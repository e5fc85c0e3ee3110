"""The real-real edge pathway: CUDA kernel wrappers (forward and
backward), plain versions, launch counters.

:func:`edge_pathway_fused` is the forward kernel's wrapper.  It takes the
edges in the port's receiver-sorted CSR layout — ``snd``/``em`` slot
arrays and ``indptr`` (N+1 row offsets over the slots, built by
``data.radius_graph.csr_indptr``) — and returns ``(dx (N,3), mh (N,M),
deg (N,1))``, the masked means of ``kernels.ref.edge_pathway_ref``.  For
CUDA tensors it launches ``csrc/edge_message.cu`` (which replaces the
JAX package's Pallas ``edge_pathway_fused``) or raises: two kernels a
call, the node projection (P = h·W1r, Q = h·W1s and the CTAs' rows, into
a scratch tensor this wrapper allocates) and the edge pass.  For CPU
tensors it runs :func:`edge_pathway_plain`.  ``launches`` counts calls.

:func:`edge_pathway_bwd_fused` returns the 11 gradients of the forward
from its primals, its ``deg`` output and the cotangents ``(g_dx, g_mh)``.
For CUDA tensors it launches ``csrc/edge_message_bwd.cu`` (which replaces
the Pallas ``edge_pathway_bwd_fused``): four kernels, whose node pass walks
the sender permutation ``sperm`` / ``sptr`` of
``data.radius_graph.csr_sender_perm``.  For CPU tensors it runs
:func:`edge_pathway_bwd_plain`.  ``bwd_launches`` counts its calls.

Widths: the kernels are compiled for Dh = H1 = M = 32 and 64, every
weight resident in shared memory.  Any other Dh, H1 and M up to 64 are
zero-padded up to the next of them (h's columns, the weights' rows and
columns, the biases: exact, a zero row or column adds +0 to every sum) and
the outputs sliced back; above 64 the panel path of ``csrc/panel.cu``
runs.  :func:`kernel_route` names the route for a set of widths and
``route_launches`` counts calls per route.

Precision: every wrapper takes the reference kernels' ``precision``
('f32' or 'bf16', ``runtime.resolve_precision``) and passes it to the C
entry points as one more int; in bf16 the kernels round every product's
operands to bfloat16 where the Pallas kernels cast them and sum in f32
(inputs and outputs stay f32), and the plain versions follow the same
casts (``kernels.ref.edge_pathway_ref_bf16``,
``edge_pathway_bwd_ref_bf16``).  ``precision_launches`` counts every
call (any route, forward or backward) per precision.

Gate ``'identity'`` (RF: Dh = 1, SchNet's coordinate head: Dh = hidden;
M = 1 for both) is its own pair of CUDA paths, ``csrc/edge_identity.cu``
(the Pallas kernels' identity branch), for H1 up to
:data:`IDENTITY_MAX_H1`: two kernels a forward, four a backward (five in
bf16 at Dh and H1 up to 64, whose per-edge dh products run as bf16 tile
products; at Dh and H1 up to 64 the projection and the backward's node
pass are tensor-core tile products in both precisions, and the forward's
edge pass runs on 64-edge tiles, edge-parallel; above 64 it walks one
receiver row a warp), counted apart in
``identity_launches`` / ``identity_bwd_launches``.  A wider
identity layer (the reference admits them for very small graphs) takes
the panel path, counted as the other gates' calls are.
Gradients flow through ``kernels.ops.EdgePathway``; both raw wrappers
refuse inputs that require grad.
"""
from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch

from repro_torch.kernels import build, panel
from repro_torch.kernels.ref import (edge_pathway_bwd_ref_bf16,
                                     edge_pathway_ref, edge_pathway_ref_bf16)
from repro_torch.kernels.runtime import (BF16, align16, pad_to,
                                         resolve_precision, unpad)

Tensor = torch.Tensor

#: calls of the CUDA edge forward (two kernels each) since the last
#: :func:`reset_launches`
launches = 0
#: launches of the CUDA edge backward since the last :func:`reset_launches`
bwd_launches = 0
#: calls of the identity-gate CUDA forward (two kernels each) and backward
#: (four kernels each; five on the bf16 tile route) since the last
#: :func:`reset_launches`
identity_launches = 0
identity_bwd_launches = 0
#: identity-gate forward calls per route since the last
#: :func:`reset_launches`: "tiles" (Dh and H1 up to 64, the edge-parallel
#: tile pass) or "rows" (a warp a receiver row)
identity_fwd_routes: Counter = Counter()

#: the widths the tile kernels are compiled for, narrowest first
COMPILED_WIDTHS = (32, 64)
#: the widest φ1 hidden width of the identity kernels (32 columns a lane,
#: at most 24 a lane)
IDENTITY_MAX_H1 = 768
#: calls per route since the last :func:`reset_launches`: the forward and
#: the backward of gate 'mlp' / 'none' each add one to the route they took
#: ("w32", "w64", "panel")
route_launches: Counter = Counter()
#: calls of every CUDA path of this module (forward and backward, tile,
#: panel and identity kernels) per precision ("f32", "bf16") since the last
#: :func:`reset_launches`
precision_launches: Counter = Counter()
#: CTAs of the forward's edge pass; None: two an SM.  Each owns the
#: receiver rows whose CSR segment starts in its equal share of the live
#: slot range, so the outputs do not depend on this number
EDGE_FWD_CTAS = None
#: CTAs of the backward's edge pass: each takes an equal share of the live
#: slot range, so the weight gradients' summation order depends on this
#: number and the inputs only, never on the card
EDGE_BWD_CTAS = 256
#: CTAs of the identity kernels' passes: the forward's tile pass (Dh and
#: H1 up to 64; None: ``idn_fwd_blocks_per_sm`` an SM), which owns whole
#: receiver rows as the edge forward's CTAs do, and the row passes (None:
#: one warp a receiver row).  Each row is summed in slot order by one
#: thread or warp, so the outputs do not depend on this number
IDENTITY_CTAS = None


def reset_launches() -> None:
    global launches, bwd_launches, identity_launches, identity_bwd_launches
    launches = bwd_launches = identity_launches = identity_bwd_launches = 0
    route_launches.clear()
    precision_launches.clear()
    identity_fwd_routes.clear()


def prec_name(bf16: bool) -> str:
    """The key of ``precision_launches`` for a call in bf16 or f32."""
    return "bf16" if bf16 else "f32"


def kernel_route(*widths: int) -> str:
    """The route the tile kernels take for these feature widths: ``"w32"``
    or ``"w64"`` (the compiled width all of them fit, padded up to it) or
    ``"panel"`` (any wider)."""
    top = max(widths)
    for w in COMPILED_WIDTHS:
        if top <= w:
            return f"w{w}"
    return "panel"


#: the panel path's gate modes
GATE_CODE = {"none": 0, "mlp": 1, "identity": 2}


def _route(gate_mode: str, dh: int, h1: int, m: int) -> str:
    """The route of a call the identity kernels do not take: the tile
    kernels' or (any identity layer wider than them) the panel path."""
    return "panel" if gate_mode == "identity" else kernel_route(dh, h1, m)


def _bind(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    lib.edge_fwd_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.edge_fwd_scratch_floats.restype = ctypes.c_longlong
    lib.edge_forward.argtypes = ([ctypes.c_void_p] * 18
                                 + [ctypes.c_int] * 4
                                 + [ctypes.c_float] + [ctypes.c_int] * 3
                                 + [ctypes.c_void_p])
    lib.edge_forward.restype = ctypes.c_int
    for fn in (lib.edge_fwd_blocks_per_sm, lib.edge_fwd_occupancy):
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    lib.edge_bwd_scratch_floats.argtypes = [ctypes.c_int] * 5
    lib.edge_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.edge_backward.argtypes = ([ctypes.c_void_p] * 31
                                  + [ctypes.c_int] * 4
                                  + [ctypes.c_float] + [ctypes.c_int] * 3
                                  + [ctypes.c_void_p])
    lib.edge_backward.restype = ctypes.c_int
    lib.edge_bwd_occupancy.argtypes = [ctypes.c_int] * 2
    lib.edge_bwd_occupancy.restype = ctypes.c_int


def _bind_identity(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    lib.idn_scratch_floats.argtypes = [ctypes.c_int] * 7
    lib.idn_scratch_floats.restype = ctypes.c_longlong
    for fn in (lib.idn_fwd_blocks_per_sm, lib.idn_fwd_occupancy):
        fn.argtypes = [ctypes.c_int] * 2
        fn.restype = ctypes.c_int
    lib.edge_identity_forward.argtypes = ([ctypes.c_void_p] * 15
                                          + [ctypes.c_int] * 5
                                          + [ctypes.c_float] + [ctypes.c_int] * 2
                                          + [ctypes.c_void_p])
    lib.edge_identity_forward.restype = ctypes.c_int
    lib.edge_identity_backward.argtypes = ([ctypes.c_void_p] * 25
                                           + [ctypes.c_int] * 5
                                           + [ctypes.c_float]
                                           + [ctypes.c_int] * 2
                                           + [ctypes.c_void_p])
    lib.edge_identity_backward.restype = ctypes.c_int


def csr_receivers(indptr: Tensor) -> Tensor:
    """Receiver index of every slot in ``[0, indptr[-1])`` (int64)."""
    n = indptr.shape[0] - 1
    counts = torch.diff(indptr.long())
    return torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                   counts)


def edge_pathway_plain(x, h, snd, em, indptr, w1r, w1s, w1d, b1, w2, b2, wg1,
                       bg1, wg2, *, gate_mode="mlp", rel_mode="raw",
                       clamp=math.inf, precision=None):
    """The kernel's function in plain PyTorch: the CSR rows of ``indptr``
    name each slot's receiver, slots past ``indptr[-1]`` are not read.
    ``precision`` 'bf16' rounds where the bf16 kernel does
    (``kernels.ref.edge_pathway_ref_bf16``)."""
    e = int(indptr[-1])
    ref = (edge_pathway_ref_bf16 if resolve_precision(precision) == BF16
           else edge_pathway_ref)
    return ref(x, h, snd[:e], csr_receivers(indptr), em[:e], w1r, w1s, w1d,
               b1, w2, b2, wg1, bg1, wg2, gate_mode=gate_mode,
               rel_mode=rel_mode, clamp=clamp)


def _check(x, h, snd, em, indptr, ws, gate_mode, rel_mode, extra=()):
    tensors = (x, h, snd, em, indptr, *ws, *extra)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the raw edge wrappers have no backward kernel of their own: "
            "differentiate through kernels.ops.EdgePathway, or call them "
            "under torch.no_grad()")
    dev = x.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"all operands must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("edge_pathway_fused needs contiguous operands")
    for name, t in (("x", x), ("h", h), ("em", em)) + tuple(
            (f"w{i}", w) for i, w in enumerate(ws)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if snd.dtype != torch.int32 or indptr.dtype != torch.int32:
        raise TypeError("snd and indptr must be int32")
    n = x.shape[0]
    if x.shape != (n, 3) or h.ndim != 2 or h.shape[0] != n:
        raise ValueError(f"x must be (N,3) and h (N,Dh); got {tuple(x.shape)}"
                         f", {tuple(h.shape)}")
    if indptr.shape != (n + 1,):
        raise ValueError(f"indptr must be ({n + 1},), got {tuple(indptr.shape)}")
    if snd.ndim != 1 or em.shape != snd.shape:
        raise ValueError("snd and em must be matching (E,) slot arrays")
    if gate_mode not in ("mlp", "identity", "none"):
        raise ValueError(f"unknown gate_mode {gate_mode!r}")
    if rel_mode not in ("raw", "inv1p"):
        raise ValueError(f"unknown rel_mode {rel_mode!r}")


def _kernel_widths(h, ws, gate_mode) -> tuple[int, int, int]:
    """Raise unless the weights fit together; return ``(Dh, H1, M)``."""
    w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2 = ws
    dh, h1, m = h.shape[1], w1r.shape[1], w2.shape[1]
    want = {"w1r": (w1r, (dh, h1)), "w1s": (w1s, (dh, h1)),
            "w1d": (w1d, (1, h1)), "b1": (b1, (1, h1)), "w2": (w2, (h1, m)),
            "b2": (b2, (1, m))}
    if gate_mode == "identity":
        if m != 1:
            raise ValueError(f"the identity gate needs M = 1, got {m}")
    elif gate_mode == "mlp":
        want.update(wg1=(wg1, (m, h1)), bg1=(bg1, (1, h1)),
                    wg2=(wg2, (h1, 1)))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"CUDA edge kernel needs {name} of shape "
                             f"{shape} (Dh {dh}, H1 {h1}, M {m}), got "
                             f"{tuple(t.shape)}")
    return dh, h1, m


def padded_widths(route: str, *widths: int) -> tuple:
    """The widths as the route takes them: each the compiled width, or
    (panel) each rounded up to a multiple of 64."""
    if route == "panel":
        return tuple(-(-v // 64) * 64 for v in widths)
    return (int(route[1:]),) * len(widths)


def _pad_weights(ws, gate_mode, d, h, m):
    """The nine weights zero-padded to widths ``(Dh, H1, M) = (d, h, m)``
    (the gate's only for gate 'mlp': the other gates do not read them)."""
    w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2 = ws
    out = [pad_to(w1r, d, h), pad_to(w1s, d, h), pad_to(w1d, 1, h),
           pad_to(b1, 1, h), pad_to(w2, h, m), pad_to(b2, 1, m)]
    if gate_mode == "mlp":
        out += [pad_to(wg1, m, h), pad_to(bg1, 1, h), pad_to(wg2, h, 1)]
    else:
        out += [wg1, bg1, wg2]
    return out


def _identity_forward(x, h, snd, em, indptr, ws, dh, h1, rel_mode, clamp,
                      bf16):
    """The identity-gate CUDA forward: ``(dx, mh (N,1), deg)``."""
    global identity_launches
    lib = build.load("edge_identity", _bind_identity)
    dev = x.device
    n, e = x.shape[0], snd.shape[0]
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    dx, mh, deg = empty(n, 3), empty(n, 1), empty(n, 1)
    per_sm = lib.idn_fwd_blocks_per_sm(dh, h1)  # 0: off the tile route
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_ctas = IDENTITY_CTAS or per_sm * sms
    scratch = empty(int(lib.idn_scratch_floats(n, e, dh, h1, 0, int(bf16),
                                               n_ctas)))
    # the projection reads h and W1r / W1s with 16-byte loads where aligned
    ins = (x, align16(h), snd, em, indptr, *map(align16, ws[:2]), *ws[2:6])
    ptrs = [t.data_ptr() for t in (*ins, dx, mh, deg, scratch)]
    err = lib.edge_identity_forward(*ptrs, n, e, dh, h1,
                                    int(rel_mode == "inv1p"), float(clamp),
                                    n_ctas, int(bf16), build.stream_ptr(dev))
    build.check(lib, err, "edge_identity_forward")
    identity_launches += 1
    identity_fwd_routes["tiles" if per_sm else "rows"] += 1
    precision_launches[prec_name(bf16)] += 1
    return dx, mh, deg


def _identity_backward(x, h, snd, em, indptr, sperm, sptr, ws, deg, g_dx,
                       g_mh, dh, h1, rel_mode, clamp, bf16):
    """The identity-gate CUDA backward: the 11 gradients (the gate's three
    are zeros: the identity branch has no gate weights)."""
    global identity_bwd_launches
    lib = build.load("edge_identity", _bind_identity)
    dev = x.device
    n, e = x.shape[0], snd.shape[0]
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    gx, gh = empty(n, 3), empty(n, dh)
    gw1r, gw1s = empty(dh, h1), empty(dh, h1)
    gw1d, gb1 = empty(1, h1), empty(1, h1)
    gw2, gb2 = empty(h1, 1), empty(1, 1)
    gates = tuple(torch.zeros_like(w) for w in ws[6:])
    scratch = empty(int(lib.idn_scratch_floats(n, e, dh, h1, 1, int(bf16),
                                               0)))
    ins = (x, align16(h), snd, em, indptr, sperm, sptr,
           *map(align16, ws[:2]), *ws[2:6], deg, g_dx, g_mh)
    outs = (gx, gh, gw1r, gw1s, gw1d, gb1, gw2, gb2)
    ptrs = [t.data_ptr() for t in (*ins, *outs, scratch)]
    err = lib.edge_identity_backward(*ptrs, n, e, dh, h1,
                                     int(rel_mode == "inv1p"), float(clamp),
                                     IDENTITY_CTAS or 0, int(bf16),
                                     build.stream_ptr(dev))
    build.check(lib, err, "edge_identity_backward")
    identity_bwd_launches += 1
    precision_launches[prec_name(bf16)] += 1
    return outs + gates


def edge_pathway_fused(x: Tensor, h: Tensor, snd: Tensor, em: Tensor,
                       indptr: Tensor, w1r: Tensor, w1s: Tensor, w1d: Tensor,
                       b1: Tensor, w2: Tensor, b2: Tensor, wg1: Tensor,
                       bg1: Tensor, wg2: Tensor, *, gate_mode: str = "mlp",
                       rel_mode: str = "raw", clamp: float = math.inf,
                       precision=None):
    """Edge forward over a receiver-sorted CSR layout → ``(dx, mh, deg)``.

    CUDA tensors launch the kernels (f32 operands; ``precision`` 'f32' or
    'bf16', the Pallas kernels' contract: bf16 operands of every product,
    f32 sums and outputs; gate 'mlp' or 'none', any Dh,
    H1 and M: :func:`kernel_route` picks the compiled width they are
    padded to, or the panel path; scratch: P and Q, N x width each, and a
    row map of the slots) or, for gate 'identity', the identity kernels
    (any Dh, M = 1; the panel path above :data:`IDENTITY_MAX_H1`);
    anything else raises.  CPU tensors run :func:`edge_pathway_plain`.
    """
    global launches
    bf16 = resolve_precision(precision) == BF16
    ws = (w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2)
    _check(x, h, snd, em, indptr, ws, gate_mode, rel_mode)
    if x.device.type != "cuda":
        return edge_pathway_plain(x, h, snd, em, indptr, *ws,
                                  gate_mode=gate_mode, rel_mode=rel_mode,
                                  clamp=clamp, precision=precision)
    dh, h1, m = _kernel_widths(h, ws, gate_mode)
    if gate_mode == "identity" and h1 <= IDENTITY_MAX_H1:
        return _identity_forward(x, h, snd, em, indptr, ws, dh, h1, rel_mode,
                                 clamp, bf16)
    route = _route(gate_mode, dh, h1, m)
    d, hp, mp = padded_widths(route, dh, h1, m)
    n, e = x.shape[0], snd.shape[0]
    # the kernels read h and the weights with 16-byte loads
    ins = [align16(t) for t in (x, pad_to(h, n, d), snd, em, indptr,
                                *_pad_weights(ws, gate_mode, d, hp, mp))]
    flags = (int(gate_mode == "mlp"), int(rel_mode == "inv1p"), float(clamp))
    if route == "panel":
        dx, mh, deg = panel.edge_forward(ins, d, hp, mp, GATE_CODE[gate_mode],
                                         *flags[1:], bf16)
    else:
        lib = build.load("edge_message", _bind)
        dev = x.device
        empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
        dx, mh, deg = empty(n, 3), empty(n, mp), empty(n, 1)
        n_ctas = EDGE_FWD_CTAS or (
            torch.cuda.get_device_properties(dev).multi_processor_count
            * lib.edge_fwd_blocks_per_sm(mp, int(bf16)))
        scratch = empty(int(lib.edge_fwd_scratch_floats(n, e, n_ctas, mp)))
        ptrs = [t.data_ptr() for t in (*ins, dx, mh, deg, scratch)]
        err = lib.edge_forward(*ptrs, n, e, *flags, n_ctas, mp, int(bf16),
                               build.stream_ptr(dev))
        build.check(lib, err, "edge_forward")
    launches += 1
    route_launches[route] += 1
    precision_launches[prec_name(bf16)] += 1
    return dx, unpad(mh, (n, m)), deg


def edge_pathway_bwd_plain(x, h, snd, em, indptr, w1r, w1s, w1d, b1, w2, b2,
                           wg1, bg1, wg2, g_dx, g_mh, *, gate_mode="mlp",
                           rel_mode="raw", clamp=math.inf, precision=None,
                           deg=None):
    """``torch.autograd.grad`` of :func:`edge_pathway_plain` for the
    cotangents ``(g_dx, g_mh)`` → the 11 gradients ``(x, h, w1r, w1s, w1d,
    b1, w2, b2, wg1, bg1, wg2)``; zeros where an input is unused.
    ``precision`` 'bf16' runs the bf16 kernel's explicit backward
    (``kernels.ref.edge_pathway_bwd_ref_bf16``) instead, with the
    forward's ``deg`` (recomputed if not given)."""
    if resolve_precision(precision) == BF16:
        e = int(indptr[-1])
        if deg is None:
            deg = edge_pathway_plain(x, h, snd, em, indptr, w1r, w1s, w1d, b1,
                                     w2, b2, wg1, bg1, wg2)[2]
        return edge_pathway_bwd_ref_bf16(
            x, h, snd[:e], csr_receivers(indptr), em[:e], w1r, w1s, w1d, b1,
            w2, b2, wg1, bg1, wg2, deg, g_dx, g_mh, gate_mode=gate_mode,
            rel_mode=rel_mode, clamp=clamp)
    prim = [t.detach().requires_grad_(True)
            for t in (x, h, w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2)]
    with torch.enable_grad():
        dx, mh, _ = edge_pathway_plain(prim[0], prim[1], snd, em, indptr,
                                       *prim[2:], gate_mode=gate_mode,
                                       rel_mode=rel_mode, clamp=clamp)
        grads = torch.autograd.grad((dx, mh), prim, grad_outputs=(g_dx, g_mh),
                                    allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, prim))


def edge_pathway_bwd_fused(x: Tensor, h: Tensor, snd: Tensor, em: Tensor,
                           indptr: Tensor, sperm, sptr, w1r: Tensor,
                           w1s: Tensor, w1d: Tensor, b1: Tensor, w2: Tensor,
                           b2: Tensor, wg1: Tensor, bg1: Tensor, wg2: Tensor,
                           deg: Tensor, g_dx: Tensor, g_mh: Tensor, *,
                           gate_mode: str = "mlp", rel_mode: str = "raw",
                           clamp: float = math.inf, precision=None):
    """Backward of :func:`edge_pathway_fused` → the 11 gradients
    ``(gx, gh, gw1r, gw1s, gw1d, gb1, gw2, gb2, gwg1, gbg1, gwg2)``.

    ``deg`` is the forward's third output (constant: it depends on the
    edge mask only).  ``sperm`` (int32, slots of ``[0, indptr[-1])``
    stably sorted by sender, padded to any length) and ``sptr`` (int32,
    N+1 sender offsets into it) come from
    ``data.radius_graph.csr_sender_perm``; the CUDA kernel needs them, the
    plain version ignores them.  Masked slots and rows with ``deg = 0``
    give exact zeros; an empty slot list gives zeros.
    """
    global bwd_launches
    bf16 = resolve_precision(precision) == BF16
    ws = (w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2)
    _check(x, h, snd, em, indptr, ws, gate_mode, rel_mode,
           extra=(deg, g_dx, g_mh))
    n = x.shape[0]
    if deg.shape != (n, 1) or g_dx.shape != (n, 3) or g_mh.shape != (
            n, w2.shape[1]):
        raise ValueError(f"need deg (N,1), g_dx (N,3), g_mh (N,M); got "
                         f"{tuple(deg.shape)}, {tuple(g_dx.shape)}, "
                         f"{tuple(g_mh.shape)}")
    if snd.shape[0] == 0:  # empty graph: nothing was reduced
        return tuple(torch.zeros_like(t) for t in (x, h, *ws))
    if x.device.type != "cuda":
        return edge_pathway_bwd_plain(x, h, snd, em, indptr, *ws, g_dx, g_mh,
                                      gate_mode=gate_mode, rel_mode=rel_mode,
                                      clamp=clamp, precision=precision,
                                      deg=deg)
    dh, h1, m = _kernel_widths(h, ws, gate_mode)
    if sperm is None or sptr is None:
        raise ValueError(
            "the CUDA edge backward needs the sender permutation (sperm, "
            "sptr) of data.radius_graph.csr_sender_perm in the layout")
    if (sperm.dtype != torch.int32 or sptr.dtype != torch.int32
            or sptr.shape != (n + 1,) or sperm.ndim != 1
            or sperm.device != x.device or sptr.device != x.device
            or not (sperm.is_contiguous() and sptr.is_contiguous())):
        raise ValueError(f"sperm must be a contiguous int32 (E,) and sptr "
                         f"an int32 ({n + 1},) tensor on {x.device}")
    if gate_mode == "identity" and h1 <= IDENTITY_MAX_H1:
        return _identity_backward(x, h, snd, em, indptr, sperm, sptr, ws,
                                  deg, g_dx, g_mh, dh, h1, rel_mode, clamp,
                                  bf16)
    route = _route(gate_mode, dh, h1, m)
    d, hp, mp = padded_widths(route, dh, h1, m)
    e = snd.shape[0]
    dev = x.device
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    gx, gh = empty(n, 3), empty(n, d)
    gw1r, gw1s, gw1d, gb1 = (empty(d, hp), empty(d, hp), empty(1, hp),
                             empty(1, hp))
    gw2, gb2 = empty(hp, mp), empty(1, mp)
    if gate_mode == "mlp":
        gwg1, gbg1, gwg2 = empty(mp, hp), empty(1, hp), empty(hp, 1)
    else:  # the kernels write no gate grads
        gwg1, gbg1, gwg2 = (torch.zeros_like(t) for t in (wg1, bg1, wg2))
    outs = (gx, gh, gw1r, gw1s, gw1d, gb1, gw2, gb2, gwg1, gbg1, gwg2)
    # the kernels read h, g_mh and the weights with 16-byte loads
    ins = [align16(t) for t in (x, pad_to(h, n, d), snd, em, indptr, sperm,
                                sptr, *_pad_weights(ws, gate_mode, d, hp, mp),
                                deg, g_dx, pad_to(g_mh, n, mp))]
    flags = (int(gate_mode == "mlp"), int(rel_mode == "inv1p"), float(clamp))
    if route == "panel":
        panel.edge_backward(ins, outs, d, hp, mp, GATE_CODE[gate_mode],
                            *flags[1:], bf16)
    else:
        lib = build.load("edge_message_bwd", _bind_bwd)
        scratch = empty(int(lib.edge_bwd_scratch_floats(n, e, EDGE_BWD_CTAS,
                                                        mp, int(bf16))))
        ptrs = [t.data_ptr() for t in (*ins, *outs, scratch)]
        err = lib.edge_backward(*ptrs, n, e, *flags, EDGE_BWD_CTAS, mp,
                                int(bf16), build.stream_ptr(dev))
        build.check(lib, err, "edge_backward")
    bwd_launches += 1
    route_launches[route] += 1
    precision_launches[prec_name(bf16)] += 1
    shapes = [(n, 3), (n, dh), (dh, h1), (dh, h1), (1, h1), (1, h1),
              (h1, m), (1, m), (m, h1), (1, h1), (h1, 1)]
    return tuple(t if (i >= 8 and gate_mode != "mlp")
                 else unpad(t, shape)
                 for i, (t, shape) in enumerate(zip(outs, shapes)))

