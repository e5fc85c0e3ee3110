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

Gate ``'identity'`` (RF: Dh = 1, SchNet's coordinate head: Dh = 64; H1 =
64 and M = 1 for both) is its own pair of CUDA paths,
``csrc/edge_identity.cu`` (the Pallas kernels' identity branch): two
kernels a forward, four a backward, counted apart in
``identity_launches`` / ``identity_bwd_launches``.
Gradients flow through ``kernels.ops.EdgePathway``; both raw wrappers
refuse inputs that require grad.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import edge_pathway_ref
from repro_torch.kernels.runtime import align16, require_f32

Tensor = torch.Tensor

#: calls of the CUDA edge forward (two kernels each) since the last
#: :func:`reset_launches`
launches = 0
#: launches of the CUDA edge backward since the last :func:`reset_launches`
bwd_launches = 0
#: calls of the identity-gate CUDA forward (two kernels each) and backward
#: (four kernels each) since the last :func:`reset_launches`
identity_launches = 0
identity_bwd_launches = 0

#: the width the CUDA kernel is compiled for (Dh = H1 = M = HG)
KERNEL_WIDTH = 64
#: CTAs of the forward's edge pass; None: two an SM.  Each owns the
#: receiver rows whose CSR segment starts in its equal share of the live
#: slot range, so the outputs do not depend on this number
EDGE_FWD_CTAS = None
#: CTAs of the backward's edge pass: each takes an equal share of the live
#: slot range, so the weight gradients' summation order depends on this
#: number and the inputs only, never on the card
EDGE_BWD_CTAS = 256
#: CTAs of the identity kernels' row passes; None: one warp a receiver
#: row.  Each row is summed by one warp, so the outputs do not depend on
#: this number
IDENTITY_CTAS = None
#: the feature widths the identity kernels take (RF's zero column, 64)
IDENTITY_DH = (1, 64)


def reset_launches() -> None:
    global launches, bwd_launches, identity_launches, identity_bwd_launches
    launches = bwd_launches = identity_launches = identity_bwd_launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    lib.edge_fwd_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.edge_fwd_scratch_floats.restype = ctypes.c_longlong
    lib.edge_forward.argtypes = ([ctypes.c_void_p] * 18
                                 + [ctypes.c_int] * 4
                                 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p])
    lib.edge_forward.restype = ctypes.c_int
    lib.edge_fwd_blocks_per_sm.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    lib.edge_bwd_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.edge_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.edge_backward.argtypes = ([ctypes.c_void_p] * 31
                                  + [ctypes.c_int] * 4
                                  + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p])
    lib.edge_backward.restype = ctypes.c_int


def _bind_identity(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    lib.idn_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.idn_scratch_floats.restype = ctypes.c_longlong
    lib.edge_identity_forward.argtypes = ([ctypes.c_void_p] * 15
                                          + [ctypes.c_int] * 4
                                          + [ctypes.c_float, ctypes.c_int,
                                             ctypes.c_void_p])
    lib.edge_identity_forward.restype = ctypes.c_int
    lib.edge_identity_backward.argtypes = ([ctypes.c_void_p] * 25
                                           + [ctypes.c_int] * 4
                                           + [ctypes.c_float, ctypes.c_int,
                                              ctypes.c_void_p])
    lib.edge_identity_backward.restype = ctypes.c_int


def csr_receivers(indptr: Tensor) -> Tensor:
    """Receiver index of every slot in ``[0, indptr[-1])`` (int64)."""
    n = indptr.shape[0] - 1
    counts = torch.diff(indptr.long())
    return torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                   counts)


def edge_pathway_plain(x, h, snd, em, indptr, w1r, w1s, w1d, b1, w2, b2, wg1,
                       bg1, wg2, *, gate_mode="mlp", rel_mode="raw",
                       clamp=math.inf):
    """The kernel's function in plain PyTorch: the CSR rows of ``indptr``
    name each slot's receiver, slots past ``indptr[-1]`` are not read."""
    e = int(indptr[-1])
    return edge_pathway_ref(x, h, snd[:e], csr_receivers(indptr), em[:e],
                            w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2,
                            gate_mode=gate_mode, rel_mode=rel_mode,
                            clamp=clamp)


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


def _check_kernel_shapes(h, ws, gate_mode) -> int:
    """Raise unless the CUDA kernels take these widths; return Dh."""
    w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2 = ws
    d = KERNEL_WIDTH
    dh = h.shape[1]
    if gate_mode == "identity":
        if dh not in IDENTITY_DH:
            raise ValueError(f"CUDA identity edge kernel needs Dh in "
                             f"{IDENTITY_DH} (width {d}), got {dh}")
        want = {"h": (h, (h.shape[0], dh)), "w1r": (w1r, (dh, d)),
                "w1s": (w1s, (dh, d)), "w1d": (w1d, (1, d)),
                "b1": (b1, (1, d)), "w2": (w2, (d, 1)), "b2": (b2, (1, 1))}
    else:
        want = {"h": (h, (h.shape[0], d)), "w1r": (w1r, (d, d)),
                "w1s": (w1s, (d, d)), "w1d": (w1d, (1, d)),
                "b1": (b1, (1, d)), "w2": (w2, (d, d)), "b2": (b2, (1, d))}
        if gate_mode == "mlp":
            want.update(wg1=(wg1, (d, d)), bg1=(bg1, (1, d)),
                        wg2=(wg2, (d, 1)))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"CUDA edge kernel needs {name} of shape {shape} "
                             f"(width {d}), got {tuple(t.shape)}")
    return dh


def _identity_forward(x, h, snd, em, indptr, ws, dh, rel_mode, clamp):
    """The identity-gate CUDA forward: ``(dx, mh (N,1), deg)``."""
    global identity_launches
    lib = build.load("edge_identity", _bind_identity)
    dev = x.device
    n, e = x.shape[0], snd.shape[0]
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    dx, mh, deg = empty(n, 3), empty(n, 1), empty(n, 1)
    scratch = empty(int(lib.idn_scratch_floats(n, e, dh, 0)))
    ins = (x, h, snd, em, indptr, *ws[:6])
    ptrs = [t.data_ptr() for t in (*ins, dx, mh, deg, scratch)]
    err = lib.edge_identity_forward(*ptrs, n, e, dh, int(rel_mode == "inv1p"),
                                    float(clamp), IDENTITY_CTAS or 0,
                                    build.stream_ptr(dev))
    build.check(lib, err, "edge_identity_forward")
    identity_launches += 1
    return dx, mh, deg


def _identity_backward(x, h, snd, em, indptr, sperm, sptr, ws, deg, g_dx,
                       g_mh, dh, rel_mode, clamp):
    """The identity-gate CUDA backward: the 11 gradients (the gate's three
    are zeros: the identity branch has no gate weights)."""
    global identity_bwd_launches
    lib = build.load("edge_identity", _bind_identity)
    dev = x.device
    n, e = x.shape[0], snd.shape[0]
    d = KERNEL_WIDTH
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    gx, gh = empty(n, 3), empty(n, dh)
    gw1r, gw1s, gw1d, gb1 = empty(dh, d), empty(dh, d), empty(1, d), empty(1, d)
    gw2, gb2 = empty(d, 1), empty(1, 1)
    gates = tuple(torch.zeros_like(w) for w in ws[6:])
    scratch = empty(int(lib.idn_scratch_floats(n, e, dh, 1)))
    ins = (x, h, snd, em, indptr, sperm, sptr, *ws[:6], deg, g_dx, g_mh)
    outs = (gx, gh, gw1r, gw1s, gw1d, gb1, gw2, gb2)
    ptrs = [t.data_ptr() for t in (*ins, *outs, scratch)]
    err = lib.edge_identity_backward(*ptrs, n, e, dh,
                                     int(rel_mode == "inv1p"), float(clamp),
                                     IDENTITY_CTAS or 0,
                                     build.stream_ptr(dev))
    build.check(lib, err, "edge_identity_backward")
    identity_bwd_launches += 1
    return outs + gates


def edge_pathway_fused(x: Tensor, h: Tensor, snd: Tensor, em: Tensor,
                       indptr: Tensor, w1r: Tensor, w1s: Tensor, w1d: Tensor,
                       b1: Tensor, w2: Tensor, b2: Tensor, wg1: Tensor,
                       bg1: Tensor, wg2: Tensor, *, gate_mode: str = "mlp",
                       rel_mode: str = "raw", clamp: float = math.inf,
                       precision=None):
    """Edge forward over a receiver-sorted CSR layout → ``(dx, mh, deg)``.

    CUDA tensors launch the kernels (f32, widths 64, gate 'mlp' or 'none';
    scratch: P and Q, N x 64 each, and a row map of the slots) or, for gate
    'identity', the identity kernels (Dh 1 or 64, H1 = 64, M = 1); anything
    the kernels do not take raises.  CPU tensors run
    :func:`edge_pathway_plain`.
    """
    global launches
    require_f32(precision)
    ws = (w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2)
    _check(x, h, snd, em, indptr, ws, gate_mode, rel_mode)
    if x.device.type != "cuda":
        return edge_pathway_plain(x, h, snd, em, indptr, *ws,
                                  gate_mode=gate_mode, rel_mode=rel_mode,
                                  clamp=clamp)
    dh = _check_kernel_shapes(h, ws, gate_mode)
    if gate_mode == "identity":
        return _identity_forward(x, h, snd, em, indptr, ws, dh, rel_mode,
                                 clamp)
    lib = build.load("edge_message", _bind)
    dev = x.device
    n, e = x.shape[0], snd.shape[0]
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    dx, mh, deg = empty(n, 3), empty(n, KERNEL_WIDTH), empty(n, 1)
    n_ctas = EDGE_FWD_CTAS or (
        torch.cuda.get_device_properties(dev).multi_processor_count
        * lib.edge_fwd_blocks_per_sm())
    scratch = empty(int(lib.edge_fwd_scratch_floats(n, e, n_ctas)))
    # the kernels read h and the 64x64 weights with 16-byte loads
    ins = [align16(t) for t in (x, h, snd, em, indptr, *ws)]
    ptrs = [t.data_ptr() for t in (*ins, dx, mh, deg, scratch)]
    err = lib.edge_forward(*ptrs, n, e, int(gate_mode == "mlp"),
                           int(rel_mode == "inv1p"), float(clamp), n_ctas,
                           build.stream_ptr(dev))
    build.check(lib, err, "edge_forward")
    launches += 1
    return dx, mh, deg


def edge_pathway_bwd_plain(x, h, snd, em, indptr, w1r, w1s, w1d, b1, w2, b2,
                           wg1, bg1, wg2, g_dx, g_mh, *, gate_mode="mlp",
                           rel_mode="raw", clamp=math.inf):
    """``torch.autograd.grad`` of :func:`edge_pathway_plain` for the
    cotangents ``(g_dx, g_mh)`` → the 11 gradients ``(x, h, w1r, w1s, w1d,
    b1, w2, b2, wg1, bg1, wg2)``; zeros where an input is unused."""
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
    require_f32(precision)
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
                                      clamp=clamp)
    dh = _check_kernel_shapes(h, ws, gate_mode)
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
    if gate_mode == "identity":
        return _identity_backward(x, h, snd, em, indptr, sperm, sptr, ws,
                                  deg, g_dx, g_mh, dh, rel_mode, clamp)
    lib = build.load("edge_message_bwd", _bind_bwd)
    dev = x.device
    e = snd.shape[0]
    d = KERNEL_WIDTH
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
    gx, gh = empty(n, 3), empty(n, d)
    gw1r, gw1s, gw1d, gb1 = empty(d, d), empty(d, d), empty(1, d), empty(1, d)
    gw2, gb2 = empty(d, d), empty(1, d)
    if gate_mode == "mlp":
        gwg1, gbg1, gwg2 = empty(d, d), empty(1, d), empty(d, 1)
    else:  # the kernel writes no gate grads
        gwg1, gbg1, gwg2 = (torch.zeros_like(w) for w in (wg1, bg1, wg2))
    scratch = empty(int(lib.edge_bwd_scratch_floats(n, e, EDGE_BWD_CTAS)))
    outs = (gx, gh, gw1r, gw1s, gw1d, gb1, gw2, gb2, gwg1, gbg1, gwg2)
    # the kernels read h, g_mh and the 64x64 weights with 16-byte loads
    ins = [align16(t) for t in (x, h, snd, em, indptr, sperm, sptr, *ws, deg,
                                g_dx, g_mh)]
    ptrs = [t.data_ptr() for t in (*ins, *outs, scratch)]
    err = lib.edge_backward(*ptrs, n, e, int(gate_mode == "mlp"),
                            int(rel_mode == "inv1p"), float(clamp),
                            EDGE_BWD_CTAS, build.stream_ptr(dev))
    build.check(lib, err, "edge_backward")
    bwd_launches += 1
    return outs
