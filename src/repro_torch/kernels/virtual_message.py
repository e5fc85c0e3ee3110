"""The virtual-node pathway: CUDA kernel wrappers (forward and backward),
plain versions, launch counters.

:func:`virtual_pathway_fused` returns ``(dx (N,3), mh (N,hid), dz_sum
(C,3), ms_sum (C,hid))``, the contract of
``kernels.ref.virtual_pathway_ref``.  For CUDA tensors it launches
``csrc/virtual_message.cu`` (which replaces the JAX package's Pallas
``virtual_pathway_fused``): the main kernel, one CTA per 64-node tile,
writes dx and mh and one row of partial sums per CTA and channel into a
scratch tensor this wrapper allocates, and a second kernel adds the CTAs
in order (in bf16 a first kernel rounds the weight stacks into a second
scratch tensor).  ``launches`` counts calls (two kernels each, bf16
three).  CPU tensors run :func:`virtual_pathway_plain`.

:func:`virtual_pathway_bwd_fused` returns the 14 gradients of the forward
(all operands but the node mask) from its primals and the four output
cotangents.  For CUDA tensors it launches ``csrc/virtual_message_bwd.cu``
(which replaces the Pallas ``virtual_pathway_bwd_fused``): the main
kernel and the reduction of its partials (in bf16 a first kernel rounds
the weight stacks into the scratch tensor, as the forward's does);
``bwd_launches`` counts calls.
CPU tensors run :func:`virtual_pathway_bwd_plain`.  Gradients flow through
``kernels.ops.VirtualPathway``; both raw wrappers refuse inputs that
require grad.

Widths: as the edge kernels (``kernels.edge_message.kernel_route``), the
kernels are compiled for Dh = hid = 32 and 64; other widths up to 64 are
zero-padded up to the next (exact) and the outputs sliced back, wider
ones take the panel path of ``csrc/panel.cu``.  ``route_launches`` counts
calls per route.  s_dim never reaches the kernels: it is folded into
``const1`` before the call.

Precision: both wrappers take ``precision`` ('f32' or 'bf16') as the
edge wrappers do (``kernels.edge_message``), with plain versions
``kernels.ref.virtual_pathway_ref_bf16`` / ``virtual_pathway_bwd_ref_bf16``;
``precision_launches`` counts calls per precision.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import build, panel
from repro_torch.kernels.edge_message import (kernel_route, padded_widths,
                                              prec_name)
from repro_torch.kernels.ref import (virtual_pathway_bwd_ref_bf16,
                                     virtual_pathway_ref,
                                     virtual_pathway_ref_bf16)
from repro_torch.kernels.runtime import (BF16, align16, pad_to,
                                         resolve_precision, unpad)

Tensor = torch.Tensor

#: calls of the CUDA virtual forward (two kernels each, bf16 three) since
#: :func:`reset_launches`
launches = 0
#: calls of the CUDA virtual backward (two kernels each, bf16 three) since
#: :func:`reset_launches`
bwd_launches = 0

#: calls per route ("w32", "w64", "panel") of the forward and the
#: backward since :func:`reset_launches`
route_launches: Counter = Counter()
#: calls of the forward and the backward per precision ("f32", "bf16")
#: since :func:`reset_launches`
precision_launches: Counter = Counter()


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0
    route_launches.clear()
    precision_launches.clear()


def pad_ops(ops: tuple, d: int, w: int) -> list:
    """The forward's 15 operands with h and the weights zero-padded to
    Dh = ``d`` and hid = ``w``."""
    x, h, z, mask, w1h, w1d, c1, w2, b2, wg1, bg1, wg2, wz1, bz1, wz2 = ops
    c = z.shape[0]
    vec = lambda t: pad_to(t, c, w)
    mat = lambda t: pad_to(t, c, w, w)
    return [x, pad_to(h, x.shape[0], d), z, mask, pad_to(w1h, c, d, w),
            vec(w1d), vec(c1), mat(w2), vec(b2), mat(wg1), vec(bg1),
            pad_to(wg2, c, w, 1), mat(wz1), vec(bz1), pad_to(wz2, c, w, 1)]


def _bind(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    lib.virtual_forward.argtypes = ([ctypes.c_void_p] * 19
                                    + [ctypes.c_int] * 4
                                    + [ctypes.c_void_p])
    lib.virtual_forward.restype = ctypes.c_int
    lib.virtual_fwd_scratch_floats.argtypes = [ctypes.c_int] * 3
    lib.virtual_fwd_scratch_floats.restype = ctypes.c_longlong
    lib.virtual_fwd_occupancy.argtypes = [ctypes.c_int] * 2
    lib.virtual_fwd_occupancy.restype = ctypes.c_int
    lib.virtual_sums.argtypes = ([ctypes.c_void_p] * 3
                                 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.virtual_sums.restype = ctypes.c_int
    lib.virtual_nodes_per_block.restype = ctypes.c_int
    lib.virtual_partial_width.argtypes = [ctypes.c_int]
    lib.virtual_partial_width.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    lib.virtual_bwd_scratch_floats.argtypes = [ctypes.c_int] * 4
    lib.virtual_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.virtual_bwd_occupancy.argtypes = [ctypes.c_int] * 2
    lib.virtual_bwd_occupancy.restype = ctypes.c_int
    lib.virtual_backward.argtypes = ([ctypes.c_void_p] * 34
                                     + [ctypes.c_int] * 4
                                     + [ctypes.c_void_p])
    lib.virtual_backward.restype = ctypes.c_int


def virtual_pathway_plain(*operands, precision=None):
    """The kernel's function in plain PyTorch (``virtual_pathway_ref``;
    ``precision`` 'bf16': ``virtual_pathway_ref_bf16``, rounded where the
    bf16 kernel rounds)."""
    if resolve_precision(precision) == BF16:
        return virtual_pathway_ref_bf16(*operands)
    return virtual_pathway_ref(*operands)


_SHAPES = ("x", "h", "z", "mask", "w1h", "w1d", "const1", "w2", "b2", "wg1",
           "bg1", "wg2", "wz1", "bz1", "wz2")


def _check(ops: tuple) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        raise RuntimeError(
            "the raw virtual wrappers have no backward kernel of their own: "
            "differentiate through kernels.ops.VirtualPathway, or call them "
            "under torch.no_grad()")
    dev = ops[0].device
    for name, t in zip(_SHAPES, ops):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"virtual_pathway_fused needs contiguous {name}")
    x, h, z, mask, w1h = ops[:5]
    n, c = x.shape[0], z.shape[0]
    dh, hid = h.shape[1], w1h.shape[2]
    want = dict(x=(n, 3), h=(n, dh), z=(c, 3), mask=(n,), w1h=(c, dh, hid),
                w1d=(c, hid), const1=(c, hid), w2=(c, hid, hid), b2=(c, hid),
                wg1=(c, hid, hid), bg1=(c, hid), wg2=(c, hid, 1),
                wz1=(c, hid, hid), bz1=(c, hid), wz2=(c, hid, 1))
    for name, t in zip(_SHAPES, ops):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must have shape {want[name]}, got "
                             f"{tuple(t.shape)}")


def virtual_pathway_fused(x: Tensor, h: Tensor, z: Tensor, node_mask: Tensor,
                          w1h: Tensor, w1d: Tensor, const1: Tensor, w2: Tensor,
                          b2: Tensor, wg1: Tensor, bg1: Tensor, wg2: Tensor,
                          wz1: Tensor, bz1: Tensor, wz2: Tensor, *,
                          precision=None):
    """Virtual forward → ``(dx, mh, dz_sum, ms_sum)``.

    CUDA tensors launch the kernels (f32 operands, ``precision`` 'f32' or
    'bf16': bf16 operands of every product, f32 sums and outputs; any Dh
    and hid: the compiled width they are padded to, or the panel path) or
    raise; CPU tensors run :func:`virtual_pathway_plain`.
    """
    global launches
    bf16 = resolve_precision(precision) == BF16
    ops = (x, h, z, node_mask, w1h, w1d, const1, w2, b2, wg1, bg1, wg2, wz1,
           bz1, wz2)
    _check(ops)
    if x.device.type != "cuda":
        return virtual_pathway_plain(*ops, precision=precision)
    dh, hid = h.shape[1], w1h.shape[2]
    route = kernel_route(dh, hid)
    d, w = padded_widths(route, dh, hid)
    n, c = x.shape[0], z.shape[0]
    dev = x.device
    # the kernels read h and the weights with 16-byte loads
    ins = [align16(t) for t in pad_ops(ops, d, w)]
    if route == "panel":
        dx, mh, dz, ms = panel.virtual_forward(ins, d, w, bf16)
    else:
        lib = build.load("virtual_message", _bind)
        n_blocks = -(-n // lib.virtual_nodes_per_block())
        empty = lambda *s: torch.empty(s, dtype=torch.float32, device=dev)
        dx, mh, dz, ms = empty(n, 3), empty(n, w), empty(c, 3), empty(c, w)
        part = empty(n_blocks, c, lib.virtual_partial_width(w))
        # bf16: the four weight stacks rounded once a call, read as tiles
        scratch = empty(int(lib.virtual_fwd_scratch_floats(c, w, int(bf16))))
        stream = build.stream_ptr(dev)
        err = lib.virtual_forward(
            *[t.data_ptr() for t in (*ins, dx, mh, part, scratch)], n, c, w,
            int(bf16), stream)
        build.check(lib, err, "virtual_forward")
        err = lib.virtual_sums(part.data_ptr(), dz.data_ptr(), ms.data_ptr(),
                               n_blocks, c, w, stream)
        build.check(lib, err, "virtual_sums")
    launches += 1
    route_launches[route] += 1
    precision_launches[prec_name(bf16)] += 1
    return dx, unpad(mh, (n, hid)), dz, unpad(ms, (c, hid))


def virtual_pathway_bwd_plain(*operands, precision=None):
    """``torch.autograd.grad`` of :func:`virtual_pathway_plain`: operands
    are the forward's 15 followed by the four cotangents ``(g_dx, g_mh,
    g_dz, g_ms)``; returns the 14 gradients (no node-mask gradient).
    ``precision`` 'bf16' runs the bf16 kernel's explicit backward
    (``kernels.ref.virtual_pathway_bwd_ref_bf16``) instead."""
    if resolve_precision(precision) == BF16:
        return virtual_pathway_bwd_ref_bf16(*operands)
    prim, cots = operands[:15], operands[15:]
    diff = [t.detach().requires_grad_(True)
            for i, t in enumerate(prim) if i != 3]
    with torch.enable_grad():
        outs = virtual_pathway_plain(diff[0], diff[1], diff[2],
                                     prim[3].detach(), *diff[3:])
        grads = torch.autograd.grad(outs, diff, grad_outputs=cots,
                                    allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, diff))


def virtual_pathway_bwd_fused(x: Tensor, h: Tensor, z: Tensor,
                              node_mask: Tensor, w1h: Tensor, w1d: Tensor,
                              const1: Tensor, w2: Tensor, b2: Tensor,
                              wg1: Tensor, bg1: Tensor, wg2: Tensor,
                              wz1: Tensor, bz1: Tensor, wz2: Tensor,
                              g_dx: Tensor, g_mh: Tensor, g_dz: Tensor,
                              g_ms: Tensor, *, precision=None):
    """Backward of :func:`virtual_pathway_fused` → ``(gx, gh, gz, gw1h,
    gw1d, gc1, gw2, gb2, gwg1, gbg1, gwg2, gwz1, gbz1, gwz2)``.

    CUDA tensors launch the kernels (f32 operands, ``precision`` as the
    forward's, any Dh and hid, routed as the forward) or raise; CPU
    tensors run :func:`virtual_pathway_bwd_plain`.
    """
    global bwd_launches
    bf16 = resolve_precision(precision) == BF16
    ops = (x, h, z, node_mask, w1h, w1d, const1, w2, b2, wg1, bg1, wg2, wz1,
           bz1, wz2)
    _check(ops)
    cots = (g_dx, g_mh, g_dz, g_ms)
    want = ((x.shape[0], 3), (x.shape[0], w1h.shape[2]), (z.shape[0], 3),
            (z.shape[0], w1h.shape[2]))
    for name, t, shape in zip(("g_dx", "g_mh", "g_dz", "g_ms"), cots, want):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in cots):
        raise RuntimeError("virtual_pathway_bwd_fused has no double "
                           "backward: pass cotangents without grad")
    if x.device.type != "cuda":
        return virtual_pathway_bwd_plain(*ops, *cots, precision=precision)
    dh, hid = h.shape[1], w1h.shape[2]
    route = kernel_route(dh, hid)
    d, w = padded_widths(route, dh, hid)
    n, c = x.shape[0], z.shape[0]
    pops = pad_ops(ops, d, w)
    grads = tuple(torch.empty_like(t) for i, t in enumerate(pops) if i != 3)
    pcots = (g_dx, pad_to(g_mh, n, w), g_dz, pad_to(g_ms, c, w))
    # the kernels read h, g_mh and the weights with 16-byte loads
    ins = [align16(t) for t in (*pops, *pcots)]
    if route == "panel":
        panel.virtual_backward(ins, grads, d, w, bf16)
    else:
        lib = build.load("virtual_message_bwd", _bind_bwd)
        # the CTAs' partials; bf16: also the rounded weight stacks
        scratch = torch.empty(
            (int(lib.virtual_bwd_scratch_floats(n, c, w, int(bf16))),),
            dtype=torch.float32, device=x.device)
        ptrs = [t.data_ptr() for t in (*ins, *grads, scratch)]
        err = lib.virtual_backward(*ptrs, n, c, w, int(bf16),
                                   build.stream_ptr(x.device))
        build.check(lib, err, "virtual_backward")
    bwd_launches += 1
    route_launches[route] += 1
    precision_launches[prec_name(bf16)] += 1
    want = [t.shape for i, t in enumerate(ops) if i != 3]
    return tuple(unpad(g, s) for g, s in zip(grads, want))
