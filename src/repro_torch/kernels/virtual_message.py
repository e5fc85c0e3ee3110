"""The virtual-node pathway: CUDA kernel wrappers (forward and backward),
plain versions, launch counters.

:func:`virtual_pathway_fused` returns ``(dx (N,3), mh (N,hid), dz_sum
(C,3), ms_sum (C,hid))``, the contract of
``kernels.ref.virtual_pathway_ref``.  For CUDA tensors it launches
``csrc/virtual_message.cu`` (which replaces the JAX package's Pallas
``virtual_pathway_fused``): the main kernel, one CTA per 64-node tile,
writes dx and mh and one row of partial sums per CTA and channel into a
scratch tensor this wrapper allocates, and a second kernel adds the CTAs
in order.  ``launches`` counts calls (two kernels each).  CPU tensors run
:func:`virtual_pathway_plain`.

:func:`virtual_pathway_bwd_fused` returns the 14 gradients of the forward
(all operands but the node mask) from its primals and the four output
cotangents.  For CUDA tensors it launches ``csrc/virtual_message_bwd.cu``
(which replaces the Pallas ``virtual_pathway_bwd_fused``): the main
kernel and the reduction of its partials; ``bwd_launches`` counts calls.
CPU tensors run :func:`virtual_pathway_bwd_plain`.  Gradients flow through
``kernels.ops.VirtualPathway``; both raw wrappers refuse inputs that
require grad.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import virtual_pathway_ref
from repro_torch.kernels.runtime import align16, require_f32

Tensor = torch.Tensor

#: calls of the CUDA virtual forward (two kernels each) since
#: :func:`reset_launches`
launches = 0
#: calls of the CUDA virtual backward (two kernels each) since
#: :func:`reset_launches`
bwd_launches = 0

#: the width the CUDA kernel is compiled for (Dh = hid)
KERNEL_WIDTH = 64


def reset_launches() -> None:
    global launches, bwd_launches
    launches = bwd_launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    lib.virtual_forward.argtypes = ([ctypes.c_void_p] * 18
                                    + [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p])
    lib.virtual_forward.restype = ctypes.c_int
    lib.virtual_sums.argtypes = ([ctypes.c_void_p] * 3
                                 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p])
    lib.virtual_sums.restype = ctypes.c_int
    lib.virtual_nodes_per_block.restype = ctypes.c_int
    lib.virtual_partial_width.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    lib.virtual_bwd_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.virtual_bwd_scratch_floats.restype = ctypes.c_longlong
    lib.virtual_backward.argtypes = ([ctypes.c_void_p] * 34
                                     + [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p])
    lib.virtual_backward.restype = ctypes.c_int


def virtual_pathway_plain(*operands):
    """The kernel's function in plain PyTorch (``virtual_pathway_ref``)."""
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

    CUDA tensors launch the kernel (f32, Dh = hid = 64) or raise; CPU
    tensors run :func:`virtual_pathway_plain`.
    """
    global launches
    require_f32(precision)
    ops = (x, h, z, node_mask, w1h, w1d, const1, w2, b2, wg1, bg1, wg2, wz1,
           bz1, wz2)
    _check(ops)
    if x.device.type != "cuda":
        return virtual_pathway_plain(*ops)
    d = KERNEL_WIDTH
    if h.shape[1] != d or w1h.shape[2] != d:
        raise ValueError(f"CUDA virtual kernel needs Dh = hid = {d}, got "
                         f"Dh={h.shape[1]}, hid={w1h.shape[2]}")
    lib = build.load("virtual_message", _bind)
    n, c = x.shape[0], z.shape[0]
    n_blocks = -(-n // lib.virtual_nodes_per_block())
    dev = x.device
    dx = torch.empty((n, 3), dtype=torch.float32, device=dev)
    mh = torch.empty((n, d), dtype=torch.float32, device=dev)
    part = torch.empty((n_blocks, c, lib.virtual_partial_width()),
                       dtype=torch.float32, device=dev)
    dz = torch.empty((c, 3), dtype=torch.float32, device=dev)
    ms = torch.empty((c, d), dtype=torch.float32, device=dev)
    stream = build.stream_ptr(dev)
    # the kernel reads h and the 64x64 weights with 16-byte loads
    ins = [align16(t) for t in ops]
    err = lib.virtual_forward(*[t.data_ptr() for t in (*ins, dx, mh, part)],
                              n, c, stream)
    build.check(lib, err, "virtual_forward")
    launches += 1
    err = lib.virtual_sums(part.data_ptr(), dz.data_ptr(), ms.data_ptr(),
                           n_blocks, c, stream)
    build.check(lib, err, "virtual_sums")
    return dx, mh, dz, ms


def virtual_pathway_bwd_plain(*operands):
    """``torch.autograd.grad`` of :func:`virtual_pathway_plain`: operands
    are the forward's 15 followed by the four cotangents ``(g_dx, g_mh,
    g_dz, g_ms)``; returns the 14 gradients (no node-mask gradient)."""
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

    CUDA tensors launch the kernel (f32, Dh = hid = 64) or raise; CPU
    tensors run :func:`virtual_pathway_bwd_plain`.
    """
    global bwd_launches
    require_f32(precision)
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
        return virtual_pathway_bwd_plain(*ops, *cots)
    d = KERNEL_WIDTH
    if h.shape[1] != d or w1h.shape[2] != d:
        raise ValueError(f"CUDA virtual kernel needs Dh = hid = {d}, got "
                         f"Dh={h.shape[1]}, hid={w1h.shape[2]}")
    lib = build.load("virtual_message_bwd", _bind_bwd)
    n, c = x.shape[0], z.shape[0]
    grads = tuple(torch.empty_like(t) for i, t in enumerate(ops) if i != 3)
    scratch = torch.empty((int(lib.virtual_bwd_scratch_floats(n, c)),),
                          dtype=torch.float32, device=x.device)
    # the kernel reads h, g_mh and the 64x64 weights with 16-byte loads
    ins = [align16(t) for t in (*ops, *cots)]
    ptrs = [t.data_ptr() for t in (*ins, *grads, scratch)]
    err = lib.virtual_backward(*ptrs, n, c, build.stream_ptr(x.device))
    build.check(lib, err, "virtual_backward")
    bwd_launches += 1
    return grads
