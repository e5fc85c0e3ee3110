"""The virtual-node forward: CUDA kernel wrapper, plain version, launch
counter.

:func:`virtual_pathway_fused` returns ``(dx (N,3), mh (N,hid), dz_sum
(C,3), ms_sum (C,hid))``, the contract of
``kernels.ref.virtual_pathway_ref``.  For CUDA tensors it launches
``csrc/virtual_message.cu`` (which replaces the JAX package's Pallas
``virtual_pathway_fused``): the main kernel writes dx and mh and one row of
partial sums per block into a scratch tensor this wrapper allocates, and a
second kernel adds the blocks in order.  ``launches`` counts the main
kernel only.  CPU tensors run :func:`virtual_pathway_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import virtual_pathway_ref
from repro_torch.kernels.runtime import require_f32

Tensor = torch.Tensor

#: launches of the main CUDA virtual kernel since :func:`reset_launches`
launches = 0

#: the width the CUDA kernel is compiled for (Dh = hid)
KERNEL_WIDTH = 64


def reset_launches() -> None:
    global launches
    launches = 0


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


def virtual_pathway_plain(*operands):
    """The kernel's function in plain PyTorch (``virtual_pathway_ref``)."""
    return virtual_pathway_ref(*operands)


_SHAPES = ("x", "h", "z", "mask", "w1h", "w1d", "const1", "w2", "b2", "wg1",
           "bg1", "wg2", "wz1", "bz1", "wz2")


def _check(ops: tuple) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ops):
        raise RuntimeError(
            "virtual_pathway_fused has no backward kernel yet: call it under "
            "torch.no_grad() or with inputs that do not require grad")
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
    err = lib.virtual_forward(*[t.data_ptr() for t in (*ops, dx, mh, part)],
                              n, c, stream)
    build.check(lib, err, "virtual_forward")
    launches += 1
    err = lib.virtual_sums(part.data_ptr(), dz.data_ptr(), ms.data_ptr(),
                           n_blocks, c, stream)
    build.check(lib, err, "virtual_sums")
    return dx, mh, dz, ms
