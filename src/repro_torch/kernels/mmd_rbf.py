"""The MMD RBF cross term and its gradient: CUDA kernel wrappers, plain
versions, launch counters.

:func:`mmd_cross_sum` returns the scalar Σ_i m_i Σ_c exp(−‖x_i−z_c‖²/2σ²)
(``kernels.ref.mmd_cross_ref``); :func:`mmd_cross_grads` returns its
``(dx (N,3), dz (C,3))`` for a scalar cotangent ``g`` (the mask is not
differentiated).  For CUDA tensors they launch ``csrc/mmd_rbf.cu`` (which
replaces the JAX package's Pallas ``mmd_cross_sum`` / ``mmd_cross_grads``)
or raise; for CPU tensors they run :func:`mmd_cross_sum_plain` /
:func:`mmd_cross_grads_plain`.  ``sum_launches`` / ``grad_launches`` count
kernel launches.  Gradients go through ``kernels.ops.MMDCross``; these raw
wrappers refuse inputs that require grad.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mmd_cross_ref

Tensor = torch.Tensor

#: launches of the CUDA cross-sum kernel since :func:`reset_launches`
sum_launches = 0
#: launches of the CUDA cross-gradient kernel since :func:`reset_launches`
grad_launches = 0


def reset_launches() -> None:
    global sum_launches, grad_launches
    sum_launches = grad_launches = 0


def _bind(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    lib.mmd_blocks.argtypes = [ctypes.c_int]
    lib.mmd_blocks.restype = ctypes.c_int
    lib.mmd_cross_sum_launch.argtypes = ([ctypes.c_void_p] * 5
                                         + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_void_p])
    lib.mmd_cross_sum_launch.restype = ctypes.c_int
    lib.mmd_cross_grads_launch.argtypes = ([ctypes.c_void_p] * 7
                                           + [ctypes.c_int, ctypes.c_int,
                                              ctypes.c_float, ctypes.c_void_p])
    lib.mmd_cross_grads_launch.restype = ctypes.c_int


def mmd_cross_sum_plain(x: Tensor, z: Tensor, node_mask: Tensor, *,
                        sigma: float) -> Tensor:
    """The kernel's function in plain PyTorch (``mmd_cross_ref``)."""
    return mmd_cross_ref(x, z, node_mask, sigma)


def mmd_cross_grads_plain(x: Tensor, z: Tensor, node_mask: Tensor, g: Tensor,
                          *, sigma: float) -> tuple[Tensor, Tensor]:
    """``torch.autograd.grad`` of :func:`mmd_cross_ref` for cotangent ``g``."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        zg = z.detach().requires_grad_(True)
        out = mmd_cross_ref(xg, zg, node_mask.detach(), sigma)
        dx, dz = torch.autograd.grad(out, (xg, zg), grad_outputs=g.detach())
    return dx, dz


def _check(x, z, node_mask, g=None) -> None:
    tensors = (x, z, node_mask) + (() if g is None else (g,))
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the raw MMD kernel wrappers have no backward kernel of their "
            "own: differentiate through kernels.ops.mmd_cross")
    dev = x.device
    for name, t in zip(("x", "z", "node_mask", "g"), tensors):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the MMD kernels need a contiguous {name}")
    n, c = x.shape[0], z.shape[0]
    if x.shape != (n, 3) or z.shape != (c, 3) or node_mask.shape != (n,):
        raise ValueError(f"need x (N,3), z (C,3), node_mask (N,); got "
                         f"{tuple(x.shape)}, {tuple(z.shape)}, "
                         f"{tuple(node_mask.shape)}")


def mmd_cross_sum(x: Tensor, z: Tensor, node_mask: Tensor, *,
                  sigma: float) -> Tensor:
    """Σ_i m_i Σ_c k(x_i, z_c) as a 0-d tensor.

    CUDA tensors launch the kernel (two stages, fixed order) or raise; CPU
    tensors run :func:`mmd_cross_sum_plain`.
    """
    global sum_launches
    _check(x, z, node_mask)
    if x.device.type != "cuda":
        return mmd_cross_sum_plain(x, z, node_mask, sigma=sigma)
    lib = build.load("mmd_rbf", _bind)
    n, c = x.shape[0], z.shape[0]
    part = torch.empty((max(lib.mmd_blocks(n), 1),), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    err = lib.mmd_cross_sum_launch(
        x.data_ptr(), z.data_ptr(), node_mask.data_ptr(), part.data_ptr(),
        out.data_ptr(), n, c, 2.0 * sigma * sigma, build.stream_ptr(x.device))
    build.check(lib, err, "mmd_cross_sum")
    sum_launches += 1
    return out


def mmd_cross_grads(x: Tensor, z: Tensor, node_mask: Tensor, g: Tensor, *,
                    sigma: float) -> tuple[Tensor, Tensor]:
    """``(dx, dz)`` of :func:`mmd_cross_sum` for the scalar cotangent ``g``.

    CUDA tensors launch the kernel (dz summed per block, then across blocks
    in index order) or raise; CPU tensors run :func:`mmd_cross_grads_plain`.
    """
    global grad_launches
    if g.numel() != 1:
        raise ValueError(f"g must be a scalar cotangent, got {tuple(g.shape)}")
    g = g.reshape(()).contiguous()
    _check(x, z, node_mask, g)
    if x.device.type != "cuda":
        return mmd_cross_grads_plain(x, z, node_mask, g, sigma=sigma)
    lib = build.load("mmd_rbf", _bind)
    n, c = x.shape[0], z.shape[0]
    dev = x.device
    part = torch.empty((max(lib.mmd_blocks(n), 1), c, 3), dtype=torch.float32,
                       device=dev)
    dx = torch.empty((n, 3), dtype=torch.float32, device=dev)
    dz = torch.empty((c, 3), dtype=torch.float32, device=dev)
    err = lib.mmd_cross_grads_launch(
        x.data_ptr(), z.data_ptr(), node_mask.data_ptr(), g.data_ptr(),
        dx.data_ptr(), part.data_ptr(), dz.data_ptr(), n, c,
        2.0 * sigma * sigma, build.stream_ptr(dev))
    build.check(lib, err, "mmd_cross_grads")
    grad_launches += 1
    return dx, dz
