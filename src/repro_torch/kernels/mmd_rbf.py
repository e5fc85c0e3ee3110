"""The MMD RBF cross term and its gradient: CUDA kernel wrappers, plain
versions, launch counters.

:func:`mmd_cross_sum` returns Σ_i m_i Σ_c exp(−‖x_i−z_c‖²/2σ²) per graph
(``kernels.ref.mmd_cross_ref``); :func:`mmd_cross_grads` returns its
``(dx, dz)`` for the cotangent ``g`` (the mask is not differentiated).
Both take a batch, x (B,N,3), z (B,C,3), mask (B,N) and g (B,), and
return (B,) / (B,N,3) and (B,C,3), as the JAX package's trainer gets
from ``jax.vmap`` over its kernels; unbatched inputs x (N,3), z (C,3),
mask (N,) and a scalar g run as B = 1 and return unbatched results.  For
CUDA tensors they launch ``csrc/mmd_rbf.cu`` (one kernel a call for any
B; it replaces the JAX package's Pallas ``mmd_cross_sum`` /
``mmd_cross_grads``) or raise; for CPU tensors they run
:func:`mmd_cross_sum_plain` / :func:`mmd_cross_grads_plain`.
``sum_launches`` / ``grad_launches`` count kernel launches.  Gradients go
through ``kernels.ops.MMDCross``; these raw wrappers refuse inputs that
require grad.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mmd_cross_ref

Tensor = torch.Tensor

#: launches of the CUDA cross-sum kernel since :func:`reset_launches`
sum_launches = 0
#: launches of the CUDA cross-gradient kernel since :func:`reset_launches`
grad_launches = 0

#: a graph's cluster: up to CTAS_MAX CTAs (above 8 the cluster size is
#: non-portable) of THREADS_MIN to THREADS_MAX threads, NODES_PER_THREAD
#: nodes a thread until both are at their largest
THREADS_MIN, THREADS_MAX, CTAS_MAX, NODES_PER_THREAD = 128, 1024, 16, 2

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    global sum_launches, grad_launches
    sum_launches = grad_launches = 0


def schedule(n: int) -> tuple[int, int]:
    """``(threads, ctas)`` of one graph's cluster for ``n`` nodes: as many
    CTAs as there is work for, then wider ones.  It fixes the kernels'
    summation order and depends on ``n`` alone, so that a graph's result
    does not depend on the batch around it."""
    per_cta = -(-n // (CTAS_MAX * NODES_PER_THREAD))
    threads = min(THREADS_MAX, max(THREADS_MIN, -(-per_cta // 32) * 32))
    return threads, min(CTAS_MAX,
                        max(1, -(-n // (threads * NODES_PER_THREAD))))


def _bind(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mmd_cross_sum_launch.argtypes = [p] * 4 + [i, i, i, ctypes.c_float,
                                                   i, i, p]
    lib.mmd_cross_sum_launch.restype = i
    lib.mmd_cross_grads_launch.argtypes = [p] * 6 + [i, i, i, ctypes.c_float,
                                                     i, i, p]
    lib.mmd_cross_grads_launch.restype = i


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = build.load("mmd_rbf", _bind)
    return _lib


def mmd_cross_sum_plain(x: Tensor, z: Tensor, node_mask: Tensor, *,
                        sigma: float) -> Tensor:
    """The kernel's function in plain PyTorch (``mmd_cross_ref``)."""
    return mmd_cross_ref(x, z, node_mask, sigma)


def mmd_cross_grads_plain(x: Tensor, z: Tensor, node_mask: Tensor, g: Tensor,
                          *, sigma: float) -> tuple[Tensor, Tensor]:
    """``torch.autograd.grad`` of :func:`mmd_cross_ref` for cotangent ``g``
    (shaped as its result: (B,), or 0-d unbatched)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        zg = z.detach().requires_grad_(True)
        out = mmd_cross_ref(xg, zg, node_mask.detach(), sigma)
        dx, dz = torch.autograd.grad(out, (xg, zg),
                                     grad_outputs=g.detach().reshape(
                                         out.shape))
    return dx, dz


def _fail(x, z, node_mask, g) -> None:
    """Raise for inputs the kernels do not take (the slow path of
    :func:`_batched`'s checks)."""
    for name, t in zip(("x", "z", "node_mask", "g"), (x, z, node_mask, g)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, expected {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the MMD kernels need a contiguous {name}")
    raise ValueError(
        f"need x (B,N,3), z (B,C,3), node_mask (B,N), g (B,) or their "
        f"unbatched forms; got {tuple(x.shape)}, {tuple(z.shape)}, "
        f"{tuple(node_mask.shape)}" + ("" if g is None else
                                        f", {tuple(g.shape)}"))


def _batched(x, z, node_mask, g=None):
    """The checks that guard the kernel, and the inputs in batch form:
    ``(x, z, node_mask, g, batched)``."""
    if torch.is_grad_enabled() and (
            x.requires_grad or z.requires_grad or node_mask.requires_grad
            or (g is not None and g.requires_grad)):
        raise RuntimeError(
            "the raw MMD kernel wrappers have no backward kernel of their "
            "own: differentiate through kernels.ops.mmd_cross")
    batched = x.dim() == 3
    if not batched:
        if x.dim() != 2:
            _fail(x, z, node_mask, g)
        if g is not None and g.numel() != 1:
            raise ValueError(f"g must be a scalar cotangent, got "
                             f"{tuple(g.shape)}")
        x, z, node_mask = x[None], z[None], node_mask[None]
        g = None if g is None else g.reshape(1)
    b, n = x.shape[0], x.shape[1]
    dev = x.device
    if (x.shape[2] != 3 or z.dim() != 3 or z.shape[0] != b or z.shape[2] != 3
            or node_mask.shape != (b, n)
            or (g is not None and g.shape != (b,))
            or z.device != dev or node_mask.device != dev
            or (g is not None and g.device != dev)
            or x.dtype != torch.float32 or z.dtype != torch.float32
            or node_mask.dtype != torch.float32
            or (g is not None and g.dtype != torch.float32)
            or not (x.is_contiguous() and z.is_contiguous()
                    and node_mask.is_contiguous()
                    and (g is None or g.is_contiguous()))):
        _fail(x, z, node_mask, g)
    return x, z, node_mask, g, batched


def mmd_cross_sum(x: Tensor, z: Tensor, node_mask: Tensor, *,
                  sigma: float) -> Tensor:
    """Σ_i m_i Σ_c k(x_i, z_c) per graph: (B,), or 0-d unbatched.

    CUDA tensors launch the kernel (one launch, fixed order) or raise; CPU
    tensors run :func:`mmd_cross_sum_plain`.
    """
    global sum_launches
    xb, zb, mb, _, batched = _batched(x, z, node_mask)
    if x.device.type != "cuda":
        return mmd_cross_sum_plain(x, z, node_mask, sigma=sigma)
    lib = _library()
    b, n, c = xb.shape[0], xb.shape[1], zb.shape[1]
    threads, ctas = schedule(n)
    out = torch.empty((b,), dtype=torch.float32, device=x.device)
    err = lib.mmd_cross_sum_launch(
        xb.data_ptr(), zb.data_ptr(), mb.data_ptr(), out.data_ptr(), b, n, c,
        -0.5 / (sigma * sigma), threads, ctas, build.stream_ptr(x.device))
    build.check(lib, err, "mmd_cross_sum")
    sum_launches += 1
    return out if batched else out[0]


def mmd_cross_grads(x: Tensor, z: Tensor, node_mask: Tensor, g: Tensor, *,
                    sigma: float) -> tuple[Tensor, Tensor]:
    """``(dx, dz)`` of :func:`mmd_cross_sum` for the cotangent ``g``.

    CUDA tensors launch the kernel (dz summed per CTA in a fixed tree, then
    across the graph's CTAs in rank order) or raise; CPU tensors run
    :func:`mmd_cross_grads_plain`.
    """
    global grad_launches
    xb, zb, mb, gb, batched = _batched(x, z, node_mask, g)
    if x.device.type != "cuda":
        return mmd_cross_grads_plain(x, z, node_mask, g, sigma=sigma)
    lib = _library()
    b, n, c = xb.shape[0], xb.shape[1], zb.shape[1]
    threads, ctas = schedule(n)
    dx = torch.empty(xb.shape, dtype=torch.float32, device=x.device)
    dz = torch.empty(zb.shape, dtype=torch.float32, device=x.device)
    err = lib.mmd_cross_grads_launch(
        xb.data_ptr(), zb.data_ptr(), mb.data_ptr(), gb.data_ptr(),
        dx.data_ptr(), dz.data_ptr(), b, n, c, -0.5 / (sigma * sigma),
        threads, ctas, build.stream_ptr(x.device))
    build.check(lib, err, "mmd_cross_grads")
    grad_launches += 1
    return (dx, dz) if batched else (dx[0], dz[0])
