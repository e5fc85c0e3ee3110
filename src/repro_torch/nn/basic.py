"""Transformer primitives: norms, RoPE, dense layers, FFNs (plain dict trees).

The counterpart of the JAX package's ``nn/basic.py``.  Weights are
``(d_in, d_out)`` and applied as ``x @ w``, as there.  Initialisers draw
from an explicit ``torch.Generator`` on the generator's own device and
return the leaf on ``device`` in ``dtype`` (so a large model can be built
straight in bf16 on the card, one leaf at a time).  ``device`` goes through
``kernels.runtime.resolve_device``: CUDA by default, raising without a GPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.runtime import resolve_device

Tensor = torch.Tensor


# ------------------------------------------------------------------- init
def randn(gen: torch.Generator, shape, *, scale: float = 1.0, device=None,
          dtype=torch.float32) -> Tensor:
    """``scale · N(0, 1)`` of ``shape``: drawn in f32 on ``gen``'s device,
    returned on ``device`` (default CUDA) in ``dtype``."""
    t = torch.randn(tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    if scale != 1.0:
        t.mul_(scale)
    return t.to(device=resolve_device(device), dtype=dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None, *, device=None,
               dtype=torch.float32) -> Tensor:
    scale = scale if scale is not None else 1.0 / d_in ** 0.5
    return randn(gen, (d_in, d_out), scale=scale, device=device, dtype=dtype)


# ------------------------------------------------------------------- norms
def init_rmsnorm(d: int, *, device=None, dtype=torch.float32):
    # gemma-style (1 + scale)
    return {"scale": torch.zeros((d,), device=resolve_device(device),
                                 dtype=dtype)}


def rmsnorm(p, x: Tensor, eps: float = 1e-6) -> Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["scale"])).to(dt)


# -------------------------------------------------------------------- RoPE
def rope_freqs(d_head: int, theta: float = 10000.0, *, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=resolve_device(device))
                            / d_head))


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)  # (D/2,)
    ang = positions[..., :, None, None].to(torch.float32) * freqs  # (..., S, 1, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------------- FFNs
def _init_gated(gen, d: int, d_ff: int, device, dtype):
    return {"w_gate": dense_init(gen, d, d_ff, device=device, dtype=dtype),
            "w_up": dense_init(gen, d, d_ff, device=device, dtype=dtype),
            "w_down": dense_init(gen, d_ff, d, device=device, dtype=dtype)}


def init_swiglu(gen, d: int, d_ff: int, *, device=None, dtype=torch.float32):
    return _init_gated(gen, d, d_ff, device, dtype)


def swiglu(p, x: Tensor) -> Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def init_geglu(gen, d: int, d_ff: int, *, device=None, dtype=torch.float32):
    return _init_gated(gen, d, d_ff, device, dtype)


def geglu(p, x: Tensor) -> Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's does not
    return (F.gelu(x @ p["w_gate"], approximate="tanh")
            * (x @ p["w_up"])) @ p["w_down"]
