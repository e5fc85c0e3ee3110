"""E(3) helpers: random group elements and their action on coordinates.

The group elements are drawn from an explicit ``torch.Generator`` (on the
CPU, so the same seed gives the same element on every device) and placed
on ``device`` — CUDA by default, raising without a GPU
(``kernels.runtime.resolve_device``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.runtime import resolve_device

Tensor = torch.Tensor


def random_rotation(gen: torch.Generator, device=None) -> Tensor:
    """Uniform random rotation in SO(3) (QR of a Gaussian, det fixed to +1),
    (3, 3) float32."""
    m = torch.randn((3, 3), generator=gen, dtype=torch.float64)
    q, r = torch.linalg.qr(m)
    # make R's diagonal positive for a unique QR, then fix the determinant
    q = q * torch.sign(torch.diagonal(r))[None, :]
    q[:, 0] = q[:, 0] * torch.linalg.det(q)  # reflect one axis if det == -1
    return q.to(torch.float32).to(resolve_device(device))


def random_orthogonal(gen: torch.Generator, device=None) -> Tensor:
    """Uniform random element of O(3) (a rotation or a roto-reflection)."""
    q = random_rotation(gen, device="cpu")
    if bool(torch.rand((), generator=gen) < 0.5):
        q[:, 0] = -q[:, 0]
    return q.to(resolve_device(device))


def apply_e3(x: Tensor, rot: Tensor, trans: Tensor) -> Tensor:
    """x (..., 3) → x @ R + t."""
    return x @ rot + trans


def apply_o3(x: Tensor, rot: Tensor) -> Tensor:
    return x @ rot


def com(x: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """Centre of mass of x (..., N, 3) over the nodes with mask 1."""
    if mask is None:
        return x.mean(-2)
    w = mask[..., None]
    return (x * w).sum(-2) / torch.clamp(w.sum(-2), min=1.0)
