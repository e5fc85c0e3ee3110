"""Maximum Mean Discrepancy objective (Eq. 10) with an E(3)-invariant RBF
kernel.

L_MMD = 1/C² Σ_ij k(z_i, z_j) − 2/(NC) Σ_ij k(x_i, z_j)

(The paper drops the constant real-real term; the cross term is written
with coefficient 1/(NC), as in the paper.)  Minimising the first term
spreads the virtual nodes apart; minimising the negated cross term pulls
them onto the real distribution.

A subset of real nodes may be sampled per step (Table IX: 3–50), drawn
from an explicit ``torch.Generator`` — sampling happens at training time
only, so the model's equivariance is untouched (Sec. IV-C).
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor


def rbf_kernel(a: Tensor, b: Tensor, sigma: float) -> Tensor:
    """k(a,b) = exp(−‖a−b‖²/(2σ²)); a: (M,3), b: (K,3) → (M,K)."""
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return torch.exp(-d2 / (2.0 * sigma * sigma))


def mmd_loss(
    z: Tensor,
    x: Tensor,
    node_mask: Tensor,
    *,
    sigma: float = 1.5,
    sample_size: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    use_kernel: bool = False,
) -> Tensor:
    """Eq. 10.  ``z``: (C,3) virtual coords, ``x``: (N,3) real coords.

    With ``sample_size`` and ``generator`` it draws that many real nodes
    (with replacement, probability ∝ ``node_mask``) for the cross term;
    the generator must live on ``x``'s device.  ``use_kernel`` routes the
    O(N·C) cross term through ``kernels.ops.mmd_cross`` (the CUDA kernels
    on CUDA tensors); the C×C virtual-virtual term stays plain.
    """
    c = z.shape[0]
    term_vv = rbf_kernel(z, z, sigma).sum() / (c * c)
    if sample_size is not None and generator is not None:
        idx = torch.multinomial((node_mask > 0).to(x.dtype), sample_size,
                                replacement=True, generator=generator)
        xs = x[idx]
        w = torch.ones((sample_size,), dtype=x.dtype, device=x.device)
    else:
        xs = x
        w = node_mask
    denom = torch.clamp(w.sum(), min=1.0) * c
    if use_kernel:
        from repro_torch.core.message_passing import record_dispatch
        from repro_torch.kernels.ops import mmd_cross

        record_dispatch("mmd_kernel")
        return term_vv - mmd_cross(xs, z, w, sigma) / denom
    k_xz = rbf_kernel(xs, z, sigma)  # (M, C)
    return term_vv - (k_xz * w[:, None]).sum() / denom
