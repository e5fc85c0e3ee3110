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
    """k(a,b) = exp(−‖a−b‖²/(2σ²)); a: (..., M,3), b: (..., K,3) →
    (..., M,K)."""
    d2 = ((a[..., :, None, :] - b[..., None, :, :]) ** 2).sum(-1)
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
    """Eq. 10.  ``z``: (C,3) virtual coords, ``x``: (N,3) real coords,
    ``node_mask``: (N,) → a scalar; or a batch, (B,C,3), (B,N,3), (B,N) →
    (B,), the losses of its graphs, as ``jax.vmap`` of the reference.

    With ``sample_size`` and ``generator`` it draws that many real nodes
    of each graph (with replacement, probability ∝ ``node_mask``) for the
    cross term, graph after graph from the one generator, which must live
    on ``x``'s device.  ``use_kernel`` routes the O(N·C) cross term
    through ``kernels.ops.mmd_cross`` (on CUDA tensors one launch of each
    MMD kernel for the whole batch); the C×C virtual-virtual term stays
    plain.
    """
    if z.dim() == 2:
        return mmd_loss(z[None], x[None], node_mask[None], sigma=sigma,
                        sample_size=sample_size, generator=generator,
                        use_kernel=use_kernel)[0]
    c = z.shape[1]
    term_vv = rbf_kernel(z, z, sigma).sum((-2, -1)) / (c * c)
    if sample_size is not None and generator is not None:
        idx = torch.stack([
            torch.multinomial((m > 0).to(x.dtype), sample_size,
                              replacement=True, generator=generator)
            for m in node_mask])
        xs = torch.gather(x, 1, idx[..., None].expand(-1, -1, 3))
        w = torch.ones(idx.shape, dtype=x.dtype, device=x.device)
    else:
        xs = x
        w = node_mask
    denom = torch.clamp(w.sum(-1), min=1.0) * c
    if use_kernel:
        from repro_torch.core.message_passing import record_dispatch
        from repro_torch.kernels.ops import mmd_cross

        record_dispatch("mmd_kernel")
        return term_vv - mmd_cross(xs, z, w, sigma) / denom
    k_xz = rbf_kernel(xs, z, sigma)  # (B, M, C)
    return term_vv - (k_xz * w[..., None]).sum((-2, -1)) / denom
