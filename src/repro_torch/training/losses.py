"""Training objectives: masked MSE + the paper's MMD regulariser (Eq. 11).

Each takes one graph, or a batch of them along a leading axis (one value
per graph), as ``jax.vmap`` of the reference's objectives gives.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.collectives import GraphAxis, graph_sum_parts
from repro_torch.core.mmd import mmd_loss

Tensor = torch.Tensor


def masked_mse(pred: Tensor, target: Tensor, node_mask: Tensor,
               axis: Optional[GraphAxis] = None) -> Tensor:
    """Mean over real nodes of ‖pred − target‖² (per-coordinate mean):
    (N,3), (N,3), (N,) → a scalar, or (B,N,3), (B,N,3), (B,N) → (B,).

    With ``axis``: the global mean over every shard's nodes (DistEGNN's
    Eq. 18 summed over devices, the full graph's MSE)."""
    err = ((pred - target) ** 2).sum(-1) * node_mask
    tot, cnt = graph_sum_parts((err.sum(-1), node_mask.sum(-1)), axis)
    return tot / torch.clamp(cnt, min=1.0) / 3.0


def combined_objective(
    x_pred: Tensor,
    x_target: Tensor,
    node_mask: Tensor,
    z_virtual: Optional[Tensor],
    *,
    lam: float = 0.0,
    sigma: float = 1.5,
    mmd_sample: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    use_kernel: bool = False,
) -> tuple[Tensor, dict]:
    """Eq. 11: L = MSE(X^L, X^GT) + λ·MMD(Z^L, X^GT) → ``(loss, parts)``,
    for one graph or a batch (``z_virtual`` (B,C,3): the loss and each
    part (B,), with one MMD call for the batch).

    ``use_kernel`` routes the MMD cross term through the kernels (the
    trainer forwards the model config's flag).  ``generator`` draws the
    ``mmd_sample`` nodes; without one the cross term runs over every real
    node.
    """
    mse = masked_mse(x_pred, x_target, node_mask)
    aux = {"mse": mse}
    loss = mse
    if z_virtual is not None and lam > 0.0:
        mmd = mmd_loss(z_virtual, x_target, node_mask, sigma=sigma,
                       sample_size=mmd_sample, generator=generator,
                       use_kernel=use_kernel)
        aux["mmd"] = mmd
        loss = loss + lam * mmd
    return loss, aux
