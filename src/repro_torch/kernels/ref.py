"""Plain PyTorch oracles of the kernels (their ground truth).

Each function computes one kernel's contract with ordinary tensor ops;
the CPU tests hold them against the JAX package, and ``chip_smoke.py``
holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.message_passing import live_edges, segment_sum

Tensor = torch.Tensor


def virtual_pathway_ref(
    x: Tensor,  # (N, 3)
    h: Tensor,  # (N, Dh)
    z: Tensor,  # (C, 3)
    node_mask: Tensor,  # (N,)
    w1h: Tensor,  # (C, Dh, hid)   φ2 layer-1 weight for the h input
    w1d: Tensor,  # (C, hid)       φ2 layer-1 weight column for d²
    const1: Tensor,  # (C, hid)    φ2 layer-1 constant: W1_s s_c + W1_mv m^v_c + b1
    w2: Tensor,  # (C, hid, hid)   φ2 layer-2
    b2: Tensor,  # (C, hid)
    wg1: Tensor,  # (C, hid, hid)  φ_x^v layer-1
    bg1: Tensor,  # (C, hid)
    wg2: Tensor,  # (C, hid, 1)    φ_x^v layer-2 (no bias)
    wz1: Tensor,  # (C, hid, hid)  φ_Z layer-1
    bz1: Tensor,  # (C, hid)
    wz2: Tensor,  # (C, hid, 1)    φ_Z layer-2 (no bias)
):
    """Fused virtual pathway (Eq. 5 + virtual terms of Eqs. 6–8).

    Returns dx (N,3), mh (N,hid), dz_sum (C,3), ms_sum (C,hid).
    """
    rel = x[:, None, :] - z[None, :, :]  # (N, C, 3)
    d2 = (rel * rel).sum(-1)  # (N, C)
    t1 = (torch.einsum("nd,cdh->nch", h, w1h)
          + d2[:, :, None] * w1d[None] + const1[None])
    msg = torch.einsum("nch,chk->nck", F.silu(t1), w2) + b2[None]
    gate_x = torch.einsum("nch,chk->nck", F.silu(
        torch.einsum("nch,chk->nck", msg, wg1) + bg1[None]), wg2)
    gate_z = torch.einsum("nch,chk->nck", F.silu(
        torch.einsum("nch,chk->nck", msg, wz1) + bz1[None]), wz2)
    dx = (rel * gate_x).mean(1)
    mh = msg.mean(1)
    w = node_mask[:, None, None]
    dz_sum = (-rel * gate_z * w).sum(0)  # Σ (z_c − x_i)·φ_Z
    ms_sum = (msg * w).sum(0)
    return dx, mh, dz_sum, ms_sum


def edge_pathway_ref(
    x: Tensor,  # (N, 3)
    h: Tensor,  # (N, Dh)
    snd: Tensor,  # (E,) int
    rcv: Tensor,  # (E,) int
    em: Tensor,  # (E,) edge validity mask
    w1r: Tensor,  # (Dh, H1)   φ1 layer-1 weight rows for h_receiver
    w1s: Tensor,  # (Dh, H1)   φ1 layer-1 weight rows for h_sender
    w1d: Tensor,  # (1, H1)    φ1 layer-1 weight row for d²
    b1: Tensor,  # (1, H1)
    w2: Tensor,  # (H1, M)     φ1 layer-2
    b2: Tensor,  # (1, M)
    wg1: Tensor,  # (M, HG)    gate layer-1 (gate_mode='mlp' only)
    bg1: Tensor,  # (1, HG)
    wg2: Tensor,  # (HG, 1)    gate layer-2 (no bias)
    *,
    gate_mode: str = "mlp",  # 'mlp' | 'identity' | 'none'
    rel_mode: str = "raw",  # 'raw' | 'inv1p'
    clamp: float = float("inf"),
):
    """Fused real-real edge pathway (Eq. 3 + real parts of Eqs. 6-7).

    Returns (dx (N,3), mh (N,M), deg (N,1)): masked means onto receivers,
    summed in edge order (:func:`~repro_torch.core.message_passing.
    segment_sum`).  ``dx`` is zeros when gate_mode='none'.
    """
    n = x.shape[0]
    snd, rcv, em = live_edges(snd, rcv, em)
    rel = x[rcv] - x[snd]
    d2 = (rel * rel).sum(-1, keepdim=True)
    t1 = F.silu(h[rcv] @ w1r + h[snd] @ w1s + d2 @ w1d + b1)
    msg = t1 @ w2 + b2
    em2 = em[:, None]
    m = msg.shape[1]
    if gate_mode == "none":
        dx_e = torch.zeros_like(rel)
    else:
        if gate_mode == "mlp":
            gate = F.silu(msg @ wg1 + bg1) @ wg2
        else:
            gate = msg
        gate = torch.clamp(gate, -clamp, clamp)
        if rel_mode == "inv1p":
            rel = rel / (torch.sqrt(d2 + 1e-12) + 1.0)
        dx_e = rel * gate * em2
    sums = segment_sum(torch.cat([msg * em2, dx_e, em2], dim=-1), rcv, n)
    deg = sums[:, -1:]
    inv = 1.0 / torch.clamp(deg, min=1.0)
    mh = sums[:, :m] * inv
    dx = sums[:, m:m + 3] * inv
    return dx, mh, deg


def mmd_cross_ref(x: Tensor, z: Tensor, node_mask: Tensor,
                  sigma: float) -> Tensor:
    """Σ_i mask_i Σ_c exp(−‖x_i−z_c‖²/2σ²) — the MMD cross term numerator.

    x (..., N, 3), z (..., C, 3), node_mask (..., N) → (...): a batch of
    graphs (B,), or one graph, 0-d.
    """
    d2 = ((x[..., :, None, :] - z[..., None, :, :]) ** 2).sum(-1)
    k = torch.exp(-d2 / (2.0 * sigma * sigma))
    return (k * node_mask[..., None]).sum((-2, -1))


def swa_attention_ref(q: Tensor, k: Tensor, v: Tensor, window: int | None,
                      causal: bool = True) -> Tensor:
    """Sliding-window (optionally causal) attention oracle.

    q,k,v: (S, H, D) — single batch; window = number of past positions
    visible (None = unlimited).  softmax over masked logits, scaled by 1/√D.
    """
    s, _, d = q.shape
    logits = torch.einsum("qhd,khd->hqk", q, k) / torch.sqrt(
        torch.tensor(float(d), dtype=q.dtype, device=q.device))
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = torch.where(mask[None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v)
