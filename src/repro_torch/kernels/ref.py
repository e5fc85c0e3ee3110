"""Plain PyTorch oracles of the kernels (their ground truth).

Each function computes one kernel's contract with ordinary tensor ops;
the CPU tests hold them against the JAX package, and ``chip_smoke.py``
holds the CUDA kernels against them on the card.
"""
from __future__ import annotations

import math

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


# ------------------------------------------------------------ bf16 mode
# The JAX package's kernels take a static ``precision``; in bf16 mode
# (``runtime.BF16``) every matmul operand is cast to bfloat16 and every
# product summed in f32 (DESIGN.md §9.3).  The functions below follow the
# Pallas kernels' casts literally -- not ``kernels/ref.py`` of the JAX
# package, which ignores precision: a value is rounded (``_b``: to
# bfloat16, round to nearest even, NaN kept, held in f32) exactly where
# the kernel source casts it, and every sum runs in f32.  A product of two
# rounded values is exact in f32, so ``_b(a) @ _b(b)`` is the kernels'
# bf16 matmul with f32 accumulation.  The backwards are written out after
# the kernels' (`_edge_bwd_common`, the virtual `_bwd_kernel`): autograd
# of a bf16 forward would round at other places.


def _b(t: Tensor) -> Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def _silu_grad(u: Tensor) -> Tensor:
    s = torch.sigmoid(u)
    return s * (1.0 + u * (1.0 - s))


def _edge_recompute(x, h, rcv, snd, w1r, w1s, w1d, b1, w2, b2):
    """The edge forward's chain per live edge, operands already rounded:
    ``(rel, d2, pre1, t1, msg)``."""
    rel = x[rcv] - x[snd]  # one-hot gathers: exact, in f32
    d2 = (rel * rel).sum(-1, keepdim=True)
    pre1 = h[rcv] @ w1r + h[snd] @ w1s + _b(d2) @ w1d + b1
    t1 = F.silu(pre1)
    return rel, d2, pre1, t1, _b(t1) @ w2 + b2


def edge_pathway_ref_bf16(x, h, snd, rcv, em, w1r, w1s, w1d, b1, w2, b2, wg1,
                          bg1, wg2, *, gate_mode="mlp", rel_mode="raw",
                          clamp=float("inf")):
    """:func:`edge_pathway_ref` in the Pallas kernel's bf16 mode
    (`_edge_kernel`): x, h and the weights rounded at the boundary, the
    segment sums one-hot matmuls, so their summands are rounded too."""
    n = x.shape[0]
    x, h = _b(x), _b(h)
    w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2 = (
        _b(w) for w in (w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2))
    snd, rcv, em = live_edges(snd, rcv, em)
    rel, d2, _, _, msg = _edge_recompute(x, h, rcv, snd, w1r, w1s, w1d, b1,
                                         w2, b2)
    em2 = em[:, None]
    m = msg.shape[1]
    if gate_mode == "none":
        dx_e = torch.zeros_like(rel)
    else:
        if gate_mode == "mlp":
            gate = _b(F.silu(_b(msg) @ wg1 + bg1)) @ wg2
        else:
            gate = msg
        gate = torch.clamp(gate, -clamp, clamp)
        if rel_mode == "inv1p":
            rel = rel / (torch.sqrt(d2 + 1e-12) + 1.0)
        dx_e = _b(rel * gate * em2)
    sums = segment_sum(torch.cat([_b(msg * em2), dx_e, _b(em2)], dim=-1),
                       rcv, n)
    deg = sums[:, -1:]
    inv = 1.0 / torch.clamp(deg, min=1.0)
    return sums[:, m:m + 3] * inv, sums[:, :m] * inv, deg


def edge_pathway_bwd_ref_bf16(x, h, snd, rcv, em, w1r, w1s, w1d, b1, w2, b2,
                              wg1, bg1, wg2, deg, g_dx, g_mh, *,
                              gate_mode="mlp", rel_mode="raw",
                              clamp=float("inf")):
    """The Pallas edge backward's bf16 mode (`_edge_bwd_common` and its
    receiver / sender passes) → the 11 gradients ``(x, h, w1r, w1s, w1d,
    b1, w2, b2, wg1, bg1, wg2)``, f32; the gate's are zeros unless gate
    'mlp'."""
    n = x.shape[0]
    ws = (w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2)
    zeros = [torch.zeros_like(t) for t in (x, h, *ws)]
    x, h = _b(x), _b(h)
    w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2 = (_b(w) for w in ws)
    snd, rcv, em = live_edges(snd, rcv, em)
    if snd.shape[0] == 0:
        return tuple(zeros)
    rel, d2, pre1, t1, msg = _edge_recompute(x, h, rcv, snd, w1r, w1s, w1d,
                                             b1, w2, b2)
    inv = 1.0 / torch.clamp(deg, min=1.0)
    scale = _b(inv[rcv]) * em[:, None]  # the gathered upstream factor
    g_msg = _b(g_mh[rcv]) * scale
    g_rel = torch.zeros_like(rel)
    g_d2 = torch.zeros_like(d2)
    grads_gate = zeros[8:]
    if gate_mode != "none":
        p = _b(g_dx[rcv]) * scale
        if gate_mode == "mlp":
            gp1 = _b(msg) @ wg1 + bg1
            gt = F.silu(gp1)
            gate_pre = _b(gt) @ wg2
        else:
            gate_pre = msg
        gate = torch.clamp(gate_pre, -clamp, clamp)
        if rel_mode == "inv1p":
            sd = torch.sqrt(d2 + 1e-12)
            kf = 1.0 / (sd + 1.0)
            rel_used = rel * kf
        else:
            rel_used = rel
        g_gate = (p * rel_used).sum(-1, keepdim=True)
        g_rel_used = p * gate
        if math.isfinite(clamp):
            inside = (gate_pre >= -clamp) & (gate_pre <= clamp)
            g_gate = g_gate * inside.to(g_gate.dtype)
        if gate_mode == "mlp":
            g_gp1 = (_b(g_gate) @ wg2.T) * _silu_grad(gp1)
            g_msg = g_msg + _b(g_gp1) @ wg1.T
            grads_gate = [_b(msg).T @ _b(g_gp1), g_gp1.sum(0, keepdim=True),
                          _b(gt).T @ _b(g_gate)]
        else:
            g_msg = g_msg + g_gate
        if rel_mode == "inv1p":
            g_rel = g_rel_used * kf
            g_d2 = ((g_rel_used * rel).sum(-1, keepdim=True)
                    * (-(kf * kf) / (2.0 * sd)))
        else:
            g_rel = g_rel_used
    g_pre1 = (_b(g_msg) @ w2.T) * _silu_grad(pre1)
    gp = _b(g_pre1)
    g_d2 = g_d2 + gp @ w1d.T
    g_rel_tot = g_rel + 2.0 * rel * g_d2
    gx = (segment_sum(_b(g_rel_tot), rcv, n)
          + segment_sum(_b(-g_rel_tot), snd, n))
    gh = (segment_sum(_b(gp @ w1r.T), rcv, n)
          + segment_sum(_b(gp @ w1s.T), snd, n))
    return (gx, gh, h[rcv].T @ gp, h[snd].T @ gp, _b(d2).T @ gp,
            g_pre1.sum(0, keepdim=True), _b(t1).T @ _b(g_msg),
            g_msg.sum(0, keepdim=True), *grads_gate)


def _virtual_rel_d2(x: Tensor, zc: Tensor) -> tuple[Tensor, Tensor]:
    """``rel = x − z_c`` and ``d2 = |rel|²`` in bfloat16 arithmetic: each
    op rounded; the 3-term sum in f32 (``jnp.sum`` upcasts bf16), then
    rounded."""
    rel = _b(x - zc[None, :])
    return rel, _b(_b(rel * rel).sum(-1, keepdim=True))


def _virtual_channel(x, h, zc, w1h, w1d, c1, w2, b2, wg1, bg1, wg2, wz1,
                     bz1, wz2):
    """One channel's forward chain, operands already rounded."""
    rel, d2 = _virtual_rel_d2(x, zc)
    pre1 = h @ w1h + _b(d2 * w1d[None, :]) + c1[None, :]
    t1 = F.silu(pre1)
    msg = _b(t1) @ w2 + b2[None, :]
    gpx = _b(msg) @ wg1 + bg1[None, :]
    gpz = _b(msg) @ wz1 + bz1[None, :]
    return rel, d2, pre1, t1, msg, gpx, gpz


def virtual_pathway_ref_bf16(x, h, z, node_mask, w1h, w1d, const1, w2, b2,
                             wg1, bg1, wg2, wz1, bz1, wz2):
    """:func:`virtual_pathway_ref` in the Pallas kernel's bf16 mode
    (`_kernel`): x, h, z and the stacks rounded at the boundary, ``rel``,
    ``d2`` and ``d2 w1d`` bfloat16 arithmetic, every sum f32."""
    x, h, z = _b(x), _b(h), _b(z)
    ws = [_b(w) for w in (w1h, w1d, const1, w2, b2, wg1, bg1, wg2, wz1, bz1,
                          wz2)]
    mb = node_mask[:, None]
    n_chan = z.shape[0]
    dx = torch.zeros_like(x)
    mh = x.new_zeros((x.shape[0], w2.shape[2]))
    dz, ms = [], []
    for c in range(n_chan):
        wc = [w[c] for w in ws]
        rel, _, _, _, msg, gpx, gpz = _virtual_channel(x, h, z[c], *wc)
        gate_x = _b(F.silu(gpx)) @ wc[7]
        gate_z = _b(F.silu(gpz)) @ wc[10]
        dx = dx + rel * gate_x
        mh = mh + msg
        dz.append((-rel * gate_z * mb).sum(0))
        ms.append((msg * mb).sum(0))
    return dx / n_chan, mh / n_chan, torch.stack(dz), torch.stack(ms)


def virtual_pathway_bwd_ref_bf16(x, h, z, node_mask, w1h, w1d, const1, w2,
                                 b2, wg1, bg1, wg2, wz1, bz1, wz2, g_dx, g_mh,
                                 g_dz, g_ms):
    """The Pallas virtual backward's bf16 mode (`_bwd_kernel`) → the 14
    gradients ``(x, h, z, w1h, w1d, const1, w2, b2, wg1, bg1, wg2, wz1,
    bz1, wz2)``, f32."""
    x, h, z = _b(x), _b(h), _b(z)
    ws = [_b(w) for w in (w1h, w1d, const1, w2, b2, wg1, bg1, wg2, wz1, bz1,
                          wz2)]
    mb = node_mask[:, None]
    n_chan = z.shape[0]
    u_x = g_dx * (1.0 / n_chan)
    gmh = g_mh * (1.0 / n_chan)
    gx = torch.zeros_like(x)
    gh = torch.zeros_like(h)
    gz, per_chan = [], []
    for c in range(n_chan):
        wc = [w[c] for w in ws]
        (w1h_c, w1d_c, _, w2_c, _, wg1_c, _, wg2_c, wz1_c, _,
         wz2_c) = wc
        rel, d2, pre1, t1, msg, gpx, gpz = _virtual_channel(x, h, z[c], *wc)
        sx, sz = F.silu(gpx), F.silu(gpz)
        gate_x, gate_z = _b(sx) @ wg2_c, _b(sz) @ wz2_c
        u_z = -mb * g_dz[c][None, :]
        g_gx = (u_x * rel).sum(-1, keepdim=True)
        g_gz = (u_z * rel).sum(-1, keepdim=True)
        g_msg = gmh + mb * g_ms[c][None, :]
        g_gpx = (_b(g_gx) @ wg2_c.T) * _silu_grad(gpx)
        g_msg = g_msg + _b(g_gpx) @ wg1_c.T
        g_gpz = (_b(g_gz) @ wz2_c.T) * _silu_grad(gpz)
        g_msg = g_msg + _b(g_gpz) @ wz1_c.T
        g_pre1 = (_b(g_msg) @ w2_c.T) * _silu_grad(pre1)
        gp = _b(g_pre1)
        gh = gh + gp @ w1h_c.T
        g_d2 = (g_pre1 * w1d_c[None, :]).sum(-1, keepdim=True)
        g_rel = u_x * gate_x + u_z * gate_z + 2.0 * rel * g_d2
        gx = gx + g_rel
        gz.append(-g_rel.sum(0))
        per_chan.append((
            h.T @ gp, (d2 * g_pre1).sum(0), g_pre1.sum(0),
            _b(t1).T @ _b(g_msg), g_msg.sum(0),
            _b(msg).T @ _b(g_gpx), g_gpx.sum(0), _b(sx).T @ _b(g_gx),
            _b(msg).T @ _b(g_gpz), g_gpz.sum(0), _b(sz).T @ _b(g_gz)))
    stacks = tuple(torch.stack(t) for t in zip(*per_chan))
    return (gx, gh, torch.stack(gz), *stacks)
