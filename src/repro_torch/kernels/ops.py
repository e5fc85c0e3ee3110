"""Glue between the model's parameter dicts and the kernels (forward only).

* :func:`unpack_edge_params` / :func:`unpack_virtual_block` slice the
  model's MLP parameters into the kernels' flat weight layout (the latter
  also forms the node-independent φ2 layer-1 constant with a small einsum);
* :func:`edge_pathway` / :func:`virtual_pathway` feed the kernel wrappers.

There is no ``autograd.Function`` yet: the wrappers raise when asked for
gradients, so nothing can silently train through a forward-only kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.edge_message import edge_pathway_fused
from repro_torch.kernels.runtime import require_f32
from repro_torch.kernels.virtual_message import virtual_pathway_fused

Tensor = torch.Tensor


# ------------------------------------------------------------------- edge MP
def unpack_edge_params(lp, h: Tensor, spec) -> tuple[Tensor, tuple]:
    """Model params → the kernel's flat weight layout.

    φ1 layer-1 weight rows are ordered [h_r | h_s | d² | e_ij]; the matrix
    is pre-split per input slice.  Returns (h_for_kernel, weights).
    """
    n = h.shape[0]
    phi1 = lp["phi1"]
    w1, b1 = phi1[0]["w"], phi1[0]["b"]
    h1 = w1.shape[1]
    dh = h.shape[-1] if spec.use_h else 0
    zeros = lambda *s: torch.zeros(s, dtype=w1.dtype, device=w1.device)
    if dh > 0:
        hk = h
        w1r, w1s = w1[:dh], w1[dh:2 * dh]
    else:  # geometry-only models: a zero feature column keeps shapes ≥ 1
        hk = zeros(n, 1)
        w1r = w1s = zeros(1, h1)
    off = 2 * dh
    w1d = w1[off:off + 1] if spec.use_d2 else zeros(1, h1)
    w2 = phi1[1]["w"]
    m = w2.shape[1]
    b2 = phi1[1]["b"][None, :] if "b" in phi1[1] else zeros(1, m)
    if spec.gate == "mlp":
        gp = lp["gate"]
        wg1, bg1, wg2 = gp[0]["w"], gp[0]["b"][None, :], gp[1]["w"]
    else:  # unused by the 'identity'/'none' branches
        wg1 = bg1 = wg2 = zeros(1, 1)
    ws = (w1r, w1s, w1d, b1[None, :], w2, b2, wg1, bg1, wg2)
    return hk.contiguous(), tuple(w.contiguous() for w in ws)


def edge_pathway(lp, h: Tensor, x: Tensor, g, spec,
                 layout) -> tuple[Tensor, Tensor]:
    """Kernel-backed edge pathway → ``(dx (N,3), mh (N,M))``.

    ``layout`` is the graph's CSR layout ``(indptr, n_edges)``, valid for
    its receiver-sorted slot arrays (``data.radius_graph.csr_indptr``).
    The kernel walks ``indptr``; there is no layout-free route.
    """
    if layout is None:
        raise ValueError(
            "the kernel edge pathway needs the graph's CSR layout "
            "(indptr, n_edges) from data.radius_graph.csr_indptr")
    require_f32(spec.precision)
    hk, ws = unpack_edge_params(lp, h, spec)
    dx, mh, _deg = edge_pathway_fused(
        x.contiguous(), hk, g.senders.contiguous(), g.edge_mask.contiguous(),
        layout[0].contiguous(), *ws, gate_mode=spec.gate, rel_mode=spec.rel,
        clamp=float(spec.coord_clamp))
    return dx, mh


# ---------------------------------------------------------------- virtual MP
def unpack_virtual_block(vb, s: Tensor, mv: Tensor, h_dim: int) -> dict:
    """Per-channel stacks → kernel weight layout + the layer-1 constant.

    φ2 layer-1 weight rows are ordered [h | s | d² | m^v-column].
    """
    w1 = vb["phi2"][0]["w"]  # (C, msg_in, hid)
    b1 = vb["phi2"][0]["b"]  # (C, hid)
    s_dim = s.shape[-1]
    w1h = w1[:, :h_dim, :]
    w1s = w1[:, h_dim:h_dim + s_dim, :]
    w1d = w1[:, h_dim + s_dim, :]
    w1mv = w1[:, h_dim + s_dim + 1:, :]  # (C, C, hid)
    const1 = (torch.einsum("cs,csh->ch", s, w1s)
              + torch.einsum("ck,ckh->ch", mv.T, w1mv) + b1)
    out = dict(
        w1h=w1h, w1d=w1d, const1=const1,
        w2=vb["phi2"][1]["w"], b2=vb["phi2"][1]["b"],
        wg1=vb["phi_xv"][0]["w"], bg1=vb["phi_xv"][0]["b"],
        wg2=vb["phi_xv"][1]["w"],
        wz1=vb["phi_z"][0]["w"], bz1=vb["phi_z"][0]["b"],
        wz2=vb["phi_z"][1]["w"],
    )
    return {k: v.contiguous() for k, v in out.items()}


def virtual_pathway(vb, h: Tensor, x: Tensor, vs, mv: Tensor,
                    node_mask: Tensor, precision=None):
    """Kernel-backed virtual pathway → ``(dx, mh, dz_sum, ms_sum)``."""
    w = unpack_virtual_block(vb, vs.s, mv, h.shape[-1])
    return virtual_pathway_fused(
        x.contiguous(), h.contiguous(), vs.z.contiguous(),
        node_mask.contiguous(), w["w1h"], w["w1d"], w["const1"], w["w2"],
        w["b2"], w["wg1"], w["bg1"], w["wg2"], w["wz1"], w["bz1"], w["wz2"],
        precision=precision)
