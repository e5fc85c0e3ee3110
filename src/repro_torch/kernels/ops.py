"""Glue between the model's parameter dicts and the kernels, and the
``torch.autograd.Function``s that make them trainable.

* :func:`unpack_edge_params` / :func:`unpack_virtual_block` slice the
  model's MLP parameters into the kernels' flat weight layout (the latter
  also forms the node-independent φ2 layer-1 constant with a small einsum,
  so the const1 cotangent flows back to ``s``, ``m^v`` and ``b1`` through
  ordinary autograd);
* :class:`EdgePathway`, :class:`VirtualPathway` and :class:`MMDCross` run
  the forward kernel wrappers and, in ``backward``, the backward kernel
  wrappers (``edge_pathway_bwd_fused``, ``virtual_pathway_bwd_fused``,
  ``mmd_cross_grads``); on CPU tensors both directions run the plain
  versions, so the CPU tests exercise this glue too.  The first two are
  f32; :func:`edge_function` / :func:`virtual_function` give the Function
  of a precision (one class per precision, as the reference caches one
  ``custom_vjp`` per precision), whose kernels take that ``precision``
  in both directions;
* :func:`edge_pathway`, :func:`virtual_pathway` and :func:`mmd_cross` are
  the entry points the model and the loss call; :func:`mmd_loss_kernel`
  is the reference's one-graph Eq. 10 over :func:`mmd_cross`.

Differentiability contract (as the JAX package's ``kernels/ops.py``):
coordinates, features, virtual state and all weights get gradients; masks
get none, integer indices and the layout get ``None``, and the edge
forward's ``deg`` output is constant.  The raw wrappers refuse inputs that
require grad, so these Functions are the only way to differentiate
through a kernel.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.edge_message import (edge_pathway_bwd_fused,
                                              edge_pathway_fused)
from repro_torch.kernels.mmd_rbf import mmd_cross_grads, mmd_cross_sum
from repro_torch.kernels.runtime import F32, resolve_precision
from repro_torch.kernels.virtual_message import (virtual_pathway_bwd_fused,
                                                 virtual_pathway_fused)

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


def _as_primals(grads, primals):
    """The kernels' f32 gradients cast back to the primals' dtypes."""
    return tuple(g.to(p.dtype) for g, p in zip(grads, primals))


@functools.lru_cache(maxsize=None)
def edge_function(precision=None) -> type:
    """The edge pathway's ``torch.autograd.Function`` for ``precision``
    ('f32', 'bf16' or a ``runtime.Precision``): forward kernel, with the
    backward kernel as its vjp, both in that precision.

    ``apply(x, h, snd, em, indptr, sperm, sptr, gate_mode, rel_mode, clamp,
    *ws)`` → ``(dx, mh, deg)``.  Saves the primals and ``deg``; gradients
    for ``x``, ``h`` and the nine weights, ``None`` for the rest.
    """
    prec = resolve_precision(precision)

    class EdgePathwayP(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, h, snd, em, indptr, sperm, sptr, gate_mode,
                    rel_mode, clamp, *ws):
            kw = dict(gate_mode=gate_mode, rel_mode=rel_mode, clamp=clamp,
                      precision=prec)
            dx, mh, deg = edge_pathway_fused(x, h, snd, em, indptr, *ws, **kw)
            ctx.save_for_backward(x, h, snd, em, indptr, deg.contiguous(),
                                  *ws)
            ctx.sender = (sperm, sptr)
            ctx.kw = kw
            ctx.mark_non_differentiable(deg)
            return dx, mh, deg

        @staticmethod
        def backward(ctx, g_dx, g_mh, _g_deg):
            x, h, snd, em, indptr, deg, *ws = ctx.saved_tensors
            g_dx = torch.zeros_like(x) if g_dx is None else g_dx.contiguous()
            g_mh = (torch.zeros((x.shape[0], ws[4].shape[1]), dtype=x.dtype,
                                device=x.device)
                    if g_mh is None else g_mh.contiguous())
            grads = edge_pathway_bwd_fused(
                x, h, snd, em, indptr, *ctx.sender, *ws, deg, g_dx, g_mh,
                **ctx.kw)
            gx, gh, *gws = _as_primals(grads, (x, h, *ws))
            return (gx, gh, None, None, None, None, None, None, None, None,
                    *gws)

    EdgePathwayP.__name__ = EdgePathwayP.__qualname__ = (
        "EdgePathway" if prec == F32 else f"EdgePathway_{prec.compute}")
    return EdgePathwayP


EdgePathway = edge_function("f32")


def edge_pathway(lp, h: Tensor, x: Tensor, g, spec,
                 layout) -> tuple[Tensor, Tensor]:
    """Kernel-backed edge pathway → ``(dx (N,3), mh (N,M))``, trainable.

    ``layout`` is the graph's CSR layout ``(indptr, n_edges)``, valid for
    its receiver-sorted slot arrays (``data.radius_graph.csr_indptr``),
    optionally followed by the sender permutation ``(sperm, sptr)`` of
    ``data.radius_graph.csr_sender_perm``, which the CUDA backward needs.
    The kernel walks ``indptr``; there is no layout-free route.
    """
    if layout is None:
        raise ValueError(
            "the kernel edge pathway needs the graph's CSR layout "
            "(indptr, n_edges) from data.radius_graph.csr_indptr")
    hk, ws = unpack_edge_params(lp, h, spec)
    sperm, sptr = (layout[2], layout[3]) if len(layout) > 2 else (None, None)
    dx, mh, _deg = edge_function(spec.precision).apply(
        x.contiguous(), hk, g.senders.contiguous(), g.edge_mask.contiguous(),
        layout[0].contiguous(), sperm, sptr, spec.gate, spec.rel,
        float(spec.coord_clamp), *ws)
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


@functools.lru_cache(maxsize=None)
def virtual_function(precision=None) -> type:
    """The virtual pathway's ``torch.autograd.Function`` for
    ``precision``: forward kernel, with the backward kernel as its vjp.

    ``apply(x, h, z, node_mask, *ws)`` (``ws``: the 11 per-channel stacks)
    → ``(dx, mh, dz_sum, ms_sum)``.  Saves the primals only; no gradient
    for the node mask.
    """
    prec = resolve_precision(precision)

    class VirtualPathwayP(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, h, z, node_mask, *ws):
            ctx.save_for_backward(x, h, z, node_mask, *ws)
            return virtual_pathway_fused(x, h, z, node_mask, *ws,
                                         precision=prec)

        @staticmethod
        def backward(ctx, g_dx, g_mh, g_dz, g_ms):
            ops = ctx.saved_tensors
            x, z, w2 = ops[0], ops[2], ops[7]
            hid = w2.shape[2]
            shapes = ((x.shape[0], 3), (x.shape[0], hid), (z.shape[0], 3),
                      (z.shape[0], hid))
            cots = tuple(
                torch.zeros(s, dtype=x.dtype, device=x.device) if c is None
                else c.contiguous() for c, s in zip((g_dx, g_mh, g_dz, g_ms),
                                                    shapes))
            grads = virtual_pathway_bwd_fused(*ops, *cots, precision=prec)
            gx, gh, gz, *gws = _as_primals(
                grads, [t for i, t in enumerate(ops) if i != 3])
            return (gx, gh, gz, None, *gws)

    VirtualPathwayP.__name__ = VirtualPathwayP.__qualname__ = (
        "VirtualPathway" if prec == F32
        else f"VirtualPathway_{prec.compute}")
    return VirtualPathwayP


VirtualPathway = virtual_function("f32")


def virtual_pathway(vb, h: Tensor, x: Tensor, vs, mv: Tensor,
                    node_mask: Tensor, precision=None):
    """Kernel-backed virtual pathway → ``(dx, mh, dz_sum, ms_sum)``,
    trainable."""
    w = unpack_virtual_block(vb, vs.s, mv, h.shape[-1])
    return virtual_function(precision).apply(
        x.contiguous(), h.contiguous(), vs.z.contiguous(),
        node_mask.contiguous(), w["w1h"], w["w1d"], w["const1"], w["w2"],
        w["b2"], w["wg1"], w["bg1"], w["wg2"], w["wz1"], w["bz1"], w["wz2"])


# --------------------------------------------------------------------- MMD
class MMDCross(torch.autograd.Function):
    """MMD cross-sum kernel with the cross-gradient kernel as its vjp.

    ``apply(x, z, weight, sigma)`` → (B,) for a batch (x (B,M,3), z
    (B,C,3), weight (B,M)), a scalar for one graph; one launch of each
    kernel either way.  No gradient for the weight.
    """

    @staticmethod
    def forward(ctx, x, z, weight, sigma):
        ctx.save_for_backward(x, z, weight)
        ctx.sigma = sigma
        return mmd_cross_sum(x, z, weight, sigma=sigma)

    @staticmethod
    def backward(ctx, g):
        x, z, weight = ctx.saved_tensors
        dx, dz = mmd_cross_grads(x, z, weight, g.contiguous(),
                                 sigma=ctx.sigma)
        return dx, dz, None, None


def mmd_cross(x: Tensor, z: Tensor, weight: Tensor, sigma: float) -> Tensor:
    """Differentiable Σ_i w_i Σ_c k(x_i, z_c) through the MMD kernels, per
    graph of a batch or for one graph (``weight`` is the node mask, or
    all-ones for a sampled subset)."""
    return MMDCross.apply(x.contiguous(), z.contiguous(), weight.contiguous(),
                          float(sigma))


def mmd_loss_kernel(z: Tensor, x: Tensor, node_mask: Tensor, *,
                    sigma: float = 1.5) -> Tensor:
    """Eq. 10 of one graph (z (C, 3), x (N, 3), node_mask (N,)) → a
    scalar, its cross term through :func:`mmd_cross` (the MMD kernels on
    CUDA tensors, their plain versions on CPU tensors); the C×C
    virtual-virtual term stays plain."""
    c = z.shape[0]
    zc = z[:, None, :] - z[None, :, :]
    term_vv = torch.sum(torch.exp(-torch.sum(zc ** 2, -1)
                                  / (2 * sigma * sigma))) / (c * c)
    cross = mmd_cross(x, z, node_mask, sigma)
    denom = torch.clamp(torch.sum(node_mask), min=1.0) * c
    return term_vv - cross / denom
