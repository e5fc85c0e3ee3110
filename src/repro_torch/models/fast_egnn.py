"""FastEGNN (Sec. IV) — EGNN + ordered virtual nodes — and DistEGNN
(Sec. VI).

With ``cfg.use_kernel`` both per-layer pathways go through the CUDA
kernels on CUDA tensors, forward and backward: the virtual pathway
(Eq. 5) and the real-real edge pathway (Eqs. 3, 6-7).

The same apply function runs DistEGNN: with an ``axis``
(``core.collectives.GraphAxis``) the CoM and the virtual aggregation
(Eqs. 16–17) are summed across shards, in the serialized or the
overlapped layer schedule (``cfg.overlap_sync``), which give the same
bits.  Single-device FastEGNN is the ``axis=None`` case.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.collectives import GraphAxis, fanout
from repro_torch.core.graph import GeometricGraph
from repro_torch.core.message_passing import clamp_vector_norm, record_dispatch
from repro_torch.core.mlp import init_mlp, mlp
from repro_torch.core.virtual_nodes import (VirtualState,
                                            finish_virtual_aggregate,
                                            init_virtual_block,
                                            init_virtual_coords,
                                            launch_com_sums,
                                            launch_virtual_sums,
                                            virtual_global_message,
                                            virtual_pathway)
from repro_torch.kernels.runtime import resolve_device, resolve_precision
from repro_torch.models.egnn import real_real_pathway

Tensor = torch.Tensor


class FastEGNNConfig(NamedTuple):
    n_layers: int = 4
    hidden: int = 64
    h_in: int = 1
    edge_attr_dim: int = 0
    n_virtual: int = 3  # C
    s_dim: int = 64
    velocity: bool = True
    coord_clamp: float = 100.0
    use_kernel: bool = False  # virtual AND edge pathways through the kernels
    shared_virtual: bool = False  # Table II "Global Nodes" ablation
    precision: str = "f32"  # kernel compute precision ('f32' | 'bf16')
    # DistEGNN layer schedule (DESIGN.md §11): overlapped (each layer's
    # cross-shard sums issued before compute that does not need them) or
    # serialized; only read with an axis, and bitwise the same either way
    overlap_sync: bool = True


def init_fast_egnn_layer(gen: torch.Generator, cfg: FastEGNNConfig,
                         device=None):
    device = resolve_device(device)
    hid = cfg.hidden
    msg_in = 2 * hid + 1 + cfg.edge_attr_dim
    p = {
        "phi1": init_mlp(gen, [msg_in, hid, hid], device=device),
        "phi_xr": init_mlp(gen, [hid, hid, 1], final_bias=False, device=device),
        "phi_h": init_mlp(gen, [3 * hid, hid, hid], device=device),
        "virtual": init_virtual_block(gen, cfg.n_virtual, hid, cfg.s_dim, hid,
                                      shared=cfg.shared_virtual, device=device),
    }
    if cfg.velocity:
        p["phi_v"] = init_mlp(gen, [hid, hid, 1], device=device)
    return p


def init_fast_egnn(gen: torch.Generator, cfg: FastEGNNConfig, device=None):
    """Random weights drawn from ``gen`` (the reference's pytree keys) on
    ``device`` (default CUDA; raises without a GPU)."""
    device = resolve_device(device)
    embed = init_mlp(gen, [cfg.h_in, cfg.hidden], device=device)
    s_init = 0.1 * torch.randn((cfg.n_virtual, cfg.s_dim), generator=gen)
    return {
        "embed": embed,
        "s_init": s_init.to(device),
        "layers": [init_fast_egnn_layer(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
    }


def fast_egnn_apply(params, cfg: FastEGNNConfig, g: GeometricGraph, *,
                    axis: Optional[GraphAxis] = None,
                    edge_layout: Optional[tuple] = None,
                    ) -> tuple[Tensor, Tensor, VirtualState]:
    """Returns (coords (N,3), feats (N,hidden), final virtual state).

    ``axis`` ⇒ DistEGNN: ``g`` is this rank's shard, and the CoM and the
    Eqs. 16–17 node sums are summed over the axis in one of two layer
    schedules (``cfg.overlap_sync``).  Serialized, the reference's loop:
    each sum is finished before anything that needs it, two
    ``collective_serialized`` a layer.  Overlapped (the reference's
    ``_apply_overlapped``, DESIGN.md §11): the CoM sum is issued before the
    edge pathway, which needs neither sum, and waited for after it; layer
    l's aggregate sum is issued after its node update and finished after
    layer l+1's edge pathway; two ``collective_overlapped`` a layer.  The
    sums' operands, their order and the epilogue are the same, so the
    floats are, and the gradients too (``_aliases``).  Without an axis the
    loop is single-device FastEGNN's serialized one, with no sums.

    ``edge_layout`` is this graph's CSR layout ``(indptr, n_edges)`` for
    the kernel edge pathway (ignored by the plain path).
    """
    resolve_precision(cfg.precision)  # an unknown string raises
    overlap = axis is not None and bool(cfg.overlap_sync)
    h = mlp(params["embed"], g.h)
    x = g.x
    mask = g.node_mask
    vs = VirtualState(z=init_virtual_coords(x, mask, cfg.n_virtual, axis),
                      s=params["s_init"])
    n_local = mask.sum()

    def edge(lp, hs, xs):  # Eqs. 3, 6-7
        return real_real_pathway(lp, hs[1], xs[2], g, cfg.coord_clamp,
                                 cfg.use_kernel, edge_layout=edge_layout,
                                 precision=cfg.precision)

    event = "collective_overlapped" if overlap else "collective_serialized"
    pending = None  # overlapped: (layer params, state, sums in flight)
    for lp in params["layers"]:
        if axis is not None:  # the layer's two sums
            record_dispatch(event)
            record_dispatch(event)
        xs, hs = _aliases(x, h, axis)
        com_sums = launch_com_sums(xs[0], mask, axis)  # Alg. 1 line 4
        if overlap:
            dx_r, mh_r = edge(lp, hs, xs)
            if pending is not None:  # layer l-1's Eqs. 16–17
                vs = finish_virtual_aggregate(pending[0], pending[1],
                                              *pending[2].wait())
        tot, cnt = com_sums.wait()
        mv = virtual_global_message(vs.z, tot / torch.clamp(cnt, min=1.0))
        dx_v, mh_v, dz_sum, ms_sum = virtual_pathway(
            lp["virtual"], hs[0], xs[1], vs, mv, mask,
            use_kernel=cfg.use_kernel, precision=cfg.precision)  # Eq. 5
        if not overlap:
            dx_r, mh_r = edge(lp, hs, xs)
        # clamp the virtual term by norm (equivariant), like the real term
        dx = dx_r + clamp_vector_norm(dx_v, cfg.coord_clamp)
        if cfg.velocity:
            dx = dx + mlp(lp["phi_v"], hs[2]) * g.v
        x_new = xs[3] + dx * mask[:, None]  # Eq. 6
        h = hs[4] + mlp(lp["phi_h"],
                        torch.cat([hs[3], mh_r, mh_v], dim=-1))  # Eq. 7
        # Eqs. 8–9 / 16–17 on the pre-update coordinates x^{(l)}
        sums = launch_virtual_sums(dz_sum, ms_sum, n_local, axis)
        if overlap:
            pending = (lp["virtual"], vs, sums)
        else:
            vs = finish_virtual_aggregate(lp["virtual"], vs, *sums.wait())
        x = x_new
    if pending is not None:
        vs = finish_virtual_aggregate(pending[0], pending[1],
                                      *pending[2].wait())
    return x, h, vs


def _aliases(x: Tensor, h: Tensor, axis: Optional[GraphAxis]):
    """With an axis: one alias of ``x`` for each of its layer consumers
    (CoM, virtual pathway, edge pathway, the update) and of ``h`` (virtual,
    edge, φ_v, φ_h's input, the residual), through ``collectives.fanout``.
    The two schedules create the pathways in different orders, and
    autograd adds a tensor's cotangents in reverse creation order; the
    aliases add them in one fixed order instead."""
    if axis is None:
        return (x,) * 4, (h,) * 5
    return fanout(x, 4), fanout(h, 5)


def fast_egnn_full(params, cfg: FastEGNNConfig, g: GeometricGraph, *,
                   axis: Optional[GraphAxis] = None,
                   edge_layout: Optional[tuple] = None) -> tuple[Tensor, dict]:
    """The trainer's ``apply_full``: ``(coords, {"h": feats, "virtual":
    VirtualState})``, as the JAX package's registry wrapper returns."""
    x, h, vs = fast_egnn_apply(params, cfg, g, axis=axis,
                               edge_layout=edge_layout)
    return x, {"h": h, "virtual": vs}
