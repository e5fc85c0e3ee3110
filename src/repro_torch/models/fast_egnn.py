"""FastEGNN (Sec. IV) — EGNN + ordered virtual nodes, single device.

The layer loop is the reference's serialized schedule (no collectives).
With ``cfg.use_kernel`` both per-layer pathways go through the CUDA
kernels on CUDA tensors, forward and backward: the virtual pathway
(Eq. 5) and the real-real edge pathway (Eqs. 3, 6-7).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.core.message_passing import clamp_vector_norm
from repro_torch.core.mlp import init_mlp, mlp
from repro_torch.core.virtual_nodes import (VirtualState, init_virtual_block,
                                            init_virtual_coords, masked_com,
                                            virtual_aggregate_from_sums,
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
                    edge_layout: Optional[tuple] = None,
                    ) -> tuple[Tensor, Tensor, VirtualState]:
    """Returns (coords (N,3), feats (N,hidden), final virtual state).

    ``edge_layout`` is this graph's CSR layout ``(indptr, n_edges)`` for
    the kernel edge pathway (ignored by the plain path).
    """
    resolve_precision(cfg.precision)  # an unknown string raises
    h = mlp(params["embed"], g.h)
    x = g.x
    vs = VirtualState(z=init_virtual_coords(x, g.node_mask, cfg.n_virtual),
                      s=params["s_init"])
    n_real = g.node_mask.sum()
    for lp in params["layers"]:
        com = masked_com(x, g.node_mask)  # Alg. 1 line 4
        mv = virtual_global_message(vs.z, com)  # Eq. 4
        dx_v, mh_v, dz_sum, ms_sum = virtual_pathway(
            lp["virtual"], h, x, vs, mv, g.node_mask,
            use_kernel=cfg.use_kernel, precision=cfg.precision)  # Eq. 5
        dx_r, mh_r = real_real_pathway(lp, h, x, g, cfg.coord_clamp,
                                       cfg.use_kernel, edge_layout=edge_layout,
                                       precision=cfg.precision)  # Eqs. 3, 6-7
        # clamp the virtual term by norm (equivariant), like the real term
        dx_v = clamp_vector_norm(dx_v, cfg.coord_clamp)
        dx = dx_r + dx_v
        if cfg.velocity:
            dx = dx + mlp(lp["phi_v"], h) * g.v
        x_new = x + dx * g.node_mask[:, None]  # Eq. 6
        h = h + mlp(lp["phi_h"], torch.cat([h, mh_r, mh_v], dim=-1))  # Eq. 7
        # Eqs. 8–9 use the pre-update coordinates x^{(l)}
        vs = virtual_aggregate_from_sums(lp["virtual"], vs, dz_sum, ms_sum,
                                         n_real)
        x = x_new
    return x, h, vs


def fast_egnn_full(params, cfg: FastEGNNConfig, g: GeometricGraph, *,
                   edge_layout: Optional[tuple] = None) -> tuple[Tensor, dict]:
    """The trainer's ``apply_full``: ``(coords, {"h": feats, "virtual":
    VirtualState})``, as the JAX package's registry wrapper returns."""
    x, h, vs = fast_egnn_apply(params, cfg, g, edge_layout=edge_layout)
    return x, {"h": h, "virtual": vs}
