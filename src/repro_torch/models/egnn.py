"""EGNN baseline (Satorras et al., 2021) — Eqs. 3, 6, 7 without virtual
terms — and the edge wiring FastEGNN shares with it: the config, the edge
spec and the real-real pathway."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.core.message_passing import EdgeSpec, edge_pathway
from repro_torch.core.mlp import init_mlp, mlp
from repro_torch.kernels.runtime import resolve_device

Tensor = torch.Tensor


class EGNNConfig(NamedTuple):
    n_layers: int = 4
    hidden: int = 64
    h_in: int = 1
    edge_attr_dim: int = 0
    velocity: bool = True
    coord_clamp: float = 100.0
    use_kernel: bool = False  # dispatch the edge pathway to the CUDA kernel
    precision: str = "f32"


def edge_spec(coord_clamp: float, precision: str = "f32") -> EdgeSpec:
    """Eq. 3 + Eqs. 6-7 real-real terms: full φ1 over [h_i|h_j|d²|e_ij],
    MLP coordinate gate, masked-mean aggregation."""
    return EdgeSpec(use_h=True, use_d2=True, use_edge_attr=True, gate="mlp",
                    rel="raw", coord_clamp=coord_clamp, normalize=True,
                    precision=precision)


def init_egnn_layer(gen: torch.Generator, cfg: EGNNConfig, device=None):
    device = resolve_device(device)
    hid = cfg.hidden
    msg_in = 2 * hid + 1 + cfg.edge_attr_dim
    p = {
        "phi1": init_mlp(gen, [msg_in, hid, hid], device=device),
        "phi_xr": init_mlp(gen, [hid, hid, 1], final_bias=False,
                           device=device),
        "phi_h": init_mlp(gen, [2 * hid, hid, hid], device=device),
    }
    if cfg.velocity:
        p["phi_v"] = init_mlp(gen, [hid, hid, 1], device=device)
    return p


def init_egnn(gen: torch.Generator, cfg: EGNNConfig, device=None):
    """Random weights drawn from ``gen`` on ``device`` (default CUDA)."""
    device = resolve_device(device)
    return {
        "embed": init_mlp(gen, [cfg.h_in, cfg.hidden], device=device),
        "layers": [init_egnn_layer(gen, cfg, device)
                   for _ in range(cfg.n_layers)],
    }


def real_real_pathway(lp, h, x, g: GeometricGraph, coord_clamp: float,
                      use_kernel: bool = False, edge_layout=None,
                      precision: str = "f32"):
    """Eq. 3 messages + real-real parts of Eqs. 6-7 with α_i = 1/|N(i)|.
    ``edge_layout`` is the graph's CSR layout ``(indptr, n_edges)``."""
    return edge_pathway({"phi1": lp["phi1"], "gate": lp["phi_xr"]}, h, x, g,
                        edge_spec(coord_clamp, precision),
                        use_kernel=use_kernel, layout=edge_layout)


def egnn_apply(params, cfg: EGNNConfig, g: GeometricGraph, *,
               edge_layout: Optional[tuple] = None) -> tuple[Tensor, Tensor]:
    """Returns updated coordinates (N,3) and features (N,hidden)."""
    h = mlp(params["embed"], g.h)
    x = g.x
    for lp in params["layers"]:
        dx, mh = real_real_pathway(lp, h, x, g, cfg.coord_clamp,
                                   cfg.use_kernel, edge_layout=edge_layout,
                                   precision=cfg.precision)
        if cfg.velocity:
            dx = dx + mlp(lp["phi_v"], h) * g.v  # φ_v(h_i)·v_i^(0)
        x = x + dx * g.node_mask[:, None]
        h = h + mlp(lp["phi_h"], torch.cat([h, mh], dim=-1))
    return x, h
