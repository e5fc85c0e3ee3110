"""Radial Field (Köhler et al., 2019) + FastRF (Sec. V).

RF computes messages purely from inter-node distances — no node features.
FastRF therefore also drops ``h`` and the virtual features ``S`` from the
virtual pathway (zero-width tensors), keeping only geometry.  The edge
pathway's width-1 message is its own gate (``gate='identity'``), which
the CUDA edge kernels run with a zero feature column (Dh = 1).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.core.message_passing import EdgeSpec, edge_pathway
from repro_torch.core.mlp import init_mlp
from repro_torch.core.virtual_nodes import VirtualState, init_virtual_coords
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.plugin import init_plugin, virtual_plugin_step

Tensor = torch.Tensor


class RFConfig(NamedTuple):
    n_layers: int = 4
    hidden: int = 64
    n_virtual: int = 0  # 0 → plain RF
    velocity: bool = True
    coord_clamp: float = 100.0
    use_kernel: bool = False  # edge + virtual pathways through the kernels
    precision: str = "f32"


def edge_spec(coord_clamp: float, precision: str = "f32") -> EdgeSpec:
    """Köhler-style normalised radial field: geometry-only φ, the width-1
    message is the gate, and the pair direction is scaled by 1/(‖r‖+1)."""
    return EdgeSpec(use_h=False, use_d2=True, gate="identity", rel="inv1p",
                    coord_clamp=coord_clamp, normalize=True,
                    precision=precision)


def init_rf(gen: torch.Generator, cfg: RFConfig, device=None):
    device = resolve_device(device)
    layers = []
    for _ in range(cfg.n_layers):
        p = {"phi": init_mlp(gen, [1, cfg.hidden, 1], final_bias=False,
                             device=device)}
        if cfg.n_virtual > 0:  # h_dim = 0, s_dim = 0: geometry only
            p["virtual"] = init_plugin(gen, cfg.n_virtual, 0, 0, cfg.hidden,
                                       device=device)
        layers.append(p)
    return {"layers": layers}


def rf_apply(params, cfg: RFConfig, g: GeometricGraph, *,
             edge_layout: Optional[tuple] = None) -> Tensor:
    x = g.x
    n = x.shape[0]
    vs = None
    if cfg.n_virtual > 0:
        vs = VirtualState(z=init_virtual_coords(x, g.node_mask,
                                                cfg.n_virtual),
                          s=x.new_zeros((cfg.n_virtual, 0)))
    h_empty = x.new_zeros((n, 0))
    spec = edge_spec(cfg.coord_clamp, cfg.precision)
    for lp in params["layers"]:
        dx, _ = edge_pathway({"phi1": lp["phi"]}, h_empty, x, g, spec,
                             use_kernel=cfg.use_kernel, layout=edge_layout)
        if cfg.n_virtual > 0:
            dx_v, _, vs = virtual_plugin_step(
                lp["virtual"], h_empty, x, vs, g.node_mask,
                use_kernel=cfg.use_kernel, precision=cfg.precision)
            dx = dx + dx_v
        if cfg.velocity:
            dx = dx + g.v  # RF integrates the initial velocity directly
        x = x + dx * g.node_mask[:, None]
    return x
