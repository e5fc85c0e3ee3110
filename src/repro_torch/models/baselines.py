"""Non-geometric baselines from Table I: Linear dynamics and MPNN."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.core.message_passing import EdgeSpec, edge_pathway
from repro_torch.core.mlp import init_mlp, mlp
from repro_torch.kernels.runtime import resolve_device

Tensor = torch.Tensor

# MPNN: invariant-only pathway — messages from endpoint features alone, no
# geometry, no coordinate gate, masked-mean aggregation.
MPNN_EDGE_SPEC = EdgeSpec(use_h=True, use_d2=False, gate="none")


class LinearConfig(NamedTuple):
    use_kernel: bool = False  # no edge pathway: accepted for registry uniformity
    precision: str = "f32"  # likewise accepted for registry uniformity


def init_linear_dyn(gen: torch.Generator, cfg: LinearConfig, device=None):
    return {"dt": torch.ones((), dtype=torch.float32,
                             device=resolve_device(device))}


def linear_dyn_apply(params, cfg: LinearConfig, g: GeometricGraph) -> Tensor:
    """x' = x + θ·v — the simplest equivariant model."""
    return g.x + params["dt"] * g.v


class MPNNConfig(NamedTuple):
    n_layers: int = 4
    hidden: int = 64
    h_in: int = 1
    use_kernel: bool = False  # dispatch the edge pathway to the CUDA kernel
    precision: str = "f32"


def init_mpnn(gen: torch.Generator, cfg: MPNNConfig, device=None):
    device = resolve_device(device)
    d_in = cfg.h_in + 6  # h ⊕ x ⊕ v — NOT equivariant, by design
    hid = cfg.hidden
    embed = init_mlp(gen, [d_in, hid], device=device)
    layers = [{"msg": init_mlp(gen, [2 * hid, hid, hid], device=device),
               "upd": init_mlp(gen, [2 * hid, hid, hid], device=device)}
              for _ in range(cfg.n_layers)]
    return {"embed": embed, "layers": layers,
            "dec": init_mlp(gen, [hid, hid, 3], device=device)}


def mpnn_apply(params, cfg: MPNNConfig, g: GeometricGraph, *,
               edge_layout: Optional[tuple] = None) -> Tensor:
    z = mlp(params["embed"], torch.cat([g.h, g.x, g.v], dim=-1))
    spec = MPNN_EDGE_SPEC._replace(precision=cfg.precision)
    for lp in params["layers"]:
        _, agg = edge_pathway({"phi1": lp["msg"]}, z, g.x, g, spec,
                              use_kernel=cfg.use_kernel, layout=edge_layout)
        z = z + mlp(lp["upd"], torch.cat([z, agg], dim=-1))
    return g.x + mlp(params["dec"], z)
