"""Single-channel TFN (Thomas et al., 2018) + FastTFN (Sec. V, Eq. 15).

The paper's single-channel, type-1-output TFN (ℓ ≤ 2) in explicit
Cartesian tensor algebra, as the reference writes it:

  Y⁰ ⊗ v¹ → 1 :  w₀ · v_j
  Y¹ ⊗ h⁰ → 1 :  w₁ · r̂
  Y¹ ⊗ v¹ → 1 :  w₂ · (r̂ × v_j)                (antisymmetric path)
  Y² ⊗ v¹ → 1 :  w₃ · (r̂ r̂ᵀ − I/3) v_j        (symmetric-traceless path)

with per-path weights from a radial MLP of ‖r‖ and h_j; type-0 features
update from Y⁰⊗h⁰→0 and Y¹⊗v¹→0.  The cross-product path flips sign under
reflection: the model is SO(3)-, not O(3)-equivariant.  These paths do
not fit the φ1-gate form, so no edge kernel runs; ``use_kernel`` still
sends FastTFN's virtual pathway to the CUDA virtual kernels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.core.message_passing import aggregate_edges, edge_rel_d2
from repro_torch.core.mlp import init_mlp, mlp
from repro_torch.core.virtual_nodes import VirtualState, init_virtual_coords
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.plugin import init_plugin, virtual_plugin_step
from repro_torch.models.schnet import rbf_expand

Tensor = torch.Tensor


class TFNConfig(NamedTuple):
    n_layers: int = 4
    hidden: int = 64
    h_in: int = 1
    n_rbf: int = 16
    rbf_cutoff: float = 10.0
    n_virtual: int = 0
    s_dim: int = 64
    coord_clamp: float = 100.0
    use_kernel: bool = False  # FastTFN's virtual pathway through kernels
    precision: str = "f32"


def init_tfn(gen: torch.Generator, cfg: TFNConfig, device=None):
    device = resolve_device(device)
    hid = cfg.hidden
    layers = []
    for _ in range(cfg.n_layers):
        p = {
            # radial net → 4 type-1 path weights + 2 type-0 path weights
            "radial": init_mlp(gen, [cfg.n_rbf + hid, hid, 6], device=device),
            "h_out": init_mlp(gen, [hid + 2, hid, hid], device=device),
        }
        if cfg.n_virtual > 0:
            p["virtual"] = init_plugin(gen, cfg.n_virtual, hid, cfg.s_dim,
                                       hid, device=device)
        layers.append(p)
    out = {"embed": init_mlp(gen, [cfg.h_in, hid], device=device),
           "layers": layers}
    if cfg.n_virtual > 0:
        out["s_init"] = (0.1 * torch.randn((cfg.n_virtual, cfg.s_dim),
                                           generator=gen)).to(device)
    return out


def tfn_apply(params, cfg: TFNConfig, g: GeometricGraph,
              ) -> tuple[Tensor, Tensor, Optional[VirtualState]]:
    """Returns (coords (N,3), feats (N,hidden), the final virtual state or
    None)."""
    h = mlp(params["embed"], g.h)
    x = g.x
    vs = None
    if cfg.n_virtual > 0:
        vs = VirtualState(z=init_virtual_coords(x, g.node_mask,
                                                cfg.n_virtual),
                          s=params["s_init"])
    snd = g.senders.long()
    em = g.edge_mask[:, None]
    vj = g.v[snd]
    for lp in params["layers"]:
        rel, d2e = edge_rel_d2(x, g)  # (E,3), (E,1)
        d = torch.sqrt(d2e[:, 0] + 1e-12)
        rhat = rel / d[:, None]
        rad_in = torch.cat([rbf_expand(d, cfg.n_rbf, cfg.rbf_cutoff),
                            h[snd]], dim=-1)
        w = torch.clamp(mlp(lp["radial"], rad_in), -cfg.coord_clamp,
                        cfg.coord_clamp)  # (E,6)
        rv = (rhat * vj).sum(-1, keepdim=True)
        quad = rhat * rv - vj / 3.0  # (r̂r̂ᵀ−I/3)v
        dx_e = (w[:, 0:1] * vj + w[:, 1:2] * rhat
                + w[:, 2:3] * torch.linalg.cross(rhat, vj)
                + w[:, 3:4] * quad) * em
        # type-0 invariant paths for the feature update
        s0 = torch.stack([w[:, 4], w[:, 5] * rv[:, 0]], dim=-1) * em
        dx = aggregate_edges(dx_e, g)
        h_agg = aggregate_edges(s0, g)
        if cfg.n_virtual > 0:
            dx_v, _, vs = virtual_plugin_step(
                lp["virtual"], h, x, vs, g.node_mask,
                use_kernel=cfg.use_kernel, precision=cfg.precision)
            dx = dx + dx_v
        x = x + dx * g.node_mask[:, None]
        h = h + mlp(lp["h_out"], torch.cat([h, h_agg], dim=-1))
    return x, h, vs
