"""SchNet (Schütt et al., 2018) + FastSchNet (Sec. V, Eq. 13).

SchNet is invariant: continuous-filter convolutions update features from
RBF-expanded distances.  For position prediction it carries the
equivariant coordinate head of Eq. 13, whose φ emits the scalar gate
itself (``gate='identity'``, run by the CUDA edge kernels at Dh = 64);
FastSchNet adds the virtual pathway's correction.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.core.message_passing import (EdgeSpec, aggregate_edges,
                                              edge_pathway, edge_rel_d2)
from repro_torch.core.mlp import init_linear, init_mlp, linear, mlp
from repro_torch.core.virtual_nodes import VirtualState, init_virtual_coords
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.plugin import init_plugin, virtual_plugin_step

Tensor = torch.Tensor


class SchNetConfig(NamedTuple):
    n_layers: int = 4
    hidden: int = 64
    h_in: int = 1
    n_rbf: int = 32
    rbf_cutoff: float = 10.0
    n_virtual: int = 0
    s_dim: int = 64
    velocity: bool = True
    coord_clamp: float = 100.0
    use_kernel: bool = False  # coord head + virtual pathway through kernels
    precision: str = "f32"


def edge_spec(coord_clamp: float, precision: str = "f32") -> EdgeSpec:
    """Eq. 13 coordinate head: φ(h_i, h_j, d²) emits the scalar gate
    directly (identity gate), masked-mean aggregation."""
    return EdgeSpec(use_h=True, use_d2=True, gate="identity", rel="raw",
                    coord_clamp=coord_clamp, normalize=True,
                    precision=precision)


def ssp(x: Tensor) -> Tensor:
    """Shifted softplus, SchNet's activation: log(1 + e^x) − log 2, as
    ``logaddexp(x, 0)`` (``F.softplus`` switches to the identity above
    20, the reference's softplus does not)."""
    return torch.logaddexp(x, x.new_zeros(())) - math.log(2.0)


def rbf_centers(n: int, cutoff: float, device=None) -> Tensor:
    """``n`` evenly spaced centres on [0, cutoff] in f32, formed as the
    reference's ``linspace`` forms them: ``i·step`` with the last one set
    to ``cutoff``."""
    step = torch.tensor(cutoff, dtype=torch.float32) / max(n - 1, 1)
    c = torch.arange(n, dtype=torch.float32) * step
    if n > 1:
        c[-1] = cutoff
    return c.to(device)


def rbf_expand(d: Tensor, n_rbf: int, cutoff: float) -> Tensor:
    """Gaussian RBF expansion of distances, (E,) → (E, n_rbf)."""
    centers = rbf_centers(n_rbf, cutoff, d.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (d[:, None] - centers[None, :]) ** 2)


def init_schnet(gen: torch.Generator, cfg: SchNetConfig, device=None):
    device = resolve_device(device)
    hid = cfg.hidden
    layers = []
    for _ in range(cfg.n_layers):
        p = {
            # filter generator W(d): rbf → hidden
            "filter": init_mlp(gen, [cfg.n_rbf, hid, hid], device=device),
            "in_proj": init_linear(gen, hid, hid, device=device),
            "out": init_mlp(gen, [hid, hid, hid], device=device),
            # Eq. 13 coordinate head: φ(h_i, h_j, d²) scalar gate
            "coord": init_mlp(gen, [2 * hid + 1, hid, 1], final_bias=False,
                              device=device),
            "phi_v": init_mlp(gen, [hid, hid, 1], device=device),
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


def schnet_apply(params, cfg: SchNetConfig, g: GeometricGraph, *,
                 edge_layout: Optional[tuple] = None,
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
    spec = edge_spec(cfg.coord_clamp, cfg.precision)
    snd = g.senders.long()
    for lp in params["layers"]:
        _, d2 = edge_rel_d2(x, g)
        d = torch.sqrt(d2[:, 0] + 1e-12)
        w = mlp(lp["filter"], rbf_expand(d, cfg.n_rbf, cfg.rbf_cutoff),
                act=ssp)
        # continuous-filter convolution: the RBF-filter product does not
        # fit the φ1 form, so only the reduction is shared
        hj = linear(lp["in_proj"], h)[snd]
        agg = aggregate_edges(hj * w * g.edge_mask[:, None], g,
                              normalize=False)
        h = h + mlp(lp["out"], agg, act=ssp)
        # Eq. 13: equivariant coordinate head + virtual pathway
        dx, _ = edge_pathway({"phi1": lp["coord"]}, h, x, g, spec,
                             use_kernel=cfg.use_kernel, layout=edge_layout)
        if cfg.n_virtual > 0:
            dx_v, _, vs = virtual_plugin_step(
                lp["virtual"], h, x, vs, g.node_mask,
                use_kernel=cfg.use_kernel, precision=cfg.precision)
            dx = dx + dx_v
        if cfg.velocity:
            dx = dx + mlp(lp["phi_v"], h) * g.v
        x = x + dx * g.node_mask[:, None]
    return x, h, vs
