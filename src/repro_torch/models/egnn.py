"""EGNN edge wiring shared by FastEGNN: the config, the edge spec and the
real-real pathway (Eqs. 3, 6, 7 without virtual terms)."""
from __future__ import annotations

from typing import NamedTuple

from repro_torch.core.graph import GeometricGraph
from repro_torch.core.message_passing import EdgeSpec, edge_pathway


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


def real_real_pathway(lp, h, x, g: GeometricGraph, coord_clamp: float,
                      use_kernel: bool = False, edge_layout=None,
                      precision: str = "f32"):
    """Eq. 3 messages + real-real parts of Eqs. 6-7 with α_i = 1/|N(i)|.
    ``edge_layout`` is the graph's CSR layout ``(indptr, n_edges)``."""
    return edge_pathway({"phi1": lp["phi1"], "gate": lp["phi_xr"]}, h, x, g,
                        edge_spec(coord_clamp, precision),
                        use_kernel=use_kernel, layout=edge_layout)
