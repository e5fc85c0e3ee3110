"""Geometric graph container (fixed-size tensors with validity masks)."""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class GeometricGraph(NamedTuple):
    """One (possibly padded) geometric graph, or a stack of them.

    Shapes of one graph (a batch adds a leading ``B`` axis):
      x:         (N, 3)   float32 node coordinates
      v:         (N, 3)   float32 node velocities
      h:         (N, H)   float32 invariant node features
      senders:   (E,)     int32   edge source indices   (padded w/ 0)
      receivers: (E,)     int32   edge destination idx  (padded w/ 0)
      edge_attr: (E, A)   float32 optional edge features (A may be 0)
      node_mask: (N,)     float32 1.0 for real nodes, 0.0 for padding
      edge_mask: (E,)     float32 1.0 for real edges, 0.0 for padding
    """

    x: Tensor
    v: Tensor
    h: Tensor
    senders: Tensor
    receivers: Tensor
    edge_attr: Tensor
    node_mask: Tensor
    edge_mask: Tensor

    @property
    def n_nodes(self) -> int:
        return self.x.shape[-2]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[-1]

    @property
    def feat_dim(self) -> int:
        return self.h.shape[-1]
