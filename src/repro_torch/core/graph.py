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

    def num_real_nodes(self) -> Tensor:
        """Σ node_mask (per graph of a stack)."""
        return torch.sum(self.node_mask, dim=-1)

    def com(self) -> Tensor:
        """Center of mass over *real* nodes: (3,) ((B, 3) for a stack)."""
        w = self.node_mask[..., None]
        return torch.sum(self.x * w, dim=-2) / torch.clamp(
            torch.sum(w, dim=-2), min=1.0)


def make_graph(x, v=None, h=None, senders=None, receivers=None,
               edge_attr=None, node_mask=None, edge_mask=None,
               feat_dim: int = 1, device=None) -> GeometricGraph:
    """Convenience constructor filling in defaults for missing fields.

    Array-likes become float32 (indices int32) tensors on ``device``:
    by default ``x``'s device when ``x`` is a tensor, else CUDA (raising
    without a GPU, ``kernels.runtime.resolve_device``)."""
    from repro_torch.kernels.runtime import resolve_device

    if device is None and isinstance(x, Tensor):
        device = x.device
    dev = resolve_device(device)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    i32 = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    x = f32(x)
    n = x.shape[0]
    senders = i32(senders if senders is not None else [])
    receivers = i32(receivers if receivers is not None else [])
    e = senders.shape[0]
    return GeometricGraph(
        x=x,
        v=torch.zeros_like(x) if v is None else f32(v),
        h=(torch.ones((n, feat_dim), dtype=torch.float32, device=dev)
           if h is None else f32(h)),
        senders=senders,
        receivers=receivers,
        edge_attr=(torch.zeros((e, 0), dtype=torch.float32, device=dev)
                   if edge_attr is None else f32(edge_attr)),
        node_mask=(torch.ones((n,), dtype=torch.float32, device=dev)
                   if node_mask is None else f32(node_mask)),
        edge_mask=(torch.ones((e,), dtype=torch.float32, device=dev)
                   if edge_mask is None else f32(edge_mask)),
    )


def segment_mean(data: Tensor, segment_ids: Tensor, num_segments: int,
                 weights: Tensor | None = None) -> Tensor:
    """Masked segment mean: Σ data / count per segment (0 where empty);
    with ``weights`` (E,), Σ w·data / Σ w.  The sums are
    ``core.message_passing.segment_sum``'s fixed-order ones."""
    from repro_torch.core.message_passing import segment_sum

    expand = lambda t: t.reshape((-1,) + (1,) * (data.dim() - 1))
    if weights is not None:
        data = data * expand(weights)
        ones = weights
    else:
        ones = torch.ones(data.shape[0], dtype=data.dtype,
                          device=data.device)
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = torch.clamp(segment_sum(ones, segment_ids, num_segments), min=1.0)
    return tot / expand(cnt)
