"""DistEGNN (Sec. VI): graph-partition parallelism on ``torch.distributed``.

One large geometric graph is split into D padded shards
(``data/partition.py``); each rank of a ``torch.distributed`` group runs
its own shard, and the shared, ordered virtual nodes are kept in sync by
cross-shard sums inside every layer (Eqs. 16–17, ``fast_egnn_apply(axis=
...)``).  The reference drives D devices from one process through
``shard_map``; here every rank is a process and the graph axis is a
:class:`~repro_torch.core.collectives.GraphAxis`.  The layer schedule is
the overlapped one by default (DESIGN.md §11); ``overlap=`` on the
builders overrides ``cfg.overlap_sync``.  Both give the same bits.

Gradients go through the sums' own autograd rule (``collectives.
graph_sum``, the paper's differentiable all-reduce, DESIGN.md §6.1).  Every
rank holds the same global loss, and each differentiates its copy divided
by D (as the reference's ``jnp.mean`` over shards does); the rank-order
sum of the ranks' parameter gradients is then the gradient of Eq. 18, and
every rank takes the same Adam step, so the parameters stay bitwise equal
across ranks.

With ``cfg.use_kernel`` each rank's edge pathway runs the CUDA kernels on
its shard's CSR layout, which :class:`ShardedBatch` carries.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.collectives import GraphAxis, graph_sum, sum_across
from repro_torch.core.graph import GeometricGraph
from repro_torch.core.mmd import mmd_loss
from repro_torch.core.virtual_nodes import VirtualState
from repro_torch.data.partition import LAYOUT_FIELDS, repad_partition
from repro_torch.kernels.runtime import resolve_device
from repro_torch.models.fast_egnn import FastEGNNConfig, fast_egnn_apply
from repro_torch.training.losses import masked_mse
from repro_torch.training.optim import Adam, tree_map

Tensor = torch.Tensor


def make_gnn_mesh(n_devices: Optional[int] = None, *,
                  device=None) -> GraphAxis:
    """The graph axis over the initialised default ``torch.distributed``
    group (``launch.mesh.init_distributed``): this rank, the world size,
    the backend, and ``device`` (default: CUDA, this process's current
    GPU).  Without an initialised group it is a one-rank axis, whose sums
    are the identity.  ``n_devices`` must equal the world size when
    given."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dist.is_available() and dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
        backend = str(dist.get_backend())
    else:
        rank, size, backend = 0, 1, "none"
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"make_gnn_mesh({n_devices}): the process group has "
                         f"{size} rank(s); start one rank per shard "
                         f"(launch.mesh.init_distributed)")
    return GraphAxis(group=None, rank=rank, size=size, device=dev,
                     backend=backend)


class ShardedBatch(NamedTuple):
    """This rank's shard of a batch: x/v/h/x_target (B, n_cap, ·),
    senders/receivers/edge_mask (B, e_cap), node_mask (B, n_cap), and
    ``layout``, the shards' stacked CSR layouts ``(indptr (B, n_cap+1),
    n_edges (B,), sperm (B, e_cap), sptr (B, n_cap+1))``.  Every slot is a
    real sample (a mesh drops the trailing partial batch)."""

    x: Tensor
    v: Tensor
    h: Tensor
    senders: Tensor
    receivers: Tensor
    node_mask: Tensor
    edge_mask: Tensor
    x_target: Tensor
    layout: tuple

    @property
    def sample_mask(self) -> None:
        return None


_GRAPH_FIELDS = ("x", "v", "h", "senders", "receivers", "node_mask",
                 "edge_mask", "x_target")

# warn-once latch for re-padding (a dataset property: once is enough)
_REPAD_WARNED = False


def stack_partitions_host(pgs, layout_cache=None) -> dict:
    """list[PartitionedGraph] (one per batch element, each (D_l, ...)) →
    dict of stacked numpy fields (D_l, B, ...), the CSR layout fields
    included.

    Samples' capacities may differ: each is re-padded to the batch max
    (its CSR layout rebuilt at the new shapes,
    ``data.partition.repad_partition``).  Inflating a sample's capacity by
    more than 2× warns once: one outlier sample is then dictating the
    batch's shapes and compute.  ``layout_cache`` (a
    ``data.layout_cache.LayoutCache``) serves the rebuilt layouts.
    """
    global _REPAD_WARNED
    n_cap = max(p.x.shape[1] for p in pgs)
    e_cap = max(p.senders.shape[1] for p in pgs)
    stacked = []
    for p in pgs:
        n0, e0 = p.x.shape[1], p.senders.shape[1]
        if (n0, e0) == (n_cap, e_cap):
            stacked.append(p)
            continue
        if not _REPAD_WARNED and (n_cap > 2 * n0 or e_cap > 2 * e0):
            _REPAD_WARNED = True
            warnings.warn(
                f"stack_partitions: re-padding a sample from (n_cap={n0}, "
                f"e_cap={e0}) to the batch max (n_cap={n_cap}, e_cap={e_cap}) "
                f"— >2× inflation; one outlier sample is dictating the "
                f"batch's padded shapes (warned once)", stacklevel=2)
        stacked.append(repad_partition(p, n_cap, e_cap, layout_cache))
    return {f: np.stack([getattr(p, f) for p in stacked], axis=1)
            for f in _GRAPH_FIELDS + LAYOUT_FIELDS}


def sharded_batch_to_device(host: dict, shard: int = 0,
                            device=None) -> ShardedBatch:
    """Row ``shard`` of stacked numpy fields → a :class:`ShardedBatch` on
    ``device`` (default CUDA)."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a[shard])).to(dev)
    return ShardedBatch(**{f: t(host[f]) for f in _GRAPH_FIELDS},
                        layout=tuple(t(host[f]) for f in LAYOUT_FIELDS))


def stack_partitions(pgs, shard: int = 0, device=None) -> ShardedBatch:
    """list[PartitionedGraph] → this rank's :class:`ShardedBatch` (row
    ``shard``); see :func:`stack_partitions_host` for the re-padding."""
    return sharded_batch_to_device(stack_partitions_host(pgs), shard, device)


def _local_graph(sb: ShardedBatch, b: int) -> tuple[GeometricGraph, tuple]:
    """Scene ``b`` of this rank's shard: its graph and its CSR layout."""
    e = sb.senders.shape[-1]
    g = GeometricGraph(
        x=sb.x[b], v=sb.v[b], h=sb.h[b], senders=sb.senders[b],
        receivers=sb.receivers[b],
        edge_attr=torch.zeros((e, 0), dtype=sb.x.dtype, device=sb.x.device),
        node_mask=sb.node_mask[b], edge_mask=sb.edge_mask[b])
    return g, tuple(a[b] for a in sb.layout)


def _resolve_overlap(cfg: FastEGNNConfig,
                     overlap: Optional[bool]) -> FastEGNNConfig:
    """``overlap=None`` keeps ``cfg.overlap_sync`` (default: overlapped);
    a bool pins the schedule (the parity checks build both this way)."""
    if overlap is None:
        return cfg
    return cfg._replace(overlap_sync=bool(overlap))


def build_dist_apply(cfg: FastEGNNConfig, mesh: GraphAxis,
                     overlap: Optional[bool] = None):
    """The distributed forward: ``(params, ShardedBatch) → (x_pred (B,
    n_cap, 3), VirtualState with (B, C, ·) leaves)`` for this rank's shard;
    the virtual state is the same on every rank.  The scenes run one after
    another, each with its own sums."""
    cfg = _resolve_overlap(cfg, overlap)

    def apply(params, sb: ShardedBatch):
        xs, zs, ss = [], [], []
        for b in range(sb.x.shape[0]):
            g, lay = _local_graph(sb, b)
            x, _, vs = fast_egnn_apply(params, cfg, g, axis=mesh,
                                       edge_layout=lay)
            xs.append(x)
            zs.append(vs.z)
            ss.append(vs.s)
        return torch.stack(xs), VirtualState(z=torch.stack(zs),
                                             s=torch.stack(ss))

    return apply


def build_dist_loss(cfg: FastEGNNConfig, mesh: GraphAxis,
                    lam_mmd: float = 0.01, mmd_sigma: float = 1.5,
                    overlap: Optional[bool] = None):
    """Eq. 18 on this rank: ``(params, ShardedBatch) → loss`` (0-d), the
    global masked MSE (summed over shards) averaged over the batch plus
    λ × the rank mean of the batch-mean local MMD (one batched call of the
    MMD kernel pair with ``cfg.use_kernel``).  The same value on every
    rank."""
    cfg = _resolve_overlap(cfg, overlap)
    apply = build_dist_apply(cfg, mesh)

    def loss_fn(params, sb: ShardedBatch) -> Tensor:
        x, vs = apply(params, sb)
        mse = masked_mse(x, sb.x_target, sb.node_mask, axis=mesh)
        mmd = mmd_loss(vs.z, sb.x_target, sb.node_mask, sigma=mmd_sigma,
                       use_kernel=cfg.use_kernel)
        mmd_mean = graph_sum(mmd.mean(), mesh) / mesh.size  # Σ_d / D
        return mse.mean() + lam_mmd * mmd_mean

    return loss_fn


def dist_value_and_grad(loss_fn, params, sb: ShardedBatch,
                        mesh: GraphAxis) -> tuple[Tensor, dict]:
    """``(loss, gradient tree)`` of ``loss_fn`` over the whole axis: each
    rank differentiates ``loss / D``, and the ranks' gradients are summed
    in rank order (one collective of every leaf), so every rank holds the
    same gradient of Eq. 18."""
    work = tree_map(lambda p: p.detach().requires_grad_(True), params)
    flat: list = []
    tree_map(flat.append, work)  # leaves in tree_map order
    loss = loss_fn(work, sb)
    grads = torch.autograd.grad(loss / mesh.size, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, flat)]
    summed = sum_across(torch.cat([g.reshape(-1) for g in grads]), mesh)
    out, i = [], 0
    for p in flat:
        out.append(summed[i:i + p.numel()].reshape(p.shape))
        i += p.numel()
    it = iter(out)
    return loss.detach(), tree_map(lambda _: next(it), work)


def build_dist_train_step(cfg: FastEGNNConfig, mesh: GraphAxis, opt: Adam,
                          lam_mmd: float = 0.01, mmd_sigma: float = 1.5,
                          overlap: Optional[bool] = None):
    """The distributed train step, Eq. 18 + Alg. 1: ``(train_step,
    loss_fn)`` with ``train_step(params, opt_state, ShardedBatch) →
    (params, opt_state, loss)``; the gradient is
    :func:`dist_value_and_grad`'s and every rank takes the same Adam
    step.  ``overlap`` pins the layer schedule (default
    ``cfg.overlap_sync``); both give the same losses and parameters."""
    loss_fn = build_dist_loss(cfg, mesh, lam_mmd, mmd_sigma, overlap)

    def train_step(params, opt_state, sb: ShardedBatch):
        loss, grads = dist_value_and_grad(loss_fn, params, sb, mesh)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss

    return train_step, loss_fn
