"""Graph partitioning for DistEGNN (Sec. VI): random and METIS-like.

Partitioning and the per-shard local graphs are host-side steps (numpy).
Each shard's arrays are padded to a fixed capacity; node indices inside a
shard are local (0..cap-1).  Beside the padded edge arrays every shard
carries the CSR layout the CUDA edge kernels walk, ``(indptr, n_edges,
sperm, sptr)`` of :func:`~repro_torch.data.loader.csr_layout`, the same
layout a single-device ``GraphBatch`` carries.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from repro_torch.data.radius_graph import (drop_longest_edges, pad_edges,
                                           pad_nodes, radius_graph,
                                           sort_edges_by_receiver)


def random_partition(rng: np.random.Generator, n: int, d: int) -> np.ndarray:
    """Balanced random assignment node → shard in [0, d)."""
    assign = np.arange(n) % d
    rng.shuffle(assign)
    return assign


def metis_like_partition(x: np.ndarray, snd: np.ndarray, rcv: np.ndarray,
                         d: int) -> np.ndarray:
    """Greedy balanced BFS growth — a METIS stand-in (edge-locality aware).

    Seeds d spatially spread nodes, grows each part over the undirected
    radius graph in round-robin, claiming neighbours of already-claimed
    nodes while parts stay under ``ceil(n / d)``; disconnected leftovers go
    to the smallest parts.  A pure function of ``(x, edges, d)``.
    """
    n = x.shape[0]
    cap = int(np.ceil(n / d))
    adj: list[list[int]] = [[] for _ in range(n)]
    # undirected, deduplicated and sorted, so the claim order is fixed
    if len(snd):
        fwd = np.stack([snd, rcv], axis=1)
        und = np.unique(np.concatenate([fwd, fwd[:, ::-1]]), axis=0)
        for s, r in und:
            adj[s].append(int(r))
    assign = np.full(n, -1, np.int64)
    # k-means++-style spread seeds
    seeds = [0]
    dist = np.sum((x - x[0]) ** 2, axis=-1)
    for _ in range(d - 1):
        seeds.append(int(np.argmax(dist)))
        dist = np.minimum(dist, np.sum((x - x[seeds[-1]]) ** 2, axis=-1))
    frontiers: list[list[int]] = []
    sizes = [0] * d
    for p, s in enumerate(seeds):
        if assign[s] == -1:
            assign[s] = p
            sizes[p] += 1
        frontiers.append([s])
    progress = True
    while progress:
        progress = False
        for p in range(d):
            if sizes[p] >= cap:
                continue
            new_frontier = []
            claimed = 0
            for u in frontiers[p]:
                for vtx in adj[u]:
                    if assign[vtx] == -1 and sizes[p] < cap:
                        assign[vtx] = p
                        sizes[p] += 1
                        new_frontier.append(vtx)
                        claimed += 1
            if claimed:
                frontiers[p] = new_frontier
                progress = True
    for vtx in np.nonzero(assign == -1)[0]:
        p = int(np.argmin(sizes))
        assign[vtx] = p
        sizes[p] += 1
    return assign


class PartitionedGraph(NamedTuple):
    """Shard-stacked arrays, leading dims ``(D, cap)``: x/v/h/x_target/
    node_mask per shard; senders/receivers are local indices into the
    shard's node slots.  ``indptr`` / ``n_edges`` / ``sperm`` / ``sptr`` are
    each shard's CSR layout over its padded edge list
    (:func:`~repro_torch.data.loader.csr_layout`)."""

    x: np.ndarray  # (D, n_cap, 3)
    v: np.ndarray
    h: np.ndarray
    senders: np.ndarray  # (D, e_cap)
    receivers: np.ndarray
    node_mask: np.ndarray  # (D, n_cap)
    edge_mask: np.ndarray  # (D, e_cap)
    x_target: np.ndarray  # (D, n_cap, 3)
    indptr: np.ndarray  # (D, n_cap + 1) int32
    n_edges: np.ndarray  # (D,) int64
    sperm: np.ndarray  # (D, e_cap) int32
    sptr: np.ndarray  # (D, n_cap + 1) int32


LAYOUT_FIELDS = ("indptr", "n_edges", "sperm", "sptr")


def shard_layout_fields(senders: np.ndarray, receivers: np.ndarray,
                        edge_mask: np.ndarray, n_cap: int,
                        layout_cache=None) -> dict:
    """(D, e_cap) padded local edge arrays → the stacked CSR layout fields
    (the one place they are built, for :func:`partition_sample` and
    :func:`repad_partition`), each through
    ``data.layout_cache.get_or_build`` (``layout_cache``: a ``LayoutCache``
    or ``None``)."""
    from repro_torch.data.layout_cache import get_or_build

    lays = [get_or_build(layout_cache, senders[d], receivers[d], n_cap,
                         edge_mask=edge_mask[d])
            for d in range(senders.shape[0])]
    return {f: np.stack(parts) for f, parts in zip(LAYOUT_FIELDS, zip(*lays))}


def repad_partition(pg: PartitionedGraph, n_cap: int, e_cap: int,
                    layout_cache=None) -> PartitionedGraph:
    """One PartitionedGraph at larger capacities: node and edge arrays grow
    by zero padding (masked slots) and the CSR layouts are rebuilt at the
    new shapes."""
    def pad_to(a, cap):
        width = [(0, 0), (0, cap - a.shape[1])] + [(0, 0)] * (a.ndim - 2)
        return np.pad(a, width)

    node = {f: pad_to(getattr(pg, f), n_cap)
            for f in ("x", "v", "h", "x_target", "node_mask")}
    edge = {f: pad_to(getattr(pg, f), e_cap)
            for f in ("senders", "receivers", "edge_mask")}
    lay = shard_layout_fields(edge["senders"], edge["receivers"],
                              edge["edge_mask"], n_cap, layout_cache)
    return pg._replace(**node, **edge, **lay)


def dynamic_radius(x: np.ndarray, assign: np.ndarray, d: int, r0: float,
                   target_edges: int, step: float = 0.001,
                   max_iter: int = 200) -> float:
    """Table VII: grow the cutoff until Σ_d local edges ≈ single-device count.

    Bisection over the grid ``r0 + k·step, k ≤ max_iter`` (the local edge
    count is monotone in the radius): the smallest grid point reaching the
    target, capped at ``r0 + max_iter·step``.
    """
    def total(r: float) -> int:
        t = 0
        for p in range(d):
            s, _ = radius_graph(x[assign == p], r)
            t += s.size
        return t

    if total(r0) >= target_edges:
        return r0
    lo, hi = 0, max_iter  # grid indices into r0 + k·step
    if total(r0 + hi * step) < target_edges:
        return r0 + hi * step
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if total(r0 + mid * step) >= target_edges:
            hi = mid
        else:
            lo = mid
    return r0 + hi * step


def _check(strategy: str, shard_range, d: int) -> None:
    if strategy not in ("random", "metis"):
        raise ValueError(f"unknown partition strategy {strategy!r}")
    lo, hi = (0, d) if shard_range is None else shard_range
    if not (0 <= lo < hi <= d):
        raise ValueError(f"shard_range {shard_range} outside [0, {d})")


class LocalShard(NamedTuple):
    """One shard before padding: its nodes' fields (in global index order)
    and its receiver-sorted local edge list after the drop."""

    x: np.ndarray
    v: np.ndarray
    h: np.ndarray
    x_target: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray


def partition_shards(x: np.ndarray, v: np.ndarray, h: np.ndarray,
                     x_target: np.ndarray, d: int, r: float, *,
                     strategy: str = "random", drop_rate: float = 0.0,
                     seed: int = 0,
                     shard_range: Optional[tuple[int, int]] = None
                     ) -> list[LocalShard]:
    """The unpadded shards ``lo..hi-1`` of one graph split d ways.

    The assignment is global and a pure function of ``seed`` (random) or
    of the graph (``'metis'``), so every process agrees on membership;
    radius graphs are built only for the shards of ``shard_range``.
    """
    _check(strategy, shard_range, d)
    if strategy == "random":
        assign = random_partition(np.random.default_rng(seed), x.shape[0], d)
    else:
        gs, gr = radius_graph(x, r)
        assign = metis_like_partition(x, gs, gr, d)
    lo, hi = (0, d) if shard_range is None else shard_range
    shards = []
    for p in range(lo, hi):
        idx = np.nonzero(assign == p)[0]
        xs = x[idx]
        snd, rcv = radius_graph(xs, r)
        # the canonical sort before the drop: its stable tie-break is
        # (receiver, sender), as for a single-device sample
        snd, rcv = sort_edges_by_receiver(snd, rcv)
        snd, rcv = drop_longest_edges(xs, snd, rcv, drop_rate)
        shards.append(LocalShard(xs, v[idx], h[idx], x_target[idx], snd, rcv))
    return shards


def pad_shards(shards: list[LocalShard], n_cap: int, e_cap: int,
               layout_cache=None) -> PartitionedGraph:
    """Pad unpadded shards to ``(n_cap, e_cap)`` and build their CSR
    layouts (through ``layout_cache``, a ``LayoutCache`` or ``None``)."""
    fields = ("x", "v", "h", "x_target", "senders", "receivers", "node_mask",
              "edge_mask")
    out = {k: [] for k in fields}
    for s in shards:
        xp, nm = pad_nodes(s.x, n_cap)
        out["x"].append(xp)
        out["v"].append(pad_nodes(s.v, n_cap)[0])
        out["h"].append(pad_nodes(s.h, n_cap)[0])
        out["x_target"].append(pad_nodes(s.x_target, n_cap)[0])
        sp, rp, em = pad_edges(s.senders, s.receivers, e_cap, s.x)
        out["senders"].append(sp)
        out["receivers"].append(rp)
        out["node_mask"].append(nm)
        out["edge_mask"].append(em)
    base = {k: np.stack(v) for k, v in out.items()}
    lay = shard_layout_fields(base["senders"], base["receivers"],
                              base["edge_mask"], n_cap, layout_cache)
    return PartitionedGraph(**base, **lay)


def partition_sample(
    x: np.ndarray,
    v: np.ndarray,
    h: np.ndarray,
    x_target: np.ndarray,
    d: int,
    r: float,
    *,
    strategy: str = "random",
    drop_rate: float = 0.0,
    n_cap: int | None = None,
    e_cap: int | None = None,
    seed: int = 0,
    shard_range: tuple[int, int] | None = None,
) -> PartitionedGraph:
    """Partition one large graph into d padded shards with local radius
    graphs (the paper's protocol: partition first, then each device builds
    its own local graph at the cutoff).

    ``shard_range=(lo, hi)`` builds only shards ``lo..hi-1`` (leading dim
    ``hi - lo``).  A partial range needs an explicit ``e_cap``: the
    default edge capacity is the max over all shards' edge counts, which a
    process that built only its own shards cannot know (a mesh pipeline
    agrees on it by a max over its group).  ``n_cap`` defaults to
    ``ceil(n / d)``.
    """
    _check(strategy, shard_range, d)
    if shard_range is not None and tuple(shard_range) != (0, d) \
            and e_cap is None:
        raise ValueError(
            "partition_sample: a partial shard_range needs an explicit "
            "e_cap — the default is the max over all shards' edge counts, "
            "which a process building only its own shards cannot compute "
            "consistently")
    shards = partition_shards(x, v, h, x_target, d, r, strategy=strategy,
                              drop_rate=drop_rate, seed=seed,
                              shard_range=shard_range)
    if n_cap is None:
        n_cap = int(np.ceil(x.shape[0] / d))
    if e_cap is None:
        e_cap = max(1, max(s.senders.size for s in shards))
    return pad_shards(shards, n_cap, e_cap)
