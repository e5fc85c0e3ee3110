"""Dataset → padded, batched ``GeometricGraph`` conversion (eager).

:class:`GraphBatch` carries, beside the padded graph tensors, the CSR
layout the CUDA edge kernels walk — ``(indptr (B,N+1), n_edges (B,),
sperm (B,E), sptr (B,N+1))``, the receiver row offsets of
:func:`~repro_torch.data.radius_graph.csr_indptr` and the sender
permutation of :func:`~repro_torch.data.radius_graph.csr_sender_perm`,
built on the host with numpy — and a ``sample_mask`` that marks the real
slots of a mask-padded trailing batch.  Assembly is split host/device as
in the JAX package: :func:`collate_host` stacks numpy arrays into a
:class:`HostBatch`, :func:`batch_to_device` moves it to the device, and
:func:`make_batch` is their composition.  :func:`dataset_to_batches`
is one epoch of ``data.stream.BatchStream``, materialized.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.data.radius_graph import (csr_indptr, csr_sender_perm,
                                           drop_longest_edges, pad_edges,
                                           pad_nodes, radius_graph,
                                           sort_edges_by_receiver)
from repro_torch.kernels.runtime import resolve_device

_NODE_KEYS = ("x", "v", "h", "x_target", "node_mask")
_EDGE_KEYS = ("senders", "receivers", "edge_mask")


class GraphBatch(NamedTuple):
    """One fixed-shape training batch.

    ``graph`` / ``x_target`` carry a leading batch dim (B, ...).
    ``layout`` is the stacked CSR layout ``(indptr, n_edges, sperm,
    sptr)`` (``None`` for layout-free batches, which only the plain path
    takes).  ``sample_mask`` (B,) marks real slots: the trailing partial
    batch of a dataset is padded with replicas of its last sample at mask
    0, so losses and metrics weight by it; ``None`` means every slot is
    real.
    """

    graph: GeometricGraph
    x_target: torch.Tensor  # (B, N, 3)
    layout: Optional[tuple] = None
    sample_mask: Optional[torch.Tensor] = None  # (B,) 1.0 real / 0.0 pad


def sample_h(s) -> np.ndarray:
    """A raw sample's invariant feature field (``h``, or ``charges``)."""
    h = getattr(s, "h", None)
    return s.charges if h is None else h


def sample_to_arrays(x0: np.ndarray, v0: np.ndarray, h: np.ndarray,
                     x1: np.ndarray, *, r: float = np.inf,
                     drop_rate: float = 0.0, node_cap: int | None = None,
                     edge_cap: int | None = None) -> dict:
    """One raw sample → padded numpy arrays (receiver-sorted real edges
    first, padding tail last).  The canonical sort comes before the drop,
    so the drop's stable tie-break is (receiver, sender), as in the JAX
    package."""
    snd, rcv = radius_graph(x0, r)
    snd, rcv = sort_edges_by_receiver(snd, rcv)
    snd, rcv = drop_longest_edges(x0, snd, rcv, drop_rate)
    node_cap = node_cap or x0.shape[0]
    edge_cap = edge_cap if edge_cap is not None else max(1, snd.size)
    xp, nm = pad_nodes(x0, node_cap)
    vp, _ = pad_nodes(v0, node_cap)
    hp, _ = pad_nodes(h, node_cap)
    tp, _ = pad_nodes(x1, node_cap)
    sp, rp, em = pad_edges(snd, rcv, edge_cap, x0)
    return dict(x=xp, v=vp, h=hp, senders=sp, receivers=rp, node_mask=nm,
                edge_mask=em, x_target=tp)


def repad_arrays(a: dict, node_cap: int, edge_cap: int) -> dict:
    """Grow one sample's padded arrays to larger shared capacities (the
    padding is masked zeros, so this is a zero-pad)."""
    out = dict(a)
    for k in _NODE_KEYS:
        pad = node_cap - a[k].shape[0]
        if pad:
            out[k] = np.pad(a[k], [(0, pad)] + [(0, 0)] * (a[k].ndim - 1))
    for k in _EDGE_KEYS:
        pad = edge_cap - a[k].shape[0]
        if pad:
            out[k] = np.pad(a[k], (0, pad))
    return out


def csr_layout(senders: np.ndarray, receivers: np.ndarray,
               edge_mask: np.ndarray, n_nodes: int) -> tuple:
    """The CSR layout ``(indptr, n_edges, sperm, sptr)`` of one padded edge
    list (real slots first), ``sperm`` padded with zeros to the edge
    capacity (only ``sptr[-1]`` entries are read)."""
    e = int(np.count_nonzero(edge_mask))
    perm, sptr = csr_sender_perm(senders, e, n_nodes)
    sperm = np.zeros(senders.shape[0], np.int32)
    sperm[:perm.size] = perm
    return csr_indptr(receivers, e, n_nodes), np.int64(e), sperm, sptr


def attach_layout(a: dict, cache=None) -> dict:
    """Store the sample's CSR layout (:func:`csr_layout`) under
    ``"layout"``.  The build goes through ``data.layout_cache.get_or_build``
    (``cache``: a ``LayoutCache`` to load it from, or ``None``), so its
    counters see it."""
    from repro_torch.data.layout_cache import get_or_build

    a = dict(a)
    a["layout"] = get_or_build(cache, a["senders"], a["receivers"],
                               a["x"].shape[0], edge_mask=a["edge_mask"])
    return a


class HostBatch(NamedTuple):
    """Numpy twin of :class:`GraphBatch`, before the device transfer."""

    arrays: dict  # str → np.ndarray, leading batch dim
    layout: Optional[tuple]  # stacked numpy layout arrays
    sample_mask: Optional[np.ndarray]  # (B,) float32 | None


def collate_host(samples: Sequence[dict],
                 pad_to: int | None = None) -> HostBatch:
    """Stack per-sample array dicts into one numpy :class:`HostBatch`;
    ``pad_to`` pads a short batch by replicating the last sample at
    ``sample_mask`` 0."""
    samples = [dict(s) for s in samples]
    mask = None
    if pad_to is not None and len(samples) < pad_to:
        n_real = len(samples)
        samples += [dict(samples[-1]) for _ in range(pad_to - n_real)]
        mask = (np.arange(pad_to) < n_real).astype(np.float32)
    lays = [s.pop("layout", None) for s in samples]
    layout = None
    if all(lay is not None for lay in lays):
        layout = tuple(np.stack(parts) for parts in zip(*lays))
    stk = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    return HostBatch(arrays=stk, layout=layout, sample_mask=mask)


def batch_to_device(hb: HostBatch, device=None) -> GraphBatch:
    """Host numpy batch → :class:`GraphBatch` on ``device`` (default
    CUDA)."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    stk = hb.arrays
    b, e = stk["senders"].shape
    g = GeometricGraph(
        x=t(stk["x"]), v=t(stk["v"]), h=t(stk["h"]),
        senders=t(stk["senders"]), receivers=t(stk["receivers"]),
        edge_attr=torch.zeros((b, e, 0), dtype=torch.float32, device=dev),
        node_mask=t(stk["node_mask"]), edge_mask=t(stk["edge_mask"]))
    layout = None if hb.layout is None else tuple(t(a) for a in hb.layout)
    mask = None if hb.sample_mask is None else t(hb.sample_mask)
    return GraphBatch(graph=g, x_target=t(stk["x_target"]), layout=layout,
                      sample_mask=mask)


def make_batch(samples: Sequence[dict], pad_to: int | None = None,
               device=None) -> GraphBatch:
    """Stack per-sample array dicts into one :class:`GraphBatch`."""
    return batch_to_device(collate_host(samples, pad_to), device)


def single_sample_batch(x: np.ndarray, v: np.ndarray, h: np.ndarray, *,
                        r: float = np.inf, drop_rate: float = 0.0,
                        x_target: np.ndarray | None = None,
                        node_cap: int | None = None,
                        edge_cap: int | None = None,
                        with_layout: bool = True, device=None) -> GraphBatch:
    """One scene → a B=1 :class:`GraphBatch` (``x_target`` defaults to
    ``x``).  ``with_layout`` attaches the CSR layout the kernel path
    needs."""
    arr = sample_to_arrays(x, v, h, x if x_target is None else x_target,
                           r=r, drop_rate=drop_rate, node_cap=node_cap,
                           edge_cap=edge_cap)
    if with_layout:
        arr = attach_layout(arr)
    return make_batch([arr], device=device)


def dataset_to_batches(samples, batch_size: int, *, r: float = np.inf,
                       drop_rate: float = 0.0, edge_cap: int | None = None,
                       shuffle_seed: int | None = None,
                       with_layout: bool = True, drop_last: bool = False,
                       cache_dir: str | None = None,
                       device=None) -> list[GraphBatch]:
    """Raw samples (NamedTuples with ``x0``/``v0``/``x1`` and a feature
    field) → one epoch of fixed-shape batches, eagerly: the materialized
    ``data.stream.BatchStream``.

    All samples share the dataset's node and edge capacities (the largest
    of any sample unless ``edge_cap`` is given).  ``shuffle_seed`` permutes
    the samples once with ``np.random.default_rng(seed)``.  The trailing
    ``len % batch_size`` samples become a mask-padded partial batch, or are
    dropped with a warning when ``drop_last``.  ``cache_dir`` loads the CSR
    layouts from a ``data.layout_cache`` directory.  The same batches, in
    the same order, as the JAX package's ``dataset_to_batches``.
    """
    from repro_torch.data.stream import BatchStream

    return BatchStream(
        samples, batch_size, r=r, drop_rate=drop_rate, edge_cap=edge_cap,
        shuffle_seed=shuffle_seed, with_layout=with_layout,
        drop_last=drop_last, cache_dir=cache_dir,
        device=device).materialize()
