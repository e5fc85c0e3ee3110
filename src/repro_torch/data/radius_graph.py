"""Host-side radius graph, edge dropping, receiver sort, padding and the
CSR row offsets the CUDA edge kernel walks.

Pure numpy, with the reference data path's semantics: a cell-list radius
search in O(N·deg), drop-longest edge dropping (Sec. VII-B), a canonical
(receiver, sender) sort, fixed-capacity padding, :func:`csr_indptr` and
the sender permutation of :func:`csr_sender_perm` (the edge backward's
sender pass walks it).
"""
from __future__ import annotations

import warnings

import numpy as np


def radius_graph(x: np.ndarray, r: float,
                 max_num_neighbors: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """All directed edges (i→j, i≠j) with ‖x_i−x_j‖ ≤ r.  Cell-list, O(N·deg).

    Returns (senders, receivers) int32 arrays in canonical
    (receiver, sender) order.  Nodes are binned into cells of side ``r``
    via one flattened-key argsort and candidates gathered per 27-cell
    stencil with ``searchsorted``.  The cutoff is evaluated in ``x``'s
    dtype (f32 inputs compare ``d² ≤ f32(r)²`` in f32).
    """
    n = x.shape[0]
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    if not np.isfinite(r):
        idx = np.arange(n)
        snd = np.repeat(idx, n)
        rcv = np.tile(idx, n)
        keep = snd != rcv
        snd, rcv = snd[keep], rcv[keep]
        order = np.lexsort((snd, rcv))
        return snd[order].astype(np.int32), rcv[order].astype(np.int32)

    rt = np.asarray(x).dtype.type(r)
    cell = np.floor(x / rt).astype(np.int64)
    # flatten 3-D cell coords to one sortable key over a grid padded by one
    # ghost cell per face, so every stencil offset stays a valid key
    c = cell - cell.min(axis=0) + 1
    dims = c.max(axis=0) + 2
    key = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    order = np.argsort(key, kind="stable")
    sk = key[order]

    off = np.array([-1, 0, 1], np.int64)
    off_flat = ((off[:, None, None] * dims[1] + off[None, :, None])
                * dims[2] + off[None, None, :]).reshape(-1)
    probe = key[:, None] + off_flat[None, :]  # (n, 27) neighbour-cell keys
    lo = np.searchsorted(sk, probe, side="left")
    hi = np.searchsorted(sk, probe, side="right")
    cnt = (hi - lo).reshape(-1)
    tot = int(cnt.sum())
    starts = lo.reshape(-1)
    run0 = np.cumsum(cnt) - cnt
    idx = np.repeat(starts - run0, cnt) + np.arange(tot)
    cand = order[idx]
    rcv = np.repeat(np.arange(n, dtype=np.int64),
                    cnt.reshape(n, 27).sum(axis=1))
    d2 = np.sum((x[cand] - x[rcv]) ** 2, axis=-1)
    keep = (d2 <= rt * rt) & (cand != rcv)
    snd, rcv = cand[keep], rcv[keep]
    order = np.lexsort((snd, rcv))
    snd, rcv = snd[order], rcv[order]
    if max_num_neighbors is not None and snd.size:
        # keep the nearest max_num_neighbors per receiver
        d2 = np.sum((x[snd] - x[rcv]) ** 2, axis=-1)
        order = np.lexsort((d2, rcv))
        snd, rcv, d2 = snd[order], rcv[order], d2[order]
        rank = np.arange(rcv.size) - np.searchsorted(rcv, rcv, side="left")
        keep = rank < max_num_neighbors
        snd, rcv = snd[keep], rcv[keep]
    return snd.astype(np.int32), rcv.astype(np.int32)


def drop_longest_edges(x: np.ndarray, snd: np.ndarray, rcv: np.ndarray,
                       p: float) -> tuple[np.ndarray, np.ndarray]:
    """Sec. VII-B edge dropping: drop the top-p fraction by length, keeping
    the survivors in their original order.  Fed canonically sorted edges,
    the stable tie-break is (receiver, sender)."""
    if p <= 0.0 or snd.size == 0:
        return snd, rcv
    if p >= 1.0:
        return snd[:0], rcv[:0]
    d2 = np.sum((x[snd] - x[rcv]) ** 2, axis=-1)
    n_keep = int(round((1.0 - p) * snd.size))
    keep = np.sort(np.argsort(d2, kind="stable")[:n_keep])
    return snd[keep], rcv[keep]


def sort_edges_by_receiver(snd: np.ndarray, rcv: np.ndarray
                           ) -> tuple[np.ndarray, np.ndarray]:
    """CSR layout pass: sort edges by (receiver, sender) — a canonical order,
    independent of the cell-list traversal and the build radius."""
    if snd.size == 0:
        return snd, rcv
    order = np.lexsort((snd, rcv))
    return snd[order], rcv[order]


def csr_indptr(receivers: np.ndarray, n_edges: int, n_nodes: int) -> np.ndarray:
    """CSR row offsets (``n_nodes + 1``, int32) of a padded edge list.

    Only the first ``n_edges`` slots are real and receiver-sorted:
    :func:`pad_edges` fills the tail with receiver 0, which breaks the sort
    after the last real edge, so the tail must not be counted.  Per-step
    mask holes (``rollout.engine._step_edge_masks``) change only the edge
    mask, never the slots, so the offsets stay valid between rebuilds.
    Raises ``ValueError`` if the real slots are not receiver-sorted.
    """
    rcv = np.asarray(receivers)[:int(n_edges)].astype(np.int64)
    if rcv.size and (np.any(np.diff(rcv) < 0) or rcv[0] < 0
                     or rcv[-1] >= n_nodes):
        raise ValueError("csr_indptr needs receiver-sorted edges with "
                         "receivers in [0, n_nodes)")
    counts = np.bincount(rcv, minlength=n_nodes)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def csr_sender_perm(senders: np.ndarray, n_edges: int, n_nodes: int
                    ) -> tuple[np.ndarray, np.ndarray]:
    """The slots ``[0, n_edges)`` stably sorted by sender (int32), and the
    sender row offsets into that permutation (``n_nodes + 1``, int32).

    Like :func:`csr_indptr` it reads only the first ``n_edges`` slots (the
    :func:`pad_edges` tail is not part of the graph).  Raises
    ``ValueError`` for a sender outside ``[0, n_nodes)``.
    """
    snd = np.asarray(senders)[:int(n_edges)].astype(np.int64)
    if snd.size and (snd.min() < 0 or snd.max() >= n_nodes):
        raise ValueError("csr_sender_perm needs senders in [0, n_nodes)")
    perm = np.argsort(snd, kind="stable").astype(np.int32)
    counts = np.bincount(snd, minlength=n_nodes)
    return perm, np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


_TRUNCATION_WARNED: set[tuple[int, int]] = set()


def reset_truncation_warnings() -> None:
    """Re-arm the once-per-(capacity, overflow) truncation warning."""
    _TRUNCATION_WARNED.clear()


def warn_edge_truncation(e: int, capacity: int, how: str) -> None:
    """Warn that ``e`` built edges exceeded ``capacity`` — once per
    (capacity, overflow) pair, not per batch."""
    sig = (int(capacity), int(e) - int(capacity))
    if sig in _TRUNCATION_WARNED:
        return
    _TRUNCATION_WARNED.add(sig)
    warnings.warn(
        f"edge truncation: capacity {capacity} short by {e - capacity} "
        f"edges ({e} built; {how} drop) — warning once per "
        f"(capacity, overflow) pair",
        stacklevel=3)


def pad_edges(snd: np.ndarray, rcv: np.ndarray, capacity: int,
              x: np.ndarray | None = None
              ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad/truncate to ``capacity``; returns (senders, receivers, edge_mask).

    Over capacity the longest edges are dropped when ``x`` is given (the
    tail of the list otherwise), with a warning once per (capacity,
    overflow) pair.  Padding slots hold sender 0, receiver 0, mask 0.
    """
    e = snd.size
    if e > capacity:
        warn_edge_truncation(
            e, capacity, "longest-first" if x is not None else "tail-first")
        if x is not None:
            d2 = np.sum((x[snd] - x[rcv]) ** 2, axis=-1)
            keep = np.sort(np.argsort(d2, kind="stable")[:capacity])
            snd, rcv = snd[keep], rcv[keep]
        else:
            snd, rcv = snd[:capacity], rcv[:capacity]
        e = capacity
    out_s = np.zeros(capacity, np.int32)
    out_r = np.zeros(capacity, np.int32)
    mask = np.zeros(capacity, np.float32)
    out_s[:e] = snd
    out_r[:e] = rcv
    mask[:e] = 1.0
    return out_s, out_r, mask


def pad_nodes(arr: np.ndarray, capacity: int,
              fill: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Pad node array (N, ...) to (capacity, ...); returns (padded, mask)."""
    n = arr.shape[0]
    if n > capacity:
        raise ValueError(f"{n} nodes exceed capacity {capacity}")
    out = np.full((capacity,) + arr.shape[1:], fill, arr.dtype)
    out[:n] = arr
    mask = np.zeros(capacity, np.float32)
    mask[:n] = 1.0
    return out, mask
