"""On-disk cache of the host CSR layouts (DESIGN.md §8.2).

The CSR layout of a padded edge list (``data.loader.csr_layout``:
``indptr``, ``n_edges``, ``sperm``, ``sptr``) is a pure function of the
padded edge arrays, their mask and the padded node count, so a run over
the same dataset rebuilds the same bytes every time.  This module keeps
them on disk, keyed by a content hash of those inputs and a format
version:

* a warm run loads its layouts instead of building them, and
  :func:`cache_stats` counts it (``builds`` is 0 on a warm run);
* different edge content, a different node count or a new format misses
  cleanly; an entry whose stored shapes disagree with ``n_nodes`` and the
  edge capacity (stale), or that cannot be read (corrupt, truncated), is
  a miss, rebuilt and rewritten, never a crash.

Every layout build of the data plane goes through :func:`get_or_build`
(``cache=None`` just builds), so the build count is counted, not
inferred.  Writes are atomic (``tempfile`` + ``os.replace``), so worker
threads and runs sharing one directory cannot tear an entry.  Processes
sharing a directory also claim a build (``<key>.claim``, created with
``O_CREAT|O_EXCL``): a process that loses the claim checks the entry once
more and otherwise builds anyway (the entries are content-addressed, so
both write the same bytes), counted as ``duplicate_builds``.  Claims
never block and expire after :data:`CLAIM_TTL_S`.

The reference keys its entries on the TPU band geometry as well
(``LayoutMeta``, ``pick_windows``); the CSR layout has none.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
import threading
import time
from typing import Optional

import numpy as np

_FORMAT_VERSION = 1

#: a claim file older than this belongs to a crashed or stalled owner
CLAIM_TTL_S = 300.0

# counted under a lock: the stream's worker threads record concurrently
_STATS = {"builds": 0, "hits": 0, "misses": 0, "errors": 0,
          "duplicate_builds": 0}
_STATS_LOCK = threading.Lock()

_FIELDS = ("indptr", "n_edges", "sperm", "sptr")


def cache_stats() -> dict:
    """A snapshot of the counters; ``builds`` counts every layout build
    routed through :func:`get_or_build`, with or without a cache."""
    with _STATS_LOCK:
        return dict(_STATS)


def reset_cache_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def _record(event: str) -> None:
    with _STATS_LOCK:
        _STATS[event] = _STATS.get(event, 0) + 1


def _mask(snd: np.ndarray, edge_mask: Optional[np.ndarray]) -> np.ndarray:
    return (np.ones(snd.shape, np.float32) if edge_mask is None
            else np.asarray(edge_mask))


def layout_key(snd: np.ndarray, rcv: np.ndarray, n_nodes: int, *,
               edge_mask: Optional[np.ndarray] = None) -> str:
    """The cache key: a SHA-256 of the padded edge arrays (the layout's
    exact inputs), the mask, ``n_nodes`` and the format version."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(snd, np.int32).tobytes())
    h.update(np.ascontiguousarray(rcv, np.int32).tobytes())
    if edge_mask is not None:
        h.update(np.ascontiguousarray(edge_mask, np.float32).tobytes())
    else:
        h.update(b"nomask")
    h.update(f"v{_FORMAT_VERSION}:{int(n_nodes)}:{len(snd)}".encode())
    return h.hexdigest()


def build_layout(snd: np.ndarray, rcv: np.ndarray, n_nodes: int,
                 edge_mask: Optional[np.ndarray] = None) -> tuple:
    """The CSR layout itself (``data.loader.csr_layout``)."""
    from repro_torch.data.loader import csr_layout

    return csr_layout(snd, rcv, _mask(snd, edge_mask), n_nodes)


class LayoutCache:
    """A directory of ``<content-hash>.npz`` CSR layout entries."""

    def __init__(self, cache_dir):
        self.dir = os.fspath(cache_dir)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"{key}.npz")

    def load(self, key: str, n_nodes: int, e_cap: int) -> Optional[tuple]:
        """One entry, or ``None`` when it is missing, stale or corrupt."""
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as f:
                lay = tuple(f[k] for k in _FIELDS)
        except Exception:
            _record("errors")  # corrupt or truncated: rebuild, not crash
            return None
        indptr, n_edges, sperm, sptr = lay
        if (indptr.shape != (n_nodes + 1,) or sptr.shape != (n_nodes + 1,)
                or sperm.shape != (e_cap,) or n_edges.shape != ()
                or not 0 <= int(n_edges) <= e_cap):
            _record("errors")  # stale: shapes of another capacity
            return None
        return indptr, n_edges[()], sperm, sptr

    def claim(self, key: str) -> bool:
        """Try to own the build of ``key``: True when this process created
        the claim (or cannot coordinate), False when another writer holds a
        fresh one; a claim older than :data:`CLAIM_TTL_S` is taken over."""
        path = self._path(key) + ".claim"
        for _ in range(2):
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                with os.fdopen(fd, "w") as f:
                    f.write(f"pid={os.getpid()}\n")
                return True
            except FileExistsError:
                try:
                    if time.time() - os.path.getmtime(path) <= CLAIM_TTL_S:
                        return False
                    os.unlink(path)  # stale: take it over and retry
                except OSError:
                    return False  # the owner released or renewed it
            except OSError:
                return True
        return False

    def release(self, key: str) -> None:
        try:
            os.unlink(self._path(key) + ".claim")
        except OSError:
            pass

    def store(self, key: str, lay: tuple, overwrite: bool = True) -> None:
        """Write an entry atomically; a failed write leaves it unsaved.
        ``overwrite=False`` keeps an existing entry (a claim's loser does
        not rewrite what the owner landed)."""
        if not overwrite and os.path.exists(self._path(key)):
            return
        payload = {k: np.asarray(v) for k, v in zip(_FIELDS, lay)}
        try:
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    np.savez(f, **payload)
                os.replace(tmp, self._path(key))
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except OSError:
            pass  # a cache that cannot write is a slow cache


def get_or_build(cache: Optional[LayoutCache], snd: np.ndarray,
                 rcv: np.ndarray, n_nodes: int, *,
                 edge_mask: Optional[np.ndarray] = None) -> tuple:
    """The data plane's one CSR layout entry point.

    With a cache: look the content hash up; a miss (or a stale or corrupt
    entry) claims the build, builds and writes.  Without: build.  Either
    way the counters record what happened."""
    if cache is None:
        _record("builds")
        return build_layout(snd, rcv, n_nodes, edge_mask)
    e_cap = int(np.asarray(snd).shape[0])
    key = layout_key(snd, rcv, n_nodes, edge_mask=edge_mask)
    lay = cache.load(key, n_nodes, e_cap)
    if lay is not None:
        _record("hits")
        return lay
    _record("misses")
    repair = os.path.exists(cache._path(key))  # present but stale/corrupt
    owned = cache.claim(key)
    if not owned:
        lay = cache.load(key, n_nodes, e_cap)  # the owner may have landed it
        if lay is not None:
            _record("hits")
            return lay
        _record("duplicate_builds")
    _record("builds")
    try:
        lay = build_layout(snd, rcv, n_nodes, edge_mask)
        cache.store(key, lay, overwrite=owned or repair)
    finally:
        if owned:
            cache.release(key)
    return lay
