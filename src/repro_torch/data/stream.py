"""The streaming data plane (DESIGN.md §8): :class:`BatchStream`, and the
process-wide worker pool for host-side graph builds.

:class:`BatchStream` is a re-iterable stream of fixed-shape batches:
``iter(stream)`` yields one epoch (``GraphBatch``es on one device,
``ShardedBatch``es on a mesh), ``len``, indexing and :meth:`materialize`
give the eager list, and ``Pipeline.fit`` re-iterates it once an epoch.

* **Background builds:** the numpy work (radius graphs, drops, padding,
  CSR layouts; on a mesh, this rank's shard of each sample) runs on
  ``num_workers`` threads behind a bounded queue of ``prefetch`` host
  batches; the device upload happens on the consumer's thread, one batch
  ahead.  ``prefetch=0`` or ``num_workers=0`` iterates synchronously.  A
  build error is re-raised in the consumer.
* **Order:** with ``reshuffle_each_epoch`` off every epoch replays the
  eager order (``shuffle_seed`` applied once), so streamed batches are
  bitwise the eager ``dataset_to_batches`` / mesh batches; on, epoch
  ``k`` is shuffled by ``default_rng((shuffle_seed or 0, k))``, the
  reference's permutation.
* **Layout cache:** ``cache_dir`` routes every CSR layout build through
  ``data.layout_cache`` (a warm run builds none).

On a mesh (``mesh``, a ``core.collectives.GraphAxis``) each rank builds
only its own shard of each sample (``partition_shards(shard_range=(rank,
rank + 1))``, sample ``j`` of a batch split with ``seed=j``), the
reference's process-sharded mode; the ranks hold their own shards, so
there is no global array to assemble.  Unless ``edge_cap`` is given, each
sample's edge capacity is agreed by an integer max over the group on the
consumer's thread, batch by batch, in the same order on every rank (the
workers make no collective call).  The trailing samples short of a full
batch are dropped with a warning (the sharded step has no sample mask).
"""
from __future__ import annotations

import queue as queue_lib
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

DEFAULT_PREFETCH = 2  # host batches queued ahead of the consumer
DEFAULT_WORKERS = 4  # host build threads

_SHARED_POOL: ThreadPoolExecutor | None = None
_SHARED_POOL_LOCK = threading.Lock()


def shared_worker_pool(max_workers: int = DEFAULT_WORKERS
                       ) -> ThreadPoolExecutor:
    """The shared worker pool, created at first use.

    Long-lived consumers, such as the rollout engines' asynchronous
    Verlet rebuilds (DESIGN.md §10), submit here instead of each starting
    threads of their own, so host build work is capped at one budget; a
    :class:`BatchStream` epoch uses threads of its own.
    """
    global _SHARED_POOL
    with _SHARED_POOL_LOCK:
        if _SHARED_POOL is None or getattr(_SHARED_POOL, "_shutdown", False):
            _SHARED_POOL = ThreadPoolExecutor(
                max_workers=max_workers, thread_name_prefix="repro-stream")
        return _SHARED_POOL


_END = object()  # producer → consumer: the epoch is done


class _Failure:
    """A producer's exception, re-raised on the consumer's thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _put(q: queue_lib.Queue, item, stop: threading.Event) -> bool:
    """A bounded put that gives up once the consumer left the epoch."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue_lib.Full:
            continue
    return False


class BatchStream:
    """A re-iterable stream of fixed-shape training batches (see the
    module docstring).

    One device: ``GraphBatch``es at the dataset's shared capacities, the
    trailing partial batch mask-padded (or dropped with a warning when
    ``drop_last``); ``with_layout`` attaches the CSR layout.  On a mesh:
    this rank's ``ShardedBatch``es (layouts always built), partitioned by
    ``partition``.  Batches land on ``device`` (default CUDA; on a mesh,
    the axis's device).
    """

    def __init__(self, samples: Sequence, batch_size: int, *,
                 r: float = np.inf, drop_rate: float = 0.0,
                 edge_cap: Optional[int] = None,
                 shuffle_seed: Optional[int] = None,
                 reshuffle_each_epoch: bool = False,
                 with_layout: bool = True, drop_last: bool = False,
                 cache_dir: Optional[str] = None,
                 prefetch: int = DEFAULT_PREFETCH,
                 num_workers: int = DEFAULT_WORKERS, mesh=None,
                 partition: str = "random", device=None):
        from repro_torch.kernels.runtime import resolve_device

        self._samples = list(samples)
        self.batch_size = int(batch_size)
        self.r = r
        self.drop_rate = drop_rate
        self.edge_cap = edge_cap
        self.shuffle_seed = shuffle_seed
        self.reshuffle_each_epoch = bool(reshuffle_each_epoch)
        self.with_layout = bool(with_layout) or mesh is not None
        self.mesh = mesh
        self.drop_last = bool(drop_last) or mesh is not None
        self.prefetch = int(prefetch)
        self.num_workers = int(num_workers)
        self.partition = partition
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        if cache_dir is not None:
            from repro_torch.data.layout_cache import LayoutCache

            self._cache = LayoutCache(cache_dir)
        else:
            self._cache = None
        self._lock = threading.Lock()
        self._epoch = 0  # epochs handed out by __iter__ (the reshuffle key)
        self._prepared = None  # one device: per-sample arrays + layouts
        self._host_cache = None  # mesh: an epoch's host batches, by order
        self._host_cache_order = None
        self._materialized = None
        rem = len(self._samples) % self.batch_size
        if rem and self.drop_last:  # known now: warn once, at construction
            where = (f"mesh n_shards={mesh.size}; the sharded step has no "
                     f"sample mask" if mesh is not None else "drop_last=True")
            warnings.warn(f"BatchStream: dropping the trailing {rem} samples "
                          f"({where}, batch_size={self.batch_size})",
                          stacklevel=3)

    # ------------------------------------------------------------ contract
    def __len__(self) -> int:
        full, rem = divmod(len(self._samples), self.batch_size)
        return full + (1 if rem and not self.drop_last else 0)

    def __getitem__(self, i):
        return self.materialize()[i]

    def __iter__(self):
        with self._lock:
            epoch = self._epoch
            self._epoch += 1
        order = self._order(epoch)
        if self.prefetch <= 0 or self.num_workers <= 0:
            return self._sync_iter(order)
        return self._async_iter(order)

    def materialize(self) -> list:
        """The eager list: one epoch in the base order, built on the
        calling thread and kept; the same batches as iteration."""
        if self._materialized is None:
            self._materialized = list(self._sync_iter(self._order(None)))
        return self._materialized

    def _order(self, epoch: Optional[int]) -> np.ndarray:
        """The samples' order for one epoch: ``epoch=None`` or reshuffle
        off → the eager order (``shuffle_seed`` applied once); reshuffle on
        → keyed by ``(shuffle_seed, epoch)``."""
        idx = np.arange(len(self._samples))
        if self.reshuffle_each_epoch and epoch is not None:
            np.random.default_rng((self.shuffle_seed or 0, int(epoch))
                                  ).shuffle(idx)
        elif self.shuffle_seed is not None:
            np.random.default_rng(self.shuffle_seed).shuffle(idx)
        return idx

    # ----------------------------------------------------- host batch build
    def _host_items(self, order: np.ndarray):
        """The epoch's host items, in order, built by the workers: numpy
        ``HostBatch``es on one device; on a mesh ``(slice, local shards)``
        (or finished host dicts when ``edge_cap`` is given)."""
        if self.mesh is not None:
            return self._windowed(self._mesh_local, self._slices(order))
        return self._host_batches_single(order)

    def _slices(self, order: np.ndarray) -> list:
        bs, n = self.batch_size, len(order)
        return [order[i:i + bs] for i in range(0, n - bs + 1, bs)]

    def _host_batches_single(self, order):
        from repro_torch.data.loader import collate_host

        prepared = self._ensure_prepared()
        if not prepared:
            return
        for sl in self._slices(order):
            yield collate_host([prepared[j] for j in sl])
        n, bs = len(prepared), self.batch_size
        rem = n % bs
        if rem and not self.drop_last:
            yield collate_host([prepared[j] for j in order[n - rem:]],
                               pad_to=bs)

    def _ensure_prepared(self) -> list:
        """Per-sample padded arrays (with layouts) at the dataset's shared
        capacities, built once on the workers and reused by every epoch."""
        with self._lock:
            if self._prepared is not None:
                return self._prepared
            from repro_torch.data.loader import (attach_layout, repad_arrays,
                                                 sample_h, sample_to_arrays)

            def build(s):
                return sample_to_arrays(s.x0, s.v0, sample_h(s), s.x1,
                                        r=self.r, drop_rate=self.drop_rate,
                                        edge_cap=self.edge_cap)

            arrays = self._pmap(build, self._samples)
            if arrays:
                n_cap = max(a["x"].shape[0] for a in arrays)
                e_cap = self.edge_cap or max(a["senders"].shape[0]
                                             for a in arrays)
                arrays = [repad_arrays(a, n_cap, e_cap) for a in arrays]
                if self.with_layout:
                    arrays = self._pmap(
                        lambda a: attach_layout(a, cache=self._cache), arrays)
            self._prepared = arrays
            return arrays

    def _mesh_local(self, sl: np.ndarray):
        """This rank's unpadded shard of each sample of one batch (sample
        ``j`` split with ``seed=j``); finished at once when the edge
        capacity is fixed."""
        from repro_torch.data.loader import sample_h
        from repro_torch.data.partition import partition_shards

        rank, d = self.mesh.rank, self.mesh.size
        local = [partition_shards(
            s.x0, s.v0, sample_h(s), s.x1, d, self.r,
            strategy=self.partition, drop_rate=self.drop_rate, seed=j,
            shard_range=(rank, rank + 1))[0]
            for j, s in enumerate(self._samples[i] for i in sl)]
        if self.edge_cap is not None:
            return self._mesh_finish(sl, local, [int(self.edge_cap)]
                                     * len(local))
        return sl, local

    def _mesh_finish(self, sl, local: list, caps: list) -> dict:
        """Pad each sample's shard at its agreed capacities and stack the
        batch (``stack_partitions_host``)."""
        from repro_torch.data.partition import pad_shards
        from repro_torch.distributed.dist_egnn import stack_partitions_host

        d = self.mesh.size
        pgs = [pad_shards([sh], int(np.ceil(self._samples[i].x0.shape[0]
                                            / d)), cap, self._cache)
               for i, sh, cap in zip(sl, local, caps)]
        return stack_partitions_host(pgs, layout_cache=self._cache)

    def _finish(self, item):
        """Consumer side: a mesh item's agreed edge capacities (one integer
        max over the group a batch), then its padding and layouts."""
        if self.mesh is None or isinstance(item, dict):
            return item
        from repro_torch.core.collectives import max_across

        sl, local = item
        caps = max_across([max(1, sh.senders.size) for sh in local],
                          self.mesh)
        return self._mesh_finish(sl, local, caps)

    def _windowed(self, fn, items: list):
        """``fn`` over ``items`` in order, at most ``num_workers`` in
        flight (serially with fewer than two workers or items)."""
        if self.num_workers <= 1 or len(items) <= 1:
            for it in items:
                yield fn(it)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            pending, it = deque(), iter(items)
            while True:
                while len(pending) < self.num_workers:
                    nxt = next(it, None)
                    if nxt is None:
                        break
                    pending.append(ex.submit(fn, nxt))
                if not pending:
                    return
                yield pending.popleft().result()

    def _pmap(self, fn, items: list) -> list:
        return list(self._windowed(fn, items))

    # --------------------------------------------------------- the consumer
    def _to_device(self, host):
        if self.mesh is not None:
            from repro_torch.distributed.dist_egnn import \
                sharded_batch_to_device

            return sharded_batch_to_device(host, 0, self.device)
        from repro_torch.data.loader import batch_to_device

        return batch_to_device(host, self.device)

    def _cached_epoch(self, order: np.ndarray):
        """A mesh epoch's finished host batches, when this order was
        built before (reshuffle off: every epoch after the first)."""
        if self.mesh is None:
            return None
        with self._lock:
            if self._host_cache_order == tuple(int(i) for i in order):
                return list(self._host_cache)
        return None

    def _keep(self, order: np.ndarray, built: list) -> None:
        if (self.mesh is not None and not self.reshuffle_each_epoch
                and len(built) == len(self._slices(order))):
            with self._lock:
                self._host_cache = built
                self._host_cache_order = tuple(int(i) for i in order)

    def _sync_iter(self, order: np.ndarray):
        cached = self._cached_epoch(order)
        if cached is not None:
            for host in cached:
                yield self._to_device(host)
            return
        built = []
        for item in self._host_items(order):
            host = self._finish(item)
            built.append(host)
            yield self._to_device(host)
        self._keep(order, built)

    def _async_iter(self, order: np.ndarray):
        cached = self._cached_epoch(order)
        if cached is not None:
            return (self._to_device(h) for h in cached)
        q = queue_lib.Queue(maxsize=max(1, self.prefetch))
        stop = threading.Event()

        def produce():
            try:
                for item in self._host_items(order):
                    if not _put(q, item, stop):
                        return
                _put(q, _END, stop)
            except BaseException as e:  # re-raised on the consumer's side
                _put(q, _Failure(e), stop)

        thread = threading.Thread(target=produce, daemon=True,
                                  name="BatchStream-producer")

        def gen():
            # started lazily: an iterator never advanced leaks no thread
            thread.start()
            buf, built = deque(), []  # one device batch ahead
            try:
                while True:
                    item = q.get()
                    if item is _END:
                        break
                    if isinstance(item, _Failure):
                        raise item.exc
                    host = self._finish(item)
                    built.append(host)
                    buf.append(self._to_device(host))
                    if len(buf) > 1:
                        yield buf.popleft()
                self._keep(order, built)
                while buf:
                    yield buf.popleft()
            finally:
                stop.set()
                while True:  # unblock a producer waiting on a full queue
                    try:
                        q.get_nowait()
                    except queue_lib.Empty:
                        break

        return gen()
