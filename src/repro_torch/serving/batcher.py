"""Request admission + dynamic scene batching for the rollout service.

The serving plane coalesces concurrent simulation
requests into batched rollouts.  Two scenes may share a batch only when
the *whole engine* they need is identical, so admission maps
every request to a :class:`BucketKey` — the capacity bucket (``node_cap``
rounded up a fixed ladder, ``edge_cap`` derived per bucket) plus the
physics parameters the engine runs with (``r``, ``skin``,
``dt``, ``drop_rate``, ``wrap_box``).  Requests in different buckets
NEVER share a batch (capacity isolation — a 1K scene padded into an 8K
program would waste ~8× compute; mixed physics would be wrong, not just
slow).  Horizons (``n_steps``) are *not* part of the key: a batch runs to
the longest member horizon and shorter members are truncated on the way
out.

:class:`DynamicBatcher` is pure request-queue logic with time injected —
``admit(pending, now)`` / ``next_batch(now)`` — so the batching window
contract is testable under a simulated arrival schedule without threads:
a bucket's queue dispatches when it reaches ``max_batch`` scenes (full
batch, no waiting) or when its oldest request has waited ``window_s``
(the batching window — bounded latency cost for coalescing).  Admission
applies backpressure: more than ``queue_cap`` queued scenes raises
:class:`QueueFullError` instead of growing without bound.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

#: default capacity ladder: small scenes share the smallest program that
#: fits; each rung costs one engine per (model, batch size)
DEFAULT_NODE_BUCKETS = (256, 1024, 4096, 8192, 16384, 65536, 131072)


class AdmissionError(ValueError):
    """The request can never be served (bad scene, no fitting bucket)."""


class QueueFullError(RuntimeError):
    """Backpressure: the request queue is at capacity — retry later."""


def capacity_bucket(n: int, buckets=DEFAULT_NODE_BUCKETS) -> int:
    """Smallest configured node capacity that fits an ``n``-node scene."""
    for cap in sorted(buckets):
        if n <= cap:
            return int(cap)
    raise AdmissionError(
        f"scene has {n} nodes but the largest configured capacity bucket "
        f"is {max(buckets)} — add a bucket or shrink the scene")


@dataclass(frozen=True)
class BucketKey:
    """Everything two scenes must share to ride one engine.

    ``(node_cap, edge_cap)`` is the capacity bucket; the rest are the
    physics constants of the batched engine.  Hashable — the batcher's
    group key and (together with model and batch size) the program-cache
    key.
    """

    node_cap: int
    edge_cap: int
    r: float
    skin: float
    dt: float
    drop_rate: float
    wrap_box: Optional[float]


@dataclass
class PendingRequest:
    """One admitted request waiting in (or dispatched from) the queue."""

    x0: np.ndarray
    v0: np.ndarray
    h: np.ndarray
    n_steps: int
    bucket: BucketKey
    enqueue_t: float
    request_id: int
    handle: object = None  # the service's StreamingResponse
    dispatch_t: Optional[float] = None
    first_frame_t: Optional[float] = None
    finished: bool = False

    @property
    def n(self) -> int:
        return self.x0.shape[0]


@dataclass
class _Group:
    queue: deque = field(default_factory=deque)


class DynamicBatcher:
    """Same-bucket coalescing behind a short batching window.

    Pure logic, clock injected: the service drives it with
    ``time.monotonic()``, tests with a simulated schedule.  Dispatch
    policy — oldest deadline first:

    * a bucket with ``>= max_batch`` queued scenes dispatches
      ``max_batch`` of them immediately (a full batch never waits);
    * otherwise a bucket dispatches everything it has once its oldest
      request is ``window_s`` old (bounded coalescing latency);
    * ties/broken by oldest enqueue time, so no bucket starves.
    """

    def __init__(self, max_batch: int, window_s: float, queue_cap: int):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if window_s < 0:
            raise ValueError(f"window_s must be >= 0, got {window_s}")
        self.max_batch = int(max_batch)
        self.window_s = float(window_s)
        self.queue_cap = int(queue_cap)
        self._groups: dict[BucketKey, _Group] = {}
        self._depth = 0

    def __len__(self) -> int:
        """Total queued (not yet dispatched) scenes across buckets."""
        return self._depth

    def admit(self, pending: PendingRequest) -> None:
        """Queue one admitted request, or raise :class:`QueueFullError`."""
        if self._depth >= self.queue_cap:
            raise QueueFullError(
                f"serving queue full ({self._depth}/{self.queue_cap} "
                f"scenes queued) — backpressure, retry later")
        self._groups.setdefault(pending.bucket, _Group()).queue.append(
            pending)
        self._depth += 1

    def next_batch(self, now: float):
        """The next dispatchable ``(BucketKey, [PendingRequest])`` batch,
        or ``None`` if every bucket is still inside its window."""
        best = None
        for key, grp in self._groups.items():
            if not grp.queue:
                continue
            oldest = grp.queue[0].enqueue_t
            full = len(grp.queue) >= self.max_batch
            due = now - oldest >= self.window_s
            if full or due:
                if best is None or oldest < best[2]:
                    best = (key, grp, oldest)
        if best is None:
            return None
        key, grp, _ = best
        batch = [grp.queue.popleft()
                 for _ in range(min(self.max_batch, len(grp.queue)))]
        self._depth -= len(batch)
        if not grp.queue:
            del self._groups[key]
        return key, batch

    def next_deadline(self) -> Optional[float]:
        """Earliest time any queued bucket's window expires (the service's
        sleep bound); ``None`` when the queue is empty."""
        deadlines = [g.queue[0].enqueue_t + self.window_s
                     for g in self._groups.values() if g.queue]
        return min(deadlines) if deadlines else None
