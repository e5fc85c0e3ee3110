"""Serving metrics: per-request latency phases and fleet-level rates.

Per request the service records three timestamps relative to admission
— dispatch (queue wait), first streamed frame (time-to-first-frame),
and completion (total latency) — plus the compute span of each batch
and its occupancy (real scenes / batch slots).  :meth:`ServingMetrics.
metrics` folds them into one snapshot: p50/p99/mean latency,
scenes per second over the observation span, a batch-occupancy
histogram, and program-cache build counts stitched in by the service.

Reservoirs are bounded deques — a long-lived service keeps a sliding
window of the most recent ``window`` requests rather than growing
without bound; counters are cumulative.
"""
from __future__ import annotations

import threading
from collections import Counter, deque


def _percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of a non-empty list."""
    xs = sorted(values)
    if not xs:
        return float("nan")
    idx = min(len(xs) - 1, max(0, int(round(q / 100.0 * (len(xs) - 1)))))
    return float(xs[idx])


class ServingMetrics:
    """Thread-safe accumulator behind ``RolloutService.metrics()``."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self._latency = deque(maxlen=window)      # admission -> done
        self._queue_wait = deque(maxlen=window)   # admission -> dispatch
        self._first_frame = deque(maxlen=window)  # admission -> first frame
        self._compute = deque(maxlen=window)      # per-batch compute span
        self._occupancy = Counter()               # real scenes per batch
        self._done_t = deque(maxlen=window)       # completion timestamps
        self.submitted = 0
        self.rejected = 0
        self.completed = 0
        self.failed = 0
        self.batches = 0
        self.scenes = 0
        self.rebuilds = 0       # Verlet-list rebuilds across batches
        self.rebuild_waits = 0  # rebuilds where the host blocked the batch
        self._rebuild_s = deque(maxlen=window)  # per-batch rebuild wall-time

    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_reject(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_batch(self, n_real: int, batch_size: int,
                     compute_s: float, *, rebuilds: int = 0,
                     rebuild_waits: int = 0,
                     rebuild_s: float = 0.0) -> None:
        with self._lock:
            self.batches += 1
            self.scenes += n_real
            self._occupancy[(n_real, batch_size)] += 1
            self._compute.append(compute_s)
            self.rebuilds += rebuilds
            self.rebuild_waits += rebuild_waits
            self._rebuild_s.append(rebuild_s)

    def record_request(self, *, queue_wait_s: float, first_frame_s: float,
                       latency_s: float, done_t: float,
                       failed: bool = False) -> None:
        with self._lock:
            if failed:
                self.failed += 1
                return
            self.completed += 1
            self._queue_wait.append(queue_wait_s)
            self._first_frame.append(first_frame_s)
            self._latency.append(latency_s)
            self._done_t.append(done_t)

    def metrics(self) -> dict:
        """Snapshot; all latencies in seconds, rates in scenes/s."""
        with self._lock:
            lat = list(self._latency)
            qw = list(self._queue_wait)
            ff = list(self._first_frame)
            comp = list(self._compute)
            reb = list(self._rebuild_s)
            done_t = list(self._done_t)
            occ = {f"{real}/{size}": count
                   for (real, size), count in sorted(self._occupancy.items())}
            snap = {
                "submitted": self.submitted,
                "rejected": self.rejected,
                "completed": self.completed,
                "failed": self.failed,
                "batches": self.batches,
                "scenes": self.scenes,
                "rebuilds": self.rebuilds,
                "rebuild_waits": self.rebuild_waits,
                "occupancy_hist": occ,
            }
        if reb:
            snap["rebuild_mean_s"] = sum(reb) / len(reb)
            snap["rebuild_p99_s"] = _percentile(reb, 99)
        if lat:
            span = max(done_t) - min(done_t) if len(done_t) > 1 else 0.0
            snap.update({
                "latency_p50_s": _percentile(lat, 50),
                "latency_p99_s": _percentile(lat, 99),
                "latency_mean_s": sum(lat) / len(lat),
                "queue_wait_p50_s": _percentile(qw, 50),
                "queue_wait_p99_s": _percentile(qw, 99),
                "first_frame_p50_s": _percentile(ff, 50),
                "compute_mean_s": (sum(comp) / len(comp)) if comp else 0.0,
                # open-loop throughput over the completion span; a single
                # completion has no span, so fall back to 1/latency
                "scenes_per_s": ((len(lat) - 1) / span if span > 0
                                 else (1.0 / lat[0] if lat[0] > 0 else 0.0)),
            })
        if self.batches:
            with self._lock:
                total_slots = sum(size * c for (_, size), c
                                  in self._occupancy.items())
                real = sum(r * c for (r, _), c in self._occupancy.items())
            snap["mean_occupancy"] = real / total_slots if total_slots else 0.0
        return snap
