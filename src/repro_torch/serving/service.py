"""The rollout service: submit scenes, stream frames.

:class:`RolloutService` sits on top of one built
:class:`~repro_torch.pipeline.Pipeline` and serves concurrent rollout
requests.  ``submit`` validates the scene, maps it to a capacity bucket
and enqueues it; a background worker coalesces same-bucket requests
inside the batching window, fetches (or builds, once) the
:class:`~repro_torch.rollout.engine.BatchedRolloutEngine` for the bucket
from a bounded :class:`~repro_torch.serving.programs.ProgramCache`, and
runs one batched rollout.  Clients hold a :class:`StreamingResponse` — a
generator of per-step frames that starts yielding at the first rebuild
boundary — or block on ``result()`` for the full trajectory.

The service only duck-types the pipeline (``predict_fn``, ``params``,
``device``, ``cfg.use_kernel``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.serving.batcher import (DEFAULT_NODE_BUCKETS, AdmissionError,
                                   BucketKey, DynamicBatcher, PendingRequest,
                                   QueueFullError, capacity_bucket)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.programs import ProgramCache, ProgramKey

__all__ = ["ServiceConfig", "RolloutService", "StreamingResponse",
           "validate_scene", "AdmissionError", "QueueFullError"]


def validate_scene(x, v, h, *, name: str = "scene"):
    """Check one scene's arrays before they reach the device path.

    Returns float32 ``(x, v, h)``; raises :class:`AdmissionError` with a
    message naming the offending array instead of letting a shape error
    surface three layers down inside the rollout engine.
    """
    x = np.asarray(x)
    v = np.asarray(v)
    h = np.asarray(h)
    if x.ndim != 2 or x.shape[1] != 3:
        raise AdmissionError(
            f"{name}: x must have shape (n, 3), got {x.shape}")
    n = x.shape[0]
    if n == 0:
        raise AdmissionError(f"{name}: x is empty (0 nodes)")
    if v.shape != (n, 3):
        raise AdmissionError(
            f"{name}: v must have shape ({n}, 3) to match x, got {v.shape}")
    if h.ndim != 2 or h.shape[0] != n:
        raise AdmissionError(
            f"{name}: h must have shape ({n}, f), got {h.shape}")
    for label, arr in (("x", x), ("v", v), ("h", h)):
        if not np.issubdtype(arr.dtype, np.floating):
            raise AdmissionError(
                f"{name}: {label} must be floating point, got {arr.dtype}")
        if not np.isfinite(arr).all():
            raise AdmissionError(
                f"{name}: {label} contains non-finite values "
                f"(nan/inf) — refusing to simulate")
    return (x.astype(np.float32), v.astype(np.float32),
            h.astype(np.float32))


class StreamingResponse:
    """Client handle for one submitted scene.

    ``frames()`` is a generator of per-step ``(n, 3)`` position frames,
    yielded in step order as the batched rollout streams chunk blocks —
    the first frames arrive at the first rebuild boundary, not at the
    horizon.  ``result()`` blocks to completion and returns the full
    ``(n_steps, n, 3)`` trajectory.  A failed batch re-raises the
    worker-side exception in whichever of the two the client is using.
    """

    def __init__(self, request_id: int, n_steps: int, n_nodes: int):
        self.request_id = request_id
        self.n_steps = int(n_steps)
        self.n_nodes = int(n_nodes)
        self._cond = threading.Condition()
        self._blocks: deque = deque()   # streamed (k, n, 3) blocks, in order
        self._all: list = []            # every block, for result()
        self._pushed = 0
        self._done = False
        self._exc: Optional[BaseException] = None
        # timings (seconds, relative to submission), set by the service
        self.queue_wait_s: Optional[float] = None
        self.first_frame_s: Optional[float] = None
        self.latency_s: Optional[float] = None

    # ---- service side
    def _push(self, block: np.ndarray) -> None:
        with self._cond:
            self._blocks.append(block)
            self._all.append(block)
            self._pushed += block.shape[0]
            self._cond.notify_all()

    def _finish(self, exc: Optional[BaseException] = None) -> None:
        with self._cond:
            self._done = True
            self._exc = exc
            self._cond.notify_all()

    # ---- client side
    @property
    def done(self) -> bool:
        with self._cond:
            return self._done

    def frames(self):
        """Yield each step's ``(n, 3)`` frame in order; blocks while the
        rollout is still producing."""
        yielded = 0
        while True:
            with self._cond:
                while not self._blocks and not self._done:
                    self._cond.wait()
                if self._blocks:
                    block = self._blocks.popleft()
                elif self._exc is not None:
                    raise self._exc
                else:
                    if yielded != self.n_steps and self._exc is None:
                        raise RuntimeError(
                            f"stream ended after {yielded}/"
                            f"{self.n_steps} frames")
                    return
            for t in range(block.shape[0]):
                yield block[t]
                yielded += 1

    def result(self) -> np.ndarray:
        """Block until done; the full ``(n_steps, n, 3)`` trajectory."""
        with self._cond:
            while not self._done:
                self._cond.wait()
            if self._exc is not None:
                raise self._exc
            return np.concatenate(self._all, axis=0)


@dataclass
class ServiceConfig:
    """Serving knobs."""

    max_batch: int = 4          # batch slots per engine
    window_s: float = 0.02      # batching window (coalescing latency bound)
    queue_cap: int = 64         # queued scenes before backpressure
    node_buckets: tuple = DEFAULT_NODE_BUCKETS
    edge_cap_per_node: int = 32  # bucket edge_cap = node_cap * this
    engine_cache: int = 4       # live engines (LRU)
    metrics_window: int = 4096


class RolloutService:
    """Queue + batcher + program cache + streaming worker, one model.

    ``pipeline`` is a built ``repro_torch.pipeline.Pipeline``
    (duck-typed); the service snapshots its ``params``, ``predict_fn`` and
    ``device`` at construction; a mesh pipeline (DistEGNN) raises
    ``ValueError``.  ``clock`` is injectable for deterministic tests.
    """

    def __init__(self, pipeline, *, model: str = "default",
                 config: Optional[ServiceConfig] = None, clock=time.monotonic):
        if getattr(pipeline, "mesh", None) is not None:
            raise ValueError(
                "RolloutService serves the single-device path; for the mesh "
                "path call Pipeline.rollout, which runs DistRolloutEngine")
        self.cfg = config or ServiceConfig()
        self.model = str(model)
        self._predict_fn = pipeline.predict_fn
        self._params = pipeline.params
        self._device = pipeline.device
        self._clock = clock
        self._batcher = DynamicBatcher(self.cfg.max_batch, self.cfg.window_s,
                                       self.cfg.queue_cap)
        self._programs = ProgramCache(self.cfg.engine_cache)
        self._metrics = ServingMetrics(window=self.cfg.metrics_window)
        self._cond = threading.Condition()
        self._next_id = 0
        self._stop = False
        self._worker = threading.Thread(target=self._loop,
                                        name="rollout-serving", daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- client API
    def submit(self, x, v, h, n_steps: int, *, r: float, skin: float = 0.0,
               dt: float, drop_rate: float = 0.0,
               wrap_box: Optional[float] = None) -> StreamingResponse:
        """Admit one scene for rollout; returns a streaming handle.

        Raises :class:`AdmissionError` on a malformed scene or one too
        large for every configured bucket, :class:`QueueFullError` when
        the queue is at capacity (backpressure — retry later).
        """
        if int(n_steps) <= 0:
            raise AdmissionError(f"n_steps must be positive, got {n_steps}")
        x, v, h = validate_scene(x, v, h)
        node_cap = capacity_bucket(x.shape[0], self.cfg.node_buckets)
        bucket = BucketKey(
            node_cap=node_cap,
            edge_cap=node_cap * self.cfg.edge_cap_per_node,
            r=float(r), skin=float(skin), dt=float(dt),
            drop_rate=float(drop_rate),
            wrap_box=None if wrap_box is None else float(wrap_box))
        now = self._clock()
        with self._cond:
            if self._stop:
                raise RuntimeError("service is closed")
            req_id = self._next_id
            self._next_id += 1
            handle = StreamingResponse(req_id, int(n_steps), x.shape[0])
            pending = PendingRequest(
                x0=x, v0=v, h=h, n_steps=int(n_steps), bucket=bucket,
                enqueue_t=now, request_id=req_id, handle=handle)
            try:
                self._batcher.admit(pending)
            except QueueFullError:
                self._metrics.record_reject()
                raise
            self._metrics.record_submit()
            self._cond.notify_all()
        return handle

    def metrics(self) -> dict:
        """Serving snapshot: latency percentiles, scenes/s, occupancy
        histogram, program-cache stats, current queue depth."""
        snap = self._metrics.metrics()
        snap["program_cache"] = self._programs.stats()
        with self._cond:
            snap["queue_depth"] = len(self._batcher)
        return snap

    def close(self) -> None:
        """Drain nothing — fail queued requests and stop the worker."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._worker.join(timeout=30)
        while True:
            got = self._batcher.next_batch(float("inf"))
            if got is None:
                break
            for p in got[1]:
                p.handle._finish(RuntimeError("service closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---------------------------------------------------------------- worker
    def _loop(self) -> None:
        while True:
            with self._cond:
                batch = None
                while not self._stop:
                    now = self._clock()
                    batch = self._batcher.next_batch(now)
                    if batch is not None:
                        break
                    deadline = self._batcher.next_deadline()
                    timeout = (None if deadline is None
                               else max(1e-4, deadline - now))
                    self._cond.wait(timeout=timeout)
                if batch is None:
                    return  # stopping and nothing dispatchable
            self._run_batch(*batch)

    def _engine_key(self, bucket: BucketKey) -> ProgramKey:
        return ProgramKey(
            model=self.model, node_cap=bucket.node_cap,
            edge_cap=bucket.edge_cap, batch_size=self.cfg.max_batch,
            r=bucket.r, skin=bucket.skin,
            dt=bucket.dt, drop_rate=bucket.drop_rate,
            wrap_box=bucket.wrap_box)

    def _build_engine(self, bucket: BucketKey):
        from repro_torch.rollout.engine import BatchedRolloutEngine

        return BatchedRolloutEngine(
            self._predict_fn, batch_size=self.cfg.max_batch,
            node_cap=bucket.node_cap, edge_cap=bucket.edge_cap,
            r=bucket.r, skin=bucket.skin, dt=bucket.dt,
            drop_rate=bucket.drop_rate, wrap_box=bucket.wrap_box, device=self._device)

    def _run_batch(self, bucket: BucketKey, batch: list) -> None:
        t_dispatch = self._clock()
        for p in batch:
            p.dispatch_t = t_dispatch
        try:
            engine = self._programs.get_or_build(
                self._engine_key(bucket), lambda: self._build_engine(bucket))
            horizon = max(p.n_steps for p in batch)

            def on_chunk(start: int, frames: np.ndarray) -> None:
                now = self._clock()
                for j, p in enumerate(batch):
                    if p.finished:
                        continue
                    hi = min(start + frames.shape[1], p.n_steps)
                    if hi <= start:
                        continue
                    if p.first_frame_t is None:
                        p.first_frame_t = now
                    p.handle._push(frames[j, :hi - start, :p.n])
                    if hi >= p.n_steps:  # this scene's horizon is done —
                        p.finished = True  # release the client early
                        p.handle._finish()

            res = engine.run(self._params,
                             [(p.x0, p.v0, p.h) for p in batch],
                             horizon, on_chunk=on_chunk)
        except BaseException as exc:  # noqa: BLE001 — fail the whole batch
            now = self._clock()
            for p in batch:
                if not p.finished:
                    p.finished = True
                    p.handle._finish(exc)
                self._metrics.record_request(
                    queue_wait_s=t_dispatch - p.enqueue_t,
                    first_frame_s=float("nan"), latency_s=now - p.enqueue_t,
                    done_t=now, failed=True)
            return
        t_done = self._clock()
        self._metrics.record_batch(len(batch), self.cfg.max_batch,
                                   t_done - t_dispatch,
                                   rebuilds=res.rebuild_count,
                                   rebuild_waits=res.rebuild_waits,
                                   rebuild_s=res.rebuild_s)
        for p in batch:
            if not p.finished:  # defensive: stream should have finished it
                p.finished = True
                p.handle._finish()
            h = p.handle
            h.queue_wait_s = t_dispatch - p.enqueue_t
            h.first_frame_s = ((p.first_frame_t or t_done) - p.enqueue_t)
            h.latency_s = t_done - p.enqueue_t
            self._metrics.record_request(
                queue_wait_s=h.queue_wait_s, first_frame_s=h.first_frame_s,
                latency_s=h.latency_s, done_t=t_done)
