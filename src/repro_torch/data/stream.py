"""The process-wide worker pool for host-side graph builds.

Counterpart of the pool in the JAX package's ``data/stream.py``; the
streaming batch loader that also draws on it there is not ported yet.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

DEFAULT_WORKERS = 4  # host build threads

_SHARED_POOL: ThreadPoolExecutor | None = None
_SHARED_POOL_LOCK = threading.Lock()


def shared_worker_pool(max_workers: int = DEFAULT_WORKERS
                       ) -> ThreadPoolExecutor:
    """The shared worker pool, created at first use.

    Long-lived consumers, such as the rollout engine's asynchronous
    Verlet rebuilds (DESIGN.md §10), submit here instead of each starting
    threads of their own, so host build work is capped at one budget.
    """
    global _SHARED_POOL
    with _SHARED_POOL_LOCK:
        if _SHARED_POOL is None or getattr(_SHARED_POOL, "_shutdown", False):
            _SHARED_POOL = ThreadPoolExecutor(
                max_workers=max_workers, thread_name_prefix="repro-stream")
        return _SHARED_POOL
