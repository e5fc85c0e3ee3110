"""Which graph shards a process owns (DistEGNN's process-sharded data
plane, DESIGN.md §11)."""
from __future__ import annotations

from typing import Optional


def process_shard_range(n_shards: int, process_index: Optional[int] = None,
                        process_count: Optional[int] = None
                        ) -> tuple[int, int]:
    """Contiguous ``[lo, hi)`` of graph shards owned by this process.

    ``n_shards`` is the global D.  The process index and count default to
    this rank and the world size of the initialised ``torch.distributed``
    group (0 and 1 without one).  Requires ``n_shards % process_count ==
    0``: an uneven split would leave processes with different local
    shapes.
    """
    if process_index is None or process_count is None:
        import torch.distributed as dist

        init = dist.is_available() and dist.is_initialized()
        if process_index is None:
            process_index = dist.get_rank() if init else 0
        if process_count is None:
            process_count = dist.get_world_size() if init else 1
    pi, pc = int(process_index), int(process_count)
    if n_shards % pc:
        raise ValueError(
            f"process_shard_range: n_shards={n_shards} not divisible by "
            f"process_count={pc} — pick a shard count that is a multiple "
            f"of the process count")
    per = n_shards // pc
    return per * pi, per * (pi + 1)
