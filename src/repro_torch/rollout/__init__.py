"""Batched recursive rollout over Verlet neighbour lists."""
from repro_torch.rollout.engine import (BatchedRolloutEngine,
                                        BatchedRolloutResult)

__all__ = ["BatchedRolloutEngine", "BatchedRolloutResult"]
