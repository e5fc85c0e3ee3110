"""Recursive rollout over Verlet neighbour lists, one scene or a batch."""
from repro_torch.rollout.engine import (BatchedRolloutEngine,
                                        BatchedRolloutResult, RolloutEngine,
                                        RolloutResult)

__all__ = ["BatchedRolloutEngine", "BatchedRolloutResult", "RolloutEngine",
           "RolloutResult"]
