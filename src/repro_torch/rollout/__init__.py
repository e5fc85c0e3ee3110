"""Recursive rollout over Verlet neighbour lists: one scene, a batch, or
one scene on a DistEGNN mesh."""
from repro_torch.rollout.engine import (BatchedRolloutEngine,
                                        BatchedRolloutResult,
                                        DistRolloutEngine, RolloutEngine,
                                        RolloutResult)

__all__ = ["BatchedRolloutEngine", "BatchedRolloutResult",
           "DistRolloutEngine", "RolloutEngine", "RolloutResult"]
