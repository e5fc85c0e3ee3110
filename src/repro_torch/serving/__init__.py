"""Rollout serving plane: capacity-bucket admission, a bounded request
queue, dynamic same-bucket batching onto
:class:`~repro_torch.rollout.engine.BatchedRolloutEngine`, a bounded
engine cache, streaming responses and serving metrics."""
from repro_torch.serving.batcher import (DEFAULT_NODE_BUCKETS, AdmissionError,
                                         BucketKey, DynamicBatcher,
                                         PendingRequest, QueueFullError,
                                         capacity_bucket)
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.programs import LRUCache, ProgramCache, ProgramKey
from repro_torch.serving.service import (RolloutService, ServiceConfig,
                                         StreamingResponse, validate_scene)

__all__ = [
    "AdmissionError", "BucketKey", "DEFAULT_NODE_BUCKETS", "DynamicBatcher",
    "LRUCache", "PendingRequest", "ProgramCache", "ProgramKey",
    "QueueFullError", "RolloutService", "ServiceConfig", "ServingMetrics",
    "StreamingResponse", "capacity_bucket", "validate_scene",
]
