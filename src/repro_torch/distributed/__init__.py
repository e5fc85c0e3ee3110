"""DistEGNN on ``torch.distributed``: the distributed forward and train
step (``dist_egnn``) and the process-to-shard map (``sharding``)."""
