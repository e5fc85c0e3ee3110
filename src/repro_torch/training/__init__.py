"""Training: objectives, the Adam optimizer, the epoch loop and
checkpoints."""
