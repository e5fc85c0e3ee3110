"""Hand-written CUDA kernels, their plain PyTorch versions and the glue
that feeds them model parameters."""
