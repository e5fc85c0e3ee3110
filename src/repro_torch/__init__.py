"""PyTorch + CUDA port of FastEGNN (rollout serving and training) and of
the LM stack's dense-attention path (gemma3 prefill and decode).

Module paths mirror the JAX package: ``repro_torch.X.Y`` is the
counterpart of ``repro.X.Y``.  The port imports ``torch`` and numpy only;
its hand-written CUDA kernels live in ``csrc/`` and are built with
``nvcc`` at first use (``kernels/build.py``).  Entry points default to
``device="cuda"`` and raise when no GPU is present; pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
