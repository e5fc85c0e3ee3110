"""Joining and starting a DistEGNN run on ``torch.distributed``.

:func:`init_distributed` is the counterpart of the reference's
``jax.distributed.initialize`` wrapper: it joins this process to the group
at ``tcp://<address>`` with the backend rule of
``core.collectives.pick_backend`` (NCCL when every rank has a GPU of its
own, gloo when ranks share one GPU or run on the CPU), chosen up front and
printed, never switched on failure.  Nothing on a machine tells a process
of its peers: the address, the world size and the rank are the caller's.
:func:`spawn_ranks` starts the ranks of one machine as processes of their
own (``torch.multiprocessing``, spawn) and waits for them.  The LM's TPU
pod mesh (``make_production_mesh``) is not ported.
"""
from __future__ import annotations

import socket
from typing import Callable

import torch


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, device=None,
                     verbose: bool = True) -> str:
    """Join the group at ``coordinator_address`` (``host:port``) as rank
    ``process_id`` of ``num_processes``; returns the backend.

    ``device`` (``'cuda'``, the default, or ``'cpu'``) is where the rank's
    tensors live.  With a GPU per rank each rank takes GPU ``rank``
    (NCCL); with fewer GPUs than ranks every rank shares GPU 0 over gloo.
    """
    import torch.distributed as dist

    from repro_torch.core.collectives import pick_backend
    from repro_torch.kernels.runtime import resolve_device

    dev = resolve_device(device)
    rank, world = int(process_id), int(num_processes)
    backend = pick_backend(dev, world)
    if dev.type == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    if verbose:
        where = (f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda"
                 else "cpu")
        print(f"rank {rank}/{world}: torch.distributed backend {backend} on "
              f"{where}", flush=True)
    return backend


def _rank_main(rank: int, fn: Callable, world: int, port: int, device,
               args: tuple) -> None:
    import torch.distributed as dist

    init_distributed(f"localhost:{port}", world, rank, device=device)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, *args, device=None) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    joined by :func:`init_distributed` at a free localhost port; raises if
    any rank fails.  CUDA ranks start fresh interpreters (``spawn``: a
    forked CUDA context is unusable), so ``fn`` must be importable by name
    (a module-level function); CPU ranks are forked."""
    import torch.multiprocessing as mp

    cuda = torch.device("cuda" if device is None else device).type == "cuda"
    mp.start_processes(_rank_main, nprocs=world_size, join=True,
                       start_method="spawn" if cuda else "fork",
                       args=(fn, world_size, free_port(), device, args))
