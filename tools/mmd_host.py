#!/usr/bin/env python3
"""Host time of the MMD pair's wrappers on one GPU.

    python3 tools/mmd_host.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout; give an
unpacked older commit to compare) and, with the device idle before each
call (``torch.cuda.synchronize()`` outside the timed region), times on the
host clock, median of 300 calls each:

* ``mmd_cross_sum`` and ``mmd_cross_grads`` called on one graph of 8,192
  nodes (7,800 live, C = 3), the form every version takes;
* the same on the train step's batch (B = 4), where the version takes a
  batch;
* the MMD term of one train step, forward and backward (``mmd_loss`` with
  the kernels, the gradient to z), graph by graph for the 4 graphs and,
  where the version takes a batch, in one call;
* the host-side pieces of a wrapper call: ``torch.empty`` of one output,
  the current stream through ``torch.cuda.current_stream`` and through the
  raw getter, ``build.load`` of the bound library; where the version takes
  a batch, also the gradient kernel's C entry point alone (its launch
  included) and the wrapper's checks.

Prints one JSON line with the card's name and power limit.  Needs CUDA and
nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
B, N, LIVE, C, SIGMA = 4, 8192, 7800, 3, 1.5


def host_us(fn, reps: int = 300) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return 1e6 * statistics.median(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT))
    ap.add_argument("--label", default="this checkout")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src) / "src"))
    import torch

    if not torch.cuda.is_available():
        print("mmd_host.py needs a GPU", file=sys.stderr)
        return 2
    from repro_torch.core.mmd import mmd_loss
    from repro_torch.kernels import build, mmd_rbf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((B, N, 3), generator=gen, device=dev)
    nm = torch.zeros((B, N), device=dev)
    nm[:, :LIVE] = 1.0
    z = 0.5 + 0.05 * torch.randn((B, C, 3), generator=gen, device=dev)
    g = torch.ones((B,), device=dev)
    batched = hasattr(mmd_rbf, "schedule")  # the batch form came with it
    out = {"label": args.label, "batched_wrappers": batched}
    with torch.no_grad():
        out["sum_one_graph_us"] = host_us(lambda: mmd_rbf.mmd_cross_sum(
            x[0], z[0], nm[0], sigma=SIGMA))
        out["grads_one_graph_us"] = host_us(lambda: mmd_rbf.mmd_cross_grads(
            x[0], z[0], nm[0], g[0], sigma=SIGMA))
        if batched:
            out["sum_batch_us"] = host_us(lambda: mmd_rbf.mmd_cross_sum(
                x, z, nm, sigma=SIGMA))
            out["grads_batch_us"] = host_us(lambda: mmd_rbf.mmd_cross_grads(
                x, z, nm, g, sigma=SIGMA))
    zg = z.clone().requires_grad_(True)
    loss = lambda zz, xx, mm: mmd_loss(zz, xx, mm, sigma=SIGMA,
                                       use_kernel=True)
    out["objective_per_slot_us"] = host_us(lambda: torch.autograd.grad(
        sum(loss(zg[b], x[b], nm[b]) for b in range(B)), zg))
    if batched:
        out["objective_batch_us"] = host_us(lambda: torch.autograd.grad(
            loss(zg, x, nm).sum(), zg))
    bind = mmd_rbf._bind
    if batched:  # the C call alone (launch included), and the checks
        lib = build.load("mmd_rbf", bind)
        dx, dz = torch.empty_like(x), torch.empty_like(z)
        stream = build.stream_ptr(dev)
        threads, ctas = mmd_rbf.schedule(N)
        ptrs = [t.data_ptr() for t in (x, z, nm, g, dx, dz)]
        out["grads_launch_only_us"] = host_us(
            lambda: lib.mmd_cross_grads_launch(
                *ptrs, B, N, C, -0.5 / (SIGMA * SIGMA), threads, ctas,
                stream))
        out["grads_checks_us"] = host_us(
            lambda: mmd_rbf._batched(x, z, nm, g))
    out["parts_us"] = {
        "torch_empty": host_us(lambda: torch.empty((B,), device=dev)),
        "current_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw_stream_getter": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(0)),
        "build_load": host_us(lambda: build.load("mmd_rbf", bind)),
    }
    out["gpu"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
