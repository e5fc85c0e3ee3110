#!/usr/bin/env python3
"""Which tensors the gloo backend's collectives take, and what they cost.

    python3 tools/collective_probe.py [--world 2] [--device cuda|cpu]

Spawns ``--world`` ranks on one machine (all on ``cuda:0`` with
``--device cuda``), joined over gloo at ``tcp://localhost:<free port>``,
and for operands of 4, 200 and 8,192 floats runs ``all_gather`` (blocking
and ``async_op=True``) and an int64 ``all_reduce(MAX)`` on tensors of the
device, checks each result against the ranks' known inputs, and times a
gather on the device's tensor beside the same gather staged through the
host (copy to the CPU, gather, copy back).  Rank 0 prints one JSON line
with the torch version, whether each collective took the device's
tensors, and the median microseconds of each form.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _time_us(fn, sync, reps: int = 50) -> float:
    for _ in range(5):
        fn()
    sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return 1e6 * statistics.median(ts)


def _rank(rank: int, world: int, port: int, device: str) -> None:
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda:0" if device == "cuda" else "cpu")
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {"torch": torch.__version__, "world": world, "device": str(dev),
           "sizes": {}}
    for n in (4, 200, 8192):
        t = torch.arange(n, dtype=torch.float32, device=dev) + 1000.0 * rank
        row = {}
        try:
            bufs = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(bufs, t)
            ok = all(torch.equal(b.cpu(), torch.arange(n, dtype=torch.float32)
                                 + 1000.0 * r) for r, b in enumerate(bufs))
            work = dist.all_gather(bufs, t * 2, async_op=True)
            work.wait()
            ok &= all(torch.equal(b.cpu(), 2 * (torch.arange(
                n, dtype=torch.float32) + 1000.0 * r))
                for r, b in enumerate(bufs))
            row["all_gather_device_ok"] = bool(ok)
            row["all_gather_device_us"] = _time_us(
                lambda: dist.all_gather(bufs, t), sync)
        except Exception as e:  # reported, not hidden: the probe's answer
            row["all_gather_device_ok"] = False
            row["all_gather_device_error"] = repr(e)[:300]

        hbufs = [torch.empty(n) for _ in range(world)]

        def staged():
            dist.all_gather(hbufs, t.cpu())
            return torch.stack(hbufs).to(dev)

        row["all_gather_staged_us"] = _time_us(staged, sync)
        try:
            m = torch.tensor([rank + 3], dtype=torch.int64, device=dev)
            dist.all_reduce(m, op=dist.ReduceOp.MAX)
            row["all_reduce_max_int_device_ok"] = int(m.item()) == world + 2
        except Exception as e:
            row["all_reduce_max_int_device_ok"] = False
            row["all_reduce_max_int_device_error"] = repr(e)[:300]
        out["sizes"][str(n)] = row
    dist.barrier()
    if rank == 0:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        _rank(args.rank, args.world, args.port, args.device)
        return 0
    import subprocess

    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--world", str(args.world), "--device",
                               args.device, "--rank", str(r), "--port",
                               str(port)]) for r in range(args.world)]
    rcs = [p.wait(timeout=600) for p in procs]
    return max(abs(rc) for rc in rcs)


if __name__ == "__main__":
    sys.exit(main())
