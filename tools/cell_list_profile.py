#!/usr/bin/env python3
"""Time and profile the device Verlet build on one GPU.

    python3 tools/cell_list_profile.py [--variant NAME=PATH] [--rounds 2]

Runs ``data/cell_list.py``'s ``device_radius_build`` + ``device_csr`` (and
each ``--variant``: another file defining the same two functions, e.g. an
earlier version, loaded as a module) at three shapes:

* ``serve``: the serve phase's four 7,800-particle fluid scenes in
  8,192-node slots, ``r + skin`` = 0.045, 262,144 edge slots, at
  ``cell_cap`` 13 (the scenes' own occupancy with headroom) and 148 (what
  random weights drove it to in ``chip_smoke.py``'s serve run);
* ``fluid113k``: one 113,000-particle scene in 131,072 slots at r = 0.035,
  ``cell_cap`` 13.

For each shape, in the order A B .. B A (``--rounds`` times): CUDA-event
time (median of 5 after a warm-up), peak device memory above what was
allocated before, whether the outputs equal the first variant's bitwise,
and once per variant the ops by device time from ``torch.profiler``.
Prints one JSON line per reading, then the medians, and writes the lines
to ``chiprun_out/cell_list_profile.jsonl``.  Needs CUDA; imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
R, SKIN, EDGES_PER_NODE = 0.035, 0.01, 32


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def load_variant(name: str, path: str):
    spec = importlib.util.spec_from_file_location(f"cell_list_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shapes(dev):
    import numpy as np
    import torch

    from repro_torch.data.fluid import generate_fluid_dataset, simulate_fluid
    from repro_torch.data.radius_graph import pad_nodes

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    scenes = generate_fluid_dataset(4, n_particles=7800, seed=0)
    xs, nms = zip(*(pad_nodes(s.x0.astype(np.float32), 8192) for s in scenes))
    serve = (t(np.stack(xs)), t(np.stack(nms)), R + SKIN, 8192)
    big, _ = simulate_fluid(np.random.default_rng(0), 113_000, 1)
    xb, nb = pad_nodes(big[0].astype(np.float32), 131_072)
    fluid = (t(xb), t(nb), R, 131_072)
    return [("serve_cap13", serve, 13), ("serve_cap148", serve, 148),
            ("fluid113k_cap13", fluid, 13)]


def top_ops(fn, k: int = 12) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(10_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and "spin" not in e.key]
    ev.sort(key=dev_us, reverse=True)
    return {"device_ms": sum(dev_us(e) for e in ev) / 1e3,
            "kernels": sum(e.count for e in ev),
            "top_us": {e.key[:60]: round(dev_us(e), 1) for e in ev[:k]}}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    from repro_torch.data import cell_list

    dev = torch.device("cuda")
    variants = [("committed", cell_list)]
    for spec in args.variant:
        name, path = spec.split("=", 1)
        variants.append((name, load_variant(name, path)))
    order = variants + variants[::-1]
    lines = [{"gpu": gpu_line(), "torch": torch.__version__}]
    print(json.dumps(lines[0]), flush=True)
    for label, (x, nm, r_build, n_nodes), cap in shapes(dev):
        kw = dict(r_build=r_build, edge_cap=n_nodes * EDGES_PER_NODE,
                  cell_cap=cap)
        ref = None
        times: dict = {}
        profiled = set()
        for rnd in range(args.rounds):
            for name, mod in order:
                def build(mod=mod):
                    db = mod.device_radius_build(x, nm, **kw)
                    return db, mod.device_csr(db.receivers, db.edge_mask,
                                              n_nodes)

                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                out = build()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                flat = [*out[0], *out[1]]
                if ref is None:
                    ref = flat
                same = all(torch.equal(a, b) for a, b in zip(flat, ref))
                del out, flat
                ts = []
                for i in range(6):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    build()
                    b.record()
                    torch.cuda.synchronize()
                    if i:
                        ts.append(a.elapsed_time(b))
                ms = statistics.median(ts)
                times.setdefault(name, []).append(ms)
                line = {"shape": label, "variant": name, "round": rnd,
                        "cell_cap": cap, "candidates": int(x.numel() // 3
                                                           * 27 * cap),
                        "ms": ms, "peak_bytes": peak,
                        "equal_to_first": same}
                if name not in profiled:
                    profiled.add(name)
                    line["profile"] = top_ops(build)
                print(json.dumps(line), flush=True)
                lines.append(line)
        med = {k: statistics.median(v) for k, v in times.items()}
        summary = {"shape": label, "median_ms": med}
        print(json.dumps(summary), flush=True)
        lines.append(summary)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "cell_list_profile.jsonl").write_text(
        "".join(json.dumps(ln) + "\n" for ln in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
