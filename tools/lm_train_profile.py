#!/usr/bin/env python3
"""Where an LM train step's time goes on one GPU.

    python3 tools/lm_train_profile.py [--steps 3]

For each published-width run of ``chip_smoke.py``'s ``lm_train`` phase
(``TRAIN_RUNS``: xlstm-125m at full depth, olmoe-1b-7b at 2 layers,
gemma3-12b at 6 layers with the dense and the 512-token chunked loss;
seed-0 f32 weights built on the card, bf16 compute, Adam lr 1e-4, clip 1):
after one warm step, ``--steps`` steps split into their two parts, each
timed on the host clock around a ``torch.cuda.synchronize()``: the loss
and gradients (``training.lm.value_and_grad``) and the Adam update;
medians.  For olmoe and gemma3 one more step under ``torch.profiler``:
the device time of each part (CUDA kernels' self time between the
part's markers), the idle share of the step, and the kernels by device
time, summed into GEMMs (cuBLAS / CUTLASS kernels) and the rest.
xlstm's step launches ~10^6 small kernels and is not profiled; it is
timed again with ``remat_policy="none"`` (no recompute, no checkpoint
hooks) beside its ``"full"``.  Prints one JSON line a reading and writes
them to ``chiprun_out/lm_train_profile.jsonl``.  Needs CUDA; imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

GEMM_MARKS = ("gemm", "cutlass", "xmma", "nvjet", "cublas")
# the step's two parts, marked with record_function (the profiler shows
# each marker on the device timeline too: not a kernel)
PARTS = ("loss_and_grads", "adam")


def timed(fn):
    """``fn()`` and its host-clock seconds, synchronised on both ends."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def profiled_step(params, state, cfg, opt, batch) -> dict:
    """One step under ``torch.profiler``: device ms of each part, the idle
    share of the step's wall time, and the kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.training.lm import value_and_grad

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        with record_function(PARTS[0]):
            _, _, grads = value_and_grad(params, cfg, batch)
            torch.cuda.synchronize()
        with record_function(PARTS[1]):
            opt.update(grads, state, params)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.key not in PARTS]
    total = sum(dev_us(e) for e in kernels)
    gemm = sum(dev_us(e) for e in kernels
               if any(m in e.key.lower() for m in GEMM_MARKS))
    parts = {}
    events = prof.events()
    for e in events:
        if e.name in PARTS and e.device_type == DeviceType.CPU:
            lo, hi = e.time_range.start, e.time_range.end
            parts[e.name] = sum(
                k.time_range.end - k.time_range.start for k in events
                if k.device_type == DeviceType.CUDA and k.name not in PARTS
                and lo <= k.time_range.start < hi) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:12]
    return {"wall_ms": wall * 1e3,
            "device_ms": total / 1e3 if total else "not measured",
            "idle_share": 1 - total / 1e3 / (wall * 1e3) if total
            else "not measured",
            "gemm_device_ms": gemm / 1e3, "part_device_ms": parts,
            "kernels": {e.key[:60]: {"ms": dev_us(e) / 1e3,
                                     "calls": e.count} for e in top}}


def reading(aid, layers, b, s, chunk, steps, dev, profile_it: bool,
            policy: str | None = None) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.training.lm import value_and_grad
    from repro_torch.training.optim import Adam

    full = get_arch(aid)
    cfg = full if layers is None else cs.family_cut(full, layers)
    cfg = dataclasses.replace(cfg, loss_chunk=chunk)
    if policy is not None:
        cfg = dataclasses.replace(cfg, remat_policy=policy)
    batch = (cs.example_stream(cfg, b, s, 1) if aid == "xlstm_125m"
             else cs.train_inputs(cfg, b, s, 1))
    batch = {k: v.to(dev) for k, v in batch.items()}
    params = cs.lm_f32_weights(cfg, 0, dev)
    opt = Adam(lr=cs.TRAIN_LR, grad_clip=cs.TRAIN_CLIP)
    state = opt.init(params)
    vg_s, up_s = [], []
    for i in range(steps + 1):
        (_, _, grads), t_vg = timed(lambda: value_and_grad(params, cfg,
                                                           batch))
        (params, state), t_up = timed(lambda: opt.update(grads, state,
                                                         params))
        del grads
        if i:  # the first step warms up
            vg_s.append(t_vg)
            up_s.append(t_up)
    out = {"arch": full.name, "layers": cfg.n_layers, "batch": b, "seq": s,
           "loss_chunk": chunk, "remat_policy": cfg.remat_policy,
           "steps": steps,
           "loss_and_grads_ms": 1e3 * statistics.median(vg_s),
           "adam_ms": 1e3 * statistics.median(up_s)}
    if profile_it:
        out["profile"] = profiled_step(params, state, cfg, opt, batch)
    del params, state
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("lm_train_profile.py needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    lines = [{"gpu": cs.gpu_line(), "torch": torch.__version__}]
    print(json.dumps(lines[0]), flush=True)
    for aid, layers, b, s, chunks in cs.TRAIN_RUNS:
        policies = ("full", "none") if aid == "xlstm_125m" else (None,)
        for chunk in chunks:
            for policy in policies:
                lines.append(reading(aid, layers, b, s, chunk, args.steps,
                                     dev, aid != "xlstm_125m", policy))
                print(json.dumps(lines[-1]), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "lm_train_profile.jsonl", "w") as f:
        for line in lines:
            f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
