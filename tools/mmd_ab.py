#!/usr/bin/env python3
"""A/B of the MMD pair's cross-CTA sum and schedule on one GPU.

    python3 tools/mmd_ab.py [--rounds 2]        # from the repository root

Builds ``csrc/mmd_rbf.cu`` three ways into ``src/repro_torch/_build/mmd_ab/``:

* ``cluster`` -- as committed: one thread-block cluster per graph, CTA
  rank 0 adds the other CTAs' sums from their shared memory in rank order;
* ``cluster_fast_exp`` -- the same with ``__expf`` (``ex2.approx``) in
  place of ``expf``;
* ``last_cta`` -- no cluster: each CTA writes its sums to a global array,
  takes a ticket (an integer atomic per graph, after a ``__threadfence``),
  and the CTA that takes the last ticket adds the sums in rank order and
  resets the ticket.  It may use any number of CTAs a graph.

and times both kernels (#5 cross sum, #6 cross gradient) of each at the
train step's shape (B = 4, N = 8,192, 7,800 live each) and the Fluid113K
one (B = 1, N = 131,072, 113,000 live), for several ``(threads, ctas)``
schedules, in the order A B .. B A (``--rounds`` times): device time per
launch from ``torch.profiler`` and CUDA-event time per launch over a run
of back-to-back launches, with the error against the plain version.
Prints one JSON line per reading, then the medians per variant, schedule
and shape, and each build's ptxas lines; the lines also go to
``chiprun_out/mmd_ab.jsonl``.  Needs CUDA and nvcc; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SHAPES = {"train": (4, 8192, 7800), "fluid113k": (1, 131072, 113000)}
# (threads, ctas) per shape and variant; the committed schedule first
SCHEDULES = {
    "cluster": {"train": [(256, 16), (512, 8), (1024, 2), (128, 16),
                          (256, 8), (512, 16)],
                "fluid113k": [(1024, 16), (512, 16), (1024, 8)]},
    "cluster_fast_exp": {"train": [(256, 16)], "fluid113k": [(1024, 16)]},
    "last_cta": {"train": [(256, 16), (256, 32), (128, 64)],
                 "fluid113k": [(1024, 16), (1024, 32), (256, 128),
                               (512, 128)]},
}
SIGMA, C = 1.5, 3

# the last-CTA variant's global state and its two kernels' ends, which
# replace the cluster sum from the first ``cluster.sync()`` on
TICKET_DECL = """constexpr unsigned FULL = 0xffffffffu;
__device__ unsigned g_ticket[65535];  // one per graph, reset by its last CTA
__device__ float g_part[1 << 20];     // [graph][cta][3C] CTA sums
"""
SUM_TAIL = """  __shared__ bool is_last;
  if (threadIdx.x == 0) {
    g_part[(size_t)b * gridDim.x + blockIdx.x] = cta_sum;
    __threadfence();
    is_last = atomicAdd(&g_ticket[b], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (is_last && warp == 0) {
    __threadfence();
    float s = 0.0f;
    for (int r0 = 0; r0 < (int)gridDim.x; r0 += 32) {
      const int r = r0 + lane;
      s += lane_order_sum(
          r < (int)gridDim.x ? __ldcg(&g_part[(size_t)b * gridDim.x + r])
                             : 0.0f, min(32, (int)gridDim.x - r0));
    }
    if (lane == 0) {
      out[b] = s;
      g_ticket[b] = 0;
    }
  }
}
"""
GRAD_TAIL = """  __shared__ bool is_last;
  __syncthreads();
  for (int f = threadIdx.x; f < width; f += blockDim.x)
    g_part[((size_t)b * gridDim.x + blockIdx.x) * width + f] = part[f];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&g_ticket[b], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int f = warp; f < width; f += warps) {
    float s = 0.0f;
    for (int r0 = 0; r0 < (int)gridDim.x; r0 += 32) {
      const int r = r0 + lane;
      s += lane_order_sum(
          r < (int)gridDim.x
              ? __ldcg(&g_part[((size_t)b * gridDim.x + r) * width + f])
              : 0.0f, min(32, (int)gridDim.x - r0));
    }
    if (lane == 0) dz[(size_t)b * width + f] = inv_s2 * s;
  }
  if (threadIdx.x == 0) g_ticket[b] = 0;
}
"""


def last_cta_source(src: str) -> str:
    """The committed source with the cluster sum replaced by tickets."""
    def cut(text, start, end, new):
        i = text.index(start)
        j = text.index(end, i) + len(end)
        return text[:i] + new + text[j:]

    end = "// the other CTAs keep their shared memory until read\n}\n"
    src = src.replace("constexpr unsigned FULL = 0xffffffffu;\n", TICKET_DECL)
    src = src.replace("  cg::cluster_group cluster = cg::this_cluster();\n",
                      "")
    src = cut(src, "  cluster.sync();\n  if (blockIdx.x == 0 && warp == 0)",
              end, SUM_TAIL)
    src = cut(src, "  cluster.sync();\n  if (blockIdx.x == 0) {", end,
              GRAD_TAIL)
    src = src.replace("constexpr int MAX_CTAS = 16;",
                      "constexpr int MAX_CTAS = 65535;")
    src = src.replace("if (ctas > 8) {", "if (false) {")
    src = src.replace("cfg.numAttrs = 1;", "cfg.numAttrs = 0;")
    if "cluster." in src:
        raise RuntimeError("the cluster sum is still in the last-CTA source")
    return src


def fast_exp_source(src: str) -> str:
    """The committed source with ``__expf`` (ex2.approx) for ``expf``."""
    out, n = re.subn(r"(?<![\w])expf\(", "__expf(", src)
    if n != 2:
        raise RuntimeError(f"expected 2 expf calls, found {n}")
    return out


VARIANTS = {"cluster": lambda src: src, "cluster_fast_exp": fast_exp_source,
            "last_cta": last_cta_source}


def build(build_mod) -> tuple[dict, dict]:
    """{variant: ctypes.CDLL} and {variant: ptxas lines}; the nvcc's
    started together."""
    from repro_torch.kernels import mmd_rbf

    out_dir = build_mod.BUILD_DIR / "mmd_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build_mod.CSRC_DIR / "mmd_rbf.cu").read_text()
    procs = {}
    for var, make in VARIANTS.items():
        text = make(src)
        cu = out_dir / f"{var}.cu"
        cu.write_text(text)
        so = out_dir / f"{var}.so"
        cmd = [build_mod.nvcc_path(), *build_mod.NVCC_FLAGS,
               f"-I{build_mod.CSRC_DIR}", "-o", str(so), str(cu)]
        procs[var] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      so)
    libs, ptxas = {}, {}
    for var, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {var}:\n{log}")
        ptxas[var] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln]
        lib = ctypes.CDLL(str(so))
        mmd_rbf._bind(lib)
        libs[var] = lib
    return libs, ptxas


def inputs(shape: str, dev):
    import numpy as np
    import torch

    b, n, live = SHAPES[shape]
    rng = np.random.default_rng(b * n)
    x = rng.uniform(0.0, 1.0, (b, n, 3)).astype(np.float32)
    x[:, live:] = 0.0
    mask = np.zeros((b, n), np.float32)
    mask[:, :live] = 1.0
    z = (0.5 + 0.1 * rng.standard_normal((b, C, 3))).astype(np.float32)
    g = np.ones((b,), np.float32)
    return [torch.from_numpy(a).to(dev) for a in (x, z, mask, g)]


def reading(lib, sched, args, want, dev) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import build as build_mod

    x, z, mask, g = args
    b, n = mask.shape
    out = torch.empty((b,), device=dev)
    dx, dz = torch.empty_like(x), torch.empty_like(z)
    stream = build_mod.stream_ptr(dev)
    neg_inv_2s2 = -0.5 / (SIGMA * SIGMA)
    calls = {
        "sum": lambda: lib.mmd_cross_sum_launch(
            x.data_ptr(), z.data_ptr(), mask.data_ptr(), out.data_ptr(), b,
            n, C, neg_inv_2s2, *sched, stream),
        "grad": lambda: lib.mmd_cross_grads_launch(
            x.data_ptr(), z.data_ptr(), mask.data_ptr(), g.data_ptr(),
            dx.data_ptr(), dz.data_ptr(), b, n, C, neg_inv_2s2, *sched, stream),
    }
    row = {}
    for name, call in calls.items():
        err = call()
        torch.cuda.synchronize()
        if err:
            row[name] = {"error": lib.cuda_error_string(err).decode()}
            continue
        got = (out,) if name == "sum" else (dx, dz)
        ref = want[name]
        rel = max(float((a - r).abs().max() / r.abs().max().clamp(min=1e-30))
                  for a, r in zip(got, ref))
        again = [t.clone() for t in got]
        call()
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, t) for a, t in zip(again, got))
        for _ in range(5):
            call()
        reps = 200
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            call()
        e1.record()
        torch.cuda.synchronize()
        events_us = 1e3 * e0.elapsed_time(e1) / reps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(10_000)
            torch.cuda.synchronize()
            for _ in range(20):
                call()
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and "mmd_" in e.key]
        dev_us = lambda e: getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0.0))
        count = sum(e.count for e in kern)
        row[name] = {"device_us": (sum(dev_us(e) for e in kern) / count
                                   if count else "not measured"),
                     "kernels_seen": count, "events_us": events_us,
                     "max_rel_err": rel, "bitwise_repeatable": repeat}
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("mmd_ab.py needs a GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import build as build_mod
    from repro_torch.kernels import mmd_rbf

    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    libs, ptxas = build(build_mod)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log = open(out_dir / "mmd_ab.jsonl", "a")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        log.write(line + "\n")

    emit({"gpu": gpu, "ptxas": ptxas})
    data = {s: inputs(s, dev) for s in SHAPES}
    want = {}
    for s, (x, z, mask, g) in data.items():
        want[s] = {"sum": (mmd_rbf.mmd_cross_sum_plain(x, z, mask,
                                                       sigma=SIGMA),),
                   "grad": mmd_rbf.mmd_cross_grads_plain(x, z, mask, g,
                                                         sigma=SIGMA)}
    runs = [(v, s, sched) for s in SHAPES for v in SCHEDULES
            for sched in SCHEDULES[v][s]]
    seen: dict = {}
    for _ in range(args.rounds):
        for v, s, sched in runs + runs[::-1]:
            row = reading(libs[v], sched, data[s], want[s], dev)
            emit({"variant": v, "shape": s, "threads_ctas": sched, **row})
            for k, r in row.items():
                if "device_us" in r:
                    seen.setdefault((v, s, sched, k), []).append(r)
    for (v, s, sched, k), rs in seen.items():
        med = lambda key: statistics.median(
            r[key] for r in rs if not isinstance(r[key], str)) if any(
                not isinstance(r[key], str) for r in rs) else "not measured"
        emit({"median": {"variant": v, "shape": s, "threads_ctas": sched,
                         "kernel": k, "device_us": med("device_us"),
                         "events_us": med("events_us"),
                         "max_rel_err": max(r["max_rel_err"] for r in rs),
                         "repeatable": all(r["bitwise_repeatable"]
                                           for r in rs)}})
    emit({"committed_schedule": {s: mmd_rbf.schedule(SHAPES[s][1])
                                 for s in SHAPES}, "gpu": gpu})
    return 0


if __name__ == "__main__":
    sys.exit(main())
