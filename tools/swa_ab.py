#!/usr/bin/env python3
"""A/B of versions of the f32 sliding-window attention kernel on one GPU.

    python3 tools/swa_ab.py [--variant NAME=PATH ...] [--rounds 2]

Builds ``src/repro_torch/csrc/swa_attention.cu`` (variant ``committed``)
and each ``--variant`` source (a file with the same C entry point, e.g. an
older commit's copy from ``git show <rev>:src/repro_torch/csrc/
swa_attention.cu``; the entry has taken T, D_v and the strides of v and o
since the kernel learned MLA's widths and cross-attention, so a copy from
before that needs its entry point brought up to the committed one's
signature) into ``src/repro_torch/_build/swa_ab/<name>/``, one
nvcc each, all started together.  Then, at ``chip_smoke.py``'s prefill
shape (B = 1, S = 8,192, 16 heads over 8 KV heads, D = 256, f32), for the
sliding-window layer (window 1,024) and the global (causal) layer, runs
each variant through ``kernels.swa_attention.attention`` in the order
A B .. B A (``--rounds`` times) and prints one JSON line per run: device
time a call (``torch.profiler``), CUDA-event time (median of 10), and the
error against the plain version; then each variant's medians and its
ptxas register / spill lines.  The lines also go to
``chiprun_out/swa_ab.jsonl``.  Needs CUDA and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def build_variants(build, sources: dict) -> tuple[dict, dict]:
    """{name: .so path} and {name: ptxas register / spill lines}."""
    procs = []
    for name, src in sources.items():
        d = build.BUILD_DIR / "swa_ab" / name
        d.mkdir(parents=True, exist_ok=True)
        for h in build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        shutil.copy(src, d / "swa_attention.cu")
        so = d / "swa_attention.so"
        procs.append((name, so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
             str(d / "swa_attention.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    paths, ptxas = {}, {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        paths[name] = so
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
    return paths, ptxas


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("swa_ab.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, swa_attention

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sink = (out_dir / "swa_ab.jsonl").open("w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        sink.write(line + "\n")

    emit({"gpu": cs.gpu_line()})
    sources = {"committed": build.CSRC_DIR / "swa_attention.cu"}
    for v in args.variant:
        name, path = v.split("=", 1)
        sources[name] = Path(path).resolve()
    paths, ptxas = build_variants(build, sources)
    libs = {}
    for name, so in paths.items():
        libs[name] = ctypes.CDLL(str(so))
        swa_attention._bind(libs[name], "swa_attention_launch")

    b, s, h, kv, d = 1, cs.PREFILL_S, 16, 8, 256
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device="cuda")
               for n in (h, kv, kv))
    pos = torch.arange(s, device="cuda")
    layers = {"swa": 1024, "global": None}
    with torch.no_grad():
        want = {name: swa_attention.chunked_attention(
            q, k, v, pos, pos, causal=True, window=w)
            for name, w in layers.items()}
    names = list(paths)
    order = (names + names[::-1]) * args.rounds
    runs: dict = {n: {lay: [] for lay in layers} for n in names}
    for name in order:
        build._LIBS["swa_attention"] = libs[name]  # the wrapper calls it
        for lay, window in layers.items():
            run = lambda w=window: swa_attention.attention(
                q, k, v, causal=True, window=w)
            with torch.no_grad():
                cmp = cs._attention_close(run(), want[lay])
                dev = cs.device_fields(run)
                ms = cs.cuda_ms(run, 10, 2)
            if isinstance(dev["device_ms"], float):
                runs[name][lay].append(dev["device_ms"])
            emit({"variant": name, "layer": lay, "ms": ms,
                  "device_ms": dev["device_ms"], **cmp})
    for name in names:
        emit({"variant": name, "ptxas": ptxas[name],
              **{f"device_ms_{lay}_median": statistics.median(t)
                 for lay, t in runs[name].items() if t}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
