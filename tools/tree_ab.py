#!/usr/bin/env python3
"""A/B of the FastEGNN kernels of two source trees on one GPU.

    python3 tools/tree_ab.py OLD_TREE [NEW_TREE]     # NEW_TREE: this one

Each tree is a checkout of the repository (e.g. ``git archive`` of another
commit unpacked under the gitignored ``_tree/``).  For each tree in the
order OLD NEW NEW OLD, a process of its own imports that tree's
``chip_smoke`` and runs its ``kernel_rows`` (the kernels phase's readings
at the serving shapes: N = 8,192 on the serve Verlet list, hidden 64),
building the tree's kernels into its own ``_build``; it prints one JSON
line per run with each kernel's device time per call (``torch.profiler``)
and CUDA-event time, then each tree's medians.  The lines also go to
``chiprun_out/tree_ab.jsonl``.  Needs CUDA and nvcc; imports nothing of
JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys
tree = sys.argv[1]
sys.path[:0] = [tree + "/src", tree]
import torch
import chip_smoke as cs
from repro_torch.pipeline import build_pipeline
dev = torch.device("cuda")
pipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                      generator=torch.Generator().manual_seed(0))
scene = cs.make_scenes(1, cs.N_PARTICLES)[0]
_, rows = cs.kernel_rows(pipe, scene, dev)
out = {}
for r in rows:
    out[r["name"]] = {"device_ms": r.get("device_ms"), "ms": r.get("ms")}
    if "rf_form" in r:
        out[r["name"] + "/rf"] = {"device_ms": r["rf_form"].get("device_ms"),
                                  "ms": r["rf_form"].get("ms")}
print(json.dumps({"tree": tree, "gpu": cs.gpu_line(), "kernels": out}))
"""


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    old = str(Path(sys.argv[1]).resolve())
    new = str(Path(sys.argv[2]).resolve()) if len(sys.argv) == 3 else str(ROOT)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    runs = []
    with open(out_dir / "tree_ab.jsonl", "w") as log:
        for tree in (old, new, new, old):
            proc = subprocess.run([sys.executable, "-c", CHILD, tree],
                                  capture_output=True, text=True, cwd=tree)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return 1
            line = proc.stdout.strip().splitlines()[-1]
            runs.append(json.loads(line))
            print(line, flush=True)
            log.write(line + "\n")
        medians = {}
        for tree in (old, new):
            mine = [r["kernels"] for r in runs if r["tree"] == tree]
            medians[tree] = {
                k: {f: statistics.median(m[k][f] for m in mine)
                    for f in ("device_ms", "ms")
                    if all(isinstance(m[k][f], float) for m in mine)}
                for k in mine[0]}
        line = json.dumps({"medians": medians})
        print(line)
        log.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
