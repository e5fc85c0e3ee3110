#!/usr/bin/env python3
"""A/B of the serve phases (f32 and bf16) over two source trees on one GPU.

    python3 tools/serve_ab.py OLD_TREE [NEW_TREE]    # NEW_TREE: this one

Each tree is a checkout of the repository (e.g. ``git archive`` of another
commit unpacked under the gitignored ``_tree/``).  For each tree in the
order OLD NEW NEW OLD, a process of its own puts that tree's ``src`` first
on the path and runs this tree's ``chip_smoke.phase_serve`` and
``phase_serve_bf16`` (four 7,800-particle scenes, 20 steps through
``RolloutService`` with device rebuilds, the same weights from a seed),
so the two packages run the same phases.  It prints one JSON line per run
(p50 latency, mean step, rebuilds, rebuild time, ``cell_cap``, both
precisions) and each tree's medians; the lines also go to
``chiprun_out/serve_ab.jsonl``.  Needs CUDA and nvcc; imports nothing of
JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("latency_p50_s", "mean_step_s", "rebuilds", "rebuild_mean_s",
        "cell_cap")

CHILD = r"""
import json, sys
tree, here = sys.argv[1], sys.argv[2]
sys.path[:0] = [tree + "/src", here]
import torch
import chip_smoke as cs
from repro_torch.pipeline import build_pipeline
dev = torch.device("cuda")
scenes = cs.make_scenes(cs.MAX_BATCH, cs.N_PARTICLES)
pipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                      generator=torch.Generator().manual_seed(0))
plain = build_pipeline("fast_egnn", device=dev, params=pipe.params)
f32 = cs.phase_serve(pipe, plain, scenes, dev)
bf16 = cs.phase_serve_bf16(pipe, scenes, f32, dev)
keys = KEYS
print(json.dumps({"tree": tree, "gpu": cs.gpu_line(),
                  "f32": {k: f32[k] for k in keys},
                  "bf16": {k: bf16[k] for k in keys}}))
""".replace("KEYS", repr(KEYS))


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    old = str(Path(sys.argv[1]).resolve())
    new = str(Path(sys.argv[2]).resolve()) if len(sys.argv) == 3 else str(ROOT)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    runs = []
    with open(out_dir / "serve_ab.jsonl", "w") as log:
        for tree in (old, new, new, old):
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, tree, str(ROOT)],
                capture_output=True, text=True, cwd=tree)
            if proc.returncode != 0:
                print(proc.stderr[-4000:], file=sys.stderr)
                return 1
            line = proc.stdout.strip().splitlines()[-1]
            runs.append(json.loads(line))
            print(line, flush=True)
            log.write(line + "\n")
        medians = {t: {p: {k: statistics.median(r[p][k] for r in runs
                                                if r["tree"] == t)
                           for k in KEYS} for p in ("f32", "bf16")}
                   for t in (old, new)}
        line = json.dumps({"medians": medians})
        print(line)
        log.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
