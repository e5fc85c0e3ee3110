#!/usr/bin/env python3
"""A/B of the identity-gate forward of several source trees on one GPU.

    python3 tools/idn_fwd_ab.py TREE_A TREE_B [TREE_C ...]

Each tree is a checkout of the repository (e.g. ``git archive`` of another
commit, or a copy with one constant of ``csrc/edge_identity.cu`` changed,
under the gitignored ``_tree/``).  For the trees in the order A B .. B A,
a process of its own imports that tree's ``chip_smoke`` and package
(building its kernels into its own ``_build``) and runs the identity
forward on the serve Verlet list (N = 8,192) in SchNet's form (Dh = H1)
and RF's (Dh = 1, inv1p) at widths 64 and 32, in f32 and bf16: each
call's device time split by kernel (``torch.profiler``) and its
CUDA-event time.  It prints a JSON line a run, then each tree's medians
and which outputs differ from the first run's by a bit; the lines also
go to ``chiprun_out/idn_fwd_ab.jsonl``.  Every run's outputs must be
within ``chip_smoke.py``'s tolerances of the first run's (f32: ATOL /
RTOL elementwise; bf16: BF_L2 relative L2 per output); it exits 1 if
not.  Needs CUDA and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

CHILD = r"""
import json, sys
tree, out_path = sys.argv[1], sys.argv[2]
sys.path[:0] = [tree + "/src", tree]
import torch
import chip_smoke as cs
from repro_torch.kernels import edge_message as em
dev = torch.device("cuda")
scene = cs.make_scenes(1, cs.N_PARTICLES)[0]
x, snd, _rcv, emask, nm, indptr, n_edges = cs.serving_graph(
    scene[0], cs.NODE_CAP, cs.R + cs.SKIN, cs.R, dev)
n = x.shape[0]
out, saved = {}, {}
with torch.no_grad():
    for w in (64, 32):
        for form, dh, rel in (("idn", w, "raw"), ("idn_rf", 1, "inv1p")):
            gen = torch.Generator(device=dev).manual_seed(w + dh)
            ws = cs._width_weights(gen, dh, w, 1, dev)
            ws[6:] = [torch.zeros(1, 1, device=dev)] * 3
            h = (torch.randn((n, dh), generator=gen, device=dev) if dh > 1
                 else torch.zeros(n, 1, device=dev))
            for prec in ("f32", "bf16"):
                kw = dict(gate_mode="identity", rel_mode=rel, clamp=100.0,
                          precision=prec)
                fn = lambda: em.edge_pathway_fused(x, h, snd, emask, indptr,
                                                   *ws, **kw)
                key = f"{prec}/{w}/{form}_fwd"
                saved[key] = [t.cpu() for t in fn()]
                dev_f = cs.device_fields(fn)
                out[key] = {"device_ms": dev_f["device_ms"],
                            "kernels_us": dev_f["kernels_us"],
                            "ms": cs.cuda_ms(fn, 15, 3)}
torch.save(saved, out_path)
print(json.dumps({"tree": tree, "gpu": cs.gpu_line(), "kernels": out}))
"""


def main() -> int:
    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [str(Path(t).resolve()) for t in sys.argv[1:]]
    order = trees + trees[::-1]
    out_dir = ROOT / "chiprun_out"
    work = out_dir / "idn_fwd_ab_outputs"  # removed before the script ends
    work.mkdir(parents=True, exist_ok=True)
    runs, paths = [], []
    try:
        with open(out_dir / "idn_fwd_ab.jsonl", "w") as log:
            for k, tree in enumerate(order):
                paths.append(work / f"run{k}.pt")
                proc = subprocess.run(
                    [sys.executable, "-c", CHILD, tree, str(paths[-1])],
                    capture_output=True, text=True, cwd=tree)
                if proc.returncode != 0:
                    print(proc.stderr[-4000:], file=sys.stderr)
                    return 1
                line = proc.stdout.strip().splitlines()[-1]
                runs.append(json.loads(line))
                print(line, flush=True)
                log.write(line + "\n")
            import torch

            sys.path.insert(0, str(ROOT))
            import chip_smoke as cs

            first = torch.load(paths[0])
            differ, outside = set(), set()
            for p in paths[1:]:
                for key, ts in torch.load(p).items():
                    pairs = list(zip(ts, first[key]))
                    if not all(torch.equal(a, b) for a, b in pairs):
                        differ.add(key)
                    ok = all(bool((a - b).abs().le(
                        cs.ATOL + cs.RTOL * b.abs()).all())
                        if key.startswith("f32/")
                        else cs.rel_l2(a, b) <= cs.BF_L2 for a, b in pairs)
                    if not ok:
                        outside.add(key)
            medians = {}
            for tree in trees:
                mine = [r["kernels"] for r in runs if r["tree"] == tree]
                med = {}
                for key in mine[0]:
                    med[key] = {f: statistics.median(m[key][f] for m in mine)
                                for f in ("device_ms", "ms")
                                if all(isinstance(m[key][f], float)
                                       for m in mine)}
                    names = {n for m in mine for n in m[key]["kernels_us"]}
                    med[key]["kernels_us"] = {
                        n: statistics.median(m[key]["kernels_us"][n]
                                             for m in mine
                                             if n in m[key]["kernels_us"])
                        for n in names}
                medians[tree] = med
            line = json.dumps({"medians": medians,
                               "outputs_bitwise_equal": not differ,
                               "differ": sorted(differ),
                               "outside_tolerance": sorted(outside)})
            print(line)
            log.write(line + "\n")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0 if not outside else 1


if __name__ == "__main__":
    sys.exit(main())
