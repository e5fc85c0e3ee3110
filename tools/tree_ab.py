#!/usr/bin/env python3
"""A/B of the FastEGNN kernels of two source trees on one GPU.

    python3 tools/tree_ab.py OLD_TREE [NEW_TREE]     # NEW_TREE: this one

Each tree is a checkout of the repository (e.g. ``git archive`` of another
commit unpacked under the gitignored ``_tree/``).  For each tree in the
order OLD NEW NEW OLD, a process of its own imports that tree's
``chip_smoke`` and runs its ``kernel_rows`` (the kernels phase's readings
at the serving shapes: N = 8,192 on the serve Verlet list, hidden 64),
building the tree's kernels into its own ``_build``; then #1-#4 once more
in f32 and in bf16 at widths 64 and 32 on the same Verlet list (gate
'mlp'; inputs from seeds), and the identity pair in SchNet's form (Dh =
H1) and RF's (Dh = 1, inv1p; the backward also at 226, the FP32-unit
route), with each call's device time (``torch.profiler``, split by
kernel) and CUDA-event time.  It prints a JSON line a run, then each tree's
medians, and the lines also go to ``chiprun_out/tree_ab.jsonl``.  The f32
outputs must be bitwise equal in every run of a tree, and across the
trees those of #1-#4 and of the identity backward; the identity
forward's f32 outputs at 64 and 32 (its tile route, which a tree may
redesign) are held across the trees to the f32 forward tolerances of
``chip_smoke.py`` (ATOL / RTOL), and ``identity_fwd_bitwise`` says
whether they were bitwise equal too.  The bf16 outputs' largest
difference from the first run is printed.  The script exits 1 if an f32
check fails.  Needs CUDA and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
WIDTHS = (64, 32)
WIDE = 226  # the identity backward's width on the FP32-unit route

CHILD = r"""
import json, sys
tree, out_path = sys.argv[1], sys.argv[2]
sys.path[:0] = [tree + "/src", tree]
import torch
import chip_smoke as cs
from repro_torch.kernels import edge_message as em, virtual_message as vm
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
x, snd, _rcv, emask, nm, indptr, n_edges = cs.serving_graph(
    scene[0], cs.NODE_CAP, cs.R + cs.SKIN, cs.R, dev)
sender, _, _ = cs._graph_operands(x, snd, emask, indptr, n_edges, dev)
n, c = x.shape[0], 3
saved = {}
with torch.no_grad():
    for w in WIDTHS:
        gen = torch.Generator(device=dev).manual_seed(w)
        r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)
        ws = cs._width_weights(gen, w, w, w, dev)
        h, g_dx, g_mh = r(n, w), r(n, 3), r(n, w)
        va = [x, h, x[:c] + 0.05 * r(c, 3), nm,
              r(c, w, w, sc=w ** -0.5), r(c, w, sc=0.3), r(c, w, sc=0.3),
              r(c, w, w, sc=w ** -0.5), r(c, w, sc=0.1),
              r(c, w, w, sc=w ** -0.5), r(c, w, sc=0.1),
              r(c, w, 1, sc=w ** -0.5), r(c, w, w, sc=w ** -0.5),
              r(c, w, sc=0.1), r(c, w, 1, sc=w ** -0.5)]
        cots = (r(n, 3), r(n, w), r(c, 3), r(c, w))
        for prec in ("f32", "bf16"):
            kw = dict(gate_mode="mlp", rel_mode="raw", clamp=100.0,
                      precision=prec)
            fwd = lambda: em.edge_pathway_fused(x, h, snd, emask, indptr,
                                                *ws, **kw)
            deg = fwd()[2].contiguous()
            calls = {
                "edge_fwd": fwd,
                "edge_bwd": lambda: em.edge_pathway_bwd_fused(
                    x, h, snd, emask, indptr, *sender, *ws, deg, g_dx,
                    g_mh, **kw),
                "virtual_fwd": lambda: vm.virtual_pathway_fused(
                    *va, precision=prec),
                "virtual_bwd": lambda: vm.virtual_pathway_bwd_fused(
                    *va, *cots, precision=prec)}
            # the identity pair: SchNet's form (Dh = H1 = w, raw) and RF's
            # (Dh = 1, a zero feature column, inv1p)
            for form, dh, rel in (("idn", w, "raw"), ("idn_rf", 1, "inv1p")):
                iws = cs._width_weights(gen, dh, w, 1, dev)
                iws[6:] = [torch.zeros(1, 1, device=dev)] * 3
                ih = h[:, :dh] if dh == w else torch.zeros(n, 1, device=dev)
                ikw = dict(gate_mode="identity", rel_mode=rel, clamp=100.0,
                           precision=prec)
                ifwd = lambda ih=ih, iws=iws, ikw=ikw: em.edge_pathway_fused(
                    x, ih, snd, emask, indptr, *iws, **ikw)
                ideg = ifwd()[2].contiguous()
                g_m1 = g_mh[:, :1].contiguous()
                calls[f"{form}_fwd"] = ifwd
                calls[f"{form}_bwd"] = (
                    lambda ih=ih, iws=iws, ikw=ikw, ideg=ideg, g_m1=g_m1:
                    em.edge_pathway_bwd_fused(x, ih, snd, emask, indptr,
                                              *sender, *iws, ideg, g_dx,
                                              g_m1, **ikw))
            for name, fn in calls.items():
                key = f"{prec}/{w}/{name}"
                saved[key] = [t.cpu() for t in fn()]
                dev_f = cs.device_fields(fn)
                out[key] = {"device_ms": dev_f["device_ms"],
                            "kernels_us": dev_f["kernels_us"],
                            "ms": cs.cuda_ms(fn, 5, 1)}
    # the identity backward at the widest width the reference admits at
    # this N (226: the FP32-unit route, which bf16 keeps above 64)
    w = WIDE
    gen = torch.Generator(device=dev).manual_seed(w)
    iws = cs._width_weights(gen, w, w, 1, dev)
    iws[6:] = [torch.zeros(1, 1, device=dev)] * 3
    ih = torch.randn((n, w), generator=gen, device=dev)
    g_dx = torch.randn((n, 3), generator=gen, device=dev)
    g_m1 = torch.randn((n, 1), generator=gen, device=dev)
    for prec in ("f32", "bf16"):
        ikw = dict(gate_mode="identity", rel_mode="raw", clamp=100.0,
                   precision=prec)
        ideg = em.edge_pathway_fused(x, ih, snd, emask, indptr, *iws,
                                     **ikw)[2].contiguous()
        fn = lambda: em.edge_pathway_bwd_fused(
            x, ih, snd, emask, indptr, *sender, *iws, ideg, g_dx, g_m1, **ikw)
        key = f"{prec}/{w}/idn_bwd"
        saved[key] = [t.cpu() for t in fn()]
        dev_f = cs.device_fields(fn)
        out[key] = {"device_ms": dev_f["device_ms"],
                    "kernels_us": dev_f["kernels_us"],
                    "ms": cs.cuda_ms(fn, 2, 1)}
torch.save(saved, out_path)
print(json.dumps({"tree": tree, "gpu": cs.gpu_line(), "kernels": out}))
""".replace("WIDTHS", repr(WIDTHS)).replace("WIDE", repr(WIDE))


def tile_identity_fwd(key: str) -> bool:
    """An f32 output of the identity forward's tile route (widths 64,
    32)."""
    prec, width, name = key.split("/")
    return (prec == "f32" and width in ("64", "32") and name.startswith("idn")
            and name.endswith("_fwd"))


def within_f32_tolerance(got, want) -> bool:
    """Forward outputs ``got`` within chip_smoke.py's f32 tolerances of
    ``want``, elementwise."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    return all(bool((a - b).abs().le(cs.ATOL + cs.RTOL * b.abs()).all())
               for a, b in zip(got, want) if b.numel())


def compare_outputs(paths: list[Path]) -> dict:
    """The runs' outputs (OLD NEW NEW OLD): f32 bitwise equal within each
    tree, and across the trees but for the identity forward's tile route,
    which must be within the f32 tolerances; the bf16 outputs' largest
    absolute difference from the first run."""
    import torch

    runs = [torch.load(p) for p in paths]
    out = {"f32_bitwise_equal": True, "f32_within_tolerance": True,
           "identity_fwd_bitwise": True, "bf16_max_abs_diff": {}}
    for k, ref in ((3, 0), (2, 1), (1, 0)):  # old, new, across
        for key, ts in runs[ref].items():
            pairs = list(zip(runs[k][key], ts))
            if key.startswith("f32/") and k == 1 and tile_identity_fwd(key):
                if not all(torch.equal(a, b) for a, b in pairs):
                    out["identity_fwd_bitwise"] = False
                if not within_f32_tolerance(runs[k][key], ts):
                    out["f32_within_tolerance"] = False
                    out.setdefault("f32_outside", []).append(key)
            elif key.startswith("f32/"):
                if not all(torch.equal(a, b) for a, b in pairs):
                    out["f32_bitwise_equal"] = False
                    out.setdefault("f32_differs", []).append(
                        f"{paths[k].name}:{key}")
            else:
                d = max(float((a - b).abs().max()) if a.numel() else 0.0
                        for a, b in pairs)
                prev = out["bf16_max_abs_diff"].get(key, 0.0)
                out["bf16_max_abs_diff"][key] = max(prev, d)
    return out


def main() -> int:
    if len(sys.argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    old = str(Path(sys.argv[1]).resolve())
    new = str(Path(sys.argv[2]).resolve()) if len(sys.argv) == 3 else str(ROOT)
    out_dir = ROOT / "chiprun_out"
    work = out_dir / "tree_ab_outputs"  # removed before the script ends
    work.mkdir(parents=True, exist_ok=True)
    runs, paths = [], []
    try:
        with open(out_dir / "tree_ab.jsonl", "w") as log:
            for k, tree in enumerate((old, new, new, old)):
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
            medians = {}
            for tree in (old, new):
                mine = [r["kernels"] for r in runs if r["tree"] == tree]
                medians[tree] = {
                    k: {f: statistics.median(m[k][f] for m in mine)
                        for f in ("device_ms", "ms")
                        if all(isinstance(m[k][f], float) for m in mine)}
                    for k in mine[0]}
            outputs = compare_outputs(paths)
            line = json.dumps({"medians": medians, "outputs": outputs})
            print(line)
            log.write(line + "\n")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0 if (outputs["f32_bitwise_equal"]
                 and outputs["f32_within_tolerance"]) else 1


if __name__ == "__main__":
    sys.exit(main())
