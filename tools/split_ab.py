#!/usr/bin/env python3
"""A/B of the TF32 operand split of the FastEGNN kernels on one GPU.

    python3 tools/split_ab.py [--rounds 2]      # from the repository root

Builds the four FastEGNN kernels (edge and virtual, forward and backward)
four ways into ``src/repro_torch/_build/split_ab/<variant>/``, the
variants differing only in ``split_tf32`` of ``csrc/tf32.cuh``, which
splits every operand of the 3xTF32 products into a TF32 high part and a
TF32 low part:

* ``split`` -- as committed: hi rounded to nearest (half an ulp added to
  the bits, low 13 bits cleared), lo = a - hi with its low 13 bits cleared;
* ``add``   -- both parts rounded so (the card's NaN, 0x7fffffff, carries
  over into -0 in both, so a NaN operand multiplies as 0);
* ``cvt``   -- both parts rounded by ``cvt.rna.tf32.f32``, low bits cleared;
* ``mask``  -- both parts cut (low 13 bits cleared: every product a little
  too small).

Then runs ``chip_smoke.kernel_rows`` at its serving shapes with each
variant's libraries in turn, in the order mask, add, cvt, split, split,
cvt, add, mask (``--rounds`` times), and prints one JSON line per run with
each kernel's device time per call (``torch.profiler``), CUDA-event time
and error against the plain version, then each variant's medians, its
worst error, whether every run stayed within the tolerance, and its
ptxas register lines.  The lines also go to ``chiprun_out/split_ab.jsonl``.
Needs CUDA and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCES = ("edge_message", "virtual_message", "edge_message_bwd",
           "virtual_message_bwd")
KERNELS = ("edge_pathway_fused", "virtual_pathway_fused",
           "edge_pathway_bwd_fused", "virtual_pathway_bwd_fused")
BODIES = {
    "split": None,  # the committed body
    "add": "  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;\n"
           "  lo = (__float_as_uint(a - __uint_as_float(hi)) + 0x1000u) &\n"
           "       0xffffe000u;",
    "cvt": "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(a));\n"
           "  hi &= 0xffffe000u;\n"
           "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo)\n"
           "      : \"f\"(a - __uint_as_float(hi)));\n"
           "  lo &= 0xffffe000u;",
    "mask": "  hi = __float_as_uint(a) & 0xffffe000u;\n"
            "  lo = __float_as_uint(a - __uint_as_float(hi)) & 0xffffe000u;",
}
ORDER = ("mask", "add", "cvt", "split", "split", "cvt", "add", "mask")


def variant_header(src: str, body) -> str:
    """tf32.cuh with ``split_tf32``'s body replaced by ``body``."""
    if body is None:
        return src
    pat = re.compile(r"(void split_tf32\(float a, uint32_t& hi,\s*"
                     r"uint32_t& lo\) \{\n)(.*?)(\n\})", re.S)
    out, n = pat.subn(lambda m: m.group(1) + body + m.group(3), src)
    if n != 1:
        raise RuntimeError("split_tf32 not found in tf32.cuh")
    return out


def build_variants(build) -> tuple[dict, dict]:
    """{variant: {source: .so path}} and {variant: ptxas register lines},
    one nvcc per library, all started together."""
    procs, paths = [], {}
    header = (build.CSRC_DIR / "tf32.cuh").read_text()
    for var, body in BODIES.items():
        d = build.BUILD_DIR / "split_ab" / var
        d.mkdir(parents=True, exist_ok=True)
        for h in build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "tf32.cuh").write_text(variant_header(header, body))
        for name in SOURCES:
            shutil.copy(build.CSRC_DIR / f"{name}.cu", d / f"{name}.cu")
            so = d / f"{name}.so"
            paths.setdefault(var, {})[name] = so
            procs.append((var, name, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so),
                 str(d / f"{name}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    ptxas: dict = {}
    for var, name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {var}/{name}:\n{log}")
        ptxas.setdefault(var, {})[name] = [
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]
    return paths, ptxas


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("split_ab.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, edge_message, virtual_message
    from repro_torch.pipeline import build_pipeline

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sink = (out_dir / "split_ab.jsonl").open("w")

    def emit(obj):
        line = json.dumps(obj)
        print(line, flush=True)
        sink.write(line + "\n")

    emit({"gpu": cs.gpu_line()})
    paths, ptxas = build_variants(build)
    binds = {"edge_message": edge_message._bind,
             "virtual_message": virtual_message._bind,
             "edge_message_bwd": edge_message._bind_bwd,
             "virtual_message_bwd": virtual_message._bind_bwd}
    libs = {}
    for var, so in paths.items():
        for name, path in so.items():
            lib = ctypes.CDLL(str(path))
            binds[name](lib)
            libs[var, name] = lib
    dev = torch.device("cuda")
    pipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                          generator=torch.Generator().manual_seed(0))
    scene = cs.make_scenes(1, cs.N_PARTICLES)[0]
    runs: dict = {}
    for rnd in range(args.rounds):
        for var in ORDER:
            for name in SOURCES:  # the wrappers now call this variant
                build._LIBS[name] = libs[var, name]
            _, rows = cs.kernel_rows(pipe, scene, dev)
            got = {r["name"]: {k: r.get(k) for k in (
                "device_ms", "ms", "max_abs_err", "max_rel_err",
                "within_tol", "bitwise_repeatable")}
                for r in rows if r["name"] in KERNELS}
            runs.setdefault(var, []).append(got)
            emit({"round": rnd, "variant": var, "kernels": got})

    def med(v, k, key):  # over the runs the profiler read
        got = [r[k][key] for r in runs[v] if isinstance(r[k][key], float)]
        return statistics.median(got) if got else "not measured"

    emit({"medians": {v: {k: {"device_ms": med(v, k, "device_ms"),
                              "ms": med(v, k, "ms"),
                              "max_abs_err": max(r[k]["max_abs_err"]
                                                 for r in runs[v]),
                              "within_tol": all(r[k]["within_tol"]
                                                for r in runs[v])}
                          for k in KERNELS} for v in BODIES},
          "ptxas": ptxas})
    sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
