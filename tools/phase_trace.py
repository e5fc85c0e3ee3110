#!/usr/bin/env python3
"""Per-phase clock trace of the FastEGNN edge and virtual kernels, forward
and backward, on one GPU.

    python3 tools/phase_trace.py                 # from the repository root
    python3 tools/phase_trace.py --bf16 [--width 32]
    python3 tools/phase_trace.py --bf16 --tree _tree/old   # another tree

Builds instrumented copies of ``csrc/edge_message.cu``,
``csrc/virtual_message.cu``, ``csrc/edge_message_bwd.cu`` and
``csrc/virtual_message_bwd.cu`` into ``src/repro_torch/_build/trace/``:
after every ``__syncthreads()`` of the main kernel (``edge_fwd_edges``,
``virtual_fwd_kernel``, ``edge_bwd_edges``, ``virtual_bwd_kernel``; not
those inside ``common.cuh``), thread 0 of CTA 0 records the source line
and ``clock64()``.  Runs the kernels through ``chip_smoke.phase_kernels`` at
its serving shapes (the last call's trace is kept) and prints, for each
sync point, how often CTA 0 passed it and the mean clocks since the
previous one.  ``--bf16`` traces the bf16 kernels instead
(``edge_fwd_edges<W, true>``, ``edge_bwd_edges<W, true>``, the identity
backward's dh pass ``idn_bwd_dh<W>``, ``virtual_fwd_kernel<W, true>`` and
``virtual_bwd_kernel<W, true>``): one bf16 call each of the edge forward
and backward (gate 'mlp'), the identity backward (SchNet's form, Dh =
H1) and the virtual forward and backward (C = 3), at width ``--width``
(64) on the serving scene's Verlet list (N = 8,192), and prints the
registers and spills ``ptxas`` reports for the five sources.
``--identity-fwd`` traces the identity forward's tile pass
(``idn_fwd_tiles``) instead: one call in SchNet's form (Dh = H1 =
``--width``) on the same list, f32 (bf16 with ``--bf16``).  Trace points
also follow the kernel's ``__syncwarp()`` and ``async_wait_all()``;
``--thread N`` records thread N of CTA 0 (0 by default).  ``--tree DIR``
traces the sources of another checkout (e.g. a ``git archive`` of an
earlier commit under the gitignored ``_tree/``), through that tree's own
package.  The
clocks include the work of any other CTA on the same SM.  Needs CUDA and
nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNELS = {"edge_message": "edge_fwd_edges",
           "virtual_message": "virtual_fwd_kernel",
           "edge_message_bwd": "edge_bwd_edges",
           "virtual_message_bwd": "virtual_bwd_kernel",
           "edge_identity": "idn_bwd_dh"}
# the sources --bf16 traces (else the four FastEGNN kernels of f32)
BF16_SOURCES = ("edge_message", "edge_message_bwd", "edge_identity",
                "virtual_message", "virtual_message_bwd")
SLOTS = 1024


def instrument(src: str, kernel: str, thread: int = 0) -> str:
    """``src`` with a trace point after each ``__syncthreads()`` (and
    ``__syncwarp()`` and ``async_wait_all()``) of ``kernel``, recorded by
    thread ``thread`` of CTA 0, and a C entry point ``get_trace`` that
    copies it out."""
    lines = src.split("\n")
    start = next(i for i, ln in enumerate(lines) if ln.startswith(kernel + "("))
    stop = next(i for i, ln in enumerate(lines) if i > start
                and ln.startswith("}"))
    body = next(i for i in range(start, stop) if lines[i].endswith(") {"))
    out = []
    for i, ln in enumerate(lines):
        for sync in ("__syncthreads();", "__syncwarp();",
                     "async_wait_all();"):
            if start < i < stop and sync in ln:
                ln = ln.replace(sync, f"{sync} trace_point({i + 1});")
        out.append(ln)
        if ln.startswith('#include "common.cuh"'):
            out.append(f"__device__ long long g_trace[{2 * SLOTS}];")
        if i == body:  # the kernel's first line
            out.append(
                "  int n_trace = 0;\n"
                "  auto trace_point = [&](int line) {\n"
                f"    if (threadIdx.x == {thread} && blockIdx.x == 0 &&\n"
                f"        n_trace < {SLOTS}) {{\n"
                "      g_trace[2 * n_trace] = line;\n"
                "      g_trace[2 * n_trace + 1] = clock64();\n"
                "      ++n_trace;\n"
                "    }\n"
                "  };")
    out.append('extern "C" int get_trace(long long* o) { return (int)'
               f"cudaMemcpyFromSymbol(o, g_trace, {16 * SLOTS}); }}")
    return "\n".join(out)


def report(name: str, lib: ctypes.CDLL) -> None:
    buf = (ctypes.c_longlong * (2 * SLOTS))()
    lib.get_trace.argtypes = [ctypes.c_void_p]
    err = lib.get_trace(ctypes.addressof(buf))
    if err:
        raise RuntimeError(f"{name}: get_trace failed with CUDA error {err}")
    events = [(buf[2 * k], buf[2 * k + 1]) for k in range(SLOTS)
              if buf[2 * k + 1]]
    if len(events) < 2:
        raise RuntimeError(f"{name}: no trace recorded")
    gaps: dict[int, list[int]] = {}
    for (_, t0), (line, t1) in zip(events, events[1:]):
        gaps.setdefault(line, []).append(t1 - t0)
    print(f"{name}: {len(events)} trace points, "
          f"{events[-1][1] - events[0][1]} clocks from first to last")
    for line, g in sorted(gaps.items()):
        print(f"  line {line:4d}: passed {len(g):3d} times, "
              f"mean {sum(g) / len(g):9.0f} clocks since the previous point")


def run_bf16(cs, width: int, dev) -> None:
    """One bf16 call each of the edge forward and backward, the identity
    backward (SchNet's form) and the virtual forward and backward at
    ``width`` on the serving scene's Verlet list."""
    import torch

    from repro_torch.kernels import edge_message as em_mod
    from repro_torch.kernels import virtual_message as vm

    scene = cs.make_scenes(1, cs.N_PARTICLES)[0]
    x, snd, _rcv, em, nm, indptr, n_edges = cs.serving_graph(
        scene[0], cs.NODE_CAP, cs.R + cs.SKIN, cs.R, dev)
    sender, _, _ = cs._graph_operands(x, snd, em, indptr, n_edges, dev)
    gen = torch.Generator(device=dev).manual_seed(width)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)
    n, c = x.shape[0], 3
    h = r(n, width)
    with torch.no_grad():
        for gate, m in (("mlp", width), ("identity", 1)):
            ws = cs._width_weights(gen, width, width, m, dev)
            if gate == "identity":
                ws[6:] = [torch.zeros(1, 1, device=dev)] * 3
            kw = dict(gate_mode=gate, rel_mode="raw", clamp=100.0,
                      precision="bf16")
            _, _, deg = em_mod.edge_pathway_fused(x, h, snd, em, indptr,
                                                  *ws, **kw)
            em_mod.edge_pathway_bwd_fused(
                x, h, snd, em, indptr, *sender, *ws, deg.contiguous(),
                r(n, 3), r(n, m), **kw)
        sw = width ** -0.5
        w = width
        va = (x, h, x[:c] + 0.05 * r(c, 3), nm, r(c, w, w, sc=sw),
              r(c, w, sc=0.3), r(c, w, sc=0.3),
              r(c, w, w, sc=sw), r(c, w, sc=0.1), r(c, w, w, sc=sw),
              r(c, w, sc=0.1), r(c, w, 1, sc=sw), r(c, w, w, sc=sw),
              r(c, w, sc=0.1), r(c, w, 1, sc=sw))
        vm.virtual_pathway_fused(*va, precision="bf16")
        vm.virtual_pathway_bwd_fused(*va, r(n, 3), r(n, w), r(c, 3),
                                     r(c, w), precision="bf16")


def run_identity_fwd(cs, width: int, precision: str, dev) -> None:
    """One identity forward in SchNet's form (Dh = H1 = ``width``) on
    the serving scene's Verlet list."""
    import torch

    from repro_torch.kernels import edge_message as em_mod

    scene = cs.make_scenes(1, cs.N_PARTICLES)[0]
    x, snd, _rcv, em, nm, indptr, n_edges = cs.serving_graph(
        scene[0], cs.NODE_CAP, cs.R + cs.SKIN, cs.R, dev)
    gen = torch.Generator(device=dev).manual_seed(width)
    ws = cs._width_weights(gen, width, width, 1, dev)
    ws[6:] = [torch.zeros(1, 1, device=dev)] * 3
    h = torch.randn((x.shape[0], width), generator=gen, device=dev)
    with torch.no_grad():
        em_mod.edge_pathway_fused(x, h, snd, em, indptr, *ws,
                                  gate_mode="identity", rel_mode="raw",
                                  clamp=100.0, precision=precision)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf16", action="store_true",
                    help="trace the kernels on bf16 tiles")
    ap.add_argument("--width", type=int, default=64, choices=(32, 64))
    ap.add_argument("--identity-fwd", action="store_true",
                    help="trace the identity forward's tile pass")
    ap.add_argument("--thread", type=int, default=0,
                    help="the thread of CTA 0 whose clocks are recorded")
    ap.add_argument("--tree", default=str(ROOT),
                    help="the checkout whose sources and package to trace")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    if not torch.cuda.is_available():
        print("phase_trace.py needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, edge_message, virtual_message
    from repro_torch.pipeline import build_pipeline

    print(cs.gpu_line(), flush=True)
    print(f"tree {tree}" + (f", bf16, width {args.width}" if args.bf16
                            else ""), flush=True)
    out_dir = build.BUILD_DIR / "trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    binds = {"edge_message": edge_message._bind,
             "virtual_message": virtual_message._bind,
             "edge_message_bwd": edge_message._bind_bwd,
             "virtual_message_bwd": virtual_message._bind_bwd,
             "edge_identity": edge_message._bind_identity}
    kernels = dict(KERNELS)
    if args.identity_fwd:
        kernels["edge_identity"] = "idn_fwd_tiles"
    names = (("edge_identity",) if args.identity_fwd else
             BF16_SOURCES if args.bf16 else tuple(KERNELS)[:4])
    libs = {}
    for name in names:
        text = (build.CSRC_DIR / f"{name}.cu").read_text()
        if f"\n{kernels[name]}(" not in text:  # an older tree's source
            print(f"  {name}: no {kernels[name]} in this tree", flush=True)
            continue
        src = out_dir / f"{name}.cu"
        src.write_text(instrument(text, kernels[name], args.thread))
        so = out_dir / f"{name}.so"
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                               str(build.CSRC_DIR), "-o", str(so), str(src)],
                              check=True, capture_output=True, text=True)
        if args.bf16 or args.identity_fwd:  # ptxas: registers, spills
            for ln in proc.stderr.splitlines():
                if "Compiling entry" in ln or "registers" in ln or (
                        "spill" in ln and " 0 bytes spill" not in ln):
                    print(f"  ptxas {name}: {ln.strip()}")
        libs[name] = ctypes.CDLL(str(so))
        binds[name](libs[name])
        build._LIBS[name] = libs[name]  # the wrappers now call the copies
    dev = torch.device("cuda")
    if args.identity_fwd:
        run_identity_fwd(cs, args.width, "bf16" if args.bf16 else "f32", dev)
    elif args.bf16:
        run_bf16(cs, args.width, dev)
    else:
        pipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                              generator=torch.Generator().manual_seed(0))
        cs.phase_kernels(pipe, cs.make_scenes(cs.MAX_BATCH, cs.N_PARTICLES),
                         dev)
    torch.cuda.synchronize()
    for name, lib in libs.items():
        report(name, lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
