#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each printing one JSON line (any failure exits nonzero):

1. build   — nvcc builds every CUDA kernel of the serving and training
             paths from ``src/repro_torch/csrc`` (one nvcc per source, in
             parallel).
2. kernels — each of the six kernels (edge and virtual forward, edge and
             virtual backward, MMD cross sum and gradient) against its
             plain PyTorch version on the card at the serving shapes
             (N = 8,192 nodes, 8,192 x 32 edge slots of a fluid scene
             built at r + skin, hidden 64, C = 3), with CUDA-event times of
             kernel and plain version and a bitwise repeat check.
3. serve   — a full-width FastEGNN (random weights from a seed) behind
             ``RolloutService`` with max_batch 4: four 7,800-particle
             fluid scenes, 20 steps each.  Checks every frame, the kernel
             launch counts and the first frame against the plain path.
4. scale   — one forward step of a 113,000-particle scene (bucket
             131,072) through ``predict_fn``, timed.
5. train   — a full-width FastEGNN (random weights from seed 0) trained
             with ``use_kernel=True`` through ``Pipeline.fit`` for 2 epochs
             on 6 + 2 fluid scenes of 7,800 particles (batch 4, so the
             second training batch is mask-padded), lam_mmd 0.03 over every
             node.  Checks every loss, the launch counts of every kernel,
             the first step's loss, gradients and update against a
             ``use_kernel=False`` pipeline on the card, and that the same
             first step run twice is bitwise equal; times a train step.

Then it prints the card's name and power limit, the per-kernel summary,
and last ``{"ok": true, "device": {...}}``.  It needs CUDA and a checkout
of the repository around it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# serving configuration: FastEGNN defaults at Water-3D scale
R, SKIN, DT, STEPS, BOX = 0.035, 0.01, 0.005, 20, 1.0
N_PARTICLES, NODE_CAP, EDGES_PER_NODE = 7800, 8192, 32
SCALE_PARTICLES, SCALE_CAP = 113_000, 131_072
MAX_BATCH, LAYERS = 4, 4
# kernel vs plain version, elementwise: |k - p| <= ATOL + RTOL * |p|
# (f32; the two sum in different orders)
ATOL, RTOL = 1e-5, 1e-4
# gradients vs their plain versions, relative to each output's largest
# magnitude: |k - p| <= GATOL * max|p| + GRTOL * |p| (the JAX package's
# own _assert_tree_close)
GATOL, GRTOL = 5e-5, 1e-3
# first served frame vs the plain path after 4 layers (periodic distance)
FRAME_TOL = 1e-4
# training: 6 train + 2 validation scenes, batch 4, 2 epochs
TRAIN_SCENES, VAL_SCENES, TRAIN_BATCH, EPOCHS = 6, 2, 4, 2
LAM_MMD, MMD_SIGMA = 0.03, 1.5
# first-step update compared where |g| >= SMALL_GRAD x the leaf's largest
SMALL_GRAD = 1e-2
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) FLOP/s
HBM_BPS, F32_FLOPS = 3.35e12, 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 15, warm: int = 3) -> float:
    """Median CUDA-event time of ``fn()`` in ms, after ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def compare(got, want) -> dict:
    """Max abs / relative error of kernel outputs against the plain ones,
    and whether every element is inside the stated tolerance."""
    import torch

    err, rel, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        d = (g - w).abs()
        err = max(err, float(d.max()))
        rel = max(rel, float(d.max() / w.abs().max().clamp(min=1e-30)))
        ok &= bool(torch.all(d <= ATOL + RTOL * w.abs()))
    return {"max_abs_err": err, "max_rel_err": rel, "within_tol": ok}


def compare_grads(got, want) -> dict:
    """Gradient outputs against the plain ones, each relative to its own
    largest magnitude (GATOL / GRTOL)."""
    import torch

    err, rel, ok = 0.0, 0.0, True
    for g, w in zip(got, want):
        d = (g - w).abs()
        scale = float(w.abs().max()) + 1e-6
        err = max(err, float(d.max()))
        rel = max(rel, float(d.max()) / scale)
        ok &= bool(torch.all(d <= GATOL * scale + GRTOL * w.abs()))
    return {"max_abs_err": err, "max_rel_err": rel, "within_tol": ok}


def repeat_equal(a, b) -> bool:
    import torch

    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def bound_ms(n_bytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = n_bytes / HBM_BPS, flops / F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ------------------------------------------------------------------ phases
def phase_build() -> dict:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in info["ptxas"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, info in libs.items()}
    return {"phase": "build", "seconds": secs,
            "libraries": {k: {"seconds": v["seconds"], "cached": v["cached"]}
                          for k, v in libs.items()},
            "ptxas": ptxas, "gpu": gpu_line()}


def make_scenes(n_scenes: int, n_particles: int, seed: int = 0) -> list:
    from repro_torch.data.fluid import generate_fluid_dataset

    return [(s.x0, s.v0, s.h) for s in
            generate_fluid_dataset(n_scenes, n_particles=n_particles,
                                   seed=seed)]


def serving_graph(x0, node_cap: int, r_build: float, r_step: float, dev):
    """Padded Verlet list of one scene at ``r_build`` with the step mask
    at ``r_step`` applied (holes where candidates lie outside r)."""
    import numpy as np
    import torch

    from repro_torch.data.radius_graph import (csr_indptr, pad_edges,
                                               pad_nodes, radius_graph,
                                               sort_edges_by_receiver)
    from repro_torch.rollout.engine import _step_edge_masks

    snd, rcv = sort_edges_by_receiver(*radius_graph(x0, r_build))
    sp, rp, em = pad_edges(snd, rcv, node_cap * EDGES_PER_NODE, x0)
    n_edges = int(np.count_nonzero(em))
    indptr = csr_indptr(rp, n_edges, node_cap)
    xp, nm = pad_nodes(x0, node_cap)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    x, sp, rp, em, nm = t(xp), t(sp), t(rp), t(em), t(nm)
    keep = _step_edge_masks(x, sp, rp, em, float(np.float32(r_step) ** 2),
                            0.0).to(torch.float32)
    return x, sp, rp, keep, nm, t(indptr), n_edges


def phase_kernels(pipe, scene, dev) -> tuple[dict, list]:
    import torch

    from repro_torch.core.virtual_nodes import (init_virtual_coords,
                                                masked_com,
                                                virtual_global_message)
    from repro_torch.kernels import edge_message, virtual_message
    from repro_torch.kernels.ops import (unpack_edge_params,
                                         unpack_virtual_block)
    from repro_torch.models.egnn import edge_spec

    x, snd, _rcv, em, nm, indptr, n_edges = serving_graph(
        scene[0], NODE_CAP, R + SKIN, R, dev)
    n, hid, c = NODE_CAP, pipe.cfg.hidden, pipe.cfg.n_virtual
    gen = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((n, hid), generator=gen, device=dev)
    lp = pipe.params["layers"][0]
    spec = edge_spec(pipe.cfg.coord_clamp)
    hk, ws = unpack_edge_params({"phi1": lp["phi1"], "gate": lp["phi_xr"]},
                                h, spec)
    kw = dict(gate_mode=spec.gate, rel_mode=spec.rel,
              clamp=float(spec.coord_clamp))
    e_args = (x, hk, snd, em, indptr, *ws)
    z = init_virtual_coords(x, nm, c) + 0.05 * torch.randn(
        (c, 3), generator=gen, device=dev)
    s = pipe.params["s_init"]
    mv = virtual_global_message(z, masked_com(x, nm))
    w = unpack_virtual_block(lp["virtual"], s, mv, hid)
    v_args = (x, h, z, nm, w["w1h"], w["w1d"], w["const1"], w["w2"], w["b2"],
              w["wg1"], w["bg1"], w["wg2"], w["wz1"], w["bz1"], w["wz2"])

    rows = []
    with torch.no_grad():
        # edge forward
        got = edge_message.edge_pathway_fused(*e_args, **kw)
        again = edge_message.edge_pathway_fused(*e_args, **kw)
        want = edge_message.edge_pathway_plain(*e_args, **kw)
        cmp_e = compare(got, want)
        cmp_e["bitwise_repeatable"] = all(
            torch.equal(a, b) for a, b in zip(got, again))
        live = int((em[:n_edges] != 0).sum())
        e_bytes = (n * (3 + hid) * 4 + n_edges * 8 + (n + 1) * 4
                   + (4 * hid * hid + 5 * hid) * 4 + n * (3 + hid + 1) * 4)
        # the function's own work: h·W1r and h·W1s once per node, then per
        # live edge msg = ·W2 and the gate's ·Wg1 and ·wg2
        e_flops = (n * 2 * (2 * hid * hid)
                   + live * (2 * 2 * hid * hid + 2 * hid))
        b_ms, b_by = bound_ms(e_bytes, e_flops)
        rows.append(dict(
            name="edge_pathway_fused", route="cuda",
            source="src/repro_torch/csrc/edge_message.cu",
            replaces="src/repro/kernels/edge_message.py:396",
            ms=cuda_ms(lambda: edge_message.edge_pathway_fused(*e_args, **kw)),
            plain_ms=cuda_ms(
                lambda: edge_message.edge_pathway_plain(*e_args, **kw), 10, 2),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shapes=dict(n=n, slots=int(snd.shape[0]), n_edges=n_edges,
                        live_edges=live, hidden=hid), **cmp_e))
        # virtual forward
        got = virtual_message.virtual_pathway_fused(*v_args)
        again = virtual_message.virtual_pathway_fused(*v_args)
        want = virtual_message.virtual_pathway_plain(*v_args)
        cmp_v = compare(got, want)
        cmp_v["bitwise_repeatable"] = all(
            torch.equal(a, b) for a, b in zip(got, again))
        v_bytes = (n * (3 + hid + 1) * 4 + c * (4 * hid * hid + 7 * hid + 3) * 4
                   + n * (3 + hid) * 4 + c * (3 + hid) * 4)
        v_flops = n * c * (4 * 2 * hid * hid + 4 * hid)
        b_ms, b_by = bound_ms(v_bytes, v_flops)
        rows.append(dict(
            name="virtual_pathway_fused", route="cuda",
            source="src/repro_torch/csrc/virtual_message.cu",
            replaces="src/repro/kernels/virtual_message.py:91",
            ms=cuda_ms(lambda: virtual_message.virtual_pathway_fused(*v_args)),
            plain_ms=cuda_ms(
                lambda: virtual_message.virtual_pathway_plain(*v_args)),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shapes=dict(n=n, channels=c, hidden=hid), **cmp_v))
        rows += backward_rows(e_args, kw, v_args, nm, n_edges, live, gen, dev)
    line = {"phase": "kernels",
            "tolerance": {"values": {"atol": ATOL, "rtol": RTOL},
                          "grads_relative_to_max": {"atol": GATOL,
                                                    "rtol": GRTOL}},
            "kernels": rows}
    for row in rows:
        if not (row["within_tol"] and row["bitwise_repeatable"]):
            raise AssertionError(f"kernel {row['name']} disagrees with its "
                                 f"plain version: {json.dumps(line)}")
    return line, rows


def backward_rows(e_args, kw, v_args, nm, n_edges, live, gen, dev) -> list:
    """The training kernels (edge and virtual backward, MMD cross sum and
    gradient) against their plain versions on the serving inputs."""
    import torch

    from repro_torch.data.radius_graph import csr_sender_perm
    from repro_torch.kernels import edge_message, mmd_rbf, virtual_message

    x, _h, snd = e_args[0], e_args[1], e_args[2]
    n, hid = x.shape[0], e_args[1].shape[1]
    z = v_args[2]
    c = z.shape[0]
    f4 = 4
    w_edge = (4 * hid * hid + 5 * hid) * f4  # W1r W1s W2 Wg1 + rows
    rows = []
    # edge backward: the sender permutation of the slots [0, n_edges)
    perm, sptr = csr_sender_perm(snd.cpu().numpy(), n_edges, n)
    sperm = torch.zeros_like(snd)
    sperm[:perm.size] = torch.from_numpy(perm).to(dev)
    sptr = torch.from_numpy(sptr).to(dev)
    deg = edge_message.edge_pathway_fused(*e_args, **kw)[2].contiguous()
    g_dx = torch.randn((n, 3), generator=gen, device=dev)
    g_mh = torch.randn((n, hid), generator=gen, device=dev)
    eb = (*e_args[:5], sperm, sptr, *e_args[5:], deg, g_dx, g_mh)
    run = lambda: edge_message.edge_pathway_bwd_fused(*eb, **kw)
    plain = lambda: edge_message.edge_pathway_bwd_plain(*e_args, g_dx, g_mh,
                                                        **kw)
    got, again = run(), run()
    cmp = compare_grads(got, plain())
    cmp["bitwise_repeatable"] = repeat_equal(got, again)
    # reads x, h, the live slots' snd/em/sperm, indptr, sptr, weights, deg
    # and both cotangents once; writes gx, gh and the weight grads
    e_bytes = (n * (3 + hid) * f4 + 3 * n_edges * f4 + 2 * (n + 1) * f4
               + w_edge + n * (1 + 3 + hid) * f4 + n * (3 + hid) * f4
               + w_edge)
    # six 64x64 products per live edge (.W2 and .Wg1 recomputed, the
    # cotangents through Wg1^T and W2^T, the W2 and Wg1 outer products) and
    # six per node (h.W1r, h.W1s, G.W1r^T, S.W1s^T, the W1r / W1s outer
    # products over the per-node sums of g_pre1)
    e_flops = (live + n) * 6 * 2 * hid * hid
    b_ms, b_by = bound_ms(e_bytes, e_flops)
    rows.append(dict(
        name="edge_pathway_bwd_fused", route="cuda",
        source="src/repro_torch/csrc/edge_message_bwd.cu",
        replaces="src/repro/kernels/edge_message.py:661",
        ms=cuda_ms(run), plain_ms=cuda_ms(plain, 10, 2), bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shapes=dict(n=n, slots=int(snd.shape[0]), n_edges=n_edges,
                    live_edges=live, hidden=hid), **cmp))
    # virtual backward
    cots = (torch.randn((n, 3), generator=gen, device=dev),
            torch.randn((n, hid), generator=gen, device=dev),
            torch.randn((c, 3), generator=gen, device=dev),
            torch.randn((c, hid), generator=gen, device=dev))
    run = lambda: virtual_message.virtual_pathway_bwd_fused(*v_args, *cots)
    plain = lambda: virtual_message.virtual_pathway_bwd_plain(*v_args, *cots)
    got, again = run(), run()
    cmp = compare_grads(got, plain())
    cmp["bitwise_repeatable"] = repeat_equal(got, again)
    w_virt = c * (4 * hid * hid + 7 * hid) * f4
    v_bytes = (n * (3 + hid + 1) * f4 + c * 3 * f4 + w_virt
               + n * (3 + hid) * f4 + c * (3 + hid) * f4
               + n * (3 + hid) * f4 + c * 3 * f4 + w_virt)
    # per node and channel eight 64x64 matvecs (four recomputed, four
    # cotangents) and four outer products
    v_flops = n * c * 12 * 2 * hid * hid
    b_ms, b_by = bound_ms(v_bytes, v_flops)
    rows.append(dict(
        name="virtual_pathway_bwd_fused", route="cuda",
        source="src/repro_torch/csrc/virtual_message_bwd.cu",
        replaces="src/repro/kernels/virtual_message.py:234",
        ms=cuda_ms(run), plain_ms=cuda_ms(plain, 10, 2), bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shapes=dict(n=n, channels=c, hidden=hid), **cmp))
    # MMD cross sum and gradient over every node (the train phase's mode)
    xs = x.contiguous()
    run = lambda: mmd_rbf.mmd_cross_sum(xs, z, nm, sigma=MMD_SIGMA)
    plain = lambda: mmd_rbf.mmd_cross_sum_plain(xs, z, nm, sigma=MMD_SIGMA)
    got, again = run(), run()
    cmp = compare([got], [plain()])
    cmp["bitwise_repeatable"] = repeat_equal(got, again)
    m_bytes = n * 16 + c * 12 + 4
    # per node and channel: 3 sub, 3 mul, 2 add, 1 scale, 1 exp, 1 mul,
    # 1 add
    b_ms, b_by = bound_ms(m_bytes, n * c * 12)
    rows.append(dict(
        name="mmd_cross_sum", route="cuda",
        source="src/repro_torch/csrc/mmd_rbf.cu",
        replaces="src/repro/kernels/mmd_rbf.py:46",
        ms=cuda_ms(run), plain_ms=cuda_ms(plain), bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shapes=dict(n=n, channels=c, sigma=MMD_SIGMA), **cmp))
    g = torch.tensor(1.0, device=dev)
    run = lambda: mmd_rbf.mmd_cross_grads(xs, z, nm, g, sigma=MMD_SIGMA)
    plain = lambda: mmd_rbf.mmd_cross_grads_plain(xs, z, nm, g,
                                                  sigma=MMD_SIGMA)
    got, again = run(), run()
    cmp = compare_grads(got, plain())
    cmp["bitwise_repeatable"] = repeat_equal(got, again)
    m_bytes = n * 16 + c * 12 + 4 + n * 12 + c * 12
    # the kernel value as above, then 3 mul-adds into dx and 3 into dz
    b_ms, b_by = bound_ms(m_bytes, n * c * 24)
    rows.append(dict(
        name="mmd_cross_grads", route="cuda",
        source="src/repro_torch/csrc/mmd_rbf.cu",
        replaces="src/repro/kernels/mmd_rbf.py:102",
        ms=cuda_ms(run), plain_ms=cuda_ms(plain), bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        shapes=dict(n=n, channels=c, sigma=MMD_SIGMA), **cmp))
    return rows


def phase_serve(pipe, plain, scenes, dev) -> dict:
    import numpy as np

    from repro_torch.kernels import edge_message, virtual_message
    from repro_torch.rollout import BatchedRolloutEngine
    from repro_torch.serving import RolloutService, ServiceConfig

    cfg = ServiceConfig(max_batch=MAX_BATCH, window_s=1.0, queue_cap=16,
                        edge_cap_per_node=EDGES_PER_NODE)
    submit = dict(r=R, skin=SKIN, dt=DT, wrap_box=BOX)
    with RolloutService(pipe, config=cfg) as warm:  # first-use set-up
        x, v, h = scenes[0]
        warm.submit(x, v, h, 2, **submit).result()

    edge_message.reset_launches()
    virtual_message.reset_launches()
    t0 = time.perf_counter()
    with RolloutService(pipe, config=cfg) as svc:
        handles = [svc.submit(x, v, h, STEPS, **submit) for x, v, h in scenes]
        streams = [[f.copy() for f in hd.frames()] for hd in handles]
    wall = time.perf_counter() - t0
    launches = {"edge_pathway_fused": edge_message.launches,
                "virtual_pathway_fused": virtual_message.launches}
    m = svc.metrics()

    for j, frames in enumerate(streams):
        if len(frames) != STEPS:
            raise AssertionError(f"stream {j}: {len(frames)}/{STEPS} frames")
        if not all(np.isfinite(f).all() for f in frames):
            raise AssertionError(f"stream {j}: non-finite frame")
    want = m["batches"] * LAYERS * MAX_BATCH * STEPS
    for name, got in launches.items():
        if got != want:
            raise AssertionError(f"{name}: {got} launches, expected {want} "
                                 f"({m['batches']} batches x {LAYERS} layers "
                                 f"x {MAX_BATCH} slots x {STEPS} steps)")
    eng = BatchedRolloutEngine(
        plain.predict_fn, batch_size=MAX_BATCH, node_cap=NODE_CAP,
        edge_cap=NODE_CAP * EDGES_PER_NODE, r=R, skin=SKIN, dt=DT,
        wrap_box=BOX, device=dev)
    ref = eng.run(plain.params, scenes, 1).trajectories
    d = max(float(np.max(np.minimum(np.abs(s[0] - t[0]),
                                    BOX - np.abs(s[0] - t[0]))))
            for s, t in zip(streams, ref))
    if not d <= FRAME_TOL:
        raise AssertionError(f"first frame differs from the plain path by "
                             f"{d} > {FRAME_TOL}")
    return {"phase": "serve", "scenes": len(scenes),
            "particles": [int(s[0].shape[0]) for s in scenes],
            "steps": STEPS, "batches": m["batches"],
            "occupancy": m["occupancy_hist"], "launches": launches,
            "launches_expected": want, "first_frame_max_err": d,
            "frame_tol": FRAME_TOL, "latency_p50_s": m["latency_p50_s"],
            "latency_p99_s": m["latency_p99_s"],
            "scenes_per_s": len(scenes) / wall,
            "compute_mean_s": m["compute_mean_s"],
            "mean_step_s": m["compute_mean_s"] / STEPS,
            "rebuilds": m["rebuilds"], "rebuild_mean_s": m["rebuild_mean_s"],
            "wall_s": wall}


def phase_scale(pipe, dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.graph import GeometricGraph
    from repro_torch.data.fluid import simulate_fluid

    t0 = time.perf_counter()
    xs, _ = simulate_fluid(np.random.default_rng(0), SCALE_PARTICLES, 1)
    x0 = xs[0].astype(np.float32)
    x, snd, rcv, em, nm, indptr, n_edges = serving_graph(
        x0, SCALE_CAP, R, R, dev)
    build_s = time.perf_counter() - t0
    n = SCALE_CAP
    g = GeometricGraph(
        x=x[None], v=torch.zeros_like(x)[None],
        h=nm[None, :, None].clone(), senders=snd[None], receivers=rcv[None],
        edge_attr=torch.zeros((1, snd.shape[0], 0), device=dev),
        node_mask=nm[None], edge_mask=em[None])
    lay = (indptr[None], torch.tensor([n_edges], device=dev))
    step = lambda: pipe.predict_fn(pipe.params, g, lay)
    out = step()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        out = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    if tuple(out.shape) != (1, n, 3) or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"scale step gave shape {tuple(out.shape)} or "
                             f"non-finite values")
    return {"phase": "scale", "particles": SCALE_PARTICLES, "node_cap": n,
            "edges": n_edges, "graph_build_s": build_s,
            "step_ms_median": 1e3 * statistics.median(times),
            "step_ms_min": 1e3 * min(times)}


class _GradsOut:
    """An optimizer stand-in whose update returns the gradients, so a
    train step exposes them."""

    def update(self, grads, state, params):
        return grads, state


def _update_close(got, want, grads) -> dict:
    """Parameters after one Adam step, kernel path against plain path, per
    leaf relative to its largest magnitude (GATOL / GRTOL), on the entries
    whose gradient is at least SMALL_GRAD of the gradient tolerance's
    scale (the leaf's largest gradient + 1e-6, as in compare_grads).  The
    step moves an entry by lr·g/(|g| + eps), which carries the gradient's
    own relative error; the gradient tolerance leaves that error unbounded
    for entries far below its scale, so those are counted and left out
    here (every gradient entry is compared before, at GATOL / GRTOL)."""
    from repro_torch.training.optim import tree_leaves

    worst, ok, skipped, total = 0.0, True, 0, 0
    for g, w, gr in zip(tree_leaves(got), tree_leaves(want),
                        tree_leaves(grads)):
        keep = gr.abs() >= SMALL_GRAD * (float(gr.abs().max()) + 1e-6)
        skipped += int((~keep).sum())
        total += keep.numel()
        scale = float(w.abs().max()) + 1e-6
        d = (g - w).abs() * keep
        worst = max(worst, float(d.max()) / scale)
        ok &= bool((d <= GATOL * scale + GRTOL * w.abs()).all())
    return {"max_rel_err": worst, "within_tol": ok,
            "entries_compared": total - skipped, "entries": total}


def profile_step(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its wall time (the
    profiler's own overhead included), the device time summed over
    kernels, the idle share and the kernels that take the most device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    from torch.autograd import DeviceType

    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    # device-side events only: a host op's "self device time" repeats the
    # time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:8]
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy_ms if events else "not measured",
            "idle_share": 1 - busy_ms / wall_ms if events else "not measured",
            "top_kernels_ms": {e.key[:60]: dev_us(e) / 1e3 for e in top}}


def phase_train(dev) -> dict:
    import math

    import torch

    from repro_torch.data.fluid import generate_fluid_dataset
    from repro_torch.kernels import edge_message, mmd_rbf, virtual_message
    from repro_torch.pipeline import build_pipeline
    from repro_torch.models.fast_egnn import fast_egnn_full
    from repro_torch.training.optim import tree_leaves
    from repro_torch.training.trainer import TrainConfig, build_train_step

    t0 = time.perf_counter()
    data = generate_fluid_dataset(TRAIN_SCENES + VAL_SCENES,
                                  n_particles=N_PARTICLES)
    tc = TrainConfig(epochs=EPOCHS, lam_mmd=LAM_MMD, mmd_sigma=MMD_SIGMA,
                     mmd_sample=None)
    pipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                          train_cfg=tc,
                          generator=torch.Generator().manual_seed(0))
    plain = build_pipeline("fast_egnn", device=dev, train_cfg=tc,
                           params=pipe.params)
    tr = pipe.make_batches(data[:TRAIN_SCENES], TRAIN_BATCH, r=R)
    va = pipe.make_batches(data[TRAIN_SCENES:], TRAIN_BATCH, r=R)
    data_s = time.perf_counter() - t0
    if not (len(tr) == 2 and tr[1].sample_mask is not None):
        raise AssertionError("expected a full and a mask-padded train batch")
    # the first step, kernel path twice and plain path once, same weights
    p0 = pipe.params
    k1, _, mk = pipe.train_step(p0, pipe.opt.init(p0), tr[0])
    k2, _, _ = pipe.train_step(p0, pipe.opt.init(p0), tr[0])
    pl, _, mp = plain.train_step(p0, plain.opt.init(p0), tr[0])
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b)
                  for a, b in zip(tree_leaves(k1), tree_leaves(k2)))
    loss_k, loss_p = float(mk["loss"]), float(mp["loss"])
    loss_ok = abs(loss_k - loss_p) <= ATOL + RTOL * abs(loss_p)
    grads = [build_train_step(fast_egnn_full, pp.cfg, tc, _GradsOut())[0](
        p0, None, tr[0])[0] for pp in (pipe, plain)]
    gcmp = compare_grads(tree_leaves(grads[0]), tree_leaves(grads[1]))
    upd = _update_close(k1, pl, grads[1])
    # step time: kernel path and plain path, after the steps above
    step_s = {}
    for name, pp in (("kernel", pipe), ("plain", plain)):
        times = []
        for _ in range(3):
            t = time.perf_counter()
            pp.train_step(p0, pp.opt.init(p0), tr[0])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        step_s[name] = statistics.median(times)
    prof = profile_step(lambda: pipe.train_step(p0, pipe.opt.init(p0), tr[0]))

    for mod in (edge_message, virtual_message, mmd_rbf):
        mod.reset_launches()
    t0 = time.perf_counter()
    res = pipe.fit(tr, va)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {"edge_pathway_fused": edge_message.launches,
                "virtual_pathway_fused": virtual_message.launches,
                "edge_pathway_bwd_fused": edge_message.bwd_launches,
                "virtual_pathway_bwd_fused": virtual_message.bwd_launches,
                "mmd_cross_sum": mmd_rbf.sum_launches,
                "mmd_cross_grads": mmd_rbf.grad_launches}
    steps = EPOCHS * len(tr)
    train_passes = steps * TRAIN_BATCH  # slots, padded ones included
    eval_passes = EPOCHS * len(va) * TRAIN_BATCH
    want = {"edge_pathway_fused": LAYERS * (train_passes + eval_passes),
            "virtual_pathway_fused": LAYERS * (train_passes + eval_passes),
            "edge_pathway_bwd_fused": LAYERS * train_passes,
            "virtual_pathway_bwd_fused": LAYERS * train_passes,
            "mmd_cross_sum": train_passes, "mmd_cross_grads": train_passes}
    losses = [h[k] for h in res.history for k in ("train_loss", "val_mse")]
    out = {"phase": "train", "particles": N_PARTICLES,
           "scenes": {"train": TRAIN_SCENES, "val": VAL_SCENES},
           "batch": TRAIN_BATCH, "epochs": EPOCHS, "steps": steps,
           "lam_mmd": LAM_MMD, "mmd_sample": None,
           "n_edges": [int(b.layout[1].max()) for b in tr],
           "data_s": data_s, "history": res.history,
           "first_step": {"loss_kernel": loss_k, "loss_plain": loss_p,
                          "loss_within_tol": loss_ok, "grads": gcmp,
                          "params": upd,
                          "bitwise_repeatable": bitwise},
           "step_ms_kernel": 1e3 * step_s["kernel"],
           "step_ms_plain": 1e3 * step_s["plain"], "profile_kernel_step": prof,
           "fit_s": fit_s, "launches": launches, "launches_expected": want}
    if not all(math.isfinite(v) for v in losses + [loss_k, loss_p]):
        raise AssertionError(f"non-finite loss: {json.dumps(out)}")
    if launches != want:
        raise AssertionError(f"launch counts differ: {json.dumps(out)}")
    if not (loss_ok and gcmp["within_tol"] and upd["within_tol"]
            and bitwise):
        raise AssertionError(f"first step disagrees: {json.dumps(out)}")
    return out


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke.py: no src/repro_torch beside this script — run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is False — this "
              "smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from repro_torch.pipeline import build_pipeline

    dev = torch.device("cuda")
    emit(phase_build())
    t0 = time.perf_counter()
    scenes = make_scenes(MAX_BATCH, N_PARTICLES)
    pipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                          generator=torch.Generator().manual_seed(0))
    plain = build_pipeline("fast_egnn", device=dev, params=pipe.params)
    emit({"phase": "setup", "scenes_s": time.perf_counter() - t0,
          "cfg": pipe.cfg._asdict()})
    line, rows = phase_kernels(pipe, scenes[0], dev)
    emit(line)
    serve = phase_serve(pipe, plain, scenes, dev)
    emit(serve)
    emit(phase_scale(pipe, dev))
    train = phase_train(dev)
    emit(train)
    for row in rows:  # forward kernels: the serve run; the rest: training
        row["launches"] = serve["launches"].get(row["name"],
                                                train["launches"][row["name"]])
    print(gpu_line(), flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
