"""The CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel
has no CPU mode).  The file imports neither JAX nor the JAX package, so it
runs on a machine that has only PyTorch; ``tests/conftest.py`` imports
JAX, so run it there as

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: forward values atol 1e-5 / rtol 1e-4 in f32 (kernel and plain
version sum in different orders); gradients relative to each output's
largest magnitude, rtol 1e-3 / atol 5e-5 (the reference's own
``_assert_tree_close``); bf16 attention outputs within one bf16 rounding
of the plain version's.  Repeated kernel runs must be bitwise equal.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.archs import model as lm_model
from repro_torch.configs import get_arch
from repro_torch.core.graph import GeometricGraph
from repro_torch.core.message_passing import EdgeSpec, edge_pathway
from repro_torch.core.virtual_nodes import (VirtualState, init_virtual_block,
                                            virtual_pathway)
from repro_torch.data.radius_graph import (csr_indptr, csr_sender_perm,
                                           pad_edges, pad_nodes, radius_graph,
                                           sort_edges_by_receiver)
from repro_torch.kernels import (edge_message, mmd_rbf, ops, swa_attention,
                                 virtual_message)
from repro_torch.models.fast_egnn import FastEGNNConfig, fast_egnn_apply
from repro_torch.nn.attention import gqa_forward, init_gqa
from repro_torch.pipeline import build_pipeline

ATOL, RTOL = 1e-5, 1e-4
WIDTH = 64
needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _graph(n=300, cap=12000, seed=5, r=0.18):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    snd, rcv = sort_edges_by_receiver(*radius_graph(x, r))
    sp, rp, em = pad_edges(snd, rcv, cap, x)
    em[: snd.size: 5] = 0.0  # mask holes inside the real slots
    return x, sp, rp, em, csr_indptr(rp, snd.size, n), snd.size


def _edge_args(dev, seed=5):
    x, sp, _, em, indptr, _ = _graph(seed=seed)
    rng = np.random.default_rng(seed + 1)
    f = lambda *s: torch.from_numpy(
        (0.2 * rng.standard_normal(s)).astype(np.float32)).to(dev)
    lp = {"phi1": [{"w": f(2 * WIDTH + 1, WIDTH), "b": f(WIDTH)},
                   {"w": f(WIDTH, WIDTH), "b": f(WIDTH)}],
          "gate": [{"w": f(WIDTH, WIDTH), "b": f(WIDTH)}, {"w": f(WIDTH, 1)}]}
    h = f(x.shape[0], WIDTH)
    hk, ws = ops.unpack_edge_params(lp, h, EdgeSpec())
    t = lambda a: torch.from_numpy(a).to(dev)
    return [t(x), hk, t(sp), t(em), t(indptr), *ws]


def _virtual_args(dev, n=1000, c=3, seed=7):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    x = t(rng.uniform(0, 1, (n, 3)))
    h = t(rng.standard_normal((n, WIDTH)))
    mask = t((rng.uniform(size=n) > 0.1) * 1.0)
    z = t(0.5 + 0.2 * rng.standard_normal((c, 3)))
    s = t(0.1 * rng.standard_normal((c, WIDTH)))
    block = init_virtual_block(torch.Generator().manual_seed(seed), c, WIDTH,
                               WIDTH, WIDTH, device=dev)
    w = ops.unpack_virtual_block(block, s, torch.zeros(c, c, device=dev),
                                 WIDTH)
    return [x, h, z, mask] + [w[k] for k in (
        "w1h", "w1d", "const1", "w2", "b2", "wg1", "bg1", "wg2", "wz1", "bz1",
        "wz2")]


def _assert_matches(got, again, want):
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)  # fixed-order sums: bitwise repeatable
        torch.testing.assert_close(g, w, atol=ATOL, rtol=RTOL)


@needs_cuda
@pytest.mark.parametrize("gate,rel,clamp", [
    ("mlp", "raw", math.inf), ("mlp", "raw", 0.05), ("mlp", "inv1p", 0.05),
    ("none", "raw", math.inf)])
def test_edge_kernel_matches_plain(gate, rel, clamp):
    args = _edge_args(torch.device("cuda"))
    kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp)
    edge_message.reset_launches()
    with torch.no_grad():
        got = edge_message.edge_pathway_fused(*args, **kw)
        again = edge_message.edge_pathway_fused(*args, **kw)
        want = edge_message.edge_pathway_plain(*args, **kw)
    torch.cuda.synchronize()
    assert edge_message.launches == 2
    _assert_matches(got, again, want)


@needs_cuda
def test_edge_kernel_empty_rows_and_empty_graph():
    args = _edge_args(torch.device("cuda"))
    args[3] = torch.zeros_like(args[3])  # every slot masked
    with torch.no_grad():
        dx, mh, deg = edge_message.edge_pathway_fused(*args)
    assert not dx.any() and not mh.any() and not deg.any()
    args[4] = torch.zeros_like(args[4])  # no slots at all
    with torch.no_grad():
        dx, mh, deg = edge_message.edge_pathway_fused(*args)
    assert not dx.any() and not mh.any() and not deg.any()


@needs_cuda
@pytest.mark.parametrize("n", [1000, 64, 37])
def test_virtual_kernel_matches_plain(n):
    args = _virtual_args(torch.device("cuda"), n=n)
    virtual_message.reset_launches()
    with torch.no_grad():
        got = virtual_message.virtual_pathway_fused(*args)
        again = virtual_message.virtual_pathway_fused(*args)
        want = virtual_message.virtual_pathway_plain(*args)
    torch.cuda.synchronize()
    assert virtual_message.launches == 2
    _assert_matches(got, again, want)


# ----------------------------- the forwards' schedules: shares, hubs, faults
def _outside_values_tolerance(got, want) -> bool:
    """True where some output leaves atol 1e-5 / rtol 1e-4."""
    return any(not bool(((g - w).abs() <= ATOL + RTOL * w.abs()).all())
               for g, w in zip(got, want))


def _hub_edge_args(dev, gate="mlp"):
    """The hub graph of the backward tests (a 200-edge hub receiver, node
    3, and hub sender, node 7; 301 nodes), forward arguments only."""
    args = _hub_edge_bwd_args(dev)[0]
    if gate == "none":
        args[11:14] = [torch.zeros(1, 1, device=dev)] * 3
    return args


@needs_cuda
@pytest.mark.parametrize("gate,rel,clamp", [
    ("mlp", "raw", math.inf), ("mlp", "raw", 0.05), ("mlp", "inv1p", 0.05),
    ("none", "raw", math.inf)])
def test_edge_forward_hub_rows(gate, rel, clamp):
    """A receiver row of 200 edges runs over several 64-edge tiles in one
    CTA; a hub sender; a node count that is no multiple of 64."""
    dev = torch.device("cuda")
    args = _hub_edge_args(dev, gate)
    deg = np.diff(args[4].cpu().numpy())
    assert deg[3] >= 200 and args[0].shape[0] % 64 != 0
    kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp)
    edge_message.reset_launches()
    with torch.no_grad():
        got = edge_message.edge_pathway_fused(*args, **kw)
        again = edge_message.edge_pathway_fused(*args, **kw)
        want = edge_message.edge_pathway_plain(*args, **kw)
    torch.cuda.synchronize()
    assert edge_message.launches == 2
    _assert_matches(got, again, want)


@needs_cuda
@pytest.mark.parametrize("n_ctas", [1, 3, 64, 1000])
def test_edge_forward_cta_count_does_not_change_a_bit(monkeypatch, n_ctas):
    """Each row sums its live edges in slot order inside one CTA, so any
    CTA count gives the same bits: one CTA; shares that cut rows anywhere;
    1,000 CTAs, most of whose shares start inside the hub row and own no
    row."""
    dev = torch.device("cuda")
    args = _hub_edge_args(dev)
    with torch.no_grad():
        ref = edge_message.edge_pathway_fused(*args)
        monkeypatch.setattr(edge_message, "EDGE_FWD_CTAS", n_ctas)
        got = edge_message.edge_pathway_fused(*args)
        want = edge_message.edge_pathway_plain(*args)
    torch.cuda.synchronize()
    _assert_matches(got, ref, want)


@needs_cuda
def test_edge_forward_shares_without_live_slots(monkeypatch):
    """Three CTA shares whose slots are all masked: their rows get exact
    zeros, the rest match the plain version."""
    dev = torch.device("cuda")
    args = _hub_edge_args(dev)
    n_ctas = 40
    monkeypatch.setattr(edge_message, "EDGE_FWD_CTAS", n_ctas)
    indptr = args[4].cpu().numpy()
    share = -(-int(indptr[-1]) // n_ctas)
    em = args[3].clone()
    em[5 * share:8 * share] = 0.0
    args[3] = em
    with torch.no_grad():
        got = edge_message.edge_pathway_fused(*args)
        again = edge_message.edge_pathway_fused(*args)
        want = edge_message.edge_pathway_plain(*args)
    torch.cuda.synchronize()
    _assert_matches(got, again, want)
    dead = [r for r in range(indptr.size - 1)
            if not em[int(indptr[r]):int(indptr[r + 1])].any()]
    assert len(dead) > 3
    for out in got:
        assert not out[dead].any()


@needs_cuda
def test_edge_forward_extra_masked_slots_do_not_change_a_bit():
    """The same live edges, once in a Verlet list at r + skin with the
    candidates outside r masked and once in a list of exactly the live
    edges: torch.equal outputs (a trajectory cannot depend on the skin)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    n, r, skin = 400, 0.15, 0.1
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    args = _edge_args(dev, seed=21)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    h = torch.from_numpy(rng.standard_normal((n, WIDTH)).astype(
        np.float32)).to(dev)
    snd, rcv = sort_edges_by_receiver(*radius_graph(x, r + skin))
    d = x[snd] - x[rcv]
    keep = (d * d).sum(-1) <= np.float32(r) ** 2
    outs = []
    for s, rc, m in ((snd, rcv, keep), (snd[keep], rcv[keep], keep[keep])):
        sp, rp, em = pad_edges(s, rc, s.size + 64, x)
        em[:s.size] = m
        args[:5] = [t(x), h, t(sp), t(em), t(csr_indptr(rp, s.size, n))]
        with torch.no_grad():
            outs.append(edge_message.edge_pathway_fused(*args))
    assert 1000 < keep.sum() < keep.size // 2
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@needs_cuda
def test_edge_forward_planted_fault_is_caught():
    """One live slot's mask zeroed in the kernel's call only lands outside
    the forward tolerance."""
    dev = torch.device("cuda")
    args = _hub_edge_args(dev)
    with torch.no_grad():
        want = edge_message.edge_pathway_plain(*args)
        em = args[3].clone()
        live = torch.nonzero(em).flatten()
        em[live[live.numel() // 2]] = 0.0
        got = edge_message.edge_pathway_fused(*args[:3], em, *args[4:])
    torch.cuda.synchronize()
    assert _outside_values_tolerance(got, want)


@needs_cuda
@pytest.mark.parametrize("n,c", [(8192, 3), (8192, 1), (8191, 3), (100, 2)])
def test_virtual_forward_serving_and_ragged_sizes(n, c):
    """The serving size (128 tiles of 64 nodes), a ragged last tile, and
    one or several channels."""
    args = _virtual_args(torch.device("cuda"), n=n, c=c)
    virtual_message.reset_launches()
    with torch.no_grad():
        got = virtual_message.virtual_pathway_fused(*args)
        again = virtual_message.virtual_pathway_fused(*args)
        want = virtual_message.virtual_pathway_plain(*args)
    torch.cuda.synchronize()
    assert virtual_message.launches == 2
    _assert_matches(got, again, want)


@needs_cuda
def test_virtual_forward_planted_fault_is_caught():
    """One node's mask flipped in the kernel's call only lands outside the
    forward tolerance."""
    args = _virtual_args(torch.device("cuda"), n=1000)
    with torch.no_grad():
        want = virtual_message.virtual_pathway_plain(*args)
        mask = args[3].clone()
        mask[500] = 1.0 - mask[500]
        got = virtual_message.virtual_pathway_fused(*args[:3], mask,
                                                    *args[4:])
    torch.cuda.synchronize()
    assert _outside_values_tolerance(got, want)


@needs_cuda
@pytest.mark.parametrize("drop_rate", [0.0, 0.5])
def test_rollout_kernel_path_bitwise_independent_of_skin(drop_rate):
    """DESIGN.md §10.2 on the card: full-width FastEGNN (2 layers) through
    the kernels, two scenes, trajectories at skin 0 (a rebuild every step)
    and skin 0.4 (a reused Verlet list with many masked candidates) are
    array_equal.  The random weights' coordinate outputs are scaled by
    0.05 so that the scenes stay finite and the list is reused."""
    from repro_torch.rollout import BatchedRolloutEngine

    dev = torch.device("cuda")
    pipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                          n_layers=2,
                          generator=torch.Generator().manual_seed(3))
    for lp in pipe.params["layers"]:
        for w in (lp["phi_xr"][1]["w"], lp["phi_v"][1]["w"],
                  lp["virtual"]["phi_xv"][1]["w"],
                  lp["virtual"]["phi_z"][1]["w"]):
            w.mul_(0.05)
    rng = np.random.default_rng(8)
    scenes = [(rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
               (0.05 * rng.standard_normal((n, 3))).astype(np.float32),
               np.ones((n, 1), np.float32)) for n in (300, 260)]
    runs = []
    for skin in (0.0, 0.4):
        eng = BatchedRolloutEngine(pipe.predict_fn, batch_size=2, node_cap=320,
                                   edge_cap=320 * 300, r=0.15, skin=skin,
                                   dt=0.01, drop_rate=drop_rate, device=dev)
        edge_message.reset_launches()
        runs.append(eng.run(pipe.params, scenes, 8))
        # layers x scenes x (steps + the steps computed and dropped)
        assert edge_message.launches == 2 * 2 * (
            8 + runs[-1].discarded_steps)
    assert runs[1].rebuild_count < runs[0].rebuild_count
    for a, b in zip(runs[0].trajectories, runs[1].trajectories):
        assert np.isfinite(a).all()
        assert np.array_equal(a, b)


def _cell_list_points(kind: str, n: int = 4096):
    """The four point sets of the cell-list parity tests, at 4,096 nodes."""
    rng = np.random.default_rng(7)
    uniform = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    if kind == "uniform":
        return uniform
    if kind == "clustered":
        return (0.05 * rng.random((n, 3))).astype(np.float32)
    if kind == "skewed":
        return np.stack([rng.uniform(0, 10, n), 0.02 * rng.random(n),
                         0.02 * rng.random(n)], axis=1).astype(np.float32)
    uniform[n // 2:] = uniform[:n - n // 2]  # duplicates
    return uniform


@needs_cuda
@pytest.mark.parametrize("edge_cap", [200_000, 4096],
                         ids=["roomy", "truncating"])
@pytest.mark.parametrize("kind", ["uniform", "clustered", "skewed",
                                  "duplicates"])
def test_device_cell_list_build_equals_host_build(kind, edge_cap):
    """DESIGN.md §13.3 on the card: the device build (node-padded, a
    quarter of the rows masked) and its CSR layout are bitwise the host
    build's at the same capacities."""
    import warnings

    from repro_torch.data.cell_list import (auto_cell_cap, cell_occupancy,
                                            device_csr, device_radius_build)

    x = _cell_list_points(kind)
    r_build = {"uniform": 0.08, "clustered": 0.004, "skewed": 0.045,
               "duplicates": 0.08}[kind]  # ~7-30 neighbours a node
    real = x[:3072]
    cap = min(3072, auto_cell_cap(cell_occupancy(real, r_build)))
    snd, rcv = sort_edges_by_receiver(*radius_graph(real, r_build))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        hs, hr, hm = pad_edges(snd, rcv, edge_cap, real)
    nm = np.zeros(4096, np.float32)
    nm[:3072] = 1.0
    t = lambda a: torch.from_numpy(a).cuda()
    db = device_radius_build(t(x), t(nm), r_build=r_build,
                             edge_cap=edge_cap, cell_cap=cap)
    indptr, n_edges = device_csr(db.receivers, db.edge_mask, 4096)
    torch.cuda.synchronize()
    assert not bool(db.overflow) and int(db.n_edges) == snd.size
    assert np.array_equal(db.senders.cpu().numpy(), hs)
    assert np.array_equal(db.receivers.cpu().numpy(), hr)
    assert np.array_equal(db.edge_mask.cpu().numpy(), hm)
    n_live = int(np.count_nonzero(hm))
    assert int(n_edges) == n_live
    assert np.array_equal(indptr.cpu().numpy(), csr_indptr(hr, n_live, 4096))


@needs_cuda
@pytest.mark.parametrize("drop_rate", [0.0, 0.3])
def test_rollout_device_rebuild_equals_host_rebuild_on_card(drop_rate):
    """Full-width FastEGNN (2 layers) through the kernels, three scenes in
    four slots: the device rebuilds give bitwise the host rebuilds'
    trajectories, with no coordinate fetch or edge upload after the first
    list and no blocking rebuild."""
    from repro_torch.rollout import BatchedRolloutEngine

    dev = torch.device("cuda")
    pipe = build_pipeline("fast_egnn", device=dev, use_kernel=True,
                          n_layers=2,
                          generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(9)
    scenes = [(rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32),
               (0.05 * rng.standard_normal((n, 3))).astype(np.float32),
               np.ones((n, 1), np.float32)) for n in (300, 260, 311)]
    runs = {}
    for mode in ("host", "device"):
        eng = BatchedRolloutEngine(pipe.predict_fn, batch_size=4, node_cap=320,
                                   edge_cap=320 * 64, r=0.15, skin=0.02,
                                   dt=0.01, drop_rate=drop_rate,
                                   wrap_box=1.0, rebuild_mode=mode,
                                   device=dev)
        edge_message.reset_launches()
        runs[mode] = eng.run(pipe.params, scenes, 6)
        # layers x slots x (steps + the steps computed and dropped)
        assert edge_message.launches == 2 * 4 * (
            6 + runs[mode].discarded_steps)
    host, devr = runs["host"], runs["device"]
    assert devr.rebuild_mode == "device" and devr.rebuild_count >= 2
    assert devr.rebuild_steps == host.rebuild_steps
    assert devr.coord_d2h_bytes == devr.edge_h2d_bytes == 0
    assert devr.rebuild_waits == 0 and host.rebuild_waits >= 2
    for a, b in zip(host.trajectories, devr.trajectories):
        assert np.isfinite(a).all()
        assert np.array_equal(a, b)


@needs_cuda
def test_kernel_path_refuses_ineligible_blocks_on_card():
    """The reference's dispatch rule on the card: a spec or block the
    reference runs in jnp (unnormalised sums; the shared-weight ablation;
    zero-width features) runs the plain path, counted as such, and equals
    ``use_kernel=False``; blocks of any width inside the reference's
    budget run the kernels, and one past it the plain path."""
    from repro_torch.core import message_passing as mp

    dev = torch.device("cuda")
    x, sp, rp, em, indptr, n_edges = _graph(seed=11)
    n = x.shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    g = GeometricGraph(x=t(x), v=torch.zeros(n, 3, device=dev),
                       h=torch.ones(n, WIDTH, device=dev), senders=t(sp),
                       receivers=t(rp),
                       edge_attr=torch.zeros(sp.size, 0, device=dev),
                       node_mask=torch.ones(n, device=dev), edge_mask=t(em))
    gen = torch.Generator(device=dev).manual_seed(0)
    r = lambda *s: 0.2 * torch.randn(s, generator=gen, device=dev)
    lp = {"phi1": [{"w": r(2 * WIDTH + 1, WIDTH), "b": r(WIDTH)},
                   {"w": r(WIDTH, WIDTH), "b": r(WIDTH)}],
          "gate": [{"w": r(WIDTH, WIDTH), "b": r(WIDTH)}, {"w": r(WIDTH, 1)}]}
    lay = (t(indptr), n_edges)
    spec = EdgeSpec(normalize=False)
    with torch.no_grad():
        mp.reset_dispatch_counts()
        got = edge_pathway(lp, g.h, g.x, g, spec, use_kernel=True, layout=lay)
        want = edge_pathway(lp, g.h, g.x, g, spec)
        assert mp.dispatch_counts() == {"edge_plain": 2}
        assert torch.equal(got.dx, want.dx) and torch.equal(got.mh, want.mh)
        vs = VirtualState(z=torch.full((3, 3), 0.5, device=dev),
                          s=torch.zeros(3, WIDTH, device=dev))
        mv = torch.zeros(3, 3, device=dev)
        shared = init_virtual_block(torch.Generator().manual_seed(0), 3,
                                    WIDTH, WIDTH, WIDTH, shared=True,
                                    device=dev)
        geo = init_virtual_block(torch.Generator().manual_seed(1), 3, 0, 0,
                                 WIDTH, device=dev)
        vs0 = VirtualState(z=vs.z, s=torch.zeros(3, 0, device=dev))
        mp.reset_dispatch_counts()
        for blk, h, st in ((shared, g.h, vs), (geo, g.h[:, :0], vs0)):
            got = virtual_pathway(blk, h, g.x, st, mv, g.node_mask,
                                  use_kernel=True)
            want = virtual_pathway(blk, h, g.x, st, mv, g.node_mask)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        assert mp.dispatch_counts() == {"virtual_plain": 4}
        # every width the reference's budget admits runs the kernels (32:
        # the compiled instantiation, 96: the panel path); a width past it
        # runs the plain path on the card too
        for w, kernel in ((32, True), (96, True), (1024, False)):
            wide = {"phi1": [{"w": r(2 * w + 1, w), "b": r(w)},
                             {"w": r(w, w), "b": r(w)}],
                    "gate": [{"w": r(w, w), "b": r(w)}, {"w": r(w, 1)}]}
            hw = torch.randn((n, w), generator=gen, device=dev)
            gw = g._replace(h=hw)
            mp.reset_dispatch_counts()
            got = edge_pathway(wide, hw, g.x, gw, EdgeSpec(),
                               use_kernel=True, layout=lay)
            want = edge_pathway(wide, hw, g.x, gw, EdgeSpec())
            assert mp.dispatch_counts() == (
                {"edge_kernel": 1, "edge_plain": 1} if kernel
                else {"edge_plain": 2})
            torch.testing.assert_close(got.mh, want.mh, atol=ATOL, rtol=RTOL)
            torch.testing.assert_close(got.dx, want.dx, atol=ATOL, rtol=RTOL)


@needs_cuda
def test_model_kernel_path_matches_plain_path_on_card():
    """Full-width FastEGNN (2 layers) on the card: every layer launches
    both kernels once, and the result matches the plain path."""
    dev = torch.device("cuda")
    x, sp, rp, em, indptr, n_edges = _graph(n=400, cap=16000, seed=9)
    n_cap = 512
    xp, nm = pad_nodes(x, n_cap)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    g = GeometricGraph(x=t(xp), v=torch.zeros(n_cap, 3, device=dev),
                       h=t(nm[:, None].copy()), senders=t(sp),
                       receivers=t(rp),
                       edge_attr=torch.zeros(sp.size, 0, device=dev),
                       node_mask=t(nm), edge_mask=t(em))
    lay = (t(csr_indptr(rp, n_edges, n_cap)), n_edges)
    pipe = build_pipeline("fast_egnn", device=dev, n_layers=2,
                          generator=torch.Generator().manual_seed(3))
    cfg_k = FastEGNNConfig(n_layers=2, use_kernel=True)
    edge_message.reset_launches()
    virtual_message.reset_launches()
    with torch.no_grad():
        xk, hk, vk = fast_egnn_apply(pipe.params, cfg_k, g, edge_layout=lay)
        xr, hr, vr = fast_egnn_apply(pipe.params, pipe.cfg, g)
    assert edge_message.launches == 2 and virtual_message.launches == 2
    torch.testing.assert_close(xk, xr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(hk, hr, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(vk.z, vr.z, atol=1e-4, rtol=1e-4)


@needs_cuda
@pytest.mark.parametrize("hidden", [32, 64])
def test_model_kernel_path_e3_equivariant_on_card(hidden):
    """FastEGNN with the kernels on the card (Proposition IV.1): rotating
    (a random orthogonal matrix) and translating the input moves the
    output the same way, within rtol / atol 2e-3, at the hidden width of
    every reference entry point (32) and the default model's (64)."""
    from repro_torch.core.equivariant import (apply_e3, apply_o3,
                                              random_orthogonal)

    dev = torch.device("cuda")
    x, sp, rp, em, indptr, n_edges = _graph(n=400, cap=16000, seed=9)
    n_cap = 512
    xp, nm = pad_nodes(x, n_cap)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rng = np.random.default_rng(2)
    g = GeometricGraph(x=t(xp), v=t(rng.standard_normal((n_cap, 3))
                                   .astype(np.float32)),
                       h=t(nm[:, None].copy()), senders=t(sp),
                       receivers=t(rp),
                       edge_attr=torch.zeros(sp.size, 0, device=dev),
                       node_mask=t(nm), edge_mask=t(em))
    lay = (t(csr_indptr(rp, n_edges, n_cap)), n_edges)
    pipe = build_pipeline("fast_egnn", device=dev, n_layers=2, hidden=hidden,
                          n_virtual=3, s_dim=hidden // 2, use_kernel=True,
                          generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(hidden)
    rot = random_orthogonal(gen, device="cpu").to(dev)
    shift = (3.0 * torch.randn((3,), generator=gen)).to(dev)
    edge_message.reset_launches()
    with torch.no_grad():
        x1, _ = pipe.apply_full(pipe.params, pipe.cfg, g, edge_layout=lay)
        gt = g._replace(x=apply_e3(g.x, rot, shift), v=apply_o3(g.v, rot))
        x2, _ = pipe.apply_full(pipe.params, pipe.cfg, gt, edge_layout=lay)
    assert edge_message.route_launches == {f"w{hidden}": 4}
    real = t(nm) > 0
    torch.testing.assert_close(x2[real], apply_e3(x1, rot, shift)[real],
                               rtol=2e-3, atol=2e-3)


# ------------------------------------------------------------- backwards
def _assert_grads_match(got, again, want):
    """Bitwise repeatable, and within rtol 1e-3 / atol 5e-5 of the plain
    gradients relative to each output's largest magnitude."""
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape
        assert torch.equal(g, a)
        scale = float(w.abs().max()) + 1e-6
        torch.testing.assert_close(g / scale, w / scale, atol=5e-5,
                                   rtol=1e-3)


def _sender_perm(sp, n_edges, n, dev):
    perm, sptr = csr_sender_perm(sp, n_edges, n)
    full = np.zeros(sp.size, np.int32)
    full[:perm.size] = perm
    return torch.from_numpy(full).to(dev), torch.from_numpy(sptr).to(dev)


def _edge_bwd_args(dev, gate, rel, clamp, seed=5):
    x, sp, _, em, indptr, n_edges = _graph(seed=seed)
    args = _edge_args(dev, seed=seed)
    n = x.shape[0]
    if gate == "none":
        args[11:14] = [torch.zeros(1, 1, device=dev)] * 3
    with torch.no_grad():
        _, _, deg = edge_message.edge_pathway_plain(
            *args, gate_mode=gate, rel_mode=rel, clamp=clamp)
    rng = np.random.default_rng(seed + 2)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    g_dx = t(rng.standard_normal((n, 3)))
    g_mh = t(rng.standard_normal((n, WIDTH)))
    sperm, sptr = _sender_perm(sp, n_edges, n, dev)
    return args, (sperm, sptr), deg.contiguous(), g_dx, g_mh


@needs_cuda
@pytest.mark.parametrize("gate,rel,clamp", [
    ("mlp", "raw", math.inf), ("mlp", "raw", 0.05), ("mlp", "inv1p", 0.05),
    ("mlp", "inv1p", math.inf), ("none", "raw", math.inf)])
def test_edge_backward_kernel_matches_plain(gate, rel, clamp):
    dev = torch.device("cuda")
    args, sender, deg, g_dx, g_mh = _edge_bwd_args(dev, gate, rel, clamp)
    kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp)
    edge_message.reset_launches()
    run = lambda: edge_message.edge_pathway_bwd_fused(
        *args[:5], *sender, *args[5:], deg, g_dx, g_mh, **kw)
    got, again = run(), run()
    want = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh, **kw)
    torch.cuda.synchronize()
    assert edge_message.bwd_launches == 2
    _assert_grads_match(got, again, want)


@needs_cuda
def test_edge_backward_masked_rows_nodes_and_empty_graph():
    """All-masked rows give exact zeros, and so does an empty slot list."""
    dev = torch.device("cuda")
    args, sender, deg, g_dx, g_mh = _edge_bwd_args(dev, "mlp", "raw",
                                                   math.inf)
    em = args[3].clone()
    indptr = args[4].cpu().numpy()
    dead = np.arange(0, indptr.size - 1, 3)  # every third receiver row
    for r in dead:
        em[int(indptr[r]):int(indptr[r + 1])] = 0.0
    args[3] = em
    with torch.no_grad():
        deg = edge_message.edge_pathway_plain(*args)[2].contiguous()
    got = edge_message.edge_pathway_bwd_fused(*args[:5], *sender, *args[5:],
                                              deg, g_dx, g_mh)
    want = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh)
    torch.cuda.synchronize()
    _assert_grads_match(got, got, want)
    args[3] = torch.zeros_like(em)
    zero_deg = torch.zeros_like(deg)
    got = edge_message.edge_pathway_bwd_fused(*args[:5], *sender, *args[5:],
                                              zero_deg, g_dx, g_mh)
    assert all(not g.any() for g in got)
    empty = [a[:0] if i in (2, 3) else a for i, a in enumerate(args)]
    empty[4] = torch.zeros_like(args[4])
    got = edge_message.edge_pathway_bwd_fused(*empty[:5], *sender,
                                              *empty[5:], zero_deg, g_dx,
                                              g_mh)
    assert all(not g.any() for g in got)


@needs_cuda
@pytest.mark.parametrize("n", [1000, 64, 37])
def test_virtual_backward_kernel_matches_plain(n):
    dev = torch.device("cuda")
    args = _virtual_args(dev, n=n)
    rng = np.random.default_rng(n)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
    c = args[2].shape[0]
    cots = (t(n, 3), t(n, WIDTH), t(c, 3), t(c, WIDTH))
    virtual_message.reset_launches()
    got = virtual_message.virtual_pathway_bwd_fused(*args, *cots)
    again = virtual_message.virtual_pathway_bwd_fused(*args, *cots)
    want = virtual_message.virtual_pathway_bwd_plain(*args, *cots)
    torch.cuda.synchronize()
    assert virtual_message.bwd_launches == 2
    _assert_grads_match(got, again, want)


@needs_cuda
@pytest.mark.parametrize("n", [8192, 1000, 37])
def test_mmd_kernels_match_plain(n):
    """The unbatched call (one graph); the counters count calls, one
    kernel each."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(n)
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    x = t(rng.uniform(0, 1, (n, 3)))
    z = t(0.5 + 0.2 * rng.standard_normal((3, 3)))
    mask = t((rng.uniform(size=n) > 0.2) * 1.0)
    g = t(np.array(0.7))
    mmd_rbf.reset_launches()
    got = mmd_rbf.mmd_cross_sum(x, z, mask, sigma=0.3)
    again = mmd_rbf.mmd_cross_sum(x, z, mask, sigma=0.3)
    want = mmd_rbf.mmd_cross_sum_plain(x, z, mask, sigma=0.3)
    gg = mmd_rbf.mmd_cross_grads(x, z, mask, g, sigma=0.3)
    gg2 = mmd_rbf.mmd_cross_grads(x, z, mask, g, sigma=0.3)
    gw = mmd_rbf.mmd_cross_grads_plain(x, z, mask, g, sigma=0.3)
    torch.cuda.synchronize()
    assert mmd_rbf.sum_launches == 2 and mmd_rbf.grad_launches == 2
    assert got.shape == () and gg[0].shape == (n, 3) and gg[1].shape == (3, 3)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
    _assert_grads_match(gg, gg2, gw)


def _mmd_batch(b, n, c, dev, seed=0, live=None):
    """x (B,N,3), z (B,C,3), mask (B,N), g (B,): graph k has ``live``
    nodes (default: 80 % of n, at random), the rest masked out."""
    rng = np.random.default_rng(seed + b * n + c)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    x = rng.uniform(0, 1, (b, n, 3))
    if live is None:
        mask = rng.uniform(size=(b, n)) > 0.2
    else:
        mask = np.arange(n)[None, :] < np.asarray(live)[:, None]
    z = 0.5 + 0.2 * rng.standard_normal((b, c, 3))
    return t(x), t(z), t(mask), t(rng.uniform(0.5, 1.5, b))


def _mmd_pair(x, z, mask, g, sigma=0.3):
    return (mmd_rbf.mmd_cross_sum(x, z, mask, sigma=sigma),
            *mmd_rbf.mmd_cross_grads(x, z, mask, g, sigma=sigma))


def _mmd_pair_plain(x, z, mask, g, sigma=0.3):
    return (mmd_rbf.mmd_cross_sum_plain(x, z, mask, sigma=sigma),
            *mmd_rbf.mmd_cross_grads_plain(x, z, mask, g, sigma=sigma))


@needs_cuda
@pytest.mark.parametrize("c", [3, 5])
@pytest.mark.parametrize("n", [37, 1000, 8192, 131072])
@pytest.mark.parametrize("b", [1, 4])
def test_mmd_batched_kernels_match_plain_and_singles(b, n, c):
    """One launch of each kernel for the batch: within the tolerances of
    the plain version, bitwise repeatable, and each graph's rows bitwise
    equal to that graph run alone (its schedule depends on N only).  Five
    channels take two passes of the gradient's register-held dz sums."""
    dev = torch.device("cuda")
    args = _mmd_batch(b, n, c, dev)
    mmd_rbf.reset_launches()
    got = _mmd_pair(*args)
    assert mmd_rbf.sum_launches == 1 and mmd_rbf.grad_launches == 1
    again = _mmd_pair(*args)
    want = _mmd_pair_plain(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (b,) and got[1].shape == (b, n, 3)
    assert got[2].shape == (b, c, 3)
    assert torch.equal(got[0], again[0])
    torch.testing.assert_close(got[0], want[0], atol=ATOL, rtol=RTOL)
    _assert_grads_match(got[1:], again[1:], want[1:])
    for k in range(b):
        one = _mmd_pair(*(a[k:k + 1] for a in args))
        for t, s in zip(got, one):
            assert torch.equal(t[k:k + 1], s)


@needs_cuda
@pytest.mark.parametrize("b,n", [(1, 37), (4, 8192), (1, 131072),
                                 (4, 131072)])
def test_mmd_kernels_one_device_kernel_per_call(b, n):
    """``torch.profiler`` sees one device kernel for each call of either
    wrapper, whatever B (a marker kernel first, left out: the profiler
    may miss a session's first kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    x, z, mask, g = _mmd_batch(b, n, 3, dev)
    for name, call in (
            ("mmd_sum_kernel", lambda: mmd_rbf.mmd_cross_sum(
                x, z, mask, sigma=0.3)),
            ("mmd_grad_kernel", lambda: mmd_rbf.mmd_cross_grads(
                x, z, mask, g, sigma=0.3))):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(10_000)
            torch.cuda.synchronize()
            call()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and "spin" not in e.key]
        assert sum(e.count for e in kernels) == 1, [e.key for e in kernels]
        assert name in kernels[0].key


@needs_cuda
@pytest.mark.parametrize("masked", [False, True])
def test_mmd_kernels_keep_nan(masked):
    """A NaN in one node's x makes its graph's sum, that node's dx and
    the graph's dz NaN, as in the plain version (a masked node too:
    NaN · 0 is NaN), and leaves the other graphs alone."""
    dev = torch.device("cuda")
    x, z, mask, g = _mmd_batch(3, 1000, 3, dev, seed=4)
    x[1, 17, 2] = float("nan")
    mask[1, 17] = 0.0 if masked else 1.0
    got = _mmd_pair(x, z, mask, g)
    want = _mmd_pair_plain(x, z, mask, g)
    torch.cuda.synchronize()
    for k, w in zip(got, want):
        assert torch.equal(torch.isnan(k), torch.isnan(w))
    assert torch.isnan(got[0][1]) and torch.isfinite(got[0][[0, 2]]).all()
    assert torch.isnan(got[1][1, 17]).all() and torch.isnan(got[2][1]).all()
    assert torch.isfinite(got[1][[0, 2]]).all()


@needs_cuda
def test_mmd_planted_mask_fault_is_caught():
    """One live node's mask flipped in the kernels' call only, at the
    train step's shape (B = 4, 7,800 live of 8,192): the sum and the
    gradients land outside the tolerances of the plain version."""
    dev = torch.device("cuda")
    x, z, mask, g = _mmd_batch(4, 8192, 3, dev, live=[7800] * 4)
    z = x[:, :7800].mean(1, keepdim=True) + 0.05 * (z - 0.5)
    want = _mmd_pair_plain(x, z, mask, g, sigma=1.5)
    bad = mask.clone()
    bad[0, 3900] = 0.0
    got = _mmd_pair(x, z, bad, g, sigma=1.5)
    torch.cuda.synchronize()
    assert not bool(torch.all((got[0] - want[0]).abs()
                              <= ATOL + RTOL * want[0].abs()))
    assert _outside_tolerance(got[1:], want[1:])
    # ... and the sound call lands inside them
    sound = _mmd_pair(x, z, mask, g, sigma=1.5)
    torch.testing.assert_close(sound[0], want[0], atol=ATOL, rtol=RTOL)
    assert not _outside_tolerance(sound[1:], want[1:])


@needs_cuda
def test_model_gradients_kernel_path_match_plain_path_on_card():
    """Full-width FastEGNN (2 layers) with the MMD term: the gradients
    through the three autograd Functions match the plain path, and every
    layer launches each backward kernel once."""
    from repro_torch.core.mmd import mmd_loss

    dev = torch.device("cuda")
    x, sp, rp, em, indptr, n_edges = _graph(n=400, cap=16000, seed=9)
    n_cap = 512
    xp, nm = pad_nodes(x, n_cap)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    g = GeometricGraph(x=t(xp), v=torch.zeros(n_cap, 3, device=dev),
                       h=t(nm[:, None].copy()), senders=t(sp),
                       receivers=t(rp),
                       edge_attr=torch.zeros(sp.size, 0, device=dev),
                       node_mask=t(nm), edge_mask=t(em))
    lay = (t(csr_indptr(rp, n_edges, n_cap)), n_edges,
           *_sender_perm(sp, n_edges, n_cap, dev))
    pipe = build_pipeline("fast_egnn", device=dev, n_layers=2,
                          generator=torch.Generator().manual_seed(3))
    target = g.x + 0.01

    def grads(cfg, layout):
        leaves = [p for lp in pipe.params["layers"] for blk in lp.values()
                  for layer in (blk if isinstance(blk, list) else
                                [l for v in blk.values() for l in v])
                  for p in layer.values()]
        for p in leaves:
            p.requires_grad_(True)
        xo, _, vs = fast_egnn_apply(pipe.params, cfg, g, edge_layout=layout)
        loss = (((xo - target) ** 2).sum(-1) * g.node_mask).mean() + 0.03 * \
            mmd_loss(vs.z, target, g.node_mask, sigma=1.5,
                     use_kernel=cfg.use_kernel)
        out = torch.autograd.grad(loss, leaves, allow_unused=True)
        for p in leaves:
            p.requires_grad_(False)
        return [torch.zeros_like(p) if o is None else o
                for o, p in zip(out, leaves)]

    edge_message.reset_launches()
    virtual_message.reset_launches()
    mmd_rbf.reset_launches()
    gk = grads(FastEGNNConfig(n_layers=2, use_kernel=True), lay)
    gr = grads(pipe.cfg, None)
    torch.cuda.synchronize()
    assert edge_message.bwd_launches == 2 and virtual_message.bwd_launches == 2
    assert mmd_rbf.sum_launches == 1 and mmd_rbf.grad_launches == 1
    _assert_grads_match(gk, gk, gr)


# ---------------------------- the backwards' schedules: ranges, hubs, faults
def _outside_tolerance(got, want) -> bool:
    """True where some output leaves the gradient tolerance."""
    for g, w in zip(got, want):
        scale = float(w.abs().max()) + 1e-6
        if not bool(((g - w).abs() <= 5e-5 * scale + 1e-3 * w.abs()).all()):
            return True
    return False


def _hub_edge_bwd_args(dev, hub_deg=200, n=301, seed=13):
    """A radius graph plus a hub receiver (node 3) and a hub sender (node
    7) of degree ``hub_deg``, with mask holes; ``n`` is not a multiple of
    the 64-node tile.  Returns the wrapper's arguments and the length of
    one edge-pass CTA's slot range."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    snd, rcv = radius_graph(x, 0.15)
    pick = rng.choice(np.setdiff1d(np.arange(n), [3, 7]), hub_deg,
                      replace=False)
    pairs = set(zip(snd.tolist(), rcv.tolist()))
    pairs |= {(int(j), 3) for j in pick} | {(7, int(j)) for j in pick}
    snd = np.array([p[0] for p in pairs], np.int32)
    rcv = np.array([p[1] for p in pairs], np.int32)
    snd, rcv = sort_edges_by_receiver(snd, rcv)
    sp, rp, em = pad_edges(snd, rcv, snd.size + 500, x)
    em[: snd.size: 7] = 0.0
    indptr = csr_indptr(rp, snd.size, n)
    args = _edge_args(dev, seed=seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    h = torch.from_numpy(rng.standard_normal((n, WIDTH)).astype(
        np.float32)).to(dev)
    args[:5] = [t(x), h, t(sp), t(em), t(indptr)]
    with torch.no_grad():
        deg = edge_message.edge_pathway_plain(*args)[2].contiguous()
    g_dx = t(rng.standard_normal((n, 3)).astype(np.float32))
    g_mh = t(rng.standard_normal((n, WIDTH)).astype(np.float32))
    sender = _sender_perm(sp, snd.size, n, dev)
    length = -(-snd.size // edge_message.EDGE_BWD_CTAS)
    return args, sender, deg, g_dx, g_mh, length


@needs_cuda
@pytest.mark.parametrize("gate,rel,clamp", [
    ("mlp", "raw", math.inf), ("mlp", "inv1p", 0.05), ("none", "raw",
                                                       math.inf)])
def test_edge_backward_hub_rows_cross_cta_ranges(gate, rel, clamp):
    """A hub receiver whose row is longer than one CTA's slot range, a hub
    sender, and a node count that is no multiple of the node tile."""
    dev = torch.device("cuda")
    args, sender, deg, g_dx, g_mh, length = _hub_edge_bwd_args(dev)
    if gate == "none":
        args[11:14] = [torch.zeros(1, 1, device=dev)] * 3
    indptr = args[4].cpu().numpy()
    assert np.diff(indptr).max() > 2 * length
    assert args[0].shape[0] % 64 != 0
    kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp)
    run = lambda: edge_message.edge_pathway_bwd_fused(
        *args[:5], *sender, *args[5:], deg, g_dx, g_mh, **kw)
    got, again = run(), run()
    want = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh, **kw)
    torch.cuda.synchronize()
    _assert_grads_match(got, again, want)


@needs_cuda
def test_edge_backward_cta_range_without_live_slots():
    """Ranges with every slot masked write zero partials."""
    dev = torch.device("cuda")
    args, sender, _, g_dx, g_mh, length = _hub_edge_bwd_args(dev)
    em = args[3].clone()
    em[5 * length:8 * length] = 0.0
    args[3] = em
    with torch.no_grad():
        deg = edge_message.edge_pathway_plain(*args)[2].contiguous()
    run = lambda: edge_message.edge_pathway_bwd_fused(
        *args[:5], *sender, *args[5:], deg, g_dx, g_mh)
    got, again = run(), run()
    want = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh)
    torch.cuda.synchronize()
    _assert_grads_match(got, again, want)


@needs_cuda
def test_edge_backward_planted_fault_is_caught():
    """One live slot's mask zeroed in the kernel's call only lands outside
    the gradient tolerance."""
    dev = torch.device("cuda")
    args, sender, deg, g_dx, g_mh, _ = _hub_edge_bwd_args(dev)
    want = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh)
    bad = list(args)
    em = args[3].clone()
    live = torch.nonzero(em).flatten()
    em[live[live.numel() // 2]] = 0.0
    bad[3] = em
    got = edge_message.edge_pathway_bwd_fused(*bad[:5], *sender, *bad[5:],
                                              deg, g_dx, g_mh)
    torch.cuda.synchronize()
    assert _outside_tolerance(got, want)


@needs_cuda
@pytest.mark.parametrize("c", [1, 3])
def test_virtual_backward_at_serving_size(c):
    dev = torch.device("cuda")
    n = 8192
    args = _virtual_args(dev, n=n, c=c)
    rng = np.random.default_rng(c)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
    cots = (t(n, 3), t(n, WIDTH), t(c, 3), t(c, WIDTH))
    virtual_message.reset_launches()
    got = virtual_message.virtual_pathway_bwd_fused(*args, *cots)
    again = virtual_message.virtual_pathway_bwd_fused(*args, *cots)
    want = virtual_message.virtual_pathway_bwd_plain(*args, *cots)
    torch.cuda.synchronize()
    assert virtual_message.bwd_launches == 2
    _assert_grads_match(got, again, want)


@needs_cuda
def test_virtual_backward_planted_fault_is_caught():
    """One node's mask flipped in the kernel's call only lands outside the
    gradient tolerance."""
    dev = torch.device("cuda")
    args = _virtual_args(dev, n=1000)
    rng = np.random.default_rng(4)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
    cots = (t(1000, 3), t(1000, WIDTH), t(3, 3), t(3, WIDTH))
    want = virtual_message.virtual_pathway_bwd_plain(*args, *cots)
    bad = list(args)
    mask = args[3].clone()
    mask[500] = 1.0 - mask[500]
    bad[3] = mask
    got = virtual_message.virtual_pathway_bwd_fused(*bad, *cots)
    torch.cuda.synchronize()
    assert _outside_tolerance(got, want)


# ------------------------------------------------- NaN computed on the card
def _card_nan_rows(h, rows):
    """h with two NaN rows: 0 / 0 computed on the card (0x7fffffff) and
    the same with the sign bit set (0xffffffff).  An integer add of half a
    TF32 ulp carries both into a zero."""
    h = h.clone()
    h[rows[0]] = torch.zeros((), device=h.device) / 0.0
    bits = h.view(torch.int32)
    bits[rows[1]] = -1
    assert int(bits[rows[0], 0]) == 0x7FFFFFFF
    return h


def _assert_same_nans(got, want):
    """NaN exactly where the plain version has NaN, close elsewhere (each
    output relative to its largest finite magnitude)."""
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        if ok.any():
            scale = float(w[ok].abs().max()) + 1e-6
            torch.testing.assert_close(g[ok] / scale, w[ok] / scale,
                                       atol=5e-5, rtol=1e-3)
    assert torch.isnan(got[1]).any() and not torch.isnan(got[1]).all()


def _live_nodes(args, dev):
    """Two nodes that receive and send live edges."""
    snd, em, indptr = args[2].cpu(), args[3].cpu(), args[4].cpu()
    rcv = torch.repeat_interleave(torch.arange(indptr.numel() - 1),
                                  torch.diff(indptr.long()))
    live = em[:rcv.numel()] != 0
    both = sorted(set(rcv[live].tolist()) & set(snd[:rcv.numel()][live]
                                                 .tolist()))
    return both[3], both[40]


@needs_cuda
def test_edge_forward_keeps_nan_computed_on_card():
    dev = torch.device("cuda")
    args = _edge_args(dev)
    args[1] = _card_nan_rows(args[1], _live_nodes(args, dev))
    kw = dict(gate_mode="mlp", rel_mode="inv1p", clamp=0.05)
    with torch.no_grad():
        got = edge_message.edge_pathway_fused(*args, **kw)
        want = edge_message.edge_pathway_plain(*args, **kw)
    _assert_same_nans(got, want)


@needs_cuda
def test_edge_backward_keeps_nan_computed_on_card():
    dev = torch.device("cuda")
    args, sender, deg, g_dx, g_mh = _edge_bwd_args(dev, "mlp", "inv1p", 0.05)
    args[1] = _card_nan_rows(args[1], _live_nodes(args, dev))
    kw = dict(gate_mode="mlp", rel_mode="inv1p", clamp=0.05)
    got = edge_message.edge_pathway_bwd_fused(*args[:5], *sender, *args[5:],
                                              deg, g_dx, g_mh, **kw)
    want = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh, **kw)
    _assert_same_nans(got, want)


def _virtual_nan_args(dev, n=1000):
    args = _virtual_args(dev, n=n)
    live = torch.nonzero(args[3]).flatten().tolist()
    args[1] = _card_nan_rows(args[1], (live[3], live[700]))
    return args


@needs_cuda
def test_virtual_forward_keeps_nan_computed_on_card():
    args = _virtual_nan_args(torch.device("cuda"))
    with torch.no_grad():
        got = virtual_message.virtual_pathway_fused(*args)
        want = virtual_message.virtual_pathway_plain(*args)
    _assert_same_nans(got, want)


@needs_cuda
def test_virtual_backward_keeps_nan_computed_on_card():
    dev = torch.device("cuda")
    args = _virtual_nan_args(dev)
    rng = np.random.default_rng(9)
    t = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dev)
    cots = (t(1000, 3), t(1000, WIDTH), t(3, 3), t(3, WIDTH))
    got = virtual_message.virtual_pathway_bwd_fused(*args, *cots)
    want = virtual_message.virtual_pathway_bwd_plain(*args, *cots)
    _assert_same_nans(got, want)


# ------------------------------------------------- sliding-window attention
# bf16 outputs: kernel and plain version both compute in f32 and round once,
# in different summation orders, so they may land one bf16 rounding apart:
# |k - p| <= 2^-7 |p| (one bf16 ulp at |p|) + 1e-3 (for outputs near 0)
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3


def _assert_attention_close(got, want):
    if want.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        assert bool(torch.all((g - w).abs() <= BF16_ATOL + BF16_RTOL * w.abs()))
    else:
        torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


def _swa_inputs(b, s, h, kv, d, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda n: torch.randn((b, s, n, d), generator=gen, device="cuda").to(
        dtype)
    return r(h), r(kv), r(kv)


@needs_cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("window", [None, 64, 1024])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("s", [100, 1000, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel_matches_plain(d, window, causal, group, s, dtype):
    """S = 100 and 1,000 are multiples of neither the bf16 kernel's 128
    query rows nor its 64 keys a block.  bf16 launches the tensor-core
    kernel, f32 the f32 one."""
    q, k, v = _swa_inputs(2, s, 2 * group, 2, d, dtype, seed=s + d)
    pos = torch.arange(s, device="cuda")
    swa_attention.reset_launches()
    with torch.no_grad():
        got = swa_attention.attention(q, k, v, causal=causal, window=window)
        again = swa_attention.attention(q, k, v, causal=causal, window=window)
        want = swa_attention.chunked_attention(q, k, v, pos, pos,
                                               causal=causal, window=window)
    torch.cuda.synchronize()
    assert swa_attention.launches == 2
    assert swa_attention.wgmma_launches == (2 if dtype == torch.bfloat16
                                            else 0)
    assert got.dtype == dtype and torch.equal(got, again)
    _assert_attention_close(got, want)


@needs_cuda
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_swa_kernel_planted_fault_is_caught(dtype, d):
    """Each kernel with the window one too wide, against the plain version
    at the true window, lands outside the bound the sound kernel keeps
    (S = 1,024, window 256): one bf16 rounding for the bf16 kernel, the f32
    tolerance for the f32 one."""
    s, window = 1024, 256
    q, k, v = _swa_inputs(1, s, 2, 1, d, dtype, seed=14)
    pos = torch.arange(s, device="cuda")
    with torch.no_grad():
        want = swa_attention.chunked_attention(q, k, v, pos, pos,
                                               causal=True, window=window)
        good = swa_attention.attention(q, k, v, causal=True, window=window)
        bad = swa_attention.attention(q, k, v, causal=True,
                                      window=window + 1)
    _assert_attention_close(good, want)
    with pytest.raises(AssertionError):
        _assert_attention_close(bad, want)


# NaN as the card makes it (0 / 0 gives 0x7fffffff) and as numpy does
NAN_BITS = [0x7FFFFFFF, 0x7FC00000]


@needs_cuda
@pytest.mark.parametrize("bits", NAN_BITS, ids=["card-nan", "qnan"])
@pytest.mark.parametrize("where", ["q", "k"])
@pytest.mark.parametrize("window", [None, 256])
def test_swa_f32_kernel_nan_lands_where_plain_has_it(window, where, bits):
    """A NaN planted in one q row (head 1) or one k row (KV head 0) of the
    f32 kernel's inputs gives NaN in exactly the outputs where
    ``chunked_attention`` has it: that query row, or the rows of the KV
    head's query heads that see that key (S = 1,000, D = 256, H = 4 over
    KV = 2)."""
    s, row = 1000, 613
    q, k, v = _swa_inputs(1, s, 4, 2, 256, torch.float32, seed=21)
    t = q if where == "q" else k
    t[0, row, 1 if where == "q" else 0, 37].view(torch.int32).fill_(bits)
    pos = torch.arange(s, device="cuda")
    with torch.no_grad():
        got = swa_attention.attention(q, k, v, causal=True, window=window)
        want = swa_attention.chunked_attention(q, k, v, pos, pos,
                                               causal=True, window=window)
    nan = torch.isnan(want)
    assert nan.any() and not nan.all()
    assert torch.equal(torch.isnan(got), nan)
    torch.testing.assert_close(got[~nan], want[~nan], atol=ATOL, rtol=RTOL)


@needs_cuda
@pytest.mark.parametrize("window", [1024, None], ids=["swa", "global"])
def test_swa_f32_kernel_at_prefill_shape(window):
    """gemma3-12b's attention shape (B = 1, S = 8,192, 16 heads over 8 KV
    heads, D = 256), both layers: the f32 kernel within the f32 tolerance
    of the plain version and bitwise repeatable."""
    s = 8192
    q, k, v = _swa_inputs(1, s, 16, 8, 256, torch.float32, seed=2)
    pos = torch.arange(s, device="cuda")
    with torch.no_grad():
        got = swa_attention.attention(q, k, v, causal=True, window=window)
        again = swa_attention.attention(q, k, v, causal=True, window=window)
        want = swa_attention.chunked_attention(q, k, v, pos, pos,
                                               causal=True, window=window)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel_head_major_signature(dtype):
    """The Pallas signature (H, S, D) reads its layout through strides."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn((4, 200, 128), generator=gen,
                           device="cuda").to(dtype) for _ in range(3))
    with torch.no_grad():
        got = swa_attention.swa_attention(q, k, v, causal=True, window=50)
        want = swa_attention.swa_attention(q.cpu(), k.cpu(), v.cpu(),
                                           causal=True, window=50)
    _assert_attention_close(got.cpu(), want)


@needs_cuda
def test_swa_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = _swa_inputs(1, 64, 2, 2, 32, torch.float32)
    with torch.no_grad():
        with pytest.raises(ValueError, match="D in"):
            swa_attention.attention(q, k, v)
        q, k, v = _swa_inputs(1, 64, 2, 2, 64, torch.float32)
        with pytest.raises(ValueError, match="is on"):
            swa_attention.attention(q, k.cpu(), v)
        with pytest.raises(ValueError, match="contiguous"):
            swa_attention.attention(q.transpose(1, 2).contiguous()
                                    .transpose(1, 2), k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        swa_attention.attention(q.requires_grad_(True), k, v)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gqa_cross_attention_kernel_matches_plain(dtype):
    """Cross-attention (reduced gemma3-12b's widths over 40 encoder states,
    S = 100 queries, and one decode query at position 17) launches the
    kernel, within the attention tolerance of the plain path on the card."""
    cfg = get_arch("gemma3_12b").reduced()
    p = init_gqa(torch.Generator(device="cuda").manual_seed(0), cfg.d_model,
                 cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, 100, cfg.d_model), generator=gen, device="cuda").to(
        dtype)
    enc = torch.randn((2, 40, cfg.d_model), generator=gen, device="cuda").to(
        dtype)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
              cross_kv=enc)
    for xs, pos in ((x, None), (x[:, :1], torch.tensor([17], device="cuda"))):
        swa_attention.reset_launches()
        with torch.no_grad():
            got = gqa_forward(p, xs, pos, **kw)
            assert swa_attention.launches == 1
            want = gqa_forward(p, xs, pos, use_kernel=False, **kw)
        scale = float(want.float().abs().max())
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=tol * scale, rtol=tol)


# the attention forms of the LM families (PERF.md section 6): MLA's
# (192, 128) causal, whisper's cross-attention (448 queries over 1,500
# frames) and its encoder (non-causal, 1,500), llama-vision's cross-
# attention (1,601 image tokens), each at fewer heads than the model's
FORMS = {
    "mla": dict(s=1000, t=1000, h=4, kv=4, d=192, dv=128, causal=True),
    "whisper_cross": dict(s=448, t=1500, h=4, kv=4, d=64, dv=64,
                          causal=False),
    "whisper_encoder": dict(s=1500, t=1500, h=4, kv=4, d=64, dv=64,
                            causal=False),
    "vision_cross": dict(s=200, t=1601, h=4, kv=1, d=128, dv=128,
                         causal=False),
    "decode_cross": dict(s=1, t=1601, h=8, kv=2, d=128, dv=128,
                         causal=False),
}


def _form_inputs(f, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda n, length, d: torch.randn((2, length, n, d), generator=gen,
                                         device="cuda").to(dtype)
    return (r(f["h"], f["s"], f["d"]), r(f["kv"], f["t"], f["d"]),
            r(f["kv"], f["t"], f["dv"]))


@needs_cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_swa_kernel_new_forms_match_plain(form, dtype):
    """D_v != D_qk and a key length of its own: each kernel within its
    tolerance of ``chunked_attention`` and bitwise repeatable."""
    f = FORMS[form]
    q, k, v = _form_inputs(f, dtype, seed=len(form))
    swa_attention.reset_launches()
    with torch.no_grad():
        got = swa_attention.attention(q, k, v, causal=f["causal"])
        again = swa_attention.attention(q, k, v, causal=f["causal"])
        want = swa_attention.chunked_attention(
            q, k, v, torch.arange(f["s"], device="cuda"),
            torch.arange(f["t"], device="cuda"), causal=f["causal"],
            window=None)
    torch.cuda.synchronize()
    assert swa_attention.launches == 2
    assert got.shape == (2, f["s"], f["h"], f["dv"]) and got.dtype == dtype
    assert torch.equal(got, again)
    _assert_attention_close(got, want)


@needs_cuda
def test_swa_kernel_new_forms_planted_fault_is_caught():
    """A cross-attention whose keys are cut one short (T - 1) lands
    outside the bound the sound kernel keeps, in both dtypes."""
    f = FORMS["whisper_cross"]
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _form_inputs(f, dtype, seed=3)
        with torch.no_grad():
            want = swa_attention.attention(q.cpu(), k.cpu(), v.cpu(),
                                           causal=False)
            bad = swa_attention.attention(q, k[:, :-1].contiguous(),
                                          v[:, :-1].contiguous(),
                                          causal=False)
        with pytest.raises(AssertionError):
            _assert_attention_close(bad.cpu(), want)


@needs_cuda
def test_swa_kernel_refuses_uncompiled_forms():
    """Widths outside the compiled set and a causal T != S raise
    ``ValueError`` on the card: no padding, no plain fallback."""
    for d, dv in ((128, 64), (48, 32), (192, 192), (96, 96)):
        q, k, _ = _form_inputs(dict(s=64, t=64, h=2, kv=2, d=d, dv=d),
                               torch.bfloat16, 0)
        v = torch.zeros(k.shape[:3] + (dv,), device="cuda",
                        dtype=torch.bfloat16)
        with torch.no_grad(), pytest.raises(ValueError, match="D in"):
            swa_attention.attention(q, k, v, causal=False)
    q, k, v = _form_inputs(dict(s=64, t=80, h=2, kv=2, d=64, dv=64),
                           torch.float32, 0)
    with torch.no_grad(), pytest.raises(ValueError, match="causal"):
        swa_attention.attention(q, k, v, causal=True)


@needs_cuda
@pytest.mark.parametrize("aid", ["olmoe_1b_7b", "deepseek_v2_lite_16b",
                                 "granite_20b", "whisper_small",
                                 "llama_3_2_vision_11b"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_family_forward_kernel_path_matches_plain_on_card(aid, dtype):
    """Each family's reduced config (MLA at deepseek-v2-lite's compiled
    widths, 128 + 64 / 128) at S = 192: one launch per self-, encoder and
    cross-attention, logits within 1e-4 of the largest |logit| of the plain
    path in f32 and within relative L2 0.1 in bf16 (DESIGN.md section
    9.3's bf16 bound: a bf16 rounding may tip a token's MoE routing, which
    moves that token's logits further than an elementwise bound allows);
    decode launches once per cross layer."""
    from repro_torch.archs.config import MLASpec

    cfg = get_arch(aid).reduced()
    if cfg.mla is not None:
        cfg = dataclasses.replace(cfg, mla=MLASpec(kv_lora=64, d_nope=128,
                                                   d_rope=64, d_v=128))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm_model.init_arch(gen, cfg, device="cuda", dtype=dtype)
    tok = torch.randint(0, cfg.vocab, (2, 192), device="cuda", generator=gen)
    mod = {}
    if cfg.has_encoder:
        mod["audio"] = torch.randn((2, cfg.n_audio_frames, cfg.d_model),
                                   generator=gen, device="cuda")
    elif cfg.cross_attn_every:
        mod["images"] = torch.randn((2, cfg.n_image_tokens, cfg.d_model),
                                    generator=gen, device="cuda")
    n_cross = sum(cfg.has_cross(i) for i in range(cfg.n_layers))
    swa_attention.reset_launches()
    with torch.no_grad():
        got, aux = lm_model.forward(params, cfg, tok, dtype=dtype, **mod)
        n = swa_attention.launches
        want, aux_plain = lm_model.forward(params, cfg, tok, dtype=dtype,
                                           use_kernel=False, **mod)
        enc = (lm_model.encode_audio(params, cfg, mod["audio"], dtype)
               if "audio" in mod else mod.get("images"))
        cache = lm_model.init_cache(cfg, 2, 8, enc_out=enc, dtype=dtype,
                                    device="cuda")
        swa_attention.reset_launches()
        lm_model.decode_step(params, cfg, cache, tok[:, 0],
                             torch.zeros(2, dtype=torch.int32, device="cuda"),
                             dtype=dtype)
    torch.cuda.synchronize()
    assert n == cfg.n_layers + cfg.encoder_layers + n_cross
    assert swa_attention.launches == n_cross
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=1e-4)
        torch.testing.assert_close(aux, aux_plain, atol=1e-5, rtol=0)
    else:
        rel = float((got - want).norm() / want.norm())
        assert rel <= 0.1, rel


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lm_recurrent_forward_launches_once_per_shared_layer(dtype):
    """Reduced zamba2-1.2b stretched to 4 layers (Mamba2, shared, Mamba2,
    shared) at S = 64 (4 SSD chunks of 16): #7 launches once per shared
    layer (the tensor-core kernel in bf16), logits within 1e-4 of the
    largest |logit| of the plain path in f32 and within relative L2 0.1 in
    bf16; decode launches nothing.  Reduced xlstm-125m launches nothing."""
    base = get_arch("zamba2_1_2b").reduced()
    cfg = dataclasses.replace(base, n_layers=4, blocks=base.blocks * 2,
                              ffns=base.ffns * 2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = lm_model.init_arch(gen, cfg, device="cuda", dtype=dtype)
    tok = torch.randint(0, cfg.vocab, (2, 64), device="cuda", generator=gen)
    swa_attention.reset_launches()
    with torch.no_grad():
        got, _ = lm_model.forward(params, cfg, tok, dtype=dtype)
        n, n_wgmma = swa_attention.launches, swa_attention.wgmma_launches
        want, _ = lm_model.forward(params, cfg, tok, dtype=dtype,
                                   use_kernel=False)
        cache = lm_model.init_cache(cfg, 2, 8, dtype=dtype, device="cuda")
        swa_attention.reset_launches()
        lm_model.decode_step(params, cfg, cache, tok[:, 0],
                             torch.zeros(2, dtype=torch.int32, device="cuda"),
                             dtype=dtype)
        n_decode = swa_attention.launches
        x_cfg = get_arch("xlstm_125m").reduced()
        x_params = lm_model.init_arch(gen, x_cfg, device="cuda", dtype=dtype)
        swa_attention.reset_launches()
        x_out, _ = lm_model.forward(x_params, x_cfg, tok[:, :16], dtype=dtype)
    torch.cuda.synchronize()
    assert n == cfg.blocks.count("shared_attn") == 2
    assert n_wgmma == (n if dtype == torch.bfloat16 else 0)
    assert n_decode == 0 and swa_attention.launches == 0
    assert torch.isfinite(x_out).all()
    got, want = got.float(), want.float()
    if dtype == torch.float32:
        scale = float(want.abs().max())
        torch.testing.assert_close(got, want, atol=1e-4 * scale, rtol=1e-4)
    else:
        rel = float((got - want).norm() / want.norm())
        assert rel <= 0.1, rel


@needs_cuda
def test_lm_inits_default_to_the_card():
    """With no ``device`` the LM's weights and caches land on the card,
    drawn from a CPU generator as from a CUDA one."""
    cfg = get_arch("gemma3_12b").reduced()
    for gen in (torch.Generator(), torch.Generator(device="cuda")):
        params = lm_model.init_arch(gen.manual_seed(0), cfg)
        leaves = [params["embed"], params["final_norm"]["scale"],
                  params["layers"][0]["attn"]["wq"],
                  params["layers"][0]["ffn"]["w_up"], params["vt"][0]["w_read"]]
        assert all(t.device.type == "cuda" for t in leaves)
    cache = lm_model.init_cache(cfg, 1, 4)
    assert cache.vt.device.type == "cuda"
    assert all(c["kv"].k.device.type == "cuda" for c in cache.layers)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_kv", [4, 2])
def test_lm_forward_kernel_path_matches_plain_on_card(n_kv, dtype):
    """Reduced gemma3-12b (SWA then global layer) at S = 192 > 2 x window:
    one launch per layer (of the tensor-core kernel in bf16), logits within
    1e-4 of the largest |logit| of the plain attention path in f32 and
    within 2e-2 in bf16 (the reference's own bf16 tolerance); decode
    launches nothing."""
    cfg = dataclasses.replace(get_arch("gemma3_12b").reduced(),
                              n_kv_heads=n_kv)
    params = lm_model.init_arch(torch.Generator(device="cuda").manual_seed(0),
                                cfg, device="cuda", dtype=dtype)
    tok = torch.randint(0, cfg.vocab, (2, 192), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(1))
    swa_attention.reset_launches()
    with torch.no_grad():
        got, _ = lm_model.forward(params, cfg, tok, dtype=dtype)
        n, n_wgmma = swa_attention.launches, swa_attention.wgmma_launches
        want, _ = lm_model.forward(params, cfg, tok, dtype=dtype,
                                   use_kernel=False)
        cache = lm_model.init_cache(cfg, 2, 8, device="cuda")
        lm_model.decode_step(params, cfg, cache, tok[:, 0],
                             torch.zeros(2, dtype=torch.int32, device="cuda"))
    torch.cuda.synchronize()
    assert n == cfg.n_layers and swa_attention.launches == n
    assert n_wgmma == (n if dtype == torch.bfloat16 else 0)
    got, want = got.float(), want.float()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, atol=tol * scale, rtol=tol)


# ------------------------------------- the identity gate (RF, SchNet), #1/#2
def _identity_args(dev, dh, seed=17, n=301):
    """The hub graph of the backward tests (a 200-edge hub receiver and
    sender, n not a multiple of 64) with identity-gate weights: Dh = 1
    (RF: a zero feature column and zero W1r / W1s) or 64 (SchNet), H1 =
    64, M = 1."""
    args = _hub_edge_bwd_args(dev, n=n, seed=seed)[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: 0.3 * torch.randn(s, generator=gen, device=dev)
    if dh == 1:
        h = torch.zeros(n, 1, device=dev)
        w1r = w1s = torch.zeros(1, WIDTH, device=dev)
    else:
        h, w1r, w1s = r(n, dh) / 0.3, r(dh, WIDTH), r(dh, WIDTH)
    z11 = torch.zeros(1, 1, device=dev)
    return [args[0], h, args[2], args[3], args[4], w1r, w1s, r(1, WIDTH),
            r(1, WIDTH), r(WIDTH, 1), r(1, 1), z11, z11, z11]


def _identity_bwd(dev, dh, rel, clamp, seed=17):
    args = _identity_args(dev, dh, seed)
    if clamp == "binds":
        clamp = _binding_clamp(args)
    kw = dict(gate_mode="identity", rel_mode=rel, clamp=clamp)
    n = args[0].shape[0]
    with torch.no_grad():
        deg = edge_message.edge_pathway_plain(*args, **kw)[2].contiguous()
    indptr = args[4].cpu().numpy()
    sender = _sender_perm(args[2].cpu().numpy(), int(indptr[-1]), n, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    g_dx = torch.randn((n, 3), generator=gen, device=dev)
    g_mh = torch.randn((n, 1), generator=gen, device=dev)
    return args, sender, deg, g_dx, g_mh, kw


def _identity_msgs(args):
    """Every live edge's message (the identity gate before the clip)."""
    x, h, snd, em, indptr, w1r, w1s, w1d, b1, w2, b2 = args[:11]
    e = int(indptr[-1])
    rcv = edge_message.csr_receivers(indptr)
    snd = snd[:e].long()
    d2 = ((x[rcv] - x[snd]) ** 2).sum(-1, keepdim=True)
    pre = h[rcv] @ w1r + h[snd] @ w1s + d2 * w1d + b1
    msg = torch.nn.functional.silu(pre) @ w2 + b2
    return msg[em[:e] != 0]


def _binding_clamp(args) -> float:
    """A clamp inside the widest gap between the middle half of the live
    edges' sorted |msg|: it binds on some edges, not on others, and no
    edge sits within rounding of it."""
    m = torch.sort(_identity_msgs(args).abs().flatten()).values
    mid = m[m.numel() // 4: 3 * m.numel() // 4]
    i = int(torch.argmax(torch.diff(mid)))
    return float((mid[i] + mid[i + 1]) / 2)


IDENTITY_CASES = [(1, "inv1p", math.inf), (1, "inv1p", "binds"),
                  (64, "raw", math.inf), (64, "raw", "binds"),
                  (64, "inv1p", "binds"), (1, "raw", "binds")]


@needs_cuda
@pytest.mark.parametrize("dh,rel,clamp", IDENTITY_CASES)
def test_identity_edge_kernels_match_plain(dh, rel, clamp):
    """Forward and backward of the identity gate against their plain
    versions: RF's form (Dh = 1, inv1p) and SchNet's (Dh = 64, raw), a
    clamp that binds and one that does not, bitwise repeats, 1 forward
    and 1 backward launch counted apart from the mlp kernels'."""
    dev = torch.device("cuda")
    args, sender, deg, g_dx, g_mh, kw = _identity_bwd(dev, dh, rel, clamp)
    edge_message.reset_launches()
    with torch.no_grad():
        got = edge_message.edge_pathway_fused(*args, **kw)
        again = edge_message.edge_pathway_fused(*args, **kw)
        want = edge_message.edge_pathway_plain(*args, **kw)
    bwd = lambda: edge_message.edge_pathway_bwd_fused(
        *args[:5], *sender, *args[5:], deg, g_dx, g_mh, **kw)
    gk, gk2 = bwd(), bwd()
    gp = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh, **kw)
    torch.cuda.synchronize()
    assert edge_message.identity_launches == 2
    assert edge_message.identity_bwd_launches == 2
    assert edge_message.launches == edge_message.bwd_launches == 0
    _assert_matches(got, again, want)
    _assert_grads_match(gk, gk2, gp)
    if clamp == "binds":  # on some live edges, not all
        msg = _identity_msgs(args).abs()
        assert bool((msg > kw["clamp"]).any())
        assert bool((msg < kw["clamp"]).any())


@needs_cuda
@pytest.mark.parametrize("n_ctas", [1, 3, 64, 1000])
@pytest.mark.parametrize("dh", [1, 64])
def test_identity_edge_kernels_cta_count_does_not_change_a_bit(
        monkeypatch, dh, n_ctas):
    """Each receiver row is summed in slot order by one thread (the
    forward's tile pass) or one warp (the row passes) and every gradient in
    an order fixed by the inputs: any CTA count gives the same bits."""
    dev = torch.device("cuda")
    args, sender, deg, g_dx, g_mh, kw = _identity_bwd(dev, dh, "inv1p", "binds")
    run = lambda: (edge_message.edge_pathway_fused(*args, **kw),
                   edge_message.edge_pathway_bwd_fused(
                       *args[:5], *sender, *args[5:], deg, g_dx, g_mh, **kw))
    with torch.no_grad():
        ref_f, ref_b = run()
        monkeypatch.setattr(edge_message, "IDENTITY_CTAS", n_ctas)
        got_f, got_b = run()
    torch.cuda.synchronize()
    for a, b in zip(ref_f + ref_b, got_f + got_b):
        assert torch.equal(a, b)


@needs_cuda
@pytest.mark.parametrize("dh", [1, 64])
def test_identity_edge_kernels_planted_fault_is_caught(dh):
    """One live slot's mask zeroed in the kernels' calls only lands
    outside the forward and the gradient tolerance."""
    dev = torch.device("cuda")
    args, sender, deg, g_dx, g_mh, kw = _identity_bwd(dev, dh, "inv1p", "binds")
    with torch.no_grad():
        want = edge_message.edge_pathway_plain(*args, **kw)
    gp = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh, **kw)
    em = args[3].clone()
    live = torch.nonzero(em).flatten()
    em[live[live.numel() // 2]] = 0.0
    bad = [*args[:3], em, *args[4:]]
    with torch.no_grad():
        got = edge_message.edge_pathway_fused(*bad, **kw)
    gk = edge_message.edge_pathway_bwd_fused(*bad[:5], *sender, *bad[5:],
                                             deg, g_dx, g_mh, **kw)
    torch.cuda.synchronize()
    assert _outside_values_tolerance(got, want)
    assert _outside_tolerance(gk, gp)


@needs_cuda
def test_identity_edge_kernels_keep_nan_computed_on_card():
    """NaN rows of h (SchNet's form) give NaN exactly where the plain
    versions have it, forward and backward."""
    dev = torch.device("cuda")
    args, sender, deg, g_dx, g_mh, kw = _identity_bwd(dev, 64, "raw", "binds")
    args[1] = _card_nan_rows(args[1], _live_nodes(args, dev))
    with torch.no_grad():
        got = edge_message.edge_pathway_fused(*args, **kw)
        want = edge_message.edge_pathway_plain(*args, **kw)
    _assert_same_nans(got, want)
    gk = edge_message.edge_pathway_bwd_fused(*args[:5], *sender, *args[5:],
                                             deg, g_dx, g_mh, **kw)
    gp = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh, **kw)
    _assert_same_nans(gk, gp)


ZOO = ("linear", "mpnn", "egnn", "rf", "schnet", "tfn", "fast_egnn",
       "fast_rf", "fast_schnet", "fast_tfn")
ZOO_DISPATCH = {  # one forward of 2 layers with use_kernel=True
    "linear": {}, "tfn": {}, "mpnn": {"edge_kernel": 2},
    "egnn": {"edge_kernel": 2}, "rf": {"edge_kernel": 2},
    "schnet": {"edge_kernel": 2},
    "fast_egnn": {"edge_kernel": 2, "virtual_kernel": 2},
    "fast_schnet": {"edge_kernel": 2, "virtual_kernel": 2},
    "fast_rf": {"edge_kernel": 2, "virtual_plain": 2},
    "fast_tfn": {"virtual_kernel": 2}}


@needs_cuda
@pytest.mark.parametrize("name", ZOO)
def test_zoo_kernel_path_matches_plain_path_on_card(name):
    """Each registry model at full width (2 layers, hidden 64) on the
    card: the reference's dispatch, exactly; coordinates, and the
    gradients of a loss of them, against the plain path; the identity
    kernels launch once a layer in each direction for RF and SchNet."""
    from repro_torch.core import message_passing as mp
    from repro_torch.training.optim import tree_leaves, tree_map

    dev = torch.device("cuda")
    x, sp, rp, em, indptr, n_edges = _graph(n=400, cap=16000, seed=9)
    n_cap = 512
    xp, nm = pad_nodes(x, n_cap)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    rng = np.random.default_rng(2)
    g = GeometricGraph(x=t(xp), v=t(0.01 * rng.standard_normal(
                           (n_cap, 3)).astype(np.float32)),
                       h=t(nm[:, None].copy()), senders=t(sp),
                       receivers=t(rp),
                       edge_attr=torch.zeros(sp.size, 0, device=dev),
                       node_mask=t(nm), edge_mask=t(em))
    lay = (t(csr_indptr(rp, n_edges, n_cap)), n_edges,
           *_sender_perm(sp, n_edges, n_cap, dev))
    kw = {} if name == "linear" else dict(n_layers=2)
    pk = build_pipeline(name, device=dev, use_kernel=True,
                        generator=torch.Generator().manual_seed(4), **kw)
    pp = build_pipeline(name, device=dev, params=pk.params, **kw)
    target = g.x + 0.01

    def run(p, layout):
        work = tree_map(lambda a: a.detach().requires_grad_(True), p.params)
        leaves = tree_leaves(work)
        xo, _ = p.apply_full(work, p.cfg, g, edge_layout=layout)
        loss = (((xo - target) ** 2).sum(-1) * g.node_mask).mean()
        out = torch.autograd.grad(loss, leaves, allow_unused=True)
        return xo.detach(), [torch.zeros_like(a) if o is None else o
                             for o, a in zip(out, leaves)]

    edge_message.reset_launches()
    mp.reset_dispatch_counts()
    xk, gk = run(pk, lay)
    assert mp.dispatch_counts() == ZOO_DISPATCH[name]
    identity = name in ("rf", "fast_rf", "schnet", "fast_schnet")
    assert edge_message.identity_launches == (2 if identity else 0)
    assert edge_message.identity_bwd_launches == (2 if identity else 0)
    xr, gr = run(pp, None)
    torch.cuda.synchronize()
    scale = float(xr.abs().max())
    assert float((xk - xr).abs().max()) <= 1e-4 * max(scale, 1.0)
    keep = [i for i, w in enumerate(gr) if w.numel()]  # FastRF's S is 0-wide
    _assert_grads_match([gk[i] for i in keep], [gk[i] for i in keep],
                        [gr[i] for i in keep])


# ------------------------------------------------------------- widths
# widths (Dh, H1, M) the reference's dispatch sends to its kernels: the
# compiled ones, ones padded up to them, and panel-path ones above 64
CUDA_WIDTHS = [(16, 16, 16), (24, 24, 24), (32, 32, 32), (48, 48, 48),
               (24, 40, 56), (96, 96, 96), (128, 128, 128), (200, 150, 100)]


def _width_args(dev, dh, h1, m, seed=5):
    """The 300-node test graph with random weights of widths (Dh, H1, M)
    for gate 'mlp', its sender permutation and its live slot count."""
    x, sp, _, em, indptr, n_edges = _graph(seed=seed)
    n = x.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)
    t = lambda a: torch.from_numpy(a).to(dev)
    sc1 = (2 * dh + 1) ** -0.5
    ws = [r(dh, h1, sc=sc1), r(dh, h1, sc=sc1), r(1, h1, sc=0.3), r(1, h1, sc=0.1), r(h1, m, sc=h1 ** -0.5),
          r(1, m, sc=0.1), r(m, h1, sc=m ** -0.5), r(1, h1, sc=0.1),
          r(h1, 1, sc=h1 ** -0.5)]
    args = [t(x), r(n, dh), t(sp), t(em), t(indptr), *ws]
    return args, _sender_perm(sp, n_edges, n, dev), n_edges


def _one_slot_masked(args, n_edges):
    """The arguments with one live slot's mask zeroed (a planted fault)."""
    em = args[3]
    live = torch.nonzero(em[:n_edges]).flatten()
    bad = em.clone()
    bad[live[live.numel() // 2]] = 0.0
    return [*args[:3], bad, *args[4:]]


@needs_cuda
@pytest.mark.parametrize("dh,h1,m", CUDA_WIDTHS,
                         ids=["-".join(map(str, w)) for w in CUDA_WIDTHS])
def test_kernels_refuse_unsupported_widths_and_modes(dh, h1, m):
    """Every width runs on the card: the edge pair (#1, #2) with its gate,
    the identity pair in SchNet's form (Dh, H1) and RF's (Dh = 1), and the
    virtual pair (#3, #4) at Dh, hid = H1, each against its plain version,
    bitwise repeatable, with a planted fault (one live slot's mask zeroed,
    one node's mask flipped) outside the tolerance; the route taken is the
    one ``kernel_route`` names."""
    dev = torch.device("cuda")
    args, sender, n_edges = _width_args(dev, dh, h1, m)
    n = args[0].shape[0]
    bad = _one_slot_masked(args, n_edges)
    gen = torch.Generator(device=dev).manual_seed(1)
    route = edge_message.kernel_route(dh, h1, m)
    edge_message.reset_launches()
    virtual_message.reset_launches()
    with torch.no_grad():
        kw = dict(gate_mode="mlp", rel_mode="inv1p", clamp=0.05)
        run = lambda a: edge_message.edge_pathway_fused(*a, **kw)
        want = edge_message.edge_pathway_plain(*args, **kw)
        _assert_matches(run(args), run(args), want)
        assert _outside_values_tolerance(run(bad), want)
        deg = want[2].contiguous()
        cots = (torch.randn((n, 3), generator=gen, device=dev),
                torch.randn((n, m), generator=gen, device=dev))
        brun = lambda a: edge_message.edge_pathway_bwd_fused(
            *a[:5], *sender, *a[5:], deg, *cots, **kw)
        bwant = edge_message.edge_pathway_bwd_plain(*args, *cots, **kw)
        _assert_grads_match(brun(args), brun(args), bwant)
        assert _outside_tolerance(brun(bad), bwant)
        assert edge_message.route_launches == {route: 6}
        # the identity pair: SchNet's form and RF's (a zero column)
        z11 = torch.zeros(1, 1, device=dev)
        for form_dh in (dh, 1):
            h = args[1] if form_dh == dh else torch.zeros(n, 1, device=dev)
            ia = [args[0], h, *args[2:5],
                  torch.randn((form_dh, h1), generator=gen, device=dev),
                  torch.randn((form_dh, h1), generator=gen, device=dev),
                  args[7], args[8],
                  0.3 * torch.randn((h1, 1), generator=gen, device=dev),
                  z11, z11, z11, z11]
            ikw = dict(gate_mode="identity",
                       rel_mode="raw" if form_dh == dh else "inv1p",
                       clamp=100.0)
            irun = lambda a: edge_message.edge_pathway_fused(*a, **ikw)
            iwant = edge_message.edge_pathway_plain(*ia, **ikw)
            _assert_matches(irun(ia), irun(ia), iwant)
            ibad = _one_slot_masked(ia, n_edges)
            assert _outside_values_tolerance(irun(ibad), iwant)
            g_mh = torch.randn((n, 1), generator=gen, device=dev)
            ideg = iwant[2].contiguous()
            ibrun = lambda a: edge_message.edge_pathway_bwd_fused(
                *a[:5], *sender, *a[5:], ideg, cots[0], g_mh, **ikw)
            _assert_grads_match(ibrun(ia), ibrun(ia),
                                edge_message.edge_pathway_bwd_plain(
                                    *ia, cots[0], g_mh, **ikw))
        # the virtual pair at Dh = dh, hid = h1
        c = 3
        r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)
        vargs = [args[0], args[1], args[0][:c] + 0.05 * r(c, 3),
                 (r(n) > -1.2).float(), r(c, dh, h1, sc=dh ** -0.5),
                 r(c, h1, sc=0.3), r(c, h1, sc=0.3),
                 r(c, h1, h1, sc=h1 ** -0.5), r(c, h1, sc=0.1),
                 r(c, h1, h1, sc=h1 ** -0.5), r(c, h1, sc=0.1),
                 r(c, h1, 1, sc=h1 ** -0.5), r(c, h1, h1, sc=h1 ** -0.5),
                 r(c, h1, sc=0.1), r(c, h1, 1, sc=h1 ** -0.5)]
        vbad = list(vargs)
        vbad[3] = vargs[3].clone()
        vbad[3][0] = 1.0 - vbad[3][0]
        vrun = lambda a: virtual_message.virtual_pathway_fused(*a)
        vwant = virtual_message.virtual_pathway_plain(*vargs)
        _assert_matches(vrun(vargs), vrun(vargs), vwant)
        assert _outside_values_tolerance(vrun(vbad), vwant)
        vcots = (r(n, 3), r(n, h1), r(c, 3), r(c, h1))
        vbrun = lambda a: virtual_message.virtual_pathway_bwd_fused(
            *a, *vcots)
        vbwant = virtual_message.virtual_pathway_bwd_plain(*vargs, *vcots)
        _assert_grads_match(vbrun(vargs), vbrun(vargs), vbwant)
        assert _outside_tolerance(vbrun(vbad), vbwant)
        assert virtual_message.route_launches == {
            edge_message.kernel_route(dh, h1): 6}


@needs_cuda
@pytest.mark.parametrize("dh", [1, 800], ids=["rf", "schnet"])
def test_identity_wider_than_its_kernels_takes_the_panel_path(dh):
    """An identity-gate layer wider than the identity kernels' 768 columns
    (the reference admits H1 = 800 at 300 nodes) runs the panel path, with
    the message's column as the gate: against the plain versions, forward
    and backward, repeatable."""
    from repro_torch.core import message_passing as mp

    dev = torch.device("cuda")
    h1 = 800
    args, sender, n_edges = _width_args(dev, 1, h1, 1)
    n = args[0].shape[0]
    gen = torch.Generator(device=dev).manual_seed(2)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)
    h = r(n, dh) if dh > 1 else torch.zeros(n, 1, device=dev)
    z11 = torch.zeros(1, 1, device=dev)
    ia = [args[0], h, *args[2:5], r(dh, h1, sc=dh ** -0.5),
          r(dh, h1, sc=dh ** -0.5), r(1, h1, sc=0.3), r(1, h1, sc=0.1),
          r(h1, 1, sc=h1 ** -0.5), z11, z11, z11, z11]
    kw = dict(gate_mode="identity", rel_mode="inv1p" if dh == 1 else "raw",
              clamp=100.0)
    lp = {"phi1": [{"w": torch.zeros(2 * (dh if dh > 1 else 0) + 1, h1)},
                   {"w": torch.zeros(h1, 1)}]}
    g = GeometricGraph(x=args[0], v=None, h=h, senders=None, receivers=None,
                       edge_attr=torch.zeros(0, 0), node_mask=None,
                       edge_mask=None)
    assert mp.kernel_supported(lp, g, EdgeSpec(gate="identity",
                                               use_h=dh > 1))
    edge_message.reset_launches()
    with torch.no_grad():
        run = lambda: edge_message.edge_pathway_fused(*ia, **kw)
        want = edge_message.edge_pathway_plain(*ia, **kw)
        _assert_matches(run(), run(), want)
        deg = want[2].contiguous()
        cots = (r(n, 3), r(n, 1))
        brun = lambda: edge_message.edge_pathway_bwd_fused(
            *ia[:5], *sender, *ia[5:], deg, *cots, **kw)
        _assert_grads_match(brun(), brun(),
                            edge_message.edge_pathway_bwd_plain(*ia, *cots,
                                                                **kw))
    assert edge_message.route_launches == {"panel": 4}
    assert edge_message.identity_launches == 0


# ------------------------------------------------------------- bf16 mode
# The bf16 mode of #1-#4 and the identity pair (precision='bf16': bf16
# operands of every product, f32 sums) against the bf16 plain versions
# (kernels.ref.*_bf16): per output relative L2 <= 1e-3 (the two round the
# same values; a different f32 summation order may tip a rounding), the
# kernel repeatable bitwise, and engaged: some output >= 1e-4 (relative
# L2) away from the f32 kernel's.
BF_L2, BF_ENGAGED = 1e-3, 1e-4


def _rel_l2(a, b):
    d = float(torch.linalg.vector_norm((a - b).double()))
    return d / max(float(torch.linalg.vector_norm(b.double())), 1e-30)


def _assert_bf16(got, again, want, f32):
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape
        assert torch.equal(g, a)
        if w.numel() and float(w.abs().max()) > 0:
            assert _rel_l2(g, w) <= BF_L2
    assert max(_rel_l2(g, f) for g, f in zip(got, f32) if f.numel()) \
        >= BF_ENGAGED


def _bf16_edge_case(dev, form, width):
    """(args, sender, kw): the test graph at ``width`` in FastEGNN's form
    (gate 'mlp'), SchNet's identity form (Dh = H1 = width) or RF's (Dh =
    1, inv1p)."""
    if form == "mlp":
        args, sender, _ = _width_args(dev, width, width, width)
        return args, sender, dict(gate_mode="mlp", rel_mode="raw",
                                  clamp=100.0)
    dh = width if form == "schnet" else 1
    args, sender, _ = _width_args(dev, dh, width, 1)
    if form == "rf":
        args[1] = torch.zeros_like(args[1])
    args[11:14] = [torch.zeros(1, 1, device=dev)] * 3
    return args, sender, dict(gate_mode="identity",
                              rel_mode="raw" if form == "schnet" else "inv1p",
                              clamp=100.0)


@needs_cuda
@pytest.mark.parametrize("width", [24, 32, 48, 64, 128])
@pytest.mark.parametrize("form", ["mlp", "schnet", "rf"])
def test_edge_kernels_bf16_match_plain_bf16(form, width):
    """#1 and #2 (and the identity pair) in bf16 on every route: the
    compiled widths, padded ones and the panel path."""
    dev = torch.device("cuda")
    args, sender, kw = _bf16_edge_case(dev, form, width)
    n = args[0].shape[0]
    m = args[9].shape[1]
    gen = torch.Generator(device=dev).manual_seed(width)
    g_dx = torch.randn((n, 3), generator=gen, device=dev)
    g_mh = torch.randn((n, m), generator=gen, device=dev)
    edge_message.reset_launches()
    with torch.no_grad():
        run = lambda p: edge_message.edge_pathway_fused(*args, **kw,
                                                        precision=p)
        got, again, f32 = run("bf16"), run("bf16"), run("f32")
        want = edge_message.edge_pathway_plain(*args, **kw, precision="bf16")
        _assert_bf16(got, again, want, f32)
        deg = want[2].contiguous()
        brun = lambda p: edge_message.edge_pathway_bwd_fused(
            *args[:5], *sender, *args[5:], deg, g_dx, g_mh, **kw, precision=p)
        gk, gk2, g32 = brun("bf16"), brun("bf16"), brun("f32")
        gp = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh, deg=deg,
                                                 **kw, precision="bf16")
        _assert_bf16(gk, gk2, gp, g32)
    assert edge_message.precision_launches == {"bf16": 4, "f32": 2}


@needs_cuda
@pytest.mark.parametrize("width", [24, 32, 64, 128])
def test_virtual_kernels_bf16_match_plain_bf16(width):
    dev = torch.device("cuda")
    args, cots = _virtual_bf16_args(dev, width)
    virtual_message.reset_launches()
    with torch.no_grad():
        run = lambda p: virtual_message.virtual_pathway_fused(*args,
                                                              precision=p)
        _assert_bf16(run("bf16"), run("bf16"), virtual_message.
                     virtual_pathway_plain(*args, precision="bf16"),
                     run("f32"))
        brun = lambda p: virtual_message.virtual_pathway_bwd_fused(
            *args, *cots, precision=p)
        _assert_bf16(brun("bf16"), brun("bf16"),
                     virtual_message.virtual_pathway_bwd_plain(
                         *args, *cots, precision="bf16"), brun("f32"))
    assert virtual_message.precision_launches == {"bf16": 4, "f32": 2}


@needs_cuda
@pytest.mark.parametrize("form", ["mlp", "schnet"])
def test_bf16_padded_width_equals_unpadded_bitwise(form):
    """Width 24 (the wrapper pads it to the compiled 32) against the same
    call zero-padded to 32 by hand: bitwise equal, forward and backward
    (a zero row or column adds +0, and bf16(0) = 0)."""
    _assert_padded_equals_unpadded(form, "bf16")


def _assert_padded_equals_unpadded(form, precision):
    """The edge pair in ``form`` at width 24 against the same call
    zero-padded to 32 by hand, in ``precision``: bitwise equal, forward
    and backward."""
    from repro_torch.kernels.runtime import pad_to

    dev = torch.device("cuda")
    args, sender, kw = _bf16_edge_case(dev, form, 24)
    kw["precision"] = precision
    n = args[0].shape[0]
    dh, h1, m = args[1].shape[1], args[5].shape[1], args[9].shape[1]
    d, hp, mp = 32 if dh > 1 else 1, 32, 32 if m > 1 else 1
    padded = [args[0], pad_to(args[1], n, d), *args[2:5],
              pad_to(args[5], d, hp), pad_to(args[6], d, hp),
              pad_to(args[7], 1, hp), pad_to(args[8], 1, hp),
              pad_to(args[9], hp, mp), pad_to(args[10], 1, mp)]
    if form == "mlp":
        padded += [pad_to(args[11], mp, hp), pad_to(args[12], 1, hp),
                   pad_to(args[13], hp, 1)]
    else:
        padded += args[11:14]
    gen = torch.Generator(device=dev).manual_seed(3)
    g_dx = torch.randn((n, 3), generator=gen, device=dev)
    g_mh = torch.randn((n, m), generator=gen, device=dev)
    with torch.no_grad():
        a = edge_message.edge_pathway_fused(*args, **kw)
        b = edge_message.edge_pathway_fused(*padded, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
        assert torch.equal(a[1], b[1][:, :m])
        deg = a[2].contiguous()
        ga = edge_message.edge_pathway_bwd_fused(
            *args[:5], *sender, *args[5:], deg, g_dx, g_mh, **kw)
        gb = edge_message.edge_pathway_bwd_fused(
            *padded[:5], *sender, *padded[5:], deg, g_dx,
            pad_to(g_mh, n, mp), **kw)
    for x, y in zip(ga, gb):
        assert torch.equal(x, y[tuple(slice(0, k) for k in x.shape)])


@needs_cuda
def test_bf16_kernels_keep_nan():
    """A NaN in h passes the bf16 rounding as a NaN (cvt.rn.bf16 keeps
    it): the bf16 kernels' outputs are NaN exactly where the bf16 plain
    versions' are, forward and backward."""
    dev = torch.device("cuda")
    args, sender, kw = _bf16_edge_case(dev, "mlp", 64)
    kw["precision"] = "bf16"
    args[1] = args[1].clone()
    args[1][7, 3] = float("nan")
    n = args[0].shape[0]
    gen = torch.Generator(device=dev).manual_seed(4)
    g_dx = torch.randn((n, 3), generator=gen, device=dev)
    g_mh = torch.randn((n, 64), generator=gen, device=dev)
    with torch.no_grad():
        got = edge_message.edge_pathway_fused(*args, **kw)
        want = edge_message.edge_pathway_plain(*args, **kw)
        deg = want[2].contiguous()
        gk = edge_message.edge_pathway_bwd_fused(
            *args[:5], *sender, *args[5:], deg, g_dx, g_mh, **kw)
        gp = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh, deg=deg,
                                                 **kw)
    for g, w in list(zip(got, want)) + list(zip(gk, gp)):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
    assert bool(torch.isnan(got[1]).any())
    v = [args[0], args[1]] + _virtual_args(dev)[2:]
    v[0], v[1] = v[0][:300], v[1][:300].clone()
    v[3] = v[3][:300]
    with torch.no_grad():
        vg = virtual_message.virtual_pathway_fused(*v, precision="bf16")
        vw = virtual_message.virtual_pathway_plain(*v, precision="bf16")
    for g, w in zip(vg, vw):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
    assert bool(torch.isnan(vg[1]).any())


@needs_cuda
@pytest.mark.parametrize("hidden", [32, 64])
def test_fast_egnn_bf16_launch_counts_and_close_to_f32(hidden):
    """FastEGNN with precision='bf16' on the card: every FastEGNN kernel
    call in bf16 (and none in f32), its coordinates within relative L2
    0.1 of the f32 kernel path's; with use_kernel=False bitwise the f32
    plain path (the precision is the kernels' only)."""
    from repro_torch.core import message_passing as mp

    dev = torch.device("cuda")
    x, sp, rp, em, indptr, n_edges = _graph()
    n = x.shape[0]
    t = lambda a: torch.from_numpy(a).to(dev)
    g = GeometricGraph(x=t(x), v=torch.zeros(n, 3, device=dev),
                       h=torch.ones(n, 1, device=dev), senders=t(sp),
                       receivers=t(rp),
                       edge_attr=torch.zeros(sp.size, 0, device=dev),
                       node_mask=torch.ones(n, device=dev), edge_mask=t(em))
    lay = (t(indptr), n_edges)
    gen = torch.Generator().manual_seed(0)
    p32 = build_pipeline("fast_egnn", device=dev, generator=gen,
                         use_kernel=True, n_layers=2, hidden=hidden)
    outs = {}
    for prec, uk in (("f32", True), ("bf16", True), ("f32", False),
                     ("bf16", False)):
        cfg = FastEGNNConfig(**{**p32.cfg._asdict(), "precision": prec,
                                "use_kernel": uk})
        edge_message.reset_launches()
        virtual_message.reset_launches()
        mp.reset_dispatch_counts()
        with torch.no_grad():
            outs[prec, uk] = fast_egnn_apply(p32.params, cfg, g,
                                             edge_layout=lay)[0]
        if uk:
            assert edge_message.precision_launches == {prec: 2}
            assert virtual_message.precision_launches == {prec: 2}
        else:
            assert mp.dispatch_counts() == {"edge_plain": 2,
                                            "virtual_plain": 2}
    assert torch.isfinite(outs["bf16", True]).all()
    assert 0 < _rel_l2(outs["bf16", True], outs["f32", True]) < 0.1
    assert torch.equal(outs["bf16", False], outs["f32", False])


# ------------------------------------- the bf16 edge pair on bf16 tiles
@needs_cuda
@pytest.mark.parametrize("width", [16, 24, 32, 48, 64])
def test_edge_pair_bf16_cta_counts_bitwise(width):
    """#1 and #2 in bf16 on the tile route (16 and 24 padded to 32, 48 to
    64): within BF_L2 of the bf16 plain versions, and bitwise the same
    under another CTA count (#2: gx and gh; its weight gradients add the
    CTAs' partials in CTA order, within BF_L2)."""
    dev = torch.device("cuda")
    args, sender, kw = _bf16_edge_case(dev, "mlp", width)
    kw["precision"] = "bf16"
    n = args[0].shape[0]
    gen = torch.Generator(device=dev).manual_seed(width + 1)
    g_dx = torch.randn((n, 3), generator=gen, device=dev)
    g_mh = torch.randn((n, width), generator=gen, device=dev)
    fwd = lambda: edge_message.edge_pathway_fused(*args, **kw)
    with torch.no_grad():
        want = edge_message.edge_pathway_plain(*args, **kw)
        deg = want[2].contiguous()
        bwd = lambda: edge_message.edge_pathway_bwd_fused(
            *args[:5], *sender, *args[5:], deg, g_dx, g_mh, **kw)
        gwant = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh,
                                                    deg=deg, **kw)
        outs = []
        for f_ctas, b_ctas in ((None, edge_message.EDGE_BWD_CTAS), (7, 61)):
            old = edge_message.EDGE_FWD_CTAS, edge_message.EDGE_BWD_CTAS
            edge_message.EDGE_FWD_CTAS, edge_message.EDGE_BWD_CTAS = (f_ctas,
                                                                      b_ctas)
            try:
                outs.append((fwd(), bwd()))
            finally:
                edge_message.EDGE_FWD_CTAS, edge_message.EDGE_BWD_CTAS = old
    for got, grads in outs:
        for g, w in list(zip(got, want)) + list(zip(grads, gwant)):
            if w.numel() and float(w.abs().max()) > 0:
                assert _rel_l2(g, w) <= BF_L2
    (f1, g1), (f2, g2) = outs
    assert all(torch.equal(a, b) for a, b in zip(f1, f2))
    assert torch.equal(g1[0], g2[0]) and torch.equal(g1[1], g2[1])


def _sass_functions(lib_path) -> dict:
    """{function name: its SASS} of a built library (cuobjdump -sass)."""
    import os
    import subprocess

    from repro_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                         capture_output=True, text=True).stdout
    funcs, name = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(ln)
    return {k: "\n".join(v) for k, v in funcs.items()}


@needs_cuda
def test_edge_pair_bf16_runs_bf16_mma():
    """The bf16 instantiations of #1 (edge_fwd_edges, node_proj), #2
    (edge_bwd_edges, node_proj) and #3 (virtual_fwd_kernel), and the
    identity backward's bf16 dh pass (idn_bwd_dh, bf16 only), at both
    compiled widths run bf16 tensor-core MMAs (HMMA.16816.F32.BF16) and no
    TF32 ones; the f32 instantiations keep the 3xTF32 route
    (HMMA.1688.F32.TF32, no bf16 MMAs)."""
    import re

    from repro_torch.kernels import build

    checked = {}
    for src, bind, kernels in (
            ("edge_message", edge_message._bind,
             ("edge_fwd_edges", "node_proj")),
            ("edge_message_bwd", edge_message._bind_bwd,
             ("edge_bwd_edges", "node_proj")),
            ("virtual_message", virtual_message._bind,
             ("virtual_fwd_kernel",)),
            ("edge_identity", edge_message._bind_identity, ("idn_bwd_dh",))):
        build.load(src, bind)
        funcs = _sass_functions(build.library_path(src))
        for name, sass in funcs.items():
            kernel = next((k for k in kernels if k in name), None)
            if kernel is None:
                continue
            ops = sorted(set(re.findall(r"HMMA\.[\w.]+", sass)))
            bf = "Lb1E" in name or kernel == "idn_bwd_dh"
            width = 64 if "Li64E" in name else 32
            checked[src, kernel, width, bf] = ops
    # sources x kernels x widths x modes; idn_bwd_dh has the bf16 mode only
    assert len(checked) == 2 * 2 * 2 * 2 + 2 * 2 + 2
    for (src, kernel, width, bf), ops in checked.items():
        if bf:
            assert "HMMA.16816.F32.BF16" in ops, (src, kernel, width, ops)
            assert not any("TF32" in op for op in ops), (src, kernel, ops)
        else:
            assert "HMMA.1688.F32.TF32" in ops, (src, kernel, width, ops)
            assert not any("BF16" in op for op in ops), (src, kernel, ops)


@needs_cuda
def test_edge_pair_bf16_occupancy():
    """The card holds two CTAs of each bf16 edge kernel and of the bf16
    virtual forward an SM at both widths (the bf16 tiles halve #2's and
    #3's shared memory; both held one at 64), and the edge forward
    launches as many as it holds."""
    from repro_torch.kernels import build

    fwd = build.load("edge_message", edge_message._bind)
    bwd = build.load("edge_message_bwd", edge_message._bind_bwd)
    vfwd = build.load("virtual_message", virtual_message._bind)
    for width in (32, 64):
        assert fwd.edge_fwd_occupancy(width, 1) >= 2
        assert bwd.edge_bwd_occupancy(width, 1) >= 2
        assert vfwd.virtual_fwd_occupancy(width, 1) >= 2
        assert fwd.edge_fwd_blocks_per_sm(width, 1) <= \
            fwd.edge_fwd_occupancy(width, 1)


@needs_cuda
@pytest.mark.parametrize("n_ctas", [1, 3, 64, 1000])
@pytest.mark.parametrize("dh", [1, 64])
def test_identity_bwd_bf16_tile_route_repeat_and_cta_count(monkeypatch, dh,
                                                           n_ctas):
    """The identity backward's bf16 tile route (Dh = 1 RF, 64 SchNet; H1 =
    64): repeated calls and any CTA count of the row and dh passes give
    the same bits, and the gradients stay within the bf16 tolerance of
    the plain bf16 backward."""
    dev = torch.device("cuda")
    args, sender, deg, g_dx, g_mh, kw = _identity_bwd(dev, dh, "inv1p",
                                                      "binds")
    kw["precision"] = "bf16"
    run = lambda: edge_message.edge_pathway_bwd_fused(
        *args[:5], *sender, *args[5:], deg, g_dx, g_mh, **kw)
    with torch.no_grad():
        first, again = run(), run()
        monkeypatch.setattr(edge_message, "IDENTITY_CTAS", n_ctas)
        other = run()
    want = edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh, deg=deg,
                                               **kw)
    torch.cuda.synchronize()
    for a, b, c, w in zip(first, again, other, want):
        assert torch.equal(a, b) and torch.equal(a, c)
        if w.numel() and float(w.abs().max()) > 0:
            assert _rel_l2(a, w) <= BF_L2


# --------- the identity backward's f32 tile route; #4 bf16 on bf16 tiles
# Dh and H1 up to 64 take the identity pair's tile route in f32 too (the
# projection as tile products, the backward's node pass 8 lanes a node
# with 3xTF32 gh and W1r / W1s partials): the compiled widths 32 and 64
# and widths padded up to them
IDN_TILE_WIDTHS = [16, 32, 48, 64]


def _identity_tile_case(dev, form, width):
    """(args, kw, fwd, bwd, fplain, bplain, n_edges) of the identity pair
    in SchNet's or RF's form at ``width``, f32."""
    args, sender, kw = _bf16_edge_case(dev, form, width)
    n = args[0].shape[0]
    with torch.no_grad():
        deg = edge_message.edge_pathway_plain(*args, **kw)[2].contiguous()
    gen = torch.Generator(device=dev).manual_seed(width + 1)
    g_dx = torch.randn((n, 3), generator=gen, device=dev)
    g_mh = torch.randn((n, 1), generator=gen, device=dev)
    fwd = lambda a=args: edge_message.edge_pathway_fused(*a, **kw)
    bwd = lambda a=args: edge_message.edge_pathway_bwd_fused(
        *a[:5], *sender, *a[5:], deg, g_dx, g_mh, **kw)
    fplain = lambda: edge_message.edge_pathway_plain(*args, **kw)
    bplain = lambda: edge_message.edge_pathway_bwd_plain(*args, g_dx, g_mh,
                                                         **kw)
    return args, kw, fwd, bwd, fplain, bplain, int(args[4][-1])


@needs_cuda
@pytest.mark.parametrize("form", ["schnet", "rf"])
@pytest.mark.parametrize("width", IDN_TILE_WIDTHS)
def test_identity_f32_tile_route_matches_plain(monkeypatch, form, width):
    """The identity pair in f32 on its tile route, SchNet's form (Dh = H1)
    and RF's (Dh = 1): within the f32 tolerances of the plain versions
    (forward 1e-4, gradients 1e-3), bitwise repeats, the same bits under
    another CTA count of the row passes, and one live slot's mask zeroed
    (a planted fault) outside both tolerances."""
    dev = torch.device("cuda")
    args, kw, fwd, bwd, fplain, bplain, n_edges = _identity_tile_case(
        dev, form, width)
    with torch.no_grad():
        got, again, want = fwd(), fwd(), fplain()
        gk, gk2 = bwd(), bwd()
    gp = bplain()
    _assert_matches(got, again, want)
    _assert_grads_match(gk, gk2, gp)
    monkeypatch.setattr(edge_message, "IDENTITY_CTAS", 7)
    bad = _one_slot_masked(args, n_edges)
    with torch.no_grad():
        other = fwd() + bwd()
        fault_f, fault_b = fwd(bad), bwd(bad)
    torch.cuda.synchronize()
    for a, b in zip(got + gk, other):
        assert torch.equal(a, b)
    assert _outside_values_tolerance(fault_f, want)
    assert _outside_tolerance(fault_b, gp)


@needs_cuda
@pytest.mark.parametrize("form", ["schnet", "rf"])
def test_identity_f32_padded_width_equals_unpadded_bitwise(form):
    """The identity pair in f32 at width 24 (padded to 32 inside the
    kernels) against the same call zero-padded to 32 by hand: bitwise
    equal, forward and backward."""
    _assert_padded_equals_unpadded(form, "f32")


@needs_cuda
@pytest.mark.parametrize("width", [24, 32])
def test_identity_f32_tile_route_keeps_nan(width):
    """NaN rows of h (the card's bit patterns) on the W = 32 tile route,
    SchNet's form: NaN exactly where the plain versions have it, forward
    and backward (the 3xTF32 split keeps a NaN operand a NaN)."""
    dev = torch.device("cuda")
    args, kw, fwd, bwd, fplain, bplain, _ = _identity_tile_case(
        dev, "schnet", width)
    args[1] = _card_nan_rows(args[1], _live_nodes(args, dev))
    with torch.no_grad():
        _assert_same_nans(fwd(args), edge_message.edge_pathway_plain(
            *args, **kw))
        gk = bwd(args)
    _assert_same_nans(gk, bplain())


# ---------------- the identity forward's tile pass (Dh and H1 up to 64)
# idn_fwd_tiles<W, BF>: the CTAs own whole receiver rows, their live slots
# packed into 64-edge tiles; at every width padded to the compiled 32 and
# 64, in SchNet's form (Dh = H1) and RF's (Dh = 1), in f32 and bf16
IDN_FWD_WIDTHS = [(16, 16), (24, 24), (32, 32), (48, 48), (64, 64),
                  (24, 40)]


def _idn_fwd_case(dev, form, dh, h1):
    """(args, kw, n_edges): the 300-node test graph with identity-gate
    weights in SchNet's form (Dh, H1, rel raw) or RF's (Dh = 1, a zero
    feature column, inv1p)."""
    args, _, n_edges = _width_args(dev, dh if form == "schnet" else 1, h1, 1)
    if form == "rf":
        args[1] = torch.zeros_like(args[1])
    args[11:14] = [torch.zeros(1, 1, device=dev)] * 3
    kw = dict(gate_mode="identity",
              rel_mode="raw" if form == "schnet" else "inv1p", clamp=100.0)
    return args, kw, n_edges


@needs_cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("form", ["schnet", "rf"])
@pytest.mark.parametrize("dh,h1", IDN_FWD_WIDTHS,
                         ids=[f"{d}-{h}" for d, h in IDN_FWD_WIDTHS])
def test_identity_fwd_tiles_match_plain(monkeypatch, dh, h1, form,
                                        precision):
    """The identity forward's tile pass against its plain version (f32:
    ATOL / RTOL elementwise; bf16: BF_L2 per output of the plain bf16
    version), a bitwise repeat, the same bits under 1 and 7 CTAs as under
    the default count, one live slot's mask zeroed (a planted fault)
    outside the tolerance, every call on the tile route."""
    dev = torch.device("cuda")
    args, kw, n_edges = _idn_fwd_case(dev, form, dh, h1)
    kw["precision"] = precision
    run = lambda a=args: edge_message.edge_pathway_fused(*a, **kw)
    edge_message.reset_launches()
    with torch.no_grad():
        got, again = run(), run()
        want = edge_message.edge_pathway_plain(*args, **kw)
        bad = run(_one_slot_masked(args, n_edges))
        others = []
        for n_ctas in (1, 7):
            monkeypatch.setattr(edge_message, "IDENTITY_CTAS", n_ctas)
            others.append(run())
    torch.cuda.synchronize()
    if precision == "f32":
        _assert_matches(got, again, want)
        assert _outside_values_tolerance(bad, want)
    else:
        assert all(torch.equal(g, a) for g, a in zip(got, again))
        assert max(_rel_l2(g, w) for g, w in zip(got, want)) <= BF_L2
        assert max(_rel_l2(g, w) for g, w in zip(bad, want)) > BF_L2
    for other in others:
        assert all(torch.equal(a, b) for a, b in zip(got, other))
    assert edge_message.identity_fwd_routes == {"tiles": 5}


@needs_cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("width", [24, 64])
def test_identity_fwd_tiles_keep_nan(width, precision):
    """NaN rows of h (the card's bit patterns; SchNet's form) give NaN in
    the tile pass's outputs exactly where the plain version has it, and
    the rest within the tolerance."""
    dev = torch.device("cuda")
    args, kw, _ = _idn_fwd_case(dev, "schnet", width, width)
    kw["precision"] = precision
    args[1] = _card_nan_rows(args[1], _live_nodes(args, dev))
    with torch.no_grad():
        got = edge_message.edge_pathway_fused(*args, **kw)
        want = edge_message.edge_pathway_plain(*args, **kw)
    if precision == "f32":
        _assert_same_nans(got, want)
        return
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert _rel_l2(g[ok], w[ok]) <= BF_L2
    assert torch.isnan(got[1]).any() and not torch.isnan(got[1]).all()


@needs_cuda
@pytest.mark.parametrize("h1", [96, 128, 226])
def test_identity_fwd_wider_keeps_the_row_pass(h1):
    """Above 64 (SchNet's form, Dh = H1) the forward keeps idn_fwd_rows,
    one warp a receiver row, against its plain version."""
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    args, kw, _ = _idn_fwd_case(dev, "schnet", h1, h1)
    lib = build.load("edge_identity", edge_message._bind_identity)
    assert lib.idn_fwd_blocks_per_sm(h1, h1) == 0
    run = lambda: edge_message.edge_pathway_fused(*args, **kw)
    edge_message.reset_launches()
    with torch.no_grad():
        _assert_matches(run(), run(),
                        edge_message.edge_pathway_plain(*args, **kw))
    assert edge_message.identity_fwd_routes == {"rows": 2}


@needs_cuda
def test_identity_fwd_tiles_occupancy():
    """The card holds as many CTAs of the tile pass an SM as the wrapper
    launches by default (idn_fwd_blocks_per_sm), at both widths and in
    both modes."""
    from repro_torch.kernels import build

    lib = build.load("edge_identity", edge_message._bind_identity)
    for width in (32, 64):
        per_sm = lib.idn_fwd_blocks_per_sm(width, width)
        assert per_sm >= 1 and lib.idn_fwd_blocks_per_sm(1, width) == per_sm
        for bf in (0, 1):
            assert lib.idn_fwd_occupancy(width, bf) >= per_sm


def _virtual_bf16_args(dev, width, n=1000, c=3):
    """#3 / #4's operands and cotangents at ``width`` (from a seed)."""
    gen = torch.Generator(device=dev).manual_seed(width)
    r = lambda *s, sc=1.0: sc * torch.randn(s, generator=gen, device=dev)
    x = torch.rand((n, 3), generator=gen, device=dev)
    sw = width ** -0.5
    args = [x, r(n, width), x[:c] + 0.05 * r(c, 3),
            (torch.rand(n, generator=gen, device=dev) > 0.1).float(),
            r(c, width, width, sc=sw), r(c, width, sc=0.3),
            r(c, width, sc=0.3), r(c, width, width, sc=sw),
            r(c, width, sc=0.1), r(c, width, width, sc=sw),
            r(c, width, sc=0.1), r(c, width, 1, sc=sw),
            r(c, width, width, sc=sw), r(c, width, sc=0.1),
            r(c, width, 1, sc=sw)]
    cots = [r(n, 3), r(n, width), r(c, 3), r(c, width)]
    return args, cots


@needs_cuda
def test_virtual_bwd_bf16_occupancy():
    """The card holds two CTAs of #4 in bf16 an SM at both compiled widths
    (its bf16 tiles halve the shared memory, ~102 KB at 64), and one of
    the f32 instance at 64."""
    from repro_torch.kernels import build

    lib = build.load("virtual_message_bwd", virtual_message._bind_bwd)
    for width in (32, 64):
        assert lib.virtual_bwd_occupancy(width, 1) >= 2
    assert lib.virtual_bwd_occupancy(64, 0) >= 1


@needs_cuda
@pytest.mark.parametrize("width", [16, 32, 48, 64])
def test_virtual_bwd_bf16_tiles_match_plain_bf16(width):
    """#4 in bf16 on bf16 tiles (16 padded to 32, 48 to 64): within BF_L2
    of the plain bf16 backward, bitwise repeatable, engaged against the
    f32 kernel, one call counted."""
    dev = torch.device("cuda")
    args, cots = _virtual_bf16_args(dev, width)
    run = lambda p: virtual_message.virtual_pathway_bwd_fused(
        *args, *cots, precision=p)
    virtual_message.reset_launches()
    with torch.no_grad():
        got, again = run("bf16"), run("bf16")
        f32 = run("f32")
    want = virtual_message.virtual_pathway_bwd_plain(*args, *cots,
                                                     precision="bf16")
    torch.cuda.synchronize()
    _assert_bf16(got, again, want, f32)
    assert virtual_message.bwd_launches == 3
    assert virtual_message.precision_launches == {"bf16": 2, "f32": 1}


@needs_cuda
def test_virtual_bwd_bf16_padded_width_equals_unpadded_bitwise():
    """#4 in bf16 at width 24 (the wrapper pads it to 32) against the same
    call zero-padded to 32 by hand: bitwise equal (a zero row or column
    adds +0, and bf16(0) = 0)."""
    from repro_torch.kernels.runtime import pad_to

    dev = torch.device("cuda")
    args, cots = _virtual_bf16_args(dev, 24)
    n, c = args[0].shape[0], args[2].shape[0]
    padded = virtual_message.pad_ops(tuple(args), 32, 32)
    pcots = [cots[0], pad_to(cots[1], n, 32), cots[2], pad_to(cots[3], c, 32)]
    with torch.no_grad():
        a = virtual_message.virtual_pathway_bwd_fused(*args, *cots,
                                                      precision="bf16")
        b = virtual_message.virtual_pathway_bwd_fused(*padded, *pcots,
                                                      precision="bf16")
    for x, y in zip(a, b):
        assert torch.equal(x, y[tuple(slice(0, k) for k in x.shape)])


@needs_cuda
def test_virtual_bwd_and_identity_projection_run_their_mma_kinds():
    """#4's bf16 instances and the identity projection's bf16 ones run
    bf16 tensor-core MMAs (HMMA.16816.F32.BF16) and no TF32 ones; their
    f32 instances, and the identity backward's tile node pass in both
    modes (3xTF32 partials), the TF32 ones and no bf16 ones."""
    import re

    from repro_torch.kernels import build

    checked = {}
    for src, bind, kernels in (
            ("virtual_message_bwd", virtual_message._bind_bwd,
             ("virtual_bwd_kernel",)),
            ("edge_identity", edge_message._bind_identity,
             ("padded_proj", "idn_bwd_nodes_tile"))):
        build.load(src, bind)
        for name, sass in _sass_functions(build.library_path(src)).items():
            kernel = next((k for k in kernels if k in name), None)
            if kernel is None:
                continue
            ops = sorted(set(re.findall(r"HMMA\.[\w.]+", sass)))
            bf = "Lb1E" in name and kernel != "idn_bwd_nodes_tile"
            width = 64 if "Li64E" in name else 32
            checked[src, kernel, width, "Lb1E" in name] = (bf, ops)
    assert len(checked) == 3 * 2 * 2  # kernels x widths x modes
    for key, (bf, ops) in checked.items():
        if bf:
            assert "HMMA.16816.F32.BF16" in ops, (key, ops)
            assert not any("TF32" in op for op in ops), (key, ops)
        else:
            assert "HMMA.1688.F32.TF32" in ops, (key, ops)
            assert not any("BF16" in op for op in ops), (key, ops)


# ------------------------------------------------------------ DistEGNN
_DIST_RANK = """
import sys
import numpy as np, torch
from repro_torch.core import collectives as C
from repro_torch.data.fluid import generate_fluid_dataset
from repro_torch.data.partition import partition_sample
from repro_torch.distributed.dist_egnn import (
    build_dist_apply, build_dist_loss, build_dist_train_step,
    dist_value_and_grad, make_gnn_mesh, stack_partitions)
from repro_torch.kernels import edge_message, virtual_message
from repro_torch.launch.mesh import init_distributed
from repro_torch.models.fast_egnn import FastEGNNConfig, init_fast_egnn
from repro_torch.training.optim import Adam, tree_leaves

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
backend = init_distributed(f"localhost:{port}", world, rank, verbose=False)
mesh = make_gnn_mesh()
dev = mesh.device
res = {"backend_gloo": np.array(backend == "gloo"),
       "device_index": np.array(dev.index)}
# graph_sum and its backward on CUDA tensors: y = sum_r t_r; rank r's loss
# (w_r * y).sum(), so every rank's t.grad is sum_r w_r
ts = [torch.arange(6, dtype=torch.float32, device=dev).reshape(2, 3)
      * (r + 1.5) for r in range(world)]
ws = [torch.full((2, 3), 0.25 * (r + 1), device=dev) for r in range(world)]
t = ts[rank].clone().requires_grad_(True)
y = C.graph_sum(t, mesh)
(ws[rank] * y).sum().backward()
want_y = ts[0]
for r in range(1, world):
    want_y = want_y + ts[r]
res["sum_equal"] = np.array(torch.equal(y.detach(), want_y))
res["sum_on_device"] = np.array(y.device == dev)
want_g = ws[0]
for r in range(1, world):
    want_g = want_g + ws[r]
res["grad_equal"] = np.array(torch.equal(t.grad, want_g))
pend = C.graph_sum_async(ts[rank] * 2, mesh)
res["async_equal"] = np.array(torch.equal(pend.wait(), 2 * want_y))
res["max_equal"] = np.array(C.max_across([rank, 7 - rank], mesh)
                            == [world - 1, 7])
# a 2-shard forward and gradient on the kernels against the plain path,
# both schedules
s = generate_fluid_dataset(1, n_particles=4000, seed=3)[0]
sb = stack_partitions([partition_sample(s.x0, s.v0, s.h, s.x1, d=world,
                                        r=0.06, seed=0)], shard=rank,
                      device=dev)
kcfg = FastEGNNConfig(use_kernel=True)
pcfg = kcfg._replace(use_kernel=False)
params = init_fast_egnn(torch.Generator().manual_seed(0), kcfg, device=dev)
for name, cfg in (("k", kcfg), ("p", pcfg)):
    for ov in (1, 0):
        edge_message.reset_launches()
        virtual_message.reset_launches()
        with torch.no_grad():
            x, vs = build_dist_apply(cfg, mesh, overlap=bool(ov))(params, sb)
        res[f"{name}_x_{ov}"], res[f"{name}_z_{ov}"] = (x.cpu().numpy(),
                                                        vs.z.cpu().numpy())
        res[f"{name}_launches_{ov}"] = np.array(
            [edge_message.launches, virtual_message.launches])
    loss, g = dist_value_and_grad(build_dist_loss(cfg, mesh, 0.03, 1.5),
                                  params, sb, mesh)
    res[f"{name}_loss"] = loss.cpu().numpy()
    for i, leaf in enumerate(tree_leaves(g)):
        res[f"{name}_g{i}"] = leaf.cpu().numpy()
opt = Adam(lr=1e-3)
for ov in (0, 1):
    step, _ = build_dist_train_step(kcfg, mesh, opt, 0.03, 1.5,
                                    overlap=bool(ov))
    p2, _, loss = step(params, opt.init(params), sb)
    res[f"step_loss_{ov}"] = loss.cpu().numpy()
    for i, leaf in enumerate(tree_leaves(p2)):
        res[f"p{ov}_{i}"] = leaf.cpu().numpy()
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def dist_runs(tmp_path_factory):
    """Two gloo ranks sharing the GPU (processes of their own), each
    writing its readings; a failing rank fails the fixture."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    tmp = tmp_path_factory.mktemp("dist_cuda")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_RANK, str(r), "2", str(port),
         str(tmp / f"r{r}.npz")], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    return [dict(np.load(tmp / f"r{r}.npz")) for r in range(2)]


def _dist_leaves(res, prefix):
    n = sum(1 for k in res if k.startswith(prefix)
            and k[len(prefix):].isdigit())
    return [res[f"{prefix}{i}"] for i in range(n)]


@needs_cuda
def test_dist_graph_sum_and_backward_on_cuda_tensors(dist_runs):
    """gloo takes the ranks' CUDA tensors: the rank-order sum, its async
    form and its backward (every rank's cotangents summed) are exact, and
    the integer max agrees."""
    for res in dist_runs:
        assert res["backend_gloo"] and res["device_index"] == 0
        for k in ("sum_equal", "sum_on_device", "grad_equal", "async_equal",
                  "max_equal"):
            assert res[k], k


@needs_cuda
def test_dist_forward_kernels_match_plain(dist_runs):
    """Each rank's 2-shard forward through the kernels against the plain
    path on the same shard and through the same sums: forward within
    ATOL / RTOL, gradients within the gradient tolerance, and the kernels
    launched once a layer each."""
    layers = FastEGNNConfig().n_layers
    for res in dist_runs:
        for k in ("x", "z"):
            np.testing.assert_allclose(res[f"k_{k}_1"], res[f"p_{k}_1"],
                                       atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(res["k_loss"], res["p_loss"], rtol=1e-4)
        for g, w in zip(_dist_leaves(res, "k_g"), _dist_leaves(res, "p_g")):
            scale = float(np.abs(w).max()) + 1e-6
            np.testing.assert_allclose(g / scale, w / scale, rtol=1e-3,
                                       atol=5e-5)
        np.testing.assert_array_equal(res["k_launches_1"], [layers, layers])
        np.testing.assert_array_equal(res["p_launches_1"], [0, 0])
    np.testing.assert_array_equal(dist_runs[0]["k_z_1"],
                                  dist_runs[1]["k_z_1"])


@needs_cuda
def test_dist_schedules_bitwise_on_card(dist_runs):
    """On the kernels, the overlapped and serialized schedules give the
    same forward, loss and updated parameters, bit for bit, and the
    parameters are the same on both ranks."""
    for res in dist_runs:
        for k in ("x", "z"):
            np.testing.assert_array_equal(res[f"k_{k}_0"], res[f"k_{k}_1"])
        assert res["step_loss_0"] == res["step_loss_1"]
        for a, b in zip(_dist_leaves(res, "p0_"), _dist_leaves(res, "p1_")):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(_dist_leaves(dist_runs[0], "p1_"),
                    _dist_leaves(dist_runs[1], "p1_")):
        np.testing.assert_array_equal(a, b)


_DIST_ROLLOUT_RANK = """
import json, sys
import numpy as np, torch
from repro_torch.data.fluid import generate_fluid_dataset
from repro_torch.distributed.dist_egnn import make_gnn_mesh
from repro_torch.kernels import edge_message, virtual_message
from repro_torch.launch.mesh import init_distributed
from repro_torch.pipeline import build_pipeline

rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                          int(sys.argv[3]), sys.argv[4])
backend = init_distributed(f"localhost:{port}", world, rank, verbose=False)
mesh = make_gnn_mesh()
s = generate_fluid_dataset(1, n_particles=4000, seed=3)[0]
state = (s.x0, s.v0, s.h)
kw = dict(r=0.06, skin=0.01, dt=0.005, wrap_box=1.0)
pipe = build_pipeline("fast_egnn", mesh=mesh, use_kernel=True,
                      generator=torch.Generator().manual_seed(0))
plain = build_pipeline("fast_egnn", mesh=mesh, params=pipe.params)
res, meta = {}, {"backend": backend, "device": str(mesh.device)}
for name, p, extra in (("dev", pipe, dict(rebuild_mode="device")),
                       ("host", pipe, dict(rebuild_mode="host",
                                           async_rebuild=False)),
                       ("async", pipe, dict(rebuild_mode="host",
                                            async_rebuild=True)),
                       ("plain", plain, dict(rebuild_mode="device"))):
    edge_message.reset_launches()
    virtual_message.reset_launches()
    r = p.rollout(p.params, state, 6, **kw, **extra)
    torch.cuda.synchronize()
    res[name] = r.trajectory
    meta[name] = dict(launches=[edge_message.launches,
                                virtual_message.launches],
                      computed=6 + r.discarded_steps,
                      rebuild_steps=r.rebuild_steps,
                      coord_d2h=r.coord_d2h_bytes, edge_h2d=r.edge_h2d_bytes,
                      steady=r.steady_state_d2h_bytes)
np.savez(out + ".npz", **res)
with open(out + ".json", "w") as fh:
    json.dump(meta, fh)
"""


@pytest.fixture(scope="module")
def dist_rollout_runs(tmp_path_factory):
    """``Pipeline.rollout`` on a 2-rank mesh (gloo, both ranks on the
    GPU, processes of their own) of a 4,000-particle scene, 6 steps:
    device, host and asynchronous host rebuilds on the kernels, and device
    rebuilds on the plain path."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    tmp = tmp_path_factory.mktemp("dist_rollout_cuda")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(repo / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _DIST_ROLLOUT_RANK, str(r), "2", str(port),
         str(tmp / f"r{r}")], cwd=repo, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    return [(dict(np.load(tmp / f"r{r}.npz")),
             json.loads((tmp / f"r{r}.json").read_text())) for r in range(2)]


@needs_cuda
def test_dist_rollout_device_equals_host_on_card(dist_rollout_runs):
    """On CUDA tensors over gloo: device rebuilds give the host rebuilds'
    trajectory (synchronous and asynchronous) bit for bit, both ranks
    return the same trajectory, device mode moves no coordinates or
    edges, and #1 / #3 launch once a layer for every step computed."""
    layers = FastEGNNConfig().n_layers
    (r0, m0), (r1, _) = dist_rollout_runs
    for res, meta in dist_rollout_runs:
        assert meta["backend"] == "gloo" and meta["device"] == "cuda:0"
        np.testing.assert_array_equal(res["dev"], res["host"])
        np.testing.assert_array_equal(res["async"], res["host"])
        assert meta["dev"]["coord_d2h"] == meta["dev"]["edge_h2d"] == 0
        assert all(meta[k]["steady"] == 0 for k in ("dev", "host", "async"))
        for k in ("dev", "host", "async"):
            n = layers * meta[k]["computed"]
            assert meta[k]["launches"] == [n, n], k
        assert meta["plain"]["launches"] == [0, 0]
    for k in ("dev", "host", "async", "plain"):
        np.testing.assert_array_equal(r0[k], r1[k])
    assert m0["dev"]["rebuild_steps"] == m0["host"]["rebuild_steps"]


@needs_cuda
def test_dist_rollout_kernels_match_plain_on_card(dist_rollout_runs):
    """The first frame of the kernel path's mesh rollout within 1e-4
    (periodic distance in the unit box) of the plain path's; later frames
    are not compared (random weights amplify the kernels' rounding)."""
    for res, _ in dist_rollout_runs:
        assert np.isfinite(res["dev"]).all()
        d = np.abs(res["dev"][0].astype(np.float64) - res["plain"][0])
        assert float(np.max(np.minimum(d, 1.0 - d))) <= 1e-4
