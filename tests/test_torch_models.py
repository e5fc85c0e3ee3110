"""The port's model zoo vs the JAX package: the registry's ten models, the
identity-gate edge kernels' plain versions, one train step, the CLIs.

Weights come from the reference (``build_pipeline(name, PRNGKey(1),
...)``) through ``weights.params_from_jax``; graphs from a numpy seed.
The reference runs with ``use_kernel`` True (its Pallas kernels in
interpret mode) and False, and so does the port (on the CPU the kernel
path runs the kernels' plain versions, fed by the CSR layout).

Tolerances: coordinates and ``aux`` within 1e-4 (DESIGN.md §3.2);
gradients, and parameters after one Adam step, relative to each leaf's
largest magnitude, rtol 1e-3 / atol 5e-5 (the reference's
``_assert_tree_close``); dispatch counts exactly, with the reference's
``*_jnp`` events named ``*_plain`` here.
"""
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import message_passing as j_mp
from repro.core.graph import GeometricGraph as JGraph
from repro.kernels.edge_message import edge_pathway_bwd_fused as j_edge_bwd
from repro.kernels.edge_message import edge_pathway_fused as j_edge_fwd
from repro.models import schnet as j_schnet
from repro.pipeline import build_pipeline as j_build
from repro.training.trainer import TrainConfig as JTrainConfig
from repro.training.trainer import build_train_step as j_bts
from repro_torch.core import message_passing as t_mp
from repro_torch.core.graph import GeometricGraph as TGraph
from repro_torch.data.fluid import generate_fluid_dataset
from repro_torch.data.radius_graph import (csr_indptr, csr_sender_perm,
                                           pad_edges, pad_nodes, radius_graph,
                                           sort_edges_by_receiver)
from repro_torch.kernels import edge_message, ops
from repro_torch.models import registry, schnet
from repro_torch.pipeline import build_pipeline
from repro_torch.training.optim import tree_leaves, tree_map
from repro_torch.training.trainer import TrainConfig
from repro_torch.training.trainer import build_train_step as t_bts
from repro_torch.weights import params_from_jax

TOL = 1e-4
HID = 16
NAMES = ("linear", "mpnn", "egnn", "rf", "schnet", "tfn", "fast_egnn",
         "fast_rf", "fast_schnet", "fast_tfn")
# the dispatch of one layer's forward on the kernel path: the reference's rule
KERNEL_DISPATCH = {
    "linear": {}, "tfn": {},
    "mpnn": {"edge_kernel": 1}, "egnn": {"edge_kernel": 1},
    "rf": {"edge_kernel": 1}, "schnet": {"edge_kernel": 1},
    "fast_egnn": {"edge_kernel": 1, "virtual_kernel": 1},
    "fast_schnet": {"edge_kernel": 1, "virtual_kernel": 1},
    "fast_rf": {"edge_kernel": 1, "virtual_plain": 1},
    "fast_tfn": {"virtual_kernel": 1},
}


def small_kw(name: str, layers: int = 2) -> dict:
    """The launcher's keywords at a small size, as the registry takes
    them (RF has no ``h_in``; linear has no width)."""
    if name == "linear":
        return {}
    kw = dict(n_layers=layers, hidden=HID)
    if name not in ("rf", "fast_rf"):
        kw["h_in"] = 1
    if name in ("fast_egnn", "fast_schnet", "fast_tfn"):
        kw["s_dim"] = HID
    return kw


def _scene(n=30, ncap=32, ecap=600, seed=0, r=0.45):
    """One padded scene with mask holes in its live slots, its CSR layout
    and live slot count (numpy)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    snd, rcv = sort_edges_by_receiver(*radius_graph(x, r))
    sp, rp, em = pad_edges(snd, rcv, ecap, x)
    em[: snd.size: 7] = 0.0
    xp, nm = pad_nodes(x, ncap)
    v = pad_nodes((0.1 * rng.standard_normal((n, 3))).astype(np.float32),
                  ncap)[0]
    h = pad_nodes(rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32), ncap)[0]
    arrays = (xp, v, h, sp, rp, np.zeros((ecap, 0), np.float32), nm, em)
    return arrays, csr_indptr(rp, snd.size, ncap), snd.size


def _max_err(want, got) -> float:
    return float(np.max(np.abs(np.asarray(want) - got.detach().numpy()),
                        initial=0.0))


def assert_tree_close(got, want):
    """Relative to each leaf's max: rtol 1e-3 / atol 5e-5."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = float(np.max(np.abs(w))) + 1e-6 if w.size else 1.0
        np.testing.assert_allclose(g / scale, w / scale, rtol=1e-3, atol=5e-5)


def _port_pipe(name, jp, use_kernel, **extra):
    return build_pipeline(name, device="cpu", use_kernel=use_kernel,
                          params=params_from_jax(
                              jax.tree.map(np.asarray, jp.params),
                              device="cpu"),
                          **small_kw(name), **extra)


@pytest.fixture(scope="module")
def scene():
    return _scene()


def _loss_weights(arrays, seed=3):
    rng = np.random.default_rng(seed)
    n = arrays[0].shape[0]
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.standard_normal((n, HID)).astype(np.float32))


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("name", NAMES)
def test_model_forward_and_dispatch_match_reference(scene, name, use_kernel):
    arrays, indptr, n_edges = scene
    j_mp.reset_dispatch_counts()
    jp = j_build(name, jax.random.PRNGKey(1), use_kernel=use_kernel,
                 **small_kw(name))
    xj, auxj = jp.apply_full(jp.params, jp.cfg,
                             JGraph(*map(jnp.asarray, arrays)))
    jc = {k.replace("_jnp", "_plain"): v
          for k, v in j_mp.dispatch_counts().items()
          if k.startswith(("edge_", "virtual_")) and "layout" not in k}
    tp = _port_pipe(name, jp, use_kernel)
    t_mp.reset_dispatch_counts()
    with torch.no_grad():
        xt, auxt = tp.apply_full(tp.params, tp.cfg,
                                 TGraph(*map(torch.from_numpy, arrays)),
                                 edge_layout=(torch.from_numpy(indptr),
                                              n_edges))
    assert _max_err(xj, xt) <= TOL
    assert sorted(auxt) == sorted(auxj)
    if "h" in auxj:
        assert _max_err(auxj["h"], auxt["h"]) <= TOL
    if "virtual" in auxj:
        assert _max_err(auxj["virtual"].z, auxt["virtual"].z) <= TOL
        assert _max_err(auxj["virtual"].s, auxt["virtual"].s) <= TOL
    got = t_mp.dispatch_counts()
    assert got == jc
    if use_kernel:
        assert got == {k: 2 * v for k, v in KERNEL_DISPATCH[name].items()}


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("name", NAMES)
def test_model_gradients_match_reference(scene, name, use_kernel):
    """Gradients of a scalar loss of the coordinates (and features, where
    the model has them) with respect to every parameter."""
    arrays, indptr, n_edges = scene
    cx, ch = _loss_weights(arrays)
    jp = j_build(name, jax.random.PRNGKey(1), use_kernel=use_kernel,
                 **small_kw(name))
    jg = JGraph(*map(jnp.asarray, arrays))

    def jloss(p):
        x, aux = jp.apply_full(p, jp.cfg, jg)
        out = jnp.sum(x * cx)
        return out + jnp.sum(aux["h"] * ch) if "h" in aux else out

    want = jax.grad(jloss)(jp.params)
    tp = _port_pipe(name, jp, use_kernel)
    work = tree_map(lambda p: p.detach().requires_grad_(True), tp.params)
    leaves = tree_leaves(work)
    x, aux = tp.apply_full(work, tp.cfg, TGraph(*map(torch.from_numpy, arrays)),
                           edge_layout=(torch.from_numpy(indptr), n_edges))
    loss = (x * torch.from_numpy(cx)).sum()
    if "h" in aux:
        loss = loss + (aux["h"] * torch.from_numpy(ch)).sum()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, leaves)]
    assert_tree_close(grads, [np.asarray(a) for a in jax.tree.leaves(want)])


# -------------------------------------------------- the identity kernels
def _identity_case(dh, seed=0):
    """A receiver-sorted layout with mask holes and fully masked rows,
    identity-gate weights at Dh (1: RF's zero column, or 16), H1 = 16,
    M = 1, and a clamp that binds on some edges."""
    rng = np.random.default_rng(seed)
    n, ncap, cap = 120, 128, 3000
    x = np.zeros((ncap, 3), np.float32)
    x[:n] = rng.uniform(0.0, 1.0, (n, 3))
    snd, rcv = sort_edges_by_receiver(*radius_graph(x[:n], 0.3))
    sp, rp, em = pad_edges(snd, rcv, cap, x[:n])
    em[: snd.size: 5] = 0.0
    indptr = csr_indptr(rp, snd.size, ncap)
    for r in range(0, ncap, 7):
        em[indptr[r]:indptr[r + 1]] = 0.0
    perm, sptr = csr_sender_perm(sp, snd.size, ncap)
    sperm = np.zeros(cap, np.int32)
    sperm[:perm.size] = perm
    f = lambda *s: (0.5 * rng.standard_normal(s)).astype(np.float32)
    h = (np.zeros((ncap, 1), np.float32) if dh == 1
         else rng.standard_normal((ncap, dh)).astype(np.float32))
    w1r, w1s = (np.zeros((1, HID), np.float32),) * 2 if dh == 1 else (
        f(dh, HID), f(dh, HID))
    ws = [w1r, w1s, f(1, HID), f(1, HID), f(HID, 1), f(1, 1),
          np.zeros((1, 1), np.float32), np.zeros((1, 1), np.float32),
          np.zeros((1, 1), np.float32)]
    return x, h, sp, rp, em, indptr, sperm, sptr, ws


def _live_msgs(x, h, sp, rp, em, ws):
    """The live edges' messages (numpy)."""
    d = x[rp] - x[sp]
    pre = (h[rp] @ ws[0] + h[sp] @ ws[1] + (d * d).sum(-1, keepdims=True)
           @ ws[2] + ws[3])
    return ((pre / (1 + np.exp(-pre))) @ ws[4] + ws[5])[em != 0]


@pytest.mark.parametrize("dh", [1, 16])
@pytest.mark.parametrize("rel", ["raw", "inv1p"])
def test_identity_edge_forward_and_backward_match_pallas(dh, rel):
    x, h, sp, rp, em, indptr, sperm, sptr, ws = _identity_case(dh)
    # a clamp in the widest gap of the middle half of the sorted |msg|:
    # it binds on some live edges, and no edge sits within rounding of it
    m = np.sort(np.abs(_live_msgs(x, h, sp, rp, em, ws)).ravel())
    mid = m[m.size // 4: 3 * m.size // 4]
    i = int(np.argmax(np.diff(mid)))
    clamp = float((mid[i] + mid[i + 1]) / 2)
    assert (m > clamp).sum() > 10 and (m < clamp).sum() > 10
    kw = dict(gate_mode="identity", rel_mode=rel, clamp=clamp)
    jargs = (jnp.asarray(x), jnp.asarray(h), jnp.asarray(sp),
             jnp.asarray(rp), jnp.asarray(em))
    jws = [jnp.asarray(w) for w in ws]
    want = j_edge_fwd(*jargs, *jws, interpret=True, **kw)
    t = lambda a, g=False: torch.from_numpy(np.array(a)).requires_grad_(g)
    prim = [t(x, True), t(h, True)] + [t(w, True) for w in ws]
    dx, mh, deg = ops.EdgePathway.apply(
        prim[0], prim[1], t(sp), t(em), t(indptr), t(sperm), t(sptr),
        "identity", rel, clamp, *prim[2:])
    for w, g in zip(want, (dx, mh, deg)):
        assert _max_err(w, g) <= TOL
    rng = np.random.default_rng(4)
    g_dx = rng.standard_normal((x.shape[0], 3)).astype(np.float32)
    g_mh = rng.standard_normal((x.shape[0], 1)).astype(np.float32)
    got = torch.autograd.grad((dx, mh), prim, (t(g_dx), t(g_mh)),
                              allow_unused=True)
    got = [torch.zeros_like(p) if g is None else g for g, p in zip(got, prim)]
    fused = j_edge_bwd(*jargs, *jws, want[2], jnp.asarray(g_dx),
                       jnp.asarray(g_mh), interpret=True, **kw)
    assert_tree_close(got, fused)
    # the raw backward wrapper's plain version against the same
    raw = edge_message.edge_pathway_bwd_fused(
        *(t(a) for a in (x, h, sp, em, indptr, sperm, sptr)),
        *(t(w) for w in ws), deg.detach().contiguous(), t(g_dx), t(g_mh),
        **kw)
    assert_tree_close(raw, fused)


# ------------------------------------------------------- registry pieces
def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("name", NAMES)
def test_init_has_reference_structure(name):
    jp = j_build(name, jax.random.PRNGKey(0), **small_kw(name))
    tp = build_pipeline(name, device="cpu",
                        generator=torch.Generator().manual_seed(0),
                        **small_kw(name))
    assert _shapes(tp.params) == _shapes(jax.tree.map(np.asarray, jp.params))
    # the port's fields, each the reference's (FastEGNN's DistEGNN-only
    # overlap_sync is not ported)
    want = jp.cfg._asdict()
    assert set(tp.cfg._fields) <= set(want)
    assert tp.cfg._asdict() == {k: want[k] for k in tp.cfg._fields}
    assert tp.name == name


def test_registry_forced_and_default_fields():
    assert registry.model_config("rf", n_virtual=5)[1].n_virtual == 0
    assert registry.model_config("fast_rf")[1].n_virtual == 3
    assert registry.model_config("fast_tfn", n_virtual=2)[1].n_virtual == 2
    assert registry.REGISTRY["fast_schnet"].has_virtual
    assert not registry.REGISTRY["schnet"].has_virtual
    with pytest.raises(KeyError, match="unknown model"):
        registry.model_config("gcn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg, params, apply_full = registry.make_model(
            "egnn", torch.Generator().manual_seed(0), device="cpu",
            **small_kw("egnn"))
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert cfg.hidden == HID and apply_full is registry.REGISTRY[
        "egnn"].apply_full and len(params["layers"]) == 2


def test_schnet_helpers_match_reference():
    """``rbf_expand``'s centres bitwise ``jnp.linspace``'s; ``ssp``
    against ``jax.nn.softplus`` − log 2 across the range where
    ``F.softplus`` switches to the identity (above 20)."""
    for n, cut in ((32, 10.0), (16, 10.0), (7, 3.3), (1, 2.0)):
        want = np.asarray(jnp.linspace(0.0, cut, n))
        assert np.array_equal(schnet.rbf_centers(n, cut).numpy(), want)
    d = np.linspace(0.0, 12.0, 101).astype(np.float32)
    np.testing.assert_allclose(
        schnet.rbf_expand(torch.from_numpy(d), 32, 10.0).numpy(),
        np.asarray(j_schnet.rbf_expand(jnp.asarray(d), 32, 10.0)),
        rtol=1e-6, atol=1e-7)
    u = np.linspace(-40.0, 40.0, 161).astype(np.float32)
    np.testing.assert_allclose(schnet.ssp(torch.from_numpy(u)).numpy(),
                               np.asarray(j_schnet.ssp(jnp.asarray(u))),
                               rtol=1e-6, atol=1e-7)


def test_build_pipeline_refuses_mesh_and_unknown_names():
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="DistEGNN"):  # FastEGNN only
        build_pipeline("rf", generator=gen, device="cpu", mesh=object())
    with pytest.raises(KeyError, match="unknown model"):
        build_pipeline("gcn", generator=gen, device="cpu")


@pytest.mark.parametrize("name", ["rf", "schnet", "fast_rf", "fast_tfn"])
def test_pipeline_rollout_matches_reference(name):
    """``Pipeline.rollout`` (device rebuilds, the kernel path) against the
    reference's over 4 steps with rebuilds: each frame within 1e-4 of
    the reference's, relative to the frame's largest coordinate where
    that exceeds 1 (RF integrates the finite-difference velocity
    directly, so random weights carry its coordinates to ~3e3 by step 4,
    with f32 rounding growing alongside)."""
    rng = np.random.default_rng(8)
    x0 = rng.uniform(0.0, 1.0, (40, 3)).astype(np.float32)
    v0 = (0.01 * rng.standard_normal((40, 3))).astype(np.float32)
    h = np.ones((40, 1), np.float32)
    jp = j_build(name, jax.random.PRNGKey(3), use_kernel=True,
                 **small_kw(name))
    tp = _port_pipe(name, jp, True)
    kw = dict(r=0.35, skin=0.1, dt=0.05, rebuild_mode="device")
    want = jp.rollout(jp.params, (x0, v0, h), 4, **kw)
    got = tp.rollout(tp.params, (x0, v0, h), 4, **kw)
    assert got.rebuild_mode == "device" and got.rebuild_count >= 1
    assert got.rebuild_steps == want.rebuild_steps
    err = np.abs(got.trajectory - want.trajectory).max(axis=(1, 2))
    mag = np.abs(want.trajectory).max(axis=(1, 2))
    assert (err <= TOL * np.maximum(mag, 1.0)).all()


def test_fast_rf_overflow_at_the_serve_dt_matches_reference():
    """FastRF recursed at the serve's dt 0.005 (``chip_smoke.py``'s DT),
    each step as the rollout engines take it with no skin (a fresh radius
    graph of the step's coordinates, v = (x' - x) / dt), port against
    reference step by step up to and including the first step whose
    frame is not finite: the same step, NaN and Inf at the same entries,
    and every finite frame within TOL of the reference's, relative to its
    largest coordinate where that exceeds 1.  RF adds the re-estimated
    velocity to its update as it is, so the coordinates grow ~10^2.6 a
    step until the virtual coordinates overflow (step 5 here); the zoo
    serves at dt 1 for that reason (``chip_smoke.py``'s ZOO_DT)."""
    n, ncap, ecap, r, dt = 40, 48, 2000, 0.35, 0.005
    rng = np.random.default_rng(8)
    x0 = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    v0 = (0.01 * rng.standard_normal((n, 3))).astype(np.float32)
    jp = j_build("fast_rf", jax.random.PRNGKey(3), use_kernel=True,
                 **small_kw("fast_rf"))
    tp = _port_pipe("fast_rf", jp, True)
    ones = np.ones((n, 1), np.float32)

    def graph(x, v):
        snd, rcv = sort_edges_by_receiver(*radius_graph(x, r))
        sp, rp, em = pad_edges(snd, rcv, ecap, x)
        arrays = (pad_nodes(x, ncap)[0], pad_nodes(v, ncap)[0],
                  pad_nodes(ones, ncap)[0], sp, rp,
                  np.zeros((ecap, 0), np.float32), pad_nodes(x, ncap)[1], em)
        return arrays, csr_indptr(rp, snd.size, ncap), snd.size

    (xj, vj), (xt, vt) = (x0, v0), (x0, v0)
    for step in range(1, 11):
        aj, _, _ = graph(xj, vj)
        at, indptr, n_edges = graph(xt, vt)
        yj = np.asarray(jp.apply_full(jp.params, jp.cfg,
                                      JGraph(*map(jnp.asarray, aj)))[0])[:n]
        with torch.no_grad():
            yt = tp.apply_full(tp.params, tp.cfg,
                               TGraph(*map(torch.from_numpy, at)),
                               edge_layout=(torch.from_numpy(indptr),
                                            n_edges))[0].numpy()[:n]
        assert np.array_equal(np.isnan(yt), np.isnan(yj)), step
        assert np.array_equal(np.isinf(yt), np.isinf(yj)), step
        fin = np.isfinite(yj)
        if fin.any():
            mag = max(float(np.abs(yj[fin]).max()), 1.0)
            assert float(np.abs(yt[fin] - yj[fin]).max()) <= TOL * mag, step
        if not fin.all():
            break
        (xj, vj), (xt, vt) = (yj, (yj - xj) / dt), (yt, (yt - xt) / dt)
    assert not np.isfinite(yj).all() and step > 2  # it overflows, later


# ----------------------------------------------------------- training
R = 0.035
TC = dict(lam_mmd=0.03, mmd_sample=None, epochs=1, lr=1e-3)


class _GradsOut:
    def update(self, grads, state, params):
        return grads, state


@pytest.fixture(scope="module")
def fluid():
    return generate_fluid_dataset(3, n_particles=64)


@pytest.mark.parametrize("name", ["rf", "schnet", "fast_schnet"])
def test_train_step_matches_reference(fluid, name):
    """One train step's gradients (the mask-padded batch) and loss
    against the reference's, kernels on; the plug-ins train with no MMD
    term, as the reference's wrappers return no virtual state."""
    jp = j_build(name, jax.random.PRNGKey(2), train_cfg=JTrainConfig(**TC),
                 use_kernel=True, **small_kw(name))
    tp = _port_pipe(name, jp, True, train_cfg=TrainConfig(**TC))
    jtr = list(jp.make_batches(fluid, 2, r=R, num_workers=0))
    ttr = tp.make_batches(fluid, 2, r=R)
    assert ttr[1].sample_mask is not None
    jstep, _ = j_bts(jp.apply_full, jp.cfg, jp.train_cfg, _GradsOut())
    tstep, _ = t_bts(tp.apply_full, tp.cfg, tp.train_cfg, _GradsOut())
    for jb, tb in zip(jtr, ttr):
        jg, _, jm = jstep(jp.params, None, jb, jax.random.PRNGKey(0))
        tg, _, tm = tstep(tp.params, None, tb)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4, atol=1e-5)
        assert "mmd" not in tm and "mmd" not in jm
        assert_tree_close(tree_leaves(tg),
                          [np.asarray(a) for a in jax.tree.leaves(jg)])
    res = tp.fit(ttr[:1], [])
    assert len(res.history) == 1 and math.isfinite(res.best_val)


# --------------------------------------------------------------- CLIs
def test_launch_train_model_rf_on_cpu(tmp_path, capsys):
    from repro_torch.launch import train as launch
    from repro_torch.weights import load_npz

    ck = str(tmp_path / "rf.npz")
    launch.main(["gnn", "--model", "rf", "--dataset", "fluid",
                 "--n-samples", "3", "--n-nodes", "40", "--batch", "2",
                 "--epochs", "1", "--n-layers", "1", "--hidden", "16",
                 "--device", "cpu", "--checkpoint", ck])
    out = capsys.readouterr().out
    assert "epoch 0" in out and "best val MSE" in out
    params = load_npz(ck, device="cpu")
    assert params["layers"][0]["phi"][0]["w"].shape == (1, 16)


@pytest.mark.parametrize("model", ["egnn", "fast_rf"])
def test_simulate_cli_other_models_on_cpu(capsys, model):
    from repro_torch.launch import simulate

    assert simulate.main(["--device", "cpu", "--n", "48", "--steps", "3",
                          "--model", model, "--use-kernel"]) == 0
    out = capsys.readouterr().out
    assert f"model={model} +kernel" in out and "3 steps in" in out
