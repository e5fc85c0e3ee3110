"""The bf16 mode of the FastEGNN kernels (#1–#4 and the identity pair)
against the JAX package's Pallas kernels in bf16 mode.

The reference runs in subprocesses (module fixture ``reference``: four,
side by side) with ``XLA_FLAGS=--xla_allow_excess_precision=false`` and
``JAX_PLATFORMS=cpu``, its Pallas kernels in interpret mode as its own
tests run them, and writes its outputs to npz files.  XLA's CPU compiler
otherwise keeps bfloat16 elementwise intermediates in f32 (the flag's
default is true), so the reference would not round where its kernel
source casts (``rel``, ``d2`` and ``d2 w1d`` of the virtual kernel); with
the flag it follows the casts exactly.  The flag is process-wide, so it
cannot be set in the test process.

The port's side runs the plain bf16 versions (``kernels.ref.*_bf16``:
on CPU tensors the kernel wrappers and the autograd Functions take them).
Bounds: each plain version, per output, within relative L2 1e-3 of the
reference's bf16 kernels; the FastEGNN forward and every gradient leaf
within relative L2 1e-2 of the reference's bf16 model and under 0.1 of
its f32 one; one train step at ``loss_scale=1024`` (MMD unsampled): loss
and updated parameters within 1e-2; ``precision='bf16'`` with
``use_kernel=False`` bitwise the f32 plain path, in both packages; E(3)
equivariance in bf16 at the reference's 3e-2.
"""
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.equivariant import apply_e3, apply_o3, random_orthogonal
from repro_torch.core.graph import make_graph
from repro_torch.data.radius_graph import csr_indptr
from repro_torch.kernels import ops
from repro_torch.kernels.edge_message import (edge_pathway_bwd_plain,
                                              edge_pathway_plain)
from repro_torch.kernels.runtime import BF16, resolve_precision
from repro_torch.kernels.virtual_message import (virtual_pathway_bwd_plain,
                                                 virtual_pathway_plain)
from repro_torch.models import fast_egnn as t_fe
from repro_torch.pipeline import build_pipeline
from repro_torch.training import optim as t_optim
from repro_torch.training.trainer import TrainConfig
from repro_torch.weights import params_from_jax

KERNEL_TOL = 1e-3  # plain bf16 version vs the reference's bf16 kernel
MODEL_TOL = 1e-2  # FastEGNN in bf16 vs the reference's bf16
F32_TOL = 0.1  # bf16 vs f32 (the reference's test_bf16_grads_finite_and_close)
EQUIV_TOL = 3e-2  # the reference's bf16 equivariance bound

# name: (gate, rel, clamp, Dh, H1, M)
EDGE_CASES = {
    "mlp": ("mlp", "raw", math.inf, 16, 16, 16),
    "mlp-clamp": ("mlp", "raw", 0.02, 16, 24, 16),
    "none": ("none", "raw", math.inf, 24, 16, 24),
    "identity-raw": ("identity", "raw", math.inf, 16, 16, 1),
    "identity-inv1p-clamp": ("identity", "inv1p", 0.02, 1, 24, 1),
    "panel-72": ("mlp", "raw", math.inf, 72, 72, 72),
}
# name: (Dh, hid)
VIRTUAL_CASES = {"16-24": (16, 24), "panel-72": (72, 72)}
N_NODES, N_SLOTS, N_CHAN = 96, 400, 3
# the model, graph and loss of the reference's
# test_bf16_grads_finite_and_close (tests/test_fused_backward.py: _CFG,
# N 48, E 120, graph seed 12, weights PRNGKey(13))
MODEL = dict(n_layers=2, hidden=16, h_in=2, n_virtual=2, s_dim=8)
MODEL_N, MODEL_E = 48, 120
TRAIN = dict(n_layers=1, hidden=16, s_dim=16, n_virtual=3)
TRAIN_TC = dict(lam_mmd=0.03, mmd_sample=None, lr=1e-3, loss_scale=1024.0)
R = 0.035
# SchNet's first train step (the zoo's identity-gate model), bf16 at
# TRAIN_TC's loss scale against its f32 step, in both packages
SCHNET = dict(n_layers=2, hidden=16, h_in=1)
SCHNET_KEY = 2


# ------------------------------------------------------------- inputs
def _edge_inputs(name):
    """x near 10 (a bf16 ulp there is 1/16), receiver-sorted slots with a
    fifth masked, weights ~ 1/sqrt(fan-in), cotangents."""
    gate, _, _, dh, h1, m = EDGE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    n, e = N_NODES, N_SLOTS
    x = (10.0 + f(n, 3)).astype(np.float32)
    h = f(n, dh)
    rcv = np.sort(rng.integers(0, n, e)).astype(np.int32)
    snd = rng.integers(0, n, e).astype(np.int32)
    em = (rng.uniform(size=e) > 0.2).astype(np.float32)
    hg = h1 if gate == "mlp" else 1
    mg = m if gate == "mlp" else 1
    ws = [f(dh, h1) / np.sqrt(dh), f(dh, h1) / np.sqrt(dh), 0.1 * f(1, h1),
          0.1 * f(1, h1), f(h1, m) / np.sqrt(h1), 0.1 * f(1, m),
          f(mg, hg) / np.sqrt(mg), 0.1 * f(1, hg), f(hg, 1) / np.sqrt(hg)]
    return dict(x=x, h=h, snd=snd, rcv=rcv, em=em, g_dx=f(n, 3),
                g_mh=f(n, m), ws=[w.astype(np.float32) for w in ws])


def _virtual_inputs(name):
    dh, hid = VIRTUAL_CASES[name]
    rng = np.random.default_rng(100 + dh)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    n, c = N_NODES, N_CHAN
    x = (10.0 + f(n, 3)).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.1).astype(np.float32)
    ops_ = [x, f(n, dh), (10.0 + 0.5 * f(c, 3)).astype(np.float32), mask,
            f(c, dh, hid) / np.sqrt(dh), 0.1 * f(c, hid), 0.1 * f(c, hid),
            f(c, hid, hid) / np.sqrt(hid), 0.1 * f(c, hid),
            f(c, hid, hid) / np.sqrt(hid), 0.1 * f(c, hid),
            f(c, hid, 1) / np.sqrt(hid), f(c, hid, hid) / np.sqrt(hid),
            0.1 * f(c, hid), f(c, hid, 1) / np.sqrt(hid)]
    cots = [f(n, 3), f(n, hid), f(c, 3), f(c, hid)]
    return [a.astype(np.float32) for a in ops_], cots


def _model_graph(seed=12):
    """The reference test's ``_graph(seed)`` and its loss target's noise
    (``jax.random``: f32 draws, the same in every process)."""
    import jax

    n, e = MODEL_N, MODEL_E
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    arrays = dict(
        x=jax.random.normal(ks[0], (n, 3)),
        v=jax.random.normal(ks[1], (n, 3)) * 0.1,
        h=jax.random.normal(ks[2], (n, 2)),
        snd=jax.random.randint(ks[3], (e,), 0, n),
        rcv=jax.random.randint(ks[4], (e,), 0, n).sort(),
        em=(jax.random.uniform(ks[5], (e,)) > 0.2).astype(np.float32),
        tgt_noise=0.05 * jax.random.normal(jax.random.PRNGKey(0), (n, 3)))
    out = {k: np.asarray(v) for k, v in arrays.items()}
    out["snd"], out["rcv"] = (out[k].astype(np.int32) for k in ("snd", "rcv"))
    return out


class _GradsOut:
    """An optimiser whose update returns the gradients: the train step's
    new parameters are its gradients."""

    def update(self, grads, state, params):
        return grads, state


def _schnet_tc(prec):
    tc = dict(TRAIN_TC)
    if prec == "f32":
        del tc["loss_scale"]
    return tc


# ------------------------------------------- the reference (subprocess)
def _reference(path, part):
    """Run the JAX package's bf16 edge kernels (``part`` 'edge'), virtual
    kernels ('virtual'), FastEGNN ('model') or train step ('train'); save
    to ``path``."""
    import jax
    import jax.numpy as jnp

    from repro.core.graph import make_graph as j_make_graph
    from repro.data.fluid import generate_fluid_dataset
    from repro.kernels.edge_message import (edge_pathway_bwd_fused,
                                            edge_pathway_fused)
    from repro.kernels.virtual_message import (virtual_pathway_bwd_fused,
                                               virtual_pathway_fused)
    from repro.models.registry import resolve_model
    from repro.pipeline import build_pipeline as j_build
    from repro.training.trainer import TrainConfig as JTrainConfig

    out = {}
    kw = dict(precision="bf16", interpret=True)
    for name, (gate, rel, clamp, *_) in (EDGE_CASES.items()
                                         if part == "edge" else ()):
        a = _edge_inputs(name)
        args = (a["x"], a["h"], a["snd"], a["rcv"], a["em"], *a["ws"])
        ekw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp, **kw)
        fwd = edge_pathway_fused(*args, **ekw)
        bwd = edge_pathway_bwd_fused(*args, fwd[2], a["g_dx"], a["g_mh"],
                                     **ekw)
        for i, t in enumerate(fwd + tuple(bwd)):
            out[f"edge/{name}/{i}"] = np.asarray(t)
    for name in VIRTUAL_CASES if part == "virtual" else ():
        args, cots = _virtual_inputs(name)
        fwd = virtual_pathway_fused(*args, **kw)
        bwd = virtual_pathway_bwd_fused(*args, *cots, **kw)
        for i, t in enumerate(tuple(fwd) + tuple(bwd)):
            out[f"virtual/{name}/{i}"] = np.asarray(t)
    if part in ("edge", "virtual"):
        np.savez(path, **out)
        return
    if part == "schnet":  # its first train step's gradients, bf16 and f32
        from repro.training.trainer import build_train_step as j_bts

        data = generate_fluid_dataset(5, n_particles=64)
        for prec in ("bf16", "f32"):
            jp = j_build("schnet", jax.random.PRNGKey(SCHNET_KEY),
                         train_cfg=JTrainConfig(**_schnet_tc(prec)),
                         use_kernel=True, precision=prec, **SCHNET)
            batch = list(jp.make_batches(data[:2], 2, r=R,
                                         num_workers=0))[0]
            step, _ = j_bts(jp.apply_full, jp.cfg, jp.train_cfg, _GradsOut())
            grads, _, m = step(jp.params, None, batch, jax.random.PRNGKey(0))
            out[f"schnet/{prec}/loss"] = np.asarray(m["loss"])
            for i, leaf in enumerate(jax.tree.leaves(grads)):
                out[f"schnet/{prec}/grad/{i}"] = np.asarray(leaf)
        np.savez(path, **out)
        return
    if part == "train":  # one bf16 train step at loss_scale 1024
        data = generate_fluid_dataset(5, n_particles=64)
        jp = j_build("fast_egnn", jax.random.PRNGKey(0),
                     train_cfg=JTrainConfig(**TRAIN_TC), use_kernel=True,
                     precision="bf16", **TRAIN)
        batch = list(jp.make_batches(data[:2], 2, r=R, num_workers=0))[0]
        new, _, metrics = jp.train_step(jp.params, jp.opt.init(jp.params),
                                        batch)
        out["train/loss"] = np.asarray(metrics["loss"])
        for i, leaf in enumerate(jax.tree.leaves(new)):
            out[f"train/param/{i}"] = np.asarray(leaf)
        np.savez(path, **out)
        return

    # FastEGNN forward and gradients, bf16 and f32, kernels and plain
    gd = _model_graph()
    g = j_make_graph(*(jnp.asarray(gd[k]) for k in ("x", "v", "h", "snd",
                                                      "rcv")),
                     edge_mask=jnp.asarray(gd["em"]))
    tgt = g.x + gd["tgt_noise"]
    cfg, params, apply_full = resolve_model(
        "fast_egnn", jax.random.PRNGKey(13), **MODEL)

    def loss(p, c):
        x_pred, _ = apply_full(p, c, g)
        return jnp.sum((x_pred - tgt) ** 2), x_pred

    c = cfg._replace(use_kernel=True, precision="bf16")
    (_, x), grads = jax.value_and_grad(loss, has_aux=True)(params, c)
    out["model/bf16/kernel/x"] = np.asarray(x)
    for i, leaf in enumerate(jax.tree.leaves(grads)):
        out[f"model/bf16/kernel/grad/{i}"] = np.asarray(leaf)
    for prec in ("f32", "bf16"):
        c = cfg._replace(use_kernel=False, precision=prec)
        out[f"model/{prec}/plain/x"] = np.asarray(apply_full(params, c, g)[0])
    out["model/plain_bitwise"] = np.asarray(
        np.array_equal(out["model/f32/plain/x"], out["model/bf16/plain/x"]))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's outputs, from five processes side by side (each
    compiles interpret-mode Pallas kernels for 10-20 s)."""
    tmp = tmp_path_factory.mktemp("bf16_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    runs = {part: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(tmp / part), part],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for part in ("edge", "virtual", "model", "train",
                                   "schnet")}
    out = {}
    for part, run in runs.items():
        _, err = run.communicate(timeout=600)
        assert run.returncode == 0, err[-4000:]
        with np.load(tmp / f"{part}.npz") as data:
            out.update({k: data[k] for k in data.files})
    return out


# -------------------------------------------------------------- helpers
def _rel_l2(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float64)
    num = np.linalg.norm((np.asarray(got, np.float64) - want).ravel())
    return num / (np.linalg.norm(want.ravel()) + 1e-30)


def _assert_rel(got, want, tol, what):
    err = _rel_l2(got, want)
    if np.linalg.norm(np.asarray(want).ravel()) == 0:
        assert np.array_equal(np.asarray(got), np.asarray(want)), what
        return
    assert err <= tol, f"{what}: relative L2 {err:.3g} > {tol}"


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.fixture
def one_torch_thread():
    """torch on one thread: the small ops of the plain versions run far
    slower on torch's threads when parallel test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -------------------------------------------------------------- kernels
@pytest.mark.parametrize("name", sorted(EDGE_CASES))
@pytest.mark.usefixtures("one_torch_thread")
def test_edge_plain_bf16_matches_pallas_bf16(reference, name):
    gate, rel, clamp, *_ = EDGE_CASES[name]
    a = _edge_inputs(name)
    n = N_NODES
    indptr = _t(csr_indptr(a["rcv"], N_SLOTS, n))
    args = (_t(a["x"]), _t(a["h"]), _t(a["snd"]), _t(a["em"]), indptr,
            *map(_t, a["ws"]))
    kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp, precision="bf16")
    fwd = edge_pathway_plain(*args, **kw)
    bwd = edge_pathway_bwd_plain(*args, _t(a["g_dx"]), _t(a["g_mh"]),
                                 deg=fwd[2], **kw)
    outs = list(fwd) + list(bwd)
    if gate != "mlp":  # the gate's gradients: zeros in both
        outs = outs[:11]
    for i, got in enumerate(outs):
        _assert_rel(got, reference[f"edge/{name}/{i}"], KERNEL_TOL,
                    f"edge {name} output {i}")
    # the bf16 mode is engaged: f32 differs
    f32 = edge_pathway_plain(*args, gate_mode=gate, rel_mode=rel,
                             clamp=clamp)
    assert _rel_l2(f32[1], reference[f"edge/{name}/1"]) > 1e-4


@pytest.mark.parametrize("name", sorted(VIRTUAL_CASES))
@pytest.mark.usefixtures("one_torch_thread")
def test_virtual_plain_bf16_matches_pallas_bf16(reference, name):
    args, cots = _virtual_inputs(name)
    targs, tcots = [_t(a) for a in args], [_t(c) for c in cots]
    outs = (list(virtual_pathway_plain(*targs, precision="bf16"))
            + list(virtual_pathway_bwd_plain(*targs, *tcots,
                                             precision="bf16")))
    for i, got in enumerate(outs):
        _assert_rel(got, reference[f"virtual/{name}/{i}"], KERNEL_TOL,
                    f"virtual {name} output {i}")
    f32 = virtual_pathway_plain(*targs)
    assert _rel_l2(f32[0], reference[f"virtual/{name}/0"]) > 1e-4


# ---------------------------------------------------------------- model
@pytest.fixture(scope="module")
def model_case():
    """The reference test's weights and graph, for the port."""
    import jax

    from repro.models.registry import resolve_model

    _, params, _ = resolve_model("fast_egnn", jax.random.PRNGKey(13),
                                 **MODEL)
    gd = _model_graph()
    g = make_graph(*(gd[k] for k in ("x", "v", "h", "snd", "rcv")),
                   edge_mask=gd["em"], device="cpu")
    lay = (_t(csr_indptr(gd["rcv"], MODEL_E, MODEL_N)), MODEL_E)
    tgt = g.x + _t(gd["tgt_noise"])
    return (params_from_jax(jax.tree.map(np.asarray, params), device="cpu"),
            g, lay, tgt)


def _run_model(params, g, lay, tgt, precision, use_kernel, grads=True):
    cfg = t_fe.FastEGNNConfig(**MODEL, use_kernel=use_kernel,
                              precision=precision)
    leaves = t_optim.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(grads)
    x, _, _ = t_fe.fast_egnn_apply(params, cfg, g, edge_layout=lay)
    if not grads:
        return x.detach(), None
    loss = ((x - tgt) ** 2).sum()
    return x.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)


@pytest.mark.usefixtures("one_torch_thread")
def test_fast_egnn_bf16_forward_and_grads_match_reference(reference,
                                                          model_case):
    """bf16 against the reference's bf16 (1e-2) and against f32 (0.1):
    the port's f32 plain path, which tests/test_torch_model.py and
    tests/test_torch_train.py hold to the reference's f32 at 1e-4 / 1e-3."""
    params, g, lay, tgt = model_case
    x, grads = _run_model(params, g, lay, tgt, "bf16", True)
    xf, grads_f = _run_model(params, g, lay, tgt, "f32", False)
    _assert_rel(x, reference["model/bf16/kernel/x"], MODEL_TOL, "bf16 x")
    _assert_rel(x, xf, F32_TOL, "bf16 vs f32 x")
    assert _rel_l2(x, xf) > 1e-5  # the bf16 mode is engaged
    for i, (gr, gf) in enumerate(zip(grads, grads_f)):
        want = reference[f"model/bf16/kernel/grad/{i}"]
        gr = torch.zeros(want.shape) if gr is None else gr
        gf = torch.zeros(want.shape) if gf is None else gf
        assert torch.isfinite(gr).all()
        _assert_rel(gr, want, MODEL_TOL, f"bf16 grad leaf {i}")
        _assert_rel(gr, gf, F32_TOL, f"bf16 vs f32 grad leaf {i}")


def test_bf16_plain_path_is_bitwise_f32(reference, model_case):
    """``use_kernel=False`` ignores the precision, as the reference's jnp
    path does (DESIGN.md §9.3): bitwise f32, in both packages."""
    assert bool(reference["model/plain_bitwise"])
    params, g, lay, tgt = model_case
    with torch.no_grad():
        xf, _ = _run_model(params, g, lay, tgt, "f32", False, grads=False)
        xb, _ = _run_model(params, g, lay, tgt, "bf16", False, grads=False)
    assert torch.equal(xf, xb)
    _assert_rel(xb, reference["model/bf16/plain/x"], 1e-5, "plain x")
    _assert_rel(xb, reference["model/f32/plain/x"], 1e-5, "plain x")


@pytest.mark.usefixtures("one_torch_thread")
def test_bf16_train_step_matches_reference(reference):
    import jax

    from repro.data.fluid import generate_fluid_dataset
    from repro.pipeline import build_pipeline as j_build
    from repro.training.trainer import TrainConfig as JTrainConfig

    data = generate_fluid_dataset(5, n_particles=64)
    jp = j_build("fast_egnn", jax.random.PRNGKey(0),
                 train_cfg=JTrainConfig(**TRAIN_TC), **TRAIN)
    tp = build_pipeline("fast_egnn", device="cpu",
                        train_cfg=TrainConfig(**TRAIN_TC),
                        params=params_from_jax(jax.tree.map(np.asarray,
                                                            jp.params),
                                               device="cpu"),
                        use_kernel=True, precision="bf16", **TRAIN)
    batch = tp.make_batches(data[:2], 2, r=R)[0]
    new, _, metrics = tp.train_step(tp.params, tp.opt.init(tp.params), batch)
    assert math.isfinite(metrics["loss"].item())
    _assert_rel(metrics["loss"].item(), reference["train/loss"], MODEL_TOL,
                "loss")
    for i, leaf in enumerate(t_optim.tree_leaves(new)):
        _assert_rel(leaf, reference[f"train/param/{i}"], MODEL_TOL,
                    f"updated parameter {i}")


@pytest.mark.usefixtures("one_torch_thread")
def test_schnet_bf16_train_step_matches_reference(reference):
    """SchNet's first bf16 train step (the identity-gate kernels' plain
    bf16 versions, loss_scale 1024) against the reference's in bf16, leaf
    by leaf within MODEL_TOL; and its f32 step within 1e-4.  Prints each
    leaf's bf16-vs-f32 distance in both packages (the card's zoo_bf16
    phase reads it, ungated, at full width)."""
    import jax

    from repro.data.fluid import generate_fluid_dataset
    from repro.pipeline import build_pipeline as j_build
    from repro_torch.training.trainer import build_train_step

    jp = j_build("schnet", jax.random.PRNGKey(SCHNET_KEY), **SCHNET)
    params = jax.tree.map(np.asarray, jp.params)
    data = generate_fluid_dataset(5, n_particles=64)
    grads = {}
    for prec in ("bf16", "f32"):
        tp = build_pipeline("schnet", device="cpu",
                            train_cfg=TrainConfig(**_schnet_tc(prec)),
                            params=params_from_jax(params, device="cpu"),
                            use_kernel=True, precision=prec, **SCHNET)
        batch = tp.make_batches(data[:2], 2, r=R)[0]
        step, _ = build_train_step(tp.apply_full, tp.cfg, tp.train_cfg,
                                   _GradsOut())
        g, _, m = step(tp.params, None, batch)
        _assert_rel(m["loss"].item(), reference[f"schnet/{prec}/loss"],
                    MODEL_TOL if prec == "bf16" else 1e-4, f"{prec} loss")
        grads[prec] = t_optim.tree_leaves(g)
    readings = []
    for i, (gb, gf) in enumerate(zip(grads["bf16"], grads["f32"])):
        jb = reference[f"schnet/bf16/grad/{i}"]
        jf = reference[f"schnet/f32/grad/{i}"]
        assert torch.isfinite(gb).all()
        _assert_rel(gb, jb, MODEL_TOL, f"bf16 grad leaf {i}")
        _assert_rel(gf, jf, 1e-4, f"f32 grad leaf {i}")
        readings.append((i, _rel_l2(jb, jf), _rel_l2(gb, gf)))
    print("SchNet bf16 vs f32, per gradient leaf (leaf, reference, port):",
          " ".join(f"{i}:{a:.3g}/{b:.3g}" for i, a, b in readings))


@pytest.mark.usefixtures("one_torch_thread")
def test_bf16_e3_equivariance(model_case):
    params, g, lay, _ = model_case
    gen = torch.Generator().manual_seed(3)
    rot = random_orthogonal(gen, device="cpu")
    t = 3.0 * torch.randn((3,), generator=gen)
    cfg = t_fe.FastEGNNConfig(**MODEL, use_kernel=True, precision="bf16")
    with torch.no_grad():
        x1, _, _ = t_fe.fast_egnn_apply(params, cfg, g, edge_layout=lay)
        g2 = g._replace(x=apply_e3(g.x, rot, t), v=apply_o3(g.v, rot))
        x2, _, _ = t_fe.fast_egnn_apply(params, cfg, g2, edge_layout=lay)
    scale = float(x2.abs().max()) + 1e-6
    np.testing.assert_allclose((apply_e3(x1, rot, t) / scale).numpy(),
                               (x2 / scale).numpy(), rtol=EQUIV_TOL,
                               atol=EQUIV_TOL)


@pytest.mark.parametrize("bad", ["bf8", "fp16", "BF16", ""])
def test_unknown_precision_raises(bad):
    with pytest.raises(ValueError, match="unknown precision"):
        resolve_precision(bad)
    with pytest.raises(ValueError, match="unknown precision"):
        build_pipeline("fast_egnn", device="cpu", precision=bad,
                       generator=torch.Generator().manual_seed(0),
                       n_layers=1, hidden=8, n_virtual=2, s_dim=4)
    assert resolve_precision("bf16") == resolve_precision("bfloat16") == BF16
    assert ops.edge_function("bf16") is ops.edge_function("bf16")


if __name__ == "__main__":
    _reference(sys.argv[1], sys.argv[2])
