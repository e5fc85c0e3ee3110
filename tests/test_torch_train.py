"""Port training path vs the JAX package: the edge (#2) and virtual (#4)
backward kernels, the objective, Adam, one train step, a two-epoch fit and
checkpoints.

On the CPU the port's autograd Functions (``kernels.ops``) run the plain
versions of the kernels in both directions; their gradients are held
against the reference's Pallas backward kernels in interpret mode and
against ``jax.vjp`` of its oracles.  Both sides train with
``use_kernel=True``, ``lam_mmd=0.03`` and ``mmd_sample=None`` (the sampled
MMD draws from a ``jax.random`` key the port cannot reproduce).

Tolerances: losses and forward values atol 1e-5 / rtol 1e-4; gradients
and updated parameters relative to each leaf's largest magnitude, rtol
1e-3 / atol 5e-5 (the reference's ``_assert_tree_close``); per-epoch
``train_loss`` / ``val_mse`` rtol 1e-4.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import virtual_nodes as j_vn
from repro.core.message_passing import EdgeSpec as JSpec
from repro.data.fluid import generate_fluid_dataset
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.edge_message import edge_pathway_bwd_fused as j_edge_bwd
from repro.kernels.virtual_message import \
    virtual_pathway_bwd_fused as j_virtual_bwd
from repro.pipeline import build_pipeline as j_build
from repro.training import checkpoint as j_ckpt
from repro.training import losses as j_losses
from repro.training import optim as j_optim
from repro.training.trainer import TrainConfig as JTrainConfig
from repro_torch.data.radius_graph import (csr_indptr, csr_sender_perm,
                                           pad_edges, radius_graph,
                                           sort_edges_by_receiver)
from repro_torch.kernels import ops
from repro_torch.pipeline import build_pipeline
from repro_torch.training import checkpoint as t_ckpt
from repro_torch.training import losses as t_losses
from repro_torch.training import optim as t_optim
from repro_torch.training.trainer import TrainConfig
from repro_torch.weights import params_from_jax

ATOL, RTOL = 1e-5, 1e-4
SMALL = dict(n_layers=2, hidden=16, s_dim=16, n_virtual=3)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, copy=True))
    return t.requires_grad_(True) if grad else t


def assert_close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def assert_tree_close(got, want):
    """Relative to each leaf's max: rtol 1e-3 / atol 5e-5."""
    for g, w in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = float(np.max(np.abs(w))) + 1e-6 if w.size else 1.0
        np.testing.assert_allclose(g / scale, w / scale, rtol=1e-3, atol=5e-5)


def _leaves(tree):
    return t_optim.tree_leaves(tree)


def _jleaves(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


# ------------------------------------------------------------ edge (#2)
def _edge_case(n=150, ncap=160, cap=2000, seed=0, dead_rows=False):
    rng = np.random.default_rng(seed)
    x = np.zeros((ncap, 3), np.float32)
    x[:n] = rng.uniform(0.0, 1.0, (n, 3))
    snd, rcv = sort_edges_by_receiver(*radius_graph(x[:n], 0.25))
    sp, rp, em = pad_edges(snd, rcv, cap, x[:n])
    em[: snd.size: 5] = 0.0  # mask holes inside the real slots
    indptr = csr_indptr(rp, snd.size, ncap)
    if dead_rows:  # every third receiver row fully masked
        for r in range(0, ncap, 3):
            em[indptr[r]:indptr[r + 1]] = 0.0
    h = rng.standard_normal((ncap, 16)).astype(np.float32)
    perm, sptr = csr_sender_perm(sp, snd.size, ncap)
    sperm = np.zeros(cap, np.int32)
    sperm[:perm.size] = perm
    return x, h, sp, rp, em, indptr, sperm, sptr


def _edge_params(seed=1, dh=16, hid=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)
    return {"phi1": [{"w": f(2 * dh + 1, hid), "b": f(hid)},
                     {"w": f(hid, hid), "b": f(hid)}],
            "gate": [{"w": f(hid, hid), "b": f(hid)}, {"w": f(hid, 1)}]}


EDGE_BWD_CASES = [("mlp", "raw", math.inf, False), ("mlp", "raw", 0.05, False),
                  ("mlp", "inv1p", 0.05, False), ("mlp", "inv1p", math.inf,
                                                  True),
                  ("none", "raw", math.inf, True)]


@pytest.mark.parametrize(
    "gate,rel,clamp,dead_rows", EDGE_BWD_CASES,
    ids=["mlp", "mlp-clip", "inv1p-clip", "inv1p-dead-rows", "none-dead-rows"])
def test_edge_backward_matches_pallas_and_vjp(gate, rel, clamp, dead_rows):
    x, h, sp, rp, em, indptr, sperm, sptr = _edge_case(dead_rows=dead_rows)
    spec = JSpec(use_edge_attr=False, gate=gate, rel=rel, coord_clamp=clamp)
    hk, ws = j_ops.unpack_edge_params(
        jax.tree.map(jnp.asarray, _edge_params()), jnp.asarray(h), spec)
    kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp)
    rng = np.random.default_rng(7)
    g_dx = rng.standard_normal((x.shape[0], 3)).astype(np.float32)
    g_mh = rng.standard_normal((x.shape[0], 16)).astype(np.float32)
    # port: the autograd Function (plain versions of both kernels on CPU)
    prim = [_t(x, True), _t(hk, True)] + [_t(w, True) for w in ws]
    dx, mh, deg = ops.EdgePathway.apply(
        prim[0], prim[1], _t(sp), _t(em), _t(indptr), _t(sperm), _t(sptr),
        gate, rel, clamp, *prim[2:])
    got = torch.autograd.grad((dx, mh), prim, (_t(g_dx), _t(g_mh)),
                              allow_unused=True)
    got = [torch.zeros_like(p) if g is None else g for g, p in zip(got, prim)]
    # reference: the Pallas backward in interpret mode, and the oracle's vjp
    jargs = (jnp.asarray(x), hk, jnp.asarray(sp), jnp.asarray(rp),
             jnp.asarray(em))
    _, _, jdeg = j_ref.edge_pathway_ref(*jargs, *ws, **kw)
    assert_close(deg.numpy(), jdeg)
    fused = j_edge_bwd(*jargs, *ws, jdeg, jnp.asarray(g_dx),
                       jnp.asarray(g_mh), interpret=True, **kw)
    assert_tree_close(got, fused)
    f = lambda xx, hh, *ww: j_ref.edge_pathway_ref(
        xx, hh, *jargs[2:], *ww, **kw)[:2]
    _, vjp = jax.vjp(f, jargs[0], hk, *ws)
    assert_tree_close(got, vjp((jnp.asarray(g_dx), jnp.asarray(g_mh))))
    # padding nodes (no edge as receiver or sender) get exact zeros
    assert not got[0][150:].any() and not got[1][150:].any()


def test_edge_backward_empty_graph_gives_zeros():
    x, h, sp, rp, em, indptr, sperm, sptr = _edge_case()
    spec = JSpec(use_edge_attr=False)
    hk, ws = j_ops.unpack_edge_params(
        jax.tree.map(jnp.asarray, _edge_params()), jnp.asarray(h), spec)
    prim = [_t(x, True), _t(hk, True)] + [_t(w, True) for w in ws]
    e0 = torch.zeros(0, dtype=torch.int32)
    dx, mh, _ = ops.EdgePathway.apply(
        prim[0], prim[1], e0, torch.zeros(0), torch.zeros_like(_t(indptr)),
        e0, torch.zeros_like(_t(sptr)), "mlp", "raw", math.inf, *prim[2:])
    assert not dx.any() and not mh.any()
    got = torch.autograd.grad(mh.sum() + dx.sum(), prim, allow_unused=True)
    assert all(g is None or not g.any() for g in got)
    want = j_edge_bwd(jnp.asarray(x), hk, jnp.zeros(0, jnp.int32),
                      jnp.zeros(0, jnp.int32), jnp.zeros(0), *ws,
                      jnp.zeros((x.shape[0], 1)), jnp.ones((x.shape[0], 3)),
                      jnp.ones((x.shape[0], 16)), interpret=True)
    assert all(not np.asarray(w).any() for w in want)


# --------------------------------------------------------- virtual (#4)
C, DH = 3, 16


def _virtual_case(n=150, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = rng.standard_normal((n, DH)).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)  # masked nodes
    z = (0.5 + 0.2 * rng.standard_normal((C, 3))).astype(np.float32)
    s = (0.3 * rng.standard_normal((C, DH))).astype(np.float32)
    block = jax.tree.map(np.asarray, j_vn.init_virtual_block(
        jax.random.PRNGKey(3), C, DH, DH, DH))
    cots = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((n, 3), (n, DH), (C, 3), (C, DH))]
    return x, h, mask, z, s, block, cots


_WKEYS = ("w1h", "w1d", "const1", "w2", "b2", "wg1", "bg1", "wg2", "wz1",
          "bz1", "wz2")


def test_virtual_backward_matches_pallas_and_vjp():
    x, h, mask, z, s, block, cots = _virtual_case()
    mv = (z - z.mean(0)) @ (z - z.mean(0)).T
    w = j_ops.unpack_virtual_block(jax.tree.map(jnp.asarray, block),
                                   jnp.asarray(s), jnp.asarray(mv), DH)
    ws = [np.asarray(w[k]) for k in _WKEYS]
    prim = [_t(a, True) for a in (x, h, z)] + [_t(a, True) for a in ws]
    outs = ops.VirtualPathway.apply(prim[0], prim[1], prim[2], _t(mask),
                                    *prim[3:])
    got = torch.autograd.grad(outs, prim, [_t(c) for c in cots])
    jx, jh, jz, jm = map(jnp.asarray, (x, h, z, mask))
    jws = [jnp.asarray(a) for a in ws]
    jc = [jnp.asarray(c) for c in cots]
    assert_tree_close(got, j_virtual_bwd(jx, jh, jz, jm, *jws, *jc,
                                         interpret=True))
    f = lambda xx, hh, zz, *ww: j_ref.virtual_pathway_ref(xx, hh, zz, jm, *ww)
    _, vjp = jax.vjp(f, jx, jh, jz, *jws)
    assert_tree_close(got, vjp(tuple(jc)))


def test_virtual_const1_cotangent_reaches_s_mv_and_b1():
    """Through ``unpack_virtual_block`` the const1 cotangent flows back to
    the features ``s``, the global message ``m^v`` and φ2's bias, as in
    the reference's traced unpacking."""
    x, h, mask, z, s, block, cots = _virtual_case(n=60)
    mv = ((z - z.mean(0)) @ (z - z.mean(0)).T).astype(np.float32)
    tb = params_from_jax(block, device="cpu")
    leaves = _leaves(tb)
    for p in leaves:
        p.requires_grad_(True)
    st, mvt = _t(s, True), _t(mv, True)
    from repro_torch.core.virtual_nodes import VirtualState

    outs = ops.virtual_pathway(tb, _t(h), _t(x), VirtualState(_t(z), st), mvt,
                               _t(mask))
    loss = sum((o * _t(c)).sum() for o, c in zip(outs, cots))
    prim = [st, mvt] + leaves
    got = torch.autograd.grad(loss, prim, allow_unused=True)  # phi_s unused
    got = [torch.zeros_like(p) if g is None else g for g, p in zip(got, prim)]

    def jloss(ss, mm, bb):
        vs = j_vn.VirtualState(z=jnp.asarray(z), s=ss)
        o = j_ops.virtual_pathway(bb, jnp.asarray(h), jnp.asarray(x), vs, mm,
                                  jnp.asarray(mask))
        return sum(jnp.sum(a * jnp.asarray(c)) for a, c in zip(o, cots))

    gs, gm, gb = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(s), jnp.asarray(mv), jax.tree.map(jnp.asarray, block))
    assert_tree_close(got, [gs, gm] + jax.tree.leaves(gb))


# -------------------------------------------------- objective and Adam
def test_combined_objective_matches_reference():
    rng = np.random.default_rng(4)
    n = 90
    pred = (rng.uniform(0, 1, (n, 3))).astype(np.float32)
    target = (pred + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    z = (0.5 + 0.1 * rng.standard_normal((3, 3))).astype(np.float32)
    kw = dict(lam=0.03, sigma=1.5, mmd_sample=None, use_kernel=True)
    pt, zt = _t(pred, True), _t(z, True)
    loss, parts = t_losses.combined_objective(pt, _t(target), _t(mask), zt,
                                              **kw)
    got = torch.autograd.grad(loss, (pt, zt))

    def jf(p, zz):
        return j_losses.combined_objective(p, jnp.asarray(target),
                                           jnp.asarray(mask), zz, **kw)

    (jl, jparts), jg = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(pred), jnp.asarray(z))
    assert_close(loss.item(), jl)
    for k in ("mse", "mmd"):
        assert_close(parts[k].item(), jparts[k])
    assert_tree_close(got, jg)


def test_adam_update_with_clipping_matches_reference():
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    params = {"b": [{"w": f(4, 3), "b": f(3)}], "a": f(5)}
    g1 = {"b": [{"w": 3 * f(4, 3), "b": f(3)}], "a": 2 * f(5)}
    g2 = {"b": [{"w": f(4, 3), "b": 1e-3 * f(3)}], "a": f(5)}
    kw = dict(lr=1e-2, weight_decay=1e-3, grad_clip=0.5)
    assert float(j_optim.optax_global_norm(g1)) > 1.0  # clipping is active
    jo, to = j_optim.Adam(**kw), t_optim.Adam(**kw)
    jp, js = params, jo.init(jax.tree.map(jnp.asarray, params))
    tp = params_from_jax(params, device="cpu")
    ts = to.init(tp)
    for g in (g1, g2):
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js,
                           jax.tree.map(jnp.asarray, jp))
        tp, ts = to.update(params_from_jax(g, device="cpu"), ts, tp)
    assert int(ts.step) == int(js.step) == 2
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        assert_tree_close(_leaves(got), _jleaves(want))
    assert_close(float(t_optim.global_norm(params_from_jax(g1, device="cpu"))),
                 float(j_optim.optax_global_norm(g1)))


# ------------------------------------------------- train step and fit
R = 0.035
TC = dict(lam_mmd=0.03, mmd_sample=None, epochs=2, lr=1e-3)


def assert_params_close(got, want, init):
    """Updated parameters against the reference's, per leaf as
    :func:`assert_tree_close`.  A leaf whose gradient is a cancelling sum
    at rounding level (|g| ~ 1e-13: the φ_Z stacks, whose node sums of
    x_i − z_c vanish while z sits at the centre of mass, and unused
    leaves) gets Adam updates lr·g/(|g|+eps) set by rounding in either
    package; such a leaf, moved by less than 1e-6 in the reference, must
    move by less than 1e-6 in the port too."""
    moved = [float(np.max(np.abs(w - i))) for w, i in zip(want, init)]
    assert sum(m >= 1e-6 for m in moved) >= 0.75 * len(moved)
    for g, w, i, m in zip(got, want, init, moved):
        if m < 1e-6:
            assert float(np.max(np.abs(g.numpy() - i))) < 1e-6
        else:
            assert_tree_close([g], [w])


class _GradsOut:
    """An optimizer stand-in whose update returns the gradients, so a
    train step exposes them."""

    def update(self, grads, state, params):
        return grads, state


@pytest.fixture(scope="module")
def train_case():
    data = generate_fluid_dataset(5, n_particles=64)
    jp = j_build("fast_egnn", jax.random.PRNGKey(0),
                 train_cfg=JTrainConfig(**TC), use_kernel=True, **SMALL)
    tp = build_pipeline("fast_egnn", device="cpu", train_cfg=TrainConfig(**TC),
                        params=params_from_jax(jax.tree.map(np.asarray,
                                                            jp.params),
                                               device="cpu"),
                        use_kernel=True, **SMALL)
    return dict(data=data, jp=jp, tp=tp,
                jtr=list(jp.make_batches(data[:3], 2, r=R, num_workers=0)),
                jva=list(jp.make_batches(data[3:], 2, r=R, num_workers=0)),
                ttr=tp.make_batches(data[:3], 2, r=R),
                tva=tp.make_batches(data[3:], 2, r=R))


def test_batches_match_reference(train_case):
    c = train_case
    assert len(c["ttr"]) == len(c["jtr"]) == 2
    for tb, jb in zip(list(c["ttr"]) + list(c["tva"]),
                      c["jtr"] + c["jva"]):
        for k in ("x", "v", "h", "senders", "receivers", "node_mask",
                  "edge_mask"):
            np.testing.assert_array_equal(getattr(tb.graph, k).numpy(),
                                          np.asarray(getattr(jb.graph, k)))
        np.testing.assert_array_equal(tb.x_target.numpy(), jb.x_target)
        assert (tb.sample_mask is None) == (jb.sample_mask is None)
    np.testing.assert_array_equal(c["ttr"][1].sample_mask.numpy(), [1.0, 0.0])


def test_train_step_gradients_and_update_match_reference(train_case):
    from repro.training.trainer import build_train_step as j_bts
    from repro_torch.models.fast_egnn import fast_egnn_full
    from repro_torch.training.trainer import build_train_step as t_bts

    c = train_case
    jp, tp = c["jp"], c["tp"]
    # gradients on the mask-padded batch (its padded slot weighs 0)
    jstep, _ = j_bts(jp.apply_full, jp.cfg, jp.train_cfg, _GradsOut())
    tstep, _ = t_bts(fast_egnn_full, tp.cfg, tp.train_cfg, _GradsOut())
    jg, _, jm = jstep(jp.params, None, c["jtr"][1], jax.random.PRNGKey(0))
    tg, _, tm = tstep(tp.params, None, c["ttr"][1])
    assert_close(tm["loss"].item(), jm["loss"])
    assert_close(tm["mmd"].item(), jm["mmd"])
    assert_tree_close(_leaves(tg), _jleaves(jg))
    # one real step with Adam
    jnew, jst, jm = jp.train_step(jp.params, jp.opt.init(jp.params),
                                  c["jtr"][0])
    tnew, tst, tm = tp.train_step(tp.params, tp.opt.init(tp.params),
                                  c["ttr"][0])
    assert_close(tm["loss"].item(), jm["loss"])
    assert int(tst.step) == int(jst.step) == 1
    assert_params_close(_leaves(tnew), _jleaves(jnew), _jleaves(jp.params))


def test_fit_two_epochs_matches_reference(train_case):
    """Per-epoch losses and the final parameters."""
    c = train_case
    init = _jleaves(c["jp"].params)
    jres = c["jp"].fit(c["jtr"], c["jva"])
    tres = c["tp"].fit(c["ttr"], c["tva"])
    assert len(tres.history) == len(jres.history) == 2
    for th, jh in zip(tres.history, jres.history):
        for k in ("train_loss", "val_mse"):
            np.testing.assert_allclose(th[k], jh[k], rtol=1e-4)
    np.testing.assert_allclose(tres.best_val, jres.best_val, rtol=1e-4)
    assert_params_close(_leaves(tres.params), _jleaves(jres.params), init)


# ------------------------------------------------------------ checkpoints
def test_checkpoints_load_in_both_packages(tmp_path, train_case):
    c = train_case
    jparams = c["jp"].params
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    tstate = c["tp"].opt.init(tparams)
    tstate = tstate._replace(step=tstate.step + 3)
    # port → JAX
    t_ckpt.save_checkpoint(str(tmp_path / "t.npz"),
                           {"params": tparams, "opt": tstate}, {"epoch": 1})
    like = {"params": jparams, "opt": c["jp"].opt.init(jparams)}
    back, meta = j_ckpt.restore_checkpoint(str(tmp_path / "t.npz"), like)
    assert meta == {"epoch": 1} and int(back["opt"].step) == 3
    for a, b in zip(_jleaves(back["params"]), _leaves(tparams)):
        np.testing.assert_array_equal(a, b.numpy())
    # JAX → port
    j_ckpt.save_checkpoint(str(tmp_path / "j.npz"), like, {"src": "jax"})
    got, meta = t_ckpt.restore_checkpoint(
        str(tmp_path / "j.npz"), {"params": tparams, "opt": tstate})
    assert meta == {"src": "jax"} and int(got["opt"].step) == 0
    assert got["opt"].step.dtype == torch.int32
    for a, b in zip(_leaves(got["params"]), _jleaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="mismatch"):
        t_ckpt.restore_checkpoint(str(tmp_path / "j.npz"), {"params": tparams})


# ----------------------------------------------------------- launcher
def test_launch_train_runs_gnn_and_lm_modes_on_cpu(tmp_path, capsys):
    from repro.archs.model import init_arch as j_init_arch
    from repro.configs import get_arch as j_get_arch
    from repro_torch.launch import train as launch
    from repro_torch.weights import load_npz

    ck = str(tmp_path / "ck.npz")
    base = ["gnn", "--dataset", "fluid", "--n-samples", "3", "--n-nodes",
            "40", "--batch", "2", "--epochs", "1", "--n-layers", "1",
            "--hidden", "16", "--device", "cpu"]
    launch.main(base + ["--checkpoint", ck])
    out = capsys.readouterr().out
    assert "epoch 0" in out and "best val MSE" in out
    params = load_npz(ck, device="cpu")
    assert params["layers"][0]["phi1"][0]["w"].shape == (33, 16)
    # the data plane's flags are ported (no refusal since): they run
    for extra in (["--dataset", "nbody"],
                  ["--layout-cache", str(tmp_path / "lay")],
                  ["--reshuffle", "--prefetch", "0", "--workers", "0"]):
        launch.main(base + extra)
        assert "best val MSE" in capsys.readouterr().out
    # LM mode: the reduced xlstm-125m, the reference's parameter count and
    # a loss line a step
    launch.main(["lm", "--arch", "xlstm-125m", "--steps", "2", "--batch",
                 "1", "--seq", "16", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    jcfg = j_get_arch("xlstm-125m").reduced()
    n = sum(a.size for a in jax.tree.leaves(jax.eval_shape(
        lambda: j_init_arch(jax.random.PRNGKey(0), jcfg))))
    assert lines[0] == f"{jcfg.name}: {n/1e6:.1f}M params"
    steps = [ln.split() for ln in lines if ln.startswith("step ")]
    assert [s[1] for s in steps] == ["0", "1"]
    assert all(math.isfinite(float(s[3])) and s[2] == "loss" for s in steps)
    assert lines[-1].startswith("2 steps in ")
