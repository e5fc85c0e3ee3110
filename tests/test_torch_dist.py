"""DistEGNN on ``torch.distributed`` (gloo, CPU) vs the JAX package, and
the port's own claims.

One module fixture starts, all at once: the reference in one subprocess
with ``--xla_force_host_platform_device_count=4`` (as
``tests/test_distributed.py`` runs it), whose ``build_dist_apply`` and
``build_dist_train_step``'s ``loss_fn`` (forward, loss and ``jax.grad``)
run at D = 2 and D = 4 and write an npz; and, per world size D = 2 and
D = 4, D port ranks, gloo processes on the CPU with the plain versions of
the kernels (``use_kernel=True``), each writing its own npz.  Both sides
take the same weights (the reference's init, saved by this process) and
the same scenes (the reference's fluid generator).

Tolerances (DESIGN.md §3.2): against the reference, forward and virtual
state 1e-4, loss 1e-5 relative, gradients 1e-3 relative to each leaf's
largest magnitude; against single-device FastEGNN on the union graph,
forward 1e-5 and gradients 5e-3 relative (the reference's own
``test_dist_*`` limits).  Bitwise: the two layer schedules (forward, loss,
updated parameters), the virtual state and the updated parameters across
ranks, a repeated step, and a one-rank mesh against the single-device
pipeline.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data import fluid as j_fluid
from repro.data import partition as j_part
from repro.distributed import dist_egnn as j_dist
from repro.models.fast_egnn import FastEGNNConfig as JCfg
from repro.models.fast_egnn import init_fast_egnn as j_init
from repro.training.checkpoint import save_checkpoint
from repro_torch.core import collectives
from repro_torch.core.graph import make_graph
from repro_torch.data.partition import partition_sample
from repro_torch.distributed.dist_egnn import make_gnn_mesh
from repro_torch.models.fast_egnn import FastEGNNConfig, fast_egnn_apply
from repro_torch.pipeline import build_pipeline
from repro_torch.training.losses import masked_mse
from repro_torch.training.optim import tree_leaves, tree_map
from repro_torch.weights import load_npz

REPO = Path(__file__).resolve().parent.parent
CFG = dict(n_layers=2, hidden=16, h_in=1, n_virtual=3, s_dim=16)
N_PARTICLES, N_SAMPLES, BATCH, R = 96, 3, 2, 0.08
LAM, SIGMA, LR = 0.03, 1.5, 1e-3
WORLDS = (2, 4)
ATOL, RTOL = 1e-4, 1e-4

_REF = """
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.data.fluid import generate_fluid_dataset
from repro.data.partition import partition_sample
from repro.distributed.dist_egnn import (build_dist_apply,
                                         build_dist_train_step,
                                         make_gnn_mesh, stack_partitions)
from repro.models.fast_egnn import FastEGNNConfig, init_fast_egnn
from repro.training.optim import Adam

CFG, N, B, R, LAM, SIGMA = {cfg!r}, {n}, {b}, {r}, {lam}, {sigma}
cfg = FastEGNNConfig(**CFG)
params = init_fast_egnn(jax.random.PRNGKey(0), cfg)
data = generate_fluid_dataset({ns}, n_particles=N, seed=0)[:B]
out = {{}}
for D in {worlds!r}:
    sb = stack_partitions([partition_sample(s.x0, s.v0, s.h, s.x1, d=D,
                                            r=R, seed=j)
                           for j, s in enumerate(data)])
    mesh = make_gnn_mesh(D)
    apply = build_dist_apply(cfg, mesh)
    _, loss_fn = build_dist_train_step(cfg, mesh, Adam(lr=1e-3),
                                       lam_mmd=LAM, mmd_sigma=SIGMA)
    # one program: the forward beside the loss and its gradient
    f = jax.jit(jax.value_and_grad(
        lambda p: (loss_fn(p, sb), apply(p, sb)), has_aux=True))
    (loss, (x, vs)), g = f(params)
    out[f"{{D}}/x"], out[f"{{D}}/z"] = np.asarray(x), np.asarray(vs.z)
    out[f"{{D}}/s"], out[f"{{D}}/loss"] = np.asarray(vs.s), np.asarray(loss)
    for i, leaf in enumerate(jax.tree.leaves(g)):
        out[f"{{D}}/g{{i}}"] = np.asarray(leaf)
np.savez(sys.argv[1], **out)
"""

_RANK = """
import json, sys, warnings
from collections import namedtuple
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.core import message_passing as mp
from repro_torch.data.partition import partition_sample
from repro_torch.distributed.dist_egnn import (
    build_dist_apply, build_dist_loss, build_dist_train_step,
    dist_value_and_grad, make_gnn_mesh, stack_partitions)
from repro_torch.launch.mesh import init_distributed
from repro_torch.models.fast_egnn import FastEGNNConfig
from repro_torch.pipeline import build_pipeline
from repro_torch.training.optim import Adam, tree_leaves
from repro_torch.training.trainer import TrainConfig
from repro_torch.weights import load_npz

CFG, B, R, LAM, SIGMA, LR = {cfg!r}, {b}, {r}, {lam}, {sigma}, {lr}


def rank_main(rank, world, port, inp, out_path):
    init_distributed(f"localhost:{{port}}", world, rank, device="cpu",
                     verbose=False)
    mesh = make_gnn_mesh(device="cpu")
    params = load_npz(inp + "/params.npz", device="cpu")
    arr = np.load(inp + "/data.npz")
    Sample = namedtuple("Sample", "x0 v0 h x1")
    samples = [Sample(*(arr[k][i] for k in ("x0", "v0", "h", "x1")))
               for i in range(arr["x0"].shape[0])]
    cfg = FastEGNNConfig(**CFG, use_kernel=True)
    sb = stack_partitions([partition_sample(s.x0, s.v0, s.h, s.x1, d=world,
                                            r=R, seed=j)
                           for j, s in enumerate(samples[:B])], shard=rank,
                          device="cpu")
    res, meta = {{}}, {{}}
    leaves = lambda name, tree: res.update(
        {{f"{{name}}{{i}}": t.detach().numpy() for i, t in
         enumerate(tree_leaves(tree))}})
    with torch.no_grad():
        for ov in (1, 0):
            x, vs = build_dist_apply(cfg, mesh, overlap=bool(ov))(params, sb)
            res[f"x_{{ov}}"], res[f"z_{{ov}}"], res[f"s_{{ov}}"] = (
                x.numpy(), vs.z.numpy(), vs.s.numpy())
    for lam in (LAM, 0.0):
        loss, g = dist_value_and_grad(build_dist_loss(cfg, mesh, lam, SIGMA),
                                      params, sb, mesh)
        res[f"loss_{{lam}}"] = loss.numpy()
        leaves(f"g_{{lam}}/", g)
    opt = Adam(lr=LR)
    counts = {{}}
    for ov in (0, 1):
        step, _ = build_dist_train_step(cfg, mesh, opt, LAM, SIGMA,
                                        overlap=bool(ov))
        mp.reset_dispatch_counts()
        p2, _, loss = step(params, opt.init(params), sb)
        counts[ov] = mp.dispatch_counts()
        res[f"step_loss_{{ov}}"] = loss.numpy()
        leaves(f"p_{{ov}}/", p2)
    p3, _, loss = step(params, opt.init(params), sb)  # the overlapped again
    res["step_loss_repeat"] = loss.numpy()
    leaves("p_repeat/", p3)
    meta["counts"] = [counts[0].get("collective_overlapped", 0),
                      counts[0].get("collective_serialized", 0),
                      counts[1].get("collective_overlapped", 0),
                      counts[1].get("collective_serialized", 0)]
    # the pipeline surface: batches, predict, fit
    pipe = build_pipeline("fast_egnn", mesh=mesh, params=params, device="cpu",
                          train_cfg=TrainConfig(epochs=2, lam_mmd=LAM,
                                                mmd_sigma=SIGMA, lr=LR),
                          use_kernel=True, **CFG)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        batches = pipe.make_batches(samples, B, r=R)
    meta["dropped_warning"] = [str(w.message) for w in rec
                               if "dropping" in str(w.message)]
    meta["n_batches"] = len(batches)
    for f in sb._fields[:-1]:
        res[f"batch/{{f}}"] = getattr(batches[0], f).numpy()
    for i, a in enumerate(batches[0].layout):
        res[f"batch/layout{{i}}"] = a.numpy()
    res["predict"] = pipe.predict(pipe.params, batches[0]).numpy()
    fit = pipe.fit(batches, batches)
    meta["history"] = fit.history
    meta["eval"] = float(pipe.eval_step(pipe.params, batches[0]))
    leaves("fit/", fit.params)
    np.savez(out_path + ".npz", **res)
    with open(out_path + ".json", "w") as fh:
        json.dump(meta, fh)


if __name__ == "__main__":
    import multiprocessing as mpr
    from repro_torch.launch.mesh import free_port
    inp, outdir = sys.argv[1], sys.argv[2]
    ctx = mpr.get_context("fork")  # torch is imported once, here
    procs = []
    for world in {worlds!r}:
        port = free_port()
        procs += [ctx.Process(target=rank_main, args=(
            r, world, port, inp, f"{{outdir}}/w{{world}}_r{{r}}"))
            for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(400)
    sys.exit(max(abs(p.exitcode or 0) if p.exitcode is not None else 1
                 for p in procs))
"""


def _env(**kw) -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **kw)
    return env


def _scenes():
    return j_fluid.generate_fluid_dataset(N_SAMPLES, n_particles=N_PARTICLES,
                                          seed=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference and every port rank at once; wait for all of
    them; their outputs by world size."""
    tmp = tmp_path_factory.mktemp("dist")
    save_checkpoint(str(tmp / "params.npz"),
                    j_init(jax.random.PRNGKey(0), JCfg(**CFG)))
    data = _scenes()
    np.savez(tmp / "data.npz", **{k: np.stack([getattr(s, k) for s in data])
                                  for k in ("x0", "v0", "h", "x1")})
    fmt = dict(cfg=CFG, n=N_PARTICLES, ns=N_SAMPLES, b=BATCH, r=R, lam=LAM, sigma=SIGMA,
               lr=LR, worlds=WORLDS)
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REF.format(**fmt)),
         str(tmp / "ref.npz")], cwd=REPO, env=_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                      "--xla_backend_optimization_level=0 "
                      "--xla_llvm_disable_expensive_passes=true"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_RANK.format(**fmt)),
         str(tmp), str(tmp)], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True))
    for p in procs:
        try:
            _, err = p.communicate(timeout=400)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    out = {"ref": ref, "params": load_npz(tmp / "params.npz", device="cpu"),
           "data": data}
    for world in WORLDS:
        out[world] = [
            (dict(np.load(tmp / f"w{world}_r{r}.npz")),
             json.loads((tmp / f"w{world}_r{r}.json").read_text()))
            for r in range(world)]
    return out


def _leaves(res: dict, prefix: str) -> list:
    n = sum(1 for k in res if k.startswith(prefix))
    return [res[f"{prefix}{i}"] for i in range(n)]


def assert_tree_close(got, want, rtol=1e-3, atol=5e-5):
    """Relative to each leaf's largest magnitude (the reference's
    ``_assert_tree_close``)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        scale = float(np.max(np.abs(w))) + 1e-6 if w.size else 1.0
        np.testing.assert_allclose(g / scale, w / scale, rtol=rtol, atol=atol)


def _union(pgs, world):
    """The single-device graph that is the union of one sample's shards
    (the reference test's construction), with its targets."""
    pg = pgs
    xs, vs, hs, ts, snds, rcvs, off = [], [], [], [], [], [], 0
    for d in range(world):
        n_d = int(pg.node_mask[d].sum())
        xs.append(pg.x[d][:n_d])
        vs.append(pg.v[d][:n_d])
        hs.append(pg.h[d][:n_d])
        ts.append(pg.x_target[d][:n_d])
        em = pg.edge_mask[d] > 0
        snds.append(pg.senders[d][em] + off)
        rcvs.append(pg.receivers[d][em] + off)
        off += n_d
    g = make_graph(np.concatenate(xs), np.concatenate(vs), np.concatenate(hs),
                   np.concatenate(snds), np.concatenate(rcvs), device="cpu")
    return g, torch.from_numpy(np.concatenate(ts))


def _gather_shards(runs_w, key, b, pg):
    """One sample's per-node field from every rank, real nodes in shard
    order (the union graph's node order)."""
    return np.concatenate([res[key][b][pg.node_mask[d] > 0]
                           for d, (res, _) in enumerate(runs_w)])


@pytest.mark.parametrize("world", WORLDS)
def test_forward_matches_reference(runs, world):
    ref = runs["ref"]
    for rank, (res, _) in enumerate(runs[world]):
        for k in ("x", "z", "s"):
            np.testing.assert_allclose(res[f"{k}_1"], ref[f"{world}/{k}"][rank],
                                       atol=ATOL, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_loss_matches_reference(runs, world):
    """Within 1e-5 relative and 1e-7 absolute, the reference's own pair
    for its two-process loss parity (``tests/test_multiprocess.py``): the
    loss is ~1e-4 here, and one f32 rounding of a coordinate moves it by
    ~2e-5 of itself."""
    want = float(runs["ref"][f"{world}/loss"])
    for res, _ in runs[world]:
        np.testing.assert_allclose(float(res[f"loss_{LAM}"]), want,
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_gradients_match_reference(runs, world):
    ref = runs["ref"]
    want = _leaves(ref, f"{world}/g")
    for res, _ in runs[world]:
        assert_tree_close(_leaves(res, f"g_{LAM}/"), want)


@pytest.mark.parametrize("world", WORLDS)
def test_matches_union_graph(runs, world):
    """DistEGNN(D) is single-device FastEGNN on the union of the shards
    (ref ``tests/test_distributed.py::test_dist_equals_single_device``),
    forward within 1e-5 and gradients of the MSE within 5e-3."""
    cfg = FastEGNNConfig(**CFG)
    params = runs["params"]
    for b, s in enumerate(runs["data"][:BATCH]):
        pg = partition_sample(s.x0, s.v0, s.h, s.x1, d=world, r=R, seed=b)
        g, target = _union(pg, world)
        x, _, vs = fast_egnn_apply(params, cfg, g)
        got = _gather_shards(runs[world], "x_1", b, pg)
        np.testing.assert_allclose(got, x.detach().numpy(), atol=1e-5)
        for res, _ in runs[world]:
            np.testing.assert_allclose(res["z_1"][b], vs.z.detach().numpy(),
                                       atol=1e-5)
    # gradients: the batch mean of the union graphs' MSEs, lam_mmd = 0
    wtree = tree_map(lambda p: p.detach().requires_grad_(True), params)
    work = tree_leaves(wtree)
    loss = 0.0
    for b, s in enumerate(runs["data"][:BATCH]):
        pg = partition_sample(s.x0, s.v0, s.h, s.x1, d=world, r=R, seed=b)
        g, target = _union(pg, world)
        x, _, _ = fast_egnn_apply(wtree, cfg, g)
        loss = loss + masked_mse(x, target, g.node_mask) / BATCH
    grads = torch.autograd.grad(loss, work, allow_unused=True)
    want = [np.zeros(p.shape, np.float32) if gr is None else gr.numpy()
            for gr, p in zip(grads, work)]
    for res, _ in runs[world]:
        assert_tree_close(_leaves(res, "g_0.0/"), want, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_virtual_state_bitwise_across_ranks(runs, world):
    first = runs[world][0][0]
    for res, _ in runs[world][1:]:
        for k in ("z_1", "s_1", "z_0", "s_0"):
            np.testing.assert_array_equal(res[k], first[k], err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_schedules_bitwise(runs, world):
    """Overlapped and serialized: the same forward, loss and updated
    parameters, bit for bit; each schedule counts its own two collectives
    a layer and a scene, none of the other's (ref
    ``tests/test_multiprocess.py::test_overlap_matches_serialized_
    train_step``)."""
    two_l = 2 * CFG["n_layers"] * BATCH
    for res, meta in runs[world]:
        for k in ("x", "z", "s"):
            np.testing.assert_array_equal(res[f"{k}_0"], res[f"{k}_1"])
        assert res["step_loss_0"] == res["step_loss_1"]
        for a, b in zip(_leaves(res, "p_0/"), _leaves(res, "p_1/")):
            np.testing.assert_array_equal(a, b)
        assert meta["counts"] == [0, two_l, two_l, 0]


@pytest.mark.parametrize("world", WORLDS)
def test_parameters_bitwise_across_ranks_and_repeat(runs, world):
    first = runs[world][0][0]
    for res, _ in runs[world]:
        for key in ("p_1/", "p_repeat/", "fit/"):
            for a, b in zip(_leaves(res, key), _leaves(first, key)):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(_leaves(res, "p_repeat/"), _leaves(res, "p_1/")):
            np.testing.assert_array_equal(a, b)
        assert res["step_loss_repeat"] == res["step_loss_1"]


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_pipeline(runs, world):
    """``build_pipeline(mesh=...)``: each rank's batches are its row of the
    reference's stacked partition (the trailing sample dropped with a
    warning), ``predict`` is the distributed forward, and ``fit`` trains
    with the same losses on every rank."""
    data = runs["data"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_dist.stack_partitions_host([
            j_part.partition_sample(s.x0, s.v0, s.h, s.x1, d=world, r=R,
                                    seed=j)
            for j, s in enumerate(data[:BATCH])])
    hist = runs[world][0][1]["history"]
    for rank, (res, meta) in enumerate(runs[world]):
        assert meta["n_batches"] == 1
        assert len(meta["dropped_warning"]) == 1
        assert "dropping the trailing 1 samples" in meta["dropped_warning"][0]
        for f in ("x", "v", "h", "senders", "receivers", "node_mask",
                  "edge_mask", "x_target"):
            np.testing.assert_array_equal(res[f"batch/{f}"], want[f][rank],
                                          err_msg=f)
        np.testing.assert_array_equal(res["predict"], res["x_1"])
        assert meta["history"] == hist
        assert all(np.isfinite([h["train_loss"] for h in hist]))
        # the first epoch's train loss is the first step's
        assert hist[0]["train_loss"] == float(res["step_loss_1"])
        assert meta["eval"] >= 0.0


def test_one_rank_mesh_is_bitwise_single_device():
    """A mesh of one rank (no process group: its sums are the identity)
    predicts bitwise what the single-device pipeline predicts, in both
    schedules."""
    data = _scenes()[:BATCH]
    params = build_pipeline("fast_egnn", device="cpu", **CFG,
                            generator=torch.Generator().manual_seed(3)).params
    single = build_pipeline("fast_egnn", device="cpu", params=params,
                            use_kernel=True, **CFG)
    want = single.predict(params, single.make_batches(data, BATCH, r=R)[0])
    mesh = make_gnn_mesh(device="cpu")
    assert (mesh.rank, mesh.size) == (0, 1)
    for ov in (True, False):
        pipe = build_pipeline("fast_egnn", mesh=mesh, params=params,
                              use_kernel=True, overlap_sync=ov, **CFG)
        got = pipe.predict(params, pipe.make_batches(data, BATCH, r=R)[0])
        assert torch.equal(got, want)


def test_graph_sum_one_rank_is_identity():
    axis = make_gnn_mesh(device="cpu")
    t = torch.randn(5, 3, requires_grad=True)
    assert collectives.graph_sum(t, axis) is t
    assert collectives.graph_sum(t, None) is t
    assert collectives.sum_across(t, axis) is t
    a, b = collectives.graph_sum_parts((t, t.sum()), axis)
    assert a is t
    assert collectives.max_across([3, 1], axis) == [3, 1]


def test_backend_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert collectives.pick_backend(cpu, 4, n_gpus=8) == "gloo"
    assert collectives.pick_backend(cuda, 1, n_gpus=1) == "nccl"
    assert collectives.pick_backend(cuda, 2, n_gpus=1) == "gloo"
    assert collectives.pick_backend(cuda, 4, n_gpus=4) == "nccl"


def test_mesh_pipeline_rejects_other_models_and_rollout():
    mesh = make_gnn_mesh(device="cpu")
    with pytest.raises(ValueError, match="DistEGNN"):
        build_pipeline("egnn", mesh=mesh, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="1 rank"):
        make_gnn_mesh(2, device="cpu")
    pipe = build_pipeline("fast_egnn", mesh=mesh, device="cpu", **CFG,
                          generator=torch.Generator().manual_seed(0))
    s = _scenes()[0]
    # the mesh rollout is ported: it runs (DistRolloutEngine) and is finite
    res = pipe.rollout(pipe.params, (s.x0, s.v0, s.h), 2, r=R, dt=0.01)
    assert res.trajectory.shape == (2, N_PARTICLES, 3)
    assert np.isfinite(res.trajectory).all()


def test_launch_train_two_devices():
    """``launch/train.py gnn --devices 2`` trains DistEGNN over two gloo
    ranks on the CPU."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "gnn",
         "--dataset", "fluid", "--devices", "2", "--device", "cpu",
         "--n-samples", "5", "--n-nodes", "48", "--batch", "2",
         "--epochs", "1", "--n-layers", "1", "--hidden", "8"],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "backend gloo on cpu" in out.stdout
    assert "best val" in out.stdout and "devices: 2" in out.stdout


def test_virtual_aggregate_halves_match_reference():
    """``virtual_aggregate`` (Eqs. 8–9 from the messages), its launch and
    finish halves and ``masked_com_sums`` against the reference's on one
    device (1e-5), and unchanged on a one-rank axis (bitwise)."""
    import jax.numpy as jnp

    from repro.core import virtual_nodes as j_vn
    from repro_torch.core import virtual_nodes as t_vn
    from repro_torch.weights import params_from_jax

    n, c, s_dim, hid = 40, 3, 8, 16
    rng = np.random.default_rng(0)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    x, msgs = f(n, 3), f(n, c, hid)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    z, s = f(c, 3), f(c, s_dim)
    jblock = j_vn.init_virtual_block(jax.random.PRNGKey(1), c, hid, s_dim,
                                     hid)
    tblock = params_from_jax(jax.tree.map(np.asarray, jblock), device="cpu")
    t = torch.from_numpy
    want = j_vn.virtual_aggregate(jblock, jnp.asarray(x),
                                  j_vn.VirtualState(jnp.asarray(z),
                                                    jnp.asarray(s)),
                                  jnp.asarray(msgs), jnp.asarray(mask))
    axis = make_gnn_mesh(device="cpu")
    vs = t_vn.VirtualState(t(z), t(s))
    got = t_vn.virtual_aggregate(tblock, t(x), vs, t(msgs), t(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
    on_axis = t_vn.virtual_aggregate(tblock, t(x), vs, t(msgs), t(mask),
                                     axis=axis)
    assert all(torch.equal(a, b) for a, b in zip(on_axis, got))
    dz, ms = t_vn.virtual_node_sums(tblock, t(x), vs, t(msgs), t(mask))
    halves = t_vn.finish_virtual_aggregate(
        tblock, vs, *t_vn.launch_virtual_sums(dz, ms, t(mask).sum(),
                                              axis).wait())
    assert all(torch.equal(a, b) for a, b in zip(halves, got))
    for g, w in zip(t_vn.masked_com_sums(t(x), t(mask), axis),
                    j_vn.masked_com_sums(jnp.asarray(x), jnp.asarray(mask))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
