"""DistEGNN rollout (``Pipeline.rollout`` on a mesh, ``DistRolloutEngine``)
on ``torch.distributed`` (gloo, CPU) against the JAX package, and the
port's own claims.

One module fixture starts, all at once: the reference in one subprocess
with ``--xla_force_host_platform_device_count=4``, whose
``DistRolloutEngine`` rolls one 40-node scene 6 steps in every case below
at D = 2 (two cases also at D = 4); and one process that forks the port's
gloo ranks (D = 2 and D = 4, CPU, ``use_kernel=True``: the kernels' plain
versions on each shard's CSR layout), each writing its own npz.  Both
sides take the same weights: the reference's init scaled by 0.5, so that
a node moves ~3e-3 a step and the 0.02 skin rebuilds every 3–4 steps,
with the asynchronous trigger two steps ahead (at full scale random
weights move nodes ~10 a step and every step rebuilds).  The reference
runs its ``jnp`` path (``use_kernel=False``): its Pallas kernels in
interpret mode inside the shard_map loop would cost minutes to compile.

Against the reference: the frozen assignment (``random`` and ``metis``)
and the ``rebuild_steps`` / ``trigger_steps`` exactly; trajectories and
``per_step_mse`` within 1e-4 over 6 steps (ROADMAP queue C: keep the
horizon).  Port against port, bitwise: device == host rebuilds, async ==
sync host rebuilds, every rank the same result, a forced ``cell_cap``
overflow adapting on every rank with the same trajectory, and a
divergence raising ``FloatingPointError`` on every rank; a one-rank mesh
equals the single-device ``Pipeline.rollout``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.models.fast_egnn import FastEGNNConfig as JCfg
from repro.models.fast_egnn import init_fast_egnn as j_init
from repro.training.checkpoint import save_checkpoint
from repro_torch.distributed.dist_egnn import make_gnn_mesh
from repro_torch.pipeline import build_pipeline
from repro_torch.weights import load_npz

REPO = Path(__file__).resolve().parent.parent
CFG = dict(n_layers=2, hidden=16, h_in=1, n_virtual=3, s_dim=16)
SCALE = 0.5
N, STEPS, R, SKIN, DT = 40, 6, 0.35, 0.02, 0.05
TOL = 1e-4
#: name → (Pipeline.rollout keywords, world sizes the reference runs)
CASES = {
    "dev": (dict(rebuild_mode="device"), (2,)),
    "dev_drop": (dict(rebuild_mode="device", drop_rate=0.25), (2, 4)),
    "dev_metis": (dict(rebuild_mode="device", drop_rate=0.25,
                       partition="metis"), (2,)),
    "host": (dict(rebuild_mode="host", async_rebuild=False,
                  drop_rate=0.25), (2, 4)),
    "async": (dict(rebuild_mode="host", async_rebuild=True,
                   drop_rate=0.25), (2,)),
    "wrap": (dict(rebuild_mode="device", drop_rate=0.25, wrap_box=1.0),
             (2,)),
}
WORLDS = (2, 4)
RANK_TIMEOUT_S = 300
#: the mesh stream's data: fluid scenes, the trailing one dropped
STREAM_SAMPLES, STREAM_NODES, STREAM_R = 5, 48, 0.1

_SCENE = """
def scene():
    rng = np.random.default_rng(0)
    x0 = rng.uniform(0, 1, ({n}, 3)).astype(np.float32)
    v0 = (0.01 * rng.standard_normal(({n}, 3))).astype(np.float32)
    h = np.ones(({n}, 1), np.float32)
    targets = x0[None] + 0.01 * np.arange(1, {steps} + 1)[:, None, None]
    return x0, v0, h, targets
"""

_REF = """
import sys
import jax, numpy as np
from repro.distributed.dist_egnn import make_gnn_mesh
from repro.models.fast_egnn import FastEGNNConfig, init_fast_egnn
from repro.pipeline import build_pipeline
from repro.rollout.engine import DistRolloutEngine
{scene}
CFG, R, SKIN, DT, STEPS = {cfg!r}, {r}, {skin}, {dt}, {steps}
x0, v0, h, targets = scene()
params = jax.tree.map(lambda a: a * {scale},
                      init_fast_egnn(jax.random.PRNGKey(0),
                                     FastEGNNConfig(**CFG)))
out = {{}}
for D in (2, 4):
    mesh = make_gnn_mesh(D)
    pipe = build_pipeline("fast_egnn", jax.random.PRNGKey(0), mesh=mesh,
                          **CFG)
    for name, (kw, worlds) in {cases!r}.items():
        if D not in worlds:
            continue
        kw = dict(kw)
        kw["strategy"] = kw.pop("partition", "random")
        eng = DistRolloutEngine(pipe.apply_full, pipe.cfg, mesh, r=R,
                                skin=SKIN, dt=DT, **kw)
        res = eng.run(params, x0, v0, h, STEPS, targets=targets)
        k = f"{{D}}/{{name}}/"
        out[k + "traj"], out[k + "mse"] = res.trajectory, res.per_step_mse
        out[k + "rebuild_steps"] = np.array(res.rebuild_steps, np.int64)
        out[k + "trigger_steps"] = np.array(res.trigger_steps, np.int64)
        for p, idx in enumerate(eng._idx):
            out[k + f"idx{{p}}"] = idx
np.savez(sys.argv[1], **out)
"""

_RANK = """
import json, sys, warnings
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.distributed.dist_egnn import make_gnn_mesh
from repro_torch.launch.mesh import init_distributed
from repro_torch.pipeline import build_pipeline
from repro_torch.rollout import DistRolloutEngine
from repro_torch.training.trainer import TrainConfig
from repro_torch.weights import load_npz
{scene}
CFG, R, SKIN, DT, STEPS = {cfg!r}, {r}, {skin}, {dt}, {steps}


def rank_main(rank, world, port, inp, out_path):
    warnings.simplefilter("ignore")
    init_distributed(f"localhost:{{port}}", world, rank, device="cpu",
                     verbose=False)
    mesh = make_gnn_mesh(device="cpu")
    params = load_npz(inp + "/params.npz", device="cpu")
    pipe = build_pipeline("fast_egnn", mesh=mesh, params=params,
                          device="cpu", use_kernel=True,
                          train_cfg=TrainConfig(epochs=2, lam_mmd=0.03),
                          **CFG)
    x0, v0, h, targets = scene()
    res, meta = {{}}, {{}}
    for name, (kw, _) in {cases!r}.items():
        r = pipe.rollout(params, (x0, v0, h), STEPS, r=R, skin=SKIN, dt=DT,
                         targets=targets, **kw)
        eng = pipe._rollout_engines._d[pipe._rollout_engines.keys()[-1]]
        k = name + "/"
        res[k + "traj"], res[k + "mse"] = r.trajectory, r.per_step_mse
        for p, idx in enumerate(eng._idx):
            res[k + f"idx{{p}}"] = idx
        meta[name] = dict(
            rebuild_steps=r.rebuild_steps, trigger_steps=r.trigger_steps,
            mode=r.rebuild_mode, coord_d2h=r.coord_d2h_bytes,
            edge_h2d=r.edge_h2d_bytes, steady=r.steady_state_d2h_bytes,
            chunks=r.chunk_calls, discarded=r.discarded_steps,
            cell_cap=eng._cell_cap,
            e_cap=eng.edge_cap, n_cap=eng.node_cap)
    # a forced overflow: cell_cap 1 grows on every rank, same trajectory
    eng = DistRolloutEngine(pipe.apply_full, pipe.cfg, mesh, r=R, skin=SKIN,
                            dt=DT, drop_rate=0.25, rebuild_mode="device",
                            cell_cap=1)
    r = eng.run(params, x0, v0, h, STEPS)
    res["overflow/traj"] = r.trajectory
    meta["overflow"] = dict(cell_overflows=eng._cell_overflows,
                            cell_cap=eng._cell_cap)
    # divergence: every rank raises at the same step, in either mode
    raised = {{}}
    for mode in ("device", "host"):
        eng = DistRolloutEngine(pipe.apply_full, pipe.cfg, mesh, r=R,
                                skin=0.0, dt=DT, rebuild_mode=mode)
        try:
            eng.run(params, x0, np.full_like(v0, 1e30), h, 3)
            raised[mode] = ""
        except FloatingPointError as e:
            raised[mode] = str(e)
    meta["raised"] = raised
    # the group still works after the raises: one more agreed rollout
    r = pipe.rollout(params, (x0, v0, h), 2, r=R, skin=SKIN, dt=DT)
    res["after/traj"] = r.trajectory
    # the mesh stream: this rank's shard of each sample, built by workers
    from repro_torch.data import layout_cache as lc
    from repro_torch.data.fluid import generate_fluid_dataset
    samples = generate_fluid_dataset({ns}, n_particles={nf}, seed=0)
    mk = lambda **kw: pipe.make_batches(samples, 2, r={rs}, **kw)
    threaded = list(mk(num_workers=2, prefetch=2))
    eager = mk(prefetch=0).materialize()
    meta["stream_len"] = len(threaded)
    for i, (a, b) in enumerate(zip(threaded, eager)):
        for f in a._fields[:-1]:
            res[f"stream/{{i}}/{{f}}"] = getattr(a, f).numpy()
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        for j, (la, lb) in enumerate(zip(a.layout, b.layout)):
            res[f"stream/{{i}}/layout{{j}}"] = la.numpy()
            assert torch.equal(la, lb)
    shuffled = mk(reshuffle_each_epoch=True, shuffle_seed=1, num_workers=2)
    for e in range(2):
        for i, b in enumerate(shuffled):
            res[f"shuffled/{{e}}/{{i}}/x"] = b.x.numpy()
    lc.reset_cache_stats()
    mk(cache_dir=inp + f"/lay{{world}}").materialize()
    cold = lc.cache_stats()
    lc.reset_cache_stats()
    warm = mk(cache_dir=inp + f"/lay{{world}}", num_workers=0).materialize()
    meta["cache"] = [cold["builds"], lc.cache_stats()["builds"],
                     lc.cache_stats()["hits"]]
    assert all(torch.equal(a.x, b.x) for a, b in zip(warm, eager))
    meta["fits"] = []
    for src in (mk(num_workers=2), eager):
        pipe.params = params
        meta["fits"].append(pipe.fit(src, src).history)
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
        p.join({timeout})
    for p in procs:
        if p.is_alive():
            p.kill()
    sys.exit(max(abs(p.exitcode) if p.exitcode is not None else 1
                 for p in procs))
"""


def _env(**kw) -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **kw)
    return env


def _scene():
    ns = {"np": np}
    exec(textwrap.dedent(_SCENE.format(n=N, steps=STEPS)), ns)
    return ns["scene"]()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference and every port rank at once; wait for all of
    them; the reference's npz and each world's per-rank results."""
    tmp = tmp_path_factory.mktemp("dist_rollout")
    params = jax.tree.map(lambda a: a * SCALE,
                          j_init(jax.random.PRNGKey(0), JCfg(**CFG)))
    save_checkpoint(str(tmp / "params.npz"), params)
    fmt = dict(scene=_SCENE.format(n=N, steps=STEPS), cfg=CFG, r=R,
               skin=SKIN, dt=DT, steps=STEPS, scale=SCALE, cases=CASES,
               worlds=WORLDS, timeout=RANK_TIMEOUT_S, ns=STREAM_SAMPLES,
               nf=STREAM_NODES, rs=STREAM_R)
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
            _, err = p.communicate(timeout=RANK_TIMEOUT_S + 60)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err[-3000:]
    out = {"ref": dict(np.load(tmp / "ref.npz")),
           "params": load_npz(tmp / "params.npz", device="cpu")}
    for world in WORLDS:
        out[world] = [
            (dict(np.load(tmp / f"w{world}_r{r}.npz")),
             json.loads((tmp / f"w{world}_r{r}.json").read_text()))
            for r in range(world)]
    return out


_REF_CASES = [(w, name) for name, (_, worlds) in CASES.items()
              for w in worlds]


@pytest.mark.parametrize("world,name", _REF_CASES)
def test_assignment_and_rebuild_steps_match_reference(runs, world, name):
    ref = runs["ref"]
    k = f"{world}/{name}/"
    for res, meta in runs[world]:
        for p in range(world):
            np.testing.assert_array_equal(res[f"{name}/idx{p}"],
                                          ref[f"{k}idx{p}"])
        assert meta[name]["rebuild_steps"] == list(ref[k + "rebuild_steps"])
        assert meta[name]["trigger_steps"] == list(ref[k + "trigger_steps"])
        assert meta[name]["mode"] == CASES[name][0]["rebuild_mode"]


@pytest.mark.parametrize("world,name", _REF_CASES)
def test_trajectory_and_mse_match_reference(runs, world, name):
    ref = runs["ref"]
    k = f"{world}/{name}/"
    for res, _ in runs[world]:
        assert res[f"{name}/traj"].shape == (STEPS, N, 3)
        err = float(np.max(np.abs(res[f"{name}/traj"] - ref[k + "traj"])))
        assert err <= TOL, err
        np.testing.assert_allclose(res[f"{name}/mse"], ref[k + "mse"],
                                   rtol=TOL, atol=0)


def test_rollouts_rebuild(runs):
    """The cases exercise what they name: rebuilds in every case, the
    metis and random assignments differ, a trigger ahead of a swap in the
    asynchronous case."""
    meta = runs[2][0][1]
    assert all(len(meta[name]["rebuild_steps"]) >= 1 for name in CASES)
    res = runs[2][0][0]
    assert not np.array_equal(res["dev_metis/idx0"], res["dev_drop/idx0"])
    a = meta["async"]
    assert any(t < s for t, s in zip(a["trigger_steps"], a["rebuild_steps"]))


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_result(runs, world):
    """Every rollout result (not the ranks' own batches) is the same on
    every rank."""
    names = list(CASES) + ["overflow", "after"]
    first, fmeta = runs[world][0]
    for res, meta in runs[world][1:]:
        assert res.keys() == first.keys()
        for k in first:
            if k.split("/")[0] in names:
                np.testing.assert_array_equal(res[k], first[k], err_msg=k)
        for name in names[:-1] + ["raised", "fits"]:
            assert meta[name] == fmeta[name], name


@pytest.mark.parametrize("world", WORLDS)
def test_device_equals_host_and_async_equals_sync(runs, world):
    """Device rebuilds give the host rebuilds' trajectory and async host
    rebuilds the synchronous one, bit for bit; device mode moves no
    coordinates or edges, and no step fetches anything."""
    for res, meta in runs[world]:
        np.testing.assert_array_equal(res["dev_drop/traj"],
                                      res["host/traj"])
        np.testing.assert_array_equal(res["async/traj"], res["host/traj"])
        for name in ("dev", "dev_drop", "dev_metis", "wrap"):
            m = meta[name]
            assert m["coord_d2h"] == 0 and m["edge_h2d"] == 0, name
        assert all(meta[name]["steady"] == 0 for name in CASES)
        assert meta["host"]["coord_d2h"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_forced_overflow_adapts_on_every_rank(runs, world):
    caps = set()
    for res, meta in runs[world]:
        np.testing.assert_array_equal(res["overflow/traj"],
                                      res["dev_drop/traj"])
        assert meta["overflow"]["cell_overflows"] >= 1
        caps.add(meta["overflow"]["cell_cap"])
        assert meta["overflow"]["cell_cap"] <= meta["dev"]["n_cap"]
    assert len(caps) == 1 and caps.pop() > 1


@pytest.mark.parametrize("world", WORLDS)
def test_divergence_raises_on_every_rank(runs, world):
    for res, meta in runs[world]:
        for mode in ("device", "host"):
            assert "diverged" in meta["raised"][mode], mode
        assert meta["raised"] == runs[world][0][1]["raised"]
        assert np.isfinite(res["after/traj"]).all()


def _reference_rows(world: int, order) -> list:
    """The reference's stacked partition of each batch of ``order``
    (sample j of a batch split with seed=j), rank rows leading."""
    import warnings

    from repro.data import fluid as j_fluid
    from repro.data import partition as j_part
    from repro.distributed import dist_egnn as j_dist

    data = j_fluid.generate_fluid_dataset(STREAM_SAMPLES,
                                          n_particles=STREAM_NODES, seed=0)
    rows = []
    for i in range(0, len(order) - 1, 2):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rows.append(j_dist.stack_partitions_host([
                j_part.partition_sample(data[k].x0, data[k].v0, data[k].h,
                                        data[k].x1, d=world, r=STREAM_R,
                                        seed=j)
                for j, k in enumerate(order[i:i + 2])]))
    return rows


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_stream_is_each_ranks_reference_rows(runs, world):
    """A rank's streamed ``ShardedBatch``es (worker threads, prefetch)
    equal the eager mesh batches and are its rows of the reference's
    partition; the trailing sample is dropped."""
    want = _reference_rows(world, list(range(STREAM_SAMPLES)))
    fields = ("x", "v", "h", "senders", "receivers", "node_mask",
              "edge_mask", "x_target")
    for rank, (res, meta) in enumerate(runs[world]):
        assert meta["stream_len"] == len(want) == STREAM_SAMPLES // 2
        for i, rows in enumerate(want):
            for f in fields:
                np.testing.assert_array_equal(res[f"stream/{i}/{f}"],
                                              rows[f][rank], err_msg=f)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_stream_reshuffle_cache_and_fit(runs, world):
    """Reshuffled epochs follow the reference's epoch order; a warm layout
    cache builds nothing on any rank; a fit over the threaded stream
    equals the fit over the eager list."""
    from repro.data.stream import BatchStream as JStream

    order = JStream(list(range(STREAM_SAMPLES)), 2, shuffle_seed=1,
                    reshuffle_each_epoch=True)._order
    for e in range(2):
        want = _reference_rows(world, list(order(e)))
        for rank, (res, _) in enumerate(runs[world]):
            for i, rows in enumerate(want):
                np.testing.assert_array_equal(res[f"shuffled/{e}/{i}/x"],
                                              rows["x"][rank])
    for res, meta in runs[world]:
        assert not np.array_equal(res["shuffled/0/0/x"],
                                  res["shuffled/1/0/x"])
        cold, warm, hits = meta["cache"]
        assert cold >= 1 and warm == 0 and hits >= 1
        streamed, eager = meta["fits"]
        assert streamed == eager and np.isfinite(
            [h["train_loss"] for h in eager]).all()


def test_wrap_box_bounds_every_frame(runs):
    traj = runs[2][0][0]["wrap/traj"]
    assert traj.min() >= 0.0 and traj.max() <= 1.0


def test_one_rank_mesh_rollout_is_bitwise_single_device(runs):
    """A mesh of one rank (no process group) rolls out bitwise what the
    single-device ``Pipeline.rollout`` does at the same capacities, in
    both rebuild modes."""
    params = runs["params"]
    single = build_pipeline("fast_egnn", device="cpu", params=params,
                            use_kernel=True, **CFG)
    mesh = build_pipeline("fast_egnn", device="cpu", params=params,
                          use_kernel=True, mesh=make_gnn_mesh(device="cpu"),
                          **CFG)
    x0, v0, h, targets = _scene()
    for kw in (dict(rebuild_mode="device", drop_rate=0.25),
               dict(rebuild_mode="host", async_rebuild=True)):
        want = single.rollout(params, (x0, v0, h), STEPS, r=R, skin=SKIN,
                              dt=DT, targets=targets, **kw)
        got = mesh.rollout(params, (x0, v0, h), STEPS, r=R, skin=SKIN,
                           dt=DT, targets=targets, **kw)
        np.testing.assert_array_equal(got.trajectory, want.trajectory)
        np.testing.assert_array_equal(got.per_step_mse, want.per_step_mse)
        assert got.rebuild_steps == want.rebuild_steps
        assert got.trigger_steps == want.trigger_steps
        assert got.rebuild_count >= 1
    # the engines are cached apart: the mesh flag leads the key
    assert all(k[0] is False for k in mesh._rollout_engines.keys())
    assert all(k[0] is True for k in single._rollout_engines.keys())


def test_dist_engine_argument_errors():
    from repro_torch.rollout import DistRolloutEngine

    pipe = build_pipeline("fast_egnn", device="cpu", **CFG,
                          mesh=make_gnn_mesh(device="cpu"),
                          generator=torch.Generator().manual_seed(0))
    mk = lambda **kw: DistRolloutEngine(pipe.apply_full, pipe.cfg, pipe.mesh,
                                        **{**dict(r=R, skin=SKIN, dt=DT),
                                           **kw})
    for kw, what in ((dict(skin=-1.0), "skin"),
                     (dict(rebuild_margin=0.0), "rebuild_margin"),
                     (dict(rebuild_margin=1.5), "rebuild_margin"),
                     (dict(wrap_box=0.0), "wrap_box"),
                     (dict(strategy="grid"), "strategy")):
        with pytest.raises(ValueError, match=what):
            mk(**kw)
    x0, v0, h, _ = _scene()
    eng = mk()
    with pytest.raises(ValueError, match="n_steps must be positive"):
        eng.run(pipe.params, x0, v0, h, 0)
    with pytest.raises(ValueError, match="targets cover 2 steps"):
        eng.run(pipe.params, x0, v0, h, 3, targets=np.zeros((2, N, 3)))
