"""Port rollout engines, ``Pipeline.rollout``, the simulate CLI and the
serving plane.

* against the JAX package: ``BatchedRolloutEngine`` (host rebuilds) over 3
  scenes and 6 steps with at least one Verlet rebuild, trajectories to 1e-4;
  ``Pipeline.rollout`` in device and host mode against the JAX package's,
  trajectories and ``per_step_mse`` to 1e-4;
* port against itself, bitwise: batched == single-scene runs, replica
  padding, trajectories independent of the skin, and the
  ``RolloutService`` stream == ``engine.run`` (device rebuilds == host
  rebuilds and async == sync host rebuilds are in
  ``test_torch_rollout_rebuild.py``, which imports this file's fixtures
  and helpers, so that the two run on two test workers);
* service behaviour: admission errors, batching window, capacity
  isolation, queue backpressure, LRU eviction and re-admission.
"""
import jax
import numpy as np
import pytest
import torch

from repro.pipeline import build_pipeline as j_build_pipeline
from repro.rollout.engine import BatchedRolloutEngine as JEngine
from repro.rollout.engine import _resolve_rebuild_mode as j_resolve
from repro_torch.launch import simulate
from repro_torch.pipeline import build_pipeline
from repro_torch.rollout import BatchedRolloutEngine, RolloutEngine
from repro_torch.rollout.engine import _resolve_rebuild_mode
from repro_torch.serving import (AdmissionError, BucketKey, DynamicBatcher,
                                 LRUCache, PendingRequest, ProgramCache,
                                 ProgramKey, QueueFullError, RolloutService,
                                 ServiceConfig, capacity_bucket,
                                 validate_scene)
from repro_torch.weights import params_from_jax

SMALL = dict(n_layers=2, hidden=16, s_dim=16, n_virtual=3)
R, SKIN, DT = 0.35, 0.1, 0.05
NODE_CAP, EDGE_CAP = 48, 48 * 48
TOL = 1e-4


def _scene(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    v0 = (0.01 * rng.standard_normal((n, 3))).astype(np.float32)
    return x0, v0, np.ones((n, 1), np.float32)


@pytest.fixture(scope="module")
def jax_pipe():
    return j_build_pipeline("fast_egnn", jax.random.PRNGKey(0), **SMALL)


@pytest.fixture(scope="module")
def pipe(jax_pipe):
    params = params_from_jax(jax.tree.map(np.asarray, jax_pipe.params),
                             device="cpu")
    return build_pipeline("fast_egnn", device="cpu", use_kernel=True,
                          params=params, **SMALL)


def _engine(p, batch_size, **kw):
    base = dict(batch_size=batch_size, node_cap=NODE_CAP, edge_cap=EDGE_CAP,
                r=R, skin=SKIN, dt=DT, device="cpu")
    base.update(kw)
    return BatchedRolloutEngine(p.predict_fn, **base)


# ------------------------------------------------------ against the JAX one
@pytest.mark.parametrize("drop_rate", [0.0, 0.3])
def test_batched_rollout_matches_reference(jax_pipe, pipe, drop_rate):
    scenes = [_scene(n, seed=s) for s, n in enumerate((40, 36, 30))]
    want = JEngine(jax_pipe.predict_fn, batch_size=3, node_cap=NODE_CAP,
                   edge_cap=EDGE_CAP, r=R, skin=SKIN, dt=DT,
                   drop_rate=drop_rate, rebuild_mode="host"
                   ).run(jax_pipe.params, scenes, 6)
    got = _engine(pipe, 3, drop_rate=drop_rate).run(pipe.params, scenes, 6)
    assert got.rebuild_count >= 1
    assert got.rebuild_steps == want.rebuild_steps
    for a, b in zip(got.trajectories, want.trajectories):
        assert a.shape == b.shape == (6, a.shape[1], 3)
        assert float(np.max(np.abs(a - b))) <= TOL


def test_rebuild_modes():
    kw = dict(batch_size=1, node_cap=8, edge_cap=8, r=R, skin=SKIN, dt=DT,
              device="cpu")
    for mode in ("device", "host"):
        assert BatchedRolloutEngine(None, rebuild_mode=mode,
                                    **kw).rebuild_mode == mode
    with pytest.raises(ValueError, match="rebuild_mode"):
        BatchedRolloutEngine(None, rebuild_mode="gpu", **kw)
    eng = BatchedRolloutEngine(None, **kw)
    assert eng.rebuild_mode == "device" and eng.traces == 0
    kw["r"] = np.inf
    assert BatchedRolloutEngine(None, **kw).rebuild_mode == "host"


@pytest.mark.parametrize("mode", ["auto", "device", "host"])
@pytest.mark.parametrize("r_build", [0.45, 0.0, np.inf])
@pytest.mark.parametrize("want_async", [None, False, True])
def test_resolve_rebuild_mode_matches_reference(mode, r_build, want_async):
    assert (_resolve_rebuild_mode(mode, r_build, want_async)
            == j_resolve(mode, r_build, want_async))


def test_single_engine_auto_mode_selection():
    kw = dict(r=R, skin=SKIN, dt=DT, device="cpu")
    assert RolloutEngine(None, **kw).rebuild_mode == "device"
    assert not RolloutEngine(None, **kw).async_rebuild
    assert RolloutEngine(None, r=np.inf, skin=0.0, dt=DT,
                         device="cpu").rebuild_mode == "host"
    eng = RolloutEngine(None, async_rebuild=True, **kw)
    assert eng.rebuild_mode == "host" and eng.async_rebuild
    eng = RolloutEngine(None, rebuild_mode="host", **kw)
    assert eng.async_rebuild  # skin > 0: async by default in host mode
    with pytest.raises(ValueError, match="rebuild_mode"):
        RolloutEngine(None, rebuild_mode="gpu", **kw)
    with pytest.raises(ValueError, match="rebuild_margin"):
        RolloutEngine(None, rebuild_margin=0.0, **kw)


# ------------------------------------------------ port against itself
@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel-layout", "plain"])
def test_batched_equals_singles_bitwise(pipe, use_kernel):
    p = pipe if use_kernel else build_pipeline(
        "fast_egnn", device="cpu", params=pipe.params, **SMALL)
    scenes = [_scene(n, seed=s) for s, n in enumerate((40, 33, 45))]
    res = _engine(p, 3).run(p.params, scenes, 6)
    assert res.n_scenes == 3 and res.rebuild_count >= 1
    for s, scene in enumerate(scenes):
        one = _engine(p, 1).run(p.params, [scene], 6)
        np.testing.assert_array_equal(res.trajectories[s],
                                      one.trajectories[0])


@pytest.mark.parametrize("drop_rate", [0.0, 0.5])
@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["kernel-layout", "plain"])
def test_trajectories_bitwise_independent_of_skin(pipe, use_kernel,
                                                  drop_rate):
    """DESIGN.md §10.2, the reference's ``tests/test_rollout.py:135``: the
    skin is an execution knob only.  Skin 0 rebuilds every step; skin 0.4
    reuses a Verlet list whose candidates outside r are masked per step;
    the trajectories are array_equal."""
    p = pipe if use_kernel else build_pipeline(
        "fast_egnn", device="cpu", params=pipe.params, **SMALL)
    scenes = [_scene(n, seed=s) for s, n in enumerate((40, 33))]
    r0 = _engine(p, 2, skin=0.0, drop_rate=drop_rate).run(p.params, scenes, 8)
    r1 = _engine(p, 2, skin=0.4, drop_rate=drop_rate).run(p.params, scenes, 8)
    assert r1.rebuild_count < r0.rebuild_count  # the list was reused...
    for a, b in zip(r0.trajectories, r1.trajectories):
        assert np.isfinite(a).all()
        assert np.array_equal(a, b)  # ...invisibly


def test_engine_hands_predict_fn_each_slots_csr_layout(pipe):
    """Every step gets ``(indptr, n_edges)`` matching that slot's Verlet
    list: rows of the first ``n_edges`` slots, the padded tail outside."""
    seen = []

    def spy(params, g, lay):
        seen.append((g.receivers.clone(), lay[0].clone(), lay[1].clone()))
        return pipe.predict_fn(params, g, lay)

    scenes = [_scene(n, seed=s) for s, n in enumerate((40, 30))]
    res = BatchedRolloutEngine(spy, batch_size=3, node_cap=NODE_CAP,
                               edge_cap=EDGE_CAP, r=R, skin=SKIN, dt=DT,
                               device="cpu").run(pipe.params, scenes, 4)
    # one call a step, and one for each step a chunk computed past a
    # failed skin check and dropped
    assert len(seen) == 4 + res.discarded_steps and res.rebuild_count >= 1
    for rcv, indptr, n_edges in seen:
        assert indptr.shape == (3, NODE_CAP + 1) and indptr.dtype == torch.int32
        for b in range(3):
            e = int(n_edges[b])
            assert 0 < e < EDGE_CAP and int(indptr[b, -1]) == e
            counts = torch.bincount(rcv[b, :e].long(), minlength=NODE_CAP)
            assert torch.equal(torch.diff(indptr[b]).long(), counts)
        assert torch.equal(indptr[2], indptr[1])  # replica of the last scene


def test_short_batch_replica_padding(pipe):
    scenes = [_scene(40, seed=s) for s in range(2)]
    res = _engine(pipe, 3).run(pipe.params, scenes, 4)
    assert res.n_scenes == 2 and res.batch_size == 3
    for s, scene in enumerate(scenes):
        one = _engine(pipe, 1).run(pipe.params, [scene], 4)
        np.testing.assert_array_equal(res.trajectories[s],
                                      one.trajectories[0])


def test_streaming_chunks_cover_all_steps_in_order(pipe):
    scenes = [_scene(40, seed=s) for s in range(2)]
    starts, blocks = [], []
    res = _engine(pipe, 2).run(
        pipe.params, scenes, 6,
        on_chunk=lambda s, f: (starts.append(s), blocks.append(f)))
    assert res.chunk_calls == len(starts) >= 2
    assert starts[0] == 0
    for i in range(1, len(starts)):
        assert starts[i] == starts[i - 1] + blocks[i - 1].shape[1]
    full = np.concatenate(blocks, axis=1)
    assert full.shape == (2, 6, NODE_CAP, 3)
    for s in range(2):
        np.testing.assert_array_equal(full[s, :, :40], res.trajectories[s])


def test_wrap_box_bounds_and_divergence_guard(pipe):
    scene = _scene(40, seed=7)
    res = _engine(pipe, 1, wrap_box=1.0).run(pipe.params, [scene], 6)
    tr = res.trajectories[0]
    assert np.isfinite(tr).all() and tr.min() >= 0.0 and tr.max() < 1.0
    bad = (scene[0], np.full_like(scene[1], 1e30), scene[2])
    with pytest.raises(FloatingPointError, match="diverged"):
        _engine(pipe, 1, skin=0.0).run(pipe.params, [bad], 3)
    with pytest.raises(ValueError, match="capacity bucket"):
        _engine(pipe, 1).run(pipe.params, [_scene(NODE_CAP + 1)], 1)


# --------------------------------------------- Pipeline.rollout and the CLI
@pytest.mark.parametrize("mode", ["device", "host"])
def test_pipeline_rollout_matches_reference(jax_pipe, pipe, mode):
    """Six steps with at least one rebuild (ROADMAP queue C: keep the
    horizon), trajectories and per-step MSE within 1e-4."""
    x0, v0, h = _scene(40, seed=8)
    targets = x0[None] + 0.01 * np.arange(1, 7)[:, None, None]
    kw = dict(r=R, skin=SKIN, dt=DT, drop_rate=0.3, targets=targets,
              rebuild_mode=mode)
    want = jax_pipe.rollout(jax_pipe.params, (x0, v0, h), 6, **kw)
    got = pipe.rollout(pipe.params, (x0, v0, h), 6, **kw)
    assert got.rebuild_mode == mode and got.rebuild_count >= 1
    assert got.rebuild_steps == want.rebuild_steps
    assert float(np.max(np.abs(got.trajectory - want.trajectory))) <= TOL
    np.testing.assert_allclose(got.per_step_mse, want.per_step_mse,
                               rtol=TOL, atol=0)
    cached = pipe._rollout_engines.stats()
    again = pipe.rollout(pipe.params, (x0, v0, h), 6, **kw)
    assert np.array_equal(again.trajectory, got.trajectory)
    after = pipe._rollout_engines.stats()  # the engine came from the LRU
    assert after["size"] == cached["size"]
    assert after["hits"] == cached["hits"] + 1


def test_pipeline_rollout_engine_lru_and_mesh_refusal(pipe):
    from repro_torch.pipeline import ROLLOUT_ENGINE_CACHE

    p = build_pipeline("fast_egnn", device="cpu", params=pipe.params,
                       **SMALL)
    x0, v0, h = _scene(20, seed=9)
    for k in range(ROLLOUT_ENGINE_CACHE + 1):
        p.rollout(p.params, (x0, v0, h), 1, r=R, skin=SKIN, dt=DT + k)
    stats = p._rollout_engines.stats()
    assert stats["size"] == ROLLOUT_ENGINE_CACHE and stats["evictions"] == 1
    from repro_torch.distributed.dist_egnn import make_gnn_mesh

    mesh = build_pipeline("fast_egnn", device="cpu", params=pipe.params,
                          mesh=make_gnn_mesh(device="cpu"), **SMALL)
    # a mesh pipeline rolls out through DistRolloutEngine (no refusal
    # since the distributed rollout was ported); one rank is single-device
    got = mesh.rollout(mesh.params, (x0, v0, h), 1, r=R, skin=SKIN, dt=DT)
    want = p.rollout(p.params, (x0, v0, h), 1, r=R, skin=SKIN, dt=DT)
    assert np.array_equal(got.trajectory, want.trajectory)
    from repro_torch.rollout import DistRolloutEngine
    [key] = mesh._rollout_engines.keys()
    assert isinstance(mesh._rollout_engines.get(key), DistRolloutEngine)


def test_service_refuses_a_mesh_pipeline(pipe):
    """``RolloutService`` serves the single-device path: a mesh pipeline
    is refused at construction, naming the mesh path's entry point."""
    from repro_torch.distributed.dist_egnn import make_gnn_mesh

    mesh = build_pipeline("fast_egnn", device="cpu", params=pipe.params,
                          mesh=make_gnn_mesh(device="cpu"), **SMALL)
    with pytest.raises(ValueError, match="DistRolloutEngine"):
        RolloutService(mesh)


def test_simulate_cli_on_cpu(capsys):
    assert simulate.main(["--device", "cpu", "--n", "48", "--steps", "4",
                          "--use-kernel"]) == 0
    out = capsys.readouterr().out
    assert "scene n=48" in out and "device=cpu" in out
    assert "4 steps in" in out and "host-blocking" in out
    assert "trajectory span" in out
    assert simulate.main(["--device", "cpu", "--n", "48", "--steps", "2",
                          "--model", "egnn"]) == 0
    assert "model=egnn" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # argparse refuses a name outside
        simulate.main(["--device", "cpu", "--model", "gcn"])  # the registry


# ------------------------------------------------------------ pure caches
def test_lru_cache_evicts_least_recently_used():
    lru = LRUCache(2)
    assert lru.put("a", 1) is None and lru.put("b", 2) is None
    assert lru.get("a") == 1
    assert lru.put("c", 3) == ("b", 2)
    assert "b" not in lru and "a" in lru and "c" in lru
    assert lru.stats() == {"size": 2, "capacity": 2, "hits": 1,
                           "misses": 0, "evictions": 1}
    assert lru.get("b") is None and lru.misses == 1


def test_program_cache_builds_once_per_key():
    pc = ProgramCache(1)
    k1 = ProgramKey("m", 16, 256, 2, R, SKIN, DT, 0.0, None)
    k2 = ProgramKey("m", 32, 512, 2, R, SKIN, DT, 0.0, None)
    built = []
    assert pc.get_or_build(k1, lambda: built.append(1) or "e1") == "e1"
    assert pc.get_or_build(k1, lambda: built.append(1) or "e1b") == "e1"
    pc.get_or_build(k2, lambda: "e2")
    assert pc.get_or_build(k1, lambda: built.append(1) or "e1c") == "e1c"
    assert pc.builds == 3 and len(built) == 2


def test_capacity_bucket_ladder():
    assert capacity_bucket(1, (16, 32)) == 16
    assert capacity_bucket(17, (16, 32)) == 32
    with pytest.raises(AdmissionError, match="largest configured"):
        capacity_bucket(33, (16, 32))


def test_validate_scene_rejects_malformed():
    x, v, h = _scene(6)
    assert validate_scene(x, v, h)[0].dtype == np.float32
    with pytest.raises(AdmissionError, match=r"x must have shape \(n, 3\)"):
        validate_scene(x[:, :2], v, h)
    with pytest.raises(AdmissionError, match="v must have shape"):
        validate_scene(x, v[:5], h)
    with pytest.raises(AdmissionError, match="h must have shape"):
        validate_scene(x, v, h[:3])
    with pytest.raises(AdmissionError, match="floating point"):
        validate_scene(x, v, h.astype(np.int32))
    bad = x.copy()
    bad[2, 1] = np.nan
    with pytest.raises(AdmissionError, match="non-finite"):
        validate_scene(bad, v, h)
    with pytest.raises(AdmissionError, match="empty"):
        validate_scene(x[:0], v[:0], h[:0])


def _bucket(node_cap=16, edge_cap=256, r=R):
    return BucketKey(node_cap=node_cap, edge_cap=edge_cap, r=r, skin=SKIN,
                     dt=DT, drop_rate=0.0, wrap_box=None)


def _pending(bucket, t, rid):
    x, v, h = _scene(14, seed=rid)
    return PendingRequest(x0=x, v0=v, h=h, n_steps=5, bucket=bucket,
                          enqueue_t=t, request_id=rid)


def test_batcher_window_full_batch_and_isolation():
    b = DynamicBatcher(max_batch=2, window_s=0.1, queue_cap=16)
    bk, other = _bucket(), _bucket(32, 512)
    b.admit(_pending(bk, 0.00, 0))
    b.admit(_pending(other, 0.01, 1))
    assert b.next_batch(now=0.05) is None  # inside the window
    assert b.next_deadline() == pytest.approx(0.10)
    b.admit(_pending(bk, 0.02, 2))          # bk is now a full batch
    key, batch = b.next_batch(now=0.02)
    assert key == bk and [p.request_id for p in batch] == [0, 2]
    key, batch = b.next_batch(now=0.2)       # other's window expired
    assert key == other and [p.request_id for p in batch] == [1]
    assert len(b) == 0 and b.next_batch(now=1.0) is None


def test_batcher_backpressure_queue_full():
    b = DynamicBatcher(max_batch=4, window_s=0.1, queue_cap=2)
    b.admit(_pending(_bucket(), 0.0, 0))
    b.admit(_pending(_bucket(), 0.0, 1))
    with pytest.raises(QueueFullError, match="2/2"):
        b.admit(_pending(_bucket(), 0.0, 2))
    b.next_batch(now=1.0)
    b.admit(_pending(_bucket(), 2.0, 3))


# ------------------------------------------------------------- the service
def _svc_cfg(**kw):
    base = dict(max_batch=4, window_s=0.25, queue_cap=16,
                node_buckets=(16, NODE_CAP), edge_cap_per_node=48)
    base.update(kw)
    return ServiceConfig(**base)


def test_service_stream_equals_engine_run(pipe):
    """Two same-bucket requests with different horizons share one batch;
    each streams exactly its own frames, bitwise equal to ``engine.run``."""
    (xa, va, ha), (xb, vb, hb) = _scene(40, seed=0), _scene(35, seed=1)
    with RolloutService(pipe, config=_svc_cfg()) as svc:
        h1 = svc.submit(xa, va, ha, 3, r=R, skin=SKIN, dt=DT)
        h2 = svc.submit(xb, vb, hb, 6, r=R, skin=SKIN, dt=DT)
        f1 = [f.copy() for f in h1.frames()]
        f2 = [f.copy() for f in h2.frames()]
        t1, t2 = h1.result(), h2.result()
    m = svc.metrics()
    assert len(f1) == 3 and len(f2) == 6
    assert t1.shape == (3, 40, 3) and t2.shape == (6, 35, 3)
    for frames, traj in ((f1, t1), (f2, t2)):
        for i, f in enumerate(frames):
            np.testing.assert_array_equal(f, traj[i])
    ref = _engine(pipe, 4).run(pipe.params, [(xa, va, ha), (xb, vb, hb)], 6)
    np.testing.assert_array_equal(t1, ref.trajectories[0][:3])
    np.testing.assert_array_equal(t2, ref.trajectories[1])
    assert m["occupancy_hist"] == {"2/4": 1}
    assert m["completed"] == 2 and m["program_cache"]["builds"] == 1
    assert m["latency_p50_s"] > 0


def test_service_capacity_buckets_never_mix(pipe):
    with RolloutService(pipe, config=_svc_cfg()) as svc:
        hs = [svc.submit(*_scene(n, seed=s), 2, r=R, skin=SKIN, dt=DT)
              for s, n in enumerate((10, 30, 12, 40))]
        trajs = [hd.result() for hd in hs]
    m = svc.metrics()
    assert [t.shape[1] for t in trajs] == [10, 30, 12, 40]
    assert m["occupancy_hist"] == {"2/4": 2}
    assert sorted(k.node_cap for k in svc._programs.keys()) == [16, NODE_CAP]
    assert m["program_cache"]["builds"] == 2


def test_service_lru_eviction_readmission_rebuilds_once(pipe):
    cfg = _svc_cfg(engine_cache=1, window_s=0.05)
    small, big = _scene(10, seed=0), _scene(30, seed=1)

    def one(svc, scene):
        return svc.submit(*scene, 2, r=R, skin=SKIN, dt=DT).result()

    with RolloutService(pipe, config=cfg) as svc:
        first = one(svc, small)
        one(svc, small)
        assert svc._programs.builds == 1
        one(svc, big)
        assert svc._programs.builds == 2
        again = one(svc, small)
        assert svc._programs.builds == 3
        one(svc, small)
        assert svc._programs.builds == 3
    np.testing.assert_array_equal(first, again)
    assert svc.metrics()["program_cache"]["evictions"] == 2


def test_service_queue_full_backpressure(pipe):
    with RolloutService(pipe, config=_svc_cfg(queue_cap=0)) as svc:
        with pytest.raises(QueueFullError, match="backpressure"):
            svc.submit(*_scene(10), 2, r=R, skin=SKIN, dt=DT)
    m = svc.metrics()
    assert m["rejected"] == 1 and m["submitted"] == 0


def test_service_rejects_malformed_and_oversized(pipe):
    with RolloutService(pipe, config=_svc_cfg()) as svc:
        x, v, h = _scene(10)
        with pytest.raises(AdmissionError, match="non-finite"):
            svc.submit(np.full_like(x, np.inf), v, h, 2, r=R, skin=SKIN,
                       dt=DT)
        with pytest.raises(AdmissionError, match="largest configured"):
            svc.submit(*_scene(NODE_CAP + 1), 2, r=R, skin=SKIN, dt=DT)
        with pytest.raises(AdmissionError, match="n_steps"):
            svc.submit(x, v, h, 0, r=R, skin=SKIN, dt=DT)


def test_service_batch_failure_reaches_every_stream(pipe):
    bad = _scene(10)
    bad = (bad[0], np.full_like(bad[1], 1e30), bad[2])
    with RolloutService(pipe, config=_svc_cfg(window_s=0.05)) as svc:
        hd = svc.submit(*bad, 4, r=R, skin=0.0, dt=DT)
        with pytest.raises(FloatingPointError, match="diverged"):
            hd.result()
        with pytest.raises(FloatingPointError):
            list(hd.frames())
    assert svc.metrics()["failed"] == 1
