"""Port rollout engines: device Verlet rebuilds against host rebuilds.

Split from ``test_torch_rollout.py`` (whose module fixtures and helpers
it imports), so that the two files run on two test workers.  Port
against itself, bitwise: device rebuilds == host rebuilds in both
engines (drop rate, ``wrap_box``, ``skin=0``, cell-list overflow
adaptation), the single-scene engine == the batched one, asynchronous ==
synchronous host rebuilds; and the single-scene engine's targets, caps
and divergence guard.
"""
import numpy as np
import pytest

from repro_torch.rollout import RolloutEngine
from test_torch_rollout import (DT, EDGE_CAP, NODE_CAP, R, SKIN, _engine,
                                _scene, jax_pipe, pipe)  # noqa: F401


# ----------------------------------------- device rebuilds == host rebuilds
def _single(p, mode, **kw):
    base = dict(r=R, skin=SKIN, dt=DT, drop_rate=0.3, device="cpu",
                rebuild_mode=mode)
    if mode == "host":
        base["async_rebuild"] = False
    base.update(kw)
    return RolloutEngine(p.predict_fn, **base)


def _assert_device_telemetry(res):
    assert res.rebuild_mode == "device"
    assert res.coord_d2h_bytes == 0 and res.edge_h2d_bytes == 0
    assert res.rebuild_waits == 0
    assert res.steady_state_d2h_bytes == 0


@pytest.mark.parametrize("case", ["drop", "wrap_box", "skin0"])
def test_single_engine_device_equals_host_bitwise(pipe, case):
    kw = {"drop": {}, "wrap_box": dict(wrap_box=1.0),
          "skin0": dict(skin=0.0)}[case]
    x0, v0, h = _scene(40, seed=2)
    steps = 8
    rh = _single(pipe, "host", **kw).run(pipe.params, x0, v0, h, steps)
    ed = _single(pipe, "device", **kw)
    rd = ed.run(pipe.params, x0, v0, h, steps)
    assert np.array_equal(rh.trajectory, rd.trajectory)
    assert rd.rebuild_steps == rh.rebuild_steps and rd.rebuild_count >= 1
    _assert_device_telemetry(rd)
    assert rh.coord_d2h_bytes > 0 and rh.edge_h2d_bytes > 0
    assert rh.steady_state_d2h_bytes == 0
    if case == "skin0":
        assert rd.rebuild_count == steps - 1
    rd2 = ed.run(pipe.params, x0, v0, h, steps)  # a cached engine, again
    assert np.array_equal(rh.trajectory, rd2.trajectory)
    _assert_device_telemetry(rd2)
    assert rd2.recompiles == 0 and rd2.cell_overflows == 0


@pytest.mark.parametrize("case", ["drop", "wrap_box", "skin0"])
def test_batched_engine_device_equals_host_bitwise(pipe, case):
    kw = {"drop": dict(drop_rate=0.3), "wrap_box": dict(wrap_box=1.0),
          "skin0": dict(skin=0.0)}[case]
    scenes = [_scene(n, seed=s) for s, n in enumerate((40, 33))]
    steps = 8
    rh = _engine(pipe, 3, rebuild_mode="host", **kw).run(pipe.params,
                                                          scenes, steps)
    ed = _engine(pipe, 3, rebuild_mode="device", **kw)
    rd = ed.run(pipe.params, scenes, steps)
    for a, b in zip(rh.trajectories, rd.trajectories):
        assert np.array_equal(a, b)
    assert rd.rebuild_steps == rh.rebuild_steps and rd.rebuild_count >= 1
    assert rh.rebuild_waits == rh.rebuild_count  # host rebuilds block
    _assert_device_telemetry(rd)
    # the skin checks are read once a chunk, at its end: no fetch in the
    # steady state (the reference's while_loop contract)
    assert rd.d2h_bytes > 0 and rd.steady_state_d2h_bytes == 0
    assert rh.steady_state_d2h_bytes == 0
    if case == "skin0":
        assert rd.rebuild_count == steps - 1
    rd2 = ed.run(pipe.params, scenes, steps)
    for a, b in zip(rh.trajectories, rd2.trajectories):
        assert np.array_equal(a, b)
    _assert_device_telemetry(rd2)
    assert rd2.cell_overflows == 0  # the adapted cell_cap sticks


def test_device_overflow_adaptation_stays_bitwise(pipe):
    """A cell_cap of 1 forces overflow adaptations: the trajectories do
    not change, the retries stay on the device, and the grown cell_cap
    sticks, so a re-run has no overflow."""
    x0, v0, h = _scene(40, seed=3)
    rh = _single(pipe, "host").run(pipe.params, x0, v0, h, 8)
    ed = _single(pipe, "device", cell_cap=1)
    rd = ed.run(pipe.params, x0, v0, h, 8)
    assert np.array_equal(rh.trajectory, rd.trajectory)
    assert ed._cell_overflows >= 1 and ed._cell_cap > 1
    _assert_device_telemetry(rd)
    rd2 = ed.run(pipe.params, x0, v0, h, 8)
    assert np.array_equal(rh.trajectory, rd2.trajectory)
    assert rd2.cell_overflows == 0

    scenes = [_scene(n, seed=s) for s, n in enumerate((40, 33))]
    bh = _engine(pipe, 2, rebuild_mode="host").run(pipe.params, scenes, 8)
    eb = _engine(pipe, 2, rebuild_mode="device", cell_cap=1)
    bd = eb.run(pipe.params, scenes, 8)
    for a, b in zip(bh.trajectories, bd.trajectories):
        assert np.array_equal(a, b)
    assert eb._cell_overflows >= 1 and 1 < eb._cell_cap <= NODE_CAP
    _assert_device_telemetry(bd)
    assert eb.run(pipe.params, scenes, 8).cell_overflows == 0


def test_single_engine_equals_batched(pipe):
    scene = _scene(40, seed=4)
    one = _single(pipe, "device", node_cap=NODE_CAP, edge_cap=EDGE_CAP
                  ).run(pipe.params, *scene, 8)
    bat = _engine(pipe, 2, drop_rate=0.3).run(pipe.params, [scene], 8)
    assert np.array_equal(one.trajectory, bat.trajectories[0])


def test_async_host_rebuild_equals_sync(pipe):
    """The two-reference rule: the stale list stays valid while the build
    runs, so asynchronous rebuilds give the synchronous trajectory."""
    x0, v0, h = _scene(40, seed=5)
    rs = _single(pipe, "host").run(pipe.params, x0, v0, h, 10)
    ea = _single(pipe, "host", async_rebuild=True)
    ra = ea.run(pipe.params, x0, v0, h, 10)
    assert ea.async_rebuild and ra.rebuild_count >= 1
    assert np.array_equal(rs.trajectory, ra.trajectory)
    assert len(ra.trigger_steps) >= ra.rebuild_count
    assert all(t <= s for t, s in zip(ra.trigger_steps, ra.rebuild_steps))
    assert 0 <= ra.rebuild_waits <= ra.rebuild_count


def test_single_engine_targets_and_caps(pipe):
    x0, v0, h = _scene(40, seed=6)
    eng = _single(pipe, "device", edge_headroom=2.0)
    res = eng.run(pipe.params, x0, v0, h, 4, targets=np.zeros((4, 40, 3)))
    want = np.mean(np.sum(res.trajectory ** 2, axis=-1), axis=-1) / 3.0
    np.testing.assert_allclose(res.per_step_mse, want, rtol=1e-6)
    from repro_torch.data.radius_graph import radius_graph
    assert eng.node_cap == 40
    assert eng.edge_cap == int(np.ceil(
        radius_graph(x0, R + SKIN)[0].size * 2.0))
    with pytest.raises(ValueError, match="targets cover 3 steps"):
        eng.run(pipe.params, x0, v0, h, 4, targets=np.zeros((3, 40, 3)))
    with pytest.raises(ValueError, match="n_steps must be positive"):
        eng.run(pipe.params, x0, v0, h, 0)
    bad = np.full_like(v0, 1e30)
    for mode in ("device", "host"):
        with pytest.raises(FloatingPointError, match="diverged"):
            _single(pipe, mode, skin=0.0).run(pipe.params, x0, bad, h, 3)
