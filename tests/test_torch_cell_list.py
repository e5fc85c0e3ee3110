"""Port device cell-list build (``data/cell_list.py``) against the JAX
package's and against the port's host build, bitwise (DESIGN.md §13).

The same seeded numpy inputs go through ``repro.data.cell_list.
device_radius_build`` (plain ``jnp``, on the CPU), the port's
``device_radius_build`` (plain torch, on the CPU) and the port's host build
``pad_edges(*sort_edges_by_receiver(*radius_graph(x, r)), cap, x)``;
every field must be equal, including ``n_edges``, ``max_occupancy`` and
``overflow``, and ``device_csr`` must equal ``csr_indptr``.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import cell_list as j_cl
from repro_torch.data import cell_list as t_cl
from repro_torch.data.radius_graph import (csr_indptr, pad_edges,
                                           radius_graph,
                                           sort_edges_by_receiver)

DISTS = ["uniform", "clustered", "skewed", "duplicates"]
R_BUILD = 0.35


def _distributions(n=96):
    """The four point sets of the JAX package's cell-list tests."""
    rng = np.random.default_rng(7)
    uniform = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    # clustered: everything inside one cell, the stencil degenerates
    clustered = (0.05 * rng.random((n, 3))).astype(np.float32)
    # skewed: a thin filament along one axis (occupancy varies wildly)
    skewed = np.stack([rng.uniform(0, 10, n), 0.02 * rng.random(n),
                       0.02 * rng.random(n)], axis=1).astype(np.float32)
    # duplicates: exact ties in both position and distance
    dup = uniform.copy()
    dup[n // 2:] = dup[:n - n // 2]
    return {"uniform": uniform, "clustered": clustered, "skewed": skewed,
            "duplicates": dup}


def _host(x, r_build, edge_cap):
    snd, rcv = sort_edges_by_receiver(*radius_graph(x, r_build))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return pad_edges(snd, rcv, edge_cap, x)


def _port(xp, nm, **kw):
    return t_cl.device_radius_build(torch.from_numpy(xp),
                                    torch.from_numpy(nm), **kw)


def _jax(xp, nm, **kw):
    return j_cl.device_radius_build(jnp.asarray(xp), jnp.asarray(nm), **kw)


def _assert_builds_equal(got, want):
    for name in t_cl.DeviceBuild._fields:
        a = getattr(got, name).numpy()
        b = np.asarray(getattr(want, name))
        assert a.dtype == b.dtype, name
        assert np.array_equal(a, b), name


def _assert_host_equal(db, host):
    hs, hr, hm = host
    assert np.array_equal(db.senders.numpy(), hs)
    assert np.array_equal(db.receivers.numpy(), hr)
    assert np.array_equal(db.edge_mask.numpy(), hm)


@pytest.mark.parametrize("edge_cap", [4096, 64], ids=["roomy", "truncating"])
@pytest.mark.parametrize("dist", DISTS)
def test_device_build_bitwise_parity(dist, edge_cap):
    x = _distributions()[dist]
    n = x.shape[0]
    cap = min(n, t_cl.auto_cell_cap(t_cl.cell_occupancy(x, R_BUILD)))
    nm = np.ones(n, np.float32)
    kw = dict(r_build=R_BUILD, edge_cap=edge_cap, cell_cap=cap)
    db = _port(x, nm, **kw)
    _assert_builds_equal(db, _jax(x, nm, **kw))
    assert not bool(db.overflow)
    host = _host(x, R_BUILD, edge_cap)
    _assert_host_equal(db, host)
    n_live = int(np.count_nonzero(host[2]))
    assert int(db.n_edges) == radius_graph(x, R_BUILD)[0].size
    indptr, n_edges = t_cl.device_csr(db.receivers, db.edge_mask, n)
    assert indptr.dtype == torch.int32 and int(n_edges) == n_live
    assert np.array_equal(indptr.numpy(), csr_indptr(host[1], n_live, n))


@pytest.mark.parametrize("edge_cap", [100, 333, 1000])
def test_device_build_truncation_splits_exact_ties(edge_cap):
    """A lattice has many edges of exactly the same length: the edge_cap
    cut falls inside a group of ties, which the canonical order breaks."""
    g = np.arange(5, dtype=np.float32) * np.float32(0.1)
    x = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    nm = np.ones(x.shape[0], np.float32)
    kw = dict(r_build=0.15, edge_cap=edge_cap, cell_cap=8)
    db = _port(x, nm, **kw)
    _assert_builds_equal(db, _jax(x, nm, **kw))
    _assert_host_equal(db, _host(x, 0.15, edge_cap))
    assert int(db.n_edges) > edge_cap
    # the same cut in every row of a batch (rows after the first count
    # their ties and kept edges from their own start)
    xs = np.stack([x[::-1].copy(), x, x[::2].repeat(2, axis=0)[:len(x)]])
    nms = np.ones(xs.shape[:2], np.float32)
    nms[2, 100:] = 0.0
    bd = _port(xs, nms, **kw)
    for j in range(3):
        one = _port(xs[j], nms[j], **kw)
        for name in t_cl.DeviceBuild._fields:
            assert torch.equal(getattr(bd, name)[j], getattr(one, name)), name


def test_cell_occupancy_and_auto_cap_match_reference():
    for x in _distributions().values():
        for r in (0.05, R_BUILD, 2.0):
            assert t_cl.cell_occupancy(x, r) == j_cl.cell_occupancy(x, r)
    for occ in (0, 1, 2, 7, 11, 100):
        assert t_cl.auto_cell_cap(occ) == j_cl.auto_cell_cap(occ)
    assert t_cl.cell_occupancy(np.zeros((0, 3), np.float32), 0.1) == 1
    assert (t_cl.DEFAULT_CELL_HEADROOM, t_cl._CENTER, t_cl._GRID_LIMIT,
            t_cl._MAX_DIM) == (j_cl.DEFAULT_CELL_HEADROOM, j_cl._CENTER,
                               j_cl._GRID_LIMIT, j_cl._MAX_DIM)


def test_device_build_masked_rows_and_padding():
    """Node-capacity padding rows never contribute edges or occupancy."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 1.0, (20, 3)).astype(np.float32)
    xp = np.zeros((32, 3), np.float32)
    xp[:20] = x
    xp[20:] = 0.5  # padding rows on top of real ones: still never counted
    nm = np.zeros(32, np.float32)
    nm[:20] = 1.0
    kw = dict(r_build=0.4, edge_cap=512, cell_cap=20)
    db = _port(xp, nm, **kw)
    _assert_builds_equal(db, _jax(xp, nm, **kw))
    assert not bool(db.overflow)
    _assert_host_equal(db, _host(x, 0.4, 512))
    indptr, _ = t_cl.device_csr(db.receivers, db.edge_mask, 32)
    assert np.array_equal(indptr.numpy(),
                          csr_indptr(db.receivers.numpy(),
                                     int(db.edge_mask.sum()), 32))


def test_device_build_all_masked_scene_is_not_an_overflow():
    x = np.random.default_rng(4).uniform(size=(16, 3)).astype(np.float32)
    nm = np.zeros(16, np.float32)
    kw = dict(r_build=0.4, edge_cap=64, cell_cap=4)
    db = _port(x, nm, **kw)
    _assert_builds_equal(db, _jax(x, nm, **kw))
    assert not bool(db.overflow) and int(db.n_edges) == 0
    assert not db.edge_mask.any()


def test_device_build_overflow_flag():
    """A cell_cap below the true occupancy flags an overflow instead of
    silently dropping pairs, and reports the true occupancy."""
    x = _distributions()["clustered"]
    nm = np.ones(x.shape[0], np.float32)
    kw = dict(r_build=R_BUILD, edge_cap=4096, cell_cap=2)
    db = _port(x, nm, **kw)
    _assert_builds_equal(db, _jax(x, nm, **kw))
    assert bool(db.overflow)
    assert int(db.max_occupancy) == t_cl.cell_occupancy(x, R_BUILD)


def test_device_build_huge_extent_grid():
    """Coordinates spread over ~1e6·r still build: the cell grows with
    the extent instead of overflowing the int32 keys."""
    rng = np.random.default_rng(11)
    x = (1e6 * rng.standard_normal((64, 3))).astype(np.float32)
    nm = np.ones(64, np.float32)
    kw = dict(r_build=0.5, edge_cap=256, cell_cap=64)
    db = _port(x, nm, **kw)
    _assert_builds_equal(db, _jax(x, nm, **kw))
    assert not bool(db.overflow)
    _assert_host_equal(db, _host(x, 0.5, 256))


def test_non_finite_coordinates_flag_an_overflow_like_the_reference():
    x = _distributions()["uniform"].copy()
    x[5, 1] = np.nan
    nm = np.ones(x.shape[0], np.float32)
    kw = dict(r_build=R_BUILD, edge_cap=256, cell_cap=8)
    db = _port(x, nm, **kw)
    assert bool(db.overflow)
    assert bool(db.overflow) == bool(_jax(x, nm, **kw).overflow)


@pytest.mark.parametrize("edge_cap", [4096, 64], ids=["roomy", "truncating"])
def test_batched_build_rows_equal_singles(edge_cap):
    """A batch of 3 scenes (different node counts in one capacity, one of
    them needing the largest cell_cap) gives each scene's lone build."""
    d = _distributions()
    scenes = [d["uniform"][:70], d["clustered"], d["skewed"][:50]]
    cap = max(t_cl.auto_cell_cap(t_cl.cell_occupancy(s, R_BUILD))
              for s in scenes)
    xs = np.zeros((3, 96, 3), np.float32)
    nms = np.zeros((3, 96), np.float32)
    for j, s in enumerate(scenes):
        xs[j, :len(s)] = s
        nms[j, :len(s)] = 1.0
    kw = dict(r_build=R_BUILD, edge_cap=edge_cap, cell_cap=cap)
    db = _port(xs, nms, **kw)
    assert db.senders.shape == (3, edge_cap) and db.overflow.shape == (3,)
    indptr, n_edges = t_cl.device_csr(db.receivers, db.edge_mask, 96)
    for j in range(3):
        one = _port(xs[j], nms[j], **kw)
        for name in t_cl.DeviceBuild._fields:
            assert torch.equal(getattr(db, name)[j], getattr(one, name)), name
        ip, ne = t_cl.device_csr(one.receivers, one.edge_mask, 96)
        assert torch.equal(indptr[j], ip) and torch.equal(n_edges[j], ne)
