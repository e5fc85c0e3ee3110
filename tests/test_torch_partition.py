"""Port graph partitioning (``data/partition.py``) vs the JAX package.

Node assignments (random and METIS-like), the shards' senders,
receivers, masks and node fields must equal the reference's exactly for
the same seed, whole or built one ``shard_range`` at a time, re-padded,
and stacked into a batch; ``dynamic_radius`` must return the same radius.
The reference's banded TPU layouts (``lay_*``) have no counterpart: each
port shard carries its CSR layout instead, which must be the one
``data.loader.csr_layout`` builds from the reference's edge arrays.  No
process group is needed here (``tests/test_torch_dist.py`` runs the
ranks).
"""
import warnings

import numpy as np
import pytest

from repro.data import fluid as j_fluid
from repro.data import partition as j_part
from repro.distributed import dist_egnn as j_dist
from repro.distributed import sharding as j_sharding
from repro_torch.data import partition as t_part
from repro_torch.data.loader import csr_layout
from repro_torch.distributed import dist_egnn as t_dist
from repro_torch.distributed import sharding as t_sharding

EXACT = ("x", "v", "h", "x_target", "senders", "receivers", "node_mask",
         "edge_mask")


def _scene(n=200, seed=0):
    s = j_fluid.generate_fluid_dataset(1, n_particles=n, seed=seed)[0]
    return s.x0, s.v0, s.h, s.x1


def assert_same_shards(got, want):
    """Every reference field the port has, bitwise; the port's CSR layout
    built from the reference's edge arrays."""
    for f in EXACT:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for d in range(want.senders.shape[0]):
        lay = csr_layout(want.senders[d], want.receivers[d],
                         want.edge_mask[d], want.x.shape[1])
        for f, w in zip(t_part.LAYOUT_FIELDS, lay):
            np.testing.assert_array_equal(getattr(got, f)[d], w, err_msg=f)


@pytest.mark.parametrize("n,d,seed", [(103, 4, 0), (64, 2, 5), (1000, 3, 9)])
def test_random_partition_exact(n, d, seed):
    got = t_part.random_partition(np.random.default_rng(seed), n, d)
    want = j_part.random_partition(np.random.default_rng(seed), n, d)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("half", [False, True], ids=["full", "half-edges"])
def test_metis_like_partition_exact(d, half):
    from repro.data.radius_graph import radius_graph

    x, *_ = _scene(300, seed=1)
    snd, rcv = radius_graph(x, 0.05)
    if half:  # a directed half list: the undirected neighbourhood matters
        keep = snd < rcv
        snd, rcv = snd[keep], rcv[keep]
    got = t_part.metis_like_partition(x, snd, rcv, d)
    np.testing.assert_array_equal(got, j_part.metis_like_partition(
        x, snd, rcv, d))


@pytest.mark.parametrize("strategy,d,drop,seed", [
    ("random", 2, 0.0, 0), ("random", 4, 0.5, 3), ("metis", 2, 0.0, 1),
    ("metis", 4, 0.75, 2)])
def test_partition_sample_exact(strategy, d, drop, seed):
    x, v, h, t = _scene(200, seed=seed)
    kw = dict(d=d, r=0.06, strategy=strategy, drop_rate=drop, seed=seed)
    assert_same_shards(t_part.partition_sample(x, v, h, t, **kw),
                       j_part.partition_sample(x, v, h, t, **kw))


def test_partition_sample_capacities_exact():
    """Explicit capacities, edge truncation (longest first) included."""
    x, v, h, t = _scene(150, seed=4)
    kw = dict(d=3, r=0.07, n_cap=64, e_cap=300, seed=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # both truncate, both warn
        got = t_part.partition_sample(x, v, h, t, **kw)
        want = j_part.partition_sample(x, v, h, t, **kw)
    assert got.senders.shape == (3, 300) and got.x.shape == (3, 64, 3)
    assert_same_shards(got, want)


@pytest.mark.parametrize("lo,hi", [(0, 1), (1, 3), (3, 4)])
def test_shard_range_exact(lo, hi):
    """One process's block of shards equals the reference's block and the
    same rows of the whole partition at the same edge capacity."""
    x, v, h, t = _scene(200, seed=2)
    kw = dict(d=4, r=0.06, seed=2, e_cap=512)
    got = t_part.partition_sample(x, v, h, t, shard_range=(lo, hi), **kw)
    assert_same_shards(got, j_part.partition_sample(
        x, v, h, t, shard_range=(lo, hi), **kw))
    whole = t_part.partition_sample(x, v, h, t, **kw)
    for f in EXACT + t_part.LAYOUT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f),
                                      getattr(whole, f)[lo:hi])


def test_shard_range_rules_as_reference():
    x, v, h, t = _scene(100)
    for mod in (t_part, j_part):
        with pytest.raises(ValueError, match="e_cap"):
            mod.partition_sample(x, v, h, t, d=4, r=0.06, shard_range=(1, 2))
        with pytest.raises(ValueError, match="outside"):
            mod.partition_sample(x, v, h, t, d=4, r=0.06, e_cap=8,
                                 shard_range=(2, 5))
        with pytest.raises(ValueError, match="strategy"):
            mod.partition_sample(x, v, h, t, d=2, r=0.06, strategy="kmeans")


def test_repad_partition_exact():
    x, v, h, t = _scene(120, seed=6)
    kw = dict(d=2, r=0.05, seed=6)
    got = t_part.partition_sample(x, v, h, t, **kw)
    e_cap = 2 * got.senders.shape[1] + 7
    got = t_part.repad_partition(got, 90, e_cap)
    want = j_part.repad_partition(j_part.partition_sample(x, v, h, t, **kw),
                                  90, e_cap)
    assert got.x.shape == (2, 90, 3) and got.sperm.shape == (2, e_cap)
    assert_same_shards(got, want)


@pytest.mark.parametrize("d,r0,step", [(2, 0.035, 0.002), (4, 0.05, 0.001)])
def test_dynamic_radius_exact(d, r0, step):
    from repro.data.radius_graph import radius_graph

    x, *_ = _scene(250, seed=0)
    target = radius_graph(x, r0)[0].size
    assign = j_part.random_partition(np.random.default_rng(0), 250, d)
    got = t_part.dynamic_radius(x, assign, d, r0, target, step=step)
    assert got == j_part.dynamic_radius(x, assign, d, r0, target, step=step)
    assert got > r0


def test_stack_partitions_host_exact_and_warns_once():
    """Samples of different sizes re-padded to the batch max, as the
    reference stacks them; more than 2x inflation warns once."""
    scenes = [_scene(n, seed=n) for n in (60, 200)]
    kw = dict(d=2, r=0.08)
    tp = [t_part.partition_sample(*s, seed=j, **kw)
          for j, s in enumerate(scenes)]
    jp = [j_part.partition_sample(*s, seed=j, **kw)
          for j, s in enumerate(scenes)]
    t_dist._REPAD_WARNED = False
    with pytest.warns(UserWarning, match="2× inflation"):
        got = t_dist.stack_partitions_host(tp)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        t_dist.stack_partitions_host(tp)
    assert not [w for w in rec if "inflation" in str(w.message)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_dist.stack_partitions_host(jp)
    for f in EXACT:
        assert got[f].shape == want[f].shape, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    n_cap = got["x"].shape[2]
    for d in range(2):
        for b in range(2):
            lay = csr_layout(want["senders"][d, b], want["receivers"][d, b],
                             want["edge_mask"][d, b], n_cap)
            for f, w in zip(t_part.LAYOUT_FIELDS, lay):
                np.testing.assert_array_equal(got[f][d, b], w)


@pytest.mark.parametrize("n,pc", [(4, 1), (4, 2), (8, 4), (6, 3)])
def test_process_shard_range_as_reference(n, pc):
    for pi in range(pc):
        assert t_sharding.process_shard_range(n, pi, pc) == \
            j_sharding.process_shard_range(n, pi, pc)
    assert t_sharding.process_shard_range(n) == (0, n)  # no group: one
    with pytest.raises(ValueError, match="divisible"):
        t_sharding.process_shard_range(5, 0, 2)
