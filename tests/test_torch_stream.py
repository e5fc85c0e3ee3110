"""The port's data plane against the JAX package: the nbody and protein
generators, ``data.stream.BatchStream``, ``data.layout_cache``, the
launcher's data flags and ``Pipeline.dispatch_report``.

* the generators bitwise the reference's from the same seed; their
  batches equal the reference's, and one FastEGNN train step on each
  (``use_kernel=True``: the kernels' plain versions on the CPU, against
  the reference's ``jnp`` path) matches the reference's gradients (1e-3
  of each leaf's largest magnitude, the reference's
  ``_assert_tree_close``) and loss (atol 1e-5 / rtol 1e-4);
* the ``BatchStream`` contract (``tests/test_stream.py``'s): the stream
  equals the eager batches and re-iterates identically, synchronous ==
  threaded, reshuffling changes the grouping but not the samples (and
  its order is the reference's), a build error reaches the consumer, and
  a streamed fit equals an eager fit bit for bit;
* the layout cache (the reference's cache tests): round trip, a warm run
  with no build, stale / capacity-mismatched / corrupt entries rebuilt,
  entries shared across streams, and a build claim held by another
  process counted as a duplicate build;
* ``launch/train.py --device cpu`` with its default dataset (nbody), with
  protein, with ``--layout-cache`` (the second run builds nothing) and
  with ``--reshuffle``.

The mesh side of the stream (each rank's shard, streamed) is checked in
``tests/test_torch_dist_rollout.py``, whose fixture starts the ranks.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.data import loader as j_loader
from repro.data import nbody as j_nbody
from repro.data import protein as j_protein
from repro.data.stream import BatchStream as JStream
from repro.pipeline import build_pipeline as j_build
from repro.training.trainer import TrainConfig as JTrainConfig
from repro_torch.data import layout_cache as lc
from repro_torch.data import loader as t_loader
from repro_torch.data import nbody as t_nbody
from repro_torch.data import protein as t_protein
from repro_torch.data.stream import BatchStream
from repro_torch.pipeline import build_pipeline
from repro_torch.training.optim import tree_leaves
from repro_torch.training.trainer import TrainConfig
from repro_torch.weights import params_from_jax

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(n_layers=2, hidden=16, s_dim=16, n_virtual=3)
TC = dict(lam_mmd=0.03, mmd_sample=None, epochs=2, lr=1e-3)
_GRAPH = ("x", "v", "h", "senders", "receivers", "node_mask", "edge_mask")


def _nbody(n_samples=7, n_nodes=12, seed=0):
    return t_nbody.generate_nbody_dataset(n_samples, n_nodes=n_nodes,
                                          seed=seed)


def _batch_arrays(b) -> list:
    """Every tensor of a GraphBatch, as numpy, in a fixed order."""
    out = [getattr(b.graph, k).numpy() for k in _GRAPH]
    out.append(b.x_target.numpy())
    out += [a.numpy() for a in (b.layout or ())]
    if b.sample_mask is not None:
        out.append(b.sample_mask.numpy())
    return out


def assert_batches_equal(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        la, lb = _batch_arrays(a), _batch_arrays(b)
        assert len(la) == len(lb)
        for xa, xb in zip(la, lb):
            assert xa.dtype == xb.dtype
            np.testing.assert_array_equal(xa, xb)


# ------------------------------------------------------------ generators
@pytest.mark.parametrize("seed,n", [(0, 12), (3, 30)])
def test_nbody_bitwise_reference(seed, n):
    want = j_nbody.generate_nbody_dataset(3, n_nodes=n, seed=seed)
    got = t_nbody.generate_nbody_dataset(3, n_nodes=n, seed=seed)
    for g, w in zip(got, want):
        assert g._fields == w._fields
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    rng_a, rng_b = (np.random.default_rng(seed) for _ in range(2))
    for a, b in zip(t_nbody.simulate_nbody(rng_a, 8, 4),
                    j_nbody.simulate_nbody(rng_b, 8, 4)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,n", [(0, 40), (5, 64)])
def test_protein_bitwise_reference(seed, n):
    want = j_protein.generate_protein_dataset(4, n_res=n, seed=seed)
    got = t_protein.generate_protein_dataset(4, n_res=n, seed=seed)
    for g, w in zip(got, want):
        assert g._fields == w._fields
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_one_dimensional_charges_pad_as_reference():
    """``sample_h`` reads nbody's ``charges``; a 1-D charge vector pads as
    the reference's ``sample_to_arrays`` pads it."""
    s = _nbody(1)[0]
    for q in (s.charges, s.charges[:, 0]):
        s1 = s._replace(charges=q)
        got = t_loader.sample_to_arrays(s1.x0, s1.v0, t_loader.sample_h(s1),
                                        s1.x1, node_cap=16)
        want = j_loader.sample_to_arrays(s1.x0, s1.v0, j_loader.sample_h(s1),
                                         s1.x1, node_cap=16)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].shape == want[k].shape, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------- batches and a train step (ref)
def _dataset(name):
    if name == "nbody":
        return (t_nbody.generate_nbody_dataset(3, n_nodes=12),
                j_nbody.generate_nbody_dataset(3, n_nodes=12), np.inf, 1)
    return (t_protein.generate_protein_dataset(3, n_res=32),
            j_protein.generate_protein_dataset(3, n_res=32), 10.0, 4)


class _GradsOut:
    """An optimizer stand-in whose update returns the gradients."""

    def update(self, grads, state, params):
        return grads, state


@pytest.mark.parametrize("name", ["nbody", "protein"])
def test_batches_and_train_step_match_reference(name):
    from repro.training.trainer import build_train_step as j_bts
    from repro_torch.models.fast_egnn import fast_egnn_full
    from repro_torch.training.trainer import build_train_step as t_bts

    tdata, jdata, r, h_in = _dataset(name)
    # the reference's jnp path: its Pallas kernels in interpret mode take
    # ~20 s to compile a train step (tests/test_torch_train.py holds the
    # port's backwards to them)
    jp = j_build("fast_egnn", jax.random.PRNGKey(0), h_in=h_in,
                 train_cfg=JTrainConfig(**TC), use_kernel=False, **SMALL)
    tp = build_pipeline(
        "fast_egnn", device="cpu", train_cfg=TrainConfig(**TC), h_in=h_in,
        params=params_from_jax(jax.tree.map(np.asarray, jp.params),
                               device="cpu"), use_kernel=True, **SMALL)
    jb = list(jp.make_batches(jdata, 2, r=r, num_workers=0))
    tb = tp.make_batches(tdata, 2, r=r)
    assert len(tb) == len(jb) == 2
    for t, j in zip(tb, jb):
        for k in _GRAPH:
            np.testing.assert_array_equal(getattr(t.graph, k).numpy(),
                                          np.asarray(getattr(j.graph, k)))
        np.testing.assert_array_equal(t.x_target.numpy(), j.x_target)
    assert tb[1].sample_mask.tolist() == [1.0, 0.0]
    jstep, _ = j_bts(jp.apply_full, jp.cfg, jp.train_cfg, _GradsOut())
    tstep, _ = t_bts(fast_egnn_full, tp.cfg, tp.train_cfg, _GradsOut())
    for t, j in zip(tb, jb):
        jg, _, jm = jstep(jp.params, None, j, jax.random.PRNGKey(0))
        tg, _, tm = tstep(tp.params, None, t)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   atol=1e-5, rtol=1e-4)
        for g, w in zip(tree_leaves(tg), jax.tree.leaves(jg)):
            w = np.asarray(w)
            scale = float(np.max(np.abs(w))) + 1e-6
            np.testing.assert_allclose(g.numpy() / scale, w / scale,
                                       rtol=1e-3, atol=5e-5)


# ------------------------------------------------------- stream contract
@pytest.mark.parametrize("with_layout", [True, False])
def test_stream_matches_eager_batches(with_layout):
    """Iterating equals the eager list, batch for batch, shuffled or not,
    the mask-padded trailing batch included; indexing is the same list."""
    data = _nbody(7)
    for seed in (None, 3):
        eager = t_loader.dataset_to_batches(data, 3, drop_rate=0.4,
                                            shuffle_seed=seed,
                                            with_layout=with_layout,
                                            device="cpu")
        stream = BatchStream(data, 3, drop_rate=0.4, shuffle_seed=seed,
                             with_layout=with_layout, device="cpu")
        assert len(stream) == len(eager) == 3
        assert_batches_equal(iter(stream), eager)
        assert_batches_equal([stream[i] for i in range(len(stream))], eager)
        assert stream.materialize() is stream.materialize()
    # and both equal the reference's batches
    jb = j_loader.dataset_to_batches(
        j_nbody.generate_nbody_dataset(7, n_nodes=12), 3, drop_rate=0.4,
        shuffle_seed=3, with_layout=False)
    for t, j in zip(eager, jb):
        for k in _GRAPH:
            np.testing.assert_array_equal(getattr(t.graph, k).numpy(),
                                          np.asarray(getattr(j.graph, k)))


def test_stream_reiterates_identically():
    stream = BatchStream(_nbody(6), 2, shuffle_seed=11, device="cpu")
    assert_batches_equal(iter(stream), list(iter(stream)))


def test_stream_sync_and_async_agree():
    data = _nbody(5)
    sync = BatchStream(data, 2, prefetch=0, device="cpu")
    thr = BatchStream(data, 2, prefetch=2, num_workers=3, device="cpu")
    assert_batches_equal(iter(thr), list(iter(sync)))
    one = BatchStream(data, 2, num_workers=1, device="cpu")
    assert_batches_equal(iter(one), list(iter(sync)))


def test_reshuffle_varies_order_not_content_and_matches_reference():
    """Epoch k is ordered by ``default_rng((shuffle_seed, k))``: the
    reference's permutation, so the port's epochs group the samples as
    the reference's do; the grouping moves between epochs, the samples do
    not."""
    data = _nbody(8, n_nodes=10)
    stream = BatchStream(data, 2, shuffle_seed=5, reshuffle_each_epoch=True,
                         with_layout=False, device="cpu")
    jstream = JStream(j_nbody.generate_nbody_dataset(8, n_nodes=10), 2,
                      shuffle_seed=5, reshuffle_each_epoch=True,
                      with_layout=False, num_workers=0)
    epochs = []
    for _ in range(2):
        got = [b.graph.x.numpy() for b in iter(stream)]
        want = [np.asarray(b.graph.x) for b in iter(jstream)]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        epochs.append(got)
    e1, e2 = epochs
    assert not all(np.array_equal(a, b) for a, b in zip(e1, e2))
    key = lambda eps: sorted(float(x[i].sum()) for x in eps
                             for i in range(x.shape[0]))
    assert key(e1) == key(e2)
    for e in (3, 4):
        np.testing.assert_array_equal(stream._order(e), jstream._order(e))


def test_stream_propagates_build_errors():
    class Bad:
        x0 = "not an array"

    for kw in (dict(), dict(prefetch=0)):
        with pytest.raises(Exception):
            list(iter(BatchStream([Bad(), Bad()], 1, device="cpu", **kw)))


def test_stream_drops_trailing_samples_with_a_warning():
    with pytest.warns(UserWarning, match="dropping the trailing 1 samples"):
        stream = BatchStream(_nbody(5), 2, drop_last=True, device="cpu")
    assert len(stream) == len(list(iter(stream))) == 2


@pytest.mark.parametrize("use_kernel", [False, True])
def test_streamed_fit_equals_eager_fit(use_kernel):
    """``fit`` over the threaded stream reproduces the fit over the eager
    list bit for bit: histories and parameters."""
    data = _nbody(7)
    tc = TrainConfig(epochs=3, lam_mmd=0.03, seed=0)

    def run(make):
        pipe = build_pipeline("fast_egnn", device="cpu", train_cfg=tc,
                              use_kernel=use_kernel, h_in=1,
                              generator=torch.Generator().manual_seed(0),
                              n_layers=2, hidden=12, n_virtual=2, s_dim=8)
        return pipe.fit(make(pipe, data[:5]), make(pipe, data[5:]))

    streamed = run(lambda p, d: p.make_batches(d, 2, num_workers=2))
    eager = run(lambda p, d: t_loader.dataset_to_batches(
        d, 2, with_layout=use_kernel, device="cpu"))
    assert streamed.history == eager.history
    for a, b in zip(tree_leaves(streamed.params), tree_leaves(eager.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------- layout cache
def _sample_edges(n=40, seed=0):
    s = _nbody(1, n_nodes=n, seed=seed)[0]
    a = t_loader.sample_to_arrays(s.x0, s.v0, t_loader.sample_h(s), s.x1,
                                  drop_rate=0.5)
    return a["senders"], a["receivers"], a["edge_mask"], a["x"].shape[0]


def _assert_layout_equal(got, want):
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


def test_layout_cache_roundtrip(tmp_path):
    snd, rcv, em, n = _sample_edges()
    cache = lc.LayoutCache(tmp_path)
    fresh = t_loader.csr_layout(snd, rcv, em, n)
    built = lc.get_or_build(cache, snd, rcv, n, edge_mask=em)
    loaded = lc.get_or_build(cache, snd, rcv, n, edge_mask=em)
    _assert_layout_equal(built, fresh)
    _assert_layout_equal(loaded, fresh)
    assert lc.layout_key(snd, rcv, n, edge_mask=em) != lc.layout_key(
        snd, rcv, n + 1, edge_mask=em)


def test_layout_cache_warm_run_zero_builds(tmp_path):
    data = _nbody(5)
    lc.reset_cache_stats()
    cold_batches = t_loader.dataset_to_batches(
        data, 2, cache_dir=str(tmp_path), device="cpu")
    cold = lc.cache_stats()
    # fully connected samples share one edge list, hence one entry
    # (worker threads that miss together each build: duplicate builds)
    assert cold["builds"] >= 1 and cold["hits"] + cold["misses"] == 5
    lc.reset_cache_stats()
    warm = t_loader.dataset_to_batches(data, 2, cache_dir=str(tmp_path),
                                       device="cpu")
    stats = lc.cache_stats()
    assert stats["builds"] == 0 and stats["misses"] == 0, stats
    assert stats["hits"] == 5
    assert_batches_equal(warm, cold_batches)
    assert_batches_equal(warm, t_loader.dataset_to_batches(data, 2,
                                                           device="cpu"))


@pytest.mark.parametrize("damage", ["stale", "capacity", "corrupt"])
def test_layout_cache_bad_entry_rebuilds(tmp_path, damage):
    """An entry of another node count (stale), with a truncated sender
    permutation (capacity mismatch) or of garbage bytes (corrupt) is a
    miss: rebuilt, counted as an error, and repaired on disk."""
    snd, rcv, em, n = _sample_edges()
    cache = lc.LayoutCache(tmp_path)
    key = lc.layout_key(snd, rcv, n, edge_mask=em)
    good = t_loader.csr_layout(snd, rcv, em, n)
    if damage == "stale":
        cache.store(key, t_loader.csr_layout(snd, rcv, em, n + 8))
    elif damage == "capacity":
        cache.store(key, good[:2] + (good[2][:-7], good[3]))
    else:
        lc.get_or_build(cache, snd, rcv, n, edge_mask=em)
        with open(cache._path(key), "wb") as f:
            f.write(b"definitely not an npz")
    lc.reset_cache_stats()
    got = lc.get_or_build(cache, snd, rcv, n, edge_mask=em)
    assert lc.cache_stats()["builds"] == 1
    assert lc.cache_stats()["errors"] == 1
    _assert_layout_equal(got, good)
    lc.reset_cache_stats()
    lc.get_or_build(cache, snd, rcv, n, edge_mask=em)
    assert lc.cache_stats()["hits"] == 1


def test_layout_cache_shared_across_streams(tmp_path):
    data = _nbody(4)
    a = BatchStream(data, 2, cache_dir=str(tmp_path),
                    device="cpu").materialize()
    lc.reset_cache_stats()
    b = BatchStream(data, 2, cache_dir=str(tmp_path), num_workers=0,
                    device="cpu").materialize()
    stats = lc.cache_stats()
    assert stats["builds"] == 0 and stats["hits"] == 4, stats
    assert_batches_equal(b, a)
    assert any(f.endswith(".npz") for f in os.listdir(tmp_path))


_CLAIM = """
import sys
from repro_torch.data.layout_cache import LayoutCache
assert LayoutCache(sys.argv[1]).claim(sys.argv[2])
"""


def test_layout_cache_claim_dedup_across_processes(tmp_path):
    """Another process holds a fresh build claim: ``get_or_build`` does
    not block, re-checks the entry, builds anyway and counts a duplicate
    build, and still lands the entry; a claim older than ``CLAIM_TTL_S``
    is taken over."""
    snd, rcv, em, n = _sample_edges()
    cache = lc.LayoutCache(tmp_path)
    key = lc.layout_key(snd, rcv, n, edge_mask=em)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", _CLAIM, str(tmp_path), key],
                   check=True, env=env, timeout=120)
    assert not cache.claim(key)  # the other process's claim is fresh
    lc.reset_cache_stats()
    lay = lc.get_or_build(cache, snd, rcv, n, edge_mask=em)
    stats = lc.cache_stats()
    assert stats["duplicate_builds"] == 1 and stats["builds"] == 1, stats
    _assert_layout_equal(lay, t_loader.csr_layout(snd, rcv, em, n))
    lc.reset_cache_stats()
    lc.get_or_build(cache, snd, rcv, n, edge_mask=em)
    assert lc.cache_stats() == {"builds": 0, "hits": 1, "misses": 0,
                                "errors": 0, "duplicate_builds": 0}
    claim = cache._path(key) + ".claim"
    old = os.path.getmtime(claim) - lc.CLAIM_TTL_S - 10
    os.utime(claim, (old, old))
    assert cache.claim(key)  # stale: taken over
    cache.release(key)
    assert not os.path.exists(claim)


# --------------------------------------------------------------- launcher
def test_launch_train_data_flags(tmp_path, capsys):
    """The launcher's default dataset (nbody), protein, a layout cache
    whose second run builds nothing, and a reshuffled training stream."""
    from repro_torch.launch import train as launch

    base = ["gnn", "--n-samples", "5", "--batch", "2", "--epochs", "2",
            "--n-layers", "1", "--hidden", "8", "--device", "cpu"]
    launch.main(base + ["--n-nodes", "10"])
    out = capsys.readouterr().out
    assert "epoch 1" in out and "best val MSE" in out
    launch.main(base + ["--dataset", "protein", "--n-nodes", "24"])
    assert "best val MSE" in capsys.readouterr().out
    cache = ["--n-nodes", "10", "--layout-cache", str(tmp_path / "lay")]
    builds = []
    for _ in range(2):
        lc.reset_cache_stats()
        launch.main(base + cache)
        out = capsys.readouterr().out
        assert "layout cache:" in out
        builds.append(lc.cache_stats()["builds"])
    assert builds[0] >= 1 and builds[1] == 0
    launch.main(base + ["--n-nodes", "10", "--reshuffle", "--workers", "2"])
    assert "best val MSE" in capsys.readouterr().out


def test_reshuffle_flag_reorders_only_the_training_stream(monkeypatch):
    """``--reshuffle`` makes the training stream reshuffle each epoch
    (keyed by ``--seed``); the validation stream keeps its order."""
    from repro_torch.launch import train as launch
    from repro_torch.pipeline import Pipeline

    seen = []
    real = Pipeline.make_batches

    def spy(self, samples, batch_size, **kw):
        seen.append(kw)
        return real(self, samples, batch_size, **kw)

    monkeypatch.setattr(Pipeline, "make_batches", spy)
    launch.main(["gnn", "--n-samples", "5", "--n-nodes", "8", "--batch", "2",
                 "--epochs", "1", "--n-layers", "1", "--hidden", "8",
                 "--device", "cpu", "--reshuffle", "--seed", "4",
                 "--prefetch", "3", "--workers", "1"])
    tr, va = seen
    assert tr["reshuffle_each_epoch"] and tr["shuffle_seed"] == 4
    assert not va.get("reshuffle_each_epoch", False)
    assert va.get("shuffle_seed") is None
    for kw in (tr, va):
        assert kw["prefetch"] == 3 and kw["num_workers"] == 1
        assert kw["cache_dir"] is None and kw["r"] == np.inf


# -------------------------------------------------------- dispatch report
@pytest.mark.parametrize("use_kernel", [False, True])
def test_dispatch_report_matches_reference(use_kernel):
    """The same counts as the reference's (the reference names the plain
    path ``jnp``; it counts a program's trace, the port a call), the same
    ``use_kernel``, and the mode: the reference's ``'jnp'`` /
    ``'interpret'`` are the port's ``'plain'`` / ``'cpu'`` (the kernel
    path on CPU tensors runs the kernels' plain versions)."""
    from repro.core import message_passing as j_mp
    from repro_torch.core import message_passing as t_mp

    data = _nbody(2, n_nodes=10)
    jp = j_build("fast_egnn", jax.random.PRNGKey(0), h_in=1,
                 use_kernel=use_kernel, n_layers=2, hidden=12, n_virtual=2,
                 s_dim=8)
    tp = build_pipeline("fast_egnn", device="cpu", h_in=1,
                        use_kernel=use_kernel,
                        params=params_from_jax(jax.tree.map(np.asarray,
                                                            jp.params),
                                               device="cpu"),
                        n_layers=2, hidden=12, n_virtual=2, s_dim=8)
    j_mp.reset_dispatch_counts()
    jp.predict(jp.params, list(jp.make_batches(data, 2, num_workers=0))[0])
    want = jp.dispatch_report()
    t_mp.reset_dispatch_counts()
    tp.predict(tp.params, tp.make_batches(data, 2)[0])
    got = tp.dispatch_report()
    rename = {"edge_jnp": "edge_plain", "virtual_jnp": "virtual_plain"}
    wc = {rename.get(k, k): v for k, v in want["counts"].items()
          if k != "edge_layout_host"}
    # the reference traces one scene of its vmapped batch; the port calls
    # the forward once a scene
    assert got["counts"] == {k: 2 * v for k, v in wc.items()}
    assert got["use_kernel"] == want["use_kernel"] == use_kernel
    assert {"jnp": "plain", "interpret": "cpu"}[want["mode"]] == got["mode"]
    assert got["rollout_engine_cache"] == want["rollout_engine_cache"]
    assert t_mp.dispatch_mode({}, True, "cuda") == "fallback"
    assert t_mp.dispatch_mode({"edge_kernel": 1}, True, "cuda") == "cuda"


def test_receiver_degree_matches_reference():
    from repro.core import message_passing as j_mp
    from repro.core.graph import make_graph as j_make
    from repro_torch.core import message_passing as t_mp
    from repro_torch.core.graph import make_graph as t_make

    rng = np.random.default_rng(0)
    x = rng.uniform(size=(20, 3)).astype(np.float32)
    snd = rng.integers(0, 20, 60)
    rcv = np.sort(rng.integers(0, 20, 60))
    em = (rng.uniform(size=60) > 0.3).astype(np.float32)
    jg = j_make(x, x, np.ones((20, 1), np.float32), snd, rcv)
    jg = jg._replace(edge_mask=jax.numpy.asarray(em))
    tg = t_make(x, x, np.ones((20, 1), np.float32), snd, rcv, device="cpu")
    tg = tg._replace(edge_mask=torch.from_numpy(em))
    np.testing.assert_array_equal(t_mp.receiver_degree(tg).numpy(),
                                  np.asarray(j_mp.receiver_degree(jg)))
