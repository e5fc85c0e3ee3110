"""Port data path vs the JAX package: integer outputs must be exactly equal.

Covers ``radius_graph``, ``sort_edges_by_receiver``, ``pad_edges``,
``drop_longest_edges``, ``pad_nodes``, the fluid generator, the rollout
engine's per-step edge masks, ``csr_indptr`` and ``csr_sender_perm`` —
including the padded tail trap: ``pad_edges`` fills the tail with
receiver 0 and sender 0, so row offsets and the sender permutation must
come from the first ``n_edges`` slots only — and the batch loader.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import fluid as j_fluid
from repro.data import radius_graph as j_rg
from repro.kernels.ref import edge_pathway_ref as j_edge_ref
from repro.rollout.engine import _step_edge_masks as j_step_masks
from repro_torch.data import fluid as t_fluid
from repro_torch.data import radius_graph as t_rg
from repro_torch.kernels import edge_message
from repro_torch.rollout.engine import _step_edge_masks as t_step_masks

ATOL, RTOL = 1e-5, 1e-4


def _points(kind: str, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    if kind == "clustered":
        c = rng.uniform(0.0, 1.0, (4, 3))
        return (c[rng.integers(0, 4, n)]
                + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    return rng.uniform(0.0, 1.0, (n, 3))  # float64


@pytest.mark.parametrize("kind", ["uniform", "clustered", "float64"])
@pytest.mark.parametrize("r", [0.15, 0.3, np.inf])
def test_radius_graph_exact(kind, r):
    x = _points(kind, 120, seed=3)
    for got, want in zip(t_rg.radius_graph(x, r), j_rg.radius_graph(x, r)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_radius_graph_max_neighbors_exact():
    x = _points("uniform", 100, seed=4)
    for got, want in zip(t_rg.radius_graph(x, 0.3, max_num_neighbors=5),
                         j_rg.radius_graph(x, 0.3, max_num_neighbors=5)):
        np.testing.assert_array_equal(got, want)


def test_sort_edges_by_receiver_exact():
    x = _points("uniform", 80, seed=5)
    snd, rcv = j_rg.radius_graph(x, 0.3)
    perm = np.random.default_rng(0).permutation(snd.size)
    for got, want in zip(t_rg.sort_edges_by_receiver(snd[perm], rcv[perm]),
                         j_rg.sort_edges_by_receiver(snd[perm], rcv[perm])):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_drop_longest_edges_exact(p):
    x = _points("uniform", 90, seed=6)
    snd, rcv = j_rg.radius_graph(x, 0.3)
    for got, want in zip(t_rg.drop_longest_edges(x, snd, rcv, p),
                         j_rg.drop_longest_edges(x, snd, rcv, p)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("capacity,with_x", [(2000, True), (150, True),
                                             (150, False)])
def test_pad_edges_exact_and_warns_once(capacity, with_x):
    x = _points("uniform", 60, seed=7)
    snd, rcv = j_rg.radius_graph(x, 0.3)
    xx = x if with_x else None
    t_rg.reset_truncation_warnings()
    j_rg.reset_truncation_warnings()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        got = t_rg.pad_edges(snd, rcv, capacity, xx)
        t_rg.pad_edges(snd, rcv, capacity, xx)
    truncating = snd.size > capacity
    assert sum("edge truncation" in str(m.message) for m in w) == truncating
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_rg.pad_edges(snd, rcv, capacity, xx)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pad_nodes_exact():
    arr = _points("uniform", 10, seed=8)
    for a, b in zip(t_rg.pad_nodes(arr, 16), j_rg.pad_nodes(arr, 16)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="exceed capacity"):
        t_rg.pad_nodes(arr, 8)


def test_fluid_generator_exact():
    kw = dict(n_particles=64, dt_frames=3, warmup=2, seed=11)
    got = t_fluid.generate_fluid_dataset(2, **kw)
    want = j_fluid.generate_fluid_dataset(2, **kw)
    for a, b in zip(got, want):
        for fa, fb in zip(a, b):
            np.testing.assert_array_equal(fa, fb)


def _verlet_case(seed=9, n=100, r=0.2, skin=0.06, cap=4000):
    """A Verlet list built at r + skin, positions then moved by < skin/2."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    snd, rcv = j_rg.sort_edges_by_receiver(*j_rg.radius_graph(x0, r + skin))
    sp, rp, em = j_rg.pad_edges(snd, rcv, cap, x0)
    x1 = (x0 + 0.25 * skin * rng.uniform(-1, 1, (n, 3)) / np.sqrt(3)
          ).astype(np.float32)
    return x1, sp, rp, em, snd.size, r


@pytest.mark.parametrize("p", [0.0, 0.3])
def test_step_edge_masks_kept_set_exact(p):
    x, sp, rp, em, _, r = _verlet_case()
    r2 = float(np.float32(r) ** 2)
    want = np.asarray(j_step_masks(jnp.asarray(x), jnp.asarray(sp),
                                   jnp.asarray(rp), jnp.asarray(em),
                                   np.float32(r) ** 2, p))
    got = t_step_masks(torch.from_numpy(x), torch.from_numpy(sp),
                       torch.from_numpy(rp), torch.from_numpy(em), r2, p)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < np.count_nonzero(em)


def test_step_edge_masks_break_directed_twin_ties_like_reference():
    """Every undirected pair has two directed edges of bitwise-equal d²:
    an odd keep count splits a pair, and the (d², receiver, sender) rank
    must keep exactly the twin the reference keeps."""
    x, sp, rp, em, e, r = _verlet_case(seed=12)
    valid = np.asarray(j_step_masks(jnp.asarray(x), jnp.asarray(sp),
                                    jnp.asarray(rp), jnp.asarray(em),
                                    np.float32(r) ** 2, 0.0))
    n_valid = int(valid.sum())
    for p in (0.1, 0.25, 0.45):
        n_keep = int(np.round(np.float32(1.0 - p) * np.float32(n_valid)))
        want = np.asarray(j_step_masks(jnp.asarray(x), jnp.asarray(sp),
                                       jnp.asarray(rp), jnp.asarray(em),
                                       np.float32(r) ** 2, p))
        got = t_step_masks(torch.from_numpy(x), torch.from_numpy(sp),
                           torch.from_numpy(rp), torch.from_numpy(em),
                           float(np.float32(r) ** 2), p).numpy()
        assert want.sum() == n_keep
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ csr_indptr
def test_csr_indptr_counts_real_slots_only():
    x, sp, rp, em, e, _ = _verlet_case()
    n = x.shape[0]
    indptr = t_rg.csr_indptr(rp, e, n)
    assert indptr.dtype == np.int32 and indptr.shape == (n + 1,)
    assert indptr[-1] == e
    np.testing.assert_array_equal(np.diff(indptr), np.bincount(rp[:e],
                                                               minlength=n))
    # the padded tail holds receiver 0 after the last real receiver: it is
    # not sorted, and counting it would pile every pad slot onto node 0
    assert rp[e:].size and (rp[e:] == 0).all() and rp[e - 1] > 0
    with pytest.raises(ValueError, match="receiver-sorted"):
        t_rg.csr_indptr(rp, rp.size, n)


def _edge_case_weights(dh=16, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)
    return (f(dh, dh), f(dh, dh), f(1, dh), f(1, dh), f(dh, dh), f(1, dh),
            f(dh, dh), f(1, dh), f(dh, 1))


def _csr_plain_vs_reference(x, h, sp, rp, em, indptr):
    ws = _edge_case_weights(h.shape[1])
    want = j_edge_ref(*map(jnp.asarray, (x, h, sp, rp, em, *ws)), clamp=0.5)
    got = edge_message.edge_pathway_fused(
        *map(torch.from_numpy, (x, h, sp, em, indptr, *ws)), clamp=0.5)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=RTOL)


def test_csr_indptr_plain_path_matches_reference_on_padded_list():
    x, sp, rp, em, e, _ = _verlet_case()
    h = np.random.default_rng(1).standard_normal((x.shape[0], 16)
                                                 ).astype(np.float32)
    _csr_plain_vs_reference(x, h, sp, rp, em, t_rg.csr_indptr(rp, e, x.shape[0]))


def test_csr_indptr_stays_valid_under_step_mask_holes():
    """Between rebuilds only the edge mask changes: the offsets of the
    rebuild stay valid for every step's holes."""
    x, sp, rp, em, e, r = _verlet_case(seed=13)
    indptr = t_rg.csr_indptr(rp, e, x.shape[0])
    h = np.random.default_rng(2).standard_normal((x.shape[0], 16)
                                                 ).astype(np.float32)
    for p in (0.0, 0.3):
        keep = t_step_masks(torch.from_numpy(x), torch.from_numpy(sp),
                            torch.from_numpy(rp), torch.from_numpy(em),
                            float(np.float32(r) ** 2), p)
        em_step = keep.numpy().astype(np.float32)
        assert 0 < em_step.sum() < e
        _csr_plain_vs_reference(x, h, sp, rp, em_step, indptr)


# ------------------------------------------------------- csr_sender_perm
def test_csr_sender_perm_sorts_real_slots_only():
    x, sp, rp, em, e, _ = _verlet_case(seed=3)
    n = x.shape[0]
    perm, sptr = t_rg.csr_sender_perm(sp, e, n)
    assert perm.dtype == np.int32 and sptr.dtype == np.int32
    assert perm.shape == (e,) and sptr.shape == (n + 1,) and sptr[-1] == e
    # the padded tail (sender 0) is not part of the permutation
    assert sp[e:].size and (sp[e:] == 0).all() and perm.max() < e
    np.testing.assert_array_equal(perm, np.argsort(sp[:e], kind="stable"))
    np.testing.assert_array_equal(np.diff(sptr),
                                  np.bincount(sp[:e], minlength=n))
    for s in (0, 7, n - 1):  # each sender's slots, in slot order
        mine = perm[sptr[s]:sptr[s + 1]]
        np.testing.assert_array_equal(mine, np.flatnonzero(sp[:e] == s))
    with pytest.raises(ValueError, match="senders in"):
        t_rg.csr_sender_perm(sp, e, 5)
    empty, eptr = t_rg.csr_sender_perm(sp, 0, n)
    assert empty.size == 0 and not eptr.any()


# ------------------------------------------------------------------ loader
def test_dataset_to_batches_matches_reference_and_carries_layout():
    from repro.data.loader import dataset_to_batches as j_batches
    from repro_torch.data import loader as t_loader

    data = j_fluid.generate_fluid_dataset(5, n_particles=40)
    want = j_batches(data, 2, r=0.05, shuffle_seed=3, with_layout=False)
    got = t_loader.dataset_to_batches(data, 2, r=0.05, shuffle_seed=3,
                                      device="cpu")
    assert len(got) == len(want) == 3
    for tb, jb in zip(got, want):
        for k in tb.graph._fields:
            np.testing.assert_array_equal(getattr(tb.graph, k).numpy(),
                                          np.asarray(getattr(jb.graph, k)))
        np.testing.assert_array_equal(tb.x_target.numpy(), jb.x_target)
        indptr, n_edges, sperm, sptr = (a.numpy() for a in tb.layout)
        for b in range(indptr.shape[0]):
            rcv, snd = tb.graph.receivers[b].numpy(), tb.graph.senders[b]
            e = int(n_edges[b])
            assert e == int(tb.graph.edge_mask[b].sum())
            np.testing.assert_array_equal(indptr[b],
                                          t_rg.csr_indptr(rcv, e, 40))
            perm, ptr = t_rg.csr_sender_perm(snd.numpy(), e, 40)
            np.testing.assert_array_equal(sperm[b, :e], perm)
            np.testing.assert_array_equal(sptr[b], ptr)
    assert got[0].sample_mask is None
    np.testing.assert_array_equal(got[-1].sample_mask.numpy(), [1.0, 0.0])
    np.testing.assert_array_equal(np.asarray(want[-1].sample_mask), [1, 0])
    with pytest.warns(UserWarning, match="dropping the trailing 1"):
        assert len(t_loader.dataset_to_batches(data, 2, r=0.05,
                                               drop_last=True,
                                               device="cpu")) == 2
