"""Every width the reference's kernel dispatch admits, on the port.

* The port's dispatch rule (``core.message_passing.kernel_supported``,
  with the reference's VMEM budget) decides exactly as the JAX package's
  over a grid of node counts, widths (the budget's edges included), gates
  and feature use.
* The edge and virtual wrappers' plain versions (what they run on the
  CPU) against the reference's Pallas kernels in interpret mode at widths
  other than 64, forward (atol / rtol 1e-4) and backward (each gradient
  within 1e-3 of its largest magnitude): the DESIGN.md §3.2 tolerances.
* The CUDA kernels take a width that is not compiled by zero-padding it
  up to one that is; the kernels' schedules, emulated in plain PyTorch
  with the tensor core's k-steps (``mm_tensor_core``) and the features of
  a row summed in order, give bitwise the same outputs padded and
  unpadded, and hold the oracles at width 32 and at a padded width.
* The simulate CLI with ``--use-kernel`` builds the reference's model
  (hidden 32, s_dim 16), and s_dim never reaches the kernels' widths.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import message_passing as j_mp
from repro.core.graph import GeometricGraph as JGraph
from repro.kernels import ref as j_ref
from repro.kernels.edge_message import edge_pathway_bwd_fused as j_edge_bwd
from repro.kernels.edge_message import edge_pathway_fused as j_edge
from repro.kernels.virtual_message import \
    virtual_pathway_bwd_fused as j_virtual_bwd
from repro.kernels.virtual_message import virtual_pathway_fused as j_virtual
from repro_torch.core import message_passing as t_mp
from repro_torch.core.graph import GeometricGraph as TGraph
from repro_torch.kernels import edge_message, virtual_message
from repro_torch.kernels.runtime import pad_to
from test_torch_bwd_schedule import (GATOL, GRTOL, _edge_graph,
                                     edge_bwd_schedule, sum_in_order,
                                     virtual_bwd_schedule)
from test_torch_fwd_schedule import (edge_fwd_schedule, mm_tensor_core,
                                     virtual_fwd_schedule)

FWD_TOL = 1e-4  # DESIGN.md §3.2, forward
GRAD_TOL = 1e-3  # and gradients, relative to each one's largest magnitude


# ------------------------------------------------------- dispatch rule
GRID_N = (100, 800, 8192, 131072)
GRID_W = (16, 24, 32, 48, 64, 96, 128, 200, 226, 227, 256, 512, 593, 594,
          749, 750, 768)


def _rule_inputs(n, w, gate, use_h):
    """The same layer for both rules: φ1 ``[h_i | h_j | d²] → w → m`` (m =
    1 for the identity gate), a 2-layer gate for 'mlp'; only shapes are
    read, so the arrays are empty where they can be."""
    dh = w if use_h else 0
    m = 1 if gate == "identity" else w
    shapes = [(2 * dh + 1, w), (w, m)]
    gshapes = [(m, w), (w, 1)] if gate == "mlp" else []
    lp_j = {"phi1": [{"w": np.empty(s, np.float32)} for s in shapes],
            "gate": [{"w": np.empty(s, np.float32)} for s in gshapes]}
    lp_t = {"phi1": [{"w": torch.empty(s)} for s in shapes],
            "gate": [{"w": torch.empty(s)} for s in gshapes]}
    feat = max(dh, 1)
    g_j = JGraph(x=np.empty((n, 3)), v=None, h=np.empty((0, feat)),
                 senders=None, receivers=None, edge_attr=np.empty((0, 0)),
                 node_mask=None, edge_mask=None)
    g_t = TGraph(x=torch.empty(n, 3), v=None, h=torch.empty(0, feat),
                 senders=None, receivers=None, edge_attr=torch.empty(0, 0),
                 node_mask=None, edge_mask=None)
    spec_j = j_mp.EdgeSpec(use_h=use_h, gate=gate)
    spec_t = t_mp.EdgeSpec(use_h=use_h, gate=gate)
    return (lp_j, g_j, spec_j), (lp_t, g_t, spec_t)


@pytest.mark.parametrize("n", GRID_N)
def test_kernel_supported_matches_reference(n):
    decided = set()
    for w in GRID_W:
        for gate in ("mlp", "identity", "none"):
            for use_h in (True, False):
                ja, ta = _rule_inputs(n, w, gate, use_h)
                want = j_mp.kernel_supported(*ja)
                assert t_mp.kernel_supported(*ta) == want, (n, w, gate,
                                                            use_h)
                decided.add(want)
    assert decided == {True, False}  # the budget binds somewhere at every N
    # the budget's edges for Dh = H1 = M (DESIGN.md §3.2)
    edges = {8192: (226, 227), 100: (749, 750)}
    if n in edges:
        fits, over = edges[n]
        assert t_mp.kernel_supported(*_rule_inputs(n, fits, "mlp", True)[1])
        assert not t_mp.kernel_supported(
            *_rule_inputs(n, over, "mlp", True)[1])


# ------------------------------------- plain versions vs the Pallas kernels
@functools.lru_cache(maxsize=None)
def _graph(n=64, cap=640, seed=0):
    from repro_torch.data.radius_graph import (csr_indptr, pad_edges,
                                               radius_graph,
                                               sort_edges_by_receiver)

    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    snd, rcv = sort_edges_by_receiver(*radius_graph(x, 0.3))
    sp, rp, em = pad_edges(snd, rcv, cap, x)
    em[: snd.size: 5] = 0.0  # mask holes inside the real slots
    return x, sp, rp, em, csr_indptr(rp, snd.size, n)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _edge_weights(rng, dh, h1, m, gate):
    ws = [_rand(rng, dh, h1, scale=(2 * dh + 1) ** -0.5),
          _rand(rng, dh, h1, scale=(2 * dh + 1) ** -0.5),
          _rand(rng, 1, h1, scale=0.3), _rand(rng, 1, h1, scale=0.1),
          _rand(rng, h1, m, scale=h1 ** -0.5), _rand(rng, 1, m, scale=0.1)]
    if gate == "mlp":
        ws += [_rand(rng, m, h1, scale=m ** -0.5),
               _rand(rng, 1, h1, scale=0.1), _rand(rng, h1, 1,
                                                   scale=h1 ** -0.5)]
    else:
        ws += [np.zeros((1, 1), np.float32)] * 3
    return ws


def _close(got, want, tol=FWD_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _grads_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max()) + 1e-6
        np.testing.assert_allclose(np.asarray(g), w, atol=GRAD_TOL * scale,
                                   rtol=GRAD_TOL)


def _edge_against_pallas(dh, h1, m, gate, rel, clamp, h=None, seed=1):
    x, sp, rp, em, indptr = _graph()
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    h = _rand(rng, n, dh) if h is None else h
    ws = _edge_weights(rng, dh, h1, m, gate)
    g_dx, g_mh = _rand(rng, n, 3), _rand(rng, n, m)
    kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp)
    ja = [jnp.asarray(a) for a in (x, h, sp, rp, em, *ws)]
    want = j_edge(*ja, interpret=True, **kw)
    want_g = j_edge_bwd(*ja, want[2], jnp.asarray(g_dx), jnp.asarray(g_mh),
                        interpret=True, **kw)
    t = torch.from_numpy
    ta = [t(a) for a in (x, h, sp, em, indptr, *ws)]
    got = edge_message.edge_pathway_fused(*ta, **kw)
    for g, w in zip(got, want):
        _close(g, w)
    got_g = edge_message.edge_pathway_bwd_fused(
        *ta[:5], None, None, *ta[5:], got[2].contiguous(), t(g_dx),
        t(g_mh), **kw)
    wanted = [0, 1, 2, 3, 4, 5, 6, 7] + ([8, 9, 10] if gate == "mlp" else [])
    _grads_close([got_g[i] for i in wanted], [want_g[i] for i in wanted])


@pytest.mark.parametrize("dh,h1,m,gate,rel,clamp",
                         [(24, 24, 24, "mlp", "inv1p", 0.05),
                          (48, 48, 48, "none", "raw", math.inf),
                          (24, 40, 56, "mlp", "raw", math.inf)],
                         ids=["24-mlp", "48-none", "24-40-56-mlp"])
def test_edge_plain_matches_pallas_at_width(dh, h1, m, gate, rel, clamp):
    """Gate 'mlp' (inv1p with a clamp that binds, and raw) and 'none',
    forward and backward."""
    _edge_against_pallas(dh, h1, m, gate, rel, clamp)


@pytest.mark.parametrize("form,h1", [("schnet", 24), ("rf", 32)])
def test_identity_plain_matches_pallas_at_width(form, h1):
    """The identity gate in SchNet's form (Dh = H1, rel raw) and RF's (a
    zero feature column, rel inv1p), at H1 other than 64."""
    if form == "schnet":
        _edge_against_pallas(h1, h1, 1, "identity", "raw", 100.0)
    else:
        n = _graph()[0].shape[0]
        _edge_against_pallas(1, h1, 1, "identity", "inv1p", 100.0,
                             h=np.zeros((n, 1), np.float32))


def _virtual_ops(rng, n, c, dh, hid):
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.1).astype(np.float32)
    z = (x[:c] + 0.05 * rng.standard_normal((c, 3))).astype(np.float32)
    vec = lambda: _rand(rng, c, hid, scale=0.3)
    mat = lambda: _rand(rng, c, hid, hid, scale=hid ** -0.5)
    col = lambda: _rand(rng, c, hid, 1, scale=hid ** -0.5)
    return [x, _rand(rng, n, dh), z, mask,
            _rand(rng, c, dh, hid, scale=dh ** -0.5), vec(), vec(), mat(),
            vec(), mat(), vec(), col(), mat(), vec(), col()]


@pytest.mark.parametrize("dh,hid", [(24, 40)], ids=["24-40"])
def test_virtual_plain_matches_pallas_at_width(dh, hid):
    rng = np.random.default_rng(4)
    n, c = 70, 3
    ops = _virtual_ops(rng, n, c, dh, hid)
    cots = [_rand(rng, n, 3), _rand(rng, n, hid), _rand(rng, c, 3),
            _rand(rng, c, hid)]
    ja = [jnp.asarray(a) for a in ops]
    want = j_virtual(*ja, block_n=64, interpret=True)
    want_g = j_virtual_bwd(*ja, *[jnp.asarray(a) for a in cots], block_n=64,
                           interpret=True)
    t = torch.from_numpy
    got = virtual_message.virtual_pathway_fused(*[t(a) for a in ops])
    for g, w in zip(got, want):
        _close(g, w)
    got_g = virtual_message.virtual_pathway_bwd_fused(
        *[t(a) for a in ops], *[t(a) for a in cots])
    _grads_close(got_g, want_g)


# ------------------------------------------- schedules: padding is exact
def _ordered_rowsum(t):
    """The features of each row added in column order: zero columns at the
    end leave every bit."""
    return sum_in_order(list(t.unbind(-1)))


def _ordered_colsum(t):
    """Each column's rows added in row order, whatever the width."""
    return sum_in_order(list(t.unbind(0)))


ORDERED = dict(rowsum=_ordered_rowsum, colsum=_ordered_colsum)


mm_fwd = mm_tensor_core  # each k-step summed on its own (STEP_SUM)
mm_bwd = functools.partial(mm_tensor_core, step_sum=False)


def _pad_edge_operands(h, ws, w):
    """h and the nine edge weights zero-padded to width ``w``."""
    w1r, w1s, w1d, b1, w2, b2, wg1, bg1, wg2 = ws
    return pad_to(h, h.shape[0], w), [
        pad_to(w1r, w, w), pad_to(w1s, w, w), pad_to(w1d, 1, w),
        pad_to(b1, 1, w), pad_to(w2, w, w), pad_to(b2, 1, w),
        pad_to(wg1, w, w), pad_to(bg1, 1, w), pad_to(wg2, w, 1)]


def _unpad(t, shape):
    return t[tuple(slice(0, k) for k in shape)]


def _edge_schedule_case(width):
    x, sp, rp, em, indptr, sperm, sptr = _edge_graph(n=100, ncap=110,
                                                     cap=1500, hub_deg=60)
    rng = np.random.default_rng(7)
    n = x.shape[0]
    t = torch.from_numpy
    h = t(_rand(rng, n, width))
    ws = [t(a) for a in _edge_weights(rng, width, width, width, "mlp")]
    g_dx, g_mh = t(_rand(rng, n, 3)), t(_rand(rng, n, width))
    return (t(x), h, t(sp), t(rp), t(em), t(indptr), t(sperm), t(sptr), ws,
            g_dx, g_mh)


@pytest.mark.parametrize("width,padded", [(24, 32)], ids=["24-to-32"])
def test_edge_schedules_at_width_and_padding_exact(width, padded):
    """The forward and backward edge schedules at width 24 and padded to
    the compiled width 32: the unpadded run within the tolerances of the
    oracles (``edge_pathway_ref`` and its ``jax.vjp``), and the padded
    run's outputs bitwise the unpadded run's."""
    x, h, sp, rp, em, indptr, sperm, sptr, ws, g_dx, g_mh = \
        _edge_schedule_case(width)
    kw = dict(gate_mode="mlp", rel_mode="inv1p", clamp=0.05)
    jargs = [jnp.asarray(a.numpy()) for a in (x, h, sp, rp, em)]
    jws = [jnp.asarray(w.numpy()) for w in ws]
    want = j_ref.edge_pathway_ref(*jargs, *jws, **kw)
    f = lambda xx, hh, *ww: j_ref.edge_pathway_ref(
        xx, hh, *jargs[2:], *ww, **kw)[:2]
    _, vjp = jax.vjp(f, jargs[0], jargs[1], *jws)
    want_g = vjp((jnp.asarray(g_dx.numpy()), jnp.asarray(g_mh.numpy())))
    sched = dict(n_ctas=5, **kw)
    fwd = edge_fwd_schedule(x, h, sp, em, indptr, *ws, mm=mm_fwd,
                            rowsum=_ordered_rowsum, **sched)
    deg = fwd[2]
    bwd = edge_bwd_schedule(x, h, sp, em, indptr, sperm, sptr, *ws, deg,
                            g_dx, g_mh, mm=mm_bwd, **ORDERED, **sched)
    for g, w in zip(fwd, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-4)
    for g, w in zip(bwd, want_g[:2]):  # gx, gh
        scale = float(np.abs(np.asarray(w)).max())
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=GATOL * scale, rtol=GRTOL)
    hp, wsp = _pad_edge_operands(h, ws, padded)
    fwd_p = edge_fwd_schedule(x, hp, sp, em, indptr, *wsp, mm=mm_fwd,
                              rowsum=_ordered_rowsum, **sched)
    bwd_p = edge_bwd_schedule(x, hp, sp, em, indptr, sperm, sptr, *wsp,
                              fwd_p[2], g_dx, pad_to(g_mh, g_mh.shape[0],
                                                     padded),
                              mm=mm_bwd, **ORDERED, **sched)
    for a, b in zip(fwd, fwd_p):
        assert torch.equal(a, _unpad(b, a.shape))
    for a, b in zip(bwd, bwd_p):
        assert torch.equal(a, _unpad(b, a.shape))


def test_virtual_schedules_padding_exact():
    """The virtual forward and backward schedules at width 24 and padded to
    32: bitwise the same outputs, within the oracles' tolerance."""
    rng = np.random.default_rng(9)
    n, c, w, wp = 90, 3, 24, 32
    ops = [torch.from_numpy(a) for a in _virtual_ops(rng, n, c, w, w)]
    cots = [torch.from_numpy(a) for a in (
        _rand(rng, n, 3), _rand(rng, n, w), _rand(rng, c, 3),
        _rand(rng, c, w))]
    want = j_ref.virtual_pathway_ref(*[jnp.asarray(a.numpy()) for a in ops])
    fwd = virtual_fwd_schedule(*ops, mm=mm_fwd, **ORDERED)
    for g, wv in zip(fwd, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-5,
                                   rtol=1e-4)
    pops = virtual_message.pad_ops(tuple(ops), wp, wp)
    pcots = [cots[0], pad_to(cots[1], n, wp), cots[2], pad_to(cots[3], c, wp)]
    fwd_p = virtual_fwd_schedule(*pops, mm=mm_fwd, **ORDERED)
    for a, b in zip(fwd, fwd_p):
        assert torch.equal(a, _unpad(b, a.shape))
    bwd = virtual_bwd_schedule(*ops, *cots, mm=mm_bwd, **ORDERED)
    bwd_p = virtual_bwd_schedule(*pops, *pcots, mm=mm_bwd, **ORDERED)
    for a, b in zip(bwd, bwd_p):
        assert torch.equal(a, _unpad(b, a.shape))


# -------------------------------------------------- the hidden-32 model
def test_simulate_cli_builds_the_reference_model(capsys):
    """``--use-kernel`` builds the JAX package's simulate model: 2 layers,
    hidden 32, C = 3, s_dim 16 (its ``launch/simulate.py``), and its edge
    and virtual steps take the kernel path (here the plain versions)."""
    from repro_torch.launch import simulate

    assert simulate.main(["--n", "120", "--steps", "2", "--use-kernel",
                          "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "layers=2 hidden=32 n_virtual=3 s_dim=16" in out
    assert "edge_kernel=" in out and "edge_plain=0" in out
    assert "virtual_plain=0" in out


@pytest.mark.parametrize("s_dim", [16, 32, 64])
def test_s_dim_never_reaches_the_kernel_widths(s_dim):
    """s_dim is folded into const1 before the virtual kernel: at hidden 32
    the kernels' operands are 32 wide whatever s_dim is."""
    from repro_torch.kernels.ops import unpack_virtual_block
    from repro_torch.pipeline import build_pipeline

    pipe = build_pipeline("fast_egnn", device="cpu",
                          generator=torch.Generator().manual_seed(0),
                          n_layers=1, hidden=32, n_virtual=3, s_dim=s_dim)
    vb = pipe.params["layers"][0]["virtual"]
    s = pipe.params["s_init"]
    w = unpack_virtual_block(vb, s, torch.zeros(3, 3), 32)
    assert w["w1h"].shape == (3, 32, 32) and w["const1"].shape == (3, 32)
    assert all(v.shape[1] == 32 for v in w.values())
    assert edge_message.kernel_route(32, w["w1h"].shape[2]) == "w32"
