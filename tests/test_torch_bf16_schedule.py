"""The bf16 schedule of the CUDA edge kernels (#1 ``edge_fwd_edges<W,
true>``, #2 ``edge_bwd_edges<W, true>`` / ``edge_bwd_nodes<W, true>``,
their ``node_proj<W, true>``), emulated in plain PyTorch and held to the
plain bf16 versions ``kernels.ref.edge_pathway_ref_bf16`` /
``edge_pathway_bwd_ref_bf16`` (which ``tests/test_torch_bf16.py`` holds to
the JAX package's bf16 kernels).

No CUDA kernel runs on the CPU, so these tests hold the bf16 kernels'
algorithm where the kernels cannot run, as ``tests/test_torch_fwd_schedule.py``
and ``tests/test_torch_bwd_schedule.py`` do for the 3xTF32 route:

* Every tile product is the tensor core's m16n8k16 bf16 MMA
  (``tile_mma_bf``, ``csrc/common.cuh``): operands rounded to bf16 (the
  tiles are stored rounded), the 16 products of a k-step exact and added
  to the accumulator, each MMA's result rounded toward zero; with
  STEP_SUM (the forward's products) each k16 step starts from zero and
  joins the running sum by a round-to-nearest f32 add.
* #1: CTA b owns the receiver rows whose CSR segment starts in its equal
  share of the live slot range, its live slots packed in slot order into
  64-edge tiles, each row's sums in slot order, carried across tiles.
* #2: equal slot ranges, live slots compacted in slot order into tiles;
  the per-slot scratch (g_pre1 and the per-edge dh terms bf16(bf16(g_pre1)
  W1r^T), ... W1s^T) stored as torch.bfloat16 and widened by the node
  pass, which sums it per node in slot / sender-permutation order; the
  weight partials per range, added in range order.

Tolerances.  With round-to-nearest f32 products of the rounded operands
(the plain version's), the schedules reproduce the plain bf16 versions
to 1e-6 (relative L2 per output): every rounding point, the bf16 scratch
and the sum orders are the plain version's.  With the tensor core's
products, every output is within 1e-3 (``BF_L2`` of the kernels' bf16
contract).  Except, in both, the node sums gx and gh of #2: their
summands are rounded to bf16, so a last-bit difference in an edge's g_rel
or dh term (another order of the gate's f32 row sum is enough) can tip
its rounding by a bf16 ulp, and on this 230-node graph one tipped summand
reads ~1e-3 in gx (tensor-core products at width 32: 1.08e-3, two
elements off by half a bf16 ulp of 1).  They are held to the card's elementwise bound for
exactly that (``chip_smoke.py``'s BF_KRTOL |p| + BF_KATOL max|p|), with
under 1 % of their elements differing at all.  Bitwise: #1's outputs,
and #2's gx and gh, do not change with the CTA count or with masked slots
in the layout.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.data.radius_graph import (csr_indptr, csr_sender_perm,
                                           pad_edges, radius_graph,
                                           sort_edges_by_receiver)
from repro_torch.kernels.ref import (edge_pathway_bwd_ref_bf16,
                                     edge_pathway_ref_bf16)
from test_torch_bf16 import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_bwd_schedule import TR, _edge_graph, _silu_grad, sum_in_order
from test_torch_fwd_schedule import _round_to_zero, cta_rows

BF_L2 = 1e-3
BF_KRTOL, BF_KATOL = 2.0 ** -7, 3e-3  # chip_smoke.py's elementwise bound
WIDTHS = (16, 32, 64)


def _b(t):
    """t rounded to bfloat16 (nearest even), held in f32."""
    return t.to(torch.bfloat16).to(torch.float32)


def mm_plain(a, b, step_sum=False):
    """The plain bf16 version's product: bf16(a) @ bf16(b) in f32."""
    return _b(a) @ _b(b)


def mm_bf16(a, b, step_sum=False):
    """``tile_mma_bf``: bf16(a) . bf16(b) as m16n8k16 MMAs, k16 steps in
    order.  A product of two bf16 values is exact, and so is the f64 sum
    of a step's 16 (and the accumulator); each MMA's result is rounded
    toward zero to f32.  ``step_sum``: each step's MMA starts from zero
    and joins the running f32 sum by a round-to-nearest add."""
    a, b = _b(a).double(), _b(b).double()
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], 16):
        p = a[:, k:k + 16] @ b[k:k + 16]
        if step_sum:
            acc = acc + _round_to_zero(p)
        else:
            acc = _round_to_zero(acc.double() + p)
    return acc


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    den = float(torch.linalg.vector_norm(want))
    if den == 0.0:
        return float(torch.linalg.vector_norm(got))
    return float(torch.linalg.vector_norm(got - want)) / den


def _pad(t, rows):
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


def _tiles(a, fn):
    """fn over 64-row tiles of ``a`` (the last padded with zero rows)."""
    return torch.cat([fn(_pad(a[i:i + TR], TR))[:min(TR, a.shape[0] - i)]
                      for i in range(0, a.shape[0], TR)])


def _rel_d2(x, r, s):
    rel = _b(x[r]) - _b(x[s])  # the coordinates rounded where read
    d2 = (rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]) + rel[:, 2] * rel[:, 2]
    return rel, d2


def _pre1(P, Q, r, s, d2, w1d, b1):
    return ((P[r] + Q[s]) + _b(d2)[:, None] * _b(w1d)) + _b(b1)


# ------------------------------------------------------------------- #1
def edge_fwd_bf16_schedule(x, h, snd, em, indptr, w1r, w1s, w1d, b1, w2,
                           b2, wg1, bg1, wg2, *, gate_mode, rel_mode, clamp,
                           n_ctas, mm=mm_bf16):
    """``edge_fwd_edges<W, true>``'s schedule → ``(dx, mh, deg)``, its
    tile products ``mm``."""
    n, m = x.shape[0], w2.shape[1]
    P = _tiles(h, lambda t: mm(t, w1r))
    Q = _tiles(h, lambda t: mm(t, w1s))
    dx = torch.full((n, 3), float("nan"))
    mh = torch.full((n, m), float("nan"))
    deg = torch.full((n, 1), float("nan"))
    rows = cta_rows(indptr, n_ctas)
    row_of = torch.searchsorted(indptr.long(), torch.arange(snd.shape[0]),
                                right=True) - 1

    def finish(r, a, dg, d):
        inv = 1.0 / max(dg, torch.tensor(1.0))
        mh[r], dx[r], deg[r, 0] = a * inv, d * inv, dg

    for b in range(n_ctas):
        r0, r1 = rows[b], rows[b + 1]
        live = [s for s in range(int(indptr[r0]), int(indptr[r1]))
                if em[s] != 0]
        for r in range(r0, r1):  # rows with no live slot
            finish(r, torch.zeros(m), torch.tensor(0.0), torch.zeros(3))
        carry = None
        for t0 in range(0, len(live), TR):
            sl = torch.tensor(live[t0:t0 + TR], dtype=torch.long)
            cnt = sl.numel()
            r, s, e = row_of[sl], snd[sl].long(), em[sl]
            rel, d2 = _rel_d2(x, r, s)
            t1 = _pad(F.silu(_pre1(P, Q, r, s, d2, w1d, b1)), TR)
            msg = mm(t1, w2, step_sum=True) + _b(b2)
            term = torch.zeros((cnt, 3))
            if gate_mode == "mlp":
                u = mm(msg, wg1, step_sum=True) + _b(bg1)
                g = (_b(F.silu(u)) * _b(wg2)[:, 0]).sum(-1)[:cnt]
                g = torch.clamp(g, -clamp, clamp)
                q = rel / (torch.sqrt(d2 + 1e-12) + 1.0)[:, None] if (
                    rel_mode == "inv1p") else rel
                term = _b((q * g[:, None]) * e[:, None])
            for i in range(cnt):  # each row's live edges in slot order
                ri = int(r[i])
                if carry is None or carry[0] != ri:
                    if carry is not None:
                        finish(*carry)
                    carry = (ri, torch.zeros(m), torch.tensor(0.0),
                             torch.zeros(3))
                _, a, dg, d = carry
                carry = (ri, a + _b(msg[i] * e[i]), dg + _b(e[i]),
                         d + term[i])
        if carry is not None:
            finish(*carry)
    return dx, mh, deg


# ------------------------------------------------------------------- #2
def edge_bwd_bf16_schedule(x, h, snd, em, indptr, sperm, sptr, w1r, w1s,
                           w1d, b1, w2, b2, wg1, bg1, wg2, deg, g_dx, g_mh, *,
                           gate_mode, rel_mode, clamp, n_ctas, mm=mm_bf16,
                           scratch=None):
    """``edge_bwd_edges<W, true>`` / ``edge_bwd_nodes<W, true>``'s
    schedule → the 11 gradients, its edge pass's tile products ``mm``;
    ``scratch`` (a dict) receives the per-slot bf16 rows the node pass
    reads."""
    n = x.shape[0]
    h1, m = w1r.shape[1], w2.shape[1]
    gate = gate_mode == "mlp"
    w1d_b, b1_b, b2_b, bg1_b, wg2_b = (_b(w) for w in (w1d, b1, b2, bg1, wg2))
    P = _tiles(h, lambda t: mm(t, w1r))
    Q = _tiles(h, lambda t: mm(t, w1s))
    live_end = int(indptr[n])
    length = -(-live_end // n_ctas)
    slots = snd.shape[0]
    bf = torch.bfloat16
    GPRE1 = torch.zeros((slots, h1), dtype=bf)
    GR = torch.zeros((slots, h1), dtype=bf)
    GS = torch.zeros((slots, h1), dtype=bf)
    GREL = torch.zeros((slots, 3))
    parts = []
    for b in range(n_ctas):
        beg = min(b * length, live_end)
        end = min(beg + length, live_end)
        live = [s for s in range(beg, end) if em[s] != 0]
        p = {k: torch.zeros(v) for k, v in (
            ("w2", (h1, m)), ("wg1", (m, h1)), ("b2", m), ("bg1", h1),
            ("wg2", h1), ("b1", h1), ("w1d", h1))}
        for t0 in range(0, len(live), TR):
            sl = torch.tensor(live[t0:t0 + TR], dtype=torch.long)
            cnt = sl.numel()
            z = lambda t: _pad(t, TR)
            r = torch.searchsorted(indptr.long(), sl, right=True) - 1
            s, e = snd[sl].long(), em[sl]
            rel, d2 = _rel_d2(x, r, s)
            inv = _b(1.0 / torch.clamp(deg[r, 0], min=1.0))
            u = _b(g_dx[r]) * (inv * e)[:, None]
            pre = z(_pre1(P, Q, r, s, d2, w1d, b1))
            t1, sg = F.silu(pre), _silu_grad(pre)
            msg = mm(t1, w2) + b2_b
            gr = torch.zeros((TR, 3))
            gq2 = torch.zeros(TR)
            gm = torch.zeros((TR, m))
            if gate:
                gp = mm(msg, wg1) + bg1_b
                gate_pre = (_b(F.silu(gp)) * wg2_b[:, 0]).sum(-1)[:cnt]
                gv = torch.clamp(gate_pre, -clamp, clamp)
                if rel_mode == "inv1p":
                    sd = torch.sqrt(d2 + 1e-12)
                    kf = 1.0 / (sd + 1.0)
                else:
                    kf = torch.ones_like(d2)
                g_gate = ((u[:, 0] * (rel[:, 0] * kf) + u[:, 1]
                           * (rel[:, 1] * kf)) + u[:, 2] * (rel[:, 2] * kf))
                g_gate = torch.where((gate_pre >= -clamp)
                                     & (gate_pre <= clamp), g_gate, 0.0)
                gu = u * gv[:, None]
                if rel_mode == "inv1p":
                    gr[:cnt] = gu * kf[:, None]
                    gq2[:cnt] = (gu * rel).sum(-1) * (-(kf * kf) / (2 * sd))
                else:
                    gr[:cnt] = gu
                gg = _b(z(g_gate))[:, None]
                ggp = (gg * wg2_b[:, 0]) * _silu_grad(gp)
                p["bg1"] += ggp.sum(0)
                p["wg2"] += (_b(F.silu(gp)) * gg).sum(0)
                p["wg1"] += mm(msg.T, ggp)
                gm = mm(ggp, wg1.T)
            gm = gm + z(_b(g_mh[r]) * (inv * e)[:, None])
            p["b2"] += gm.sum(0)
            p["w2"] += mm(t1.T, gm)
            gpre = mm(gm, w2.T) * sg
            p["b1"] += gpre.sum(0)
            p["w1d"] += (_b(z(d2))[:, None] * _b(gpre)).sum(0)
            g_d2 = gq2 + (_b(gpre) * w1d_b[0]).sum(-1)
            GREL[sl] = _b(gr + 2.0 * z(rel) * g_d2[:, None])[:cnt]
            GPRE1[sl] = gpre[:cnt].to(bf)
            GR[sl] = mm(gpre, w1r.T)[:cnt].to(bf)
            GS[sl] = mm(gpre, w1s.T)[:cnt].to(bf)
        parts.append(p)
    acc = {k: sum_in_order([p[k] for p in parts]) for k in parts[0]}
    if scratch is not None:
        scratch.update(GPRE1=GPRE1, GR=GR, GS=GS)
    # node pass: the bf16 rows widened, summed per node in slot order
    # (receivers) and sender-permutation order (senders)
    g1, gr_, gs_ = GPRE1.float(), GR.float(), GS.float()
    G, S = torch.zeros((n, h1)), torch.zeros((n, h1))
    gx, gh = torch.zeros((n, 3)), torch.zeros((n, h1))
    for i in range(n):
        dr, ds = torch.zeros(3), torch.zeros(3)
        hr, hs = torch.zeros(h1), torch.zeros(h1)
        for s in range(int(indptr[i]), int(indptr[i + 1])):
            if em[s] != 0:
                G[i] += g1[s]
                hr += gr_[s]
                dr += GREL[s]
        for k in range(int(sptr[i]), int(sptr[i + 1])):
            s = int(sperm[k])
            if em[s] != 0:
                S[i] += g1[s]
                hs += gs_[s]
                ds -= GREL[s]
        gx[i], gh[i] = dr + ds, hr + hs
    # h^T G, h^T S: h rounded, G and S f32 sums (3xTF32 on the card,
    # f32-accurate), per 64-node tile, added in tile order
    hb = _b(h)
    gw1r = sum_in_order([hb[i:i + TR].T @ G[i:i + TR]
                         for i in range(0, n, TR)])
    gw1s = sum_in_order([hb[i:i + TR].T @ S[i:i + TR]
                         for i in range(0, n, TR)])
    zero = torch.zeros_like
    return (gx, gh, gw1r, gw1s, acc["w1d"][None], acc["b1"][None],
            acc["w2"], acc["b2"][None],
            acc["wg1"] if gate else zero(wg1),
            acc["bg1"][None] if gate else zero(bg1),
            acc["wg2"][:, None] if gate else zero(wg2))


# ----------------------------------------------------------------- cases
def _weights(width, seed=1):
    rng = np.random.default_rng(seed + width)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    ws = [f(width, width) / math.sqrt(width), f(width, width) / math.sqrt(width),
          0.3 * f(1, width), 0.1 * f(1, width), f(width, width) / math.sqrt(width),
          0.1 * f(1, width), f(width, width) / math.sqrt(width),
          0.1 * f(1, width), f(width, 1) / math.sqrt(width)]
    return ws


def _case(width):
    x, sp, rp, em, indptr, sperm, sptr = _edge_graph()
    rng = np.random.default_rng(width)
    n = x.shape[0]
    t = torch.from_numpy
    h = t(rng.standard_normal((n, width)).astype(np.float32))
    g_dx = t(rng.standard_normal((n, 3)).astype(np.float32))
    g_mh = t(rng.standard_normal((n, width)).astype(np.float32))
    return (t(x), h, t(sp), t(rp), t(em), t(indptr), t(sperm), t(sptr),
            _weights(width), g_dx, g_mh)


def _assert_close(got, want, what, tol, node_sums=()):
    """Each output within relative L2 ``tol``; the outputs at
    ``node_sums`` (bf16 summands) instead within the card's elementwise
    bound, with under 1 % of their elements differing."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i)
        if i in node_sums:
            d = (g - w).abs()
            bound = BF_KRTOL * w.abs() + BF_KATOL * float(w.abs().max())
            assert bool((d <= bound).all()), f"{what} output {i}"
            assert int((d > 0).sum()) < 0.01 * d.numel(), f"{what} output {i}"
            continue
        err = _rel_l2(g, w)
        assert err <= tol, f"{what} output {i}: relative L2 {err:.3g}"


# gate 'mlp' (raw; inv1p with a clamp that clips most edges) and 'none'.
# With a clamp that clips nearly every edge (0.05 here), gx is the sum of
# the few unclipped edges' terms, and an edge whose gate_pre lies within a
# rounding of +-clamp lands on either side of it under two summation
# orders: a discontinuity of the function, which read 1.2e-3 at width 32.
KW = [("mlp", "raw", math.inf), ("mlp", "inv1p", 0.5),
      ("none", "raw", math.inf)]
# the products: the plain version's (round to nearest), or the tensor
# core's; the tolerance of each
PRODUCTS = {"plain": (mm_plain, 1e-6), "tensor-core": (mm_bf16, BF_L2)}


def _gate_weights(ws, gate):
    return ws if gate == "mlp" else ws[:6] + [torch.zeros(1, 1)] * 3


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("products", sorted(PRODUCTS))
@pytest.mark.parametrize("width", WIDTHS)
def test_bf16_edge_fwd_schedule_matches_plain_bf16(width, products):
    """#1 in bf16 at widths 16 / 32 / 64, the gates of KW: within the
    products' tolerance of the plain bf16 version; 24 CTAs (the hub rows
    run far past their share) and one give the same bits."""
    mm, tol = PRODUCTS[products]
    x, h, sp, rp, em, indptr, _, _, ws, _, _ = _case(width)
    for gate, rel, clamp in KW:
        w = _gate_weights(ws, gate)
        kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp)
        want = edge_pathway_ref_bf16(x, h, sp, rp, em, *w, **kw)
        outs = [edge_fwd_bf16_schedule(x, h, sp, em, indptr, *w, **kw,
                                       n_ctas=k, mm=mm) for k in (24, 1)]
        _assert_close(outs[0], want, f"fwd {gate}-{rel} at {width}", tol)
        for out in outs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("products", sorted(PRODUCTS))
@pytest.mark.parametrize("width", WIDTHS)
def test_bf16_edge_bwd_schedule_matches_plain_bf16(width, products):
    """#2 in bf16 at widths 16 / 32 / 64 (gates as the forward's): within
    the products' tolerance of the plain bf16 backward (gx, gh: see the
    module's note); gx and gh bitwise the same under 12 and 5 CTAs; the
    per-slot scratch is bf16 and the node pass reads back exactly the
    rounded values the edge pass formed."""
    mm, tol = PRODUCTS[products]
    x, h, sp, rp, em, indptr, sperm, sptr, ws, g_dx, g_mh = _case(width)
    for gate, rel, clamp in KW:
        w = _gate_weights(ws, gate)
        kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp)
        deg = edge_pathway_ref_bf16(x, h, sp, rp, em, *w, **kw)[2]
        want = edge_pathway_bwd_ref_bf16(x, h, sp, rp, em, *w, deg, g_dx,
                                         g_mh, **kw)
        scratch = {}
        outs = [edge_bwd_bf16_schedule(
            x, h, sp, em, indptr, sperm, sptr, *w, deg, g_dx, g_mh, **kw,
            n_ctas=k, mm=mm, scratch=scratch if k == 12 else None)
            for k in (12, 5)]
        got = outs[0] if gate == "mlp" else outs[0][:8]
        _assert_close(got, want[:len(got)], f"bwd {gate}-{rel} at {width}",
                      tol, node_sums=(0, 1))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])
        assert all(v.dtype == torch.bfloat16 for v in scratch.values())
        live = em[:int(indptr[-1])] != 0
        g1 = scratch["GPRE1"][:live.numel()][live].float()
        assert torch.equal(_b(g1), g1) and bool(g1.abs().sum() > 0)


@pytest.mark.usefixtures("one_torch_thread")
def test_bf16_edge_schedules_masked_slots_do_not_change_a_bit():
    """The same live edges in a Verlet list at r + skin (the candidates
    outside r masked) and in a list of exactly the live edges: #1's
    outputs and #2's gx, gh bitwise equal (a trajectory does not depend
    on the skin)."""
    rng = np.random.default_rng(4)
    n, r, width = 120, 0.22, 32
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    snd, rcv = sort_edges_by_receiver(*radius_graph(x, r + 0.1))
    d = x[snd] - x[rcv]
    keep = (d * d).sum(-1) <= np.float32(r) ** 2
    t = torch.from_numpy
    h = t(rng.standard_normal((n, width)).astype(np.float32))
    g_dx = t(rng.standard_normal((n, 3)).astype(np.float32))
    g_mh = t(rng.standard_normal((n, width)).astype(np.float32))
    ws = _weights(width)
    kw = dict(gate_mode="mlp", rel_mode="inv1p", clamp=0.05)
    outs = []
    for s, rc, mk in ((snd, rcv, keep), (snd[keep], rcv[keep], keep[keep])):
        sp, rp, em = pad_edges(s, rc, s.size + 50, x)
        em[:s.size] = mk
        indptr = csr_indptr(rp, s.size, n)
        perm, sptr = csr_sender_perm(sp, s.size, n)
        sperm = np.zeros(sp.size, np.int32)
        sperm[:perm.size] = perm
        args = (t(x), h, t(sp), t(em), t(indptr))
        fwd = edge_fwd_bf16_schedule(*args, *ws, **kw, n_ctas=9)
        bwd = edge_bwd_bf16_schedule(*args, t(sperm), t(sptr), *ws,
                                     fwd[2], g_dx, g_mh, **kw, n_ctas=9)
        outs.append(list(fwd) + list(bwd[:2]))
    assert 0 < keep.sum() < keep.size
    for a, b in zip(*outs):
        assert torch.equal(a, b)
