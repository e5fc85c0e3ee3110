"""The bf16 schedule of the CUDA edge kernels (#1 ``edge_fwd_edges<W,
true>``, #2 ``edge_bwd_edges<W, true>`` / ``edge_bwd_nodes<W, true>``,
their ``node_proj<W, true>``), of the identity gate's backward on its tile
route (``padded_proj<W, true>``, ``idn_bwd_dh<W>``,
``idn_bwd_nodes_tile<W, true>``) and of the virtual forward and backward
(#3 ``virtual_fwd_kernel<W, true>``, #4 ``virtual_bwd_kernel<W, true>``),
emulated in plain PyTorch and held to the plain bf16 versions
``kernels.ref.edge_pathway_ref_bf16`` / ``edge_pathway_bwd_ref_bf16`` /
``virtual_pathway_ref_bf16`` / ``virtual_pathway_bwd_ref_bf16`` (which
``tests/test_torch_bf16.py`` holds to the JAX package's bf16 kernels).

No CUDA kernel runs on the CPU, so these tests hold the bf16 kernels'
algorithm where the kernels cannot run, as ``tests/test_torch_fwd_schedule.py``
and ``tests/test_torch_bwd_schedule.py`` do for the 3xTF32 route:

* Every tile product is the tensor core's m16n8k16 bf16 MMA
  (``tile_mma_bf``, ``csrc/common.cuh``): operands rounded to bf16 (the
  tiles are stored rounded), the 16 products of a k-step exact and added
  to the accumulator, each MMA's result rounded toward zero; with
  STEP_SUM (the forwards' products) each k16 step starts from zero and
  joins the running sum by a round-to-nearest f32 add.
* #1: CTA b owns the receiver rows whose CSR segment starts in its equal
  share of the live slot range, its live slots packed in slot order into
  64-edge tiles, each row's sums in slot order, carried across tiles.
* #2: equal slot ranges, live slots compacted in slot order into tiles;
  the per-slot scratch (g_pre1 and the per-edge dh terms bf16(bf16(g_pre1)
  W1r^T), ... W1s^T) stored as torch.bfloat16 and widened by the node
  pass, which sums it per node in slot / sender-permutation order; the
  weight partials per range, added in range order.
* The identity forward's tile route (``idn_fwd_tiles<W, true>``, Dh and
  H1 up to 64; SchNet's and RF's forms): the projection as in the
  backward, #1's CTA rows and 64-edge live tiles, the bf16 rounding points
  of the FP32-unit route (x, d2 and t1 as operands, the weights where
  loaded, the row sums' summands), each edge's msg as the warp butterfly
  adds it (``butterfly_dot``) and each row's sums in slot order, carried
  across tiles.
* The identity backward (SchNet's form, Dh = H1; RF's, Dh = 1): the
  projection P = h.W1r, Q = h.W1s as tile products on 64-node tiles; the
  row pass's per-edge terms and per-row sums in slot order; bf16(g_pre1) per
  slot in bf16; the dh pass's 64-slot tiles of the slot range (a masked
  slot's unwritten row in the tile, its products not stored), the live
  slots' two products stored in bf16; the node pass's sums in slot /
  sender-permutation order; h^T G, h^T S and the rows' partials per
  64-node tile, added in tile order.
* #3: 64-node tiles, the channels in order, bf16 tiles and k16 STEP_SUM
  products; one partial row (dz | ms) per tile and channel, added in tile
  order.
* #4: the same tiles, its twelve products a channel (four recomputed,
  four cotangents, four weight partials) on bf16 tiles without STEP_SUM
  (no sum adds more than 12 MMA results), every column sum, g_d2 and
  g_rel of the unrounded f32 terms; one partial per tile and channel,
  added in tile order; dh accumulated over the channels.

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
elements off by half a bf16 ulp of 1).  They are held to the card's
elementwise bound for exactly that (``chip_smoke.py``'s BF_KRTOL |p| +
BF_KATOL max|p|), with under 1 % of their elements differing at all; so
are the identity backward's.  The virtual forward's masked sums dz and
ms, over every node, are held to ``chip_smoke.py``'s BF_SUM_L2 with the
tensor core's products.  Bitwise:
#1's outputs, and #2's and the identity backward's gx and gh, do not
change with the CTA count or with masked slots in the layout.
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
                                     edge_pathway_ref_bf16,
                                     virtual_pathway_bwd_ref_bf16,
                                     virtual_pathway_ref_bf16)
from repro_torch.kernels.runtime import pad_to
from repro_torch.kernels.virtual_message import pad_ops
from test_torch_bf16 import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_bwd_schedule import (TR, _edge_graph, _silu_grad,
                                     sum_in_order)
from test_torch_fwd_schedule import (_round_to_zero, butterfly_dot,
                                     cta_rows, identity_edge_terms,
                                     identity_fwd_schedule,
                                     identity_projection)

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


# ------------------------------------------------- #2, identity gate
def identity_bwd_bf16_schedule(x, h, snd, em, indptr, sperm, sptr, w1r, w1s,
                               w1d, b1, w2, b2, deg, g_dx, g_mh, *, rel_mode,
                               clamp, n_ctas, mm=mm_bf16, scratch=None):
    """The identity gate's bf16 backward on its tile route (Dh, H1 <= 64:
    ``padded_proj<W, true>``, ``idn_bwd_rows<..., true>``,
    ``idn_bwd_dh<W>``, ``idn_bwd_nodes_tile<W, true>``) → the 8 gradients
    ``(x, h, w1r, w1s, w1d, b1, w2, b2)``.  The projection takes 64-node
    tiles and the tile products ``mm`` (RF's Dh = 1: ``idn_proj``'s exact
    rank-1 products).  The row pass
    recomputes each live edge (FP32 units) and sums per receiver row in
    slot order; the dh pass takes the slot range in 64-slot tiles (CTA b
    tiles b, b + n_ctas, ...), a masked slot's row whatever the stage
    holds (never written nor fetched: NaN here), forms the per-edge dh
    terms with the tile products ``mm`` and stores the live slots' in
    bf16; the node pass
    sums them per node in slot / sender-permutation order and forms h^T G,
    h^T S per 64-node tile.  ``scratch``
    (a dict) receives the per-slot bf16 rows (and ``g_msg``, the terms of
    the b2 gradient)."""
    n, h1 = x.shape[0], w1r.shape[1]
    inv1p = rel_mode == "inv1p"
    w1d_b, b1_b, w2_b, b2_b = (_b(w) for w in (w1d, b1, w2, b2))
    # padded_proj's tile products (idn_proj's exact rank-1 product at Dh = 1)
    proj = mm if h.shape[1] > 1 else mm_plain
    P = _tiles(h, lambda t: proj(t, w1r))
    Q = _tiles(h, lambda t: proj(t, w1s))
    live_end = int(indptr[n])
    live = [s for s in range(live_end) if em[s] != 0]
    sl = torch.tensor(live, dtype=torch.long)
    r = torch.searchsorted(indptr.long(), sl, right=True) - 1
    s, e = snd[sl].long(), em[sl]
    # the row pass's per-edge terms (each edge's alone)
    rel, d2 = _rel_d2(x, r, s)
    pre = _pre1(P, Q, r, s, d2, w1d, b1)
    t1, dt = F.silu(pre), _silu_grad(pre)
    msg = (_b(t1) @ w2_b + b2_b)[:, 0]
    inv = _b(1.0 / torch.clamp(deg[r, 0], min=1.0))
    sc = inv * e
    u = _b(g_dx[r]) * sc[:, None]
    kf = 1.0 / (torch.sqrt(d2 + 1e-12) + 1.0) if inv1p else torch.ones_like(d2)
    g_gate = (u * (rel * kf[:, None])).sum(-1)
    g_gate = torch.where((msg >= -clamp) & (msg <= clamp), g_gate, 0.0)
    g_msg = _b(g_mh[r, 0]) * sc + g_gate
    gp = (_b(g_msg)[:, None] * w2_b[:, 0]) * dt
    gq = _b(gp)
    g_d2 = gq @ w1d_b[0]
    gu = u * torch.clamp(msg, -clamp, clamp)[:, None]  # g_rel_used
    if inv1p:
        g_d2 = g_d2 + (gu * rel).sum(-1) * (-(kf * kf)
                                            / (2.0 * torch.sqrt(d2 + 1e-12)))
        gu = gu * kf[:, None]
    grel = _b(gu + 2.0 * rel * g_d2[:, None])
    # per receiver row, its live edges in slot order
    rows = {"G": gq, "gxr": grel, "w2": _b(t1) * _b(g_msg)[:, None],
            "w1d": _b(d2)[:, None] * gq, "b1": gp, "b2": g_msg[:, None]}
    RS = {k: torch.zeros((n, v.shape[1])) for k, v in rows.items()}
    for k, v in rows.items():
        for i in range(n):
            idx = (r == i).nonzero().flatten()
            if idx.numel():
                RS[k][i] = sum_in_order(list(v[idx]))
    # the dh pass: 64-slot tiles of the slot range, taken by the CTAs in
    # turn; a masked slot's row is garbage and its products are not stored
    bf = torch.bfloat16
    slots = snd.shape[0]
    GPRE1 = torch.full((slots, h1), float("nan"), dtype=bf)
    GR = torch.zeros((slots, w1r.shape[0]), dtype=bf)
    GS = torch.zeros((slots, w1r.shape[0]), dtype=bf)
    GPRE1[sl] = gq.to(bf)
    n_t = -(-live_end // TR)
    for b in range(n_ctas):
        for t in range(b, n_t, n_ctas):
            k = torch.arange(t * TR, min(t * TR + TR, live_end))
            on = em[k] != 0
            g = _pad(GPRE1[k].float(), TR)
            GR[k[on]] = mm(g, w1r.T)[:k.numel()][on].to(bf)
            GS[k[on]] = mm(g, w1s.T)[:k.numel()][on].to(bf)
    if scratch is not None:
        scratch.update(GPRE1=GPRE1, GR=GR, GS=GS, g_msg=g_msg)
    # the node pass: 8 lanes a node, the bf16 rows widened and summed
    g1, gr_, gs_ = GPRE1.float(), GR.float(), GS.float()
    GREL = torch.zeros((slots, 3))
    GREL[sl] = grel
    S = torch.zeros((n, h1))
    gx, gh = torch.zeros((n, 3)), torch.zeros((n, w1r.shape[0]))
    for i in range(n):
        hr, hs, ds = torch.zeros_like(gh[i]), torch.zeros_like(gh[i]), \
            torch.zeros(3)
        for k in range(int(indptr[i]), int(indptr[i + 1])):
            if em[k] != 0:
                hr = hr + gr_[k]
        for p in range(int(sptr[i]), int(sptr[i + 1])):
            k = int(sperm[p])
            if em[k] != 0:
                S[i] = S[i] + g1[k]
                hs = hs + gs_[k]
                ds = ds - GREL[k]
        gx[i], gh[i] = RS["gxr"][i] + ds, hr + hs
    # h^T G, h^T S (3xTF32 on the card: f32-accurate) and the rows'
    # partials, per 64-node tile, added in tile order
    hb = _b(h)
    tiles = lambda fn: sum_in_order([fn(slice(i, i + TR))
                                     for i in range(0, n, TR)])
    col = lambda k: tiles(lambda t: sum_in_order(list(RS[k][t])))
    return (gx, gh, tiles(lambda t: hb[t].T @ RS["G"][t]),
            tiles(lambda t: hb[t].T @ S[t]), col("w1d")[None],
            col("b1")[None], col("w2")[:, None], col("b2")[None])


# SchNet's form (Dh = H1, rel 'raw') and RF's (Dh = 1, 'inv1p' with a clamp
# that binds on most edges)
IDN_FORMS = {"schnet": (None, "raw", math.inf), "rf": (1, "inv1p", 0.5)}


def _identity_case(width, form):
    x, h, sp, rp, em, indptr, sperm, sptr, ws, g_dx, _ = _case(width)
    dh, rel, clamp = IDN_FORMS[form]
    dh = dh or width
    rng = np.random.default_rng(width + 7)
    t = torch.from_numpy
    h = t(rng.standard_normal((x.shape[0], dh)).astype(np.float32))
    w = [t(rng.standard_normal((dh, width)).astype(np.float32))
         / math.sqrt(2 * dh + 1) for _ in range(2)]
    ws = w + ws[2:4] + [ws[4][:, :1], ws[5][:, :1]]
    g_mh = t(rng.standard_normal((x.shape[0], 1)).astype(np.float32))
    kw = dict(gate_mode="identity", rel_mode=rel, clamp=clamp)
    zeros = [torch.zeros(1, 1)] * 3
    deg = edge_pathway_ref_bf16(x, h, sp, rp, em, *ws, *zeros, **kw)[2]
    want = edge_pathway_bwd_ref_bf16(x, h, sp, rp, em, *ws, *zeros, deg,
                                     g_dx, g_mh, **kw)[:8]
    args = (x, h, sp, em, indptr, sperm, sptr, *ws, deg, g_dx, g_mh)
    return args, dict(rel_mode=rel, clamp=clamp), want


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("products", sorted(PRODUCTS))
@pytest.mark.parametrize("form", sorted(IDN_FORMS))
@pytest.mark.parametrize("width", WIDTHS)
def test_bf16_identity_bwd_schedule_matches_plain_bf16(width, form,
                                                       products):
    """The identity backward's bf16 tile route at widths 16 / 32 / 64 in
    SchNet's and RF's forms: within the products' tolerance of the plain
    bf16 backward (gx, gh: the card's elementwise bound, see the module's
    note); the per-slot scratch is bf16 and holds exactly the rounded
    values the row pass formed."""
    mm, tol = PRODUCTS[products]
    args, kw, want = _identity_case(width, form)
    scratch = {}
    got = identity_bwd_bf16_schedule(*args, **kw, n_ctas=12, mm=mm,
                                     scratch=scratch)
    _assert_close(got[:7], want[:7], f"identity bwd {form} at {width}", tol,
                  node_sums=(0, 1))
    # the b2 gradient is one scalar, the sum of every live edge's g_msg of
    # either sign: two f32 orders of it differ by ulps of the terms'
    # magnitudes, not of their cancelling sum (1.15e-6 of it at width 32)
    terms = float(scratch.pop("g_msg").abs().sum())
    assert float((got[7] - want[7]).abs()) <= tol * terms
    assert all(v.dtype == torch.bfloat16 for v in scratch.values())
    em, indptr = args[3], args[4]
    live = (em[:int(indptr[-1])] != 0).nonzero().flatten()
    g1 = scratch["GPRE1"][live].float()
    assert bool(g1.abs().sum() > 0) and bool(torch.isfinite(got[1]).all())


@pytest.mark.usefixtures("one_torch_thread")
def test_bf16_identity_bwd_schedule_ctas_masked_slots_keep_bits():
    """The identity backward's tile route: gx and gh bitwise equal under 12
    and 5 dh-pass CTAs, and with the same live edges in a Verlet list at
    r + skin (the candidates outside r masked) and in a list of exactly
    the live edges (RF's form, a clamp that binds)."""
    rng = np.random.default_rng(5)
    n, r, width = 120, 0.22, 32
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    snd, rcv = sort_edges_by_receiver(*radius_graph(x, r + 0.1))
    d = x[snd] - x[rcv]
    keep = (d * d).sum(-1) <= np.float32(r) ** 2
    t = torch.from_numpy
    h = t(rng.standard_normal((n, 1)).astype(np.float32))
    g_dx = t(rng.standard_normal((n, 3)).astype(np.float32))
    g_mh = t(rng.standard_normal((n, 1)).astype(np.float32))
    ws = _weights(width)
    ws = [ws[0][:1], ws[1][:1]] + ws[2:4] + [ws[4][:, :1], ws[5][:, :1]]
    kw = dict(rel_mode="inv1p", clamp=0.5)
    outs = []
    for s, rc, mk in ((snd, rcv, keep), (snd[keep], rcv[keep], keep[keep])):
        sp, rp, em = pad_edges(s, rc, s.size + 50, x)
        em[:s.size] = mk
        indptr = csr_indptr(rp, s.size, n)
        perm, sptr = csr_sender_perm(sp, s.size, n)
        sperm = np.zeros(sp.size, np.int32)
        sperm[:perm.size] = perm
        deg = edge_pathway_ref_bf16(
            t(x), h, t(sp), t(rp), t(em), *ws, *[torch.zeros(1, 1)] * 3,
            gate_mode="identity", **kw)[2]
        args = (t(x), h, t(sp), t(em), t(indptr), t(sperm), t(sptr), *ws,
                deg, g_dx, g_mh)
        for k in (12, 5):
            outs.append(identity_bwd_bf16_schedule(*args, **kw, n_ctas=k)[:2])
    assert 0 < keep.sum() < keep.size
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


# ------------------------------------------- #1, identity gate, tile route
def _plain_dot(t, w2, width):
    """The plain bf16 version's msg dot: ``_b(t1) @ w2`` as a matmul."""
    return (t @ w2[:, None])[:, 0]


def identity_fwd_bf16_schedule(x, h, snd, em, indptr, w1r, w1s, w1d, b1,
                               w2, b2, *, rel_mode, clamp, n_ctas,
                               mm=mm_bf16, dot=butterfly_dot):
    """``idn_fwd_tiles<W, true>``'s schedule -> ``(dx, mh, deg)``: the f32
    schedule (``identity_fwd_schedule``) at the compiled width the widths
    pad to, with h, x and the weights rounded where the kernels read them,
    d2 and t1 rounded as operands, the summands rounded; the projection's
    tile products ``mm`` (RF's Dh = 1: the exact rank-1 product of the
    rounded operands), each msg's dot ``dot``."""
    width = 32 if max(h.shape[1], w1r.shape[1]) <= 32 else 64

    def proj(h_, wr, ws, w, _):
        return identity_projection(_b(h_), _b(wr), _b(ws), w,
                                   mm if h_.shape[1] > 1 else mm_plain)

    def terms(*a, **kw):
        return identity_edge_terms(*a, **kw, dot=dot, rnd=_b)

    return identity_fwd_schedule(
        x, h, snd, em, indptr, w1r, w1s, _b(w1d), _b(b1), _b(w2), _b(b2),
        rel_mode=rel_mode, clamp=clamp, n_ctas=n_ctas, width=width, mm=mm,
        terms=terms, proj=proj)


def _identity_fwd_case(width, form, graph=None):
    """The edge cases' hub graph (or ``graph``) with identity-gate operands
    of ``form`` at ``width``, and the plain bf16 version's outputs."""
    x, _, sp, rp, em, indptr, _, _, ws, _, _ = _case(width)
    if graph is not None:
        x, sp, rp, em, indptr = (torch.from_numpy(a) for a in graph)
    dh, rel, clamp = IDN_FORMS[form]
    dh = dh or width
    rng = np.random.default_rng(width + 8)
    t = torch.from_numpy
    h = t(rng.standard_normal((x.shape[0], dh)).astype(np.float32))
    w = [t(rng.standard_normal((dh, width)).astype(np.float32))
         / math.sqrt(2 * dh + 1) for _ in range(2)]
    ws = w + ws[2:4] + [ws[4][:, :1], ws[5][:, :1]]
    kw = dict(rel_mode=rel, clamp=clamp)
    zeros = [torch.zeros(1, 1)] * 3
    want = edge_pathway_ref_bf16(x, h, sp, rp, em, *ws, *zeros,
                                 gate_mode="identity", **kw)
    return (x, h, sp, em, indptr, *ws), kw, want


# the per-edge dot and the projection: the plain version's (1e-6), the
# kernel's butterfly with the plain projection (one bf16 summand can tip
# where msg moves by an f32 rounding: BF_TIP_L2), and the kernel's with
# the tensor core's projection (BF_L2)
BF_TIP_L2 = 1e-4
IDN_FWD_PRODUCTS = {"plain": (mm_plain, _plain_dot, 1e-6),
                    "butterfly": (mm_plain, butterfly_dot, BF_TIP_L2),
                    "tensor-core": (mm_bf16, butterfly_dot, BF_L2)}


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("products", sorted(IDN_FWD_PRODUCTS))
@pytest.mark.parametrize("form", sorted(IDN_FORMS))
@pytest.mark.parametrize("width", WIDTHS)
def test_bf16_identity_fwd_schedule_matches_plain_bf16(width, form,
                                                       products):
    """The identity forward's bf16 tile route at widths 16 / 32 / 64 in
    SchNet's and RF's forms (RF's clamp binds): within each variant's
    tolerance of the plain bf16 forward, under 12 CTAs."""
    mm, dot, tol = IDN_FWD_PRODUCTS[products]
    args, kw, want = _identity_fwd_case(width, form)
    got = identity_fwd_bf16_schedule(*args, **kw, n_ctas=12, mm=mm, dot=dot)
    _assert_close(got, want, f"identity fwd {form} at {width}", tol)
    assert all(bool(torch.isfinite(g).all()) for g in got)


@pytest.mark.usefixtures("one_torch_thread")
def test_bf16_identity_fwd_schedule_ctas_masked_slots_keep_bits():
    """The bf16 tile route (RF's form, a clamp that binds): bitwise equal
    under 1, 5 and 300 CTAs, and with the same live edges in a Verlet list
    at r + skin (the candidates outside r masked) and in a list of exactly
    the live edges."""
    rng = np.random.default_rng(6)
    n, r = 120, 0.22
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    snd, rcv = sort_edges_by_receiver(*radius_graph(x, r + 0.1))
    d = x[snd] - x[rcv]
    keep = (d * d).sum(-1) <= np.float32(r) ** 2
    outs = []
    for s, rc, mk in ((snd, rcv, keep), (snd[keep], rcv[keep], keep[keep])):
        sp, rp, em = pad_edges(s, rc, s.size + 50, x)
        em[:s.size] = mk
        graph = (x, sp, rp, em, csr_indptr(rp, s.size, n))
        args, kw, _ = _identity_fwd_case(32, "rf", graph)
        for k in (1, 5, 300):
            outs.append(identity_fwd_bf16_schedule(*args, **kw, n_ctas=k))
    assert 0 < keep.sum() < keep.size
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


@pytest.mark.usefixtures("one_torch_thread")
def test_bf16_identity_fwd_schedule_keeps_nan():
    """A NaN row of h (SchNet's form at 32; bf16 rounding keeps a NaN):
    NaN exactly where the plain bf16 version has it, the rest within the
    tensor-core variant's tolerance."""
    args, kw, _ = _identity_fwd_case(32, "schnet")
    h = args[1].clone()
    h[5] = float("nan")
    args = (args[0], h, *args[2:])
    got = identity_fwd_bf16_schedule(*args, **kw, n_ctas=12)
    x, _, sp, em, indptr = args[:5]
    rp = torch.searchsorted(indptr.long(), torch.arange(sp.shape[0]),
                            right=True) - 1
    want = edge_pathway_ref_bf16(x, h, sp, rp.clamp(max=x.shape[0] - 1), em,
                                 *args[5:], *[torch.zeros(1, 1)] * 3,
                                 gate_mode="identity", **kw)
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        assert _rel_l2(g[ok], w[ok]) <= BF_L2
    assert bool(torch.isnan(got[1]).any()) and not bool(
        torch.isnan(got[1]).all())


# ------------------------------------------------------------------- #3
def virtual_fwd_bf16_schedule(x, h, z, mask, w1h, w1d, c1, w2, b2, wg1, bg1,
                              wg2, wz1, bz1, wz2, *, mm=mm_bf16):
    """``virtual_fwd_kernel<W, true>``'s schedule → ``(dx, mh, dz, ms)``:
    64-node tiles, the channels in order; the h, t1, msg and weight tiles
    bf16 and the four products ``mm`` with a STEP_SUM per k16 step; rel,
    d2 and d2 w1d in bfloat16 arithmetic; mh, dx and the masked sums f32
    sums of unrounded terms, one partial row per tile and channel, added
    in tile order."""
    n, c = x.shape[0], z.shape[0]
    hid = w2.shape[-1]
    xb, zb = _b(x), _b(z)
    w1d, c1, b2, bg1, wg2, bz1, wz2 = (_b(v) for v in (w1d, c1, b2, bg1,
                                                      wg2, bz1, wz2))
    inv_c = 1.0 / c
    dx, mh = torch.zeros((n, 3)), torch.zeros((n, hid))
    parts = []
    for i0 in range(0, n, TR):
        cnt = min(TR, n - i0)
        xt, ht, mt = (_pad(a[i0:i0 + cnt], TR) for a in (xb, h, mask))
        ok = (torch.arange(TR) < cnt)[:, None]
        mha, dxa = torch.zeros((TR, hid)), torch.zeros((TR, 3))
        tile_parts = []
        for ch in range(c):
            rl = _b(xt - zb[ch])
            sq = _b(rl * rl)
            d2 = _b((sq[:, 0] + sq[:, 1]) + sq[:, 2])
            t1 = F.silu((mm(ht, w1h[ch], step_sum=True)
                         + _b(d2[:, None] * w1d[ch])) + c1[ch])
            msg = mm(t1, w2[ch], step_sum=True) + b2[ch]
            mha = mha + msg
            gx = (_b(F.silu(mm(msg, wg1[ch], step_sum=True) + bg1[ch]))
                  * wg2[ch, :, 0]).sum(-1)
            gz = (_b(F.silu(mm(msg, wz1[ch], step_sum=True) + bz1[ch]))
                  * wz2[ch, :, 0]).sum(-1)
            dxa = dxa + rl * gx[:, None]
            ms = torch.where(ok, msg * mt[:, None], 0.0).sum(0)
            dzt = torch.where(ok, (-rl * gz[:, None]) * mt[:, None], 0.0)
            tile_parts.append((sum_in_order(list(dzt)), ms))
        parts.append(tile_parts)
        mh[i0:i0 + cnt] = (mha * inv_c)[:cnt]
        dx[i0:i0 + cnt] = (dxa * inv_c)[:cnt]
    red = lambda k: torch.stack([sum_in_order([p[ch][k] for p in parts])
                                 for ch in range(c)])
    return dx, mh, red(0), red(1)


def _virtual_case(width, n=200, c=3):
    rng = np.random.default_rng(40 + width)
    f = lambda *s, sc=1.0: torch.from_numpy(
        (sc * rng.standard_normal(s)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=n) > 0.2).astype(np.float32))
    sw = width ** -0.5
    return (x, f(n, width), x[:c] + 0.05 * f(c, 3), mask,
            f(c, width, width, sc=sw), f(c, width, sc=0.3),
            f(c, width, sc=0.3), f(c, width, width, sc=sw),
            f(c, width, sc=0.1), f(c, width, width, sc=sw), f(c, width, sc=0.1),
            f(c, width, 1, sc=sw), f(c, width, width, sc=sw),
            f(c, width, sc=0.1), f(c, width, 1, sc=sw))


BF_SUM_L2 = 5e-5  # chip_smoke.py's bound on the virtual forward's sums


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("products", sorted(PRODUCTS))
@pytest.mark.parametrize("width", WIDTHS)
def test_bf16_virtual_fwd_schedule_matches_plain_bf16(width, products):
    """#3 in bf16 at widths 16 / 32 / 64 on bf16 tiles with k16 products:
    dx and mh within the products' tolerance of the plain bf16 forward,
    the masked sums dz and ms within it (plain products) or BF_SUM_L2
    (the tensor core's)."""
    mm, tol = PRODUCTS[products]
    args = _virtual_case(width)
    want = virtual_pathway_ref_bf16(*args)
    got = virtual_fwd_bf16_schedule(*args, mm=mm)
    for i, (g, w) in enumerate(zip(got, want)):
        err = _rel_l2(g, w)
        assert err <= (tol if i < 2 or tol < BF_SUM_L2 else BF_SUM_L2), (
            f"output {i}: relative L2 {err:.3g}")


# ------------------------------------------------------------------- #4
def virtual_bwd_bf16_schedule(x, h, z, mask, w1h, w1d, c1, w2, b2, wg1, bg1,
                              wg2, wz1, bz1, wz2, g_dx, g_mh, g_dz, g_ms, *,
                              mm=mm_bf16):
    """``virtual_bwd_kernel<W, true>``'s schedule → the 14 gradients
    ``(x, h, z, w1h, w1d, const1, w2, b2, wg1, bg1, wg2, wz1, bz1, wz2)``:
    64-node tiles (the last padded with zero rows), the channels in order;
    the h, t1, msg, g_gpx, g_gpz, g_msg and g_pre1 tiles and the weights
    bf16 (each value rounded once, as stored) and the twelve products
    ``mm``, each k16 step's MMA into the accumulator (g_msg's two
    cotangent products into one: one product over the joined K); rel, d2 and d2
    w1d in bfloat16 arithmetic; every column sum, the gates' row dots,
    g_d2 and g_rel of the unrounded f32 terms; one partial per tile and
    channel, added in tile order; dh summed over the channels."""
    n, c = x.shape[0], z.shape[0]
    dw = h.shape[1]
    xb, zb = _b(x), _b(z)
    vecs = [_b(v) for v in (w1d, c1, b2, bg1, wg2[..., 0], bz1, wz2[..., 0])]
    inv_c = 1.0 / c
    gx, gh = torch.zeros((n, 3)), torch.zeros((n, dw))
    parts = []
    for i0 in range(0, n, TR):
        cnt = min(TR, n - i0)
        xt, ht, mt, gdx, gmh = (_pad(a[i0:i0 + cnt], TR)
                                for a in (xb, h, mask, g_dx, g_mh))
        ux = gdx * inv_c
        dx, dh = torch.zeros((TR, 3)), torch.zeros((TR, dw))
        tile_parts = []
        for ch in range(c):
            vw1d, vc1, vb2, vbg1, vwg2, vbz1, vwz2 = (v[ch] for v in vecs)
            rl = _b(xt - zb[ch])
            sq = _b(rl * rl)
            d2 = _b((sq[:, 0] + sq[:, 1]) + sq[:, 2])
            uz = -mt[:, None] * g_dz[ch]
            ggx = (ux[:, 0] * rl[:, 0] + ux[:, 1] * rl[:, 1]) \
                + ux[:, 2] * rl[:, 2]
            ggz = (uz[:, 0] * rl[:, 0] + uz[:, 1] * rl[:, 1]) \
                + uz[:, 2] * rl[:, 2]
            pre = (mm(ht, w1h[ch]) + _b(d2[:, None] * vw1d)) + vc1
            t1, dt = F.silu(pre), _silu_grad(pre)
            msg = mm(t1, w2[ch]) + vb2
            gate, q, sgg = [], [], []
            for wg, bg, w2g, gg in ((wg1[ch], vbg1, vwg2, ggx),
                                    (wz1[ch], vbz1, vwz2, ggz)):
                p = mm(msg, wg) + bg
                sg = F.silu(p)
                gate.append((_b(sg) * w2g).sum(-1))
                q.append((_b(gg)[:, None] * w2g) * _silu_grad(p))
                sgg.append(_b(sg) * _b(gg)[:, None])
            gm = mm(torch.cat(q, 1), torch.cat([wg1[ch].T, wz1[ch].T])) + (
                gmh * inv_c + mt[:, None] * g_ms[ch])
            gp = mm(gm, w2[ch].T) * dt
            g_d2 = (gp * vw1d).sum(-1)
            g_rel = (ux * gate[0][:, None] + uz * gate[1][:, None]
                     + 2.0 * rl * g_d2[:, None])
            dx = dx + g_rel
            dh = dh + mm(gp, w1h[ch].T)
            g_rel[cnt:] = 0.0
            tile_parts.append(dict(
                w1h=mm(ht.T, gp), w1d=(d2[:, None] * gp).sum(0),
                c1=gp.sum(0), w2=mm(t1.T, gm), b2=gm.sum(0),
                wg1=mm(msg.T, q[0]), bg1=q[0].sum(0), wg2=sgg[0].sum(0),
                wz1=mm(msg.T, q[1]), bz1=q[1].sum(0), wz2=sgg[1].sum(0),
                dz=-sum_in_order(list(g_rel))))
        parts.append(tile_parts)
        gx[i0:i0 + cnt], gh[i0:i0 + cnt] = dx[:cnt], dh[:cnt]
    red = lambda k: torch.stack([sum_in_order([p[ch][k] for p in parts])
                                 for ch in range(c)])
    return (gx, gh, red("dz"), red("w1h"), red("w1d"), red("c1"), red("w2"),
            red("b2"), red("wg1"), red("bg1"), red("wg2")[..., None],
            red("wz1"), red("bz1"), red("wz2")[..., None])


def _virtual_bwd_case(width, n=200, c=3):
    args = _virtual_case(width, n, c)
    rng = np.random.default_rng(80 + width)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return args, (f(n, 3), f(n, width), f(c, 3), f(c, width))


# #4's tolerance with exact products: the kernel adds g_msg's terms (the
# two cotangent products into one accumulator, then g_mh / C + m g_ms) and
# the g_gx / g_gz dots in other orders than the plain version, so the
# bf16 rounding of an entry of g_msg or g_gx can tip by a bf16 ulp (4.5e-5
# at width 64 here; in the plain version's orders the schedule reproduces
# it to 1.4e-7: every rounding point is the plain version's)
V4_TOL = {"plain": 1e-4, "tensor-core": BF_L2}


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("products", sorted(PRODUCTS))
@pytest.mark.parametrize("width", (16, 32, 64))
def test_bf16_virtual_bwd_schedule_matches_plain_bf16(width, products):
    """#4 in bf16 at widths 32 and 64 and 16 (zero-padded to 32 as the
    wrapper pads it) on bf16 tiles with k16 products: every gradient
    within V4_TOL of the plain bf16 backward (relative L2), on 200 nodes
    (a ragged last tile) with masked nodes."""
    mm, tol = PRODUCTS[products][0], V4_TOL[products]
    args, cots = _virtual_bwd_case(width)
    assert 0 < float(args[3].sum()) < args[3].numel()
    want = virtual_pathway_bwd_ref_bf16(*args, *cots)
    if width < 32:  # the wrapper's zero padding to the compiled width
        n, c = args[0].shape[0], args[2].shape[0]
        args = pad_ops(args, 32, 32)
        cots = (cots[0], pad_to(cots[1], n, 32), cots[2],
                pad_to(cots[3], c, 32))
    got = virtual_bwd_bf16_schedule(*args, *cots, mm=mm)
    for i, (g, w) in enumerate(zip(got, want)):
        g = g[tuple(slice(0, k) for k in w.shape)]
        err = _rel_l2(g, w)
        assert err <= tol, f"gradient {i}: relative L2 {err:.3g}"


@pytest.mark.usefixtures("one_torch_thread")
def test_bf16_virtual_bwd_schedule_padding_nodes_leave_no_mark():
    """Nodes past the graph's (the ragged last tile filled with padding
    nodes: any coordinates and features, mask 0, zero cotangents, as a
    batch's padding arrives) change no bit of any gradient: their rows of
    every cotangent tile are exact zeros."""
    args, cots = _virtual_bwd_case(64, n=200)
    rng = np.random.default_rng(9)
    extra = 40
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    more = list(args)
    more[0] = torch.cat([args[0], torch.from_numpy(
        rng.uniform(0.0, 1.0, (extra, 3)).astype(np.float32))])
    more[1] = torch.cat([args[1], f(extra, 64)])
    more[3] = torch.cat([args[3], torch.zeros(extra)])
    mcots = (torch.cat([cots[0], torch.zeros(extra, 3)]),
             torch.cat([cots[1], torch.zeros(extra, 64)]), *cots[2:])
    assert -(-(200 + extra) // TR) == -(-200 // TR)  # the same tiles
    a = virtual_bwd_bf16_schedule(*args, *cots)
    b = virtual_bwd_bf16_schedule(*more, *mcots)
    for i, (u, v) in enumerate(zip(a, b)):
        assert torch.equal(u, v[:200] if i < 2 else v), f"gradient {i}"
