"""The schedule of the CUDA edge (#2) and virtual (#4) backward kernels,
emulated in plain PyTorch and held against ``jax.vjp`` of the JAX
package's oracles (``edge_pathway_ref`` / ``virtual_pathway_ref``).

No CUDA kernel runs on the CPU, so these tests hold the kernels'
algorithm where the kernels cannot run: the order in which
``csrc/edge_message_bwd.cu`` and ``csrc/virtual_message_bwd.cu`` cut the
work and add it up, and the precision of their tensor-core products.

* Edge: ``EDGE_BWD_CTAS``-style fixed slot ranges over ``[0, indptr[N])``,
  live slots compacted per range in slot order into 64-row tiles, per-range
  weight partials added in range order; the node pass's receiver-segment
  sums in slot order and sender-segment sums in ``csr_sender_perm`` order,
  over 64-node tiles with a ragged last tile.
* Virtual: 64-node tiles (ragged last), the channels in order, one partial
  per tile and channel, added in tile order.
* Every 64 x 64 product either in f32 or as the kernels' 3xTF32 split
  (each operand rounded to TF32 into a high and a low part,
  a_lo b_hi + a_hi b_lo + a_hi b_hi).  A single TF32 pass misses the
  gradient tolerance; the split keeps it.

Tolerance: each gradient relative to its own largest magnitude, rtol
1e-3 / atol 5e-5 (the reference's ``_assert_tree_close``, the kernels'
``GATOL`` / ``GRTOL``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro_torch.data.radius_graph import (csr_indptr, csr_sender_perm,
                                           pad_edges, radius_graph,
                                           sort_edges_by_receiver)
from repro_torch.kernels.edge_message import edge_pathway_bwd_plain
from repro_torch.kernels.virtual_message import virtual_pathway_bwd_plain

HID = 64   # the kernels' width
TR = 64    # rows of a tile
GATOL, GRTOL = 5e-5, 1e-3


# ------------------------------------------------------------ products
def _tf32(a):
    """``a`` rounded to the nearest TF32 value (10 mantissa bits, ties away
    from zero): half a TF32 ulp added to the bits, then the low 13 bits
    cleared, as the kernels' ``split_tf32`` makes its high part."""
    return ((a.contiguous().view(torch.int32) + 4096) & -8192).view(
        torch.float32)


def split_tf32(a):
    """The kernels' operand split: hi = ``_tf32(a)``, lo = a - hi (exact)
    with its low 13 bits cleared."""
    hi = _tf32(a)
    lo = ((a - hi).view(torch.int32) & -8192).view(torch.float32)
    return hi, lo


def mm_f32(a, b):
    return a @ b


def mm_3xtf32(a, b):
    """The kernels' product: a_lo b_hi + a_hi b_lo + a_hi b_hi."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_1xtf32(a, b):
    """A single TF32 pass (not used by the kernels)."""
    return _tf32(a) @ _tf32(b)


# NaN and Inf as the card makes them: 0x7fffffff is its NaN, and an
# integer add of half a TF32 ulp would carry it (and 0xffffffff) into -0 /
# +0, so a split by that add would drop a NaN from the product
NONFINITE_BITS = [0x7FFFFFFF, -1, 0x7FC00000, 0x7F800001, 0x7F800000,
                  -0x800000]


@pytest.mark.parametrize("bits", NONFINITE_BITS,
                         ids=["nan", "-nan", "qnan", "snan", "inf", "-inf"])
def test_tf32_split_keeps_nonfinite_operands(bits):
    """A NaN operand gives NaN products in the split, as in f32; an
    infinite one gives non-finite products (NaN where f32 has ±Inf:
    a - a_hi is Inf - Inf)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((4, HID)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((HID, 8)).astype(np.float32))
    a.view(torch.int32)[1, 5] = bits
    hi, lo = split_tf32(a[1, 5])
    assert not torch.isfinite(lo)
    got, want = mm_3xtf32(a, b), mm_f32(a, b)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    assert torch.equal(torch.isnan(got) | torch.isinf(want),
                       torch.isnan(want) | torch.isinf(want))
    assert not torch.isfinite(got[1]).any() and torch.isfinite(got[0]).all()


def _silu_grad(u):
    s = torch.sigmoid(u)
    return s * (1.0 + u * (1.0 - s))


# ------------------------------------------------------- edge schedule
def edge_bwd_schedule(x, h, snd, em, indptr, sperm, sptr, w1r, w1s, w1d, b1,
                      w2, b2, wg1, bg1, wg2, deg, g_dx, g_mh, *, gate_mode,
                      rel_mode, clamp, n_ctas, mm, trace=None, rowsum=None,
                      colsum=None):
    """``csrc/edge_message_bwd.cu``'s schedule → the 11 gradients, at the
    widths of the operands (``rowsum`` / ``colsum``: the sums over a row's
    features and over a tile's rows, torch's by default)."""
    n = x.shape[0]
    h1, m = w1r.shape[1], w2.shape[1]
    rowsum = rowsum or (lambda t: t.sum(-1))
    colsum = colsum or (lambda t: t.sum(0))
    f32 = torch.float32
    gate = gate_mode == "mlp"
    # 1. node_proj, per 64-node tile
    P = torch.cat([mm(h[i:i + TR], w1r) for i in range(0, n, TR)])
    Q = torch.cat([mm(h[i:i + TR], w1s) for i in range(0, n, TR)])
    # 2. edge pass: equal slot ranges, live slots compacted in slot order
    live_end = int(indptr[n])
    length = -(-live_end // n_ctas)
    e_slots = snd.shape[0]
    GPRE1 = torch.zeros((e_slots, h1), dtype=f32)
    GREL = torch.zeros((e_slots, 3), dtype=f32)
    parts = []
    for b in range(n_ctas):
        beg = min(b * length, live_end)
        end = min(beg + length, live_end)
        live = [s for s in range(beg, end) if em[s] != 0]
        if trace is not None:
            trace.append((beg, end, live))
        p = {k: torch.zeros(v, dtype=f32) for k, v in (
            ("w2", (h1, m)), ("wg1", (m, h1)), ("b2", m), ("bg1", h1),
            ("wg2", h1), ("b1", h1), ("w1d", h1))}
        for t0 in range(0, len(live), TR):
            sl = torch.tensor(live[t0:t0 + TR], dtype=torch.long)
            cnt = sl.numel()
            pad = TR - cnt  # ragged tile: zero rows
            r = torch.searchsorted(indptr.long(), sl, right=True) - 1
            s = snd[sl].long()
            e = em[sl]
            rel = x[r] - x[s]
            d2 = (rel * rel).sum(-1)
            inv = 1.0 / torch.clamp(deg[r, 0], min=1.0)
            u = (g_dx[r] * inv[:, None]) * e[:, None]
            pre = ((P[r] + Q[s]) + d2[:, None] * w1d) + b1
            z = lambda t: torch.cat([t, torch.zeros((pad,) + t.shape[1:],
                                                    dtype=f32)])
            pre = z(pre)
            t1 = torch.nn.functional.silu(pre)
            msg = mm(t1, w2) + b2
            gr = torch.zeros((TR, 3), dtype=f32)
            gq2 = torch.zeros(TR, dtype=f32)
            gm = z((g_mh[r] * inv[:, None]) * e[:, None])
            if gate:
                gp = mm(msg, wg1) + bg1
                sgp = torch.nn.functional.silu(gp)
                gate_pre = rowsum(sgp * wg2[:, 0])[:cnt]
                gv = torch.clamp(gate_pre, -clamp, clamp)
                if rel_mode == "inv1p":
                    sd = torch.sqrt(d2 + 1e-12)
                    kf = 1.0 / (sd + 1.0)
                else:
                    kf = torch.ones_like(d2)
                g_gate = (u * (rel * kf[:, None])).sum(-1)
                g_gate = torch.where((gate_pre >= -clamp)
                                     & (gate_pre <= clamp), g_gate, 0.0)
                gu = u * gv[:, None]
                if rel_mode == "inv1p":
                    gr[:cnt] = gu * kf[:, None]
                    gq2[:cnt] = (gu * rel).sum(-1) * (-(kf * kf) / (2 * sd))
                else:
                    gr[:cnt] = gu
                g_gate = z(g_gate)
                q = (g_gate[:, None] * wg2[:, 0]) * _silu_grad(gp)
                p["bg1"] += colsum(q)
                p["wg2"] += colsum(sgp * g_gate[:, None])
                gm = gm + mm(q, wg1.T)
                p["wg1"] += mm(msg.T, q)
            p["b2"] += colsum(gm)
            p["w2"] += mm(t1.T, gm)
            gpre = mm(gm, w2.T) * _silu_grad(pre)
            p["b1"] += colsum(gpre)
            p["w1d"] += colsum(z(d2)[:, None] * gpre)
            g_d2 = gq2 + rowsum(gpre * w1d[0])
            g_rel = gr + 2.0 * z(rel) * g_d2[:, None]
            GPRE1[sl] = gpre[:cnt]
            GREL[sl] = g_rel[:cnt]
        parts.append(p)
    acc = {k: sum_in_order([p[k] for p in parts]) for k in parts[0]}
    # 3. node pass: 64-node tiles, segment sums in slot / permutation order
    G = torch.zeros((n, h1), dtype=f32)
    S = torch.zeros((n, h1), dtype=f32)
    gx = torch.zeros((n, 3), dtype=f32)
    for i in range(n):
        dr = torch.zeros(3, dtype=f32)
        ds = torch.zeros(3, dtype=f32)
        for s in range(int(indptr[i]), int(indptr[i + 1])):
            if em[s] != 0:
                G[i] += GPRE1[s]
                dr += GREL[s]
        for k in range(int(sptr[i]), int(sptr[i + 1])):
            s = int(sperm[k])
            if em[s] != 0:
                S[i] += GPRE1[s]
                ds -= GREL[s]
        gx[i] = dr + ds
    gh = torch.cat([mm(G[i:i + TR], w1r.T) + mm(S[i:i + TR], w1s.T)
                    for i in range(0, n, TR)])
    gw1r = sum_in_order([mm(h[i:i + TR].T, G[i:i + TR])
                         for i in range(0, n, TR)])
    gw1s = sum_in_order([mm(h[i:i + TR].T, S[i:i + TR])
                         for i in range(0, n, TR)])
    zero = lambda w: torch.zeros_like(w)
    return (gx, gh, gw1r, gw1s, acc["w1d"][None], acc["b1"][None],
            acc["w2"], acc["b2"][None],
            acc["wg1"] if gate else zero(wg1),
            acc["bg1"][None] if gate else zero(bg1),
            acc["wg2"][:, None] if gate else zero(wg2))


def sum_in_order(parts):
    out = torch.zeros_like(parts[0])
    for p in parts:
        out = out + p
    return out


def _edge_graph(seed=0, n=200, ncap=230, cap=4000, hub_r=3, hub_s=7,
                hub_deg=150):
    """A radius graph plus a hub receiver ``hub_r`` and a hub sender
    ``hub_s`` of degree ``hub_deg``, receiver-sorted and padded; mask
    holes in the real slots; nodes past ``n`` are padding."""
    rng = np.random.default_rng(seed)
    x = np.zeros((ncap, 3), np.float32)
    x[:n] = rng.uniform(0.0, 1.0, (n, 3))
    snd, rcv = radius_graph(x[:n], 0.2)
    others = np.array([j for j in range(n) if j not in (hub_r, hub_s)])
    pick = rng.choice(others, hub_deg, replace=False)
    pairs = set(zip(snd.tolist(), rcv.tolist()))
    pairs |= {(int(j), hub_r) for j in pick} | {(hub_s, int(j)) for j in pick}
    snd = np.array([p[0] for p in pairs], np.int32)
    rcv = np.array([p[1] for p in pairs], np.int32)
    snd, rcv = sort_edges_by_receiver(snd, rcv)
    sp, rp, em = pad_edges(snd, rcv, cap, x[:n])
    em[:snd.size:5] = 0.0
    indptr = csr_indptr(rp, snd.size, ncap)
    perm, sptr = csr_sender_perm(sp, snd.size, ncap)
    sperm = np.zeros(cap, np.int32)
    sperm[:perm.size] = perm
    return x, sp, rp, em, indptr, sperm, sptr


def _edge_weights(seed=1, scale=0.15):
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return [f(HID, HID), f(HID, HID), f(1, HID), f(1, HID), f(HID, HID),
            f(1, HID), f(HID, HID), f(1, HID), f(HID, 1)]


def _assert_grads_close(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape
        scale = float(np.max(np.abs(w))) + 1e-6
        np.testing.assert_allclose(g / scale, w / scale, rtol=GRTOL,
                                   atol=GATOL)


def _edge_case(gate, rel, clamp, n_ctas, empty_range):
    x, sp, rp, em, indptr, sperm, sptr = _edge_graph()
    ncap = x.shape[0]
    live_end = int(indptr[-1])
    length = -(-live_end // n_ctas)
    if empty_range:  # one range with no live slot
        em[5 * length:6 * length] = 0.0
    rng = np.random.default_rng(2)
    h = rng.standard_normal((ncap, HID)).astype(np.float32)
    ws = _edge_weights()
    if gate == "none":
        ws[6:] = [np.zeros((1, 1), np.float32)] * 3
    kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp)
    g_dx = rng.standard_normal((ncap, 3)).astype(np.float32)
    g_mh = rng.standard_normal((ncap, HID)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (x, h, sp, rp, em)]
    jws = [jnp.asarray(w) for w in ws]
    _, _, deg = j_ref.edge_pathway_ref(*jargs, *jws, **kw)
    f = lambda xx, hh, *ww: j_ref.edge_pathway_ref(
        xx, hh, *jargs[2:], *ww, **kw)[:2]
    _, vjp = jax.vjp(f, jargs[0], jargs[1], *jws)
    want = vjp((jnp.asarray(g_dx), jnp.asarray(g_mh)))
    t = lambda a: torch.from_numpy(np.array(a))
    targs = (t(x), t(h), t(sp), t(em), t(indptr), t(sperm), t(sptr),
             *[t(w) for w in ws], t(np.asarray(deg)), t(g_dx), t(g_mh))
    return targs, kw, want, (indptr, em, length)


EDGE_CASES = [("mlp", "raw", math.inf), ("mlp", "raw", 0.05),
              ("mlp", "inv1p", 0.05), ("none", "raw", math.inf)]


@pytest.mark.parametrize("mm", [mm_f32, mm_3xtf32], ids=["f32", "3xtf32"])
@pytest.mark.parametrize("gate,rel,clamp", EDGE_CASES,
                         ids=["mlp", "mlp-clip", "inv1p-clip", "none"])
def test_edge_schedule_matches_vjp(gate, rel, clamp, mm):
    n_ctas = 12
    targs, kw, want, (indptr, em, length) = _edge_case(gate, rel, clamp,
                                                       n_ctas, True)
    trace = []
    got = edge_bwd_schedule(*targs, **kw, n_ctas=n_ctas, mm=mm, trace=trace)
    # the graph exercises what the kernel must get right
    deg = np.diff(indptr)
    assert deg.max() > length  # a hub row longer than one CTA's range
    crossing = [r for r in range(indptr.size - 1)
                if indptr[r] // length != (indptr[r + 1] - 1) // length
                and indptr[r + 1] > indptr[r]]
    assert crossing  # rows that cross range boundaries
    assert any(end > beg and not live for beg, end, live in trace)
    assert any(len(live) > TR for _, _, live in trace)  # several tiles
    assert targs[0].shape[0] % TR != 0  # a ragged last node tile
    _assert_grads_close(got, want)
    # padding nodes (no edge) get exact zeros
    assert not got[0][200:].any() and not got[1][200:].any()


def test_edge_schedule_single_tf32_pass_misses_tolerance():
    """Why the kernels split every operand: one TF32 pass per product
    lands outside the gradient tolerance on the same case."""
    targs, kw, want, _ = _edge_case("mlp", "raw", math.inf, 12, True)
    got = edge_bwd_schedule(*targs, **kw, n_ctas=12, mm=mm_1xtf32)
    with pytest.raises(AssertionError):
        _assert_grads_close(got, want)


@pytest.mark.parametrize("n_ctas", [1, 7, 256])
def test_edge_schedule_any_cta_count(n_ctas):
    """The result does not hang on the range length: one range, ranges
    that cut rows anywhere, and more CTAs than ranges with work."""
    targs, kw, want, _ = _edge_case("mlp", "inv1p", 0.05, n_ctas, False)
    got = edge_bwd_schedule(*targs, **kw, n_ctas=n_ctas, mm=mm_3xtf32)
    _assert_grads_close(got, want)


# ---------------------------------------------------- virtual schedule
def virtual_bwd_schedule(x, h, z, mask, w1h, w1d, c1, w2, b2, wg1, bg1, wg2,
                         wz1, bz1, wz2, g_dx, g_mh, g_dz, g_ms, *, mm,
                         rowsum=None, colsum=None):
    """``csrc/virtual_message_bwd.cu``'s schedule → the 14 gradients, at
    the widths of the operands (``rowsum`` / ``colsum`` as in
    :func:`edge_bwd_schedule`)."""
    n, c = x.shape[0], z.shape[0]
    dw = h.shape[1]
    rowsum = rowsum or (lambda t: t.sum(-1))
    colsum = colsum or (lambda t: t.sum(0))
    f32 = torch.float32
    silu = torch.nn.functional.silu
    inv_c = 1.0 / c
    gx = torch.zeros((n, 3), dtype=f32)
    gh = torch.zeros((n, dw), dtype=f32)
    parts = []
    for i0 in range(0, n, TR):
        cnt = min(TR, n - i0)
        pad = TR - cnt
        zp = lambda t: torch.cat([t, torch.zeros((pad,) + t.shape[1:],
                                                 dtype=f32)])
        xt, ht, mt = zp(x[i0:i0 + cnt]), zp(h[i0:i0 + cnt]), zp(
            mask[i0:i0 + cnt])
        ux = zp(g_dx[i0:i0 + cnt]) * inv_c
        gmt = zp(g_mh[i0:i0 + cnt])
        dx = torch.zeros((TR, 3), dtype=f32)
        dh = torch.zeros((TR, dw), dtype=f32)
        tile_parts = []
        for ch in range(c):
            rl = xt - z[ch]
            d2 = (rl * rl).sum(-1)
            uz = -mt[:, None] * g_dz[ch]
            ggx = (ux * rl).sum(-1)
            ggz = (uz * rl).sum(-1)
            pre = (mm(ht, w1h[ch]) + d2[:, None] * w1d[ch]) + c1[ch]
            t1 = silu(pre)
            msg = mm(t1, w2[ch]) + b2[ch]
            px = mm(msg, wg1[ch]) + bg1[ch]
            pz = mm(msg, wz1[ch]) + bz1[ch]
            gate_x = rowsum(silu(px) * wg2[ch, :, 0])
            gate_z = rowsum(silu(pz) * wz2[ch, :, 0])
            qx = (ggx[:, None] * wg2[ch, :, 0]) * _silu_grad(px)
            qz = (ggz[:, None] * wz2[ch, :, 0]) * _silu_grad(pz)
            gm = (mm(qx, wg1[ch].T) + mm(qz, wz1[ch].T)) + (
                gmt * inv_c + mt[:, None] * g_ms[ch])
            gp = mm(gm, w2[ch].T) * _silu_grad(pre)
            g_d2 = rowsum(gp * w1d[ch])
            g_rel = (ux * gate_x[:, None] + uz * gate_z[:, None]
                     + 2.0 * rl * g_d2[:, None])
            dx += g_rel
            dh = dh + mm(gp, w1h[ch].T)
            g_rel[cnt:] = 0.0
            tile_parts.append(dict(
                w1h=mm(ht.T, gp), w2=mm(t1.T, gm), wg1=mm(msg.T, qx),
                wz1=mm(msg.T, qz), c1=colsum(gp), b2=colsum(gm),
                bg1=colsum(qx), bz1=colsum(qz), w1d=colsum(d2[:, None] * gp),
                wg2=colsum(silu(px) * ggx[:, None]),
                wz2=colsum(silu(pz) * ggz[:, None]), dz=-colsum(g_rel)))
        parts.append(tile_parts)
        gx[i0:i0 + cnt] = dx[:cnt]
        gh[i0:i0 + cnt] = dh[:cnt]
    red = lambda k: torch.stack([sum_in_order([p[ch][k] for p in parts])
                                 for ch in range(c)])
    return (gx, gh, red("dz"), red("w1h"), red("w1d"), red("c1"), red("w2"),
            red("b2"), red("wg1"), red("bg1"), red("wg2")[..., None],
            red("wz1"), red("bz1"), red("wz2")[..., None])


def _virtual_case(n, c, seed=3):
    rng = np.random.default_rng(seed)
    f = lambda s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = f((n, HID))
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    z = (0.5 + 0.2 * rng.standard_normal((c, 3))).astype(np.float32)
    sc = 0.15
    ws = [f((c, HID, HID), sc), f((c, HID), sc), f((c, HID), sc),
          f((c, HID, HID), sc), f((c, HID), sc), f((c, HID, HID), sc),
          f((c, HID), sc), f((c, HID, 1), sc), f((c, HID, HID), sc),
          f((c, HID), sc), f((c, HID, 1), sc)]
    cots = [f((n, 3)), f((n, HID)), f((c, 3)), f((c, HID))]
    jm = jnp.asarray(mask)
    fn = lambda xx, hh, zz, *ww: j_ref.virtual_pathway_ref(xx, hh, zz, jm,
                                                           *ww)
    _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in (x, h, z, *ws)])
    want = vjp(tuple(jnp.asarray(a) for a in cots))
    t = torch.from_numpy
    return (t(x), t(h), t(z), t(mask), *[t(w) for w in ws],
            *[t(a) for a in cots]), want


@pytest.mark.parametrize("mm", [mm_f32, mm_3xtf32], ids=["f32", "3xtf32"])
@pytest.mark.parametrize("n,c", [(150, 3), (64, 1), (37, 3), (200, 1)])
def test_virtual_schedule_matches_vjp(n, c, mm):
    args, want = _virtual_case(n, c)
    got = virtual_bwd_schedule(*args, mm=mm)
    _assert_grads_close(got, want)


def test_virtual_schedule_single_tf32_pass_misses_tolerance():
    args, want = _virtual_case(150, 3)
    got = virtual_bwd_schedule(*args, mm=mm_1xtf32)
    with pytest.raises(AssertionError):
        _assert_grads_close(got, want)


# ------------------------------------------------------ NaN in the inputs
def _assert_same_nans(got, want):
    """NaN where the plain gradients have NaN, and close elsewhere."""
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        if ok.any():
            scale = float(w[ok].abs().max()) + 1e-6
            torch.testing.assert_close(g[ok] / scale, w[ok] / scale,
                                       atol=GATOL, rtol=GRTOL)
    assert torch.isnan(got[1]).any() and not torch.isnan(got[1]).all()


def test_edge_schedule_keeps_nan_in_h():
    """NaN rows of h (the card's bit patterns, at two nodes that send and
    receive live edges): NaN in the same gradients as the plain
    version's autograd, close elsewhere."""
    targs, kw, _, _ = _edge_case("mlp", "inv1p", 0.05, 12, True)
    targs = list(targs)
    h = targs[1].clone()
    h.view(torch.int32)[2] = 0x7FFFFFFF
    h.view(torch.int32)[5] = -1
    targs[1] = h
    got = edge_bwd_schedule(*targs, **kw, n_ctas=12, mm=mm_3xtf32)
    want = edge_pathway_bwd_plain(*targs[:5], *targs[7:16], *targs[17:],
                                  **kw)
    _assert_same_nans(got, want)


def test_virtual_schedule_keeps_nan_in_h():
    args, _ = _virtual_case(150, 3)
    args = list(args)
    live = torch.nonzero(args[3]).flatten()
    h = args[1].clone()
    h.view(torch.int32)[int(live[3])] = 0x7FFFFFFF
    h.view(torch.int32)[int(live[90])] = -1
    args[1] = h
    got = virtual_bwd_schedule(*args, mm=mm_3xtf32)
    _assert_same_nans(got, virtual_pathway_bwd_plain(*args))


# ------------------------------------------ identity gate, f32 tile route
def walk_fp32_units(perm, em, p0, p1, rows, grel):
    """The FP32-unit route's sender walk (``idn_bwd_nodes``): a warp
    ballots 32 slots' masks at a time and adds the live rows one after
    another from zero; gx's sender half subtracts their g_rel."""
    acc, d = torch.zeros(rows.shape[1]), torch.zeros(3)
    for b in range(p0, p1, 32):
        for p in range(b, min(b + 32, p1)):
            s = int(perm[p])
            if em[s] != 0:
                acc = acc + rows[s]
                d = d - grel[s]
    return acc, d


def walk_segment_sum(perm, em, p0, p1, rows, grel):
    """``segment_sum<W, true, false>`` (common.cuh) as the tile route's
    node pass runs it: a group of 8 lanes ballots 8 slots' masks at a
    time, takes their live rows four at a time and adds them in slot
    order; gx's sender half adds sign * g_rel, sign = -1."""
    acc, d = torch.zeros(rows.shape[1]), torch.zeros(3)
    for b in range(p0, p1, 8):
        live = [int(perm[p]) for p in range(b, min(b + 8, p1))
                if em[int(perm[p])] != 0]
        for k in range(0, len(live), 4):
            for s in live[k:k + 4]:
                acc = acc + rows[s]
                d = d + (-1.0) * grel[s]
    return acc, d


def _zero_pad(t, rows, cols):
    out = torch.zeros((rows, cols), dtype=torch.float32)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def identity_bwd_schedule(x, h, snd, em, indptr, sperm, sptr, w1r, w1s, w1d,
                          b1, w2, b2, deg, g_dx, g_mh, *, rel_mode, clamp,
                          width, mm, walk=walk_segment_sum, trace=None):
    """The identity gate's f32 backward on its tile route (Dh, H1 <= 64:
    ``padded_proj<W, false>`` (``idn_proj`` at Dh = 1), ``idn_bwd_rows``,
    ``idn_bwd_nodes_tile<W, false>``, ``idn_bwd_reduce``) → the 8
    gradients ``(x, h, w1r, w1s, w1d, b1, w2, b2)``.  Dh and H1 are
    zero-padded to ``width`` in the tile products.  P = h.W1r and Q =
    h.W1s on 64-node tiles (RF's Dh = 1: exact rank-1 products); each
    receiver row's live edges recomputed and summed in slot order (G,
    the receiver half of gx, the W2 / w1d / b2 terms); each node's sender
    segment summed by ``walk`` (S and the sender half of gx); gh = G.W1r^T
    + S.W1s^T and h^T G, h^T S with the tile products ``mm``; the b1, W2,
    w1d, b2 partials the rows' sums in node order; tiles added in order.
    ``trace`` (a dict) receives S."""
    n, dh, h1 = x.shape[0], h.shape[1], w1r.shape[1]
    f32 = torch.float32
    hp = _zero_pad(h, n, width)
    wr, ws = _zero_pad(w1r, width, width), _zero_pad(w1s, width, width)
    tiles = range(0, n, TR)
    if dh == 1:  # idn_proj: RF's rank-1 product elementwise, exact
        P, Q = h @ w1r, h @ w1s
    else:  # padded_proj
        P = torch.cat([mm(hp[i:i + TR], wr) for i in tiles])[:, :h1]
        Q = torch.cat([mm(hp[i:i + TR], ws) for i in tiles])[:, :h1]
    # the row pass: each live edge alone, then each row's sums in slot order
    live_end = int(indptr[n])
    sl = torch.tensor([s for s in range(live_end) if em[s] != 0])
    r = torch.searchsorted(indptr.long(), sl, right=True) - 1
    s = snd[sl].long()
    rel = x[r] - x[s]
    d2 = (rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]) + rel[:, 2] * rel[:, 2]
    pre = ((P[r] + Q[s]) + d2[:, None] * w1d) + b1
    t1, dt = torch.nn.functional.silu(pre), _silu_grad(pre)
    msg = (t1 * w2[:, 0]).sum(-1) + b2[0, 0]
    sc = (1.0 / torch.clamp(deg[r, 0], min=1.0)) * em[sl]
    u = g_dx[r] * sc[:, None]
    if rel_mode == "inv1p":
        sd = torch.sqrt(d2 + 1e-12)
        kf = 1.0 / (sd + 1.0)
    else:
        kf = torch.ones_like(d2)
    g_gate = (u * (rel * kf[:, None])).sum(-1)
    g_gate = torch.where((msg >= -clamp) & (msg <= clamp), g_gate, 0.0)
    g_msg = g_mh[r, 0] * sc + g_gate
    gp = (g_msg[:, None] * w2[:, 0]) * dt
    g_d2 = (gp * w1d[0]).sum(-1)
    gr = u * torch.clamp(msg, -clamp, clamp)[:, None]
    if rel_mode == "inv1p":
        g_d2 = g_d2 + (gr * rel).sum(-1) * (-(kf * kf) / (2.0 * sd))
        gr = gr * kf[:, None]
    grel = gr + 2.0 * rel * g_d2[:, None]
    terms = {"G": gp, "gxr": grel, "w2": t1 * g_msg[:, None],
             "w1d": d2[:, None] * gp, "b2": g_msg[:, None]}
    RS = {k: torch.zeros((n, v.shape[1]), dtype=f32) for k, v in terms.items()}
    for i in range(n):
        idx = (r == i).nonzero().flatten()
        for k, v in terms.items():
            if idx.numel():
                RS[k][i] = sum_in_order(list(v[idx]))
    # the rows' per-slot scratch: g_pre1 as f32 rows of the width
    slots = snd.shape[0]
    GPRE1 = torch.full((slots, width), float("nan"), dtype=f32)
    GPRE1[sl] = _zero_pad(gp, gp.shape[0], width)
    GREL = torch.zeros((slots, 3), dtype=f32)
    GREL[sl] = grel
    # the node pass: sender segments, then the tile products
    S = torch.zeros((n, width), dtype=f32)
    gx = torch.zeros((n, 3), dtype=f32)
    for i in range(n):
        S[i], ds = walk(sperm, em, int(sptr[i]), int(sptr[i + 1]), GPRE1,
                        GREL)
        gx[i] = RS["gxr"][i] + ds
    if trace is not None:
        trace["S"] = S
    G = _zero_pad(RS["G"], n, width)
    gh = torch.cat([mm(G[i:i + TR], wr.T) + mm(S[i:i + TR], ws.T)
                    for i in tiles])[:, :dh]
    in_order = lambda fn: sum_in_order([fn(slice(i, i + TR)) for i in tiles])
    node_sum = lambda a: in_order(lambda t: sum_in_order(list(a[t])))
    return (gx, gh,
            in_order(lambda t: mm(hp[t].T, G[t]))[:dh, :h1],
            in_order(lambda t: mm(hp[t].T, S[t]))[:dh, :h1],
            node_sum(RS["w1d"])[None], node_sum(RS["G"])[None],
            node_sum(RS["w2"])[:, None], node_sum(RS["b2"])[None])


# SchNet's form (Dh = H1, rel 'raw') at the compiled width 64 and padded
# from 24 to 32, RF's (Dh = 1, 'inv1p', a clamp that binds) at 64
IDN_CASES = {"schnet": (64, 64, 64, "raw", math.inf),
             "schnet-clip": (64, 64, 64, "raw", 0.5),
             "rf": (1, 64, 64, "inv1p", 0.5),
             "padded": (24, 24, 32, "raw", math.inf)}


def _identity_case(form):
    """The hub graph of the edge cases (n = 230 nodes: a ragged last
    64-node tile), identity-gate operands at Dh, H1 of ``form``, and the
    reference's gradients (``jax.vjp`` of its identity branch)."""
    dh, h1, width, rel, clamp = IDN_CASES[form]
    x, sp, rp, em, indptr, sperm, sptr = _edge_graph()
    ncap = x.shape[0]
    rng = np.random.default_rng(11)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    h = f(ncap, dh)
    ws = [f(dh, h1, sc=(2 * dh + 1) ** -0.5), f(dh, h1, sc=(2 * dh + 1) ** -0.5),
          f(1, h1, sc=0.3), f(1, h1, sc=0.1), f(h1, 1, sc=h1 ** -0.5),
          f(1, 1, sc=0.1)]
    zeros = [np.zeros((1, 1), np.float32)] * 3
    kw = dict(gate_mode="identity", rel_mode=rel, clamp=clamp)
    g_dx, g_mh = f(ncap, 3), f(ncap, 1)
    jargs = [jnp.asarray(a) for a in (x, h, sp, rp, em)]
    jz = [jnp.asarray(z) for z in zeros]
    _, _, deg = j_ref.edge_pathway_ref(*jargs, *map(jnp.asarray, ws), *jz,
                                       **kw)
    fn = lambda xx, hh, *ww: j_ref.edge_pathway_ref(
        xx, hh, *jargs[2:], *ww, *jz, **kw)[:2]
    _, vjp = jax.vjp(fn, jargs[0], jargs[1], *map(jnp.asarray, ws))
    want = vjp((jnp.asarray(g_dx), jnp.asarray(g_mh)))
    t = lambda a: torch.from_numpy(np.array(a))
    args = (t(x), t(h), t(sp), t(em), t(indptr), t(sperm), t(sptr),
            *map(t, ws), t(np.asarray(deg)), t(g_dx), t(g_mh))
    return args, dict(rel_mode=rel, clamp=clamp, width=width), want


@pytest.mark.parametrize("mm", [mm_f32, mm_3xtf32], ids=["f32", "3xtf32"])
@pytest.mark.parametrize("form", sorted(IDN_CASES))
def test_identity_tile_schedule_matches_vjp(form, mm):
    """The identity backward's f32 tile route in SchNet's form (raw, a
    clamp that binds and one that does not), RF's (Dh = 1, inv1p) and a
    width padded from 24 to 32, on 230 nodes (a ragged last tile): within
    the gradient tolerance of ``jax.vjp`` of the reference."""
    args, kw, want = _identity_case(form)
    assert args[0].shape[0] % TR != 0
    got = identity_bwd_schedule(*args, **kw, mm=mm)
    _assert_grads_close(got, want)
    # padding nodes (no edge) get exact zeros
    assert not got[0][200:].any() and not got[1][200:].any()


def test_identity_tile_schedule_single_tf32_pass_misses_tolerance():
    """Why gh and the W1r / W1s partials (and the projection) are 3xTF32
    products: one TF32 pass each lands outside the gradient tolerance."""
    args, kw, want = _identity_case("schnet")
    got = identity_bwd_schedule(*args, **kw, mm=mm_1xtf32)
    with pytest.raises(AssertionError):
        _assert_grads_close(got, want)


@pytest.mark.parametrize("form", ["schnet", "rf"])
def test_identity_tile_sender_sums_keep_the_fp32_unit_order(form):
    """S (the sender segments' sums of g_pre1) and gx are bitwise the
    FP32-unit route's: ``segment_sum``'s 8-slot groups add the live rows
    in the same permutation order, from zero, as the warp's 32-slot
    walk."""
    args, kw, _ = _identity_case(form)
    outs = []
    for walk in (walk_fp32_units, walk_segment_sum):
        trace = {}
        got = identity_bwd_schedule(*args, **kw, mm=mm_3xtf32, walk=walk,
                                    trace=trace)
        outs.append((trace["S"], got[0]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    sptr = args[6]
    assert int(torch.diff(sptr).max()) > 32  # a segment of several walks
