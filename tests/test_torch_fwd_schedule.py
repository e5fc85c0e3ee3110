"""The schedule of the CUDA edge (#1) and virtual (#3) forward kernels,
emulated in plain PyTorch and held against the JAX package's oracles
(``edge_pathway_ref`` / ``virtual_pathway_ref``).

No CUDA kernel runs on the CPU, so these tests hold the kernels'
algorithm where the kernels cannot run: how ``csrc/edge_message.cu`` and
``csrc/virtual_message.cu`` cut the work and add it up, and the precision
of their tensor-core products.

* Edge: the node projection P = h·W1r, Q = h·W1s over 64-node tiles; CTA b
  owns the receiver rows whose CSR segment starts in its equal share of
  ``[0, indptr[N])`` (``node_proj``'s ``ctarow``); its live slots are
  packed in slot order into 64-edge tiles; each row's mh, deg and dx start
  from zero and add the row's live edges one at a time in slot order,
  carried across tiles.  The output must not change by a bit with the CTA
  count or with extra masked slots in the layout.
* The identity gate's forward on its tile route (``csrc/edge_identity.cu``,
  Dh and H1 up to 64): the projection (``padded_proj``'s 64-node tile
  products, or RF's Dh = 1 rank-1 product), #1's CTA rows and 64-edge live
  tiles, each edge's msg an FMA chain a butterfly lane (columns v, v + 32)
  added as ``warp_sum``'s xor butterfly, and each row's five sums in slot
  order, carried across tiles: within the tolerance of the JAX oracle,
  bitwise the row walk of the route above 64 (a warp a receiver row), and
  bitwise unchanged by the CTA count or masked slots.
* Virtual: 64-node tiles (ragged last), the channels in order, one partial
  row (dz | ms) per tile and channel, added in tile order.
* Every 64 x 64 product either in f32 or as the kernels' 3xTF32 split;
  and the split as the tensor core sums it (each MMA's result rounded
  toward zero), which is why the forwards sum every k-step on its own
  (``tile_mma``'s STEP_SUM).

Tolerance: the forward's, elementwise atol 1e-5 / rtol 1e-4
(``chip_smoke.py``'s ATOL / RTOL).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro_torch.core.virtual_nodes import init_virtual_block
from repro_torch.data.radius_graph import (csr_indptr, pad_edges,
                                           radius_graph,
                                           sort_edges_by_receiver)
from repro_torch.kernels.edge_message import edge_pathway_plain
from repro_torch.kernels.ops import unpack_virtual_block
from repro_torch.kernels.virtual_message import virtual_pathway_plain
from test_torch_bf16 import one_torch_thread  # noqa: F401 (a fixture)
from test_torch_bwd_schedule import (HID, TR, _edge_graph, _edge_weights,
                                     mm_1xtf32, mm_3xtf32, mm_f32,
                                     split_tf32, sum_in_order)

ATOL, RTOL = 1e-5, 1e-4
silu = torch.nn.functional.silu


def _round_to_zero(x):
    """f64 → f32, rounded toward zero."""
    y = x.float()
    over = y.double().abs() > x.abs()
    y[over] = torch.nextafter(y[over], torch.zeros_like(y[over]))
    return y


def mm_tensor_core(a, b, step_sum=True):
    """The 3xTF32 product as the tensor core sums it: each MMA adds its
    eight exact products to its accumulator and rounds the result toward
    zero.  ``step_sum``: each k-step's three MMAs start from zero and the
    step joins the running sum by a round-to-nearest f32 add, as
    ``tile_mma<..., STEP_SUM>`` does."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        d = torch.zeros_like(acc) if step_sum else acc
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            d = _round_to_zero(d.double() + x[:, s].double() @ y[s].double())
        acc = acc + d if step_sum else d
    return acc


def _tiles(a, fn):
    """fn over 64-row tiles of ``a`` (the last padded with zero rows)."""
    out = []
    for i in range(0, a.shape[0], TR):
        t = a[i:i + TR]
        cnt = t.shape[0]
        t = torch.cat([t, t.new_zeros((TR - cnt,) + t.shape[1:])])
        out.append(fn(t)[:cnt])
    return torch.cat(out)


# ------------------------------------------------------- edge schedule
def cta_rows(indptr, n_ctas):
    """``node_proj``'s ctarow: CTA b owns rows [rows[b], rows[b + 1])."""
    n = indptr.shape[0] - 1
    share = max(1, -(-int(indptr[n]) // n_ctas))
    c = lambda r: min(int(indptr[r]) // share, n_ctas - 1)
    rows = [None] * (n_ctas + 1)
    for r in range(n + 1):
        lo = -1 if r == 0 else c(r - 1)
        up = n_ctas if r == n else c(r)
        for b in range(lo + 1, up + 1):
            rows[b] = r
    return rows


def edge_fwd_schedule(x, h, snd, em, indptr, w1r, w1s, w1d, b1, w2, b2, wg1,
                      bg1, wg2, *, gate_mode, rel_mode, clamp, n_ctas, mm,
                      trace=None, rowsum=None):
    """``csrc/edge_message.cu``'s schedule → ``(dx, mh, deg)``, at the
    widths of the operands (``rowsum``: the sums over a row's features,
    torch's by default)."""
    n, m = x.shape[0], w2.shape[1]
    rowsum = rowsum or (lambda t: t.sum(-1))
    f32 = torch.float32
    P = _tiles(h, lambda t: mm(t, w1r))
    Q = _tiles(h, lambda t: mm(t, w1s))
    dx = torch.full((n, 3), float("nan"), dtype=f32)
    mh = torch.full((n, m), float("nan"), dtype=f32)
    deg = torch.full((n, 1), float("nan"), dtype=f32)
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
        carry = None  # (row, mh sum, deg, dx sum) of the unfinished row
        for t0 in range(0, len(live), TR):
            sl = torch.tensor(live[t0:t0 + TR], dtype=torch.long)
            cnt = sl.numel()
            r, s, e = row_of[sl], snd[sl].long(), em[sl]
            if trace is not None:
                trace.append((b, r0, r1, r.tolist()))
            rel = x[r] - x[s]
            d2 = (rel * rel).sum(-1)
            pad = lambda t: torch.cat([t, t.new_zeros((TR - cnt,)
                                                      + t.shape[1:])])
            t1 = silu(pad(((P[r] + Q[s]) + d2[:, None] * w1d) + b1))
            msg = mm(t1, w2) + b2
            term = torch.zeros((cnt, 3), dtype=f32)
            if gate_mode == "mlp":
                g = rowsum(silu(mm(msg, wg1) + bg1) * wg2[:, 0])[:cnt]
                g = torch.clamp(g, -clamp, clamp)
                q = rel / (torch.sqrt(d2 + 1e-12) + 1.0)[:, None] if (
                    rel_mode == "inv1p") else rel
                term = (q * g[:, None]) * e[:, None]
            for i in range(cnt):  # each row's live edges in slot order
                ri = int(r[i])
                if carry is None or carry[0] != ri:
                    if carry is not None:
                        finish(*carry)
                    carry = (ri, torch.zeros(m), torch.tensor(0.0),
                             torch.zeros(3))
                _, a, dg, d = carry
                carry = (ri, a + msg[i] * e[i], dg + e[i], d + term[i])
        if carry is not None:
            finish(*carry)
    return dx, mh, deg


def _edge_fwd_case(gate, rel, clamp, empty_share=None):
    x, sp, rp, em, indptr, _, _ = _edge_graph()
    if empty_share is not None:  # one CTA share with no live slot
        n_ctas, k = empty_share
        length = -(-int(indptr[-1]) // n_ctas)
        em[k * length:(k + 1) * length] = 0.0
    rng = np.random.default_rng(2)
    h = rng.standard_normal((x.shape[0], HID)).astype(np.float32)
    ws = _edge_weights()
    if gate == "none":
        ws[6:] = [np.zeros((1, 1), np.float32)] * 3
    kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp)
    want = j_ref.edge_pathway_ref(*[jnp.asarray(a) for a in (x, h, sp, rp, em)],
                                  *[jnp.asarray(w) for w in ws], **kw)
    t = torch.from_numpy
    targs = (t(x), t(h), t(sp), t(em), t(indptr), *[t(w) for w in ws])
    return targs, kw, [np.asarray(w) for w in want]


def _assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


EDGE_CASES = [("mlp", "raw", math.inf), ("mlp", "raw", 0.05),
              ("mlp", "inv1p", 0.05), ("mlp", "inv1p", math.inf),
              ("none", "raw", math.inf)]


@pytest.mark.parametrize("mm", [mm_f32, mm_3xtf32], ids=["f32", "3xtf32"])
@pytest.mark.parametrize("gate,rel,clamp", EDGE_CASES,
                         ids=["mlp", "mlp-clip", "inv1p-clip", "inv1p",
                              "none"])
def test_edge_fwd_schedule_matches_oracle(gate, rel, clamp, mm):
    """24 CTAs: the hub row runs far past its share, CTAs whose share
    starts inside it own no row, one share has no live slot; 4 CTAs:
    several tiles a CTA, rows carried across tiles and tiles whose last
    live edge ends a row.  Both within the tolerance, and bitwise equal."""
    targs, kw, want = _edge_fwd_case(gate, rel, clamp, empty_share=(24, 10))
    indptr = targs[4].numpy()
    outs = []
    for n_ctas in (24, 4):
        trace = []
        outs.append(edge_fwd_schedule(*targs, **kw, n_ctas=n_ctas, mm=mm,
                                      trace=trace))
        _assert_close(outs[-1], want)
        tiles = {}
        for b, _, _, rows in trace:
            tiles.setdefault(b, []).append(rows)
        pairs = [(a[-1], c[0]) for ts in tiles.values()
                 for a, c in zip(ts, ts[1:])]
        share = -(-int(indptr[-1]) // n_ctas)
        rows = cta_rows(targs[4], n_ctas)
        if n_ctas == 24:
            assert np.diff(indptr).max() > 2 * share
            assert any(rows[b] == rows[b + 1] for b in range(n_ctas))
        else:
            assert any(a == c for a, c in pairs)  # a row carried on
            assert any(a != c for a, c in pairs)  # a row ended a tile
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    # padding nodes (no slot) get exact zeros
    assert all(not v[200:].any() for v in outs[0])


@pytest.mark.parametrize("gate,rel,clamp", EDGE_CASES[1:3],
                         ids=["mlp-clip", "inv1p-clip"])
def test_edge_fwd_schedule_cta_count_does_not_change_a_bit(gate, rel, clamp):
    """One CTA, shares that cut rows anywhere, and more CTAs than rows:
    the same bits."""
    targs, kw, _ = _edge_fwd_case(gate, rel, clamp)
    outs = [edge_fwd_schedule(*targs, **kw, n_ctas=k, mm=mm_3xtf32)
            for k in (1, 3, 7, 12, 300)]
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)


def test_edge_fwd_schedule_masked_slots_do_not_change_a_bit():
    """The same live edges in a Verlet list at r + skin (the candidates
    outside r masked) and in a list of exactly the live edges: the same
    bits, as the rollout's skin independence needs."""
    rng = np.random.default_rng(4)
    n, r = 150, 0.2
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    snd, rcv = sort_edges_by_receiver(*radius_graph(x, r + 0.1))
    d = x[snd] - x[rcv]
    keep = (d * d).sum(-1) <= np.float32(r) ** 2
    h = torch.from_numpy(rng.standard_normal((n, HID)).astype(np.float32))
    ws = [torch.from_numpy(w) for w in _edge_weights()]
    outs = []
    for s, rc, m in ((snd, rcv, keep), (snd[keep], rcv[keep], keep[keep])):
        sp, rp, em = pad_edges(s, rc, s.size + 50, x)
        em[:s.size] = m
        t = torch.from_numpy
        outs.append(edge_fwd_schedule(
            t(x), h, t(sp), t(em), t(csr_indptr(rp, s.size, n)), *ws,
            gate_mode="mlp", rel_mode="inv1p", clamp=0.05, n_ctas=9,
            mm=mm_3xtf32))
    assert 0 < keep.sum() < keep.size
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_edge_fwd_schedule_single_tf32_pass_misses_tolerance():
    """Why the kernel splits every operand: one TF32 pass per product
    lands outside the forward tolerance on the same case."""
    targs, kw, want = _edge_fwd_case("mlp", "raw", math.inf)
    got = edge_fwd_schedule(*targs, **kw, n_ctas=12, mm=mm_1xtf32)
    with pytest.raises(AssertionError):
        _assert_close(got, want)


# ------------------------------------ identity gate, forward tile route
def _fma(a, b, c):
    """fmaf(a, b, c) elementwise: the product of two f32 values is exact in
    f64, the sum rounded once to f64, then to f32."""
    return (a.double() * b.double() + c.double()).float()


def butterfly_dot(t, w2, width):
    """``idn_fwd_tiles``' per-edge dot t . w2 over ``width`` columns (zero
    past w2's length): butterfly lane v < 32 holds the FMA chain from zero
    over columns v, v + 32, ...; the lanes add as ``warp_sum``'s xor
    butterfly, o = 16, 8, 4, 2, 1 (its levels 16 to 4 inside a thread,
    2 and 1 by shuffles: the same tree)."""
    e, h1 = t.shape
    tp = torch.zeros((e, width), dtype=torch.float32)
    wp = torch.zeros(width, dtype=torch.float32)
    tp[:, :h1], wp[:h1] = t, w2
    part = torch.zeros((e, 32), dtype=torch.float32)
    for j in range(0, width, 32):
        part = _fma(tp[:, j:j + 32], wp[j:j + 32], part)
    for o in (16, 8, 4, 2, 1):
        part = part[:, :o] + part[:, o:2 * o]
    return part[:, 0]


def identity_edge_terms(x, P, Q, r, s, e, w1d, b1, w2, b2, *, rel_mode,
                        clamp, width, dot=butterfly_dot, rnd=lambda t: t):
    """One tile's edges (receivers r, senders s, masks e; padded to 64
    rows, as the kernel's tile is) -> their five row-sum summands (64, 5):
    msg em | em | rel_used gate em (3).  ``rnd``: the bf16 mode's rounding
    points (x, d2 and t1 as operands, the summands; the weights arrive
    rounded)."""
    rel = rnd(x[r]) - rnd(x[s])
    d2 = (rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]) + rel[:, 2] * rel[:, 2]
    pre = ((P[r] + Q[s]) + rnd(d2)[:, None] * w1d) + b1
    msg = dot(rnd(torch.nn.functional.silu(pre)), w2[:, 0], width) + b2[0, 0]
    g = torch.clamp(msg, -clamp, clamp)  # NaN stays
    q = rel / (torch.sqrt(d2 + 1e-12) + 1.0)[:, None] if (
        rel_mode == "inv1p") else rel
    return torch.cat([rnd(msg * e)[:, None], rnd(e)[:, None],
                      rnd((q * g[:, None]) * e[:, None])], 1)


def identity_projection(h, w1r, w1s, width, mm):
    """P = h.W1r, Q = h.W1s: ``padded_proj``'s 64-node tile products at
    Dh > 1 (h and the weights zero-padded to ``width``), RF's Dh = 1 the
    exact rank-1 product (``idn_proj``)."""
    h1 = w1r.shape[1]
    if h.shape[1] == 1:
        return h @ w1r, h @ w1s
    pad = lambda t, r: torch.cat([torch.cat(
        [t, t.new_zeros((t.shape[0], width - t.shape[1]))], 1),
        t.new_zeros((r - t.shape[0], width))])
    hp = pad(h, h.shape[0])
    return tuple(_tiles(hp, lambda t: mm(t, pad(w, width)))[:, :h1]
                 for w in (w1r, w1s))


def identity_fwd_schedule(x, h, snd, em, indptr, w1r, w1s, w1d, b1, w2, b2,
                          *, rel_mode, clamp, n_ctas, width, mm,
                          terms=identity_edge_terms, proj=identity_projection,
                          trace=None):
    """``idn_fwd_tiles``' schedule (``csrc/edge_identity.cu``) -> ``(dx,
    mh, deg)``: CTA b owns the rows of ``cta_rows``; its live slots go in
    slot order into 64-edge tiles; a tile's summands (``terms``) are added
    per row in slot order by one thread, the tile's last row carried into
    the next tile.  ``trace`` (a list) receives (CTA, the tile's rows)."""
    n = x.shape[0]
    P, Q = proj(h, w1r, w1s, width, mm)
    f32 = np.float32
    out = np.full((n, 5), np.nan, f32)  # mh | deg | dx

    def finish(r, v):
        inv = f32(1.0) / max(v[1], f32(1.0))
        out[r] = (v[0] * inv, v[1], v[2] * inv, v[3] * inv, v[4] * inv)

    rows = cta_rows(indptr, n_ctas)
    row_of = torch.searchsorted(indptr.long(), torch.arange(snd.shape[0]),
                                right=True) - 1
    for b in range(n_ctas):
        r0, r1 = rows[b], rows[b + 1]
        live = [s for s in range(int(indptr[r0]), int(indptr[r1]))
                if em[s] != 0]
        for r in range(r0, r1):  # rows with no live slot: zeros
            finish(r, np.zeros(5, f32))
        carry = None  # (row, its five sums) of the unfinished row
        for t0 in range(0, len(live), TR):
            sl = torch.tensor(live[t0:t0 + TR], dtype=torch.long)
            cnt = sl.numel()
            pad = lambda t: torch.cat([t, t.new_zeros(TR - cnt)])
            r, s = pad(row_of[sl]), pad(snd[sl].long())
            if trace is not None:
                trace.append((b, r[:cnt].tolist()))
            v = terms(x, P, Q, r, s, pad(em[sl]), w1d, b1, w2, b2,
                      rel_mode=rel_mode, clamp=clamp, width=width)
            v = v[:cnt].numpy()
            for i in range(cnt):  # each row's live edges in slot order
                ri = int(r[i])
                if carry is None or carry[0] != ri:
                    if carry is not None:
                        finish(*carry)
                    carry = (ri, np.zeros(5, f32))
                carry[1][:] = carry[1] + v[i]
        if carry is not None:
            finish(*carry)
    t = torch.from_numpy(out)
    return t[:, 2:].clone(), t[:, :1].clone(), t[:, 1:2].clone()


def identity_fwd_row_walk(x, h, snd, em, indptr, w1r, w1s, w1d, b1, w2, b2,
                          *, rel_mode, clamp, width, mm,
                          terms=identity_edge_terms,
                          proj=identity_projection):
    """The route above 64 (``idn_fwd_rows``): each receiver row's live
    edges walked in slot order, the same per-edge terms (64-edge chunks of
    the live slots, as the tile pass forms them) -> ``(dx, mh, deg)``."""
    n = x.shape[0]
    P, Q = proj(h, w1r, w1s, width, mm)
    live = torch.tensor([s for s in range(int(indptr[n])) if em[s] != 0],
                        dtype=torch.long)
    row_of = torch.searchsorted(indptr.long(), live, right=True) - 1
    v = []
    for t0 in range(0, live.numel(), TR):
        k = live[t0:t0 + TR]
        pad = lambda t: torch.cat([t, t.new_zeros(TR - k.numel())])
        v.append(terms(x, P, Q, pad(row_of[t0:t0 + TR]), pad(snd[k].long()),
                       pad(em[k]), w1d, b1, w2, b2, rel_mode=rel_mode,
                       clamp=clamp, width=width)[:k.numel()])
    v = torch.cat(v).numpy()
    f32 = np.float32
    out = np.zeros((n, 5), f32)
    for r in range(n):
        a = np.zeros(5, f32)
        for i in (row_of == r).nonzero().flatten().tolist():
            a = a + v[i]
        inv = f32(1.0) / max(a[1], f32(1.0))
        out[r] = (a[0] * inv, a[1], a[2] * inv, a[3] * inv, a[4] * inv)
    t = torch.from_numpy(out)
    return t[:, 2:].clone(), t[:, :1].clone(), t[:, 1:2].clone()


# SchNet's form (Dh = H1, rel raw) at the compiled width 64 without and
# with a clamp that binds, RF's (Dh = 1, inv1p, a clamp that binds), and
# SchNet's padded from 24 to 32: (Dh, H1, width, rel, clamp)
IDN_FWD_CASES = {"schnet": (64, 64, 64, "raw", math.inf),
                 "schnet-clip": (64, 64, 64, "raw", 0.05),
                 "rf": (1, 64, 64, "inv1p", 0.05),
                 "padded": (24, 24, 32, "raw", math.inf)}


def _identity_fwd_case(form, graph=None):
    """The hub graph of the edge cases (230 nodes, 30 of them padding)
    with identity-gate operands of ``form``: (torch args, kw, the JAX
    oracle's outputs)."""
    dh, h1, width, rel, clamp = IDN_FWD_CASES[form]
    x, sp, rp, em, indptr, _, _ = graph or _edge_graph()
    rng = np.random.default_rng(12)
    f = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)
    h = f(x.shape[0], dh)
    ws = [f(dh, h1, sc=(2 * dh + 1) ** -0.5),
          f(dh, h1, sc=(2 * dh + 1) ** -0.5), f(1, h1, sc=0.3),
          f(1, h1, sc=0.1), f(h1, 1, sc=h1 ** -0.5), f(1, 1, sc=0.1)]
    z = [jnp.zeros((1, 1), jnp.float32)] * 3
    want = j_ref.edge_pathway_ref(
        *[jnp.asarray(a) for a in (x, h, sp, rp, em)],
        *[jnp.asarray(w) for w in ws], *z, gate_mode="identity",
        rel_mode=rel, clamp=clamp)
    t = torch.from_numpy
    args = (t(x), t(h), t(sp), t(em), t(indptr), *map(t, ws))
    return args, dict(rel_mode=rel, clamp=clamp, width=width), \
        [np.asarray(w) for w in want]


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("mm", [mm_f32, mm_3xtf32], ids=["f32", "3xtf32"])
@pytest.mark.parametrize("form", sorted(IDN_FWD_CASES))
def test_identity_fwd_schedule_matches_oracle(form, mm):
    """The identity forward's tile route in SchNet's form (a clamp that
    binds on some edges and one that does not), RF's and a width padded
    from 24 to 32: within the forward tolerance of the JAX oracle under 24
    CTAs (the hub row far past its share, CTAs that own no row) and 4
    (several tiles a CTA, rows carried across tiles), bitwise equal under
    both and bitwise the row walk of the route above 64."""
    args, kw, want = _identity_fwd_case(form)
    outs = []
    for n_ctas in (24, 4):
        trace = []
        outs.append(identity_fwd_schedule(*args, **kw, n_ctas=n_ctas, mm=mm,
                                          trace=trace))
        _assert_close(outs[-1], want)
        if n_ctas == 4:
            tiles = {}
            for b, rows in trace:
                tiles.setdefault(b, []).append(rows)
            pairs = [(a[-1], c[0]) for ts in tiles.values()
                     for a, c in zip(ts, ts[1:])]
            assert any(a == c for a, c in pairs)  # a row carried on
    walk = identity_fwd_row_walk(*args, **kw, mm=mm)
    for a, b, c in zip(*outs, walk):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert not any(v[200:].any() for v in outs[0])  # padding nodes: zeros
    if kw["clamp"] < math.inf:  # the clamp binds on some edges, not all
        x, h, snd, em, indptr = args[:5]
        e = int(indptr[-1])
        r = torch.searchsorted(indptr.long(), torch.arange(e), right=True) - 1
        live = em[:e] != 0
        d2 = ((x[r] - x[snd[:e].long()]) ** 2).sum(-1)
        pre = (h[r] @ args[5] + h[snd[:e].long()] @ args[6]
               + d2[:, None] * args[7] + args[8])
        msg = (silu(pre) @ args[9] + args[10])[:, 0][live].abs()
        assert bool((msg > kw["clamp"]).any() and (msg < kw["clamp"]).any())


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("form", ["schnet-clip", "rf"])
def test_identity_fwd_schedule_cta_count_does_not_change_a_bit(form):
    """One CTA, shares that cut rows anywhere, and more CTAs than rows:
    the same bits."""
    args, kw, _ = _identity_fwd_case(form)
    outs = [identity_fwd_schedule(*args, **kw, n_ctas=k, mm=mm_3xtf32)
            for k in (1, 3, 7, 300)]
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


@pytest.mark.usefixtures("one_torch_thread")
def test_identity_fwd_schedule_masked_slots_do_not_change_a_bit():
    """The same live edges in a Verlet list at r + skin (the candidates
    outside r masked) and in a list of exactly the live edges (RF's form,
    a clamp that binds): the same bits."""
    rng = np.random.default_rng(4)
    n, r = 150, 0.2
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    snd, rcv = sort_edges_by_receiver(*radius_graph(x, r + 0.1))
    d = x[snd] - x[rcv]
    keep = (d * d).sum(-1) <= np.float32(r) ** 2
    outs = []
    for s, rc, m in ((snd, rcv, keep), (snd[keep], rcv[keep], keep[keep])):
        sp, rp, em = pad_edges(s, rc, s.size + 50, x)
        em[:s.size] = m
        graph = (x, sp, rp, em, csr_indptr(rp, s.size, n), None, None)
        args, kw, _ = _identity_fwd_case("rf", graph)
        outs.append(identity_fwd_schedule(*args, **kw, n_ctas=9,
                                          mm=mm_3xtf32))
    assert 0 < keep.sum() < keep.size
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_identity_fwd_butterfly_is_the_warp_sum_tree():
    """The tile pass's dot: four threads an edge, each folding its eight
    butterfly lanes (k + 4 i) in the xor 16, 8, 4 levels, then xor 2 and 1
    across the threads -- bitwise ``warp_sum``'s butterfly over 32 lanes,
    every lane of which ends with the same bits."""
    rng = np.random.default_rng(9)
    lanes = torch.from_numpy((rng.standard_normal((500, 32))
                              * 10.0 ** rng.integers(-4, 4, (500, 32)))
                             .astype(np.float32))
    warp = lanes.clone()  # every lane: v += lane v ^ o
    for o in (16, 8, 4, 2, 1):
        warp = warp + warp[:, torch.arange(32) ^ o]
    assert all(torch.equal(warp[:, 0], warp[:, v]) for v in range(32))
    fold = []
    for k in range(4):  # thread k: s[i] = lane k + 4 i
        s = [lanes[:, k + 4 * i] for i in range(8)]
        for o in (4, 2, 1):
            s = [s[i] + s[i + o] for i in range(o)]
        fold.append(s[0])
    for o in (2, 1):
        fold = [fold[k] + fold[k ^ o] for k in range(4)]
    assert all(torch.equal(f, warp[:, 0]) for f in fold)
    # H1 = 24 zero-padded to W = 32 or to 64 (Dh above 32): the columns
    # past H1 add +0 to their lanes' chains, the same bits
    t, w = lanes[:, :24], lanes[0, 8:32]
    assert torch.equal(butterfly_dot(t, w, 32), butterfly_dot(t, w, 64))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("mm", [mm_3xtf32, mm_tensor_core],
                         ids=["3xtf32", "tensor-core"])
def test_identity_fwd_schedule_keeps_nan_in_h(mm):
    """NaN rows of h (a receiver and a sender with live edges; SchNet's
    form) reach the same outputs as in the plain version, and no others."""
    args, kw, _ = _identity_fwd_case("schnet-clip")
    args = (args[0], _plant_nans(args[1], (5, 11)), *args[2:])
    got = identity_fwd_schedule(*args, **kw, n_ctas=12, mm=mm)
    z = torch.zeros(1, 1)
    _assert_same_nans(got, edge_pathway_plain(
        *args, z, z, z, gate_mode="identity", rel_mode=kw["rel_mode"],
        clamp=kw["clamp"]))


# ---------------------------------------------------- virtual schedule
def virtual_fwd_schedule(x, h, z, mask, w1h, w1d, c1, w2, b2, wg1, bg1, wg2,
                         wz1, bz1, wz2, *, mm, rowsum=None, colsum=None):
    """``csrc/virtual_message.cu``'s schedule → ``(dx, mh, dz, ms)``, at
    the widths of the operands (``rowsum`` as in :func:`edge_fwd_schedule`,
    ``colsum``: the sums over a tile's rows, torch's by default)."""
    n, c = x.shape[0], z.shape[0]
    hid = w2.shape[-1]
    rowsum = rowsum or (lambda t: t.sum(-1))
    colsum = colsum or (lambda t: t.sum(0))
    f32 = torch.float32
    inv_c = 1.0 / c
    dx = torch.zeros((n, 3), dtype=f32)
    mh = torch.zeros((n, hid), dtype=f32)
    parts = []
    for i0 in range(0, n, TR):
        cnt = min(TR, n - i0)
        pad = lambda t: torch.cat([t, t.new_zeros((TR - cnt,)
                                                  + t.shape[1:])])
        xt, ht, mt = pad(x[i0:i0 + cnt]), pad(h[i0:i0 + cnt]), pad(
            mask[i0:i0 + cnt])
        ok = torch.arange(TR) < cnt
        mha = torch.zeros((TR, hid), dtype=f32)
        dxa = torch.zeros((TR, 3), dtype=f32)
        tile_parts = []
        for ch in range(c):  # the channels in order
            rl = xt - z[ch]
            d2 = (rl * rl).sum(-1)
            t1 = silu((mm(ht, w1h[ch]) + d2[:, None] * w1d[ch]) + c1[ch])
            msg = mm(t1, w2[ch]) + b2[ch]
            mha = mha + msg
            gx = rowsum(silu(mm(msg, wg1[ch]) + bg1[ch]) * wg2[ch, :, 0])
            gz = rowsum(silu(mm(msg, wz1[ch]) + bz1[ch]) * wz2[ch, :, 0])
            dxa = dxa + rl * gx[:, None]
            ms = colsum(torch.where(ok[:, None], msg * mt[:, None], 0.0))
            dzt = torch.where(ok[:, None], (-rl * gz[:, None]) * mt[:, None],
                              0.0)
            tile_parts.append((sum_in_order(list(dzt)), ms))
        parts.append(tile_parts)
        mh[i0:i0 + cnt] = (mha * inv_c)[:cnt]
        dx[i0:i0 + cnt] = (dxa * inv_c)[:cnt]
    red = lambda k: torch.stack([sum_in_order([p[ch][k] for p in parts])
                                 for ch in range(c)])
    return dx, mh, red(0), red(1)


def _virtual_fwd_case(n, c, seed=3):
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
    want = j_ref.virtual_pathway_ref(*[jnp.asarray(a)
                                       for a in (x, h, z, mask, *ws)])
    t = torch.from_numpy
    return (t(x), t(h), t(z), t(mask), *[t(w) for w in ws]), want


@pytest.mark.parametrize("mm", [mm_f32, mm_3xtf32], ids=["f32", "3xtf32"])
@pytest.mark.parametrize("n,c", [(150, 3), (64, 1), (37, 3), (200, 2)])
def test_virtual_fwd_schedule_matches_oracle(n, c, mm):
    args, want = _virtual_fwd_case(n, c)
    _assert_close(virtual_fwd_schedule(*args, mm=mm), want)


def test_virtual_fwd_schedule_single_tf32_pass_misses_tolerance():
    args, want = _virtual_fwd_case(150, 3)
    with pytest.raises(AssertionError):
        _assert_close(virtual_fwd_schedule(*args, mm=mm_1xtf32), want)


def _virtual_init_case(n, c, seed=7):
    """The model's own virtual block (``init_virtual_block``) at ``n``
    nodes, as the GPU tests build it."""
    rng = np.random.default_rng(seed)
    f = lambda a: a.astype(np.float32)
    x, h = f(rng.uniform(0, 1, (n, 3))), f(rng.standard_normal((n, HID)))
    mask = f((rng.uniform(size=n) > 0.1) * 1.0)
    z = f(0.5 + 0.2 * rng.standard_normal((c, 3)))
    s = torch.from_numpy(f(0.1 * rng.standard_normal((c, HID))))
    block = init_virtual_block(torch.Generator().manual_seed(seed), c, HID,
                               HID, HID, device="cpu")
    w = unpack_virtual_block(block, s, torch.zeros(c, c), HID)
    ws = [w[k].numpy() for k in ("w1h", "w1d", "const1", "w2", "b2", "wg1",
                                 "bg1", "wg2", "wz1", "bz1", "wz2")]
    want = j_ref.virtual_pathway_ref(*[jnp.asarray(a)
                                       for a in (x, h, z, mask, *ws)])
    t = torch.from_numpy
    return (t(x), t(h), t(z), t(mask), *[t(a) for a in ws]), want


@pytest.mark.parametrize("step_sum", [True, False],
                         ids=["step-sums", "one-accumulator"])
def test_virtual_fwd_schedule_tensor_core_rounding(step_sum):
    """The serving size, one channel: ms sums ~7,400 messages.  With the
    24 MMAs of each product rounding toward zero into one accumulator, the
    messages' common bias leaves the forward tolerance; summing each
    k-step on its own keeps it."""
    args, want = _virtual_init_case(8192, 1)
    got = virtual_fwd_schedule(
        *args, mm=lambda a, b: mm_tensor_core(a, b, step_sum))
    if step_sum:
        _assert_close(got, want)
    else:
        with pytest.raises(AssertionError):
            _assert_close(got, want)


# ------------------------------------------------------ NaN in the inputs
CARD_NANS = (0x7FFFFFFF, -1)  # the card's NaN, and 0xffffffff


def _plant_nans(h, rows):
    """h with rows set to NaN bit patterns the card computes."""
    h = h.clone()
    for r, bits in zip(rows, CARD_NANS):
        h.view(torch.int32)[r] = bits
    return h


def _assert_same_nans(got, want):
    """NaN where the plain version has NaN, and close elsewhere."""
    for g, w in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        ok = ~torch.isnan(w)
        torch.testing.assert_close(g[ok], w[ok], atol=ATOL, rtol=RTOL)
    assert any(torch.isnan(g).any() for g in got)


@pytest.mark.parametrize("mm", [mm_3xtf32, mm_tensor_core],
                         ids=["3xtf32", "tensor-core"])
def test_edge_fwd_schedule_keeps_nan_in_h(mm):
    """NaN rows of h (a receiver and a sender with live edges) reach the
    same outputs as in the plain version, and no others."""
    targs, kw, _ = _edge_fwd_case("mlp", "inv1p", 0.05)
    args = (targs[0], _plant_nans(targs[1], (5, 11)), *targs[2:])
    got = edge_fwd_schedule(*args, **kw, n_ctas=12, mm=mm)
    _assert_same_nans(got, edge_pathway_plain(*args, **kw))


@pytest.mark.parametrize("mm", [mm_3xtf32, mm_tensor_core],
                         ids=["3xtf32", "tensor-core"])
def test_virtual_fwd_schedule_keeps_nan_in_h(mm):
    """NaN rows of h at two live nodes: NaN in their rows and in the
    masked sums, as in the plain version."""
    args, _ = _virtual_fwd_case(150, 3)
    live = torch.nonzero(args[3]).flatten()
    args = (args[0], _plant_nans(args[1], (int(live[3]), int(live[90]))),
            *args[2:])
    got = virtual_fwd_schedule(*args, mm=mm)
    _assert_same_nans(got, virtual_pathway_plain(*args))
