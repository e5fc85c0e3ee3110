"""Port sliding-window attention (#7) vs the JAX package.

On the CPU the port's ``kernels.swa_attention.swa_attention`` runs its
plain version (``chunked_attention``, the port of the reference's
``_chunked_attention``); it is held against the reference's Pallas
``swa_attention`` in interpret mode and its oracle
``ref.swa_attention_ref``, on the reference's own grid
(``tests/test_kernels.py``) at its tolerances: atol = rtol = 2e-4 in f32,
2e-2 in bf16.  The port's oracle is held against the reference's the same
way, and a ragged S (which the Pallas kernel cannot take) against both
oracles.

The bf16 CUDA kernel (``csrc/swa_attention_wgmma.cu``) cannot run here; its
tile loop (128 x 64 tiles, online softmax, P split into two bf16 parts for
the tensor cores) is emulated in f32 below and held to the bound the card
holds the kernel to, ``|k - p| <= 1e-3 + 2^-7 |p|`` against
``chunked_attention``: the split passes, a single bf16 P and a planted
fault (window + 1) do not.  The f32 CUDA kernel (``csrc/swa_attention.cu``)
is emulated the same way, in float64 with the card's rounding made
explicit: 128-row CTAs of 16-row warps, 32-key blocks that a warp skips
where none of its rows sees them, every product split into TF32 parts
(3xTF32) with each MMA's result rounded toward zero, Q Kᵀ summed a k-step
at a time and P V a key block at a time, online softmax in f32.  It is
held to the f32 tolerance the card applies (atol 1e-5, rtol 1e-4) against
the Pallas kernel and ``chunked_attention``; a single TF32 pass and the
planted fault miss it, and the step sums' effect is measured.  The
wrapper's routing rules are checked without launching anything.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.swa_attention import swa_attention as j_swa
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels import swa_attention as t_swa
from test_torch_bwd_schedule import mm_1xtf32, split_tf32
from test_torch_fwd_schedule import _round_to_zero, mm_tensor_core

GRID = [
    (128, 2, 32, None, True, 64),
    (256, 2, 64, 64, True, 128),
    (256, 4, 32, 32, True, 32),
    (128, 1, 64, None, False, 128),
    (512, 2, 64, 100, True, 128),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bfloat16"
            else dict(rtol=2e-4, atol=2e-4))


def _qkv(h, s, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((h, s, d)).astype(np.float32)
            for _ in range(3)]


def _f32(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("s,h,d,window,causal,bq", GRID)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_port_swa_matches_pallas_and_oracle(s, h, d, window, causal, bq,
                                            dtype):
    jdt, tdt = DTYPES[dtype]
    q, k, v = _qkv(h, s, d, s + h)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = t_swa.swa_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (h, s, d)
    pallas = j_swa(jq, jk, jv, causal=causal, window=window, block_q=bq,
                   block_k=bq, interpret=True)
    np.testing.assert_allclose(_f32(got), np.asarray(pallas, np.float32),
                               **_tol(dtype))
    f = lambda a: np.asarray(a, np.float32).transpose(1, 0, 2)
    oracle = j_ref.swa_attention_ref(
        *(jnp.asarray(f(a)) for a in (jq, jk, jv)), window,
        causal).transpose(1, 0, 2)
    np.testing.assert_allclose(_f32(got), np.asarray(oracle), **_tol(dtype))


@pytest.mark.parametrize("s,h,d,window,causal,bq", GRID)
def test_port_oracle_matches_reference_oracle(s, h, d, window, causal, bq):
    q, k, v = (a.transpose(1, 0, 2) for a in _qkv(h, s, d, s + h))
    want = j_ref.swa_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), window, causal)
    got = t_ref.swa_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), window, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **_tol("f32"))


@pytest.mark.parametrize("window,causal", [(None, True), (64, True),
                                           (30, False), (1, True)])
def test_ragged_length_plain_path_matches_oracles(window, causal):
    s, h, d = 100, 2, 64
    q, k, v = _qkv(h, s, d, 3)
    got = t_swa.swa_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, window=window)
    sh = lambda a: a.transpose(1, 0, 2)
    want_t = t_ref.swa_attention_ref(
        *(torch.from_numpy(sh(a)) for a in (q, k, v)), window, causal)
    want_j = j_ref.swa_attention_ref(*(jnp.asarray(sh(a)) for a in (q, k, v)),
                                     window, causal)
    np.testing.assert_allclose(got.numpy(), sh(want_t.numpy()),
                               **_tol("f32"))
    np.testing.assert_allclose(got.numpy(), sh(np.asarray(want_j)),
                               **_tol("f32"))


def test_grouped_heads_and_query_chunks_match_oracle():
    """``attention``'s (B, S, H, D) layout with H / KV = 2 and S split
    into query chunks equals the oracle run on K/V repeated per group."""
    b, s, h, kv, d = 2, 96, 4, 2, 32
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, kv, d))
                             .astype(np.float32)) for _ in range(2))
    got = t_swa.attention(q, k, v, causal=True, window=40, q_chunk=32)
    for i in range(b):
        want = t_ref.swa_attention_ref(q[i], k[i].repeat_interleave(2, dim=1),
                                       v[i].repeat_interleave(2, dim=1), 40)
        np.testing.assert_allclose(got[i].numpy(), want.numpy(),
                                   **_tol("f32"))


def test_wrapper_refuses_bad_inputs():
    x = torch.zeros(2, 16, 32)
    with pytest.raises(ValueError, match="window"):
        t_swa.swa_attention(x, x, x, window=0)
    with pytest.raises(ValueError, match="one shape"):
        t_swa.swa_attention(x, x[:, :8], x)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        t_swa.swa_attention(x.half(), x.half(), x.half())
    with pytest.raises(TypeError, match="is torch.bfloat16"):
        t_swa.swa_attention(x, x.bfloat16(), x)
    q = torch.zeros(1, 16, 3, 32)
    kv = torch.zeros(1, 16, 2, 32)
    with pytest.raises(ValueError, match="do not group"):
        t_swa.attention(q, kv, kv)


# the bound chip_smoke.py and tests/test_torch_cuda.py hold bf16 kernels to
BF16_ATOL, BF16_RTOL = 1e-3, 2.0 ** -7


def _emulate_wgmma_tile_loop(q, k, v, *, window, split_p):
    """The bf16 kernel's arithmetic for causal attention, in f32 on the
    CPU: per 64-row query block (a consumer warpgroup) the 64-key blocks
    that meet the band, scores from bf16 q and k in f32, masked entries
    p = 0 by a select, base-2 online softmax, P rounded to bf16 once
    (``split_p=False``) or split into P_hi = bf16(P) and
    P_lo = bf16(P - P_hi) with two P V products, l summing the unrounded P,
    one bf16 rounding of acc / max(l, 1e-30).  q (B, S, H, D), k and v
    (B, S, KV, D) in bf16."""
    bq, bk, neg = 64, 64, -1e30
    b, s, h, d = q.shape
    g = h // k.shape[2]
    qf = q.float().transpose(1, 2)  # (B, H, S, D)
    kf, vf = (t.float().repeat_interleave(g, dim=2).transpose(1, 2)
              for t in (k, v))
    c = math.log2(math.e) / math.sqrt(d)
    bf = lambda t: t.to(torch.bfloat16).float()
    out = torch.empty_like(qf)
    for q0 in range(0, s, bq):
        rows = torch.arange(q0, min(q0 + bq, s))
        m = torch.full((b, h, len(rows), 1), neg)
        l = torch.zeros((b, h, len(rows), 1))
        acc = torch.zeros((b, h, len(rows), d))
        lo = max(0, q0 - window + 1) // bk if window else 0
        for k0 in range(lo * bk, rows[-1].item() + 1, bk):
            keys = torch.arange(k0, min(k0 + bk, s))
            vis = keys[None, :] <= rows[:, None]
            if window:
                vis &= keys[None, :] > rows[:, None] - window
            x = torch.where(vis, qf[:, :, rows] @ kf[:, :, keys].transpose(
                -1, -2) * c, neg)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            alpha = torch.exp2(m - m_new)
            p = torch.where(vis, torch.exp2(x - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            hi = bf(p)
            acc = acc * alpha + hi @ vf[:, :, keys]
            if split_p:
                acc = acc + bf(p - hi) @ vf[:, :, keys]
            m = m_new
        out[:, :, rows] = acc / l.clamp(min=1e-30)
    return out.transpose(1, 2).to(torch.bfloat16)


def _bf16_within(got, want):
    d = (got.float() - want.float()).abs()
    return bool(torch.all(d <= BF16_ATOL + BF16_RTOL * want.float().abs()))


def test_wgmma_tile_loop_needs_split_p():
    """At S = 1,024, H = 2 over KV = 1, D = 256, window 256: the split-P
    tile loop lands within one bf16 rounding of the plain version, a single
    bf16 P does not, and neither does a planted fault (window + 1) — the
    design decision the CUDA kernel rests on."""
    s, h, kv, d, window = 1024, 2, 1, 256, 256
    rng = np.random.default_rng(14)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, s, n, d)).astype(
        np.float32)).to(torch.bfloat16) for n in (h, kv, kv))
    pos = torch.arange(s)
    want = t_swa.chunked_attention(q, k, v, pos, pos, causal=True,
                                   window=window)
    split = _emulate_wgmma_tile_loop(q, k, v, window=window, split_p=True)
    single = _emulate_wgmma_tile_loop(q, k, v, window=window, split_p=False)
    fault = _emulate_wgmma_tile_loop(q, k, v, window=window + 1,
                                     split_p=True)
    assert _bf16_within(split, want)
    assert not _bf16_within(single, want)
    assert not _bf16_within(fault, want)


# the f32 kernels' tolerance (chip_smoke.py's ATOL / RTOL)
F32_ATOL, F32_RTOL = 1e-5, 1e-4


@pytest.fixture
def one_torch_thread():
    """torch on one thread for the f32 emulation: its thousands of small
    ops run ~50x slower on torch's threads when parallel test workers
    share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32_3x(a, b):
    """3xTF32 products as the tensor core sums them, a k-step's three MMAs
    summed from zero and added to the running sum in f32."""
    return mm_tensor_core(a, b, step_sum=True)


def _block_sum(o, p, vb):
    """The kernel's P V: the block's 3xTF32 MMAs summed from zero (each
    result rounded toward zero), the block added to O in f32."""
    return o + mm_tensor_core(p, vb, step_sum=False)


def _mma_into(o, p, vb):
    """P V by 3xTF32 MMAs that accumulate into O itself, each result
    rounded toward zero (no block sum)."""
    (ph, pl), (vh, vl) = split_tf32(p), split_tf32(vb)
    for kk in range(0, p.shape[1], 8):
        ks = slice(kk, kk + 8)
        for x, y in ((pl, vh), (ph, vl), (ph, vh)):
            o = _round_to_zero(o.double() + x[:, ks].double()
                               @ y[ks].double())
    return o


def _emulate_f32_tile_loop(q, k, v, *, window, causal=True, qk=_tf32_3x,
                           pv=_block_sum):
    """The f32 kernel's arithmetic on the CPU: per head S = ``qk``(Q, Kᵀ)
    (each score's chain of MMAs does not depend on the tiling, so the whole
    matrix at once), then per 32-key block, for the rows of the 16-row
    warps that do not skip it, the masked select with -1e30, online
    softmax in f32, and O = ``pv``(O·alpha, P, V); O / max(l, 1e-30).
    q (B, S, H, D), k and v (B, S, KV, D) in f32."""
    bk, wr, neg = 32, 16, -1e30
    b, s, h, d = q.shape
    g = h // k.shape[2]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    out = torch.empty_like(q)
    r0 = torch.arange(0, s, wr)  # each warp's first row
    for bi in range(b):
        for hi in range(h):
            kh, vh = k[bi, :, hi // g], v[bi, :, hi // g]
            sc = qk(q[bi, :, hi], kh.T.contiguous())
            m = torch.full((s,), neg)
            l = torch.zeros(s)
            o = torch.zeros(s, d)
            for k0 in range(0, s, bk):
                live = torch.ones_like(r0, dtype=torch.bool)
                if causal:
                    live &= k0 <= r0 + wr - 1
                if window:
                    live &= k0 + bk - 1 > r0 - window
                rows = (r0[live][:, None] + torch.arange(wr)).flatten()
                rows = rows[rows < s]
                if not len(rows):
                    continue
                keys = torch.arange(k0, min(k0 + bk, s))
                vis = torch.ones(len(rows), len(keys), dtype=torch.bool)
                if causal:
                    vis &= keys[None] <= rows[:, None]
                if window:
                    vis &= keys[None] > rows[:, None] - window
                x = torch.where(vis, sc[rows][:, keys] * scale, neg)
                m_new = torch.maximum(m[rows], x.amax(-1))
                p = torch.where(vis, torch.exp(x - m_new[:, None]), 0.0)
                alpha = torch.exp(m[rows] - m_new)
                l[rows] = l[rows] * alpha + p.sum(-1)
                o[rows] = pv(o[rows] * alpha[:, None], p, vh[keys])
                m[rows] = m_new
            out[bi, :, hi] = o / l.clamp(min=1e-30)[:, None]
    return out


def _f32_worst(got, want):
    """The largest |got - want| over the f32 tolerance: <= 1 passes."""
    d = (got - want).abs()
    return float((d / (F32_ATOL + F32_RTOL * want.abs())).max())


def _attention_inputs(s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, s, n, d)).astype(
        np.float32)) for n in (h, kv, kv)]


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.usefixtures("one_torch_thread")
def test_f32_tile_loop_matches_pallas_and_plain(d, window, group):
    """S = 512, 2 query heads: the f32 kernel's tile loop lands within the
    f32 tolerance of the Pallas kernel (interpret mode, K and V repeated
    for each query head) and of ``chunked_attention``."""
    s, h = 512, 2
    q, k, v = _attention_inputs(s, h, h // group, d, seed=d + s + group)
    got = _emulate_f32_tile_loop(q, k, v, window=window)
    pos = torch.arange(s)
    plain = t_swa.chunked_attention(q, k, v, pos, pos, causal=True,
                                    window=window)
    hsd = lambda t, n: jnp.asarray(
        t[0].repeat_interleave(n, dim=1).transpose(0, 1).numpy())
    pallas = j_swa(hsd(q, 1), hsd(k, group), hsd(v, group), causal=True,
                   window=window, interpret=True)
    pallas = torch.from_numpy(np.array(pallas)).transpose(0, 1)[None]
    assert _f32_worst(got, pallas) <= 1.0
    assert _f32_worst(got, plain) <= 1.0


@pytest.mark.usefixtures("one_torch_thread")
def test_f32_tile_loop_single_tf32_pass_and_planted_fault_miss():
    """S = 512, D = 256, window 256, 2 query heads over one KV head: one
    TF32 pass a product instead of three, or the window one too wide, lands
    outside the f32 tolerance that the 3xTF32 loop keeps."""
    s, d, window = 512, 256, 256
    q, k, v = _attention_inputs(s, 2, 1, d, seed=17)
    pos = torch.arange(s)
    want = t_swa.chunked_attention(q, k, v, pos, pos, causal=True,
                                   window=window)
    assert _f32_worst(_emulate_f32_tile_loop(q, k, v, window=window),
                      want) <= 1.0
    single = _emulate_f32_tile_loop(
        q, k, v, window=window, qk=mm_1xtf32,
        pv=lambda o, p, vb: o + mm_1xtf32(p, vb))
    assert _f32_worst(single, want) > 1.0
    fault = _emulate_f32_tile_loop(q, k, v, window=window + 1)
    assert _f32_worst(fault, want) > 1.0


@pytest.mark.usefixtures("one_torch_thread")
def test_f32_tile_loop_qk_step_sum_keeps_margin():
    """S = 512, D = 256 (96 MMAs a score), causal: Q Kᵀ's chain of MMAs
    into one accumulator, each rounded toward zero, takes several times
    more of the tolerance than a k-step at a time, which the kernel
    does."""
    s, d = 512, 256
    q, k, v = _attention_inputs(s, 2, 2, d, seed=1)
    pos = torch.arange(s)
    want = t_swa.chunked_attention(q, k, v, pos, pos, causal=True,
                                   window=None)
    step = _f32_worst(_emulate_f32_tile_loop(q, k, v, window=None), want)
    chain = _f32_worst(_emulate_f32_tile_loop(
        q, k, v, window=None,
        qk=lambda a, b: mm_tensor_core(a, b, step_sum=False)), want)
    print(f"worst / tolerance: k-step sums {step:.3f}, one chain "
          f"{chain:.3f}")
    assert step <= 0.15 and chain >= 2 * step


@pytest.mark.usefixtures("one_torch_thread")
def test_f32_tile_loop_pv_block_sum_bias():
    """S = 2,048 causal, D = 64, v > 0 (so O > 0 and a bias toward zero
    shows as a negative relative error): the kernel sums each key block's
    P V MMAs from zero and adds the block to O in f32, not each k-step
    (as Q Kᵀ does).  Against float64, the mean relative error of the last
    256 rows stays below 2e-6; with the MMAs accumulating straight into O
    (each result rounded toward zero) it is over 10x that, and it grows
    with the number of keys (~8e-6 for every 1,024)."""
    s, d = 2048, 64
    rng = np.random.default_rng(2)
    q, k = (torch.from_numpy(rng.standard_normal((1, s, 1, d)).astype(
        np.float32)) for _ in range(2))
    v = torch.from_numpy((1.0 + 0.1 * rng.standard_normal((1, s, 1, d)))
                         .astype(np.float32))
    x = (q[0, :, 0].double() @ k[0, :, 0].double().T) / math.sqrt(d)
    x = x.masked_fill(torch.ones(s, s, dtype=torch.bool).triu(1),
                      float("-inf"))
    exact = torch.softmax(x, -1) @ v[0, :, 0].double()
    qk_exact = lambda a, b: (a.double() @ b.double()).float()
    rel = lambda o: float(((o[0, -256:, 0].double() - exact[-256:])
                           / exact[-256:]).mean())
    block = rel(_emulate_f32_tile_loop(q, k, v, window=None, qk=qk_exact))
    straight = rel(_emulate_f32_tile_loop(q, k, v, window=None, qk=qk_exact,
                                          pv=_mma_into))
    print(f"mean relative error of the last 256 rows: block sums "
          f"{block:.2e}, MMAs straight into O {straight:.2e}")
    assert abs(block) < 2e-6 and straight < -10 * abs(block)


def test_route_sends_each_dtype_to_its_kernel():
    x32 = torch.zeros(1, 16, 2, 64)
    assert t_swa.route(x32, x32, x32, x32) == "swa_attention"
    x16 = x32.to(torch.bfloat16)
    assert t_swa.route(x16, x16, x16, x16) == "swa_attention_wgmma"


def test_route_refuses_bf16_strides_off_tma_alignment():
    """Strides of 68 elements: float4 loads take them in f32, TMA (16
    bytes, 8 bf16) does not take them in bf16."""
    wide = torch.zeros(1, 16, 2, 68)
    x32 = wide[..., :64]
    assert t_swa.route(x32, x32, x32, x32) == "swa_attention"
    x16 = wide.to(torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="multiples of 8"):
        t_swa.route(x16, x16, x16, x16)
    with pytest.raises(ValueError, match="D in"):
        y = torch.zeros(1, 16, 2, 32, dtype=torch.bfloat16)
        t_swa.route(y, y, y, y)


def test_reset_launches_resets_both_counters(monkeypatch):
    monkeypatch.setattr(t_swa, "launches", 5)
    monkeypatch.setattr(t_swa, "wgmma_launches", 3)
    monkeypatch.setitem(t_swa.form_launches, "64x64-causal", 5)
    t_swa.reset_launches()
    assert t_swa.launches == 0 and t_swa.wgmma_launches == 0
    assert t_swa.form_launches == {}
