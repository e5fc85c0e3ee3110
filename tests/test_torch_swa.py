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
fault (window + 1) do not.  The wrapper's routing rules are checked
without launching anything.
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
    t_swa.reset_launches()
    assert t_swa.launches == 0 and t_swa.wgmma_launches == 0
