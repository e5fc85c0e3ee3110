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
"""
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
