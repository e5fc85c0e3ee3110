"""The LM stack's attention family in the port vs the JAX package.

Six configs at their ``reduced()`` widths (2 layers, d_model 256, 4 heads
of 64, vocab 512; 4 experts, top-2, expert width 128; MLA 32 + 16 / 32;
whisper 2 encoder layers over 16 frames; llama-vision's second layer a
cross layer over 16 image tokens): olmoe-1b-7b (MoE), deepseek-v2-lite-16b
(MLA, a dense first layer, then MoE with shared experts), granite-20b
(MQA), llama3-405b (GQA), whisper-small (encoder + cross-attention in
every layer) and llama-3.2-vision-11b (image cross-attention).  Weights
come from the reference's ``init_arch`` through ``params_from_jax``;
tokens, frames and patch embeddings from numpy seeds.  On the CPU every
attention runs the attention kernel's plain version.

Tolerances: the MoE dispatch's integer outputs (top-k indices, slot
order, counts, keep, dst) exactly; building blocks (MoE, MLA, cross-
attention, the encoder, the plain attention) atol 1e-5 / rtol 1e-4 in f32;
``forward`` and ``decode_step`` at f32 within 1e-4 of the largest |logit|
(and rtol 1e-4), the aux loss within 1e-5; ``forward`` at bf16 within
relative L2 0.1 of the reference's bf16 forward (DESIGN.md §9.3's bf16
bound); MLA's decode against its forward (port against port, f32) at
atol 1e-5 / rtol 1e-4; cache footprints exactly.  (A whole model's decode
is not held to its forward: the virtual-token read sums over the whole
prompt, and MoE capacity depends on the tokens in a call.)
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.archs import model as j_model
from repro.configs import get_arch as j_get_arch
from repro.launch.serve import cache_bytes as j_cache_bytes
from repro.nn import attention as j_attn
from repro.nn import moe as j_moe
from repro_torch.archs import model as t_model
from repro_torch.configs import get_arch
from repro_torch.kernels import swa_attention as t_swa
from repro_torch.launch import serve as t_serve
from repro_torch.nn import attention as t_attn
from repro_torch.nn import moe as t_moe
from repro_torch.weights import params_from_jax

ATOL, RTOL = 1e-5, 1e-4
FAMILIES = ["olmoe_1b_7b", "deepseek_v2_lite_16b", "granite_20b",
            "llama3_405b", "whisper_small", "llama_3_2_vision_11b"]
B, S, STEPS = 2, 64, 8


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close_to_max(got, want, tol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return np.linalg.norm(np.asarray(got, np.float64) - want) / \
        np.linalg.norm(want)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    """(port cfg, reference cfg, reference params, port params, inputs):
    tokens (B, S) and, where the config reads them, ``audio`` or
    ``images`` (B, 16, d_model)."""
    aid = request.param
    cfg, jcfg = get_arch(aid).reduced(), j_get_arch(aid).reduced()
    jp = j_model.init_arch(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    inputs = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.has_encoder:
        inputs["audio"] = rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    elif cfg.cross_attn_every:
        inputs["images"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, jp, tp, inputs


def _modality(inputs, to):
    return {k: to(v) for k, v in inputs.items() if k != "tokens"}


def _forward_pair(family, jdt, tdt):
    cfg, jcfg, jp, tp, inputs = family
    want, jaux = j_model.forward(jp, jcfg, jnp.asarray(inputs["tokens"]),
                                 dtype=jdt, **_modality(inputs, jnp.asarray))
    with torch.no_grad():
        got, aux = t_model.forward(tp, cfg, torch.from_numpy(inputs["tokens"]),
                                   dtype=tdt, **_modality(inputs, _t))
    return got, aux, np.asarray(want), float(jaux)


# ------------------------------------------------------------------ forward
def test_forward_f32_matches(family):
    got, aux, want, jaux = _forward_pair(family, jnp.float32, torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close_to_max(got.numpy(), want)
    np.testing.assert_allclose(float(aux), jaux, atol=1e-5, rtol=0)
    cfg = family[0]
    if cfg.moe is not None:
        assert jaux > 0.5  # ~1 per MoE layer: the loss is really summed
    else:
        assert float(aux) == 0.0


def test_forward_bf16_close(family):
    got, aux, want, jaux = _forward_pair(family, jnp.bfloat16, torch.bfloat16)
    rel = _rel_l2(got.numpy(), want)
    assert rel < 0.1, rel
    assert abs(float(aux) - jaux) <= 0.1 * max(abs(jaux), 1e-6)


def test_init_arch_tree_matches_reference(family):
    """The port's own init builds the reference's tree: same structure,
    shapes, and (built in bf16) dtype — what ``params_from_jax`` carries
    across, stacked experts, MLA weights and the encoder included."""
    cfg, _, jp, _, _ = family
    tp = t_model.init_arch(torch.Generator().manual_seed(0), cfg,
                           device="cpu", dtype=torch.bfloat16)
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert tdef == jdef
    assert [tuple(t.shape) for t in tl] == [tuple(a.shape) for a in jl]
    assert all(t.dtype == torch.bfloat16 for t in tl)


@pytest.mark.parametrize("aid", ["whisper_small", "llama_3_2_vision_11b"])
def test_forward_needs_its_modality(aid):
    cfg = get_arch(aid).reduced()
    tp = t_model.init_arch(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    with pytest.raises(ValueError, match="embeddings"):
        t_model.forward(tp, cfg, torch.zeros((1, 4), dtype=torch.long))


# ------------------------------------------------------------------- decode
def _enc_out(family, dtype_j, dtype_t):
    """The cross-attention source of both: the encoded frames (whisper)
    or the patch embeddings (vlm), in each package's dtype; else None."""
    cfg, jcfg, jp, tp, inputs = family
    if cfg.has_encoder:
        return (j_model.encode_audio(jp, jcfg, jnp.asarray(inputs["audio"]),
                                     dtype_j),
                t_model.encode_audio(tp, cfg, _t(inputs["audio"]), dtype_t))
    if cfg.cross_attn_every:
        return (jnp.asarray(inputs["images"], dtype_j),
                _t(inputs["images"]).to(dtype_t))
    return None, None


def test_decode_matches_reference(family):
    """Teacher-forced f32 decode for STEPS steps, every step's logits; the
    MLA latents' positions equal the reference's."""
    cfg, jcfg, jp, tp, inputs = family
    tok = inputs["tokens"]
    j_enc, t_enc = _enc_out(family, jnp.float32, torch.float32)
    jc = j_model.init_cache(jcfg, B, STEPS, enc_out=j_enc, dtype=jnp.float32)
    with torch.no_grad():
        tc = t_model.init_cache(cfg, B, STEPS, enc_out=t_enc,
                                dtype=torch.float32, device="cpu")
        for t in range(STEPS):
            want, jc = j_model.decode_step(jp, jcfg, jc, jnp.asarray(tok[:, t]),
                                           jnp.full((B,), t, jnp.int32),
                                           dtype=jnp.float32)
            got, tc = t_model.decode_step(
                tp, cfg, tc, torch.from_numpy(tok[:, t]),
                torch.full((B,), t, dtype=torch.int32), dtype=torch.float32)
            _close_to_max(got.numpy(), want)
    for jl, tl in zip(jc.layers, tc.layers):
        np.testing.assert_array_equal(tl["kv"].pos.numpy(),
                                      np.asarray(jl["kv"].pos))


@pytest.mark.parametrize("aid", FAMILIES)
@pytest.mark.parametrize("full", [False, True])
def test_cache_bytes_match_reference(aid, full):
    cfg, jcfg = get_arch(aid), j_get_arch(aid)
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    b, cap = 2, 48
    n_enc = cfg.n_audio_frames if cfg.has_encoder else cfg.n_image_tokens
    enc = (cfg.has_encoder or cfg.cross_attn_every) and not full
    j_enc = jnp.zeros((b, n_enc, cfg.d_model), jnp.bfloat16) if enc else None
    t_enc = torch.zeros((b, n_enc, cfg.d_model),
                        dtype=torch.bfloat16) if enc else None
    if full:  # keep the full configs' caches small: one slot
        cap = 1
    got = t_serve.cache_bytes(t_model.init_cache(cfg, b, cap, enc_out=t_enc,
                                                 device="cpu"))
    assert got == j_cache_bytes(j_model.init_cache(jcfg, b, cap,
                                                   enc_out=j_enc))


# ----------------------------------------------------------------- encoder
def test_encode_audio_matches():
    cfg, jcfg = (get_arch("whisper_small").reduced(),
                 j_get_arch("whisper_small").reduced())
    jp = j_model.init_arch(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    frames = np.random.default_rng(3).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32)
    want = j_model.encode_audio(jp, jcfg, jnp.asarray(frames), jnp.float32)
    with torch.no_grad():
        got = t_model.encode_audio(tp, cfg, _t(frames), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


# --------------------------------------------------------- cross-attention
@pytest.mark.parametrize("kv", [4, 2, 1])
def test_cross_attention_matches(kv):
    """GQA cross-attention (T = 24 keys against S = 40 queries, no RoPE,
    not causal) and one query at a decode position, as decode_step calls
    it."""
    from repro.nn.attention import init_gqa

    d, h, dh = 128, 4, 32
    jp = init_gqa(jax.random.PRNGKey(kv), d, h, kv, dh)
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(kv)
    x = rng.standard_normal((2, 40, d)).astype(np.float32)
    enc = rng.standard_normal((2, 24, d)).astype(np.float32)
    kw = dict(n_heads=h, n_kv=kv, d_head=dh, q_chunk=8)
    for xs, pos in ((x, np.arange(40)), (x[:, :1], np.array([17]))):
        want = j_attn.gqa_forward(jp, jnp.asarray(xs), jnp.asarray(pos),
                                  cross_kv=jnp.asarray(enc), **kw)
        got = t_attn.gqa_forward(tp, _t(xs), torch.from_numpy(pos),
                                 cross_kv=_t(enc), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)


# ---------------------------------------------------------- plain attention
@pytest.mark.parametrize("causal,t", [(True, 40), (False, 40), (False, 23)])
def test_chunked_attention_dv_and_key_length(causal, t):
    """The plain version at MLA-like widths (q and k 48 wide, v 32) and a
    key length of its own, against the reference's ``_chunked_attention``
    (kv positions 0 .. T-1; causal only with T = S)."""
    rng = np.random.default_rng(t)
    s, h, kv = 40, 4, 2
    q = rng.standard_normal((2, s, h, 48)).astype(np.float32)
    k = rng.standard_normal((2, t, kv, 48)).astype(np.float32)
    v = rng.standard_normal((2, t, kv, 32)).astype(np.float32)
    qp, kp = np.arange(s), np.arange(t)
    want = j_attn._chunked_attention(
        *map(jnp.asarray, (q, k, v, qp, kp)), causal=causal, window=None,
        q_chunk=8)
    got = t_swa.chunked_attention(*map(torch.from_numpy, (q, k, v, qp, kp)),
                                  causal=causal, window=None, q_chunk=8)
    assert got.shape == (2, s, h, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    # the wrapper on the CPU: the same function at positions 0 .. S-1 / T-1
    wrapped = t_swa.attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, q_chunk=8)
    torch.testing.assert_close(wrapped, got)


def test_attention_wrapper_refuses_causal_cross():
    q = torch.zeros(1, 16, 2, 64)
    kv = torch.zeros(1, 12, 2, 64)
    with pytest.raises(ValueError, match="causal"):
        t_swa.attention(q, kv, kv, causal=True)
    with pytest.raises(ValueError, match="B,T,KV,Dv"):
        t_swa.attention(q, kv, torch.zeros(1, 11, 2, 64), causal=False)


@pytest.mark.parametrize("widths,ok", [((192, 128), True), ((64, 64), True),
                                       ((128, 64), False), ((48, 32), False),
                                       ((192, 192), False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_takes_the_compiled_widths(widths, ok, dtype):
    d, dv = widths
    q = torch.zeros(1, 16, 2, d, dtype=dtype)
    k = torch.zeros(1, 24, 2, d, dtype=dtype)
    v = torch.zeros(1, 24, 2, dv, dtype=dtype)
    o = torch.zeros(1, 16, 2, dv, dtype=dtype)
    if ok:
        assert t_swa.route(q, k, v, o) == t_swa.KERNELS[dtype][0]
    else:
        with pytest.raises(ValueError, match="D in"):
            t_swa.route(q, k, v, o)


# ---------------------------------------------------------------------- MLA
@pytest.fixture(scope="module")
def mla():
    jcfg = j_get_arch("deepseek_v2_lite_16b").reduced()
    m = jcfg.mla
    jp = j_attn.init_mla(jax.random.PRNGKey(5), jcfg.d_model, jcfg.n_heads,
                         kv_lora=m.kv_lora, d_nope=m.d_nope, d_rope=m.d_rope,
                         d_v=m.d_v)
    kw = dict(n_heads=jcfg.n_heads, kv_lora=m.kv_lora, d_nope=m.d_nope,
              d_rope=m.d_rope, d_v=m.d_v, rope_theta=jcfg.rope_theta)
    x = np.random.default_rng(5).standard_normal(
        (2, 24, jcfg.d_model)).astype(np.float32)
    return jp, params_from_jax(jp, device="cpu"), kw, x


def test_mla_forward_matches(mla):
    jp, tp, kw, x = mla
    pos = np.arange(x.shape[1])
    want = j_attn.mla_forward(jp, jnp.asarray(x), jnp.asarray(pos), q_chunk=8,
                              **kw)
    for use_kernel in (True, False):
        got = t_attn.mla_forward(tp, _t(x), torch.from_numpy(pos), q_chunk=8,
                                 use_kernel=use_kernel, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)


def test_mla_decode_matches_reference_and_forward(mla):
    """f32 decode over the 24 tokens against the reference's decode at each
    step, and its outputs against the port's forward at each position."""
    jp, tp, kw, x = mla
    b, s = x.shape[:2]
    jc = j_attn.init_mla_cache(b, s, kw["kv_lora"], kw["d_rope"], jnp.float32)
    tc = t_attn.init_mla_cache(b, s, kw["kv_lora"], kw["d_rope"],
                               torch.float32, device="cpu")
    full = t_attn.mla_forward(tp, _t(x), None, use_kernel=False, **kw)
    for t in range(s):
        pos = np.full((b,), t, np.int32)
        want, jc = j_attn.mla_decode(jp, jnp.asarray(x[:, t:t + 1]), jc,
                                     jnp.asarray(pos), **kw)
        got, tc = t_attn.mla_decode(tp, _t(x[:, t:t + 1]), tc,
                                    torch.from_numpy(pos), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(),
                                   atol=ATOL, rtol=RTOL)
    for a, w in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=RTOL)


def test_prefill_kv_cache_matches():
    rng = np.random.default_rng(9)
    k = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    pos = np.arange(3, 8, dtype=np.int32)
    want = j_attn.prefill_kv_cache(j_attn.init_kv_cache(2, 9, 2, 8),
                                   jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pos))
    got = t_attn.prefill_kv_cache(
        t_attn.init_kv_cache(2, 9, 2, 8, device="cpu"), _t(k), _t(v),
        torch.from_numpy(pos))
    for a, w in zip(got, want):
        assert a.dtype == (torch.int32 if a is got.pos else torch.bfloat16)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(w, np.float32))


# ---------------------------------------------------------------------- MoE
def _moe_params(seed, d=64, ff=32, e=8, k=2, n_shared=0):
    jp = j_moe.init_moe(jax.random.PRNGKey(seed), d, ff, e, k, n_shared,
                        None)
    return jp, params_from_jax(jp, device="cpu")


def _ref_dispatch(jp, tokens, e, k, cf):
    """The reference's dispatch (``nn/moe.py``'s ``_moe_tokens``), restated
    in jnp up to ``dst``: (idx, order, counts, keep, dst)."""
    n_tok = tokens.shape[0]
    probs = jax.nn.softmax(tokens @ jp["router"], axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    cap = max(1, int(cf * n_tok * k / e))
    flat_e = idx.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jax.ops.segment_sum(jnp.ones_like(flat_e), flat_e,
                                 num_segments=e)
    starts = jnp.cumsum(counts) - counts
    pos_in_e = jnp.arange(flat_e.size) - starts[sorted_e]
    keep = pos_in_e < cap
    dst = jnp.where(keep, sorted_e * cap + pos_in_e, e * cap)
    return [np.asarray(a) for a in (idx, order, counts, keep, dst)]


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_dispatch_exact(cf):
    """Top-k indices, slot order, counts, keep and dst equal the
    reference's, on a router with exact ties (experts 3 and 5 share one
    weight column, large enough to lead for about half the tokens) and at
    capacities that drop slots (more at 0.5)."""
    e, k = 8, 2
    jp, tp = _moe_params(1, e=e, k=k)
    router = np.asarray(jp["router"]).copy()
    router[:, 3] = router[:, 5] = 3.0 * router[:, 0]
    jp = dict(jp, router=jnp.asarray(router))
    tokens = np.random.default_rng(1).standard_normal((96, 64)).astype(
        np.float32)
    idx, order, counts, keep, dst = _ref_dispatch(jp, jnp.asarray(tokens), e,
                                                  k, cf)
    probs = torch.softmax(_t(tokens) @ _t(router), dim=-1)
    _, t_idx = t_moe.router_top_k(probs, k)
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    cap = max(1, int(cf * 96 * k / e))
    got = t_moe.dispatch(t_idx.reshape(-1), e, cap)
    for g, w in zip(got, (order, counts, keep, dst)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (idx == [3, 5]).all(axis=1).sum() > 20  # the tie decided
    assert not keep.all()


def test_router_top_k_breaks_ties_by_index():
    """``lax.top_k``'s rule: among equal values the lower index first."""
    rng = np.random.default_rng(2)
    probs = rng.integers(0, 3, (200, 16)).astype(np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(probs), 5)
    t_vals, t_idx = t_moe.router_top_k(torch.from_numpy(probs), 5)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(vals))


@pytest.mark.parametrize("cf,grouped,n_shared", [
    (1.25, False, 0), (0.5, False, 0), (1.25, True, 0), (1.25, False, 2),
    (0.5, True, 2)])
def test_moe_ffn_matches_reference(cf, grouped, n_shared):
    e, k = 8, 2
    jp, tp = _moe_params(2, e=e, k=k, n_shared=n_shared)
    x = np.random.default_rng(2).standard_normal((3, 40, 64)).astype(
        np.float32)
    kw = dict(n_experts=e, top_k=k, capacity_factor=cf, grouped=grouped)
    want, jaux = j_moe.moe_ffn(jp, jnp.asarray(x), **kw)
    got, aux = t_moe.moe_ffn(tp, _t(x), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n_shared", [0, 2])
def test_moe_ffn_against_dense_oracle(n_shared):
    """With room for every slot the dispatch is the dense oracle's
    function; the port's oracle is the reference's; and at capacity 0.5
    the dispatch drops slots, so it is not."""
    e, k = 8, 2
    jp, tp = _moe_params(3, e=e, k=k, n_shared=n_shared)
    x = np.random.default_rng(3).standard_normal((2, 32, 64)).astype(
        np.float32)
    dense = t_moe.moe_ffn_ref_dense(tp, _t(x), n_experts=e, top_k=k)
    np.testing.assert_allclose(
        dense.numpy(), np.asarray(j_moe.moe_ffn_ref_dense(
            jp, jnp.asarray(x), n_experts=e, top_k=k)), atol=ATOL, rtol=RTOL)
    roomy, _ = t_moe.moe_ffn(tp, _t(x), n_experts=e, top_k=k,
                             capacity_factor=float(e))
    np.testing.assert_allclose(roomy.numpy(), dense.numpy(), atol=ATOL,
                               rtol=RTOL)
    tight, _ = t_moe.moe_ffn(tp, _t(x), n_experts=e, top_k=k,
                             capacity_factor=0.5)
    assert not np.allclose(tight.numpy(), dense.numpy(), atol=1e-3)


def test_moe_combine_is_the_reference_scatter_order_in_bf16():
    """The combine adds each token's contributions one at a time in slot
    order in bf16, as the reference's ``.at[src_tok].add`` does: bitwise
    a sequential scatter-add over the sorted slots, and a repeat bitwise."""
    e, k = 8, 3
    _, tp = _moe_params(4, e=e, k=k)
    tp = jax.tree.map(lambda a: a.to(torch.bfloat16), tp)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (50, 64)).astype(np.float32)).to(torch.bfloat16)
    got, _ = t_moe._moe_tokens(tp, x, n_experts=e, top_k=k,
                               capacity_factor=1.0)
    again, _ = t_moe._moe_tokens(tp, x, n_experts=e, top_k=k,
                                 capacity_factor=1.0)
    assert torch.equal(got, again)
    # the same dispatch, combined slot by slot
    probs = torch.softmax(x.float() @ tp["router"].float(), dim=-1)
    gates, idx = t_moe.router_top_k(probs, k)
    gates = (gates / gates.sum(-1, keepdim=True)).reshape(-1).to(x.dtype)
    cap = max(1, int(1.0 * 50 * k / e))
    order, _, keep, dst = t_moe.dispatch(idx.reshape(-1), e, cap)
    we = tp["experts"]
    want = torch.zeros_like(x)
    for j in range(order.numel()):
        s = int(order[j])
        if not keep[j]:
            continue
        ex, tok = int(idx.reshape(-1)[s]), s // k
        h = torch.nn.functional.silu(x[tok] @ we["w_gate"][ex]) * (
            x[tok] @ we["w_up"][ex])
        want[tok] = want[tok] + (h @ we["w_down"][ex]) * gates[s]
    assert torch.equal(got, want)


# -------------------------------------------------------------------- serve
@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-11b"])
def test_serve_main_on_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = t_serve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                            "--prompt-len", "4", "--gen", "5"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith(f"{arch}-smoke: cache footprint")
    assert lines[1].startswith("decoded 18 tokens in")
    assert res["tokens"] == 18
    assert tuple(res["generated"].shape) == (2, 5)
    cfg, jcfg = get_arch(arch).reduced(), j_get_arch(arch).reduced()
    n_enc = cfg.n_audio_frames if cfg.has_encoder else cfg.n_image_tokens
    assert res["cache_bytes"] == j_cache_bytes(j_model.init_cache(
        jcfg, 2, 9, enc_out=jnp.zeros((2, n_enc, cfg.d_model),
                                      jnp.bfloat16)))
    # on the CPU the plain attention runs: no kernel launch
    assert res["attention_launches"] == res["encoder_launches"] == 0
    assert int(res["generated"].max()) < cfg.vocab
