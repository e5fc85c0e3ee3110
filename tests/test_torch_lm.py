"""Port LM stack (gemma3, dense GQA/SWA blocks) vs the JAX package.

The reduced gemma3-12b (2 layers: SWA then global, d_model 256, 4 heads
of 64, window 64) and a variant with 2 KV heads (so GQA groups of 2) at
S = 192 > 2 x window, so the sliding band bites.  Weights come from the
reference's ``init_arch`` through ``params_from_jax``; tokens from numpy.
On the CPU every self-attention runs the SWA kernel's plain version.

Tolerances: building blocks atol = rtol = 1e-5 in f32; ``forward`` and
``decode_step`` at f32 within 1e-4 of the largest |logit| (and rtol
1e-4); ``forward`` at bf16 within relative L2 0.1 of the reference's bf16
forward (DESIGN.md §9.3's bf16 bound); the decode-vs-forward property at
the reference's own atol 0.08 on the last position's softmax.
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
from repro.configs import ALIASES as J_ALIASES
from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.launch.serve import cache_bytes as j_cache_bytes
from repro.nn import attention as j_attn
from repro.nn import basic as j_basic
from repro.nn import virtual_tokens as j_vt
from repro_torch.archs import model as t_model
from repro_torch.configs import ALIASES, INPUT_SHAPES, get_arch
from repro_torch.launch import serve as t_serve
from repro_torch.nn import attention as t_attn
from repro_torch.nn import basic as t_basic
from repro_torch.nn import moe as t_moe
from repro_torch.nn import ssm as t_ssm
from repro_torch.nn import xlstm as t_xlstm
from repro_torch.nn import virtual_tokens as t_vt
from repro_torch.weights import params_from_jax

ATOL, RTOL = 1e-5, 1e-4
S_LONG = 192


def _cfgs(kv=None):
    cfgs = [get_arch("gemma3_12b").reduced(),
            j_get_arch("gemma3_12b").reduced()]
    if kv is not None:
        cfgs = [dataclasses.replace(c, n_kv_heads=kv) for c in cfgs]
    return cfgs


@pytest.fixture(scope="module", params=[None, 2], ids=["kv4", "kv2"])
def model(request):
    """(port cfg, reference cfg, reference params, port params)."""
    cfg, jcfg = _cfgs(request.param)
    jp = j_model.init_arch(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, jp, tp


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close_to_max(got, want, tol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("aid", ["gemma3_12b", "gemma3_27b", "gemma3-12b",
                                 "olmoe_1b_7b", "deepseek_v2_lite_16b",
                                 "granite_20b", "llama3_405b", "whisper_small",
                                 "llama_3_2_vision_11b", "xlstm_125m",
                                 "xlstm-125m", "zamba2_1_2b", "zamba2-1.2b"])
def test_configs_match_reference(aid):
    cfg, jcfg = get_arch(aid), j_get_arch(aid)
    for a, b in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced()),
                 (cfg.long_context_variant(), jcfg.long_context_variant())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert ALIASES == J_ALIASES
    assert INPUT_SHAPES == {k: tuple(v) for k, v in J_SHAPES.items()}


def test_unknown_block_kind_raises():
    """An unknown block kind raises ``ValueError(kind)`` at ``init_arch``,
    as the reference's ``_init_layer`` does."""
    cfg = dataclasses.replace(get_arch("gemma3_12b").reduced(),
                              blocks=("attn", "conv"))
    jcfg = dataclasses.replace(j_get_arch("gemma3_12b").reduced(),
                               blocks=("attn", "conv"))
    with pytest.raises(ValueError, match="conv"):
        j_model.init_arch(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(ValueError, match="conv"):
        t_model.init_arch(torch.Generator().manual_seed(0), cfg, device="cpu")


# ----------------------------------------------------------- building blocks
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = 0.1 * rng.standard_normal(64).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_basic.rmsnorm({"scale": jnp.asarray(scale, jdt)},
                           jnp.asarray(x, jdt))
    got = t_basic.rmsnorm({"scale": _t(scale).to(tdt)}, _t(x).to(tdt))
    assert got.dtype == tdt
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == "float32" else dict(
        atol=0, rtol=0)  # one f32 computation, one rounding
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_apply_rope_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 4, 64)).astype(np.float32)
    pos = np.arange(100, 140, dtype=np.int32)
    want = j_basic.apply_rope(jnp.asarray(x), jnp.asarray(pos)[None], 1e6)
    got = t_basic.apply_rope(_t(x), torch.from_numpy(pos)[None], 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("kind", ["geglu", "swiglu"])
def test_gated_ffns_match(kind):
    """GeGLU is the trap: jax.nn.gelu is the tanh form by default."""
    jp = getattr(j_basic, f"init_{kind}")(jax.random.PRNGKey(2), 32, 64)
    x = 2.0 * np.random.default_rng(2).standard_normal((3, 7, 32)).astype(
        np.float32)
    want = getattr(j_basic, kind)(jp, jnp.asarray(x))
    got = getattr(t_basic, kind)(params_from_jax(jp, device="cpu"), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_gqa_forward_matches(model, window, use_kernel):
    cfg, _, jp, tp = model
    x = np.random.default_rng(3).standard_normal(
        (2, S_LONG, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
              window=window, rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk)
    pos = np.arange(S_LONG)
    want = j_attn.gqa_forward(jp["layers"][0]["attn"], jnp.asarray(x),
                              jnp.asarray(pos), **kw)
    got = t_attn.gqa_forward(tp["layers"][0]["attn"], _t(x),
                             torch.from_numpy(pos), use_kernel=use_kernel,
                             **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=RTOL)


def test_gqa_forward_positions(model):
    """Shifted positions: the plain path masks by them, as the reference
    does; the kernel path (which masks by index) refuses them."""
    cfg, _, jp, tp = model
    x = np.random.default_rng(4).standard_normal(
        (1, 80, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
              window=cfg.window, rope_theta=cfg.rope_theta)
    pos = 7 + 2 * np.arange(80)
    want = j_attn.gqa_forward(jp["layers"][0]["attn"], jnp.asarray(x),
                              jnp.asarray(pos), **kw)
    got = t_attn.gqa_forward(tp["layers"][0]["attn"], _t(x),
                             torch.from_numpy(pos), use_kernel=False, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=RTOL)
    with pytest.raises(ValueError, match="masks by index"):
        t_attn.gqa_forward(tp["layers"][0]["attn"], _t(x),
                           torch.from_numpy(pos), **kw)
    same = t_attn.gqa_forward(tp["layers"][0]["attn"], _t(x), None, **kw)
    torch.testing.assert_close(same, t_attn.gqa_forward(
        tp["layers"][0]["attn"], _t(x), torch.arange(80), **kw))


_CFG = get_arch("gemma3_12b").reduced()
_GEN = torch.Generator
_INITS = {
    "randn": lambda: t_basic.randn(_GEN(), (2, 3)),
    "dense_init": lambda: t_basic.dense_init(_GEN(), 4, 8),
    "init_rmsnorm": lambda: t_basic.init_rmsnorm(8),
    "rope_freqs": lambda: t_basic.rope_freqs(8),
    "init_geglu": lambda: t_basic.init_geglu(_GEN(), 4, 8),
    "init_swiglu": lambda: t_basic.init_swiglu(_GEN(), 4, 8),
    "init_gqa": lambda: t_attn.init_gqa(_GEN(), 8, 2, 1, 4),
    "init_kv_cache": lambda: t_attn.init_kv_cache(1, 4, 1, 4),
    "init_mla": lambda: t_attn.init_mla(_GEN(), 8, 2, kv_lora=4, d_nope=4,
                                        d_rope=2, d_v=4),
    "init_mla_cache": lambda: t_attn.init_mla_cache(1, 4, 4, 2),
    "init_moe": lambda: t_moe.init_moe(_GEN(), 8, 4, 4, 2, 1),
    "init_mamba2": lambda: t_ssm.init_mamba2(_GEN(), t_ssm.mamba2_dims(8, 4,
                                                                       4)),
    "init_mamba2_cache": lambda: t_ssm.init_mamba2_cache(
        1, t_ssm.mamba2_dims(8, 4, 4)),
    "init_mlstm": lambda: t_xlstm.init_mlstm(_GEN(), t_xlstm.xlstm_dims(8, 2)),
    "init_mlstm_state": lambda: t_xlstm.init_mlstm_state(
        1, t_xlstm.xlstm_dims(8, 2)),
    "init_slstm": lambda: t_xlstm.init_slstm(_GEN(), t_xlstm.xlstm_dims(8, 2)),
    "init_slstm_state": lambda: t_xlstm.init_slstm_state(1, 8),
    "init_virtual_tokens": lambda: t_vt.init_virtual_tokens(_GEN(), 2, 8, 4),
    "init_arch": lambda: t_model.init_arch(_GEN(), _CFG),
    "init_cache": lambda: t_model.init_cache(_CFG, 1, 4),
}


@pytest.mark.parametrize("name", sorted(_INITS))
def test_lm_inits_default_to_cuda(name, monkeypatch):
    """With no ``device`` every init asks for the card, and so raises
    where there is none, as the FastEGNN inits do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        _INITS[name]()


def test_gqa_cross_attention_is_not_ported(model):
    """Cross-attention, once refused here, is ported: over encoder states
    of their own length (T = 24 against S = 40 queries; no RoPE, not
    causal) it matches the reference's ``gqa_forward(..., cross_kv=)``,
    through the kernel's plain version and the plain attention alike."""
    cfg, _, jp, tp = model
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
              q_chunk=cfg.q_chunk)
    want = j_attn.gqa_forward(jp["layers"][0]["attn"], jnp.asarray(x),
                              jnp.arange(40), cross_kv=jnp.asarray(enc), **kw)
    for use_kernel in (True, False):
        got = t_attn.gqa_forward(tp["layers"][0]["attn"], _t(x), None,
                                 cross_kv=_t(enc), use_kernel=use_kernel,
                                 **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=RTOL)


def test_virtual_token_layer_matches(model):
    cfg, _, jp, tp = model
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 50, cfg.d_model)).astype(np.float32)
    vt = rng.standard_normal((2, cfg.n_virtual_tokens,
                              cfg.d_virtual)).astype(np.float32)
    mask = (rng.uniform(size=(2, 50)) > 0.2).astype(np.float32)
    for m in (None, mask):
        want = j_vt.virtual_token_layer(
            jp["vt"][1], jnp.asarray(x), jnp.asarray(vt),
            None if m is None else jnp.asarray(m))
        got = t_vt.virtual_token_layer(tp["vt"][1], _t(x), _t(vt),
                                       None if m is None else _t(m))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=RTOL)


def test_init_arch_shapes_match_reference():
    cfg, jcfg = _cfgs()
    jp = j_model.init_arch(jax.random.PRNGKey(0), jcfg)
    tp = t_model.init_arch(torch.Generator().manual_seed(0), cfg,
                           device="cpu", dtype=torch.bfloat16)
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert tdef == jdef
    assert [tuple(t.shape) for t in tl] == [tuple(a.shape) for a in jl]
    assert all(t.dtype == torch.bfloat16 for t in tl)


# ------------------------------------------------------------------- forward
def test_forward_f32_matches(model):
    cfg, jcfg, jp, tp = model
    tok = _tokens(cfg, 2, S_LONG)
    want, _ = j_model.forward(jp, jcfg, jnp.asarray(tok), dtype=jnp.float32)
    with torch.no_grad():
        got, aux = t_model.forward(tp, cfg, torch.from_numpy(tok),
                                   dtype=torch.float32)
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close_to_max(got.numpy(), want)


def test_forward_bf16_close(model):
    cfg, jcfg, jp, tp = model
    tok = _tokens(cfg, 2, S_LONG, seed=1)
    want, _ = j_model.forward(jp, jcfg, jnp.asarray(tok))
    with torch.no_grad():
        got, _ = t_model.forward(tp, cfg, torch.from_numpy(tok))
    want = np.asarray(want)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < 0.1, rel


def test_forward_hidden_and_head(model):
    cfg, _, _, tp = model
    tok = torch.from_numpy(_tokens(cfg, 1, 20))
    with torch.no_grad():
        logits, _ = t_model.forward(tp, cfg, tok, dtype=torch.float32)
        hidden, _ = t_model.forward(tp, cfg, tok, dtype=torch.float32,
                                    return_hidden=True)
    head = t_model.lm_head_weights(tp, cfg, torch.float32)
    np.testing.assert_allclose((hidden @ head).numpy(), logits.numpy(),
                               atol=ATOL, rtol=RTOL)


# -------------------------------------------------------------------- decode
def test_decode_matches_reference_past_window(model):
    """Teacher-forced decode for 80 > window 64 steps: the SWA ring wraps."""
    cfg, jcfg, jp, tp = model
    b, steps = 2, 80
    tok = _tokens(cfg, b, steps, seed=2)
    jstep = jax.jit(lambda p, c, t, pos: j_model.decode_step(
        p, jcfg, c, t, pos, dtype=jnp.float32))
    jc = j_model.init_cache(jcfg, b, steps, dtype=jnp.float32)
    tc = t_model.init_cache(cfg, b, steps, dtype=torch.float32, device="cpu")
    assert tc.layers[0]["kv"].k.shape[1] == cfg.window < steps
    with torch.no_grad():
        for t in range(steps):
            want, jc = jstep(jp, jc, jnp.asarray(tok[:, t]),
                             jnp.full((b,), t, jnp.int32))
            got, tc = t_model.decode_step(
                tp, cfg, tc, torch.from_numpy(tok[:, t]),
                torch.full((b,), t, dtype=torch.int32), dtype=torch.float32)
            _close_to_max(got.numpy(), want)
    np.testing.assert_array_equal(tc.layers[0]["kv"].pos.numpy(),
                                  np.asarray(jc.layers[0]["kv"].pos))


@pytest.mark.parametrize("aid,b,cap", [("gemma3_12b", 2, 80),
                                       ("gemma3_12b", 4, 48),
                                       ("gemma3_27b", 1, 2048)])
@pytest.mark.parametrize("full", [False, True])
def test_cache_bytes_match_reference(aid, b, cap, full):
    cfg, jcfg = get_arch(aid), j_get_arch(aid)
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got = t_serve.cache_bytes(t_model.init_cache(cfg, b, cap, device="cpu"))
    assert got == j_cache_bytes(j_model.init_cache(jcfg, b, cap))


def test_decode_matches_forward():
    """The reference's decode-vs-forward property, port against port:
    teacher-forced f32 decode against the bf16 forward."""
    cfg = get_arch("gemma3_12b").reduced()
    b, s = 2, 32
    params = t_model.init_arch(torch.Generator().manual_seed(0), cfg,
                               device="cpu")
    tok = torch.from_numpy(_tokens(cfg, b, s, seed=3))
    with torch.no_grad():
        logits, _ = t_model.forward(params, cfg, tok)
        cache = t_model.init_cache(cfg, b, s, dtype=torch.float32,
                                   device="cpu")
        for t in range(s):
            lg, cache = t_model.decode_step(
                params, cfg, cache, tok[:, t],
                torch.full((b,), t, dtype=torch.int32), dtype=torch.float32)
    np.testing.assert_allclose(torch.softmax(lg, -1).numpy(),
                               torch.softmax(logits[:, -1], -1).numpy(),
                               atol=0.08)


def test_serve_main_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = t_serve.main(["--arch", "gemma3-12b", "--device", "cpu",
                            "--batch", "2", "--prompt-len", "5", "--gen",
                            "6"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("gemma3-12b-smoke: cache footprint")
    assert lines[1].startswith("decoded 22 tokens in")
    assert lines[2].startswith("sample: [")
    assert res["tokens"] == 22
    assert tuple(res["prompt"].shape) == (2, 5)
    assert tuple(res["generated"].shape) == (2, 6)
    cfg = get_arch("gemma3-12b").reduced()
    assert res["cache_bytes"] == j_cache_bytes(
        j_model.init_cache(j_get_arch("gemma3-12b").reduced(), 2, 11))
    assert int(res["generated"].max()) < cfg.vocab
    # the served sequence replayed through decode_step: finite logits at
    # every step, and each generated token the argmax of the step before
    params = t_model.init_arch(torch.Generator().manual_seed(0), cfg,
                               device="cpu", dtype=torch.bfloat16)
    seq = torch.cat([res["prompt"], res["generated"]], dim=1)
    cache = t_model.init_cache(cfg, 2, 11, device="cpu")
    with torch.no_grad():
        for t in range(10):
            logits, cache = t_model.decode_step(
                params, cfg, cache, seq[:, t],
                torch.full((2,), t, dtype=torch.int32))
            assert torch.isfinite(logits).all()
            if t >= 4:
                assert torch.equal(torch.argmax(logits, dim=-1), seq[:, t + 1])
