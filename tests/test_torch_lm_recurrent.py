"""The LM stack's recurrent family in the port vs the JAX package.

xlstm-125m (mLSTM, then sLSTM) and zamba2-1.2b (Mamba2, then the shared
attention block) at their ``reduced()`` widths: 2 layers, d_model 256, 4
heads of 64, vocab 512; Mamba2 d_state 16, head_dim 32 (16 heads),
``ssd_chunk`` 16; mLSTM 4 heads of 128.  Weights come from the reference's
initialisers (``init_arch``, ``init_mamba2``, ``init_mlstm``, ...) through
``params_from_jax``; tokens and inputs from numpy seeds.  On the CPU the shared block's attention runs the attention
kernel's plain version.  The reference runs under ``jax.jit`` (its eager
ops cost more than the compile).

Tolerances: the modules (``mamba2_forward`` at S = 32 and at a ragged
S = 24, which takes the single-chunk rule; ``mamba2_decode``, mLSTM and
sLSTM forward and decode) atol 1e-5 / rtol 1e-4 in f32; chunk invariance
and decode against forward, port against port, at 1e-4 (the reference's
own tests' limits); ``forward`` and ``decode_step`` at f32 within 1e-4 of
the largest |logit| (and rtol 1e-4); ``forward`` at bf16 within relative
L2 0.1 of the reference's bf16 forward (DESIGN.md §9.3's bf16 bound);
cache footprints exactly.
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
from repro.nn import ssm as j_ssm
from repro.nn import xlstm as j_xlstm
from repro_torch.archs import model as t_model
from repro_torch.configs import get_arch
from repro_torch.launch import serve as t_serve
from repro_torch.nn import ssm as t_ssm
from repro_torch.nn import xlstm as t_xlstm
from repro_torch.weights import params_from_jax

ATOL, RTOL = 1e-5, 1e-4
RECURRENT = ["xlstm_125m", "zamba2_1_2b"]
B, S, STEPS = 2, 32, 8
# zamba2 at full depth: its f32 decode turns non-finite within this many
# steps with the reference's random weights (the virtual-token state)
DEEP_STEPS = 24


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: the recurrences' small ops run far slower on
    torch's threads when parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _close_to_max(got, want, tol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module", params=RECURRENT)
def model(request):
    """(port cfg, reference cfg, reference params, port params)."""
    cfg, jcfg = get_arch(request.param).reduced(), \
        j_get_arch(request.param).reduced()
    jp = jax.jit(lambda k: j_model.init_arch(k, jcfg))(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, jp, tp


def _port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


@pytest.fixture(scope="module")
def mamba():
    """(reference params, port params, dims, cfg) of one Mamba2 mixer at
    the reduced zamba2's widths."""
    cfg = j_get_arch("zamba2_1_2b").reduced()
    dims = j_ssm.mamba2_dims(cfg.d_model, d_state=cfg.ssm.d_state,
                             head_dim=cfg.ssm.head_dim, expand=cfg.ssm.expand)
    jp = j_ssm.init_mamba2(jax.random.PRNGKey(3), dims)
    return jp, _port(jp), dims, cfg


@pytest.fixture(scope="module")
def xlstm():
    """({"first": mLSTM, "slstm": sLSTM} reference params, the port's,
    dims, cfg) at the reduced xlstm's widths."""
    cfg = j_get_arch("xlstm_125m").reduced()
    dims = j_xlstm.xlstm_dims(cfg.d_model, cfg.n_heads)
    jtree = {"first": j_xlstm.init_mlstm(jax.random.PRNGKey(3), dims),
             "slstm": j_xlstm.init_slstm(jax.random.PRNGKey(4), dims)}
    return jtree, _port(jtree), dims, cfg


# ------------------------------------------------------------------ configs
def test_configs_and_dims():
    """Both configs' SSM specs, chunk and derived widths as the
    reference's, at full size and reduced; the port's dims tuples equal
    the reference's."""
    for aid in RECURRENT:
        for cfg, jcfg in ((get_arch(aid), j_get_arch(aid)),
                          (get_arch(aid).reduced(),
                           j_get_arch(aid).reduced())):
            assert dataclasses.asdict(cfg.ssm) == dataclasses.asdict(jcfg.ssm)
            assert cfg.ssd_chunk == jcfg.ssd_chunk
            assert cfg.sub_quadratic() == jcfg.sub_quadratic()
            assert tuple(t_model._mamba_dims(cfg)) == tuple(
                j_model._mamba_dims(jcfg))
            assert tuple(t_model._xlstm_dims(cfg)) == tuple(
                j_model._xlstm_dims(jcfg))
    z = get_arch("zamba2-1.2b")
    assert (z.n_layers, z.d_model, z.ssm.d_state, z.ssm.head_dim) == \
        (38, 2048, 64, 64)
    assert [i for i, k in enumerate(z.blocks) if k == "shared_attn"] == \
        [5, 11, 17, 23, 29, 35]
    x = get_arch("xlstm-125m")
    assert [i for i, k in enumerate(x.blocks) if k == "slstm"] == [1, 4, 7, 10]
    assert t_model._xlstm_dims(x).head_dim == 384


def test_softplus_matches_jax():
    """The port's softplus is exact past F.softplus's threshold of 20."""
    x = np.concatenate([np.linspace(-60, 60, 241), [1e-3, 19.9, 20.1, 88.0]]
                       ).astype(np.float32)
    _close(t_ssm.softplus(_t(x)).numpy(), jax.nn.softplus(jnp.asarray(x)),
           atol=0, rtol=1e-6)
    assert float(t_ssm.softplus(torch.tensor(-30.0))) > 0


# ------------------------------------------------------------------- Mamba2
@pytest.mark.parametrize("s", [32, 24], ids=["chunked", "ragged"])
def test_mamba2_forward_matches(mamba, s):
    jp, tp, dims, cfg = mamba
    x = _x((B, s, cfg.d_model), 1)
    want = jax.jit(lambda p, x: j_ssm.mamba2_forward(
        p, x, dims, cfg.ssd_chunk))(jp, jnp.asarray(x))
    got = t_ssm.mamba2_forward(tp, _t(x), t_ssm.Mamba2Dims(*dims),
                               cfg.ssd_chunk)
    _close(got.numpy(), want)


def test_ssd_chunked_state_matches(mamba):
    """The SSD core alone: y and the final state, 3 chunks from a non-zero
    initial state."""
    jp, tp, dims, cfg = mamba
    rng = np.random.default_rng(4)
    s, nh, p, n = 48, dims.n_heads, dims.head_dim, dims.d_state
    xh = rng.standard_normal((B, s, nh, p)).astype(np.float32)
    bm, cm = (rng.standard_normal((B, s, n)).astype(np.float32)
              for _ in range(2))
    dt = np.abs(rng.standard_normal((B, s, nh))).astype(np.float32) * 0.3
    a = -np.exp(np.asarray(jp["a_log"]))
    h0 = rng.standard_normal((B, nh, p, n)).astype(np.float32)
    want = jax.jit(lambda *a: j_ssm._ssd_chunked(*a, chunk=16))(
        *map(jnp.asarray, (xh, bm, cm, dt, a, h0)))
    got = t_ssm._ssd_chunked(*map(_t, (xh, bm, cm, dt, a, h0)), chunk=16)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_mamba2_chunk_invariance(mamba, chunk):
    """The reference's chunk-invariance property, port against port."""
    _, tp, dims, cfg = mamba
    x = _t(_x((B, 32, cfg.d_model), 2))
    dims = t_ssm.Mamba2Dims(*dims)
    _close(t_ssm.mamba2_forward(tp, x, dims, chunk=chunk).numpy(),
           t_ssm.mamba2_forward(tp, x, dims, chunk=32).numpy(),
           atol=1e-4, rtol=1e-4)


def test_mamba2_decode_matches(mamba):
    """Six decode steps from an empty f32 cache against the reference's:
    outputs and both cache tensors."""
    jp, tp, dims, cfg = mamba
    x = _x((B, 6, cfg.d_model), 5)
    jc = j_ssm.init_mamba2_cache(B, dims)
    tdims = t_ssm.Mamba2Dims(*dims)
    tc = t_ssm.init_mamba2_cache(B, tdims, device="cpu")
    jstep = jax.jit(lambda p, x, c: j_ssm.mamba2_decode(p, x, c, dims))
    for t in range(6):
        want, jc = jstep(jp, jnp.asarray(x[:, t:t + 1]), jc)
        got, tc = t_ssm.mamba2_decode(tp, _t(x[:, t:t + 1]), tc, tdims)
        _close(got.numpy(), want)
    _close(tc.h.numpy(), jc.h)
    _close(tc.conv.numpy(), jc.conv)


def test_mamba2_decode_bf16_keeps_f32_cache(mamba):
    """A bf16 step over the f32 cache: the window and state promote to
    f32 as JAX's do (the cache stays f32), the output is bf16 and within
    bf16 rounding of the reference's."""
    jp, tp, dims, cfg = mamba
    x = _x((B, 3, cfg.d_model), 6)
    bf = lambda tree: jax.tree.map(lambda a: a.astype(jnp.bfloat16), tree)
    jc = j_ssm.init_mamba2_cache(B, dims)
    tdims = t_ssm.Mamba2Dims(*dims)
    tc = t_ssm.init_mamba2_cache(B, tdims, device="cpu")
    tpb = t_model.cast_params(tp, torch.bfloat16)
    jstep = jax.jit(lambda p, x, c: j_ssm.mamba2_decode(p, x, c, dims))
    for t in range(3):
        want, jc = jstep(bf(jp), jnp.asarray(x[:, t:t + 1]).astype(
            jnp.bfloat16), jc)
        got, tc = t_ssm.mamba2_decode(tpb, _t(x[:, t:t + 1]).to(
            torch.bfloat16), tc, tdims)
    assert got.dtype == torch.bfloat16
    assert tc.h.dtype == tc.conv.dtype == torch.float32
    assert jc.h.dtype == jc.conv.dtype == jnp.float32
    _close(tc.conv.numpy(), np.asarray(jc.conv), atol=1e-2, rtol=1e-2)
    _close(got.float().numpy(), np.asarray(want, np.float32), atol=5e-2,
           rtol=5e-2)


def test_mamba2_decode_matches_forward(mamba):
    """The reference's decode-vs-forward property, port against port."""
    _, tp, dims, cfg = mamba
    dims = t_ssm.Mamba2Dims(*dims)
    x = _t(_x((B, 24, cfg.d_model), 7))
    y = t_ssm.mamba2_forward(tp, x, dims, chunk=8)
    cache = t_ssm.init_mamba2_cache(B, dims, device="cpu")
    outs = []
    for t in range(24):
        yt, cache = t_ssm.mamba2_decode(tp, x[:, t:t + 1], cache, dims)
        outs.append(yt)
    _close(torch.cat(outs, 1).numpy(), y.numpy(), atol=1e-4, rtol=1e-4)


# ----------------------------------------------------------------- xLSTM
def test_mlstm_forward_and_decode_match(xlstm):
    jtree, ttree, dims, cfg = xlstm
    jp, tp = jtree["first"], ttree["first"]
    tdims = t_xlstm.XLSTMDims(*dims)
    x = _x((B, 16, cfg.d_model), 8)
    _close(t_xlstm.mlstm_forward(tp, _t(x), tdims).numpy(),
           jax.jit(lambda p, x: j_xlstm.mlstm_forward(p, x, dims))(
               jp, jnp.asarray(x)))
    js = j_xlstm.init_mlstm_state(B, dims)
    ts = t_xlstm.init_mlstm_state(B, tdims, device="cpu")
    jstep = jax.jit(lambda p, x, s: j_xlstm.mlstm_decode(p, x, s, dims))
    for t in range(4):
        want, js = jstep(jp, jnp.asarray(x[:, t:t + 1]), js)
        got, ts = t_xlstm.mlstm_decode(tp, _t(x[:, t:t + 1]), ts, tdims)
        _close(got.numpy(), want)
    for g, w in zip(ts, js):
        _close(g.numpy(), w)


def test_slstm_forward_and_decode_match(xlstm):
    jtree, ttree, dims, cfg = xlstm
    jp, tp = jtree["slstm"], ttree["slstm"]
    assert tuple(tp["ff_up"].shape) == (cfg.d_model, int(4 * cfg.d_model / 3))
    x = _x((B, 16, cfg.d_model), 9)
    _close(t_xlstm.slstm_forward(tp, _t(x)).numpy(),
           jax.jit(j_xlstm.slstm_forward)(jp, jnp.asarray(x)))
    js = j_xlstm.init_slstm_state(B, cfg.d_model)
    ts = t_xlstm.init_slstm_state(B, cfg.d_model, device="cpu")
    jstep = jax.jit(j_xlstm.slstm_decode)
    for t in range(4):
        want, js = jstep(jp, jnp.asarray(x[:, t:t + 1]), js)
        got, ts = t_xlstm.slstm_decode(tp, _t(x[:, t:t + 1]), ts)
        _close(got.numpy(), want)
    for g, w in zip(ts, js):
        _close(g.numpy(), w)


def test_xlstm_decode_matches_forward(xlstm):
    """The reference's decode-vs-forward property, port against port, for
    both cells."""
    _, ttree, dims, cfg = xlstm
    tdims = t_xlstm.XLSTMDims(*dims)
    x = _t(_x((B, 16, cfg.d_model), 10))
    for fwd, dec, state in (
            (lambda: t_xlstm.mlstm_forward(ttree["first"], x, tdims),
             lambda xt, s: t_xlstm.mlstm_decode(ttree["first"], xt, s, tdims),
             t_xlstm.init_mlstm_state(B, tdims, device="cpu")),
            (lambda: t_xlstm.slstm_forward(ttree["slstm"], x),
             lambda xt, s: t_xlstm.slstm_decode(ttree["slstm"], xt, s),
             t_xlstm.init_slstm_state(B, cfg.d_model, device="cpu"))):
        outs = []
        for t in range(16):
            yt, state = dec(x[:, t:t + 1], state)
            outs.append(yt)
        _close(torch.cat(outs, 1).numpy(), fwd().numpy(), atol=1e-4,
               rtol=1e-4)


def test_bf16_stabiliser_start():
    """The forward's stabiliser starts at -1e30 rounded to the compute
    dtype, then f32, as the reference's state does."""
    dims = t_xlstm.xlstm_dims(8, 2)
    for make, jmake in ((lambda dt: t_xlstm.init_mlstm_state(
            1, dims, dt, device="cpu"), lambda dt: j_xlstm.init_mlstm_state(
            1, j_xlstm.xlstm_dims(8, 2), dt)),
            (lambda dt: t_xlstm.init_slstm_state(1, 8, dt, device="cpu"),
             lambda dt: j_xlstm.init_slstm_state(1, 8, dt))):
        got = make(torch.bfloat16).m.float().numpy()
        want = np.asarray(jmake(jnp.bfloat16).m.astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------- models
def test_init_arch_shapes_match_reference(model):
    cfg, _, jp, _ = model
    tp = t_model.init_arch(torch.Generator().manual_seed(0), cfg,
                           device="cpu", dtype=torch.bfloat16)
    jl, jdef = jax.tree.flatten(jp)
    tl, tdef = jax.tree.flatten(tp)
    assert tdef == jdef
    assert [tuple(t.shape) for t in tl] == [tuple(a.shape) for a in jl]
    assert all(t.dtype == torch.bfloat16 for t in tl)
    if "shared_attn" in cfg.blocks:
        i = cfg.blocks.index("shared_attn")
        assert tuple(tp["layers"][i]["norm1"]["scale"].shape) == \
            (2 * cfg.d_model,)
        assert tuple(tp["shared_block"]["ffn"]["w_up"].shape) == \
            (cfg.d_model, cfg.d_ff or 4 * cfg.d_model)


def test_forward_f32_matches(model):
    cfg, jcfg, jp, tp = model
    tok = np.random.default_rng(11).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    want, jaux = jax.jit(lambda p, t: j_model.forward(
        p, jcfg, t, dtype=jnp.float32))(jp, jnp.asarray(tok))
    with torch.no_grad():
        got, aux = t_model.forward(tp, cfg, torch.from_numpy(tok),
                                   dtype=torch.float32)
    assert got.dtype == torch.float32 and float(aux) == float(jaux) == 0.0
    _close_to_max(got.numpy(), want)


def test_forward_bf16_close(model):
    cfg, jcfg, jp, tp = model
    tok = np.random.default_rng(12).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    want, _ = jax.jit(lambda p, t: j_model.forward(p, jcfg, t))(
        jp, jnp.asarray(tok))
    with torch.no_grad():
        got, _ = t_model.forward(tp, cfg, torch.from_numpy(tok))
    want = np.asarray(want, np.float64)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < 0.1, rel


def test_decode_matches_reference(model):
    """Teacher-forced f32 decode, STEPS tokens, logits and the recurrent
    states against the reference's."""
    cfg, jcfg, jp, tp = model
    tok = np.random.default_rng(13).integers(0, cfg.vocab, (B, STEPS)).astype(
        np.int32)
    jstep = jax.jit(lambda p, c, t, pos: j_model.decode_step(
        p, jcfg, c, t, pos, dtype=jnp.float32))
    jc = j_model.init_cache(jcfg, B, STEPS, dtype=jnp.float32)
    tc = t_model.init_cache(cfg, B, STEPS, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for t in range(STEPS):
            want, jc = jstep(jp, jc, jnp.asarray(tok[:, t]),
                             jnp.full((B,), t, jnp.int32))
            got, tc = t_model.decode_step(
                tp, cfg, tc, torch.from_numpy(tok[:, t]),
                torch.full((B,), t, dtype=torch.int32), dtype=torch.float32)
            _close_to_max(got.numpy(), want)
    for i, kind in enumerate(cfg.blocks):
        if kind in ("mamba2", "mlstm", "slstm"):
            for g, w in zip(tc.layers[i]["ssm"], jc.layers[i]["ssm"]):
                assert g.dtype == torch.float32
                _close_to_max(g.numpy(), w)


def test_decode_bf16_cache_dtypes(model):
    """A bf16 step: KV caches and the virtual tokens in bf16, recurrent
    states in f32, as the reference's ``init_cache`` makes them."""
    cfg, _, _, tp = model
    tc = t_model.init_cache(cfg, B, 4, device="cpu")
    with torch.no_grad():
        logits, tc = t_model.decode_step(
            tp, cfg, tc, torch.zeros((B,), dtype=torch.long),
            torch.zeros((B,), dtype=torch.int32))
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    for i, kind in enumerate(cfg.blocks):
        (name, entry), = tc.layers[i].items()
        want = torch.bfloat16 if name == "kv" else torch.float32
        assert name == ("kv" if kind == "shared_attn" else "ssm")
        assert all(t.dtype == want for t in entry if t.is_floating_point())
    assert tc.vt.dtype == torch.bfloat16


@pytest.mark.parametrize("aid", RECURRENT)
@pytest.mark.parametrize("full,b,cap", [(False, 2, 48), (True, 4, 48),
                                        (True, 1, 2048)])
def test_cache_bytes_match_reference(aid, full, b, cap):
    cfg, jcfg = get_arch(aid), j_get_arch(aid)
    if not full:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got = t_serve.cache_bytes(t_model.init_cache(cfg, b, cap, device="cpu"))
    assert got == j_cache_bytes(jax.eval_shape(
        lambda: j_model.init_cache(jcfg, b, cap)))


@pytest.mark.parametrize("aid", ["xlstm-125m", "zamba2-1.2b"])
def test_serve_main_on_cpu(aid):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = t_serve.main(["--arch", aid, "--device", "cpu", "--batch", "2",
                            "--prompt-len", "5", "--gen", "6"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith(f"{aid}-smoke: cache footprint")
    assert lines[1].startswith("decoded 22 tokens in")
    assert res["tokens"] == 22 and res["attention_launches"] == 0
    assert res["first_nonfinite_step"] is None  # 2 layers: no overflow
    assert tuple(res["generated"].shape) == (2, 6)
    assert res["cache_bytes"] == j_cache_bytes(jax.eval_shape(
        lambda: j_model.init_cache(j_get_arch(aid).reduced(), 2, 11)))
    assert int(res["generated"].max()) < get_arch(aid).reduced().vocab


def test_load_npz_reads_recurrent_checkpoint(model, tmp_path):
    """A reference checkpoint of the whole model (``mixer.*``, ``in_proj``,
    ``shared_block.*``) read by ``load_npz``: the reference's tree, every
    leaf bitwise."""
    from repro.training.checkpoint import save_checkpoint
    from repro_torch.weights import load_npz

    _, _, jp, tp = model
    path = str(tmp_path / "ck.npz")
    save_checkpoint(path, jp)
    got = load_npz(path, device="cpu")
    gl, gdef = jax.tree.flatten(got)
    tl, tdef = jax.tree.flatten(tp)
    assert gdef == tdef
    assert all(torch.equal(g, t) for g, t in zip(gl, tl))


def _deep_zamba2_reference():
    """zamba2-1.2b at the reduced widths and its full 38 layers, weights
    drawn by the reference's own initialisers a layer at a time (one
    compile a block kind; ``init_arch`` under jit compiles 38 layers
    unrolled, ~90 s)."""
    from repro.nn import attention as j_attn
    from repro.nn import basic as j_basic
    from repro.nn.virtual_tokens import init_virtual_tokens

    full = j_get_arch("zamba2_1_2b")
    cfg = dataclasses.replace(full.reduced(), n_layers=full.n_layers,
                              blocks=full.blocks, ffns=full.ffns)
    layer = {k: jax.jit(lambda key, i=cfg.blocks.index(k): j_model._init_layer(
        key, cfg, i)) for k in set(cfg.blocks)}
    vt = jax.jit(lambda key: init_virtual_tokens(
        key, cfg.n_virtual_tokens, cfg.d_model, cfg.d_virtual))
    ks = jax.random.split(jax.random.PRNGKey(5), 2 * cfg.n_layers + 3)
    jp = {
        "embed": 0.02 * jax.random.normal(ks[-1], (cfg.vocab, cfg.d_model)),
        "final_norm": j_basic.init_rmsnorm(cfg.d_model),
        "layers": [layer[k](ks[i]) for i, k in enumerate(cfg.blocks)],
        "vt": [vt(ks[cfg.n_layers + i]) for i in range(cfg.n_layers)],
        "shared_block": {
            "attn": j_attn.init_gqa(ks[-2], cfg.d_model, cfg.n_heads,
                                    cfg.n_kv_heads, cfg.head_dim),
            "norm2": j_basic.init_rmsnorm(cfg.d_model),
            "ffn": j_basic.init_swiglu(ks[-3], cfg.d_model, cfg.d_ff)},
    }
    return cfg, jp


def test_deep_decode_overflows_where_the_reference_does():
    """zamba2 at its 38 layers (reduced widths), teacher-forced f32 decode:
    the first step within 1e-4 of the reference's largest logit, and the
    virtual-token state (one read added per layer and per step) growing
    with these random weights until the logits turn non-finite at the same
    step in both packages, inside DEEP_STEPS."""
    jcfg, jp = _deep_zamba2_reference()
    cfg = dataclasses.replace(get_arch("zamba2_1_2b").reduced(),
                              n_layers=jcfg.n_layers, blocks=jcfg.blocks,
                              ffns=jcfg.ffns)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    tok = np.random.default_rng(14).integers(0, cfg.vocab,
                                             (B, DEEP_STEPS)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, pos: j_model.decode_step(
        p, jcfg, c, t, pos, dtype=jnp.float32))
    jc = j_model.init_cache(jcfg, B, DEEP_STEPS, dtype=jnp.float32)
    tc = t_model.init_cache(cfg, B, DEEP_STEPS, dtype=torch.float32,
                            device="cpu")
    j_finite, t_finite = [], []
    with torch.no_grad():
        for t in range(DEEP_STEPS):
            want, jc = jstep(jp, jc, jnp.asarray(tok[:, t]),
                             jnp.full((B,), t, jnp.int32))
            got, tc = t_model.decode_step(
                tp, cfg, tc, torch.from_numpy(tok[:, t]),
                torch.full((B,), t, dtype=torch.int32), dtype=torch.float32)
            want, got = np.asarray(want), got.numpy()
            if t == 0:
                _close_to_max(got, want)
            j_finite.append(bool(np.isfinite(want).all()))
            t_finite.append(bool(np.isfinite(got).all()))
    print(f"zamba2 at 38 layers: first non-finite decode step "
          f"{j_finite.index(False) if False in j_finite else None}")
    assert t_finite == j_finite
    assert j_finite[0] and not j_finite[-1]
