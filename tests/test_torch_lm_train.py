"""LM training in the port vs the JAX package: the loss and its gradients
for all ten configs, the chunked loss, the remat policies, the train step
and LM checkpoints.

Every config at its ``reduced()`` widths (2 layers, d_model 256, vocab
512), B = 2, S = 32.  Weights come from the reference's ``init_arch``
through ``params_from_jax``; tokens, labels and the whisper / vlm stub
inputs from numpy seeds.  The reference runs under ``jax.jit``, the port
on one torch thread; each reference gradient is computed once and shared
by the tests of this file.

Tolerances:
- f32: the port's ``lm_loss(dtype=float32)`` against the reference's
  ``forward(dtype=float32)`` under the same loss formula (``_j_loss_f32``,
  a copy of the reference's ``lm_loss`` with the dtype passed), both
  differentiated: loss and MoE aux within 1e-4, every gradient leaf within
  1e-3 of the leaf's largest |value| (DESIGN.md §3.2).
- bf16: against the reference's own ``lm_loss`` (bf16 compute): the loss
  within 1e-2 relative, each gradient leaf's relative L2 below 0.1
  (DESIGN.md §9.3).  The bf16 reference runs in two subprocesses
  (fixture ``bf16_reference``, started with the module so that they
  overlap the tests before the bf16 ones) with ``XLA_FLAGS=--xla_allow_excess_precision=false``: by
  default XLA's CPU compiler keeps bf16 intermediates in f32, so the
  reference would not round where a bf16 computation does (at the
  default, deepseek-v2-lite's expert gradients leave the port's by more
  than 0.1).  The flag is process-wide, so the test process cannot set
  it (``tests/test_torch_bf16.py`` does the same).  A MoE config's bf16
  tokens must route to the reference's experts
  (``test_bf16_moe_routing_against_reference`` compares the top-k
  indices): a slot on another expert moves its token by a whole expert's
  output, which no rounding bound covers, and such a config would be
  held in f32 only.  On these inputs both route alike.
- The chunked loss: against the port's dense loss in f32 (loss within
  1e-6 relative, gradients within 1e-6 of a leaf's largest |value|); in
  bf16 the loss within 2e-5 relative and each gradient leaf within
  relative L2 (n_chunks + 1) · 2⁻⁸ (see ``test_chunked_loss_bf16``);
  against the reference's dense loss at the parity tolerances above.  (The
  reference's own bf16 chunked-gradient test is elementwise and red for
  olmoe at chunks 8 and 13; that assertion is not copied.)
- The remat policies: bitwise the same loss and gradients.
- ``make_train_step`` (Adam, lr 1e-3, grad_clip 1.0, f32) over two steps
  on gemma3-12b, olmoe-1b-7b and xlstm-125m against the reference's f32
  gradient and its ``Adam``: the metrics (loss, nll, aux) within 1e-4;
  every parameter within 1e-4, except elements whose reference gradient
  is below 1e-6 in magnitude, and not zero, at either step: there Adam's
  normalised step takes the sign of rounding noise and can move the
  element by up to lr a step in either direction.  (A gradient of exactly
  zero, an expert no token reached, gives a zero step on both sides.)
  Those elements are counted, and their share of all elements must stay
  below ``NOISY_SHARE``.
- Checkpoints: an LM parameter tree and its ``AdamState`` round-trip
  bitwise, under the reference's key scheme.
"""
import dataclasses
import hashlib
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.nn.moe as t_moe
from repro.archs import model as j_model
from repro.configs import _ARCH_IDS
from repro.configs import get_arch as j_get_arch
from repro.training import checkpoint as j_ckpt
from repro.training import lm as j_lm
from repro.training import optim as j_optim
from repro_torch.archs import model as t_model
from repro_torch.configs import get_arch
from repro_torch.training import checkpoint as t_ckpt
from repro_torch.training import lm as t_lm
from repro_torch.training import optim as t_optim
from repro_torch.training.optim import tree_leaves
from repro_torch.weights import params_from_jax

B, S = 2, 32
MOE = ["olmoe_1b_7b", "deepseek_v2_lite_16b"]
CHUNKED = ["gemma3_12b", "olmoe_1b_7b"]
CHUNKS = [8, 13, 32]
BF16_ULP = 2.0 ** -8
STEP_ARCHS = ["gemma3_12b", "olmoe_1b_7b", "xlstm_125m"]
LR, CLIP = 1e-3, 1.0
#: the largest share of elements whose reference gradient is below 1e-6
#: and not zero
NOISY_SHARE = 0.01


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _j_loss_f32(params, cfg, tokens, labels, *, audio=None, images=None,
                aux_weight=0.01):
    """The reference's ``lm_loss`` formula over its f32 forward."""
    logits, aux = j_model.forward(params, cfg, tokens, audio=audio,
                                  images=images, dtype=jnp.float32)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[..., None], axis=-1)[..., 0]
    return jnp.mean(nll) + aux_weight * aux, {"nll": jnp.mean(nll),
                                               "aux": aux}


_CASES: dict = {}


def case(aid: str) -> dict:
    """The config pair, both packages' weights and the numpy inputs."""
    if aid not in _CASES:
        cfg, jcfg = get_arch(aid).reduced(), j_get_arch(aid).reduced()
        # eagerly: its ops, compiled once, serve every config's shapes,
        # where a jit would compile each config's init
        jp = j_model.init_arch(jax.random.PRNGKey(0), jcfg)
        rng = np.random.default_rng(1)
        inputs = {"tokens": rng.integers(0, cfg.vocab, (B, S)),
                  "labels": rng.integers(0, cfg.vocab, (B, S))}
        inputs = {k: v.astype(np.int32) for k, v in inputs.items()}
        if cfg.has_encoder:
            inputs["audio"] = rng.standard_normal(
                (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
        if cfg.cross_attn_every:
            inputs["images"] = rng.standard_normal(
                (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        _CASES[aid] = dict(cfg=cfg, jcfg=jcfg, jp=jp, inputs=inputs,
                           tp=params_from_jax(jax.tree.map(np.asarray, jp),
                                              device="cpu"))
    return _CASES[aid]


def batch(c: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in c["inputs"].items()}


_VG: dict = {}
_REF: dict = {}


def reference_vg(aid: str, mode: str):
    """The reference's jitted ``value_and_grad`` on ``aid``'s inputs,
    ``mode`` f32 (the f32 formula) or bf16 (its ``lm_loss``): params →
    ((loss, parts), grads), compiled once."""
    if (aid, mode) not in _VG:
        c = case(aid)
        fn = _j_loss_f32 if mode == "f32" else j_lm.lm_loss
        inp = c["inputs"]
        extra = {k: inp[k] for k in ("audio", "images") if k in inp}
        vg = jax.jit(jax.value_and_grad(
            lambda p, t, y, kw: fn(p, c["jcfg"], t, y, **kw), has_aux=True))
        _VG[aid, mode] = lambda p: vg(p, inp["tokens"], inp["labels"],
                                      extra)
    return _VG[aid, mode]


def reference(aid: str, mode: str) -> tuple:
    """(loss, parts, gradient leaves) of the reference at the initial
    weights, computed once (in this process: f32)."""
    if (aid, mode) not in _REF:
        (loss, parts), grads = reference_vg(aid, mode)(case(aid)["jp"])
        _REF[aid, mode] = (float(loss), {k: float(v) for k, v in
                                         parts.items()},
                           [np.asarray(g, np.float32)
                            for g in jax.tree.leaves(grads)])
    return _REF[aid, mode]


def port(aid: str, dtype, cfg=None) -> tuple:
    """(loss, parts, gradient leaves as numpy) of the port."""
    c = case(aid)
    loss, parts, grads = t_lm.value_and_grad(c["tp"], cfg or c["cfg"],
                                             batch(c), dtype=dtype)
    return (float(loss), {k: float(v) for k, v in parts.items()},
            [g.float().numpy() for g in tree_leaves(grads)])


def rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def assert_leaves_close(got, want, tol):
    """Every leaf within ``tol`` of the leaf's largest |value|."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * float(np.abs(w).max()))


# -------------------------------------------------------------- parity
@pytest.mark.parametrize("aid", _ARCH_IDS)
def test_f32_loss_and_grads_match_reference(aid):
    want_loss, want_parts, want = reference(aid, "f32")
    loss, parts, got = port(aid, torch.float32)
    np.testing.assert_allclose(loss, want_loss, rtol=0, atol=1e-4)
    np.testing.assert_allclose(parts["aux"], want_parts["aux"], rtol=0,
                               atol=1e-4)
    if aid in MOE:
        assert parts["aux"] > 0
    assert_leaves_close(got, want, 1e-3)


# ------------------------------------------------------------- chunked
def _chunked(aid: str, chunk: int):
    return dataclasses.replace(case(aid)["cfg"], loss_chunk=chunk)


@pytest.mark.parametrize("aid", CHUNKED)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_loss_f32_matches_dense_and_reference(aid, chunk):
    dense_loss, _, dense = port(aid, torch.float32)
    loss, parts, got = port(aid, torch.float32, _chunked(aid, chunk))
    np.testing.assert_allclose(loss, dense_loss, rtol=1e-6)
    assert_leaves_close(got, dense, 1e-6)
    want_loss, want_parts, want = reference(aid, "f32")
    np.testing.assert_allclose(loss, want_loss, rtol=0, atol=1e-4)
    np.testing.assert_allclose(parts["aux"], want_parts["aux"], rtol=0,
                               atol=1e-4)
    assert_leaves_close(got, want, 1e-3)


# --------------------------------------------------------------- remat
def _granite(policy: str, remat: bool = True):
    return dataclasses.replace(case("granite_20b")["cfg"],
                               remat_policy=policy, remat=remat)


def test_remat_policies_agree_bitwise():
    """full, dots and none (and remat=False): the same loss and gradients,
    bit for bit, on the CPU (the reference's test_remat_policies_agree
    holds its policies at rtol 1e-5 / 5e-3)."""
    runs = [port("granite_20b", torch.bfloat16, _granite(p))
            for p in ("full", "dots", "none")]
    runs.append(port("granite_20b", torch.bfloat16, _granite("full", False)))
    for loss, _, grads in runs[1:]:
        assert loss == runs[0][0]
        for g, w in zip(grads, runs[0][2]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("policy, passes", [("full", 2), ("dots", 2),
                                            ("none", 1)])
def test_remat_recomputes_each_layer(policy, passes, monkeypatch):
    """A training step runs each layer's forward twice under full and dots
    (once more in the backward) and once under none; a forward under
    no_grad (prefill) once under any policy."""
    calls = []
    layer = t_model._layer_forward

    def counted(params, lp, cfg, i, *rest):
        calls.append(i)
        return layer(params, lp, cfg, i, *rest)

    monkeypatch.setattr(t_model, "_layer_forward", counted)
    cfg = _granite(policy)
    port("granite_20b", torch.bfloat16, cfg)
    assert sorted(calls) == sorted(list(range(cfg.n_layers)) * passes)
    calls.clear()
    with torch.no_grad():
        t_model.forward(case("granite_20b")["tp"], cfg,
                        batch(case("granite_20b"))["tokens"])
    assert calls == list(range(cfg.n_layers))


# ---------------------------------------------------------- train step
@pytest.mark.parametrize("aid", STEP_ARCHS)
def test_train_step_matches_reference(aid):
    c = case(aid)
    j_opt = j_optim.Adam(lr=LR, grad_clip=CLIP)
    t_opt = t_optim.Adam(lr=LR, grad_clip=CLIP)
    t_step = t_lm.make_train_step(c["cfg"], t_opt, dtype=torch.float32)
    jp, js = c["jp"], j_opt.init(c["jp"])
    tp, ts = c["tp"], t_opt.init(c["tp"])
    j_update = jax.jit(j_opt.update)
    quiet = None
    for _ in range(2):
        (jl, jparts), jg = reference_vg(aid, "f32")(jp)
        jp, js = j_update(jg, js, jp)
        tp, ts, tm = t_step(tp, ts, batch(c))
        assert set(tm) == {"loss", "nll", "aux"}
        for k, want in dict(jparts, loss=jl).items():
            np.testing.assert_allclose(float(tm[k]), float(want), rtol=0,
                                       atol=1e-4)
        small = [(np.abs(np.asarray(g)) < 1e-6) & (np.asarray(g) != 0)
                 for g in jax.tree.leaves(jg)]
        quiet = small if quiet is None else [
            a | b for a, b in zip(quiet, small)]
    assert int(ts.step) == 2
    n_noisy = n_all = 0
    for got, want, noisy in zip(tree_leaves(tp), jax.tree.leaves(jp),
                                quiet):
        got, want = got.numpy(), np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got[~noisy], want[~noisy], rtol=0,
                                   atol=1e-4)
        # where the sign is noise: two steps of at most 2·lr apart each
        assert np.all(np.abs(got - want)[noisy] <= 4 * LR + 1e-4)
        n_noisy += int(noisy.sum())
        n_all += noisy.size
    assert n_noisy / n_all < NOISY_SHARE


def test_lm_checkpoint_round_trips_bitwise(tmp_path):
    """An LM parameter tree and its AdamState after a step go through
    save / restore unchanged, under the reference's keys (the reference
    restores the file into its own tree)."""
    c = case("olmoe_1b_7b")
    opt = t_optim.Adam(lr=LR, grad_clip=CLIP)
    params, state, _ = t_lm.make_train_step(c["cfg"], opt)(
        c["tp"], opt.init(c["tp"]), batch(c))
    tree = {"params": params, "opt": state}
    path = str(tmp_path / "lm.npz")
    t_ckpt.save_checkpoint(path, tree, {"arch": c["cfg"].name})
    got, meta = t_ckpt.restore_checkpoint(path, tree)
    assert meta == {"arch": c["cfg"].name}
    assert int(got["opt"].step) == 1 and got["opt"].step.dtype == torch.int32
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    j_opt = j_optim.Adam(lr=LR, grad_clip=CLIP)
    like = {"params": c["jp"], "opt": j_opt.init(c["jp"])}
    back, _ = j_ckpt.restore_checkpoint(path, like)
    for a, b in zip(jax.tree.leaves(back), tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---------------------------------------------------------------- bf16
# last in the file: the bf16 reference's subprocess, started with the
# module, runs while the tests above do
def _digest(tree) -> str:
    h = hashlib.sha256()
    for leaf in jax.tree.leaves(tree):
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()


def _bf16_reference(path: str, aids: list) -> None:
    """(Run in a subprocess, see ``bf16_reference``.)  The bf16 ``lm_loss``
    and gradients of each config of ``aids`` at the initial weights, a
    digest of those weights, and the MoE configs' top-k expert indices of
    the bf16 forward, MoE layer by layer; saved to ``path``."""
    out, top_k, got = {}, jax.lax.top_k, []

    def record(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda a: got.append(np.asarray(a)), idx)
        return vals, idx

    for aid in aids:
        c = case(aid)
        (loss, parts), grads = reference_vg(aid, "bf16")(c["jp"])
        out[f"{aid}/loss"] = np.asarray(loss)
        out[f"{aid}/digest"] = np.asarray(_digest(c["jp"]))
        for i, g in enumerate(jax.tree.leaves(grads)):
            out[f"{aid}/grad/{i}"] = np.asarray(g, np.float32)
        if aid in MOE:
            got.clear()
            jax.lax.top_k = record
            try:
                jax.jit(lambda p, t: j_model.forward(p, c["jcfg"], t))(
                    c["jp"], c["inputs"]["tokens"])[0].block_until_ready()
            finally:
                jax.lax.top_k = top_k
            for j, idx in enumerate(got):
                out[f"{aid}/topk/{j}"] = idx
    np.savez(path, **out)


@pytest.fixture(scope="module", autouse=True)
def _bf16_runs(tmp_path_factory):
    """Start the bf16 reference's two subprocesses (half the configs each)
    with the module; kill any still running when the module ends."""
    tmp = tmp_path_factory.mktemp("lm_bf16")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_allow_excess_precision=false")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    runs = []
    for part in (_ARCH_IDS[0::2], _ARCH_IDS[1::2]):
        path = tmp / f"{part[0]}.npz"
        runs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(path), *part],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True), path))
    yield runs
    for proc, _ in runs:
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def bf16_reference(_bf16_runs):
    """{aid: (loss, gradient leaves, top-k indices)} of the bf16
    reference; its weights checked against this process's."""
    data = {}
    for proc, path in _bf16_runs:
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        with np.load(path) as f:
            data.update({k: f[k] for k in f.files})
    out = {}
    for aid in _ARCH_IDS:
        assert str(data[f"{aid}/digest"]) == _digest(case(aid)["jp"])
        n = len(jax.tree.leaves(case(aid)["jp"]))
        out[aid] = (float(data[f"{aid}/loss"]),
                    [data[f"{aid}/grad/{i}"] for i in range(n)],
                    [data[k] for k in sorted(
                        k for k in data if k.startswith(f"{aid}/topk/"))])
    return out


@pytest.mark.parametrize("aid", _ARCH_IDS)
def test_bf16_loss_and_grads_match_reference(aid, bf16_reference):
    want_loss, want, _ = bf16_reference[aid]
    loss, _, got = port(aid, torch.bfloat16)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-2)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert rel_l2(g, w) < 0.1


@pytest.mark.parametrize("aid", MOE)
def test_bf16_moe_routing_against_reference(aid, bf16_reference,
                                            monkeypatch):
    """The bf16 top-k expert indices of every MoE layer against the
    reference's: equal."""
    c = case(aid)
    got, top_k = [], t_moe.router_top_k

    def record(probs, k):
        vals, idx = top_k(probs, k)
        got.append(idx.numpy())
        return vals, idx

    monkeypatch.setattr(t_moe, "router_top_k", record)
    with torch.no_grad():
        t_model.forward(c["tp"], c["cfg"], batch(c)["tokens"],
                        use_kernel=False)
    want = bf16_reference[aid][2]
    assert len(got) == len(want) == c["cfg"].ffns.count("moe")
    flips = sum(int((g != w).sum()) for g, w in zip(got, want))
    assert flips == 0


@pytest.mark.parametrize("aid", CHUNKED)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunked_loss_bf16(aid, chunk, bf16_reference):
    """bf16: the loss within 2e-5 relative of the dense one (the
    reference's own rtol; the NLL sums run in f32 either way) and of the
    reference's within 1e-2.  Gradients: both paths accumulate every
    product in f32 and differ only in bf16 roundings (u = 2⁻⁸).  The dense
    path rounds the head's gradient hᵀ·dlogits once (u); the chunked path
    rounds each chunk's product (u of a partial, u of their sum over all
    chunks) and each of the n_chunks − 1 bf16 additions autograd makes
    (u each): each leaf within relative L2 (n_chunks + 1) · u of the dense
    gradient (dhidden is one product a row either way), and below 0.1 of
    the reference's."""
    dense_loss, _, dense = port(aid, torch.bfloat16)
    loss, _, got = port(aid, torch.bfloat16, _chunked(aid, chunk))
    np.testing.assert_allclose(loss, dense_loss, rtol=2e-5)
    bound = (-(-S // chunk) + 1) * BF16_ULP
    for g, w in zip(got, dense):
        assert rel_l2(g, w) <= bound
    want_loss, want, _ = bf16_reference[aid]
    np.testing.assert_allclose(loss, want_loss, rtol=1e-2)
    for g, w in zip(got, want):
        assert rel_l2(g, w) < 0.1


if __name__ == "__main__":
    _bf16_reference(sys.argv[1], sys.argv[2:])
