"""Port LM decode at gemma3-12b's full depth vs the JAX package.

gemma3-12b cut to the reduced widths (d_model 256, 4 heads of 64, window
64) but kept at its 48 layers (8 global, 40 SWA), weights from the
reference's ``init_arch``.  Teacher-forced f32 ``decode_step``: the
virtual-token state (zeros at first, one read added per layer and per
step) grows by orders of magnitude a step with these random weights, in
the reference as in the port, until it overflows.  The port reproduces
that: the first step's logits within 1e-4 of the largest |logit|, and the
same first step with non-finite logits.

The step at which the reference's state overflows hardly depends on the
width or the draw (the read and write projections are scaled by 1/√d):
the sweep below runs the reference alone at d_model 256 and 512 and other
seeds, and every run turns non-finite within ``OVERFLOW_STEPS``, the
window ``chip_smoke.py`` holds full-width gemma3-12b's decode to on the
card.  ``pytest -s`` prints each run's step and its state's growth.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.archs import model as j_model
from repro.configs import get_arch as j_get_arch
from repro_torch.archs import model as t_model
from repro_torch.configs import get_arch
from repro_torch.weights import params_from_jax

STEPS = 18
OVERFLOW_STEPS = (13, 16)  # first non-finite step, inclusive


def _deep(cfg):
    r = cfg.reduced()
    n = cfg.n_layers
    return dataclasses.replace(r, n_layers=n, blocks=cfg.blocks[:n],
                               ffns=cfg.ffns[:n])


def test_deep_decode_overflows_where_the_reference_does():
    cfg, jcfg = _deep(get_arch("gemma3_12b")), _deep(j_get_arch("gemma3_12b"))
    assert cfg.n_layers == 48 and cfg.blocks.count("attn") == 8
    jp = j_model.init_arch(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    b = 2
    tok = np.random.default_rng(0).integers(0, cfg.vocab, (b, STEPS)).astype(
        np.int32)
    jstep = jax.jit(lambda p, c, t, pos: j_model.decode_step(
        p, jcfg, c, t, pos, dtype=jnp.float32))
    jc = j_model.init_cache(jcfg, b, STEPS, dtype=jnp.float32)
    tc = t_model.init_cache(cfg, b, STEPS, dtype=torch.float32, device="cpu")
    j_finite, t_finite = [], []
    with torch.no_grad():
        for t in range(STEPS):
            want, jc = jstep(jp, jc, jnp.asarray(tok[:, t]),
                             jnp.full((b,), t, jnp.int32))
            got, tc = t_model.decode_step(
                tp, cfg, tc, torch.from_numpy(tok[:, t]),
                torch.full((b,), t, dtype=torch.int32), dtype=torch.float32)
            want, got = np.asarray(want), got.numpy()
            if t == 0:
                np.testing.assert_allclose(
                    got, want, rtol=1e-4,
                    atol=1e-4 * float(np.abs(want).max()))
            j_finite.append(bool(np.isfinite(want).all()))
            t_finite.append(bool(np.isfinite(got).all()))
    assert t_finite == j_finite
    assert j_finite[0] and not j_finite[-1]  # it does overflow in the window
    lo, hi = OVERFLOW_STEPS
    assert lo <= j_finite.index(False) <= hi


@pytest.mark.parametrize("d_model,seed", [(256, 1), (512, 0), (512, 1)])
def test_reference_deep_decode_overflow_step(d_model, seed):
    """The reference alone at 48 layers: the first step whose virtual-token
    state is non-finite lies in OVERFLOW_STEPS at either width."""
    jcfg = _deep(j_get_arch("gemma3_12b"))
    if d_model != jcfg.d_model:  # gemma3-12b's d_virtual, 8 heads over 4
        jcfg = dataclasses.replace(jcfg, d_model=d_model, n_heads=8,
                                   n_kv_heads=4, d_ff=4 * d_model,
                                   d_virtual=256)
    jp = j_model.init_arch(jax.random.PRNGKey(seed), jcfg)
    b, steps = 4, OVERFLOW_STEPS[1] + 1
    tok = np.random.default_rng(seed).integers(
        0, jcfg.vocab, (b, steps)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t, pos: j_model.decode_step(
        p, jcfg, c, t, pos, dtype=jnp.float32))
    jc = j_model.init_cache(jcfg, b, steps, dtype=jnp.float32)
    first, log_max = None, []
    for t in range(steps):
        _, jc = jstep(jp, jc, jnp.asarray(tok[:, t]),
                      jnp.full((b,), t, jnp.int32))
        vt = np.asarray(jc.vt)
        if not np.isfinite(vt).all():
            first = t
            break
        log_max.append(round(float(np.log10(np.abs(vt).max())), 1))
    print(f"d_model {d_model} seed {seed}: first non-finite step {first}, "
          f"log10 max|vt| by step {log_max}")
    assert first is not None
    assert OVERFLOW_STEPS[0] <= first <= OVERFLOW_STEPS[1]
