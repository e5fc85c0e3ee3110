"""Port MMD cross term (#5) and its gradient (#6) vs the JAX package.

On the CPU the port's ``kernels.ops.MMDCross`` runs the plain versions of
the two kernels (``mmd_rbf.mmd_cross_sum`` / ``mmd_cross_grads``); it is
held against the reference's Pallas kernels in interpret mode and against
``jax.vjp`` of its oracle ``ref.mmd_cross_ref``.  Values atol 1e-5 /
rtol 1e-4; gradients relative to each output's largest magnitude, rtol
1e-3 / atol 5e-5 (the reference's ``_assert_tree_close``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mmd as j_mmd
from repro.kernels import ref as j_ref
from repro.kernels.mmd_rbf import mmd_cross_grads as j_grads
from repro.kernels.mmd_rbf import mmd_cross_sum as j_sum
from repro_torch.core import message_passing as t_mp
from repro_torch.core import mmd as t_mmd
from repro_torch.kernels import mmd_rbf, ops

ATOL, RTOL = 1e-5, 1e-4


def assert_grads_close(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        scale = float(np.max(np.abs(w))) + 1e-6
        np.testing.assert_allclose(g / scale, w / scale, rtol=1e-3, atol=5e-5)


def _inputs(n, c=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    z = (0.5 + 0.2 * rng.standard_normal((c, 3))).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    return x, z, mask


@pytest.mark.parametrize("n,sigma", [(200, 0.3), (37, 1.5)])
def test_mmd_cross_function_matches_pallas_and_vjp(n, sigma):
    x, z, mask = _inputs(n)
    g = np.float32(0.7)
    xt, zt = (torch.from_numpy(a).requires_grad_(True) for a in (x, z))
    out = ops.mmd_cross(xt, zt, torch.from_numpy(mask), sigma)
    dx, dz = torch.autograd.grad(out, (xt, zt), grad_outputs=torch.tensor(g))
    jx, jz, jm = map(jnp.asarray, (x, z, mask))
    want = j_sum(jx, jz, jm, sigma=sigma, interpret=True)
    np.testing.assert_allclose(out.item(), float(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(out.item(), float(
        j_ref.mmd_cross_ref(jx, jz, jm, sigma)), atol=ATOL, rtol=RTOL)
    assert_grads_close((dx, dz), j_grads(jx, jz, jm, g, sigma=sigma,
                                         interpret=True))
    _, vjp = jax.vjp(lambda a, b: j_ref.mmd_cross_ref(a, b, jm, sigma), jx, jz)
    assert_grads_close((dx, dz), vjp(g))


def test_mmd_wrappers_plain_on_cpu_and_refuse_grads():
    x, z, mask = map(torch.from_numpy, _inputs(50))
    mmd_rbf.reset_launches()
    s = mmd_rbf.mmd_cross_sum(x, z, mask, sigma=0.5)
    assert s.shape == () and mmd_rbf.sum_launches == 0
    dx, dz = mmd_rbf.mmd_cross_grads(x, z, mask, torch.tensor(1.0), sigma=0.5)
    assert dx.shape == (50, 3) and dz.shape == (3, 3)
    assert mmd_rbf.grad_launches == 0
    with pytest.raises(RuntimeError, match="no backward kernel"):
        mmd_rbf.mmd_cross_sum(x.clone().requires_grad_(True), z, mask,
                              sigma=0.5)
    with pytest.raises(ValueError, match="scalar cotangent"):
        mmd_rbf.mmd_cross_grads(x, z, mask, torch.ones(2), sigma=0.5)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_mmd_loss_unsampled_matches_reference(use_kernel):
    x, z, mask = _inputs(120, seed=3)
    xt = torch.from_numpy(x)
    zt = torch.from_numpy(z).requires_grad_(True)
    t_mp.reset_dispatch_counts()
    loss = t_mmd.mmd_loss(zt, xt, torch.from_numpy(mask), sigma=0.4,
                          use_kernel=use_kernel)
    (gz,) = torch.autograd.grad(loss, zt)
    assert t_mp.dispatch_counts().get("mmd_kernel", 0) == int(use_kernel)
    jf = lambda zz: j_mmd.mmd_loss(zz, jnp.asarray(x), jnp.asarray(mask),
                                   sigma=0.4, use_kernel=use_kernel)
    want, jg = jax.value_and_grad(jf)(jnp.asarray(z))
    np.testing.assert_allclose(loss.item(), float(want), atol=ATOL, rtol=RTOL)
    assert_grads_close((gz,), (jg,))


def test_mmd_loss_sampling_draws_real_nodes_from_the_generator():
    """The sampled cross term (its node draw cannot reproduce the JAX
    package's ``jax.random`` stream): same generator seed, same loss; the
    draw only ever picks real nodes."""
    x, z, mask = map(torch.from_numpy, _inputs(80, seed=4))
    mask[40:] = 0.0
    run = lambda seed: t_mmd.mmd_loss(
        z, x, mask, sigma=0.4, sample_size=16,
        generator=torch.Generator().manual_seed(seed))
    assert run(0).item() == run(0).item()
    idx = torch.multinomial((mask > 0).float(), 500, replacement=True,
                            generator=torch.Generator().manual_seed(1))
    assert int(idx.max()) < 40
    idx = torch.multinomial((mask > 0).float(), 16, replacement=True,
                            generator=torch.Generator().manual_seed(1))
    ref = t_mmd.mmd_loss(z, x[idx], torch.ones(16), sigma=0.4)
    torch.testing.assert_close(run(1), ref)
