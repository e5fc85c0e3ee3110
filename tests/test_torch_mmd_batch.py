"""The batched MMD pair (#5 cross sum, #6 cross gradient) and the trainer's
one batched MMD call a step, against the JAX package.

The reference's trainer runs ``jax.vmap`` over its per-graph loss, so each
MMD ``pallas_call`` is one call a train step with the batch as a grid
axis.  The port's wrappers take the batch (x (B,N,3), z (B,C,3), mask
(B,N), g (B,)); on the CPU they run their plain versions, held here
against ``jax.vmap`` of the reference's kernels in interpret mode and
against ``jax.vjp`` of the vmapped oracle.  The trainer's batched
objective is held against the per-slot route it replaced, and the CUDA
kernels' summation order (CTA strides, warp tree, CTAs in rank order) is
modelled in plain PyTorch at the Fluid113K size.

Tolerances: values atol 1e-5 / rtol 1e-4; gradients relative to each
output's largest magnitude, rtol 1e-3 / atol 5e-5 (the reference's
``_assert_tree_close``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as j_ref
from repro.kernels.mmd_rbf import mmd_cross_grads as j_grads
from repro.kernels.mmd_rbf import mmd_cross_sum as j_sum
from repro_torch.core import mmd as t_mmd
from repro_torch.data.fluid import generate_fluid_dataset
from repro_torch.kernels import mmd_rbf, ops
from repro_torch.kernels.ref import mmd_cross_ref
from repro_torch.models.fast_egnn import fast_egnn_full
from repro_torch.pipeline import build_pipeline
from repro_torch.training.losses import combined_objective
from repro_torch.training.optim import tree_leaves, tree_map
from repro_torch.training.trainer import (TrainConfig, _batch_mean, _slots,
                                          build_train_step)

ATOL, RTOL = 1e-5, 1e-4


def assert_grads_close(got, want):
    for g, w in zip(got, want):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.detach().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.shape == w.shape
        scale = float(np.max(np.abs(w))) + 1e-6
        np.testing.assert_allclose(g / scale, w / scale, rtol=1e-3, atol=5e-5)


def _batch_inputs(b, n, c, seed=0, zero_graph=None):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (b, n, 3)).astype(np.float32)
    z = (0.5 + 0.2 * rng.standard_normal((b, c, 3))).astype(np.float32)
    mask = (rng.uniform(size=(b, n)) > 0.2).astype(np.float32)
    if zero_graph is not None:
        mask[zero_graph] = 0.0
    g = rng.uniform(0.5, 1.5, (b,)).astype(np.float32)
    return x, z, mask, g


# ------------------------------------------- the batched pair vs jax.vmap
@pytest.mark.parametrize("c", [3, 5])
@pytest.mark.parametrize("n", [37, 200])
@pytest.mark.parametrize("b", [1, 3])
def test_batched_pair_matches_vmapped_pallas_and_vjp(b, n, c):
    """The wrappers' batch form (plain path) and ``ops.mmd_cross`` on a
    batch against the reference's kernels vmapped as its trainer runs
    them (interpret mode); with three graphs, the middle one's mask is
    all zero."""
    sigma = 0.4
    x, z, mask, g = _batch_inputs(b, n, c, seed=b * 1000 + n + c,
                                  zero_graph=1 if b == 3 else None)
    jx, jz, jm, jg = map(jnp.asarray, (x, z, mask, g))
    want = jax.vmap(lambda a, bb, m: j_sum(a, bb, m, sigma=sigma,
                                           interpret=True))(jx, jz, jm)
    want_dx, want_dz = jax.vmap(lambda a, bb, m, gg: j_grads(
        a, bb, m, gg, sigma=sigma, interpret=True))(jx, jz, jm, jg)
    _, vjp = jax.vjp(jax.vmap(lambda a, bb, m: j_ref.mmd_cross_ref(
        a, bb, m, sigma)), jx, jz, jm)
    vjp_dx, vjp_dz, _ = vjp(jg)

    xt, zt, mt, gt = map(torch.from_numpy, (x, z, mask, g))
    got = mmd_rbf.mmd_cross_sum(xt, zt, mt, sigma=sigma)
    assert got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    dx, dz = mmd_rbf.mmd_cross_grads(xt, zt, mt, gt, sigma=sigma)
    assert dx.shape == (b, n, 3) and dz.shape == (b, c, 3)
    assert_grads_close((dx, dz), (want_dx, want_dz))
    assert_grads_close((dx, dz), (vjp_dx, vjp_dz))
    if b == 3:  # the graph with no live node: a zero sum and zero grads
        assert got[1].item() == 0.0
        assert not dx[1].any() and not dz[1].any()
    # through the autograd Function, as the trainer calls it
    xa, za = xt.clone().requires_grad_(True), zt.clone().requires_grad_(True)
    out = ops.mmd_cross(xa, za, mt, sigma)
    ga, gz = torch.autograd.grad(out, (xa, za), grad_outputs=gt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    assert_grads_close((ga, gz), (vjp_dx, vjp_dz))


@pytest.mark.parametrize("n", [37, 200])
def test_unbatched_call_equals_batch_of_one(n):
    x, z, mask, g = map(torch.from_numpy, _batch_inputs(1, n, 3, seed=n))
    s1 = mmd_rbf.mmd_cross_sum(x, z, mask, sigma=0.5)
    s0 = mmd_rbf.mmd_cross_sum(x[0], z[0], mask[0], sigma=0.5)
    assert s0.shape == () and s1.shape == (1,)
    assert torch.equal(s0, s1[0])
    dx1, dz1 = mmd_rbf.mmd_cross_grads(x, z, mask, g, sigma=0.5)
    dx0, dz0 = mmd_rbf.mmd_cross_grads(x[0], z[0], mask[0], g[0], sigma=0.5)
    assert dx0.shape == (n, 3) and dz0.shape == (3, 3)
    assert torch.equal(dx0, dx1[0]) and torch.equal(dz0, dz1[0])
    l1 = t_mmd.mmd_loss(z, x, mask, sigma=0.5, use_kernel=True)
    l0 = t_mmd.mmd_loss(z[0], x[0], mask[0], sigma=0.5, use_kernel=True)
    assert l0.shape == () and torch.equal(l0, l1[0])


def test_batched_wrappers_check_their_inputs():
    x, z, mask, g = map(torch.from_numpy, _batch_inputs(2, 20, 3))
    mmd_rbf.reset_launches()
    with pytest.raises(ValueError, match=r"z \(B,C,3\)"):
        mmd_rbf.mmd_cross_sum(x, z[:1], mask, sigma=0.5)
    with pytest.raises(ValueError, match="node_mask"):
        mmd_rbf.mmd_cross_sum(x, z, mask[:, :10], sigma=0.5)
    with pytest.raises(ValueError, match="g"):
        mmd_rbf.mmd_cross_grads(x, z, mask, g[:1], sigma=0.5)
    with pytest.raises(TypeError, match="float32"):
        mmd_rbf.mmd_cross_sum(x.double(), z, mask, sigma=0.5)
    with pytest.raises(ValueError, match="contiguous x"):
        mmd_rbf.mmd_cross_sum(x.transpose(0, 1).contiguous().transpose(0, 1),
                              z, mask, sigma=0.5)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        mmd_rbf.mmd_cross_grads(x, z.clone().requires_grad_(True), mask, g,
                                sigma=0.5)
    assert mmd_rbf.sum_launches == mmd_rbf.grad_launches == 0


# ------------------------------------ the kernels' schedule and sum order
@pytest.mark.parametrize("n,want", [(0, (128, 1)), (37, (128, 1)),
                                    (1000, (128, 4)), (4096, (128, 16)),
                                    (8192, (256, 16)), (113_000, (1024, 16)),
                                    (131_072, (1024, 16))])
def test_schedule_depends_on_n_alone(n, want):
    """One cluster per graph: up to 16 CTAs (the non-portable cluster
    size) with ~2 nodes a thread, then up to 1,024 threads a CTA, then
    more nodes a thread."""
    threads, ctas = mmd_rbf.schedule(n)
    assert (threads, ctas) == want
    assert threads % 32 == 0 and threads <= mmd_rbf.THREADS_MAX
    assert 1 <= ctas <= mmd_rbf.CTAS_MAX
    assert threads * ctas * mmd_rbf.NODES_PER_THREAD >= n or (
        (threads, ctas) == (mmd_rbf.THREADS_MAX, mmd_rbf.CTAS_MAX))


def _butterfly(v):
    """The warp's xor-shuffle tree over the last axis (32 lanes): every
    lane ends with the same value; lane 0's is returned."""
    lane = torch.arange(32)
    for m in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ m]
    return v[..., 0]


def _in_order(v):
    """Sum over the last axis one element after another, in f32."""
    s = torch.zeros(v.shape[:-1], dtype=v.dtype)
    for k in range(v.shape[-1]):
        s = s + v[..., k]
    return s


def kernel_order_pair(x, z, mask, g, sigma):
    """``csrc/mmd_rbf.cu``'s arithmetic in its order, in f32: each thread
    of a graph's cluster takes the nodes ``rank * threads + t`` + k ·
    ``ctas * threads`` in turn, each node's channels in order; then the
    warp tree, the warps in index order, the CTAs in rank order.
    Returns (out (B,), dx (B,N,3), dz (B,C,3))."""
    b, n, _ = x.shape
    c = z.shape[1]
    threads, ctas = mmd_rbf.schedule(n)
    p = threads * ctas
    steps = -(-n // p)
    neg_inv_2s2 = torch.tensor(-0.5 / (sigma * sigma))  # rounded to f32
    inv_s2 = -2.0 * neg_inv_2s2
    rel = x[:, :, None, :] - z[:, None, :, :]  # (B, N, C, 3)
    k = torch.exp((rel * rel).sum(-1) * neg_inv_2s2)  # (B, N, C)
    term = k * mask[..., None]
    w = k * (g[:, None] * mask)[..., None]
    wr = w[..., None] * rel  # (B, N, C, 3)
    dx = -inv_s2 * _in_order(wr.transpose(-1, -2))  # channels in order
    v = torch.zeros((b, p))
    acc = torch.zeros((b, p, c, 3))
    for s in range(steps):
        idx = torch.arange(s * p, (s + 1) * p)
        live = idx < n
        idx = idx.clamp(max=n - 1)
        for ch in range(c):
            v = torch.where(live, v + term[:, idx, ch], v)
        acc = torch.where(live[:, None, None], acc + wr[:, idx], acc)

    def reduce(t):  # (B, P, ...) → (B, ...): warp tree, warps, ranks
        t = t.reshape(b, ctas, threads // 32, 32, -1).movedim(3, -1)
        per_cta = _in_order(_butterfly(t).movedim(2, -1))  # (B, ctas, F)
        return _in_order(per_cta.movedim(1, -1))

    out = reduce(v[..., None])[:, 0]
    dz = inv_s2 * reduce(acc.reshape(b, p, 3 * c)).reshape(b, c, 3)
    return out, dx, dz


@pytest.mark.parametrize("n,live", [(113_000, 113_000), (131_072, 113_000)])
def test_kernel_sum_order_at_fluid113k_size(n, live):
    """At the Fluid113K size the kernels' order of f32 adds stays inside
    the tolerance of a float64 sum, and graph 0's result is bitwise the
    same alone and in a batch of three (its schedule depends on N only)."""
    rng = np.random.default_rng(n)
    sigma, c = 1.5, 3
    x = rng.uniform(0.0, 1.0, (3, n, 3)).astype(np.float32)
    z = (0.5 + 0.2 * rng.standard_normal((3, c, 3))).astype(np.float32)
    mask = np.zeros((3, n), np.float32)
    mask[:, :live] = 1.0
    mask[1] = rng.uniform(size=n) > 0.5
    g = np.array([0.7, 1.3, 0.2], np.float32)
    xt, zt, mt, gt = map(torch.from_numpy, (x, z, mask, g))
    out, dx, dz = kernel_order_pair(xt, zt, mt, gt, sigma)
    x64, z64, m64, g64 = (t.double() for t in (xt, zt, mt, gt))
    want = mmd_cross_ref(x64, z64, m64, sigma)
    want_dx, want_dz = mmd_rbf.mmd_cross_grads_plain(x64, z64, m64, g64,
                                                      sigma=sigma)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL,
                               rtol=RTOL)
    for b in range(3):
        assert_grads_close((dx[b], dz[b]), (want_dx[b], want_dz[b]))
    alone = kernel_order_pair(xt[:1], zt[:1], mt[:1], gt[:1], sigma)
    for got, one in zip((out, dx, dz), alone):
        assert torch.equal(got[:1], one)


# -------------------------------- the trainer: one batched MMD call a step
R = 0.035
SMALL = dict(n_layers=2, hidden=16, s_dim=16, n_virtual=3)


@pytest.fixture(scope="module")
def train_batches():
    data = generate_fluid_dataset(3, n_particles=64)
    out = {}
    for use_kernel in (False, True):
        pipe = build_pipeline("fast_egnn", device="cpu", use_kernel=use_kernel,
                              generator=torch.Generator().manual_seed(2),
                              **SMALL)
        out[use_kernel] = (pipe, pipe.make_batches(data, 2, r=R))
    return out


def _per_slot_loss(params, cfg, tc, batch, generator):
    """The route the trainer took before it batched its MMD call: the
    objective slot by slot, the same weighted mean."""
    losses, parts = [], []
    for g, target, lay in _slots(batch):
        x_pred, aux = fast_egnn_full(params, cfg, g, edge_layout=lay)
        loss, p = combined_objective(
            x_pred, target, g.node_mask, aux["virtual"].z, lam=tc.lam_mmd,
            sigma=tc.mmd_sigma, mmd_sample=tc.mmd_sample,
            generator=generator, use_kernel=bool(cfg.use_kernel))
        losses.append(loss)
        parts.append(p)
    mean = lambda vals: _batch_mean(torch.stack(vals), batch.sample_mask)
    return mean(losses), {k: mean([p[k] for p in parts]) for k in parts[0]}


class _GradsOut:
    def update(self, grads, state, params):
        return grads, state


@pytest.mark.parametrize("mmd_sample", [None, 3])
@pytest.mark.parametrize("which", [0, 1])  # batch 1 is mask-padded
@pytest.mark.parametrize("use_kernel", [False, True])
def test_trainer_batched_mmd_matches_per_slot_route(train_batches, monkeypatch,
                                                    use_kernel, which,
                                                    mmd_sample):
    """Loss, parts and every parameter gradient of the trainer's step
    (one batched MMD call) against the per-slot route; with
    ``mmd_sample``, the same node indices drawn from the generator, slot
    by slot, and the same generator state after the step."""
    pipe, batches = train_batches[use_kernel]
    batch = batches[which]
    assert (batch.sample_mask is not None) == (which == 1)
    tc = TrainConfig(lam_mmd=0.5, mmd_sample=mmd_sample)
    drawn = []
    multinomial = torch.multinomial

    def record(*a, **kw):
        out = multinomial(*a, **kw)
        drawn[-1].append(out.clone())
        return out

    monkeypatch.setattr(torch, "multinomial", record)
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    drawn.append([])
    grads, _, metrics = build_train_step(fast_egnn_full, pipe.cfg, tc,
                                         _GradsOut())[0](
        pipe.params, None, batch, gens[0])
    drawn.append([])
    work = tree_map(lambda p: p.detach().requires_grad_(True), pipe.params)
    flat = tree_leaves(work)
    loss, parts = _per_slot_loss(work, pipe.cfg, tc, batch, gens[1])
    want = torch.autograd.grad(loss, flat, allow_unused=True)
    want = [torch.zeros_like(p) if w is None else w
            for w, p in zip(want, flat)]

    np.testing.assert_allclose(metrics["loss"].item(), loss.item(),
                               atol=ATOL, rtol=RTOL)
    for k in ("mse", "mmd"):
        np.testing.assert_allclose(metrics[k].item(), parts[k].item(),
                                   atol=ATOL, rtol=RTOL)
    got = tree_leaves(grads)
    assert len(got) == len(want)
    assert_grads_close(got, want)
    n_draws = 0 if mmd_sample is None else 2
    assert len(drawn[0]) == len(drawn[1]) == n_draws
    for a, b in zip(*drawn):
        assert torch.equal(a, b)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
