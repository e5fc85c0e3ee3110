"""Small helpers of the port vs the JAX package: ``GeometricGraph``'s
``num_real_nodes`` and ``com``, ``segment_mean``, ``optax_global_norm``
and ``kernels.ops.mmd_loss_kernel``.

Inputs from numpy seeds; values atol 1e-5 / rtol 1e-4 (``mmd_loss_kernel``
and its gradients against the reference's, whose cross term runs its
Pallas kernels in interpret mode; on the CPU the port's runs the MMD
kernels' plain versions), counts exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as j_graph
from repro.kernels import ops as j_ops
from repro.training import optim as j_optim
from repro_torch.core import graph as t_graph
from repro_torch.core import mmd as t_mmd
from repro_torch.kernels import ops as t_ops
from repro_torch.training import optim as t_optim

ATOL, RTOL = 1e-5, 1e-4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _graph_inputs(n=40, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.3).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("all_padding", [False, True])
def test_num_real_nodes_and_com_match_reference(all_padding):
    x, mask = _graph_inputs()
    if all_padding:
        mask[:] = 0.0
    jg = j_graph.make_graph(x, node_mask=mask)
    tg = t_graph.make_graph(x, node_mask=mask, device="cpu")
    assert float(tg.num_real_nodes()) == float(jg.num_real_nodes())
    _close(tg.com(), jg.com())
    # a stack of graphs: one count and one centre a graph
    stack = t_graph.GeometricGraph(*(torch.stack([a, a]) for a in tg))
    assert stack.num_real_nodes().shape == (2,)
    _close(stack.com(), np.stack([np.asarray(jg.com())] * 2))


@pytest.mark.parametrize("weighted", [False, True])
def test_segment_mean_matches_reference(weighted):
    rng = np.random.default_rng(3)
    data = rng.standard_normal((50, 4)).astype(np.float32)
    ids = rng.integers(0, 7, 50).astype(np.int32)  # segment 7 stays empty
    w = (rng.uniform(size=50) > 0.4).astype(np.float32) if weighted else None
    want = j_graph.segment_mean(jnp.asarray(data), jnp.asarray(ids), 8,
                                None if w is None else jnp.asarray(w))
    got = t_graph.segment_mean(torch.from_numpy(data), torch.from_numpy(ids),
                               8, None if w is None else torch.from_numpy(w))
    _close(got, want)
    assert float(got[7].abs().max()) == 0.0


def test_optax_global_norm_is_global_norm():
    assert t_optim.optax_global_norm is t_optim.global_norm
    rng = np.random.default_rng(5)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    got = t_optim.optax_global_norm(
        {"a": torch.from_numpy(tree["a"]),
         "b": [torch.from_numpy(tree["b"][0])]})
    _close(got, j_optim.optax_global_norm(tree))


def test_mmd_loss_kernel_matches_reference_and_core():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((200, 3)).astype(np.float32)
    z = rng.standard_normal((5, 3)).astype(np.float32)
    mask = (rng.uniform(size=200) > 0.2).astype(np.float32)
    jfn = lambda z_, x_: j_ops.mmd_loss_kernel(z_, x_, jnp.asarray(mask),
                                               sigma=1.5)
    want, (gz, gx) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(z), jnp.asarray(x))
    tz = torch.from_numpy(z).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = t_ops.mmd_loss_kernel(tz, tx, torch.from_numpy(mask), sigma=1.5)
    got.backward()
    _close(float(got.detach()), float(want))
    _close(tz.grad, gz)
    _close(tx.grad, gx)
    # the port's own core form (the reference's test_mmd_loss_kernel_
    # matches_core)
    core = t_mmd.mmd_loss(torch.from_numpy(z), torch.from_numpy(x),
                          torch.from_numpy(mask), sigma=1.5)
    np.testing.assert_allclose(float(got.detach()), float(core), rtol=1e-5)
