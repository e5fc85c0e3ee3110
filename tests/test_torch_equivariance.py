"""Property tests of the port's models: E(3) equivariance of every
geometric registry model (SO(3) for TFN, whose cross-product path is
chiral; Proposition IV.1), and the virtual state's E(3) equivariance and
permutation invariance — ``tests/test_equivariance.py`` for the port.

Weights are the port's own random draws (``build_pipeline`` with a
``torch.Generator``), group elements come from ``core.equivariant``, and
each model runs its plain path and its kernel path (the kernels' plain
versions on the CPU, fed by the graph's CSR layout).  Tolerance: rtol /
atol 2e-3, as the reference's.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.equivariant import (apply_e3, apply_o3, com,
                                          random_orthogonal, random_rotation)
from repro_torch.core.graph import make_graph
from repro_torch.data.radius_graph import csr_indptr, sort_edges_by_receiver
from repro_torch.models import schnet, tfn
from repro_torch.pipeline import build_pipeline

N, E, HIN = 18, 50, 2
TOL = dict(rtol=2e-3, atol=2e-3)

MODELS = {
    "linear": {},
    "egnn": dict(h_in=HIN, n_layers=2, hidden=16),
    "fast_egnn": dict(h_in=HIN, n_layers=2, hidden=16, n_virtual=3, s_dim=8),
    "rf": dict(n_layers=2, hidden=16),
    "fast_rf": dict(n_layers=2, hidden=16, n_virtual=2),
    "schnet": dict(h_in=HIN, n_layers=2, hidden=16),
    "fast_schnet": dict(h_in=HIN, n_layers=2, hidden=16, n_virtual=2,
                        s_dim=8),
    "tfn": dict(h_in=HIN, n_layers=2, hidden=16),
    "fast_tfn": dict(h_in=HIN, n_layers=2, hidden=16, n_virtual=2, s_dim=8),
}
SO3_ONLY = {"tfn", "fast_tfn"}


def _graph(seed=0, perm=None):
    """Random coordinates, velocities and features; random edges sorted
    by receiver, with their CSR layout.  ``perm`` relabels the nodes
    (node i of the result is node perm[i] of the original)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, 3)).astype(np.float32)
    v = rng.standard_normal((N, 3)).astype(np.float32)
    h = rng.standard_normal((N, HIN)).astype(np.float32)
    snd = rng.integers(0, N, E).astype(np.int32)
    rcv = rng.integers(0, N, E).astype(np.int32)
    if perm is not None:
        inv = np.argsort(perm).astype(np.int32)
        x, v, h, snd, rcv = x[perm], v[perm], h[perm], inv[snd], inv[rcv]
    snd, rcv = sort_edges_by_receiver(snd, rcv)
    g = make_graph(x, v, h, snd, rcv, device="cpu")
    return g, (torch.from_numpy(csr_indptr(rcv, E, N)), E)


def _pipe(name, use_kernel):
    return build_pipeline(name, device="cpu", use_kernel=use_kernel,
                          generator=torch.Generator().manual_seed(1),
                          **MODELS[name])


def _transform(g, rot, t):
    return g._replace(x=apply_e3(g.x, rot, t), v=apply_o3(g.v, rot))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_e3_equivariance(name, use_kernel, seed):
    g, lay = _graph(0)
    p = _pipe(name, use_kernel)
    gen = torch.Generator().manual_seed(seed)
    rot = (random_rotation(gen, device="cpu") if name in SO3_ONLY
           else random_orthogonal(gen, device="cpu"))
    t = 3.0 * torch.randn((3,), generator=gen)
    with torch.no_grad():
        x1, _ = p.apply_full(p.params, p.cfg, g, edge_layout=lay)
        x2, _ = p.apply_full(p.params, p.cfg, _transform(g, rot, t),
                             edge_layout=lay)
    np.testing.assert_allclose(x2.numpy(), apply_e3(x1, rot, t).numpy(),
                               **TOL)


def _virtual_z(name, p, g, lay):
    """The final virtual coordinates of a plug-in or of FastEGNN."""
    if name == "fast_egnn":
        return p.apply_full(p.params, p.cfg, g, edge_layout=lay)[1][
            "virtual"].z
    if name == "fast_schnet":
        return schnet.schnet_apply(p.params, p.cfg, g, edge_layout=lay)[2].z
    return tfn.tfn_apply(p.params, p.cfg, g)[2].z


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", ["fast_egnn", "fast_schnet", "fast_tfn"])
def test_virtual_state_equivariant_and_perm_invariant(name, seed):
    """Prop. IV.1: Z is E(3)-equivariant (SO(3) for FastTFN) and invariant
    to a relabelling of the real nodes, while X' is permutation
    equivariant."""
    g, lay = _graph(0)
    p = _pipe(name, True)
    gen = torch.Generator().manual_seed(100 + seed)
    rot = (random_rotation(gen, device="cpu") if name in SO3_ONLY
           else random_orthogonal(gen, device="cpu"))
    t = torch.randn((3,), generator=gen)
    perm = torch.randperm(N, generator=gen).numpy()
    gp, layp = _graph(0, perm=perm)
    with torch.no_grad():
        z1 = _virtual_z(name, p, g, lay)
        z2 = _virtual_z(name, p, _transform(g, rot, t), lay)
        zp = _virtual_z(name, p, gp, layp)
        x1, _ = p.apply_full(p.params, p.cfg, g, edge_layout=lay)
        xp, _ = p.apply_full(p.params, p.cfg, gp, edge_layout=layp)
    np.testing.assert_allclose(z2.numpy(), apply_e3(z1, rot, t).numpy(),
                               **TOL)
    np.testing.assert_allclose(zp.numpy(), z1.numpy(), **TOL)
    np.testing.assert_allclose(xp.numpy(), x1[perm].numpy(), **TOL)


def test_group_elements():
    """random_rotation is in SO(3), random_orthogonal in O(3) with both
    signs of the determinant over seeds; com is the masked mean."""
    dets = []
    for s in range(12):
        q = random_orthogonal(torch.Generator().manual_seed(s), device="cpu")
        r = random_rotation(torch.Generator().manual_seed(s), device="cpu")
        eye = torch.eye(3)
        torch.testing.assert_close(q @ q.T, eye, atol=1e-5, rtol=0)
        torch.testing.assert_close(r @ r.T, eye, atol=1e-5, rtol=0)
        assert abs(float(torch.linalg.det(r)) - 1.0) < 1e-5
        dets.append(round(float(torch.linalg.det(q))))
    assert set(dets) == {-1, 1}
    x = torch.arange(12.0).reshape(4, 3)
    m = torch.tensor([1.0, 0.0, 1.0, 0.0])
    torch.testing.assert_close(com(x, m), (x[0] + x[2]) / 2)
    torch.testing.assert_close(com(x), x.mean(0))
