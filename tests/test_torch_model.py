"""Port FastEGNN vs the JAX package: the whole forward, weights, pipeline.

The reference runs with ``use_kernel=True`` (its Pallas kernels in
interpret mode) and without; the port runs its kernel path (the kernels'
plain versions on the CPU, fed by the CSR layout) and its plain path.  Coordinates, features and the final virtual state agree to
1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import GeometricGraph as JGraph
from repro.models import fast_egnn as j_fe
from repro.pipeline import build_pipeline as j_build
from repro.training.checkpoint import save_checkpoint
from repro_torch.core import message_passing as t_mp
from repro_torch.core.graph import GeometricGraph as TGraph
from repro_torch.data.radius_graph import (csr_indptr, pad_edges, pad_nodes,
                                           radius_graph,
                                           sort_edges_by_receiver)
from repro_torch.models import fast_egnn as t_fe
from repro_torch.pipeline import build_pipeline
from repro_torch.weights import load_npz, params_from_jax

TOL = 1e-4
SMALL = dict(n_layers=2, hidden=16, s_dim=16, n_virtual=3)


def _scene(n=150, ncap=160, ecap=4000, seed=0, holes=True):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    snd, rcv = sort_edges_by_receiver(*radius_graph(x, 0.25))
    sp, rp, em = pad_edges(snd, rcv, ecap, x)
    if holes:
        em[: snd.size: 7] = 0.0
    xp, nm = pad_nodes(x, ncap)
    v = pad_nodes((0.01 * rng.standard_normal((n, 3))).astype(np.float32),
                  ncap)[0]
    h = pad_nodes(np.ones((n, 1), np.float32), ncap)[0]
    arrays = (xp, v, h, sp, rp, np.zeros((ecap, 0), np.float32), nm, em)
    return arrays, csr_indptr(rp, snd.size, ncap), snd.size


def _jax_params(seed=0, **kw):
    cfg = j_fe.FastEGNNConfig(**SMALL, **kw)
    return cfg, j_fe.init_fast_egnn(jax.random.PRNGKey(seed), cfg)


def _max_err(a, b):
    return float(np.max(np.abs(np.asarray(a) - b.numpy())))


@pytest.fixture(scope="module")
def model_case():
    arrays, indptr, n_edges = _scene()
    cfg_j, p_j = _jax_params(use_kernel=True)
    out_j = j_fe.fast_egnn_apply(p_j, cfg_j,
                                 JGraph(*map(jnp.asarray, arrays)))
    return dict(arrays=arrays, indptr=indptr, n_edges=n_edges,
                params=jax.tree.map(np.asarray, p_j),
                want=jax.tree.map(np.asarray, out_j))


@pytest.mark.parametrize("mode", ["plain", "kernel-layout"])
def test_fast_egnn_apply_matches_reference(model_case, mode):
    c = model_case
    cfg = t_fe.FastEGNNConfig(**SMALL, use_kernel=mode != "plain")
    g = TGraph(*map(torch.from_numpy, c["arrays"]))
    lay = (torch.from_numpy(c["indptr"]), c["n_edges"])
    params = params_from_jax(c["params"], device="cpu")
    t_mp.reset_dispatch_counts()
    with torch.no_grad():
        x, h, vs = t_fe.fast_egnn_apply(params, cfg, g, edge_layout=lay)
    x_j, h_j, vs_j = c["want"]
    for want, got in ((x_j, x), (h_j, h), (vs_j.z, vs.z), (vs_j.s, vs.s)):
        assert _max_err(want, got) <= TOL
    counts = t_mp.dispatch_counts()
    if mode == "plain":
        assert counts == {"virtual_plain": 2, "edge_plain": 2}
    else:
        assert counts == {"virtual_kernel": 2, "edge_kernel": 2}


def test_kernel_path_needs_the_csr_layout(model_case):
    c = model_case
    cfg = t_fe.FastEGNNConfig(**SMALL, use_kernel=True)
    g = TGraph(*map(torch.from_numpy, c["arrays"]))
    params = params_from_jax(c["params"], device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match="CSR layout"):
        t_fe.fast_egnn_apply(params, cfg, g)


def test_shared_virtual_ablation_matches_reference():
    arrays, indptr, n_edges = _scene(n=60, ncap=64, ecap=1200, seed=3)
    cfg_j, p_j = _jax_params(seed=2, shared_virtual=True)
    want = j_fe.fast_egnn_apply(p_j, cfg_j, JGraph(*map(jnp.asarray, arrays)))
    cfg = t_fe.FastEGNNConfig(**SMALL, shared_virtual=True, use_kernel=True)
    params = params_from_jax(jax.tree.map(np.asarray, p_j), device="cpu")
    t_mp.reset_dispatch_counts()
    with torch.no_grad():
        got = t_fe.fast_egnn_apply(params, cfg,
                                   TGraph(*map(torch.from_numpy, arrays)),
                                   edge_layout=(torch.from_numpy(indptr),
                                                n_edges))
    # rank-2 shared weights are not kernel-eligible: the plain virtual
    # path, as the reference's jnp path (on CUDA too, see
    # tests/test_torch_cuda.py)
    assert t_mp.dispatch_counts()["virtual_plain"] == 2
    assert _max_err(want[0], got[0]) <= TOL
    assert _max_err(want[2].s, got[2].s) <= TOL


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def test_init_fast_egnn_has_reference_structure(monkeypatch):
    for kw in ({}, {"shared_virtual": True}, {"velocity": False}):
        _, p_j = _jax_params(**kw)
        p_t = t_fe.init_fast_egnn(torch.Generator().manual_seed(0),
                                  t_fe.FastEGNNConfig(**SMALL, **kw),
                                  device="cpu")
        assert _shapes(p_t) == _shapes(jax.tree.map(np.asarray, p_j))
    # like every entry point, init defaults to CUDA: no silent CPU weights
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_fe.init_fast_egnn(torch.Generator().manual_seed(0),
                            t_fe.FastEGNNConfig(**SMALL))


def test_load_npz_reads_reference_checkpoint(tmp_path):
    _, p_j = _jax_params(seed=4)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, p_j, metadata={"step": 3})
    got = load_npz(path, device="cpu")
    want = params_from_jax(jax.tree.map(np.asarray, p_j), device="cpu")
    assert _shapes(got) == _shapes(want)
    flat = lambda t: (torch.cat([flat(v) for v in t.values()]) if
                      isinstance(t, dict) else torch.cat([flat(v) for v in t])
                      if isinstance(t, list) else t.reshape(-1))
    assert torch.equal(flat(got), flat(want))


def test_build_pipeline_defaults_to_cuda_and_refuses_bf16(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    # bf16 builds (the kernels' bf16 mode); an unknown precision raises
    assert build_pipeline("fast_egnn", generator=gen, device="cpu",
                          precision="bf16").cfg.precision == "bf16"
    with pytest.raises(ValueError, match="unknown precision"):
        build_pipeline("fast_egnn", generator=gen, device="cpu",
                       precision="fp8")
    with pytest.raises(KeyError, match="unknown model"):
        build_pipeline("gcn", generator=gen, device="cpu")
    with pytest.raises(ValueError, match="generator"):
        build_pipeline("fast_egnn", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_pipeline("fast_egnn", generator=gen)


def test_predict_fn_batched_equals_singles_and_reference():
    scenes = [_scene(seed=s) for s in range(3)]
    stack = lambda i: np.stack([sc[0][i] for sc in scenes])
    arrays = tuple(stack(i) for i in range(8))
    _, p_j = _jax_params(seed=5)
    pj = j_build("fast_egnn", jax.random.PRNGKey(5), **SMALL)
    want = np.asarray(pj.predict_fn(p_j, JGraph(*map(jnp.asarray, arrays)),
                                    None))
    pipe = build_pipeline("fast_egnn", device="cpu", use_kernel=True,
                          params=params_from_jax(jax.tree.map(np.asarray,
                                                              p_j),
                                                 device="cpu"), **SMALL)
    g = TGraph(*map(torch.from_numpy, arrays))
    lay = (torch.from_numpy(np.stack([sc[1] for sc in scenes])),
           torch.tensor([sc[2] for sc in scenes]))
    got = pipe.predict_fn(pipe.params, g, lay)
    assert got.shape == (3, 160, 3) and not got.requires_grad
    assert float(np.max(np.abs(want - got.numpy()))) <= TOL
    for b in range(3):
        one = pipe.predict_fn(pipe.params,
                              TGraph(*(a[b:b + 1] for a in g)),
                              (lay[0][b:b + 1], lay[1][b:b + 1]))
        assert torch.equal(one[0], got[b])
