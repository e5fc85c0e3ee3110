"""Port edge and virtual pathways vs the JAX package.

On the CPU the kernel wrappers run their plain PyTorch versions; they are
held against the reference's jnp oracles (``repro.kernels.ref``) and its
Pallas kernels in interpret mode, at atol 1e-5 / rtol 1e-4 in f32 (the
gap is summation order).  The CUDA kernels themselves are held against
the plain versions in ``tests/test_torch_cuda.py``, on a GPU.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import virtual_nodes as j_vn
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.kernels.edge_message import edge_pathway_fused as j_edge_fused
from repro.kernels.virtual_message import \
    virtual_pathway_fused as j_virtual_fused
from repro_torch.core import message_passing as t_mp
from repro_torch.core import virtual_nodes as t_vn
from repro_torch.core.graph import GeometricGraph as TGraph
from repro_torch.data.radius_graph import (csr_indptr, pad_edges,
                                           radius_graph,
                                           sort_edges_by_receiver)
from repro_torch.kernels import edge_message, ops, virtual_message
from repro_torch.kernels.runtime import (BF16, F32, resolve_device,
                                         resolve_precision)
from repro_torch.weights import params_from_jax

ATOL, RTOL = 1e-5, 1e-4


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ------------------------------------------------------------------ edges
def _edge_graph(n=150, cap=2000, seed=0, dh=16):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    snd, rcv = sort_edges_by_receiver(*radius_graph(x, 0.25))
    sp, rp, em = pad_edges(snd, rcv, cap, x)
    em[: snd.size: 5] = 0.0  # mask holes inside the real slots
    h = rng.standard_normal((n, dh)).astype(np.float32)
    return x, h, sp, rp, em, csr_indptr(rp, snd.size, n)


def _edge_params(dh=16, hid=16, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)
    return {"phi1": [{"w": f(2 * dh + 1, hid), "b": f(hid)},
                     {"w": f(hid, hid), "b": f(hid)}],
            "gate": [{"w": f(hid, hid), "b": f(hid)}, {"w": f(hid, 1)}]}


EDGE_CASES = [("mlp", "raw", math.inf), ("mlp", "raw", 0.05),
              ("mlp", "inv1p", 0.05), ("none", "raw", math.inf)]


@pytest.fixture(scope="module", params=EDGE_CASES,
                ids=["mlp-noclamp", "mlp-clamp", "mlp-inv1p-clamp", "none"])
def edge_case(request):
    gate, rel, clamp = request.param
    x, h, sp, rp, em, indptr = _edge_graph()
    lp = _edge_params()
    from repro.core.message_passing import EdgeSpec as JSpec

    spec = JSpec(use_edge_attr=False, gate=gate, rel=rel, coord_clamp=clamp)
    hk, ws = j_ops.unpack_edge_params(jax.tree.map(jnp.asarray, lp),
                                      jnp.asarray(h), spec)
    kw = dict(gate_mode=gate, rel_mode=rel, clamp=clamp)
    args = (jnp.asarray(x), hk, jnp.asarray(sp), jnp.asarray(rp),
            jnp.asarray(em), *ws)
    return dict(x=x, h=h, sp=sp, rp=rp, em=em, indptr=indptr, lp=lp,
                gate=gate, rel=rel, clamp=clamp, ws=[np.asarray(w) for w in ws],
                ref=j_ref.edge_pathway_ref(*args, **kw),
                fused=j_edge_fused(*args, interpret=True, **kw))


def test_edge_wrapper_plain_matches_reference_and_pallas(edge_case):
    c = edge_case
    got = edge_message.edge_pathway_fused(
        *map(_t, (c["x"], c["h"], c["sp"], c["em"], c["indptr"], *c["ws"])),
        gate_mode=c["gate"], rel_mode=c["rel"], clamp=c["clamp"])
    for g, want_ref, want_fused in zip(got, c["ref"], c["fused"]):
        _close(g.numpy(), want_ref)
        _close(g.numpy(), want_fused)


def test_edge_pathway_plain_and_kernel_paths_match_reference(edge_case):
    """``core.message_passing.edge_pathway`` both ways: the plain path and
    the kernel path, which needs the graph's CSR layout."""
    c = edge_case
    spec = t_mp.EdgeSpec(gate=c["gate"], rel=c["rel"], coord_clamp=c["clamp"])
    n, e = c["x"].shape[0], c["sp"].shape[0]
    g = TGraph(x=_t(c["x"]), v=torch.zeros(n, 3), h=_t(c["h"]),
               senders=_t(c["sp"]), receivers=_t(c["rp"]),
               edge_attr=torch.zeros(e, 0), node_mask=torch.ones(n),
               edge_mask=_t(c["em"]))
    lp = params_from_jax(c["lp"], device="cpu")
    layout = (_t(c["indptr"]), int(c["indptr"][-1]))
    t_mp.reset_dispatch_counts()
    outs = [t_mp.edge_pathway(lp, g.h, g.x, g, spec),
            t_mp.edge_pathway(lp, g.h, g.x, g, spec, use_kernel=True,
                              layout=layout)]
    with pytest.raises(ValueError, match="CSR layout"):
        t_mp.edge_pathway(lp, g.h, g.x, g, spec, use_kernel=True)
    assert t_mp.dispatch_counts() == {"edge_plain": 1, "edge_kernel": 1}
    dx_ref, mh_ref, _ = c["ref"]
    for out in outs:
        _close(out.mh.numpy(), mh_ref)
        if c["gate"] == "none":
            assert out.dx is None
        else:
            _close(out.dx.numpy(), dx_ref)
            _close(out.dx.numpy(), c["fused"][0])


def test_segment_sum_adds_in_edge_order_on_every_segment():
    vals = torch.tensor([[1.0], [1e8], [-1e8], [2.0], [3.0]])
    ids = torch.tensor([2, 0, 0, 2, 0])
    out = t_mp.segment_sum(vals, ids, 4)
    # segment 0 in order: ((0 + 1e8) - 1e8) + 3 = 3 exactly
    assert out[:, 0].tolist() == [3.0, 0.0, 3.0, 0.0]
    assert t_mp.segment_sum(vals[:0], ids[:0], 3).shape == (3, 1)


# ---------------------------------------------------------------- virtual
C, DH, HID, S = 3, 16, 16, 16


def _virtual_inputs(n=150, seed=2):
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.3 * rng.standard_normal(s)).astype(np.float32)
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    h = rng.standard_normal((n, DH)).astype(np.float32)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float32)
    z = (0.5 + 0.2 * rng.standard_normal((C, 3))).astype(np.float32)
    s = f(C, S)
    block = j_vn.init_virtual_block(jax.random.PRNGKey(3), C, DH, S, HID)
    return x, h, mask, z, s, jax.tree.map(np.asarray, block)


@pytest.fixture(scope="module")
def virtual_case():
    x, h, mask, z, s, block = _virtual_inputs()
    com = np.asarray(j_vn.masked_com(jnp.asarray(x), jnp.asarray(mask)))
    mv = np.asarray(j_vn.virtual_global_message(jnp.asarray(z),
                                                jnp.asarray(com)))
    w = j_ops.unpack_virtual_block(jax.tree.map(jnp.asarray, block),
                                   jnp.asarray(s), jnp.asarray(mv), DH)
    flat = [jnp.asarray(a) for a in (x, h, z, mask)] + [
        w[k] for k in ("w1h", "w1d", "const1", "w2", "b2", "wg1", "bg1",
                       "wg2", "wz1", "bz1", "wz2")]
    return dict(x=x, h=h, mask=mask, z=z, s=s, mv=mv, block=block,
                flat=[np.asarray(a) for a in flat],
                ref=j_ref.virtual_pathway_ref(*flat),
                fused=j_virtual_fused(*flat, block_n=64, interpret=True))


def test_virtual_wrapper_plain_matches_reference_and_pallas(virtual_case):
    c = virtual_case
    got = virtual_message.virtual_pathway_fused(*map(_t, c["flat"]))
    for g, want_ref, want_fused in zip(got, c["ref"], c["fused"]):
        _close(g.numpy(), want_ref)
        _close(g.numpy(), want_fused)


def test_unpack_virtual_block_matches_reference(virtual_case):
    c = virtual_case
    w = ops.unpack_virtual_block(params_from_jax(c["block"], device="cpu"),
                                 _t(c["s"]), _t(c["mv"]), DH)
    names = ("w1h", "w1d", "const1", "w2", "b2", "wg1", "bg1", "wg2", "wz1",
             "bz1", "wz2")
    for name, want in zip(names, c["flat"][4:]):
        assert w[name].is_contiguous()
        _close(w[name].numpy(), want)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_virtual_pathway_matches_reference(virtual_case, use_kernel):
    c = virtual_case
    vs_j = j_vn.VirtualState(z=jnp.asarray(c["z"]), s=jnp.asarray(c["s"]))
    want = j_vn.virtual_pathway(jax.tree.map(jnp.asarray, c["block"]),
                                jnp.asarray(c["h"]), jnp.asarray(c["x"]),
                                vs_j, jnp.asarray(c["mv"]),
                                jnp.asarray(c["mask"]))
    vs_t = t_vn.VirtualState(z=_t(c["z"]), s=_t(c["s"]))
    got = t_vn.virtual_pathway(params_from_jax(c["block"], device="cpu"),
                               _t(c["h"]), _t(c["x"]), vs_t, _t(c["mv"]),
                               _t(c["mask"]), use_kernel=use_kernel)
    for g, w in zip(got, want):
        _close(g.numpy(), w)


def test_virtual_aggregate_matches_reference(virtual_case):
    c = virtual_case
    rng = np.random.default_rng(4)
    dz, ms = (rng.standard_normal((C, 3)).astype(np.float32),
              rng.standard_normal((C, HID)).astype(np.float32))
    want = j_vn.virtual_aggregate_from_sums(
        jax.tree.map(jnp.asarray, c["block"]),
        j_vn.VirtualState(jnp.asarray(c["z"]), jnp.asarray(c["s"])),
        jnp.asarray(dz), jnp.asarray(ms), jnp.float32(117.0))
    got = t_vn.virtual_aggregate_from_sums(
        params_from_jax(c["block"], device="cpu"),
        t_vn.VirtualState(_t(c["z"]), _t(c["s"])), _t(dz), _t(ms),
        torch.tensor(117.0))
    _close(got.z.numpy(), want.z)
    _close(got.s.numpy(), want.s)


# ------------------------------------------------------- wrapper contract
def _edge_operands():
    x, h, sp, rp, em, indptr = _edge_graph(n=40, cap=600)
    ws = [w for w in _edge_wrapper_weights()]
    return [_t(a) for a in (x, h, sp, em, indptr)] + ws


def _edge_wrapper_weights(dh=16):
    lp = params_from_jax(_edge_params(dh), device="cpu")
    spec = t_mp.EdgeSpec()
    return list(ops.unpack_edge_params(lp, torch.zeros(1, dh), spec)[1])


def test_wrappers_refuse_gradients_and_bf16():
    args = _edge_operands()
    args[1] = args[1].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        edge_message.edge_pathway_fused(*args)
    with torch.no_grad():
        edge_message.edge_pathway_fused(*args)  # fine without autograd
    # bf16 is a mode of the kernels (its own plain version on the CPU),
    # refused with gradients as f32 is; an unknown precision raises
    with pytest.raises(RuntimeError, match="no backward kernel"):
        edge_message.edge_pathway_fused(*args, precision="bf16")
    with torch.no_grad():
        f32 = edge_message.edge_pathway_fused(*args)
        bf16 = edge_message.edge_pathway_fused(*args, precision="bf16")
        assert not torch.equal(f32[1], bf16[1])
        with pytest.raises(ValueError, match="unknown precision"):
            edge_message.edge_pathway_fused(*args, precision="bf8")
    x, h, mask, z, s, block = _virtual_inputs(n=20)
    flat = [_t(a) for a in (x, h, z, mask)]
    w = ops.unpack_virtual_block(params_from_jax(block, device="cpu"), _t(s),
                                 torch.zeros(C, C), DH)
    vargs = flat + [w[k] for k in ("w1h", "w1d", "const1", "w2", "b2", "wg1",
                                   "bg1", "wg2", "wz1", "bz1", "wz2")]
    vargs[0] = vargs[0].clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        virtual_message.virtual_pathway_fused(*vargs)
    with torch.no_grad():
        virtual_message.virtual_pathway_fused(*vargs, precision=BF16)
        with pytest.raises(ValueError, match="unknown precision"):
            virtual_message.virtual_pathway_fused(*vargs, precision="fp16")


def test_wrappers_check_dtype_shape_contiguity():
    args = _edge_operands()
    bad = list(args)
    bad[4] = bad[4].long()  # indptr int64
    with pytest.raises(TypeError, match="int32"):
        edge_message.edge_pathway_fused(*bad)
    bad = list(args)
    bad[4] = bad[4][:-1]
    with pytest.raises(ValueError, match="indptr"):
        edge_message.edge_pathway_fused(*bad)
    bad = list(args)
    bad[1] = torch.zeros(16, args[1].shape[0]).T  # non-contiguous h
    with pytest.raises(ValueError, match="contiguous"):
        edge_message.edge_pathway_fused(*bad)
    with pytest.raises(ValueError, match="gate_mode"):
        edge_message.edge_pathway_fused(*args, gate_mode="tanh")
    x, h, mask, z, s, block = _virtual_inputs(n=20)
    w = ops.unpack_virtual_block(params_from_jax(block, device="cpu"), _t(s),
                                 torch.zeros(C, C), DH)
    vargs = [_t(a) for a in (x, h, z, mask)] + [
        w[k] for k in ("w1h", "w1d", "const1", "w2", "b2", "wg1", "bg1",
                       "wg2", "wz1", "bz1", "wz2")]
    vargs[3] = vargs[3][:-1]  # node mask one short
    with pytest.raises(ValueError, match="mask must have shape"):
        virtual_message.virtual_pathway_fused(*vargs)


def test_cpu_wrappers_do_not_count_launches():
    edge_message.reset_launches()
    virtual_message.reset_launches()
    with torch.no_grad():
        edge_message.edge_pathway_fused(*_edge_operands())
    assert edge_message.launches == 0 and virtual_message.launches == 0


def test_resolve_device_and_precision(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_precision(None) is F32 and resolve_precision("bf16") == BF16
    assert BF16.compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown precision"):
        resolve_precision("fp8")
