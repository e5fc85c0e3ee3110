"""xLSTM blocks (Beck et al., 2024): mLSTM (matrix memory) and sLSTM (scalar).

The counterpart of the JAX package's ``nn/xlstm.py``.  Both use
exponential gating with the max-state stabiliser; the recurrences step one
token at a time in a Python loop where the reference runs ``lax.scan``
(decode reuses the same cell with the state carried in a cache).  The
mLSTM block carries matrix memory C ∈ R^{P×P} per head; sLSTM keeps scalar
cells.  Blocks include the paper's pre-up-projection (mLSTM, pf=2) /
post-up-projection (sLSTM, pf=4/3) structure, so d_ff=0 at the model
level.  The recurrences run in f32 whatever the compute dtype, as in the
reference; there is no hand-written kernel here (the reference's is
plain ``jnp`` too).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.runtime import resolve_device
from repro_torch.nn.basic import dense_init, init_rmsnorm, rmsnorm

Tensor = torch.Tensor

# the stabiliser's start: -1e30 in the state's dtype
_M0 = -1e30


class XLSTMDims(NamedTuple):
    d_model: int
    n_heads: int
    d_inner: int  # mLSTM: pf * d_model
    head_dim: int


def xlstm_dims(d_model: int, n_heads: int, pf: int = 2) -> XLSTMDims:
    d_inner = pf * d_model
    return XLSTMDims(d_model=d_model, n_heads=n_heads, d_inner=d_inner,
                     head_dim=d_inner // n_heads)


# ------------------------------------------------------------------- mLSTM
def init_mlstm(gen, dims: XLSTMDims, *, device=None, dtype=torch.float32):
    kw = dict(device=resolve_device(device), dtype=dtype)
    di, nh = dims.d_inner, dims.n_heads
    return {
        "up_x": dense_init(gen, dims.d_model, di, **kw),
        "up_z": dense_init(gen, dims.d_model, di, **kw),
        "wq": dense_init(gen, di, di, **kw),
        "wk": dense_init(gen, di, di, **kw),
        "wv": dense_init(gen, di, di, **kw),
        "w_if": dense_init(gen, di, 2 * nh, scale=0.02, **kw),
        "b_if": torch.cat([torch.zeros((nh,), **kw),
                           torch.full((nh,), 3.0, **kw)]),
        "norm": init_rmsnorm(di, **kw),
        "down": dense_init(gen, di, dims.d_model, **kw),
    }


def _mlstm_cell(carry, q, k, v, log_i, log_f):
    """carry: (C (B,H,P,P), n (B,H,P), m (B,H)); q,k,v (B,H,P), i,f (B,H)."""
    c, n, m = carry
    m_new = torch.maximum(log_f + m, log_i)
    i_g = torch.exp(log_i - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c = f_g[..., None, None] * c + i_g[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k
    # products as matmul / sum (einsum's dispatch costs more than the math
    # in a step of a long prefill)
    qn = torch.abs((n * q).sum(-1))
    denom = torch.maximum(qn, torch.exp(-m_new))[..., None]
    h = torch.matmul(c, q[..., None])[..., 0] / denom
    return (c, n, m_new), h


def _mlstm_scan(q, k, v, log_i, log_f, state):
    """q/k/v: (B,S,H,P); gates: (B,S,H).  Returns h (B,S,H,P), final state."""
    hs = []
    for t in range(q.shape[1]):
        state, h = _mlstm_cell(state, q[:, t], k[:, t], v[:, t],
                               log_i[:, t], log_f[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), state


class MLSTMState(NamedTuple):
    c: Tensor  # (B, H, P, P)
    n: Tensor  # (B, H, P)
    m: Tensor  # (B, H)


def init_mlstm_state(batch: int, dims: XLSTMDims, dtype=torch.float32, *,
                     device=None) -> MLSTMState:
    dev = resolve_device(device)
    h, p = dims.n_heads, dims.head_dim
    return MLSTMState(
        c=torch.zeros((batch, h, p, p), dtype=dtype, device=dev),
        n=torch.zeros((batch, h, p), dtype=dtype, device=dev),
        m=torch.full((batch, h), _M0, dtype=dtype, device=dev))


def _mlstm_inner(p, x: Tensor, dims: XLSTMDims, state: MLSTMState):
    bsz, s, _ = x.shape
    xi = x @ p["up_x"]
    z = x @ p["up_z"]
    shp = (bsz, s, dims.n_heads, dims.head_dim)
    # the recurrence runs in fp32 for stability (exponential gating)
    f32 = lambda a: a.to(torch.float32)
    q = f32((xi @ p["wq"]).reshape(shp)) / (dims.head_dim ** 0.5)
    k = f32((xi @ p["wk"]).reshape(shp)) / (dims.head_dim ** 0.5)
    v = f32((xi @ p["wv"]).reshape(shp))
    gates = f32(xi @ p["w_if"]) + f32(p["b_if"])
    log_i = gates[..., : dims.n_heads]  # exponential input gate (log space)
    log_f = F.logsigmoid(gates[..., dims.n_heads:])
    h, state = _mlstm_scan(q, k, v, log_i, log_f,
                           tuple(f32(s_) for s_ in state))
    h = h.reshape(bsz, s, dims.d_inner).to(x.dtype)
    out = rmsnorm(p["norm"], h) * F.silu(z)
    return out @ p["down"], MLSTMState(*state)


def mlstm_forward(p, x: Tensor, dims: XLSTMDims) -> Tensor:
    state = init_mlstm_state(x.shape[0], dims, x.dtype, device=x.device)
    return _mlstm_inner(p, x, dims, state)[0]


def mlstm_decode(p, x: Tensor, state: MLSTMState, dims: XLSTMDims):
    """x: (B, 1, d_model) (or several tokens); returns (out, new state)."""
    return _mlstm_inner(p, x, dims, state)


# ------------------------------------------------------------------- sLSTM
def init_slstm(gen, dims: XLSTMDims, *, device=None, dtype=torch.float32):
    kw = dict(device=resolve_device(device), dtype=dtype)
    d = dims.d_model
    d_ff = int(4 * d / 3)
    return {
        "w_zifo": dense_init(gen, d, 4 * d, scale=0.02, **kw),
        "b_zifo": torch.zeros((4 * d,), **kw),
        "norm": init_rmsnorm(d, **kw),
        "ff_up": dense_init(gen, d, d_ff, **kw),
        "ff_down": dense_init(gen, d_ff, d, **kw),
    }


class SLSTMState(NamedTuple):
    c: Tensor  # (B, d)
    n: Tensor  # (B, d)
    m: Tensor  # (B, d)


def init_slstm_state(batch: int, d: int, dtype=torch.float32, *,
                     device=None) -> SLSTMState:
    dev = resolve_device(device)
    return SLSTMState(
        c=torch.zeros((batch, d), dtype=dtype, device=dev),
        n=torch.zeros((batch, d), dtype=dtype, device=dev),
        m=torch.full((batch, d), _M0, dtype=dtype, device=dev))


def _slstm_cell(carry, z, log_i, log_f, o):
    c, n, m = carry
    m_new = torch.maximum(log_f + m, log_i)
    i_g = torch.exp(log_i - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c = f_g * c + i_g * torch.tanh(z)
    n = f_g * n + i_g
    h = torch.sigmoid(o) * c / torch.clamp(n, min=1e-6)
    return (c, n, m_new), h


def _slstm_inner(p, x: Tensor, state: SLSTMState):
    bsz, s, d = x.shape
    zifo = (x @ p["w_zifo"]).to(torch.float32) + p["b_zifo"].to(torch.float32)
    z, i, f, o = torch.split(zifo, d, dim=-1)
    log_f = F.logsigmoid(f)
    state = tuple(s_.to(torch.float32) for s_ in state)
    hs = []
    for t in range(s):
        state, h = _slstm_cell(state, z[:, t], i[:, t], log_f[:, t], o[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).to(x.dtype)
    h = rmsnorm(p["norm"], h)
    # jax.nn.gelu is the tanh approximation; torch's default is not
    h = F.gelu(h @ p["ff_up"], approximate="tanh") @ p["ff_down"]
    return h, SLSTMState(*state)


def slstm_forward(p, x: Tensor) -> Tensor:
    state = init_slstm_state(x.shape[0], x.shape[-1], x.dtype,
                             device=x.device)
    return _slstm_inner(p, x, state)[0]


def slstm_decode(p, x: Tensor, state: SLSTMState):
    """x: (B, 1, d_model) (or several tokens); returns (out, new state)."""
    return _slstm_inner(p, x, state)
