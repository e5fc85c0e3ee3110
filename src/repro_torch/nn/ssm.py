"""Mamba2 (SSD) layer — chunked state-space dual form + O(1) decode.

The counterpart of the JAX package's ``nn/ssm.py``.  Prefill uses the SSD
block decomposition (Dao & Gu, 2024): an intra-chunk quadratic
(attention-like) term plus an inter-chunk recurrence, a Python loop over
chunks where the reference runs ``lax.scan``, so the state is
materialised once per chunk boundary.  Decode keeps the recurrent state
and the causal-conv tail in a cache, in f32 whatever the compute dtype.

The SSD core, ``dt`` and ``a`` run in f32 and are cast back to the input's
dtype before the gate, as in the reference.  There is no hand-written
kernel here: the reference's Mamba2 is plain ``jnp`` too.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.runtime import resolve_device
from repro_torch.nn.basic import dense_init, init_rmsnorm, randn, rmsnorm

Tensor = torch.Tensor


class Mamba2Dims(NamedTuple):
    d_model: int
    d_inner: int  # = expand * d_model
    n_heads: int  # d_inner // head_dim
    head_dim: int
    d_state: int
    d_conv: int = 4


def mamba2_dims(d_model: int, d_state: int = 64, head_dim: int = 64,
                expand: int = 2) -> Mamba2Dims:
    d_inner = expand * d_model
    return Mamba2Dims(d_model=d_model, d_inner=d_inner,
                      n_heads=d_inner // head_dim, head_dim=head_dim,
                      d_state=d_state)


def softplus(x: Tensor) -> Tensor:
    """``log(1 + e^x)`` at every x, as ``jax.nn.softplus`` (``F.softplus``
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_mamba2(gen, dims: Mamba2Dims, *, device=None, dtype=torch.float32):
    kw = dict(device=resolve_device(device), dtype=dtype)
    d_in_proj = 2 * dims.d_inner + 2 * dims.d_state + dims.n_heads  # z, x, B, C, dt
    conv_ch = dims.d_inner + 2 * dims.d_state  # conv over x, B, C
    heads = dict(device=kw["device"], dtype=torch.float32)
    return {
        "in_proj": dense_init(gen, dims.d_model, d_in_proj, **kw),
        "conv_w": randn(gen, (dims.d_conv, conv_ch), scale=0.1, **kw),
        "conv_b": torch.zeros((conv_ch,), **kw),
        # A = -exp(a_log)
        "a_log": torch.log(torch.linspace(1.0, 16.0, dims.n_heads,
                                          **heads)).to(dtype),
        "dt_bias": torch.zeros((dims.n_heads,), **kw),
        "d_skip": torch.ones((dims.n_heads,), **kw),
        "norm": init_rmsnorm(dims.d_inner, **kw),
        "out_proj": dense_init(gen, dims.d_inner, dims.d_model, **kw),
    }


def _split_proj(proj: Tensor, dims: Mamba2Dims):
    di, ds = dims.d_inner, dims.d_state
    z = proj[..., :di]
    xbc = proj[..., di: di + di + 2 * ds]
    dt = proj[..., di + di + 2 * ds:]
    return z, xbc, dt


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """xbc: (B, S, C); depthwise causal conv, kernel (K, C)."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b)


def _ssd_chunked(xh: Tensor, bmat: Tensor, cmat: Tensor, dt: Tensor,
                 a: Tensor, h0: Tensor, chunk: int = 128):
    """SSD scan.  xh: (B,S,H,P), b/c: (B,S,N), dt: (B,S,H), a: (H,) (negative).

    Returns y: (B,S,H,P), h_final: (B,H,P,N).
    State update: h ← exp(a·dt)h + dt·x⊗B;  y = h·C.
    """
    bsz, s, nh, p = xh.shape
    n = bmat.shape[-1]
    if s % chunk != 0:
        # the reference's rule for ragged shapes: one chunk of S, whose
        # (B, 1, S, S, H) intra-chunk tensors grow with S²
        chunk = s
    nc = s // chunk
    xc = xh.reshape(bsz, nc, chunk, nh, p)
    bc = bmat.reshape(bsz, nc, chunk, n)
    cc = cmat.reshape(bsz, nc, chunk, n)
    dtc = dt.reshape(bsz, nc, chunk, nh)

    loga = a[None, None, None, :] * dtc  # (B,nc,L,H), ≤ 0
    seg = torch.cumsum(loga, dim=2)  # within-chunk cumulative log decay

    # intra-chunk (attention-like) term
    rel = seg[:, :, :, None, :] - seg[:, :, None, :, :]  # (B,nc,L,L,H)
    causal = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=xh.device).tril()[None, None, :, :, None]
    # masked inside the exponent, as the reference does it
    gamma = torch.exp(torch.where(causal, rel, -1e9))  # (B,nc,L,L,H)
    del rel
    cb = torch.einsum("bctn,bcsn->bcts", cc, bc)  # (B,nc,L,L)
    m = cb[..., None] * gamma * dtc[:, :, None, :, :]  # (B,nc,L,L,H)
    del gamma
    y_intra = torch.einsum("bctsh,bcshp->bcthp", m, xc)
    del m

    # chunk-boundary states
    decay_to_end = torch.exp(seg[:, :, -1:, :] - seg)  # (B,nc,L,H)
    db = torch.einsum("bclh,bcln,bclhp->bchpn", dtc * decay_to_end, bc, xc)
    chunk_decay = torch.exp(seg[:, :, -1, :])  # (B,nc,H)

    # the reference's lax.scan over chunks: the state entering each chunk
    h, starts = h0, []
    for c in range(nc):
        starts.append(h)
        h = h * chunk_decay[:, c, :, None, None] + db[:, c]
    h_starts = torch.stack(starts, dim=1)  # (B,nc,H,P,N)

    # inter-chunk term: y += C_t · (decay_from_start · h_start)
    decay_from_start = torch.exp(seg)  # (B,nc,L,H)
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", cc, h_starts,
                           decay_from_start)
    y = (y_intra + y_inter).reshape(bsz, s, nh, p)
    return y, h


def mamba2_forward(p, x: Tensor, dims: Mamba2Dims, chunk: int = 128) -> Tensor:
    """x: (B, S, d_model) → (B, S, d_model)."""
    bsz, s, _ = x.shape
    proj = x @ p["in_proj"]
    z, xbc, dt = _split_proj(proj, dims)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    f32 = lambda t: t.to(torch.float32)
    di, ds = dims.d_inner, dims.d_state
    xh = f32(xbc[..., :di]).reshape(bsz, s, dims.n_heads, dims.head_dim)
    bmat = f32(xbc[..., di: di + ds])
    cmat = f32(xbc[..., di + ds:])
    dt = softplus(f32(dt) + f32(p["dt_bias"]))  # (B,S,H)
    a = -torch.exp(f32(p["a_log"]))
    h0 = torch.zeros((bsz, dims.n_heads, dims.head_dim, dims.d_state),
                     dtype=torch.float32, device=x.device)
    y, _ = _ssd_chunked(xh, bmat, cmat, dt, a, h0, chunk)
    y = y + f32(p["d_skip"])[None, None, :, None] * xh
    y = y.to(x.dtype).reshape(bsz, s, di) * F.silu(z)
    y = rmsnorm(p["norm"], y)
    return y @ p["out_proj"]


class Mamba2Cache(NamedTuple):
    h: Tensor  # (B, H, P, N) recurrent state
    conv: Tensor  # (B, K-1, conv_ch) causal-conv tail


def init_mamba2_cache(batch: int, dims: Mamba2Dims, dtype=torch.float32, *,
                      device=None) -> Mamba2Cache:
    dev = resolve_device(device)
    conv_ch = dims.d_inner + 2 * dims.d_state
    return Mamba2Cache(
        h=torch.zeros((batch, dims.n_heads, dims.head_dim, dims.d_state),
                      dtype=dtype, device=dev),
        conv=torch.zeros((batch, dims.d_conv - 1, conv_ch), dtype=dtype,
                         device=dev),
    )


def mamba2_decode(p, x: Tensor, cache: Mamba2Cache, dims: Mamba2Dims
                  ) -> tuple[Tensor, Mamba2Cache]:
    """x: (B, 1, d_model); O(1) recurrent update.  Returns a new cache (the
    given one is not written).  The f32 cache promotes the conv window and
    everything after it to f32, as JAX's promotion does."""
    bsz = x.shape[0]
    proj = x @ p["in_proj"]
    z, xbc, dt = _split_proj(proj, dims)
    wdt = torch.promote_types(cache.conv.dtype, xbc.dtype)
    window = torch.cat([cache.conv.to(wdt), xbc.to(wdt)], dim=1)  # (B, K, C)
    conv_out = torch.sum(window * p["conv_w"][None], dim=1, keepdim=True) \
        + p["conv_b"]
    xbc = F.silu(conv_out)
    f32 = lambda t: t.to(torch.float32)
    di, ds = dims.d_inner, dims.d_state
    xh = f32(xbc[..., :di]).reshape(bsz, dims.n_heads, dims.head_dim)
    bvec = f32(xbc[:, 0, di: di + ds])
    cvec = f32(xbc[:, 0, di + ds:])
    dt = softplus(f32(dt[:, 0]) + f32(p["dt_bias"]))  # (B,H)
    a = -torch.exp(f32(p["a_log"]))
    decay = torch.exp(a[None] * dt)  # (B,H)
    h = f32(cache.h) * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dt, bvec, xh)
    y = torch.einsum("bhpn,bn->bhp", h, cvec) \
        + f32(p["d_skip"])[None, :, None] * xh
    y = y.to(x.dtype).reshape(bsz, 1, di) * F.silu(z)
    y = rmsnorm(p["norm"], y)
    return y @ p["out_proj"], Mamba2Cache(h=h, conv=window[:, 1:])

