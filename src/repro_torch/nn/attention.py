"""Attention layers: GQA/MQA (full and sliding-window) and its decode.

The GQA half of the JAX package's ``nn/attention.py`` (MLA is not ported
yet).  Training/prefill self-attention goes through
``kernels.swa_attention.attention``: on CUDA tensors that launches the
hand-written kernel ``csrc/swa_attention.cu`` (causal, optional sliding
window, f32 inside) for every call, or raises; on CPU tensors it runs
:func:`_chunked_attention`, the port of the reference's chunked XLA
attention.  ``use_kernel=False`` asks for :func:`_chunked_attention` on any
device (how ``chip_smoke.py`` holds the kernel path against the plain one
on the card).

Decode paths operate on a KV cache: full-attention layers keep (B, T, KV, D);
sliding-window layers keep a ring buffer of size ``window`` with per-slot
position metadata.  Unlike the reference's immutable arrays, the port
writes the new token's K/V into the cache tensors in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import swa_attention as swa_kernel
from repro_torch.kernels.runtime import resolve_device
# the kernel's plain version, the port of the reference's chunked attention
from repro_torch.kernels.swa_attention import \
    chunked_attention as _chunked_attention
from repro_torch.nn.basic import apply_rope, dense_init

Tensor = torch.Tensor
_NEG = -1e30


# ----------------------------------------------------------------- GQA init
def init_gqa(gen, d_model: int, n_heads: int, n_kv: int, d_head: int, *,
             device=None, dtype=torch.float32):
    kw = dict(device=resolve_device(device), dtype=dtype)
    return {
        "wq": dense_init(gen, d_model, n_heads * d_head, **kw),
        "wk": dense_init(gen, d_model, n_kv * d_head, **kw),
        "wv": dense_init(gen, d_model, n_kv * d_head, **kw),
        "wo": dense_init(gen, n_heads * d_head, d_model, **kw),
    }


def gqa_forward(
    p,
    x: Tensor,  # (B, S, d_model)
    positions: Optional[Tensor],  # (S,), or None for 0 .. S-1
    *,
    n_heads: int,
    n_kv: int,
    d_head: int,
    causal: bool = True,
    window: Optional[int] = None,
    rope_theta: float = 10000.0,
    cross_kv: Optional[Tensor] = None,
    q_chunk: int = 512,
    use_kernel: bool = True,
) -> Tensor:
    """Self-attention → (B, S, d_model).

    ``positions=None`` means ``0 .. S-1`` (what ``forward`` passes).  The
    kernel masks by index, so with ``use_kernel`` explicit positions must
    be ``0 .. S-1`` or it raises (checking them costs a host sync on the
    card); the plain path masks by the positions given, as the reference
    does.  Cross-attention (``cross_kv``) is not ported: it raises.
    """
    if cross_kv is not None:
        raise NotImplementedError(
            "cross-attention is not ported (the encoder and cross-attention "
            "wait in ROADMAP queue A #10)")
    b, s, _ = x.shape
    index = torch.arange(s, device=x.device)
    if positions is None:
        positions = index
    elif positions.shape != (s,):
        raise ValueError(f"positions must be (S,) = ({s},), got "
                         f"{tuple(positions.shape)}")
    elif use_kernel and not torch.equal(positions.to(index), index):
        raise ValueError("the attention kernel masks by index: positions "
                         "must be 0 .. S-1 (use_kernel=False masks by "
                         "positions)")
    q = (x @ p["wq"]).reshape(b, s, n_heads, d_head)
    k = (x @ p["wk"]).reshape(b, s, n_kv, d_head)
    v = (x @ p["wv"]).reshape(b, s, n_kv, d_head)
    q = apply_rope(q, positions[None], rope_theta)
    k = apply_rope(k, positions[None], rope_theta)
    if use_kernel:
        out = swa_kernel.attention(q, k, v, causal=causal, window=window,
                                   q_chunk=q_chunk)
    else:
        out = _chunked_attention(q, k, v, positions, positions,
                                 causal=causal, window=window,
                                 q_chunk=q_chunk)
    return out.reshape(b, s, n_heads * d_head) @ p["wo"]


# ------------------------------------------------------------------ decode
class KVCache(NamedTuple):
    """Either a full cache (capacity = max seq) or a ring buffer (= window)."""

    k: Tensor  # (B, cap, KV, D)
    v: Tensor  # (B, cap, KV, D)
    pos: Tensor  # (B, cap) int32 — absolute position stored in each slot (-1 empty)


def init_kv_cache(batch: int, capacity: int, n_kv: int, d_head: int,
                  dtype=torch.bfloat16, *, device=None) -> KVCache:
    device = resolve_device(device)
    return KVCache(
        k=torch.zeros((batch, capacity, n_kv, d_head), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, capacity, n_kv, d_head), dtype=dtype,
                      device=device),
        pos=torch.full((batch, capacity), -1, dtype=torch.int32,
                       device=device),
    )


def gqa_decode(
    p,
    x: Tensor,  # (B, 1, d_model)
    cache: KVCache,
    t_pos: Tensor,  # (B,) int32 — absolute position of the new token
    *,
    n_heads: int,
    n_kv: int,
    d_head: int,
    window: Optional[int] = None,
    rope_theta: float = 10000.0,
) -> tuple[Tensor, KVCache]:
    """One token's attention over its cache, plain PyTorch.  Writes the
    token's K/V and position into ``cache`` in place and returns it."""
    b = x.shape[0]
    cap = cache.k.shape[1]
    q = (x @ p["wq"]).reshape(b, 1, n_heads, d_head)
    k_new = (x @ p["wk"]).reshape(b, 1, n_kv, d_head)
    v_new = (x @ p["wv"]).reshape(b, 1, n_kv, d_head)
    q = apply_rope(q, t_pos[:, None], rope_theta)
    k_new = apply_rope(k_new, t_pos[:, None], rope_theta)
    # ring buffer when cap == window; plain slot otherwise
    slot = (t_pos % cap).long()
    bidx = torch.arange(b, device=x.device)
    cache.k[bidx, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[bidx, slot] = v_new[:, 0].to(cache.v.dtype)
    cache.pos[bidx, slot] = t_pos.to(torch.int32)
    k, v, pos = cache
    g = n_heads // n_kv
    qr = q.reshape(b, n_kv, g, d_head)
    logits = torch.einsum("bkgd,btkd->bkgt", qr.to(torch.float32),
                          k.to(torch.float32)) / (d_head ** 0.5)
    valid = (pos >= 0) & (pos <= t_pos[:, None])
    if window is not None:
        valid &= pos > (t_pos[:, None] - window)
    logits = torch.where(valid[:, None, None, :], logits, _NEG)
    pattn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", pattn, v.to(torch.float32))
    out = out.reshape(b, 1, n_heads * d_head).to(x.dtype) @ p["wo"]
    return out, cache
