"""Attention layers: GQA/MQA (full, sliding-window, cross) and MLA.

The counterpart of the JAX package's ``nn/attention.py``.  Prefill
attention — GQA self-attention (causal or, in an encoder, not), cross-
attention over encoder states or image embeddings (not causal, no RoPE,
keys of their own length T), and MLA (q and k 192 wide, v 128 at
DeepSeek-V2's widths) — goes through ``kernels.swa_attention.attention``:
on CUDA tensors that launches the hand-written kernel
(``csrc/swa_attention_wgmma.cu`` in bf16, ``csrc/swa_attention.cu`` in
f32) for every call, or raises; on CPU tensors it runs
:func:`_chunked_attention`, the port of the reference's chunked XLA
attention.  ``use_kernel=False`` asks for :func:`_chunked_attention` on any
device (how ``chip_smoke.py`` holds the kernel path against the plain one
on the card).

Decode paths operate on a KV cache: full-attention layers keep (B, T, KV, D);
sliding-window layers keep a ring buffer of size ``window`` with per-slot
position metadata; MLA layers keep the latents (B, T, kv_lora) and the
shared rope key (B, T, d_rope) and expand them every step, as the
reference does.  Unlike the reference's immutable arrays, the port writes
the new token's entries into the cache tensors in place.
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
    """Self-attention or, with ``cross_kv`` (B, T, d_model), cross-
    attention → (B, S, d_model).

    Cross-attention takes its keys and values from ``cross_kv`` at
    positions ``0 .. T-1``, with no RoPE and no causal mask, as the
    reference does.  ``positions=None`` means ``0 .. S-1`` (what
    ``forward`` passes).  The kernel masks by index, so with
    ``use_kernel`` explicit positions that a mask reads (self-attention,
    or a window) must be ``0 .. S-1`` or it raises (checking them costs a
    host sync on the card); the plain path masks by the positions given,
    as the reference does.
    """
    b, s, _ = x.shape
    positions = _positions(positions, s, x.device, use_kernel and (
        cross_kv is None or window is not None))
    q = (x @ p["wq"]).reshape(b, s, n_heads, d_head)
    if cross_kv is None:
        src, t, kv_positions = x, s, positions
    else:
        src, t = cross_kv, cross_kv.shape[1]
        kv_positions = torch.arange(t, device=x.device)
    k = (src @ p["wk"]).reshape(b, t, n_kv, d_head)
    v = (src @ p["wv"]).reshape(b, t, n_kv, d_head)
    if cross_kv is None:  # RoPE only for self-attention
        q = apply_rope(q, positions[None], rope_theta)
        k = apply_rope(k, kv_positions[None], rope_theta)
    out = _attend(q, k, v, positions, kv_positions,
                  causal=causal and cross_kv is None, window=window,
                  q_chunk=q_chunk, use_kernel=use_kernel)
    return out.reshape(b, s, n_heads * d_head) @ p["wo"]


def _positions(positions: Optional[Tensor], s: int, device,
               index_only: bool) -> Tensor:
    """``positions`` as an (S,) tensor (``None``: ``0 .. S-1``); with
    ``index_only`` anything but ``0 .. S-1`` raises (the kernel masks by
    index)."""
    index = torch.arange(s, device=device)
    if positions is None:
        return index
    if positions.shape != (s,):
        raise ValueError(f"positions must be (S,) = ({s},), got "
                         f"{tuple(positions.shape)}")
    if index_only and not torch.equal(positions.to(index), index):
        raise ValueError("the attention kernel masks by index: positions "
                         "must be 0 .. S-1 (use_kernel=False masks by "
                         "positions)")
    return positions


def _attend(q, k, v, q_positions, kv_positions, *, causal, window, q_chunk,
            use_kernel) -> Tensor:
    """The kernel (by index) or the plain attention (by position)."""
    if use_kernel:
        return swa_kernel.attention(q, k, v, causal=causal, window=window,
                                    q_chunk=q_chunk)
    return _chunked_attention(q, k, v, q_positions, kv_positions,
                              causal=causal, window=window, q_chunk=q_chunk)


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


def prefill_kv_cache(cache: KVCache, k: Tensor, v: Tensor,
                     positions: Tensor) -> KVCache:
    """Write a prefix of S tokens (k, v (B, S, KV, D), positions (S,)) into
    slots ``0 .. S-1`` (capacity ≥ S), in place; returns the cache."""
    s = k.shape[1]
    cache.k[:, :s] = k.to(cache.k.dtype)
    cache.v[:, :s] = v.to(cache.v.dtype)
    cache.pos[:, :s] = positions[None, :s].to(torch.int32)
    return cache


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


# -------------------------------------------------------------------- MLA
def init_mla(gen, d_model: int, n_heads: int, *, kv_lora: int, d_nope: int,
             d_rope: int, d_v: int, device=None, dtype=torch.float32):
    kw = dict(device=resolve_device(device), dtype=dtype)
    return {
        "wq": dense_init(gen, d_model, n_heads * (d_nope + d_rope), **kw),
        "w_dkv": dense_init(gen, d_model, kv_lora, **kw),
        "w_uk": dense_init(gen, kv_lora, n_heads * d_nope, **kw),
        "w_uv": dense_init(gen, kv_lora, n_heads * d_v, **kw),
        "w_kr": dense_init(gen, d_model, d_rope, **kw),  # shared rope key
        "wo": dense_init(gen, n_heads * d_v, d_model, **kw),
    }


def mla_forward(p, x: Tensor, positions: Optional[Tensor], *, n_heads: int,
                kv_lora: int, d_nope: int, d_rope: int, d_v: int,
                causal: bool = True, rope_theta: float = 10000.0,
                q_chunk: int = 512, use_kernel: bool = True) -> Tensor:
    """DeepSeek-V2 Multi-head Latent Attention (expanded form) → (B, S,
    d_model).

    KV is compressed to a per-token latent c_kv (kv_lora) + a shared rope
    key (d_rope); every head's key is [k_nope, k_rope] (d_nope + d_rope
    wide) and its value d_v wide, so the attention runs with D = d_nope +
    d_rope against Dv = d_v over H KV heads.  ``positions`` as in
    :func:`gqa_forward`.
    """
    b, s, _ = x.shape
    positions = _positions(positions, s, x.device, use_kernel)
    q = (x @ p["wq"]).reshape(b, s, n_heads, d_nope + d_rope)
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    q_rope = apply_rope(q_rope, positions[None], rope_theta)
    c_kv = x @ p["w_dkv"]  # (B, S, kv_lora)
    k_rope = apply_rope((x @ p["w_kr"])[:, :, None, :], positions[None],
                        rope_theta)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, n_heads, d_nope)
    value = (c_kv @ p["w_uv"]).reshape(b, s, n_heads, d_v)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, n_heads, d_rope)], -1)
    q_full = torch.cat([q_nope, q_rope], -1)
    out = _attend(q_full, k_full, value, positions, positions, causal=causal,
                  window=None, q_chunk=q_chunk, use_kernel=use_kernel)
    return out.reshape(b, s, n_heads * d_v) @ p["wo"]


class MLACache(NamedTuple):
    c_kv: Tensor  # (B, cap, kv_lora)
    k_rope: Tensor  # (B, cap, d_rope)
    pos: Tensor  # (B, cap)


def init_mla_cache(batch: int, capacity: int, kv_lora: int, d_rope: int,
                   dtype=torch.bfloat16, *, device=None) -> MLACache:
    device = resolve_device(device)
    return MLACache(
        c_kv=torch.zeros((batch, capacity, kv_lora), dtype=dtype,
                         device=device),
        k_rope=torch.zeros((batch, capacity, d_rope), dtype=dtype,
                           device=device),
        pos=torch.full((batch, capacity), -1, dtype=torch.int32,
                       device=device),
    )


def mla_decode(p, x: Tensor, cache: MLACache, t_pos: Tensor, *, n_heads: int,
               kv_lora: int, d_nope: int, d_rope: int, d_v: int,
               rope_theta: float = 10000.0) -> tuple[Tensor, MLACache]:
    """One token's MLA over its cache, plain PyTorch: the latents of every
    slot are expanded to keys and values each step, as the reference does.
    Writes the token's latent, rope key and position into ``cache`` in
    place and returns it."""
    b = x.shape[0]
    cap = cache.c_kv.shape[1]
    q = (x @ p["wq"]).reshape(b, 1, n_heads, d_nope + d_rope)
    q_nope, q_rope = q[..., :d_nope], q[..., d_nope:]
    q_rope = apply_rope(q_rope, t_pos[:, None], rope_theta)
    c_new = (x @ p["w_dkv"]).reshape(b, 1, kv_lora)
    kr_new = apply_rope((x @ p["w_kr"]).reshape(b, 1, 1, d_rope),
                        t_pos[:, None], rope_theta)
    slot = (t_pos % cap).long()
    bidx = torch.arange(b, device=x.device)
    cache.c_kv[bidx, slot] = c_new[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[bidx, slot] = kr_new[:, 0, 0, :].to(cache.k_rope.dtype)
    cache.pos[bidx, slot] = t_pos.to(torch.int32)
    c_kv, k_rope, pos = cache
    # expand latents → keys/values (absorbed form left as a perf iteration)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, cap, n_heads, d_nope)
    value = (c_kv @ p["w_uv"]).reshape(b, cap, n_heads, d_v)
    f32 = torch.float32
    logits = (
        torch.einsum("bhd,bthd->bht", q_nope[:, 0].to(f32), k_nope.to(f32))
        + torch.einsum("bhd,btd->bht", q_rope[:, 0].to(f32), k_rope.to(f32))
    ) / ((d_nope + d_rope) ** 0.5)
    valid = (pos >= 0) & (pos <= t_pos[:, None])
    logits = torch.where(valid[:, None, :], logits, _NEG)
    pattn = torch.softmax(logits, dim=-1)
    out = torch.einsum("bht,bthd->bhd", pattn, value.to(f32))
    out = out.reshape(b, 1, n_heads * d_v).to(x.dtype) @ p["wo"]
    return out, cache
