"""Config-driven decoder stack, the dense-attention part.

The counterpart of the JAX package's ``archs/model.py`` for architectures
whose blocks are all GQA self-attention (``ATTN``) or sliding-window
attention (``SWA``), with SwiGLU / GeGLU FFNs and the optional
virtual-token pathway (the paper's technique): the gemma3 configs.  Other
block kinds (MLA, Mamba2, mLSTM, sLSTM, shared attention), MoE FFNs, the
audio encoder and cross-attention raise ``NotImplementedError`` (ROADMAP
queue A #10).

Three entry points:
  ``forward``      — prefill: tokens (B, S) → logits (B, S, V); every
                     self-attention runs ``csrc/swa_attention.cu`` on the
                     card (``use_kernel=False``: the plain attention)
  ``init_cache``   — decode caches (full KV for ATTN, a ring for SWA)
  ``decode_step``  — one-token serve step, plain PyTorch, cache updated in
                     place

Layers run in a Python loop: ``ArchConfig.scan_layers``, ``remat`` and
``remat_policy`` are XLA compile-time knobs of the reference and have no
effect here.  ``forward`` and ``decode_step`` take the compute ``dtype``
(bf16 by default, as the reference) and cast f32 leaves to it
(:func:`cast_params`); ``init_arch(..., dtype=torch.bfloat16)`` builds the
weights in bf16 directly, so no f32 copy of a large model ever exists.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.archs.config import (ATTN, FFN_GEGLU, FFN_MOE, FFN_NONE,
                                      FFN_SWIGLU, SWA, ArchConfig)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.nn import attention as attn
from repro_torch.nn.basic import (dense_init, geglu, init_geglu, init_rmsnorm,
                                  init_swiglu, randn, rmsnorm, swiglu)
from repro_torch.nn.virtual_tokens import (init_virtual_tokens, init_vt_state,
                                           virtual_token_layer)

Tensor = torch.Tensor

_TODO = "(ROADMAP queue A #10, the LM stack)"


# ----------------------------------------------------------------- helpers
def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def cast_params(params, dtype):
    """fp32 master weights → compute dtype (other leaves as they are)."""
    return _tree_map(
        lambda a: a.to(dtype) if a.dtype == torch.float32 else a, params)


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for what the port does not run yet."""
    kinds = sorted(set(cfg.blocks) - {ATTN, SWA})
    if kinds:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {kinds} are not ported {_TODO}")
    if FFN_MOE in cfg.ffns:
        raise NotImplementedError(f"{cfg.name}: MoE FFNs are not ported {_TODO}")
    if cfg.has_encoder or cfg.cross_attn_every > 0:
        raise NotImplementedError(
            f"{cfg.name}: the encoder and cross-attention are not ported "
            f"{_TODO}")


# -------------------------------------------------------------------- init
def _init_ffn(gen, cfg: ArchConfig, kind: str, kw):
    if kind == FFN_SWIGLU:
        return init_swiglu(gen, cfg.d_model, cfg.d_ff, **kw)
    if kind == FFN_GEGLU:
        return init_geglu(gen, cfg.d_model, cfg.d_ff, **kw)
    return None


def _init_layer(gen, cfg: ArchConfig, i: int, kw):
    p: dict[str, Any] = {
        "norm1": init_rmsnorm(cfg.d_model, **kw),
        "attn": attn.init_gqa(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, **kw),
    }
    fk = cfg.ffns[i]
    if fk != FFN_NONE:
        p["norm2"] = init_rmsnorm(cfg.d_model, **kw)
        p["ffn"] = _init_ffn(gen, cfg, fk, kw)
    return p


def init_arch(gen: torch.Generator, cfg: ArchConfig, *, device=None,
              dtype=torch.float32):
    """Random weights of the reference's shapes and scales, drawn from
    ``gen`` on its own device (a CUDA generator builds a large model on the
    card) and stored on ``device`` (default CUDA) in ``dtype``."""
    check_supported(cfg)
    kw = dict(device=resolve_device(device), dtype=dtype)
    params: dict[str, Any] = {
        "embed": randn(gen, (cfg.vocab, cfg.d_model), scale=0.02, **kw),
        "final_norm": init_rmsnorm(cfg.d_model, **kw),
        "layers": [_init_layer(gen, cfg, i, kw) for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, 0.02, **kw)
    if cfg.n_virtual_tokens > 0:
        params["vt"] = [
            init_virtual_tokens(gen, cfg.n_virtual_tokens, cfg.d_model,
                                cfg.d_virtual, **kw)
            for _ in range(cfg.n_layers)
        ]
    return params


# ----------------------------------------------------------------- forward
def _ffn_apply(lp, kind: str, x: Tensor) -> Tensor:
    if kind == FFN_SWIGLU:
        return swiglu(lp["ffn"], x)
    if kind == FFN_GEGLU:
        return geglu(lp["ffn"], x)
    return torch.zeros_like(x)


def _layer_forward(lp, cfg: ArchConfig, i: int, x: Tensor,
                   use_kernel: bool) -> Tensor:
    kind = cfg.block_kind(i)
    h = rmsnorm(lp["norm1"], x)
    x = x + attn.gqa_forward(
        lp["attn"], h, None, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        d_head=cfg.head_dim, window=cfg.window if kind == SWA else None,
        rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk, use_kernel=use_kernel)
    fk = cfg.ffns[i]
    if fk != FFN_NONE:
        x = x + _ffn_apply(lp, fk, rmsnorm(lp["norm2"], x))
    return x


def _embed(params, cfg: ArchConfig, tokens: Tensor, dtype) -> Tensor:
    # √d rounded to the compute dtype on the host, as the reference's
    # jnp.asarray(√d, dtype): no device tensor (and no sync) per call
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=dtype).item()
    return params["embed"][tokens] * scale


def forward(
    params,
    cfg: ArchConfig,
    tokens: Tensor,  # (B, S) integer
    *,
    audio: Optional[Tensor] = None,
    images: Optional[Tensor] = None,
    dtype=torch.bfloat16,
    return_hidden: bool = False,
    use_kernel: bool = True,
) -> tuple[Tensor, Tensor]:
    """Returns (logits (B,S,V) in fp32, aux loss scalar); with
    ``return_hidden`` the pre-head hidden states (B,S,d) in compute dtype
    instead of logits.  There is no MoE here, so aux is 0."""
    check_supported(cfg)
    if audio is not None or images is not None:
        raise NotImplementedError(f"audio / image inputs are not ported {_TODO}")
    params = cast_params(params, dtype)
    b = tokens.shape[0]
    x = _embed(params, cfg, tokens, dtype)
    vt = None
    if cfg.n_virtual_tokens > 0:
        vt = init_vt_state(params["vt"][0], b).to(dtype)
    for i in range(cfg.n_layers):
        x = _layer_forward(params["layers"][i], cfg, i, x, use_kernel)
        if vt is not None:
            x, vt = virtual_token_layer(params["vt"][i], x, vt)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    x = rmsnorm(params["final_norm"], x)
    if return_hidden:
        return x, aux
    logits = (x @ lm_head_weights(params, cfg, dtype)).to(torch.float32)
    return logits, aux


def lm_head_weights(params, cfg: ArchConfig, dtype=torch.bfloat16) -> Tensor:
    """(d, V) head matrix in compute dtype (tied or separate)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(dtype)


# ------------------------------------------------------------------ decode
class DecodeCache(NamedTuple):
    layers: tuple  # per-layer {"kv": KVCache}
    vt: Optional[Tensor]
    enc_out: Optional[Tensor]  # cross K/V source (not ported: always None)


def init_cache(cfg: ArchConfig, batch: int, capacity: int, *,
               enc_out: Optional[Tensor] = None, dtype=torch.bfloat16,
               device=None) -> DecodeCache:
    check_supported(cfg)
    if enc_out is not None:
        raise NotImplementedError(f"encoder states are not ported {_TODO}")
    dev = resolve_device(device)
    layers = []
    for i in range(cfg.n_layers):
        cap = min(cfg.window, capacity) if cfg.block_kind(i) == SWA else capacity
        layers.append({"kv": attn.init_kv_cache(batch, cap, cfg.n_kv_heads,
                                                cfg.head_dim, dtype,
                                                device=dev)})
    vt = None
    if cfg.n_virtual_tokens > 0:
        vt = torch.zeros((batch, cfg.n_virtual_tokens, cfg.d_virtual),
                         dtype=dtype, device=dev)
    return DecodeCache(layers=tuple(layers), vt=vt, enc_out=None)


def decode_step(
    params,
    cfg: ArchConfig,
    cache: DecodeCache,
    tokens: Tensor,  # (B,) integer — current token
    pos: Tensor,  # (B,) int32 — its absolute position
    *,
    dtype=torch.bfloat16,
) -> tuple[Tensor, DecodeCache]:
    """One serve step: next-token logits (B, V) + the cache, its KV tensors
    updated in place.  Launches no kernel of its own."""
    params = cast_params(params, dtype)
    x = _embed(params, cfg, tokens, dtype)[:, None, :]
    vt = cache.vt
    new_layers = []
    for i, lp in enumerate(params["layers"]):
        kind = cfg.block_kind(i)
        entry = dict(cache.layers[i])
        h = rmsnorm(lp["norm1"], x)
        out, entry["kv"] = attn.gqa_decode(
            lp["attn"], h, entry["kv"], pos, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
            window=cfg.window if kind == SWA else None,
            rope_theta=cfg.rope_theta)
        x = x + out
        fk = cfg.ffns[i]
        if fk != FFN_NONE:
            x = x + _ffn_apply(lp, fk, rmsnorm(lp["norm2"], x))
        if vt is not None:
            x, vt = virtual_token_layer(params["vt"][i], x, vt)
        new_layers.append(entry)
    x = rmsnorm(params["final_norm"], x)
    logits = (x[:, 0] @ lm_head_weights(params, cfg, dtype)).to(torch.float32)
    return logits, DecodeCache(layers=tuple(new_layers), vt=vt,
                               enc_out=cache.enc_out)
