"""Config-driven decoder stack: every block kind of the ten configs.

The counterpart of the JAX package's ``archs/model.py``: a decoder whose
per-layer block kind comes from ``ArchConfig.blocks`` — GQA self-attention
(``ATTN``), sliding-window attention (``SWA``), multi-head latent
attention (``MLA``), Mamba2 (``MAMBA2``), mLSTM / sLSTM (``MLSTM``,
``SLSTM``) and zamba2's shared attention block (``SHARED_ATTN``: one
attention + SwiGLU block whose weights all such layers share, read through
each layer's own norm and projection of ``concat([x, x0])``, ``x0`` the
embedding output) — with SwiGLU / GeGLU / MoE FFNs, the optional
bidirectional audio encoder (whisper), the optional cross-attention layers
(whisper's decoder, llama-vision's image layers) and the optional
virtual-token pathway (the paper's technique).  An unknown block kind
raises ``ValueError``, as the reference's ``_init_layer`` does.

Three entry points:
  ``forward``      — training / prefill: tokens (B, S) → logits (B, S, V);
                     every self-, shared, encoder and cross-attention runs
                     the hand-written attention kernel on the card
                     (``use_kernel=False``: the plain attention, which
                     training differentiates, as the reference's
                     ``jax.grad`` goes through its XLA attention); Mamba2,
                     mLSTM and sLSTM are plain PyTorch, as the reference's
                     are plain ``jnp``
  ``init_cache``   — decode caches (full KV for ATTN and SHARED_ATTN, a
                     ring for SWA, latents for MLA, the f32 recurrent state
                     for MAMBA2 / MLSTM / SLSTM) and the encoder states /
                     image embeddings that cross-attention reads
  ``decode_step``  — one-token serve step; KV caches updated in place,
                     recurrent states replaced; plain PyTorch but for
                     cross-attention, which launches the kernel (one query
                     over the T encoder states)

Layers run in a Python loop: ``ArchConfig.scan_layers`` (the reference's
``lax.scan`` over layer groups, an XLA compile-time knob) has no effect
here.  While autograd records (grad mode on and a parameter that requires
grad: training), ``forward`` runs each layer with its virtual-token step
under ``ArchConfig.remat_policy`` as the reference's ``_remat_wrap`` does:
``"full"`` under ``torch.utils.checkpoint`` (the layer's forward runs again
in the backward), ``"dots"`` under selective checkpointing that keeps the
outputs of ``mm`` / ``addmm`` (the counterpart of
``dots_with_no_batch_dims_saveable``) and recomputes the rest, ``"none"``
(or ``remat=False``) with every activation kept.  Under ``torch.no_grad()``
(prefill) no layer is wrapped.  ``forward`` and ``decode_step`` take the
compute ``dtype``
(bf16 by default, as the reference) and cast f32 leaves to it
(:func:`cast_params`); ``init_arch(..., dtype=torch.bfloat16)`` builds the
weights in bf16 directly, so no f32 copy of a large model ever exists.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.archs.config import (ATTN, FFN_GEGLU, FFN_MOE, FFN_NONE,
                                      FFN_SWIGLU, MAMBA2, MLA, MLSTM,
                                      SHARED_ATTN, SLSTM, SWA, ArchConfig)
from repro_torch.kernels.runtime import resolve_device
from repro_torch.nn import attention as attn
from repro_torch.nn import moe as moe_lib
from repro_torch.nn import ssm as ssm_lib
from repro_torch.nn import xlstm as xlstm_lib
from repro_torch.nn.basic import (dense_init, geglu, init_geglu, init_rmsnorm,
                                  init_swiglu, randn, rmsnorm, swiglu)
from repro_torch.nn.virtual_tokens import (init_virtual_tokens, init_vt_state,
                                           virtual_token_layer)

Tensor = torch.Tensor

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


def _mamba_dims(cfg: ArchConfig) -> ssm_lib.Mamba2Dims:
    return ssm_lib.mamba2_dims(cfg.d_model, d_state=cfg.ssm.d_state,
                               head_dim=cfg.ssm.head_dim, expand=cfg.ssm.expand)


def _xlstm_dims(cfg: ArchConfig) -> xlstm_lib.XLSTMDims:
    return xlstm_lib.xlstm_dims(cfg.d_model, cfg.n_heads)


# -------------------------------------------------------------------- init
def _init_ffn(gen, cfg: ArchConfig, kind: str, kw):
    if kind == FFN_SWIGLU:
        return init_swiglu(gen, cfg.d_model, cfg.d_ff, **kw)
    if kind == FFN_GEGLU:
        return init_geglu(gen, cfg.d_model, cfg.d_ff, **kw)
    if kind == FFN_MOE:
        m = cfg.moe
        return moe_lib.init_moe(gen, cfg.d_model, m.d_expert_ff, m.n_experts,
                                m.top_k, m.n_shared, m.d_shared_ff, **kw)
    return None


def _init_gqa(gen, cfg: ArchConfig, kw):
    return attn.init_gqa(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                         cfg.head_dim, **kw)


def _init_layer(gen, cfg: ArchConfig, i: int, kw):
    kind = cfg.block_kind(i)
    p: dict[str, Any] = {}
    if kind == SHARED_ATTN:
        # a per-layer input projection; attention and FFN weights are shared
        p["norm1"] = init_rmsnorm(2 * cfg.d_model, **kw)
        p["in_proj"] = dense_init(gen, 2 * cfg.d_model, cfg.d_model, **kw)
    else:
        p["norm1"] = init_rmsnorm(cfg.d_model, **kw)
    if kind in (ATTN, SWA):
        p["attn"] = _init_gqa(gen, cfg, kw)
    elif kind == MLA:
        m = cfg.mla
        p["attn"] = attn.init_mla(gen, cfg.d_model, cfg.n_heads,
                                  kv_lora=m.kv_lora, d_nope=m.d_nope,
                                  d_rope=m.d_rope, d_v=m.d_v, **kw)
    elif kind == MAMBA2:
        p["mixer"] = ssm_lib.init_mamba2(gen, _mamba_dims(cfg), **kw)
    elif kind == MLSTM:
        p["mixer"] = xlstm_lib.init_mlstm(gen, _xlstm_dims(cfg), **kw)
    elif kind == SLSTM:
        p["mixer"] = xlstm_lib.init_slstm(gen, _xlstm_dims(cfg), **kw)
    elif kind != SHARED_ATTN:
        raise ValueError(kind)
    if cfg.has_cross(i):
        p["norm_x"] = init_rmsnorm(cfg.d_model, **kw)
        p["cross"] = _init_gqa(gen, cfg, kw)
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
    kw = dict(device=resolve_device(device), dtype=dtype)
    params: dict[str, Any] = {
        "embed": randn(gen, (cfg.vocab, cfg.d_model), scale=0.02, **kw),
        "final_norm": init_rmsnorm(cfg.d_model, **kw),
        "layers": [_init_layer(gen, cfg, i, kw) for i in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, 0.02, **kw)
    if SHARED_ATTN in cfg.blocks:
        params["shared_block"] = {
            "attn": _init_gqa(gen, cfg, kw),
            "norm2": init_rmsnorm(cfg.d_model, **kw),
            "ffn": init_swiglu(gen, cfg.d_model, cfg.d_ff or 4 * cfg.d_model,
                               **kw),
        }
    if cfg.has_encoder:
        params["encoder"] = {
            "layers": [
                {"norm1": init_rmsnorm(cfg.d_model, **kw),
                 "attn": _init_gqa(gen, cfg, kw),
                 "norm2": init_rmsnorm(cfg.d_model, **kw),
                 "ffn": init_swiglu(gen, cfg.d_model,
                                    cfg.d_ff or 4 * cfg.d_model, **kw)}
                for _ in range(cfg.encoder_layers)
            ],
            "final_norm": init_rmsnorm(cfg.d_model, **kw),
        }
    if cfg.n_virtual_tokens > 0:
        params["vt"] = [
            init_virtual_tokens(gen, cfg.n_virtual_tokens, cfg.d_model,
                                cfg.d_virtual, **kw)
            for _ in range(cfg.n_layers)
        ]
    return params


# ----------------------------------------------------------------- encoder
def _gqa_kw(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim)


def encode_audio(params, cfg: ArchConfig, frames: Tensor,
                 dtype=torch.bfloat16, use_kernel: bool = True) -> Tensor:
    """Whisper-style bidirectional encoder over precomputed frame
    embeddings (B, n_frames, d_model) (the conv/mel frontend is the stubbed
    modality input, as in the reference): every layer's self-attention is
    not causal and runs the attention kernel on the card."""
    params = cast_params(params, dtype)
    x = frames.to(dtype)
    for lp in params["encoder"]["layers"]:
        h = rmsnorm(lp["norm1"], x)
        x = x + attn.gqa_forward(lp["attn"], h, None, **_gqa_kw(cfg),
                                 causal=False, rope_theta=cfg.rope_theta,
                                 q_chunk=cfg.q_chunk, use_kernel=use_kernel)
        x = x + swiglu(lp["ffn"], rmsnorm(lp["norm2"], x))
    return rmsnorm(params["encoder"]["final_norm"], x)


# ----------------------------------------------------------------- forward
def _ffn_apply(lp, cfg: ArchConfig, kind: str, x: Tensor
               ) -> tuple[Tensor, Optional[Tensor]]:
    """The FFN's output and, for MoE, its aux loss (else None)."""
    if kind == FFN_SWIGLU:
        return swiglu(lp["ffn"], x), None
    if kind == FFN_GEGLU:
        return geglu(lp["ffn"], x), None
    if kind == FFN_MOE:
        m = cfg.moe
        return moe_lib.moe_ffn(lp["ffn"], x, n_experts=m.n_experts,
                               top_k=m.top_k,
                               capacity_factor=m.capacity_factor,
                               grouped=cfg.moe_grouped)
    return torch.zeros_like(x), None


def _cross(lp, cfg: ArchConfig, x: Tensor, enc_out: Tensor, positions,
           q_chunk: int, use_kernel: bool) -> Tensor:
    h = rmsnorm(lp["norm_x"], x)
    return x + attn.gqa_forward(lp["cross"], h, positions, **_gqa_kw(cfg),
                                cross_kv=enc_out, q_chunk=q_chunk,
                                use_kernel=use_kernel)


def _shared_in(lp, x: Tensor, x0: Tensor) -> Tensor:
    """A shared-attention layer's input: its norm over ``concat([x, x0])``
    (2·d_model wide), then its own projection back to d_model."""
    return rmsnorm(lp["norm1"], torch.cat([x, x0], dim=-1)) @ lp["in_proj"]


def _shared_out(sb, x: Tensor, a: Tensor) -> Tensor:
    """The shared block's residual: attention plus its SwiGLU of the
    normed attention output."""
    return x + a + swiglu(sb["ffn"], rmsnorm(sb["norm2"], a))


def _layer_forward(params, lp, cfg: ArchConfig, i: int, x: Tensor,
                   x0: Tensor, enc_out: Optional[Tensor], use_kernel: bool
                   ) -> tuple[Tensor, Optional[Tensor]]:
    kind = cfg.block_kind(i)
    if kind == SHARED_ATTN:
        sb = params["shared_block"]
        a = attn.gqa_forward(sb["attn"], _shared_in(lp, x, x0), None,
                             **_gqa_kw(cfg), rope_theta=cfg.rope_theta,
                             q_chunk=cfg.q_chunk, use_kernel=use_kernel)
        x = _shared_out(sb, x, a)
    else:
        h = rmsnorm(lp["norm1"], x)
        if kind == MLA:
            m = cfg.mla
            x = x + attn.mla_forward(
                lp["attn"], h, None, n_heads=cfg.n_heads, kv_lora=m.kv_lora,
                d_nope=m.d_nope, d_rope=m.d_rope, d_v=m.d_v,
                rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk,
                use_kernel=use_kernel)
        elif kind == MAMBA2:
            x = x + ssm_lib.mamba2_forward(lp["mixer"], h, _mamba_dims(cfg),
                                           cfg.ssd_chunk)
        elif kind == MLSTM:
            x = x + xlstm_lib.mlstm_forward(lp["mixer"], h, _xlstm_dims(cfg))
        elif kind == SLSTM:
            x = x + xlstm_lib.slstm_forward(lp["mixer"], h)
        else:
            x = x + attn.gqa_forward(
                lp["attn"], h, None, **_gqa_kw(cfg),
                window=cfg.window if kind == SWA else None,
                rope_theta=cfg.rope_theta, q_chunk=cfg.q_chunk,
                use_kernel=use_kernel)
    if cfg.has_cross(i) and enc_out is not None:
        x = _cross(lp, cfg, x, enc_out, None, cfg.q_chunk, use_kernel)
    aux = None
    fk = cfg.ffns[i]
    if fk != FFN_NONE:
        out, aux = _ffn_apply(lp, cfg, fk, rmsnorm(lp["norm2"], x))
        x = x + out
    return x, aux


def _layer_step(params, cfg: ArchConfig, i: int, x0: Tensor,
                enc_out: Optional[Tensor], use_kernel: bool, x: Tensor,
                vt: Optional[Tensor]):
    """Layer ``i`` and its virtual-token step: (x, vt, aux or None)."""
    x, aux = _layer_forward(params, params["layers"][i], cfg, i, x, x0,
                            enc_out, use_kernel)
    if vt is not None:
        x, vt = virtual_token_layer(params["vt"][i], x, vt)
    return x, vt, aux


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``"dots"``: keep the products
    without batch dims (``x @ w``), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(step, cfg: ArchConfig, *args):
    """``step(*args)`` under ``cfg``'s activation-checkpoint policy."""
    if not cfg.remat or cfg.remat_policy == "none":
        return step(*args)
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    return ckpt.checkpoint(step, *args, use_reentrant=False, **kw)


def _records_grad(params) -> bool:
    """Whether autograd records a forward over ``params``."""
    if not torch.is_grad_enabled():
        return False
    found = []
    _tree_map(lambda a: found.append(a.requires_grad), params)
    return any(found)


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
    audio: Optional[Tensor] = None,  # (B, n_audio, d_model)
    images: Optional[Tensor] = None,  # (B, n_img, d_model)
    dtype=torch.bfloat16,
    return_hidden: bool = False,
    use_kernel: bool = True,
) -> tuple[Tensor, Tensor]:
    """Returns (logits (B,S,V) in fp32, aux loss scalar: the sum of the MoE
    layers' load-balance losses); with ``return_hidden`` the pre-head
    hidden states (B,S,d) in compute dtype instead of logits.  Whisper
    needs ``audio`` (frame embeddings, encoded here), llama-vision
    ``images`` (patch embeddings, read by its cross-attention layers).
    While autograd records, each layer runs under ``cfg.remat_policy``."""
    recording = _records_grad(params)
    params = cast_params(params, dtype)
    b = tokens.shape[0]
    x = x0 = _embed(params, cfg, tokens, dtype)
    enc_out = None
    if cfg.has_encoder:
        if audio is None:
            raise ValueError(f"{cfg.name}: the whisper backbone needs frame "
                             f"embeddings (audio=)")
        enc_out = encode_audio(params, cfg, audio, dtype, use_kernel)
    elif cfg.cross_attn_every > 0:
        if images is None:
            raise ValueError(f"{cfg.name}: the vlm backbone needs patch "
                             f"embeddings (images=)")
        enc_out = images.to(dtype)
    vt = None
    if cfg.n_virtual_tokens > 0:
        vt = init_vt_state(params["vt"][0], b).to(dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(cfg.n_layers):
        step = functools.partial(_layer_step, params, cfg, i, x0, enc_out,
                                 use_kernel)
        x, vt, aux = _remat(step, cfg, x, vt) if recording else step(x, vt)
        if aux is not None:
            aux_total = aux_total + aux
    x = rmsnorm(params["final_norm"], x)
    if return_hidden:
        return x, aux_total
    logits = (x @ lm_head_weights(params, cfg, dtype)).to(torch.float32)
    return logits, aux_total


def lm_head_weights(params, cfg: ArchConfig, dtype=torch.bfloat16) -> Tensor:
    """(d, V) head matrix in compute dtype (tied or separate)."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(dtype)


# ------------------------------------------------------------------ decode
class DecodeCache(NamedTuple):
    layers: tuple  # per-layer {"kv": KVCache or MLACache} or {"ssm": state}
    vt: Optional[Tensor]
    enc_out: Optional[Tensor]  # encoder states / image embeddings (cross K/V src)


def init_cache(cfg: ArchConfig, batch: int, capacity: int, *,
               enc_out: Optional[Tensor] = None, dtype=torch.bfloat16,
               device=None) -> DecodeCache:
    """Attention layers' KV caches in ``dtype``; the recurrent layers'
    states in f32 whatever ``dtype``, as the reference's."""
    dev = resolve_device(device)
    layers = []
    for i in range(cfg.n_layers):
        kind = cfg.block_kind(i)
        if kind == MLA:
            entry = {"kv": attn.init_mla_cache(
                batch, capacity, cfg.mla.kv_lora, cfg.mla.d_rope, dtype,
                device=dev)}
        elif kind == MAMBA2:
            entry = {"ssm": ssm_lib.init_mamba2_cache(
                batch, _mamba_dims(cfg), device=dev)}
        elif kind == MLSTM:
            entry = {"ssm": xlstm_lib.init_mlstm_state(
                batch, _xlstm_dims(cfg), device=dev)}
        elif kind == SLSTM:
            entry = {"ssm": xlstm_lib.init_slstm_state(
                batch, cfg.d_model, device=dev)}
        else:  # ATTN, SHARED_ATTN: full capacity; SWA: a ring
            cap = min(cfg.window, capacity) if kind == SWA else capacity
            entry = {"kv": attn.init_kv_cache(
                batch, cap, cfg.n_kv_heads, cfg.head_dim, dtype, device=dev)}
        layers.append(entry)
    vt = None
    if cfg.n_virtual_tokens > 0:
        vt = torch.zeros((batch, cfg.n_virtual_tokens, cfg.d_virtual),
                         dtype=dtype, device=dev)
    return DecodeCache(layers=tuple(layers), vt=vt, enc_out=enc_out)


def decode_step(
    params,
    cfg: ArchConfig,
    cache: DecodeCache,
    tokens: Tensor,  # (B,) integer — current token
    pos: Tensor,  # (B,) int32 — its absolute position
    *,
    dtype=torch.bfloat16,
    use_kernel: bool = True,
) -> tuple[Tensor, DecodeCache]:
    """One serve step: next-token logits (B, V) + the cache (KV tensors
    updated in place, recurrent states replaced by new tensors).
    Self-attention, MLA, the shared block and the recurrent blocks are
    plain PyTorch over the cache; cross-attention (one query over the
    cached ``enc_out``) runs the attention kernel on the card
    (``use_kernel=False``: the plain one)."""
    params = cast_params(params, dtype)
    x = x0 = _embed(params, cfg, tokens, dtype)[:, None, :]
    vt = cache.vt
    new_layers = []
    for i, lp in enumerate(params["layers"]):
        kind = cfg.block_kind(i)
        entry = dict(cache.layers[i])
        if kind == SHARED_ATTN:
            sb = params["shared_block"]
            a, entry["kv"] = attn.gqa_decode(
                sb["attn"], _shared_in(lp, x, x0), entry["kv"], pos,
                **_gqa_kw(cfg), rope_theta=cfg.rope_theta)
            x = _shared_out(sb, x, a)
        else:
            h = rmsnorm(lp["norm1"], x)
            if kind == MLA:
                m = cfg.mla
                out, entry["kv"] = attn.mla_decode(
                    lp["attn"], h, entry["kv"], pos, n_heads=cfg.n_heads,
                    kv_lora=m.kv_lora, d_nope=m.d_nope, d_rope=m.d_rope,
                    d_v=m.d_v, rope_theta=cfg.rope_theta)
            elif kind == MAMBA2:
                out, entry["ssm"] = ssm_lib.mamba2_decode(
                    lp["mixer"], h, entry["ssm"], _mamba_dims(cfg))
            elif kind == MLSTM:
                out, entry["ssm"] = xlstm_lib.mlstm_decode(
                    lp["mixer"], h, entry["ssm"], _xlstm_dims(cfg))
            elif kind == SLSTM:
                out, entry["ssm"] = xlstm_lib.slstm_decode(
                    lp["mixer"], h, entry["ssm"])
            else:
                out, entry["kv"] = attn.gqa_decode(
                    lp["attn"], h, entry["kv"], pos, **_gqa_kw(cfg),
                    window=cfg.window if kind == SWA else None,
                    rope_theta=cfg.rope_theta)
            x = x + out
        if cfg.has_cross(i) and cache.enc_out is not None:
            x = _cross(lp, cfg, x, cache.enc_out.to(dtype), pos[:1], 1,
                       use_kernel)
        fk = cfg.ffns[i]
        if fk != FFN_NONE:
            x = x + _ffn_apply(lp, cfg, fk, rmsnorm(lp["norm2"], x))[0]
        if vt is not None:
            x, vt = virtual_token_layer(params["vt"][i], x, vt)
        new_layers.append(entry)
    x = rmsnorm(params["final_norm"], x)
    logits = (x[:, 0] @ lm_head_weights(params, cfg, dtype)).to(torch.float32)
    return logits, DecodeCache(layers=tuple(new_layers), vt=vt,
                               enc_out=cache.enc_out)
