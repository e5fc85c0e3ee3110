"""Architecture configuration schema for the assigned model pool.

Every architecture is fully described by an ``ArchConfig``: a per-layer block
kind list (attention flavours, SSM flavours, shared blocks) plus per-layer
FFN kinds (dense/moe/none), modality stubs, and the virtual-token feature
(the paper's technique adapted to transformers — DESIGN.md §4/§5).
``reduced()`` produces the CPU smoke variant (≤2 layers, d_model ≤ 512,
≤4 experts) required for per-arch smoke tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

# block kinds
ATTN = "attn"  # full causal self-attention (GQA)
SWA = "swa"  # sliding-window causal self-attention
MLA = "mla"  # DeepSeek multi-head latent attention
MAMBA2 = "mamba2"
MLSTM = "mlstm"
SLSTM = "slstm"
SHARED_ATTN = "shared_attn"  # zamba2-style shared transformer block

# ffn kinds
FFN_SWIGLU = "swiglu"
FFN_GEGLU = "geglu"
FFN_MOE = "moe"
FFN_NONE = "none"


@dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert_ff: int
    n_shared: int = 0
    d_shared_ff: Optional[int] = None
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class MLASpec:
    kv_lora: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


@dataclass(frozen=True)
class SSMSpec:
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2


@dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    blocks: tuple[str, ...]  # length n_layers
    ffns: tuple[str, ...]  # length n_layers
    d_head: Optional[int] = None  # default d_model // n_heads
    window: int = 1024  # for SWA blocks
    rope_theta: float = 10000.0
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None
    ssm: SSMSpec = field(default_factory=SSMSpec)
    # enc-dec / multimodal stubs
    encoder_layers: int = 0  # whisper audio encoder depth
    n_audio_frames: int = 1500
    cross_attn_every: int = 0  # vlm: decoder layer i has cross-attn if (i+1)%k==0
    n_image_tokens: int = 1024
    # virtual tokens (the paper's mechanism, transformer form)
    n_virtual_tokens: int = 0
    d_virtual: int = 256
    # numerics / structure
    tie_embeddings: bool = True
    remat: bool = True
    remat_policy: str = "full"  # full | dots | none (hillclimb treatment)
    scan_layers: bool = True  # lax.scan over repeating layer groups
    q_chunk: int = 512
    ssd_chunk: int = 128
    # fused chunked softmax-xent: compute the LM head + CE in sequence chunks
    # of this many tokens instead of materialising fp32 (B,S,V) logits
    # (0 = off).  Beyond-paper §Perf treatment for the large-vocab archs.
    loss_chunk: int = 0
    # replicate (don't TP-shard) weights smaller than this many elements —
    # §Perf treatment: tiny TP shards cost full-activation collectives
    tp_min_weight: int = 0
    # skip FSDP (keep TP) for weights below this many elements — §Perf
    # treatment: FSDP on a contracting dim costs a full-activation all-reduce
    fsdp_min_weight: int = 0
    # per-batch-row MoE dispatch (GShard groups) — §Perf treatment: keeps the
    # dispatch buffers sharded instead of replicating a global argsort
    moe_grouped: bool = False
    source: str = ""  # citation

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def has_encoder(self) -> bool:
        return self.encoder_layers > 0

    def block_kind(self, i: int) -> str:
        return self.blocks[i]

    def has_cross(self, i: int) -> bool:
        if self.has_encoder:
            return True  # whisper decoder: cross-attn in every layer
        return self.cross_attn_every > 0 and (i + 1) % self.cross_attn_every == 0

    def sub_quadratic(self) -> bool:
        """True if no block needs an unbounded-length KV cache."""
        return all(b in (SWA, MAMBA2, MLSTM, SLSTM) for b in self.blocks)

    def long_context_variant(self) -> "ArchConfig":
        """Sliding-window variant used ONLY for long_500k on full-attention
        archs (DESIGN.md §5): every full-attention block becomes SWA-8192."""
        blocks = tuple(SWA if b in (ATTN, MLA, SHARED_ATTN) else b for b in self.blocks)
        mla = None if self.mla is not None else self.mla
        return dataclasses.replace(self, blocks=blocks, window=8192, mla=mla,
                                   name=self.name + "-swa")

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: 2 layers, d_model ≤ 512, ≤4 experts."""
        n_layers = min(2, self.n_layers)
        d_model = min(256, self.d_model)
        n_heads = min(4, self.n_heads)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        blocks = self.blocks[:n_layers]
        # keep kind diversity: make sure layer variety survives the truncation
        uniq = []
        for b in self.blocks:
            if b not in uniq:
                uniq.append(b)
        blocks = tuple((uniq + list(self.blocks))[:n_layers])
        ffns = []
        for i in range(n_layers):
            ffns.append(self.ffns[min(i, len(self.ffns) - 1)])
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, n_experts=4, top_k=min(2, self.moe.top_k),
                                      d_expert_ff=128, d_shared_ff=128 if self.moe.n_shared else None)
        mla = None
        if self.mla is not None:
            mla = MLASpec(kv_lora=64, d_nope=32, d_rope=16, d_v=32)
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv, d_head=64, d_ff=min(512, self.d_ff) if self.d_ff else 0,
            vocab=512, blocks=blocks, ffns=tuple(ffns), moe=moe, mla=mla,
            ssm=SSMSpec(d_state=16, head_dim=32, expand=2),
            encoder_layers=min(2, self.encoder_layers),
            n_audio_frames=16 if self.has_encoder else self.n_audio_frames,
            cross_attn_every=self.cross_attn_every and 2,
            n_image_tokens=16 if self.cross_attn_every else self.n_image_tokens,
            d_virtual=64, window=min(64, self.window),
            q_chunk=32, ssd_chunk=16, name=self.name + "-smoke",
        )


def uniform_blocks(kind: str, n: int) -> tuple[str, ...]:
    return tuple([kind] * n)


def pattern_blocks(pattern: list[str], n: int) -> tuple[str, ...]:
    return tuple(pattern[i % len(pattern)] for i in range(n))
