"""OLMoE-1B-7B [arXiv:2409.02060]: 16L, d=2048, 16H (kv=16), MoE 64e top-8,
d_expert_ff=1024, vocab 50304.  MoE FFN on every layer; full attention."""
from repro_torch.archs.config import (ArchConfig, MoESpec, FFN_MOE, ATTN,
                                      uniform_blocks)

_L = 16
CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    arch_type="moe",
    n_layers=_L,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,  # per-expert
    vocab=50304,
    blocks=uniform_blocks(ATTN, _L),
    ffns=tuple([FFN_MOE] * _L),
    moe=MoESpec(n_experts=64, top_k=8, d_expert_ff=1024),
    tie_embeddings=False,
    n_virtual_tokens=4,  # paper-technique bridge (DESIGN.md §5)
    source="arXiv:2409.02060",
)
