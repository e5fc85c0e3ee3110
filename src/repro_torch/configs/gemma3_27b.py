"""Gemma3-27B [hf:google/gemma-3-1b-pt family]: 62L, d=5376, 32H (kv=16),
d_ff=21504, vocab 262144; 5:1 local:global sliding pattern."""
from repro_torch.archs.config import (ArchConfig, FFN_GEGLU, ATTN, SWA,
                                      pattern_blocks)

_L = 62
CONFIG = ArchConfig(
    name="gemma3-27b",
    arch_type="dense",
    n_layers=_L,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    d_head=128,
    d_ff=21504,
    vocab=262144,
    blocks=pattern_blocks([SWA, SWA, SWA, SWA, SWA, ATTN], _L),
    ffns=tuple([FFN_GEGLU] * _L),
    window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    n_virtual_tokens=4,
    source="hf:google/gemma-3-1b-pt",
)
