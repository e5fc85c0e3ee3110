"""Gemma3-12B [hf:google/gemma-3-1b-pt family]: 48L, d=3840, 16H (kv=8),
d_ff=15360, vocab 262144; 5 local (sliding 1024) : 1 global pattern, GeGLU."""
from repro_torch.archs.config import (ArchConfig, FFN_GEGLU, ATTN, SWA,
                                      pattern_blocks)

_L = 48
CONFIG = ArchConfig(
    name="gemma3-12b",
    arch_type="dense",
    n_layers=_L,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    d_head=256,
    d_ff=15360,
    vocab=262144,
    blocks=pattern_blocks([SWA, SWA, SWA, SWA, SWA, ATTN], _L),
    ffns=tuple([FFN_GEGLU] * _L),
    window=1024,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    n_virtual_tokens=4,  # global bridge across the 5:1 local windows
    source="hf:google/gemma-3-1b-pt",
)
