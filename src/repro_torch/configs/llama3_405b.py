"""Llama-3 405B [arXiv:2407.21783]: 126L, d=16384, 128H (GQA kv=8),
d_ff=53248, vocab 128256, rope 500k."""
from repro_torch.archs.config import (ArchConfig, FFN_SWIGLU, ATTN,
                                      uniform_blocks)

_L = 126
CONFIG = ArchConfig(
    name="llama3-405b",
    arch_type="dense",
    n_layers=_L,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_head=128,
    d_ff=53248,
    vocab=128256,
    blocks=uniform_blocks(ATTN, _L),
    ffns=tuple([FFN_SWIGLU] * _L),
    rope_theta=500_000.0,
    tie_embeddings=False,
    n_virtual_tokens=4,
    source="arXiv:2407.21783",
)
