"""Granite-20B-Code [arXiv:2405.04324]: 52L, d=6144, 48H with MQA (kv=1),
d_ff=24576, vocab 49152; llama-style decoder."""
from repro_torch.archs.config import (ArchConfig, FFN_SWIGLU, ATTN,
                                      uniform_blocks)

_L = 52
CONFIG = ArchConfig(
    name="granite-20b",
    arch_type="dense",
    n_layers=_L,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_head=128,
    d_ff=24576,
    vocab=49152,
    blocks=uniform_blocks(ATTN, _L),
    ffns=tuple([FFN_SWIGLU] * _L),
    tie_embeddings=True,
    n_virtual_tokens=4,
    source="arXiv:2405.04324",
)
