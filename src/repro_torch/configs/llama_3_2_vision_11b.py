"""Llama-3.2-Vision-11B backbone [hf:meta-llama/Llama-3.2-11B-Vision]:
40L, d=4096, 32H (kv=8), d_ff=14336, vocab 128256; cross-attention image
layers every 5th layer.  ViT/projector frontend is a stub: cross layers
consume precomputed patch embeddings (n_image_tokens=1601→1024 padded)."""
from repro_torch.archs.config import (ArchConfig, FFN_SWIGLU, ATTN,
                                      uniform_blocks)

_L = 40
CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    n_layers=_L,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab=128256,
    blocks=uniform_blocks(ATTN, _L),
    ffns=tuple([FFN_SWIGLU] * _L),
    cross_attn_every=5,
    n_image_tokens=1601,
    rope_theta=500_000.0,
    tie_embeddings=False,
    n_virtual_tokens=4,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
