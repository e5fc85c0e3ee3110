"""Whisper-small backbone [arXiv:2212.04356]: enc-dec, 12+12L, d=768, 12H,
d_ff=3072, vocab 51865.  Mel/conv frontend is a stub: the encoder consumes
precomputed frame embeddings (n_audio_frames=1500)."""
from repro_torch.archs.config import (ArchConfig, FFN_SWIGLU, ATTN,
                                      uniform_blocks)

_L = 12
CONFIG = ArchConfig(
    name="whisper-small",
    arch_type="audio",
    n_layers=_L,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    blocks=uniform_blocks(ATTN, _L),
    ffns=tuple([FFN_SWIGLU] * _L),
    encoder_layers=12,
    n_audio_frames=1500,
    tie_embeddings=True,
    n_virtual_tokens=4,
    source="arXiv:2212.04356",
)
