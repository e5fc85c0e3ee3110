"""Zamba2-1.2B [arXiv:2411.15242]: 38 Mamba2 layers (d=2048, ssm_state=64)
with a SHARED attention+MLP block invoked every 6th layer (concat[x, x0]
input, per-invocation down-projection); 32H, d_ff=8192 (shared block MLP)."""
from repro_torch.archs.config import (ArchConfig, SSMSpec, FFN_NONE, MAMBA2,
                                      SHARED_ATTN)

_L = 38
_blocks = tuple(SHARED_ATTN if (i + 1) % 6 == 0 else MAMBA2 for i in range(_L))
CONFIG = ArchConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    n_layers=_L,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    blocks=_blocks,
    ffns=tuple([FFN_NONE] * _L),
    ssm=SSMSpec(d_state=64, head_dim=64, expand=2),
    tie_embeddings=True,
    n_virtual_tokens=4,
    source="arXiv:2411.15242",
)
