"""DeepSeek-V2-Lite-16B [arXiv:2405.04434]: 27L, d=2048, 16H, MLA kv_lora=512,
vocab 102400; MoE 64 routed (top-6) + 2 shared, d_expert_ff=1408; first layer
dense FFN (the release's actual layout)."""
from repro_torch.archs.config import (ArchConfig, MLASpec, MoESpec, FFN_MOE,
                                      FFN_SWIGLU, MLA, uniform_blocks)

_L = 27
CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    n_layers=_L,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,  # per routed expert
    vocab=102400,
    blocks=uniform_blocks(MLA, _L),
    ffns=tuple([FFN_SWIGLU] + [FFN_MOE] * (_L - 1)),
    mla=MLASpec(kv_lora=512, d_nope=128, d_rope=64, d_v=128),
    moe=MoESpec(n_experts=64, top_k=6, d_expert_ff=1408, n_shared=2),
    tie_embeddings=False,
    n_virtual_tokens=4,
    source="arXiv:2405.04434",
)
