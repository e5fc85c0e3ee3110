"""xLSTM-125M [arXiv:2405.04517]: 12L, d=768, 4H, vocab 50304, d_ff=0
(blocks carry their own projections).  sLSTM at positions {1, 4, 7, 10},
mLSTM elsewhere (the paper's mixed [7:1]-style stack at small scale)."""
from repro_torch.archs.config import ArchConfig, FFN_NONE, MLSTM, SLSTM

_L = 12
_blocks = tuple(SLSTM if i % 3 == 1 else MLSTM for i in range(_L))
CONFIG = ArchConfig(
    name="xlstm-125m",
    arch_type="ssm",
    n_layers=_L,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    blocks=_blocks,
    ffns=tuple([FFN_NONE] * _L),
    tie_embeddings=True,
    n_virtual_tokens=4,  # psum-shared global state bridge (attention-free)
    source="arXiv:2405.04517",
)
