"""Config registry: ``get_arch(name)`` + the assigned input shapes.

All ten configs are ported, each a copy of the JAX package's field by
field: the attention family — gemma3-12b / 27b (GQA + sliding window,
GeGLU), olmoe-1b-7b (MoE), deepseek-v2-lite-16b (MLA + MoE with shared
experts), granite-20b (MQA), llama3-405b (GQA), whisper-small (audio
encoder + cross-attention) and llama-3.2-vision-11b (image cross-attention
every 5th layer) — whose attention runs the hand-written attention kernel
on the card; and the recurrent family — xlstm-125m (mLSTM, sLSTM at
layers 1, 4, 7, 10) and zamba2-1.2b (Mamba2, with a shared attention block
every 6th layer that runs the attention kernel).
"""
from __future__ import annotations

import importlib
from typing import NamedTuple

from repro_torch.archs.config import ArchConfig

_ARCH_IDS = [
    "olmoe_1b_7b",
    "gemma3_12b",
    "xlstm_125m",
    "deepseek_v2_lite_16b",
    "whisper_small",
    "llama3_405b",
    "zamba2_1_2b",
    "llama_3_2_vision_11b",
    "gemma3_27b",
    "granite_20b",
]

# canonical dashed ids (CLI) → module names
ALIASES = {i.replace("_", "-"): i for i in _ARCH_IDS}
ALIASES.update({i: i for i in _ARCH_IDS})
# spec-sheet ids
ALIASES.update({
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "zamba2-1.2b": "zamba2_1_2b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
})

ARCH_NAMES = sorted(ALIASES)


def get_arch(name: str) -> ArchConfig:
    mod = ALIASES[name]
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


class InputShape(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
