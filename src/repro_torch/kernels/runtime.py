"""Device selection and the precision contract shared by every kernel.

There is no interpret mode: a kernel wrapper launches its CUDA kernel for
CUDA tensors and runs its plain PyTorch version only for CPU tensors.
:func:`resolve_device` is the one place an entry point turns its
``device`` argument into a ``torch.device``: the default is CUDA, and
asking for CUDA without a GPU raises instead of silently running on the
CPU.  It also turns TF32 off for f32 matmuls and convolutions — the f32
parity contract with the reference needs full-precision products.

Precision contract
------------------
:class:`Precision` is the static ``(compute, accumulate)`` dtype pair.
The FastEGNN kernels (edge, virtual, identity and panel paths) take
either, as the reference's Pallas kernels do (DESIGN.md §9.3): in
``'bf16'`` every product's operands are rounded to bfloat16 and every
sum runs in f32, on f32 inputs and outputs.  A plain path ignores the
flag and runs f32, as the reference's ``jnp`` path does.  The LM path
computes in bf16 by default with f32 accumulation: the sliding-window
attention kernel takes f32 or bf16 inputs and does its math in f32.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch


def align16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it if its data does not start on a 16-byte
    boundary (the kernels read some operands with 16-byte loads; a
    contiguous view into a larger tensor may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def pad_to(t: torch.Tensor, *shape: int) -> torch.Tensor:
    """``t`` zero-padded at the end of each dimension up to ``shape`` (a
    new contiguous tensor), or ``t`` itself if it has that shape."""
    if tuple(t.shape) == shape:
        return t
    out = t.new_zeros(shape)
    out[tuple(slice(0, k) for k in t.shape)] = t
    return out


def unpad(t: torch.Tensor, shape) -> torch.Tensor:
    """The leading ``shape`` block of a padded output (``t`` itself if it
    has that shape)."""
    if tuple(t.shape) == tuple(shape):
        return t
    return t[tuple(slice(0, k) for k in shape)].contiguous()


def backend_mode(device) -> str:
    """What a dispatched kernel path runs as on ``device``: ``'cuda'`` (the
    CUDA kernels) or ``'cpu'`` (the wrappers' plain versions) — the tag
    ``core.message_passing.dispatch_mode`` reports, where the reference
    reports ``'tpu'`` or ``'interpret'``."""
    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None``/``'cuda'``/``'cpu'``/``torch.device`` → ``torch.device``.

    ``None`` means CUDA.  A CUDA device without a GPU raises
    ``RuntimeError`` (no silent CPU fallback).  On CUDA, TF32 is switched
    off for matmuls and cuDNN so f32 products stay f32.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False — pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: expected 'cuda' or 'cpu'")
    return dev


class Precision(NamedTuple):
    """Static compute/accumulate dtype pair (dtype names, hashable)."""

    compute: str = "float32"
    accumulate: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute)

    @property
    def accumulate_dtype(self) -> torch.dtype:
        return getattr(torch, self.accumulate)


F32 = Precision("float32", "float32")
BF16 = Precision("bfloat16", "float32")

_PRECISIONS = {
    None: F32,
    "f32": F32, "float32": F32, "fp32": F32,
    "bf16": BF16, "bfloat16": BF16,
}


def resolve_precision(p: Union[str, Precision, None]) -> Precision:
    """``None``/``'f32'``/``'bf16'``/``Precision`` → :class:`Precision`;
    anything else raises ``ValueError``."""
    if isinstance(p, Precision):
        return p
    try:
        return _PRECISIONS[p]
    except KeyError:
        raise ValueError(
            f"unknown precision {p!r}: expected 'f32', 'bf16', or a "
            f"kernels.runtime.Precision") from None
