"""Language-model training step: next-token CE + MoE aux loss + Adam.

The counterpart of the JAX package's ``training/lm.py``.  The loss runs
``archs.model.forward`` with ``use_kernel=False``: the attention kernel
has no backward (it refuses inputs that require grad), and the reference
differentiates its plain XLA attention too, so training differentiates the
port's plain attention on every device.  Compute is bf16 by default over
f32 master weights, as in the reference (``forward``'s ``dtype``); each
layer runs under ``cfg.remat_policy`` while autograd records.

Gradients come from ``torch.autograd.grad`` over the leaves of the
parameter tree; the update is the port's functional ``Adam``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.archs.config import ArchConfig
from repro_torch.archs.model import cast_params, forward, lm_head_weights
from repro_torch.training.optim import Adam, tree_leaves, tree_map

Tensor = torch.Tensor


def _nll(logits: Tensor, labels: Tensor) -> Tensor:
    """−log softmax(logits)[label] per position, in f32."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def lm_loss(params, cfg: ArchConfig, tokens: Tensor, labels: Tensor, *,
            audio: Optional[Tensor] = None, images: Optional[Tensor] = None,
            aux_weight: float = 0.01, dtype=torch.bfloat16):
    """(loss, {"nll", "aux"}): the mean next-token NLL plus ``aux_weight``
    × the MoE load-balance loss; ``dtype`` is the compute dtype handed to
    ``forward``.  ``cfg.loss_chunk > 0`` takes :func:`_lm_loss_chunked`."""
    if cfg.loss_chunk > 0:
        return _lm_loss_chunked(params, cfg, tokens, labels, audio=audio,
                                images=images, aux_weight=aux_weight,
                                dtype=dtype)
    logits, aux = forward(params, cfg, tokens, audio=audio, images=images,
                          dtype=dtype, use_kernel=False)
    nll = torch.mean(_nll(logits, labels.long()))
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def _chunk_nll(h: Tensor, head: Tensor, y: Tensor, m: Tensor) -> Tensor:
    """Σ of one chunk's masked NLL: h (B, ck, d) @ head (d, V) in the
    compute dtype, the softmax in f32."""
    return torch.sum(_nll((h @ head).to(torch.float32), y) * m)


def _lm_loss_chunked(params, cfg: ArchConfig, tokens: Tensor,
                     labels: Tensor, *, audio: Optional[Tensor] = None,
                     images: Optional[Tensor] = None,
                     aux_weight: float = 0.01, dtype=torch.bfloat16):
    """The fused chunked softmax-xent: the LM head and the cross-entropy
    run per sequence chunk of ``cfg.loss_chunk`` under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so
    forward and backward hold one (B, chunk, V) f32 slab at a time and
    never the (B, S, V) logits.  The tail is padded and masked; the chunk
    sums add up in chunk order, as the reference's ``lax.scan``.  The head
    reads the same compute-dtype copy of the weights as the layers (one
    cast of a tied embedding, one gradient in the compute dtype, as the
    dense loss has), where the reference casts the head again (XLA shares
    the copy)."""
    params = cast_params(params, dtype)
    hidden, aux = forward(params, cfg, tokens, audio=audio, images=images,
                          dtype=dtype, return_hidden=True, use_kernel=False)
    head = lm_head_weights(params, cfg, hidden.dtype)  # (d, V)
    b, s, _ = hidden.shape
    ck = min(cfg.loss_chunk, s)
    n_chunks = -(-s // ck)
    pad = n_chunks * ck - s
    labels = labels.long()
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
    valid = (torch.arange(n_chunks * ck, device=hidden.device) < s).to(
        torch.float32)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for h, y, m in zip(hidden.split(ck, 1), labels.split(ck, 1),
                       valid.split(ck)):
        total = total + checkpoint(_chunk_nll, h, head, y, m,
                                   use_reentrant=False)
    nll = total / (b * s)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def value_and_grad(params, cfg: ArchConfig, batch: dict, *,
                   dtype=torch.bfloat16):
    """(loss, parts, grads) of :func:`lm_loss` on ``batch`` ('tokens',
    'labels', optional 'audio' / 'images'); ``grads`` has ``params``'s
    structure (zeros where a leaf gets no gradient, as ``jax.grad``), and
    the loss and parts are detached."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(
        p.is_floating_point()), params)
    (loss, parts) = lm_loss(leaves, cfg, batch["tokens"], batch["labels"],
                            audio=batch.get("audio"),
                            images=batch.get("images"), dtype=dtype)
    flat = [p for p in tree_leaves(leaves) if p.requires_grad]
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    by_id = {id(p): g for p, g in zip(flat, got)}
    grads = tree_map(lambda p: torch.zeros_like(p)
                     if by_id.get(id(p)) is None else by_id[id(p)], leaves)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            grads)


def make_train_step(cfg: ArchConfig, opt: Adam, *,
                    dtype=torch.bfloat16) -> Callable:
    """(params, opt_state, batch) → (params, opt_state, metrics).

    ``batch`` is a dict with 'tokens', 'labels' (+ 'audio' / 'images' for
    the multimodal backbones); ``metrics`` holds 'loss', 'nll' and 'aux'
    as 0-d tensors.  The update is functional: new parameter and moment
    tensors, the inputs untouched."""

    def train_step(params, opt_state, batch):
        loss, parts, grads = value_and_grad(params, cfg, batch, dtype=dtype)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, dict(parts, loss=loss)

    return train_step
