"""Adam/AdamW with global-norm clipping and a cosine schedule, over
parameter trees (nested dicts and lists of tensors, the layout of the JAX
package's pytrees).

The arithmetic follows the JAX package's ``training/optim.py`` step for
step: the moments first, then the bias corrections as f32 scalars from
``step``, then ``p - lr*(u + wd*p)``; clipping scales the gradients by
``min(1, grad_clip / (gnorm + 1e-9))``.  Updates are functional: new
tensors, the inputs are not modified.  The update runs leaf by leaf
(clip, moments, step), so besides the inputs only one leaf's
temporaries and the new parameters and moments exist at a time (no
clipped copy of the whole gradient tree).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch

Tensor = torch.Tensor


def tree_leaves(tree) -> list:
    """Leaves in the JAX package's order (dict keys sorted, lists in
    order)."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over matching leaves of ``tree`` and ``rest``; keeps the
    structure (dicts, lists, tuples, NamedTuples)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *vals) for vals in zip(tree, *rest)]
        return type(tree)(*out) if hasattr(tree, "_fields") else type(tree)(out)
    return fn(tree, *rest)


class AdamState(NamedTuple):
    step: Tensor  # () int32
    m: Any
    v: Any


def global_norm(tree) -> Tensor:
    """√(Σ leaf²) over every leaf, in f32."""
    return torch.sqrt(sum((x.to(torch.float32) ** 2).sum()
                          for x in tree_leaves(tree)))


#: the JAX package's name for :func:`global_norm`
optax_global_norm = global_norm


class Adam(NamedTuple):
    lr: float | Callable[[Tensor], Tensor] = 5e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-12  # the paper's default (Table IX)
    grad_clip: Optional[float] = None

    def init(self, params) -> AdamState:
        dev = tree_leaves(params)[0].device
        return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         m=tree_map(torch.zeros_like, params),
                         v=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: AdamState, params):
        step = state.step + 1
        scale = None
        if self.grad_clip is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        sf = step.to(torch.float32)
        f32 = lambda c: torch.tensor(c, dtype=torch.float32, device=sf.device)
        mh_c = 1.0 - f32(b1) ** sf
        vh_c = 1.0 - f32(b2) ** sf

        def upd(p, g, mm, vv):
            if scale is not None:
                g = g * scale
            mm = b1 * mm + (1 - b1) * g
            vv = b2 * vv + (1 - b2) * g * g
            u = (mm / mh_c) / (torch.sqrt(vv / vh_c) + self.eps)
            return p - lr * (u + self.weight_decay * p), mm, vv

        new = tree_map(upd, params, grads, state.m, state.v)
        part = lambda k: tree_map(lambda _, t: t[k], params, new)
        return part(0), AdamState(step=step, m=part(1), v=part(2))


def cosine_schedule(base_lr: float, warmup: int,
                    total: int) -> Callable[[Tensor], Tensor]:
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``."""

    def sched(step: Tensor) -> Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1.0 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return sched
