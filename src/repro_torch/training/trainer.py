"""Single-device training loop for the registry's models.

:func:`build_train_step` returns ``train_step(params, opt_state, batch,
generator=None) → (params, opt_state, metrics)`` and ``eval_step(params,
batch) → masked MSE``.  The JAX trainer vmaps over the batch; here the
scenes of a batch run one after another through the same per-scene
forward (as ``Pipeline.predict_fn`` does), then the objective of all of
them at once (one batched MMD call, as the reference's vmapped kernel
call); their losses are weighted by the batch's ``sample_mask`` and one
backward pass runs over the weighted sum.  ``loss_scale`` multiplies the
loss before the backward and divides the gradients after it.
:func:`run_fit` is the epoch loop with validation-based early stopping
(the paper's protocol, Table IX).
"""
from __future__ import annotations

import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.training.losses import combined_objective
from repro_torch.training.optim import (Adam, AdamState, tree_leaves,
                                        tree_map)

Tensor = torch.Tensor


class TrainConfig(NamedTuple):
    lr: float = 5e-4
    weight_decay: float = 1e-12
    grad_clip: float = 10.0
    epochs: int = 100
    early_stop: int = 20
    lam_mmd: float = 0.0  # λ in Eq. 11 (0 ⇒ plain MSE)
    mmd_sigma: float = 1.5
    mmd_sample: Optional[int] = 3
    seed: int = 0
    # static loss scaling: the loss is multiplied by this before the
    # backward and the gradients divided after; metrics stay unscaled
    loss_scale: float = 1.0


def _batch_mean(values: Tensor, sample_mask: Optional[Tensor]) -> Tensor:
    """Mean over batch slots, weighted by the sample mask when present."""
    if sample_mask is None:
        return values.mean()
    w = sample_mask / torch.clamp(sample_mask.sum(), min=1.0)
    return (values * w).sum()


def _slots(batch):
    """``(graph, x_target, layout)`` of every slot of a batch."""
    g, lay = batch.graph, batch.layout
    for b in range(g.x.shape[0]):
        yield (GeometricGraph(*(a[b] for a in g)), batch.x_target[b],
               None if lay is None else tuple(a[b] for a in lay))


def build_train_step(apply_full: Callable, cfg_model, tc: TrainConfig,
                     opt: Adam):
    """``(train_step, eval_step)`` for ``apply_full(params, cfg, g,
    edge_layout=...) → (coords, aux)``."""
    use_kernel = bool(getattr(cfg_model, "use_kernel", False))
    scale = float(tc.loss_scale)

    def batch_loss(params, batch, generator):
        preds, zs = [], []
        for g, _, lay in _slots(batch):
            x_pred, aux = apply_full(params, cfg_model, g, edge_layout=lay)
            preds.append(x_pred)
            zs.append(aux["virtual"].z if "virtual" in aux else None)
        # the objective of every slot at once: one MMD call for the batch
        losses, parts = combined_objective(
            torch.stack(preds), batch.x_target, batch.graph.node_mask,
            None if zs[0] is None else torch.stack(zs), lam=tc.lam_mmd,
            sigma=tc.mmd_sigma, mmd_sample=tc.mmd_sample,
            generator=generator, use_kernel=use_kernel)
        sm = batch.sample_mask
        return _batch_mean(losses, sm), {k: _batch_mean(v, sm)
                                         for k, v in parts.items()}

    def train_step(params, opt_state: AdamState, batch, generator=None):
        work = tree_map(lambda p: p.detach().requires_grad_(True), params)
        flat: list = []
        tree_map(flat.append, work)  # leaves in tree_map order
        loss, parts = batch_loss(work, batch, generator)
        grads = torch.autograd.grad(loss * scale, flat, allow_unused=True)
        grads = iter([torch.zeros_like(p) if g is None
                      else (g / scale if scale != 1.0 else g)
                      for g, p in zip(grads, flat)])
        gtree = tree_map(lambda _: next(grads), work)
        params, opt_state = opt.update(gtree, opt_state, params)
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    @torch.no_grad()
    def eval_step(params, batch) -> Tensor:
        mses = []
        for g, target, lay in _slots(batch):
            x_pred, _ = apply_full(params, cfg_model, g, edge_layout=lay)
            err = ((x_pred - target) ** 2).sum(-1) * g.node_mask
            mses.append(err.sum() / torch.clamp(g.node_mask.sum(), min=1.0)
                        / 3.0)
        return _batch_mean(torch.stack(mses), batch.sample_mask)

    return train_step, eval_step


class FitResult(NamedTuple):
    params: Any
    best_val: float
    history: list
    wall_time: float


def batch_weight(batch) -> float:
    """The number of real samples in a batch — the weight of its per-batch
    mean in any across-batch aggregate (a mask-padded partial batch must
    not over-weight its few real samples)."""
    if batch.sample_mask is not None:
        return float(batch.sample_mask.sum())
    return float(batch.x_target.shape[0])


def run_fit(train_step: Callable, eval_step: Callable, params, opt_state,
            tc: TrainConfig, train_batches, val_batches,
            verbose: bool = False) -> FitResult:
    """The epoch loop: epochs + validation-based early stopping over any
    re-iterable batch source, per-batch means weighted by
    :func:`batch_weight`.  Without validation batches the train objective
    drives early stopping.  The MMD node sample is drawn from one
    ``torch.Generator`` seeded with ``tc.seed`` on the parameters'
    device."""
    dev = tree_leaves(params)[0].device
    gen = torch.Generator(device=dev).manual_seed(tc.seed)
    best_val, best_params, patience = float("inf"), params, 0
    history = []
    t0 = time.time()
    for epoch in range(tc.epochs):
        ep_loss, ep_w = 0.0, 0.0
        for batch in train_batches:
            params, opt_state, parts = train_step(params, opt_state, batch,
                                                  gen)
            w = batch_weight(batch)
            ep_loss += float(parts["loss"]) * w
            ep_w += w
        vals = [(float(eval_step(params, b)), batch_weight(b))
                for b in val_batches]
        if vals:
            val = float(np.average([v for v, _ in vals],
                                   weights=[w for _, w in vals]))
        else:
            val = ep_loss / max(ep_w, 1.0)
        history.append({"epoch": epoch,
                        "train_loss": ep_loss / max(ep_w, 1.0),
                        "val_mse": val})
        if verbose:
            print(f"epoch {epoch}: train {history[-1]['train_loss']:.5f} "
                  f"val {val:.5f}", flush=True)
        if val < best_val:
            best_val, best_params, patience = val, params, 0
        else:
            patience += 1
            if patience >= tc.early_stop:
                break
    return FitResult(params=best_params, best_val=best_val, history=history,
                     wall_time=time.time() - t0)


def fit(apply_full: Callable, cfg_model, params, train_batches, val_batches,
        tc: TrainConfig = TrainConfig(), verbose: bool = False) -> FitResult:
    opt = Adam(lr=tc.lr, weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)
    train_step, eval_step = build_train_step(apply_full, cfg_model, tc, opt)
    return run_fit(train_step, eval_step, params, opt.init(params), tc,
                   train_batches, val_batches, verbose=verbose)
