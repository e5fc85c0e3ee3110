"""Functional MLP over nested dicts of tensors (the reference's pytree
layout: a list of ``{"w": (d_in, d_out), "b": (d_out,)}`` layers).

The init functions draw from a CPU ``torch.Generator`` (so weights do not
depend on the device) and place them on ``device`` — CUDA by default,
raising without a GPU (``kernels.runtime.resolve_device``)."""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from repro_torch.kernels.runtime import resolve_device

Tensor = torch.Tensor


def _glorot(gen: torch.Generator, shape, device) -> Tensor:
    lim = math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return (u * (2 * lim) - lim).to(device)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, bias: bool = True,
                device=None):
    device = resolve_device(device)
    p = {"w": _glorot(gen, (d_in, d_out), device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def linear(params, x: Tensor) -> Tensor:
    y = x @ params["w"]
    if "b" in params:
        y = y + params["b"]
    return y


def silu(x: Tensor) -> Tensor:
    return F.silu(x)


def init_mlp(gen: torch.Generator, sizes: Sequence[int], *,
             final_bias: bool = True, device=None):
    """``sizes = [d_in, h1, ..., d_out]`` → list of linear params."""
    device = resolve_device(device)
    layers = []
    for i in range(len(sizes) - 1):
        last = i == len(sizes) - 2
        layers.append(init_linear(gen, sizes[i], sizes[i + 1],
                                  bias=(final_bias or not last), device=device))
    return layers


def mlp(params, x: Tensor, act: Callable = silu,
        final_act: Callable | None = None) -> Tensor:
    for i, layer in enumerate(params):
        x = linear(layer, x)
        if i < len(params) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def init_stacked_mlp(gen: torch.Generator, n_copies: int, sizes: Sequence[int],
                     **kw):
    """``n_copies`` independent MLPs, params stacked on a leading axis (the
    per-virtual-channel MLPs)."""
    per = [init_mlp(gen, sizes, **kw) for _ in range(n_copies)]
    return [{k: torch.stack([p[i][k] for p in per]) for k in per[0][i]}
            for i in range(len(per[0]))]
