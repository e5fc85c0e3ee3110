"""The single-device forward surface of a built model.

``build_pipeline("fast_egnn", generator=..., device=..., **cfg)`` returns
a :class:`Pipeline` with ``cfg``, ``params``, ``device`` and
``predict_fn(params, graph(B,·), layout) -> (B, N, 3)``: the forward the
rollout engine and the serving plane compose.  ``layout`` is ``None`` or
the batch's CSR layout ``(indptr (B, N+1) int32, n_edges (B,))``.  The
scenes of a batch run one after another through the same per-scene
forward, so a batched prediction equals the per-scene ones by
construction.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.kernels.runtime import require_f32, resolve_device
from repro_torch.models.fast_egnn import (FastEGNNConfig, fast_egnn_apply,
                                          init_fast_egnn)

Tensor = torch.Tensor


class Pipeline:
    """A model's config, parameters, device and forward program."""

    def __init__(self, name: str, cfg: FastEGNNConfig, params,
                 device: torch.device):
        self.name = name
        self.cfg = cfg
        self.params = params
        self.device = device
        #: ``(params, graph(B,·), layout|None) -> (B, N, 3)`` predicted
        #: coordinates, run without autograd
        self.predict_fn: Callable = torch.no_grad()(self._predict)

    def _predict(self, params, g: GeometricGraph,
                 layout: Optional[tuple]) -> Tensor:
        out = []
        for b in range(g.x.shape[0]):
            gb = GeometricGraph(*(a[b] for a in g))
            lay = None if layout is None else (layout[0][b], layout[1][b])
            out.append(fast_egnn_apply(params, self.cfg, gb,
                                       edge_layout=lay)[0])
        return torch.stack(out)


def build_pipeline(name: str, *, generator: Optional[torch.Generator] = None,
                   params=None, device=None, **cfg_overrides) -> Pipeline:
    """``'fast_egnn'`` + config overrides → :class:`Pipeline` on ``device``
    (default CUDA).  Weights are ``params`` (e.g. from
    ``weights.params_from_jax``) or random draws from ``generator``."""
    if name != "fast_egnn":
        raise NotImplementedError(
            f"model {name!r}: the PyTorch port builds 'fast_egnn' only")
    dev = resolve_device(device)
    cfg = FastEGNNConfig(**cfg_overrides)
    require_f32(cfg.precision)
    if params is None:
        if generator is None:
            raise ValueError("build_pipeline needs params= or generator=")
        params = init_fast_egnn(generator, cfg, device=dev)
    return Pipeline(name, cfg, params, dev)
