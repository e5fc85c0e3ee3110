"""Uniform model registry: explicit spec composition, no name magic.

Every entry is a :class:`ModelSpec` — a base model, or a base model
composed with the virtual-node plug-in by :func:`compose_virtual` (the
Sec. V "Fast" variants).  ``cfg_forced`` pins config fields whatever the
caller passes (plain RF / SchNet / TFN pin ``n_virtual=0``, so the name
fixes the family); ``cfg_defaults`` are overridable defaults (``fast_*``
default to ``n_virtual=3``, the paper's C).

Every config carries ``use_kernel``, and every apply routes its edge
aggregation through ``core.message_passing`` and its virtual pathway
through ``models.plugin``, so every entry runs the CUDA kernels where the
reference runs its Pallas kernels.  ``apply_full(params, cfg, graph, *,
edge_layout=None) -> (coords (N,3), aux)``; ``aux`` holds ``"h"`` and
``"virtual"`` where the reference's wrapper returns them (only FastEGNN
exposes its virtual state, so only its objective has an MMD term).
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, NamedTuple

from repro_torch.models import baselines, egnn, fast_egnn, rf, schnet, tfn


class ModelSpec(NamedTuple):
    make_config: Callable[..., Any]
    # init(generator, cfg, device=None) -> params
    init: Callable[..., Any]
    # apply_full(params, cfg, graph, *, edge_layout=None) -> (x, aux)
    apply_full: Callable[..., tuple]
    has_virtual: bool
    cfg_forced: dict = {}  # pinned config fields (override the caller)
    cfg_defaults: dict = {}  # overridable config defaults


def compose_virtual(base: ModelSpec, n_virtual: int = 3) -> ModelSpec:
    """Base model × virtual-node plug-in (Sec. V): unpins ``n_virtual``
    and defaults it to the paper's C = 3; init, apply and dispatch are the
    base spec's, whose apply runs the plug-in when ``n_virtual > 0``."""
    forced = {k: v for k, v in base.cfg_forced.items() if k != "n_virtual"}
    return base._replace(has_virtual=True, cfg_forced=forced,
                         cfg_defaults={**base.cfg_defaults,
                                       "n_virtual": n_virtual})


def _egnn_full(p, cfg, g, *, edge_layout=None):
    x, h = egnn.egnn_apply(p, cfg, g, edge_layout=edge_layout)
    return x, {"h": h}


def _rf_full(p, cfg, g, *, edge_layout=None):
    return rf.rf_apply(p, cfg, g, edge_layout=edge_layout), {}


def _schnet_full(p, cfg, g, *, edge_layout=None):
    x, h, _ = schnet.schnet_apply(p, cfg, g, edge_layout=edge_layout)
    return x, {"h": h}


def _tfn_full(p, cfg, g, *, edge_layout=None):
    x, h, _ = tfn.tfn_apply(p, cfg, g)
    return x, {"h": h}


def _linear_full(p, cfg, g, *, edge_layout=None):
    return baselines.linear_dyn_apply(p, cfg, g), {}


def _mpnn_full(p, cfg, g, *, edge_layout=None):
    return baselines.mpnn_apply(p, cfg, g, edge_layout=edge_layout), {}


_BASE: dict[str, ModelSpec] = {
    "linear": ModelSpec(baselines.LinearConfig, baselines.init_linear_dyn,
                        _linear_full, False),
    "mpnn": ModelSpec(baselines.MPNNConfig, baselines.init_mpnn, _mpnn_full,
                      False),
    "egnn": ModelSpec(egnn.EGNNConfig, egnn.init_egnn, _egnn_full, False),
    "rf": ModelSpec(rf.RFConfig, rf.init_rf, _rf_full, False,
                    cfg_forced={"n_virtual": 0}),
    "schnet": ModelSpec(schnet.SchNetConfig, schnet.init_schnet,
                        _schnet_full, False, cfg_forced={"n_virtual": 0}),
    "tfn": ModelSpec(tfn.TFNConfig, tfn.init_tfn, _tfn_full, False,
                     cfg_forced={"n_virtual": 0}),
}

REGISTRY: dict[str, ModelSpec] = dict(_BASE)
# FastEGNN has its own apply (ordered virtual nodes are structural, Sec. IV)
REGISTRY["fast_egnn"] = ModelSpec(fast_egnn.FastEGNNConfig,
                                  fast_egnn.init_fast_egnn,
                                  fast_egnn.fast_egnn_full, True)
# Sec. V plug-in variants: explicit base × virtual composition
for _name in ("rf", "schnet", "tfn"):
    REGISTRY[f"fast_{_name}"] = compose_virtual(_BASE[_name])


def model_config(name: str, **cfg_overrides) -> tuple[ModelSpec, Any]:
    """Registry name + overrides → ``(spec, cfg)``: the spec's defaults
    fill what the caller leaves out, its pinned fields win."""
    if name not in REGISTRY:
        raise KeyError(f"unknown model {name!r}; the registry has "
                       f"{sorted(REGISTRY)}")
    spec = REGISTRY[name]
    for k, v in spec.cfg_defaults.items():
        cfg_overrides.setdefault(k, v)
    cfg_overrides.update(spec.cfg_forced)
    return spec, spec.make_config(**cfg_overrides)


def resolve_model(name: str, generator, *, device=None, **cfg_overrides):
    """Registry name + overrides → ``(cfg, params, apply_full)``, the
    weights drawn from ``generator`` on ``device`` (default CUDA)."""
    spec, cfg = model_config(name, **cfg_overrides)
    return cfg, spec.init(generator, cfg, device=device), spec.apply_full


def make_model(name: str, generator, **cfg_overrides):
    """Deprecated: use ``repro_torch.pipeline.build_pipeline``.

    Kept as a thin shim with the historical contract — ``(cfg, params,
    apply_full)`` built by the pipeline factory (``device=`` passes
    through to it).
    """
    warnings.warn(
        "make_model is deprecated; use repro_torch.pipeline.build_pipeline "
        "(returns a Pipeline whose .cfg/.params/.apply_full match this "
        "shim's return)", DeprecationWarning, stacklevel=2)
    from repro_torch.pipeline import build_pipeline

    p = build_pipeline(name, generator=generator, **cfg_overrides)
    return p.cfg, p.params, p.apply_full
