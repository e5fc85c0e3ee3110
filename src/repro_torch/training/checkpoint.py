"""Checkpoints: parameter / optimizer-state trees ↔ ``.npz``.

The key scheme is the JAX package's (``training/checkpoint.py``): the
path to each leaf joined by ``/`` — dict keys, list positions as
integers, NamedTuple field names (``layers/0/phi1/1/b``, ``m/embed/0/w``)
— plus a JSON ``__meta__`` entry.  A file written by either package loads
in the other.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict[str, Any]:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, tree: Any, metadata: dict | None = None) -> None:
    """Write ``tree`` and ``metadata`` to ``path`` as an uncompressed
    ``.npz`` (the reference writes a compressed one; ``np.load`` reads
    either, so both packages load both.  Deflating an LM's parameters and
    Adam moments, gigabytes of floats that barely compress, would take
    minutes on one core)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    np.savez(path, __meta__=json.dumps(metadata or {}), **flat)


def _rebuild(like, flat: dict, prefix: str = ""):
    key = lambda k: f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, key(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, flat, key(f))
                            for f, v in zip(like._fields, like)))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, key(i)) for i, v in enumerate(like))
    arr = flat[prefix]
    if arr.shape != tuple(np.shape(like)):
        raise ValueError(f"shape mismatch at {prefix}: {arr.shape} vs "
                         f"{tuple(np.shape(like))}")
    if isinstance(like, torch.Tensor):
        # np.array, not np.ascontiguousarray: the latter makes a 0-d leaf
        # (AdamState.step) 1-d
        return torch.from_numpy(np.array(arr, order="C")).to(
            device=like.device, dtype=like.dtype)
    return arr


def restore_checkpoint(path: str, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like`` (a template tree; tensor
    leaves give the device and dtype) → ``(tree, metadata)``."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = {k: data[k] for k in data.files if k != "__meta__"}
    template = _flatten(like)
    missing = set(template) - set(flat)
    extra = set(flat) - set(template)
    if missing or extra:
        raise ValueError(f"checkpoint mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    return _rebuild(like, flat), meta
