"""Weight interchange with the JAX package.

The reference keeps parameters as a pytree of nested dicts and lists
(FastEGNN's ``embed``, ``s_init``, ``layers[i].phi1[0].w``, …; the LM's
``embed``, ``final_norm.scale``, ``layers[i].attn.wq``, ``vt[i].w_read``,
…); the port keeps the same structure with ``torch.Tensor`` leaves.

* :func:`params_from_jax` converts such a tree with numpy (or any
  array-like) leaves, every registry model's (0-d leaves such as linear's
  ``dt`` stay 0-d) — how the parity tests share weights;
* :func:`load_npz` reads a checkpoint written by the reference's
  ``save_checkpoint``, whose keys are the tree paths joined by ``/``
  (list positions as integers, e.g. ``layers/0/phi1/1/b``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.runtime import resolve_device


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    arr = np.asarray(tree)
    if np.issubdtype(arr.dtype, np.floating):
        arr = arr.astype(np.float32)
    # np.array, not np.ascontiguousarray: the latter makes a 0-d leaf
    # (linear's ``dt``) 1-d
    return torch.from_numpy(np.array(arr, order="C")).to(device)


def params_from_jax(tree, *, device=None):
    """Reference parameter pytree (array-like leaves) → the port's tree of
    float32 tensors on ``device`` (default CUDA)."""
    return _convert(tree, resolve_device(device))


def _listify(node):
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        idx = sorted(int(k) for k in node)
        if idx != list(range(len(idx))):
            raise ValueError(f"checkpoint list indices not contiguous: {idx}")
        return [node[str(i)] for i in idx]
    return node


def load_npz(path, *, device=None):
    """Read a reference checkpoint (``/``-joined key paths) into the port's
    parameter tree on ``device`` (default CUDA)."""
    tree: dict = {}
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if key == "__meta__":
                continue
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return params_from_jax(_listify(tree), device=device)
