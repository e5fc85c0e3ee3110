"""Synthetic protein-backbone dynamics, the stand-in for the AdK MD
benchmark (Table I's Protein Dynamics: a 10 Å cutoff).

A self-avoiding random-walk backbone (bond length ≈ 3.8 Å, as Cα traces)
moved by a smooth, spatially correlated displacement field and relaxed
towards its bond lengths; consecutive samples form one trajectory.  Same
semantics and random stream as the reference generator, so a seed gives
the same samples bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ProteinSample(NamedTuple):
    x0: np.ndarray
    v0: np.ndarray
    h: np.ndarray  # residue type, one-hot over 4
    x1: np.ndarray


def _make_chain(rng: np.random.Generator, n_res: int,
                bond: float = 3.8) -> np.ndarray:
    """A persistent random walk pulled towards its centroid: a compact,
    globule-like chain."""
    x = np.zeros((n_res, 3))
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    for i in range(1, n_res):
        centroid = x[:i].mean(axis=0)
        pull = centroid - x[i - 1]
        pn = np.linalg.norm(pull) + 1e-9
        step = 0.7 * d + 0.3 * rng.normal(size=3) + 0.05 * pull / pn
        step /= np.linalg.norm(step) + 1e-9
        x[i] = x[i - 1] + bond * step
        d = step
    return x


def _smooth_field(rng: np.random.Generator, x: np.ndarray, scale: float,
                  n_modes: int = 8) -> np.ndarray:
    """A spatially smooth random vector field: a sum of low-frequency
    Fourier modes."""
    out = np.zeros_like(x)
    extent = np.ptp(x, axis=0).max() + 1e-9
    for _ in range(n_modes):
        k = rng.normal(size=3) * (2 * np.pi / extent)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.normal(size=3)
        out += np.sin(x @ k + phase)[:, None] * amp
    return scale * out / np.sqrt(n_modes)


def generate_protein_dataset(n_samples: int, n_res: int = 256,
                             seed: int = 0,
                             disp_scale: float = 0.8) -> list[ProteinSample]:
    """``n_samples`` consecutive frames of one chain of ``n_res`` residues;
    each target is its frame moved by the field and relaxed by two Jacobi
    sweeps towards the 3.8 Å bond length."""
    rng = np.random.default_rng(seed)
    chain = _make_chain(rng, n_res)
    feats = rng.integers(0, 4, n_res)
    h = np.eye(4, dtype=np.float32)[feats]
    out = []
    x = chain.copy()
    for _ in range(n_samples):
        vel = _smooth_field(rng, x, disp_scale)
        x1 = x + vel
        for _ in range(2):
            db = np.diff(x1, axis=0)
            ln = np.linalg.norm(db, axis=-1, keepdims=True) + 1e-9
            corr = 0.5 * (ln - 3.8) * db / ln
            x1[:-1] += corr
            x1[1:] -= corr
        out.append(ProteinSample(x0=x.astype(np.float32),
                                 v0=vel.astype(np.float32), h=h,
                                 x1=x1.astype(np.float32)))
        x = x1
    return out
