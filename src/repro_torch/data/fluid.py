"""SPH-like falling-fluid simulator — the stand-in for Water-3D (7.8K
particles) and Fluid113K (113K particles) scenes.

A weakly-compressible SPH-style integrator: gravity, pressure repulsion
between neighbours (cell list), velocity damping and box-boundary
reflection.  Same semantics and random stream as the reference generator.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.data.radius_graph import radius_graph


class FluidSample(NamedTuple):
    x0: np.ndarray
    v0: np.ndarray
    h: np.ndarray  # per-particle feature (constant 1s — water is homogeneous)
    x1: np.ndarray


def _pressure_accel(x: np.ndarray, r: float, stiffness: float) -> np.ndarray:
    snd, rcv = radius_graph(x, r)
    acc = np.zeros_like(x)
    if snd.size == 0:
        return acc
    diff = x[rcv] - x[snd]
    d = np.sqrt(np.sum(diff**2, axis=-1)) + 1e-9
    # cubic-spline-ish repulsion: force ∝ (1 - d/r)² along the pair axis
    mag = stiffness * (1.0 - d / r) ** 2
    f = diff / d[:, None] * mag[:, None]
    np.add.at(acc, rcv, f)
    return acc


def simulate_fluid(rng: np.random.Generator, n_particles: int, n_steps: int,
                   box: float = 1.0, r: float = 0.035, dt: float = 0.005,
                   stiffness: float = 20.0, damping: float = 0.02
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Fluid blob dropped into a box; returns (traj_x, traj_v), (T,N,3) each."""
    # lattice spacing ≈ 0.7·r gives ~12 neighbours per particle at r
    side = int(np.ceil(n_particles ** (1 / 3)))
    spacing = 0.7 * r
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)
    blob = side * spacing
    lo = np.clip(0.5 * (box - blob), 0.02 * box, None)
    x = grid[:n_particles] * spacing + np.array([lo, lo, max(lo, 0.5 * box)])
    x = x + rng.normal(0, 0.1 * spacing, x.shape)
    v = np.tile(rng.normal(0, 0.05, (1, 3)), (n_particles, 1))
    g = np.array([0.0, 0.0, -1.0])
    xs, vs = [x.copy()], [v.copy()]
    for _ in range(n_steps - 1):
        a = g + _pressure_accel(x, r, stiffness)
        v = (1.0 - damping) * v + dt * a
        x = x + dt * v
        for axis in range(3):  # reflecting boundaries
            low, high = x[:, axis] < 0.0, x[:, axis] > box
            x[low, axis] = -x[low, axis]
            v[low, axis] = -0.5 * v[low, axis]
            x[high, axis] = 2 * box - x[high, axis]
            v[high, axis] = -0.5 * v[high, axis]
        x = np.clip(x, 0.0, box)
        xs.append(x.copy())
        vs.append(v.copy())
    return np.stack(xs), np.stack(vs)


def generate_fluid_dataset(n_samples: int, n_particles: int = 512,
                           dt_frames: int = 15, warmup: int = 10,
                           seed: int = 0, **sim_kw) -> list[FluidSample]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_samples):
        xs, vs = simulate_fluid(rng, n_particles, warmup + dt_frames + 1,
                                **sim_kw)
        out.append(FluidSample(
            x0=xs[warmup].astype(np.float32),
            v0=vs[warmup].astype(np.float32),
            h=np.ones((n_particles, 1), np.float32),
            x1=xs[warmup + dt_frames].astype(np.float32),
        ))
    return out
