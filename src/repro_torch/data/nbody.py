"""Charged-particle N-body simulator (Kipf et al. 2018 / Satorras et al.
2021), the paper's first benchmark.

N charged particles (c_i ∈ {±1}) under softened Coulomb forces,
leapfrog-integrated; the task is to predict the positions Δ frames ahead
from the positions and velocities at the input frame.  Fully connected
graphs (r = ∞), Table VIII.  Same semantics and random stream as the
reference generator, so a seed gives the same samples bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class NBodySample(NamedTuple):
    x0: np.ndarray  # (N, 3) input positions
    v0: np.ndarray  # (N, 3) input velocities
    charges: np.ndarray  # (N, 1) ±1
    x1: np.ndarray  # (N, 3) target positions


def _coulomb_accel(x: np.ndarray, charges: np.ndarray,
                   softening: float = 0.3) -> np.ndarray:
    """Softened Coulomb: ``softening`` bounds close-encounter kicks, so the
    recorded velocities stay O(1)."""
    diff = x[:, None, :] - x[None, :, :]  # (N, N, 3)
    d2 = np.sum(diff**2, axis=-1) + softening
    inv_d3 = d2 ** (-1.5)
    np.fill_diagonal(inv_d3, 0.0)
    q = charges.reshape(-1)
    f = (q[:, None] * q[None, :] * inv_d3)[:, :, None] * diff
    return np.sum(f, axis=1)


def simulate_nbody(rng: np.random.Generator, n_nodes: int, n_steps: int,
                   dt: float = 0.005, box: float = 3.0,
                   substeps: int = 20
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Leapfrog trajectory → ``(traj_x (T, N, 3), traj_v (T, N, 3),
    charges (N, 1))``.  Each recorded frame advances ``substeps`` leapfrog
    steps, so a 10-frame prediction spans enough time for the forces to
    bend the trajectories away from ballistic motion."""
    # low initial speeds: the displacement over the task's frames is
    # force-dominated, so edge-free extrapolation cannot solve it
    x = rng.uniform(-box / 2, box / 2, (n_nodes, 3))
    v = rng.normal(0.0, 0.1, (n_nodes, 3))
    charges = rng.choice([-1.0, 1.0], (n_nodes, 1))
    xs, vs = [x.copy()], [v.copy()]
    a = _coulomb_accel(x, charges)
    for _ in range(n_steps - 1):
        for _ in range(substeps):
            v_half = v + 0.5 * dt * a
            x = x + dt * v_half
            a = _coulomb_accel(x, charges)
            v = v_half + 0.5 * dt * a
        xs.append(x.copy())
        vs.append(v.copy())
    return np.stack(xs), np.stack(vs), charges


def generate_nbody_dataset(n_samples: int, n_nodes: int = 100,
                           frame_in: int = 30, frame_out: int = 40,
                           seed: int = 0) -> list[NBodySample]:
    """The paper's setting: predict frame 40 from frame 30 (Δ = 10
    frames), one simulation a sample."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_samples):
        xs, vs, charges = simulate_nbody(rng, n_nodes, frame_out + 1)
        out.append(NBodySample(
            x0=xs[frame_in].astype(np.float32),
            v0=vs[frame_in].astype(np.float32),
            charges=charges.astype(np.float32),
            x1=xs[frame_out].astype(np.float32)))
    return out
