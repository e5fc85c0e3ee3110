"""Batched recursive rollout over Verlet neighbour lists (host rebuilds).

The model is fed its own output step after step, velocities re-estimated
by finite differences.  The neighbour list of each scene is built on the
host at ``r + skin`` (a Verlet list) and reused on the device until some
node has moved more than ``skin/2`` from the positions it was built at;
each step applies the exact radius-``r`` + drop-longest semantics as a
device-side mask over the list (:func:`_step_edge_masks`), so the model
sees the edge set a fresh build would give, whatever the rebuild schedule.

The step loop is a Python loop on the device; the skin check fetches one
scalar per step.  Frames stream to ``on_chunk`` at every rebuild boundary.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.data.radius_graph import (csr_indptr, pad_edges, pad_nodes,
                                           radius_graph,
                                           sort_edges_by_receiver)
from repro_torch.kernels.runtime import resolve_device

Tensor = torch.Tensor

_DIVERGED_MSG = ("batched rollout diverged: non-finite coordinates after step "
                 "{} — train the model, shorten the horizon, or bound the "
                 "dynamics with wrap_box")


def _resolve_rebuild_mode(rebuild_mode: str) -> str:
    """``'auto'`` → ``'host'``: the device cell-list rebuild is not ported."""
    if rebuild_mode not in ("auto", "device", "host"):
        raise ValueError(f"rebuild_mode must be 'auto', 'device' or 'host', "
                         f"got {rebuild_mode!r}")
    if rebuild_mode == "device":
        raise NotImplementedError(
            "rebuild_mode='device' needs the device cell-list build, which "
            "the PyTorch port does not have yet; use 'host' or 'auto'")
    return "host"


def _lexsort(keys: list[Tensor]) -> Tensor:
    """Permutation sorting by ``keys`` (last key primary), as chained
    stable sorts — ``torch`` has no ``lexsort``."""
    order = torch.argsort(keys[0], stable=True)
    for k in keys[1:]:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _step_edge_masks(x: Tensor, snd: Tensor, rcv: Tensor, em: Tensor,
                     r2: float, p: float) -> Tensor:
    """Per-step edge selection over the Verlet candidate list (bool, (E,)).

    Radius-``r`` filter at the current positions, then Sec. VII-B
    drop-longest: ``round((1−p)·n_valid)`` edges are kept by rank under the
    lexicographic key ``(d², receiver, sender)`` — the host path's stable
    tie-break as a pure function of edge identity, so the kept set does not
    depend on the storage order of the list.
    """
    snd, rcv = snd.long(), rcv.long()
    d = x[snd] - x[rcv]
    d2 = (d * d).sum(-1)
    valid = (em > 0) & (d2 <= r2)
    if p <= 0.0:
        return valid
    n_valid = valid.sum().to(torch.float32)
    n_keep = torch.round(torch.tensor(1.0 - p, dtype=torch.float32,
                                      device=x.device) * n_valid)
    key = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    order = _lexsort([snd, rcv, key])
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.shape[0], device=x.device)
    return valid & (rank < n_keep)


@dataclass
class BatchedRolloutResult:
    """Per-scene trajectories (real nodes only) plus the engine's counts.

    ``rebuild_count`` is batch-global (one rebuild covers every scene);
    host rebuilds block the batch, so every rebuild is a ``rebuild_wait``.
    ``steady_state_d2h_bytes`` counts the per-step skin-check fetches.
    There is no compilation, so ``recompiles`` is 0.
    """

    trajectories: list  # per real scene: (n_steps, n_j, 3) float32
    n_steps: int
    n_scenes: int
    batch_size: int
    rebuild_count: int
    rebuild_steps: list = field(default_factory=list)
    chunk_calls: int = 0
    recompiles: int = 0
    steady_state_d2h_bytes: int = 0
    rebuild_mode: str = "host"
    rebuild_waits: int = 0
    rebuild_s: float = 0.0


class BatchedRolloutEngine:
    """Rollout of 1..``batch_size`` same-capacity scenes stepping together.

    Every scene is padded to the pinned ``(node_cap, edge_cap)`` bucket.
    The skin criterion is reduced over the batch (any scene past its
    budget ends the chunk), so a rebuild covers all scenes.  A short batch
    pads its slots with replicas of the last scene; replicas compute the
    same trajectory and are dropped from the result.  The per-step masks
    make each scene's trajectory independent of the rebuild schedule, so a
    batched run equals single-scene runs at the same capacities.

    ``predict_fn(params, graph(B,·), layout) -> (B, N, 3)`` is the model
    (``Pipeline.predict_fn``); the engine hands it each scene's CSR layout
    ``(indptr, n_edges)``, built with every Verlet list.
    """

    def __init__(self, predict_fn: Callable, *, batch_size: int,
                 node_cap: int, edge_cap: int, r: float, skin: float,
                 dt: float, drop_rate: float = 0.0,
                 wrap_box: Optional[float] = None,
                 rebuild_mode: str = "auto", device=None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if skin < 0:
            raise ValueError(f"skin must be >= 0, got {skin}")
        if wrap_box is not None and not wrap_box > 0:
            raise ValueError(f"wrap_box must be > 0, got {wrap_box}")
        self.predict_fn = predict_fn
        self.batch_size = int(batch_size)
        self.node_cap = int(node_cap)
        self.edge_cap = int(edge_cap)
        self.r = float(r)
        self.skin = float(skin)
        self.dt = float(dt)
        self.drop_rate = float(drop_rate)
        self.wrap_box = None if wrap_box is None else float(wrap_box)
        self.rebuild_mode = _resolve_rebuild_mode(rebuild_mode)
        self.device = resolve_device(device)
        self._g: Optional[GeometricGraph] = None
        self._lay = None

    @property
    def traces(self) -> int:
        """Program traces: none — PyTorch runs eagerly."""
        return 0

    # ------------------------------------------------------------- host side
    def _host_build_scene(self, x_np: np.ndarray) -> dict:
        """One scene's Verlet list (+ CSR layout) at the pinned capacities."""
        snd, rcv = radius_graph(x_np, self.r + self.skin)
        snd, rcv = sort_edges_by_receiver(snd, rcv)
        sp, rp, em = pad_edges(snd, rcv, self.edge_cap, x_np)
        n_edges = int(np.count_nonzero(em))
        return dict(senders=sp, receivers=rp, edge_mask=em,
                    indptr=csr_indptr(rp, n_edges, self.node_cap),
                    n_edges=n_edges)

    def _build_scenes(self, scene_x: list) -> list:
        # sequential: the numpy build holds the GIL, threads gain nothing
        return [self._host_build_scene(x) for x in scene_x]

    def _install(self, builds: list, slot_src: list) -> None:
        """Upload per-scene builds as the stacked edge operands; padding
        slots replicate the last real scene."""
        dev = self.device
        stack = lambda key: torch.from_numpy(
            np.stack([builds[j][key] for j in slot_src])).to(dev)
        self._g = self._g._replace(senders=stack("senders"),
                                   receivers=stack("receivers"),
                                   edge_mask=stack("edge_mask"))
        n_edges = torch.tensor([builds[j]["n_edges"] for j in slot_src],
                               device=dev)
        self._lay = (stack("indptr"), n_edges)

    # ----------------------------------------------------------- device side
    def _step(self, params, x: Tensor, v: Tensor) -> tuple[Tensor, Tensor]:
        g = self._g
        r2 = float(np.float32(self.r) ** 2)
        keep = torch.stack([
            _step_edge_masks(x[b], g.senders[b], g.receivers[b],
                             g.edge_mask[b], r2, self.drop_rate)
            for b in range(self.batch_size)])
        gi = g._replace(x=x, v=v, edge_mask=keep.to(torch.float32))
        xp = self.predict_fn(params, gi, self._lay)
        xp = torch.where(g.node_mask[..., None] > 0, xp,
                         torch.zeros_like(xp))
        if self.wrap_box is not None:
            b = self.wrap_box
            xp = xp - b * torch.floor(xp / b)
        return xp, (xp - x) / self.dt

    # ------------------------------------------------------------------- run
    @torch.no_grad()
    def run(self, params, scenes, n_steps: int, *,
            on_chunk: Optional[Callable] = None) -> BatchedRolloutResult:
        """Roll 1..``batch_size`` scenes ``(x0, v0, h)`` forward together.

        ``on_chunk(start_step, frames)`` streams: after every chunk (the
        steps between two rebuilds) it gets the ``(n_scenes, k, node_cap,
        3)`` block of new positions for steps ``start..start+k``.
        """
        n_steps = int(n_steps)
        if n_steps <= 0:
            raise ValueError(f"n_steps must be positive, got {n_steps}")
        scenes = list(scenes)
        if not 1 <= len(scenes) <= self.batch_size:
            raise ValueError(
                f"got {len(scenes)} scenes for a batch_size="
                f"{self.batch_size} engine (need 1..{self.batch_size})")
        n_real = len(scenes)
        slot_src = list(range(n_real)) + [n_real - 1] * (self.batch_size
                                                         - n_real)
        xs, vs, hs, ns, nms = [], [], [], [], []
        for (x0, v0, h) in scenes:
            x0 = np.asarray(x0, np.float32)
            if self.wrap_box is not None:
                b = np.float32(self.wrap_box)
                x0 = x0 - b * np.floor(x0 / b)
            n = x0.shape[0]
            if n > self.node_cap:
                raise ValueError(
                    f"scene has {n} nodes but this engine's capacity bucket "
                    f"is node_cap={self.node_cap} — route it to a larger "
                    f"bucket")
            xp, nm = pad_nodes(x0, self.node_cap)
            xs.append(xp)
            vs.append(pad_nodes(np.asarray(v0, np.float32), self.node_cap)[0])
            hs.append(pad_nodes(np.asarray(h, np.float32), self.node_cap)[0])
            nms.append(nm)
            ns.append(n)
        dev = self.device
        up = lambda arrs: torch.from_numpy(
            np.stack([arrs[j] for j in slot_src])).to(dev)
        b_, e_ = self.batch_size, self.edge_cap
        self._g = GeometricGraph(
            x=up(xs), v=up(vs), h=up(hs),
            senders=torch.zeros((b_, e_), dtype=torch.int32, device=dev),
            receivers=torch.zeros((b_, e_), dtype=torch.int32, device=dev),
            edge_attr=torch.zeros((b_, e_, 0), dtype=torch.float32,
                                  device=dev),
            node_mask=up(nms),
            edge_mask=torch.zeros((b_, e_), dtype=torch.float32, device=dev))
        self._install(self._build_scenes([xs[j][:ns[j]]
                                          for j in range(n_real)]), slot_src)

        lim2 = float(np.float32((0.5 * self.skin) ** 2))
        nm = self._g.node_mask
        x, v = self._g.x, self._g.v
        ref = x
        done = chunk_calls = waits = steady = 0
        rebuild_s = 0.0
        rebuild_steps: list[int] = []
        parts: list[np.ndarray] = []
        while done < n_steps:
            chunk_calls += 1
            block = []
            while done + len(block) < n_steps:
                if block:  # the chunk's loop condition (x == ref at k = 0)
                    d2 = ((x - ref) ** 2).sum(-1) * nm
                    steady += 1
                    if not bool(d2.max() <= lim2):
                        break
                x, v = self._step(params, x, v)
                block.append(x)
            new = torch.stack(block, 1).cpu().numpy()
            parts.append(new)
            if on_chunk is not None:
                on_chunk(done, new[:n_real])
            done += len(block)
            if done >= n_steps:
                break
            t0 = time.perf_counter()
            x_np = x.cpu().numpy()
            scene_x = [x_np[j, :ns[j]] for j in range(n_real)]
            if not all(np.isfinite(sx).all() for sx in scene_x):
                raise FloatingPointError(_DIVERGED_MSG.format(done))
            self._install(self._build_scenes(scene_x), slot_src)
            rebuild_s += time.perf_counter() - t0
            waits += 1
            ref = x
            rebuild_steps.append(done)
        full = np.concatenate(parts, axis=1)
        return BatchedRolloutResult(
            trajectories=[full[j, :n_steps, :ns[j]] for j in range(n_real)],
            n_steps=n_steps, n_scenes=n_real, batch_size=self.batch_size,
            rebuild_count=len(rebuild_steps), rebuild_steps=rebuild_steps,
            chunk_calls=chunk_calls, steady_state_d2h_bytes=steady,
            rebuild_mode=self.rebuild_mode, rebuild_waits=waits,
            rebuild_s=rebuild_s)
