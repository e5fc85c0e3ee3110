"""Recursive rollout over Verlet neighbour lists (DESIGN.md §10, §13).

The model is fed its own output step after step, velocities re-estimated
by finite differences.  Each scene's neighbour list is built at
``r + skin`` (a Verlet list) and reused until some node has moved more
than ``skin/2`` from the positions it was built at; each step applies the
exact radius-``r`` + drop-longest semantics as a device-side mask over the
list (:func:`_step_edge_masks`), so the model sees the edge set a fresh
build would give, whatever the rebuild schedule.

Where the lists are rebuilt is ``rebuild_mode``:

* ``'device'`` (what ``'auto'`` picks whenever ``r + skin`` is finite and
  asynchronous host builds were not asked for): the cell-list build of
  ``data/cell_list.py`` runs on the carried device coordinates, bitwise
  the host build at the same capacities, and the CSR layout is derived on
  the device.  Per rebuild only a ``(B, 4)`` int32 flag tensor (finite,
  overflow, edges found, densest cell) crosses to the host.  An overflow
  grows ``cell_cap`` and builds again on the device.
* ``'host'``: fetch the coordinates, run the numpy cell list, upload
  edges and CSR offsets.  The single-scene engine can submit that build
  early to :func:`~repro_torch.data.stream.shared_worker_pool` and keep
  stepping on the still-valid list (``async_rebuild``).

The step loop is a Python loop on the device with no host fetch in the
steady state (``steady_state_d2h_bytes`` is 0), as the reference's device
``while_loop`` chunk: the steps run in chunks on the current list, the
skin check before each step evaluated on the device, and one fetch of a
chunk's checks at its end finds the first that failed.  The steps from
there on were computed on a stale list and are dropped
(``discarded_steps``); the state before that step is rebuilt and stepped
on.  The steps kept are the computations the per-step check would run,
so trajectories do not depend on the chunking.  A chunk runs up to the
last interval between failed checks, then probes a quarter of it at a
time (doubling while the first interval is unknown).

:class:`DistRolloutEngine` is the same single-scene engine on one rank of
a DistEGNN mesh (DESIGN.md §11): each rank steps its shard of a frozen
partition, and the skin checks, the device build's flags and the final
trajectory are agreed over the group, so every rank stops, rebuilds and
returns alike.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.data.cell_list import (auto_cell_cap, cell_occupancy,
                                        device_csr, device_radius_build)
from repro_torch.data.radius_graph import (csr_indptr, pad_edges, pad_nodes,
                                           radius_graph,
                                           sort_edges_by_receiver,
                                           warn_edge_truncation)
from repro_torch.kernels.runtime import resolve_device

Tensor = torch.Tensor

#: extra edge capacity over the first build, absorbing density changes
#: across rebuilds (a breach truncates longest-first, with a warning)
DEFAULT_EDGE_HEADROOM = 1.25

_DIVERGED_MSG = ("{}rollout diverged: non-finite coordinates after step {} "
                 "— train the model, shorten the horizon, or bound the "
                 "dynamics with wrap_box")


def _resolve_rebuild_mode(rebuild_mode: str, r_build: float,
                          want_async: Optional[bool]) -> str:
    """``'auto'`` → ``'device'`` when the cell list is eligible.

    Eligible: a finite positive build radius (``r = inf`` is a fully
    connected graph, with no cells to exploit).  An explicit
    ``async_rebuild=True`` keeps the host path: a device rebuild is
    synchronous, with nothing to overlap.
    """
    if rebuild_mode not in ("auto", "device", "host"):
        raise ValueError(f"rebuild_mode must be 'auto', 'device' or 'host', "
                         f"got {rebuild_mode!r}")
    if rebuild_mode != "auto":
        return rebuild_mode
    if want_async is True or not (np.isfinite(r_build) and r_build > 0):
        return "host"
    return "device"


class _Telemetry:
    """The bytes an engine moves between host and device.

    ``coord_d2h`` counts coordinate fetches for host rebuilds and
    ``edge_h2d`` host-built edge and CSR uploads (both 0 in device mode);
    ``steady_d2h`` counts fetches inside the stepping (none: the skin
    checks are read once a chunk, at its boundary).  ``d2h`` / ``h2d``
    are the totals, the frames, checks and flags included.
    """

    def __init__(self):
        self.d2h = self.h2d = self.steady_d2h = 0
        self.coord_d2h = self.edge_h2d = 0

    def fetch(self, t: Tensor, steady: bool = False,
              coords: bool = False) -> np.ndarray:
        out = t.cpu().numpy()
        self.d2h += out.nbytes
        if steady:
            self.steady_d2h += out.nbytes
        if coords:
            self.coord_d2h += out.nbytes
        return out

    def uploaded(self, *arrays: np.ndarray, edges: bool = False) -> None:
        b = sum(int(a.nbytes) for a in arrays)
        self.h2d += b
        if edges:
            self.edge_h2d += b


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


class _VerletEngine:
    """What both engines share: the model step over ``batch_size`` slots,
    the skin check, and the host and device rebuilds with their
    accounting.  Subclasses set ``node_cap``, ``edge_cap`` and
    ``batch_size`` before the first build."""

    batch_size = 1
    node_cap: int
    edge_cap: int

    def __init__(self, predict_fn: Callable, *, r: float, skin: float,
                 dt: float, drop_rate: float, wrap_box: Optional[float],
                 rebuild_mode: str, want_async: Optional[bool],
                 cell_cap: Optional[int], device):
        if skin < 0:
            raise ValueError(f"skin must be >= 0, got {skin}")
        if wrap_box is not None and not wrap_box > 0:
            raise ValueError(f"wrap_box must be > 0, got {wrap_box}")
        self.predict_fn = predict_fn
        self.r = float(r)
        self.skin = float(skin)
        self.dt = float(dt)
        self.drop_rate = float(drop_rate)
        self.wrap_box = None if wrap_box is None else float(wrap_box)
        self.rebuild_mode = _resolve_rebuild_mode(
            rebuild_mode, self.r + self.skin, want_async)
        self.device = resolve_device(device)
        self._cell_cap = cell_cap
        self._cell_overflows = 0
        self._rebuild_s = 0.0
        self._tel = _Telemetry()
        self._g: Optional[GeometricGraph] = None
        self._lay = None
        # steps between the last two failed skin checks (chunk sizing)
        self._interval: Optional[int] = None
        self._discarded = 0

    @property
    def traces(self) -> int:
        """Program traces: none — PyTorch runs eagerly."""
        return 0

    # ------------------------------------------------------------- host side
    def _host_build_scene(self, x_np: np.ndarray, edges=None) -> dict:
        """One scene's Verlet list (+ CSR layout) at the pinned capacities,
        from ``edges`` (its radius graph at ``r + skin``, when already
        built); numpy only, so a worker thread may run it."""
        snd, rcv = (radius_graph(x_np, self.r + self.skin) if edges is None
                    else edges)
        snd, rcv = sort_edges_by_receiver(snd, rcv)
        sp, rp, em = pad_edges(snd, rcv, self.edge_cap, x_np)
        n_edges = int(np.count_nonzero(em))
        return dict(senders=sp, receivers=rp, edge_mask=em,
                    indptr=csr_indptr(rp, n_edges, self.node_cap),
                    n_edges=np.int32(n_edges))

    def _install(self, builds: list, slot_src: list) -> None:
        """Upload per-scene host builds as the stacked edge operands;
        slot ``b`` takes ``builds[slot_src[b]]``."""
        arrs = {k: np.stack([builds[j][k] for j in slot_src])
                for k in ("senders", "receivers", "edge_mask", "indptr",
                          "n_edges")}
        self._tel.uploaded(*arrs.values(), edges=True)
        up = {k: torch.from_numpy(a).to(self.device) for k, a in arrs.items()}
        self._g = self._g._replace(senders=up["senders"],
                                   receivers=up["receivers"],
                                   edge_mask=up["edge_mask"])
        self._lay = (up["indptr"], up["n_edges"])

    def _load(self, scenes: list, slot_src: list,
              wrap: bool = True) -> tuple[list, list]:
        """Wrap (unless ``wrap`` is off: already wrapped), pad and upload
        the scenes' ``(x0, v0, h)`` as the slots' state, with empty edge
        lists.  Returns the real node counts and the f32 (wrapped)
        starting coordinates of each scene."""
        xs, vs, hs, ns, nms = [], [], [], [], []
        for (x0, v0, h) in scenes:
            x0 = np.asarray(x0, np.float32)
            if wrap and self.wrap_box is not None:
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
        stacked = [np.stack([a[j] for j in slot_src])
                   for a in (xs, vs, hs, nms)]
        self._tel.uploaded(*stacked)
        x, v, h, nm = (torch.from_numpy(a).to(self.device) for a in stacked)
        b_, e_, dev = self.batch_size, self.edge_cap, self.device
        self._g = GeometricGraph(
            x=x, v=v, h=h,
            senders=torch.zeros((b_, e_), dtype=torch.int32, device=dev),
            receivers=torch.zeros((b_, e_), dtype=torch.int32, device=dev),
            edge_attr=torch.zeros((b_, e_, 0), dtype=torch.float32,
                                  device=dev),
            node_mask=nm,
            edge_mask=torch.zeros((b_, e_), dtype=torch.float32, device=dev))
        return ns, [xs[j][:ns[j]] for j in range(len(scenes))]

    # ----------------------------------------------------------- device side
    def _device_build(self, x: Tensor):
        db = device_radius_build(x, self._g.node_mask,
                                 r_build=self.r + self.skin,
                                 edge_cap=self.edge_cap,
                                 cell_cap=self._cell_cap)
        finite = torch.isfinite(x).reshape(x.shape[0], -1).all(dim=1)
        flags = torch.stack([finite.to(torch.int32),
                             db.overflow.to(torch.int32), db.n_edges,
                             db.max_occupancy], dim=1)
        return db, flags

    def _device_rebuild(self, x: Tensor, step: int, n_real: int,
                        cap_limit: int, what: str) -> None:
        """One batch-global rebuild on the device coordinates ``x``.

        Only the ``(B, 4)`` flags of the real scenes are read.  An overflow
        in any scene grows the shared ``cell_cap`` from the occupancy it
        reported (never past ``cap_limit``, a bound on any cell's count,
        so the loop ends) and builds again on the same coordinates; the
        host build is never touched.
        """
        t0 = time.perf_counter()
        db, flags = self._device_build(x)
        f = self._reduce_flags(self._tel.fetch(flags)[:n_real])
        if not f[:, 0].all():
            raise FloatingPointError(_DIVERGED_MSG.format(what, step))
        while f[:, 1].any():
            self._cell_overflows += 1
            self._cell_cap = min(cap_limit,
                                 max(auto_cell_cap(int(f[:, 3].max())),
                                     self._cell_cap + 1))
            db, flags = self._device_build(x)
            f = self._reduce_flags(self._tel.fetch(flags)[:n_real])
        worst = int(f[:, 2].max())
        if worst > self.edge_cap:
            warn_edge_truncation(worst, self.edge_cap, "longest-first")
        self._g = self._g._replace(senders=db.senders,
                                   receivers=db.receivers,
                                   edge_mask=db.edge_mask)
        self._lay = device_csr(db.receivers, db.edge_mask, self.node_cap)
        self._rebuild_s += time.perf_counter() - t0

    def _reduce_flags(self, f: np.ndarray) -> np.ndarray:
        """The build flags every rank acts on (one rank: its own)."""
        return f

    def _disp2(self, x: Tensor, refs: tuple) -> Tensor:
        """What the skin check before a step reads, left on the device: the
        largest masked squared displacement of any slot from each ``(ref,
        lim2)``'s reference (``(len(refs),)`` f32)."""
        nm = self._g.node_mask
        return torch.stack([(((x - ref) ** 2).sum(-1) * nm).max()
                            for ref, _ in refs])

    def _read_checks(self, disp2: Tensor, refs: tuple) -> np.ndarray:
        """A chunk's checks ``(k + 1, len(refs))`` → whether each held
        (every reference within its ``lim2``), in the chunk's one fetch."""
        d2 = self._tel.fetch(self._max_over_ranks(disp2))
        lims = np.array([lim2 for _, lim2 in refs], np.float32)
        return (d2 <= lims).all(axis=1)

    def _max_over_ranks(self, t: Tensor) -> Tensor:
        """``t`` as every rank sees it (one rank: itself)."""
        return t

    def _chunk_len(self, since: int, left: int) -> int:
        """Steps of the next chunk, ``since`` steps after the last failed
        check with ``left`` to go: up to the last interval (its trailing
        check then finds a rebuild due with no step lost), then a quarter
        of it at a time (doubling while no interval is known)."""
        last = self._interval
        if last is None:  # 1, 1, 2, 4, ...: no step lost on a short one
            k = max(since, 1)
        elif since < last:
            k = last - since
        else:
            k = max(1, last // 4)
        return max(1, min(k, left))

    def _advance(self, params, x: Tensor, v: Tensor, refs: tuple,
                 left: int, since: int) -> tuple:
        """Step on the current list while the skin check ``refs`` holds,
        at most ``left`` steps, in chunks (:meth:`_chunk_len`): each
        chunk's steps run on the device with the check before each of them
        and after the last, then one fetch of the checks (a chunk
        boundary).  Returns ``(x, v, kept, since, stopped)``: the state
        after the kept steps, their positions, the steps since the last
        failed check and whether a check failed."""
        kept: list[Tensor] = []
        while left > 0:
            k = self._chunk_len(since, left)
            checks, states = [], []
            xi, vi = x, v
            for _ in range(k):
                checks.append(self._disp2(xi, refs))
                xi, vi = self._step(params, xi, vi)
                states.append((xi, vi))
            checks.append(self._disp2(xi, refs))  # before the next step
            ok = self._read_checks(torch.stack(checks), refs)
            j = int(np.argmin(ok))  # the first failed check (k + 1: none)
            j = k + 1 if ok[j] else j
            self._discarded += max(k - j, 0)
            kept_now = min(j, k)
            if kept_now:
                x, v = states[kept_now - 1]
                kept += [s[0] for s in states[:kept_now]]
            left -= kept_now
            since += kept_now
            if j <= k:
                self._interval = since
                return x, v, kept, 0, True
        return x, v, kept, since, False

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

    def _counts(self, base: tuple, base2: tuple) -> dict:
        """Per-run deltas of the accounting: ``base`` at the run's start,
        ``base2`` after its first install (which is set-up, not rebuild
        traffic)."""
        tel = self._tel
        return dict(
            d2h_bytes=tel.d2h - base[0], h2d_bytes=tel.h2d - base[1],
            steady_state_d2h_bytes=tel.steady_d2h - base[2],
            rebuild_mode=self.rebuild_mode,
            coord_d2h_bytes=tel.coord_d2h - base2[0],
            edge_h2d_bytes=tel.edge_h2d - base2[1],
            cell_overflows=self._cell_overflows - base2[2],
            rebuild_s=self._rebuild_s - base2[3],
            discarded_steps=self._discarded - base2[4])

    def _marks(self) -> tuple:
        tel = self._tel
        return (tel.coord_d2h, tel.edge_h2d, self._cell_overflows,
                self._rebuild_s, self._discarded)


@dataclass
class RolloutResult:
    """A single-scene rollout: trajectory plus the engine's accounting.

    ``trajectory`` is the predicted positions per step, real nodes only.
    ``per_step_mse`` (when targets were given) is the mean over nodes of
    ‖x̂ − x‖² / 3.  ``rebuild_waits`` counts asynchronous host builds not
    finished when the stale list's budget ran out (the host blocked).
    ``coord_d2h_bytes`` / ``edge_h2d_bytes`` count rebuild traffic after
    the first install, 0 in ``'device'`` mode; ``cell_overflows`` counts
    the device build's capacity adaptations; ``rebuild_s`` is host wall
    time in rebuild installs.  ``discarded_steps`` counts steps computed
    past a failed skin check in a chunk and dropped.  There is no
    compilation: ``recompiles`` is 0.
    """

    trajectory: np.ndarray  # (n_steps, n, 3)
    per_step_mse: Optional[np.ndarray]  # (n_steps,) | None
    rebuild_count: int
    steps_per_rebuild: float  # n_steps / (rebuild_count + 1)
    n_steps: int
    rebuild_steps: list = field(default_factory=list)  # step of each swap
    trigger_steps: list = field(default_factory=list)  # step of each submit
    rebuild_waits: int = 0
    chunk_calls: int = 0
    recompiles: int = 0
    d2h_bytes: int = 0
    h2d_bytes: int = 0
    steady_state_d2h_bytes: int = 0
    rebuild_mode: str = "host"
    coord_d2h_bytes: int = 0
    edge_h2d_bytes: int = 0
    cell_overflows: int = 0
    rebuild_s: float = 0.0
    discarded_steps: int = 0


class RolloutEngine(_VerletEngine):
    """Recursive rollout of one scene.

    ``predict_fn(params, graph(B=1,·), layout) -> (1, N, 3)`` is the model
    (``Pipeline.predict_fn``); ``r`` / ``drop_rate`` are the model's graph
    semantics and ``skin`` an execution knob only: the trajectory does not
    depend on it, and ``skin=0`` rebuilds after every step.

    ``node_cap`` defaults to the first scene's node count and ``edge_cap``
    to its edge count at ``r + skin`` times ``edge_headroom``; both stay
    pinned for later runs.  ``rebuild_mode`` is as in the module
    docstring.  In host mode ``async_rebuild`` (default: on when
    ``skin > 0``) submits the build at ``rebuild_margin`` of the skin
    budget and keeps stepping on the stale list, bounded by both the old
    reference's full budget and the pending build's reference (each bound
    alone would let a pair close by more than the skin), so the list
    swapped in is valid by construction.

    ``wrap_box`` wraps every predicted position into ``[0, wrap_box)^3``
    before the velocity is formed, which bounds the recursion; the
    neighbour search is not minimum-image (pairs across a face are not
    found), and a node crossing a face triggers a rebuild.
    """

    def __init__(self, predict_fn: Callable, *, r: float, skin: float,
                 dt: float, drop_rate: float = 0.0,
                 node_cap: Optional[int] = None,
                 edge_cap: Optional[int] = None,
                 async_rebuild: Optional[bool] = None,
                 rebuild_margin: float = 0.5,
                 edge_headroom: float = DEFAULT_EDGE_HEADROOM, pool=None,
                 wrap_box: Optional[float] = None,
                 rebuild_mode: str = "auto",
                 cell_cap: Optional[int] = None, device=None):
        if not 0 < rebuild_margin <= 1:
            raise ValueError(f"rebuild_margin must be in (0, 1], got "
                             f"{rebuild_margin}")
        super().__init__(predict_fn, r=r, skin=skin, dt=dt,
                         drop_rate=drop_rate, wrap_box=wrap_box,
                         rebuild_mode=rebuild_mode, want_async=async_rebuild,
                         cell_cap=cell_cap, device=device)
        self.rebuild_margin = float(rebuild_margin)
        self.edge_headroom = float(edge_headroom)
        self.async_rebuild = (self.rebuild_mode == "host"
                              and (skin > 0 if async_rebuild is None
                                   else bool(async_rebuild)))
        self.node_cap = node_cap
        self.edge_cap = edge_cap
        self._pool = pool
        self._n_real = 0

    def _first_build(self, x0, v0, h) -> None:
        """Size the capacities on the first run, load the scene and
        install its first list."""
        x32 = np.asarray(x0, np.float32)
        if self.wrap_box is not None:
            b = np.float32(self.wrap_box)
            x32 = x32 - b * np.floor(x32 / b)
        n = self._n_real = x32.shape[0]
        self.node_cap = int(self.node_cap or n)
        device = self.rebuild_mode == "device"
        edges = None
        if self.edge_cap is None:
            # a sizing pass on the host; in device mode its edges are not
            # uploaded (the device build installs the first list)
            edges = radius_graph(x32, self.r + self.skin)
            self.edge_cap = max(1, int(np.ceil(edges[0].size
                                               * self.edge_headroom)))
        if device and self._cell_cap is None:
            # clamped at n: no cell can hold more than every node
            self._cell_cap = min(n, auto_cell_cap(
                cell_occupancy(x32, self.r + self.skin)))
        _, (x_real,) = self._load([(x0, v0, h)], [0])
        if device:
            self._device_rebuild(self._g.x, 0, 1, n, "")
        else:
            self._install([self._host_build_scene(x_real, edges)], [0])

    def _all_finite(self, x_np: np.ndarray) -> bool:
        return bool(np.isfinite(x_np).all())

    def _cap_limit(self) -> int:
        """A bound on any cell's count, where ``cell_cap`` stops growing."""
        return self._n_real

    def _trajectory(self, frames: Tensor) -> np.ndarray:
        """The kept frames (n_steps, node_cap, 3) → the result's
        trajectory, real nodes only."""
        return self._tel.fetch(frames)[:, :self._n_real]

    @torch.no_grad()
    def run(self, params, x0, v0, h, n_steps: int, *,
            targets: Optional[np.ndarray] = None,
            traj_capacity: Optional[int] = None) -> RolloutResult:
        """Roll the model ``n_steps`` forward from ``(x0, v0, h)``.

        ``targets[k]``, when given, is the ground truth for step ``k+1``
        and must cover every step: a short array raises (comparing late
        predictions with a frozen last frame would understate the error).
        ``traj_capacity`` is accepted for the JAX package's signature: with
        no compiled program there is no buffer to pre-size.
        """
        from repro_torch.data.stream import shared_worker_pool

        del traj_capacity
        n_steps = int(n_steps)
        if n_steps <= 0:
            raise ValueError(f"n_steps must be positive, got {n_steps}")
        if targets is not None:
            targets = np.asarray(targets)
            if targets.shape[0] < n_steps:
                raise ValueError(
                    f"rollout targets cover {targets.shape[0]} steps but "
                    f"n_steps={n_steps}: refusing to clamp ground truth to "
                    f"the last frame (it silently understates late-step "
                    f"error) — pass n_steps <= len(targets) or more frames")
        tel = self._tel
        base = (tel.d2h, tel.h2d, tel.steady_d2h)
        self._first_build(x0, v0, h)
        base2 = self._marks()
        n = self._n_real
        device = self.rebuild_mode == "device"

        lim2 = float(np.float32((0.5 * self.skin) ** 2))
        trig2 = (float(np.float32((self.rebuild_margin * 0.5 * self.skin)
                                  ** 2)) if self.async_rebuild else lim2)
        x, v = self._g.x, self._g.v
        x_ref = x
        pending = None  # (future, x at the trigger) during an async build
        done = chunk_calls = waits = since = 0
        frames: list[Tensor] = []
        rebuild_steps: list[int] = []
        trigger_steps: list[int] = []
        while done < n_steps:
            if pending is None:  # fresh list: watch the trigger
                refs = ((x_ref, trig2),)
            else:  # stale list: bounded by the old and the pending reference
                refs = ((x_ref, lim2), (pending[1], lim2))
            chunk_calls += 1
            x, v, kept, since, _ = self._advance(params, x, v, refs,
                                                 n_steps - done, since)
            frames += [xk[0] for xk in kept]
            done += len(kept)
            if done >= n_steps:
                break
            if pending is None:
                trigger_steps.append(done)
                if device:
                    self._device_rebuild(x, done, 1, self._cap_limit(), "")
                    x_ref = x
                    rebuild_steps.append(done)
                    continue
                x_np = tel.fetch(x[0], coords=True)[:n]
                if not self._all_finite(x_np):
                    # no displacement check passes on NaN: without this the
                    # loop would rebuild at the same positions forever
                    raise FloatingPointError(_DIVERGED_MSG.format("", done))
                if self.async_rebuild:
                    pool = self._pool or shared_worker_pool()
                    pending = (pool.submit(self._host_build_scene, x_np), x)
                else:
                    t0 = time.perf_counter()
                    self._install([self._host_build_scene(x_np)], [0])
                    self._rebuild_s += time.perf_counter() - t0
                    x_ref = x
                    rebuild_steps.append(done)
            else:
                fut, x_trig = pending
                if not fut.done():
                    waits += 1  # the budget ran out before the build landed
                t0 = time.perf_counter()
                self._install([fut.result()], [0])
                self._rebuild_s += time.perf_counter() - t0
                x_ref = x_trig
                rebuild_steps.append(done)
                pending = None

        traj = self._trajectory(torch.stack(frames))
        mse = None
        if targets is not None:
            n = traj.shape[1]
            err = np.sum((traj - targets[:n_steps, :n]) ** 2, axis=-1)
            mse = np.mean(err, axis=-1) / 3.0
        rebuilds = len(rebuild_steps)
        return RolloutResult(
            trajectory=traj, per_step_mse=mse, rebuild_count=rebuilds,
            steps_per_rebuild=n_steps / (rebuilds + 1), n_steps=n_steps,
            rebuild_steps=rebuild_steps, trigger_steps=trigger_steps,
            rebuild_waits=waits, chunk_calls=chunk_calls,
            **self._counts(base, base2))


@dataclass
class BatchedRolloutResult:
    """Per-scene trajectories (real nodes only) plus the engine's counts.

    ``rebuild_count`` is batch-global (one rebuild covers every scene).
    Host rebuilds block the batch, so in ``'host'`` mode every rebuild is
    a ``rebuild_wait``; ``'device'`` mode has none.  The byte counts follow
    :class:`RolloutResult`.  There is no compilation, so ``recompiles`` is
    0.
    """

    trajectories: list  # per real scene: (n_steps, n_j, 3) float32
    n_steps: int
    n_scenes: int
    batch_size: int
    rebuild_count: int
    rebuild_steps: list = field(default_factory=list)
    chunk_calls: int = 0
    recompiles: int = 0
    d2h_bytes: int = 0
    h2d_bytes: int = 0
    steady_state_d2h_bytes: int = 0
    rebuild_mode: str = "host"
    rebuild_waits: int = 0
    coord_d2h_bytes: int = 0
    edge_h2d_bytes: int = 0
    cell_overflows: int = 0
    rebuild_s: float = 0.0
    discarded_steps: int = 0


class BatchedRolloutEngine(_VerletEngine):
    """Rollout of 1..``batch_size`` same-capacity scenes stepping together.

    Every scene is padded to the pinned ``(node_cap, edge_cap)`` bucket.
    The skin criterion is reduced over the batch (any scene past its
    budget ends the chunk), so a rebuild covers all scenes: in device
    mode one build of every slot, with one fetch of the ``(B, 4)`` flags.
    A short batch pads its slots with replicas of the last scene; replicas
    compute the same trajectory and are dropped from the result.  The
    per-step masks make each scene's trajectory independent of the
    rebuild schedule, so a batched run equals single-scene runs at the
    same capacities.

    ``predict_fn(params, graph(B,·), layout) -> (B, N, 3)`` is the model
    (``Pipeline.predict_fn``); the engine hands it each slot's CSR layout
    ``(indptr, n_edges)``, built with every Verlet list.  ``cell_cap``
    (device mode) defaults to the first run's densest cell at ``r + skin``
    with headroom, clamped at ``node_cap``.
    """

    def __init__(self, predict_fn: Callable, *, batch_size: int,
                 node_cap: int, edge_cap: int, r: float, skin: float,
                 dt: float, drop_rate: float = 0.0,
                 wrap_box: Optional[float] = None,
                 rebuild_mode: str = "auto",
                 cell_cap: Optional[int] = None, device=None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        super().__init__(predict_fn, r=r, skin=skin, dt=dt,
                         drop_rate=drop_rate, wrap_box=wrap_box,
                         rebuild_mode=rebuild_mode, want_async=None,
                         cell_cap=cell_cap, device=device)
        self.batch_size = int(batch_size)
        self.node_cap = int(node_cap)
        self.edge_cap = int(edge_cap)

    def _build_scenes(self, scene_x: list) -> list:
        # sequential: the numpy build holds the GIL, threads gain nothing
        return [self._host_build_scene(x) for x in scene_x]

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
        tel = self._tel
        base = (tel.d2h, tel.h2d, tel.steady_d2h)
        ns, scene_x0 = self._load(scenes, slot_src)
        device = self.rebuild_mode == "device"
        if device:
            if self._cell_cap is None:
                self._cell_cap = min(self.node_cap, auto_cell_cap(
                    max(cell_occupancy(sx, self.r + self.skin)
                        for sx in scene_x0)))
            self._device_rebuild(self._g.x, 0, n_real, self.node_cap,
                                 "batched ")
        else:
            self._install(self._build_scenes(scene_x0), slot_src)
        base2 = self._marks()

        lim2 = float(np.float32((0.5 * self.skin) ** 2))
        x, v = self._g.x, self._g.v
        ref = x
        done = chunk_calls = waits = since = 0
        rebuild_steps: list[int] = []
        parts: list[np.ndarray] = []
        while done < n_steps:
            chunk_calls += 1
            x, v, block, since, _ = self._advance(
                params, x, v, ((ref, lim2),), n_steps - done, since)
            if block:
                new = tel.fetch(torch.stack(block, 1))
                parts.append(new)
                if on_chunk is not None:
                    on_chunk(done, new[:n_real])
                done += len(block)
            if done >= n_steps:
                break
            if device:
                self._device_rebuild(x, done, n_real, self.node_cap,
                                     "batched ")
            else:
                t0 = time.perf_counter()
                x_np = tel.fetch(x, coords=True)
                scene_x = [x_np[j, :ns[j]] for j in range(n_real)]
                if not all(np.isfinite(sx).all() for sx in scene_x):
                    raise FloatingPointError(
                        _DIVERGED_MSG.format("batched ", done))
                self._install(self._build_scenes(scene_x), slot_src)
                self._rebuild_s += time.perf_counter() - t0
                waits += 1
            ref = x
            rebuild_steps.append(done)
        full = np.concatenate(parts, axis=1)
        return BatchedRolloutResult(
            trajectories=[full[j, :n_steps, :ns[j]] for j in range(n_real)],
            n_steps=n_steps, n_scenes=n_real, batch_size=self.batch_size,
            rebuild_count=len(rebuild_steps), rebuild_steps=rebuild_steps,
            chunk_calls=chunk_calls, rebuild_waits=waits,
            **self._counts(base, base2))


class DistRolloutEngine(RolloutEngine):
    """Recursive rollout of one scene on a DistEGNN mesh: each rank of the
    ``torch.distributed`` group steps its own shard.

    ``apply_full(params, cfg, g, *, axis, edge_layout)`` is the registry's
    FastEGNN forward; with ``mesh`` (a ``core.collectives.GraphAxis``) its
    virtual-node sums go over the group in every layer
    (``core.collectives.graph_sum``).  The engine is the single-scene
    engine on the rank's shard, with the reference's semantics:

    * the partition is frozen once a run, at the (wrapped) starting
      positions: ``random_partition(default_rng(seed), n, D)`` or
      ``metis_like_partition`` on the radius graph at ``r + skin``
      (``strategy``).  Every rank computes it from its copy of the whole
      scene, so every rank knows every shard's nodes; ``n_cap`` (default:
      the largest shard) and ``e_cap`` (the largest shard's Verlet edge
      count × ``edge_headroom``, agreed by an integer max) stay pinned for
      later runs, as does ``cell_cap`` (default: the densest cell of any
      shard, with headroom);
    * the skin check: each rank's largest masked squared displacement,
      before every step of a chunk and after its last, made global by one
      ``all_reduce(MAX)`` a chunk (``collectives.max_across_f32``), so every
      rank stops at the same step; the chunk lengths and every branch
      depend only on such agreed values, so the ranks' collective calls
      stay matched;
    * device rebuilds (``data/cell_list.py`` on the shard, at the pinned
      capacities): the flags (non-finite, overflow, edges found, densest
      cell) are agreed by one integer max, so an overflow on any shard
      grows ``cell_cap`` and builds again on every rank, and a non-finite
      coordinate raises ``FloatingPointError`` on every rank at the same
      step.  Host rebuilds fetch and build only the rank's own shard,
      synchronously or (``async_rebuild``) on the shared worker pool,
      with the two-reference rule of :class:`RolloutEngine`;
    * the result: one ``all_gather`` of the ranks' trajectories, scattered
      by the frozen indices, gives every rank the same global
      ``(n_steps, n, 3)`` trajectory, bit for bit.
    """

    def __init__(self, apply_full: Callable, cfg, mesh, *, r: float,
                 skin: float, dt: float, drop_rate: float = 0.0,
                 strategy: str = "random", seed: int = 0,
                 n_cap: Optional[int] = None, e_cap: Optional[int] = None,
                 async_rebuild: Optional[bool] = None,
                 rebuild_margin: float = 0.5,
                 edge_headroom: float = DEFAULT_EDGE_HEADROOM, pool=None,
                 wrap_box: Optional[float] = None,
                 rebuild_mode: str = "auto",
                 cell_cap: Optional[int] = None, device=None):
        if strategy not in ("random", "metis"):
            raise ValueError(f"unknown partition strategy {strategy!r}")

        def predict(params, g: GeometricGraph, layout) -> Tensor:
            out = []
            for b in range(g.x.shape[0]):
                gb = GeometricGraph(*(a[b] for a in g))
                lay = None if layout is None else tuple(a[b] for a in layout)
                out.append(apply_full(params, cfg, gb, axis=mesh,
                                      edge_layout=lay)[0])
            return torch.stack(out)

        super().__init__(
            predict, r=r, skin=skin, dt=dt, drop_rate=drop_rate,
            node_cap=n_cap, edge_cap=e_cap, async_rebuild=async_rebuild,
            rebuild_margin=rebuild_margin, edge_headroom=edge_headroom,
            pool=pool, wrap_box=wrap_box, rebuild_mode=rebuild_mode,
            cell_cap=cell_cap,
            device=mesh.device if device is None else device)
        self.apply_full = apply_full
        self.cfg = cfg
        self.mesh = mesh
        self.d = int(mesh.size)
        self.strategy = strategy
        self.seed = int(seed)
        self._idx: list = []  # each shard's global node indices (frozen)
        self._n_global = 0

    # ------------------------------------------------------- the partition
    def _freeze_assignment(self, x: np.ndarray) -> None:
        from repro_torch.data.partition import (metis_like_partition,
                                                random_partition)

        n = x.shape[0]
        if self.strategy == "random":
            assign = random_partition(np.random.default_rng(self.seed), n,
                                      self.d)
        else:
            gs, gr = radius_graph(x, self.r + self.skin)
            assign = metis_like_partition(x, gs, gr, self.d)
        self._idx = [np.nonzero(assign == p)[0] for p in range(self.d)]
        self._n_global = n
        if self.node_cap is None:
            self.node_cap = max(1, max(i.size for i in self._idx))

    def _first_build(self, x0, v0, h) -> None:
        """Freeze the partition, size the capacities on the first run, load
        this rank's shard and install its first list (device mode: built
        on the device, bitwise the host build)."""
        from repro_torch.core.collectives import max_across

        x32 = np.asarray(x0, np.float32)
        if self.wrap_box is not None:
            b = np.float32(self.wrap_box)
            x32 = x32 - b * np.floor(x32 / b)
        self._freeze_assignment(x32)
        idx = self._idx[self.mesh.rank]
        self._n_real = idx.size
        r_build = self.r + self.skin
        x_local = x32[idx]
        device = self.rebuild_mode == "device"
        edges = None
        if self.edge_cap is None:
            edges = radius_graph(x_local, r_build)
            e_max = max(1, max_across([edges[0].size], self.mesh)[0])
            self.edge_cap = max(1, int(np.ceil(e_max * self.edge_headroom)))
        if device and self._cell_cap is None:
            # every rank holds the whole scene: the same value everywhere
            occ = max((cell_occupancy(x32[i], r_build) for i in self._idx
                       if i.size), default=1)
            self._cell_cap = min(self.node_cap, auto_cell_cap(occ))
        self._load([(x_local, np.asarray(v0, np.float32)[idx],
                     np.asarray(h, np.float32)[idx])], [0], wrap=False)
        if device:
            self._device_rebuild(self._g.x, 0, 1, self._cap_limit(), "")
        else:
            self._install([self._host_build_scene(x_local, edges)], [0])

    # ----------------------------------------------------- agreed decisions
    def _max_over_ranks(self, t: Tensor) -> Tensor:
        from repro_torch.core.collectives import max_across_f32

        return max_across_f32(t, self.mesh)

    def _reduce_flags(self, f: np.ndarray) -> np.ndarray:
        from repro_torch.core.collectives import max_across

        worst = max_across([1 - int(f[0, 0]), int(f[0, 1]), int(f[0, 2]),
                            int(f[0, 3])], self.mesh)
        return np.array([[1 - worst[0]] + worst[1:]], np.int32)

    def _cap_limit(self) -> int:
        return self.node_cap  # the same on every rank

    def _all_finite(self, x_np: np.ndarray) -> bool:
        from repro_torch.core.collectives import max_across

        return not max_across([int(not np.isfinite(x_np).all())],
                              self.mesh)[0]

    def _trajectory(self, frames: Tensor) -> np.ndarray:
        """Every rank's kept frames, gathered and scattered by the frozen
        indices: the global trajectory, the same on every rank."""
        from repro_torch.core.collectives import gather_across

        out = np.zeros((frames.shape[0], self._n_global, 3), np.float32)
        for idx, part in zip(self._idx,
                             gather_across(frames.contiguous(), self.mesh)):
            out[:, idx] = self._tel.fetch(part)[:, :idx.size]
        return out
