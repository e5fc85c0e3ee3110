"""The surface of a built model: forward and training, on one device or
DistEGNN over a ``torch.distributed`` group.

``build_pipeline(name, generator=..., device=..., train_cfg=..., **cfg)``
resolves any of the registry's ten names (``models.registry``: linear,
mpnn, egnn, rf, schnet, tfn, fast_egnn, fast_rf, fast_schnet, fast_tfn)
and returns a :class:`Pipeline` with ``cfg``, ``params``, ``apply_full``,
``device``, ``train_cfg``, ``opt`` and

* ``predict_fn(params, graph(B,·), layout) -> (B, N, 3)``: the forward the
  rollout engine and the serving plane compose.  ``layout`` is ``None`` or
  the batch's CSR layout ``(indptr (B, N+1) int32, n_edges (B,)[, sperm,
  sptr])``.  The scenes of a batch run one after another through the same
  per-scene forward, so a batched prediction equals the per-scene ones by
  construction;
* :meth:`Pipeline.make_batches` → a re-iterable
  :class:`~repro_torch.data.stream.BatchStream` of layout-carrying
  ``data.loader.GraphBatch``es; :meth:`Pipeline.train_step`,
  :meth:`Pipeline.eval_step`, :meth:`Pipeline.predict` and
  :meth:`Pipeline.fit` (epochs + early stopping, ``training.trainer``);
* :meth:`Pipeline.rollout`: recursive prediction of one scene through a
  cached :class:`~repro_torch.rollout.engine.RolloutEngine`;
* :meth:`Pipeline.dispatch_report`: the kernel-dispatch counts and the
  rollout engines' LRU.

``build_pipeline("fast_egnn", mesh=make_gnn_mesh(...), ...)`` (DistEGNN,
Sec. VI; ``distributed.dist_egnn``) is the same surface on one rank of a
group: ``make_batches`` streams this rank's shard of each batch,
``predict_fn(params, ShardedBatch) -> (B, n_cap, 3)`` is the distributed
forward, ``train_step`` / ``fit`` the distributed train step,
``eval_step`` the Eq. 18 objective, and ``rollout`` runs
:class:`~repro_torch.rollout.engine.DistRolloutEngine` on the group.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.kernels.runtime import resolve_device, resolve_precision
from repro_torch.models.registry import model_config
from repro_torch.serving.programs import LRUCache
from repro_torch.training.optim import Adam
from repro_torch.training.trainer import (FitResult, TrainConfig,
                                          build_train_step, run_fit)

Tensor = torch.Tensor

#: live rollout engines a pipeline keeps (LRU over their keys)
ROLLOUT_ENGINE_CACHE = 4


class Pipeline:
    """A model's config, parameters, device, forward program and training
    machinery."""

    def __init__(self, name: str, cfg, params, apply_full: Callable,
                 device: torch.device,
                 train_cfg: Optional[TrainConfig] = None, mesh=None):
        self.name = name
        #: ``None``, or the DistEGNN graph axis
        #: (``core.collectives.GraphAxis``) this pipeline's rank runs on
        self.mesh = mesh
        self.cfg = cfg
        self.params = params
        #: the registry's ``(params, cfg, g, *, edge_layout=None) ->
        #: (coords, aux)``
        self.apply_full = apply_full
        self.device = device
        self.train_cfg = train_cfg if train_cfg is not None else TrainConfig()
        tc = self.train_cfg
        self.opt = Adam(lr=tc.lr, weight_decay=tc.weight_decay,
                        grad_clip=tc.grad_clip)
        #: ``(params, graph(B,·), layout|None) -> (B, N, 3)`` predicted
        #: coordinates, run without autograd; on a mesh ``(params,
        #: ShardedBatch) -> (B, n_cap, 3)``, this rank's shard
        if mesh is None:
            self.predict_fn: Callable = torch.no_grad()(self._predict)
        else:
            from repro_torch.distributed.dist_egnn import build_dist_apply

            dist_apply = build_dist_apply(cfg, mesh)
            self.predict_fn = torch.no_grad()(
                lambda params, sb: dist_apply(params, sb)[0])
        self._steps = None
        self._rollout_engines = LRUCache(ROLLOUT_ENGINE_CACHE)

    def _predict(self, params, g: GeometricGraph,
                 layout: Optional[tuple]) -> Tensor:
        out = []
        for b in range(g.x.shape[0]):
            gb = GeometricGraph(*(a[b] for a in g))
            lay = None if layout is None else tuple(a[b] for a in layout)
            out.append(self.apply_full(params, self.cfg, gb,
                                       edge_layout=lay)[0])
        return torch.stack(out)

    # ------------------------------------------------------------- batches
    def make_batches(self, samples, batch_size: int, *, r: float = np.inf,
                     drop_rate: float = 0.0, partition: str = "random",
                     shuffle_seed: Optional[int] = None,
                     with_layout: Optional[bool] = None,
                     reshuffle_each_epoch: bool = False,
                     cache_dir: Optional[str] = None,
                     prefetch: Optional[int] = None,
                     num_workers: Optional[int] = None,
                     edge_cap: Optional[int] = None,
                     drop_last: bool = False):
        """Raw samples → a :class:`~repro_torch.data.stream.BatchStream` of
        fixed-shape batches on this pipeline's device (DESIGN.md §8).

        One device: ``GraphBatch``es at the dataset's shared capacities,
        the trailing partial batch mask-padded (dropped with a warning when
        ``drop_last``); ``with_layout`` defaults to ``cfg.use_kernel``
        (only the kernel path reads the CSR layout).  On a mesh: this
        rank's ``ShardedBatch``es (their CSR layouts always built): sample
        j of a batch is split by ``partition_shards(strategy=partition,
        seed=j)`` and this rank builds only its own shard; each sample's
        edge capacity (its max over the shards, unless ``edge_cap``) is
        agreed by an integer max over the group, so every shard is the one
        a single process would build.  The trailing samples short of a
        full batch are dropped with a warning (the sharded step has no
        sample mask).

        The stream re-iterates once an epoch (``fit``), its host batches
        built by ``num_workers`` threads ``prefetch`` batches ahead
        (defaults ``data.stream.DEFAULT_PREFETCH`` / ``DEFAULT_WORKERS``;
        0 iterates synchronously); ``len``, indexing and ``materialize()``
        give the eager list.  ``reshuffle_each_epoch`` shuffles each epoch
        by ``(shuffle_seed, epoch)``; off, every epoch replays the eager
        order.  ``cache_dir`` keeps the CSR layouts in a
        ``data.layout_cache`` directory, so a warm run builds none."""
        from repro_torch.data.stream import (DEFAULT_PREFETCH,
                                             DEFAULT_WORKERS, BatchStream)

        if with_layout is None:
            with_layout = bool(self.cfg.use_kernel)
        return BatchStream(
            samples, batch_size, r=r, drop_rate=drop_rate, edge_cap=edge_cap,
            shuffle_seed=shuffle_seed, with_layout=with_layout,
            reshuffle_each_epoch=reshuffle_each_epoch, drop_last=drop_last,
            cache_dir=cache_dir,
            prefetch=DEFAULT_PREFETCH if prefetch is None else prefetch,
            num_workers=(DEFAULT_WORKERS if num_workers is None
                         else num_workers),
            mesh=self.mesh, partition=partition, device=self.device)

    # --------------------------------------------------------------- steps
    def _build_steps(self):
        if self._steps is None and self.mesh is not None:
            from repro_torch.distributed.dist_egnn import \
                build_dist_train_step

            tc = self.train_cfg
            step, loss_fn = build_dist_train_step(
                self.cfg, self.mesh, self.opt, lam_mmd=tc.lam_mmd,
                mmd_sigma=tc.mmd_sigma)

            def train_step(params, opt_state, batch, generator=None):
                params, opt_state, loss = step(params, opt_state, batch)
                return params, opt_state, {"loss": loss}

            self._steps = (train_step, torch.no_grad()(loss_fn))
        if self._steps is None:
            step, ev = build_train_step(self.apply_full, self.cfg,
                                        self.train_cfg, self.opt)

            def train_step(params, opt_state, batch, generator=None):
                if generator is None:  # as the reference's default key
                    generator = torch.Generator(device=self.device)
                    generator.manual_seed(self.train_cfg.seed)
                return step(params, opt_state, batch, generator)

            self._steps = (train_step, ev)
        return self._steps

    @property
    def train_step(self) -> Callable:
        """``(params, opt_state, batch, generator=None)`` → ``(params,
        opt_state, metrics)``; metrics always has ``"loss"``.  The MMD node
        sample (``train_cfg.mmd_sample``) draws from ``generator``, by
        default one seeded with ``train_cfg.seed`` on this device."""
        return self._build_steps()[0]

    @property
    def eval_step(self) -> Callable:
        """``(params, batch)`` → the batch's masked MSE (0-d tensor); on a
        mesh the Eq. 18 objective (MSE + λ·MMD), the same on every rank."""
        return self._build_steps()[1]

    def predict(self, params, batch) -> Tensor:
        """Batch-level forward → predicted coordinates (B, N, 3); on a mesh
        this rank's shard, (B, n_cap, 3)."""
        if self.mesh is not None:
            return self.predict_fn(params, batch)
        return self.predict_fn(params, batch.graph, batch.layout)

    def rollout(self, params, state0, n_steps: int, *, r: float,
                skin: float = 0.0, dt: float, drop_rate: float = 0.0,
                targets=None, node_cap: Optional[int] = None,
                edge_cap: Optional[int] = None,
                async_rebuild: Optional[bool] = None,
                partition: str = "random", seed: int = 0,
                traj_capacity: Optional[int] = None,
                wrap_box: Optional[float] = None,
                rebuild_mode: str = "auto"):
        """Recursive prediction: feed the model its own output for
        ``n_steps`` steps, velocities re-estimated by finite differences
        at timestep ``dt`` (DESIGN.md §10).

        ``state0`` is ``(x0, v0, h)`` (numpy, one scene).  ``r`` /
        ``drop_rate`` are the model's graph semantics, as in training;
        ``skin`` is an execution knob: the list is built at ``r + skin``
        and reused until some node moves more than ``skin/2``.
        ``rebuild_mode`` (``'auto'``: ``'device'`` whenever ``r`` is
        finite and ``async_rebuild`` was not asked for), ``async_rebuild``,
        the capacities, ``targets`` and ``wrap_box`` are those of
        :class:`~repro_torch.rollout.engine.RolloutEngine`; both modes give
        bitwise the same trajectory.  On a mesh every rank calls this with
        the whole scene and runs
        :class:`~repro_torch.rollout.engine.DistRolloutEngine`: the
        partition (``partition``, ``seed``) is frozen at ``x0``, each rank
        steps its shard (``node_cap`` / ``edge_cap`` are a shard's), and
        every rank returns the same global trajectory.
        ``traj_capacity`` pre-sizes a compiled buffer the port does not
        have: it is accepted and changes nothing.  Engines are kept in an
        LRU of ``ROLLOUT_ENGINE_CACHE`` keys.

        Returns a :class:`~repro_torch.rollout.engine.RolloutResult`.
        """
        from repro_torch.rollout.engine import (DistRolloutEngine,
                                                RolloutEngine)

        x0, v0, h = state0
        key = (self.mesh is None, float(r), float(skin), float(dt),
               float(drop_rate), node_cap, edge_cap, async_rebuild,
               partition, seed, wrap_box, rebuild_mode)
        eng = self._rollout_engines.get(key)
        if eng is None:
            if self.mesh is None:
                eng = RolloutEngine(
                    self.predict_fn, r=r, skin=skin, dt=dt,
                    drop_rate=drop_rate, node_cap=node_cap,
                    edge_cap=edge_cap, async_rebuild=async_rebuild,
                    wrap_box=wrap_box, rebuild_mode=rebuild_mode,
                    device=self.device)
            else:
                eng = DistRolloutEngine(
                    self.apply_full, self.cfg, self.mesh, r=r, skin=skin,
                    dt=dt, drop_rate=drop_rate, strategy=partition,
                    seed=seed, n_cap=node_cap, e_cap=edge_cap,
                    async_rebuild=async_rebuild, wrap_box=wrap_box,
                    rebuild_mode=rebuild_mode, device=self.device)
            self._rollout_engines.put(key, eng)
        return eng.run(params, x0, v0, h, n_steps, targets=targets,
                       traj_capacity=traj_capacity)

    def fit(self, train_batches, val_batches,
            verbose: bool = False) -> FitResult:
        """Epochs + validation-based early stopping
        (``training.trainer.run_fit``); sets ``self.params`` to the best
        validation parameters and returns the :class:`FitResult`."""
        step, eval_step = self._build_steps()
        res = run_fit(step, eval_step, self.params,
                      self.opt.init(self.params), self.train_cfg,
                      train_batches, val_batches, verbose=verbose)
        self.params = res.params
        return res


    # ------------------------------------------------------------ telemetry
    def dispatch_report(self) -> dict:
        """The kernel-dispatch counters (``core.message_passing.
        dispatch_counts``, per call since the last ``reset_dispatch_counts``),
        ``use_kernel``, the dispatch mode they show for this pipeline
        (``message_passing.dispatch_mode`` on this device), and the rollout
        engines' LRU stats."""
        from repro_torch.core import message_passing as mp
        from repro_torch.kernels.runtime import backend_mode

        counts = mp.dispatch_counts()
        use_kernel = bool(getattr(self.cfg, "use_kernel", False))
        return dict(counts=counts, use_kernel=use_kernel,
                    mode=mp.dispatch_mode(counts, use_kernel,
                                          backend_mode(self.device)),
                    rollout_engine_cache=self._rollout_engines.stats())


def build_pipeline(name: str, *, generator: Optional[torch.Generator] = None,
                   params=None, device=None,
                   train_cfg: Optional[TrainConfig] = None, mesh=None,
                   **cfg_overrides) -> Pipeline:
    """Registry name + config overrides → :class:`Pipeline` on ``device``
    (default CUDA).  The config is composed as the registry composes it
    (``models.registry.model_config``); the weights are ``params`` (e.g.
    from ``weights.params_from_jax``) or random draws from ``generator``
    (the same seed on every rank of a mesh gives every rank the same
    weights); ``train_cfg`` sets the optimizer and the fit protocol
    (default :class:`~repro_torch.training.trainer.TrainConfig`).  A
    ``mesh`` (``distributed.dist_egnn.make_gnn_mesh``) builds DistEGNN on
    its device, which is FastEGNN over a graph partition: any other name
    raises."""
    if mesh is not None and name != "fast_egnn":
        raise ValueError(
            f"build_pipeline(mesh=...) implements DistEGNN (Sec. VI), which "
            f"is FastEGNN over a graph partition — got model {name!r}; pass "
            f"name='fast_egnn' or mesh=None")
    spec, cfg = model_config(name, **cfg_overrides)
    if mesh is not None and device is None:
        device = mesh.device
    dev = resolve_device(device)
    resolve_precision(cfg.precision)  # an unknown string raises
    if params is None:
        if generator is None:
            raise ValueError("build_pipeline needs params= or generator=")
        params = spec.init(generator, cfg, device=dev)
    return Pipeline(name, cfg, params, spec.apply_full, dev, train_cfg, mesh)
