"""Simulation client: one scene through the rollout serving plane.

    PYTHONPATH=src python -m repro_torch.launch.simulate --n 7800 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.simulate --scene scene.npz \\
        --steps 500 --r 0.05 --skin 0.025 --use-kernel

A one-request client of :class:`repro_torch.serving.RolloutService`: load
or synthesise a scene, submit it, stream frames as they arrive at rebuild
boundaries, and report the trajectory statistics and the service's own
metrics.  The flags are the JAX package's ``launch/simulate.py``, plus
``--device``: the model runs on CUDA, its Verlet lists rebuilt on the card
(``data/cell_list.py``), or with ``--device cpu`` through the plain
PyTorch versions of the kernels.  ``--model`` takes any name of
``models.registry`` (default fast_egnn), built with the JAX package's
keywords (2 layers, hidden 32; C = 3 and s_dim 16 for fast_egnn).
``--use-kernel`` routes the steps through the CUDA kernels, the same
model either way.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def load_scene(args) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(x0, v0, h) from ``--scene file.npz`` (keys x, v[, h]) or synthetic.

    The ``.npz`` is validated up front (shapes x ``(n,3)``, v ``(n,3)``,
    h ``(n,f)``, floating dtypes, finite values), so a malformed scene
    fails here with a clear message.
    """
    from repro_torch.serving import AdmissionError, validate_scene

    if args.scene:
        z = np.load(args.scene)
        if "x" not in z or "v" not in z:
            raise SystemExit(
                f"{args.scene}: .npz must contain keys 'x' and 'v' "
                f"(optionally 'h'), found {sorted(z.keys())}")
        x = np.asarray(z["x"])
        v = np.asarray(z["v"])
        h = (np.asarray(z["h"]) if "h" in z
             else np.ones((x.shape[0] if x.ndim >= 1 else 0, 1), np.float32))
        try:
            return validate_scene(x, v, h, name=args.scene)
        except AdmissionError as e:
            raise SystemExit(str(e)) from None
    rng = np.random.default_rng(args.seed)
    x = rng.uniform(0.0, 1.0, (args.n, 3)).astype(np.float32)
    v = (0.01 * rng.standard_normal((args.n, 3))).astype(np.float32)
    return validate_scene(x, v, np.ones((args.n, 1), np.float32))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", type=str, default=None,
                    help=".npz with x (n,3), v (n,3)[, h (n,f)]; "
                         "default: synthetic uniform cube")
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=100)
    from repro_torch.models.registry import REGISTRY

    ap.add_argument("--model", type=str, default="fast_egnn",
                    choices=sorted(REGISTRY))
    ap.add_argument("--r", type=float, default=None,
                    help="cutoff radius (default: ~8 neighbours/node)")
    ap.add_argument("--skin", type=float, default=None,
                    help="Verlet skin (default: r/2)")
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--drop-rate", type=float, default=0.0)
    ap.add_argument("--wrap-box", type=float, default=None,
                    help="periodic box side; positions wrap into "
                         "[0, box)^3 each step so long rollouts stay "
                         "bounded (default: 1.0 for the synthetic cube, "
                         "off for --scene; pass 0 to disable)")
    ap.add_argument("--use-kernel", action="store_true",
                    help="route steps through the CUDA kernels (the model "
                         "is then built at hidden and s_dim 64)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default: the GPU)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.launch.train import config_kwargs
    from repro_torch.pipeline import build_pipeline
    from repro_torch.serving import RolloutService

    x0, v0, h = load_scene(args)
    n = x0.shape[0]
    r = args.r if args.r is not None else float(
        (8 * 3.0 / (4.0 * np.pi * n)) ** (1.0 / 3.0))
    skin = args.skin if args.skin is not None else 0.5 * r
    if args.wrap_box is None:
        wrap_box = None if args.scene else 1.0
    else:
        wrap_box = args.wrap_box if args.wrap_box > 0 else None

    kw = dict(h_in=h.shape[1], n_layers=2, hidden=32)
    if args.model == "fast_egnn":
        kw.update(n_virtual=3, s_dim=16)
    pipe = build_pipeline(
        args.model, generator=torch.Generator().manual_seed(args.seed),
        device=args.device, use_kernel=args.use_kernel,
        **config_kwargs(args.model, kw))

    from repro_torch.core.message_passing import (dispatch_counts,
                                                  reset_dispatch_counts)
    from repro_torch.kernels import edge_message, virtual_message

    reset_dispatch_counts()
    edge_message.reset_launches()
    virtual_message.reset_launches()
    with RolloutService(pipe, model=args.model) as svc:
        t0 = time.perf_counter()
        handle = svc.submit(x0, v0, h, args.steps, r=r, skin=skin,
                            dt=args.dt, drop_rate=args.drop_rate,
                            wrap_box=wrap_box)
        streamed = 0
        t_first = None
        for _frame in handle.frames():
            if t_first is None:
                t_first = time.perf_counter() - t0
            streamed += 1
        tr = handle.result()
        wall = time.perf_counter() - t0
    # after close() the worker has joined, so the metrics snapshot is
    # complete (streaming releases clients before batch bookkeeping)
    m = svc.metrics()

    print(f"scene n={n}  r={r:.4f}  skin={skin:.4f}  model={args.model}"
          f"{' +kernel' if args.use_kernel else ''}  device={pipe.device}"
          f"{f'  box={wrap_box:g}' if wrap_box else ''}")
    print(f"{streamed} steps in {wall:.2f}s "
          f"({streamed / wall:.1f} steps/s, first run includes set-up); "
          f"first frame streamed at {t_first:.2f}s")
    cache = m["program_cache"]
    print(f"serving: queue wait {handle.queue_wait_s * 1e3:.1f}ms, "
          f"compute {m['compute_mean_s']:.2f}s, engines built "
          f"{cache['builds']} (cache {cache['size']}/{cache['capacity']})")
    print(f"rebuilds: {m['rebuilds']} "
          f"({m['rebuild_waits']} host-blocking), rebuild time "
          f"{m.get('rebuild_mean_s', 0.0) * 1e3:.1f}ms/batch")
    print(f"trajectory span: |x| max {np.abs(tr).max():.3f}, "
          f"final-step mean displacement "
          f"{np.linalg.norm(tr[-1] - (tr[-2] if len(tr) > 1 else x0), axis=-1).mean():.4f}")
    cfg = pipe.cfg
    print(f"model: layers={cfg.n_layers} hidden={cfg.hidden}"
          + (f" n_virtual={cfg.n_virtual} s_dim={cfg.s_dim}"
             if args.model == "fast_egnn" else ""))
    d = dispatch_counts()
    print("dispatch: " + " ".join(
        f"{k}={d.get(k, 0)}" for k in ("edge_kernel", "edge_plain",
                                       "virtual_kernel", "virtual_plain"))
          + f"  launches: edge={edge_message.launches} "
          f"identity={edge_message.identity_launches} "
          f"virtual={virtual_message.launches}  routes: edge "
          + (",".join(f"{k}:{v}" for k, v in sorted(
              edge_message.route_launches.items())) or "-")
          + " virtual " + (",".join(f"{k}:{v}" for k, v in sorted(
              virtual_message.route_launches.items())) or "-"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
