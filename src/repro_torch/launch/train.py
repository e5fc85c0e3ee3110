"""Training launcher (GNN mode).

    python -m repro_torch.launch.train gnn --dataset fluid --n-nodes 7800 \
        --n-samples 8 --batch 4 --epochs 2 [--devices 2]

Builds ``--model`` (any name of ``models.registry``; default fast_egnn)
with ``build_pipeline`` (random weights from ``--seed``), the batches
with ``Pipeline.make_batches`` and trains with ``Pipeline.fit``; the
flags, their defaults and the per-model keywords are the JAX package's
``launch/train.py`` (keywords a model's config does not have, such as
RF's ``h_in``, are left out), plus ``--device``: the model runs on CUDA
through the hand-written kernels, or with ``--device cpu`` through their
plain PyTorch versions.  ``--devices D`` > 1 trains DistEGNN (the model
pinned to fast_egnn, Sec. VI): D ranks started on this machine
(``launch.mesh.spawn_ranks``), each on its own shard of every batch
(``--partition``), over NCCL with a GPU each or gloo when they share one
GPU or run on the CPU.  Not ported yet: the ``nbody`` and ``protein``
datasets and the streaming data plane (``--layout-cache``,
``--reshuffle``; ROADMAP queue A #7) and LM mode (queue A #10).
``--prefetch`` and ``--workers`` are accepted and have no effect: batches
are built eagerly.
"""
from __future__ import annotations

import argparse


def config_kwargs(model: str, kw: dict) -> dict:
    """The launcher's keywords that ``model``'s config has."""
    from repro_torch.models.registry import REGISTRY

    fields = REGISTRY[model].make_config._fields
    return {k: v for k, v in kw.items() if k in fields}


def gnn_main(args) -> None:
    if args.dataset != "fluid":
        raise NotImplementedError(
            f"--dataset {args.dataset}: the port generates 'fluid' only; "
            f"nbody and protein come with the data plane (ROADMAP queue A "
            f"#7)")
    if args.layout_cache or args.reshuffle:
        raise NotImplementedError(
            "--layout-cache and --reshuffle need the streaming data plane "
            "(ROADMAP queue A #7)")
    if args.devices > 1:
        from repro_torch.launch.mesh import spawn_ranks

        spawn_ranks(_gnn_rank, args.devices, args, device=args.device)
        return
    train_gnn(args)


def _gnn_rank(rank: int, world: int, args) -> None:
    from repro_torch.distributed.dist_egnn import make_gnn_mesh

    train_gnn(args, make_gnn_mesh(world, device=args.device))


def train_gnn(args, mesh=None) -> None:
    """Generate the data, build the pipeline (on ``mesh``, DistEGNN, when
    given), fit, report and checkpoint (rank 0 of a mesh)."""
    import torch

    from repro_torch.data.fluid import generate_fluid_dataset
    from repro_torch.pipeline import build_pipeline
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.training.trainer import TrainConfig

    lead = mesh is None or mesh.rank == 0
    data = generate_fluid_dataset(args.n_samples, n_particles=args.n_nodes)
    r, h_in = 0.035, 1
    n_tr = int(0.8 * len(data))
    model = args.model if mesh is None else "fast_egnn"
    kw = dict(h_in=h_in, n_layers=args.n_layers, hidden=args.hidden)
    if model.startswith("fast_"):
        kw.update(n_virtual=args.n_virtual)
        if model in ("fast_egnn", "fast_schnet", "fast_tfn"):
            kw.update(s_dim=args.hidden)
    tc = TrainConfig(epochs=args.epochs, lam_mmd=args.lam_mmd,
                     mmd_sigma=args.mmd_sigma, seed=args.seed)
    pipe = build_pipeline(
        model, generator=torch.Generator().manual_seed(args.seed),
        device=args.device, train_cfg=tc, use_kernel=True, mesh=mesh,
        **config_kwargs(model, kw))
    bk = dict(r=r, drop_rate=args.drop_rate)
    if mesh is not None:
        bk.update(partition=args.partition)
    tr = pipe.make_batches(data[:n_tr], args.batch, **bk)
    va = pipe.make_batches(data[n_tr:], args.batch, **bk)
    res = pipe.fit(tr, va, verbose=lead)
    if not lead:
        return
    print(f"best val MSE: {res.best_val:.6f}  wall: {res.wall_time:.1f}s"
          f"  device: {pipe.device}  devices: {args.devices}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, res.params,
                        {"model": args.model, "val_mse": res.best_val})
        print("saved", args.checkpoint)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)
    g = sub.add_parser("gnn")
    from repro_torch.models.registry import REGISTRY

    g.add_argument("--model", default="fast_egnn", choices=sorted(REGISTRY))
    g.add_argument("--dataset", default="nbody",
                   choices=["nbody", "fluid", "protein"])
    g.add_argument("--n-samples", type=int, default=64)
    g.add_argument("--n-nodes", type=int, default=100)
    g.add_argument("--batch", type=int, default=8)
    g.add_argument("--epochs", type=int, default=50)
    g.add_argument("--n-layers", type=int, default=4)
    g.add_argument("--hidden", type=int, default=64)
    g.add_argument("--n-virtual", type=int, default=3)
    g.add_argument("--drop-rate", type=float, default=0.0)
    g.add_argument("--lam-mmd", type=float, default=0.03)
    g.add_argument("--mmd-sigma", type=float, default=1.5)
    g.add_argument("--devices", type=int, default=1)
    g.add_argument("--partition", default="random",
                   choices=["random", "metis"])
    g.add_argument("--checkpoint", default=None)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--layout-cache", default=None, metavar="DIR")
    g.add_argument("--reshuffle", action="store_true")
    g.add_argument("--prefetch", type=int, default=2)
    g.add_argument("--workers", type=int, default=4)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model runs (default: the GPU)")
    sub.add_parser("lm")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        raise NotImplementedError(
            "LM mode needs the LM stack, which the port does not have yet "
            "(ROADMAP queue A #10)")
    gnn_main(args)


if __name__ == "__main__":
    main()
