"""Training launcher: GNN mode and LM mode.

    python -m repro_torch.launch.train gnn --dataset nbody --epochs 50 \
        [--devices 2] [--layout-cache DIR] [--reshuffle]
    python -m repro_torch.launch.train lm --arch xlstm-125m --steps 100 \
        [--batch 4] [--seq 128] [--lr 3e-4] [--full] [--device cpu]

Builds ``--model`` (any name of ``models.registry``; default fast_egnn)
with ``build_pipeline`` (random weights from ``--seed``), streams the
batches of ``--dataset`` (nbody, fluid or protein, generated from their
seeds) with ``Pipeline.make_batches`` (``--workers`` build threads,
``--prefetch`` batches ahead; ``--layout-cache DIR`` keeps the CSR
layouts on disk and prints the cache's counters; ``--reshuffle``
reshuffles the training stream each epoch) and trains with
``Pipeline.fit``.  The flags, their defaults and the per-model keywords
are the JAX package's ``launch/train.py`` (keywords a model's config does
not have, such as RF's ``h_in``, are left out), plus ``--device``: the
model runs on CUDA through the hand-written kernels, or with ``--device
cpu`` through their plain PyTorch versions.  ``--devices D`` > 1 trains
DistEGNN (the model pinned to fast_egnn, Sec. VI): D ranks started on
this machine (``launch.mesh.spawn_ranks``), each on its own shard of
every batch (``--partition``), over NCCL with a GPU each or gloo when
they share one GPU or run on the CPU.

LM mode trains an LM config (``--arch``, any name of ``configs``; its
``reduced()`` variant unless ``--full``) as the JAX package's ``lm_main``
does: f32 master weights from ``--seed``, bf16 compute,
``training.lm.make_train_step`` with Adam (``cosine_schedule(--lr, 20,
--steps)``, grad_clip 1.0), on one synthetic batch of an order-1 stream
(token t+1 = 7·token t + 13 mod min(V, 512)) drawn from a
``torch.Generator`` seeded 0, with random audio frames / image embeddings
for the whisper / vlm backbones.  It prints the parameter count and the
loss every ``steps // 20`` steps in the reference's format; the stream's
values are not ``jax.random``'s.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def config_kwargs(model: str, kw: dict) -> dict:
    """The launcher's keywords that ``model``'s config has."""
    from repro_torch.models.registry import REGISTRY

    fields = REGISTRY[model].make_config._fields
    return {k: v for k, v in kw.items() if k in fields}


def gnn_main(args) -> None:
    if args.devices > 1:
        from repro_torch.launch.mesh import spawn_ranks

        spawn_ranks(_gnn_rank, args.devices, args, device=args.device)
        return
    train_gnn(args)


def _gnn_rank(rank: int, world: int, args) -> None:
    from repro_torch.distributed.dist_egnn import make_gnn_mesh

    train_gnn(args, make_gnn_mesh(world, device=args.device))


def dataset(name: str, n_samples: int, n_nodes: int) -> tuple:
    """``(samples, r, h_in)`` of a dataset, as the JAX package's launcher
    sets them: nbody fully connected (r = ∞) with one charge feature,
    fluid r = 0.035, protein r = 10 Å with four residue-type features."""
    if name == "nbody":
        from repro_torch.data.nbody import generate_nbody_dataset

        return generate_nbody_dataset(n_samples, n_nodes=n_nodes), np.inf, 1
    if name == "fluid":
        from repro_torch.data.fluid import generate_fluid_dataset

        return (generate_fluid_dataset(n_samples, n_particles=n_nodes),
                0.035, 1)
    from repro_torch.data.protein import generate_protein_dataset

    return generate_protein_dataset(n_samples, n_res=n_nodes), 10.0, 4


def train_gnn(args, mesh=None) -> None:
    """Generate the data, build the pipeline (on ``mesh``, DistEGNN, when
    given), stream the batches, fit, report and checkpoint (rank 0 of a
    mesh)."""
    import torch

    from repro_torch.pipeline import build_pipeline
    from repro_torch.training.checkpoint import save_checkpoint
    from repro_torch.training.trainer import TrainConfig

    lead = mesh is None or mesh.rank == 0
    data, r, h_in = dataset(args.dataset, args.n_samples, args.n_nodes)
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
    # the streaming data plane: batches built by --workers threads,
    # --prefetch ahead; --layout-cache keeps the CSR layouts on disk
    bk = dict(r=r, drop_rate=args.drop_rate, partition=args.partition,
              prefetch=args.prefetch, num_workers=args.workers,
              cache_dir=args.layout_cache)
    # reshuffle the training stream only: a reshuffled validation stream
    # would move the early-stopping metric with its batching
    tr = pipe.make_batches(data[:n_tr], args.batch,
                           reshuffle_each_epoch=args.reshuffle,
                           shuffle_seed=args.seed if args.reshuffle else None,
                           **bk)
    va = pipe.make_batches(data[n_tr:], args.batch, **bk)
    res = pipe.fit(tr, va, verbose=lead)
    if not lead:
        return
    if args.layout_cache:
        from repro_torch.data.layout_cache import cache_stats

        print("layout cache:", cache_stats())
    print(f"best val MSE: {res.best_val:.6f}  wall: {res.wall_time:.1f}s"
          f"  device: {pipe.device}  devices: {args.devices}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, res.params,
                        {"model": args.model, "val_mse": res.best_val})
        print("saved", args.checkpoint)


def synthetic_lm_batch(cfg, batch: int, seq: int, gen: torch.Generator,
                       device) -> dict:
    """The reference launcher's synthetic batch: (batch, seq) tokens of an
    order-1 stream in ``[0, min(V, 512))`` and the next tokens as labels
    (+ 'audio' / 'images' stubs), drawn from ``gen`` and moved to
    ``device``."""
    v = min(cfg.vocab, 512)
    tokens = torch.randint(0, v, (batch, seq + 1), generator=gen)
    tokens[:, 1:] = (tokens[:, :-1] * 7 + 13) % v
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.has_encoder:
        out["audio"] = torch.randn((batch, cfg.n_audio_frames, cfg.d_model),
                                   generator=gen)
    if cfg.cross_attn_every:
        out["images"] = torch.randn((batch, cfg.n_image_tokens, cfg.d_model),
                                    generator=gen)
    return {k: t.to(device) for k, t in out.items()}


def lm_main(args) -> None:
    """Train ``--arch`` for ``--steps`` steps on one synthetic batch."""
    from repro_torch.archs.model import init_arch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.runtime import resolve_device
    from repro_torch.training.lm import make_train_step
    from repro_torch.training.optim import Adam, cosine_schedule, tree_leaves

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = init_arch(torch.Generator(device=dev).manual_seed(args.seed),
                       cfg, device=dev)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{cfg.name}: {n_params/1e6:.1f}M params")
    opt = Adam(lr=cosine_schedule(args.lr, 20, args.steps), grad_clip=1.0)
    state = opt.init(params)
    step = make_train_step(cfg, opt)
    batch = synthetic_lm_batch(cfg, args.batch, args.seq,
                               torch.Generator().manual_seed(0), dev)
    t0 = time.time()
    for i in range(args.steps):
        params, state, m = step(params, state, batch)
        if i % max(1, args.steps // 20) == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"nll {float(m['nll']):.4f}", flush=True)
    print(f"{args.steps} steps in {time.time()-t0:.1f}s")


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
    li = sub.add_parser("lm")
    li.add_argument("--arch", required=True)
    li.add_argument("--steps", type=int, default=100)
    li.add_argument("--batch", type=int, default=4)
    li.add_argument("--seq", type=int, default=128)
    li.add_argument("--lr", type=float, default=3e-4)
    li.add_argument("--reduced", action="store_true", default=True)
    li.add_argument("--full", dest="reduced", action="store_false")
    li.add_argument("--seed", type=int, default=0)
    li.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (default: the GPU)")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        lm_main(args)
    else:
        gnn_main(args)


if __name__ == "__main__":
    main()
