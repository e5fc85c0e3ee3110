"""Serving launcher: batched greedy decoding with per-layer KV caches.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
      --batch 4 --prompt-len 16 --gen 32 [--full] [--device cuda|cpu]

The JAX package's ``launch/serve.py`` with the same flags and printout,
plus ``--device`` (default ``cuda``).  Runs the reduced config by default;
``--full`` runs the published widths and depth.  The weights are random
from ``--seed`` and built in bf16, the compute dtype of ``decode_step``
(the reference builds f32 and casts them every step: the same values).
The prompt is teacher-forced through ``decode_step``, as the reference
does it, then ``--gen`` tokens are decoded greedily.  Prints tokens/s and
the cache footprint.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.archs.model import decode_step, init_arch, init_cache
from repro_torch.configs import get_arch
from repro_torch.kernels.runtime import resolve_device


def cache_bytes(cache) -> int:
    """Bytes held by every tensor of a decode cache."""
    if isinstance(cache, torch.Tensor):
        return cache.numel() * cache.element_size()
    if isinstance(cache, dict):
        cache = list(cache.values())
    if isinstance(cache, (list, tuple)):
        return sum(cache_bytes(c) for c in cache)
    return 0  # None


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def run(params, cfg, *, batch: int = 4, prompt_len: int = 16, gen: int = 32,
        capacity: int | None = None, device=None) -> dict:
    """Decode ``batch`` random prompts (seed 1) of ``prompt_len`` tokens,
    then ``gen`` greedy tokens each; prints as the reference does and
    returns the numbers, the prompt and the generated tokens."""
    dev = resolve_device(device)
    b = batch
    cap = capacity or (prompt_len + gen)
    prompt = torch.randint(0, cfg.vocab, (b, prompt_len),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    cache = init_cache(cfg, b, cap, device=dev)
    footprint = cache_bytes(cache)
    print(f"{cfg.name}: cache footprint {footprint/1e6:.1f} MB "
          f"(capacity {cap})")

    def step(tok, t):
        return decode_step(params, cfg, cache, tok,
                           torch.full((b,), t, dtype=torch.int32, device=dev))

    _sync(dev)
    t0 = time.perf_counter()
    for t in range(prompt_len):
        logits, cache = step(prompt[:, t], t)
    generated = []
    for t in range(prompt_len, prompt_len + gen):
        tok = torch.argmax(logits, dim=-1)
        generated.append(tok)
        logits, cache = step(tok, t)
    _sync(dev)
    dt = time.perf_counter() - t0
    total = b * (prompt_len + gen)
    print(f"decoded {total} tokens in {dt:.2f}s → {total/dt:.1f} tok/s")
    tokens = torch.stack(generated, dim=1).cpu() if generated else \
        torch.zeros((b, 0), dtype=torch.long)
    print("sample:", tokens[0, :16].tolist())
    return {"arch": cfg.name, "batch": b, "prompt_len": prompt_len,
            "gen": gen, "capacity": cap, "cache_bytes": footprint,
            "tokens": total, "seconds": dt, "tokens_per_s": total / dt,
            "prompt": prompt.cpu(), "generated": tokens}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_arch(gen, cfg, device=dev, dtype=torch.bfloat16)
    return run(params, cfg, batch=args.batch, prompt_len=args.prompt_len,
               gen=args.gen, capacity=args.capacity, device=dev)


if __name__ == "__main__":
    main()
