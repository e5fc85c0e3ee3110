"""Serving launcher: batched greedy decoding with per-layer KV / state caches.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \\
      --batch 4 --prompt-len 16 --gen 32 [--full] [--device cuda|cpu]

The JAX package's ``launch/serve.py`` with the same flags and printout,
plus ``--device`` (default ``cuda``), for all ten configs: the attention
family's layers keep KV caches (or MLA latents), xlstm-125m's and
zamba2-1.2b's recurrent layers their f32 states, zamba2's shared
attention layers full KV caches.  Runs the reduced config by default;
``--full`` runs the published widths and depth.  The weights are random
from ``--seed`` and built in bf16, the compute dtype of ``decode_step``
(the reference builds f32 and casts them every step: the same values).
Whisper's random frame embeddings go through ``encode_audio`` and
llama-vision's random bf16 patch embeddings are taken as they are; both
are kept in the cache (``enc_out``) for the cross-attention layers.  The
prompt is teacher-forced through ``decode_step``, as the reference does
it, then ``--gen`` tokens are decoded greedily.  Prints tokens/s and the
cache footprint.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.archs.model import (decode_step, encode_audio, init_arch,
                                     init_cache)
from repro_torch.configs import get_arch
from repro_torch.kernels import swa_attention
from repro_torch.kernels.runtime import resolve_device


def cache_bytes(cache) -> int:
    """Bytes held by every tensor of a decode cache (KV caches, recurrent
    state tuples, the virtual tokens, the encoder states)."""
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


def modality_inputs(cfg, batch: int, device=None) -> dict:
    """The random modality input a config reads, from seed 1: whisper's
    frame embeddings ``audio`` (B, n_audio_frames, d_model) or
    llama-vision's bf16 patch embeddings ``images`` (B, n_image_tokens,
    d_model); {} for the others."""
    gen = torch.Generator().manual_seed(1)
    dev = resolve_device(device)
    if cfg.has_encoder:
        return {"audio": torch.randn((batch, cfg.n_audio_frames, cfg.d_model),
                                     generator=gen).to(dev)}
    if cfg.cross_attn_every > 0:
        return {"images": torch.randn(
            (batch, cfg.n_image_tokens, cfg.d_model), generator=gen).to(
                dev, torch.bfloat16)}
    return {}


@torch.no_grad()
def run(params, cfg, *, batch: int = 4, prompt_len: int = 16, gen: int = 32,
        capacity: int | None = None, device=None) -> dict:
    """Decode ``batch`` random prompts (seed 1) of ``prompt_len`` tokens,
    then ``gen`` greedy tokens each; prints as the reference does and
    returns the numbers, the prompt and the generated tokens.  Whisper
    encodes its frames and llama-vision reads its patch embeddings (both
    from :func:`modality_inputs`) through the cross-attention layers of
    every step.  ``attention_launches`` counts the attention
    kernel's launches of the decode loop (its cross-attention; 0 on the
    CPU), ``encoder_launches`` those of the encoder;
    ``first_nonfinite_step`` is the first step whose logits are not all
    finite (None if none is: random weights' virtual-token state
    overflows at depth, in the reference as here)."""
    dev = resolve_device(device)
    b = batch
    cap = capacity or (prompt_len + gen)
    prompt = torch.randint(0, cfg.vocab, (b, prompt_len),
                           generator=torch.Generator().manual_seed(1)).to(dev)
    mod = modality_inputs(cfg, b, dev)
    n0 = swa_attention.launches
    enc_out = None
    if cfg.has_encoder:
        enc_out = encode_audio(params, cfg, mod["audio"])
    elif cfg.cross_attn_every > 0:
        enc_out = mod["images"]
    n_enc = swa_attention.launches - n0
    cache = init_cache(cfg, b, cap, enc_out=enc_out, device=dev)
    footprint = cache_bytes(cache)
    print(f"{cfg.name}: cache footprint {footprint/1e6:.1f} MB "
          f"(capacity {cap})")

    def step(tok, t):
        return decode_step(params, cfg, cache, tok,
                           torch.full((b,), t, dtype=torch.int32, device=dev))

    _sync(dev)
    n0 = swa_attention.launches
    finite = []  # a device flag a step: no host sync in the loop
    t0 = time.perf_counter()
    for t in range(prompt_len):
        logits, cache = step(prompt[:, t], t)
        finite.append(torch.isfinite(logits).all())
    generated = []
    for t in range(prompt_len, prompt_len + gen):
        tok = torch.argmax(logits, dim=-1)
        generated.append(tok)
        logits, cache = step(tok, t)
        finite.append(torch.isfinite(logits).all())
    _sync(dev)
    dt = time.perf_counter() - t0
    n_dec = swa_attention.launches - n0
    finite = torch.stack(finite).tolist() if finite else []
    total = b * (prompt_len + gen)
    print(f"decoded {total} tokens in {dt:.2f}s → {total/dt:.1f} tok/s")
    tokens = torch.stack(generated, dim=1).cpu() if generated else \
        torch.zeros((b, 0), dtype=torch.long)
    print("sample:", tokens[0, :16].tolist())
    return {"arch": cfg.name, "batch": b, "prompt_len": prompt_len,
            "gen": gen, "capacity": cap, "cache_bytes": footprint,
            "tokens": total, "seconds": dt, "tokens_per_s": total / dt,
            "attention_launches": n_dec, "encoder_launches": n_enc,
            "first_nonfinite_step": (finite.index(False)
                                     if False in finite else None),
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
