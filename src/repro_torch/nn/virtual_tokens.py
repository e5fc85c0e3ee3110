"""Virtual tokens — the paper's virtual-node mechanism adapted to transformers.

The counterpart of the JAX package's ``nn/virtual_tokens.py`` (DESIGN.md
§4): an *ordered* set of C global summary tokens per layer plays the role
FastEGNN's virtual nodes play on geometric graphs:

  read  (≙ Eqs. 5+16/17): each channel c gathers a gated mean of the sequence
        — a pure Σ over tokens (over the whole sequence in a prefill, so the
        read is not causal: ported as the reference has it);
  write (≙ the virtual term of Eq. 6): every position receives a per-channel
        gated combination of the virtual states.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.runtime import resolve_device
from repro_torch.nn.basic import randn

Tensor = torch.Tensor


def init_virtual_tokens(gen, n_channels: int, d_model: int, d_virtual: int, *,
                        device=None, dtype=torch.float32):
    kw = dict(device=resolve_device(device), dtype=dtype)
    c = n_channels
    return {
        "vt_init": randn(gen, (c, d_virtual), scale=0.02, **kw),
        "w_read_gate": randn(gen, (c, d_model, 1), scale=0.02, **kw),
        "w_read": randn(gen, (c, d_model, d_virtual),
                        scale=1.0 / d_model ** 0.5, **kw),
        "w_write_gate": randn(gen, (c, d_model, 1), scale=0.02, **kw),
        "w_write": randn(gen, (c, d_virtual, d_model),
                         scale=1.0 / d_virtual ** 0.5, **kw),
    }


def virtual_token_layer(p, x: Tensor, vt: Tensor, mask: Tensor | None = None
                        ) -> tuple[Tensor, Tensor]:
    """x: (B, S, d); vt: (B, C, dv); mask: (B, S) or None.

    Returns (x + write, vt + read).
    """
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=x.dtype, device=x.device)
    g_read = torch.sigmoid(torch.einsum("bsd,cd->bsc", x,
                                        p["w_read_gate"][..., 0]))
    g_read = g_read * mask[:, :, None]  # (B, S, C)
    # Σ_s g_read x, then each channel's read projection
    num = torch.einsum("bcd,cdv->bcv",
                       torch.einsum("bsc,bsd->bcd", g_read, x), p["w_read"])
    den = torch.sum(g_read, dim=1)[..., None] + 1e-6  # (B, C, 1)
    vt_new = vt + num / den

    g_write = torch.sigmoid(torch.einsum("bsd,cd->bsc", x,
                                         p["w_write_gate"][..., 0]))
    w = torch.einsum("bcv,cvd->bcd", vt_new, p["w_write"])
    add = torch.einsum("bsc,bcd->bsd", g_write, w) / vt.shape[1]
    return x + add * mask[..., None], vt_new


def init_vt_state(p, batch: int) -> Tensor:
    return p["vt_init"][None].expand((batch,) + tuple(p["vt_init"].shape))
