"""Mixture-of-Experts FFN: token-choice top-k router, sort-based dispatch.

The counterpart of the JAX package's ``nn/moe.py``.  Token slots are
sorted by expert id (a stable sort) and gathered into a fixed (E·C, d)
buffer, the expert SwiGLUs run as batched products over the stacked
expert weights (E, d, ff) — plain ``torch.einsum``: the reference leaves
them to XLA, outside any Pallas kernel — and slots beyond an expert's
capacity C are dropped (Switch-style), with the auxiliary load-balance
loss.  Optional shared experts (DeepSeek-V2) run densely on every token.

The dispatch is integer-exact against the reference: the capacity in
Python floats as there, top-k with the lower expert index first on ties
(``lax.top_k``'s rule; ``torch.topk`` promises no order on ties, so a
stable descending sort takes its place), the same stable slot order.  The
combine adds each token's k contributions in that slot order (ascending
expert id), one add at a time in the tokens' dtype, as the reference's
``.at[src_tok].add`` does; it gathers them into (T, k, d) and adds the k
columns in turn, so no float atomics decide the order and a repeated run
is bitwise equal.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.runtime import resolve_device
from repro_torch.nn.basic import dense_init, init_swiglu, randn, swiglu

Tensor = torch.Tensor


def init_moe(gen, d_model: int, d_expert_ff: int, n_experts: int, top_k: int,
             n_shared: int = 0, d_shared_ff: Optional[int] = None, *,
             device=None, dtype=torch.float32):
    """Router (d, E) at scale 0.02, stacked expert SwiGLUs (E, d, ff) /
    (E, ff, d) at the reference's 1/√fan-in, and the shared experts'
    SwiGLU (width ``(d_shared_ff or d_expert_ff) · n_shared``)."""
    kw = dict(device=resolve_device(device), dtype=dtype)
    e, d, ff = n_experts, d_model, d_expert_ff
    p = {
        "router": dense_init(gen, d, e, scale=0.02, **kw),
        "experts": {
            "w_gate": randn(gen, (e, d, ff), scale=d ** -0.5, **kw),
            "w_up": randn(gen, (e, d, ff), scale=d ** -0.5, **kw),
            "w_down": randn(gen, (e, ff, d), scale=ff ** -0.5, **kw),
        },
    }
    if n_shared > 0:
        p["shared"] = init_swiglu(gen, d, (d_shared_ff or d_expert_ff)
                                  * n_shared, **kw)
    return p


def router_top_k(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The k largest entries of each row and their indices, largest first
    and, among equal values, the lower index first (``lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(
    p,
    x: Tensor,  # (B, S, d)
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float = 1.25,
    router_dtype=torch.float32,
    grouped: bool = False,
) -> tuple[Tensor, Tensor]:
    """Returns (output (B,S,d), aux load-balance loss scalar).

    ``grouped=True``: the dispatch runs per batch row (per-row capacity,
    the reference's GShard-style groups), and aux is the mean of the rows'.
    """
    kw = dict(n_experts=n_experts, top_k=top_k,
              capacity_factor=capacity_factor, router_dtype=router_dtype)
    if grouped:
        outs, auxs = zip(*(_moe_tokens(p, row, **kw) for row in x))
        return torch.stack(outs), torch.stack(auxs).mean()
    out, aux = _moe_tokens(p, x.reshape(-1, x.shape[-1]), **kw)
    return out.reshape(x.shape), aux


def dispatch(flat_e: Tensor, n_experts: int, capacity: int):
    """The sort-based dispatch of the slots' expert ids ``flat_e`` (T·k,):
    (order, counts, keep, dst) as the reference computes them — the stable
    slot order by expert, the slots an expert gets, whether each sorted
    slot fits its expert's capacity, and its row of the (E·C + 1) buffer
    (the last row takes the dropped slots)."""
    n_slot = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)  # slots grouped by expert
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(n_slot, device=flat_e.device) - starts[sorted_e]
    keep = pos_in_e < capacity
    dst = torch.where(keep, sorted_e * capacity + pos_in_e,
                      n_experts * capacity)
    return order, counts, keep, dst


def _moe_tokens(
    p,
    tokens: Tensor,  # (T, d)
    *,
    n_experts: int,
    top_k: int,
    capacity_factor: float,
    router_dtype=torch.float32,
) -> tuple[Tensor, Tensor]:
    """Sort-based dispatch over one token group; returns ((T,d), aux)."""
    n_tok, d = tokens.shape
    n_slot = n_tok * top_k
    logits = tokens.to(router_dtype) @ p["router"].to(router_dtype)  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = router_top_k(probs, top_k)  # (T, k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    capacity = max(1, int(capacity_factor * n_tok * top_k / n_experts))
    flat_e = idx.reshape(n_slot)
    flat_gate = gate_vals.reshape(n_slot).to(tokens.dtype)
    order, counts, keep, dst = dispatch(flat_e, n_experts, capacity)

    src_tok = order // top_k
    buf = tokens.new_zeros((n_experts * capacity, d))
    buf[dst[keep]] = tokens[src_tok[keep]]  # kept rows are distinct
    xe = buf.reshape(n_experts, capacity, d)

    we = p["experts"]
    he = F.silu(torch.einsum("ecd,edf->ecf", xe, we["w_gate"])) * torch.einsum(
        "ecd,edf->ecf", xe, we["w_up"])
    ye = torch.einsum("ecf,efd->ecd", he, we["w_down"]).reshape(
        n_experts * capacity, d)
    ye = torch.cat([ye, ye.new_zeros((1, d))], dim=0)

    contrib = ye[dst] * (flat_gate[order] * keep.to(tokens.dtype))[:, None]
    # each token's k contributions in slot order: the sorted positions of
    # its slots, ascending, then added one at a time in the tokens' dtype
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n_slot, device=order.device)
    by_tok = contrib[torch.sort(rank.reshape(n_tok, top_k), dim=1).values]
    out = by_tok[:, 0]
    for j in range(1, top_k):
        out = out + by_tok[:, j]

    if "shared" in p:
        out = out + swiglu(p["shared"], tokens)

    # Switch-style load balance: E · Σ_e f_e · P_e
    f = counts.to(router_dtype) / n_slot
    pr = torch.mean(probs, dim=0)
    aux = n_experts * torch.sum(f * pr)
    return out, aux


def moe_ffn_ref_dense(p, x: Tensor, *, n_experts: int, top_k: int) -> Tensor:
    """Oracle: run every expert on every token, combine with top-k gates.

    O(E·T·d·ff) — tiny shapes only; used by tests to validate the dispatch.
    """
    b, s, d = x.shape
    tokens = x.reshape(b * s, d)
    logits = tokens.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = router_top_k(probs, top_k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    we = p["experts"]
    he = F.silu(torch.einsum("td,edf->etf", tokens, we["w_gate"])) * \
        torch.einsum("td,edf->etf", tokens, we["w_up"])
    ye = torch.einsum("etf,efd->etd", he, we["w_down"])  # (E, T, d)
    gate_full = torch.zeros((b * s, n_experts), dtype=x.dtype,
                            device=x.device)
    gate_full.scatter_(1, idx, gate_vals.to(x.dtype))
    out = torch.einsum("etd,te->td", ye, gate_full)
    if "shared" in p:
        out = out + swiglu(p["shared"], tokens)
    return out.reshape(b, s, d)
