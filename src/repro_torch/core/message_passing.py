"""The real-real edge pathway (Eq. 3 + the real parts of Eqs. 6-7).

:func:`edge_pathway` gathers endpoint features, runs φ1 over
``[h_i | h_j | ‖x_i−x_j‖² | e_ij]``, gates the edge vector with a scalar
head and reduces onto receivers with masked degree normalisation.  With
``use_kernel=True`` and a kernel-eligible spec (:func:`kernel_supported`,
the reference's own rule) it dispatches to ``kernels.ops.edge_pathway`` —
the hand-written CUDA kernels on CUDA tensors, which raise on widths they
do not take.  A spec the reference runs in ``jnp`` (edge attributes,
unnormalised sums, other MLP depths) runs the plain PyTorch path below on
any device, as there, and is counted as ``edge_plain``.
:func:`aggregate_edges` is the masked segment reduce for models whose
per-edge message does not fit the φ1 form (SchNet's cfconv, TFN's paths).

Every reduction here is :func:`segment_sum`: a fixed-order segment sum
that adds each segment's values one at a time in edge order, on every
device (no ``index_add_``, whose CUDA order is not fixed).  Edges with
mask 0 are left out of the sums rather than added as zeros, so the result
does not depend on how many masked slots a Verlet list carries.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.graph import GeometricGraph
from repro_torch.core.mlp import mlp

Tensor = torch.Tensor


class EdgeSpec(NamedTuple):
    """Static description of one model's edge pathway.

    use_h:       gather ``h_i, h_j`` into the φ1 input.
    use_d2:      append ``‖x_i−x_j‖²`` to the φ1 input.
    use_edge_attr: append ``e_ij`` to the φ1 input.
    gate:        'mlp' (scalar gate = φ_x(φ1(·))), 'identity' (φ1 emits
                 the gate) or 'none' (no coordinate update).
    rel:         'raw' (x_i − x_j) or 'inv1p' ((x_i − x_j)/(‖x_i−x_j‖+1)).
    coord_clamp: clamp on the scalar gate.
    normalize:   divide segment sums by the masked receiver degree.
    precision:   kernel compute precision, 'f32' or 'bf16' (bf16 operands
                 of every product, f32 sums); the plain path runs f32.
    """

    use_h: bool = True
    use_d2: bool = True
    use_edge_attr: bool = False
    gate: str = "mlp"
    rel: str = "raw"
    coord_clamp: float = math.inf
    normalize: bool = True
    precision: str = "f32"


class EdgePathwayOut(NamedTuple):
    dx: Optional[Tensor]  # (N, 3) coordinate update, None when gate == 'none'
    mh: Tensor  # (N, M) aggregated messages


def clamp_vector_norm(v: Tensor, max_norm: float) -> Tensor:
    """Equivariantly bound a (..., 3) update: rescale to ``max_norm`` when
    longer (a componentwise clip would break E(3) equivariance)."""
    n = torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-12)
    return v * torch.clamp(max_norm / n, max=1.0)


def segment_sum(values: Tensor, segment_ids: Tensor,
                num_segments: int) -> Tensor:
    """Fixed-order segment sum of ``values`` (E, ...) onto ``num_segments``.

    Each segment's values are added one at a time, starting from zero, in
    their order of appearance — the order the CUDA edge kernel walks its
    CSR rows in.  Implemented as a loop over in-segment ranks: the k-th
    value of every segment is added in one gather/scatter over unique
    indices, so the result is deterministic on every device.
    """
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    e = segment_ids.shape[0]
    if e == 0:
        return out
    ids = segment_ids.long()
    order = torch.argsort(ids, stable=True)
    ids = ids[order]
    counts = torch.bincount(ids, minlength=num_segments)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(e, device=ids.device) - start[ids]
    by_rank = torch.argsort(rank, stable=True)
    ids = ids[by_rank]
    vals = values[order][by_rank]
    off = 0
    for c in torch.bincount(rank).tolist():
        idx = ids[off:off + c]
        out[idx] = out[idx] + vals[off:off + c]
        off += c
    return out


def receiver_degree(g: GeometricGraph) -> Tensor:
    """Masked in-degree per node: Σ_{e: rcv(e)=i} edge_mask_e, (N,)."""
    live = torch.nonzero(g.edge_mask != 0).squeeze(1)
    return segment_sum(g.edge_mask[live], g.receivers[live].long(),
                       g.n_nodes)


def aggregate_edges(values: Tensor, g: GeometricGraph, *,
                    normalize: bool = True) -> Tensor:
    """Masked segment reduce of per-edge values (E, F) onto receivers,
    divided by ``max(deg_i, 1)`` with ``normalize`` (the masked mean).

    ``values`` must already be masked by the caller (multiplied by
    ``edge_mask``), as in the reference; the rows of masked edges are
    left out of the sums rather than added as zeros.
    """
    live = torch.nonzero(g.edge_mask != 0).squeeze(1)
    rcv = g.receivers[live].long()
    out = segment_sum(values[live], rcv, g.n_nodes)
    if normalize:
        deg = segment_sum(g.edge_mask[live], rcv, g.n_nodes)
        inv = 1.0 / torch.clamp(deg, min=1.0)
        out = out * inv.reshape((-1,) + (1,) * (values.ndim - 1))
    return out


def edge_rel_d2(x: Tensor, g: GeometricGraph) -> tuple[Tensor, Tensor]:
    """Edge vectors r_e = x_rcv − x_snd (E, 3) and ‖r_e‖² (E, 1)."""
    rel = x[g.receivers.long()] - x[g.senders.long()]
    return rel, (rel * rel).sum(-1, keepdim=True)


def live_edges(snd: Tensor, rcv: Tensor, em: Tensor):
    """The edges with a nonzero mask: ``(snd, rcv, em)`` restricted to
    them, endpoints as int64 for indexing."""
    live = torch.nonzero(em != 0).squeeze(1)
    return snd[live].long(), rcv[live].long(), em[live]


# --------------------------------------------------------------- telemetry
# Dispatch counters: 'edge_kernel' / 'edge_plain' (this module),
# 'virtual_kernel' / 'virtual_plain' (core.virtual_nodes) and 'mmd_kernel'
# (core.mmd).  PyTorch runs
# eagerly, so counts are per call, not per trace.
DISPATCH_COUNTS: dict[str, int] = {}


def record_dispatch(event: str) -> None:
    DISPATCH_COUNTS[event] = DISPATCH_COUNTS.get(event, 0) + 1


def reset_dispatch_counts() -> None:
    DISPATCH_COUNTS.clear()


def dispatch_counts() -> dict[str, int]:
    return dict(DISPATCH_COUNTS)


def dispatch_mode(counts: dict, use_kernel: bool, backend_mode: str) -> str:
    """Classify the edge dispatch of the calls ``counts`` saw: ``'plain'``
    when the kernel was not asked for (the reference's ``'jnp'``),
    ``backend_mode`` (``kernels.runtime.backend_mode``: ``'cuda'``, or
    ``'cpu'`` where the wrappers run their plain versions) when the kernel
    path was taken, ``'fallback'`` when it was asked for and never taken.
    The CSR layout is always built on the host, so there is no regroup to
    count (the reference's other ``'fallback'`` case)."""
    if not use_kernel:
        return "plain"
    if counts.get("edge_kernel", 0):
        return backend_mode
    return "fallback"


# The reference's kernel-dispatch budget, carried for parity of the
# dispatch decision only: its Pallas edge kernel bounds its per-step VMEM
# footprint, and a layer past that budget runs in jnp there, so here it
# takes the plain path too.  Not a limit of the CUDA kernels, which take
# any width.  Plain integer arithmetic, a copy of the reference's
# `edge_kernel_vmem_bytes` and of what it reads of `pick_windows`.
EDGE_KERNEL_VMEM_BUDGET = 12 * 2**20
EDGE_KERNEL_BLOCK_E = 128
_LANE = 128  # TPU lane width
_DEFAULT_WINDOW = 512  # receiver-window rows
_DEFAULT_SWINDOW = 4096  # sender-window rows


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def pick_windows(n_nodes: int) -> tuple[int, int, int]:
    """The reference's window policy ``(window, swindow, n_pad)`` for an
    ``n_nodes`` graph (its ``kernels.edge_message.pick_windows`` at the
    default band sizes)."""
    base = _round_up(max(n_nodes, 1), _LANE)
    swindow = min(_DEFAULT_SWINDOW, base)
    window = swindow
    for cand in (_DEFAULT_WINDOW, 256, _LANE):
        if swindow % cand == 0:
            window = min(window, cand) if swindow > cand else window
            break
    if swindow % window != 0:
        window = swindow
    return window, swindow, _round_up(max(n_nodes, 1), swindow)


def edge_kernel_vmem_bytes(n_nodes: int, dh: int, h1: int, m: int,
                           block_e: int = EDGE_KERNEL_BLOCK_E) -> int:
    """The reference's per-grid-step VMEM footprint model of its banded
    edge kernel (one-hots, double-buffered node windows, output blocks,
    edge intermediates, weights)."""
    window, swindow, _ = pick_windows(n_nodes)
    f32 = 4
    one_hots = block_e * (swindow + window) * f32
    node_windows = 2 * (swindow + window) * (3 + dh) * f32
    out_blocks = window * (3 + m + 1) * f32
    edge_tmp = block_e * (3 + 1 + 2 * h1 + 2 * m) * f32
    weights = (2 * dh * h1 + 2 * h1 + h1 * m + 2 * m + m * h1) * f32
    return one_hots + node_windows + out_blocks + edge_tmp + weights


def kernel_supported(lp: dict, g: GeometricGraph, spec: EdgeSpec) -> bool:
    """The reference's kernel-dispatch rule, whole, decided from the spec,
    the parameter shapes and the graph's node count: 2-layer φ1 over
    ``[h_i | h_j | d²]``, a 2-layer (or identity) gate, a masked-mean
    reduction, and widths inside the reference's VMEM budget
    (:func:`edge_kernel_vmem_bytes`, with Dh = 1 where φ1 reads no
    features).  Anything else takes the plain path on every device, as
    the reference's ``jnp`` path.  The budget is kept for exact parity of
    the dispatch decision; the CUDA kernels take every width."""
    if spec.use_edge_attr and g.edge_attr.shape[-1] > 0:
        return False
    if not spec.normalize:
        return False
    if len(lp["phi1"]) != 2:
        return False
    if spec.gate == "mlp" and len(lp.get("gate", ())) != 2:
        return False
    w1 = lp["phi1"][0]["w"]
    w2 = lp["phi1"][1]["w"]
    dh = g.feat_dim if spec.use_h else 1
    vmem = edge_kernel_vmem_bytes(g.n_nodes, dh, w1.shape[1], w2.shape[1])
    return vmem <= EDGE_KERNEL_VMEM_BUDGET


def _phi1_features(h: Tensor, d2: Tensor, snd: Tensor, rcv: Tensor,
                   edge_attr: Optional[Tensor], spec: EdgeSpec) -> Tensor:
    feats = []
    if spec.use_h:
        feats.append(h[rcv])
        feats.append(h[snd])
    if spec.use_d2:
        feats.append(d2)
    if edge_attr is not None:
        feats.append(edge_attr)
    return torch.cat(feats, dim=-1)


def edge_pathway(lp: dict, h: Tensor, x: Tensor, g: GeometricGraph,
                 spec: EdgeSpec, *, use_kernel: bool = False,
                 layout=None) -> EdgePathwayOut:
    """The real-real edge pathway (Eq. 3 + real parts of Eqs. 6-7).

    ``lp`` holds ``"phi1"`` and, for ``spec.gate == 'mlp'``, ``"gate"``.
    ``layout`` is this graph's CSR layout ``(indptr, n_edges)`` (see
    ``data.radius_graph.csr_indptr``), optionally followed by the sender
    permutation ``(sperm, sptr)`` the CUDA backward needs
    (``data.radius_graph.csr_sender_perm``); the kernel path needs it, the
    plain path ignores it.  With ``use_kernel`` and a spec the reference
    sends to its kernel, CUDA tensors launch the CUDA kernels or raise;
    a spec the reference runs in ``jnp`` takes the plain path here too.
    """
    if use_kernel and kernel_supported(lp, g, spec):
        from repro_torch.kernels import ops as kops

        dx, mh = kops.edge_pathway(lp, h, x, g, spec, layout)
        record_dispatch("edge_kernel")
        return EdgePathwayOut(dx=dx if spec.gate != "none" else None, mh=mh)
    record_dispatch("edge_plain")

    n = g.n_nodes
    live = torch.nonzero(g.edge_mask != 0).squeeze(1)
    snd, rcv = g.senders[live].long(), g.receivers[live].long()
    em = g.edge_mask[live][:, None]
    ea = None
    if spec.use_edge_attr and g.edge_attr.shape[-1] > 0:
        ea = g.edge_attr[live]
    rel = x[rcv] - x[snd]
    d2 = (rel * rel).sum(-1, keepdim=True)
    msg = mlp(lp["phi1"], _phi1_features(h, d2, snd, rcv, ea, spec))
    cols = [msg * em]
    if spec.gate != "none":
        gate = mlp(lp["gate"], msg) if spec.gate == "mlp" else msg
        gate = torch.clamp(gate, -spec.coord_clamp, spec.coord_clamp)
        if spec.rel == "inv1p":
            rel = rel / (torch.sqrt(d2 + 1e-12) + 1.0)
        cols.append(rel * gate * em)
    cols.append(em)
    sums = segment_sum(torch.cat(cols, dim=-1), rcv, n)
    m = msg.shape[-1]
    mh, deg = sums[:, :m], sums[:, -1:]
    dx = sums[:, m:m + 3] if spec.gate != "none" else None
    if spec.normalize:
        inv = 1.0 / torch.clamp(deg, min=1.0)
        mh = mh * inv
        dx = dx * inv if dx is not None else None
    return EdgePathwayOut(dx=dx, mh=mh)
