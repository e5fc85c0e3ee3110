"""Device-resident neighbour search: the Verlet rebuild on the GPU.

Counterpart of the JAX package's ``data/cell_list.py`` (DESIGN.md §13).
:func:`device_radius_build` bins the nodes into cells of side at least
``r_build`` (one flattened-key sort), looks up each node's 27 stencil
cells with ``searchsorted`` and sweeps a static window of ``cell_cap``
candidates per cell; :func:`device_csr` turns its output into the CSR
layout ``(indptr, n_edges)`` the edge kernel walks.  Everything stays on
the device and no step waits for the host: there is no boolean-mask
indexing, ``nonzero`` or ``.item()`` inside.

Bitwise contract: the edges are exactly the host build's at the same
capacities, ``pad_edges(*sort_edges_by_receiver(*radius_graph(x, r)),
edge_cap, x)``, and :func:`device_csr` is ``csr_indptr`` of them.

1. The stencil enumerates every pair within ``r_build`` (any such pair is
   in adjacent cells), and the keep predicate is the host's f32
   arithmetic: ``d² = dx·dx + dy·dy + dz·dz`` added in axis order, each
   product rounded on its own, against ``f32(r_build)²``.
2. Over capacity the ``edge_cap`` lowest edges under ``(d², receiver,
   sender)`` are kept: a stable sort by d² over the canonical order, as
   ``pad_edges`` does.
3. Kept edges are packed in ``(receiver, sender)`` order; the tail slots
   are zero.

``cell_cap`` bounds the candidates taken from one cell.  A build whose
densest cell holds more (or whose integer grid would overflow the int32
key space) sets ``overflow`` instead of dropping neighbours; the rollout
engines then grow ``cell_cap`` and build again, on the device.

The build is plain PyTorch (sorts, ``searchsorted``, gathers, a top-k
and cumsums), as the JAX package's is plain ``jnp``; a hand-written
pair-sweep kernel could replace the candidate block later without
touching the contract.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

# Headroom multiplier for the auto-sized per-cell capacity: densities
# drift during a rollout and an overflow costs a second build, while the
# candidate block grows linearly with cell_cap.
DEFAULT_CELL_HEADROOM = 1.5

_CENTER = 13  # flat index of offset (0, 0, 0) in the 3×3×3 stencil
_GRID_LIMIT = float(2 ** 30)  # int32-injectivity bound on Dx·Dy·Dz
_MAX_DIM = 1000.0  # per-axis cell-grid bound: (1000 + 3)³ < 2³⁰


class DeviceBuild(NamedTuple):
    """One device rebuild: padded canonical edges and validity scalars.

    Shapes are of one scene; a batched build puts the scene axis first.
    """

    senders: Tensor  # (edge_cap,) int32, canonical order, masked = 0
    receivers: Tensor  # (edge_cap,) int32
    edge_mask: Tensor  # (edge_cap,) float32
    n_edges: Tensor  # () int32: edges found before truncation
    max_occupancy: Tensor  # () int32: the densest real cell
    overflow: Tensor  # () bool: cell_cap exceeded or grid too large


def _masked_extrema(a: Tensor, real: Tensor) -> tuple[Tensor, Tensor]:
    """Per-axis min and max of ``a`` (B, n, 3) over the real rows."""
    inf = torch.tensor(float("inf"), dtype=a.dtype, device=a.device)
    m = real[..., None]
    return (torch.where(m, a, inf).amin(dim=1),
            torch.where(m, a, -inf).amax(dim=1))


def _row_cumsum(flags: Tensor) -> tuple[Tensor, Tensor]:
    """Inclusive count of ``flags`` (B, m) over the rows laid end to end,
    flat (B·m,) int64, and each row's count of the rows before it (B,).

    One scan over the flat array: on the card a scan along the last axis
    of a few long rows runs far slower than a flat one.
    """
    b, m = flags.shape
    cum = torch.cumsum(flags.reshape(-1), dim=0)
    before = torch.zeros(b, dtype=cum.dtype, device=cum.device)
    before[1:] = cum[m - 1:(b - 1) * m:m]
    return cum, before


def device_radius_build(x: Tensor, node_mask: Tensor, *, r_build: float,
                        edge_cap: int, cell_cap: int) -> DeviceBuild:
    """All pairs within ``r_build``, padded to ``edge_cap``, on ``x``'s
    device.

    ``x`` is (n, 3) or a batch (B, n, 3) of node-capacity padded
    coordinates, ``node_mask`` (n,) or (B, n) with > 0 marking real rows.
    Masked rows are hashed to unique sentinel cells, so they never occupy
    (or overflow) a real cell.  Each scene's output is bitwise the host
    build at the same capacities (module docstring).
    """
    single = x.dim() == 2
    if single:
        x, node_mask = x[None], node_mask[None]
    dev = x.device
    b, n = x.shape[0], x.shape[1]
    x = x.to(torch.float32)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
    rb = f32(r_build)
    real = node_mask > 0  # (B, n)

    # --- spatial hash: flatten 3-D cells into one sortable key ----------
    # The cell is at least r_build wide and grows with the extent so that
    # Dx·Dy·Dz stays inside the int32 key budget; the 27-stencil of a
    # coarser grid still holds every pair within r_build, and the exact d²
    # predicate below selects, so the edges do not depend on the cell.
    xm, xM = _masked_extrema(x, real)
    cs = torch.maximum(rb, (xM - xm).amax(dim=-1) / f32(_MAX_DIM))  # (B,)
    cf = torch.floor(x / cs[:, None, None])  # (B, n, 3) f32 cell coords
    mn, mx = _masked_extrema(cf, real)
    spans = mx - mn + 3.0  # one ghost cell per face
    any_real = real.any(dim=1)
    grid_ok = ((torch.isfinite(spans).all(dim=-1)
                & (spans[:, 0] * spans[:, 1] * spans[:, 2] < _GRID_LIMIT))
               # an all-masked scene has no pairs to find: never a reason
               # to flag an overflow
               | ~any_real)
    spans = torch.where(grid_ok[:, None], spans, f32(3.0)).to(torch.int64)
    d1, d2_ = spans[:, 1:2], spans[:, 2:3]  # (B, 1)
    c = torch.where(grid_ok[:, None, None] & real[..., None],
                    cf - mn[:, None, :] + 1.0, f32(0.0)).to(torch.int64)
    key = (c[..., 0] * d1 + c[..., 1]) * d2_ + c[..., 2]  # (B, n)
    # unique sentinel keys beyond the real grid for masked rows (real
    # stencil probes stay below the grid volume, so nothing aliases)
    grid_vol = spans[:, 0:1] * d1 * d2_
    ar_n = torch.arange(n, device=dev)
    key = torch.where(real, key, grid_vol + ar_n)

    sk, order = torch.sort(key, dim=1, stable=True)
    off = torch.tensor([-1, 0, 1], dtype=torch.int64, device=dev)
    off3 = (off[:, None, None], off[None, :, None], off[None, None, :])
    off_flat = ((off3[0][None] * d1[:, :, None, None] + off3[1][None])
                * d2_[:, :, None, None] + off3[2][None]).reshape(b, 27)
    probe = (key[:, :, None] + off_flat[:, None, :]).reshape(b, n * 27)
    lo = torch.searchsorted(sk, probe, side="left").reshape(b, n, 27)
    hi = torch.searchsorted(sk, probe, side="right").reshape(b, n, 27)
    cnt = hi - lo  # (B, n, 27) bucket sizes

    occ = torch.where(real, cnt[..., _CENTER],
                      torch.zeros_like(cnt[..., _CENTER])).amax(dim=1)
    overflow = (occ > cell_cap) | ~grid_ok

    # --- candidate sweep: a static window of cell_cap per stencil cell --
    ar = torch.arange(cell_cap, device=dev)
    cidx = torch.clamp(lo[..., None] + ar, 0, n - 1).reshape(b, -1)
    cand = torch.gather(order, 1, cidx).reshape(b, n, 27 * cell_cap)
    in_bucket = (ar < cnt[..., None]).reshape(b, n, -1)
    cand_real = torch.gather(real, 1, cand.reshape(b, -1)).reshape(cand.shape)
    valid = (in_bucket & (cand != ar_n[None, :, None])
             & real[..., None] & cand_real)
    # d² as the host adds it: three rounded products summed in axis order
    # (separate ops: a reduction's order on the card is not promised)
    flat = cand.reshape(b, -1)
    sq = []
    for a in range(3):
        xa = x[..., a]
        da = torch.gather(xa, 1, flat).reshape(cand.shape) - xa[..., None]
        sq.append(da * da)
    d2 = (sq[0] + sq[1]) + sq[2]
    del sq
    valid &= d2 <= rb * rb

    # --- canonical (receiver, sender) order: rows are receiver-major, so
    # one stable sort by sender within each row finishes it; the sorted
    # keys are the senders (int32 keys: half the radix passes of int64) --
    big = torch.iinfo(torch.int32).max
    snd_flat, rord = torch.sort(
        torch.where(valid, cand.to(torch.int32), big), dim=-1, stable=True)
    d2_flat = torch.gather(d2, -1, rord).reshape(b, -1)
    del rord, d2, valid, cand
    snd_flat = snd_flat.reshape(b, -1)
    val_flat = snd_flat != big
    k = 27 * cell_cap
    m = n * k

    # --- drop-longest under (d², receiver, sender), the pad_edges rule: a
    # stable sort by d² over the canonical order keeps the edge_cap
    # smallest, i.e. every edge below the edge_cap-th smallest d² (t) and,
    # of the ties at t, the first ones in canonical order ----------------
    if edge_cap >= m:
        kept = val_flat
    else:
        inf = f32(float("inf"))
        dkey = torch.where(val_flat, d2_flat, inf)
        t = torch.topk(dkey, edge_cap, dim=-1, largest=False,
                       sorted=False).values.amax(dim=-1, keepdim=True)
        below = dkey < t  # never an invalid slot: those hold inf
        tie = val_flat & (dkey == t)
        tie_cum, before = _row_cumsum(tie)
        room = edge_cap - below.sum(dim=-1, keepdim=True) + before[:, None]
        kept = below | (tie & (tie_cum.reshape(b, m) <= room))

    # --- compact: output slot j takes the (j+1)-th kept edge of its row;
    # slots past the row's last one stay zero ------------------------------
    cum, before = _row_cumsum(kept)
    want = before[:, None] + torch.arange(1, edge_cap + 1, device=dev)
    row0 = torch.arange(b, device=dev)[:, None] * m
    idx = torch.searchsorted(cum, want.reshape(-1), side="left")
    idx = idx.reshape(b, edge_cap) - row0
    live = idx < m
    idx = torch.clamp(idx, max=m - 1)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    out = DeviceBuild(
        senders=torch.where(live, torch.gather(snd_flat, 1, idx), zero),
        receivers=torch.where(live, (idx // k).to(torch.int32), zero),
        edge_mask=live.to(torch.float32),
        n_edges=val_flat.sum(dim=1).to(torch.int32),
        max_occupancy=occ.to(torch.int32), overflow=overflow)
    if single:
        return DeviceBuild(*(t[0] for t in out))
    return out


def device_csr(receivers: Tensor, edge_mask: Tensor,
               n_nodes: int) -> tuple[Tensor, Tensor]:
    """CSR layout ``(indptr, n_edges)`` of a fresh device build, on the
    device: ``indptr`` (n_nodes + 1,) int32 and ``n_edges`` () int32, or
    with a leading scene axis for a batch.

    Bitwise ``data.radius_graph.csr_indptr(receivers, n_edges, n_nodes)``:
    a build's live slots come first, in receiver order, so mapping the
    masked tail to ``n_nodes`` keeps the row sorted, and row ``i`` starts
    at the count of receivers below ``i``.
    """
    rk = torch.where(edge_mask > 0, receivers.to(torch.int64),
                     torch.full_like(receivers, n_nodes, dtype=torch.int64))
    rows = torch.arange(n_nodes + 1, device=receivers.device)
    if rk.dim() > 1:
        rows = rows.expand(rk.shape[0], n_nodes + 1).contiguous()
    indptr = torch.searchsorted(rk, rows, side="left").to(torch.int32)
    n_edges = (edge_mask > 0).sum(dim=-1).to(torch.int32)
    return indptr, n_edges


# ------------------------------------------------------------- host sizing
def cell_occupancy(x: np.ndarray, r_build: float) -> int:
    """Densest-cell occupancy of ``x`` at cell size ``r_build`` (numpy).

    Sizes ``cell_cap`` at an engine's first run; the device build measures
    it again at every rebuild and flags an overflow.
    """
    x = np.asarray(x)
    if x.shape[0] == 0:
        return 1
    rt = x.dtype.type(r_build)
    cell = np.floor(x / rt).astype(np.int64)
    c = cell - cell.min(axis=0)
    dims = c.max(axis=0) + 1
    key = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
    return int(np.bincount(np.unique(key, return_inverse=True)[1]).max())


def auto_cell_cap(occupancy: int,
                  headroom: float = DEFAULT_CELL_HEADROOM) -> int:
    """Per-cell candidate capacity from a measured occupancy."""
    return max(4, int(math.ceil(occupancy * headroom)) + 1)
