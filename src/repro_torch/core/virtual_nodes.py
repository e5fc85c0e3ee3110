"""Virtual node learning (Secs. IV-A/IV-B, VI).

An ordered set of C virtual nodes ``(Z, S)``: CoM initialisation of the
coordinates (Eq. 2), per-channel learnable features ``S``, the invariant
virtual global message (Eq. 4), per-channel real↔virtual messages (Eq. 5),
the virtual terms of Eqs. 6–7 and the virtual-node aggregation (Eqs. 8–9).
Every channel owns its MLP weights (stacked on a leading axis); the
shared-weight "Global Nodes" ablation keeps rank-2 weights.

An ``axis`` (``core.collectives.GraphAxis``) turns the node sums of the
CoM and of Eqs. 8–9 into cross-shard sums: DistEGNN's Eqs. 16–17.  The
``launch_*`` halves issue a sum and return a pending handle, so the
overlapped layer schedule can put local compute between the launch and
the ``wait()``; the floats are those of the blocking form.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.collectives import GraphAxis, PendingParts
from repro_torch.core.mlp import init_mlp, init_stacked_mlp, mlp
from repro_torch.kernels.runtime import resolve_device

Tensor = torch.Tensor


class VirtualState(NamedTuple):
    z: Tensor  # (C, 3) coordinates
    s: Tensor  # (C, S) invariant features


def launch_com_sums(x: Tensor, node_mask: Tensor,
                    axis: Optional[GraphAxis] = None) -> PendingParts:
    """Issue the CoM sums ``(Σ m_i x_i, Σ m_i)`` over the axis; ``wait()``
    returns them reduced."""
    w = node_mask[:, None]
    return PendingParts(((x * w).sum(0), w.sum()), axis)


def masked_com_sums(x: Tensor, node_mask: Tensor,
                    axis: Optional[GraphAxis] = None) -> tuple[Tensor, Tensor]:
    """The globally reduced ``(Σ m_i x_i, Σ m_i)``."""
    return launch_com_sums(x, node_mask, axis).wait()


def masked_com(x: Tensor, node_mask: Tensor,
               axis: Optional[GraphAxis] = None) -> Tensor:
    """CoM over real nodes (Alg. 1 line 4), over every shard of ``axis``:
    (3,)."""
    tot, cnt = masked_com_sums(x, node_mask, axis)
    return tot / torch.clamp(cnt, min=1.0)


def init_virtual_coords(x: Tensor, node_mask: Tensor, n_channels: int,
                        axis: Optional[GraphAxis] = None) -> Tensor:
    """Eq. 2 / Alg. 1 line 1: every channel starts at the CoM (of the whole
    graph, with ``axis``: Sec. VI)."""
    return masked_com(x, node_mask, axis)[None, :].repeat(n_channels, 1)


def virtual_global_message(z: Tensor, com: Tensor) -> Tensor:
    """Eq. 4: E(3)-invariant Gram matrix of centred virtual coords, (C, C)."""
    zc = z - com[None, :]
    return zc @ zc.T


def init_virtual_block(gen: torch.Generator, n_channels: int, h_dim: int,
                       s_dim: int, hidden: int, shared: bool = False,
                       device=None):
    """Parameters for one layer's virtual pathway: φ2 (message), φ_xv
    (real-coordinate gate), φ_z (virtual-coordinate gate), φ_s (feature
    update).  ``shared=True`` builds the Global Nodes ablation."""
    device = resolve_device(device)
    msg_in = h_dim + s_dim + 1 + n_channels

    def mk(sizes, **kw):
        if shared:
            return init_mlp(gen, sizes, device=device, **kw)
        return init_stacked_mlp(gen, n_channels, sizes, device=device, **kw)

    return {
        "phi2": mk([msg_in, hidden, hidden]),
        "phi_xv": mk([hidden, hidden, 1], final_bias=False),
        "phi_z": mk([hidden, hidden, 1], final_bias=False),
        "phi_s": mk([s_dim + hidden, hidden, s_dim]),
    }


def _apply_channelwise(params, feats: Tensor) -> Tensor:
    """Apply a (possibly per-channel-stacked) MLP over (N, C, F) features."""
    if params[0]["w"].ndim == 2:
        return mlp(params, feats)
    x = feats
    for i, layer in enumerate(params):
        x = torch.einsum("ncf,cfo->nco", x, layer["w"])
        if "b" in layer:
            x = x + layer["b"][None]
        if i < len(params) - 1:
            x = torch.nn.functional.silu(x)
    return x


def virtual_messages(params, h: Tensor, x: Tensor, vs: VirtualState,
                     mv: Tensor) -> Tensor:
    """Eq. 5 (separated form): m_ic = φ2^{(c)}(h_i, s_c, ‖x_i−z_c‖², m^v_:,c),
    (N, C, hidden)."""
    n = x.shape[0]
    c = vs.z.shape[0]
    d2 = ((x[:, None, :] - vs.z[None, :, :]) ** 2).sum(-1)  # (N, C)
    feats = torch.cat([
        h[:, None, :].expand(n, c, h.shape[-1]),
        vs.s[None, :, :].expand(n, c, vs.s.shape[-1]),
        d2[:, :, None],
        mv.T[None, :, :].expand(n, c, c),  # column c of m^v
    ], dim=-1)
    return _apply_channelwise(params["phi2"], feats)


def real_from_virtual(params, x: Tensor, vs: VirtualState,
                      msgs: Tensor) -> tuple[Tensor, Tensor]:
    """Virtual→real terms of Eqs. 6–7: the channel means of
    ``(x_i − z_c)·φ_x^v(m_ic)`` and of ``m_ic``."""
    gate = _apply_channelwise(params["phi_xv"], msgs)  # (N, C, 1)
    rel = x[:, None, :] - vs.z[None, :, :]
    return (rel * gate).mean(1), msgs.mean(1)


def virtual_node_sums(params, x: Tensor, vs: VirtualState, msgs: Tensor,
                      node_mask: Tensor) -> tuple[Tensor, Tensor]:
    """Masked node sums feeding Eqs. 8–9: ``Σ_i m_i (z_c − x_i) φ_Z(m_ic)``
    (C, 3) and ``Σ_i m_i m_ic`` (C, hidden)."""
    w = node_mask[:, None, None]
    gate = _apply_channelwise(params["phi_z"], msgs)
    rel = vs.z[None, :, :] - x[:, None, :]
    return (rel * gate * w).sum(0), (msgs * w).sum(0)


def virtual_kernel_supported(params, h: Tensor) -> bool:
    """The reference's virtual-kernel dispatch rule: the per-channel
    stacked 2-layer form of φ2 / φ_x^v / φ_Z with at least one real
    feature column.  The shared-weight Global Nodes ablation, other MLP
    depths and zero-width features (FastRF's geometry-only plug-in) take
    the plain path on every device, as the reference's ``jnp`` path."""
    for name in ("phi2", "phi_xv", "phi_z"):
        p = params[name]
        if len(p) != 2 or p[0]["w"].ndim != 3:
            return False
    return h.shape[-1] > 0


def virtual_pathway(params, h: Tensor, x: Tensor, vs: VirtualState,
                    mv: Tensor, node_mask: Tensor, *, use_kernel: bool = False,
                    precision=None) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The Eq. 5–9 hot path: ``(dx (N,3), mh (N,hidden), dz_sum (C,3),
    ms_sum (C,hidden))``.  With ``use_kernel`` and an eligible parameter
    block this goes through ``kernels.ops.virtual_pathway`` (the CUDA
    forward and backward kernels on CUDA tensors, which raise on widths
    they do not take), otherwise through the plain composition, counted
    as ``virtual_plain``."""
    from repro_torch.core.message_passing import record_dispatch

    if use_kernel and virtual_kernel_supported(params, h):
        from repro_torch.kernels import ops as kops

        record_dispatch("virtual_kernel")
        return kops.virtual_pathway(params, h, x, vs, mv, node_mask,
                                    precision=precision)
    record_dispatch("virtual_plain")
    msgs = virtual_messages(params, h, x, vs, mv)
    dx, mh = real_from_virtual(params, x, vs, msgs)
    dz_sum, ms_sum = virtual_node_sums(params, x, vs, msgs, node_mask)
    return dx, mh, dz_sum, ms_sum


def launch_virtual_sums(dz_sum: Tensor, ms_sum: Tensor, n_local: Tensor,
                        axis: Optional[GraphAxis] = None) -> PendingParts:
    """Issue the Eqs. 16–17 sums ``(dz_sum, ms_sum, n)`` over the axis as
    one collective (the communication half); ``wait()`` returns them
    reduced, for :func:`finish_virtual_aggregate`."""
    return PendingParts((dz_sum, ms_sum, n_local), axis)


def finish_virtual_aggregate(params, vs: VirtualState, dz_sum: Tensor,
                             ms_sum: Tensor, n_total: Tensor) -> VirtualState:
    """Eqs. 8–9 from already reduced node sums (the compute half):
    ``z_c += dz_sum_c / N`` and ``s_c += φ_S^{(c)}(s_c, ms_sum_c / N)``."""
    n = torch.clamp(n_total, min=1.0)
    z_new = vs.z + dz_sum / n
    s_in = torch.cat([vs.s, ms_sum / n], dim=-1)  # (C, S+hidden)
    if params["phi_s"][0]["w"].ndim == 3:
        ds = _apply_channelwise(params["phi_s"], s_in[None])[0]
    else:
        ds = mlp(params["phi_s"], s_in)
    return VirtualState(z=z_new, s=vs.s + ds)


def virtual_aggregate_from_sums(params, vs: VirtualState, dz_sum: Tensor,
                                ms_sum: Tensor, n_local: Tensor,
                                axis: Optional[GraphAxis] = None
                                ) -> VirtualState:
    """Eqs. 8–9 (or 16–17 with ``axis``) from the node sums."""
    return finish_virtual_aggregate(
        params, vs, *launch_virtual_sums(dz_sum, ms_sum, n_local,
                                         axis).wait())


def virtual_aggregate(params, x: Tensor, vs: VirtualState, msgs: Tensor,
                      node_mask: Tensor,
                      axis: Optional[GraphAxis] = None) -> VirtualState:
    """Eqs. 8–9 (single device) / Eqs. 16–17 (over ``axis``) from the
    messages: ``z_c ← z_c + (1/N) Σ_i (z_c − x_i) φ_Z^{(c)}(m_ic)``,
    ``s_c ← s_c + φ_S^{(c)}(s_c, (1/N) Σ_i m_ic)``."""
    dz_sum, ms_sum = virtual_node_sums(params, x, vs, msgs, node_mask)
    return virtual_aggregate_from_sums(params, vs, dz_sum, ms_sum,
                                       node_mask.sum(), axis)
