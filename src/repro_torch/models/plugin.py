"""The virtual-node mechanism as a generic plug-in (Sec. V).

``virtual_plugin_step`` bundles the auxiliary pathway that Sec. V bolts
onto RF / SchNet / TFN: per-channel real↔virtual messages, the
real-coordinate correction ``(1/C)Σ_c (x_i−z_c)φ_x^v(m_ic)`` and the
virtual-node aggregation, without touching the host model's own update.
With ``use_kernel=True`` the pathway goes through the CUDA virtual
kernels wherever the reference sends it to its Pallas kernel
(:func:`kernel_supported`); FastRF's geometry-only block (zero-width
features) runs the plain composition, as the reference's ``jnp`` path.
"""
from __future__ import annotations

import torch

from repro_torch.core.message_passing import clamp_vector_norm
from repro_torch.core.virtual_nodes import (VirtualState, init_virtual_block,
                                            masked_com,
                                            virtual_aggregate_from_sums,
                                            virtual_global_message,
                                            virtual_kernel_supported,
                                            virtual_pathway)

Tensor = torch.Tensor


def init_plugin(gen: torch.Generator, n_virtual: int, h_dim: int, s_dim: int,
                hidden: int, device=None):
    return init_virtual_block(gen, n_virtual, h_dim, s_dim, hidden,
                              device=device)


def kernel_supported(vb, h: Tensor) -> bool:
    """Alias of :func:`core.virtual_nodes.virtual_kernel_supported`, the
    one home of the virtual-kernel dispatch rule."""
    return virtual_kernel_supported(vb, h)


def virtual_plugin_step(vb, h: Tensor, x: Tensor, vs: VirtualState,
                        node_mask: Tensor, coord_clamp: float = 10.0,
                        use_kernel: bool = False, precision: str = "f32",
                        ) -> tuple[Tensor, Tensor, VirtualState]:
    """One layer of the auxiliary virtual pathway.

    Returns (dx_virtual (N,3), mh_virtual (N,hidden), the updated virtual
    state).  ``coord_clamp`` bounds the coordinate correction per layer by
    a norm rescale (not a componentwise clip), so the pathway stays
    E(3)-equivariant when it binds.
    """
    com = masked_com(x, node_mask)
    mv = virtual_global_message(vs.z, com)
    dx_v, mh_v, dz_sum, ms_sum = virtual_pathway(
        vb, h, x, vs, mv, node_mask, use_kernel=use_kernel,
        precision=precision)
    dx_v = clamp_vector_norm(dx_v, coord_clamp)
    vs_new = virtual_aggregate_from_sums(vb, vs, dz_sum, ms_sum,
                                         node_mask.sum())
    return dx_v, mh_v, vs_new
