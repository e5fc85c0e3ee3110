"""Launchers of the panel path (``csrc/panel.cu``): the edge and virtual
pathways, forward and backward, at feature widths above 64.

The callers (``kernels.edge_message`` / ``kernels.virtual_message``) pick
this route, zero-pad every width up to a multiple of 64, hand over the
padded operands as one list in their kernels' argument order, and slice
the padded outputs back; these functions allocate the outputs (forwards)
and the scratch, launch, and check the return code.  CUDA tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib: ctypes.CDLL) -> None:
    build.common_bind(lib)
    for name, n_int in (("panel_edge_fwd_scratch_floats", 4),
                        ("panel_edge_bwd_scratch_floats", 6),
                        ("panel_virtual_fwd_scratch_floats", 2),
                        ("panel_virtual_bwd_scratch_floats", 3)):
        getattr(lib, name).argtypes = [_I] * n_int
        getattr(lib, name).restype = ctypes.c_longlong
    lib.panel_edge_forward.argtypes = [_P] * 18 + [_I] * 7 + [_F, _I, _P]
    lib.panel_edge_backward.argtypes = [_P] * 31 + [_I] * 7 + [_F, _I, _P]
    lib.panel_virtual_forward.argtypes = [_P] * 20 + [_I] * 5 + [_P]
    lib.panel_virtual_backward.argtypes = [_P] * 34 + [_I] * 5 + [_P]
    for name in ("panel_edge_forward", "panel_edge_backward",
                 "panel_virtual_forward", "panel_virtual_backward"):
        getattr(lib, name).restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return build.load("panel", _bind)


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def edge_forward(ins: list, d: int, h: int, m: int, gate: int,
                 rel_inv1p: int, clamp: float, bf16: bool) -> tuple:
    """``ins``: x, h (N, d), snd, em, indptr and the nine padded weights;
    ``gate`` 0 'none', 1 'mlp', 2 'identity'; ``bf16``: the bf16 mode →
    ``(dx, mh (N, m), deg)``."""
    lib = _lib()
    x, snd = ins[0], ins[2]
    dev, n, e = x.device, x.shape[0], snd.shape[0]
    dx, mh, deg = _empty(dev, n, 3), _empty(dev, n, m), _empty(dev, n, 1)
    scratch = _empty(dev, int(lib.panel_edge_fwd_scratch_floats(n, e, h, m)))
    ptrs = [t.data_ptr() for t in (*ins, dx, mh, deg, scratch)]
    err = lib.panel_edge_forward(*ptrs, n, e, d, h, m, gate, rel_inv1p,
                                 clamp, int(bf16), build.stream_ptr(dev))
    build.check(lib, err, "panel_edge_forward")
    return dx, mh, deg


def edge_backward(ins: list, outs: tuple, d: int, h: int, m: int,
                  gate: int, rel_inv1p: int, clamp: float, bf16: bool) -> None:
    """``ins``: the edge backward's 19 padded operands; fills ``outs``, its
    11 padded gradients (the gate's three only for gate 1, 'mlp')."""
    lib = _lib()
    x, snd = ins[0], ins[2]
    dev, n, e = x.device, x.shape[0], snd.shape[0]
    scratch = _empty(dev, int(lib.panel_edge_bwd_scratch_floats(
        n, e, d, h, m, int(bf16))))
    ptrs = [t.data_ptr() for t in (*ins, *outs, scratch)]
    err = lib.panel_edge_backward(*ptrs, n, e, d, h, m, gate, rel_inv1p,
                                  clamp, int(bf16), build.stream_ptr(dev))
    build.check(lib, err, "panel_edge_backward")


def virtual_forward(ins: list, d: int, w: int, bf16: bool) -> tuple:
    """``ins``: the virtual forward's 15 padded operands (Dh = d, hid = w)
    → ``(dx, mh (N, w), dz_sum, ms_sum (C, w))``."""
    lib = _lib()
    x, z = ins[0], ins[2]
    dev, n, c = x.device, x.shape[0], z.shape[0]
    dx, mh = _empty(dev, n, 3), _empty(dev, n, w)
    dz, ms = _empty(dev, c, 3), _empty(dev, c, w)
    scratch = _empty(dev, int(lib.panel_virtual_fwd_scratch_floats(n, w)))
    ptrs = [t.data_ptr() for t in (*ins, dx, mh, dz, ms, scratch)]
    err = lib.panel_virtual_forward(*ptrs, n, c, d, w, int(bf16),
                                    build.stream_ptr(dev))
    build.check(lib, err, "panel_virtual_forward")
    return dx, mh, dz, ms


def virtual_backward(ins: list, grads: tuple, d: int, w: int,
                     bf16: bool) -> None:
    """``ins``: the 15 padded operands and the four padded cotangents;
    fills ``grads``, the 14 padded gradients."""
    lib = _lib()
    x, z = ins[0], ins[2]
    dev, n, c = x.device, x.shape[0], z.shape[0]
    scratch = _empty(dev, int(lib.panel_virtual_bwd_scratch_floats(n, d, w)))
    ptrs = [t.data_ptr() for t in (*ins, *grads, scratch)]
    err = lib.panel_virtual_backward(*ptrs, n, c, d, w, int(bf16),
                                     build.stream_ptr(dev))
    build.check(lib, err, "panel_virtual_backward")
