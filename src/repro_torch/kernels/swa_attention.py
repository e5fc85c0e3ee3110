"""Flash causal sliding-window attention: the CUDA kernel's wrapper, its
plain version and a launch counter.

:func:`attention` takes the transformer's layout, q (B, S, H, D), k
(B, T, KV, D) and v (B, T, KV, Dv) with head h reading KV head
``h // (H // KV)``, queries at positions ``0 .. S-1`` and keys at
``0 .. T-1``; :func:`swa_attention` keeps the Pallas kernel's (H, S, D)
signature.  Both compute ``softmax(mask(q kᵀ / √D)) v`` with the mask
``k ≤ q`` (``causal``) and ``k > q − window`` (``window`` not None), f32
inside, the output (B, S, H, Dv) in the input dtype.  T ≠ S (cross-
attention over an encoder's states) needs ``causal=False``, as the JAX
package's cross-attention is never causal.  For CUDA tensors they launch one
of two kernels that replace the JAX package's Pallas ``swa_attention``, or
raise: bf16 goes to ``csrc/swa_attention_wgmma.cu`` (``wgmma``, TMA),
f32 to ``csrc/swa_attention.cu`` (``mma.sync``, every product as three
TF32 MMAs), both on the tensor cores in 128-query blocks.  For CPU
tensors they run :func:`chunked_attention`, the port of the JAX package's
``nn.attention._chunked_attention``.  ``launches`` counts the launches of
both kernels, ``wgmma_launches`` those of the bf16 one, and
``form_launches`` both by the form of the call (:func:`form`).

On CUDA both take (D, Dv) ∈ {(64, 64), (128, 128), (256, 256)} and MLA's
(192, 128) (``SUPPORTED_WIDTHS``), any S, T ≥ 1, and have no backward: they
refuse inputs that require grad.  The plain version takes any widths.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

Tensor = torch.Tensor

_NEG = -1e30
#: (D of q and k, Dv of v and o) that both kernels are compiled for
SUPPORTED_WIDTHS = ((64, 64), (128, 128), (256, 256), (192, 128))
#: the kernel library for each dtype, and the stride (in elements) its
#: loads need: TMA's 16 bytes for bf16, float4 loads for f32
KERNELS = {torch.bfloat16: ("swa_attention_wgmma", 8),
           torch.float32: ("swa_attention", 4)}

#: launches of either CUDA kernel since :func:`reset_launches`
launches = 0
#: launches of the bf16 tensor-core kernel since :func:`reset_launches`
wgmma_launches = 0
#: launches of either kernel by :func:`form` since :func:`reset_launches`
form_launches: dict[str, int] = {}


def reset_launches() -> None:
    global launches, wgmma_launches
    launches = wgmma_launches = 0
    form_launches.clear()


def form(d: int, dv: int, s: int, t: int, causal: bool) -> str:
    """A call's form: its widths and mask, e.g. ``"192x128-causal"`` (MLA),
    ``"64x64-noncausal"`` (an encoder), ``"128x128-cross"`` (T != S)."""
    mask = "causal" if causal else ("noncausal" if t == s else "cross")
    return f"{d}x{dv}-{mask}"


def _bind(lib: ctypes.CDLL, entry: str) -> None:
    build.common_bind(lib)
    fn = getattr(lib, entry)
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int


def chunked_attention(
    q: Tensor,  # (B, S, H, D)
    k: Tensor,  # (B, T, KV, D)
    v: Tensor,  # (B, T, KV, Dv)
    q_positions: Tensor,  # (S,)
    kv_positions: Tensor,  # (T,)
    *,
    causal: bool,
    window: Optional[int],
    q_chunk: int = 512,
) -> Tensor:
    """The kernel's function in plain PyTorch: query chunks of ``q_chunk``
    rows (one chunk if S is not a multiple), each against every key, the
    (chunk, T) scores in f32, masked by position.  Returns (B, S, H, Dv) in
    q's dtype."""
    b, s, h, d = q.shape
    t, kv_heads = k.shape[1], k.shape[2]
    g = h // kv_heads
    scale = 1.0 / (d ** 0.5)
    qc = min(q_chunk, s)
    if s % qc != 0:  # fall back to one chunk for ragged sizes
        qc = s
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    dv = v.shape[-1]
    outs = []
    for c0 in range(0, s, qc):
        qi = q[:, c0:c0 + qc].to(torch.float32).reshape(b, qc, kv_heads, g, d)
        qp = q_positions[c0:c0 + qc]
        logits = torch.einsum("bqkgd,btkd->bkgqt", qi, kf) * scale
        mask = torch.ones((qc, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_positions[None, :] <= qp[:, None]
        if window is not None:
            mask &= kv_positions[None, :] > qp[:, None] - window
        logits = torch.where(mask, logits, _NEG)
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgqt,btkd->bqkgd", p, vf)
        outs.append(out.to(q.dtype).reshape(b, qc, h, dv))
    return torch.cat(outs, dim=1)


def _check(q: Tensor, k: Tensor, v: Tensor, causal: bool,
           window: Optional[int]) -> None:
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in KERNELS:
        raise TypeError(f"attention takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"need q (B,S,H,D), k (B,T,KV,D) and v (B,T,KV,Dv); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} in batch or head width")
    if causal and k.shape[1] != s:
        raise ValueError(f"causal attention needs keys of the queries' "
                         f"length: T = {k.shape[1]}, S = {s}")
    if h % k.shape[2] != 0:
        raise ValueError(f"{h} query heads do not group over "
                         f"{k.shape[2]} KV heads")
    if s < 1 or k.shape[1] < 1:
        raise ValueError("attention needs S >= 1 and T >= 1")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def _require_contiguous(q: Tensor, k: Tensor, v: Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"the SWA attention kernel needs a contiguous "
                             f"{name}")


def route(q4: Tensor, k4: Tensor, v4: Tensor, out4: Tensor) -> str:
    """The kernel library that takes these q (B, S, H, D), k (B, T, KV, D),
    v (B, T, KV, Dv) and o (B, S, H, Dv) views: ``KERNELS[dtype]``, after
    checking what that kernel needs of the widths, the grid, strides and
    alignment; raises ``ValueError`` for what it does not take.  Launches
    nothing."""
    name, align = KERNELS[q4.dtype]
    b, s, h, d = q4.shape
    widths = (d, v4.shape[-1])
    if widths not in SUPPORTED_WIDTHS:
        raise ValueError(f"the SWA attention kernel takes D in (64, 128, "
                         f"256) with Dv = D, or (D, Dv) = (192, 128); got "
                         f"{widths}")
    # grid y of both kernels: 128-query blocks
    if -(-s // 128) > 65535:
        raise ValueError(f"S = {s}: too many query blocks for the "
                         f"{q4.dtype} kernel's grid")
    if out4.shape != (b, s, h, widths[1]):
        raise ValueError(f"o {tuple(out4.shape)} is not (B, S, H, Dv)")
    for t_name, t in (("q", q4), ("k", k4), ("v", v4), ("o", out4)):
        if (t.stride(-1) != 1 or any(st % align for st in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"the {q4.dtype} SWA attention kernel needs "
                             f"{t_name} with a contiguous last dim, strides "
                             f"in multiples of {align} elements and a "
                             f"16-byte aligned start")
    return name


def _launch(q4: Tensor, k4: Tensor, v4: Tensor, out4: Tensor, causal: bool,
            window: Optional[int]) -> None:
    """Launch the kernel :func:`route` picks on q (B, S, H, D), k
    (B, T, KV, D), v (B, T, KV, Dv) and o (B, S, H, Dv) views whose strides
    it reads, with the scale 1 / √D."""
    global launches, wgmma_launches
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q4, k4, v4)):
        raise RuntimeError("the SWA attention kernel has no backward: run "
                           "it under torch.no_grad()")
    name = route(q4, k4, v4, out4)
    entry = f"{name}_launch"
    lib = build.load(name, lambda lib: _bind(lib, entry))
    b, s, h, d = q4.shape
    err = getattr(lib, entry)(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out4.data_ptr(),
        b, s, k4.shape[1], h, k4.shape[2], d, v4.shape[3],
        *q4.stride()[:3], *k4.stride()[:3], *v4.stride()[:3],
        *out4.stride()[:3], int(causal),
        0 if window is None else int(window), 1.0 / (d ** 0.5),
        build.stream_ptr(q4.device))
    build.check(lib, err, name)
    launches += 1
    key = form(d, v4.shape[3], s, k4.shape[1], causal)
    form_launches[key] = form_launches.get(key, 0) + 1
    if name == "swa_attention_wgmma":
        wgmma_launches += 1


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              window: Optional[int] = None, q_chunk: int = 512) -> Tensor:
    """Attention of q (B, S, H, D) at positions 0 .. S-1 over k
    (B, T, KV, D) and v (B, T, KV, Dv) at positions 0 .. T-1 →
    (B, S, H, Dv) in q's dtype.  T ≠ S needs ``causal=False``.

    CUDA tensors launch the kernel of their dtype (contiguous inputs) or
    raise; CPU tensors run :func:`chunked_attention` with ``q_chunk``.
    """
    _check(q, k, v, causal, window)
    if q.device.type != "cuda":
        return chunked_attention(
            q, k, v, torch.arange(q.shape[1], device=q.device),
            torch.arange(k.shape[1], device=q.device), causal=causal,
            window=window, q_chunk=q_chunk)
    _require_contiguous(q, k, v)
    out = q.new_empty(q.shape[:3] + v.shape[3:])
    _launch(q, k, v, out, causal, window)
    return out


def swa_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  window: Optional[int] = None) -> Tensor:
    """q/k/v: (H, S, D) → (H, S, D), the Pallas kernel's signature (its
    oracle ``ref.swa_attention_ref`` takes (S, H, D)).

    CUDA tensors launch the same kernels as :func:`attention`, reading the
    (H, S, D) layout through strides (contiguous inputs), or raise; CPU
    tensors run :func:`chunked_attention`.
    """
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"need q, k, v of one shape (H, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    as4 = lambda t: t.permute(1, 0, 2).unsqueeze(0)  # (1, S, H, D) view
    q4, k4, v4 = as4(q), as4(k), as4(v)
    _check(q4, k4, v4, causal, window)
    if q.device.type != "cuda":
        pos = torch.arange(q.shape[1], device=q.device)
        out = chunked_attention(q4, k4, v4, pos, pos, causal=causal,
                                window=window)
        return out[0].permute(1, 0, 2).contiguous()
    _require_contiguous(q, k, v)
    out = torch.empty_like(q)
    _launch(q4, k4, v4, as4(out), causal, window)
    return out
