"""Attention for short sequences: ``fused_mha`` and ``fused_attention``.

``fused_mha`` ports ``vtc_tpu/ops/pallas_attention.py:fused_mha`` (``:288``):
heads-packed multi-head attention. q, k and v are ``[B, L, E]`` with the
heads packed in E, and may be the strided views that splitting the merged
qkv GEMM gives (row stride 3E): the kernel takes the strides, so no copy is
made. The output is a contiguous ``[B, L, E]`` in q's dtype.

``fused_attention`` ports ``fused_attention`` (``:131``): attention over
``[B·H, L, D]`` (the JAX layout) or over 4-D head views ``[B, H, L, D]``
with any (batch, head, row) strides, with an optional additive fp32
``[L, L]`` mask; the scores are scaled in fp32 (``_reference_attention``,
``:118``), not q in its own dtype as in ``fused_mha``.

On a CUDA tensor each launches its hand-written CUDA kernel
(``csrc/fused_mha.cu``, ``csrc/fused_attention.cu``, both built on the
tensor-core tile of ``csrc/short_attention.cuh``; the source notes give the
bound and the design); on a CPU tensor it runs its plain version, the math
of the JAX reference. There is no fallback from one to the other. L is
at most 128 in both, as in the TPU kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import check_launch, forward_only, load_library

MAX_LEN = 128
MAX_HEAD_DIM = 128  # csrc/short_attention.cuh: sa::kMaxL, sa::kMaxDh
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask (upper-triangular -inf), fp32, as
    ``vtc_tpu.models.layers.causal_mask``."""
    mask = torch.full((length, length), float("-inf"), device=device)
    return torch.triu(mask, diagonal=1)


def fused_mha_plain(q, k, v, heads: int, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Reference math: q scaled in its dtype, fp32 scores and softmax, P
    rounded to q's dtype, P@V accumulated in fp32, output in q's dtype."""
    b, l, e = q.shape
    d = e // heads
    s = scale if scale is not None else d**-0.5
    qh = (q * torch.tensor(s, dtype=q.dtype)).reshape(b, l, heads, d)
    kh = k.reshape(b, l, heads, d)
    vh = v.reshape(b, l, heads, d)
    scores = torch.einsum("blhd,bmhd->bhlm", qh.float(), kh.float())
    if causal:
        scores = scores + causal_mask(l, q.device)
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", attn.float(), vh.float())
    return out.reshape(b, l, e).to(q.dtype)


def _kernel():
    fn = load_library("fused_mha").vtc_fused_mha
    if fn.argtypes is None:  # ctypes hands back the same object every time
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
            + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
    return fn


def _launch(q, k, v, heads, causal, scale):
    b, l, e = q.shape
    o = torch.empty((b, l, e), dtype=q.dtype, device=q.device)
    err = _kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1),
        b, l, heads, e // heads, int(causal), scale, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(err, "fused_mha")
    fused_mha.launches += 1
    return o


def fused_mha(q, k, v, heads: int, causal: bool = False,
              scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention over ``[B, L, E]``, E = heads·Dh, L <= 128."""
    b, l, e = q.shape
    if l > MAX_LEN:
        raise ValueError(
            f"fused_mha supports L <= {MAX_LEN} (got L={l}), as the TPU "
            f"kernel it ports"
        )
    if e % heads:
        raise ValueError(f"E={e} is not a multiple of heads={heads}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape} {k.shape} {v.shape}")
    s = scale if scale is not None else (e // heads) ** -0.5
    if q.device.type == "cpu":
        return fused_mha_plain(q, k, v, heads, causal, s)
    if q.device.type != "cuda":
        raise ValueError(f"fused_mha runs on cpu or cuda, not {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"fused_mha takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q.dtype} {k.dtype} {v.dtype}"
        )
    if e // heads > MAX_HEAD_DIM:
        raise ValueError(f"head dim {e // heads} > {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.stride(2) != 1:
            raise ValueError(
                f"{name} must be on {q.device} with a contiguous last dim "
                f"(got {t.device}, strides {t.stride()})"
            )
    return forward_only("fused_mha", lambda q_, k_, v_: _launch(
        q_, k_, v_, heads, causal, s), q, k, v)


fused_mha.launches = 0


# ---- fused_attention --------------------------------------------------------

def fused_attention_plain(q, k, v, mask=None, scale: Optional[float] = None):
    """Reference math (``_reference_attention``): fp32 scores times the scale
    in fp32, plus the mask, fp32 softmax, P rounded to q's dtype, P@V
    accumulated in fp32, output in q's dtype. Any leading dims."""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    scores = torch.einsum("...id,...jd->...ij", q.float(), k.float()) * s
    if mask is not None:
        scores = scores + mask.float()
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("...ij,...jd->...id", attn.float(), v.float())
    return out.to(q.dtype)


def _attention_kernel():
    fn = load_library("fused_attention").vtc_fused_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 12
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
    return fn


def _attention_launch(q, k, v, mask, scale):
    """q, k, v: ``[B, H, L, D]`` views. The output is allocated as
    ``[B, L, H, D]`` and returned as its ``[B, H, L, D]`` view, so merging
    the heads back into ``[B, L, H·D]`` is free."""
    b, h, l, d = q.shape
    o = torch.empty((b, l, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = [n for t in (q, k, v, o) for n in t.stride()[:3]]
    err = _attention_kernel()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if mask is None else mask.data_ptr(), o.data_ptr(),
        *strides, b, h, l, d, scale, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(err, "fused_attention")
    fused_attention.launches += 1
    return o


def fused_attention(q, k, v, mask=None, scale: Optional[float] = None):
    """Attention over ``[B, L, D]`` (B = batch·heads, the JAX layout) or
    ``[B, H, L, D]`` views; L <= 128, D <= 128. ``mask``: additive ``[L, L]``,
    broadcast over the leading dims. A 3-D call returns a contiguous
    ``[B, L, D]``; a 4-D call on the card returns the ``[B, H, L, D]`` view
    of a ``[B, L, H, D]`` tensor."""
    if q.dim() not in (3, 4):
        raise ValueError(f"fused_attention takes [B, L, D] or [B, H, L, D], got {q.shape}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {q.shape} {k.shape} {v.shape}")
    l, d = q.shape[-2:]
    if l > MAX_LEN or d > MAX_HEAD_DIM:
        raise ValueError(
            f"fused_attention supports L <= {MAX_LEN} and D <= {MAX_HEAD_DIM} "
            f"(got L={l}, D={d})"
        )
    if mask is not None and tuple(mask.shape) != (l, l):
        raise ValueError(f"mask must be [L, L] = [{l}, {l}], got {tuple(mask.shape)}")
    s = scale if scale is not None else d**-0.5
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, mask, s)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cpu or cuda, not {q.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"fused_attention takes float32 or bfloat16 q, k, v of one dtype, "
            f"got {q.dtype} {k.dtype} {v.dtype}"
        )
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError(
                f"{name} must be on {q.device} with a contiguous last dim "
                f"(got {t.device}, strides {t.stride()})"
            )
    if mask is not None:
        mask = mask.to(device=q.device, dtype=torch.float32).contiguous()
    squeeze = q.dim() == 3
    if squeeze:
        q, k, v = q[:, None], k[:, None], v[:, None]
    o = forward_only("fused_attention", lambda q_, k_, v_: _attention_launch(
        q_, k_, v_, mask, s), q, k, v)
    return o[:, 0] if squeeze else o


fused_attention.launches = 0
