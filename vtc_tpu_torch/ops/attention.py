"""Heads-packed multi-head attention for short sequences (``fused_mha``).

Port of ``vtc_tpu/ops/pallas_attention.py:fused_mha`` (``:288``). On a CUDA
tensor ``fused_mha`` launches the hand-written CUDA kernel of
``csrc/fused_mha.cu`` (its source note gives the bound and the design); on a
CPU tensor it runs ``fused_mha_plain``, the math of ``_mha_reference``
(``:268``). There is no fallback from one to the other.

q, k and v are ``[B, L, E]`` with the heads packed in E, and may be the
strided views that splitting the merged qkv GEMM gives (row stride 3E): the
kernel takes the strides, so no copy is made. The output is a contiguous
``[B, L, E]`` in q's dtype. L is at most 128, as in the TPU kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ._build import check_launch, forward_only, load_library

MAX_LEN = 128
MAX_HEAD_DIM = 128  # csrc/fused_mha.cu: kMaxL, kMaxDh
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
