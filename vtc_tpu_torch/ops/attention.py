"""Attention kernels: ``fused_mha`` and ``fused_attention``.

``fused_mha`` ports ``vtc_tpu/ops/pallas_attention.py:fused_mha`` (``:288``):
heads-packed multi-head attention. q, k and v are ``[B, L, E]`` with the
heads packed in E, and may be the strided views that splitting the merged
qkv GEMM gives (row stride 3E): the kernel takes the strides, so no copy is
made. The output is a contiguous ``[B, L, E]`` in q's dtype. It takes any
L: up to 128 on the short tile, the Pallas kernel's range, and past it on
the long route (``fused_mha_long``: ``csrc/long_attention.cuh``; bf16 up to
L = 272 in one pass over the keys, fp32 and longer rows in two; the
launch's choices are ``long_plan``), where the JAX package runs XLA attention
(``vtc_tpu/models/layers.py:269-290``: the ViT-B/16 and ViT-L/14 towers, L
= 197 and 257) with the same math in fp32. Fewer queries than keys (Lq <
Lk, no mask: the joint TimeSformer's CLS row, ``vtc_tpu/models/
timesformer_joint.py:97``) run on the long route's two-pass kernel at any
lengths (``fused_mha_long``); the plain version and the backward take Lq
≠ Lk with the same math.

``fused_attention`` ports ``fused_attention`` (``:131``): attention over
``[B·H, L, D]`` (the JAX layout) or over 4-D head views ``[B, H, L, D]``
with any (batch, head, row) strides, with an optional additive fp32
``[L, L]`` mask; the scores are scaled in fp32 (``_reference_attention``,
``:118``), not q in its own dtype as in ``fused_mha``.

On a CUDA tensor each launches its hand-written CUDA kernel
(``csrc/fused_mha.cu``, ``csrc/fused_attention.cu``, both built on the
tensor-core tile of ``csrc/short_attention.cuh``; the source notes give the
bound and the design); on a CPU tensor it runs its plain version, the math
of the JAX reference. There is no fallback from one to the other, nor
from one route of ``fused_mha`` to the other. ``fused_attention``'s L is
at most 128, as in the TPU kernel.

Backward: ``mha_backward`` and ``attention_backward``, PyTorch ops on the
saved ``(q, k, v[, mask])``, the math of ``jax.vjp`` of the JAX reference
that each kernel's ``custom_vjp`` differentiates (``_mha_bwd``, ``:307-317``;
``_bwd``, ``:148-159``). P is recomputed in fp32 and rounded to q's dtype
where the forward rounds it, so ``dV`` sees the rounded P and ``dP`` is
rounded to q's dtype on its way back, as the vjp of that cast; then
``dS = P ⊙ (dP − rowsum(dP ⊙ P))`` and ``dQ``/``dK`` with the scale. The
mask gets no gradient. The gradients take the inputs' shapes whatever their
strides (the q/k/v column views of one qkv GEMM output).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from ._build import acc_dtype, check_launch, load_library, needs_grad

MAX_LEN = 128
MAX_HEAD_DIM = 128  # csrc/short_attention.cuh: sa::kMaxL, sa::kMaxDh
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class LongPlan(NamedTuple):
    """How ``vtc_fused_mha_long`` launches at one (L, Dh, dtype)."""

    one_pass: int  # 1: the one-pass kernel, 0: the two-pass kernel
    key_tiles: int  # one pass: the key tiles of 8 of S each warp holds, else 0
    threads: int  # a block
    smem: int  # dynamic shared memory a block, bytes


def long_plan(length: int, head_dim: int, dtype: torch.dtype) -> LongPlan:
    """The long route's launch at ``(length, head_dim, dtype)``, as the C
    entry ``vtc_fused_mha_long_plan`` reports it (``long_plan`` in
    ``csrc/fused_mha.cu``, which the launch follows): bf16 up to L = 272 on
    the one-pass kernel, one block per (sequence, head); longer bf16 rows
    and fp32 on the two-pass kernel. Builds the library, so it needs
    ``nvcc``, though it launches nothing."""
    fn = load_library("fused_mha").vtc_fused_mha_long_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 4)()
    check_launch(fn(length, head_dim, _DTYPES[dtype], out), "vtc_fused_mha_long_plan")
    return LongPlan(*out)


def causal_mask(length: int, device=None) -> torch.Tensor:
    """Additive causal mask (upper-triangular -inf), fp32, as
    ``vtc_tpu.models.layers.causal_mask``."""
    mask = torch.full((length, length), float("-inf"), device=device)
    return torch.triu(mask, diagonal=1)


def fused_mha_plain(q, k, v, heads: int, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Reference math: q scaled in its dtype, fp32 scores and softmax, P
    rounded to q's dtype, P@V accumulated in fp32, output in q's dtype.
    q is ``[B, Lq, E]``, k and v ``[B, Lk, E]``; ``causal`` at Lq = Lk."""
    b, l, e = q.shape
    lk = k.shape[1]
    d = e // heads
    s = scale if scale is not None else d**-0.5
    acc = acc_dtype(q.dtype)
    qh = (q * torch.tensor(s, dtype=q.dtype)).reshape(b, l, heads, d)
    kh = k.reshape(b, lk, heads, d)
    vh = v.reshape(b, lk, heads, d)
    scores = torch.einsum("blhd,bmhd->bhlm", qh.to(acc), kh.to(acc))
    if causal:
        scores = scores + causal_mask(l, q.device).to(acc)
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhlm,bmhd->blhd", attn.to(acc), vh.to(acc))
    return out.reshape(b, l, e).to(q.dtype)


def _softmax_backward(p, dp_rounded):
    """dS from the fp32 P and the cotangent of P after its rounding."""
    return p * (dp_rounded - (dp_rounded * p).sum(dim=-1, keepdim=True))


def mha_backward(q, k, v, g, heads: int, causal: bool, scale: float):
    """``(dq, dk, dv)`` of ``fused_mha_plain`` for the output cotangent
    ``g``, each in its input's dtype and shape (Lq and Lk may differ)."""
    b, l, e = q.shape
    lk = k.shape[1]
    d = e // heads
    acc = acc_dtype(q.dtype)
    s = torch.tensor(scale, dtype=q.dtype)
    qh = (q * s).reshape(b, l, heads, d).to(acc)
    kh = k.reshape(b, lk, heads, d).to(acc)
    vh = v.reshape(b, lk, heads, d).to(acc)
    g32 = g.reshape(b, l, heads, d).to(acc)
    scores = torch.einsum("blhd,bmhd->bhlm", qh, kh)
    if causal:
        scores = scores + causal_mask(l, q.device).to(acc)
    p = torch.softmax(scores, dim=-1)
    dv = torch.einsum("bhlm,blhd->bmhd", p.to(q.dtype).to(acc), g32)
    dp = torch.einsum("blhd,bmhd->bhlm", g32, vh).to(q.dtype).to(acc)
    ds = _softmax_backward(p, dp)
    dqh = torch.einsum("bhlm,bmhd->blhd", ds, kh).to(q.dtype)
    dk = torch.einsum("bhlm,blhd->bmhd", ds, qh)
    return ((dqh * s).reshape(b, l, e), dk.reshape(b, lk, e).to(k.dtype),
            dv.reshape(b, lk, e).to(v.dtype))


class FusedMhaFn(torch.autograd.Function):
    """The kernel's forward (``launch``: ``csrc/fused_mha.cu`` on the card,
    ``fused_mha_plain`` on the CPU) and ``mha_backward``, which takes any
    L."""

    @staticmethod
    def forward(ctx, q, k, v, heads, causal, scale, launch):
        ctx.args = (heads, causal, scale)
        ctx.save_for_backward(q, k, v)
        return launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with record_function("fused_mha.backward"):
            return (*mha_backward(q, k, v, g, *ctx.args), None, None, None, None)


def _kernel(entry: str):
    """``vtc_fused_mha`` (the short tile; its lengths: L) or
    ``vtc_fused_mha_long`` (the long route; its lengths: Lq, Lk)."""
    fn = getattr(load_library("fused_mha"), entry)
    if fn.argtypes is None:  # ctypes hands back the same object every time
        lengths = 1 if entry == "vtc_fused_mha" else 2
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
            + [ctypes.c_int] * (4 + lengths) + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
    return fn


def _run(entry: str, q, k, v, heads, causal, scale):
    b, l, e = q.shape
    lengths = (l,) if entry == "vtc_fused_mha" else (l, k.shape[1])
    o = torch.empty((b, l, e), dtype=q.dtype, device=q.device)
    err = _kernel(entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1),
        b, *lengths, heads, e // heads, int(causal), scale, _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check_launch(err, entry)
    return o


def _launch(q, k, v, heads, causal, scale):
    o = _run("vtc_fused_mha", q, k, v, heads, causal, scale)
    fused_mha.launches += 1
    return o


def fused_mha_long(q, k, v, heads: int, causal: bool, scale: float) -> torch.Tensor:
    """The long route's launch (``fused_mha`` checks q, k and v and sends L
    > 128 here, and q with fewer rows than k and v): ``csrc/
    long_attention.cuh`` through the C entry ``vtc_fused_mha_long``, which
    takes any Lq <= Lk. Counted apart from the short tile in
    ``fused_mha_long.launches``. Refuses a host tensor, whose pointer the
    kernel would read as the card's."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_mha_long launches on cuda tensors, not {q.device}")
    o = _run("vtc_fused_mha_long", q, k, v, heads, causal, scale)
    fused_mha_long.launches += 1
    return o


fused_mha_long.launches = 0


def _check_cuda_qkv(name, q, k, v):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"{name} takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q.dtype} {k.dtype} {v.dtype}"
        )
    for arg, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.stride(-1) != 1:
            raise ValueError(
                f"{arg} must be on {q.device} with a contiguous last dim "
                f"(got {t.device}, strides {t.stride()})"
            )


def fused_mha(q, k, v, heads: int, causal: bool = False,
              scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention over ``[B, L, E]``, E = heads·Dh: on the card
    the short tile for L <= 128, the long route above, Dh <= 128 in both.
    q may have fewer rows than k and v (``[B, Lq, E]`` against ``[B, Lk,
    E]``, Lq < Lk, no mask), which the long route's two-pass kernel takes
    at any length (``fused_mha_long``)."""
    b, l, e = q.shape
    if e % heads:
        raise ValueError(f"E={e} is not a multiple of heads={heads}")
    cross = k.shape[1] > l and k.shape[::2] == q.shape[::2]
    if v.shape != k.shape or (k.shape != q.shape and not cross):
        raise ValueError(f"q, k, v shapes differ: {q.shape} {k.shape} {v.shape}")
    if cross and causal:
        raise ValueError(f"the causal mask takes Lq = Lk, got {l} and {k.shape[1]}")
    s = scale if scale is not None else (e // heads) ** -0.5
    if q.device.type == "cpu":
        def launch(q_, k_, v_):
            return fused_mha_plain(q_, k_, v_, heads, causal, s)
    elif q.device.type == "cuda":
        _check_cuda_qkv("fused_mha", q, k, v)
        if e // heads > MAX_HEAD_DIM:
            raise ValueError(f"head dim {e // heads} > {MAX_HEAD_DIM}")

        route = fused_mha_long if cross or l > MAX_LEN else _launch

        def launch(q_, k_, v_):
            return route(q_, k_, v_, heads, causal, s)
    else:
        raise ValueError(f"fused_mha runs on cpu or cuda, not {q.device}")
    if needs_grad(q, k, v):
        return FusedMhaFn.apply(q, k, v, heads, causal, s, launch)
    return launch(q, k, v)


fused_mha.launches = 0


# ---- fused_attention --------------------------------------------------------

def fused_attention_plain(q, k, v, mask=None, scale: Optional[float] = None):
    """Reference math (``_reference_attention``): fp32 scores times the scale
    in fp32, plus the mask, fp32 softmax, P rounded to q's dtype, P@V
    accumulated in fp32, output in q's dtype. Any leading dims."""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    acc = acc_dtype(q.dtype)
    scores = torch.einsum("...id,...jd->...ij", q.to(acc), k.to(acc)) * s
    if mask is not None:
        scores = scores + mask.to(acc)
    attn = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("...ij,...jd->...id", attn.to(acc), v.to(acc))
    return out.to(q.dtype)


def attention_backward(q, k, v, mask, g, scale: float):
    """``(dq, dk, dv)`` of ``fused_attention_plain`` for the output
    cotangent ``g``, each in its input's dtype and shape."""
    acc = acc_dtype(q.dtype)
    q32, k32, v32, g32 = q.to(acc), k.to(acc), v.to(acc), g.to(acc)
    scores = torch.einsum("...id,...jd->...ij", q32, k32) * scale
    if mask is not None:
        scores = scores + mask.to(acc)
    p = torch.softmax(scores, dim=-1)
    dv = torch.einsum("...ij,...id->...jd", p.to(q.dtype).to(acc), g32)
    dp = torch.einsum("...id,...jd->...ij", g32, v32).to(q.dtype).to(acc)
    ds = _softmax_backward(p, dp) * scale
    dq = torch.einsum("...ij,...jd->...id", ds, k32)
    dk = torch.einsum("...ij,...id->...jd", ds, q32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FusedAttentionFn(torch.autograd.Function):
    """The kernel's forward (``launch``: ``csrc/fused_attention.cu`` on the
    card, ``fused_attention_plain`` on the CPU) and ``attention_backward``;
    the mask is saved, not differentiated."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, launch):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, mask)
        return launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask = ctx.saved_tensors
        with record_function("fused_attention.backward"):
            return (*attention_backward(q, k, v, mask, g, ctx.scale), None, None, None)


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
        def launch(q_, k_, v_):
            return fused_attention_plain(q_, k_, v_, mask, s)
    elif q.device.type == "cuda":
        _check_cuda_qkv("fused_attention", q, k, v)
        if mask is not None:
            mask = mask.to(device=q.device, dtype=torch.float32).contiguous()

        def launch(q_, k_, v_):
            if q_.dim() == 3:
                return _attention_launch(q_[:, None], k_[:, None], v_[:, None],
                                         mask, s)[:, 0]
            return _attention_launch(q_, k_, v_, mask, s)
    else:
        raise ValueError(f"fused_attention runs on cpu or cuda, not {q.device}")
    if needs_grad(q, k, v):
        return FusedAttentionFn.apply(q, k, v, mask, s, launch)
    return launch(q, k, v)


fused_attention.launches = 0
