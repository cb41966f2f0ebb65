"""Row LayerNorm with fp32 statistics (``layernorm``), a Triton kernel.

Port of ``vtc_tpu/ops/pallas_layernorm.py:layernorm`` (``:66``, kernel
``_ln_kernel`` ``:31``). On a CUDA tensor ``layernorm`` launches the Triton
kernel below; on a CPU tensor it runs ``layernorm_plain``, the math of
``_xla_layernorm`` (``:43``). There is no fallback from one to the other.

Bound on the H100: bytes. Each row of 512 or 768 elements is read once and
written once, with one reduction and an affine between; tensor cores play no
part. Design: one program normalizes a block of rows held whole in
registers (``BLOCK = next_pow2(d)``, masked tail), with the mean and the
centered variance in fp32 from that one read, so device memory sees one read
and one write per element. The TPU's ``d % 128`` and ``rows % block``
constraints do not apply: any d, any number of rows.

Backward: ``LayerNormFn.backward``, PyTorch ops on the saved ``(x, scale,
bias)``: the math of ``jax.vjp`` of ``_xla_layernorm``, which is the JAX
kernel's own backward (``_bwd``, ``:111-117``). Mean and rstd are recomputed
in fp32; ``dx`` is cast to ``x.dtype``, ``dscale``/``dbias`` summed over the
rows in fp32. It is its own function, not autograd of ``layernorm_plain``, so
no plain forward runs on the card's training path.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ._build import acc_dtype, import_triton, needs_grad

tl = None  # triton.language, bound by _kernel() at first launch
_KERNEL = None
_ELEMS_PER_PROGRAM = 4096


def layernorm_plain(x, scale, bias, eps: float = 1e-5):
    x32 = x.to(acc_dtype(x.dtype))
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def layernorm_backward(x, scale, g, eps: float = 1e-5):
    """``(dx32, dscale, dbias)`` of ``y = LN(x)·scale + bias`` for the
    cotangent ``g`` of y; ``dx32`` stays in the compute type (add+LN adds
    the cotangent of its sum to it before casting)."""
    acc = acc_dtype(x.dtype)
    x32, g32 = x.to(acc), g.to(acc)
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    d = x.shape[-1]
    dscale = (g32 * xhat).reshape(-1, d).sum(dim=0)
    dbias = g32.reshape(-1, d).sum(dim=0)
    dxhat = g32 * scale.to(acc)
    dx32 = rstd * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                   - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx32, dscale.to(scale.dtype), dbias.to(scale.dtype)


class LayerNormFn(torch.autograd.Function):
    """The kernel's forward (``launch``: the Triton kernel on the card,
    ``layernorm_plain`` on the CPU) and the backward above."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, launch):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return launch(x, scale, bias)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with record_function("layernorm.backward"):
            dx32, dscale, dbias = layernorm_backward(x, scale, g, ctx.eps)
            return dx32.to(x.dtype), dscale, dbias, None, None


def _ln_kernel(x_ptr, w_ptr, b_ptr, y_ptr, rows, d, stride_x, eps,
               BLOCK: tl.constexpr, ROWS: tl.constexpr):
    r = tl.program_id(0) * ROWS + tl.arange(0, ROWS)[:, None]
    c = tl.arange(0, BLOCK)[None, :]
    m = (r < rows) & (c < d)
    x = tl.load(x_ptr + r * stride_x + c, mask=m, other=0.0).to(tl.float32)
    mean = tl.sum(x, axis=1) / d
    xc = tl.where(m, x - mean[:, None], 0.0)
    var = tl.sum(xc * xc, axis=1) / d
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + c, mask=c < d, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + c, mask=c < d, other=0.0).to(tl.float32)
    y = xc * rstd[:, None] * w + b
    tl.store(y_ptr + r * d + c, y.to(y_ptr.dtype.element_ty), mask=m)


def _kernel():
    global tl, _KERNEL
    if _KERNEL is None:
        triton, tl = import_triton()
        _KERNEL = triton.jit(_ln_kernel)
    return _KERNEL


def row_blocks(d: int):
    """(BLOCK, ROWS): the row padded to a power of two, and as many rows per
    program as make about 4096 elements."""
    block = 1 << max(0, (d - 1).bit_length())
    return block, max(1, _ELEMS_PER_PROGRAM // block)


def rows_view(x: torch.Tensor):
    """``x`` as ``[rows, d]`` rows with a unit column stride, and the row
    stride, without copying; raises when no such view exists."""
    d = x.shape[-1]
    if x.dim() == 2 and x.stride(1) == 1:
        return x, x.stride(0)
    if x.is_contiguous():
        return x.view(-1, d), d
    raise ValueError(
        f"need rows with a contiguous last dim, got shape {tuple(x.shape)} "
        f"strides {x.stride()}"
    )


def check_cuda_rows(name, x, scale, bias):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    d = x.shape[-1]
    for p in (scale, bias):
        if p.device != x.device or p.shape != (d,) or not p.is_contiguous():
            raise ValueError(
                f"{name}: scale and bias must be contiguous [{d}] on {x.device}"
            )


def _launch(x, scale, bias, eps):
    x2, stride = rows_view(x)
    rows, d = x2.shape
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    block, per = row_blocks(d)
    _kernel()[((rows + per - 1) // per,)](
        x2, scale, bias, y, rows, d, stride, eps, BLOCK=block, ROWS=per,
        num_warps=4,
    )
    layernorm.launches += 1
    return y


def layernorm(x, scale, bias, eps: float = 1e-5):
    """LayerNorm over the last axis with fp32 statistics and affine, cast
    back to ``x.dtype``. ``scale``/``bias``: ``[d]``, fp32 in the model."""
    if x.device.type == "cpu":
        def launch(x_, s_, b_):
            return layernorm_plain(x_, s_, b_, eps)
    elif x.device.type == "cuda":
        check_cuda_rows("layernorm", x, scale, bias)

        def launch(x_, s_, b_):
            return _launch(x_, s_, b_, eps)
    else:
        raise ValueError(f"layernorm runs on cpu or cuda, not {x.device}")
    if needs_grad(x, scale, bias):
        return LayerNormFn.apply(x, scale, bias, eps, launch)
    return launch(x, scale, bias)


layernorm.launches = 0
