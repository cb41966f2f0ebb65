"""LayerNorm designs of the sweep (``ln_mxu``, ``ln_mxu_bf16``), Triton
kernels, each beside a plain version of its exact math.

Port of the designs of ``scripts/bench_ln_kernel.py`` (``make_pallas``,
``:88``), whose twin is ``vtc_tpu_torch/scripts/bench_ln_kernel.py``:

* ``vpu_kernel`` (``:27``) is the math of ``_ln_kernel``, so the sweep times
  ``ops.layernorm`` under that name; it has no kernel here.
* ``ln_mxu`` (``mxu_kernel``, ``:39``): fp32 row sums Σx and Σx² as a
  product with a ones matrix, ``var = E[x²] − E[x]²``, fp32 affine, output in
  x's dtype.
* ``ln_mxu_bf16`` (``mxu_bf16_kernel``, ``:61``): bf16 x straight into the
  product with fp32 accumulation, x² rounded to bf16 before its sum, per-row
  mean and rstd in fp32 then rounded to bf16, and the centering, scaling and
  affine in bf16 (scale and bias rounded to bf16), each step rounded as the
  JAX body's bf16 operations are.

On a CUDA tensor each wrapper launches its Triton kernel; on a CPU tensor it
runs its plain version. There is no fallback from one to the other.

Bound on the H100: bytes, as ``layernorm`` (one read and one write of the
rows). The design under test is "the row sum on the matrix unit": a program
takes ``ROWS`` rows and walks them in chunks of 128 columns, accumulating
Σx and Σx² with ``tl.dot`` against a ``[128, 16]`` matrix whose column 0 is
ones and the rest zeros (``tl.dot``'s least N is 16), so the product's
column 0 is the row sum and the other columns stay exact zeros; a second
walk over the same rows, which the first left in L2, normalizes and stores.
A first form that held each row whole in registers and reduced it in one
product (d = 768 padded to 1024) was many times slower on the H100, and at
64 rows its product needed more shared memory than a block has. ``tl.dot`` needs at least 16 rows, so ``ROWS`` is 16 or more. The
fp32 product is asked for with ``input_precision="ieee"`` (Triton's default
is TF32, which would round x to 10 bits): Hopper's tensor cores have no fp32
mode, so that product runs on the FMA units; the bf16 product runs on the
tensor cores. d need not be a multiple of 128: the padded columns load as
zeros and add nothing.
"""

from __future__ import annotations

import torch

from ._build import forward_only, import_triton
from .layernorm import check_cuda_rows, rows_view

tl = None  # triton.language, bound by _kernel() at first launch
_KERNELS = {}
# (rows per program, warps): the fastest of the sweep's configurations on
# the H100 at [8000, 768] bf16 (scripts/bench_ln_kernel.py)
LN_MXU_CONFIG = (16, 4)
LN_MXU_BF16_CONFIG = (64, 8)
_CHUNK = 128  # columns per product: the sums' depth per tl.dot
_SUM_COLS = 16  # tl.dot's least N


def ln_mxu_plain(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    d = x.shape[-1]
    ones = torch.ones(d, 1, device=x.device)
    mean = (x32 @ ones) / d
    var = ((x32 * x32) @ ones) / d - mean * mean
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def ln_mxu_bf16_plain(x, scale, bias, eps: float = 1e-5):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"ln_mxu_bf16 takes bfloat16, got {x.dtype}")
    d = x.shape[-1]
    ones = torch.ones(d, 1, device=x.device)
    mean = (x.float() @ ones) / d  # a bf16 value is exact in fp32
    var = ((x * x).float() @ ones) / d - mean * mean
    rstd = torch.rsqrt(var + eps)
    y = (x - mean.to(torch.bfloat16)) * rstd.to(torch.bfloat16)
    return y * scale.to(torch.bfloat16) + bias.to(torch.bfloat16)


def _ln_mxu_kernel(x_ptr, w_ptr, b_ptr, y_ptr, rows, d, stride_x, eps,
                   ROWS: tl.constexpr, CHUNK: tl.constexpr, COLS: tl.constexpr):
    f32 = tl.float32
    r = tl.program_id(0) * ROWS + tl.arange(0, ROWS)[:, None]
    k = tl.arange(0, CHUNK)[None, :]
    col0 = (tl.arange(0, COLS) == 0).to(f32)
    ones = tl.zeros((CHUNK, COLS), f32) + col0[None, :]
    acc = tl.zeros((ROWS, COLS), f32)
    acc2 = tl.zeros((ROWS, COLS), f32)
    for k0 in range(0, d, CHUNK):
        c = k0 + k
        x = tl.load(x_ptr + r * stride_x + c, mask=(r < rows) & (c < d),
                    other=0.0).to(f32)
        acc = tl.dot(x, ones, acc, input_precision="ieee")
        acc2 = tl.dot(x * x, ones, acc2, input_precision="ieee")
    mean = tl.sum(acc, axis=1)[:, None] / d
    rstd = 1.0 / tl.sqrt(tl.sum(acc2, axis=1)[:, None] / d - mean * mean + eps)
    for k0 in range(0, d, CHUNK):
        c = k0 + k
        m = (r < rows) & (c < d)
        x = tl.load(x_ptr + r * stride_x + c, mask=m, other=0.0).to(f32)
        w = tl.load(w_ptr + c, mask=c < d, other=0.0).to(f32)
        b = tl.load(b_ptr + c, mask=c < d, other=0.0).to(f32)
        y = (x - mean) * rstd * w + b
        tl.store(y_ptr + r * d + c, y.to(y_ptr.dtype.element_ty), mask=m)


def _ln_mxu_bf16_kernel(x_ptr, w_ptr, b_ptr, y_ptr, rows, d, stride_x, eps,
                        ROWS: tl.constexpr, CHUNK: tl.constexpr,
                        COLS: tl.constexpr):
    bf16 = tl.bfloat16
    f32 = tl.float32
    r = tl.program_id(0) * ROWS + tl.arange(0, ROWS)[:, None]
    k = tl.arange(0, CHUNK)[None, :]
    col0 = (tl.arange(0, COLS) == 0).to(bf16)
    ones = tl.zeros((CHUNK, COLS), bf16) + col0[None, :]
    acc = tl.zeros((ROWS, COLS), f32)
    acc2 = tl.zeros((ROWS, COLS), f32)
    for k0 in range(0, d, CHUNK):
        c = k0 + k
        x = tl.load(x_ptr + r * stride_x + c, mask=(r < rows) & (c < d), other=0.0)
        x32 = x.to(f32)
        acc = tl.dot(x, ones, acc)
        acc2 = tl.dot((x32 * x32).to(bf16), ones, acc2)  # x² rounded to bf16
    mean = tl.sum(acc, axis=1)[:, None] / d
    rstd = 1.0 / tl.sqrt(tl.sum(acc2, axis=1)[:, None] / d - mean * mean + eps)
    # every bf16 operation of the JAX body: computed in fp32, rounded
    mean_b = mean.to(bf16).to(f32)
    rstd_b = rstd.to(bf16).to(f32)
    for k0 in range(0, d, CHUNK):
        c = k0 + k
        m = (r < rows) & (c < d)
        x32 = tl.load(x_ptr + r * stride_x + c, mask=m, other=0.0).to(f32)
        w = tl.load(w_ptr + c, mask=c < d, other=0.0).to(bf16).to(f32)
        b = tl.load(b_ptr + c, mask=c < d, other=0.0).to(bf16).to(f32)
        xc = (x32 - mean_b).to(bf16).to(f32)
        y = (xc * rstd_b).to(bf16).to(f32)
        y = (y * w).to(bf16).to(f32)
        tl.store(y_ptr + r * d + c, (y + b).to(bf16), mask=m)


def _kernel(name):
    global tl
    if name not in _KERNELS:
        triton, tl = import_triton()
        body = {"ln_mxu": _ln_mxu_kernel, "ln_mxu_bf16": _ln_mxu_bf16_kernel}[name]
        _KERNELS[name] = triton.jit(body)
    return _KERNELS[name]


def _launch(wrapper, x, scale, bias, eps, rows_per_program, num_warps):
    x2, stride = rows_view(x)
    rows, d = x2.shape
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _kernel(wrapper.__name__)[(-(-rows // rows_per_program),)](
        x2, scale, bias, y, rows, d, stride, eps,
        ROWS=rows_per_program, CHUNK=_CHUNK, COLS=_SUM_COLS, num_warps=num_warps,
    )
    wrapper.launches += 1
    return y


def _check_rows_per_program(rows_per_program: int) -> None:
    if rows_per_program < 16 or rows_per_program & (rows_per_program - 1):
        raise ValueError(
            f"rows_per_program must be a power of two >= 16 (tl.dot's least "
            f"M), got {rows_per_program}"
        )


def ln_mxu(x, scale, bias, eps: float = 1e-5,
           rows_per_program: int = LN_MXU_CONFIG[0],
           num_warps: int = LN_MXU_CONFIG[1]):
    """LayerNorm with its row sums as a product with ones (fp32 sums,
    ``E[x²] − E[x]²``), cast back to ``x.dtype``."""
    _check_rows_per_program(rows_per_program)
    if x.device.type == "cpu":
        return ln_mxu_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mxu runs on cpu or cuda, not {x.device}")
    check_cuda_rows("ln_mxu", x, scale, bias)
    return forward_only("ln_mxu", lambda x_, s_, b_: _launch(
        ln_mxu, x_, s_, b_, eps, rows_per_program, num_warps), x, scale, bias)


def ln_mxu_bf16(x, scale, bias, eps: float = 1e-5,
                rows_per_program: int = LN_MXU_BF16_CONFIG[0],
                num_warps: int = LN_MXU_BF16_CONFIG[1]):
    """The bf16 design: bf16 product sums with fp32 accumulation, bf16
    normalization with per-row fp32 coefficients. bf16 in, bf16 out."""
    _check_rows_per_program(rows_per_program)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"ln_mxu_bf16 takes bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return ln_mxu_bf16_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mxu_bf16 runs on cpu or cuda, not {x.device}")
    check_cuda_rows("ln_mxu_bf16", x, scale, bias)
    return forward_only("ln_mxu_bf16", lambda x_, s_, b_: _launch(
        ln_mxu_bf16, x_, s_, b_, eps, rows_per_program, num_warps), x, scale, bias)


ln_mxu.launches = 0
ln_mxu_bf16.launches = 0
