"""LayerNorm designs of the sweep: ``ln_mxu`` (CUDA C++, ``csrc/ln_mxu.cu``)
and ``ln_mxu_bf16`` (Triton), each beside a plain version of its exact math.

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

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
its plain version. There is no fallback from one to the other.

Bound on the H100: bytes, as ``layernorm`` (one read and one write of the
rows). Both designs put the row sums on the tensor cores, as a product with
ones:

* ``ln_mxu``, CUDA C++ (the source note of ``csrc/ln_mxu.cu`` gives the
  design): a block stages ``rows_per_program`` rows in shared memory, one
  read, and ``num_warps`` warps take its 16-row tiles, ``num_warps /
  (rows_per_program / 16)`` warps to a tile, each with its share of the
  16-column chunks. ``mma.sync`` against an all-ones B fragment sums each
  chunk. fp32 x and x·x enter as three exact bf16 parts, bf16 x² as two.
  Every warp then normalizes whole rows from shared memory.
* ``ln_mxu_bf16``, Triton: a program takes ``ROWS`` rows and walks them in
  chunks of 128 columns, accumulating Σx and Σx² with ``tl.dot`` against a
  ``[128, 16]`` matrix whose column 0 is ones and the rest zeros
  (``tl.dot``'s least N is 16); a second walk over the same rows, which the
  first left in L2, normalizes and stores. ``tl.dot`` needs at least 16
  rows, so ``ROWS`` is 16 or more. d need not be a multiple of 128: the
  padded columns load as zeros and add nothing.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check_launch, forward_only, import_triton, load_library
from .layernorm import check_cuda_rows, rows_view

tl = None  # triton.language, bound by _bf16_kernel() at first launch
_BF16_KERNEL = None
# (rows per program, warps): the fastest of the sweep's configurations on
# the H100 at [8000, 768] bf16 (scripts/bench_ln_kernel.py)
LN_MXU_CONFIG = (16, 8)
LN_MXU_BF16_CONFIG = (64, 8)
_CHUNK = 128  # columns per product: the sums' depth per tl.dot
_SUM_COLS = 16  # tl.dot's least N
LN_MXU_MAX_WARPS = 8  # csrc/ln_mxu.cu: kMaxWarps
LN_MXU_MAX_SMEM = 232448  # shared memory a block can use on the H100
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ln_mxu_smem_bytes(rows_per_program: int, num_warps: int, d: int, dtype) -> int:
    """Shared memory of one ``ln_mxu`` block (``smem_bytes`` of
    ``csrc/ln_mxu.cu``): the rows at ``sa::row_stride`` (d padded to 16,
    plus 16 bytes), a ``(Σx, Σx²)`` pair per warp and fragment row, and a
    ``(mean, rstd)`` pair per row."""
    esize = torch.empty(0, dtype=dtype).element_size()
    row_stride = -(-d // 16) * 16 + 16 // esize
    return rows_per_program * row_stride * esize + 8 * (16 * num_warps + rows_per_program)


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


def _bf16_kernel():
    global tl, _BF16_KERNEL
    if _BF16_KERNEL is None:
        triton, tl = import_triton()
        _BF16_KERNEL = triton.jit(_ln_mxu_bf16_kernel)
    return _BF16_KERNEL


def _launch_bf16(x, scale, bias, eps, rows_per_program, num_warps):
    x2, stride = rows_view(x)
    rows, d = x2.shape
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _bf16_kernel()[(-(-rows // rows_per_program),)](
        x2, scale, bias, y, rows, d, stride, eps,
        ROWS=rows_per_program, CHUNK=_CHUNK, COLS=_SUM_COLS, num_warps=num_warps,
    )
    ln_mxu_bf16.launches += 1
    return y


def _ln_mxu_kernel():
    fn = load_library("ln_mxu").vtc_ln_mxu
    if fn.argtypes is None:  # ctypes hands back the same object every time
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
    return fn


def _launch(x, scale, bias, eps, rows_per_program, num_warps):
    x2, stride = rows_view(x)
    rows, d = x2.shape
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    err = _ln_mxu_kernel()(
        x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), stride,
        rows, d, rows_per_program, num_warps, eps, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, "ln_mxu")
    ln_mxu.launches += 1
    return y


def _check_rows_per_program(rows_per_program: int) -> None:
    if rows_per_program < 16 or rows_per_program & (rows_per_program - 1):
        raise ValueError(
            f"rows_per_program must be a power of two >= 16 (a product's least "
            f"M), got {rows_per_program}"
        )


def _check_ln_mxu_config(rows_per_program: int, num_warps: int, d: int, dtype) -> None:
    _check_rows_per_program(rows_per_program)
    tiles = rows_per_program // 16
    if not 1 <= num_warps <= LN_MXU_MAX_WARPS or num_warps % tiles:
        raise ValueError(
            f"ln_mxu: num_warps must be a multiple of rows_per_program / 16 = "
            f"{tiles} and at most {LN_MXU_MAX_WARPS}, got {num_warps}"
        )
    smem = ln_mxu_smem_bytes(rows_per_program, num_warps, d, dtype)
    if smem > LN_MXU_MAX_SMEM:
        raise ValueError(
            f"ln_mxu: {rows_per_program} rows of d = {d} need {smem} bytes of "
            f"shared memory, more than the {LN_MXU_MAX_SMEM} a block has"
        )


def ln_mxu(x, scale, bias, eps: float = 1e-5,
           rows_per_program: int = LN_MXU_CONFIG[0],
           num_warps: int = LN_MXU_CONFIG[1]):
    """LayerNorm with its row sums as a product with ones (fp32 sums,
    ``E[x²] − E[x]²``), cast back to ``x.dtype``.

    ``rows_per_program`` rows (16, 32, 64 or 128) make one block of the CUDA
    kernel, staged whole in shared memory, and ``num_warps`` warps share
    them: a multiple of ``rows_per_program / 16`` (one warp or more per
    16-row tile), at most 8. A configuration outside that, or rows too wide
    for one block's shared memory (``ln_mxu_smem_bytes``), raises, on the
    CPU too. ``scale`` and ``bias`` enter the kernel in fp32."""
    _check_ln_mxu_config(rows_per_program, num_warps, x.shape[-1], x.dtype)
    if x.device.type == "cpu":
        return ln_mxu_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mxu runs on cpu or cuda, not {x.device}")
    check_cuda_rows("ln_mxu", x, scale, bias)
    return forward_only("ln_mxu", lambda x_, s_, b_: _launch(
        x_, s_, b_, eps, rows_per_program, num_warps), x, scale.float(), bias.float())


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
    return forward_only("ln_mxu_bf16", lambda x_, s_, b_: _launch_bf16(
        x_, s_, b_, eps, rows_per_program, num_warps), x, scale, bias)


ln_mxu.launches = 0
ln_mxu_bf16.launches = 0
