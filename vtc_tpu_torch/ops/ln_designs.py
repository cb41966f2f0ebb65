"""LayerNorm designs of the sweep, ``ln_mxu`` and ``ln_mxu_bf16``, CUDA C++
kernels (``csrc/ln_mxu.cu``), each beside a plain version of its exact math.

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
rows). Both designs stage each row tile once in shared memory and put the
row sums on the tensor cores, ``mma.sync`` against an all-ones B fragment
(the source notes of ``csrc/ln_mxu.cu`` give the designs):

* ``ln_mxu``: a block stages ``rows_per_program`` rows, and ``num_warps``
  warps take its 16-row tiles, ``num_warps / (rows_per_program / 16)`` warps
  to a tile, each with its share of the 16-column chunks. fp32 x and x·x
  enter as three exact bf16 parts, bf16 x² as two. Every warp then
  normalizes whole rows from shared memory. One block per row tile.
* ``ln_mxu_bf16``: the same tiles and warps, with x and bf16(x²) one part
  each, and the body's bf16 steps as bf16 pair instructions. Its blocks are
  persistent: ``ln_mxu_bf16_grid`` launches a few per SM, and each walks
  tiles a grid apart over two shared-memory stages, the next tile's copy in
  flight while this one is summed, normalized and stored.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import check_launch, forward_only, load_library
from .layernorm import check_cuda_rows, rows_view

# (rows per program, warps): the fastest of the sweep's configurations on
# the H100 at [8000, 768] bf16 (scripts/bench_ln_kernel.py; the runs are
# in PERF.md, rows 5a and 5b)
LN_MXU_CONFIG = (16, 8)
LN_MXU_BF16_CONFIG = (16, 8)
LN_MXU_MAX_WARPS = 8  # csrc/ln_mxu.cu: kMaxWarps
LN_MXU_MAX_SMEM = 232448  # shared memory a block can use on the H100
# the H100's SM: shared memory (1 KB of it reserved for each block), threads
# and blocks it holds
SM_SMEM, BLOCK_SMEM_RESERVED, SM_THREADS, SM_BLOCKS = 233472, 1024, 2048, 32
# ln_mxu_bf16's tile loads in flight per SM that its grid aims at: twice
# the 25 KB that 3.35 TB/s × about 1 µs of latency / 132 SMs gives by
# arithmetic (two blocks of 16-row tiles at d = 768; chip_smoke.py times
# the grids of one, two and four blocks per SM)
LN_MXU_BF16_IN_FLIGHT = 48 * 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _row_stride(d: int, esize: int) -> int:
    """``sa::row_stride``: d padded to 16, plus 16 bytes."""
    return -(-d // 16) * 16 + 16 // esize


def ln_mxu_smem_bytes(rows_per_program: int, num_warps: int, d: int, dtype) -> int:
    """Shared memory of one ``ln_mxu`` block (``smem_bytes`` of
    ``csrc/ln_mxu.cu``): the rows at ``sa::row_stride`` (d padded to 16,
    plus 16 bytes), a ``(Σx, Σx²)`` pair per warp and fragment row, and a
    ``(mean, rstd)`` pair per row."""
    esize = torch.empty(0, dtype=dtype).element_size()
    return (rows_per_program * _row_stride(d, esize) * esize
            + 8 * (16 * num_warps + rows_per_program))


def ln_mxu_bf16_smem_bytes(rows_per_program: int, num_warps: int, d: int) -> int:
    """Shared memory of one ``ln_mxu_bf16`` block (``bf16_smem_bytes`` of
    ``csrc/ln_mxu.cu``): two stages of rows at ``sa::row_stride``, scale and
    bias in bf16 (d padded to 16), a ``(Σx, Σx²)`` pair per warp and
    fragment row, and a ``(mean, rstd)`` pair of bf16 pairs per row."""
    return (2 * rows_per_program * _row_stride(d, 2) * 2 + 2 * -(-d // 16) * 16 * 2
            + 8 * (16 * num_warps + rows_per_program))


def ln_mxu_bf16_grid(rows: int, rows_per_program: int, num_warps: int, d: int,
                     sms: int) -> int:
    """Blocks of one ``ln_mxu_bf16`` launch: per SM, as many as keep
    ``LN_MXU_BF16_IN_FLIGHT`` bytes of tile loads in flight (each block has
    one tile in flight), at most as many as the SM holds (shared memory,
    threads), and never more blocks than tiles."""
    tiles = -(-rows // rows_per_program)
    smem = ln_mxu_bf16_smem_bytes(rows_per_program, num_warps, d) + BLOCK_SMEM_RESERVED
    fit = min(SM_SMEM // smem, SM_THREADS // (32 * num_warps), SM_BLOCKS)
    want = -(-LN_MXU_BF16_IN_FLIGHT // (rows_per_program * d * 2))
    return max(1, min(tiles, sms * min(fit, want)))


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


# the C entries of csrc/ln_mxu.cu: x, w, b, y, the row stride, the ints
# (rows, d, rows per tile, warps; vtc_ln_mxu_bf16: blocks), eps,
# (vtc_ln_mxu: the dtype,) the stream
_ARGTYPES = {
    "vtc_ln_mxu": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
    "vtc_ln_mxu_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
}


def _entry(symbol: str):
    fn = getattr(load_library("ln_mxu"), symbol)
    if fn.argtypes is None:  # ctypes hands back the same object every time
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[symbol]
    return fn


def _launch(x, scale, bias, eps, rows_per_program, num_warps):
    x2, stride = rows_view(x)
    rows, d = x2.shape
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    err = _entry("vtc_ln_mxu")(
        x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), stride,
        rows, d, rows_per_program, num_warps, eps, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, "ln_mxu")
    ln_mxu.launches += 1
    return y


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch_bf16(x, scale, bias, eps, rows_per_program, num_warps, blocks=None):
    """``blocks``: the grid, ``ln_mxu_bf16_grid``'s unless given (a grid
    study in ``chip_smoke.py`` times others; the kernel takes at most one
    block per tile)."""
    x2, stride = rows_view(x)
    rows, d = x2.shape
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if blocks is None:
        blocks = ln_mxu_bf16_grid(rows, rows_per_program, num_warps, d,
                                  _sm_count(x.device))
    err = _entry("vtc_ln_mxu_bf16")(
        x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), stride,
        rows, d, rows_per_program, num_warps, blocks, eps,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    check_launch(err, "ln_mxu_bf16")
    ln_mxu_bf16.launches += 1
    return y


def _check_config(name: str, rows_per_program: int, num_warps: int, d: int,
                  smem: int) -> None:
    """The (rows, warps) pairs the kernels take, and ``smem`` bytes of
    shared memory a block at most."""
    if rows_per_program < 16 or rows_per_program & (rows_per_program - 1):
        raise ValueError(
            f"rows_per_program must be a power of two >= 16 (a product's least "
            f"M), got {rows_per_program}"
        )
    tiles = rows_per_program // 16
    if not 1 <= num_warps <= LN_MXU_MAX_WARPS or num_warps % tiles:
        raise ValueError(
            f"{name}: num_warps must be a multiple of rows_per_program / 16 = "
            f"{tiles} and at most {LN_MXU_MAX_WARPS}, got {num_warps}"
        )
    if smem > LN_MXU_MAX_SMEM:
        raise ValueError(
            f"{name}: {rows_per_program} rows of d = {d} need {smem} bytes of "
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
    d = x.shape[-1]
    _check_config("ln_mxu", rows_per_program, num_warps, d,
                  ln_mxu_smem_bytes(rows_per_program, num_warps, d, x.dtype))
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
    normalization with per-row fp32 coefficients. bf16 in, bf16 out.

    ``rows_per_program`` rows make one tile of the CUDA kernel and
    ``num_warps`` warps one block, under ``ln_mxu``'s rules; a block holds
    two tiles (``ln_mxu_bf16_smem_bytes``), and the grid is
    ``ln_mxu_bf16_grid``'s. A configuration or width outside that raises, on
    the CPU too. ``scale`` and ``bias`` enter the kernel in fp32."""
    d = x.shape[-1]
    _check_config("ln_mxu_bf16", rows_per_program, num_warps, d,
                  ln_mxu_bf16_smem_bytes(rows_per_program, num_warps, d))
    if x.dtype != torch.bfloat16:
        raise TypeError(f"ln_mxu_bf16 takes bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return ln_mxu_bf16_plain(x, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_mxu_bf16 runs on cpu or cuda, not {x.device}")
    check_cuda_rows("ln_mxu_bf16", x, scale, bias)
    return forward_only("ln_mxu_bf16", lambda x_, s_, b_: _launch_bf16(
        x_, s_, b_, eps, rows_per_program, num_warps), x, scale.float(), bias.float())


ln_mxu.launches = 0
ln_mxu_bf16.launches = 0
