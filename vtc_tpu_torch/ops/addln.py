"""Fused residual add + LayerNorm with two outputs (``add_layernorm``), a
Triton kernel.

Port of ``vtc_tpu/ops/pallas_addln.py:add_layernorm`` (``:79``, kernel
``_addln_kernel`` ``:44``). ``s = a + b`` in fp32 and ``y = LN(s)`` with fp32
statistics, both cast to ``a.dtype``; ``s`` feeds the next residual junction
and ``y`` the block's MLP. ``a`` and ``b`` may differ in dtype: in the CAM in
bf16 mode the residual stream is fp32 and the attention branch bf16. On a
CUDA tensor ``add_layernorm`` launches the Triton kernel below; on a CPU
tensor it runs ``add_layernorm_plain``, the math of ``_xla_add_layernorm``
(``:71``). There is no fallback from one to the other.

Bound on the H100: bytes (two rows read, two written, per row one
reduction). Design: one program holds a block of whole rows of ``s`` in fp32
registers, writes ``s`` and computes the statistics from the same registers,
so ``s`` is never read back from device memory; four passes over the rows in
all, the least the two outputs allow.
"""

from __future__ import annotations

import torch

from ._build import forward_only, import_triton
from .layernorm import check_cuda_rows, layernorm_plain, row_blocks, rows_view

tl = None  # triton.language, bound by _kernel() at first launch
_KERNEL = None


def add_layernorm_plain(a, b, scale, bias, eps: float = 1e-5):
    s32 = a.float() + b.float()
    return s32.to(a.dtype), layernorm_plain(s32, scale, bias, eps).to(a.dtype)


def _addln_kernel(a_ptr, b_ptr, w_ptr, bias_ptr, s_ptr, y_ptr, rows, d,
                  stride_a, stride_b, eps,
                  BLOCK: tl.constexpr, ROWS: tl.constexpr):
    r = tl.program_id(0) * ROWS + tl.arange(0, ROWS)[:, None]
    c = tl.arange(0, BLOCK)[None, :]
    m = (r < rows) & (c < d)
    a = tl.load(a_ptr + r * stride_a + c, mask=m, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + r * stride_b + c, mask=m, other=0.0).to(tl.float32)
    s = a + b
    tl.store(s_ptr + r * d + c, s.to(s_ptr.dtype.element_ty), mask=m)
    mean = tl.sum(s, axis=1) / d
    sc = tl.where(m, s - mean[:, None], 0.0)
    var = tl.sum(sc * sc, axis=1) / d
    rstd = 1.0 / tl.sqrt(var + eps)
    w = tl.load(w_ptr + c, mask=c < d, other=0.0).to(tl.float32)
    bb = tl.load(bias_ptr + c, mask=c < d, other=0.0).to(tl.float32)
    y = sc * rstd[:, None] * w + bb
    tl.store(y_ptr + r * d + c, y.to(y_ptr.dtype.element_ty), mask=m)


def _kernel():
    global tl, _KERNEL
    if _KERNEL is None:
        triton, tl = import_triton()
        _KERNEL = triton.jit(_addln_kernel)
    return _KERNEL


def _launch(a, b, scale, bias, eps):
    a2, stride_a = rows_view(a)
    b2, stride_b = rows_view(b)
    rows, d = a2.shape
    s = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    y = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    block, per = row_blocks(d)
    _kernel()[((rows + per - 1) // per,)](
        a2, b2, scale, bias, s, y, rows, d, stride_a, stride_b, eps,
        BLOCK=block, ROWS=per, num_warps=4,
    )
    add_layernorm.launches += 1
    return s, y


def add_layernorm(a, b, scale, bias, eps: float = 1e-5):
    """``(a + b, LN(a + b))`` in one pass, both in ``a.dtype``."""
    if a.shape != b.shape:
        raise ValueError(f"a and b shapes differ: {a.shape} {b.shape}")
    if a.device.type == "cpu":
        return add_layernorm_plain(a, b, scale, bias, eps)
    if a.device.type != "cuda":
        raise ValueError(f"add_layernorm runs on cpu or cuda, not {a.device}")
    check_cuda_rows("add_layernorm", a, scale, bias)
    check_cuda_rows("add_layernorm", b, scale, bias)
    return forward_only(
        "add_layernorm",
        lambda a_, b_, s_, bi_: _launch(a_, b_, s_, bi_, eps),
        a, b, scale, bias,
    )


add_layernorm.launches = 0
