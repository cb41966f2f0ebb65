"""Sweep the LayerNorm kernel designs on the card.

    python -m vtc_tpu_torch.scripts.bench_ln_kernel [rows] [d]

The port's twin of ``scripts/bench_ln_kernel.py`` (``main``, ``:102-137``):
bf16 rows ``[8000, 768]`` by default (the ViT-B/32 residual stream at batch
160), scale and bias drawn from a seeded normal, and one line per design and
rows per program:

* ``vpu``: ``ops.layernorm``, whose kernel is ``vpu_kernel``'s math
  (two-pass fp32 statistics from one read of the row);
* ``mxu``: ``ops.ln_mxu``, the row sums as a product with ones, fp32;
* ``mxu_bf16``: ``ops.ln_mxu_bf16``, the same product fed bf16 (x and
  bf16(x²)), the normalization in bf16 steps, its blocks persistent over
  two stages of row tiles (``csrc/ln_mxu.cu``).

Each line gives µs per LN (device time, CUDA-graph replays over rotating
inputs larger than the L2 cache), GB/s at ``rows·d·2·2`` bytes (bf16 in and
out, as the JAX script counts) and the max |err| against
``ops.layernorm_plain`` (the twin of ``xla_ln``). ``F.layer_norm``'s time is
printed as the yardstick; no design calls it.

Rows per program: the TPU script's blocks of 160, 400 and 1600 rows give
50, 20 and 5 programs at 8000 rows, fewer than the H100's 132 SMs, so here
both CUDA designs sweep ``CONFIGS``, the configurations their kernels take
at d = 768: tiles of 16, 32 and 64 rows with one to eight warps per 16-row
tile. ``mxu`` launches one block per tile (500 to 125 blocks);
``mxu_bf16``'s blocks walk the tiles (``ops.ln_designs.ln_mxu_bf16_grid``).
``vpu`` runs at ``ops.layernorm``'s own choice (about 4096 elements per
program).

It needs a card and raises without one.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from .. import ops
from ..device import resolve_device
from ..ops.layernorm import row_blocks
from ..utils.timing import n_sets, time_ms

# (rows per program, warps) of ln_mxu and ln_mxu_bf16
CONFIGS = ((16, 1), (16, 2), (16, 4), (16, 8), (32, 2), (32, 4), (32, 8), (64, 4),
           (64, 8))


def designs(d: int):
    """[(design, rows per program, warps, fn(x, scale, bias))]."""
    out = [("vpu", row_blocks(d)[1], 4, ops.layernorm)]
    for name, fn in (("mxu", ops.ln_mxu), ("mxu_bf16", ops.ln_mxu_bf16)):
        for rows, warps in CONFIGS:
            out.append((name, rows, warps, lambda x, s, b, fn=fn, r=rows, w=warps:
                        fn(x, s, b, rows_per_program=r, num_warps=w)))
    return out


def main(rows: int = 8000, d: int = 768, seed: int = 0):
    """Run the sweep; print one line per design and return them as dicts
    (``design``, ``rows_per_program``, ``num_warps``, ``us``, ``gbs``,
    ``max_abs_err``)."""
    dev = resolve_device(None)
    rng = np.random.default_rng(seed)
    scale = torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(dev)
    nbytes = rows * d * 2 * 2
    x_sets = [
        (torch.from_numpy(rng.normal(size=(rows, d)).astype(np.float32))
         .to(dev).to(torch.bfloat16),)
        for _ in range(n_sets(nbytes))
    ]
    x = x_sets[0][0]
    ref = ops.layernorm_plain(x, scale, bias).float()

    results = []

    def line(name, per, warps, fn, err):
        us = time_ms(fn, x_sets) * 1e3
        row = dict(design=name, rows_per_program=per, num_warps=warps, us=us,
                   gbs=nbytes / us / 1e3, max_abs_err=err)
        results.append(row)
        err_s = "" if err is None else f"  err {err:.4f}"
        per_s = "" if per is None else f" rows/program={per} warps={warps}"
        print(f"{name + per_s:<40} {us:8.2f} us/LN  {row['gbs']:6.0f} GB/s{err_s}",
              flush=True)

    s16, b16 = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
    line("torch F.layer_norm (yardstick)", None, None,
         lambda x: F.layer_norm(x, (d,), s16, b16, 1e-5), None)
    line("plain (xla_ln twin)", None, None,
         lambda x: ops.layernorm_plain(x, scale, bias), 0.0)
    for name, per, warps, fn in designs(d):
        y = fn(x, scale, bias)
        err = (y.float() - ref).abs().max().item()
        line(name, per, warps, lambda x, fn=fn: fn(x, scale, bias), err)
    return results


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
