#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vtc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. build: compile the CUDA kernels from ``vtc_tpu_torch/csrc`` with nvcc
   (sm_90a), all sources at once, and the Triton kernels, and print the
   seconds;
3. kernels: each kernel against its plain PyTorch version on the card, fp32
   and bf16, at the shapes of the path that runs it: the flagship's (batch
   160) for ``layernorm``, ``add_layernorm`` and ``fused_mha``; the video
   model's temporal attention (batch 50, 8 frames: B·H = 29,400 sequences of
   L = 8, as strided head views of the merged qkv) and a masked shape
   (B·H = 960·8, L = 16, causal and a seeded additive mask) for
   ``fused_attention``; ``[8000, 768]`` for the LN sweep's ``ln_mxu`` and
   ``ln_mxu_bf16``. With times (CUDA-graph replays of launches over rotating
   inputs larger than the L2 cache, median of 5), the time of one PyTorch
   library call for the same function where there is one, and the least
   time the card could take (bytes over 3.35 TB/s or operations over the
   type's peak, the larger) and the kernel's share of it. ``fused_mha`` also
   runs at the video model's spatial shape (batch 400 frames, L = 50). In
   bf16 both attention kernels are held to at most 1e-4 of their outputs
   beyond one ulp of the typical output and none beyond one ulp of the
   largest, a limit shown to catch a P left unrounded. ``ln_mxu_bf16`` is
   also timed on grids of 1, 2 and 4 blocks per SM, and held, at one bf16
   ulp of the largest output, on ragged, strided, misaligned and narrow
   rows (``LN_BF16_EDGES``);
4. flagship: ``PretrainedCLIP_finaltf`` ViT-B/32 forward, fp32, batch 32,
   bench.py's inputs (uint8 patches, 16-token title and 5 comments, one
   empty), on the card against the same seeded weights on the CPU (plain
   versions); the CAM is moved off its zero-init by seeded noise so its
   attention and MLP branches count;
5. kernel use: the launch counters of that forward must read 29 layernorm,
   26 add_layernorm and 26 fused_mha launches, and none of the others;
6. serving: a RetrievalIndex of the card's image features plus 10^4 seeded
   rows answers ragged text and image batches; top-k ids equal the CPU's;
7. bf16: the flagship with ``convert_weights`` tracks fp32 (cosine > 0.995);
   its throughput at batch 160 (all the work of 20 windows over all their
   time, with the windows' spread) and a ``torch.profiler`` window of it
   (device time per kernel family, the device's idle share) are printed;
8. video: ``PretrainedCLIP_TimeSformer_finaltf`` built from the ``arch``
   block of ``configs/pretrained_clip_timesformer_comments_attention.jsonc``
   (ViT-B/32, 8 frames), fp32, batch 4 of uint8 patch frames with the
   flagship's texts, card against CPU; the CAM, ``temporal_fc`` and
   ``temporal_embed`` moved off their zero-init by seeded noise, so the
   temporal branch (``fused_attention``) counts. One forward must launch 41
   layernorm, 26 add_layernorm, 26 fused_mha and 12 fused_attention; in
   bf16 it tracks fp32 (cosine > 0.995), and its throughput in videos/s at
   the configuration's batch of 50 and a profiler window are printed;
9. LN sweep: ``vtc_tpu_torch.scripts.bench_ln_kernel`` at its defaults, the
   counts of its designs' launches read around it;
10. backward: each model kernel's gradient on the card (``fused_mha`` at
    ``vit``, ``text`` causal and ``cam``; ``fused_attention`` at the
    temporal strided views and at L 16 with a causal and a seeded additive
    mask; ``layernorm`` and ``add_layernorm`` at ``[160·50, 768]`` and
    ``[960·16, 512]``), fp32 and bf16, against ``torch.autograd.grad``
    through the plain version, tolerances beside the errors (fp32: 2e-5 of
    the largest |gradient|; bf16: two bf16 ulps at it), with the
    backward's time beside the kernel's forward time;
11. train-step parity: the flagship from the ``arch`` block of
    ``configs/pretrained_clip_comments_attention.jsonc`` (random adapter
    skip on), ViT-B/32, fp32, batch 8, the CAM moved off its zero-init; 3
    ``train_step``s with the config's optimizer on the card and on the CPU
    from the same weights and the same skip draws (drawn once, handed to
    both): each step's loss within 2e-6 (``LOSS_ATOL``), each parameter's
    gradient after step 1 within 1e-3 of its largest |gradient|; of the
    entries that moved on the CPU, at most 1% farther than 0.01 lr from the
    CPU's and the median moved by at least 0.5 lr, none farther than 2·lr
    per step; the unused ``final_linear`` takes no gradient and stays put;
    and one step of the frozen config
    (``pretrained_clip_comments_attn_frozen.jsonc``, ``freeze: all``)
    leaves the towers bit for bit and moves the CAM. The three steps'
    kernel launches are counted from 0 and must be 3 × (29, 26, 26);
12. train throughput: ``vtc_tpu_torch.scripts.bench_train_step`` (batch
    128, bf16 over fp32 weights, Adam amsgrad, StepLR): samples/s over 3
    windows of 8 steps after 3 warm-up steps, the peak memory, a loss that
    is finite and falls over the 27 steps on the one repeated batch, the
    kernels' forward launches of one step, and ``torch.profiler`` windows:
    the device's idle share over 5 plain steps, and device time per step
    by family and by phase over 5 steps with a synchronize after each
    phase (forward, backward, optimizer);
13. the kernels line (JSON) and, last, ``{"ok": true, "device": ...}``.

It needs one card, builds everything it runs, and exits non-zero, printing
no result, where CUDA is missing or the package is not beside it.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, no TF32
BENCH_BATCH = 160  # bench.py's batch
FWD_BATCH = 32
FP32_ATOL = 2e-5  # the repo's fp32 kernel tolerance (tests/test_pallas_attention.py)
FEAT_ATOL = 1e-4  # card vs CPU at full depth: GEMM sums in another order
COS_MIN = 0.995  # bf16 vs fp32 (tests/test_clip_parity.py::test_bf16_close_to_fp32)
CAM_NOISE = 0.05  # tests/test_torch_models.py's ``tiny`` fixture
TEMPORAL_NOISE = 0.02  # the std of the attention projections' init
# fused_mha and fused_attention in bf16: the share of outputs allowed beyond
# one ulp at the median |output|. Where the plain version's cuBLAS sums the
# fp32 scores and P·V in another order than the kernel's tensor cores, the
# roundings of P and of the output to bf16 flip at a few entries (a share of
# about 1e-5 on the H100); a P left unrounded moves a share of about 0.04.
ATTN_BF16_SHARE = 1e-4
WARMUP, WINDOWS, PER_WINDOW = 20, 20, 10  # flagship bf16 throughput: forwards
VIDEO_WARMUP, VIDEO_WINDOWS, VIDEO_PER_WINDOW = 5, 10, 4  # video: forwards
PROFILED = 5  # bf16 forwards under torch.profiler
VIDEO_CONFIG = "configs/pretrained_clip_timesformer_comments_attention.jsonc"
VIDEO_FWD_BATCH = 4
NFRAMES = 8
LN_SWEEP = (8000, 768)  # scripts/bench_ln_kernel.py's default rows
TRAIN_CONFIG = "configs/pretrained_clip_comments_attention.jsonc"
FROZEN_CONFIG = "configs/pretrained_clip_comments_attn_frozen.jsonc"
PARITY_BATCH, PARITY_STEPS = 8, 3
# card vs CPU, full depth fp32, loss ~2.1: the measured spread was 2.38e-7,
# one ulp (PERF.md, PR 6 run 1); 2e-6 leaves eight
LOSS_ATOL = 2e-6
# after the parity steps, the share of the entries that moved on the CPU that
# may lie farther than PARAM_ATOL_LR·lr from the CPU's (tests/test_torch_
# training.py's bound against JAX): Adam turns a gradient near 0 into a step of
# about ±lr, so a few entries may differ by up to 2 lr per step in a right run
PARAM_ATOL_LR, PARAM_FAR_SHARE = 1e-2, 1e-2
# the median entry that moved on the CPU moved by at least this many lr, so
# the check above is not met by an optimizer that does nothing
MOVED_MIN_LR = 0.5
GRAD_RTOL = 1e-3  # of each parameter's largest |gradient|, card vs CPU
# ln_mxu_bf16 beyond the sweep's shape: rows, d, row stride, x's offset and
# the parameters' offset in elements. Blocks walk the 8000-row tiles; the
# element copies (d = 100, stride 770, an offset base) and element stores
# (d = 100) take their paths, and the last tile of 37 and 8001 rows is ragged
LN_BF16_EDGES = {
    "37x100": (37, 100, 100, 0, 0), "50x16": (50, 16, 16, 0, 0),
    "8000x100": (8000, 100, 100, 0, 0), "8001x768": (8001, 768, 768, 0, 0),
    "row stride 800": (8000, 768, 800, 0, 0), "row stride 770": (8000, 768, 770, 0, 0),
    "base off 16 bytes": (8000, 768, 768, 1, 0),
    "params off 16 bytes": (8000, 768, 768, 0, 1),
}
PORT_KERNELS = ("layernorm", "add_layernorm", "fused_mha", "fused_attention")
EXPECTED_LAUNCHES = {"layernorm": 29, "add_layernorm": 26, "fused_mha": 26,
                     "fused_attention": 0, "ln_mxu": 0, "ln_mxu_bf16": 0}
# video: 26 LN in the tower (ln_pre, 12 × (ln_time + ln_1), ln_post), 13 in
# the text tower, 2 in the CAM; add+LN and fused_mha 12 + 12 + 2
EXPECTED_VIDEO_LAUNCHES = {"layernorm": 41, "add_layernorm": 26, "fused_mha": 26,
                           "fused_attention": 12, "ln_mxu": 0, "ln_mxu_bf16": 0}
KERNEL_FAMILIES = (  # device-kernel name fragments, matched in this order
    ("add_layernorm", ("_addln_kernel",)),
    ("layernorm", ("_ln_kernel",)),
    ("fused_mha", ("fused_mha_kernel",)),
    ("fused_attention", ("fused_attention_kernel",)),
    ("gemm", ("gemm", "Gemm", "gemv", "nvjet", "cutlass", "xmma")),
)
SOURCES = {
    "layernorm": ("triton", "vtc_tpu_torch/ops/layernorm.py",
                  "vtc_tpu/ops/pallas_layernorm.py:66"),
    "add_layernorm": ("triton", "vtc_tpu_torch/ops/addln.py",
                      "vtc_tpu/ops/pallas_addln.py:79"),
    "fused_mha": ("cuda", "vtc_tpu_torch/csrc/fused_mha.cu",
                  "vtc_tpu/ops/pallas_attention.py:288"),
    "fused_attention": ("cuda", "vtc_tpu_torch/csrc/fused_attention.cu",
                        "vtc_tpu/ops/pallas_attention.py:131"),
    "ln_mxu": ("cuda", "vtc_tpu_torch/csrc/ln_mxu.cu",
               "scripts/bench_ln_kernel.py:39"),
    "ln_mxu_bf16": ("cuda", "vtc_tpu_torch/csrc/ln_mxu.cu",
                    "scripts/bench_ln_kernel.py:61"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def bf16_tol(ref: torch.Tensor, ulps: int) -> float:
    """``ulps`` bf16 ulps at the largest magnitude of ``ref``."""
    return ulps * 2.0**-7 * max(1.0, ref.abs().max().item())


def bf16_ulp_at_median(ref: torch.Tensor) -> float:
    """The spacing of bf16 numbers at the median magnitude of ``ref``: one
    ulp of the typical element."""
    return 2.0 ** (math.floor(math.log2(ref.float().abs().median().item())) - 7)


def mha_p_unrounded(q, k, v, heads: int, causal: bool) -> torch.Tensor:
    """``fused_mha_plain`` with P left in fp32: the fault that the bf16 check
    of ``fused_mha`` must see. (At Dh = 64 the scale is 1/8, so q·scale is
    exact in bf16 and P's rounding is the only one that shows.)"""
    b, l, e = q.shape
    d = e // heads
    qh = (q * torch.tensor(d**-0.5, dtype=q.dtype)).reshape(b, l, heads, d)
    scores = torch.einsum("blhd,bmhd->bhlm", qh.float(),
                          k.reshape(b, l, heads, d).float())
    if causal:
        scores = scores.masked_fill(
            torch.ones(l, l, dtype=torch.bool, device=q.device).triu(1), float("-inf"))
    out = torch.einsum("bhlm,bmhd->blhd", torch.softmax(scores, -1),
                       v.reshape(b, l, heads, d).float())
    return out.reshape(b, l, e).to(q.dtype)


def attention_p_unrounded(q, k, v, mask) -> torch.Tensor:
    """``fused_attention_plain`` with P left in fp32."""
    scores = torch.einsum("...id,...jd->...ij", q.float(), k.float()) * q.shape[-1] ** -0.5
    if mask is not None:
        scores = scores + mask
    return torch.einsum("...ij,...jd->...id", torch.softmax(scores, -1),
                        v.float()).to(q.dtype)


def share_beyond(out, ref, tol: float) -> float:
    return ((out.float() - ref.float()).abs() > tol).float().mean().item()


def bf16_share_check(kernel: str, name: str, out, ref, fault) -> float:
    """The attention kernels' bf16 rule: at most ``ATTN_BF16_SHARE`` of the
    outputs beyond one ulp at the median |output|, and ``fault`` (the plain
    version with P left unrounded) beyond it. Returns the max-abs tolerance
    that goes with it, one ulp at the largest |output|."""
    median_ulp = bf16_ulp_at_median(ref)
    share = share_beyond(out, ref, median_ulp)
    fault_share = share_beyond(fault, ref, median_ulp)
    log(f"kernel {kernel} {name} bfloat16: {share:.3g} of outputs beyond one ulp "
        f"at the median ({median_ulp:.3g}), limit {ATTN_BF16_SHARE:g}; P left "
        f"unrounded: {fault_share:.3g} of them, max diff "
        f"{(fault.float() - ref.float()).abs().max().item():.3g}")
    require(share <= ATTN_BF16_SHARE,
            f"{kernel} {name}: {share} of outputs beyond {median_ulp}")
    require(fault_share > ATTN_BF16_SHARE,
            f"{kernel} {name}: the bf16 check cannot see P's rounding ({fault_share})")
    return bf16_tol(ref, 1)


def kernel_instance(ptxas_line: str) -> str:
    """The kernel and template arguments of a ptxas "Compiling entry
    function" line, e.g. ``fused_mha<bf16, 8, 4>``, ``ln_mxu<fp32>``,
    ``ln_mxu_bf16<8>``: the ``*_kernel`` name whose length prefix matches
    it (the anonymous namespace before it ends in a hash of digits)."""
    for m in re.finditer(r"(?=(\d+)([a-z]\w*?_kernel)I(\w+?)EEvNS)", ptxas_line):
        if int(m.group(1)) == len(m.group(2)):
            args = re.findall(r"13__nv_bfloat16|f(?=Li|$)|(?<=Li)\d+", m.group(3))
            args = ["bf16" if a.endswith("bfloat16") else "fp32" if a == "f" else a
                    for a in args]
            return f"{m.group(2)[:-len('_kernel')]}<{', '.join(args)}>"
    return ptxas_line


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---- phase 3: kernels against their plain versions -------------------------

def check_kernels(ops) -> dict:
    """-> {kernel: {"cases": [...], "headline": case}}; a case holds the
    error, its tolerance and the times. The headline case is the largest
    bf16 launch of the kernel's path: the ViT shape at batch 160, the video
    model's temporal attention at batch 50, the sweep's [8000, 768]."""
    import torch.nn.functional as F

    from vtc_tpu_torch.utils.timing import n_sets, time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b = BENCH_BATCH
    ln_shapes = {"vit": (b * 50, 768), "text": (6 * b * 16, 512), "cam": (b * 6, 512)}
    mha_shapes = {"vit": (b, 50, 768, 12, False), "text": (6 * b, 16, 512, 8, True),
                  "cam": (b, 6, 512, 8, False),
                  # the video model's spatial attention: 50 videos x 8 frames
                  "video": (400, 50, 768, 12, False)}
    out = {k: {"cases": []} for k in SOURCES}

    def record(kernel, shape_name, dtype, err, tol, ms, plain_ms, library_ms,
               bound_ms, bound_by, desc, headline=None):
        case = dict(shape=shape_name, dtype=str(dtype).split(".")[-1],
                    max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        out[kernel]["cases"].append(case)
        if headline if headline is not None else (
                shape_name == "vit" and dtype == torch.bfloat16):
            out[kernel]["headline"] = case
        lib = "n/a" if library_ms is None else f"{library_ms:.5f}"
        log(f"kernel {kernel} {shape_name} {case['dtype']} {desc}: "
            f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib} "
            f"bound_us={bound_ms * 1e3:.2f} ({bound_by}) "
            f"share_of_bound={bound_ms / ms:.4f} "
            f"max_abs_err={err:.3g} tol={tol:.3g}")
        require(err <= tol, f"{kernel} {shape_name} {case['dtype']}: "
                f"max_abs_err {err} > tol {tol}")

    def record_error(kernel, shape_name, dtype, err, tol, desc):
        """A case held for its error alone (untimed)."""
        out[kernel]["cases"].append(dict(shape=shape_name, dtype=str(dtype).split(".")[-1],
                                         max_abs_err=err, tol=tol))
        log(f"kernel {kernel} {shape_name} {str(dtype).split('.')[-1]} {desc}: "
            f"max_abs_err={err:.3g} tol={tol:.3g}")
        require(err <= tol, f"{kernel} {shape_name}: max_abs_err {err} > tol {tol}")

    for dtype in (torch.float32, torch.bfloat16):
        esize = torch.finfo(dtype).bits // 8
        for name, (rows, d) in ln_shapes.items():
            w = (1 + 0.2 * torch.randn(d, device=dev, generator=g)).contiguous()
            bias = (0.2 * torch.randn(d, device=dev, generator=g)).contiguous()
            # the CAM's residual stream stays fp32 in bf16 mode (a), its branch
            # output is bf16 (b)
            a_dtype = torch.float32 if name == "cam" else dtype
            a_size = torch.finfo(a_dtype).bits // 8
            per = rows * d * (esize + a_size)
            sets = [(2 * torch.randn(rows, d, device=dev, generator=g) + 0.5)
                    for _ in range(n_sets(per))]
            x_sets = [(x.to(dtype),) for x in sets]
            ab_sets = [(x.to(a_dtype), torch.roll(x, 1, 0).to(dtype)) for x in sets]

            x = x_sets[0][0]
            y = ops.layernorm(x, w, bias)
            torch.cuda.synchronize()
            ref = ops.layernorm_plain(x, w, bias)
            err = (y.float() - ref.float()).abs().max().item()
            tol = FP32_ATOL if dtype == torch.float32 else bf16_tol(ref.float(), 1)
            w_l, b_l = w.to(dtype), bias.to(dtype)
            bms, by = bound(rows * d * 2 * esize + 2 * d * 4, 8 * rows * d, dtype)
            record("layernorm", name, dtype, err, tol,
                   time_ms(lambda x: ops.layernorm(x, w, bias), x_sets),
                   time_ms(lambda x: ops.layernorm_plain(x, w, bias), x_sets),
                   time_ms(lambda x: F.layer_norm(x, (d,), w_l, b_l, 1e-5), x_sets),
                   bms, by, f"rows={rows} d={d}")

            a, bb = ab_sets[0]
            s, y = ops.add_layernorm(a, bb, w, bias)
            torch.cuda.synchronize()
            s_ref, y_ref = ops.add_layernorm_plain(a, bb, w, bias)
            err = max((s.float() - s_ref.float()).abs().max().item(),
                      (y.float() - y_ref.float()).abs().max().item())
            tol = FP32_ATOL if a_dtype == torch.float32 else bf16_tol(y_ref.float(), 1)
            nbytes = rows * d * (a_size + esize + 2 * a_size) + 2 * d * 4
            bms, by = bound(nbytes, 9 * rows * d, dtype)
            record("add_layernorm", name, dtype, err, tol,
                   time_ms(lambda a, b_: ops.add_layernorm(a, b_, w, bias), ab_sets),
                   time_ms(lambda a, b_: ops.add_layernorm_plain(a, b_, w, bias),
                           ab_sets),
                   None, bms, by, f"rows={rows} d={d} a={a_dtype} b={dtype}")

        for name, (bsz, l, e, h, causal) in mha_shapes.items():
            per = 4 * bsz * l * e * esize
            qkv_sets = [
                torch.randn(bsz, l, 3 * e, device=dev, generator=g).to(dtype).chunk(3, -1)
                for _ in range(n_sets(per))
            ]
            q, k, v = qkv_sets[0]
            o = ops.fused_mha(q, k, v, h, causal)
            torch.cuda.synchronize()
            ref = ops.fused_mha_plain(q, k, v, h, causal)
            err = (o.float() - ref.float()).abs().max().item()
            if dtype == torch.float32:
                tol = FP32_ATOL
            else:
                tol = bf16_share_check("fused_mha", name, o, ref,
                                       mha_p_unrounded(q, k, v, h, causal))
            dh = e // h
            pairs = l * (l + 1) // 2 if causal else l * l  # (query, key) pairs run
            bms, by = bound(per, 4 * bsz * h * pairs * dh, dtype)

            def sdpa(q, k, v):
                def heads(t):
                    return t.view(bsz, l, h, dh).transpose(1, 2)

                return F.scaled_dot_product_attention(
                    heads(q), heads(k), heads(v), is_causal=causal
                )

            record("fused_mha", name, dtype, err, tol,
                   time_ms(lambda q, k, v: ops.fused_mha(q, k, v, h, causal), qkv_sets),
                   time_ms(lambda q, k, v: ops.fused_mha_plain(q, k, v, h, causal),
                           qkv_sets),
                   time_ms(sdpa, qkv_sets), bms, by,
                   f"B={bsz} L={l} E={e} H={h} causal={causal}")
        del sets, x_sets, ab_sets, qkv_sets
        torch.cuda.empty_cache()

        check_fused_attention(ops, dtype, g, record)
        torch.cuda.empty_cache()

    check_ln_designs(ops, g, record, record_error)
    return out


def check_fused_attention(ops, dtype, g, record) -> None:
    """``fused_attention`` at the video model's temporal shape (strided head
    views of a [2450, 8, 3·768] qkv buffer, no mask) and at a masked shape.
    Yardsticks: SDPA (with ``attn_mask`` where there is a mask) and, at the
    temporal shape, ``fused_mha`` on the same buffer, the same function at
    Dh = 64."""
    import torch.nn.functional as F

    from vtc_tpu_torch.utils.timing import n_sets, time_ms

    dev = torch.device("cuda")
    esize = torch.finfo(dtype).bits // 8
    seqs, t, e, h = 50 * 49, NFRAMES, 768, 12
    dh = e // h
    lengths = {"temporal": t, "causal": 16, "additive": 16}
    seeded = torch.randn(16, 16, device=dev, generator=g)
    seeded = seeded.masked_fill(torch.rand(16, 16, device=dev, generator=g) < 0.3,
                                float("-inf")).fill_diagonal_(0.0)
    masks = {"temporal": None, "causal": ops.causal_mask(16, dev), "additive": seeded}

    for name, mask in masks.items():
        length = lengths[name]
        if name == "temporal":
            per = 4 * seqs * t * e * esize
            buffers = [torch.randn(seqs, t, 3 * e, device=dev, generator=g).to(dtype)
                       for _ in range(n_sets(per))]
            sets = [tuple(x.unflatten(-1, (h, dh)).transpose(1, 2) for x in buf.chunk(3, -1))
                    for buf in buffers]
            nbh = seqs * h
            desc = f"B·H={seqs}·{h} L={t} D={dh} strided head views, no mask"
        else:
            nbh = 960 * 8
            per = 4 * nbh * length * dh * esize
            sets = [tuple(torch.randn(nbh, length, dh, device=dev, generator=g).to(dtype)
                          for _ in range(3)) for _ in range(n_sets(per))]
            desc = f"B·H={nbh} L={length} D={dh} {name} mask"
        q, k, v = sets[0]
        o = ops.fused_attention(q, k, v, mask)
        torch.cuda.synchronize()
        ref = ops.fused_attention_plain(q, k, v, mask)
        err = (o.float() - ref.float()).abs().max().item()
        if dtype == torch.float32:
            tol = FP32_ATOL
        else:
            tol = bf16_share_check("fused_attention", name, o, ref,
                                   attention_p_unrounded(q, k, v, mask))
        mask_bytes = 0 if mask is None else length * length * 4
        bms, by = bound(per + mask_bytes, 4 * nbh * length * length * dh, dtype)

        def kernel(q, k, v):
            return ops.fused_attention(q, k, v, mask)

        def plain(q, k, v):
            return ops.fused_attention_plain(q, k, v, mask)

        def sdpa(q, k, v):
            if q.dim() == 3:
                q, k, v = (x.view(960, 8, length, dh) for x in (q, k, v))
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)

        if name == "temporal":
            mha_ms = time_ms(lambda buf: ops.fused_mha(*buf.chunk(3, -1), h),
                             [(buf,) for buf in buffers])
            log(f"kernel fused_attention temporal {str(dtype)[6:]}: fused_mha on "
                f"the same qkv buffer {mha_ms:.5f} ms")
        record("fused_attention", name, dtype, err, tol, time_ms(kernel, sets),
               time_ms(plain, sets), time_ms(sdpa, sets), bms, by, desc,
               headline=name == "temporal" and dtype == torch.bfloat16)
        del sets


def check_ln_designs(ops, g, record, record_error) -> None:
    """The LN sweep's two product designs at [8000, 768], against their
    plain versions; ``ln_mxu_bf16``'s time on other grids, and its error on
    ``LN_BF16_EDGES``. ``ln_mxu`` on fp32 rows: 2e-5, the sums in another
    order and ``E[x²] − E[x]²``'s cancellation (under one bit for mean 0.5,
    std 2); on bf16 rows, and ``ln_mxu_bf16``: one bf16 ulp at the largest
    |output| (the order of the sums can move a rounding to bf16 by a
    step)."""
    import torch.nn.functional as F

    from vtc_tpu_torch.ops import ln_designs
    from vtc_tpu_torch.utils.timing import n_sets, time_ms

    dev = torch.device("cuda")
    rows, d = LN_SWEEP
    w = (1 + 0.2 * torch.randn(d, device=dev, generator=g)).contiguous()
    bias = (0.2 * torch.randn(d, device=dev, generator=g)).contiguous()
    for name, fn, plain, dtypes in (
        ("ln_mxu", ops.ln_mxu, ops.ln_mxu_plain, (torch.float32, torch.bfloat16)),
        ("ln_mxu_bf16", ops.ln_mxu_bf16, ops.ln_mxu_bf16_plain, (torch.bfloat16,)),
    ):
        for dtype in dtypes:
            esize = torch.finfo(dtype).bits // 8
            nbytes = rows * d * 2 * esize + 2 * d * 4
            x_sets = [((2 * torch.randn(rows, d, device=dev, generator=g) + 0.5)
                       .to(dtype),) for _ in range(n_sets(nbytes))]
            x = x_sets[0][0]
            y = fn(x, w, bias)
            torch.cuda.synchronize()
            ref = plain(x, w, bias)
            err = (y.float() - ref.float()).abs().max().item()
            tol = FP32_ATOL if dtype == torch.float32 else bf16_tol(ref.float(), 1)
            w_l, b_l = w.to(dtype), bias.to(dtype)
            bms, by = bound(nbytes, 8 * rows * d, dtype)
            record(name, "sweep", dtype, err, tol,
                   time_ms(lambda x: fn(x, w, bias), x_sets),
                   time_ms(lambda x: plain(x, w, bias), x_sets),
                   time_ms(lambda x: F.layer_norm(x, (d,), w_l, b_l, 1e-5), x_sets),
                   bms, by, f"rows={rows} d={d}", headline=dtype == torch.bfloat16)
    # ln_mxu_bf16's grid (ln_mxu_bf16_grid) against one, two and four blocks
    # per SM at its configuration; four at 16-row tiles is one block per
    # tile, one wave, as ln_mxu runs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_tile, warps = ln_designs.LN_MXU_BF16_CONFIG
    tiles = -(-rows // per_tile)
    rule = ln_designs.ln_mxu_bf16_grid(rows, per_tile, warps, d, sms)
    for per_sm in (1, 2, 4):
        blocks = min(tiles, sms * per_sm)
        ms = time_ms(lambda x: ln_designs._launch_bf16(x, w, bias, 1e-5, per_tile, warps,
                                                       blocks), x_sets)
        log(f"kernel ln_mxu_bf16 sweep bfloat16 rows={rows} d={d} ({per_tile}, {warps}) on "
            f"{blocks} blocks ({per_sm} per SM{', the grid rule' if blocks == rule else ''}, "
            f"{tiles / blocks:.2f} tiles per block): kernel_ms={ms:.5f} "
            f"share_of_bound={bms / ms:.4f}")
    for name, (rows, d, width, offset, p_offset) in LN_BF16_EDGES.items():
        flat = 2 * torch.randn(rows * width + offset, device=dev, generator=g) + 0.5
        x = flat.to(torch.bfloat16)[offset:].view(rows, width)[:, :d]
        w, bias = ((mu + 0.2 * torch.randn(d + p_offset, device=dev, generator=g))[p_offset:]
                   for mu in (1.0, 0.0))
        y = ops.ln_mxu_bf16(x, w, bias)
        torch.cuda.synchronize()
        ref = ops.ln_mxu_bf16_plain(x, w, bias).float()
        require(y.shape == x.shape and y.is_contiguous(), f"ln_mxu_bf16 {name}: layout")
        record_error("ln_mxu_bf16", name, torch.bfloat16, (y.float() - ref).abs().max().item(),
                     bf16_tol(ref, 1), f"rows={rows} d={d} row stride={width} "
                     f"x offset={offset} parameter offset={p_offset}")


# ---- phases 4-9: the port's main paths ---------------------------------------

def bench_inputs(batch: int, patch: int, seed: int = 0, frames: int = 0):
    """bench.py's recipe: uint8 patches and synthetic 16-token texts, plus one
    empty comment (row 0, comment 4) so the mask embedding is on the path.
    With ``frames``, the patches are of ``[batch, frames]`` video frames."""
    from vtc_tpu_torch.data import EOT_ID, SOT_ID, extract_patches, synthetic_tokens

    rng = np.random.default_rng(seed)
    lead = (batch, frames) if frames else (batch,)
    u8 = rng.integers(0, 256, lead + (224, 224, 3), dtype=np.uint8)
    vis = extract_patches(u8, patch)
    title = synthetic_tokens((batch,), 16, 14, rng)
    comments = synthetic_tokens((batch, 5), 16, 14, rng)
    comments[0, 4] = 0
    comments[0, 4, :2] = (SOT_ID, EOT_ID)
    return [torch.from_numpy(a) for a in (vis, title, comments)]


def cosines(a, b):
    return (a.float().cpu() * b.float().cpu()).sum(-1)


@torch.no_grad()
def perturb(model, seed: int = 0):
    """Move the zero-init parameters off zero, identically on every device:
    seeded N(0, CAM_NOISE) noise on each ``final_transformer``/
    ``final_linear`` parameter, as the CPU tests' ``tiny`` fixture does, and
    N(0, TEMPORAL_NOISE) on each ``temporal_fc``/``temporal_embed``. At
    zero-init the adapter's attention and MLP branches, and the
    TimeSformer's temporal branch, are multiplied by zero weights, and the
    end-to-end checks could not see how they call their kernels."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.startswith(("final_transformer.", "final_linear.")):
            std = CAM_NOISE
        elif ".temporal_fc." in name or name.endswith(".temporal_embed"):
            std = TEMPORAL_NOISE
        else:
            continue
        p.add_(std * torch.randn(p.shape, generator=g).to(p.device))
    return model


def flagship(**kwargs):
    from vtc_tpu_torch.models import create_model

    return perturb(create_model("PretrainedCLIP_finaltf",
                                model_type="ViT-B/32", seed=0, **kwargs))


def video_model(**kwargs):
    """The video CAM model from the ``arch`` block of the repo's config."""
    from vtc_tpu_torch.models import create_model
    from vtc_tpu_torch.utils import jsonc

    arch = jsonc.read_json(Path(__file__).resolve().parent / VIDEO_CONFIG)["arch"]
    return perturb(create_model(arch["type"], seed=0, nframes=NFRAMES,
                                **arch["args"], **kwargs))


def profile_calls(fn, n: int) -> dict:
    """``n`` calls of ``fn`` (forwards, train steps) under
    ``torch.profiler``: device time per kernel family (the port's kernels,
    GEMMs, the rest) and the device's idle share, 1 - (union of device
    intervals) / (the host's window from the first launch to the
    synchronize after the last call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("forwards"):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    window = next(e for e in events
                  if e.name == "forwards" and e.device_type == DeviceType.CPU)
    t0, t1 = window.time_range.start, window.time_range.end
    device = sorted(
        (e for e in events
         if e.device_type == DeviceType.CUDA and not e.is_user_annotation),
        key=lambda e: e.time_range.start,
    )
    require(len(device) > 0, "the profiler recorded no device events")
    by_family, other = {}, {}
    busy, end = 0.0, t0
    for e in device:
        start, stop = max(e.time_range.start, end), min(e.time_range.end, t1)
        if stop > start:
            busy += stop - start
            end = stop
        us = e.time_range.end - e.time_range.start
        family = next((f for f, keys in KERNEL_FAMILIES if any(k in e.name for k in keys)),
                      "other")
        by_family[family] = by_family.get(family, 0.0) + us
        if family == "other":
            other[e.name] = other.get(e.name, 0.0) + us
    return {"window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / (t1 - t0),
            "family_ms": {f: us / 1e3 / n for f, us in by_family.items()},
            "other_top": sorted(other.items(), key=lambda kv: -kv[1])[:6],
            "launches": len(device) / n}


def throughput(what, model, inputs, batch, warmup, windows, per_window, unit,
               smi) -> None:
    """All the work of ``windows`` windows of ``per_window`` forwards over all
    their time, after ``warmup`` forwards, with the windows' spread."""
    for _ in range(warmup):
        model(*inputs)
    torch.cuda.synchronize()
    seconds = []
    for _ in range(windows):
        tic = time.perf_counter()
        for _ in range(per_window):
            model(*inputs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - tic)
    rates = sorted(batch * per_window / s for s in seconds)
    log(f"throughput {what}: {batch * per_window * windows / sum(seconds):.1f} {unit}, all "
        f"{windows * per_window} forwards over {sum(seconds):.4f} s after "
        f"{warmup} warm-up forwards; windows of {per_window}: min "
        f"{rates[0]:.1f} median {statistics.median(rates):.1f} max "
        f"{rates[-1]:.1f} {unit}; on {smi}")


def log_profile(prof, what: str) -> None:
    log(f"profile {what}, {PROFILED} forwards under torch.profiler: window "
        f"{prof['window_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, idle "
        f"share {prof['idle_share']:.4f}, {prof['launches']:.0f} device events "
        f"per forward")
    total = sum(prof["family_ms"].values())
    for family, ms in sorted(prof["family_ms"].items(), key=lambda kv: -kv[1]):
        log(f"profile device ms per forward: {family} {ms:.4f} "
            f"({ms / total:.4f} of device time)")
    for kname, us in prof["other_top"]:
        log(f"profile other: {us / 1e3 / PROFILED:.4f} ms per forward: {kname[:120]}")


def compare_with_cpu(what, outs, cpu_outs, scale) -> None:
    for name, a, c, atol in zip(("feats_vis", "feats_text", "sim"), outs, cpu_outs,
                                (FEAT_ATOL, FEAT_ATOL, scale * FEAT_ATOL)):
        require(a.shape == c.shape and bool(torch.isfinite(a).all()),
                f"{what} {name}: shape {tuple(a.shape)} or non-finite values")
        err = (a.cpu() - c).abs().max().item()
        log(f"{what} fp32 {name} {tuple(a.shape)}: max_abs_err vs CPU "
            f"{err:.3g} (atol {atol:.3g})")
        require(err <= atol, f"{what} {name} differs from the CPU run by {err}")


def run_video(ops, smi) -> dict:
    """Phase 8: the video model. Returns the launch counts of one forward."""
    from vtc_tpu_torch.models import convert_weights

    tic = time.perf_counter()
    model = video_model()
    cpu_model = video_model(device="cpu")
    log(f"video models built in {time.perf_counter() - tic:.1f} s")
    inputs = bench_inputs(VIDEO_FWD_BATCH, 32, seed=3, frames=NFRAMES)
    with torch.inference_mode():
        model(*[t.cuda() for t in inputs])  # warm up
        torch.cuda.synchronize()
        # the video path's run: counts from 0 just before, read just after
        ops.reset_launch_counts()
        outs = model(*[t.cuda() for t in inputs])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        tic = time.perf_counter()
        cpu_outs = cpu_model(*inputs)
        log(f"video CPU forward, batch {VIDEO_FWD_BATCH}: "
            f"{time.perf_counter() - tic:.1f} s")
    log(f"kernel use (video forward): {json.dumps(launches)}")
    require(launches == EXPECTED_VIDEO_LAUNCHES,
            f"video launches {launches} != expected {EXPECTED_VIDEO_LAUNCHES}")
    compare_with_cpu("video", outs, cpu_outs, cpu_model.model.logit_scale.exp().item())
    del cpu_model

    bf16 = convert_weights(video_model(dtype="bf16"))
    with torch.inference_mode():
        fv16, ft16, _ = bf16(*[t.cuda() for t in inputs])
        for name, a, b in (("feats_vis", fv16, outs[0]), ("feats_text", ft16, outs[1])):
            cos = cosines(a, b).min().item()
            log(f"video bf16 {name}: min cosine vs fp32 {cos:.6f} (> {COS_MIN})")
            require(cos > COS_MIN, f"video bf16 {name} cosine {cos} <= {COS_MIN}")
        del model
        torch.cuda.empty_cache()
        batch = 50  # the configuration's batch_size
        big = [t.cuda() for t in bench_inputs(batch, 32, seed=4, frames=NFRAMES)]
        throughput(f"video bf16 batch {batch} ({NFRAMES} frames, 16-token title "
                   f"+ 5 comments)", bf16, big, batch, VIDEO_WARMUP, VIDEO_WINDOWS,
                   VIDEO_PER_WINDOW, "videos/s", smi)
        prof = profile_calls(lambda: bf16(*big), PROFILED)
    log_profile(prof, f"video bf16 batch {batch}")
    return launches


def run_ln_sweep(ops) -> dict:
    """Phase 9: the LN sweep's entry point. Returns its launch counts."""
    from vtc_tpu_torch.scripts import bench_ln_kernel

    ops.reset_launch_counts()
    bench_ln_kernel.main(*LN_SWEEP)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"kernel use (LN sweep): {json.dumps(launches)}")
    for name in ("layernorm", "ln_mxu", "ln_mxu_bf16"):
        require(launches[name] > 0, f"the LN sweep launched no {name}")
    return launches


# ---- phases 10-12: training ---------------------------------------------------

def grad_tol(ref: torch.Tensor) -> float:
    """fp32: 2e-5 of the largest |gradient| (at least 2e-5); bf16: two bf16
    ulps at it."""
    if ref.dtype == torch.bfloat16:
        return bf16_tol(ref.float(), 2)
    return FP32_ATOL * max(1.0, ref.abs().max().item())


def check_backward(ops) -> dict:
    """Phase 10: each model kernel's gradient against autograd through its
    plain version, on the card. Returns {kernel: [case, ...]}."""
    from vtc_tpu_torch.utils.timing import n_sets, time_ms

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    out = {k: [] for k in PORT_KERNELS}

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    def held(kernel, shape, dtype, inputs, cots, fn, plain, bwd, fwd, desc):
        """Gradients of ``fn`` and ``plain`` w.r.t. ``inputs``; times of
        ``bwd(*detached inputs, *cots)`` and of ``fwd`` (the kernel's
        forward) over rotating copies."""
        outs = fn(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        refs = plain(*inputs)
        refs = refs if isinstance(refs, tuple) else (refs,)
        ours = torch.autograd.grad(outs, inputs, cots)
        ref = torch.autograd.grad(refs, inputs, cots)
        errs = [(o.float() - r.float()).abs().max().item() for o, r in zip(ours, ref)]
        tols = [grad_tol(r) for r in ref]
        detached = [t.detach() for t in inputs]
        nbytes = sum(t.numel() * t.element_size() for t in detached + list(cots))
        sets = [tuple(detached) + tuple(cots)] + [
            tuple(t.clone() for t in detached + list(cots))
            for _ in range(n_sets(nbytes) - 1)]
        with torch.no_grad():
            bwd_ms = time_ms(bwd, sets)
            fwd_ms = time_ms(fwd, [c[:len(detached)] for c in sets])
        case = dict(shape=shape, dtype=str(dtype).split(".")[-1], bwd_ms=bwd_ms,
                    fwd_ms=fwd_ms, max_abs_err=max(errs))
        out[kernel].append(case)
        log(f"backward {kernel} {shape} {case['dtype']} {desc}: backward_ms="
            f"{bwd_ms:.5f} kernel_forward_ms={fwd_ms:.5f} ({bwd_ms / fwd_ms:.1f}x); "
            f"max_abs_err per input {['%.3g' % e for e in errs]} tol "
            f"{['%.3g' % t for t in tols]}")
        for e, t, r in zip(errs, tols, ref):
            require(e <= t, f"backward {kernel} {shape} {case['dtype']}: "
                    f"max_abs_err {e} > tol {t}")
            require(bool(torch.isfinite(r).all()), f"backward {kernel}: non-finite")

    b = BENCH_BATCH
    for dtype in (torch.float32, torch.bfloat16):
        for shape, (rows, d) in {"vit": (b * 50, 768), "text": (6 * b * 16, 512)}.items():
            w = (1 + 0.2 * randn(d)).requires_grad_()
            bias = (0.2 * randn(d)).requires_grad_()
            x = (2 * randn(rows, d) + 0.5).to(dtype).requires_grad_()
            gy = randn(rows, d, dtype=dtype)
            held("layernorm", shape, dtype, (x, w, bias), (gy,),
                 lambda x_, w_, b_: ops.layernorm(x_, w_, b_),
                 lambda x_, w_, b_: ops.layernorm_plain(x_, w_, b_),
                 lambda x_, w_, b_, g_: ops.layernorm_backward(x_, w_, g_),
                 lambda x_, w_, b_: ops.layernorm(x_, w_, b_), f"rows={rows} d={d}")
            a = (2 * randn(rows, d) + 0.5).to(dtype).requires_grad_()
            gs = randn(rows, d, dtype=dtype)
            held("add_layernorm", shape, dtype, (a, x, w, bias), (gs, gy),
                 lambda a_, b_, w_, bi_: ops.add_layernorm(a_, b_, w_, bi_),
                 lambda a_, b_, w_, bi_: ops.add_layernorm_plain(a_, b_, w_, bi_),
                 lambda a_, b_, w_, bi_, gs_, gy_: ops.add_layernorm_backward(
                     a_, b_, w_, gs_, gy_),
                 lambda a_, b_, w_, bi_: ops.add_layernorm(a_, b_, w_, bi_),
                 f"rows={rows} d={d}, cotangents of s and y")
        for shape, (bsz, l, e, h, causal) in {
                "vit": (b, 50, 768, 12, False), "text": (6 * b, 16, 512, 8, True),
                "cam": (b, 6, 512, 8, False)}.items():
            qkv = randn(bsz, l, 3 * e, dtype=dtype).requires_grad_()
            go = randn(bsz, l, e, dtype=dtype)
            dh = e // h
            held("fused_mha", shape, dtype, (qkv,), (go,),
                 lambda t: ops.fused_mha(*t.chunk(3, -1), h, causal),
                 lambda t: ops.fused_mha_plain(*t.chunk(3, -1), h, causal),
                 lambda t, g_: ops.mha_backward(*t.chunk(3, -1), g_, h, causal, dh**-0.5),
                 lambda t: ops.fused_mha(*t.chunk(3, -1), h, causal),
                 f"B={bsz} L={l} E={e} H={h} causal={causal}, q/k/v views of one qkv")
        seqs, t, e, h = 50 * 49, NFRAMES, 768, 12
        dh = e // h

        def heads(buf):
            return [x.unflatten(-1, (h, dh)).transpose(1, 2) for x in buf.chunk(3, -1)]

        buf = randn(seqs, t, 3 * e, dtype=dtype).requires_grad_()
        go = randn(seqs, h, t, dh, dtype=dtype)
        held("fused_attention", "temporal", dtype, (buf,), (go,),
             lambda x: ops.fused_attention(*heads(x)),
             lambda x: ops.fused_attention_plain(*heads(x)),
             lambda x, g_: ops.attention_backward(*heads(x), None, g_, dh**-0.5),
             lambda x: ops.fused_attention(*heads(x)),
             f"B·H={seqs}·{h} L={t} D={dh} strided head views, no mask")
        seeded = randn(16, 16).masked_fill(
            torch.rand(16, 16, device=dev, generator=g) < 0.3, float("-inf")
        ).fill_diagonal_(0.0)
        for shape, mask in (("causal", ops.causal_mask(16, dev)), ("additive", seeded)):
            q, k, v = (randn(960 * 8, 16, dh, dtype=dtype).requires_grad_()
                       for _ in range(3))
            go = randn(960 * 8, 16, dh, dtype=dtype)
            held("fused_attention", shape, dtype, (q, k, v), (go,),
                 lambda q_, k_, v_: ops.fused_attention(q_, k_, v_, mask),
                 lambda q_, k_, v_: ops.fused_attention_plain(q_, k_, v_, mask),
                 lambda q_, k_, v_, g_: ops.attention_backward(q_, k_, v_, mask, g_,
                                                               dh**-0.5),
                 lambda q_, k_, v_: ops.fused_attention(q_, k_, v_, mask),
                 f"B·H={960 * 8} L=16 D={dh} {shape} mask")
        torch.cuda.empty_cache()
    return out


def model_from_config(config: str, **kwargs):
    """A model from the ``arch`` block of one of the repo's configs, with
    its CAM moved off its zero-init (``perturb``)."""
    from vtc_tpu_torch.models import create_model
    from vtc_tpu_torch.utils import jsonc

    arch = jsonc.read_json(Path(__file__).resolve().parent / config)["arch"]
    return perturb(create_model(arch["type"], seed=0, **arch["args"], **kwargs))


def config_optimizer(model, config: str):
    from vtc_tpu_torch.training import build_optimizer
    from vtc_tpu_torch.utils import jsonc

    cfg = jsonc.read_json(Path(__file__).resolve().parent / config)
    return build_optimizer(
        model, cfg["optimizer"], cfg.get("lr_scheduler"), steps_per_epoch=100,
        fc_lr=cfg.get("fc_lr"), time_lr=cfg.get("time_lr"),
        adapter_lr=cfg.get("adapter_lr"),
    )


def run_train_parity(ops) -> dict:
    """Phase 11. Returns the launch counts of the card's three steps."""
    from vtc_tpu_torch.models.cam import draw_adapter_skip
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.training import train_step

    tic = time.perf_counter()
    inputs = bench_inputs(PARITY_BATCH, 32, seed=6)
    gen = torch.Generator().manual_seed(6)
    draws = [{"adapter_skip": draw_adapter_skip(PARITY_BATCH, gen)}
             for _ in range(PARITY_STEPS)]
    runs = {}
    for dev in ("cuda", "cpu"):
        model = model_from_config(TRAIN_CONFIG, **({} if dev == "cuda" else
                                                   {"device": "cpu"}))
        require(model.random_skip_adapter, "the config's random_skip_adapter is off")
        optimizer, scheduler = config_optimizer(model, TRAIN_CONFIG)
        before = {n: p.detach().cpu().clone() for n, p in model.named_parameters()}
        grads = {}

        def keep_first_grads(opt, args, kwargs, model=model, grads=grads):
            if not grads:
                grads.update({n: None if p.grad is None else p.grad.detach().cpu()
                              for n, p in model.named_parameters()})

        hook = optimizer.register_step_pre_hook(keep_first_grads)
        data = [x.to(dev) for x in inputs]
        # the train path's run: counts from 0 just before, read just after
        ops.reset_launch_counts()
        losses = [train_step(model, clip_loss, optimizer, scheduler, data, {},
                             draws=draws[k])[0].item() for k in range(PARITY_STEPS)]
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        hook.remove()
        lr = {n: g["initial_lr"] for g in optimizer.param_groups
              for n, p in model.named_parameters() if any(p is q for q in g["params"])}
        runs[dev] = dict(losses=losses, grads=grads, before=before, lr=lr, params={
            n: p.detach().cpu() for n, p in model.named_parameters()})
        del model, optimizer
        torch.cuda.empty_cache()
    log(f"train parity: built and stepped in {time.perf_counter() - tic:.1f} s; "
        f"adapter skip draws per step {[int(d['adapter_skip'].sum()) for d in draws]} "
        f"of {PARITY_BATCH}")
    card, cpu = runs["cuda"], runs["cpu"]
    for k, (a, c) in enumerate(zip(card["losses"], cpu["losses"])):
        log(f"train parity step {k + 1}: loss card {a:.7f} CPU {c:.7f} "
            f"(|diff| {abs(a - c):.3g}, atol {LOSS_ATOL:g})")
        require(math.isfinite(a) and abs(a - c) <= LOSS_ATOL,
                f"train step {k + 1} loss {a} vs CPU {c}")
    worst, n_grads = (0.0, ""), 0
    for name, ref in cpu["grads"].items():
        ours = card["grads"][name]
        if ref is None or ours is None:
            require(ref is None and ours is None, f"{name}: a gradient on one device only")
            continue
        n_grads += 1
        scale = ref.abs().max().item()
        err = (ours - ref).abs().max().item()
        require(err <= GRAD_RTOL * scale if scale > 0 else err == 0.0,
                f"{name}: gradient differs from the CPU's by {err} (largest {scale})")
        worst = max(worst, (err / scale if scale else 0.0, name))
    log(f"train parity: {n_grads} parameter gradients after step 1 agree; worst "
        f"max|diff| / max|grad| {worst[0]:.3g} at {worst[1]} (limit {GRAD_RTOL:g})")
    require(card["grads"]["final_linear.weight"] is None,
            "final_linear (unused with init_from_avg) took a gradient")
    worst, far, moved, n_moved = (0.0, ""), 0, 0, 0
    for name, p in card["params"].items():
        lr = card["lr"][name]
        d = (p - cpu["params"][name]).abs() / lr
        step = (cpu["params"][name] - cpu["before"][name]).abs() / lr
        require(d.max().item() <= 2 * PARITY_STEPS, f"{name}: {d.max().item()} lr "
                f"from the CPU's after {PARITY_STEPS} steps")
        worst = max(worst, (d.max().item(), name))
        far += int((d[step > 0] > PARAM_ATOL_LR).sum())
        moved += int((step >= MOVED_MIN_LR).sum())
        n_moved += int((step > 0).sum())
    require(not (card["params"]["final_linear.weight"]
                 - card["before"]["final_linear.weight"]).any(),
            "final_linear moved without a gradient")
    require(n_moved > 0, "no parameter moved on the CPU")
    log(f"train parity: after {PARITY_STEPS} steps {n_moved} parameter entries "
        f"moved on the CPU, {moved / n_moved:.4f} of them by >= {MOVED_MIN_LR} lr "
        f"(need > 0.5); {far / n_moved:.3g} lie farther than {PARAM_ATOL_LR:g} lr "
        f"from the CPU's (limit {PARAM_FAR_SHARE:g}); the largest {worst[0]:.3g} lr "
        f"at {worst[1]} (limit {2 * PARITY_STEPS}); final_linear (no gradient) "
        f"unchanged")
    require(moved > n_moved / 2,
            f"the optimizer moved the median entry by less than {MOVED_MIN_LR} lr")
    require(far <= PARAM_FAR_SHARE * n_moved,
            f"{far / n_moved:.3g} of the entries lie farther than {PARAM_ATOL_LR:g} lr "
            f"from the CPU's")
    del runs, card, cpu

    # the frozen config: freeze "all" trains the CAM alone
    model = model_from_config(FROZEN_CONFIG)
    optimizer, scheduler = config_optimizer(model, FROZEN_CONFIG)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    train_step(model, clip_loss, optimizer, scheduler,
               [x.cuda() for x in inputs], {}, draws=draws[0])
    towers = [n for n in before if n.startswith("model.")]
    for n, p in model.named_parameters():
        require(p.grad is None, f"{n}: a gradient left after the step")
        if n.startswith("model."):
            require(not p.requires_grad and torch.equal(p, before[n]),
                    f"frozen {n} moved or takes a gradient")
    cam_moved = [n for n, p in model.named_parameters()
                 if not n.startswith("model.") and not torch.equal(p, before[n])]
    require(len(cam_moved) > 0, "the frozen config's CAM did not train")
    log(f"train parity, {FROZEN_CONFIG}: {len(towers)} tower parameters frozen "
        f"and unchanged bit for bit, {len(cam_moved)} CAM parameters moved")
    del model, optimizer
    torch.cuda.empty_cache()
    return launches


def profile_train_phases(model, optimizer, scheduler, data, generator, n: int) -> dict:
    """``n`` train steps (``train_step``'s calls) with a synchronize after
    each phase, under ``torch.profiler``: each device kernel is charged to
    the phase in whose host window it starts. -> {"family_ms", "phase_ms",
    "backward_top"} per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from vtc_tpu_torch.ops.losses import clip_loss

    model.train()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function("phase:forward"):
                loss = clip_loss(model(*data, generator=generator), {})
                torch.cuda.synchronize()
            with record_function("phase:backward"):
                loss.backward()
                torch.cuda.synchronize()
            with record_function("phase:optimizer"):
                optimizer.step()
                scheduler.step()
                optimizer.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
    events = prof.events()
    windows = [(e.name.split(":", 1)[1], e.time_range.start, e.time_range.end)
               for e in events
               if e.name.startswith("phase:") and e.device_type == DeviceType.CPU]
    require(len(windows) == 3 * n, f"profiler phase windows: {len(windows)}")
    family_ms, phase_ms, backward_top = {}, {}, {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        phase = next((p for p, t0, t1 in windows if t0 <= e.time_range.start <= t1),
                     "unplaced")
        ms = (e.time_range.end - e.time_range.start) / 1e3 / n
        name = next((f for f, keys in KERNEL_FAMILIES if any(k in e.name for k in keys)),
                    "other")
        if name in PORT_KERNELS:
            family = "forward kernels (the port's)"
        elif name == "gemm":
            family = f"GEMMs ({phase})"
        else:
            family = {"backward": "backward ops (non-GEMM)",
                      "optimizer": "optimizer"}.get(phase, f"elementwise ({phase})")
            if phase == "backward":
                backward_top[e.name] = backward_top.get(e.name, 0.0) + ms
        family_ms[family] = family_ms.get(family, 0.0) + ms
        phase_ms[phase] = phase_ms.get(phase, 0.0) + ms
    require(sum(phase_ms.values()) > 0, "the profiler recorded no device events")
    # the kernels' backwards: the device time of the kernels launched inside
    # each ``<kernel>.backward`` range (the profiler links a kernel to the op
    # that launched it), and the calls per step
    kernel_bwd = {}
    for e in events:
        kernel = e.name[: -len(".backward")]
        if e.device_type == DeviceType.CPU and e.name.endswith(".backward") and (
                kernel in PORT_KERNELS):
            ms, calls = kernel_bwd.get(kernel, (0.0, 0))
            us = getattr(e, "device_time_total", None)
            us = e.cuda_time_total if us is None else us
            kernel_bwd[kernel] = (ms + us / 1e3 / n, calls + 1 / n)
    return {"family_ms": family_ms, "phase_ms": phase_ms, "kernel_backward": kernel_bwd,
            "backward_top": sorted(backward_top.items(), key=lambda kv: -kv[1])[:8]}


def run_train_bench(ops, smi) -> dict:
    """Phase 12. Returns the launch counts of one train step."""
    from vtc_tpu_torch.ops.losses import clip_loss
    from vtc_tpu_torch.scripts import bench_train_step
    from vtc_tpu_torch.training import train_step

    torch.cuda.reset_peak_memory_stats()
    res = bench_train_step.main()  # batch 128, 3 windows of 8 steps after 3
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    log(f"train throughput bf16: {res['samples_per_s']:.1f} samples/s, windows "
        f"{['%.1f' % r for r in res['window_rates']]}; peak memory allocated "
        f"{peak / 2**30:.3f} GiB (reserved {torch.cuda.max_memory_reserved() / 2**30:.3f} "
        f"GiB); on {smi}")
    log(f"train losses over {len(losses)} steps on one batch: "
        f"{['%.4f' % x for x in losses]}")
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    require(all(math.isfinite(x) for x in losses), "a non-finite train loss")
    require(len(losses) >= 20 and last < first,
            f"the loss did not fall: mean of the first 5 {first}, last 5 {last}")
    model, optimizer, scheduler, data = res["setup"]
    generator = torch.Generator(device="cuda").manual_seed(1)
    # the train benchmark's path: counts from 0 just before one step, read after
    ops.reset_launch_counts()
    train_step(model, clip_loss, optimizer, scheduler, data, {}, generator)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"kernel use (one bf16 train step): {json.dumps(launches)}")
    require(launches == EXPECTED_LAUNCHES,
            f"train step launches {launches} != {EXPECTED_LAUNCHES}")
    prof = profile_calls(lambda: train_step(model, clip_loss, optimizer, scheduler,
                                            data, {}, generator), PROFILED)
    log(f"profile train bf16, {PROFILED} steps: window "
        f"{prof['window_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, idle "
        f"share {prof['idle_share']:.4f}, {prof['launches']:.0f} device events per step, "
        f"device ms per step {sum(prof['family_ms'].values()):.4f}")
    phases = profile_train_phases(model, optimizer, scheduler, data, generator, PROFILED)
    total = sum(phases["phase_ms"].values())
    for phase, ms in sorted(phases["phase_ms"].items(), key=lambda kv: -kv[1]):
        log(f"profile train device ms per step by phase: {phase} {ms:.4f} "
            f"({ms / total:.4f} of device time)")
    for family, ms in sorted(phases["family_ms"].items(), key=lambda kv: -kv[1]):
        log(f"profile train device ms per step by family: {family} {ms:.4f} "
            f"({ms / total:.4f})")
    for kernel, (ms, calls) in sorted(phases["kernel_backward"].items()):
        log(f"profile train backward of {kernel}: {calls:.0f} calls per step, device "
            f"ms per step {ms:.4f} ({ms / total:.4f} of device time)")
    for kname, ms in phases["backward_top"]:
        log(f"profile train backward op: {ms:.4f} ms per step: {kname[:120]}")
    del res, model, optimizer
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    from vtc_tpu_torch import ops
    from vtc_tpu_torch.models import convert_weights
    from vtc_tpu_torch.ops import _build
    from vtc_tpu_torch.serving import ClipRetrievalService, RetrievalIndex

    # 1. device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {card} "
        f"count {torch.cuda.device_count()}")

    # 2. build
    tic = time.perf_counter()
    libs = _build.build_all()
    nvcc_s = time.perf_counter() - tic
    for stem, path in libs.items():
        ptxas = path.with_suffix(".so.log").read_text() if path.with_suffix(
            ".so.log").exists() else ""
        entry = stem
        for line in ptxas.splitlines():
            if "Compiling entry function" in line:
                entry = kernel_instance(line)
            elif "registers" in line or "spill" in line:
                log(f"ptxas {entry}: {line.split(':', 1)[-1].strip()}")
    tic = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for d in (512, 768):
            x = torch.randn(32, d, device="cuda").to(dtype)
            w, b = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
            ops.layernorm(x, w, b)
            ops.add_layernorm(x, x, w, b)
    torch.cuda.synchronize()
    log(f"build: nvcc {nvcc_s:.1f} s ({', '.join(libs)}), triton first "
        f"compiles (layernorm, add_layernorm) {time.perf_counter() - tic:.1f} s")

    # 3. kernels
    results = check_kernels(ops)

    # 4. flagship forward, fp32, card vs CPU
    tic = time.perf_counter()
    model = flagship()
    cpu_model = flagship(device="cpu")
    log(f"models built in {time.perf_counter() - tic:.1f} s")
    inputs = bench_inputs(FWD_BATCH, 32)
    with torch.inference_mode():
        model(*[t.cuda() for t in inputs])  # warm up
        torch.cuda.synchronize()
        # 5. the main path's run: counts from 0 just before, read just after
        ops.reset_launch_counts()
        fv, ft, sim = model(*[t.cuda() for t in inputs])
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        fv_c, ft_c, sim_c = cpu_model(*inputs)
    log(f"kernel use (flagship forward): {json.dumps(launches)}")
    require(launches == EXPECTED_LAUNCHES,
            f"launches {launches} != expected {EXPECTED_LAUNCHES}")
    compare_with_cpu("flagship", (fv, ft, sim), (fv_c, ft_c, sim_c),
                     cpu_model.model.logit_scale.exp().item())

    # 6. serving
    rng = np.random.default_rng(1)
    extra = rng.normal(size=(10_000, 512)).astype(np.float32)
    extra_ids = np.arange(100_000, 110_000)
    vis, title = inputs[0], inputs[1]
    queries = [("text", 0, 3), ("text", 3, 8), ("image", 0, 3), ("image", 3, 10)]
    answers = {}
    for dev, m, feats in (("cuda", model, fv), ("cpu", cpu_model, fv_c)):
        device = None if dev == "cuda" else "cpu"  # None: the card
        index = RetrievalIndex(512, device=device)
        index.add(feats.float().cpu().numpy(), np.arange(FWD_BATCH))
        index.add(extra, extra_ids)
        svc = ClipRetrievalService(m, index, device=device)
        ops.reset_launch_counts()
        answers[dev] = [
            svc.search_text(title[lo:hi], k=10) if kind == "text"
            else svc.search_image(vis[lo:hi], k=10)
            for kind, lo, hi in queries
        ]
        if dev == "cuda":
            torch.cuda.synchronize()
            serve_launches = ops.launch_counts()
    # per text batch 13 LN (12 ln_1 + ln_final), per image batch 14
    # (ln_pre + 12 ln_1 + ln_post); 12 add+LN and 12 attention per batch
    want = dict(EXPECTED_LAUNCHES, layernorm=2 * 13 + 2 * 14, add_layernorm=4 * 12,
                fused_mha=4 * 12)
    log(f"kernel use (serving, 2 text + 2 image batches): {json.dumps(serve_launches)}")
    require(serve_launches == want, f"serving launches {serve_launches} != {want}")
    for (kind, lo, hi), (ids, scores), (ids_c, scores_c) in zip(
        queries, answers["cuda"], answers["cpu"]
    ):
        require(np.array_equal(ids, ids_c), f"{kind} top-k ids differ from the CPU's")
        err = float(np.abs(scores - scores_c).max())
        log(f"serving {kind} batch {hi - lo}: top-10 ids equal the CPU's, "
            f"score max_abs_err {err:.3g}")
        require(err <= FEAT_ATOL, f"{kind} scores differ from the CPU's by {err}")
        if kind == "image":
            require(np.array_equal(ids[:, 0], np.arange(lo, hi)),
                    "an image query did not find its own gallery row first")

    # 7. bf16
    del cpu_model
    bf16 = convert_weights(flagship(dtype="bf16"))
    with torch.inference_mode():
        fv16, ft16, _ = bf16(*[t.cuda() for t in inputs])
        for name, a, b in (("feats_vis", fv16, fv), ("feats_text", ft16, ft)):
            cos = cosines(a, b).min().item()
            log(f"flagship bf16 {name}: min cosine vs fp32 {cos:.6f} (> {COS_MIN})")
            require(cos > COS_MIN, f"bf16 {name} cosine {cos} <= {COS_MIN}")
        big = [t.cuda() for t in bench_inputs(BENCH_BATCH, 32, seed=2)]
        throughput(f"bf16 batch {BENCH_BATCH} (16-token title + 5 comments)", bf16,
                   big, BENCH_BATCH, WARMUP, WINDOWS, PER_WINDOW, "pairs/s", smi)
        prof = profile_calls(lambda: bf16(*big), PROFILED)
    log_profile(prof, f"bf16 batch {BENCH_BATCH}")
    del model, bf16, big
    torch.cuda.empty_cache()

    # 8. video
    video_launches = run_video(ops, smi)
    torch.cuda.empty_cache()

    # 9. the LN sweep
    sweep_launches = run_ln_sweep(ops)

    # 10. each model kernel's backward
    check_backward(ops)

    # 11. train-step parity, card vs CPU, and the frozen config
    parity_launches = run_train_parity(ops)
    want = {k: PARITY_STEPS * v for k, v in EXPECTED_LAUNCHES.items()}
    log(f"kernel use ({PARITY_STEPS} fp32 train steps): {json.dumps(parity_launches)}")
    require(parity_launches == want, f"train launches {parity_launches} != {want}")

    # 12. train throughput
    run_train_bench(ops, smi)

    # 13. results: each kernel's launches from the path that runs it
    path_launches = dict(launches, fused_attention=video_launches["fused_attention"],
                         ln_mxu=sweep_launches["ln_mxu"],
                         ln_mxu_bf16=sweep_launches["ln_mxu_bf16"])
    kernels = []
    for name, (route, source, replaces) in SOURCES.items():
        head = results[name]["headline"]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": path_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in results[name]["cases"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
        })
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
