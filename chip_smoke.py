#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vtc_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives them;
2. build: compile the CUDA kernels from ``vtc_tpu_torch/csrc`` with nvcc
   (sm_90a) and the Triton kernels, and print the seconds;
3. kernels: each kernel against its plain PyTorch version on the card at the
   flagship's shapes (batch 160), fp32 and bf16, with times (CUDA-graph
   replays of launches over rotating inputs larger than the L2 cache, median
   of 5), the time of one PyTorch library call for the same function where
   there is one, and the least time the card could take (bytes over
   3.35 TB/s or operations over the type's peak, the larger); in bf16,
   ``fused_mha`` is held to one ulp of its typical output, a limit shown to
   catch a P left unrounded;
4. flagship: ``PretrainedCLIP_finaltf`` ViT-B/32 forward, fp32, batch 32,
   bench.py's inputs (uint8 patches, 16-token title and 5 comments, one
   empty), on the card against the same seeded weights on the CPU (plain
   versions); the CAM is moved off its zero-init by seeded noise so its
   attention and MLP branches count;
5. kernel use: the launch counters of that forward must read 29 layernorm,
   26 add_layernorm and 26 fused_mha launches;
6. serving: a RetrievalIndex of the card's image features plus 10^4 seeded
   rows answers ragged text and image batches; top-k ids equal the CPU's;
7. bf16: the flagship with ``convert_weights`` tracks fp32 (cosine > 0.995);
   its throughput at batch 160 (all the work of 20 windows over all their
   time, with the windows' spread) and a ``torch.profiler`` window of it
   (device time per kernel family, the device's idle share) are printed;
8. the kernels line (JSON) and, last, ``{"ok": true, "device": ...}``.

It needs one card, builds everything it runs, and exits non-zero, printing
no result, where CUDA is missing or the package is not beside it.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

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
WARMUP, WINDOWS, PER_WINDOW = 20, 20, 10  # bf16 throughput: forwards
PROFILED = 5  # bf16 forwards under torch.profiler
EXPECTED_LAUNCHES = {"layernorm": 29, "add_layernorm": 26, "fused_mha": 26}
KERNEL_FAMILIES = (  # device-kernel name fragments, matched in this order
    ("add_layernorm", ("_addln_kernel",)),
    ("layernorm", ("_ln_kernel",)),
    ("fused_mha", ("fused_mha_kernel",)),
    ("gemm", ("gemm", "Gemm", "gemv", "nvjet", "cutlass", "xmma")),
)
SOURCES = {
    "layernorm": ("triton", "vtc_tpu_torch/ops/layernorm.py",
                  "vtc_tpu/ops/pallas_layernorm.py:66"),
    "add_layernorm": ("triton", "vtc_tpu_torch/ops/addln.py",
                      "vtc_tpu/ops/pallas_addln.py:79"),
    "fused_mha": ("cuda", "vtc_tpu_torch/csrc/fused_mha.cu",
                  "vtc_tpu/ops/pallas_attention.py:288"),
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


def time_ms(fn, arg_sets, windows: int = 5) -> float:
    """Device time of one ``fn(*args)``: a CUDA graph of launches cycling
    through ``arg_sets`` (together larger than the L2 cache, so each launch
    reads from device memory), replayed ``windows`` times; the median."""
    for args in arg_sets[:2]:
        fn(*args)  # warm up: Triton compiles, allocator pools fill
    torch.cuda.synchronize()
    iters = len(arg_sets) * max(1, math.ceil(32 / len(arg_sets)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    del graph
    return statistics.median(times)


def n_sets(bytes_per_call: int) -> int:
    return int(min(32, max(2, math.ceil(200e6 / bytes_per_call))))


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---- phase 3: kernels against their plain versions -------------------------

def check_kernels(ops) -> dict:
    """-> {kernel: {"cases": [...], "headline": case}}; a case holds the
    error, its tolerance and the times. The headline case is the ViT shape
    in bf16, the largest launch of the bench configuration."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b = BENCH_BATCH
    ln_shapes = {"vit": (b * 50, 768), "text": (6 * b * 16, 512), "cam": (b * 6, 512)}
    mha_shapes = {"vit": (b, 50, 768, 12, False), "text": (6 * b, 16, 512, 8, True),
                  "cam": (b, 6, 512, 8, False)}
    out = {k: {"cases": []} for k in SOURCES}

    def record(kernel, shape_name, dtype, err, tol, ms, plain_ms, library_ms,
               bound_ms, bound_by, desc):
        case = dict(shape=shape_name, dtype=str(dtype).split(".")[-1],
                    max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by)
        out[kernel]["cases"].append(case)
        if shape_name == "vit" and dtype == torch.bfloat16:
            out[kernel]["headline"] = case
        lib = "n/a" if library_ms is None else f"{library_ms:.5f}"
        log(f"kernel {kernel} {shape_name} {case['dtype']} {desc}: "
            f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib} "
            f"bound_us={bound_ms * 1e3:.2f} ({bound_by}) "
            f"max_abs_err={err:.3g} tol={tol:.3g}")
        require(err <= tol, f"{kernel} {shape_name} {case['dtype']}: "
                f"max_abs_err {err} > tol {tol}")

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
                tol = bf16_ulp_at_median(ref)
                fault = (mha_p_unrounded(q, k, v, h, causal).float()
                         - ref.float()).abs().max().item()
                log(f"kernel fused_mha {name} bfloat16: P left unrounded would "
                    f"differ by {fault:.3g} (tol {tol:.3g})")
                require(fault > tol, f"fused_mha {name}: the bf16 tolerance "
                        f"{tol} cannot see P's rounding ({fault})")
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
    return out


# ---- phases 4-7: the port's main path ----------------------------------------

def bench_inputs(batch: int, patch: int, seed: int = 0):
    """bench.py's recipe: uint8 patches and synthetic 16-token texts, plus one
    empty comment (row 0, comment 4) so the mask embedding is on the path."""
    from vtc_tpu_torch.data import EOT_ID, SOT_ID, extract_patches, synthetic_tokens

    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)
    vis = extract_patches(u8, patch)
    title = synthetic_tokens((batch,), 16, 14, rng)
    comments = synthetic_tokens((batch, 5), 16, 14, rng)
    comments[0, 4] = 0
    comments[0, 4, :2] = (SOT_ID, EOT_ID)
    return [torch.from_numpy(a) for a in (vis, title, comments)]


def cosines(a, b):
    return (a.float().cpu() * b.float().cpu()).sum(-1)


@torch.no_grad()
def perturb_cam(model, seed: int = 0):
    """Move the CAM off its zero-init, identically on every device: seeded
    N(0, CAM_NOISE) noise on each ``final_transformer``/``final_linear``
    parameter, as the CPU tests' ``tiny`` fixture does. At zero-init the
    adapter's attention and MLP branches are multiplied by zero weights and
    the end-to-end checks could not see how the CAM calls its kernels."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.startswith(("final_transformer.", "final_linear.")):
            p.add_(CAM_NOISE * torch.randn(p.shape, generator=g).to(p.device))
    return model


def flagship(**kwargs):
    from vtc_tpu_torch.models import create_model

    return perturb_cam(create_model("PretrainedCLIP_finaltf",
                                    model_type="ViT-B/32", seed=0, **kwargs))


def profile_forward(model, inputs, n: int) -> dict:
    """``n`` forwards under ``torch.profiler``: device time per kernel family
    (the port's three kernels, GEMMs, the rest) and the device's idle share,
    1 - (union of device intervals) / (the host's window from the first
    launch to the synchronize after the last forward)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("forwards"):
            for _ in range(n):
                model(*inputs)
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
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {stem}: {line.strip()}")
    tic = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for d in (512, 768):
            x = torch.randn(8, d, device="cuda").to(dtype)
            w, b = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
            ops.layernorm(x, w, b)
            ops.add_layernorm(x, x, w, b)
    torch.cuda.synchronize()
    log(f"build: nvcc {nvcc_s:.1f} s ({', '.join(libs)}), triton first "
        f"compiles {time.perf_counter() - tic:.1f} s")

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
    scale = cpu_model.model.logit_scale.exp().item()
    for name, a, c, atol in (("feats_vis", fv, fv_c, FEAT_ATOL),
                             ("feats_text", ft, ft_c, FEAT_ATOL),
                             ("sim", sim, sim_c, scale * FEAT_ATOL)):
        require(a.shape == c.shape and bool(torch.isfinite(a).all()),
                f"{name}: shape {tuple(a.shape)} or non-finite values")
        err = (a.cpu() - c).abs().max().item()
        log(f"flagship fp32 {name} {tuple(a.shape)}: max_abs_err vs CPU "
            f"{err:.3g} (atol {atol:.3g})")
        require(err <= atol, f"flagship {name} differs from the CPU run by {err}")

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
    want = {"layernorm": 2 * 13 + 2 * 14, "add_layernorm": 4 * 12, "fused_mha": 4 * 12}
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
        for _ in range(WARMUP):
            bf16(*big)
        torch.cuda.synchronize()
        seconds = []
        for _ in range(WINDOWS):
            tic = time.perf_counter()
            for _ in range(PER_WINDOW):
                bf16(*big)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - tic)
        rates = sorted(BENCH_BATCH * PER_WINDOW / s for s in seconds)
        log(f"throughput bf16 batch {BENCH_BATCH} (16-token title + 5 comments): "
            f"{BENCH_BATCH * PER_WINDOW * WINDOWS / sum(seconds):.1f} pairs/s, all "
            f"{WINDOWS * PER_WINDOW} forwards over {sum(seconds):.4f} s after "
            f"{WARMUP} warm-up forwards; windows of {PER_WINDOW}: min "
            f"{rates[0]:.1f} median {statistics.median(rates):.1f} max "
            f"{rates[-1]:.1f} pairs/s; on {smi}")

        prof = profile_forward(bf16, big, PROFILED)
    log(f"profile bf16 batch {BENCH_BATCH}, {PROFILED} forwards under "
        f"torch.profiler: window {prof['window_ms']:.3f} ms, device busy "
        f"{prof['busy_ms']:.3f} ms, idle share {prof['idle_share']:.4f}, "
        f"{prof['launches']:.0f} device events per forward")
    total = sum(prof["family_ms"].values())
    for family, ms in sorted(prof["family_ms"].items(), key=lambda kv: -kv[1]):
        log(f"profile device ms per forward: {family} {ms:.4f} "
            f"({ms / total:.4f} of device time)")
    for kname, us in prof["other_top"]:
        log(f"profile other: {us / 1e3 / PROFILED:.4f} ms per forward: {kname[:120]}")

    # 8. results
    kernels = []
    for name, (route, source, replaces) in SOURCES.items():
        head = results[name]["headline"]
        kernels.append({
            "name": name, "route": route, "source": source, "replaces": replaces,
            "launches": launches[name],
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
