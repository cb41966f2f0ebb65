"""A ``torch.profiler`` trace of the flagship's eval forward: the twin of
``scripts/profile_trace.py``.

    python -m vtc_tpu_torch.scripts.profile_trace [batch] [ntoks]

``PretrainedCLIP_finaltf`` at ViT-B/32, bf16 (``convert_weights``), seed 0,
the JAX script's inputs: CLIP-normalized NCHW images in bf16, or with
``VTC_PROFILE_PATCHES=1`` the uint8 patch input
(``data.extract_patches``), and a title and 5 comments of ``ntoks`` tokens
(``synthetic_tokens``, 14 real). After 2 warm-up forwards, ``iters``
forwards run under the profiler, and it prints the top kernels by self
device time, the device time per kernel family (the port's kernels, GEMMs,
the rest) and the device's idle share over the window from the first launch
to the synchronize after the last forward.

``profile_calls`` and ``log_profile`` are the profile that ``chip_smoke.py``
prints in its phases 7, 8 and 27, and ``KERNEL_FAMILIES`` the families that
its phase 12 charges. On the CPU (``device="cpu"``: the tests) the events
are the CPU's operators, their self times standing in for device time.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

KERNEL_FAMILIES = (  # device-kernel name fragments, matched in this order
    ("add_layernorm", ("_addln_kernel",)),
    ("layernorm", ("_ln_kernel",)),
    ("fused_mha_long", ("fused_mha_long_kernel", "fused_mha_long_onepass_kernel")),
    ("fused_mha", ("fused_mha_kernel",)),
    ("fused_attention", ("fused_attention_kernel",)),
    ("gemm", ("gemm", "Gemm", "gemv", "nvjet", "cutlass", "xmma")),
)
ITERS = 8  # forwards under the profiler, as the JAX script's fori_loop
TOP = 15


def family(name: str) -> str:
    """The kernel family of a device event's name, or "other"."""
    return next((f for f, keys in KERNEL_FAMILIES if any(k in name for k in keys)), "other")


def profile_calls(fn, n: int, device=None) -> dict:
    """``n`` calls of ``fn`` (forwards, train steps) under ``torch.profiler``:
    device time per kernel family (the port's kernels, GEMMs, the rest),
    each kernel's, and the device's idle share, 1 - (union of device
    intervals) / (the host's window from the first launch to the synchronize
    after the last call). On the CPU the CPU's operators stand in for the
    device's kernels, charged their self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device is None or torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function("forwards"):
            for _ in range(n):
                fn()
            if cuda:
                torch.cuda.synchronize()
    events = prof.events()
    window = next(e for e in events
                  if e.name == "forwards" and e.device_type == DeviceType.CPU)
    t0, t1 = window.time_range.start, window.time_range.end
    if cuda:
        timed = [(e.name, e.time_range.start, e.time_range.end,
                  e.time_range.end - e.time_range.start)
                 for e in events if e.device_type == DeviceType.CUDA
                 and not e.is_user_annotation]
    else:
        timed = [(e.name, e.time_range.start, e.time_range.end, e.self_cpu_time_total)
                 for e in events if e.device_type == DeviceType.CPU
                 and not e.is_user_annotation and e.name != "forwards"]
    if not timed:
        raise RuntimeError("the profiler recorded no device events")
    by_family, by_kernel, other = {}, {}, {}
    busy, end = 0.0, t0
    for name, start, stop, us in sorted(timed, key=lambda e: e[1]):
        if cuda:
            start, stop = max(start, end), min(stop, t1)
            if stop > start:
                busy += stop - start
                end = stop
        else:
            busy += us
        f = family(name)
        by_family[f] = by_family.get(f, 0.0) + us
        by_kernel[name] = by_kernel.get(name, 0.0) + us
        if f == "other":
            other[name] = other.get(name, 0.0) + us
    busy = min(busy, t1 - t0)
    return {"window_ms": (t1 - t0) / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / (t1 - t0),
            "family_ms": {f: us / 1e3 / n for f, us in by_family.items()},
            "kernel_ms": {k: us / 1e3 / n for k, us in
                          sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]},
            "other_top": sorted(other.items(), key=lambda kv: -kv[1])[:6],
            "launches": len(timed) / n}


def log_profile(prof: dict, what: str, n: int, log=print) -> None:
    """The profile's lines: the window, busy time and idle share, the
    device time of each family and the top "other" kernels, per call."""
    log(f"profile {what}, {n} forwards under torch.profiler: window "
        f"{prof['window_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, idle "
        f"share {prof['idle_share']:.4f}, {prof['launches']:.0f} device events "
        f"per forward")
    total = sum(prof["family_ms"].values())
    for name, ms in sorted(prof["family_ms"].items(), key=lambda kv: -kv[1]):
        log(f"profile device ms per forward: {name} {ms:.4f} "
            f"({ms / total:.4f} of device time)")
    for kname, us in prof["other_top"]:
        log(f"profile other: {us / 1e3 / n:.4f} ms per forward: {kname[:120]}")


def main(batch: int = 160, ntoks: int = 16, iters: int = ITERS,
         model_type: str = "ViT-B/32", device=None, log=print) -> dict:
    """Trace ``iters`` bf16 eval forwards and print the top kernels, the
    families and the idle share; -> ``profile_calls``' dict."""
    from ..data import extract_patches, synthetic_tokens
    from ..device import resolve_device
    from ..models import convert_weights, create_model

    device = resolve_device(device)
    model = convert_weights(create_model("PretrainedCLIP_finaltf", model_type=model_type,
                                         seed=0, dtype="bf16", device=device).eval())
    v = model.variant
    rng = np.random.default_rng(0)
    res = v.input_resolution
    if os.environ.get("VTC_PROFILE_PATCHES") == "1":  # the uint8 patch input
        u8 = rng.integers(0, 256, (batch, res, res, 3), dtype=np.uint8)
        vis = torch.from_numpy(extract_patches(u8, v.patch_size))
    else:
        vis = torch.from_numpy(rng.normal(size=(batch, 3, res, res)).astype(np.float32)
                               ).to(torch.bfloat16)
    title = torch.from_numpy(synthetic_tokens((batch,), ntoks, 14, rng))
    comments = torch.from_numpy(synthetic_tokens((batch, 5), ntoks, 14, rng))
    vis, title, comments = (t.to(device) for t in (vis, title, comments))
    with torch.inference_mode():
        for _ in range(2):
            model(vis, title, comments)
        if device.type == "cuda":
            torch.cuda.synchronize()
        prof = profile_calls(lambda: model(vis, title, comments), iters, device)
    log(f"top {len(prof['kernel_ms'])} kernels by self device time, ms per forward "
        f"(batch {batch}, {ntoks} tokens, {device}):")
    for name, ms in prof["kernel_ms"].items():
        log(f"{ms:10.4f}  [{family(name)}] {name[:110]}")
    log_profile(prof, f"bf16 batch {batch}", iters, log)
    return prof


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", nargs="?", type=int, default=160)
    ap.add_argument("ntoks", nargs="?", type=int, default=16)
    a = ap.parse_args()
    main(a.batch, a.ntoks)
