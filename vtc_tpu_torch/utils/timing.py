"""Device time of one kernel call on the card, L2-cold (``time_ms``:
``chip_smoke.py``, ``scripts/bench_ln_kernel.py``; it needs a card), and of
a whole call in windows (``windows_ms``: the benchmark and profile twins).
"""

from __future__ import annotations

import math
import statistics
import time

import torch

L2_BYTES = 50e6  # the H100's L2 cache


def n_sets(bytes_per_call: int) -> int:
    """How many input sets, cycled through, make the calls' inputs together
    about four times the L2 cache (2 to 32 sets)."""
    return int(min(32, max(2, math.ceil(4 * L2_BYTES / bytes_per_call))))


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


def windows_ms(fn, device, iters: int, warmup: int = 3, windows: int = 3) -> list:
    """Milliseconds of one ``fn()`` in each of ``windows`` windows of
    ``iters`` calls, after ``warmup``. On the card a window is timed by CUDA
    events around its calls; on a CPU device (the tests) by the host clock."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(windows):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            tic = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - tic) * 1e3 / iters)
    return times
