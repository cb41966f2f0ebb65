"""Build and load the CUDA C++ kernels, and the plumbing every wrapper shares.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
by ``nvcc`` into a shared library for ``sm_90a``; all sources are compiled
in parallel, at first use, into ``vtc_tpu_torch/_build/`` (listed in
``.gitignore``). A library's file name carries a hash of its source, so an
edited source is rebuilt and a stale library is never loaded. The library
is then opened with ``ctypes``: no PyTorch headers, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are compiled from csrc/ on the machine with the card"
        )
    return nvcc


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no current library, one ``nvcc``
    per source, all started together. Returns ``{stem: library path}``; the
    compiler's output (``-Xptxas=-v``: registers, shared memory, spills) is
    kept beside each library as ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Path] = {}
    procs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        lib = _lib_path(src)
        out[src.stem] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        log = open(lib.with_suffix(".so.log"), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, lib, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT
        )))
    failed = []
    for src, lib, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{src.name} (rc {rc}, see {log.name})")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed: " + ", ".join(failed))
    return out


def import_triton():
    """``(triton, triton.language)``, with Triton's compile cache in the build
    directory unless the caller chose one, so a run writes nothing outside
    the checkout. Only the launch functions call this: the CPU has no
    Triton."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    import triton
    import triton.language

    return triton, triton.language


def load_library(stem: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of ``csrc/<stem>.cu``, built on first use."""
    with _lock:
        if stem not in _libs:
            _libs[stem] = ctypes.CDLL(str(build_all()[stem]))
        return _libs[stem]


def check_launch(err: int, name: str) -> None:
    """A C entry returns ``cudaGetLastError()``; a refused launch (too many
    threads, too much shared memory) never runs and ``synchronize()`` would
    not report it, so raise here."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


class _ForwardOnly(torch.autograd.Function):
    """Runs a kernel launch and refuses a backward pass through it: the
    backward kernels come with the training slice, and until then a gradient
    must not be recomputed silently through another path."""

    @staticmethod
    def forward(ctx, name: str, launch: Callable, *tensors):
        ctx.name = name
        return launch(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.name} has no backward kernel yet (ROADMAP: training slice)"
        )


def forward_only(name: str, launch: Callable, *tensors):
    """``launch(*tensors)``, recorded on the autograd tape only when a
    gradient is wanted, so inference pays nothing for the guard."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _ForwardOnly.apply(name, launch, *tensors)
    return launch(*tensors)
