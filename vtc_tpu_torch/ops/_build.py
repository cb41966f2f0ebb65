"""Build and load the CUDA C++ kernels and the host libraries, and the
plumbing every wrapper shares.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
by ``nvcc`` into a shared library for ``sm_90a``, with the libraries it
links (``LINK_FLAGS``: nvJPEG for ``jpeg_decode.cu``), at first use, into
``vtc_tpu_torch/_build/`` (listed in ``.gitignore``). The kernel sources
are compiled in parallel; the data path's sources (``SEPARATE``) each on
their own, so a machine whose toolkit lacks nvJPEG still loads every
kernel. A library's file name carries a hash of its source, of
the shared headers ``csrc/*.cuh`` and of its flags, so an edited source or
header is rebuilt and a stale library is never loaded. The library is then
opened with ``ctypes``: no PyTorch headers, so a build takes seconds.

The host route: each ``csrc/host/*.cpp`` (PIL's resampler) is compiled by
``g++`` at first use into the same directory, named the same way, and
raises when the compiler fails.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
HOST_DIR = CSRC_DIR / "host"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
# libraries one source links, after its name on the command line
LINK_FLAGS = {"jpeg_decode": ["-lnvjpeg"]}
# sources that are not kernels of the models, built only when loaded
SEPARATE = {"jpeg_decode"}
# no -march: PIL's build does not contract the resampler's double-precision
# coefficient tables into FMAs, and neither may this one
HOST_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]
HOST_LINK_FLAGS = ["-lpthread"]

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


def _lib_path(src: Path, csrc_dir: Path = CSRC_DIR, flags=None) -> Path:
    """The library of ``src``, named by a hash of the source, every header
    of ``csrc_dir`` (``*.cuh``, which the sources include) and the flags
    (by default ``src``'s nvcc flags and link list)."""
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc_dir.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    if flags is None:
        flags = [*NVCC_FLAGS, *LINK_FLAGS.get(src.stem, [])]
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build_all(stems: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the sources ``csrc/<stem>.cu`` (by default every kernel
    source: all but ``SEPARATE``) that have no current library, one ``nvcc``
    per source, all started together. Returns ``{stem: library path}``; the
    compiler's output (``-Xptxas=-v``: registers, shared memory, spills) is
    kept beside each library as ``<lib>.log``."""
    if stems is None:
        sources = [s for s in sorted(CSRC_DIR.glob("*.cu")) if s.stem not in SEPARATE]
    else:
        sources = [CSRC_DIR / f"{stem}.cu" for stem in stems]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out: Dict[str, Path] = {}
    procs = []
    for src in sources:
        lib = _lib_path(src)
        out[src.stem] = lib
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        log = open(lib.with_suffix(".so.log"), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        if src.stem in LINK_FLAGS:
            # the toolkit's libraries are found at load time by their path
            lib64 = Path(nvcc_path()).resolve().parent.parent / "lib64"
            cmd += [*LINK_FLAGS[src.stem], "-Xlinker", f"-rpath={lib64}"]
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
    """The ``ctypes`` handle of ``csrc/<stem>.cu``, built on first use: with
    every kernel source, or alone where it is one of ``SEPARATE``."""
    with _lock:
        if stem not in _libs:
            stems = [stem] if stem in SEPARATE else None
            _libs[stem] = ctypes.CDLL(str(build_all(stems)[stem]))
        return _libs[stem]


def build_host(stem: str) -> Path:
    """Compile ``csrc/host/<stem>.cpp`` with ``g++`` unless its library is
    current; raises when the compiler is missing or fails (there is no other
    route to fall back to)."""
    src = HOST_DIR / f"{stem}.cpp"
    lib = _lib_path(src, HOST_DIR, HOST_FLAGS + HOST_LINK_FLAGS)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: {src.name} is compiled at first use")
    tmp = lib.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run([gxx, *HOST_FLAGS, "-o", str(tmp), str(src), *HOST_LINK_FLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {src.name} (rc {proc.returncode}): "
                           f"{proc.stderr[-2000:]}")
    os.replace(tmp, lib)
    return lib


def load_host_library(stem: str) -> ctypes.CDLL:
    """The ``ctypes`` handle of ``csrc/host/<stem>.cpp``, built on first
    use."""
    key = f"host/{stem}"
    with _lock:
        if key not in _libs:
            _libs[key] = ctypes.CDLL(str(build_host(stem)))
        return _libs[key]


def check_launch(err: int, name: str) -> None:
    """A C entry returns ``cudaGetLastError()``; a refused launch (too many
    threads, too much shared memory) never runs and ``synchronize()`` would
    not report it, so raise here."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions and the backwards compute in: fp32 for
    fp32 and bf16 tensors, as the TPU kernels do, and fp64 for fp64 tensors,
    so that ``torch.autograd.gradcheck`` can hold a backward in fp64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def needs_grad(*tensors) -> bool:
    """Whether a call must go on the autograd tape: only then does a
    wrapper pay for its ``torch.autograd.Function``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    )


class _ForwardOnly(torch.autograd.Function):
    """Runs a kernel launch and refuses a backward pass through it. The LN
    sweep's designs (``ln_mxu``, ``ln_mxu_bf16``) measure a forward and take
    no gradient; a gradient must not be recomputed silently through another
    path."""

    @staticmethod
    def forward(ctx, name: str, launch: Callable, *tensors):
        ctx.name = name
        return launch(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.name} has no backward: it is a design of the LN sweep, "
            f"which measures forwards only; the model path's LayerNorm is "
            f"ops.layernorm"
        )


def forward_only(name: str, launch: Callable, *tensors):
    """``launch(*tensors)``, recorded on the autograd tape only when a
    gradient is wanted, so inference pays nothing for the guard."""
    if needs_grad(*tensors):
        return _ForwardOnly.apply(name, launch, *tensors)
    return launch(*tensors)
