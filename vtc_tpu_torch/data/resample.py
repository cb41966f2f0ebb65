"""PIL's ``Image.resize`` on uint8 RGB arrays, bit for bit, without PIL.

The resampler is ``csrc/host/resample.cpp`` (the port's copy of
``native/vtc_preproc.cpp``'s), compiled with ``g++`` at first use
(``ops._build.build_host``) and called through ``ctypes``, which releases
the GIL: the loader's thread workers resize in parallel.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..ops import _build

FILTERS = {"bicubic": 0, "bilinear": 1}
_U8P = ctypes.POINTER(ctypes.c_uint8)


def _lib():
    lib = _build.load_host_library("resample")
    if lib.vtc_resize_batch.argtypes is None:
        lib.vtc_resize_batch.argtypes = [
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.vtc_resize_batch.restype = None
    return lib


def resize(images: np.ndarray, width: int, height: int, resample: str = "bicubic",
           num_threads: int = 1) -> np.ndarray:
    """uint8 ``[h, w, 3]`` or ``[n, h, w, 3]`` -> uint8 ``[height, width, 3]``
    (``[n, height, width, 3]``): ``Image.resize((width, height), BICUBIC or
    BILINEAR)`` of each image, on ``num_threads`` threads for a batch."""
    if images.dtype != np.uint8 or images.shape[-1] != 3 or images.ndim not in (3, 4):
        raise ValueError(f"resize takes uint8 [..., h, w, 3], got {images.dtype} "
                         f"{images.shape}")
    if width < 1 or height < 1:
        raise ValueError(f"resize to {width}x{height}")
    batch = np.ascontiguousarray(images if images.ndim == 4 else images[None])
    n, h, w, _ = batch.shape
    out = np.empty((n, height, width, 3), np.uint8)
    _lib().vtc_resize_batch(
        batch.ctypes.data_as(_U8P), n, h, w, out.ctypes.data_as(_U8P),
        height, width, FILTERS[resample], int(num_threads))
    return out if images.ndim == 4 else out[0]
