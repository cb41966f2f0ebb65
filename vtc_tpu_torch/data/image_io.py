"""Read an RGB image: ``read_rgb(path, device)``.

The JAX package opens its thumbnails with ``PIL.Image.open(path).convert(
"RGB")``. The port has two routes, and the device the caller names picks
one; nothing switches between them quietly:

* the card (``device`` None or CUDA): nvJPEG decodes the JPEG into a uint8
  ``[h, w, 3]`` tensor on the card (``csrc/jpeg_decode.cu``), which is
  copied to the host. A grayscale JPEG is decoded as its luma plane and
  repeated into three equal channels, as ``convert("RGB")`` does. What
  nvJPEG cannot match PIL on (CMYK and YCCK; an Adobe RGB JPEG without a
  colour transform) or fails to decode raises ``JpegDecodeError``, and no
  other decoder stands in;
* the CPU (``device="cpu"``): PIL, imported in the function, as the JAX
  package does.

nvJPEG's IDCT and chroma upsampling are not libjpeg-turbo's: its pixels
are a few levels from PIL's (the bound is ``chip_smoke.py``'s). Neither
route applies the EXIF orientation; ``Image.open`` does not either.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..ops import _build

NVJPEG_STATUS = {
    1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG", 4: "JPEG_NOT_SUPPORTED",
    5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED", 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
    9: "IMPLEMENTATION_NOT_SUPPORTED", 10: "INCOMPLETE_BITSTREAM",
}
_SOF_MARKERS = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}

_local = threading.local()  # each thread's decode stream


class JpegDecodeError(RuntimeError):
    """nvJPEG refused or failed to decode an image."""


def jpeg_header(data: bytes) -> dict:
    """What the markers before the first scan say: ``components``,
    ``subsampled`` (a component sampled otherwise than the first),
    ``progressive`` (a SOF2 frame) and ``adobe_transform`` (the APP14
    "Adobe" segment's colour transform, None without one)."""
    if data[:2] != b"\xff\xd8":
        raise JpegDecodeError("not a JPEG (no SOI marker)")
    info = {"components": None, "subsampled": False, "progressive": False,
            "adobe_transform": None}
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise JpegDecodeError(f"corrupt JPEG: no marker at byte {i}")
        marker = data[i + 1]
        if marker == 0xFF:  # fill byte
            i += 1
            continue
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        if marker in (0xD9, 0xDA):  # end of image, start of scan
            break
        length = int.from_bytes(data[i + 2 : i + 4], "big")
        seg = data[i + 4 : i + 2 + length]
        if marker in _SOF_MARKERS and len(seg) >= 6:
            info["components"] = seg[5]
            info["subsampled"] = len(set(seg[7 : 6 + 3 * seg[5] : 3])) > 1
            info["progressive"] = marker in (0xC2, 0xC6, 0xCA, 0xCE)
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            info["adobe_transform"] = seg[11]
        i += 2 + length
    if info["components"] is None:
        raise JpegDecodeError("corrupt JPEG: no frame header before the first scan")
    return info


def _lib():
    """The nvJPEG binding; a toolkit without nvJPEG, or a failed build or
    link, raises ``JpegDecodeError`` (the kernels are built apart and stay
    usable)."""
    try:
        lib = _build.load_library("jpeg_decode")
    except (RuntimeError, OSError) as e:
        raise JpegDecodeError(f"the nvJPEG binding csrc/jpeg_decode.cu could not be "
                              f"built or loaded: {e}") from e
    if lib.vtc_jpeg_decode.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vtc_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                      *[ctypes.POINTER(i)] * 2]
        lib.vtc_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, i, p,
                                        ctypes.c_size_t, p]
        lib.vtc_jpeg_info.restype = lib.vtc_jpeg_decode.restype = i
    return lib


def _check(rc: int, what: str, path) -> None:
    if rc == 0:
        return
    name = (f"cudaError {rc - 1000}" if rc >= 1000
            else f"NVJPEG_STATUS_{NVJPEG_STATUS.get(rc, rc)}")
    raise JpegDecodeError(f"{path}: nvJPEG {what} failed with {name}")


def decode_jpeg(data: bytes, device: Optional[torch.device] = None, path="<bytes>"
                ) -> torch.Tensor:
    """uint8 ``[h, w, 3]`` RGB on the card from the JPEG bytes ``data``.

    Each thread decodes on a stream of its own, on which the output is also
    allocated; the call returns when the decode has finished."""
    header = jpeg_header(data)
    if header["components"] not in (1, 3):
        raise JpegDecodeError(
            f"{path}: a {header['components']}-component JPEG (CMYK or YCCK): nvJPEG "
            "does not convert it as PIL does")
    if header["components"] == 3 and header["adobe_transform"] == 0:
        raise JpegDecodeError(
            f"{path}: an Adobe JPEG coded in RGB (no colour transform): nvJPEG would "
            "read it as YCbCr")
    lib = _lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(lib.vtc_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h)),
           "image info", path)
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    stream = getattr(_local, "stream", None)
    if stream is None or stream.device != device:
        stream = _local.stream = torch.cuda.Stream(device)
    luma = header["components"] == 1
    with torch.cuda.stream(stream):
        out = torch.empty((h.value, w.value) if luma else (h.value, w.value, 3),
                          dtype=torch.uint8, device=device)
        what = "progressive decode" if header["progressive"] else "decode"
        _check(lib.vtc_jpeg_decode(data, len(data), int(luma), out.data_ptr(),
                                   out.stride(0), stream.cuda_stream), what, path)
        return out[..., None].expand(-1, -1, 3).contiguous() if luma else out


def read_rgb(path, device=None) -> np.ndarray:
    """uint8 ``[h, w, 3]`` RGB of the image at ``path``, on the host: decoded
    by nvJPEG on the card (default; raises without one), or by PIL where
    ``device`` is the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        from PIL import Image

        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    with open(path, "rb") as f:
        data = f.read()
    img = decode_jpeg(data, device if device.index is not None else None, path)
    with torch.cuda.stream(_local.stream):
        return img.cpu().numpy()
