"""Decode a PNG on the host without PIL: ``decode_png(data)``.

The machine with the card has no PIL, and the server takes PNG queries
(``images_b64``). This decoder gives what ``PIL.Image.open(...).convert(
"RGB")`` gives, bit for bit, for the PNGs that it takes:

* colour types gray (bit depths 1, 2, 4 and 8: a sample scaled to 0-255 as
  PIL's ``1``, ``L;2`` and ``L;4`` unpackers do), gray + alpha, RGB and
  RGBA (8 bits) and palette (1, 2, 4 and 8 bits); alpha, and a ``tRNS``
  chunk, are dropped, as ``convert("RGB")`` drops them;
* chunks are read with their CRCs checked; the ``IDAT`` data is inflated by
  the standard library's ``zlib``; the five row filters are reversed by
  ``csrc/host/png_unfilter.cpp`` (``g++`` at first use, as the resampler):
  Average and Paeth depend on the byte just reversed, too slow a loop for
  numpy at 224-1024 pixels a side.

16-bit samples and Adam7 interlacing are refused with ``PngDecodeError``
(ROADMAP: Queue 3), as are a palette index past the palette, an image of
more pixels than PIL opens, and a malformed file.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from ..ops import _build
from .image_io import ImageInputError

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, the bit depths taken)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8)), 2: (3, (8,)), 3: (1, (1, 2, 4, 8)), 4: (2, (8,)),
                 6: (4, (8,))}
_U8P = ctypes.POINTER(ctypes.c_uint8)
# PIL refuses an image of more pixels as a decompression bomb (twice its
# Image.MAX_IMAGE_PIXELS); so does this decoder, before allocating it
MAX_PIXELS = 2 * 89_478_485


class PngDecodeError(ImageInputError):
    """A PNG that this decoder refuses (16-bit, interlaced) or that is
    malformed."""


def _lib():
    lib = _build.load_host_library("png_unfilter")
    if lib.vtc_png_unfilter.argtypes is None:
        lib.vtc_png_unfilter.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8P]
        lib.vtc_png_unfilter.restype = ctypes.c_int
    return lib


def _chunks(data: bytes):
    """(type, payload) of each chunk up to ``IEND``, CRCs checked."""
    i = len(SIGNATURE)
    while True:
        if i + 12 > len(data):
            raise PngDecodeError("truncated PNG: no IEND chunk")
        length, = struct.unpack(">I", data[i : i + 4])
        kind = data[i + 4 : i + 8]
        payload = data[i + 8 : i + 8 + length]
        crc = data[i + 8 + length : i + 12 + length]
        if len(payload) != length or len(crc) != 4:
            raise PngDecodeError(f"truncated PNG in a {kind!r} chunk")
        if zlib.crc32(kind + payload) != struct.unpack(">I", crc)[0]:
            raise PngDecodeError(f"broken PNG: bad CRC in a {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        i += 12 + length


def decode_png(data: bytes) -> np.ndarray:
    """uint8 ``[h, w, 3]`` RGB of the PNG bytes ``data``, as
    ``Image.open(...).convert("RGB")`` gives it."""
    if data[:8] != SIGNATURE:
        raise PngDecodeError("not a PNG (no signature)")
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            if len(payload) != 13:
                raise PngDecodeError("malformed IHDR chunk")
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            if len(payload) % 3:
                raise PngDecodeError("malformed PLTE chunk")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise PngDecodeError("malformed PNG: no IHDR or no IDAT chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth == 16:
        raise PngDecodeError("a 16-bit PNG: 16-bit samples are not decoded (8 bits and "
                             "fewer are)")
    if interlace != 0:
        raise PngDecodeError("an Adam7-interlaced PNG: interlaced PNGs are not decoded")
    if colour not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[colour][1] or (
            compression, filtering) != (0, 0) or width == 0 or height == 0:
        raise PngDecodeError(f"malformed PNG header: {width}x{height}, bit depth {depth}, "
                             f"colour type {colour}")
    if width * height > MAX_PIXELS:
        raise PngDecodeError(f"a {width}x{height} PNG: over {MAX_PIXELS} pixels, a "
                             "decompression bomb")
    if colour == 3 and palette is None:
        raise PngDecodeError("a palette PNG without a PLTE chunk")
    channels = _COLOUR_TYPES[colour][0]
    stride = (width * channels * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngDecodeError(f"broken PNG: {e}") from e
    if len(raw) < height * (stride + 1):
        raise PngDecodeError(f"truncated PNG: {len(raw)} bytes of image data, "
                             f"{height * (stride + 1)} needed")
    raw = np.frombuffer(raw, np.uint8, count=height * (stride + 1))
    rows = np.empty((height, stride), np.uint8)
    rc = _lib().vtc_png_unfilter(raw.ctypes.data_as(_U8P), height, stride,
                                 max(1, channels * depth // 8), rows.ctypes.data_as(_U8P))
    if rc != 0:
        raise PngDecodeError(f"broken PNG: unknown filter type in row {-1 - rc}")
    if depth < 8:  # pack sub-byte samples, most significant bits first
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits * weights).sum(-1, dtype=np.uint8)[:, :width]
    else:
        samples = rows.reshape(height, width, channels)
    if colour == 3:
        index = samples if depth < 8 else samples[..., 0]
        if int(index.max()) >= len(palette):
            raise PngDecodeError(f"broken PNG: palette index {int(index.max())} past the "
                                 f"palette of {len(palette)} colours")
        return palette[index]
    if colour in (0, 4):
        gray = samples if depth < 8 else samples[..., 0]
        gray = gray * np.uint8(255 // ((1 << depth) - 1))
        return np.repeat(gray[..., None], 3, axis=-1)
    return np.ascontiguousarray(samples[..., :3])
