"""Decode a PNG on the host without PIL: ``decode_png(data)``.

The machine with the card has no PIL, and the server takes PNG queries
(``images_b64``). This decoder gives what ``PIL.Image.open(...).convert(
"RGB")`` gives, bit for bit, for the PNGs that it takes:

* colour types gray (bit depths 1, 2, 4 and 8: a sample scaled to 0-255 as
  PIL's ``1``, ``L;2`` and ``L;4`` unpackers do; 16: clamped to 0-255, as
  PIL's ``I;16`` -> ``RGB`` conversion does), gray + alpha, RGB and RGBA (8
  and 16 bits; of a 16-bit sample the high byte, as PIL's ``LA;16B``,
  ``RGB;16B`` and ``RGBA;16B`` unpackers keep it) and palette (1, 2, 4 and 8
  bits); alpha, and a ``tRNS`` chunk, are dropped, as ``convert("RGB")``
  drops them;
* Adam7-interlaced images are decoded pass by pass, each pass's rows
  unfiltered on their own, and the passes' pixels put in place;
* chunks are read with their CRCs checked; the ``IDAT`` data is inflated by
  the standard library's ``zlib``; the five row filters are reversed by
  ``csrc/host/png_unfilter.cpp`` (``g++`` at first use, as the resampler):
  Average and Paeth depend on the byte just reversed, too slow a loop for
  numpy at 224-1024 pixels a side.

A palette index past the palette, an image of more pixels than PIL opens
(``MAX_PIXELS``, shared with the JPEG route) and a malformed file are
refused with ``PngDecodeError``.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from ..ops import _build
from .image_io import MAX_PIXELS, ImageInputError

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, the bit depths taken)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                 4: (2, (8, 16)), 6: (4, (8, 16))}
_U8P = ctypes.POINTER(ctypes.c_uint8)
# Adam7's passes: the first column and row of each, and its steps across and down
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


class PngDecodeError(ImageInputError):
    """A PNG that this decoder refuses (a palette index past the palette,
    more pixels than ``MAX_PIXELS``) or that is malformed."""


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


def _sub_image(raw: bytes, at: int, width: int, height: int, channels: int, depth: int):
    """The samples of a ``width`` x ``height`` image (the whole image, or one
    Adam7 pass) whose filtered rows start at byte ``at`` of the inflated
    data: ``([height, width, channels] uint8, or uint16 at 16 bits; the
    byte after the rows)``."""
    stride = (width * channels * depth + 7) // 8
    end = at + height * (stride + 1)
    if len(raw) < end:
        raise PngDecodeError(f"truncated PNG: {len(raw)} bytes of image data, {end} needed")
    filtered = np.frombuffer(raw, np.uint8, count=height * (stride + 1), offset=at)
    rows = np.empty((height, stride), np.uint8)
    rc = _lib().vtc_png_unfilter(filtered.ctypes.data_as(_U8P), height, stride,
                                 max(1, channels * depth // 8), rows.ctypes.data_as(_U8P))
    if rc != 0:
        raise PngDecodeError(f"broken PNG: unknown filter type in row {-1 - rc}")
    if depth < 8:  # pack sub-byte samples, most significant bits first
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        samples = (bits * weights).sum(-1, dtype=np.uint8)[:, :width, None]
    elif depth == 16:
        samples = rows.view(">u2").astype(np.uint16).reshape(height, width, channels)
    else:
        samples = rows.reshape(height, width, channels)
    return samples, end


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
    if colour not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[colour][1] or (
            compression, filtering) != (0, 0) or interlace not in (0, 1) or width == 0 or (
            height == 0):
        raise PngDecodeError(f"malformed PNG header: {width}x{height}, bit depth {depth}, "
                             f"colour type {colour}, interlace {interlace}")
    if width * height > MAX_PIXELS:
        raise PngDecodeError(f"a {width}x{height} PNG: over {MAX_PIXELS} pixels, a "
                             "decompression bomb")
    if colour == 3 and palette is None:
        raise PngDecodeError("a palette PNG without a PLTE chunk")
    channels = _COLOUR_TYPES[colour][0]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PngDecodeError(f"broken PNG: {e}") from e
    if interlace == 0:
        samples, _ = _sub_image(raw, 0, width, height, channels, depth)
    else:
        samples = np.empty((height, width, channels), np.uint16 if depth == 16 else np.uint8)
        at = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw > 0 and ph > 0:  # an empty pass has no bytes, not even filter types
                samples[y0::dy, x0::dx], at = _sub_image(raw, at, pw, ph, channels, depth)
    samples = samples[..., 0] if channels == 1 else samples
    if colour == 3:
        if int(samples.max()) >= len(palette):
            raise PngDecodeError(f"broken PNG: palette index {int(samples.max())} past the "
                                 f"palette of {len(palette)} colours")
        return palette[samples]
    if depth == 16:  # I;16 -> RGB clamps; LA;16B, RGB;16B, RGBA;16B keep the high byte
        samples = (np.minimum(samples, 255) if colour == 0 else samples >> 8).astype(np.uint8)
    elif colour == 0:
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if colour in (0, 4):
        gray = samples if colour == 0 else samples[..., 0]
        return np.repeat(gray[..., None], 3, axis=-1)
    return np.ascontiguousarray(samples[..., :3])
