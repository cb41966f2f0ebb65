"""Decode a GIF on the host without PIL: ``decode_gif(data)``.

The machine with the card has no PIL, and ``vtc_tpu`` reads a thumbnail of
any format PIL opens. This decoder gives what ``PIL.Image.open(...).convert(
"RGB")`` gives, bit for bit (Pillow's ``GifImagePlugin``), which is the
first frame on the logical screen:

* the screen is the header's size, grown to hold the first frame where its
  extent reaches past it;
* the screen starts as the frame's transparent index where its graphic
  control extension names one, else as index 0, and the frame's pixels are
  decoded into its extent;
* the indices go through the frame's local palette, else the global one,
  an index past the palette reading black; a transparent index reads as
  its palette colour, since ``convert("RGB")`` drops transparency. A
  palette whose entries are the ramp ``i -> (i, i, i)`` is dropped, as PIL
  drops it (an index then reads as its own gray value), and so does a
  GIF without a palette;
* the image data is LZW-decoded as PIL's ``GifDecode.c`` does it (clear
  and end codes, a 12-bit table that stops growing when full), interlaced
  rows going to their pass's places. Pixels past an end code keep the
  screen's index.

An image of more pixels than PIL opens (``MAX_PIXELS``) is refused from the
logical screen and frame headers, before any pixel is decoded; a
malformed or truncated file with ``GifDecodeError``.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_io import MAX_PIXELS, ImageInputError

SIGNATURES = (b"GIF87a", b"GIF89a")
MAX_CODE_BITS = 12
# interlaced rows: (first row, step) of each pass
INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))


class GifDecodeError(ImageInputError):
    """A GIF that this decoder refuses (more pixels than ``MAX_PIXELS``) or
    that is malformed or truncated."""


def _palette(raw: bytes):
    """``[n, 3]`` uint8 of a palette, or None for the gray ramp PIL drops."""
    pal = np.frombuffer(raw, np.uint8).reshape(-1, 3)
    ramp = np.arange(len(pal)) % 256
    if (pal == ramp[:, None]).all():
        return None
    return pal


def _sub_blocks(data: bytes, pos: int):
    """(the payload of the sub-blocks at ``pos``, the position after their
    terminator, whether the terminator was there)."""
    out, n = bytearray(), len(data)
    while pos < n:
        size = data[pos]
        pos += 1
        if size == 0:
            return bytes(out), pos, True
        out += data[pos:pos + size]
        pos += size
    return bytes(out), pos, False


def gif_header(data: bytes) -> dict:
    """The logical screen, the global palette and the first frame's
    descriptor: ``width``/``height`` (the screen, grown to the frame),
    ``extent`` (x0, y0, x1, y1), ``interlace``, ``palette`` (``[n, 3]`` or
    None), ``transparency`` (an index or None), ``code_size`` and
    ``data_at``, where the frame's LZW sub-blocks start."""
    if data[:6] not in SIGNATURES or len(data) < 13:
        raise GifDecodeError("not a GIF file")
    width, height = struct.unpack_from("<HH", data, 6)
    flags = data[10]
    pos = 13
    global_palette = None
    if flags & 0x80:
        size = 3 << ((flags & 7) + 1)
        if pos + size > len(data):
            raise GifDecodeError("a truncated GIF: the global palette")
        global_palette = _palette(data[pos:pos + size])
        pos += size
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise GifDecodeError("a GIF without an image")
        kind = data[pos]
        pos += 1
        if kind == 0x21:  # an extension
            if pos >= len(data):
                raise GifDecodeError("a truncated GIF: an extension")
            label = data[pos]
            if label == 0xF9 and pos + 1 < len(data) and data[pos + 1] >= 4 \
                    and pos + 5 < len(data) and data[pos + 2] & 1:
                transparency = data[pos + 5]  # the graphic control's index
            _, pos, _ = _sub_blocks(data, pos + 1)
        elif kind == 0x2C:  # the image descriptor
            if pos + 9 > len(data):
                raise GifDecodeError("a truncated GIF: the image descriptor")
            x0, y0, w, h = struct.unpack_from("<HHHH", data, pos)
            flags = data[pos + 8]
            pos += 9
            palette = global_palette
            if flags & 0x80:
                size = 3 << ((flags & 7) + 1)
                if pos + size > len(data):
                    raise GifDecodeError("a truncated GIF: the local palette")
                palette = _palette(data[pos:pos + size])
                pos += size
            if pos >= len(data):
                raise GifDecodeError("a truncated GIF: the image data")
            return {"width": max(width, x0 + w), "height": max(height, y0 + h),
                    "extent": (x0, y0, x0 + w, y0 + h), "interlace": bool(flags & 0x40),
                    "palette": palette, "transparency": transparency,
                    "code_size": data[pos], "data_at": pos + 1}
        # any other byte is skipped, as PIL skips it


def decode_gif(data: bytes) -> np.ndarray:
    """uint8 ``[height, width, 3]`` RGB of the GIF bytes ``data``: its first
    frame on the logical screen."""
    h = gif_header(data)
    if h["width"] * h["height"] > MAX_PIXELS:
        raise GifDecodeError(f"a {h['width']}x{h['height']} GIF: over {MAX_PIXELS} pixels, "
                             "a decompression bomb")
    x0, y0, x1, y1 = h["extent"]
    fw, fh = x1 - x0, y1 - y0
    fill = h["transparency"] if h["transparency"] is not None else 0
    screen = np.full((h["height"], h["width"]), fill, np.uint8)
    if fw and fh:
        payload, _, _ = _sub_blocks(data, h["data_at"])
        pixels = lzw_decode(payload, h["code_size"], fw * fh)
        frame = screen[y0:y1, x0:x1].copy().reshape(-1)
        frame[:len(pixels)] = np.frombuffer(pixels, np.uint8)
        frame = frame.reshape(fh, fw)
        if h["interlace"]:
            rows = np.concatenate([np.arange(first, fh, step) for first, step in INTERLACE])
            placed = np.empty_like(frame)
            placed[rows] = frame
            frame = placed
        screen[y0:y1, x0:x1] = frame
    pal = h["palette"]
    if pal is None:
        return np.repeat(screen[..., None], 3, -1)
    lut = np.zeros((256, 3), np.uint8)
    lut[:min(len(pal), 256)] = pal[:256]
    return lut[screen]


def lzw_decode(payload: bytes, code_size: int, count: int) -> bytes:
    """The first ``count`` (or fewer, at an end code) pixel indices of the
    GIF LZW stream ``payload`` with the minimum code size ``code_size``. A
    stream that runs out before ``count`` pixels and an end code, or holds
    a code the table does not have yet, raises ``GifDecodeError``."""
    if not 1 <= code_size <= 11:
        raise GifDecodeError(f"a GIF LZW minimum code size of {code_size}")
    clear, end = 1 << code_size, (1 << code_size) + 1
    base = [bytes((i,)) for i in range(clear)] + [b"", b""]
    table = list(base)
    bits = code_size + 1
    out = bytearray()
    prev = None
    acc = nacc = 0
    pos, n = 0, len(payload)
    while len(out) < count:
        while nacc < bits:
            if pos >= n:
                raise GifDecodeError(f"a truncated GIF: LZW data for {len(out)} of "
                                     f"{count} pixels")
            acc |= payload[pos] << nacc
            nacc += 8
            pos += 1
        code = acc & ((1 << bits) - 1)
        acc >>= bits
        nacc -= bits
        if code == clear:
            table = list(base)
            bits = code_size + 1
            prev = None
            continue
        if code == end:
            break
        if prev is None:
            if code >= len(table):
                raise GifDecodeError(f"a GIF LZW code {code} before any pixel")
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            if len(table) < 1 << MAX_CODE_BITS:
                table.append(prev + entry[:1])
        elif code == len(table) and code < 1 << MAX_CODE_BITS:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise GifDecodeError(f"a GIF LZW code {code} past the table's {len(table)}")
        if len(table) == 1 << bits and bits < MAX_CODE_BITS:
            bits += 1
        out += entry
        prev = entry
    return bytes(out[:count])
