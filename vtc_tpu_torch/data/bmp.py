"""Decode a BMP on the host without PIL: ``decode_bmp(data)``.

The machine with the card has no PIL, and ``vtc_tpu`` reads a thumbnail of
any format PIL opens. This decoder gives what ``PIL.Image.open(...).convert(
"RGB")`` gives, bit for bit (Pillow's ``BmpImagePlugin``), for the BMPs that
it takes:

* the headers of 12 (OS/2 1.x, 3-byte palette entries), 40, 52, 56, 64, 108
  and 124 bytes;
* 1, 4 and 8 bits through the palette (4-byte entries, ``colors`` of them,
  all ``1 << bits`` where the header says 0; an index past the palette reads
  black). A palette whose entries are the gray ramp ``i -> (i, i, i)`` is
  dropped, as PIL drops it: an 8-bit pixel then reads as its own value and a
  1-bit one as 0 or 255; a 4-bit gray ramp PIL reads as 8-bit samples, and
  that is refused by name;
* 16, 24 and 32 bits, ``BI_RGB`` (16: 5-5-5, 32: B, G, R and a byte PIL
  drops) and ``BI_BITFIELDS`` with the masks PIL takes (32 bits: byte-wide
  masks in the orders of PIL's ``MASK_MODES``; 24: B, G, R; 16: 5-6-5 and
  5-5-5); a 5- or 6-bit channel scales to 0-255 as PIL's ``BGR;15`` and
  ``BGR;16`` unpackers scale it, ``v·255 // (2ⁿ − 1)``; alpha is dropped;
* RLE8 and RLE4, as PIL's ``BmpRleDecoder`` runs them, its delta escape
  included (it reads the two bytes after the escape and then two more, as
  the offsets);
* bottom-up rows, and top-down ones where the height's high byte is 0xFF.

An image of more pixels than PIL opens (``MAX_PIXELS``) is refused from the
header, before any pixel is decoded, and a malformed or truncated file, or
a kind PIL does not read, with ``BmpDecodeError``.
"""

from __future__ import annotations

import struct

import numpy as np

from .image_io import MAX_PIXELS, ImageInputError

SIGNATURE = b"BM"
HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)
RAW, RLE8, RLE4, BITFIELDS = 0, 1, 2, 3
# (bits, masks) -> where each of R, G, B sits: PIL's MASK_MODES, as byte
# offsets of a 32-bit or 24-bit pixel
BYTE_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): (2, 1, 0),
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): (3, 2, 1),
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): (3, 1, 0),
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): (3, 2, 1),
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): (0, 1, 2),
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): (2, 1, 0),
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): (3, 1, 0),
    (32, (0x0, 0x0, 0x0, 0x0)): (2, 1, 0),
    (24, (0xFF0000, 0xFF00, 0xFF)): (2, 1, 0),
}
# 16-bit pixels: (shift, width) of R, G, B
WORD_MASKS = {
    (0xF800, 0x7E0, 0x1F): ((11, 5), (5, 6), (0, 5)),
    (0x7C00, 0x3E0, 0x1F): ((10, 5), (5, 5), (0, 5)),
}


class BmpDecodeError(ImageInputError):
    """A BMP that this decoder refuses (a kind PIL does not read, more
    pixels than ``MAX_PIXELS``) or that is malformed or truncated."""


def _u32(data, off):
    return struct.unpack_from("<I", data, off)[0]


def _u16(data, off):
    return struct.unpack_from("<H", data, off)[0]


def bmp_header(data: bytes) -> dict:
    """What the file and DIB headers say: ``width``, ``height``, ``bits``,
    ``compression``, ``top_down``, ``colors``, the palette's ``entry``
    size, the masks of a ``BI_BITFIELDS`` image, where the palette starts
    (``palette_at``) and where the pixels start (``offset``)."""
    if data[:2] != SIGNATURE or len(data) < 18:
        raise BmpDecodeError("not a BMP file")
    offset = _u32(data, 10)
    size = _u32(data, 14)
    if size not in HEADER_SIZES:
        raise BmpDecodeError(f"unsupported BMP header type ({size})")
    if len(data) < 14 + size:
        raise BmpDecodeError("a truncated BMP header")
    h = {"header_size": size, "masks": None}
    at = 14 + size
    if size == 12:
        h.update(width=_u16(data, 18), height=_u16(data, 20), bits=_u16(data, 24),
                 compression=RAW, colors=0, entry=3, top_down=False)
    else:
        top_down = data[25] == 0xFF  # the height's high byte, as PIL reads it
        height = _u32(data, 22)
        h.update(width=_u32(data, 18), height=2**32 - height if top_down else height,
                 bits=_u16(data, 28), compression=_u32(data, 30), colors=_u32(data, 46),
                 entry=4, top_down=top_down)
        if h["compression"] == BITFIELDS:
            if size >= 52:
                n = 4 if size >= 56 else 3
                masks = struct.unpack_from(f"<{n}I", data, 54)
            else:  # a 40-byte header: three masks after it
                if len(data) < at + 12:
                    raise BmpDecodeError("a truncated BMP header")
                masks = struct.unpack_from("<3I", data, at)
                at += 12
            h["masks"] = tuple(masks) + (0,) * (4 - len(masks))
    if not h["colors"]:
        h["colors"] = 1 << h["bits"]
    h["palette_at"] = at
    if offset == 14 + size and h["bits"] <= 8:
        offset += 4 * h["colors"]
    h["offset"] = offset
    return h


def check_size(h: dict) -> None:
    if h["width"] * h["height"] > MAX_PIXELS:
        raise BmpDecodeError(f"a {h['width']}x{h['height']} BMP: over {MAX_PIXELS} pixels, "
                             "a decompression bomb")


def decode_bmp(data: bytes) -> np.ndarray:
    """uint8 ``[height, width, 3]`` RGB of the BMP bytes ``data``."""
    h = bmp_header(data)
    check_size(h)
    w, ht, bits, comp = h["width"], h["height"], h["bits"], h["compression"]
    if bits not in (1, 4, 8, 16, 24, 32):
        raise BmpDecodeError(f"unsupported BMP pixel depth ({bits})")
    if comp == BITFIELDS:
        key = h["masks"] if bits == 32 else h["masks"][:3]
        if (bits, key) not in BYTE_MASKS and not (bits == 16 and key in WORD_MASKS):
            raise BmpDecodeError("unsupported BMP bitfields layout")
    elif comp in (RLE8, RLE4):
        if bits > 8:
            raise BmpDecodeError(f"an RLE-compressed BMP of {bits} bits")
    elif comp != RAW:
        raise BmpDecodeError(f"unsupported BMP compression ({comp})")
    if w == 0 or ht == 0:
        raise BmpDecodeError(f"a {w}x{ht} BMP")

    lut = None
    if bits <= 8:
        lut = _palette(data, h)
    if comp in (RLE8, RLE4):
        idx = _rle(data, h)
    else:
        idx = _raw(data, h)
    if lut is not None:
        return lut[idx]
    return idx


def _palette(data: bytes, h: dict):
    """``[256, 3]`` uint8 lookup of a palette image's indices (black past
    the palette), or the gray ramp of a palette PIL drops."""
    colors, entry, at = h["colors"], h["entry"], h["palette_at"]
    if not 0 < colors <= 65536:
        raise BmpDecodeError(f"unsupported BMP palette size ({colors})")
    # PIL reads ``colors`` entries from after the header, whatever lies
    # there (the pixels themselves, where the header's count runs past the
    # palette written), and as many as the file holds
    raw = data[at:at + entry * colors]
    pal = np.frombuffer(raw, np.uint8, len(raw) // entry * entry).reshape(-1, entry)[:, 2::-1]
    ramp = np.array([0, 255] if colors == 2 else np.arange(colors) % 256, np.uint8)
    if len(pal) == colors and np.array_equal(pal, np.repeat(ramp[:, None], 3, 1)):
        if colors == 2:  # PIL's "1": a set bit reads 255
            if h["bits"] != 1:
                raise BmpDecodeError(f"a {h['bits']}-bit BMP of a black and white "
                                     "palette: PIL reads its pixels as bits")
            return np.array([[0] * 3] + [[255] * 3] * 255, np.uint8)
        if h["bits"] != 8:
            raise BmpDecodeError(f"a {h['bits']}-bit BMP whose palette is the gray ramp: "
                                 "PIL reads its pixels as 8-bit samples")
        return np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    lut = np.zeros((256, 3), np.uint8)
    lut[:min(len(pal), 256)] = pal[:256]
    return lut


def _raw(data: bytes, h: dict) -> np.ndarray:
    """Palette indices ``[h, w]`` or RGB ``[h, w, 3]`` of an uncompressed
    or ``BI_BITFIELDS`` image."""
    w, ht, bits = h["width"], h["height"], h["bits"]
    stride = ((w * bits + 31) >> 3) & ~3
    start = h["offset"]
    if start + stride * ht > len(data):
        raise BmpDecodeError(f"a truncated BMP: {len(data) - start} bytes of pixels, "
                             f"{stride * ht} needed")
    rows = np.frombuffer(data, np.uint8, stride * ht, start).reshape(ht, stride)
    if not h["top_down"]:
        rows = rows[::-1]
    if bits < 8:
        return np.unpackbits(rows, axis=1, bitorder="big").reshape(ht, -1, bits)[
            :, :w].dot(1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    if bits == 8:
        return rows[:, :w]
    if bits == 16:
        key = h["masks"][:3] if h["compression"] == BITFIELDS else (0x7C00, 0x3E0, 0x1F)
        px = rows[:, :2 * w].view("<u2").astype(np.uint32)
        out = np.empty((ht, w, 3), np.uint8)
        for c, (shift, width) in enumerate(WORD_MASKS[key]):
            top = (1 << width) - 1
            out[..., c] = ((px >> shift) & top) * 255 // top
        return out
    order = (2, 1, 0)  # B, G, R (and a byte PIL drops)
    if h["compression"] == BITFIELDS:
        order = BYTE_MASKS[(bits, h["masks"] if bits == 32 else h["masks"][:3])]
    px = rows[:, :w * bits // 8].reshape(ht, w, bits // 8)
    return np.ascontiguousarray(px[..., list(order)])


def _rle(data: bytes, h: dict) -> np.ndarray:
    """Palette indices ``[h, w]`` of an RLE8 or RLE4 image, as PIL's
    ``BmpRleDecoder`` runs it: pixels not written stay 0."""
    w, ht = h["width"], h["height"]
    rle4 = h["compression"] == RLE4
    total = w * ht
    out = bytearray()
    x, pos, n = 0, h["offset"], len(data)
    while len(out) < total:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:  # a run
            count = max(0, w - x) if x + count > w else count
            if rle4:
                pair = bytes((byte >> 4, byte & 0x0F))
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes((byte,)) * count
            x += count
        elif byte == 0:  # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:  # end of bitmap
            break
        elif byte == 2:  # delta: PIL reads two bytes, then the offsets from the next two
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise BmpDecodeError("a truncated BMP: an RLE delta without its offsets")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:  # absolute mode: ``byte`` pixels
            nbytes = byte // 2 if rle4 else byte
            chunk = data[pos:pos + nbytes]
            pos += len(chunk)
            if rle4:
                out += bytes(v for b in chunk for v in (b >> 4, b & 0x0F))
            else:
                out += chunk
            if len(chunk) < nbytes:
                break
            x += byte
            if pos % 2:  # word-aligned
                pos += 1
    if len(out) < total:
        raise BmpDecodeError(f"a truncated BMP: RLE data for {len(out)} of {total} pixels")
    idx = np.frombuffer(bytes(out[:total]), np.uint8).reshape(ht, w)
    return idx if h["top_down"] else idx[::-1]
