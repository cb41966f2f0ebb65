"""Decode a WebP on the host without PIL: ``decode_webp(data)``.

The machine with the card has no PIL, and the JAX package trains on and
answers whatever ``PIL.Image.open(...).convert("RGB")`` reads: WebP is the
format in which the large image hosts serve thumbnails. PIL 12 opens every
WebP with libwebp's ``WebPAnimDecoder`` and keeps frame 0; this module gives
the same pixels, bit for bit, and refuses (``WebpDecodeError``) the files
that PIL refuses:

* the file is recognized as PIL's ``_accept`` does it: ``RIFF``, ``WEBP``,
  then ``VP8 ``, ``VP8L`` or ``VP8X`` at byte 12;
* the container is checked as libwebp checks it before and while it
  demuxes: the header parse of ``WebPGetFeatures`` (the RIFF size, a
  ``VP8X`` chunk of 10 bytes, the chunks before the bitstream summing to
  no more than the RIFF size, a canvas the size of a still image's
  bitstream), then the demuxer's rules (``src/demux/demux.c``): chunk sizes
  and their padding inside the RIFF chunk, a file no shorter than its RIFF
  size, ``VP8X`` flags among the defined ones, an animation's frames in
  ``ANMF`` chunks after an ``ANIM`` chunk and a still image's outside them,
  an ``ALPH`` chunk before its bitstream (and dropped where the ``VP8X``
  flags have no alpha), each frame inside the canvas;
* a canvas of more than ``image_io.MAX_PIXELS`` pixels is refused from its
  header, before anything is allocated, as ``Image.open`` refuses a
  decompression bomb;
* frame 0's bitstream (``VP8`` lossy with its ``ALPH`` chunk, or ``VP8L``
  lossless) is decoded by ``csrc/host/webp_decode.cpp`` (``g++`` at first
  use, loaded with ``ctypes``, as the PNG unfilter is) into RGBA, and put on
  a canvas of transparent black at its offset: a key frame, not blended.
  ``convert("RGB")`` drops the alpha, so pixels outside the frame read
  (0, 0, 0).

No other decoder stands in, and no libwebp is linked: a malformed file
raises ``WebpDecodeError`` (an ``ImageInputError``); a decoder that does not
build raises the program's ``RuntimeError``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..ops import _build
from .image_io import MAX_PIXELS, ImageInputError

_U8P = ctypes.POINTER(ctypes.c_uint8)
_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_IMAGE_AREA = 1 << 32
_ALPHA_FLAG, _ANIMATION_FLAG, _ALL_VALID_FLAGS = 0x10, 0x02, 0x3E
# libwebp's VP8StatusCode values that matter here
_OK, _NOT_ENOUGH_DATA, _BITSTREAM_ERROR = 0, 7, 3
# the demuxer's ParseStatus
_PARSE_OK, _PARSE_NEED_MORE_DATA, _PARSE_ERROR = 0, 1, 2

# csrc/host/webp_decode.cpp's Status codes
DECODE_ERRORS = {
    1: "a VP8 frame header that is not a shown key frame of its stated size",
    2: "a VP8 first partition longer than the data",
    3: "VP8 token partitions past the data",
    4: "premature end of the VP8 first partition",
    5: "premature end of a VP8 token partition",
    6: "a VP8 frame header cut short",
    7: "a VP8L header with a bad signature, version or size",
    8: "an invalid VP8L prefix code, transform or colour cache",
    9: "premature end of the VP8L stream",
    10: "a VP8L backward reference outside the image",
    11: "an ALPH header with an unknown method, pre-processing or reserved bits",
    12: "raw alpha shorter than the image",
    13: "an invalid VP8L stream in the ALPH chunk",
    14: "a bitstream whose size is not the header's",
    15: "out of memory",
}


class WebpDecodeError(ImageInputError):
    """A WebP that PIL does not decode either: malformed, truncated, or over
    ``MAX_PIXELS`` pixels."""


def is_webp(data: bytes) -> bool:
    """PIL's ``WebPImagePlugin._accept``."""
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP" and data[12:16] in (
        b"VP8 ", b"VP8L", b"VP8X")


def _lib():
    lib = _build.load_host_library("webp_decode")
    if lib.vtc_webp_decode.argtypes is None:
        lib.vtc_webp_decode.argtypes = [_U8P, ctypes.c_size_t, ctypes.c_int, _U8P,
                                        ctypes.c_size_t, ctypes.c_int, ctypes.c_int, _U8P]
        lib.vtc_webp_decode.restype = ctypes.c_int
    return lib


def _le(data, at: int, n: int) -> int:
    return int.from_bytes(data[at:at + n], "little")


# ---- libwebp's header parse (src/dec/webp_dec.c) ------------------------------------

def _vp8_info(data, at: int, size: int, chunk_size: int) -> Optional[Tuple[int, int]]:
    """``VP8GetInfo``: the size of a VP8 key frame, or None."""
    if size < 10 or data[at + 3:at + 6] != b"\x9d\x01\x2a":
        return None
    bits = _le(data, at, 3)
    width, height = _le(data, at + 6, 2) & 0x3FFF, _le(data, at + 8, 2) & 0x3FFF
    if bits & 1 or ((bits >> 1) & 7) > 3 or not (bits >> 4) & 1 or (bits >> 5) >= chunk_size:
        return None
    if width == 0 or height == 0:
        return None
    return width, height


def _vp8l_info(data, at: int, size: int) -> Optional[Tuple[int, int]]:
    """``VP8LGetInfo``: the size of a VP8L stream, or None."""
    if size < 5 or data[at] != 0x2F or data[at + 4] >> 5 != 0:
        return None
    bits = _le(data, at + 1, 4)
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


@dataclass
class _Headers:
    status: int
    width: int = 0
    height: int = 0
    animation: bool = False
    lossless: bool = False
    offset: int = 0         # the bitstream, after its chunk header
    alpha: Optional[Tuple[int, int]] = None  # (offset, size) of the ALPH payload


def _optional_chunks(data, pos: int, size: int, riff_size: int):
    """``ParseOptionalChunks``: skips to the VP8/VP8L chunk; (status, pos,
    size, alpha)."""
    total = 4 + 8 + 10
    alpha = None
    while True:
        if size < 8:
            return _NOT_ENOUGH_DATA, pos, size, alpha
        chunk_size = _le(data, pos + 4, 4)
        if chunk_size > _MAX_CHUNK_PAYLOAD:
            return _BITSTREAM_ERROR, pos, size, alpha
        disk = ((8 + chunk_size + 1) & ~1) & 0xFFFFFFFF
        total = (total + disk) & 0xFFFFFFFF
        if riff_size > 0 and total > riff_size:
            return _BITSTREAM_ERROR, pos, size, alpha
        if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
            return _OK, pos, size, alpha
        if size < disk:
            return _NOT_ENOUGH_DATA, pos, size, alpha
        if data[pos:pos + 4] == b"ALPH":
            alpha = (pos + 8, chunk_size)
        pos += disk
        size -= disk


def _parse_headers(data, for_decode: bool) -> _Headers:
    """``ParseHeadersInternal``: as ``WebPGetFeatures`` runs it
    (``for_decode`` False) or as ``WebPDecode`` does (True: all the data at
    hand, the bitstream's place and the ALPH chunk wanted)."""
    size, pos = len(data), 0
    if size < 12:
        return _Headers(_NOT_ENOUGH_DATA)
    riff_size = 0
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            return _Headers(_BITSTREAM_ERROR)
        riff = _le(data, 4, 4)
        if riff < 12 or riff > _MAX_CHUNK_PAYLOAD:
            return _Headers(_BITSTREAM_ERROR)
        if for_decode and riff > size - 8:
            return _Headers(_NOT_ENOUGH_DATA)
        riff_size, pos, size = riff, 12, size - 12
    if size < 8:
        return _Headers(_NOT_ENOUGH_DATA)
    found_vp8x, flags, width, height = False, 0, 0, 0
    if data[pos:pos + 4] == b"VP8X":
        if _le(data, pos + 4, 4) != 10:
            return _Headers(_BITSTREAM_ERROR)
        if size < 18:
            return _Headers(_NOT_ENOUGH_DATA)
        flags = _le(data, pos + 8, 4)
        width, height = 1 + _le(data, pos + 12, 3), 1 + _le(data, pos + 15, 3)
        if width * height >= _MAX_IMAGE_AREA:
            return _Headers(_BITSTREAM_ERROR)
        pos, size, found_vp8x = pos + 18, size - 18, True
    if riff_size == 0 and found_vp8x:
        return _Headers(_BITSTREAM_ERROR)
    out = _Headers(_OK, width, height, bool(flags & _ANIMATION_FLAG))

    def finish(status):  # ReturnWidthHeight
        if status == _OK or (status == _NOT_ENOUGH_DATA and found_vp8x and not for_decode):
            out.status = _OK
        else:
            out.status = status
        return out

    if found_vp8x and out.animation and not for_decode:
        return finish(_OK)
    if size < 4:
        return finish(_NOT_ENOUGH_DATA)
    if (riff_size and found_vp8x) or (not riff_size and not found_vp8x
                                      and data[pos:pos + 4] == b"ALPH"):
        status, pos, size, out.alpha = _optional_chunks(data, pos, size, riff_size)
        if status != _OK:
            return finish(status)
    # ParseVP8Header
    if size < 8:
        return finish(_NOT_ENOUGH_DATA)
    tag = data[pos:pos + 4]
    if tag in (b"VP8 ", b"VP8L"):
        chunk = _le(data, pos + 4, 4)
        if riff_size >= 12 and chunk > riff_size - 12:
            return finish(_BITSTREAM_ERROR)
        if for_decode and chunk > size - 8:
            return finish(_NOT_ENOUGH_DATA)
        compressed, pos, size, out.lossless = chunk, pos + 8, size - 8, tag == b"VP8L"
    else:  # a bitstream without its chunk header
        out.lossless = _vp8l_info(data, pos, size) is not None
        compressed = size
    if compressed > _MAX_CHUNK_PAYLOAD:
        return _Headers(_BITSTREAM_ERROR)
    if not out.lossless:
        if size < 10:
            return finish(_NOT_ENOUGH_DATA)
        image = _vp8_info(data, pos, size, compressed)
        if image is None:
            return _Headers(_BITSTREAM_ERROR)
    else:
        if size < 5:
            return finish(_NOT_ENOUGH_DATA)
        image = _vp8l_info(data, pos, size)
        if image is None:
            return _Headers(_BITSTREAM_ERROR)
    if found_vp8x and (width, height) != image:
        return _Headers(_BITSTREAM_ERROR)
    out.width, out.height = image
    out.offset = pos
    return finish(_OK)


# ---- libwebp's demuxer (src/demux/demux.c), for a file held whole ---------------------

@dataclass
class _Frame:
    x_offset: int = 0
    y_offset: int = 0
    width: int = 0
    height: int = 0
    frame_num: int = 0
    complete: bool = False
    image: Tuple[int, int] = (0, 0)  # (offset, size) of the chunk, header included
    alpha: Tuple[int, int] = (0, 0)


class _Demuxer:
    PARSING_HEADER, PARSED_HEADER, DONE = 0, 1, 2

    def __init__(self, data, riff_end: int):
        self.data, self.riff_end = data, riff_end
        self.start, self.end = 12, riff_end  # the file is whole: end is the RIFF end
        self.state = self.PARSING_HEADER
        self.is_ext = False
        self.flags = 0
        self.canvas = (-1, -1)
        self.frames = []
        self.num_frames = 0

    # MemBuffer
    def left(self) -> int:
        return self.end - self.start

    def invalid(self, size: int) -> bool:
        return size > self.riff_end - self.start

    def read(self, n: int) -> int:
        v = _le(self.data, self.start, n)
        self.start += n
        return v

    def add_frame(self, frame: _Frame) -> bool:
        if self.frames and not self.frames[-1].complete:
            return False
        self.frames.append(frame)
        return True

    def store_frame(self, frame_num: int, min_size: int, frame: _Frame) -> int:
        alpha_chunks = image_chunks = 0
        if self.left() < 8 or self.left() < min_size:
            return _PARSE_NEED_MORE_DATA
        status, done = _PARSE_OK, False
        while not done and status == _PARSE_OK:
            chunk_start = self.start
            fourcc = self.data[self.start:self.start + 4]
            self.start += 4
            payload = self.read(4)
            if payload > _MAX_CHUNK_PAYLOAD:
                return _PARSE_ERROR
            padded = payload + (payload & 1)
            available = min(padded, self.left())
            chunk_size = 8 + available
            if self.invalid(padded):
                return _PARSE_ERROR
            if padded > self.left():
                status = _PARSE_NEED_MORE_DATA
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame.alpha, frame.frame_num = (chunk_start, chunk_size), frame_num
                self.start += available
            elif fourcc == b"VP8L" and alpha_chunks > 0:
                return _PARSE_ERROR  # VP8L has its own alpha
            elif fourcc in (b"VP8 ", b"VP8L") and image_chunks == 0:
                features = _parse_headers(self.data[chunk_start:chunk_start + chunk_size], False)
                if status == _PARSE_NEED_MORE_DATA and features.status == _NOT_ENOUGH_DATA:
                    return _PARSE_NEED_MORE_DATA
                if features.status != _OK:
                    return _PARSE_ERROR
                image_chunks = 1
                frame.image = (chunk_start, chunk_size)
                frame.width, frame.height = features.width, features.height
                frame.frame_num, frame.complete = frame_num, status == _PARSE_OK
                self.start += available
            else:  # not this frame's: the caller parses it
                self.start -= 8
                done = True
            if self.start == self.riff_end:
                done = True
            elif self.left() < 8:
                status = _PARSE_NEED_MORE_DATA
        return status

    def parse_single_image(self) -> int:
        if self.frames or self.invalid(8):
            return _PARSE_ERROR
        if self.left() < 8:
            return _PARSE_NEED_MORE_DATA
        frame = _Frame()
        status = self.store_frame(1, 0, frame)
        if status != _PARSE_ERROR:
            if not self.flags & _ALPHA_FLAG:  # the ALPH chunk is dropped
                frame.alpha = (0, 0)
            if not self.is_ext and frame.width > 0 and frame.height > 0:
                self.state = self.PARSED_HEADER
                self.canvas = (frame.width, frame.height)
            if not self.add_frame(frame):
                status = _PARSE_ERROR
            else:
                self.num_frames = 1
        return status

    def parse_animation_frame(self, frame_chunk_size: int) -> int:
        is_animation = bool(self.flags & _ANIMATION_FLAG)
        if self.invalid(16) or frame_chunk_size < 16:
            return _PARSE_ERROR
        if self.left() < 16:
            return _PARSE_NEED_MORE_DATA
        frame = _Frame()
        frame.x_offset, frame.y_offset = 2 * self.read(3), 2 * self.read(3)
        frame.width, frame.height = 1 + self.read(3), 1 + self.read(3)
        self.read(3)  # duration
        self.read(1)  # dispose and blend
        if frame.width * frame.height >= _MAX_IMAGE_AREA:
            return _PARSE_ERROR
        start = self.start
        status = self.store_frame(self.num_frames + 1, frame_chunk_size - 16, frame)
        if status != _PARSE_ERROR and self.start - start > frame_chunk_size - 16:
            status = _PARSE_ERROR
        if status != _PARSE_ERROR and is_animation and frame.frame_num > 0:
            if self.add_frame(frame):
                self.num_frames += 1
            else:
                status = _PARSE_ERROR
        return status

    def parse_vp8x_chunks(self) -> int:
        is_animation = bool(self.flags & _ANIMATION_FLAG)
        anim_chunks = 0
        status = _PARSE_OK
        while status == _PARSE_OK:
            fourcc = self.data[self.start:self.start + 4]
            self.start += 4
            chunk_size = self.read(4)
            if chunk_size > _MAX_CHUNK_PAYLOAD:
                return _PARSE_ERROR
            padded = chunk_size + (chunk_size & 1)
            if self.invalid(padded):
                return _PARSE_ERROR
            if fourcc == b"VP8X":
                return _PARSE_ERROR
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks > 0 or is_animation:
                    return _PARSE_ERROR
                self.start -= 8
                status = self.parse_single_image()
            elif fourcc == b"ANIM" and anim_chunks == 0:
                if padded < 6:
                    return _PARSE_ERROR
                if self.left() < padded:
                    status = _PARSE_NEED_MORE_DATA
                else:
                    anim_chunks = 1
                    self.start += padded  # background colour, loop count
            elif fourcc == b"ANMF":
                if anim_chunks == 0:
                    return _PARSE_ERROR  # ANIM comes before the frames
                status = self.parse_animation_frame(padded)
            else:  # a second ANIM, ICCP, EXIF, XMP and unknown chunks are skipped
                if fourcc == b"ANIM" and padded < 6:
                    return _PARSE_ERROR
                if padded <= self.left():
                    self.start += padded
                else:
                    status = _PARSE_NEED_MORE_DATA
            if self.start == self.riff_end:
                break
            if self.left() < 8:
                status = _PARSE_NEED_MORE_DATA
        return status

    def parse_vp8x(self) -> int:
        if self.left() < 8:
            return _PARSE_NEED_MORE_DATA
        self.is_ext = True
        self.start += 4
        size = self.read(4)
        if size > _MAX_CHUNK_PAYLOAD or size < 10:
            return _PARSE_ERROR
        size += size & 1
        if self.invalid(size):
            return _PARSE_ERROR
        if self.left() < size:
            return _PARSE_NEED_MORE_DATA
        self.flags = self.read(1)
        self.start += 3  # reserved
        self.canvas = (1 + self.read(3), 1 + self.read(3))
        if self.canvas[0] * self.canvas[1] >= _MAX_IMAGE_AREA:
            return _PARSE_ERROR
        self.start += size - 10
        self.state = self.PARSED_HEADER
        if self.invalid(8):
            return _PARSE_ERROR
        if self.left() < 8:
            return _PARSE_NEED_MORE_DATA
        return self.parse_vp8x_chunks()

    def valid_simple(self) -> bool:
        if self.state == self.PARSING_HEADER:
            return True
        if self.canvas[0] <= 0 or self.canvas[1] <= 0:
            return False
        if self.state == self.DONE and not self.frames:
            return False
        return self.frames[0].width > 0 and self.frames[0].height > 0

    def valid_extended(self) -> bool:
        is_animation = bool(self.flags & _ANIMATION_FLAG)
        if self.state == self.PARSING_HEADER:
            return True
        if self.canvas[0] <= 0 or self.canvas[1] <= 0:
            return False
        if self.state == self.DONE and not self.frames:
            return False
        if self.flags & ~_ALL_VALID_FLAGS:
            return False
        for i, f in enumerate(self.frames):
            if not is_animation and f.frame_num > 1:
                return False
            if f.complete:
                if f.alpha[1] == 0 and f.image[1] == 0:
                    return False
                if f.alpha[1] > 0 and f.alpha[0] > f.image[0]:
                    return False
                if f.width <= 0 or f.height <= 0:
                    return False
            else:
                if self.state == self.DONE:
                    return False
                if f.alpha[1] > 0 and f.image[1] > 0 and f.alpha[0] > f.image[0]:
                    return False
                if i + 1 < len(self.frames):
                    return False
            if f.width > 0 and f.height > 0:
                if not is_animation:
                    bad = (f.x_offset, f.y_offset) != (0, 0) or (f.width, f.height) != self.canvas
                else:
                    bad = (f.x_offset < 0 or f.y_offset < 0 or f.width + f.x_offset > self.canvas[0]
                           or f.height + f.y_offset > self.canvas[1])
                if bad:
                    return False
        return True


def _demux(data) -> _Demuxer:
    """``WebPDemux`` of a whole file (PIL hands libwebp all of it)."""
    riff_size = _le(data, 4, 4)
    if len(data) < 20 or riff_size < 8 or riff_size > _MAX_CHUNK_PAYLOAD:
        raise WebpDecodeError("malformed WebP: a RIFF header of a bad size")
    if len(data) < riff_size + 8:
        raise WebpDecodeError(f"truncated WebP: {len(data)} bytes of a RIFF chunk of "
                              f"{riff_size + 8}")
    dmux = _Demuxer(data, riff_size + 8)
    tag = data[12:16]
    if tag == b"VP8X":
        status, valid = dmux.parse_vp8x(), dmux.valid_extended
    else:
        status, valid = dmux.parse_single_image(), dmux.valid_simple
    if status == _PARSE_OK:
        dmux.state = dmux.DONE
    if status != _PARSE_OK or not valid():
        raise WebpDecodeError("malformed WebP: its chunks break the container's rules")
    return dmux


@dataclass
class Frame0:
    """What ``WebPAnimDecoder`` decodes for PIL: the canvas size, frame 0's
    place on it, and the bitstreams libwebp hands its decoder."""
    canvas: Tuple[int, int]
    offset: Tuple[int, int]
    size: Tuple[int, int]
    lossless: bool
    bitstream: memoryview          # the VP8 or VP8L payload, to the frame's end
    alpha: Optional[memoryview]    # the ALPH payload of a lossy frame


def locate_frame0(data) -> Frame0:
    """The container checks, in libwebp's order: ``WebPGetFeatures`` of the
    file, the canvas against ``MAX_PIXELS``, the demuxer, then
    ``WebPDecode``'s two header parses of frame 0's payload (the ALPH chunk
    and the bitstream's)."""
    if not is_webp(data):
        raise WebpDecodeError("not a WebP (RIFF, WEBP, then VP8 , VP8L or VP8X)")
    data = memoryview(data)
    features = _parse_headers(data, False)
    if features.status != _OK:
        raise WebpDecodeError("malformed WebP: its headers do not parse")
    if features.width * features.height > MAX_PIXELS:
        raise WebpDecodeError(f"a {features.width}x{features.height} WebP: over {MAX_PIXELS} "
                              "pixels, a decompression bomb")
    dmux = _demux(data)
    frame = next(f for f in dmux.frames if f.frame_num == 1)
    # GetFramePayload: the ALPH chunk (and what lies between) and the bitstream's chunk
    start, size = frame.image
    if frame.alpha[1] > 0:
        start, size = frame.alpha[0], size + frame.alpha[1] + (
            frame.image[0] - (frame.alpha[0] + frame.alpha[1]))
    fragment = data[start:start + size]
    if _parse_headers(fragment, False).status != _OK:
        raise WebpDecodeError("malformed WebP: frame 0's headers do not parse")
    hdrs = _parse_headers(fragment, True)
    if hdrs.status != _OK or hdrs.animation:
        raise WebpDecodeError("malformed WebP: frame 0's bitstream is cut short")
    alpha = None
    if hdrs.alpha is not None:
        alpha = fragment[hdrs.alpha[0]:hdrs.alpha[0] + hdrs.alpha[1]]
    return Frame0(dmux.canvas, (frame.x_offset, frame.y_offset), (hdrs.width, hdrs.height),
                  hdrs.lossless, fragment[hdrs.offset:], alpha)


def decode_webp_rgba(data: bytes) -> np.ndarray:
    """uint8 ``[h, w, 4]`` RGBA of the canvas after frame 0, as libwebp's
    ``WebPAnimDecoder`` gives it to PIL (an image without alpha reads 255)."""
    f = locate_frame0(data)
    (width, height), (x0, y0) = f.size, f.offset
    rgba = np.empty((height, width, 4), np.uint8)
    bits = np.frombuffer(f.bitstream, np.uint8)
    alpha = None if f.alpha is None else np.frombuffer(f.alpha, np.uint8)
    rc = _lib().vtc_webp_decode(bits.ctypes.data_as(_U8P), bits.size, int(f.lossless),
                                None if alpha is None else alpha.ctypes.data_as(_U8P),
                                0 if alpha is None else alpha.size, width, height,
                                rgba.ctypes.data_as(_U8P))
    if rc != 0:
        raise WebpDecodeError(f"broken WebP: {DECODE_ERRORS.get(rc, f'error {rc}')}")
    if f.canvas == f.size:
        return rgba
    canvas = np.zeros((f.canvas[1], f.canvas[0], 4), np.uint8)
    canvas[y0:y0 + height, x0:x0 + width] = rgba
    return canvas


def decode_webp(data: bytes) -> np.ndarray:
    """uint8 ``[h, w, 3]`` RGB of the WebP bytes ``data``, as
    ``Image.open(...).convert("RGB")`` gives it."""
    return np.ascontiguousarray(decode_webp_rgba(data)[..., :3])
