"""Decode an RGB image: ``read_rgb(path, device)``, ``decode_rgb(data,
device)``.

The JAX package opens its images with ``PIL.Image.open(...).convert(
"RGB")``. The port has two routes, and the device the caller names picks
one; nothing switches between them quietly:

* the card (``device`` None or CUDA): a JPEG is decoded by nvJPEG into its
  planes on the card (``csrc/jpeg_decode.cu``), and the kernel
  ``ycc_to_rgb`` upsamples each plane and converts to RGB as libjpeg-turbo
  does (the integer tables of ``jdcolor.c``), so only nvJPEG's IDCT sets the
  pixels apart from PIL's. Each plane is upsampled by its own ratio, the
  largest sampling factors over its own, by the method libjpeg-turbo's
  ``jinit_upsampler`` picks: "fancy" 2 x 1, 1 x 2 and 2 x 2, the box for a
  plane at most 2 samples wide at 2 x 1 and 2 x 2 and for every other whole
  ratio (``int_upsample``). 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and 4:1:0
  come through nvJPEG's YUV output, every other sampling through its planes
  as coded: Cb and Cr sampled apart, a luma sampled below the chroma, 1 x 4
  or 3 x 1, a K plane sampled otherwise than the first. A plane sampled by a
  fraction of the largest factors is refused from the header, as
  libjpeg-turbo refuses it (``JERR_FRACT_SAMPLE_NOTIMPL``). A grayscale JPEG
  is decoded as its luma plane and repeated into three equal channels, as
  ``convert("RGB")`` does. A JPEG coded in RGB (an Adobe segment with
  colour transform 0, or the component ids R, G, B without a JFIF or Adobe
  segment: libjpeg-turbo's ``default_decompress_parms``) takes the same
  upsampling without the colour matrix: its planes are R, G and B. A
  4-component JPEG is converted as PIL converts it: CMYK planes, stored
  inverted by Adobe's convention, or YCCK ones, whose Y, Cb and Cr go
  through the YCbCr tables first (libjpeg-turbo's ``ycck_cmyk_convert``),
  then PIL's ``cmyk2rgb``. What fails to decode raises ``JpegDecodeError``
  (nvJPEG's refusal named by its status), and no other decoder stands in;
  an image of more than ``MAX_PIXELS`` pixels is refused from its header,
  before anything is allocated, as PIL refuses it. A PNG, a GIF, a BMP and a
  WebP are decoded on the host, by ``png.decode_png``, ``gif.decode_gif``,
  ``bmp.decode_bmp`` and ``webp.decode_webp``, each PIL's pixels bit for
  bit (the other formats PIL reads raise ``JpegInputError``);
* the CPU (``device="cpu"``): PIL, imported in the function, as the JAX
  package does.

A fault of the bytes themselves (not an image the route decodes, a
malformed file, a kind of image refused by name) raises an
``ImageInputError``: ``JpegInputError``, ``png.PngDecodeError``,
``gif.GifDecodeError``, ``bmp.BmpDecodeError``, ``webp.WebpDecodeError``,
or PIL's error wrapped on the CPU route. Every other error (a binding that
does not build or load, a failed launch, the card's own errors) is the
program's, and is not an ``ImageInputError``.

``ycc_to_rgb`` is the kernel's wrapper: on CUDA tensors it launches the
kernel and counts the launch in ``ycc_to_rgb.launches``; on CPU tensors it
runs ``ycc_to_rgb_reference``, the same integer math in torch. Neither
route applies the EXIF orientation; ``Image.open`` does not either.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Optional, Tuple

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
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# jdcolor.c's build_ycc_rgb_table: FIX(x) = int(x * 2**16 + 0.5), ONE_HALF
_CR_R, _CB_B, _CR_G, _CB_G, _HALF = 91881, 116130, 46802, 22554, 1 << 15
# the chroma's upsampling (hf, vf) of the samplings nvJPEG's YUV output takes
# (4:4:4, 4:2:2, 4:4:0, 4:2:0, 4:1:1, 4:1:0: the luma full size, Cb and Cr
# alike); every other sampling is decoded as coded (NVJPEG_OUTPUT_UNCHANGED)
FACTORS = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2))
# PIL refuses an image of more pixels as a decompression bomb (twice its
# Image.MAX_IMAGE_PIXELS), at open; so do the port's JPEG and PNG decoders,
# from the header, before they allocate anything
MAX_PIXELS = 2 * 89_478_485

_local = threading.local()  # each thread's decode stream


class ImageInputError(ValueError):
    """The image bytes are at fault: not an image of a format the route
    decodes, malformed, or of a kind the route refuses by name."""


class JpegDecodeError(RuntimeError):
    """The card's JPEG route failed: its binding could not be built or
    loaded, nvJPEG or the kernel failed, or (``JpegInputError``) the bytes
    are at fault."""


class JpegInputError(JpegDecodeError, ImageInputError):
    """A JPEG that nvJPEG finds malformed, or one that the card's route
    cannot decode as PIL does and refuses by name."""


# nvJPEG's statuses that the bitstream causes: BAD_JPEG, JPEG_NOT_SUPPORTED,
# INCOMPLETE_BITSTREAM
_INPUT_STATUSES = {3, 4, 10}


def jpeg_header(data: bytes) -> dict:
    """What the markers before the first scan say: ``width``, ``height``
    and ``components`` (the frame header's), ``sampling`` (each
    component's (horizontal, vertical) sampling factors), ``subsampled`` (a
    component sampled otherwise than the first), ``progressive`` (a SOF2
    frame), ``adobe_transform`` (the APP14 "Adobe" segment's colour
    transform, None without one), ``jfif`` (an APP0 "JFIF" segment),
    ``component_ids`` and ``rgb``: a 3-component image coded in RGB, as
    libjpeg-turbo decides it (``jdapimin.c:default_decompress_parms``: JFIF
    means YCbCr, else Adobe transform 0 means RGB, else the ids R, G, B);
    ``ycck``: a 4-component image coded in YCCK (an Adobe segment of a
    transform other than 0; without one, CMYK)."""
    if data[:2] != b"\xff\xd8":
        raise JpegInputError("not a JPEG (no SOI marker)")
    info = {"width": None, "height": None, "components": None, "sampling": None,
            "subsampled": False, "progressive": False, "adobe_transform": None,
            "jfif": False, "component_ids": None}
    i = 2
    while i + 4 <= len(data):
        if data[i] != 0xFF:
            raise JpegInputError(f"corrupt JPEG: no marker at byte {i}")
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
        if marker in _SOF_MARKERS:
            if len(seg) < 6 or len(seg) < 6 + 3 * seg[5]:
                raise JpegInputError(f"corrupt JPEG: a truncated frame header ({len(seg)} "
                                     "bytes)")
            info["height"] = int.from_bytes(seg[1:3], "big")
            info["width"] = int.from_bytes(seg[3:5], "big")
            info["components"] = seg[5]
            info["sampling"] = [(b >> 4, b & 15) for b in seg[7 : 6 + 3 * seg[5] : 3]]
            info["component_ids"] = list(seg[6 : 6 + 3 * seg[5] : 3])
            if not all(1 <= f <= 4 for s in info["sampling"] for f in s):
                raise JpegInputError(f"corrupt JPEG: sampling factors {info['sampling']} "
                                     "outside 1-4")
            info["subsampled"] = len(set(info["sampling"])) > 1
            info["progressive"] = marker in (0xC2, 0xC6, 0xCA, 0xCE)
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            info["adobe_transform"] = seg[11]
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            info["jfif"] = True
        i += 2 + length
    if info["components"] is None:
        raise JpegInputError("corrupt JPEG: no frame header before the first scan")
    info["rgb"] = info["components"] == 3 and not info["jfif"] and (
        info["adobe_transform"] == 0 if info["adobe_transform"] is not None
        else info["component_ids"] == list(b"RGB"))
    info["ycck"] = info["components"] == 4 and info["adobe_transform"] not in (None, 0)
    return info


def upsampling_factors(sampling, path="<bytes>") -> Tuple[Tuple[int, int], ...]:
    """``(hf, vf)`` of each component: how many times libjpeg-turbo's
    ``jinit_upsampler`` upsamples its plane across and down, the largest
    sampling factors over its own. A ratio that is not a whole number raises
    ``JpegInputError`` from the header, as libjpeg-turbo raises
    ``JERR_FRACT_SAMPLE_NOTIMPL`` (and PIL with it)."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    if any(hmax % h or vmax % v for h, v in sampling):
        raise JpegInputError(
            f"{path}: sampling factors {sampling}: a plane upsampled by a fraction, which "
            "libjpeg-turbo does not implement either (JERR_FRACT_SAMPLE_NOTIMPL)")
    return tuple((hmax // h, vmax // v) for h, v in sampling)


def plane_factors(factors, n: int) -> Tuple[Tuple[int, int], ...]:
    """Each of ``n`` planes' ``(hf, vf)``: ``factors`` as given, one pair a
    plane, or a single pair, the chroma's, with the luma and K full size."""
    if len(factors) == 2 and all(isinstance(f, int) for f in factors):
        return ((1, 1),) + (tuple(factors),) * 2 + ((1, 1),) * (n - 3)
    if len(factors) != n:
        raise ValueError(f"{len(factors)} upsampling factors for {n} planes")
    return tuple(tuple(int(x) for x in f) for f in factors)


def _image_size(planes, factors, size) -> Tuple[int, int]:
    """``(h, w)``: ``size``, or the shape of the first plane not upsampled."""
    if size is not None:
        return tuple(size)
    for p, f in zip(planes, factors):
        if f == (1, 1):
            return tuple(p.shape)
    raise ValueError(f"no plane of {factors} is full size: the image size must be given")


def _check_planes(planes, factors, h: int, w: int) -> None:
    """Each plane is the size libjpeg-turbo gives it: the image's divided by
    its factors, rounded up."""
    if any(hf < 1 or vf < 1 or tuple(p.shape) != (-(-h // vf), -(-w // hf))
           for p, (hf, vf) in zip(planes, factors)):
        raise ValueError(f"planes {[tuple(p.shape) for p in planes]} upsampled by {factors} "
                         f"do not cover the image {(h, w)}")


def _upsample_reference(plane: torch.Tensor, hf: int, vf: int) -> torch.Tensor:
    """libjpeg-turbo's upsampling of one plane (int32 ``[ch, cw]`` ->
    ``[vf·ch, hf·cw]``) as ``jinit_upsampler`` picks it: ``h2v1_fancy_upsample``
    (2 x 1), ``h1v2_fancy_upsample`` (1 x 2) and ``h2v2_fancy_upsample`` (2 x
    2) (``jdsample.c``), the edge sample standing in for the missing
    neighbour at every border (``jdmainct.c``'s context rows at the top and
    bottom); a plane at most 2 samples wide upsampled 2 x 1 or 2 x 2 is
    box-replicated (``h2v1_upsample``, ``h2v2_upsample``), and so is every
    other whole ratio (``int_upsample``: 4 x 1, 4 x 2, 1 x 4, 3 x 1 ...)."""
    ch, cw = plane.shape
    if (hf, vf) == (1, 1):
        return plane
    if not ((hf, vf) == (1, 2) or ((hf, vf) in ((2, 1), (2, 2)) and cw > 2)):
        return plane.repeat_interleave(vf, 0).repeat_interleave(hf, 1)

    def interleave(a, b, dim):  # a, b, a, b ... along dim
        return torch.stack([a, b], dim + 1).flatten(dim, dim + 1)

    if vf == 2:  # the nearer row weighted 3, the row above for even output rows
        above = torch.cat([plane[:1], plane[:-1]])
        below = torch.cat([plane[1:], plane[-1:]])
        if hf == 1:
            return interleave((3 * plane + above + 1) >> 2, (3 * plane + below + 2) >> 2, 0)
        sums = interleave(3 * plane + above, 3 * plane + below, 0)
        left = torch.cat([sums[:, :1], sums[:, :-1]], 1)
        right = torch.cat([sums[:, 1:], sums[:, -1:]], 1)
        return interleave((3 * sums + left + 8) >> 4, (3 * sums + right + 7) >> 4, 1)
    left = torch.cat([plane[:, :1], plane[:, :-1]], 1)
    right = torch.cat([plane[:, 1:], plane[:, -1:]], 1)
    return interleave((3 * plane + left + 1) >> 2, (3 * plane + right + 2) >> 2, 1)


def ycc_to_rgb_reference(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor,
                         factors, transform: bool = True, k: Optional[torch.Tensor] = None,
                         size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The plain version of the ``ycc_to_rgb`` kernel on CPU tensors: uint8
    planes Y, Cb, Cr (and K), each sampled ``(hf, vf)`` times below the image
    (``factors``: a pair a plane, or one pair for Cb and Cr with the luma
    and K full size) -> uint8 ``[h, w, 3]`` RGB, ``size = (h, w)`` by
    default the shape of the first plane not upsampled. Each plane is
    upsampled as libjpeg-turbo does (``_upsample_reference``), cropped to
    ``w x h``, and converted with ``jdcolor.c``'s integer tables
    (``SCALEBITS`` 16), clamped to 0-255. With ``transform`` False (a JPEG
    coded in RGB) the three planes are R, G and B: upsampled and cropped
    alike, with no colour matrix (``jdcolor.c:rgb_rgb_convert``). With a
    fourth plane ``k`` the image is CMYK (``transform`` False: the planes
    are Adobe's inverted C, M, Y) or YCCK (True: the YCbCr tables give 255
    minus C, M, Y, as ``ycck_cmyk_convert``), and PIL's ``cmyk2rgb`` makes
    RGB: ``K - K·c/255`` in its integer rounding."""
    planes = (y, cb, cr) + (() if k is None else (k,))
    factors = plane_factors(factors, len(planes))
    h, w = _image_size(planes, factors, size)
    _check_planes(planes, factors, h, w)
    up = [_upsample_reference(p.to(torch.int32), hf, vf)[:h, :w]
          for p, (hf, vf) in zip(planes, factors)]
    luma = up[0]
    if transform:
        dcb, dcr = up[1] - 128, up[2] - 128
        rgb = torch.stack([luma + ((_CR_R * dcr + _HALF) >> 16),
                           luma + ((-_CB_G * dcb + _HALF - _CR_G * dcr) >> 16),
                           luma + ((_CB_B * dcb + _HALF) >> 16)], -1).clamp(0, 255)
    else:
        rgb = torch.stack(up[:3], -1)
    if k is not None:
        kk = up[3][..., None]
        # PIL's C, M, Y: the inverted planes of a CMYK JPEG, the converted
        # ones of a YCCK JPEG; PIL's K: 255 minus the plane, so nk is the plane
        c = rgb if transform else 255 - rgb
        tmp = c * kk + 128
        rgb = (kk - (((tmp >> 8) + tmp) >> 8)).clamp(0, 255)
    return rgb.to(torch.uint8)


class _Plane(ctypes.Structure):
    """``csrc/jpeg_decode.cu``'s ``Plane``: a uint8 plane on the card and
    how many times it is upsampled across and down."""
    _fields_ = [("p", ctypes.c_void_p), ("pitch", ctypes.c_int), ("w", ctypes.c_int),
                ("h", ctypes.c_int), ("hf", ctypes.c_int), ("vf", ctypes.c_int)]


def _lib():
    """The nvJPEG binding and the ``ycc_to_rgb`` kernel; a toolkit without
    nvJPEG, or a failed build or link, raises ``JpegDecodeError``, not an
    input error (the model kernels are built apart and stay usable)."""
    try:
        lib = _build.load_library("jpeg_decode")
    except (RuntimeError, OSError) as e:
        raise JpegDecodeError(f"the nvJPEG binding csrc/jpeg_decode.cu could not be "
                              f"built or loaded: {e}") from e
    if lib.vtc_jpeg_decode.argtypes is None:
        p, i, size = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        ip = ctypes.POINTER(i)
        lib.vtc_jpeg_info.argtypes = [ctypes.c_char_p, size, ip, ip]
        lib.vtc_jpeg_decode.argtypes = [ctypes.c_char_p, size, i, i, p, size, p, size, p, size,
                                        p, size, p]
        lib.vtc_ycc_to_rgb.argtypes = [ctypes.POINTER(_Plane), i, i, i, i, p, i, p]
        lib.vtc_jpeg_info.restype = lib.vtc_jpeg_decode.restype = i
        lib.vtc_ycc_to_rgb.restype = i
    return lib


def _check(rc: int, what: str, path) -> None:
    """Raise for a failed nvJPEG call: ``JpegInputError`` where the
    bitstream is at fault, else ``JpegDecodeError``."""
    if rc == 0:
        return
    name = (f"cudaError {rc - 1000}" if rc >= 1000
            else f"NVJPEG_STATUS_{NVJPEG_STATUS.get(rc, rc)}")
    error = JpegInputError if rc in _INPUT_STATUSES else JpegDecodeError
    raise error(f"{path}: nvJPEG {what} failed with {name}")


def ycc_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, factors,
               transform: bool = True, k: Optional[torch.Tensor] = None,
               size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """uint8 ``[h, w, 3]`` RGB from the Y, Cb and Cr planes (uint8, rows
    contiguous), each upsampled ``(hf, vf)`` times (``factors``, as
    ``ycc_to_rgb_reference`` takes them): the CUDA kernel of
    ``csrc/jpeg_decode.cu`` on CUDA tensors, on the current stream;
    ``ycc_to_rgb_reference`` on CPU tensors. With ``transform`` False the
    planes are R, G and B (a JPEG coded in RGB): the same upsampling, no
    colour matrix; a fourth plane ``k`` makes the image CMYK or YCCK, as
    ``ycc_to_rgb_reference`` says."""
    if y.device.type == "cpu":
        return ycc_to_rgb_reference(y, cb, cr, factors, transform, k, size)
    planes = (y, cb, cr) + (() if k is None else (k,))
    factors = plane_factors(factors, len(planes))
    h, w = _image_size(planes, factors, size)
    for name, t in zip(("y", "cb", "cr", "k"), planes):
        if t.device != y.device or t.dtype != torch.uint8 or t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"ycc_to_rgb: {name} must be a uint8 [rows, cols] plane with "
                             f"contiguous rows on {y.device}")
    _check_planes(planes, factors, h, w)
    args = (_Plane * 4)(*(_Plane(t.data_ptr(), t.stride(0), t.shape[1], t.shape[0], *f)
                          for t, f in zip(planes, factors)))
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    mode = int(bool(transform)) + (2 if k is not None else 0)
    with torch.cuda.device(y.device):
        err = _lib().vtc_ycc_to_rgb(args, len(planes), w, h, mode, out.data_ptr(),
                                    out.stride(0),
                                    torch.cuda.current_stream(y.device).cuda_stream)
    _build.check_launch(err, "ycc_to_rgb")
    ycc_to_rgb.launches += 1
    return out


def planes_to_rgb(planes, factors, transform: bool = True, reference: bool = False,
                  size: Optional[Tuple[int, int]] = None):
    """``ycc_to_rgb`` (or its plain version) of ``decode_jpeg_planes``'s
    three or four colour planes."""
    fn = ycc_to_rgb_reference if reference else ycc_to_rgb
    return fn(*planes[:3], factors, transform, planes[3] if len(planes) == 4 else None, size)


ycc_to_rgb.launches = 0


def _decode_stream(device: torch.device) -> torch.cuda.Stream:
    stream = getattr(_local, "stream", None)
    if stream is None or stream.device != device:
        stream = _local.stream = torch.cuda.Stream(device)
    return stream


def decode_jpeg_planes(data: bytes, device: Optional[torch.device] = None, path="<bytes>"):
    """nvJPEG's decode of the JPEG bytes ``data`` before colour conversion:
    ``(planes, factors, transform)`` with the uint8 planes on the card at
    their own sizes (Y, Cb and Cr; R, G and B where ``transform`` is False:
    a JPEG coded in RGB; C, M, Y and K (``transform`` False) or Y, Cb, Cr
    and K (True) for a 4-component one) and each plane's upsampling ``(hf,
    vf)`` (``upsampling_factors``); or the luma alone and None for a
    grayscale JPEG (``planes_to_rgb`` converts them; where no plane is full
    size it is given the header's size). The six samplings nvJPEG's YUV
    output takes are decoded through it; every other one as coded
    (``NVJPEG_OUTPUT_UNCHANGED``, as 4-component images are). The planes are
    allocated on, and decoded on, the calling thread's decode stream, and the
    call returns when the decode has finished. An image of more than
    ``MAX_PIXELS`` pixels, or a plane upsampled by a fraction, raises
    ``JpegInputError`` before the binding is called."""
    header = jpeg_header(data)
    if header["width"] * header["height"] > MAX_PIXELS:
        raise JpegInputError(
            f"{path}: a {header['width']}x{header['height']} JPEG: over {MAX_PIXELS} pixels, "
            "a decompression bomb")
    n = header["components"]
    if n not in (1, 3, 4):
        raise JpegInputError(f"{path}: a {n}-component JPEG: PIL reads 1, 3 or 4")
    factors = upsampling_factors(header["sampling"], path) if n > 1 else None
    lib = _lib()
    # nvJPEG and the planes on ``device`` whichever card the calling thread (a
    # loader's worker) would pick; None: that card
    with contextlib.nullcontext() if device is None else torch.cuda.device(device):
        return _decode_planes(lib, data, header, n, factors, device, path)


# nvJPEG's output formats, as vtc_jpeg_decode numbers them
_OUTPUT_Y, _OUTPUT_YUV, _OUTPUT_UNCHANGED = 0, 1, 2


def plane_shapes(header: dict, factors) -> list:
    """``(rows, cols)`` of each component's plane as libjpeg-turbo sizes it
    (``downsampled_width``, ``downsampled_height``): the image's divided by
    the plane's upsampling factors, rounded up."""
    h, w = header["height"], header["width"]
    return [(-(-h // vf), -(-w // hf)) for hf, vf in factors]


def _decode_planes(lib, data, header, n, factors, device, path):
    widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
    _check(lib.vtc_jpeg_info(data, len(data), widths, heights), "image info", path)
    sizes = [(heights[0], widths[0])] if factors is None else plane_shapes(header, factors)
    if factors is not None:
        got = [(heights[c], widths[c]) for c in range(n)]
        if got != sizes:
            raise JpegDecodeError(f"{path}: nvJPEG's planes {got} are not the sizes the "
                                  f"header's sampling gives, {sizes}")
    yuv = n == 3 and factors[0] == (1, 1) and factors[1] == factors[2] and factors[1] in FACTORS
    output = _OUTPUT_Y if n == 1 else _OUTPUT_YUV if yuv else _OUTPUT_UNCHANGED
    device = torch.device("cuda", torch.cuda.current_device()) if device is None else device
    stream = _decode_stream(device)
    with torch.cuda.stream(stream):
        planes = [torch.empty(s, dtype=torch.uint8, device=device) for s in sizes]
        ptrs = [(t.data_ptr(), t.stride(0)) for t in planes] + [(None, 0)] * (4 - len(planes))
        what = "progressive decode" if header["progressive"] else "decode"
        _check(lib.vtc_jpeg_decode(data, len(data), len(planes), output, *ptrs[0], *ptrs[1],
                                   *ptrs[2], *ptrs[3], stream.cuda_stream), what, path)
    transform = header["ycck"] if n == 4 else not header["rgb"]
    return planes, factors, transform


def decode_jpeg(data: bytes, device: Optional[torch.device] = None, path="<bytes>"
                ) -> torch.Tensor:
    """uint8 ``[h, w, 3]`` RGB on the card from the JPEG bytes ``data``:
    nvJPEG's planes through the ``ycc_to_rgb`` kernel, on the calling
    thread's decode stream (the caller reads the result on that stream, as
    ``decode_rgb`` does)."""
    planes, factors, transform = decode_jpeg_planes(data, device, path)
    with torch.cuda.stream(_local.stream):
        if factors is None:
            return planes[0][..., None].expand(-1, -1, 3).contiguous()
        header = jpeg_header(data)
        return planes_to_rgb(planes, factors, transform, size=(header["height"],
                                                                header["width"]))


def decode_rgb(data: bytes, device=None, path="<bytes>") -> np.ndarray:
    """uint8 ``[h, w, 3]`` RGB of the encoded image ``data``, on the host:
    on the card (default; raises without one) a JPEG by ``decode_jpeg``, and
    on the host a PNG by ``png.decode_png``, a GIF by ``gif.decode_gif``, a
    BMP by ``bmp.decode_bmp`` and a RIFF WebP by ``webp.decode_webp`` (told
    apart by their magic bytes), any other format raising
    ``JpegInputError``; by PIL where ``device`` is the CPU, whose errors
    (PIL reading the bytes) are raised as ``ImageInputError``."""
    device = resolve_device(device)
    if device.type == "cpu":
        import io

        from PIL import Image

        try:
            with Image.open(io.BytesIO(data)) as img:
                return np.asarray(img.convert("RGB"))
        except Exception as e:  # noqa: BLE001 - all of it is PIL reading the bytes
            raise ImageInputError(f"{path}: PIL cannot decode the image: {e}") from e
    if data[:8] == PNG_SIGNATURE:
        from .png import decode_png

        return decode_png(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        from .gif import decode_gif

        return decode_gif(data)
    if data[:2] == b"BM":
        from .bmp import decode_bmp

        return decode_bmp(data)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        from .webp import decode_webp

        return decode_webp(data)
    img = decode_jpeg(data, device if device.index is not None else None, path)
    with torch.cuda.stream(_local.stream):
        return img.cpu().numpy()


def read_rgb(path, device=None) -> np.ndarray:
    """uint8 ``[h, w, 3]`` RGB of the image file at ``path``, on the host:
    ``decode_rgb`` of its bytes."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_rgb(data, device, path)
