"""The port's image data path (vtc_tpu_torch.data) against the JAX package's
(vtc_tpu.data), on the CPU, from the same files made with numpy from a seed.

* ``read_csv`` against ``pd.read_csv``: each column's ``tolist()`` equal
  (NaN where pandas has NaN) and its kind of dtype, on quoted commas and
  newlines, unicode, empty/"NA"/"None" titles, int and base-36 ids, int
  and float lengths, "[]" comments; a title that pandas reads as NaN makes
  both packages' items raise the same ``TypeError``.
* ``partition_dataframe``, ``filter_by_k_comments`` (with ``limit``: the
  rows and their order), ``preprocess_comments`` with a seeded generator,
  ``load_features`` (``.npz`` and ``.pth``, plain and comment formats):
  equal.
* The resampler bit-exact against ``PIL.Image.resize`` (bicubic and
  bilinear: up- and downscales, odd sizes, 1-pixel sides, very wide and
  very tall images); ``clip_preprocess``, ``clip_resize_uint8``,
  ``augment_frames`` and ``augment_image`` bit-exact against JAX's with the
  same seed.
* ``ImTextDataset`` items (``device="cpu"``, PIL's decode) against
  ``vtc_tpu``'s: images bit-exact, tokens, ids and sampled comments equal,
  for the float, ``uint8_images`` and ``patch_images`` outputs with and
  without augmentation, ``add_comments`` always/train_only/never,
  ``test_on_over_k_comms`` with ``test_set_limit``, cached vision and audio
  features, an over-long title (RAKE); ``FeaturesDataset`` items; the
  loader's batches over both datasets.
* The JPEG fixtures of ``tests/data/jpeg`` (made by ``make_jpeg_fixtures``:
  PIL's and OpenCV's encoders, and libjpeg-turbo's through a shim built at
  run time for six samplings they do not write) and their committed PIL
  decodes; ``read_rgb`` on the card against them (``cuda``-marked) at
  ``chip_smoke.py``'s bound.

Exact equality throughout, but for nvJPEG on the card (the bound below).
"""

import ast
import csv
import io
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from vtc_tpu_torch.data import DataLoader, datasets, image_io, partition, preprocess
from vtc_tpu_torch.data.resample import resize
from vtc_tpu_torch.data.table import read_csv
from vtc_tpu_torch.ops import _build

try:  # the references; the machine with the card has none of them and runs
    # only the cuda-marked test (python -m pytest ... -m cuda --noconftest)
    import pandas as pd
    from PIL import Image

    from vtc_tpu.data import datasets as jax_datasets
    from vtc_tpu.data import partition as jax_partition
    from vtc_tpu.data import preprocess as jax_pre
    from vtc_tpu.data.loader import DataLoader as JaxDataLoader
except ImportError:
    pd = Image = jax_datasets = jax_partition = jax_pre = JaxDataLoader = None

JPEG_DIR = Path(__file__).resolve().parent / "data" / "jpeg"
BASE36 = "0123456789abcdefghijklmnopqrstuvwxyz"
# the card's decode against PIL, mean |d| in levels: per channel on every
# image (nvJPEG's IDCT, then libjpeg-turbo's chroma upsampling and colour
# conversion in a kernel: chip_smoke.py's DECODE_MEAN_MAX), of the luma too
# where the chroma is subsampled, and per channel of a subsampled image to a
# ceiling that a lost, swapped or misplaced chroma plane exceeds
# (SUBSAMPLED_CHANNEL_MEAN_MAX)
DECODE_MEAN_MAX = 1.5
SUBSAMPLED_CHANNEL_MEAN_MAX = 6.0

JPEG_FIXTURES = {  # name: (width, height, PIL save options, mode)
    "rgb420_480x360": (480, 360, {"quality": 90}, "RGB"),
    "odd_211x97": (211, 97, {"quality": 85}, "RGB"),
    "rgb444_160x120": (160, 120, {"quality": 92, "subsampling": 0}, "RGB"),
    "gray_200x150": (200, 150, {"quality": 90}, "L"),
    "progressive_240x180": (240, 180, {"quality": 88, "progressive": True}, "RGB"),
    # written by OpenCV: PIL's encoder writes no 4:1:1
    "rgb411_94x64": (94, 64, {"quality": 90, "opencv_sampling": "411"}, "RGB"),
    # coded in RGB: an Adobe segment with colour transform 0, the planes R, G, B
    "adobergb444_96x64": (96, 64, {"quality": 90, "subsampling": 0, "keep_rgb": True}, "RGB"),
    # PIL's encoder refuses a subsampled RGB JPEG: a 4:2:0 one's JFIF segment
    # replaced by an Adobe segment of transform 0, so R is the full plane and
    # G and B the subsampled ones
    "adobergb420_98x66": (98, 66, {"quality": 90, "adobe_rgb": True}, "RGB"),
    # 4 components: CMYK as PIL writes it (Adobe transform 0, inverted planes),
    # and YCCK, which no encoder here writes: a CMYK one's transform set to 2
    "cmyk_96x64": (96, 64, {"quality": 90}, "CMYK"),
    "ycck_96x64": (96, 64, {"quality": 90, "ycck": True}, "CMYK"),
    # written by libjpeg-turbo itself (jpeg_set_defaults, then each
    # component's sampling factors): samplings PIL's and OpenCV's encoders do
    # not write, each decoded by PIL through jinit_upsampler's per-plane rule
    "sampling_y1x4_96x61": (96, 61, {"quality": 90, "libjpeg_sampling": [(1, 4), (1, 1),
                                                                        (1, 1)]}, "RGB"),
    "sampling_y3x1_97x40": (97, 40, {"quality": 90, "libjpeg_sampling": [(3, 1), (1, 1),
                                                                        (1, 1)]}, "RGB"),
    # Cb upsampled 2 x 2, Cr 1 x 2
    "sampling_cb_cr_apart_99x65": (99, 65, {"quality": 90, "libjpeg_sampling": [
        (2, 2), (1, 1), (2, 1)]}, "RGB"),
    # the luma upsampled 2 x 2 under full-size chroma
    "sampling_luma_below_93x61": (93, 61, {"quality": 90, "libjpeg_sampling": [
        (1, 1), (2, 2), (2, 2)]}, "RGB"),
    # no plane full size: the luma 1 x 2, the chroma 2 x 1
    "sampling_no_full_plane_90x58": (90, 58, {"quality": 90, "libjpeg_sampling": [
        (2, 1), (1, 2), (1, 2)]}, "RGB"),
    # K at 1 x 1 under C at 2 x 2: K and M, Y upsampled 2 x 2
    "cmyk_k1x1_97x63": (97, 63, {"quality": 90, "libjpeg_sampling": [
        (2, 2), (1, 1), (1, 1), (1, 1)]}, "CMYK"),
}
# libjpeg-turbo, through a shim compiled at run time: a writer with each
# component's sampling factors set, and the raw planes of a decode
# (jpeg_read_raw_data: the IDCT's output before upsampling)
LIBJPEG_SHIM = r"""
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>

struct guard { struct jpeg_error_mgr pub; jmp_buf jump; };
static void on_error(j_common_ptr c) { longjmp(((struct guard*)c->err)->jump, 1); }

int shim_write(const unsigned char* pix, int w, int h, int ncomp, const int* hv, int quality,
               unsigned char** out, unsigned long* size) {
  struct jpeg_compress_struct c;
  struct guard g;
  int i;
  c.err = jpeg_std_error(&g.pub);
  g.pub.error_exit = on_error;
  if (setjmp(g.jump)) { jpeg_destroy_compress(&c); return -1; }
  jpeg_create_compress(&c);
  *out = NULL;
  *size = 0;
  jpeg_mem_dest(&c, out, size);
  c.image_width = w;
  c.image_height = h;
  c.input_components = ncomp;
  c.in_color_space = ncomp == 4 ? JCS_CMYK : JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, quality, TRUE);
  for (i = 0; i < ncomp; ++i) {
    c.comp_info[i].h_samp_factor = hv[2 * i];
    c.comp_info[i].v_samp_factor = hv[2 * i + 1];
  }
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = (JSAMPROW)(pix + (size_t)c.next_scanline * w * ncomp);
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  return 0;
}

/* Each component's plane, cropped to its downsampled size, one after the
   other into `planes`; `dims` gets each one's width and height. */
int shim_raw(const unsigned char* data, unsigned long n, unsigned char* planes, int* dims,
             int capacity) {
  struct jpeg_decompress_struct d;
  struct guard g;
  JSAMPARRAY rows[4];
  JSAMPIMAGE image = rows;
  int ci, total = 0, done = 0;
  d.err = jpeg_std_error(&g.pub);
  g.pub.error_exit = on_error;
  if (setjmp(g.jump)) { jpeg_destroy_decompress(&d); return -1; }
  jpeg_create_decompress(&d);
  jpeg_mem_src(&d, data, n);
  jpeg_read_header(&d, TRUE);
  d.raw_data_out = TRUE;
  jpeg_start_decompress(&d);
  int mcu_rows = d.max_v_samp_factor * DCTSIZE;
  for (ci = 0; ci < d.num_components; ++ci) {
    jpeg_component_info* comp = &d.comp_info[ci];
    int stride = comp->width_in_blocks * DCTSIZE;
    rows[ci] = (*d.mem->alloc_sarray)((j_common_ptr)&d, JPOOL_IMAGE, stride,
                                      comp->v_samp_factor * DCTSIZE);
    dims[2 * ci] = comp->downsampled_width;
    dims[2 * ci + 1] = comp->downsampled_height;
    total += comp->downsampled_width * comp->downsampled_height;
  }
  if (total > capacity) { jpeg_destroy_decompress(&d); return -2; }
  while (d.output_scanline < d.output_height) {
    jpeg_read_raw_data(&d, image, mcu_rows);
    unsigned char* dst = planes;
    for (ci = 0; ci < d.num_components; ++ci) {
      jpeg_component_info* comp = &d.comp_info[ci];
      int r, rows_here = comp->v_samp_factor * DCTSIZE;
      int first = done / d.max_v_samp_factor * comp->v_samp_factor;
      for (r = 0; r < rows_here && first + r < (int)comp->downsampled_height; ++r) {
        memcpy(dst + (size_t)(first + r) * comp->downsampled_width, rows[ci][r],
               comp->downsampled_width);
      }
      dst += (size_t)comp->downsampled_width * comp->downsampled_height;
    }
    done += mcu_rows;
  }
  jpeg_finish_decompress(&d);
  jpeg_destroy_decompress(&d);
  return d.num_components;
}

void shim_free(void* p) { free(p); }
"""


def libjpeg_shim(build_dir):
    """The shim built against the system's libjpeg-turbo (``jpeglib.h``,
    ``-ljpeg``), or None where either is missing."""
    import ctypes
    import shutil
    import subprocess

    gcc = shutil.which("gcc")
    if gcc is None:
        return None
    src, lib = Path(build_dir) / "jpeg_shim.c", Path(build_dir) / "libjpeg_shim.so"
    src.write_text(LIBJPEG_SHIM)
    if subprocess.run([gcc, "-O2", "-shared", "-fPIC", "-o", str(lib), str(src), "-ljpeg"],
                      capture_output=True).returncode != 0:
        return None
    shim = ctypes.CDLL(str(lib))
    shim.shim_write.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                                ctypes.POINTER(ctypes.c_void_p),
                                ctypes.POINTER(ctypes.c_ulong)]
    shim.shim_raw.argtypes = [ctypes.c_char_p, ctypes.c_ulong, ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    shim.shim_free.argtypes = [ctypes.c_void_p]
    return shim


def libjpeg_write(shim, pixels: np.ndarray, sampling, quality: int) -> bytes:
    """``pixels`` (RGB or CMYK, uint8 ``[h, w, c]``) as a JPEG of each
    component's ``(h, v)`` sampling factors."""
    import ctypes

    h, w, c = pixels.shape
    hv = (ctypes.c_int * 8)(*[f for pair in sampling for f in pair])
    out, size = ctypes.c_void_p(), ctypes.c_ulong()
    rc = shim.shim_write(np.ascontiguousarray(pixels).tobytes(), w, h, c, hv, quality,
                         ctypes.byref(out), ctypes.byref(size))
    assert rc == 0, f"libjpeg-turbo refused sampling {sampling}"
    data = ctypes.string_at(out.value, size.value)
    shim.shim_free(out)
    return data


def libjpeg_raw_planes(shim, data: bytes):
    """libjpeg-turbo's planes of ``data`` before upsampling, each at its
    downsampled size."""
    import ctypes

    capacity = 4 * 65536 * 64
    buf = np.empty(capacity, np.uint8)
    dims = (ctypes.c_int * 8)()
    n = shim.shim_raw(data, len(data), buf.ctypes.data, dims, capacity)
    assert n > 0, "libjpeg-turbo could not read the raw planes"
    planes, at = [], 0
    for ci in range(n):
        w, h = dims[2 * ci], dims[2 * ci + 1]
        planes.append(buf[at:at + w * h].reshape(h, w).copy())
        at += w * h
    return planes
# an APP14 "Adobe" segment: version 100, no flags, colour transform 0 (RGB)
ADOBE_RGB_SEGMENT = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"


def as_adobe_rgb(data: bytes) -> bytes:
    """The JPEG ``data`` with its APP0 JFIF segment replaced by an Adobe
    segment of colour transform 0: the same bitstream, read as R, G, B."""
    assert data[2:4] == b"\xff\xe0" and data[6:11] == b"JFIF\x00"
    return data[:2] + ADOBE_RGB_SEGMENT + data[4 + int.from_bytes(data[4:6], "big"):]


def with_adobe_transform(data: bytes, transform: int) -> bytes:
    """The JPEG ``data`` with its Adobe segment's colour transform set."""
    i = data.index(b"\xff\xee")
    assert data[i + 4 : i + 9] == b"Adobe"
    out = bytearray(data)
    out[i + 4 + 11] = transform
    return bytes(out)


def save_npz_lzma(path, **arrays) -> None:
    """``np.savez`` with LZMA compression (``np.load`` reads it): a third
    smaller than ``savez_compressed`` on the decodes."""
    import zipfile

    with zipfile.ZipFile(path, "w", zipfile.ZIP_LZMA) as z:
        for name, arr in arrays.items():
            buf = io.BytesIO()
            np.save(buf, np.asarray(arr))
            z.writestr(f"{name}.npy", buf.getvalue())


def make_jpeg_fixtures(out_dir, seed=9):
    """The committed fixtures: smooth scenes (a gradient, discs, strokes;
    not noise, on which chroma upsampling alone would set the difference)
    saved by PIL as JPEG (the 4:1:1 one by OpenCV; the subsampled RGB one
    through ``as_adobe_rgb``), and PIL's RGB decodes of them in
    ``pil_decodes.npz``."""
    import cv2
    from PIL import ImageDraw

    import tempfile

    rng = np.random.default_rng(seed)
    out_dir = Path(out_dir)
    decodes = {}
    shim_dir = tempfile.TemporaryDirectory()
    shim = libjpeg_shim(shim_dir.name)
    for name, (w, h, opts, mode) in JPEG_FIXTURES.items():
        y, x = np.mgrid[0:h, 0:w].astype(np.float32)
        a, b = rng.uniform(0.2, 1.0, 2)
        base = np.stack([255 * x / w * a, 255 * y / h * b,
                         127.5 + 127.5 * np.sin((x + y) / (w + h) * 6.0)], -1)
        img = Image.fromarray(base.astype(np.uint8), "RGB")
        draw = ImageDraw.Draw(img)
        for _ in range(6):
            cx, cy = rng.uniform(0, w), rng.uniform(0, h)
            r = rng.uniform(0.05, 0.25) * min(w, h)
            draw.ellipse([cx - r, cy - r, cx + r, cy + r],
                         fill=tuple(int(c) for c in rng.integers(0, 256, 3)))
        for _ in range(4):
            pts = [(float(rng.uniform(0, w)), float(rng.uniform(0, h))) for _ in range(3)]
            draw.line(pts, fill=tuple(int(c) for c in rng.integers(0, 256, 3)),
                      width=int(rng.integers(2, 7)))
        if mode in ("L", "CMYK"):
            img = img.convert(mode)
        path = out_dir / f"{name}.jpg"
        if "libjpeg_sampling" in opts:
            assert shim is not None, "no libjpeg-turbo to write with (gcc, jpeglib.h, -ljpeg)"
            pixels = np.asarray(img)
            path.write_bytes(libjpeg_write(shim, pixels if mode == "RGB" else 255 - pixels,
                                           opts["libjpeg_sampling"], opts["quality"]))
        elif "opencv_sampling" in opts:
            sampling = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{opts['opencv_sampling']}")
            assert cv2.imwrite(str(path), np.asarray(img)[..., ::-1].copy(), [
                cv2.IMWRITE_JPEG_QUALITY, opts["quality"],
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling])
        elif opts.get("ycck"):
            buf = io.BytesIO()
            img.save(buf, "JPEG", quality=opts["quality"])
            path.write_bytes(with_adobe_transform(buf.getvalue(), 2))
        elif opts.get("adobe_rgb"):
            buf = io.BytesIO()
            img.save(buf, "JPEG", quality=opts["quality"])
            path.write_bytes(as_adobe_rgb(buf.getvalue()))
        else:
            img.save(path, "JPEG", **opts)
        with Image.open(path) as f:
            decodes[name] = np.asarray(f.convert("RGB"))
    shim_dir.cleanup()
    save_npz_lzma(out_dir / "pil_decodes.npz", **decodes)
    return decodes


# ---- the JPEG fixtures ---------------------------------------------------------

def test_committed_pil_decodes_match_the_jpegs():
    ref = np.load(JPEG_DIR / "pil_decodes.npz")
    assert sorted(ref.files) == sorted(JPEG_FIXTURES)
    for name, (w, h, opts, mode) in JPEG_FIXTURES.items():
        with Image.open(JPEG_DIR / f"{name}.jpg") as img:
            assert img.size == (w, h) and img.mode == mode
            np.testing.assert_array_equal(np.asarray(img.convert("RGB")), ref[name])
            assert bool(img.info.get("progressive")) == bool(opts.get("progressive"))
        # the CPU route of read_rgb is PIL's decode
        np.testing.assert_array_equal(image_io.read_rgb(JPEG_DIR / f"{name}.jpg", "cpu"),
                                      ref[name])
    assert sum(f.stat().st_size for f in JPEG_DIR.iterdir()) < 600_000


def test_fixture_generator_makes_the_named_images(tmp_path):
    decodes = make_jpeg_fixtures(tmp_path)
    for name, (w, h, opts, mode) in JPEG_FIXTURES.items():
        assert decodes[name].shape == (h, w, 3)
        header = image_io.jpeg_header((tmp_path / f"{name}.jpg").read_bytes())
        assert header["components"] == {"L": 1, "RGB": 3, "CMYK": 4}[mode]
        assert header["subsampled"] == (mode == "RGB" and "444" not in name
                                        or "libjpeg_sampling" in opts)
        if "libjpeg_sampling" in opts:
            assert header["sampling"] == opts["libjpeg_sampling"], name
        assert header["progressive"] == name.startswith("progressive")
        assert header["rgb"] == name.startswith("adobergb"), name
        assert header["ycck"] == name.startswith("ycck"), name


def test_decode_refusals_on_the_cpu(tmp_path):
    """What libjpeg-turbo cannot upsample is refused by name before any
    card work: a plane sampled by a fraction of the largest factors (PIL
    refuses it too); a file that is no JPEG. A 4-component JPEG whose K is
    sampled otherwise than its first plane is no longer refused: each plane
    gets its factors and its size. A JPEG coded in RGB is decoded (no
    longer refused), and is told from YCbCr as libjpeg-turbo tells it: a
    JFIF segment means YCbCr whatever an Adobe segment says; CMYK and YCCK
    are decoded too (no longer refused)."""
    rng = np.random.default_rng(0)
    cmyk = bytearray((JPEG_DIR / "cmyk_96x64.jpg").read_bytes())
    sof = cmyk.index(b"\xff\xc0")
    cmyk[sof + 11] = 0x11  # C at 1 x 1 ...
    cmyk[sof + 20] = 0x22  # ... and K at 2 x 2: K above the first plane
    header = image_io.jpeg_header(bytes(cmyk))
    factors = image_io.upsampling_factors(header["sampling"])
    assert factors == ((2, 2), (2, 2), (2, 2), (1, 1))
    assert image_io.plane_shapes(header, factors) == [(32, 48)] * 3 + [(64, 96)]
    fractional = bytearray(cmyk)
    fractional[sof + 11] = 0x31  # C at 3 x 1 under K at 2 x 2: 2 / 3
    with pytest.raises(image_io.JpegInputError, match="fraction"):
        image_io.decode_jpeg(bytes(fractional))
    with pytest.raises(Exception):  # PIL (libjpeg-turbo) refuses it as well
        Image.open(io.BytesIO(bytes(fractional))).convert("RGB")
    rgb = (JPEG_DIR / "rgb444_160x120.jpg").read_bytes()
    both = rgb[:2] + ADOBE_RGB_SEGMENT + rgb[2:]  # JFIF and Adobe transform 0
    header = image_io.jpeg_header(both)
    assert header["adobe_transform"] == 0 and header["jfif"] and not header["rgb"]
    with Image.open(io.BytesIO(both)) as img:  # PIL (libjpeg-turbo) reads YCbCr
        np.testing.assert_array_equal(np.asarray(img.convert("RGB")),
                                      np.load(JPEG_DIR / "pil_decodes.npz")["rgb444_160x120"])
    assert image_io.jpeg_header(as_adobe_rgb(rgb))["rgb"]
    no_markers = bytearray(rgb[:2] + rgb[4 + int.from_bytes(rgb[4:6], "big"):])
    sof = no_markers.index(b"\xff\xc0")
    assert image_io.jpeg_header(bytes(no_markers))["rgb"] is False  # ids 1, 2, 3
    no_markers[sof + 10 : sof + 19 : 3] = b"RGB"
    assert image_io.jpeg_header(bytes(no_markers))["rgb"]  # ids R, G, B
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)).save(buf, "PNG")
    with pytest.raises(image_io.JpegDecodeError, match="not a JPEG"):
        image_io.decode_jpeg(buf.getvalue())
    # without a card, the default device raises instead of falling to PIL
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            image_io.read_rgb(JPEG_DIR / "rgb444_160x120.jpg")


def _luma(rgb):
    return rgb.astype(np.float64) @ np.array([0.299, 0.587, 0.114])


def _decode_misses(ours, ref, subsampled):
    """The bounds a decode ``ours`` misses against PIL's ``ref``: [] when
    it is held."""
    per_channel = np.abs(ours.astype(np.int16) - ref.astype(np.int16)).reshape(-1, 3).mean(0)
    misses = []
    if subsampled:
        d_luma = np.abs(_luma(ours) - _luma(ref)).mean()
        if d_luma > DECODE_MEAN_MAX:
            misses.append(("luma", d_luma))
        if per_channel.max() > SUBSAMPLED_CHANNEL_MEAN_MAX:
            misses.append(("channel ceiling", per_channel))
    if per_channel.max() > DECODE_MEAN_MAX:
        misses.append(("channels", per_channel))
    return misses


def _ycbcr(rgb):
    r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
    return (0.299 * r + 0.587 * g + 0.114 * b, 128 - 0.168736 * r - 0.331264 * g + 0.5 * b,
            128 + 0.5 * r - 0.418688 * g - 0.081312 * b)


def _rgb(y, cb, cr):
    rgb = np.stack([y + 1.402 * (cr - 128), y - 0.344136 * (cb - 128) - 0.714136 * (cr - 128),
                    y + 1.772 * (cb - 128)], -1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


def test_decode_bound_rejects_a_wrong_chroma():
    """The subsampled fixtures are held on each channel (and on their luma,
    which a wrong chroma leaves as it is): a decode that lost, swapped or
    moved (by 1 or 3 pixels, either way) its chroma planes misses the
    bound, and an error of the IDCT's size (±1 level) does not."""
    ref = np.load(JPEG_DIR / "pil_decodes.npz")
    headers = {n: image_io.jpeg_header((JPEG_DIR / f"{n}.jpg").read_bytes())
               for n in ref.files}
    # chroma: the subsampled fixtures coded in YCbCr
    subsampled = [n for n, h in headers.items()
                  if h["subsampled"] and not h["rgb"] and h["components"] == 3]
    assert sorted(subsampled) == [
        "odd_211x97", "progressive_240x180", "rgb411_94x64", "rgb420_480x360",
        "sampling_cb_cr_apart_99x65", "sampling_luma_below_93x61",
        "sampling_no_full_plane_90x58", "sampling_y1x4_96x61", "sampling_y3x1_97x40"]
    for name in subsampled:
        pil = ref[name]
        y, cb, cr = _ycbcr(pil)
        assert _decode_misses(pil, pil, True) == []
        # the IDCT's error: ±1 level on two values in three, 0.65-0.66 mean
        noise = np.random.default_rng(0).integers(-1, 2, pil.shape)
        assert _decode_misses(np.clip(pil + noise, 0, 255).astype(np.uint8), pil, True) == []
        wrong = {"lost": _rgb(y, np.full_like(cb, 128), np.full_like(cr, 128)),
                 "swapped": _rgb(y, cr, cb)}
        for axis in (0, 1):
            for shift in (1, 3):  # moved by 1: the worst channel 2.87-8.27 levels
                wrong[f"moved {shift} on {axis}"] = _rgb(y, np.roll(cb, shift, axis),
                                                         np.roll(cr, shift, axis))
        for what, rgb in wrong.items():
            misses = _decode_misses(rgb, pil, True)
            assert "channels" in [m[0] for m in misses], (name, what, misses)


def test_nvjpeg_binding_builds_apart_from_the_kernels(tmp_path, monkeypatch):
    """The kernels build without the nvJPEG binding, and a binding that
    cannot be built (here: the link to nvJPEG fails) raises the decoder's
    named error rather than taking the kernels down. A stand-in ``nvcc``
    writes empty libraries; no GPU is needed."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\nout=\nfor a; do [ \"$prev\" = -o ] && out=$a; prev=$a\n"
        "case $a in *jpeg_decode.cu) echo 'cannot find -lnvjpeg'; exit 1;; esac; done\n"
        ": > \"$out\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_libs", {})
    libs = _build.build_all()
    assert sorted(libs) == ["fused_attention", "fused_mha", "ln_mxu"]
    assert all(path.exists() for path in libs.values())
    with pytest.raises(image_io.JpegDecodeError, match="could not be built.*jpeg_decode.cu"):
        image_io.decode_jpeg((JPEG_DIR / "rgb444_160x120.jpg").read_bytes())
    assert "cannot find -lnvjpeg" in next((tmp_path / "build").glob(
        "libjpeg_decode-*.so.log")).read_text()


@pytest.mark.cuda
def test_read_rgb_on_card_matches_pil_within_bound():
    """Every fixture within the bound; one of the samplings written by
    libjpeg-turbo may instead be refused by nvJPEG, by its status's name."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: nvJPEG runs on the card")
    ref = np.load(JPEG_DIR / "pil_decodes.npz")
    for name in ref.files:
        path = JPEG_DIR / f"{name}.jpg"
        try:
            ours = image_io.read_rgb(path)
        except image_io.JpegInputError as e:
            assert "libjpeg_sampling" in JPEG_FIXTURES[name][2] and "NVJPEG_STATUS" in str(e)
            continue
        assert ours.shape == ref[name].shape and ours.dtype == np.uint8
        subsampled = image_io.jpeg_header(path.read_bytes())["subsampled"]
        assert _decode_misses(ours, ref[name], subsampled) == [], name


# ---- the CSV table -------------------------------------------------------------

def _write_csv(path, header, rows, quoting=csv.QUOTE_MINIMAL):
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, quoting=quoting)
        w.writerow(header)
        w.writerows(rows)
    return path


def _same_column(ours, ref):
    ours, ref = ours.tolist(), ref.tolist()
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        if isinstance(b, float) and math.isnan(b):
            assert isinstance(a, float) and math.isnan(a), (a, b)
        else:
            assert type(a) is type(b) and a == b, (a, b)


CSV_CASES = {
    "reddit": (["reddit_id", "video_path", "title", "video_length", "comments"], [
        [101, "results/2t.mp4", "plain title", 10, "['a', 'b']"],
        [102, "results/2u.mp4", "comma, inside", 12, "[]"],
        [103, "results/2v.mp4", "new\nline and \"quotes\"", 7, "['x, y', \"it's\"]"],
        [104, "results/2w.mp4", "", 3, "['only']"],
        [105, "results/2x.mp4", "NA", 4, "[]"],
        [106, "results/2y.mp4", "None", 5, "['c']"],
        [107, "results/2z.mp4", "ünïcödé 日本 🐱", 6, "['ü']"],
    ]),
    "float lengths, base-36 ids": (["reddit_id", "video_path", "title", "video_length",
                                    "comments"], [
        ["abc1", "results/abc1.mp4", "t1", 10.5, "['a']"],
        ["2222", "results/2222.mp4", "t2", 3, "[]"],
        ["zz9", "results/zz9.mp4", "null", 1e3, "['b']"],
    ]),
    "ints with NA": (["reddit_id", "video_length", "title"], [
        [1, 10, "a"], [2, "", "b"], [3, "NaN", "c"], [4, -7, "n/a"],
    ]),
    "all missing, signs, spaces": (["a", "b", "c", "d"], [
        ["", "+5", " 3", "1.5e-3"], ["NULL", "-2", "4 ", "-.5"], ["#N/A", "0", "5", "inf"],
    ]),
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
@pytest.mark.parametrize("quoting", [csv.QUOTE_MINIMAL, csv.QUOTE_ALL])
def test_read_csv_matches_pandas(tmp_path, case, quoting):
    header, rows = CSV_CASES[case]
    path = _write_csv(tmp_path / "t.csv", header, rows, quoting)
    ours, ref = read_csv(path), pd.read_csv(path)
    assert list(ours.columns) == list(ref.columns)
    for name in header:
        kind = ref[name].dtype.kind
        assert ours[name].dtype.kind == ("O" if kind not in "if" else kind), name
        _same_column(ours[name], ref[name])


def test_read_csv_matches_pandas_to_csv(tmp_path):
    """A table written by pandas, as the JAX package's tests write theirs."""
    rng = np.random.default_rng(0)
    rows = [{"reddit_id": int(rng.integers(1, 10**9)), "video_path": f"results/v{i}.mp4",
             "title": f"title {i}, with \"quotes\" and\nlines" if i % 3 else "",
             "video_length": float(rng.uniform(1, 100)),
             "comments": str([f"c{j}" for j in range(int(rng.integers(0, 4)))])}
            for i in range(40)]
    pd.DataFrame(rows).to_csv(tmp_path / "t.csv", index=False)
    ours, ref = read_csv(tmp_path / "t.csv"), pd.read_csv(tmp_path / "t.csv")
    for name in ref.columns:
        _same_column(ours[name], ref[name])


# ---- the corpus ------------------------------------------------------------------

LONG_TITLE = ("the cat sat on the mat and then the dog ran over the hill while the "
              "bird sang in the old oak tree near the river bank ") * 4
BOT = ["i am a bot, beep", "[deleted]", "Thank you for your submission!"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Rows over every split (base-36 ids), a JPEG thumbnail per row but
    two, comments with bot texts, one over-long title, cached features."""
    tmp = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    root = tmp / "media"
    (root / "thumbs").mkdir(parents=True)
    rows = []
    for i in range(60):
        rid_str = "c" + BASE36[(i * 7) % 36] + BASE36[i % 36]
        n_comms = int(rng.integers(0, 8))
        comments = [f"comment {j} on post {i}" for j in range(n_comms)]
        comments[1:1] = BOT[: i % 4]
        rows.append({
            "reddit_id": int(rid_str, 36),
            "video_path": f"results/thumbs/{rid_str}.mp4",
            "title": LONG_TITLE if i == 8 else f"a thumbnail about topic {i} & more",
            "video_length": float(i % 13) + 0.5,
            "comments": str(comments),
        })
        if i in (5, 17):  # missing media: the presence filter's warning
            continue
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        y, x = np.mgrid[0:h, 0:w]
        img = np.stack([x * 255 // w, y * 255 // h, (x + y) * 127 // (w + h)], -1)
        img = (img + rng.integers(0, 40, (h, w, 3))).clip(0, 255).astype(np.uint8)
        Image.fromarray(img).save(root / "thumbs" / f"{rid_str}.jpg", quality=90)
    csv_path = tmp / "posts.csv"
    pd.DataFrame(rows).to_csv(csv_path, index=False)
    ids = np.array([r["reddit_id"] for r in rows], dtype=np.int64)
    np.savez(tmp / "vis.npz", reddit_ids=ids,
             embeddings=rng.normal(size=(len(ids), 16)).astype(np.float32))
    np.savez(tmp / "audio.npz", reddit_ids=ids,
             embeddings=rng.normal(size=(len(ids), 5, 8)).astype(np.float32))
    mapping = {int(r): [int(r) * 10 + j for j in range(3)] for r in ids}
    embs = [[rng.normal(size=6).astype(np.float32) for _ in range(1 + k % 3)]
            for k in range(len(ids))]
    torch.save({"reddit_id_to_comment_id": mapping,
                "embeddings": [[torch.from_numpy(e) for e in row] for row in embs]},
               tmp / "comm.pth")
    np.savez(tmp / "comm.npz", reddit_id_to_comment_id=np.array(mapping, dtype=object),
             embeddings=np.array(embs, dtype=object))
    return {"csv": csv_path, "root": root, "tmp": tmp}


def test_partition_and_filters_match_jax(corpus, tmp_path):
    ours, ref = read_csv(corpus["csv"]), pd.read_csv(corpus["csv"])
    for split in ("train", "val", "test"):
        a = partition.partition_dataframe(ours, split=split)
        b = jax_partition.partition_dataframe(ref, split=split)
        _same_column(a.reddit_id, b.reddit_id)
        for k, limit in ((0, None), (3, None), (2, 4), (1, 3)):
            fa = partition.filter_by_k_comments(a, k, limit=limit)
            fb = jax_partition.filter_by_k_comments(b, k, limit=limit)
            _same_column(fa.reddit_id, fb.reddit_id)  # the rows and their order
            _same_column(fa.title, fb.title)
    # with a root: the ids of the .mp4 files under it
    for rid in ("c00", "c7a", "cen"):
        (tmp_path / f"{rid}.mp4").write_bytes(b"")
    for split in ("train", "val", "test"):
        _same_column(partition.partition_dataframe(ours, str(tmp_path), split).reddit_id,
                     jax_partition.partition_dataframe(ref, str(tmp_path), split).reddit_id)


@pytest.mark.parametrize("sampling", ["random", None, "first"])
@pytest.mark.parametrize("num_comms", [0, 2, 5])
def test_preprocess_comments_matches_jax(sampling, num_comms):
    for i, comments in enumerate([[], ["a", "b"], ["x"] * 3 + BOT + [f"c{j}" for j in range(6)],
                                  [("tuple one", 1), ("i'm a bot", 2), ("two", 3)]]):
        a = partition.preprocess_comments(list(comments), sampling, num_comms,
                                          np.random.default_rng(i))
        b = jax_partition.preprocess_comments(list(comments), sampling, num_comms,
                                              np.random.default_rng(i))
        assert a == b


@pytest.mark.parametrize("name", ["vis.npz", "audio.npz", "comm.pth", "comm.npz"])
def test_load_features_matches_jax(corpus, name):
    path = str(corpus["tmp"] / name)
    a = partition.load_features(partition.partition_dataframe(
        read_csv(corpus["csv"]), split="train"), path)
    b = jax_partition.load_features(jax_partition.partition_dataframe(
        pd.read_csv(corpus["csv"]), split="train"), path)
    if isinstance(b, list):
        assert len(a) == len(b)
        for ra, rb in zip(a, b):
            assert len(ra) == len(rb)
            for x, y in zip(ra, rb):
                np.testing.assert_array_equal(x, y)
        rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
        for sampling in ("first", "random", "all"):
            for ra, rb in zip(a, b):
                np.testing.assert_array_equal(
                    partition.sample_if_list(ra, sampling, rng_a),
                    jax_partition.sample_if_list(rb, sampling, rng_b))
    else:
        np.testing.assert_array_equal(a, b)


def test_nan_title_raises_in_both(tmp_path):
    """A title that pandas reads as NaN ("NA", "None", empty) is NaN in both
    packages' tables, and tokenizing it raises the same TypeError in both
    packages' items."""
    rid = "c0" + "9"  # a train id
    rows = [[int(rid, 36), f"results/{rid}.mp4", "NA", 1.0, "['a']"]]
    path = _write_csv(tmp_path / "t.csv",
                      ["reddit_id", "video_path", "title", "video_length", "comments"], rows)
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / f"{rid}.jpg")
    ours = datasets.ImTextDataset(str(path), str(tmp_path), device="cpu", image_size=8)
    ref = jax_datasets.ImTextDataset(str(path), str(tmp_path), image_size=8)
    assert math.isnan(ours.titles[0]) and math.isnan(ref.titles[0])
    with pytest.raises(TypeError) as ea:
        ours[0]
    with pytest.raises(TypeError) as eb:
        ref[0]
    assert str(ea.value) == str(eb.value)


# ---- the resampler and preprocessing -------------------------------------------

RESIZE_CASES = [
    ((360, 480), (224, 298)), ((480, 360), (298, 224)), ((97, 211), (224, 487)),
    ((64, 48), (256, 256)), ((1, 1), (7, 5)), ((1, 300), (224, 1)), ((300, 1), (1, 224)),
    ((3, 2000), (224, 149333 // 1000)), ((2000, 3), (1, 224)), ((224, 224), (224, 224)),
    ((37, 41), (100, 13)), ((5, 7), (6, 8)), ((513, 257), (128, 64)),
]


@pytest.mark.parametrize("filt", ["bicubic", "bilinear"])
@pytest.mark.parametrize("src, dst", RESIZE_CASES)
def test_resize_is_pil_bit_exact(src, dst, filt):
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    pil = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR}[filt]
    ref = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), pil))
    np.testing.assert_array_equal(resize(img, dst[1], dst[0], filt), ref)


def test_resize_batch_on_threads():
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (6, 50, 70, 3), dtype=np.uint8)
    ref = np.stack([np.asarray(Image.fromarray(f).resize((33, 21), Image.BILINEAR))
                    for f in frames])
    np.testing.assert_array_equal(resize(frames, 33, 21, "bilinear", num_threads=3), ref)
    with pytest.raises(ValueError):
        resize(frames.astype(np.float32), 33, 21)


def test_resampler_build_raises_without_a_compiler(tmp_path, monkeypatch):
    """No fall back to PIL: a missing or failing g++ raises."""
    from vtc_tpu_torch.ops import _build

    host = tmp_path / "host"
    host.mkdir()
    (host / "resample.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "HOST_DIR", host)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on resample.cpp"):
        _build.build_host("resample")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build_host("resample")


def _smooth_image(rng, h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w, 1), y * 255 // max(h, 1), (x * y) % 256], -1)
    return (img + rng.integers(0, 60, (h, w, 3))).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(360, 480), (97, 211), (224, 224), (300, 120), (50, 40)])
@pytest.mark.parametrize("size", [224, 32])
def test_clip_preprocess_matches_jax(shape, size):
    img = _smooth_image(np.random.default_rng(shape[0]), *shape)
    pil = Image.fromarray(img)
    a, b = preprocess.clip_preprocess(img, size), jax_pre.clip_preprocess(pil, size)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (3, size, size)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(preprocess.clip_resize_uint8(img, size),
                                  jax_pre.clip_resize_uint8(pil, size))


@pytest.mark.parametrize("seed", range(6))
def test_augmentations_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    shape = [(120, 160), (300, 60), (64, 400), (90, 90), (33, 47), (256, 256)][seed]
    frames = np.stack([_smooth_image(rng, *shape) for _ in range(3)])
    np.testing.assert_array_equal(
        preprocess.augment_frames(frames, np.random.default_rng(seed)),
        jax_pre.augment_frames(frames, np.random.default_rng(seed)))
    np.testing.assert_array_equal(
        preprocess.augment_image(frames[0], np.random.default_rng(seed)),
        np.asarray(jax_pre.augment_image(Image.fromarray(frames[0]),
                                         np.random.default_rng(seed))))
    assert preprocess.IG65M_MEAN.tolist() == jax_pre.IG65M_MEAN.tolist()
    assert preprocess.IG65M_STD.tolist() == jax_pre.IG65M_STD.tolist()


# ---- the datasets ----------------------------------------------------------------

def _same_item(a, b):
    assert type(a) is type(b) or (isinstance(a, tuple) and isinstance(b, tuple))
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _same_item(a[k], b[k])
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_item(x, y)
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


IM_TEXT_CASES = {
    "float, always": dict(add_comments="always", num_comms=3),
    "float, augmented": dict(add_comments="always", num_comms=2, use_augmentation=True),
    "uint8, train_only": dict(uint8_images=True, num_comms=2),
    "uint8, augmented": dict(uint8_images=True, use_augmentation=True, num_comms=1),
    "patches, never": dict(patch_images=8, add_comments="never", num_comms=2),
    "patches True, augmented": dict(patch_images=True, image_size=64, use_augmentation=True,
                                    add_comments="always", num_comms=5,
                                    comment_sampling=None),
    "cached vision": dict(cached_vision_features="vis.npz", num_comms=2,
                          add_comments="always"),
    "cached audio": dict(cached_audio_features="audio.npz", num_comms=2,
                         add_comments="always"),
    "audio with comments": dict(cached_audio_features="audio.npz", audio_with_comms=True,
                                num_comms=2, add_comments="always"),
    "audio instead of title": dict(cached_audio_features="audio.npz",
                                   audio_instead_of_title=True),
}


def _im_text(corpus, package, train, test=False, **kwargs):
    kw = dict(dict(image_size=32, seed=3), **kwargs)
    for key in ("cached_vision_features", "cached_audio_features"):
        if kw.get(key):
            kw[key] = str(corpus["tmp"] / kw[key])
    args = (str(corpus["csv"]), str(corpus["root"]))
    if package == "port":
        return datasets.ImTextDataset(*args, train=train, test=test, device="cpu", **kw)
    return jax_datasets.ImTextDataset(*args, train=train, test=test, **kw)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("case", sorted(IM_TEXT_CASES))
def test_im_text_items_match_jax(corpus, case, train):
    ours = _im_text(corpus, "port", train, **IM_TEXT_CASES[case])
    ref = _im_text(corpus, "jax", train, **IM_TEXT_CASES[case])
    assert len(ours) == len(ref) > 0
    assert ours.filenames == ref.filenames and ours.ids == ref.ids
    assert ours.comments == ref.comments and ours.video_lengths == ref.video_lengths
    for i in range(len(ref)):
        _same_item(ours[i], ref[i])


@pytest.mark.parametrize("k, limit", [(3, None), (2, 3), (1, 100)])
def test_im_text_test_split_over_k_comments(corpus, k, limit):
    kw = dict(add_comments="always", num_comms=3, comment_sampling="random",
              test_on_over_k_comms=k, test_set_limit=limit)
    ours = _im_text(corpus, "port", False, test=True, **kw)
    ref = _im_text(corpus, "jax", False, test=True, **kw)
    assert ours.ids == ref.ids and len(ref) > 0
    for i in range(len(ref)):
        _same_item(ours[i], ref[i])


def test_long_title_goes_through_rake(corpus):
    ours, ref = _im_text(corpus, "port", True), _im_text(corpus, "jax", True)
    i = ours.titles.index(LONG_TITLE)
    tokens = ours[i][1]
    assert tokens[-1] == 0 and 49407 in tokens  # summarized, not cut at 77
    np.testing.assert_array_equal(tokens, ref[i][1])
    np.testing.assert_array_equal(ours._tokenise(LONG_TITLE * 4), ref._tokenise(LONG_TITLE * 4))


def test_features_dataset_matches_jax(corpus):
    tmp = corpus["tmp"]
    specs = [dict(input_features=str(tmp / "vis.npz")),
             dict(input_features=[str(tmp / "vis.npz"), str(tmp / "comm.pth")],
                  target_features=str(tmp / "audio.npz"), train_comment_sampling="random",
                  test_comment_sampling="first"),
             dict(input_features=[[str(tmp / "vis.npz"), str(tmp / "comm.npz")]],
                  train_comment_sampling="random", test_comment_sampling="first"),
             dict(input_features=str(tmp / "comm.npz"), train_comment_sampling="all",
                  test_comment_sampling="all")]
    for spec in specs:
        for train in (True, False):
            ours = datasets.FeaturesDataset(str(corpus["csv"]), train=train, seed=4, **spec)
            ref = jax_datasets.FeaturesDataset(str(corpus["csv"]), train=train, seed=4, **spec)
            assert len(ours) == len(ref) > 0
            for i in range(len(ref)):
                _same_item(ours[i], ref[i])


def test_loader_batches_match_jax(corpus):
    for make in (lambda p: _im_text(corpus, p, True, uint8_images=True, num_comms=2,
                                    add_comments="always"),
                 lambda p: (datasets.FeaturesDataset if p == "port"
                            else jax_datasets.FeaturesDataset)(
                     str(corpus["csv"]), input_features=str(corpus["tmp"] / "vis.npz"))):
        ours = DataLoader(make("port"), 4, shuffle=True, drop_last=True, num_workers=0,
                          seed=5)
        ref = JaxDataLoader(make("jax"), 4, shuffle=True, drop_last=True, num_workers=0,
                            seed=5)
        for _ in range(2):  # two epochs: the shuffle and the rng move on
            batches = list(ref)
            assert len(batches) == len(ours) > 0
            for a, b in zip(ours, batches):
                _same_item(a, b)


def test_video_dataset_names_wait_for_their_port(corpus):
    """Every video dataset is ported (tests/test_torch_video.py; the two that
    feed the R(2+1)D tower in tests/test_torch_zoo.py): each is a class, and
    ``VideoDatasetFirst32``/``First1800`` take the JAX package's arguments
    (and the ``device`` of ``init_obj``) on a corpus, splitting it as JAX
    does; the ig65m path without text features is refused as there."""
    import vtc_tpu.data.datasets as jax_ds
    from vtc_tpu_torch import data

    for name in ("VideoDatasetSegments", "VideoDatasetReddit", "VideoDatasetMSRVTT",
                 "VideoDatasetFirst32", "VideoDatasetFirst1800"):
        assert isinstance(getattr(data, name), type)
    args = (str(corpus["csv"]), str(corpus["tmp"]))
    for kw in ({"train": True}, {"train": False}, {"should_partition_dataframe": False}):
        ours = data.VideoDatasetFirst1800(*args, device="cpu", **kw)
        ref = jax_ds.VideoDatasetFirst1800(*args, **kw)
        assert ours.video_files == ref.video_files
        ours = data.VideoDatasetFirst32(*args, clip_preprocess=True, **kw)
        ref = jax_ds.VideoDatasetFirst32(*args, clip_preprocess=True, **kw)
        assert (ours.video_files, ours.ids, ours.titles) == (
            ref.video_files, ref.ids, ref.titles)
    assert len(ours) == len(ref) > 0
    with pytest.raises(ValueError, match="text_features"):
        data.VideoDatasetFirst32(*args)


def test_comments_column_is_read_as_jax_reads_it(corpus):
    ours, ref = _im_text(corpus, "port", True), _im_text(corpus, "jax", True)
    assert ours.comments == ref.comments
    assert all(c == ast.literal_eval(str(c)) for c in ours.comments)
