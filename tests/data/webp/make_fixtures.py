"""Write the WebP fixtures of ``tests/test_torch_webp.py`` and PIL's decodes
of them (``pil_decodes.npz``: ``Image.open(...).convert("RGB")``).

The bitstreams come from the system's libwebp encoder (``webp/encode.h``)
and the extended containers from its muxer (``webp/mux.h``), through a
small C shim compiled with ``gcc`` at run time; the images are seeded. The
settings cover what the port's decoder must read: lossy at qualities 0-100,
methods 0 and 6, 1 and 4 segments, both loop filters at strengths 0-100,
sharpness 0 and 7, 1 to 8 token partitions, SNS 0 and 100; lossless at
methods 0 and 6, palettes of 2, 4, 16 and 256 colours (every pixel
bundling), near-lossless, one colour, a row and a column; alpha raw and
compressed under each filter; ``VP8X`` with ICCP and EXIF; an animation
whose frame 0 is smaller than the canvas and offset.

    python tests/data/webp/make_fixtures.py   # rewrites the files beside it
"""

from __future__ import annotations

import ctypes
import io
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_SHIM = r"""
#include <stdlib.h>
#include <string.h>
#include <webp/encode.h>
#include <webp/mux.h>

/* p: lossless, quality, method, segments, filter_type, filter_strength,
   filter_sharpness, partitions, sns_strength, alpha_compression,
   alpha_filtering, alpha_quality, near_lossless, exact, use_alpha */
int shim_encode(const uint8_t* rgba, int w, int h, const int* p, uint8_t** out,
                size_t* out_size) {
  WebPConfig config;
  WebPPicture pic;
  WebPMemoryWriter writer;
  int ok;
  if (!WebPConfigInit(&config)) return -1;
  config.lossless = p[0];
  config.quality = (float)p[1];
  config.method = p[2];
  config.segments = p[3];
  config.filter_type = p[4];
  config.filter_strength = p[5];
  config.filter_sharpness = p[6];
  config.partitions = p[7];
  config.sns_strength = p[8];
  config.alpha_compression = p[9];
  config.alpha_filtering = p[10];
  config.alpha_quality = p[11];
  config.near_lossless = p[12];
  config.exact = p[13];
  config.autofilter = 0;
  config.thread_level = 0;
  if (!WebPValidateConfig(&config)) return -2;
  if (!WebPPictureInit(&pic)) return -3;
  pic.use_argb = config.lossless;
  pic.width = w;
  pic.height = h;
  ok = p[14] ? WebPPictureImportRGBA(&pic, rgba, 4 * w)
             : WebPPictureImportRGBX(&pic, rgba, 4 * w);
  if (!ok) return -4;
  WebPMemoryWriterInit(&writer);
  pic.writer = WebPMemoryWrite;
  pic.custom_ptr = &writer;
  ok = WebPEncode(&config, &pic);
  WebPPictureFree(&pic);
  if (!ok) return -5;
  *out = writer.mem;
  *out_size = writer.size;
  return 0;
}

int shim_meta(const uint8_t* webp, size_t n, const uint8_t* icc, size_t icc_n,
              const uint8_t* exif, size_t exif_n, uint8_t** out, size_t* out_size) {
  WebPData image = {webp, n}, iccp = {icc, icc_n}, ex = {exif, exif_n}, assembled;
  WebPMux* mux = WebPMuxNew();
  int err = WebPMuxSetImage(mux, &image, 1);
  if (err == WEBP_MUX_OK) err = WebPMuxSetChunk(mux, "ICCP", &iccp, 1);
  if (err == WEBP_MUX_OK) err = WebPMuxSetChunk(mux, "EXIF", &ex, 1);
  WebPDataInit(&assembled);
  if (err == WEBP_MUX_OK) err = WebPMuxAssemble(mux, &assembled);
  WebPMuxDelete(mux);
  *out = (uint8_t*)assembled.bytes;
  *out_size = assembled.size;
  return err == WEBP_MUX_OK ? 0 : -1;
}

int shim_anim(const uint8_t* f0, size_t n0, int x0, int y0, const uint8_t* f1, size_t n1,
              int canvas_w, int canvas_h, uint8_t** out, size_t* out_size) {
  WebPMuxAnimParams params = {0xff204060u, 0};
  WebPMuxFrameInfo frame;
  WebPData assembled;
  WebPMux* mux = WebPMuxNew();
  int err = WebPMuxSetCanvasSize(mux, canvas_w, canvas_h);
  if (err == WEBP_MUX_OK) err = WebPMuxSetAnimationParams(mux, &params);
  memset(&frame, 0, sizeof(frame));
  frame.id = WEBP_CHUNK_ANMF;
  frame.duration = 80;
  frame.dispose_method = WEBP_MUX_DISPOSE_NONE;
  frame.blend_method = WEBP_MUX_BLEND;
  frame.bitstream.bytes = f0;
  frame.bitstream.size = n0;
  frame.x_offset = x0;
  frame.y_offset = y0;
  if (err == WEBP_MUX_OK) err = WebPMuxPushFrame(mux, &frame, 1);
  frame.bitstream.bytes = f1;
  frame.bitstream.size = n1;
  frame.x_offset = 0;
  frame.y_offset = 0;
  if (err == WEBP_MUX_OK) err = WebPMuxPushFrame(mux, &frame, 1);
  WebPDataInit(&assembled);
  if (err == WEBP_MUX_OK) err = WebPMuxAssemble(mux, &assembled);
  WebPMuxDelete(mux);
  *out = (uint8_t*)assembled.bytes;
  *out_size = assembled.size;
  return err == WEBP_MUX_OK ? 0 : -1;
}

void shim_free(void* p) { WebPFree(p); }
"""


class EncoderUnavailable(RuntimeError):
    """The system's libwebp encoder and muxer (headers and libraries) are
    not installed, or gcc is missing."""


def _shim(build_dir: Path) -> ctypes.CDLL:
    gcc = shutil.which("gcc")
    if gcc is None:
        raise EncoderUnavailable("gcc not found")
    src, lib = build_dir / "webp_shim.c", build_dir / "libwebp_shim.so"
    src.write_text(_SHIM)
    proc = subprocess.run([gcc, "-O2", "-shared", "-fPIC", "-o", str(lib), str(src),
                           "-lwebpmux", "-lwebp"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise EncoderUnavailable(proc.stderr[-500:])
    shim = ctypes.CDLL(str(lib))
    u8p, out_p, size_p = ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(
        ctypes.c_size_t)
    shim.shim_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                                 out_p, size_p]
    shim.shim_meta.argtypes = [u8p, ctypes.c_size_t, u8p, ctypes.c_size_t, u8p,
                               ctypes.c_size_t, out_p, size_p]
    shim.shim_anim.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, u8p,
                               ctypes.c_size_t, ctypes.c_int, ctypes.c_int, out_p, size_p]
    shim.shim_free.argtypes = [ctypes.c_void_p]
    return shim


def _take(shim, rc: int, out: ctypes.c_void_p, size: ctypes.c_size_t, what: str) -> bytes:
    if rc != 0:
        raise RuntimeError(f"libwebp {what} failed ({rc})")
    data = ctypes.string_at(out.value, size.value)
    shim.shim_free(out)
    return data


# lossless, quality, method, segments, filter_type, filter_strength,
# filter_sharpness, partitions, sns_strength, alpha_compression,
# alpha_filtering, alpha_quality, near_lossless, exact, use_alpha
_DEFAULTS = dict(lossless=0, quality=75, method=4, segments=4, filter_type=1,
                 filter_strength=60, sharpness=0, partitions=0, sns=50, alpha_compression=1,
                 alpha_filtering=1, alpha_quality=100, near_lossless=100, exact=0)


def _encode(shim, rgba: np.ndarray, use_alpha: bool = False, **settings) -> bytes:
    p = {**_DEFAULTS, **settings}
    params = (ctypes.c_int * 15)(
        p["lossless"], p["quality"], p["method"], p["segments"], p["filter_type"],
        p["filter_strength"], p["sharpness"], p["partitions"], p["sns"],
        p["alpha_compression"], p["alpha_filtering"], p["alpha_quality"], p["near_lossless"],
        p["exact"], int(use_alpha))
    h, w = rgba.shape[:2]
    out, size = ctypes.c_void_p(), ctypes.c_size_t()
    rc = shim.shim_encode(np.ascontiguousarray(rgba, np.uint8).tobytes(), w, h, params,
                          ctypes.byref(out), ctypes.byref(size))
    return _take(shim, rc, out, size, "encode")


def scene(rng, w: int, h: int, noise: float = 10.0) -> np.ndarray:
    """A seeded RGBA picture (alpha 255): gradients, flat shapes with hard
    edges, texture, so that every intra mode and filter has work."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([255 * x / max(w - 1, 1), 255 * y / max(h - 1, 1),
                    127 + 120 * np.sin((x + 2 * y) / 7.0)], -1)
    for _ in range(6):
        cx, cy, r = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(2, max(w, h) / 3 + 2)
        mask = (x - cx) ** 2 + (y - cy) ** 2 < r * r
        img[mask] = rng.uniform(0, 255, 3)
    for _ in range(3):
        x0, y0 = rng.integers(0, max(w, 1)), rng.integers(0, max(h, 1))
        img[y0:y0 + rng.integers(1, 9), x0:x0 + rng.integers(1, 30)] = rng.uniform(0, 255, 3)
    img += rng.normal(0, noise, img.shape) if noise else 0
    rgb = np.clip(np.rint(img), 0, 255).astype(np.uint8)
    return np.concatenate([rgb, np.full((h, w, 1), 255, np.uint8)], -1)


def _palette_image(rng, w: int, h: int, colours: int) -> np.ndarray:
    palette = rng.integers(0, 256, (colours, 4), dtype=np.uint8)
    palette[:, 3] = 255
    # blocks of one index and runs, for backward references and the colour cache
    idx = rng.integers(0, colours, (h // 4 + 1, w // 3 + 1)).repeat(4, 0).repeat(3, 1)[:h, :w]
    idx[::5] = rng.integers(0, colours, idx[::5].shape)
    return palette[idx]


def _alpha(rng, w: int, h: int, kind: str) -> np.ndarray:
    y, x = np.mgrid[0:h, 0:w]
    if kind == "rows":  # every row alike: the vertical filter wins
        a = np.broadcast_to((x * 255 // max(w - 1, 1)) ^ (x & 8) * 15, (h, w))
    elif kind == "columns":  # every column alike: the horizontal filter wins
        a = np.broadcast_to((y * 255 // max(h - 1, 1)) ^ (y & 8) * 15, (h, w))
    elif kind == "plane":  # a smooth slope
        a = (3 * x + 2 * y) % 256
    elif kind == "hramp":
        a = (x * 7) % 256
    elif kind == "quad":
        a = ((x * x + y * y) // 8) % 256
    else:  # shapes
        a = np.where((x - w / 2) ** 2 + (y - h / 2) ** 2 < (min(w, h) / 2.5) ** 2, 255, 40)
        a = a + rng.integers(0, 9, (h, w))
    return np.clip(a, 0, 255).astype(np.uint8)


def _filter_alpha(plane: np.ndarray, filt: int) -> np.ndarray:
    """The forward ALPH filter (1 horizontal, 2 vertical, 3 gradient) whose
    inverse libwebp's WebPUnfilters compute: the first row from the left
    (its first sample from 0), a later row's first sample from above."""
    a = plane.astype(np.int32)
    pred = np.zeros_like(a)
    if filt:
        pred[0, 1:] = a[0, :-1]
        pred[1:, 0] = a[:-1, 0]
        if filt == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif filt == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) % 256).astype(np.uint8)


def _riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(tag + len(p).to_bytes(4, "little") + p + b"\0" * (len(p) & 1)
                              for tag, p in chunks)
    return b"RIFF" + len(body).to_bytes(4, "little") + body


def _with_alpha(shim, lossy: bytes, plane: np.ndarray, method: int, filt: int) -> bytes:
    """A VP8X file of the lossy ``VP8 `` chunk of ``lossy`` and an ALPH
    chunk of ``plane`` filtered by ``filt``: raw (``method`` 0) or as the
    image stream of a VP8L encoding (its 5-byte header dropped: 40 bits, so
    the stream starts on a byte) of the filtered plane in the green channel."""
    h, w = plane.shape
    filtered = _filter_alpha(plane, filt)
    if method == 0:
        data = filtered.tobytes()
    else:
        argb = np.zeros((h, w, 4), np.uint8)
        argb[..., 1], argb[..., 3] = filtered, 255
        vp8l = _encode(shim, argb, lossless=1, exact=1)
        data = vp8l[vp8l.index(b"VP8L") + 8 + 5:]
    vp8 = lossy[lossy.index(b"VP8 ") + 8:]
    vp8 = vp8[:int.from_bytes(lossy[lossy.index(b"VP8 ") + 4:lossy.index(b"VP8 ") + 8],
                              "little")]
    vp8x = bytes([0x10, 0, 0, 0]) + (w - 1).to_bytes(3, "little") + (h - 1).to_bytes(3, "little")
    return _riff([(b"VP8X", vp8x), (b"ALPH", bytes([method | filt << 2]) + data),
                  (b"VP8 ", vp8)])


def make_webp_fixtures(out_dir, seed: int = 22):
    """Writes every fixture and ``pil_decodes.npz`` into ``out_dir``; returns
    ``({name: bytes}, {npz key: PIL's RGB})``. Raises ``EncoderUnavailable``
    where the system has no libwebp encoder."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    files = {}
    with tempfile.TemporaryDirectory() as tmp:
        shim = _shim(Path(tmp))
        # lossy: every encoder setting that changes what the decoder reads
        base = scene(rng, 33, 65)
        lossy = {
            "lossy_q0_m0": dict(quality=0, method=0),
            "lossy_q30_m6": dict(quality=30, method=6),
            "lossy_q75_m4": dict(),
            "lossy_q100_m6": dict(quality=100, method=6),
            "lossy_seg1": dict(segments=1),
            "lossy_simple_filter": dict(filter_type=0, filter_strength=50),
            "lossy_filter0": dict(filter_strength=0),
            "lossy_filter100_sharp7": dict(filter_strength=100, sharpness=7),
            "lossy_simple_sharp7": dict(filter_type=0, filter_strength=100, sharpness=7),
            "lossy_sns0": dict(sns=0),
            "lossy_sns100_q30": dict(sns=100, quality=30),
        }
        for name, settings in lossy.items():
            files[name + ".webp"] = _encode(shim, base, **settings)
        tall = scene(rng, 40, 150)  # 10 macroblock rows: every partition is used
        for parts in range(4):  # the encoder splits tokens at methods 0-2 only
            files[f"lossy_partitions{1 << parts}.webp"] = _encode(
                shim, tall, partitions=parts, quality=90, method=2 if parts % 2 else 0)
        for w, h in ((1, 1), (3, 5), (17, 9)):
            files[f"lossy_{w}x{h}.webp"] = _encode(shim, scene(rng, w, h), quality=80)
        files["lossy_480x360.webp"] = _encode(shim, scene(rng, 480, 360, noise=6.0), quality=80)
        # lossless
        files["lossless_m0_q0.webp"] = _encode(shim, base, lossless=1, method=0, quality=0)
        files["lossless_m6_q100.webp"] = _encode(shim, base, lossless=1, method=6, quality=100)
        for colours in (2, 4, 16, 256):
            files[f"lossless_{colours}colours.webp"] = _encode(
                shim, _palette_image(rng, 37, 23, colours), lossless=1, method=4, quality=75)
        files["lossless_near60.webp"] = _encode(shim, base, lossless=1, near_lossless=60)
        one = np.broadcast_to(np.array([12, 200, 77, 255], np.uint8), (9, 14, 4))
        files["lossless_one_colour.webp"] = _encode(shim, one, lossless=1)
        files["lossless_1x300.webp"] = _encode(shim, scene(rng, 1, 300), lossless=1)
        files["lossless_300x1.webp"] = _encode(shim, scene(rng, 300, 1), lossless=1)
        files["lossless_480x360.webp"] = _encode(shim, scene(rng, 480, 360, noise=0),
                                                 lossless=1, method=4, quality=50)
        # alpha from the encoder: raw, compressed (its filters where it picks
        # them), two alpha qualities
        alpha_cases = [("rows", 0, 0, 100), ("hramp", 1, 1, 100), ("quad", 1, 2, 100),
                       ("shapes", 1, 0, 50), ("plane", 1, 2, 50)]
        for kind, compression, filtering, quality in alpha_cases:
            img = scene(rng, 30, 22)
            img[..., 3] = _alpha(rng, 30, 22, kind)
            files[f"alpha_{kind}_c{compression}_f{filtering}_q{quality}.webp"] = _encode(
                shim, img, use_alpha=True, alpha_compression=compression,
                alpha_filtering=filtering, alpha_quality=quality)
        # alpha written here: every filter, raw and as a VP8L stream (the
        # encoder keeps raw alpha unfiltered and picks the filters it likes)
        img = scene(rng, 30, 22)
        lossy = _encode(shim, img, quality=70)
        plane = _alpha(rng, 30, 22, "quad")
        for method in (0, 1):
            for filt in range(4):
                files[f"alpha_written_m{method}_f{filt}.webp"] = _with_alpha(
                    shim, lossy, plane, method, filt)
        img = scene(rng, 30, 22)
        img[..., 3] = _alpha(rng, 30, 22, "shapes")
        files["lossless_alpha.webp"] = _encode(shim, img, use_alpha=True, lossless=1)
        files["lossless_alpha_exact.webp"] = _encode(shim, img, use_alpha=True, lossless=1,
                                                     exact=1)
        # VP8X with ICCP and EXIF
        icc = bytes(rng.integers(0, 256, 131, dtype=np.uint8))
        exif = b"Exif\x00\x00" + bytes(rng.integers(0, 256, 40, dtype=np.uint8))
        for name, image in (("vp8x_meta_lossy", files["lossy_q75_m4.webp"]),
                            ("vp8x_meta_lossless", files["lossless_m0_q0.webp"]),
                            ("vp8x_meta_alpha", files["alpha_shapes_c1_f0_q50.webp"])):
            out, size = ctypes.c_void_p(), ctypes.c_size_t()
            rc = shim.shim_meta(image, len(image), icc, len(icc), exif, len(exif),
                                ctypes.byref(out), ctypes.byref(size))
            files[name + ".webp"] = _take(shim, rc, out, size, "mux")
        # an animation: frame 0 smaller than the canvas, offset; frame 1 the canvas
        for name, lossless in (("anim_lossy", 0), ("anim_lossless", 1)):
            f0 = scene(rng, 21, 13)
            f0[..., 3] = _alpha(rng, 21, 13, "shapes")
            f0 = _encode(shim, f0, use_alpha=True, lossless=lossless)
            f1 = _encode(shim, scene(rng, 40, 30), lossless=lossless)
            out, size = ctypes.c_void_p(), ctypes.c_size_t()
            rc = shim.shim_anim(f0, len(f0), 6, 10, f1, len(f1), 40, 30, ctypes.byref(out),
                                ctypes.byref(size))
            files[name + ".webp"] = _take(shim, rc, out, size, "animation mux")
    decoded = {}
    for name, data in sorted(files.items()):
        (out_dir / name).write_bytes(data)
        with Image.open(io.BytesIO(data)) as img:
            decoded[name.replace(".", "_")] = np.asarray(img.convert("RGB"))
    np.savez_compressed(out_dir / "pil_decodes.npz", **decoded)
    return files, decoded


if __name__ == "__main__":
    made, _ = make_webp_fixtures(Path(__file__).resolve().parent)
    print(f"{len(made)} fixtures, {sum(map(len, made.values()))} bytes")
