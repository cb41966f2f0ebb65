"""The card's JPEG route after nvJPEG: libjpeg-turbo's chroma upsampling and
YCbCr -> RGB (``image_io.ycc_to_rgb`` and its plain version
``ycc_to_rgb_reference``), and the PNG decoder ``data/png.py``.

* ``ycc_to_rgb_reference`` equals, value for value, a scalar transcription
  of libjpeg-turbo's ``h2v2_fancy_upsample``, ``h2v1_fancy_upsample``,
  ``h1v2_fancy_upsample`` (``jdsample.c``; the box ``h2v1_upsample`` and
  ``h2v2_upsample`` where ``jinit_upsampler`` picks them), the context rows
  of ``jdmainct.c`` and ``ycc_rgb_convert`` with ``build_ycc_rgb_table``
  (``jdcolor.c``), on seeded planes at even, odd, 1-row and 1-column sizes;
* on the committed fixtures, PIL's own upsampled YCbCr
  (``draft("YCbCr")``) through the plain colour conversion is PIL's RGB;
* samplings other than 4:4:4, 4:2:2, 4:2:0 and 4:4:0 are refused by name;
* ``decode_png`` against ``PIL.Image.open(...).convert("RGB")``, bit for
  bit, for every colour type and bit depth it takes and each of the five
  row filters, on the committed ``tests/data/png`` fixtures too; 16-bit
  and interlaced PNGs are refused;
* on the card (``cuda``-marked): the kernel bit-exact against the plain
  version on nvJPEG's own planes of every fixture and on seeded planes.
"""

import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from vtc_tpu_torch.data import image_io
from vtc_tpu_torch.data.png import PngDecodeError, decode_png

try:  # the reference; the machine with the card has no PIL
    from PIL import Image
except ImportError:
    Image = None

DATA = Path(__file__).resolve().parent / "data"
JPEG_DIR = DATA / "jpeg"
PNG_DIR = DATA / "png"
FACTORS = [(1, 1), (2, 1), (1, 2), (2, 2)]
SIZES = [(1, 1), (1, 7), (9, 1), (2, 3), (3, 2), (4, 4), (5, 5), (6, 9), (17, 12), (33, 31)]


# ---- libjpeg-turbo, transcribed ------------------------------------------------

def _h2v1_fancy_upsample(input_data, downsampled_width):
    output_data = []
    for inptr in input_data:
        outptr = []
        invalue = inptr[0]  # special case for first column
        outptr.append(invalue)
        outptr.append((invalue * 3 + inptr[1] + 2) >> 2)
        i = 1
        for _ in range(downsampled_width - 2, 0, -1):
            invalue = inptr[i] * 3
            i += 1
            outptr.append((invalue + inptr[i - 2] + 1) >> 2)
            outptr.append((invalue + inptr[i] + 2) >> 2)
        invalue = inptr[i]  # special case for last column
        outptr.append((invalue * 3 + inptr[i - 1] + 1) >> 2)
        outptr.append(invalue)
        output_data.append(outptr)
    return output_data


def _h2v2_fancy_upsample(input_data, downsampled_width):
    """``input_data`` holds a context row above and below the rows."""
    output_data = []
    for inrow in range(1, len(input_data) - 1):
        for v in range(2):
            inptr0 = input_data[inrow]
            inptr1 = input_data[inrow - 1] if v == 0 else input_data[inrow + 1]
            outptr = []
            thiscolsum = inptr0[0] * 3 + inptr1[0]
            nextcolsum = inptr0[1] * 3 + inptr1[1]
            outptr.append((thiscolsum * 4 + 8) >> 4)
            outptr.append((thiscolsum * 3 + nextcolsum + 7) >> 4)
            lastcolsum, thiscolsum = thiscolsum, nextcolsum
            i = 2
            for _ in range(downsampled_width - 2, 0, -1):
                nextcolsum = inptr0[i] * 3 + inptr1[i]
                i += 1
                outptr.append((thiscolsum * 3 + lastcolsum + 8) >> 4)
                outptr.append((thiscolsum * 3 + nextcolsum + 7) >> 4)
                lastcolsum, thiscolsum = thiscolsum, nextcolsum
            outptr.append((thiscolsum * 3 + lastcolsum + 8) >> 4)
            outptr.append((thiscolsum * 4 + 7) >> 4)
            output_data.append(outptr)
    return output_data


def _h1v2_fancy_upsample(input_data, downsampled_width):
    """``input_data`` holds a context row above and below the rows."""
    output_data = []
    for inrow in range(1, len(input_data) - 1):
        for v in range(2):
            inptr0 = input_data[inrow]
            if v == 0:
                inptr1, bias = input_data[inrow - 1], 1
            else:
                inptr1, bias = input_data[inrow + 1], 2
            output_data.append([(inptr0[c] * 3 + inptr1[c] + bias) >> 2
                                for c in range(downsampled_width)])
    return output_data


def _box_upsample(input_data, hf, vf):  # h2v1_upsample, h2v2_upsample
    return [[s for s in row for _ in range(hf)] for row in input_data for _ in range(vf)]


def _libjpeg_upsample(plane, hf, vf):
    """One component as jinit_upsampler sets it up (do_fancy_upsampling,
    full-scale IDCT), with jdmainct.c's context rows: the first row above
    the image, the last real row below it."""
    rows = [list(map(int, r)) for r in plane]
    width = len(rows[0])
    context = [rows[0]] + rows + [rows[-1]]
    if (hf, vf) == (1, 1):
        return rows
    if (hf, vf) == (2, 1):
        return _h2v1_fancy_upsample(rows, width) if width > 2 else _box_upsample(rows, 2, 1)
    if (hf, vf) == (1, 2):
        return _h1v2_fancy_upsample(context, width)
    return (_h2v2_fancy_upsample(context, width) if width > 2
            else _box_upsample(rows, 2, 2))


def _ycc_rgb_tables():
    """build_ycc_rgb_table (jdcolor.c), 8-bit samples."""
    scalebits, one_half = 16, 1 << 15

    def fix(x):
        return int(x * (1 << scalebits) + 0.5)

    tabs = {"Cr_r": [], "Cb_b": [], "Cr_g": [], "Cb_g": []}
    for i in range(256):
        x = i - 128
        tabs["Cr_r"].append((fix(1.40200) * x + one_half) >> scalebits)
        tabs["Cb_b"].append((fix(1.77200) * x + one_half) >> scalebits)
        tabs["Cr_g"].append(-fix(0.71414) * x)
        tabs["Cb_g"].append(-fix(0.34414) * x + one_half)
    return tabs


TABS = _ycc_rgb_tables()


def _ycc_rgb_convert(y, cb, cr):
    """ycc_rgb_convert (jdcolor.c) on upsampled planes (lists of rows)."""
    def limit(v):  # range_limit
        return min(max(v, 0), 255)

    out = []
    for yr, cbr, crr in zip(y, cb, cr):
        out.append([(limit(yv + TABS["Cr_r"][c_r]),
                     limit(yv + ((TABS["Cb_g"][c_b] + TABS["Cr_g"][c_r]) >> 16)),
                     limit(yv + TABS["Cb_b"][c_b]))
                    for yv, c_b, c_r in zip(yr, cbr, crr)])
    return np.asarray(out, np.uint8)


def _libjpeg_rgb(y, cb, cr, factors):
    h, w = y.shape
    up = [[row[:w] for row in _libjpeg_upsample(p, *factors)[:h]] for p in (cb, cr)]
    return _ycc_rgb_convert(y.tolist(), *up)


def _planes(w, h, factors, rng):
    cw, ch = -(-w // factors[0]), -(-h // factors[1])
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (ch, cw), dtype=np.uint8),
            rng.integers(0, 256, (ch, cw), dtype=np.uint8))


# ---- the plain version on the CPU ------------------------------------------------

@pytest.mark.parametrize("factors", FACTORS)
def test_reference_equals_libjpeg_turbo(factors):
    rng = np.random.default_rng(sum(factors))
    for w, h in SIZES:
        y, cb, cr = _planes(w, h, factors, rng)
        ours = image_io.ycc_to_rgb_reference(*map(torch.from_numpy, (y, cb, cr)), factors)
        assert ours.dtype == torch.uint8 and ours.shape == (h, w, 3)
        np.testing.assert_array_equal(ours.numpy(), _libjpeg_rgb(y, cb, cr, factors),
                                      err_msg=f"{w}x{h} at {factors}")


def test_reference_takes_the_extremes_of_the_tables():
    """Saturated chroma against dark and bright luma clamps as range_limit
    does."""
    for factors in FACTORS:
        for yv, cv in ((0, 0), (0, 255), (255, 0), (255, 255), (16, 240)):
            y = np.full((5, 7), yv, np.uint8)
            c = np.full((-(-5 // factors[1]), -(-7 // factors[0])), cv, np.uint8)
            c[0, 0] = 255 - cv
            ours = image_io.ycc_to_rgb_reference(*map(torch.from_numpy, (y, c, c)), factors)
            np.testing.assert_array_equal(ours.numpy(), _libjpeg_rgb(y, c, c, factors))


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    y, cb, cr = map(torch.from_numpy, _planes(13, 9, (2, 2), np.random.default_rng(3)))
    before = image_io.ycc_to_rgb.launches
    torch.testing.assert_close(image_io.ycc_to_rgb(y, cb, cr, (2, 2)),
                               image_io.ycc_to_rgb_reference(y, cb, cr, (2, 2)),
                               atol=0, rtol=0)
    assert image_io.ycc_to_rgb.launches == before  # no kernel was launched
    with pytest.raises(ValueError, match="do not cover"):
        image_io.ycc_to_rgb_reference(y, cb[:2], cr[:2], (2, 2))


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
def test_colour_conversion_of_pil_upsampled_planes_is_pils_rgb():
    """PIL's fancy-upsampled YCbCr of each colour fixture through the plain
    conversion (factors 1 x 1) gives PIL's RGB bit for bit: a miss of the
    card's decode lies in the planes or the upsampling, not the tables."""
    ref = np.load(JPEG_DIR / "pil_decodes.npz")
    n = 0
    for name in ref.files:
        with Image.open(JPEG_DIR / f"{name}.jpg") as img:
            if img.mode != "RGB":
                continue
            img.draft("YCbCr", img.size)
            ycc = torch.from_numpy(np.array(img))
        rgb = image_io.ycc_to_rgb_reference(ycc[..., 0], ycc[..., 1], ycc[..., 2], (1, 1))
        np.testing.assert_array_equal(rgb.numpy(), ref[name], err_msg=name)
        n += 1
    assert n == 4


def _with_sampling(data: bytes, sampling) -> bytes:
    """``data`` with its frame header's sampling factors replaced."""
    i = data.index(b"\xff\xc0") + 4 + 6
    out = bytearray(data)
    for c, (h, v) in enumerate(sampling):
        out[i + 3 * c + 1] = h << 4 | v
    return bytes(out)


def test_other_samplings_are_refused_by_name():
    data = (JPEG_DIR / "rgb420_480x360.jpg").read_bytes()
    assert image_io.jpeg_header(data)["sampling"] == [(2, 2), (1, 1), (1, 1)]
    assert image_io.chroma_factors([(2, 2), (1, 1), (1, 1)]) == (2, 2)
    assert image_io.chroma_factors([(2, 1), (1, 1), (1, 1)]) == (2, 1)
    assert image_io.chroma_factors([(1, 2), (1, 1), (1, 1)]) == (1, 2)
    assert image_io.chroma_factors([(2, 2), (2, 2), (2, 2)]) == (1, 1)
    for sampling, name in (([(4, 1), (1, 1), (1, 1)], "4:1:1"),
                           ([(4, 2), (1, 1), (1, 1)], "4:1:0"),
                           ([(2, 2), (1, 1), (2, 1)], "unusual"),
                           ([(1, 1), (2, 2), (2, 2)], "unusual")):
        with pytest.raises(image_io.JpegDecodeError, match=name):
            image_io.chroma_factors(sampling)
        # refused from the header, before the card is asked
        with pytest.raises(image_io.JpegDecodeError, match=name):
            image_io.decode_jpeg_planes(_with_sampling(data, sampling))
    # a header that is malformed: the input's fault, by name, not a bare
    # ZeroDivisionError or unpacking error
    sof = data.index(b"\xff\xc0")
    truncated = bytearray(data)
    truncated[sof + 2 : sof + 4] = (2 + 6 + 3).to_bytes(2, "big")  # 1 of 3 components
    for bad, match in ((_with_sampling(data, [(2, 2), (0, 1), (0, 1)]), "outside 1-4"),
                       (_with_sampling(data, [(2, 2), (1, 1), (5, 1)]), "outside 1-4"),
                       (bytes(truncated), "truncated frame header")):
        with pytest.raises(image_io.JpegInputError, match=match):
            image_io.decode_jpeg_planes(bad)
        with pytest.raises(image_io.ImageInputError, match=match):
            image_io.jpeg_header(bad)


# ---- PNG --------------------------------------------------------------------------

def _png(rows: np.ndarray, depth: int, colour: int, palette=None, interlace=0) -> bytes:
    """A PNG of the packed scanlines ``rows`` ([h, stride] bytes), each
    row filtered with the type ``row % 5``, so every filter is used."""
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    h, stride = rows.shape
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour]
    bpp = max(1, channels * depth // 8)
    width = stride * 8 // (channels * depth)
    raw = bytearray()
    prev = np.zeros(stride, np.int32)
    for r in range(h):
        cur = rows[r].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        kind = r % 5
        if kind == 4:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        else:
            pred = [0 * cur, left, prev, (left + prev) >> 1][kind]
        raw += bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, h, depth, colour, 0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.tobytes())
    return out + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")


PNG_CASES = {  # name: (colour type, bit depth, samples per pixel)
    "gray1": (0, 1, 1), "gray2": (0, 2, 1), "gray4": (0, 4, 1), "gray8": (0, 8, 1),
    "gray_alpha": (4, 8, 2), "rgb": (2, 8, 3), "rgba": (6, 8, 4),
    "palette1": (3, 1, 1), "palette2": (3, 2, 1), "palette4": (3, 4, 1), "palette8": (3, 8, 1),
}


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
@pytest.mark.parametrize("name", sorted(PNG_CASES))
def test_png_matches_pil_with_every_filter(name):
    colour, depth, channels = PNG_CASES[name]
    rng = np.random.default_rng(len(name))
    for w, h in ((1, 1), (3, 7), (37, 11)):
        stride = -(-w * channels * depth // 8)
        # pad bits past the last pixel of a row stay 0, as an encoder writes them
        samples = rng.integers(0, 1 << depth, (h, w * channels), dtype=np.uint8)
        if depth < 8:
            bits = np.unpackbits(samples[..., None], axis=-1)[..., 8 - depth:].reshape(h, -1)
            rows = np.packbits(bits, axis=1)[:, :stride]
        else:
            rows = samples
        palette = (rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
                   if colour == 3 else None)
        data = _png(rows, depth, colour, palette)
        with Image.open(io.BytesIO(data)) as img:
            ref = np.asarray(img.convert("RGB"))
        np.testing.assert_array_equal(decode_png(data), ref, err_msg=f"{name} {w}x{h}")


def test_png_fixtures_decode_as_pil_did():
    """The committed PNGs (PIL's own encoder: gray, gray+alpha, RGB, RGBA,
    palette) against the PIL decodes committed beside them."""
    ref = np.load(PNG_DIR / "pil_decodes.npz")
    assert sorted(ref.files) == ["gray", "gray_alpha", "palette", "rgb", "rgba"]
    for name in ref.files:
        ours = decode_png((PNG_DIR / f"{name}.png").read_bytes())
        np.testing.assert_array_equal(ours, ref[name], err_msg=name)
    assert sum(f.stat().st_size for f in PNG_DIR.iterdir()) < 200_000


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
def test_png_fixture_generator_makes_the_committed_files(tmp_path):
    made = make_png_fixtures(tmp_path)
    ref = np.load(PNG_DIR / "pil_decodes.npz")
    for name, decoded in made.items():
        np.testing.assert_array_equal(decoded, ref[name])
        np.testing.assert_array_equal(decode_png((tmp_path / f"{name}.png").read_bytes()),
                                      ref[name])


def make_png_fixtures(out_dir, seed=11):
    """The committed PNG fixtures: a smooth 64 x 48 scene saved by PIL in
    each mode, and PIL's RGB decodes of them in ``pil_decodes.npz``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:48, 0:64]
    rgba = np.stack([xx * 4, yy * 5, (xx + yy) * 2, 255 - xx * 3], -1)
    rgba = np.clip(rgba + rng.integers(0, 8, rgba.shape), 0, 255).astype(np.uint8)
    images = {"gray": Image.fromarray(rgba[..., 0], "L"),
              "gray_alpha": Image.fromarray(rgba[..., [0, 3]], "LA"),
              "rgb": Image.fromarray(rgba[..., :3], "RGB"),
              "rgba": Image.fromarray(rgba, "RGBA"),
              "palette": Image.fromarray(rgba[..., :3], "RGB").quantize(24, dither=0)}
    decoded = {}
    for name, img in images.items():
        img.save(out_dir / f"{name}.png", "PNG")
        with Image.open(out_dir / f"{name}.png") as back:
            decoded[name] = np.asarray(back.convert("RGB"))
    np.savez_compressed(out_dir / "pil_decodes.npz", **decoded)
    return decoded


def test_png_refusals():
    rows = np.zeros((2, 8), np.uint8)
    with pytest.raises(PngDecodeError, match="16-bit"):
        decode_png(_png(rows, 16, 0))
    with pytest.raises(PngDecodeError, match="interlaced"):
        decode_png(_png(rows, 8, 0, interlace=1))
    with pytest.raises(PngDecodeError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(20))
    good = _png(rows, 8, 0)
    with pytest.raises(PngDecodeError, match="bad CRC"):
        decode_png(good[:-5] + bytes([good[-5] ^ 1]) + good[-4:])
    with pytest.raises(PngDecodeError, match="palette index"):
        decode_png(_png(np.full((2, 8), 5, np.uint8), 8, 3, np.zeros((4, 3), np.uint8)))
    with pytest.raises(PngDecodeError, match="truncated"):
        decode_png(good[:40])
    bomb = bytearray(good)  # 65536 x 65536 declared: refused before any allocation
    bomb[16:24] = struct.pack(">II", 65536, 65536)
    bomb[29:33] = struct.pack(">I", zlib.crc32(bytes(bomb[12:29])))
    with pytest.raises(PngDecodeError, match="decompression bomb"):
        decode_png(bytes(bomb))


def test_decode_rgb_routes():
    """On the card a PNG goes to ``decode_png`` and anything but a JPEG or a
    PNG is refused; without a card the default device raises rather than
    falling to PIL."""
    data = (PNG_DIR / "rgb.png").read_bytes()
    if Image is not None:
        np.testing.assert_array_equal(image_io.decode_rgb(data, "cpu"), decode_png(data))
        # PIL's refusal of bytes that are no image is the input's fault
        with pytest.raises(image_io.ImageInputError, match="PIL cannot decode"):
            image_io.decode_rgb(b"hi", "cpu")
    assert issubclass(PngDecodeError, image_io.ImageInputError)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            image_io.decode_rgb(data)


# ---- on the card ------------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_is_bit_exact_on_nvjpeg_planes():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel and nvJPEG run on the card")
    for path in sorted(JPEG_DIR.glob("*.jpg")):
        planes, factors = image_io.decode_jpeg_planes(path.read_bytes())
        if factors is None:
            continue
        before = image_io.ycc_to_rgb.launches
        with torch.cuda.stream(image_io._local.stream):
            ours = image_io.ycc_to_rgb(*planes, factors).cpu()
        assert image_io.ycc_to_rgb.launches == before + 1
        ref = image_io.ycc_to_rgb_reference(*[p.cpu() for p in planes], factors)
        torch.testing.assert_close(ours, ref, atol=0, rtol=0, msg=path.name)


@pytest.mark.cuda
@pytest.mark.parametrize("factors", FACTORS)
def test_kernel_is_bit_exact_on_seeded_planes(factors):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs on the card")
    rng = np.random.default_rng(7)
    for w, h in SIZES + [(257, 3), (480, 360)]:
        planes = [torch.from_numpy(p) for p in _planes(w, h, factors, rng)]
        ours = image_io.ycc_to_rgb(*[p.cuda() for p in planes], factors)
        torch.cuda.synchronize()
        torch.testing.assert_close(ours.cpu(), image_io.ycc_to_rgb_reference(*planes, factors),
                                   atol=0, rtol=0, msg=f"{w}x{h}")
