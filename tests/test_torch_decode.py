"""The card's JPEG route after nvJPEG: libjpeg-turbo's chroma upsampling and
YCbCr -> RGB (``image_io.ycc_to_rgb`` and its plain version
``ycc_to_rgb_reference``), and the PNG decoder ``data/png.py``.

* ``ycc_to_rgb_reference`` equals, value for value, a scalar transcription
  of libjpeg-turbo's ``h2v2_fancy_upsample``, ``h2v1_fancy_upsample``,
  ``h1v2_fancy_upsample`` (``jdsample.c``; the box ``h2v1_upsample`` and
  ``h2v2_upsample`` where ``jinit_upsampler`` picks them, and
  ``int_upsample`` for 4:1:1 and 4:1:0), the context rows of ``jdmainct.c``
  and ``ycc_rgb_convert`` with ``build_ycc_rgb_table`` (``jdcolor.c``), on
  seeded planes at even, odd, 1-row and 1-column sizes;
* without the colour matrix (a JPEG coded in RGB) the plain version is
  the transcription's upsampling of each plane;
* on the committed fixtures, PIL's own upsampled YCbCr
  (``draft("YCbCr")``) through the plain colour conversion is PIL's RGB;
  on the two coded in RGB (Adobe colour transform 0), PIL's upsampled
  planes of the same bitstream read as YCbCr, through the plain version
  without the matrix, are PIL's RGB; on the CMYK and YCCK fixtures, the
  planes PIL reads (inverted back, and the YCCK file read as CMYK for its
  raw planes) through the plain version with the K plane are PIL's RGB;
  and the plain version's CMYK and YCCK conversions are PIL's
  ``convert("RGB")`` of seeded CMYK values;
  on the 4:1:1 fixture (written by OpenCV) its chroma, taken back to one
  sample in 4, through the plain version at 4 x 1 is PIL's RGB too;
* samplings other than 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and 4:1:0 are
  refused by name; a frame header of more pixels than ``MAX_PIXELS`` is
  refused before the binding is asked for anything;
* ``decode_png`` against ``PIL.Image.open(...).convert("RGB")``, bit for
  bit, for every colour type and bit depth it takes (16 bits included) and
  each of the five row filters, Adam7-interlaced too (written by the test's
  own encoder: neither PIL nor OpenCV writes interlaced PNGs), on the
  committed ``tests/data/png`` fixtures too;
* on the card (``cuda``-marked): the kernel bit-exact against the plain
  version on nvJPEG's own planes of every fixture and on seeded planes,
  with and without the colour matrix.
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
FACTORS = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2)]
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


def _int_upsample(input_data, h_expand, v_expand):
    """int_upsample: each input sample repeated h_expand times across, each
    row so made repeated v_expand times down (jcopy_sample_rows)."""
    output_data = []
    for inptr in input_data:
        outptr = []
        for invalue in inptr:
            for _ in range(h_expand):
                outptr.append(invalue)
        for _ in range(v_expand):
            output_data.append(list(outptr))
    return output_data


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
    if hf == 4:
        return _int_upsample(rows, hf, vf)
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


@pytest.mark.parametrize("factors", FACTORS)
def test_reference_without_the_matrix_is_libjpeg_turbos_upsampling(factors):
    """A JPEG coded in RGB: the planes upsampled as the transcription does
    and written as R, G, B (``rgb_rgb_convert``)."""
    rng = np.random.default_rng(10 + sum(factors))
    for w, h in SIZES:
        y, cb, cr = _planes(w, h, factors, rng)
        ours = image_io.ycc_to_rgb_reference(*map(torch.from_numpy, (y, cb, cr)), factors,
                                             transform=False)
        up = [np.asarray(_libjpeg_upsample(p, *factors))[:h, :w] for p in (cb, cr)]
        np.testing.assert_array_equal(ours.numpy(), np.stack([y, *up], -1),
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
    torch.testing.assert_close(image_io.ycc_to_rgb(y, cb, cr, (2, 2), transform=False),
                               image_io.ycc_to_rgb_reference(y, cb, cr, (2, 2), False),
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
        if image_io.jpeg_header((JPEG_DIR / f"{name}.jpg").read_bytes())["rgb"]:
            continue  # coded in RGB: the next test
        with Image.open(JPEG_DIR / f"{name}.jpg") as img:
            if img.mode != "RGB":
                continue
            img.draft("YCbCr", img.size)
            ycc = torch.from_numpy(np.array(img))
        rgb = image_io.ycc_to_rgb_reference(ycc[..., 0], ycc[..., 1], ycc[..., 2], (1, 1))
        np.testing.assert_array_equal(rgb.numpy(), ref[name], err_msg=name)
        n += 1
    assert n == 5


def _read_as_ycbcr(data: bytes) -> bytes:
    """The JPEG ``data`` with its Adobe segment replaced by a JFIF one: the
    same bitstream, which libjpeg-turbo then reads as YCbCr."""
    i = data.index(b"\xff\xee")
    jfif = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    return data[:i] + jfif + data[i + 2 + int.from_bytes(data[i + 2 : i + 4], "big"):]


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
def test_rgb_coded_fixtures_through_the_plain_version_are_pils_rgb():
    """The fixtures coded in RGB: PIL's upsampled planes of their bitstream
    read as YCbCr (``draft("YCbCr")``, no colour conversion) through the
    plain version without the matrix (factors 1 x 1) give PIL's RGB decode
    bit for bit, for the 4:4:4 fixture and the one whose G and B planes are
    subsampled 2 x 2."""
    ref = np.load(JPEG_DIR / "pil_decodes.npz")
    names = [n for n in ref.files
             if image_io.jpeg_header((JPEG_DIR / f"{n}.jpg").read_bytes())["rgb"]]
    assert sorted(names) == ["adobergb420_98x66", "adobergb444_96x64"]
    for name in names:
        data = (JPEG_DIR / f"{name}.jpg").read_bytes()
        header = image_io.jpeg_header(data)
        assert header["adobe_transform"] == 0 and not header["jfif"]
        with Image.open(io.BytesIO(_read_as_ycbcr(data))) as img:
            assert img.mode == "RGB"
            img.draft("YCbCr", img.size)
            planes = torch.from_numpy(np.array(img))
        rgb = image_io.ycc_to_rgb_reference(*planes.unbind(-1), (1, 1), transform=False)
        np.testing.assert_array_equal(rgb.numpy(), ref[name], err_msg=name)
        # with the matrix, the same planes miss PIL's decode by far
        ycc = image_io.ycc_to_rgb_reference(*planes.unbind(-1), (1, 1))
        assert np.abs(ycc.numpy().astype(int) - ref[name]).mean() > 10, name


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
def test_cmyk_conversions_are_pils():
    """Seeded planes: CMYK (Adobe-inverted C, M, Y, K) and YCCK (Y, Cb,
    Cr through the tables, then inverted, as ``ycck_cmyk_convert``) through
    the plain version against PIL's ``cmyk2rgb`` of the CMYK that PIL's
    decoder would hold (the inverted planes)."""
    rng = np.random.default_rng(12)
    for factors in ((1, 1), (2, 2)):
        y, cb, cr = _planes(33, 17, factors, rng)
        k = rng.integers(0, 256, y.shape, dtype=np.uint8)
        t = [torch.from_numpy(a) for a in (y, cb, cr, k)]
        for transform in (False, True):
            ours = image_io.ycc_to_rgb_reference(*t[:3], factors, transform, t[3]).numpy()
            up = (np.asarray(_libjpeg_rgb(y, cb, cr, factors)) if transform else np.stack(
                [y] + [np.asarray(_libjpeg_upsample(p, *factors))[:17, :33] for p in (cb, cr)],
                -1))
            # PIL's CMYK: 255 - libjpeg's output; libjpeg's CMYK output is the
            # planes (CMYK) or 255 - the tables' RGB (YCCK)
            pil_cmy = up if transform else 255 - up
            held = np.concatenate([pil_cmy, 255 - k[..., None]], -1).astype(np.uint8)
            ref = np.asarray(Image.fromarray(held, "CMYK").convert("RGB"))
            np.testing.assert_array_equal(ours, ref, err_msg=f"{factors} {transform}")


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
def test_cmyk_and_ycck_fixtures_through_the_plain_version_are_pils_rgb():
    """The 4-component fixtures: their raw planes (PIL's CMYK inverted back;
    the YCCK file read as CMYK for them) through the plain version with
    ``k`` give PIL's RGB decode bit for bit."""
    from test_torch_data import with_adobe_transform

    ref = np.load(JPEG_DIR / "pil_decodes.npz")
    for name, ycck in (("cmyk_96x64", False), ("ycck_96x64", True)):
        data = (JPEG_DIR / f"{name}.jpg").read_bytes()
        assert image_io.jpeg_header(data)["ycck"] == ycck
        with Image.open(io.BytesIO(with_adobe_transform(data, 0))) as img:
            assert img.mode == "CMYK"
            raw = torch.from_numpy(255 - np.array(img))
        rgb = image_io.ycc_to_rgb_reference(*raw[..., :3].unbind(-1), (1, 1), ycck, raw[..., 3])
        np.testing.assert_array_equal(rgb.numpy(), ref[name], err_msg=name)


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
def test_411_fixture_through_the_plain_version_is_pils_rgb():
    """The 4:1:1 fixture: PIL's luma and its chroma taken back to one sample
    in four (libjpeg-turbo's ``int_upsample`` replicated each) through the
    plain version at 4 x 1 give PIL's RGB bit for bit."""
    data = (JPEG_DIR / "rgb411_94x64.jpg").read_bytes()
    assert image_io.jpeg_header(data)["sampling"] == [(4, 1), (1, 1), (1, 1)]
    with Image.open(io.BytesIO(data)) as img:
        img.draft("YCbCr", img.size)
        ycc = torch.from_numpy(np.array(img))
    cb, cr = ycc[:, ::4, 1].contiguous(), ycc[:, ::4, 2].contiguous()
    assert cb.shape == (64, 24)
    np.testing.assert_array_equal(
        image_io.ycc_to_rgb_reference(ycc[..., 0], cb, cr, (4, 1)).numpy(),
        np.load(JPEG_DIR / "pil_decodes.npz")["rgb411_94x64"])


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
    # 4:1:1 and 4:1:0 are decoded now, by libjpeg-turbo's int_upsample
    assert image_io.chroma_factors([(4, 1), (1, 1), (1, 1)]) == (4, 1)
    assert image_io.chroma_factors([(4, 2), (1, 1), (1, 1)]) == (4, 2)
    for sampling, name in (([(1, 4), (1, 1), (1, 1)], "unusual"),
                           ([(3, 1), (1, 1), (1, 1)], "unusual"),
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


def bomb_jpeg(width=20000, height=20000) -> bytes:
    """``rgb420_480x360.jpg`` with its frame header's size set to ``width``
    x ``height`` (400,000,000 pixels by default)."""
    data = (JPEG_DIR / "rgb420_480x360.jpg").read_bytes()
    sof = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[sof + 5 : sof + 9] = struct.pack(">HH", height, width)
    return bytes(out)


def test_bomb_sized_header_is_refused_before_the_binding(monkeypatch):
    """A frame header of more than ``MAX_PIXELS`` pixels: PIL refuses it as a
    decompression bomb, and so does the card's route, from the header,
    before the binding is built or asked and before anything is allocated
    (both stubbed here to fail the test); a header at the limit gets past
    the check to the binding."""
    header = image_io.jpeg_header((JPEG_DIR / "rgb420_480x360.jpg").read_bytes())
    assert (header["width"], header["height"]) == (480, 360)
    bomb = bomb_jpeg()
    assert (image_io.jpeg_header(bomb)["width"], image_io.jpeg_header(bomb)["height"]) == (
        20000, 20000)

    class Reached(Exception):
        pass

    def reached(*args, **kwargs):
        raise Reached

    monkeypatch.setattr(image_io, "_lib", reached)
    monkeypatch.setattr(torch, "empty", reached)
    with pytest.raises(image_io.JpegInputError, match="decompression bomb"):
        image_io.decode_jpeg_planes(bomb)
    with pytest.raises(Reached):  # 65535 x 2730 = 178,910,550 pixels: not a bomb
        image_io.decode_jpeg_planes(bomb_jpeg(65535, 2730))
    assert 65535 * 2730 <= image_io.MAX_PIXELS < 65535 * 2731
    if Image is not None:
        with pytest.raises(Image.DecompressionBombError):
            Image.open(io.BytesIO(bomb))
        with pytest.raises(image_io.ImageInputError):
            image_io.decode_rgb(bomb, "cpu")


# ---- PNG --------------------------------------------------------------------------

def _chunk(kind, payload):
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
        ">I", zlib.crc32(kind + payload))


def _filtered(rows: np.ndarray, bpp: int) -> bytes:
    """The packed scanlines ``rows`` ([h, stride] bytes), each row filtered
    with the type ``row % 5``, so every filter is used."""
    h, stride = rows.shape
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
    return bytes(raw)


def _file(width, height, depth, colour, raw: bytes, palette=None, interlace=0) -> bytes:
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", width, height, depth, colour, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png(rows: np.ndarray, depth: int, colour: int, palette=None, interlace=0) -> bytes:
    """A PNG of the packed scanlines ``rows`` ([h, stride] bytes), filtered
    by ``_filtered``; ``interlace`` is only written in the header."""
    h, stride = rows.shape
    channels = CHANNELS[colour]
    width = stride * 8 // (channels * depth)
    raw = _filtered(rows, max(1, channels * depth // 8))
    return _file(width, h, depth, colour, raw, palette, interlace)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """Samples ``[h, w, channels]`` -> packed scanlines ``[h, stride]``:
    sub-byte samples most significant bits first, the pad bits past the
    last pixel 0; 16-bit samples big-endian."""
    h = samples.shape[0]
    if depth < 8:
        bits = np.unpackbits(samples.astype(np.uint8).reshape(h, -1, 1), axis=-1)
        return np.packbits(bits[..., 8 - depth:].reshape(h, -1), axis=1)
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    return samples.reshape(h, -1).astype(np.uint8)


def _adam7_png(samples: np.ndarray, depth: int, colour: int, palette=None) -> bytes:
    """An Adam7-interlaced PNG of ``samples`` ``[h, w, channels]``: each of
    the 7 passes' pixels packed and filtered on their own, an empty pass
    left out (PNG specification, section 8.2)."""
    h, w, channels = samples.shape
    bpp = max(1, channels * depth // 8)
    raw = b""
    for x0, y0, dx, dy in ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
                           (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filtered(_pack(sub, depth), bpp)
    return _file(w, h, depth, colour, raw, palette, interlace=1)


def _seeded_samples(colour, depth, w, h, rng):
    """Samples of every value a depth takes; 16-bit gray half under 512, so
    that PIL's clamp to 255 is not all that is seen."""
    samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[colour]), dtype=np.int64)
    if depth == 16 and colour == 0:
        samples[::2] %= 512
    return samples.astype(np.uint16 if depth == 16 else np.uint8)


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


PNG_CASES = {  # name: (colour type, bit depth, samples per pixel)
    "gray1": (0, 1, 1), "gray2": (0, 2, 1), "gray4": (0, 4, 1), "gray8": (0, 8, 1),
    "gray_alpha": (4, 8, 2), "rgb": (2, 8, 3), "rgba": (6, 8, 4),
    "palette1": (3, 1, 1), "palette2": (3, 2, 1), "palette4": (3, 4, 1), "palette8": (3, 8, 1),
    "gray16": (0, 16, 1), "gray_alpha16": (4, 16, 2), "rgb16": (2, 16, 3),
    "rgba16": (6, 16, 4),
}


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
@pytest.mark.parametrize("name", sorted(PNG_CASES))
def test_png_matches_pil_with_every_filter(name):
    colour, depth, channels = PNG_CASES[name]
    rng = np.random.default_rng(len(name))
    for w, h in ((1, 1), (3, 7), (37, 11)):
        samples = _seeded_samples(colour, depth, w, h, rng)
        palette = (rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
                   if colour == 3 else None)
        data = _png(_pack(samples, depth), depth, colour, palette)
        np.testing.assert_array_equal(decode_png(data), _pil_rgb(data),
                                      err_msg=f"{name} {w}x{h}")


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
@pytest.mark.parametrize("name", sorted(PNG_CASES))
def test_adam7_png_matches_pil(name):
    """Adam7-interlaced PNGs of each colour type and bit depth, at sizes
    where some passes are empty (1 x 1, 3 x 7) and none is (37 x 11)."""
    colour, depth, channels = PNG_CASES[name]
    rng = np.random.default_rng(100 + len(name))
    for w, h in ((1, 1), (3, 7), (5, 2), (37, 11)):
        samples = _seeded_samples(colour, depth, w, h, rng)
        palette = (rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
                   if colour == 3 else None)
        data = _adam7_png(samples, depth, colour, palette)
        np.testing.assert_array_equal(decode_png(data), _pil_rgb(data),
                                      err_msg=f"{name} {w}x{h} interlaced")


def test_png_fixtures_decode_as_pil_did():
    """The committed PNGs (PIL's own encoder: gray, gray+alpha, RGB, RGBA,
    palette; OpenCV's: 16-bit gray, RGB and RGBA) against the PIL decodes
    committed beside them."""
    ref = np.load(PNG_DIR / "pil_decodes.npz")
    assert sorted(ref.files) == ["gray", "gray16", "gray_alpha", "palette", "rgb", "rgb16",
                                 "rgba", "rgba16"]
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
    each mode, and as 16-bit gray, RGB and RGBA by OpenCV (PIL writes no
    16-bit colour PNG), and PIL's RGB decodes of them in
    ``pil_decodes.npz``."""
    import cv2

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
    deep = (rgba.astype(np.uint16) * 257 + rng.integers(0, 257, rgba.shape)).astype(np.uint16)
    deep[::2, :, 0] //= 160  # 16-bit gray: values under 256 too, where PIL does not clamp
    for name, img in images.items():
        img.save(out_dir / f"{name}.png", "PNG")
    for name, arr in (("gray16", deep[..., 0]), ("rgb16", deep[..., 2::-1]),
                      ("rgba16", deep[..., [2, 1, 0, 3]])):  # OpenCV writes BGR(A)
        assert cv2.imwrite(str(out_dir / f"{name}.png"), np.ascontiguousarray(arr))
    decoded = {}
    for name in [*images, "gray16", "rgb16", "rgba16"]:
        with Image.open(out_dir / f"{name}.png") as back:
            decoded[name] = np.asarray(back.convert("RGB"))
    np.savez_compressed(out_dir / "pil_decodes.npz", **decoded)
    return decoded


def test_png_refusals():
    rows = np.zeros((2, 8), np.uint8)
    # 16-bit samples and Adam7 are decoded now; a 16-bit palette and an
    # interlace method other than Adam7 are not PNGs
    np.testing.assert_array_equal(decode_png(_png(rows, 16, 0)), np.zeros((2, 4, 3)))
    np.testing.assert_array_equal(decode_png(_adam7_png(np.zeros((2, 8, 1)), 8, 0)),
                                  np.zeros((2, 8, 3)))
    with pytest.raises(PngDecodeError, match="malformed PNG header"):
        decode_png(_png(rows, 16, 3, np.zeros((4, 3), np.uint8)))
    with pytest.raises(PngDecodeError, match="malformed PNG header"):
        decode_png(_png(rows, 8, 0, interlace=2))
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
        planes, factors, transform = image_io.decode_jpeg_planes(path.read_bytes())
        if factors is None:
            continue
        assert transform == path.name.startswith(("rgb", "odd", "progressive", "ycck")), \
            path.name
        assert len(planes) == (4 if path.name.startswith(("cmyk", "ycck")) else 3)
        before = image_io.ycc_to_rgb.launches
        with torch.cuda.stream(image_io._local.stream):
            ours = image_io.planes_to_rgb(planes, factors, transform).cpu()
        assert image_io.ycc_to_rgb.launches == before + 1
        ref = image_io.planes_to_rgb([p.cpu() for p in planes], factors, transform,
                                     reference=True)
        torch.testing.assert_close(ours, ref, atol=0, rtol=0, msg=path.name)


@pytest.mark.cuda
@pytest.mark.parametrize("with_k", [False, True])
@pytest.mark.parametrize("transform", [True, False])
@pytest.mark.parametrize("factors", FACTORS)
def test_kernel_is_bit_exact_on_seeded_planes(factors, transform, with_k):
    """YCbCr, R, G, B planes, and with a K plane YCCK and CMYK."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs on the card")
    rng = np.random.default_rng(7)
    for w, h in SIZES + [(257, 3), (480, 360)]:
        planes = [torch.from_numpy(p) for p in _planes(w, h, factors, rng)]
        if with_k:
            planes.append(torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8)))
        ours = image_io.planes_to_rgb([p.cuda() for p in planes], factors, transform)
        torch.cuda.synchronize()
        torch.testing.assert_close(
            ours.cpu(), image_io.planes_to_rgb(planes, factors, transform, reference=True),
            atol=0, rtol=0, msg=f"{w}x{h}")
