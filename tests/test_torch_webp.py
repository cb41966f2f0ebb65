"""The port's WebP decoder (``vtc_tpu_torch/data/webp.py`` and
``csrc/host/webp_decode.cpp``) against PIL's ``Image.open(...).convert(
"RGB")``, the reader of every image in ``vtc_tpu``, bit for bit.

* The committed fixtures of ``tests/data/webp`` (the system's libwebp
  encoder and muxer through ``tests/data/webp/make_fixtures.py``: lossy at
  every setting that changes what the decoder reads, lossless with every
  transform and palette bundling, alpha raw and compressed under each
  filter, ``VP8X`` with metadata, an animation's offset first frame) through
  ``decode_webp`` and through ``decode_rgb``'s host route, against the PIL
  decodes committed beside them and, where PIL is installed, PIL itself
  (alpha included).
* Seeded mutations of ten fixtures (truncations, bit flips, overwritten
  bytes, the headers' bytes): the same pixels wherever PIL decodes the
  mutated file, ``WebpDecodeError`` wherever PIL raises.
* The refusals: a canvas over ``MAX_PIXELS`` from its header, before the
  decoder is called; bytes that are no WebP; a truncated file.
* The decoder built with ``-fsanitize=address,undefined`` as a standalone
  program, over the fixtures' and the mutations' bitstreams: no report, and
  the return codes of the library.
"""

import importlib.util
import io
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    from PIL import Image
except ImportError:  # the card's machine: the committed decodes are the reference
    Image = None

from vtc_tpu_torch.data import image_io, webp
from vtc_tpu_torch.data.webp import WebpDecodeError, decode_webp, decode_webp_rgba
from vtc_tpu_torch.ops import _build

DIR = Path(__file__).resolve().parent / "data" / "webp"
MUTATED = ("lossy_q75_m4", "lossy_partitions8", "lossy_q0_m0", "lossy_3x5",
           "lossless_m6_q100", "lossless_4colours", "alpha_quad_c1_f2_q100",
           "alpha_written_m1_f3", "vp8x_meta_alpha", "anim_lossy")


def _fixtures():
    return sorted(p.name for p in DIR.glob("*.webp"))


def _pil(data: bytes, mode: str = "RGB"):
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert(mode)), img.mode


def _host_route(data: bytes, monkeypatch) -> np.ndarray:
    """``decode_rgb`` with the card named: the host decoders, the JPEG
    binding never asked for."""
    def no_binding(stem):
        raise AssertionError(f"the JPEG binding {stem} was asked for")

    monkeypatch.setattr(image_io, "resolve_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(image_io._build, "load_library", no_binding)
    return image_io.decode_rgb(data, None, "<fixture>")


def test_fixtures_decode_as_pil_did(monkeypatch):
    ref = np.load(DIR / "pil_decodes.npz")
    names = _fixtures()
    assert sorted(n.replace(".", "_") for n in names) == sorted(ref.files)
    assert len(names) == 50
    for name in names:
        data = (DIR / name).read_bytes()
        expected = ref[name.replace(".", "_")]
        np.testing.assert_array_equal(decode_webp(data), expected, err_msg=name)
        np.testing.assert_array_equal(_host_route(data, monkeypatch), expected, err_msg=name)
        if Image is not None:  # PIL itself, and the alpha it keeps
            np.testing.assert_array_equal(_pil(data)[0], expected, err_msg=name)
            rgba, mode = _pil(data, "RGBA")
            if mode == "RGBA":
                np.testing.assert_array_equal(decode_webp_rgba(data), rgba, err_msg=name)
    assert sum(f.stat().st_size for f in DIR.iterdir()) < 1_200_000


def _bool_bits(buf: bytes):
    """RFC 6386's boolean decoder, a bit of probability 1/2 at a time."""
    value, rng, count, pos = 0, 255, 0, 0
    while True:
        while count < 16:
            value = (value << 8) | (buf[pos] if pos < len(buf) else 0)
            pos, count = pos + 1, count + 8
        split = 1 + (((rng - 1) * 128) >> 8)
        big = split << (count - 8)
        bit = value >= big
        rng, value = (rng - split, value - big) if bit else (split, value)
        while rng < 128:
            rng, count = rng << 1, count - 1
        yield int(bit)


def _vp8_header(data: bytes) -> dict:
    """The key frame header's segment, filter and partition fields."""
    vp8 = data[data.index(b"VP8 ") + 8:]
    bits = _bool_bits(vp8[10:10 + (int.from_bytes(vp8[:3], "little") >> 5)])

    def value(n):
        v = 0
        for _ in range(n):
            v = (v << 1) | next(bits)
        return v

    value(2)  # colour space, clamping
    out = {"segments": value(1)}
    if out["segments"]:
        update_map, update_data = value(1), value(1)
        if update_data:
            value(1)
            for width in (7,) * 4 + (6,) * 4:
                if value(1):
                    value(width + 1)
        if update_map:
            for _ in range(3):
                if value(1):
                    value(8)
    out["simple"], out["level"], out["sharpness"] = value(1), value(6), value(3)
    if value(1) and value(1):
        for _ in range(8):
            if value(1):
                value(7)
    out["partitions"] = 1 << value(2)
    return out


def _chunks(data: bytes):
    """(tag, payload) of the chunks inside a RIFF file and its ANMF chunks."""
    def walk(buf):
        at = 0
        while at + 8 <= len(buf):
            tag, size = buf[at:at + 4], struct.unpack("<I", buf[at + 4:at + 8])[0]
            payload = buf[at + 8:at + 8 + size]
            yield tag, payload
            if tag == b"ANMF":
                yield from walk(payload[16:])
            at += 8 + size + (size & 1)
    return list(walk(data[12:]))


def test_fixtures_cover_the_decoder():
    """The fixtures reach every path of the decoder: both loop filters,
    sharpness, segments, 1-8 partitions; alpha raw and compressed under all
    four filters; VP8L with each colour-indexing bundling; VP8X metadata and
    an offset animation frame."""
    headers = {n: _vp8_header((DIR / n).read_bytes()) for n in _fixtures()
               if n.startswith("lossy_")}
    assert {h["partitions"] for h in headers.values()} == {1, 2, 4, 8}
    assert {h["simple"] for h in headers.values()} == {0, 1}
    assert {h["segments"] for h in headers.values()} == {0, 1}
    assert {h["sharpness"] for h in headers.values()} >= {0, 7}
    assert 0 in {h["level"] for h in headers.values()} and max(
        h["level"] for h in headers.values()) == 63
    alph = {(p[0] & 3, (p[0] >> 2) & 3) for n in _fixtures()
            for tag, p in _chunks((DIR / n).read_bytes()) if tag == b"ALPH"}
    assert {m for m, _ in alph} == {0, 1} and {f for _, f in alph} == {0, 1, 2, 3}
    bundling = set()
    for n in _fixtures():
        for tag, p in _chunks((DIR / n).read_bytes()):
            bits = int.from_bytes(p[5:7], "little")  # after the 40-bit header
            if tag == b"VP8L" and bits & 1 and (bits >> 1) & 3 == 3:  # colour indexing first
                colours = ((bits >> 3) & 0xFF) + 1
                bundling.add(0 if colours > 16 else 1 if colours > 4 else 2 if colours > 2 else 3)
    assert bundling == {0, 1, 2, 3}
    tags = {t for n in _fixtures() for t, _ in _chunks((DIR / n).read_bytes())}
    assert {b"ICCP", b"EXIF", b"ANIM", b"ANMF", b"VP8X"} <= tags


def _make_fixtures():
    spec = importlib.util.spec_from_file_location("make_webp_fixtures", DIR / "make_fixtures.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
def test_fixture_generator_makes_the_committed_files(tmp_path):
    module = _make_fixtures()
    try:
        files, decoded = module.make_webp_fixtures(tmp_path)
    except module.EncoderUnavailable as e:
        pytest.skip(f"no system libwebp encoder: {e}")
    ref = np.load(DIR / "pil_decodes.npz")
    assert sorted(files) == _fixtures()
    for name, data in files.items():
        assert data == (DIR / name).read_bytes(), name
        np.testing.assert_array_equal(decoded[name.replace(".", "_")],
                                      ref[name.replace(".", "_")])


def mutations(seed: int, n: int):
    """``n`` seeded mutations of the ``MUTATED`` fixtures: a truncation, 1-3
    bit flips, 1-7 overwritten bytes, or one byte of the first 60 (the RIFF,
    VP8X, ANMF and frame headers)."""
    rng = np.random.default_rng(seed)
    originals = [(DIR / f"{name}.webp").read_bytes() for name in MUTATED]
    for _ in range(n):
        data = bytearray(originals[rng.integers(len(originals))])
        kind = rng.integers(4)
        if kind == 0:
            data = data[:rng.integers(0, len(data))]
        elif kind == 1:
            for _ in range(rng.integers(1, 4)):
                data[rng.integers(len(data))] ^= 1 << rng.integers(8)
        elif kind == 2:
            at, k = rng.integers(len(data)), rng.integers(1, 8)
            data[at:at + k] = bytes(rng.integers(0, 256, k, dtype=np.uint8))[:len(data) - at]
        else:
            data[rng.integers(0, min(60, len(data)))] = rng.integers(256)
        yield bytes(data)


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
def test_mutations_agree_with_pil():
    decoded = refused = 0
    for i, data in enumerate(mutations(22, 3000)):
        try:
            expected = _pil(data)[0]
        except Exception:  # noqa: BLE001 - any refusal of PIL's
            with pytest.raises(WebpDecodeError):
                decode_webp(data)
            refused += 1
            continue
        np.testing.assert_array_equal(decode_webp(data), expected, err_msg=f"mutation {i}")
        decoded += 1
    assert decoded > 800 and refused > 800  # both outcomes are exercised


def bomb_webp() -> bytes:
    """A lossless WebP whose header says 16384 x 16384 (268M pixels), with
    a few bytes of stream."""
    header = 0x2F | (16383 << 8) | (16383 << 22)
    vp8l = header.to_bytes(5, "little") + bytes(7)
    return b"RIFF" + struct.pack("<I", 4 + 8 + len(vp8l)) + b"WEBPVP8L" + struct.pack(
        "<I", len(vp8l)) + vp8l


def test_refusals(monkeypatch):
    """A bomb-sized canvas is refused from its header, the decoder never
    called; a truncated file, a RIFF of another kind, an unknown first chunk:
    ``WebpDecodeError``, an ``ImageInputError``, as PIL refuses them."""
    monkeypatch.setattr(webp, "_lib", lambda: pytest.fail("the decoder was called"))
    with pytest.raises(WebpDecodeError, match="decompression bomb"):
        decode_webp(bomb_webp())
    with pytest.raises(WebpDecodeError, match="decompression bomb"):
        _host_route(bomb_webp(), monkeypatch)
    monkeypatch.undo()
    data = (DIR / "lossy_q75_m4.webp").read_bytes()
    refused = [data[:len(data) // 2], b"RIFF" + data[4:8] + b"AVI " + data[12:],
               data[:12] + b"VP9 " + data[16:]]
    with pytest.raises(WebpDecodeError, match="truncated"):
        decode_webp(refused[0])
    for bad in refused[1:]:
        with pytest.raises(WebpDecodeError, match="not a WebP"):
            decode_webp(bad)
    assert issubclass(WebpDecodeError, image_io.ImageInputError)
    if Image is not None:  # PIL refuses them too
        for bad in [bomb_webp()] + refused:
            with pytest.raises(Exception):
                _pil(bad)


def _cases(datas):
    """The bitstreams of each file the container parse lets through, as the
    standalone sanitizer build reads them."""
    out = bytearray()
    for data in datas:
        try:
            f = webp.locate_frame0(data)
        except WebpDecodeError:
            continue
        alpha = b"" if f.alpha is None else bytes(f.alpha)
        out += struct.pack("<BIIII", int(f.lossless), *f.size, len(f.bitstream),
                           0xFFFFFFFF if f.alpha is None else len(alpha))
        out += bytes(f.bitstream) + alpha
    return bytes(out)


def test_sanitizers_report_nothing(tmp_path):
    """One build of the decoder with AddressSanitizer and UBSan as a
    standalone program, over every fixture's and 1500 mutations'
    bitstreams: it exits cleanly, reports nothing, and returns what the
    library returns."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found")
    exe = tmp_path / "webp_decode_main"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=undefined", "-DVTC_WEBP_MAIN", "-o", str(exe),
         str(_build.HOST_DIR / "webp_decode.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-2000:]
    datas = [(DIR / n).read_bytes() for n in _fixtures()] + list(mutations(23, 1500))
    cases = tmp_path / "cases.bin"
    cases.write_bytes(_cases(datas))
    run = subprocess.run([str(exe), str(cases)], capture_output=True, text=True, timeout=120,
                         env={"ASAN_OPTIONS": "detect_leaks=1:abort_on_error=0",
                              "UBSAN_OPTIONS": "print_stacktrace=1"})
    assert run.returncode == 0, run.stderr[-3000:]
    assert "runtime error" not in run.stderr and "Sanitizer" not in run.stderr, run.stderr[-3000:]
    codes = [int(line) for line in run.stdout.split()]
    expected = []
    for data in datas:
        try:
            webp.locate_frame0(data)
        except WebpDecodeError:
            continue
        try:
            decode_webp(data)
            expected.append(0)
        except WebpDecodeError as e:
            expected.append(next(k for k, v in webp.DECODE_ERRORS.items() if v in str(e)))
    assert codes == expected
    assert codes.count(0) > 100 and len(set(codes)) > 3
