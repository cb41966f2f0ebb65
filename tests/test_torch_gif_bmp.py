"""The port's GIF and BMP decoders (``vtc_tpu_torch/data/gif.py``,
``data/bmp.py``) against PIL's ``Image.open(...).convert("RGB")``, the
reader of every thumbnail in ``vtc_tpu``, bit for bit.

* The committed fixtures of ``tests/data/gif_bmp`` (PIL's own GIF and BMP
  encoders, and the writers below for what PIL does not write: a local
  palette, a frame offset on or grown past the logical screen, 4-bit,
  16-bit, 32-bit, bitfields, RLE8/RLE4, top-down rows, the OS/2 header)
  through ``decode_rgb``'s host route (the card named, the JPEG binding
  stubbed to fail if asked) against the PIL decodes committed beside them;
  the generator ``make_gif_bmp_fixtures`` makes those files again.
* Seeded images of every kind through both decoders and through PIL, at
  sizes with ragged rows (1 x 1, 3 x 7, 37 x 11).
* The refusals: a bomb-sized header (before any pixel), a truncated file,
  bytes that are no GIF or BMP, each an ``ImageInputError``.

The server's 400s for the bomb and the truncated file are in
``tests/test_torch_server.py``.
"""

import io
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    from PIL import Image
except ImportError:  # the card's machine: the committed decodes are the reference
    Image = None

from vtc_tpu_torch.data import image_io
from vtc_tpu_torch.data.bmp import BmpDecodeError, decode_bmp
from vtc_tpu_torch.data.gif import GifDecodeError, decode_gif

DIR = Path(__file__).resolve().parent / "data" / "gif_bmp"


def _pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as img:
        return np.asarray(img.convert("RGB"))


# ---- writers for what PIL does not write ------------------------------------------

def lzw_encode(indices: np.ndarray, code_size: int, clear_every: int = 0) -> bytes:
    """GIF LZW of ``indices`` at the minimum code size ``code_size``: a clear
    code first, the table grown to 12 bits (then a clear), an end code;
    ``clear_every`` > 0 also clears after that many codes."""
    clear, end = 1 << code_size, (1 << code_size) + 1
    out, acc, nacc = bytearray(), 0, 0
    bits = code_size + 1

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += bits
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    def reset():
        nonlocal bits
        bits = code_size + 1
        return {bytes((i,)): i for i in range(clear)}

    emit(clear)
    table, nxt, cur, emitted = reset(), end + 1, b"", 0
    for v in bytes(np.asarray(indices, np.uint8).ravel()):
        nxt_str = cur + bytes((v,))
        if nxt_str in table:
            cur = nxt_str
            continue
        emit(table[cur])
        emitted += 1
        if nxt < 4096:
            table[nxt_str] = nxt
            nxt += 1
            if nxt - 1 == (1 << bits) and bits < 12:
                bits += 1
        if nxt == 4096 or (clear_every and emitted % clear_every == 0):
            emit(clear)
            table, nxt = reset(), end + 1
        cur = bytes((v,))
    if cur:
        emit(table[cur])
    emit(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(payload: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(payload), 255):
        chunk = payload[i:i + 255]
        out += bytes((len(chunk),)) + chunk
    return bytes(out) + b"\x00"


def write_gif(frame: np.ndarray, screen=None, offset=(0, 0), global_palette=None,
              local_palette=None, transparency=None, interlace=False, code_size=None,
              version=b"GIF89a", clear_every=0, extra_frame=None) -> bytes:
    """A GIF of the index array ``frame`` at ``offset`` on a ``screen`` of
    (w, h), with the palettes, transparent index and interlace given."""
    fh, fw = frame.shape
    sw, sh = screen or (fw, fh)

    def pal_bits(pal):
        return max(1, int(np.ceil(np.log2(max(len(pal), 2)))))

    def pal_bytes(pal):
        n = 1 << pal_bits(pal)
        full = np.zeros((n, 3), np.uint8)
        full[:len(pal)] = pal
        return full.tobytes()

    flags = 0
    if global_palette is not None:
        flags = 0x80 | 0x70 | (pal_bits(global_palette) - 1)
    out = bytearray(version + struct.pack("<HHBBB", sw, sh, flags, 0, 0))
    if global_palette is not None:
        out += pal_bytes(global_palette)

    def image(frame, offset, transparency):
        fh, fw = frame.shape
        img = bytearray()
        if transparency is not None:
            img += b"\x21\xf9\x04" + bytes((1,)) + b"\x00\x00" + bytes((transparency,)) + b"\x00"
        lflags = 0x40 if interlace else 0
        if local_palette is not None:
            lflags |= 0x80 | (pal_bits(local_palette) - 1)
        img += b"\x2c" + struct.pack("<HHHHB", offset[0], offset[1], fw, fh, lflags)
        if local_palette is not None:
            img += pal_bytes(local_palette)
        rows = frame
        if interlace:
            order = np.concatenate([np.arange(f, fh, s) for f, s in
                                    ((0, 8), (4, 8), (2, 4), (1, 2))])
            rows = frame[order]
        cs = code_size or max(2, int(frame.max()).bit_length())
        img += bytes((cs,)) + _sub_blocks(lzw_encode(rows, cs, clear_every))
        return img

    out += b"\x21\xfe" + _sub_blocks(b"a comment before the frame")
    out += image(frame, offset, transparency)
    if extra_frame is not None:
        out += image(extra_frame, (0, 0), None)
    return bytes(out) + b"\x3b"


def write_bmp(pixels: np.ndarray, bits: int, palette=None, compression=0, masks=None,
              top_down=False, header=40, colors=None) -> bytes:
    """A BMP of ``pixels`` (indices ``[h, w]`` for ``bits`` <= 8, else RGB
    ``[h, w, 3]``, or ``[h, w, 4]`` bytes of 32-bit pixels as stored):
    ``compression`` 0 (BI_RGB), 1/2 (RLE8/RLE4: one absolute run of each
    row's pixels or runs of equal ones) or 3 (BI_BITFIELDS, ``masks``)."""
    h, w = pixels.shape[:2]
    rows = pixels if top_down else pixels[::-1]
    if compression in (1, 2):
        body = bytearray()
        for row in rows:
            body += _rle_row(row, compression == 2)
        body += b"\x00\x01"
        body = bytes(body)
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        body = bytearray()
        for row in rows:
            if bits < 8:
                vals = np.zeros(-(-w * bits // 8) * 8 // bits, np.uint8)
                vals[:w] = row
                packed = np.packbits(np.unpackbits(vals[:, None], axis=1)[:, 8 - bits:])
                raw = packed.tobytes()
            elif bits == 8:
                raw = row.astype(np.uint8).tobytes()
            elif bits == 16:
                raw = row.astype("<u2").tobytes()
            elif bits == 24:
                raw = row[:, ::-1].astype(np.uint8).tobytes()  # B, G, R
            else:
                raw = row.astype(np.uint8).tobytes()  # as stored
            body += raw + bytes(stride - len(raw))
        body = bytes(body)
    pal = b""
    if palette is not None:
        entry = 3 if header == 12 else 4
        p = np.zeros((len(palette), entry), np.uint8)
        p[:, :3] = np.asarray(palette)[:, ::-1]  # B, G, R (, 0)
        pal = p.tobytes()
    if header == 12:
        dib = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        height = (2**32 - h) if top_down else h
        dib = struct.pack("<IiIHHIIiiII", header, w, height, 1, bits, compression, len(body),
                          2835, 2835, colors if colors is not None else 0, 0)
        if header > 40:
            m = list(masks or (0, 0, 0, 0)) + [0] * 4
            dib += struct.pack("<4I", *m[:4])[:header - 40]
            dib += bytes(header - len(dib))
    extra = b""
    if compression == 3 and header == 40:
        extra = struct.pack("<3I", *masks[:3])
    offset = 14 + len(dib) + len(extra) + len(pal)
    head = b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
    return head + dib + extra + pal + body


def _rle_row(row, rle4: bool) -> bytes:
    """One row as runs of equal pixels (run length up to 255), with an
    absolute-mode stretch where pixels differ, then an end of line."""
    out = bytearray()
    row = [int(v) for v in row]
    i = 0
    while i < len(row):
        j = i
        while j < len(row) and j - i < 254 and row[j] == row[i]:
            j += 1
        if j - i >= 3 or len(row) - i < 3:
            n = j - i
            out += bytes((n, (row[i] << 4) | row[i] if rle4 else row[i]))
            i = j
            continue
        k = i
        while k < len(row) and k - i < 254 and not (
                k + 2 < len(row) and row[k] == row[k + 1] == row[k + 2]):
            k += 1
        n = k - i
        if n < 3:  # absolute mode needs 3 or more
            out += bytes((1, (row[i] << 4) | row[i] if rle4 else row[i]))
            i += 1
            continue
        if rle4 and n % 2:
            n -= 1  # PIL reads byte // 2 bytes: an even count
        vals = row[i:i + n]
        if rle4:
            payload = bytes((vals[t] << 4) | vals[t + 1] for t in range(0, n, 2))
        else:
            payload = bytes(vals)
        out += bytes((0, n)) + payload + (b"\x00" if len(payload) % 2 else b"")
        i += n
    return bytes(out) + b"\x00\x00"


# ---- the committed fixtures ---------------------------------------------------------

def _scene(rng, w=64, h=48):
    yy, xx = np.mgrid[0:h, 0:w]
    rgb = np.stack([xx * 4, yy * 5, (xx + yy) * 2], -1)
    return np.clip(rgb + rng.integers(0, 8, rgb.shape), 0, 255).astype(np.uint8)


def make_gif_bmp_fixtures(out_dir, seed=16):
    """The committed GIF and BMP fixtures (PIL's encoders and the writers
    above, on a smooth 64 x 48 scene and seeded indices) and PIL's RGB
    decodes of them in ``pil_decodes.npz``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    rgb = _scene(rng)
    quant = Image.fromarray(rgb, "RGB").quantize(24, dither=0)
    idx = np.asarray(quant)
    pal = np.asarray(quant.getpalette()[:3 * 24], np.uint8).reshape(24, 3)
    files = {}
    buf = io.BytesIO()
    quant.save(buf, "GIF")  # PIL interlaces a GIF of 16 rows or more
    files["pil_interlaced.gif"] = buf.getvalue()
    buf = io.BytesIO()
    quant.save(buf, "GIF", interlace=False, transparency=3)
    files["pil_transparent.gif"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(rgb[..., 1], "L").save(buf, "GIF")
    files["pil_gray.gif"] = buf.getvalue()
    small = idx[5:35, 7:47]
    files["local_offset.gif"] = write_gif(
        small, screen=(64, 48), offset=(7, 5), global_palette=pal[::-1],
        local_palette=pal, transparency=9, version=b"GIF87a")
    files["grown_past_screen.gif"] = write_gif(
        idx[:40, :50], screen=(40, 30), offset=(10, 8), global_palette=pal, interlace=True)
    files["animated.gif"] = write_gif(idx, global_palette=pal, extra_frame=idx[::-1])
    files["index_past_palette.gif"] = write_gif(
        (idx * 5 % 64).astype(np.uint8), global_palette=pal[:16], code_size=6,
        clear_every=100)
    for mode, name in (("1", "pil_1bit.bmp"), ("L", "pil_gray.bmp"), ("P", "pil_palette.bmp"),
                       ("RGB", "pil_rgb.bmp")):
        buf = io.BytesIO()
        img = quant if mode == "P" else Image.fromarray(rgb, "RGB").convert(mode)
        img.save(buf, "BMP")
        files[name] = buf.getvalue()
    idx16 = (idx % 16).astype(np.uint8)
    pal16 = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    files["rle8.bmp"] = write_bmp(idx, 8, pal, compression=1)
    files["rle4.bmp"] = write_bmp(idx16, 4, pal16, compression=2)
    files["4bit_top_down.bmp"] = write_bmp(idx16, 4, pal16, top_down=True)
    files["os2_8bit.bmp"] = write_bmp(idx, 8, np.resize(pal, (256, 3)), header=12)
    r5 = (rgb.astype(np.uint32) >> 3)
    files["16bit_555.bmp"] = write_bmp(r5[..., 0] << 10 | r5[..., 1] << 5 | r5[..., 2], 16)
    files["16bit_565_bitfields.bmp"] = write_bmp(
        r5[..., 0] << 11 | (rgb[..., 1].astype(np.uint32) >> 2) << 5 | r5[..., 2], 16,
        compression=3, masks=(0xF800, 0x7E0, 0x1F))
    bgrx = np.concatenate([rgb[..., ::-1], rng.integers(0, 256, rgb.shape[:2] + (1,),
                                                        dtype=np.uint8)], -1)
    files["32bit.bmp"] = write_bmp(bgrx, 32)
    xbgr = np.concatenate([bgrx[..., 3:], bgrx[..., :3]], -1)  # X, B, G, R in memory
    files["32bit_xbgr_v5.bmp"] = write_bmp(xbgr, 32, compression=3, header=124,
                                           masks=(0xFF000000, 0xFF0000, 0xFF00, 0))
    files["32bit_bgra_top_down.bmp"] = write_bmp(bgrx, 32, compression=3, header=108,
                                                 top_down=True,
                                                 masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    decoded = {}
    for name, data in files.items():
        (out_dir / name).write_bytes(data)
        decoded[name.replace(".", "_")] = _pil_rgb(data)
    np.savez_compressed(out_dir / "pil_decodes.npz", **decoded)
    return files, decoded


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
    names = sorted(p.name for p in DIR.iterdir() if p.suffix in (".gif", ".bmp"))
    assert sorted(n.replace(".", "_") for n in names) == sorted(ref.files)
    assert len(names) == 20
    for name in names:
        ours = _host_route((DIR / name).read_bytes(), monkeypatch)
        np.testing.assert_array_equal(ours, ref[name.replace(".", "_")], err_msg=name)
    assert sum(f.stat().st_size for f in DIR.iterdir()) < 400_000


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
def test_fixture_generator_makes_the_committed_files(tmp_path):
    files, decoded = make_gif_bmp_fixtures(tmp_path)
    ref = np.load(DIR / "pil_decodes.npz")
    for name, data in files.items():
        assert data == (DIR / name).read_bytes(), name
        np.testing.assert_array_equal(decoded[name.replace(".", "_")],
                                      ref[name.replace(".", "_")])


SIZES = ((1, 1), (3, 7), (37, 11))


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
@pytest.mark.parametrize("case", ["global", "local", "transparent", "interlaced", "gray",
                                  "offset", "past_palette", "clears", "full_table"])
def test_seeded_gifs_match_pil(case):
    rng = np.random.default_rng(len(case))
    for w, h in SIZES + ((90, 70),):
        n = 64 if case == "full_table" else 8
        idx = rng.integers(0, n, (h, w), dtype=np.uint8)
        pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        kw = {"global": dict(global_palette=pal),
              "local": dict(global_palette=pal[::-1], local_palette=pal),
              "transparent": dict(global_palette=pal, transparency=int(idx.flat[0])),
              "interlaced": dict(global_palette=pal, interlace=True),
              "gray": dict(global_palette=np.repeat(np.arange(n, dtype=np.uint8)[:, None],
                                                    3, 1)),
              "offset": dict(global_palette=pal, screen=(w + 3, h + 2), offset=(2, 1),
                             transparency=1),
              "past_palette": dict(global_palette=pal[:3]),
              "clears": dict(global_palette=pal, clear_every=5),
              "full_table": dict(global_palette=pal, code_size=8)}[case]
        data = write_gif(idx, **kw)
        np.testing.assert_array_equal(decode_gif(data), _pil_rgb(data),
                                      err_msg=f"{case} {w}x{h}")


BMP_CASES = {
    "1bit": dict(bits=1, colors=2), "4bit": dict(bits=4, colors=16),
    "8bit": dict(bits=8, colors=200), "8bit_gray": dict(bits=8, gray=True),
    "rle8": dict(bits=8, colors=256, compression=1),
    "rle4": dict(bits=4, colors=16, compression=2),
    "16bit": dict(bits=16), "24bit": dict(bits=24), "32bit": dict(bits=32),
    "32bit_rgba_fields": dict(bits=32, compression=3, header=56,
                              masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "24bit_fields": dict(bits=24, compression=3, masks=(0xFF0000, 0xFF00, 0xFF)),
    "16bit_565": dict(bits=16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
    "os2_4bit": dict(bits=4, colors=16, header=12),
}


@pytest.mark.skipif(Image is None, reason="PIL is the reference")
@pytest.mark.parametrize("name,top_down", [
    (name, top_down) for name in sorted(BMP_CASES) for top_down in (False, True)
    if not (top_down and BMP_CASES[name].get("header") == 12)])  # OS/2 1.x: bottom-up only
def test_seeded_bmps_match_pil(name, top_down):
    case = dict(BMP_CASES[name])
    rng = np.random.default_rng(len(name) + 10 * top_down)
    bits, colors, gray = case.pop("bits"), case.pop("colors", None), case.pop("gray", False)
    for w, h in SIZES:
        palette = None
        if bits <= 8:
            if gray:
                palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
                px = rng.integers(0, 256, (h, w), dtype=np.uint8)
            else:
                palette = rng.integers(0, 256, (colors, 3), dtype=np.uint8)
                top = min(1 << bits, colors + 3)  # some indices past a short palette
                px = rng.integers(0, top, (h, w), dtype=np.uint8)
                if case.get("compression") in (1, 2):
                    px[:, : w // 2] = px[:, :1]  # runs to encode
        elif bits == 16:
            px = rng.integers(0, 1 << 16, (h, w)).astype(np.uint32)
        elif bits == 24:
            px = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        else:
            px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        data = write_bmp(px, bits, palette, top_down=top_down,
                         colors=None if palette is None or gray else len(palette), **case)
        np.testing.assert_array_equal(decode_bmp(data), _pil_rgb(data),
                                      err_msg=f"{name} {w}x{h} top_down={top_down}")


def test_every_16bit_pixel_matches_pils_unpackers():
    """All 65,536 pixels of each 16-bit layout (5-5-5 and 5-6-5)."""
    if Image is None:
        pytest.skip("PIL is the reference")
    px = np.arange(1 << 16, dtype=np.uint32).reshape(256, 256)
    for kw in ({}, dict(compression=3, masks=(0xF800, 0x7E0, 0x1F))):
        data = write_bmp(px, 16, **kw)
        np.testing.assert_array_equal(decode_bmp(data), _pil_rgb(data), err_msg=str(kw))


def bomb_gif() -> bytes:
    """A GIF whose logical screen claims 20000 x 20000 pixels over a 2 x 2
    frame."""
    return write_gif(np.zeros((2, 2), np.uint8), screen=(20000, 20000),
                     global_palette=np.zeros((2, 3), np.uint8))


def bomb_bmp() -> bytes:
    """A BMP whose header claims 20000 x 20000 pixels over 4 bytes of
    them."""
    data = bytearray(write_bmp(np.zeros((1, 1, 3), np.uint8), 24))
    data[18:26] = struct.pack("<ii", 20000, 20000)
    return bytes(data)


def test_refusals(monkeypatch):
    """A bomb-sized header is refused before any pixel is decoded (the LZW
    and row decoders stubbed to fail if called); a truncated file, and bytes
    of neither format, raise the decoders' ``ImageInputError``s."""
    from vtc_tpu_torch.data import bmp, gif

    for name in ("lzw_decode",):
        monkeypatch.setattr(gif, name, lambda *a: pytest.fail("decoded a bomb's pixels"))
    for name in ("_raw", "_rle", "_palette"):
        monkeypatch.setattr(bmp, name, lambda *a: pytest.fail("decoded a bomb's pixels"))
    with pytest.raises(GifDecodeError, match="decompression bomb"):
        decode_gif(bomb_gif())
    with pytest.raises(BmpDecodeError, match="decompression bomb"):
        decode_bmp(bomb_bmp())
    monkeypatch.undo()
    gif_data = (DIR / "pil_interlaced.gif").read_bytes()
    bmp_data = (DIR / "pil_rgb.bmp").read_bytes()
    with pytest.raises(GifDecodeError, match="truncated"):
        decode_gif(gif_data[: len(gif_data) // 2])
    with pytest.raises(BmpDecodeError, match="truncated"):
        decode_bmp(bmp_data[: len(bmp_data) // 2])
    with pytest.raises(BmpDecodeError, match="truncated"):
        decode_bmp((DIR / "rle8.bmp").read_bytes()[:900])
    with pytest.raises(GifDecodeError, match="not a GIF"):
        decode_gif(b"GIF90a" + bytes(20))
    with pytest.raises(BmpDecodeError, match="header type"):
        decode_bmp(b"BM" + bytes(12) + struct.pack("<I", 33) + bytes(40))
    with pytest.raises(BmpDecodeError, match="bitfields"):
        decode_bmp(write_bmp(np.zeros((2, 2, 4), np.uint8), 32, compression=3,
                             masks=(0xFF00, 0xFF, 0xFF0000, 0)))
    for exc in (GifDecodeError, BmpDecodeError):
        assert issubclass(exc, image_io.ImageInputError)
    if Image is not None:  # PIL refuses them too
        for data in (gif_data[: len(gif_data) // 2], bmp_data[: len(bmp_data) // 2]):
            with pytest.raises(Exception):
                _pil_rgb(data)
