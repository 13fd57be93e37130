"""Every PNG, PNM and BMP variant cv2.imread reads, through the port's
decoders (`csrc/io_native.cpp` behind `native.io.decode_batch` and
`utils.io.load_image`), against cv2.imread and the JAX package's
`load_image`, pixel for pixel, gray and colour; the files the port
refuses; the fixtures' manifest (tests/torch_fixtures/formats, which
chip_smoke.py part 7c holds the card machine's build to); and the serving
pipeline and CLI on such frames against the JAX package's.

Files come from cv2 and PIL where they can write them, and from the numpy
writers of tests/torch_fixtures/formats/make_fixtures.py where they cannot
(Adam7, low-bit gray, inserted gAMA / sRGB chunks, RLE BMP, odd maxvals,
crafted chunk orders). Tolerance 0: every decoder here is integer
arithmetic or libpng's and OpenCV's float arithmetic done the same way.
The JAX package's native decoder converts a colour PNG to gray by OpenCV's
BGR2GRAY where cv::imread takes libpng's rgb_to_gray, so for a colour PNG
read as gray the JAX package is asked through its cv2 route (its
`_native_io` patched to None).
"""

import ctypes
import hashlib
import importlib.util
import io as _io
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
from hypothesis import given, settings, strategies as st  # noqa: E402

from of_dis_tpu import cli as jcli  # noqa: E402
from of_dis_tpu import pipeline as jax_pipeline  # noqa: E402
from of_dis_tpu.utils import io as jio  # noqa: E402
from of_dis_tpu_torch import cli, pipeline  # noqa: E402
from of_dis_tpu_torch.kernels import build  # noqa: E402
from of_dis_tpu_torch.native import io as nio  # noqa: E402
from of_dis_tpu_torch.utils import io as uio  # noqa: E402
from tests.test_torch_pipeline import assert_files_match_jax  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures", "formats")
_spec = importlib.util.spec_from_file_location(
    "formats_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)

EPE_RATIO = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as the other pipeline test files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cv2_planes(path, channels):
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if channels == 1
                     else cv2.IMREAD_COLOR)
    if img is None:
        return None
    return img[None] if img.ndim == 2 else img.transpose(2, 0, 1)


def jax_planes(path, channels):
    """The JAX package's `load_image`, through its cv2 route for a colour
    PNG read as gray."""
    with open(path, "rb") as f:
        head = f.read(26)
    colour_png = head[:8] == uio.PNG_MAGIC and head[25] & 2
    saved = jio._native_io
    if channels == 1 and colour_png:
        jio._native_io = None
    try:
        return jio.load_image(path, channels)
    finally:
        jio._native_io = saved


def assert_as_cv2(path, jax=True):
    """Gray and colour: `decode_batch` and `load_image` equal cv2.imread
    and (if `jax`) the JAX package's `load_image`."""
    for ch in (1, 3):
        want = cv2_planes(path, ch)
        assert want is not None, (path, ch)
        got = nio.decode_batch([path], ch)[0]
        assert got.shape == want.shape, (path, ch)
        np.testing.assert_array_equal(got, want, err_msg=f"{path} {ch}")
        ours = uio.load_image(path, ch)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, want)
        if jax:
            np.testing.assert_array_equal(ours, jax_planes(path, ch))


def write(tmp_path, name, raw):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(raw)
    return p


def assert_raw_as_cv2(tmp_path, name, raw, jax=True):
    assert_as_cv2(write(tmp_path, name, raw), jax)


SIZES = ((1, 1), (7, 9), (9, 13), (5, 64))

# ------------------------------------------------------------------- PNG


@pytest.mark.parametrize("ct,bd", [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16),
                                   (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
                                   (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)])
@pytest.mark.parametrize("interlace", [0, 1])
def test_png_every_layout(tmp_path, ct, bd, interlace):
    """Every colour type and bit depth, plain and Adam7 (passes of zero
    width or height at 1x1 and 7x9), 13-px rows of 1-bit samples, every
    filter, no gamma, sRGB and a gAMA of 0.7; palettes shorter than the
    indices reach, with a tRNS."""
    rng = np.random.default_rng(ct * 100 + bd * 2 + interlace)
    nch = mf.PNG_CHANNELS[ct]
    for h, w in SIZES:
        for k, before in enumerate(([], [mf.SRGB], [mf.gama(70000)])):
            kinds = tuple(rng.integers(0, 5, 5))
            if ct == 3:
                n = int(rng.integers(1, (1 << bd) + 1))
                raw = mf.png(rng.integers(0, 1 << bd, (h, w, 1)), 3, bd,
                             interlace, palette=rng.integers(0, 256, (n, 3)),
                             trns=bytes(range(min(n, 3))), before=before,
                             kinds=kinds)
            else:
                raw = mf.png(rng.integers(0, 1 << bd, (h, w, nch)), ct, bd,
                             interlace, before=before, kinds=kinds)
            assert_raw_as_cv2(tmp_path, f"{h}x{w}_{k}.png", raw)


# gAMA values at libpng's thresholds (an exponent or its inverse within
# 0.05 of 1 counts as none), and sBIT values setting the 16-bit tables'
# precision
@pytest.mark.parametrize("gamma", [16, 45455, 70000, 94999, 95237, 95238,
                                   100000, 104999, 105001, 150000,
                                   625000000])
def test_png_gamma_rules(tmp_path, gamma):
    rng = np.random.default_rng(gamma)
    for bd in (8, 16):
        for sbit in ((None, 4, 11, 12, 16) if bd == 16 else (None,)):
            pix = rng.integers(0, 1 << bd, (9, 13, 3))
            pix[0] = pix[0, :, :1]                  # R = G = B pixels
            before = [mf.gama(gamma)] + (
                [(b"sBIT", bytes([sbit, max(sbit - 1, 1), sbit]))]
                if sbit else [])
            assert_raw_as_cv2(tmp_path, f"{bd}_{sbit}.png",
                              mf.png(pix, 2, bd, before=before))
            assert_raw_as_cv2(tmp_path, f"{bd}_{sbit}_rgba.png", mf.png(
                rng.integers(0, 1 << bd, (7, 9, 4)), 6, bd, 1,
                before=before))


def _bad_crc(c):
    kind, payload = c
    good = mf.chunk(kind, payload)
    return good[:-4] + bytes(b ^ 1 for b in good[-4:])


CHUNK_CASES = {
    "srgb_overrides_gama": ([mf.gama(70000), mf.SRGB], None),
    "gama_then_srgb_order": ([mf.SRGB, mf.gama(100000)], None),
    "first_gama_wins": ([mf.gama(70000), mf.gama(100000)], None),
    "gama_zero_is_none": ([mf.gama(0)], None),
    "gama_wrong_length": ([(b"gAMA", b"\0\1\x11\x70\0")], None),
    "srgb_bad_intent": ([(b"sRGB", b"\4")], None),
    "cicp_and_chrm_ignored": ([(b"cICP", bytes([1, 13, 0, 1])),
                               (b"cHRM", struct.pack(">8I", 31270, 32900,
                                                     64000, 33000, 30000,
                                                     60000, 15000, 6000))],
                              None),
    "text_chunks": ([(b"tEXt", b"Software\0test"),
                     (b"zTXt", b"Comment\0\0" + zlib.compress(b"x"))], None),
    "srgb_after_plte_ignored": ([], [mf.SRGB]),
    "eXIf_orientation_1": ([(b"eXIf", b"II*\0\x08\0\0\0\1\0\x12\x01\3\0"
                             b"\1\0\0\0\1\0\0\0\0\0\0\0")], None),
}


@pytest.mark.parametrize("name", sorted(CHUNK_CASES))
def test_png_chunk_rules(tmp_path, name):
    """Which ancillary chunks move cv::imread's gray: only sRGB and a
    valid gAMA before PLTE and IDAT, the first of each."""
    before, after = CHUNK_CASES[name]
    rng = np.random.default_rng(len(name))
    pix = rng.integers(0, 256, (11, 13, 3))
    raw = mf.png(pix, 2, 8, before=before,
                 palette=rng.integers(0, 256, (4, 3)) if after else None)
    if after:   # the chunk after PLTE: before the first IDAT
        at = raw.index(b"IDAT") - 4
        raw = raw[:at] + b"".join(mf.chunk(*c) for c in after) + raw[at:]
    assert_raw_as_cv2(tmp_path, f"{name}.png", raw)


@pytest.mark.parametrize("length", [0, 1, 7, 8, 15, 16, 63, 64, 65, 79, 80,
                                    127, 128, 129, 1000, 70_001])
def test_chunk_crc_is_zlibs(length):
    """The parser's CRC-32 (`of_crc32`: carry-less folding of 64-byte
    blocks where the host has PCLMULQDQ, eight tables for short inputs and
    tails) equals zlib.crc32 at every start and length around its block
    sizes."""
    crc32 = build.load_host("io_native").of_crc32
    crc32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
    crc32.restype = ctypes.c_uint32
    raw = np.random.default_rng(length).integers(0, 256, length + 40,
                                                 dtype=np.uint8)
    for start in (0, 1, 5, 16, 39):
        for init in (0, 0xFFFFFFFF, 0x1234567):
            assert crc32(raw.ctypes.data + start, length, init) == \
                zlib.crc32(raw[start:start + length].tobytes(), init)


def test_png_ancillary_crc_error_is_ignored(tmp_path):
    pix = np.random.default_rng(3).integers(0, 256, (11, 13, 3))
    raw = mf.png(pix, 2)
    at = raw.index(b"IDAT") - 4
    raw = raw[:at] + _bad_crc(mf.gama(70000)) + raw[at:]
    assert_raw_as_cv2(tmp_path, "crc.png", raw)


def test_gray_from_colour_png_is_libpngs_rule(tmp_path):
    """A colour PNG read as gray is libpng's (9797 R + 19234 G + 3737 B)
    >> 15, not OpenCV's BGR2GRAY: on RGB noise about half the pixels
    differ between the two, by one level."""
    rng = np.random.default_rng(0)
    pix = rng.integers(0, 256, (40, 50, 3))
    p = write(tmp_path, "noise.png", mf.png(pix, 2))
    r, g, b = (pix[..., k] for k in range(3))
    libpng = (9797 * r + 19234 * g + 3737 * b) >> 15
    bgr2gray = (r * 4899 + g * 9617 + b * 1868 + 8192) >> 14
    got = nio.decode_batch([p], 1)[0, 0]
    np.testing.assert_array_equal(got, libpng)
    np.testing.assert_array_equal(got, cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    assert 0.4 < (got != bgr2gray).mean() < 0.6


# ------------------------------------------------------------------- PNM


@pytest.mark.parametrize("kind", [1, 2, 3, 4, 5, 6])
def test_pnm_every_kind(tmp_path, kind):
    """P1-P6 at maxvals 1 to 65535 (ASCII values past maxval clamped; the
    binary ones below 255 as stored, above it the high byte), comments in
    the header, 13-px bitmap rows."""
    rng = np.random.default_rng(kind)
    maxvals = (1,) if kind in (1, 4) else (1, 7, 100, 255, 256, 1000, 65535)
    for h, w in SIZES:
        for maxval in maxvals:
            shape = (h, w, 3) if kind in (3, 6) else (h, w)
            pix = rng.integers(0, maxval + 1, shape)
            if kind in (2, 3):
                pix = pix + (rng.random(shape) < 0.1) * 3
            raw = mf.pnm(pix, kind, maxval,
                         comment=b"# c\n" if w == 9 else b"")
            assert_raw_as_cv2(tmp_path, f"{h}x{w}_{maxval}.pnm", raw)


# ------------------------------------------------------------------- BMP


@pytest.mark.parametrize("header,bpp", [
    (h, b) for h in ("core", "info", "v4", "v5") for b in (1, 4, 8, 16, 24, 32)
    if (h, b) != ("core", 16)])           # the core header has no 16-bit
def test_bmp_every_depth(tmp_path, header, bpp):
    """1, 4 and 8-bit palettes (partial ones too), 5-5-5, 5-6-5 and its
    BI_BITFIELDS masks, 24 and 32-bit (with masks: from a V4 / V5 header),
    bottom-up and top-down, rows padded to 4 bytes."""
    rng = np.random.default_rng(bpp * 10 + len(header))
    for h, w in SIZES:
        for top_down in ((False,) if header == "core" else (False, True)):
            if bpp <= 8:
                n = int(rng.integers(1, (1 << bpp) + 1))
                pal = rng.integers(0, 256, (1 << bpp, 3))
                pix = rng.integers(0, 1 << bpp, (h, w))
                forms = [dict(palette=pal), dict(palette=pal[:n],
                                                 colours_used=n)]
                if header == "core":
                    forms = forms[:1]
            else:
                pix = rng.integers(0, 256, (h, w, 3))
                forms = [{}]
                if bpp in (16, 32) and header != "core":
                    forms += [dict(compression=3, masks=m) for m in (
                        (0x1F, 0x7E0, 0xF800), (0x1F, 0x3E0, 0x7C00),
                        (0xFF, 0xFF00, 0xFF0000))]
            for k, form in enumerate(forms):
                raw = mf.bmp(pix, bpp, header=header, top_down=top_down,
                             **form)
                p = write(tmp_path, f"{h}x{w}_{top_down}_{k}.bmp", raw)
                if cv2_planes(p, 1) is None:     # refused by cv2 too
                    with pytest.raises(ValueError):
                        nio.decode_batch([p], 1)
                    continue
                assert_as_cv2(p)


def test_bmp_masked_32_bit(tmp_path):
    """A 32-bit BI_BITFIELDS BMP with a header of 56 bytes or more: each
    field scaled by 255 / its mask in float, gray in float (OpenCV 5)."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2 ** 32, (9, 13), dtype=np.uint64)
    for size in (56, 108, 124):
        for masks in ((0xFF0000, 0xFF00, 0xFF), (0xF800, 0x7E0, 0x1F),
                      (0x3FF00000, 0xFFC00, 0x3FF), (0xF0F, 0xF0, 0xF000),
                      (0xFF0000, 0, 0xFF)):
            data = words.astype("<u4").tobytes()
            head = struct.pack("<IiiHHIIiiII", size, 13, 9, 1, 32, 3,
                               len(data), 0, 0, 0, 0)
            head += struct.pack("<III", *masks)
            head += b"\0" * (size - len(head))
            raw = (b"BM" + struct.pack("<IHHI", 14 + size + len(data), 0, 0,
                                       14 + size) + head + data)
            assert_raw_as_cv2(tmp_path, f"m{size}_{masks[1]}.bmp", raw)


# crafted RLE streams, bottom row first, on a 4-row image of width 6
def _rle_streams(bits):
    run = (lambda n, a, b=0: bytes([n, a])) if bits == 8 else \
        (lambda n, a, b=0: bytes([n, a << 4 | b]))
    ab = (lambda *v: bytes([0, len(v)]) + bytes(v) + b"\0" * (len(v) & 1)) \
        if bits == 8 else \
        (lambda *v: bytes([0, len(v)]) + bytes(
            (v[k] << 4) | (v[k + 1] if k + 1 < len(v) else 0)
            for k in range(0, len(v), 2)) + b"\0" * (
                ((len(v) + 1) // 2) & 1))
    eol, eob = b"\0\0", b"\0\1"
    return {
        # a run to the row's end, then an end of line (RLE8 drops it)
        "run_to_row_end": run(6, 3, 4) + eol + run(6, 5, 6) + eol
        + run(2, 1, 2) + eob,
        "eol_at_row_start": eol + run(3, 2, 7) + eol + ab(1, 2, 3, 4, 5)
        + eol + eob,
        "delta_across_rows": run(2, 7, 1) + b"\0\2\5\1" + run(1, 4, 4)
        + eol + eob,
        "early_eob": run(4, 9, 3) + eob,
        "absolute_odd_counts": ab(1, 2, 3) + ab(4, 5, 6) + eol + ab(7, 8, 9)
        + eob,
        "no_eob": run(6, 1, 2) + eol + run(6, 3, 4) + eol + run(6, 5, 6)
        + eol + run(6, 7, 8) + eol,
        "run_crosses_row_end": run(4, 1, 1) + run(4, 2, 2) + eob,
        "truncated": run(4, 1, 1) + b"\0",
        "delta_truncated": run(1, 1, 1) + b"\0\2\3",
    }


@pytest.mark.parametrize("bits", [8, 4])
def test_bmp_rle(tmp_path, bits):
    """BI_RLE8 / BI_RLE4 as OpenCV walks them: the encoder's streams at
    every size (with deltas and early ends of line on the larger ones),
    top-down too, and crafted streams (runs to a row's end, deltas across
    rows, an early or missing end of bitmap); a run that would cross its
    row's end and a stream that ends early are refused by both (in RLE4,
    where an end of bitmap only ends its row, so is a stream that stops
    before the last row)."""
    rng = np.random.default_rng(bits)
    comp = 1 if bits == 8 else 2
    for h, w in SIZES + ((13, 41),):
        for trial in range(4):
            pal = rng.integers(0, 256, (1 << bits, 3))
            idx = rng.integers(0, 1 << bits, (h, w)) * (rng.random((h, w))
                                                        < 0.7)
            if trial % 2:
                idx = np.repeat(idx[:, :1], w, 1)
            data = mf.rle(idx, bits, np.random.default_rng(trial)
                          if trial >= 2 else None, eob=trial != 3)
            for top_down in (False, True):
                assert_raw_as_cv2(tmp_path, f"{h}x{w}_{trial}_{top_down}.bmp",
                                  mf.bmp(idx, bits, pal, compression=comp,
                                         data=data, top_down=top_down))
    pal = rng.integers(0, 256, (1 << bits, 3))
    blank = np.zeros((4, 6), np.int64)
    refused = set()
    for name, data in _rle_streams(bits).items():
        p = write(tmp_path, f"{name}.bmp",
                  mf.bmp(blank, bits, pal, compression=comp, data=data))
        if cv2_planes(p, 3) is None:
            refused.add(name)
            with pytest.raises(ValueError, match="BMP"):
                nio.decode_batch([p], 3)
            continue
        assert_as_cv2(p)
    assert {"run_crosses_row_end", "truncated", "delta_truncated"} <= refused


# ---------------------------------------------------- written by libraries


def test_files_written_by_cv2_and_pil(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(11)
    img = cv2.GaussianBlur((rng.random((37, 53, 3)) * 255).astype(np.uint8),
                           (5, 5), 1.5)
    img16 = (img.astype(np.uint16) << 8) | rng.integers(
        0, 256, img.shape).astype(np.uint16)
    paths = []
    for name, arr in (("cv_rgb16.png", img16), ("cv_gray16.png",
                                                img16[..., 0]),
                      ("cv_rgb.bmp", img), ("cv_gray.bmp", img[..., 0]),
                      ("cv_gray16.pgm", img16[..., 0]),
                      ("cv_rgb16.ppm", img16), ("cv_rgb.ppm", img)):
        p = str(tmp_path / name)
        assert cv2.imwrite(p, arr)
        paths.append(p)
    rgb = Image.fromarray(img[..., ::-1])
    for name, im in (("pil_p.png", rgb.quantize(200)),
                     ("pil_1.png", rgb.convert("1")),
                     ("pil_la.png", rgb.convert("LA")),
                     ("pil_rgba.png", rgb.convert("RGBA")),
                     ("pil_i16.png", Image.fromarray(img16[..., 1])),
                     ("pil_p.bmp", rgb.quantize(16)),
                     ("pil_1.bmp", rgb.convert("1")),
                     ("pil_rgb.bmp", rgb), ("pil_rgba.bmp",
                                            rgb.convert("RGBA")),
                     ("pil_l.pgm", rgb.convert("L")), ("pil_rgb.ppm", rgb),
                     ("pil_1.pbm", rgb.convert("1"))):
        p = str(tmp_path / name)
        im.save(p)
        paths.append(p)
    buf = _io.BytesIO()
    rgb.save(buf, "PNG", icc_profile=b"\0" * 16)   # an iCCP chunk
    paths.append(write(tmp_path, "pil_iccp.png", buf.getvalue()))
    for p in paths:
        assert_as_cv2(p)


# ---------------------------------------------------------------- refusals


def _png_without_iend():
    raw = mf.png(np.zeros((3, 4, 1), np.int64), 0)
    return raw[:raw.index(b"IEND") - 4]


def _png_idat_crc():
    raw = bytearray(mf.png(np.zeros((3, 4, 1), np.int64), 0))
    raw[raw.index(b"IDAT") + 5] ^= 0x10
    return bytes(raw)


def _png_idat_crc_field():
    """Image data intact, the IDAT chunk's CRC wrong: found by the pixel
    decoder, `of_png_decode`."""
    raw = bytearray(mf.png(np.zeros((3, 4, 1), np.int64), 0))
    at = raw.index(b"IDAT") - 4
    raw[at + 8 + struct.unpack(">I", raw[at:at + 4])[0]] ^= 0x01
    return bytes(raw)


def _png_exif(orientation):
    tiff = (b"II*\0\x08\0\0\0\1\0\x12\x01\3\0\1\0\0\0"
            + struct.pack("<H", orientation) + b"\0\0\0\0\0\0")
    return mf.png(np.zeros((3, 4, 3), np.int64), 2,
                  before=[(b"eXIf", tiff)])


def _png_srgb_icc():
    prof = b"\0" * 3144
    return mf.png(np.zeros((3, 4, 3), np.int64), 2, before=[
        (b"iCCP", b"sRGB IEC61966-2.1\0\0" + zlib.compress(prof))])


def _bmp(compression, bpp=8):
    raw = bytearray(mf.bmp(np.zeros((3, 4), np.int64), 8,
                           np.zeros((256, 3), np.int64)))
    struct.pack_into("<HI", raw, 28, bpp, compression)
    return bytes(raw)


def _encoded(ext):
    ok, buf = cv2.imencode(ext, np.full((64, 64, 3), 77, np.uint8))
    assert ok
    return buf.tobytes()


def _jpeg_sized(w, h):
    """A cv2-written JPEG whose SOF0 declares w x h."""
    raw = bytearray(_encoded(".jpg"))
    at = raw.index(b"\xff\xc0") + 5
    raw[at:at + 4] = struct.pack(">HH", h, w)
    return bytes(raw)


def _tiff_compression(raw, value):
    """A cv2-written (little-endian) TIFF with its Compression set to
    `value`."""
    ifd = struct.unpack("<I", raw[4:8])[0]
    for k in range(struct.unpack("<H", raw[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack("<H", raw[at:at + 2])[0] == 259:
            return raw[:at + 8] + struct.pack("<H", value) + raw[at + 10:]
    raise AssertionError("no Compression tag")


def _signed_jp2(raw):
    """A JP2 file with its component 0's Ssiz marked signed."""
    at = raw.index(b"\xff\x4f\xff\x51") + 4 + 38
    return raw[:at] + bytes([raw[at] | 0x80]) + raw[at + 1:]


REFUSED = {
    # TIFF and GIF are read (tests/test_torch_tiff.py and
    # tests/test_torch_gif.py): a refused variant of each
    "tiff": (lambda: _tiff_compression(_encoded(".tiff"), 34925),
             "TIFF compression LZMA"),
    # WebP, HDR, PFM and PAM are read: a refused variant of each (the
    # others are in tests/test_torch_webp.py and
    # tests/test_torch_raster_formats.py)
    "webp": (lambda: _encoded(".webp")[:40], "truncated WebP"),
    # JPEG 2000 is read (tests/test_torch_jp2.py): a refused variant, the
    # cv2-written file with its component 0 signed
    "jpeg2000": (lambda: _signed_jp2(_encoded(".jp2")),
                 "signed component 0"),
    "hdr": (lambda: _encoded(".hdr").replace(b"rle_rgbe", b"rle_xyze"),
            "XYZE"),
    "pfm": (lambda: b"PF\n1 1\n0\n" + b"\0" * 12, "PFM scale 0"),
    "pam": (lambda: b"P7\nWIDTH 1\nHEIGHT 1\nDEPTH 4\nMAXVAL 255\n"
            b"TUPLTYPE RGB_ALPHA\nENDHDR\n\5\5\5\5", "RGB_ALPHA"),
    "gif": (lambda: b"GIF89a" + b"\0" * 20, "GIF logical screen of 0x0"),
    "unknown": (lambda: b"\0\1\2\3" * 8, r"unsupported image format: PNG"),
    "bmp_bi_jpeg": (lambda: _bmp(4, 24), "BI_JPEG"),
    "bmp_bi_png": (lambda: _bmp(5, 24), "BI_PNG"),
    "bmp_rle8_at_24": (lambda: _bmp(1, 24), "unsupported BMP"),
    "bmp_truncated": (lambda: mf.bmp(np.zeros((5, 7, 3), np.int64), 24)[:-5],
                      "truncated BMP"),
    "png_no_iend": (_png_without_iend, "no IEND"),
    "png_idat_crc": (_png_idat_crc, "IDAT chunk: CRC error"),
    "png_idat_crc_field": (_png_idat_crc_field, "IDAT chunk: CRC error"),
    "png_exif_orientation": (lambda: _png_exif(6), "eXIf orientation 6"),
    "png_unknown_critical": (lambda: mf.png(
        np.zeros((3, 4, 1), np.int64), 0, before=[(b"ABCD", b"")]),
        "critical PNG chunk"),
    "pnm_truncated": (lambda: b"P5\n4 3\n255\n" + b"\0" * 11,
                      "truncated PNM"),
    "pnm_ascii_bad_byte": (lambda: b"P2\n2 1\n255\n10 x\n",
                           "bad byte or number"),
    "pnm_no_byte_after_last_value": (lambda: b"P2\n2 1\n255\n10 20",
                                     "truncated PNM"),
    "pnm_maxval_zero": (lambda: b"P5\n1 1\n0\n\0", "maxval 0"),
    # above 2^30 pixels: cv::imread fails on the header (its size check)
    "png_above_cv2_limits": (lambda: uio.PNG_MAGIC + mf.chunk(
        b"IHDR", struct.pack(">IIBBBBB", 32768, 32769, 8, 0, 0, 0, 0))
        + mf.chunk(b"IEND", b""), "above cv::imread's limits"),
    "pnm_above_cv2_limits": (lambda: b"P5\n32768 32769\n255\n",
                             "above cv::imread's limits"),
    "jpeg_above_cv2_limits": (lambda: _jpeg_sized(40000, 40000),
                              "above cv::imread's limits"),
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_naming_the_cause(tmp_path, name):
    """A file the port refuses raises ValueError naming the cause (and,
    for another format, the format and the list read), from every entry;
    cv2 reads none of these with other pixels than the port would."""
    make, match = REFUSED[name]
    p = write(tmp_path, f"{name}.bin", make())
    for ch in (1, 3):
        with pytest.raises(ValueError, match=match):
            nio.decode_batch([p], ch)
        with pytest.raises(ValueError, match=match):
            uio.load_image(p, ch)


def test_colour_png_with_srgb_profile_is_refused_only_as_gray(tmp_path):
    """libpng may take an ICC sRGB profile for an sRGB chunk (its gamma),
    which the port does not reproduce: refused as gray, read in colour."""
    p = write(tmp_path, "icc.png", _png_srgb_icc())
    with pytest.raises(ValueError, match="sRGB ICC profile"):
        nio.decode_batch([p], 1)
    np.testing.assert_array_equal(nio.decode_batch([p], 3)[0],
                                  cv2_planes(p, 3))


# ---------------------------------------------------------- corrupt bytes

_FUZZ_SOURCES = [
    mf.png(np.random.default_rng(1).integers(0, 4, (9, 11, 1)), 3, 2, 1,
           palette=np.random.default_rng(2).integers(0, 256, (3, 3))),
    mf.png(np.random.default_rng(3).integers(0, 65536, (7, 9, 3)), 2, 16,
           before=[mf.SRGB]),
    mf.png(np.random.default_rng(4).integers(0, 2, (5, 13, 1)), 0, 1, 1),
    mf.pnm(np.random.default_rng(5).integers(0, 300, (4, 5)), 2, 299),
    mf.pnm(np.random.default_rng(6).integers(0, 256, (4, 5, 3)), 6),
    mf.pnm(np.random.default_rng(7).integers(0, 2, (3, 13)), 4),
    mf.bmp(np.random.default_rng(8).integers(0, 256, (5, 7, 3)), 24),
    mf.bmp(np.zeros((6, 9), np.int64), 8,
           np.random.default_rng(9).integers(0, 256, (256, 3)),
           compression=1, data=mf.rle(np.random.default_rng(10).integers(
               0, 3, (6, 9)), 8, np.random.default_rng(0))),
    mf.bmp(np.zeros((6, 9), np.int64), 4,
           np.random.default_rng(11).integers(0, 256, (16, 3)),
           compression=2, data=mf.rle(np.random.default_rng(12).integers(
               0, 3, (6, 9)), 4, np.random.default_rng(1))),
]


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(src=st.integers(0, len(_FUZZ_SOURCES) - 1),
       cut=st.one_of(st.none(), st.floats(0.0, 1.0)),
       flips=st.lists(st.tuples(st.floats(0.0, 1.0), st.integers(1, 255)),
                      max_size=3))
def test_corrupt_input_raises_or_equals_cv2(src, cut, flips):
    """Truncated and byte-flipped PNG, PNM and BMP files: the port raises
    ValueError or gives exactly cv2's planes, never anything else and
    never a crash."""
    raw = bytearray(_FUZZ_SOURCES[src])
    for where, mask in flips:
        raw[min(int(where * len(raw)), len(raw) - 1)] ^= mask
    if cut is not None:
        raw = raw[:int(cut * len(raw))]
    raw = bytes(raw)
    for ch in (1, 3):
        try:
            got = nio.decode_image(raw, ch)
        except ValueError:
            continue
        flag = cv2.IMREAD_GRAYSCALE if ch == 1 else cv2.IMREAD_COLOR
        want = cv2.imdecode(np.frombuffer(raw, np.uint8), flag)
        assert want is not None
        want = want[None] if want.ndim == 2 else want.transpose(2, 0, 1)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- fixtures

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def _sha(planes):
    return hashlib.sha256(np.ascontiguousarray(planes).tobytes()).hexdigest()


def _assert_manifest(path, rec):
    for key, ch in (("gray", 1), ("color", 3)):
        for planes in (cv2_planes(path, ch), nio.decode_batch([path], ch)[0],
                       uio.load_image(path, ch).astype(np.uint8)):
            assert list(planes.shape) == rec[key]["shape"]
            assert _sha(planes) == rec[key]["sha256"], (path, key)


@pytest.mark.parametrize("rel", sorted(MANIFEST["files"]))
def test_fixture_manifest_matches_cv2_and_the_decoder(rel):
    """The committed variants: their hashes, which chip_smoke.py holds the
    card's build to, are cv2's (live here) and the port's."""
    path = os.path.join(FIXTURES, rel)
    assert os.path.getsize(path) == MANIFEST["files"][rel]["bytes"]
    _assert_manifest(path, MANIFEST["files"][rel])
    assert_as_cv2(path)


@pytest.fixture(scope="module")
def frame_dirs(tmp_path_factory):
    """chip_smoke.py part 7c's frames, written here from cv2's planes of
    the JPEG frames (which the port's JPEG decoder reproduces)."""
    root = str(tmp_path_factory.mktemp("frames"))
    return mf.write_frames(root, mf.jpeg_planes())


@pytest.mark.parametrize("fmt", mf.FORMATS)
def test_frame_manifest_matches_cv2_and_the_decoder(frame_dirs, fmt):
    """Part 7c's 1024x436 frames (made on the card's host by the same
    numpy generator): every plane's hash in the manifest is cv2's and the
    port's, and a batch of all nine on a pool equals them."""
    paths = frame_dirs[fmt]
    assert len(paths) == 9
    for p in paths:
        _assert_manifest(p, MANIFEST["frames"][f"{fmt}/"
                                               f"{os.path.basename(p)}"])
    with ThreadPoolExecutor(4) as pool:
        batch = nio.decode_batch(paths, 1, pool=pool)
    for p, planes in zip(paths, batch):
        assert _sha(planes) == MANIFEST["frames"][
            f"{fmt}/{os.path.basename(p)}"]["gray"]["sha256"]


def test_fixtures_stay_small():
    sizes = [os.path.getsize(os.path.join(FIXTURES, r))
             for r in MANIFEST["files"]]
    assert max(sizes) < 10_000 and len(sizes) >= 30
    assert not any(name.startswith("frame") for _, _, names
                   in os.walk(FIXTURES) for name in names)
    assert MANIFEST["motion_px"] == [1.3, 0.4]
    assert len(MANIFEST["frames"]) == 9 * len(mf.FORMATS)


def test_variants_regenerate_byte_for_byte():
    """The generator is deterministic: the committed variants are what it
    writes now."""
    for name, raw in mf.variants().items():
        with open(os.path.join(FIXTURES, "variants", name), "rb") as f:
            assert f.read() == raw, name


# ------------------------------------------------ batches, pipeline, CLI

H, W = 96, 128


def _shift_planes(n, dx, dy, seed=0):
    """(gray, bgr) planes of n frames whose content translates by
    (dx, dy) px a frame."""
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur((rng.random((140, 180, 3)) * 255).astype(
        np.float32), (9, 9), 2.5)
    out = []
    for t in range(n):
        m = np.float32([[1, 0, dx * t], [0, 1, dy * t]])
        f = np.clip(cv2.warpAffine(big, m, (180, 140))[20:20 + H, 20:20 + W],
                    0, 255).astype(np.uint8)
        out.append((cv2.cvtColor(f, cv2.COLOR_BGR2GRAY),
                    np.ascontiguousarray(f.transpose(2, 0, 1))))
    return out


# a sequence whose frames come in turn in each format the JAX package
# reads through cv2 (none is an 8-bit non-interlaced colour PNG, which
# its native decoder would read with BGR2GRAY); its pipeline lists PNG,
# PGM, PPM and JPEG frames, not BMP
MIXED = ("png16", "adam7_srgb", "pgm16", "palette")


def _mixed_dir(root, n, seed=0, formats=MIXED):
    os.makedirs(root, exist_ok=True)
    for t, (gray, bgr) in enumerate(_shift_planes(n, 1.5, 0.5, seed)):
        fmt = formats[t % len(formats)]
        with open(os.path.join(root, f"frame_{t:04d}.{mf.EXT[fmt]}"),
                  "wb") as f:
            f.write(mf.encode_frame(fmt, gray, bgr))
    return str(root)


def test_mixed_format_batch_on_a_pool(tmp_path):
    """PNG, BMP and PGM frames of one size in one batch, through a thread
    pool, equal each frame decoded alone and cv2."""
    d = _mixed_dir(tmp_path / "f", 5, formats=MIXED + ("bmp24",))
    paths = pipeline.list_frames(d)
    assert len(paths) == 5 and paths[-1].endswith(".bmp")
    for ch in (1, 3):
        alone = np.stack([cv2_planes(p, ch) for p in paths])
        with ThreadPoolExecutor(4) as pool:
            got = nio.decode_batch(paths, ch, pool=pool)
        np.testing.assert_array_equal(got, alone)


def test_mixed_format_pipeline_matches_jax(tmp_path):
    """Six frames, one format after another (five pairs, batch 2), through
    both pipelines, gray flow."""
    d = _mixed_dir(tmp_path / "frames", 6)
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pipeline.run_pipeline(d, jax_out, op_point=1, batch=2,
                              mode="run_OF_INT", verbose=False)
    n = pipeline.run_pipeline(d, out, op_point=1, batch=2, mode="run_OF_INT",
                              verbose=False, device="cpu")
    assert n == 5
    names = assert_files_match_jax(out, jax_out)
    for name in names:
        fl = uio.read_flo(os.path.join(out, name))
        med = np.median(fl[16:-16, 16:-16].reshape(-1, 2), axis=0)
        assert abs(med[0] - 1.5) < 0.4 and abs(med[1] - 0.5) < 0.4


def test_bmp_pipeline_matches_jax_on_ppm(tmp_path):
    """BMP frames through the port's pipeline, against the JAX pipeline on
    the same frames as binary PPM (one gray rule for both: BGR2GRAY)."""
    planes = _shift_planes(3, 1.5, 0.5, seed=2)
    bmp_dir, ppm_dir = tmp_path / "bmp", tmp_path / "ppm"
    os.makedirs(bmp_dir)
    os.makedirs(ppm_dir)
    for t, (gray, bgr) in enumerate(planes):
        write(bmp_dir, f"frame_{t:04d}.bmp",
              mf.bmp(bgr.transpose(1, 2, 0), 24, top_down=t == 1))
        write(ppm_dir, f"frame_{t:04d}.ppm", mf.pnm(bgr[::-1].transpose(
            1, 2, 0), 6))
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pipeline.run_pipeline(str(ppm_dir), jax_out, op_point=1, batch=2,
                              mode="run_OF_INT", verbose=False)
    assert pipeline.run_pipeline(str(bmp_dir), out, op_point=1, batch=2,
                                 mode="run_OF_INT", verbose=False,
                                 device="cpu") == 2
    assert assert_files_match_jax(out, jax_out) == ["frame_0000.flo",
                                                   "frame_0001.flo"]


@pytest.mark.parametrize("mode,fmts", [("run_OF_INT", ("png16", "pgm16")),
                                       ("run_OF_RGB", ("bmp24", "adam7_srgb"))])
def test_cli_matches_jax(tmp_path, mode, fmts):
    planes = _shift_planes(2, 1.5, 0.5, seed=1)
    paths = []
    for t, fmt in enumerate(fmts):
        paths.append(write(tmp_path, f"f{t}.{mf.EXT[fmt]}",
                           mf.encode_frame(fmt, *planes[t])))
    ours, ref = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    cli.main([mode, *paths, ours, "2", "--quiet", "--device", "cpu"])
    jcli.main([mode, *paths, ref, "2", "--quiet"])
    got, want = uio.read_flo(ours), jio.read_flo(ref)
    assert got.shape == want.shape == (H, W, 2)
    epe = np.linalg.norm(got - want, axis=-1).mean() \
        / np.linalg.norm(want, axis=-1).mean()
    assert epe <= EPE_RATIO
