"""Damaged TIFF files, read by the port's decoder (`utils.io.tiff_ifd`,
`csrc/tiff.cpp`, Deflate in `native/io.py`, JPEG strips by `csrc/jpeg.cpp`,
through `native.io.decode_image`, `decode_batch` and `utils.io.load_image`)
exactly as cv2.imread reads the file, and the serving pipeline and CLI on
damaged frames against the JAX package's.

cv2.imread reads every 8-bit TIFF through libtiff's RGBA reader
(TIFFReadRGBAStrip / TIFFReadRGBATile), which ignores a codec's error and
puts what the codec left in its buffer: what was decoded, zeros after it,
no predictor and no byte swap where the codec failed. One case per codec
and fault: LZW (an undefined code, a full table, data that end early,
with and without predictor 2, no Clear first), PackBits (runs and
literals past the buffer or the data), Deflate (a data error, a bad
check value, short data), CCITT in Modified Huffman, Group 3 1-D and 2-D
and Group 4 (a bad code word, an EOL inside a row, a row of another
length, data that end early, Group 3 data without EOLs, more runs than
libtiff's run arrays hold, uncompressed-mode codes), JPEG strips (bytes
before a marker, a cut, bad Huffman codes, a wrong restart marker, a
stream smaller than its strip, an unfinished progressive stream), byte
counts (past the file's end, 0, cut short, libtiff's estimates), over
strips, tiles, planar layout and FillOrder 2. Then a seeded corpus of
1,050 files from 15 sources damaged only in strip or tile data and byte
counts (0 refused, 0 different among the reads cv2 makes), a whole-file
corpus whose refusals all name a fault of the IFD, the manifest's damaged
sets (chip_smoke.py part 7h), and the pipeline and CLI against the JAX
package's (EPE ratio 1e-3). Every case is written to a file and held to
cv2.imread of it, gray and colour, tolerance 0.
"""

import hashlib
import io as _io
import json
import os
import re
import struct
import sys
import zlib

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from of_dis_tpu import cli as jcli  # noqa: E402
from of_dis_tpu import pipeline as jax_pipeline  # noqa: E402
from of_dis_tpu.utils import io as jio  # noqa: E402
from of_dis_tpu_torch import cli, pipeline  # noqa: E402
from of_dis_tpu_torch.native import io as nio  # noqa: E402
from of_dis_tpu_torch.utils import io as uio  # noqa: E402
from tests.test_torch_pipeline import assert_files_match_jax  # noqa: E402
from tests.test_torch_tiff import (  # noqa: E402
    EPE_RATIO, FIXTURES, H, MANIFEST, W, _jpeg, _shift_planes, _sha,
    assert_as_cv2, cv2_planes, mf, write)
from tests.test_torch_tiff_fax import (  # noqa: E402
    BLACK, EOL, WHITE, _blobs, _stream_tiff)

sys.path.insert(0, mf.JPEG_DIR)
from damage import damage  # noqa: E402

sys.path.pop(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def set_count(raw, i, value):
    """`raw` (a classic TIFF) with byte count i set."""
    _, _, at, size = mf.chunk_table(raw)[i]
    b = bytearray(raw)
    b[at:at + size] = struct.pack(("<" if raw[:2] == b"II" else ">")
                                  + ("H" if size == 2 else "I"), value)
    return bytes(b)


def flip(raw, at, mask=0x5A):
    b = bytearray(raw)
    b[at] ^= mask
    return bytes(b)


def chunk(raw, i):
    """(offset, byte count) of chunk i."""
    return mf.chunk_table(raw)[i][:2]


def assert_cv2_fails(raw):
    """cv2.imread fails on the file, gray and colour; the port raises
    ValueError saying so."""
    path = write(raw, "fails.tif")
    for ch in (1, 3):
        assert cv2_planes(path, ch) is None
        with pytest.raises(ValueError, match="cv::imread fails on it too"):
            nio.decode_image(raw, ch)


# ------------------------------------------------------------------- LZW

def lzw_codes(codes):
    """Codes packed MSB-first at the widths libtiff's decoder reads them:
    9 bits after a Clear, one more once the next free entry passes
    2^n - 2, up to 12 (the table full at 5119 entries)."""
    bits, width, free = [], 9, 5119
    for c in codes:
        bits.append(format(c, f"0{width}b"))
        if c == 256:
            width, free = 9, 258
        elif c != 257 and free < 5119:
            free += 1
            if free > (1 << width) - 2 and width < 12:
                width += 1
    s = "".join(bits)
    s += "0" * (-len(s) % 8)
    return bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))


G = mf._blur(19, 37, 1, 3)[..., 0]
C = mf._blur(19, 37, 3, 4)


def _lzw_full_table():
    """Literal codes only, with no Clear after the first: once 4,861 new
    entries fill the table, the next code ends the strip."""
    rng = np.random.default_rng(5)
    lits = [int(v) for v in rng.integers(0, 256, 4900)]
    data = lzw_codes([256] + lits + [257])
    return mf.tiff(np.zeros((60, 100), np.uint8), compression=5,
                   chunks=[data])


def _lzw_cut(pred, big_endian=False, bits=8):
    img = G if bits == 8 else G * 257 + 7
    raw = mf.tiff(img, compression=5, predictor=pred, rows_per_strip=7,
                  bits=bits, big_endian=big_endian)
    return set_count(raw, 1, chunk(raw, 1)[1] // 2)


def _mid_flip(raw, i, mask=0x5A):
    off, cnt = chunk(raw, i)
    return flip(raw, off + cnt // 2, mask)


LZW = {
    "undefined code": lambda: mf.tiff(
        np.zeros((5, 9), np.uint8), compression=5,
        chunks=[lzw_codes([256, 65, 66, 300, 257])]),
    "undefined code after Clear": lambda: mf.tiff(
        np.zeros((5, 9), np.uint8), compression=5,
        chunks=[lzw_codes([256, 65, 256, 258, 257])]),
    "end code early": lambda: mf.tiff(
        np.zeros((5, 9), np.uint8), compression=5,
        chunks=[lzw_codes([256, 65, 66, 259, 257])]),
    "full table": _lzw_full_table,
    "no Clear first, predictor": lambda: mf.tiff(
        G, compression=5, predictor=2,
        chunks=[lzw_codes([65, 66, 257])]),
    "data end early": lambda: _lzw_cut(1),
    "data end early, predictor": lambda: _lzw_cut(2),
    "16-bit big-endian, predictor, cut": lambda: _lzw_cut(2, True, 16),
    "flip, predictor": lambda: _mid_flip(
        mf.tiff(G, compression=5, predictor=2, rows_per_strip=5), 2),
    "flip, planar RGB": lambda: _mid_flip(
        mf.tiff(C, compression=5, planar=True, rows_per_strip=8), 4),
    "flip, tiles": lambda: _mid_flip(
        mf.tiff(C, compression=5, tile=(16, 16)), 1),
    "flip, FillOrder 2": lambda: _mid_flip(
        mf.tiff(G, compression=5, fill_order=2, rows_per_strip=6), 1),
    "flip, palette": lambda: _mid_flip(
        mf.tiff(G, compression=5, colormap=np.arange(768).reshape(256, 3)
                * 85 % 65536, rows_per_strip=6), 0),
}


@pytest.mark.parametrize("case", sorted(LZW))
def test_lzw_faults_read_as_cv2(case):
    assert_as_cv2(LZW[case]())


def test_lzw_fault_skips_predictor_and_swab():
    """A failed LZW chunk keeps its raw differences: libtiff undoes the
    predictor (and swabs 16-bit data) only where the codec succeeds."""
    raw = _lzw_cut(2)
    got = nio.decode_image(raw, 1)[0]
    np.testing.assert_array_equal(got[:7], G[:7])       # strip 0 intact
    assert (got[7:14] != G[7:14]).mean() > 0.5           # differences
    assert (got[14:] == G[14:]).all()


# -------------------------------------------------------------- PackBits

def _packbits(chunks, h=4, w=9):
    return mf.tiff(np.zeros((h, w), np.uint8), compression=32773,
                   chunks=chunks)


PACKBITS = {
    "run past the buffer": lambda: _packbits([bytes([256 - 40, 7, 0, 9])]),
    "literal past the buffer": lambda: _packbits([bytes([60]) + bytes(
        range(61))]),
    "run without its byte": lambda: _packbits([bytes([2, 1, 2, 3, 255])]),
    "literal past the data": lambda: _packbits([bytes([30, 1, 2, 3])]),
    "nop and short data": lambda: _packbits([bytes([128, 128, 1, 9, 8])]),
    "cut count, tiles": lambda: set_count(
        mf.tiff(C, compression=32773, tile=(16, 16)), 2, 17),
    "flip, strips": lambda: _mid_flip(
        mf.tiff(C, compression=32773, rows_per_strip=4), 1, 0xF0),
}


@pytest.mark.parametrize("case", sorted(PACKBITS))
def test_packbits_faults_read_as_cv2(case):
    assert_as_cv2(PACKBITS[case]())


# --------------------------------------------------------------- Deflate

def _deflate_error():
    """A flipped byte where zlib stops on corrupt data partway through the
    strip (the first such byte from the middle on)."""
    raw = mf.tiff(G, compression=8, predictor=2, rows_per_strip=10)
    off, cnt = chunk(raw, 0)
    data = raw[off:off + cnt]
    for k in range(cnt // 2, cnt - 4):
        bad = data[:k] + bytes([data[k] ^ 0xFF]) + data[k + 1:]
        try:
            zlib.decompressobj().decompress(bad, 370)
        except zlib.error:
            if 0 < len(nio._inflate_prefix(bad, 370)) < 370:
                return flip(raw, off + k, 0xFF)
    raise AssertionError("no flip stops zlib partway")


def _deflate_check():
    """The Adler-32 after the last byte spoilt: zlib fails only once the
    buffer is full, and libtiff then undoes no predictor."""
    raw = mf.tiff(C, compression=8, predictor=2, rows_per_strip=5)
    off, cnt = chunk(raw, 1)
    return flip(raw, off + cnt - 1, 0x01)


DEFLATE = {
    "data error, predictor": _deflate_error,
    "bad check value, predictor": _deflate_check,
    "bad header": lambda: flip(mf.tiff(G, compression=8), 8, 0x10),
    "short data": lambda: set_count(
        mf.tiff(G, compression=8, rows_per_strip=8), 1, 40),
    "short data, planar tiles": lambda: set_count(
        mf.tiff(C, compression=32946, planar=True, tile=(16, 16)), 7, 30),
    "16-bit big-endian short data": lambda: _deflate_be16(),
}


def _deflate_be16():
    raw = mf.tiff(C * 257 + 9, bits=16, compression=8, big_endian=True,
                  rows_per_strip=6)
    return set_count(raw, 1, chunk(raw, 1)[1] // 2)


@pytest.mark.parametrize("case", sorted(DEFLATE))
def test_deflate_faults_read_as_cv2(case):
    assert_as_cv2(DEFLATE[case]())


def test_inflate_prefix_is_zlibs_output():
    """The pure-Python inflate that gives what zlib wrote before it
    stopped: on intact streams of every block type, zlib's output."""
    rng = np.random.default_rng(21)
    for level in (0, 1, 6, 9):
        for data in (rng.integers(0, 4, 3000), rng.integers(0, 256, 700),
                     np.cumsum(rng.integers(-2, 3, 2000))):
            raw = (data % 256).astype(np.uint8).tobytes()
            assert nio._inflate_prefix(zlib.compress(raw, level),
                                       len(raw)) == raw


# ----------------------------------------------------------------- CCITT

def _g4(bits, width, rows, options=None):
    return _stream_tiff(bits, width, rows, 4, options)


FAX = {
    # Modified Huffman
    "mh bad code": ("00000001" + WHITE[7] + "0", 7, 2, 2, None),
    "mh premature EOL": (WHITE[2] + EOL + WHITE[7], 7, 2, 2, None),
    "mh line length": (WHITE[4] + BLACK[5] + "0000" + WHITE[7], 7, 2, 2,
                       None),
    "mh premature EOF": (WHITE[2] + BLACK[2], 7, 3, 2, None),
    # Group 3 1-D
    "g3 1d bad code": (EOL + "00000001" + EOL + WHITE[7], 7, 2, 3, None),
    "g3 1d premature EOL": (EOL + WHITE[3] + EOL + WHITE[7], 7, 2, 3, None),
    "g3 1d line length": (EOL + WHITE[4] + BLACK[5] + EOL + WHITE[7], 7, 2,
                          3, None),
    "g3 1d premature EOF": (EOL + WHITE[2] + BLACK[2], 7, 2, 3, None),
    "g3 1d without EOLs": (EOL + WHITE[7] + WHITE[4] + BLACK[3] + "1", 7, 3,
                           3, None),
    "g3 1d runs overflow": (EOL + ("000111" + BLACK[0]) * 20 + WHITE[4],
                            31, 1, 3, None),    # white 1, black 0 ...
    # Group 3 2-D
    "g3 2d bad VL": (EOL + "1" + WHITE[7] + EOL + "0" + "010" + "1" * 8, 7,
                     2, 3, 1),
    "g3 2d premature EOL": (EOL + "0" + "001" + WHITE[2] + BLACK[2]
                            + "0000000" + "0000" + EOL + "1" + WHITE[7], 7,
                            2, 3, 1),
    "g3 2d line length": (EOL + "0" + "0000011", 7, 1, 3, 1),
    "g3 2d premature EOF": (EOL + "1" + WHITE[7] + EOL + "0" + "001", 7, 2,
                            3, 1),
    "g3 2d uncompressed": (EOL + "0" + "0000001111" + EOL + "1" + WHITE[7],
                           7, 2, 3, 3),
    "g3 2d runs overflow": (EOL + "0" + ("001" + WHITE[0] + BLACK[0]) * 40,
                            31, 1, 3, 1),
    # Group 4
    "g4 bad code in a horizontal run": ("001" + "00000001" + "1" * 16, 7, 3,
                                        4, None),
    "g4 EOL ends the strip": ("1" + "000000000001" + "1" * 16, 7, 3, 4,
                              None),
    "g4 line length": ("0000011" + "1" * 16, 7, 2, 4, None),
    "g4 premature EOF": ("1" + "001" + WHITE[2], 7, 3, 4, None),
    "g4 uncompressed": ("1" + "0000001111" + "1" * 16, 7, 3, 4, 2),
    "g4 runs overflow": (("001" + WHITE[0] + BLACK[0]) * 40, 31, 1, 4,
                         None),
}


@pytest.mark.parametrize("case", sorted(FAX))
def test_ccitt_faults_read_as_cv2(case):
    """Streams put together bit by bit, one fault each."""
    bits, width, rows, comp, opts = FAX[case]
    assert_as_cv2(_stream_tiff(bits, width, rows, comp, opts))


def _fax_layout(mode, kw, fault):
    comp, opts = {"mh": ("tiff_ccitt", None), "g3_1d": ("group3", None),
                  "g3_2d": ("group3", 1), "g4": ("group4", None)}[mode]
    raw = mf.fax_tiff(_blobs(40, 61, 9), comp, opts, **kw)
    if fault == "cut":
        return set_count(raw, 1, chunk(raw, 1)[1] // 3)
    return _mid_flip(raw, 1, 0x24)


@pytest.mark.parametrize("fault", ["flip", "cut"])
@pytest.mark.parametrize("layout", ["strips", "tiles", "strips fill2"])
@pytest.mark.parametrize("mode", ["mh", "g3_1d", "g3_2d", "g4"])
def test_ccitt_damaged_chunks_read_as_cv2(mode, layout, fault):
    """libtiff's encoder's strips and tiles with a byte flipped or the
    data cut short in chunk 1: the chunks after it decode on (Group 3
    without EOLs from there on, where a chunk's data ended at a row
    start)."""
    kw = {"strips": {"rows_per_strip": 9}, "tiles": {"tile": (32, 16)},
          "strips fill2": {"rows_per_strip": 9, "fill_order": 2}}[layout]
    assert_as_cv2(_fax_layout(mode, kw, fault))


# ------------------------------------------------------------ JPEG strips

JC = cv2.GaussianBlur((np.random.default_rng(31).random((61, 83, 3))
                       * 255).astype(np.float32), (0, 0), 2.0).astype(
                           np.uint8)


def _jpg(img=JC, restart=0, progressive=False):
    ok, enc = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok
    return enc.tobytes()


def _jpeg_case(edit, restart=0, progressive=False, size=(83, 61)):
    return mf.jpeg_tiff(edit(_jpg(restart=restart, progressive=progressive)),
                        *size)


def _mid_scan(data, k):
    """An offset in the middle of scan k's entropy-coded data."""
    sos = [m.start() for m in re.finditer(rb"\xff\xda", data)]
    end = data.index(b"\xff", sos[k] + 2 + int.from_bytes(
        data[sos[k] + 2:sos[k] + 4], "big") + 1)
    while data[end + 1] in (0, *range(0xD0, 0xD8)):
        end = data.index(b"\xff", end + 2)
    return (sos[k] + end) // 2


def _rst(data, k):
    """The offset of the k-th restart marker."""
    return [m.start() for m in re.finditer(rb"\xff[\xd0-\xd7]", data)][k]


JPEG = {
    "extraneous bytes": lambda: _jpeg_case(
        lambda d: d[:_rst(d, 2)] + b"\x12\x34\x56" + d[_rst(d, 2):], 4),
    "a cut": lambda: _jpeg_case(lambda d: d[:len(d) * 2 // 3]),
    "bad Huffman code": lambda: _jpeg_case(
        lambda d: d[:len(d) // 2] + b"\xff\x00\xff\x00\xfe"
        + d[len(d) // 2 + 5:]),
    "wrong restart marker": lambda: _jpeg_case(
        lambda d: d[:_rst(d, 3) + 1] + bytes([0xD0 | (d[_rst(d, 3) + 1]
                                                       + 3) & 7])
        + d[_rst(d, 3) + 2:], 2),
    "smaller than its strip": lambda: _jpeg_case(lambda d: d,
                                                 size=(90, 70)),
    "unfinished progressive": lambda: _jpeg_case(
        lambda d: d[:_mid_scan(d, 4)], progressive=True),
    "strip count cut": lambda: set_count(_jpeg_case(lambda d: d), 0, 900),
}


@pytest.mark.parametrize("case", sorted(JPEG))
def test_jpeg_strip_faults_read_as_cv2(case):
    assert_as_cv2(JPEG[case]())


def _two_strip_jpeg(rows1):
    """83 x 61 YCbCr JPEG-in-TIFF in strips of 32 rows, strip 1's stream
    `rows1` rows (29 fill the image)."""
    segs0, rest0 = mf.jpeg_segments(_jpg(JC[:32]))
    segs1, rest1 = mf.jpeg_segments(_jpg(np.resize(JC[32:], (rows1, 83, 3))))
    tables = b"\xff\xd8" + b"".join(
        s for m, s in segs0 if m in (0xC4, 0xDB)) + b"\xff\xd9"
    streams = [b"\xff\xd8" + b"".join(s for m, s in segs if m not in (
        0xC4, 0xDB) and not 0xE0 <= m <= 0xEF) + rest
        for segs, rest in ((segs0, rest0), (segs1, rest1))]
    return mf.tiff(np.zeros((61, 83, 3), np.uint8), compression=7,
                   photometric=6, chunks=streams, jpeg_tables=tables,
                   ycbcr_subsampling=(2, 2), rows_per_strip=32)


def test_jpeg_last_strip_may_be_taller():
    """libtiff reads a last strip whose stream has more rows than the
    image has left (a warning); a stream larger than its strip elsewhere
    fails JPEGPreDecode, and cv::imread with it."""
    assert_as_cv2(_two_strip_jpeg(32))
    assert_as_cv2(_two_strip_jpeg(29))
    assert_cv2_fails(mf.jpeg_tiff(_jpg(), 80, 61))


@pytest.mark.parametrize("scans", [99, 100])
def test_jpeg_strip_of_100_scans_fails_as_in_libtiff(scans):
    """libtiff's progress monitor fails a JPEG stream once it reaches its
    100th scan (the last scan of a progressive stream repeated here);
    99 scans read as cv2 reads them."""
    d = _jpg(progressive=True)
    sos = [m.start() for m in re.finditer(rb"\xff\xda", d)]
    d = d[:-2] + d[sos[-1]:-2] * (scans - len(sos)) + b"\xff\xd9"
    raw = mf.jpeg_tiff(d, 83, 61)
    if scans < 100:
        assert_as_cv2(raw)
    else:
        assert_cv2_fails(raw)


# ------------------------------------------------------------ byte counts

def _planar_lzw():
    return mf.tiff(C, compression=5, planar=True, rows_per_strip=8)


COUNTS = {
    "plane 2 past the end": lambda: set_count(_planar_lzw(), 7, 1 << 19),
    "plane 1 of 0": lambda: set_count(_planar_lzw(), 4, 0),
    "one compressed strip of 0": lambda: set_count(
        mf.tiff(G, compression=5), 0, 0),
    "one PackBits strip of 0, palette": lambda: set_count(
        mf.tiff(G, compression=32773, colormap=np.arange(768).reshape(
            256, 3) * 257 % 65536), 0, 0),
    "above 1 MiB, cut to ten strips": lambda: set_count(
        mf.tiff(np.tile(G, (8, 1)), compression=5, rows_per_strip=1), 3,
        0x02000000),
    "uncompressed strips of unequal counts": lambda: set_count(
        mf.tiff(G, rows_per_strip=4), 1, 100),
    "uncompressed last strip short": lambda: set_count(
        mf.tiff(C, rows_per_strip=4), 4, 50),
    "uncompressed one strip short": lambda: set_count(mf.tiff(C), 0, 90),
    "uncompressed one strip of 0": lambda: set_count(mf.tiff(G), 0, 0),
    "no codec in libtiff": lambda: mf.tiff(
        G, chunks=[b"\x55" * 40], photometric=0,
        extra_tags=((259, 3, [34712]),)),
}


@pytest.mark.parametrize("case", sorted(COUNTS))
def test_byte_count_faults_read_as_cv2(case):
    assert_as_cv2(COUNTS[case]())


@pytest.mark.parametrize("make", [
    lambda: set_count(mf.tiff(G, compression=5, rows_per_strip=5), 2,
                      1 << 20),
    lambda: set_count(mf.tiff(C, compression=8, tile=(16, 16)), 0, 0),
    lambda: set_count(_planar_lzw(), 1, 1 << 19),
    lambda: set_count(mf.jpeg_tiff(_jpg(), 83, 61), 0, 1 << 20)],
    ids=["strip past the end", "tile of 0", "plane 0 past the end",
         "JPEG strip past the end"])
def test_unreadable_first_plane_fails_as_in_cv2(make):
    """TIFFFillStrip / TIFFFillTile fail on a byte count of 0 or past the
    end of the file (the file mapped); in the first plane cv::imread fails
    with them."""
    assert_cv2_fails(make())


# ---------------------------------------------------------------- corpus

_CORPUS_C = mf._blur(48, 80, 3, 21).astype(np.uint8)
_CORPUS_G = mf._blur(48, 80, 1, 22)[..., 0].astype(np.uint8)


def _cv2_tif(img, comp):
    ok, enc = cv2.imencode(".tif", img, [cv2.IMWRITE_TIFF_COMPRESSION, comp])
    assert ok
    return enc.tobytes()


def _pil_tif(bgr, mode, comp, **kw):
    buf = _io.BytesIO()
    Image.fromarray(np.ascontiguousarray(bgr[..., ::-1])).convert(mode).save(
        buf, "TIFF", compression=comp, **kw)
    return buf.getvalue()


def corpus_sources():
    """The corpus's 15 sources (name -> bytes): cv2, PIL and the numpy
    writers, every codec, strips, tiles, planar, FillOrder 2, 16-bit
    big-endian."""
    c, g = _CORPUS_C, _CORPUS_G
    bl = _blobs(48, 80, 5)
    jpg = open(os.path.join(mf.JPEG_DIR, "variants", "s420.jpg"), "rb").read()
    return {
        "cv2_lzw_gray": _cv2_tif(np.tile(g, (4, 1)), 5),
        "cv2_deflate_rgb": _cv2_tif(np.tile(c, (3, 1, 1)), 8),
        "pil_lzw_rgb": _pil_tif(c, "RGB", "tiff_lzw", strip_size=1000),
        "pil_jpeg_ycbcr": _pil_tif(c, "RGB", "jpeg", strip_size=4000),
        "lzw_pred_gray": mf.tiff(g, compression=5, predictor=2,
                                 rows_per_strip=8),
        "lzw_planar_rgb": mf.tiff(c, compression=5, planar=True,
                                  rows_per_strip=16),
        "packbits_tiled_rgb": mf.tiff(c, compression=32773, tile=(32, 16)),
        "deflate_pred16_be": mf.tiff(c.astype(np.int64) * 257, bits=16,
                                     compression=8, predictor=2,
                                     big_endian=True, rows_per_strip=12),
        "jpeg_tiff": mf.jpeg_tiff(jpg, 83, 61),
        "fax_mh": mf.fax_tiff(bl, "tiff_ccitt", rows_per_strip=16),
        "fax_g3_1d": mf.fax_tiff(bl, "group3", rows_per_strip=16),
        "fax_g3_2d_fill2": mf.fax_tiff(bl, "group3", 1, rows_per_strip=16,
                                       fill_order=2),
        "fax_g4_tiled": mf.fax_tiff(bl, "group4", tile=(32, 32)),
        "fax_g4": mf.fax_tiff(bl, "group4", rows_per_strip=24),
        "none_gray": mf.tiff(g, rows_per_strip=8),
    }


def damage_chunks(raw, rng):
    """One damage to strip or tile data or byte counts: 1-3 bytes flipped
    in one chunk (6 in 10), a byte count cut short (2 in 10), made longer
    (1 in 10) or with one byte flipped (1 in 10)."""
    table = mf.chunk_table(raw)
    kind = rng.integers(0, 10)
    b = bytearray(raw)
    if kind < 6:
        off, cnt, _, _ = table[int(rng.integers(len(table)))]
        for _ in range(int(rng.integers(1, 4))):
            b[off + int(rng.integers(cnt))] ^= int(rng.integers(1, 256))
        return bytes(b)
    i = int(rng.integers(len(table)))
    _, cnt, _, size = table[i]
    if kind < 8:
        value = int(rng.integers(0, cnt))
    elif kind < 9:
        value = cnt + int(rng.integers(1, 64))
    else:
        value = cnt ^ (int(rng.integers(1, 256)) << 8 * int(
            rng.integers(0, size)))
    return set_count(raw, i, value)


def test_seeded_corpus_reads_as_cv2(tmp_path):
    """1,050 files (70 a source) damaged in strip or tile data and byte
    counts only: the port refuses none of the reads cv2 makes, and every
    one equals cv2's planes; where cv2 fails the port raises."""
    path = str(tmp_path / "d.tif")
    counts = {"same": 0, "refused": 0, "different": 0, "both fail": 0,
              "port reads": 0}
    for s, (name, src) in enumerate(sorted(corpus_sources().items())):
        rng = np.random.default_rng([2026, s])
        for _ in range(70):
            raw = damage_chunks(src, rng)
            with open(path, "wb") as f:
                f.write(raw)
            for ch in (1, 3):
                want = cv2_planes(path, ch)
                try:
                    got = nio.decode_image(raw, ch)
                except ValueError:
                    counts["refused" if want is not None
                           else "both fail"] += 1
                    continue
                if want is None:
                    counts["port reads"] += 1
                elif got.shape == want.shape and np.array_equal(got, want):
                    counts["same"] += 1
                else:
                    counts["different"] += 1
    assert counts["refused"] == counts["different"] == 0, counts
    assert counts["port reads"] == 0, counts
    assert counts["same"] > 1500, counts


# the faults of the IFD itself the port still refuses (ROADMAP Queue 3)
IFD_FAULTS = re.compile(
    r"tags out of order|tag \d+ twice|values lie beyond the file|"
    r"offsets and \d+ byte counts for|tag \d+ (of type \d+ and \d+ values|"
    r"with \d+ values|with values)|IFD offset|truncated TIFF IFD|"
    r"TIFF IFD entry of type")


def test_whole_file_corpus_refuses_only_ifd_faults(tmp_path):
    """Files cut or with bytes flipped anywhere (the IFD too): every
    read cv2 makes that the port refuses names a fault of the IFD, and
    every read both make agrees."""
    path = str(tmp_path / "w.tif")
    refused = []
    for s, (name, src) in enumerate(sorted(corpus_sources().items())):
        rng = np.random.default_rng([2027, s])
        for _ in range(30):
            b = bytearray(src)
            if rng.random() < 0.3:
                del b[int(rng.integers(8, len(b))):]
            else:
                for _ in range(int(rng.integers(1, 4))):
                    b[int(rng.integers(0, len(b)))] ^= int(
                        rng.integers(1, 256))
            raw = bytes(b)
            with open(path, "wb") as f:
                f.write(raw)
            for ch in (1, 3):
                want = cv2_planes(path, ch)
                try:
                    got = nio.decode_image(raw, ch)
                except ValueError as e:
                    if want is not None:
                        refused.append(str(e))
                    continue
                assert want is not None, name
                np.testing.assert_array_equal(got, want, err_msg=name)
    assert all(IFD_FAULTS.search(r) for r in refused), refused


# -------------------------------------------------- manifest (part 7h)

DAMAGED = MANIFEST["damaged"]


def test_manifest_damaged_sets_match_cv2_and_the_decoder(tmp_path):
    """Part 7h's sets: each source's SHA-256 as recorded (the generated
    sets written here from the JPEG frames, fax_g4 the committed files),
    the edits applied, and every plane of cv2.imread, `decode_batch` and
    `load_image` equal to the manifest's hash; the damage changes under
    5% of a frame's pixels. The numpy writers' sets (LZW and PackBits,
    slow in pure Python) on frames 0-2, one of each kind of edit; part 7h
    holds all nine to the hashes on the card's host."""
    assert sorted(DAMAGED["sets"]) == sorted(mf.DAMAGED)
    planes, raws = mf.jpeg_frames()
    for name, frames in sorted(DAMAGED["sets"].items()):
        assert len(frames) == 9
        for t, fr in enumerate(frames):
            if name in ("lzw_pred", "packbits_tiled") and t > 2:
                continue
            if name in mf.COMMITTED:
                with open(os.path.join(FIXTURES, fr["source"]), "rb") as f:
                    src = f.read()
            else:
                src = mf.encode_frame(name, *planes[t], raws[t])
            assert hashlib.sha256(src).hexdigest() == \
                DAMAGED["sources"][fr["source"]], fr["source"]
            assert fr["edits"] == mf.damage_edits(src, t, *mf.DAMAGED[name])
            path = write(damage(src, fr["edits"]), fr["name"],
                         str(tmp_path))
            rec = DAMAGED["planes"][f"{name}/{fr['name']}"]
            assert rec["changed"] < 0.05 and (rec["changed"] > 0) == bool(
                fr["edits"])
            for key, ch in (("gray", 1), ("color", 3)):
                for got in (cv2_planes(path, ch),
                            nio.decode_batch([path], ch)[0],
                            uio.load_image(path, ch).astype(np.uint8)):
                    assert list(got.shape) == rec[key]["shape"]
                    assert _sha(got) == rec[key]["sha256"], (path, key)


# ------------------------------------------------------- pipeline, CLI

def _damaged_frames(directory, kinds, seed):
    """Frames moving (1.5, 0.5) px a frame, each of `kinds` (a format of
    make_fixtures.FORMATS and a damage) in turn, written to `directory`;
    their paths. The damage, as in part 7h, to a few of a frame's rows:
    chunk 1's data with a byte flipped or its count cut at 90%."""
    planes = _shift_planes(len(kinds), 1.5, 0.5, seed=seed)
    paths = []
    for t, (fmt, how) in enumerate(kinds):
        raw = mf.encode_frame(fmt, *planes[t], _jpeg(planes[t][1]))
        off, cnt = chunk(raw, 1)
        if how == "flip":
            raw = flip(raw, off + cnt * 9 // 10)
        elif how == "cut":
            raw = set_count(raw, 1, cnt * 9 // 10)
        paths.append(write(raw, f"frame_{t:04d}.tif", directory))
    return paths


def test_damaged_tiff_pipeline_matches_jax(tmp_path):
    """Three damaged frames (two pairs, batch 2, gray flow) through the
    port's pipeline, against the JAX pipeline on cv2's gray planes of the
    same files as PGM."""
    port_dir, pgm_dir = tmp_path / "tiff", tmp_path / "pgm"
    os.makedirs(port_dir)
    os.makedirs(pgm_dir)
    paths = _damaged_frames(str(port_dir), [("lzw_pred", "flip"),
                                            ("packbits_tiled", "cut"),
                                            ("deflate_rgb", "flip")], 4)
    for p in paths:
        gray = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        write(b"P5\n%d %d\n255\n" % (W, H) + gray.tobytes(),
              os.path.basename(p)[:-4] + ".pgm", str(pgm_dir))
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pipeline.run_pipeline(str(pgm_dir), jax_out, op_point=2, batch=2,
                              mode="run_OF_INT", verbose=False)
    assert pipeline.run_pipeline(str(port_dir), out, op_point=2, batch=2,
                                 mode="run_OF_INT", verbose=False,
                                 device="cpu") == 2
    assert assert_files_match_jax(out, jax_out) == ["frame_0000.flo",
                                                   "frame_0001.flo"]


def _epe_ratio(got, want):
    return float(np.linalg.norm(got - want, axis=-1).mean()
                 / np.linalg.norm(want, axis=-1).mean())


def _clis(paths, mode, tmp_path):
    """(the port's flow, the JAX package's flow) of `cli.main` on a pair,
    op-2."""
    ours, ref = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    cli.main([mode, *paths, ours, "2", "--quiet", "--device", "cpu"])
    jcli.main([mode, *paths, ref, "2", "--quiet"])
    return uio.read_flo(ours), jio.read_flo(ref)


@pytest.mark.parametrize("mode,kinds", [
    ("run_OF_INT", [("lzw_pred", "cut"), ("lzw_pred", "flip")]),
    ("run_OF_RGB", [("ycbcr_lzw", "flip"), ("packbits_tiled", "cut")])])
def test_damaged_tiff_cli_matches_jax(tmp_path, mode, kinds):
    """The port's CLI and the JAX package's (whose `load_image` reads the
    files through cv2) on a damaged pair."""
    got, want = _clis(_damaged_frames(str(tmp_path), kinds, 5), mode,
                      tmp_path)
    assert got.shape == want.shape == (H, W, 2)
    assert _epe_ratio(got, want) <= EPE_RATIO


def test_damaged_pair_the_flow_does_not_settle_on(tmp_path):
    """Some damaged pairs leave the port's CLI further than 1e-3 (EPE
    ratio) from the JAX CLI although both read the same planes, bit for
    bit: here frame 1's strip 1 cut at 90% (rows 93-95 read 0), RGB flow,
    3.4e-3. On this pair the JAX CLI moves further from itself when one
    sample of frame 0 changes by 1 (3.2e-2): the flow is not settled to
    the budget by the pixels. The port stays within that spread."""
    paths = _damaged_frames(str(tmp_path), [("packbits_tiled", None),
                                            ("deflate_rgb", "cut")], 5)
    got, want = _clis(paths, "run_OF_RGB", tmp_path)
    a = cv2.imread(paths[0])
    a[40, 20, 0] ^= 1
    nudged = write(cv2.imencode(".png", a)[1].tobytes(), "nudged.png",
                   str(tmp_path))
    ref = str(tmp_path / "nudged.flo")
    jcli.main(["run_OF_RGB", nudged, paths[1], ref, "2", "--quiet"])
    spread = _epe_ratio(jio.read_flo(ref), want)
    assert spread > 10 * EPE_RATIO
    assert EPE_RATIO < _epe_ratio(got, want) <= spread


def corpus_counts(decode):
    """{corpus: {outcome: reads}} of both corpora above (the seeded one of
    strip and tile damage and the whole-file one) under `decode` (raw,
    channels) -> planes, which raises ValueError where it refuses."""
    import tempfile
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "c.tif")
        for corpus, seed, n in (("chunks", 2026, 70), ("whole file", 2027,
                                                         30)):
            counts = dict.fromkeys(("same", "refused", "different",
                                    "both fail", "port reads"), 0)
            for s, (name, src) in enumerate(sorted(corpus_sources().items())):
                rng = np.random.default_rng([seed, s])
                for _ in range(n):
                    if corpus == "chunks":
                        raw = damage_chunks(src, rng)
                    else:
                        b = bytearray(src)
                        if rng.random() < 0.3:
                            del b[int(rng.integers(8, len(b))):]
                        else:
                            for _ in range(int(rng.integers(1, 4))):
                                b[int(rng.integers(0, len(b)))] ^= int(
                                    rng.integers(1, 256))
                        raw = bytes(b)
                    with open(path, "wb") as f:
                        f.write(raw)
                    for ch in (1, 3):
                        want = cv2_planes(path, ch)
                        try:
                            got = decode(raw, ch)
                        except ValueError:
                            counts["refused" if want is not None
                                   else "both fail"] += 1
                            continue
                        counts["port reads" if want is None else "same"
                               if np.array_equal(got, want)
                               else "different"] += 1
            out[corpus] = counts
    return out


if __name__ == "__main__":
    # python -m tests.test_torch_tiff_damaged [CHECKOUT]: both corpora's
    # counts under CHECKOUT's decoder (default this one's), the files made
    # by this checkout's writers
    import importlib
    tree = sys.argv[1] if len(sys.argv) > 1 else None
    if tree:
        for m in [m for m in sys.modules if m.startswith("of_dis_tpu_torch")]:
            del sys.modules[m]
        sys.path.insert(0, os.path.abspath(tree))
    decoder = importlib.import_module("of_dis_tpu_torch.native.io")
    print(json.dumps({"decoder": decoder.__file__,
                      **corpus_counts(decoder.decode_image)}))
