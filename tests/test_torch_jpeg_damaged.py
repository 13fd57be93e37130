"""Damaged JPEG files that libjpeg decodes with a warning, read by the port's
decoder (`csrc/jpeg.cpp`, through `native.io.decode_jpeg`, `decode_batch`
and `utils.io.load_image`) exactly as cv2.imread reads the file, and the
serving pipeline and CLI on damaged frames against the JAX package's.

cv2.imread reads a file through libjpeg's stdio source, which follows the
file's end with fake EOI markers; cv2.imdecode of the same bytes fails on
a file cut short, so every case here is written to a file and held to
cv2.imread of it (gray and colour, tolerance 0), and the port's
`load_image` to the JAX package's, which reaches the same cv2.imread.
One case per warning family: bytes before a marker, data that end early,
bad Huffman and arithmetic codes and AC runs past the block, wrong restart
markers (each of jpeg_resync_to_restart's choices), scan parameters
libjpeg only warns about, unfinished progressive images (block
smoothing), unknown Adobe transforms; then a seeded corpus of 2,000 cut
and byte-flipped files, where the port reads every file cv2 reads to
exactly its planes and raises ValueError on every file cv2 fails on. The
pipeline and CLI runs are held at the port-vs-JAX budget of
tests/test_torch_pipeline.py (EPE ratio 1e-3).
"""

import os
import struct

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from of_dis_tpu import cli as jcli  # noqa: E402
from of_dis_tpu import pipeline as jax_pipeline  # noqa: E402
from of_dis_tpu.utils import io as jio  # noqa: E402
from of_dis_tpu_torch import cli, pipeline  # noqa: E402
from of_dis_tpu_torch.native import io as nio  # noqa: E402
from of_dis_tpu_torch.utils import io as uio  # noqa: E402
from tests.test_torch_pipeline import assert_files_match_jax  # noqa: E402

VARIANTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures", "jpeg", "variants")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}
EPE_RATIO = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def content(h, w, seed):
    """(h, w, 3) uint8 BGR of blurred random content."""
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur((rng.random((h, w, 3)) * 255).astype(
        np.float32), (0, 0), 3.0)
    lo, hi = img.min(), img.max()
    return ((img - lo) / (hi - lo) * 255).astype(np.uint8)


def encode(img, quality=90, sampling="420", progressive=False, restart=0):
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    return buf.tobytes()


def variant(name):
    with open(os.path.join(VARIANTS, name), "rb") as f:
        return f.read()


def imread(path, channels):
    """cv2.imread's planes, (C, H, W), or None where it fails."""
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if channels == 1
                     else cv2.IMREAD_COLOR)
    if img is None:
        return None
    return img[None] if img.ndim == 2 else img.transpose(2, 0, 1)


def held_to_imread(path):
    """Gray and colour: the decoder, `decode_batch` and the port's
    `load_image` equal cv2.imread of the file, and the JAX package's
    `load_image` (the same cv2.imread); the file must be one cv2 reads."""
    with open(path, "rb") as f:
        raw = f.read()
    for ch in (1, 3):
        want = imread(path, ch)
        assert want is not None, f"cv2.imread fails on channels {ch}"
        np.testing.assert_array_equal(nio.decode_jpeg(raw, ch), want,
                                      err_msg=f"channels {ch}")
        np.testing.assert_array_equal(nio.decode_batch([path], ch)[0], want)
        np.testing.assert_array_equal(uio.load_image(path, ch),
                                      jio.load_image(path, ch))


# ------------------------------------------------------------ the edits

def sos(raw, k=0):
    """Offset of the FF of the k-th SOS marker, and the offset of its
    scan's first entropy-coded byte."""
    at = -1
    for _ in range(k + 1):
        at = raw.index(b"\xff\xda", at + 1)
    return at, at + 2 + struct.unpack(">H", raw[at + 2:at + 4])[0]


def scan_params(raw, k, ss=None, se=None, ahal=None):
    """`raw` with the k-th SOS's Ss, Se or Ah/Al byte replaced."""
    at, data = sos(raw, k)
    b = bytearray(raw)
    for off, v in ((data - 3, ss), (data - 2, se), (data - 1, ahal)):
        if v is not None:
            b[off] = v
    return bytes(b)


def restarts(raw):
    """Offsets of the FF of every RSTn after the first SOS."""
    at = sos(raw)[1]
    return [i for i in range(at, len(raw) - 1)
            if raw[i] == 0xFF and 0xD0 <= raw[i + 1] <= 0xD7]


def wrong_restart(raw, step, k=None):
    """The k-th (by default the middle) RSTn of `raw` made RST(n + step),
    or another marker code where `step` is a string of one byte."""
    rst = restarts(raw)
    at = rst[len(rst) // 2 if k is None else k]
    b = bytearray(raw)
    b[at + 1] = step[0] if isinstance(step, bytes) else \
        0xD0 + ((b[at + 1] - 0xD0 + step) & 7)
    return bytes(b)


def without_scan(raw, k):
    """`raw` without its k-th scan (SOS header and data, up to the next
    marker segment's FF that is not an RSTn)."""
    at, data = sos(raw, k)
    end = data
    while not (raw[end] == 0xFF and raw[end + 1] not in (0, *range(0xD0,
                                                                   0xD8))):
        end += 1
    return raw[:at] + raw[end:]


def adobe_transform(raw, transform):
    """`raw` with its JFIF APP0 replaced by an Adobe APP14 of `transform`,
    or its Adobe transform byte set."""
    if raw[2:4] == b"\xff\xe0":
        end = 4 + struct.unpack(">H", raw[4:6])[0]
        seg = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + \
            bytes([transform])
        return raw[:2] + seg + raw[end:]
    at = raw.index(b"Adobe")
    return raw[:at + 11] + bytes([transform]) + raw[at + 12:]


def std_ac_codes():
    """The standard luminance AC table's code of each symbol (JPEG Annex K),
    as bit strings."""
    bits = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
    vals = [int(v, 16) for v in (
        "01 02 03 00 04 11 05 12 21 31 41 06 13 51 61 07 22 71 14 32 81 91 "
        "a1 08 23 42 b1 c1 15 52 d1 f0 24 33 62 72 82 09 0a 16 17 18 19 1a "
        "25 26 27 28 29 2a 34 35 36 37 38 39 3a 43 44 45 46 47 48 49 4a 53 "
        "54 55 56 57 58 59 5a 63 64 65 66 67 68 69 6a 73 74 75 76 77 78 79 "
        "7a 83 84 85 86 87 88 89 8a 92 93 94 95 96 97 98 99 9a a2 a3 a4 a5 "
        "a6 a7 a8 a9 aa b2 b3 b4 b5 b6 b7 b8 b9 ba c2 c3 c4 c5 c6 c7 c8 c9 "
        "ca d2 d3 d4 d5 d6 d7 d8 d9 da e1 e2 e3 e4 e5 e6 e7 e8 e9 ea f1 f2 "
        "f3 f4 f5 f6 f7 f8 f9 fa").split()]
    codes, code, k = {}, 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            codes[vals[k]] = format(code, f"0{length}b")
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def with_scan_bits(raw, bits):
    """`raw` (one scan) with its entropy-coded data replaced by `bits`,
    padded with 1s and byte-stuffed, then EOI."""
    data = sos(raw)[1]
    bits += "1" * (-len(bits) % 8)
    out = bytearray()
    for i in range(0, len(bits), 8):
        out.append(int(bits[i:i + 8], 2))
        if out[-1] == 0xFF:
            out.append(0)
    return raw[:data] + bytes(out) + b"\xff\xd9"


def ac_run_past_63():
    """A 16x16 gray file whose first block's AC codes run past coefficient
    63: three ZRLs (k = 49), then run 15 / size 1 (k = 64), which libjpeg
    writes into coefficient 63; the other blocks DC 0, EOB."""
    raw = encode(cv2.cvtColor(content(16, 16, 1), cv2.COLOR_BGR2GRAY),
                 sampling="444")
    ac = std_ac_codes()
    block0 = "00" + ac[0xF0] * 3 + ac[0xF1] + "1" + ac[0x00]
    return with_scan_bits(raw, block0 + ("00" + ac[0x00]) * 3)


def bad_huffman_code(raw):
    """`raw` with 16 one bits (FF 00 FF 00) at the start of its scan: no
    DC code of the standard tables, which libjpeg reads as 17 bits and
    symbol 0."""
    data = sos(raw)[1]
    return raw[:data] + b"\xff\x00\xff\x00" + raw[data:]


def cut_last_mcu_row(raw):
    """`raw` cut 60 bytes before its end, inside its last MCU row's data
    (16 lines at 4:2:0)."""
    return raw[:len(raw) - 60]


_IMG = content(61, 83, 5)
_BASE = encode(_IMG)
_BASE444 = encode(_IMG, sampling="444")
_GRAY = encode(cv2.cvtColor(_IMG, cv2.COLOR_BGR2GRAY))
_PROG = encode(_IMG, progressive=True)
_RST = encode(_IMG, restart=2)
_PROG_RST = encode(content(45, 70, 6), quality=60, progressive=True,
                   restart=1)

# case -> the damaged file, by warning family
CASES = {
    # 1. garbage before a marker (JWRN_EXTRANEOUS_DATA)
    "extraneous_before_eoi": lambda: _BASE[:-2] + b"\x5a\xa5\x3c" + _BASE[-2:],
    "extraneous_ff00_before_eoi": lambda: _BASE444[:-2] + b"\x00\xff\x00\x07"
    + _BASE444[-2:],
    "extraneous_between_segments": lambda: _GRAY[:20] + b"\x11\x22"
    + _GRAY[20:],
    "extraneous_between_scans": lambda: _PROG[:sos(_PROG, 3)[0]] + b"\xaa"
    + _PROG[sos(_PROG, 3)[0]:],
    "extraneous_arith": lambda: variant("arith_s420.jpg")[:-2] + b"\x01\x02"
    + variant("arith_s420.jpg")[-2:],
    # 2. data that end early (JWRN_JPEG_EOF, JWRN_HIT_MARKER)
    "no_eoi": lambda: _BASE[:-2],
    "no_eoi_progressive": lambda: _PROG[:-2],
    "cut_last_mcu_row": lambda: cut_last_mcu_row(_BASE),
    "cut_mid_scan_444": lambda: _BASE444[:len(_BASE444) * 2 // 3],
    "cut_gray": lambda: _GRAY[:len(_GRAY) * 3 // 4],
    "cut_restart_coded": lambda: _RST[:len(_RST) * 3 // 4],
    "cut_progressive": lambda: _PROG[:len(_PROG) * 2 // 3],
    "cut_progressive_restart": lambda: _PROG_RST[:len(_PROG_RST) * 3 // 5],
    "cut_arith": lambda: variant("arith_restart7.jpg")[:900],
    "cut_arith_progressive": lambda: variant("arith_progressive.jpg")[:1200],
    # 3. bad codes (JWRN_HUFF_BAD_CODE, JWRN_ARITH_BAD_CODE, and an AC run
    # past coefficient 63, which libjpeg does not warn about)
    "bad_huffman_code": lambda: bad_huffman_code(_BASE),
    "ac_run_past_63": ac_run_past_63,
    "flipped_byte_baseline": lambda: _BASE[:1000] + bytes([_BASE[1000] ^ 0x21])
    + _BASE[1001:],
    "flipped_byte_progressive": lambda: _PROG[:1500]
    + bytes([_PROG[1500] ^ 0x44]) + _PROG[1501:],
    "bad_arith_code": lambda: (lambda r: r[:700] + bytes([r[700] ^ 0x5A])
                               + r[701:])(variant("arith_s420.jpg")),
    # 4. a wrong restart marker (JWRN_MUST_RESYNC): one or two ahead of the
    # one due (left unread: an empty interval), one or two behind or
    # another marker below SOF0 (skipped to the next marker), farther
    # (swallowed), a non-RST marker (left unread), none
    "restart_one_ahead": lambda: wrong_restart(_RST, 1),
    "restart_two_ahead": lambda: wrong_restart(_RST, 2),
    "restart_one_behind": lambda: wrong_restart(_RST, -1),
    "restart_two_behind": lambda: wrong_restart(_RST, -2),
    "restart_far": lambda: wrong_restart(_RST, 4),
    "restart_below_sof0": lambda: wrong_restart(_RST, b"\x05"),
    "restart_replaced_by_dht": lambda: wrong_restart(_RST, b"\xc4"),
    "restart_missing": lambda: (lambda r, at: r[:at] + r[at + 2:])(
        _RST, restarts(_RST)[3]),
    "restart_progressive": lambda: wrong_restart(_PROG_RST, 3),
    "restart_arith": lambda: wrong_restart(variant("arith_restart7.jpg"), 1),
    # 5. scan parameters libjpeg warns about (JWRN_NOT_SEQUENTIAL,
    # JWRN_BOGUS_PROGRESSION)
    "not_sequential_spectral": lambda: scan_params(_BASE, 0, se=0x20),
    "not_sequential_approximation": lambda: scan_params(_BASE, 0, ahal=0x11),
    "bogus_progression_ah": lambda: scan_params(_PROG, 1, ahal=0x32),
    "bogus_progression_dc_refine": lambda: scan_params(_PROG, 6, ahal=0x21),
    "ac_scan_without_dc": lambda: without_scan(_PROG, 0),
    # 6. unfinished progressive images: block smoothing
    "progressive_without_last_scan": lambda: _PROG[:sos(_PROG, 9)[0]]
    + b"\xff\xd9",
    "arith_progressive_without_last_scan": lambda: (
        lambda r: r[:r.rindex(b"\xff\xda")] + b"\xff\xd9")(
            variant("arith_progressive.jpg")),
    # 7. an Adobe transform libjpeg does not know (JWRN_ADOBE_XFORM)
    "adobe_transform_3_components": lambda: adobe_transform(_BASE, 5),
    "adobe_transform_4_components": lambda: adobe_transform(
        variant("cmyk_adobe.jpg"), 7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_warned_family_reads_as_imread(tmp_path, case):
    path = str(tmp_path / f"{case}.jpg")
    with open(path, "wb") as f:
        f.write(CASES[case]())
    held_to_imread(path)


# Unfinished progressive images, cv2-written at several sizes (whole
# blocks or not, every sampling cv2 writes) and qualities, stopped after
# each scan of the progression: libjpeg-turbo smooths their blocks from
# the DC values of the 5x5 blocks around (estimating DC too where no AC
# coefficient of the first nine has data), with the coefficient states of
# before the last scan in rows past the last one decoded.
@pytest.mark.parametrize("h,w,sampling,quality", [
    (64, 96, "420", 90), (61, 83, "420", 50), (72, 40, "420", 95),
    (37, 29, "444", 75), (9, 130, "420", 30), (130, 9, "444", 60)])
def test_unfinished_progressive_reads_as_imread(tmp_path, h, w, sampling,
                                                quality):
    raw = encode(content(h, w, h * w), quality, sampling, progressive=True)
    n = raw.count(b"\xff\xda")
    for k in range(1, n):
        path = str(tmp_path / f"stop{k}.jpg")
        with open(path, "wb") as f:
            f.write(raw[:sos(raw, k)[0]] + b"\xff\xd9")
        held_to_imread(path)
    path = str(tmp_path / "cut.jpg")        # cut inside the last scan
    with open(path, "wb") as f:
        f.write(raw[:(sos(raw, n - 1)[1] + len(raw)) // 2])
    held_to_imread(path)


# ------------------------------------------------------- the seeded corpus

CORPUS = {
    "baseline_420": lambda: encode(content(64, 96, 0)),
    "baseline_444": lambda: encode(content(64, 96, 1), sampling="444"),
    "gray": lambda: encode(cv2.cvtColor(content(64, 96, 2),
                                        cv2.COLOR_BGR2GRAY)),
    "progressive": lambda: encode(content(64, 96, 3), progressive=True),
    "restart": lambda: encode(content(64, 96, 4), restart=2),
    "progressive_restart": lambda: encode(content(45, 70, 5), quality=60,
                                          progressive=True, restart=1),
    "arith_restart7": lambda: variant("arith_restart7.jpg"),
    "arith_progressive": lambda: variant("arith_progressive.jpg"),
}
CORPUS_FILES = 2000
# what the port still refuses by name where cv2 reads: nothing on these
# sources (a lossless component in no scan cannot arise from them)
REFUSED = {}


def damaged_corpus(raw, n, rng):
    """`n` damaged copies of `raw`: every third cut at 30-100% of its
    length, the rest with 1-3 bytes xor-ed anywhere past the SOI."""
    for t in range(n):
        b = bytearray(raw)
        if t % 3 == 0:
            yield bytes(b[:int(len(b) * rng.uniform(0.3, 1.0))])
            continue
        for _ in range(int(rng.integers(1, 4))):
            b[int(rng.integers(2, len(b)))] ^= int(rng.integers(1, 256))
        yield bytes(b)


@pytest.mark.parametrize("source", sorted(CORPUS))
def test_seeded_corpus_reads_as_imread(tmp_path, source):
    """CORPUS_FILES files over the sources, from default_rng(0) (each
    source its own stream): where cv2.imread reads a file the port gives
    exactly its planes, where it fails the port raises ValueError; the
    counts of both, and of named refusals, are asserted."""
    rng = np.random.default_rng([0, sorted(CORPUS).index(source)])
    counts = {"read": 0, "both_fail": 0}
    refused = {}
    path = str(tmp_path / "damaged.jpg")
    n = CORPUS_FILES // len(CORPUS)
    for raw in damaged_corpus(CORPUS[source](), n, rng):
        with open(path, "wb") as f:
            f.write(raw)
        for ch in (1, 3):
            want = imread(path, ch)
            try:
                got = nio.decode_jpeg(raw, ch)
            except ValueError as e:
                if want is None:
                    counts["both_fail"] += 1
                else:
                    refused[str(e)] = refused.get(str(e), 0) + 1
                continue
            assert want is not None, "the port reads a file cv2 fails on"
            np.testing.assert_array_equal(got, want)
            counts["read"] += 1
    assert refused == REFUSED
    assert counts["read"] + counts["both_fail"] == 2 * n
    assert counts["read"] >= n, counts   # most damaged files still read


# ---------------------------------------------- pipeline and CLI vs JAX

H, W = 96, 128


def write_damaged_frames(frame_dir, n, dx, dy, seed=0):
    """Colour frames translating by (dx, dy) px a frame, cv2-written 4:2:0
    quality 90 (restart interval 2 for every third), then damaged in turn:
    3 bytes before EOI, EOI dropped, cut inside the last MCU row, a wrong
    restart marker, none."""
    os.makedirs(frame_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur((rng.random((140, 180, 3)) * 255).astype(
        np.float32), (9, 9), 2.5)
    damages = [lambda r: r[:-2] + b"\x5a\xa5\x3c" + r[-2:],
               lambda r: r[:-2],
               cut_last_mcu_row,
               lambda r: wrong_restart(r, 1),
               lambda r: r]
    for t in range(n):
        m = np.float32([[1, 0, dx * t], [0, 1, dy * t]])
        f = cv2.warpAffine(big, m, (180, 140))[20:20 + H, 20:20 + W]
        raw = encode(np.clip(f, 0, 255).astype(np.uint8),
                     restart=2 if t % 5 == 3 else 0)
        with open(os.path.join(frame_dir, f"frame_{t:04d}.jpg"), "wb") as fh:
            fh.write(damages[t % 5](raw))
    return str(frame_dir)


@pytest.mark.parametrize("mode", ["run_OF_INT", "run_OF_RGB"])
def test_damaged_pipeline_matches_jax(tmp_path, mode):
    """Five damaged frames (four pairs, batch 2) through both pipelines:
    the JAX package's reads them with cv2.imread; before the port read
    them, its producer thread raised on the first."""
    frame_dir = write_damaged_frames(tmp_path / "frames", 5, 1.5, 0.5)
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pipeline.run_pipeline(frame_dir, jax_out, op_point=1, batch=2,
                              mode=mode, verbose=False)
    n = pipeline.run_pipeline(frame_dir, out, op_point=1, batch=2, mode=mode,
                              verbose=False, device="cpu")
    assert n == 4
    assert assert_files_match_jax(out, jax_out) == [
        f"frame_{t:04d}.flo" for t in range(4)]


def test_damaged_cli_matches_jax(tmp_path):
    """The CLI on a pair cut short and with a wrong restart marker."""
    frame_dir = write_damaged_frames(tmp_path / "frames", 4, 1.5, 0.5,
                                     seed=1)
    a, b = (os.path.join(frame_dir, f"frame_{t:04d}.jpg") for t in (2, 3))
    ours, ref = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    cli.main(["run_OF_INT", a, b, ours, "2", "--quiet", "--device", "cpu"])
    jcli.main(["run_OF_INT", a, b, ref, "2", "--quiet"])
    got, want = uio.read_flo(ours), jio.read_flo(ref)
    assert got.shape == want.shape == (H, W, 2)
    epe = np.linalg.norm(got - want, axis=-1).mean() \
        / np.linalg.norm(want, axis=-1).mean()
    assert epe <= EPE_RATIO
