"""The port's WebP decoder (`csrc/webp.cpp` behind `utils.io.webp_chunks`,
`native.io.decode_batch` and `utils.io.load_image`) against cv2.imread,
pixel for pixel, and the WebP serving pipeline and CLI against the JAX
package's.

Files come from cv2 and PIL (lossy VP8, lossless VP8L, alpha, EXIF,
methods 0-6), from the container writers of
tests/torch_fixtures/webp/make_fixtures.py (animations, crafted chunk
orders) and from its `Vp8Stream` rewriter (the simple loop filter,
sharpness and loop-filter deltas, token partitions: bitstreams no encoder
here writes). Every case holds the decoder's gray and colour planes equal
to cv2.imread's (IMREAD_GRAYSCALE: OpenCV's cvtColor BGR2GRAY of the BGR
pixels; IMREAD_COLOR: libwebp's BGR, alpha dropped, frame 0 of an
animation, the EXIF orientation applied) and the port's `load_image`
equal to the JAX package's (cv2 under it). Tolerance 0: libwebp's decode
is integer arithmetic. Corrupt input either raises ValueError naming the
cause or decodes exactly as cv2 does.
"""

import hashlib
import importlib.util
import json
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pytest.importorskip("PIL")
from hypothesis import given, settings, strategies as st  # noqa: E402

from of_dis_tpu import cli as jcli  # noqa: E402
from of_dis_tpu import pipeline as jax_pipeline  # noqa: E402
from of_dis_tpu.utils import io as jio  # noqa: E402
from of_dis_tpu_torch import cli, pipeline  # noqa: E402
from of_dis_tpu_torch.kernels import build  # noqa: E402
from of_dis_tpu_torch.models import dis  # noqa: E402
from of_dis_tpu_torch.native import io as nio  # noqa: E402
from of_dis_tpu_torch.ops import pyramid  # noqa: E402
from of_dis_tpu_torch.params import (op_point_params,  # noqa: E402
                                     pad_amounts)
from of_dis_tpu_torch.utils import io as uio  # noqa: E402
from of_dis_tpu_torch.utils import viz  # noqa: E402
from tests.test_torch_pipeline import assert_files_match_jax  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures", "webp")
_spec = importlib.util.spec_from_file_location(
    "webp_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
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


def cv2_planes(path_or_raw, channels):
    flag = cv2.IMREAD_GRAYSCALE if channels == 1 else cv2.IMREAD_COLOR
    if isinstance(path_or_raw, (bytes, bytearray)):
        img = cv2.imdecode(np.frombuffer(path_or_raw, np.uint8), flag)
    else:
        img = cv2.imread(path_or_raw, flag)
    if img is None:
        return None
    return img[None] if img.ndim == 2 else img.transpose(2, 0, 1)


def write(tmp_path, name, raw):
    p = str(tmp_path / name)
    with open(p, "wb") as f:
        f.write(raw)
    return p


def assert_as_cv2(path):
    """Gray and colour: `decode_image`, `decode_batch` and the port's
    `load_image` equal cv2.imread, and the JAX package's `load_image`."""
    raw = open(path, "rb").read()
    for ch in (1, 3):
        want = cv2_planes(path, ch)
        assert want is not None, (path, ch)
        got = nio.decode_image(raw, ch)
        assert got.shape == want.shape, (ch, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"channels {ch}")
        np.testing.assert_array_equal(nio.decode_batch([path], ch)[0], want)
        ours = uio.load_image(path, ch)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, jio.load_image(path, ch))


def assert_raw_as_cv2(raw):
    for ch in (1, 3):
        want = cv2_planes(raw, ch)
        assert want is not None, ch
        np.testing.assert_array_equal(nio.decode_image(raw, ch), want)


def content(h, w, kind, seed=0, channels=3):
    """(h, w, channels) uint8: "blur" smooth content, "noise" uniform
    noise, "sat" blocks of 0 / 255 per channel."""
    rng = np.random.default_rng(seed)
    if kind == "blur":
        return mf.blurred(h, w, channels, seed)
    if kind == "sat":
        cells = rng.integers(0, 2, (h // 4 + 1, w // 4 + 1, channels)) * 255
        return np.repeat(np.repeat(cells, 4, 0), 4, 1)[:h, :w].astype(
            np.uint8)
    return rng.integers(0, 256, (h, w, channels), dtype=np.uint8)


# ------------------------------------------------------------- lossy, VP8

# (height, width, content, quality, encoder, method)
CASES = (
    [(h, w, kind, 90, "cv2", None) for (h, w) in ((1, 1), (2, 3), (9, 13),
                                                   (16, 16), (17, 33))
     for kind in ("blur", "sat")]
    + [(61, 83, kind, q, "cv2", None) for q in (1, 30, 75, 100)
       for kind in ("blur", "noise")]
    + [(45, 70, "blur", 75, "pil", m) for m in range(7)]
    + [(45, 70, "noise", q, "pil", 6) for q in (0, 100)]
    + [(437, 1023, "blur", 90, "cv2", None),
       (436, 1024, "noise", 50, "pil", 4)])


def encode(img, quality, encoder="cv2", method=None, **kw):
    if encoder == "cv2":
        return mf.cv2_webp(img, quality)
    extra = {} if method is None else {"method": method}
    return mf.pil_webp(np.ascontiguousarray(img[..., ::-1]),
                       quality=quality, **extra, **kw)


@pytest.mark.parametrize("h,w,kind,quality,encoder,method", CASES)
def test_lossy_equals_cv2(tmp_path, h, w, kind, quality, encoder, method):
    img = content(h, w, kind, seed=h * w + quality)
    raw = encode(img, quality, encoder, method)
    assert raw[12:16] == b"VP8 "
    assert_as_cv2(write(tmp_path, "f.webp", raw))


# ---------------------------------------------------------- lossless, VP8L

@pytest.mark.parametrize("h,w,kind,method,quality", [
    (1, 1, "blur", 4, 75), (9, 13, "noise", 4, 75), (33, 17, "sat", 0, 0),
    (61, 83, "blur", 0, 0), (61, 83, "blur", 6, 100), (61, 83, "noise", 3, 50),
    (61, 83, "sat", 6, 100), (45, 300, "blur", 5, 90)])
def test_lossless_equals_cv2(tmp_path, h, w, kind, method, quality):
    img = content(h, w, kind, seed=h + w + method)
    raw = mf.pil_webp(img, lossless=True, method=method, quality=quality)
    assert raw[12:16] == b"VP8L"
    assert_as_cv2(write(tmp_path, "f.webp", raw))


@pytest.mark.parametrize("levels", [2, 3, 4, 11, 16, 17, 200, 256])
def test_palette_and_pixel_bundling(tmp_path, levels):
    """Gray images of few levels: colour indexing with 8, 4, 2 and 1
    pixels a byte (RFC 9649 section 4.4)."""
    rng = np.random.default_rng(levels)
    g = (rng.integers(0, levels, (29, 37)) * (255 // max(levels - 1, 1))
         ).astype(np.uint8)
    raw = mf.pil_webp(g, lossless=True)
    assert_as_cv2(write(tmp_path, "g.webp", raw))


def test_lossless_of_cv2_gray_and_colour(tmp_path):
    g = content(61, 83, "blur", 5, channels=1)[..., 0]
    assert_as_cv2(write(tmp_path, "g.webp", mf.cv2_webp(g, 101)))
    assert_as_cv2(write(tmp_path, "c.webp", mf.cv2_webp(
        content(61, 83, "noise", 6), 101)))


# ------------------------------------------------------ alpha, EXIF, VP8X

@pytest.mark.parametrize("kw", [dict(quality=80), dict(quality=30,
                                                       alpha_quality=20),
                                dict(lossless=True),
                                dict(lossless=True, exact=True)])
def test_alpha_is_dropped(tmp_path, kw):
    """RGBA: cv::imread's BGR is the decoded colour, not premultiplied,
    whatever the alpha (0 included, kept by `exact`)."""
    rgba = np.concatenate([content(37, 53, "blur", 1),
                           content(37, 53, "noise", 2, channels=1)], 2)
    rgba[:9, :9, 3] = 0
    raw = mf.pil_webp(rgba, **kw)
    if not kw.get("lossless"):
        assert b"ALPH" in raw
    assert_as_cv2(write(tmp_path, "a.webp", raw))


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("lossless", [False, True])
def test_exif_orientation(tmp_path, orientation, lossless):
    img = np.ascontiguousarray(content(20, 30, "blur", 3)[..., ::-1])
    kw = dict(lossless=True) if lossless else dict(quality=90)
    raw = mf.pil_webp(img, exif=mf.exif(orientation), **kw)
    p = write(tmp_path, "o.webp", raw)
    info = uio.webp_chunks(raw)
    assert info.orientation == orientation
    assert (info.height, info.width) == ((30, 20) if orientation >= 5
                                         else (20, 30))
    assert_as_cv2(p)


def _still(img=None, quality=90):
    raw = mf.cv2_webp(content(14, 22, "blur", 4) if img is None else img,
                      quality)
    return mf.image_chunks(raw)


@pytest.mark.parametrize("name,chunks,orientation", [
    ("prefix_ignored", lambda s: [mf.vp8x(0x08, 22, 14), s, mf.chunk(
        b"EXIF", b"Exif\0\0" + mf.exif(6))], 1),
    ("no_flag_ignored", lambda s: [mf.vp8x(0, 22, 14), s,
                                   mf.chunk(b"EXIF", mf.exif(6))], 1),
    ("before_image", lambda s: [mf.vp8x(0x08, 22, 14),
                                mf.chunk(b"EXIF", mf.exif(8)), s], 8),
    ("first_wins", lambda s: [mf.vp8x(0x08, 22, 14), s,
                              mf.chunk(b"EXIF", mf.exif(3)),
                              mf.chunk(b"EXIF", mf.exif(6))], 3),
    ("unreadable_ignored", lambda s: [mf.vp8x(0x08, 22, 14), s,
                                      mf.chunk(b"EXIF", b"II*\0garbage")], 1),
    ("big_endian", lambda s: [mf.vp8x(0x08, 22, 14), s, mf.chunk(
        b"EXIF", b"MM\0*" + struct.pack(">IHHHIHH", 8, 1, 0x0112, 3, 1, 5,
                                        0) + b"\0" * 4)], 5),
    ("unknown_chunks", lambda s: [mf.vp8x(0x20, 22, 14),
                                  mf.chunk(b"ICCP", b"icc"),
                                  mf.chunk(b"ABCD", b"xyz"), s,
                                  mf.chunk(b"XMP ", b"<x/>")], 1),
    ("alpha_flag_no_alph", lambda s: [mf.vp8x(0x10, 22, 14), s], 1),
    # an EXIF chunk cut short: libwebp's demuxer, through which OpenCV
    # reads EXIF, fails; the image is still decoded, not turned
    ("exif_cut_short_ignored", lambda s: [
        mf.vp8x(0x08, 22, 14), s,
        b"EXIF" + struct.pack("<I", 4096) + mf.exif(6)], 1),
])
def test_extended_container_as_opencv_reads_it(tmp_path, name, chunks,
                                               orientation):
    raw = mf.riff(chunks(_still()))
    assert uio.webp_chunks(raw).orientation == orientation
    assert_as_cv2(write(tmp_path, f"{name}.webp", raw))


def test_simple_file_with_trailing_chunks(tmp_path):
    """A simple file's decoder sees every byte after its VP8 chunk, as
    libwebp's does; an EXIF chunk there is not honoured (no VP8X)."""
    raw = mf.riff([_still(), mf.chunk(b"EXIF", mf.exif(6))])
    assert uio.webp_chunks(raw).orientation == 1
    assert_as_cv2(write(tmp_path, "t.webp", raw))


# --------------------------------------------------------- animation

def _frame(h, w, lossless=False, alpha=False, seed=0):
    img = np.ascontiguousarray(content(h, w, "blur", seed)[..., ::-1])
    if alpha:
        a = content(h, w, "noise", seed + 1, channels=1)
        a[: h // 3] = 0
        img = np.concatenate([img, a], 2)
    kw = dict(lossless=True, exact=True) if lossless else dict(quality=80)
    return mf.image_chunks(mf.pil_webp(img, **kw))


@pytest.mark.parametrize("x,y,lossless,alpha,flags", [
    (0, 0, False, False, 0), (6, 4, False, False, 0),
    (10, 12, True, False, 2), (2, 0, False, True, 0),
    (4, 8, True, True, 2), (4, 8, True, True, 1)])
def test_animation_frame0_on_a_canvas_of_zeros(tmp_path, x, y, lossless,
                                               alpha, flags):
    """WebPAnimDecoder's first frame: its rectangle at its offset, alpha
    and blending ignored, zeros elsewhere; later frames unread."""
    raw = mf.riff([mf.vp8x(0x12 if alpha else 0x02, 48, 36),
                   mf.chunk(b"ANIM", struct.pack("<IH", 0xFF204080, 3)),
                   mf.anmf(x, y, 30, 20, _frame(20, 30, lossless, alpha),
                           flags=flags),
                   mf.anmf(0, 0, 48, 36, _frame(36, 48, seed=5))])
    info = uio.webp_chunks(raw)
    assert (info.x0, info.y0, info.width, info.height) == (x, y, 48, 36)
    assert_as_cv2(write(tmp_path, "anim.webp", raw))
    got = nio.decode_image(raw, 3)
    assert not got[:, :y].any() and not got[:, :, :x].any()


@pytest.mark.parametrize("orientation", [3, 6, 8])
def test_animation_exif_orientation(tmp_path, orientation):
    """cv::imread turns an animation's frame 0 by its EXIF orientation
    too (where the VP8X EXIF flag is set)."""
    raw = mf.riff([mf.vp8x(0x0A, 30, 20), mf.chunk(b"ANIM", bytes(6)),
                   mf.anmf(2, 4, 22, 14, _still()),
                   mf.chunk(b"EXIF", mf.exif(orientation))])
    info = uio.webp_chunks(raw)
    assert (info.width, info.height) == ((20, 30) if orientation >= 5
                                         else (30, 20))
    assert_as_cv2(write(tmp_path, "anim.webp", raw))


# ----------------------------------------------------- manifest, fixtures

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def _sha(planes):
    return hashlib.sha256(np.ascontiguousarray(planes).tobytes()).hexdigest()


@pytest.mark.parametrize("rel", sorted(MANIFEST["files"]))
def test_fixture_manifest_matches_cv2_and_the_decoder(rel):
    """The hashes that chip_smoke.py part 7d holds the card's build to are
    cv2's (live here) and the port's; the port's `load_image` is the JAX
    package's."""
    path = os.path.join(FIXTURES, rel)
    rec = MANIFEST["files"][rel]
    assert os.path.getsize(path) == rec["bytes"]
    for key, ch in (("gray", 1), ("color", 3)):
        for planes in (cv2_planes(path, ch), nio.decode_batch([path], ch)[0],
                       uio.load_image(path, ch).astype(np.uint8)):
            assert list(planes.shape) == rec[key]["shape"]
            assert _sha(planes) == rec[key]["sha256"], (rel, key)
        np.testing.assert_array_equal(uio.load_image(path, ch),
                                      jio.load_image(path, ch))


def test_fixtures_stay_small_and_frames_move():
    total = sum(os.path.getsize(os.path.join(d, n))
                for d, _, names in os.walk(FIXTURES) for n in names)
    assert total < 5 << 19
    frames = sorted(r for r in MANIFEST["files"] if r.startswith("frames/"))
    assert len(frames) == 9
    assert MANIFEST["motion_px"] == [1.3, 0.4]
    for r in frames + [r for r in MANIFEST["files"]
                       if r.startswith("lossless/")]:
        assert MANIFEST["files"][r]["gray"]["shape"] == [1, 436, 1024]


def test_rewritten_streams_are_what_they_claim():
    """The rewriter replays a cv2 file exactly; its simple-filter and
    sharpness / delta files differ from the source (the filter changed),
    its partitioned files do not (the tokens only moved), and each
    declares what its name says."""
    src = mf.cv2_webp(mf.blurred(64, 96, 3, 3), 60)
    stream = mf.Vp8Stream(mf.vp8_payload(src))
    assert stream.filter["level"] > 0 and not stream.filter["simple"]
    same = mf.riff([mf.chunk(b"VP8 ", stream.write())])
    base = cv2_planes(src, 3)
    np.testing.assert_array_equal(cv2_planes(same, 3), base)
    for name, changed in (("filter_simple", True),
                          ("filter_sharpness5_deltas", True),
                          ("partitions2", False), ("partitions8", False)):
        with open(os.path.join(FIXTURES, "variants", f"{name}.webp"),
                  "rb") as f:
            raw = f.read()
        assert (cv2_planes(raw, 3) != base).any() == changed, name
        parsed = mf.Vp8Stream(mf.vp8_payload(raw))
        if name == "filter_simple":
            assert parsed.filter["simple"] == 1
        if name.startswith("partitions"):
            assert len(parsed.tokens) == stream.mb_h
        assert_raw_as_cv2(raw)


# ------------------------------------------------------------- hypothesis

@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 70), w=st.integers(1, 90),
       quality=st.integers(0, 101), seed=st.integers(0, 1000))
def test_any_size_and_quality_equals_cv2(h, w, quality, seed):
    img = content(h, w, ("blur", "noise", "sat")[seed % 3], seed)
    raw = mf.cv2_webp(img, max(quality, 1)) if seed % 2 else mf.pil_webp(
        np.ascontiguousarray(img[..., ::-1]), quality=min(quality, 100),
        lossless=quality == 101)
    assert_raw_as_cv2(raw)


def _fuzz_sources():
    small = content(23, 37, "blur", 20)
    rgba = np.concatenate([small[..., ::-1], content(23, 37, "noise", 21,
                                                     channels=1)], 2)
    return [mf.cv2_webp(small, 60),
            mf.pil_webp(np.ascontiguousarray(rgba), quality=70),
            mf.pil_webp(content(23, 37, "noise", 22), lossless=True,
                        method=6),
            mf.pil_webp(content(23, 37, "blur", 23, channels=1)[..., 0] // 16
                        * 16, lossless=True),
            mf.riff([mf.vp8x(0x08, 37, 23), mf.image_chunks(
                mf.cv2_webp(small, 40)), mf.chunk(b"EXIF", mf.exif(6))]),
            mf.riff([mf.chunk(b"VP8 ", mf.Vp8Stream(mf.vp8_payload(
                mf.cv2_webp(small, 80))).write(partitions=4,
                                              simple=True))])]


_FUZZ_SOURCES = _fuzz_sources()


@settings(max_examples=300, deadline=None, derandomize=True,
          database=None)
@given(src=st.integers(0, len(_FUZZ_SOURCES) - 1),
       cut=st.one_of(st.none(), st.floats(0.0, 1.0)),
       flips=st.lists(st.tuples(st.floats(0.0, 1.0), st.integers(1, 255)),
                      max_size=3))
def test_corrupt_input_raises_or_equals_cv2(src, cut, flips):
    """Truncated and byte-flipped files: the decoder raises ValueError or
    gives exactly cv2's planes, never anything else and never a crash."""
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
        want = cv2_planes(raw, ch)
        assert want is not None
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ refusals

def _patch(raw, at, value):
    b = bytearray(raw)
    b[at:at + len(value)] = value
    return bytes(b)


_LOSSY = mf.cv2_webp(content(14, 22, "blur", 7), 90)
_LOSSLESS = mf.cv2_webp(content(14, 22, "blur", 8), 101)
_LOSSLESS_1X1 = mf.cv2_webp(content(1, 1, "blur", 9), 101)


@pytest.mark.parametrize("make,match", [
    (lambda: _LOSSY[:31], "cv::imread reads 32 at least"),
    (lambda: _patch(_LOSSY, 4, struct.pack("<I", len(_LOSSY))),
     "shorter than its RIFF size"),
    (lambda: _patch(_LOSSY, 23, b"\x9d\x01\x2b"), "no start code"),
    (lambda: _patch(_LOSSY, 20, bytes([_LOSSY[20] | 1])), "not a key frame"),
    (lambda: _patch(_LOSSLESS, 24, bytes([_LOSSLESS[24] | 0x20])),
     "VP8L header"),
    (lambda: mf.riff([mf.vp8x(0, 23, 14), _still()]), "canvas 23x14"),
    (lambda: mf.riff([mf.chunk(b"XXXX", b"1234"), _still()]),
     "where VP8 / VP8L / VP8X"),
    (lambda: mf.riff([mf.vp8x(0x02, 30, 20), mf.chunk(
        b"ANIM", bytes(6)), mf.anmf(20, 10, 22, 14, _still())]),
     "does not fit its canvas"),
    (lambda: mf.riff([mf.vp8x(0x02, 30, 20), mf.anmf(0, 0, 22, 14,
                                                      _still())]),
     "no ANIM before ANMF"),
    (lambda: mf.riff([mf.vp8x(0x10, 22, 14), mf.chunk(b"ALPH", b"\x03xx"),
                      _still()]), "ALPH"),
    (lambda: mf.riff([mf.vp8x(0x10, 22, 14), mf.chunk(
        b"ALPH", b"\x00" + bytes(100)), _still()]), "ALPH"),
])
def test_unsupported_or_corrupt_raises_naming_the_cause(tmp_path, make,
                                                        match):
    """Each refusal is one cv2.imread fails on too (it returns None)."""
    raw = make()
    p = write(tmp_path, "bad.webp", raw)
    for ch in (1, 3):
        with pytest.raises(ValueError, match=match):
            nio.decode_image(raw, ch)
        assert cv2_planes(p, ch) is None
    with pytest.raises(ValueError, match=match):
        uio.load_image(p, 1)


@pytest.mark.parametrize("w,h", [(65536, 65535), (32768, 32769),
                                 (1 << 20 | 1, 1)])
def test_canvas_larger_than_cv2_reads_is_refused(tmp_path, w, h):
    """A ~100-byte animation of one 1x1 frame on a canvas above 2^30
    pixels or 2^20 a side: cv::imread fails on it from the header (its
    size check raises), and the port refuses it before it allocates the
    canvas."""
    raw = mf.riff([mf.vp8x(0x02, w, h), mf.chunk(b"ANIM", bytes(6)),
                   mf.anmf(0, 0, 1, 1, mf.image_chunks(_LOSSLESS_1X1))])
    assert len(raw) < 128
    p = write(tmp_path, "big.webp", raw)
    for ch in (1, 3):
        with pytest.raises(ValueError, match="above cv::imread's limits"):
            nio.decode_image(raw, ch)
        with pytest.raises(cv2.error, match="CV_IO_MAX_IMAGE"):
            cv2.imread(p, cv2.IMREAD_GRAYSCALE if ch == 1
                       else cv2.IMREAD_COLOR)
    with pytest.raises(ValueError, match="above cv::imread's limits"):
        uio.load_image(p, 1)


def test_a_webp_library_that_does_not_build_raises(monkeypatch, tmp_path):
    """No fallback to cv2 or PIL: a decoder that cannot be built is an
    error, not a silent change of decoder."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "webp.cpp").write_text("this is not C++\n")
    for name in ("io_native.cpp", "orient.h"):
        (src / name).write_bytes((build.SRC_DIR / name).read_bytes())
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_host_libs", {})
    p = os.path.join(FIXTURES, "variants", "q50.webp")
    with pytest.raises(RuntimeError, match="building webp failed"):
        nio.decode_batch([p], 1)
    with pytest.raises(RuntimeError, match="building webp failed"):
        uio.load_image(p, 1)


# ---------------------------------------------- batches, pipeline, CLI

H, W = 96, 128


def _shift_frames(n, dx, dy, seed=0):
    """(h, w, 3) BGR frames whose content translates by (dx, dy) px a
    frame."""
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur((rng.random((140, 180, 3)) * 255).astype(
        np.float32), (9, 9), 2.5)
    out = []
    for t in range(n):
        m = np.float32([[1, 0, dx * t], [0, 1, dy * t]])
        out.append(np.clip(cv2.warpAffine(big, m, (180, 140))[
            20:20 + H, 20:20 + W], 0, 255).astype(np.uint8))
    return out


def write_webp_frames(frame_dir, frames, quality):
    os.makedirs(frame_dir, exist_ok=True)
    for t, f in enumerate(frames):
        with open(os.path.join(frame_dir, f"frame_{t:04d}.webp"),
                  "wb") as fh:
            fh.write(mf.cv2_webp(f, quality))
    return str(frame_dir)


def test_mixed_format_batch_on_a_pool(tmp_path):
    """WebP (lossy, lossless, extended), JPEG and PNG frames of one size
    in one batch, through a thread pool, equal cv2 frame by frame."""
    frames = _shift_frames(5, 1.0, 0.0, seed=3)
    paths = [write(tmp_path, "a.webp", mf.cv2_webp(frames[0], 90)),
             write(tmp_path, "b.webp", mf.cv2_webp(frames[1], 101)),
             write(tmp_path, "c.webp", mf.riff([mf.vp8x(0x20, W, H),
                                                mf.chunk(b"ICCP", b"icc"),
                                                _still(frames[2])])),
             write(tmp_path, "d.jpg", cv2.imencode(".jpg", frames[3])[1]
                   .tobytes())]
    p = str(tmp_path / "e.png")
    viz.write_png(p, frames[4][..., ::-1])
    paths.append(p)
    for ch in (1, 3):
        want = np.stack([cv2_planes(q, ch) for q in paths])
        with ThreadPoolExecutor(4) as pool:
            np.testing.assert_array_equal(
                nio.decode_batch(paths, ch, pool=pool), want)


@pytest.mark.parametrize("quality", [90, 101])
def test_webp_pipeline_matches_jax_and_dis_flow_batched(tmp_path, quality):
    """Four WebP frames (three pairs, batch 2, gray flow) through the
    port's pipeline: every file 0.0 px from `dis_flow_batched` on the
    decoded planes; and within the port-vs-JAX budget of the JAX pipeline
    on the same planes as gray PNGs (its pipeline lists no WebP; its
    `load_image` reads WebP through cv2, the CLI test below)."""
    frames = _shift_frames(4, 1.5, 0.5, seed=quality)
    frame_dir = write_webp_frames(tmp_path / "webp", frames, quality)
    paths = pipeline.list_frames(frame_dir)
    assert len(paths) == 4 and paths[0].endswith(".webp")
    png_dir = tmp_path / "png"
    os.makedirs(png_dir)
    for p in paths:
        gray = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        viz.write_png(str(png_dir / (os.path.basename(p)[:-5] + ".png")),
                      np.repeat(gray[..., None], 3, 2))
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pipeline.run_pipeline(str(png_dir), jax_out, op_point=2, batch=2,
                              mode="run_OF_INT", verbose=False)
    n = pipeline.run_pipeline(frame_dir, out, op_point=2, batch=2,
                              mode="run_OF_INT", verbose=False,
                              device="cpu")
    assert n == 3
    names = assert_files_match_jax(out, jax_out)
    params = op_point_params(W, 2, nop=2, noc=1)
    x = pyramid.pad_to_divisible(torch.as_tensor(nio.decode_batch(paths, 1)),
                                 params.sc_f)
    top, _, left, _ = pad_amounts(W, H, params.sc_f)
    want = dis.dis_flow_batched(x[:-1], x[1:], params, x.shape[-1],
                                x.shape[-2], device="cpu")
    want = want[:, top:top + H, left:left + W]
    for k, name in enumerate(names):
        got = uio.read_flo(os.path.join(out, name))
        np.testing.assert_array_equal(got, want[k].numpy())
        med = np.median(got[16:-16, 16:-16].reshape(-1, 2), axis=0)
        assert abs(med[0] - 1.5) < 0.4 and abs(med[1] - 0.5) < 0.4


@pytest.mark.parametrize("mode,quality", [("run_OF_INT", 90),
                                          ("run_OF_RGB", 101)])
def test_webp_cli_matches_jax(tmp_path, mode, quality):
    """The port's CLI and the JAX package's (whose `load_image` reads the
    WebP files through cv2) on the same two files."""
    frames = _shift_frames(2, 1.5, 0.5, seed=7)
    frame_dir = write_webp_frames(tmp_path / "frames", frames, quality)
    a, b = (os.path.join(frame_dir, f"frame_{t:04d}.webp") for t in (0, 1))
    ours, ref = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    cli.main([mode, a, b, ours, "2", "--quiet", "--device", "cpu"])
    jcli.main([mode, a, b, ref, "2", "--quiet"])
    got, want = uio.read_flo(ours), jio.read_flo(ref)
    assert got.shape == want.shape == (H, W, 2)
    epe = np.linalg.norm(got - want, axis=-1).mean() \
        / np.linalg.norm(want, axis=-1).mean()
    assert epe <= EPE_RATIO
