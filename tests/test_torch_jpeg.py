"""The port's JPEG decoder (`csrc/jpeg.cpp`, through `native.io.decode_jpeg`,
`decode_batch` and `utils.io.load_image`) against cv2.imread, pixel for
pixel, and the JPEG serving pipeline and CLI against the JAX package's.

Every case writes its file with cv2 (or patches a cv2-written file) and
holds the decoder's gray and colour planes equal to cv2.imread's
(IMREAD_GRAYSCALE: the decoded Y plane; IMREAD_COLOR: BGR; the EXIF
orientation applied), and the port's `load_image` equal to the JAX
package's (cv2 under it). Tolerance 0: libjpeg-turbo's integer decode is
deterministic. The pipeline and CLI runs are held at the port-vs-JAX
budget of tests/test_torch_pipeline.py (EPE ratio 1e-3). Damaged input
decodes exactly as cv2.imread decodes the file, or raises ValueError naming
the cause where cv2 fails on it.
"""

import hashlib
import json
import os
import struct
import tempfile

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
from of_dis_tpu_torch.utils import viz  # noqa: E402
from tests.test_torch_pipeline import assert_files_match_jax  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures", "jpeg")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
EPE_RATIO = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as the other pipeline test files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def content(h, w, kind, seed=0):
    """(h, w, 3) uint8 BGR: "blur" smooth mid-range colour, "sat" blocks of
    0 / 255 per channel (where BGR2GRAY of the colour decode parts from
    the Y plane), "noise" uniform noise."""
    rng = np.random.default_rng(seed)
    if kind == "blur":
        img = cv2.GaussianBlur((rng.random((h, w, 3)) * 255).astype(
            np.float32), (0, 0), 3.0)
        lo, hi = img.min(), img.max()
        return ((img - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)
    if kind == "sat":
        cells = rng.integers(0, 2, (h // 4 + 1, w // 4 + 1, 3)) * 255
        return np.repeat(np.repeat(cells, 4, 0), 4, 1)[:h, :w].astype(
            np.uint8)
    return (rng.random((h, w, 3)) * 255).astype(np.uint8)


def encode(img, quality=90, sampling="420", progressive=False, restart=0):
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    return buf.tobytes()


def segment(code, payload):
    return bytes([0xFF, code]) + struct.pack(">H", len(payload) + 2) + payload


def segments(raw):
    """(code, start, end) of each marker segment up to the first SOS, and
    the offset of the SOS."""
    out, pos = [], 2
    while raw[pos + 1] != 0xDA:
        end = pos + 2 + struct.unpack(">H", raw[pos + 2:pos + 4])[0]
        out.append((raw[pos + 1], pos, end))
        pos = end
    return out, pos


def exif(orientation, big_endian=False):
    e = ">" if big_endian else "<"
    tiff = ((b"MM\x00\x2a" if big_endian else b"II\x2a\x00")
            + struct.pack(e + "I", 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + b"\0\0\0\0")
    return segment(0xE1, b"Exif\0\0" + tiff)


def after_app0(raw, insert, drop_app0=False):
    segs, _ = segments(raw)
    code, start, end = segs[0]
    assert code == 0xE0
    return raw[:2] + (b"" if drop_app0 else raw[start:end]) + insert \
        + raw[end:]


def cv2_planes(path_or_raw, channels):
    flag = cv2.IMREAD_GRAYSCALE if channels == 1 else cv2.IMREAD_COLOR
    if isinstance(path_or_raw, (bytes, bytearray)):
        img = cv2.imdecode(np.frombuffer(path_or_raw, np.uint8), flag)
    else:
        img = cv2.imread(path_or_raw, flag)
    if img is None:
        return None
    return img[None] if img.ndim == 2 else img.transpose(2, 0, 1)


def assert_decodes_as_cv2(path):
    """Gray and colour: the decoder, `decode_batch` and the port's
    `load_image` equal cv2.imread, and the JAX package's `load_image`."""
    raw = open(path, "rb").read()
    for ch in (1, 3):
        want = cv2_planes(path, ch)
        got = nio.decode_jpeg(raw, ch)
        assert got.shape == want.shape, (ch, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"channels {ch}")
        np.testing.assert_array_equal(nio.decode_batch([path], ch)[0], want)
        ours = uio.load_image(path, ch)
        assert ours.dtype == np.float32
        np.testing.assert_array_equal(ours, jio.load_image(path, ch))


# (height, width, content, sampling, quality, restart, progressive)
CASES = (
    [(h, w, kind, s, 90, 0, False) for s in SAMPLING
     for (h, w) in ((17, 33), (61, 83)) for kind in ("blur", "sat")]
    + [(h, w, "sat", s, 75, 0, False) for s in SAMPLING
       for (h, w) in ((1, 1), (7, 9))]
    # chroma 2 and 3 samples wide: libjpeg's fancy h2 filters start at 3
    + [(h, w, "noise", s, 90, 0, False) for s in ("422", "420")
       for (h, w) in ((5, 3), (6, 4), (9, 5), (4, 6))]
    + [(61, 83, kind, "420", q, 0, False) for q in (5, 50, 90, 100)
       for kind in ("sat", "noise")]
    + [(61, 83, "blur", "420", 90, r, p) for r in (0, 1, 7)
       for p in (False, True)]
    + [(61, 83, "sat", s, 90, 0, True) for s in SAMPLING]
    + [(437, 1023, "blur", "420", 90, 0, False),
       (437, 1023, "sat", "420", 90, 0, True),
       (437, 1023, "blur", "444", 90, 7, False)])


@pytest.mark.parametrize("h,w,kind,sampling,quality,restart,progressive",
                         CASES)
def test_decoder_equals_cv2(tmp_path, h, w, kind, sampling, quality,
                            restart, progressive):
    path = str(tmp_path / "a.jpg")
    with open(path, "wb") as f:
        f.write(encode(content(h, w, kind), quality, sampling, progressive,
                       restart))
    assert_decodes_as_cv2(path)


@pytest.mark.parametrize("sampling,kind,restart,gray", [
    ("420", "blur", 0, False), ("420", "sat", 7, False),
    ("444", "noise", 0, False), ("422", "blur", 1, False),
    (None, "blur", 0, True)])
def test_motion_jpeg_without_dht_equals_cv2(tmp_path, sampling, kind,
                                            restart, gray):
    """Motion-JPEG frames carry no DHT: the scans' tables 0 and 1 are the
    standard ones (libjpeg-turbo's std_huff_tables), which cv2's encoder
    also writes; the same planes as cv2.imread's of the frame, and of the
    file with its tables."""
    img = content(61, 83, kind, 5)
    raw = encode(cv2.cvtColor(img, cv2.COLOR_BGR2GRAY) if gray else img,
                 90, sampling or "420", False, restart)
    segs, sos = segments(raw)
    bare = raw[:2] + b"".join(raw[a:b] for c, a, b in segs
                              if c != 0xC4) + raw[sos:]
    assert b"\xff\xc4" not in bare[:sos]
    path = str(tmp_path / "mjpeg.jpg")
    with open(path, "wb") as f:
        f.write(bare)
    assert_decodes_as_cv2(path)
    for ch in (1, 3):
        np.testing.assert_array_equal(nio.decode_jpeg(bare, ch),
                                      nio.decode_jpeg(raw, ch))


@pytest.mark.parametrize("h,w,progressive", [
    (1, 1, False), (7, 9, False), (17, 33, True), (61, 83, False),
    (437, 1023, True)])
def test_gray_jpeg_equals_cv2(tmp_path, h, w, progressive):
    """A one-component JPEG: gray as is, colour its one plane three
    times."""
    path = str(tmp_path / "g.jpg")
    gray = cv2.cvtColor(content(h, w, "blur", 4), cv2.COLOR_BGR2GRAY)
    with open(path, "wb") as f:
        f.write(encode(gray, progressive=progressive))
    assert_decodes_as_cv2(path)
    col = nio.decode_jpeg(open(path, "rb").read(), 3)
    assert (col == col[:1]).all()


def test_gray_is_the_y_plane_not_bgr2gray(tmp_path):
    """On saturated colour, BGR2GRAY of the colour decode differs from
    cv2.imread(GRAYSCALE) (the Y plane); the decoder gives the latter."""
    path = str(tmp_path / "s.jpg")
    with open(path, "wb") as f:
        f.write(encode(content(61, 83, "sat", 5)))
    gray = nio.decode_jpeg(open(path, "rb").read(), 1)[0]
    via_bgr = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                           cv2.COLOR_BGR2GRAY)
    assert (gray != via_bgr).sum() > 100
    np.testing.assert_array_equal(gray, cv2.imread(path,
                                                   cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(tmp_path, orientation):
    """Orientations 1-8 (5-8 transpose), written by PIL as cameras write
    them; the shape follows cv2's."""
    Image = pytest.importorskip("PIL.Image")
    path = str(tmp_path / "o.jpg")
    im = Image.fromarray(content(61, 83, "sat", 6)[:, :, ::-1])
    tags = Image.Exif()
    tags[0x0112] = orientation
    im.save(path, exif=tags.tobytes(), quality=90)
    assert_decodes_as_cv2(path)
    w, h, _ = nio.jpeg_info(open(path, "rb").read())
    assert (h, w) == ((83, 61) if orientation >= 5 else (61, 83))


@pytest.mark.parametrize("where", ["be_before_app0", "xmp_first",
                                   "second_exif_ignored", "not_exif",
                                   "string_tag_out_of_bounds",
                                   "after_first_scan"])
def test_exif_orientation_as_opencv_finds_it(tmp_path, where):
    """OpenCV's reading of EXIF: the first APP1 that starts "Exif\\0\\0"
    before the first scan, big-endian too; an entry it cannot read before
    the orientation tag loses the tag."""
    raw = encode(content(61, 83, "sat", 7))
    bad_string = segment(0xE1, b"Exif\0\0" + b"II\x2a\x00"
                         + struct.pack("<IH", 8, 2)
                         + struct.pack("<HHII", 0x010E, 2, 100, 9999)
                         + struct.pack("<HHIHH", 0x0112, 3, 1, 6, 0)
                         + b"\0\0\0\0")
    xmp = segment(0xE1, b"http://ns.adobe.com/xap/1.0/\0<x/>")
    patched = {
        "be_before_app0": raw[:2] + exif(6, True) + raw[2:],
        "xmp_first": after_app0(raw, xmp + exif(8)),
        "second_exif_ignored": after_app0(raw, exif(6) + exif(3)),
        "not_exif": after_app0(raw, segment(0xE1, b"XXXX\0\0"
                                            + exif(6)[10:])),
        "string_tag_out_of_bounds": after_app0(raw, bad_string),
        "after_first_scan": raw[:-2] + exif(6) + raw[-2:],
    }[where]
    path = str(tmp_path / "e.jpg")
    with open(path, "wb") as f:
        f.write(patched)
    assert_decodes_as_cv2(path)


@pytest.mark.parametrize("transform,keep_jfif", [(0, False), (0, True),
                                                 (1, False)])
def test_adobe_app14(tmp_path, transform, keep_jfif):
    """An Adobe APP14 segment spliced into a 4:4:4 file: transform 0
    without JFIF reads the components as RGB (no conversion); a JFIF APP0
    or transform 1 keeps YCbCr. The planes are cv2's of the same file."""
    raw = encode(content(61, 83, "blur", 8), sampling="444")
    app14 = segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                 transform))
    path = str(tmp_path / "adobe.jpg")
    with open(path, "wb") as f:
        f.write(after_app0(raw, app14, drop_app0=not keep_jfif))
    assert_decodes_as_cv2(path)
    ycc = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
    same = np.array_equal(cv2.imread(path, cv2.IMREAD_COLOR), ycc)
    assert same == (keep_jfif or transform == 1)


@pytest.mark.parametrize("progressive", [False, True])
def test_sixteen_bit_quant_tables(tmp_path, progressive):
    """Quantization values above 255: libjpeg writes 16-bit DQT tables and
    (sequential) an extended SOF1 frame."""
    Image = pytest.importorskip("PIL.Image")
    path = str(tmp_path / "q16.jpg")
    Image.fromarray(content(61, 83, "blur", 9)).save(
        path, qtables=[list(range(300, 364)), list(range(1, 65))],
        progressive=progressive)
    raw = open(path, "rb").read()
    segs, _ = segments(raw)
    dqt = [raw[s + 4] for c, s, _ in segs if c == 0xDB]
    assert dqt and dqt[0] >> 4 == 1                       # 16-bit entries
    assert {c for c, _, _ in segs} & {0xC1, 0xC2} == {
        0xC2 if progressive else 0xC1}
    assert_decodes_as_cv2(path)


# ------------------------------------------------------------ fixtures

def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


MANIFEST = _manifest()


@pytest.mark.parametrize("rel", sorted(MANIFEST["files"]))
def test_fixture_manifest_matches_cv2_and_the_decoder(rel):
    """The hashes that chip_smoke.py holds the card's build to are cv2's
    (live here) and the decoder's; a read the manifest has as null cv2
    fails on, and the decoder refuses it."""
    path = os.path.join(FIXTURES, rel)
    rec = MANIFEST["files"][rel]
    assert os.path.getsize(path) == rec["bytes"]
    for key, ch in (("gray", 1), ("color", 3)):
        if rec[key] is None:
            assert cv2_planes(path, ch) is None, (rel, key)
            with pytest.raises(ValueError, match="fails on it too"):
                nio.decode_jpeg(open(path, "rb").read(), ch)
            continue
        for planes in (np.ascontiguousarray(cv2_planes(path, ch)),
                       nio.decode_jpeg(open(path, "rb").read(), ch)):
            assert list(planes.shape) == rec[key]["shape"]
            assert hashlib.sha256(planes.tobytes()).hexdigest() == \
                rec[key]["sha256"], (rel, key)


def test_fixtures_stay_small_and_frames_move():
    """Under 1 MiB for the Huffman frames and variants, and 2.5 MB more
    for the arithmetic-coded frames, the CLI pairs and the arithmetic,
    lossless and 4-component variants."""
    total = sum(os.path.getsize(os.path.join(d, n))
                for d, _, names in os.walk(FIXTURES) for n in names)
    assert total < (1 << 20) + 2_500_000
    assert MANIFEST["motion_px"] == [1.3, 0.4]
    for sub in ("frames/", "frames_arith/"):
        frames = sorted(r for r in MANIFEST["files"] if r.startswith(sub))
        assert len(frames) == 9
        for r in frames:
            assert MANIFEST["files"][r]["color"]["shape"] == [3, 436, 1024]
    pairs = sorted(r for r in MANIFEST["files"] if r.startswith("pairs/"))
    assert len(pairs) == 4
    for r in pairs:
        assert MANIFEST["files"][r]["gray"]["shape"] == [1, 436, 1024]


# ------------------------------------------------------- batches, errors

def test_mixed_png_and_jpeg_batch_on_a_pool(tmp_path):
    """PNG and JPEG frames of one size in one batch, through a thread
    pool, equal each frame decoded alone."""
    from concurrent.futures import ThreadPoolExecutor
    paths = []
    for k in range(6):
        img = content(45, 70, "blur", 10 + k)
        p = str(tmp_path / f"f{k}.{'jpg' if k % 2 else 'png'}")
        if k % 2:
            with open(p, "wb") as f:
                f.write(encode(img, progressive=k == 3))
        else:
            viz.write_png(p, img[:, :, ::-1])
        paths.append(p)
    for ch in (1, 3):
        alone = np.stack([uio.load_image(p, ch) for p in paths])
        with ThreadPoolExecutor(4) as pool:
            got = nio.decode_batch(paths, ch, pool=pool)
        np.testing.assert_array_equal(got, alone)


def _patched(fn):
    raw = encode(content(29, 41, "blur", 11))
    return fn(raw)


def _without(codes):
    def fn(raw):
        segs, sos = segments(raw)
        keep = b"".join(raw[s:e] for c, s, e in segs if c not in codes)
        return raw[:2] + keep + raw[sos:]
    return fn


def _sof_byte(offset, value):
    def fn(raw):
        segs, _ = segments(raw)
        start = next(s for c, s, _ in segs if c == 0xC0)
        b = bytearray(raw)
        b[start + offset] = value
        return bytes(b)
    return fn


def _variant(name):
    with open(os.path.join(FIXTURES, "variants", name), "rb") as f:
        return f.read()


def _two_components(raw):
    """A 2-component file, which no colour space of libjpeg's takes."""
    return _variant("two_components.jpg")


def _lossless_ycbcr(raw):
    """A lossless RGB file under an Adobe transform 1 (YCbCr), which
    libjpeg may not convert in a lossless frame."""
    raw = _variant("lossless_rgb.jpg")
    at = raw.index(b"\xff\xee")
    return raw[:at + 15] + b"\x01" + raw[at + 16:]


def _no_dht_slot2(raw):
    """No DHT, and the first scan's first component on DC and AC table 2,
    which no standard table fills (those fill slots 0 and 1)."""
    raw = _without({0xC4})(raw)
    sos = raw.index(b"\xff\xda")
    b = bytearray(raw)
    b[sos + 6] = 0x22           # Ns, then Cs1, then Td1 / Ta1
    return bytes(b)


def _unrefined(raw):
    """A progressive file without its last scan (the final refinement of
    the luma's AC bits): libjpeg would smooth its blocks."""
    prog = encode(content(29, 41, "blur", 12), progressive=True)
    last_sos = prog.rindex(b"\xff\xda")
    return prog[:last_sos] + b"\xff\xd9"


# "arithmetic", "lossless", "cmyk": what cv2 fails on among those (lossless
# arithmetic coding, a lossless frame in a colour space libjpeg would have
# to convert, 2 components), since the decoder reads SOF9 / SOF10, SOF3
# and CMYK / YCCK as cv2 does
@pytest.mark.parametrize("make,match", [
    (_sof_byte(1, 0xCB), "lossless arithmetic.*fails on it too"),
    (_lossless_ycbcr, "lossless JPEG read in a colour space.*fails on it"),
    (_sof_byte(1, 0xC5), "hierarchical.*fails on it too"),
    (_sof_byte(4, 12), "12-bit.*fails on it too"),
    (_two_components, "2 or more than 4 components.*fails on it too"),
    (_no_dht_slot2, "Huffman table that is not defined"),
    (_without({0xDB}), "quantization table that is not defined"),
], ids=["arithmetic", "lossless", "hierarchical", "12bit", "cmyk",
        "no_dht", "no_dqt"])
def test_unsupported_or_corrupt_raises_naming_the_cause(tmp_path, make,
                                                        match):
    raw = _patched(make)
    path = str(tmp_path / "bad.jpg")
    with open(path, "wb") as f:
        f.write(raw)
    for ch in (1, 3):
        with pytest.raises(ValueError, match=match):
            nio.decode_batch([path], ch)
        with pytest.raises(ValueError, match=match):
            uio.load_image(path, ch)


# What libjpeg decodes with a warning reads as cv2.imread reads the file:
# an unfinished progressive image (block smoothing), a file cut in the
# middle of its scan (read on past a fake EOI), a stray byte between two
# marker segments (skipped).
@pytest.mark.parametrize("make", [
    _unrefined,
    lambda raw: raw[:(raw.index(b"\xff\xda") + len(raw)) // 2],
    lambda raw: after_app0(raw, b"\0"),
], ids=["smoothing", "truncated", "garbage"])
def test_damaged_input_reads_as_cv2(tmp_path, make):
    raw = _patched(make)
    path = str(tmp_path / "damaged.jpg")
    with open(path, "wb") as f:
        f.write(raw)
    for ch in (1, 3):
        want = cv2_planes(path, ch)
        assert want is not None
        np.testing.assert_array_equal(nio.decode_jpeg(raw, ch), want)
        np.testing.assert_array_equal(nio.decode_batch([path], ch)[0], want)
        np.testing.assert_array_equal(uio.load_image(path, ch),
                                      jio.load_image(path, ch))


def test_mixed_size_jpeg_batch_raises(tmp_path):
    paths = []
    for k, (h, w) in enumerate(((29, 41), (29, 40))):
        p = str(tmp_path / f"{k}.jpg")
        with open(p, "wb") as f:
            f.write(encode(content(h, w, "blur", k)))
        paths.append(p)
    with pytest.raises(ValueError, match="frame in a batch"):
        nio.decode_batch(paths, 1)


_FUZZ_SOURCES = [encode(content(23, 37, "blur", 20), quality=50,
                        restart=3),
                 encode(content(23, 37, "sat", 21), progressive=True),
                 encode(cv2.cvtColor(content(23, 37, "blur", 22),
                                     cv2.COLOR_BGR2GRAY), sampling="444"),
                 _variant("arith_restart7.jpg"),
                 _variant("arith_progressive.jpg"),
                 _variant("lossless_gray_rst.jpg"),
                 _variant("lossless_rgb.jpg")]


@settings(max_examples=300, deadline=None, derandomize=True,
          database=None)
@given(src=st.integers(0, len(_FUZZ_SOURCES) - 1),
       cut=st.one_of(st.none(), st.floats(0.0, 1.0)),
       flips=st.lists(st.tuples(st.floats(0.0, 1.0), st.integers(1, 255)),
                      max_size=3))
def test_corrupt_input_raises_or_equals_cv2(src, cut, flips):
    """Truncated and byte-flipped files (Huffman, arithmetic-coded and
    lossless) against cv2.imread of the file: exactly its planes, or, where
    cv2 fails (or on a lossless component no scan holds, whose samples
    libjpeg leaves undefined), ValueError; never anything else and never a
    crash."""
    raw = bytearray(_FUZZ_SOURCES[src])
    for where, mask in flips:
        raw[min(int(where * len(raw)), len(raw) - 1)] ^= mask
    if cut is not None:
        raw = raw[:int(cut * len(raw))]
    raw = bytes(raw)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fuzz.jpg")
        with open(path, "wb") as f:
            f.write(raw)
        for ch in (1, 3):
            want = cv2_planes(path, ch)
            try:
                got = nio.decode_jpeg(raw, ch)
            except ValueError as e:
                assert want is None or "in no scan" in str(e), str(e)
                continue
            assert want is not None
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_a_jpeg_library_that_does_not_build_raises(monkeypatch, tmp_path):
    """No fallback to cv2 or PIL: a decoder that cannot be built is an
    error, not a silent change of decoder."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "jpeg.cpp").write_text("this is not C++\n")
    (src / "io_native.cpp").write_bytes(
        (build.SRC_DIR / "io_native.cpp").read_bytes())
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_host_libs", {})
    p = os.path.join(FIXTURES, "variants", "s420.jpg")
    with pytest.raises(RuntimeError, match="building jpeg failed"):
        nio.decode_batch([p], 1)
    with pytest.raises(RuntimeError, match="building jpeg failed"):
        uio.load_image(p, 1)


# ---------------------------------------------- pipeline and CLI vs JAX

H, W = 96, 128


def write_jpeg_frames(frame_dir, n, dx, dy, seed=0):
    """Colour frames whose content translates by (dx, dy) px a frame,
    written by cv2 as 4:2:0 JPEG at quality 90."""
    os.makedirs(frame_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur((rng.random((140, 180, 3)) * 255).astype(
        np.float32), (9, 9), 2.5)
    for t in range(n):
        m = np.float32([[1, 0, dx * t], [0, 1, dy * t]])
        f = cv2.warpAffine(big, m, (180, 140))[20:20 + H, 20:20 + W]
        with open(os.path.join(frame_dir, f"frame_{t:04d}.jpg"), "wb") as fh:
            fh.write(encode(np.clip(f, 0, 255).astype(np.uint8)))
    return str(frame_dir)


@pytest.mark.parametrize("mode", ["run_OF_INT", "run_OF_RGB"])
def test_jpeg_pipeline_matches_jax(tmp_path, mode):
    """Five JPEG frames (four pairs, batch 2) through both pipelines."""
    frame_dir = write_jpeg_frames(tmp_path / "frames", 5, 1.5, 0.5)
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pipeline.run_pipeline(frame_dir, jax_out, op_point=1, batch=2,
                              mode=mode, verbose=False)
    n = pipeline.run_pipeline(frame_dir, out, op_point=1, batch=2, mode=mode,
                              verbose=False, device="cpu")
    assert n == 4
    names = assert_files_match_jax(out, jax_out)
    assert names == [f"frame_{t:04d}.flo" for t in range(4)]
    for name in names:
        fl = uio.read_flo(os.path.join(out, name))
        med = np.median(fl[16:-16, 16:-16].reshape(-1, 2), axis=0)
        assert abs(med[0] - 1.5) < 0.4 and abs(med[1] - 0.5) < 0.4


@pytest.mark.parametrize("mode", ["run_OF_INT", "run_OF_RGB"])
def test_jpeg_cli_matches_jax(tmp_path, mode):
    frame_dir = write_jpeg_frames(tmp_path / "frames", 2, 1.5, 0.5, seed=1)
    a, b = (os.path.join(frame_dir, f"frame_{t:04d}.jpg") for t in (0, 1))
    ours, ref = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    cli.main([mode, a, b, ours, "2", "--quiet", "--device", "cpu"])
    jcli.main([mode, a, b, ref, "2", "--quiet"])
    got, want = uio.read_flo(ours), jio.read_flo(ref)
    assert got.shape == want.shape == (H, W, 2)
    epe = np.linalg.norm(got - want, axis=-1).mean() \
        / np.linalg.norm(want, axis=-1).mean()
    assert epe <= EPE_RATIO
