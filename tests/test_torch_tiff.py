"""The port's TIFF decoder (`utils.io.tiff_ifd`, the pixels by
`csrc/tiff.cpp`, JPEG strips by `csrc/jpeg.cpp`, through
`native.io.decode_batch` and `utils.io.load_image`) against cv2.imread,
pixel for pixel, gray and colour; the files the port refuses, by name;
the fixtures' manifest (tests/torch_fixtures/tiff, which chip_smoke.py
part 7e holds the card machine's build to); and the serving pipeline and
CLI on TIFF frames against the JAX package's.

Files come from the numpy writers of tests/torch_fixtures/tiff/
make_fixtures.py, or from cv2 and PIL. cv2 reads them from files
(cv2.imread, as the JAX package's `load_image`): cv2.imdecode's memory
reader fails on some uncompressed tiles that cv2.imread reads. Tolerance
0: the decoder does libtiff's and OpenCV's integer arithmetic.
"""

import hashlib
import importlib.util
import io as _io
import json
import os
import struct
import tempfile
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
from of_dis_tpu_torch.native import io as nio  # noqa: E402
from of_dis_tpu_torch.utils import io as uio  # noqa: E402
from tests.test_torch_pipeline import assert_files_match_jax  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures", "tiff")
_spec = importlib.util.spec_from_file_location(
    "tiff_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)

EPE_RATIO = 1e-3
_SCRATCH = tempfile.mkdtemp(prefix="tiff_cases_")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as the other pipeline test files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cv2_planes(path, channels):
    """cv2.imread's planes, (C, H, W), None where it fails."""
    flag = cv2.IMREAD_GRAYSCALE if channels == 1 else cv2.IMREAD_COLOR
    try:
        img = cv2.imread(path, flag)
    except cv2.error:
        return None
    if img is None:
        return None
    return img[None] if img.ndim == 2 else img.transpose(2, 0, 1)


def write(raw, name="f.tif", directory=None):
    p = os.path.join(directory or _SCRATCH, name)
    with open(p, "wb") as f:
        f.write(raw)
    return p


def assert_as_cv2(raw, jax_too=True):
    """Gray and colour: `decode_image`, `decode_batch` and the port's
    `load_image` equal cv2.imread; the JAX package's `load_image` too."""
    path = write(raw)
    for ch in (1, 3):
        want = cv2_planes(path, ch)
        assert want is not None, ch
        got = nio.decode_image(raw, ch)
        assert got.shape == want.shape, (ch, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"channels {ch}")
        np.testing.assert_array_equal(nio.decode_batch([path], ch)[0], want)
        if jax_too:
            np.testing.assert_array_equal(uio.load_image(path, ch),
                                          jio.load_image(path, ch))


RNG = np.random.default_rng(161)
H0, W0 = 19, 37                 # tiles of 16 are clipped on both sides
COLOUR = mf._blur(H0, W0, 3, 5)
GRAY = mf._blur(H0, W0, 1, 6)[..., 0]
ALPHA = RNG.integers(0, 256, (H0, W0, 1))
PAL16 = RNG.integers(0, 65536, (256, 3))
# kind -> (samples, writer keywords); 16-bit kinds scale the 8-bit content
KINDS = {
    "gray8": (GRAY, {}),
    "gray16": (GRAY * 257 + 11, {"bits": 16}),
    "miniswhite8": (GRAY, {"photometric": 0}),
    "bilevel": (GRAY > 120, {"bits": 1}),
    "rgb8": (COLOUR, {}),
    "rgb16": (COLOUR * 257 + 3, {"bits": 16}),
    "rgba_unassoc": (np.concatenate([COLOUR, ALPHA], 2),
                     {"extra_samples": [2]}),
    "rgba16_assoc": (np.concatenate([COLOUR, ALPHA], 2) * 257,
                     {"bits": 16, "extra_samples": [1]}),
    "gray_alpha": (np.stack([GRAY, ALPHA[..., 0]], 2),
                   {"extra_samples": [2]}),
    "palette8": (GRAY, {"colormap": PAL16}),
    "palette4": (GRAY % 16, {"bits": 4, "colormap": PAL16[:16]}),
    "cmyk": (np.concatenate([COLOUR, ALPHA], 2), {"photometric": 5}),
}
# (tile, planar): strips of 5 rows, 16x16 tiles, each chunky and planar
LAYOUTS = {"strips": (None, False), "tiles": ((16, 16), False),
           "planar_strips": (None, True), "planar_tiles": ((16, 16), True)}


def _case(kind, layout, compression, **extra):
    pix, kw = KINDS[kind]
    tile, planar = LAYOUTS[layout]
    bits = kw.get("bits", 8)
    pred = 2 if compression in (5, 8, 32946) and bits in (8, 16) else 1
    return mf.tiff(pix, compression=compression, predictor=pred,
                   tile=tile, planar=planar, rows_per_strip=5,
                   **{**kw, **extra})


# a one-sample image is planar and chunky alike: planar only for the others
CASES = [(kind, layout) for kind in sorted(KINDS)
         for layout in sorted(LAYOUTS)
         if KINDS[kind][0].ndim == 3 or "planar" not in layout]


@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 32946])
@pytest.mark.parametrize("kind,layout", CASES)
def test_tiff_equals_cv2(kind, layout, compression):
    """Every sample layout the decoder reads, in strips and clipped tiles,
    chunky and planar, under each compression (predictor 2 where LZW or
    Deflate carries it)."""
    assert_as_cv2(_case(kind, layout, compression),
                  jax_too=compression == 5)


@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("kind", ["gray16", "rgb16", "gray_alpha", "rgb8"])
def test_byte_order_and_predictor(kind, big_endian):
    """Big-endian files: 16-bit samples swabbed before the predictor and
    before libtiff reads a clipped tile's rows off its stride."""
    for layout in ("strips", "tiles"):
        for comp in (5, 8):
            assert_as_cv2(_case(kind, layout, comp, big_endian=big_endian),
                          jax_too=False)


def test_predictor_tag_without_a_codec_is_ignored():
    """Uncompressed and PackBits data carry no predictor in libtiff: the
    tag is an unknown field, and the differences read as they are."""
    for comp in (1, 32773):
        raw = mf.tiff(COLOUR, compression=comp, predictor=2)
        assert_as_cv2(raw, jax_too=False)
        got = nio.decode_image(raw, 3)
        assert not np.array_equal(got, COLOUR.transpose(2, 0, 1)[::-1])


def test_clipped_tiles_read_as_libtiff_reads_them():
    """libtiff's gray and palette routines step past a clipped tile's
    right part by pixels, not bytes: 16-bit gray read off its rows, equal
    to cv2, and not the image itself."""
    raw = _case("gray16", "tiles", 1)
    assert_as_cv2(raw)
    got = nio.decode_image(raw, 1)[0]
    want = (GRAY * 257 + 11) >> 8
    assert np.array_equal(got[:, :16], want[:, :16])
    assert not np.array_equal(got[:, 16:], want[:, 16:])


@pytest.mark.parametrize("orientation", [1, 2, 3, 4])
@pytest.mark.parametrize("layout", ["strips", "tiles"])
def test_orientation(orientation, layout):
    """2 mirrors each strip or tile in place, 4 turns the image upside
    down, 3 both, as libtiff's raster and OpenCV's placement do."""
    assert_as_cv2(_case("rgb8", layout, 5, orientation=orientation),
                  jax_too=False)
    assert_as_cv2(_case("gray16", layout, 1, orientation=orientation),
                  jax_too=False)


@pytest.mark.parametrize("orientation", [5, 6, 7, 8])
def test_transposing_orientations_are_refused(orientation):
    """cv2.imread fails on orientations 5-8 ("original_ptr ==
    real_mat.data")."""
    raw = _case("rgb8", "strips", 1, orientation=orientation)
    path = write(raw)
    for ch in (1, 3):
        assert cv2_planes(path, ch) is None
        with pytest.raises(ValueError, match=f"orientation {orientation}"):
            nio.decode_image(raw, ch)


@pytest.mark.parametrize("fill_order", [1, 2])
@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
def test_fill_order(fill_order, compression):
    """FillOrder 2: the stored bytes' bits reversed, before any codec."""
    for kind in ("bilevel", "gray8"):
        assert_as_cv2(_case(kind, "strips", compression,
                            fill_order=fill_order), jax_too=False)


def test_bigtiff_and_signed_samples():
    for raw in (mf.tiff(COLOUR, compression=8, big=True, tile=(16, 16)),
                mf.tiff(COLOUR, big=True, big_endian=True, planar=True),
                mf.tiff((GRAY - 128) & 0xFF, sample_format=2),
                mf.tiff(GRAY * 257 - 30000 & 0xFFFF, bits=16,
                        sample_format=2)):
        assert_as_cv2(raw, jax_too=False)


# --------------------------------------------------------- JPEG-in-TIFF

@pytest.mark.parametrize("quality", [95, 40])
@pytest.mark.parametrize("gray", [False, True])
@pytest.mark.parametrize("h,w", [(32, 48), (37, 45), (8, 8)])
def test_cv2_jpeg_tiff(h, w, gray, quality):
    """cv2's compression 7: photometric RGB (gray) strips, the JPEG
    tables in JPEGTables, each strip an abbreviated stream; the samples
    as libjpeg decodes them with no colour conversion, gray by the
    readers' rule of that colour."""
    img = mf._blur(h, w, 3, h * w).astype(np.uint8)
    ok, enc = cv2.imencode(".tif", img[..., 0] if gray else img,
                           [cv2.IMWRITE_TIFF_COMPRESSION, 7,
                            cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    assert_as_cv2(enc.tobytes(), jax_too=False)


@pytest.mark.parametrize("name,sub", [("s420", (2, 2)), ("s444", (1, 1)),
                                      ("s422", (2, 1)),
                                      ("saturated", (2, 2))])
def test_ycbcr_jpeg_tiff_is_the_jpeg_in_colour(name, sub):
    """YCbCr JPEG-in-TIFF: libtiff has libjpeg convert it to RGB, with
    the JPEG decoder's upsampling: the colour planes are cv2's of the JPEG
    itself; gray is the readers' rule of that colour, not the Y plane
    (they part on saturated colour)."""
    with open(os.path.join(mf.JPEG_DIR, "variants", f"{name}.jpg"),
              "rb") as f:
        jpg = f.read()
    h, w = cv2.imdecode(np.frombuffer(jpg, np.uint8), 0).shape
    raw = mf.jpeg_tiff(jpg, w, h, sub)
    assert_as_cv2(raw, jax_too=False)
    jpg_path = write(jpg, "f.jpg")
    np.testing.assert_array_equal(nio.decode_image(raw, 3),
                                  cv2_planes(jpg_path, 3))
    if name == "saturated":
        assert not np.array_equal(nio.decode_image(raw, 1),
                                  cv2_planes(jpg_path, 1))


def test_pil_written_tiffs():
    """PIL's YCbCr, gray and RGB JPEG TIFFs, and its RGBA (unassociated
    alpha: premultiplied), CMYK, gray + alpha, palette and bilevel ones."""
    Image = pytest.importorskip("PIL.Image")
    im = Image.fromarray(mf._blur(33, 41, 3, 2).astype(np.uint8))
    for mode, comp in (("YCbCr", "jpeg"), ("L", "jpeg"), ("RGB", "jpeg"),
                       ("RGBA", "packbits"), ("CMYK", "tiff_lzw"),
                       ("LA", "raw"), ("P", "tiff_deflate"),
                       ("1", "packbits"), ("I;16", "tiff_lzw")):
        buf = _io.BytesIO()
        im.convert(mode).save(buf, "TIFF", compression=comp)
        assert_as_cv2(buf.getvalue(), jax_too=False)


# ------------------------------------------------------------- refusals

def _patch_tag(raw, tag, value):
    """A little-endian classic TIFF with the one LONG value of `tag` in its
    IFD set to `value`."""
    ifd = struct.unpack("<I", raw[4:8])[0]
    for k in range(struct.unpack("<H", raw[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack("<H", raw[at:at + 2])[0] == tag:
            return raw[:at + 8] + struct.pack("<I", value) + raw[at + 12:]
    raise KeyError(tag)


def _retag(raw, tag, new_tag=None, new_type=None):
    """A little-endian classic TIFF with IFD entry `tag` renumbered or
    retyped (its value field as it is)."""
    ifd = struct.unpack("<I", raw[4:8])[0]
    b = bytearray(raw)
    for k in range(struct.unpack("<H", raw[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * k
        if struct.unpack("<H", raw[at:at + 2])[0] == tag:
            if new_tag is not None:
                struct.pack_into("<H", b, at, new_tag)
            if new_type is not None:
                struct.pack_into("<H", b, at + 2, new_type)
            return bytes(b)
    raise KeyError(tag)


def _padded_tiles():
    """Uncompressed 16x16 tiles stored with one byte too many each."""
    chunks = []
    for y in range(0, H0, 16):
        for x in range(0, W0, 16):
            tile = np.zeros((16, 16, 1), np.int64)
            block = GRAY[y:y + 16, x:x + 16, None]
            tile[:block.shape[0], :block.shape[1]] = block
            chunks.append(mf._rows(tile, 8, "<") + b"\0")
    return mf.tiff(GRAY, tile=(16, 16), chunks=chunks)


# (make, the refusal's words, whether cv2.imread fails on it too)
REFUSALS = [
    (lambda: mf.tiff(GRAY % 16, bits=4), "4-bit gray", True),
    (lambda: mf.tiff(GRAY % 4, bits=2), "2-bit samples", True),
    (lambda: mf.tiff(COLOUR % 16, bits=4), "4-bit RGB", True),
    (lambda: mf.tiff(np.frombuffer(GRAY.astype(np.float32).tobytes(),
                                   np.uint32).reshape(GRAY.shape),
                     bits=32, sample_format=3), "SampleFormat 3", True),
    (lambda: mf.tiff(GRAY, bits=32), "32-bit samples", True),
    (lambda: mf.tiff(GRAY, bits=16, sample_format=3), "SampleFormat 3",
     True),
    (lambda: mf.tiff(GRAY, omit=(262,)), "PhotometricInterpretation",
     True),
    (lambda: mf.tiff(GRAY, extra_tags=((278, 4, [0]),)), "RowsPerStrip 0",
     True),
    (lambda: mf.tiff(GRAY, chunks=[b"\0" * 8],
                     extra_tags=((259, 3, [34925]),)), "LZMA", True),
    (lambda: mf.tiff(GRAY, chunks=[b"\0" * 8],
                     extra_tags=((259, 3, [50000]),)), "ZSTD", True),
    (lambda: mf.tiff(COLOUR, omit=(277,)), "RGB TIFF of 1", True),
    (lambda: mf.tiff(np.stack([GRAY, GRAY], 2), colormap=PAL16,
                     planar=True, extra_samples=[0]), "planar palette",
     True),
    (lambda: mf.tiff(COLOUR, photometric=8), "CIELab", False),
    (lambda: mf.tiff(GRAY, compression=5, predictor=3), "predictor 3",
     None),
    (lambda: mf.tiff(GRAY, compression=5, chunks=[b"\0\x01" + bytes(30)]),
     "old-style TIFF LZW", None),
    (lambda: mf.tiff(GRAY)[:-300], "IFD offset out of the file", True),
    (lambda: b"II*\0" + struct.pack("<I", 1 << 20), "IFD offset", True),
    # IFDs libtiff reads otherwise than the parser would, or fails on
    (lambda: _retag(mf.tiff(GRAY), 284, 259), "tag 259 twice", None),
    (lambda: _retag(mf.tiff(GRAY), 284, 325), "stripped TIFF with tile",
     None),
    (lambda: _padded_tiles(), "uncompressed TIFF tile of another byte",
     True),
    (lambda: mf.tiff(GRAY, colormap=PAL16, omit=(258,)),
     "colour TIFF without BitsPerSample", True),
    (lambda: mf.tiff(GRAY, extra_tags=((278, 4, [5, 5]),)),
     "tag 278 with 2 values", True),
    (lambda: mf.tiff(COLOUR, extra_tags=((258, 3, [8, 8]),)),
     "tag 258 with values", None),
    (lambda: _retag(mf.tiff(GRAY), 259, new_type=2), "tag 259 of type 2",
     None),
    (lambda: mf.tiff(GRAY, extra_tags=((278, 4, [1 << 23]),)),
     "RGBA buffer of 1 GiB", True),
    (lambda: mf.tiff(np.concatenate([COLOUR, ALPHA], 2),
                     extra_samples=[3]), "ExtraSamples", None),
]


def _ccitt():
    Image = pytest.importorskip("PIL.Image")
    buf = _io.BytesIO()
    Image.fromarray((GRAY > 100).astype(np.uint8) * 255).convert("1").save(
        buf, "TIFF", compression="group4")
    return buf.getvalue()


def _rgba_jpeg():
    Image = pytest.importorskip("PIL.Image")
    buf = _io.BytesIO()
    Image.fromarray(np.concatenate([COLOUR, ALPHA], 2).astype(
        np.uint8)).save(buf, "TIFF", compression="jpeg")
    return buf.getvalue()


# files the port refused until it read CCITT fax, YCbCr without JPEG,
# 4-sample JPEG-in-TIFF, and damaged strips: LZW data that do not start
# with Clear (libtiff decodes nothing of them: zeros), and one uncompressed
# strip whose byte count runs past the end of the file (libtiff's
# EstimateStripByteCounts takes its rows' bytes instead). The refusals'
# words are their ids.
ONCE_REFUSED = [(_ccitt, "CCITT Group 4"),
                (_rgba_jpeg, "JPEG TIFF other than"),
                (lambda: mf.tiff(COLOUR, photometric=6),
                 "YCbCr without JPEG"),
                (lambda: mf.tiff(GRAY, compression=5,
                                 chunks=[b"\x40" + bytes(30)]),
                 "corrupt TIFF LZW"),                   # no Clear first
                (lambda: _patch_tag(mf.tiff(GRAY), 279, 1 << 20),
                 "beyond the end of the file")]


@pytest.mark.parametrize("make,words", ONCE_REFUSED,
                         ids=[r[1] for r in ONCE_REFUSED])
def test_once_refused_variants_read_as_cv2(make, words):
    """The same files as the refusals they replace: each now equals
    cv2.imread (the uncompressed YCbCr one takes libtiff's default 2x2
    subsampling, its bytes read as blocks; the LZW strip without Clear
    reads as zeros)."""
    assert_as_cv2(make())


@pytest.mark.parametrize("make,match,cv2_fails", REFUSALS,
                         ids=[r[1] for r in REFUSALS])
def test_refused_variants_raise_naming_them(make, match, cv2_fails):
    """Each refusal names the variant. Those cv2.imread fails on say so;
    those cv2.imread reads (listed in ROADMAP.md, Queue 3) are named as
    not supported."""
    raw = make()
    path = write(raw, "bad.tif")
    for ch in (1, 3):
        with pytest.raises(ValueError, match=match):
            nio.decode_image(raw, ch)
        if cv2_fails is not None:
            assert (cv2_planes(path, ch) is None) == cv2_fails, ch
    with pytest.raises(ValueError, match=match):
        uio.load_image(path, 1)


@pytest.mark.parametrize("w,h", [(1 << 20 | 1, 1), (1, 1 << 20 | 1),
                                 (32768, 32769)])
def test_larger_than_cv2_reads_is_refused(w, h):
    raw = mf.tiff(np.zeros((1, 1)), extra_tags=((256, 4, [w]),
                                                (257, 4, [h])))
    path = write(raw, "big.tif")
    for ch in (1, 3):
        with pytest.raises(ValueError, match="above cv::imread's limits"):
            nio.decode_image(raw, ch)
        assert cv2_planes(path, ch) is None


# ----------------------------------------------------- manifest, frames

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def _sha(planes):
    return hashlib.sha256(np.ascontiguousarray(planes).tobytes()).hexdigest()


def _assert_manifest(path, rec):
    for key, ch in (("gray", 1), ("color", 3)):
        if rec[key] is None:
            assert cv2_planes(path, ch) is None
            with pytest.raises(ValueError):
                nio.decode_batch([path], ch)
            continue
        for planes in (cv2_planes(path, ch), nio.decode_batch([path], ch)[0],
                       uio.load_image(path, ch).astype(np.uint8)):
            assert list(planes.shape) == rec[key]["shape"]
            assert _sha(planes) == rec[key]["sha256"], (path, key)


@pytest.mark.parametrize("rel", sorted(MANIFEST["files"]))
def test_fixture_manifest_matches_cv2_and_the_decoder(rel):
    """The committed variants: their hashes, which chip_smoke.py holds the
    card's build to, are cv2's (live here) and the port's; the port's
    `load_image` is the JAX package's where cv2 reads the file."""
    path = os.path.join(FIXTURES, rel)
    rec = MANIFEST["files"][rel]
    assert os.path.getsize(path) == rec["bytes"]
    _assert_manifest(path, rec)
    for key, ch in (("gray", 1), ("color", 3)):
        if rec[key] is not None:
            np.testing.assert_array_equal(uio.load_image(path, ch),
                                          jio.load_image(path, ch))


@pytest.mark.parametrize("rel", sorted(MANIFEST["committed"]))
def test_committed_sets_match_cv2_and_the_decoder(rel):
    """The committed frame sets (libtiff-written: Group 4 frames, RGBA and
    CMYK JPEG-in-TIFF pairs), which chip_smoke.py part 7e serves: their
    hashes are cv2's and the port's, and the JAX package's `load_image`
    reads them as the port's does."""
    path = os.path.join(FIXTURES, rel)
    rec = MANIFEST["committed"][rel]
    assert os.path.getsize(path) == rec["bytes"]
    _assert_manifest(path, rec)
    np.testing.assert_array_equal(uio.load_image(path, 1),
                                  jio.load_image(path, 1))


@pytest.fixture(scope="module")
def frame_dirs(tmp_path_factory):
    """chip_smoke.py part 7e's frames 0-2, written here from cv2's planes
    of the JPEG frames (which the port's JPEG decoder reproduces)."""
    root = str(tmp_path_factory.mktemp("frames"))
    planes, jpegs = mf.jpeg_frames()
    return mf.write_frames(root, planes[:3], jpegs[:3])


@pytest.mark.parametrize("fmt", mf.FORMATS)
def test_frame_manifest_matches_cv2_and_the_decoder(frame_dirs, fmt):
    """Part 7e's 1024x436 frames (made on the card's host by the same
    numpy writers): the manifest's hashes are cv2's and the port's, and a
    batch on a pool equals them."""
    paths = frame_dirs[fmt]
    for p in paths:
        _assert_manifest(p, MANIFEST["frames"][f"{fmt}/"
                                               f"{os.path.basename(p)}"])
    with ThreadPoolExecutor(3) as pool:
        batch = nio.decode_batch(paths, 1, pool=pool)
    for p, planes in zip(paths, batch):
        assert _sha(planes) == MANIFEST["frames"][
            f"{fmt}/{os.path.basename(p)}"]["gray"]["sha256"]


def test_fixtures_stay_small_and_regenerate():
    sizes = [os.path.getsize(os.path.join(FIXTURES, r))
             for r in MANIFEST["files"]]
    assert max(sizes) < 12_000 and len(sizes) >= 60
    assert MANIFEST["motion_px"] == [1.3, 0.4]
    assert len(MANIFEST["frames"]) == 9 * len(mf.FORMATS)
    assert sorted(MANIFEST["committed"]) == sorted(
        f"{d}/frame_{t:04d}.tif" for d, n in mf.COMMITTED.items()
        for t in range(n))
    for name, raw in mf.variants().items():
        with open(os.path.join(FIXTURES, "variants", name), "rb") as f:
            assert f.read() == raw, name


# ------------------------------------------------------------ hypothesis

_FUZZ_SOURCES = [
    mf.tiff(GRAY[:7, :9], compression=5, predictor=2, rows_per_strip=3),
    mf.tiff(COLOUR[:6, :7], compression=32773, tile=(16, 16)),
    mf.tiff(COLOUR[:5, :6] * 257, bits=16, compression=8, planar=True),
    mf.tiff(GRAY[:8, :9] % 16, bits=4, colormap=PAL16[:16]),
    mf.tiff(np.concatenate([COLOUR, ALPHA], 2)[:4, :5], extra_samples=[2],
            big_endian=True, big=True),
    mf.jpeg_tiff(open(os.path.join(mf.JPEG_DIR, "variants", "tiny_7x9.jpg"),
                      "rb").read(), 9, 7),
    open(os.path.join(FIXTURES, "variants", "pil_1_group4.tif"), "rb").read(),
    mf.ycbcr_tiff(mf.rgb_to_ycbcr(COLOUR[:9, :11]), (2, 2), compression=5,
                  rows_per_strip=4),
]


@settings(max_examples=200, deadline=None, derandomize=True,
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
    path = write(raw, "fuzz.tif")
    for ch in (1, 3):
        try:
            got = nio.decode_image(raw, ch)
        except ValueError:
            continue
        want = cv2_planes(path, ch)
        assert want is not None
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------- batches, pipeline, CLI

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


def _jpeg(bgr):
    ok, enc = cv2.imencode(".jpg", bgr.transpose(1, 2, 0),
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
    assert ok
    return enc.tobytes()


def test_mixed_format_batch_on_a_pool(tmp_path):
    """Every frame format of part 7e and a PNG in one batch, through a
    thread pool, equal cv2 frame by frame."""
    planes = _shift_planes(6, 1.0, 0.0, seed=4)
    paths = [write(mf.encode_frame(fmt, *planes[k], _jpeg(planes[k][1])),
                   f"f{k}.tif", str(tmp_path))
             for k, fmt in enumerate(mf.FORMATS)]
    png = str(tmp_path / "f9.png")
    cv2.imwrite(png, planes[5][1].transpose(1, 2, 0))
    paths.append(png)
    assert pipeline.list_frames(str(tmp_path)) == sorted(paths)
    for ch in (1, 3):
        want = np.stack([cv2_planes(p, ch) for p in paths])
        with ThreadPoolExecutor(4) as pool:
            np.testing.assert_array_equal(
                nio.decode_batch(paths, ch, pool=pool), want)


def test_pipeline_lists_tiff_and_gif(tmp_path):
    for name in ("a.tif", "b.TIFF", "c.gif", "d.txt", "e.pfm"):
        write(b"", name, str(tmp_path))
    assert [os.path.basename(p) for p in pipeline.list_frames(
        str(tmp_path))] == ["a.tif", "b.TIFF", "c.gif"]


def test_tiff_pipeline_matches_jax(tmp_path):
    """Three frames, one format after another (two pairs, batch 2, gray
    flow), through the port's pipeline, against the JAX pipeline on cv2's
    gray planes of the same files as PGM (its pipeline lists no TIFF; its
    `load_image` reads TIFF through cv2, the CLI test)."""
    planes = _shift_planes(3, 1.5, 0.5, seed=2)
    port_dir, pgm_dir = tmp_path / "tiff", tmp_path / "pgm"
    os.makedirs(port_dir)
    os.makedirs(pgm_dir)
    for t, fmt in enumerate(("lzw_pred", "jpeg", "packbits_tiled")):
        p = write(mf.encode_frame(fmt, *planes[t], _jpeg(planes[t][1])),
                  f"frame_{t:04d}.tif", str(port_dir))
        gray = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        write(b"P5\n%d %d\n255\n" % (W, H) + gray.tobytes(),
              f"frame_{t:04d}.pgm", str(pgm_dir))
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pipeline.run_pipeline(str(pgm_dir), jax_out, op_point=2, batch=2,
                              mode="run_OF_INT", verbose=False)
    assert pipeline.run_pipeline(str(port_dir), out, op_point=2, batch=2,
                                 mode="run_OF_INT", verbose=False,
                                 device="cpu") == 2
    assert assert_files_match_jax(out, jax_out) == ["frame_0000.flo",
                                                   "frame_0001.flo"]


@pytest.mark.parametrize("mode,fmts", [("run_OF_INT", ("gray16",
                                                       "deflate_rgb")),
                                       ("run_OF_RGB", ("jpeg",
                                                       "packbits_tiled"))])
def test_tiff_cli_matches_jax(tmp_path, mode, fmts):
    """The port's CLI and the JAX package's (whose `load_image` reads
    these files through cv2) on the same two files."""
    planes = _shift_planes(2, 1.5, 0.5, seed=1)
    paths = [write(mf.encode_frame(fmt, *planes[t], _jpeg(planes[t][1])),
                   f"f{t}.tif", str(tmp_path))
             for t, fmt in enumerate(fmts)]
    ours, ref = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    cli.main([mode, *paths, ours, "2", "--quiet", "--device", "cpu"])
    jcli.main([mode, *paths, ref, "2", "--quiet"])
    got, want = uio.read_flo(ours), jio.read_flo(ref)
    assert got.shape == want.shape == (H, W, 2)
    epe = np.linalg.norm(got - want, axis=-1).mean() \
        / np.linalg.norm(want, axis=-1).mean()
    assert epe <= EPE_RATIO
