"""The port's GIF decoder (`utils.io.gif_blocks`, the pixels by
`csrc/gif.cpp`, through `native.io.decode_batch` and `utils.io.load_image`)
against cv2.imread, pixel for pixel, gray and colour; the files the port
refuses, by name; the fixtures' manifest (tests/torch_fixtures/gif, which
chip_smoke.py part 7e holds the card machine's build to); and the serving
pipeline and CLI on GIF frames against the JAX package's.

Files come from the numpy writers of tests/torch_fixtures/gif/
make_fixtures.py (GIF's LZW as giflib writes it, or code streams laid out
by hand), or from cv2 and PIL. Tolerance 0.
"""

import hashlib
import importlib.util
import io as _io
import json
import os
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
                        "torch_fixtures", "gif")
_spec = importlib.util.spec_from_file_location(
    "gif_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)

EPE_RATIO = 1e-3
_SCRATCH = tempfile.mkdtemp(prefix="gif_cases_")


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


def write(raw, name="f.gif", directory=None):
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


RNG = np.random.default_rng(162)
PAL = RNG.integers(0, 256, (256, 3))
LOCAL = RNG.integers(0, 256, (256, 3))


@pytest.mark.parametrize("min_size", [2, 3, 5, 8])
@pytest.mark.parametrize("tables", ["global", "local", "both", "none"])
@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("h,w", [(1, 1), (13, 17), (9, 70)])
def test_gif_equals_cv2(h, w, interlace, tables, min_size):
    """Every minimum code size, the colour tables (no table at all: black,
    white, then gray levels), interlace, 1 to 9 rows."""
    idx = RNG.integers(0, 1 << min_size, (h, w))
    n = 1 << min_size
    raw = mf.gif([mf.frame(idx, min_size=min_size, interlace=interlace,
                           local=LOCAL[:n] if tables in ("local", "both")
                           else None)], w, h,
                 PAL[:n] if tables in ("global", "both") else None,
                 background=int(RNG.integers(0, n)))
    assert_as_cv2(raw, jax_too=min_size == 8)


@pytest.mark.parametrize("transparent", [None, 0, 7])
@pytest.mark.parametrize("global_table", [True, False])
def test_frame_offset_background_and_transparency(global_table,
                                                  transparent):
    """The screen outside the first image, and its transparent pixels,
    keep the global table's background colour (black without one)."""
    idx = RNG.integers(0, 16, (7, 9))
    raw = mf.gif([mf.frame(idx, left=4, top=3, transparent=transparent,
                           local=None if global_table else LOCAL,
                           disposal=int(RNG.integers(0, 4)))], 17, 12,
                 PAL if global_table else None, background=200)
    assert_as_cv2(raw)
    got = nio.decode_image(raw, 3)
    want_bg = PAL[200][::-1] if global_table else (0, 0, 0)
    np.testing.assert_array_equal(got[:, 0, 0], want_bg)
    if transparent is not None:
        y, x = np.argwhere(idx == transparent)[0] if (
            idx == transparent).any() else (None, None)
        if y is not None:
            np.testing.assert_array_equal(got[:, 3 + y, 4 + x], want_bg)


def test_gray_is_cvtcolor_of_the_colour():
    """Gray is OpenCV 5's cvtColor BGR2GRAY (1/32768ths) of the decoded
    colour, not the readers' 1/16384ths: a palette whose every entry
    rounds apart under the two rules."""
    raw = open(os.path.join(FIXTURES, "variants", "gray_rule.gif"),
               "rb").read()
    assert_as_cv2(raw)
    bgr = nio.decode_image(raw, 3).astype(np.int64)
    b, g, r = bgr
    np.testing.assert_array_equal(
        nio.decode_image(raw, 1)[0],
        (b * 3735 + g * 19235 + r * 9798 + 16384) >> 15)
    assert ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14 != (
        (b * 3735 + g * 19235 + r * 9798 + 16384) >> 15)).all()


@pytest.mark.parametrize("defer,clear_every", [(True, None), (False, None),
                                               (False, 7), (True, 1000)])
def test_code_table_growth_and_clears(defer, clear_every):
    """A table that fills (4096 codes) with or without a Clear after it,
    and Clears at other points."""
    idx = RNG.integers(0, 4, (90, 130))
    raw = mf.gif([mf.frame(idx, min_size=2, defer=defer,
                           clear_every=clear_every)], 130, 90, PAL[:4])
    assert_as_cv2(raw, jax_too=False)


def test_animation_is_its_first_frame():
    f0, f1 = RNG.integers(0, 256, (2, 11, 14))
    raw = mf.gif([mf.frame(f0, gce=True, delay=3),
                  mf.frame(f1, gce=True, delay=3, local=LOCAL)], 14, 11, PAL,
                 loop=True)
    assert_as_cv2(raw)
    np.testing.assert_array_equal(nio.decode_image(raw, 3),
                                  PAL[f0][..., ::-1].transpose(2, 0, 1))


def test_pil_and_cv2_written_gifs():
    Image = pytest.importorskip("PIL.Image")
    img = mf.gray_palette()[RNG.integers(0, 256, (27, 31))].astype(np.uint8)
    im = Image.fromarray(cv2.GaussianBlur(
        RNG.integers(0, 256, (27, 31, 3)).astype(np.uint8), (5, 5), 1))
    for mode, kw in (("P", {}), ("L", {}), ("1", {}),
                     ("P", {"interlace": True}), ("L", {"transparency": 9}),
                     ("RGB", {"optimize": True})):
        buf = _io.BytesIO()
        im.convert(mode).save(buf, "GIF", **kw)
        assert_as_cv2(buf.getvalue(), jax_too=False)
    ok, enc = cv2.imencode(".gif", img)
    assert ok
    assert_as_cv2(enc.tobytes(), jax_too=False)


# ------------------------------------------------------------- refusals

def _codes(codes, min_size=2, w=4, h=1):
    """A GIF whose image data is the given (code, width) list, LSB-first,
    on a 4-entry gray table."""
    acc = n = 0
    data = bytearray()
    for code, width in codes:
        acc |= code << n
        n += width
        while n >= 8:
            data.append(acc & 0xFF)
            acc >>= 8
            n -= 8
    if n:
        data.append(acc & 0xFF)
    return mf.gif([mf.frame(np.zeros((h, w)), min_size=min_size,
                            data=bytes(data))], w, h, mf.gray_palette(4))


_IDX = RNG.integers(0, 256, (6, 9))
C, E = 4, 5     # Clear and End of a minimum code size of 2
# (make, the refusal's words, whether cv2.imread fails on it too)
REFUSALS = [
    (lambda: mf.gif([mf.frame(_IDX)], 0, 6, PAL), "logical screen", True),
    (lambda: mf.gif([mf.frame(_IDX, left=3)], 9, 6, PAL), "outside its",
     True),
    (lambda: mf.gif([mf.frame(_IDX % 4, min_size=2)], 9, 6, PAL[:4],
                    background=5), "background index", True),
    (lambda: mf.gif([mf.frame(_IDX)], 9, 6, PAL)[:-1], "no trailer", True),
    (lambda: mf.gif([], 9, 6, PAL), "without an image", True),
    (lambda: b"GIF88a" + mf.gif([mf.frame(_IDX)], 9, 6, PAL)[6:],
     "unsupported image format", True),
    (lambda: mf.gif([b"\x21\xf9\x05" + bytes(5) + b"\0" + mf.frame(_IDX)],
                    9, 6, PAL), "Graphic Control Extension", True),
    (lambda: mf.gif([b"\x21\xf9\x04\x1d\0\0\0\0" + mf.frame(_IDX)], 9, 6,
                    PAL), "disposal method 7", True),
    (lambda: mf.gif([b"\x21\xff\x0bANIMEXTS1.0\x03\x01\0\0\0" +
                     mf.frame(_IDX)], 9, 6, PAL), "application extension",
     True),
    (lambda: mf.gif([b"\x00" + mf.frame(_IDX)], 9, 6, PAL), "block 0x00",
     True),
    (lambda: mf.gif([mf.frame(_IDX % 8, min_size=3)], 9, 6, PAL[:4]),
     "outside its colour tables", True),
    (lambda: _codes([(C, 3), (1, 3), (2, 3), (E, 3)]), "more or fewer",
     True),                                         # End before the last
    (lambda: _codes([(C, 3), (1, 3), (2, 3), (6, 3), (E, 3)], w=3),
     "more or fewer", True),                        # a string overruns
    (lambda: _codes([(C, 3), (1, 3), (7, 3), (E, 3)], w=3), "corrupt GIF",
     True),                                         # undefined code
    (lambda: _codes([(C, 3), (6, 3), (E, 3)], w=2), "corrupt GIF", True),
    (lambda: _codes([(C, 3), (1, 3), (2, 3), (3, 3), (1, 4), (E, 4)], w=3),
     "more or fewer", True),                        # a code past the end
    (lambda: _codes([(C, 3), (1, 3), (2, 3), (3, 3), (1, 4)], w=4),
     "no LZW End", False),                          # data ends at a code
    (lambda: _codes([(C, 3), (1, 3), (2, 3), (3, 3), (E, 3), (0, 8),
                     (0, 8)], w=3), "data after its End", True),
    (lambda: mf.gif([mf.frame(_IDX, min_size=9, data=b"\0")], 9, 6, PAL),
     "minimum code size 9", None),
    (lambda: mf.gif([mf.frame(_IDX % 4, min_size=2, transparent=9)], 9, 6,
                    PAL[:4]), "transparent index 9", None),
]


@pytest.mark.parametrize("make,match,cv2_fails", REFUSALS,
                         ids=[f"{k}-{r[1]}" for k, r in enumerate(REFUSALS)])
def test_refused_variants_raise_naming_them(make, match, cv2_fails):
    """Each refusal names the variant. Those cv2.imread fails on say so
    (or are corrupt); those cv2.imread reads are listed in ROADMAP.md,
    Queue 3."""
    raw = make()
    path = write(raw, "bad.gif")
    for ch in (1, 3):
        with pytest.raises(ValueError, match=match):
            nio.decode_image(raw, ch)
        if cv2_fails is not None:
            assert (cv2_planes(path, ch) is None) == cv2_fails, ch
    with pytest.raises(ValueError, match=match):
        uio.load_image(path, 1)


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


@pytest.fixture(scope="module")
def frame_dirs(tmp_path_factory):
    """chip_smoke.py part 7e's frames 0-2, written here from cv2's gray
    planes of the JPEG frames (which the port's JPEG decoder
    reproduces)."""
    root = str(tmp_path_factory.mktemp("frames"))
    return mf.write_frames(root, mf.jpeg_grays()[:3])


@pytest.mark.parametrize("fmt", mf.FORMATS)
def test_frame_manifest_matches_cv2_and_the_decoder(frame_dirs, fmt):
    """Part 7e's 1024x436 frames (made on the card's host by the same
    numpy writers): the manifest's hashes are cv2's and the port's, the
    gray plane the JPEG frame's own, and a batch on a pool equals them."""
    paths = frame_dirs[fmt]
    grays = mf.jpeg_grays()
    for t, p in enumerate(paths):
        _assert_manifest(p, MANIFEST["frames"][f"{fmt}/"
                                               f"{os.path.basename(p)}"])
        np.testing.assert_array_equal(nio.decode_image(
            open(p, "rb").read(), 1)[0], grays[t])
    with ThreadPoolExecutor(3) as pool:
        batch = nio.decode_batch(paths, 1, pool=pool)
    for p, planes in zip(paths, batch):
        assert _sha(planes) == MANIFEST["frames"][
            f"{fmt}/{os.path.basename(p)}"]["gray"]["sha256"]


def test_fixtures_stay_small_and_regenerate():
    sizes = [os.path.getsize(os.path.join(FIXTURES, r))
             for r in MANIFEST["files"]]
    assert max(sizes) < 10_000 and len(sizes) >= 30
    assert MANIFEST["motion_px"] == [1.3, 0.4]
    assert len(MANIFEST["frames"]) == 9 * len(mf.FORMATS)
    for name, raw in mf.variants().items():
        with open(os.path.join(FIXTURES, "variants", name), "rb") as f:
            assert f.read() == raw, name


# ------------------------------------------------------------ hypothesis

_FUZZ_SOURCES = [
    mf.gif([mf.frame(_IDX)], 9, 6, PAL),
    mf.gif([mf.frame(_IDX % 8, min_size=3, interlace=True, local=LOCAL[:8],
                     transparent=2)], 9, 6, PAL[:8], background=3),
    mf.gif([mf.frame(_IDX[:3, :4], left=2, top=1, gce=True),
            mf.frame(_IDX, gce=True)], 9, 6, None, loop=True),
    mf.gif([mf.frame(RNG.integers(0, 4, (20, 30)), min_size=2,
                     defer=True)], 30, 20, PAL[:4],
           extensions=b"\x21\xfe\x02hi\x00"),
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
    path = write(raw, "fuzz.gif")
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


def _shift_grays(n, dx, dy, seed=0):
    """Gray planes of n frames whose content translates by (dx, dy) px a
    frame."""
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur((rng.random((140, 180)) * 255).astype(
        np.float32), (9, 9), 2.5)
    out = []
    for t in range(n):
        m = np.float32([[1, 0, dx * t], [0, 1, dy * t]])
        out.append(np.clip(cv2.warpAffine(big, m, (180, 140))[
            20:20 + H, 20:20 + W], 0, 255).astype(np.uint8))
    return out


def test_gif_pipeline_matches_jax(tmp_path):
    """Three 256-gray GIF frames (two pairs, batch 2, gray flow) through
    the port's pipeline, against the JAX pipeline on the same gray planes
    as PGM (its pipeline lists no GIF; its `load_image` reads GIF through
    cv2, the CLI test)."""
    grays = _shift_grays(3, 1.5, 0.5, seed=3)
    port_dir, pgm_dir = tmp_path / "gif", tmp_path / "pgm"
    os.makedirs(port_dir)
    os.makedirs(pgm_dir)
    for t, fmt in enumerate(("gray256", "gray256_interlaced", "gray256")):
        p = write(mf.encode_frame(fmt, grays[t]), f"frame_{t:04d}.gif",
                  str(port_dir))
        assert np.array_equal(cv2.imread(p, cv2.IMREAD_GRAYSCALE), grays[t])
        write(b"P5\n%d %d\n255\n" % (W, H) + grays[t].tobytes(),
              f"frame_{t:04d}.pgm", str(pgm_dir))
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pipeline.run_pipeline(str(pgm_dir), jax_out, op_point=2, batch=2,
                              mode="run_OF_INT", verbose=False)
    assert pipeline.run_pipeline(str(port_dir), out, op_point=2, batch=2,
                                 mode="run_OF_INT", verbose=False,
                                 device="cpu") == 2
    assert assert_files_match_jax(out, jax_out) == ["frame_0000.flo",
                                                   "frame_0001.flo"]


@pytest.mark.parametrize("mode", ["run_OF_INT", "run_OF_RGB"])
def test_gif_cli_matches_jax(tmp_path, mode):
    """The port's CLI and the JAX package's (whose `load_image` reads GIF
    through cv2) on the same two 256-gray GIF files."""
    grays = _shift_grays(2, 1.5, 0.5, seed=1)
    paths = [write(mf.encode_frame("gray256", g), f"f{t}.gif", str(tmp_path))
             for t, g in enumerate(grays)]
    ours, ref = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    cli.main([mode, *paths, ours, "2", "--quiet", "--device", "cpu"])
    jcli.main([mode, *paths, ref, "2", "--quiet"])
    got, want = uio.read_flo(ours), jio.read_flo(ref)
    assert got.shape == want.shape == (H, W, 2)
    epe = np.linalg.norm(got - want, axis=-1).mean() \
        / np.linalg.norm(want, axis=-1).mean()
    assert epe <= EPE_RATIO
