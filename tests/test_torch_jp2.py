"""The port's JPEG 2000 decoder (`utils.io.jp2_header`, the pixels by
`csrc/jp2.cpp`, through `native.io.decode_batch` and `utils.io.load_image`)
against cv2.imread, plane for plane, gray and colour; the files the port
refuses, by name; the fixtures' manifest (tests/torch_fixtures/jp2, which
chip_smoke.py part 7f holds the card machine's build to); and the serving
pipeline and CLI on JPEG 2000 frames against the JAX package's.

Files come from Pillow's and cv2's encoders (OpenJPEG), some with their
codestream edited by tests/torch_fixtures/jp2/make_fixtures.py's helpers.
Tolerance 0.
"""

import hashlib
import importlib.util
import json
import os
import struct
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pytest.importorskip("PIL.Image")
from hypothesis import given, settings, strategies as st  # noqa: E402

from of_dis_tpu import cli as jcli  # noqa: E402
from of_dis_tpu import pipeline as jax_pipeline  # noqa: E402
from of_dis_tpu.utils import io as jio  # noqa: E402
from of_dis_tpu_torch import cli, pipeline  # noqa: E402
from of_dis_tpu_torch.native import io as nio  # noqa: E402
from of_dis_tpu_torch.utils import io as uio  # noqa: E402
from tests.test_torch_pipeline import assert_files_match_jax  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures", "jp2")
_spec = importlib.util.spec_from_file_location(
    "jp2_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)

EPE_RATIO = 1e-3
_SCRATCH = tempfile.mkdtemp(prefix="jp2_cases_")


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


def write(raw, name="f.jp2", directory=None):
    p = os.path.join(directory or _SCRATCH, name)
    with open(p, "wb") as f:
        f.write(raw)
    return p


def assert_as_cv2(raw, name="f.jp2"):
    """Gray and colour: `decode_image` and `decode_batch` equal
    cv2.imread, or raise where it fails."""
    path = write(raw, name)
    for ch in (1, 3):
        want = cv2_planes(path, ch)
        if want is None:
            with pytest.raises(ValueError):
                nio.decode_image(raw, ch)
            continue
        got = nio.decode_image(raw, ch)
        assert got.shape == want.shape, (ch, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"channels {ch}")
        np.testing.assert_array_equal(nio.decode_batch([path], ch)[0], want)


RNG = np.random.default_rng(172)
_RGB = mf.smooth(RNG, 45, 61, 3)
_GRAY = np.ascontiguousarray(_RGB[..., 0])


# ----------------------------------------------------- manifest, frames

with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def _sha(planes):
    return hashlib.sha256(np.ascontiguousarray(planes).tobytes()).hexdigest()


def _assert_manifest(path, rec, jax_too=False):
    """The file's planes through `decode_batch` and `load_image` (which
    returns `decode_image`'s planes as float32) hash to the manifest's, as
    cv2.imread's do (where cv2 fails, the port raises); with `jax_too`,
    the JAX package's `load_image` (cv2) equals the port's."""
    for key, ch in (("gray", 1), ("color", 3)):
        if rec[key] is None:
            assert cv2_planes(path, ch) is None
            with pytest.raises(ValueError):
                nio.decode_batch([path], ch)
            with pytest.raises(ValueError):
                uio.load_image(path, ch)
            continue
        loaded = uio.load_image(path, ch)
        for planes in (cv2_planes(path, ch), nio.decode_batch([path], ch)[0],
                       loaded.astype(np.uint8)):
            assert list(planes.shape) == rec[key]["shape"]
            assert _sha(planes) == rec[key]["sha256"], (path, key)
        if jax_too:
            np.testing.assert_array_equal(loaded, jio.load_image(path, ch))


@pytest.mark.parametrize("rel", sorted(MANIFEST["files"]))
def test_fixture_manifest_matches_cv2_and_the_decoder(rel):
    """Every committed file: its hashes, which chip_smoke.py holds the
    card's build to, are cv2's (live here) and the port's through
    `decode_image`, `decode_batch` and `load_image`; where cv2 fails the
    port raises; the port's `load_image` is the JAX package's where cv2
    reads the file."""
    path = os.path.join(FIXTURES, rel)
    rec = MANIFEST["files"][rel]
    assert os.path.getsize(path) == rec["bytes"]
    _assert_manifest(path, rec, jax_too=True)


@pytest.mark.parametrize("directory", ["frames", "lossless"])
def test_served_frames_batch_on_a_pool(directory):
    """Part 7f's frame sets in one batch on a thread pool: each plane the
    manifest's; the lossless gray frames are the JPEG frames' own gray
    planes, the lossy ones within a few levels of them."""
    paths = pipeline.list_frames(os.path.join(FIXTURES, directory))
    assert len(paths) == (9 if directory == "frames" else 3)
    with ThreadPoolExecutor(3) as pool:
        batch = nio.decode_batch(paths, 1, pool=pool)
    grays = [g for g, _ in mf.jpeg_frames()]
    for t, (p, planes) in enumerate(zip(paths, batch)):
        rel = f"{directory}/{os.path.basename(p)}"
        assert _sha(planes) == MANIFEST["files"][rel]["gray"]["sha256"]
        diff = np.abs(planes[0].astype(int) - grays[t])
        if directory == "lossless":
            assert not diff.any()
        else:
            assert diff.mean() < 4


def test_fixtures_stay_small_and_regenerate():
    """Variants under 32 KB, the directory under 2 MB; with the OpenJPEG
    that wrote them, make_fixtures.py writes the same bytes again."""
    from PIL import features
    files = MANIFEST["files"]
    variants = [r for r in files if r.startswith("variants/")]
    assert len(variants) >= 40
    assert max(files[r]["bytes"] for r in variants) < 32_000
    assert sum(r["bytes"] for r in files.values()) < 2_000_000
    assert MANIFEST["motion_px"] == [1.3, 0.4]
    assert sum(r.startswith("frames/") for r in files) == 9
    assert sum(r.startswith("lossless/") for r in files) == 3
    if features.version("jpg_2000") == MANIFEST["openjpeg"]:
        for name, raw in mf.variants().items():
            with open(os.path.join(FIXTURES, "variants", name), "rb") as f:
                assert f.read() == raw, name


# ------------------------------------------------------------- features

def test_gray_is_cvtcolor_of_the_colour():
    """Gray of three components is OpenCV 5's cvtColor BGR2GRAY
    (1/32768ths) of the colour read, not its readers' 1/16384ths: a
    lossless file whose every colour rounds apart under the two rules."""
    raw = open(os.path.join(FIXTURES, "variants", "gray_rule.jp2"),
               "rb").read()
    assert_as_cv2(raw)
    b, g, r = nio.decode_image(raw, 3).astype(np.int64)
    np.testing.assert_array_equal(
        nio.decode_image(raw, 1)[0],
        (b * 3735 + g * 19235 + r * 9798 + 16384) >> 15)
    assert ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14 != (
        (b * 3735 + g * 19235 + r * 9798 + 16384) >> 15)).all()


def test_sixteen_bits_keep_their_high_byte():
    """16-bit samples come out shifted by 8 (the largest precision less
    8), as cv::imread brings them to 8 bits."""
    a = RNG.integers(0, 65536, (23, 37)).astype(np.uint16)
    raw = mf.pil_encode(a)
    assert_as_cv2(raw)
    np.testing.assert_array_equal(nio.decode_image(raw, 1)[0], a >> 8)


@pytest.mark.parametrize("h,w", [(1, 1), (1, 9), (7, 1), (2, 3), (33, 2)])
@pytest.mark.parametrize("irreversible", [False, True])
def test_small_and_thin_images(h, w, irreversible):
    """Images a few pixels a side, down to 1x1, where the wavelet's lines
    have one or two samples."""
    raw = mf.pil_encode(np.ascontiguousarray(_RGB[:h, :w]), num_resolutions=
                        min(3, 1 + int(np.log2(min(h, w)))) if min(h, w) > 1
                        else 1, irreversible=irreversible and min(h, w) > 1)
    assert_as_cv2(raw)


@pytest.mark.parametrize("ext", [".jp2", ".j2k"])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA"])
def test_modes_and_containers(mode, ext):
    """Gray, RGB, RGBA and gray + alpha, in a JP2 file and as a raw
    codestream: alpha dropped; a raw codestream of fewer than three
    components fails as colour in cv::imread (its colour space is unknown,
    read as sRGB) and is refused so."""
    arr = {"L": _GRAY, "RGB": _RGB,
           "RGBA": np.dstack([_RGB, _GRAY]),
           "LA": np.dstack([_GRAY, _RGB[..., 2]])}[mode]
    raw = mf.pil_encode(np.ascontiguousarray(arr), ext=ext)
    assert_as_cv2(raw, "f" + ext)
    if ext == ".j2k" and mode in ("L", "LA"):
        with pytest.raises(ValueError, match="cv::imread fails on it too"):
            nio.decode_image(raw, 3)


# ------------------------------------------------------------ refusals

def _with_tile_marker(raw):
    """A raw single-tile codestream with a COD marker in its tile-part
    header (Psot grown to match)."""
    at = raw.index(b"\xff\x90")
    cod = mf.cod_at(raw)
    seg = raw[cod:cod + 2 + struct.unpack(">H", raw[cod + 2:cod + 4])[0]]
    psot = struct.unpack(">I", raw[at + 6:at + 10])[0]
    head = raw[:at + 6] + struct.pack(">I", psot + len(seg)) + \
        raw[at + 10:at + 12]
    return head + seg + raw[at + 12:]


def _packets_past_tile_part(raw):
    """A raw single-tile codestream with 40 bytes of its tile-part's data
    taken out (and Psot shrunk): its packets run past the tile-part."""
    at = raw.index(b"\xff\x90")
    psot = struct.unpack(">I", raw[at + 6:at + 10])[0]
    end = at + psot
    return raw[:at + 6] + struct.pack(">I", psot - 40) + \
        raw[at + 10:end - 40] + raw[end:]


def _palette(raw):
    """A JP2 file with a pclr box in its jp2h (grown to match)."""
    box = b"pclr"
    body = struct.pack(">HB", 2, 1) + bytes([7]) + b"\x00\xff"
    pclr = struct.pack(">I", 8 + len(body)) + box + body
    at = raw.index(b"jp2h") - 4
    size = struct.unpack(">I", raw[at:at + 4])[0]
    colr = raw.index(b"colr") - 4
    colr_end = colr + struct.unpack(">I", raw[colr:colr + 4])[0]
    out = raw[:colr_end] + pclr + raw[colr_end:]
    return out[:at] + struct.pack(">I", size + len(pclr)) + out[at + 4:]


_J2K = mf.pil_encode(_RGB, ext=".j2k", num_resolutions=3)
_JP2 = mf.pil_encode(_RGB, num_resolutions=3)
_J2K16 = mf.pil_encode(RNG.integers(0, 65536, (9, 11)).astype(np.uint16),
                       ext=".j2k")
# (make, the refusal's words, whether cv2.imread fails on it too: None
# where it is not asserted)
REFUSALS = [
    (lambda: mf.patch_cod(_J2K, 8, 1), "code-block style BYPASS", None),
    (lambda: mf.patch_cod(_J2K, 8, 2), "code-block style RESET", None),
    (lambda: mf.patch_cod(_J2K, 8, 4), "code-block style TERMALL", None),
    (lambda: mf.patch_cod(_J2K, 8, 8), "code-block style VSC", None),
    (lambda: mf.patch_cod(_J2K, 8, 16), "code-block style PTERM", None),
    (lambda: mf.patch_cod(_J2K, 8, 32), "code-block style SEGSYM", None),
    (lambda: mf.patch_cod(_J2K, 8, 64), r"code-block style HT \(HTJ2K\)",
     None),
    (lambda: mf.patch_cod(_J2K, 0, 2), "SOP / EPH", None),
    (lambda: mf.patch_cod(_J2K, 0, 4), "SOP / EPH", None),
    (lambda: mf.insert_marker(_J2K, 0xFF5E, bytes([0, 0, 2])), "RGN",
     None),
    (lambda: mf.insert_marker(_J2K, 0xFF5F, bytes([0, 0, 0, 1, 3, 0])),
     "POC", None),
    (lambda: mf.insert_marker(_J2K, 0xFF60, bytes([0])), "PPM", None),
    (lambda: mf.insert_marker(_J2K, 0xFF50, struct.pack(">IH", 1 << 17, 0)),
     "CAP", None),
    (lambda: mf.patch_siz(_J2K, "rsiz", 0x4000), "HTJ2K codestream", None),
    (lambda: mf.patch_siz(_J2K, "rsiz", 0x8000), "Part 2 capabilities",
     None),
    (lambda: mf.patch_siz(_J2K16, "ssiz", 19), "precision 20", None),
    (lambda: mf.patch_siz(_J2K, "xrsiz", 2, comp=1), "subsampled 2x1",
     None),
    (lambda: _palette(_JP2), "palette", None),
    (lambda: mf.patch_colr(_JP2, 18), "sYCC", None),
    (lambda: _JP2.replace(b"colr\x01", b"colr\x02"), "ICC colour profile",
     None),
    (lambda: _JP2.replace(b"ftypjp2 ", b"ftypjpx "), "brand 'jpx '", None),
    (lambda: _J2K[:len(_J2K) // 2], "cut short", None),
    (lambda: _J2K[:-2], "cut short", None),
    (lambda: _JP2[:len(_JP2) - 30], "runs past its end", None),
    (lambda: _packets_past_tile_part(_J2K), "cut short", None),
    (lambda: _with_tile_marker(_J2K), "tile-part header marker", None),
    (lambda: mf.patch_siz(_J2K, "xsiz", (1 << 20) + 1),
     "above cv::imread's limits", True),
    (lambda: mf.patch_siz(_J2K, "xsiz", 1 << 20), r"samples \(above 2\^27\)",
     None),
    (lambda: mf.patch_siz(_J2K, "ssiz", 0x87), "signed component 0", True),
    (lambda: mf.patch_siz(_J2K, "xosiz", 3), r"image offset \(3, 0\)",
     True),
    (lambda: mf.five_components(_J2K), "image of 5 components", True),
    (lambda: mf.patch_colr(_JP2, 12), "colour space 12", True),
]


@pytest.mark.parametrize("make,match,cv2_fails", REFUSALS,
                         ids=[f"{k}-{r[1]}" for k, r in enumerate(REFUSALS)])
def test_refused_variants_raise_naming_them(make, match, cv2_fails):
    """Each refusal names the variant. Those cv2.imread fails on say so;
    those cv2.imread may read are listed in ROADMAP.md, Queue 3."""
    raw = make()
    path = write(raw, "bad.jp2")
    for ch in (1, 3):
        with pytest.raises(ValueError, match=match):
            nio.decode_image(raw, ch)
        if cv2_fails is not None:
            assert (cv2_planes(path, ch) is None) == cv2_fails, ch
    with pytest.raises(ValueError, match=match):
        uio.load_image(path, 1)


# ------------------------------------------------------------ hypothesis

@settings(max_examples=100, deadline=None, derandomize=True, database=None)
@given(h=st.integers(33, 97), w=st.integers(33, 97),
       mode=st.sampled_from(["L", "RGB", "RGBA"]),
       resolutions=st.integers(1, 5),
       tile=st.one_of(st.none(), st.tuples(st.integers(16, 100),
                                           st.integers(16, 100))),
       precinct=st.one_of(st.none(), st.tuples(st.integers(3, 7),
                                               st.integers(3, 7))),
       block=st.one_of(st.none(), st.tuples(st.integers(3, 6),
                                            st.integers(3, 6))),
       progression=st.sampled_from(["LRCP", "RLCP", "RPCL", "PCRL",
                                    "CPRL"]),
       layers=st.one_of(st.none(), st.lists(st.sampled_from(
           [2, 5, 10, 20, 40]), min_size=1, max_size=3, unique=True)),
       irreversible=st.booleans(), mct=st.booleans(), raw=st.booleans(),
       seed=st.integers(0, 2**16))
def test_pillow_options_equal_cv2(h, w, mode, resolutions, tile, precinct,
                                  block, progression, layers, irreversible,
                                  mct, raw, seed):
    """Any Pillow (OpenJPEG) encoding at 33-97 px: tiles with partial
    edges, precinct and code-block sizes, the five progressions, quality
    layers, resolution counts, 9/7 or 5/3, the component transform, JP2 or
    raw: the port equals cv2.imread."""
    rng = np.random.default_rng(seed)
    img = mf.smooth(rng, h, w, {"L": 1, "RGB": 3, "RGBA": 4}[mode],
                    sigma=float(rng.choice([0.6, 1.5, 4.0])))
    arr = img[..., 0] if mode == "L" else img
    opts = dict(num_resolutions=resolutions, progression=progression)
    if tile:
        opts["tile_size"] = tile
    if precinct:
        # a precinct of at least 2^resolutions, which no level halves to 1
        size = [max(1 << p, 1 << resolutions) for p in precinct]
        opts["precinct_size"] = tuple(size)
    if block and block[0] + block[1] <= 12:
        opts["codeblock_size"] = (1 << block[0], 1 << block[1])
    if layers:
        opts.update(quality_mode="rates",
                    quality_layers=sorted(layers, reverse=True))
    edges = [(d, t) for d, t in zip((w, h), tile or (w, h))]
    # OpenJPEG's 9/7 encoder asserts on a line of one sample
    if irreversible and all(t >= 1 << resolutions and (
            d % t == 0 or d % t >= 1 << resolutions) for d, t in edges):
        opts["irreversible"] = True
    if mct and mode != "L":
        opts["mct"] = 1
    data = mf.pil_encode(np.ascontiguousarray(arr),
                         ext=".j2k" if raw else ".jp2", **opts)
    assert_as_cv2(data, "hyp.j2k" if raw else "hyp.jp2")


_FUZZ_SOURCES = [
    mf.pil_encode(_RGB, num_resolutions=3, tile_size=(32, 24),
                  progression="RPCL", precinct_size=(16, 16),
                  codeblock_size=(8, 8)),
    mf.pil_encode(_RGB, ext=".j2k", irreversible=True, mct=1,
                  quality_layers=[20, 5], num_resolutions=4),
    mf.pil_encode(_GRAY, progression="CPRL", plt=True,
                  quality_layers=[40, 10, 2]),
    mf.pil_encode(np.dstack([_GRAY, _RGB[..., 1]]), num_resolutions=2),
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
    path = write(raw, "fuzz.jp2")
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


def _shift_frames(n, dx, dy, seed=0):
    """BGR planes of n frames whose content translates by (dx, dy) px a
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


def _encode(bgr, kind):
    rgb = np.ascontiguousarray(bgr[..., ::-1])
    if kind == "lossy":
        return mf.pil_encode(rgb, **mf.LOSSY)
    if kind == "raw":
        return mf.pil_encode(rgb, ext=".j2k", tile_size=(64, 48),
                             progression="RPCL")
    return mf.pil_encode(np.ascontiguousarray(bgr[..., 1]))


def test_jp2_pipeline_matches_jax(tmp_path):
    """Three JPEG 2000 frames (9/7 RGB, a raw 5/3 codestream in tiles,
    5/3 gray: two pairs, batch 2, gray flow) through the port's pipeline,
    against the JAX pipeline on the same gray planes as PGM (its pipeline
    lists no JPEG 2000; its `load_image` reads it through cv2, the CLI
    test)."""
    frames = _shift_frames(3, 1.5, 0.5, seed=3)
    port_dir, pgm_dir = tmp_path / "jp2", tmp_path / "pgm"
    os.makedirs(port_dir)
    os.makedirs(pgm_dir)
    for t, (kind, ext) in enumerate((("lossy", ".jp2"), ("raw", ".j2k"),
                                     ("gray", ".jp2"))):
        p = write(_encode(frames[t], kind), f"frame_{t:04d}{ext}",
                  str(port_dir))
        gray = cv2.imread(p, cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(nio.decode_batch([p], 1)[0, 0], gray)
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


def test_jp2_cli_matches_jax(tmp_path):
    """The port's CLI and the JAX package's (whose `load_image` reads JPEG
    2000 through cv2) on the same two lossy RGB JP2 files, read as gray
    (their colour reads are held to the JAX package's `load_image` with
    the fixtures)."""
    frames = _shift_frames(2, 1.5, 0.5, seed=1)
    paths = [write(_encode(f, "lossy"), f"f{t}.jp2", str(tmp_path))
             for t, f in enumerate(frames)]
    ours, ref = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    cli.main(["run_OF_INT", *paths, ours, "2", "--quiet", "--device",
              "cpu"])
    jcli.main(["run_OF_INT", *paths, ref, "2", "--quiet"])
    got, want = uio.read_flo(ours), jio.read_flo(ref)
    assert got.shape == want.shape == (H, W, 2)
    epe = np.linalg.norm(got - want, axis=-1).mean() \
        / np.linalg.norm(want, axis=-1).mean()
    assert epe <= EPE_RATIO
