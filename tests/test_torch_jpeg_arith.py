"""The port's JPEG decoder (`csrc/jpeg.cpp`) on the streams cv2 reads that
cv2 and PIL do not write: arithmetic coding (SOF9, SOF10, DAC), lossless
frames (SOF3) and 4-component CMYK / YCCK files, pixel for pixel against
cv2.imread, and the serving pipeline and CLI on such frames against the
JAX package's.

Every file is written by libjpeg-turbo itself, through the fixture writer
`tests/torch_fixtures/jpeg/jpeg_writer.c` (built here by
`make_fixtures.build_writer` against the libjpeg-turbo that Pillow
bundles), or is such a file patched. Each read is held to cv2.imread of the
same file at tolerance 0: where cv2 reads, the decoder's planes,
`decode_batch`'s and the port's `load_image` equal cv2's (and the JAX
package's `load_image`); where cv2 fails, all three raise ValueError naming
the cause. The pipeline and CLI runs are held at the port-vs-JAX budget of
tests/test_torch_pipeline.py (EPE ratio 1e-3).
"""

import importlib.util
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
from of_dis_tpu_torch.native import io as nio  # noqa: E402
from of_dis_tpu_torch.utils import io as uio  # noqa: E402
from tests.test_torch_pipeline import assert_files_match_jax  # noqa: E402

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures", "jpeg")
_spec = importlib.util.spec_from_file_location(
    "jpeg_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
mf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mf)

EPE_RATIO = 1e-3
FAILS_TOO = "fails on it too"
SAMP = {"444": "1,1;1,1;1,1", "422": "2,1;1,1;1,1", "420": "2,2;1,1;1,1",
        "440": "1,2;1,1;1,1", "411": "4,1;1,1;1,1"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as the other pipeline test files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def writer(tmp_path_factory):
    return mf.build_writer(str(tmp_path_factory.mktemp("writer")))


def rgb(h, w, seed=0):
    """(h, w, 3) uint8 RGB of blurred random content."""
    return mf.blurred(h, w, seed)[..., ::-1]


def gray(h, w, seed=0):
    return cv2.cvtColor(mf.blurred(h, w, seed), cv2.COLOR_BGR2GRAY)


def cmyk(h, w, seed=0):
    """(h, w, 4) stored CMYK samples (cv2 shows them as about `rgb`)."""
    return mf.cmyk_of(mf.blurred(h, w, seed),
                      255 - mf.blurred(h, w, seed + 1)[..., 0] // 4)


def cv2_planes(path, channels):
    """cv2.imread's planes, (C, H, W), None where it fails."""
    flag = cv2.IMREAD_GRAYSCALE if channels == 1 else cv2.IMREAD_COLOR
    img = cv2.imread(path, flag)
    if img is None:
        return None
    return img[None] if img.ndim == 2 else img.transpose(2, 0, 1)


def held_to_cv2(tmp_path, raw, fails=(), match=FAILS_TOO):
    """`raw` written to a file: for each read cv2 takes, the decoder,
    `decode_batch` and the port's `load_image` give cv2.imread's planes
    (and the JAX package's `load_image`); the reads in `fails` (channel
    counts) cv2 fails on, and the port raises ValueError matching `match`
    there."""
    path = str(tmp_path / "a.jpg")
    with open(path, "wb") as f:
        f.write(raw)
    for ch in (1, 3):
        want = cv2_planes(path, ch)
        if ch in fails:
            assert want is None, f"cv2 reads channels {ch}"
            for fn in (lambda: nio.decode_jpeg(raw, ch),
                       lambda: nio.decode_batch([path], ch),
                       lambda: uio.load_image(path, ch)):
                with pytest.raises(ValueError, match=match):
                    fn()
            continue
        assert want is not None, f"cv2 fails on channels {ch}"
        got = nio.decode_jpeg(raw, ch)
        assert got.shape == want.shape, (ch, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"channels {ch}")
        np.testing.assert_array_equal(nio.decode_batch([path], ch)[0], want)
        ours = uio.load_image(path, ch)
        np.testing.assert_array_equal(ours, jio.load_image(path, ch))


def segments(raw):
    """(code, start) of each marker segment before the first SOS."""
    out, pos = [], 2
    while raw[pos + 1] != 0xDA:
        out.append((raw[pos + 1], pos))
        pos += 2 + struct.unpack(">H", raw[pos + 2:pos + 4])[0]
    return out


def sof_code(raw):
    """The frame's SOF marker code."""
    return next(c for c, _ in segments(raw)
                if 0xC0 <= c <= 0xCF and c not in (0xC4, 0xC8, 0xCC))


# ----------------------------------------------------------- arithmetic

# (h, w, content, sampling, restart, dac "L,U,K", quality)
ARITH = (
    [(61, 83, "rgb", s, 0, None, 90) for s in SAMP]
    + [(61, 83, "rgb", "420", r, None, 90) for r in (1, 3, 7)]
    + [(61, 83, "rgb", "420", 0, d, 90)
       for d in ("3,7,2", "0,0,63", "15,15,1", "1,2,20")]
    + [(h, w, "rgb", s, 0, None, 75) for (h, w) in ((1, 1), (7, 9), (5, 3),
                                                     (9, 5), (17, 33))
       for s in ("420", "422")]
    + [(61, 83, "rgb", "420", 0, None, q) for q in (5, 50, 100)]
    + [(h, w, "gray", None, r, None, 90) for (h, w) in ((7, 9), (61, 83))
       for r in (0, 2)]
    + [(437, 1023, "rgb", "420", 5, "2,4,1", 90)])


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("h,w,kind,samp,restart,dac,quality", ARITH)
def test_arithmetic_equals_cv2(tmp_path, writer, h, w, kind, samp, restart,
                               dac, quality, progressive):
    img = rgb(h, w, h + w) if kind == "rgb" else gray(h, w, h + w)
    params = {"arith": 1, "rst": restart, "q": quality,
              "prog": int(progressive)}
    if samp:
        params["samp"] = SAMP[samp]
    if dac:
        params["dac"] = dac
    raw = mf.write(writer, img, **params)
    assert sof_code(raw) == (0xCA if progressive else 0xC9)
    if dac:
        assert b"\xff\xcc" in raw
    held_to_cv2(tmp_path, raw)


def progression(rng, ncomp):
    """A random scan script that refines every coefficient to its last bit:
    DC (interleaved or one scan a component) with successive
    approximation, each component's AC in random spectral bands, each band
    its own successive approximation, the scans shuffled in legal order."""
    dc_al = int(rng.integers(0, 4))
    scans = ([(list(range(ncomp)), 0, 0, 0, dc_al)] if rng.random() < 0.5
             else [([c], 0, 0, 0, dc_al) for c in range(ncomp)])
    queues = [[(list(range(ncomp)), 0, 0, a + 1, a)
               for a in reversed(range(dc_al))]]
    for c in range(ncomp):
        cuts = sorted(set(rng.integers(2, 64, int(rng.integers(0, 4)))
                          .tolist()))
        edges = [1] + cuts + [64]
        for lo, hi in zip(edges[:-1], edges[1:]):
            al = int(rng.integers(0, 4))
            queues.append([([c], lo, hi - 1, 0, al)]
                          + [([c], lo, hi - 1, a + 1, a)
                             for a in reversed(range(al))])
    while any(queues):
        live = [q for q in queues if q]
        scans.append(live[int(rng.integers(0, len(live)))].pop(0))
    return "/".join(",".join(map(str, c)) + f":{ss}:{se}:{ah}:{al}"
                    for c, ss, se, ah, al in scans)


@pytest.mark.parametrize("seed", range(12))
def test_arithmetic_progression_scripts_equal_cv2(tmp_path, writer, seed):
    """Spectral selection and successive approximation, the place where
    an arithmetic decoder's refinement contexts drift: random scripts,
    gray and colour, with and without restarts."""
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(9, 70)), int(rng.integers(9, 90))
    colour = seed % 3 != 0
    img = rgb(h, w, seed) if colour else gray(h, w, seed)
    params = {"arith": 1, "scans": progression(rng, 3 if colour else 1),
              "q": int(rng.integers(30, 101)), "rst": int(seed % 4 == 1) * 3}
    if colour:
        params["samp"] = SAMP[("444", "420", "422")[seed % 3]]
    raw = mf.write(writer, img, **params)
    assert sof_code(raw) == 0xCA
    held_to_cv2(tmp_path, raw)


# ------------------------------------------------------------- lossless

# (h, w, precision, predictor, point transform, restart in MCU rows)
LOSSLESS_GRAY = (
    [(40, 64, 8, psv, pt, 0) for psv in range(1, 8) for pt in range(3)]
    + [(40, 64, p, 1 + p % 7, p % 2, 0) for p in range(2, 8)]
    + [(40, 64, 8, psv, 0, r) for psv in (1, 4, 7) for r in (1, 3)]
    + [(h, w, 8, 4, 0, 1) for (h, w) in ((1, 1), (7, 9), (1, 50), (50, 1))])


@pytest.mark.parametrize("h,w,precision,psv,pt,restart", LOSSLESS_GRAY)
def test_lossless_gray_equals_cv2(tmp_path, writer, h, w, precision, psv,
                                  pt, restart):
    """Predictors 1-7, point transforms 0-2, precisions 2-8 (samples
    returned unscaled, as libjpeg returns them), restarts of one and of
    several rows; the colour read is one cv2 fails on."""
    img = (gray(h, w, psv) >> (8 - precision)).astype(np.uint8)
    raw = mf.write(writer, img, lossless=f"{psv},{pt}", prec=precision,
                   rstrows=restart)
    assert sof_code(raw) == 0xC3
    held_to_cv2(tmp_path, raw, fails=(3,))
    if pt == 0:
        np.testing.assert_array_equal(nio.decode_jpeg(raw, 1)[0], img)


@pytest.mark.parametrize("psv,restart", [(psv, 0) for psv in range(1, 8)]
                         + [(2, 1), (6, 2)])
def test_lossless_rgb_equals_cv2(tmp_path, writer, psv, restart):
    """Three components: RGB (libjpeg writes no conversion in a lossless
    frame), read as colour exactly; the gray read is one cv2 fails on."""
    img = rgb(33, 47, psv)
    raw = mf.write(writer, img, lossless=f"{psv},{psv % 3}", rstrows=restart)
    held_to_cv2(tmp_path, raw, fails=(1,))
    if psv % 3 == 0:
        np.testing.assert_array_equal(nio.decode_jpeg(raw, 3),
                                      img[..., ::-1].transpose(2, 0, 1))


@pytest.mark.parametrize("psv", [1, 5])
def test_lossless_cmyk_equals_cv2(tmp_path, writer, psv):
    raw = mf.write(writer, cmyk(33, 47, psv), lossless=f"{psv},0",
                   space="cmyk")
    held_to_cv2(tmp_path, raw)


# ---------------------------------------------------------- CMYK, YCCK

@pytest.mark.parametrize("samp", ["1,1;1,1;1,1;1,1", "2,2;1,1;1,1;2,2"])
@pytest.mark.parametrize("coding", ["huffman", "arith", "prog", "arith_prog"])
@pytest.mark.parametrize("space,adobe", [("cmyk", 1), ("cmyk", 0),
                                         ("ycck", 1)])
def test_cmyk_and_ycck_equal_cv2(tmp_path, writer, space, adobe, coding,
                                 samp):
    """CMYK with libjpeg's Adobe marker (transform 0) or with none, and
    YCCK (transform 2, libjpeg's YCCK to CMYK), each then OpenCV's CMYK to
    BGR and to gray."""
    raw = mf.write(writer, cmyk(45, 70, len(coding)), space=space,
                   adobe=adobe, samp=samp, arith=int("arith" in coding),
                   prog=int("prog" in coding))
    assert (b"Adobe" in raw) == bool(adobe)
    held_to_cv2(tmp_path, raw)


@pytest.mark.parametrize("h,w", [(29, 41), (61, 83)])
def test_pil_cmyk_equals_cv2(tmp_path, h, w):
    """PIL's CMYK: Adobe transform 0, the samples stored inverted."""
    held_to_cv2(tmp_path, mf.pil_cmyk(cmyk(h, w, 3)))


@pytest.mark.parametrize("what", ["pil_cmyk", "ycck", "ycck_arith"])
def test_four_components_with_exif_orientation_6(tmp_path, writer, what):
    if what == "pil_cmyk":
        raw = mf.pil_cmyk(cmyk(29, 41, 5))
    else:
        raw = mf.write(writer, cmyk(29, 41, 5), space="ycck",
                       arith=int(what == "ycck_arith"))
    raw = raw[:2] + mf.exif_orientation(6) + raw[2:]
    held_to_cv2(tmp_path, raw)
    w, h, n = nio.jpeg_info(raw)
    assert (h, w, n) == (41, 29, 4)


# ------------------------------------------------------------ refusals

def _at(raw, code):
    return next(s for c, s in segments(raw) if c == code)


def _adobe(raw, transform):
    """`raw` with its Adobe APP14 transform byte set to `transform`."""
    b = bytearray(raw)
    b[_at(raw, 0xEE) + 4 + 11] = transform
    return bytes(b)


def _patch_marker(raw, old, new):
    b = bytearray(raw)
    b[_at(raw, old) + 1] = new
    return bytes(b)


def _dri(raw, interval):
    at = _at(raw, 0xDD)
    return raw[:at + 4] + struct.pack(">H", interval) + raw[at + 6:]


def _refusal(writer, case):
    """(file, reads cv2 fails on, what the port's error names)"""
    img, g, c4 = rgb(24, 40, 1), gray(24, 40, 1), cmyk(24, 40, 1)
    g12 = gray(24, 40, 1).astype(np.uint16) << 4
    if case == "dct_12bit":
        return mf.write(writer, np.dstack([g12] * 3), prec=12), (1, 3), \
            "12-bit.*" + FAILS_TOO
    if case == "arith_12bit":
        return mf.write(writer, g12, prec=12, arith=1), (1, 3), \
            "12-bit.*" + FAILS_TOO
    if case == "lossless_12bit":
        return mf.write(writer, g12, prec=12, lossless="1,0"), (1, 3), \
            "precision.*" + FAILS_TOO
    if case == "hierarchical_sof5":
        return _patch_marker(mf.write(writer, img), 0xC0, 0xC5), (1, 3), \
            "hierarchical.*" + FAILS_TOO
    if case == "hierarchical_sof13":
        return _patch_marker(mf.write(writer, img, arith=1), 0xC9, 0xCD), \
            (1, 3), "hierarchical.*" + FAILS_TOO
    if case == "lossless_arith_sof11":
        return _patch_marker(mf.write(writer, g, lossless="1,0"), 0xC3,
                             0xCB), (1, 3), "SOF11.*" + FAILS_TOO
    if case.startswith("two_components"):
        params = {"huffman": {}, "arith": {"arith": 1},
                  "lossless": {"lossless": "1,0"}}[case.split("_")[-1]]
        return mf.write(writer, img[..., :2], **params), (1, 3), \
            "2 or more than 4 components.*" + FAILS_TOO
    if case == "lossless_ycbcr_adobe1":
        return _adobe(mf.write(writer, img, lossless="1,0"), 1), (1, 3), \
            "YCbCr.*" + FAILS_TOO
    if case == "lossless_ycck_adobe2":
        return _adobe(mf.write(writer, c4, lossless="1,0", space="cmyk"), 2), \
            (1, 3), "YCCK.*" + FAILS_TOO
    if case == "lossless_restart_not_a_row":
        raw = mf.write(writer, g, lossless="1,0", rstrows=1)
        # the colour read fails on the colour space first
        return _dri(raw, 7), (1, 3), \
            "(restart interval|colour space).*" + FAILS_TOO
    raise AssertionError(case)


REFUSALS = ["dct_12bit", "arith_12bit", "lossless_12bit",
            "hierarchical_sof5", "hierarchical_sof13", "lossless_arith_sof11",
            "two_components_huffman", "two_components_arith",
            "two_components_lossless",
            "lossless_ycbcr_adobe1", "lossless_ycck_adobe2",
            "lossless_restart_not_a_row"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_name_the_cause(tmp_path, writer, case):
    """What cv2 fails on the port refuses with "cv::imread fails on it
    too", never returning other pixels."""
    raw, fails, match = _refusal(writer, case)
    path = str(tmp_path / "bad.jpg")
    with open(path, "wb") as f:
        f.write(raw)
    for ch in (1, 3):
        assert (cv2_planes(path, ch) is None) == (ch in fails), ch
        for fn in (lambda: nio.decode_jpeg(raw, ch),
                   lambda: nio.decode_batch([path], ch),
                   lambda: uio.load_image(path, ch)):
            with pytest.raises(ValueError, match=match):
                fn()


def _warned(writer, case):
    """A file libjpeg decodes with a warning, where cv2.imread returns the
    image: arithmetic-coded data cut short ("Premature end of JPEG file",
    read on as zeros past the fake EOI), an unknown Adobe transform (YCCK
    assumed for four components, YCbCr for three)."""
    img, c4 = rgb(24, 40, 1), cmyk(24, 40, 1)
    if case.startswith("cut_"):
        raw = mf.write(writer, img, arith=1, prog=int("prog" in case))
        return raw[:len(raw) * 2 // 3]
    if case == "cmyk_adobe_transform_1":
        return _adobe(mf.write(writer, c4, space="cmyk"), 1)
    if case == "ycbcr_adobe_transform_2":
        return _adobe(mf.write(writer, img, space="ycc", jfif=0, adobe=1), 2)
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["cut_arith", "cut_arith_prog",
                                  "cmyk_adobe_transform_1",
                                  "ycbcr_adobe_transform_2"])
def test_warned_reads_equal_cv2(tmp_path, writer, case):
    held_to_cv2(tmp_path, _warned(writer, case))


def _fuzz_sources():
    names = ("arith_restart7", "arith_progressive", "arith_dac",
             "arith_prog_gray", "lossless_gray_rst", "lossless_rgb",
             "lossless_gray_prec6", "ycck_arith_420", "cmyk_pil")
    out = []
    for name in names:
        with open(os.path.join(FIXTURES, "variants", f"{name}.jpg"),
                  "rb") as f:
            out.append(f.read())
    return out


_FUZZ = _fuzz_sources()


@settings(max_examples=300, deadline=None, derandomize=True,
          database=None)
@given(src=st.integers(0, len(_FUZZ) - 1),
       cut=st.one_of(st.none(), st.floats(0.0, 1.0)),
       flips=st.lists(st.tuples(st.floats(0.0, 1.0), st.integers(1, 255)),
                      max_size=3))
def test_corrupt_arithmetic_lossless_and_cmyk_raise_or_equal_cv2(src, cut,
                                                                 flips):
    """Cut and byte-flipped arithmetic, lossless and 4-component files
    against cv2.imread of the file: exactly its planes, or, where cv2 fails
    (or on a lossless component no scan holds, whose samples libjpeg
    leaves undefined), ValueError; never anything else."""
    raw = bytearray(_FUZZ[src])
    for where, mask in flips:
        raw[min(int(where * len(raw)), len(raw) - 1)] ^= mask
    if cut is not None:
        raw = raw[:max(1, int(cut * len(raw)))]
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
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------- pipeline and CLI vs JAX

H, W = 96, 128


def write_frames(writer, frame_dir, n, dx, dy, seed=0, **params):
    """Colour frames whose content translates by (dx, dy) px a frame,
    written by the fixture writer with `params` (arithmetic 4:2:0 by
    default)."""
    os.makedirs(frame_dir, exist_ok=True)
    params = params or {"arith": 1, "samp": SAMP["420"]}
    rng = np.random.default_rng(seed)
    big = cv2.GaussianBlur((rng.random((140, 180, 3)) * 255).astype(
        np.float32), (9, 9), 2.5)
    for t in range(n):
        m = np.float32([[1, 0, dx * t], [0, 1, dy * t]])
        f = cv2.warpAffine(big, m, (180, 140))[20:20 + H, 20:20 + W]
        bgr = np.clip(f, 0, 255).astype(np.uint8)
        if params.get("space") == "ycck":
            img = mf.cmyk_of(bgr, np.full((H, W), 240, np.uint8))
        elif params.get("lossless"):
            img = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
        else:
            img = bgr[..., ::-1]
        with open(os.path.join(frame_dir, f"frame_{t:04d}.jpg"), "wb") as fh:
            fh.write(mf.write(writer, img, **params))
    return str(frame_dir)


@pytest.mark.parametrize("mode", ["run_OF_INT", "run_OF_RGB"])
def test_arithmetic_pipeline_matches_jax(tmp_path, writer, mode):
    """Five arithmetic-coded frames (four pairs, batch 2) through both
    pipelines."""
    frame_dir = write_frames(writer, tmp_path / "frames", 5, 1.5, 0.5)
    jax_out, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pipeline.run_pipeline(frame_dir, jax_out, op_point=1, batch=2,
                              mode=mode, verbose=False)
    n = pipeline.run_pipeline(frame_dir, out, op_point=1, batch=2, mode=mode,
                              verbose=False, device="cpu")
    assert n == 4
    names = assert_files_match_jax(out, jax_out)
    for name in names:
        fl = uio.read_flo(os.path.join(out, name))
        med = np.median(fl[16:-16, 16:-16].reshape(-1, 2), axis=0)
        assert abs(med[0] - 1.5) < 0.4 and abs(med[1] - 0.5) < 0.4


@pytest.mark.parametrize("kind,mode", [("arith", "run_OF_INT"),
                                       ("arith", "run_OF_RGB"),
                                       ("lossless", "run_OF_INT"),
                                       ("ycck", "run_OF_RGB")])
def test_cli_matches_jax(tmp_path, writer, kind, mode):
    params = {"arith": {}, "lossless": {"lossless": "1,0"},
              "ycck": {"space": "ycck"}}[kind]
    frame_dir = write_frames(writer, tmp_path / "frames", 2, 1.5, 0.5,
                             seed=1, **params)
    a, b = (os.path.join(frame_dir, f"frame_{t:04d}.jpg") for t in (0, 1))
    ours, ref = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    cli.main([mode, a, b, ours, "2", "--quiet", "--device", "cpu"])
    jcli.main([mode, a, b, ref, "2", "--quiet"])
    got, want = uio.read_flo(ours), jio.read_flo(ref)
    assert got.shape == want.shape == (H, W, 2)
    epe = np.linalg.norm(got - want, axis=-1).mean() \
        / np.linalg.norm(want, axis=-1).mean()
    assert epe <= EPE_RATIO
