"""The port's YCbCr TIFF decoder without JPEG (`csrc/tiff.cpp`: libtiff's
RGBA reader, tif_color.c's fixed-point YCbCr to RGB over the file's
YCbCrCoefficients and ReferenceBlackWhite, tif_getimage.c's
putcontig8bitYCbCr*tile block layouts) and the 4-sample JPEG-in-TIFF
(RGB with an extra sample, CMYK: `csrc/jpeg.cpp`'s `of_jpeg_decode_tiff`
with no colour transform, then libtiff's alpha and CMYK rules) against
cv2.imread, pixel for pixel, gray and colour, through
`native.io.decode_image`, `decode_batch` and `utils.io.load_image`, and
against the JAX package's `load_image` (its cv2 route).

The YCbCr files come from the numpy writer of tests/torch_fixtures/tiff/
make_fixtures.py (`ycbcr_tiff`) and from PIL; the JPEG-in-TIFF ones from
PIL (libtiff's JPEG codec) and from the JPEG fixtures' bitstreams.
Tolerance 0.
"""

import io as _io
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

from of_dis_tpu import cli as jcli  # noqa: E402
from of_dis_tpu import pipeline as jax_pipeline  # noqa: E402
from of_dis_tpu.utils import io as jio  # noqa: E402
from of_dis_tpu_torch import cli, pipeline  # noqa: E402
from of_dis_tpu_torch.native import io as nio  # noqa: E402
from of_dis_tpu_torch.utils import io as uio  # noqa: E402
from tests.test_torch_pipeline import assert_files_match_jax  # noqa: E402
from tests.test_torch_tiff import (EPE_RATIO, H, W,  # noqa: E402
                                   _shift_planes, assert_as_cv2, cv2_planes,
                                   mf, write)

SUBSAMPLINGS = [(4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)]
Y_VALUES = (0, 16, 128, 235, 255)
REC709 = [(2126, 10000), (7152, 10000), (722, 10000)]
STUDIO = [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)]
PIL_REF_BW = [(0, 1), (255, 1), (128, 1), (255, 1), (128, 1), (255, 1)]
COLOUR = mf._blur(27, 39, 3, 17)


def chroma_plane_blocks(h, v):
    """Blocks (256 x 256k, h * v + 2) holding every (Cb, Cr) pair once for
    each group of k block columns, the luma samples cycling through
    Y_VALUES so that each pair meets each of them."""
    per = h * v
    groups = -(-len(Y_VALUES) // per)
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    blocks = []
    for g in range(groups):
        luma = np.array([Y_VALUES[(g * per + k) % len(Y_VALUES)]
                         for k in range(per)])
        blocks.append(np.concatenate([np.broadcast_to(luma, (256, 256, per)),
                                      cb[..., None], cr[..., None]], 2))
    return np.concatenate(blocks, 1)


def blocks_tiff(blocks, h, v, **kw):
    """A one-strip YCbCr TIFF of these blocks, as they are."""
    rows, cols = blocks.shape[0] * v, blocks.shape[1] * h
    return mf.tiff(np.zeros((rows, cols, 3), np.uint8), photometric=6,
                   chunks=[blocks.astype(np.uint8).tobytes()],
                   ycbcr_subsampling=(h, v), **kw)


@pytest.mark.parametrize("sub", SUBSAMPLINGS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_whole_chroma_plane_at_five_lumas(sub):
    """Every (Cb, Cr) at Y 0, 16, 128, 235 and 255 under each subsampling:
    libtiff's float32 coefficient arithmetic and its clamps."""
    raw = blocks_tiff(chroma_plane_blocks(*sub), *sub)
    assert_as_cv2(raw)


@pytest.mark.parametrize("coefficients", ["default", "pil", "rec709",
                                          "studio", "rec709_studio"])
def test_coefficients_and_reference_black_and_white(coefficients):
    """YCbCrCoefficients and ReferenceBlackWhite absent (libtiff's
    defaults), PIL's, Rec. 709's, studio range: RATIONALs read into C
    floats, over the whole (Cb, Cr) plane."""
    luma, ref_bw = {"default": (None, None), "pil": (None, PIL_REF_BW),
                    "rec709": (REC709, None), "studio": (None, STUDIO),
                    "rec709_studio": (REC709, STUDIO)}[coefficients]
    extra = []
    if luma is not None:
        extra.append((529, 5, luma))
    if ref_bw is not None:
        extra.append((532, 5, ref_bw))
    for sub in ((2, 2), (1, 1)):
        raw = blocks_tiff(chroma_plane_blocks(*sub), *sub,
                          extra_tags=extra)
        assert_as_cv2(raw)


@pytest.mark.parametrize("sub", SUBSAMPLINGS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_partial_blocks_in_strips(sub):
    """Sizes that are not whole blocks, strips of rows that are not whole
    blocks either (each strip's blocks its own; libtiff reads a strip's
    rows rounded up to blocks times TIFFScanlineSize, which for 4x4 drops
    the last Cb and Cr of a block row whose bytes do not divide by 4)."""
    ycc = mf.rgb_to_ycbcr(COLOUR)
    for (h, w) in ((27, 39), (13, 10), (9, 7), (1, 1), (5, 21), (16, 16)):
        for rps in (h, 3, 4, 8):
            assert_as_cv2(mf.ycbcr_tiff(ycc[:h, :w], sub, rows_per_strip=rps))


@pytest.mark.parametrize("sub", SUBSAMPLINGS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_clipped_tiles(sub):
    """Tiles the image cuts on the right and at the bottom: libtiff's put
    routines step over a clipped tile's blocks by (skipped pixels / h)
    times their own block size, 10 bytes for 4x4 (not 18)."""
    ycc = mf.rgb_to_ycbcr(mf._blur(37, 61, 3, 3))
    for tile in ((16, 16), (32, 16), (16, 32)):
        assert_as_cv2(mf.ycbcr_tiff(ycc, sub, tile=tile, compression=5))


@pytest.mark.parametrize("compression", [1, 5, 8, 32773, 32946])
def test_compressions(compression):
    ycc = mf.rgb_to_ycbcr(COLOUR)
    for sub in ((2, 1), (4, 4), (1, 1)):
        assert_as_cv2(mf.ycbcr_tiff(ycc, sub, compression=compression,
                                    rows_per_strip=8))
    if compression in (5, 8, 32946):        # predictor 2 over 1x1
        assert_as_cv2(mf.ycbcr_tiff(ycc, (1, 1), compression=compression,
                                    predictor=2))


@pytest.mark.parametrize("orientation", [1, 2, 3, 4])
def test_orientation(orientation):
    ycc = mf.rgb_to_ycbcr(COLOUR)
    for kw in ({"rows_per_strip": 8}, {"tile": (16, 16)}):
        assert_as_cv2(mf.ycbcr_tiff(ycc, (2, 2), orientation=orientation,
                                    **kw))


def test_default_subsampling_and_big_endian():
    """No YCbCrSubSampling tag: libtiff's 2x2; a big-endian BigTIFF."""
    ycc = mf.rgb_to_ycbcr(COLOUR)
    assert_as_cv2(mf.ycbcr_tiff(ycc, (2, 2), omit_subsampling=True))
    assert_as_cv2(mf.ycbcr_tiff(ycc, (4, 2), big=True, big_endian=True,
                                compression=8))


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "packbits",
                                         "tiff_deflate",
                                         "tiff_adobe_deflate"])
def test_pil_ycbcr(compression):
    """PIL's YCbCr mode (1x1, ReferenceBlackWhite as RATIONALs)."""
    buf = _io.BytesIO()
    Image.fromarray(mf._blur(33, 41, 3, 4).astype(np.uint8), "YCbCr").save(
        buf, "TIFF", compression=compression)
    assert_as_cv2(buf.getvalue())


# ------------------------------------------------------------- refusals

def _luma_tag(values):
    return mf.ycbcr_tiff(mf.rgb_to_ycbcr(COLOUR), (2, 2),
                         extra_tags=((529, 5, values),))


# (make, the refusal's words, whether cv2.imread fails on it too)
REFUSALS = [
    (lambda: mf.ycbcr_tiff(mf.rgb_to_ycbcr(COLOUR), (1, 4)),
     "subsampling 1x4", True),
    (lambda: mf.ycbcr_tiff(mf.rgb_to_ycbcr(COLOUR), (2, 4)),
     "subsampling 2x4", True),
    (lambda: mf.ycbcr_tiff(mf.rgb_to_ycbcr(COLOUR), (4, 4),
                           extra_tags=((530, 3, [3, 3]),)),
     "subsampling 3x3", True),
    (lambda: _luma_tag([(299, 1000), (0, 1), (114, 1000)]),
     "YCbCrCoefficients", True),
    (lambda: mf.tiff(mf.rgb_to_ycbcr(COLOUR), photometric=6, planar=True,
                     ycbcr_subsampling=(1, 1)), "planar YCbCr", None),
    (lambda: mf.tiff(mf.rgb_to_ycbcr(COLOUR) * 257, bits=16,
                     photometric=6, ycbcr_subsampling=(1, 1)),
     "YCbCr TIFF of 3 16-bit", None),
    (lambda: mf.ycbcr_tiff(mf.rgb_to_ycbcr(COLOUR), (2, 2), compression=5,
                           extra_tags=((317, 3, [2]),)),
     "predictor 2 over subsampled YCbCr", None),
    (lambda: _luma_tag([(299, 1000), (587, 1000)]), "tag 529 of type 5",
     None),
]


@pytest.mark.parametrize("make,match,cv2_fails", REFUSALS,
                         ids=[r[1] for r in REFUSALS])
def test_refused_variants_raise_naming_them(make, match, cv2_fails):
    raw = make()
    path = write(raw, "bad_ycc.tif")
    for ch in (1, 3):
        with pytest.raises(ValueError, match=match):
            nio.decode_image(raw, ch)
        if cv2_fails is not None:
            assert (cv2_planes(path, ch) is None) == cv2_fails, ch
    if cv2_fails:
        with pytest.raises(ValueError, match="cv::imread fails on it too"):
            nio.decode_image(raw, 1)


# --------------------------------------------- 4-sample JPEG-in-TIFF

@pytest.mark.parametrize("quality", [95, 75, 30])
@pytest.mark.parametrize("mode", ["RGBA", "CMYK"])
def test_pil_four_sample_jpeg_tiff(mode, quality):
    """PIL's RGBA (photometric RGB, ExtraSamples 2: unassociated alpha,
    premultiplied) and CMYK JPEG-in-TIFF: libtiff has libjpeg return the
    four components as they are (no Adobe marker, no transform)."""
    rng = np.random.default_rng(quality)
    pix = np.concatenate([mf._blur(37, 45, 3, quality),
                          rng.integers(0, 256, (37, 45, 1))], 2)
    buf = _io.BytesIO()
    Image.fromarray(pix.astype(np.uint8), mode).save(
        buf, "TIFF", compression="jpeg", quality=quality)
    assert_as_cv2(buf.getvalue())


@pytest.mark.parametrize("name", ["cmyk_adobe", "cmyk_no_adobe", "ycck"])
def test_four_component_jpeg_streams_in_tiff(name):
    """The JPEG fixtures' CMYK and YCCK bitstreams as photometric-5 JPEG
    strips: libtiff sets libjpeg's colour space to unknown, so an Adobe
    marker's transform is not applied; and it takes only 1x1 sampling
    for a photometric other than YCbCr (the YCCK stream is 2x2: cv2 fails
    on it, "Improper JPEG sampling factors")."""
    with open(os.path.join(mf.JPEG_DIR, "variants", f"{name}.jpg"),
              "rb") as f:
        jpg = f.read()
    h, w = cv2.imdecode(np.frombuffer(jpg, np.uint8), 0).shape
    raw = mf.jpeg_tiff(jpg, w, h, None, photometric=5)
    if name != "ycck":
        assert_as_cv2(raw)
        return
    path = write(raw, "ycck.tif")
    for ch in (1, 3):
        assert cv2_planes(path, ch) is None
        with pytest.raises(ValueError, match="sampling factors"):
            nio.decode_image(raw, ch)


def test_jpeg_tiff_of_two_samples_stays_refused():
    buf = _io.BytesIO()
    Image.fromarray(mf._blur(21, 23, 3, 8).astype(np.uint8)).convert(
        "LA").save(buf, "TIFF", compression="jpeg")
    with pytest.raises(ValueError, match="JPEG TIFF other than"):
        nio.decode_image(buf.getvalue(), 1)


# ---------------------------------------------- pipeline and CLI

def _ycbcr_frame(bgr):
    return mf.ycbcr_tiff(mf.rgb_to_ycbcr(bgr[::-1].transpose(1, 2, 0)),
                         (2, 1), compression=5, rows_per_strip=16)


def test_ycbcr_pipeline_matches_jax(tmp_path):
    """Three 2x1 YCbCr LZW frames (two pairs, batch 2, gray flow) through
    the port's pipeline, against the JAX pipeline on cv2's gray planes of
    the same files as PGM (its pipeline lists no TIFF)."""
    planes = _shift_planes(3, 1.5, 0.5, seed=5)
    port_dir, pgm_dir = tmp_path / "tiff", tmp_path / "pgm"
    os.makedirs(port_dir)
    os.makedirs(pgm_dir)
    for t, (_, bgr) in enumerate(planes):
        p = write(_ycbcr_frame(bgr), f"frame_{t:04d}.tif", str(port_dir))
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


def test_four_sample_jpeg_cli_matches_jax(tmp_path):
    """The port's CLI and the JAX package's (whose `load_image` reads
    these files through cv2) on an RGBA then a CMYK JPEG-in-TIFF frame
    (PIL's), RGB flow."""
    planes = _shift_planes(2, 1.5, 0.5, seed=6)
    paths = []
    for t, ((_, bgr), mode) in enumerate(zip(planes, ("RGBA", "CMYK"))):
        buf = _io.BytesIO()
        Image.fromarray(np.ascontiguousarray(bgr[::-1].transpose(
            1, 2, 0))).convert(mode).save(buf, "TIFF", compression="jpeg")
        paths.append(write(buf.getvalue(), f"f{t}.tif", str(tmp_path)))
    ours, ref = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    cli.main(["run_OF_RGB", *paths, ours, "2", "--quiet", "--device", "cpu"])
    jcli.main(["run_OF_RGB", *paths, ref, "2", "--quiet"])
    got, want = uio.read_flo(ours), jio.read_flo(ref)
    assert got.shape == want.shape == (H, W, 2)
    epe = np.linalg.norm(got - want, axis=-1).mean() \
        / np.linalg.norm(want, axis=-1).mean()
    assert epe <= EPE_RATIO
