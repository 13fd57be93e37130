"""The port's CCITT fax decoder (`csrc/tiff.cpp`'s FaxDecoder behind
`utils.io.tiff_ifd`: TIFF compressions 2, 3 and 4) against cv2.imread,
whose libtiff decodes them, pixel for pixel, gray and colour, through
`native.io.decode_image`, `decode_batch` and `utils.io.load_image`, and
against the JAX package's `load_image` (its cv2 route).

The streams come from libtiff's own encoder (through PIL,
tests/torch_fixtures/tiff/make_fixtures.py's `pil_fax` / `fax_tiff`), and
a few are put together here bit by bit where no encoder writes them (a
black run of 0, the corrupt ones). One row set codes every white and
every black run length 0-2,623 (the terminating, make-up and extended
make-up codes) in each codec. Tolerance 0.
"""

import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
pytest.importorskip("PIL.Image")

from of_dis_tpu import cli as jcli  # noqa: E402
from of_dis_tpu.utils import io as jio  # noqa: E402
from of_dis_tpu_torch import cli  # noqa: E402
from of_dis_tpu_torch.native import io as nio  # noqa: E402
from of_dis_tpu_torch.utils import io as uio  # noqa: E402
from tests.test_torch_tiff import (EPE_RATIO, _shift_planes,  # noqa: E402
                                   assert_as_cv2, cv2_planes, mf, write)

# (PIL compression, T4Options): Modified Huffman, Group 3 1-D, 1-D with
# fill bits, 2-D, 2-D with fill bits, Group 4
MODES = {"mh": ("tiff_ccitt", None), "g3_1d": ("group3", None),
         "g3_1d_fill": ("group3", 4), "g3_2d": ("group3", 1),
         "g3_2d_fill": ("group3", 5), "g4": ("group4", None)}
RNG = np.random.default_rng(191)


def _blobs(h, w, seed, level=128):
    """Bilevel shapes: smooth noise thresholded (True white)."""
    return mf._blur(h, w, 1, seed)[..., 0] >= level


def run_length_rows(two_d):
    """Rows of width 5,246 that hold white and black runs of every length
    0-2,623: row i is white i, black i, white 2,623 - i, black 2,623 - i.
    For a 2-D codec each follows an all-white row, so that the row is
    coded against a reference line without changes: in horizontal mode,
    every run by its run-length codes."""
    width = 2 * 2623
    rows = []
    for i in range(1312):
        black = np.zeros(width, bool)
        black[i:2 * i] = True
        black[2623 + i:] = True
        if two_d:
            rows.append(np.zeros(width, bool))
        rows.append(black)
    return ~np.array(rows)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_every_run_length_of_both_colours(mode):
    comp, opts = MODES[mode]
    two_d = comp == "group4" or (opts or 0) & 1
    pix = run_length_rows(two_d)
    raw = mf.fax_tiff(pix, comp, opts)
    assert_as_cv2(raw)
    got = nio.decode_image(raw, 1)[0]
    np.testing.assert_array_equal(got > 0, pix)      # MINISBLACK: as drawn


@pytest.mark.parametrize("density", [0.03, 0.5, 0.97])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_random_rows(mode, density):
    """Noise and shapes: the 2-D codecs' pass and vertical modes (every
    a1 - b1 of -3..3) besides horizontal runs."""
    comp, opts = MODES[mode]
    noise = RNG.random((31, 203)) < density
    shapes = _blobs(40, 203, int(density * 100))
    for pix in (noise, shapes, np.concatenate([shapes, noise])):
        assert_as_cv2(mf.fax_tiff(pix, comp, opts))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_layouts(mode):
    """Several rows a strip (each strip starts afresh against a white
    reference line), clipped tiles, FillOrder 2, MINISWHITE."""
    comp, opts = MODES[mode]
    pix = _blobs(37, 45, 3)
    for kw in ({"rows_per_strip": 5}, {"rows_per_strip": 1},
               {"tile": (32, 32)}, {"tile": (32, 16), "fill_order": 2},
               {"fill_order": 2, "rows_per_strip": 8},
               {"photometric": 0}, {"photometric": 0, "tile": (16, 32)}):
        assert_as_cv2(mf.fax_tiff(pix, comp, opts, **kw))


def test_libtiff_warns_on_its_own_short_rle_rows_at_a_tile_end():
    """Modified Huffman tiles 16 pixels wide: rows of a byte or two at the
    end of a tile's data, where libtiff's byte alignment counts bits past
    the end ("Premature EOL" on the tile's last row, its row filled in).
    libtiff only warns, and the port reads the tile as it does."""
    raw = mf.fax_tiff(_blobs(37, 45, 3), "tiff_ccitt", tile=(16, 16))
    path = write(raw, "short_rows.tif")
    assert cv2_planes(path, 1) is not None
    assert_as_cv2(raw)


@pytest.mark.parametrize("photometric", [0, 1])
@pytest.mark.parametrize("mode", ["mh", "g3_2d", "g4"])
def test_which_bit_a_white_run_makes(mode, photometric):
    """libtiff's fax decoder writes white runs as 0 bits whatever the
    photometric interpretation: MINISBLACK shows the code's white runs
    black (PIL's files invert their rows for it), MINISWHITE white."""
    comp, opts = MODES[mode]
    pix = _blobs(23, 37, 5)
    raw = mf.fax_tiff(pix, comp, opts, photometric=photometric)
    assert_as_cv2(raw)
    got = nio.decode_image(raw, 1)[0] > 0
    np.testing.assert_array_equal(got, pix if photometric else ~pix)


@pytest.mark.parametrize("orientation", [1, 2, 3, 4])
def test_orientation(orientation):
    pix = _blobs(37, 45, 7)
    for kw in ({"rows_per_strip": 8}, {"tile": (16, 16)}):
        assert_as_cv2(mf.fax_tiff(pix, "group4", orientation=orientation,
                                  **kw))


@pytest.mark.parametrize("width", [1, 2, 7, 31, 32, 33, 63, 65, 1729])
def test_odd_widths(width):
    """Rows of any width, alternating pixels among them (a row of W + 1
    runs: libtiff's run arrays hold the width plus one, rounded up to
    32)."""
    alternate = np.arange(width) % 2 == 0
    pix = np.stack([alternate, ~alternate, _blobs(3, width, width)[1],
                    np.ones(width, bool), np.zeros(width, bool)])
    for mode in ("mh", "g3_1d", "g3_2d", "g4"):
        assert_as_cv2(mf.fax_tiff(pix, *MODES[mode]))


def test_palette_and_uncompressed_mode_allowed():
    """A 1-bit palette read through the fax codec; T4Options bit 1 and
    T6Options bit 1 (uncompressed mode allowed) change nothing where no
    uncompressed run turns up."""
    pix = _blobs(21, 35, 9)
    assert_as_cv2(mf.fax_tiff(pix, "group4", photometric=3,
                              colormap=[[65535, 0, 0], [0, 0, 65535]]))
    for comp, opts in (("group3", 2), ("group3", 3), ("group4", 2)):
        assert_as_cv2(mf.fax_tiff(pix, comp, opts))


def test_libtiff_written_fax_fixtures():
    """The committed fax files (libtiff's encoder through PIL: each codec
    and Group 3 option, tiles, strips, FillOrder 2, MINISWHITE), which the
    manifest test of test_torch_tiff.py holds to cv2's hashes for the
    card's build: each read as cv2 reads it."""
    names = [n for n in os.listdir(os.path.join(mf.HERE, "variants"))
             if n.startswith(("pil_1_group", "pil_1_tiff_ccitt", "fax_"))]
    assert len(names) >= 9
    for name in names:
        with open(os.path.join(mf.HERE, "variants", name), "rb") as f:
            assert_as_cv2(f.read())


# --------------------------------------------------- streams put together

# a few T.4 code words, to put streams together that no encoder writes
WHITE = {0: "00110101", 2: "0111", 3: "1000", 4: "1011", 7: "1111"}
BLACK = {0: "0000110111", 1: "010", 2: "11", 3: "10", 5: "0011"}
EOL = "000000000001"


def _bytes(bits):
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _stream_tiff(bits, width, rows, compression, options=None):
    tags = () if options is None else ((292 if compression == 3 else 293,
                                        4, [options]),)
    return mf.tiff(np.zeros((rows, width), np.uint8), bits=1,
                   compression=compression, chunks=[_bytes(bits)],
                   photometric=0, extra_tags=tags)


def test_a_black_run_of_zero():
    """White 2, black 0, white 3, black 2: libtiff adds the two white runs
    up (no encoder writes a black run of 0)."""
    row = WHITE[2] + BLACK[0] + WHITE[3] + BLACK[2]   # 20 bits
    for raw in (_stream_tiff((row + "0" * 4) * 2, 7, 2, 2),
                _stream_tiff((EOL + row) * 2, 7, 2, 3)):
        assert_as_cv2(raw)
        np.testing.assert_array_equal(nio.decode_image(raw, 1)[0, 0],
                                      [255] * 5 + [0] * 2)


def test_rle_rows_start_on_bytes_and_g3_on_eols():
    """Modified Huffman rows start on a byte (what the padding holds is
    skipped); Group 3 rows after an EOL, fill bits or not. Near the end
    of the data libtiff counts bits it does not have as zeros, up to the
    width of its lookup: a byte alignment there lands elsewhere, and its
    next row reads as a bad code word (a warning; the port reads it as
    libtiff does)."""
    row = WHITE[4] + BLACK[3]           # 6 bits
    padded = row + "11"                 # the padding to a byte: skipped
    assert_as_cv2(_stream_tiff(padded * 3 + "0" * 16, 7, 3, 2))
    assert_as_cv2(_stream_tiff(padded * 3, 7, 3, 2))
    fill = "".join("0" * k + EOL + row for k in (0, 5, 17))
    assert_as_cv2(_stream_tiff(fill, 7, 3, 3))


# (stream bits, width, rows, compression, options, the fault libtiff warns
# about)
CORRUPT = {
    "premature EOL": (EOL + WHITE[2] + EOL + WHITE[7], 7, 2, 3, None,
                      "premature EOL"),
    "line length": (WHITE[3] + BLACK[5], 7, 1, 2, None,
                    "line length mismatch"),
    "bad code": ("0" * 16, 7, 1, 2, None, "bad code word"),
    "cut mid-row": (WHITE[2] + BLACK[3] + WHITE[2] + BLACK[2] + WHITE[4],
                    100, 1, 2, None, "bad code word"),
    "rows missing": (EOL + WHITE[7], 7, 2, 3, None, "premature EOF"),
    "no EOL": (WHITE[7], 7, 1, 3, None, "without its EOL"),
    "uncompressed 1-D": ("000000001111" + "0" * 12, 7, 1, 2, None,
                         "uncompressed mode"),
    "uncompressed 2-D": ("0000001111" + "0" * 14, 7, 1, 4, 2,
                         "uncompressed mode"),
    "2-D length": (EOL + "0" + "000011", 7, 1, 3, 1,   # VR2 past the end
                   "line length mismatch"),
}


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_corrupt_streams_raise_naming_the_fault(case):
    """Where libtiff only warns (and cv::imread takes what it read), the
    port reads the stream as libtiff does (these raised ValueError naming
    the fault until the port read damaged TIFFs): a bad code word ends
    its row, an EOL inside a row ends it too, an uncompressed-mode code
    (not supported by libtiff) is a bad code in 1-D and ends a 2-D row,
    data that end early end the strip."""
    bits, width, rows, comp, opts, _ = CORRUPT[case]
    raw = _stream_tiff(bits, width, rows, comp, opts)
    assert_as_cv2(raw)
    path = write(raw, "corrupt.tif")
    np.testing.assert_array_equal(uio.load_image(path, 1).astype(np.uint8),
                                  cv2_planes(path, 1))


def test_truncated_strips_raise_or_equal_cv2():
    """A Group 4 and a Group 3 strip cut at every tenth byte: exactly
    cv2's planes (a ValueError is no longer expected)."""
    pix = _blobs(29, 61, 11)
    for comp, opts in (("group4", None), ("group3", 1), ("tiff_ccitt", None)):
        whole = mf.pil_fax(pix, comp, opts)
        for cut in range(1, len(whole), max(1, len(whole) // 10)):
            raw = mf.fax_tiff(pix, comp, opts)
            raw = raw.replace(whole, whole[:cut] + bytes(len(whole) - cut))
            path = write(raw, "cut.tif")
            for ch in (1, 3):
                np.testing.assert_array_equal(nio.decode_image(raw, ch),
                                              cv2_planes(path, ch))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_fax_of_more_than_one_bit_is_refused_as_cv2_fails(bits):
    raw = mf.tiff(np.zeros((5, 7), np.uint8), bits=bits, compression=4,
                  chunks=[b"\0" * 8])
    path = write(raw, "bits.tif")
    for ch in (1, 3):
        assert cv2_planes(path, ch) is None
        with pytest.raises(ValueError, match="cv::imread fails on it too"):
            nio.decode_image(raw, ch)


def test_fax_cli_matches_jax(tmp_path):
    """Two Group 4 frames (a thresholded frame moving 1.5, 0.5 px) through
    the port's CLI and the JAX package's (whose `load_image` reads them
    through cv2), gray flow at op-2."""
    planes = _shift_planes(2, 1.5, 0.5, seed=3)
    paths = [write(mf.fax_tiff(gray >= 128, "group4"), f"f{t}.tif",
                   str(tmp_path)) for t, (gray, _) in enumerate(planes)]
    ours, ref = str(tmp_path / "port.flo"), str(tmp_path / "jax.flo")
    cli.main(["run_OF_INT", *paths, ours, "2", "--quiet", "--device", "cpu"])
    jcli.main(["run_OF_INT", *paths, ref, "2", "--quiet"])
    got, want = uio.read_flo(ours), jio.read_flo(ref)
    assert got.shape == want.shape
    epe = np.linalg.norm(got - want, axis=-1).mean() \
        / np.linalg.norm(want, axis=-1).mean()
    assert epe <= EPE_RATIO
