"""The port's batch frame decoder (`of_dis_tpu_torch.native.io`, C entries
in `csrc/io_native.cpp`, built here with the host compiler) against its
`utils.io.load_image` and the JAX package's native `decode_batch`, bit for
bit (a colour PNG read as gray against cv2.imread and the JAX package's
cv2 route instead): every PNG row filter, gray, gray+alpha, RGB and RGBA,
PGM and PPM, frames written by OpenCV and PIL, a thread pool against a
serial run, and the inputs it must refuse."""

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import pytest

from of_dis_tpu.native import io as jax_native_io
from of_dis_tpu.utils import io as jax_io
from of_dis_tpu_torch.kernels import build
from of_dis_tpu_torch.native import io as nio
from of_dis_tpu_torch.utils import io as uio

COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}   # channels -> PNG color type


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(kind, row, up, bpp):
    """One scanline filtered by `kind` (0-4), byte by byte as the PNG
    spec writes it."""
    out = []
    for x, v in enumerate(row):
        a = int(row[x - bpp]) if x >= bpp else 0
        b = int(up[x])
        c = int(up[x - bpp]) if x >= bpp else 0
        pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
        out.append((int(v) - pred) & 0xFF)
    return bytes([kind] + out)


def write_png(path, pix, kinds):
    """An 8-bit PNG of pix (H, W, nch), row y filtered by kinds[y % len]."""
    h, w, nch = pix.shape
    rows = pix.reshape(h, w * nch)
    up = np.zeros(w * nch, np.uint8)
    data = b""
    for y in range(h):
        data += _filter_row(kinds[y % len(kinds)], rows[y], up, nch)
        up = rows[y]

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, COLOR_TYPE[nch], 0, 0, 0)
    with open(path, "wb") as f:
        # the image data in two IDAT chunks, as encoders may split it
        z = zlib.compress(data)
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", z[:len(z) // 2])
                + chunk(b"IDAT", z[len(z) // 2:]) + chunk(b"IEND", b""))
    return str(path)


def _frame(seed, h=23, w=37, nch=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, nch), dtype=np.uint8)


def _colour_png(path):
    with open(path, "rb") as f:
        head = f.read(26)
    return head[:8] == b"\x89PNG\r\n\x1a\n" and head[25] & 2


def _check(paths, channels, pool=None):
    """decode_batch == the JAX package's decode_batch; a colour PNG read
    as gray == cv2.imread == the JAX package's cv2 route (`load_image`
    without its native decoder). The JAX native decoder converts a colour
    PNG to gray by OpenCV's BGR2GRAY, where cv::imread takes libpng's
    rgb_to_gray: on 8-bit RGB noise 1,028 of 2,000 pixels differ, each by
    one level. The port's `load_image` runs the same C decoder as
    `decode_batch`: the two entry points must agree, which holds the
    wiring between them, not the decoder."""
    ours = nio.decode_batch(paths, channels, pool=pool)
    single = np.stack([uio.load_image(p, channels) for p in paths])
    assert ours.dtype == np.uint8 and ours.shape == single.shape
    np.testing.assert_array_equal(ours, single.astype(np.uint8))
    for k, p in enumerate(paths):
        if channels == 1 and _colour_png(p):
            cv2 = pytest.importorskip("cv2")
            np.testing.assert_array_equal(
                ours[k, 0], cv2.imread(p, cv2.IMREAD_GRAYSCALE))
            with mock.patch.object(jax_io, "_native_io", None):
                ref = jax_io.load_image(p, 1)
        else:
            ref = jax_native_io.decode_batch([p], channels,
                                             dtype=np.uint8)[0]
        np.testing.assert_array_equal(ours[k], ref)
    return ours


@pytest.mark.parametrize("nch", [1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3])
def test_every_filter_and_color_type(tmp_path, nch, channels):
    paths = [write_png(tmp_path / f"f{k}.png", _frame(k, nch=nch),
                       kinds=[(y + k) % 5 for y in range(5)])
             for k in range(3)]
    # one frame with every row under one filter, each of the five
    paths += [write_png(tmp_path / f"only{k}.png", _frame(10 + k, nch=nch),
                        kinds=[k]) for k in range(5)]
    ours = _check(paths, channels)
    if channels == 3 and nch >= 3:      # BGR planes of the RGB pixels
        np.testing.assert_array_equal(
            ours[0], _frame(0, nch=nch)[..., 2::-1].transpose(2, 0, 1))


def test_gray_frame_is_itself(tmp_path):
    pix = _frame(3)
    p = write_png(tmp_path / "g.png", pix, kinds=[4])
    np.testing.assert_array_equal(nio.decode_batch([p], 1)[0, 0],
                                  pix[..., 0])


def test_pgm_and_ppm(tmp_path):
    for nch, magic in ((1, b"P5"), (3, b"P6")):
        pix = _frame(nch, nch=nch)
        p = str(tmp_path / f"f{nch}.pnm")
        with open(p, "wb") as f:
            f.write(magic + b"\n# a comment\n%d %d\n255\n" % (37, 23)
                    + pix.tobytes())
        for channels in (1, 3):
            _check([p, p], channels)


def test_opencv_and_pil_frames(tmp_path):
    cv2 = pytest.importorskip("cv2")
    image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(7)
    img = cv2.GaussianBlur((rng.random((61, 83, 3)) * 255).astype(np.uint8),
                           (5, 5), 1.5)
    pc, pp = str(tmp_path / "cv.png"), str(tmp_path / "pil.png")
    cv2.imwrite(pc, img)
    image.fromarray(img).save(pp)
    pg = str(tmp_path / "pil_gray.png")
    image.fromarray(img[..., 1]).save(pg)
    for channels in (1, 3):
        _check([pc, pp, pg], channels)
    # colour frames in BGR order, as cv::imread(COLOR) gives them
    np.testing.assert_array_equal(nio.decode_batch([pc], 3)[0],
                                  cv2.imread(pc).transpose(2, 0, 1))


def test_thread_pool_equals_serial(tmp_path):
    paths = [write_png(tmp_path / f"f{k}.png", _frame(k, 40, 64, 3),
                       kinds=[0, 1, 2, 3, 4]) for k in range(12)]
    serial = nio.decode_batch(paths, 3)
    with ThreadPoolExecutor(4) as pool:
        pooled = nio.decode_batch(paths, 3, pool=pool)
    np.testing.assert_array_equal(pooled, serial)
    _check(paths, 1)


def test_out_buffer_is_filled_in_place(tmp_path):
    paths = [write_png(tmp_path / f"f{k}.png", _frame(k), kinds=[4])
             for k in range(2)]
    out = np.zeros((2, 1, 23, 37), np.uint8)
    assert nio.decode_batch(paths, 1, out=out) is out
    np.testing.assert_array_equal(out, nio.decode_batch(paths, 1))
    with pytest.raises(ValueError, match="frame in a batch"):
        nio.decode_batch(paths, 1, out=np.zeros((2, 1, 23, 36), np.uint8))


def test_truncated_jpeg_and_mixed_sizes_raise(tmp_path):
    p = write_png(tmp_path / "a.png", _frame(0), kinds=[1])
    cut = tmp_path / "cut.png"
    cut.write_bytes(open(p, "rb").read()[:20])
    with pytest.raises(ValueError, match="truncated"):
        nio.decode_batch([str(cut)], 1)
    half = tmp_path / "half.png"
    raw = open(p, "rb").read()
    half.write_bytes(raw[:len(raw) - 40])
    with pytest.raises(ValueError):
        nio.decode_batch([p, str(half)], 1)
    jpg = tmp_path / "a.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 64)
    with pytest.raises(ValueError, match="JPEG"):
        nio.decode_batch([str(jpg)], 1)
    small = write_png(tmp_path / "small.png", _frame(1, 22, 37), kinds=[0])
    with pytest.raises(ValueError, match="frame in a batch"):
        nio.decode_batch([p, small], 1)


def test_unknown_filter_type_raises(tmp_path):
    p = write_png(tmp_path / "a.png", _frame(0), kinds=[0])
    raw = open(p, "rb").read()
    png = uio.png_chunks(raw)
    rows = bytearray(png.data)
    rows[5 * (png.width + 1)] = 7        # row 5 under filter type 7
    z = zlib.compress(bytes(rows))
    bad = tmp_path / "bad.png"
    bad.write_bytes(raw[:33] + struct.pack(">I", len(z)) + b"IDAT" + z
                    + struct.pack(">I", zlib.crc32(b"IDAT" + z))
                    + struct.pack(">I", 0) + b"IEND"
                    + struct.pack(">I", zlib.crc32(b"IEND")))
    with pytest.raises(ValueError, match="row 5: unknown filter type"):
        nio.decode_batch([str(bad)], 1)
    with pytest.raises(ValueError, match="bad PNG filter"):
        uio.load_image(str(bad), 1)


def test_a_library_that_does_not_build_raises(monkeypatch, tmp_path):
    """No fallback to the Python decoder: a build failure is an error."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "io_native.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "SRC_DIR", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_host_libs", {})
    p = write_png(tmp_path / "a.png", _frame(0), kinds=[0])
    with pytest.raises(RuntimeError, match="building io_native failed"):
        nio.decode_batch([p], 1)
