"""Flow/depth/image file I/O for the port, in numpy and the standard library.

Byte-compatible with the reference writers/readers:
  - `.flo`: "PIEH" magic + int32 width/height + row-major float32 payload with
    1 (depth), 2 (flow) or 4 (scene flow) channels (reference: run_dense.cpp:17-58).
  - `.pfm`: "Pf" header, bottom-up rows, NEGATED depth values, scale -1.0
    written via printf("%f") (reference: run_dense.cpp:61-82).
  - image loading decodes 8-bit non-interlaced PNG and binary PGM/PPM with
    zlib and numpy (no OpenCV or PIL needed), with OpenCV's fixed-point
    BGR2GRAY conversion so gray values equal cv::imread(GRAYSCALE)'s
    (run_dense.cpp:200-210); JPEG through the port's own decoder
    (`native.io.decode_jpeg`, csrc/jpeg.cpp), pixel for pixel as
    cv::imread: gray is the image's decoded Y plane, not BGR2GRAY of its
    colour decode, and the EXIF orientation is applied.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_FLO_MAGIC = b"PIEH"
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"  # SOI, then a marker's FF


def write_flo(path: str, data: np.ndarray) -> None:
    """Write a (H, W, C) float32 array as .flo (reference: run_dense.cpp:17-58)."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim == 2:
        data = data[:, :, None]
    h, w, nc = data.shape
    if nc not in (1, 2, 4):
        raise ValueError(f"flo supports 1/2/4 channels, got {nc}")
    with open(path, "wb") as f:
        f.write(_FLO_MAGIC)
        f.write(struct.pack("<ii", w, h))
        f.write(data.tobytes())


def read_flo(path: str) -> np.ndarray:
    """Read a .flo file, inferring the channel count from the payload size
    (run_dense.cpp:85-129)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != _FLO_MAGIC:
        raise ValueError(f"{path}: bad .flo magic {raw[:4]!r}")
    w, h = struct.unpack("<ii", raw[4:12])
    payload = np.frombuffer(raw, dtype=np.float32, offset=12)
    nc = payload.size // (w * h)
    if nc * w * h != payload.size or nc not in (1, 2, 4):
        raise ValueError(f"{path}: payload size {payload.size} != {w}x{h}xC")
    return payload.reshape(h, w, nc).copy()


def write_pfm(path: str, depth: np.ndarray) -> None:
    """Write a (H, W) float32 depth map as .pfm, negated + bottom-up
    (run_dense.cpp:61-82)."""
    depth = np.ascontiguousarray(depth, dtype=np.float32)
    if depth.ndim == 3:
        depth = depth[:, :, 0]
    h, w = depth.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n%d %d\n%f\n" % (w, h, -1.0))
        f.write((-depth[::-1]).tobytes())


def read_pfm(path: str) -> np.ndarray:
    """Read a .pfm written by `write_pfm` (returns the un-negated depth)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"Pf":
            raise ValueError(f"{path}: expected grayscale Pf, got {magic!r}")
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), dtype="<f4" if scale < 0 else ">f4",
                             count=h * w)
    return (-data.reshape(h, w)[::-1]).copy()


def _paeth_row(row: np.ndarray, prev: np.ndarray, nch: int) -> np.ndarray:
    """Undo PNG filter 4 on one row (sequential within the row)."""
    out = bytearray(row.tobytes())
    up = prev.tolist()
    for x in range(len(out)):
        a = out[x - nch] if x >= nch else 0
        b = up[x]
        c = up[x - nch] if x >= nch else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[x] = (out[x] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _avg_row(row: np.ndarray, prev: np.ndarray, nch: int) -> np.ndarray:
    """Undo PNG filter 3 on one row."""
    out = bytearray(row.tobytes())
    up = prev.tolist()
    for x in range(len(out)):
        a = out[x - nch] if x >= nch else 0
        out[x] = (out[x] + ((a + up[x]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def png_chunks(raw: bytes):
    """The header and the inflated image data of an 8-bit non-interlaced
    PNG (gray, RGB, gray+alpha, RGBA): (width, height, channels, data), data
    the (height * (width * channels + 1)) bytes of filtered rows, each led
    by its filter type (io_native.cpp:68-110). Raises ValueError on any
    other PNG, a truncated file or a bad zlib stream."""
    if raw[:8] != _PNG_MAGIC:
        raise ValueError("not a PNG")
    pos = 8
    width = height = 0
    bit_depth, color_type, interlace = 0, -1, 0
    idat = []
    while pos + 8 <= len(raw):
        length = struct.unpack(">I", raw[pos:pos + 4])[0]
        ctype = raw[pos + 4:pos + 8]
        if pos + 12 + length > len(raw):
            raise ValueError("truncated PNG")
        payload = raw[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            width, height = struct.unpack(">II", payload[:8])
            bit_depth, color_type = payload[8], payload[9]
            interlace = payload[12]
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if bit_depth != 8 or interlace != 0 or color_type not in (0, 2, 4, 6):
        raise ValueError("unsupported PNG (need 8-bit non-interlaced "
                         "gray/RGB/RGBA)")
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    size = (width * nch + 1) * height
    try:
        data = zlib.decompress(b"".join(idat), bufsize=max(size, 1))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from e
    if len(data) != size:
        raise ValueError("PNG payload size mismatch")
    return width, height, nch, data


def _decode_png(raw: bytes) -> np.ndarray:
    """8-bit non-interlaced PNG (gray, RGB, gray+alpha, RGBA) -> (H, W, nch)
    uint8 (io_native.cpp:68-141)."""
    width, height, nch, raw_rows = png_chunks(raw)
    stride = width * nch
    data = np.frombuffer(raw_rows, np.uint8).reshape(height, stride + 1)
    pix = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        filt, row = data[y, 0], data[y, 1:]
        if filt == 0:
            cur = row
        elif filt == 1:    # Sub: running sum per channel, mod 256
            cur = (np.cumsum(row.reshape(width, nch), axis=0,
                             dtype=np.int64) & 0xFF).astype(np.uint8).ravel()
        elif filt == 2:    # Up
            cur = row + prev
        elif filt == 3:
            cur = _avg_row(row, prev, nch)
        elif filt == 4:
            cur = _paeth_row(row, prev, nch)
        else:
            raise ValueError("bad PNG filter")
        pix[y] = cur
        prev = pix[y]
    return pix.reshape(height, width, nch)


def decode_pnm(raw: bytes) -> np.ndarray:
    """Binary PGM/PPM (P5/P6, maxval 255) -> (H, W, nch) uint8
    (io_native.cpp:143-181)."""
    nch = 1 if raw[1:2] == b"5" else 3
    pos = 2
    vals = []
    for _ in range(3):
        while pos < len(raw) and (raw[pos:pos + 1].isspace()
                                  or raw[pos:pos + 1] == b"#"):
            if raw[pos:pos + 1] == b"#":
                while pos < len(raw) and raw[pos:pos + 1] != b"\n":
                    pos += 1
            else:
                pos += 1
        start = pos
        while pos < len(raw) and raw[pos:pos + 1].isdigit():
            pos += 1
        vals.append(int(raw[start:pos]))
    pos += 1                      # single whitespace after maxval
    w, h, maxval = vals
    if maxval != 255:
        raise ValueError("PNM maxval != 255 unsupported")
    need = w * h * nch
    if len(raw) - pos < need:
        raise ValueError("truncated PNM")
    return np.frombuffer(raw[pos:pos + need], np.uint8).reshape(h, w, nch)


def load_image(path: str, channels: int = 1) -> np.ndarray:
    """Load an 8-bit PNG/PGM/PPM or a JPEG as float32 (C, H, W), the
    values cv::imread gives.

    PNG / PNM: channels=1 gray through OpenCV's fixed-point BGR2GRAY,
    (R*4899 + G*9617 + B*1868 + 8192) >> 14 (io_native.cpp:208-210);
    channels=3 BGR order, as cv::imread(COLOR) gives it.
    JPEG (csrc/jpeg.cpp, through `native.io.decode_jpeg`): channels=1 the
    decoded Y plane, as libjpeg hands cv::imread(GRAYSCALE) (not BGR2GRAY
    of the colour decode); channels=3 BGR; the EXIF orientation applied.
    Raises ValueError naming the cause on a JPEG it refuses (arithmetic
    coding, 12-bit, lossless, CMYK, corrupt data)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:3] == JPEG_MAGIC:
        from of_dis_tpu_torch.native import io as native_io
        try:
            pix = native_io.decode_jpeg(raw, channels)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
        return pix.astype(np.float32)
    if raw[:8] == _PNG_MAGIC:
        pix = _decode_png(raw)
    elif raw[:1] == b"P" and raw[1:2] in (b"5", b"6"):
        pix = decode_pnm(raw)
    else:
        raise ValueError(f"{path}: unsupported image format "
                         "(PNG/PGM/PPM/JPEG supported)")
    pix = pix.astype(np.int32)
    if pix.shape[2] in (1, 2):          # gray (+ alpha)
        r = g = b = pix[:, :, 0]
    else:
        r, g, b = pix[:, :, 0], pix[:, :, 1], pix[:, :, 2]
    if channels == 1:
        gray = (r * 4899 + g * 9617 + b * 1868 + 8192) >> 14
        return gray[None].astype(np.float32)
    return np.stack([b, g, r], axis=0).astype(np.float32)
