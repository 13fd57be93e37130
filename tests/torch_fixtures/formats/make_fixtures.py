"""Writers of PNG, PNM and BMP files in numpy and zlib alone, the frames of
chip_smoke.py part 7c, and the fixtures of tests/test_torch_image_formats.py.

    python tests/torch_fixtures/formats/make_fixtures.py

writes `variants/` (small files, one a feature the port's decoders must
read: 16-bit, palette, low-bit gray, Adam7, sRGB / gAMA, PNM of every kind
and odd maxvals, BMP of every depth, RLE, top-down, core and V5 headers)
and `manifest.json`: per file the shape and SHA-256 of cv2.imread's gray
(IMREAD_GRAYSCALE) and colour (IMREAD_COLOR) planes, laid out as the port
lays them out ((C, H, W) uint8, C-contiguous); and the same of the frames
`write_frames` makes, which are not committed (chip_smoke.py writes them
on the card's host, where there is no cv2, and holds the port's decoder
to these hashes). Needs cv2 for the manifest only; everything else here is
numpy, zlib and integer arithmetic, so the pixels do not depend on the
machine.

The frames: the nine 1024x436 JPEG frames of ../jpeg (moving 1.3, 0.4 px a
frame), decoded as cv2.imread decodes them (the port's decoder gives those
planes, ../jpeg/manifest.json), re-encoded as
  - png16: 16-bit gray PNG, the gray plane in the high byte and a fixed
    pattern in the low byte (cv::imread keeps the high byte);
  - palette: 8-bit palette PNG, the colour planes cut to 3-3-2 bits;
  - adam7_srgb: 8-bit RGB PNG, Adam7 interlaced, with an sRGB chunk (read
    as gray through libpng's gamma path);
  - bmp24: 24-bit bottom-up BMP;
  - pgm16: binary PGM at maxval 65535, the gray plane in the high byte;
  - png8: 8-bit gray PNG (the decode rate's yardstick).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(os.path.dirname(HERE), "jpeg")
FORMATS = ("png16", "palette", "adam7_srgb", "bmp24", "pgm16", "png8")
EXT = {"png16": "png", "palette": "png", "adam7_srgb": "png",
       "bmp24": "bmp", "pgm16": "pgm", "png8": "png"}

# ------------------------------------------------------------------- PNG

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def pack_samples(samples: np.ndarray, bit_depth: int) -> np.ndarray:
    """(h, n) samples -> (h, bytes) packed big-endian rows."""
    s = samples.astype(np.int64)
    if bit_depth == 16:
        return s.astype(">u2").view(np.uint8).reshape(s.shape[0], -1)
    if bit_depth == 8:
        return s.astype(np.uint8)
    per = 8 // bit_depth
    h, n = s.shape
    padded = np.zeros((h, -(-n // per) * per), np.int64)
    padded[:, :n] = s
    padded = padded.reshape(h, -1, per)
    shifts = bit_depth * np.arange(per - 1, -1, -1)
    return (padded << shifts).sum(axis=2).astype(np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows: np.ndarray, bpp: int, kinds) -> bytes:
    """Packed rows (h, n) filtered, row y by kinds[y % len(kinds)] (PNG
    filter types 0-4), each led by its type byte."""
    r = rows.astype(np.int64)
    up = np.vstack([np.zeros((1, r.shape[1]), np.int64), r[:-1]])
    left = np.pad(r, ((0, 0), (bpp, 0)))[:, :r.shape[1]]
    ul = np.pad(up, ((0, 0), (bpp, 0)))[:, :r.shape[1]]
    preds = (np.zeros_like(r), left, up, (left + up) >> 1,
             _paeth(left, up, ul))
    kind = np.asarray([kinds[y % len(kinds)] for y in range(r.shape[0])])
    pred = np.choose(kind[:, None], preds)
    body = ((r - pred) & 0xFF).astype(np.uint8)
    return np.hstack([kind[:, None].astype(np.uint8), body]).tobytes()


def png(pix: np.ndarray, color_type: int, bit_depth: int = 8,
        interlace: int = 0, palette=None, trns: bytes = None,
        before=(), kinds=(0, 1, 2, 3, 4), level: int = 6) -> bytes:
    """A PNG of pix (h, w, channels) samples (palette: indices), with the
    chunks `before` (kind, payload) ahead of PLTE."""
    h, w = pix.shape[:2]
    nch = PNG_CHANNELS[color_type]
    bpp = max(1, nch * bit_depth // 8)
    data = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = pix[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:
            data += filter_rows(pack_samples(sub.reshape(sub.shape[0], -1),
                                             bit_depth), bpp, kinds)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, bit_depth, color_type, 0, 0, interlace))
    for c in before:
        out += chunk(*c)
    if palette is not None:
        out += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += chunk(b"tRNS", trns)
    z = zlib.compress(data, level)
    # the image data in two IDAT chunks, as encoders may split it
    return (out + chunk(b"IDAT", z[:len(z) // 2])
            + chunk(b"IDAT", z[len(z) // 2:]) + chunk(b"IEND", b""))


SRGB = (b"sRGB", b"\0")


def gama(value: int):
    return (b"gAMA", struct.pack(">I", value))


# ------------------------------------------------------------------- PNM

def pnm(pix: np.ndarray, kind: int, maxval: int = 255,
        comment: bytes = b"") -> bytes:
    """P`kind` of pix (h, w) or (h, w, 3) samples (P1 / P4: 0 white, 1
    black), `comment` (a '#' line) after the magic."""
    h, w = pix.shape[:2]
    head = b"P%d\n%s%d %d\n" % (kind, comment, w, h)
    if kind not in (1, 4):
        head += b"%d\n" % maxval
    flat = pix.reshape(h, -1).astype(np.int64)
    if kind == 4:
        return head + np.packbits(flat.astype(np.uint8), axis=1).tobytes()
    if kind >= 5:
        dt = ">u2" if maxval > 255 else np.uint8
        return head + flat.astype(dt).tobytes()
    rows = [b" ".join(b"%d" % v for v in row) for row in flat]
    return head + b"\n".join(rows) + b"\n"


# ------------------------------------------------------------------- BMP

def rle(idx: np.ndarray, bits: int, rng=None, eob: bool = True) -> bytes:
    """BI_RLE8 (bits 8) or BI_RLE4 (bits 4) of (h, w) indices, bottom row
    first: runs of equal indices (RLE4: of an alternating pair), absolute
    runs of the rest, an end of line after each row and an end of bitmap.
    With `rng`, pixels of index 0 are sometimes skipped by a delta or an
    early end of line (the reader fills skipped pixels with entry 0)."""
    out = bytearray()
    h, w = idx.shape
    rows = idx[::-1]
    y = 0
    while y < h:
        row = rows[y].tolist()
        x = 0
        while x < w:
            if rng is not None and row[x] == 0 and rng.random() < 0.5:
                zeros = 0
                while x + zeros < w and row[x + zeros] == 0:
                    zeros += 1
                if x + zeros == w and rng.random() < 0.5:
                    break                      # end of line skips the rest
                dx = min(zeros, 255)
                out += bytes([0, 2, dx, 0])
                x += dx
                continue
            n = 1
            if bits == 8:
                while x + n < w and n < 255 and row[x + n] == row[x]:
                    n += 1
            else:
                while (x + n < w and n < 255
                       and row[x + n] == row[x + (n & 1)]):
                    n += 1
            if n >= 3 or w - x < 3:
                val = row[x] if bits == 8 else \
                    (row[x] << 4) | (row[x + 1] if n > 1 else 0)
                out += bytes([n, val])
                x += n
                continue
            n = 3
            while x + n < w and n < 255 and not (
                    x + n + 2 < w and row[x + n] == row[x + n + 1]
                    == row[x + n + 2]):
                n += 1
            vals = row[x:x + n]
            if bits == 8:
                body = bytes(vals) + b"\0" * (n & 1)
            else:
                vals = vals + [0] * (n & 1)
                body = bytes((vals[k] << 4) | vals[k + 1]
                             for k in range(0, n + (n & 1), 2))
                body += b"\0" * (len(body) & 1)
            out += bytes([0, n]) + body
            x += n
        y += 1
        if y < h or not eob:
            out += b"\0\0"
    if eob:
        out += b"\0\1"
    return bytes(out)


def bmp(pix: np.ndarray, bpp: int, palette=None, header: str = "info",
        top_down: bool = False, compression: int = 0, masks=None,
        colours_used: int = 0, data: bytes = None) -> bytes:
    """A BMP of pix: (h, w) palette indices for bpp <= 8, (h, w, 3) B, G, R
    otherwise (16-bit: x >> 3 of each field, 5-6-5 when `masks` is given
    as BI_BITFIELDS, else 5-5-5; 32-bit: alpha 255). `header`: "core" (12
    bytes), "info" (40), "v4" (108) or "v5" (124). `data` replaces the
    pixel rows (RLE streams)."""
    h, w = pix.shape[:2]
    if data is None:
        rows = pix[::-1] if not top_down else pix
        if bpp <= 8:
            packed = pack_samples(rows.reshape(h, w), bpp)
        elif bpp == 16:
            b, g, r = (rows[..., k].astype(np.int64) for k in range(3))
            if masks is not None and masks[1] == 0x7E0:   # 5-6-5
                t = b >> 3 | (g >> 2) << 5 | (r >> 3) << 11
            else:                                         # 5-5-5
                t = b >> 3 | (g >> 3) << 5 | (r >> 3) << 10
            packed = t.astype("<u2").view(np.uint8).reshape(h, -1)
        elif bpp == 24:
            packed = rows.astype(np.uint8).reshape(h, -1)
        else:
            packed = np.concatenate([rows.astype(np.uint8), np.full(
                (h, w, 1), 255, np.uint8)], axis=2).reshape(h, -1)
        pitch = (packed.shape[1] + 3) & ~3
        data = np.pad(packed, ((0, 0), (0, pitch - packed.shape[1]))
                      ).tobytes()
    if header == "core":
        head = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        size = {"info": 40, "v4": 108, "v5": 124}[header]
        head = struct.pack("<IiiHHIIiiII", size, w, -h if top_down else h,
                           1, bpp, compression, len(data), 2835, 2835,
                           colours_used, 0)
        if size > 40:
            m = masks or (0, 0, 0)
            head += struct.pack("<IIII", m[2], m[1], m[0], 0)
            head += b"\0" * (size - len(head))
    extra = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8)
        if header == "core":
            extra = pal[:, :3].tobytes()
        else:
            extra = np.concatenate([pal[:, :3], np.zeros(
                (len(pal), 1), np.uint8)], axis=1).tobytes()
    elif masks is not None and header == "info":
        extra = struct.pack("<III", masks[2], masks[1], masks[0])
    offset = 14 + len(head) + len(extra)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset)
            + head + extra + data)


# --------------------------------------------------------- chip frames

def low_pattern(h: int, w: int) -> np.ndarray:
    """The fixed low byte of the 16-bit frames."""
    y, x = np.mgrid[:h, :w]
    return ((x * 7 + y * 13) & 0xFF).astype(np.uint16)


def palette332() -> np.ndarray:
    """The 256 RGB colours of the 3-3-2 cut, each the middle of its cell."""
    i = np.arange(256)
    r, g, b = i >> 5, (i >> 2) & 7, i & 3
    return np.stack([r * 32 + 16, g * 32 + 16, b * 64 + 32], 1).astype(
        np.uint8)


def encode_frame(fmt: str, gray: np.ndarray, bgr: np.ndarray) -> bytes:
    """One frame (gray (h, w), bgr (3, h, w) uint8 planes, as cv::imread
    reads the JPEG) in format `fmt` of FORMATS."""
    h, w = gray.shape
    rgb = np.ascontiguousarray(bgr[::-1].transpose(1, 2, 0))
    if fmt == "png16":
        v = (gray.astype(np.uint16) << 8) | low_pattern(h, w)
        return png(v[..., None], 0, 16, level=1)
    if fmt == "palette":
        r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
        idx = (r >> 5) << 5 | (g >> 5) << 2 | (b >> 6)
        return png(idx[..., None], 3, 8, palette=palette332(), level=1)
    if fmt == "adam7_srgb":
        return png(rgb, 2, 8, interlace=1, before=[SRGB], level=1)
    if fmt == "bmp24":
        return bmp(bgr.transpose(1, 2, 0), 24)
    if fmt == "pgm16":
        v = (gray.astype(np.uint16) << 8) | low_pattern(h, w)
        return pnm(v, 5, 65535)
    if fmt == "png8":
        return png(gray[..., None], 0, 8, level=1)
    raise ValueError(fmt)


def write_frames(out_dir: str, planes, formats=FORMATS, pool=None) -> dict:
    """Write frame_0000.<ext> ... of each format into out_dir/<format>/
    from `planes`: a list of (gray, bgr) uint8 arrays per frame, on the
    executor `pool` if given. Returns {format: [paths]}."""
    def one(fmt, t):
        with open(paths[fmt][t], "wb") as f:
            f.write(encode_frame(fmt, *planes[t]))

    paths = {}
    for fmt in formats:
        os.makedirs(os.path.join(out_dir, fmt), exist_ok=True)
        paths[fmt] = [os.path.join(out_dir, fmt, f"frame_{t:04d}.{EXT[fmt]}")
                      for t in range(len(planes))]
    jobs = [(fmt, t) for fmt in formats for t in range(len(planes))]
    if pool is None:
        for job in jobs:
            one(*job)
    else:
        for fut in [pool.submit(one, *job) for job in jobs]:
            fut.result()
    return paths


# ------------------------------------------------------------- variants

def _blur(h, w, c, seed):
    """Smooth integer content: a 4x4 box of uniform noise, twice."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 256, (h + 6, w + 6, c)).astype(np.int64)
    for _ in range(2):
        v = sum(np.roll(np.roll(v, i, 0), j, 1) for i in range(4)
                for j in range(4)) >> 4
    return v[3:3 + h, 3:3 + w]


def variants() -> dict:
    """Small files, one per feature (name -> bytes)."""
    rng = np.random.default_rng(14)
    out = {}
    c = _blur(29, 41, 3, 1)
    out["rgb8.png"] = png(c, 2)
    out["rgb8_srgb.png"] = png(c, 2, before=[SRGB])
    out["rgb8_gama22.png"] = png(c, 2, before=[gama(45455)])
    out["rgb8_gama07.png"] = png(c, 2, before=[gama(70000)])
    out["rgba8.png"] = png(np.concatenate([c, _blur(29, 41, 1, 2)], 2), 6)
    c16 = c * 257 + rng.integers(0, 257, c.shape)
    out["rgb16.png"] = png(c16, 2, 16)
    out["rgb16_srgb.png"] = png(c16, 2, 16, before=[SRGB])
    out["gray16.png"] = png(c16[..., :1], 0, 16)
    pal = rng.integers(0, 256, (200, 3))
    idx = rng.integers(0, 256, (29, 41, 1))     # indices past PLTE's 200
    out["palette8.png"] = png(idx, 3, 8, palette=pal, trns=bytes(range(9)))
    out["palette4_srgb.png"] = png(idx % 16, 3, 4, palette=pal[:16],
                                   before=[SRGB])
    for bits in (1, 2, 4):
        g = rng.integers(0, 1 << bits, (9, 13, 1))
        out[f"gray{bits}_13x9.png"] = png(g, 0, bits)
    out["adam7_rgb_7x9.png"] = png(c[:9, :7], 2, interlace=1, before=[SRGB])
    out["adam7_gray1_1x1.png"] = png(np.ones((1, 1, 1), np.int64), 0, 1,
                                     interlace=1)
    out["adam7_palette2.png"] = png(idx[:13, :13] % 4, 3, 2, interlace=1,
                                    palette=pal[:4])
    gray = _blur(23, 31, 1, 3)[..., 0]
    out["p1.pbm"] = pnm(gray[:9, :13] > 128, 1)
    out["p4.pbm"] = pnm(gray[:9, :13] > 128, 4)
    out["p2_maxval100.pgm"] = pnm(gray * 100 // 255, 2, 100,
                                  comment=b"# a comment\n")
    out["p3_maxval1000.ppm"] = pnm(c[:13, :17] * 1000 // 255, 3, 1000)
    out["p5_maxval100.pgm"] = pnm(gray * 100 // 255, 5, 100)
    out["p6_maxval65535.ppm"] = pnm(c16, 6, 65535)
    bpal = rng.integers(0, 256, (256, 3))
    out["bmp1.bmp"] = bmp(rng.integers(0, 2, (9, 13)), 1, bpal[:2])
    out["bmp4.bmp"] = bmp(rng.integers(0, 16, (9, 13)), 4, bpal[:16])
    out["bmp8_topdown.bmp"] = bmp(rng.integers(0, 256, (9, 13)), 8, bpal,
                                  top_down=True)
    out["bmp8_core.bmp"] = bmp(rng.integers(0, 256, (9, 13)), 8, bpal,
                               header="core")
    out["bmp16_555.bmp"] = bmp(c, 16)
    out["bmp16_565.bmp"] = bmp(c, 16, compression=3,
                               masks=(0x1F, 0x7E0, 0xF800))
    out["bmp24_v5.bmp"] = bmp(c, 24, header="v5")
    out["bmp32.bmp"] = bmp(c, 32)
    ridx = (_blur(29, 41, 1, 4)[..., 0] >> 5) * (rng.random((29, 41)) < 0.9)
    out["bmp8_rle.bmp"] = bmp(ridx, 8, bpal, compression=1,
                              data=rle(ridx, 8, np.random.default_rng(1)))
    r4 = ridx & 15
    out["bmp4_rle.bmp"] = bmp(r4, 4, bpal[:16], compression=2,
                              data=rle(r4, 4, np.random.default_rng(2)))
    return out


def planes(path: str) -> dict:
    """cv2.imread's gray and colour planes of `path`, (C, H, W) layout:
    shape and SHA-256."""
    import cv2
    rec = {}
    for key, flag in (("gray", cv2.IMREAD_GRAYSCALE),
                      ("color", cv2.IMREAD_COLOR)):
        img = cv2.imread(path, flag)
        chw = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
        rec[key] = {"shape": list(chw.shape), "sha256": hashlib.sha256(
            np.ascontiguousarray(chw).tobytes()).hexdigest()}
    return rec


def jpeg_planes() -> list:
    """cv2.imread's (gray, bgr) planes of the nine JPEG frames."""
    import cv2
    names = sorted(os.listdir(os.path.join(JPEG_DIR, "frames")))
    out = []
    for n in names:
        p = os.path.join(JPEG_DIR, "frames", n)
        out.append((cv2.imread(p, cv2.IMREAD_GRAYSCALE),
                    np.ascontiguousarray(cv2.imread(p).transpose(2, 0, 1))))
    return out


def main(scratch: str) -> dict:
    import cv2
    files = {}
    os.makedirs(os.path.join(HERE, "variants"), exist_ok=True)
    for name, raw in sorted(variants().items()):
        path = os.path.join(HERE, "variants", name)
        with open(path, "wb") as f:
            f.write(raw)
        files[f"variants/{name}"] = {"bytes": len(raw), **planes(path)}
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        motion = json.load(f)["motion_px"]
    frames = {}
    for fmt, paths in write_frames(scratch, jpeg_planes()).items():
        for p in paths:
            frames[f"{fmt}/{os.path.basename(p)}"] = planes(p)
    manifest = {"cv2": cv2.__version__, "motion_px": motion,
                "frame_size": [1024, 436], "files": files, "frames": frames}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        m = main(tmp)
    print(f"{len(m['files'])} variants "
          f"({sum(r['bytes'] for r in m['files'].values())} bytes), "
          f"{len(m['frames'])} frames")
