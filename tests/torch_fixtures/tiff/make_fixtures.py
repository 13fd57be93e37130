"""Writers of TIFF files in numpy and the standard library, the frames of
chip_smoke.py part 7e, and the fixtures of tests/test_torch_tiff.py.

    python tests/torch_fixtures/tiff/make_fixtures.py

writes `variants/` (small files, one a feature the port's decoder must
read: every compression it reads, predictor 2, strips and tiles, chunky
and planar, 1-16 bits, gray, MINISWHITE, palette, RGB, CMYK, alpha,
YCbCr at each subsampling, orientations, CCITT fax and JPEG-in-TIFF from
cv2 and PIL, and the variants cv2.imread fails on), `fax_g4/` and
`pairs/` (the committed frame sets below) and `manifest.json`: per file
the shape and SHA-256 of cv2.imread's gray (IMREAD_GRAYSCALE) and colour
(IMREAD_COLOR) planes, laid out as the port lays them out ((C, H, W)
uint8, C-contiguous), null for a read cv2.imread fails on; and the same
of the frames `write_frames` makes, which are not committed
(chip_smoke.py writes them on the card's host, where there is no cv2, and
holds the port's decoder to these hashes). Needs cv2 for the manifest
and PIL for its PIL-written files (libtiff's own CCITT and JPEG
encoders).

The frames: the nine 1024x436 JPEG frames of ../jpeg (moving 1.3, 0.4 px
a frame), as cv2.imread decodes them, re-encoded as
  - lzw_pred: gray, LZW with predictor 2, strips of 16 rows;
  - deflate_rgb: RGB, Deflate (compression 8), strips of 64 rows;
  - packbits_tiled: RGB, PackBits, 64x32 tiles;
  - gray16: 16-bit gray, uncompressed, the gray plane in the high byte;
  - jpeg: the JPEG frame's own bitstream in one strip, its tables in the
    JPEGTables tag, YCbCr 4:2:0 (JPEG-in-TIFF as libtiff writes it);
  - ycbcr_lzw: YCbCr (JPEG's full-range conversion in integers), 2x1
    subsampled, LZW, strips of 16 rows, no ReferenceBlackWhite (libtiff's
    default).
The committed sets, written by libtiff through PIL (`committed_sets`):
  - fax_g4/: the nine gray planes blurred and thresholded, Group 4;
  - pairs/rgba_jpeg/, pairs/cmyk_jpeg/: frames 0-1 as PIL's RGBA (alpha
    255) and CMYK JPEG-in-TIFF.
The damaged sets (`damaged_sets`, the manifest's "damaged" entry; part
7h of chip_smoke.py): the frames of DAMAGED (sets whose bytes are the
same on any machine: not Deflate, whose output differs between zlib
builds), each as byte edits in ../jpeg/damage.py's format of its source
frame, whose SHA-256 the entry records: frames 0, 3 and 6 intact, 1, 4
and 7 with a byte flipped in one strip or tile (near the end of the data
of the one-strip sets, so that the damage stays under 5% of the pixels),
2, 5 and 8 with a strip's or tile's byte count cut short; and the
SHA-256 of cv2.imread's planes of each, with the share of the gray
plane's pixels the damage changed.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import sys
import zlib

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(os.path.dirname(HERE), "jpeg")
FORMATS = ("lzw_pred", "deflate_rgb", "packbits_tiled", "gray16", "jpeg",
           "ycbcr_lzw")
# the committed frame sets: directory -> frames
COMMITTED = {"fax_g4": 9, "pairs/rgba_jpeg": 2, "pairs/cmyk_jpeg": 2}
# the damaged sets -> (first chunk damaged, step a frame, where in the
# chunk's data the flipped byte lies, the share of its bytes a cut count
# keeps); in a PackBits chunk the byte flipped is the control byte at or
# after that point
DAMAGED = {"lzw_pred": (5, 3, 0.5, 0.6), "packbits_tiled": (20, 17, 0.5, 0.6),
           "jpeg": (0, 0, 0.985, 0.985), "fax_g4": (0, 0, 0.985, 0.985)}

_REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))
# struct codes of the field types BYTE, ASCII, SHORT, LONG, UNDEFINED,
# LONG8 (RATIONAL is packed apart)
_CODES = {1: "B", 2: "B", 3: "H", 4: "I", 7: "B", 16: "Q"}


# ---------------------------------------------------------------- codecs

def lzw(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: codes MSB-first, 9 to 12 bits, one
    bit more once the next free code passes 2^n - 1 (the decoder's early
    change); Clear (256) first and when the next free code reaches 4094,
    EOI (257) last."""
    out = bytearray()
    acc = nacc = 0
    width = 9

    def put(code):
        nonlocal acc, nacc
        acc = (acc << width) | code
        nacc += width
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1

    table, nxt = {}, 258        # (prefix code << 8 | byte) -> code
    put(256)
    w = -1
    for b in data:
        key = (w << 8) | b
        if w < 0:
            w = b
            continue
        code = table.get(key)
        if code is not None:
            w = code
            continue
        put(w)
        table[key] = nxt
        nxt += 1
        if nxt == 4094:
            put(256)
            table, nxt, width = {}, 258, 9
        elif nxt > (1 << width) - 1:
            width += 1
        w = b
    if w >= 0:
        put(w)
        nxt += 1
        if nxt > (1 << width) - 1 and width < 12:
            width += 1
    put(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: runs of 3 to 128 equal bytes as (1 - n, byte), other
    bytes as literals of up to 128."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), data[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 128 and not (
                k + 2 < n and data[k] == data[k + 1] == data[k + 2]):
            k += 1
        k = max(k, i + 1)
        out.append(k - i - 1)
        out += data[i:k]
        i = k
    return bytes(out)


def _compress(chunk: bytes, compression: int) -> bytes:
    if compression == 1:
        return chunk
    if compression == 5:
        return lzw(chunk)
    if compression in (8, 32946):
        return zlib.compress(chunk, 6)
    if compression == 32773:
        return packbits(chunk)
    raise ValueError(f"no writer for compression {compression}")


# --------------------------------------------------------------- writer

def _rows(block: np.ndarray, bits: int, order: str) -> bytes:
    """(rows, cols, samples) -> packed rows, each padded to a byte."""
    r, c, s = block.shape
    flat = block.reshape(r, c * s)
    if bits == 8:
        return flat.astype(np.uint8).tobytes()
    if bits == 16:
        return flat.astype(order + "u2").tobytes()
    if bits == 32:
        return flat.astype(order + "u4").tobytes()
    per = 8 // bits
    width = -(-c * s // per) * per
    pad = np.zeros((r, width), np.uint8)
    pad[:, :c * s] = flat
    v = pad.reshape(r, -1, per).astype(np.uint8)
    shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint8)
    return np.bitwise_or.reduce(v << shifts, axis=2).astype(
        np.uint8).tobytes()


def _predict(block: np.ndarray, bits: int) -> np.ndarray:
    """Horizontal differencing (predictor 2) of (rows, cols, samples)."""
    mod = 1 << bits
    out = block.astype(np.int64).copy()
    out[:, 1:] = (block[:, 1:].astype(np.int64)
                  - block[:, :-1].astype(np.int64)) % mod
    return out


def chunk_grid(h: int, w: int, rows_per_strip: int = None, tile=None):
    """The chunks of an h x w image, ((x, y, width, height) a strip or
    tile, ...), and the chunk size: strips of `rows_per_strip` rows
    (default all, the last cut to the image) or tiles of `tile` = (width,
    height), whole."""
    if tile is None:
        rps = h if rows_per_strip is None else rows_per_strip
        return [(0, y, w, min(rps, h - y)) for y in range(0, h, rps)], (w, rps)
    cw, ch = tile
    return [(x, y, cw, ch) for y in range(0, h, ch)
            for x in range(0, w, cw)], (cw, ch)


def tiff(pix: np.ndarray, *, bits: int = 8, photometric: int = None,
         compression: int = 1, predictor: int = 1, planar: bool = False,
         rows_per_strip: int = None, tile=None, colormap=None,
         extra_samples=None, sample_format: int = None,
         orientation: int = None, big_endian: bool = False,
         fill_order: int = None, chunks=None, jpeg_tables: bytes = None,
         ycbcr_subsampling=None, extra_tags=(), omit=(),
         big: bool = False) -> bytes:
    """A one-page TIFF of pix (h, w) or (h, w, samples) integer samples
    of `bits` bits: strips of `rows_per_strip` rows (default all) or
    tiles of `tile` = (width, height), chunky or planar, each chunk
    compressed by `compression` (1, 5, 8, 32946, 32773) after
    `predictor`; `colormap` (2^bits, 3) 16-bit R, G, B entries for
    photometric 3. `chunks`, if given, are the compressed chunks as they
    are (JPEG streams, say). `extra_tags` ((tag, type, values), ...) are
    added and the tags in `omit` left out; the IFD is sorted by tag.
    `big`: a BigTIFF (8-byte offsets and counts)."""
    pix = np.asarray(pix)
    if pix.ndim == 2:
        pix = pix[:, :, None]
    h, w, spp = pix.shape
    order = ">" if big_endian else "<"
    if photometric is None:
        photometric = 3 if colormap is not None else (1 if spp < 3 else 2)
    planes = [pix[:, :, k:k + 1] for k in range(spp)] if planar else [pix]
    grid, (cw, ch) = chunk_grid(h, w, rows_per_strip, tile)
    if chunks is None:
        chunks = []
        for plane in planes:
            for x, y, gw, gh in grid:
                block = plane[y:y + gh, x:x + gw]
                if tile is not None:    # tiles are whole: pad with zeros
                    full = np.zeros((ch, cw, plane.shape[2]), np.int64)
                    full[:block.shape[0], :block.shape[1]] = block
                    block = full
                if predictor == 2:
                    block = _predict(block, bits)
                raw = _compress(_rows(block, bits, order), compression)
                if fill_order == 2:     # the stored bytes, bits reversed
                    raw = raw.translate(_REVERSED)
                chunks.append(raw)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [2 if planar else 1])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if colormap is not None:
        cm = np.asarray(colormap, np.int64)
        tags[320] = (3, list(cm[:, 0]) + list(cm[:, 1]) + list(cm[:, 2]))
    if extra_samples is not None:
        tags[338] = (3, list(extra_samples))
    if sample_format is not None:
        tags[339] = (3, [sample_format] * spp)
    if orientation is not None:
        tags[274] = (3, [orientation])
    if fill_order is not None:
        tags[266] = (3, [fill_order])
    if jpeg_tables is not None:
        tags[347] = (7, list(jpeg_tables))
    if ycbcr_subsampling is not None:
        tags[530] = (3, list(ycbcr_subsampling))
    if tile is None:
        tags[278] = (4, [ch])
    else:
        tags[322], tags[323] = (4, [cw]), (4, [ch])
    for tag, typ, values in extra_tags:
        tags[tag] = (typ, list(values))
    for tag in omit:
        tags.pop(tag, None)
    # layout: header, chunk data, then the IFD and its out-of-line values
    word = 8 if big else 4
    if big:
        out = bytearray((b"MM\0+" if big_endian else b"II+\0")
                        + struct.pack(order + "HHQ", 8, 0, 0))
    else:
        out = bytearray((b"MM\0*" if big_endian else b"II*\0") + b"\0" * 4)
    offsets = []
    for c in chunks:
        offsets.append(len(out))
        out += c
        if len(out) & 1:
            out += b"\0"
    off_tag, cnt_tag = (273, 279) if tile is None else (324, 325)
    if off_tag not in omit:
        tags[off_tag] = (16 if big else 4, offsets)
    if cnt_tag not in omit:
        tags[cnt_tag] = (16 if big else 4, [len(c) for c in chunks])
    ifd_at = len(out)
    struct.pack_into(order + ("Q" if big else "I"), out, 8 if big else 4,
                     ifd_at)
    entries = sorted(tags.items())
    head = "Q" if big else "H"
    data_at = ifd_at + struct.calcsize(head) + (4 + 2 * word) * len(
        entries) + word
    ifd = bytearray(struct.pack(order + head, len(entries)))
    extra = bytearray()
    for tag, (typ, values) in entries:
        if typ == 5:
            payload = b"".join(struct.pack(order + "II", *v) for v in values)
        else:
            payload = struct.pack(order + _CODES[typ] * len(values), *values)
        ifd += struct.pack(order + "HH" + ("Q" if big else "I"), tag, typ,
                           len(values))
        if len(payload) <= word:
            ifd += payload.ljust(word, b"\0")
        else:
            ifd += struct.pack(order + ("Q" if big else "I"),
                               data_at + len(extra))
            extra += payload
            if len(extra) & 1:
                extra += b"\0"
    ifd += b"\0" * word
    return bytes(out + ifd + extra)


# ---------------------------------------------------------- JPEG-in-TIFF

def jpeg_segments(jpg: bytes):
    """((marker, segment bytes), ...) of a JPEG up to its first SOS, and
    the rest of the file from that SOS."""
    pos, segs = 2, []
    while jpg[pos + 1] != 0xDA:
        end = pos + 2 + struct.unpack(">H", jpg[pos + 2:pos + 4])[0]
        segs.append((jpg[pos + 1], jpg[pos:end]))
        pos = end
    return segs, jpg[pos:]


def jpeg_tiff(jpg: bytes, width: int, height: int, ycbcr=(2, 2),
              photometric: int = None, **kw) -> bytes:
    """A JPEG's bitstream as a one-strip JPEG-compressed TIFF, the way
    libtiff stores one: its DQT and DHT segments as a tables-only stream
    in JPEGTables, the strip an abbreviated stream without them (nor
    APPn); photometric YCbCr with `ycbcr` subsampling, or (ycbcr None)
    RGB or gray as the JPEG's components are, or `photometric`."""
    segs, rest = jpeg_segments(jpg)
    tables = b"\xff\xd8" + b"".join(
        seg for m, seg in segs if m in (0xC4, 0xDB)) + b"\xff\xd9"
    stream = b"\xff\xd8" + b"".join(
        seg for m, seg in segs
        if m not in (0xC4, 0xDB) and not 0xE0 <= m <= 0xEF) + rest
    sof = next(seg for m, seg in segs if m in (0xC0, 0xC1, 0xC2))
    spp = sof[9]
    if photometric is None:
        photometric = 6 if ycbcr else (2 if spp == 3 else 1)
    return tiff(np.zeros((height, width, spp), np.uint8), compression=7,
                photometric=photometric,
                chunks=[stream], jpeg_tables=tables,
                ycbcr_subsampling=ycbcr, **kw)


# ----------------------------------------------------------------- YCbCr

def rgb_to_ycbcr(rgb: np.ndarray) -> np.ndarray:
    """(h, w, 3) R, G, B -> Y, Cb, Cr by JPEG's full-range conversion, in
    16-bit fixed point (integers: every machine writes the same bytes)."""
    r, g, b = (rgb[..., k].astype(np.int64) for k in range(3))
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11056 * r - 21712 * g + 32768 * b + (128 << 16) + 32768) >> 16
    cr = (32768 * r - 27440 * g - 5328 * b + (128 << 16) + 32768) >> 16
    return np.clip(np.stack([y, cb, cr], 2), 0, 255)


def ycbcr_blocks(ycc: np.ndarray, h: int, v: int) -> np.ndarray:
    """(rows, cols, 3) Y, Cb, Cr -> (rows / v, cols / h, h * v + 2) blocks
    (rounded up; edge samples repeated): the block's luma row by row,
    then Cb and Cr, each the block's mean, rounded."""
    rows, cols, _ = ycc.shape
    br, bc = -(-rows // v), -(-cols // h)
    pad = np.pad(ycc.astype(np.int64), ((0, br * v - rows),
                                         (0, bc * h - cols), (0, 0)),
                 mode="edge")
    blk = pad.reshape(br, v, bc, h, 3).transpose(0, 2, 1, 3, 4)
    luma = blk[..., 0].reshape(br, bc, v * h)
    chroma = (blk[..., 1:].sum((2, 3)) + h * v // 2) // (h * v)
    return np.concatenate([luma, chroma], 2)


def ycbcr_tiff(ycc: np.ndarray, sub=(2, 2), *, compression: int = 1,
               rows_per_strip: int = None, tile=None, predictor: int = 1,
               luma=None, ref_bw=None, omit_subsampling: bool = False,
               **kw) -> bytes:
    """A chunky 8-bit YCbCr TIFF of (h, w, 3) Y, Cb, Cr samples with
    subsampling `sub` = (h, v): each strip or tile's own blocks
    (`ycbcr_blocks`), a tile's padded to the whole tile. `luma` and
    `ref_bw`, if given, are YCbCrCoefficients and ReferenceBlackWhite as
    (numerator, denominator) RATIONALs; `omit_subsampling` leaves tag 530
    out (libtiff's default is 2x2)."""
    h, w, _ = ycc.shape
    sh, sv = sub
    chunks = []
    for x, y, gw, gh in chunk_grid(h, w, rows_per_strip, tile)[0]:
        part = ycc[y:y + gh, x:x + gw]
        if tile is not None:            # a tile is whole: edge samples
            part = np.pad(part, ((0, gh - part.shape[0]),
                                 (0, gw - part.shape[1]), (0, 0)),
                          mode="edge")
        data = ycbcr_blocks(part, sh, sv)
        if predictor == 2:
            data = _predict(data.reshape(data.shape[0], -1, 3), 8)
        chunks.append(_compress(data.astype(np.uint8).tobytes(),
                                compression))
    extra = list(kw.pop("extra_tags", ()))
    if luma is not None:
        extra.append((529, 5, luma))
    if ref_bw is not None:
        extra.append((532, 5, ref_bw))
    return tiff(np.zeros((h, w, 3), np.uint8), photometric=6,
                compression=compression, predictor=predictor, tile=tile,
                rows_per_strip=rows_per_strip, chunks=chunks,
                ycbcr_subsampling=None if omit_subsampling else sub,
                extra_tags=extra, **kw)


# ------------------------------------------------------------ CCITT fax

def pil_fax(pix: np.ndarray, compression: str, options: int = None) -> bytes:
    """The one strip libtiff's CCITT encoder (through PIL) writes for the
    (h, w) image `pix` (nonzero white) as a 1-bit MINISBLACK TIFF:
    `compression` "tiff_ccitt", "group3" or "group4", `options` its
    T4Options."""
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.where(pix, 255, 0).astype(np.uint8)).convert(
        "1").save(buf, "TIFF", compression=compression,
                  strip_size=pix.size,          # one strip
                  **({} if options is None else {"tiffinfo": {292: options}}))
    raw = buf.getvalue()
    ifd = struct.unpack("<I", raw[4:8])[0]
    tags = {}
    for k in range(struct.unpack("<H", raw[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * k
        tag, typ, count = struct.unpack("<HHI", raw[at:at + 8])
        assert tag not in (273, 279) or count == 1, "more than one strip"
        tags[tag] = struct.unpack("<H" if typ == 3 else "<I",
                                  raw[at + 8:at + (10 if typ == 3 else 12)])[0]
    return raw[tags[273]:tags[273] + tags[279]]


_FAX_CODES = {"tiff_ccitt": 2, "group3": 3, "group4": 4}


def fax_tiff(pix: np.ndarray, compression: str = "group4",
             options: int = None, *, rows_per_strip: int = None, tile=None,
             fill_order: int = None, photometric: int = 1,
             **kw) -> bytes:
    """A 1-bit CCITT TIFF of (h, w) `pix` (nonzero white, as PIL's
    MINISBLACK writes it; photometric 0 reads it inverted), each strip or
    tile (padded with white) encoded by libtiff through PIL (`pil_fax`),
    with T4Options `options` (Group 3) and FillOrder `fill_order` (2: the
    stored bits reversed)."""
    h, w = pix.shape
    chunks = []
    for x, y, gw, gh in chunk_grid(h, w, rows_per_strip, tile)[0]:
        part = np.ones((gh, gw), bool)
        block = pix[y:y + gh, x:x + gw]
        part[:block.shape[0], :block.shape[1]] = block
        raw = pil_fax(part, compression, options)
        chunks.append(raw.translate(_REVERSED) if fill_order == 2 else raw)
    code = _FAX_CODES[compression]
    extra = list(kw.pop("extra_tags", ()))
    if options is not None:
        extra.append((292 if code == 3 else 293, 4, [options]))
    return tiff(np.zeros((h, w), np.uint8), bits=1, compression=code,
                photometric=photometric, fill_order=fill_order, tile=tile,
                rows_per_strip=rows_per_strip, chunks=chunks,
                extra_tags=extra, **kw)


# ---------------------------------------------------------------- frames

def encode_frame(fmt: str, gray: np.ndarray, bgr: np.ndarray,
                 jpg: bytes) -> bytes:
    """One frame (gray (h, w), bgr (3, h, w) uint8 planes as cv::imread
    reads the JPEG frame `jpg`) in format `fmt` of FORMATS."""
    h, w = gray.shape
    rgb = bgr[::-1].transpose(1, 2, 0)
    if fmt == "lzw_pred":
        return tiff(gray, compression=5, predictor=2, rows_per_strip=16)
    if fmt == "deflate_rgb":
        return tiff(rgb, compression=8, predictor=2, rows_per_strip=64)
    if fmt == "packbits_tiled":
        return tiff(rgb, compression=32773, tile=(64, 32))
    if fmt == "gray16":
        lo = (np.arange(gray.size) * 37 & 0xFF).reshape(gray.shape)
        return tiff((gray.astype(np.int64) << 8) | lo, bits=16,
                    rows_per_strip=32)
    if fmt == "jpeg":
        return jpeg_tiff(jpg, w, h)
    if fmt == "ycbcr_lzw":
        return ycbcr_tiff(rgb_to_ycbcr(rgb), (2, 1), compression=5,
                          rows_per_strip=16)
    raise ValueError(fmt)


def write_frames(out_dir: str, planes, jpegs, formats=FORMATS,
                 pool=None) -> dict:
    """Write frame_0000.tif ... of each format into out_dir/<format>/
    from `planes`, a list of (gray, bgr) uint8 arrays per frame, and
    `jpegs`, the JPEG frames' bytes, on the executor `pool` if given.
    Returns {format: [paths]}."""
    def one(fmt, t):
        with open(paths[fmt][t], "wb") as f:
            f.write(encode_frame(fmt, *planes[t], jpegs[t]))

    paths = {}
    for fmt in formats:
        os.makedirs(os.path.join(out_dir, fmt), exist_ok=True)
        paths[fmt] = [os.path.join(out_dir, fmt, f"frame_{t:04d}.tif")
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
    """Small files, one per feature (name -> bytes), written here."""
    rng = np.random.default_rng(16)
    out = {}
    c = _blur(29, 41, 3, 1)
    a = rng.integers(0, 256, (29, 41, 1))
    g = _blur(23, 37, 1, 3)[..., 0]
    g16 = g * 257 + rng.integers(0, 256, g.shape)
    c16 = c * 257 + rng.integers(0, 256, c.shape)
    pal16 = rng.integers(0, 65536, (256, 3))
    idx = rng.integers(0, 256, (21, 35))
    bits = rng.integers(0, 2, (21, 35))
    # compressions, predictor, byte order
    out["gray8.tif"] = tiff(g, rows_per_strip=5)
    out["gray8_lzw_pred.tif"] = tiff(g, compression=5, predictor=2,
                                     rows_per_strip=7)
    out["gray8_deflate_pred.tif"] = tiff(g, compression=8, predictor=2)
    out["gray8_packbits.tif"] = tiff(g, compression=32773,
                                     rows_per_strip=4)
    out["gray8_pred_ignored.tif"] = tiff(g, predictor=2)   # no codec: raw
    out["miniswhite8.tif"] = tiff(g, photometric=0, compression=5)
    out["bilevel.tif"] = tiff(bits, bits=1, compression=32773)
    out["bilevel_white_fill2.tif"] = tiff(bits, bits=1, photometric=0,
                                          fill_order=2, compression=5)
    out["gray16.tif"] = tiff(g16, bits=16, rows_per_strip=6)
    out["gray16_be_lzw_pred.tif"] = tiff(g16, bits=16, compression=5,
                                         predictor=2, big_endian=True)
    out["rgb8_lzw_pred.tif"] = tiff(c, compression=5, predictor=2,
                                    rows_per_strip=8)
    out["rgb8_adobe_deflate.tif"] = tiff(c, compression=32946)
    out["rgb8_planar.tif"] = tiff(c, planar=True, compression=5,
                                  rows_per_strip=10)
    out["rgb8_tiled_packbits.tif"] = tiff(c, tile=(16, 16),
                                          compression=32773)
    out["rgb8_tiled_planar_deflate.tif"] = tiff(c, tile=(32, 16),
                                                planar=True, compression=8)
    out["rgb16.tif"] = tiff(c16, bits=16)
    out["rgb16_be_deflate_pred.tif"] = tiff(c16, bits=16, compression=8,
                                            predictor=2, big_endian=True)
    out["bigtiff_lzw.tif"] = tiff(c, compression=5, big=True,
                                  rows_per_strip=9)
    # alpha and extra samples
    rgba = np.concatenate([c, a], 2)
    out["rgba_assoc.tif"] = tiff(rgba, extra_samples=[1])
    out["rgba_unassoc.tif"] = tiff(rgba, extra_samples=[2], compression=5)
    out["rgba_unassoc16.tif"] = tiff(np.concatenate([c16, a * 257], 2),
                                     bits=16, extra_samples=[2])
    out["rgba_planar_unassoc.tif"] = tiff(rgba, extra_samples=[2],
                                          planar=True)
    out["rgba_unspecified.tif"] = tiff(rgba, extra_samples=[0])
    ga = np.stack([g, rng.integers(0, 256, g.shape)], 2)
    out["gray_alpha.tif"] = tiff(ga, extra_samples=[2])
    out["gray_alpha_planar_unassoc.tif"] = tiff(ga, extra_samples=[2],
                                                planar=True)
    # libtiff reads a clipped tile of more than a byte a pixel off its
    # rows (putgreytile, put16bitbwtile, put8bitcmaptile)
    out["gray_alpha_tiled.tif"] = tiff(ga, extra_samples=[2],
                                       tile=(16, 16), compression=5)
    out["gray16_tiled.tif"] = tiff(g16, bits=16, tile=(16, 16))
    out["palette8_alpha_tiled.tif"] = tiff(
        np.stack([idx, idx[::-1]], 2), colormap=pal16, extra_samples=[0],
        tile=(16, 16), compression=8)
    # palettes
    out["palette8.tif"] = tiff(idx, colormap=pal16, compression=5)
    out["palette8_cmap8.tif"] = tiff(idx, colormap=pal16 >> 8)
    out["palette4.tif"] = tiff(idx % 16, bits=4, colormap=pal16[:16],
                               compression=32773)
    out["palette1.tif"] = tiff(bits, bits=1, colormap=pal16[:2])
    # CMYK, signed samples, orientations
    cmyk = np.concatenate([c, a], 2)
    out["cmyk.tif"] = tiff(cmyk, photometric=5, compression=5)
    out["cmyk_planar.tif"] = tiff(cmyk, photometric=5, planar=True)
    out["int8.tif"] = tiff(g, sample_format=2)
    for o in (2, 3, 4):
        out[f"orient{o}.tif"] = tiff(c, orientation=o, rows_per_strip=8)
        out[f"orient{o}_tiled.tif"] = tiff(c, orientation=o, tile=(16, 16),
                                           compression=5)
    # JPEG-in-TIFF from the JPEG fixtures' bitstreams
    for name, sub in (("s420", (2, 2)), ("s444", (1, 1)),
                      ("s422", (2, 1))):
        with open(os.path.join(JPEG_DIR, "variants", f"{name}.jpg"),
                  "rb") as f:
            out[f"jpeg_ycbcr_{name}.tif"] = jpeg_tiff(f.read(), 83, 61, sub)
    with open(os.path.join(JPEG_DIR, "variants", "gray.jpg"), "rb") as f:
        out["jpeg_gray_tables.tif"] = jpeg_tiff(f.read(), 83, 61, None)
    # YCbCr without JPEG: every subsampling at sizes of partial blocks, the
    # compressions, tiles, coefficients and reference black and white
    ycc = rgb_to_ycbcr(c)
    for k, (sub, comp) in enumerate((((4, 4), 1), ((4, 2), 5), ((4, 1), 8),
                                     ((2, 2), 32773), ((2, 1), 32946),
                                     ((1, 2), 5), ((1, 1), 1))):
        out[f"ycbcr_{sub[0]}{sub[1]}.tif"] = ycbcr_tiff(
            ycc[:27 - k, :39 - k], sub, compression=comp, rows_per_strip=8)
    out["ycbcr_22_tiled.tif"] = ycbcr_tiff(ycc, (2, 2), compression=5,
                                           tile=(16, 16))
    out["ycbcr_44_tiled.tif"] = ycbcr_tiff(ycc, (4, 4), tile=(32, 16))
    out["ycbcr_11_pred.tif"] = ycbcr_tiff(ycc, (1, 1), compression=8,
                                          predictor=2)
    out["ycbcr_default_22.tif"] = ycbcr_tiff(ycc, (2, 2),
                                             omit_subsampling=True)
    out["ycbcr_rec709.tif"] = ycbcr_tiff(
        ycc, (2, 1), compression=5, luma=[(2126, 10000), (7152, 10000),
                                          (722, 10000)],
        ref_bw=[(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])
    out["ycbcr_orient3.tif"] = ycbcr_tiff(ycc, (2, 2), orientation=3,
                                          rows_per_strip=8)
    # variants cv::imread fails on (null in the manifest)
    out["fails_ycbcr_14.tif"] = ycbcr_tiff(ycc, (1, 4))
    out["fails_orient6.tif"] = tiff(c, orientation=6)
    out["fails_gray4.tif"] = tiff(g % 16, bits=4)
    out["fails_float32.tif"] = tiff(
        np.frombuffer(g.astype(np.float32).tobytes(), np.uint32).reshape(
            g.shape), bits=32, sample_format=3)
    out["fails_uint32.tif"] = tiff(g, bits=32)
    out["fails_rgb4.tif"] = tiff(c % 16, bits=4)
    out["fails_rows_per_strip0.tif"] = tiff(g, extra_tags=((278, 4, [0]),))
    out["fails_no_photometric.tif"] = tiff(g, omit=(262,))
    out["fails_lzma.tif"] = tiff(g, chunks=[b"\0" * 16],
                                 extra_tags=((259, 3, [34925]),))
    return out


def written_variants() -> dict:
    """Small files cv2 and PIL write (name -> bytes)."""
    import io
    import cv2
    from PIL import Image
    out = {}
    c = _blur(37, 45, 3, 7).astype(np.uint8)
    for comp, name in ((1, "none"), (5, "lzw"), (8, "deflate"),
                       (32773, "packbits"), (32946, "adobe_deflate"),
                       (7, "jpeg")):
        for img, kind in ((c, "bgr"), (c[..., 1], "gray")):
            ok, enc = cv2.imencode(".tif", img,
                                   [cv2.IMWRITE_TIFF_COMPRESSION, comp])
            assert ok
            out[f"cv2_{name}_{kind}.tif"] = enc.tobytes()
    im = Image.fromarray(c[..., ::-1].copy())
    for mode, comp in (("YCbCr", "jpeg"), ("L", "jpeg"), ("RGB", "jpeg"),
                       ("RGBA", "tiff_lzw"), ("CMYK", "packbits"),
                       ("LA", "tiff_deflate"), ("P", "tiff_lzw"),
                       ("1", "tiff_lzw")):
        buf = io.BytesIO()
        im.convert(mode).save(buf, "TIFF", compression=comp)
        out[f"pil_{mode.lower()}_{comp}.tif"] = buf.getvalue()
    buf = io.BytesIO()
    im.save(buf, "TIFF", big_tiff=True, compression="tiff_deflate")
    out["pil_bigtiff_deflate.tif"] = buf.getvalue()
    # YCbCr (1x1, ReferenceBlackWhite as RATIONALs), RGBA and CMYK JPEG
    rgba = np.concatenate([c[..., ::-1], (np.arange(37 * 45).reshape(
        37, 45, 1) * 7 % 256)], 2).astype(np.uint8)
    for mode, comp, img in (("YCbCr", "raw", im), ("YCbCr", "tiff_lzw", im),
                            ("RGBA", "jpeg", Image.fromarray(rgba)),
                            ("CMYK", "jpeg", im)):
        buf = io.BytesIO()
        img.convert(mode).save(buf, "TIFF", compression=comp)
        out[f"pil_{mode.lower()}_{comp}.tif"] = buf.getvalue()
    # CCITT fax, by libtiff's encoder: each codec and Group 3 option, and
    # chunks of its output re-laid as tiles, strips and fill order 2
    bilevel = c[..., 1] > 120
    for comp, opts in (("tiff_ccitt", None), ("group3", None),
                       ("group3", 1), ("group3", 4), ("group3", 5),
                       ("group4", None)):
        buf = io.BytesIO()
        Image.fromarray(bilevel).save(
            buf, "TIFF", compression=comp,
            **({} if opts is None else {"tiffinfo": {292: opts}}))
        out[f"pil_1_{comp}{'' if opts is None else opts}.tif"] = \
            buf.getvalue()
    out["fax_g4_tiled.tif"] = fax_tiff(bilevel, "group4", tile=(16, 16))
    out["fax_g3_2d_strips_fill2.tif"] = fax_tiff(
        bilevel, "group3", 1, rows_per_strip=5, fill_order=2)
    out["fax_rle_miniswhite.tif"] = fax_tiff(bilevel, "tiff_ccitt",
                                             photometric=0)
    return out


def committed_sets() -> dict:
    """The committed frame sets (COMMITTED; "dir/frame_000k.tif" ->
    bytes), from the JPEG frames as cv2.imread decodes them: Group 4 of
    the gray planes box-blurred and thresholded at 128, and frames 0-1
    as PIL's RGBA (alpha 255) and CMYK JPEG-in-TIFF (quality 75)."""
    import io
    from PIL import Image
    planes, _ = jpeg_frames()
    out = {}
    for t, (gray, _) in enumerate(planes[:COMMITTED["fax_g4"]]):
        g = gray.astype(np.int64)
        for _ in range(2):          # a 5x5 box, twice
            g = sum(np.roll(np.roll(g, i, 0), j, 1) for i in range(-2, 3)
                    for j in range(-2, 3)) // 25
        out[f"fax_g4/frame_{t:04d}.tif"] = fax_tiff(g >= 128, "group4")
    for mode in ("rgba", "cmyk"):
        for t, (_, bgr) in enumerate(planes[:2]):
            im = Image.fromarray(np.ascontiguousarray(
                bgr[::-1].transpose(1, 2, 0))).convert(mode.upper())
            buf = io.BytesIO()
            im.save(buf, "TIFF", compression="jpeg")
            out[f"pairs/{mode}_jpeg/frame_{t:04d}.tif"] = buf.getvalue()
    return out


def chunk_table(raw: bytes):
    """((offset, byte count, where the count is stored, its size), ...) of
    the chunks of a classic TIFF, little- or big-endian."""
    order = "<" if raw[:2] == b"II" else ">"
    ifd = struct.unpack(order + "I", raw[4:8])[0]
    tags = {}
    for k in range(struct.unpack(order + "H", raw[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * k
        tag, typ, count = struct.unpack(order + "HHI", raw[at:at + 8])
        tags[tag] = (typ, count, at + 8)

    def array(tag):
        typ, count, at = tags[tag]
        size = 2 if typ == 3 else 4
        if size * count > 4:
            at = struct.unpack(order + "I", raw[at:at + 4])[0]
        code = order + ("H" if size == 2 else "I")
        return [(struct.unpack(code, raw[at + size * i:at + size * (i + 1)])
                 [0], at + size * i, size) for i in range(count)]

    offs = array(273 if 273 in tags else 324)
    counts = array(279 if 279 in tags else 325)
    return [(o, c, at, size) for (o, _, _), (c, at, size) in zip(offs, counts)]


def _tag(raw: bytes, tag: int) -> int:
    """The first value of a SHORT or LONG tag of a little-endian classic
    TIFF."""
    ifd = struct.unpack("<I", raw[4:8])[0]
    for k in range(struct.unpack("<H", raw[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * k
        t, typ = struct.unpack("<HH", raw[at:at + 4])
        if t == tag:
            return struct.unpack("<H" if typ == 3 else "<I",
                                 raw[at + 8:at + (10 if typ == 3 else 12)])[0]
    raise KeyError(tag)


def damage_edits(raw: bytes, t: int, first: int, step: int, where: float,
                 keep: float) -> list:
    """Frame t's edits of a DAMAGED set (see the module's docstring)."""
    table = chunk_table(raw)
    off, count, at, size = table[(first + step * t) % len(table)]
    if t % 3 == 1:
        flip = off + int(count * where)
        if _tag(raw, 259) == 32773:     # the next control byte
            k = off
            while k < flip:
                c = raw[k]
                k += 2 if c > 128 else 1 if c == 128 else c + 2
            flip = k
        return [["xor", flip, 0x5A]]
    if t % 3 == 2:
        new = int(count * keep)
        return [["xor", at + k, ((count ^ new) >> (8 * k)) & 0xFF]
                for k in range(size) if ((count ^ new) >> (8 * k)) & 0xFF]
    return []


def damaged_sets(sources: dict) -> dict:
    """{set: [{"name", "source", "edits"}]} of DAMAGED, from `sources`
    ({"set/frame_000k.tif": bytes}, the sets' intact frames)."""
    out = {}
    for name, args in DAMAGED.items():
        out[name] = [{"name": f"frame_{t:04d}.tif",
                      "source": f"{name}/frame_{t:04d}.tif",
                      "edits": damage_edits(
                          sources[f"{name}/frame_{t:04d}.tif"], t, *args)}
                     for t in range(9)]
    return out


def damaged_entry(frame_root: str, scratch: str) -> dict:
    """The manifest's "damaged" entry: the sets, the SHA-256 of each
    source frame (the generated sets under `frame_root`, fax_g4 the
    committed files), and cv2.imread's planes of each damaged frame
    (written under `scratch`) with the share of gray pixels changed."""
    import cv2
    sys.path.insert(0, JPEG_DIR)
    from damage import damage
    sys.path.pop(0)
    sources = {}
    for name in DAMAGED:
        base = HERE if name in COMMITTED else frame_root
        for t in range(9):
            with open(os.path.join(base, name, f"frame_{t:04d}.tif"),
                      "rb") as f:
                sources[f"{name}/frame_{t:04d}.tif"] = f.read()
    sets = damaged_sets(sources)
    recs = {}
    for name, frames in sets.items():
        for fr in frames:
            src = sources[fr["source"]]
            path = os.path.join(scratch, "damaged", name, fr["name"])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "wb") as f:
                f.write(damage(src, fr["edits"]))
            intact = os.path.join(scratch, "intact.tif")
            with open(intact, "wb") as f:
                f.write(src)
            a = cv2.imread(intact, cv2.IMREAD_GRAYSCALE)
            b = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
            recs[f"{name}/{fr['name']}"] = {
                "changed": float((a != b).mean()), **planes(path)}
    return {"sets": sets, "planes": recs,
            "sources": {rel: hashlib.sha256(raw).hexdigest()
                        for rel, raw in sorted(sources.items())}}


def planes(path: str) -> dict:
    """cv2.imread's gray and colour planes of `path`, (C, H, W) layout:
    shape and SHA-256, None where cv2.imread fails."""
    import cv2
    rec = {}
    for key, flag in (("gray", cv2.IMREAD_GRAYSCALE),
                      ("color", cv2.IMREAD_COLOR)):
        try:
            img = cv2.imread(path, flag)
        except cv2.error:
            img = None
        if img is None:
            rec[key] = None
            continue
        chw = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
        rec[key] = {"shape": list(chw.shape), "sha256": hashlib.sha256(
            np.ascontiguousarray(chw).tobytes()).hexdigest()}
    return rec


def jpeg_frames() -> tuple:
    """cv2.imread's (gray, bgr) planes of the nine JPEG frames, and their
    bytes."""
    import cv2
    names = sorted(os.listdir(os.path.join(JPEG_DIR, "frames")))
    out, raws = [], []
    for n in names:
        p = os.path.join(JPEG_DIR, "frames", n)
        out.append((cv2.imread(p, cv2.IMREAD_GRAYSCALE),
                    np.ascontiguousarray(cv2.imread(p).transpose(2, 0, 1))))
        with open(p, "rb") as f:
            raws.append(f.read())
    return out, raws


def main(scratch: str) -> dict:
    import cv2
    files = {}
    os.makedirs(os.path.join(HERE, "variants"), exist_ok=True)
    made = {**variants(), **written_variants()}
    for name, raw in sorted(made.items()):
        path = os.path.join(HERE, "variants", name)
        with open(path, "wb") as f:
            f.write(raw)
        files[f"variants/{name}"] = {"bytes": len(raw), **planes(path)}
    committed = {}
    for rel, raw in sorted(committed_sets().items()):
        path = os.path.join(HERE, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(raw)
        committed[rel] = {"bytes": len(raw), **planes(path)}
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        motion = json.load(f)["motion_px"]
    frames = {}
    for fmt, paths in write_frames(scratch, *jpeg_frames()).items():
        for p in paths:
            frames[f"{fmt}/{os.path.basename(p)}"] = planes(p)
    manifest = {"cv2": cv2.__version__, "motion_px": motion,
                "frame_size": [1024, 436], "files": files, "frames": frames,
                "committed": committed,
                "damaged": damaged_entry(scratch, scratch)}
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
          f"{len(m['frames'])} frames, {len(m['committed'])} committed "
          f"frames ({sum(r['bytes'] for r in m['committed'].values())} "
          "bytes)")
