"""Writers of GIF files in numpy and the standard library, the frames of
chip_smoke.py part 7e, and the fixtures of tests/test_torch_gif.py.

    python tests/torch_fixtures/gif/make_fixtures.py

writes `variants/` (small files, one a feature the port's decoder must
read: GIF87a and GIF89a, global and local colour tables, a frame offset
inside the logical screen, interlace, the transparent index, every
minimum code size, a full code table without a Clear, an animation's
first frame, cv2- and PIL-written files) and `manifest.json`: per file
the shape and SHA-256 of cv2.imread's gray (IMREAD_GRAYSCALE) and colour
(IMREAD_COLOR) planes, laid out as the port lays them out ((C, H, W)
uint8, C-contiguous), null for a read cv2.imread fails on; and the same
of the frames `write_frames` makes, which are not committed
(chip_smoke.py writes them on the card's host, where there is no cv2,
and holds the port's decoder to these hashes). Needs cv2 for the
manifest and PIL for its PIL-written variants.

The frames: the nine 1024x436 JPEG frames of ../jpeg (moving 1.3, 0.4 px
a frame), as cv2.imread decodes them, re-encoded as
  - gray256: their gray planes under a 256-level gray palette, which
    holds a gray frame without loss;
  - gray256_interlaced: the same, interlaced, in an animation's first
    frame (a NETSCAPE2.0 loop, a second frame after it).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(os.path.dirname(HERE), "jpeg")
FORMATS = ("gray256", "gray256_interlaced")


def lzw(indices: bytes, min_size: int, clear_every: int = None,
        defer: bool = False) -> bytes:
    """GIF LZW of `indices` as giflib's encoder writes it: codes LSB-first
    from min_size + 1 bits, one bit more once a code is written while the
    next free code is 2^n or more, up to 12; Clear first, End last. When
    the next free code reaches 4095 it sends Clear, or with `defer` goes
    on with a full table; after `clear_every` codes, a Clear anyway."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nacc = 0
    width, nxt, since = min_size + 1, end + 1, 0
    table = {}                  # (prefix code << 8 | index) -> code

    def put(code):
        nonlocal acc, nacc, width
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8
        if nxt >= 1 << width and width < 12:
            width += 1

    put(clear)
    w = -1
    for b in indices:
        if w < 0:
            w = b
            continue
        key = (w << 8) | b
        code = table.get(key)
        if code is not None:
            w = code
            continue
        put(w)
        since += 1
        w = b
        if (nxt >= 4095 and not defer) or (clear_every
                                           and since >= clear_every):
            put(clear)
            table, nxt, width, since = {}, end + 1, min_size + 1, 0
        elif nxt < 4096:
            table[key] = nxt
            nxt += 1
    if w >= 0:
        put(w)
    put(end)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def _blocks(data: bytes) -> bytes:
    """Data sub-blocks of up to 255 bytes and the block terminator."""
    out = bytearray()
    for i in range(0, len(data), 255):
        out.append(len(data[i:i + 255]))
        out += data[i:i + 255]
    return bytes(out + b"\0")


def _table(colours) -> tuple:
    """(size field, bytes) of a colour table of (n, 3) R, G, B entries,
    padded with black to a power of two of at least 2 entries."""
    colours = np.asarray(colours, np.uint8).reshape(-1, 3)
    k = max(1, int(np.ceil(np.log2(max(len(colours), 2)))))
    pad = np.zeros((1 << k, 3), np.uint8)
    pad[:len(colours)] = colours
    return k - 1, pad.tobytes()


def frame(indices: np.ndarray, *, left: int = 0, top: int = 0,
          local=None, interlace: bool = False, min_size: int = 8,
          transparent: int = None, disposal: int = 0, delay: int = 0,
          gce: bool = None, defer: bool = False, clear_every: int = None,
          data: bytes = None) -> bytes:
    """One image: a Graphic Control Extension (where `gce`, or where a
    transparent index is given), the image descriptor at (left, top),
    its local colour table, LZW data of `indices` (h, w) row by row (in
    interlaced order where `interlace`), or `data` as it is."""
    h, w = indices.shape
    out = bytearray()
    if gce or transparent is not None:
        flags = (disposal << 2) | (1 if transparent is not None else 0)
        out += b"\x21\xf9\x04" + struct.pack("<BHB", flags, delay,
                                              transparent or 0) + b"\0"
    flags = 0x40 if interlace else 0
    lct = b""
    if local is not None:
        size, lct = _table(local)
        flags |= 0x80 | size
    out += b"\x2c" + struct.pack("<HHHHB", left, top, w, h, flags) + lct
    rows = indices
    if interlace:
        order = [y for start, step in ((0, 8), (4, 8), (2, 4), (1, 2))
                 for y in range(start, h, step)]
        rows = indices[order]
    if data is None:
        data = lzw(rows.astype(np.uint8).tobytes(), min_size,
                   clear_every=clear_every, defer=defer)
    return bytes(out) + bytes([min_size]) + _blocks(data)


def gif(frames, width: int, height: int, palette=None, *,
        version: bytes = b"89a", background: int = 0, loop: bool = False,
        extensions: bytes = b"") -> bytes:
    """A GIF of logical screen width x height, global colour table
    `palette` ((n, 3) R, G, B, or None), the `frames` (from `frame`)."""
    flags = 0
    gct = b""
    if palette is not None:
        size, gct = _table(palette)
        flags = 0x80 | 0x70 | size
    out = b"GIF" + version + struct.pack("<HHBBB", width, height, flags,
                                         background, 0) + gct
    if loop:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    return out + extensions + b"".join(frames) + b"\x3b"


def gray_palette(levels: int = 256) -> np.ndarray:
    """`levels` gray entries from 0 to 255."""
    v = np.round(np.arange(levels) * 255 / (levels - 1)).astype(np.uint8)
    return np.stack([v, v, v], 1)


# ---------------------------------------------------------------- frames

def encode_frame(fmt: str, gray: np.ndarray) -> bytes:
    """One frame (its gray plane (h, w) uint8) in format `fmt` of
    FORMATS."""
    h, w = gray.shape
    if fmt == "gray256":
        return gif([frame(gray)], w, h, gray_palette())
    if fmt == "gray256_interlaced":
        second = frame(gray[::-1], gce=True, delay=4)
        return gif([frame(gray, interlace=True, gce=True, delay=4), second],
                   w, h, gray_palette(), loop=True)
    raise ValueError(fmt)


def write_frames(out_dir: str, grays, formats=FORMATS, pool=None) -> dict:
    """Write frame_0000.gif ... of each format into out_dir/<format>/
    from `grays`, the frames' gray planes, on the executor `pool` if
    given. Returns {format: [paths]}."""
    def one(fmt, t):
        with open(paths[fmt][t], "wb") as f:
            f.write(encode_frame(fmt, grays[t]))

    paths = {}
    for fmt in formats:
        os.makedirs(os.path.join(out_dir, fmt), exist_ok=True)
        paths[fmt] = [os.path.join(out_dir, fmt, f"frame_{t:04d}.gif")
                      for t in range(len(grays))]
    jobs = [(fmt, t) for fmt in formats for t in range(len(grays))]
    if pool is None:
        for job in jobs:
            one(*job)
    else:
        for fut in [pool.submit(one, *job) for job in jobs]:
            fut.result()
    return paths


# ------------------------------------------------------------- variants

def variants() -> dict:
    """Small files, one per feature (name -> bytes), written here."""
    rng = np.random.default_rng(16)
    out = {}
    h, w = 23, 37
    idx = rng.integers(0, 256, (h, w))
    pal = rng.integers(0, 256, (256, 3))
    # a palette whose gray parts OpenCV's two BGR2GRAY rules (2^-14 and
    # 2^-15): every entry rounds differently under them
    cand = rng.integers(0, 256, (400000, 3))
    b, g, r = cand[:, 2], cand[:, 1], cand[:, 0]
    apart = ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14) != (
        (b * 3735 + g * 19235 + r * 9798 + 16384) >> 15)
    split = cand[apart][:256]
    gray = (np.add.outer(np.arange(h) * 7, np.arange(w) * 3) % 256)
    out["gray256.gif"] = gif([frame(gray)], w, h, gray_palette())
    out["gray_rule.gif"] = gif([frame(np.arange(256).reshape(16, 16))], 16,
                               16, split)
    out["palette.gif"] = gif([frame(idx)], w, h, pal)
    out["gif87a.gif"] = gif([frame(idx)], w, h, pal, version=b"87a")
    out["local_table.gif"] = gif([frame(idx, local=pal[::-1])], w, h, pal)
    out["local_short.gif"] = gif([frame(idx % 64, local=pal[:32])], w, h,
                                 pal)       # indices 32-63 from the global
    out["local_only.gif"] = gif([frame(idx, local=pal)], w, h, None)
    out["no_table.gif"] = gif([frame(idx)], w, h, None)
    sub = idx[:11, :13]
    out["offset.gif"] = gif([frame(sub, left=9, top=5)], w, h, pal,
                            background=77)
    out["offset_no_global.gif"] = gif([frame(sub, left=9, top=5,
                                             local=pal)], w, h, None,
                                      background=77)
    out["transparent.gif"] = gif([frame(idx, transparent=int(idx[0, 0]))],
                                 w, h, pal, background=5)
    out["transparent_offset.gif"] = gif(
        [frame(sub, left=3, top=7, transparent=int(sub[2, 2]),
               local=pal[::-1], disposal=2)], w, h, pal, background=200)
    out["interlaced.gif"] = gif([frame(idx, interlace=True)], w, h, pal)
    out["interlaced_5rows.gif"] = gif([frame(idx[:5], interlace=True)], w,
                                      5, pal)
    for ms in range(2, 8):
        out[f"code_size{ms}.gif"] = gif(
            [frame(idx % (1 << ms), min_size=ms)], w, h, pal[:1 << ms])
    big = rng.integers(0, 4, (96, 120))
    out["full_table_no_clear.gif"] = gif(
        [frame(big, min_size=2, defer=True)], 120, 96, pal[:4])
    out["clear_every_50.gif"] = gif([frame(idx, clear_every=50)], w, h,
                                    pal)
    out["animated.gif"] = gif(
        [frame(idx, gce=True, delay=10), frame(idx[::-1], gce=True,
                                               delay=10, local=pal[::-1])],
        w, h, pal, loop=True)
    out["extensions.gif"] = gif(
        [frame(idx)], w, h, pal, extensions=b"\x21\xfe\x05hello\x00"
        b"\x21\x01\x0c" + bytes(12) + b"\x02hi\x00")
    # variants cv::imread fails on (null in the manifest)
    out["fails_frame_outside.gif"] = gif([frame(sub, left=30, top=5)], w,
                                         h, pal)
    out["fails_background_outside.gif"] = gif(
        [frame(idx % 4, min_size=2)], w, h, pal[:4], background=9)
    out["fails_no_trailer.gif"] = gif([frame(idx)], w, h, pal)[:-1]
    out["fails_end_code_early.gif"] = gif(
        [frame(idx, data=lzw(bytes(idx.astype(np.uint8).ravel()[:100]),
                             8))], w, h, pal)
    out["fails_index_outside.gif"] = gif([frame(idx % 8, min_size=3)], w,
                                         h, pal[:4])
    return out


def written_variants() -> dict:
    """Small files cv2 and PIL write (name -> bytes)."""
    import io
    import cv2
    from PIL import Image
    rng = np.random.default_rng(17)
    out = {}
    bgr = rng.integers(0, 256, (31, 43, 3)).astype(np.uint8)
    bgr[:15] = cv2.GaussianBlur(bgr[:15], (5, 5), 2)
    ok, enc = cv2.imencode(".gif", bgr)
    assert ok
    out["cv2.gif"] = enc.tobytes()
    im = Image.fromarray(bgr[..., ::-1].copy())
    for mode, kw in (("P", {}), ("L", {}), ("1", {}),
                     ("P", {"interlace": True}),
                     ("P", {"transparency": 3})):
        buf = io.BytesIO()
        im.convert(mode).save(buf, "GIF", **kw)
        name = "_".join([mode.lower()] + sorted(kw))
        out[f"pil_{name}.gif"] = buf.getvalue()
    frames = [Image.fromarray(rng.integers(0, 256, (31, 43, 3)).astype(
        np.uint8)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:],
                   loop=0, duration=40)
    out["pil_animated.gif"] = buf.getvalue()
    return out


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


def jpeg_grays() -> list:
    """cv2.imread's gray planes of the nine JPEG frames."""
    import cv2
    names = sorted(os.listdir(os.path.join(JPEG_DIR, "frames")))
    return [cv2.imread(os.path.join(JPEG_DIR, "frames", n),
                       cv2.IMREAD_GRAYSCALE) for n in names]


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
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        motion = json.load(f)["motion_px"]
    frames = {}
    for fmt, paths in write_frames(scratch, jpeg_grays()).items():
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
