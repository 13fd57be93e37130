"""Writers of Sun raster, PAM, Radiance HDR and PFM files in numpy alone,
the frames of chip_smoke.py part 7d, and the fixtures of
tests/test_torch_raster_formats.py.

    python tests/torch_fixtures/raster/make_fixtures.py

writes `variants/` (small files, one a feature the port's decoders must
read: Sun rasters of every depth with and without a colour map, PAM of
each tuple type and odd maxvals, HDR run-length and flat, PFM of both
byte orders and of scales other than 1) and `manifest.json`: per file the
shape and SHA-256 of cv2.imread's gray (IMREAD_GRAYSCALE) and colour
(IMREAD_COLOR) planes, laid out as the port lays them out ((C, H, W)
uint8, C-contiguous), null for a read cv2.imread fails on; and the same
of the frames `write_frames` makes, which are not committed (chip_smoke.py
writes them on the card's host, where there is no cv2, and holds the
port's decoders to these hashes). Needs cv2 for the manifest only.

The frames: the nine 1024x436 JPEG frames of ../jpeg (moving 1.3, 0.4 px
a frame), as cv2.imread decodes them, re-encoded as
  - ras24: 24-bit standard Sun raster (B, G, R);
  - ras8: 8-bit Sun raster with a 3-3-2 colour map;
  - pam_rgb: 8-bit RGB PAM;
  - pam16: 16-bit GRAYSCALE PAM, the gray plane in the high byte;
  - hdr: run-length Radiance HDR of the colour planes over 255;
  - pfm: gray PFM of the gray plane plus 0.25, scale -1 (little-endian).
"""

from __future__ import annotations

import hashlib
import json
import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(os.path.dirname(HERE), "jpeg")
FORMATS = ("ras24", "ras8", "pam_rgb", "pam16", "hdr", "pfm")
EXT = {"ras24": "ras", "ras8": "ras", "pam_rgb": "pam", "pam16": "pam",
       "hdr": "hdr", "pfm": "pfm"}

SUN_MAGIC = 0x59A66A95


def ras(pix: np.ndarray, depth: int, cmap=None, typ: int = 1) -> bytes:
    """A Sun raster: pix (h, w) indices or bits for depth 1 / 8, (h, w, 3)
    B, G, R for 24, (h, w, 4) pad, B, G, R for 32; cmap (n, 3) R, G, B
    entries (stored as R, G and B thirds); rows padded to 16 bits."""
    h, w = pix.shape[:2]
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    if depth == 1:
        rows = np.packbits(pix.astype(np.uint8), axis=1)
    else:
        rows = pix.astype(np.uint8).reshape(h, -1)
    body = np.zeros((h, pitch), np.uint8)
    body[:, :rows.shape[1]] = rows
    cm = b"" if cmap is None else np.ascontiguousarray(
        np.asarray(cmap, np.uint8).T).tobytes()
    header = struct.pack(">8I", SUN_MAGIC, w, h, depth, body.size, typ,
                         0 if cmap is None else 1, len(cm))
    return header + cm + body.tobytes()


def pam(pix: np.ndarray, maxval: int, tupltype=None, comment=b"",
        newline=b"\n") -> bytes:
    """A PAM (P7): pix (h, w) or (h, w, depth) samples, big-endian 16-bit
    above maxval 255; for maxval 1, rows of width * depth bytes whose
    leading bits are the pixels, as OpenCV's reader takes them."""
    h, w = pix.shape[:2]
    depth = 1 if pix.ndim == 2 else pix.shape[2]
    nl = newline
    head = (b"P7" + nl + comment + b"WIDTH %d" % w + nl + b"HEIGHT %d" % h
            + nl + b"DEPTH %d" % depth + nl + b"MAXVAL %d" % maxval + nl)
    if tupltype:
        head += b"TUPLTYPE " + tupltype + nl
    head += b"ENDHDR" + nl
    if maxval == 1:
        bits = np.packbits(pix.reshape(h, w * depth)[:, :w].astype(np.uint8),
                           axis=1)
        body = np.zeros((h, w * depth), np.uint8)
        body[:, :bits.shape[1]] = bits
        return head + body.tobytes()
    dtype = ">u2" if maxval > 255 else np.uint8
    return head + pix.astype(dtype).tobytes()


def rgbe(rgb: np.ndarray) -> np.ndarray:
    """Float R, G, B (h, w, 3) to RGBE bytes (h, w, 4) as Ward's
    float2rgbe: the largest component's exponent, mantissas * 256."""
    v = rgb.max(axis=2)
    m, e = np.frexp(v)
    scale = np.where(v > 1e-32, m * 256.0 / np.where(v > 0, v, 1), 0)
    out = np.zeros(rgb.shape[:2] + (4,), np.uint8)
    out[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    out[..., 3] = np.where(v > 1e-32, e + 128, 0)
    return out


def hdr(px: np.ndarray, rle: bool = True, magic=b"#?RADIANCE",
        extra=b"") -> bytes:
    """A Radiance HDR of RGBE bytes (h, w, 4): new-style run-length
    scanlines (runs of 3 and more, literals up to 128) where `rle` and the
    width allows, else flat."""
    h, w = px.shape[:2]
    out = bytearray(magic + b"\n" + extra + b"FORMAT=32-bit_rle_rgbe\n\n"
                    + b"-Y %d +X %d\n" % (h, w))
    if not rle or w < 8 or w > 0x7FFF:
        return bytes(out) + px.tobytes()
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            v = px[y, :, c]
            # run starts: where 3 or more equal values begin
            same = np.concatenate([[False], v[1:] == v[:-1]])
            i = 0
            while i < w:
                j = i + 1
                while j < w and same[j] and j - i < 127:
                    j += 1
                if j - i >= 3:
                    out += bytes([128 + j - i, v[i]])
                    i = j
                    continue
                k = i
                while k < w and k - i < 128 and not (
                        k + 2 < w and v[k] == v[k + 1] == v[k + 2]):
                    k += 1
                k = max(k, i + 1)
                out += bytes([k - i]) + v[i:k].tobytes()
                i = k
    return bytes(out)


def pfm(values: np.ndarray, scale: float = -1.0) -> bytes:
    """A PFM of float (h, w) gray ('Pf') or (h, w, 3) R, G, B ('PF')
    values, rows bottom-up, little-endian for a negative scale."""
    h, w = values.shape[:2]
    magic = b"PF" if values.ndim == 3 else b"Pf"
    data = values[::-1].astype("<f4" if scale < 0 else ">f4").tobytes()
    return magic + b"\n%d %d\n%s\n" % (w, h, repr(scale).encode()) + data


def palette332() -> np.ndarray:
    """The 256 RGB colours of the 3-3-2 cut, each the middle of its cell."""
    i = np.arange(256)
    r, g, b = i >> 5, (i >> 2) & 7, i & 3
    return np.stack([r * 32 + 16, g * 32 + 16, b * 64 + 32], 1).astype(
        np.uint8)


def encode_frame(fmt: str, gray: np.ndarray, bgr: np.ndarray) -> bytes:
    """One frame (gray (h, w), bgr (3, h, w) uint8 planes, as cv::imread
    reads the JPEG) in format `fmt` of FORMATS."""
    b, g, r = (bgr[k].astype(np.int64) for k in range(3))
    if fmt == "ras24":
        return ras(bgr.transpose(1, 2, 0), 24)
    if fmt == "ras8":
        return ras((r >> 5) << 5 | (g >> 5) << 2 | (b >> 6), 8, palette332())
    if fmt == "pam_rgb":
        return pam(np.stack([r, g, b], 2), 255, b"RGB")
    if fmt == "pam16":
        lo = (np.arange(gray.size) * 37 & 0xFF).reshape(gray.shape)
        return pam((gray.astype(np.int64) << 8) | lo, 65535, b"GRAYSCALE")
    if fmt == "hdr":
        return hdr(rgbe(np.stack([r, g, b], 2) / 255.0))
    if fmt == "pfm":
        return pfm(gray.astype(np.float32) + np.float32(0.25))
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
    rng = np.random.default_rng(15)
    out = {}
    c = _blur(29, 41, 3, 1)
    gray = _blur(23, 31, 1, 3)[..., 0]
    pal = rng.integers(0, 256, (256, 3))
    idx = rng.integers(0, 256, (9, 13))
    bits = rng.integers(0, 2, (9, 13))
    out["ras1.ras"] = ras(bits, 1)
    out["ras1_map.ras"] = ras(bits, 1, pal[:2])
    out["ras8.ras"] = ras(idx, 8)
    out["ras8_old.ras"] = ras(idx, 8, typ=0)
    out["ras8_map.ras"] = ras(idx, 8, pal)
    out["ras8_map10.ras"] = ras(idx, 8, pal[:10])    # black past entry 10
    out["ras8_graymap.ras"] = ras(idx, 8, np.repeat(
        np.arange(256)[::-1, None], 3, 1))
    out["ras24.ras"] = ras(c, 24)
    out["ras24_odd.ras"] = ras(c[:7, :5], 24)
    out["ras32.ras"] = ras(np.concatenate([_blur(29, 41, 1, 5), c], 2), 32)
    out["pam_gray.pam"] = pam(gray, 255, b"GRAYSCALE")
    out["pam_gray_notype.pam"] = pam(gray, 255, comment=b"# a comment\n")
    out["pam_gray_maxval99.pam"] = pam(gray * 99 // 255, 99, b"GRAYSCALE")
    out["pam_gray16.pam"] = pam(gray * 257 + 13, 65535, b"GRAYSCALE")
    out["pam_gray_maxval1000.pam"] = pam(gray * 1000 // 255, 1000,
                                         b"GRAYSCALE")
    out["pam_rgb.pam"] = pam(c, 255, b"RGB")
    out["pam_rgb_notype.pam"] = pam(c, 255)
    out["pam_rgb16.pam"] = pam(c * 257 + 5, 65535, b"RGB")
    out["pam_bw.pam"] = pam(rng.integers(0, 2, (9, 21)), 1,
                            b"BLACKANDWHITE")
    out["pam_rgb_maxval1.pam"] = pam(rng.integers(0, 2, (9, 21, 3)), 1,
                                     b"RGB")
    out["pam_bw_maxval255.pam"] = pam(gray, 255, b"BLACKANDWHITE")
    out["pam_crlf.pam"] = pam(gray, 255, b"GRAYSCALE", newline=b"\r\n")
    e = rng.integers(100, 150, (13, 21, 1))
    px = np.concatenate([_blur(13, 21, 3, 6), e], 2).astype(np.uint8)
    px[0, :3, 3] = 0                                # zero exponents
    px[1, :2, 3] = 255                              # values above 2^31
    px[2:5, :12] = px[2:5, :1]                      # runs
    out["hdr_rle.hdr"] = hdr(px)
    out["hdr_flat.hdr"] = hdr(px, rle=False)
    out["hdr_rgbe_magic.hdr"] = hdr(px, magic=b"#?RGBE",
                                    extra=b"EXPOSURE=2.0\n# comment\n")
    out["hdr_narrow.hdr"] = hdr(px[:, :5])          # width < 8: flat
    half = (np.arange(40) % 2).astype(np.uint8)     # c * 255 / 2: ties
    tie = np.stack([np.arange(40, 80), np.arange(80, 120), np.arange(40),
                    np.full(40, 135)], 1).astype(np.uint8)[None]
    out["hdr_ties.hdr"] = hdr(tie | np.stack([half] * 3 + [0 * half],
                                             1)[None])
    v = rng.random((11, 17)).astype(np.float32) * 300 - 20
    v[0, :10] = np.arange(10) + 0.5                 # ties to even
    v[1, :4] = (np.nan, np.inf, -np.inf, 3e9)
    out["pfm_le.pfm"] = pfm(v, -1.0)
    out["pfm_be_scale3.pfm"] = pfm(v, 3.0)
    out["pfm_scale07.pfm"] = pfm(v, -0.7)
    out["pfm_color.pfm"] = pfm(np.stack([v, v * 0.5, 255 - v], 2), -1.0)
    return out


def planes(path: str) -> dict:
    """cv2.imread's gray and colour planes of `path`, (C, H, W) layout:
    shape and SHA-256, None where cv2.imread fails."""
    import cv2
    rec = {}
    for key, flag in (("gray", cv2.IMREAD_GRAYSCALE),
                      ("color", cv2.IMREAD_COLOR)):
        img = cv2.imread(path, flag)
        if img is None:
            rec[key] = None
            continue
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
