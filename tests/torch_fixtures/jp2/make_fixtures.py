"""The JPEG 2000 fixtures of tests/test_torch_jp2.py and chip_smoke.py
part 7f, and the codestream edits the tests make.

    python tests/torch_fixtures/jp2/make_fixtures.py

writes, with Pillow (OpenJPEG) and cv2 as encoders:
  - `frames/frame_0000.jp2` ... `frame_0008.jp2`: the nine 1024x436 JPEG
    frames of ../jpeg (moving 1.3, 0.4 px a frame), as cv2.imread decodes
    them in colour, RGB 9/7 with the irreversible component transform at
    20:1 (`lossy`);
  - `lossless/gray_0000.jp2` ... `gray_0002.jp2`: frames 0-2's gray
    planes, 5/3 without loss (`lossless`);
  - `variants/`: small files, one a feature the port's decoder must read
    (tiles with partial edges, precincts, code-block sizes, the five
    progression orders, quality layers, resolution counts, 9/7 and 5/3
    with and without the component transform, PLT, comments, raw
    codestreams, RGBA, gray + alpha, 16-bit random values, the 2K cinema
    profile at 2048x1080, cv2-written files) or one cv::imread fails on
    (`fails_*`: a signed component, precision 7, an image offset, five
    components, CMYK, a precinct of 2^0 above the lowest resolution);
and `manifest.json`: per file the shape and SHA-256 of cv2.imread's gray
(IMREAD_GRAYSCALE) and colour (IMREAD_COLOR) planes, laid out as the port
lays them out ((C, H, W) uint8, C-contiguous), null for a read cv2.imread
fails on. The card's host has no JPEG 2000 encoder, so every file is
committed. A rerun with the same OpenJPEG writes the same bytes.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import struct

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_DIR = os.path.join(os.path.dirname(HERE), "jpeg")
LOSSY = dict(irreversible=True, quality_mode="rates", quality_layers=[20],
             mct=1)


def pil_encode(array: np.ndarray, ext: str = ".jp2", **options) -> bytes:
    """Pillow's JPEG 2000 file (`.j2k`: a raw codestream) of `array`:
    (h, w) uint8 L or uint16 I;16, (h, w, 2) LA, (h, w, 3) RGB, (h, w, 4)
    RGBA."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, "JPEG2000", no_jp2=ext == ".j2k",
                                **options)
    return buf.getvalue()


# ----------------------------------------------------- codestream edits

def codestream_at(raw: bytes) -> int:
    """The offset of the codestream (SOC) in a JP2 file or a raw one."""
    at = raw.find(b"jp2c")
    return 0 if raw[:2] == b"\xff\x4f" else at + 4


def siz_at(raw: bytes) -> int:
    """The offset of the SIZ marker's Lsiz."""
    return codestream_at(raw) + 4


def patch_siz(raw: bytes, field: str, value: int, comp: int = 0) -> bytes:
    """`raw` with one SIZ field set: "xsiz", "xosiz", "ssiz", "xrsiz",
    "rsiz"."""
    at = siz_at(raw)
    offsets = {"rsiz": (2, ">H"), "xsiz": (4, ">I"), "xosiz": (12, ">I")}
    if field in offsets:
        off, fmt = offsets[field]
    else:
        off, fmt = 38 + 3 * comp + {"ssiz": 0, "xrsiz": 1}[field], ">B"
    size = struct.calcsize(fmt)
    return raw[:at + off] + struct.pack(fmt, value) + \
        raw[at + off + size:]


def insert_marker(raw: bytes, marker: int, body: bytes) -> bytes:
    """`raw` with a marker segment put in its main header after SIZ (and,
    in a JP2 file, its jp2c box grown to match)."""
    at = siz_at(raw)
    lsiz = struct.unpack(">H", raw[at:at + 2])[0]
    seg = struct.pack(">HH", marker, len(body) + 2) + body
    out = raw[:at + lsiz] + seg + raw[at + lsiz:]
    if raw[:2] != b"\xff\x4f":
        box = raw.find(b"jp2c") - 4
        size = struct.unpack(">I", raw[box:box + 4])[0]
        if size:
            out = out[:box] + struct.pack(">I", size + len(seg)) + \
                out[box + 4:]
    return out


def cod_at(raw: bytes) -> int:
    """The offset of the COD marker."""
    at = raw.find(b"\xff\x52", codestream_at(raw))
    assert at > 0
    return at


def patch_cod(raw: bytes, offset: int, value: int) -> bytes:
    """`raw` with the byte `offset` past COD's Lcod set (0 Scod, 1
    progression, 4 MCT, 5 levels, 8 code-block style, 9 transform)."""
    at = cod_at(raw) + 4 + offset
    return raw[:at] + bytes([value]) + raw[at + 1:]


def patch_colr(raw: bytes, enumcs: int) -> bytes:
    at = raw.find(b"colr") + 4
    return raw[:at + 3] + struct.pack(">I", enumcs) + raw[at + 7:]


def five_components(raw: bytes) -> bytes:
    """A raw three-component codestream whose SIZ declares five."""
    at = siz_at(raw)
    lsiz = struct.unpack(">H", raw[at:at + 2])[0]
    comps = raw[at + 38:at + lsiz] + raw[at + 38:at + 44]
    head = raw[:at] + struct.pack(">H", lsiz + 6) + raw[at + 2:at + 36] + \
        struct.pack(">H", 5)
    return head + comps + raw[at + lsiz:]


# --------------------------------------------------------------- images

def smooth(rng, h: int, w: int, c: int, sigma: float = 1.5) -> np.ndarray:
    """Blurred noise with an edge, (h, w, c) uint8."""
    import cv2
    img = cv2.GaussianBlur(rng.integers(0, 256, (h, w, c)).astype(np.uint8),
                           (0, 0), sigma)
    img = img.reshape(h, w, c)
    img[h // 3:h // 2, w // 4:] //= 3
    return img


def gray_rule_colours(rng) -> np.ndarray:
    """16x16 RGB colours whose gray parts OpenCV's two BGR2GRAY rules
    (2^-14 of its image readers, 2^-15 of cvtColor): every one rounds
    differently under them."""
    cand = rng.integers(0, 256, (400000, 3))
    r, g, b = cand[:, 0], cand[:, 1], cand[:, 2]
    apart = ((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14) != (
        (b * 3735 + g * 19235 + r * 9798 + 16384) >> 15)
    return cand[apart][:256].reshape(16, 16, 3).astype(np.uint8)


def variants() -> dict:
    """Small files, one per feature (name -> bytes)."""
    import cv2
    rng = np.random.default_rng(17)
    h, w = 72, 88
    rgb = smooth(rng, h, w, 3)
    gray = np.ascontiguousarray(rgb[..., 1])
    rgba = np.dstack([rgb, rng.integers(0, 256, (h, w, 1), np.uint8)])
    la = np.ascontiguousarray(rgba[..., 2:])
    out = {
        "default_rgb.jp2": pil_encode(rgb),
        "gray.jp2": pil_encode(gray),
        "gray.j2k": pil_encode(gray, ext=".j2k"),
        "rgb.j2k": pil_encode(rgb, ext=".j2k"),
        "rgba.jp2": pil_encode(rgba),
        "rgba.j2k": pil_encode(rgba, ext=".j2k"),
        "la.jp2": pil_encode(la),
        "la.j2k": pil_encode(la, ext=".j2k"),
        "gray16_random.jp2": pil_encode(
            rng.integers(0, 65536, (67, 71)).astype(np.uint16)),
        "gray16_97.jp2": pil_encode(
            (gray.astype(np.uint16) * 257) ^ rng.integers(
                0, 64, (h, w)).astype(np.uint16), irreversible=True),
        "tiles_32x24.jp2": pil_encode(rgb, tile_size=(32, 24)),
        "tiles_37x29_97.jp2": pil_encode(rgb, tile_size=(37, 29),
                                         num_resolutions=3,
                                         irreversible=True, mct=1),
        "tiles_odd_53.j2k": pil_encode(rgb[:67, :81], ext=".j2k",
                                       tile_size=(33, 20),
                                       num_resolutions=4),
        "precincts_16.jp2": pil_encode(rgb, precinct_size=(16, 16),
                                       num_resolutions=4),
        "precincts_32x8.jp2": pil_encode(gray, precinct_size=(32, 8),
                                         codeblock_size=(64, 4)),
        "codeblock_4x64.jp2": pil_encode(gray, codeblock_size=(4, 64)),
        "codeblock_16x16.jp2": pil_encode(rgb, codeblock_size=(16, 16)),
        "layers_3.jp2": pil_encode(rgb, quality_mode="rates",
                                   quality_layers=[40, 10, 2]),
        "layers_db.jp2": pil_encode(rgb, quality_mode="dB",
                                    quality_layers=[30, 40, 50]),
        "resolutions_1.jp2": pil_encode(rgb, num_resolutions=1),
        "resolutions_7.jp2": pil_encode(gray, num_resolutions=7),
        "irreversible.jp2": pil_encode(rgb, irreversible=True),
        "irreversible_mct.jp2": pil_encode(rgb, irreversible=True, mct=1),
        "lossy_20.jp2": pil_encode(rgb, **LOSSY),
        "lossy_gray_50.j2k": pil_encode(gray, ext=".j2k", irreversible=True,
                                        quality_layers=[50]),
        "reversible_mct.jp2": pil_encode(rgb, mct=1),
        "plt.jp2": pil_encode(rgb, plt=True, tile_size=(48, 40)),
        "comment.jp2": pil_encode(gray, comment="fixture"),
        "gray_rule.jp2": pil_encode(gray_rule_colours(rng)),
    }
    for prog in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL"):
        out[f"prog_{prog.lower()}.jp2"] = pil_encode(
            rgb[:71, :83], progression=prog, tile_size=(40, 36),
            precinct_size=(16, 8), codeblock_size=(8, 8),
            quality_layers=[30, 8, 1], num_resolutions=4, mct=1)
    out["prog_rpcl_97.j2k"] = pil_encode(
        rgb, ext=".j2k", progression="RPCL", precinct_size=(32, 32),
        irreversible=True, quality_layers=[16, 4], mct=1)
    # the 2K digital-cinema profile (tile-parts by component, CPRL,
    # 32x32 code-blocks, 256 px precincts, 9/7): a gradient at 2048x1080
    yy, xx = np.mgrid[0:1080, 0:2048]
    cinema = np.stack([xx * 255 // 2047, yy * 255 // 1079,
                       (xx + yy) * 255 // 3126], -1).astype(np.uint8)
    cinema[500:532, 1000:1048] = rng.integers(0, 256, (32, 48, 3))
    out["cinema2k_24.jp2"] = pil_encode(cinema, cinema_mode="cinema2k-24")
    # cv2's writer (.jp2 only)
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    for name, img, params in (
            ("cv2_bgr.jp2", bgr, []),
            ("cv2_gray.jp2", gray, []),
            ("cv2_bgr_x1000.jp2", bgr,
             [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000]),
            ("cv2_gray16.jp2", gray.astype(np.uint16) * 200, [])):
        ok, enc = cv2.imencode(".jp2", img, params)
        assert ok
        out[name] = enc.tobytes()
    # what cv::imread fails on
    out["fails_signed.jp2"] = pil_encode(gray, signed=True)
    out["fails_precision7.j2k"] = patch_siz(out["gray.j2k"], "ssiz", 6)
    out["fails_offset.jp2"] = patch_siz(out["gray.jp2"], "xosiz", 8)
    out["fails_5_components.j2k"] = five_components(out["rgb.j2k"])
    out["fails_cmyk.jp2"] = patch_colr(out["default_rgb.jp2"], 12)
    # Pillow halves 16 px precincts down the six resolutions to a size
    # of 2^0 at a level above the lowest, which the standard forbids
    out["fails_precinct_zero.jp2"] = pil_encode(rgb, precinct_size=(16, 16))
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


def jpeg_frames() -> list:
    """cv2.imread's (gray, BGR) planes of the nine JPEG frames."""
    import cv2
    names = sorted(os.listdir(os.path.join(JPEG_DIR, "frames")))
    paths = [os.path.join(JPEG_DIR, "frames", n) for n in names]
    return [(cv2.imread(p, cv2.IMREAD_GRAYSCALE),
             cv2.imread(p, cv2.IMREAD_COLOR)) for p in paths]


def frames() -> dict:
    """The served frames (relative path -> bytes)."""
    out = {}
    for t, (gray, bgr) in enumerate(jpeg_frames()):
        out[f"frames/frame_{t:04d}.jp2"] = pil_encode(
            np.ascontiguousarray(bgr[..., ::-1]), **LOSSY)
        if t < 3:
            out[f"lossless/gray_{t:04d}.jp2"] = pil_encode(gray)
    return out


def main() -> dict:
    import cv2
    from PIL import features
    made = {f"variants/{k}": v for k, v in variants().items()}
    made.update(frames())
    files = {}
    for rel, raw in sorted(made.items()):
        path = os.path.join(HERE, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(raw)
        files[rel] = {"bytes": len(raw), **planes(path)}
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        motion = json.load(f)["motion_px"]
    manifest = {"cv2": cv2.__version__,
                "openjpeg": features.version("jpg_2000"),
                "motion_px": motion, "frame_size": [1024, 436],
                "files": files}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    m = main()
    print(f"{len(m['files'])} files "
          f"({sum(r['bytes'] for r in m['files'].values())} bytes)")
