"""Write the JPEG fixtures of the port's tests and of chip_smoke.py part 7b,
and their manifest.

    python tests/torch_fixtures/jpeg/make_fixtures.py

Needs cv2 (the encoder, and the decoder whose output the manifest
records) and runs the port on the CPU for the frames' content:
  - frames/frame_0000.jpg ... frame_0008.jpg: nine 1024x436 colour frames,
    quality 90, 4:2:0, of blurred random content (`frames`: a luma and two
    colour-difference planes of `tools.bench_pipeline.frame_stack`, so
    that the chroma planes carry detail of their own) moving by MOTION px
    a frame;
  - variants/*.jpg: small files, one a feature the decoder must read
    (sampling factors, progressive, restart markers, EXIF orientation 6,
    gray, saturated colour blocks, Adobe RGB, a 7x9 frame, Motion-JPEG
    frames without DHT, colour and gray);
  - manifest.json: per file the shape and SHA-256 of cv2.imread's gray
    (IMREAD_GRAYSCALE) and colour (IMREAD_COLOR) planes, laid out as the
    port's decoder lays them out ((C, H, W) uint8, C-contiguous), with the
    cv2 and libjpeg-turbo versions that made them and the frames' motion.
tests/test_torch_jpeg.py holds the manifest to live cv2 and to the port's
decoder; chip_smoke.py holds the card machine's build of the decoder to
it, where there is no cv2.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import struct
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)

from of_dis_tpu_torch.tools import bench_pipeline  # noqa: E402

MOTION = (1.3, 0.4)
CHROMA = 0.5
N_FRAMES, FRAME_H, FRAME_W = 9, 436, 1024
SMALL = (61, 83)
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def frames() -> np.ndarray:
    """(N_FRAMES, H, W, 3) uint8 BGR frames: a luma base L and two colour
    differences d1, d2 (times CHROMA around mid-gray), each its own blurred
    random base moving by MOTION (`frame_stack`), and B = L + d1,
    R = L + d2, G such that 0.299 R + 0.587 G + 0.114 B = L."""
    lum, d1, d2 = (bench_pipeline.frame_stack(
        N_FRAMES, MOTION, seed=seed, device="cpu", h=FRAME_H,
        w=FRAME_W).numpy().astype(np.float32) for seed in range(3))
    d1 = (d1 - 128.0) * CHROMA
    d2 = (d2 - 128.0) * CHROMA
    b, r = lum + d1, lum + d2
    g = lum - (0.114 * d1 + 0.299 * d2) / 0.587
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).round().astype(
        np.uint8)


def blurred(h, w, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur((rng.random((h, w, 3)) * 255).astype(np.float32),
                           (0, 0), 2.0)
    lo, hi = img.min(), img.max()
    return ((img - lo) / max(hi - lo, 1e-6) * 255).round().astype(np.uint8)


def saturated(h, w, seed) -> np.ndarray:
    """Blocks of 0 / 255 in each channel: where a gray read through
    BGR2GRAY parts from the decoded Y plane."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 2, (h // 5 + 1, w // 5 + 1, 3)) * 255
    return np.repeat(np.repeat(cells, 5, 0), 5, 1)[:h, :w].astype(np.uint8)


def encode(img, quality=90, sampling="420", progressive=False, restart=0):
    ok, buf = cv2.imencode(".jpg", img, [
        cv2.IMWRITE_JPEG_QUALITY, quality,
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
        cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    return buf.tobytes()


def segment(code: int, payload: bytes) -> bytes:
    return bytes([0xFF, code]) + struct.pack(">H", len(payload) + 2) + payload


def exif_orientation(value: int, big_endian: bool = False) -> bytes:
    """An APP1 Exif segment whose IFD0 holds one tag, 0x0112 = value."""
    e = ">" if big_endian else "<"
    tiff = ((b"MM\x00\x2a" if big_endian else b"II\x2a\x00")
            + struct.pack(e + "I", 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIHH", 0x0112, 3, 1, value, 0)
            + b"\0\0\0\0")
    return segment(0xE1, b"Exif\0\0" + tiff)


def adobe(transform: int) -> bytes:
    return segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0,
                                                transform))


def after_app0(raw: bytes, insert: bytes, drop_app0: bool = False) -> bytes:
    """`raw` with `insert` after its JFIF APP0 segment (or in its place)."""
    assert raw[2:4] == b"\xff\xe0"
    end = 4 + struct.unpack(">H", raw[4:6])[0]
    return raw[:2] + (b"" if drop_app0 else raw[2:end]) + insert + raw[end:]


def without_dht(raw: bytes) -> bytes:
    """`raw` without its DHT segments before the first SOS, as a
    Motion-JPEG frame that uses the standard Huffman tables comes."""
    pos, out = 2, bytearray(raw[:2])
    while raw[pos + 1] != 0xDA:
        end = pos + 2 + struct.unpack(">H", raw[pos + 2:pos + 4])[0]
        if raw[pos + 1] != 0xC4:
            out += raw[pos:end]
        pos = end
    return bytes(out + raw[pos:])


def variants() -> dict:
    h, w = SMALL
    base = blurred(h, w, 1)
    out = {f"s{s}.jpg": encode(base, sampling=s) for s in SAMPLING}
    out["progressive.jpg"] = encode(base, progressive=True)
    out["restart7.jpg"] = encode(base, restart=7)
    out["orient6.jpg"] = after_app0(encode(base), exif_orientation(6))
    out["gray.jpg"] = encode(cv2.cvtColor(base, cv2.COLOR_BGR2GRAY))
    out["saturated.jpg"] = encode(saturated(h, w, 2))
    out["adobe_rgb.jpg"] = after_app0(encode(base, sampling="444"),
                                      adobe(0), drop_app0=True)
    out["tiny_7x9.jpg"] = encode(saturated(7, 9, 3), quality=50)
    # Motion-JPEG frames: cv2 writes the standard tables, which a decoder
    # installs where a scan uses a table that no DHT defined
    out["no_dht_420.jpg"] = without_dht(encode(base))
    out["no_dht_gray.jpg"] = without_dht(out["gray.jpg"])
    return out


def planes(path: str) -> dict:
    """cv2.imread's gray and colour planes of `path`, (C, H, W) layout:
    shape and SHA-256."""
    rec = {}
    for key, flag in (("gray", cv2.IMREAD_GRAYSCALE),
                      ("color", cv2.IMREAD_COLOR)):
        img = cv2.imread(path, flag)
        chw = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
        chw = np.ascontiguousarray(chw)
        rec[key] = {"shape": list(chw.shape),
                    "sha256": hashlib.sha256(chw.tobytes()).hexdigest()}
    return rec


def libjpeg_version() -> str:
    m = re.search(r"JPEG:\s+(.*)", cv2.getBuildInformation())
    return m.group(1).strip() if m else "unknown"


def main() -> dict:
    files = {}
    os.makedirs(os.path.join(HERE, "frames"), exist_ok=True)
    os.makedirs(os.path.join(HERE, "variants"), exist_ok=True)
    for t, img in enumerate(frames()):
        files[f"frames/frame_{t:04d}.jpg"] = encode(img)
    for name, raw in variants().items():
        files[f"variants/{name}"] = raw
    manifest = {"cv2": cv2.__version__, "libjpeg": libjpeg_version(),
                "motion_px": list(MOTION),
                "frame_size": [FRAME_W, FRAME_H], "files": {}}
    for rel, raw in sorted(files.items()):
        path = os.path.join(HERE, rel)
        with open(path, "wb") as f:
            f.write(raw)
        manifest["files"][rel] = {"bytes": len(raw), **planes(path)}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    m = main()
    print(f"{len(m['files'])} files, "
          f"{sum(r['bytes'] for r in m['files'].values())} bytes")
