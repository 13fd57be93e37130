"""Write the JPEG fixtures of the port's tests and of chip_smoke.py part 7b,
and their manifest.

    python tests/torch_fixtures/jpeg/make_fixtures.py

Needs cv2 (the encoder, and the decoder whose output the manifest
records), PIL (a CMYK file) and gcc (`jpeg_writer.c`, built against the
libjpeg-turbo that Pillow bundles: the arithmetic-coded, lossless, CMYK
and YCCK streams that cv2 and PIL do not write), and runs the port on the
CPU for the frames' content:
  - frames/frame_0000.jpg ... frame_0008.jpg: nine 1024x436 colour frames,
    quality 90, 4:2:0, of blurred random content (`frames`: a luma and two
    colour-difference planes of `tools.bench_pipeline.frame_stack`, so
    that the chroma planes carry detail of their own) moving by MOTION px
    a frame;
  - frames_arith/: the same nine frames, arithmetic-coded (SOF9), 4:2:0,
    quality 90;
  - pairs/lossless_gray/, pairs/ycck/: frames 0 and 1 as lossless gray
    (SOF3, predictor 1) and as YCCK (Adobe transform 2), for the serving
    pipeline and the CLI;
  - progressive/frame_0000.jpg ... frame_0002.jpg: frames 0-2 written
    progressive by cv2 (the same coefficients, so the same planes);
  - restart/frame_0005.jpg: frame 5 with a restart interval of 4 MCUs;
  - variants/*.jpg: small files, one a feature the decoder must read
    (sampling factors, progressive, restart markers, EXIF orientation 6,
    gray, saturated colour blocks, Adobe RGB, a 7x9 frame, Motion-JPEG
    frames without DHT, colour and gray; arithmetic coding, sequential and
    progressive, with restarts and DAC conditioning; lossless gray and RGB
    at several predictors, point transforms and precisions; CMYK and YCCK)
    or must refuse as cv2 fails on it (two components);
  - manifest.json: per file the shape and SHA-256 of cv2.imread's gray
    (IMREAD_GRAYSCALE) and colour (IMREAD_COLOR) planes, laid out as the
    port's decoder lays them out ((C, H, W) uint8, C-contiguous), or null
    for a read that cv2 fails on (the gray read of a lossless RGB file, the
    colour read of a lossless gray one), with the cv2 and libjpeg-turbo
    versions that made them, the writer's libjpeg-turbo and the frames'
    motion; and, under "damaged", chip_smoke.py part 7g's frame sets, each
    frame a committed file and the byte edits (`damage.py`) that damage
    it: "damaged" the nine frames, frame 1 with 3 bytes before its EOI,
    frame 2 without its EOI, frame 3 cut inside its last MCU row, frame
    4 with a byte flipped in mid-scan, frame 5 (the restart file) with a
    restart marker one ahead of the one due; "progressive" and
    "progressive_cut" the three progressive frames, whole and cut before
    their last scan; per damaged frame cv2.imread's planes as above and
    the share of pixels where they differ from the whole file's.
tests/test_torch_jpeg.py holds the manifest to live cv2 and to the port's
decoder; chip_smoke.py holds the card machine's build of the decoder to
it, where there is no cv2.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import re
import struct
import subprocess
import sys
import tempfile

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, ROOT)

from of_dis_tpu_torch.tools import bench_pipeline  # noqa: E402

sys.path.insert(0, HERE)
from damage import damage  # noqa: E402

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


def pillow_libjpeg() -> str:
    """The libjpeg-turbo 3 shared library that Pillow bundles."""
    import PIL
    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "libjpeg-*.so*"))
    if not libs:
        raise RuntimeError("Pillow bundles no libjpeg-turbo here")
    return libs[0]


def writer_version() -> str:
    from PIL import features
    return f"libjpeg-turbo {features.version('libjpeg_turbo')}"


def build_writer(out_dir: str) -> str:
    """Compile jpeg_writer.c into `out_dir`; the executable's path."""
    lib = pillow_libjpeg()
    exe = os.path.join(out_dir, "jpeg_writer")
    subprocess.run(["gcc", "-O1", "-o", exe,
                    os.path.join(HERE, "jpeg_writer.c"), lib,
                    "-Wl,-rpath," + os.path.dirname(lib)], check=True)
    return exe


def write(exe: str, img: np.ndarray, **params) -> bytes:
    """`img` (H, W) or (H, W, C) samples (uint8, or uint16 above 8 bits of
    precision; C 3 is RGB, 4 CMYK) as jpeg_writer writes it with `params`
    (its key=value settings)."""
    h, w = img.shape[:2]
    comps = 1 if img.ndim == 2 else img.shape[2]
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.raw"), os.path.join(tmp, "out.jpg")
        np.ascontiguousarray(img).astype(
            "<u2" if img.dtype == np.uint16 else np.uint8).tofile(src)
        subprocess.run([exe, src, dst, f"w={w}", f"h={h}", f"comps={comps}"]
                       + [f"{k}={v}" for k, v in params.items()],
                       check=True)
        with open(dst, "rb") as f:
            return f.read()


def pil_cmyk(img: np.ndarray) -> bytes:
    """PIL's CMYK JPEG of (H, W, 4) uint8 ink values: Adobe APP14
    transform 0, the samples stored inverted as Photoshop stores them."""
    import io
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(img, "CMYK").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def cmyk_of(bgr: np.ndarray, k: np.ndarray) -> np.ndarray:
    """(H, W, 4) stored CMYK samples that cv::imread shows as about `bgr`:
    the colour planes as R, G, B under the black plane `k` (OpenCV reads
    the samples as Adobe's inverted ones: 255 is no ink)."""
    return np.dstack([bgr[..., 2], bgr[..., 1], bgr[..., 0], k])


# arithmetic, lossless and 4-component variants: name -> (content, writer
# settings); content "rgb" the blurred base, "gray" its gray, "cmyk" its
# CMYK, "tiny" a 7x9 saturated frame
NEW_VARIANTS = {
    **{f"arith_s{s}.jpg": ("rgb", {"arith": 1, "samp": f})
       for s, f in (("444", "1,1;1,1;1,1"), ("422", "2,1;1,1;1,1"),
                    ("420", "2,2;1,1;1,1"), ("411", "4,1;1,1;1,1"))},
    "arith_progressive.jpg": ("rgb", {"arith": 1, "prog": 1}),
    "arith_restart7.jpg": ("rgb", {"arith": 1, "rst": 7}),
    "arith_dac.jpg": ("rgb", {"arith": 1, "dac": "2,4,1", "rst": 5}),
    "arith_gray.jpg": ("gray", {"arith": 1}),
    "arith_prog_gray.jpg": ("gray", {"arith": 1, "prog": 1}),
    "arith_tiny_7x9.jpg": ("tiny", {"arith": 1, "q": 50}),
    "lossless_gray.jpg": ("gray", {"lossless": "1,0"}),
    "lossless_gray_p7_pt2.jpg": ("gray", {"lossless": "7,2"}),
    "lossless_gray_prec6.jpg": ("gray6", {"lossless": "4,1", "prec": 6}),
    "lossless_gray_rst.jpg": ("gray", {"lossless": "5,0", "rstrows": 2}),
    "lossless_rgb.jpg": ("rgb", {"lossless": "6,0"}),
    "cmyk_adobe.jpg": ("cmyk", {"space": "cmyk"}),
    "cmyk_no_adobe.jpg": ("cmyk", {"space": "cmyk", "adobe": 0}),
    "ycck.jpg": ("cmyk", {"space": "ycck"}),
    "ycck_arith_420.jpg": ("cmyk", {"space": "ycck", "arith": 1,
                                    "samp": "2,2;1,1;1,1;2,2"}),
    # no colour space of libjpeg's: both of cv2's reads fail
    "two_components.jpg": ("two", {}),
}


def new_variants(exe: str) -> dict:
    h, w = SMALL
    base = blurred(h, w, 1)
    gray = cv2.cvtColor(base, cv2.COLOR_BGR2GRAY)
    k = 255 - blurred(h, w, 4)[..., 0] // 4
    content = {"rgb": base[..., ::-1], "gray": gray, "gray6": gray >> 2,
               "cmyk": cmyk_of(base, k),
               "tiny": saturated(7, 9, 3)[..., ::-1], "two": base[..., :2]}
    out = {name: write(exe, content[kind], **params)
           for name, (kind, params) in NEW_VARIANTS.items()}
    out["cmyk_pil.jpg"] = pil_cmyk(255 - content["cmyk"])
    ycck = out["ycck.jpg"]             # SOI, then libjpeg's Adobe APP14
    out["ycck_orient6.jpg"] = ycck[:2] + exif_orientation(6) + ycck[2:]
    return out


def arith_frames(exe: str, imgs: np.ndarray) -> list:
    """The frames arithmetic-coded (SOF9), 4:2:0, quality 90."""
    return [write(exe, img[..., ::-1], arith=1, samp="2,2;1,1;1,1")
            for img in imgs]


def pairs(exe: str, imgs: np.ndarray) -> dict:
    """Frames 0 and 1 as lossless gray and as YCCK, a directory each."""
    out = {}
    ks = bench_pipeline.frame_stack(2, MOTION, seed=3, device="cpu",
                                    h=FRAME_H, w=FRAME_W).numpy()
    for t in range(2):
        gray = cv2.cvtColor(imgs[t], cv2.COLOR_BGR2GRAY)
        out[f"lossless_gray/frame_{t:04d}.jpg"] = write(exe, gray,
                                                       lossless="1,0")
        k = 255 - np.clip(ks[t], 0, 255).astype(np.uint8) // 8
        out[f"ycck/frame_{t:04d}.jpg"] = write(exe, cmyk_of(imgs[t], k),
                                               space="ycck")
    return out


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
    shape and SHA-256, or None where cv2 fails on the read."""
    rec = {}
    for key, flag in (("gray", cv2.IMREAD_GRAYSCALE),
                      ("color", cv2.IMREAD_COLOR)):
        img = cv2.imread(path, flag)
        if img is None:
            rec[key] = None
            continue
        chw = img[None] if img.ndim == 2 else img.transpose(2, 0, 1)
        chw = np.ascontiguousarray(chw)
        rec[key] = {"shape": list(chw.shape),
                    "sha256": hashlib.sha256(chw.tobytes()).hexdigest()}
    return rec


def _markers(raw: bytes, codes) -> list:
    """Offsets of the FF of every marker with a code in `codes` after the
    first SOS."""
    at = raw.index(b"\xff\xda")
    return [i for i in range(at, len(raw) - 1)
            if raw[i] == 0xFF and raw[i + 1] in codes]


def _gray(raw: bytes):
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.jpg")
        with open(path, "wb") as f:
            f.write(raw)
        return cv2.imread(path, cv2.IMREAD_GRAYSCALE)


def last_row_cut(raw: bytes) -> int:
    """A length that cuts `raw` inside its last MCU row: halfway between
    the shortest cut whose gray read differs from the whole file's only in
    that row's lines (16 at 4:2:0) and the file's end (cv2.imread reads
    past the cut as libjpeg does)."""
    whole = _gray(raw)
    first_row = (whole.shape[0] - 1) // 16 * 16
    lo, hi = raw.index(b"\xff\xda"), len(raw) - 2
    while hi - lo > 1:                # the first differing line >= first_row
        mid = (lo + hi) // 2
        rows = np.nonzero((_gray(raw[:mid]) != whole).any(axis=1))[0]
        if rows.size and rows[0] < first_row:
            lo = mid
        else:
            hi = mid
    return (hi + len(raw) - 2) // 2


def damaged_sets(files: dict) -> dict:
    """Part 7g's frame sets (see the module's docstring): name -> frames,
    each {"name", "source", "edits"}."""
    frames = []
    for t in range(N_FRAMES):
        source = f"frames/frame_{t:04d}.jpg" if t != 5 else \
            "restart/frame_0005.jpg"
        raw, edits = files[source], []
        if t == 1:                    # extraneous bytes before EOI
            edits = [["insert", len(raw) - 2, "5aa53c"]]
        elif t == 2:                  # no EOI
            edits = [["cut", len(raw) - 2]]
        elif t == 3:                  # cut inside the last MCU row
            edits = [["cut", last_row_cut(raw)]]
        elif t == 4:                  # a byte flipped in mid-scan
            at = raw.index(b"\xff\xda")
            edits = [["xor", (at + len(raw)) // 2, 0x10]]
        elif t == 5:                  # RSTn one ahead of the one due
            rst = _markers(raw, range(0xD0, 0xD8))
            k = len(rst) // 2
            edits = [["xor", rst[k] + 1, (raw[rst[k] + 1] - 0xD0) ^
                      ((raw[rst[k] + 1] - 0xD0 + 1) & 7)]]
        frames.append({"name": f"frame_{t:04d}.jpg", "source": source,
                       "edits": edits})
    prog = [f"progressive/frame_{t:04d}.jpg" for t in range(3)]
    return {
        "damaged": frames,
        "progressive": [{"name": os.path.basename(p), "source": p,
                         "edits": []} for p in prog],
        "progressive_cut": [{"name": os.path.basename(p), "source": p,
                             "edits": [["cut", files[p].rindex(
                                 b"\xff\xda")]]} for p in prog]}


def damaged_planes(files: dict, sets: dict) -> dict:
    """"set/frame" -> cv2.imread's planes of the damaged frame, and the
    share of pixels where they differ from the whole source file's."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, frs in sets.items():
            for fr in frs:
                raw = files[fr["source"]]
                path = os.path.join(tmp, "damaged.jpg")
                with open(path, "wb") as f:
                    f.write(damage(raw, fr["edits"]))
                rec = planes(path)
                whole = os.path.join(tmp, "whole.jpg")
                with open(whole, "wb") as f:
                    f.write(raw)
                a = cv2.imread(path, cv2.IMREAD_COLOR)
                b = cv2.imread(whole, cv2.IMREAD_COLOR)
                rec["changed"] = float((a != b).any(axis=2).mean())
                out[f"{name}/{fr['name']}"] = rec
    return out


def libjpeg_version() -> str:
    m = re.search(r"JPEG:\s+(.*)", cv2.getBuildInformation())
    return m.group(1).strip() if m else "unknown"


def main() -> dict:
    files = {}
    for d in ("frames", "frames_arith", "pairs/lossless_gray", "pairs/ycck",
              "progressive", "restart", "variants"):
        os.makedirs(os.path.join(HERE, d), exist_ok=True)
    imgs = frames()
    for t, img in enumerate(imgs):
        files[f"frames/frame_{t:04d}.jpg"] = encode(img)
    for t in range(3):
        files[f"progressive/frame_{t:04d}.jpg"] = encode(imgs[t],
                                                         progressive=True)
    files["restart/frame_0005.jpg"] = encode(imgs[5], restart=4)
    for name, raw in variants().items():
        files[f"variants/{name}"] = raw
    with tempfile.TemporaryDirectory() as tmp:
        exe = build_writer(tmp)
        for name, raw in new_variants(exe).items():
            files[f"variants/{name}"] = raw
        for t, raw in enumerate(arith_frames(exe, imgs)):
            files[f"frames_arith/frame_{t:04d}.jpg"] = raw
        for name, raw in pairs(exe, imgs).items():
            files[f"pairs/{name}"] = raw
    manifest = {"cv2": cv2.__version__, "libjpeg": libjpeg_version(),
                "writer_libjpeg": writer_version(),
                "motion_px": list(MOTION),
                "frame_size": [FRAME_W, FRAME_H], "files": {}}
    for rel, raw in sorted(files.items()):
        path = os.path.join(HERE, rel)
        with open(path, "wb") as f:
            f.write(raw)
        manifest["files"][rel] = {"bytes": len(raw), **planes(path)}
    sets = damaged_sets(files)
    manifest["damaged"] = {"sets": sets,
                           "planes": damaged_planes(files, sets)}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return manifest


if __name__ == "__main__":
    m = main()
    print(f"{len(m['files'])} files, "
          f"{sum(r['bytes'] for r in m['files'].values())} bytes")
