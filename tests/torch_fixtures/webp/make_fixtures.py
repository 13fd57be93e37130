"""Write the WebP fixtures of the port's tests and of chip_smoke.py part
7d, and their manifest.

    python tests/torch_fixtures/webp/make_fixtures.py

Needs cv2 and PIL (the encoders, and cv2 the decoder whose output the
manifest records). The card's machine has no WebP encoder, so the files
are committed:
  - frames/frame_0000.webp ... frame_0008.webp: the nine 1024x436 JPEG
    frames of ../jpeg (moving 1.3, 0.4 px a frame), as cv2.imread reads
    them, re-encoded lossy by cv2 at quality 90;
  - lossless/gray_0000.webp ... gray_0002.webp: the first three frames'
    gray planes, lossless (colour indexing of 256 grays); and
    lossless/color_0000.webp, frame 0 in colour, lossless;
  - variants/*.webp: small files, one a feature the decoder must read:
    odd sizes, qualities 0 to 100, alpha (lossy ALPH and lossless), EXIF
    orientations 3, 6 and 8, an animation whose frame 0 lies off the
    canvas's corner, palettes of 4 and 256 grays, both encoders' methods
    0 and 6, and three bitstreams no encoder here writes, made by
    rewriting a cv2 file's boolean-coded streams (`Vp8Stream`): the simple
    loop filter, the normal filter with sharpness and mode / reference
    deltas, and 2, 4 and 8 token partitions;
  - manifest.json: per file the shape and SHA-256 of cv2.imread's gray
    (IMREAD_GRAYSCALE) and colour (IMREAD_COLOR) planes, laid out as the
    port lays them out ((C, H, W) uint8, C-contiguous).
tests/test_torch_webp.py holds the manifest to live cv2 and to the port's
decoder; chip_smoke.py holds the card machine's build to it. Deterministic:
a rerun writes the same bytes.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import re
import struct
import sys

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
JPEG_DIR = os.path.join(os.path.dirname(HERE), "jpeg")
WEBP_CPP = os.path.join(ROOT, "of_dis_tpu_torch", "csrc", "webp.cpp")
SMALL = (61, 83)

# ------------------------------------------------------------ container


def chunk(tag: bytes, payload: bytes) -> bytes:
    pad = b"\0" if len(payload) & 1 else b""
    return tag + struct.pack("<I", len(payload)) + payload + pad


def riff(chunks) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(flags: int, w: int, h: int) -> bytes:
    return chunk(b"VP8X", struct.pack("<I", flags)
                 + (w - 1).to_bytes(3, "little")
                 + (h - 1).to_bytes(3, "little"))


def anmf(x: int, y: int, w: int, h: int, sub: bytes, duration=100,
         flags=0) -> bytes:
    fields = [x // 2, y // 2, w - 1, h - 1, duration]
    return chunk(b"ANMF", b"".join(v.to_bytes(3, "little") for v in fields)
                 + bytes([flags]) + sub)


def image_chunks(raw: bytes) -> bytes:
    """The ALPH, VP8 and VP8L chunks of a WebP file, as they stand."""
    out, pos = b"", 12
    while pos + 8 <= len(raw):
        size = struct.unpack("<I", raw[pos + 4:pos + 8])[0]
        end = pos + 8 + size + (size & 1)
        if raw[pos:pos + 4] in (b"ALPH", b"VP8 ", b"VP8L"):
            out += raw[pos:end]
        pos = end
    return out


def exif(orientation: int) -> bytes:
    """A TIFF-structured EXIF block whose IFD0 holds one tag, 0x0112."""
    return (b"II*\0" + struct.pack("<I", 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0)
            + b"\0\0\0\0")


# ------------------------------------------------- VP8 boolean streams

def _table(name: str) -> list:
    """A table of csrc/webp.cpp (the decoder's copy of RFC 6386's)."""
    with open(WEBP_CPP) as f:
        src = f.read()
    body = re.search(name + r"\[[^\]]*\] = \{(.*?)\};", src, re.S).group(1)
    return [int(v) for v in re.findall(r"\d+", body)]


class BoolDecoder:
    """RFC 6386 section 7.3's boolean decoder, logging each (bit, prob)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 2
        self.value = (data[0] << 8 | data[1]) if len(data) >= 2 else 0
        self.range, self.count, self.log = 255, 0, []

    def bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            b, self.range, self.value = 1, self.range - split, \
                self.value - (split << 8)
        else:
            b, self.range = 0, split
        while self.range < 128:
            self.value, self.range = self.value << 1, self.range << 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                if self.pos < len(self.data):
                    self.value |= self.data[self.pos]
                self.pos += 1
        self.log.append((b, prob))
        return b

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(128) else v


class BoolEncoder:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def bit(self, b: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if b:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if self.count == 0:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def value_bits(self, v: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.bit(v >> k & 1, 128)

    def signed(self, v: int, n: int) -> None:
        self.value_bits(abs(v), n)
        self.bit(int(v < 0), 128)

    def flush(self) -> bytes:
        c, v = self.count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


ZIGZAG_BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135),
             (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
YMODE_TREE = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)


class Vp8Stream:
    """A key frame's boolean-coded decisions, parsed (RFC 6386 sections
    9, 11, 13) so that it can be written again with another loop filter
    header or token partition count: the macroblock modes and every
    token are replayed as (bit, probability) pairs."""

    def __init__(self, payload: bytes):
        tag = int.from_bytes(payload[:3], "little")
        self.tag_low = tag & 0x1F         # key frame, profile, shown
        self.frame_header = payload[3:10]
        size = tag >> 5
        w = int.from_bytes(payload[6:8], "little") & 0x3FFF
        h = int.from_bytes(payload[8:10], "little") & 0x3FFF
        self.mb_w, self.mb_h = (w + 15) >> 4, (h + 15) >> 4
        d = BoolDecoder(payload[10:10 + size])
        self.head = [d.bit(128), d.bit(128)]
        seg = self.segment = {"use": d.bit(128)}
        if seg["use"]:
            seg["update_map"] = d.bit(128)
            seg["update_data"] = d.bit(128)
            if seg["update_data"]:
                seg["abs"] = d.bit(128)
                seg["quant"] = [d.signed(7) if d.bit(128) else None
                                for _ in range(4)]
                seg["lf"] = [d.signed(6) if d.bit(128) else None
                             for _ in range(4)]
            if seg["update_map"]:
                seg["probs"] = [d.value_bits(8) if d.bit(128) else None
                                for _ in range(3)]
        self.filter = {"simple": d.bit(128), "level": d.value_bits(6),
                       "sharpness": d.value_bits(3), "deltas": None}
        if d.bit(128):
            updates = d.bit(128)
            self.filter["deltas"] = (
                [[d.signed(6) if d.bit(128) else None for _ in range(4)]
                 for _ in range(2)] if updates else [[None] * 4] * 2)
        parts = 1 << d.value_bits(2)
        mark = len(d.log)
        q = [d.value_bits(7)] + [d.signed(4) if d.bit(128) else None
                                 for _ in range(5)]
        self.quant = q
        d.bit(128)
        update, proba0 = _table("kCoeffsUpdateProba"), _table("kCoeffsProba0")
        proba = [d.value_bits(8) if d.bit(update[k]) else proba0[k]
                 for k in range(len(update))]
        skip = d.bit(128)
        skip_p = d.value_bits(8) if skip else 0
        self.rest0 = d.log[mark:]   # quant .. skip prob: replayed as is
        bmodes = _table("kBModesProba")
        probs = [255 if v is None else v
                 for v in self.segment.get("probs") or [None] * 3]
        i4, skips = [], []
        intra_t = [0] * (4 * self.mb_w)
        for _ in range(self.mb_h):
            intra_l = [0] * 4
            for x in range(self.mb_w):
                if self.segment.get("update_map"):
                    s = (d.bit(probs[2]) + 2) if d.bit(probs[0]) \
                        else d.bit(probs[1])
                else:
                    s = 0
                skips.append(d.bit(skip_p) if skip else 0)
                is4 = not d.bit(145)
                i4.append(is4)
                if not is4:
                    ym = (1 if d.bit(128) else 3) if d.bit(156) \
                        else (2 if d.bit(163) else 0)
                    intra_t[4 * x:4 * x + 4] = [ym] * 4
                    intra_l = [ym] * 4
                else:
                    for yy in range(4):
                        ym = intra_l[yy]
                        for xx in range(4):
                            p = bmodes[(intra_t[4 * x + xx] * 10 + ym) * 9:]
                            i = YMODE_TREE[d.bit(p[0])]
                            while i > 0:
                                i = YMODE_TREE[2 * i + d.bit(p[i])]
                            ym = -i
                            intra_t[4 * x + xx] = ym
                        intra_l[yy] = ym
                if d.bit(142) and d.bit(114):
                    d.bit(183)
        self.modes = d.log[mark + len(self.rest0):]
        # token partitions: each macroblock's decisions
        sizes_at = 10 + size
        bufs, at = [], sizes_at + 3 * (parts - 1)
        for p in range(parts - 1):
            n = int.from_bytes(payload[sizes_at + 3 * p:sizes_at + 3 * p + 3],
                               "little")
            bufs.append(payload[at:at + n])
            at += n
        bufs.append(payload[at:])
        decs = [BoolDecoder(b) for b in bufs]
        self.tokens = []    # per macroblock row, its decisions
        nz_t, nzdc_t = [0] * self.mb_w, [0] * self.mb_w
        proba = [proba[k:k + 11] for k in range(0, len(proba), 11)]
        for y in range(self.mb_h):
            dec = decs[y & (parts - 1)]
            start = len(dec.log)
            nz_l = nzdc_l = 0
            for x in range(self.mb_w):
                k = y * self.mb_w + x
                nz_t[x], nz_l, nzdc_t[x], nzdc_l = self._residuals(
                    dec, proba, i4[k], nz_t[x], nz_l, nzdc_t[x], nzdc_l,
                    skips[k])
            self.tokens.append(dec.log[start:])

    @staticmethod
    def _coeffs(dec, proba, t, ctx, n):
        p = proba[(t * 8 + ZIGZAG_BANDS[n]) * 3 + ctx]
        while n < 16:
            if not dec.bit(p[0]):
                return n
            while not dec.bit(p[1]):
                n += 1
                p = proba[(t * 8 + ZIGZAG_BANDS[n]) * 3]
                if n == 16:
                    return 16
            nxt = (t * 8 + ZIGZAG_BANDS[n + 1]) * 3
            if not dec.bit(p[2]):
                p = proba[nxt + 1]
            else:
                if not dec.bit(p[3]):
                    if dec.bit(p[4]):
                        dec.bit(p[5])
                elif not dec.bit(p[6]):
                    if not dec.bit(p[7]):
                        dec.bit(159)
                    else:
                        dec.bit(165)
                        dec.bit(145)
                else:
                    b1 = dec.bit(p[8])
                    b0 = dec.bit(p[9 + b1])
                    for prob in CAT_PROBS[2 * b1 + b0]:
                        dec.bit(prob)
                p = proba[nxt + 2]
            dec.bit(128)
            n += 1
        return 16

    def _residuals(self, dec, proba, is4, nz_t, nz_l, nzdc_t, nzdc_l, skip):
        if skip:
            return 0, 0, (nzdc_t if is4 else 0), (nzdc_l if is4 else 0)
        first, t = 0, 3
        if not is4:
            nz = self._coeffs(dec, proba, 1, nzdc_t + nzdc_l, 0)
            nzdc_t = nzdc_l = int(nz > 0)
            first, t = 1, 0
        tnz, lnz = nz_t & 0x0F, nz_l & 0x0F
        for _ in range(4):
            lb = lnz & 1
            for _ in range(4):
                nz = self._coeffs(dec, proba, t, lb + (tnz & 1), first)
                lb = int(nz > first)
                tnz = (tnz >> 1) | (lb << 7)
            tnz >>= 4
            lnz = (lnz >> 1) | (lb << 7)
        out_t, out_l = tnz, lnz >> 4
        for ch in (0, 2):
            tnz, lnz = nz_t >> (4 + ch), nz_l >> (4 + ch)
            for _ in range(2):
                lb = lnz & 1
                for _ in range(2):
                    nz = self._coeffs(dec, proba, 2, lb + (tnz & 1), 0)
                    lb = int(nz > 0)
                    tnz = (tnz >> 1) | (lb << 3)
                tnz >>= 2
                lnz = (lnz >> 1) | (lb << 5)
            out_t |= (tnz << 4) << ch
            out_l |= (lnz & 0xF0) << ch
        return out_t & 0xFF, out_l & 0xFF, nzdc_t, nzdc_l

    def write(self, simple=None, sharpness=None, deltas=None,
              partitions=None) -> bytes:
        """The frame again, with the loop filter's type (`simple`), its
        sharpness, its reference / mode deltas (two lists of four, None
        for no update) and the token partition count changed where
        given."""
        e = BoolEncoder()
        for b in self.head:
            e.bit(b, 128)
        seg = self.segment
        e.bit(seg["use"], 128)
        if seg["use"]:
            e.bit(seg["update_map"], 128)
            e.bit(seg["update_data"], 128)
            if seg["update_data"]:
                e.bit(seg["abs"], 128)
                for v, n in [(v, 7) for v in seg["quant"]] + \
                        [(v, 6) for v in seg["lf"]]:
                    e.bit(v is not None, 128)
                    if v is not None:
                        e.signed(v, n)
            if seg["update_map"]:
                for v in seg["probs"]:
                    e.bit(v is not None, 128)
                    if v is not None:
                        e.value_bits(v, 8)
        f = dict(self.filter)
        if simple is not None:
            f["simple"] = int(simple)
        if sharpness is not None:
            f["sharpness"] = sharpness
        if deltas is not None:
            f["deltas"] = deltas
        e.bit(f["simple"], 128)
        e.value_bits(f["level"], 6)
        e.value_bits(f["sharpness"], 3)
        e.bit(f["deltas"] is not None, 128)
        if f["deltas"] is not None:
            e.bit(1, 128)
            for v in f["deltas"][0] + f["deltas"][1]:
                e.bit(v is not None, 128)
                if v is not None:
                    e.signed(v, 6)
        parts = partitions or 1
        e.value_bits(parts.bit_length() - 1, 2)
        for b, p in self.rest0 + self.modes:
            e.bit(b, p)
        first = e.flush()
        encs = [BoolEncoder() for _ in range(parts)]
        for y, row in enumerate(self.tokens):
            for b, p in row:
                encs[y & (parts - 1)].bit(b, p)
        streams = [enc.flush() for enc in encs]
        sizes = b"".join(len(s).to_bytes(3, "little") for s in streams[:-1])
        tag = (len(first) << 5) | self.tag_low
        return (tag.to_bytes(3, "little") + self.frame_header + first
                + sizes + b"".join(streams))


# ---------------------------------------------------------------- files

def blurred(h, w, c, seed) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = cv2.GaussianBlur((rng.random((h, w, c)) * 255).astype(np.float32),
                           (0, 0), 2.0).reshape(h, w, c)
    lo, hi = img.min(), img.max()
    return ((img - lo) / max(hi - lo, 1e-6) * 255).round().astype(np.uint8)


def cv2_webp(img: np.ndarray, quality: int) -> bytes:
    """cv2's WebP of a BGR or gray image: quality 1-100 lossy, 101
    lossless."""
    ok, buf = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return buf.tobytes()


def pil_webp(arr: np.ndarray, **kw) -> bytes:
    """PIL's WebP of an RGB, RGBA or gray array."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, "WEBP", **kw)
    return buf.getvalue()


def vp8_payload(raw: bytes) -> bytes:
    at = raw.index(b"VP8 ") + 8
    return raw[at:at + struct.unpack("<I", raw[at - 4:at])[0]]


def jpeg_frames() -> list:
    """cv2.imread's BGR images of the nine JPEG frames."""
    names = sorted(os.listdir(os.path.join(JPEG_DIR, "frames")))
    return [cv2.imread(os.path.join(JPEG_DIR, "frames", n)) for n in names]


def variants() -> dict:
    h, w = SMALL
    base = blurred(h, w, 3, 1)
    rgb = np.ascontiguousarray(base[..., ::-1])
    out = {}
    for hh, ww in ((1, 1), (9, 13), (33, 17)):
        out[f"size_{ww}x{hh}.webp"] = cv2_webp(base[:hh, :ww], 90)
        out[f"size_{ww}x{hh}_lossless.webp"] = cv2_webp(base[:hh, :ww], 101)
    for q in (0, 50, 100):
        out[f"q{q}.webp"] = pil_webp(rgb, quality=q)
    out["method0.webp"] = pil_webp(rgb, quality=75, method=0)
    out["method6.webp"] = pil_webp(rgb, quality=75, method=6)
    out["lossless_method0.webp"] = pil_webp(rgb, lossless=True, method=0,
                                            quality=0)
    out["lossless_method6.webp"] = pil_webp(rgb, lossless=True, method=6,
                                            quality=100)
    alpha = blurred(h, w, 1, 2)
    alpha[:8, :8] = 0
    rgba = np.concatenate([rgb, alpha], 2)
    out["alpha_lossy.webp"] = pil_webp(rgba, quality=80)
    out["alpha_lossless.webp"] = pil_webp(rgba, lossless=True, exact=True)
    for o in (3, 6, 8):
        out[f"exif{o}.webp"] = pil_webp(rgb, quality=90, exif=exif(o))
    # frame 0 at (6, 4) of a larger canvas, lossy with alpha
    frame = image_chunks(pil_webp(rgba[:40, :50], quality=80))
    out["anim_offset.webp"] = riff([
        vp8x(0x12, 70, 52), chunk(b"ANIM", struct.pack("<IH", 0xFF336699, 0)),
        anmf(6, 4, 50, 40, frame),
        anmf(0, 0, 50, 40, image_chunks(pil_webp(rgba[:40, :50],
                                                 lossless=True)))])
    gray = cv2.cvtColor(base, cv2.COLOR_BGR2GRAY)
    out["gray4_lossless.webp"] = pil_webp(gray // 64 * 85, lossless=True)
    out["gray_lossless.webp"] = pil_webp(gray, lossless=True)
    # bitstreams no encoder here writes: rewritten from a cv2 file
    src = cv2_webp(blurred(64, 96, 3, 3), 60)
    stream = Vp8Stream(vp8_payload(src))
    out["filter_simple.webp"] = riff([chunk(b"VP8 ",
                                            stream.write(simple=True))])
    out["filter_sharpness5_deltas.webp"] = riff([chunk(b"VP8 ", stream.write(
        sharpness=5, deltas=[[7, -3, 2, 0], [-9, 4, 1, -2]]))])
    for parts in (2, 4, 8):
        out[f"partitions{parts}.webp"] = riff([chunk(
            b"VP8 ", stream.write(partitions=parts))])
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


def webp_version() -> str:
    m = re.search(r"WEBP:\s+(.*)", cv2.getBuildInformation())
    return m.group(1).strip() if m else "unknown"


def main() -> dict:
    files = {}
    frames = jpeg_frames()
    for t, img in enumerate(frames):
        files[f"frames/frame_{t:04d}.webp"] = cv2_webp(img, 90)
    for t in range(3):
        files[f"lossless/gray_{t:04d}.webp"] = cv2_webp(
            cv2.cvtColor(frames[t], cv2.COLOR_BGR2GRAY), 101)
    files["lossless/color_0000.webp"] = cv2_webp(frames[0], 101)
    for name, raw in variants().items():
        files[f"variants/{name}"] = raw
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        motion = json.load(f)["motion_px"]
    manifest = {"cv2": cv2.__version__, "webp": webp_version(),
                "motion_px": motion, "frame_size": [1024, 436], "files": {}}
    for rel, raw in sorted(files.items()):
        path = os.path.join(HERE, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
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
