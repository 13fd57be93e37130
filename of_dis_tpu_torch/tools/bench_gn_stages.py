"""Per-stage device timing of the Gauss-Newton iteration (T2).

Where do the microseconds of one GN trip go? Each stage runs `max_iter`
trips for every patch of a batch on the kernel `kernels.gn_stages`
(csrc/gn_stages.cu), on the layout of the GN kernel that runs the
geometry (K1's lanes at op2-l3, K6's window columns at op4-l0, through
their device code in csrc/gn_common.cuh), and the differences between
the cumulative stages attribute the time:

  W        the window's tap loads (the sum of every pixel's four taps)
  A3       + the bilinear interpolation (on columns with its shuffle), the
           patch sum
  A4       + patch mean, residual, sum |residual| / psz^2, two projections

plus three variants of A4 that compute its function bit for bit:

  B-smem   each warp stages its windows in shared memory
  C-u16    planes as 16-bit integers of value * 4^lv, converted after the
           load (exact for lv <= 4)
  both     B-smem and C-u16 together

Inputs follow the JAX package's tools/bench_gn_stages.py: a
numpy.random.default_rng(0) draw in its order (level planes quantised to
multiples of 4^-lv, templates, the two steepest-descent images, the
anchors), anchors that move every trip. Geometries:

  op2-l3   psz 8, the 72x144 plane, 448 patches, 12 trips, lv 3, batch
           384 (the JAX tool's: op-2's finest level); K1's lane layout
  op4-l0   psz 12, level 0 of op-4 at 1024x448 with its 12-pixel padding
           (472x1048), 51,300 patches, 128 trips, lv 0, batch 4 (where the
           large-level GN kernel spends most of op-4's time); K6's column
           layout

Prints microseconds per pair per stage, the difference from the previous
stage, and whether each variant equals A4 bit for bit (every patch's
checksum).

Usage: python -m of_dis_tpu_torch.tools.bench_gn_stages [batch] [reps]
           [--geometry op2-l3|op4-l0] [--device cuda|cpu]
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from of_dis_tpu_torch.kernels import gn_stages


@dataclasses.dataclass(frozen=True)
class Geometry:
    psz: int
    hp: int          # plane rows
    wp: int          # plane columns
    n: int           # patches a pair
    max_iter: int
    lv: int          # pyramid level: plane values are multiples of 4^-lv
    batch: int       # default batch
    sy_hi: int       # anchors' rows are drawn from [0, sy_hi)
    # the GN kernel's layout that runs this geometry (`gn_stages.LANES`,
    # K1's, or `gn_stages.COLUMNS`, K6's)
    layout: int = gn_stages.LANES

    @property
    def sx_hi(self) -> int:
        """Anchors' columns are drawn from [0, sx_hi), as the JAX tool
        draws them: trip i moves the window i columns to the right."""
        return self.wp - (self.psz + 1) - self.max_iter - 1


GEOMETRIES = {
    # the JAX tool's row bound: its 80-row banded planes less a 16-row
    # window and 3 rows a trip
    "op2-l3": Geometry(8, 72, 144, 448, 12, 3, 384, 80 - 16 - 3 * 12 - 1),
    # windows, with the 3-row jitter, inside the plane
    "op4-l0": Geometry(12, 472, 1048, 51300, 128, 0, 4, 472 - 12 - 3,
                       gn_stages.COLUMNS),
}
# (label, stage, variant) in the order they run and print
RUNS = (("W taps", "W", ""), ("A3 +bilerp", "A3", ""),
        ("A4 +loss/proj", "A4", ""), ("B-smem", "A4", "B-smem"),
        ("C-u16", "A4", "C-u16"), ("both", "A4", "both"))


def make_inputs(geom: Geometry, batch: int, device) -> dict:
    """The tool's inputs on `device`, drawn as the JAX tool draws them:
    planes, templates, x- and y-gradient images, column and row anchors."""
    b, d, n = batch, geom.psz * geom.psz, geom.n
    rng = np.random.default_rng(0)
    lv_scale = 4.0 ** geom.lv
    im = np.round(rng.random((b, 1, geom.hp, geom.wp)).astype(np.float32)
                  * 255.0 * lv_scale) / lv_scale
    tmpl, tdx, tdy = (rng.random((b, d, n)).astype(np.float32)
                      for _ in range(3))
    sx0 = rng.integers(0, geom.sx_hi, (b, 1, n))
    sy0 = rng.integers(0, geom.sy_hi, (b, 1, n))

    def dev(x, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype) \
            .to(device)

    return dict(
        planes=dev(im[:, 0]),
        planes_u16=dev(np.round(im[:, 0] * lv_scale).astype(np.uint16)),
        scale=1.0 / lv_scale,
        # (B, D, N) -> (B, N, D): a patch's pixels contiguous
        tmpl=dev(tmpl.transpose(0, 2, 1)), tdx=dev(tdx.transpose(0, 2, 1)),
        tdy=dev(tdy.transpose(0, 2, 1)),
        sx0=dev(sx0[:, 0], torch.int32), sy0=dev(sy0[:, 0], torch.int32))


def call_args(inputs: dict, geom: Geometry, stage: str, variant: str = ""
              ) -> tuple:
    """The arguments of `kernels.gn_stages.gn_stages` (and of its twin) for
    one stage or variant on the geometry's layout: the u16 variants read
    the integer planes."""
    u16 = variant in gn_stages.U16_VARIANTS
    return (inputs["planes_u16" if u16 else "planes"], inputs["tmpl"],
            inputs["tdx"], inputs["tdy"], inputs["sx0"], inputs["sy0"],
            geom.psz, geom.max_iter, stage, variant,
            inputs["scale"] if u16 else 1.0, geom.layout)


def call(inputs: dict, geom: Geometry, stage: str, variant: str = ""):
    """One launch of the kernel (the twin on the CPU) for one stage or
    variant. Returns the (B, N) checksums."""
    return gn_stages.gn_stages(*call_args(inputs, geom, stage, variant))


def time_ms(fn, reps: int, device) -> float:
    """ms per call of `reps` back-to-back calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(geom: Geometry, batch: int, reps: int, device) -> list:
    """Every stage and variant once for its checksums, then timed. Prints
    the table; returns one dict a row."""
    inputs = make_inputs(geom, batch, device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu (the plain twin; no device time)")
    layout = "lanes" if geom.layout == gn_stages.LANES else "columns"
    print(f"gn_stages: psz {geom.psz}, plane {geom.hp}x{geom.wp}, "
          f"{geom.n} patches, {geom.max_iter} trips, lv {geom.lv}, batch "
          f"{batch}, {layout} layout, {reps} reps on {where}", flush=True)
    rows, a4 = [], None
    for label, stage, variant in RUNS:
        out = call(inputs, geom, stage, variant)
        ms = time_ms(lambda: call(inputs, geom, stage, variant), reps,
                     device)
        us_pair = ms * 1e3 / batch
        row = dict(label=label, stage=stage, variant=variant, ms=ms,
                   us_per_pair=us_pair, checksum=float(out.double().sum()),
                   equal_a4=None)
        delta = ""
        if stage == "A4" and not variant:
            a4 = out
        if variant:
            row["equal_a4"] = bool(torch.equal(out, a4))
            eq = ("  == A4 (bit)" if row["equal_a4"] else
                  f"  != A4 (max diff {float((out - a4).abs().max()):.3e})")
        else:
            eq = ""
            if rows:
                delta = f"({us_pair - rows[-1]['us_per_pair']:+9.3f})"
        rows.append(row)
        print(f"{label:16s} {us_pair:9.3f} us/pair   {delta}{eq}", flush=True)
    print("(the variants compute A4's function; compare them with the A4 "
          "row)", flush=True)
    return rows


def main(argv=None) -> list:
    argv = list(sys.argv[1:] if argv is None else argv)
    geometry, device = "op2-l3", "cuda"
    for flag in ("--geometry", "--device"):
        if flag in argv:
            k = argv.index(flag)
            if flag == "--geometry":
                geometry = argv[k + 1]
            else:
                device = argv[k + 1]
            del argv[k:k + 2]
    geom = GEOMETRIES[geometry]
    batch = int(argv[0]) if argv else geom.batch
    reps = int(argv[1]) if len(argv) > 1 else 20
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "the plain twin")
    return run(geom, batch, reps, dev)


if __name__ == "__main__":
    main()
