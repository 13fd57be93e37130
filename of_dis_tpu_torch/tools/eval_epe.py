"""End-point-error evaluation of flow/depth outputs: the counterpart of the
JAX package's `tools/eval_epe.py`, with the same output text.

The reference validated itself against the Sintel/Middlebury benchmark
servers. This is the local equivalent: compare computed .flo/.pfm files
against ground truth.

Usage:
  python -m of_dis_tpu_torch.tools.eval_epe out.flo gt.flo   # one pair
  python -m of_dis_tpu_torch.tools.eval_epe OUT_DIR GT_DIR   # a directory
Prints mean EPE, and for directories the per-file breakdown plus the
standard Sintel accuracy buckets (% of pixels with EPE > 1/3/5 px).

Kept as the JAX tool has them: the directory mean weights each file's
mean over its valid pixels by all of its pixels, and a file without a
valid pixel makes that mean NaN.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from of_dis_tpu_torch.utils import io


def _load(path):
    """(H, W, C) float32: a .flo's channels, or a .pfm's one channel as
    stored (the negated disparity: EPE is the same either way)."""
    if path.endswith(".pfm"):
        return -io.read_pfm(path)[:, :, None]
    return io.read_flo(path)


def epe_stats(flow, gt):
    """(mean EPE, %>1px, %>3px, %>5px) over pixels with finite gt.

    Sintel convention: gt values > 1e9 (or non-finite) mark invalid/
    unknown pixels and are excluded.
    """
    nc = min(flow.shape[2], gt.shape[2], 2)
    d = flow[:, :, :nc].astype(np.float64) - gt[:, :, :nc].astype(np.float64)
    err = np.sqrt(np.sum(d * d, axis=2))
    valid = np.all(np.isfinite(gt[:, :, :nc])
                   & (np.abs(gt[:, :, :nc]) < 1e9), axis=2)
    err = err[valid]
    if err.size == 0:
        return float("nan"), 0.0, 0.0, 0.0
    return (float(err.mean()),
            float((err > 1).mean() * 100),
            float((err > 3).mean() * 100),
            float((err > 5).mean() * 100))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 2
    a, b = argv
    if os.path.isdir(a):
        names = sorted(set(os.listdir(a)) & set(os.listdir(b)))
        names = [n for n in names if n.endswith((".flo", ".pfm"))]
        if not names:
            print(f"no common .flo/.pfm files under {a} and {b}")
            return 1
        tot, n_px = 0.0, 0
        for name in names:
            fl, gt = _load(os.path.join(a, name)), _load(os.path.join(b, name))
            epe, p1, p3, p5 = epe_stats(fl, gt)
            k = fl.shape[0] * fl.shape[1]
            tot += epe * k
            n_px += k
            print(f"{name}: EPE {epe:.4f}  >1px {p1:.2f}%  >3px {p3:.2f}%"
                  f"  >5px {p5:.2f}%")
        print(f"mean over {len(names)} files: EPE {tot / n_px:.4f}")
    else:
        epe, p1, p3, p5 = epe_stats(_load(a), _load(b))
        print(f"EPE {epe:.4f}  >1px {p1:.2f}%  >3px {p3:.2f}%  >5px {p5:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
