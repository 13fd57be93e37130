"""Port's CLI at op-3 / op-4, with the forward-backward merge and on the
20-parameter form, against the compiled-reference goldens (moved from
tests/test_torch_dis_op34.py so that test workers spread the two files).

Tolerances: the budgets of test_golden_parity.py, 1% (the red-black SOR
order), and 1e-3 for the TV-free pseudo-Huber run (sweep-order free)."""

import os

import numpy as np
import pytest

from of_dis_tpu_torch import cli
from of_dis_tpu_torch.utils import io as tio

G = os.path.join(os.path.dirname(__file__), "goldens")


def _epe_ratio(ours, ref):
    """Mean end-point error over the reference's mean magnitude, over the
    trailing parameter axis (2 flow, 1 depth)."""
    d = np.linalg.norm(ours - ref, axis=-1)
    return d.mean() / np.linalg.norm(ref, axis=-1).mean()


FB20 = "3 1 12 12 0.05 0.95 0 8 0.4 1 1 {cost} 1 10 10 5 1 3 1.6 0"


# (mode, inputs, golden, trailing arguments, budget): the goldens of
# op-3/4, the merge and the explicit 20-parameter settings, at the budgets
# of tests/test_golden_parity.py
GOLDENS_OP34_FB = [
    ("run_OF_INT", ("a.png", "b.png"), "of_int_op3.flo", ["3"], 1e-2),
    ("run_OF_INT", ("a.png", "b.png"), "of_int_op4.flo", ["4"], 1e-2),
    ("run_OF_RGB", ("ac.png", "bc.png"), "of_rgb_op3.flo", ["3"], 1e-2),
    ("run_OF_GRD", ("a.png", "b.png"), "of_grd_op3.flo", ["3"], 1e-2),
    ("run_DE_INT", ("a.png", "bs.png"), "de_int_op3.pfm", ["3"], 1e-2),
    ("run_OF_INT", ("a.png", "b.png"), "of_int_l1_fb.flo",
     FB20.format(cost=1).split(), 1e-2),
    ("run_DE_INT", ("a.png", "bs.png"), "de_int_l2_fb.pfm",
     FB20.format(cost=0).split(), 1e-2),
    ("run_OF_INT", ("a.png", "b.png"), "of_int_huber_notv.flo",
     "3 1 12 12 0.05 0.95 0 8 0.4 0 1 2 0 10 10 5 1 3 1.6 0".split(), 1e-3),
]


@pytest.mark.parametrize("mode,inputs,golden,args,budget", GOLDENS_OP34_FB,
                         ids=[g[2][:-4] for g in GOLDENS_OP34_FB])
def test_cli_goldens_op34_fbcon(tmp_path, mode, inputs, golden, args, budget):
    out = str(tmp_path / ("out" + golden[-4:]))
    cli.main([mode] + [os.path.join(G, f) for f in inputs] + [out] + args
             + ["--quiet", "--device", "cpu"])
    if golden.endswith(".flo"):
        ours, ref = tio.read_flo(out), tio.read_flo(os.path.join(G, golden))
    else:
        ours, ref = (tio.read_pfm(f)[..., None]
                     for f in (out, os.path.join(G, golden)))
        assert ours.max() <= 0.0           # left camera: disparity <= 0
    assert ours.shape == ref.shape
    ratio = _epe_ratio(ours, ref)
    assert ratio < budget, ratio
