"""The benchmark's configuration and plain reference of op-4 with the
forward-backward merge (`dis_bench/configs/dis_op4_fb_gray.json`,
`dis_bench/reference/dis_flow_fb.py`) against the port, on the CPU.

The reference writes the merge on its own, as a direct float64 scatter of
every footprint pixel's four taps; the port's CPU twin contracts soft
one-hot matrices. Both sum each pixel's terms in float64, in other orders
and groupings, so their float32 roundings part by one float32 step at a
few pixels, and 8 Gauss-Newton trips a level and the variational
refinement carry that forward: 2.4e-7 px at most and 3.7e-10 px mean
EPE at this size (3.3e-6 and 8.8e-9 with other sum orders). The
tolerance, 1e-4 px at most and 1e-6 px mean EPE, holds that with room
and is a thousandth of what leaving the merge out or not negating the
backward flow gives (0.27 px and 4.2 px)."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dis_bench import geometry
from dis_bench.reference import dis_flow_fb as ref
from dis_bench.traffic import synth
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import densify, patch_solver
from of_dis_tpu_torch.params import make_level_spec, op_point_params

CONFIG = Path(__file__).resolve().parents[1] / "dis_bench" / "configs" / \
    "dis_op4_fb_gray.json"
MAX_PX, EPE_PX = 1e-4, 1e-6
# op-4 at 96 wide runs levels 1..0, level 0 with 640 patches on the
# large-level route, level 1 with 160 on the small-level one; 8 trips a
# level in place of 128, for the CPU's time
H, W, TRIPS = 60, 96, 8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config():
    return json.loads(CONFIG.read_text())


@pytest.mark.parametrize("width", [1024, 1920, W])
def test_config_is_the_ports_op_point_with_the_merge(width):
    ours = geometry.params_for(config(), width)
    port = dataclasses.replace(op_point_params(width, 4), usefbcon=True)
    for f in ("sc_f", "sc_l") + geometry.PARAM_KEYS:
        assert getattr(ours, f) == getattr(port, f), f
    assert config()["reference"] == "dis_flow_fb"


@pytest.fixture(scope="module")
def case():
    cfg = dict(config(), max_iter=TRIPS, min_iter=TRIPS)
    params = geometry.params_for(cfg, W)
    fh, fw = geometry.padded_size(H, W, params.sc_f + 1)
    a, b = synth.make_pairs(2, H, W, synth.generator(2 ** 33 + 5, "cpu"),
                            "cpu", fh, fw)
    port = dataclasses.replace(op_point_params(W, 4), usefbcon=True,
                               max_iter=TRIPS, min_iter=TRIPS)
    with torch.no_grad():
        flow = ref.flow(a, b, params)
    return port, a, b, fh, fw, flow


def _gap(case):
    port, a, b, fh, fw, want = case
    got = dis.dis_flow_batched(a, b, port, fw, fh, device="cpu")
    assert got.shape == want.shape == (2, fh, fw, 2)
    d = got - want
    return float(d.abs().max()), float(torch.sqrt((d * d).sum(-1)).mean())


def test_the_port_follows_the_reference(case):
    mx, epe = _gap(case)
    assert mx <= MAX_PX and epe <= EPE_PX


@pytest.mark.parametrize("fault", ["merge left out", "backward flow kept"])
def test_a_broken_merge_is_far_outside_the_tolerance(case, monkeypatch,
                                                     fault):
    twin = densify._backward_splat
    if fault == "merge left out":
        def broken(spec, params, compl):
            return torch.zeros_like(twin(spec, params, compl))
    else:
        def broken(spec, params, compl):
            return twin(spec, params, compl._replace(p=-compl.p))
    monkeypatch.setattr(densify, "_backward_splat", broken)
    mx, _ = _gap(case)
    assert mx > 1000 * MAX_PX


def test_the_reference_splat_agrees_with_the_ports_twin():
    """The reference's scatter against the port's soft one-hot twin on
    seeded converged positions around op-4's level-2 grid at 1024x448,
    some at and beyond the borders: both sum float64 terms in other
    orders, so their float32 results part by one float32 step at most."""
    params = op_point_params(1024, 4)
    spec = make_level_spec(2, 1024, 448, params)
    rng = np.random.default_rng(4)
    n, psz = spec.nopatches, params.p_samp_s
    grid = patch_solver.grid_ref_points(spec).numpy()
    p = (rng.standard_normal((2, n, 2)) * 3).astype(np.float32)
    pt = grid[None] + p
    pt[:, ::97] = rng.uniform(-10, spec.width + 10, (2, pt[:, ::97].shape[1],
                                                     2)).astype(np.float32)
    pw = (2.0 + rng.random((2, psz, psz, n)) * 30).astype(np.float32)
    res = patch_solver.PatchResult(torch.from_numpy(p), torch.from_numpy(pt),
                                   torch.from_numpy(pw), torch.zeros(()))
    want = densify._backward_splat(spec, params, res)
    got = ref.splat(spec, params, res.p.transpose(1, 2),
                    res.pt.transpose(1, 2), res.pweight)
    for f in range(3):
        scale = float(want[:, f].abs().max())
        torch.testing.assert_close(got[:, f], want[:, f], rtol=2.0 ** -23,
                                   atol=1e-9 * scale)


def test_the_reference_refuses_what_it_does_not_compute():
    cfg = dict(config(), usefbcon=False)
    with pytest.raises(ValueError):
        ref.check_supported(geometry.params_for(cfg, W))
