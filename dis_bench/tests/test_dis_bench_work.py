"""`work/k1.py` and `work/k6.py` against `chip_smoke.py::check_gn`'s byte
and operation counts, on the same level shapes and trips (check_gn run on
the CPU with its kernel replaced by the plain twin and its timers by
zeros)."""

import json
from pathlib import Path

import pytest
import torch

import chip_smoke
from dis_bench import geometry
from dis_bench.work import gn, k1, k6
from of_dis_tpu_torch.ops import patch_solver
from of_dis_tpu_torch.params import make_level_spec, op_point_params

HERE = Path(__file__).resolve().parents[1]


def check_gn_counts(monkeypatch, name, spec, params, b):
    """(bytes, flops, trips) that check_gn computes for one level."""
    got = {}

    def bound(nbytes, flops, peak=chip_smoke.F32_FLOP_PER_S):
        got["bytes"], got["flops"] = nbytes, flops
        return (0.0, 0.0, 0.0)

    monkeypatch.setattr(chip_smoke, "bound", bound)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda *a, **k: 0.0)
    monkeypatch.setattr(chip_smoke, "device_ms", lambda *a, **k: 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    g = torch.Generator().manual_seed(3)
    hp, wp = spec.padded_height, spec.padded_width
    planes = [torch.rand((b, 1, hp, wp), generator=g) * 255
              for _ in range(4)]
    p_init = torch.zeros((b, 2, spec.nopatches))
    ref = patch_solver.grid_ref_points(spec).T[None].contiguous()
    if name == "gn_fused":
        tpl = patch_solver.extract_templates(spec, params, *planes[1:])
        fn = patch_solver._gn_plain
    else:
        tpl = tuple(planes[1:])
        fn = patch_solver._gn_tiled_plain
    row = chip_smoke.check_gn(name, (spec, params, planes[0], tpl, p_init,
                                     ref), lambda *a: fn(*a)[:3])
    return got["bytes"], got["flops"], row["trips"]


@pytest.mark.parametrize("op,level,w,name", [
    (2, 1, 160, "gn_fused"), (2, 2, 160, "gn_fused"),
    (4, 0, 96, "gn_tiled")])
def test_counts_match_check_gn(monkeypatch, op, level, w, name):
    torch.set_num_threads(1)
    h = 64
    pp = op_point_params(w, op)
    cfg = json.loads((HERE / "configs" / f"dis_op{op}_gray.json")
                     .read_text())
    params = geometry.params_for(cfg, w)
    spec = make_level_spec(level, w, h, pp)
    ours = geometry.make_level_spec(level, w, h, params)
    assert geometry.uses_tiled(ours) == (name == "gn_tiled")
    b = 2
    nbytes, flops, trips = check_gn_counts(monkeypatch, name, spec, pp, b)
    assert gn.level_work(b, ours, params, name == "gn_tiled",
                         n_trips=trips) == (nbytes, flops)


def test_a_call_sums_its_levels():
    cfg = json.loads((HERE / "configs" / "dis_op4_gray.json").read_text())
    params = geometry.params_for(cfg, 1024)
    specs = [geometry.make_level_spec(sl, 1024, 448, params)
             for sl in params.levels]
    small = [s for s in specs if not geometry.uses_tiled(s)]
    large = [s for s in specs if geometry.uses_tiled(s)]
    assert [s.level for s in large] == [3, 2, 1, 0]
    assert large[-1].nopatches == 51300
    for mod, levels, tiled in ((k1, small, False), (k6, large, True)):
        want = [gn.level_work(16, s, params, tiled) for s in levels]
        assert mod.work(16, 1024, 448, params) == (
            sum(x[0] for x in want), sum(x[1] for x in want))
