"""The port's per-stage ablation of the Gauss-Newton iteration (T2,
`kernels.gn_stages`, its tool `of_dis_tpu_torch.tools.bench_gn_stages`)
against the JAX package's tools/bench_gn_stages.py, whose Pallas kernel
runs in interpret mode on the CPU in a child process.

The two tools draw the same inputs (default_rng(0), the JAX tool's order)
at the op-2 level-3 geometry. The JAX kernel sums its checksum over the
pairs of one program (2 at batch 2) and per trip over the patch; the port
keeps one checksum a pair and sums per lane across the trips. So the
stages that compute the same function — A3 (bilinear, patch sum) and A4
(+ mean, residual, |.| / psz^2, projections; the JAX B and C variants are
A4 too) — agree to rounding: within 1e-5 of each patch's sum of absolute
terms, taken in float64. The port's W stage (tap loads) has no JAX
counterpart (the JAX A0-A2 sum TPU layout buffers) and is held against a
float64 evaluation only, as every stage is at a geometry of 5 pixels a
lane. The column layout's twin (K6's: 16 lanes a patch, two patches a
warp) sums in another order: it is held against the float64 evaluation
at the same 1e-5 and against the lane layout's twin to rounding. The
card's kernel is held against the twin in
tests/test_torch_kernels_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

from of_dis_tpu_torch.kernels import build, gn_stages
from of_dis_tpu_torch.tools import bench_gn_stages as bgs
from tests.test_torch_i8_dot import run_jax_tool

OP2 = bgs.GEOMETRIES["op2-l3"]
# the JAX tool's variants in run order; each kernel runs twice at reps 1
JAX_VARIANTS = ("A0", "A1", "A2", "A3", "A4", "B1", "B2", "B3", "C1")
# psz 12: 144 pixels, 5 a lane with the last one ragged
SMALL = bgs.Geometry(12, 40, 60, 7, 5, 2, 3, 40 - 12 - 3)
# the column layout at SMALL, and at psz 12 with an odd patch count
# (the last warp's second segment runs the last patch again) and anchors
# that leave the plane, where the window's rows and columns clamp
COLUMNS = dataclasses.replace(SMALL, layout=gn_stages.COLUMNS)
COLUMNS_ODD = bgs.Geometry(12, 30, 50, 9, 4, 1, 2, 30 - 12 - 3,
                           gn_stages.COLUMNS)


@pytest.fixture(scope="module")
def jax_outs(tmp_path_factory):
    outs = run_jax_tool("bench_gn_stages.py", ["2", "1"],
                        tmp_path_factory.mktemp("gn_stages"),
                        env={"GN_STAGES_INTERPRET": "1"})
    assert len(outs) == 2 * len(JAX_VARIANTS)
    return {v: outs[2 * k][0] for k, v in enumerate(JAX_VARIANTS)}


def reference_f64(x, geom, stage):
    """(value, magnitude) per pair and patch in float64: the stage's
    checksum and the sum of the absolute values of its terms."""
    planes = x["planes"].double().numpy()
    sx0, sy0 = x["sx0"].numpy(), x["sy0"].numpy()
    tm, tx, ty = (x[k].double().numpy() for k in ("tmpl", "tdx", "tdy"))
    b, hp, wp = planes.shape
    d = geom.psz * geom.psz
    j, i = np.divmod(np.arange(d), geom.psz)
    bi = np.arange(b)[:, None, None]
    val = np.zeros(sx0.shape)
    mag = np.zeros(sx0.shape)
    for it in range(geom.max_iter):
        y = (sy0 + 3 * (it % 2))[..., None] + j
        xx = (sx0 + it)[..., None] + i

        def tap(dy, dx):
            return planes[bi, np.clip(y + dy, 0, hp - 1),
                          np.clip(xx + dx, 0, wp - 1)]

        v00, v01, v10, v11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
        if stage == "W":
            s = (v00 + v01 + v10 + v11).sum(-1)
            val, mag = val + s, mag + s
            continue
        rx, ry = gn_stages.residuals(it)[:2]
        px = (rx * ((1 - ry) * v01 + ry * v11)
              + (1 - rx) * ((1 - ry) * v00 + ry * v10))
        if stage == "A3":
            val, mag = val + px.sum(-1), mag + np.abs(px).sum(-1)
            continue
        pd = px - px.mean(-1, keepdims=True) - tm
        terms = (np.abs(pd) / d, tx * pd, ty * pd)
        val = val + sum(t.sum(-1) for t in terms)
        mag = mag + sum(np.abs(t).sum(-1) for t in terms)
    return val, mag


@pytest.mark.parametrize("jax_stage,ours", [
    ("A3", "A3"), ("A4", "A4"), ("B1", "A4"), ("B2", "A4"), ("B3", "A4"),
    ("C1", "A4")])
def test_twin_matches_the_jax_kernel(jax_outs, jax_stage, ours):
    x = bgs.make_inputs(OP2, 2, "cpu")
    out = bgs.call(x, OP2, ours).double().numpy()
    _, mag = reference_f64(x, OP2, ours)
    ref = jax_outs[jax_stage].astype(np.float64)
    assert ref.shape == (OP2.n,)
    err = np.abs(out.sum(0) - ref)
    assert (err <= 1e-5 * mag.sum(0)).all(), err.max()


@pytest.mark.parametrize("stage", gn_stages.STAGES)
def test_twin_matches_float64_at_five_pixels_a_lane(stage):
    x = bgs.make_inputs(SMALL, SMALL.batch, "cpu")
    out = bgs.call(x, SMALL, stage).double().numpy()
    val, mag = reference_f64(x, SMALL, stage)
    assert out.shape == (SMALL.batch, SMALL.n)
    assert (np.abs(out - val) <= 1e-5 * mag).all()


def _column_inputs(geom):
    x = bgs.make_inputs(geom, geom.batch, "cpu")
    if geom is COLUMNS_ODD:
        x["sx0"][:, ::2] += 30                # past the right border
        x["sy0"][:, 1::3] -= 9                # above the top border
    return x


@pytest.mark.parametrize("stage", gn_stages.STAGES)
@pytest.mark.parametrize("geom", [COLUMNS, COLUMNS_ODD],
                         ids=["small", "odd-patches"])
def test_column_twin_matches_float64(geom, stage):
    x = _column_inputs(geom)
    out = bgs.call(x, geom, stage).double().numpy()
    val, mag = reference_f64(x, geom, stage)
    assert out.shape == (geom.batch, geom.n)
    assert (np.abs(out - val) <= 1e-5 * mag).all()


@pytest.mark.parametrize("stage", gn_stages.STAGES)
@pytest.mark.parametrize("geom", [COLUMNS, COLUMNS_ODD],
                         ids=["small", "odd-patches"])
def test_column_twin_matches_the_lane_twin(geom, stage):
    """The same function on both layouts: the taps and each pixel's lerp
    are the same float32 operations, so only the sums' order differs; W
    (integer-valued sums far below 2^24) is equal."""
    x = _column_inputs(geom)
    cols = bgs.call(x, geom, stage)
    lanes = bgs.call(x, dataclasses.replace(geom, layout=gn_stages.LANES),
                     stage)
    if stage == "W":
        assert torch.equal(cols, lanes)
    torch.testing.assert_close(cols, lanes, rtol=1e-5,
                               atol=1e-5 * float(lanes.abs().max()))


@pytest.mark.parametrize("geom", [OP2, SMALL, COLUMNS],
                         ids=["op2-l3", "psz12", "psz12-columns"])
def test_tool_variants_equal_a4_bit_for_bit(geom, capsys):
    """On the CPU the tool runs the twin; the u16 planes (value * 4^lv)
    convert back to the float planes exactly, so every variant's
    checksums equal A4's."""
    before = gn_stages.launches
    rows = bgs.run(geom, 2, 1, torch.device("cpu"))
    assert gn_stages.launches == before and not build._libs
    assert [r["label"] for r in rows] == [r[0] for r in bgs.RUNS]
    assert all(r["equal_a4"] for r in rows if r["variant"])
    assert capsys.readouterr().out.count("== A4 (bit)") == 3


def test_inputs_follow_the_jax_draws():
    """Level planes on the 4^-lv grid within [0, 255], u16 planes their
    exact integers, windows inside the plane for every trip."""
    for geom in (OP2, SMALL, bgs.GEOMETRIES["op4-l0"]):
        x = bgs.make_inputs(geom, 1 if geom.n > 1000 else 2, "cpu")
        p = x["planes"]
        assert float(p.min()) >= 0 and float(p.max()) <= 255
        assert torch.equal(x["planes_u16"].float() * x["scale"], p)
        assert int(x["sx0"].max()) + geom.max_iter + geom.psz < geom.wp
        assert int(x["sy0"].max()) + 3 + geom.psz < geom.hp


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = bgs.make_inputs(SMALL, 1, "cpu")
    args = (x["tmpl"], x["tdx"], x["tdy"], x["sx0"], x["sy0"], 12, 2)
    lanes = gn_stages.LANES
    with pytest.raises(ValueError, match="unknown stage"):
        gn_stages.gn_stages(x["planes"], *args, "W", "B-smem", 1.0, lanes)
    with pytest.raises(ValueError, match="takes torch.uint16 planes"):
        gn_stages.gn_stages(x["planes"], *args, "A4", "C-u16", 1.0, lanes)
    with pytest.raises(ValueError, match="patch size 13"):
        gn_stages.gn_stages(x["planes"], *args[:5], 13, 2, "A4", "", 1.0,
                            lanes)
    with pytest.raises(ValueError, match="unknown layout 2"):
        gn_stages.gn_stages(x["planes"], *args, "A4", "", 1.0, 2)
