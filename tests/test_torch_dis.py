"""Port's end-to-end model and CLI against the JAX package and the
compiled-reference goldens.

Tolerances:
  - dis_flow_batched at B=2 on the 192x160 goldens: EPE ratio <= 1e-3
    against JAX — the port's extraction is exact float32 where the JAX CPU
    path reads bf16 hi/lo planes, and float32 sums run in another order;
  - the same 1e-3 for RGB flow, for depth (gray, RGB) and for the float
    gradient-magnitude input of the GRD modes: there the JAX pyramid
    contracts floats through two bf16 planes (measured 5e-6 of a level's
    largest value) where the port stays in float32, and the GN trips
    amplify that to an EPE ratio of 7e-6 — far inside the budget;
  - goldens through the port's cli.main: op-1 < 1e-4 (no TV, sweep-order
    free) and op-2 < 1% (the red-black SOR order), the budgets of
    test_golden_parity.py, for all six modes (op-3/4 and the
    forward-backward merge: tests/test_torch_dis_op34.py)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_dis_tpu.models import dis as jdis
from of_dis_tpu.params import op_point_params as j_op_point_params
from of_dis_tpu.utils import io as jio
from of_dis_tpu_torch import cli, convert
from of_dis_tpu_torch.kernels import upscale
from of_dis_tpu_torch.models import dis as tdis
from of_dis_tpu_torch.ops import pyramid as tpyr
from of_dis_tpu_torch.utils import io as tio

G = os.path.join(os.path.dirname(__file__), "goldens")


def _epe_ratio(ours, ref):
    """Mean end-point error over the reference's mean magnitude, over the
    trailing parameter axis (2 flow, 1 depth)."""
    d = np.linalg.norm(ours - ref, axis=-1)
    return d.mean() / np.linalg.norm(ref, axis=-1).mean()


def _pairs():
    a = np.stack([jio.load_image(os.path.join(G, f)) for f in
                  ("a.png", "b.png")]).astype(np.uint8)
    b = np.stack([jio.load_image(os.path.join(G, f)) for f in
                  ("b.png", "a.png")]).astype(np.uint8)
    return a, b


@pytest.mark.parametrize("op", [1, 2])
def test_dis_flow_batched_matches_jax(op):
    a, b = _pairs()
    jp = j_op_point_params(a.shape[3], op)
    tp = convert.params_from_reference(dataclasses.asdict(jp))
    h, w = a.shape[2], a.shape[3]
    ref = np.asarray(jdis.dis_flow_batched(jnp.asarray(a), jnp.asarray(b),
                                           jp, w, h))
    ours = tdis.dis_flow_batched(a, b, tp, w, h, device="cpu").numpy()
    assert ours.shape == ref.shape == (2, h, w, 2)
    for k in range(2):
        assert _epe_ratio(ours[k], ref[k]) <= 1e-3


def test_sintel_sized_pair_matches_jax_and_true_field():
    """One pair of chip_smoke.py's synthetic workload (`tools/synth.py`) at
    its full 1024x436 size, on the CPU: port vs JAX EPE ratio <= 1e-3 (as above), and both
    within the field limits chip_smoke.py holds the card to (median 0.25
    px, mean EPE 0.6 px in the interior: op-2 stops at 1/8 resolution)."""
    from of_dis_tpu_torch.tools import synth
    a, b, u, v = synth.make_pairs(1, 436, 1024, 0, torch.device("cpu"))
    jp = j_op_point_params(1024, 2)
    im_a = tpyr.pad_to_divisible(a, jp.sc_f)
    im_b = tpyr.pad_to_divisible(b, jp.sc_f)
    ref = np.asarray(jdis.dis_flow_batched(jnp.asarray(im_a.numpy()),
                                           jnp.asarray(im_b.numpy()), jp,
                                           1024, 448))
    ours = tdis.dis_flow_batched(
        im_a, im_b, convert.params_from_reference(dataclasses.asdict(jp)),
        1024, 448, device="cpu").numpy()
    assert _epe_ratio(ours[0], ref[0]) <= 1e-3
    true = np.stack([u.numpy(), v.numpy()], -1)[32:-32, 32:-32]
    for flow in (ours[0], ref[0]):
        crop = flow[6 + 32:6 + 436 - 32, 32:-32]
        med = np.median(crop.reshape(-1, 2), 0)
        assert np.abs(med - np.median(true.reshape(-1, 2), 0)).max() <= 0.25
        assert np.hypot(*(crop - true).transpose(2, 0, 1)).mean() <= 0.6


@pytest.mark.parametrize("op,budget", [(1, 1e-4), (2, 0.01)])
def test_cli_goldens(tmp_path, op, budget):
    out = str(tmp_path / "out.flo")
    cli.main(["run_OF_INT", os.path.join(G, "a.png"), os.path.join(G, "b.png"),
              out, str(op), "--quiet", "--device", "cpu"])
    ratio = _epe_ratio(tio.read_flo(out),
                       tio.read_flo(os.path.join(G, f"of_int_op{op}.flo")))
    assert ratio < budget, ratio


def test_cli_twenty_parameter_form(tmp_path):
    """The explicit form with op-1's settings gives op-1's golden."""
    out = str(tmp_path / "out.flo")
    cli.main(["run_OF_INT", os.path.join(G, "a.png"), os.path.join(G, "b.png"),
              out] + "3 1 16 16 0.05 0.95 0 8 0.3 0 1 0 0 10 10 5 1 3 1.6 0"
             .split() + ["--device", "cpu"])
    ratio = _epe_ratio(tio.read_flo(out),
                       tio.read_flo(os.path.join(G, "of_int_op1.flo")))
    assert ratio < 1e-4, ratio


def test_dis_flow_full_matches_batched():
    a, b = _pairs()
    p = convert.params_from_reference(
        dataclasses.asdict(j_op_point_params(192, 2)))
    full = tdis.dis_flow_full(a[0], b[0], p, 192, 160, device="cpu")
    batched = tdis.dis_flow_batched(a[:1], b[:1], p, 192, 160,
                                    channels_last=False, device="cpu")
    np.testing.assert_array_equal(full.numpy(),
                                  batched[0].permute(1, 2, 0).numpy())


def test_upscale_matches_float64_and_tap_tables():
    """The plain upscale (K4's twin) against a float64 evaluation of the
    INTER_LINEAR matrices, 1e-5 px (float32 rounding of ~10 px values): the
    JAX package's bf16 hi/lo planes put its own CPU result ~1e-4 off."""
    rng = np.random.default_rng(0)
    flow = rng.standard_normal((2, 7, 16, 2)).astype(np.float32)
    ref = np.einsum("ih,bhwc,jw->bijc", tpyr._lerp_matrix(56, 7),
                    flow.astype(np.float64) * 8.0, tpyr._lerp_matrix(128, 16))
    ours = upscale.upscale_batched(torch.as_tensor(flow), 3, 56, 128)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)
    jref = np.asarray(jdis.upscale_output(jnp.asarray(flow[0]), 3, 56, 128))
    np.testing.assert_allclose(ours[0].numpy(), jref, atol=1e-3, rtol=0)
    # the kernel's two-tap tables rebuild the interpolation matrix exactly
    for n_out, n_in, s in ((56, 7, 8.0), (128, 16, 1.0)):
        i0, i1, w0, w1 = upscale.tap_tables(n_out, n_in, s)
        m = np.zeros((n_out, n_in), np.float32)
        np.add.at(m, (np.arange(n_out), i0), w0)
        np.add.at(m, (np.arange(n_out), i1), w1)
        np.testing.assert_array_equal(m, tpyr._lerp_matrix(n_out, n_in) * s)


# (mode, first image, second image): the committed inputs of each golden
MODE_INPUTS = {
    "run_OF_RGB": ("ac.png", "bc.png"), "run_OF_GRD": ("a.png", "b.png"),
    "run_DE_INT": ("a.png", "bs.png"), "run_DE_RGB": ("asc.png", "bsc.png"),
    "run_DE_GRD": ("a.png", "bs.png"),
}


@pytest.mark.parametrize("mode,budget", [
    ("run_OF_RGB", 1e-3), ("run_DE_INT", 1e-3), ("run_DE_RGB", 1e-3),
    ("run_OF_GRD", 1e-3), ("run_DE_GRD", 1e-3)])
def test_dis_flow_batched_modes_match_jax(mode, budget):
    """RGB, depth and gradient-magnitude input through `dis_flow_batched`,
    B=2 (the pair and the pair with its frames swapped)."""
    from of_dis_tpu.ops import pyramid as jpyr
    nop = 2 if "OF" in mode else 1
    noc = 3 if "RGB" in mode else 1
    f1, f2 = (jio.load_image(os.path.join(G, f), noc)
              for f in MODE_INPUTS[mode])
    if "GRD" in mode:
        f1, f2 = (np.asarray(jpyr.gradient_magnitude(jnp.asarray(f)))
                  for f in (f1, f2))
    else:
        f1, f2 = f1.astype(np.uint8), f2.astype(np.uint8)
    a, b = np.stack([f1, f2]), np.stack([f2, f1])
    jp = j_op_point_params(a.shape[3], 2, nop=nop, noc=noc)
    tp = convert.params_from_reference(dataclasses.asdict(jp))
    h, w = a.shape[2], a.shape[3]
    ref = np.asarray(jdis.dis_flow_batched(jnp.asarray(a), jnp.asarray(b),
                                           jp, w, h))
    ours = tdis.dis_flow_batched(a, b, tp, w, h, device="cpu").numpy()
    assert ours.shape == ref.shape == (2, h, w, nop)
    assert _epe_ratio(ours[0], ref[0]) <= budget
    if nop == 2:
        assert _epe_ratio(ours[1], ref[1]) <= budget
    else:
        # swapped frames: the true disparity is positive, the left
        # camera's clamp holds both at <= 0 and the result near zero
        assert ours.max() <= 0.0 and ref.max() <= 0.0
        assert np.abs(ours[1] - ref[1]).mean() <= budget * np.abs(
            ref[0]).mean()


@pytest.mark.parametrize("mode,golden", [
    ("run_OF_RGB", "of_rgb_op2.flo"), ("run_OF_GRD", "of_grd_op2.flo"),
    ("run_DE_INT", "de_int_op2.pfm"), ("run_DE_RGB", "de_rgb_op2.pfm"),
    ("run_DE_GRD", "de_grd_op2.pfm")])
def test_cli_goldens_rgb_grd_depth(tmp_path, mode, golden):
    """The compiled reference's outputs through the port's CLI at op-2:
    1% (.flo: EPE ratio; .pfm: mean abs difference over mean abs
    disparity, which is the same measure on one parameter)."""
    out = str(tmp_path / ("out" + golden[-4:]))
    cli.main([mode] + [os.path.join(G, f) for f in MODE_INPUTS[mode]]
             + [out, "2", "--quiet", "--device", "cpu"])
    if golden.endswith(".flo"):
        ours, ref = tio.read_flo(out), tio.read_flo(os.path.join(G, golden))
    else:
        ours, ref = (tio.read_pfm(f)[..., None]
                     for f in (out, os.path.join(G, golden)))
        assert ours.max() <= 0.0           # left camera: disparity <= 0
    assert ours.shape == ref.shape
    ratio = _epe_ratio(ours, ref)
    assert ratio < 0.01, ratio


def test_dis_flow_full_depth_matches_batched():
    f1, f2 = (jio.load_image(os.path.join(G, f)).astype(np.uint8)
              for f in ("a.png", "bs.png"))
    p = convert.params_from_reference(
        dataclasses.asdict(j_op_point_params(192, 2, nop=1)))
    full = tdis.dis_flow_full(f1, f2, p, 192, 160, device="cpu")
    single = tdis.dis_flow(f1, f2, p, 192, 160, device="cpu")
    batched = tdis.dis_flow_batched(f1[None], f2[None], p, 192, 160,
                                    channels_last=False, device="cpu")
    assert full.shape == (160, 192, 1) and batched.shape == (1, 1, 160, 192)
    assert single.shape == (160 // 2 ** p.sc_l, 192 // 2 ** p.sc_l, 1)
    np.testing.assert_array_equal(full.numpy()[..., 0], batched[0, 0].numpy())


@pytest.mark.parametrize("change", [dict(nop=3), dict(noc=2)])
def test_unknown_mode_shapes_raise(change):
    p = dataclasses.replace(
        convert.params_from_reference(
            dataclasses.asdict(j_op_point_params(64, 2))), **change)
    x = np.zeros((1, p.noc, 32, 64), np.uint8)
    with pytest.raises(ValueError, match="nop must be 1 or 2"):
        tdis.dis_flow_batched(x, x, p, 64, 32, device="cpu")


def test_load_image_matches_reference_loader(monkeypatch):
    """The goldens' frames as the JAX package loads them; a colour PNG read
    as gray as cv::imread reads it (libpng's rgb_to_gray), which is the
    JAX package's cv2 route and not its native decoder's BGR2GRAY."""
    for name in ("a.png", "ac.png", "bsc.png"):
        for ch in (1, 3):
            path = os.path.join(G, name)
            with monkeypatch.context() as m:
                if ch == 1 and name != "a.png":
                    m.setattr(jio, "_native_io", None)
                np.testing.assert_array_equal(tio.load_image(path, ch),
                                              jio.load_image(path, ch))


def test_flo_pfm_round_trip_and_bytes(tmp_path):
    f = np.random.default_rng(1).standard_normal((5, 7, 2)).astype(np.float32)
    tio.write_flo(str(tmp_path / "t.flo"), f)
    jio.write_flo(str(tmp_path / "j.flo"), f)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(tio.read_flo(str(tmp_path / "t.flo")), f)
    tio.write_pfm(str(tmp_path / "t.pfm"), f[..., 0])
    jio.write_pfm(str(tmp_path / "j.pfm"), f[..., 0])
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
    np.testing.assert_array_equal(tio.read_pfm(str(tmp_path / "t.pfm")),
                                  f[..., 0])


def test_load_image_pnm(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (6, 9, 3), np.uint8)
    path = tmp_path / "x.ppm"
    path.write_bytes(b"P6\n# c\n9 6\n255\n" + img.tobytes())
    bgr = tio.load_image(str(path), 3)
    np.testing.assert_array_equal(bgr, img[..., ::-1].transpose(2, 0, 1))
    gray = tio.load_image(str(path), 1)[0].astype(np.int64)
    r, g, b = (img[..., k].astype(np.int64) for k in range(3))
    np.testing.assert_array_equal(
        gray, (r * 4899 + g * 9617 + b * 1868 + 8192) >> 14)
