"""Port's patch solver (templates, GN loop; flow and depth, gray and RGB)
against the JAX package.

Tolerances, each with its reason:
  - templates and Hessians: 1e-5 relative (of the field's largest value) —
    float32 sums over the patch in another order;
  - GN: `iters` equal; `p` within 1e-3 px — float32 reductions in another
    order, carried through 12 dependent trips; `pweight` within 1e-4
    relative to the level's largest weight (a residual moves by p's
    float32 difference times the image gradient). The target planes are
    integer-valued, which the JAX XLA path's bf16 hi/lo extraction
    reproduces exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_dis_tpu import params as jparams
from of_dis_tpu.ops import patch_solver as jps
from of_dis_tpu.ops import pyramid as jpyr
from of_dis_tpu_torch import convert
from of_dis_tpu_torch.ops import patch_solver as tps


def _blur(x, k=5):
    ker = np.ones(k) / k
    x = np.apply_along_axis(lambda r: np.convolve(r, ker, "same"), -1, x)
    return np.apply_along_axis(lambda r: np.convolve(r, ker, "same"), -2, x)


def _level(seed=0, b=2, h=40, w=48, shift=(1.6, -0.7), c=1):
    """Integer-valued pair batch (B, c, h, w) with a subpixel shift."""
    rng = np.random.default_rng(seed)
    big = _blur(rng.random((b, c, h + 8, w + 8)) * 255)
    yy, xx = np.mgrid[0:h, 0:w]
    a = big[:, :, 4:4 + h, 4:4 + w]
    sx, sy = shift
    x0 = np.floor(xx + 4 - sx).astype(int)
    y0 = np.floor(yy + 4 - sy).astype(int)
    fx, fy = (xx + 4 - sx) - x0, (yy + 4 - sy) - y0
    bb = ((1 - fy) * ((1 - fx) * big[..., y0, x0] + fx * big[..., y0, x0 + 1])
          + fy * ((1 - fx) * big[..., y0 + 1, x0] + fx * big[..., y0 + 1, x0 + 1]))
    return np.rint(a).astype(np.uint8), np.rint(bb).astype(np.uint8)


def _setup(params, seed=0, camlr=0, shift=(1.6, -0.7)):
    a, b = _level(seed, shift=shift, c=params.noc)
    spec = jparams.make_level_spec(0, a.shape[3], a.shape[2], params,
                                   camlr=camlr)
    pad = params.p_samp_s
    j = [jpyr.build_pyramid(jnp.asarray(x[k]), 0, pad)
         for x in (a, b) for k in range(x.shape[0])]
    nb = a.shape[0]
    ja = [jnp.stack([j[k][f][0] for k in range(nb)]) for f in range(3)]
    jb = jnp.stack([j[nb + k][0][0] for k in range(nb)])
    ta = [torch.as_tensor(np.array(x)) for x in ja]
    tb = torch.as_tensor(np.array(jb))
    tparams = convert.params_from_reference(dataclasses.asdict(params))
    return spec, tparams, ja, jb, ta, tb


def _scaled_close(ours, ref, rel):
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(ours, ref, atol=rel * scale, rtol=0)


def test_params_round_trip():
    p = jparams.op_point_params(1024, 2)
    assert dataclasses.asdict(
        convert.params_from_reference(dataclasses.asdict(p))) \
        == dataclasses.asdict(p)


def test_templates_match_jax():
    params = jparams.op_point_params(48, 2)
    spec, tparams, ja, _, ta, _ = _setup(params)
    ref = [jps.extract_templates(spec, params, ja[0][k], ja[1][k], ja[2][k])
           for k in range(2)]
    ours = tps.extract_templates(spec, tparams, *ta)
    for f in range(4):
        for k in range(2):
            _scaled_close(ours[f][k].numpy(), ref[k][f], 1e-5)


def test_init_from_coarser_matches_jax():
    params = jparams.op_point_params(48, 2)
    spec = jparams.make_level_spec(1, 96, 80, params)
    flow = np.random.default_rng(4).standard_normal(
        (spec.height // 2, spec.width // 2, 2)).astype(np.float32)
    ref = jps.init_from_coarser(spec, params, jnp.asarray(flow))
    ours = tps.init_from_coarser(spec, params, torch.as_tensor(flow)[None])
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref))


@pytest.mark.parametrize("costfct", [0, 1, 2])
def test_loss_error_image_matches_jax(costfct):
    d = np.random.default_rng(costfct).standard_normal((64, 9)).astype(
        np.float32) * 20
    for a, b in zip(tps.loss_error_image(torch.as_tensor(d), costfct),
                    jps.loss_error_image(jnp.asarray(d), costfct)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("costfct,min_iter,init_scale", [
    (0, 12, 1.0),     # op-2 L2, min_iter == max_iter
    (1, 12, 1.0),     # L1
    (2, 12, 1.0),     # pseudo-Huber
    (0, 3, 1.0),      # stopping rule active after trip 3
    (0, 12, 8.0),     # large inits: out-of-bounds starts and resets
])
def test_gn_matches_jax(costfct, min_iter, init_scale):
    params = dataclasses.replace(jparams.op_point_params(48, 2),
                                 costfct=costfct, min_iter=min_iter)
    spec, tparams, ja, jb, ta, tb = _setup(params, seed=costfct + min_iter)
    rng = np.random.default_rng(11)
    p_init = (rng.standard_normal((2, spec.nopatches, 2)) * init_scale
              ).astype(np.float32)
    ref = jps.optimize_level_batched(spec, params, jb, None,
                                     jnp.asarray(p_init), src=tuple(ja))
    tpl = tps.extract_templates(spec, tparams, *ta)
    ours = tps.optimize_level_batched(spec, tparams, tb, tpl,
                                      torch.as_tensor(p_init))
    assert int(ours.iters) == int(ref.iters)
    np.testing.assert_allclose(ours.p.numpy(), np.asarray(ref.p), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(ours.pt.numpy(), np.asarray(ref.pt),
                               atol=1e-3, rtol=0)
    _scaled_close(ours.pweight.numpy(), ref.pweight, 1e-4)


def test_gn_plain_trips_bound_iters():
    """`iters` is the largest per-patch trip count (the kernel's atomicMax)."""
    params = dataclasses.replace(jparams.op_point_params(48, 2), min_iter=2)
    spec, tparams, _, _, ta, tb = _setup(params, seed=3)
    tpl = tps.extract_templates(spec, tparams, *ta)
    pt_ref = tps.grid_ref_points(spec).T[None]
    p0 = torch.zeros((2, 2, spec.nopatches))
    _, _, iters, trips = tps._gn_plain(spec, tparams, tb, tpl, p0, pt_ref)
    assert int(iters) == int(trips.max())
    assert 0 < int(iters) <= params.max_iter


# ------------------------------------------- depth (nop=1) and RGB (noc=3)

MODES = [(1, 1), (2, 3), (1, 3)]


@pytest.mark.parametrize("nop,noc", MODES)
def test_templates_match_jax_depth_and_rgb(nop, noc):
    params = jparams.op_point_params(48, 2, nop=nop, noc=noc)
    spec, tparams, ja, _, ta, _ = _setup(params)
    ref = [jps.extract_templates(spec, params, ja[0][k], ja[1][k], ja[2][k])
           for k in range(2)]
    ours = tps.extract_templates(spec, tparams, *ta)
    assert ours.tmpl.shape == (2, 64 * noc, spec.nopatches)
    assert ours.hes.shape == (2, 3 if nop == 2 else 1, spec.nopatches)
    for f in range(4):
        for k in range(2):
            _scaled_close(ours[f][k].numpy(), ref[k][f], 1e-5)
    # the JAX templates, carried across as numpy, drive the port's GN loop
    # to the result its own templates give
    carried = convert.tensors_from_numpy(
        tps.PatchTemplates, *(np.stack([np.asarray(r[f]) for r in ref])
                              for f in range(4)))
    assert [tuple(t.shape) for t in carried] == [tuple(t.shape) for t in ours]
    p0 = torch.zeros((2, spec.nopatches, nop))
    tb = torch.as_tensor(np.array(_setup(params)[3]))
    a = tps.optimize_level_batched(spec, tparams, tb, carried, p0)
    b = tps.optimize_level_batched(spec, tparams, tb, ours, p0)
    np.testing.assert_allclose(a.p.numpy(), b.p.numpy(), atol=1e-3, rtol=0)


@pytest.mark.parametrize("nop", [1, 2])
def test_flat_template_hessian_guard_matches_jax(nop):
    """A flat image has zero gradients: h00 == 0 (depth) or det == 0
    (flow) takes the +1e-10 guard, exactly as in the JAX package."""
    params = jparams.op_point_params(48, 2, nop=nop)
    spec = jparams.make_level_spec(0, 48, 40, params)
    flat = np.full((1, 40 + 16, 48 + 16), 7.0, np.float32)
    zero = np.zeros_like(flat)
    ref = jps.extract_templates(spec, params, *map(jnp.asarray,
                                                   (flat, zero, zero)))
    tparams = convert.params_from_reference(dataclasses.asdict(params))
    ours = tps.extract_templates(spec, tparams, *(
        torch.as_tensor(x)[None] for x in (flat, zero, zero)))
    np.testing.assert_array_equal(ours.hes[0].numpy(), np.asarray(ref.hes))
    assert float(ours.hes[0, 0, 0]) == np.float32(1e-10)
    # the carry-across function builds the same NamedTuple from numpy
    carried = convert.tensors_from_numpy(tps.PatchTemplates,
                                         *(np.asarray(f)[None] for f in ref))
    for a, b in zip(carried, ours):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _gn_both(params, camlr, seed, init_scale, shift):
    spec, tparams, ja, jb, ta, tb = _setup(params, seed=seed, camlr=camlr,
                                           shift=shift)
    rng = np.random.default_rng(11)
    p_init = (rng.standard_normal((2, spec.nopatches, params.nop))
              * init_scale).astype(np.float32)
    ref = jps.optimize_level_batched(spec, params, jb, None,
                                     jnp.asarray(p_init), src=tuple(ja))
    tpl = tps.extract_templates(spec, tparams, *ta)
    ours = tps.optimize_level_batched(spec, tparams, tb, tpl,
                                      torch.as_tensor(p_init))
    return spec, p_init, ref, ours


def _assert_gn_close(ref, ours):
    assert int(ours.iters) == int(ref.iters)
    assert ours.p.shape == ref.p.shape and ours.pt.shape == ref.pt.shape
    np.testing.assert_allclose(ours.p.numpy(), np.asarray(ref.p), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(ours.pt.numpy(), np.asarray(ref.pt),
                               atol=1e-3, rtol=0)
    _scaled_close(ours.pweight.numpy(), ref.pweight, 1e-4)


@pytest.mark.parametrize("costfct", [0, 1, 2])
@pytest.mark.parametrize("nop,noc", MODES)
def test_gn_matches_jax_depth_and_rgb(nop, noc, costfct):
    params = dataclasses.replace(
        jparams.op_point_params(48, 2, nop=nop, noc=noc), costfct=costfct)
    # depth of the left camera: the second frame sits at negative x
    shift = (1.6, -0.7) if nop == 2 else (-1.6, 0.0)
    spec, _, ref, ours = _gn_both(params, 0, costfct + nop + noc, 1.0, shift)
    _assert_gn_close(ref, ours)
    assert ours.pweight.shape == (2, 8, 8, spec.nopatches)
    if nop == 1:
        # the patch moves along x only
        np.testing.assert_array_equal(
            ours.pt[..., 1].numpy(),
            np.broadcast_to(tps.grid_ref_points(spec)[:, 1].numpy(),
                            ours.pt[..., 1].shape))


@pytest.mark.parametrize("noc", [1, 3])
@pytest.mark.parametrize("camlr", [0, 1])
def test_gn_depth_sign_clamp_matches_jax(camlr, noc):
    """The disparity clamp before the reset test, for both cameras, with
    starts of both signs and large enough to reset or start outside."""
    params = jparams.op_point_params(48, 2, nop=1, noc=noc)
    shift = (-1.6, 0.0) if camlr == 0 else (1.6, 0.0)
    _, p_init, ref, ours = _gn_both(params, camlr, 5 + camlr + noc, 3.0,
                                    shift)
    _assert_gn_close(ref, ours)
    moved = ours.p.numpy() != p_init
    assert moved.any()
    vals = ours.p.numpy()[moved]
    assert (vals <= 0).all() if camlr == 0 else (vals >= 0).all()


@pytest.mark.parametrize("noc,d", [(1, 64), (3, 192), (1, 144), (3, 432)])
def test_lane_sum_follows_the_kernel_order(noc, d):
    """`_lane_sum` adds lane by lane as the GN kernel does: pixel
    lane + 32k, its channels in order, then the butterfly; float32 at
    every step (checked against an explicit scalar loop)."""
    x = np.random.default_rng(d).standard_normal((1, d, 2)).astype(
        np.float32) * 100
    ours = tps._lane_sum(torch.as_tensor(x), noc).numpy()
    pix = d // noc
    for n in range(2):
        lanes = []
        for lane in range(32):
            s = None
            for k in range(-(-pix // 32)):
                for c in range(noc):
                    p = lane + 32 * k
                    v = x[0, p * noc + c, n] if p < pix else np.float32(0)
                    s = v if s is None else np.float32(s + v)
            lanes.append(s)
        w = 32
        while w > 1:
            w //= 2
            lanes = [np.float32(lanes[i] + lanes[i + w]) for i in range(w)]
        assert ours[0, n] == lanes[0]
