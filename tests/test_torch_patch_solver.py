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
from of_dis_tpu_torch import convert, trace
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


def _setup(params, seed=0, camlr=0, shift=(1.6, -0.7), pair=None):
    a, b = _level(seed, shift=shift, c=params.noc) if pair is None else pair
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


@pytest.mark.parametrize("noc", [1, 3])
def test_template_mean_is_the_rounded_exact_mean(noc):
    """The template mean is the float64 mean rounded once, on level-5
    values (multiples of 1/1024): a float32 sum of an RGB patch's 192
    such values rounds (a gray 8-pixel patch's 64 do not), in an order
    that follows the batch on CUDA."""
    params = jparams.op_point_params(48, 2, nop=2, noc=noc)
    spec, tparams, _, _, ta, _ = _setup(params)
    rng = np.random.default_rng(3)
    im = torch.as_tensor((rng.integers(0, 255 * 1024, ta[0].shape)
                          / 1024).astype(np.float32))
    got = tps.extract_templates(spec, tparams, im, ta[1], ta[2]).tmpl
    raw = tps._gather_templates(spec, params.p_samp_s, im)
    mean = raw.double().mean(dim=-2, keepdim=True).float()
    assert torch.equal(got, raw - mean)


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


def _singular_hessians(n=4096, seed=19):
    """(B=1, 3, n) Hessians, float32-singular (h01^2 == h00 * h11 up to
    rounding, as a bilevel frame's straight edges give) and near it, and
    (1, 2, n) projections, some parallel to the Hessian's null space. The
    last 64 Hessians have h00 * h11 = 3 + 1.5 * 2^-22, halfway between two
    float32 values, and a tiny h01: one rounding of h00 * h11 - h01^2 goes
    down, a rounding to float64 and then to float32 would go up."""
    rng = np.random.default_rng(seed)
    h00 = (rng.integers(1, 1 << 16, n) / 64.0).astype(np.float32)
    ratio = rng.choice([1.0, 0.25, 4.0, 1 + 1e-7], n)
    h11 = (h00 * ratio).astype(np.float32)
    h01 = (np.sqrt(h00.astype(np.float64) * h11) * rng.choice([-1, 1], n)
           * rng.choice([1.0, 1 - 1e-6, 1 - 1e-3], n)).astype(np.float32)
    h00[-64:], h11[-64:], h01[-64:] = 3.0, 1 + 2.0 ** -23, 2.0 ** -30
    hes = np.stack([h00, h01, h11])[None]
    r0 = (rng.standard_normal(n) * 1e4).astype(np.float32)
    r1 = np.where(rng.random(n) < 0.5, r0 * np.sign(h01),
                  rng.standard_normal(n) * 1e4).astype(np.float32)
    return hes, np.stack([r0, r1])[None]


def _fms_exact(a, b, c, d):
    """fma(a, b, -(c * d)) of float32 scalars from the exact rational
    value, rounded to the nearest float32, ties to even."""
    from fractions import Fraction
    v = (Fraction(float(a)) * Fraction(float(b))
         - Fraction(float(np.float32(c) * np.float32(d))))
    f = np.float32(float(v))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    return min(near, key=lambda q: (abs(Fraction(float(q)) - v),
                                    int(np.array(q).view(np.int32)) & 1))


def test_fms_rounds_once():
    """`_fms` is fma(a, b, -(c * d)), one rounding of the exact value,
    over random operands of mixed scales and float32 ties that a rounding
    through float64 would break the other way."""
    rng = np.random.default_rng(5)
    n = 4096
    a = (rng.standard_normal(n) * rng.choice([1, 1e-3, 1e3], n)
         ).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    c = (rng.standard_normal(n) * rng.choice([1, 1e-10, 1e-20], n)
         ).astype(np.float32)
    d = rng.standard_normal(n).astype(np.float32)
    a[:64], b[:64] = 3.0, 1 + 2.0 ** -23
    c[:64] = d[:64] = 2.0 ** -30 * rng.choice([-1, 1], 64)
    got = tps._fms(*map(torch.as_tensor, (a, b, c, d))).numpy()
    want = np.array([_fms_exact(*x) for x in zip(a, b, c, d)], np.float32)
    np.testing.assert_array_equal(got, want)
    assert got[0] == np.float32(3 + 2.0 ** -22)


def test_singular_hessian_solve_matches_jax():
    """The 2x2 solve's determinant and numerators are each one fused
    multiply-add, as XLA computes the JAX package's a * b - c * d: where
    the Hessian is singular in float32 (a bilevel frame's edges) the step
    is JAX's, bit for bit, finite where JAX's is, and not 0 / 0."""
    import jax
    hes, rhs = _singular_hessians()
    want = np.asarray(jax.jit(lambda h, r: jps._solve_step(h, r, 2))(
        jnp.asarray(hes), jnp.asarray(rhs)))
    got = tps._solve_step(torch.as_tensor(hes), torch.as_tensor(rhs),
                          2).numpy()
    np.testing.assert_array_equal(got, want)
    edge = np.array([[[1016.015625], [-1016.015625], [1016.015625]]],
                    np.float32)
    step = tps._solve_step(torch.as_tensor(edge),
                           torch.zeros((1, 2, 1)), 2)
    assert torch.equal(step, torch.zeros((1, 2, 1)))   # was 0 / 0


def test_bilevel_edge_templates_and_gn_match_jax():
    """Bilevel frames with straight 45-degree edges (every patch on an
    edge has h00 == h11 == |h01|) moving one pixel: the Hessians and their
    guard as JAX's, bit for bit, and a finite Gauss-Newton level (0 / 0
    before). A float32-singular patch's step is the rounding of its
    projections over a determinant of rounding: the JAX package's differ
    from the port's wherever XLA fused its sums (here most agree to 1e-6
    px, some are pixels apart), so only the patches with a regular Hessian
    (the flat ones, here) are held to JAX's values. For the singular ones
    the only comparison with JAX is end to end, the flow of Group 4 frames
    in `test_torch_tiff_fax.py::test_fax_cli_matches_jax`."""
    params = jparams.op_point_params(48, 2)
    yy, xx = np.mgrid[0:40, 0:48]
    steps = [np.stack([(xx - yy + d) % 48 < 24, (xx + yy + d) % 48 < 24])
             for d in (0, 1)]
    a, b = (((x * 255)[:, None]).astype(np.uint8) for x in steps)
    spec, tparams, ja, jb, ta, tb = _setup(params, pair=(a, b))
    for k in range(2):
        ref = jps.extract_templates(spec, params, *(x[k] for x in ja))
        ours = tps.extract_templates(spec, tparams, *(x[k] for x in ta))
        np.testing.assert_array_equal(ours.hes.numpy(), np.asarray(ref.hes))
    p_init = np.zeros((2, spec.nopatches, 2), np.float32)
    ref = jps.optimize_level_batched(spec, params, jb, None,
                                     jnp.asarray(p_init), src=tuple(ja))
    ours = tps.optimize_level_batched(
        spec, tparams, tb, tps.extract_templates(spec, tparams, *ta),
        torch.as_tensor(p_init))
    assert torch.isfinite(ours.p).all() and np.isfinite(ref.p).all()
    flat = tps.extract_templates(spec, tparams, *ta).hes[:, 1] == 0
    assert 0 < int(flat.sum()) < flat.numel()
    np.testing.assert_array_equal(ours.p.numpy()[flat.numpy()],
                                  np.asarray(ref.p)[flat.numpy()])


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


def test_column_sum_adds_columns_first():
    """`_column_sum` on a 2x2 patch where the order shows: the columns
    (lanes) add down their rows first, 2^24 - 2^24 = 0 and 1 + 1 = 2, then
    the butterfly adds the lanes (0 + 0, 2 + 0, then 0 + 2): 2. Row by row
    in float32 the first 1 is lost against 2^24 and the sum is 1."""
    big = float(2 ** 24)
    x = torch.tensor([[[big], [1.0], [-big], [1.0]]], dtype=torch.float32)
    assert tps.column_segment(2) == 4
    assert float(tps._column_sum(x, 1)[0, 0]) == 2.0
    row_major = np.float32(0)
    for v in (big, 1.0, -big, 1.0):
        row_major = np.float32(row_major + np.float32(v))
    assert row_major == 1.0


@pytest.mark.parametrize("psz,seg", [(1, 2), (2, 4), (3, 4), (4, 8), (7, 8),
                                     (8, 16), (12, 16)])
def test_column_segment_is_the_power_of_two_above_the_patch(psz, seg):
    assert tps.column_segment(psz) == seg


@pytest.mark.parametrize("noc,psz", [(1, 12), (3, 12), (1, 8), (3, 5),
                                     (1, 3)])
def test_column_sum_follows_the_kernel_order(noc, psz):
    """`_column_sum` adds as the `gn_tiled` kernel does: lane i of the
    patch's segment holds column i and adds its pixels (j, i) row by row,
    channels in order, from the first; the lanes beyond psz hold 0; then
    the butterfly over the segment; float32 at every step (checked against
    an explicit scalar loop)."""
    d = psz * psz * noc
    x = np.random.default_rng(d + noc).standard_normal((1, d, 2)).astype(
        np.float32) * 100
    ours = tps._column_sum(torch.as_tensor(x), noc).numpy()
    seg = tps.column_segment(psz)
    for n in range(2):
        lanes = []
        for col in range(seg):
            s = np.float32(0)
            if col < psz:
                s = None
                for j in range(psz):
                    for c in range(noc):
                        v = x[0, (j * psz + col) * noc + c, n]
                        s = v if s is None else np.float32(s + v)
            lanes.append(s)
        w = seg
        while w > 1:
            w //= 2
            lanes = [np.float32(lanes[i] + lanes[i + w]) for i in range(w)]
        assert ours[0, n] == lanes[0]


# ------------------------- the large-level route: `gn_tiled` and its twin
#
# Tolerances: `iters` equal; `p` within 2e-3 px and `pweight` within rtol
# 1e-3 (atol 5e-2) — the budget the JAX package holds its own tiled kernel
# to against its XLA path (tests/test_gn_tiled.py): the twin sums the
# template mean, the Hessian and every patch sum in the CUDA kernel's lane
# order, the JAX path in XLA's, and 16 dependent trips amplify the ulps.

def _assert_tiled_close(ref, ours):
    assert int(ours.iters) == int(ref.iters)
    np.testing.assert_allclose(ours.p.numpy(), np.asarray(ref.p), rtol=1e-4,
                               atol=2e-3)
    np.testing.assert_allclose(ours.pt.numpy(), np.asarray(ref.pt),
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(ours.pweight.numpy(), np.asarray(ref.pweight),
                               rtol=1e-3, atol=5e-2)


def _op3_level_params(**changes):
    """op-3's patch geometry (size 12, grid step 3) and its 16 trips."""
    return dataclasses.replace(jparams.op_point_params(48, 3), sc_f=0,
                               sc_l=0, **changes)


def _tiled_both(monkeypatch, params, camlr=0, seed=0, init_scale=1.0,
                shift=(1.6, -0.7)):
    """The same level through JAX's optimize_level_batched(tpl=None,
    src=...) on the CPU (its XLA route) and through the port's large-level
    route (the twin of `gn_tiled`)."""
    spec, tparams, ja, jb, ta, tb = _setup(params, seed=seed, camlr=camlr,
                                           shift=shift)
    rng = np.random.default_rng(13)
    p_init = (rng.standard_normal((2, spec.nopatches, params.nop))
              * init_scale).astype(np.float32)
    ref = jps.optimize_level_batched(spec, params, jb, None,
                                     jnp.asarray(p_init), src=tuple(ja))
    monkeypatch.setattr(tps, "TILED_MIN_PATCHES", 0)
    assert tps.uses_tiled(spec)
    calls = []
    monkeypatch.setattr(tps.gn_fused, "gn_fused",
                        lambda *a: calls.append("gn_fused"))
    ours = tps.optimize_level_batched(spec, tparams, tb, None,
                                      torch.as_tensor(p_init), src=tuple(ta))
    assert not calls
    return spec, p_init, ref, ours


@pytest.mark.parametrize("nop,noc,camlr,costfct,patnorm", [
    (2, 1, 0, 0, 1), (2, 1, 0, 1, 1), (2, 1, 0, 2, 0), (2, 1, 0, 0, 0),
    (2, 3, 0, 0, 1), (2, 3, 0, 2, 1), (1, 1, 0, 0, 1), (1, 1, 1, 0, 1),
    (1, 1, 1, 1, 0), (1, 3, 0, 0, 1), (1, 3, 1, 2, 1)])
def test_gn_tiled_plain_matches_jax(monkeypatch, nop, noc, camlr, costfct,
                                    patnorm):
    params = _op3_level_params(nop=nop, noc=noc, costfct=costfct,
                               patnorm=patnorm)
    assert (params.p_samp_s, params.steps, params.max_iter) == (12, 3, 16)
    shift = (1.6, -0.7) if nop == 2 else \
        ((-1.6, 0.0) if camlr == 0 else (1.6, 0.0))
    spec, p_init, ref, ours = _tiled_both(
        monkeypatch, params, camlr=camlr,
        seed=nop + noc + camlr + costfct + patnorm, shift=shift)
    _assert_tiled_close(ref, ours)
    assert ours.pweight.shape == (2, 12, 12, spec.nopatches)
    if nop == 1:
        vals = ours.p.numpy()[ours.p.numpy() != p_init]
        assert (vals <= 0).all() if camlr == 0 else (vals >= 0).all()


@pytest.mark.parametrize("nop", [1, 2])
def test_gn_tiled_plain_out_of_bounds_starts_match_jax(monkeypatch, nop):
    """Large starts: patches that begin outside keep p_init and take the
    template's cost weight; others reset on the way."""
    params = _op3_level_params(nop=nop)
    spec, p_init, ref, ours = _tiled_both(monkeypatch, params, seed=4,
                                          init_scale=12.0)
    pt0 = tps.grid_ref_points(spec).numpy()[None] + (
        p_init if nop == 2 else np.concatenate(
            [p_init, np.zeros_like(p_init)], -1))
    oob = ((pt0 < spec.tmp_lb).any(-1) | (pt0[..., 0] > spec.tmp_ubw)
           | (pt0[..., 1] > spec.tmp_ubh))
    assert 0 < oob.sum() < oob.size
    _assert_tiled_close(ref, ours)
    np.testing.assert_array_equal(ours.p.numpy()[oob], p_init[oob])


def test_gn_tiled_plain_matches_the_pallas_kernel_in_interpret_mode(
        monkeypatch):
    """The twin against `_gn_tiled_pallas` itself (in-kernel templates,
    interpret mode on the CPU), set up as the JAX package's own test of it
    (patch size 8, 8 trips, a 60x120 level forced onto the tiled route)."""
    from jax.experimental import pallas as pl
    params = dataclasses.replace(
        jparams.op_point_params(120, 2), sc_f=0, sc_l=0, max_iter=8,
        min_iter=8, usetvref=False)
    rng = np.random.default_rng(1)
    a, b = _level(0, b=1, h=60, w=120)
    spec = jparams.make_level_spec(0, 120, 60, params)
    pyr = [jpyr.build_pyramid(jnp.asarray(x[0]), 0, params.p_samp_s)
           for x in (a, b)]
    ja = tuple(pyr[0][f][0][None] for f in range(3))
    jb = pyr[1][0][0][None]
    p_init = rng.normal(0, 1.5, (1, spec.nopatches, 2)).astype(np.float32)
    with monkeypatch.context() as m:
        orig = pl.pallas_call
        m.setattr(pl, "pallas_call",
                  lambda *args, **kw: orig(*args, **{"interpret": True,
                                                     **kw}))
        m.setattr(jps, "_use_pallas_bilerp", lambda: True)
        m.setattr(jps, "_pick_gn_bb", lambda *args, **kw: None)
        geom = jps._pick_tile_geom(spec, params, inkernel=True)
        assert geom is not None and geom.ybs > 0
        ref = jps.optimize_level_batched.__wrapped__(
            spec, params, jb, None, jnp.asarray(p_init), src=ja,
            src_exact=True)
    tparams = convert.params_from_reference(dataclasses.asdict(params))
    pt_ref = tps.grid_ref_points(spec).T[None].contiguous()
    p, pw, iters, _ = tps._gn_tiled_plain(
        spec, tparams, torch.as_tensor(np.array(jb)),
        tuple(torch.as_tensor(np.array(x)) for x in ja),
        torch.as_tensor(p_init).transpose(1, 2).contiguous(), pt_ref)
    assert int(iters) == int(ref.iters)
    np.testing.assert_allclose(p.transpose(1, 2).numpy(), np.asarray(ref.p),
                               rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(pw.reshape(1, 8, 8, -1).numpy(),
                               np.asarray(ref.pweight), rtol=1e-3, atol=5e-2)


@pytest.mark.parametrize("nop,noc,min_iter", [(2, 1, 16), (2, 3, 2),
                                              (1, 1, 2)])
def test_epilogue_pweight_equals_the_carried_pweight(nop, noc, min_iter):
    """One extraction at the final position gives, bit for bit, the splat
    weight `_gn_plain` carries from each patch's last active trip — on the
    same templates and the same patch-sum order (`gn_tiled`'s), with
    patches that stop early, reset, or start outside."""
    params = _op3_level_params(nop=nop, noc=noc, min_iter=min_iter)
    spec, tparams, _, _, ta, tb = _setup(params, seed=2)
    tpl = tps._tiled_templates(spec, tparams, ta)
    rng = np.random.default_rng(3)
    p0 = torch.as_tensor((rng.standard_normal((2, nop, spec.nopatches)) * 6
                          ).astype(np.float32))
    pt_ref = tps.grid_ref_points(spec).T[None].contiguous()
    carried = tps._gn_plain(spec, tparams, tb, tpl, p0, pt_ref,
                            patch_sum=tps._column_sum)
    tiled = tps._gn_tiled_plain(spec, tparams, tb, ta, p0, pt_ref)
    for c, t in zip(carried, tiled):
        assert torch.equal(c, t)
    assert int(carried[3].min()) < int(carried[3].max())


def test_tiled_templates_match_extract_templates():
    """The kernel-order template mean and Hessian against
    `extract_templates` (1e-5 relative: another float32 sum order); the
    gathers themselves are the same bits."""
    for nop, noc in ((2, 1), (1, 3)):
        params = _op3_level_params(nop=nop, noc=noc)
        spec, tparams, _, _, ta, _ = _setup(params)
        a = tps.extract_templates(spec, tparams, *ta)
        b = tps._tiled_templates(spec, tparams, ta)
        assert torch.equal(a.tdx, b.tdx)
        if nop == 2:
            assert torch.equal(a.tdy, b.tdy)
        _scaled_close(b.tmpl.numpy(), a.tmpl.numpy(), 1e-5)
        _scaled_close(b.hes.numpy(), a.hes.numpy(), 1e-5)


def test_integer_starts_beyond_128_anchor_as_jax(monkeypatch):
    """On a 320 px wide level, integer start positions on both sides of 128
    and 256 px: `pt + 1e-5` keeps the 1e-5 below 256 px in float32 and
    loses it from there on, which moves the bilinear anchor by one pixel.
    With zero residuals, no mean-normalisation and no trips, pweight is
    max(|im_b[anchor] - im_a[grid]|, 2) exactly, so the anchors of the port
    and of the JAX package can be held equal to the bit."""
    params = dataclasses.replace(jparams.op_point_params(320, 2), sc_f=0,
                                 sc_l=0, patnorm=0, max_iter=0, min_iter=0)
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (1, 1, 24, 320)).astype(np.uint8)
    b = rng.integers(0, 256, (1, 1, 24, 320)).astype(np.uint8)
    spec = jparams.make_level_spec(0, 320, 24, params)
    pyr = [jpyr.build_pyramid(jnp.asarray(x[0]), 0, params.p_samp_s)
           for x in (a, b)]
    ja = tuple(pyr[0][f][0][None] for f in range(3))
    jb = pyr[1][0][0][None]
    grid = np.asarray(jps.grid_ref_points(spec))
    assert grid[:, 0].min() < 128 < 256 < grid[:, 0].max()
    p_init = np.zeros((1, spec.nopatches, 2), np.float32)
    p_init[0, :, 0] = rng.integers(-3, 4, spec.nopatches)
    p_init[0, :, 1] = rng.integers(-2, 3, spec.nopatches)
    ref = jps.optimize_level_batched(spec, params, jb, None,
                                     jnp.asarray(p_init), src=ja)
    tparams = convert.params_from_reference(dataclasses.asdict(params))
    monkeypatch.setattr(tps, "TILED_MIN_PATCHES", 0)
    ours = tps.optimize_level_batched(
        spec, tparams, torch.as_tensor(np.array(jb)), None,
        torch.as_tensor(p_init),
        src=tuple(torch.as_tensor(np.array(x)) for x in ja))
    np.testing.assert_array_equal(ours.pweight.numpy(),
                                  np.asarray(ref.pweight))
    # the anchor does move: an integer position below 256 px reads the
    # pixel at that position, one from 256 px on reads its left neighbour
    tb = np.array(jb)[0, 0]
    pad, half = spec.pad, params.p_samp_s // 2
    pw = ours.pweight.numpy()[0]
    inb = ((grid + p_init[0] >= spec.tmp_lb).all(-1)
           & (grid[:, 0] + p_init[0, :, 0] <= spec.tmp_ubw)
           & (grid[:, 1] + p_init[0, :, 1] <= spec.tmp_ubh))
    seen = set()
    for n in np.flatnonzero(inb):
        x, y = (grid[n] + p_init[0, n]).astype(int)
        gx, gy = grid[n].astype(int)
        left = int(x >= 256)
        up = int(y >= 256)
        want = max(abs(float(tb[y + pad - half - up, x + pad - half - left])
                       - float(np.array(ja[0])[0, 0, gy + pad - half,
                                                  gx + pad - half])), 2.0)
        assert pw[0, 0, n] == want
        seen.add(left)
    assert seen == {0, 1}


@pytest.mark.parametrize("op,w,h,levels", [
    (3, 1024, 448, {5: False, 4: False, 3: True, 2: True, 1: True}),
    (4, 1024, 448, {5: False, 4: False, 3: True, 2: True, 1: True,
                    0: True}),
    (2, 1024, 448, {5: False, 4: False, 3: False}),
    (1, 1024, 448, {5: False, 4: False, 3: False}),
    (3, 192, 160, {2: False, 1: True, 0: True}),
    (4, 192, 160, {2: False, 1: True, 0: True}),
    (2, 192, 160, {3: False, 2: False, 1: False})])
def test_large_level_routing_rule(op, w, h, levels):
    """Which levels go to `gn_tiled`: op-3/4's levels 3, 2, 1, 0 at 1024x436
    (817 / 3,268 / 12,825 / 51,300 patches) and the two finest levels of
    the 192x160 goldens (864, 3,456); every level of op-1/op-2 (at most 448
    and 480 patches) stays on `gn_fused`."""
    from of_dis_tpu_torch.params import make_level_spec, op_point_params
    params = op_point_params(w, op)
    assert sorted(levels) == list(range(params.sc_l, params.sc_f + 1))
    for sl, tiled in levels.items():
        spec = make_level_spec(sl, w, h, params)
        assert tps.uses_tiled(spec) is tiled, (sl, spec.nopatches)
    if op >= 3 and w == 1024:
        counts = [make_level_spec(sl, w, h, params).nopatches
                  for sl in (2, 1, 0)]
        assert counts == [3268, 12825, 51300]


def test_optimize_level_needs_templates_or_source():
    params = jparams.op_point_params(48, 2)
    spec, tparams, _, _, ta, tb = _setup(params)
    p0 = torch.zeros((2, spec.nopatches, 2))
    with pytest.raises(ValueError, match="tpl or src"):
        tps.optimize_level_batched(spec, tparams, tb, None, p0)
    # a small level with src alone extracts its templates and takes the
    # route of `gn_fused`
    assert not tps.uses_tiled(spec)
    a = tps.optimize_level_batched(spec, tparams, tb, None, p0, src=ta)
    b = tps.optimize_level_batched(
        spec, tparams, tb, tps.extract_templates(spec, tparams, *ta), p0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ------------ the unfused route: `gn_unfused` and the extraction kernel's twin
#
# Tolerances: an extraction within 1e-4 on the 0-255 scale — three float32
# lerps against the JAX package's one-hot sums of the same terms (a few
# ulps at 255); the route as the other GN routes against JAX (`iters`
# equal, `p` 1e-3 px, `pweight` 1e-4 of the level's largest weight).

def _extract_inputs(psz, noc, seed):
    """Integer-valued padded planes (2, noc, Hp, Wp) of a 40x48 level and
    positions that cover the interior, both validity borders (tmp_lb and
    tmp_ub, where the window ends on the padding's last row and column)
    and whole-pixel positions."""
    rng = np.random.default_rng(seed)
    h, w = 40, 48
    im = rng.integers(0, 256, (2, noc, h + 2 * psz, w + 2 * psz)).astype(
        np.float32)
    n = 37                                   # ragged on purpose
    pts = np.stack([rng.uniform(-psz / 2, w + psz // 2 - 2, (2, n)),
                    rng.uniform(-psz / 2, h + psz // 2 - 2, (2, n))], -1)
    pts[:, 0] = (-psz / 2, -psz / 2)
    pts[:, 1] = (w + psz // 2 - 2, h + psz // 2 - 2)
    pts[:, 2:8] = np.rint(pts[:, 2:8])
    return im, pts.astype(np.float32), h + 2 * psz, w + 2 * psz


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas"])
@pytest.mark.parametrize("psz,noc", [(16, 1), (16, 3), (12, 1), (8, 3),
                                     (5, 1)])
def test_bilerp_extract_matches_jax(monkeypatch, psz, noc, pallas):
    """The extraction wrapper (its plain twin, on CPU tensors) against the
    JAX package's `extract_bilinear_mxu_batched`: through its plain
    row-select (`_bilerp_select_pure`) and through the Pallas kernel
    `_bilerp_select_pallas` itself in interpret mode."""
    import jax
    from jax.experimental import pallas as pl
    from of_dis_tpu_torch.kernels import bilerp_extract
    im, pts, hp, wp = _extract_inputs(psz, noc, psz + noc)
    planes = jax.vmap(lambda x: jps._shifted_planes(x, psz))(jnp.asarray(im))
    with monkeypatch.context() as m:
        orig = pl.pallas_call
        m.setattr(pl, "pallas_call",
                  lambda *args, **kw: orig(*args, **{"interpret": True,
                                                     **kw}))
        if pallas:
            assert jps._bilerp_block(2, psz + 1, noc, hp, pts.shape[1])
        ref = jps.extract_bilinear_mxu_batched(planes, jnp.asarray(pts), psz,
                                               psz, noc, hp, wp, pallas)
    before = trace.launches("bilerp_extract")
    ours = bilerp_extract.bilerp_extract(torch.as_tensor(im),
                                         torch.as_tensor(pts), psz, psz)
    assert trace.launches("bilerp_extract") == before  # CPU: the twin
    assert ours.shape == (2, psz * psz * noc, pts.shape[1])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    # whole-pixel positions read single pixels: exact
    np.testing.assert_array_equal(ours.numpy()[:, :, 2:8],
                                  np.asarray(ref)[:, :, 2:8])


def _psz16_level_params(**changes):
    """op-3's settings at patch size 16 (grid step 4), one level."""
    return dataclasses.replace(jparams.op_point_params(48, 3), sc_f=0,
                               sc_l=0, p_samp_s=16, **changes)


@pytest.mark.parametrize("nop,noc,camlr,costfct,init_scale", [
    (2, 1, 0, 0, 1.0), (2, 1, 0, 1, 1.0), (2, 1, 0, 2, 1.0),
    (2, 3, 0, 0, 1.0), (1, 1, 0, 0, 1.0), (1, 1, 1, 0, 3.0),
    (1, 3, 0, 2, 1.0), (2, 1, 0, 0, 14.0)])
def test_unfused_route_matches_jax(monkeypatch, nop, noc, camlr, costfct,
                                   init_scale):
    """A level of 16x16 patches through `optimize_level_batched`: neither
    GN kernel's wrapper is called, the extraction wrapper once at the start
    and once per trip, and the result follows the JAX package's."""
    from of_dis_tpu_torch.kernels import bilerp_extract
    params = _psz16_level_params(nop=nop, noc=noc, costfct=costfct)
    assert tps.uses_unfused(params) and params.steps == 4
    shift = (1.6, -0.7) if nop == 2 else \
        ((-1.6, 0.0) if camlr == 0 else (1.6, 0.0))
    spec, tparams, ja, jb, ta, tb = _setup(params, seed=nop + noc + costfct,
                                           camlr=camlr, shift=shift)
    rng = np.random.default_rng(17)
    p_init = (rng.standard_normal((2, spec.nopatches, nop)) * init_scale
              ).astype(np.float32)
    ref = jps.optimize_level_batched(spec, params, jb, None,
                                     jnp.asarray(p_init), src=tuple(ja))
    calls = []
    for mod, name in ((tps.gn_fused, "gn_fused"), (tps.gn_tiled, "gn_tiled")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name: calls.append(_n))
    extract = bilerp_extract.bilerp_extract
    monkeypatch.setattr(
        bilerp_extract, "bilerp_extract",
        lambda *a: (calls.append("extract"), extract(*a))[1])
    monkeypatch.setattr(tps, "TILED_MIN_PATCHES", 0)   # size does not matter
    ours = tps.optimize_level_batched(spec, tparams, tb, None,
                                      torch.as_tensor(p_init), src=tuple(ta))
    assert calls == ["extract"] * (1 + int(ours.iters))
    _assert_gn_close(ref, ours)
    assert ours.pweight.shape == (2, 16, 16, spec.nopatches)
    if init_scale > 10:
        assert (ours.p.numpy() == p_init).any()        # starts outside stay


@pytest.mark.parametrize("psz,unfused", [(4, False), (8, False), (12, False),
                                         (13, True), (16, True)])
def test_unfused_routing_rule(psz, unfused):
    """Patches of more than 160 pixels (a side above 12) go to the unfused
    route, whatever the level's size; every op-point stays on the fused
    kernels."""
    from of_dis_tpu_torch.params import op_point_params
    assert tps.uses_unfused(dataclasses.replace(
        op_point_params(1024, 3), p_samp_s=psz)) is unfused
    assert not any(tps.uses_unfused(op_point_params(1024, op))
                   for op in (1, 2, 3, 4))
