"""Port's end-to-end model at op-3 / op-4 and with the forward-backward
merge, against the JAX package (the goldens of these modes through the
port's CLI are in tests/test_torch_goldens_op34.py).

Tolerance: dis_flow_batched on the 192x160 goldens' inputs: EPE ratio
<= 1e-3 against JAX, as at op-2 (float32 sums in another order, exact
float32 extraction where the JAX CPU path reads bf16 hi/lo planes); one
case states a wider budget with its reason."""

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
from of_dis_tpu_torch.models import dis as tdis

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


@pytest.mark.parametrize("nop,what,budget", [
    (2, "op3", 1e-3), (2, "fbcon", 1e-3), (1, "op3", 3e-3),
    (1, "fbcon", 1e-3)])
def test_dis_flow_batched_op3_and_fbcon_match_jax(nop, what, budget):
    """op-3 (patch size 12, grid step 3, the two finest levels on the
    large-level GN route) and the forward-backward merge at op-2's settings, flow and
    depth, against the JAX package on the 192x160 goldens' inputs: EPE
    ratio <= 1e-3, as the other modes. Depth at op-3 gets 3e-3: the stereo
    pair is shifted by whole pixels, so at full resolution converged
    patches sit on the boundary between two bilinear anchors
    (ceil(pt + 1e-5)), where one float32 ulp of the sum order decides the
    cell: 123 of the finest level's 3,456 patches settle one pixel apart
    from JAX's (the two coarser levels agree to 1e-5 px), measured 1.6e-3."""
    f1, f2 = (jio.load_image(os.path.join(G, f)).astype(np.uint8)
              for f in (("a.png", "b.png") if nop == 2
                        else ("a.png", "bs.png")))
    a, b = f1[None], f2[None]
    jp = j_op_point_params(192, 3 if what == "op3" else 2, nop=nop)
    if what == "fbcon":
        jp = dataclasses.replace(jp, usefbcon=True)
    tp = convert.params_from_reference(dataclasses.asdict(jp))
    ref = np.asarray(jdis.dis_flow_batched(jnp.asarray(a), jnp.asarray(b),
                                           jp, 192, 160))
    ours = tdis.dis_flow_batched(a, b, tp, 192, 160, device="cpu").numpy()
    assert ours.shape == ref.shape == (1, 160, 192, nop)
    assert _epe_ratio(ours[0], ref[0]) <= budget
    if what == "fbcon":
        # the merge is part of the result, not a no-op
        plain = tdis.dis_flow_batched(
            a, b, dataclasses.replace(tp, usefbcon=False), 192, 160,
            device="cpu").numpy()
        assert _epe_ratio(plain[0], ref[0]) > 1e-3


def _half_pixel_stereo():
    """The goldens' first frame and a second view of it 2.5 px to the left
    (the mean of the 2 px and 3 px shifts, rounded to u8): a disparity of
    -2.5 px for the left camera, off the whole-pixel grid at every level."""
    a = jio.load_image(os.path.join(G, "a.png")).astype(np.float32)
    b = (np.roll(a, -2, axis=-1) + np.roll(a, -3, axis=-1)) / 2
    return a.astype(np.uint8)[None], np.rint(b).astype(np.uint8)[None]


def test_depth_op3_on_a_half_pixel_stereo_pair_matches_jax():
    """Depth at op-3 against JAX within the 1e-3 of the other modes once
    the stereo shift is not a whole number of pixels: converged patches
    then lie inside a bilinear cell, not on the boundary between two
    anchors, and no ulp of the sum order can move them to the next cell
    (the whole-pixel pair of the case above needs 3e-3)."""
    a, b = _half_pixel_stereo()
    jp = j_op_point_params(192, 3, nop=1)
    tp = convert.params_from_reference(dataclasses.asdict(jp))
    ref = np.asarray(jdis.dis_flow_batched(jnp.asarray(a), jnp.asarray(b),
                                           jp, 192, 160))
    ours = tdis.dis_flow_batched(a, b, tp, 192, 160, device="cpu").numpy()
    assert ours.shape == ref.shape == (1, 160, 192, 1)
    # the pair does carry the disparity it was built with
    assert abs(float(np.median(ref[0, 20:-20, 20:-20])) + 2.5) < 0.1
    assert _epe_ratio(ours[0], ref[0]) <= 1e-3


@pytest.mark.parametrize("nop", [2, 1])
def test_dis_flow_batched_patch_size_16_matches_jax(nop):
    """The 20-parameter form at patch size 16 (levels 2..1, 16 trips,
    overlap 0.75, TV on): every level takes the unfused GN route, and the
    result follows the JAX package's to an EPE ratio of 1e-3."""
    from of_dis_tpu_torch.kernels import bilerp_extract
    from of_dis_tpu_torch.ops import patch_solver
    rest = "2 1 16 16 0.05 0.95 0 16 0.75 0 1 0 1 10 10 5 1 3 1.6 0".split()
    tp = cli.build_params(192, nop, 1, rest)
    assert patch_solver.uses_unfused(tp)
    jp = j_op_point_params(192, 3, nop=nop)
    jp = dataclasses.replace(jp, **{f.name: getattr(tp, f.name)
                                    for f in dataclasses.fields(tp)
                                    if hasattr(jp, f.name)})
    assert (jp.p_samp_s, jp.sc_f, jp.sc_l, jp.max_iter) == (16, 2, 1, 16)
    f1, f2 = (jio.load_image(os.path.join(G, f)).astype(np.uint8)
              for f in (("a.png", "b.png") if nop == 2
                        else ("a.png", "bs.png")))
    a, b = f1[None], f2[None]
    ref = np.asarray(jdis.dis_flow_batched(jnp.asarray(a), jnp.asarray(b),
                                           jp, 192, 160))
    before = bilerp_extract.launches
    ours = tdis.dis_flow_batched(a, b, tp, 192, 160, device="cpu").numpy()
    assert bilerp_extract.launches == before           # CPU: no launch
    assert ours.shape == ref.shape == (1, 160, 192, nop)
    assert _epe_ratio(ours[0], ref[0]) <= 1e-3


def test_fbcon_runs_through_every_entry_and_repeats():
    a, b = _pairs()
    p = dataclasses.replace(convert.params_from_reference(
        dataclasses.asdict(j_op_point_params(192, 2))), usefbcon=True)
    batched = tdis.dis_flow_batched(a[:1], b[:1], p, 192, 160, device="cpu")
    again = tdis.dis_flow_batched(a[:1], b[:1], p, 192, 160, device="cpu")
    assert torch.equal(batched, again)
    full = tdis.dis_flow_full(a[0], b[0], p, 192, 160, device="cpu")
    np.testing.assert_array_equal(full.numpy(), batched[0].numpy())


def test_large_levels_take_the_tiled_route_in_the_model(monkeypatch):
    """At op-3 on a 192x160 pair the two finest levels (864 and 3,456
    patches) go to `gn_tiled`, the coarsest (224) to `gn_fused`; with fbcon
    both grids do."""
    from of_dis_tpu_torch.kernels import gn_fused, gn_tiled
    a, b = _pairs()
    p = dataclasses.replace(convert.params_from_reference(
        dataclasses.asdict(j_op_point_params(192, 3))), usefbcon=True,
        max_iter=2, min_iter=2)
    seen = []
    for mod, name in ((gn_fused, "gn_fused"), (gn_tiled, "gn_tiled")):
        fn = getattr(mod, name)
        monkeypatch.setattr(
            mod, name, lambda spec, *args, _fn=fn, _n=name:
            (seen.append((_n, spec.level, spec.camlr)), _fn(spec, *args))[1])
    tdis.dis_flow_batched(a[:1], b[:1], p, 192, 160, device="cpu")
    assert seen == [("gn_fused", 2, 0), ("gn_fused", 2, 1),
                    ("gn_tiled", 1, 0), ("gn_tiled", 1, 1),
                    ("gn_tiled", 0, 0), ("gn_tiled", 0, 1)]
