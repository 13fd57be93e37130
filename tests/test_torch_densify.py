"""Port's densification, forward and with the backward merge, against the
JAX package.

Tolerance: 1e-5 relative to the field's largest value — the same 0/1
cover (and, for the merge, soft one-hot) contractions, summed in another
float32 order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_dis_tpu import params as jparams
from of_dis_tpu.ops import densify as jd
from of_dis_tpu.ops import patch_solver as jps
from of_dis_tpu_torch import convert
from of_dis_tpu_torch.ops import densify as td
from of_dis_tpu_torch.ops import patch_solver as tps
from of_dis_tpu_torch.params import make_level_spec


@pytest.mark.parametrize("op,level,size", [(2, 1, (96, 80)), (1, 0, (40, 56)),
                                           (3, 0, (48, 36))])
def test_aggregate_flow_dense_matches_jax(op, level, size):
    params = jparams.op_point_params(size[0], op)
    spec = jparams.make_level_spec(level, size[0], size[1], params)
    rng = np.random.default_rng(op)
    b, n, psz = 2, spec.nopatches, params.p_samp_s
    p = rng.standard_normal((b, n, 2)).astype(np.float32) * 3
    pw = (2.0 + rng.random((b, psz, psz, n)) * 30).astype(np.float32)
    pt = np.zeros((b, n, 2), np.float32)
    ref = jax.vmap(lambda p_, pt_, pw_: jd.aggregate_flow_dense(
        spec, params, jps.PatchResult(p_, pt_, pw_, jnp.int32(0))))(
        jnp.asarray(p), jnp.asarray(pt), jnp.asarray(pw))
    tparams = convert.params_from_reference(dataclasses.asdict(params))
    tspec = make_level_spec(level, size[0], size[1], tparams)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(spec)
    ours = td.aggregate_flow_dense(
        tspec, tparams,
        convert.tensors_from_numpy(tps.PatchResult, p, pt, pw, np.int32(0)))
    ref = np.asarray(ref)
    assert ours.shape == ref.shape == (b, spec.height, spec.width, 2)
    np.testing.assert_allclose(ours.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("level,size", [(1, (96, 80)), (0, (40, 56))])
def test_aggregate_flow_dense_depth_matches_jax(level, size):
    """nop=1: one parameter per patch, dense result (B, H, W, 1)."""
    params = jparams.op_point_params(size[0], 2, nop=1)
    spec = jparams.make_level_spec(level, size[0], size[1], params)
    rng = np.random.default_rng(level)
    b, n, psz = 2, spec.nopatches, params.p_samp_s
    p = -np.abs(rng.standard_normal((b, n, 1))).astype(np.float32) * 3
    pw = (2.0 + rng.random((b, psz, psz, n)) * 30).astype(np.float32)
    pt = np.zeros((b, n, 2), np.float32)
    ref = np.asarray(jax.vmap(lambda p_, pt_, pw_: jd.aggregate_flow_dense(
        spec, params, jps.PatchResult(p_, pt_, pw_, jnp.int32(0))))(
        jnp.asarray(p), jnp.asarray(pt), jnp.asarray(pw)))
    tparams = convert.params_from_reference(dataclasses.asdict(params))
    ours = td.aggregate_flow_dense(
        make_level_spec(level, size[0], size[1], tparams), tparams,
        convert.tensors_from_numpy(tps.PatchResult, p, pt, pw, np.int32(0)))
    assert ours.shape == ref.shape == (b, spec.height, spec.width, 1)
    np.testing.assert_allclose(ours.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_cover_tables_match_jax():
    params = dataclasses.replace(jparams.op_point_params(1024, 2))
    spec = jparams.make_level_spec(3, 1024, 448, params)
    for args in ((spec.height, spec.noph, spec.offseth, spec.steps, 8),
                 (spec.width, spec.nopw, spec.offsetw, spec.steps, 8)):
        np.testing.assert_array_equal(td._cover_matrix(*args),
                                      jd._cover_matrix(*args))


# ------------------------------------------- backward merge (usefbcon)

def _merge_case(nop, level, size, seed, border=False):
    """Forward and complementary patch results of one level as numpy: the
    complementary patches sit at grid + displacement, a few of them on and
    just outside the validity border (1 <= x < W-1, 1 <= y < H-1) when
    `border`."""
    params = jparams.op_point_params(size[0], 2, nop=nop)
    spec = jparams.make_level_spec(level, size[0], size[1], params)
    rng = np.random.default_rng(seed)
    b, n, psz = 2, spec.nopatches, params.p_samp_s
    grid = np.asarray(jps.grid_ref_points(spec))                # (N, 2)

    def one():
        p = rng.standard_normal((b, n, nop)).astype(np.float32) * 3
        pw = (2.0 + rng.random((b, psz, psz, n)) * 30).astype(np.float32)
        move = p if nop == 2 else np.concatenate([p, np.zeros_like(p)], -1)
        return p, (grid[None] + move).astype(np.float32), pw

    fw, bw = one(), one()
    if border:
        h, w = spec.height, spec.width
        # footprint rows / columns straddle the border: integer positions
        # (zero residual), half-pixel ones, and far outside
        spots = [(psz / 2, psz / 2), (psz / 2 + 1, psz / 2 + 0.5),
                 (w - psz / 2, h - psz / 2), (w - psz / 2 - 1.5, h - 1.0),
                 (0.0, 0.0), (-3.25, 2.0), (w + 5.0, h + 5.0),
                 (1.0, h - 2.0)]
        for k, (x, y) in enumerate(spots):
            bw[1][:, k * 3] = (x, y)
    return params, spec, fw, bw


def _merge_both(params, spec, fw, bw):
    ref = np.asarray(jax.vmap(
        lambda p, pt, pw, cp, cpt, cpw: jd.aggregate_flow_dense(
            spec, params, jps.PatchResult(p, pt, pw, jnp.int32(0)),
            compl_res=jps.PatchResult(cp, cpt, cpw, jnp.int32(0))))(
        *(jnp.asarray(x) for x in fw + bw)))
    tparams = convert.params_from_reference(dataclasses.asdict(params))
    tspec = make_level_spec(spec.level, spec.width * 2 ** spec.level,
                            spec.height * 2 ** spec.level, tparams)
    assert dataclasses.asdict(tspec) == dataclasses.asdict(spec)
    args = (tspec, tparams,
            convert.tensors_from_numpy(tps.PatchResult, *fw, np.int32(0)),
            convert.tensors_from_numpy(tps.PatchResult, *bw, np.int32(0)))
    ours, none = td.merge_flows(*args)
    assert none is None
    return ref, ours, args


@pytest.mark.parametrize("nop,level,size,border", [
    (2, 1, (96, 80), False), (2, 0, (40, 56), True),
    (1, 1, (96, 80), False), (1, 0, (40, 56), True)])
def test_backward_merge_matches_jax(nop, level, size, border):
    """`merge_flows` with the complementary grid's results, flow
    and depth: 1e-5 relative to the field's largest value, as the forward
    path (the same soft one-hot contractions, summed in another float32
    order), also with patches on and just outside the validity border."""
    ref, ours, _ = _merge_both(*_merge_case(nop, level, size, 7 + nop,
                                            border))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_backward_merge_changes_the_result_and_is_repeatable():
    params, spec, fw, bw = _merge_case(2, 1, (96, 80), 3)
    _, merged, args = _merge_both(params, spec, fw, bw)
    forward = td.aggregate_flow_dense(*args[:3])
    assert float((merged - forward).abs().max()) > 0.1
    assert torch.equal(merged, td.merge_flows(*args)[0])


def test_backward_merge_chunks_give_the_unchunked_sums(monkeypatch):
    """More patches than one chunk holds: the chunked merge adds the same
    per-patch terms (1e-6 relative: partial sums in another order)."""
    params, spec, fw, bw = _merge_case(2, 1, (96, 80), 5)
    _, whole, args = _merge_both(params, spec, fw, bw)
    n, psz = spec.nopatches, params.p_samp_s
    assert td._merge_chunk(n, psz, spec.height, spec.width) == n
    monkeypatch.setattr(td, "_MERGE_CHUNK_BYTES",
                        4 * psz * (spec.height + 2 * spec.width) * 100)
    assert td._merge_chunk(n, psz, spec.height, spec.width) == 100 < n
    chunked = td.merge_flows(*args)[0]
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(),
                               atol=1e-6 * float(whole.abs().max()), rtol=0)


@pytest.mark.parametrize("nop", [2, 1])
def test_merge_flows_both_directions_equal_each_alone(nop):
    """With the backward grid's level given, `merge_flows` makes both
    flows in one pass; each equals its direction merged alone, bit for
    bit (the same sums, the same splats)."""
    params, spec, fw, bw = _merge_case(nop, 1, (96, 80), 11 + nop, True)
    _, _, (tspec, tparams, res, res_bw) = _merge_both(params, spec, fw, bw)
    tspec_bw = dataclasses.replace(tspec, camlr=1)
    flow, flow_bw = td.merge_flows(tspec, tparams, res, res_bw, tspec_bw)
    assert torch.equal(flow, td.merge_flows(tspec, tparams, res, res_bw)[0])
    alone_bw, _ = td.merge_flows(tspec_bw, tparams, res_bw, res)
    assert torch.equal(flow_bw, alone_bw)
    assert float((flow_bw - flow).abs().max()) > 0.1
