"""Port's forward densification against the JAX package.

Tolerance: 1e-5 relative to the field's largest value — the same 0/1
cover contractions, summed in another float32 order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
