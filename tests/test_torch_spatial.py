"""Row-sharded TV refinement (`of_dis_tpu_torch.parallel.spatial`) on CPU
device lists: the nine cases of the JAX package's tests/test_spatial.py at
their shapes or smaller, each split equal to the port's unsharded level
bit for bit and held against the JAX package's unsharded counterpart; one
small split against the JAX package's own row-sharded function; and the
route, its refusals and the K3 row origin's twin.

Tolerances, each with its reason:
  - the split against the port's unsharded level: equal (`torch.equal`):
    a block padded only toward real neighbours runs the stock loop, whose
    interior rows see exactly the unsharded operations;
  - against JAX's `ops.tv.ref_level_of` / `ref_level_de`: 1e-4 px, the
    level loop's budget of tests/test_torch_tv.py (float32 rounding in
    the dependent sweeps);
  - against JAX's `spatial.tv_refine_spatial`: 3e-4 px (its own 2e-4
    against the unsharded kernel, plus the port's 1e-4);
  - end to end against JAX's `_dis_flow_core` / `dis_flow_batched`: an
    EPE ratio of 1e-3, the port's budget (tests/test_torch_mesh.py), on
    u8 frames for the reason given there."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from of_dis_tpu.models import dis as jdis
from of_dis_tpu.ops import tv as jtv
from of_dis_tpu.parallel import spatial as jspatial
from of_dis_tpu.params import DISParams as JaxParams
from of_dis_tpu.params import with_spatial_tv as j_with_spatial_tv
from of_dis_tpu_torch import convert
from of_dis_tpu_torch.kernels import tv_of_inner
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import tv
from of_dis_tpu_torch.parallel import spatial
from of_dis_tpu_torch.parallel.mesh import make_mesh
from of_dis_tpu_torch.params import (DISParams, make_level_spec,
                                     with_spatial_tv)

KW = dict(alpha=10.0, gamma=10.0, delta=5.0, n_inner=1, n_solver=3,
          omega=1.6)
LEVEL_TOL = 1e-4
JAX_EPE_RATIO = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes run one torch thread (see tests/test_torch_mesh.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _level(b, h, w, seed, noc=1, scale=1.5):
    """Random level images (B, C, H, W) in [0, 255) and a flow (B, H, W, 2)
    of standard deviation `scale` px, float32."""
    rng = np.random.default_rng(seed)
    im1 = (rng.random((b, noc, h, w)) * 255).astype(np.float32)
    im2 = (rng.random((b, noc, h, w)) * 255).astype(np.float32)
    flow = (rng.standard_normal((b, h, w, 2)) * scale).astype(np.float32)
    return im1, im2, flow


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _unsharded_of(flow, im1, im2, **kw):
    u, v = tv.ref_level_of_batched(flow[..., 0].contiguous(),
                                   flow[..., 1].contiguous(), im1, im2, **kw)
    return torch.stack([u, v], dim=-1)


def _check_of(n, h, w, seed, b=1, **kw):
    """Flow split over n CPU devices: equal to the port's unsharded level,
    and within LEVEL_TOL of JAX's ref_level_of on every pair."""
    kw = dict(KW, **kw)
    im1, im2, flow = _level(b, h, w, seed)
    got = spatial.tv_refine_spatial(make_mesh(["cpu"] * n), *_t(flow, im1,
                                                                 im2), **kw)
    assert torch.equal(got, _unsharded_of(*_t(flow, im1, im2), **kw))
    for k in range(b):
        ru, rv = jtv.ref_level_of(*map(jnp.asarray, (
            flow[k, ..., 0], flow[k, ..., 1], im1[k], im2[k])), **kw)
        np.testing.assert_allclose(got[k].numpy(), np.stack(
            [np.asarray(ru), np.asarray(rv)], -1), atol=LEVEL_TOL, rtol=0)
    return got


def _check_de(n, h, w, seed, camlr, noc=1):
    """Depth split over n CPU devices: equal to the port's unsharded
    level, within LEVEL_TOL of JAX's ref_level_de."""
    im1, im2, flow = _level(1, h, w, seed, noc=noc)
    sign = -1.0 if camlr == 0 else 1.0
    wx = (sign * np.abs(flow[0, ..., 0])).astype(np.float32)
    got = spatial.tv_refine_spatial_de(make_mesh(["cpu"] * n),
                                       *_t(wx, im1[0], im2[0]), camlr=camlr,
                                       **KW)
    want = tv.ref_level_de_batched(*_t(wx[None], im1, im2), camlr=camlr,
                                   **KW)[0]
    assert torch.equal(got, want)
    ref = jtv.ref_level_de(*map(jnp.asarray, (wx, im1[0], im2[0])),
                           camlr=camlr, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LEVEL_TOL,
                               rtol=0)


# ---------------------------------------- the cases of tests/test_spatial.py

def test_spatial_tv_matches_unsharded():
    # 8 shards of 20 rows; halo depth 4 + 1 * (2 + 6) = 12 <= 20
    _check_of(8, 160, 96, seed=0)


def test_spatial_tv_multi_inner():
    """A deeper loop, a larger halo: 4 + 3 * 8 = 28 <= 32."""
    _check_of(4, 128, 64, seed=1, n_inner=3)


def test_spatial_tv_odd_shard_heights():
    """152 / 8 = 19 rows a shard: shards 1, 3, 5 and 7 start on odd global
    rows and run at row parity 1. Flow and depth."""
    _check_of(8, 152, 96, seed=4)
    _check_de(8, 152, 96, seed=4, camlr=0)


def test_spatial_tv_2d_mesh_pairs_x_rows():
    """The 2-D form: 4 pairs over 2 row meshes of 4 devices (2 pairs a
    mesh, 32 rows a shard), each pair equal to the unsharded level and
    within LEVEL_TOL of JAX's."""
    im1, im2, flow = _level(4, 128, 64, seed=3)
    meshes = (make_mesh(["cpu"] * 4), make_mesh(["cpu"] * 4))
    got = spatial.tv_refine_spatial_batched(meshes, *_t(flow, im1, im2),
                                            **KW)
    assert tuple(got.shape) == (4, 128, 64, 2)
    assert torch.equal(got, _unsharded_of(*_t(flow, im1, im2), **KW))
    ru, rv = jtv.ref_level_of_batched(*map(jnp.asarray, (
        flow[..., 0], flow[..., 1], im1, im2)), **KW)
    np.testing.assert_allclose(got.numpy(), np.stack(
        [np.asarray(ru), np.asarray(rv)], -1), atol=LEVEL_TOL, rtol=0)
    with pytest.raises(ValueError, match="one size"):
        spatial.tv_refine_spatial_batched(
            (make_mesh(["cpu"] * 4), make_mesh(["cpu"] * 2)),
            *_t(flow, im1, im2), **KW)


def _frames(b, h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (b, 1, h, w)).astype(np.uint8),
            rng.integers(0, 256, (b, 1, h, w)).astype(np.uint8))


def _epe_ratio(ours, ref):
    return float(np.linalg.norm(ours - ref, axis=-1).mean()
                 / np.linalg.norm(ref, axis=-1).mean())


@pytest.mark.parametrize("nop", [2, 1], ids=["flow", "depth"])
def test_model_level_spatial_tv_dispatch(nop, monkeypatch):
    """The model routes its finest level (L0, 128x256) over 8 CPU devices
    and not L1 (64x128): the threshold lies between their working sets.
    The routed core equals the unrouted one bit for bit and follows JAX's
    unrouted core. (tests/test_spatial.py's flow and depth dispatch
    cases.)"""
    h, w = 128, 256
    base = dict(sc_f=1, sc_l=0, max_iter=4, min_iter=4, p_samp_s=8,
                patove=0.4, noc=1, nop=nop, usetvref=True)
    params = DISParams(**base)
    a, b = _frames(1, h, w, seed=nop)
    want = dis._dis_flow_core(*_t(a, b), params, w, h)
    mesh = make_mesh(["cpu"] * 8)
    routed = with_spatial_tv(params, mesh, min_bytes=2 << 20)
    assert dis._spatial_tv_route(1, h, w, routed) is mesh
    assert dis._spatial_tv_route(1, h // 2, w // 2, routed) is None
    calls = []
    fn = spatial._split_level
    monkeypatch.setattr(spatial, "_split_level", lambda *args, **kw: (
        calls.append(tuple(args[1][0].shape)), fn(*args, **kw))[1])
    got = dis._dis_flow_core(*_t(a, b), routed, w, h)
    assert calls == [(1, h, w)]                     # L0 only, routed once
    assert torch.equal(got, want)
    # sc_l = 0: the jitted batched entry returns the core's result
    ref = np.asarray(jdis.dis_flow_batched(jnp.asarray(a), jnp.asarray(b),
                                           JaxParams(**base), w, h))
    assert _epe_ratio(got.numpy(), ref) < JAX_EPE_RATIO


def test_model_spatial_tv_dispatch_1080p_level():
    """`_tv_refine` on a level-0 spec of 1080 rows (narrowed to 240
    columns) routed over 8 CPU devices (135 rows a shard: odd heights) and
    over 4 (270): equal to the unrouted level, which follows JAX's."""
    h, w = 1080, 240
    params = DISParams(sc_f=0, sc_l=0, max_iter=1, min_iter=1, p_samp_s=8,
                       patove=0.4, noc=1, nop=2, usetvref=True)
    spec = make_level_spec(0, w, h, params)
    p = spec.pad
    rng = np.random.default_rng(7)
    im_a = (rng.random((1, 1, h + 2 * p, w + 2 * p)) * 255).astype(np.float32)
    im_b = (rng.random((1, 1, h + 2 * p, w + 2 * p)) * 255).astype(np.float32)
    flow = rng.standard_normal((1, h, w, 2)).astype(np.float32)
    want = dis._tv_refine(*_t(flow, im_a, im_b), spec, params)
    for n in (8, 4):
        mesh = make_mesh(["cpu"] * n)
        routed = with_spatial_tv(params, mesh, min_bytes=16 << 20)
        assert dis._spatial_tv_route(1, h, w, routed) is mesh
        assert torch.equal(dis._tv_refine(*_t(flow, im_a, im_b), spec,
                                          routed), want)
    ref = jdis._tv_refine(*map(jnp.asarray, (flow, im_a, im_b)), spec,
                          JaxParams(**{f.name: getattr(params, f.name)
                                       for f in dataclasses.fields(params)}),
                          camlr=0)
    np.testing.assert_allclose(want.numpy(), np.asarray(ref),
                               atol=LEVEL_TOL, rtol=0)


def test_spatial_route_in_params_is_cache_keyed():
    """A routed parameter set is hashable and differs from the unrouted
    one; dis_flow_batched with it equals the unrouted run and JAX's."""
    h, w = 128, 64   # L1 shards 32 rows >= halo depth 20, L0 64 >= 12
    base = dict(sc_f=1, sc_l=0, max_iter=2, min_iter=2, p_samp_s=8,
                patove=0.4, noc=1, nop=2, usetvref=True)
    params = DISParams(**base)
    routed = with_spatial_tv(params, make_mesh(["cpu"] * 2), min_bytes=0)
    assert routed != params and hash(routed) != hash(params)
    assert routed == with_spatial_tv(params, make_mesh(["cpu"] * 2),
                                     min_bytes=0)
    a, b = _frames(1, h, w, seed=0)
    want = dis.dis_flow_batched(a, b, params, w, h, device="cpu")
    got = dis.dis_flow_batched(a, b, routed, w, h, device="cpu")
    assert torch.equal(got, want)
    ref = np.asarray(jdis.dis_flow_batched(jnp.asarray(a), jnp.asarray(b),
                                           JaxParams(**base), w, h))
    assert _epe_ratio(got.numpy(), ref) < JAX_EPE_RATIO


@pytest.mark.parametrize("camlr", [0, 1])
def test_spatial_tv_depth_matches_unsharded(camlr):
    _check_de(8, 160, 96, seed=2, camlr=camlr)


# --------------------------------------------------------- beyond JAX's

def test_against_jax_row_sharded_function():
    """2 shards of a 64x64 flow level against JAX's own
    `spatial.tv_refine_spatial` on 2 of the virtual CPU devices."""
    im1, im2, flow = _level(1, 64, 64, seed=11)
    got = spatial.tv_refine_spatial(make_mesh(["cpu"] * 2),
                                    *_t(flow[0], im1[0], im2[0]), **KW)
    jm = JaxMesh(np.asarray(jax.devices()[:2]), ("rows",))
    # jitted: one compile of the shard body, not an eager op-by-op run
    ref = jax.jit(partial(jspatial.tv_refine_spatial, jm, **KW))(
        *map(jnp.asarray, (flow[0], im1[0], im2[0])))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-4,
                               rtol=0)


def test_rgb_and_batch_split_equal_unsharded():
    """RGB flow and RGB depth, 3 pairs in one launch a shard, 6 shards of
    odd height (21 rows)."""
    im1, im2, flow = _level(3, 126, 40, seed=5, noc=3)
    mesh = make_mesh(["cpu"] * 6)
    got = spatial.tv_refine_spatial(mesh, *_t(flow, im1, im2), **KW)
    assert torch.equal(got, _unsharded_of(*_t(flow, im1, im2), **KW))
    wx = -np.abs(flow[..., 0])
    got = spatial.tv_refine_spatial_de(mesh, *_t(wx, im1, im2), camlr=0,
                                       **KW)
    assert torch.equal(got, tv.ref_level_de_batched(*_t(wx, im1, im2),
                                                    camlr=0, **KW))


def _both_sides_replicated(flow, im1, im2, n, kw):
    """The JAX shard body's padding, d replicated rows outside the image
    too, with the stock loop (neither `_rep` nor `not_last`): a halo row
    outside the image is a replica of the edge row, its warp the edge
    row's (JAX clamps its global row)."""
    h = flow.shape[-3]
    hl = h // n
    d = spatial.halo_depth(kw["n_inner"], kw["n_solver"])
    u, v = flow[..., 0], flow[..., 1]
    w_im2, mask = tv.warp_image(im2, u, v)
    qa, hd3, hg3 = tv.tv_coefficients(kw["alpha"], kw["gamma"], kw["delta"])
    outs = []
    for i in range(n):
        rows = torch.arange(i * hl - d, (i + 1) * hl + d).clamp(0, h - 1)

        def take(x):
            return x.index_select(-2, rows)

        deriv = torch.stack(tv.get_derivatives(take(im1), take(w_im2)), 1)
        uu, vv = tv_of_inner._plain(
            take(u), take(v), take(mask), deriv, quarter_alpha=qa, hd3=hd3,
            hg3=hg3, n_inner=kw["n_inner"], n_solver=kw["n_solver"],
            omega=kw["omega"], row_parity=(i * hl - d) % 2)
        outs.append(torch.stack([uu, vv], -1)[:, d:d + hl])
    return torch.cat(outs, dim=1)


def test_replicated_padding_with_the_stock_loop_is_not_exact():
    """Why a block is padded only toward real neighbours: padding both
    sides with replicated rows, then running the stock loop, is off the
    unsharded level by far more than rounding near the image's top and
    bottom rows (152x96, 8 shards), while the port's split is exact."""
    im1, im2, flow = _level(1, 152, 96, seed=4)
    args = _t(flow, im1, im2)
    want = _unsharded_of(*args, **KW)
    off = (_both_sides_replicated(*args, 8, KW) - want).abs()
    assert float(off.max()) > 0.1
    assert float(off[:, 19:-19].max()) == 0.0      # the inner shards: exact
    assert torch.equal(spatial.tv_refine_spatial(make_mesh(["cpu"] * 8),
                                                 *args, **KW), want)


def test_refusals():
    """Rows that do not divide, and a shard shorter than the halo, raise;
    the route does not take a height that does not divide."""
    im1, im2, flow = _level(1, 60, 32, seed=6)
    args = _t(flow, im1, im2)
    with pytest.raises(ValueError, match="does not divide"):
        spatial.tv_refine_spatial(make_mesh(["cpu"] * 7), *args, **KW)
    # 6 shards of 10 rows < halo depth 12
    with pytest.raises(ValueError, match="halo depth 12 exceeds"):
        spatial.tv_refine_spatial(make_mesh(["cpu"] * 6), *args, **KW)
    # one device: no neighbour, any height
    assert torch.equal(spatial.tv_refine_spatial(make_mesh(["cpu"]), *args,
                                                 **KW),
                       _unsharded_of(*args, **KW))
    routed = with_spatial_tv(DISParams(), make_mesh(["cpu"] * 7),
                             min_bytes=0)
    assert dis._spatial_tv_route(1, 60, 32, routed) is None
    assert dis._spatial_tv_route(1, 63, 32, routed) is routed.spatial_tv_mesh
    assert dis._spatial_tv_route(1, 63, 32, DISParams()) is None


def test_params_from_reference_with_and_without_a_port_mesh():
    jp = j_with_spatial_tv(JaxParams(), JaxMesh(np.asarray(
        jax.devices()[:2]), ("rows",)), min_bytes=123, axis_name="r")
    fields = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)}
    with pytest.raises(ValueError, match="mesh="):
        convert.params_from_reference(fields)
    mesh = make_mesh(["cpu"] * 2)
    tp = convert.params_from_reference(fields, mesh=mesh)
    assert tp.spatial_tv_mesh is mesh
    assert (tp.spatial_tv_min_bytes, tp.spatial_tv_axis) == (123, "r")
    assert tp == with_spatial_tv(DISParams(), mesh, 123, "r")
    plain = dataclasses.asdict(JaxParams())
    assert convert.params_from_reference(plain, mesh=mesh) == DISParams()


def test_warp_row_origin_equals_the_whole_frame_rows():
    """The K3 twin on a block of rows [g0, g0 + hb) of a frame, sampling
    the whole frame, equals those rows of the whole-frame warp, at odd and
    even origins, the last block included; the wrapper refuses rows
    outside the source."""
    im1, im2, flow = _level(2, 37, 21, seed=8, scale=6.0)
    src, u, v = _t(im2, flow[..., 0], flow[..., 1])
    out, mask = tv.warp_image_batched(src, u.contiguous(), v.contiguous())
    for g0, hb in ((0, 5), (3, 11), (14, 9), (30, 7)):
        o, m = tv.warp_image_batched(src, u[:, g0:g0 + hb].contiguous(),
                                     v[:, g0:g0 + hb].contiguous(), row0=g0)
        assert torch.equal(o, out[:, :, g0:g0 + hb])
        assert torch.equal(m, mask[:, g0:g0 + hb])
    with pytest.raises(ValueError, match="not rows"):
        tv.warp_image_batched(src, u[:, :8].contiguous(),
                              v[:, :8].contiguous(), row0=30)
