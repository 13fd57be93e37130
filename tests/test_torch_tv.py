"""Port's TV refinement (warp, derivatives, data terms, SOR, level loops
for flow and depth, gray and RGB, batched and single pair) against the JAX
package.

Tolerances, each with its reason:
  - warp: 1e-5 absolute on the 0-255 scale — the same four-term lerp in
    the same float32 order;
  - derivatives / smoothness / data term / sub_laplacian: 1e-5 relative to
    each field's largest value — the same elementwise formulas;
  - SOR and the level loop uu/vv: 1e-4 px absolute — float32 rounding
    differences carried through the dependent sweeps; the same against
    the JAX package's fused kernels run in Pallas interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_dis_tpu.ops import tv as jtv
from of_dis_tpu_torch import trace
from of_dis_tpu_torch.kernels import tv_de_inner, tv_of_inner
from of_dis_tpu_torch.ops import tv as ttv


def _data(b=2, h=20, w=24, seed=0):
    rng = np.random.default_rng(seed)
    im1 = (rng.random((b, 1, h, w)) * 255).astype(np.float32)
    im2 = (rng.random((b, 1, h, w)) * 255).astype(np.float32)
    wx = (rng.standard_normal((b, h, w)) * 1.5).astype(np.float32)
    wy = (rng.standard_normal((b, h, w)) * 1.5).astype(np.float32)
    return im1, im2, wx, wy


def _tv_counts(lib):
    """Launches of a TV library's batched and single-pair C entries."""
    return (trace.launches(lib, f"of_{lib}"),
            trace.launches(lib, f"of_{lib}_single"))


def _close(ours, ref, rel=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours.numpy(), ref,
                               atol=rel * max(np.abs(ref).max(), 1.0), rtol=0)


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def test_warp_matches_jax():
    im1, im2, wx, wy = _data()
    wx[:, 0, :] = 30.0            # corner clamps
    wy[:, :, 0] = -25.0
    for k in range(2):
        ro, rm = jtv.warp_image(jnp.asarray(im2[k]), jnp.asarray(wx[k]),
                                jnp.asarray(wy[k]))
        o, m = ttv.warp_image(*_t(im2[k], wx[k], wy[k]))
        np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=1e-5,
                                   rtol=0)
        np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    # the K3 wrapper takes its plain twin on CPU tensors
    o, m = ttv.warp_image_batched(*_t(im2, wx, wy))
    ro, rm = jax.vmap(jtv.warp_image)(*map(jnp.asarray, (im2, wx, wy)))
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))


def test_derivatives_smoothness_data_match_jax():
    im1, im2, wx, wy = _data(seed=1)
    ref = jax.vmap(jtv.get_derivatives)(jnp.asarray(im1), jnp.asarray(im2))
    ours = ttv.get_derivatives(*_t(im1, im2))
    for a, b in zip(ours, ref):
        _close(a, b)
    rh, rv = jtv.compute_smoothness(jnp.asarray(wx), jnp.asarray(wy), 2.5)
    oh, ov = ttv.compute_smoothness(*_t(wx, wy), 2.5)
    _close(oh, rh)
    _close(ov, rv)
    mask = np.ones_like(wx)
    mask[:, :2] = 0.0
    du, dv = wx * 0.1, wy * -0.2
    i_j = [jnp.asarray(np.asarray(f)).transpose(1, 0, 2, 3) for f in ref]
    i_t = [torch.as_tensor(np.asarray(f)).transpose(0, 1) for f in ref]
    for hd3 in (5.0 * 0.5 / 3.0, 0.0):
        rd = jtv.compute_data_gray(*map(jnp.asarray, (mask, du, dv)), i_j,
                                   hd3, 10.0 * 0.5 / 3.0)
        od = ttv.compute_data_gray(*_t(mask, du, dv), i_t, hd3,
                                   10.0 * 0.5 / 3.0)
        for a, b in zip(od, rd):
            _close(a, b)
    _close(ttv.sub_laplacian(*_t(du, wx), oh, ov),
           jtv.sub_laplacian(jnp.asarray(du), jnp.asarray(wx), rh, rv))


@pytest.mark.parametrize("row_parity", [0, 1])
def test_sor_matches_jax(row_parity):
    rng = np.random.default_rng(row_parity)
    shape = (2, 14, 32)
    f = [rng.standard_normal(shape).astype(np.float32) for _ in range(5)]
    wh = np.abs(rng.standard_normal(shape)).astype(np.float32)
    wv = np.abs(rng.standard_normal(shape)).astype(np.float32)
    wh[..., -1] = 0.0
    wv[..., -1, :] = 0.0
    a11 = np.abs(f[0]) + 1.0
    a22 = np.abs(f[1]) + 1.0
    z = np.zeros(shape, np.float32)
    args = (z, z, a11, f[2] * 0.1, a22, f[3], f[4], wh, wv)
    ref = jtv.sor_coupled_rb(*map(jnp.asarray, args), 3, 1.6,
                             row_parity=row_parity)
    ours = ttv.sor_coupled_rb(*_t(*args), 3, 1.6, row_parity=row_parity)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("n_inner,delta", [(4, 5.0), (2, 0.0)])
def test_ref_level_of_batched_matches_jax(n_inner, delta):
    im1, im2, wx, wy = _data(h=14, w=32, seed=n_inner)
    kw = dict(alpha=10.0, gamma=10.0, delta=delta, n_inner=n_inner,
              n_solver=3, omega=1.6)
    ru, rv = jtv.ref_level_of_batched(*map(jnp.asarray, (wx, wy, im1, im2)),
                                      **kw)
    launches = _tv_counts("tv_of_inner")
    ou, ov = ttv.ref_level_of_batched(*_t(wx, wy, im1, im2), **kw)
    assert _tv_counts("tv_of_inner") == launches  # CPU: plain twin, no kernel
    np.testing.assert_allclose(ou.numpy(), np.asarray(ru), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ov.numpy(), np.asarray(rv), atol=1e-4, rtol=0)


# ------------------------------------------------ RGB and depth (nop=1)

HD3 = 5.0 * 0.5 / 3.0
HG3 = 10.0 * 0.5 / 3.0


def _fields(noc, seed, h=12, w=16):
    """mask, du, dv (H, W) and the 8 derivative fields (noc, H, W)."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((h, w)) > 0.1).astype(np.float32)
    du = rng.standard_normal((h, w)).astype(np.float32) * 0.3
    dv = rng.standard_normal((h, w)).astype(np.float32) * 0.3
    I = [rng.standard_normal((noc, h, w)).astype(np.float32) * s
         for s in (8, 8, 20, 3, 3, 3, 6, 6)]
    return mask, du, dv, I


@pytest.mark.parametrize("hd3", [HD3, 0.0])
@pytest.mark.parametrize("term", ["rgb", "de_gray", "de_rgb"])
def test_rgb_and_depth_data_terms_match_jax(term, hd3):
    noc = 1 if term == "de_gray" else 3
    mask, du, dv, I = _fields(noc, seed=len(term))
    state = (mask, du, dv) if term == "rgb" else (mask, du)
    ref = getattr(jtv, f"compute_data_{term}")(
        *map(jnp.asarray, state), [jnp.asarray(f) for f in I], hd3, HG3)
    ours = getattr(ttv, f"compute_data_{term}")(
        *_t(*state), _t(*I), hd3, HG3)
    assert len(ours) == len(ref) == (5 if term == "rgb" else 2)
    for a, b in zip(ours, ref):
        _close(a, b)


def _dump_inputs():
    """The inputs of the compiled reference's data-term dumps: mask, du,
    dv, then 8 derivative images x 3 channels, 16x24 float32 planes."""
    import os
    g = os.path.join(os.path.dirname(__file__), "goldens")
    w, h = 24, 16
    n = w * h
    raw = np.fromfile(os.path.join(g, "data_term_inputs.bin"), np.float32)
    planes = raw.reshape(-1, h, w)
    return g, planes[0], planes[1], planes[2], [
        planes[3 + 3 * f:6 + 3 * f] for f in range(8)]


@pytest.mark.parametrize("term,n_out", [("rgb", 5), ("de_rgb", 2)])
def test_rgb_data_terms_match_reference_dump(term, n_out):
    """The two upstream quirks of the RGB flow term and the scalings of
    both RGB terms are pinned by raw dumps of the C functions; 1e-5 of
    each field's largest value, the budget of the JAX package's own test."""
    import os
    g, mask, du, dv, I = _dump_inputs()
    state = (mask, du, dv) if term == "rgb" else (mask, du)
    ours = getattr(ttv, f"compute_data_{term}")(
        *_t(*(x.copy() for x in state)), _t(*(f.copy() for f in I)), HD3, HG3)
    ref = np.fromfile(os.path.join(g, f"data_term_{term}.bin"),
                      np.float32).reshape(n_out, 16, 24)
    for a, b in zip(ours, ref):
        _close(a, b)


@pytest.mark.parametrize("row_parity", [0, 1])
def test_sor_de_matches_jax(row_parity):
    rng = np.random.default_rng(10 + row_parity)
    shape = (2, 14, 32)
    f = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    wh = np.abs(rng.standard_normal(shape)).astype(np.float32)
    wv = np.abs(rng.standard_normal(shape)).astype(np.float32)
    wh[..., -1] = 0.0
    wv[..., -1, :] = 0.0
    args = (np.zeros(shape, np.float32), np.abs(f[0]) + 1.0, f[1], wh, wv)
    ref = jtv.sor_de_rb(*map(jnp.asarray, args), 3, 1.6,
                        row_parity=row_parity)
    ours = ttv.sor_de_rb(*_t(*args), 3, 1.6, row_parity=row_parity)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)


def _data_c(noc, seed, b=2, h=14, w=32):
    rng = np.random.default_rng(seed)
    im1 = (rng.random((b, noc, h, w)) * 255).astype(np.float32)
    im2 = (rng.random((b, noc, h, w)) * 255).astype(np.float32)
    wx = (rng.standard_normal((b, h, w)) * 1.5).astype(np.float32)
    wy = (rng.standard_normal((b, h, w)) * 1.5).astype(np.float32)
    return im1, im2, wx, wy


KW = dict(alpha=10.0, gamma=10.0, delta=5.0, n_inner=3, n_solver=3,
          omega=1.6)


@pytest.mark.parametrize("n_inner,delta", [(4, 5.0), (2, 0.0)])
def test_ref_level_of_batched_rgb_matches_jax(n_inner, delta):
    im1, im2, wx, wy = _data_c(3, seed=20 + n_inner)
    kw = dict(KW, n_inner=n_inner, delta=delta)
    ru, rv = jtv.ref_level_of_batched(*map(jnp.asarray, (wx, wy, im1, im2)),
                                      **kw)
    ou, ov = ttv.ref_level_of_batched(*_t(wx, wy, im1, im2), **kw)
    np.testing.assert_allclose(ou.numpy(), np.asarray(ru), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ov.numpy(), np.asarray(rv), atol=1e-4, rtol=0)


@pytest.mark.parametrize("noc", [1, 3])
@pytest.mark.parametrize("camlr", [0, 1])
def test_ref_level_de_batched_matches_jax(camlr, noc):
    im1, im2, wx, _ = _data_c(noc, seed=30 + camlr + noc)   # both signs
    ref = jtv.ref_level_de_batched(*map(jnp.asarray, (wx, im1, im2)),
                                   camlr=camlr, **KW)
    before = _tv_counts("tv_de_inner")
    ours = ttv.ref_level_de_batched(*_t(wx, im1, im2), camlr=camlr, **KW)
    assert _tv_counts("tv_de_inner") == before    # CPU: plain twin, no kernel
    assert ours.shape == (2, 14, 32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    # the sign clamp acts, and part of the field sits on it
    assert (ours <= 0).all() if camlr == 0 else (ours >= 0).all()
    assert int((ours == 0).sum()) > 0


def _interp_pallas(monkeypatch):
    """Run the JAX package's fused TV kernels themselves, in Pallas
    interpret mode, as its own tests do on the CPU."""
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(jtv, "_use_pallas", lambda h, w, noc: True)


@pytest.mark.parametrize("noc", [1, 3])
def test_ref_level_of_single_pair_matches_jax_kernel(monkeypatch, noc):
    """`ref_level_of` on one unbatched pair against `_of_inner_pallas`."""
    im1, im2, wx, wy = _data_c(noc, seed=40 + noc, b=1, h=24, w=32)
    _interp_pallas(monkeypatch)
    ru, rv = jtv.ref_level_of(*map(jnp.asarray,
                                   (wx[0], wy[0], im1[0], im2[0])), **KW)
    counts = _tv_counts("tv_of_inner")
    ou, ov = ttv.ref_level_of(*_t(wx[0], wy[0], im1[0], im2[0]), **KW)
    assert _tv_counts("tv_of_inner") == counts
    assert ou.shape == ov.shape == (24, 32)
    np.testing.assert_allclose(ou.numpy(), np.asarray(ru), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ov.numpy(), np.asarray(rv), atol=1e-4, rtol=0)
    # one pair through the batched entry is the same computation
    bu, bv = ttv.ref_level_of_batched(*_t(wx, wy, im1, im2), **KW)
    np.testing.assert_array_equal(ou.numpy(), bu[0].numpy())
    np.testing.assert_array_equal(ov.numpy(), bv[0].numpy())


@pytest.mark.parametrize("noc", [1, 3])
@pytest.mark.parametrize("camlr", [0, 1])
def test_ref_level_de_single_pair_matches_jax_kernel(monkeypatch, camlr, noc):
    """`ref_level_de` on one unbatched pair against `_de_inner_pallas`."""
    im1, im2, wx, _ = _data_c(noc, seed=50 + camlr + noc, b=1, h=24, w=32)
    wx = -np.abs(wx) if camlr == 0 else np.abs(wx)
    _interp_pallas(monkeypatch)
    ref = jtv.ref_level_de(*map(jnp.asarray, (wx[0], im1[0], im2[0])),
                           camlr=camlr, **KW)
    counts = _tv_counts("tv_de_inner")
    ours = ttv.ref_level_de(*_t(wx[0], im1[0], im2[0]), camlr=camlr, **KW)
    assert _tv_counts("tv_de_inner") == counts
    assert ours.shape == (24, 32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=0)
    batched = ttv.ref_level_de_batched(*_t(wx, im1, im2), camlr=camlr, **KW)
    np.testing.assert_array_equal(ours.numpy(), batched[0].numpy())


@pytest.mark.parametrize("h,w,cooperative", [
    (1, 1, False), (14, 32, False), (32, 32, False), (33, 32, True),
    (28, 64, True), (56, 128, True), (448, 1024, True)])
def test_tv_route_rule_follows_the_pair_size(h, w, cooperative):
    """K2's route is a rule of the level's shape alone: pairs of up to
    1,024 pixels (op-2/3/4's coarsest level, 14x32) keep one block a pair,
    larger ones spread over the card in one cooperative launch."""
    assert tv_of_inner.BLOCK_MAX_PIXELS == 1024
    assert tv_of_inner.cooperative(h, w) == cooperative


# K5's rule (measured on the H100, PERF.md): pairs of at most 2,048 pixels
# keep one block a pair; larger ones split into bands of at most 2,048
# pixels that fit one block's shared memory, as many clusters as fill the
# card in one wave and at least 64 blocks; the cooperative route where no
# 16-block cluster holds a pair
_DE_ROUTES = {
    (14, 32): [("cluster", 1)] * 4,
    (28, 64): [("cluster", 1)] * 4,
    (56, 128): [("cluster", 16), ("cluster", 16), ("cluster", 4),
                ("cluster", 2)],
    (112, 256): [("cluster", 16), ("cluster", 16), ("cluster", 8),
                 ("cluster", 4)],
    (224, 512): [("cluster", 16)] * 4,
    (448, 1024): [("cooperative", 0)] * 4,
}


@pytest.mark.parametrize("b", [1, 4, 16, 64])
@pytest.mark.parametrize("h,w", sorted(_DE_ROUTES))
def test_tv_de_route_rule_follows_the_level_and_batch(h, w, b):
    """K5's route is a rule of the level's shape and batch: op-2's coarse
    levels (up to 1,792 pixels a pair) keep one block a pair at any batch;
    its 56x128 level splits over clusters of 2 at B=64 (one wave), 4 at
    B=16 (path D), 16 for one to four pairs; op-4's 224x512 level needs 16
    blocks of 172 KB, and its 1024x448 level (11 MB of fields a pair) takes
    the cooperative route. Every band fits the shared memory and is at
    least 2 rows high."""
    name, k = tv_de_inner.route(b, h, w)
    assert (name, k) == _DE_ROUTES[(h, w)][[1, 4, 16, 64].index(b)]
    if name == "cluster":
        assert k == 1 or h >= 2 * k
        assert tv_de_inner.N_FIELDS * 4 * -(-h // k) * w \
            <= tv_de_inner.SMEM_BYTES
    else:
        k = tv_de_inner.MAX_CLUSTER
        assert tv_de_inner.N_FIELDS * 4 * -(-h // k) * w \
            > tv_de_inner.SMEM_BYTES
