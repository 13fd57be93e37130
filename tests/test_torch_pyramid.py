"""Port's pyramid (of_dis_tpu_torch.ops.pyramid) against the JAX package.

Tolerance: 1e-4 absolute on the 0-255 scale — u8-sourced levels are exact
in both (dyadic box means), the Sobel and lerp sums differ only in float32
summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_dis_tpu.ops import pyramid as jp
from of_dis_tpu_torch.ops import pyramid as tp

ATOL = 1e-4


def _img(shape, seed=0, u8=True):
    rng = np.random.default_rng(seed)
    x = rng.random(shape) * 255
    return np.rint(x).astype(np.uint8) if u8 else x.astype(np.float32)


@pytest.mark.parametrize("lv_f,lv_l", [(3, 1), (3, 0), (2, 2)])
def test_build_pyramid_matches_jax(lv_f, lv_l):
    img = _img((1, 40, 48), seed=lv_f + lv_l)
    ji, jdx, jdy = jp.build_pyramid(jnp.asarray(img), lv_f, 8, lv_l=lv_l)
    ti, tdx, tdy = tp.build_pyramid(torch.as_tensor(img), lv_f, 8, lv_l=lv_l)
    for lv in range(lv_f + 1):
        if lv < lv_l:
            assert ti[lv] is None and tdx[lv] is None
            continue
        for a, b in ((ji, ti), (jdx, tdx), (jdy, tdy)):
            np.testing.assert_allclose(b[lv].numpy(), np.asarray(a[lv]),
                                       atol=ATOL, rtol=0)


def test_build_pyramid_batched_matches_per_pair():
    img = _img((3, 1, 32, 40), seed=5)
    ti, _, tdy = tp.build_pyramid(torch.as_tensor(img), 2, 4, lv_l=1)
    for k in range(3):
        ji, _, jdy = jax.vmap(lambda x: jp.build_pyramid(x, 2, 4, lv_l=1))(
            jnp.asarray(img[k:k + 1]))
        np.testing.assert_allclose(ti[2][k].numpy(), np.asarray(ji[2][0]),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(tdy[1][k].numpy(), np.asarray(jdy[1][0]),
                                   atol=ATOL, rtol=0)


def test_float_pyramid_matches_float64():
    """A float (not u8) image: the JAX package splits it into two bf16
    planes (~16-bit mantissa, ~1e-3 off), so the port's float32 levels are
    held against a float64 evaluation of the same matrices instead."""
    img = _img((1, 40, 48), seed=9, u8=False)
    ti, _, _ = tp.build_pyramid(torch.as_tensor(img), 2, 8)
    ref = img.astype(np.float64)
    for lv in range(1, 3):
        h, w = ref.shape[1], ref.shape[2]
        ref = np.einsum("ih,chw,jw->cij", tp._lerp_matrix(h // 2, h),
                        ref, tp._lerp_matrix(w // 2, w))
        np.testing.assert_allclose(ti[lv][:, 8:-8, 8:-8].numpy(), ref,
                                   atol=ATOL, rtol=0)


def test_sobel_matches_jax():
    img = _img((2, 17, 23), seed=3, u8=False)
    for jf, tf in ((jp.sobel_dx, tp.sobel_dx), (jp.sobel_dy, tp.sobel_dy)):
        np.testing.assert_allclose(tf(torch.as_tensor(img)).numpy(),
                                   np.asarray(jf(jnp.asarray(img))),
                                   atol=ATOL, rtol=0)


def test_rgb_pyramid_matches_jax():
    img = _img((3, 40, 48), seed=11)
    ji, jdx, jdy = jp.build_pyramid(jnp.asarray(img), 2, 8, lv_l=1)
    ti, tdx, tdy = tp.build_pyramid(torch.as_tensor(img)[None], 2, 8, lv_l=1)
    for lv in (1, 2):
        assert ti[lv].shape == (1, 3) + tuple(ji[lv].shape[1:])
        for a, b in ((ji, ti), (jdx, tdx), (jdy, tdy)):
            np.testing.assert_allclose(b[lv][0].numpy(), np.asarray(a[lv]),
                                       atol=ATOL, rtol=0)


def test_gradient_magnitude_matches_jax():
    img = _img((1, 33, 47), seed=12).astype(np.float32)
    ours = tp.gradient_magnitude(torch.as_tensor(img))
    ref = np.asarray(jp.gradient_magnitude(jnp.asarray(img)))
    assert ours.dtype == torch.float32 and ours.shape == (1, 33, 47)
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=0)
    # u8 in, float out: the CLI feeds the loader's float image, but a u8
    # tensor must not wrap around in the Sobel differences
    np.testing.assert_array_equal(
        tp.gradient_magnitude(torch.as_tensor(img.astype(np.uint8))).numpy(),
        ours.numpy())


def test_gradient_magnitude_pyramid_vs_jax_float_contraction():
    """The GRD modes feed a float image to the pyramid. The JAX package
    contracts floats through two bf16 planes (~16 mantissa bits, 2^-17 =
    7.6e-6 relative), the port in float32: the levels agree to 2e-5 of
    the level's largest value (measured 5e-6), where u8 input is exact in
    both."""
    img = _img((1, 40, 48), seed=13).astype(np.float32)
    gj = jp.gradient_magnitude(jnp.asarray(img))
    gt = tp.gradient_magnitude(torch.as_tensor(img))
    ji, _, _ = jp.build_pyramid(gj, 2, 8)
    ti, _, _ = tp.build_pyramid(gt, 2, 8)
    for lv in (1, 2):
        ref = np.asarray(ji[lv])
        np.testing.assert_allclose(ti[lv].numpy(), ref,
                                   atol=2e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("shape", [(1, 37, 50), (1, 32, 32)])
def test_pad_to_divisible_matches_jax(shape):
    img = _img(shape, seed=1)
    ours = tp.pad_to_divisible(torch.as_tensor(img), 3)
    ref = np.asarray(jp.pad_to_divisible(jnp.asarray(img), 3))
    assert ours.dtype == torch.uint8
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_resize_linear_matches_float64():
    """INTER_LINEAR upscale of a float field (the final flow rescale): the
    JAX package's bf16 hi/lo planes are ~1e-3 off for float inputs, so the
    reference is a float64 evaluation of the same matrices."""
    img = _img((2, 7, 16), seed=2, u8=False)
    ours = tp.resize_linear(torch.as_tensor(img), 56, 128)
    ref = np.einsum("ih,chw,jw->cij", tp._lerp_matrix(56, 7),
                    img.astype(np.float64), tp._lerp_matrix(128, 16))
    np.testing.assert_allclose(ours.numpy(), ref, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tp._lerp_matrix(56, 7),
                                  jp._lerp_matrix(56, 7))
