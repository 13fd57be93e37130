"""The frame-pair batch split over a list of devices
(`of_dis_tpu_torch.parallel.mesh`) on 8 CPU devices: the cases of the JAX
package's tests/test_mesh.py, each shard's shape and device checked, the
split equal to one device, and held against the JAX package's sharded
run. Also: a pair's flow does not depend on the pairs batched with it, at
op-3 and with the forward-backward merge (the split puts one pair on a
device when the batch equals the device count)."""

import dataclasses

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_dis_tpu.models import dis as jax_dis
from of_dis_tpu.parallel import mesh as jax_mesh
from of_dis_tpu.params import DISParams as JaxParams
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import densify, pyramid
from of_dis_tpu_torch.parallel import mesh as pmesh
from of_dis_tpu_torch.params import DISParams, make_level_spec, op_point_params

H, W = 32, 64
# The port against the JAX package: EPE ratio (mean endpoint error over
# the mean flow), the port's `dis_flow_batched` budget. Held on the u8
# frames of the same draw: on float input the JAX package's pyramid
# contracts through two bf16 planes and the port's in float32 (ROADMAP
# Queue 3), which random-noise frames amplify to an EPE ratio of ~2e-3.
JAX_EPE_RATIO = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes run one torch thread: under several test workers a
    full pool of spinning threads per worker makes these many small
    operations tens of times slower, and starves the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pairs(b, noc=1, seed=0):
    rng = np.random.default_rng(seed)
    im_a = rng.random((b, noc, H, W)).astype(np.float32) * np.float32(255)
    im_b = rng.random((b, noc, H, W)).astype(np.float32) * np.float32(255)
    return im_a, im_b


def _params(**kw):
    base = dict(sc_f=1, sc_l=0, max_iter=6, min_iter=6, p_samp_s=8,
                patove=0.4, noc=1, nop=2, usetvref=True)
    base.update(kw)
    return DISParams(**base), JaxParams(**base)


@pytest.fixture(scope="module")
def mesh8():
    return pmesh.make_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_mesh8():
    return jax_mesh.make_mesh(jax.devices()[:8])


def _check_shards(got, per, shape):
    assert len(got) == 8
    for s in got:
        assert s.device.type == "cpu"
        assert tuple(s.shape) == (per,) + shape


def _epe_ratio(ours, ref):
    return float(np.linalg.norm(ours - ref, axis=-1).mean()
                 / max(np.linalg.norm(ref, axis=-1).mean(), 1e-12))


def _against_jax(mesh, jm, im_a, im_b, params, jp):
    """The split on the u8 frames of (im_a, im_b) against the JAX
    package's sharded run on the same frames."""
    a, b = (np.round(x).astype(np.uint8) for x in (im_a, im_b))
    got = torch.cat(pmesh.dis_flow_sharded(mesh, a, b, params, W, H))
    sa, sb = jax_mesh.shard_batch(jm, jnp.asarray(a), jnp.asarray(b))
    want = np.asarray(jax_mesh.dis_flow_sharded(jm, sa, sb, jp, W, H))
    assert _epe_ratio(got.numpy(), want) < JAX_EPE_RATIO


def test_sharded_matches_unsharded(mesh8, jax_mesh8):
    params, jp = _params()
    im_a, im_b = _pairs(8)
    want = dis.dis_flow_batched(im_a, im_b, params, W, H, device="cpu")
    sa, sb = pmesh.shard_batch(mesh8, im_a, im_b)
    got = pmesh.dis_flow_sharded(mesh8, sa, sb, params, W, H)
    np.testing.assert_allclose(torch.cat(got).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(torch.cat(got), want)
    _against_jax(mesh8, jax_mesh8, im_a, im_b, params, jp)


def test_sharded_output_shards(mesh8):
    params, _ = _params()
    im_a, im_b = _pairs(8, seed=1)
    sa, sb = pmesh.shard_batch(mesh8, im_a, im_b)
    # inputs land one contiguous chunk a device, in order
    _check_shards(sa, 1, (1, H, W))
    np.testing.assert_array_equal(torch.cat(sb).numpy(), im_b)
    out = pmesh.dis_flow_sharded(mesh8, sa, sb, params, W, H)
    _check_shards(out, 1, (H, W, 2))


def test_sharded_batch_multiple_pairs_per_device(mesh8, jax_mesh8):
    # B=16 over 8 devices: 2 pairs a device
    params, jp = _params(max_iter=4, min_iter=4)
    im_a, im_b = _pairs(16, seed=2)
    want = dis.dis_flow_batched(im_a, im_b, params, W, H, device="cpu")
    got = pmesh.dis_flow_sharded(mesh8, im_a, im_b, params, W, H)
    _check_shards(got, 2, (H, W, 2))
    np.testing.assert_allclose(torch.cat(got).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    _against_jax(mesh8, jax_mesh8, im_a, im_b, params, jp)


def test_sharded_sequence_streams(mesh8, jax_mesh8):
    """dis_sequence_batched with the STREAM axis split over the devices
    equals the unsplit sequence mode (warm-start carries stay on their
    device)."""
    params, jp = _params(max_iter=4, min_iter=4)
    rng = np.random.default_rng(5)
    t, s = 3, 8
    frames = rng.integers(0, 256, (t, s, 1, H, W)).astype(np.uint8)
    want = dis.dis_sequence_batched(frames, params, W, H, device="cpu")
    got = pmesh.dis_sequence_sharded(mesh8, frames, params, W, H)
    for g in got:
        assert tuple(g.shape) == (t - 1, 1, H, W, 2)
    joined = torch.cat(got, dim=1)
    np.testing.assert_allclose(joined.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    ref = np.asarray(jax_mesh.dis_sequence_sharded(
        jax_mesh8, jnp.asarray(frames), jp, W, H))
    assert _epe_ratio(joined.numpy(), ref) < JAX_EPE_RATIO


def test_sharded_fbcon(mesh8, jax_mesh8):
    """The forward-backward merge through the split (oflow.cpp:162-169)."""
    params, jp = _params(usefbcon=True, max_iter=4, min_iter=4)
    im_a, im_b = _pairs(8, seed=6)
    want = dis.dis_flow_batched(im_a, im_b, params, W, H, device="cpu")
    got = pmesh.dis_flow_sharded(mesh8, im_a, im_b, params, W, H)
    np.testing.assert_allclose(torch.cat(got).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    _against_jax(mesh8, jax_mesh8, im_a, im_b, params, jp)


def test_sharded_depth_mode(mesh8, jax_mesh8):
    params, jp = _params(nop=1)
    im_a, im_b = _pairs(8, seed=3)
    want = dis.dis_flow_batched(im_a, im_b, params, W, H, device="cpu")
    got = pmesh.dis_flow_sharded(mesh8, im_a, im_b, params, W, H)
    _check_shards(got, 1, (H, W, 1))
    np.testing.assert_allclose(torch.cat(got).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    _against_jax(mesh8, jax_mesh8, im_a, im_b, params, jp)


def test_make_mesh_needs_cuda_or_a_device_list(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.make_mesh(["cuda:0", "cuda:0"])
    mesh = pmesh.make_mesh(["cpu", torch.device("cpu")])
    assert mesh.size == 2 and all(d.type == "cpu" for d in mesh.devices)
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_batch(mesh, np.zeros((3, 1, 4, 4), np.uint8))


def _shifted_frames(n, dx=1.5, dy=0.5, h=96, w=128):
    """n frames of one blurred random image moving (dx, dy) px a frame."""
    rng = np.random.default_rng(0)
    big = cv2.GaussianBlur((rng.random((140, 180)) * 255).astype(np.float32),
                           (9, 9), 2.5)
    out = []
    for t in range(n):
        m = np.float32([[1, 0, dx * t], [0, 1, dy * t]])
        f = cv2.warpAffine(big, m, (180, 140))[20:20 + h, 20:20 + w]
        out.append(np.clip(f, 0, 255).astype(np.uint8))
    return torch.as_tensor(np.stack(out))[:, None]


@pytest.mark.parametrize("op,fbcon", [(3, False), (2, True)])
def test_one_pair_alone_equals_it_in_a_batch(op, fbcon):
    """8 batches of 1 equal the batch of 8 bit for bit: at op-3 (the
    densification's contractions) and with the merge (its backward
    splat), where a float32 product's sum order followed the batch size."""
    params = op_point_params(128, op, nop=2, noc=1, verbosity=0)
    params = dataclasses.replace(params, usefbcon=fbcon)
    fr = pyramid.pad_to_divisible(_shifted_frames(9), params.sc_f)
    fh, fw = fr.shape[-2:]
    a, b = fr[:-1], fr[1:]
    whole = dis.dis_flow_batched(a, b, params, fw, fh, device="cpu")
    alone = torch.cat([dis.dis_flow_batched(a[i:i + 1], b[i:i + 1], params,
                                            fw, fh, device="cpu")
                       for i in range(8)])
    assert torch.equal(alone, whole)


def test_one_pair_alone_equals_it_in_a_batch_over_merge_chunks(monkeypatch):
    """The merge over many chunks (a few patches each): the chunks are
    sized per pair, so 4 batches of 1 still equal the batch of 4."""
    monkeypatch.setattr(densify, "_MERGE_CHUNK_BYTES", 1 << 16)
    params = op_point_params(128, 2, nop=2, noc=1, verbosity=0)
    params = dataclasses.replace(params, usefbcon=True)
    fr = pyramid.pad_to_divisible(_shifted_frames(5), params.sc_f)
    fh, fw = fr.shape[-2:]
    a, b = fr[:-1], fr[1:]
    spec = make_level_spec(params.sc_l, fw, fh, params)
    assert densify._merge_chunk(spec.nopatches, params.p_samp_s,
                                spec.height, spec.width) < spec.nopatches
    whole = dis.dis_flow_batched(a, b, params, fw, fh, device="cpu")
    alone = torch.cat([dis.dis_flow_batched(a[i:i + 1], b[i:i + 1], params,
                                            fw, fh, device="cpu")
                       for i in range(4)])
    assert torch.equal(alone, whole)


def test_shard_bounds_is_the_split_rule(mesh8):
    """One contiguous chunk a device, in order; `shard_batch` cuts by it."""
    bounds = pmesh.shard_bounds(mesh8, 16)
    assert bounds == [slice(2 * d, 2 * d + 2) for d in range(8)]
    x = torch.arange(16 * 3).reshape(16, 3)
    for chunk, s in zip(pmesh.shard_batch(mesh8, x), bounds):
        assert torch.equal(chunk, x[s])
    with pytest.raises(ValueError, match="does not divide"):
        pmesh.shard_bounds(mesh8, 12)
