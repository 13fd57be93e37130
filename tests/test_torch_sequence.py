"""The port's warm start and sequence mode against the JAX package on the
CPU: `warm_start_from_full`, `dis_flow(init_flow=...)`, `dis_sequence`,
`dis_sequence_batched`, `dis_step_warm` and the CLI's `--init-flow`.

Tolerances: the box mean of `warm_start_from_full` sums k^2 values in
another order than XLA: 1e-6 of the largest value. A warm-started pair,
and each step of a sequence, is held to an EPE ratio of 1e-4 against JAX
(the port is at 2e-6 to 7e-6 on single pairs: float32 sums in another
order, amplified by the GN trips; a warm start carries a step's
difference into the next). Two identical streams give equal flows bit for
bit, and a loop of `dis_step_warm` is `dis_sequence_batched`'s loop, so
the two are equal bit for bit; a stream of `dis_sequence_batched` is held
to `dis_sequence` within 1e-4 px, the JAX test's bound. The CLI's file is
held to JAX's at an EPE ratio of 1e-3, as the other CLI comparisons
(tests/test_torch_dis.py)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from of_dis_tpu import cli as jcli
from of_dis_tpu.models import dis as jdis
from of_dis_tpu.params import DISParams as JParams
from of_dis_tpu.utils import io as jio
from of_dis_tpu_torch import cli, convert
from of_dis_tpu_torch.models import dis as tdis
from of_dis_tpu_torch.utils import io as tio

cv2 = pytest.importorskip("cv2")

from tests.test_e2e import _pair  # noqa: E402

G = os.path.join(os.path.dirname(__file__), "goldens")


def _epe_ratio(ours, ref):
    d = np.linalg.norm(ours - ref, axis=-1)
    return d.mean() / np.linalg.norm(ref, axis=-1).mean()


def _port(jp):
    return convert.params_from_reference(dataclasses.asdict(jp))


@pytest.mark.parametrize("shape,sc_f", [((37, 53, 2), 1), ((50, 70, 1), 2),
                                        ((3, 37, 53, 2), 1)])
def test_warm_start_from_full_matches_jax(shape, sc_f):
    """Uneven sizes: the crop to a multiple of 2^(sc_f+1), the value
    scale and the box mean; leading axes are streams."""
    f = np.random.default_rng(sum(shape)).standard_normal(shape) \
        .astype(np.float32) * 4
    ours = tdis.warm_start_from_full(torch.as_tensor(f), sc_f).numpy()
    rows = f.reshape(-1, *shape[-3:])
    ref = np.stack([np.asarray(jdis.warm_start_from_full(jnp.asarray(r),
                                                         sc_f))
                    for r in rows]).reshape(ours.shape)
    k = 2 ** (sc_f + 1)
    assert ours.shape == (*shape[:-3], shape[-3] // k, shape[-2] // k,
                          shape[-1])
    assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max()


# tests/test_model_modes.py::test_init_flow_input
INIT_PRM = JParams(sc_f=1, sc_l=0, max_iter=4, min_iter=4, p_samp_s=8,
                   patove=0.4, noc=1, nop=2, usetvref=False)


def _smooth_init(h, w, seed):
    """A smooth random field (h, w, 2) of ~1-3 px."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    c = rng.random(4).astype(np.float32)
    u = 2.0 + c[0] * np.sin(xx / (1.5 + w / 4)) + c[1] * np.cos(yy / 3)
    v = 1.0 + c[2] * np.cos(xx / 2) + c[3] * np.sin(yy / (1 + h / 3))
    return np.stack([u, v], -1).astype(np.float32)


@pytest.mark.parametrize("kind,motion", [("constant", (2.0, 1.0)),
                                         ("smooth", (2.0, 1.0)),
                                         ("constant", (1.5, 0.5))],
                         ids=["jax-inputs", "smooth", "half-pixel"])
def test_dis_flow_with_init_flow_matches_jax(kind, motion):
    """The JAX test's inputs (whole-pixel motion (2, 1) at full resolution,
    a start of 0.5 px) leave converged patches on the boundary between two
    bilinear anchors, where one ulp of the pyramid flips a patch's cell
    (the port's float32 pyramid against JAX's bf16 planes): cold or warm,
    a few hundred of the 2,048 pixels differ by up to ~0.6 px, so there
    the median is held to 1e-4 px. A smooth random start on the same
    frames, and the JAX test's start on a half-pixel pair, keep every patch
    off those boundaries: EPE ratio <= 1e-4."""
    h, w = 32, 64
    a, b = _pair(h, w, flow=motion, seed=13)
    k = 2 ** (INIT_PRM.sc_f + 1)
    init = (np.full((h // k, w // k, 2), 0.5, np.float32) if kind ==
            "constant" else _smooth_init(h // k, w // k, 4))
    ref = np.asarray(jdis.dis_flow(jnp.asarray(a), jnp.asarray(b), INIT_PRM,
                                   w, h, init_flow=jnp.asarray(init)))
    ours = tdis.dis_flow(a, b, _port(INIT_PRM), w, h, init_flow=init,
                         device="cpu").numpy()
    cold = tdis.dis_flow(a, b, _port(INIT_PRM), w, h, device="cpu").numpy()
    assert ours.shape == ref.shape == (h, w, 2)
    assert not np.array_equal(ours, cold)      # the warm start was used
    if motion == (2.0, 1.0) and kind == "constant":
        assert np.median(np.linalg.norm(ours - ref, axis=-1)) <= 1e-4
    else:
        assert _epe_ratio(ours, ref) <= 1e-4


def _frames():
    """tests/test_model_modes.py::test_sequence_warm_start's video: four
    frames moving by (1.5, 0.5) px a frame."""
    h, w = 32, 64
    rng = np.random.default_rng(12)
    big = cv2.GaussianBlur((rng.random((h + 60, w + 60)) * 255
                            ).astype(np.float32), (9, 9), 2.5)
    frames = []
    for t in range(4):
        m = np.float32([[1, 0, 1.5 * t], [0, 1, 0.5 * t]])
        f = cv2.warpAffine(big, m, (w + 60, h + 60))[30:30 + h, 30:30 + w]
        frames.append(f[None])
    return np.stack(frames), h, w


# the JAX test's settings (one level, no upscale), and two levels above a
# finest level at half resolution, so the carry passes K4's upscale
SEQ_PRM = {
    "sc0": JParams(sc_f=1, sc_l=0, max_iter=8, min_iter=8, p_samp_s=8,
                   patove=0.4, noc=1, nop=2, usetvref=True),
    "sc1": JParams(sc_f=2, sc_l=1, max_iter=8, min_iter=8, p_samp_s=8,
                   patove=0.4, noc=1, nop=2, usetvref=True),
}


@pytest.mark.parametrize("cfg", sorted(SEQ_PRM))
def test_sequence_modes_match_jax(cfg):
    jp = SEQ_PRM[cfg]
    frames, h, w = _frames()
    two = np.stack([frames, frames], axis=1)           # (T, 2, C, H, W)
    ref = np.asarray(jdis.dis_sequence(jnp.asarray(frames), jp, w, h))
    ref_b = np.asarray(jdis.dis_sequence_batched(jnp.asarray(two), jp, w, h))
    ours = tdis.dis_sequence(frames, _port(jp), w, h, device="cpu").numpy()
    ours_b = tdis.dis_sequence_batched(two, _port(jp), w, h,
                                       device="cpu").numpy()
    assert ours.shape == ref.shape == (3, h, w, 2)
    assert ours_b.shape == ref_b.shape == (3, 2, h, w, 2)
    for t in range(3):
        assert _epe_ratio(ours[t], ref[t]) <= 1e-4, t
        assert _epe_ratio(ours_b[t, 0], ref_b[t, 0]) <= 1e-4, t
        inner = ours[t, 8:-8, 8:-8]
        assert np.hypot(inner[..., 0] - 1.5, inner[..., 1] - 0.5).mean() \
            < 0.5
    np.testing.assert_array_equal(ours_b[:, 0], ours_b[:, 1])
    np.testing.assert_allclose(ours_b[:, 0], ours, rtol=0, atol=1e-4)


def test_step_loop_equals_batched_sequence():
    jp = SEQ_PRM["sc1"]
    frames, h, w = _frames()
    # two streams: the video and the video reversed
    two = np.stack([frames, frames[::-1]], axis=1)
    p = _port(jp)
    carry = tdis.warm_carry_init(2, p, w, h, device="cpu")
    assert tuple(carry.shape) == (2, h // 8, w // 8, 2)
    steps = []
    for t in range(3):
        flow, carry = tdis.dis_step_warm(two[t], two[t + 1], p, w, h, carry,
                                         device="cpu")
        steps.append(flow)
    batched = tdis.dis_sequence_batched(two, p, w, h, device="cpu")
    assert torch.equal(torch.stack(steps), batched)


def _write_init(path, flow):
    tio.write_flo(str(path), flow.astype(np.float32))
    return str(path)


@pytest.mark.parametrize("size", ["same", "other"])
@pytest.mark.parametrize("mode,second,golden", [
    ("run_OF_INT", "b.png", "of_int_op2.flo"),
    ("run_DE_INT", "bs.png", "de_int_op2.pfm")], ids=["flow", "depth"])
def test_cli_init_flow_matches_jax(tmp_path, mode, second, golden, size):
    """--init-flow at 192x160 from the op-2 golden, at the frames' size or
    subsampled to another one (resized, its values rescaled): the port's
    file against JAX's."""
    if golden.endswith(".flo"):
        init = jio.read_flo(os.path.join(G, golden))
    else:
        init = jio.read_pfm(os.path.join(G, golden))[..., None]
    if size == "other":
        init = init[::2, ::3] * np.asarray([1 / 3, 1 / 2][:init.shape[-1]],
                                           np.float32)
    flo = _write_init(tmp_path / "init.flo", init)
    files = [os.path.join(G, f) for f in ("a.png", second)]
    suffix = golden[-4:]
    ref, ours = (str(tmp_path / (n + suffix)) for n in ("jax", "port"))
    jcli.main([mode, *files, ref, "2", "--init-flow", flo, "--quiet"])
    cli.main([mode, *files, ours, "2", "--init-flow", flo, "--quiet",
              "--device", "cpu"])
    read = tio.read_flo if suffix == ".flo" else \
        (lambda f: tio.read_pfm(f)[..., None])
    r, o = read(ref), read(ours)
    assert o.shape == r.shape == (160, 192, r.shape[-1])
    assert _epe_ratio(o, r) <= 1e-3
