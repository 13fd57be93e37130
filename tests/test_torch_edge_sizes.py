"""Shape robustness of the port: the cases of tests/test_edge_sizes.py (odd,
prime-ish, portrait and non-divisible frame sizes, flow, RGB and depth)
through the port's `cli.main --device cpu`, each output file held against
the JAX package's CLI on the same frames.

Tolerance: EPE ratio (mean end-point error over the JAX result's mean
magnitude; for depth the same on one parameter) <= 1e-3, the port-vs-JAX
budget of tests/test_torch_dis.py: the port's extraction is exact float32
where the JAX CPU path reads bf16 hi/lo planes, and float32 sums run in
another order; the GN trips carry that into the result.

Two cases get 2e-2: their frames move by whole pixels, (-2, 0) and (2, 1),
and these small frames end at full resolution (level 0), so converged
patches sit on the boundary between two bilinear anchors
(ceil(pt + 1e-5)), where one float32 ulp of the sum order decides the
cell, as in tests/test_torch_dis_op34.py. Measured 1.42e-2 (depth 39x101)
and 9.1e-3 (77x115). The same runs stopped at the first level where the
motion is subpixel agree to 1.6e-6 and 2.2e-6, and the same frames moved
0.1 px further agree within the 1e-3 budget (measured 3.8e-7 and 7.1e-7;
the last test)."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from of_dis_tpu import cli as jcli  # noqa: E402
from of_dis_tpu.utils import io as jio  # noqa: E402
from of_dis_tpu_torch import cli  # noqa: E402
from of_dis_tpu_torch.utils import io  # noqa: E402
from tests.test_edge_sizes import _frames  # noqa: E402

# whole-pixel motion ending at full resolution: the anchor's knife edge
WHOLE_PIXEL_BUDGET = 2e-2


def _both(tmp_path, mode, p1, p2, op, suffix):
    """The port's and the JAX CLI's outputs for one pair."""
    ours, ref = (str(tmp_path / f"{who}{suffix}") for who in ("port", "jax"))
    cli.main([mode, p1, p2, ours, op, "--quiet", "--device", "cpu"])
    jcli.main([mode, p1, p2, ref, op, "--quiet"])
    if suffix == ".flo":
        return io.read_flo(ours), jio.read_flo(ref)
    return io.read_pfm(ours)[..., None], jio.read_pfm(ref)[..., None]


def _epe_ratio(ours, ref):
    d = np.linalg.norm(ours - ref, axis=-1)
    return d.mean() / np.linalg.norm(ref, axis=-1).mean()


@pytest.mark.parametrize("mode,h,w,noc,op,shift,budget", [
    ("run_OF_INT", 33, 47, 1, "2", (1.5, 0.5), 1e-3),
    ("run_OF_INT", 41, 129, 1, "2", (1.5, 0.5), 1e-3),
    ("run_OF_INT", 97, 61, 1, "2", (1.5, 0.5), 1e-3),
    ("run_OF_RGB", 45, 83, 3, "1", (1.5, 0.5), 1e-3),
    # a negative-x shift: negative disparity, valid for the left camera
    ("run_DE_INT", 39, 101, 1, "2", (-2.0, 0.0), WHOLE_PIXEL_BUDGET)])
def test_cli_odd_sizes_match_jax(tmp_path, mode, h, w, noc, op, shift,
                                 budget):
    p1, p2 = _frames(tmp_path, h, w, noc, flow=shift)
    suffix = ".flo" if mode.startswith("run_OF") else ".pfm"
    ours, ref = _both(tmp_path, mode, p1, p2, op, suffix)
    assert ours.shape == ref.shape == (h, w, 2 if suffix == ".flo" else 1)
    assert np.isfinite(ours).all()
    if suffix == ".pfm":
        assert ours.max() <= 0.0
    assert _epe_ratio(ours, ref) <= budget


def test_cli_recovers_translation_odd_size_as_jax(tmp_path):
    h, w = 77, 115
    true = (2.0, 1.0)
    p1, p2 = _frames(tmp_path, h, w, 1, flow=true, seed=3)
    ours, ref = _both(tmp_path, "run_OF_INT", p1, p2, "2", ".flo")
    assert ours.shape == ref.shape == (h, w, 2)
    assert _epe_ratio(ours, ref) <= WHOLE_PIXEL_BUDGET
    inner = ours[12:-12, 12:-12]
    err = np.hypot(inner[..., 0] - true[0], inner[..., 1] - true[1]).mean()
    assert err < 0.4, err


@pytest.mark.parametrize("mode,h,w,shift,seed,suffix", [
    ("run_DE_INT", 39, 101, (-2.1, 0.0), 0, ".pfm"),
    ("run_OF_INT", 77, 115, (2.1, 1.1), 3, ".flo")])
def test_whole_pixel_cases_moved_subpixel_match_jax(tmp_path, mode, h, w,
                                                    shift, seed, suffix):
    """The two whole-pixel cases with their frames moved 0.1 px further:
    no patch sits on an anchor boundary, and the port agrees with JAX
    within the common budget."""
    p1, p2 = _frames(tmp_path, h, w, 1, flow=shift, seed=seed)
    ours, ref = _both(tmp_path, mode, p1, p2, "2", suffix)
    assert ours.shape == ref.shape
    assert _epe_ratio(ours, ref) <= 1e-3
