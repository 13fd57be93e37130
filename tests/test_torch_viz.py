"""The port's flow visualization (`of_dis_tpu_torch.utils.viz`) against
the JAX package's: `flow_to_color` bit for bit, the zlib PNG writer read
back by OpenCV and by the port's own decoder, and `main` on a .flo
file."""

import numpy as np
import pytest

from of_dis_tpu.utils import viz as jax_viz
from of_dis_tpu_torch.native import io as nio
from of_dis_tpu_torch.utils import io as uio
from of_dis_tpu_torch.utils import viz


def _flow(seed, h=31, w=47, scale=6.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((h, w, 2)) * scale).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_flow", [None, 2.5, 40.0])
def test_flow_to_color_equals_jax(seed, max_flow):
    flow = _flow(seed)
    ours = viz.flow_to_color(flow, max_flow)
    assert ours.dtype == np.uint8 and ours.shape == (31, 47, 3)
    np.testing.assert_array_equal(ours, jax_viz.flow_to_color(flow,
                                                              max_flow))


def test_zero_flow_and_wheel_equal_jax():
    flow = np.zeros((9, 13, 2), np.float32)
    np.testing.assert_array_equal(viz.flow_to_color(flow),
                                  jax_viz.flow_to_color(flow))
    np.testing.assert_array_equal(viz._color_wheel(),
                                  jax_viz._color_wheel())


@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (1, 1), (6, 2, 3)])
def test_write_png_reads_back(tmp_path, shape):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / "w.png")
    viz.write_png(p, img)
    ch = 1 if img.ndim == 2 else 3
    want = img[None] if ch == 1 else img[..., ::-1].transpose(2, 0, 1)
    np.testing.assert_array_equal(nio.decode_batch([p], ch)[0], want)
    np.testing.assert_array_equal(uio.load_image(p, ch), want)
    cv2 = pytest.importorskip("cv2")
    back = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back if ch == 1 else back[..., ::-1], img)


def test_png_rows_use_every_filter():
    img = np.random.default_rng(0).integers(0, 256, (12, 8), dtype=np.uint8)
    rows = np.frombuffer(viz.png_rows(img), np.uint8).reshape(12, 9)
    assert rows[:, 0].tolist() == [y % 5 for y in range(12)]


def test_write_png_refuses_other_images(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        viz.write_png(str(tmp_path / "x.png"), np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        viz.write_png(str(tmp_path / "x.png"), np.zeros((4, 4, 4), np.uint8))


@pytest.mark.parametrize("argv_tail", [[], ["3.0"]])
def test_main_on_a_flo_file(tmp_path, argv_tail):
    flow = _flow(9)
    f = str(tmp_path / "f.flo")
    uio.write_flo(f, flow)
    out = str(tmp_path / "viz.png")
    assert viz.main([f, out] + argv_tail) == 0
    max_flow = float(argv_tail[0]) if argv_tail else None
    want = jax_viz.flow_to_color(flow, max_flow)      # RGB
    np.testing.assert_array_equal(nio.decode_batch([out], 3)[0],
                                  want[..., ::-1].transpose(2, 0, 1))
