"""The six seeded configurations of tests/test_fuzz_params.py (the same
draw over the reference's 20-parameter surface, the same pairs at 64x128)
through the port's `dis_flow` on the CPU against the JAX package's
`dis.dis_flow` on the same inputs.

Budget: the port's end-to-end budget against JAX, an EPE ratio (mean
end-point error over the mean flow) of 1e-3 (tests/test_torch_mesh.py),
floored at 1e-3 of the JAX file's 0.02 px floor for fields near zero.
The draw turns TV refinement off in all six, so each configuration also
runs with it on (`usetvref=True`, the drawn TV weights), the TV loop's
interactions with the other knobs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

from of_dis_tpu.models import dis as jdis
from of_dis_tpu.params import DISParams as JaxParams
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.params import DISParams
from tests.test_fuzz_params import _pair, _random_config

EPE_RATIO = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes run one torch thread (see tests/test_torch_mesh.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("tv", ["drawn", "on"])
@pytest.mark.parametrize("seed", range(6))
def test_fuzzed_config_matches_jax(seed, tv):
    # the draw of tests/test_fuzz_params.py, in its order
    rng = np.random.default_rng(1000 + seed)
    cfg = _random_config(rng)
    if tv == "on":
        cfg["usetvref"] = True
    h, w = 64, 128
    sc_f = int(rng.integers(1, 3))
    flow = (float(rng.uniform(-3, 3)), float(rng.uniform(-2, 2)))
    img_a, img_b = _pair(h, w, flow, seed=2000 + seed)

    ref = np.asarray(jdis.dis_flow(
        jnp.asarray(img_a), jnp.asarray(img_b),
        JaxParams(sc_f=sc_f, sc_l=0, noc=1, nop=2, **cfg), w, h))
    ours = dis.dis_flow(img_a, img_b,
                        DISParams(sc_f=sc_f, sc_l=0, noc=1, nop=2, **cfg),
                        w, h, device="cpu").numpy()
    assert ours.shape == ref.shape == (h, w, 2)
    epe = float(np.linalg.norm(ours - ref, axis=-1).mean())
    mag = float(np.linalg.norm(ref, axis=-1).mean())
    assert epe <= EPE_RATIO * max(mag, 0.02), (cfg, sc_f, flow, epe, mag)


def test_chip_smoke_holds_the_draw_of_seed_0():
    """chip_smoke.py sends seed 0's configuration through the card (it
    imports nothing of the tests): its copy is the draw."""
    import chip_smoke
    rng = np.random.default_rng(1000)
    assert chip_smoke.FUZZ_SEED0 == _random_config(rng)
    assert chip_smoke.FUZZ_SEED0_SC_F == int(rng.integers(1, 3))
