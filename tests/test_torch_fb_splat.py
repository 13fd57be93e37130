"""K8, the forward-backward merge's splat (`kernels/fb_splat.py`), against
its plain twin `ops.densify._backward_splat`, on the card.

Every test here needs an NVIDIA GPU with nvcc and is marked `cuda`;
without a card each one skips. On the card, without JAX (the conftest
imports it), run:

    python -m pytest --noconftest -m cuda tests/test_torch_fb_splat.py

Against the benchmark's reference splat (`dis_bench/reference/
dis_flow_fb.py::splat`, a scatter written on its own) the kernel is equal
bit for bit: both form each tap's term w * ty * tx alike and sum a
pixel's terms in float64 in the same stated order.

Tolerance against the twin: the twin groups a footprint row's two x-taps
before its y-tap and adds in its matrix products' order (with fused
multiply-adds), so the float64 sums differ by a few units of 2^-53 of the
sum of their terms' magnitudes, and their float32 roundings by at most
one float32 step (2^-23 relative) where a sum lies that close to a
rounding boundary: rtol 2^-23, atol 1e-9 of the plane's largest magnitude
(sums that cancel)."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from of_dis_tpu_torch import trace
from of_dis_tpu_torch.kernels import fb_splat
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import densify, patch_solver
from of_dis_tpu_torch.params import make_level_spec, op_point_params

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]
RTOL = 2.0 ** -23
ATOL = 1e-9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# op-2's finest level (L3) and op-4's L2 at 1024x448; op-4's L2 for depth
LEVELS = [(2, 3, 2), (4, 2, 2), (4, 2, 1)]


def _result(spec, params, b, seed):
    """A seeded complementary grid's `PatchResult`: converged positions
    around the grid, some at and beyond every border, residuals near 0
    and 1 and exactly 0, pweight from MINERRVAL (2) to 1e7."""
    rng = np.random.default_rng(seed)
    nop, psz, n = params.nop, params.p_samp_s, spec.nopatches
    ref = patch_solver.grid_ref_points(spec).numpy()
    p = (rng.standard_normal((b, n, nop)) * 2.5).astype(np.float32)
    move = p if nop == 2 else np.concatenate([p, np.zeros_like(p)], -1)
    pt = (ref[None] + move).astype(np.float32)
    h, w = spec.height, spec.width
    spots = [(0.0, 0.0), (-psz / 2 - 1.0, 3.0), (1.0, -psz / 2 + 0.5),
             (w - 1.0, h - 1.0), (w + psz / 2 - 2.0, h / 2),
             (w / 2, h + psz / 2 - 2.0), (w + 20.0, h + 20.0),
             (-40.0, -40.0), (psz / 2 + 1e-7, psz / 2 - 1e-7),
             (w / 3 + 0.9999999, h / 3 + 0.9999999),
             (w / 4 + 1e-6, h / 4 - 0.9999999), (5.0, 7.0)]
    for k, (x, y) in enumerate(spots):
        pt[:, 5 * k] = np.float32((x, y))
    pw = (2.0 + rng.random((b, psz, psz, n)) * 40).astype(np.float32)
    pw[:, :, :, ::7] = 2.0
    pw[:, 0, :, ::11] = 1e7
    return patch_solver.PatchResult(torch.from_numpy(p), torch.from_numpy(pt),
                                    torch.from_numpy(pw),
                                    torch.zeros((), dtype=torch.int32))


def _case(op, level, nop, b, seed):
    params = op_point_params(1024, op, nop=nop)
    spec = make_level_spec(level, 1024, 448, params)
    return params, spec, _result(spec, params, b, seed)


def _to(res, dev):
    return patch_solver.PatchResult(*(t.to(dev) for t in res))


def _assert_twin(got, want):
    for f in range(want.shape[1]):
        scale = float(want[:, f].abs().max())
        torch.testing.assert_close(got[:, f], want[:, f], rtol=RTOL,
                                   atol=ATOL * scale)


@pytest.mark.parametrize("op,level,nop", LEVELS)
def test_kernel_matches_the_twin(cuda, op, level, nop):
    params, spec, res = _case(op, level, nop, 3, 10 * op + nop)
    got = fb_splat.backward_splat(spec, params, (_to(res, cuda),))[0].cpu()
    want = densify._backward_splat(spec, params, res)
    assert got.shape == want.shape == (3, 1 + nop, spec.height, spec.width)
    assert float(want[:, 0].abs().max()) > 0
    _assert_twin(got, want)


@pytest.mark.parametrize("op,level", [(2, 3), (4, 2)])
def test_kernel_equals_the_benchmark_reference(cuda, op, level):
    from dis_bench.reference import dis_flow_fb

    params, spec, res = _case(op, level, 2, 3, 20 + op)
    res = _to(res, cuda)
    got = fb_splat.backward_splat(spec, params, (res,))[0]
    want = dis_flow_fb.splat(spec, params, res.p.transpose(1, 2),
                             res.pt.transpose(1, 2), res.pweight)
    assert torch.equal(got, want)


@pytest.mark.parametrize("op,level,nop", LEVELS)
def test_two_directions_in_one_launch_equal_each_alone(cuda, op, level,
                                                       nop):
    params, spec, fw = _case(op, level, nop, 2, 1)
    _, _, bw = _case(op, level, nop, 2, 2)
    fw, bw = _to(fw, cuda), _to(bw, cuda)
    n = trace.launches("fb_splat", "of_fb_splat")
    both = fb_splat.backward_splat(spec, params, (fw, bw))
    assert trace.launches("fb_splat", "of_fb_splat") == n + 1
    assert torch.equal(both[0], fb_splat.backward_splat(spec, params,
                                                        (fw,))[0])
    assert torch.equal(both[1], fb_splat.backward_splat(spec, params,
                                                        (bw,))[0])


def test_two_runs_give_the_same_bits(cuda):
    params, spec, res = _case(4, 2, 2, 4, 5)
    res = _to(res, cuda)
    a = fb_splat.backward_splat(spec, params, (res,))
    b = fb_splat.backward_splat(spec, params, (res,))
    assert torch.equal(a, b)


def test_a_batch_equals_its_parts(cuda):
    """Batch 8 equals four calls of batch 2, bit for bit: a pair's sums
    do not depend on the pairs beside it."""
    params, spec, res = _case(4, 2, 2, 8, 6)
    res = _to(res, cuda)
    whole = fb_splat.backward_splat(spec, params, (res,))[0]
    parts = torch.cat([fb_splat.backward_splat(spec, params, (
        patch_solver.PatchResult(res.p[i:i + 2], res.pt[i:i + 2],
                                 res.pweight[i:i + 2], res.iters),))[0]
        for i in range(0, 8, 2)])
    assert torch.equal(whole, parts)


def _frames(b, h, w, seed):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor((rng.random((b, 1, h, w)) * 255).astype(np.uint8))
    return x, torch.roll(x, (1, 2), (-2, -1))


def test_only_the_merge_launches_it(cuda):
    """Gray flow launches no `fb_splat`; with the merge, op-2 launches its
    splat once a level (three levels), the same flow on every call."""
    params = op_point_params(256, 2)
    a, b = (t.to(cuda) for t in _frames(2, 128, 256, 3))
    n = trace.launches("fb_splat")
    dis.dis_flow_batched(a, b, params, 256, 128, device=cuda)
    assert trace.launches("fb_splat") == n
    fb = dataclasses.replace(params, usefbcon=True)
    n = trace.launches("fb_splat", "of_fb_splat")
    flow = dis.dis_flow_batched(a, b, fb, 256, 128, device=cuda)
    assert trace.launches("fb_splat", "of_fb_splat") == n + 3
    assert torch.equal(flow, dis.dis_flow_batched(a, b, fb, 256, 128,
                                                  device=cuda))


def test_a_gray_process_does_not_load_the_library(cuda):
    """The library loads at the first merge: a process that computes gray
    flow only never loads it."""
    code = ("import torch\n"
            "from of_dis_tpu_torch.kernels import build\n"
            "from of_dis_tpu_torch.models import dis\n"
            "from of_dis_tpu_torch.params import op_point_params\n"
            "a = torch.zeros((1, 1, 128, 256), dtype=torch.uint8, "
            "device='cuda')\n"
            "dis.dis_flow_batched(a, a, op_point_params(256, 2), 256, 128)\n"
            "torch.cuda.synchronize()\n"
            "print(sorted(build._libs))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    libs = out.stdout.strip().splitlines()[-1]
    assert "gn_fused" in libs and "fb_splat" not in libs
