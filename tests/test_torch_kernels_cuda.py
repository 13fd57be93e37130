"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs an NVIDIA GPU with nvcc and is marked `cuda`; without
a card each one skips. Shapes are small and deliberately ragged (patch
counts that are no multiple of a block, a level larger than one block's
1024 threads, batch sizes that fill no warp). On the card, without JAX
(the conftest imports it), run:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances are those of chip_smoke.py, with the same reasons: the GN
twin sums each patch in the kernel's order and 12 dependent trips amplify
the rounding left (1e-3 px, pweight 1e-4 relative); the others repeat
their twin's float32 formulas (1e-4). The single-pair TV entries launch
the batched kernel with one block, so they equal row 0 of the batched
result bit for bit. The dot microbenchmark's sums of small integers are
exact in both types: equal to the twin. The GN stage ablation's twin sums
in the kernel's order (1e-6 of the largest checksum), and its variants
equal its A4 stage bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from of_dis_tpu_torch.kernels import (bilerp_extract, gn_fused, gn_stages,
                                      gn_tiled, i8_dot, tv_de_inner,
                                      tv_of_inner, upscale, warp)
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.ops import patch_solver, pyramid, tv
from of_dis_tpu_torch.params import make_level_spec, op_point_params
from of_dis_tpu_torch.tools import bench_gn_stages

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _frames(b, h, w, seed, c=1, half=False):
    rng = np.random.default_rng(seed)
    x = rng.random((b, c, h + 8, w + 8)) * 255
    k = np.ones(5) / 5
    for ax in (-1, -2):
        x = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax, x)
    a = x[:, :, 4:4 + h, 4:4 + w]
    bb = x[:, :, 3:3 + h, 2:2 + w]          # shifted by (2, 1) px
    if half:                                # by (1.5, 0.5) px
        bb = (bb + x[:, :, 3:3 + h, 3:3 + w] + x[:, :, 4:4 + h, 2:2 + w]
              + x[:, :, 4:4 + h, 3:3 + w]) / 4
    return (np.rint(a).astype(np.uint8), np.rint(bb).astype(np.uint8))


@pytest.mark.parametrize("nop,noc,camlr", [(2, 1, 0), (2, 3, 0), (1, 1, 0),
                                           (1, 1, 1), (1, 3, 0)])
@pytest.mark.parametrize("costfct,min_iter", [(0, 12), (1, 12), (2, 12),
                                              (0, 3)])
def test_gn_kernel_matches_plain(cuda, costfct, min_iter, nop, noc, camlr):
    params = dataclasses.replace(op_point_params(100, 2, nop=nop, noc=noc),
                                 costfct=costfct, min_iter=min_iter)
    a, b = (torch.as_tensor(x, device=cuda)
            for x in _frames(3, 44, 100, 1, noc))
    spec = make_level_spec(0, 100, 44, params, camlr=camlr)
    ims, dxs, dys = pyramid.build_pyramid(a, 0, params.p_samp_s)
    imb, _, _ = pyramid.build_pyramid(b, 0, params.p_samp_s, getgrad=False)
    tpl = patch_solver.extract_templates(spec, params, ims[0], dxs[0], dys[0])
    rng = np.random.default_rng(costfct)
    p0 = torch.as_tensor(rng.standard_normal((3, nop, spec.nopatches)) * 3,
                         dtype=torch.float32, device=cuda)
    pt_ref = patch_solver.grid_ref_points(spec, cuda).T[None].contiguous()
    before = gn_fused.launches
    p_k, pw_k, it_k = gn_fused.gn_fused(spec, params, imb[0], tpl, p0, pt_ref)
    assert gn_fused.launches == before + 1
    p_p, pw_p, it_p, _ = patch_solver._gn_plain(spec, params, imb[0], tpl, p0,
                                                pt_ref)
    assert p_k.shape == (3, nop, spec.nopatches)
    assert pw_k.shape == (3, 64, spec.nopatches)
    assert int(it_k) == int(it_p)
    assert float((p_k - p_p).abs().max()) <= 1e-3
    assert float((pw_k - pw_p).abs().max()) <= 1e-4 * float(pw_p.abs().max())
    if nop == 1:
        # the clamp holds wherever the parameter moved off its start
        moved = p_k != p0
        assert bool((p_k[moved] <= 0).all() if camlr == 0
                    else (p_k[moved] >= 0).all())


@pytest.mark.parametrize("nop,noc,camlr", [(2, 1, 0), (2, 3, 0), (1, 1, 0),
                                           (1, 1, 1), (1, 3, 0)])
@pytest.mark.parametrize("psz,costfct,patnorm,min_iter", [
    (12, 0, 1, 16), (12, 1, 1, 16), (12, 2, 0, 16), (12, 0, 1, 3),
    (8, 0, 1, 16), (4, 0, 1, 16), (9, 0, 1, 16)])
def test_gn_tiled_kernel_matches_plain(cuda, psz, costfct, patnorm, min_iter,
                                       nop, noc, camlr):
    """K6 against `_gn_tiled_plain` for every template instance the
    wrapper can reach (pixels per lane 1, 2, 3, 5; gray and RGB), on a
    ragged patch count, with starts large enough to reset and to begin
    outside. The twin sums in the kernel's order: 1e-3 px over 16 trips."""
    params = dataclasses.replace(
        op_point_params(100, 3, nop=nop, noc=noc), sc_f=0, sc_l=0,
        p_samp_s=psz, costfct=costfct, patnorm=patnorm, min_iter=min_iter)
    a, b = (torch.as_tensor(x, device=cuda)
            for x in _frames(3, 44, 100, 1, noc))
    spec = make_level_spec(0, 100, 44, params, camlr=camlr)
    src = tuple(f[0] for f in pyramid.build_pyramid(a, 0, psz))
    imb, _, _ = pyramid.build_pyramid(b, 0, psz, getgrad=False)
    rng = np.random.default_rng(costfct + psz)
    p0 = torch.as_tensor(rng.standard_normal((3, nop, spec.nopatches)) * 4,
                         dtype=torch.float32, device=cuda)
    pt_ref = patch_solver.grid_ref_points(spec, cuda).T[None].contiguous()
    before = gn_tiled.launches
    p_k, pw_k, it_k = gn_tiled.gn_tiled(spec, params, imb[0], src, p0, pt_ref)
    assert gn_tiled.launches == before + 1
    p_p, pw_p, it_p, _ = patch_solver._gn_tiled_plain(spec, params, imb[0],
                                                      src, p0, pt_ref)
    assert p_k.shape == (3, nop, spec.nopatches)
    assert pw_k.shape == (3, psz * psz, spec.nopatches)
    assert int(it_k) == int(it_p)
    assert float((p_k - p_p).abs().max()) <= 1e-3
    assert float((pw_k - pw_p).abs().max()) <= 1e-4 * float(pw_p.abs().max())
    if nop == 1:
        moved = p_k != p0
        assert bool((p_k[moved] <= 0).all() if camlr == 0
                    else (p_k[moved] >= 0).all())


def test_gn_tiled_rejects_what_the_kernel_does_not_take(cuda):
    params = dataclasses.replace(op_point_params(100, 3), sc_f=0, sc_l=0)
    spec = make_level_spec(0, 100, 44, params)
    planes = torch.zeros((1, 1, 44 + 24, 100 + 24), device=cuda)
    pt_ref = patch_solver.grid_ref_points(spec, cuda).T[None].contiguous()
    p0 = torch.zeros((1, 2, spec.nopatches), device=cuda)
    with pytest.raises(ValueError, match="im_a"):
        gn_tiled.gn_tiled(spec, params, planes, (planes[:, :, 1:],) * 3, p0,
                          pt_ref)
    with pytest.raises(ValueError, match="above 12"):
        gn_tiled.gn_tiled(spec, dataclasses.replace(params, p_samp_s=13),
                          planes, (planes,) * 3, p0, pt_ref)


@pytest.mark.parametrize("psz,noc,n", [(16, 1, 1000), (16, 3, 37),
                                       (12, 1, 33), (8, 3, 257), (5, 1, 1)])
def test_bilerp_extract_kernel_matches_plain(cuda, psz, noc, n):
    """K7 against `extract_bilinear` on ragged patch counts: positions in
    the interior, on both validity borders, on whole pixels, and far
    outside (clamped window). The same three float32 lerps: equal."""
    rng = np.random.default_rng(psz + noc + n)
    h, w = 44, 100
    im = torch.as_tensor(rng.random((3, noc, h + 2 * psz, w + 2 * psz)) * 255,
                         dtype=torch.float32, device=cuda)
    pts = np.stack([rng.uniform(-psz / 2, w + psz // 2 - 2, (3, n)),
                    rng.uniform(-psz / 2, h + psz // 2 - 2, (3, n))], -1)
    pts[0, 0] = (-psz / 2, -psz / 2)
    pts[1, 0] = (w + psz // 2 - 2, h + psz // 2 - 2)
    pts[2, 0] = (-500.0, 1e4)
    pts[:, n // 2:n // 2 + 5] = np.rint(pts[:, n // 2:n // 2 + 5])
    pts = torch.as_tensor(pts, dtype=torch.float32, device=cuda)
    before = bilerp_extract.launches
    o_k = bilerp_extract.bilerp_extract(im, pts, psz, psz)
    assert bilerp_extract.launches == before + 1
    o_p = patch_solver.extract_bilinear(im, pts, psz, psz)
    assert o_k.shape == o_p.shape == (3, psz * psz * noc, n)
    assert float((o_k - o_p).abs().max()) <= 1e-4
    with pytest.raises(ValueError, match="contiguous"):
        bilerp_extract.bilerp_extract(im, torch.cat([pts, pts], 1)[:, ::2],
                                      psz, psz)


@pytest.mark.parametrize("nop,noc", [(2, 1), (1, 3)])
def test_unfused_route_on_the_card_matches_cpu_path(cuda, nop, noc):
    """Patch size 16 through `dis_flow_batched`: neither GN kernel
    launches, the extraction kernel once at the start of a level and once
    per trip, and the result follows the CPU plain path (half-pixel
    frames, see the op-3 test below)."""
    a, b = _frames(2, 96, 256, 7, noc, half=True)
    if nop == 1:
        a, b = b, a
    params = dataclasses.replace(op_point_params(256, 3, nop=nop, noc=noc),
                                 p_samp_s=16, sc_f=3, sc_l=1)
    assert patch_solver.uses_unfused(params)
    counts = (gn_fused.launches, gn_tiled.launches, bilerp_extract.launches)
    ours = dis.dis_flow_batched(a, b, params, 256, 96, device="cuda")
    grown = (gn_fused.launches - counts[0], gn_tiled.launches - counts[1],
             bilerp_extract.launches - counts[2])
    assert grown[:2] == (0, 0)
    assert 3 * 2 <= grown[2] <= 3 * (1 + params.max_iter)
    ref = dis.dis_flow_batched(a, b, params, 256, 96, device="cpu")
    d = torch.linalg.vector_norm(ours.cpu() - ref, dim=-1).mean()
    assert float(d / torch.linalg.vector_norm(ref, dim=-1).mean()) < 1e-3


def test_kernel_path_matches_cpu_path_op3_fbcon(cuda):
    """op-3 with the forward-backward merge on the card against the CPU
    plain path, and two calls on the card equal to the bit. The frames
    move by half pixels: at full resolution a whole-pixel shift parks the
    converged patches on the boundary between two bilinear anchors, where
    one ulp of the CPU's and the card's matrix products decides the cell."""
    a, b = _frames(2, 96, 256, 7, half=True)
    params = dataclasses.replace(op_point_params(256, 3), usefbcon=True)
    counts = (gn_fused.launches, gn_tiled.launches)
    ours = dis.dis_flow_batched(a, b, params, 256, 96, device="cuda")
    n_lv = params.sc_f - params.sc_l + 1
    grown = (gn_fused.launches - counts[0], gn_tiled.launches - counts[1])
    assert sum(grown) == 2 * n_lv and grown[1] >= 2
    assert torch.equal(ours, dis.dis_flow_batched(a, b, params, 256, 96,
                                                  device="cuda"))
    ref = dis.dis_flow_batched(a, b, params, 256, 96, device="cpu")
    d = torch.linalg.vector_norm(ours.cpu() - ref, dim=-1).mean()
    assert float(d / torch.linalg.vector_norm(ref, dim=-1).mean()) < 1e-3


def _tv_inputs(cuda, b, c, h, w, seed, depth=False):
    rng = np.random.default_rng(seed)
    im1, im2 = (torch.as_tensor(rng.random((b, c, h, w)) * 255,
                                dtype=torch.float32, device=cuda)
                for _ in range(2))
    wx, wy = (torch.as_tensor(rng.standard_normal((b, h, w)) * 1.5,
                              dtype=torch.float32, device=cuda)
              for _ in range(2))
    if depth:
        wy = torch.zeros_like(wx)
    w_im2, mask = tv.warp_image(im2, wx, wy)
    deriv = torch.stack(tv.get_derivatives(im1, w_im2), dim=1).contiguous()
    return im1, im2, wx, wy, mask, deriv


def _i_list(deriv):
    return [d.movedim(1, 0) for d in deriv.unbind(1)]


@pytest.mark.parametrize("noc", [1, 3])
@pytest.mark.parametrize("h,w,delta,parity", [(14, 32, 5.0, 0),
                                              (37, 61, 0.0, 1)])
def test_tv_kernel_matches_plain(cuda, h, w, delta, parity, noc):
    _, _, wx, wy, mask, deriv = _tv_inputs(cuda, 3, noc, h, w, h)
    qa, hd3, hg3 = tv.tv_coefficients(10.0, 10.0, delta)
    kw = dict(quarter_alpha=qa, hd3=hd3, hg3=hg3, n_inner=3, n_solver=3,
              omega=1.6, row_parity=parity)
    before = tv_of_inner.launches
    uu_k, vv_k = tv_of_inner.of_inner(wx, wy, mask, deriv, **kw)
    assert tv_of_inner.launches == before + 1
    uu_p, vv_p = tv._of_inner_loop(wx, wy, mask, _i_list(deriv), noc=noc,
                                   **kw)
    assert float((uu_k - uu_p).abs().max()) <= 1e-4
    assert float((vv_k - vv_p).abs().max()) <= 1e-4


@pytest.mark.parametrize("noc", [1, 3])
@pytest.mark.parametrize("h,w,delta,parity,camlr", [(14, 32, 5.0, 0, 0),
                                                    (37, 61, 0.0, 1, 1),
                                                    (33, 40, 5.0, 1, 0)])
def test_tv_de_kernel_matches_plain(cuda, h, w, delta, parity, camlr, noc):
    _, _, wx, _, mask, deriv = _tv_inputs(cuda, 3, noc, h, w, h + 1,
                                          depth=True)
    qa, hd3, hg3 = tv.tv_coefficients(10.0, 10.0, delta)
    kw = dict(camlr=camlr, quarter_alpha=qa, hd3=hd3, hg3=hg3, n_inner=3,
              n_solver=3, omega=1.6, row_parity=parity)
    before = tv_de_inner.launches
    uu_k = tv_de_inner.de_inner(wx, mask, deriv, **kw)
    assert tv_de_inner.launches == before + 1
    uu_p = tv._de_inner_loop(wx, mask, _i_list(deriv), noc=noc, **kw)
    assert float((uu_k - uu_p).abs().max()) <= 1e-4
    assert bool((uu_k <= 0).all() if camlr == 0 else (uu_k >= 0).all())


@pytest.mark.parametrize("noc", [1, 3])
def test_single_pair_tv_entries_match_plain_and_batched_row(cuda, noc):
    """ref_level_of / ref_level_de on one unbatched pair: one block of the
    batched kernel, its own launch count, equal to the batched row."""
    im1, im2, wx, wy, _, _ = _tv_inputs(cuda, 2, noc, 37, 61, 5)
    kw = dict(alpha=10.0, gamma=10.0, delta=5.0, n_inner=2, n_solver=3,
              omega=1.6)
    counts = (tv_of_inner.launches, tv_of_inner.launches_single,
              tv_de_inner.launches, tv_de_inner.launches_single)
    uu, vv = tv.ref_level_of(wx[0], wy[0], im1[0], im2[0], **kw)
    dd = tv.ref_level_de(-wx[0].abs(), im1[0], im2[0], camlr=0, **kw)
    assert (tv_of_inner.launches, tv_of_inner.launches_single,
            tv_de_inner.launches, tv_de_inner.launches_single) == (
        counts[0], counts[1] + 1, counts[2], counts[3] + 1)
    assert uu.shape == vv.shape == dd.shape == (37, 61)
    bu, bv = tv.ref_level_of_batched(wx, wy, im1, im2, **kw)
    bd = tv.ref_level_de_batched(-wx.abs(), im1, im2, camlr=0, **kw)
    assert torch.equal(uu, bu[0]) and torch.equal(vv, bv[0])
    assert torch.equal(dd, bd[0])
    cu, cv = tv.ref_level_of(wx[0].cpu(), wy[0].cpu(), im1[0].cpu(),
                             im2[0].cpu(), **kw)
    cd = tv.ref_level_de(-wx[0].abs().cpu(), im1[0].cpu(), im2[0].cpu(),
                         camlr=0, **kw)
    assert float((uu.cpu() - cu).abs().max()) <= 1e-4
    assert float((vv.cpu() - cv).abs().max()) <= 1e-4
    assert float((dd.cpu() - cd).abs().max()) <= 1e-4


@pytest.mark.parametrize("c", [1, 3])
def test_warp_kernel_matches_plain(cuda, c):
    rng = np.random.default_rng(c)
    src = torch.as_tensor(rng.random((2, c, 23, 41)) * 255,
                          dtype=torch.float32, device=cuda)
    wx, wy = (torch.as_tensor(rng.standard_normal((2, 23, 41)) * 6,
                              dtype=torch.float32, device=cuda)
              for _ in range(2))
    wx[:, 0] = 1e6                       # far outside: clamped corners
    o_k, m_k = warp.warp_image_batched(src, wx, wy)
    o_p, m_p = tv.warp_image(src, wx, wy)
    assert float((o_k - o_p).abs().max()) <= 1e-4
    assert torch.equal(m_k, m_p)


@pytest.mark.parametrize("nop", [2, 1])
def test_upscale_kernel_matches_plain(cuda, nop):
    flow = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (3, 7, 13, nop)), dtype=torch.float32, device=cuda)
    o_k = upscale.upscale_batched(flow, 3, 56, 104)
    o_p = dis.upscale_output(flow, 3, 56, 104)
    assert float((o_k - o_p).abs().max()) <= 1e-4


@pytest.mark.parametrize("nop,noc", [(2, 1), (2, 3), (1, 1), (1, 3)])
def test_kernel_path_matches_cpu_path(cuda, nop, noc):
    """dis_flow_batched on the card (every kernel) against the CPU plain
    path: EPE ratio below 1e-3, for flow and depth, gray and RGB."""
    a, b = _frames(2, 96, 256, 7, noc)
    if nop == 1:
        a, b = b, a                       # disparity of the left camera <= 0
    params = op_point_params(256, 2, nop=nop, noc=noc)
    assert params.sc_l > 0                # the upscale runs
    tv_mod = tv_of_inner if nop == 2 else tv_de_inner
    mods = (gn_fused, tv_mod, warp, upscale)
    counts = [m.launches for m in mods]
    ours = dis.dis_flow_batched(a, b, params, 256, 96, device="cuda").cpu()
    grown = [m.launches - c for m, c in zip(mods, counts)]
    n_lv = params.sc_f - params.sc_l + 1
    assert grown == [n_lv, n_lv, n_lv, 1]
    ref = dis.dis_flow_batched(a, b, params, 256, 96, device="cpu")
    assert ours.shape == ref.shape == (2, 96, 256, nop)
    d = torch.linalg.vector_norm(ours - ref, dim=-1).mean()
    assert float(d / torch.linalg.vector_norm(ref, dim=-1).mean()) < 1e-3
    assert float(torch.linalg.vector_norm(ref, dim=-1).mean()) > 0.5


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,reps,grid", [(40, 48, 24, 3, 2),
                                             (130, 160, 72, 2, 3),
                                             (17, 256, 8, 1, 1)])
def test_i8_dot_kernel_matches_plain(cuda, dtype, m, k, n, reps, grid):
    """Ragged m and n (no multiple of the 64 x 64 tile), k below and above
    one 128-byte slice, every rep's B block a different one."""
    rng = np.random.default_rng(m)
    a = torch.as_tensor(rng.integers(-127, 127, (m, k), np.int8))
    bt = torch.as_tensor(rng.integers(-3, 4, (reps * n, k), np.int8))
    a, bt = a.to(cuda, dtype), bt.to(cuda, dtype)
    before = i8_dot.launches
    out = i8_dot.dot_sum(a, bt, n, grid)
    assert i8_dot.launches == before + 1
    assert out.shape == (grid, m, n) and out.dtype == i8_dot.ACC[dtype]
    assert torch.equal(out, i8_dot._plain(a, bt, n, grid))


def test_i8_dot_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros((8, 24), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        i8_dot.dot_sum(a, torch.zeros((16, 24), dtype=torch.int8,
                                      device=cuda), 8, 1)
    with pytest.raises(ValueError, match="int8 or both bfloat16"):
        i8_dot.dot_sum(a, torch.zeros((16, 24), dtype=torch.bfloat16,
                                      device=cuda), 8, 1)


@pytest.mark.parametrize("psz,edge", [(5, False), (8, False), (12, False),
                                      (12, True)])
def test_gn_stages_kernel_matches_plain(cuda, psz, edge):
    """Every stage against the twin and every variant equal to A4, at
    patch sizes of 1, 2 and 5 pixels a lane, 37 patches (a ragged last
    block); with `edge` the anchors run past the plane's borders, where
    the taps and the shared-memory window clamp."""
    geom = bench_gn_stages.Geometry(psz, 40, 60, 37, 7, 2, 3,
                                    40 - psz - 3)
    x = bench_gn_stages.make_inputs(geom, 3, cuda)
    if edge:
        x["sx0"][:, ::2] += 30
        x["sy0"][:, 1::3] -= 9
    a4 = None
    for _, stage, variant in bench_gn_stages.RUNS:
        args = bench_gn_stages.call_args(x, geom, stage, variant)
        out = gn_stages.gn_stages(*args)
        ref = gn_stages._plain(*args)
        err = float((out - ref).abs().max())
        assert err <= 1e-6 * float(ref.abs().max()), (stage, variant, err)
        if stage == "A4" and not variant:
            a4 = out
        assert not variant or torch.equal(out, a4), variant
