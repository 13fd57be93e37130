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
their twin's float32 formulas (1e-4; the flow TV loop on either route
and the depth TV loop on every route and cluster size equal their twins,
error 0; the patch extraction too, at every window tile). The single-pair TV entries launch the batched
kernel for one pair, so they equal row 0 of the batched result bit for
bit. The warp repeats its twin's float32 operations in
their order (no contraction): equal to it, error 0. The dot
microbenchmark's sums of small integers are exact in both types: equal
to the twin. The GN stage ablation's twin sums
in the kernel's order (1e-6 of the largest checksum), and its variants
equal its A4 stage bit for bit."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from of_dis_tpu_torch import trace
from of_dis_tpu_torch.kernels import (bilerp_extract, build, gn_fused,
                                      gn_stages,
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


def _tv_counts(lib):
    """Launches of a TV library's batched and single-pair C entries."""
    return (trace.launches(lib, f"of_{lib}"),
            trace.launches(lib, f"of_{lib}_single"))


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
    before = trace.launches("gn_fused")
    p_k, pw_k, it_k = gn_fused.gn_fused(spec, params, imb[0], tpl, p0, pt_ref)
    assert trace.launches("gn_fused") == before + 1
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
    before = trace.launches("gn_tiled")
    p_k, pw_k, it_k = gn_tiled.gn_tiled(spec, params, imb[0], src, p0, pt_ref)
    assert trace.launches("gn_tiled") == before + 1
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
    before = trace.launches("bilerp_extract")
    o_k = bilerp_extract.bilerp_extract(im, pts, psz, psz)
    assert trace.launches("bilerp_extract") == before + 1
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
    counts = (trace.launches("gn_fused"), trace.launches("gn_tiled"),
              trace.launches("bilerp_extract"))
    ours = dis.dis_flow_batched(a, b, params, 256, 96, device="cuda")
    grown = (trace.launches("gn_fused") - counts[0],
             trace.launches("gn_tiled") - counts[1],
             trace.launches("bilerp_extract") - counts[2])
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
    counts = (trace.launches("gn_fused"), trace.launches("gn_tiled"))
    ours = dis.dis_flow_batched(a, b, params, 256, 96, device="cuda")
    n_lv = params.sc_f - params.sc_l + 1
    grown = (trace.launches("gn_fused") - counts[0],
             trace.launches("gn_tiled") - counts[1])
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
    before = trace.launches("tv_of_inner", "of_tv_of_inner")
    uu_k, vv_k = tv_of_inner.of_inner(wx, wy, mask, deriv, **kw)
    assert trace.launches("tv_of_inner", "of_tv_of_inner") == before + 1
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
    before = trace.launches("tv_de_inner", "of_tv_de_inner")
    uu_k = tv_de_inner.de_inner(wx, mask, deriv, **kw)
    assert trace.launches("tv_de_inner", "of_tv_de_inner") == before + 1
    uu_p = tv._de_inner_loop(wx, mask, _i_list(deriv), noc=noc, **kw)
    assert float((uu_k - uu_p).abs().max()) <= 1e-4
    assert bool((uu_k <= 0).all() if camlr == 0 else (uu_k >= 0).all())


@pytest.mark.parametrize("noc", [1, 3])
def test_single_pair_tv_entries_match_plain_and_batched_row(cuda, noc):
    """ref_level_of / ref_level_de on one unbatched pair: the batched
    kernel at B = 1, its own launch count, equal to the batched row."""
    im1, im2, wx, wy, _, _ = _tv_inputs(cuda, 2, noc, 37, 61, 5)
    kw = dict(alpha=10.0, gamma=10.0, delta=5.0, n_inner=2, n_solver=3,
              omega=1.6)
    counts = _tv_counts("tv_of_inner") + _tv_counts("tv_de_inner")
    uu, vv = tv.ref_level_of(wx[0], wy[0], im1[0], im2[0], **kw)
    dd = tv.ref_level_de(-wx[0].abs(), im1[0], im2[0], camlr=0, **kw)
    assert _tv_counts("tv_of_inner") + _tv_counts("tv_de_inner") == (
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


def _warp_batch(h, w, large):
    """3 pairs, or (`large`) enough pixels for the kernel's 4-pixel route
    on this card."""
    return -(-warp.vec_min_pixels(torch.device("cuda")) // (h * w)) \
        if large else 3


# (w, h, large): every width at both heights with 3 pairs (one pixel a
# thread), and a batch large enough for 4 pixels a thread at the widths
# that are a multiple of 4 (the others stay at one pixel a thread)
WARP_SHAPES = [(w, h, large) for w in (1, 3, 4, 5, 41, 128, 129)
               for h in (1, 8) for large in (False, True)
               if not large or (w % 4 == 0 and h * w >= 8)]


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("w,h,large", WARP_SHAPES)
def test_warp_kernel_equals_plain_on_ragged_widths(cuda, w, h, large, c):
    """One pixel a thread (small calls, ragged widths) and 4 on the vector
    route, with flows far outside the frame both ways: equal to the twin,
    masks equal."""
    b = _warp_batch(h, w, large)
    rng = np.random.default_rng(w * 100 + h * 10 + c)
    src = torch.as_tensor(rng.random((b, c, h, w)) * 255,
                          dtype=torch.float32, device=cuda)
    wx, wy = (torch.as_tensor(rng.standard_normal((b, h, w)) * 6,
                              dtype=torch.float32, device=cuda)
              for _ in range(2))
    wx[0, :, ::2] = 1e6
    wx[1, :, 1::3] = -1e6
    wy[2, :, ::3] = 1e6
    wy[1, -1, :] = -1e6
    o_k, m_k = warp.warp_image_batched(src, wx, wy)
    o_p, m_p = tv.warp_image(src, wx, wy)
    assert float((o_k - o_p).abs().max()) == 0.0
    assert torch.equal(m_k, m_p)


# (hs, h, row0, w, large): blocks of h rows at row origin row0 of a source
# of hs rows, first, inner and last blocks, odd and even origins, widths
# that are and are not a multiple of 4, and batches large enough for 4
# pixels a thread where the width allows
WARP_ROW0_SHAPES = [(37, 9, 0, 41, False), (37, 9, 13, 41, False),
                    (37, 9, 28, 5, False), (37, 37, 0, 3, False),
                    (150, 19, 19, 128, False), (150, 19, 57, 128, True),
                    (150, 40, 110, 64, True), (151, 27, 61, 129, True)]


@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("hs,h,row0,w,large", WARP_ROW0_SHAPES)
def test_warp_kernel_row_origin_equals_plain(cuda, hs, h, row0, w, large,
                                             c):
    """K3 on a block of rows sampling the whole source from its row origin
    (the row-sharded TV, parallel/spatial.py), with flows past every edge
    of the source: equal to the twin at the same origin, masks equal, and
    equal to the same rows of the whole-frame warp."""
    b = _warp_batch(h, w, large)
    rng = np.random.default_rng(hs + h + row0 + w + c)
    src = torch.as_tensor(rng.random((b, c, hs, w)) * 255,
                          dtype=torch.float32, device=cuda)
    wx, wy = (torch.as_tensor(rng.standard_normal((b, hs, w)) * 6,
                              dtype=torch.float32, device=cuda)
              for _ in range(2))
    wy[0, :, ::2] = 1e6
    wy[1, :, 1::3] = -1e6
    wy[2, :, ::5] = -(row0 + 0.5)          # just above the source's top
    wx[2, :, ::3] = 1e6
    bx, by = (f[:, row0:row0 + h].contiguous() for f in (wx, wy))
    o_k, m_k = warp.warp_image_batched(src, bx, by, row0=row0)
    o_p, m_p = tv.warp_image(src, bx, by, row0)
    assert tuple(o_k.shape) == (b, c, h, w)
    assert float((o_k - o_p).abs().max()) == 0.0
    assert torch.equal(m_k, m_p)
    o_f, m_f = warp.warp_image_batched(src, wx, wy)
    assert torch.equal(o_k, o_f[:, :, row0:row0 + h])
    assert torch.equal(m_k, m_f[:, row0:row0 + h])


def test_warp_kernel_on_unaligned_tensors(cuda):
    """Fields that start 4 bytes past a 16-byte boundary take one pixel a
    thread at a width that is a multiple of 4 and a batch large enough
    for four: equal to the twin."""
    rng = np.random.default_rng(5)
    c, h, w = 1, 6, 64
    b = _warp_batch(h, w, True)
    src = torch.as_tensor(rng.random((b, c, h, w)) * 255,
                          dtype=torch.float32, device=cuda)

    def field():
        x = torch.empty(b * h * w + 1, device=cuda)[1:].view(b, h, w)
        x.copy_(torch.as_tensor(rng.standard_normal((b, h, w)) * 4))
        return x

    wx, wy = field(), field()
    assert wx.data_ptr() % 16 and wx.is_contiguous()
    o_k, m_k = warp.warp_image_batched(src, wx, wy)
    o_p, m_p = tv.warp_image(src, wx, wy)
    assert torch.equal(o_k, o_p) and torch.equal(m_k, m_p)


@pytest.mark.parametrize("nop", [1, 2])
@pytest.mark.parametrize("sc_l", [1, 3])
@pytest.mark.parametrize("h,w,out_h,out_w", [(7, 13, 14, 26),
                                             (5, 131, 40, 1047),
                                             (3, 300, 9, 2398)])
def test_upscale_kernel_ragged_widths(cuda, nop, sc_l, h, w, out_h, out_w):
    """x2 and x8 value scales, output widths that are no multiple of 4
    and span several tiles: within 1e-4 px of the twin."""
    flow = torch.as_tensor(np.random.default_rng(h * w).standard_normal(
        (3, h, w, nop)), dtype=torch.float32, device=cuda)
    before = trace.launches("upscale")
    o_k = upscale.upscale_batched(flow, sc_l, out_h, out_w)
    assert trace.launches("upscale") == before + 1
    o_p = dis.upscale_output(flow, sc_l, out_h, out_w)
    assert o_k.shape == (3, out_h, out_w, nop)
    assert float((o_k - o_p).abs().max()) <= 1e-4


@pytest.mark.parametrize("name", ["gn_fused", "gn_tiled", "bilerp_extract",
                                  "tv_of_inner", "tv_de_inner", "warp",
                                  "upscale", "i8_dot", "gn_stages"])
def test_each_entry_is_bound_once(cuda, name):
    """Every wrapper's C entry is bound once: asked for twice, and around
    two launches of the warp and the upscale, it is the same object."""
    mod = importlib.import_module(f"of_dis_tpu_torch.kernels.{name}")
    fn = build.entry(name, f"of_{name}", mod._ARGTYPES)
    assert build.entry(name, f"of_{name}", mod._ARGTYPES) is fn
    assert fn.restype is not None and len(fn.argtypes) == len(mod._ARGTYPES)
    src = torch.ones((1, 1, 4, 8), device=cuda)
    f = torch.zeros((1, 4, 8), device=cuda)
    for _ in range(2):
        warp.warp_image_batched(src, f, f)
        upscale.upscale_batched(f[..., None], 1, 8, 16)
    assert build._entries[(name, f"of_{name}")] is fn


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
    counts = [trace.launches(m.NAME, f"of_{m.NAME}") for m in mods]
    ours = dis.dis_flow_batched(a, b, params, 256, 96, device="cuda").cpu()
    grown = [trace.launches(m.NAME, f"of_{m.NAME}") - c
             for m, c in zip(mods, counts)]
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
    before = trace.launches("i8_dot")
    out = i8_dot.dot_sum(a, bt, n, grid)
    assert trace.launches("i8_dot") == before + 1
    assert out.shape == (grid, m, n) and out.dtype == i8_dot.ACC[dtype]
    assert torch.equal(out, i8_dot._plain(a, bt, n, grid))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,reps,grid", [(832, 256, 256, 64, 64),
                                             (200, 256, 300, 3, 2),
                                             (100, 128, 40, 5, 1)])
def test_i8_dot_kernel_at_the_defaults_and_ragged_tiles(cuda, dtype, m, k,
                                                        n, reps, grid):
    """The tool's defaults (0/1 B as the tool draws it), and m no multiple
    of the block's 64-row halves with n past one 256-column tile or below
    it: TMA's zero fill beyond the arrays, the unstored columns of the next
    rep and the idle consumer half. Equal to the exact twin."""
    rng = np.random.default_rng(m + n)
    a = torch.as_tensor(rng.integers(-127, 127, (m, k), np.int8))
    bt = torch.as_tensor((rng.random((reps * n, k)) < 0.3).astype(np.int8)
                         * rng.integers(-3, 4, (reps * n, k), np.int8))
    a, bt = a.to(cuda, dtype), bt.to(cuda, dtype)
    out = i8_dot.dot_sum(a, bt, n, grid)
    assert torch.equal(out, i8_dot._plain(a, bt, n, grid))


def test_i8_dot_rejects_what_the_kernel_does_not_take(cuda):
    a = torch.zeros((8, 24), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        i8_dot.dot_sum(a, torch.zeros((16, 24), dtype=torch.int8,
                                      device=cuda), 8, 1)
    with pytest.raises(ValueError, match="int8 or both bfloat16"):
        i8_dot.dot_sum(a, torch.zeros((16, 24), dtype=torch.bfloat16,
                                      device=cuda), 8, 1)
    # A's stripe stays in shared memory: k * element size is bounded
    wide = torch.zeros((8, i8_dot.MAX_K_BYTES + 16), dtype=torch.int8,
                       device=cuda)
    with pytest.raises(ValueError, match="at most"):
        i8_dot.dot_sum(wide, wide, 8, 1)


@pytest.mark.parametrize("layout", [gn_stages.LANES, gn_stages.COLUMNS],
                         ids=["lanes", "columns"])
@pytest.mark.parametrize("psz,n,edge", [(4, 37, False), (5, 37, True),
                                        (8, 37, False), (8, 36, True),
                                        (12, 37, False), (12, 37, True),
                                        (12, 1, False)])
def test_gn_stages_kernel_matches_plain(cuda, psz, n, edge, layout):
    """Every stage against the twin and every variant equal to A4, on both
    layouts, at patch sizes of 1, 2 and 5 pixels a lane and 4 to 12
    columns (psz 8 and 12 their own instances: lanes 8, columns 12), 37
    patches (a ragged last block, and on columns a last warp whose second
    segment repeats the last patch), 36 and one; with `edge` the anchors
    run past the plane's borders, where the taps, the window columns and
    the shared-memory windows clamp."""
    geom = bench_gn_stages.Geometry(psz, 40, 60, n, 7, 2, 3, 40 - psz - 3,
                                    layout)
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


# ------------------------------------------------------ the TV loop (K2)

@pytest.mark.parametrize("route", ["cooperative", "block"])
@pytest.mark.parametrize("noc", [1, 3])
@pytest.mark.parametrize("b,h,w,parity,n_inner", [
    (1, 1, 1, 0, 1), (3, 7, 5, 1, 3), (3, 33, 129, 0, 3), (1, 33, 129, 1, 1),
    (64, 7, 5, 0, 3), (64, 72, 96, 1, 1)])
def test_tv_kernel_routes_equal_plain(cuda, monkeypatch, b, h, w, parity,
                                      n_inner, noc, route):
    """K2 on each route, whatever the shape rule would pick: one pixel and
    ragged levels, one and many pairs, both row parities, one and three
    inner iterations; the last shape (442,368 pixels) is larger than any
    cooperative grid of the card (2,048 threads an SM at most), so threads
    stride over several pixels. The twin's float32 operations per pixel,
    no contraction: equal to it (error 0; a 1x1 level has no edge weights,
    so omega / 0 makes both NaN alike)."""
    monkeypatch.setattr(tv_of_inner, "BLOCK_MAX_PIXELS",
                        0 if route == "cooperative" else h * w)
    assert tv_of_inner.cooperative(h, w) == (route == "cooperative")
    _, _, wx, wy, mask, deriv = _tv_inputs(cuda, b, noc, h, w, h * w + b)
    qa, hd3, hg3 = tv.tv_coefficients(10.0, 10.0, 5.0)
    kw = dict(quarter_alpha=qa, hd3=hd3, hg3=hg3, n_inner=n_inner,
              n_solver=3, omega=1.6, row_parity=parity)
    before = trace.launches("tv_of_inner", "of_tv_of_inner")
    uu_k, vv_k = tv_of_inner.of_inner(wx, wy, mask, deriv, **kw)
    assert trace.launches("tv_of_inner", "of_tv_of_inner") == before + 1
    uu_p, vv_p = tv._of_inner_loop(wx, wy, mask, _i_list(deriv), noc=noc,
                                   **kw)
    for k, p in ((uu_k, uu_p), (vv_k, vv_p)):
        torch.testing.assert_close(k, p, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("route", ["cooperative", "block"])
@pytest.mark.parametrize("n_inner,n_solver", [(0, 3), (2, 0), (1, 1)])
def test_tv_kernel_without_sweeps_or_iterations_equals_plain(
        cuda, monkeypatch, n_inner, n_solver, route):
    """The 20-parameter form may ask for no inner iteration (uu = wx) or no
    SOR sweep (du = 0, uu = wx after every iteration): both routes equal
    the twin."""
    monkeypatch.setattr(tv_of_inner, "BLOCK_MAX_PIXELS",
                        0 if route == "cooperative" else 10 ** 9)
    _, _, wx, wy, mask, deriv = _tv_inputs(cuda, 3, 1, 19, 23, 7)
    qa, hd3, hg3 = tv.tv_coefficients(10.0, 10.0, 5.0)
    kw = dict(quarter_alpha=qa, hd3=hd3, hg3=hg3, n_inner=n_inner,
              n_solver=n_solver, omega=1.6)
    uu_k, vv_k = tv_of_inner.of_inner(wx, wy, mask, deriv, **kw)
    uu_p, vv_p = tv._of_inner_loop(wx, wy, mask, _i_list(deriv), noc=1,
                                   **kw)
    assert torch.equal(uu_k, uu_p) and torch.equal(vv_k, vv_p)


def test_tv_cooperative_kernel_is_captured_by_a_cuda_graph(cuda):
    """The cooperative launch is taken by stream capture (chip_smoke.py
    times K2 through a CUDA graph) and replays to the same bits."""
    _, _, wx, wy, mask, deriv = _tv_inputs(cuda, 2, 1, 30, 41, 3)
    assert tv_of_inner.cooperative(30, 41)
    qa, hd3, hg3 = tv.tv_coefficients(10.0, 10.0, 5.0)
    kw = dict(quarter_alpha=qa, hd3=hd3, hg3=hg3, n_inner=2, n_solver=3,
              omega=1.6)
    uu0, vv0 = tv_of_inner.of_inner(wx, wy, mask, deriv, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        uu, vv = tv_of_inner.of_inner(wx, wy, mask, deriv, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(uu, uu0) and torch.equal(vv, vv0)


# ------------------------------------------------- the depth TV loop (K5)

_DE_ROUTES = [("cluster", 1), ("cluster", 2), ("cluster", 4), ("cluster", 8),
              ("cluster", 16), ("cooperative", 0)]
# (b, h, w): one pixel, ragged and odd levels, bands at their minimum of
# 2 rows (4 rows at K = 2, 32 at K = 16), one, three and 64 pairs
_DE_SHAPES = [(1, 1, 1), (3, 7, 5), (3, 4, 9), (3, 37, 61), (64, 37, 61),
              (1, 32, 40)]
_DE_CASES = [(b, h, w, r, k) for b, h, w in _DE_SHAPES for r, k in _DE_ROUTES
             if r == "cooperative" or k == 1 or h >= 2 * k]


def _force_de_route(monkeypatch, route):
    monkeypatch.setattr(tv_de_inner, "route", lambda b, h, w: route)


def _de_kw(parity, camlr, n_inner=3, n_solver=3, delta=5.0):
    qa, hd3, hg3 = tv.tv_coefficients(10.0, 10.0, delta)
    return dict(camlr=camlr, quarter_alpha=qa, hd3=hd3, hg3=hg3,
                n_inner=n_inner, n_solver=n_solver, omega=1.6,
                row_parity=parity)


@pytest.mark.parametrize("noc", [1, 3])
@pytest.mark.parametrize("b,h,w,route,k", _DE_CASES)
def test_tv_de_kernel_routes_equal_plain(cuda, monkeypatch, b, h, w, route,
                                         k, noc):
    """K5 on each route and cluster size, whatever the rule would pick:
    both row parities and both cameras (alternating over the shapes), the
    colour term on and off. The twin's float32 operations per pixel, no
    contraction: equal to it (error 0; NaN where both are NaN: a 1x1 level
    outside the warp's bounds has no weights, and omega / 0 times 0 is NaN
    in both)."""
    _force_de_route(monkeypatch, (route, k))
    i = _DE_SHAPES.index((b, h, w))
    parity, camlr = i % 2, (i // 2) % 2
    _, _, wx, _, mask, deriv = _tv_inputs(cuda, b, noc, h, w, h * w + b + k,
                                          depth=True)
    kw = _de_kw(parity, camlr, delta=5.0 if (i + k) % 2 else 0.0)
    before = trace.launches("tv_de_inner", "of_tv_de_inner")
    uu_k = tv_de_inner.de_inner(wx, mask, deriv, **kw)
    assert trace.launches("tv_de_inner", "of_tv_de_inner") == before + 1
    assert tv_de_inner.last_route == (route, k)
    uu_p = tv._de_inner_loop(wx, mask, _i_list(deriv), noc=noc, **kw)
    torch.testing.assert_close(uu_k, uu_p, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("route", [("cluster", 1), ("cluster", 4),
                                   ("cooperative", 0)])
@pytest.mark.parametrize("n_inner,n_solver", [(0, 3), (3, 0), (2, 1)])
def test_tv_de_kernel_without_sweeps_or_iterations_equals_plain(
        cuda, monkeypatch, n_inner, n_solver, route):
    """No inner iteration (uu = wx, unclamped) or no SOR sweep (du = 0,
    uu = clamp(wx) after every iteration): every route equals the twin."""
    _force_de_route(monkeypatch, route)
    _, _, wx, _, mask, deriv = _tv_inputs(cuda, 3, 1, 19, 23, 7, depth=True)
    kw = _de_kw(1, 0, n_inner=n_inner, n_solver=n_solver)
    uu_k = tv_de_inner.de_inner(wx, mask, deriv, **kw)
    uu_p = tv._de_inner_loop(wx, mask, _i_list(deriv), noc=1, **kw)
    assert torch.equal(uu_k, uu_p)


@pytest.mark.parametrize("route", [("cluster", 8), ("cooperative", 0)])
def test_tv_de_kernel_is_captured_by_a_cuda_graph(cuda, monkeypatch, route):
    """A cluster launch and a cooperative launch are taken by stream
    capture (chip_smoke.py times K5 through a CUDA graph) and replay to the
    same bits."""
    _force_de_route(monkeypatch, route)
    _, _, wx, _, mask, deriv = _tv_inputs(cuda, 2, 1, 30, 41, 3, depth=True)
    kw = _de_kw(0, 0, n_inner=2)
    uu0 = tv_de_inner.de_inner(wx, mask, deriv, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        uu = tv_de_inner.de_inner(wx, mask, deriv, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(uu, uu0)


def test_tv_de_kernel_raises_where_no_cluster_can_be_resident(cuda,
                                                              monkeypatch):
    """Bands of 2 rows x 6,000 pixels need 240,000 bytes of shared memory a
    block, more than an SM has: no cluster of 16 can be resident, the card
    says so, and the wrapper raises (no fallback to another route or the
    twin); a cluster of 32 blocks is refused too."""
    h, w = 32, 6000
    assert tv_de_inner.max_clusters(cuda, 1, 16, h, w) == 0
    assert tv_de_inner.max_clusters(cuda, 1, 2, 56, 128) > 0
    _, _, wx, _, mask, deriv = _tv_inputs(cuda, 1, 1, h, w, 1, depth=True)
    kw = _de_kw(0, 0, n_inner=1)
    before = trace.launches("tv_de_inner", "of_tv_de_inner")
    for k in (16, 32):
        _force_de_route(monkeypatch, ("cluster", k))
        with pytest.raises(RuntimeError, match="cudaError_t"):
            tv_de_inner.de_inner(wx, mask, deriv, **kw)
    assert trace.launches("tv_de_inner", "of_tv_de_inner") == before


# ------------------------------ the large-level GN kernel (K6), every instance

def _odd_level(params, camlr):
    """(h, w, spec) of the first level from 40x100 on with an odd patch
    count (so that 3 pairs leave the kernel's last warp a lone patch)."""
    for h in range(40, 56):
        for w in range(100, 140):
            spec = make_level_spec(0, w, h, params, camlr=camlr)
            if spec.nopatches % 2:
                return h, w, spec
    raise AssertionError("no level with an odd patch count")


@pytest.mark.parametrize("nop,noc,camlr", [(2, 1, 0), (2, 3, 0), (1, 1, 1),
                                           (1, 3, 0)])
@pytest.mark.parametrize("psz", [1, 2, 3, 5, 7, 11])
def test_gn_tiled_kernel_every_segment_width(cuda, psz, nop, noc, camlr):
    """K6 at patch sizes of every lane segment (2, 4, 8 and 16 lanes a
    patch; with `test_gn_tiled_kernel_matches_plain`'s 4, 8, 9 and 12),
    gray and RGB, flow and depth, on an odd patch count (the last warp
    holds one patch) with starts that reset and that begin outside:
    iterations equal to the twin's, p within 1e-3 px, pweight 1e-4."""
    params = dataclasses.replace(
        op_point_params(100, 3, nop=nop, noc=noc), sc_f=0, sc_l=0,
        p_samp_s=psz, min_iter=16)
    h, w, spec = _odd_level(params, camlr)
    per_warp = 32 // patch_solver.column_segment(psz)
    assert (3 * spec.nopatches) % per_warp != 0
    a, b = (torch.as_tensor(x, device=cuda)
            for x in _frames(3, h, w, psz, noc))
    src = tuple(f[0] for f in pyramid.build_pyramid(a, 0, psz))
    imb, _, _ = pyramid.build_pyramid(b, 0, psz, getgrad=False)
    rng = np.random.default_rng(psz + 10 * noc)
    p0 = torch.as_tensor(rng.standard_normal((3, nop, spec.nopatches)) * 6,
                         dtype=torch.float32, device=cuda)
    pt_ref = patch_solver.grid_ref_points(spec, cuda).T[None].contiguous()
    before = trace.launches("gn_tiled")
    p_k, pw_k, it_k = gn_tiled.gn_tiled(spec, params, imb[0], src, p0, pt_ref)
    assert trace.launches("gn_tiled") == before + 1
    p_p, pw_p, it_p, _ = patch_solver._gn_tiled_plain(
        spec, params, imb[0], src, p0, pt_ref)
    assert int(it_k) == int(it_p)
    assert float((p_k - p_p).abs().max()) <= 1e-3
    assert float((pw_k - pw_p).abs().max()) <= 1e-4 * float(pw_p.abs().max())


# ---------------- the small-level GN kernel (K1) and the extraction (K7)

# patches a K1 block (kWarps of csrc/gn_fused.cu)
K1_BLOCK_PATCHES = 4


def _level_filling_no_block(params, camlr):
    """(h, w, spec) of the first level from 40x100 on whose patch count, at
    3 pairs, fills no whole K1 block (K1_BLOCK_PATCHES patches): the last
    block holds fewer."""
    for h in range(40, 56):
        for w in range(100, 140):
            spec = make_level_spec(0, w, h, params, camlr=camlr)
            if (3 * spec.nopatches) % K1_BLOCK_PATCHES:
                return h, w, spec
    raise AssertionError("no level with a ragged block")


@pytest.mark.parametrize("nop,noc,camlr", [(2, 1, 0), (2, 3, 0), (1, 1, 0),
                                           (1, 1, 1), (1, 3, 0)])
@pytest.mark.parametrize("psz", [4, 5, 7, 8, 12])
@pytest.mark.parametrize("stops", ["first trip", "every trip"])
def test_gn_fused_kernel_every_instance(cuda, psz, stops, nop, noc, camlr):
    """K1 at every template instance (1, 2 and 5 pixels a lane at the run
    time's patch sizes 4, 5 and 7; patch sizes 8 and 12 as constants), gray
    and RGB, flow and depth of either sign, on a patch count that fills no
    whole block, with starts up to ~12 px off the grid: windows inside the
    planes and on their borders (clamped), and starts outside. Either
    every patch stops on its first trip (min_iter 1 and a residual-decrease
    threshold no trip meets) or runs every trip unless reset (min_iter =
    max_iter). Iterations equal to the twin's, p within 1e-3 px, pweight
    within 1e-4 of the largest."""
    params = dataclasses.replace(
        op_point_params(100, 2, nop=nop, noc=noc), sc_f=0, sc_l=0,
        p_samp_s=psz)
    if stops == "first trip":
        params = dataclasses.replace(params, min_iter=1, dr_thresh=1e-9)
    else:
        params = dataclasses.replace(params, min_iter=params.max_iter)
    h, w, spec = _level_filling_no_block(params, camlr)
    a, b = (torch.as_tensor(x, device=cuda)
            for x in _frames(3, h, w, psz, noc))
    ims, dxs, dys = pyramid.build_pyramid(a, 0, psz)
    imb, _, _ = pyramid.build_pyramid(b, 0, psz, getgrad=False)
    tpl = patch_solver.extract_templates(spec, params, ims[0], dxs[0], dys[0])
    rng = np.random.default_rng(psz + 10 * noc + 100 * nop + camlr)
    p0 = torch.as_tensor(rng.standard_normal((3, nop, spec.nopatches)) * 4,
                         dtype=torch.float32, device=cuda)
    pt_ref = patch_solver.grid_ref_points(spec, cuda).T[None].contiguous()
    # the starts' windows: some inside the planes, some on a border
    x0 = pt_ref[:, 0] + p0[:, 0]
    y0 = pt_ref[:, 1] + (p0[:, 1] if nop == 2 else 0.0)
    sx = torch.ceil(x0 + 1e-5) - psz // 2 - 1 + spec.pad
    sy = torch.ceil(y0 + 1e-5) - psz // 2 - 1 + spec.pad
    hp, wp = imb[0].shape[-2:]
    inside = (sx >= 0) & (sy >= 0) & (sx + psz < wp) & (sy + psz < hp)
    assert bool(inside.any()) and bool((~inside).any())
    before = trace.launches("gn_fused")
    p_k, pw_k, it_k = gn_fused.gn_fused(spec, params, imb[0], tpl, p0, pt_ref)
    assert trace.launches("gn_fused") == before + 1
    p_p, pw_p, it_p, trips = patch_solver._gn_plain(spec, params, imb[0],
                                                    tpl, p0, pt_ref)
    if stops == "first trip":
        assert int(it_p) == 1 and int(trips.max()) == 1
    else:
        assert bool((trips == params.max_iter).any())
    assert p_k.shape == (3, nop, spec.nopatches)
    assert pw_k.shape == (3, psz * psz, spec.nopatches)
    assert int(it_k) == int(it_p)
    assert float((p_k - p_p).abs().max()) <= 1e-3
    assert float((pw_k - pw_p).abs().max()) <= 1e-4 * float(pw_p.abs().max())


def _extract_inputs(cuda, b, noc, n, psz, seed, h=44, w=100):
    """Planes (b, noc, h + 2 psz, w + 2 psz) and n positions a pair: in the
    interior, on both validity borders, far outside (a clamped window) and
    on whole pixels."""
    rng = np.random.default_rng(seed)
    im = torch.as_tensor(rng.random((b, noc, h + 2 * psz, w + 2 * psz))
                         * 255, dtype=torch.float32, device=cuda)
    pts = np.stack([rng.uniform(-psz / 2, w + psz // 2 - 2, (b, n)),
                    rng.uniform(-psz / 2, h + psz // 2 - 2, (b, n))], -1)
    pts[0, 0] = (-psz / 2, -psz / 2)
    pts[-1, -1] = (w + psz // 2 - 2, h + psz // 2 - 2)
    pts[b // 2, 0] = (-500.0, 1e4)
    pts[:, n // 2:n // 2 + 5] = np.rint(pts[:, n // 2:n // 2 + 5])
    return im, torch.as_tensor(pts, dtype=torch.float32, device=cuda)


@pytest.mark.parametrize("psz,n,noc", [
    (psz, n, noc) for psz in (5, 8, 12, 13, 16, 24) for n in (1, 33, 1000)
    for noc in (1, 3)] + [(200, 33, 1), (200, 33, 3)])
def test_bilerp_extract_kernel_every_window_tile(cuda, psz, n, noc):
    """K7 at patch sizes whose 32 windows fit one tile of the block's
    shared memory (5 to 16, odd and even), where they take bands of rows
    (24: 80 KB of windows) and bands of columns (200), gray and RGB, on one
    patch, one more than a block's 32, and 1000 (ragged). The twin's
    float32 lerps term by term: equal."""
    im, pts = _extract_inputs(cuda, 3, noc, n, psz, psz + noc + n)
    before = trace.launches("bilerp_extract")
    o_k = bilerp_extract.bilerp_extract(im, pts, psz, psz)
    assert trace.launches("bilerp_extract") == before + 1
    o_p = patch_solver.extract_bilinear(im, pts, psz, psz)
    assert o_k.shape == o_p.shape == (3, psz * psz * noc, n)
    assert torch.equal(o_k, o_p)


# --------------------------------- repairs: launch device, batch of 65,537

def test_kernels_launch_on_the_tensors_device(cuda):
    """With device 0 current, K2, K3 and K4 on tensors of cuda:1 launch on
    cuda:1 (its stream, its SM count), equal to their twins there, and
    leave device 0 current. Needs two GPUs."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    dev1 = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    _, _, wx, wy, mask, deriv = _tv_inputs(dev1, 2, 1, 30, 41, 1)
    qa, hd3, hg3 = tv.tv_coefficients(10.0, 10.0, 5.0)
    kw = dict(quarter_alpha=qa, hd3=hd3, hg3=hg3, n_inner=2, n_solver=3,
              omega=1.6)
    uu, vv = tv_of_inner.of_inner(wx, wy, mask, deriv, **kw)
    src = torch.rand((2, 1, 30, 41), device=dev1) * 255
    o_k, m_k = warp.warp_image_batched(src, wx, wy)
    up = upscale.upscale_batched(torch.stack([wx, wy], -1), 1, 60, 82)
    assert torch.cuda.current_device() == 0
    assert uu.device == o_k.device == up.device == dev1
    uu_p, vv_p = tv._of_inner_loop(wx, wy, mask, _i_list(deriv), noc=1, **kw)
    assert torch.equal(uu, uu_p) and torch.equal(vv, vv_p)
    o_p, m_p = tv.warp_image(src, wx, wy)
    assert torch.equal(o_k, o_p) and torch.equal(m_k, m_p)
    up_p = dis.upscale_output(torch.stack([wx, wy], -1), 1, 60, 82)
    assert float((up - up_p).abs().max()) <= 1e-4


def test_warp_and_upscale_take_more_than_65535_pairs(cuda):
    """A batch of 65,537 pairs of 4x8 frames (more than the grid's z holds):
    the warp equal to its twin, the upscale within 1e-4, one launch count
    each."""
    rng = np.random.default_rng(0)
    b = 65537
    src = torch.as_tensor(rng.random((b, 1, 4, 8)) * 255,
                          dtype=torch.float32, device=cuda)
    wx, wy = (torch.as_tensor(rng.standard_normal((b, 4, 8)) * 2,
                              dtype=torch.float32, device=cuda)
              for _ in range(2))
    counts = (trace.launches("warp"), trace.launches("upscale"))
    o_k, m_k = warp.warp_image_batched(src, wx, wy)
    flow = torch.stack([wx, wy], -1)
    up = upscale.upscale_batched(flow, 1, 8, 16)
    assert (trace.launches("warp"), trace.launches("upscale")) == (
        counts[0] + 1, counts[1] + 1)
    o_p, m_p = tv.warp_image(src, wx, wy)
    assert torch.equal(o_k, o_p) and torch.equal(m_k, m_p)
    up_p = dis.upscale_output(flow, 1, 8, 16)
    assert up.shape == (b, 8, 16, 2)
    assert float((up - up_p).abs().max()) <= 1e-4


def test_bilerp_extract_takes_more_than_65535_pairs(cuda):
    """A batch of 65,537 pairs (more than a grid's y or z axis holds) of
    three patches on a tiny level: one launch, equal to its twin."""
    im, pts = _extract_inputs(cuda, 65537, 1, 3, 5, 0, h=4, w=8)
    before = trace.launches("bilerp_extract")
    o_k = bilerp_extract.bilerp_extract(im, pts, 5, 5)
    assert trace.launches("bilerp_extract") == before + 1
    o_p = patch_solver.extract_bilinear(im, pts, 5, 5)
    assert o_k.shape == (65537, 25, 3)
    assert torch.equal(o_k, o_p)
