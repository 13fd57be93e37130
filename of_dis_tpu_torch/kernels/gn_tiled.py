"""K6: the Gauss-Newton loop of a large level as one CUDA kernel that builds
its templates itself, lanes on the columns of a patch's window and several
patches a warp (csrc/gn_tiled.cu), flow or depth, gray or RGB, replacing
`_gn_tiled_pallas` of the JAX package.

Plain twin: `ops.patch_solver._gn_tiled_plain` (patch sums in the
kernel's order, `_column_sum`)."""

from __future__ import annotations

import ctypes

import torch

from of_dis_tpu_torch.kernels import build

NAME = "gn_tiled"

_f, _i, _p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_p] * 9 + [_i] * 13 + [_f] * 8 + [_p]


def gn_tiled(spec, params, im_b: torch.Tensor, src, p_init_t: torch.Tensor,
             pt_ref_t: torch.Tensor):
    """Masked GN over every patch of one level, templates taken in the
    kernel from `src` = (im_a, dx_a, dy_a) at the integer grid positions.

    im_b and the three fields of src (B, C, Hp, Wp) padded level planes;
    p_init_t (B, nop, N); pt_ref_t (1, 2, N). Returns (p (B, nop, N),
    pweight (B, psz^2, N) from one extraction at the final position, summed
    over channels of weights clamped at MINERRVAL, iters () int32). CPU
    tensors run the plain twin."""
    if im_b.device.type == "cpu":
        from of_dis_tpu_torch.ops.patch_solver import _gn_tiled_plain
        p, pw, iters, _ = _gn_tiled_plain(spec, params, im_b, src, p_init_t,
                                          pt_ref_t)
        return p, pw, iters
    nop, noc, psz = params.nop, params.noc, params.p_samp_s
    if noc not in (1, 3) or nop not in (1, 2):
        raise ValueError(f"{NAME}: noc must be 1 or 3 and nop 1 or 2, got "
                         f"noc={noc}, nop={nop}")
    pix = psz * psz
    if psz > 12:
        raise ValueError(f"{NAME}: patch size {psz} above 12 unsupported")
    b, _, hp, wp = im_b.shape
    n = pt_ref_t.shape[-1]
    if (hp, wp) != (spec.padded_height, spec.padded_width) \
            or n != spec.nopatches:
        raise ValueError(f"{NAME}: planes {hp}x{wp} / {n} patches do not "
                         f"belong to level {spec.level}")
    build.check_tensor(NAME, "im_b", im_b, (b, noc, hp, wp))
    for what, t in zip(("im_a", "dx_a", "dy_a"), src):
        build.check_tensor(NAME, what, t, (b, noc, hp, wp))
    build.check_tensor(NAME, "p_init_t", p_init_t, (b, nop, n))
    build.check_tensor(NAME, "pt_ref_t", pt_ref_t, (1, 2, n))
    p_out = torch.empty((b, nop, n), dtype=torch.float32, device=im_b.device)
    pw_out = torch.empty((b, pix, n), dtype=torch.float32, device=im_b.device)
    iters = torch.zeros((1,), dtype=torch.int32, device=im_b.device)
    p = build.ptr
    build.launch(im_b.device, NAME, "of_gn_tiled", _ARGTYPES, p(im_b),
                 p(src[0]), p(src[1]), p(src[2]), p(p_init_t), p(pt_ref_t),
                 p(p_out), p(pw_out), p(iters), b, n, noc, hp, wp, psz,
                 spec.pad, params.max_iter, params.min_iter, params.costfct,
                 params.patnorm, nop, spec.camlr, spec.tmp_lb, spec.tmp_ubw,
                 spec.tmp_ubh, params.outlierthresh, params.res_thresh,
                 params.dp_thresh_sq, params.dr_thresh, float(params.novals))
    return p_out, pw_out, iters.reshape(())
