"""K1: the whole per-level Gauss-Newton loop as one CUDA kernel
(csrc/gn_fused.cu), flow or depth, gray or RGB, replacing
`_gn_fused_pallas` of the JAX package.

Plain twin: `ops.patch_solver._gn_plain`."""

from __future__ import annotations

import ctypes

import torch

from of_dis_tpu_torch.kernels import build

NAME = "gn_fused"

_f, _i, _p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
_ARGTYPES = [_p] * 10 + [_i] * 13 + [_f] * 8 + [_p]


def gn_fused(spec, params, im_b: torch.Tensor, tpl, p_init_t: torch.Tensor,
             pt_ref_t: torch.Tensor):
    """Masked GN over every patch of one level, for flow (nop 2) or depth
    (nop 1, disparity clamped to the sign of `spec.camlr`), gray or RGB.

    im_b (B, C, Hp, Wp) target level; tpl fields (B, D, N), D = psz^2 C,
    and hes (B, 3, N) or (B, 1, N); p_init_t (B, nop, N); pt_ref_t
    (1, 2, N). Returns (p (B, nop, N), pweight (B, psz^2, N) summed over
    channels of weights clamped at MINERRVAL, iters () int32). CPU tensors
    run the plain twin."""
    if im_b.device.type == "cpu":
        from of_dis_tpu_torch.ops.patch_solver import _gn_plain
        p, pw, iters, _ = _gn_plain(spec, params, im_b, tpl, p_init_t,
                                    pt_ref_t)
        return p, pw, iters
    nop, noc, psz = params.nop, params.noc, params.p_samp_s
    if noc not in (1, 3) or nop not in (1, 2):
        raise ValueError(f"{NAME}: noc must be 1 or 3 and nop 1 or 2, got "
                         f"noc={noc}, nop={nop}")
    pix = psz * psz
    if pix > 32 * 5:
        raise ValueError(f"{NAME}: patch size {psz} above 12 unsupported")
    b, _, hp, wp = im_b.shape
    n = tpl.tmpl.shape[-1]
    build.check_tensor(NAME, "im_b", im_b, (b, noc, hp, wp))
    for what, t in zip(("tmpl", "tdx", "tdy"), tpl[:3]):
        build.check_tensor(NAME, what, t, (b, pix * noc, n))
    build.check_tensor(NAME, "hes", tpl.hes, (b, 3 if nop == 2 else 1, n))
    build.check_tensor(NAME, "p_init_t", p_init_t, (b, nop, n))
    build.check_tensor(NAME, "pt_ref_t", pt_ref_t, (1, 2, n))
    p_out = torch.empty((b, nop, n), dtype=torch.float32, device=im_b.device)
    pw_out = torch.empty((b, pix, n), dtype=torch.float32, device=im_b.device)
    iters = torch.zeros((1,), dtype=torch.int32, device=im_b.device)
    p = build.ptr
    build.launch(im_b.device, NAME, "of_gn_fused", _ARGTYPES, p(im_b),
                 p(tpl.tmpl), p(tpl.tdx), p(tpl.tdy), p(tpl.hes), p(p_init_t),
                 p(pt_ref_t), p(p_out), p(pw_out), p(iters), b, n, noc, hp,
                 wp, psz, spec.pad, params.max_iter, params.min_iter,
                 params.costfct, params.patnorm, nop, spec.camlr,
                 spec.tmp_lb, spec.tmp_ubw, spec.tmp_ubh,
                 params.outlierthresh, params.res_thresh,
                 params.dp_thresh_sq, params.dr_thresh, float(params.novals))
    return p_out, pw_out, iters.reshape(())
