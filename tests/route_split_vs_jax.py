"""The two GN routes of the port against the JAX package, on the CPU, at
the levels of `chip_smoke.py`'s path F (op-4 gray flow, 1024x436 padded to
1024x448, batch 4, seed 0; the pairs made on the CPU).

Runs `dis_flow_batched` on the CPU down to level LEVEL (default 3) and, at
every level from 4 down to LEVEL, feeds the same inputs to the twin of
`gn_fused` (templates from `extract_templates`), the twin of `gn_tiled`
(`_gn_tiled_plain`) and the JAX package's `optimize_level_batched` (its
XLA route on the CPU). Prints one JSON line a level: the largest distance
between each two of the three (px), the patches further apart than 1e-3
px, and the three patches where the two port routes end furthest apart.
Not a test: levels 1 and 0 take minutes and gigabytes. Run:

    JAX_PLATFORMS=cpu python tests/route_split_vs_jax.py [LEVEL]
"""

import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from of_dis_tpu import params as jparams  # noqa: E402
from of_dis_tpu.ops import patch_solver as jps  # noqa: E402
from of_dis_tpu_torch.models import dis  # noqa: E402
from of_dis_tpu_torch.ops import patch_solver as tps, pyramid  # noqa: E402
from of_dis_tpu_torch.params import op_point_params  # noqa: E402
from of_dis_tpu_torch.tools import synth  # noqa: E402


class _Stop(Exception):
    pass


def main(last_level: int) -> None:
    params = op_point_params(chip_smoke.W_ORG, 4)
    a, b, _, _ = synth.make_pairs(4, chip_smoke.H_ORG, chip_smoke.W_ORG, 0,
                                  "cpu")
    im_a = pyramid.pad_to_divisible(a, params.sc_f)
    im_b = pyramid.pad_to_divisible(b, params.sc_f)
    levels = []
    optimize = tps.optimize_level_batched

    def record(spec, prm, target, tpl, p_init, src=None):
        levels.append((spec, prm, target, src, p_init))
        if spec.level <= last_level:
            raise _Stop
        return optimize(spec, prm, target, tpl, p_init, src=src)

    tps.optimize_level_batched = record
    try:
        dis.dis_flow_batched(im_a, im_b, params, im_a.shape[3],
                             im_a.shape[2], device="cpu")
    except _Stop:
        pass
    finally:
        tps.optimize_level_batched = optimize
    jprm = jparams.op_point_params(chip_smoke.W_ORG, 4)
    for spec, prm, target, src, p_init in levels:
        if spec.level > 4:
            continue
        pt_ref_t = tps.grid_ref_points(spec).T[None].contiguous()
        p_init_t = p_init.transpose(1, 2).contiguous()
        tpl = tps.extract_templates(spec, prm, *src)
        p_f, _, _, trips_f = tps._gn_plain(spec, prm, target, tpl, p_init_t,
                                           pt_ref_t)
        p_t, _, _, trips_t = tps._gn_tiled_plain(spec, prm, target, src,
                                                 p_init_t, pt_ref_t)
        ref = jps.optimize_level_batched(
            spec, jprm, jnp.asarray(target.numpy()), None,
            jnp.asarray(p_init.numpy()),
            src=tuple(jnp.asarray(s.numpy()) for s in src))
        p_j = torch.as_tensor(np.array(ref.p)).transpose(1, 2)

        def apart(x, y):
            return (x - y).abs().amax(dim=1)            # (B, N)

        worst = []
        d = apart(p_f, p_t)
        for flat in torch.topk(d.flatten(), 3).indices.tolist():
            pair, n = divmod(flat, d.shape[1])
            worst.append({
                "pair": pair, "patch": n, "ref": pt_ref_t[0, :, n].tolist(),
                "fused": p_f[pair, :, n].tolist(),
                "tiled": p_t[pair, :, n].tolist(),
                "jax": p_j[pair, :, n].tolist(),
                "trips_fused": int(trips_f[pair, n]),
                "trips_tiled": int(trips_t[pair, n])})
        pairs = {"fused_tiled": (p_f, p_t), "fused_jax": (p_f, p_j),
                 "tiled_jax": (p_t, p_j)}
        print(json.dumps({
            "level": spec.level, "patches": spec.nopatches,
            "port_uses_tiled": tps.uses_tiled(spec),
            "max_abs_diff": {k: float(apart(*v).max())
                             for k, v in pairs.items()},
            "over_1e-3": {k: int((apart(*v) > 1e-3).sum())
                          for k, v in pairs.items()},
            "furthest_apart": worst}), flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 3)
