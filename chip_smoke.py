"""On-card smoke test of the PyTorch / CUDA port (`of_dis_tpu_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. device: CUDA present, the `nvidia-smi` name / power-limit line;
  2. build: every kernel of `of_dis_tpu_torch/csrc/` compiled with nvcc for
     sm_90a, one process per source, all at once;
  3. per path (see PATHS: at op-point 2 A gray flow, B gray depth, C RGB
     flow, D RGB depth, G gray flow with the forward-backward merge; E
     op-point 3 and F op-point 4 gray flow; H gray flow at patch size 16
     through the 20-parameter form, the unfused GN route; Sintel 1024x436
     padded to 1024x448; I op-point 4 gray depth): each kernel against its
     plain PyTorch twin on
     the card, on the inputs the path hands it (the whole batch), with
     wrapper / plain / library times (CUDA events around back-to-back
     calls) and the bound the card could reach; for every kernel of the
     path also the device's own time (CUDA graphs of 20 calls on rotated
     copies of the inputs, `device_ms`), apart from the host's, and for
     the warp, the upscale and the patch extraction the library call's;
     for the small-level GN kernel, the patch extraction and the depth TV
     loop also one line of device ms per level, with the card's name and
     power limit; every depth TV call's route and cluster size, asserted
     against the rule and the path's expectation, with the clusters of
     that size the card holds at once;
     on paths A, E and F every GN level is also timed on both fused
     routes (templates gathered by plain torch plus `gn_fused`, against
     `gn_tiled`), the measurement behind `patch_solver.TILED_MIN_PATCHES`,
     with the patches where the two routes end furthest apart;
  4. per path, end to end: `dis_flow_batched`, launch counts of every
     kernel (asserted), the result against the known synthetic field and
     against the plain path, pairs/s, one profile with the busy share; the
     merge's result equal to the bit between two calls;
  5. the single-pair TV entries `ops.tv.ref_level_of` / `ref_level_de` on
     pair 0 of the finest level of paths A and B: launch counts, against
     their twins, and equal to row 0 of the batched result;
  6. path J, the warm-started sequence mode: `dis_sequence_batched` on 16
     streams x 5 frames at op-2 gray flow (frame t of a stream is its
     base frame warped by t times path A's field): every kernel call
     against its twin, launches counted over the run and per step (each
     step's equal to a path-A call's), per step the median flow against
     the field, the kernel path against the plain path and stream 0
     against `dis_sequence`, wall ms per step beside path A's and one
     profiled step; then `cli.main --init-flow` at op-2 against the same
     run on the plain twins;
  7. the serving pipeline (`pipeline.run_pipeline`) at op-2 gray flow on
     161 PNG frames of 1024x436 written on the card's host
     (`tools.bench_pipeline.make_frames`: content moving 1.3, 0.4 px a
     frame): the batch decoder's frames/s at 1, 4, 8 and 16 threads
     (its pixels held to cv2's in part 7c); cold batches of 64 (two full
     and a ragged tail of 32), `--streams 16`, depth on 17 frames moving
     -1.3 px, and
     the cold run split over two devices (`cuda:0` twice): launches per
     batch equal to a path-A call's, every file against
     `dis_flow_batched` (a `dis_step_warm` loop for the streams) on the
     same decoded frames, medians against the motion, the split's files
     against one device's, pairs/s beside the bare calls' and the device's
     busy share of a cold run; one `utils.viz.main` call;
  7b. JPEG frames (`run_jpeg_part`, the fixtures of
     tests/torch_fixtures/jpeg): every fixture decoded by the port's own
     decoder (`csrc/jpeg.cpp`) through `decode_batch` and `load_image`,
     gray and colour, each plane's SHA-256 equal to the manifest's
     cv2.imread hash (a read the manifest has as null, which cv2 fails on,
     must raise): Huffman, arithmetic-coded, lossless, CMYK and YCCK
     files; JPEG frames/s at 1, 4, 8 and 16 threads and `load_image`'s,
     the arithmetic-coded frames' beside the Huffman ones'; `run_pipeline`
     at op-2 on the nine 1024x436 frames (one batch of 8 pairs), gray and
     RGB flow: launches those of a path-A (C) call, every file against
     `dis_flow_batched` on the same decoded frames, medians within 0.25 px
     of the motion, pairs/s and the busy share; `cli.main` on the first
     pair, gray and RGB, against `dis_flow_batched`; then the nine frames
     arithmetic-coded through `run_pipeline` at op-1 and op-2, gray and
     RGB flow (launches those of the `dis_flow_batched` call they are held
     to), and `cli.main` on a lossless gray pair and a YCCK pair;
  7c. PNG, PNM and BMP frames (`run_formats_part`): part 7b's nine frames
     re-encoded on the card's host by the numpy-only generator of
     tests/torch_fixtures/formats as 16-bit gray PNG, palette PNG, Adam7
     RGB PNG with sRGB, 24-bit BMP, 16-bit PGM and 8-bit gray PNG; every
     frame and committed variant decoded by the port's own decoder
     (`csrc/io_native.cpp`) through `decode_batch` and `load_image`, gray
     and colour, each plane's SHA-256 equal to the manifest's cv2.imread
     hash; decode frames/s per format at 1 and 8 threads; `run_pipeline`
     at op-2 gray flow (one batch of 8 pairs) and `cli.main` on the first
     pair of the 16-bit PNG and the sRGB RGB PNG frames: launches those of
     a path-A call, every file against `dis_flow_batched` on the same
     decoded frames, medians within 0.25 px of the motion;
  7d. WebP, Sun raster, PAM, HDR and PFM frames (`run_webp_part`,
     `run_raster_part`): every committed WebP fixture of
     tests/torch_fixtures/webp (nine lossy 1024x436 frames, three lossless
     gray ones, small variants) and part 7b's frames re-encoded on the
     card's host by the numpy writers of tests/torch_fixtures/raster (24
     and 8-bit Sun raster, RGB and 16-bit PAM, run-length HDR, gray PFM),
     with those writers' variants, decoded by the port's own decoders
     (`csrc/webp.cpp`, `csrc/raster.cpp`) through `decode_batch` and
     `load_image`, gray and colour, each plane's SHA-256 equal to the
     manifest's cv2.imread hash (a read cv2.imread fails on must raise);
     decode frames/s per frame set at 1 and 8 threads; `run_pipeline` at
     op-2 gray flow (one batch) and `cli.main` on the first pair of the
     lossy and the lossless WebP frames and of the Sun raster, 16-bit PAM
     and HDR frames: launches those of a path-A call, every file against
     `dis_flow_batched` on the same decoded frames, medians within 0.25 px
     of the motion;
  7e. TIFF and GIF frames (`run_tiff_part`, `run_gif_part`): every
     committed variant of tests/torch_fixtures/tiff and
     tests/torch_fixtures/gif (numpy-, cv2- and PIL-written), the
     committed TIFF frame sets (the nine frames blurred, thresholded and
     CCITT Group 4-coded; frames 0-1 as RGBA and CMYK JPEG-in-TIFF) and
     part 7b's frames re-encoded on the card's host by their numpy writers
     (TIFF: LZW with predictor 2 gray, Deflate RGB, PackBits RGB in 64x32
     tiles, 16-bit gray, the JPEG frames' own bitstreams as YCbCr
     JPEG-in-TIFF, 2x1 YCbCr with LZW; GIF: gray under a 256-level gray
     palette, plain and interlaced), decoded by the port's own decoders
     (`csrc/tiff.cpp` with `csrc/jpeg.cpp` for JPEG strips,
     `csrc/gif.cpp`) through `decode_batch` and `load_image`, gray and
     colour, each plane's SHA-256 equal to the manifest's cv2.imread hash
     (a read cv2.imread fails on must raise); decode frames/s per frame
     set at 1 and 8 threads; `run_pipeline` at op-2 gray flow (one batch;
     RGB flow too on YCbCr) and `cli.main` on the first pair of every
     TIFF set, of the RGBA and CMYK pairs and of the 256-gray GIF frames:
     launches those of a path-A (C) call, every file against
     `dis_flow_batched` on the same decoded frames, medians within 0.25
     px of the motion (measured, not held, on the bilevel Group 4
     frames);
  7f. JPEG 2000 frames (`run_jp2_part`): every committed fixture of
     tests/torch_fixtures/jp2 (nine 1024x436 frames RGB 9/7 at 20:1,
     frames 0-2 gray 5/3 without loss, small Pillow- and cv2-written
     variants, the 2K cinema profile at 2048x1080) decoded by the port's
     own decoder (`csrc/jp2.cpp`) through `decode_batch` and
     `load_image`, gray and colour, each plane's SHA-256 equal to the
     manifest's cv2.imread hash (a read cv2.imread fails on must raise);
     decode frames/s of the lossy and the lossless frames at 1 and 8
     threads; `run_pipeline` at op-2 gray flow (one batch) and `cli.main`
     on the first pair of each set: launches those of a path-A call,
     every file against `dis_flow_batched` on the same decoded frames,
     medians within 0.25 px of the motion;
  7g. damaged JPEG frames (`run_jpeg_damaged_part`): the three frame sets
     that tests/torch_fixtures/jpeg/manifest.json lists as byte edits
     (`damage.py`) of committed files, written on the card's host: the
     nine frames with 3 bytes before an EOI, an EOI missing, a cut inside
     the last MCU row, a byte flipped in mid-scan and (frame 5, a
     restart-coded re-encode) a restart marker one ahead of the one due;
     frames 0-2 written progressive, whole and cut before their last scan
     (block smoothing); decoded by the port's own decoder through
     `decode_batch` and `load_image`, gray and colour, each plane's
     SHA-256 equal to the manifest's cv2.imread hash; decode frames/s per
     set at 1 and 8 threads; `run_pipeline` (one batch) and `cli.main` at
     op-2, gray and RGB flow, on every set: launches those of a path-A
     (C) call, every file against `dis_flow_batched` on the same decoded
     frames, medians within 0.25 px of the motion on the pairs of frames
     that differ from their whole files in under 5% of pixels (measured
     on the others);
  7h. damaged TIFF frames (`run_tiff_damaged_part`): the four frame sets
     that tests/torch_fixtures/tiff/manifest.json lists as byte edits
     (`damage.py`) of source frames (lzw_pred, packbits_tiled and jpeg
     written on the card's host by part 7e's writers, fax_g4 the
     committed files; each source's SHA-256 checked first): frames 0, 3,
     6 whole, 1, 4, 7 with a byte flipped in one strip or tile, 2, 5, 8
     with a strip's or tile's byte count cut short; decoded through
     `decode_batch` and `load_image`, gray and colour, each plane's
     SHA-256 equal to the manifest's cv2.imread hash; decode frames/s per
     set at 1 and 8 threads (a sanity figure of one run); `run_pipeline`
     (one batch) and `cli.main` at op-2, gray and RGB flow, on every set,
     checked as in 7g (fax_g4's medians measured, not held);
  8. the compiled-reference goldens through the port's `cli.main` on the
     card (all fifteen: six modes at op-2, op-1, op-3 in five modes, op-4,
     the merge for flow and depth, the TV-free pseudo-Huber run), and the
     op-2 and op-4 gray-flow goldens again at the CLI's default verbosity 2:
     the per-scale lines printed, the file equal to the quiet one;
  9. the tensor-core dot microbenchmark (T1): `tools.bench_i8_dot` at its
     defaults, launches counted, both products equal to their exact twin,
     wrapper and device times beside the bound and one PyTorch product of
     the same function (`torch._int_mm`, bf16 `matmul`), its device time
     too;
  10. the per-stage ablation of the GN iteration (T2): `tools
     .bench_gn_stages` at op-2's finest level (batch 384, on the small-level
     GN kernel's lane layout) and at op-4's level 0 (batch 4, on the
     large-level GN kernel's column layout), launches counted, every stage
     against its twin, every variant equal to A4 bit for bit, wrapper and
     device times; the stages' device times beside the small-level GN
     kernel's level-3 device time of path A (per pair) and the large-level
     GN kernel's level-0 device time of path F, with the card's name and
     power limit;
 11. the row-sharded TV refinement (`parallel.spatial`, routed by
     `params.with_spatial_tv`) on 1920x1080 u8 pairs, every split over a
     list of cuda:0 repeated (the card has one GPU): S1 op-4 gray flow
     and S2 op-4 gray depth (batch 4, L1 544x960 over 4 devices), S3
     op-3 RGB flow (L2 272x480 over 2) through `dis_flow_batched`; S4
     `dis._tv_refine` on a level-0 spec of 1920x1080 (batch 4, flow and
     depth, over 8 devices, 135 rows a shard and both row parities, and
     over 4); S5 `tv_refine_spatial_batched` on S1's level, pairs x rows =
     2 x 2. Each: the routed result equal to the unrouted one (0.0 px),
     launches asserted (n K3 and n K2 / K5 in place of one of each),
     every shard's K3 and K2 / K5 call against its twin with its row
     origin and parity, the device ms of the split level beside the
     unsharded level's, wall ms of a routed and an unrouted call. S6: the
     fuzzed configuration of seed 0 (tests/test_fuzz_params.py) at
     64x128, drawn and with TV on, through `dis_flow_batched`, every
     kernel call against its twin;
 12. the measurement tools (`of_dis_tpu_torch/tools/`), chained as an
     operator would: `warmup` for op-2 gray flow at 1024x436, batch 64,
     then a check that the next calls build nothing (no new file under
     `build/of_dis_tpu_torch/`); `bench` with BENCH_ITERS=2 on its primary
     row and the rows `op3`, `de_op2` and `seq_op3` (its JSON line, each
     row's launch check, a number and a busy share per row); `eval_epe` on
     phase 7's cold `.flo` files against files of their true motion, the
     constant (1.3, 0.4) px: its lines printed, its mean finite;
 13. one `{"kernels": [...]}` JSON line, the `nvidia-smi` line, and as the
     last line `{"ok": true, "device": {...}}`.

Synthetic pairs follow the JAX package's bench workload (a blurred random
frame, backward-warped by a smooth subpixel field, both frames rounded to
u8), generated on the card from a seed (`of_dis_tpu_torch/tools/synth.py`,
shared with the port's measurement tools). Flow pairs move by a field of mean
~(2.5, 1.0) px; stereo pairs shift horizontally only, by a disparity in
[-4.6, -1.4] px (the left camera's disparity is <= 0).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib.util
import io as io_mod
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from of_dis_tpu_torch import cli, pipeline, trace
from of_dis_tpu_torch.kernels import (bilerp_extract, build, gn_fused,
                                      gn_stages, gn_tiled, i8_dot,
                                      tv_de_inner, tv_of_inner, upscale,
                                      warp)
from of_dis_tpu_torch.models import dis
from of_dis_tpu_torch.native import io as native_io
from of_dis_tpu_torch.ops import patch_solver, pyramid, tv
from of_dis_tpu_torch.parallel import mesh as pmesh
from of_dis_tpu_torch.parallel import spatial
from of_dis_tpu_torch.params import (DISParams, make_level_spec,
                                     op_point_params, pad_amounts,
                                     with_spatial_tv)
from of_dis_tpu_torch.tools import (bench, bench_gn_stages, bench_i8_dot,
                                    bench_pipeline, eval_epe, synth, warmup)
from of_dis_tpu_torch.tools.profile_pipeline import profile_call
from of_dis_tpu_torch.utils import io, viz

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "of_dis_tpu_torch", "smoke")

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# FLOP/s outside the tensor cores, for every kernel of the flow path
# (float32 CUDA-core work); the dense tensor-core rates without sparsity
# for the dot microbenchmark (T1): int8 OP/s and bf16 FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
INT8_OP_PER_S = 1979e12
BF16_FLOP_PER_S = 989e12

H_ORG, W_ORG = 436, 1024
# The paths driven end to end, each with its expected launches per
# `dis_flow_batched` call. op-2: three levels (5..3), one final upscale.
# op-3: five levels (5..1), of which levels 3 to 1 run the large-level GN
# kernel. op-4: six levels (5..0), levels 3..0 on the large-level kernel,
# and no upscale (the last level is full resolution). The merge (fbcon)
# runs a second GN per level and a backward TV at all but the last level.
# `plain_pairs`: pairs of the kernel-path / plain-path comparison; `routes`:
# time every GN level on both fused routes; `args`: the CLI's 20-parameter
# form in place of an op-point; `at_least`: kernels whose launch count
# depends on the data (one extraction at the start of a level and one per
# trip), with the fewest launches a call must show.
PATHS = [
    dict(name="A", what="flow, gray", op=2, nop=2, noc=1, batch=64,
         routes=True,
         launches={"gn_fused": 3, "tv_of_inner": 3, "warp": 3, "upscale": 1}),
    dict(name="B", what="depth, gray", op=2, nop=1, noc=1, batch=64,
         launches={"gn_fused": 3, "tv_de_inner": 3, "warp": 3, "upscale": 1},
         de_routes={5: ("cluster", 1), 4: ("cluster", 1),
                    3: ("cluster", 2)}),
    dict(name="C", what="flow, RGB", op=2, nop=2, noc=3, batch=64,
         launches={"gn_fused": 3, "tv_of_inner": 3, "warp": 3, "upscale": 1}),
    dict(name="D", what="depth, RGB", op=2, nop=1, noc=3, batch=16,
         launches={"gn_fused": 3, "tv_de_inner": 3, "warp": 3, "upscale": 1},
         de_routes={5: ("cluster", 1), 4: ("cluster", 1),
                    3: ("cluster", 4)}),
    dict(name="E", what="flow, gray, op-3", op=3, nop=2, noc=1, batch=16,
         plain_pairs=2, routes=True,
         launches={"gn_fused": 2, "gn_tiled": 3, "tv_of_inner": 5, "warp": 5,
                   "upscale": 1}),
    dict(name="F", what="flow, gray, op-4", op=4, nop=2, noc=1, batch=4,
         plain_pairs=2, routes=True,
         launches={"gn_fused": 2, "gn_tiled": 4, "tv_of_inner": 6,
                   "warp": 6}),
    dict(name="G", what="flow, gray, forward-backward merge", op=2, nop=2,
         noc=1, batch=64, fbcon=True,
         launches={"gn_fused": 6, "tv_of_inner": 5, "warp": 5, "upscale": 1}),
    # op-3's settings (16 trips, overlap 0.75, TV on) at patch size 16,
    # levels 4..1: 256 pixels a patch, more than a warp of either GN
    # kernel holds, so every level takes the unfused route
    dict(name="H", what="flow, gray, patch size 16 (20-parameter form)",
         op=None, args="4 1 16 16 0.05 0.95 0 16 0.75 0 1 0 1 10 10 5 1 3 "
         "1.6 0", nop=2, noc=1, batch=4, plain_pairs=2,
         launches={"tv_of_inner": 4, "warp": 4, "upscale": 1},
         at_least={"bilerp_extract": 8}),
    # op-4 depth on B's disparity field: every route of the depth TV loop,
    # one block a pair at levels 5 and 4, clusters of 16 at 3..1,
    # cooperative at level 0
    dict(name="I", what="depth, gray, op-4", op=4, nop=1, noc=1, batch=4,
         plain_pairs=2,
         launches={"gn_fused": 2, "gn_tiled": 4, "tv_de_inner": 6,
                   "warp": 6},
         de_routes={5: ("cluster", 1), 4: ("cluster", 1),
                    3: ("cluster", 16), 2: ("cluster", 16),
                    1: ("cluster", 16), 0: ("cooperative", 0)}),
]
# the single-pair depth entry on pair 0 of path B's finest level (56x128)
SINGLE_DE_ROUTES = {3: ("cluster", 16)}
# name -> where the main path looks the wrapper up (`entry`), the kernel
# library and C entry its launches are counted under (`trace.launches`),
# its source and the TPU kernel(s) it replaces.
KERNELS = {
    "gn_fused": dict(library="gn_fused", entry=(gn_fused, "gn_fused"),
                     symbol="of_gn_fused",
                     source="of_dis_tpu_torch/csrc/gn_fused.cu",
                     replaces="of_dis_tpu/ops/patch_solver.py:584",
                     tpu_kernels=["of_dis_tpu/ops/patch_solver.py:584 "
                                  "_gn_fused_pallas"]),
    "gn_tiled": dict(library="gn_tiled", entry=(gn_tiled, "gn_tiled"),
                     symbol="of_gn_tiled",
                     source="of_dis_tpu_torch/csrc/gn_tiled.cu",
                     replaces="of_dis_tpu/ops/patch_solver.py:1228",
                     tpu_kernels=["of_dis_tpu/ops/patch_solver.py:1228 "
                                  "_gn_tiled_pallas"]),
    "bilerp_extract": dict(library="bilerp_extract",
                           entry=(bilerp_extract, "bilerp_extract"),
                           symbol="of_bilerp_extract",
                           source="of_dis_tpu_torch/csrc/bilerp_extract.cu",
                           replaces="of_dis_tpu/ops/patch_solver.py:312",
                           tpu_kernels=["of_dis_tpu/ops/patch_solver.py:312 "
                                        "_bilerp_select_pallas"]),
    "tv_of_inner": dict(library="tv_of_inner",
                        entry=(tv_of_inner, "of_inner"),
                        symbol="of_tv_of_inner",
                        source="of_dis_tpu_torch/csrc/tv_of_inner.cu",
                        replaces="of_dis_tpu/ops/tv.py:1153",
                        tpu_kernels=["of_dis_tpu/ops/tv.py:1153 "
                                     "_of_inner_pallas_batched"]),
    "tv_of_inner_single": dict(library="tv_of_inner",
                               entry=(tv_of_inner, "of_inner_single"),
                               symbol="of_tv_of_inner_single",
                               source="of_dis_tpu_torch/csrc/tv_of_inner.cu",
                               replaces="of_dis_tpu/ops/tv.py:1092",
                               tpu_kernels=["of_dis_tpu/ops/tv.py:1092 "
                                            "_of_inner_pallas"]),
    "tv_de_inner": dict(library="tv_de_inner",
                        entry=(tv_de_inner, "de_inner"),
                        symbol="of_tv_de_inner",
                        source="of_dis_tpu_torch/csrc/tv_de_inner.cu",
                        replaces="of_dis_tpu/ops/tv.py:1224",
                        tpu_kernels=["of_dis_tpu/ops/tv.py:1224 "
                                     "_de_inner_pallas_batched"]),
    "tv_de_inner_single": dict(library="tv_de_inner",
                               entry=(tv_de_inner, "de_inner_single"),
                               symbol="of_tv_de_inner_single",
                               source="of_dis_tpu_torch/csrc/tv_de_inner.cu",
                               replaces="of_dis_tpu/ops/tv.py:1332",
                               tpu_kernels=["of_dis_tpu/ops/tv.py:1332 "
                                            "_de_inner_pallas"]),
    "warp": dict(library="warp", entry=(tv, "warp_image_batched"),
                 symbol="of_warp",
                 source="of_dis_tpu_torch/csrc/warp.cu",
                 replaces="of_dis_tpu/ops/tv.py:271",
                 tpu_kernels=["of_dis_tpu/ops/tv.py:271 "
                              "warp_image_banded_pallas",
                              "of_dis_tpu/ops/tv.py:106 _warp_coeffs_pallas"]),
    "upscale": dict(library="upscale", entry=(upscale, "upscale_batched"),
                    symbol="of_upscale",
                    source="of_dis_tpu_torch/csrc/upscale.cu",
                    replaces="of_dis_tpu/models/dis.py:206",
                    tpu_kernels=["of_dis_tpu/models/dis.py:206 "
                                 "_upscale_cf_pallas"]),
    # the measurement tools' kernels (phases 9 and 10)
    "i8_dot": dict(library="i8_dot", entry=(i8_dot, "dot_sum"),
                   symbol="of_i8_dot",
                   source="of_dis_tpu_torch/csrc/i8_dot.cu",
                   replaces="tools/bench_i8_dot.py:36",
                   tpu_kernels=["tools/bench_i8_dot.py:36 main.make"]),
    "gn_stages": dict(library="gn_stages", entry=(gn_stages, "gn_stages"),
                      symbol="of_gn_stages",
                      source="of_dis_tpu_torch/csrc/gn_stages.cu",
                      replaces="tools/bench_gn_stages.py:103",
                      tpu_kernels=["tools/bench_gn_stages.py:103 "
                                   "main.make"]),
}
# Tolerances of kernel against plain twin, with their reasons.
TOL = {
    # px: the twin sums each patch in the kernel's order, so the two agree
    # to rounding; 12 dependent Gauss-Newton trips amplify what is left
    "gn_fused": 1e-3,
    # px: as gn_fused, the template mean and the Hessian summed in the
    # kernel's order too; up to 128 dependent trips at op-4
    "gn_tiled": 1e-3,
    # the twin's three float32 lerps term by term, no contraction: equal
    "bilerp_extract": 0.0,
    # px: the same float32 formulas; the only freedom is rounding of the
    # compiler's division / square root, carried through the SOR sweeps
    "tv_of_inner": 1e-4,
    "tv_of_inner_single": 1e-4,
    # px: as tv_of_inner, one unknown
    "tv_de_inner": 1e-4,
    "tv_de_inner_single": 1e-4,
    # the twin's float32 operations in its order, no contraction: equal
    "warp": 0.0,
    # px: two taps against the matrix product's sum over every input
    # column, float32 rounding of ~20 px values
    "upscale": 1e-4,
    # every value a small integer: both products exact, in any order
    "i8_dot": 0.0,
    # relative to the stage's largest checksum: the twin sums in the
    # kernel's order with the same float32 operations (no contraction), so
    # 0 is expected; the margin covers a division or gather that rounds
    # otherwise
    "gn_stages": 1e-6,
}
# pweight of the GN kernel: relative to the level's largest weight
# (a residual moves by p's float32 difference times the image gradient)
PWEIGHT_REL_TOL = 1e-4


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, inner: int) -> float:
    """Median over `reps` samples of the CUDA-event time of `inner`
    back-to-back calls of fn, per call, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _nbytes(a) -> int:
    """Bytes of the tensors in `a`, through tuples (and named tuples)."""
    if torch.is_tensor(a):
        return a.numel() * a.element_size()
    if isinstance(a, tuple):
        return sum(_nbytes(x) for x in a)
    return 0


def _copy(a):
    """`a` with every tensor in it cloned, through tuples (and named
    tuples); anything else as it is."""
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, tuple):
        items = [_copy(x) for x in a]
        return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
    return a


def device_ms(fn, args, reps: int = 20) -> float:
    """The device's own time per call of fn(*args), apart from the host's:
    `reps` calls captured in one CUDA graph, the graph replayed between two
    CUDA events, the median of 5 replays after a first. The calls rotate
    over copies of the tensors in `args` (also those inside tuples), enough
    to hold twice the L2 (at most `reps`), so inputs of more than 1/`reps`
    of that reach the kernel from HBM, as its bound assumes; smaller ones
    stay in the L2. The time includes the graph's gap between two kernels
    and, where the wrapper allocates and zeroes an output on the device,
    that kernel too (K1 and K6: a one-int fill).

    `cuda_ms` times the wrapper: when the host takes longer to launch
    than the card to run, its events measure the host."""
    size = _nbytes(tuple(args))
    l2 = torch.cuda.get_device_properties(
        torch.cuda.current_device()).L2_cache_size
    n = max(1, min(reps, -(-2 * l2 // max(size, 1))))
    copies = [args] + [tuple(_copy(a) for a in args) for _ in range(n - 1)]
    # warm up (caches, lazily bound entries) outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*copies[i % n])
    graph.replay()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, peak: float = F32_FLOP_PER_S):
    """(bound_ms, bytes_ms, ops_ms) of work on the H100's published peaks;
    `peak` is the rate of the operations' type (float32 by default)."""
    b_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    o_ms = flops / peak * 1e3
    return max(b_ms, o_ms), b_ms, o_ms


# ---------------------------------------------- kernel inputs of the path

@contextlib.contextmanager
def swapped(make):
    """Replace each kernel's wrapper, where the main path looks it up, by
    make(name, wrapper); yields the wrappers and restores them on exit."""
    saved = {name: getattr(*k["entry"]) for name, k in KERNELS.items()}
    for name, k in KERNELS.items():
        setattr(*k["entry"], make(name, saved[name]))
    try:
        yield saved
    finally:
        for name, k in KERNELS.items():
            setattr(*k["entry"], saved[name])


def _recorder(calls):
    """make() for `swapped`: record each call's arguments in calls[name],
    then call through to the wrapper."""
    def make(name, fn):
        def wrapped(*args, **kw):
            calls[name].append((args, kw))
            return fn(*args, **kw)
        return wrapped
    return make


def _single(plain):
    """The twin of a single-pair entry: the batched twin at B = 1."""
    def fn(*args, **kw):
        out = plain(*(a[None] for a in args), **kw)
        return out[0] if torch.is_tensor(out) else tuple(o[0] for o in out)
    return fn


# each kernel's plain twin, with its wrapper's signature: routes the main
# path through the twins on whatever device the tensors are
PLAIN = {
    "gn_fused": lambda *args: patch_solver._gn_plain(*args)[:3],
    "gn_tiled": lambda *args: patch_solver._gn_tiled_plain(*args)[:3],
    "bilerp_extract": patch_solver.extract_bilinear,
    "tv_of_inner": tv_of_inner._plain,
    "tv_of_inner_single": _single(tv_of_inner._plain),
    "tv_de_inner": tv_de_inner._plain,
    "tv_de_inner_single": _single(tv_de_inner._plain),
    "warp": tv.warp_image,
    "upscale": dis.upscale_output,
    "i8_dot": i8_dot._plain,
    "gn_stages": gn_stages._plain,
}


_launch_base = {}


def _launch_counts():
    return {name: trace.launches(k["library"], k["symbol"])
            for name, k in KERNELS.items()}


def reset_launches():
    """Count launches from here on."""
    _launch_base.clear()
    _launch_base.update(_launch_counts())


def read_launches():
    """Launch counts since the last reset, kernels never launched left
    out."""
    counts = {name: n - _launch_base.get(name, 0)
              for name, n in _launch_counts().items()}
    return {name: n for name, n in counts.items() if n}


# ------------------------------------------------- per-kernel comparisons

def check_gn(name, args, kernel_fn):
    """One GN call against its twin. `gn_fused` takes materialised
    templates (spec, params, im_b, tpl, p_init_t, pt_ref_t), `gn_tiled`
    the source planes in their place."""
    spec, params, im_b, tpl_or_src, p_init_t, pt_ref_t = args
    twin = (patch_solver._gn_plain if name == "gn_fused"
            else patch_solver._gn_tiled_plain)
    p_k, pw_k, it_k = kernel_fn(*args)
    p_p, pw_p, it_p, trips = twin(*args)
    torch.cuda.synchronize()
    err = float((p_k - p_p).abs().max())
    pw_err = float((pw_k - pw_p).abs().max()) / float(pw_p.abs().max())
    if int(it_k) != int(it_p):
        raise AssertionError(f"{name} iters {int(it_k)} != plain "
                             f"{int(it_p)} at level {spec.level}")
    if not (err <= TOL[name] and pw_err <= PWEIGHT_REL_TOL):
        raise AssertionError(f"{name} level {spec.level}: p err {err}, "
                             f"pweight rel err {pw_err}")
    b, c, hp, wp = im_b.shape
    n, nop = spec.nopatches, params.nop
    d = params.novals
    nh = 3 if nop == 2 else 1
    # trips are the ones this run's data needed
    n_trips = float(trips.sum())
    # outputs written once: p, the channel-summed pweight, iters; inputs
    # read once: the target planes, p_init, pt_ref and the templates
    nbytes = 4 * (b * c * hp * wp + nop * b * n + 2 * n
                  + nop * b * n + b * (d // c) * n + 1)
    if name == "gn_fused":
        # tmpl, tdx and for flow tdy, and the Hessians
        nbytes += 4 * ((1 + nop) * b * d * n + nh * b * n)
        # per element: 15 flops per extraction (9 bilinear, 2
        # mean-normalise, 3 residual / weight / clamp, 1 residual sum), one
        # extraction at the start and one per trip, plus 2 per trip and
        # projection (two for flow, one for depth)
        flops = d * (15.0 * (b * n + n_trips) + 2.0 * nop * n_trips)
    else:
        # the source image and its x- (for flow also y-) gradient planes
        nbytes += 4 * (1 + nop) * b * c * hp * wp
        # as gn_fused, with the projections taken inside every error
        # evaluation, one more extraction for the weight after the loop,
        # and per patch the template mean (2 per element) and the Hessian
        # entries (2 each)
        flops = d * (15.0 * (2 * b * n + n_trips)
                     + 2.0 * nop * (b * n + n_trips)
                     + (2.0 + 2.0 * nh) * b * n)
    return dict(
        shape=f"B{b} N{n} D{d} nop{nop} planes {c}x{hp}x{wp}",
        max_abs_err=err, pweight_rel_err=pw_err, iters=int(it_k),
        twin_pairs=b, trips=n_trips,
        wrapper_ms=cuda_ms(lambda: kernel_fn(*args), 5, 10),
        plain_ms=cuda_ms(lambda: twin(*args), 2, 1),
        library_wrapper_ms=None, device_ms=device_ms(kernel_fn, args),
        library_device_ms=None, bound=bound(nbytes, flops))


def check_routes(label, spec, params, im_b, src, p_init):
    """One GN level on both fused routes, for the routing rule
    (`patch_solver.uses_tiled`): templates gathered into device memory by
    plain torch and then `gn_fused`, against `gn_tiled` on the source
    planes. Prints the two times and how far their results lie apart; where
    that is more than 1e-3 px, the three patches furthest apart, with the
    trips each route's twin ran for them."""
    pt_ref_t = patch_solver.grid_ref_points(spec, im_b.device).T[None] \
        .contiguous()
    p_init_t = p_init.transpose(1, 2).contiguous()

    def fused_route():
        tpl = patch_solver.extract_templates(spec, params, *src)
        return gn_fused.gn_fused(spec, params, im_b, tpl, p_init_t, pt_ref_t)

    def tiled_route():
        return gn_tiled.gn_tiled(spec, params, im_b, src, p_init_t, pt_ref_t)

    p_f, p_t = fused_route()[0], tiled_route()[0]
    apart = (p_f - p_t).abs().amax(dim=1)                 # (B, N)
    diff = float(apart.max())
    worst = []
    if diff > 1e-3:
        tpl = patch_solver.extract_templates(spec, params, *src)
        trips_f = patch_solver._gn_plain(spec, params, im_b, tpl, p_init_t,
                                         pt_ref_t)[3]
        trips_t = patch_solver._gn_tiled_plain(spec, params, im_b, src,
                                               p_init_t, pt_ref_t)[3]
        for flat in torch.topk(apart.flatten(), min(3, apart.numel())
                               ).indices.tolist():
            b, n = divmod(flat, apart.shape[1])
            worst.append({
                "pair": b, "patch": n, "ref": pt_ref_t[0, :, n].tolist(),
                "p_init": p_init_t[b, :, n].tolist(),
                "p_fused": p_f[b, :, n].tolist(),
                "p_tiled": p_t[b, :, n].tolist(),
                "trips_fused_twin": int(trips_f[b, n]),
                "trips_tiled_twin": int(trips_t[b, n])})
    print(json.dumps({
        "path": label, "routes_level": spec.level, "grid": spec.camlr,
        "patches": spec.nopatches, "batch": im_b.shape[0],
        "psz": params.p_samp_s, "trips": params.max_iter,
        "uses_tiled": patch_solver.uses_tiled(spec),
        "fused_route_ms": cuda_ms(fused_route, 3, 2),
        "tiled_route_ms": cuda_ms(tiled_route, 3, 2),
        "routes_max_abs_diff": diff,
        "patches_over_1e-3": int((apart > 1e-3).sum()),
        "furthest_apart": worst}), flush=True)


def check_extract(args, kernel_fn):
    """One patch extraction against its twin."""
    im, pts, psz, pad = args
    o_k = kernel_fn(*args)
    o_p = patch_solver.extract_bilinear(*args)
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    if not (o_k.shape == o_p.shape and err <= TOL["bilerp_extract"]):
        raise AssertionError(f"bilerp_extract {tuple(o_k.shape)}: err {err}")
    b, c, hp, wp = im.shape
    n = pts.shape[1]
    d = psz * psz * c
    # library yardstick: grid_sample at every tap position of every patch,
    # pt - psz/2 + pad + (i, j) in the padded planes, a (B, psz^2, N, 2)
    # grid built outside the timing; its output (B, C, psz^2, N). It
    # differs from the kernel where the kernel's anchor ceil(pt + 1e-5)
    # lands one pixel left (integer positions from 256 on, where 1e-5 is
    # below half an ulp) and beyond the planes (it clamps the coordinate,
    # the kernel each tap)
    jj, ii = (t.reshape(-1).to(im.device, torch.float32) for t in
              torch.meshgrid(torch.arange(psz), torch.arange(psz),
                             indexing="ij"))
    base = pts + float(pad - psz // 2)                    # (B, N, 2)
    gx = (base[:, None, :, 0] + ii[None, :, None]) * (2.0 / (wp - 1)) - 1.0
    gy = (base[:, None, :, 1] + jj[None, :, None]) * (2.0 / (hp - 1)) - 1.0
    grid = torch.stack([gx, gy], dim=-1)

    def lib_call(planes, g):
        return F.grid_sample(planes, g, mode="bilinear",
                             padding_mode="border", align_corners=True)

    lib = lambda: lib_call(im, grid)  # noqa: E731
    lib_diff = float((lib().permute(0, 2, 1, 3).reshape(b, d, n)
                      - o_p).abs().max()) if c == 1 else None
    # planes and positions read once, the patches written once; per element
    # two y-lerps and one x-lerp of three operations each
    nbytes = 4 * (b * c * hp * wp + 2 * b * n + b * d * n)
    flops = 9.0 * b * d * n
    return dict(
        shape=f"B{b} N{n} D{d} planes {c}x{hp}x{wp}", max_abs_err=err,
        library_max_abs_diff=lib_diff,
        wrapper_ms=cuda_ms(lambda: kernel_fn(*args), 5, 10),
        plain_ms=cuda_ms(lambda: patch_solver.extract_bilinear(*args), 2, 1),
        library_wrapper_ms=cuda_ms(lib, 5, 10),
        device_ms=device_ms(kernel_fn, args),
        library_device_ms=device_ms(lib_call, (im, grid)),
        bound=bound(nbytes, flops))


def tv_flops_per_px(name, n_solver, colour, noc):
    """Float operations per pixel and inner iteration of a TV loop, as the
    kernel does them. Flow: smoothness 18, data term 64 gray / 212 RGB
    (44 / 136 without the colour term), sub_laplacian and the hoisted SOR
    terms 23, uu/vv 2, and 24 per SOR sweep (each pixel updated once per
    sweep). Depth: smoothness 10, data term 53 gray / 143 RGB (34 / 94),
    sub_laplacian and the hoisted term 15, uu and its clamp 2, and 11 per
    sweep."""
    if name.startswith("tv_of"):
        data = {1: (64, 44), 3: (212, 136)}[noc][0 if colour else 1]
        return 18 + data + 23 + 2 + 24 * n_solver
    data = {1: (53, 34), 3: (143, 94)}[noc][0 if colour else 1]
    return 10 + data + 15 + 2 + 11 * n_solver


def check_tv(name, args, kw, kernel_fn):
    """One TV entry (flow or depth, batched or single pair) against its
    twin. args = (wx, [wy,] mask, deriv), unbatched for a single entry."""
    def tup(out):
        return (out,) if torch.is_tensor(out) else tuple(out)

    wx, deriv = args[0], args[-1]
    out_k = tup(kernel_fn(*args, **kw))
    route = {}
    if name.startswith("tv_de_inner"):
        b_, h_, w_ = (1, *wx.shape) if wx.ndim == 2 else tuple(wx.shape)
        rule = tv_de_inner.route(b_, h_, w_)
        if tv_de_inner.last_route != rule:
            raise AssertionError(f"{name} {tuple(wx.shape)}: launched "
                                 f"{tv_de_inner.last_route}, rule {rule}")
        route = dict(route=list(rule), max_clusters=(
            tv_de_inner.max_clusters(wx.device, deriv.shape[-3], rule[1],
                                     h_, w_) if rule[0] == "cluster"
            else None))
    plain = lambda: PLAIN[name](*args, **kw)  # noqa: E731
    out_p = tup(plain())
    torch.cuda.synchronize()
    err = max(float((k - p).abs().max()) for k, p in zip(out_k, out_p))
    if not err <= TOL[name]:
        raise AssertionError(f"{name} {tuple(wx.shape)}: err {err}")
    h, w = wx.shape[-2:]
    b = wx.shape[0] if wx.ndim == 3 else 1
    noc = deriv.shape[-3]
    # inputs wx, [wy,] mask and 8 derivative planes per channel read once,
    # outputs uu [, vv] written once
    nbytes = 4 * b * h * w * (len(args) - 1 + 8 * noc + len(out_k))
    flops = b * h * w * kw["n_inner"] * tv_flops_per_px(
        name, kw["n_solver"], bool(kw["hd3"]), noc)
    return dict(
        shape=f"B{b} C{noc} {h}x{w} n_inner {kw['n_inner']}", **route,
        max_abs_err=err,
        wrapper_ms=cuda_ms(lambda: kernel_fn(*args, **kw), 5, 10),
        plain_ms=cuda_ms(plain, 2, 1), library_wrapper_ms=None,
        device_ms=device_ms(lambda *a: kernel_fn(*a, **kw), args),
        library_device_ms=None, bound=bound(nbytes, flops))


def check_warp(args, kw, kernel_fn):
    """One warp call against its twin; `kw` may hold the row origin of a
    block of a row-sharded level (src then has more rows than the
    fields)."""
    src, wx, wy = args
    row0 = kw.get("row0", 0)
    o_k, m_k = kernel_fn(*args, **kw)
    o_p, m_p = tv.warp_image(*args, row0)
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    if not (err <= TOL["warp"] and torch.equal(m_k, m_p)):
        raise AssertionError(f"warp {tuple(src.shape)}: err {err}, masks "
                             f"equal {torch.equal(m_k, m_p)}")
    b, c, hs, w = src.shape
    h = wx.shape[-2]
    # library yardstick: grid_sample with border padding at the same
    # absolute positions (no mask); the grid is built outside the timing
    gy = torch.arange(row0, row0 + h, dtype=torch.float32,
                      device=src.device)[:, None]
    gx = torch.arange(w, dtype=torch.float32, device=src.device)[None, :]
    grid = torch.stack([(gx + wx) * (2.0 / (w - 1)) - 1.0,
                        (gy + wy) * (2.0 / (hs - 1)) - 1.0], dim=-1)

    def lib_call(planes, g):
        return F.grid_sample(planes, g, mode="bilinear",
                             padding_mode="border", align_corners=True)

    lib = lambda: lib_call(src, grid)  # noqa: E731
    lib_diff = float((lib() - o_p).abs().max())
    # the flow read, the output and mask written, and of the source the
    # rows this call's samples reach (each pair's span of clamped corner
    # rows; the whole frame on a whole-frame call, about the block's own
    # rows on a block of a row-sharded level), each read once
    yy = gy + wy
    lo = yy.amin(dim=(1, 2)).floor().clamp(0, hs - 1)
    hi = (yy.amax(dim=(1, 2)).floor() + 1).clamp(0, hs - 1)
    src_rows = float((hi - lo + 1).sum())
    nbytes = 4 * (c * src_rows * w + b * h * w * (c + 3))
    flops = b * h * w * (10 + 13 * c)
    return dict(
        shape=f"B{b} C{c} {h}x{w}" + (f" rows {row0}.. of {hs}"
                                      if (row0, hs) != (0, h) else ""),
        max_abs_err=err, library_max_abs_diff=lib_diff,
        wrapper_ms=cuda_ms(lambda: kernel_fn(*args, **kw), 5, 10),
        plain_ms=cuda_ms(lambda: tv.warp_image(*args, row0), 5, 5),
        library_wrapper_ms=cuda_ms(lib, 5, 10),
        device_ms=device_ms(lambda *a: kernel_fn(*a, **kw), args),
        library_device_ms=device_ms(lib_call, (src, grid)),
        bound=bound(nbytes, flops))


def check_upscale(args, kernel_fn):
    flow, sc_l, out_h, out_w = args
    o_k = kernel_fn(*args)
    o_p = dis.upscale_output(*args)
    torch.cuda.synchronize()
    err = float((o_k - o_p).abs().max())
    if not err <= TOL["upscale"]:
        raise AssertionError(f"upscale {tuple(flow.shape)}: err {err}")
    b, h, w, nop = flow.shape
    # library yardstick: one bilinear interpolate of the pre-scaled planar
    # flow (half-pixel centres, edge clamp = INTER_LINEAR)
    f_cf = (flow * float(2 ** sc_l)).movedim(-1, 1).contiguous()

    def lib_call(planar):
        return F.interpolate(planar, size=(out_h, out_w), mode="bilinear",
                             align_corners=False)

    lib = lambda: lib_call(f_cf)  # noqa: E731
    lib_diff = float((lib().movedim(1, -1) - o_p).abs().max())
    nbytes = 4 * nop * (b * h * w + b * out_h * out_w) + 16 * (out_h + out_w)
    flops = 6.0 * nop * b * out_h * out_w
    return dict(
        shape=f"B{b} {h}x{w}x{nop} -> {out_h}x{out_w}",
        max_abs_err=err, library_max_abs_diff=lib_diff,
        wrapper_ms=cuda_ms(lambda: kernel_fn(*args), 5, 10),
        plain_ms=cuda_ms(lambda: dis.upscale_output(*args), 5, 5),
        library_wrapper_ms=cuda_ms(lib, 5, 10),
        device_ms=device_ms(kernel_fn, args),
        library_device_ms=device_ms(lib_call, (f_cf,)),
        bound=bound(nbytes, flops))


def epe_ratio(ours, ref):
    """Mean end-point error over the reference's mean magnitude, over the
    trailing parameter axis (2 for flow, 1 for depth)."""
    d = torch.linalg.vector_norm(ours - ref, dim=-1)
    return float(d.mean() / torch.linalg.vector_norm(ref, dim=-1).mean())


CHECKS = {"gn_fused": lambda name, args, kw, fn: check_gn(name, args, fn),
          "gn_tiled": lambda name, args, kw, fn: check_gn(name, args, fn),
          "bilerp_extract": lambda name, args, kw, fn: check_extract(args, fn),
          "warp": lambda name, args, kw, fn: check_warp(args, kw, fn),
          "upscale": lambda name, args, kw, fn: check_upscale(args, fn)}


def call_level(name, args, full_w, finest):
    """The pyramid level of a recorded call, and for a GN call the grid
    (camlr 1 is the merge's backward grid): from the level spec of a GN
    call, from the field width of a TV or warp call; the upscale follows
    the finest level."""
    if name.startswith("gn_"):
        return args[0].level, args[0].camlr
    if name == "upscale":
        return finest, 0
    if name == "bilerp_extract":
        # (im, pts, psz, pad): the padded planes' width
        width = args[0].shape[-1] - 2 * args[3]
        return int(round(math.log2(full_w / width))), 0
    return int(round(math.log2(full_w / args[0].shape[-1]))), 0


# kernels whose device time is also printed summed per level of a path
PER_LEVEL = ("gn_fused", "bilerp_extract", "tv_de_inner")


def check_call(name, args, kw, wrapper, rows):
    """One recorded call of a kernel against its twin (CHECKS, else
    check_tv), its bound split into bound_ms / bytes_ms / ops_ms; the row
    is appended to rows[name] and returned."""
    r = CHECKS.get(name, check_tv)(name, args, kw, wrapper)
    b_ms, by_ms, op_ms = r.pop("bound")
    r.update(bound_ms=b_ms, bytes_ms=by_ms, ops_ms=op_ms)
    rows[name].append(r)
    return r


def check_calls(label, calls, wrappers, rows, full_w, finest, de_routes=None):
    """Hold every recorded call of every kernel against its twin, time it,
    print one JSON line per call and append the rows to rows[name]; for
    the kernels of PER_LEVEL also one line of device ms per level, summed
    over the level's calls, with the card's name and power limit. A depth
    TV call's route must be the one `de_routes` gives its level."""
    for name, recorded in calls.items():
        seen = {}
        per_level = {}
        for args, kw in recorded:
            r = check_call(name, args, kw, wrappers[name], rows)
            level, _ = call_level(name, args, full_w, finest)
            if "route" in r and tuple(r["route"]) != de_routes[level]:
                raise AssertionError(f"path {label} {name} level {level}: "
                                     f"route {r['route']}, expected "
                                     f"{de_routes[level]}")
            # with the merge a level's second call is the backward grid's;
            # the extraction runs many times a level: its calls are numbered
            seen[level] = seen.get(level, 0) + 1
            if name == "bilerp_extract":
                grid = f"call {seen[level]}"
            else:
                grid = "forward" if seen[level] == 1 else "backward"
            # each recorded call is one launch of the kernel on the path
            print(json.dumps({"path": label, "kernel": name, "level": level,
                              "grid": grid, "launches": 1,
                              "tolerance": TOL[name], **r}), flush=True)
            per_level[level] = per_level.get(level, 0.0) + r["device_ms"]
        if name in PER_LEVEL and per_level:
            print(json.dumps({"path": label, "kernel": name,
                              "device_ms_per_level": per_level,
                              "calls_per_level": seen,
                              "card": nvidia_smi_line()}), flush=True)


def launches_as_expected(counts, cfg) -> bool:
    """Whether one call's launch counts are the path's: exact for every
    kernel but those of `at_least`, which must reach their floor."""
    floor = cfg.get("at_least", {})
    exact = {name: n for name, n in counts.items() if name not in floor}
    return exact == cfg["launches"] and all(
        counts.get(name, 0) >= n for name, n in floor.items())


def run_path(cfg, dev, rows, totals, walls_by_path):
    """Phases 3 and 4 for one path; its median wall time goes to
    walls_by_path[name]. Returns the recorded inputs and result of the finest
    level's batched TV call, for the single-pair phase, and that level."""
    label, nop, noc, batch = cfg["name"], cfg["nop"], cfg["noc"], cfg["batch"]
    op = cfg["op"]
    if op is None:
        params = cli.build_params(W_ORG, nop, noc, cfg["args"].split())
    else:
        params = op_point_params(W_ORG, op, nop=nop, noc=noc)
    if cfg.get("fbcon"):
        params = dataclasses.replace(params, usefbcon=True)
    t0 = time.perf_counter()
    field = synth.flow_field if nop == 2 else synth.disparity_field
    a_u8, b_u8, u_true, v_true = synth.make_pairs(
        batch, H_ORG, W_ORG, 0, dev, channels=noc, field=field)
    im_a = pyramid.pad_to_divisible(a_u8, params.sc_f)
    im_b = pyramid.pad_to_divisible(b_u8, params.sc_f)
    full_h, full_w = im_a.shape[2], im_a.shape[3]
    torch.cuda.synchronize()
    print(f"path {label} ({cfg['what']}, nop={nop}, noc={noc}): {batch} x "
          f"{noc}x{H_ORG}x{W_ORG} u8 -> padded {full_h}x{full_w} in "
          f"{time.perf_counter() - t0:.2f} s; levels {params.sc_f}.."
          f"{params.sc_l}", flush=True)

    def run(a=im_a, b=im_b):
        return dis.dis_flow_batched(a, b, params, full_w, full_h, device=dev)

    # 3. each kernel against its plain twin on the path's inputs; the
    # batched TV entry's inputs and result are kept for phase 5
    tv_entry = "ref_level_of_batched" if nop == 2 else "ref_level_de_batched"
    tv_fn = getattr(tv, tv_entry)
    tv_calls = []

    def tv_recorded(*args, **kw):
        out = tv_fn(*args, **kw)
        tv_calls.append((args, kw, out))
        return out

    gn_level = patch_solver.optimize_level_batched
    gn_levels = []

    def gn_recorded(spec, prm, target, tpl, p_init, src=None):
        gn_levels.append((spec, prm, target, src, p_init))
        return gn_level(spec, prm, target, tpl, p_init, src=src)

    calls = {name: [] for name in KERNELS}
    setattr(tv, tv_entry, tv_recorded)
    patch_solver.optimize_level_batched = gn_recorded
    try:
        with swapped(_recorder(calls)) as wrappers:
            run()
    finally:
        setattr(tv, tv_entry, tv_fn)
        patch_solver.optimize_level_batched = gn_level
    torch.cuda.synchronize()
    recorded = {name: len(c) for name, c in calls.items() if c}
    if not launches_as_expected(recorded, cfg):
        raise AssertionError(f"path {label}: calls {recorded}, expected "
                             f"{cfg['launches']}, at least "
                             f"{cfg.get('at_least', {})}")
    first = {name: len(rs) for name, rs in rows.items()}
    check_calls(label, calls, wrappers, rows, full_w, params.sc_l,
                cfg.get("de_routes"))
    if cfg.get("routes"):
        for level_args in gn_levels:
            check_routes(label, *level_args)
    del gn_levels

    # 4. end to end, counted
    reset_launches()
    flow = run()
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"path {label}: launches in one dis_flow_batched call: "
          f"{json.dumps(launches)}", flush=True)
    if not launches_as_expected(launches, cfg):
        raise AssertionError(f"path {label}: launches {launches} != expected "
                             f"{cfg['launches']}, at least "
                             f"{cfg.get('at_least', {})}")
    for name, n in launches.items():
        totals[name] = totals.get(name, 0) + n
    if tuple(flow.shape) != (batch, full_h, full_w, nop) or \
            not bool(torch.isfinite(flow).all()):
        raise AssertionError(f"flow shape {tuple(flow.shape)} or non-finite")
    top = (full_h - H_ORG) // 2
    # interior, away from the border where the warp's clamp rules
    crop = flow[:, top + 32:top + H_ORG - 32, 32:W_ORG - 32]
    true = torch.stack([u_true, v_true], -1)[32:-32, 32:-32, :nop]
    med = crop.reshape(-1, nop).median(dim=0).values
    med_true = true.reshape(-1, nop).median(dim=0).values
    epe_true = float(torch.linalg.vector_norm(crop - true, dim=-1).mean())
    print(f"path {label}: median {med.tolist()} vs true {med_true.tolist()}; "
          f"mean EPE vs the true field {epe_true:.4f} px", flush=True)
    # op-2 stops at 1/8 resolution (op-3 at 1/2, op-4 at full);
    # tests/test_torch_dis.py holds the JAX reference to the same limits
    # on this workload at op-2
    if float((med - med_true).abs().max()) > 0.25 or epe_true > 0.6:
        raise AssertionError(f"path {label}: result does not follow the "
                             "synthetic field")
    if nop == 1 and float(flow.max()) > 0.0:
        raise AssertionError(f"path {label}: positive disparity "
                             f"{float(flow.max())} for the left camera")
    if cfg.get("fbcon") and not torch.equal(flow, run()):
        raise AssertionError(f"path {label}: two calls with the merge differ")
    few = cfg.get("plain_pairs", 4)
    with swapped(lambda name, _: PLAIN[name]):
        ref4 = run(im_a[:few], im_b[:few])
    ours4 = run(im_a[:few], im_b[:few])
    ratio = epe_ratio(ours4, ref4)
    print(f"path {label}: EPE ratio, kernel path vs plain path on the card, "
          f"{few} pairs: {ratio:.3e}", flush=True)
    # the batch split: the first pairs as a batch of their own, and the
    # first pair alone, against the same pairs in the full batch
    alone = run(im_a[:1], im_b[:1])
    split = max(float((ours4 - flow[:few]).abs().max()),
                float((alone - flow[:1]).abs().max()))
    print(f"path {label}: {few} pairs and 1 pair alone vs in the batch of "
          f"{batch}: max |diff| {split:.3e} px", flush=True)
    if not split <= 1e-5:
        raise AssertionError(f"path {label}: a pair's flow depends on its "
                             f"batch by {split} px")
    if not ratio < 1e-3:
        raise AssertionError(f"path {label}: kernel path EPE ratio {ratio} "
                             ">= 1e-3")
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    walls_by_path[label] = wall
    print(json.dumps({"e2e": "dis_flow_batched", "path": label, "op": op,
                      "fbcon": bool(cfg.get("fbcon")),
                      "nop": nop, "noc": noc, "batch": batch,
                      "size": f"{W_ORG}x{H_ORG}", "wall_s": walls,
                      "median_wall_s": wall, "pairs_per_s": batch / wall}),
          flush=True)
    profile_call(f"dis_flow_batched path {label}", run, wall)
    # per kernel, summed over its calls in this path's run
    print(json.dumps({"path": label, "kernel_ms": {
        name: {key: sum(r[key] for r in rs[first[name]:])
               for key in ("wrapper_ms", "device_ms", "library_wrapper_ms",
                           "library_device_ms", "plain_ms", "bound_ms")
               if rs[-1].get(key) is not None}
        for name, rs in rows.items() if len(rs) > first[name]}}), flush=True)
    return tv_calls[-1], params.sc_l


def run_single(label, finest, rows, totals):
    """Phase 5 for one path: the single-pair TV entry on pair 0 of the
    finest level's recorded inputs."""
    (args, kw, batched), level = finest
    flow_path = len(args) == 4                 # (wx, wy, im1, im2)
    entry = tv.ref_level_of if flow_path else tv.ref_level_de
    name = "tv_of_inner_single" if flow_path else "tv_de_inner_single"
    pair0 = tuple(a[0].contiguous() for a in args)
    expected = {name: 1, "warp": 1}
    calls = {n: [] for n in KERNELS}
    with swapped(_recorder(calls)) as wrappers:
        entry(*pair0, **kw)
    check_calls(label + "'", {n: calls[n] for n in expected}, wrappers, rows,
                W_ORG, level, SINGLE_DE_ROUTES)
    reset_launches()
    out = entry(*pair0, **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"path {label}': launches in one {entry.__name__} call: "
          f"{json.dumps(launches)}", flush=True)
    if launches != expected:
        raise AssertionError(f"path {label}': launches {launches} != "
                             f"expected {expected}")
    for kernel, n in launches.items():
        totals[kernel] = totals.get(kernel, 0) + n
    outs = (out,) if torch.is_tensor(out) else out
    rows0 = (batched,) if torch.is_tensor(batched) else batched
    for o, r in zip(outs, rows0):
        if o.shape != r.shape[1:] or not torch.equal(o, r[0]):
            raise AssertionError(f"{entry.__name__} differs from row 0 of "
                                 "the batched result")
    print(f"path {label}': {entry.__name__} on one {tuple(outs[0].shape)} "
          "pair equals row 0 of the batched result", flush=True)


# Path J: S streams of T frames through the warm-started sequence mode at
# op-2, gray flow; each step launches what one path-A call launches.
SEQUENCE = dict(name="J", what="warm sequence, op-2 gray flow", op=2,
                streams=16, frames=5, plain_streams=4)


def run_sequence(dev, rows, totals, walls_by_path):
    """Phase 6: path J. `dis_sequence_batched` on S streams x T frames at
    op-2 (1024x436 padded to 1024x448, which divides 2^(sc_f+1)): every
    kernel call of one run against its twin; launches counted over the run
    and per step (a loop of `dis_step_warm`, equal to the run bit for bit),
    each step's equal to path A's per call; per step the median flow
    against the field, the kernel path against the plain path on a few
    streams and stream 0 against `dis_sequence` on that stream; wall ms per
    step beside path A's and one profiled step."""
    cfg = SEQUENCE
    label, s, t_n = cfg["name"], cfg["streams"], cfg["frames"]
    params = op_point_params(W_ORG, cfg["op"], nop=2, noc=1)
    frames, u_true, v_true = synth.make_sequence(s, t_n, H_ORG, W_ORG, 0,
                                                 dev)
    frames = pyramid.pad_to_divisible(frames, params.sc_f + 1)
    full_h, full_w = frames.shape[-2], frames.shape[-1]
    k = 2 ** (params.sc_f + 1)
    if full_h % k or full_w % k:
        raise AssertionError(f"path {label}: {full_h}x{full_w} does not "
                             f"divide {k}")
    print(f"path {label} ({cfg['what']}): {s} streams x {t_n} frames, "
          f"1x{H_ORG}x{W_ORG} u8 -> padded {full_h}x{full_w}; levels "
          f"{params.sc_f}..{params.sc_l}, warm start at "
          f"{full_h // k}x{full_w // k}", flush=True)

    def run(x=frames):
        return dis.dis_sequence_batched(x, params, full_w, full_h, device=dev)

    # every kernel call of one run (a loop of its steps) against its twin
    carry = dis.warm_carry_init(s, params, full_w, full_h, device=dev)
    for t in range(t_n - 1):
        calls = {name: [] for name in KERNELS}
        with swapped(_recorder(calls)) as wrappers:
            _, carry = dis.dis_step_warm(frames[t], frames[t + 1], params,
                                         full_w, full_h, carry, device=dev)
        torch.cuda.synchronize()
        check_calls(f"{label} step {t}", {n: c for n, c in calls.items()
                                          if c}, wrappers, rows, full_w,
                    params.sc_l)

    # one run, counted, and each step counted on its own
    per_call = next(c["launches"] for c in PATHS if c["name"] == "A")
    reset_launches()
    flows = run()
    torch.cuda.synchronize()
    launches = read_launches()
    steps = t_n - 1
    print(f"path {label}: launches in one dis_sequence_batched call "
          f"({steps} steps): {json.dumps(launches)}", flush=True)
    if launches != {name: steps * n for name, n in per_call.items()}:
        raise AssertionError(f"path {label}: launches {launches}, expected "
                             f"{steps} x {per_call}")
    for name, n in launches.items():
        totals[name] = totals.get(name, 0) + n
    carry = dis.warm_carry_init(s, params, full_w, full_h, device=dev)
    step_flows = []
    for t in range(steps):
        reset_launches()
        flow, carry = dis.dis_step_warm(frames[t], frames[t + 1], params,
                                        full_w, full_h, carry, device=dev)
        torch.cuda.synchronize()
        step = read_launches()
        print(f"path {label} step {t}: launches {json.dumps(step)} (path A "
              f"per call: {json.dumps(per_call)})", flush=True)
        if step != per_call:
            raise AssertionError(f"path {label} step {t}: launches {step}")
        step_flows.append(flow)
    if not torch.equal(torch.stack(step_flows), flows):
        raise AssertionError(f"path {label}: a loop of dis_step_warm differs "
                             "from dis_sequence_batched")
    if tuple(flows.shape) != (steps, s, full_h, full_w, 2) or \
            not bool(torch.isfinite(flows).all()):
        raise AssertionError(f"path {label}: flows {tuple(flows.shape)} or "
                             "non-finite")

    # per step: the field, the plain path, dis_sequence on stream 0
    few = cfg["plain_streams"]
    with swapped(lambda name, _: PLAIN[name]):
        ref = run(frames[:, :few])
    ours = run(frames[:, :few])
    single = dis.dis_sequence(frames[:, 0], params, full_w, full_h,
                              device=dev)
    top = (full_h - H_ORG) // 2
    true = torch.stack([u_true, v_true], -1)[32:-32, 32:-32]
    med_true = true.reshape(-1, 2).median(dim=0).values
    for t in range(steps):
        crop = flows[t, :, top + 32:top + H_ORG - 32, 32:W_ORG - 32]
        med = crop.reshape(-1, 2).median(dim=0).values
        epe_true = float(torch.linalg.vector_norm(crop - true, dim=-1).mean())
        ratio = epe_ratio(ours[t], ref[t])
        seq_diff = float((flows[t, 0] - single[t]).abs().max())
        print(json.dumps({"path": label, "step": t,
                          "median": med.tolist(),
                          "median_true": med_true.tolist(),
                          "epe_vs_field": epe_true,
                          "epe_ratio_vs_plain": ratio,
                          "plain_streams": few,
                          "stream0_vs_dis_sequence_max_abs": seq_diff}),
              flush=True)
        if float((med - med_true).abs().max()) > 0.25:
            raise AssertionError(f"path {label} step {t}: median "
                                 f"{med.tolist()} vs {med_true.tolist()}")
        if not ratio < 1e-3:
            raise AssertionError(f"path {label} step {t}: kernel path EPE "
                                 f"ratio {ratio} >= 1e-3")
        if not seq_diff <= 1e-4:
            raise AssertionError(f"path {label} step {t}: stream 0 differs "
                                 f"from dis_sequence by {seq_diff} px")

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    # the same S pairs cold, through dis_flow_batched
    cold = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dis.dis_flow_batched(frames[0], frames[1], params, full_w, full_h,
                             device=dev)
        torch.cuda.synchronize()
        cold.append(time.perf_counter() - t0)
    print(json.dumps({"e2e": "dis_sequence_batched", "path": label,
                      "op": cfg["op"], "streams": s, "frames": t_n,
                      "size": f"{W_ORG}x{H_ORG}", "wall_s": walls,
                      "median_wall_s": wall,
                      "wall_ms_per_step": wall * 1e3 / steps,
                      "cold_wall_ms_same_pairs":
                          statistics.median(cold) * 1e3,
                      "path_a_wall_ms_per_call": walls_by_path["A"] * 1e3,
                      "pairs_per_s": s * steps / wall}), flush=True)
    carry = dis.warm_carry_init(s, params, full_w, full_h, device=dev)
    _, carry = dis.dis_step_warm(frames[0], frames[1], params, full_w,
                                 full_h, carry, device=dev)
    profile_call(f"dis_step_warm path {label} (a warm step)",
                 lambda: dis.dis_step_warm(frames[1], frames[2], params,
                                           full_w, full_h, carry, device=dev),
                 wall / steps)


def run_cli_init_flow():
    """Phase 6, second part: `cli.main` at op-2 with `--init-flow` (the
    op-2 gray-flow golden as the start), counted; its file against the
    same run on the plain twins."""
    os.makedirs(OUT_DIR, exist_ok=True)
    gold = os.path.join(ROOT, "tests", "goldens")
    init = os.path.join(gold, "of_int_op2.flo")
    argv = ["run_OF_INT", os.path.join(gold, "a.png"),
            os.path.join(gold, "b.png")]
    out, plain = (os.path.join(OUT_DIR, f"init_flow_{n}.flo")
                  for n in ("kernels", "plain"))
    reset_launches()
    cli.main(argv + [out, "2", "--init-flow", init, "--quiet"])
    launches = read_launches()
    with swapped(lambda name, _: PLAIN[name]):
        cli.main(argv + [plain, "2", "--init-flow", init, "--quiet"])
    ours, ref = io.read_flo(out), io.read_flo(plain)
    ratio = epe_ratio(torch.as_tensor(ours), torch.as_tensor(ref))
    golden = epe_ratio(torch.as_tensor(ours), torch.as_tensor(
        io.read_flo(init)))
    print(f"cli --init-flow at op-2: {ours.shape} flow, EPE ratio vs the "
          f"plain path {ratio:.3e}, vs the golden it started from "
          f"{golden:.3e}; launches {json.dumps(launches)}", flush=True)
    if ours.shape != (160, 192, 2) or not np.isfinite(ours).all():
        raise AssertionError("cli --init-flow: bad output")
    if not ratio < 1e-3:
        raise AssertionError(f"cli --init-flow: EPE ratio {ratio} vs plain")
    if not launches.get("gn_fused"):
        raise AssertionError(f"cli --init-flow: launches {launches}")


# Phase 7: the serving pipeline at op-2 gray flow on PNG frames of the
# Sintel size (`tools.bench_pipeline.make_frames`). `frames` frames moving
# `step` px a frame make frames - 1 pairs: at batch 64, two full batches
# and a ragged tail of 32; --streams 16 gives 10 steps of 16 lanes; the
# depth run's frames move by `depth_step` (the left camera's disparity is
# <= 0); the split runs the cold batches over two devices (the card twice).
PIPELINE = dict(op=2, frames=161, step=(1.3, 0.4), batch=64, streams=16,
                depth_frames=17, depth_step=(-1.3, 0.0),
                decode_threads=(1, 4, 8, 16))
# px: a file against `dis_flow_batched` on the same decoded frames; a
# pair's flow does not depend on its batch (the Hessian's and the
# densification's sums in float64), so 0 is expected
PIPELINE_TOL = 1e-4


def _timed(fn, runs: int = 3):
    """Wall seconds of `runs` calls of fn (each ends in a synchronize),
    and fn's last result."""
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, out


def _pipeline_files(out_dir, names, want, nop):
    """The largest difference (px) between the pipeline's files `names` and
    the rows of `want` (n, h, w, nop) on the card, and each file's median
    over the interior (32 px from the border)."""
    worst, meds = 0.0, []
    for k, name in enumerate(names):
        path = os.path.join(out_dir, name)
        got = io.read_flo(path) if nop == 2 else io.read_pfm(path)[..., None]
        got = torch.as_tensor(got.copy())
        worst = max(worst, float((got - want[k].cpu()).abs().max()))
        meds.append(got[32:-32, 32:-32].reshape(-1, nop).median(dim=0)
                    .values.tolist())
    return worst, meds


def _check_medians(what, meds, motion):
    off = max(abs(m - t) for med in meds for m, t in zip(med, motion))
    if not off <= 0.25:
        raise AssertionError(f"pipeline {what}: a median is {off} px from "
                             f"the motion {motion}")
    return off


def run_pipeline_phase(dev, totals, walls_by_path):
    """Phase 7: the serving pipeline end to end on the card (see the
    module docstring); every pipeline run counted, its launches added to
    the kernels' totals."""
    cfg = PIPELINE
    t_phase = time.perf_counter()
    root = os.path.join(OUT_DIR, "pipeline")
    frame_dir, depth_dir = (os.path.join(root, d) for d in ("frames",
                                                            "depth"))
    bench_pipeline.make_frames(frame_dir, cfg["frames"], cfg["step"],
                               seed=0, device=dev)
    bench_pipeline.make_frames(depth_dir, cfg["depth_frames"],
                               cfg["depth_step"], seed=1, device=dev)
    paths = pipeline.list_frames(frame_dir)
    n_pairs = len(paths) - 1
    made = time.perf_counter() - t_phase

    # decode rate: the batch decoder on every frame at each thread count
    # (its pixels are held to cv2's by part 7c's manifest, whose 8-bit
    # gray PNG frames use all five filters)
    decoded = native_io.decode_batch(paths, 1)
    rates = {}
    for k in cfg["decode_threads"]:
        with ThreadPoolExecutor(k) as pool:
            t0 = time.perf_counter()
            again = native_io.decode_batch(paths, 1, pool=pool)
            rates[k] = len(paths) / (time.perf_counter() - t0)
        if not np.array_equal(again, decoded):
            raise AssertionError(f"decode_batch with {k} threads differs")
    print(json.dumps({"pipeline": "decode", "frames": len(paths),
                      "size": f"{W_ORG}x{H_ORG}", "png_rows": "filters 0-4",
                      "frames_per_s_by_threads": rates,
                      "cpu_count": os.cpu_count(), "card": nvidia_smi_line()}),
          flush=True)

    # the bare calls on the decoded frames, batched as the pipeline batches
    params = op_point_params(W_ORG, cfg["op"], nop=2, noc=1)
    top, bot, left, right = pad_amounts(W_ORG, H_ORG, params.sc_f)
    full_h, full_w = H_ORG + top + bot, W_ORG + left + right
    x = pyramid.pad_to_divisible(torch.as_tensor(decoded).to(dev),
                                 params.sc_f)
    batch = cfg["batch"]

    def crop(flow):
        return flow[:, top:top + H_ORG, left:left + W_ORG]

    def bare(x=x, params=params, count=n_pairs):
        outs = []
        for i in range(0, count, batch):
            rows = torch.arange(i, i + batch, device=x.device).clamp(
                max=count - 1)
            flow = dis.dis_flow_batched(x[rows], x[rows + 1], params, full_w,
                                        full_h, device=dev)
            outs.append(crop(flow)[:min(batch, count - i)])
        return torch.cat(outs)

    bare_walls, want = _timed(bare)
    names = [os.path.splitext(os.path.basename(p))[0] + ".flo"
             for p in paths[:-1]]
    per_call = next(c["launches"] for c in PATHS if c["name"] == "A")
    n_batches = -(-n_pairs // batch)

    def counted(what, calls, per, **kw):
        """One pipeline run, counted: `calls` calls of `per` launches."""
        out_dir = os.path.join(root, f"out_{what}")
        reset_launches()
        n = pipeline.run_pipeline(kw.pop("frame_dir", frame_dir), out_dir,
                                  op_point=cfg["op"], verbose=False, **kw)
        torch.cuda.synchronize()
        launches = read_launches()
        print(f"pipeline {what}: {n} pairs, launches {json.dumps(launches)} "
              f"({calls} calls of {json.dumps(per)})", flush=True)
        if launches != {name: calls * c for name, c in per.items()}:
            raise AssertionError(f"pipeline {what}: launches {launches}")
        for name, c in launches.items():
            totals[name] = totals.get(name, 0) + c
        return n, out_dir

    # cold batches
    n, cold_dir = counted("cold", n_batches, per_call, batch=batch)
    if n != n_pairs or sorted(os.listdir(cold_dir)) != names:
        raise AssertionError(f"pipeline cold: {n} pairs, files "
                             f"{len(os.listdir(cold_dir))}")
    cold_err, meds = _pipeline_files(cold_dir, names, want, 2)
    cold_off = _check_medians("cold", meds, cfg["step"])
    cold_walls, _ = _timed(lambda: pipeline.run_pipeline(
        frame_dir, cold_dir, op_point=cfg["op"], batch=batch, verbose=False))
    cold_wall = statistics.median(cold_walls)
    # where a cold run's time goes: its three stages alone, each on what
    # the run handles (its distinct frames decoded on the run's threads;
    # the bare calls above; its files written by the writer pool)
    distinct = n_pairs + n_batches
    with ThreadPoolExecutor(pipeline.DECODE_THREADS) as pool:
        t0 = time.perf_counter()
        for i in range(0, n_pairs, batch):
            native_io.decode_batch(paths[i:min(i + batch, n_pairs) + 1], 1,
                                   pool=pool)
        decode_s = time.perf_counter() - t0
    rows_host = want.cpu().numpy()
    write_dir = os.path.join(root, "write_rate")
    os.makedirs(write_dir, exist_ok=True)
    with ThreadPoolExecutor(pipeline.WRITE_THREADS) as pool:
        t0 = time.perf_counter()
        for fut in [pool.submit(io.write_flo, os.path.join(write_dir, f),
                                rows_host[k]) for k, f in enumerate(names)]:
            fut.result()
        write_s = time.perf_counter() - t0
    stages = {"decode_s": decode_s, "decode_frames": distinct,
              "decode_threads": pipeline.DECODE_THREADS,
              "bare_calls_s": statistics.median(bare_walls),
              "write_s": write_s, "write_threads": pipeline.WRITE_THREADS,
              "write_bytes": int(rows_host.nbytes),
              "write_bytes_per_s": rows_host.nbytes / write_s,
              "cold_run_s": cold_wall}

    # warm streams against a dis_step_warm loop over the same segments
    s = cfg["streams"]
    steps = n_pairs // s
    n, st_dir = counted("streams", steps, per_call, streams=s)
    carry = dis.warm_carry_init(s, params, full_w, full_h, device=dev)
    loop = torch.empty((n_pairs, H_ORG, W_ORG, 2), device=dev)
    starts = torch.arange(s, device=dev) * steps
    for t in range(steps):
        flow, carry = dis.dis_step_warm(x[starts + t], x[starts + t + 1],
                                        params, full_w, full_h, carry,
                                        device=dev)
        loop[starts + t] = crop(flow)
    st_err, meds = _pipeline_files(st_dir, names, loop, 2)
    st_off = _check_medians("streams", meds, cfg["step"])
    st_walls, _ = _timed(lambda: pipeline.run_pipeline(
        frame_dir, st_dir, op_point=cfg["op"], streams=s, verbose=False))

    # depth
    de_paths = pipeline.list_frames(depth_dir)
    de_params = op_point_params(W_ORG, cfg["op"], nop=1, noc=1)
    de_x = pyramid.pad_to_divisible(torch.as_tensor(native_io.decode_batch(
        de_paths, 1)).to(dev), de_params.sc_f)
    de_want = bare(de_x, de_params, len(de_paths) - 1)
    de_calls = -(-(len(de_paths) - 1) // batch)
    n, de_dir = counted("depth", de_calls, next(
        c["launches"] for c in PATHS if c["name"] == "B"),
        frame_dir=depth_dir, batch=batch, mode="run_DE_INT")
    de_names = [os.path.splitext(os.path.basename(p))[0] + ".pfm"
                for p in de_paths[:-1]]
    if n != len(de_names) or sorted(os.listdir(de_dir)) != de_names:
        raise AssertionError(f"pipeline depth: {n} pairs")
    de_err, meds = _pipeline_files(de_dir, de_names, de_want, 1)
    de_off = _check_medians("depth", meds, cfg["depth_step"][:1])
    if float(de_want.max()) > 0.0:
        raise AssertionError("pipeline depth: positive disparity")

    # the cold run split over two devices (the card twice)
    mesh = pmesh.make_mesh([torch.device("cuda", 0)] * 2)
    n, mesh_dir = counted("mesh", n_batches * mesh.size, per_call,
                          batch=batch, mesh=mesh)
    mesh_err, _ = _pipeline_files(mesh_dir, names, torch.stack(
        [torch.as_tensor(io.read_flo(os.path.join(cold_dir, f)))
         for f in names]), 2)
    mesh_walls, _ = _timed(lambda: pipeline.run_pipeline(
        frame_dir, mesh_dir, op_point=cfg["op"], batch=batch, mesh=mesh,
        verbose=False), runs=1)

    # one visualization of an output
    png = os.path.join(root, "viz.png")
    viz.main([os.path.join(cold_dir, names[0]), png])
    if native_io.decode_batch([png], 3).shape != (1, 3, H_ORG, W_ORG):
        raise AssertionError("viz.main wrote a wrong image")

    for what, err in (("cold", cold_err), ("streams", st_err),
                      ("depth", de_err), ("mesh", mesh_err)):
        if not err <= PIPELINE_TOL:
            raise AssertionError(f"pipeline {what}: files differ by {err} px")
    print(json.dumps({
        "pipeline": "op-2 gray flow", "size": f"{W_ORG}x{H_ORG}",
        "pairs": n_pairs, "batch": batch, "streams": s,
        "max_abs_vs_dis_flow_batched": cold_err,
        "streams_max_abs_vs_dis_step_warm": st_err,
        "depth_max_abs_vs_dis_flow_batched": de_err,
        "mesh_max_abs_vs_one_device": mesh_err,
        "median_off_motion_px": {"cold": cold_off, "streams": st_off,
                                 "depth": de_off},
        "cold_wall_s": cold_walls, "streams_wall_s": st_walls,
        "bare_wall_s": bare_walls, "mesh_wall_s": mesh_walls,
        "cold_pairs_per_s": n_pairs / cold_wall,
        "streams_pairs_per_s": n_pairs / statistics.median(st_walls),
        "bare_pairs_per_s": n_pairs / statistics.median(bare_walls),
        "mesh_pairs_per_s": n_pairs / mesh_walls[0],
        "cold_stages_alone": stages,
        "path_a_wall_ms_per_call": walls_by_path["A"] * 1e3,
        "frames_written_s": made, "cpu_count": os.cpu_count(),
        "card": nvidia_smi_line()}), flush=True)
    profile_call("run_pipeline cold (every device activity, copies too)",
                 lambda: pipeline.run_pipeline(
                     frame_dir, cold_dir, op_point=cfg["op"], batch=batch,
                     verbose=False), cold_wall)
    print(f"pipeline phase: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return cold_dir


# Part 7b: JPEG frames, decoded by the port's own decoder
# (`csrc/jpeg.cpp`) as cv::imread decodes them. The fixtures of
# tests/torch_fixtures/jpeg (made by its make_fixtures.py with cv2, PIL and
# libjpeg-turbo's own encoder): nine 1024x436 colour frames, q90 4:2:0,
# moving by the manifest's motion, Huffman-coded (frames/) and
# arithmetic-coded (frames_arith/), a lossless gray pair and a YCCK pair
# (pairs/), and small variants; the manifest holds the SHA-256 of
# cv2.imread's gray and colour planes of each, which the card machine's
# build of the decoder must reproduce (there is no cv2 there). The eight
# pairs serve as one batch of 8, gray flow (path A's launches) and RGB flow
# (C's); the arithmetic-coded ones at op-1 too (`arith_ops`), and each
# pair of pairs/ serves and goes through the CLI (`pairs`: directory, mode,
# channels).
JPEG_DIR = os.path.join(ROOT, "tests", "torch_fixtures", "jpeg")
JPEG = dict(op=2, batch=8, decode_threads=(1, 4, 8, 16), decode_repeats=8,
            load_image_frames=4,
            modes=(("run_OF_INT", 1, "A"), ("run_OF_RGB", 3, "C")),
            arith_ops=(1, 2),
            pairs=(("lossless_gray", "run_OF_INT", 1),
                   ("ycck", "run_OF_INT", 1), ("ycck", "run_OF_RGB", 3)))


def _sha256(planes) -> str:
    return hashlib.sha256(np.ascontiguousarray(planes).tobytes()).hexdigest()


def _check_planes(files):
    """(planes checked, mismatches): each (path, manifest record) decoded
    through `decode_batch` and `load_image`, gray and colour, against the
    record's shapes and SHA-256s (a read the record has as null, which
    cv2.imread fails on, must raise ValueError)."""
    checked, bad = 0, []
    for path, rec in files:
        for key, ch in (("gray", 1), ("color", 3)):
            if rec[key] is None:    # cv2.imread fails: the port must raise
                for how, fn in (("decode_batch", native_io.decode_batch),
                                ("load_image", io.load_image)):
                    checked += 1
                    try:
                        fn([path] if how == "decode_batch" else path, ch)
                        bad.append(f"{os.path.relpath(path, ROOT)} {key} "
                                   f"{how} read where cv2 fails")
                    except ValueError:
                        pass
                continue
            for how, planes in (
                    ("decode_batch", native_io.decode_batch([path], ch)[0]),
                    ("load_image", io.load_image(path, ch).astype(np.uint8))):
                checked += 1
                if (list(planes.shape) != rec[key]["shape"]
                        or _sha256(planes) != rec[key]["sha256"]):
                    bad.append(f"{os.path.relpath(path, ROOT)} {key} {how}")
    return checked, bad


def _decode_rates(paths, channels, repeats, threads):
    """Frames/s of `decode_batch` over `paths` repeated, at each thread
    count; each run's first frames against one serial decode."""
    many = list(paths) * repeats
    once = native_io.decode_batch(paths, channels)
    rates = {}
    for k in threads:
        with ThreadPoolExecutor(k) as pool:
            t0 = time.perf_counter()
            again = native_io.decode_batch(many, channels, pool=pool)
            rates[k] = len(many) / (time.perf_counter() - t0)
        if not np.array_equal(again[:len(paths)], once):
            raise AssertionError(f"decode_batch with {k} threads differs "
                                 f"({paths[0]})")
    return rates


def run_jpeg_part(dev, totals, walls_by_path):
    """Phase 7, part 7b (see JPEG): every fixture's planes against the
    manifest's cv2 hashes, through `decode_batch` and `load_image`; the
    decode rate at each thread count; `run_pipeline` at op-2 on the nine
    frames, gray and RGB flow, counted, each file against
    `dis_flow_batched` on the same decoded frames and its median against
    the motion, pairs/s and the busy share; `cli.main` on the first pair,
    gray and RGB, against `dis_flow_batched`; the arithmetic-coded frames
    served as the PNG-derived formats of 7c are, at op-1 and op-2, gray
    and RGB flow, and so the lossless gray and the YCCK pair."""
    cfg = JPEG
    t_part = time.perf_counter()
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    motion = manifest["motion_px"]

    # decode check: both entries, both channel counts, every file
    checked, bad = _check_planes(
        (os.path.join(JPEG_DIR, rel), rec)
        for rel, rec in sorted(manifest["files"].items()))
    print(json.dumps({"jpeg": "decode check", "planes": checked,
                      "files": len(manifest["files"]),
                      "against": f"cv2 {manifest['cv2']} "
                                 f"({manifest['libjpeg']})",
                      "mismatches": bad}), flush=True)
    if bad:
        raise AssertionError(f"JPEG planes differ from cv2's: {bad}")

    # decode rate: the nine frames, repeated, at each thread count,
    # Huffman and arithmetic-coded
    frame_dir = os.path.join(JPEG_DIR, "frames")
    paths = pipeline.list_frames(frame_dir)
    arith = pipeline.list_frames(os.path.join(JPEG_DIR, "frames_arith"))
    for coding, ps in (("q90 4:2:0", paths),
                       ("q90 4:2:0 arithmetic", arith)):
        many = ps * cfg["decode_repeats"]
        rates = {key: _decode_rates(ps, ch, cfg["decode_repeats"],
                                    cfg["decode_threads"])
                 for key, ch in (("gray", 1), ("color", 3))}
        few = ps[:cfg["load_image_frames"]]
        t0 = time.perf_counter()
        for p in few:
            io.load_image(p, 1)
        plain_rate = len(few) / (time.perf_counter() - t0)
        print(json.dumps({"jpeg": "decode", "frames": len(many),
                          "size": f"{W_ORG}x{H_ORG}", "coding": coding,
                          "frames_per_s_by_threads": rates,
                          "load_image_gray_frames_per_s": plain_rate,
                          "cpu_count": os.cpu_count(),
                          "card": nvidia_smi_line()}), flush=True)

    # serving: one batch of the eight pairs, gray and RGB flow
    n_pairs = len(paths) - 1
    names = [os.path.splitext(os.path.basename(p))[0] + ".flo"
             for p in paths[:-1]]
    result = {}
    for mode, noc, path_name in cfg["modes"]:
        params = op_point_params(W_ORG, cfg["op"], nop=2, noc=noc)
        top, bot, left, right = pad_amounts(W_ORG, H_ORG, params.sc_f)
        full_h, full_w = H_ORG + top + bot, W_ORG + left + right
        x = pyramid.pad_to_divisible(torch.as_tensor(
            native_io.decode_batch(paths, noc)).to(dev), params.sc_f)
        want = dis.dis_flow_batched(x[:-1], x[1:], params, full_w, full_h,
                                    device=dev)[:, top:top + H_ORG,
                                                left:left + W_ORG]
        per = next(c["launches"] for c in PATHS if c["name"] == path_name)
        out_dir = os.path.join(OUT_DIR, "jpeg", mode)
        shutil.rmtree(out_dir, ignore_errors=True)
        reset_launches()
        n = pipeline.run_pipeline(frame_dir, out_dir, op_point=cfg["op"],
                                  batch=cfg["batch"], mode=mode,
                                  verbose=False)
        torch.cuda.synchronize()
        launches = read_launches()
        if n != n_pairs or sorted(os.listdir(out_dir)) != names:
            raise AssertionError(f"jpeg pipeline {mode}: {n} pairs")
        if launches != per:
            raise AssertionError(f"jpeg pipeline {mode}: launches "
                                 f"{launches}, expected {per} (one batch)")
        for name, c in launches.items():
            totals[name] = totals.get(name, 0) + c
        err, meds = _pipeline_files(out_dir, names, want, 2)
        off = _check_medians(f"jpeg {mode}", meds, motion)
        if not err <= PIPELINE_TOL:
            raise AssertionError(f"jpeg pipeline {mode}: files differ by "
                                 f"{err} px")
        walls, _ = _timed(lambda: pipeline.run_pipeline(
            frame_dir, out_dir, op_point=cfg["op"], batch=cfg["batch"],
            mode=mode, verbose=False))
        wall = statistics.median(walls)
        result[mode] = {"max_abs_vs_dis_flow_batched": err,
                        "median_off_motion_px": off, "launches": launches,
                        "wall_s": walls, "pairs_per_s": n_pairs / wall,
                        "path_wall_ms_per_call":
                            walls_by_path[path_name] * 1e3}
        print(json.dumps({"jpeg": f"pipeline {mode}", "pairs": n_pairs,
                          "batch": cfg["batch"], **result[mode],
                          "card": nvidia_smi_line()}), flush=True)
        profile_call(f"run_pipeline JPEG {mode} (every device activity)",
                     lambda: pipeline.run_pipeline(
                         frame_dir, out_dir, op_point=cfg["op"],
                         batch=cfg["batch"], mode=mode, verbose=False), wall)

        # the CLI on the first pair
        cli_out = os.path.join(OUT_DIR, "jpeg", f"cli_{mode}.flo")
        reset_launches()
        cli.main([mode, paths[0], paths[1], cli_out, str(cfg["op"]),
                  "--quiet"])
        launches = read_launches()
        if launches != per:
            raise AssertionError(f"jpeg cli {mode}: launches {launches}")
        for name, c in launches.items():
            totals[name] = totals.get(name, 0) + c
        got = torch.as_tensor(io.read_flo(cli_out))
        cli_err = float((got - want[0].cpu()).abs().max())
        print(f"jpeg cli {mode}: {tuple(got.shape)} flow, max abs vs "
              f"dis_flow_batched {cli_err}", flush=True)
        if not cli_err <= PIPELINE_TOL:
            raise AssertionError(f"jpeg cli {mode}: differs by {cli_err} px")

    # the arithmetic-coded frames at op-1 and op-2; the two CLI pairs
    for op in cfg["arith_ops"]:
        for mode, noc, _ in cfg["modes"]:
            result[f"arith op{op} {mode}"] = _serve_frames(
                f"jpeg arith op{op}", arith, dict(cfg, op=op),
                os.path.join(OUT_DIR, "jpeg", f"arith_op{op}_{mode}"), dev,
                totals, motion, mode, noc)
    for name, mode, noc in cfg["pairs"]:
        result[f"{name} {mode}"] = _serve_frames(
            f"jpeg {name}", pipeline.list_frames(
                os.path.join(JPEG_DIR, "pairs", name)), cfg,
            os.path.join(OUT_DIR, "jpeg", f"{name}_{mode}"), dev, totals,
            motion, mode, noc)
    print(f"jpeg part: {time.perf_counter() - t_part:.1f} s", flush=True)
    return result


# Part 7c: PNG, PNM and BMP frames beyond 8-bit PNG, decoded by the port's
# own decoder (`csrc/io_native.cpp`) as cv::imread decodes them. The
# frames are the nine JPEG frames of part 7b, decoded by the port's JPEG
# decoder (cv2's planes, 7b's manifest) and re-encoded at 1024x436 by the
# numpy-only generator tests/torch_fixtures/formats/make_fixtures.py in
# each of its FORMATS (16-bit gray PNG, palette PNG, Adam7 RGB PNG with
# sRGB, 24-bit BMP, 16-bit PGM, and 8-bit gray PNG as the rate's
# yardstick); its manifest holds the SHA-256 of cv2.imread's gray and
# colour planes of every frame and of its small committed variants, which
# the card machine's build must reproduce. `served`: the formats whose
# eight pairs serve as one batch of 8 at op-2 gray flow (path A's
# launches) and whose first pair goes through `cli.main`.
FORMATS_DIR = os.path.join(ROOT, "tests", "torch_fixtures", "formats")
FORMATS_PART = dict(op=2, batch=8, decode_threads=(1, 8), decode_repeats=4,
                    served=("png16", "adam7_srgb"))


def _serve_frames(label, ps, cfg, out_dir, dev, totals, motion,
                  mode="run_OF_INT", noc=1, medians=True, held=None):
    """`run_pipeline` at cfg's op-point, gray flow (or `mode` on `noc`
    channels), on the frames `ps` of one directory (in one batch of
    cfg["batch"] pairs), and `cli.main` on the first pair: launches those
    of the `dis_flow_batched` call on the same decoded frames each (at
    op-2 a path-A call's, C's for RGB), every file against that call,
    medians against the motion (of the pairs `held`, all by default;
    measured and printed only, with `medians` False), pairs/s. Prints and
    returns the result."""
    params = op_point_params(W_ORG, cfg["op"], nop=2, noc=noc)
    top, bot, left, right = pad_amounts(W_ORG, H_ORG, params.sc_f)
    full_h, full_w = H_ORG + top + bot, W_ORG + left + right
    frame_dir = os.path.dirname(ps[0])
    if pipeline.list_frames(frame_dir) != list(ps):
        raise AssertionError(f"{label}: the directory lists other frames")
    names = [os.path.splitext(os.path.basename(p))[0] + ".flo"
             for p in ps[:-1]]
    x = pyramid.pad_to_divisible(torch.as_tensor(
        native_io.decode_batch(ps, noc)).to(dev), params.sc_f)
    reset_launches()
    want = dis.dis_flow_batched(x[:-1], x[1:], params, full_w, full_h,
                                device=dev)[:, top:top + H_ORG,
                                            left:left + W_ORG]
    torch.cuda.synchronize()
    per = read_launches()
    path = "A" if noc == 1 else "C"
    if cfg["op"] == 2 and per != next(c["launches"] for c in PATHS
                                      if c["name"] == path):
        raise AssertionError(f"{label}: launches {per}, not path {path}'s")
    reset_launches()
    n = pipeline.run_pipeline(frame_dir, out_dir, op_point=cfg["op"],
                              batch=cfg["batch"], mode=mode, verbose=False)
    torch.cuda.synchronize()
    launches = read_launches()
    if n != len(names) or sorted(os.listdir(out_dir)) != names:
        raise AssertionError(f"{label} pipeline: {n} pairs")
    if launches != per:
        raise AssertionError(f"{label} pipeline: launches {launches}, "
                             f"expected {per} (one batch)")
    for name, c in launches.items():
        totals[name] = totals.get(name, 0) + c
    err, meds = _pipeline_files(out_dir, names, want, 2)
    held = list(range(len(meds)) if held is None else held) if medians \
        else []
    if held:
        _check_medians(label, [meds[k] for k in held], motion)
    off = max(abs(m - t) for med in meds for m, t in zip(med, motion))
    if not err <= PIPELINE_TOL:
        raise AssertionError(f"{label} pipeline: files differ by {err} px")
    walls, _ = _timed(lambda: pipeline.run_pipeline(
        frame_dir, out_dir, op_point=cfg["op"], batch=cfg["batch"],
        mode=mode, verbose=False), runs=2)
    cli_out = out_dir + "_cli.flo"
    reset_launches()
    cli.main([mode, ps[0], ps[1], cli_out, str(cfg["op"]), "--quiet"])
    cli_launches = read_launches()
    if cli_launches != per:
        raise AssertionError(f"{label} cli: launches {cli_launches}")
    for name, c in cli_launches.items():
        totals[name] = totals.get(name, 0) + c
    got = torch.as_tensor(io.read_flo(cli_out))
    cli_err = float((got - want[0].cpu()).abs().max())
    if not cli_err <= PIPELINE_TOL:
        raise AssertionError(f"{label} cli: differs by {cli_err} px")
    result = {"max_abs_vs_dis_flow_batched": err,
              "cli_max_abs_vs_dis_flow_batched": cli_err,
              "median_off_motion_px": off, "medians_held": held,
              "launches": launches,
              "wall_s": walls,
              "pairs_per_s": len(names) / statistics.median(walls)}
    print(json.dumps({"serving": f"pipeline and cli {label} {mode}",
                      "pairs": len(names), "batch": cfg["batch"], **result,
                      "card": nvidia_smi_line()}), flush=True)
    return result


def _fixture_module(directory, name, file="make_fixtures.py"):
    """A fixture directory's make_fixtures.py (or `file`), loaded by
    path."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(directory, file))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _written_part(label, directory, cfg, write, dev, totals):
    """Parts 7c, 7d (raster) and 7e, one fixture directory each: the
    frames written on the host by `write` (root -> {set: paths}), and the
    committed frame sets of the manifest's "committed" (cfg["committed"]
    names the served ones); every frame's and committed file's planes
    against the manifest's cv2 hashes, through `decode_batch` and
    `load_image`; decode frames/s per set at 1 and 8 threads;
    `run_pipeline` and `cli.main` at op-2 gray flow on the served sets,
    RGB flow too on cfg["served_rgb"], medians not held on
    cfg["no_median"], and each pair of cfg["pairs"] (directory, mode,
    channels) (`_serve_frames`)."""
    t_part = time.perf_counter()
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    root = os.path.join(OUT_DIR, label)
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    paths = write(root)
    write_s = time.perf_counter() - t0
    files = [(os.path.join(directory, rel), rec)
             for rel, rec in sorted(manifest["files"].items())]
    files += [(p, manifest["frames"][f"{fmt}/{os.path.basename(p)}"])
              for fmt, ps in paths.items() for p in ps]
    if len(files) != len(manifest["files"]) + len(manifest["frames"]):
        raise AssertionError(f"{label}: the frames written differ from the "
                             "manifest's")
    committed = manifest.get("committed", {})
    files += [(os.path.join(directory, rel), rec)
              for rel, rec in sorted(committed.items())]
    for name in cfg.get("committed", ()):
        paths[name] = pipeline.list_frames(os.path.join(directory, name))
        if len(paths[name]) != sum(rel.startswith(name + "/")
                                   for rel in committed):
            raise AssertionError(f"{label}: {name} differs from the "
                                 "manifest's")
    checked, bad = _check_planes(files)
    print(json.dumps({label: "decode check", "planes": checked,
                      "files": len(files), "frames_written_s": write_s,
                      "against": f"cv2 {manifest['cv2']}",
                      "mismatches": bad}), flush=True)
    if bad:
        raise AssertionError(f"{label} planes differ from cv2's: {bad}")
    rates = {fmt: _decode_rates(ps, 1, cfg["decode_repeats"],
                                cfg["decode_threads"])
             for fmt, ps in paths.items()}
    print(json.dumps({label: "decode", "size": f"{W_ORG}x{H_ORG}",
                      "channels": 1, "frames": 9 * cfg["decode_repeats"],
                      "frames_per_s_by_threads": rates,
                      "cpu_count": os.cpu_count(),
                      "card": nvidia_smi_line()}), flush=True)
    motion = manifest["motion_px"]
    result = {}
    for fmt in cfg["served"]:
        for mode, noc in (("run_OF_INT", 1), ("run_OF_RGB", 3)):
            if noc == 3 and fmt not in cfg.get("served_rgb", ()):
                continue
            result[f"{fmt} {mode}"] = _serve_frames(
                f"{label} {fmt}", paths[fmt], cfg,
                os.path.join(root, f"out_{fmt}_{mode}"), dev, totals, motion,
                mode, noc, medians=fmt not in cfg.get("no_median", ()))
    for name, mode, noc in cfg.get("pairs", ()):
        result[f"{name} {mode}"] = _serve_frames(
            f"{label} {name}", pipeline.list_frames(
                os.path.join(directory, "pairs", name)), cfg,
            os.path.join(root, f"out_{name}_{mode}"), dev, totals, motion,
            mode, noc)
    print(f"{label} part: {time.perf_counter() - t_part:.1f} s", flush=True)
    return result


def _jpeg_frames():
    """Part 7b's frames: (gray, bgr) planes as the port decodes them, and
    the files' bytes."""
    jpeg_paths = pipeline.list_frames(os.path.join(JPEG_DIR, "frames"))
    planes = [(native_io.decode_batch([p], 1)[0, 0],
               native_io.decode_batch([p], 3)[0]) for p in jpeg_paths]
    raws = []
    for p in jpeg_paths:
        with open(p, "rb") as f:
            raws.append(f.read())
    return planes, raws


def run_formats_part(dev, totals, walls_by_path):
    """Phase 7, part 7c (see FORMATS_PART): the frames written; every
    frame's and variant's planes against the manifest's cv2 hashes,
    through `decode_batch` and `load_image`; decode frames/s per format at
    1 and 8 threads; `run_pipeline` at op-2 gray flow and `cli.main` on
    the served formats, counted, each file against `dis_flow_batched` on
    the same decoded frames and its median against the motion."""
    fixtures = _fixture_module(FORMATS_DIR, "formats_fixtures")
    planes = _jpeg_frames()[0]

    def write(root):
        with ThreadPoolExecutor(8) as pool:
            return fixtures.write_frames(root, planes, pool=pool)

    return _written_part("formats", FORMATS_DIR, FORMATS_PART, write, dev,
                         totals)


# Part 7d: the WebP fixtures of tests/torch_fixtures/webp (committed: the
# card's machine has no WebP encoder), nine 1024x436 frames lossy at
# quality 90 and frames 0-2 lossless in gray, and small variants; then
# part 7b's frames re-encoded on the card's host by the numpy writers of
# tests/torch_fixtures/raster as Sun raster, PAM, Radiance HDR and PFM.
# Each manifest holds the SHA-256 of cv2.imread's gray and colour planes
# (null where cv2.imread fails). `served`: the frame sets whose pairs go
# through `run_pipeline` (one batch) and `cli.main` at op-2 gray flow.
WEBP_DIR = os.path.join(ROOT, "tests", "torch_fixtures", "webp")
RASTER_DIR = os.path.join(ROOT, "tests", "torch_fixtures", "raster")
WEBP_PART = dict(op=2, batch=8, decode_threads=(1, 8), decode_repeats=4,
                 served=("frames", "lossless"))
RASTER_PART = dict(op=2, batch=8, decode_threads=(1, 8), decode_repeats=2,
                   served=("ras24", "pam16", "hdr"))


def run_webp_part(dev, totals, walls_by_path):
    """Phase 7, part 7d, WebP (see WEBP_PART): every fixture's planes
    against the manifest's cv2 hashes through `decode_batch` and
    `load_image`; decode frames/s of the lossy and the lossless frames at
    1 and 8 threads; `run_pipeline` and `cli.main` at op-2 gray flow on
    the nine lossy frames and on the three lossless ones, each file
    against `dis_flow_batched` on the same decoded frames."""
    cfg = WEBP_PART
    t_part = time.perf_counter()
    with open(os.path.join(WEBP_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    files = [(os.path.join(WEBP_DIR, rel), rec)
             for rel, rec in sorted(manifest["files"].items())]
    checked, bad = _check_planes(files)
    print(json.dumps({"webp": "decode check", "planes": checked,
                      "files": len(files),
                      "against": f"cv2 {manifest['cv2']}, libwebp "
                                 f"{manifest['webp']}",
                      "mismatches": bad}), flush=True)
    if bad:
        raise AssertionError(f"WebP planes differ from cv2's: {bad}")
    root = os.path.join(OUT_DIR, "webp")
    shutil.rmtree(root, ignore_errors=True)
    sets = {"frames": pipeline.list_frames(os.path.join(WEBP_DIR, "frames"))}
    lossless_dir = os.path.join(root, "lossless")   # the gray frames alone
    os.makedirs(lossless_dir)
    for t in range(3):
        shutil.copy(os.path.join(WEBP_DIR, "lossless", f"gray_{t:04d}.webp"),
                    lossless_dir)
    sets["lossless"] = pipeline.list_frames(lossless_dir)
    # each set decoded 9 * decode_repeats times a thread count
    rates = {name: _decode_rates(ps, 1, cfg["decode_repeats"] * 9 // len(ps),
                                 cfg["decode_threads"])
             for name, ps in sets.items()}
    print(json.dumps({"webp": "decode", "size": f"{W_ORG}x{H_ORG}",
                      "channels": 1, "frames": 9 * cfg["decode_repeats"],
                      "frames_per_s_by_threads": rates,
                      "cpu_count": os.cpu_count(),
                      "card": nvidia_smi_line()}), flush=True)
    result = {name: _serve_frames(f"webp {name}", sets[name], cfg,
                                  os.path.join(root, f"out_{name}"), dev,
                                  totals, manifest["motion_px"])
              for name in cfg["served"]}
    print(f"webp part: {time.perf_counter() - t_part:.1f} s", flush=True)
    return result


def run_raster_part(dev, totals, walls_by_path):
    """Phase 7, part 7d, Sun raster, PAM, HDR and PFM (see RASTER_PART):
    the frames written; every frame's and variant's planes against the
    manifest's cv2 hashes; decode frames/s per format at 1 and 8 threads;
    `run_pipeline` and `cli.main` at op-2 gray flow on the served
    formats, each file against `dis_flow_batched`."""
    fixtures = _fixture_module(RASTER_DIR, "raster_fixtures")
    planes = _jpeg_frames()[0]

    def write(root):
        with ThreadPoolExecutor(8) as pool:
            return fixtures.write_frames(root, planes, pool=pool)

    return _written_part("raster", RASTER_DIR, RASTER_PART, write, dev,
                         totals)


# Part 7e: the TIFF and GIF fixtures (the committed variants, numpy-, cv2-
# and PIL-written), and part 7b's frames re-encoded on the card's host by
# the numpy writers of tests/torch_fixtures/tiff and tests/torch_fixtures/
# gif (the TIFF "jpeg" set wraps the JPEG frames' own bitstreams; the
# "ycbcr_lzw" set is 2x1-subsampled YCbCr without JPEG); the TIFF
# committed sets, written by libtiff: "fax_g4", the nine frames blurred,
# thresholded and CCITT Group 4-coded, and pairs/ (frames 0-1 as PIL's
# RGBA and CMYK JPEG-in-TIFF). Each manifest holds the SHA-256 of
# cv2.imread's gray and colour planes (null where cv2.imread fails).
# `served`: the frame sets whose pairs go through `run_pipeline` (one
# batch) and `cli.main` at op-2 gray flow (RGB flow too: `served_rgb`);
# `no_median`: sets whose medians are measured and not held to the
# motion (bilevel frames: edges that move by whole pixels); `pairs`: the
# pairs/ directories served, with mode and channels.
TIFF_DIR = os.path.join(ROOT, "tests", "torch_fixtures", "tiff")
GIF_DIR = os.path.join(ROOT, "tests", "torch_fixtures", "gif")
TIFF_PART = dict(op=2, batch=8, decode_threads=(1, 8), decode_repeats=2,
                 served=("lzw_pred", "deflate_rgb", "packbits_tiled",
                         "gray16", "jpeg", "ycbcr_lzw", "fax_g4"),
                 served_rgb=("ycbcr_lzw",), committed=("fax_g4",),
                 no_median=("fax_g4",),
                 pairs=(("rgba_jpeg", "run_OF_RGB", 3),
                        ("cmyk_jpeg", "run_OF_INT", 1),
                        ("cmyk_jpeg", "run_OF_RGB", 3)))
GIF_PART = dict(op=2, batch=8, decode_threads=(1, 8), decode_repeats=2,
                served=("gray256",))


def run_tiff_part(dev, totals, walls_by_path):
    """Phase 7, part 7e, TIFF (see TIFF_PART)."""
    fixtures = _fixture_module(TIFF_DIR, "tiff_fixtures")
    planes, raws = _jpeg_frames()

    def write(root):
        with ThreadPoolExecutor(8) as pool:
            return fixtures.write_frames(root, planes, raws, pool=pool)

    return _written_part("tiff", TIFF_DIR, TIFF_PART, write, dev, totals)


def run_gif_part(dev, totals, walls_by_path):
    """Phase 7, part 7e, GIF (see GIF_PART)."""
    fixtures = _fixture_module(GIF_DIR, "gif_fixtures")
    grays = [g for g, _ in _jpeg_frames()[0]]

    def write(root):
        with ThreadPoolExecutor(8) as pool:
            return fixtures.write_frames(root, grays, pool=pool)

    return _written_part("gif", GIF_DIR, GIF_PART, write, dev, totals)


# Part 7f: the JPEG 2000 fixtures of tests/torch_fixtures/jp2 (committed:
# the card's machine has no JPEG 2000 encoder), part 7b's nine frames RGB
# 9/7 at 20:1 (`frames`, the "lossy" set), frames 0-2's gray planes 5/3
# without loss (`lossless`), and small variants. The manifest holds the
# SHA-256 of cv2.imread's gray and colour planes (null where cv2.imread
# fails). `served`: the frame sets whose pairs go through `run_pipeline`
# (one batch) and `cli.main` at op-2 gray flow.
JP2_DIR = os.path.join(ROOT, "tests", "torch_fixtures", "jp2")
JP2_PART = dict(op=2, batch=8, decode_threads=(1, 8), decode_repeats=2,
                served=("lossy", "lossless"))


def run_jp2_part(dev, totals, walls_by_path):
    """Phase 7, part 7f, JPEG 2000 (see JP2_PART): every fixture's planes
    against the manifest's cv2 hashes through `decode_batch` and
    `load_image`; decode frames/s of the lossy and the lossless frames at
    1 and 8 threads; `run_pipeline` and `cli.main` at op-2 gray flow on
    the nine lossy frames and on the three lossless ones, each file
    against `dis_flow_batched` on the same decoded frames."""
    cfg = JP2_PART
    t_part = time.perf_counter()
    with open(os.path.join(JP2_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    files = [(os.path.join(JP2_DIR, rel), rec)
             for rel, rec in sorted(manifest["files"].items())]
    checked, bad = _check_planes(files)
    print(json.dumps({"jp2": "decode check", "planes": checked,
                      "files": len(files),
                      "against": f"cv2 {manifest['cv2']}, OpenJPEG "
                                 f"{manifest['openjpeg']}",
                      "mismatches": bad, "card": nvidia_smi_line()}),
          flush=True)
    if bad:
        raise AssertionError(f"JPEG 2000 planes differ from cv2's: {bad}")
    sets = {"lossy": pipeline.list_frames(os.path.join(JP2_DIR, "frames")),
            "lossless": pipeline.list_frames(os.path.join(JP2_DIR,
                                                          "lossless"))}
    # each set decoded 9 * decode_repeats times a thread count
    rates = {name: _decode_rates(ps, 1, cfg["decode_repeats"] * 9 // len(ps),
                                 cfg["decode_threads"])
             for name, ps in sets.items()}
    print(json.dumps({"jp2": "decode", "size": f"{W_ORG}x{H_ORG}",
                      "channels": 1, "frames": 9 * cfg["decode_repeats"],
                      "frames_per_s_by_threads": rates,
                      "cpu_count": os.cpu_count(),
                      "card": nvidia_smi_line()}), flush=True)
    root = os.path.join(OUT_DIR, "jp2")
    shutil.rmtree(root, ignore_errors=True)
    result = {name: _serve_frames(f"jp2 {name}", sets[name], cfg,
                                  os.path.join(root, f"out_{name}"), dev,
                                  totals, manifest["motion_px"])
              for name in cfg["served"]}
    print(f"jp2 part: {time.perf_counter() - t_part:.1f} s", flush=True)
    return result


# Part 7g: damaged JPEG frames, which libjpeg decodes with a warning and
# cv2.imread returns. The JPEG manifest's "damaged" entry lists three
# frame sets as byte edits (tests/torch_fixtures/jpeg/damage.py) of
# committed files, and the SHA-256 of cv2.imread's planes of every frame
# with the share of its pixels that the damage changed. `held_share`: a
# pair's median is held to the motion where both frames changed in fewer
# pixels than that.
DAMAGED_PART = dict(op=2, batch=8, decode_threads=(1, 8), decode_repeats=2,
                    held_share=0.05)


def run_jpeg_damaged_part(dev, totals, walls_by_path):
    """Phase 7, part 7g (see DAMAGED_PART): the damaged sets written on the
    host, every frame's planes against the manifest's cv2 hashes through
    `decode_batch` and `load_image`; decode frames/s per set at 1 and 8
    threads; `run_pipeline` and `cli.main` at op-2, gray and RGB flow, on
    every set, each file against `dis_flow_batched` on the same decoded
    frames."""
    cfg = DAMAGED_PART
    t_part = time.perf_counter()
    with open(os.path.join(JPEG_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    damaged = manifest["damaged"]
    root = os.path.join(OUT_DIR, "jpeg_damaged")
    shutil.rmtree(root, ignore_errors=True)
    sets = _fixture_module(JPEG_DIR, "jpeg_damage", "damage.py").write_sets(
        root, JPEG_DIR, damaged["sets"])
    recs = {name: [damaged["planes"][f"{name}/{os.path.basename(p)}"]
                   for p in ps] for name, ps in sets.items()}
    checked, bad = _check_planes(
        (p, rec) for name, ps in sets.items()
        for p, rec in zip(ps, recs[name]))
    print(json.dumps({"jpeg_damaged": "decode check", "planes": checked,
                      "frames": sum(map(len, sets.values())),
                      "against": f"cv2 {manifest['cv2']} "
                                 f"({manifest['libjpeg']})",
                      "mismatches": bad, "card": nvidia_smi_line()}),
          flush=True)
    if bad:
        raise AssertionError(f"damaged JPEG planes differ from cv2's: {bad}")
    rates = {name: _decode_rates(ps, 1, cfg["decode_repeats"] * 9 // len(ps),
                                 cfg["decode_threads"])
             for name, ps in sets.items()}
    print(json.dumps({"jpeg_damaged": "decode", "size": f"{W_ORG}x{H_ORG}",
                      "channels": 1, "frames": 9 * cfg["decode_repeats"],
                      "frames_per_s_by_threads": rates,
                      "cpu_count": os.cpu_count(),
                      "card": nvidia_smi_line()}), flush=True)
    result = {}
    for name, ps in sets.items():
        share = [rec["changed"] for rec in recs[name]]
        held = [k for k in range(len(ps) - 1)
                if max(share[k], share[k + 1]) < cfg["held_share"]]
        for mode, noc in (("run_OF_INT", 1), ("run_OF_RGB", 3)):
            result[f"{name} {mode}"] = _serve_frames(
                f"jpeg damaged {name}", ps, cfg,
                os.path.join(root, f"out_{name}_{mode}"), dev, totals,
                manifest["motion_px"], mode, noc, held=held)
    print(f"jpeg damaged part: {time.perf_counter() - t_part:.1f} s",
          flush=True)
    return result


# Part 7h: damaged TIFF frames, which libtiff's RGBA reader returns with
# what each codec decoded before its fault (cv2.imread with it). The TIFF
# manifest's "damaged" entry lists four frame sets as byte edits
# (tests/torch_fixtures/jpeg/damage.py) of source frames: lzw_pred,
# packbits_tiled and jpeg as part 7e's writers make them on the host,
# fax_g4 the committed files; the SHA-256 of every source, which must
# match before the edits apply, and of cv2.imread's planes of every
# damaged frame, with the share of its pixels the damage changed.
# Deflate is not among them: zlib's output differs between builds.
# `held_share` as in part 7g; `no_median`: bilevel frames, measured only.
TIFF_DAMAGED_PART = dict(op=2, batch=8, decode_threads=(1, 8),
                         decode_repeats=2, held_share=0.05,
                         no_median=("fax_g4",))


def run_tiff_damaged_part(dev, totals, walls_by_path):
    """Phase 7, part 7h (see TIFF_DAMAGED_PART): the sources written on the
    host and checked against their SHA-256, the damaged sets made from
    them, every frame's planes against the manifest's cv2 hashes through
    `decode_batch` and `load_image`; decode frames/s per set at 1 and 8
    threads (a sanity figure of one run); `run_pipeline` and `cli.main`
    at op-2, gray and RGB flow, on every set, each file against
    `dis_flow_batched` on the same decoded frames."""
    cfg = TIFF_DAMAGED_PART
    t_part = time.perf_counter()
    with open(os.path.join(TIFF_DIR, "manifest.json")) as f:
        manifest = json.load(f)
    damaged = manifest["damaged"]
    fixtures = _fixture_module(TIFF_DIR, "tiff_fixtures")
    damage = _fixture_module(JPEG_DIR, "jpeg_damage", "damage.py").damage
    root = os.path.join(OUT_DIR, "tiff_damaged")
    shutil.rmtree(root, ignore_errors=True)
    generated = [n for n in damaged["sets"] if n not in fixtures.COMMITTED]
    planes, raws = _jpeg_frames()
    with ThreadPoolExecutor(8) as pool:
        fixtures.write_frames(os.path.join(root, "sources"), planes, raws,
                              formats=generated, pool=pool)
    sets, wrong = {}, []
    for name, frames in damaged["sets"].items():
        base = TIFF_DIR if name in fixtures.COMMITTED \
            else os.path.join(root, "sources")
        os.makedirs(os.path.join(root, name))
        sets[name] = []
        for fr in frames:
            with open(os.path.join(base, fr["source"]), "rb") as f:
                src = f.read()
            if hashlib.sha256(src).hexdigest() != \
                    damaged["sources"][fr["source"]]:
                wrong.append(fr["source"])
            path = os.path.join(root, name, fr["name"])
            with open(path, "wb") as f:
                f.write(damage(src, fr["edits"]))
            sets[name].append(path)
    if wrong:
        raise AssertionError(f"TIFF sources differ from the manifest's: "
                             f"{wrong}")
    recs = {name: [damaged["planes"][f"{name}/{os.path.basename(p)}"]
                   for p in ps] for name, ps in sets.items()}
    checked, bad = _check_planes(
        (p, rec) for name, ps in sets.items()
        for p, rec in zip(ps, recs[name]))
    print(json.dumps({"tiff_damaged": "decode check", "planes": checked,
                      "frames": sum(map(len, sets.values())),
                      "sources_checked": len(damaged["sources"]),
                      "against": f"cv2 {manifest['cv2']}",
                      "mismatches": bad, "card": nvidia_smi_line()}),
          flush=True)
    if bad:
        raise AssertionError(f"damaged TIFF planes differ from cv2's: {bad}")
    rates = {name: _decode_rates(ps, 1, cfg["decode_repeats"] * 9 // len(ps),
                                 cfg["decode_threads"])
             for name, ps in sets.items()}
    print(json.dumps({"tiff_damaged": "decode (sanity, one run)",
                      "size": f"{W_ORG}x{H_ORG}", "channels": 1,
                      "frames": 9 * cfg["decode_repeats"],
                      "frames_per_s_by_threads": rates,
                      "cpu_count": os.cpu_count(),
                      "card": nvidia_smi_line()}), flush=True)
    result = {}
    for name, ps in sets.items():
        share = [rec["changed"] for rec in recs[name]]
        held = [k for k in range(len(ps) - 1)
                if max(share[k], share[k + 1]) < cfg["held_share"]]
        for mode, noc in (("run_OF_INT", 1), ("run_OF_RGB", 3)):
            result[f"{name} {mode}"] = _serve_frames(
                f"tiff damaged {name}", ps, cfg,
                os.path.join(root, f"out_{name}_{mode}"), dev, totals,
                manifest["motion_px"], mode, noc,
                medians=name not in cfg["no_median"], held=held)
    print(f"tiff damaged part: {time.perf_counter() - t_part:.1f} s",
          flush=True)
    return result


# The explicit 20-parameter forms of the merge and TV-free goldens
# (tests/test_golden_parity.py): levels 3..1, 12 trips, patch size 8,
# overlap 0.4, then usefbcon, patnorm, costfct, usetvref.
_FB = "3 1 12 12 0.05 0.95 0 8 0.4 1 1 {cost} 1 10 10 5 1 3 1.6 0"
_HUBER_NOTV = "3 1 12 12 0.05 0.95 0 8 0.4 0 1 2 0 10 10 5 1 3 1.6 0"
# (mode, first image, second image, golden, trailing arguments, budget):
# the budgets of tests/test_golden_parity.py
GOLDENS = [
    ("run_OF_INT", "a.png", "b.png", "of_int_op1.flo", "1", 1e-2),
    ("run_OF_INT", "a.png", "b.png", "of_int_op2.flo", "2", 1e-2),
    ("run_OF_RGB", "ac.png", "bc.png", "of_rgb_op2.flo", "2", 1e-2),
    ("run_OF_GRD", "a.png", "b.png", "of_grd_op2.flo", "2", 1e-2),
    ("run_DE_INT", "a.png", "bs.png", "de_int_op2.pfm", "2", 1e-2),
    ("run_DE_RGB", "asc.png", "bsc.png", "de_rgb_op2.pfm", "2", 1e-2),
    ("run_DE_GRD", "a.png", "bs.png", "de_grd_op2.pfm", "2", 1e-2),
    ("run_OF_INT", "a.png", "b.png", "of_int_op3.flo", "3", 1e-2),
    ("run_OF_INT", "a.png", "b.png", "of_int_op4.flo", "4", 1e-2),
    ("run_OF_RGB", "ac.png", "bc.png", "of_rgb_op3.flo", "3", 1e-2),
    ("run_OF_GRD", "a.png", "b.png", "of_grd_op3.flo", "3", 1e-2),
    ("run_DE_INT", "a.png", "bs.png", "de_int_op3.pfm", "3", 1e-2),
    ("run_OF_INT", "a.png", "b.png", "of_int_l1_fb.flo",
     _FB.format(cost=1), 1e-2),
    ("run_DE_INT", "a.png", "bs.png", "de_int_l2_fb.pfm",
     _FB.format(cost=0), 1e-2),
    ("run_OF_INT", "a.png", "b.png", "of_int_huber_notv.flo", _HUBER_NOTV,
     1e-3),
]


def run_goldens():
    """Phase 8: the compiled reference's outputs through `cli.main`."""
    os.makedirs(OUT_DIR, exist_ok=True)
    gold = os.path.join(ROOT, "tests", "goldens")
    for mode, img1, img2, golden, args, budget in GOLDENS:
        out = os.path.join(OUT_DIR, golden)
        reset_launches()
        cli.main([mode, os.path.join(gold, img1), os.path.join(gold, img2),
                  out] + args.split() + ["--quiet"])
        launches = read_launches()
        if golden.endswith(".flo"):
            ours, ref = io.read_flo(out), io.read_flo(
                os.path.join(gold, golden))
        else:
            ours, ref = (io.read_pfm(f)[..., None]
                         for f in (out, os.path.join(gold, golden)))
        r = epe_ratio(torch.as_tensor(ours.copy()),
                      torch.as_tensor(ref.copy()))
        print(f"golden {golden} ({mode}): EPE ratio {r:.3e} (budget "
              f"{budget:g}); launches {json.dumps(launches)}", flush=True)
        if not r < budget:
            raise AssertionError(f"golden {golden} EPE ratio {r}")
        # op-3 / op-4: the 192x160 frame's finest level holds 3,456 patches
        if args in ("3", "4") and not launches.get("gn_tiled"):
            raise AssertionError(f"golden {golden}: the finest level did "
                                 "not run gn_tiled")


# goldens run again at the CLI's default verbosity 2 (no --quiet)
VERBOSE_GOLDENS = ("of_int_op2.flo", "of_int_op4.flo")


def run_verbose_goldens():
    """Phase 8, second part: `cli.main` at verbosity 2 prints one
    per-scale line a level and writes the file written quietly above."""
    gold = os.path.join(ROOT, "tests", "goldens")
    for mode, img1, img2, golden, args, _ in GOLDENS:
        if golden not in VERBOSE_GOLDENS:
            continue
        out = os.path.join(OUT_DIR, "verbose_" + golden)
        text = io_mod.StringIO()
        with contextlib.redirect_stdout(text):
            cli.main([mode, os.path.join(gold, img1),
                      os.path.join(gold, img2), out] + args.split())
        lines = text.getvalue().splitlines()
        print("\n".join(f"  {ln}" for ln in lines), flush=True)
        params = cli.build_params(192, 2, 1, args.split())
        scales = sum(ln.startswith("TIME (Sc: ") for ln in lines)
        if scales != params.sc_f - params.sc_l + 1:
            raise AssertionError(f"verbose golden {golden}: {scales} "
                                 "per-scale lines")
        quiet = io.read_flo(os.path.join(OUT_DIR, golden))
        if not np.array_equal(io.read_flo(out), quiet):
            raise AssertionError(f"verbose golden {golden}: the file "
                                 "differs from the quiet one")
        print(f"golden {golden} at verbosity 2: {scales} per-scale lines, "
              "the file equal to the quiet one", flush=True)


# ------------------------------------------------- the measurement tools

def run_i8_dot(dev, rows, totals):
    """Phase 9: the dot microbenchmark's main path (the tool at its
    defaults, launches counted), then both products against the twin,
    timed beside the bound and one PyTorch product of the same function:
    A repeated reps times along k times B's reps blocks stacked along k."""
    reset_launches()
    res = bench_i8_dot.main(["--device", str(dev)])
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"i8_dot: launches in one run of the tool: {json.dumps(launches)}",
          flush=True)
    if set(launches) != {"i8_dot"}:
        raise AssertionError(f"i8_dot tool launches {launches}")
    totals["i8_dot"] = totals.get("i8_dot", 0) + launches["i8_dot"]
    reps, grid, m, k, n = 64, 64, 832, 256, 256
    inputs = bench_i8_dot.make_inputs(reps, m, k, n, dev)
    for dtype, peak, label in ((torch.int8, INT8_OP_PER_S, "int8 -> int32"),
                               (torch.bfloat16, BF16_FLOP_PER_S,
                                "bf16 -> f32")):
        a, bt = inputs[dtype]
        out = i8_dot.dot_sum(a, bt, n, grid)
        twin = i8_dot._plain(a, bt, n, grid)
        err = float((out.double() - twin.double()).abs().max())
        if not (torch.equal(out, twin) and torch.equal(res[label]["out"],
                                                       twin)):
            raise AssertionError(f"i8_dot {label}: not the exact product "
                                 f"(max abs err {err})")
        # B's blocks stacked along k, (reps k, n), column-major (k
        # contiguous), the layout of cuBLAS's integer tensor-core products
        a_rep = a.repeat(1, reps)
        b_stack = bt.reshape(reps, n, k).transpose(0, 1).reshape(
            n, reps * k).t()
        product = torch._int_mm if dtype == torch.int8 else torch.matmul

        def lib_call(x, y):
            return [product(x, y) for _ in range(grid)]

        lib = lambda: lib_call(a_rep, b_stack)  # noqa: E731
        lib_diff = float((lib()[0].double() - twin[0].double()).abs().max())
        ops = 2.0 * m * k * n * reps * grid
        esize = a.element_size()
        nbytes = esize * (m * k + reps * n * k) + 4 * grid * m * n
        r = dict(shape=f"{label} ({m}, {k}) @ ({k}, {n}) x {reps} reps x "
                 f"{grid}", max_abs_err=err, library_max_abs_diff=lib_diff,
                 wrapper_ms=cuda_ms(lambda: i8_dot.dot_sum(a, bt, n, grid),
                                   5, 3),
                 plain_ms=cuda_ms(lambda: i8_dot._plain(a, bt, n, grid), 3,
                                  1),
                 library_wrapper_ms=cuda_ms(lib, 5, 1),
                 device_ms=device_ms(
                     lambda x, y: i8_dot.dot_sum(x, y, n, grid), (a, bt), 10),
                 library_device_ms=device_ms(lib_call, (a_rep, b_stack), 5))
        r["tops"] = ops / r["wrapper_ms"] / 1e9
        r["device_tops"] = ops / r["device_ms"] / 1e9
        r["library_tops"] = ops / r["library_wrapper_ms"] / 1e9
        r["library_device_tops"] = ops / r["library_device_ms"] / 1e9
        b_ms, by_ms, op_ms = bound(nbytes, ops, peak)
        r.update(bound_ms=b_ms, bytes_ms=by_ms, ops_ms=op_ms)
        rows["i8_dot"].append(r)
        print(json.dumps({"tool": "bench_i8_dot", "kernel": "i8_dot",
                          "tolerance": TOL["i8_dot"], **r,
                          "card": nvidia_smi_line()}), flush=True)


def gn_stages_flops(stage: str, b: int, n: int, psz: int,
                    max_iter: int) -> float:
    """Float operations of one `gn_stages` call, as the kernel does them:
    per pixel and trip W 4 (three tap sums, one accumulation), A3 10 (nine
    for the bilinear, one accumulation), A4 18 (the bilinear, the patch
    sum, the residual's two subtractions, |.|, the three accumulations:
    1 + 2 + 2); A4 also a division a patch and trip for the mean and, once
    a patch, the division and two additions at the end."""
    per_px = {"W": 4, "A3": 10, "A4": 18}[stage]
    ops = float(b) * n * max_iter * psz * psz * per_px
    if stage == "A4":
        ops += float(b) * n * (max_iter + 3)
    return ops


def run_gn_stages(dev, rows, totals):
    """Phase 10: the GN stage ablation's main path (the tool at both
    geometries, launches counted), then every stage against its twin on
    the card and every variant against A4, timed (wrapper and device);
    the stages' device times at op2-l3 beside the small-level GN kernel's
    level-3 device time of path A (448 patches, batch 64, per pair), at
    op4-l0 beside the large-level GN kernel's level-0 device time of path
    F (51,300 patches, batch 4), from the same run."""
    reset_launches()
    results = {g: bench_gn_stages.main(["--geometry", g, "--device",
                                        str(dev)])
               for g in ("op2-l3", "op4-l0")}
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"gn_stages: launches in one run of the tool at both geometries: "
          f"{json.dumps(launches)}", flush=True)
    if set(launches) != {"gn_stages"}:
        raise AssertionError(f"gn_stages tool launches {launches}")
    totals["gn_stages"] = totals.get("gn_stages", 0) + launches["gn_stages"]
    if not all(r["equal_a4"] for res in results.values() for r in res
               if r["variant"]):
        raise AssertionError("gn_stages: a variant differs from A4")
    k6_l0 = [r["device_ms"] for r in rows["gn_tiled"]
             if r["shape"].startswith("B4 N51300 ")]
    # path A's level 3 (the first such call: A runs first; B is depth, C
    # RGB)
    k1_l3 = [r["device_ms"] for r in rows["gn_fused"]
             if r["shape"].startswith("B64 N448 D64 nop2 ")]
    for gname in results:
        geom = bench_gn_stages.GEOMETRIES[gname]
        b, n, psz = geom.batch, geom.n, geom.psz
        x = bench_gn_stages.make_inputs(geom, b, dev)
        a4 = None
        stage_ms = {}
        for label, stage, variant in bench_gn_stages.RUNS:
            args = bench_gn_stages.call_args(x, geom, stage, variant)
            out = gn_stages.gn_stages(*args)
            twin = gn_stages._plain(*args)
            torch.cuda.synchronize()
            err = float((out - twin).abs().max())
            scale = float(twin.abs().max())
            if not err <= TOL["gn_stages"] * scale:
                raise AssertionError(f"gn_stages {gname} {label}: err {err} "
                                     f"of checksums up to {scale}")
            if stage == "A4" and not variant:
                a4 = out
            if variant and not torch.equal(out, a4):
                raise AssertionError(f"gn_stages {gname} {label} != A4")
            # planes, the anchors and the checksums
            nbytes = (args[0].numel() * args[0].element_size()
                      + 4 * 2 * b * n + 4 * b * n)
            if stage == "A4":
                nbytes += 4 * 3 * b * n * psz * psz
            r = dict(shape=f"{gname} {label} B{b} N{n} psz{psz} "
                     f"trips{geom.max_iter} layout{geom.layout}",
                     max_abs_err=err, max_abs_checksum=scale,
                     wrapper_ms=cuda_ms(lambda: gn_stages.gn_stages(*args), 5,
                                       3),
                     plain_ms=cuda_ms(lambda: gn_stages._plain(*args), 1, 1),
                     library_wrapper_ms=None,
                     device_ms=device_ms(gn_stages.gn_stages, args),
                     library_device_ms=None)
            r["us_per_pair"] = r["wrapper_ms"] * 1e3 / b
            r["device_us_per_pair"] = r["device_ms"] * 1e3 / b
            stage_ms[label] = r["device_ms"]
            b_ms, by_ms, op_ms = bound(nbytes, gn_stages_flops(
                stage, b, n, psz, geom.max_iter))
            r.update(bound_ms=b_ms, bytes_ms=by_ms, ops_ms=op_ms)
            rows["gn_stages"].append(r)
            print(json.dumps({"tool": "bench_gn_stages",
                              "kernel": "gn_stages",
                              "tolerance": TOL["gn_stages"], **r}),
                  flush=True)
        # the cumulative stages and their differences, in device ms
        w, a3, a4_ms = (stage_ms[k] for k in
                        ("W taps", "A3 +bilerp", "A4 +loss/proj"))
        split = {"W": w, "A3": a3, "A4": a4_ms, "A3-W": a3 - w,
                 "A4-A3": a4_ms - a3}
        if gname == "op2-l3" and k1_l3:
            print(json.dumps({
                "beside": "gn_fused (K1) at level 3 of path A: 448 patches "
                          "x 64 pairs, 12 trips; T2 on K1's lane layout",
                "k1_device_us_per_pair": k1_l3[0] * 1e3 / 64,
                "t2_op2_l3_device_us_per_pair": {
                    k: v * 1e3 / b for k, v in split.items()},
                "card": nvidia_smi_line()}), flush=True)
        if gname == "op4-l0" and k6_l0:
            print(json.dumps({
                "beside": "gn_tiled (K6) at level 0 of path F: 51,300 "
                          "patches x 4 pairs, 128 trips; T2 on K6's column "
                          "layout",
                "k6_l0_device_ms": k6_l0[0],
                "t2_op4_l0_device_ms": split,
                "a4_below_k6": a4_ms < k6_l0[0],
                "card": nvidia_smi_line()}), flush=True)


# --------------------------------------------- row-sharded TV (phase 11)

# Full-HD pairs: 1080 rows pad to 1088 at op-3 and op-4 (sc_f 6), so the
# model's routed levels are L1 544x960 (op-4) and L2 272x480 (op-3).
SPATIAL_H, SPATIAL_W = 1080, 1920
# The model cases, each routed over `devices` x cuda:0 with a threshold
# between the working sets (`dis._TV_FIELDS` fields a pixel) of the
# routed level (`level`) and the next coarser one: S1 op-4 gray flow (L1
# 217 MB, L2 54 MB; n_inner 2, halo 20, 136 rows a shard), S2 the same in
# depth (K5), S3 op-3 RGB flow (L2 54 MB, L3 14 MB; n_inner 3, halo 28,
# 136 rows a shard).
SPATIAL = [
    dict(name="S1", what="op-4 gray flow", op=4, nop=2, noc=1, batch=4,
         devices=4, level=1, min_bytes=100 << 20),
    dict(name="S2", what="op-4 gray depth", op=4, nop=1, noc=1, batch=4,
         devices=4, level=1, min_bytes=100 << 20),
    dict(name="S3", what="op-3 RGB flow", op=3, nop=2, noc=3, batch=4,
         devices=2, level=2, min_bytes=32 << 20),
]
# tests/test_fuzz_params.py's configuration for seed 0 (numpy
# default_rng(1000), then sc_f), which tests/test_torch_fuzz_params.py
# holds this copy to
FUZZ_SEED0 = dict(
    p_samp_s=4, patove=0.4623051082037978, costfct=2, patnorm=0,
    max_iter=8, min_iter=2, dp_thresh=0.13690216614881262,
    dr_thresh=0.8382072560161578, res_thresh=0.0, usetvref=False,
    usefbcon=False, tv_alpha=16.30522328287391, tv_gamma=13.275076650968213,
    tv_delta=7.182332454250331, tv_innerit=2, tv_solverit=3,
    tv_sor=1.4490235979236834)
FUZZ_SEED0_SC_F = 2


def _tv_kernel(nop):
    return "tv_of_inner" if nop == 2 else "tv_de_inner"


def _whole_level(nop, kw):
    """The unsharded level on a recorded split's inputs: K3, then K2 or
    K5, once for the whole frame."""
    if nop == 2:
        return lambda f, i1, i2: torch.stack(tv.ref_level_of_batched(
            f[..., 0].contiguous(), f[..., 1].contiguous(), i1, i2, **kw),
            dim=-1)
    return lambda wx, i1, i2: tv.ref_level_de_batched(wx.contiguous(), i1,
                                                      i2, **kw)


def split_level(label, split, whole, args, nop, row0s, rows):
    """One split of a level on its recorded inputs `args` (flow or
    disparity, im1, im2): every shard's K3 and K2 / K5 call held against
    its twin (one JSON line a call, appended to rows[name]), their row
    origins `row0s` and parities asserted, the split equal to the
    unsharded level (0.0 px), and the device ms of both (`device_ms`),
    with the card's name and power limit."""
    tv_name = _tv_kernel(nop)
    calls = {name: [] for name in KERNELS}
    with swapped(_recorder(calls)) as wrappers:
        out = split(*args)
    torch.cuda.synchronize()
    calls = {name: c for name, c in calls.items() if c}
    got_row0 = [kw["row0"] for _, kw in calls.get("warp", [])]
    parities = [kw["row_parity"] for _, kw in calls.get(tv_name, [])]
    if set(calls) != {"warp", tv_name} or got_row0 != row0s or \
            parities != [g % 2 for g in row0s]:
        raise AssertionError(f"{label}: calls {sorted(calls)}, row origins "
                             f"{got_row0} (expected {row0s}), parities "
                             f"{parities}")
    for name, recorded in calls.items():
        for i, (a, kw) in enumerate(recorded):
            r = check_call(name, a, kw, wrappers[name], rows)
            print(json.dumps({"spatial": label, "kernel": name, "shard": i,
                              "row0": row0s[i],
                              "row_parity": row0s[i] % 2, "launches": 1,
                              "tolerance": TOL[name], **r}), flush=True)
    want = whole(*args)
    torch.cuda.synchronize()
    diff = float((out - want).abs().max())
    if not torch.equal(out, want):
        raise AssertionError(f"{label}: the split is {diff} px off the "
                             "unsharded level")
    print(json.dumps({"spatial": label, "level": tuple(args[0].shape[:3]),
                      "shards": len(row0s), "parities": sorted(
                          {g % 2 for g in row0s}),
                      "max_abs_diff_vs_unsharded_px": diff,
                      "split_device_ms": device_ms(split, args),
                      "unsharded_device_ms": device_ms(whole, args),
                      "card": nvidia_smi_line()}), flush=True)


def _wall_ms(fn):
    """Host ms of 3 calls of a warm fn, each ending in a synchronize."""
    return [w * 1e3 for w in _timed(fn)[0]]


def _row0s(mesh, h, kw):
    return [g0 for _, g0, _ in spatial._row_blocks(
        mesh, h, spatial.halo_depth(kw["n_inner"], kw["n_solver"]))]


def _check_split_launches(label, routed, unrouted, tv_name, n):
    """A routed call launches n K3 and n K2 / K5 in place of one of each,
    and everything else as the unrouted call."""
    want = dict(unrouted)
    for name in ("warp", tv_name):
        want[name] = want[name] + n - 1
    print(f"{label}: launches routed {json.dumps(routed)}, unrouted "
          f"{json.dumps(unrouted)}", flush=True)
    if routed != want:
        raise AssertionError(f"{label}: launches {routed}, expected {want}")


def run_spatial_model(cfg, dev, rows, totals):
    """S1-S3: `dis_flow_batched` on full-HD pairs with the finest level's
    TV row-sharded (`params.with_spatial_tv`) against the unrouted call
    (0.0 px), launches asserted, the routed level's split checked call by
    call (`split_level`), wall ms of both calls. Returns the routed
    level's inputs and arguments."""
    label, nop, noc, n = cfg["name"], cfg["nop"], cfg["noc"], cfg["devices"]
    params = op_point_params(SPATIAL_W, cfg["op"], nop=nop, noc=noc)
    mesh = pmesh.make_mesh([dev] * n)
    routed = with_spatial_tv(params, mesh, min_bytes=cfg["min_bytes"])
    field = synth.flow_field if nop == 2 else synth.disparity_field
    a_u8, b_u8, _, _ = synth.make_pairs(cfg["batch"], SPATIAL_H, SPATIAL_W,
                                        0, dev, channels=noc, field=field)
    im_a = pyramid.pad_to_divisible(a_u8, params.sc_f)
    im_b = pyramid.pad_to_divisible(b_u8, params.sc_f)
    full_h, full_w = im_a.shape[2], im_a.shape[3]

    def run(p):
        return dis.dis_flow_batched(im_a, im_b, p, full_w, full_h,
                                    device=dev)

    entry = "tv_refine_spatial" if nop == 2 else "tv_refine_spatial_de"
    fn = getattr(spatial, entry)
    seen = []

    def recorded(m, *args, **kw):
        seen.append((args, kw))
        return fn(m, *args, **kw)

    setattr(spatial, entry, recorded)
    try:
        reset_launches()
        out = run(routed)
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        setattr(spatial, entry, fn)
    reset_launches()
    want = run(params)
    torch.cuda.synchronize()
    _check_split_launches(label, launches, read_launches(), _tv_kernel(nop),
                          n)
    for name, k in launches.items():
        totals[name] = totals.get(name, 0) + k
    lh, lw = full_h >> cfg["level"], full_w >> cfg["level"]
    if len(seen) != 1 or tuple(seen[0][0][0].shape[1:3]) != (lh, lw):
        raise AssertionError(f"{label}: routed levels "
                             f"{[tuple(a[0].shape) for a, _ in seen]}, "
                             f"expected one of {lh}x{lw}")
    diff = float((out - want).abs().max())
    print(f"{label} ({cfg['what']}, batch {cfg['batch']}, {SPATIAL_W}x"
          f"{SPATIAL_H} padded to {full_w}x{full_h}): L{cfg['level']} "
          f"{lh}x{lw} over {n} x {dev}: routed vs unrouted max |diff| "
          f"{diff} px", flush=True)
    if not torch.equal(out, want):
        raise AssertionError(f"{label}: routed differs by {diff} px")
    args, kw = seen[0]
    split_level(label, lambda *a: fn(mesh, *a, **kw), _whole_level(nop, kw),
                args, nop, _row0s(mesh, lh, kw), rows)
    print(json.dumps({"spatial": label, "e2e": "dis_flow_batched",
                      "routed_wall_ms": _wall_ms(lambda: run(routed)),
                      "unrouted_wall_ms": _wall_ms(lambda: run(params)),
                      "card": nvidia_smi_line()}), flush=True)
    return args, kw


def run_spatial_level(dev, rows, totals):
    """S4: `dis._tv_refine` on a level-0 spec of 1920x1080 (n_inner 1,
    halo 12), batch 4, gray flow and gray depth, routed over 8 x cuda:0
    (135 rows a shard: odd shards run K2 / K5 at parity 1) and 4 x cuda:0
    (270), against the unrouted level (0.0 px), launches asserted, every
    shard's calls against their twins, wall ms of one call."""
    h, w = SPATIAL_H, SPATIAL_W
    for nop, field in ((2, synth.flow_field),
                       (1, synth.disparity_field)):
        params = DISParams(sc_f=0, sc_l=0, max_iter=1, min_iter=1,
                           p_samp_s=8, patove=0.4, nop=nop, noc=1,
                           tv_innerit=1, tv_solverit=3)
        spec = make_level_spec(0, w, h, params)
        p = spec.pad
        a_u8, b_u8, u, v = synth.make_pairs(4, h + 2 * p, w + 2 * p, 1,
                                            dev, field=field)
        im_a, im_b = a_u8.float(), b_u8.float()
        flow = torch.stack([u, v], dim=-1)[p:-p, p:-p, :nop].expand(
            4, h, w, nop).contiguous()
        level = (flow, im_a, im_b, spec)
        reset_launches()
        want = dis._tv_refine(*level, params)
        torch.cuda.synchronize()
        unrouted = read_launches()
        kw = dict(alpha=params.tv_alpha, gamma=params.tv_gamma,
                  delta=params.tv_delta, n_inner=1,
                  n_solver=params.tv_solverit, omega=params.tv_sor)
        if nop == 1:
            kw["camlr"] = spec.camlr
        args = ((flow if nop == 2 else flow[..., 0]),
                im_a[:, :, p:-p, p:-p].contiguous(),
                im_b[:, :, p:-p, p:-p].contiguous())
        entry = (spatial.tv_refine_spatial if nop == 2
                 else spatial.tv_refine_spatial_de)
        for n in (8, 4):
            label = f"S4 {'flow' if nop == 2 else 'depth'} x{n}"
            mesh = pmesh.make_mesh([dev] * n)
            routed = with_spatial_tv(params, mesh, min_bytes=0)
            if dis._spatial_tv_route(4, h, w, routed) is not mesh:
                raise AssertionError(f"{label}: the level is not routed")
            reset_launches()
            got = dis._tv_refine(*level, routed)
            torch.cuda.synchronize()
            launches = read_launches()
            _check_split_launches(label, launches, unrouted,
                                  _tv_kernel(nop), n)
            for name, k in launches.items():
                totals[name] = totals.get(name, 0) + k
            diff = float((got - want).abs().max())
            print(f"{label}: _tv_refine at {w}x{h}, batch 4, {h // n} rows "
                  f"a shard: routed vs unrouted max |diff| {diff} px",
                  flush=True)
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: routed differs by {diff} px")
            split_level(label, lambda *a, m=mesh: entry(m, *a, **kw),
                        _whole_level(nop, kw), args, nop,
                        _row0s(mesh, h, kw), rows)
            print(json.dumps({
                "spatial": label, "e2e": "_tv_refine",
                "routed_wall_ms": _wall_ms(
                    lambda r=routed: dis._tv_refine(*level, r)),
                "unrouted_wall_ms": _wall_ms(
                    lambda: dis._tv_refine(*level, params)),
                "card": nvidia_smi_line()}), flush=True)


def run_spatial_2d(dev, level_args, kw, rows, totals):
    """S5: `tv_refine_spatial_batched` on S1's routed level, pairs x rows
    = 2 x 2 on cuda:0: launches (4 K3, 4 K2), every call against its twin,
    equal to the unsharded level."""
    meshes = (pmesh.make_mesh([dev] * 2),) * 2
    flow = level_args[0]
    reset_launches()
    spatial.tv_refine_spatial_batched(meshes, *level_args, **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"S5: launches {json.dumps(launches)}", flush=True)
    if launches != {"warp": 4, "tv_of_inner": 4}:
        raise AssertionError(f"S5: launches {launches}")
    for name, k in launches.items():
        totals[name] = totals.get(name, 0) + k
    split_level("S5 pairs x rows 2 x 2",
                lambda *a: spatial.tv_refine_spatial_batched(meshes, *a,
                                                             **kw),
                _whole_level(2, kw), level_args, 2,
                _row0s(meshes[0], flow.shape[1], kw) * 2, rows)


def run_fuzz_config(dev, rows, totals):
    """S6: the fuzzed configuration of seed 0 (64x128, sc_f 2, patch 4,
    pseudo-Huber, no mean normalisation), as drawn (TV off) and with TV
    on, through `dis_flow_batched` on 4 pairs: every kernel call against
    its twin, launches counted, the kernel path against the plain path."""
    h, w = 64, 128
    a_u8, b_u8, _, _ = synth.make_pairs(4, h, w, 3, dev)
    for tv_on in (False, True):
        label = "S6" + (" TV on" if tv_on else "")
        params = DISParams(sc_f=FUZZ_SEED0_SC_F, sc_l=0, noc=1, nop=2,
                           **dict(FUZZ_SEED0, usetvref=tv_on))

        def run():
            return dis.dis_flow_batched(a_u8, b_u8, params, w, h,
                                        device=dev)

        calls = {name: [] for name in KERNELS}
        with swapped(_recorder(calls)) as wrappers:
            run()
        torch.cuda.synchronize()
        check_calls(label, {n: c for n, c in calls.items() if c}, wrappers,
                    rows, w, 0)
        reset_launches()
        out = run()
        torch.cuda.synchronize()
        launches = read_launches()
        for name, k in launches.items():
            totals[name] = totals.get(name, 0) + k
        with swapped(lambda name, _: PLAIN[name]):
            ref = run()
        ratio = epe_ratio(out, ref)
        print(f"{label}: launches {json.dumps(launches)}; EPE ratio, kernel "
              f"path vs plain path: {ratio:.3e}", flush=True)
        if tuple(out.shape) != (4, h, w, 2) or \
                not bool(torch.isfinite(out).all()) or not ratio < 1e-3:
            raise AssertionError(f"{label}: shape {tuple(out.shape)}, "
                                 f"EPE ratio {ratio}")


def run_spatial_phase(dev, rows, totals):
    """Phase 11: S1-S6."""
    t0 = time.perf_counter()
    level = {cfg["name"]: run_spatial_model(cfg, dev, rows, totals)
             for cfg in SPATIAL}
    run_spatial_level(dev, rows, totals)
    run_spatial_2d(dev, *level["S1"], rows, totals)
    run_fuzz_config(dev, rows, totals)
    print(f"spatial phase: {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------ the measurement tools (phase 12)

# the bench's rows beside its primary one, and its timed calls a row
TOOLS_BENCH_ROWS = ("op3_pairs_per_sec", "de_op2_pairs_per_sec",
                    "seq_op3_pairs_per_sec")
TOOLS_BENCH_ITERS = 2


def _built_files() -> set:
    return {f for f in os.listdir(build.BUILD_DIR)
            if os.path.isfile(os.path.join(build.BUILD_DIR, f))}


def run_tools_phase(dev, totals, cold_dir):
    """Phase 12 (see the module docstring): warmup, then the bench (its
    rows' launches added to the kernels' totals), then eval_epe on the
    pipeline's cold files."""
    t_phase = time.perf_counter()
    reset_launches()
    warmup.main(["--w", str(W_ORG), "--h", str(H_ORG), "--batch", "64",
                 "--ops", "2", "--modes", "of_int"])
    torch.cuda.synchronize()
    for name, n in read_launches().items():
        totals[name] = totals.get(name, 0) + n
    built = _built_files()

    saved = os.environ.get("BENCH_ITERS")
    os.environ["BENCH_ITERS"] = str(TOOLS_BENCH_ITERS)
    try:
        line = bench.main([], rows=TOOLS_BENCH_ROWS, h=H_ORG, w=W_ORG)
    finally:
        if saved is None:
            del os.environ["BENCH_ITERS"]
        else:
            os.environ["BENCH_ITERS"] = saved
    new = _built_files() - built
    if new:
        raise AssertionError(f"the calls after warmup built {sorted(new)}")
    names = (bench.PRIMARY,) + TOOLS_BENCH_ROWS
    values = [line["value"]] + [line["secondary"][k]
                                for k in TOOLS_BENCH_ROWS]
    if (set(line["secondary"]) != set(TOOLS_BENCH_ROWS)
            or not all(math.isfinite(v) and v > 0 for v in values)
            or any(line["busy_share"][k] is None for k in names)
            or line["vs_baseline"] is not None or not line["card"]):
        raise AssertionError(f"bench line: {line}")
    for counts in line["launches"].values():
        for name, n in counts.items():
            totals[name] = totals.get(name, 0) + n

    gt_dir = os.path.join(OUT_DIR, "tools", "gt")
    shutil.rmtree(gt_dir, ignore_errors=True)
    os.makedirs(gt_dir)
    flos = sorted(f for f in os.listdir(cold_dir) if f.endswith(".flo"))
    gt = np.empty((H_ORG, W_ORG, 2), np.float32)
    gt[...] = PIPELINE["step"]
    for f in flos:
        io.write_flo(os.path.join(gt_dir, f), gt)
    out = io_mod.StringIO()
    with contextlib.redirect_stdout(out):
        rc = eval_epe.main([cold_dir, gt_dir])
    text = out.getvalue()
    print(text, end="")
    last = text.strip().splitlines()[-1]
    mean = float(last.rsplit("EPE", 1)[1])
    if rc != 0 or not last.startswith(f"mean over {len(flos)} files") \
            or not math.isfinite(mean):
        raise AssertionError(f"eval_epe: rc {rc}, {last!r}")
    print(json.dumps({"tools": "warmup, bench, eval_epe",
                      "bench_pairs_per_s": dict(zip(names, values)),
                      "eval_epe_files": len(flos),
                      "eval_epe_mean_px": mean,
                      "true_motion_px": PIPELINE["step"],
                      "seconds": time.perf_counter() - t_phase,
                      "card": nvidia_smi_line()}), flush=True)


# -------------------------------------------------------------------- main

def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = dis.resolve_device("cuda")

    # 2. build
    t0 = time.perf_counter()
    reports = build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(reports)} "
          "kernels", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 3-4. every path; 5. the single-pair entries on paths A and B
    rows = {name: [] for name in KERNELS}
    totals = {}
    walls = {}
    finest = {cfg["name"]: run_path(cfg, dev, rows, totals, walls)
              for cfg in PATHS}
    for label in ("A", "B"):
        run_single(label, finest[label], rows, totals)

    # 6. the warm sequence (path J) and the CLI's warm start
    run_sequence(dev, rows, totals, walls)
    run_cli_init_flow()

    # 7. the serving pipeline: decode, cold batches, streams, depth, two
    # devices
    cold_dir = run_pipeline_phase(dev, totals, walls)
    # 7b. JPEG frames: the decoder against cv2's hashes, serving, the CLI
    run_jpeg_part(dev, totals, walls)
    # 7c. PNG, PNM and BMP frames: the same, at op-2 gray flow
    run_formats_part(dev, totals, walls)
    # 7d. WebP, Sun raster, PAM, HDR and PFM frames: the same
    run_webp_part(dev, totals, walls)
    run_raster_part(dev, totals, walls)
    # 7e. TIFF and GIF frames: the same
    run_tiff_part(dev, totals, walls)
    run_gif_part(dev, totals, walls)
    # 7f. JPEG 2000 frames: the same, on the committed frames
    run_jp2_part(dev, totals, walls)
    # 7g. damaged JPEG frames, read as cv2.imread reads them: the same
    run_jpeg_damaged_part(dev, totals, walls)
    # 7h. damaged TIFF frames, read as cv2.imread reads them: the same
    run_tiff_damaged_part(dev, totals, walls)

    # 8. goldens through the CLI on the card, quiet and at verbosity 2
    run_goldens()
    run_verbose_goldens()

    # 9-10. the measurement tools' kernels
    run_i8_dot(dev, rows, totals)
    run_gn_stages(dev, rows, totals)

    # 11. the row-sharded TV refinement, and one fuzzed configuration
    run_spatial_phase(dev, rows, totals)

    # 12. the measurement tools: warmup, bench, eval_epe
    run_tools_phase(dev, totals, cold_dir)

    # 13. summary: per kernel, summed over its calls in one run of every
    # path or tool
    summary = []
    for name, rs in rows.items():
        if not rs or not totals.get(name):
            raise AssertionError(f"kernel {name} was launched on no path")
        k = KERNELS[name]
        lib = [r["library_wrapper_ms"] for r in rs]
        dev = [r.get("device_ms") for r in rs]
        lib_dev = [r.get("library_device_ms") for r in rs]
        summary.append({
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "tpu_kernels": k["tpu_kernels"],
            "launches": totals[name],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            # the wrapper's CUDA-event time; where measured, the device's
            # own time (`device_ms`) beside it, for the library call too
            "ms": sum(r["wrapper_ms"] for r in rs),
            "device_ms": None if None in dev else sum(dev),
            "library_device_ms": None if None in lib_dev else sum(lib_dev),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": ("bytes" if sum(r["bytes_ms"] for r in rs)
                         >= sum(r["ops_ms"] for r in rs) else "operations"),
            "library_ms": None if None in lib else sum(lib),
        })
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
