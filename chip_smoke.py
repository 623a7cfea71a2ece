#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path and its GAN training step on one
NVIDIA GPU, with the shift attention engine and with the fused one, then the
port's drivers, train_torch.py and eval_torch.py, its data-parallel step, the
metric battery, the modules off the main path, the measuring tools, the
drivers over real-layout data sets without cv2 and the benchmark,
bench_torch.py.

    python3 chip_smoke.py [--out DIR]   # from the root of a checkout, one card

Phases (any failure exits non-zero, nothing falls back to the CPU):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the hand-written kernels from hoig_torch/csrc (one nvcc each, in
     parallel), report the build seconds, and hold the tile constants that
     hoig_torch/ops/attn_fused.py and local_combine.py repeat (TILING)
     against the libraries';
  3. drive the serving path once, eagerly (flow_eager + forward_eager:
     conditioning + generator_spade_attn at full
     width, 256 px, batch 4, bf16, shift engine, random weights from a seed)
     with every launch counter at 0, and record the inputs each kernel got;
     then hold each kernel against its plain PyTorch version on exactly those
     inputs and time kernel, plain version, library yardstick and bound (the
     B1 forward: bf16 on the tensor cores, counted as local_combine_tc, its
     window staged by TMA on all 18 calls, within one bf16 ulp plus 1e-5 of
     the largest sum of |v||src| with the count of elements that differ,
     bit-equal to itself on a second call; the same inputs cast to f32
     through the FP32 kernel, bit-equal); hold them again on small ragged
     shapes off the tile grid (the forward also on shapes that take the
     element-wise staging, partial slabs and a frame smaller than the TMA
     box), and the rasterizer on scenes with exact ties (duplicated faces,
     faces of one plane; one scene whose tile lists overflow);
 3b. the InstanceNorm kernels (hoig_torch/csrc/instance_norm.cu: the
     statistics, the apply, the backward's sums, coefficients and dx) at
     every (H, C, batch, dtype) of the benchmark's cells, affine and
     parameter-free, against their plain versions on the card (y and dx of
     bf16 inputs within one bf16 ulp plus 1e-6 of the largest entry, every
     f32 result within 1e-6 of its largest entry), each bit-equal to itself on a second call and the kept
     pair's apply to the first; then contiguous NCHW, odd planes, C off the
     16-byte vector and a one-pixel plane; timed beside their bytes bound,
     the plain version they replaced (FoldedStats and the apply) and
     F.instance_norm, summed per step and per call of the cells;
  4. compare the card with the CPU: the conditioning at 128 px, batch 2, and
     the full-width generator in f32 (TF32 off) at 128 px, batch 1, its
     outputs and the gradient of a fixed scalar of them w.r.t. every weight;
  5. time the serving call (>= 5 calls after warm-up: CUDA graphs'
     replays), assert 18 / 1 / 2
     launches of the combine (local_combine_tc) / rasterizer / gather
     kernels on the eager first call and on the call that captures (its
     warm-up), none on a replay, and finite outputs;
 5b. the serving calls' CUDA graphs (flow_only, forward_only) against the
     eager bodies at the benchmark's hogan_dexycb (batch 16) and
     hogan_ho3dv3 (batch 4, and a partial batch of 3): five calls on
     different rows bit-equal to eager, no output changed by a later call,
     launches counted on the eager call and the capture's warm-up alone,
     a weight scaled in place seen by the next replay, a replaced weight
     captured again; call ms eager and replayed, the host ms of a replay,
     the weights' guard in us, peak memory;
  6. the fused attention engine (corner_engine "pallas", the four B4
     kernels of hoig_torch/csrc/attn_fused.cu; under bf16, B4-fwd's phase A,
     B4-bwd-a-gsrc's projection and B4-bwd-a-dw run on the tensor cores,
     counted as attn_fused_fwd_tc, attn_fused_bwd_a_gsrc_tc and
     attn_fused_bwd_a_dw_tc; B4-bwd-c is bwd_c_kernel, V and the padded
     gradient kept on chip, with bwd_c_gattn_kernel for g_attn's last sum)
     on the same model, data and weights: (a) one eager
     serving call from launch counters at 0 (9 / 1 / 2 launches of B4-fwd /
     rasterizer / gather, no combine) with B4-fwd held against its plain
     version on the nine recorded inputs; (b) one training step (remat off)
     from counters at 0 (9 of each B4 kernel, 1 / 2 of B2 / B3), each
     backward kernel held against its plain version on the recorded inputs
     (dW on the dG that B4-bwd-a-gsrc returned), finite metrics, every G
     weight moved; each B4 kernel called twice on each input and held
     bit-equal to itself (B4-bwd-c's source gradient also bit-equal to the
     plain version, bf16 and f32), and timed beside its plain version, its
     library yardstick (cuDNN conv2d, conv_transpose2d and the weight gradient of
     the three tensor-core products alone, named in the kernels line's
     "library" key) and its FP32 path on the f32-cast inputs; the same first
     step twice more with remat off and once with remat and remat_attn on
     (18 B4-fwd launches: the recompute runs each layer's forward again),
     every G and D gradient and updated weight of the three bit-equal; (c)
     all four kernels on ragged shapes and at odd channel counts (run at the
     next even count), and B4-bwd-c also on frames with H or W equal to 1 and
     below 11 (one pixel collects both margins); (d) fused and shift engines
     agree on the card
     in f32 (TF32 off), 128 px, batch 1, outputs and the gradients of a fixed
     scalar; (e) the fused serving call and step timed as in phases 5 and 7,
     each B4 kernel and its plain version timed, and the shift engine's
     ExtractorAttn on the same layer inputs as a yardstick (the training
     state is freed before phase 7, and rebuilt for phase 8);
  7. the training step (make_train_step: conditioning, generator, G losses
     with VGG and the PatchGAN-4 discriminator, both Adam updates) at full
     width, 256 px, batch 4, bf16, shift engine: one step from launch
     counters at 0 with the backward kernels' inputs recorded, then bwd_src
     and bwd_v held against their plain versions on those inputs: bf16 as
     recorded through the tensor-core kernels (counted as
     local_combine_bwd_src_tc and local_combine_bwd_v_tc; each called twice
     and held bit-equal to itself; dsrc within one bf16 ulp plus 1e-5 of the
     largest sum of |v||g|, with the count of elements that differ; dv
     within one ulp plus 1e-5 of |g||src|), and cast to f32 through the FP32
     kernels (dsrc bit-equal); then timed beside their plain versions and
     the FP32 kernels; the edge-pad fold (edge_pad_fold: the backward of the
     attention's replicate pads, one fold_kernel launch per padded tensor)
     on the step's 18 recorded gradients and on ragged frames and the main
     path's frames with C not a multiple of 8, at pads 2 and 5, f32 and
     bf16, aligned and one element off 16 bytes, bit-equal to its plain
     version (the f32 fold rounded once) and to itself, timed beside it and
     aten's replication_pad2d_backward; warm and timed steps with the per-step
     launch counts (18 / 18 / 9 / 1 / 2 / 18 edge-pad folds) asserted,
     finite metrics, every weight moved, D bit-equal across a gated step;
     the same again with the bf16 remat defaults (bottleneck and attention
     kept) for the memory peak; (b) the same first step (fresh weights from
     seed 0) twice with the remat defaults and (c) once with remat off:
     every G and D gradient and updated weight bit-equal; (d) the
     determinism probe: one step with the shift engine (remat defaults),
     with the fused engine (remat off; remat + remat_attn) and the fp32
     step of (e) under torch.use_deterministic_algorithms(True,
     warn_only=True), printing every op it warns about, none allowed; (e)
     the fp32 step as the drivers run it (TrainConfig(): f32, gather
     engine, full remat) at batch 8: one step from launch counters at 0
     (1 / 2 / 9 / 9 launches of B2 / B3 / the edge-pad fold / scatter_rows,
     the gather engine's one corner gather per layer transposed in a fixed
     order) with the 9 layers' corner gradients recorded; scatter_rows held
     on them bit-equal to its plain version and to itself, timed whole and
     as its two stages apart (the order built on the card; the sum in it)
     beside it, one index_add_ and the 72 torch.gather backward passes a
     layer that it replaced (that backward also run twice on the same
     inputs, the elements that differ counted); then on ragged shapes (C
     from 1 to 512, indices outside the rows, one row, no entry, 100,000
     entries on one row, a clamped gather layer, an unaligned base, f32
     and bf16) and through GatherRows; then the same first step twice and
     once with remat off,
     every G and D gradient and updated weight bit-equal (cuDNN
     deterministic, TF32 off);
  8. one profiler window over two serving calls and one training step with
     each engine, and one shift step with the bf16 remat defaults, splits
     the device time of each by kernel, and asserts 9 launches of dg_kernel,
     dw_tc_kernel, bwd_c_kernel and bwd_c_gattn_kernel and 18 of fold_kernel
     (the gsrc projection's and the target pad's) per fused step, and 18 of
     combine_fwd_tc_kernel, of combine_bwd_src_tc_kernel and of fold_kernel,
     9 of combine_bwd_v_tc_kernel, one of bin_kernel and raster_kernel and
     none of the FP32 combine kernels per shift step with either remat (and
     per shift serving call: 18, 1, 1, none); the remat-defaults step runs
     as many InstanceNorm statistics kernels (inorm_stats_kernel) as the
     remat-off step (the recompute keeps them: models/layers.py
     keep_stats) and 37 more apply kernels, and its device kernels, the
     statistics' ms and the kernels that keeping them saves the recompute
     (derived from the norms in rematerialized blocks) are printed;
  9. the drivers, after the earlier phases' models are freed, at full width
     on the synthetic dataset (256 px, batch 4, bf16, --use_spade --use_vgg
     --mask_bce, random weights): the loader alone over three batches;
     train_torch.Train for one epoch of 3 steps, each step from launch
     counters at 0 (18 / 18 / 9 / 1 / 2 / 18 as in phase 7), finite errors, the
     first display's visuals forward and validation forward (18 / 1 / 2
     launches each), the validation losses logged, the epoch-1 checkpoint
     files under their reference names; eval_torch.main --load_epoch 1 from
     that directory over 2 batches (shift engine): the loaded G bit-equal to
     the G that was saved, 18 / 1 / 2 launches per batch, the first batch's
     fakes bit-equal to flow_only + forward_only on the same batch and
     weights, 8 PNGs each in source/, imitators/ and gt/, 256x256 by their
     IHDR; eval_torch.main --corner_engine pallas over 1 batch (9 launches of
     attn_fused_fwd_tc, no combine). Times: the loader's ms per batch, the
     driver's train steps and iterations beside phase 7's step with the same
     remat, the eval batches with and without the PNG writes beside phase
     5's serving call, model builds, checkpoint saves, peak device memory.
     The checkpoint directory (about 2.3 GB) is deleted at the end;
 10. data parallelism and the metrics: (a) an NCCL process group of world
     size 1 in this process; the same first step (fresh weights from seed 0,
     remat off, D's gate on) twice in one process and once through
     hoig_torch.parallel.DataParallel, each from launch counters at 0: the
     data-parallel step's kernel launches are phase 7's (18 / 18 / 9 / 1 /
     2 / 18) and its collectives are counted (the gate's gloo broadcast, the
     G and D gradient all-reduces, the metrics' all-reduce); the two
     one-process steps bit-equal, and the data-parallel step's G and D
     gradients and updated weights bit-equal to theirs; the fp32 batch-8
     step of phase 7e through DataParallel bit-equal to phase 7e's
     one-process step; the all-reduce of
     G's and D's flat f32 gradients timed; (b) `python -m torch.distributed.run
     --standalone --nproc_per_node 1 train_torch.py` for one epoch of 3
     synthetic steps at full width: exit 0, its epoch-1 checkpoint, its
     iterations (from its log) beside phase 9's; (c) FID, LPIPS, SSIM and
     MS-SSIM over phase 9's eval tree (imitators/ against gt/) with seeded
     random Inception and LPIPS weights, on the card and on the CPU, within
     the CPU tests' bounds, FID of gt/ against itself below 1e-3, and the
     decode, resize, Inception and LPIPS times per image;
 11. off the main path, each against the port's plain CPU path on the same
     inputs: (a) renderer.render_fim_wim, render_silhouettes and render_depth
     at 256 px and render_rgb at 512^2 (2x anti-aliasing) on the HOGAN
     tables and cameras, batch 4, textures of size 3, each from launch
     counters at 0 (one B2 call, bin_kernel + raster_kernel, and one B3
     finish gather per map), timed; card vs CPU end to end on the first
     samples (fim off on at most 1e-3 of the pixels, where the projection's
     planes tie to an ulp; wim and depth within 1e-5 where fim agrees) and
     strictly at the kernels' boundary, render_rgb's face corners on both
     sides (fim equal, wim and depth within 1e-6, RGB within 1e-5), and
     for every sample at 256^2 and 512^2 against the plain z-buffer and
     gather run on the card's own tensors (fim equal, wim and depth within
     1e-6), with the most faces one tile lists at 512^2 held to LIST_CAP;
     (b) the
     neural renderer's Renderer (look_at camera, 2x anti-aliasing): RGB
     with get_fim, silhouettes and depth, launches, times, card vs CPU on
     one sample; soft silhouettes forward and vertex gradient, time, peak
     memory, card vs CPU within 1e-6 and 1e-5 of the gradient's max; (c)
     the exact-gradient silhouettes, depth and RGB (backward_pixel_map,
     backward_depth_map, the texture gradient by autograd of the sampling):
     forward + backward time, peak memory and launches at 256 px (512^2
     rasters), vertex and texture gradients card vs CPU on one sample at 64
     px within 1e-5 of their max (RGB vertex gradient also rtol 1e-3), and
     the vertex and texture gradients bit-equal on a second run on the
     card; (d) block_extractor and local_attn_reshape at 32^2 x 512, kernel
     3, forward and gradients card vs CPU, and bit-equal on a second run;
     (e) compute_uv_image on the hand atlas at uv_size 224: the reference's
     2,000 Adam steps timed with the final loss, and 50 steps on the card
     (twice, bit-equal) and the CPU within 1e-4; (f) the
     resume from a JAX epoch: a full-width bf16 state after two steps (D
     gated on the second) laid out as a JAX run's trees, loaded into a
     fresh state by checkpoints.load_jax_state, weights, moments and Adam
     steps bit-equal (Adam's step on the device torch keeps it on), again
     after one Adam step of each on the same gradients, and one train step
     of each, whose mean |G difference| is at most twice the largest of
     three pairs of steps from the original state and two deep copies of
     it;
 12. the measuring tools: scripts/profile_step_torch.py as a subprocess
     (its own profiler session) for the fp32 batch-8 gather training step
     with the drivers' fp32 remat (full; 2 steps) and for the bf16 batch-4
     fused serving call (2 calls): device busy share, operator classes, top
     kernels, the 10 longest idle gaps and the peak memory from its JSON
     line, its launch counters per step or call (1 / 2 of B2 / B3, the
     step 9 of the edge-pad fold and of scatter_rows, and 9 of B4-fwd for
     the fused call) and, from its profile, bin_kernel and raster_kernel
     once and gather_kernel twice (the step also fold_kernel and
     scatter_rows' six kernels, SCATTER_FUNCTIONS, 9 times; the fused call also
     conv5_tc_kernel and fwd_pixel_kernel 9 times and slice_sum_kernel once
     per layer whose product splits), no other hand-written kernel;
     scripts/attn_ab_torch.py's `run` over the three layer shapes and three
     engines at 3 iterations, bf16 (the engines held to agree in f32); the
     FLOP walk (hoig_torch/utils/flops.py) against
     FlopCounterMode over one bf16 batch-4 shift serving call and training
     step within 0.1% for the aten part, the launch counters equal to the
     walk's; the FLOPs of each leg and the share of the bf16 peak that
     phases 5 and 7's medians imply;
 13. real-layout data without cv2 (hoig_torch/runtime's native reader):
     (a) the committed fixtures (tests/torch_fixtures/images) read and the
     data path's resizes made, each array held to the SHA-256 that cv2 gave
     when the fixture was made, with host ms per 640x480 JPEG (4:2:0; 4:4:4
     with restarts), mask PNG and resize; (b) an HO3Dv3 tree (2 videos x 4
     frames copied from the fixtures, masks at 320x240 and 640x480) beside
     a real-asset layout (synthetic MANO pickle, hand UV atlas, two
     objects, the second with the fixture texture_map.png), and
     train_torch.py --dataset_mode hov3 over it at full width (256 px,
     batch 4, bf16, seeded random VGG19 weights from an .npz) for 3 steps
     in a subprocess where cv2 cannot be imported: exit 0, the loader alone
     over 3 batches, 18 / 18 / 9 / 1 / 2 / 18 launches per step as in phase 7,
     finite errors, the textured object's table bit-equal to the fixture
     texture resized as cv2 does; loader, step and iteration ms beside
     phase 9's; (c) a DexYCB tree (2 nested videos, the 21 YCB objects, the
     second textured) and eval_torch.py --dataset_mode ycb over one batch
     of 4 pairs likewise: 18 / 1 / 2 launches, 12 PNGs of 256x256, the
     batch ms beside phase 9's;
 14. the benchmark: bench_torch.py as a subprocess in full mode with its
     default budget (train_bf16, gen_fwd, train_bf16_b8, train_bf16_dexycb,
     train_fp32 at 256 px, conv_dim 64, repeat 6; each leg its own process)
     and again with HOIG_BENCH_HEADLINE_ONLY=1 HOIG_BENCH_ENGINE=pallas
     (the fused engine's headline): both exit 0, the last stdout line is the
     headline JSON with a finite positive value; the details hold all five
     legs, none failed or skipped, torch's TF32 defaults; the b8 step
     within 2.2x of the b4 step (bench.py's b4-vs-b8 per-image flag is
     recorded and printed: the host-bound step takes about as long at b8 as
     at b4, which puts b8's per-image throughput at the flag's bound);
     every leg's share of its peak in (0, 1); each leg's launches per step
     or call equal the FLOP walk's (flops.kernel_launches plus B2 1, B3 2
     and a training step's edge-pad folds) and phases 5 / 6e / 7's counts
     (shift steps at b4 and b8 18 / 18 / 9 / 1 / 2 / 18, the serving call
     18 / 1 / 2, the fused step 9 of each B4 kernel and 1 / 2 / 9, the fp32
     gather step 1 / 2 / 9 / 9 scatter_rows); one line per leg
     (images/s, step ms, synchronized ms, share of peak, launches, peak
     MiB), the headline's step beside phase 7's with the same remat and
     gen_fwd's call beside phase 5's, as information;
 15. print the drivers line, the phase 10 line, the phase 11 line, the
     phase 12 line, the phase 13 line, the bench line, the kernels line, the
     card line and, last, the result line.

Details (result.json, profile.txt, build.txt: the compiler's report) go to
--out, by default build/chip_smoke/.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# source of each kernel and the TPU kernel it replaces
KERNELS = {
    "local_combine_tc": ("hoig_torch/csrc/local_combine.cu", "hoig_tpu/ops/local_combine.py:50"),
    "local_combine_bwd_src_tc": ("hoig_torch/csrc/local_combine.cu",
                                 "hoig_tpu/ops/local_combine.py:62"),
    "local_combine_bwd_v_tc": ("hoig_torch/csrc/local_combine.cu",
                               "hoig_tpu/ops/local_combine.py:80"),
    "rasterizer": ("hoig_torch/csrc/rasterizer.cu", "hoig_tpu/ops/rasterizer_pallas.py:45"),
    "table_gather": ("hoig_torch/csrc/table_gather.cu", "hoig_tpu/ops/table_gather.py:77"),
    "attn_fused_fwd_tc": ("hoig_torch/csrc/attn_fused.cu", "hoig_tpu/ops/attn_pallas.py:211"),
    "attn_fused_bwd_c": ("hoig_torch/csrc/attn_fused.cu", "hoig_tpu/ops/attn_pallas.py:628"),
    "attn_fused_bwd_a_gsrc_tc": ("hoig_torch/csrc/attn_fused.cu",
                                 "hoig_tpu/ops/attn_pallas.py:321"),
    "attn_fused_bwd_a_dw_tc": ("hoig_torch/csrc/attn_fused.cu",
                               "hoig_tpu/ops/attn_pallas.py:409"),
    # no TPU kernel: the backward of the JAX package's jnp.pad(mode="edge"),
    # which XLA transposes itself (the fc_0 target half's pad; the shift
    # engine's source pad at :213)
    "edge_pad_fold": ("hoig_torch/csrc/attn_fused.cu", "hoig_tpu/models/generator.py:139"),
    # no TPU kernel: the backward of the JAX package's jnp.take_along_axis
    # (the gather engine's corners), which XLA transposes itself
    "scatter_rows": ("hoig_torch/csrc/table_gather.cu", "hoig_tpu/models/generator.py:326"),
}
# the four B4 wrappers, and the counter each one's bf16 launch adds to: under
# bf16, B4-fwd's phase A, the gsrc projection and dW run on the tensor cores
FUSED = ("attn_fused_fwd", "attn_fused_bwd_c", "attn_fused_bwd_a_gsrc", "attn_fused_bwd_a_dw")
FUSED_BF16 = {"attn_fused_fwd": "attn_fused_fwd_tc", "attn_fused_bwd_c": "attn_fused_bwd_c",
              "attn_fused_bwd_a_gsrc": "attn_fused_bwd_a_gsrc_tc",
              "attn_fused_bwd_a_dw": "attn_fused_bwd_a_dw_tc"}
# launches per serving call, and per training step: each of the 9 attention
# layers combines twice forward; both calls need dsrc, only the second (whose
# coefficients come from the attention, not from the no-grad flow) needs dv.
# Under bf16 the forward and both backward kernels run on the tensor cores
# (counters *_tc). The rasterizer's wrapper counts one call (two kernels).
# The training step's backward folds the gradient of each edge-padded tensor
# of the attention once (edge_pad_fold): the fc_0 target half's of every
# layer, and the shift engine's padded source.
# InstanceNorm (hoig_torch/ops/instance_norm.py, flops.instance_norm_launches):
# each of G's 85 norms launches the statistics and the apply kernel; a
# training step adds D's 4 norms on the fake in G's loss and on the real and
# the fake in D's own step, and a backward of three kernels for each of the
# 97 (89 when D's gate is off: D's own step then runs without gradients);
# under remat the recompute applies the kept statistics of each norm it
# reaches again (NORMS_KEPT: the conv blocks' 37 with the bf16 remat
# defaults, remat_attn adding none; all 85 with full remat)
NORMS_PER_CALL = {"inorm_stats": 85, "inorm_apply": 85}
NORMS_PER_STEP = {"inorm_stats": 97, "inorm_apply": 97, "inorm_backward": 3 * 97}
NORMS_KEPT = {"bf16 remat defaults": 37, "full remat": 85}
# the validation forward (compute_losses): G, and D on the fake and the real
NORMS_PER_EVAL_FORWARD = {"inorm_stats": 93, "inorm_apply": 93}
NORM_BACKWARD_KERNELS = ("inorm_bwd_sums_kernel", "inorm_bwd_coef_kernel", "inorm_bwd_dx_kernel")
# The norms of one G forward at batch B, full width, 256 px: (batch as a
# multiple of B, C, H = W, affine, calls, of them recomputed under the bf16
# remat defaults); the background and object branches run at 2B. Then one D
# pass (parameter-free, batch B; three passes a step).
NORM_G_CALLS = [(1, 64, 256, True, 6, 6), (1, 128, 128, False, 2, 2), (1, 128, 128, True, 4, 4),
                (1, 256, 64, False, 2, 2), (1, 256, 64, True, 4, 4), (1, 512, 32, False, 14, 2),
                (1, 512, 32, True, 12, 0), (2, 64, 256, True, 5, 5), (2, 128, 128, False, 1, 1),
                (2, 128, 128, True, 4, 4), (2, 256, 64, False, 1, 1), (2, 256, 64, True, 4, 4),
                (2, 512, 32, False, 7, 1), (2, 512, 32, True, 19, 1)]
NORM_D_CALLS = [(1, 128, 64, False, 1, 0), (1, 256, 32, False, 1, 0), (1, 512, 16, False, 1, 0),
                (1, 512, 15, False, 1, 0)]
# the cells' batches (BENCHMARK.json: training at 32 in bf16 and f32, serving
# at 16 in bf16)
NORM_CELL_BATCHES = {"bfloat16": (32, 16), "float32": (32,)}
LAUNCHES_PER_CALL = {"local_combine_tc": 18, "rasterizer": 1, "table_gather": 2,
                     **NORMS_PER_CALL}
LAUNCHES_PER_STEP = {"local_combine_tc": 18, "local_combine_bwd_src_tc": 18,
                     "local_combine_bwd_v_tc": 9, "rasterizer": 1, "table_gather": 2,
                     "edge_pad_fold": 18, **NORMS_PER_STEP}


def with_kept(launches: dict, remat: str) -> dict:
    """A step's launches with the recompute's applies of `remat`'s kept
    statistics (NORMS_KEPT) added."""
    return dict(launches, inorm_apply=launches["inorm_apply"] + NORMS_KEPT[remat])


def gated(launches: dict) -> dict:
    """A step's launches with D's gate off: no backward (three kernels) for
    the norms of D's two passes in its own step."""
    return dict(launches, inorm_backward=launches["inorm_backward"] - 3 * 2 * len(NORM_D_CALLS))


# the shift step with the bf16 remat defaults (the drivers' under --bf16)
LAUNCHES_PER_STEP_REMAT = with_kept(LAUNCHES_PER_STEP, "bf16 remat defaults")
# the fused engine: one forward and one backward of each of the 9 layers
FUSED_LAUNCHES_PER_CALL = {"attn_fused_fwd_tc": 9, "rasterizer": 1, "table_gather": 2,
                           **NORMS_PER_CALL}
FUSED_LAUNCHES_PER_STEP = {**{k: 9 for k in FUSED_BF16.values()}, "rasterizer": 1,
                           "table_gather": 2, "edge_pad_fold": 9, **NORMS_PER_STEP}
# under remat_attn the backward recomputes each layer's forward
FUSED_LAUNCHES_PER_STEP_REMAT = with_kept(dict(FUSED_LAUNCHES_PER_STEP, attn_fused_fwd_tc=18),
                                          "bf16 remat defaults")
# the fp32 step as the drivers run it (TrainConfig(): f32, gather engine,
# full remat): no attention kernel; each layer's 36 corners are one row
# gather, whose backward is one scatter_rows launch
FP32_LAUNCHES_PER_STEP = with_kept({"rasterizer": 1, "table_gather": 2, "edge_pad_fold": 9,
                                    "scatter_rows": 9, **NORMS_PER_STEP}, "full remat")
IMAGE, BATCH = 256, 4
# the reference's own training batch (scripts/train_hov3_ddp.sh: 8 a card)
FP32_BATCH = 8
# B4 kernel vs plain version on the card. f32 inputs: within 1e-5 of the
# output's largest magnitude (only the order of the f32 sums differs).
# bf16 inputs: `out` and bwd-c's source gradient within one bf16 ulp (2^-7)
# of the largest magnitude (a last-bit difference of an f32 sum can move a
# bf16-rounded product or output by one ulp); the f32 residuals acc, attn
# and g_attn within 1e-4 of it (channel sums in another order); the gsrc
# projection, dG and dW within 1e-5, as in f32: the tensor-core forms of
# the projection and of dW take JAX's exact f32 products (dG split in three
# bf16 parts), so a dG rounded to bf16 (about 4e-3) fails.
TOL_F32 = 1e-5
TOL_BF16 = 2.0 ** -7
TOL_RESID = 1e-4
# InstanceNorm's kernels against their plain versions: each f32 result within
# 1e-6 of its largest entry (the sums in another order)
TOL_NORM = 1e-6


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int = 10, behind_sleep: bool = True) -> float:
    """Median device time of one call of fn, by CUDA events around each call.

    behind_sleep: queue the calls behind a GPU sleep that outlasts the host's
    work of enqueueing them (checked, and the sleep doubled until it does),
    so that the events time the device alone and not the host's launch gaps.
    The plain versions launch more kernels per call than the launch queue
    holds; they are timed without the sleep (their kernels are large enough
    at these shapes to keep the device busy)."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 10**8 if behind_sleep else 0
    while True:
        marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(reps)]
        slept = torch.cuda.Event()
        if cycles:
            torch.cuda._sleep(cycles)
        slept.record()
        for a, b in marks:
            a.record()
            fn()
            b.record()
        queued_in_time = not cycles or not slept.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return statistics.median(a.elapsed_time(b) for a, b in marks)
        check(cycles < 10**11, "could not queue the timed calls ahead of the device")
        cycles *= 2


class Recorder:
    """Wraps the kernel wrappers at their call sites and keeps their inputs."""

    def __init__(self):
        # "local_combine_tc": (src_pad, v, R) of each forward call;
        # "local_combine_backward": (src_pad, v, g, R, d_cols, need_src, need_v)
        # of each backward call, the inputs of the bwd_src and bwd_v kernels
        self.calls = {name: [] for name in (*KERNELS, *FUSED, "local_combine_backward")}

    def wrap(self, name, fn):
        def recorded(*args, **kwargs):
            self.calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return recorded


@contextlib.contextmanager
def recording(rec: Recorder):
    import hoig_torch.geometry.conditioning as cond
    import hoig_torch.geometry.renderer as rend
    import hoig_torch.models.generator as gen
    import hoig_torch.ops.attn_fused as af
    import hoig_torch.ops.local_combine as lc
    import hoig_torch.ops.rasterizer_cuda as rc
    import hoig_torch.ops.table_gather as tg

    sites = [(af, name, name) for name in (*FUSED, "edge_pad_fold")] + [
             (gen, "local_combine", "local_combine_tc"),
             (tg, "scatter_rows", "scatter_rows"),
             (lc, "local_combine_backward", "local_combine_backward"),
             (cond, "rasterize_fim_wim_auto", "rasterizer"),
             (rc, "gather_rows", "table_gather"),
             (rend, "gather_rows", "table_gather")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in sites]
    for mod, attr, name in sites:
        setattr(mod, attr, rec.wrap(name, getattr(mod, attr)))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def bound_ms(nbytes: float, flops: float, tc_flops: float = 0.0) -> tuple[float, str]:
    """The larger of bytes over the memory rate and operations over their
    peak: FP32 on the CUDA cores, and bf16 products (`tc_flops`) on the
    tensor cores (the H100 SXM data sheet's rates, hoig_torch/utils/flops.py)."""
    from hoig_torch.utils.flops import PEAK_BF16_TC_FLOPS, PEAK_BYTES_PER_S, PEAK_FP32_FLOPS

    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_FP32_FLOPS + tc_flops / PEAK_BF16_TC_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _fwd_close(out, ref, src, v, radius: int) -> tuple[bool, float, int]:
    """bf16 B1-fwd on the tensor cores forms the plain loop's exact bf16 x
    bf16 products but adds them in the tensor cores' order, in f32, and
    rounds once to bf16: within one bf16 ulp (2^-7 of the value) of the
    plain value, plus 1e-5 of the largest sum of |v| |src| over the offsets
    (the f32 sums' own difference, where the value is small). Returns (ok,
    max abs err, number of elements that differ)."""
    from hoig_torch.ops.local_combine import local_combine_reference

    mags = local_combine_reference(src.float().abs(), v.float().abs(), radius)
    err = (out.float() - ref.float()).abs()
    tol = 1e-5 * float(mags.max()) + 2.0 ** -7 * ref.float().abs()
    return bool((err <= tol).all()), float(err.max()), int((out != ref).sum())


def check_local_combine(calls) -> dict:
    """B1-fwd on the 18 recorded (src_pad, v, R) calls: bf16 as recorded
    through the tensor-core kernel (every call's window staged by TMA),
    within _fwd_close of the plain loop and bit-equal to itself on a second
    call; the same inputs cast to f32 through the FP32 kernel, which repeats
    the plain loop's order and rounding: bit-equal. Timed: the bf16 kernel
    (bound by bytes, or by its products at the tensor cores' rate), the FP32
    kernel on the f32 inputs (its own bound: FP32 operations), the plain
    version."""
    import torch

    from hoig_torch.ops.local_combine import fwd_staging, local_combine, local_combine_reference
    from hoig_torch.utils.flops import combine_flops

    rows = []
    tot = dict(ms=0.0, plain_ms=0.0, f32_ms=0.0, bytes=0.0, flops=0.0, err=0.0, differ=0,
               elements=0)
    for (src, v, radius), _ in calls:
        src, v = src.detach(), v.detach()
        check(src.dtype == torch.bfloat16, f"the serving path's combine is {src.dtype}, not bf16")
        staging = fwd_staging(src)
        check(staging == "tma", f"the combine at {tuple(src.shape)} took the {staging} staging")
        out = local_combine(src, v, radius)
        again = local_combine(src, v, radius)
        ref = local_combine_reference(src, v, radius)
        check(torch.equal(out, again), f"B1-fwd gave other bits on a second call at {tuple(src.shape)}")
        ok, e16, n_diff = _fwd_close(out, ref, src, v, radius)
        check(ok, f"B1-fwd bf16 disagrees at {tuple(src.shape)} R={radius}: max abs err {e16}")
        s32, v32 = src.float(), v.float()
        out32 = local_combine(s32, v32, radius)
        check(torch.equal(out32, local_combine_reference(s32, v32, radius)),
              f"B1-fwd f32 not bit-equal at {tuple(src.shape)} R={radius}")
        b, h, w, c = out.shape
        k2 = (2 * radius + 1) ** 2
        nbytes = (src.numel() + b * h * w * k2 + out.numel()) * src.element_size()
        flops = combine_flops(b, h, w, c, k2)
        ms = device_ms(lambda: local_combine(src, v, radius))
        f32_ms = device_ms(lambda: local_combine(s32, v32, radius))
        plain = device_ms(lambda: local_combine_reference(src, v, radius), reps=3,
                          behind_sleep=False)
        bnd, by = bound_ms(nbytes, 0.0, flops)
        f32_bnd, _ = bound_ms(nbytes * 2, flops)
        rows.append(dict(shape=list(src.shape), radius=radius, dtype=str(src.dtype), staging=staging,
                         ms=ms, f32_ms=f32_ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                         f32_bound_ms=f32_bnd, err_bf16=e16, differ=n_diff))
        for k, val in (("ms", ms), ("plain_ms", plain), ("f32_ms", f32_ms), ("bytes", nbytes),
                       ("flops", flops), ("differ", n_diff), ("elements", out.numel())):
            tot[k] += val
        tot["err"] = max(tot["err"], e16)
        del s32, v32, out32
    bnd, by = bound_ms(tot["bytes"], 0.0, tot["flops"])
    f32_bnd, f32_by = bound_ms(tot["bytes"] * 2, tot["flops"])
    log(f"  local_combine_tc (B1-fwd): {len(calls)} calls, staging "
        f"{sorted({r['staging'] for r in rows})}; kernel {tot['ms']:.4f} ms, FP32 path "
        f"{tot['f32_ms']:.4f} ms (bound {f32_bnd:.4f}, {f32_by}), plain {tot['plain_ms']:.2f} ms, "
        f"bound {bnd:.4f} ms ({by}; {tot['bytes'] / 1e6:.1f} MB, {tot['flops'] / 1e9:.2f} GFLOP bf16);"
        f" max abs err {tot['err']:.3g} (bf16 one ulp + 1e-5 of the largest sum of |v||src|; "
        f"{tot['differ']} of {tot['elements']} elements differ; f32 exact); a second call bit-equal")
    for r in rows:
        log(f"    {r['shape']} R={r['radius']}: kernel {r['ms']:.4f} ms (bound {r['bound_ms']:.4f}),"
            f" FP32 {r['f32_ms']:.4f}, plain {r['plain_ms']:.3f}, {r['differ']} differ")
    return dict(max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bnd,
                bound_by=by, library_ms=None, f32_ms=tot["f32_ms"], f32_bound_ms=f32_bnd,
                differ=tot["differ"], elements=tot["elements"], bytes=tot["bytes"],
                bf16_flop=tot["flops"], staging=[r["staging"] for r in rows], detail=rows)


def _dv_close(dv, ref, src, g, dtype_is_bf16: bool) -> tuple[bool, float]:
    """bwd_v sums each channel dot in its own order (FP32: ascending channels,
    fused multiply-adds; tensor cores: their order within each split of the
    channels, the splits added in order), the plain version in torch.sum's.
    f32: |err| <= 1e-5 of the largest |g[p]| * |src[q]| (the bound of any
    such dot). bf16: both round an f32 dot to bf16, so they differ by at
    most one bf16 ulp (2^-7 of the value) where the f32 sums straddle a
    rounding boundary."""
    scale = float(g.float().norm(dim=-1).max() * src.float().norm(dim=-1).max())
    err = (dv.float() - ref.float()).abs()
    tol = 1e-5 * scale + (2.0 ** -7 * ref.float().abs() if dtype_is_bf16 else 0.0)
    return bool((err <= tol).all()), float(err.max())


def _dsrc_close(ds, ref, v, g, radius: int) -> tuple[bool, float, int]:
    """bf16 bwd_src on the tensor cores forms the plain version's exact
    bf16 x bf16 products but adds them in the tensor cores' order, in f32,
    and rounds once to bf16: within one bf16 ulp (2^-7 of the value) of the
    plain value, plus 1e-5 of the largest sum of |v| |g| over the offsets
    (the f32 sums' own difference, where the value is small). Returns (ok,
    max abs err, number of elements that differ)."""
    from hoig_torch.ops.local_combine import local_combine_backward_reference

    mags, _ = local_combine_backward_reference(None, v.float().abs(), g.float().abs(), radius,
                                               True, False)
    err = (ds.float() - ref.float()).abs()
    tol = 1e-5 * float(mags.max()) + 2.0 ** -7 * ref.float().abs()
    return bool((err <= tol).all()), float(err.max()), int((ds != ref).sum())


def check_local_combine_backward(calls) -> dict:
    """B1-bwd-src and B1-bwd-v on every recorded backward call: bf16 as
    recorded, through the tensor-core kernels, each called twice and held
    bit-equal to itself, dsrc within _dsrc_close and dv within _dv_close of
    the plain versions (with the count of dsrc elements that differ); the
    same inputs in f32 through the FP32 kernels, dsrc bit-equal (they repeat
    the plain loop's order and rounding), dv within _dv_close. Timed: the
    bf16 kernels (bound by bytes, or by their products at the tensor cores'
    rate), their plain versions, and the FP32 kernels on the f32 inputs."""
    import torch

    from hoig_torch.ops.local_combine import (local_combine_backward,
                                              local_combine_backward_reference)
    from hoig_torch.utils.flops import combine_flops

    names = ("local_combine_bwd_src_tc", "local_combine_bwd_v_tc")
    tot = {n: dict(ms=0.0, plain_ms=0.0, f32_ms=0.0, bytes=0.0, flops=0.0, err=0.0, calls=0,
                   differ=0, elements=0) for n in names}
    rows = []
    for (src, v, g, radius, d_cols, need_src, need_v), _ in calls:
        src, v, g = (None if t is None else t.detach() for t in (src, v, g.contiguous()))
        check(g.dtype == torch.bfloat16, f"the training step's backward is {g.dtype}, not bf16")
        b, h, w, c = g.shape
        k2 = (2 * radius + 1) ** 2
        flops = combine_flops(b, h, w, c, k2)
        row = dict(shape=[b, h, w, c], radius=radius, dtype=str(g.dtype))
        for cast in (lambda t: t, lambda t: None if t is None else t.float()):
            s_, v_, g_ = cast(src), cast(v), cast(g)
            lowp = g_.dtype == torch.bfloat16
            ds, dv = local_combine_backward(s_, v_, g_, radius, d_cols, need_src, need_v)
            rs, rv = local_combine_backward_reference(s_, v_, g_, radius, need_src, need_v)
            tag = str(g_.dtype)
            if lowp:
                ds2, dv2 = local_combine_backward(s_, v_, g_, radius, d_cols, need_src, need_v)
                check(all(x is None or torch.equal(x, y) for x, y in ((ds, ds2), (dv, dv2))),
                      f"the tensor-core backward gave other bits on a second call at {row}")
            if need_src:
                if lowp:
                    ok, e, n_diff = _dsrc_close(ds, rs, v_, g_, radius)
                    check(ok, f"bwd_src_tc disagrees at {row}: max abs err {e}")
                    t = tot[names[0]]
                    t["err"] = max(t["err"], e)
                    t["differ"] += n_diff
                    t["elements"] += ds.numel()
                    row.update(src_err=e, src_differ=n_diff)
                else:
                    check(torch.equal(ds, rs), f"bwd_src {tag} differs at {row}: {max_err(ds, rs)}")
            if need_v:
                check(not dv[..., k2:].any(), f"bwd_v {tag}: columns past K^2 not zero at {row}")
                ok, e = _dv_close(dv[..., :k2], rv, s_, g_, lowp)
                check(ok, f"bwd_v {tag} disagrees at {row}: max abs err {e}")
                tot[names[1]]["err"] = max(tot[names[1]]["err"], e)
        es = g.element_size()
        g32 = g.float()
        if need_src:
            t = tot[names[0]]
            v32 = v.float()
            ms = device_ms(lambda: local_combine_backward(None, v, g, radius, d_cols, True, False))
            f32_ms = device_ms(lambda: local_combine_backward(None, v32, g32, radius, d_cols, True,
                                                              False))
            plain = device_ms(lambda: local_combine_backward_reference(None, v, g, radius, True, False),
                              reps=2, behind_sleep=False)
            nbytes = (g.numel() + b * h * w * k2 + b * (h + 2 * radius) * (w + 2 * radius) * c) * es
            bnd, by = bound_ms(nbytes, 0.0, flops)
            row.update(src_ms=ms, src_plain_ms=plain, src_f32_ms=f32_ms, src_bound_ms=bnd,
                       src_bound_by=by)
            for k_, val in (("ms", ms), ("plain_ms", plain), ("f32_ms", f32_ms), ("bytes", nbytes),
                            ("flops", flops), ("calls", 1)):
                t[k_] += val
            del v32
        if need_v:
            t = tot[names[1]]
            s32 = src.float()
            ms = device_ms(lambda: local_combine_backward(src, None, g, radius, d_cols, False, True))
            f32_ms = device_ms(lambda: local_combine_backward(s32, None, g32, radius, d_cols, False,
                                                              True))
            plain = device_ms(lambda: local_combine_backward_reference(src, None, g, radius, False, True),
                              reps=2, behind_sleep=False)
            nbytes = (src.numel() + g.numel() + b * h * w * d_cols) * es
            bnd, by = bound_ms(nbytes, 0.0, flops)
            row.update(v_ms=ms, v_plain_ms=plain, v_f32_ms=f32_ms, v_bound_ms=bnd, v_bound_by=by)
            for k_, val in (("ms", ms), ("plain_ms", plain), ("f32_ms", f32_ms), ("bytes", nbytes),
                            ("flops", flops), ("calls", 1)):
                t[k_] += val
            del s32
        rows.append(row)
    out = {}
    for n in names:
        t = tot[n]
        bnd, by = bound_ms(t["bytes"], 0.0, t["flops"])
        f32_bnd, _ = bound_ms(t["bytes"] * 2, t["flops"])
        out[n] = dict(max_abs_err=t["err"], ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bnd,
                      bound_by=by, library_ms=None, f32_ms=t["f32_ms"], f32_bound_ms=f32_bnd,
                      calls=t["calls"], detail=rows)
        if n == names[0]:
            out[n].update(differ=t["differ"], elements=t["elements"])
        log(f"  {n}: {t['calls']} calls; kernel {t['ms']:.4f} ms, FP32 path {t['f32_ms']:.4f} ms, "
            f"plain {t['plain_ms']:.2f} ms, bound {bnd:.4f} ms ({by}); max abs err {t['err']:.3g}"
            + (f" (bf16 one ulp + 1e-5 of the largest sum of |v||g|; {t['differ']} of "
               f"{t['elements']} elements differ; f32 exact)" if n == names[0] else
               " (f32 tol 1e-5 |g||src|, bf16 one ulp)"))
    for r in rows:
        log(f"    {r['shape']} R={r['radius']}: bwd_src {r['src_ms']:.4f} ms (bound "
            f"{r['src_bound_ms']:.4f}, FP32 {r['src_f32_ms']:.4f})"
            + (f", bwd_v {r['v_ms']:.4f} ms (bound {r['v_bound_ms']:.4f}, FP32 {r['v_f32_ms']:.4f})"
               if "v_ms" in r else ", dv not needed"))
    return out


def _bbox_pairs(bbox, s: int) -> float:
    """(pixel, face) pairs whose pixel centre lies in the face's box: the
    candidate tests this scene needs."""
    import torch

    lo = torch.ceil((bbox[..., 0::2] * s + s - 1) / 2).clamp(0, s)
    hi = torch.floor((bbox[..., 1::2] * s + s - 1) / 2).clamp(-1, s - 1)
    n = (hi - lo + 1).clamp_min(0)
    return float((n[..., 0] * n[..., 1]).sum())


def _tile_lists(bbox, edge, s: int, tile: int):
    """(B, F, T, T) masks of the rasterizer's tile lists: `boxed`, each face
    at every 8x8 tile its box meets (the tile's outer pixel centres padded
    by one pixel pitch), and `keep`, of those the pairs bin_kernel keeps:
    none of the face's edge functions below its rounding margin at all
    four corner pixel centres of the tile."""
    import torch

    t = torch.arange(-(-s // tile), device=bbox.device, dtype=torch.float32)
    c0 = (2.0 * (t * tile) + 1.0 - s) / s
    c1 = (2.0 * (t * tile + tile - 1) + 1.0 - s) / s
    pitch = torch.tensor(2.0, device=bbox.device) / s
    mx = (bbox[..., 0, None] <= c1 + pitch) & (bbox[..., 1, None] >= c0 - pitch)
    my = (bbox[..., 2, None] <= c1 + pitch) & (bbox[..., 3, None] >= c0 - pitch)
    boxed = my[..., :, None] & mx[..., None, :]  # (B, F, T, T)
    big = torch.maximum(c0.abs(), c1.abs())
    keep = boxed.clone()
    for k in range(3):
        a, b, c = (edge[..., k, j, None, None].float() for j in range(3))
        top = torch.full(boxed.shape, float("-inf"), device=bbox.device)
        for cx in (c0, c1):
            for cy in (c0, c1):
                top = torch.maximum(top, (cx * a + cy[:, None] * b) + c)
        keep &= ~(top < -(16.0 * 5.9604645e-8) * ((a.abs() * big + b.abs() * big[:, None]) + c.abs()))
    return boxed, keep


def _listed_pairs(bbox, edge, s: int, tile: int) -> tuple[float, float]:
    """(pixel, face) pairs of the tiles the boxes meet, and of those in the
    tile lists (see _tile_lists): each face at the 64 pixels of a tile."""
    boxed, keep = _tile_lists(bbox, edge, s, tile)
    n = tile * tile
    return float(boxed.sum()) * n, float(keep.sum()) * n


def check_rasterizer(calls) -> dict:
    """B2 on the recorded 2B x 256^2 scene: the z-buffer kernels (binning
    into per-tile face lists, then the z-buffer over them) against the plain
    chunked reduction (indices equal), and the whole fim/wim/rows entry
    against the plain rasterizer (fim and rows equal, wim atol 1e-4)."""
    import torch

    from hoig_torch.ops.rasterizer import _face_setup, rasterize_fim_wim, zbuffer_reference
    from hoig_torch.ops.rasterizer_cuda import (TILE, face_bbox, rasterize_fim_wim_auto,
                                                rasterize_zbuffer)

    (fv, valid), kw = calls[0]
    s, near, far, attrs = kw["image_size"], kw["near"], kw["far"], kw["attrs"]
    setup = _face_setup(fv, valid, s)
    bbox = face_bbox(fv, setup["keep"])
    idx = rasterize_zbuffer(setup, bbox, s, near, far)
    idx_ref = zbuffer_reference(setup, s, near, far)
    n_diff = int((idx != idx_ref).sum())
    check(n_diff == 0, f"rasterizer z-buffer disagrees on {n_diff} pixels")
    fim, wim, rows = rasterize_fim_wim_auto(fv, valid, image_size=s, near=near, far=far, attrs=attrs)
    fim_r, wim_r, rows_r = rasterize_fim_wim(fv, valid, image_size=s, near=near, far=far, attrs=attrs)
    check(torch.equal(fim, fim_r) and torch.equal(rows, rows_r), "rasterizer fim/rows disagree")
    e_wim = max_err(wim, wim_r)
    check(e_wim <= 1e-4, f"rasterizer wim disagrees: {e_wim}")
    hits = int((fim >= 0).sum())
    b, f = valid.shape
    nbytes = b * f * 16 * 4 + b * s * s * 4
    pairs = _bbox_pairs(bbox, s)
    boxed, listed = _listed_pairs(bbox, setup["edge"], s, TILE)
    flops = pairs * 16  # 3 edge planes + 1 depth plane, 2 mul + 2 add each
    ms = device_ms(lambda: rasterize_zbuffer(setup, bbox, s, near, far))
    plain = device_ms(lambda: zbuffer_reference(setup, s, near, far), reps=3, behind_sleep=False)
    bnd, by = bound_ms(nbytes, flops)
    again = rasterize_zbuffer(setup, bbox, s, near, far)
    check(torch.equal(idx, again), "rasterizer gave other indices on a second call")
    log(f"  rasterizer: faces {tuple(valid.shape)}, {s}^2, hit pixels {hits}, box pairs {pairs:.4g},"
        f" pairs of the tiles the boxes meet {boxed:.4g}, of those the lists keep {listed:.4g},"
        f" idx diffs 0 (and 0 on a second call), wim err {e_wim:.3g}; kernels {ms:.4f} ms, plain "
        f"{plain:.3f} ms, bound {bnd:.5f} ms ({by})")
    return dict(max_abs_err=e_wim, ms=ms, plain_ms=plain, bound_ms=bnd, bound_by=by,
                library_ms=None, detail=dict(hits=hits, box_pairs=pairs, tile_box_pairs=boxed,
                                                     listed_pairs=listed))


def tie_scene(gen, b: int, f: int, copies: int):
    """(B, F, 3, 3) faces with exact ties, all valid: `copies` copies of one
    large triangle at random indices, half of the rest overlapping
    triangles of one fronto-parallel plane (z = 2, the large one's too), a
    quarter of those repeated at other indices, the rest random."""
    import torch

    fv = torch.randn(b, f, 3, 3, device="cuda", generator=gen) * 0.4
    fv[..., 2] = fv[..., 2].abs() + 1.5
    big = torch.tensor([[-0.9, -0.8, 2.0], [0.85, -0.7, 2.0], [0.1, 0.95, 2.0]], device="cuda")
    corner = torch.tensor([[0.0, 0.0], [0.5, 0.05], [0.1, 0.45]], device="cuda")
    for bi in range(b):
        idx = torch.randperm(f, device="cuda", generator=gen)
        fv[bi, idx[:copies]] = big
        flat = idx[copies:copies + (f - copies) // 2]
        fv[bi, flat, :, :2] = (torch.rand(len(flat), 1, 2, device="cuda", generator=gen) * 1.6 - 0.8
                               + corner)
        fv[bi, flat, :, 2] = 2.0
        rep = idx[copies + (f - copies) // 2:][:len(flat) // 4]
        fv[bi, rep] = fv[bi, flat[:len(rep)]]
    return fv, torch.ones(b, f, dtype=torch.bool, device="cuda")


def check_rasterizer_ties() -> dict:
    """B2 where the winner rule is put to the test: exact ties in inverse
    depth (duplicated faces, faces of one plane), whose lowest index must
    win whatever the order of a tile's list. Two scenes: 2 x 300 faces at
    100 px (lists that hold every face), and 2 x 1200 faces with 1100
    copies of one triangle at 128 px (every tile under it counts more than
    the lists' capacity and walks all faces). Indices bit-equal to the
    plain z-buffer, also on a second call; fim equal and wim within 1e-4
    of the plain rasterizer."""
    import torch

    from hoig_torch.ops.rasterizer import _face_setup, rasterize_fim_wim, zbuffer_reference
    from hoig_torch.ops.rasterizer_cuda import (LIST_CAP, face_bbox, rasterize_fim_wim_auto,
                                                rasterize_zbuffer)

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for b, f, copies, s in ((2, 300, 40, 100), (2, 1200, 1100, 128)):
        fv, valid = tie_scene(gen, b, f, copies)
        setup = _face_setup(fv, valid, s)
        bbox = face_bbox(fv, setup["keep"])
        ref = zbuffer_reference(setup, s, 0.1, 100.0)
        got = rasterize_zbuffer(setup, bbox, s, 0.1, 100.0)
        again = rasterize_zbuffer(setup, bbox, s, 0.1, 100.0)
        n_diff = int((got != ref).sum())
        check(n_diff == 0 and torch.equal(got, again),
              f"rasterizer tie scene {(b, f, copies, s)}: {n_diff} pixels differ from the plain "
              f"z-buffer, second call equal {torch.equal(got, again)}")
        # pixels won by a face that has an exact copy elsewhere: there the
        # lowest index of the copies had to win
        won = ref.long().clamp_min(0)
        twins = ((fv[torch.arange(b, device="cuda")[:, None], won][:, :, None] == fv[:, None])
                 .flatten(3).all(-1).sum(-1) > 1) & (ref >= 0)
        fim, wim = rasterize_fim_wim_auto(fv, valid, image_size=s)
        fim_r, wim_r = rasterize_fim_wim(fv, valid, image_size=s)
        check(torch.equal(fim, fim_r) and max_err(wim, wim_r) <= 1e-4,
              f"rasterizer tie scene {(b, f, copies, s)}: fim/wim differ from the plain rasterizer")
        key = f"{b}x{f} faces, {copies} copies, {s} px"
        out[key] = dict(hit=int((ref >= 0).sum()), tied=int(twins.sum()),
                        overflow=copies > min(f, LIST_CAP))
    log("  rasterizer tie scenes: " + "; ".join(
        f"{k}: {v['hit']} hit pixels, {v['tied']} won by a face with an exact copy"
        + (" (lists over capacity: tiles walk all faces)" if v["overflow"] else "")
        for k, v in out.items()) + "; indices bit-equal to the plain z-buffer, twice")
    return out


def check_table_gather(calls) -> dict:
    """B3 on the two recorded calls: bit-equal to take_along_dim."""
    import torch

    from hoig_torch.ops.table_gather import gather_rows, gather_rows_reference

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0)
    for (table, idx), _ in calls:
        out = gather_rows(table, idx)
        check(torch.equal(out, gather_rows_reference(table, idx)), "table_gather not bit-equal")
        idx64 = idx.long()[..., None]
        b, r, a = table.shape
        p = idx.shape[1]
        tot["bytes"] += b * p * 4 + table.numel() * 4 + b * a * p * 4
        tot["ms"] += device_ms(lambda: gather_rows(table, idx))
        tot["plain_ms"] += device_ms(lambda: gather_rows_reference(table, idx).contiguous())
        tot["library_ms"] += device_ms(lambda: torch.take_along_dim(table, idx64, dim=1))
        log(f"    table {tuple(table.shape)}, idx {tuple(idx.shape)}")
    bnd, by = bound_ms(tot["bytes"], 0.0)
    log(f"  table_gather: {len(calls)} calls bit-equal; kernel {tot['ms']:.4f} ms, plain "
        f"{tot['plain_ms']:.4f} ms, take_along_dim {tot['library_ms']:.4f} ms, bound {bnd:.4f} ms")
    return dict(max_abs_err=0.0, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bnd,
                bound_by=by, library_ms=tot["library_ms"], library="torch.take_along_dim")


# the edge-pad fold off the main path's shapes, at both pads: ragged frames,
# channel counts that are odd or not multiples of 8, H or W equal to 1 (one
# pixel collects both margins of an axis)
EDGE_FRAMES = ((2, 13, 11, 6), (1, 9, 20, 71), (2, 1, 13, 18), (1, 9, 1, 3), (3, 1, 1, 130))
# the main path's frames (128², 64², 32² at batch 4) with C not a multiple of
# 8, which fold_kernel takes on its scalar path
EDGE_SCALAR_FRAMES = ((4, 128, 128, 130), (4, 64, 64, 250), (4, 32, 32, 516))


def check_edge_pad_fold(calls) -> dict:
    """The edge-pad fold on the training step's recorded gradients (the
    attention's padded tensors), then on EDGE_FRAMES and EDGE_SCALAR_FRAMES
    in f32 and bf16 with pads 2 and 5, each also one element off 16-byte
    alignment: bit-equal to its plain version (the f32 fold rounded once)
    and to itself on a second call; timed beside the plain version and
    aten's replication_pad2d_backward (float atomics) on the same gradient."""
    import torch

    from hoig_torch.ops.attn_fused import edge_pad_fold, edge_pad_fold_reference

    def held(gpad, p, where):
        out = edge_pad_fold(gpad, p)
        check(torch.equal(out, edge_pad_fold_reference(gpad, p)),
              f"edge_pad_fold is not bit-equal to its plain version at {where}")
        check(torch.equal(out, edge_pad_fold(gpad, p)),
              f"edge_pad_fold gave other bits on a second call at {where}")
        return out

    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, adds=0.0)
    shapes = {}
    for (gpad, p), _ in calls:
        out = held(gpad, p, f"{tuple(gpad.shape)} pad {p}")
        b, h, w, c = out.shape
        image = torch.empty((b, c, h, w), dtype=gpad.dtype, device=gpad.device)
        grad_nchw = gpad.permute(0, 3, 1, 2)
        tot["bytes"] += (gpad.numel() + out.numel()) * gpad.element_size()
        tot["adds"] += gpad.numel() - out.numel()
        tot["ms"] += device_ms(lambda: edge_pad_fold(gpad, p))
        tot["plain_ms"] += device_ms(lambda: edge_pad_fold_reference(gpad, p), behind_sleep=False)
        tot["library_ms"] += device_ms(lambda: torch.ops.aten.replication_pad2d_backward(
            grad_nchw, image, [p, p, p, p]))
        key = f"{tuple(gpad.shape)} pad {p} {str(gpad.dtype).replace('torch.', '')}"
        shapes[key] = shapes.get(key, 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(16)
    for b, h, w, c in EDGE_FRAMES + EDGE_SCALAR_FRAMES:
        for dtype in (torch.float32, torch.bfloat16):
            for p in (2, 5):
                gpad = torch.randn(b, h + 2 * p, w + 2 * p, c, device="cuda", generator=gen)
                held(gpad.to(dtype), p, f"{(b, h, w, c)} pad {p} {dtype}")
                # the frame one element off 16-byte alignment (the scalar path)
                flat = torch.randn(1 + gpad.numel(), device="cuda", generator=gen).to(dtype)
                held(flat[1:].view(gpad.shape), p, f"{(b, h, w, c)} pad {p} {dtype}, unaligned")
    bnd, by = bound_ms(tot["bytes"], tot["adds"])
    log(f"  edge_pad_fold: {len(calls)} recorded gradients ("
        + ", ".join(f"{k} x{n}" for k, n in shapes.items()) + f") and {len(EDGE_FRAMES)} ragged "
        f"frames and {len(EDGE_SCALAR_FRAMES)} main-path frames with C not a multiple of 8, at "
        f"pads 2 and 5, f32 and bf16, aligned and one element off: bit-equal to the plain "
        f"version and to itself; "
        f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, replication_pad2d_backward "
        f"{tot['library_ms']:.4f} ms, bound {bnd:.4f} ms ({by}) over the {len(calls)}")
    return dict(max_abs_err=0.0, ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bnd,
                bound_by=by, library_ms=tot["library_ms"],
                library="torch.ops.aten.replication_pad2d_backward", functions=["fold_kernel"])


def _gather_backward_before(val, idx, n: int):
    """What scatter_rows replaced on the gather engine's step: each of a
    layer's 36 corners gathered twice by torch.gather, whose backward is a
    zero-filled source-sized gradient and a scatter_add_ (float atomics)
    each, added up by autograd: 72 of each a layer, on the same gradients."""
    import torch

    e, c = val.shape[1], val.shape[2]
    g, i = val.reshape(e // n, n, c), idx.reshape(e // n, n)
    total = None
    for j in range(e // n):
        ij = i[j][None, :, None].expand(1, n, c)
        for _ in range(2):
            part = torch.zeros((1, n, c), dtype=val.dtype, device=val.device).scatter_add_(
                1, ij, g[j][None])
            total = part if total is None else total + part
    return total


# scatter_rows' kernel functions (hoig_torch/csrc/table_gather.cu), one
# launch each per call: the order (count, tiled scan, the tiles' totals,
# placement, the long segments' sort) and the sum
SCATTER_FUNCTIONS = ("row_count_kernel", "row_scan_kernel", "row_scan_totals_kernel",
                     "row_place_kernel", "segment_sort_kernel", "scatter_rows_kernel")


def check_scatter_rows(calls) -> dict:
    """scatter_rows on the fp32 step's recorded (gradient, indices, rows) of
    the 9 attention layers: bit-equal to its plain version and to itself on
    a second call; timed whole and as its two stages apart (the order built
    on the card; the sum in it) beside the plain version, one index_add_
    over the same entries (float atomics) and the 72 gathers' backward that
    it replaced (_gather_backward_before), which is also run twice on the
    same inputs and the elements that differ counted."""
    import torch

    from hoig_torch.ops import table_gather as tg
    from hoig_torch.ops.table_gather import scatter_rows, scatter_rows_reference

    tot = dict(ms=0.0, order_ms=0.0, sum_ms=0.0, plain_ms=0.0, library_ms=0.0, replaced_ms=0.0,
               bytes=0.0)
    shapes = {}
    # what the replaced backward does on the same inputs twice (information:
    # float atomics need not differ on every call)
    moved = dict(elements=0, of=0, layers=0)
    segments = dict(longest=0, over_128=0)
    for (val, idx, n), _ in calls:
        b, e, c = val.shape
        what = f"{tuple(val.shape)} into {n} rows"
        before = _gather_backward_before(val, idx, n)
        diff = int((before != _gather_backward_before(val, idx, n)).sum())
        moved["elements"] += diff
        moved["of"] += before.numel()
        moved["layers"] += diff > 0
        del before
        check(b == 1 and e % n == 0, f"scatter_rows: recorded {what}")
        lens = torch.bincount(idx.reshape(-1), minlength=n)
        segments["longest"] = max(segments["longest"], int(lens.max()))
        segments["over_128"] += int((lens > 128).sum())
        out = scatter_rows(val, idx, n)
        check(torch.equal(out, scatter_rows_reference(val, idx, n)),
              f"scatter_rows is not bit-equal to its plain version at {what}")
        check(torch.equal(out, scatter_rows(val, idx, n)),
              f"scatter_rows gave other bits on a second call at {what}")
        # the two stages apart, on one scratch: the order, then the sum in it
        part = torch.empty_like(out)
        scratch = tg.scatter_rows_stages(val, idx, n, part, None, tg.ORDER)
        tg.scatter_rows_stages(val, idx, n, part, scratch, tg.SUM)
        check(torch.equal(part, out), f"scatter_rows' stages apart gave other bits at {what}")
        rows = idx.reshape(-1)
        flat = val.reshape(-1, c)
        tot["bytes"] += (val.numel() + out.numel()) * val.element_size() + idx.numel() * 8
        tot["ms"] += device_ms(lambda: scatter_rows(val, idx, n))
        tot["order_ms"] += device_ms(
            lambda: tg.scatter_rows_stages(val, idx, n, part, scratch, tg.ORDER))
        tot["sum_ms"] += device_ms(
            lambda: tg.scatter_rows_stages(val, idx, n, part, scratch, tg.SUM))
        tot["plain_ms"] += device_ms(lambda: scatter_rows_reference(val, idx, n), reps=3,
                                     behind_sleep=False)
        tot["library_ms"] += device_ms(lambda: torch.zeros(
            (n, c), dtype=val.dtype, device=val.device).index_add_(0, rows, flat))
        tot["replaced_ms"] += device_ms(lambda: _gather_backward_before(val, idx, n), reps=3,
                                        behind_sleep=False)
        del part, scratch
        key = f"{e // n} x {n} x {c}"
        shapes[key] = shapes.get(key, 0) + 1
    bnd, by = bound_ms(tot["bytes"], 0.0)
    log(f"  scatter_rows: {len(calls)} recorded layers (corners x rows x channels: "
        + ", ".join(f"{k} x{v}" for k, v in shapes.items()) + f"; longest segment "
        f"{segments['longest']}, {segments['over_128']} rows over 128) bit-equal to the plain "
        f"version and to itself, and as its two stages apart; kernels {tot['ms']:.4f} ms (the "
        f"order {tot['order_ms']:.4f}, the sum {tot['sum_ms']:.4f}), plain {tot['plain_ms']:.4f} "
        f"ms, index_add_ {tot['library_ms']:.4f} ms, torch.gather's backward as the step ran it "
        f"before (72 a layer) {tot['replaced_ms']:.4f} ms, bound {bnd:.4f} ms ({by}; "
        f"{tot['bytes'] / 1e9:.3f} GB); that backward called twice on the same inputs: "
        f"{moved['elements']} of {moved['of']} elements differ, in {moved['layers']} of "
        f"{len(calls)} layers")
    return dict(max_abs_err=0.0, ms=tot["ms"], order_ms=tot["order_ms"], sum_ms=tot["sum_ms"],
                plain_ms=tot["plain_ms"], bound_ms=bnd, bound_by=by,
                library_ms=tot["library_ms"], library="torch.Tensor.index_add_",
                replaced_ms=tot["replaced_ms"],
                replaced="torch.gather's backward, 72 a layer (zeros + scatter_add_ + add)",
                replaced_repeat_differs=moved, segments=segments,
                functions=list(SCATTER_FUNCTIONS))


# scatter_rows off the main path's shapes: (B, E, C, rows), odd and narrow
# channel counts (the texture sampler's 3, the depth backward's 9), more
# entries than rows and fewer
SCATTER_SHAPES = ((2, 300, 1, 40), (1, 257, 3, 500), (3, 1000, 7, 11), (2, 999, 9, 64),
                  (1, 4000, 128, 300), (2, 513, 130, 97), (1, 64, 512, 5))


def clamped_corners(b: int, h: int, w: int, reach: float, gen):
    """(1, 36 * b * h * w) int64: the gather engine's 36 border-clamped
    corners (corner-major) of a batch-flattened (b, h, w) source under a
    random flow of up to `reach` pixels, on the card."""
    import torch

    fy = torch.arange(h, device="cuda")[:, None] + (torch.rand(
        b, h, w, device="cuda", generator=gen) * 2 - 1) * reach
    fx = torch.arange(w, device="cuda")[None, :] + (torch.rand(
        b, h, w, device="cuda", generator=gen) * 2 - 1) * reach
    y0, x0 = fy.floor().long(), fx.floor().long()
    base = (torch.arange(b, device="cuda") * h * w)[:, None, None]
    return torch.stack([base + (y0 + dy).clamp(0, h - 1) * w + (x0 + dx).clamp(0, w - 1)
                        for dy in range(-2, 4) for dx in range(-2, 4)]).reshape(1, -1)


def check_scatter_ragged() -> dict:
    """scatter_rows on SCATTER_SHAPES with indices outside [0, rows) mixed
    in, f32 and bf16, and on edge cases (every entry on one row, no entry at
    all, 100,000 entries on one row, a gather layer whose border corners
    clamp onto the edge rows, a base two bytes off 16-byte alignment, the
    pinned order [1e8, 1, -1e8] whose f32 sum is exactly 0): bit-equal to
    the plain version and to itself; the scratch's size as table_gather.cu
    counts it; GatherRows' forward bit-equal to torch.gather and its
    backward one scatter_rows launch."""
    import ctypes

    import torch

    from hoig_torch.ops import _cuda
    from hoig_torch.ops import table_gather as tg
    from hoig_torch.ops.table_gather import (gather_rows_nhwc, scatter_rows,
                                             scatter_rows_reference)

    gen = torch.Generator(device="cuda").manual_seed(17)

    def held(val, idx, n, what):
        out = scatter_rows(val, idx, n)
        check(torch.equal(out, scatter_rows_reference(val, idx, n)),
              f"scatter_rows is not bit-equal to its plain version at {what}")
        check(torch.equal(out, scatter_rows(val, idx, n)),
              f"scatter_rows gave other bits on a second call at {what}")
        return out

    for b, e, c, n in SCATTER_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            val = torch.randn(b, e, c, device="cuda", generator=gen).to(dtype)
            idx = torch.randint(-2, n + 2, (b, e), device="cuda", generator=gen)
            held(val, idx, n, f"{(b, e, c, n)} {dtype}")
    val = torch.randn(1, 5000, 9, device="cuda", generator=gen)
    one = held(val, torch.full((1, 5000), 3, device="cuda"), 7, "every entry on one row")
    check(not one[:, :3].any() and not one[:, 4:].any(), "scatter_rows filled an empty row")
    none = held(val[:, :0], torch.zeros((1, 0), dtype=torch.long, device="cuda"), 7, "no entry")
    check(not none.any(), "scatter_rows without entries is not 0")
    flat = torch.randn(1 + 2 * 300 * 16, device="cuda", generator=gen).bfloat16()
    held(flat[1:].view(2, 300, 16), torch.randint(0, 50, (2, 300), device="cuda", generator=gen),
         50, "a bf16 base 2 bytes off alignment")
    # long segments: 100,000 entries on one row among short ones (the order's
    # chunked network in device memory; the plain version runs on the CPU,
    # where its loop over 100,000 segment positions takes seconds, not a
    # minute), and a gather-engine layer whose flow clamps most border
    # corners onto the edge rows (segments of hundreds to thousands)
    idx = torch.randint(0, 64, (1, 110_000), device="cuda", generator=gen)
    idx[:, 5_000:105_000] = 17
    val = torch.randn(1, 110_000, 4, device="cuda", generator=gen)
    out = scatter_rows(val, idx, 64)
    check(torch.equal(out.cpu(), scatter_rows_reference(val.cpu(), idx.cpu(), 64)),
          "scatter_rows is not bit-equal to its plain version with 100,000 entries on one row")
    check(torch.equal(out, scatter_rows(val, idx, 64)),
          "scatter_rows gave other bits on a second call with 100,000 entries on one row")
    clamped = clamped_corners(2, 64, 64, 12.0, gen)
    longest = int(torch.bincount(clamped.reshape(-1)).max())
    for c, dtype in ((256, torch.float32), (256, torch.bfloat16), (7, torch.float32)):
        val = torch.randn(1, clamped.shape[1], c, device="cuda", generator=gen).to(dtype)
        held(val, clamped, 2 * 64 * 64, f"a clamped 2 x 64 x 64 layer, C {c} {dtype}")
    lib = _cuda.kernel("table_gather", "hoig_scatter_rows_scratch", [ctypes.c_longlong] * 2)
    lib.restype = ctypes.c_longlong
    for rows, entries in ((1, 0), (4095, 7), (4096, 1), (131_072, 4_718_592), (2**30, 2**31 - 1)):
        check(lib(rows, entries) == tg.scatter_scratch_ints(rows, entries),
              f"table_gather.cu's scratch for {rows} rows, {entries} entries is not "
              "scatter_scratch_ints'")
    pinned = torch.tensor([[[1e8], [1.0], [-1e8]]], device="cuda")
    check(float(held(pinned, torch.zeros((1, 3), dtype=torch.long, device="cuda"), 1,
                     "the pinned order").item()) == 0.0, "scatter_rows added [1e8, 1, -1e8] "
          "in another order")
    src = torch.randn(2, 50, 9, device="cuda", generator=gen).requires_grad_()
    idx = torch.randint(0, 50, (2, 400), device="cuda", generator=gen)
    out = gather_rows_nhwc(src, idx)
    check(torch.equal(out, torch.gather(src, 1, idx[..., None].expand(-1, -1, 9))),
          "GatherRows' forward is not torch.gather's")
    g = torch.randn(out.shape, device="cuda", generator=gen)
    _cuda.reset_launch_counts()
    out.backward(g)
    check(_cuda.launch_counts() == {"scatter_rows": 1},
          f"GatherRows' backward launched {_cuda.launch_counts()}")
    check(torch.equal(src.grad, scatter_rows_reference(g, idx, 50)),
          "GatherRows' backward is not the plain scatter")
    log(f"  scatter_rows ragged: {len(SCATTER_SHAPES)} shapes (C in "
        f"{sorted({s[2] for s in SCATTER_SHAPES})}, indices outside the rows mixed in), f32 and "
        "bf16, every entry on one row, no entry, 100,000 entries on one row, a clamped 2 x 64 x "
        f"64 gather layer (longest segment {longest}; C 256 f32 and bf16, C 7), an unaligned "
        "bf16 base, the pinned order [1e8, 1, -1e8] -> 0: bit-equal to the plain version and "
        "to itself; the scratch's size agrees with table_gather.cu's; GatherRows: "
        "torch.gather's forward, one scatter_rows launch backward")
    return dict(shapes=len(SCATTER_SHAPES), one_row_entries=100_000,
                clamped_layer_longest_segment=longest)


def _bf16_adjacent(got, ref, floor: float) -> bool:
    """bf16 values within one ulp of each other (adjacent representable
    values: the ulp of the larger magnitude), plus `floor` (an f32
    difference that moves a value near zero)."""
    import torch

    big = torch.maximum(got.float().abs(), ref.float().abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return bool(((got.float() - ref.float()).abs() <= ulp + floor).all())


def check_instance_norm() -> dict:
    """Phase 3b: the InstanceNorm kernels (hoig_torch/ops/instance_norm.py)
    against their plain versions on the card at every (H, C, batch, dtype)
    of the cells (NORM_G_CALLS, NORM_D_CALLS, NORM_CELL_BATCHES), channels_last,
    affine and parameter-free: y and dx of bf16 inputs within one bf16 ulp
    (plus TOL_NORM of the largest entry, where an f32 difference of the
    terms moves a value near zero), every f32 result (f32 y and dx, the
    statistics, dweight, dbias) within TOL_NORM of its largest entry (y:
    of its largest term, x a or b, which cancel on a one-pixel plane); every kernel bit-equal to itself on a
    second call, and the kept pair's apply bit-equal to the first. Then
    contiguous NCHW and odd shapes, and the times per step of a training
    cell and per call of the serving cell: kernels, their bytes bound, the
    plain version (FoldedStats and the apply that they replaced) and
    F.instance_norm (the library yardstick; no recompute)."""
    import torch
    import torch.nn.functional as F_

    from hoig_torch.ops import _cuda
    from hoig_torch.ops import instance_norm as IN
    from hoig_torch.utils.flops import PEAK_BYTES_PER_S

    check(sum(r[4] for r in NORM_G_CALLS) == NORMS_PER_CALL["inorm_stats"]
          and sum(r[5] for r in NORM_G_CALLS) == NORMS_KEPT["bf16 remat defaults"]
          and 3 * len(NORM_D_CALLS) == NORMS_PER_STEP["inorm_stats"] - NORMS_PER_CALL["inorm_stats"],
          "NORM_G_CALLS / NORM_D_CALLS disagree with the launch constants")
    t_phase = time.perf_counter()
    worst: dict = {}
    times: dict = {}
    failures: list = []

    def run(x, dy, w, b):
        _cuda.reset_launch_counts()
        y, st = IN.norm_forward(x, w, b, 1e-5)
        dx, gw, gb = IN.norm_backward(x, dy, w, st[0], st[2], st[3])
        yk = IN.norm_apply(x, st[0], st[1])
        torch.cuda.synchronize()
        check(_cuda.launch_counts() == {"inorm_stats": 1, "inorm_apply": 2, "inorm_backward": 3},
              f"InstanceNorm launches {_cuda.launch_counts()}")
        return y, st, dx, gw, gb, yk

    def hold(x, dy, w, b, label):
        y, st, dx, gw, gb, yk = run(x, dy, w, b)
        again = run(x, dy, w, b)
        same = all(p is None and q is None or torch.equal(p, q)
                   for p, q in zip((y, st, dx, gw, gb), again[:5]))
        check(same and torch.equal(yk, y), f"InstanceNorm {label}: not bit-equal to itself")
        ref = IN.norm_stats_reference(x, w, b, 1e-5)
        yr = IN.norm_apply_reference(x, ref[0], ref[1])
        dxr, gwr, gbr = IN.norm_backward_reference(x, dy, w, st[0], st[2], st[3])
        f32 = dict(a=(st[0], ref[0]), b=(st[1], ref[1]), mean=(st[2], ref[2]),
                   rstd=(st[3], ref[3]))
        if w is not None:
            f32.update(dweight=(gw, gwr), dbias=(gb, gbr))
        # y's scale is its terms' (x a and b), which cancel where a plane's
        # variance is tiny against its mean (a one-pixel plane: y = bias)
        scale = dict(y=float(x.float().abs().amax(dim=(2, 3)).mul(ref[0].abs()).max()
                               + ref[1].abs().max()))
        if x.dtype == torch.float32:
            f32.update(y=(y, yr), dx=(dx, dxr))
        else:
            for k, got, want in (("y", y, yr), ("dx", dx, dxr)):
                top = scale.get(k, float(want.float().abs().max()))
                if not _bf16_adjacent(got, want, TOL_NORM * top):
                    failures.append(f"{label}: bf16 {k} beyond one ulp")
        for k, (got, want) in f32.items():
            rel = max_err(got, want) / max(scale.get(k, float(want.abs().max())), 1e-30)
            if rel > TOL_NORM:
                failures.append(f"{label}: {k} {rel:.3g} of its largest entry")
            worst[k] = max(worst.get(k, 0.0), rel)

    def inputs(b, c, h, dt, fmt=torch.channels_last, w_=None):
        g = torch.Generator(device="cuda").manual_seed(b * 1000 + c + h)
        w_ = w_ or h
        x = (2 * torch.randn(b, c, h, w_, device="cuda", generator=g) + 1).to(dt)
        dy = torch.randn(b, c, h, w_, device="cuda", generator=g).to(dt)
        return (x.contiguous(memory_format=fmt), dy.contiguous(memory_format=fmt),
                torch.rand(c, device="cuda", generator=g) + 0.5,
                torch.randn(c, device="cuda", generator=g))

    for dtype, batches in NORM_CELL_BATCHES.items():
        dt = getattr(torch, dtype)
        shapes = {(m * bb, c, h) for bb in batches for m, c, h, *_ in NORM_G_CALLS}
        shapes |= {(batches[0], c, h) for _, c, h, *_ in NORM_D_CALLS}
        for b, c, h in sorted(shapes):
            x, dy, w, bias = inputs(b, c, h, dt)
            for affine in (True, False):
                hold(x, dy, *((w, bias) if affine else (None, None)),
                     f"{dtype} B {b} C {c} {h}x{h} {'affine' if affine else 'parameter-free'}")
            wt = (w, bias)
            _, st = IN.norm_forward(x, *wt, 1e-5)
            xg = x.detach().requires_grad_()
            wg, bg = w.detach().requires_grad_(), bias.detach().requires_grad_()

            def plain_fwd():
                a, o = IN.FoldedStats.apply(x, w, bias, 1e-5, None)
                return x * a.to(dt) + o.to(dt)

            def plain_both():
                a, o = IN.FoldedStats.apply(xg, wg, bg, 1e-5, None)
                return torch.autograd.grad(xg * a.to(dt) + o.to(dt), (xg, wg, bg), dy)

            def lib_both():
                return torch.autograd.grad(F_.instance_norm(xg, weight=wg, bias=bg, eps=1e-5),
                                           (xg, wg, bg), dy)

            a4, o4 = st[0][:, :, None, None].to(dt), st[1][:, :, None, None].to(dt)
            nbytes = x.numel() * x.element_size()
            row = dict(
                fwd=device_ms(lambda: IN.norm_forward(x, *wt, 1e-5)),
                apply=device_ms(lambda: IN.norm_apply(x, st[0], st[1])),
                bwd=device_ms(lambda: IN.norm_backward(x, dy, w, st[0], st[2], st[3])),
                plain_fwd=device_ms(plain_fwd, reps=5, behind_sleep=False),
                plain_apply=device_ms(lambda: x * a4 + o4, reps=5, behind_sleep=False),
                plain_both=device_ms(plain_both, reps=5, behind_sleep=False),
                lib_fwd=device_ms(lambda: F_.instance_norm(x, weight=w, bias=bias, eps=1e-5),
                                  reps=5, behind_sleep=False),
                lib_both=device_ms(lib_both, reps=5, behind_sleep=False),
                bound_fwd=3 * nbytes / PEAK_BYTES_PER_S * 1e3,
                bound_apply=2 * nbytes / PEAK_BYTES_PER_S * 1e3,
                bound_bwd=5 * nbytes / PEAK_BYTES_PER_S * 1e3)
            row["plain_bwd"] = row["plain_both"] - row["plain_fwd"]
            row["lib_bwd"] = row["lib_both"] - row["lib_fwd"]
            times[(dtype, b, c, h)] = row
            del x, dy, xg, st
            torch.cuda.empty_cache()
    # contiguous NCHW, odd planes, C off the 16-byte vector, one pixel
    for dtype in NORM_CELL_BATCHES:
        dt = getattr(torch, dtype)
        for b, c, h, w_, fmt in ((3, 64, 15, 15, torch.contiguous_format),
                                 (2, 128, 33, 31, torch.contiguous_format),
                                 (2, 70, 9, 13, torch.channels_last),
                                 (5, 67, 16, 16, torch.contiguous_format),
                                 (4, 256, 1, 1, torch.channels_last)):
            x, dy, w, bias = inputs(b, c, h, dt, fmt, w_)
            for affine in (True, False):
                hold(x, dy, *((w, bias) if affine else (None, None)),
                     f"{dtype} B {b} C {c} {h}x{w_} {fmt} {'affine' if affine else 'free'}")

    check(not failures, f"InstanceNorm kernels against their plain versions ({len(failures)} "
          f"cases): " + "; ".join(failures[:40]))

    def per_step(dtype, b, train):
        """Device ms a step (train) or a call of the norms at batch b."""
        tot = dict.fromkeys(("kernels", "bound", "plain", "library"), 0.0)
        # (batch, C, H, calls, recomputed): the bf16 cells keep the conv
        # blocks' statistics, the f32 cell (full remat) all of G's
        calls = [(m * b, c, h, n, k if dtype == "bfloat16" else n)
                 for m, c, h, _, n, k in NORM_G_CALLS]
        if train:
            calls += [(b, c, h, 3, 0) for _, c, h, *_ in NORM_D_CALLS]
        for bb, c, h, n, kept in calls:
            r = times[(dtype, bb, c, h)]
            for key, k in zip(tot, ("fwd", "bound_fwd", "plain_fwd", "lib_fwd")):
                tot[key] += n * r[k]
            if train:
                for key, k in zip(tot, ("bwd", "bound_bwd", "plain_bwd", "lib_bwd")):
                    tot[key] += n * r[k]
                # the recompute's apply (F.instance_norm keeps no statistics: left out)
                for key, k in zip(tot, ("apply", "bound_apply", "plain_apply")):
                    tot[key] += kept * r[k]
        return tot

    out = dict(worst_rel=worst, tol=TOL_NORM, times={"|".join(map(str, k)): v
                                                     for k, v in times.items()},
               step_bf16_b32=per_step("bfloat16", NORM_CELL_BATCHES["bfloat16"][0], True),
               call_bf16_b16=per_step("bfloat16", NORM_CELL_BATCHES["bfloat16"][1], False),
               step_fp32_b32=per_step("float32", NORM_CELL_BATCHES["float32"][0], True),
               seconds=time.perf_counter() - t_phase)
    log(f"  InstanceNorm kernels held at {len(times)} cell shapes (bf16 one ulp; f32 results "
        f"within {TOL_NORM} of their largest entry; worst "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())) + "), bit-equal to "
        f"themselves; {out['seconds']:.1f} s")
    for key in ("step_bf16_b32", "call_bf16_b16", "step_fp32_b32"):
        t = out[key]
        log(f"  InstanceNorm {key}: kernels {t['kernels']:.2f} ms, bound {t['bound']:.2f}, plain "
            f"{t['plain']:.2f}, F.instance_norm {t['library']:.2f} (device ms)")
    return out


def check_ragged_shapes() -> None:
    """Each kernel against its plain version on small shapes its wrapper
    takes but the main path does not give it: partial pixel tiles and
    channel chunks, extra coefficient columns, an image size off the tile
    grid, a partial face chunk, a narrow table."""
    import torch

    from hoig_torch.ops.local_combine import (fwd_staging, local_combine, local_combine_backward,
                                              local_combine_backward_reference,
                                              local_combine_reference)
    from hoig_torch.ops.rasterizer import rasterize_fim_wim
    from hoig_torch.ops.rasterizer_cuda import rasterize_fim_wim_auto
    from hoig_torch.ops.table_gather import gather_rows, gather_rows_reference

    gen = torch.Generator(device="cuda").manual_seed(5)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)

    def forward_agrees(src, v, r) -> str:
        """The forward against the plain loop: f32 bit-equal, bf16 within
        _fwd_close and bit-equal to itself; returns its staging route."""
        out, ref = local_combine(src, v, r), local_combine_reference(src, v, r)
        what = f"at {tuple(src.shape)} R={r} {src.dtype}"
        if src.dtype == torch.float32:
            check(torch.equal(out, ref), f"local_combine differs {what}")
            return "fp32"
        ok, e, _ = _fwd_close(out, ref, src, v, r)
        check(ok, f"local_combine_tc differs {what}: max abs err {e}")
        check(torch.equal(out, local_combine(src, v, r)),
              f"local_combine_tc gave other bits on a second call {what}")
        return fwd_staging(src)

    routes = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w, c, r, extra in ((2, 13, 11, 6, 3, 15), (1, 9, 20, 70, 5, 0)):
            src = randn(b, h + 2 * r, w + 2 * r, c).to(dtype)
            v = randn(b, h, w, (2 * r + 1) ** 2 + extra).to(dtype)
            routes.append(forward_agrees(src, v, r))
            # the backward kernels through the autograd Function: both sides,
            # then each side alone (needs_input_grad with only one of them)
            g = randn(b, h, w, c).to(dtype)
            rs, rv = local_combine_backward_reference(src, v, g, r)
            k2 = (2 * r + 1) ** 2
            if dtype == torch.bfloat16:  # the tensor-core kernels add in a fixed order
                once, again = (local_combine_backward(src, v, g, r, v.shape[3]) for _ in range(2))
                check(all(torch.equal(x, y) for x, y in zip(once, again)),
                      f"the tensor-core backward gave other bits on a second call at "
                      f"{tuple(src.shape)} R={r}")
            for need_src, need_v in ((True, True), (True, False), (False, True)):
                s_ = src.clone().requires_grad_(need_src)
                v_ = v.clone().requires_grad_(need_v)
                local_combine(s_, v_, r).backward(g)
                what = f"at {tuple(src.shape)} R={r} {dtype} needs=({need_src}, {need_v})"
                check((s_.grad is not None) == need_src and (v_.grad is not None) == need_v,
                      f"LocalCombine gave the wrong gradients {what}")
                if need_src and dtype == torch.float32:
                    check(torch.equal(s_.grad, rs), f"bwd_src differs {what}")
                elif need_src:
                    ok, e, _ = _dsrc_close(s_.grad, rs, v, g, r)
                    check(ok, f"bwd_src_tc differs {what}: max abs err {e}")
                if need_v:
                    ok, e = _dv_close(v_.grad[..., :k2], rv, src, g, dtype == torch.bfloat16)
                    check(ok and not v_.grad[..., k2:].any(), f"bwd_v differs {what}: {e}")
    # the bf16 forward alone: TMA with a partial slab (24, 72 channels), a
    # frame smaller than the TMA box (3 x 5 at R = 5: 13 x 15 padded, boxes
    # of 18 x 18), R = 1 and 2, four channel splits of one slab each, and
    # eight slabs through one block's ring of stages (128 tiles: no split);
    # the element-wise staging with whole 16-byte units on a base 2 bytes off
    for b, h, w, c, r, extra in ((1, 9, 20, 24, 5, 0), (2, 13, 11, 72, 3, 7), (1, 3, 5, 16, 5, 0),
                                 (2, 17, 9, 40, 1, 0), (1, 10, 6, 200, 2, 3),
                                 (2, 64, 64, 512, 3, 0)):
        src = randn(b, h + 2 * r, w + 2 * r, c).bfloat16()
        v = randn(b, h, w, (2 * r + 1) ** 2 + extra).bfloat16()
        routes.append(forward_agrees(src, v, r))
    b, h, w, c, r = 1, 9, 20, 64, 5
    flat = randn(b * (h + 2 * r) * (w + 2 * r) * c + 1).bfloat16()
    src = flat[1:].view(b, h + 2 * r, w + 2 * r, c)
    routes.append(forward_agrees(src, randn(b, h, w, 121).bfloat16(), r))
    check(routes.count("tma") == 6 and routes.count("elementwise") == 3,
          f"the ragged forward calls took the stagings {routes}")
    fv = randn(2, 300, 3, 3) * 0.4
    fv[..., 2] = fv[..., 2].abs() + 1.5
    valid = torch.rand(2, 300, device="cuda", generator=gen) > 0.1
    fim, wim = rasterize_fim_wim_auto(fv, valid, image_size=100)
    fim_r, wim_r = rasterize_fim_wim(fv, valid, image_size=100)
    check(torch.equal(fim, fim_r) and max_err(wim, wim_r) <= 1e-4,
          "rasterizer differs on the 100 px random scene")
    table = randn(3, 77, 3)
    idx = torch.randint(0, 77, (3, 1000), device="cuda", generator=gen, dtype=torch.int32)
    check(torch.equal(gather_rows(table, idx), gather_rows_reference(table, idx)),
          "table_gather differs on a (3, 77, 3) table")
    log(f"  ragged shapes: all six kernels agree with their plain versions "
        f"(100 px scene: {int((fim >= 0).sum())} hit pixels); forward stagings {routes}")


def compare_with_cpu() -> dict:
    """The card against the CPU's plain path on the same inputs and weights."""
    import torch

    from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment
    from hoig_torch.geometry.conditioning import ConditioningConfig
    from hoig_torch.train.model_api import batch_as_torch, flow_only
    from hoig_torch.train.trainer import TrainConfig, build_generator, generator_kwargs

    s = 128
    env_cpu = synthetic_environment(2, s, device="cpu")
    env_gpu = dict(env_cpu, tables=env_cpu["tables_np"].as_torch("cuda"),
                   mano_params=env_cpu["mano"].as_torch("cuda"))
    batch = synthetic_batch(2, env_cpu["obj_verts"], image_size=s, seed=3)
    ccfg = ConditioningConfig(image_size=s)
    fc = flow_only(batch_as_torch(batch, "cpu"), env_cpu, ccfg)
    fg = flow_only(batch_as_torch(batch, "cuda"), env_gpu, ccfg)
    exact = ("src_crop_mask_bg", "tsf_crop_mask_bg", "src_crop_mask_hand", "tsf_crop_mask_hand")
    worst = 0.0
    for k, v in fc.items():
        if v is None:
            continue
        g = fg[k].cpu()
        if k in exact:
            check(torch.equal(g, v), f"conditioning {k} differs between card and CPU")
        else:
            # elements off by > 1e-4: z-fights between nearly coplanar faces
            share = float(((g - v).abs() > 1e-4).float().mean())
            check(share <= 1e-3, f"conditioning {k}: {share:.3g} of elements differ > 1e-4")
            worst = max(worst, share)
    log(f"  conditioning 128 px b2: masks equal, share of other elements off by >1e-4: {worst:.3g}")

    tcfg = TrainConfig(conv_dim=64, repeat_num=6, corner_engine="shift",
                       compute_dtype=torch.float32, remat=False)
    g_cpu = build_generator(tcfg, device="cpu", seed=1)
    g_gpu = copy.deepcopy(g_cpu).to(device="cuda", memory_format=torch.channels_last)
    kw = generator_kwargs({k: (None if v is None else v[:1]) for k, v in fc.items()},
                          torch.as_tensor(batch["maskA"][:1]), torch.as_tensor(batch["maskB"][:1]),
                          True)
    with torch.inference_mode():
        t0 = time.perf_counter()
        out_c = g_cpu(**kw)
        cpu_s = time.perf_counter() - t0
        out_g = g_gpu(**{k: (None if v is None else v.cuda()) for k, v in kw.items()})
    err = max(max_err(a.cpu(), b) for a, b in zip(out_g, out_c))
    # f32 on both sides, TF32 off; the ~45 stacked convolutions and norms run
    # other summation orders on the card
    check(err <= 1e-3, f"full-width generator card vs CPU max abs err {err}")
    log(f"  generator f32 conv_dim 64 repeat 6, 128 px b1: card vs CPU max abs err {err:.3g} "
        f"(tol 1e-3); CPU forward {cpu_s:.1f} s")

    # gradient of one fixed scalar of the ten outputs w.r.t. every weight:
    # the card runs the combine's three kernels, the CPU their plain versions.
    # The objects get a random texture for this: on the untextured synthetic
    # objects the generator's object images are constant, and the object
    # branch's norms then amplify rounding noise into its gradients.
    import numpy as np

    tables_np = env_cpu["tables_np"]
    tables_np.obj_tex = (np.random.RandomState(5).rand(*tables_np.obj_tex.shape) * 2 - 1).astype(
        np.float32)
    f_tex = flow_only(batch_as_torch(batch, "cpu"), dict(env_cpu, tables=tables_np.as_torch("cpu")),
                      ccfg)
    kw_tex = generator_kwargs({k: (None if v is None else v[:1].clone()) for k, v in f_tex.items()},
                              torch.as_tensor(batch["maskA"][:1]),
                              torch.as_tensor(batch["maskB"][:1]), True)
    wgen = torch.Generator().manual_seed(7)
    weights = [torch.randn(o.shape, generator=wgen) for o in out_c]

    def grads(model, dev):
        outs = model(**{k: (None if v is None else v.to(dev)) for k, v in kw_tex.items()})
        scalar = sum((o.float() * w.to(dev)).sum() for o, w in zip(outs, weights))
        named = list(model.named_parameters())
        return dict(zip((n for n, _ in named),
                        torch.autograd.grad(scalar, [p for _, p in named])))

    t0 = time.perf_counter()
    gr_c = grads(g_cpu, "cpu")
    cpu_s = time.perf_counter() - t0
    gr_g = grads(g_gpu, "cuda")
    tree_max = max(float(v.abs().max()) for v in gr_c.values())
    rows = []
    for name, ref in gr_c.items():
        got = gr_g[name].cpu()
        check(bool(torch.isfinite(got).all()), f"non-finite gradient of {name} on the card")
        rows.append((float((got - ref).abs().max()), float(ref.abs().max()), name))
    rows.sort(key=lambda r: -max(r[0] / (r[1] + 1e-4 * tree_max), 20 * r[0] / tree_max))
    for e, top, name in rows[:5]:
        log(f"    {name}: max abs err {e:.3g}, leaf max {top:.3g}, largest gradient {tree_max:.3g}")
    # f32 on both sides, TF32 off; ~45 stacked convolutions and norms and their
    # backward passes run other summation orders on the card, and the small
    # leaves' gradients are differences of large terms. 0.1 of a leaf's max is
    # what a missing or mis-signed path would break in any leaf; 5e-3 of the
    # largest gradient bounds the absolute error.
    for e, top, name in rows:
        check(e <= 0.1 * top + 1e-6 * tree_max and e <= 5e-3 * tree_max,
              f"gradient of {name}: card vs CPU max abs err {e} (leaf max {top}, largest {tree_max})")
    worst_leaf = max(e / top for e, top, _ in rows if top > 1e-6 * tree_max)
    worst_tree = max(e / tree_max for e, _, _ in rows)
    log(f"  gradients of a fixed scalar w.r.t. {len(rows)} weight tensors: card vs CPU worst "
        f"{worst_leaf:.3g} of a leaf's max (tol 0.1), {worst_tree:.3g} of the largest gradient "
        f"(tol 5e-3); CPU forward+backward {cpu_s:.1f} s")
    return dict(conditioning_share_off=worst, generator_err=err, grad_err_of_leaf_max=worst_leaf,
                grad_err_of_tree_max=worst_tree)


def _snapshot(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


def _opt_tensors(opt) -> dict:
    return {(i, k): v for i, st in opt.state_dict()["state"].items() for k, v in st.items()
            if hasattr(v, "shape")}


def train_config(engine: str, **remat):
    """The full-width bf16 training configuration of phases 6 and 7."""
    import torch

    from hoig_torch.train.trainer import TrainConfig

    return TrainConfig(conv_dim=64, repeat_num=6, image_size=IMAGE, use_vgg=True, mask_bce=True,
                       corner_engine=engine, compute_dtype=torch.bfloat16, **remat)


def fp32_config(**kw):
    """The training configuration the drivers run without --bf16, at full
    width: TrainConfig()'s defaults (f32, gather engine, full remat)."""
    from hoig_torch.train.trainer import TrainConfig

    return TrainConfig(image_size=IMAGE, **kw)


def fp32_batch(env):
    """A synthetic batch of FP32_BATCH on the card."""
    from hoig_torch.data.synthetic import synthetic_batch
    from hoig_torch.train.model_api import batch_as_torch

    return batch_as_torch(synthetic_batch(FP32_BATCH, env["obj_verts"], image_size=IMAGE), "cuda")


def build_step(env, ccfg, tcfg):
    """A fresh training state (weights from seed 0) and its step function."""
    import torch

    from hoig_torch.models.vgg import init_vgg
    from hoig_torch.train.trainer import build_networks, init_state, make_train_step

    state = init_state(*build_networks(tcfg, device="cuda", seed=0), tcfg)
    vgg = init_vgg(seed=2, compute_dtype=tcfg.compute_dtype, device="cuda")
    return state, make_train_step(vgg, env["tables"], env["mano_params"], ccfg, tcfg)


def counted_step(state, step, batch, d_trainable, expected: dict):
    """One step from launch counters at 0; asserts the launches and finite metrics."""
    import torch

    from hoig_torch.ops import _cuda

    _cuda.reset_launch_counts()
    state, m = step(state, batch, d_trainable)
    torch.cuda.synchronize()
    got = _cuda.launch_counts()
    check(got == expected, f"per-step launches {got} != {expected}")
    check(all(bool(torch.isfinite(v)) for v in m.values()), f"non-finite metrics {m}")
    return m


def timed_steps(state, step, batch, expected: dict, warm: int, n: int):
    """Host ms of n steps after `warm` ones, and the peak device MiB."""
    import torch

    for _ in range(warm):
        counted_step(state, step, batch, True, expected)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        counted_step(state, step, batch, True, expected)
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, torch.cuda.max_memory_allocated() / 2**20


def recorded_step(state, step, batch, expected: dict, rec) -> tuple[dict, dict]:
    """The first step from launch counters at 0, with the kernels' inputs
    recorded; asserts the launches, finite metrics, and that every weight got
    a finite gradient and moved unless its gradient is exactly zero (constant
    object images, a conv bias before a plain norm). Returns (metrics, launches)."""
    import torch

    from hoig_torch.ops import _cuda

    n_g = sum(p.numel() for p in state.g.parameters())
    n_d = sum(p.numel() for p in state.d.parameters())
    before = _snapshot(dict(state.g.named_parameters())), _snapshot(dict(state.d.named_parameters()))
    with recording(rec):
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        state, metrics = step(state, batch, True)
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
    log(f"  step 1 launches: {launches}; G {n_g / 1e6:.1f} M, D {n_d / 1e6:.1f} M parameters")
    check(launches == expected, f"training step launches {launches} != {expected}")
    check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"non-finite metrics {metrics}")
    log("  step 1 metrics: " + ", ".join(f"{k} {float(v):.4g}" for k, v in metrics.items()))
    for net, snap, label in ((state.g, before[0], "G"), (state.d, before[1], "D")):
        still = 0
        for name, p in net.named_parameters():
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"{label} {name}: missing or non-finite gradient")
            if torch.equal(p.detach(), snap[name]):
                check(not bool(p.grad.any()), f"{label} {name} has a gradient but did not move")
                still += 1
        check(still <= 0.05 * len(snap), f"{still} of {len(snap)} {label} weights did not move")
        log(f"  {label}: {len(snap) - still} of {len(snap)} weight tensors moved "
            f"({still} with an all-zero gradient)")
    return {k: float(v) for k, v in metrics.items()}, launches


def fresh_step(env, ccfg, batch, tcfg, expected: dict) -> dict:
    """One first step (fresh weights from seed 0, D's gate on) from launch
    counters at 0, cuDNN held to its deterministic algorithms: {"grad g.<name>"
    / "grad d.<name>": gradient, "weight g.<name>" / "weight d.<name>": the
    updated weight} of every parameter."""
    import torch

    state, step = build_step(env, ccfg, tcfg)
    torch.backends.cudnn.deterministic = True
    try:
        counted_step(state, step, batch, True, expected)
    finally:
        torch.backends.cudnn.deterministic = False
    out = {}
    for net in ("g", "d"):
        for name, p in getattr(state, net).named_parameters():
            out[f"grad {net}.{name}"] = p.grad.detach().clone()
            out[f"weight {net}.{name}"] = p.detach().clone()
    del state, step
    torch.cuda.empty_cache()
    return out


def bit_equal(got: dict, want: dict, label: str) -> int:
    """Every tensor of `got` bit-equal to `want`'s (the gradients and updated
    weights of two steps); fails naming the differing ones. Returns how many
    were compared."""
    import torch

    check(got.keys() == want.keys(), f"{label}: other tensors")
    bad = sorted(((max_err(got[k], v), k) for k, v in want.items() if not torch.equal(got[k], v)),
                 reverse=True)
    check(not bad, f"{label}: {len(bad)} of {len(want)} tensors differ, the largest "
          + ", ".join(f"{k} by {e:.3g}" for e, k in bad[:6]))
    n_grads = sum(k.startswith("grad ") for k in want)
    log(f"  {label}: all {n_grads} gradients and {len(want) - n_grads} updated weights bit-equal")
    return len(want)


# ops that torch's deterministic-algorithms setting names on the bf16 step's
# path and that this project leaves as they are (ROADMAP C): none. The
# setting swaps index_add_, index_put_ and the scatter-adds for
# deterministic kernels without naming them; the bit-equality checks, run
# without it, see those.
REMAINING_NONDETERMINISTIC: tuple = ()


@contextlib.contextmanager
def stderr_to(path: Path):
    """The process's standard error (file descriptor 2, where torch's C++
    warnings go when no Python handler takes them) written to `path` while
    the block runs, then echoed to the real standard error."""
    import os

    sys.stderr.flush()
    saved = os.dup(2)
    with open(path, "wb") as sink:
        os.dup2(sink.fileno(), 2)
        try:
            yield
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)
            os.close(saved)
    sys.stderr.write(path.read_text(errors="replace"))


def _alerts(caught, stderr_path: Path) -> list:
    """The ops that torch's deterministic setting named, from the Python
    warnings and the C++ ones on standard error."""
    pattern = re.compile(r"(?:^|Warning: )(\w+)(?: with [^.\n]*?)? does not have a "
                         r"deterministic implementation", re.M)
    text = "\n".join(str(w.message) for w in caught) + "\n" + stderr_path.read_text(
        errors="replace")
    return sorted(set(pattern.findall(text)))


def determinism_probe(env, ccfg, batch, out_dir: Path) -> dict:
    """Phase 7 (d): one bf16 step (fresh weights) with each engine under
    torch.use_deterministic_algorithms(True, warn_only=True): the shift
    engine with the remat defaults, the fused engine with remat off and with
    remat + remat_attn; and the fp32 step as the drivers run it
    (TrainConfig(): gather engine, full remat) at batch 8. Prints every op
    the setting names (as a Python
    warning or, from some ops, as a C++ warning on standard error, once per
    process) and fails on one that REMAINING_NONDETERMINISTIC does not
    name. Two controls first show that the probe sees both kinds of call:
    histc (forward) and grid_sample's backward (autograd's thread)."""
    import warnings

    import torch

    def probed(label, fn):
        err = out_dir / f"determinism_{len(out)}.stderr.txt"
        with warnings.catch_warnings(record=True) as caught, stderr_to(err):
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                fn()
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        out[label] = _alerts(caught, err)
        return out[label]

    def grid_backward():
        x = torch.ones(1, 1, 4, 4, device="cuda", requires_grad=True)
        grid = torch.zeros(1, 2, 2, 2, device="cuda")
        torch.nn.functional.grid_sample(x, grid, align_corners=False).sum().backward()

    out: dict = {}
    controls = {"_histc_cuda": lambda: torch.histc(torch.rand(16, device="cuda")),
                "grid_sampler_2d_backward_cuda": grid_backward}
    for op, fn in controls.items():
        check(op in probed(f"control {op}", fn), f"the determinism probe does not see {op}: "
              "it would be blind")
    configs = {
        "shift, bf16 remat defaults": (train_config("shift", remat=True, remat_bottleneck=False,
                                                    remat_attn=False), batch,
                                       LAUNCHES_PER_STEP_REMAT),
        "fused, remat off": (train_config("pallas", remat=False), batch, FUSED_LAUNCHES_PER_STEP),
        "fused, remat + remat_attn": (train_config("pallas", remat=True, remat_bottleneck=False,
                                                   remat_attn=True), batch,
                                      FUSED_LAUNCHES_PER_STEP_REMAT),
        f"gather, fp32 batch {FP32_BATCH}, full remat": (fp32_config(), fp32_batch(env),
                                                         FP32_LAUNCHES_PER_STEP),
    }
    for label, (tcfg, data, expected) in configs.items():
        ops = probed(label, lambda: fresh_step(env, ccfg, data, tcfg, expected))
        log(f"  (d) {label}: torch.use_deterministic_algorithms(True, warn_only=True) names "
            f"{len(ops)} op(s){': ' + ', '.join(ops) if ops else ''}")
        stray = [op for op in ops if op not in REMAINING_NONDETERMINISTIC]
        check(not stray, f"determinism probe, {label}: {stray}")
    return out


def training_phase(env, ccfg, batch, regions: dict, more_regions, out_dir: Path
                   ) -> tuple[dict, dict, dict]:
    """The GAN training step at full width on the card with the shift engine,
    and the profiler window over `regions`, the regions `more_regions()`
    builds, and one such step (see the module docstring, phases 7 and 8).
    Returns (kernel results of bwd_src / bwd_v, the training numbers, the
    profile)."""
    import torch

    from hoig_torch.train.environment import resolve_corner_engine
    from hoig_torch.utils.profiling import profile_window

    def config(**remat):
        return train_config(resolve_corner_engine("auto", bf16=True), **remat)

    # remat off: the recorded step, the kernel checks, the timed steps, the gated step
    state, step = build_step(env, ccfg, config(remat=False))
    n_g = sum(p.numel() for p in state.g.parameters())
    n_d = sum(p.numel() for p in state.d.parameters())
    rec = Recorder()
    metrics, launches = recorded_step(state, step, batch, LAUNCHES_PER_STEP, rec)
    check(len(rec.calls["local_combine_backward"]) == LAUNCHES_PER_STEP["local_combine_bwd_src_tc"],
          f"{len(rec.calls['local_combine_backward'])} backward calls recorded")
    results = check_local_combine_backward(rec.calls["local_combine_backward"])
    check(len(rec.calls["edge_pad_fold"]) == LAUNCHES_PER_STEP["edge_pad_fold"],
          f"{len(rec.calls['edge_pad_fold'])} edge-pad folds recorded")
    results["edge_pad_fold"] = check_edge_pad_fold(rec.calls["edge_pad_fold"])
    for name in results:
        results[name]["launches"] = launches[name]
    del rec

    ms, peak = timed_steps(state, step, batch, LAUNCHES_PER_STEP, warm=3, n=6)
    # the gated step leaves D and its Adam state bit-equal
    d_before = _snapshot(dict(state.d.named_parameters()))
    o_before = _snapshot(_opt_tensors(state.opt_d))
    g_before = _snapshot(dict(list(state.g.named_parameters())[:1]))
    m_gated = counted_step(state, step, batch, False, gated(LAUNCHES_PER_STEP))
    check(all(torch.equal(v, d_before[k]) for k, v in state.d.named_parameters()),
          "the gated step moved D's weights")
    o_after = _opt_tensors(state.opt_d)
    check(o_after.keys() == o_before.keys() and all(torch.equal(v, o_before[k]) for k, v in o_after.items()),
          "the gated step moved D's Adam state")
    check(not any(torch.equal(p.detach(), g_before[n]) for n, p in list(state.g.named_parameters())[:1]),
          "the gated step did not train G")
    check(all(k in m_gated for k in ("loss_D", "d_real", "d_fake")), "gated step metrics incomplete")
    med = statistics.median(ms)
    train = dict(step_ms=med, images_per_s=BATCH / (med / 1e3), peak_mem_mb=peak, steps=len(ms),
                 step_ms_all=ms, launches=launches, params_g=n_g, params_d=n_d, metrics=metrics)
    log(f"  remat off: step {med:.2f} ms (median of {len(ms)}; {min(ms):.2f}-{max(ms):.2f}), "
        f"{train['images_per_s']:.2f} images/s, peak {peak:.0f} MiB; gated step leaves D bit-equal")

    # 8. one profiler window over both paths of both engines, and the shift
    # step with the bf16 remat defaults (conv blocks recomputed, the
    # bottleneck and the attention kept)
    log("[8] profiler window: 2 serving calls and 1 training step, each engine; 1 shift step "
        "with the bf16 remat defaults")
    rstate, rstep = build_step(env, ccfg, config(remat=True, remat_bottleneck=False,
                                                 remat_attn=False))
    counted_step(rstate, rstep, batch, True, LAUNCHES_PER_STEP_REMAT)  # warm-up
    regions = dict(regions, **more_regions(), hoig_train=(
        lambda: counted_step(state, step, batch, True, LAUNCHES_PER_STEP), 1), hoig_train_remat=(
        lambda: counted_step(rstate, rstep, batch, True, LAUNCHES_PER_STEP_REMAT), 1))
    profile = profile_window(regions, out_dir, log=log)
    del regions, state, step
    torch.cuda.empty_cache()
    train["device_ms"] = profile.get("hoig_train", {}).get("device_ms")
    train["remat"] = remat_profile(profile, rstate.g)

    # the remat defaults' memory peak and step time
    ms, peak = timed_steps(rstate, rstep, batch, LAUNCHES_PER_STEP_REMAT, warm=2, n=4)
    train["remat"].update(step_ms=statistics.median(ms), peak_mem_mb=peak, step_ms_all=ms)
    log(f"  remat (conv blocks; bottleneck and attention kept): step "
        f"{train['remat']['step_ms']:.2f} ms (median of {len(ms)}), peak {peak:.0f} MiB")
    del rstate, rstep
    torch.cuda.empty_cache()

    # 7 (b), (c): the same first step (fresh weights from seed 0, same batch)
    # twice with the remat defaults and once with remat off: every gradient
    # and updated weight bit-equal
    log("  (b) the first step twice with the bf16 remat defaults, (c) once with remat off: "
        "bit for bit")
    remat_cfg = config(remat=True, remat_bottleneck=False, remat_attn=False)
    first = fresh_step(env, ccfg, batch, remat_cfg, LAUNCHES_PER_STEP_REMAT)
    n = bit_equal(fresh_step(env, ccfg, batch, remat_cfg, LAUNCHES_PER_STEP_REMAT), first,
                  "(b) two shift steps with the remat defaults")
    bit_equal(fresh_step(env, ccfg, batch, config(remat=False), LAUNCHES_PER_STEP), first,
              "(c) the shift step with remat off against the remat defaults")
    train["remat"]["bit_equal_tensors"] = n
    del first
    log("  (d) determinism probe")
    train["determinism_probe"] = determinism_probe(env, ccfg, batch, out_dir)
    return results, train, profile


def fp32_phase(env, ccfg) -> tuple[dict, dict]:
    """Phase 7 (e): the fp32 training step as the drivers run it
    (TrainConfig(): f32, gather engine, full remat; batch 8, 256 px, full
    width): one step from launch counters at 0 with scatter_rows' inputs
    recorded (the 9 attention layers' corner gradients), scatter_rows held
    on them and on ragged shapes; then the same first step (fresh weights
    from seed 0, D's gate on) twice and once with remat off, every G and D
    gradient and updated weight bit-equal. cuDNN runs with
    torch.backends.cudnn.deterministic = True in those steps, as in (b) and
    (c); TF32 is off, as everywhere in this script. Returns (the kernel's
    results, the phase's numbers with the first step's tensors on the host
    for phase 10a)."""
    import dataclasses

    import torch

    from hoig_torch.train.environment import resolve_corner_engine

    tcfg = fp32_config()
    check(tcfg.corner_engine == resolve_corner_engine("auto", bf16=False) == "gather"
          and tcfg.compute_dtype == torch.float32
          and (tcfg.remat, tcfg.remat_bottleneck, tcfg.remat_attn) == (True, True, True),
          f"TrainConfig() is not the f32 gather step with full remat: {tcfg}")
    batch = fp32_batch(env)
    t0 = time.perf_counter()
    state, step = build_step(env, ccfg, tcfg)
    rec = Recorder()
    torch.cuda.reset_peak_memory_stats()
    metrics, launches = recorded_step(state, step, batch, FP32_LAUNCHES_PER_STEP, rec)
    peak = torch.cuda.max_memory_allocated() / 2**20
    del state, step
    torch.cuda.empty_cache()
    calls = rec.calls["scatter_rows"]
    check(len(calls) == FP32_LAUNCHES_PER_STEP["scatter_rows"],
          f"{len(calls)} scatter_rows calls recorded")
    result = check_scatter_rows(calls)
    result["launches"] = launches["scatter_rows"]
    del rec, calls
    torch.cuda.empty_cache()
    result["ragged"] = check_scatter_ragged()

    log("  (e) the fp32 step's first step twice with full remat and once with remat off: bit "
        "for bit")
    first = fresh_step(env, ccfg, batch, tcfg, FP32_LAUNCHES_PER_STEP)
    n = bit_equal(fresh_step(env, ccfg, batch, tcfg, FP32_LAUNCHES_PER_STEP), first,
                  "(e) two fp32 steps with full remat")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bit_equal(fresh_step(env, ccfg, batch, dataclasses.replace(tcfg, remat=False),
                         dict(FP32_LAUNCHES_PER_STEP, inorm_apply=NORMS_PER_STEP["inorm_apply"])),
              first,
              "(e) the fp32 step with remat off against full remat")
    peak_off = torch.cuda.max_memory_allocated() / 2**20
    out = dict(launches=launches, metrics=metrics, bit_equal_tensors=n,
               recorded_step_peak_mib=peak, remat_off_peak_mib=peak_off,
               seconds=time.perf_counter() - t0)
    out["reference"] = {k: v.cpu() for k, v in first.items()}
    del first
    torch.cuda.empty_cache()
    log(f"  (e) fp32 batch {FP32_BATCH}: launches {launches}; peak {peak:.0f} MiB with the "
        f"9 layers' gradients recorded, {peak_off:.0f} MiB with remat off; "
        f"{out['seconds']:.1f} s")
    return result, out


def remat_norms(g) -> dict:
    """InstanceNorms of generator g in rematerialized regions (`_run` with
    remat on; the attention has none), by kind, and the device kernels that
    keeping their statistics saves each recompute: the statistics kernel
    (inorm_stats_kernel) of each."""
    import torch

    from hoig_torch.models.layers import InstanceNorm, ResidualBlock

    def norms(mods, affine):
        return sum(isinstance(m, InstanceNorm) and (m.weight is not None) == affine
                   for mod in mods for m in mod.modules())

    bg, regions = g.bg_model, []
    if bg.remat:
        for net in (g.src_model, g.tsf_model, g.obj_model):
            regions += [net.encoders, net.decoders, net.skippers]
            regions += [net.resnets] if net.remat_mid else []
        regions += [m for m in bg.model if bg.remat_mid or not isinstance(m, ResidualBlock)]
    affine, plain = norms(regions, True), norms(regions, False)
    return dict(affine=affine, parameter_free=plain, kernels=affine + plain)


def remat_profile(profile: dict, g) -> dict:
    """Phase 8's remat-defaults step against the remat-off step: device
    kernels, and the InstanceNorm statistics' kernels and ms per step. The
    recompute reduces nothing (models/layers.py keep_stats): both steps run
    as many statistics kernels (inorm_stats_kernel), the remat step the
    apply kernel once more for each kept pair."""
    derived = remat_norms(g)
    off, on = profile.get("hoig_train"), profile.get("hoig_train_remat")
    out = dict(norms_in_remat_regions=derived)
    if off is None or on is None:
        log("  profiler: the remat-defaults step against remat off not measured")
        return out

    def launched(r, kernel):
        hit = (r.get("hand_written") or {}).get(kernel, {})
        return hit.get("count", 0), hit.get("ms", 0.0)

    stats = {k: launched(r, "inorm_stats_kernel") for k, r in (("off", off), ("on", on))}
    applies = {k: launched(r, "inorm_apply_kernel")[0] for k, r in (("off", off), ("on", on))}
    out.update(kernels_per_step=on["kernels_per_call"], device_ms=on["device_ms"],
               remat_off_kernels_per_step=off["kernels_per_call"],
               in_stats_kernels=stats["on"][0], in_stats_ms=stats["on"][1],
               remat_off_in_stats_kernels=stats["off"][0], remat_off_in_stats_ms=stats["off"][1])
    log(f"  profiler: the shift step with the bf16 remat defaults {on['kernels_per_call']} device "
        f"kernels, {on['device_ms']:.2f} ms busy; remat off {off['kernels_per_call']}, "
        f"{off['device_ms']:.2f} ms; InstanceNorm statistics {stats['on'][0]} kernels "
        f"{stats['on'][1]:.3f} ms / remat off {stats['off'][0]} kernels {stats['off'][1]:.3f} ms; "
        f"{derived['affine']} + {derived['parameter_free']} norms in remat regions, whose kept "
        f"statistics save the recompute {derived['kernels']} kernels")
    check(stats["on"][0] == stats["off"][0] == NORMS_PER_STEP["inorm_stats"],
          "the remat recompute reduced InstanceNorm statistics again: "
          f"{stats['on'][0]} statistics kernels against {stats['off'][0]}")
    check(applies["on"] - applies["off"] == NORMS_KEPT["bf16 remat defaults"],
          f"the remat step applies {applies['on']} InstanceNorms against {applies['off']}")
    return out


def _fused_cost(name: str, args) -> tuple[float, float, float]:
    """(bytes, FP32 operations, bf16 tensor-core operations) of one B4
    launch on these inputs (hoig_torch/utils/flops.py `fused_cost`)."""
    from hoig_torch.utils.flops import fused_cost

    b, h, w, c = _fused_shape(name, args)
    es = (args[5] if name == "attn_fused_bwd_a_gsrc" else args[0]).element_size()
    return fused_cost(name, b, h, w, c, es == 2)


def _fused_shape(name: str, args) -> list:
    """(B, H, W, C) of a B4 call (bwd-a-gsrc takes g_acc, 128 wide, and w0s)."""
    if name == "attn_fused_bwd_a_gsrc":
        return list(args[0].shape[:3]) + [args[5].shape[1]]
    return list(args[0].shape)


def _tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _within(got, ref, rel: float) -> tuple[bool, float]:
    err = max_err(got, ref)
    return err <= rel * float(ref.float().abs().max()), err


def _library_call(name: str, args):
    """The one PyTorch call that computes a B4 kernel's 5x5 product on the
    same inputs, as a yardstick the port never calls, or None: cuDNN's
    conv2d of the bf16 edge-padded source with the (128, C, 5, 5) weight for
    B4-fwd's phase A, its conv_transpose2d of the f32 dG with the
    f32-widened weight for the gsrc projection, and its weight gradient
    (convolution_backward, weight output only) of that conv2d from the f32
    dG and the f32-widened edge-padded source for dW. The call's inputs are
    made outside the timed call."""
    import torch
    import torch.nn.functional as F_

    from hoig_torch.ops import attn_fused as af

    if name == "attn_fused_fwd":
        src, w0s = args[0], args[2]
        x = af._nchw(af.edge_pad(src, af.PAD))
        wt = af._conv_weight(w0s).to(src.dtype).contiguous(memory_format=torch.channels_last)
        return lambda: F_.conv2d(x, wt)
    if name == "attn_fused_bwd_a_gsrc":
        x = af._nchw(af._dg_reference(args[0], *af.coeff_axes(*args[1:5])))
        wt = af._conv_weight(args[5]).contiguous(memory_format=torch.channels_last)
        return lambda: F_.conv_transpose2d(x, wt)
    if name == "attn_fused_bwd_a_dw":
        src, dg = args
        x = af._nchw(af.edge_pad(src, af.PAD).float())
        g = af._nchw(dg)
        wt = torch.empty((af.F, src.shape[3], af.K, af.K), device=src.device).contiguous(
            memory_format=torch.channels_last)  # only its shape is read
        return lambda: torch.ops.aten.convolution_backward(
            g, x, wt, None, [1, 1], [0, 0], [1, 1], False, [0, 0], 1, [False, True, False])[1]
    return None


def _library_dw(grad_weight):
    """cuDNN's (128, C, 5, 5) weight gradient in dW's (25, C, 128) layout."""
    return grad_weight.permute(2, 3, 1, 0).reshape(25, grad_weight.shape[1], grad_weight.shape[0])


# outputs held bit-equal to the plain version, bf16 and f32: B4-bwd-c's
# source gradient sums its rounded products and folds the margins in the
# plain version's order
EXACT = {"attn_fused_bwd_c": (0,)}


def check_fused_kernel(name: str, calls) -> dict:
    """The B4 kernel of wrapper `name` on every recorded call of the main
    path: against its plain version with the inputs as recorded (bf16) and
    cast to f32, with the tolerances of TOL_* (bit-equal for the outputs in
    EXACT); the bf16 call made twice and
    held bit-equal (the kernels add in a fixed order: a missing fence or
    barrier shows as a difference); then timed, summed over the launches
    (the kernel behind a GPU sleep): the kernel, its plain version, the
    library yardstick where there is one and, for the two tensor-core
    kernels, their FP32 path on the same inputs cast to f32. Fails if the
    kernel reads faster than its bound (the count would be wrong)."""
    import torch

    from hoig_torch.ops import attn_fused as af

    kern, plain = getattr(af, name), getattr(af, name + "_reference")
    # the three kernels with a tensor-core entry point under bf16, and the
    # one PyTorch call of their 5x5 product alone (library_ms)
    library = {"attn_fused_fwd": "cuDNN conv2d of phase A's 5x5 product alone",
               "attn_fused_bwd_a_gsrc": "cuDNN conv_transpose2d of the gsrc projection alone",
               "attn_fused_bwd_a_dw": "cuDNN weight gradient (aten.convolution_backward, weight "
                                      "only) of the 5x5 product, f32"}.get(name)
    # per output, under bf16 inputs: out / gsrc_c one ulp; residuals 1e-4;
    # the gsrc projection, dG and dW (exact f32 products) 1e-5
    tols = {"attn_fused_fwd": (TOL_BF16, TOL_RESID, TOL_RESID),
            "attn_fused_bwd_c": (TOL_BF16, TOL_RESID),
            "attn_fused_bwd_a_gsrc": (TOL_F32, TOL_F32), "attn_fused_bwd_a_dw": (TOL_F32,)}[name]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0, f32=0.0, tc=0.0, f32_ms=0.0,
               f32_bytes=0.0, f32_f32=0.0)
    err16 = [0.0] * len(tols)
    err32 = [0.0] * len(tols)
    rel16 = [0.0] * len(tols)  # max abs err over the output's largest magnitude
    rel32 = [0.0] * len(tols)
    exact = [True] * len(tols)
    rows = []
    for args, _ in calls:
        args = tuple(a.detach() for a in args)
        lowp = any(a.dtype == torch.bfloat16 for a in args)
        for cast in ((False, True) if lowp else (True,)):
            a_ = tuple(a.float() for a in args) if cast else args
            got, ref = _tuple(kern(*a_)), _tuple(plain(*a_))
            again = _tuple(kern(*a_))
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  f"{name} gave other bits on a second call at {_fused_shape(name, args)}")
            for i, (g_, r_) in enumerate(zip(got, ref)):
                tol = TOL_F32 if cast else tols[i]
                ok, e = _within(g_, r_, tol)
                if i in EXACT.get(name, ()):
                    check(torch.equal(g_, r_), f"{name} output {i} ({'f32' if cast else 'bf16'}) is "
                          f"not bit-equal to the plain version at {_fused_shape(name, args)}")
                check(ok and g_.shape == r_.shape and g_.dtype == r_.dtype,
                      f"{name} output {i} ({'f32' if cast else 'bf16'}) at {_fused_shape(name, args)}: "
                      f"max abs err {e} above {tol} of {float(r_.float().abs().max())}")
                errs, rels = (err32, rel32) if cast else (err16, rel16)
                errs[i] = max(errs[i], e)
                rels[i] = max(rels[i], e / max(float(r_.float().abs().max()), 1e-30))
                if not cast:
                    exact[i] = exact[i] and torch.equal(g_, r_)
        nbytes, f32, tc = _fused_cost(name, args)
        bnd, by = bound_ms(nbytes, f32, tc)
        row = dict(shape=_fused_shape(name, args), ms=device_ms(lambda: kern(*args)),
                   plain_ms=device_ms(lambda: plain(*args), reps=2, behind_sleep=False),
                   bound_ms=bnd, bound_by=by)
        check(row["ms"] >= bnd, f"{name} at {row['shape']}: {row['ms']} ms is below its bound {bnd}")
        lib = _library_call(name, args)
        if lib is not None:
            row["library_ms"] = device_ms(lib)
            if name == "attn_fused_bwd_a_dw":  # recorded, not held to a bound
                ref = _tuple(plain(*args))[0]
                row["library_rel_err"] = max_err(_library_dw(lib()), ref) / float(ref.abs().max())
        if library is not None:
            a32 = tuple(a.float() for a in args)
            row["f32_ms"] = device_ms(lambda: kern(*a32))
            b32, o32, _ = _fused_cost(name, a32)
            tot["f32_bytes"] += b32
            tot["f32_f32"] += o32
        for k, v in (("bytes", nbytes), ("f32", f32), ("tc", tc)):
            tot[k] += v
        for k in ("ms", "plain_ms", "library_ms", "f32_ms"):
            tot[k] += row.get(k, 0.0)
        rows.append(row)
    bnd, by = bound_ms(tot["bytes"], tot["f32"], tot["tc"])
    log(f"  {name}: {len(calls)} calls; kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.2f} ms,"
        f" bound {bnd:.4f} ms ({by}; {tot['bytes'] / 1e6:.1f} MB, {tot['f32'] / 1e9:.1f} GFLOP FP32,"
        f" {tot['tc'] / 1e9:.1f} GFLOP bf16 tensor-core); max abs err per output bf16 "
        f"{['%.3g' % e for e in err16]} (bit-exact {exact}), f32 {['%.3g' % e for e in err32]}; "
        f"of the largest entry bf16 {['%.3g' % e for e in rel16]} (bounds {list(tols)}), f32 "
        f"{['%.3g' % e for e in rel32]} (bound {TOL_F32}); a second call bit-equal")
    out = dict(max_abs_err=max(err16 + err32), ms=tot["ms"], plain_ms=tot["plain_ms"],
               bound_ms=bnd, bound_by=by,
               library_ms=tot["library_ms"] if library is not None else None, library=library,
               err_bf16=err16, err_f32=err32, rel_err_bf16=rel16, rel_err_f32=rel32,
               bit_exact_bf16=exact, bytes=tot["bytes"],
               fp32_flop=tot["f32"], bf16_flop=tot["tc"], calls=len(calls), detail=rows)
    if library is not None:
        f32_bnd, f32_by = bound_ms(tot["f32_bytes"], tot["f32_f32"])
        out.update(f32_ms=tot["f32_ms"], f32_bound_ms=f32_bnd, f32_bound_by=f32_by)
        lib_err = [r["library_rel_err"] for r in rows if "library_rel_err" in r]
        if lib_err:
            out["library_rel_err"] = max(lib_err)
        log(f"    {library}: {tot['library_ms']:.4f} ms"
            + (f" (its error of the largest entry {max(lib_err):.3g})" if lib_err else "")
            + f"; FP32 path on the f32 inputs {tot['f32_ms']:.4f} ms (bound {f32_bnd:.4f}, "
            f"{f32_by})")
        for r in rows:
            log(f"    {r['shape']}: kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f}, plain "
                f"{r['plain_ms']:.3f}, library {r['library_ms']:.4f}, f32 path {r['f32_ms']:.4f}")
    return out


# (B, H, W, C) off the tile grids: H != W, frames that are not multiples of
# the 8x8 tiles, channel counts that are not multiples of 8 or 16 (6, 70, 130,
# 18) or of 64 (24), past one 64- or 128-wide chunk; small frames make the
# tensor-core products split K over the offsets
RAGGED_FUSED = ((1, 13, 11, 6), (2, 9, 20, 70), (1, 17, 8, 130), (2, 10, 19, 18), (2, 21, 27, 24))
# B4-bwd-c's frames where one pixel collects both margins of an axis (H or W
# equal to 1) or one tile touches both edges (H and W below 11)
SMALL_BWD_C = ((1, 1, 1, 6), (2, 1, 13, 18), (1, 9, 1, 70), (2, 7, 10, 130), (1, 5, 3, 24),
               (3, 1, 1, 64))
# odd channel counts, which every B4 wrapper runs at the next even count (a
# zero channel: attn_fused.with_even_channels)
ODD_FUSED = ((2, 9, 13, 7), (1, 6, 5, 1))


def check_fused_ragged() -> dict:
    """(c) All four B4 kernels against their plain versions on RAGGED_FUSED
    and at the odd channel counts of ODD_FUSED, and B4-bwd-c also on
    SMALL_BWD_C, f32 and bf16, each called twice and held bit-equal to itself
    (dW on the plain version's dG; the outputs in EXACT bit-equal to the
    plain version)."""
    import torch

    from hoig_torch.ops import attn_fused as af

    gen = torch.Generator(device="cuda").manual_seed(9)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)
    worst: dict = {}  # (kernel, dtype) -> the largest error over the output's largest magnitude
    for b, h, w, c in RAGGED_FUSED + ODD_FUSED + SMALL_BWD_C:
        for dtype in (torch.float32, torch.bfloat16):
            src = randn(b, h, w, c).to(dtype)
            w0s = (randn(25, c, 128) / (25 * c) ** 0.5).to(dtype)
            flow = torch.rand(b, h, w, 2, device="cuda", generator=gen) * 4.9 - 2.95
            fields = af.flow_fields(flow)
            fwd_args = (src, 0.1 * randn(b, h, w, 128), w0s, randn(128, 25) / 128 ** 0.5,
                        0.1 * randn(1, 25), *fields)
            attn = af.attn_fused_fwd(*fwd_args)[2]
            g_acc = randn(b, h, w, 128)
            dg = af._dg_reference(g_acc, *af.coeff_axes(*fields))
            cases = {"attn_fused_fwd": fwd_args,
                     "attn_fused_bwd_c": (src, *fields, attn, randn(b, h, w, c).to(dtype)),
                     "attn_fused_bwd_a_gsrc": (g_acc, *fields, w0s),
                     "attn_fused_bwd_a_dw": (src, dg)}
            if (b, h, w, c) in SMALL_BWD_C:
                cases = {"attn_fused_bwd_c": cases["attn_fused_bwd_c"]}
            for name, args in cases.items():
                got = _tuple(getattr(af, name)(*args))
                ref = _tuple(getattr(af, name + "_reference")(*args))
                again = _tuple(getattr(af, name)(*args))
                check(all(torch.equal(x, y) for x, y in zip(got, again)),
                      f"{name} gave other bits on a second call at {(b, h, w, c)} {dtype}")
                for i, (g_, r_) in enumerate(zip(got, ref)):
                    tol = TOL_F32 if dtype == torch.float32 else (
                        TOL_BF16 if (name, i) in (("attn_fused_fwd", 0), ("attn_fused_bwd_c", 0))
                        else TOL_F32 if name in ("attn_fused_bwd_a_gsrc", "attn_fused_bwd_a_dw")
                        else TOL_RESID)
                    ok, e = _within(g_, r_, tol)
                    check(ok, f"{name} output {i} differs at {(b, h, w, c)} {dtype}: {e}")
                    if i in EXACT.get(name, ()):
                        check(torch.equal(g_, r_), f"{name} output {i} is not bit-equal to the "
                              f"plain version at {(b, h, w, c)} {dtype}")
                    key = (name, str(dtype).replace("torch.", ""))
                    worst[key] = max(worst.get(key, 0.0), e / float(r_.float().abs().max()))
    log(f"  (c) ragged shapes {', '.join(map(str, RAGGED_FUSED + ODD_FUSED))}, f32 and bf16: all four B4 "
        f"kernels agree with their plain versions and repeat their bits; B4-bwd-c also on "
        f"{', '.join(map(str, SMALL_BWD_C))}, its source gradient bit-equal throughout; worst "
        "error of the largest entry: " + ", ".join(f"{k} {d} {v:.3g}" for (k, d), v in sorted(worst.items())))
    return {f"{k} {d}": v for (k, d), v in worst.items()}


def shift_yardstick(layer_inputs, gen_shift) -> tuple[float, float]:
    """Device ms of the shift engine's ExtractorAttn on the fused path's own
    layer inputs, summed over the layers: its forward, and its backward
    (forward + backward less forward). Timed with events around each call,
    not queued ahead: the module launches many small kernels."""
    import torch

    fwd = bwd = 0.0
    for name, (src, tgt, flow) in layer_inputs:
        mod = gen_shift.get_submodule(name)
        s_, t_, f_ = (x.detach().clone() for x in (src, tgt, flow))
        with torch.inference_mode():
            f_ms = device_ms(lambda: mod(s_, t_, f_), reps=3, behind_sleep=False)
        s_.requires_grad_(True)
        t_.requires_grad_(True)
        cot = torch.ones_like(s_)
        fb_ms = device_ms(lambda: torch.autograd.backward(mod(s_, t_, f_), cot), reps=3,
                          behind_sleep=False)
        mod.zero_grad(set_to_none=True)
        fwd += f_ms
        bwd += max(fb_ms - f_ms, 0.0)
    return fwd, bwd


def engines_agree() -> dict:
    """(d) The fused and shift engines on the card in f32 (TF32 off), full
    width, 128 px, batch 1, one state dict: the ten outputs within the JAX
    package's bound for its engine comparison (rtol 2e-4, atol 2e-5,
    tests/test_models.py), and the gradients of a fixed scalar of them
    w.r.t. every weight, leaf by leaf, within the two bounds of the CPU
    tests' step comparisons (tests/test_torch_train.py): 2e-4 of the leaf's
    largest entry + 1e-2 of the largest gradient (the leaves whose gradient
    is 1e-2 to 1e-5 of the largest carry the slope of the outputs' last-bit
    differences), and 0.15 of the leaf's largest entry + 1e-6 of the largest
    gradient (what a missing or mis-signed path breaks in any leaf)."""
    import dataclasses

    import numpy as np
    import torch

    from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment
    from hoig_torch.geometry.conditioning import ConditioningConfig
    from hoig_torch.train.model_api import batch_as_torch, flow_only
    from hoig_torch.train.trainer import TrainConfig, build_generator, generator_kwargs

    s = 128
    env = synthetic_environment(2, s, device="cuda")
    tables_np = env["tables_np"]
    tables_np.obj_tex = (np.random.RandomState(5).rand(*tables_np.obj_tex.shape) * 2 - 1).astype(
        np.float32)
    env = dict(env, tables=tables_np.as_torch("cuda"))
    batch = batch_as_torch(synthetic_batch(1, env["obj_verts"], image_size=s, seed=3), "cuda")
    flow = flow_only(batch, env, ConditioningConfig(image_size=s))
    kw = generator_kwargs({k: (None if v is None else v.clone()) for k, v in flow.items()},
                          batch["maskA"], batch["maskB"], True)
    cfg = TrainConfig(conv_dim=64, repeat_num=6, corner_engine="shift",
                      compute_dtype=torch.float32, remat=False)
    g_s = build_generator(cfg, device="cuda", seed=1)
    g_f = build_generator(dataclasses.replace(cfg, corner_engine="pallas"), device="cuda", seed=1)
    g_f.load_state_dict(g_s.state_dict())
    with torch.inference_mode():
        o_s, o_f = g_s(**kw), g_f(**kw)
    err = max(max_err(a, b) for a, b in zip(o_f, o_s))
    for i, (a, b) in enumerate(zip(o_f, o_s)):
        check(torch.allclose(a, b, rtol=2e-4, atol=2e-5),
              f"fused vs shift engine output {i}: max abs err {max_err(a, b)}")
    wgen = torch.Generator().manual_seed(7)
    weights = [torch.randn(o.shape, generator=wgen).cuda() for o in o_s]

    def grads(model):
        outs = model(**kw)
        scalar = sum((o.float() * w).sum() for o, w in zip(outs, weights))
        named = list(model.named_parameters())
        return dict(zip((n for n, _ in named), torch.autograd.grad(scalar, [p for _, p in named])))

    gr_s = grads(g_s)
    agree = grads_agree(grads(g_f), gr_s, "fused vs shift")
    log(f"  (d) engines agree, f32 128 px b1: outputs max abs err {err:.3g} (rtol 2e-4, atol 2e-5); "
        f"gradients w.r.t. {len(gr_s)} weight tensors worst {agree['grad_err_of_leaf_max']:.3g} of "
        f"a leaf's max (bound 0.15), {agree['grad_err_of_tree_max']:.3g} of the largest gradient "
        f"{agree['tree_max']:.3g} (bound 1e-2)")
    return dict(output_err=err, **agree)


def grads_agree(got: dict, ref: dict, label: str) -> dict:
    """Two gradients of every weight, leaf by leaf, within the two bounds of
    the CPU tests' step comparisons (see engines_agree); logs the three worst
    leaves and returns the worst errors and how many leaves are bit-equal."""
    import torch

    check(got.keys() == ref.keys(), f"{label}: gradients of other weights")
    tree_max = max(float(v.abs().max()) for v in ref.values())
    rows = []
    for name, r in ref.items():
        e, top = max_err(got[name], r), float(r.abs().max())
        check(bool(torch.isfinite(got[name]).all()), f"{label}: non-finite gradient of {name}")
        check(e <= 2e-4 * top + 1e-2 * tree_max and e <= 0.15 * top + 1e-6 * tree_max,
              f"gradient of {name}: {label} max abs err {e} (leaf max {top}, largest {tree_max})")
        rows.append((e / top if top > 1e-6 * tree_max else 0.0, e, top, name))
    rows.sort(reverse=True)
    for rel, e, top, name in rows[:3]:
        log(f"    {name}: max abs err {e:.3g}, {rel:.3g} of its largest entry {top:.3g}")
    return dict(grad_err_of_leaf_max=rows[0][0], grad_err_of_tree_max=max(r[1] for r in rows) / tree_max,
                tree_max=tree_max, bit_equal_leaves=sum(torch.equal(got[n], r) for n, r in ref.items()),
                leaves=len(ref))


def time_serving(gen, env, ccfg, batch, tcfg, expected: dict, n: int = 7) -> dict:
    """Host ms of n serving calls (conditioning, then generator) after two
    warm-up calls: the first runs eagerly and the second captures the CUDA
    graphs, each with `expected` launches (the second's are its warm-up on
    the capture stream: the capture launches nothing); the timed calls
    replay the graphs, so no wrapper runs and the counters stay at 0. Every
    call's outputs finite."""
    import torch

    from hoig_torch.ops import _cuda
    from hoig_torch.train.model_api import FLOW_GRAPHS, FORWARD_GRAPHS, flow_only, forward_only

    FLOW_GRAPHS.clear()
    FORWARD_GRAPHS.clear()
    for i in range(2):
        _cuda.reset_launch_counts()
        forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg)
        torch.cuda.synchronize()
        check(_cuda.launch_counts() == expected,
              f"warm-up call {i + 1} launches {_cuda.launch_counts()} != {expected}")
    torch.cuda.reset_peak_memory_stats()
    cond_ms, gen_ms = [], []
    for _ in range(n):
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        flow = flow_only(batch, env, ccfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        outs = forward_only(gen, flow, batch, tcfg)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        check(_cuda.launch_counts() == {},
              f"a replayed call counted launches {_cuda.launch_counts()}: it did not replay")
        check(all(torch.isfinite(o).all() for o in outs), "non-finite serving outputs")
        cond_ms.append((t1 - t0) * 1e3)
        gen_ms.append((t2 - t1) * 1e3)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    total = [a + b for a, b in zip(cond_ms, gen_ms)]
    serve = dict(conditioning_ms=statistics.median(cond_ms), generator_ms=statistics.median(gen_ms),
                 call_ms=statistics.median(total),
                 images_per_s=BATCH / (statistics.median(total) / 1e3),
                 peak_mem_mb=peak_mb, calls=len(total), cond_ms_all=cond_ms, gen_ms_all=gen_ms)
    log(f"  conditioning {serve['conditioning_ms']:.2f} ms, generator {serve['generator_ms']:.2f} ms,"
        f" call {serve['call_ms']:.2f} ms, {serve['images_per_s']:.2f} images/s, peak "
        f"{peak_mb:.0f} MiB (median of {len(total)})")
    return serve


def _same(a, b) -> bool:
    """Nests of dicts, tuples and tensors (or None) bit-equal."""
    import torch

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return (a is None and b is None) or torch.equal(a, b)


def graph_phase(env) -> dict:
    """Phase 5b: the serving calls' CUDA graphs (hoig_torch/train/call_graphs.py)
    against the eager bodies (flow_eager, forward_eager) at the benchmark's
    configurations, hogan_dexycb at batch 16 and hogan_ho3dv3 at batch 4 and
    at a partial batch of 3: five successive calls on rows of five seeds
    (call 1 eager, call 2 captured, 3-5 replayed; the launch counters move
    on calls 1 and 2 alone, by the same counts), every output of every
    call bit-equal to the eager bodies' on the same rows once all five have
    run (no call's outputs changed under a later one); then a weight scaled
    in place and a convolution's weight replaced by a new tensor, each seen
    by the next call (the second captures again). Times per call eager and
    replayed, the host ms of a replayed call, the weights' guard and the
    peak device memory."""
    import torch

    from benchmark.lib.program import conditioning_config, train_config
    from hoig_torch.data.synthetic import synthetic_batch
    from hoig_torch.ops import _cuda
    from hoig_torch.train import call_graphs
    from hoig_torch.train.model_api import (FLOW_GRAPHS, FORWARD_GRAPHS, batch_as_torch,
                                            flow_eager, flow_only, forward_eager, forward_only)
    from hoig_torch.train.trainer import build_generator

    def host_ms(fn, reps=5, sync=True):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            if sync:
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(times)

    out = {}
    for label, config, b in (("hogan_dexycb b16", "hogan_dexycb", 16),
                             ("hogan_ho3dv3 b4", "hogan_ho3dv3", 4),
                             ("hogan_ho3dv3 b3", "hogan_ho3dv3", 3)):
        cfg = json.loads((REPO / "benchmark" / "configs" / f"{config}.json").read_text())
        tcfg, ccfg = train_config(cfg), conditioning_config(cfg)
        gen = build_generator(tcfg, device="cuda", seed=0)
        batches = [batch_as_torch(synthetic_batch(b, env["obj_verts"], image_size=IMAGE,
                                                  seed=20 + i, camera=cfg["camera_model"],
                                                  with_masks=cfg["with_masks"]), "cuda")
                   for i in range(5)]
        FLOW_GRAPHS.clear()
        FORWARD_GRAPHS.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def eager(batch, gen=gen):
            flow = flow_eager(batch, env, ccfg)
            return flow, forward_eager(gen, flow, batch, tcfg)

        def graphed(batch, gen=gen):
            flow = flow_only(batch, env, ccfg)
            return flow, forward_only(gen, flow, batch, tcfg)

        want = [eager(bt) for bt in batches]
        repeat = _same(eager(batches[0]), want[0])
        got, counted = [], []
        for bt in batches:
            _cuda.reset_launch_counts()
            got.append(graphed(bt))
            counted.append(_cuda.launch_counts())
        torch.cuda.synchronize()
        differ = [i for i, (g, w) in enumerate(zip(got, want)) if not _same(g, w)]
        check(FLOW_GRAPHS.captures == FORWARD_GRAPHS.captures == 1,
              f"{label}: {FLOW_GRAPHS.captures} / {FORWARD_GRAPHS.captures} captures in 5 calls")
        check(counted[0] and counted[1] == counted[0] and not any(counted[2:]),
              f"{label}: launch counters per call {counted}: the eager call's launches on call 1 "
              "and on call 2 (its capture's warm-up), none on a replay")
        check(not differ, f"{label}: graphed calls {differ} differ from the eager bodies "
                          f"(eager bit-equal to itself: {repeat})")
        check(not _same(got[0][1], got[1][1]), f"{label}: calls on other rows gave the same images")
        peak = torch.cuda.max_memory_allocated()
        row = dict(calls=5, bit_equal=True, eager_repeats=repeat, peak_bytes=peak,
                   eager_call_ms=host_ms(lambda: eager(batches[1])),
                   graph_call_ms=host_ms(lambda: graphed(batches[1])),
                   graph_host_ms=host_ms(lambda: graphed(batches[1]), sync=False))
        live = call_graphs.module_tensors(gen)
        t0 = time.perf_counter()
        for _ in range(100):
            call_graphs.live_specs(call_graphs.module_tensors(gen))
        row.update(guard_us=(time.perf_counter() - t0) / 100 * 1e6, guarded_tensors=len(live))

        # a weight scaled in place, then a convolution's weight replaced
        flow0 = want[0][0]
        with torch.no_grad():
            next(gen.parameters()).mul_(1.25)
        moved = forward_only(gen, flow0, batches[0], tcfg)
        check(_same(moved, forward_eager(gen, flow0, batches[0], tcfg))
              and not _same(moved, want[0][1]) and FORWARD_GRAPHS.captures == 1,
              f"{label}: a weight scaled in place was not seen by the replay")
        conv = next(m for m in gen.modules() if isinstance(m, torch.nn.Conv2d))
        conv.weight = torch.nn.Parameter(conv.weight.detach() * 0.5)
        replaced = forward_only(gen, flow0, batches[0], tcfg)
        check(FORWARD_GRAPHS.captures == 2
              and _same(replaced, forward_eager(gen, flow0, batches[0], tcfg))
              and not _same(replaced, moved),
              f"{label}: a replaced weight was not captured again "
              f"({FORWARD_GRAPHS.captures} captures)")
        row.update(in_place_seen=True, replaced_recaptured=True)
        log(f"  {label}: 5 graphed calls bit-equal to eager (eager repeats: {repeat}), no output "
            f"changed under a later call; in-place weight seen, replaced weight recaptured; call "
            f"{row['eager_call_ms']:.2f} ms eager / {row['graph_call_ms']:.2f} ms replayed (host "
            f"{row['graph_host_ms']:.3f} ms of it), guard {row['guard_us']:.0f} us over "
            f"{len(live)} tensors, peak {peak} B")
        out[label] = row
        del gen, batches, want, got, moved, replaced, live
        FLOW_GRAPHS.clear()
        FORWARD_GRAPHS.clear()
        torch.cuda.empty_cache()
    return out


def fused_phase(env, ccfg, batch, gen_shift, tcfg_shift):
    """Phase 6 (see the module docstring). Returns (kernel results, the
    phase's numbers, a function that builds the profiler regions of the
    fused serving call and step). The phase frees its generator and training
    state before it returns, so that phase 7's memory peaks count the shift
    engine's alone; the returned function makes fresh ones for the profiler."""
    import dataclasses

    import torch

    from hoig_torch.models.generator import ExtractorAttn
    from hoig_torch.ops import _cuda
    from hoig_torch.train.model_api import flow_eager, flow_only, forward_eager, forward_only
    from hoig_torch.train.trainer import build_generator

    # (a) serving, from launch counters at 0, on the shift generator's weights
    tcfg = dataclasses.replace(tcfg_shift, corner_engine="pallas")
    gen = build_generator(tcfg, device="cuda", seed=0)
    gen.load_state_dict(gen_shift.state_dict())
    layer_inputs = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: layer_inputs.append((name, args)))
        for name, m in gen.named_modules() if isinstance(m, ExtractorAttn)]
    rec = Recorder()
    with recording(rec):
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        outs = forward_eager(gen, flow_eager(batch, env, ccfg), batch, tcfg)
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
    for h in hooks:
        h.remove()
    log(f"  (a) fused serving call launches: {launches}")
    check(launches == FUSED_LAUNCHES_PER_CALL,
          f"fused serving launches {launches} != {FUSED_LAUNCHES_PER_CALL}")
    check(all(torch.isfinite(o).all() for o in outs), "non-finite fused serving outputs")
    check(len(layer_inputs) == 9, f"{len(layer_inputs)} attention layers ran")
    results = {"attn_fused_fwd_tc": check_fused_kernel("attn_fused_fwd", rec.calls["attn_fused_fwd"])}
    del rec
    yard_fwd, yard_bwd = shift_yardstick(layer_inputs, gen_shift)
    log(f"  yardstick: the shift engine's ExtractorAttn on the same 9 layer inputs, forward "
        f"{yard_fwd:.3f} ms, backward {yard_bwd:.3f} ms")
    del layer_inputs
    log(f"  (e) fused serving call timing: {IMAGE} px, batch {BATCH}, bf16")
    serve = time_serving(gen, env, ccfg, batch, tcfg, FUSED_LAUNCHES_PER_CALL)

    # (b) one training step, remat off, from launch counters at 0
    log("  (b) fused training step: 256 px, batch 4, bf16, remat off")
    state, step = build_step(env, ccfg, train_config("pallas", remat=False))
    rec = Recorder()
    metrics, step_launches = recorded_step(state, step, batch, FUSED_LAUNCHES_PER_STEP, rec)
    for name in FUSED[1:]:
        check(len(rec.calls[name]) == 9, f"{name}: {len(rec.calls[name])} calls recorded")
        results[FUSED_BF16[name]] = check_fused_kernel(name, rec.calls[name])
    del rec
    for name in FUSED:
        r = results[FUSED_BF16[name]]
        r["launches"] = step_launches[FUSED_BF16[name]]
        r["yardstick_ms"] = yard_fwd if name == FUSED[0] else yard_bwd
        r["yardstick"] = ("shift-engine ExtractorAttn " +
                          ("forward" if name == FUSED[0] else "backward (all of it)"))

    ms, peak = timed_steps(state, step, batch, FUSED_LAUNCHES_PER_STEP, warm=3, n=6)
    med = statistics.median(ms)
    train = dict(step_ms=med, images_per_s=BATCH / (med / 1e3), peak_mem_mb=peak, steps=len(ms),
                 step_ms_all=ms, launches=step_launches, metrics=metrics)
    log(f"  (e) fused step {med:.2f} ms (median of {len(ms)}; {min(ms):.2f}-{max(ms):.2f}), "
        f"{train['images_per_s']:.2f} images/s, peak {peak:.0f} MiB")
    del state, step
    torch.cuda.empty_cache()

    # (b) the same first step (fresh weights from seed 0, same batch) three
    # times more: twice with remat off, then with the conv blocks and the
    # attention layers rematerialized (the recompute runs each layer's
    # forward again and takes the InstanceNorm statistics back). No op of the
    # step adds in an order that changes from run to run (the edge pads fold
    # their gradient in a fixed order: edge_pad_fold), so every gradient and
    # updated weight is bit-equal across the three. cuDNN is held to its
    # deterministic algorithms for these steps, so that a recompute under
    # other memory pressure does not pick another convolution algorithm
    log("  (b) the fused step again, twice remat off, then with remat and remat_attn on: "
        "bit for bit")
    first = fresh_step(env, ccfg, batch, train_config("pallas", remat=False),
                       FUSED_LAUNCHES_PER_STEP)
    n = bit_equal(fresh_step(env, ccfg, batch, train_config("pallas", remat=False),
                             FUSED_LAUNCHES_PER_STEP), first, "two fused steps with remat off")
    bit_equal(fresh_step(env, ccfg, batch, train_config(
        "pallas", remat=True, remat_bottleneck=False, remat_attn=True),
        FUSED_LAUNCHES_PER_STEP_REMAT), first, "the fused step with remat and remat_attn against "
        "remat off")
    train["remat_attn"] = dict(launches=FUSED_LAUNCHES_PER_STEP_REMAT, bit_equal_tensors=n)
    del first

    # (c) ragged shapes; (d) the engines agree
    ragged = check_fused_ragged()
    agree = engines_agree()

    del gen
    torch.cuda.empty_cache()

    def regions() -> dict:
        gen = build_generator(tcfg, device="cuda", seed=0)
        gen.load_state_dict(gen_shift.state_dict())
        state, step = build_step(env, ccfg, train_config("pallas", remat=False))
        for _ in range(2):  # warm-up: the graphs are captured before the profiler runs
            forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg)
        counted_step(state, step, batch, True, FUSED_LAUNCHES_PER_STEP)
        return {
            "hoig_serve_fused": (
                lambda: forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg), 2),
            "hoig_train_fused": (
                lambda: counted_step(state, step, batch, True, FUSED_LAUNCHES_PER_STEP), 1),
        }

    return results, dict(serving=serve, training=train, serving_launches=launches,
                         engines_agree=agree, ragged_rel_err=ragged), regions


def _png_size(path: Path) -> tuple[int, int]:
    """(width, height) from a PNG's IHDR chunk."""
    head = path.read_bytes()[:24]
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", f"{path} is not a PNG")
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


@contextlib.contextmanager
def patched(obj, name: str, make):
    """Replace obj.name by make(original) for the duration of the block."""
    import inspect

    raw = inspect.getattr_static(obj, name)
    setattr(obj, name, make(getattr(obj, name)))
    try:
        yield
    finally:
        setattr(obj, name, raw)


class DriverProbe:
    """Instruments the model facade while the drivers run: each train step
    from launch counters at 0 (synchronized, timed, launches kept), each
    forward likewise (its compute_losses flag, and the first call's batch and
    fakes), each model build and checkpoint save timed, set_input's start
    times (the loop's iterations), and the eval driver's PNG writes."""

    def __init__(self):
        self.steps, self.forwards, self.builds, self.saves = [], [], [], []
        self.inputs, self.pngs = [], []
        self.first = None

    def timed(self, fn):
        import torch

        # (no card: phase 13's CPU rehearsal)
        sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    @contextlib.contextmanager
    def attached(self):
        import eval_torch
        from hoig_torch.ops import _cuda
        from hoig_torch.train import model_api

        def make_step(orig_make):
            def make(*a, **k):
                step = orig_make(*a, **k)

                def counted(state, batch, d_trainable):
                    _cuda.reset_launch_counts()
                    out, s = self.timed(lambda: step(state, batch, d_trainable))
                    self.steps.append((s * 1e3, _cuda.launch_counts()))
                    return out
                return counted
            return make

        def forward(orig):
            def fwd(model, keep_data_for_visuals=False, compute_losses=True):
                _cuda.reset_launch_counts()
                out, s = self.timed(lambda: orig(model, keep_data_for_visuals, compute_losses))
                self.forwards.append((compute_losses, s * 1e3, _cuda.launch_counts()))
                if self.first is None:
                    self.first = (model._batch, [o.clone() for o in out])
                return out
            return fwd

        def build(orig):
            def get_by_name(*a, **k):
                model, s = self.timed(lambda: orig(*a, **k))
                self.builds.append(s)
                return model
            return staticmethod(get_by_name)

        def save(orig):
            def save_(model, label):
                _, s = self.timed(lambda: orig(model, label))
                self.saves.append(s)
            return save_

        def set_input(orig):
            def set_input_(model, batch):
                self.inputs.append((time.perf_counter(), model.is_train))
                return orig(model, batch)
            return set_input_

        def save_image(orig):
            def save_image_(image, path):
                t0 = time.perf_counter()
                orig(image, path)
                self.pngs.append((time.perf_counter(), time.perf_counter() - t0))
            return save_image_

        with contextlib.ExitStack() as stack:
            for obj, name, make in ((model_api, "make_train_step", make_step),
                                    (model_api.HOIGModel, "forward", forward),
                                    (model_api.ModelsFactory, "get_by_name", build),
                                    (model_api.HOIGModel, "save", save),
                                    (model_api.HOIGModel, "set_input", set_input),
                                    (eval_torch, "save_image", save_image)):
                stack.enter_context(patched(obj, name, make))
            yield self


def _eval_batches(probe: DriverProbe, t_end: float) -> list:
    """(wall ms, PNG ms) of each eval batch: from its set_input to the next
    one's (or to the driver's return)."""
    marks = [t for t, _ in probe.inputs] + [t_end]
    out = []
    for a, b in zip(marks, marks[1:]):
        png = sum(s for t, s in probe.pngs if a <= t <= b)
        out.append(((b - a) * 1e3, png * 1e3))
    return out


def driver_phase(out_dir: Path, serve: dict, train: dict) -> dict:
    """Phase 9: train_torch.Train for one epoch of 3 steps and eval_torch.main
    from its checkpoint, at full width on the synthetic dataset (see the
    module docstring). Returns the phase's numbers."""
    import shutil

    import torch

    import eval_torch
    import train_torch
    from hoig_torch.data.loader import CustomDatasetDataLoader
    from hoig_torch.options.train_options import TrainOptions
    from hoig_torch.train.model_api import flow_only, forward_only

    root = out_dir / "drivers"
    ck = root / "checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    common = ["--dataset_mode", "synthetic", "--image_size", str(IMAGE), "--batch_size",
              str(BATCH), "--conv_dim", "64", "--repeat_num", "6", "--bf16", "--use_spade",
              "--checkpoints_dir", str(ck), "--name", "drivers"]
    train_args = common + ["--use_vgg", "--mask_bce", "--synthetic_size", str(3 * BATCH),
                           "--nepochs_no_decay", "1", "--nepochs_decay", "0"]
    out = {}
    try:
        # the loader alone: three batches of the training split
        opt = TrainOptions().parse(train_args)
        t0 = time.perf_counter()
        n = sum(1 for _ in CustomDatasetDataLoader(opt, is_for_train=True).load_data())
        out["loader_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 / n
        check(n == 3, f"the loader gave {n} batches of {3 * BATCH} samples at batch {BATCH}")

        # 1. train_torch.Train: one epoch of 3 steps
        torch.cuda.reset_peak_memory_stats()
        with DriverProbe().attached() as probe:
            t0 = time.perf_counter()
            run = train_torch.Train(train_args)
            train_s = time.perf_counter() - t0
        out["train_peak_mem_mb"] = torch.cuda.max_memory_allocated() / 2**20
        check(len(probe.steps) == 3, f"{len(probe.steps)} train steps, not 3")
        for i, (_, launches) in enumerate(probe.steps):
            check(launches == LAUNCHES_PER_STEP_REMAT,
                  f"driver step {i + 1} launches {launches} != {LAUNCHES_PER_STEP_REMAT}")
        for losses, _, launches in probe.forwards:
            want = dict(LAUNCHES_PER_CALL, **NORMS_PER_EVAL_FORWARD) if losses else LAUNCHES_PER_CALL
            check(launches == want, f"driver forward launches {launches} != {want}")
        flags = [losses for losses, _, _ in probe.forwards]
        check(flags == [False, True], f"forwards in training (compute_losses) {flags}: the first "
              "display must run the visuals forward and one validation forward")
        errors = run.model.get_current_errors()
        check(all(math.isfinite(v) for v in errors.values()), f"non-finite errors {errors}")
        summary = json.loads((ck / "drivers" / "summary.json").read_text())
        log_text = (ck / "drivers" / "loss_log2.txt").read_text()
        check("Test/g_rec" in summary and "(V, epoch: 1" in log_text,
              "the first display did not log the validation losses")
        want = {f"{k}_epoch_1_id_{n}.pth" for k in ("net", "opt") for n in "GD"}
        files = set(p.name for p in (ck / "drivers").iterdir())
        check(want <= files, f"epoch-1 checkpoint files missing: {sorted(want - files)}")
        out["checkpoint_gb"] = sum((ck / "drivers" / f).stat().st_size for f in want) / 1e9
        g_saved = {k: v.detach().cpu().clone() for k, v in run.model._state.g.state_dict().items()}
        # the loop's iterations: from one training batch's set_input to the next
        starts = [t for t, is_train in probe.inputs if is_train]
        iters = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
        out.update(train_s=train_s, train_step_ms=statistics.median(s for s, _ in probe.steps),
                   train_step_ms_all=[s for s, _ in probe.steps], train_iteration_ms=iters,
                   direct_step_ms=train["remat"]["step_ms"], train_model_build_s=probe.builds[0],
                   checkpoint_save_s=probe.saves, train_errors=errors,
                   train_launches_per_step=probe.steps[0][1])
        log(f"  train_torch.Train: 3 steps, {statistics.median(s for s, _ in probe.steps):.2f} ms "
            f"per step (median; phase 7 with the same remat: {train['remat']['step_ms']:.2f}), "
            f"iterations {', '.join(f'{v:.1f}' for v in iters)} ms, model built in "
            f"{probe.builds[0]:.2f} s, saves {', '.join(f'{v:.2f}' for v in probe.saves)} s "
            f"({out['checkpoint_gb']:.2f} GB), peak {out['train_peak_mem_mb']:.0f} MiB")
        del run, probe
        torch.cuda.empty_cache()

        # 2. eval_torch.main from that checkpoint, shift engine: 2 batches
        def run_eval(label, extra, batches):
            dest = root / label
            args = common + ["--load_epoch", "1", "--synthetic_size", str(BATCH * batches),
                             "--output_dir", str(dest), *extra]
            torch.cuda.reset_peak_memory_stats()
            with DriverProbe().attached() as probe:
                model = eval_torch.main(args)
                t_end = time.perf_counter()
            peak = torch.cuda.max_memory_allocated() / 2**20
            check(len(probe.forwards) == batches, f"{label}: {len(probe.forwards)} forwards")
            for sub in ("source", "imitators", "gt"):
                pngs = sorted((dest / sub).glob("*.png"))
                check(len(pngs) == BATCH * batches, f"{label}/{sub}: {len(pngs)} PNGs")
                check(all(_png_size(p) == (IMAGE, IMAGE) for p in pngs),
                      f"{label}/{sub}: a PNG is not {IMAGE}x{IMAGE}")
            return model, probe, _eval_batches(probe, t_end), peak

        model, probe, batches, peak = run_eval("eval_shift", [], 2)
        g_loaded = model._state.g.state_dict()
        check(g_loaded.keys() == g_saved.keys() and all(
            torch.equal(g_loaded[k].cpu(), v) for k, v in g_saved.items()),
            "the G eval_torch loaded is not bit-equal to the G train_torch saved")
        for _, _, launches in probe.forwards:
            check(launches == LAUNCHES_PER_CALL, f"eval batch launches {launches}")
        batch, fakes = probe.first
        ref = forward_only(model._state.g, flow_only(batch, model._frozen, model._ccfg), batch,
                           model._tcfg)
        check(all(torch.equal(a, b) for a, b in zip(fakes, ref)),
              "HOIGModel.forward's fakes differ from flow_only + forward_only on batch 1")
        out.update(eval_model_build_s=probe.builds[0], eval_peak_mem_mb=peak,
                   eval_batch_ms=[w for w, _ in batches], eval_png_ms=[p for _, p in batches],
                   eval_batch_ms_without_png=[w - p for w, p in batches],
                   eval_forward_ms=[s for _, s, _ in probe.forwards],
                   serving_call_ms=serve["call_ms"], eval_launches_per_batch=probe.forwards[0][2])
        log(f"  eval_torch.main (shift): batches {', '.join(f'{w:.1f}' for w, _ in batches)} ms, "
            f"without the PNG writes {', '.join(f'{w - p:.1f}' for w, p in batches)} ms (phase 5's "
            f"serving call {serve['call_ms']:.2f} ms); loaded G bit-equal to the saved G; the "
            f"facade's fakes bit-equal to flow_only + forward_only; model built in "
            f"{probe.builds[0]:.2f} s, peak {peak:.0f} MiB")
        del model, probe, batch, fakes, ref, g_loaded
        torch.cuda.empty_cache()

        # 3. the fused engine from the command line: 1 batch
        model, probe, batches, _ = run_eval("eval_fused", ["--corner_engine", "pallas"], 1)
        launches = probe.forwards[0][2]
        check(launches == FUSED_LAUNCHES_PER_CALL,
              f"fused eval launches {launches} != {FUSED_LAUNCHES_PER_CALL}")
        out.update(eval_fused_batch_ms=batches[0][0], eval_fused_launches_per_batch=launches)
        log(f"  eval_torch.main --corner_engine pallas: 1 batch {batches[0][0]:.1f} ms, "
            f"launches {launches}")
        del model, probe
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(ck, ignore_errors=True)  # about 2.3 GB per save
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def ddp_phase(env, ccfg, fp32_ref: dict) -> dict:
    """Phase 10a: the data-parallel step (hoig_torch.parallel.DataParallel)
    in an NCCL process group of world size 1, at full width (see the module
    docstring); and the fp32 step's (phase 7e) against fp32_ref, the
    one-process step's tensors. Returns its numbers."""
    import torch
    import torch.distributed as dist

    from hoig_torch import parallel
    from hoig_torch.data.synthetic import synthetic_batch
    from hoig_torch.models.vgg import init_vgg
    from hoig_torch.ops import _cuda
    from hoig_torch.train.model_api import batch_as_torch
    from hoig_torch.train.trainer import build_networks, init_state, make_train_step

    batch = batch_as_torch(synthetic_batch(BATCH, env["obj_verts"], image_size=IMAGE), "cuda")
    tcfg = train_config("shift", remat=False)

    def one_step(sync: bool, tcfg=tcfg, batch=batch, expected=LAUNCHES_PER_STEP):
        """A fresh state (seed 0) and one step with D's gate on, launches from
        counters at 0; its G and D gradients and weights after the step."""
        state = init_state(*build_networks(tcfg, device="cuda", seed=0), tcfg)
        dp = parallel.DataParallel(state) if sync else None
        step = make_train_step(init_vgg(seed=2, compute_dtype=tcfg.compute_dtype, device="cuda"),
                               env["tables"], env["mano_params"], ccfg, tcfg, sync=dp)
        torch.backends.cudnn.deterministic = True
        try:
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            state, metrics = step(state, batch, True)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.deterministic = False
        launches = _cuda.launch_counts()
        check(launches == expected,
              f"{'data-parallel' if sync else 'one-process'} step launches {launches}")
        check(all(bool(torch.isfinite(v)) for v in metrics.values()), f"non-finite {metrics}")
        nets = (("g", state.g), ("d", state.d))
        tensors = {f"{kind} {n}.{k}": (p.grad if kind == "grad" else p).detach().clone()
                   for kind in ("grad", "weight") for n, net in nets
                   for k, p in net.named_parameters()}
        return state, dp, launches, tensors, metrics

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        log("  (a) NCCL process group of world size 1, one card")
        out = {}
        state, _, _, ref, ref_m = one_step(sync=False)
        del state
        # two one-process steps, and the data-parallel step against them: every
        # gradient and updated weight bit-equal (one rank: the all-reduce sums
        # one buffer and divides by 1)
        n = bit_equal(one_step(sync=False)[3], ref, "two one-process steps")
        torch.cuda.empty_cache()
        state, dp, launches, dp_t, dp_m = one_step(sync=True)
        want = {"broadcast_gate": 1, "all_reduce_g": 1, "all_reduce_d": 1, "all_reduce_metrics": 1}
        check(dict(dp.collectives) == want, f"data-parallel step collectives {dict(dp.collectives)}")
        bit_equal(dp_t, ref, "the data-parallel step against the one-process step")
        metric_err = max(abs(float(dp_m[k]) - float(ref_m[k])) / max(abs(float(ref_m[k])), 1e-6)
                         for k in ref_m)
        # one rank: the averaged metrics are the step's own (a sanity bound;
        # the two-rank means are held to the global batch's by the CPU tests)
        check(metric_err <= 1e-2, f"data-parallel metrics {dp_m} vs one process {ref_m}")
        n_g = dp.flat["g"].numel()
        n_d = dp.flat["d"].numel()
        ms_g = device_ms(lambda: dist.all_reduce(dp.flat["g"]))
        ms_d = device_ms(lambda: dist.all_reduce(dp.flat["d"]))
        bound_g, _ = bound_ms(2 * 4 * n_g, 0.0)
        bound_d, _ = bound_ms(2 * 4 * n_d, 0.0)
        out.update(launches=launches, collectives=dict(dp.collectives), bit_equal_tensors=n,
                   metrics_max_rel_err=metric_err, all_reduce_g_ms=ms_g, all_reduce_d_ms=ms_d,
                   all_reduce_g_bound_ms=bound_g, all_reduce_d_bound_ms=bound_d,
                   all_reduce_g_mb=4 * n_g / 1e6, all_reduce_d_mb=4 * n_d / 1e6)
        log(f"  data-parallel step: kernel launches {launches} (phase 7's), collectives "
            f"{dict(dp.collectives)}; its {n} gradients and updated weights bit-equal to the "
            f"one-process step's; metrics within {metric_err:.3g} relative")
        log(f"  all_reduce of the flat f32 gradients: G {n_g / 1e6:.1f} M ({4 * n_g / 1e6:.0f} MB) "
            f"{ms_g:.4f} ms (read + write bound {bound_g:.4f}), D {n_d / 1e6:.1f} M {ms_d:.4f} ms "
            f"(bound {bound_d:.4f}); one rank, so NCCL has no peer to reduce with")
        del state, dp, ref, dp_t
        torch.cuda.empty_cache()
        # the fp32 step as the drivers run it (phase 7e) through DataParallel
        state, dp, _, dp_t, _ = one_step(True, fp32_config(), fp32_batch(env),
                                         FP32_LAUNCHES_PER_STEP)
        check(dict(dp.collectives) == want, f"fp32 data-parallel collectives {dict(dp.collectives)}")
        out["fp32_bit_equal_tensors"] = bit_equal(
            {k: v.cpu() for k, v in dp_t.items()}, fp32_ref,
            f"the fp32 batch-{FP32_BATCH} data-parallel step against phase 7e's one-process step")
        del state, dp, dp_t
    finally:
        parallel.shutdown()
        torch.cuda.empty_cache()
    return out


def torchrun_phase(out_dir: Path, drivers: dict) -> dict:
    """Phase 10b: train_torch.py under torchrun, one process, 3 synthetic
    steps at full width; its iterations from its log beside phase 9's."""
    import os
    import shutil
    import signal

    root = out_dir / "torchrun"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           str(REPO / "train_torch.py"), "--dataset_mode", "synthetic", "--image_size",
           str(IMAGE), "--batch_size", str(BATCH), "--conv_dim", "64", "--repeat_num", "6",
           "--bf16", "--use_spade", "--use_vgg", "--mask_bce", "--synthetic_size", str(3 * BATCH),
           "--nepochs_no_decay", "1", "--nepochs_decay", "0", "--print_freq_s", "0",
           "--checkpoints_dir", str(root / "ck"), "--name", "ddp"]
    log_path = root / "train.log"
    t0 = time.perf_counter()
    try:
        with open(log_path, "w") as fp:
            proc = subprocess.Popen(cmd, cwd=REPO, stdout=fp, stderr=subprocess.STDOUT,
                                    start_new_session=True)
            try:
                rc = proc.wait(timeout=400)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
                rc = "timeout"
        wall = time.perf_counter() - t0
        text = log_path.read_text()
        check(rc == 0, f"torchrun train_torch.py exited {rc}:\n{text[-3000:]}")
        t_smpl = [float(m) for m in re.findall(r"\(Tv?, epoch: 1, it: \d+/[\d.]+, t/smpl: "
                                                 r"([\d.]+)s\)", text)]
        check(len(t_smpl) == 3, f"torchrun run logged {len(t_smpl)} iterations, not 3")
        files = {p.name for p in (root / "ck" / "ddp").iterdir()}
        want = {f"{k}_epoch_1_id_{n}.pth" for k in ("net", "opt") for n in "GD"}
        check(want <= files, f"torchrun run's checkpoints missing: {sorted(want - files)}")
    finally:
        shutil.rmtree(root / "ck", ignore_errors=True)  # about 2.3 GB
    iters = [t * BATCH * 1e3 for t in t_smpl]
    log(f"  (b) torchrun --nproc_per_node 1 train_torch.py: exit 0 after {wall:.1f} s; iterations "
        f"{', '.join(f'{v:.0f}' for v in iters)} ms (its log's t/smpl x batch {BATCH}); phase 9's "
        f"iterations {', '.join(f'{v:.0f}' for v in drivers['train_iteration_ms'])} ms, steps "
        f"{', '.join(f'{v:.0f}' for v in drivers['train_step_ms_all'])} ms")
    return dict(wall_s=wall, iteration_ms=iters, phase9_iteration_ms=drivers["train_iteration_ms"],
                phase9_step_ms=drivers["train_step_ms_all"])


def metrics_phase(out_dir: Path) -> dict:
    """Phase 10c: FID, LPIPS, SSIM and MS-SSIM over phase 9's eval tree, on
    the card and on the CPU, with seeded random network weights."""
    import numpy as np
    import torch

    from hoig_torch.metrics import fid, image_loader, lpips
    from hoig_torch.metrics.inception import init_inception
    from hoig_torch.metrics.precision import f32_exact
    from hoig_torch.metrics.ssim import calculate_ssim_given_paths
    from hoig_torch.utils.util import read_png

    tree = out_dir / "drivers" / "eval_shift"
    pair = [str(tree / "imitators"), str(tree / "gt")]
    files = [str(p) for sub in pair for p in sorted(Path(sub).glob("*.png"))]
    check(len(files) == 4 * BATCH, f"the eval tree holds {len(files)} PNGs, not {4 * BATCH}")
    out = {"images": len(files)}

    # per image, on the host: decode, then the loader's resize (256 -> 299)
    t0 = time.perf_counter()
    imgs = [read_png(f) for f in files]
    out["decode_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / len(files)
    t0 = time.perf_counter()
    for img in imgs:
        image_loader.pil_bilinear_resize(img, (299, 299))
    out["resize_ms_per_image"] = (time.perf_counter() - t0) * 1e3 / len(files)
    # per image, on the card: the Inception (its 256 -> 299 resize included)
    # and LPIPS, a batch of 8 at a time
    x = torch.from_numpy(np.stack(imgs[:BATCH * 2]).astype(np.float32) / 255.0).permute(
        0, 3, 1, 2).contiguous().cuda()
    net = init_inception().cuda()
    lp = lpips.init_lpips().cuda()
    y = torch.nn.functional.interpolate(x, size=(299, 299), mode="bilinear")
    with torch.no_grad(), f32_exact():
        out["inception_ms_per_image"] = device_ms(lambda: net(x), reps=5,
                                                  behind_sleep=False) / x.shape[0]
        out["lpips_ms_per_image"] = device_ms(lambda: lp(y, y.flip(0)), reps=5,
                                              behind_sleep=False) / x.shape[0]
    del x, y, net, lp

    stats = {}
    for dev in ("cuda", "cpu"):
        model_fn = fid.make_inception(None, device=dev)
        stats[dev] = [fid.compute_statistics_of_path(p, model_fn, batch_size=2 * BATCH)
                      for p in pair]
    fids = {dev: fid.calculate_frechet_distance(*s[0], *s[1]) for dev, s in stats.items()}
    same = fid.calculate_frechet_distance(*stats["cuda"][1], *stats["cuda"][1])
    lp = {dev: lpips.calculate_lpips_given_paths(pair, IMAGE, 2 * BATCH, device=dev)
          for dev in ("cuda", "cpu")}
    ss = {dev: calculate_ssim_given_paths(pair, IMAGE, 2 * BATCH, device=dev)
          for dev in ("cuda", "cpu")}
    check(all(math.isfinite(v) for v in (*fids.values(), *lp.values(), *ss["cuda"], *ss["cpu"])),
          f"non-finite metrics: FID {fids}, LPIPS {lp}, SSIM {ss}")
    # the CPU tests' bounds: FID 1e-3 relative, LPIPS 1e-5 relative, SSIM 1e-5
    check(abs(fids["cuda"] - fids["cpu"]) <= 1e-3 * abs(fids["cpu"]),
          f"FID card {fids['cuda']} vs CPU {fids['cpu']}")
    check(abs(lp["cuda"] - lp["cpu"]) <= 1e-5 * abs(lp["cpu"]),
          f"LPIPS card {lp['cuda']} vs CPU {lp['cpu']}")
    check(all(abs(a - b) <= 1e-5 for a, b in zip(ss["cuda"], ss["cpu"])),
          f"SSIM / MS-SSIM card {ss['cuda']} vs CPU {ss['cpu']}")
    check(abs(same) < 1e-3, f"FID of gt/ against itself {same}")
    out.update(fid=fids, fid_self=same, lpips=lp, ssim={d: v[0] for d, v in ss.items()},
               ms_ssim={d: v[1] for d, v in ss.items()})
    log(f"  (c) metrics over phase 9's eval tree ({len(files) // 2} pairs, seeded random "
        f"Inception and LPIPS weights: only the times mean anything): FID card {fids['cuda']:.6g} / "
        f"CPU {fids['cpu']:.6g}, gt against itself {same:.3g}; LPIPS {lp['cuda']:.6g} / "
        f"{lp['cpu']:.6g}; SSIM {ss['cuda'][0]:.6f} / {ss['cpu'][0]:.6f}, MS-SSIM "
        f"{ss['cuda'][1]:.6f} / {ss['cpu'][1]:.6f}")
    log(f"  per image: decode {out['decode_ms_per_image']:.2f} ms, resize 256 -> 299 "
        f"{out['resize_ms_per_image']:.2f} ms (host); Inception {out['inception_ms_per_image']:.3f} "
        f"ms, LPIPS {out['lpips_ms_per_image']:.3f} ms (card, f32, TF32 off)")
    return out


# ---------------------------------------------------------------------------
# 11. off the main path: the generic renderer, the exact rasterizer
# gradients, the block extractor, the UV fit and the resume from a JAX epoch
# ---------------------------------------------------------------------------

# B2 and B3 per hard map: one z-buffer call (bin_kernel + raster_kernel) and
# one finish gather
RENDER_LAUNCHES = {"rasterizer": 1, "table_gather": 1}
# scatter_rows launches of one exact-gradient forward + backward: the vertex
# gradient through vertices_to_faces (the RGB's lighting reads the faces a
# second time), the depth backward's per-face sums, the texture sampler's
EXACT_SCATTERS = {"silhouettes": 1, "depth": 2, "rgb": 3}
# phase 11's sizes besides IMAGE and BATCH: the exact gradients' card-vs-CPU
# image, the block extractor's layer (hw^2, channels), the UV fit's atlas
# size, its steps and the steps it is held against the CPU for
OFF_CMP_IMAGE = 64
OFF_BLOCK_HW, OFF_BLOCK_CH = 32, 512
UV_SIZE, UV_STEPS, UV_CMP_STEPS = 224, 2000, 50


def _counted(fn, dev: str, expected: dict, label: str):
    """fn() from launch counters at 0 -> (its result, the launches); on the
    card the launches must be `expected`."""
    import torch

    from hoig_torch.ops import _cuda

    if dev == "cuda":
        torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    out = fn()
    if dev == "cuda":
        torch.cuda.synchronize()
    got = _cuda.launch_counts()
    if dev == "cuda":
        check(got == expected, f"{label}: launches {got} != {expected}")
    return out, got


def _host_ms(fn, dev: str, reps: int = 3) -> float:
    """Median host ms of fn() ending in a synchronize (after one warm call)."""
    import torch

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    fn()
    sync()
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ms)


def _peak_mib(fn, dev: str) -> float | None:
    import torch

    if dev != "cuda":
        fn()
        return None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def _tile_list_peak(bbox, edge, s: int, tile: int) -> int:
    """The most faces bin_kernel lists for one tile of this scene."""
    return int(_tile_lists(bbox, edge, s, tile)[1].sum(1).max())


def _renderer_maps(env, dev: str, image: int, batch: int) -> dict:
    """(a) renderer.render_fim_wim / render_silhouettes / render_depth at
    `image` px and render_rgb at 2 x `image` (2x anti-aliasing), on the HOGAN
    tables and cameras, batch `batch`, textures of size 3; then the B2 / B3
    boundary held strictly: render_rgb's first sample against the plain CPU
    path, and the whole batch at image and 2 x image against the plain
    z-buffer and gather run on the card's own tensors."""
    import torch

    from hoig_torch.data.synthetic import synthetic_theta
    from hoig_torch.geometry import renderer as rend
    from hoig_torch.geometry.conditioning import ConditioningConfig, get_details
    from hoig_torch.ops.rasterizer import _face_setup, finish, zbuffer_reference
    from hoig_torch.ops.rasterizer_cuda import LIST_CAP, TILE, face_bbox, rasterize_fim_wim_auto
    from hoig_torch.ops.table_gather import gather_rows_reference
    from hoig_torch.ops.texture import lighting, sample_textures_trilinear

    ccfg = ConditioningConfig(image_size=image)
    theta = synthetic_theta(batch, env["obj_verts"], seed=11, image_size=image)
    det = get_details(env["mano_params"],
                      {k: torch.as_tensor(v, device=dev) for k, v in theta.items()}, ccfg)
    f_max = env["tables"]["faces"].shape[1]
    gen = torch.Generator().manual_seed(12)
    tex = torch.rand((batch, f_max, 3, 3, 3, 3), generator=gen).to(dev)
    on_dev = (env["tables"], det["cam"], det["verts"], det["obj_id"])
    tables_cpu = env["tables_np"].as_torch("cpu")
    on_cpu = (tables_cpu, det["cam"].cpu(), det["verts"].cpu(), det["obj_id"].cpu())
    calls = {
        "render_fim_wim": lambda a, t: rend.render_fim_wim(*a, image_size=image),
        "render_silhouettes": lambda a, t: rend.render_silhouettes(*a, image_size=image),
        "render_depth": lambda a, t: rend.render_depth(*a, image_size=image),
        "render_rgb": lambda a, t: rend.render_rgb(a[0], a[1], a[2], t, a[3], image_size=image),
    }
    # the plain CPU path on the first samples (its z-buffer takes about 10 s
    # per 512^2 image on eight cores): two at image px, one at 2 x image
    first = lambda a, n: (a[0], *(x[:n] for x in a[1:]))
    out, got, res = {}, {}, {}
    for name, fn in calls.items():
        n = 1 if name == "render_rgb" else 2
        got[name], launches = _counted(lambda: fn(on_dev, tex), dev, RENDER_LAUNCHES, name)
        res[name] = fn(first(on_cpu, n), tex[:n].cpu())
        got[name] = tuple(x[:n] for x in got[name]) if isinstance(got[name], tuple) \
            else got[name][:n]
        out[name] = dict(ms=_host_ms(lambda: fn(on_dev, tex), dev), launches=launches)
    # end to end: the camera projection's matrix products round on the card
    # as cuBLAS does (f2pts differ by an ulp), and a barycentric weight
    # moves by that ulp over the face's area: held as phase 4 holds the
    # conditioning, at most 1e-3 of the elements off by more than 1e-4
    _, fim_g, wim_g = got["render_fim_wim"]
    f2_c, fim_c, wim_c = res["render_fim_wim"]
    fim_g = fim_g.cpu()
    share = float((fim_g != fim_c).float().mean())
    e_f2 = max_err(got["render_fim_wim"][0].cpu(), f2_c)
    offs = {"fim": share, "silhouettes": float(
        (got["render_silhouettes"].cpu() != res["render_silhouettes"]).float().mean())}
    errs = {}
    for key, a, b in (("wim", wim_g.cpu(), wim_c), ("depth", got["render_depth"].cpu(),
                                                     res["render_depth"]),
                      ("rgb", got["render_rgb"].cpu(), res["render_rgb"])):
        offs[key] = float(((a - b).abs() > 1e-4).float().mean())
        errs[key] = max_err(a, b)
    check(all(v <= 1e-3 for v in offs.values()) and e_f2 <= 1e-5,
          f"renderer maps card vs CPU: shares off {offs}, f2pts {e_f2}")
    hits = int((fim_g >= 0).sum())
    check(hits > 0.01 * fim_g.numel(), f"the hands cover {hits} pixels only")

    # strictly at the kernels' boundary: render_rgb's face corners at 2 x
    # image, the same inputs on both sides (B2 + B3 on the card, the plain
    # z-buffer and gather on the CPU)
    s2 = 2 * image
    _, fv, faces, valid = rend._project(*on_dev, image, "matrix")
    fim2, wim2, d2 = rasterize_fim_wim_auto(fv, valid, image_size=s2, near=0.1, far=25.0,
                                           depth=True)
    fim2c, wim2c, d2c = rasterize_fim_wim_auto(fv[:1].cpu(), valid[:1].cpu(), image_size=s2,
                                              near=0.1, far=25.0, depth=True)
    check(torch.equal(fim2[:1].cpu(), fim2c),
          "render_rgb's fim differs card vs CPU on the same faces")
    e_wim2, e_d2 = max_err(wim2[:1].cpu(), wim2c), max_err(d2[:1].cpu(), d2c)
    lit = lighting(rend.vertices_to_faces(det["verts"], faces), tex)
    rgb2 = sample_textures_trilinear(lit[:1], fim2[:1], wim2[:1])
    rgb2c = sample_textures_trilinear(lit[:1].cpu(), fim2c, wim2c)
    e_rgb2 = max_err(rgb2.cpu(), rgb2c)
    check(e_wim2 <= 1e-6 and e_d2 <= 1e-6 and e_rgb2 <= 1e-5,
          f"render_rgb at the kernels' boundary: wim {e_wim2}, depth {e_d2}, rgb {e_rgb2}")
    # the whole batch at both sizes: B2 + B3 against the plain z-buffer and
    # gather on the same card tensors (no kernel on that side)
    plain = {}
    for s in (image, s2):
        kern = (fim2, wim2, d2) if s == s2 else rasterize_fim_wim_auto(
            fv, valid, image_size=s, near=0.1, far=25.0, depth=True)
        setup = _face_setup(fv, valid, s)
        ref = finish(zbuffer_reference(setup, s, 0.1, 25.0), setup["finv"], None, s,
                     gather=gather_rows_reference, z=setup["z"], far=25.0)
        plain[s] = dict(fim_equal=[bool(torch.equal(a, b)) for a, b in zip(kern[0], ref[0])],
                        wim_err=max_err(kern[1], ref[1]), depth_err=max_err(kern[2], ref[2]))
        check(all(plain[s]["fim_equal"]) and plain[s]["wim_err"] <= 1e-6
              and plain[s]["depth_err"] <= 1e-6,
              f"B2 + B3 vs the plain z-buffer and gather on the card at {s}^2: {plain[s]}")
    peak = _tile_list_peak(face_bbox(fv, setup["keep"]), setup["edge"], s2, TILE)
    check(peak <= LIST_CAP, f"a tile lists {peak} faces at {s2}^2, over LIST_CAP {LIST_CAP}")
    log(f"  (a) renderer maps, {batch} x {image}^2 (render_rgb at {s2}^2), faces "
        f"{tuple(fv.shape[:2])}, hit pixels {hits}: launches per call "
        + ", ".join(f"{k} {v['launches']}" for k, v in out.items())
        + "; ms per call " + ", ".join(f"{k} {v['ms']:.2f}" for k, v in out.items()))
    log(f"      card vs CPU end to end (2 samples, render_rgb 1): f2pts {e_f2:.3g}, shares "
        "off (fim, silhouettes: any; the rest > 1e-4) " + ", ".join(
            f"{k} {v:.3g}" for k, v in offs.items()) + ", max errors " + ", ".join(
            f"{k} {v:.3g}" for k, v in errs.items()) + f"; on the same faces at {s2}^2 (1 "
        f"sample): fim equal, wim {e_wim2:.3g}, depth {e_d2:.3g}, rgb {e_rgb2:.3g}; "
        f"most faces in one tile's list {peak} (LIST_CAP {LIST_CAP})")
    log(f"      B2 + B3 vs the plain z-buffer and gather on the card's tensors, all {batch} "
        "samples: " + "; ".join(
            f"{s}^2 fim equal {sum(p['fim_equal'])}/{len(p['fim_equal'])}, wim "
            f"{p['wim_err']:.3g}, depth {p['depth_err']:.3g}" for s, p in plain.items())
        + " (bounds: fim equal, 1e-6)")
    return dict(calls=out, f2pts_err=e_f2, share_off=offs, max_err=errs,
                boundary=dict(wim_err=e_wim2, depth_err=e_d2, rgb_err=e_rgb2),
                plain_on_card={str(s): p for s, p in plain.items()},
                tile_list_peak=peak, faces=list(fv.shape[:2]), hits=hits)


def _renderer_mesh(env, batch: int, dev: str):
    """The hand and the first object as one mesh around the origin (B, V, 3),
    its valid faces (F, 3), and textures of size 3 (B, F, 3, 3, 3, 3)."""
    import torch

    from hoig_torch.data.synthetic import synthetic_theta
    from hoig_torch.geometry.conditioning import ConditioningConfig, get_details

    theta = synthetic_theta(batch, env["obj_verts"][:1], seed=13)  # every sample holds object 0
    det = get_details(env["mano_params"],
                      {k: torch.as_tensor(v, device=dev) for k, v in theta.items()},
                      ConditioningConfig())
    v = det["verts"] - det["verts"].mean(1, keepdim=True)
    v = v / v.abs().amax(dim=(1, 2), keepdim=True)
    nf = int(env["tables_np"].num_faces[0])
    faces = env["tables"]["faces"][0, :nf]
    gen = torch.Generator().manual_seed(14)
    tex = torch.rand((batch, nf, 3, 3, 3, 3), generator=gen).to(dev)
    return v, faces, tex


def _renderer_objects(env, dev: str, image: int, batch: int) -> dict:
    """(b) neural_renderer_api.Renderer (look_at camera, 2x anti-aliasing):
    RGB at 2 x image with get_fim, silhouettes at 2 x image, depth at image,
    against the CPU; soft silhouettes forward and vertex gradient with the
    peak memory."""
    import torch

    from hoig_torch.geometry.neural_renderer_api import Renderer

    v, faces, tex = _renderer_mesh(env, batch, dev)
    r = Renderer(image_size=image)
    two = {"rasterizer": 2, "table_gather": 2}  # the 2x map and the fim at image
    calls = {
        "render": (lambda a: r.render(*a, get_fim=True), two),
        "render_silhouettes": (lambda a: r.render_silhouettes(*a[:2]), RENDER_LAUNCHES),
        "render_depth": (lambda a: r.render_depth(*a[:2]), RENDER_LAUNCHES),
    }
    out = {}
    args_d, args_c = (v, faces, tex), (v[:1].cpu(), faces.cpu(), tex[:1].cpu())
    for name, (fn, want) in calls.items():
        got, launches = _counted(lambda: fn(args_d), dev, want, name)
        ref = fn(args_c)  # the first sample on the CPU
        ms = _host_ms(lambda: fn(args_d), dev)
        if name == "render":
            (rgb, fim), (rgb_c, fim_c) = got, ref
            share = float((fim[:1].cpu() != fim_c).float().mean())
            err = float(((rgb[:1].cpu() - rgb_c).abs() > 1e-5).float().mean())
        else:
            share = float(((got[:1].cpu() - ref).abs() > 1e-6).float().mean())
            err = max_err(got[:1].cpu(), ref)
        check(share <= 1e-3 and (name != "render" or err <= 1e-3),
              f"Renderer.{name} card vs CPU: {share:.3g} of the pixels differ ({err})")
        out[name] = dict(ms=ms, launches=launches, share_off=share, err=err)

    # soft coverage at image px: forward and the vertex gradient of a fixed
    # weighting; card vs CPU on the first sample
    gen = torch.Generator().manual_seed(15)
    w = torch.randn((batch, image, image), generator=gen).to(dev)

    def soft(vv, ww):
        x = vv.clone().requires_grad_()
        sil = r.render_silhouettes(x, faces.to(vv.device), soft=True)
        (sil * ww).sum().backward()
        return sil.detach(), x.grad

    ms = _host_ms(lambda: soft(v, w), dev)
    mib = _peak_mib(lambda: soft(v, w), dev)
    sil_g, grad_g = soft(v[:1], w[:1])
    sil_c, grad_c = soft(v[:1].cpu(), w[:1].cpu())
    e_sil = max_err(sil_g.cpu(), sil_c)
    top = float(grad_c.abs().max())
    e_grad = max_err(grad_g.cpu(), grad_c)
    check(e_sil <= 1e-6 and e_grad <= 1e-5 * top,
          f"soft silhouettes card vs CPU: values {e_sil}, vertex gradient {e_grad} (max {top})")
    out["soft_silhouette"] = dict(ms=ms, peak_mib=mib, err=e_sil, grad_err=e_grad,
                                  grad_max=top)
    log(f"  (b) Renderer (look_at, 2x anti-aliasing), {batch} x {image}^2, faces "
        f"{tuple(faces.shape)}: " + "; ".join(
            f"{k} {o['ms']:.2f} ms, launches {o.get('launches')}" for k, o in out.items()
            if "launches" in o)
        + "; card vs CPU (1 sample): share of values off " + ", ".join(
            f"{k} {o['share_off']:.3g}" for k, o in out.items() if "share_off" in o))
    log(f"      soft silhouettes forward + vertex gradient {ms:.2f} ms, peak {mib} MiB above the "
        f"live tensors; card vs CPU (one sample): values {e_sil:.3g}, gradient {e_grad:.3g} "
        f"(bound 1e-5 of its max {top:.3g})")
    return out


def _exact_vjps(env, dev: str, image: int, batch: int, cmp_image: int) -> dict:
    """(c) the exact-gradient Functions through Renderer(exact_grad=True):
    forward + backward time, launches and peak memory at image (2x
    anti-aliasing for the silhouette and RGB), then the vertex and texture
    gradients card vs CPU on one sample at cmp_image."""
    import torch

    from hoig_torch.geometry.neural_renderer_api import Renderer

    v, faces, tex = _renderer_mesh(env, batch, dev)
    gen = torch.Generator().manual_seed(16)

    def run(r, vv, tt, which, w):
        x = vv.clone().requires_grad_()
        t = tt.clone().requires_grad_()
        if which == "silhouettes":
            out = r.render_silhouettes(x, faces.to(vv.device), exact_grad=True)
        elif which == "depth":
            out = r.render_depth(x, faces.to(vv.device), exact_grad=True)
        else:
            out = r.render(x, faces.to(vv.device), t, exact_grad=True)
        (out * w).sum().backward()
        return out.detach(), x.grad, t.grad

    res = {}
    for which in ("silhouettes", "depth", "rgb"):
        r = Renderer(image_size=image)
        shape = (batch, 3, image, image) if which == "rgb" else (batch, image, image)
        w = torch.randn(shape, generator=gen).to(dev)
        (_, gv, gt), launches = _counted(lambda: run(r, v, tex, which, w), dev,
                                         dict(RENDER_LAUNCHES, scatter_rows=EXACT_SCATTERS[which]),
                                         f"exact {which}")
        check(bool(torch.isfinite(gv).all()) and float(gv.abs().max()) > 0,
              f"exact {which}: vertex gradient non-finite or zero")
        # the gradients' sums run in a fixed order: a second run, the same bits
        _, gv2, gt2 = run(r, v, tex, which, w)
        check(torch.equal(gv, gv2) and (gt is None or torch.equal(gt, gt2)),
              f"exact {which}: the vertex or texture gradient changed on a second run")
        ms = _host_ms(lambda: run(r, v, tex, which, w), dev, reps=2)
        mib = _peak_mib(lambda: run(r, v, tex, which, w), dev)
        rc = Renderer(image_size=cmp_image)
        shape = (1, 3, cmp_image, cmp_image) if which == "rgb" else (1, cmp_image, cmp_image)
        wc = torch.randn(shape, generator=gen)
        out_g, gv_g, gt_g = run(rc, v[:1], tex[:1], which, wc.to(dev))
        out_c, gv_c, gt_c = run(rc, v[:1].cpu(), tex[:1].cpu(), which, wc)
        e_out = max_err(out_g.cpu(), out_c)
        top_v = float(gv_c.abs().max())
        err_v = (gv_g.cpu() - gv_c).abs()
        # the walk divides colour differences by distances down to eps: where
        # a map differs by rounding, rtol 1e-3 of the entry (the CPU tests'
        # bound against JAX)
        ok_v = bool((err_v <= 1e-5 * top_v + (1e-3 if which == "rgb" else 0.0) * gv_c.abs()).all())
        row = dict(ms=ms, peak_mib=mib, launches=launches, fwd_err=e_out,
                   vertex_grad_err=float(err_v.max()), vertex_grad_max=top_v)
        check(ok_v and e_out <= 1e-5, f"exact {which} card vs CPU: output {e_out}, vertex "
              f"gradient {float(err_v.max())} (max {top_v})")
        if which == "rgb":
            top_t = float(gt_c.abs().max())
            e_t = max_err(gt_g.cpu(), gt_c)
            check(e_t <= 1e-5 * top_t, f"exact rgb texture gradient card vs CPU {e_t} (max {top_t})")
            row.update(texture_grad_err=e_t, texture_grad_max=top_t)
        res[which] = row
    log(f"  (c) exact-gradient Renderer, {batch} x {image}^2 (silhouettes and rgb rasterized at "
        f"{2 * image}^2), forward + backward (vertex and texture gradients bit-equal on a second "
        "run): " + "; ".join(
            f"{k} {o['ms']:.1f} ms, peak {o['peak_mib']} MiB, launches {o['launches']}"
            for k, o in res.items()))
    log(f"      card vs CPU at {cmp_image}^2, one sample: " + "; ".join(
        f"{k} output {o['fwd_err']:.3g}, vertex gradient {o['vertex_grad_err']:.3g} of max "
        f"{o['vertex_grad_max']:.3g}" + (f", texture gradient {o['texture_grad_err']:.3g} of max "
                                         f"{o['texture_grad_max']:.3g}" if k == "rgb" else "")
        for k, o in res.items()) + " (bounds 1e-5 of the max; rgb vertex also rtol 1e-3)")
    return res


def _block_extractor(dev: str, batch: int, hw: int, ch: int) -> dict:
    """(d) block_extractor and local_attn_reshape at the (hw^2, ch) layer
    shape, kernel 3: forward and gradients card vs CPU, and times."""
    import torch

    from hoig_torch.ops.block_extractor import block_extractor, local_attn_reshape

    gen = torch.Generator().manual_seed(17)
    k = 3
    src = torch.randn((batch, ch, hw, hw), generator=gen)
    flow = torch.randn((batch, 2, hw, hw), generator=gen) * 2.0
    g = torch.randn((batch, ch, hw * k, hw * k), generator=gen)
    attn = torch.randn((batch, k * k, hw, hw), generator=gen)

    def run(d):
        s_ = src.to(d).requires_grad_()
        f_ = flow.to(d).requires_grad_()
        out = block_extractor(s_, f_, k)
        ((out * g.to(d)).sum() + local_attn_reshape(attn.to(d), k).sum()).backward()
        return out.detach(), s_.grad, f_.grad

    ms = _host_ms(lambda: run(dev), dev)
    # the CPU run last: there src.to("cpu") is src itself, which then requires grad
    got, again, ref = run(dev), run(dev), run("cpu")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "block_extractor: the output or a gradient changed on a second run")
    errs = [max_err(a.cpu(), b) for a, b in zip(got, ref)]
    tops = [float(b.abs().max()) for b in ref]
    check(errs[0] <= 1e-6 and errs[1] <= 1e-5 * tops[1] and errs[2] <= 1e-5 * tops[2],
          f"block_extractor card vs CPU: out {errs[0]}, d source {errs[1]}, d flow {errs[2]}")
    check(torch.equal(local_attn_reshape(attn.to(dev), k).cpu(), local_attn_reshape(attn, k)),
          "local_attn_reshape differs card vs CPU")
    log(f"  (d) block_extractor ({batch}, {ch}, {hw}, {hw}), kernel 3: forward + backward "
        f"{ms:.2f} ms; card vs CPU out {errs[0]:.3g}, d source {errs[1]:.3g} (max {tops[1]:.3g}), "
        f"d flow {errs[2]:.3g} (max {tops[2]:.3g}); local_attn_reshape equal; output and "
        "gradients bit-equal on a second run")
    return dict(ms=ms, out_err=errs[0], src_grad_err=errs[1], flow_grad_err=errs[2])


def _uv_fit(env, dev: str, out_dir: Path, uv_size: int, steps: int, cmp_steps: int) -> dict:
    """(e) compute_uv_image on the hand atlas (the synthetic hand's UV OBJ,
    samplers of size 3): the reference's full fit on the card, timed, with
    its final loss; cmp_steps steps on the card and on the CPU held together."""
    import numpy as np
    import torch

    from hoig_torch.data.synthetic import write_hand_uv_obj
    from hoig_torch.geometry.uv_image import compute_uv_image, create_uvsampler
    from hoig_torch.ops.grid_sample import grid_sample

    path = out_dir / "hand_uv.obj"
    write_hand_uv_obj(str(path), env["mano"])
    uv = create_uvsampler(str(path), 3).reshape(-1, 3, 3, 2)
    path.unlink()
    tex = (np.random.RandomState(18).rand(uv.shape[0], 3, 3, 3) * 1.6 - 0.8).astype(np.float32)

    def loss(img):
        s = grid_sample(torch.as_tensor(img)[None], torch.as_tensor(uv.reshape(1, -1, 9, 2)))
        return float(((s.reshape(3, -1, 3, 3).permute(1, 2, 3, 0) - torch.as_tensor(tex)) ** 2)
                     .mean())

    if dev == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = compute_uv_image(uv, tex, uv_size=uv_size, steps=steps, device=dev)
    full_s = time.perf_counter() - t0
    short_g = compute_uv_image(uv, tex, uv_size=uv_size, steps=cmp_steps, device=dev)
    check(np.array_equal(short_g, compute_uv_image(uv, tex, uv_size=uv_size, steps=cmp_steps,
                                                   device=dev)),
          f"compute_uv_image: {cmp_steps} steps gave other bits on a second run")
    t0 = time.perf_counter()
    short_c = compute_uv_image(uv, tex, uv_size=uv_size, steps=cmp_steps, device="cpu")
    cpu_s = time.perf_counter() - t0
    err = float(np.abs(short_g - short_c).max())
    l0, l_short, l_full = loss(np.full_like(full, np.tanh(-1.0))), loss(short_c), loss(full)
    # Adam on the same gradients up to the f32 rounding of two devices
    check(err <= 1e-4, f"compute_uv_image card vs CPU after {cmp_steps} steps: {err}")
    check(np.isfinite(full).all() and l_full < l_short < l0,
          f"compute_uv_image loss {l0} -> {l_short} ({cmp_steps}) -> {l_full} ({steps})")
    log(f"  (e) compute_uv_image, hand atlas ({uv.shape[0]} faces), uv_size {uv_size}: {steps} "
        f"steps {full_s:.2f} s ({full_s / steps * 1e3:.3f} ms per step), loss {l0:.4g} -> "
        f"{l_short:.4g} ({cmp_steps}) -> {l_full:.4g} ({steps}); card vs CPU after {cmp_steps} "
        f"steps {err:.3g} (bound 1e-4; CPU {cpu_s:.2f} s); the card's {cmp_steps} steps "
        "bit-equal on a second run")
    return dict(steps=steps, s=full_s, ms_per_step=full_s / steps * 1e3, loss0=l0,
                loss_short=l_short, loss=l_full, cmp_err=err, cmp_steps=cmp_steps)


def _jax_resume(env, ccfg, batch, tcfg, dev: str) -> dict:
    """(f) the resume from a JAX epoch: a training state after two steps (D
    gated on the second, so D's Adam count is 1 and G's 2), laid out in
    memory as a JAX run's trees (flax_tree_from_torch, optax_from_adam) and
    loaded into a fresh state by checkpoints.load_jax_state: weights, Adam
    moments and steps bit-equal, Adam's step where torch keeps it; one Adam
    step of each on the same gradients, bit-equal; one train step of each,
    against a control: two deep copies of the original state, stepped too.
    The three control pairs measure how far two steps from one state differ
    here (cuDNN runs with torch's defaults in this phase); the resumed pair's
    mean |G difference| may be at most twice the largest of theirs (so none
    where the controls are bit-equal). The largest element differences are
    printed only."""
    import copy

    import numpy as np
    import torch

    from hoig_torch.models.convert import (discriminator_mapping, flax_tree_from_torch,
                                           generator_mapping)
    from hoig_torch.models.vgg import init_vgg
    from hoig_torch.train import checkpoints as ckpt
    from hoig_torch.train.optax_state import optax_from_adam
    from hoig_torch.train.trainer import build_networks, init_state, make_train_step

    state = init_state(*build_networks(tcfg, device=dev, seed=0), tcfg)
    vgg = init_vgg(seed=2, compute_dtype=tcfg.compute_dtype, device=dev)
    step = make_train_step(vgg, env["tables"], env["mano_params"], ccfg, tcfg)
    state, _ = step(state, batch, True)
    state, _ = step(state, batch, False)
    gmap, dmap = generator_mapping(tcfg.gen_name, tcfg.repeat_num), discriminator_mapping(4)
    t0 = time.perf_counter()
    trees = ({"params": flax_tree_from_torch(state.g.state_dict(), gmap)},
             {"params": flax_tree_from_torch(state.d.state_dict(), dmap)},
             {"opt": optax_from_adam(state.opt_g, state.g, gmap), "lr": state.lr_g,
              "step": np.int32(state.step)},
             {"opt": optax_from_adam(state.opt_d, state.d, dmap), "lr": state.lr_d})
    export_s = time.perf_counter() - t0
    counts = int(trees[2]["opt"]["0"]["count"]), int(trees[3]["opt"]["0"]["count"])
    check(counts == (2, 1), f"optax counts (G, D) {counts} != (2, 1)")
    fresh = init_state(*build_networks(tcfg, device=dev, seed=5), tcfg)
    t0 = time.perf_counter()
    ckpt.load_jax_state(fresh, tcfg, *trees)
    if dev == "cuda":
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    def pairs():
        return ((a, b, oa, ob) for net_a, net_b, oa, ob in (
            (state.g, fresh.g, state.opt_g, fresh.opt_g), (state.d, fresh.d, state.opt_d,
                                                           fresh.opt_d))
            for a, b in zip(net_a.parameters(), net_b.parameters()))

    def equal_states(label):
        for a, b, oa, ob in pairs():
            check(torch.equal(a, b), f"{label}: weights differ")
            sa, sb = oa.state[a], ob.state[b]
            check(torch.equal(sa["exp_avg"], sb["exp_avg"])
                  and torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"]), f"{label}: moments differ")
            check(float(sa["step"]) == float(sb["step"]), f"{label}: Adam steps differ")
            check(sb["step"].device == sa["step"].device, f"{label}: Adam's step on "
                  f"{sb['step'].device}, where torch keeps it: {sa['step'].device}")

    equal_states("after the resume")
    check(fresh.step == state.step == 2 and fresh.lr_g == state.lr_g
          and fresh.lr_d == state.lr_d, "step counter or learning rates differ")
    step_dev = str(fresh.opt_g.state[next(fresh.g.parameters())]["step"].device)
    gen = torch.Generator(device=dev).manual_seed(19)
    for a, b, _, _ in pairs():
        a.grad = torch.randn(a.shape, generator=gen, device=dev) * 1e-3
        b.grad = a.grad.clone()
    for opt in (state.opt_g, state.opt_d, fresh.opt_g, fresh.opt_d):
        opt.step()
    equal_states("after one Adam step on the same gradients")
    ctrls = [copy.deepcopy(state) for _ in range(2)]
    state, ma = step(state, batch, True)
    fresh, mb = step(fresh, batch, True)
    ctrls = [step(c, batch, True)[0] for c in ctrls]
    d_loss = abs(float(ma["loss_G"]) - float(mb["loss_G"])) / abs(float(ma["loss_G"]))

    def g_diff_lr(a, b):
        # the largest and the mean |G weight difference| of two states, in
        # units of G's lr
        with torch.no_grad():
            d = [(x - y).abs() for x, y in zip(a.g.parameters(), b.g.parameters())]
            n = sum(t.numel() for t in d)
            return (max(float(t.max()) for t in d) / state.lr_g,
                    sum(float(t.double().sum()) for t in d) / n / state.lr_g)

    moved = g_diff_lr(state, fresh)
    controls = [g_diff_lr(a, b) for a, b in ((state, ctrls[0]), (state, ctrls[1]),
                                             (ctrls[0], ctrls[1]))]
    control = max(c[1] for c in controls)
    same = sum(torch.equal(a, b) for a, b, _, _ in pairs())
    n = sum(1 for _ in pairs())
    check(all(bool(torch.isfinite(v)) for v in mb.values()), f"non-finite metrics {mb}")
    check(d_loss <= 1e-3, f"the train steps after the resume: loss_G differs by {d_loss:.3g}")
    check(moved[1] <= 2.0 * control, f"the train steps after the resume: mean |G difference| "
          f"{moved[1]:.3g} lr, over twice the {control:.3g} lr of steps from one original state")
    log(f"  (f) resume from a JAX run's trees: G Adam count 2, D 1 (D gated on step 2); export "
        f"{export_s:.2f} s, load_jax_state {load_s:.2f} s; weights, moments and Adam steps "
        f"bit-equal after the resume and after one Adam step on the same gradients; Adam's step "
        f"on {step_dev} as in the original state; one train step of each: loss_G relative "
        f"difference {d_loss:.3g}, {same} of {n} weight tensors bit-equal; G differs by "
        f"{moved[1]:.3g} lr on average and {moved[0]:.3g} lr at most, three pairs of steps from "
        "one original state by " + ", ".join(f"{c[1]:.3g} / {c[0]:.3g}" for c in controls)
        + " lr (bound: twice the largest control mean)")
    out = dict(counts=list(counts), export_s=export_s, load_s=load_s, step_device=step_dev,
               loss_rel_diff=d_loss, equal_tensors=same, tensors=n, max_g_diff_lr=moved[0],
               mean_g_diff_lr=moved[1], control_g_diff_lr=[list(c) for c in controls])
    del state, fresh, ctrls, step, vgg
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def offpath_phase(env, out_dir: Path, dev: str = "cuda") -> dict:
    """Phase 11 (see the module docstring), at IMAGE px, batch BATCH and the
    OFF_* / UV_* sizes; dev "cpu" rehearses it (launch counts unchecked)."""
    import torch

    from hoig_torch.data.synthetic import synthetic_batch
    from hoig_torch.geometry.conditioning import ConditioningConfig
    from hoig_torch.train.model_api import batch_as_torch

    out = dict(renderer=_renderer_maps(env, dev, IMAGE, BATCH),
               renderer_objects=_renderer_objects(env, dev, IMAGE, BATCH),
               exact_grad=_exact_vjps(env, dev, IMAGE, BATCH, OFF_CMP_IMAGE),
               block_extractor=_block_extractor(dev, BATCH, OFF_BLOCK_HW, OFF_BLOCK_CH),
               uv_image=_uv_fit(env, dev, out_dir, UV_SIZE, UV_STEPS, UV_CMP_STEPS))
    ccfg = ConditioningConfig(image_size=IMAGE)
    bt = batch_as_torch(synthetic_batch(BATCH, env["obj_verts"], image_size=IMAGE, seed=9), dev)
    out["jax_resume"] = _jax_resume(env, ccfg, bt, train_config("shift"), dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
    return out


def _profile_leg(label: str, argv: list, out_dir: Path, counters: dict, kernels: dict) -> dict:
    """scripts/profile_step_torch.py in a subprocess (a second profiler
    session in this process would lose its device events): its JSON line,
    with its launch counters per step held to `counters` and the launches
    per step of the hand-written kernels in its profile to `kernels`."""
    log_dir = out_dir / "tools" / label
    log_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(REPO / "scripts" / "profile_step_torch.py"), *argv],
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    (log_dir / "stdout.txt").write_text(proc.stdout + "\n--- stderr\n" + proc.stderr)
    check(proc.returncode == 0, f"profile_step_torch.py {' '.join(argv)} exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    res = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    res["seconds"] = time.perf_counter() - t0
    check(res["launches_per_step"] == counters,
          f"{label}: launch counters per step {res['launches_per_step']} != {counters}")
    check(res["device_busy_ms"] is not None, f"{label}: the profiler reported no device time")
    got = {k: v["count"] for k, v in res["hand_written"].items()}
    check(got == kernels, f"{label}: hand-written kernels per step in the profile {got} != {kernels}")
    unit = "step" if "train" in label else "call"
    log(f"  profile_step_torch {' '.join(argv)} ({res['seconds']:.1f} s): device busy "
        f"{res['device_busy_ms']:.2f} ms of {res['wall_ms']:.2f} ms wall per {unit} "
        f"({res['busy_share']:.1%}), {res['kernels_per_step']} device kernels, peak "
        f"{res['peak_mem_mib']:.0f} MiB; remat {res['remat']}; launches {res['launches_per_step']}")
    log("    by operator class: " + "; ".join(
        f"{k} {v:.2f}" for k, v in sorted(res["classes"].items(), key=lambda kv: -kv[1])))
    log("    top kernels: " + "; ".join(f"{r['ms']:.3f} x{r['count']} {r['name'][:48]}"
                                      for r in res["top_kernels"][:8]))
    log("    10 longest idle gaps (ms, the host op running when it opened / the next to begin): "
        + "; ".join(f"{g['ms']:.3f} {(g['host'] or ['-'])[-1][:32]} / {str(g['next'])[:32]}"
                    for g in res["idle_gaps"]))
    return res


def tools_phase(env, out_dir: Path, serve: dict, train: dict) -> dict:
    """Phase 12 (see the module docstring). Returns the phase's numbers."""
    import dataclasses

    import torch

    sys.path.insert(0, str(REPO / "scripts"))
    import attn_ab_torch
    import flops_ceiling_torch
    from profile_step_torch import train_config

    from hoig_torch.ops.attn_fused import F, HALO, _tc_splits
    from hoig_torch.utils import flops

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cond = {"rasterizer": 1, "table_gather": 2}
    b2b3 = {"bin_kernel": 1, "raster_kernel": 1, "gather_kernel": 2}
    # the InstanceNorm kernels: the statistics and the apply forward (the
    # apply also in the recompute), three kernels a backward
    fp32_norms = {"inorm_stats_kernel": NORMS_PER_STEP["inorm_stats"],
                  "inorm_apply_kernel": FP32_LAUNCHES_PER_STEP["inorm_apply"],
                  **{k: NORMS_PER_STEP["inorm_backward"] // 3 for k in NORM_BACKWARD_KERNELS}}
    serve_norms = {"inorm_stats_kernel": NORMS_PER_CALL["inorm_stats"],
                   "inorm_apply_kernel": NORMS_PER_CALL["inorm_apply"]}
    # B4-fwd's product adds its split-K partials in a second launch where it splits
    split = sum(_tc_splits(BATCH, h + 2 * HALO, h + 2 * HALO, F) > 1
                for h, _ in flops.attn_layers(IMAGE, 64, 6))
    out = dict(profile={
        "fp32_b8_gather_train": _profile_leg(
            "fp32_b8_gather_train", ["--dtype", "fp32", "--engine", "gather", "--batch", "8",
                                     "--steps", "2", "--warmup", "1"], out_dir,
            FP32_LAUNCHES_PER_STEP, dict(b2b3, fold_kernel=9, **{k: 9 for k in SCATTER_FUNCTIONS},
                                         **fp32_norms)),
        "bf16_b4_fused_serve": _profile_leg(
            "bf16_b4_fused_serve", ["--dtype", "bf16", "--engine", "pallas", "--leg", "fwd",
                                    "--batch", str(BATCH), "--steps", "2", "--warmup", "2"],
            out_dir, dict(cond, attn_fused_fwd_tc=9, **NORMS_PER_CALL),
            dict(b2b3, conv5_tc_kernel=9, fwd_pixel_kernel=9, slice_sum_kernel=split,
                 **serve_norms))})

    rows = attn_ab_torch.run(BATCH, "bf16", ("shift", "gather", "pallas"), 3, "cuda", IMAGE, 64)
    log("  attn_ab_torch (3 iterations; device ms queued behind a GPU sleep, * the stream's span "
        "where an iteration outruns the launch queue / host ms): " + "; ".join(
            f"{r['shape']} {r['engine']} {r['dtype']} fwd {r['fwd_ms']:.3f}"
            f"{'' if r['fwd_queued'] else '*'} / {r['fwd_host_ms']:.2f}, fwd+bwd "
            f"{r['fwd_bwd_ms']:.3f}{'' if r['fwd_bwd_queued'] else '*'} / {r['fwd_bwd_host_ms']:.2f}"
            for r in rows))
    out["attn_ab"] = rows

    tcfg = train_config("bf16", "shift")
    check_rows = flops_ceiling_torch.check_leg(tcfg, BATCH, torch.device("cuda"), env)
    for leg, row in check_rows.items():
        check(row["rel_diff"] <= 1e-3, f"FLOP walk vs FlopCounterMode ({leg}): {row}")
    out["flop_check"] = check_rows
    # FLOPs per leg and the share of the bf16 peak the measured medians imply
    legs = {}
    for name, cfg, leg, ms in (
            ("serving call, bf16 shift (phase 5)", tcfg, "serve", serve["call_ms"]),
            ("training step, bf16 shift, remat off (phase 7)",
             dataclasses.replace(tcfg, remat=False), "train", train["step_ms"]),
            ("training step, bf16 shift, bf16 remat defaults (phase 7)", tcfg, "train",
             train["remat"]["step_ms"])):
        tot = flops.leg_flops(cfg, BATCH, leg)["total"]
        legs[name] = dict(model=tot["model"], executed=tot["executed"], ms=ms,
                          bf16_peak_share=tot["executed"] / (ms / 1e3) / flops.PEAK_BF16_TC_FLOPS)
    f32 = out["profile"]["fp32_b8_gather_train"]
    tot = flops.leg_flops(train_config("fp32", "gather"), 8, "train")["total"]
    legs["training step, fp32 gather, batch 8, full remat (profiled wall)"] = dict(
        model=tot["model"], executed=tot["executed"], ms=f32["wall_ms"],
        bf16_peak_share=tot["executed"] / (f32["wall_ms"] / 1e3) / flops.PEAK_BF16_TC_FLOPS,
        fp32_peak_share=tot["executed"] / (f32["wall_ms"] / 1e3) / flops.PEAK_FP32_FLOPS)
    out["legs"] = legs
    for name, v in legs.items():
        log(f"  {name}: {v['model'] / 1e12:.3f} TFLOP model, {v['executed'] / 1e12:.3f} executed, "
            f"{v['ms']:.2f} ms: {v['bf16_peak_share']:.2%} of the bf16 peak"
            + (f", {v['fp32_peak_share']:.2%} of FP32's" if "fp32_peak_share" in v else ""))
    for leg, row in check_rows.items():
        log(f"  FLOP walk vs FlopCounterMode, bf16 shift {leg} at batch {BATCH}: "
            f"{row['aten_counted'] / 1e12:.4f} against {row['aten_walk'] / 1e12:.4f} TFLOP aten "
            f"(relative difference {row['rel_diff']:.2g}); launches {row['launches']} as the "
            f"walk's; hand-written kernels {row['kernel_flops'] / 1e9:.1f} GFLOP")
    out["seconds"] = time.perf_counter() - t0
    log(f"  phase 12 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 13. real-layout data without cv2: the native reader on the committed
# fixtures, train_torch.py over an HO3Dv3 tree and eval_torch.py over a
# DexYCB tree, in subprocesses where cv2 cannot be imported (the port's
# modules import no cv2, PIL or torchvision: tests/test_torch_images.py)
# ---------------------------------------------------------------------------
FIXTURES = REPO / "tests" / "torch_fixtures" / "images"
IMAGE_LIBRARIES = ("cv2", "PIL", "torchvision")
# the drivers' network width in phase 13 (phase 9's)
REAL_NET = ["--conv_dim", "64", "--repeat_num", "6"]
# a subprocess of phase 13: cv2 made unimportable first
CHILD = ("import sys; sys.modules['cv2'] = None; sys.path.insert(0, {repo!r}); "
         "import chip_smoke; sys.exit(chip_smoke.real_data_child(sys.argv[1]))")


@contextlib.contextmanager
def cv2_blocked():
    """cv2 unimportable inside the block (the rest of sys.modules untouched:
    mock.patch.dict would also drop the modules imported inside it)."""
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


def _sha256(b) -> str:
    import hashlib

    return hashlib.sha256(bytes(b)).hexdigest()


def decode_fixtures() -> dict:
    """Phase 13a: every committed fixture and the data path's resizes held to
    the SHA-256 that cv2 gave when they were made; host ms per read."""
    from hoig_torch.runtime import imread, resize_linear_u8

    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    for name, entry in manifest["files"].items():
        path = FIXTURES / name
        check(_sha256(path.read_bytes()) == entry["sha256"], f"fixture {name} changed")
        img = imread(path)
        check(list(img.shape) == entry["shape"] and _sha256(img.tobytes()) == entry[
            "imread_sha256"], f"{name}: the native reader differs from cv2.imread's array")
    for case in manifest["resizes"]:
        img = resize_linear_u8(imread(FIXTURES / case["source"]), case["dsize"])
        check(_sha256(img.tobytes()) == case["sha256"],
              f"{case['source']} resized to {case['dsize']} differs from cv2.resize's array")
    mask, tex = imread(FIXTURES / "mask_320x240_3ch.png"), imread(FIXTURES / "texture_map.png")
    calls = {
        "jpeg_420_640x480": lambda: imread(FIXTURES / "frame_420_q95.jpg"),
        "jpeg_444_rst_640x480": lambda: imread(FIXTURES / "frame_444_q75_rst.jpg"),
        "png_mask_640x480x3": lambda: imread(FIXTURES / "mask_640x480_3ch.png"),
        "png_mask_320x240x3": lambda: imread(FIXTURES / "mask_320x240_3ch.png"),
        "resize_mask_320x240_to_640x480": lambda: resize_linear_u8(mask, (640, 480)),
        "resize_texture_512_to_256": lambda: resize_linear_u8(tex, (256, 256)),
    }
    ms = {k: _host_ms(fn, "cpu", reps=20) for k, fn in calls.items()}  # host work only
    return dict(files=len(manifest["files"]), resizes=len(manifest["resizes"]),
                made_by=manifest["versions"], host_ms=ms)


def _write_assets(root: Path, objects: list, obj_file, texture: str) -> list:
    """A real-data asset layout (tests/test_torch_data.py's _real_asset_tree):
    a synthetic MANO pickle, the hand UV atlas, the semantics, the objects
    (synthetic meshes), the second with the fixture texture under `texture`.
    Returns the asset flags."""
    import pickle
    import shutil

    import numpy as np

    from hoig_torch.data.synthetic import (synthetic_semantics, write_hand_uv_obj,
                                           write_synthetic_obj)
    from hoig_torch.geometry.mano import MANOModel

    m = MANOModel.synthetic(0)
    kintree = np.stack([np.where(m.parents < 0, 2**32 - 1, m.parents), np.arange(16)])
    (root / "mano").mkdir(parents=True)
    with open(root / "mano" / "MANO_RIGHT.pkl", "wb") as fp:
        pickle.dump(dict(v_template=m.v_template, shapedirs=m.shapedirs, posedirs=m.posedirs,
                         J_regressor=m.j_regressor, weights=m.lbs_weights,
                         hands_components=m.hands_components, hands_mean=m.hands_mean,
                         f=m.faces, kintree_table=kintree), fp)
    write_hand_uv_obj(str(root / "hand_uv.obj"), m)
    with open(root / "sem.pkl", "wb") as fp:
        pickle.dump(synthetic_semantics(), fp)
    for i, name in enumerate(objects):
        path = obj_file(name)
        path.parent.mkdir(parents=True, exist_ok=True)
        write_synthetic_obj(str(path), seed=i)
    shutil.copy(FIXTURES / "texture_map.png", obj_file(objects[1]).parent / texture)
    return ["--mano_model", str(root / "mano"), "--uv_mapping", str(root / "hand_uv.obj"),
            "--sem_hand", str(root / "sem.pkl")]


# (fixture frame, fixture mask) of each HO3D frame: both JPEG kinds, masks at
# half and full size, three channels and one
HOV3_FRAMES = [("frame_420_q95.jpg", "mask_320x240_3ch.png"),
               ("frame_444_q75_rst.jpg", "mask_640x480_3ch.png"),
               ("frame_444_q75_rst.jpg", "mask_320x240_1ch.png"),
               ("frame_420_q95.jpg", "mask_640x480_1ch.png")]


def hov3_tree(root: Path) -> list:
    """An HO3Dv3 tree (tests/test_real_datasets.py's layout: meta pickles,
    box and split pickles) of 2 videos x 4 frames, frames and masks copied
    from the fixtures, cameras at HO3D's 640x480 intrinsics; the real-asset
    layout beside it with 003_cracker_box plain and 004_sugar_box textured.
    Returns the dataset and asset flags."""
    import pickle
    import shutil

    import numpy as np

    data = root / "data"
    rng = np.random.RandomState(13)
    names = ["003_cracker_box", "004_sugar_box"]  # OBJNAMES 0, 1; sorted, as the tables list them
    flags = _write_assets(root / "assets", names, lambda n: root / "obj" / n / f"{n}.obj",
                          "texture_map.png")
    vids = {"ABF10_0": names[0], "GPMF11_0": names[1]}
    frames = [f"{i:04d}.jpg" for i in range(len(HOV3_FRAMES))]
    for vid, obj_name in vids.items():
        seq = data / "images" / "train" / vid.split("_")[0]
        for sub in ("rgb", "mask", "meta"):
            (seq / sub).mkdir(parents=True)
        for i, (frame, mask) in enumerate(HOV3_FRAMES):
            shutil.copy(FIXTURES / frame, seq / "rgb" / frames[i])
            shutil.copy(FIXTURES / mask, seq / "mask" / f"{i:05d}.png")
            anno = {"objName": obj_name,
                    "objRot": (rng.randn(3, 1) * 0.3).astype(np.float32),
                    "objTrans": (rng.randn(3) * 0.02 + [0, 0, 0.55]).astype(np.float32),
                    "camMat": np.array([[614.0, 0, 320], [0, 614.0, 240], [0, 0, 1]], np.float32),
                    "handPose": (rng.randn(48) * 0.1).astype(np.float32),
                    "handBeta": (rng.randn(10) * 0.3).astype(np.float32),
                    "handTrans": np.array([0, 0, 0.5], np.float32)}
            with open(seq / "meta" / f"{i:04d}.pkl", "wb") as fp:
                pickle.dump(anno, fp)
    (data / "params").mkdir()
    split = {vid: frames for vid in vids}
    for fname, payload in [("HOv3-CR_bbx.pkl", {v: [160.0, 80.0, 320.0, 320.0] for v in vids}),
                           ("HOv3-CR_train_new.pkl", split), ("HOv3-CR_test_new.pkl", split)]:
        with open(data / "params" / fname, "wb") as fp:
            pickle.dump(payload, fp)
    return ["--dataset_mode", "hov3", "--data_dir", str(data), "--params_dir", "params",
            "--images_dir", "images", "--obj_dir", str(root / "obj"), *flags]


YCB_VIDEOS = ["20200709-subject-01/20200709_141754/932122060861",
              "20200813-subject-02/20200813_145653/932122060861"]


def ycb_tree(root: Path) -> tuple[list, Path]:
    """A DexYCB tree (tests/test_real_datasets.py's layout: labels_*.npz, the
    video info, box and split pickles) of 2 nested videos x 2 frames copied
    from the fixture JPEGs, the 21 YCB objects (synthetic meshes, the second
    textured) and assets/eval_pairs.pkl of BATCH pairs (one eval batch)
    under the run directory the eval driver starts in. Returns the dataset
    and asset flags and the run directory."""
    import pickle
    import shutil

    import numpy as np

    from hoig_torch.data.dataset_base import rodrigues
    from hoig_torch.data.ycb_dataset import OBJNAMES

    data = root / "data"
    rng = np.random.RandomState(14)
    flags = _write_assets(root / "assets", OBJNAMES,
                          lambda n: data / "models" / n / "textured_pre.obj",
                          "texture_map_resize.png")
    bbx, info = {}, {}
    for k, vid in enumerate(YCB_VIDEOS):
        img_dir = data / "images" / vid
        img_dir.mkdir(parents=True)
        bbx[vid] = [160.0, 80.0, 480.0, 400.0]  # x0, y0, x1, y1
        info[vid] = {"intrinsics": {"fx": 614.0, "fy": 614.0, "ppx": 320.0, "ppy": 240.0},
                     "ycb_ids": [14, k + 1],  # the grasped object second: OBJNAMES[k]
                     "ycb_grasp_ind": 1, "mano_betas": (rng.randn(10) * 0.3).tolist()}
        for f, frame in enumerate(("frame_420_q95.jpg", "frame_444_q75_rst.jpg")):
            shutil.copy(FIXTURES / frame, img_dir / f"color_{f:06d}.jpg")
            pose_y = np.zeros((2, 3, 4), np.float32)
            for o in range(2):
                pose_y[o, :, :3] = rodrigues((rng.randn(3) * 0.3).astype(np.float32))
                pose_y[o, :, 3] = rng.randn(3) * 0.02 + [0, 0, 0.55]
            np.savez(img_dir / f"labels_{f:06d}.npz", pose_y=pose_y,
                     pose_m=(rng.randn(1, 51) * 0.1).astype(np.float32))
    (data / "params").mkdir()
    split = {vid: [0, 1] for vid in YCB_VIDEOS}
    for fname, payload in [("DexYCB-bbx.pkl", bbx), ("valid_video_info.pkl", info),
                           ("DexYCB_train.pkl", split), ("DexYCB_test.pkl", split)]:
        with open(data / "params" / fname, "wb") as fp:
            pickle.dump(payload, fp)
    run_dir = root / "run"
    (run_dir / "assets").mkdir(parents=True)
    va, vb = YCB_VIDEOS
    pairs = [(f"{va}/0", f"{vb}/1"), (f"{vb}/0", f"{va}/1"), (f"{va}/1", f"{va}/0"),
             (f"{vb}/1", f"{vb}/0")]
    with open(run_dir / "assets" / "eval_pairs.pkl", "wb") as fp:
        pickle.dump([pairs[i % len(pairs)] for i in range(BATCH)], fp)
    return ["--dataset_mode", "ycb", "--data_dir", str(data), "--params_dir", "params",
            "--images_dir", "images", "--obj_dir", str(data / "models"), *flags], run_dir


def real_data_child(spec_file: str) -> int:
    """Phase 13's driver run, in a subprocess started by CHILD (cv2
    unimportable): spec "train" times the loader alone over the
    training split, then runs train_torch.Train; spec "eval" runs
    eval_torch.main; both under a DriverProbe. Writes the numbers to the
    spec's result file."""
    import numpy as np

    import eval_torch
    import train_torch
    from hoig_torch.data.loader import CustomDatasetDataLoader
    from hoig_torch.options.train_options import TrainOptions

    spec = json.loads(Path(spec_file).read_text())
    args, out = spec["args"], {}
    if spec["driver"] == "train":
        opt = TrainOptions().parse(args)
        t0 = time.perf_counter()
        n = sum(1 for _ in CustomDatasetDataLoader(opt, is_for_train=True).load_data())
        out.update(loader_batches=n, loader_ms_per_batch=(time.perf_counter() - t0) * 1e3 / n)
        with DriverProbe().attached() as probe:
            run = train_torch.Train(args)
        tex = run.model._env["tables_np"].obj_tex
        starts = [t for t, is_train in probe.inputs if is_train]
        out.update(steps=probe.steps, forwards=probe.forwards,
                   iterations_ms=[(b - a) * 1e3 for a, b in zip(starts, starts[1:])],
                   errors=run.model.get_current_errors(),
                   obj_tex_sha256=[_sha256(np.ascontiguousarray(t).tobytes()) for t in tex],
                   obj_tex_absmax=[float(np.abs(t).max()) for t in tex])
    else:
        with DriverProbe().attached() as probe:
            eval_torch.main(args)
            t_end = time.perf_counter()
        out.update(forwards=probe.forwards, batches=_eval_batches(probe, t_end))
    Path(spec["result"]).write_text(json.dumps(out))
    return 0


def _run_child(label: str, spec: dict, cwd: Path, root: Path, timeout: int) -> dict:
    import os
    import signal

    spec_file, log_path = root / f"{label}_spec.json", root / f"{label}.log"
    spec["result"] = str(root / f"{label}_result.json")
    spec_file.write_text(json.dumps(spec))
    cmd = [sys.executable, "-c", CHILD.format(repo=str(REPO)), str(spec_file)]
    t0 = time.perf_counter()
    with open(log_path, "w") as fp:
        proc = subprocess.Popen(cmd, cwd=cwd, stdout=fp, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            rc = "timeout"
    wall = time.perf_counter() - t0
    check(rc == 0, f"phase 13 {label} exited {rc}:\n{log_path.read_text()[-3000:]}")
    return dict(json.loads(Path(spec["result"]).read_text()), wall_s=wall)


def real_data_phase(out_dir: Path, drivers: dict, dev: str = "cuda") -> dict:
    """Phase 13: the fixtures through the native reader, then train_torch.py
    over an HO3Dv3 tree and eval_torch.py over a DexYCB tree, full width
    (REAL_NET), IMAGE px, batch BATCH, bf16, each in a subprocess where cv2
    cannot be imported. Returns the phase's numbers."""
    import importlib.util
    import shutil

    import numpy as np

    from hoig_torch.models.vgg import init_vgg
    from hoig_torch.runtime import imread, resize_linear_u8

    t_phase = time.perf_counter()
    root = (out_dir / "real_data").resolve()  # the eval driver runs in its own directory
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    out = {"image_libraries_installed": [m for m in IMAGE_LIBRARIES
                                         if importlib.util.find_spec(m) is not None]}
    if "cv2" in out["image_libraries_installed"]:
        import cv2  # its version, for the record; the phase never calls it

        out["cv2_version"] = cv2.__version__
    try:
        with cv2_blocked():
            out["decode"] = decode_fixtures()
            hov3_args = hov3_tree(root / "hov3")
            ycb_args, ycb_run = ycb_tree(root / "ycb")
        ms = out["decode"]["host_ms"]
        log(f"  (a) {out['decode']['files']} fixtures and {out['decode']['resizes']} resizes "
            f"bit-equal to cv2 {out['decode']['made_by']['cv2']} (libjpeg-turbo "
            f"{out['decode']['made_by']['libjpeg-turbo']}, libpng "
            f"{out['decode']['made_by']['libpng']}); image libraries installed here: "
            f"{out['image_libraries_installed'] or 'none'} (cv2 {out.get('cv2_version')}), "
            f"blocked in the phase; host ms: "
            + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))

        # the perceptual loss on seeded random VGG19 weights passed as a file
        # (real-data training refuses random VGG features otherwise)
        vgg = root / "vgg19_seed0.npz"
        np.savez(vgg, **{k: v.numpy() for k, v in init_vgg(seed=0, device="cpu")
                         .state_dict().items()})
        common = ["--image_size", str(IMAGE), "--batch_size", str(BATCH), *REAL_NET, "--bf16",
                  "--use_spade", "--device", dev]
        train = _run_child("train", dict(driver="train", args=hov3_args + common + [
            "--use_vgg", "--vgg_weights", str(vgg), "--mask_bce", "--num_repeats",
            str(3 * BATCH // 2), "--nepochs_no_decay", "1", "--nepochs_decay", "0",
            "--checkpoints_dir", str(root / "checkpoints"), "--name", "hov3"]), REPO, root, 600)
        check(train["loader_batches"] == 3, f"the HO3D loader gave {train['loader_batches']} "
              f"batches, not 3")
        check(len(train["steps"]) == 3, f"hov3 train_torch ran {len(train['steps'])} steps")
        check(all(math.isfinite(v) for v in train["errors"].values()),
              f"hov3 train_torch: non-finite errors {train['errors']}")
        if dev == "cuda":
            for i, (_, launches) in enumerate(train["steps"]):
                check(launches == LAUNCHES_PER_STEP_REMAT,
                      f"hov3 step {i + 1} launches {launches} != {LAUNCHES_PER_STEP_REMAT}")
        # the textured object's table: the fixture texture resized to IMAGE
        # as cv2 does, the plain one zeros
        tex = resize_linear_u8(imread(FIXTURES / "texture_map.png")[:, :, ::-1], (IMAGE, IMAGE))
        want = (tex.astype(np.float32) / 255.0 * 2.0 - 1.0).transpose(2, 0, 1)
        check(train["obj_tex_absmax"][0] == 0 and train["obj_tex_absmax"][1] > 0
              and train["obj_tex_sha256"][1] == _sha256(np.ascontiguousarray(want).tobytes()),
              f"hov3 obj_tex: |max| {train['obj_tex_absmax']}, not the fixture texture")
        steps = [s for s, _ in train["steps"]]
        log(f"  (b) train_torch.py --dataset_mode hov3 (2 videos x 4 frames, 3 steps): exit 0 "
            f"after {train['wall_s']:.1f} s; loader {train['loader_ms_per_batch']:.2f} ms per "
            f"batch (phase 9's synthetic loader {drivers['loader_ms_per_batch']:.2f}); steps "
            f"{', '.join(f'{v:.1f}' for v in steps)} ms (phase 9's "
            f"{', '.join(f'{v:.1f}' for v in drivers['train_step_ms_all'])}); iterations "
            f"{', '.join(f'{v:.1f}' for v in train['iterations_ms'])} ms (phase 9's "
            f"{', '.join(f'{v:.1f}' for v in drivers['train_iteration_ms'])}); launches per "
            f"step {train['steps'][0][1]}; the textured object's table bit-equal to cv2's resize")
        shutil.rmtree(root / "checkpoints", ignore_errors=True)  # about 2.3 GB

        dest = root / "eval_out"
        ev = _run_child("eval", dict(driver="eval", args=ycb_args + common + [
            "--num_repeats", "1", "--checkpoints_dir", str(root / "ycb_ck"), "--name", "ycb",
            "--output_dir", str(dest)]), ycb_run, root, 300)
        check(len(ev["forwards"]) == 1, f"ycb eval_torch ran {len(ev['forwards'])} batches")
        if dev == "cuda":
            check(ev["forwards"][0][2] == LAUNCHES_PER_CALL,
                  f"ycb eval batch launches {ev['forwards'][0][2]} != {LAUNCHES_PER_CALL}")
        pngs = sorted(dest.glob("*/*.png"))
        check(len(pngs) == 3 * BATCH and all(_png_size(p) == (IMAGE, IMAGE) for p in pngs),
              f"ycb eval_torch wrote {len(pngs)} PNGs, not {3 * BATCH} of {IMAGE}x{IMAGE}")
        log(f"  (c) eval_torch.py --dataset_mode ycb (21 objects, {BATCH} pairs, 1 batch): exit 0 "
            f"after {ev['wall_s']:.1f} s; {len(pngs)} PNGs of {IMAGE}x{IMAGE}; batch "
            f"{ev['batches'][0][0]:.1f} ms, {ev['batches'][0][1]:.1f} of it PNG writes (phase "
            f"9's eval batches {', '.join(f'{v:.1f}' for v in drivers['eval_batch_ms'])}); "
            f"launches {ev['forwards'][0][2]}")
        out.update(train={k: v for k, v in train.items() if k != "forwards"},
                   eval=ev, phase9=dict(loader_ms_per_batch=drivers["loader_ms_per_batch"],
                                        train_step_ms=drivers["train_step_ms_all"],
                                        train_iteration_ms=drivers["train_iteration_ms"],
                                        eval_batch_ms=drivers["eval_batch_ms"]))
    finally:
        # the trees, the 80 MB of VGG weights and a 2.3 GB save; the logs,
        # results and eval PNGs stay
        for path in ("checkpoints", "ycb_ck", "hov3", "ycb"):
            shutil.rmtree(root / path, ignore_errors=True)
        (root / "vgg19_seed0.npz").unlink(missing_ok=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  phase 13 took {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# 14. bench_torch.py, the port's benchmark: every leg in full mode, then the
# headline alone with the fused engine
# ---------------------------------------------------------------------------

# the bench's own limit is its diagnostic budget (2700 s by default); this
# phase's is chip_smoke's
BENCH_TIMEOUT_S = 600
# launches per step or call of each leg at the main path's counts (phases 5,
# 6e, 7 and 7e); the fp32 leg's gather engine launches no attention kernel
BENCH_LAUNCHES = {"train_bf16": LAUNCHES_PER_STEP_REMAT, "gen_fwd": LAUNCHES_PER_CALL,
                  "train_bf16_b8": LAUNCHES_PER_STEP_REMAT,
                  "train_bf16_dexycb": LAUNCHES_PER_STEP_REMAT,
                  "train_fp32": FP32_LAUNCHES_PER_STEP}


def _bench_run(label: str, out_dir: Path, env_extra: dict) -> dict:
    """`python bench_torch.py --out out_dir` in its own process group (its
    legs' processes go with it on a timeout): its headline line, checked."""
    import os
    import signal

    import bench_torch

    env = {k: v for k, v in os.environ.items() if not k.startswith("HOIG_BENCH_")}
    env.update(env_extra)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with open(out_dir / f"{label}.stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, str(REPO / "bench_torch.py"), "--out",
                                 str(out_dir)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                                stderr=err, text=True, start_new_session=True)
        try:
            stdout, _ = proc.communicate(timeout=BENCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            stdout, _ = proc.communicate()
            fail(f"bench_torch.py ({label}) passed {BENCH_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    (out_dir / f"{label}.stdout.txt").write_text(stdout)
    check(proc.returncode == 0, f"bench_torch.py ({label}) exited {proc.returncode}: "
          f"{(out_dir / f'{label}.stderr.txt').read_text()[-3000:]}")
    lines = stdout.strip().splitlines()
    check(bool(lines), f"bench_torch.py ({label}) printed nothing")
    head = json.loads(lines[-1])
    check(head.get("metric") == bench_torch.METRIC and "rehearsal" not in head
          and math.isfinite(head.get("value", math.nan)) and head["value"] > 0,
          f"bench_torch.py ({label}): last line {lines[-1]!r} is not the headline")
    return dict(headline=head, wall_s=wall)


def _bench_leg(leg: str, d: dict, engine: str, want: dict) -> dict:
    """One leg's numbers from the bench's details, its launches held to the
    walk's (flops.kernel_launches plus B2 and B3) and to `want`."""
    import torch

    import bench_torch

    spec = bench_torch.leg_spec(leg, engine)
    walk = bench_torch.expected_launches(spec)
    check(walk == want, f"{leg}: the walk's launches {walk} != the main path's {want}")
    check(d.get(f"{leg}_launches") == walk, f"{leg}: launches {d.get(f'{leg}_launches')} per "
          f"{'step' if spec['kind'] == 'train' else 'call'} != the walk's {walk}")
    mfu = d.get(f"{leg}_mfu")
    check(mfu is not None and 0 < mfu < 1, f"{leg}: share of peak {mfu}")
    check(d.get(f"{leg}_device") == torch.cuda.get_device_name(0), f"{leg}: device "
          f"{d.get(f'{leg}_device')}")
    check(d.get(f"{leg}_batch") == spec["batch"], f"{leg}: batch {d.get(f'{leg}_batch')}")
    unit = "step_ms" if spec["kind"] == "train" else "ms"
    row = dict(images_per_s=d[f"{leg}_images_per_sec_per_chip"], ms=d[f"{leg}_{unit}"],
               blocked_ms=d[f"{leg}_{unit}_blocked"], mfu=mfu, mfu_peak=d[f"{leg}_mfu_peak"],
               tflops_per_s=d[f"{leg}_tflops_per_sec"], launches=d[f"{leg}_launches"],
               peak_mib=d[f"{leg}_peak_mem_mib"], first_step_s=d[f"{leg}_first_step_s"],
               kernel_build_s=d[f"{leg}_kernel_build_s"], batch=spec["batch"], engine=engine)
    log(f"  {leg} ({engine}, batch {spec['batch']}): {row['images_per_s']:.3f} images/s, "
        f"{row['ms']:.2f} ms per {'step' if spec['kind'] == 'train' else 'call'} (synchronized "
        f"{row['blocked_ms']:.2f}), {mfu:.2%} of the {row['mfu_peak']}, launches "
        f"{row['launches']}, peak {row['peak_mib']:.0f} MiB; first step {row['first_step_s']:.2f} s, kernels "
        f"{row['kernel_build_s']:.2f} s")
    return row


def bench_phase(out_dir: Path, serve: dict, train: dict, fused: dict) -> dict:
    """Phase 14: bench_torch.py in full mode (all five legs, the default
    budget), then HOIG_BENCH_HEADLINE_ONLY=1 HOIG_BENCH_ENGINE=pallas.
    Returns the phase's numbers."""
    import torch

    import bench_torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    root = out_dir / "bench"
    full = _bench_run("full", root, {})
    d = json.loads((root / "BENCH_DETAILS.json").read_text())
    for key in ("legs_failed", "legs_skipped_for_budget"):
        check(key not in d, f"bench_torch.py: {key} {d.get(key)}")
    # bench.py's b4-vs-b8 flag (per-image throughput within 2.2x) is recorded,
    # not held: the eager step is host-bound at both batches, so the b8 step
    # takes about as long as the b4 step, and b8's per-image throughput sits
    # at twice b4's, inside the flag's noise. The steps themselves must agree
    # within bench_torch.TIMING_RATIO: a timing artifact breaks that
    t4, t8 = d["train_bf16_step_ms"], d["train_bf16_b8_step_ms"]
    check(1 / bench_torch.TIMING_RATIO < t8 / t4 < bench_torch.TIMING_RATIO,
          f"bench_torch.py: the b8 step {t8:.1f} ms against the b4 step {t4:.1f} ms")
    check(not [k for k in d if k.startswith("SANITY_FAIL_") and k != "SANITY_FAIL_b4_vs_b8"],
          f"bench_torch.py: {[k for k in d if k.startswith('SANITY_FAIL_')]}")
    log(f"  b8 step / b4 step {t8 / t4:.3f}; bench.py's b4-vs-b8 flag: "
        f"{d.get('SANITY_FAIL_b4_vs_b8', 'not raised')}")
    check(round(d["train_bf16_images_per_sec_per_chip"], 3) == full["headline"]["value"],
          "bench_torch.py: the headline line is not the headline leg's number")
    check(d["tf32"] == {"cudnn": True, "matmul": False}, f"bench_torch.py: TF32 flags {d['tf32']}"
          " are not torch's defaults")
    log(f"  bench_torch.py (full, {full['wall_s']:.1f} s): headline {full['headline']}; "
        f"corner engine {d['corner_engine']}, TF32 {d['tf32']}")
    legs = {leg: _bench_leg(leg, d, "gather" if leg == "train_fp32" else "shift", want)
            for leg, want in BENCH_LAUNCHES.items()}
    log(f"  headline step {legs['train_bf16']['ms']:.2f} ms beside phase 7's median with the "
        f"same remat {train['remat']['step_ms']:.2f}; gen_fwd call {legs['gen_fwd']['ms']:.2f} ms "
        f"beside phase 5's {serve['call_ms']:.2f} (information, not checks)")

    ab_dir = out_dir / "bench_ab"
    ab = _bench_run("fused_headline", ab_dir, {"HOIG_BENCH_HEADLINE_ONLY": "1",
                                                "HOIG_BENCH_ENGINE": "pallas"})
    ab_d = json.loads((ab_dir / "BENCH_AB.json").read_text().splitlines()[-1])
    check(ab_d["corner_engine"] == "pallas", f"fused headline: engine {ab_d['corner_engine']}")
    check(not (ab_dir / "BENCH_DETAILS.json").exists(),
          "a headline-only run wrote BENCH_DETAILS.json")
    fused_row = _bench_leg("train_bf16", ab_d, "pallas",
                           with_kept(FUSED_LAUNCHES_PER_STEP, "bf16 remat defaults"))
    log(f"  fused headline ({ab['wall_s']:.1f} s): {ab['headline']}; step {fused_row['ms']:.2f} ms "
        f"(bf16 remat defaults) beside phase 6e's fused step with remat off "
        f"{fused['training']['step_ms']:.2f} (information)")
    out = dict(headline=full["headline"], full_wall_s=full["wall_s"], legs=legs,
               b8_over_b4_step=t8 / t4, sanity_b4_vs_b8=d.get("SANITY_FAIL_b4_vs_b8"),
               baseline_estimate=d["baseline_estimate"], bf16_speedup=d.get("bf16_speedup"),
               tf32=d["tf32"], fused_headline=dict(ab["headline"], wall_s=ab["wall_s"],
                                                   **fused_row),
               seconds=time.perf_counter() - t_phase)
    log(f"  phase 14 took {out['seconds']:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=REPO / "build" / "chip_smoke",
                    help="directory for result.json, profile.txt and build.txt")
    cli = ap.parse_args()
    out_dir = cli.out
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the GPU path only", file=sys.stderr)
        return 2
    if not (REPO / "hoig_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (hoig_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from hoig_torch.data.synthetic import synthetic_batch, synthetic_environment
    from hoig_torch.geometry.conditioning import ConditioningConfig
    from hoig_torch.ops import _cuda
    from hoig_torch.train.environment import resolve_corner_engine
    from hoig_torch.train.model_api import (batch_as_torch, flow_eager, flow_only, forward_eager,
                                            forward_only)
    from hoig_torch.train.trainer import TrainConfig, build_generator

    # 1. the card
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    report = _cuda.build_all()
    build_s = time.perf_counter() - t0
    (out_dir / "build.txt").write_text("\n".join(f"--- {k}\n{v}" for k, v in report.items()))
    for name, text in report.items():
        lines = [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "smem" in ln or "spill" in ln or "wgmma" in ln]
        log(f"  {name}: " + ("; ".join(lines[-8:]) if lines else text.strip()[:200]))
    log(f"[2] kernels built in {build_s:.1f} s")
    from hoig_torch.ops import attn_fused as af

    from hoig_torch.ops import local_combine as lc

    tiling = af.kernel_tiling()
    check(tiling == af.TILING, f"attn_fused.cu's tile constants {tiling} != TILING {af.TILING}")
    log(f"  attn_fused tile constants agree with hoig_torch/ops/attn_fused.py: {tiling}")
    tiling = lc.kernel_tiling()
    check(tiling == lc.TILING, f"local_combine.cu's tile constants {tiling} != TILING {lc.TILING}")
    log(f"  local_combine tile constants agree with hoig_torch/ops/local_combine.py: {tiling}")

    # 3. main path once, counters from 0, kernel inputs recorded
    t0 = time.perf_counter()
    env = synthetic_environment(2, IMAGE, device="cuda")
    log(f"[3] synthetic environment {IMAGE} px built in {time.perf_counter() - t0:.1f} s "
        f"(faces {tuple(env['tables_np'].faces.shape)})")
    ccfg = ConditioningConfig(image_size=IMAGE)
    tcfg = TrainConfig(conv_dim=64, repeat_num=6,
                       corner_engine=resolve_corner_engine("auto", bf16=True),
                       compute_dtype=torch.bfloat16)
    check(tcfg.corner_engine == "shift", "bf16 must pick the shift engine")
    gen = build_generator(tcfg, device="cuda", seed=0)
    batch = batch_as_torch(synthetic_batch(BATCH, env["obj_verts"], image_size=IMAGE), "cuda")
    rec = Recorder()
    with recording(rec):
        torch.cuda.synchronize()
        _cuda.reset_launch_counts()
        outs = forward_eager(gen, flow_eager(batch, env, ccfg), batch, tcfg)
        torch.cuda.synchronize()
        launches = _cuda.launch_counts()
    log(f"  main path launches: {launches}")
    check(launches == LAUNCHES_PER_CALL, f"main path launches {launches} != {LAUNCHES_PER_CALL}")
    for name, n in LAUNCHES_PER_CALL.items():
        if name in rec.calls:
            check(len(rec.calls[name]) == n, f"{name}: {len(rec.calls[name])} calls recorded")
    check(all(torch.isfinite(o).all() for o in outs), "non-finite serving outputs")
    results = {
        "local_combine_tc": check_local_combine(rec.calls["local_combine_tc"]),
        "rasterizer": check_rasterizer(rec.calls["rasterizer"]),
        "table_gather": check_table_gather(rec.calls["table_gather"]),
    }
    del rec
    results["rasterizer"]["ties"] = check_rasterizer_ties()
    check_ragged_shapes()
    log("[3b] InstanceNorm kernels against their plain versions at the cells' shapes")
    norms = check_instance_norm()

    # 4. card against CPU
    log("[4] card vs CPU")
    cpu_cmp = compare_with_cpu()

    # 5. timing at 256 px, batch 4, bf16
    log(f"[5] serving call timing: {IMAGE} px, batch {BATCH}, bf16, shift engine, conv_dim 64, "
        "repeat 6")
    serve = time_serving(gen, env, ccfg, batch, tcfg, LAUNCHES_PER_CALL)

    # 5b. the serving calls' CUDA graphs against the eager bodies
    log(f"[5b] CUDA graphs of flow_only and forward_only against flow_eager and forward_eager: "
        f"hogan_dexycb b16, hogan_ho3dv3 b4 and b3 (the benchmark's configurations), {IMAGE} px; "
        f"card {card}")
    graphs = graph_phase(env)

    # 6. the fused attention engine
    log(f"[6] fused attention engine (corner_engine 'pallas'): {IMAGE} px, batch {BATCH}, bf16, "
        "conv_dim 64, repeat 6, the shift generator's weights")
    fused_results, fused, fused_regions = fused_phase(env, ccfg, batch, gen, tcfg)
    results.update(fused_results)

    # 7. the training step (and 8. the profiler window)
    log(f"[7] training step: {IMAGE} px, batch {BATCH}, bf16, shift engine, conv_dim 64, repeat 6, "
        "PatchGAN-4, VGG19 loss, mask BCE")
    for _ in range(2):  # phase 5b forgot the graphs: capture them before the profiler runs
        forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg)
    regions = {"hoig_serve": (lambda: forward_only(gen, flow_only(batch, env, ccfg), batch, tcfg), 2)}
    bwd_results, train, profile = training_phase(env, ccfg, batch, regions, fused_regions, out_dir)
    results.update(bwd_results)
    for path in ("serving", "training"):
        region = "hoig_serve_fused" if path == "serving" else "hoig_train_fused"
        fused[path]["device_ms"] = profile.get(region, {}).get("device_ms")
    del fused_regions
    # dG is built once per backward (by bwd-a-gsrc's entry point), dW runs on
    # the tensor cores, B4-bwd-c is bwd_c_kernel and bwd_c_gattn_kernel: one
    # launch each per attention layer; fold_kernel folds the gsrc projection's
    # margins and the fc_0 target half's edge pad: two per layer
    hw = profile.get("hoig_train_fused", {}).get("hand_written")
    want = {"dg_kernel": 9, "dw_tc_kernel": 9, "dw_kernel": 0, "bwd_c_kernel": 9,
            "bwd_c_gattn_kernel": 9, "fold_kernel": 18}
    if hw is None:
        log("  profiler: the fused step's launches by kernel not measured")
    else:
        got = {k: hw.get(k, {}).get("count", 0) for k in want}
        log(f"  profiler hoig_train_fused: launches per step {got}")
        check(got == want, f"fused step launches by kernel {got} != {want}")
    # the shift path's combines run on the tensor cores under bf16: both
    # forward combines of each layer, and (step) both sides of the R = 5
    # combine's backward and dsrc of the R = 3 one; the rasterizer is one
    # binning and one z-buffer kernel; (step) the two edge pads of each layer
    # fold their gradient (fold_kernel); with the bf16 remat defaults the
    # attention is kept, so the same kernels
    fwd_want = {"combine_fwd_tc_kernel": 18, "combine_fwd_kernel": 0, "bin_kernel": 1,
                "raster_kernel": 1, "fold_kernel": 0}
    step_want = dict(fwd_want, combine_bwd_src_tc_kernel=18, combine_bwd_v_tc_kernel=9,
                     combine_bwd_src_kernel=0, combine_bwd_v_kernel=0, fold_kernel=18)
    for region, want in (("hoig_serve", fwd_want), ("hoig_train", step_want),
                         ("hoig_train_remat", step_want)):
        hw = profile.get(region, {}).get("hand_written")
        if hw is None:
            log(f"  profiler: the launches by kernel of {region} not measured")
            continue
        got = {k: hw.get(k, {}).get("count", 0) for k in want}
        log(f"  profiler {region}: launches per {'call' if region == 'hoig_serve' else 'step'} {got}")
        check(got == want, f"{region} launches by kernel {got} != {want}")

    # 7 (e). the fp32 step as the drivers run it, and scatter_rows
    del gen, regions, outs
    torch.cuda.empty_cache()
    log(f"[7e] the fp32 training step as the drivers run it (TrainConfig(): f32, gather engine, "
        f"full remat), {IMAGE} px, batch {FP32_BATCH}, conv_dim 64, repeat 6; card {card}")
    results["scatter_rows"], fp32 = fp32_phase(env, ccfg)

    # 9. the drivers: train_torch.Train, then eval_torch.main from its checkpoint
    del batch
    torch.cuda.empty_cache()
    log(f"[9] drivers: train_torch.Train (3 steps) and eval_torch.main (shift, 2 batches; fused, "
        f"1 batch) on the synthetic dataset, {IMAGE} px, batch {BATCH}, bf16, conv_dim 64, "
        "repeat 6")
    drivers = driver_phase(out_dir, serve, train)

    # 10. data parallelism (hoig_torch.parallel) and the metric battery
    log(f"[10] data-parallel training (NCCL, one rank) and the metrics, {IMAGE} px, batch "
        f"{BATCH}, bf16, conv_dim 64, repeat 6")
    ddp = ddp_phase(env, ccfg, fp32.pop("reference"))
    ddp["torchrun"] = torchrun_phase(out_dir, drivers)
    metrics = metrics_phase(out_dir)

    # 11. off the main path
    log(f"[11] off the main path: the generic renderer ({IMAGE} px, batch {BATCH}, 2x "
        f"anti-aliasing), the exact rasterizer gradients, the block extractor, the UV fit, the "
        f"resume from a JAX run's trees; card {card}")
    offpath = offpath_phase(env, out_dir)

    # 12. the measuring tools
    log(f"[12] the measuring tools: profile_step_torch (fp32 batch 8 gather step; bf16 fused "
        f"serving call), attn_ab_torch ({IMAGE} px, batch {BATCH}), the FLOP walk; card {card}")
    tools = tools_phase(env, out_dir, serve, train)

    # 13. real-layout data without cv2
    log(f"[13] real-layout data without cv2: the native reader on the committed fixtures, "
        f"train_torch.py --dataset_mode hov3 (3 steps) and eval_torch.py --dataset_mode ycb (1 "
        f"batch), {IMAGE} px, batch {BATCH}, bf16, conv_dim 64, repeat 6; card {card}")
    real_data = real_data_phase(out_dir, drivers)

    # 14. the benchmark
    log(f"[14] bench_torch.py: full mode (train_bf16, gen_fwd, train_bf16_b8, train_bf16_dexycb, "
        f"train_fp32; 256 px, conv_dim 64, repeat 6), then the headline alone with the fused "
        f"engine; card {card}")
    bench = bench_phase(out_dir, serve, train, fused)

    # 15. report
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = results[name]
        on_fused = name in FUSED_BF16.values()
        step_launches = (fused["training"]["launches"] if on_fused else
                         fp32["launches"] if name == "scatter_rows" else train["launches"])
        call_launches = fused["serving_launches"] if on_fused else launches
        row = dict(name=name, route="cuda", source=src, replaces=replaces,
                   launches=step_launches[name], launches_serving=call_launches.get(name, 0),
                   max_abs_err=r["max_abs_err"], ms=r["ms"],
                   plain_ms=r["plain_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                   library_ms=r["library_ms"])
        row.update({k: r[k] for k in ("library", "yardstick_ms", "yardstick", "f32_ms",
                                      "f32_bound_ms", "replaced_ms", "replaced", "order_ms",
                                      "sum_ms", "functions") if k in r})
        if name in RENDER_LAUNCHES:
            # launches of one renderer.render_rgb call (2x anti-aliasing) in phase 11
            row["launches_renderer"] = offpath["renderer"]["calls"]["render_rgb"]["launches"].get(
                name, 0)
        kernels.append(row)
    detail = dict(card=card, torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
                  kernels=results, instance_norm=norms, cpu_compare=cpu_cmp, serving=serve,
                  graphs=graphs, training=train,
                  fp32=fp32, fused=fused, profile=profile, drivers=drivers, ddp=ddp, metrics=metrics,
                  offpath=offpath, tools=tools, real_data=real_data, bench=bench)
    (out_dir / "result.json").write_text(json.dumps(detail, indent=1, default=str))
    log(json.dumps({"drivers": drivers}, default=str))
    log(json.dumps({"ddp": ddp, "metrics": metrics}, default=str))
    log(json.dumps({"offpath": offpath, "card": card}, default=str))
    log(json.dumps({"tools": {k: tools[k] for k in ("legs", "flop_check", "seconds")},
                    "card": card}, default=str))
    log(json.dumps({"real_data": real_data, "card": card}, default=str))
    log(json.dumps({"bench": {k: bench[k] for k in ("headline", "legs", "b8_over_b4_step",
                                                    "sanity_b4_vs_b8", "fused_headline",
                                                    "seconds")}, "card": card}, default=str))
    log(json.dumps({"graphs": graphs, "card": card}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"instance_norm": {k: norms[k] for k in (
        "worst_rel", "step_bf16_b32", "call_bf16_b16", "step_fp32_b32", "seconds")}}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
