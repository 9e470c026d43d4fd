#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on one CUDA card and check what comes out.

    python3 chip_smoke.py [--earlier-sepconv PATH] [--earlier-projection PATH]
                          [--earlier-warp PATH]

Run from a checkout: the port's package must sit beside this script. It
exits non-zero, printing no result, when there is no CUDA device or no
package; any failed check raises. ``--earlier-sepconv``,
``--earlier-projection`` and ``--earlier-warp`` name an earlier version of
csrc/sepconv.cu, csrc/flow_projection.cu or csrc/warp.cu (e.g. from ``git
show <commit>:meta_interpolation_tpu_torch/csrc/sepconv.cu``): it is built
beside the kernels and timed in turns with them. The first two take the
checkout's C interface; the third takes it too, told apart by its bf16
entry point (``warp_sample_bounded_forward_bf16``; the earlier bf16 kernel,
the gather design, then runs on both bf16 routes and every kernel is held
to it bit for bit), or the interface before the warp kernels took the
grid (K3 and its fy/fx gradient on coordinate planes), which runs inside
the plain glue of ``ops/warp_bounded.py`` (``grid_sample_bounded_ref``),
as that tree did. Phases, in order:

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every kernel under meta_interpolation_tpu_torch/csrc/, one
     nvcc per source, all started together; the registers and spill bytes
     of each kernel (ptxas), and no spill allowed;
  3. kernels: each held against its plain PyTorch version on the card at
     its main-path shape and ragged ones, and timed beside that version,
     the card's bound and, where one exists, the one PyTorch call that
     computes the same function:
       - SepConv K1/K2 at input 1x3x434x562, maps 1x51x384x512, and at
         edges of their tiles and strips: N = 2, F = 5 and F = 50, maps
         37x53 and 21x70;
       - the bounded grid sampler K3, its grid gradient K3-grad and that
         gradient's derivative K3-grad² at image 1x3x256x512 (RRIN's padded
         256x448 frame) and 37x53, both padding modes, both align_corners,
         R = 1, 3 and 8, displacements within and past R, smooth ones, on
         whole pixels and off every edge, and at 1x3x256x448 with border
         padding and align_corners=True (VoxelFlow's call); the autograd
         Function's first and second derivatives against the plain
         versions'; K3 and K3-grad also against F.grid_sample and
         aten.grid_sampler_2d_backward within range, K3-grad² against
         F.grid_sample's double backward where this PyTorch has one; all
         three timed at RRIN's and at VoxelFlow's call, K3-grad² also on
         smooth displacements, at 8x3x256x512 and (after the second-order
         training paths, which record it) at the shape those paths give it,
         in turns with --earlier-warp's; K3 and K3-grad's band entries (the
         row-sharded evaluation) on the first and last of 2 bands of a
         256x448 frame at each padding and align_corners, R = 8, bit for
         bit the whole-frame kernel's rows and against the plain version
         with row0, the bf16 and K3-grad² band calls refused, both timed on
         a 128-row band of a 1x3x256x512 image;
       - the bounded flow projection K4 at 1x256x448 (DAIN's served frame),
         R = 8, on a uniform and a smooth flow, and at 2x37x53 with R = 0,
         1, 16 (over 48 KB of shared memory) and 40 (a halo staged in
         bands), flows past R, integer landings on the bottom and right
         edges, every source sent to one cell and every source of a tile
         to one tile row; with and without depth; two calls must be
         bitwise equal, and with --earlier-projection the earlier design's
         proj and cnt too;
  4. main paths, each driven with every launch count set to 0 just before
     it and read just after:
       - SepConv: the CLI's scene-adaptive evaluation of the 8 synthetic
         validation clips (crop 256, Adamax, Meta-SGD, 3 inner steps), full
         256x448 Vimeo-size clips through run_validation_iter, and a
         crop-64 clip on the card against the same clip on the CPU;
       - SepConv meta-training (run_sepconv.sh: batch 3, Adamax, Meta-SGD,
         3 inner steps, first order): the double backward of the sepconv
         op (two K1 and one K2) against autograd through the plain
         version; the training CLI at crop 256 for 4 iterations with its
         checkpoint, K1/K2 launches per train iteration and per validation
         clip, and a run resumed from the checkpoint; seconds per train
         iteration, its profile and peak memory; one second-order
         iteration with the plain sepconv patched to raise, and its
         launches against the count derived above; first- and
         second-order outer gradients on the card against the CPU;
       - the warp models, one phase each, all with --fast_warp_range 8:
         RRIN (run_rrin.sh: Adam, LSLR, 0 training steps, plus 1
         evaluation step), SuperSloMo (run_superslomo.sh: Adam, Meta-SGD,
         1*Super, 1 + 1 steps) and VoxelFlow (run_voxelflow.sh: the same
         with 1*MSE): the CLI's clips with K3 and K3-grad launches a clip
         held to 6 and 4 (RRIN), 18 and 12 (SuperSloMo), 6 and 4
         (VoxelFlow), the plain sampler patched to raise; 256x448 episodes
         on the bounded and the exact warp (F.grid_sample, no kernel of
         ours) in turns and, with --earlier-warp, the earlier warp, with
         peak memory, profiles and the FLOPs of a forward; the largest
         blocks live at a bounded episode's peak (the allocator's recorded
         history); FlowStats' share of displacements past R on an exact
         episode; a 64x64 clip on the
         card against the CPU; then the device time and device ops of one
         RRIN warp call (forward and flow gradient) on each path;
       - meta-training of the warp models with --fast_warp_range 8
         (run_rrin.sh, run_superslomo.sh, run_voxelflow.sh as they stand)
         and of DAIN (run_dain.sh's hyperparameters, --mode train, tamed
         weights): a first-order train iteration at the preset's batch on
         256x256 crops (median of 3 after a warm-up, peak memory, profile
         and idle share), one second-order iteration at batch 1 (RRIN with
         1 inner step), K3 / K3-grad / K3-grad² launches held to the counts
         derived at WARP_TRAIN with the plain sampler patched to raise, and
         the outer gradient of a 64x64 clip on the card against the CPU
         (first order at the preset's rule, second order at the inner SGD
         rule; DAIN's CPU run handed the card's rectify inputs);
       - DAIN: a served 256x448 frame with the bounded projection (K4 also
         timed on the two flows that frame projects), in turns with the
         exact one; the CLI and an episode (exact projection, as the JAX
         meta system); a 64x64 clip on the card against the CPU, and a
         served 64x64 frame on the card against the CPU given the card's
         flows, depths and offsets;
       - CAIN in evaluation (run_cain.sh's hyperparameters: Adam,
         Meta-SGD, 1*L1, 1 step; full architecture): the CLI's clips, 256x448
         episodes with peak memory, a profile and the FLOPs of a forward,
         and a 64x64 clip on the card against the CPU; no kernel of ours;
       - CAIN meta-training (run_cain.sh: batch 8, 1 step, first order):
         the training CLI for one iteration with its checkpoint, seconds
         per train iteration with peak memory and a profile, one
         second-order iteration at batch 1, and the first-order outer
         gradient of a 64x64 clip on the card against the CPU;
       - --mode test (run_test.sh: CAIN, one evaluation step; then SepConv
         with Adamax and Meta-SGD) on 6 synthetic 256x448 frames in a
         temporary directory, x2 and then x4 on its own output: the names
         the JAX package writes, no frame overwritten, SepConv's K1 and K2
         launches a clip (6 and 4), and a written 64x64 frame on the card
         against the CPU within one 8-bit level;
       - the scene-adaptation engine (``engine``), each path a preset above
         with its flag: L2F on SepConv (run_sepconv.sh + --attenuate, the
         attenuator's gamma_mult set to 0.5 on both devices): the 256x448
         episode with K1 18 and K2 16 a clip (the attenuation's support
         pass adds 4 and 4), a first-order train iteration at batch 3 (54
         and 54), a 64x64 clip and the outer gradients, the attenuator's
         too, on the card against the CPU; per-step BN statistics on
         VoxelFlow (run_voxelflow.sh + --per_step_bn_statistics
         --fast_warp_range 8): the warp-training measurements above, the
         statistics after a train iteration card vs CPU, an evaluation
         episode leaving them as they were; the adversarial losses on
         SepConv (--loss 1*L1+0.005*GAN, the same with
         --disc_per_forward, and WGAN_GP): a train iteration at batch 3
         with the 1*L1 path's K1/K2 launches, and the discriminator after
         the step card vs CPU; the exact warp's second order (RRIN,
         SuperSloMo, VoxelFlow without --fast_warp_range, batch 1): an
         iteration at 256x256 and the outer gradient card vs CPU;
       - bf16 (``--dtype bfloat16``, after the kernel checks the bf16
         kernels: K1 and K2, banded products on the tensor cores, within
         one bf16 ulp of max + 1e-5 of the float32 kernels on the widened
         inputs, rounded, and of their plain bf16 versions, with at most
         1 % of the outputs differing at all from the former (the share
         printed per shape); K3 and K3-grad within one bf16 ulp of max +
         1e-5 of their plain bf16 versions at every warp case, a bf16 grid
         too, and at two C = 5 cases past the tiled kernels' limit (the
         gather route; each case's route printed, both taken), bit for bit
         the gather kernels and, with --earlier-warp, the earlier bf16
         kernels; K3-grad² (its bf16 tile kernel, and past its limit its
         float32 kernel widened, at one more case, R = 80) and K4 bit for
         bit their float32 kernels on the widened operands, K3-grad² also
         within one bf16 ulp of its plain version, one call's device ops
         against the widened call's, and timed at the K3-grad² shapes
         (1x and 8x RRIN frames, smooth displacements, VoxelFlow's call)
         in turns with the widened call; each bf16 kernel timed in turns
         with its float32 kernel, at its bf16 bytes' bound and, for K1 and
         K2, the bf16 tensor-core rate; with --earlier-sepconv the earlier
         bf16 K1 and K2 in turns too; K3 and K3-grad also at 1x3x256x512
         and RRIN's served batch 8x3x256x512 in turns with the gather
         kernels and the earlier ones, beside bound and library): every
         preset's 256x448 evaluation episode and first-order train
         iteration in float32 and bf16 in turns, with PSNR, peak memory, a
         profile and the same launches as float32 (the bf16 paths with the
         plain versions and the float32 entry points of K1, K2, K3,
         K3-grad and K3-grad² patched to raise), a second-order bf16
         VoxelFlow iteration (K3-grad²'s bf16 kernel), bench.py's serving
         forwards (every weight in bf16 at its batches and options) in
         frames a second beside float32, and a 64x64 clip of six presets
         in bf16 on the card against the CPU (DAIN's CPU side handed the
         card's flows, log depths and offsets), within twice the CPU's own
         bf16 − float32 difference plus 1e-5 of the largest value (the
         card's side three
         times as it runs, their spread printed, then twice under
         cudnn.deterministic, and for CAIN torch.use_deterministic_algorithms
         too, where the two must agree bit for bit; the first of those two
         is held to the limit);
       - the rest of the package (``rest``): SepConv first-order train
         iterations at run_sepconv.sh's preset under --loss
         1*L1+0.1*VGG22+1*SSIM and 1*VGGP in turns with 1*L1 (the same K1
         and K2 launches; seconds, peak memory) and each one's outer
         gradient of a 64x64 clip card vs CPU; the evaluation CLI with
         --lpips (the val line carries LPIPS) and LPIPS of a 256x448
         prediction card vs CPU; --profile_dir on the evaluation CLI at
         64x64 (the trace names K1's kernel once a K1 launch); --remat on
         SepConv and on VoxelFlow with --fast_warp_range 8, first and
         second order, with and without it in turns (seconds, peak
         memory; K1 or K3 launches up by the recomputed forwards, derived
         in remat_extra; outer gradients unchanged); the legacy trainers
         on SepConv (a MAML step, a Reptile step and an evaluation
         episode at batch 4 on 256x256 crops, launches held to
         LEGACY_LAUNCHES, each card vs CPU on a 64x64 clip) and one epoch
         of each of the four legacy command lines; the native loader
         (prep.cpp built with g++, no fallback; a batch bit for bit the
         numpy transcription of the C arithmetic, within one ulp of the
         numpy path); DAIN's off-path ops at 256x448 card vs CPU;
       - task parallelism (``parallel``): run_sepconv.sh at batch 4 on 2
         ranks of the one card over gloo (``--mesh_shape 2``, started by
         parallel/launch.spawn, the CLI in each), a warm-up and a timed
         train iteration of 2 tasks a rank and the epoch's validation:
         28 K1 and 28 K2 a rank an iteration, 14/12 a validation clip; the
         first iteration against one process on the same batch and
         weights on the card (the loss within 1e-6, each group's gradient
         before the step within 1e-5 of its norm plus twice the spread of
         two one-process runs, the weights after the Adamax step within
         the bound the gradients' difference puts on it,
         adamax_step_bound); K1/K2 built by both ranks at once into
         one fresh directory; halo_exchange bit for bit and
         spatial_sharded_apply on interior rows (1e-5) on CUDA tensors;
         and, beside the two, one rank alone over NCCL, where the row
         bands' collectives and their adjoints run too;
       - the exact row-sharded evaluation (``--spatial_shards 2`` on the
         same two gloo ranks, ``--mesh_shape 1x2``): the row-aware ops
         (convs with zero and reflected borders, the align_corners
         upsample, the global mean) on bands against the whole frame,
         values and gradients, on CUDA tensors; then through the CLI
         SepConv's evaluation (run_sepconv.sh) and CAIN's (run_cain.sh,
         the full architecture) on one 256x448 Vimeo-format septuplet,
         and SepConv's --mode test on one 720x1280 clip: 14/12 K1/K2 a
         rank a validation clip and 6/4 a test clip, each on a band of half
         the padded rows (shapes printed); RRIN's, SuperSloMo's and
         VoxelFlow's evaluation (their presets, --fast_warp_range 8) of the
         septuplet and RRIN's --mode test of the 720x1280 clip: K3/K3-grad
         a rank a clip 6/4, 18/12, 6/4 and 6/4, all on the band entries,
         each sampling the whole padded frame at the band's half of its
         rows (image, band grid and row0 printed); against one process on the
         card on the same batch and weights, the support gradients within
         1e-4 of their norm (CAIN's, which float32 rounds to ~2e-4 at
         random init, no farther from the float64 gradient than the one
         process's), and, the one process handed the ranks' inner
         gradients (Adam's first step is a sign near g = 0), the
         prediction within 1e-4 of its largest value + 1e-5, the PSNR
         within 1e-3 dB and the loss 1e-5; seconds a clip and each rank's
         peak memory beside the one process's;
  5. a JSON line of per-kernel results, each with its launches on every
     main path that runs it (``launches_by_path``: K1/K2 the training
     CLI's, the SepConv test runs' and the engine's L2F and adversarial
     paths'; K3/K3-grad the RRIN, SuperSloMo and VoxelFlow CLIs' and their
     training paths', the per-step BN ones included; K3-grad² their
     second-order training paths'; K1/K2 also the ``rest`` phase's SepConv
     paths and K3/K3-grad (K3-grad² in second order) its VoxelFlow
     --remat paths, and each ``parallel`` rank's run and its row-sharded
     evaluation and test runs, K3/K3-grad those of the warp models; K3
     and K3-grad also ``band``, their band call's times; K4 the served DAIN
     frames' and its bf16 paths'; the bf16 kernels of K1, K2, K3,
     K3-grad and K3-grad² five records of their own, K3's and K3-grad's
     with their times at one image and at the served batch, ``by_batch``
     and ``served_batch``; K3-grad²'s two
     with their times at GRAD2_SHAPES, ``by_shape``, and at the
     second-order main paths' shapes, ``main_path_shapes``) and their sum
     (``launches``), the card line again, and the last line {"ok": true,
     "device": {...}}.
"""
import argparse
import collections
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "meta_interpolation_tpu_torch"
# kernel vs plain version: only the summation order differs
TOL_REL, TOL_ABS = 1e-4, 1e-5
# card vs CPU on one small clip, as the port's CPU tests hold it to JAX
PRED_ATOL, PSNR_TOL_DB = 1e-4, 1e-3
EVAL_FLAGS = ["--model", "sepconv", "--mode", "val", "--optimizer", "Adamax",
              "--metasgd", "--inner_lr", "1e-5",
              "--number_of_evaluation_steps_per_iter", "3",
              "--val_batch_size", "1", "--loss", "1*L1"]
STEPS, PAIRS, CALLS = 3, 2, 2   # inner steps, support pairs, sepconvs a pass
K1_PER_CLIP = PAIRS * CALLS * STEPS + CALLS   # support passes + the query
K2_PER_CLIP = PAIRS * CALLS * STEPS           # support backwards
# SepConv meta-training: scripts/run_sepconv.sh (first order)
TRAIN_FLAGS = ["--model", "sepconv", "--mode", "train", "--dataset",
               "synthetic", "--loss", "1*L1", "--optimizer", "Adamax",
               "--batch_size", "3", "--val_batch_size", "1", "--inner_lr",
               "1e-5", "--outer_lr", "1e-5",
               "--number_of_training_steps_per_iter", "3",
               "--number_of_evaluation_steps_per_iter", "3", "--metasgd"]
TASKS = 3                      # the preset's batch
TRAIN_ITERS, TRAIN_REPS = 4, 2  # CLI iterations; timed iterations
# first order, a task: the evaluation episode's launches with the query on
# the tape, plus its backward (a K2 a query sepconv)
K1_PER_TRAIN_ITER = TASKS * K1_PER_CLIP
K2_PER_TRAIN_ITER = TASKS * (K2_PER_CLIP + CALLS)
# second order, a task: a support sepconv runs K1 forward and K2 in the
# inner gradient; the outer backward gives each such K2 node its double
# backward (2 K1, 1 K2) and each support K1 node its K2; the query runs
# K1 and K2 as in first order
K1_PER_TASK_SECOND_ORDER = 3 * PAIRS * CALLS * STEPS + CALLS
K2_PER_TASK_SECOND_ORDER = 3 * PAIRS * CALLS * STEPS + CALLS
# (N, H, W, F) of the double-backward checks: a ragged map, SepConv's
DOUBLE_BACKWARD_SHAPES = [(1, 37, 53, 51), (1, 384, 512, 51)]
# card vs CPU outer gradients: the loss, and each parameter group's
# gradient in norm (an inner Adamax step is ~lr·sign(g): an element whose
# support gradient is within the devices' rounding of zero may step the
# other way on one of them)
LOSS_RTOL, OUTER_GRAD_RTOL = 1e-5, 1e-3
# an adapted weight of CAIN's episode may differ between card and CPU by
# more than STEP_ATOL_OF_LR x the inner rate (a step of ~lr·sign(g) taken
# the other way, at g within rounding of zero) on this share of the
# weights: 8.4e-6 between a float32 and a float64 episode on the CPU, and
# the card's convolutions sum in other orders than the CPU's; a fault
# moves most weights
STEP_ATOL_OF_LR, CAIN_FLIP_SHARE = 0.1, 1e-4
# (N, H, W, F) of the K1/K2 checks; timed: last. H and W off the 16x16 and
# 16x8 tiles and the 4- and 2-pixel strips; F odd, even and small
KERNEL_SHAPES = [(1, 37, 53, 51), (2, 21, 70, 51), (2, 21, 70, 5),
                 (1, 37, 53, 50), (1, 384, 512, 51)]
# ptxas names of the K1/K2 kernels in csrc/sepconv.cu and of K4 in
# csrc/flow_projection.cu
SEPCONV_KERNELS = {"sepconv_forward": "sepconv_fwd_kernel",
                   "sepconv_grad_kernels": "sepconv_grad_kernels_kernel"}
PROJECTION_KERNELS = {"flow_projection_bounded": "flow_projection_kernel"}
CLI_CROP = 256                 # synthetic clips of the CLI run
FULL_HW = (256, 448)           # the Vimeo frame (kernel maps 384x512)
SMALL_HW = (64, 64)            # card vs CPU
# RRIN: run_rrin.sh's hyperparameters, one evaluation step, bounded warp
WARP_R = 8
WARP_RANGES = (1, 3, WARP_R)   # R of the K3 checks at the ragged shapes
RRIN_FLAGS = ["--model", "rrin", "--mode", "val", "--optimizer", "Adam",
              "--inner_lr", "1e-5", "--loss", "1*L1",
              "--number_of_training_steps_per_iter", "0",
              "--number_of_evaluation_steps_per_iter", "1",
              "--val_batch_size", "1", "--fast_warp_range", str(WARP_R)]
RRIN_STEPS, WARPS = 1, 2       # inner steps, warps a forward
QUERY = (2, 3, 4)         # (in0, target, in1) of the query
K3_PER_CLIP = PAIRS * WARPS * RRIN_STEPS + WARPS   # support passes + query
K3G_PER_CLIP = PAIRS * WARPS * RRIN_STEPS          # support backwards
# SuperSloMo (run_superslomo.sh) and VoxelFlow (run_voxelflow.sh): Adam,
# Meta-SGD, 1 training and 1 evaluation step, plus the bounded warp. Every
# warp's grid depends on the flow and every warped frame reaches the loss,
# so each support pass runs K3-grad once a warp; the frames are data, so no
# image gradient runs
WARP_MODEL_FLAGS = ["--mode", "val", "--optimizer", "Adam", "--metasgd",
                    "--inner_lr", "1e-5",
                    "--number_of_training_steps_per_iter", "1",
                    "--number_of_evaluation_steps_per_iter", "1",
                    "--val_batch_size", "1", "--fast_warp_range", str(WARP_R)]
SSM_FLAGS = ["--model", "superslomo", "--loss", "1*Super"] + WARP_MODEL_FLAGS
VF_FLAGS = ["--model", "voxelflow", "--loss", "1*MSE"] + WARP_MODEL_FLAGS
WARP_MODEL_STEPS = 1
SSM_WARPS, VF_WARPS = 6, 2     # warps a forward
K3_PER_CLIP_SSM = PAIRS * SSM_WARPS * WARP_MODEL_STEPS + SSM_WARPS   # 18
K3G_PER_CLIP_SSM = PAIRS * SSM_WARPS * WARP_MODEL_STEPS             # 12
K3_PER_CLIP_VF = PAIRS * VF_WARPS * WARP_MODEL_STEPS + VF_WARPS      # 6
K3G_PER_CLIP_VF = PAIRS * VF_WARPS * WARP_MODEL_STEPS               # 4
# the warp models' main paths: (flags, K3, K3-grad launches a clip)
WARP_MODELS = {"rrin": (RRIN_FLAGS, K3_PER_CLIP, K3G_PER_CLIP),
               "superslomo": (SSM_FLAGS, K3_PER_CLIP_SSM, K3G_PER_CLIP_SSM),
               "voxelflow": (VF_FLAGS, K3_PER_CLIP_VF, K3G_PER_CLIP_VF)}
# meta-training of the warp models with --fast_warp_range 8
# (scripts/run_rrin.sh, run_superslomo.sh and run_voxelflow.sh as they
# stand) and of DAIN (run_dain.sh's hyperparameters with --mode train,
# tamed weights, the exact projection): (flags, batch, inner steps, warps a
# forward). A task of n inner steps runs 2n support forwards and the query:
# first order (2n + 1)·w K3 and as many K3-grad (each support backward and
# the outer backward of the query); second order, the inner gradients on
# the tape, K3-grad² once a support warp (the outer backward through its
# K3-grad node) and K3-grad once more (through its K3 node): (2n + 1)·w
# K3, (4n + 1)·w K3-grad, 2n·w K3-grad², counted on the CPU with counting
# wrappers before the first chip run. Second order runs at batch 1 and
# RRIN there takes 1 inner step (at 0 it is first order)
TRAIN_COMMON = ["--mode", "train", "--inner_lr", "1e-5", "--outer_lr", "1e-5",
                "--val_batch_size", "1"]
WARP_TRAIN = {
    "rrin": (TRAIN_COMMON + ["--model", "rrin", "--loss", "1*L1",
                             "--optimizer", "Adam", "--batch_size", "8",
                             "--number_of_training_steps_per_iter", "0",
                             "--number_of_evaluation_steps_per_iter", "0",
                             "--fast_warp_range", str(WARP_R)], 8, 0, WARPS),
    "superslomo": (TRAIN_COMMON + ["--model", "superslomo", "--loss",
                                   "1*Super", "--optimizer", "Adam",
                                   "--metasgd", "--batch_size", "4",
                                   "--number_of_training_steps_per_iter", "1",
                                   "--number_of_evaluation_steps_per_iter",
                                   "1", "--fast_warp_range", str(WARP_R)],
                   4, 1, SSM_WARPS),
    "voxelflow": (TRAIN_COMMON + ["--model", "voxelflow", "--loss", "1*MSE",
                                  "--optimizer", "Adam", "--metasgd",
                                  "--batch_size", "8",
                                  "--number_of_training_steps_per_iter", "1",
                                  "--number_of_evaluation_steps_per_iter",
                                  "1", "--fast_warp_range", str(WARP_R)],
                  8, 1, VF_WARPS),
    "dain": (TRAIN_COMMON + ["--model", "dain", "--loss", "1*L1",
                             "--optimizer", "Adamax", "--metasgd",
                             "--batch_size", "6",
                             "--number_of_training_steps_per_iter", "1",
                             "--number_of_evaluation_steps_per_iter", "1"],
             6, 1, 0)}
SECOND_ORDER_STEPS = 1
WARP_TRAIN_REPS = 1
# VoxelFlow's K3 call: one frame of its padded 256x448 input, border
# padding, align_corners=True
VF_WARP_CASE = (1, 3, 256, 448, -WARP_R, WARP_R - 1, "uniform", WARP_R,
                True, "border")
# (H, W, lowest floor, highest floor) of the displacements of the warp
# checks' grids; timed: last. The middle one reaches past [-R, R-1], where
# the clamp acts.
WARP_SHAPES = [(37, 53, -WARP_R, WARP_R - 1),
               (37, 53, -WARP_R - 3, WARP_R + 2),
               (256, 512, -WARP_R, WARP_R - 1)]
# ptxas names of K3, K3-grad (float32, and bf16 on the gather route),
# K3-grad² (float32, and bf16 past its tile kernel's limit, widened) and
# the bf16 tile kernels of K3, K3-grad and K3-grad² in csrc/warp.cu, and
# of the kernels of the warp.cu that took coordinate planes (--earlier-warp)
GRAD2 = "warp_sample_bounded_grad_grid_backward"
GATHER_WARP_KERNELS = {
    "warp_sample_bounded_forward": "warp_sample_fwd_kernel",
    "warp_sample_bounded_grad_grid": "warp_sample_grad_grid_kernel",
    GRAD2: "warp_sample_grad_grid_backward_kernel"}
WARP_KERNELS = {**GATHER_WARP_KERNELS,
                "warp_sample_bounded_forward_bf16": "warp_fwd_bf16_tile_kernel",
                "warp_sample_bounded_grad_grid_bf16":
                    "warp_grad_grid_bf16_tile_kernel",
                f"{GRAD2}_bf16": "warp_grad_grid_backward_bf16_tile_kernel"}
# bf16 K3-grad² calls past its tile kernel's limit, which take the gather
# route (the float32 kernel on the widened operands) beside the C > 4 ones
# of BF16_GATHER_CASES: a window past 227 KB of texels (R = 80 on a
# 256x448 frame); the plain K3-grad² is the closed form, cheap at any R
GRAD2_GATHER_CASES = [(1, 3, 256, 448, -80, 79, "uniform", 80, True,
                       "border")]
# K3-grad² timed (label, n, c, h, w, grid kind, R, align_corners, padding):
# RRIN's padded frame on random and on smooth displacements within range,
# VoxelFlow's call and RRIN's served batch; the shapes the second-order
# main paths give it are timed after those paths ran (grad2_path_phase)
GRAD2_SHAPES = [("1x3x256x512 random", 1, 3, 256, 512, "library", WARP_R,
                 False, "zeros"),
                ("1x3x256x512 smooth", 1, 3, 256, 512, "smooth", WARP_R,
                 False, "zeros"),
                ("VoxelFlow's call", 1, 3, 256, 448, "library", WARP_R, True,
                 "border"),
                ("8x3x256x512 random", 8, 3, 256, 512, "library", WARP_R,
                 False, "zeros")]
# the band entries of K3 and K3-grad (the row-sharded evaluation): checked
# on the first and last of BAND_COUNT bands of a BAND_HW frame at each
# padding and align_corners, R = WARP_R, displacements past R; timed on a
# band of BAND_TIMED_HW's image (RRIN's padded frame), the first of 2.
# K3-grad²'s band entry (row-sharded second-order training): checked on the
# first, a middle, the last and a one-row band at each padding,
# align_corners, R of GRAD2_BAND_RANGES and channel count of
# GRAD2_BAND_CHANNELS; timed as the other two
BAND_HW, BAND_COUNT = (256, 448), 2
BAND_TIMED_HW = (256, 512)
GRAD2_BAND_RANGES, GRAD2_BAND_CHANNELS = (4, WARP_R), (3, 5)
EARLIER_WARP_KERNELS = {"warp_bounded_forward": "warp_bounded_fwd_kernel",
                        "warp_bounded_grad_frac":
                            "warp_bounded_grad_frac_kernel"}
# DAIN: served at 256x448 with the bounded projection; the CLI with the
# run_dain.sh hyperparameters (no --dataset hd, no --resume) and tamed
# random weights
PROJ_R, DAIN_SEED = 8, 12345
# (N, H, W, R, flow, span) of the K4 checks (flows of proj_flow); timed:
# the first two, DAIN's served shape
PROJ_CASES = [(1, 256, 448, PROJ_R, "uniform", PROJ_R),
              (1, 256, 448, PROJ_R, "smooth", PROJ_R),
              (2, 37, 53, PROJ_R, "uniform", 11),    # past R: some dropped
              (2, 37, 53, 0, "uniform", 2),
              (2, 37, 53, 1, "uniform", 3),
              (2, 37, 53, 16, "uniform", 18),        # over 48 KB shared
              (2, 37, 53, 40, "uniform", 42),        # a halo in bands
              (2, 37, 53, PROJ_R, "integer", PROJ_R + 1),
              (2, 37, 53, PROJ_R, "one_cell", 0),
              (2, 37, 53, PROJ_R, "one_row", 0)]
DAIN_QUERY = (2, 4)                # the served pair: frames 2 and 4
K4_PER_FRAME = 2                   # one projection a direction
DAIN_PTH = os.path.join(ROOT, "build", "dain_tamed.pth")
DAIN_FLAGS = ["--model", "dain", "--mode", "val", "--optimizer", "Adamax",
              "--metasgd", "--inner_lr", "1e-5", "--loss", "1*L1",
              "--number_of_training_steps_per_iter", "1",
              "--number_of_evaluation_steps_per_iter", "1",
              "--val_batch_size", "1", "--pretrained_model", DAIN_PTH]
# card vs CPU: a pixel may exceed the limit only within the reach, in
# pixels along each axis, of where a flow value near an integer (a floor
# flip) acts: the 2x2 cells a projected source lands on (1), the 4x4 filter
# window (2) and the rectify net's 21x21 receptive field (10)
NEAR_INT, FLIP_REACH = 1e-5, 13
# CAIN: run_cain.sh's hyperparameters (Adam, Meta-SGD, 1*L1, 1 training
# and 1 evaluation step) at the full architecture (depth 3, 5 groups of 12
# RCABs, 192 channels); evaluation at --val_batch_size 1, training at its
# batch 8, first order. Only cuDNN convolutions: no kernel of ours
CAIN_FLAGS = ["--model", "cain", "--loss", "1*L1", "--optimizer", "Adam",
              "--metasgd", "--inner_lr", "1e-5", "--outer_lr", "1e-5",
              "--number_of_training_steps_per_iter", "1",
              "--number_of_evaluation_steps_per_iter", "1",
              "--val_batch_size", "1"]
CAIN_EVAL_FLAGS = CAIN_FLAGS + ["--mode", "val"]
CAIN_TRAIN_FLAGS = CAIN_FLAGS + ["--mode", "train", "--batch_size", "8"]
CAIN_TASKS, CAIN_PARAMS = 8, 42_780_432
CAIN_EPISODE_REPS = 2
# --mode test: run_test.sh (CAIN, Adam, one evaluation step), and the same
# flags with SepConv's Adamax and Meta-SGD, on a directory of TEST_FRAMES
# frames f00.png ... f05.png, then again on its own output
TEST_FLAGS = ["--mode", "test", "--dataset", "test", "--img_fmt", "png",
              "--number_of_evaluation_steps_per_iter", "1"]
TEST_MODELS = {"cain": ["--model", "cain"],
               "sepconv": ["--model", "sepconv", "--optimizer", "Adamax",
                           "--metasgd"]}
TEST_FRAMES, TEST_STEPS = 6, 1
# a test clip: n steps on the two support pairs, then one forward
K1_PER_TEST_CLIP = PAIRS * CALLS * TEST_STEPS + CALLS     # 4n + 2
K2_PER_TEST_CLIP = PAIRS * CALLS * TEST_STEPS             # 4n
# what the JAX package's writer names: the inputs renamed to
# name_0.000000.png; x2 writes the midpoint of each window's frames 1 and 2
# (a zero second index counts as 1.0), x4 then between those
TEST_INPUTS = [f"f{i:02d}_0.000000.png" for i in range(TEST_FRAMES)]
TEST_NAMES = {"x2": ["f01_0.500000.png", "f02_0.500000.png",
                     "f03_0.500000.png"],
              "x4": ["f01_0.250000.png", "f01_0.750000.png",
                     "f02_0.250000.png", "f02_0.750000.png",
                     "f03_0.250000.png", "f03_0.750000.png"]}
# the scene-adaptation engine's paths (L2F, per-step BN statistics, the
# adversarial losses, the exact warp's second order), each a preset above
# with its flag. The attenuator's multiplier starts at 0, where gamma is 1
# whatever it computes, so the checks set it to GAMMA_MULT on both devices
GAMMA_MULT = 0.5
L2F_EVAL_FLAGS = EVAL_FLAGS + ["--attenuate"]
L2F_TRAIN_FLAGS = TRAIN_FLAGS + ["--attenuate"]
# the attenuation's first-order support gradient, before the inner loop:
# every support pair's forward and backward, K1 and K2 a sepconv call
K1_L2F = K2_L2F = PAIRS * CALLS
# run_voxelflow.sh with --per_step_bn_statistics (and --fast_warp_range 8)
PSBN_TRAIN = (WARP_TRAIN["voxelflow"][0] + ["--per_step_bn_statistics"],
              ) + WARP_TRAIN["voxelflow"][1:]
# VoxelFlow's first-order outer gradient with per-step BN statistics, card
# vs CPU, is held at the inner SGD rule and shown at the preset's Adam: the
# first Adam step is ~lr·sign(g), and through the batch statistics the
# elements whose support gradient is within the devices' rounding of zero
# and step the other way move the query gradient by 2.1e-3 of its norm
# (PR 11 run M; 1.5e-5 at the inner SGD rule)
# a per-step BN statistic, card vs CPU: within this share of the largest
# plus an absolute floor (the statistics are O(1) and summed in other
# orders on the two devices)
BN_RTOL, BN_ATOL = 1e-4, 1e-5
# run_sepconv.sh with a GAN term: the default cadence, the reference's
# (--disc_per_forward) and WGAN-GP
GAN_PATHS = {
    "gan": TRAIN_FLAGS + ["--loss", "1*L1+0.005*GAN"],
    "gan_per_forward": TRAIN_FLAGS + ["--loss", "1*L1+0.005*GAN",
                                      "--disc_per_forward"],
    "wgan_gp": TRAIN_FLAGS + ["--loss", "1*L1+0.005*WGAN_GP"]}
# the discriminator after a step, card vs CPU: Adam's first steps are
# ~lr·sign(g), so an element whose gradient is within the devices'
# rounding of zero steps the other way: each within 2.5·lr a step, and
# after one step at most this share off by more than 0.1·lr (measured
# 3.2e-3 after GAN's step, PR 11 run M: the card's convolutions sum in
# other orders than the CPU's and the CPU tests' JAX; sequential
# single-item steps amplify such flips, see tests/test_torch_adversarial.py)
DISC_FLIP_SHARE = 1e-2
# the card-vs-CPU checks of the engine take 1 inner step (the CPU side's
# time)
ENGINE_CHECK_STEPS = ["--number_of_training_steps_per_iter", "1",
                      "--number_of_evaluation_steps_per_iter", "1"]
KERNELS = ("sepconv_forward", "sepconv_grad_kernels",
           "warp_sample_bounded_forward", "warp_sample_bounded_grad_grid",
           "warp_sample_bounded_grad_grid_backward",
           "flow_projection_bounded")
# data-sheet peaks: fp32 outside the tensor cores (FLOP/s), device memory
# (bytes/s) and dense bf16 on the tensor cores (FLOP/s); first name that
# the card's name contains wins
PEAKS = [("H100 PCIe", 51.2e12, 2.0e12, 756e12),
         ("H100 NVL", 60.0e12, 3.9e12, 835e12),
         ("H100", 67.0e12, 3.35e12, 989e12),
         ("H200", 67.0e12, 4.8e12, 989e12)]


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def _peak_row(name):
    for row in PEAKS:
        if row[0] in name:
            return row
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def peaks(name):
    """(fp32 FLOP/s outside the tensor cores, device memory bytes/s)."""
    return _peak_row(name)[1:3]


def bf16_tensor_peak(name):
    """Dense bf16 FLOP/s on the tensor cores."""
    return _peak_row(name)[3]


def call_ms(torch, fn, reps=20, warmup=3):
    """Median of ``reps`` CUDA-event timings of one eager call of ``fn``
    after warm-up: the host's launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_ms(torch, fn, reps=20, warmup=3, calls=20, stream=None):
    """The card's time for one call of ``fn``: ``calls`` calls captured
    back to back in one CUDA graph after warm-up, then the median of
    ``reps`` CUDA-event timings of a replay, over ``calls``. Inside a
    replay the host launches nothing, so what is timed is the card's work
    and the small gaps between its kernels, not the host's launch
    overhead, which is most of an eager call of a microsecond kernel.
    ``stream``: the stream to capture on (an autograd backward runs on the
    stream of its forward, so a backward is captured on that one)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    return call_ms(torch, graph.replay, reps, warmup) / calls


def max_err(got, want, what):
    err = (got - want).abs().max().item()
    lim = TOL_REL * want.abs().max().item() + TOL_ABS
    check(err <= lim, f"{what}: max|diff| {err:.3e} > {lim:.3e}")
    return err


def max_errs(got, want, what):
    """max_err of a tensor, or the largest over the parts of a tuple."""
    if isinstance(got, tuple):
        return max(max_err(a, b, f"{what}, output {i}")
                   for i, (a, b) in enumerate(zip(got, want)))
    return max_err(got, want, what)


def ptxas_report(log):
    """{entry function: {"registers", "spill", "stack"[, "smem"]}} from the
    log of ``nvcc -Xptxas -v``; spill counts the bytes stored and loaded,
    smem the static shared memory (ptxas names it only when there is
    some)."""
    report, name = {}, None
    for line in str(log).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            report[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            report[name]["stack"] = int(m.group(1))
            report[name]["spill"] = int(m.group(2)) + int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m and name:
            report[name]["smem"] = int(m.group(1))
    return report


def kernel_resources(log, what, entries, no_spill=True):
    """The registers, spill and stack bytes and static shared memory (where
    ptxas names some) of the kernels ``entries`` names ({wrapper: ptxas
    entry name}) from the build log of a source, the most over a
    template's instances; None where this run reused a built library.
    Fails on a spill if ``no_spill``: the kernels are designed to keep
    their state in registers."""
    report = ptxas_report(log)
    if not report:
        print(f"[build] {what}: library reused, no ptxas report")
        return None
    resources = {}
    for name, entry in entries.items():
        hits = [v for k, v in report.items() if entry in k]
        check(hits and all({"registers", "spill", "stack"} <= set(hit)
                            for hit in hits),
              f"{what}: no ptxas report for {entry}")
        res = resources[name] = {key: max(hit.get(key, 0) for hit in hits)
                                 for key in set().union(*hits)}
        print(f"[build] {what} {name}: {res['registers']} registers, "
              f"{res['spill']} bytes spilled, {res['stack']} bytes stack, "
              f"{res.get('smem', 0)} bytes static shared memory")
        check(not no_spill or res["spill"] == 0,
              f"{what} {name} spills {res['spill']} bytes")
    return resources


def sepconv_resources(log, what, no_spill=True):
    """K1's and K2's resources from the build log of a sepconv source."""
    return kernel_resources(log, what, SEPCONV_KERNELS, no_spill)


def with_attr(mod, name, value, fn):
    """``fn`` run with ``mod.<name>`` set to ``value``, restored after."""
    def run(*args):
        real = getattr(mod, name)
        setattr(mod, name, value)
        try:
            return fn(*args)
        finally:
            setattr(mod, name, real)
    return run


def on_library(mod, lib, fn):
    """``fn`` run with the wrappers of ``mod`` (ops/sepconv.py or
    ops/flow_projection_bounded.py) bound to ``lib``, a built version of
    their source (an earlier design, timed beside the kernels the port
    runs) in place of the checkout's."""
    return with_attr(mod, "_library", lambda: lib, fn)


def start_build(path, tag, source):
    """Start nvcc on a version of csrc/<source>.cu into build/<tag>/, with
    the kernels' own flags: (process, library path)."""
    from meta_interpolation_tpu_torch.ops import _build
    lib = os.path.join(ROOT, "build", tag, f"lib{source}.so")
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                             path], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, lib


def finish_build(bind, proc, lib, what, entries):
    """Wait for start_build's nvcc, report the resources of its kernels
    ``entries`` and load it with the C signatures that ``bind`` sets (a
    wrapper module's ``_bind``)."""
    import ctypes
    log, _ = proc.communicate()
    check(proc.returncode == 0, f"{what} build failed:\n{log}")
    kernel_resources(log, what, entries, no_spill=False)
    return bind(ctypes.CDLL(lib))


def in_turns(torch, fns, timer=None):
    """``timer`` (time_ms unless given) of the two ``fns`` in turns (first,
    second, second, first): one list of times per function."""
    timer = timer or time_ms
    times = ([], [])
    for i in (0, 1, 1, 0):
        times[i].append(timer(torch, fns[i]))
    return times


def kernel_phase(torch, sc, card, resources=None, earlier_lib=None):
    """Hold K1/K2 against their plain versions at every KERNEL_SHAPES
    entry; time both at the SepConv shape, in turns with the K1 and K2 of
    ``earlier_lib`` (an earlier design) where given. Returns the per-kernel
    records (launches filled in later)."""
    flops_peak, bw_peak = peaks(card)
    earlier = None if earlier_lib is None else (
        on_library(sc, earlier_lib, sc.sepconv_forward),
        on_library(sc, earlier_lib, sc.sepconv_grad_kernels))
    errs = {"k1": 0.0, "k2": 0.0}
    for n, h, w, f in KERNEL_SHAPES:
        gen = torch.Generator().manual_seed(n * 100000 + h * 1000 + w + f)
        c = 3
        inp = torch.rand(n, c, h + f - 1, w + f - 1, generator=gen).cuda()
        kv = torch.randn(n, f, h, w, generator=gen).cuda()
        kh = torch.randn(n, f, h, w, generator=gen).cuda()
        g = torch.randn(n, c, h, w, generator=gen).cuda()
        what = f"{n}x{h}x{w} F={f}"
        ref = sc.sepconv_ref(inp, kv, kh)
        errs["k1"] = max(errs["k1"], max_err(sc.sepconv_forward(inp, kv, kh),
                                             ref, f"K1 {what}"))
        gkv, gkh = sc.sepconv_grad_kernels(inp, g, kv, kh)
        rkv, rkh = sc.grad_kernels_ref(inp, g, kv, kh)
        errs["k2"] = max(errs["k2"], max_err(gkv, rkv, f"K2 gkv {what}"),
                         max_err(gkh, rkh, f"K2 gkh {what}"))
        # the autograd Function against autograd through the plain forward
        grads = []
        for fn in (sc.sepconv, sc.sepconv_ref):
            leaves = [t.clone().requires_grad_() for t in (inp, kv, kh)]
            (fn(*leaves) * g).sum().backward()
            grads.append([t.grad for t in leaves])
        for a, b, name in zip(*grads, ("gin", "gkv", "gkh")):
            max_err(a, b, f"SepConvFunction {name} {what}")
        torch.cuda.synchronize()
        print(f"[kernels] {what}: K1 and K2 agree with the plain versions "
              f"(max|diff| K1 {errs['k1']:.3e}, K2 {errs['k2']:.3e})")

    k1_ops = 2 * n * h * w * c * f * (f + 1)
    k2_ops = 2 * n * h * w * f * f * (c + 2)
    in_bytes = 4 * n * c * (h + f - 1) * (w + f - 1)
    img_bytes, map_bytes = 4 * n * c * h * w, 4 * n * f * h * w
    k1_bytes = in_bytes + 2 * map_bytes + img_bytes
    k2_bytes = in_bytes + img_bytes + 4 * map_bytes
    if earlier is not None:
        max_err(earlier[0](inp, kv, kh), ref, "earlier K1")
        for a, b, part in zip(earlier[1](inp, g, kv, kh), (rkv, rkh),
                              ("gkv", "gkh")):
            max_err(a, b, f"earlier K2 {part}")
    records = []
    for i, (name, err, fn, plain, ops, nbytes, line) in enumerate([
            ("sepconv_forward", errs["k1"],
             lambda: sc.sepconv_forward(inp, kv, kh),
             lambda: sc.sepconv_ref(inp, kv, kh), k1_ops, k1_bytes, 134),
            ("sepconv_grad_kernels", errs["k2"],
             lambda: sc.sepconv_grad_kernels(inp, g, kv, kh),
             lambda: sc.grad_kernels_ref(inp, g, kv, kh), k2_ops, k2_bytes,
             233)]):
        ms = time_ms(torch, fn)
        eager_ms = call_ms(torch, fn)
        plain_ms = time_ms(torch, plain)
        t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
        bound = max(t_ops, t_bytes)
        records.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/sepconv.cu",
            "replaces": f"meta_interpolation_tpu/ops/sepconv.py:{line}",
            "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None, "call_ms": eager_ms,
            "shape": f"in {n}x3x{h + f - 1}x{w + f - 1}, maps {n}x{f}x{h}x{w}",
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6})
        res = (resources or {}).get(name)
        res_txt = (f"{res['registers']} registers, {res['spill']} bytes "
                   f"spilled" if res else "registers not reported")
        print(f"[kernels] {name}: {ms:.4f} ms, eager call {eager_ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms, bound {bound:.4f} ms by "
              f"{records[-1]['bound_by']}, {bound / ms:.3f} of the bound "
              f"reached; {res_txt}; no single PyTorch call computes it, so "
              f"library_ms is null)")
        if earlier is None:
            print(f"[kernels] {name}: earlier design not given "
                  f"(--earlier-sepconv)")
            continue
        args = (inp, kv, kh) if i == 0 else (inp, g, kv, kh)
        new, old = in_turns(torch, (fn, lambda: earlier[i](*args)))
        print(f"[kernels] {name}, in turns (this, earlier, earlier, this): "
              f"this design {new[0]:.4f}, {new[1]:.4f} ms; earlier design "
              f"{old[0]:.4f}, {old[1]:.4f} ms; bound {bound:.4f} ms")
    return records


# profiles of one call's device ops, taken again where the profiler caught
# no device event (grad2_call_ops)
PROFILE_TRIES = 3


def device_time_by_kernel(torch, fn):
    """One run of ``fn`` under torch.profiler → (wall ms, device-busy ms,
    kernels sorted by device time). Only device events are summed: a host
    op's device time repeats that of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, host = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            rows.append((e.self_device_time_total / 1e3, e.count, e.key))
        elif e.device_type == DeviceType.CPU:
            host.append((e.self_cpu_time_total / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    return wall, sum(r[0] for r in rows), rows, host


def peak_blocks(trace, top=6):
    """Replay one device's allocator trace (torch.cuda.memory._snapshot()
    "device_traces"): the most bytes that its allocations held at once and
    the ``top`` largest blocks live at that moment, each as (bytes, the
    innermost frame, the innermost frame in the port's package)."""
    def frame(ev, where=""):
        for f in ev.get("frames") or ():
            if where in f["filename"]:
                return (f"{os.path.basename(f['filename'])}:{f['line']} "
                        f"{f['name']}")
        return "?"
    cur = peak = peak_at = 0
    for i, ev in enumerate(trace):
        if ev["action"] == "alloc":
            cur += ev["size"]
            if cur > peak:
                peak, peak_at = cur, i
        elif ev["action"] == "free_completed":
            cur -= ev["size"]
    live = {}
    for ev in trace[:peak_at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_completed":
            live.pop(ev["addr"], None)
    largest = sorted(live.values(), key=lambda ev: -ev["size"])[:top]
    return peak, [(ev["size"], frame(ev),
                   frame(ev, "meta_interpolation_tpu_torch"))
                  for ev in largest]


def peak_memory_by_block(torch, run, label):
    """One run of ``run`` with the allocator's history recorded: the bytes
    held before it, its own peak above them, and the largest blocks live at
    that peak (peak_blocks)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.memory._record_memory_history(max_entries=1_000_000,
                                             stacks="python")
    try:
        run()
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    peak, blocks = peak_blocks(trace)
    print(f"[memory] {label}: {base / 2**30:.3f} GiB held before, its own "
          f"peak {peak / 2**30:.3f} GiB above that over {len(trace)} "
          f"allocator events; largest blocks live at the peak:")
    for size, inner, ours in blocks:
        print(f"[memory]   {size / 2**20:10.1f} MiB  {inner}  ({ours})")


def warp_grid(torch, kind, n, h, w, lo, hi, align_corners, seed):
    """A CPU grid (N, H, W, 2) float32 of a K3 check, normalised as
    F.grid_sample reads it (made in float64). "uniform": displacements
    uniform over [lo, hi + 1) per axis, floors over [lo, hi]; "integer":
    whole displacements in [lo, hi], on whole pixels up to the float32
    rounding of the grid; "outside": the frame zoomed out by 1.3 around its
    centre, so that the edge pixels sample off every edge of the image;
    "library": floors in [lo, hi] with fractions in [0.05, 0.95], away from
    the whole pixels where another rounding of the coordinate (the library
    sampler's) could take another floor; "smooth": displacements of
    smooth_flow, at most min(-lo, hi) pixels, the kind a flow network
    gives."""
    gen = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    ys = torch.arange(h, dtype=f64)[None, :, None].expand(n, h, w)
    xs = torch.arange(w, dtype=f64)[None, None, :].expand(n, h, w)
    pos = torch.stack([xs, ys], -1)
    size = torch.tensor([w, h], dtype=f64)
    shape = (n, h, w, 2)
    uniform = lambda: torch.rand(shape, generator=gen, dtype=f64)
    whole = lambda: torch.randint(lo, hi + 1, shape, generator=gen).to(f64)
    if kind == "uniform":
        coord = pos + lo + uniform() * (hi + 1 - lo)
    elif kind == "integer":
        coord = pos + whole()
    elif kind == "outside":
        centre = (size - 1) / 2
        coord = (pos - centre) * 1.3 + centre + (uniform() - 0.5) * 0.6
    elif kind == "library":
        coord = pos + whole() + 0.05 + 0.9 * uniform()
    elif kind == "smooth":
        coord = pos + smooth_flow(torch, n, h, w, min(-lo, hi), seed).to(f64)
    else:
        raise ValueError(f"no grid kind {kind!r}")
    if align_corners:
        return (2 * coord / (size - 1) - 1).float()
    return ((2 * coord + 1) / size - 1).float()


# an earlier csrc/warp.cu with today's C interface is told apart by this
# symbol (its bf16 entry points)
GRID_WARP_SYMBOL = "warp_sample_bounded_forward_bf16"


def earlier_warp_kernels(path):
    """The ptxas names of the kernels of an earlier csrc/warp.cu: those of
    the gather design where the source has today's C interface, else those
    of the plane interface."""
    with open(path) as f:
        text = f.read()
    return GATHER_WARP_KERNELS if GRID_WARP_SYMBOL in text else \
        EARLIER_WARP_KERNELS


def bind_earlier_warp(lib):
    """An earlier csrc/warp.cu, loaded: ("grid", lib) with today's C
    signatures (ops/warp_bounded._bind) where it has GRID_WARP_SYMBOL,
    else ("planes", lib) with those of a source from before the kernels
    took the grid: K3 and its fy/fx gradient on coordinate planes."""
    import ctypes
    if hasattr(lib, GRID_WARP_SYMBOL):
        from meta_interpolation_tpu_torch.ops import warp_bounded as wb
        return "grid", wb._bind(lib)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.warp_bounded_forward.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.warp_bounded_forward.restype = i32
    lib.warp_bounded_grad_frac.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
    lib.warp_bounded_grad_frac.restype = i32
    return "planes", lib


def earlier_warp(torch, wb, lib):
    """The bounded sampler as the tree before the fused kernels ran it:
    the plain glue of ``wb.grid_sample_bounded_ref`` around ``lib``'s K3
    (on dy0/dx0 int32 and fy/fx planes) and its fy/fx gradient, each call
    in a ``torch.cuda.device`` context as that tree's wrappers were (their
    checks left out). Returns (sampler, K3, K3's fy/fx gradient)."""
    import functools
    from torch.autograd.function import once_differentiable

    def launch(fn, *args):
        with torch.cuda.device(args[0].device):
            code = fn(*(a.data_ptr() if torch.is_tensor(a) else a
                        for a in args),
                      torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"earlier warp kernel: cudaError {code}")

    def k3(img, dy0, dx0, fy, fx, r):
        n, c, h, w = img.shape
        out = torch.empty_like(img)
        launch(lib.warp_bounded_forward, *(t.contiguous() for t in
                                           (img, dy0, dx0, fy, fx)), out,
               n, c, h, w, r)
        return out

    def k3_grad(img, dy0, dx0, fy, fx, g, r):
        n, c, h, w = img.shape
        gfy, gfx = torch.empty_like(fy), torch.empty_like(fx)
        launch(lib.warp_bounded_grad_frac, *(t.contiguous() for t in
                                             (img, dy0, dx0, fy, fx, g)),
               gfy, gfx, n, c, h, w, r)
        return gfy, gfx

    class Accumulate(torch.autograd.Function):
        @staticmethod
        def forward(ctx, img, dy0, dx0, fy, fx, r, row0=0):
            check(row0 == 0 and dy0.shape[1] == img.shape[2],
                  "the earlier warp samples whole frames only")
            ctx.save_for_backward(img, dy0, dx0, fy, fx)
            ctx.r = r
            return k3(img, dy0, dx0, fy, fx, r)

        @staticmethod
        @once_differentiable
        def backward(ctx, g):
            img, dy0, dx0, fy, fx = ctx.saved_tensors
            gfy = gfx = gimg = None
            if ctx.needs_input_grad[3] or ctx.needs_input_grad[4]:
                gfy, gfx = k3_grad(img, dy0, dx0, fy, fx, g, ctx.r)
            if ctx.needs_input_grad[0]:
                gimg = wb.warp_bounded_grad_img_ref(img, dy0, dx0, fy, fx, g,
                                                    ctx.r)
            return gimg, None, None, gfy, gfx, None, None

    return (functools.partial(wb.grid_sample_bounded_ref,
                              warp=Accumulate.apply), k3, k3_grad)


def warp_checks(torch, wb, case, earlier=None):
    """Hold K3, K3-grad and GridSampleBoundedFunction against the plain
    composition (autograd through wb.grid_sample_bounded_ref), K3-grad
    against the closed form, and K3-grad² and the Function's double
    backward (the sampler's grid gradient differentiated in g and the
    grid) against autograd through the closed form, on one case (n, c, h,
    w, lo, hi, kind, R, align_corners, padding); with ``earlier``
    (earlier_warp's sampler) its output and grid gradient too. Returns
    (K3 error, K3-grad error, K3-grad² error)."""
    n, c, h, w, lo, hi, kind, r, align, padding = case
    seed = h * 1000 + w + hi + 17 * r + 3 * align
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand(n, c, h, w, generator=gen).cuda()
    g = torch.randn(n, c, h, w, generator=gen).cuda()
    grid = warp_grid(torch, kind, n, h, w, lo, hi, align, seed).cuda()
    what = (f"{n}x{c}x{h}x{w} {kind} grid floors [{lo}, {hi}], R={r}, "
            f"align_corners={align}, {padding}")
    opts = (r, align, padding)
    leaves = [t.clone().requires_grad_() for t in (img, grid)]
    ref = wb.grid_sample_bounded_ref(*leaves, *opts)
    (ref * g).sum().backward()
    ref_gimg, ref_ggrid = (t.grad for t in leaves)
    err_fwd = max_err(wb.warp_sample_bounded_forward(img, grid, *opts),
                      ref.detach(), f"K3 {what}")
    ggrid = wb.warp_sample_bounded_grad_grid(img, grid, g, *opts)
    err_grad = max(
        max_err(ggrid, wb.grid_sample_bounded_grad_grid_ref(img, grid, g,
                                                            *opts),
                f"K3-grad against the closed form, {what}"),
        max_err(ggrid, ref_ggrid, f"K3-grad against autograd, {what}"))
    leaves = [t.clone().requires_grad_() for t in (img, grid)]
    out = wb.GridSampleBoundedFunction.apply(*leaves, *opts)
    (out * g).sum().backward()
    max_err(leaves[0].grad, ref_gimg, f"GridSampleBoundedFunction gimg {what}")
    max_err(leaves[1].grad, ref_ggrid,
            f"GridSampleBoundedFunction ggrid {what}")
    v = torch.randn(n, h, w, 2, generator=gen).cuda()
    ref2 = wb.grid_sample_bounded_grad_grid_backward_ref(img, grid, g, v,
                                                         *opts)
    got2 = wb.warp_sample_bounded_grad_grid_backward(img, grid, g, v, *opts)
    err_grad2 = max(max_err(got2[0], ref2[0], f"K3-grad² gg {what}"),
                    max_err(got2[1], ref2[1], f"K3-grad² grid {what}"))
    leaf, g_leaf = grid.clone().requires_grad_(), g.clone().requires_grad_()
    first, = torch.autograd.grad(
        wb.GridSampleBoundedFunction.apply(img, leaf, *opts), leaf, g_leaf,
        create_graph=True)
    for got, want, part in zip(torch.autograd.grad(first, (g_leaf, leaf), v),
                               ref2, ("gg", "grid")):
        max_err(got, want, f"GridSampleBoundedFunction double backward "
                           f"{part} {what}")
    if earlier is not None:
        leaf = grid.clone().requires_grad_()
        out = earlier(img, leaf, *opts)
        (out * g).sum().backward()
        max_err(out.detach(), ref.detach(), f"earlier warp {what}")
        max_err(leaf.grad, ref_ggrid, f"earlier warp ggrid {what}")
    torch.cuda.synchronize()
    return err_fwd, err_grad, err_grad2


def warp_cases():
    """Every K3 check: (n, c, h, w, lo, hi, kind, R, align_corners,
    padding). The whole-pixel and off-the-edge ones take 2 images of 2
    channels: the kernels' instance for any C, and the batch index."""
    cases = []
    for align in (False, True):
        for padding in ("zeros", "border"):
            for h, w, lo, hi in WARP_SHAPES:
                for r in (WARP_RANGES if h < 100 else (WARP_R,)):
                    cases.append((1, 3, h, w, lo, hi, "uniform", r, align,
                                  padding))
            h, w, lo, hi = WARP_SHAPES[0]
            for kind in ("integer", "outside"):
                for r in (1, WARP_R):
                    cases.append((2, 2, h, w, lo, hi, kind, r, align,
                                  padding))
            h, w, lo, hi = WARP_SHAPES[-1]
            cases.append((1, 3, h, w, lo, hi, "smooth", WARP_R, align,
                          padding))
    return cases + [VF_WARP_CASE]


def warp_kernel_phase(torch, wb, card, resources=None, earlier=None,
                      earlier_lib=None):
    """Hold K3 and K3-grad against their plain versions at every
    warp_cases() entry and against the library calls within range; time
    both at the RRIN main-path shape and settings, beside the plain
    version, the bound and the library call, K3-grad² also at
    GRAD2_SHAPES (grad2_timing), and in turns with the earlier design where
    given: ``earlier`` (earlier_warp's (sampler, K3,
    K3-grad)) of the plane interface, or ``earlier_lib`` with today's C
    interface (warp_f32_against_earlier). Returns the per-kernel records
    (launches filled in later)."""
    import torch.nn.functional as F
    flops_peak, bw_peak = peaks(card)
    errs = {"fwd": 0.0, "grad": 0.0, "grad2": 0.0}
    cases = warp_cases()
    for case in cases:
        got = warp_checks(torch, wb, case,
                          None if earlier is None else earlier[0])
        for key, err in zip(("fwd", "grad", "grad2"), got):
            errs[key] = max(errs[key], err)
    print(f"[kernels] K3, K3-grad and K3-grad² agree with their plain "
          f"versions at {len(cases)} cases (max|diff| K3 {errs['fwd']:.3e}, "
          f"K3-grad {errs['grad']:.3e}, K3-grad² {errs['grad2']:.3e}); the "
          f"Function's first and second derivatives agree with autograd "
          f"through the plain versions"
          + ("; so does the earlier warp" if earlier is not None else ""))

    # RRIN's settings at its padded frame, within range (floors in
    # [-R, R-2], so that the clamp does not act and the library calls
    # compute the same function), on random displacements and on smooth
    # ones, the kind RRIN's flow network gives
    n, c, (h, w), r = 1, 3, WARP_SHAPES[-1][:2], WARP_R
    gen = torch.Generator().manual_seed(5)
    img = torch.rand(n, c, h, w, generator=gen).cuda()
    g = torch.randn(n, c, h, w, generator=gen).cuda()
    v = torch.randn(n, h, w, 2, generator=gen).cuda()
    opts = (r, False, "zeros")
    grids = {kind: warp_grid(torch, kind, n, h, w, -r, r - 2, False, 6
                             ).cuda() for kind in ("library", "smooth")}
    calls, streams = {}, {}
    for kind, grid in grids.items():
        lib_grad2, streams[kind] = library_double_backward(
            torch, img, grid, g, v, "zeros", False)
        calls[kind] = {
            "grad2": lambda grid=grid: wb.warp_sample_bounded_grad_grid_backward(
                img, grid, g, v, *opts),
            "lib_grad2": lib_grad2,
            "plain_grad2": lambda grid=grid: (
                wb.grid_sample_bounded_grad_grid_backward_ref(
                    img, grid, g, v, *opts)),
            "fwd": lambda grid=grid: wb.warp_sample_bounded_forward(
                img, grid, *opts),
            "grad": lambda grid=grid: wb.warp_sample_bounded_grad_grid(
                img, grid, g, *opts),
            "lib_fwd": lambda grid=grid: F.grid_sample(
                img, grid, mode="bilinear", padding_mode="zeros",
                align_corners=False),
            "lib_grad": lambda grid=grid: torch.ops.aten.grid_sampler_2d_backward(
                g, img, grid, 0, 0, False, [False, True])[1],
            "plain_fwd": lambda grid=grid: wb.grid_sample_bounded_ref(
                img, grid, *opts),
            "plain_grad": lambda grid=grid: wb.grid_sample_bounded_grad_grid_ref(
                img, grid, g, *opts)}
    # the library sampler may round a coordinate otherwise: held only on
    # the grid whose fractions keep away from whole pixels
    got = {k: fn() for k, fn in calls["library"].items()
           if k in ("fwd", "grad", "lib_fwd", "lib_grad", "grad2",
                    "lib_grad2") and fn is not None}
    torch.cuda.synchronize()
    lib_err = (max_err(got["fwd"], got["lib_fwd"],
                       "K3 against F.grid_sample"),
               max_err(got["grad"], got["lib_grad"],
                       "K3-grad against aten.grid_sampler_2d_backward"),
               max_errs(got["grad2"], got["lib_grad2"], "K3-grad² against "
                        "the double backward of F.grid_sample")
               if "lib_grad2" in got else None)
    print(f"[kernels] {n}x{c}x{h}x{w} in range, R={r}: K3 agrees with "
          f"F.grid_sample (max|diff| {lib_err[0]:.3e}), K3-grad with "
          f"aten.grid_sampler_2d_backward's grid gradient ({lib_err[1]:.3e})"
          + ("" if lib_err[2] is None else
             f", K3-grad² with F.grid_sample's double backward "
             f"({lib_err[2]:.3e})"))
    pixels = n * h * w
    records = []
    for name, key, lib_name, ops, nbytes, replaces in [
            ("warp_sample_bounded_forward", "fwd", "F.grid_sample",
             pixels * (40 + 7 * c), pixels * (8 + 8 * c),
             "meta_interpolation_tpu/ops/warp_pallas.py:86"),
            ("warp_sample_bounded_grad_grid", "grad",
             "aten.grid_sampler_2d_backward (grid only)",
             pixels * (50 + 16 * c), pixels * (16 + 8 * c),
             "meta_interpolation_tpu/ops/warp.py:310"),
            ("warp_sample_bounded_grad_grid_backward", "grad2",
             "F.grid_sample's double backward (GridSampler2DBackwardBackward "
             "at g and the grid)", pixels * (80 + 27 * c),
             pixels * (24 + 12 * c), "meta_interpolation_tpu/ops/warp.py:310")]:
        fn, smooth = calls["library"][key], calls["smooth"][key]
        ms, smooth_ms = time_ms(torch, fn), time_ms(torch, smooth)
        eager_ms = call_ms(torch, fn)
        plain_ms = time_ms(torch, calls["library"][f"plain_{key}"])
        lib_streams = ((streams["library"], streams["smooth"])
                       if key == "grad2" else (None, None))
        library_ms, library_smooth_ms = (
            None if calls[kind][f"lib_{key}"] is None else
            time_ms(torch, calls[kind][f"lib_{key}"], stream=stream)
            for kind, stream in zip(("library", "smooth"), lib_streams))
        t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
        bound = max(t_ops, t_bytes)
        records.append({
            "name": name, "route": "cuda",
            "source": f"{PACKAGE}/csrc/warp.cu", "replaces": replaces,
            "launches": None, "max_abs_err": errs[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "call_ms": eager_ms,
            "smooth_ms": smooth_ms, "library_smooth_ms": library_smooth_ms,
            "shape": f"img {n}x{c}x{h}x{w}, grid {n}x{h}x{w}x2 (random "
                     f"displacements; smooth_ms: smooth ones), R={r}, zeros, "
                     f"align_corners=False",
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6})
        res = (resources or {}).get(name)
        res_txt = (f"{res['registers']} registers, {res['spill']} bytes "
                   f"spilled" if res else "registers not reported")
        print(f"[kernels] {name}: {ms:.4f} ms on random displacements, "
              f"{smooth_ms:.4f} ms on smooth ones, eager call "
              f"{eager_ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
              f"{bound:.6f} ms by {records[-1]['bound_by']}, "
              f"{bound / ms:.3f} and {bound / smooth_ms:.3f} of the bound "
              f"reached; library {lib_name} "
              + ("not in this PyTorch" if library_ms is None else
                 f"{library_ms:.4f} and {library_smooth_ms:.4f} ms")
              + f"; {res_txt})")
    for rec, timing in zip(records, border_warp_timing(torch, wb,
                                                        flops_peak,
                                                        bw_peak)):
        rec["voxelflow_call"] = timing
    # K3-grad² at GRAD2_SHAPES, in turns with the earlier design's
    records[2]["by_shape"] = grad2_timing(torch, wb, card, GRAD2_SHAPES,
                                          earlier_lib, ("float32",))[
        "float32"]
    if earlier_lib is not None:
        warp_f32_against_earlier(torch, wb, earlier_lib, calls)
    if earlier is None:
        if earlier_lib is None:
            print("[kernels] K3, K3-grad: earlier design not given "
                  "(--earlier-warp)")
        return records
    # the earlier K3 and its fy/fx gradient on the planes its glue makes
    # of the same grids
    for kind, grid in grids.items():
        planes = []
        wb.grid_sample_bounded_ref(img, grid, *opts,
                                   warp=lambda *a: planes.append(a) or a[0])
        planes = planes[0][:5]
        for name, this, old in [
                ("warp_sample_bounded_forward", calls[kind]["fwd"],
                 lambda: earlier[1](*planes, r)),
                ("warp_sample_bounded_grad_grid", calls[kind]["grad"],
                 lambda: earlier[2](*planes, g, r))]:
            new_ms, old_ms = in_turns(torch, (this, old))
            new_call, old_call = in_turns(torch, (this, old), call_ms)
            print(f"[kernels] {name}, {kind} grid, in turns (this, earlier, "
                  f"earlier, this): card {new_ms[0]:.4f}, {new_ms[1]:.4f} "
                  f"ms, eager call {new_call[0]:.4f}, {new_call[1]:.4f} ms; "
                  f"the earlier "
                  f"{'K3' if 'forward' in name else 'K3 fy/fx gradient'} "
                  f"alone on its planes: card {old_ms[0]:.4f}, "
                  f"{old_ms[1]:.4f} ms, eager call {old_call[0]:.4f}, "
                  f"{old_call[1]:.4f} ms")
    return records


def grad2_band_checks(torch, wb):
    """K3-grad²'s band entry on the first, a middle, the last and a
    one-row band of a BAND_HW frame, at each padding, align_corners, R of
    GRAD2_BAND_RANGES and channel count of GRAD2_BAND_CHANNELS
    (displacements reaching past R): gg and the grid's cotangent bit for
    bit the whole-frame kernel's rows, and within TOL_REL·max + TOL_ABS of
    the plain version with ``row0``. Returns (band calls, largest error
    against plain)."""
    h, w = BAND_HW
    rows = h // BAND_COUNT
    bands = {"first": (0, rows), "middle": ((h - rows) // 2, rows),
             "last": (h - rows, rows), "one-row": (h // 3, 1)}
    checked, worst = 0, 0.0
    for r in GRAD2_BAND_RANGES:
        for c in GRAD2_BAND_CHANNELS:
            for align in (False, True):
                for padding in wb.PADDING_MODES:
                    seed = 41 + checked
                    gen = torch.Generator().manual_seed(seed)
                    img, g = (torch.rand(1, c, h, w, generator=gen).cuda(),
                              torch.randn(1, c, h, w, generator=gen).cuda())
                    v = torch.randn(1, h, w, 2, generator=gen).cuda()
                    grid = warp_grid(torch, "uniform", 1, h, w, -r - 3, r + 2,
                                     align, seed).cuda()
                    opts = (r, align, padding)
                    whole = wb.warp_sample_bounded_grad_grid_backward(
                        img, grid, g, v, *opts)
                    for name, (row0, n_rows) in bands.items():
                        sl = slice(row0, row0 + n_rows)
                        what = (f"K3-grad² on the {name} band (rows {row0}.."
                                f"{row0 + n_rows - 1}) of 1x{c}x{h}x{w}, "
                                f"R={r}, align_corners={align}, {padding}")
                        args = (img, grid[:, sl].contiguous(),
                                g[:, :, sl].contiguous(),
                                v[:, sl].contiguous())
                        got = wb.warp_sample_bounded_grad_grid_backward(
                            *args, *opts, row0=row0)
                        check(torch.equal(got[0], whole[0][:, :, sl])
                              and torch.equal(got[1], whole[1][:, sl]),
                              f"{what} is not the whole frame's rows")
                        want = wb.grid_sample_bounded_grad_grid_backward_ref(
                            *args, *opts, row0)
                        for part, a, b in zip(("gg", "grid"), got, want):
                            worst = max(worst, max_err(
                                a, b.detach(), f"{what}, {part} against "
                                               f"plain"))
                        checked += 1
    return checked, worst


def warp_band_phase(torch, wb, card, resources=None):
    """The band entries of K3, K3-grad and K3-grad²: K3 and K3-grad on the
    first and last of BAND_COUNT bands of a BAND_HW frame at each padding
    and align_corners, R = WARP_R, displacements reaching past R, each
    band call bit for bit the whole-frame kernel's rows and within
    TOL_REL·max + TOL_ABS of the plain version with ``row0``; K3-grad² as
    grad2_band_checks; the bf16 band calls raise. Then the three timed on
    the first band of a BAND_TIMED_HW image, random displacements within
    range (RRIN's padded frame), beside the plain version, the bound and
    the library call on the same band (K3-grad² has none: the card's
    PyTorch has no double backward of grid_sampler_2d_backward), K3-grad²
    with its registers and spill from ``resources`` (ptxas). Returns {K3
    name: timing, K3-grad name: timing, K3-grad² name: timing}."""
    import torch.nn.functional as F
    n, c, r = 1, 3, WARP_R
    h, w = BAND_HW
    rows = h // BAND_COUNT
    checked, worst = 0, {"fwd": 0.0, "grad": 0.0}
    for align in (False, True):
        for padding in wb.PADDING_MODES:
            seed = 31 + 2 * align + (padding == "border")
            gen = torch.Generator().manual_seed(seed)
            img = torch.rand(n, c, h, w, generator=gen).cuda()
            g = torch.randn(n, c, h, w, generator=gen).cuda()
            grid = warp_grid(torch, "uniform", n, h, w, -r - 3, r + 2, align,
                             seed).cuda()
            opts = (r, align, padding)
            whole = wb.warp_sample_bounded_forward(img, grid, *opts)
            whole_g = wb.warp_sample_bounded_grad_grid(img, grid, g, *opts)
            for row0 in (0, h - rows):
                sl = slice(row0, row0 + rows)
                what = (f"band rows {row0}..{row0 + rows - 1} of {n}x{c}x{h}x"
                        f"{w}, R={r}, align_corners={align}, {padding}")
                band = grid[:, sl].contiguous()
                gb = g[:, :, sl].contiguous()
                out = wb.warp_sample_bounded_forward(img, band, *opts,
                                                     row0=row0)
                ggrid = wb.warp_sample_bounded_grad_grid(img, band, gb, *opts,
                                                         row0=row0)
                check(torch.equal(out, whole[:, :, sl]),
                      f"K3 on {what} is not the whole frame's rows")
                check(torch.equal(ggrid, whole_g[:, sl]),
                      f"K3-grad on {what} is not the whole frame's rows")
                worst["fwd"] = max(worst["fwd"], max_err(
                    out, wb.grid_sample_bounded_ref(img, band, *opts,
                                                    row0=row0),
                    f"K3 on {what} against plain"))
                worst["grad"] = max(worst["grad"], max_err(
                    ggrid, wb.grid_sample_bounded_grad_grid_ref(
                        img, band, gb, *opts, row0), f"K3-grad on {what} "
                                                     f"against plain"))
                checked += 1
    refused = []
    band, gb = grid[:, rows:], g[:, :, rows:]
    for what, call in [
            ("bf16 K3", lambda: wb.warp_sample_bounded_forward(
                img.bfloat16(), band, *opts, row0=rows)),
            ("bf16 K3-grad", lambda: wb.warp_sample_bounded_grad_grid(
                img.bfloat16(), band, gb.bfloat16(), *opts, row0=rows)),
            ("bf16 K3-grad²", lambda: wb.warp_sample_bounded_grad_grid_backward(
                img.bfloat16(), band, gb.bfloat16(), torch.ones_like(band),
                *opts, row0=rows))]:
        try:
            call()
        except NotImplementedError:
            refused.append(what)
        else:
            check(False, f"the {what} band call did not raise")
    torch.cuda.synchronize()
    print(f"[kernels] K3 / K3-grad band entries: {checked} band calls of "
          f"{rows} of {h} rows (first and last band, both paddings and "
          f"align_corners, R={r}, floors in [{-r - 3}, {r + 2}]) bit for bit "
          f"the whole-frame kernel's rows; against the plain version with "
          f"row0 max|diff| {worst['fwd']:.3e} / {worst['grad']:.3e}; the "
          f"{', '.join(refused)} band calls raise")
    checked, worst["grad2"] = grad2_band_checks(torch, wb)
    torch.cuda.synchronize()
    print(f"[kernels] K3-grad² band entry: {checked} band calls (first, "
          f"middle, last and one-row bands of {h}x{w}, R in "
          f"{GRAD2_BAND_RANGES}, C in {GRAD2_BAND_CHANNELS}, both paddings "
          f"and align_corners, floors past R) bit for bit the whole-frame "
          f"kernel's rows; against the plain version with row0 max|diff| "
          f"{worst['grad2']:.3e}")

    flops_peak, bw_peak = peaks(card)
    h, w = BAND_TIMED_HW
    rows = h // BAND_COUNT
    gen = torch.Generator().manual_seed(37)
    img = torch.rand(n, c, h, w, generator=gen).cuda()
    g = torch.randn(n, c, rows, w, generator=gen).cuda()
    grid = warp_grid(torch, "library", n, h, w, -r, r - 2, False,
                     38)[:, :rows].contiguous().cuda()
    v = torch.randn(n, rows, w, 2, generator=gen).cuda()
    opts = (r, False, "zeros")
    calls = {
        "fwd": (lambda: wb.warp_sample_bounded_forward(img, grid, *opts,
                                                       row0=0),
                lambda: wb.grid_sample_bounded_ref(img, grid, *opts),
                lambda: F.grid_sample(img, grid, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=False)),
        "grad": (lambda: wb.warp_sample_bounded_grad_grid(img, grid, g,
                                                          *opts, row0=0),
                 lambda: wb.grid_sample_bounded_grad_grid_ref(img, grid, g,
                                                              *opts),
                 lambda: torch.ops.aten.grid_sampler_2d_backward(
                     g, img, grid, 0, 0, False, [False, True])[1]),
        "grad2": (lambda: wb.warp_sample_bounded_grad_grid_backward(
                      img, grid, g, v, *opts, row0=0),
                  lambda: tuple(t.detach() for t in
                                wb.grid_sample_bounded_grad_grid_backward_ref(
                                    img, grid, g, v, *opts)),
                  None)}
    # the band's work: its pixels' grid (and g, ggrid) and output, and the
    # image rows its taps can reach (the band + R, clipped)
    pixels, reach = n * rows * w, n * min(rows + r + 1, h) * w
    out = {}
    for key, name, ops, nbytes in (
            ("fwd", "warp_sample_bounded_forward", pixels * (40 + 7 * c),
             pixels * (8 + 4 * c) + reach * 4 * c),
            ("grad", "warp_sample_bounded_grad_grid", pixels * (50 + 16 * c),
             pixels * (16 + 4 * c) + reach * 4 * c),
            # grid, g and v in, gg and the grid's cotangent out (24 + 8C B
            # a pixel), grad2_timing's operations
            ("grad2", GRAD2, pixels * (80 + 27 * c),
             pixels * (24 + 8 * c) + reach * 4 * c)):
        kernel, plain, library = calls[key]
        err = max_errs(kernel(), plain(), f"{name} band against plain")
        lib_err = (None if library is None else max_err(
            kernel(), library(), f"{name} band against the library"))
        t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
        out[name] = {
            "shape": f"img {n}x{c}x{h}x{w}, grid and output rows 0..{rows - 1}"
                     f" ({n}x{rows}x{w}x2), R={r}, zeros, align_corners=False",
            "max_abs_err": max(err, worst[key]), "library_err": lib_err,
            "ms": time_ms(torch, kernel), "call_ms": call_ms(torch, kernel),
            "plain_ms": time_ms(torch, plain),
            "library_ms": (None if library is None
                           else time_ms(torch, library)),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "mbytes": nbytes / 1e6}
        t = out[name]
        res = (resources or {}).get(name) if key == "grad2" else None
        if res is not None:
            t["registers"], t["spill"] = res["registers"], res["spill"]
        print(f"[kernels] {name} on a band ({t['shape']}): {t['ms']:.4f} ms "
              f"(eager call {t['call_ms']:.4f}; plain {t['plain_ms']:.4f}, "
              + ("library none (no double backward of "
                 "grid_sampler_2d_backward in this PyTorch)"
                 if library is None else
                 f"library {t['library_ms']:.4f}, against it {lib_err:.3e}")
              + f"; bound {t['bound_ms']:.6f} ms by {t['bound_by']}, "
              f"{t['mbytes']:.2f} MB, {t['bound_ms'] / t['ms']:.3f} reached"
              + ("" if res is None else
                 f"; {res['registers']} registers, {res['spill']} bytes "
                 f"spilled (ptxas, the whole-frame entry's kernel)")
              + f") ({card})")
    return out


def warp_f32_against_earlier(torch, wb, lib, calls):
    """The float32 K3, K3-grad and K3-grad² bit for bit those of ``lib``
    (an earlier csrc/warp.cu with today's C interface) at every
    warp_cases() entry, then K3 and K3-grad in turns with them (this,
    earlier, earlier, this) on ``calls`` (warp_kernel_phase's RRIN-frame
    calls on random and smooth displacements)."""
    def earlier(name):
        return on_library(wb, lib, getattr(wb, name))
    cases = warp_cases()
    for case in cases:
        n, c, h, w, lo, hi, kind, r, align, padding = case
        gen = torch.Generator().manual_seed(h * 1000 + w + hi + 17 * r + 2)
        img = torch.rand(n, c, h, w, generator=gen).cuda()
        g = torch.randn(n, c, h, w, generator=gen).cuda()
        v = torch.randn(n, h, w, 2, generator=gen).cuda()
        grid = warp_grid(torch, kind, n, h, w, lo, hi, align, 7).cuda()
        what = f"float32 {n}x{c}x{h}x{w} {kind}, R={r}, {align}, {padding}"
        opts = (r, align, padding)
        for name, args in (("warp_sample_bounded_forward", (img, grid)),
                           ("warp_sample_bounded_grad_grid", (img, grid, g)),
                           ("warp_sample_bounded_grad_grid_backward",
                            (img, grid, g, v))):
            got = getattr(wb, name)(*args, *opts)
            old = earlier(name)(*args, *opts)
            for i, (a, b) in enumerate(zip(
                    got if isinstance(got, tuple) else (got,),
                    old if isinstance(old, tuple) else (old,))):
                bitwise(torch, a, b, f"{name} output {i} {what} against the "
                                     f"earlier design")
    torch.cuda.synchronize()
    print(f"[kernels] float32 K3, K3-grad and K3-grad² are bit for bit the "
          f"earlier design's at {len(cases)} cases")
    for kind, fns in calls.items():
        for name, key in (("warp_sample_bounded_forward", "fwd"),
                          ("warp_sample_bounded_grad_grid", "grad")):
            new_ms, old_ms = in_turns(torch, (
                fns[key], on_library(wb, lib, fns[key])))
            print(f"[kernels] {name} float32, {kind} grid, in turns (this, "
                  f"earlier, earlier, this): this {new_ms[0]:.4f}, "
                  f"{new_ms[1]:.4f} ms; earlier {old_ms[0]:.4f}, "
                  f"{old_ms[1]:.4f} ms")


def grad2_inputs(torch, n, c, h, w, kind, r, align, seed=5):
    """(img, grid, g, v) float32 on the card for a K3-grad² call: the grid
    of warp_grid ``kind`` with floors in [-R, R-2]."""
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand(n, c, h, w, generator=gen).cuda()
    g = torch.randn(n, c, h, w, generator=gen).cuda()
    v = torch.randn(n, h, w, 2, generator=gen).cuda()
    grid = warp_grid(torch, kind, n, h, w, -r, r - 2, align, seed + 1).cuda()
    return img, grid, g, v


def widened_grad2(wb, lib=None):
    """The bf16 K3-grad² call as it ran before its bf16 kernel: the image
    and g widened, the float32 kernel (``lib``'s where given: an earlier
    csrc/warp.cu), gg rounded back; three device ops beside the kernel."""
    fn = wb.warp_sample_bounded_grad_grid_backward
    fn = fn if lib is None else on_library(wb, lib, fn)

    def run(img, grid, g, v, *opts):
        gg, ggrid = fn(img.float(), grid, g.float(), v, *opts)
        return gg.to(g.dtype), ggrid.to(grid.dtype)
    return run


def grad2_bf16(torch, wb, img, grid, g, v, opts, what, earlier_lib=None):
    """The bf16 K3-grad² on (img, grid, g, v), as the wrapper runs it, held
    bit for bit to the float32 kernel on the widened operands with gg
    rounded (widened_grad2), and to ``earlier_lib``'s float32 kernel so
    where given. Returns (gg, ggrid)."""
    got = wb.warp_sample_bounded_grad_grid_backward(img, grid, g, v, *opts)
    views = {"the float32 kernel on the widened operands": None}
    if earlier_lib is not None:
        views["the earlier design's, widened"] = earlier_lib
    for label, lib in views.items():
        want = widened_grad2(wb, lib)(img, grid, g, v, *opts)
        for part, a, b in zip(("gg", "grid"), got, want):
            bitwise(torch, a, b, f"K3-grad² {part} {what} against {label}")
    return got


def grad2_timing(torch, wb, card, shapes=GRAD2_SHAPES, earlier_lib=None,
                 dtypes=("float32", "bf16")):
    """K3-grad² at each of ``shapes`` (GRAD2_SHAPES' form), in ``dtypes``:
    float32, and bf16 (image, g and gg bf16; grid and v float32). Held bit
    for bit and timed in turns (this, other, other, this) with: in float32
    ``earlier_lib``'s K3-grad² where given (an earlier csrc/warp.cu); in
    bf16 the call as it ran before its bf16 kernel (widened_grad2, on this
    float32 kernel and on ``earlier_lib``'s where given). Beside the bound:
    bytes, each input read and each output written once (float32 24 + 12C
    B a pixel, bf16 24 + 6C). Returns {dtype: [a record a shape]}."""
    flops_peak, bw_peak = peaks(card)
    fn = wb.warp_sample_bounded_grad_grid_backward
    out = {dtype: [] for dtype in dtypes}
    for label, n, c, h, w, kind, r, align, padding in shapes:
        img, grid, g, v = grad2_inputs(torch, n, c, h, w, kind, r, align)
        opts = (r, align, padding)
        shape = (f"img {n}x{c}x{h}x{w}, grid {n}x{h}x{w}x2 float32 ({label}), "
                 f"R={r}, {padding}, align_corners={align}")
        pixels = n * h * w
        for dtype in dtypes:
            bf16 = dtype == "bf16"
            im, gr = ((img.to(torch.bfloat16), g.to(torch.bfloat16)) if bf16
                      else (img, g))
            args = (im, grid, gr, v, *opts)
            others = {}
            if bf16:
                grad2_bf16(torch, wb, *args[:4], opts, shape, earlier_lib)
                others["widened"] = widened_grad2(wb)
                if earlier_lib is not None:
                    others["earlier widened"] = widened_grad2(wb,
                                                              earlier_lib)
            elif earlier_lib is not None:
                others["earlier"] = on_library(wb, earlier_lib, fn)
                for part, a, b in zip(("gg", "grid"), fn(*args),
                                      others["earlier"](*args)):
                    bitwise(torch, a, b, f"K3-grad² {part} float32 {shape} "
                                         f"against the earlier design")
            per_pixel = 24 + (6 if bf16 else 12) * c
            t_ops = pixels * (80 + 27 * c) / flops_peak * 1e3
            t_bytes = pixels * per_pixel / bw_peak * 1e3
            rec = {"shape": shape, "dtype": dtype,
                   "route": (wb.bf16_window(n, c, h, w, r).route if bf16
                             else None),
                   "bound_ms": max(t_ops, t_bytes),
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "mbytes": pixels * per_pixel / 1e6}
            mine = []
            for other, run in others.items():
                t_this, t_other = in_turns(torch, (
                    lambda: fn(*args), lambda run=run: run(*args)))
                mine += t_this
                rec[f"ms_in_turns_with_{other}"] = t_this
                rec[f"{other}_ms_in_turns"] = t_other
            rec["ms"] = (statistics.median(mine) if mine
                         else time_ms(torch, lambda: fn(*args)))
            out[dtype].append(rec)
            print(f"[kernels] K3-grad² {dtype} at {shape}: {rec['ms']:.4f} "
                  f"ms" + ("" if rec["route"] is None else
                           f" ({rec['route']} route)")
                  + "".join(f"; in turns (this, {k}, {k}, this) this "
                            f"{rec[f'ms_in_turns_with_{k}'][0]:.4f}, "
                            f"{rec[f'ms_in_turns_with_{k}'][1]:.4f} ms, "
                            f"{k} {rec[f'{k}_ms_in_turns'][0]:.4f}, "
                            f"{rec[f'{k}_ms_in_turns'][1]:.4f} ms"
                            for k in others)
                  + f"; bound {rec['bound_ms']:.6f} ms by {rec['bound_by']} "
                  f"({rec['mbytes']:.2f} MB), "
                  f"{rec['bound_ms'] / rec['ms']:.3f} of it reached ({card})")
    torch.cuda.synchronize()
    return out


def library_double_backward(torch, img, grid, g, v, padding, align):
    """The double backward of ``F.grid_sample`` (PyTorch's
    GridSampler2DBackwardBackward) at g and the grid for the cotangent v
    of the grid gradient: (a call that runs it once, returning the two
    cotangents, and the stream it runs on), or (None, None) where this
    PyTorch has no derivative of ``aten::grid_sampler_2d_backward`` (2.11
    has none; 2.13 has one). The first-order graph is built on a stream
    of its own, on which the backward then runs, so that time_ms can
    capture it there."""
    import torch.nn.functional as F
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        g_leaf, leaf = g.clone().requires_grad_(), grid.clone().requires_grad_()
        out = F.grid_sample(img, leaf, mode="bilinear", padding_mode=padding,
                            align_corners=align)
        first, = torch.autograd.grad(out, leaf, g_leaf, create_graph=True)
    torch.cuda.current_stream().wait_stream(stream)

    def run():
        return torch.autograd.grad(first, (g_leaf, leaf), v,
                                   retain_graph=True)
    try:
        run()
    except RuntimeError as err:
        if "not implemented" not in str(err):
            raise
        print(f"[kernels] torch {torch.__version__} has no double backward "
              f"of F.grid_sample ({err}): no library time for K3-grad²")
        return None, None
    return run, stream


def border_warp_timing(torch, wb, flops_peak, bw_peak):
    """K3 and K3-grad at VoxelFlow's call (VF_WARP_CASE's shape, border
    padding, align_corners=True), within range, against F.grid_sample and
    aten.grid_sampler_2d_backward's grid gradient (border is padding mode
    1): errors, card ms, the plain version's and the library's ms, and the
    bound; K3-grad² likewise against F.grid_sample's double backward.
    Returns one dict a kernel (K3, K3-grad, K3-grad²)."""
    import torch.nn.functional as F
    n, c, h, w, _, _, _, r, align, padding = VF_WARP_CASE
    gen = torch.Generator().manual_seed(15)
    img = torch.rand(n, c, h, w, generator=gen).cuda()
    g = torch.randn(n, c, h, w, generator=gen).cuda()
    v = torch.randn(n, h, w, 2, generator=gen).cuda()
    grid = warp_grid(torch, "library", n, h, w, -r, r - 2, align, 16).cuda()
    opts = (r, align, padding)
    lib_grad2, stream = library_double_backward(torch, img, grid, g, v,
                                                padding, align)
    calls = {
        "grad2": (lambda: wb.warp_sample_bounded_grad_grid_backward(
                      img, grid, g, v, *opts),
                  lambda: wb.grid_sample_bounded_grad_grid_backward_ref(
                      img, grid, g, v, *opts),
                  lib_grad2),
        "fwd": (lambda: wb.warp_sample_bounded_forward(img, grid, *opts),
                lambda: wb.grid_sample_bounded_ref(img, grid, *opts),
                lambda: F.grid_sample(img, grid, mode="bilinear",
                                      padding_mode=padding,
                                      align_corners=align)),
        "grad": (lambda: wb.warp_sample_bounded_grad_grid(img, grid, g,
                                                          *opts),
                 lambda: wb.grid_sample_bounded_grad_grid_ref(img, grid, g,
                                                              *opts),
                 lambda: torch.ops.aten.grid_sampler_2d_backward(
                     g, img, grid, 0, 1, align, [False, True])[1])}
    pixels = n * h * w
    out = []
    for key, name, ops, nbytes in (
            ("fwd", "K3", pixels * (40 + 7 * c), pixels * (8 + 8 * c)),
            ("grad", "K3-grad", pixels * (50 + 16 * c),
             pixels * (16 + 8 * c)),
            ("grad2", "K3-grad²", pixels * (80 + 27 * c),
             pixels * (24 + 12 * c))):
        kernel, plain, library = calls[key]
        got = kernel()
        err = max_errs(got, plain(), f"{name} at VoxelFlow's call against "
                                     f"plain")
        lib_err = (None if library is None else
                   max_errs(got, library(), f"{name} at VoxelFlow's call "
                                            f"against the library"))
        t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
        timing = {"shape": f"img {n}x{c}x{h}x{w}, grid {n}x{h}x{w}x2, R={r}, "
                           f"{padding}, align_corners={align}",
                  "max_abs_err": err, "library_err": lib_err,
                  "ms": time_ms(torch, kernel),
                  "plain_ms": time_ms(torch, plain),
                  "library_ms": None if library is None else time_ms(
                      torch, library,
                      stream=stream if key == "grad2" else None),
                  "bound_ms": max(t_ops, t_bytes),
                  "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        lib_txt = ("no library call in this PyTorch" if library is None else
                   f"against the library {lib_err:.3e}")
        print(f"[kernels] {name} at VoxelFlow's call ({timing['shape']}): "
              f"max|diff| against plain {err:.3e}, {lib_txt}; "
              f"{timing['ms']:.4f} ms (plain {timing['plain_ms']:.4f}, "
              f"library " + ("null" if library is None else
                             f"{timing['library_ms']:.4f}")
              + f", bound {timing['bound_ms']:.6f} ms by "
                f"{timing['bound_by']})")
        out.append(timing)
    return out


def smooth_flow(torch, n, h, w, amplitude, seed, waves=3):
    """Seeded smooth flows (N, H, W, 2) float32 on the CPU, the kind a
    trained flow network gives: for each image and axis a sum of ``waves``
    sinusoids of at most 2 periods across the frame, with amplitudes that
    sum to at most ``amplitude`` pixels."""
    gen = torch.Generator().manual_seed(seed)
    ys = torch.arange(h, dtype=torch.float64)[:, None] / h
    xs = torch.arange(w, dtype=torch.float64)[None, :] / w
    flow = torch.zeros(n, h, w, 2, dtype=torch.float64)
    for b in range(n):
        for c in range(2):
            for _ in range(waves):
                ky, kx, phase, amp = torch.rand(4, generator=gen,
                                                dtype=torch.float64)
                flow[b, :, :, c] += (amplitude / waves * (0.5 + 0.5 * amp)
                                     * torch.sin(2 * math.pi * (
                                         2 * ky * ys + 2 * kx * xs + phase)))
    return flow.float()


def proj_flow(torch, kind, n, h, w, span, seed):
    """A CPU flow (N, H, W, 2) of a K4 check. "uniform": in [-span, span];
    "smooth": smooth_flow of amplitude span; "integer": integer offsets in
    [-span, span] with the landings clipped to [-1, H-1] x [-1, W-1], so
    that many land exactly on the bottom and right edges and some outside;
    "one_cell": every source lands on the centre cell; "one_row": every
    source lands on row 12 (tile row 1) in columns 0-31 (the first tile),
    which fills that row's lists (sources farther than R are dropped)."""
    gen = torch.Generator().manual_seed(seed)
    ys = torch.arange(h, dtype=torch.float32)[None, :, None].expand(n, h, w)
    xs = torch.arange(w, dtype=torch.float32)[None, None, :].expand(n, h, w)
    if kind == "uniform":
        return (torch.rand(n, h, w, 2, generator=gen) * 2 - 1) * span
    if kind == "smooth":
        return smooth_flow(torch, n, h, w, span, seed)
    if kind == "integer":
        k = torch.randint(-span, span + 1, (n, h, w, 2), generator=gen)
        return torch.stack([(xs + k[..., 0]).clamp(-1, w - 1) - xs,
                            (ys + k[..., 1]).clamp(-1, h - 1) - ys], -1)
    if kind == "one_cell":
        return torch.stack([w // 2 - xs, h // 2 - ys], -1)
    if kind == "one_row":
        return torch.stack([xs.clamp(0, 31) - xs, 12 - ys], -1)
    raise ValueError(f"no flow kind {kind!r}")


def k4_list_lengths(torch, flow, r):
    """(mean, largest) length of the list a warp of K4 builds on ``flow``
    (N, H, W, 2) at range r: for each tile row of 32 targets, the sources
    that land on that row and in those columns within their [-R, R+1]
    window, each counted once."""
    n, h, w, _ = flow.shape
    ys = torch.arange(h, device=flow.device)[None, :, None]
    xs = torch.arange(w, device=flow.device)[None, None, :]
    x2 = xs.to(torch.float32) + flow[..., 0]
    y2 = ys.to(torch.float32) + flow[..., 1]
    valid = (x2 >= 0) & (y2 >= 0) & (x2 <= w - 1) & (y2 <= h - 1)
    t = torch.floor(y2).clamp(0, h - 1).long()
    l = torch.floor(x2).clamp(0, w - 1).long()
    bt, rt = (t + 1).clamp(max=h - 1), (l + 1).clamp(max=w - 1)

    def kept(v, s):
        return (v - s >= -r) & (v - s <= r + 1)

    # the distinct rows a source lands on, and the distinct tiles of its
    # columns, each with whether it is kept
    rows = [(t, kept(t, ys)), (bt, kept(bt, ys) & ~(kept(t, ys) & (bt == t)))]
    lt, rtt = l // 32, rt // 32
    cols = [(lt, kept(l, xs)), (rtt, kept(rt, xs) & ~(kept(l, xs)
                                                      & (rtt == lt)))]
    tiles_x = (w + 31) // 32
    image = torch.arange(n, device=flow.device)[:, None, None]
    counts = torch.zeros(n * h * tiles_x, dtype=torch.long,
                         device=flow.device)
    for row, row_kept in rows:
        for tile, col_kept in cols:
            hit = valid & row_kept & col_kept
            counts += torch.bincount(((image * h + row) * tiles_x + tile)[hit],
                                     minlength=counts.numel())
    return counts.float().mean().item(), int(counts.max())


def k4_in_turns(torch, fpb, earlier, flow, depth, label):
    """K4 on one flow at PROJ_R in turns with ``earlier`` (an earlier
    design's wrapper): this, earlier, earlier, this."""
    new, old = in_turns(torch, (
        lambda: fpb.flow_projection_bounded(flow, depth, PROJ_R),
        lambda: earlier(flow, depth, PROJ_R)))
    print(f"[kernels] K4 on the {label} flow, in turns (this, earlier, "
          f"earlier, this): this design {new[0]:.4f}, {new[1]:.4f} ms; "
          f"earlier design {old[0]:.4f}, {old[1]:.4f} ms")


def projection_kernel_phase(torch, fpb, card, resources=None, earlier=None):
    """Hold K4 against its plain version at every PROJ_CASES entry, with
    identical hole sets, bitwise repeatable and, where ``earlier`` (an
    earlier design's wrapper) is given, bitwise equal to it; time K4 at
    DAIN's served shape on a uniform and a smooth flow, beside the exact
    scatter, in turns with ``earlier`` where given. Returns the kernel's
    record (launches and the served frame's times filled in later)."""
    flops_peak, bw_peak = peaks(card)
    err = 0.0
    for n, h, w, r, kind, span in PROJ_CASES:
        flow = proj_flow(torch, kind, n, h, w, span, n * 1000 + h + w + r
                         ).cuda()
        gen = torch.Generator().manual_seed(h + w + r)
        depth = (torch.rand(n, h, w, 1, generator=gen) + 0.3).cuda()
        for d in (depth, None):
            what = (f"{n}x{h}x{w} R={r} {kind} flow"
                    f"{f' in [-{span}, {span}]' if span else ''}, "
                    f"{'depth' if d is not None else 'no depth'}")
            proj, cnt = fpb.flow_projection_bounded(flow, d, r)
            again = fpb.flow_projection_bounded(flow, d, r)
            rproj, rcnt = fpb.project_ref(flow, d, r)
            err = max(err, max_err(proj, rproj, f"K4 proj {what}"),
                      max_err(cnt, rcnt, f"K4 cnt {what}"))
            check(torch.equal(cnt > 0, rcnt > 0), f"K4 hole set {what}")
            check(torch.equal(proj, again[0]) and torch.equal(cnt, again[1]),
                  f"K4 {what}: two calls differ")
            same = ""
            if earlier is not None:
                eproj, ecnt = earlier(flow, d, r)
                check(torch.equal(proj, eproj) and torch.equal(cnt, ecnt),
                      f"K4 {what}: not bitwise equal to the earlier design")
                same = ", bitwise equal to the earlier design"
            torch.cuda.synchronize()
            print(f"[kernels] K4 {what}: agrees with the plain version "
                  f"(max|diff| {err:.3e}), hole sets identical, "
                  f"{int((rcnt == 0).sum())} holes, two calls bitwise "
                  f"equal{same}")
            if kind == "uniform" and r == PROJ_R and span > r and d is not None:
                exact, _ = fpb.project_ref(flow, d)
                check((exact - proj).abs().max().item() > 1e-3,
                      "K4 dropped no source past R")

    n, h, w = 1, *FULL_HW
    gen = torch.Generator().manual_seed(7)
    flow = ((torch.rand(n, h, w, 2, generator=gen) * 2 - 1) * PROJ_R).cuda()
    depth = (torch.rand(n, h, w, 1, generator=gen) + 0.3).cuda()
    smooth = smooth_flow(torch, n, h, w, PROJ_R, seed=8).cuda()
    fn = lambda: fpb.flow_projection_bounded(flow, depth, PROJ_R)
    ms, eager_ms = time_ms(torch, fn), call_ms(torch, fn)
    smooth_ms = time_ms(
        torch, lambda: fpb.flow_projection_bounded(smooth, depth, PROJ_R))
    plain_ms = time_ms(torch, lambda: fpb.project_ref(flow, depth, PROJ_R))
    exact_ms = time_ms(torch, lambda: fpb.project_ref(flow, depth))
    # the function's bytes: flow (2 planes) and depth read, proj (2) and
    # cnt written; ~30 operations a source to land and weigh it
    nbytes, ops = 4 * n * h * w * 6, 30 * n * h * w
    t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
    rec = {"name": "flow_projection_bounded", "route": "cuda",
           "source": f"{PACKAGE}/csrc/flow_projection.cu",
           "replaces": "meta_interpolation_tpu/ops/flow_projection_pallas.py:96",
           "launches": None, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": None, "call_ms": eager_ms, "smooth_ms": smooth_ms,
           "served_ms": None,
           "shape": f"flow {n}x{h}x{w}x2, depth, R={PROJ_R}",
           "gflop": ops / 1e9, "mbytes": nbytes / 1e6}
    res = (resources or {}).get("flow_projection_bounded")
    res_txt = (f"{res['registers']} registers, {res['spill']} bytes spilled"
               if res else "registers not reported")
    lists = {label: k4_list_lengths(torch, f, PROJ_R)
             for label, f in (("uniform", flow), ("smooth", smooth))}
    print(f"[kernels] flow_projection_bounded: {ms:.4f} ms on the uniform "
          f"flow in [-{PROJ_R}, {PROJ_R}], {smooth_ms:.4f} ms on the smooth "
          f"one, eager call {eager_ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
          f"{rec['bound_ms']:.6f} ms by {rec['bound_by']}, "
          f"{rec['bound_ms'] / ms:.3f} of the bound reached; {res_txt}; "
          f"lists a warp (mean, largest): " + ", ".join(
              f"{label} {mean:.1f}, {top}" for label, (mean, top)
              in lists.items()) +
          f"; no single PyTorch call computes a scatter-average, so "
          f"library_ms is null; the exact index_add scatter takes "
          f"{exact_ms:.4f} ms)")
    if earlier is None:
        print("[kernels] flow_projection_bounded: earlier design not given "
              "(--earlier-projection)")
    else:
        k4_in_turns(torch, fpb, earlier, flow, depth, "uniform")
        k4_in_turns(torch, fpb, earlier, smooth, depth, "smooth")
    return [rec]


def timed(label, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, with its wall time printed."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    print(f"[time] {label}: {time.perf_counter() - t0:.1f} s")
    return out


def reset_launches(mods):
    for mod in mods:
        mod.reset_launches()


def launch_counts(mods):
    return {name: getattr(mod, name).launches for mod in mods
            for name in KERNELS if hasattr(mod, name)}


def profile_episode(torch, run, label, ours_key):
    """One episode under torch.profiler: wall, device busy, idle share, the
    device ops (kernels, memsets, copies) and the host's cudaLaunchKernel
    calls, the share of the kernels whose names hold ``ours_key``, and the
    top kernels by device time. Returns (device ops, cudaLaunchKernel)."""
    wall, busy, top, host = device_time_by_kernel(torch, run)
    print(f"[profile] {label} host ops by self CPU time: " + "; ".join(
        f"{key} {ms:.1f} ms {count}x" for ms, count, key in host[:8]))
    if busy <= 0:
        print("[profile] torch.profiler recorded no device time")
        return None, None
    ops = sum(count for _, count, _ in top)
    launches = sum(count for _, count, key in host
                   if key == "cudaLaunchKernel")
    ours = [row for row in top if ours_key and ours_key in row[2]]
    ours_ms = sum(ms for ms, _, _ in ours)
    print(f"[profile] one {label}: wall {wall:.1f} ms, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / wall:.3f}, {ops} device "
          f"ops, {launches} cudaLaunchKernel" + (
              f", {ours_key} kernels {ours_ms:.3f} ms "
              f"({ours_ms / busy:.4f} of busy)" if ours_key else ""))
    for ms, count, key in top[:12] + [r for r in ours if r not in top[:12]]:
        print(f"[profile]   {ms:9.3f} ms  {count:5d}x  {key[:90]}")
    return ops, launches


def card_vs_cpu(cfg, model, prepare=None):
    """The first small synthetic clip on the card and on the CPU;
    ``prepare(system)`` runs on each system first."""
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    preds_by_dev, psnr_by_dev = {}, {}
    for dev in ("cuda", "cpu"):
        system = SceneAdaptiveInterpolation(cfg, device=dev)
        if prepare is not None:
            prepare(system)
        clip = SyntheticSeptuplet(model=model, mode="val",
                                  size=SMALL_HW)[0][0][None]
        losses, preds = system.run_validation_iter(clip)
        preds_by_dev[dev] = preds.cpu()
        psnr_by_dev[dev] = losses["psnr"]
    diff = (preds_by_dev["cuda"] - preds_by_dev["cpu"]).abs().max().item()
    dpsnr = abs(psnr_by_dev["cuda"] - psnr_by_dev["cpu"])
    check(diff <= PRED_ATOL and dpsnr <= PSNR_TOL_DB,
          f"{model} card vs CPU at {SMALL_HW}: max|pred diff| {diff:.3e}, "
          f"PSNR diff {dpsnr:.3e} dB")
    print(f"[main] {model} {SMALL_HW[0]}x{SMALL_HW[1]} clip, card vs CPU: "
          f"max|pred diff| {diff:.3e}, PSNR {psnr_by_dev['cuda']:.4f} dB, "
          f"diff {dpsnr:.3e} dB")


def cli_phase(torch, mods, flags, model, per_clip):
    """The CLI on the synthetic validation clips at CLI_CROP, with every
    launch count set to 0 just before and checked against ``per_clip``
    times the clip count just after. Returns the counts."""
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.main import main as port_main
    n_clips = len(SyntheticSeptuplet(mode="val"))
    reset_launches(mods)
    t0 = time.perf_counter()
    stats = port_main(flags + ["--dataset", "synthetic",
                               "--crop_size", str(CLI_CROP)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launch_counts(mods)
    check(math.isfinite(stats["psnr"]) and math.isfinite(stats["ssim"]),
          f"{model} CLI metrics not finite: {stats}")
    want = {k: per_clip.get(k, 0) * n_clips for k in launches}
    check(launches == want, f"{model} CLI launches {launches} for {n_clips} "
                            f"clips, want {want}")
    print(f"[main] {model} CLI val: {n_clips} clips at {CLI_CROP}x{CLI_CROP} "
          f"in {dt:.2f} s (first clip includes set-up), PSNR "
          f"{stats['psnr']:.3f} SSIM {stats['ssim']:.4f}, launches "
          f"{launches}")
    return launches


def main_path_phase(torch, mods, earlier_lib=None):
    """SepConv through the port's entry points on the card, the 256x448
    episode also in turns with ``earlier_lib``'s K1 and K2 where given.
    Returns the launches of the CLI run (the main path) per kernel."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)

    # (a) the CLI: the synthetic validation clips
    launches = cli_phase(torch, mods, EVAL_FLAGS, "sepconv",
                         {"sepconv_forward": K1_PER_CLIP,
                          "sepconv_grad_kernels": K2_PER_CLIP})

    # (b) the full Vimeo frame
    cfg = get_args(EVAL_FLAGS)
    system = SceneAdaptiveInterpolation(cfg)
    frames = SyntheticSeptuplet(mode="val", size=FULL_HW)[0][0][None]
    system.run_validation_iter(frames)  # warm-up: cuDNN plans, allocator
    reps = 3
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, preds = system.run_validation_iter(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = launch_counts(mods)
    check(got["sepconv_forward"] == K1_PER_CLIP * reps
          and got["sepconv_grad_kernels"] == K2_PER_CLIP * reps,
          f"{FULL_HW} launches {got} for {reps} clips")
    check(tuple(preds.shape) == (1, 3) + FULL_HW
          and bool(torch.isfinite(preds).all())
          and math.isfinite(losses["psnr"]), f"{FULL_HW} output: {losses}")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[main] sepconv {FULL_HW[0]}x{FULL_HW[1]} episode: median "
          f"{statistics.median(times):.4f} s over {reps} (all "
          f"{[round(t, 4) for t in times]}), PSNR {losses['psnr']:.3f}, "
          f"launches K1 {got['sepconv_forward'] // reps} K2 "
          f"{got['sepconv_grad_kernels'] // reps} per clip, peak "
          f"memory {peak_gib:.2f} GiB")
    profile_episode(torch, lambda: system.run_validation_iter(frames),
                    f"sepconv {FULL_HW[0]}x{FULL_HW[1]} episode", "sepconv")
    if earlier_lib is not None:
        from meta_interpolation_tpu_torch.ops import sepconv as sc
        runs = {"this": system.run_validation_iter,
                "earlier": on_library(sc, earlier_lib,
                                      system.run_validation_iter)}
        turns = {"this": [], "earlier": []}
        for which in ["this", "earlier", "earlier", "this"] * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[which](frames)
            torch.cuda.synchronize()
            turns[which].append(time.perf_counter() - t0)
        print(f"[main] sepconv {FULL_HW[0]}x{FULL_HW[1]} episode in turns "
              f"(this, earlier, earlier, this) x2: " + "; ".join(
                  f"{which} K1/K2 median {statistics.median(t):.4f} s (all "
                  f"{[round(x, 4) for x in t]})"
                  for which, t in turns.items()))

    # (c) a small clip on the card against the same clip on the CPU
    card_vs_cpu(cfg, "sepconv")
    return launches


def double_backward_phase(torch, sc):
    """SepConvGradKernelsFunction's vector-Jacobian products w.r.t. g, kv
    and kh, built from K1 and K2, against autograd through the plain
    grad_kernels_ref, at a ragged map and at the SepConv shape. Returns
    the K1 and K2 launches of one double backward."""
    counts = None
    for n, h, w, f in DOUBLE_BACKWARD_SHAPES:
        gen = torch.Generator().manual_seed(h * 1000 + w)
        inp = torch.rand(n, 3, h + f - 1, w + f - 1, generator=gen).cuda()
        g, kv, kh = (torch.randn(n, *shape, generator=gen).cuda()
                     for shape in ((3, h, w), (f, h, w), (f, h, w)))
        cot = [torch.randn(n, f, h, w, generator=gen).cuda()
               for _ in range(2)]
        grads = []
        for fn in (sc.SepConvGradKernelsFunction.apply, sc.grad_kernels_ref):
            leaves = [t.clone().requires_grad_() for t in (g, kv, kh)]
            out = fn(inp, *leaves)
            reset_launches((sc,))
            grads.append(torch.autograd.grad(out, leaves, cot))
            if counts is None:
                torch.cuda.synchronize()
                counts = launch_counts((sc,))
        what = f"{n}x{h}x{w} F={f}"
        errs = [max_err(a, b, f"double backward d{name} {what}")
                for a, b, name in zip(*grads, ("g", "kv", "kh"))]
        print(f"[train] double backward {what}: dg, dkv, dkh agree with "
              f"autograd through grad_kernels_ref (max|diff| "
              + ", ".join(f"{e:.3e}" for e in errs) + ")")
    check(counts == {"sepconv_forward": 2, "sepconv_grad_kernels": 1},
          f"one double backward launched {counts}")
    print(f"[train] one double backward launches {counts}: two K1 for dg, "
          f"one K2 (its maps the two cotangents) for dkv and dkh")
    return counts


def count_calls(torch, mods, cls, name, log):
    """``cls.<name>`` wrapped to append (epoch argument, launches during
    the call, conv1 weight before the call, result) to ``log``."""
    real = getattr(cls, name)

    def wrapped(self, frames, *args, **kwargs):
        torch.cuda.synchronize()
        before = launch_counts(mods)
        w0 = self.meta_params["net"]["moduleConv1.0.weight"].detach().clone()
        out = real(self, frames, *args, **kwargs)
        torch.cuda.synchronize()
        after = launch_counts(mods)
        log.append((args[0] if args else None,
                    {k: after[k] - before[k] for k in after}, w0, out))
        return out
    return wrapped


def timed_iters(torch, run, reps, warmup=2):
    for _ in range(warmup):
        run()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def train_cli_phase(torch, mods):
    """The training CLI with the run_sepconv.sh preset at crop 256 for 4
    iterations, its checkpoint in a directory under build/, then a run
    resumed from it. Returns the launches of the first run."""
    import shutil
    import tempfile
    from meta_interpolation_tpu_torch.core.checkpoint import load_checkpoint
    from meta_interpolation_tpu_torch.main import main as port_main
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation as System)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="smoke_ckpt_",
                                dir=os.path.join(ROOT, "build"))
    flags = TRAIN_FLAGS + ["--crop_size", str(CLI_CROP), "--exp_name",
                           "smoke", "--checkpoint_dir", ckpt_dir]
    try:
        trains, vals = [], []
        run = with_attr(System, "run_train_iter",
                        count_calls(torch, mods, System, "run_train_iter",
                                    trains),
                        with_attr(System, "run_validation_iter",
                                  count_calls(torch, mods, System,
                                              "run_validation_iter", vals),
                                  port_main))
        reset_launches(mods)
        t0 = time.perf_counter()
        stats = run(flags + ["--max_epoch", "1", "--total_iter_per_epoch",
                             str(TRAIN_ITERS)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launch_counts(mods)
        want_train = {"sepconv_forward": K1_PER_TRAIN_ITER,
                      "sepconv_grad_kernels": K2_PER_TRAIN_ITER}
        want_val = {"sepconv_forward": K1_PER_CLIP,
                    "sepconv_grad_kernels": K2_PER_CLIP}
        check(len(trains) == TRAIN_ITERS and len(vals) == TRAIN_ITERS,
              f"train CLI: {len(trains)} train and {len(vals)} val calls")
        for _, got, _, (losses, preds) in trains:
            check({k: got[k] for k in want_train} == want_train,
                  f"train iteration launches {got}, want {want_train}")
            check(all(math.isfinite(v) for v in losses.values())
                  and bool(torch.isfinite(preds).all()),
                  f"train iteration losses {losses}")
        for _, got, _, _ in vals:
            check({k: got[k] for k in want_val} == want_val,
                  f"validation clip launches {got}, want {want_val}")
        exp = os.path.join(ckpt_dir, "smoke")
        state = load_checkpoint(exp)
        check(state is not None and state["epoch"] == 1
              and math.isfinite(stats["best_psnr"]),
              f"train CLI checkpoint {os.listdir(exp)}, stats {stats}")
        print(f"[train] CLI: {TRAIN_ITERS} iterations of batch 3 at "
              f"{CLI_CROP}x{CLI_CROP} and {TRAIN_ITERS} validation clips in "
              f"{dt:.2f} s (set-up and checkpoint included), losses "
              + ", ".join(f"{t[3][0]['loss']:.4f}" for t in trains)
              + f", launches {launches}: K1/K2 "
              f"{[t[1]['sepconv_forward'] for t in trains]}/"
              f"{[t[1]['sepconv_grad_kernels'] for t in trains]} per train "
              f"iteration, {want_val} per validation clip; wrote "
              f"{sorted(os.listdir(exp))}")
        saved = state["system"]["meta_params"]["net"]["moduleConv1.0.weight"]
        trains.clear()
        run(flags + ["--max_epoch", "2", "--total_iter_per_epoch", "1",
                     "--resume"])
        epoch, _, w0, _ = trains[0]
        check(epoch == 1 and torch.equal(w0.cpu(), saved),
              f"resumed run: epoch {epoch}, meta-parameters "
              f"{'equal' if torch.equal(w0.cpu(), saved) else 'differ'}")
        print(f"[train] --resume: started at epoch {epoch} from the saved "
              f"meta-parameters; checkpoint epoch "
              f"{load_checkpoint(exp)['epoch']}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches


def train_phase(torch, mods, sc, card):
    """SepConv meta-training on the card: the double backward against
    plain, the CLI (and a resumed run), seconds per first-order iteration
    with its profile and peak memory, one second-order iteration with no
    plain sepconv allowed, and outer gradients on the card against the
    CPU. Returns the launches of the training CLI."""
    import numpy as np
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    double_backward_phase(torch, sc)
    launches = train_cli_phase(torch, mods)

    clips = SyntheticSeptuplet(mode="train", size=(CLI_CROP, CLI_CROP))
    frames = np.stack([clips[i][0] for i in range(3)])
    system = SceneAdaptiveInterpolation(get_args(TRAIN_FLAGS))
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    times = timed_iters(torch, lambda: system.run_train_iter(frames, 0),
                        TRAIN_REPS)
    got = launch_counts(mods)
    n = TRAIN_REPS + 2
    check(got["sepconv_forward"] == K1_PER_TRAIN_ITER * n
          and got["sepconv_grad_kernels"] == K2_PER_TRAIN_ITER * n,
          f"train iterations launched {got} in {n}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] first order, batch 3, {CLI_CROP}x{CLI_CROP}, "
          f"{STEPS} steps ({card}): median {statistics.median(times):.4f} s "
          f"a train iteration over {TRAIN_REPS} after 2 warm-ups (all "
          f"{[round(t, 4) for t in times]}), peak memory {peak:.2f} GiB, "
          f"launches K1 {K1_PER_TRAIN_ITER} K2 {K2_PER_TRAIN_ITER} an "
          f"iteration")
    profile_episode(torch, lambda: system.run_train_iter(frames, 0),
                    f"sepconv train iteration ({card})", "sepconv")
    del system

    # second order: every sepconv through the kernels, none plain
    def plain_called(*_args):
        raise AssertionError("a plain sepconv ran on the card")

    second = SceneAdaptiveInterpolation(get_args(
        TRAIN_FLAGS + ["--batch_size", "1", "--second_order"]))
    one = frames[:1]
    run = with_attr(sc, "sepconv_ref", plain_called, with_attr(
        sc, "grad_kernels_ref", plain_called,
        lambda: second.run_train_iter(one, 0)))
    run()   # warm-up
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    times = timed_iters(torch, run, 1, warmup=0)
    got = launch_counts(mods)
    want = {"sepconv_forward": K1_PER_TASK_SECOND_ORDER,
            "sepconv_grad_kernels": K2_PER_TASK_SECOND_ORDER}
    check({k: got[k] for k in want} == want,
          f"second-order iteration launched {got}, want {want}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] second order, batch 1, {CLI_CROP}x{CLI_CROP}, {STEPS} "
          f"steps ({card}): {times[0]:.4f} s an iteration, peak memory "
          f"{peak:.2f} GiB, launches K1 {got['sepconv_forward']} K2 "
          f"{got['sepconv_grad_kernels']} (want {want}), no plain sepconv")
    del second
    # card vs CPU: first order at the preset's 3 inner steps, second order
    # at 1 (the CPU side's time)
    train_card_vs_cpu(torch, orders=("first",))
    train_card_vs_cpu(torch, TRAIN_FLAGS + ENGINE_CHECK_STEPS,
                      orders=("second",))
    return launches


def train_card_vs_cpu(torch, flags=TRAIN_FLAGS, model="sepconv",
                      orders=("first", "second"), hold_grads=True,
                      state=None, hand=None, prepare=None):
    """Outer gradients of one 64x64 clip on the card and on the CPU, from
    the same weights (the model's seeded init, or ``state``), for each
    order of ``orders``: the loss within LOSS_RTOL and, with
    ``hold_grads``, each parameter group's gradient within
    OUTER_GRAD_RTOL in norm (else the distance is shown); a group that
    trains nothing (the fixed rates of LSLR, the BN statistics, the
    discriminator) has zero gradients on both. ``hand``: (class, method
    name) of a model method whose results the CPU run takes from the card
    run, call by call; ``prepare(system)`` runs on each system first. In
    first order under Adam or Adamax the CPU steps with the card's support
    gradients (handing_inner), which are held to its own within
    OUTER_GRAD_RTOL in norm."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.inner_optimizers import (
        InnerOptimizer)
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    clip = SyntheticSeptuplet(model=model, mode="train",
                              size=SMALL_HW)[0][0][None]
    for order in orders:
        extra = ["--second_order"] if order == "second" else []
        cfg = get_args(flags + ["--batch_size", "1"] + extra)
        hand_inner = (order == "first" and cfg.optimizer != "SGD"
                      and cfg.number_of_training_steps_per_iter > 0)
        out, handed, calls, steps = {}, [], 0, []
        inner = dict.fromkeys(("d2", "n2", "flips", "n"), 0)
        for dev in ("cuda", "cpu"):
            system = SceneAdaptiveInterpolation(cfg, device=dev)
            if state is not None:
                system.load_net(state)
            if prepare is not None:
                prepare(system)
            run = lambda: system.outer_grads(clip, 0)
            if hand is not None:
                run = with_attr(hand[0], hand[1], handing(
                    torch, getattr(hand[0], hand[1]), handed, dev), run)
            if hand_inner:
                run = with_attr(InnerOptimizer, "update", handing_inner(
                    torch, InnerOptimizer.update, steps, dev, inner), run)
            loss, _, grads = run()
            out[dev] = float(loss), {g: {k: v.cpu() for k, v in t.items()}
                                     for g, t in grads.items()}
            calls = calls if dev == "cpu" else len(handed)
        check(not handed, f"the CPU run left {len(handed)} of the card's "
                          f"{calls} handed results")
        check(not steps, f"the CPU run left {len(steps)} of the card's "
                         f"inner steps")
        if hand_inner:
            inner_diff = math.sqrt(inner["d2"])
            inner_ref = math.sqrt(inner["n2"])
            check(inner_diff <= OUTER_GRAD_RTOL * inner_ref or not hold_grads,
                  f"{order}-order support gradients: card vs CPU "
                  f"{inner_diff:.3e} > {OUTER_GRAD_RTOL} x {inner_ref:.3e}")
        (l_card, g_card), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
        check(abs(l_card - l_cpu) <= LOSS_RTOL * abs(l_cpu),
              f"{order}-order outer loss card {l_card} vs CPU {l_cpu}")
        ratios = {}
        for g in g_cpu:
            diff = math.sqrt(sum(float((g_card[g][k] - v).norm()) ** 2
                                 for k, v in g_cpu[g].items()))
            ref = math.sqrt(sum(float(v.norm()) ** 2
                                for v in g_cpu[g].values()))
            ratios[g] = diff / ref if ref else diff
            check(diff <= OUTER_GRAD_RTOL * ref or not hold_grads,
                  f"{order}-order outer gradient of {g}: card vs CPU "
                  f"{diff:.3e} > {OUTER_GRAD_RTOL} x {ref:.3e}")
        worst = max(float((g_card[g][k] - v).norm() / float(v.norm()))
                    for g in g_cpu for k, v in g_cpu[g].items()
                    if float(v.norm()) > 0)
        limit = OUTER_GRAD_RTOL if hold_grads else "none"
        print(f"[train] {model} {order}-order outer gradient, inner "
              f"{cfg.optimizer}, {SMALL_HW[0]}x{SMALL_HW[1]} clip, card vs "
              f"CPU" + (f" (the CPU handed the card's {hand[1]}, "
                        f"{calls} calls)" if hand else "")
              + (f" (the CPU stepped with the card's support gradients: "
                 f"|diff|/|cpu| {inner_diff / inner_ref:.3e}, "
                 f"{inner['flips']} of "
                 f"{inner['n']} elements of the other sign)"
                 if hand_inner else "")
              + f": loss {l_card:.6f} vs {l_cpu:.6f}, |diff|/|cpu| "
              + " ".join(f"{g} {r:.3e}" for g, r in ratios.items()
                         if g in ("net", "lrs", "attenuator"))
              + f" (limit {limit}); worst single tensor {worst:.3e}")


def handing(torch, real, record, dev):
    """A stand-in for the model method ``real``: on the card it runs it and
    records each call's results (on the CPU); on the CPU it returns the
    card's results in call order instead, checking the call count."""
    def card(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        record.append(tuple(t.detach().cpu() if torch.is_tensor(t) else t
                            for t in out))
        return out

    def cpu(self, *args, **kwargs):
        check(len(record) > 0, f"the CPU run calls {real.__name__} more "
                               f"often than the card run")
        return record.pop(0)
    return card if dev == "cuda" else cpu


def handing_inner(torch, real, record, dev, dist, keep_tape=False):
    """A stand-in for InnerOptimizer.update ``real`` in a first-order
    episode, whose support gradients are constants. On the card it records
    each step's gradients (on the CPU) and steps; on the CPU it steps with
    the card's gradients in step order instead of its own, and adds to
    ``dist`` the squared distance of its own from the card's ("d2"), its
    own squared norm ("n2"), the elements of the other sign ("flips") and
    all elements ("n"). Adam's and Adamax's first step is lr·g/(|g| + eps),
    a sign wherever |g| ≫ eps = 1e-8: an element whose gradient is within
    the devices' rounding of 0 steps one way on the card and the other on
    the CPU, and its Meta-SGD rate's outer gradient changes sign with it.
    Handed, both devices take the same step, and what the outer gradients
    compare is continuous in the rounding. With ``keep_tape`` (a
    second-order episode) the replaying side steps with the recorded
    values and its own gradients' derivative, g + (recorded − g) detached,
    so the second order stays on its tape."""
    def card(self, params, grads, lrs, state, step_idx):
        record.append({k: g.detach().cpu() for k, g in grads.items()})
        return real(self, params, grads, lrs, state, step_idx)

    def cpu(self, params, grads, lrs, state, step_idx):
        check(len(record) > 0, "the CPU run takes more inner steps than the "
                               "card run")
        check(keep_tape or not any(g.requires_grad for g in grads.values()),
              "a handed support gradient would cut the second order")
        theirs = {k: t.to(grads[k].device) for k, t in record.pop(0).items()}
        for k, g in grads.items():
            g = g.detach()
            dist["d2"] += float((g - theirs[k]).norm()) ** 2
            dist["n2"] += float(g.norm()) ** 2
            dist["flips"] += int((torch.sign(g) != torch.sign(theirs[k])).sum())
            dist["n"] += g.numel()
        return real(self, params, {k: g + (theirs[k] - g).detach()
                                   if keep_tape else theirs[k]
                                   for k, g in grads.items()},
                    lrs, state, step_idx)
    return card if dev == "cuda" else cpu


def warp_call_phase(torch, mods, earlier=None, reps=10):
    """One backward_warp_rrin at RRIN's padded frame, forward (with grad)
    and the flow's gradient, on the bounded path, on the earlier warp
    (``earlier``: earlier_warp's sampler) where given, and on the exact
    path: device ops and device ms a call from torch.profiler over
    ``reps`` calls, and the eager ms of forward and backward together
    (CUDA events), in turns (bounded, earlier, exact, exact, earlier,
    bounded). The bounded path must launch K3 and K3-grad once each a
    call, the others neither."""
    from meta_interpolation_tpu_torch.ops import warp as warp_ops
    n, c, (h, w) = 1, 3, WARP_SHAPES[-1][:2]
    gen = torch.Generator().manual_seed(9)
    img = torch.rand(n, c, h, w, generator=gen).cuda()
    g = torch.randn(n, c, h, w, generator=gen).cuda()
    flow = smooth_flow(torch, n, h, w, 4.0, seed=10).cuda().requires_grad_()
    paths = {"bounded": lambda: warp_ops.backward_warp_rrin(img, flow,
                                                            WARP_R)}
    if earlier is not None:
        paths["earlier"] = with_attr(warp_ops, "grid_sample_bounded",
                                     earlier, paths["bounded"])
    paths["exact"] = lambda: warp_ops.backward_warp_rrin(img, flow, None)
    flow_grad = lambda out: torch.autograd.grad(out, flow, g)[0]
    if earlier is not None:   # the same glue and floors: the same result
        max_err(flow_grad(paths["earlier"]()), flow_grad(paths["bounded"]()),
                "warp call: the earlier path's flow gradient")
    stats = {which: {"busy": [], "ms": []} for which in paths}
    order = list(paths) + list(paths)[::-1]
    for which in order:
        fwd = paths[which]
        reset_launches(mods)
        _, fwd_busy, fwd_rows, _ = device_time_by_kernel(
            torch, lambda: [fwd() for _ in range(reps)])
        outs = [fwd() for _ in range(reps)]
        _, bwd_busy, bwd_rows, _ = device_time_by_kernel(
            torch, lambda: [flow_grad(o) for o in outs])
        launched = launch_counts(mods)
        want = {k: 0 for k in launched}
        if which == "bounded":
            want["warp_sample_bounded_forward"] = 2 * reps
            want["warp_sample_bounded_grad_grid"] = reps
        check(launched == want, f"warp call {which}: launches {launched}, "
                                f"want {want}")
        stats[which]["ops"] = (sum(k for _, k, _ in fwd_rows) / reps,
                               sum(k for _, k, _ in bwd_rows) / reps)
        stats[which]["busy"].append((fwd_busy / reps, bwd_busy / reps))
    for which in order:   # eager, with the profiler off
        stats[which]["ms"].append(
            call_ms(torch, lambda: flow_grad(paths[which]())))
    for which, st in stats.items():
        print(f"[main] rrin warp call at {n}x{c}x{h}x{w}, {which} "
              f"warp, in turns ({', '.join(order)}): forward "
              f"{st['ops'][0]:.0f} device ops, backward {st['ops'][1]:.0f}; "
              f"device ms forward " + ", ".join(f"{b[0]:.4f}" for b in
                                                st["busy"])
              + "; backward " + ", ".join(f"{b[1]:.4f}" for b in st["busy"])
              + "; eager forward and backward " + ", ".join(
                  f"{t:.4f}" for t in st["ms"]) + " ms")
    return stats


def plain_warp_forbidden(wb, fn):
    """``fn`` run with the bounded sampler's plain versions (the
    composition and its closed-form grid gradient, which K3-grad²'s plain
    version differentiates) patched to raise: on the card the sampler must
    run K3, K3-grad and K3-grad² only, and no plain image gradient
    (GridSampleBoundedFunction takes it through the plain composition, and
    only when the image needs one)."""
    def forbidden(*_args, **_kw):
        raise AssertionError("a plain bounded-sampler version ran on the "
                             "card")
    return with_attr(wb, "grid_sample_bounded_ref", forbidden,
                     with_attr(wb, "grid_sample_bounded_grad_grid_ref",
                               forbidden, fn))


def warp_model_phase(torch, mods, wb, model, flags, k3, k3g, earlier=None):
    """RRIN, SuperSloMo or VoxelFlow through the port's entry points on the
    card: (a) the CLI on the synthetic clips with ``flags`` (bounded warp),
    K3 and K3-grad launches a clip held to ``k3`` and ``k3g``; (b) 256x448
    episodes on the bounded and the exact warp in turns (the exact launches
    no kernel of ours) and, where ``earlier`` (earlier_warp's sampler) is
    given, on the earlier warp: s/episode, peak memory, a profile of each,
    the FLOPs of one forward; (c) FlowStats over an exact episode: the
    share of displacements past R; (d) a 64x64 clip on the card against the
    same clip on the CPU. No plain bounded sampler runs on the card in the
    CLI or the timed bounded episodes. Returns the CLI's launches per
    kernel."""
    from torch.utils.flop_counter import FlopCounterMode

    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    from meta_interpolation_tpu_torch.ops import warp as warp_ops

    # (a) the CLI
    launches = plain_warp_forbidden(wb, lambda: cli_phase(
        torch, mods, flags, model,
        {"warp_sample_bounded_forward": k3,
         "warp_sample_bounded_grad_grid": k3g}))()

    # (b) the full Vimeo frame, bounded and exact (and earlier) in turns
    frames = SyntheticSeptuplet(model=model, mode="val",
                                size=FULL_HW)[0][0][None]
    systems, peak_gib = {}, {}
    for which, extra in (("bounded", []),
                         ("exact", ["--fast_warp_range", "0"])):
        systems[which] = SceneAdaptiveInterpolation(get_args(flags + extra))
        torch.cuda.reset_peak_memory_stats()
        systems[which].run_validation_iter(frames)   # warm-up
        peak_gib[which] = torch.cuda.max_memory_allocated() / 2**30
    check(systems["exact"].model.warp_range is None,
          "exact path still bounded")
    runs = {"bounded": plain_warp_forbidden(
                wb, systems["bounded"].run_validation_iter),
            "exact": systems["exact"].run_validation_iter}
    turns = ["bounded", "exact", "exact", "bounded"] * 3
    if earlier is not None:
        runs["earlier"] = with_attr(warp_ops, "grid_sample_bounded", earlier,
                                    systems["bounded"].run_validation_iter)
        runs["earlier"](frames)                      # warm-up
        turns += ["earlier", "bounded", "bounded", "earlier"] * 2
    times = {which: [] for which in runs}
    out = {}
    for which in turns:
        reset_launches(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[which] = runs[which](frames)
        torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t0)
        got = launch_counts(mods)
        want = {k: 0 for k in got}
        if which == "bounded":
            want.update(warp_sample_bounded_forward=k3,
                        warp_sample_bounded_grad_grid=k3g)
        check(got == want, f"{model} {FULL_HW} {which} episode launches "
                           f"{got}, want {want}")
    for which, (losses, preds) in out.items():
        check(tuple(preds.shape) == (1, 3) + FULL_HW
              and bool(torch.isfinite(preds).all())
              and math.isfinite(losses["psnr"]),
              f"{model} {FULL_HW} {which} output: {losses}")
    diff = {which: (out[which][1] - out["bounded"][1]).abs().max().item()
            for which in out}
    for which in runs:
        extra = (f"launches K3 {k3} K3-grad {k3g} per clip"
                 if which == "bounded" else
                 f"no kernel of ours launched, max|pred diff| against the "
                 f"bounded {diff[which]:.3e}")
        peak = (f", peak memory {peak_gib[which]:.2f} GiB"
                if which in peak_gib else "")
        print(f"[main] {model} {FULL_HW[0]}x{FULL_HW[1]} episode, {which} "
              f"warp{'' if which == 'exact' else f' R={WARP_R}'}: median "
              f"{statistics.median(times[which]):.4f} s over "
              f"{len(times[which])} in turns (all "
              f"{[round(t, 4) for t in times[which]]}), PSNR "
              f"{out[which][0]['psnr']:.3f}{peak}, {extra}")
    ours_key = {"bounded": "warp_sample", "exact": "grid_sampler",
                "earlier": "warp_bounded"}
    for which, run in runs.items():
        profile_episode(torch, lambda: run(frames),
                        f"{model} {FULL_HW[0]}x{FULL_HW[1]} episode, {which} "
                        f"warp", ours_key[which])
    peak_memory_by_block(torch, lambda: runs["bounded"](frames),
                         f"{model} {FULL_HW[0]}x{FULL_HW[1]} episode, "
                         f"bounded warp")
    clip = systems["bounded"]._frames(frames)[0]
    q0, _, q1 = QUERY
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        systems["bounded"].model(clip[q0][None], clip[q1][None])
    print(f"[main] {model} forward at {FULL_HW[0]}x{FULL_HW[1]}: "
          f"{counter.get_total_flops() / 1e9:.3f} GFLOP "
          f"(torch.utils.flop_counter)")

    # (c) the displacements the exact sampler sees over one episode
    with warp_ops.FlowStats(r=WARP_R) as fs:
        runs["exact"](frames)
    check(fs.calls == k3, f"{model} FlowStats recorded {fs.calls} exact "
                          f"samples, want {k3}")
    print(f"[main] {model} {FULL_HW[0]}x{FULL_HW[1]} exact episode, "
          f"FlowStats over {fs.calls} samples: share past R={WARP_R} "
          f"{fs.frac_beyond:.6f} ({fs.n_beyond} of {fs.n_total}), largest "
          f"displacement {fs.max_disp:.3f} px")
    del systems, runs, out

    # (d) a small clip on the card against the same clip on the CPU
    card_vs_cpu(get_args(flags), model)
    return launches


def train_launches(steps, warps, second):
    """K3, K3-grad and K3-grad² launches of one task (see WARP_TRAIN)."""
    k3 = (2 * steps + 1) * warps
    if not second:
        return {"warp_sample_bounded_forward": k3,
                "warp_sample_bounded_grad_grid": k3}
    return {"warp_sample_bounded_forward": k3,
            "warp_sample_bounded_grad_grid": (4 * steps + 1) * warps,
            "warp_sample_bounded_grad_grid_backward": 2 * steps * warps}


def warp_train_model(torch, mods, wb, card, model, state=None, preset=None,
                     name=None, hold_first=True, record=None):
    """Meta-training of one model of WARP_TRAIN on the card: (a) first
    order at its preset batch on 256x256 crops, median of WARP_TRAIN_REPS
    train iterations after a warm-up, peak memory, launches, a profile with
    the device's idle share; (b) one second-order iteration at batch 1
    after a warm-up; (c) the outer gradient of a 64x64 clip on the card
    against the CPU, first order at the preset's rule and second order at
    the inner SGD rule (DAIN: the CPU handed the card's rectify inputs,
    whose projection floors may flip between the devices). Every sampler
    call runs K3 / K3-grad / K3-grad², no plain version (the plain sampler
    and its closed forms patched to raise). Returns the launches of (a)
    and (b), by path. ``preset`` (flags, batch, steps, warps) stands for
    WARP_TRAIN[model] and ``name`` for the model in the paths' names; with
    ``hold_first`` False (c)'s first-order gradient is shown, not held.
    ``record`` (a Recording of the warp library) counts the shapes of
    (b)'s kernel calls."""
    import numpy as np

    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    from meta_interpolation_tpu_torch.models.dain import model as dain_mod
    flags, batch, steps, warps = preset or WARP_TRAIN[model]
    name = name or model
    clips = SyntheticSeptuplet(model=model, mode="train",
                               size=(CLI_CROP, CLI_CROP))
    frames = np.stack([clips[i][0] for i in range(batch)])
    second_flags = flags + ["--number_of_training_steps_per_iter",
                            str(max(steps, SECOND_ORDER_STEPS))]
    paths = {}
    for order, cfg_flags, tasks, reps in (
            ("first", flags, batch, WARP_TRAIN_REPS),
            ("second", second_flags + ["--batch_size", "1",
                                       "--second_order"], 1, 1)):
        n = steps if order == "first" else max(steps, SECOND_ORDER_STEPS)
        system = SceneAdaptiveInterpolation(get_args(cfg_flags))
        if state is not None:
            system.load_net(state)
        out = []
        run = plain_warp_forbidden(wb, lambda: out.append(
            system.run_train_iter(frames[:tasks], 0)))
        if record is not None and order == "second":
            run = on_library(wb, record, run)
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mods)
        times = timed_iters(torch, run, reps, warmup=1)
        got = launch_counts(mods)
        want = {k: 0 for k in got}
        want.update({k: v * tasks * (reps + 1) for k, v in
                     train_launches(n, warps, order == "second").items()})
        check(got == want, f"{model} {order}-order train iterations "
                           f"launched {got}, want {want}")
        losses, preds = out[-1]
        check(all(math.isfinite(v) for v in losses.values())
              and tuple(preds.shape) == (tasks, 3, CLI_CROP, CLI_CROP)
              and bool(torch.isfinite(preds).all()),
              f"{model} {order}-order train iteration: {losses}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        per_iter = {k: v // (reps + 1) for k, v in got.items() if v}
        print(f"[train] {name} {order} order, batch {tasks}, {CLI_CROP}x"
              f"{CLI_CROP}, {n} step(s) ({card}): median "
              f"{statistics.median(times):.4f} s a train iteration over "
              f"{reps} after a warm-up (all {[round(t, 4) for t in times]}), "
              f"loss {losses['loss']:.4f}, peak memory {peak:.2f} GiB, "
              f"launches an iteration {per_iter}, no plain sampler")
        if order == "first":
            profile_episode(torch, run, f"{name} train iteration ({card})",
                            "warp_sample" if warps else None)
        suffix = "" if order == "first" else "_second_order"
        paths[f"{name}_train{suffix}"] = {k: v for k, v in got.items()}
        del system, out
    hand = (dain_mod.DAIN, "rectify_input") if model == "dain" else None
    train_card_vs_cpu(torch, flags, model, orders=("first",), state=state,
                      hand=hand, hold_grads=hold_first)
    train_card_vs_cpu(torch, second_flags + ["--optimizer", "SGD"], model,
                      orders=("second",), state=state, hand=hand)
    return paths


def warp_train_phase(torch, mods, wb, card, record=None):
    """warp_train_model for RRIN, SuperSloMo, VoxelFlow and DAIN (tamed
    weights, dain_weights), ``record`` counting the shapes of the
    second-order iterations' kernel calls. Returns every path's
    launches."""
    paths = {}
    for model in WARP_TRAIN:
        state = (dain_weights(torch).state_dict() if model == "dain"
                 else None)
        paths.update(timed(f"{model}_train", warp_train_model, torch, mods,
                           wb, card, model, state, record=record))
    return paths


def grad2_path_phase(torch, wb, card, record, earlier_lib=None):
    """K3-grad² at each shape the second-order main paths gave it
    (``record``, a Recording of their K3-grad² calls), printed with its
    count, then timed there in float32 and bf16 on random displacements
    within range as at GRAD2_SHAPES (grad2_timing, in turns with
    ``earlier_lib`` where given and with the widened bf16 call). Returns
    {dtype: [a record a shape]}."""
    shapes = {}
    for (name, n, c, h, w, r, align, border), count in sorted(
            record.calls.items()):
        padding = "border" if border else "zeros"
        print(f"[kernels] K3-grad² on the second-order main paths: {count} "
              f"calls of {name} at img {n}x{c}x{h}x{w}, R={r}, "
              f"align_corners={bool(align)}, {padding}")
        key = (n, c, h, w, r, bool(align), padding)
        shapes[key] = shapes.get(key, 0) + count
    check(shapes, "no K3-grad² call recorded on the second-order paths")
    return grad2_timing(torch, wb, card, [
        (f"main path, {count} calls", n, c, h, w, "library", r, align,
         padding)
        for (n, c, h, w, r, align, padding), count in shapes.items()],
        earlier_lib)


def dain_weights(torch):
    """Random DAIN weights from DAIN_SEED with the depth head tamed, also
    written to DAIN_PTH for the CLI's --pretrained_model."""
    from meta_interpolation_tpu_torch.models.dain.model import (
        DAIN, tame_depth_head_)
    model = tame_depth_head_(DAIN(torch.Generator().manual_seed(DAIN_SEED)))
    os.makedirs(os.path.dirname(DAIN_PTH), exist_ok=True)
    torch.save(model.state_dict(), DAIN_PTH)
    return model


def dain_served_phase(torch, mods, model, earlier_k4=None):
    """One frame pair at 256x448 through DAIN.forward with proj_range and
    hole filling, timed in turns with the exact projection; K4 timed on the
    two flows the frame projects, in turns with ``earlier_k4`` (an earlier
    design's wrapper) where given. Returns the launches of the bounded runs
    per kernel and K4's times on the frame's flows."""
    from meta_interpolation_tpu_torch.ops import flow_projection_bounded as fpb
    from torch.utils.flop_counter import FlopCounterMode

    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.models.dain import model as dain_mod
    frames = SyntheticSeptuplet(model="dain", mode="val", size=FULL_HW)[0][0]
    f0, f1 = (torch.tensor(frames[i]).permute(2, 0, 1)[None].contiguous()
              .cuda() for i in DAIN_QUERY)
    model = model.cuda()
    runs = {"bounded": lambda: model(f0, f1, proj_range=PROJ_R,
                                     fill_holes=True),
            "exact": lambda: model(f0, f1, fill_holes=True)}
    with torch.no_grad():
        for run in runs.values():
            run()                                   # warm-up
        times = {"bounded": [], "exact": []}
        out = {"bounded": [], "exact": []}
        reset_launches(mods)
        for which in ["bounded", "exact", "exact", "bounded"] * 3:
            want = launch_counts(mods)
            if which == "bounded":
                want["flow_projection_bounded"] += K4_PER_FRAME
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[which].append(runs[which]())
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t0)
            check(launch_counts(mods) == want,
                  f"dain {which} frame launches {launch_counts(mods)}, "
                  f"want {want}")
        launches = launch_counts(mods)
        n_frames = len(times["bounded"])
        check(launches["flow_projection_bounded"] == K4_PER_FRAME * n_frames,
              f"dain served launches {launches} for {n_frames} frames")
        for which, preds in out.items():
            for pred in preds:
                check(tuple(pred.shape) == (1, 3) + FULL_HW
                      and bool(torch.isfinite(pred).all()),
                      f"dain served {which} output {tuple(pred.shape)}")
        # bounded against exact, beside exact against exact: the forward
        # itself is not bitwise repeatable on the card
        diff = max((b - e).abs().max().item()
                   for b, e in zip(out["bounded"], out["exact"]))
        noise = max((e - out["exact"][0]).abs().max().item()
                    for e in out["exact"])
        flow_max = max(f.abs().max().item() for f in model.flows(f0, f1))
        # the offsets (projected flows) of one frame on each path, and K4's
        # offsets against the exact scatter's on the very same inputs
        calls, offsets = [], []
        real = dain_mod.flow_projection

        def spy(*args, **kwargs):
            calls.append((args, kwargs))
            offsets.append(real(*args, **kwargs))
            return offsets[-1]

        dain_mod.flow_projection = spy
        try:
            runs["bounded"]()
            runs["exact"]()
        finally:
            dain_mod.flow_projection = real
        same_inputs = max(
            max_err(off, real(*args, **{**kwargs, "proj_range": None}),
                    "dain served: K4 offsets against the exact scatter's")
            for (args, kwargs), off in zip(calls[:2], offsets[:2]))
        off_diff = max((a - b).abs().max().item()
                       for a, b in zip(offsets[:2], offsets[2:]))
        flow_diff = max((a[0][0] - b[0][0]).abs().max().item()
                        for a, b in zip(calls[:2], calls[2:]))
        # K4 alone on the two (flow, depth) pairs the bounded frame projects
        served = [(args[0].contiguous(), args[1].contiguous())
                  for args, _ in calls[:2]]
        served_ms = [time_ms(torch, lambda f=f, d=d:
                             fpb.flow_projection_bounded(f, d, PROJ_R))
                     for f, d in served]
        served_lists = [k4_list_lengths(torch, f, PROJ_R) for f, _ in served]
        torch.cuda.reset_peak_memory_stats()
        runs["bounded"]()
        torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        with FlopCounterMode(display=False) as counter:
            runs["bounded"]()
    for which in times:
        print(f"[main] dain served {FULL_HW[0]}x{FULL_HW[1]} frame, "
              f"{which} projection"
              f"{f' R={PROJ_R}' if which == 'bounded' else ''}: median "
              f"{statistics.median(times[which]):.4f} s/frame over "
              f"{len(times[which])} in turns (all "
              f"{[round(t, 4) for t in times[which]]})")
    print(f"[main] dain served: K4 launches {launches} over {n_frames} "
          f"bounded frames ({K4_PER_FRAME} a frame, none on the exact "
          f"ones); bounded vs exact max|pred diff| {diff:.3e} (exact vs "
          f"exact {noise:.3e}), max|offset diff| {off_diff:.3e} on flows "
          f"{flow_diff:.3e} apart and {same_inputs:.3e} on the same flows; "
          f"flows' "
          f"max|value| {flow_max:.3f} px against R = {PROJ_R}; peak memory "
          f"{peak_gib:.2f} GiB; forward {counter.get_total_flops() / 1e9:.3f}"
          f" GFLOP (torch.utils.flop_counter)")
    print(f"[main] dain served: K4 on the frame's own two flows "
          f"{served_ms[0]:.4f}, {served_ms[1]:.4f} ms (lists a warp, mean "
          f"and largest: " + "; ".join(f"{mean:.1f}, {top}" for mean, top
                                       in served_lists) + ")")
    if earlier_k4 is not None:
        for (f, d), which in zip(served, ("first", "second")):
            k4_in_turns(torch, fpb, earlier_k4, f, d, f"served frame's {which}")
    with torch.no_grad():
        profile_episode(torch, runs["bounded"],
                        f"dain served {FULL_HW[0]}x{FULL_HW[1]} frame",
                        "flow_projection")
    return launches, served_ms


def flip_mask(torch, values, delta):
    """(H, W) bool: the pixels within FLIP_REACH of where a projection value
    within delta of an integer acts. values: (flow, offsets) pairs of the
    projections, (N, H, W, 2) each, (fx, fy) last. A flow acts at the cell
    its source lands on, an offset at its own pixel."""
    import torch.nn.functional as F
    h, w = SMALL_HW
    ys = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
    hits = torch.zeros(1, 1, h, w)
    for flow, off in values:
        check(tuple(flow.shape[1:3]) == SMALL_HW,
              f"projection at {tuple(flow.shape)}: padded past {SMALL_HW}")
        for v, ty, tx in ((flow, ys + flow[..., 1], xs + flow[..., 0]),
                          (off, ys.expand(off.shape[:3]),
                           xs.expand(off.shape[:3]))):
            near = ((v - v.round()).abs() < delta).any(-1)   # (N, H, W)
            hits[0, 0, ty[near].round().clamp(0, h - 1).long(),
                 tx[near].round().clamp(0, w - 1).long()] = 1.0
    return F.max_pool2d(hits, 2 * FLIP_REACH + 1, stride=1,
                        padding=FLIP_REACH)[0, 0] > 0


def dain_card_vs_cpu(torch, cfg, state):
    """The first small synthetic clip on the card and on the CPU. A pixel
    may exceed the limit only inside the flip mask: within FLIP_REACH of
    where a projection input or output value (a flow the projection or the
    filter interpolation floors) within delta of an integer on the CPU run
    acts, since there the two devices may take other floors. delta is the
    larger of NEAR_INT and the devices' largest flow difference in the
    first forward, where both still hold the same weights. The PSNR of the
    pixels outside the mask agrees to PSNR_TOL_DB, always."""
    from meta_interpolation_tpu_torch.core.metrics import (
        psnr_from_quantized, quantize)
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    from meta_interpolation_tpu_torch.models.dain import model as dain_mod
    clip = SyntheticSeptuplet(model="dain", mode="val",
                              size=SMALL_HW)[0][0][None]
    seen = {"cuda": [], "cpu": []}
    real = dain_mod.flow_projection
    dev = None

    def spy(flow, *args, **kwargs):
        off = real(flow, *args, **kwargs)
        seen[dev].append((flow.detach().cpu(), off.detach().cpu()))
        return off

    preds, psnr = {}, {}
    dain_mod.flow_projection = spy
    try:
        for dev in ("cuda", "cpu"):
            system = SceneAdaptiveInterpolation(cfg, device=dev)
            system.load_net(state)
            losses, pred = system.run_validation_iter(clip)
            preds[dev], psnr[dev] = pred.cpu(), losses["psnr"]
    finally:
        dain_mod.flow_projection = real
    # the first forward's two projections: same weights on both devices
    d_flow = max((a[0] - b[0]).abs().max().item()
                 for a, b in zip(seen["cuda"][:2], seen["cpu"][:2]))
    delta = max(NEAR_INT, d_flow)
    near = sum(int(((v - v.round()).abs() < delta).sum())
               for pair in seen["cpu"] for v in pair)
    n_values = sum(v.numel() for pair in seen["cpu"] for v in pair)
    mask = flip_mask(torch, seen["cpu"], delta)
    keep = ~mask
    diff = (preds["cuda"] - preds["cpu"]).abs().amax(1)[0]      # (H, W)
    lim = TOL_REL * preds["cpu"].abs().max().item() + TOL_ABS
    outside = int(((diff > lim) & keep).sum())
    inside = int(((diff > lim) & mask).sum())
    share_1e4 = float((diff > 1e-4).float().mean())
    # the repo's PSNR of the query frame over the pixels outside the mask
    target = torch.tensor(clip[0, cfg.target_idxs[1]]).permute(2, 0, 1)
    kept_psnr = {dev: psnr_from_quantized(quantize(p[0][:, keep]),
                                          quantize(target[:, keep])).item()
                 for dev, p in preds.items()}
    dpsnr_kept = abs(kept_psnr["cuda"] - kept_psnr["cpu"])
    msg = (f"dain {SMALL_HW[0]}x{SMALL_HW[1]} clip, card vs CPU: max|pred "
           f"diff| {diff.max().item():.3e}, share of pixels beyond 1e-4 "
           f"{share_1e4:.5f}, PSNR diff {abs(psnr['cuda'] - psnr['cpu']):.3e}"
           f" dB; first-forward max|flow diff| {d_flow:.3e}; {near} of "
           f"{n_values} projection values within {delta:.3e} of an integer, "
           f"their flip mask {int(mask.sum())} of {mask.numel()} pixels; "
           f"beyond {lim:.3e} (1e-4 max|pred| + 1e-5): {outside} pixels "
           f"outside the mask (must be 0), {inside} inside; PSNR outside "
           f"the mask {dpsnr_kept:.3e} dB apart (limit {PSNR_TOL_DB})")
    check(int(keep.sum()) > 0 and outside == 0
          and dpsnr_kept <= PSNR_TOL_DB, msg)
    print(f"[main] {msg}")

def dain_served_card_vs_cpu(torch, state):
    """One served forward (proj_range=PROJ_R, hole filling) of the first
    small synthetic clip's query pair on the card, then on the CPU with the
    same weights, handed the card's PWC flows, log depths and projected
    offsets (spies on DAIN.flows, depthNet and flow_projection), so that no
    floor can flip: every pixel must lie within 1e-4·max|pred| + 1e-5, with
    no mask."""
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.models.dain import model as dain_mod
    frames = SyntheticSeptuplet(model="dain", mode="val", size=SMALL_HW)[0][0]
    pair = [torch.tensor(frames[i]).permute(2, 0, 1)[None].contiguous()
            for i in DAIN_QUERY]
    seen = {"flows": [], "depth": [], "offsets": []}
    real = dain_mod.flow_projection
    preds = {}
    for dev in ("cuda", "cpu"):
        model = dain_mod.DAIN(torch.Generator().manual_seed(DAIN_SEED))
        model.load_state_dict(state)
        inputs = pair
        if dev == "cuda":
            model, inputs = model.cuda(), [f.cuda() for f in pair]
            real_flows = model.flows

            def flows(x0, x2):
                out = real_flows(x0, x2)
                seen["flows"].append(tuple(f.cpu() for f in out))
                return out

            def depth(module, args, out):
                seen["depth"].append(out.cpu())

            def project(*args, **kwargs):
                out = real(*args, **kwargs)
                seen["offsets"].append(out.cpu())
                return out
        else:
            check(len(seen["flows"]) == 1 and len(seen["depth"]) == 1
                  and len(seen["offsets"]) == 2,
                  f"dain served: spies saw {[len(v) for v in seen.values()]}")
            offsets = iter(seen["offsets"])
            flows = lambda x0, x2: seen["flows"][0]
            depth = lambda module, args, out: seen["depth"][0]
            project = lambda *args, **kwargs: next(offsets)
        model.flows = flows
        hook = model.depthNet.register_forward_hook(depth)
        dain_mod.flow_projection = project
        try:
            with torch.no_grad():
                preds[dev] = model(*inputs, proj_range=PROJ_R,
                                   fill_holes=True).cpu()
        finally:
            dain_mod.flow_projection = real
            hook.remove()
    diff = (preds["cuda"] - preds["cpu"]).abs()
    lim = TOL_REL * preds["cpu"].abs().max().item() + TOL_ABS
    beyond = int((diff > lim).sum())
    msg = (f"dain served {SMALL_HW[0]}x{SMALL_HW[1]} frame, card vs CPU on "
           f"the card's flows, log depths and offsets: max|pred diff| "
           f"{diff.max().item():.3e}, {beyond} of {diff.numel()} values "
           f"beyond {lim:.3e} (1e-4 max|pred| + 1e-5; must be 0, no mask)")
    check(bool(torch.isfinite(preds["cuda"]).all()) and beyond == 0, msg)
    print(f"[main] {msg}")


def dain_phase(torch, mods, earlier_k4=None):
    """DAIN through the port's entry points on the card: served with the
    bounded projection, then the CLI and an episode with the exact one.
    Returns the launches of the served runs (K4's main path) per kernel and
    K4's times on the served frame's flows."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)

    model = dain_weights(torch)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    launches, served_ms = dain_served_phase(torch, mods, model, earlier_k4)
    del model

    # the CLI: the meta system projects exactly, as the JAX one does
    cli_phase(torch, mods, DAIN_FLAGS, "dain", {})

    # one 256x448 episode
    cfg = get_args(DAIN_FLAGS)
    system = SceneAdaptiveInterpolation(cfg)
    system.load_net(state)
    frames = SyntheticSeptuplet(model="dain", mode="val",
                                size=FULL_HW)[0][0][None]
    torch.cuda.reset_peak_memory_stats()
    system.run_validation_iter(frames)             # warm-up
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    reps = 3
    reset_launches(mods)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, preds = system.run_validation_iter(frames)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    got = launch_counts(mods)
    check(not any(got.values()), f"dain episode launched kernels: {got}")
    check(tuple(preds.shape) == (1, 3) + FULL_HW
          and bool(torch.isfinite(preds).all())
          and math.isfinite(losses["psnr"]), f"dain {FULL_HW} output: "
                                              f"{losses}")
    print(f"[main] dain {FULL_HW[0]}x{FULL_HW[1]} episode, exact projection: "
          f"median {statistics.median(times):.4f} s over {reps} (all "
          f"{[round(t, 4) for t in times]}), PSNR {losses['psnr']:.3f}, no "
          f"kernel launched, peak memory {peak_gib:.2f} GiB")
    profile_episode(torch, lambda: system.run_validation_iter(frames),
                    f"dain {FULL_HW[0]}x{FULL_HW[1]} episode", "conv")
    del system

    # a small clip on the card against the same clip on the CPU, and a
    # served frame on the CPU from the card's flows, depths and offsets
    dain_card_vs_cpu(torch, cfg, state)
    dain_served_card_vs_cpu(torch, state)
    return launches, served_ms


def cain_phase(torch, mods, card):
    """CAIN in evaluation, run_cain.sh's hyperparameters, through the
    port's entry points on the card: (a) the CLI on the synthetic clips,
    no kernel of ours launched; (b) 256x448 episodes: median of
    CAIN_EPISODE_REPS after a warm-up, peak memory, a profile, the FLOPs
    of a forward; (c) a 64x64 clip on the card against the CPU."""
    from torch.utils.flop_counter import FlopCounterMode

    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)

    # (a) the CLI
    cli_phase(torch, mods, CAIN_EVAL_FLAGS, "cain", {})

    # (b) the full Vimeo frame
    cfg = get_args(CAIN_EVAL_FLAGS)
    system = SceneAdaptiveInterpolation(cfg)
    n_params = sum(v.numel() for v in system.meta_params["net"].values())
    check(n_params == CAIN_PARAMS, f"cain has {n_params} parameters, want "
                                   f"{CAIN_PARAMS}")
    frames = SyntheticSeptuplet(model="cain", mode="val",
                                size=FULL_HW)[0][0][None]
    out = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    times = timed_iters(
        torch, lambda: out.append(system.run_validation_iter(frames)),
        CAIN_EPISODE_REPS, warmup=1)
    got = launch_counts(mods)
    check(not any(got.values()), f"cain episodes launched {got}")
    losses, preds = out[-1]
    check(tuple(preds.shape) == (1, 3) + FULL_HW
          and bool(torch.isfinite(preds).all())
          and math.isfinite(losses["psnr"]), f"cain {FULL_HW}: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[main] cain {FULL_HW[0]}x{FULL_HW[1]} episode ({card}): median "
          f"{statistics.median(times):.4f} s over {CAIN_EPISODE_REPS} after "
          f"a warm-up (all {[round(t, 4) for t in times]}), PSNR "
          f"{losses['psnr']:.3f}, max|pred| {preds.abs().max().item():.3f}, "
          f"peak memory {peak:.2f} GiB, {n_params} parameters, no kernel "
          f"of ours launched")
    profile_episode(torch, lambda: system.run_validation_iter(frames),
                    f"cain {FULL_HW[0]}x{FULL_HW[1]} episode", None)
    clip = system._frames(frames)[0]
    q0, _, q1 = QUERY
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        system.model(clip[q0][None], clip[q1][None])
    print(f"[main] cain forward at {FULL_HW[0]}x{FULL_HW[1]}: "
          f"{counter.get_total_flops() / 1e9:.3f} GFLOP "
          f"(torch.utils.flop_counter)")
    del system, out

    # (c) a small clip on the card against the same clip on the CPU
    cain_card_vs_cpu(torch, cfg)


def cain_card_vs_cpu(torch, cfg):
    """CAIN's first small synthetic clip on the card and on the CPU. The
    preset's first inner Adam step moves a weight by lr·g/(|g| + eps),
    about lr·sign(g), so a weight whose support gradient is within the
    devices' rounding of zero steps the other way on one of them (358 of
    the 42,780,432 between a float32 and a float64 episode on the CPU),
    and the random-init prediction, ~10² from 60 residual blocks, carries
    that to ~1e-3. So: (a) the episode on each device, PSNR within
    PSNR_TOL_DB, and each adapted weight within STEP_ATOL_OF_LR·lr of the
    other device's but for a share of at most CAIN_FLIP_SHARE; (b) the query on
    the CPU handed the card's adapted weights, every pixel within
    1e-4·max|pred| + 1e-5 of the card's (DAIN's rule for a frame handed the
    card's flows)."""
    from torch.func import functional_call

    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta import episode as episode_lib
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    clip = SyntheticSeptuplet(model="cain", mode="val",
                              size=SMALL_HW)[0][0][None]
    spec = episode_lib.EpisodeSpec(support_idxs=cfg.support_idxs("train"),
                                   num_steps=cfg.num_eval_steps)
    q0, _, q1 = QUERY
    out = {}
    for dev in ("cuda", "cpu"):
        system = SceneAdaptiveInterpolation(cfg, device=dev)
        losses, preds = system.run_validation_iter(clip)
        frames = system._frames(clip)[0]
        adapted = system.builder.adapt(system.meta_params["net"],
                                       system.meta_params["lrs"], frames,
                                       spec)
        out[dev] = (system, frames, losses["psnr"], preds.cpu(),
                    {k: v.detach().cpu() for k, v in adapted.items()})
    (card, card_frames, psnr_card, pred_card, w_card) = out["cuda"]
    (cpu, cpu_frames, psnr_cpu, pred_cpu, w_cpu) = out["cpu"]
    dpsnr = abs(psnr_card - psnr_cpu)
    diff = (pred_card - pred_cpu).abs().max().item()
    step_atol = STEP_ATOL_OF_LR * cfg.inner_lr
    flips = sum(int(((w_card[k] - w).abs() > step_atol).sum())
                for k, w in w_cpu.items())
    total = sum(w.numel() for w in w_cpu.values())
    worst = max((w_card[k] - w).abs().max().item() for k, w in w_cpu.items())
    check(dpsnr <= PSNR_TOL_DB and flips <= CAIN_FLIP_SHARE * total,
          f"cain card vs CPU at {SMALL_HW}: PSNR diff {dpsnr:.3e} dB, "
          f"{flips} of {total} adapted weights differ by more than "
          f"{step_atol:.1e}")
    with torch.no_grad():
        handed = functional_call(cpu.model, w_card, (cpu_frames[q0][None],
                                                     cpu_frames[q1][None]))
        mine = functional_call(card.model, {k: v.cuda() for k, v in
                                            w_card.items()},
                               (card_frames[q0][None],
                                card_frames[q1][None])).cpu()
    handed_diff = (handed - mine).abs().max().item()
    limit = 1e-4 * mine.abs().max().item() + 1e-5
    check(handed_diff <= limit,
          f"cain query on the CPU handed the card's adapted weights: "
          f"max|diff| {handed_diff:.3e} > {limit:.3e}")
    print(f"[main] cain {SMALL_HW[0]}x{SMALL_HW[1]} clip, card vs CPU: PSNR "
          f"{psnr_card:.4f} dB, diff {dpsnr:.3e} dB; max|pred diff| "
          f"{diff:.3e} at max|pred| {pred_cpu.abs().max().item():.3f}; "
          f"adapted weights: {flips} of {total} differ by more than "
          f"{step_atol:.1e} (largest {worst:.3e}); the query on the CPU "
          f"handed the card's adapted weights: max|diff| {handed_diff:.3e} "
          f"(limit {limit:.3e})")


def cain_train_phase(torch, mods, card):
    """CAIN meta-training, run_cain.sh as it stands (batch 8, 1 step, first
    order), on the card: (a) the training CLI at crop 256 for one
    iteration and its validation clip, with its checkpoint (removed
    after); (b) seconds per train iteration, median of TRAIN_REPS after 2
    warm-ups, peak memory, a profile; (c) one second-order iteration at
    batch 1; (d) the first-order outer gradient of a 64x64 clip on the card
    against the CPU. No kernel of ours runs."""
    import shutil
    import tempfile

    import numpy as np

    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.core.checkpoint import load_checkpoint
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.main import main as port_main
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)

    # (a) the training CLI
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="smoke_ckpt_cain_",
                                dir=os.path.join(ROOT, "build"))
    try:
        reset_launches(mods)
        t0 = time.perf_counter()
        stats = port_main(CAIN_TRAIN_FLAGS + [
            "--dataset", "synthetic", "--crop_size", str(CLI_CROP),
            "--max_epoch", "1", "--total_iter_per_epoch", "1",
            "--exp_name", "smoke", "--checkpoint_dir", ckpt_dir])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = launch_counts(mods)
        state = load_checkpoint(os.path.join(ckpt_dir, "smoke"))
        check(not any(got.values()), f"cain train CLI launched {got}")
        check(state is not None and state["epoch"] == 1
              and math.isfinite(stats["best_psnr"]),
              f"cain train CLI: stats {stats}")
        print(f"[train] cain CLI: 1 iteration of batch {CAIN_TASKS} at "
              f"{CLI_CROP}x{CLI_CROP} and its validation clip in {dt:.2f} s "
              f"(set-up and checkpoint included), best PSNR "
              f"{stats['best_psnr']:.3f}, checkpoint epoch {state['epoch']}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # (b) seconds per train iteration
    clips = SyntheticSeptuplet(model="cain", mode="train",
                               size=(CLI_CROP, CLI_CROP))
    frames = np.stack([clips[i][0] for i in range(CAIN_TASKS)])
    system = SceneAdaptiveInterpolation(get_args(CAIN_TRAIN_FLAGS))
    out = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches(mods)
    times = timed_iters(
        torch, lambda: out.append(system.run_train_iter(frames, 0)),
        TRAIN_REPS)
    got = launch_counts(mods)
    check(not any(got.values()), f"cain train iterations launched {got}")
    losses, preds = out[-1]
    check(all(math.isfinite(v) for v in losses.values())
          and tuple(preds.shape) == (CAIN_TASKS, 3, CLI_CROP, CLI_CROP)
          and bool(torch.isfinite(preds).all()),
          f"cain train iteration: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] cain first order, batch {CAIN_TASKS}, {CLI_CROP}x"
          f"{CLI_CROP}, 1 step ({card}): median "
          f"{statistics.median(times):.4f} s a train iteration over "
          f"{TRAIN_REPS} after 2 warm-ups (all "
          f"{[round(t, 4) for t in times]}), loss {losses['loss']:.4f}, "
          f"peak memory {peak:.2f} GiB")
    profile_episode(torch, lambda: system.run_train_iter(frames, 0),
                    f"cain train iteration ({card})", None)
    del system, out

    # (c) second order, batch 1
    second = SceneAdaptiveInterpolation(get_args(
        CAIN_TRAIN_FLAGS + ["--batch_size", "1", "--second_order"]))
    out = []
    torch.cuda.reset_peak_memory_stats()
    times = timed_iters(
        torch, lambda: out.append(second.run_train_iter(frames[:1], 0)), 1,
        warmup=1)
    losses, _ = out[-1]
    check(all(math.isfinite(v) for v in losses.values()),
          f"cain second-order iteration: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[train] cain second order, batch 1, {CLI_CROP}x{CLI_CROP}, 1 "
          f"step ({card}): {times[0]:.4f} s an iteration after a warm-up, "
          f"peak memory {peak:.2f} GiB")
    del second, out

    # (d) the first-order outer gradient, card against CPU: at the inner SGD
    # rule, smooth in the support gradient, each group within
    # OUTER_GRAD_RTOL; at the preset's Adam, whose first step is about
    # lr·sign(g) (see cain_card_vs_cpu), the loss, the distance shown
    train_card_vs_cpu(torch, CAIN_TRAIN_FLAGS + ["--optimizer", "SGD"],
                      "cain", orders=("first",))
    train_card_vs_cpu(torch, CAIN_TRAIN_FLAGS, "cain", orders=("first",),
                      hold_grads=False)


def md5s(directory):
    import hashlib
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = hashlib.md5(f.read()).hexdigest()
    return out


def write_frames(directory, hw, count):
    """``count`` synthetic frames at ``hw`` from the seeded clips, as
    f00.png, f01.png, ..."""
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.utils.viz import save_image
    os.makedirs(directory)
    clip = SyntheticSeptuplet(mode="test", size=hw, num_frames=count)[0][0]
    for i, frame in enumerate(clip):
        save_image(frame, os.path.join(directory, f"f{i:02d}.png"))


def run_test_mode(flags, directory, device=None):
    from meta_interpolation_tpu_torch.main import main as port_main
    extra = ["--device", device] if device else []
    return port_main(TEST_FLAGS + flags + [
        "--data_root", directory, "--checkpoint_dir",
        os.path.join(os.path.dirname(directory), "ckpt")] + extra)


def test_mode_phase(torch, mods):
    """--mode test on a directory of TEST_FRAMES synthetic 256x448 frames
    in a temporary directory, for each model of TEST_MODELS on a fresh copy:
    x2, then x4 on its own output. The frames written hold the JAX
    package's names, no file is overwritten or changed, and SepConv
    launches K1_PER_TEST_CLIP / K2_PER_TEST_CLIP a clip (CAIN none). Then a
    4-frame 64x64 directory on the card and on the CPU: the written frame
    within one 8-bit level. Returns the launches of the SepConv runs."""
    import shutil
    import tempfile

    import numpy as np

    from meta_interpolation_tpu_torch.data.datasets import load_image

    tmp = tempfile.mkdtemp(prefix="smoke_test_mode_")
    try:
        src = os.path.join(tmp, "frames")
        write_frames(src, FULL_HW, TEST_FRAMES)
        sepconv_launches = {}
        for model, flags in TEST_MODELS.items():
            d = os.path.join(tmp, model)
            shutil.copytree(src, d)
            per_clip = ({"sepconv_forward": K1_PER_TEST_CLIP,
                         "sepconv_grad_kernels": K2_PER_TEST_CLIP}
                        if model == "sepconv" else {})
            # the inputs as the first run renames them
            held = {f"{name[:-4]}_0.000000.png": digest
                    for name, digest in md5s(d).items()}
            for run in ("x2", "x4"):
                n_clips = len(held) - 3
                reset_launches(mods)
                t0 = time.perf_counter()
                count = run_test_mode(flags, d)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                got = launch_counts(mods)
                now = md5s(d)
                want_names = sorted(held) + TEST_NAMES[run]
                check(count == len(TEST_NAMES[run])
                      and sorted(now) == sorted(want_names),
                      f"{model} test {run}: wrote {count}, directory "
                      f"{sorted(now)}, want {sorted(want_names)}")
                check(all(now[k] == v for k, v in held.items()),
                      f"{model} test {run} changed an existing frame")
                want = {k: per_clip.get(k, 0) * n_clips for k in got}
                check(got == want, f"{model} test {run} launches {got} for "
                                   f"{n_clips} clips, want {want}")
                frame = load_image(os.path.join(d, TEST_NAMES[run][0]))
                check(frame.shape == FULL_HW + (3,),
                      f"{model} test frame {frame.shape}")
                if model == "sepconv":
                    for k, v in got.items():
                        sepconv_launches[k] = sepconv_launches.get(k, 0) + v
                print(f"[test] {model} {run}: {n_clips} clips at "
                      f"{FULL_HW[0]}x{FULL_HW[1]} in {dt:.2f} s (set-up "
                      f"included), wrote {TEST_NAMES[run]}, launches {got}")
                held = now
        for model, flags in TEST_MODELS.items():
            written = {}
            for dev in ("cuda", "cpu"):
                d = os.path.join(tmp, f"small_{model}_{dev}")
                write_frames(d, SMALL_HW, 4)
                run_test_mode(flags, d, dev)
                written[dev] = np.asarray(load_image(os.path.join(
                    d, TEST_NAMES["x2"][0])))
            levels = float(np.abs(written["cuda"] - written["cpu"]).max()
                           * 255.0)
            check(levels <= 1.0 + 1e-3, f"{model} test frame card vs CPU "
                                        f"differs by {levels} levels")
            print(f"[test] {model} {SMALL_HW[0]}x{SMALL_HW[1]} written frame "
                  f"card vs CPU: max {levels:.0f} 8-bit level(s)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return sepconv_launches


def set_gamma_mult(system):
    system.meta_params["attenuator"]["gamma_mult"].fill_(GAMMA_MULT)


def l2f_phase(torch, mods, card):
    """L2F on SepConv (run_sepconv.sh + --attenuate): the 256x448
    evaluation episode (seconds, launches, profile), a first-order train
    iteration at batch 3 on 256x256 crops, a 64x64 clip and the outer
    gradients (the attenuator's too; first order at the preset's Adamax,
    second at the inner SGD rule) on the card against the CPU. K1 and K2
    run K1_L2F and K2_L2F more a task than without --attenuate. Returns
    the launches of each path."""
    import numpy as np
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    paths = {}
    cfg = get_args(L2F_EVAL_FLAGS)
    system = SceneAdaptiveInterpolation(cfg)
    set_gamma_mult(system)
    frames = SyntheticSeptuplet(mode="val", size=FULL_HW)[0][0][None]
    system.run_validation_iter(frames)   # warm-up
    reps = 3
    reset_launches(mods)
    times = timed_iters(torch, lambda: system.run_validation_iter(frames),
                        reps, warmup=0)
    got = launch_counts(mods)
    want = {"sepconv_forward": (K1_PER_CLIP + K1_L2F) * reps,
            "sepconv_grad_kernels": (K2_PER_CLIP + K2_L2F) * reps}
    check({k: got[k] for k in want} == want,
          f"L2F episodes launched {got}, want {want}")
    paths["l2f_eval"] = got
    losses, preds = system.run_validation_iter(frames)
    check(bool(torch.isfinite(preds).all()) and math.isfinite(
        losses["psnr"]), f"L2F episode output: {losses}")
    print(f"[engine] L2F sepconv {FULL_HW[0]}x{FULL_HW[1]} episode "
          f"({card}): median {statistics.median(times):.4f} s over {reps} "
          f"(all {[round(t, 4) for t in times]}), PSNR "
          f"{losses['psnr']:.3f}, launches K1 {got['sepconv_forward'] // reps}"
          f" K2 {got['sepconv_grad_kernels'] // reps} a clip (without "
          f"--attenuate {K1_PER_CLIP} and {K2_PER_CLIP})")
    profile_episode(torch, lambda: system.run_validation_iter(frames),
                    f"L2F sepconv {FULL_HW[0]}x{FULL_HW[1]} episode ({card})",
                    "sepconv")
    del system
    card_vs_cpu(get_args(L2F_EVAL_FLAGS + ENGINE_CHECK_STEPS), "sepconv",
                prepare=set_gamma_mult)

    system = SceneAdaptiveInterpolation(get_args(L2F_TRAIN_FLAGS))
    set_gamma_mult(system)
    clips = SyntheticSeptuplet(mode="train", size=(CLI_CROP, CLI_CROP))
    frames = np.stack([clips[i][0] for i in range(TASKS)])
    reset_launches(mods)
    times = timed_iters(torch, lambda: system.run_train_iter(frames, 0), 2,
                        warmup=1)
    got = launch_counts(mods)
    want = {"sepconv_forward": (K1_PER_TRAIN_ITER + TASKS * K1_L2F) * 3,
            "sepconv_grad_kernels": (K2_PER_TRAIN_ITER + TASKS * K2_L2F) * 3}
    check({k: got[k] for k in want} == want,
          f"L2F train iterations launched {got}, want {want}")
    gamma_mult = float(system.meta_params["attenuator"]["gamma_mult"])
    check(math.isfinite(gamma_mult) and gamma_mult != GAMMA_MULT,
          f"the attenuator did not train: gamma_mult {gamma_mult}")
    paths["l2f_train"] = got
    print(f"[engine] L2F sepconv first-order train iteration, batch "
          f"{TASKS}, {CLI_CROP}x{CLI_CROP} ({card}): median "
          f"{statistics.median(times):.4f} s over 2 after a warm-up (all "
          f"{[round(t, 4) for t in times]}), launches K1 "
          f"{got['sepconv_forward'] // 3} K2 "
          f"{got['sepconv_grad_kernels'] // 3} an iteration (without "
          f"--attenuate {K1_PER_TRAIN_ITER} and {K2_PER_TRAIN_ITER})")
    del system
    train_card_vs_cpu(torch, L2F_TRAIN_FLAGS + ENGINE_CHECK_STEPS,
                      orders=("first",), prepare=set_gamma_mult)
    train_card_vs_cpu(torch, L2F_TRAIN_FLAGS + ENGINE_CHECK_STEPS
                      + ["--optimizer", "SGD"], orders=("second",),
                      prepare=set_gamma_mult)
    return paths


def per_step_bn_phase(torch, mods, wb, card):
    """Per-step BN statistics on VoxelFlow (run_voxelflow.sh +
    --per_step_bn_statistics --fast_warp_range 8): warp_train_model's
    first-order iterations at batch 8, a second-order one at batch 1 and
    the outer gradients card vs CPU (first order held at the inner SGD
    rule, shown at the preset's Adam); then the statistics after a train
    iteration of two 64x64 clips, card vs CPU, and an evaluation episode
    on the card leaving them as they were. Returns the launches by
    path."""
    import numpy as np
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    paths = warp_train_model(torch, mods, wb, card, "voxelflow",
                             preset=PSBN_TRAIN, name="voxelflow_psbn",
                             hold_first=False)
    train_card_vs_cpu(torch, PSBN_TRAIN[0] + ["--optimizer", "SGD"],
                      "voxelflow", orders=("first",))
    clips = SyntheticSeptuplet(model="voxelflow", mode="train",
                               size=SMALL_HW)
    frames = np.stack([clips[i][0] for i in range(2)])
    cfg = get_args(PSBN_TRAIN[0] + ["--batch_size", "2"])
    states = {}
    for dev in ("cuda", "cpu"):
        system = SceneAdaptiveInterpolation(cfg, device=dev)
        system.run_train_iter(frames, 0)
        states[dev] = {k: v.detach().cpu().clone()
                       for k, v in system.meta_params["bn_state"].items()}
    worst = 0.0
    for k, cpu in states["cpu"].items():
        err = float((states["cuda"][k] - cpu).abs().max())
        limit = BN_RTOL * float(cpu.abs().max()) + BN_ATOL
        check(err <= limit, f"per-step BN {k} card vs CPU {err:.3e} > "
                            f"{limit:.3e}")
        worst = max(worst, err / limit)
    before = {k: v.clone() for k, v in system.meta_params["bn_state"].items()}
    val = SyntheticSeptuplet(model="voxelflow", mode="val",
                             size=SMALL_HW)[0][0][None]
    system = SceneAdaptiveInterpolation(cfg)
    with torch.no_grad():
        for k, v in before.items():
            system.meta_params["bn_state"][k].copy_(v)
    losses, _ = system.run_validation_iter(val)
    check(all(torch.equal(system.meta_params["bn_state"][k], v.cuda())
              for k, v in before.items()) and math.isfinite(losses["psnr"]),
          "an evaluation episode moved the per-step BN statistics")
    print(f"[engine] per-step BN statistics after a train iteration of two "
          f"{SMALL_HW[0]}x{SMALL_HW[1]} clips, card vs CPU: worst "
          f"{worst:.3f} of the limit ({BN_RTOL} x max + {BN_ATOL}); an "
          f"evaluation episode on the card left them unchanged")
    return paths


def disc_params(system):
    return {k: v.detach().cpu().clone()
            for k, v in system.meta_params["loss_ctx"].items()}


def gan_phase(torch, mods, card):
    """The adversarial losses on SepConv (run_sepconv.sh with a GAN term):
    for each of GAN_PATHS two train iterations at batch 3 on 256x256 crops
    (the second timed), K1/K2 launches those of the 1*L1 path (the
    discriminator is cuDNN convolutions), the discriminator moved; then
    the discriminator after a train iteration of a 64x64 clip, card vs CPU
    (WGAN-GP's interpolation weights come from a CPU generator seeded
    alike on both). Returns the launches by path."""
    import numpy as np
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    paths = {}
    clips = SyntheticSeptuplet(mode="train", size=(CLI_CROP, CLI_CROP))
    frames = np.stack([clips[i][0] for i in range(TASKS)])
    small = SyntheticSeptuplet(mode="train", size=SMALL_HW)[0][0][None]
    for name, flags in GAN_PATHS.items():
        system = SceneAdaptiveInterpolation(get_args(flags))
        before = disc_params(system)
        reset_launches(mods)
        out = []
        times = timed_iters(torch, lambda: out.append(
            system.run_train_iter(frames, 0)), 1, warmup=1)
        got = launch_counts(mods)
        want = {"sepconv_forward": K1_PER_TRAIN_ITER * 2,
                "sepconv_grad_kernels": K2_PER_TRAIN_ITER * 2}
        check({k: got[k] for k in want} == want,
              f"{name} train iterations launched {got}, want {want} (the "
              f"1*L1 path's)")
        after = disc_params(system)
        moved = max(float((after[k] - v).abs().max())
                    for k, v in before.items())
        losses = out[-1][0]
        check(moved > 0 and all(math.isfinite(v) for v in losses.values())
              and all(bool(torch.isfinite(v).all()) for v in after.values()),
              f"{name}: discriminator moved {moved}, losses {losses}")
        paths[f"sepconv_{name}_train"] = got
        print(f"[engine] {name} sepconv first-order train iteration, batch "
              f"{TASKS}, {CLI_CROP}x{CLI_CROP} ({card}): {times[0]:.4f} s "
              f"after a warm-up, loss {losses['loss']:.5f}, discriminator "
              f"moved by up to {moved:.3e}, launches K1 "
              f"{got['sepconv_forward'] // 2} K2 "
              f"{got['sepconv_grad_kernels'] // 2} an iteration")
        del system, out
        cfg = get_args(flags + ENGINE_CHECK_STEPS + ["--batch_size", "1"])
        disc = {}
        for dev in ("cuda", "cpu"):
            system = SceneAdaptiveInterpolation(cfg, device=dev)
            system.run_train_iter(small, 0)
            disc[dev] = disc_params(system)
            lr = system.adv_state.opt.param_groups[0]["lr"]
        steps = 1 * (1 * PAIRS + 1) if cfg.disc_per_forward else 1
        flips = total = 0
        worst = 0.0
        for k, cpu in disc["cpu"].items():
            diff = (disc["cuda"][k] - cpu).abs()
            worst = max(worst, float(diff.max()))
            flips += int((diff > 0.1 * lr).sum())
            total += diff.numel()
        check(worst <= 2.5 * lr * steps
              and (steps > 1 or flips <= DISC_FLIP_SHARE * total),
              f"{name} discriminator card vs CPU: max {worst:.3e}, "
              f"{flips} of {total} off by more than 0.1 lr")
        print(f"[engine] {name} discriminator after {steps} step(s) of a "
              f"{SMALL_HW[0]}x{SMALL_HW[1]} clip, card vs CPU: max "
              f"{worst:.3e} (limit {2.5 * lr * steps:.1e}), {flips} of "
              f"{total} off by more than 0.1 lr")
    return paths


def exact_second_order_phase(torch, mods, card):
    """The exact warp's second order on the card: RRIN, SuperSloMo and
    VoxelFlow without --fast_warp_range at batch 1 (one inner step), one
    train iteration at 256x256 (timed after a warm-up; no kernel of ours:
    F.grid_sample, aten's backward and autograd through the closed form of
    the sampler's gradients), then the outer gradient of a 64x64 clip on
    the card against the CPU at the inner SGD rule."""
    import numpy as np
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    for model in ("rrin", "superslomo", "voxelflow"):
        flags = WARP_TRAIN[model][0]
        i = flags.index("--fast_warp_range")
        flags = flags[:i] + flags[i + 2:] + [
            "--number_of_training_steps_per_iter", str(SECOND_ORDER_STEPS),
            "--second_order"]
        frames = SyntheticSeptuplet(model=model, mode="train", size=(
            CLI_CROP, CLI_CROP))[0][0][None]
        system = SceneAdaptiveInterpolation(get_args(
            flags + ["--batch_size", "1"]))
        out = []
        reset_launches(mods)
        torch.cuda.reset_peak_memory_stats()
        times = timed_iters(torch, lambda: out.append(
            system.run_train_iter(frames, 0)), 1, warmup=1)
        got = launch_counts(mods)
        losses, preds = out[-1]
        check(not any(got.values()) and bool(torch.isfinite(preds).all())
              and all(math.isfinite(v) for v in losses.values()),
              f"{model} exact second order: launches {got}, {losses}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"[engine] {model} second order on the exact warp, batch 1, "
              f"{CLI_CROP}x{CLI_CROP} ({card}): {times[0]:.4f} s after a "
              f"warm-up, loss {losses['loss']:.5f}, peak memory {peak:.2f} "
              f"GiB, no kernel of ours")
        del system, out
        train_card_vs_cpu(torch, flags + ["--optimizer", "SGD"], model,
                          orders=("second",))


def engine_phase(torch, mods, wb, card):
    """The scene-adaptation engine's paths: L2F, per-step BN statistics,
    the adversarial losses and the exact warp's second order. Returns the
    launches of each path."""
    paths = timed("engine_l2f", l2f_phase, torch, mods, card)
    paths.update(timed("engine_per_step_bn", per_step_bn_phase, torch, mods,
                       wb, card))
    paths.update(timed("engine_gan", gan_phase, torch, mods, card))
    timed("engine_exact_second_order", exact_second_order_phase, torch, mods,
          card)
    return paths


# --dtype bfloat16: K1 and K2 in their bf16 kernels (banded products on the
# tensor cores), K3, K3-grad and K3-grad² in their bf16 tile kernels, K4
# widened in its wrapper; every preset above with
# --dtype bfloat16; bench.py's serving forwards (every weight in bf16, its
# batches and options at 256x448)
BF16 = ["--dtype", "bfloat16"]
BF16_KERNELS = KERNELS[:4]
# ptxas names of the bf16 K1/K2 kernels in csrc/sepconv.cu
BF16_SEPCONV_KERNELS = {"sepconv_forward_bf16": "sepconv_fwd_bf16_kernel",
                        "sepconv_grad_kernels_bf16":
                            "sepconv_grad_kernels_bf16_kernel"}
# bf16 K1/K2 against the float32 kernel on the widened inputs, rounded: the
# tensor cores sum the same exact products in another float32 order, which
# moves a value across a bf16 rounding boundary in well under a thousandth
# of the outputs on random maps; a sum kept in bf16 would move most of them
BF16_FLIP_SHARE = 1e-2
# each preset's evaluation: (flags, kernel launches a clip)
BF16_EVAL = {
    "sepconv": (EVAL_FLAGS, {"sepconv_forward": K1_PER_CLIP,
                             "sepconv_grad_kernels": K2_PER_CLIP}),
    **{model: (flags, {"warp_sample_bounded_forward": k3,
                       "warp_sample_bounded_grad_grid": k3g})
       for model, (flags, k3, k3g) in WARP_MODELS.items()},
    "dain": (DAIN_FLAGS, {}),
    "cain": (CAIN_EVAL_FLAGS, {})}
# each preset's first-order train iteration: (flags, batch, launches an
# iteration)
BF16_TRAIN = {
    "sepconv": (TRAIN_FLAGS, TASKS,
                {"sepconv_forward": K1_PER_TRAIN_ITER,
                 "sepconv_grad_kernels": K2_PER_TRAIN_ITER}),
    **{model: (flags, batch, {k: v * batch for k, v in
                              train_launches(steps, warps, False).items()}
                             if warps else {})
       for model, (flags, batch, steps, warps) in WARP_TRAIN.items()},
    "cain": (CAIN_TRAIN_FLAGS, CAIN_TASKS, {})}
# bench.py --model / the headline: (batch, model kwargs, forward kwargs,
# launches a forward)
BF16_SERVE = {
    "rrin": (8, {"warp_range": WARP_R}, {},
             {"warp_sample_bounded_forward": WARPS}),
    "voxelflow": (8, {"warp_range": WARP_R}, {},
                  {"warp_sample_bounded_forward": VF_WARPS}),
    "superslomo": (16, {"warp_range": WARP_R}, {},
                   {"warp_sample_bounded_forward": SSM_WARPS}),
    "dain": (1, {}, {"proj_range": PROJ_R, "fill_holes": True},
             {"flow_projection_bounded": K4_PER_FRAME}),
    "sepconv": (4, {}, {}, {"sepconv_forward": CALLS}),
    "cain": (16, {"pad_multiple": 8, "fuse_pad": True}, {}, {})}
BF16_SERVE_ITERS = 5
# bf16 K3 / K3-grad timed at RRIN's padded frame, one image (the kernel
# table's shape) and its served batch (bench.py), R = 8, zeros
BF16_WARP_BATCHES = (1, BF16_SERVE["rrin"][0])
# bf16 calls past the tiled kernels' limit (C > 4: a texel holds 4
# channels), which take the gather route
BF16_GATHER_CASES = [(2, 5, 37, 53, -WARP_R - 3, WARP_R + 2, "uniform",
                      WARP_R, False, "zeros"),
                     (1, 5, 256, 512, -WARP_R, WARP_R - 1, "smooth", WARP_R,
                      True, "border")]
# the 64x64 clip, card vs CPU in bf16: max|card − CPU| within twice
# max|CPU bf16 − CPU float32| plus BF16_FLOOR of the largest value
BF16_FLOOR = 1e-5
BF16_CARD_VS_CPU = ("sepconv", "rrin", "superslomo", "voxelflow", "dain",
                    "cain")
# DAIN's bf16 CPU side is handed the card side's PWC flows, log depths and
# projected offsets, call by call (dain_handing), as the served frame's
# check does in float32: with its own, a projection floor or hole near an
# integer may flip between the devices
DAIN_HANDED = ("flows", "log depth", "offsets")
BF16_SPREAD_RUNS = 3  # the card's side as it runs, for its spread
# presets whose card side is bit for bit the same from run to run under
# torch.use_deterministic_algorithms (CAIN: its reflection pads then take
# models/layers.ReflectPadFunction's backward); the others upsample with
# F.interpolate (models/layers.upsample_bilinear), whose backward on the
# card adds with atomics and has no deterministic version
BF16_BITWISE = ("cain",)


def bf16_ulp(t):
    """One bf16 ulp at max|t| (8 significant bits)."""
    top = t.float().abs().max().item()
    return 0.0 if top == 0 else 2.0 ** (math.floor(math.log2(top)) - 7)


def bf16_err(got, want, what):
    """max|got − want|, held within one bf16 ulp of max|want| + 1e-5."""
    err = (got.float() - want.float()).abs().max().item()
    lim = bf16_ulp(want) + TOL_ABS
    check(err <= lim, f"{what}: max|diff| {err:.3e} > {lim:.3e}")
    return err


def bitwise(torch, got, want, what):
    check(got.dtype == want.dtype and bool(torch.equal(got, want)),
          f"{what}: not bit for bit ({got.dtype} against {want.dtype}, "
          f"max|diff| {(got.float() - want.float()).abs().max().item():.3e})")


class F32Forbidden:
    """A loaded kernel library whose entry points ``names`` raise: on a bf16
    path K1, K2, K3, K3-grad and K3-grad² must run their bf16 kernels
    (``what``, the float32 ones), and K3, K3-grad and K3-grad² their tile
    ones (the gather route is for shapes no main path has)."""

    def __init__(self, lib, names, what="the float32"):
        self._lib, self._names, self._what = lib, set(names), what

    def __getattr__(self, name):
        if name in self._names:
            raise AssertionError(f"{self._what} {name} ran on a bf16 path")
        return getattr(self._lib, name)


class Renamed:
    """A loaded kernel library whose entry points ``names`` ({name:
    other}) are ``other``: TILE_AS_GATHER runs the bf16 gather kernels
    where the wrapper calls the tiled ones; GATHER_AS_BF16 runs an earlier
    source's bf16 kernel (the gather design) on both routes."""

    def __init__(self, lib, names):
        self._lib, self._names = lib, names

    def __getattr__(self, name):
        return getattr(self._lib, self._names.get(name, name))


class Recording:
    """A loaded kernel library that counts the calls of its entry points
    ``names`` in ``calls``, by (entry point, N, C, H, W, R, align_corners,
    border): the shapes a main path gives a kernel."""

    def __init__(self, lib, names):
        self._lib, self._names = lib, set(names)
        self.calls = collections.Counter()

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in self._names:
            return fn

        def record(*args):
            self.calls[(name, *args[-8:-1])] += 1
            return fn(*args)
        return record


TILE_AS_GATHER = {f"{k}_bf16": f"{k}_bf16_gather"
                  for k in ("warp_sample_bounded_forward",
                            "warp_sample_bounded_grad_grid")}
GATHER_AS_BF16 = {v: k for k, v in TILE_AS_GATHER.items()}


def earlier_bf16(lib):
    """An earlier csrc/warp.cu's bf16 K3 and K3-grad on both routes: its
    own gather entry points where it has them, else its one bf16 kernel
    (the gather design) on both (GATHER_AS_BF16)."""
    return (lib if hasattr(lib, "warp_sample_bounded_forward_bf16_gather")
            else Renamed(lib, GATHER_AS_BF16))


def bf16_only(sc, wb, fn):
    """``fn`` with the plain K1/K2 and bounded-sampler versions patched to
    raise and the float32 entry points of K1, K2, K3, K3-grad and K3-grad²
    too (K3-grad²'s gather route is its float32 kernel, widened), and the
    gather route of K3 and K3-grad: on the card a bf16 path runs the bf16
    kernels only, K3, K3-grad and K3-grad² their tile ones."""
    def forbidden(*_args, **_kw):
        raise AssertionError("a plain sepconv version ran on the card")
    sc_lib = F32Forbidden(sc._library(), ("sepconv_forward",
                                          "sepconv_grad_kernels"))
    wb_lib = F32Forbidden(F32Forbidden(wb._library(), GATHER_AS_BF16,
                                       "the gather route's"),
                          ("warp_sample_bounded_forward",
                           "warp_sample_bounded_grad_grid", GRAD2))
    fn = on_library(sc, sc_lib, on_library(wb, wb_lib, fn))
    fn = with_attr(sc, "sepconv_ref", forbidden,
                   with_attr(sc, "grad_kernels_ref", forbidden, fn))
    return plain_warp_forbidden(wb, fn)


def bf16_kernel_phase(torch, mods, card, earlier_lib=None, resources=None,
                      earlier_warp_lib=None):
    """K1 and K2 in bf16 at every KERNEL_SHAPES entry within one bf16 ulp of
    max + 1e-5 of the float32 kernel on the widened inputs, rounded, and of
    their plain bf16 versions, with at most BF16_FLIP_SHARE of the outputs
    differing at all from the former (the share printed per shape); K3 and
    K3-grad in bf16 within one bf16 ulp of max + 1e-5 of their plain bf16
    versions at every warp_cases() entry (a bf16 grid too); K3-grad² (also
    at GRAD2_GATHER_CASES, its gather route) and K4 on bf16 operands bit
    for bit their float32 kernels on the widened ones, rounded (K3-grad²
    also ``earlier_warp_lib``'s where given, grad2_bf16), K3-grad² within
    one bf16 ulp of max + 1e-5 of its plain version, timed at GRAD2_SHAPES
    in turns with the widened call (grad2_timing), and one call's device
    ops and device ms against the widened call's (grad2_call_ops). Each
    bf16 kernel timed in turns with its float32 kernel
    (float32, bf16, bf16, float32) at the main-path shape, beside its plain
    bf16 version, its bound (K1/K2: their operations at the bf16
    tensor-core rate, the others at the fp32 rate; bytes at their bf16
    size) and the library's bf16 call; K1 and K2 in bf16 also in turns
    with those of ``earlier_lib`` (an earlier csrc/sepconv.cu) where given.
    K3 and K3-grad in bf16 also at BF16_GATHER_CASES (the gather route),
    each case's route printed, both routes taken; at every case bit for
    bit the gather kernels and, where given, ``earlier_warp_lib`` (an
    earlier csrc/warp.cu with today's C interface); and timed at
    BF16_WARP_BATCHES (bf16_warp_timing). ``resources``: the bf16 kernels'
    registers, spills and static shared memory (ptxas). Returns the bf16
    kernels' records."""
    import torch.nn.functional as F
    sc, wb, fpb = mods
    bf = torch.bfloat16
    flops_peak, bw_peak = peaks(card)
    tensor_peak = bf16_tensor_peak(card)
    errs = dict.fromkeys(BF16_KERNELS + (GRAD2,), 0.0)
    for n, h, w, f in KERNEL_SHAPES:
        gen = torch.Generator().manual_seed(n * 100000 + h * 1000 + w + f + 1)
        inp = torch.rand(n, 3, h + f - 1, w + f - 1, generator=gen).cuda()
        kv, kh = (torch.randn(n, f, h, w, generator=gen).cuda()
                  for _ in "vh")
        g = torch.randn(n, 3, h, w, generator=gen).cuda()
        b = [t.to(bf) for t in (inp, g, kv, kh)]
        wide = [t.float() for t in b]
        what = f"bf16 {n}x{h}x{w} F={f}"
        got = {"sepconv_forward": (sc.sepconv_forward(b[0], b[2], b[3]),),
               "sepconv_grad_kernels": sc.sepconv_grad_kernels(*b)}
        f32 = {"sepconv_forward": (sc.sepconv_forward(
                   wide[0], wide[2], wide[3]).to(bf),),
               "sepconv_grad_kernels": tuple(
                   t.to(bf) for t in sc.sepconv_grad_kernels(*wide))}
        plain = {"sepconv_forward": (sc._widened(sc.sepconv_ref, b[0], b[2],
                                                 b[3]),),
                 "sepconv_grad_kernels": sc._widened(sc.grad_kernels_ref,
                                                     *b)}
        shares = []
        for name, parts in (("sepconv_forward", ("out",)),
                            ("sepconv_grad_kernels", ("gkv", "gkh"))):
            for part, a, c, p in zip(parts, got[name], f32[name],
                                     plain[name]):
                label = f"{'K1' if name == 'sepconv_forward' else 'K2'} " \
                        f"{part} {what}"
                check(a.dtype == bf, f"{label}: {a.dtype} out")
                bf16_err(a, c, f"{label} against the float32 kernel on "
                               f"widened inputs, rounded")
                errs[name] = max(errs[name], bf16_err(
                    a, p, f"{label} against its plain bf16 version"))
                share = (a != c).sum().item() / a.numel()
                check(share <= BF16_FLIP_SHARE,
                      f"{label}: {share:.3e} of the outputs differ from the "
                      f"float32 kernel's, rounded (limit {BF16_FLIP_SHARE})")
                shares.append(f"{part} {share:.2e}")
        torch.cuda.synchronize()
        print(f"[bf16] K1/K2 {what}: within one bf16 ulp of max + "
              f"{TOL_ABS:g} of the float32 kernels on the widened inputs and "
              f"of the plain bf16 versions; share of outputs that differ "
              f"from the float32 kernels' rounded: {', '.join(shares)} "
              f"(limit {BF16_FLIP_SHARE:g})")
    print(f"[bf16] K1 and K2 in bf16 at {len(KERNEL_SHAPES)} shapes: "
          f"max|diff| to their plain bf16 versions K1 "
          f"{errs['sepconv_forward']:.3e}, K2 "
          f"{errs['sepconv_grad_kernels']:.3e}")
    for name, res in (resources or {}).items():
        print(f"[bf16] {name}: {res['registers']} registers, {res['spill']} "
              f"bytes spilled, {res.get('smem', 0)} bytes static shared "
              f"memory")
    earlier = None if earlier_lib is None else {
        "sepconv_forward": on_library(sc, earlier_lib, sc.sepconv_forward),
        "sepconv_grad_kernels": on_library(sc, earlier_lib,
                                           sc.sepconv_grad_kernels)}
    sc_args = {"sepconv_forward": (b[0], b[2], b[3]),
               "sepconv_grad_kernels": tuple(b)}
    for name, fn in (earlier or {}).items():  # at the SepConv shape
        out = fn(*sc_args[name])
        for a, p in zip(out if isinstance(out, tuple) else (out,),
                        plain[name]):
            bf16_err(a, p, f"earlier {name} bf16 against its plain bf16 "
                           f"version")
    sc_calls = {"sepconv_forward": (
        lambda: sc.sepconv_forward(*wide[:1], *wide[2:]),
        lambda: sc.sepconv_forward(b[0], b[2], b[3]),
        lambda: sc._widened(sc.sepconv_ref, b[0], b[2], b[3]),
        2 * n * h * w * 3 * f * (f + 1),
        2 * (n * 3 * (h + f - 1) * (w + f - 1) + 2 * n * f * h * w
             + n * 3 * h * w), None, "meta_interpolation_tpu/ops/sepconv.py:134"),
                "sepconv_grad_kernels": (
        lambda: sc.sepconv_grad_kernels(*wide),
        lambda: sc.sepconv_grad_kernels(*b),
        lambda: sc._widened(sc.grad_kernels_ref, *b),
        2 * n * h * w * f * f * 5,
        2 * (n * 3 * (h + f - 1) * (w + f - 1) + n * 3 * h * w
             + 4 * n * f * h * w), None,
        "meta_interpolation_tpu/ops/sepconv.py:233")}
    sc_shape = f"in {n}x3x{h + f - 1}x{w + f - 1}, maps {n}x{f}x{h}x{w}, bf16"

    # K3 / K3-grad at every warp case in bf16 (the grid float32; every
    # fourth case a bf16 grid) and the gather route's, bit for bit the
    # gather kernels and the earlier design; K3-grad² bit for bit its
    # widened call
    cases = warp_cases() + BF16_GATHER_CASES
    views = {"the gather kernels": Renamed(wb._library(), TILE_AS_GATHER)}
    if earlier_warp_lib is not None:
        views["the earlier design"] = earlier_bf16(earlier_warp_lib)
    routes = {"tile": 0, "gather": 0}
    wb.reset_launches()
    for i, case in enumerate(cases):
        n, c, h, w, lo, hi, kind, r, align, padding = case
        img, g, v, grid, opts, what = bf16_warp_inputs(torch, case, i)
        out = wb.warp_sample_bounded_forward(img, grid, *opts)
        check(out.dtype == bf, f"K3 {what}: {out.dtype} out")
        errs["warp_sample_bounded_forward"] = max(
            errs["warp_sample_bounded_forward"],
            bf16_err(out, wb.grid_sample_bounded_ref(img, grid, *opts),
                     f"K3 {what}"))
        ggrid = wb.warp_sample_bounded_grad_grid(img, grid, g, *opts)
        check(ggrid.dtype == grid.dtype, f"K3-grad {what}: {ggrid.dtype}")
        errs["warp_sample_bounded_grad_grid"] = max(
            errs["warp_sample_bounded_grad_grid"],
            bf16_err(ggrid, wb.grid_sample_bounded_grad_grid_ref(
                img, grid, g, *opts), f"K3-grad {what}"))
        for label, lib in views.items():
            bitwise(torch, on_library(wb, lib, wb.warp_sample_bounded_forward)(
                img, grid, *opts), out, f"K3 {what} against {label}")
            bitwise(torch, on_library(wb, lib,
                                      wb.warp_sample_bounded_grad_grid)(
                img, grid, g, *opts), ggrid,
                f"K3-grad {what} against {label}")
        errs[GRAD2] = max(errs[GRAD2], grad2_plain_err(
            torch, wb, grad2_bf16(torch, wb, img, grid, g, v, opts, what,
                                  earlier_warp_lib),
            img, grid, g, v, opts, what))
        win = wb.bf16_window(n, c, h, w, r)
        routes[win.route] += 1
        print(f"[bf16] K3 / K3-grad / K3-grad² {what}: {win.route} route (a "
              f"block's window at most {win.rows}x{win.cols} texels, "
              f"{win.shared_bytes} B), bit for bit {' and '.join(views)}")
    torch.cuda.synchronize()
    check(all(routes.values()), f"bf16 K3 routes taken: {routes}")
    # the gather route's own counts: each gather case's call and one a
    # view (the tiled cases' gather view runs through the tile route);
    # K3-grad²'s gather route (widened) each gather case's call
    gathered = [wb.warp_sample_bounded_forward.gather_launches,
                wb.warp_sample_bounded_grad_grid.gather_launches,
                wb.warp_sample_bounded_grad_grid_backward.gather_launches]
    check(gathered == [routes["gather"] * (1 + len(views))] * 2
          + [routes["gather"]],
          f"gather route launches {gathered}, routes {routes}")
    # K3-grad² past the window limit at large R (its plain version is the
    # closed form; K3's, the sweep, is not run there)
    for i, case in enumerate(GRAD2_GATHER_CASES):
        n, c, h, w, lo, hi, kind, r, align, padding = case
        img, g, v, grid, opts, what = bf16_warp_inputs(torch, case, i)
        check(wb.bf16_window(n, c, h, w, r).route == "gather",
              f"K3-grad² {what}: not on the gather route")
        before = wb.warp_sample_bounded_grad_grid_backward.gather_launches
        errs[GRAD2] = max(errs[GRAD2], grad2_plain_err(
            torch, wb, grad2_bf16(torch, wb, img, grid, g, v, opts, what,
                                  earlier_warp_lib),
            img, grid, g, v, opts, what))
        check(wb.warp_sample_bounded_grad_grid_backward.gather_launches
              == before + 1, f"K3-grad² {what}: no gather launch")
        print(f"[bf16] K3-grad² {what}: gather route (the float32 kernel on "
              f"the widened operands)")
    print(f"[bf16] K3 and K3-grad in bf16 agree with their plain bf16 "
          f"versions within one bf16 ulp of max + {TOL_ABS:g} at "
          f"{len(cases)} cases ({routes['tile']} on the tile route, "
          f"{routes['gather']} on the gather route; max|diff| K3 "
          f"{errs['warp_sample_bounded_forward']:.3e}, K3-grad "
          f"{errs['warp_sample_bounded_grad_grid']:.3e}), bit for bit "
          f"{' and '.join(views)}; K3-grad² in bf16 at those and "
          f"{len(GRAD2_GATHER_CASES)} more (gather) is bit for bit its "
          f"float32 kernel on the widened operands, rounded"
          + ("" if earlier_warp_lib is None else
             " (this design's and the earlier one's)")
          + f", within one bf16 ulp of max + {TOL_ABS:g} of its plain "
          f"version (max|diff| {errs[GRAD2]:.3e})")
    n, c, (h, w), r = 1, 3, WARP_SHAPES[-1][:2], WARP_R
    gen = torch.Generator().manual_seed(5)
    img = torch.rand(n, c, h, w, generator=gen).cuda()
    g = torch.randn(n, c, h, w, generator=gen).cuda()
    v = torch.randn(n, h, w, 2, generator=gen).cuda()
    grid = warp_grid(torch, "library", n, h, w, -r, r - 2, False, 6).cuda()
    img_b, g_b, grid_b = img.to(bf), g.to(bf), grid.to(bf)
    opts = (r, False, "zeros")
    pixels = n * h * w
    wb_calls = {"warp_sample_bounded_forward": (
        lambda: wb.warp_sample_bounded_forward(img, grid, *opts),
        lambda: wb.warp_sample_bounded_forward(img_b, grid, *opts),
        lambda: wb.grid_sample_bounded_ref(img_b, grid, *opts),
        pixels * (40 + 7 * c), pixels * (8 + 4 * c),
        lambda: F.grid_sample(img_b, grid_b, mode="bilinear",
                              padding_mode="zeros", align_corners=False),
        "meta_interpolation_tpu/ops/warp_pallas.py:86"),
                "warp_sample_bounded_grad_grid": (
        lambda: wb.warp_sample_bounded_grad_grid(img, grid, g, *opts),
        lambda: wb.warp_sample_bounded_grad_grid(img_b, grid, g_b, *opts),
        lambda: wb.grid_sample_bounded_grad_grid_ref(img_b, grid, g_b,
                                                     *opts),
        pixels * (50 + 16 * c), pixels * (16 + 4 * c),
        lambda: torch.ops.aten.grid_sampler_2d_backward(
            g_b, img_b, grid_b, 0, 0, False, [False, True])[1],
        "meta_interpolation_tpu/ops/warp.py:310"),
                GRAD2: (
        lambda: wb.warp_sample_bounded_grad_grid_backward(img, grid, g, v,
                                                          *opts),
        lambda: wb.warp_sample_bounded_grad_grid_backward(img_b, grid, g_b,
                                                          v, *opts),
        lambda: widened_plain_grad2(wb, img_b, grid, g_b, v, opts),
        pixels * (80 + 27 * c), pixels * (24 + 6 * c), None,
        "meta_interpolation_tpu/ops/warp.py:310")}
    wb_shape = (f"img {n}x{c}x{h}x{w} bf16, grid {n}x{h}x{w}x2 float32, "
                f"R={r}, zeros, align_corners=False (library: the grid "
                f"rounded to bf16)")

    # K4 on a bf16 flow and depth: its float32 kernel on the widened ones
    for n, h, w, r, kind, span in PROJ_CASES[:3]:
        flow = proj_flow(torch, kind, n, h, w, span, 21).cuda().to(bf)
        depth = (torch.rand(n, h, w, 1, generator=torch.Generator()
                            .manual_seed(22)) + 0.5).cuda().to(bf)
        proj, cnt = fpb.flow_projection_bounded(flow, depth, r)
        wproj, wcnt = fpb.flow_projection_bounded(flow.float(), depth.float(),
                                                  r)
        bitwise(torch, proj, wproj.to(bf), f"K4 bf16 {n}x{h}x{w} {kind} proj")
        bitwise(torch, cnt, wcnt.to(bf), f"K4 bf16 {n}x{h}x{w} {kind} cnt")
    print(f"[bf16] K4 on bf16 flows is its float32 kernel on the widened "
          f"ones, rounded, at {len(PROJ_CASES[:3])} cases")

    records = []
    for name, (f32_fn, fn, plain, ops, nbytes, lib, line) in {
            **sc_calls, **wb_calls}.items():
        f32_ms, bf16_ms = in_turns(torch, (f32_fn, fn))
        ms = statistics.median(bf16_ms)
        plain_ms = time_ms(torch, plain)
        library_ms = None if lib is None else time_ms(torch, lib)
        sepconv = name.startswith("sepconv")
        rate = tensor_peak if sepconv else flops_peak
        t_ops, t_bytes = ops / rate * 1e3, nbytes / bw_peak * 1e3
        bound = max(t_ops, t_bytes)
        records.append({
            "name": f"{name}_bf16", "route": "cuda",
            "source": f"{PACKAGE}/csrc/{'sepconv' if sepconv else 'warp'}.cu",
            "replaces": line, "launches": None, "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "float32_ms_in_turns": f32_ms,
            "bf16_ms_in_turns": bf16_ms,
            "shape": sc_shape if sepconv else wb_shape,
            "gflop": ops / 1e9, "mbytes": nbytes / 1e6})
        print(f"[bf16] {name} bf16: {ms:.4f} ms, in turns (float32, bf16, "
              f"bf16, float32) float32 {f32_ms[0]:.4f}, {f32_ms[1]:.4f} ms, "
              f"bf16 {bf16_ms[0]:.4f}, {bf16_ms[1]:.4f} ms (plain bf16 "
              f"{plain_ms:.4f} ms, bound {bound:.6f} ms by "
              f"{records[-1]['bound_by']} at the bf16 bytes and "
              f"{rate / 1e12:g} TFLOP/s, {bound / ms:.3f} of it reached; "
              f"library "
              + ("none" if library_ms is None else f"{library_ms:.4f} ms")
              + f"; {card})")
        if sepconv and earlier is None:
            print(f"[bf16] {name} bf16: earlier design not given "
                  f"(--earlier-sepconv)")
        elif sepconv:
            new_ms, old_ms = in_turns(
                torch, (fn, lambda: earlier[name](*sc_args[name])))
            records[-1]["earlier_ms_in_turns"] = old_ms
            print(f"[bf16] {name} bf16, in turns (this, earlier, earlier, "
                  f"this): this design {new_ms[0]:.4f}, {new_ms[1]:.4f} ms; "
                  f"earlier design {old_ms[0]:.4f}, {old_ms[1]:.4f} ms; "
                  f"bound {bound:.6f} ms ({card})")
    timing = bf16_warp_timing(torch, wb, card, earlier_warp_lib)
    for rec in records:
        by_batch = timing.get(rec["name"][:-len("_bf16")])
        if by_batch:
            rec["by_batch"] = by_batch
            rec["served_batch"] = by_batch[-1]
    grad2 = next(rec for rec in records if rec["name"] == f"{GRAD2}_bf16")
    grad2["by_shape"] = grad2_timing(torch, wb, card, GRAD2_SHAPES,
                                     earlier_warp_lib, ("bf16",))["bf16"]
    grad2["device_ops"] = grad2_call_ops(torch, wb, img_b, grid, g_b, v,
                                         opts, card)
    return records


def widened_plain_grad2(wb, img, grid, g, v, opts):
    """K3-grad²'s plain version on the widened operands, gg rounded to
    g's type and the grid's cotangent to the grid's."""
    gg, ggrid = wb.grid_sample_bounded_grad_grid_backward_ref(
        img.float(), grid.float(), g.float(), v, *opts)
    return gg.to(g.dtype), ggrid.to(grid.dtype)


def grad2_plain_err(torch, wb, got, img, grid, g, v, opts, what):
    """The larger max|diff| of a bf16 K3-grad² result ``got`` (gg, ggrid)
    to its plain version on the widened operands, each held within one
    bf16 ulp of max + TOL_ABS."""
    want = wb.grid_sample_bounded_grad_grid_backward_ref(
        img.float(), grid.float(), g.float(), v, *opts)
    return max(bf16_err(a, b, f"K3-grad² {part} {what} against its plain "
                              f"version")
               for part, a, b in zip(("gg", "grid"), got, want))


def grad2_call_ops(torch, wb, img, grid, g, v, opts, card, reps=10):
    """One bf16 K3-grad² call (float32 grid) and the same call as it ran
    before its bf16 kernel (widened_grad2), in turns (this, widened,
    widened, this): the device ops and the device ms a call, from
    torch.profiler over ``reps`` calls. Its bf16 kernel is one device op
    a call; the widened call also three casts. A turn whose profile caught
    no device event at all (the profiler now and then drops a cycle's) is
    profiled again, up to PROFILE_TRIES times; one that caught events is
    held as it is."""
    paths = {"bf16 kernel": lambda: wb.warp_sample_bounded_grad_grid_backward(
                 img, grid, g, v, *opts),
             "widened": lambda: widened_grad2(wb)(img, grid, g, v, *opts)}
    stats = {which: {"ops": [], "busy": []} for which in paths}
    for which in ("bf16 kernel", "widened", "widened", "bf16 kernel"):
        fn = paths[which]
        fn()
        for _ in range(PROFILE_TRIES):
            _, busy, rows, _ = device_time_by_kernel(
                torch, lambda: [fn() for _ in range(reps)])
            if rows:
                break
        stats[which]["ops"].append(sum(k for _, k, _ in rows) / reps)
        stats[which]["busy"].append(busy / reps)
    check(stats["bf16 kernel"]["ops"] == [1.0, 1.0],
          f"a bf16 K3-grad² call ran {stats['bf16 kernel']['ops']} device "
          f"ops, want one")
    for which, st in stats.items():
        print(f"[bf16] one K3-grad² call at {tuple(img.shape)}, {which}, in "
              f"turns (bf16 kernel, widened, widened, bf16 kernel): "
              f"{st['ops'][0]:.0f} device ops, device ms "
              + ", ".join(f"{b:.4f}" for b in st["busy"]) + f" ({card})")
    return stats


def bf16_warp_inputs(torch, case, i):
    """The bf16 K3 check of warp case ``case``, the ``i``-th: (img, g, v,
    grid, (R, align_corners, padding), label); img and g bf16, v float32,
    the grid float32 or, every fourth case, bf16."""
    n, c, h, w, lo, hi, kind, r, align, padding = case
    bf = torch.bfloat16
    seed = h * 1000 + w + hi + 17 * r + 3 * align + 1
    gen = torch.Generator().manual_seed(seed)
    img = torch.rand(n, c, h, w, generator=gen).cuda().to(bf)
    g = torch.randn(n, c, h, w, generator=gen).cuda().to(bf)
    v = torch.randn(n, h, w, 2, generator=gen).cuda()
    grid = warp_grid(torch, kind, n, h, w, lo, hi, align, seed).cuda()
    if i % 4 == 3:
        grid = grid.to(bf)
    what = (f"bf16 {n}x{c}x{h}x{w} {kind}, R={r}, align_corners={align}, "
            f"{padding}, {grid.dtype} grid")
    return img, g, v, grid, (r, align, padding), what


def bf16_warp_timing(torch, wb, card, earlier_lib=None, label="earlier"):
    """bf16 K3 and K3-grad at each BF16_WARP_BATCHES batch of RRIN's padded
    frame (R = 8, zeros, align_corners=False, random displacements within
    range): held bit for bit to the gather kernels and, where given,
    ``earlier_lib``'s bf16 kernels (its _bf16 entry points on both
    routes), then timed in turns with each (tile, gather, gather, tile;
    this, ``label``, ``label``, this), beside the bound at the bf16 bytes
    and the library's bf16 call (the grid rounded to bf16). Returns
    {wrapper name: [a record a batch]}."""
    import torch.nn.functional as F
    flops_peak, bw_peak = peaks(card)
    bf = torch.bfloat16
    views = {"gather": Renamed(wb._library(), TILE_AS_GATHER)}
    if earlier_lib is not None:
        views[label] = earlier_bf16(earlier_lib)
    timing = {"warp_sample_bounded_forward": [],
              "warp_sample_bounded_grad_grid": []}
    c, (h, w), r = 3, WARP_SHAPES[-1][:2], WARP_R
    opts = (r, False, "zeros")
    for n in BF16_WARP_BATCHES:
        gen = torch.Generator().manual_seed(5)
        img = torch.rand(n, c, h, w, generator=gen).cuda().to(bf)
        g = torch.randn(n, c, h, w, generator=gen).cuda().to(bf)
        grid = warp_grid(torch, "library", n, h, w, -r, r - 2, False,
                         6).cuda()
        grid_b, pixels = grid.to(bf), n * h * w
        for name, args, ops, nbytes, lib in [
                ("warp_sample_bounded_forward", (img, grid, *opts),
                 pixels * (40 + 7 * c), pixels * (8 + 4 * c),
                 lambda: F.grid_sample(img, grid_b, mode="bilinear",
                                       padding_mode="zeros",
                                       align_corners=False)),
                ("warp_sample_bounded_grad_grid", (img, grid, g, *opts),
                 pixels * (50 + 16 * c), pixels * (16 + 4 * c),
                 lambda: torch.ops.aten.grid_sampler_2d_backward(
                     g, img, grid_b, 0, 0, False, [False, True])[1])]:
            wrapper = getattr(wb, name)
            t_ops, t_bytes = ops / flops_peak * 1e3, nbytes / bw_peak * 1e3
            bound = max(t_ops, t_bytes)
            rec = {"shape": f"img {n}x{c}x{h}x{w} bf16, grid {n}x{h}x{w}x2 "
                            f"float32, R={r}, zeros, align_corners=False",
                   "route": wb.bf16_window(n, c, h, w, r).route,
                   "bound_ms": bound,
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "gflop": ops / 1e9, "mbytes": nbytes / 1e6,
                   "library_ms": time_ms(torch, lib)}
            this = []
            for label, view in views.items():
                bitwise(torch, on_library(wb, view, wrapper)(*args),
                        wrapper(*args), f"{name} bf16 {rec['shape']} "
                                        f"against {label}")
                mine, theirs = in_turns(torch, (
                    lambda: wrapper(*args),
                    on_library(wb, view, lambda: wrapper(*args))))
                this += mine
                rec[f"ms_in_turns_with_{label}"] = mine
                rec[f"{label}_ms_in_turns"] = theirs
            rec["ms"] = statistics.median(this)
            timing[name].append(rec)
            print(f"[bf16] {name} bf16 at {n}x{c}x{h}x{w}: "
                  f"{rec['ms']:.4f} ms ({rec['route']} route, bit for bit "
                  f"{' and '.join(views)}), "
                  + "; ".join(f"in turns (this, {k}, {k}, this) this "
                              f"{rec[f'ms_in_turns_with_{k}'][0]:.4f}, "
                              f"{rec[f'ms_in_turns_with_{k}'][1]:.4f} ms, "
                              f"{k} {rec[f'{k}_ms_in_turns'][0]:.4f}, "
                              f"{rec[f'{k}_ms_in_turns'][1]:.4f} ms"
                              for k in views)
                  + f"; bound {bound:.6f} ms by {rec['bound_by']} "
                  f"({nbytes / 1e6:.2f} MB), {bound / rec['ms']:.3f} of it "
                  f"reached; library {rec['library_ms']:.4f} ms ({card})")
    return timing


def bf16_systems(flags, state=None):
    """The system of ``flags`` in float32 and in bf16, on the card."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    systems = {}
    for dtype in ("float32", "bfloat16"):
        systems[dtype] = SceneAdaptiveInterpolation(
            get_args(flags + ["--dtype", dtype]))
        if state is not None:
            systems[dtype].load_net(state)
    return systems


def bf16_turns(torch, mods, sc, wb, runs, want, what, reps=1):
    """``runs`` {dtype: fn} after one warm-up each (peak memory), then in
    turns (float32, bf16, bf16, float32) ``reps`` times; every run's
    launches held to ``want``, the bf16 runs with bf16_only. Returns
    ({dtype: seconds}, {dtype: peak GiB}, {dtype: last result})."""
    runs = {"float32": runs["float32"],
            "bfloat16": bf16_only(sc, wb, runs["bfloat16"])}
    peak, out = {}, {}
    for dtype, run in runs.items():
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peak[dtype] = torch.cuda.max_memory_allocated() / 2**30
    times = {dtype: [] for dtype in runs}
    for dtype in ("float32", "bfloat16", "bfloat16", "float32") * reps:
        reset_launches(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[dtype] = runs[dtype]()
        torch.cuda.synchronize()
        times[dtype].append(time.perf_counter() - t0)
        got = launch_counts(mods)
        full = {k: want.get(k, 0) for k in got}
        check(got == full, f"{what} {dtype}: launches {got}, want {full}")
    return times, peak, out, runs


def bf16_eval_phase(torch, mods, card, dain_state):
    """Each preset's 256x448 evaluation episode in float32 and in bf16, in
    turns: seconds, PSNR of the same clip, peak memory, launches (the same
    in both), a profile of the bf16 one. Returns the bf16 launches by
    path."""
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    sc, wb, _ = mods
    paths = {}
    for model, (flags, per_clip) in BF16_EVAL.items():
        systems = bf16_systems(flags, dain_state if model == "dain" else None)
        frames = SyntheticSeptuplet(model=model, mode="val",
                                    size=FULL_HW)[0][0][None]
        runs = {dtype: (lambda s=s: s.run_validation_iter(frames))
                for dtype, s in systems.items()}
        times, peak, out, runs = bf16_turns(
            torch, mods, sc, wb, runs, per_clip,
            f"{model} {FULL_HW} episode")
        for dtype, (losses, preds) in out.items():
            check(tuple(preds.shape) == (1, 3) + FULL_HW
                  and preds.dtype == torch.float32
                  and bool(torch.isfinite(preds).all())
                  and math.isfinite(losses["psnr"]),
                  f"{model} {dtype} episode output: {losses}")
        diff = (out["bfloat16"][1] - out["float32"][1]).abs().max().item()
        for dtype in times:
            print(f"[bf16] {model} {FULL_HW[0]}x{FULL_HW[1]} episode "
                  f"{dtype} ({card}): median "
                  f"{statistics.median(times[dtype]):.4f} s over "
                  f"{len(times[dtype])} in turns (all "
                  f"{[round(t, 4) for t in times[dtype]]}), PSNR "
                  f"{out[dtype][0]['psnr']:.4f} dB, peak memory "
                  f"{peak[dtype]:.2f} GiB, launches a clip {per_clip}")
        # the float32 episode's profile is its own phase's
        profile_episode(torch, runs["bfloat16"], f"{model} episode bfloat16",
                        None)
        print(f"[bf16] {model} episode: max|pred bf16 − float32| "
              f"{diff:.3e}, PSNR bf16 − float32 "
              f"{out['bfloat16'][0]['psnr'] - out['float32'][0]['psnr']:+.4f}"
              f" dB")
        paths[f"bf16_{model}_eval"] = dict(per_clip)
        del systems, runs, out
        torch.cuda.empty_cache()
    return paths


def bf16_train_phase(torch, mods, card, dain_state):
    """Each preset's first-order train iteration at its batch on 256x256
    crops, float32 and bf16 in turns (after a warm-up each): seconds, peak
    memory, launches (the same in both; not profiled: CAIN's 2e5 device
    ops take the profiler minutes); the meta-parameters, rates and
    optimizer state stay float32. Then one
    second-order bf16 VoxelFlow iteration at batch 1 (K3-grad² on widened
    operands). Returns the bf16 launches by path."""
    import numpy as np
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    sc, wb, _ = mods
    paths = {}
    for model, (flags, batch, per_iter) in BF16_TRAIN.items():
        clips = SyntheticSeptuplet(model=model, mode="train",
                                   size=(CLI_CROP, CLI_CROP))
        frames = np.stack([clips[i][0] for i in range(batch)])
        systems = bf16_systems(flags, dain_state if model == "dain" else None)
        runs = {dtype: (lambda s=s: s.run_train_iter(frames, 0))
                for dtype, s in systems.items()}
        times, peak, out, runs = bf16_turns(
            torch, mods, sc, wb, runs, per_iter,
            f"{model} train iteration, batch {batch}")
        for dtype, (losses, preds) in out.items():
            check(all(math.isfinite(v) for v in losses.values())
                  and bool(torch.isfinite(preds).all()),
                  f"{model} {dtype} train iteration: {losses}")
        masters = {v.dtype for tree in systems["bfloat16"].meta_params.values()
                   for v in tree.values()}
        moments = {v.dtype for st in systems["bfloat16"].outer_opt.state
                   .values() for v in st.values() if torch.is_tensor(v)
                   and v.is_floating_point()}
        check(masters == {torch.float32} and moments <= {torch.float32},
              f"{model} bf16 meta-parameters {masters}, optimizer {moments}")
        for dtype in times:
            print(f"[bf16] {model} train iteration {dtype}, batch {batch}, "
                  f"{CLI_CROP}x{CLI_CROP} ({card}): median "
                  f"{statistics.median(times[dtype]):.4f} s over "
                  f"{len(times[dtype])} in turns (all "
                  f"{[round(t, 4) for t in times[dtype]]}), loss "
                  f"{out[dtype][0]['loss']:.4f}, peak memory "
                  f"{peak[dtype]:.2f} GiB, launches an iteration {per_iter}")
        paths[f"bf16_{model}_train"] = dict(per_iter)
        del systems, runs, out
        torch.cuda.empty_cache()

    flags, _, steps, warps = WARP_TRAIN["voxelflow"]
    system = SceneAdaptiveInterpolation(get_args(
        flags + BF16 + ["--batch_size", "1", "--second_order"]))
    frames = SyntheticSeptuplet(model="voxelflow", mode="train",
                                size=(CLI_CROP, CLI_CROP))[0][0][None]
    run = bf16_only(sc, wb, lambda: system.run_train_iter(frames, 0))
    run()
    reset_launches(mods)
    times = timed_iters(torch, run, 1, warmup=0)
    got = launch_counts(mods)
    want = {k: train_launches(steps, warps, True).get(k, 0) for k in got}
    check(got == want, f"voxelflow bf16 second order: {got}, want {want}")
    print(f"[bf16] voxelflow second-order train iteration bf16, batch 1 "
          f"({card}): {times[0]:.4f} s, launches {got}")
    paths["bf16_voxelflow_train_second_order"] = got
    return paths


@contextlib.contextmanager
def deterministic(torch, algorithms):
    """torch.backends.cudnn.deterministic, and with ``algorithms``
    torch.use_deterministic_algorithms, both restored after."""
    saved = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(saved[1] or algorithms)
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        torch.use_deterministic_algorithms(saved[1])


def dain_handing(torch, record, dev, system, go):
    """``go()`` with DAIN's PWC flows (``flows``), log depths (the output
    of ``system.model.depthNet``) and projected offsets
    (models/dain/model.py's ``flow_projection``) recorded, on the card
    (``dev`` "cuda"), in ``record`` ({DAIN_HANDED name: [its results in
    call order, on the CPU]}); on the CPU taken from ``record`` in call
    order instead, every one of them."""
    from meta_interpolation_tpu_torch.models.dain import model as dain_mod
    cls = type(system.model)
    real_flows, real_project = cls.flows, dain_mod.flow_projection

    def take(kind, compute):
        if dev == "cuda":
            out = compute()
            record[kind].append(tuple(t.detach().cpu() for t in out)
                                if isinstance(out, tuple)
                                else out.detach().cpu())
            return out
        check(record[kind], f"dain: the CPU run takes more {kind} than the "
                            f"card run gave")
        return record[kind].pop(0)

    def flows(self, x0, x2):
        return take("flows", lambda: real_flows(self, x0, x2))

    def project(*args, **kwargs):
        return take("offsets", lambda: real_project(*args, **kwargs))

    hook = system.model.depthNet.register_forward_hook(
        lambda _mod, _args, out: take("log depth", lambda: out))
    try:
        out = with_attr(cls, "flows", flows, with_attr(
            dain_mod, "flow_projection", project, go))()
    finally:
        hook.remove()
    check(dev == "cuda" or not any(record.values()),
          f"dain: the CPU run left "
          f"{ {k: len(v) for k, v in record.items()} } of the card's "
          f"handed results")
    return out


def bf16_card_vs_cpu_phase(torch, dain_state):
    """A 64x64 clip of each BF16_CARD_VS_CPU preset in bf16 on the card
    against the same clip on the CPU: max|card − CPU| of the prediction
    within twice the CPU's own max|bf16 − float32| plus BF16_FLOOR of the
    largest value, the loss likewise. The card's side runs
    BF16_SPREAD_RUNS times as it runs (cuDNN free to pick algorithms whose
    sums change from run to run; their spread printed), then twice under
    torch.backends.cudnn.deterministic and, for the BF16_BITWISE presets,
    torch.use_deterministic_algorithms (restored after): those two must
    agree bit for bit for the BF16_BITWISE presets (their difference is
    printed for the others), and the first is held to the limit. DAIN
    runs on ``dain_state`` (tamed weights), its CPU bf16 side handed the
    first deterministic card run's DAIN_HANDED tensors (dain_handing)."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    for model in BF16_CARD_VS_CPU:
        flags = BF16_EVAL[model][0]
        clip = SyntheticSeptuplet(model=model, mode="val",
                                  size=SMALL_HW)[0][0][None]
        handed = {kind: [] for kind in DAIN_HANDED}

        def run(dev, dtype, hand=False):
            system = SceneAdaptiveInterpolation(
                get_args(flags + ["--dtype", dtype]), device=dev)
            if model == "dain":
                system.load_net(dain_state)
            go = lambda: system.run_validation_iter(clip)
            losses, preds = (dain_handing(torch, handed, dev, system, go)
                             if hand else go())
            return losses["loss"], preds.cpu()

        free = [run("cuda", "bfloat16") for _ in range(BF16_SPREAD_RUNS)]
        bitwise_runs = model in BF16_BITWISE
        hand = model == "dain"
        with deterministic(torch, bitwise_runs):
            card = run("cuda", "bfloat16", hand)
            again = run("cuda", "bfloat16")
        same = card[0] == again[0] and torch.equal(card[1], again[1])
        runs = (f"loss {card[0]!r} vs {again[0]!r}, max|pred diff| "
                f"{(card[1] - again[1]).abs().max().item():.3e}")
        check(same or not bitwise_runs,
              f"{model} bf16 on the card under deterministic algorithms: "
              f"two runs differ ({runs})")
        calls = {kind: len(v) for kind, v in handed.items()}
        cpu, f32 = run("cpu", "bfloat16", hand), run("cpu", "float32")
        diff = (card[1] - cpu[1]).abs().max().item()
        gap = (cpu[1] - f32[1]).abs().max().item()
        lim = 2 * gap + BF16_FLOOR * cpu[1].abs().max().item()
        loss_lim = 2 * abs(cpu[0] - f32[0]) + BF16_FLOOR * abs(cpu[0])
        losses = [loss for loss, _ in free]
        spread = max((p - free[0][1]).abs().max().item() for _, p in free)
        print(f"[bf16] {model} {SMALL_HW[0]}x{SMALL_HW[1]} clip, bf16 on the "
              f"card as it runs, {BF16_SPREAD_RUNS} runs: losses "
              f"{[f'{x:.6f}' for x in losses]} (spread "
              f"{max(losses) - min(losses):.3e}, against the CPU "
              f"{max(abs(x - cpu[0]) for x in losses):.3e} at most), "
              f"max|pred diff| to the first run {spread:.3e}; two runs "
              + ("under torch.use_deterministic_algorithms: bit for bit "
                 "equal" if bitwise_runs else
                 f"under cudnn.deterministic: {runs} (F.interpolate's "
                 f"backward adds with atomics)"))
        check(diff <= lim and abs(card[0] - cpu[0]) <= loss_lim,
              f"{model} bf16 card vs CPU: pred {diff:.3e} > {lim:.3e} or "
              f"loss {abs(card[0] - cpu[0]):.3e} > {loss_lim:.3e}")
        print(f"[bf16] {model} {SMALL_HW[0]}x{SMALL_HW[1]} clip, bf16 card "
              f"(the first deterministic run) vs CPU"
              + (f" (the CPU handed the card's {', '.join(DAIN_HANDED)}: "
                 f"{calls} calls)" if hand else "")
              + f": max|pred diff| {diff:.3e} "
              f"(limit {lim:.3e}: the CPU's bf16 − float32 {gap:.3e}), loss "
              f"{card[0]:.6f} vs {cpu[0]:.6f} (limit {loss_lim:.3e}; float32 "
              f"{f32[0]:.6f})")


def bf16_serve_phase(torch, mods, card, dain_state):
    """bench.py's serving forwards: each model with every weight in bf16
    at its batch and options on 256x448 frames, frames a second over
    BF16_SERVE_ITERS forwards in turns with the same model in float32
    (float32, bf16, bf16, float32), launches a forward held (bf16: the
    bf16 kernels only). Returns the bf16 launches by path."""
    import copy
    sc, wb, _ = mods
    paths = {}
    for model, (batch, kwargs, fwd_kw, per_fwd) in BF16_SERVE.items():
        gen = torch.Generator().manual_seed(DAIN_SEED)
        net = serve_model(model, gen, kwargs)
        if model == "dain":
            net.load_state_dict(dain_state)
        nets = {"float32": net.cuda().eval(),
                "bfloat16": copy.deepcopy(net).to(torch.bfloat16)}
        gen = torch.Generator().manual_seed(0)
        f0, f1 = (torch.rand(batch, 3, *FULL_HW, generator=gen).cuda()
                  for _ in "01")
        types = {"float32": torch.float32, "bfloat16": torch.bfloat16}

        def serve(dtype):
            def run():
                with torch.no_grad():
                    for _ in range(BF16_SERVE_ITERS):
                        out = nets[dtype](f0.to(types[dtype]),
                                          f1.to(types[dtype]), **fwd_kw)
                return out[0] if isinstance(out, tuple) else out
            return run
        want = {k: v * BF16_SERVE_ITERS for k, v in per_fwd.items()}
        times, peak, out, _ = bf16_turns(
            torch, mods, sc, wb, {d: serve(d) for d in nets}, want,
            f"{model} served batch {batch}")
        for dtype, pred in out.items():
            check(tuple(pred.shape) == (batch, 3) + FULL_HW
                  and pred.dtype == types[dtype]
                  and bool(torch.isfinite(pred).all()),
                  f"{model} served {dtype}: {pred.shape} {pred.dtype}")
        diff = (out["bfloat16"].float() - out["float32"]).abs().max().item()
        fps = {d: [batch * BF16_SERVE_ITERS / t for t in ts]
               for d, ts in times.items()}
        print(f"[bf16] {model} served at batch {batch}, {FULL_HW[0]}x"
              f"{FULL_HW[1]}, {kwargs or fwd_kw or 'no options'} ({card}): "
              f"bf16 {statistics.median(fps['bfloat16']):.2f} frames/s "
              f"(all {[round(x, 2) for x in fps['bfloat16']]}), float32 "
              f"{statistics.median(fps['float32']):.2f} "
              f"(all {[round(x, 2) for x in fps['float32']]}), peak memory "
              f"bf16 {peak['bfloat16']:.2f} GiB, float32 "
              f"{peak['float32']:.2f} GiB, max|bf16 − float32| {diff:.3e}, "
              f"launches a forward {per_fwd}")
        if per_fwd:
            paths[f"bf16_{model}_serve"] = want
        del nets, out
        torch.cuda.empty_cache()
    return paths


def serve_model(model, gen, kwargs):
    """The port's ``model`` built as bench.py serves it."""
    from meta_interpolation_tpu_torch.models import cain, rrin, sepconv
    from meta_interpolation_tpu_torch.models import superslomo, voxelflow
    from meta_interpolation_tpu_torch.models.dain.model import DAIN
    cls = {"rrin": rrin.RRIN, "voxelflow": voxelflow.VoxelFlow,
           "superslomo": superslomo.SuperSloMo, "dain": DAIN,
           "sepconv": sepconv.SepConv, "cain": cain.CAIN}[model]
    return cls(gen, **kwargs)


def bf16_phase(torch, mods, card):
    """--dtype bfloat16 on every preset's main paths and bench.py's
    serving forwards. Returns the bf16 launches by path."""
    dain_state = {k: v.detach().cpu()
                  for k, v in dain_weights(torch).state_dict().items()}
    paths = timed("bf16_eval", bf16_eval_phase, torch, mods, card, dain_state)
    paths.update(timed("bf16_train", bf16_train_phase, torch, mods, card,
                       dain_state))
    paths.update(timed("bf16_serve", bf16_serve_phase, torch, mods, card,
                       dain_state))
    timed("bf16_card_vs_cpu", bf16_card_vs_cpu_phase, torch, dain_state)
    return paths


# the rest of the JAX package: the SSIM and VGG19 losses, --lpips,
# --profile_dir, --remat, the legacy trainers, the native loader and DAIN's
# off-path ops. SepConv at run_sepconv.sh's preset (batch 3, 3 steps,
# Adamax, Meta-SGD) on 256x256 crops; the evaluations at 256x448
VGG_LOSSES = {"vgg22_ssim": "1*L1+0.1*VGG22+1*SSIM", "vggp": "1*VGGP"}
LOSS_TURNS = 2
# LPIPS on the card against the CPU, on the same images
LPIPS_ATOL = 1e-4
REMAT = ["--remat"]
REMAT_REPS = 1
# the legacy scripts' defaults: --batch_size 4, --num_inner_update 1,
# --crop_size 128 (the CLI runs); the steps timed on 256x256 crops
LEGACY_BATCH, LEGACY_STEPS, LEGACY_CROP, LEGACY_REPS = 4, 1, 128, 1
# a legacy step over the batch: n inner steps of the two support pairs,
# one model call (CALLS sepconvs) each, then the query. MAML's query runs
# with grad and takes its backward; Reptile's and the evaluation's run
# under no-grad
LEGACY_LAUNCHES = {
    "maml": {"sepconv_forward": (2 * LEGACY_STEPS + 1) * CALLS,
             "sepconv_grad_kernels": (2 * LEGACY_STEPS + 1) * CALLS},
    "reptile": {"sepconv_forward": (2 * LEGACY_STEPS + 1) * CALLS,
                "sepconv_grad_kernels": 2 * LEGACY_STEPS * CALLS},
    "eval": {"sepconv_forward": (2 * LEGACY_STEPS + 1) * CALLS,
             "sepconv_grad_kernels": 2 * LEGACY_STEPS * CALLS}}
LEGACY_PRESETS = ("sepconv", "voxelflow", "superslomo", "dain")
NATIVE_CLIPS = 6
# DAIN's off-path ops, card vs CPU (plain PyTorch both sides, scatters
# summed in other orders): within this share of the largest value
DAIN_OPS_RTOL = 1e-4


def remat_extra(steps, per_forward, second, training=True):
    """The forward-kernel launches --remat adds to one task: those of each
    recomputed forward. Training recomputes every support pass in its
    backward (second order twice: in the inner gradient and again in the
    outer backward through it) and the query once; evaluation the support
    passes (its query runs under no-grad). Counted on the CPU with
    counting wrappers before the first chip run."""
    support = PAIRS * steps * per_forward
    return ((2 * support if second else support)
            + (per_forward if training else 0))


def group_distance(got, want):
    """{group: ‖got − want‖ / ‖want‖} over the tensors of each group."""
    out = {}
    for g, tree in want.items():
        diff = math.sqrt(sum(float((got[g][k].cpu() - v.cpu()).norm()) ** 2
                             for k, v in tree.items()))
        ref = math.sqrt(sum(float(v.norm()) ** 2 for v in tree.values()))
        out[g] = diff / ref if ref else diff
    return out


def loss_terms_phase(torch, mods, card):
    """SepConv first-order train iterations at the preset under the SSIM
    and VGG19 terms (VGG_LOSSES) in turns with 1*L1: the same K1/K2
    launches as 1*L1 (the VGG features and the SSIM windows are cuDNN
    convolutions), seconds an iteration, peak memory; then each loss's
    outer gradient of a 64x64 clip on the card against the CPU (the loss,
    each group's gradient within OUTER_GRAD_RTOL, the inner steps handed
    over). Returns the launches by path."""
    import numpy as np
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    clips = SyntheticSeptuplet(mode="train", size=(CLI_CROP, CLI_CROP))
    frames = np.stack([clips[i][0] for i in range(TASKS)])
    specs = {"l1": "1*L1", **VGG_LOSSES}
    systems = {name: SceneAdaptiveInterpolation(get_args(
        TRAIN_FLAGS + ["--loss", spec])) for name, spec in specs.items()}
    paths, times, peaks, losses = {}, {n: [] for n in specs}, {}, {}
    want = {"sepconv_forward": K1_PER_TRAIN_ITER,
            "sepconv_grad_kernels": K2_PER_TRAIN_ITER}
    for name, system in systems.items():   # warm-up, launches, peak
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(mods)
        out, _ = system.run_train_iter(frames, 0)
        torch.cuda.synchronize()
        got = launch_counts(mods)
        check({k: got[k] for k in want} == want,
              f"{name} train iteration launched {got}, want {want} (the "
              f"1*L1 path's)")
        check(all(math.isfinite(v) for v in out.values()),
              f"{name} train iteration: {out}")
        peaks[name] = torch.cuda.max_memory_allocated() / 2**30
        losses[name] = out["loss"]
        if name != "l1":
            paths[f"sepconv_{name}_train"] = got
    for _ in range(LOSS_TURNS):
        for name, system in systems.items():
            times[name] += timed_iters(
                torch, lambda: system.run_train_iter(frames, 0), 1, warmup=0)
    base = statistics.median(times["l1"])
    for name, spec in specs.items():
        med = statistics.median(times[name])
        print(f"[rest] sepconv first-order train iteration, --loss {spec}, "
              f"batch {TASKS}, {CLI_CROP}x{CLI_CROP} ({card}): median "
              f"{med:.4f} s over {LOSS_TURNS} in turns with the others (all "
              f"{[round(t, 4) for t in times[name]]}; {med / base:.3f} x "
              f"1*L1's), peak memory {peaks[name]:.2f} GiB, loss "
              f"{losses[name]:.5f}, launches K1 {want['sepconv_forward']} K2 "
              f"{want['sepconv_grad_kernels']} an iteration")
    del systems
    for spec in VGG_LOSSES.values():
        train_card_vs_cpu(torch, TRAIN_FLAGS + ["--loss", spec]
                          + ENGINE_CHECK_STEPS, orders=("first",))
    return paths


def captured(fn):
    """``fn()`` with its standard output captured, then printed → (result,
    text)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    print(buf.getvalue(), end="")
    return out, buf.getvalue()


def lpips_phase(torch, mods, card):
    """--mode val --lpips on SepConv (the CLI's clips at CLI_CROP): the
    ``[val epoch]`` line carries LPIPS, K1/K2 as without it; then LPIPS of
    a 256x448 episode's prediction on the card against the CPU's on the
    same images, within LPIPS_ATOL, and its time on the card. Returns the
    launches."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.main import main as port_main
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    from meta_interpolation_tpu_torch.utils.profiling import eval_lpips
    n_clips = len(SyntheticSeptuplet(mode="val"))
    reset_launches(mods)
    stats, text = captured(lambda: port_main(
        EVAL_FLAGS + ["--lpips", "--dataset", "synthetic", "--crop_size",
                      str(CLI_CROP)]))
    torch.cuda.synchronize()
    launches = launch_counts(mods)
    want = {k: 0 for k in launches}
    want.update(sepconv_forward=K1_PER_CLIP * n_clips,
                sepconv_grad_kernels=K2_PER_CLIP * n_clips)
    check(launches == want, f"--lpips CLI launched {launches}, want {want}")
    line = [ln for ln in text.splitlines() if ln.startswith("[val epoch")]
    check(len(line) == 1 and " LPIPS " in line[0]
          and math.isfinite(stats.get("lpips", math.nan)),
          f"--lpips val line {line}, stats {stats}")
    system = SceneAdaptiveInterpolation(get_args(EVAL_FLAGS))
    clip = SyntheticSeptuplet(mode="val", size=FULL_HW)[0][0][None]
    _, preds = system.run_validation_iter(clip)
    pred = preds.clamp(0, 1)
    tgt = torch.as_tensor(clip[:, QUERY[1]].transpose(0, 3, 1, 2).copy(),
                          device=pred.device).clamp(0, 1)
    on_card = eval_lpips(pred, tgt)
    on_cpu = eval_lpips(pred.cpu(), tgt.cpu())
    check(abs(on_card - on_cpu) <= LPIPS_ATOL,
          f"LPIPS card {on_card} vs CPU {on_cpu}")
    ms = call_ms(torch, lambda: eval_lpips(pred, tgt), reps=5, warmup=1)
    print(f"[rest] sepconv --lpips CLI val: {n_clips} clips, LPIPS "
          f"{stats['lpips']:.4f}, launches {launches}; LPIPS of a "
          f"{FULL_HW[0]}x{FULL_HW[1]} prediction ({card}): card {on_card:.6f}"
          f" vs CPU {on_cpu:.6f} (diff {abs(on_card - on_cpu):.2e}, limit "
          f"{LPIPS_ATOL}), {ms:.3f} ms on the card")
    return {"sepconv_lpips_val": launches}


def profile_dir_phase(torch, mods):
    """--profile_dir on the SepConv CLI val at 64x64: the trace file is
    written and names K1's kernel once for each K1 launch of the run (the
    card's activity was captured). Returns the launches."""
    import shutil
    import tempfile
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.main import main as port_main
    from meta_interpolation_tpu_torch.utils.profiling import TRACE_FILE
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    log_dir = tempfile.mkdtemp(prefix="smoke_profile_", dir=build)
    n_clips = len(SyntheticSeptuplet(mode="val"))
    try:
        reset_launches(mods)
        port_main(EVAL_FLAGS + ["--dataset", "synthetic", "--crop_size",
                                str(SMALL_HW[0]), "--profile_dir", log_dir])
        torch.cuda.synchronize()
        launches = launch_counts(mods)
        path = os.path.join(log_dir, TRACE_FILE)
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(log_dir)
    kernel = SEPCONV_KERNELS["sepconv_forward"]
    k1_events = [e for e in events if e.get("cat") == "kernel"
                 and kernel in e.get("name", "")]
    device = [e for e in events if e.get("cat") == "kernel"]
    check(launches["sepconv_forward"] == K1_PER_CLIP * n_clips
          and len(k1_events) == launches["sepconv_forward"],
          f"--profile_dir trace: {len(k1_events)} {kernel} events, "
          f"launches {launches}")
    print(f"[rest] --profile_dir sepconv CLI val at {SMALL_HW[0]}x"
          f"{SMALL_HW[1]}: trace {size / 2**20:.1f} MiB, {len(events)} "
          f"events, {len(device)} device kernels, {len(k1_events)} named "
          f"{kernel} (K1 launches {launches['sepconv_forward']})")
    return {"sepconv_profiled_val": launches}


def remat_paths(torch, mods, wb, card, name, flags, batch, steps, warps,
                base, frames, clip, run_wrap):
    """One model's --remat measurements: a first-order train iteration at
    ``batch`` and a second-order one at batch 1, each with and without
    --remat in turns (seconds, peak memory, launches: ``base(order)``
    without, plus the recomputed forwards' with), then outer gradients of
    ``clip`` with and without --remat on the card (first order at the
    preset's rule, second at the inner SGD rule): the loss within
    LOSS_RTOL, each group within OUTER_GRAD_RTOL. Returns the --remat
    paths' launches."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation)
    kernel = "sepconv_forward" if warps is None else \
        "warp_sample_bounded_forward"
    per_forward = CALLS if warps is None else warps
    paths = {}
    for order, extra, tasks in (("first", [], batch),
                                ("second", ["--second_order"], 1)):
        systems = {remat: SceneAdaptiveInterpolation(get_args(
            flags + extra + (REMAT if remat else [])
            + (["--batch_size", "1"] if order == "second" else [])))
            for remat in (False, True)}
        want = dict(base(order))
        times = {False: [], True: []}
        peaks, got = {}, {}
        for rep in range(REMAT_REPS + 1):
            for remat, system in systems.items():
                run = run_wrap(lambda: system.run_train_iter(
                    frames[:tasks], 0))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_launches(mods)
                t = timed_iters(torch, run, 1, warmup=0)[0]
                got[remat] = launch_counts(mods)
                peaks[remat] = torch.cuda.max_memory_allocated() / 2**30
                if rep:
                    times[remat].append(t)
        add = tasks * remat_extra(steps, per_forward, order == "second")
        want_remat = {**want, kernel: want[kernel] + add}
        check({k: got[False][k] for k in want} == want
              and {k: got[True][k] for k in want} == want_remat,
              f"{name} {order}-order launches {got}, want {want} and with "
              f"--remat {want_remat}")
        paths[f"{name}_remat_train" + ("" if order == "first"
                                       else "_second_order")] = got[True]
        med = {r: statistics.median(times[r]) for r in times}
        print(f"[rest] {name} {order}-order train iteration, batch {tasks}, "
              f"{CLI_CROP}x{CLI_CROP} ({card}): without --remat "
              f"{med[False]:.4f} s, peak {peaks[False]:.2f} GiB; with "
              f"{med[True]:.4f} s ({med[True] / med[False]:.3f} x), peak "
              f"{peaks[True]:.2f} GiB ({peaks[True] / peaks[False]:.3f} x); "
              f"medians of {REMAT_REPS} in turns after a warm-up; {kernel} "
              f"{want[kernel]} -> {want_remat[kernel]} an iteration")
        del systems
        rule = [] if order == "first" else ["--optimizer", "SGD"]
        out = {}
        for remat in (False, True):
            system = SceneAdaptiveInterpolation(get_args(
                flags + extra + rule + ["--batch_size", "1"]
                + (REMAT if remat else [])))
            loss, _, grads = run_wrap(lambda: system.outer_grads(clip, 0))()
            out[remat] = (float(loss), grads)
            del system
        (l0, g0), (l1, g1) = out[False], out[True]
        ratios = group_distance(g1, g0)
        check(abs(l1 - l0) <= LOSS_RTOL * abs(l0)
              and all(r <= OUTER_GRAD_RTOL for r in ratios.values()),
              f"{name} {order}-order --remat: loss {l1} vs {l0}, gradients "
              f"{ratios}")
        print(f"[rest] {name} {order}-order outer gradient of a "
              f"{SMALL_HW[0]}x{SMALL_HW[1]} clip on the card, --remat vs "
              f"without: loss {l1:.6f} vs {l0:.6f}, |diff|/|ref| "
              + " ".join(f"{g} {r:.3e}" for g, r in ratios.items()
                         if g in ("net", "lrs"))
              + f" (limit {OUTER_GRAD_RTOL})")
    return paths


def remat_phase(torch, mods, sc, wb, card):
    """--remat on SepConv (run_sepconv.sh) and on VoxelFlow with
    --fast_warp_range 8 (run_voxelflow.sh): remat_paths each, with no
    plain sepconv or sampler allowed. Returns the launches by path."""
    import numpy as np
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet

    def plain_called(*_args):
        raise AssertionError("a plain sepconv ran on the card")

    def no_plain_sepconv(fn):
        return with_attr(sc, "sepconv_ref", plain_called, with_attr(
            sc, "grad_kernels_ref", plain_called, fn))

    paths = {}
    clips = SyntheticSeptuplet(mode="train", size=(CLI_CROP, CLI_CROP))
    frames = np.stack([clips[i][0] for i in range(TASKS)])
    clip = SyntheticSeptuplet(mode="train", size=SMALL_HW)[0][0][None]
    paths.update(remat_paths(
        torch, mods, wb, card, "sepconv", TRAIN_FLAGS, TASKS, STEPS, None,
        lambda order: ({"sepconv_forward": K1_PER_TRAIN_ITER,
                        "sepconv_grad_kernels": K2_PER_TRAIN_ITER}
                       if order == "first" else
                       {"sepconv_forward": K1_PER_TASK_SECOND_ORDER,
                        "sepconv_grad_kernels": K2_PER_TASK_SECOND_ORDER}),
        frames, clip, no_plain_sepconv))
    flags, batch, steps, warps = WARP_TRAIN["voxelflow"]
    clips = SyntheticSeptuplet(model="voxelflow", mode="train",
                               size=(CLI_CROP, CLI_CROP))
    frames = np.stack([clips[i][0] for i in range(batch)])
    clip = SyntheticSeptuplet(model="voxelflow", mode="train",
                              size=SMALL_HW)[0][0][None]
    paths.update(remat_paths(
        torch, mods, wb, card, "voxelflow", flags, batch, steps, warps,
        lambda order: {k: v * (batch if order == "first" else 1)
                       for k, v in train_launches(
                           steps, warps, order == "second").items()},
        frames, clip, lambda fn: plain_warp_forbidden(wb, fn)))
    return paths


def legacy_phase(torch, mods, card):
    """The legacy trainers on SepConv (train_sepconv's preset): a MAML
    step, a Reptile step and an evaluation episode at LEGACY_BATCH on
    256x256 crops (seconds, K1/K2 launches held to LEGACY_LAUNCHES); each
    on a 64x64 clip on the card against the CPU (the inner Adamax steps
    handed over: the loss within LOSS_RTOL, MAML's outer gradient and
    Reptile's move within OUTER_GRAD_RTOL in norm, the evaluation's
    prediction within PRED_ATOL); then one epoch of each preset's CLI
    (LEGACY_PRESETS) on the synthetic set at crop LEGACY_CROP. Returns
    the launches by path."""
    import shutil
    import numpy as np
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.legacy import driver, trainers
    from meta_interpolation_tpu_torch.meta.inner_optimizers import (
        InnerOptimizer)
    import importlib
    preset = importlib.import_module(
        "meta_interpolation_tpu_torch.legacy.train_sepconv").PRESET
    paths = {}
    cfg = driver.parse_args(preset, ["--batch_size", str(LEGACY_BATCH)])
    md, model, params, loss_fn, mask, dev = driver.build(preset, cfg)
    opt = driver.make_outer_optimizer(preset.outer_opt, params.values(),
                                      cfg.outer_lr)
    clips = SyntheticSeptuplet(mode="train", size=(CLI_CROP, CLI_CROP))
    frames = driver.to_device_frames(
        np.stack([clips[i][0] for i in range(LEGACY_BATCH)]), dev)
    kw = dict(num_steps=LEGACY_STEPS, inner_rule=preset.inner_rule,
              mask=mask)
    steps = {
        "maml": lambda: trainers.fomaml_step(model, loss_fn, params, opt,
                                             frames, cfg.inner_lr, **kw),
        "reptile": lambda: trainers.reptile_step(
            model, loss_fn, params, frames, cfg.inner_lr, cfg.outer_lr,
            **kw),
        "eval": lambda: trainers.eval_episode(model, loss_fn, params, frames,
                                              cfg.inner_lr, **kw)}
    for algo, step in steps.items():
        step()   # warm-up
        reset_launches(mods)
        times = timed_iters(torch, step, LEGACY_REPS, warmup=0)
        got = launch_counts(mods)
        want = {k: v * LEGACY_REPS for k, v in LEGACY_LAUNCHES[algo].items()}
        check({k: got[k] for k in want} == want,
              f"legacy {algo} launched {got}, want {want}")
        paths[f"legacy_sepconv_{algo}"] = got
        print(f"[rest] legacy sepconv {algo} step, batch {LEGACY_BATCH}, "
              f"{CLI_CROP}x{CLI_CROP}, {LEGACY_STEPS} inner step ({card}): "
              f"median {statistics.median(times):.4f} s over {LEGACY_REPS} "
              f"after a warm-up (all {[round(t, 4) for t in times]}), "
              f"launches K1 {LEGACY_LAUNCHES[algo]['sepconv_forward']} K2 "
              f"{LEGACY_LAUNCHES[algo]['sepconv_grad_kernels']} a step")
    del model, params, opt, frames
    small = SyntheticSeptuplet(mode="train", size=SMALL_HW)[0][0][None]
    for algo in steps:
        out, record = {}, []
        inner = dict.fromkeys(("d2", "n2", "flips", "n"), 0)
        for dev_name in ("cuda", "cpu"):
            c = driver.parse_args(preset, ["--device", dev_name])
            _, model, params, loss_fn, mask, dev = driver.build(preset, c)
            before = {k: v.clone() for k, v in params.items()}
            x = driver.to_device_frames(small, dev)
            kw = dict(num_steps=LEGACY_STEPS, inner_rule=preset.inner_rule,
                      mask=mask)
            taken = {}
            if algo == "maml":
                opt = driver.make_outer_optimizer(preset.outer_opt,
                                                  params.values(), c.outer_lr)
                real_step = opt.step

                def recording_step(real_step=real_step, params=params):
                    taken.update({k: p.grad.detach().cpu()
                                  for k, p in params.items()})
                    return real_step()
                opt.step = recording_step
                fn = lambda: trainers.fomaml_step(model, loss_fn, params, opt,
                                                  x, c.inner_lr, **kw)
            elif algo == "reptile":
                fn = lambda: trainers.reptile_step(
                    model, loss_fn, params, x, c.inner_lr, c.outer_lr, **kw)
            else:
                fn = lambda: trainers.eval_episode(model, loss_fn, params, x,
                                                   c.inner_lr, **kw)
            res = with_attr(InnerOptimizer, "update", handing_inner(
                torch, InnerOptimizer.update, record, dev_name, inner), fn)()
            if algo == "maml":
                moved = taken
            elif algo == "reptile":
                moved = {k: (v - before[k]).cpu() for k, v in res[0].items()}
            else:
                moved = {"pred": res[1].cpu()}
            out[dev_name] = (float(res[1] if algo != "eval" else res[0]),
                             moved)
        check(not record, f"legacy {algo}: the CPU left {len(record)} of the "
                          f"card's inner steps")
        (l_card, m_card), (l_cpu, m_cpu) = out["cuda"], out["cpu"]
        check(abs(l_card - l_cpu) <= LOSS_RTOL * abs(l_cpu),
              f"legacy {algo} loss card {l_card} vs CPU {l_cpu}")
        if algo == "eval":
            diff = float((m_card["pred"] - m_cpu["pred"]).abs().max())
            check(diff <= PRED_ATOL, f"legacy eval prediction card vs CPU "
                                     f"{diff}")
            shown = f"max|pred diff| {diff:.3e} (limit {PRED_ATOL})"
        else:
            ratio = group_distance({"net": m_card}, {"net": m_cpu})["net"]
            check(ratio <= OUTER_GRAD_RTOL, f"legacy {algo} card vs CPU "
                                            f"{ratio}")
            what = "outer gradient" if algo == "maml" else "move θ' − θ"
            shown = f"{what} |diff|/|cpu| {ratio:.3e} (limit " \
                    f"{OUTER_GRAD_RTOL})"
        print(f"[rest] legacy sepconv {algo}, {SMALL_HW[0]}x{SMALL_HW[1]} "
              f"clip, card vs CPU (the CPU stepped with the card's support "
              f"gradients, {inner['flips']} of {inner['n']} elements of the "
              f"other sign): loss {l_card:.6f} vs {l_cpu:.6f}, {shown}")
    ckpt = os.path.join(ROOT, "build", "smoke_legacy_ckpt")
    try:
        for name in LEGACY_PRESETS:
            mod = importlib.import_module(
                f"meta_interpolation_tpu_torch.legacy.train_{name}")
            reset_launches(mods)
            t0 = time.perf_counter()
            _, text = captured(lambda: mod.main([
                "--dataset", "synthetic", "--crop_size", str(LEGACY_CROP),
                "--batch_size", "1", "--val_batch_size", "1",
                "--max_epoch", "1", "--train_iter", "1", "--val_iter", "1",
                "--logfreq", "1", "--exp_name", name,
                "--checkpoint_dir", ckpt]))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = launch_counts(mods)
            psnr = [float(ln.split()[-1]) for ln in text.splitlines()
                    if ln.startswith("val_PSNR:")]
            check(len(psnr) == 1 and math.isfinite(psnr[0]) and
                  os.path.exists(os.path.join(ckpt, name, "checkpoint.pth")),
                  f"legacy {name} CLI: PSNR {psnr}")
            if name == "sepconv":
                want = {k: LEGACY_LAUNCHES["maml"][k]
                        + LEGACY_LAUNCHES["eval"][k]
                        for k in LEGACY_LAUNCHES["maml"]}
                check({k: got[k] for k in want} == want,
                      f"legacy sepconv CLI launched {got}, want {want}")
                paths["legacy_sepconv_cli"] = got
            else:
                # the legacy scripts build the models without a warp
                # bound: the exact sampler and projection, no kernel of ours
                check(not any(got.values()),
                      f"legacy {name} CLI launched {got}")
            print(f"[rest] legacy {name} CLI, one epoch of 1 train and 1 val "
                  f"batch at {LEGACY_CROP}x{LEGACY_CROP}: {dt:.2f} s, val "
                  f"PSNR {psnr[0]:.3f}, launches {got}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return paths


def native_loader_phase(card):
    """The native loader on the card's host: prep.cpp builds with g++ (no
    fallback), and a train batch of NATIVE_CLIPS synthetic 256x448
    septuplets in the Vimeo90K layout through TaskLoader's native path is
    bit for bit the numpy transcription of the C arithmetic on the same raw
    frames and augmentation draws, and within one float32 ulp of the
    numpy path's (x/255 there, x·(1/255) here); both paths timed."""
    import shutil
    import tempfile
    import numpy as np
    from PIL import Image
    from meta_interpolation_tpu_torch.data import loader as loader_lib
    from meta_interpolation_tpu_torch.data import native
    from meta_interpolation_tpu_torch.data.datasets import (
        SyntheticSeptuplet, VimeoSeptuplet)
    t0 = time.perf_counter()
    lib = native.load()
    build_s = time.perf_counter() - t0
    check(lib is not None and native.FALLBACK is None,
          f"the native library did not build: {native.FALLBACK}")
    root = tempfile.mkdtemp(prefix="smoke_vimeo_",
                            dir=os.path.join(ROOT, "build"))
    try:
        seqs = [f"{i:05d}/0001" for i in range(NATIVE_CLIPS)]
        synth = SyntheticSeptuplet(mode="val", size=FULL_HW)
        for i, seq in enumerate(seqs):
            d = os.path.join(root, "sequences", seq)
            os.makedirs(d)
            for t, frame in enumerate(synth[i][0], 1):
                Image.fromarray(np.round(frame * 255).astype(np.uint8)).save(
                    os.path.join(d, f"im{t}.png"))
        for name in ("sep_trainlist.txt", "sep_testlist.txt"):
            with open(os.path.join(root, name), "w") as f:
                f.write("\n".join(seqs))
        calls = []
        real = native.prep_batch

        def counted(*args, **kwargs):
            calls.append(1)
            return real(*args, **kwargs)

        def batch(native_path):
            ds = VimeoSeptuplet(root, model="sepconv", crop_size=CLI_CROP)
            tl = loader_lib.TaskLoader(ds, NATIVE_CLIPS, shuffle=True,
                                       num_workers=4)
            load = native.load if native_path else (lambda: None)
            t0 = time.perf_counter()
            out = with_attr(native, "load", load, with_attr(
                native, "prep_batch", counted, lambda: next(iter(tl))))()
            return out, time.perf_counter() - t0

        (got, got_meta), native_s = batch(True)
        check(len(calls) == 1, f"the loader took the native path "
                               f"{len(calls)} times for one batch")
        (ref, ref_meta), numpy_s = batch(False)
        check(len(calls) == 1 and got_meta == ref_meta,
              "the numpy path called prep_batch, or the metadata differ")
        # the same raw frames and draws, transcribed: (u8·(1/255) − 0)/1
        ds = VimeoSeptuplet(root, model="sepconv", crop_size=CLI_CROP)
        order = list(range(NATIVE_CLIPS))
        np.random.RandomState(0).shuffle(order)
        want = []
        for i in order:
            raw, _ = ds.get_raw(i)
            oy, ox, flip, ch, cw = ds.aug_params(*raw.shape[1:3])
            raw = raw[::-1] if flip else raw
            crop = raw[:, oy:oy + ch, ox:ox + cw].astype(np.float32)
            want.append(crop * np.float32(1.0 / 255.0))
        bitwise = np.array_equal(got, np.stack(want))
        ulp = np.abs(got - ref) <= np.spacing(np.maximum(np.abs(got),
                                                         np.abs(ref)))
        check(bitwise and bool(ulp.all()),
              f"native batch: bitwise the transcription {bitwise}, within "
              f"one ulp of the numpy path {float(ulp.mean())}")
    finally:
        shutil.rmtree(root)
    print(f"[rest] native loader ({card}): g++ build {build_s:.2f} s, a "
          f"batch of {NATIVE_CLIPS} clips of {FULL_HW[0]}x{FULL_HW[1]} PNGs "
          f"cropped {CLI_CROP}x{CLI_CROP}: native {native_s:.3f} s, numpy "
          f"{numpy_s:.3f} s, bit for bit the transcription of prep.cpp, "
          f"{int((got != ref).sum())} of {got.size} values one ulp off the "
          f"numpy path's")


def dain_ops_phase(torch, card):
    """DAIN's off-path ops on CUDA tensors against the CPU, plain PyTorch
    on both (scatters summed in other orders): the adaptive-weight
    interpolation of two 256x448 frames, the flow of 51-tap separable
    kernels and the min-depth projection with hole filling, each within
    DAIN_OPS_RTOL of its largest value, and timed on the card."""
    from meta_interpolation_tpu_torch.ops import adaptive_weight as aw
    from meta_interpolation_tpu_torch.ops import flow_projection as fp
    from meta_interpolation_tpu_torch.ops import sepconv as sc
    gen = torch.Generator().manual_seed(0)
    h, w = FULL_HW
    inputs = {
        "img1": torch.rand(1, 3, h, w, generator=gen),
        "img2": torch.rand(1, 3, h, w, generator=gen),
        "flow1": smooth_flow(torch, 1, h, w, 3.0, 1) + 0.013,
        "flow2": smooth_flow(torch, 1, h, w, 3.0, 2) + 0.017,
        "kv": torch.rand(1, sc.F_TAPS, h, w, generator=gen),
        "kh": torch.rand(1, sc.F_TAPS, h, w, generator=gen),
        "depth": torch.rand(1, h, w, 1, generator=gen) + 0.1}
    on = {"cpu": inputs,
          "cuda": {k: v.cuda() for k, v in inputs.items()}}
    cases = {
        "adaptive_weight_interpolation": lambda x: aw.
        adaptive_weight_interpolation(x["img1"], x["img2"], x["flow1"],
                                      x["flow2"]),
        "separable_conv_flow": lambda x: sc.separable_conv_flow(x["kv"],
                                                                x["kh"]),
        "min_depth_flow_projection": lambda x: fp.min_depth_flow_projection(
            x["flow1"], x["depth"], True)}
    for name, fn in cases.items():
        got, want = fn(on["cuda"]).cpu(), fn(on["cpu"])
        err = float((got - want).abs().max())
        lim = DAIN_OPS_RTOL * float(want.abs().max())
        check(err <= lim, f"{name} card vs CPU: {err:.3e} > {lim:.3e}")
        ms = call_ms(torch, lambda: fn(on["cuda"]), reps=5, warmup=1)
        print(f"[rest] {name} at {h}x{w}, card vs CPU ({card}): max|diff| "
              f"{err:.3e} (limit {lim:.3e}), {ms:.3f} ms on the card")


def rest_phase(torch, mods, sc, wb, card):
    """The phases of the rest of the JAX package. Returns the launches of
    each main path."""
    paths = timed("rest_loss_terms", loss_terms_phase, torch, mods, card)
    paths.update(timed("rest_lpips", lpips_phase, torch, mods, card))
    paths.update(timed("rest_profile_dir", profile_dir_phase, torch, mods))
    paths.update(timed("rest_remat", remat_phase, torch, mods, sc, wb, card))
    paths.update(timed("rest_legacy", legacy_phase, torch, mods, card))
    timed("rest_native_loader", native_loader_phase, card)
    timed("rest_dain_ops", dain_ops_phase, torch, card)
    return paths


# task parallelism (parallel/mesh.py): run_sepconv.sh at batch 4 over 2
# ranks on the one card (--mesh_shape 2, gloo: NCCL refuses two ranks on
# one device), 2 tasks a rank; each rank's loader takes 2 threads
PARALLEL_RANKS, PARALLEL_TASKS = 2, 4
PARALLEL_FLAGS = TRAIN_FLAGS + [
    "--batch_size", str(PARALLEL_TASKS), "--crop_size", str(CLI_CROP),
    "--max_epoch", "1", "--total_iter_per_epoch", "2", "--num_workers", "2"]
# a rank's first-order iteration: K1_PER_CLIP K1 and K2_PER_CLIP + CALLS K2
# a task (28 and 28 for 2 tasks); a validation clip (batch 1, which the
# task axis does not divide) runs whole on each rank
K1_PER_RANK_ITER = PARALLEL_TASKS // PARALLEL_RANKS * K1_PER_CLIP
K2_PER_RANK_ITER = PARALLEL_TASKS // PARALLEL_RANKS * (K2_PER_CLIP + CALLS)
# the ranks against one process: the order of the gradient's sum over tasks
# differs (an all-reduce of the ranks' sums), and on the card the backward
# itself is not reproducible (F.interpolate's backward adds with atomics;
# one process against itself ~1e-5 of the net gradient's norm and ~2.5e-5
# of the rates' on an H100, PERF.md): each group's gradient is held within
# PARALLEL_GRAD_RTOL plus twice the spread of two one-process runs in the
# same call; the forward is reproducible, so the loss to 1e-6
PARALLEL_LOSS_RTOL, PARALLEL_GRAD_RTOL = 1e-6, 1e-5
# the halo exchange and the row-sharded apply on CUDA tensors: a frame of
# FULL_HW rows split in 2 bands, a halo of 32 rows, a two-conv stack
HALO_ROWS, SHARDED_APPLY_RTOL = 32, 1e-5
PARALLEL_TIMEOUT = 600
# the exact row-sharded evaluation on the same two ranks: each clip's
# frames whole on both, the rows of each activation split in 2 bands.
# SepConv (EVAL_FLAGS) and CAIN (CAIN_EVAL_FLAGS) validate one Vimeo-format
# septuplet of FULL_HW through the CLI; SepConv's --mode test (TEST_FLAGS,
# one evaluation step) one clip of SPATIAL_HD; each against one process on
# the card handed the ranks' inner gradients: the prediction within
# TOL_REL of its largest value + TOL_ABS (cain_card_vs_cpu's rule: a
# random-init CAIN predicts ~50 and rounds at that scale), the
# PSNR within PSNR_TOL_DB, the loss SPATIAL_LOSS_RTOL
SPATIAL_FLAGS = ["--mesh_shape", f"1x{PARALLEL_RANKS}", "--spatial_shards",
                 str(PARALLEL_RANKS), "--num_workers", "1"]
SPATIAL_HD = (720, 1280)
SPATIAL_LOSS_RTOL = 1e-5
# the ranks' support gradients (summed over the bands) against one
# process's, in norm: only the order of the sums differs
SPATIAL_GRAD_RTOL = 1e-4
SPATIAL_OP_SHAPE = (1, 8, 64, 96)     # a frame the op checks split in 2
# row-sharded meta-training (--mode train --spatial_shards 2) on the same two
# ranks: one task a rank (two gloo ranks share the card) of a CLI_CROP²
# synthetic clip through System.outer_grads, first order twice (the first
# held, the second timed) and second order once, each against one process
# on the card on the same clip and weights, handed the ranks' support
# gradients (in second order their values, its own derivative): the loss
# within SPATIAL_LOSS_RTOL, each group's outer gradient within
# SPATIAL_GRAD_RTOL of its norm (CAIN's: no farther from the float64
# gradient than twice the one process's). Path → (flags, inner steps, warps
# a forward, orders): SepConv at run_sepconv.sh (Adamax, Meta-SGD, 3 inner
# steps), the warp models at WARP_TRAIN's presets with --fast_warp_range 8
# (RRIN's second order with 1 inner step, as warp_train's), CAIN at
# run_cain.sh's, first order
SPATIAL_TRAIN = {
    "sepconv": (TRAIN_FLAGS, STEPS, 0, ("first", "second")),
    **{model: (WARP_TRAIN[model][0], WARP_TRAIN[model][2],
               WARP_TRAIN[model][3], ("first", "second"))
       for model in WARP_MODELS},
    "cain": (CAIN_TRAIN_FLAGS, 1, 0, ("first",))}
SPATIAL_TRAIN_FLAGS = ["--batch_size", "1", "--crop_size", str(CLI_CROP)]
# the training CLI on the two ranks: VoxelFlow's preset at one task, one
# iteration and the epoch's validation of one clip on bands; rank 0 writes
# the checkpoint
SPATIAL_TRAIN_CLI = WARP_TRAIN["voxelflow"][0] + SPATIAL_TRAIN_FLAGS + [
    "--dataset", "synthetic", "--max_epoch", "1", "--total_iter_per_epoch",
    "1", "--num_workers", "1"]


def adamax_step_bound(torch, lr, d_grad, weight, eps=1e-8):
    """How far apart two first outer Adamax (or Adam) steps may put a
    weight when their gradients differ by ``d_grad``: the step lr·g/(|g| +
    eps) has a slope of at most 1/eps (at g = 0, where a gradient within
    rounding of zero steps either way), so lr·min(2, |Δg|/eps), plus the
    rounding of each side's subtraction (an ulp of the weight) and of the
    step itself."""
    return (lr * torch.clamp(d_grad.double().abs() / eps, max=2.0)
            + 2 * weight.double().abs() * 2.0 ** -23 + 1e-6 * lr)


def halo_checks(torch, dev, mesh):
    """halo_exchange and spatial_sharded_apply on CUDA tensors over the
    mesh's spatial axis: each band padded with its neighbours' rows (and
    its own reflected at the frame's ends) bit for bit, and the frame
    assembled from a two-conv stack's bands against the dense stack on
    its interior rows."""
    from meta_interpolation_tpu_torch.parallel import spatial
    gen = torch.Generator().manual_seed(11)
    h, w = FULL_HW
    x = torch.rand(1, 3, h, w, generator=gen).to(dev)
    band = spatial.shard_rows(mesh, x)
    padded = spatial.halo_exchange(band, HALO_ROWS, mesh.spatial_group)
    rows = h // mesh.spatial
    lo, hi = mesh.spatial_index * rows, (mesh.spatial_index + 1) * rows
    top = (x[:, :, lo - HALO_ROWS:lo] if lo else
           x[:, :, :HALO_ROWS].flip(2))
    bottom = (x[:, :, hi:hi + HALO_ROWS] if hi < h else
              x[:, :, -HALO_ROWS:].flip(2))
    want = torch.cat([top, band, bottom], dim=2)
    check(torch.equal(padded, want),
          f"halo exchange on rank {mesh.rank} is not the neighbours' rows")
    params = {"c1.weight": torch.randn(8, 3, 3, 3, generator=gen) * 0.3,
              "c1.bias": torch.randn(8, generator=gen) * 0.1,
              "c2.weight": torch.randn(3, 8, 3, 3, generator=gen) * 0.3,
              "c2.bias": torch.randn(3, generator=gen) * 0.1}
    params = {k: v.to(dev) for k, v in params.items()}

    def stack(p, f0, f1):
        y = torch.relu(torch.nn.functional.conv2d(
            (f0 + f1) / 2, p["c1.weight"], p["c1.bias"], padding=1))
        return torch.nn.functional.conv2d(y, p["c2.weight"], p["c2.bias"],
                                          padding=1)
    f1 = torch.rand(1, 3, h, w, generator=gen).to(dev)
    out = spatial.gather_rows(mesh, spatial.spatial_sharded_apply(
        stack, mesh, HALO_ROWS)(params, x, f1))
    dense = stack(params, x, f1)
    inner = slice(HALO_ROWS, -HALO_ROWS)
    err = max_err(out[:, :, inner], dense[:, :, inner],
                  "row-sharded conv stack")
    scale = float(dense.abs().max())
    check(err <= SHARDED_APPLY_RTOL * scale,
          f"row-sharded apply: {err:.3e} on interior rows (max {scale:.3e})")
    return {"halo": f"{tuple(padded.shape)} on {padded.device}",
            "apply_err": err, "apply_scale": scale}


def spatial_op_checks(torch, dev, mesh):
    """The row-aware ops on this rank's band of a frame against the same
    op on the whole frame, on CUDA tensors: a zero-padded conv, CAIN's
    reflect-padded and zero-padded ConvNorm, the align_corners upsample and
    the global mean (read by each band's rows), each band's output
    gathered; the values and the gradients of Σ out·g in the frame (the
    bands' halo adjoints) and in the parameters, summed over the ranks.
    Returns the largest error over the checks."""
    from meta_interpolation_tpu_torch.models import cain, layers
    from meta_interpolation_tpu_torch.parallel import spatial

    class Mean(torch.nn.Module):
        def forward(self, x):
            return x * layers.global_avg_pool(x)

    gen = torch.Generator().manual_seed(17)
    n, c, h, w = SPATIAL_OP_SHAPE
    ops = {"conv": layers.xavier_conv(c, c, 3, gen),
           "convnorm_reflect": cain.ConvNorm(c, c, 3, False, gen),
           "convnorm_zero": cain.ConvNorm(c, c, 3, True, gen),
           "upsample": layers.Upsample(2, align_corners=True),
           "mean": Mean()}
    x = torch.randn(SPATIAL_OP_SHAPE, generator=gen).to(dev)
    worst = 0.0
    for name, op in ops.items():
        op = op.to(dev)
        params = list(op.parameters())
        scale = 2 if name == "upsample" else 1
        g = torch.randn(n, c, h * scale, w * scale, generator=gen).to(dev)
        whole = x.clone().requires_grad_()
        want = op(whole)
        want_g = torch.autograd.grad((want * g).sum(), [whole] + params)
        band = x.clone().requires_grad_()
        with spatial.row_shard(mesh) as shard:
            got = spatial.gather_band(op(spatial.band(band)))
        got_g = spatial.all_reduce_grads(torch.autograd.grad(
            (got * g).sum(), [band] + params), shard)
        for i, (a, b) in enumerate(zip((got,) + tuple(got_g),
                                       (want,) + tuple(want_g))):
            worst = max(worst, max_err(a.detach(), b.detach(),
                                       f"row-sharded {name} ({i})"))
    return worst


def write_septuplet(root, hw):
    """A Vimeo90K-format tree at ``root`` (the lists and
    sequences/00001/0001/im1..im7.png) holding one synthetic septuplet of
    ``hw``: the CLI validates it whole."""
    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    from meta_interpolation_tpu_torch.utils.viz import save_image
    seq = os.path.join(root, "sequences", "00001", "0001")
    os.makedirs(seq)
    for name in ("sep_trainlist.txt", "sep_testlist.txt"):
        with open(os.path.join(root, name), "w") as f:
            f.write("00001/0001\n")
    clip = SyntheticSeptuplet(mode="val", size=hw)[0][0]
    for i, frame in enumerate(clip, 1):
        save_image(frame, os.path.join(seq, f"im{i}.png"))


def spatial_launches(k1=0, k2=0, k3=0, k3g=0):
    """A clip's launches of K1, K2, K3 and K3-grad."""
    return dict(zip(KERNELS[:4], (k1, k2, k3, k3g)))


def spatial_paths(work):
    """The row-sharded runs of the parallel phase: path → (CLI flags, the
    System method each clip goes through, the launches a clip of K1, K2,
    K3 and K3-grad). The warp models run their presets with
    --fast_warp_range WARP_R (K3 / K3-grad on each rank's band); RRIN's
    test mode (TEST_FLAGS, one evaluation step) one clip of SPATIAL_HD."""
    val = ["--dataset", "vimeo90k", "--data_root",
           os.path.join(work, "vimeo")]
    # a test run writes its frames beside its inputs: a directory a model
    hd = ["--data_root", os.path.join(work, "hd")]
    hd_rrin = ["--data_root", os.path.join(work, "hd_rrin")]
    return {
        "sepconv_spatial_val": (EVAL_FLAGS + val, "run_validation_iter",
                                spatial_launches(K1_PER_CLIP, K2_PER_CLIP)),
        "cain_spatial_val": (CAIN_EVAL_FLAGS + val, "run_validation_iter",
                             spatial_launches()),
        "sepconv_spatial_test": (
            TEST_FLAGS + TEST_MODELS["sepconv"] + hd, "run_test_iter",
            spatial_launches(K1_PER_TEST_CLIP, K2_PER_TEST_CLIP)),
        **{f"{model}_spatial_val": (flags + val, "run_validation_iter",
                                    spatial_launches(k3=k3, k3g=k3g))
           for model, (flags, k3, k3g) in WARP_MODELS.items()},
        "rrin_spatial_test": (RRIN_FLAGS + TEST_FLAGS + hd_rrin,
                              "run_test_iter",
                              spatial_launches(k3=K3_PER_CLIP,
                                               k3g=K3G_PER_CLIP))}


def spatial_runs(torch, work, mesh, dev):
    """Each row-sharded run through the CLI on this rank, its launch
    counts set to 0 just before and read just after: per clip its
    seconds, launches (and K3 / K3-grad's on their band entries), the K1
    band shapes (the sepconv op's input and kernel maps) and the bounded
    sampler's (image, band grid, row0), and its frames, losses and
    prediction; the rank's peak memory over the run."""
    import pathlib

    import numpy as np
    import torch.distributed as dist
    from meta_interpolation_tpu_torch.main import main as port_main
    from meta_interpolation_tpu_torch.meta.inner_optimizers import (
        InnerOptimizer)
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation as System)
    from meta_interpolation_tpu_torch.ops import sepconv as sc
    from meta_interpolation_tpu_torch.ops import warp as warp_ops
    from meta_interpolation_tpu_torch.ops import warp_bounded as wb
    out = {"ops_err": spatial_op_checks(torch, dev, mesh)}
    mods, bounded = (sc, wb), KERNELS[2:4]

    def band_launches():
        return {k: getattr(wb, k).band_launches for k in bounded}
    for path, (flags, method, _) in spatial_paths(work).items():
        clips, shapes, k3_shapes, inner = [], [], [], []
        real = getattr(System, method)
        real_sepconv = sc.sepconv
        real_bounded = warp_ops.grid_sample_bounded

        def clip(self, frames, *args, **kwargs):
            torch.cuda.synchronize()
            comm.clear()
            before, band_before = launch_counts(mods), band_launches()
            t = time.perf_counter()
            res = real(self, frames, *args, **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            after, band_after = launch_counts(mods), band_launches()
            losses, preds = res if method == "run_validation_iter" else (
                None, res)
            clips.append({"s": dt, "comm": dict(comm), "launches": {
                k: after[k] - before[k] for k in after}, "band_launches": {
                k: band_after[k] - band_before[k] for k in band_after},
                "frames": np.asarray(frames).copy(), "losses": losses,
                "preds": preds.detach().cpu()})
            return res

        def sepconv(inp, kv, kh):
            shapes.append((tuple(inp.shape), tuple(kv.shape)))
            return real_sepconv(inp, kv, kh)

        def grid_sample_bounded(img, grid, *args, row0=0, **kwargs):
            k3_shapes.append((tuple(img.shape), tuple(grid.shape), row0))
            return real_bounded(img, grid, *args, row0=row0, **kwargs)

        # every collective of the run: its count and host seconds (a gloo
        # collective on CUDA tensors returns once its data is back)
        comm = collections.Counter()

        def timed_collective(real):
            def run(*args, **kwargs):
                t = time.perf_counter()
                out = real(*args, **kwargs)
                comm[real.__name__] += 1
                comm["s"] += time.perf_counter() - t
                return out
            return run

        # each inner step's support gradients, summed over the bands, as
        # the update takes them (handing_inner's recording side)
        run = with_attr(System, method, clip, with_attr(
            sc, "sepconv", sepconv, with_attr(
                warp_ops, "grid_sample_bounded", grid_sample_bounded,
                with_attr(InnerOptimizer, "update", handing_inner(
                    torch, InnerOptimizer.update, inner, "cuda", None),
                    with_attr(dist, "all_gather", timed_collective(
                        dist.all_gather), with_attr(
                            dist, "all_reduce", timed_collective(
                                dist.all_reduce), port_main))))))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_launches(mods)
        run(flags + SPATIAL_FLAGS + ["--checkpoint_dir", str(
            pathlib.Path(work) / f"ck_{path}")])
        out[path] = {"clips": clips, "launches": launch_counts(mods),
                     "band_shapes": sorted(set(shapes)),
                     "k3_shapes": sorted(set(k3_shapes)),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "base_gib": base / 2**30,
                     "inner": inner if mesh.rank == 0 else None}
    return out


def spatial_train_flags(model, order):
    """The CLI flags of a SPATIAL_TRAIN path in ``order``, one task."""
    flags, steps, _, _ = SPATIAL_TRAIN[model]
    extra = []
    if order == "second":
        extra = ["--second_order", "--number_of_training_steps_per_iter",
                 str(max(steps, SECOND_ORDER_STEPS))]
    return flags + SPATIAL_TRAIN_FLAGS + extra


def spatial_train_launches(model, order):
    """A task's launches (K1, K2, K3, K3-grad, K3-grad²) on a
    SPATIAL_TRAIN path: one process's, each rank running them on its
    band."""
    _, steps, warps, _ = SPATIAL_TRAIN[model]
    second = order == "second"
    want = dict.fromkeys(KERNELS[:5], 0)
    if model == "sepconv":
        want.update(zip(KERNELS[:2], (
            (K1_PER_TASK_SECOND_ORDER, K2_PER_TASK_SECOND_ORDER) if second
            else (K1_PER_CLIP, K2_PER_CLIP + CALLS))))
    elif warps:
        want.update(train_launches(max(steps, SECOND_ORDER_STEPS) if second
                                   else steps, warps, second))
    return want


def spatial_train_clip(model):
    """The one-task batch of a SPATIAL_TRAIN path: (1, 7, H, W, 3)."""
    import numpy as np

    from meta_interpolation_tpu_torch.data.datasets import SyntheticSeptuplet
    return np.asarray(SyntheticSeptuplet(
        model=model, mode="train", size=(CLI_CROP, CLI_CROP))[0][0])[None]


def spatial_train(torch, work, mesh, dev):
    """Row-sharded meta-training on this rank: each SPATIAL_TRAIN path's
    outer_grads, its launch counts set to 0 just before each iteration
    and read just after (with the band entries' of K3, K3-grad and
    K3-grad²), its seconds and peak memory, the first iteration's loss,
    outer gradient and (rank 0) support gradients; then the training CLI
    (SPATIAL_TRAIN_CLI) with its checkpoint writes counted."""
    import pathlib

    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.core import checkpoint as ckpt_lib
    from meta_interpolation_tpu_torch.main import main as port_main
    from meta_interpolation_tpu_torch.meta.inner_optimizers import (
        InnerOptimizer)
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation as System)
    from meta_interpolation_tpu_torch.ops import sepconv as sc
    from meta_interpolation_tpu_torch.ops import warp_bounded as wb
    mods, out = (sc, wb), {}
    for model, (_, _, _, orders) in SPATIAL_TRAIN.items():
        frames = spatial_train_clip(model)
        for order in orders:
            system = System(get_args(spatial_train_flags(model, order)
                                     + SPATIAL_FLAGS), device=dev, mesh=mesh)
            runs = []
            for i in range(2 if order == "first" else 1):
                inner = []
                run = with_attr(InnerOptimizer, "update", handing_inner(
                    torch, InnerOptimizer.update, inner, "cuda", None),
                    lambda: system.outer_grads(frames, 0))
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                reset_launches(mods)
                t = time.perf_counter()
                loss, aux, grads = run()
                torch.cuda.synchronize()
                runs.append({
                    "s": time.perf_counter() - t, "loss": float(loss),
                    "launches": launch_counts(mods),
                    "band": {k: getattr(wb, k).band_launches
                             for k in KERNELS[2:5]},
                    "peak_gib": (torch.cuda.max_memory_allocated()
                                 - base) / 2**30,
                    "finite": bool(torch.isfinite(aux["preds"]).all())})
                if i == 0:
                    runs[0]["grads"] = {
                        g: {k: v.detach().cpu() for k, v in t.items()}
                        for g, t in grads.items() if g in ("net", "lrs")}
                    runs[0]["inner"] = inner if mesh.rank == 0 else None
                del loss, aux, grads
            out[f"{model}_{order}"] = runs
            del system
    saves = []
    real_save = ckpt_lib.save_checkpoint

    def save(state, directory, *args, **kwargs):
        saves.append(directory)
        return real_save(state, directory, *args, **kwargs)
    reset_launches(mods)
    t = time.perf_counter()
    ckpt = pathlib.Path(work) / "ck_spatial_train"
    stats = with_attr(ckpt_lib, "save_checkpoint", save, port_main)(
        SPATIAL_TRAIN_CLI + SPATIAL_FLAGS + ["--checkpoint_dir", str(ckpt)])
    out["cli"] = {"s": time.perf_counter() - t, "stats": stats,
                  "saves": saves, "launches": launch_counts(mods)}
    return out


def parallel_rank(rank, work):
    """One rank of the parallel phase: both ranks build K1/K2 at once into
    one fresh directory (K3's library, built once already, copied there
    by the parent), run the halo checks, then the training CLI on
    the 2-rank mesh with each train iteration's launches, seconds and
    (rank 0) its batch, gradient and weights recorded; the results go to
    ``work``."""
    import pathlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from meta_interpolation_tpu_torch.main import main as port_main
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation as System)
    from meta_interpolation_tpu_torch.ops import _build
    from meta_interpolation_tpu_torch.ops import sepconv as sc
    from meta_interpolation_tpu_torch.parallel import mesh as mesh_lib
    work = pathlib.Path(work)
    _build.BUILD_DIR = work / "kernels"
    # every task computed as one process computes it (cuDNN's algorithms
    # fixed): the ranks and that process then differ only in the order of
    # the gradient's sum over tasks
    torch.backends.cudnn.deterministic = True
    dev = mesh_lib.init_distributed("cuda")
    out = {"backend": dist.get_backend(), "device": str(dev)}
    dist.barrier()
    t0 = time.perf_counter()
    out["build"] = {k: v["seconds"] for k, v in _build.build(
        ["sepconv", "warp"]).items()}
    out["build_s"] = time.perf_counter() - t0
    out.update(halo_checks(torch, dev, mesh_lib.make_mesh(
        f"1x{PARALLEL_RANKS}")))

    first, trains, vals = {}, [], []
    real_outer = System.outer_grads

    def cpu(tree):
        return {g: {k: v.detach().cpu().clone() for k, v in t.items()}
                for g, t in tree.items() if g in ("net", "lrs")}

    def outer_grads(self, frames, *args, **kwargs):
        if not first:
            first["frames"] = np.asarray(frames).copy()
            first["before"] = cpu(self.meta_params)
        loss, aux, grads = real_outer(self, frames, *args, **kwargs)
        if "grads" not in first:
            first["loss"], first["grads"] = float(loss), cpu(grads)
        return loss, aux, grads

    def counted(name, log):
        real = getattr(System, name)

        def wrapped(self, frames, *args, **kwargs):
            torch.cuda.synchronize()
            before = launch_counts((sc,))
            t = time.perf_counter()
            res = real(self, frames, *args, **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            after = launch_counts((sc,))
            log.append((dt, {k: after[k] - before[k] for k in after},
                        res[0]))
            if name == "run_train_iter" and "after" not in first:
                first["after"] = cpu(self.meta_params)
            return res
        return wrapped

    run = with_attr(System, "outer_grads", outer_grads, with_attr(
        System, "run_train_iter", counted("run_train_iter", trains),
        with_attr(System, "run_validation_iter",
                  counted("run_validation_iter", vals), port_main)))
    torch.cuda.reset_peak_memory_stats()
    reset_launches((sc,))
    stats = run(PARALLEL_FLAGS + ["--mesh_shape", str(PARALLEL_RANKS),
                                  "--checkpoint_dir", str(work / "ck")])
    out["launches"] = launch_counts((sc,))
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out.update(trains=trains, vals=vals, stats=stats)
    t0 = time.perf_counter()
    out["spatial"] = spatial_runs(torch, str(work), mesh_lib.make_mesh(
        f"1x{PARALLEL_RANKS}"), dev)
    out["spatial_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["spatial_train"] = spatial_train(torch, str(work), mesh_lib.make_mesh(
        f"1x{PARALLEL_RANKS}"), dev)
    out["spatial_train_s"] = time.perf_counter() - t0
    if rank == 0:
        torch.save(first, work / "first.pt")
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()


def nccl_rank(rank, work):
    """One rank alone with its card: init_distributed takes NCCL, and the
    collectives the parallel module uses run through it."""
    import pathlib

    import torch
    import torch.distributed as dist
    from meta_interpolation_tpu_torch.parallel import mesh as mesh_lib
    from meta_interpolation_tpu_torch.parallel import spatial
    dev = mesh_lib.init_distributed("cuda")
    backend = dist.get_backend()
    x = torch.arange(12.0, device=dev).reshape(1, 1, 4, 3)
    y = x.clone()
    dist.all_reduce(y)
    parts = [torch.empty_like(x)]
    dist.all_gather(parts, x)
    dist.broadcast(y, src=0)
    padded = spatial.halo_exchange(x, 2, None)
    ok = (torch.equal(y, x) and torch.equal(parts[0], x) and torch.equal(
        padded, torch.cat([x[:, :, :2].flip(2), x, x[:, :, -2:].flip(2)],
                          dim=2)))
    # the row bands' collectives and their adjoints over NCCL, one band:
    # the halo rows are zeros and take no cotangent, the sum and the
    # gather are identities
    shard = spatial.RowShard(0, 1, None)
    xr = x.clone().requires_grad_()
    halo = spatial.halo_rows(xr, 2, shard)
    w = torch.arange(halo.numel(), device=dev, dtype=x.dtype).reshape(
        halo.shape)
    total = spatial.all_reduce_sum(xr, shard)
    gathered = spatial.gather_band(xr, shard)
    grad, = torch.autograd.grad((halo * w).sum() + (total * x).sum()
                                + (gathered * 2).sum(), [xr])
    ok = ok and (torch.equal(halo[:, :, 2:-2], x)
                 and not halo[:, :, :2].any() and not halo[:, :, -2:].any()
                 and torch.equal(total, x) and torch.equal(gathered, x)
                 and torch.equal(grad, w[:, :, 2:-2] + x + 2))
    torch.save({"backend": backend, "device": str(dev), "ok": ok},
               pathlib.Path(work) / "nccl.pt")
    dist.destroy_process_group()


def grads_rel(got, want):
    """|got − want| / |want| over a dict of tensors (float64)."""
    d2 = sum(float((got[k].double() - want[k].double()).norm()) ** 2
             for k in want)
    return (d2 / sum(float(v.double().norm()) ** 2
                     for v in want.values())) ** 0.5


def support_grads64(torch, system, frames):
    """The first inner step's support gradient of an evaluation episode in
    float64 on the card (``system`` at its initial weights, task 0 of
    ``frames``): the exact gradient the float32 ones round."""
    from meta_interpolation_tpu_torch.meta.episode import TaskState
    builder = system.builder
    spec = system._spec("train", system.cfg.num_eval_steps, use_msl=True)
    net = system.meta_params["net"]
    live = builder._live(net)
    src = {k: v.double().requires_grad_(k in live) for k, v in net.items()}
    loss = builder._support_loss(src, system._frames(frames)[0].double(),
                                 spec, 0, TaskState())
    grads = torch.autograd.grad(loss, [src[k] for k in live])
    return {k: g.detach().cpu() for k, g in zip(live, grads)}


def spatial_against_one(torch, ranks, work, card):
    """Each row-sharded run's first clip against one process on the card
    on the same frames and weights (the same seed; cuDNN deterministic,
    as in the ranks), on its own and handed the ranks' support gradients:
    the support gradients within SPATIAL_GRAD_RTOL (CAIN's: no farther
    from the float64 gradient than twice the one process's), and the
    handed run's
    prediction, PSNR and loss within their limits; the launches a clip
    (K3 / K3-grad's all on their band entries) and the band shapes;
    seconds a clip and peak memory beside the ranks'. Returns each rank's
    launches on each path."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.meta.inner_optimizers import (
        InnerOptimizer)
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation as System)
    from meta_interpolation_tpu_torch.models import registry
    from meta_interpolation_tpu_torch.models.sepconv import SepConv
    launches = {}
    bounded = KERNELS[2:4]
    for path, (flags, method, want) in spatial_paths(work).items():
        model = path.split("_")[0]
        runs = [rank["spatial"][path] for rank in ranks]
        first = runs[0]["clips"][0]
        for r, run in enumerate(runs):
            check(len(run["clips"]) == 1, f"{path} rank {r}: "
                  f"{len(run['clips'])} clips, want 1")
            got = {k: run["clips"][0]["launches"][k] for k in want}
            check(got == want, f"{path} rank {r}: a clip launched {got}, "
                  f"want {want}")
            band = run["clips"][0]["band_launches"]
            check(band == {k: want[k] for k in bounded},
                  f"{path} rank {r}: K3 / K3-grad launched {band} times on "
                  f"their band entries, want all of {want}")
            check(torch.equal(run["clips"][0]["preds"], first["preds"]),
                  f"{path} rank {r}: its prediction differs from rank 0's")
            launches[f"{path}_rank{r}"] = run["launches"]
            if want[bounded[0]]:
                # every bounded sample of the whole padded frame at this
                # rank's band of its rows
                grid = registry.get(model).build.grid_rows(
                    first["frames"].shape[2])
                rows = grid // PARALLEL_RANKS
                check(run["k3_shapes"] and all(
                    img[2] == grid and g[1] == rows and row0 == r * rows
                    for img, g, row0 in run["k3_shapes"]),
                    f"{path} rank {r}: K3 (image, grid, row0) "
                    f"{run['k3_shapes']}, want {rows} of the {grid} padded "
                    f"rows from row {r * rows}")
        shapes = runs[0]["band_shapes"]
        if want["sepconv_forward"]:
            grid = SepConv.grid_rows(first["frames"].shape[2])
            check(all(kv[2] == grid // PARALLEL_RANKS for _, kv in shapes),
                  f"{path}: K1 bands {shapes}, want {grid // PARALLEL_RANKS}"
                  f" of the {grid} padded rows")
        # one process on its own, then handed the ranks' summed support
        # gradients at each inner step (handing_inner): Adam's and Adamax's
        # first step is lr·sign(g) wherever |g| >> 1e-8, so an element whose
        # gradient is within rounding of 0 steps either way (ROADMAP Queue
        # 3); handed, both take the same steps, and the prediction, PSNR and
        # loss are held to their limits
        # one system for both runs (an evaluation episode adapts copies);
        # the one process's peak memory counts its weights, as a rank's
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        system = System(get_args(flags))
        runs_one, own_grads = {}, []
        for how in ("own", "handed"):
            record = list(runs[0]["inner"])
            dist = collections.Counter()
            update = (handing_inner(torch, InnerOptimizer.update, own_grads,
                                    "cuda", None) if how == "own" else
                      handing_inner(torch, InnerOptimizer.update, record,
                                    "cpu", dist))
            with deterministic(torch, False):
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = with_attr(InnerOptimizer, "update", update, getattr(
                    system, method))(first["frames"])
                torch.cuda.synchronize()
                one_s = time.perf_counter() - t
            losses, preds = (res if first["losses"] is not None
                             else (None, res))
            runs_one[how] = {
                "s": one_s, "losses": losses, "preds": preds.detach().cpu(),
                "err": float((first["preds"] - preds.cpu()).abs().max()),
                "peak": (torch.cuda.max_memory_allocated() - base) / 2**30,
                "dist": dist}
            del res, preds
            check(how == "own" or not record, f"{path}: the ranks took more "
                  f"inner steps than the one process")
        own, handed = runs_one["own"], runs_one["handed"]
        preds, dist = handed["preds"], handed["dist"]
        scale = float(preds.abs().max())
        check(handed["err"] <= TOL_REL * scale + TOL_ABS,
              f"{path}: the ranks' prediction {handed['err']:.3e} from one "
              f"process's handed their support gradients, over {TOL_REL:.0e}"
              f" x {scale:.3e} + {TOL_ABS:.0e} (on its own {own['err']:.3e})")
        grad_rel = (dist["d2"] / dist["n2"]) ** 0.5 if dist["n2"] else 0.0
        line = (f"[spatial] {path}: 2 ranks of {tuple(first['frames'].shape)}"
                f" in 2 row bands vs one process on the card ({card}): "
                f"support gradients {grad_rel:.3e} of their norm apart, "
                f"{dist['flips']} of {dist['n']} elements of the other sign;")
        if path.startswith("cain"):
            # a random-init CAIN's float32 gradient is ~2e-4 of its norm
            # from the exact one (float64, on the CPU): held against the
            # float64 gradient, the ranks' no farther than twice the one
            # process's
            exact = support_grads64(torch, system, first["frames"])
            ranks_d = grads_rel(runs[0]["inner"][0], exact)
            own_d = grads_rel(own_grads[0], exact)
            check(ranks_d <= 2 * own_d + SPATIAL_GRAD_RTOL * 1e-2,
                  f"{path}: the ranks' support gradient {ranks_d:.3e} of its "
                  f"norm from float64's, the one process's {own_d:.3e}")
            line += (f" from the float64 gradient: ranks {ranks_d:.3e}, one "
                     f"process {own_d:.3e};")
        else:
            check(grad_rel <= SPATIAL_GRAD_RTOL,
                  f"{path}: the ranks' support gradients {grad_rel:.3e} of "
                  f"their norm from one process's")
        line += (f" prediction {handed['err']:.3e} from the one process handed"
                 f" the ranks' gradients (limit {TOL_REL:.0e} x max |pred| "
                 f"{scale:.3e} + {TOL_ABS:.0e}), {own['err']:.3e} from it on "
                 f"its own")
        if first["losses"] is not None:
            got_l, losses = first["losses"], handed["losses"]
            check(abs(got_l["psnr"] - losses["psnr"]) <= PSNR_TOL_DB,
                  f"{path}: PSNR {got_l['psnr']!r} vs {losses['psnr']!r}")
            check(abs(got_l["loss"] - losses["loss"])
                  <= SPATIAL_LOSS_RTOL * abs(losses["loss"]),
                  f"{path}: loss {got_l['loss']!r} vs {losses['loss']!r}")
            line += (f"; PSNR {got_l['psnr']!r} vs {losses['psnr']!r} handed"
                     f", {own['losses']['psnr']!r} on its own; loss "
                     f"{got_l['loss']!r} vs {losses['loss']!r} handed, "
                     f"{own['losses']['loss']!r} on its own")
        one_s, one_peak = own["s"], own["peak"]
        del system
        print(line)
        ran = [k for k in want if want[k]] or list(want)[:2]
        short = {"sepconv_forward": "K1", "sepconv_grad_kernels": "K2",
                 bounded[0]: "K3", bounded[1]: "K3-grad"}
        shape_txt = (f"K1 (input, maps) shapes {shapes}" if
                     want["sepconv_forward"] else
                     f"K3 (image, band grid, row0) a rank "
                     f"{[run['k3_shapes'] for run in runs]}"
                     if want[bounded[0]] else "no kernel")
        print(f"[spatial] {path}: "
              + "/".join(short[k] for k in ran) + " a clip a rank "
              + "/".join(str([run["clips"][0]["launches"][k] for run in runs])
                         for k in ran)
              + f" (want {'/'.join(str(want[k]) for k in ran)}; on band "
              f"entries {[run['clips'][0]['band_launches'] for run in runs]})"
              f"; {shape_txt}; "
              f"s/clip ranks {[round(run['clips'][0]['s'], 4) for run in runs]}"
              f" (2 ranks share the card; collectives a clip "
              f"{ {k: v for k, v in first['comm'].items() if k != 's'} }, "
              f"{first['comm'].get('s', 0.0):.4f} s of rank 0's host in "
              f"them), one process {one_s:.4f}; peak "
              f"memory a rank {[round(run['peak_gib'], 3) for run in runs]} "
              f"GiB (its whole CLI run; "
              f"{[round(run['base_gib'], 3) for run in runs]} held before "
              f"it), one process {one_peak:.3f} GiB (its weights and the "
              f"clip) ({card})")
    return launches


def to_float64(torch, system):
    """``system`` recast to float64 in place (its model, meta-parameters,
    the Super loss's VGG16 and the frames it takes): the exact run that
    float32 ones round. Returns it."""
    import numpy as np
    system.model.double()
    system.meta_params = {g: {k: v.double() for k, v in tree.items()}
                          for g, tree in system.meta_params.items()}
    vgg = getattr(system.loss_fn, "vgg16_params", None)
    if vgg is not None:
        system.loss_fn.vgg16_params = {
            name: {k: t.double() for k, t in layer.items()}
            for name, layer in vgg.items()}
    system._frames = lambda frames: torch.from_numpy(np.ascontiguousarray(
        np.asarray(frames, np.float64).transpose(0, 1, 4, 2, 3))).to(
            system.device)
    return system


def spatial_train_against_one(torch, ranks, card):
    """Each SPATIAL_TRAIN path's ranks against one process on the card:
    the launches a rank an iteration (one process's, K3, K3-grad and
    K3-grad² all on their band entries) and the same loss on both ranks;
    the one process on the same clip and weights handed the ranks' support
    gradients (in second order their values, its own derivative): its
    loss within SPATIAL_LOSS_RTOL and each group's outer gradient within
    SPATIAL_GRAD_RTOL of its norm, CAIN's against float64's (the ranks'
    no farther than twice the one process's); seconds an iteration and
    peak memory a rank beside the one process's. Then the training CLI:
    one checkpoint written, by rank 0. Returns each rank's launches on
    each path that runs a kernel of ours."""
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.meta.inner_optimizers import (
        InnerOptimizer)
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation as System)

    def cpu(tree):
        return {g: {k: v.detach().cpu() for k, v in t.items()}
                for g, t in tree.items() if g in ("net", "lrs")}

    def group_rel(a, b):
        out = {}
        for g in b:
            d = sum(float((a[g][k].double() - v.double()).norm()) ** 2
                    for k, v in b[g].items()) ** 0.5
            n = sum(float(v.double().norm()) ** 2 for v in b[g].values())
            out[g] = d / n ** 0.5 if n else d
        return out

    launches = {}
    for model, (_, _, _, orders) in SPATIAL_TRAIN.items():
        frames = spatial_train_clip(model)
        for order in orders:
            path = f"{model}_{order}"
            runs = [rank["spatial_train"][path] for rank in ranks]
            want = spatial_train_launches(model, order)
            for r, rank_runs in enumerate(runs):
                for i, run in enumerate(rank_runs):
                    got = {k: run["launches"][k] for k in want}
                    check(got == want, f"{path} rank {r} iteration {i}: "
                                       f"launched {got}, want {want}")
                    check(run["band"] == {k: want[k] for k in KERNELS[2:5]},
                          f"{path} rank {r}: K3 / K3-grad / K3-grad² "
                          f"launched {run['band']} times on their band "
                          f"entries, want all of them")
                    check(run["finite"], f"{path} rank {r}: a prediction "
                                         f"is not finite")
                check(rank_runs[0]["loss"] == runs[0][0]["loss"],
                      f"{path} rank {r}: loss {rank_runs[0]['loss']!r}, rank "
                      f"0's {runs[0][0]['loss']!r}")
                if model != "cain":
                    launches[f"{model}_spatial_train_{order}_rank{r}"] = (
                        rank_runs[0]["launches"])
            first = runs[0][0]
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            system = System(get_args(spatial_train_flags(model, order)))
            record, dist = list(first["inner"]), collections.Counter()
            keep = order == "second"
            run = with_attr(InnerOptimizer, "update", handing_inner(
                torch, InnerOptimizer.update, record, "cpu", dist, keep),
                lambda: system.outer_grads(frames, 0))
            with deterministic(torch, False):
                torch.cuda.synchronize()
                t = time.perf_counter()
                loss, _, grads = run()
                torch.cuda.synchronize()
            one_s = time.perf_counter() - t
            one_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
            loss, grads = float(loss), cpu(grads)
            check(not record, f"{path}: the ranks took more inner steps than "
                              f"the one process")
            check(abs(first["loss"] - loss) <= SPATIAL_LOSS_RTOL * abs(loss),
                  f"{path}: the ranks' loss {first['loss']!r}, one process "
                  f"{loss!r}")
            rel = group_rel(first["grads"], grads)
            inner_rel = ((dist["d2"] / dist["n2"]) ** 0.5 if dist["n2"]
                         else 0.0)
            line = (f"[spatial] {path} training: 2 ranks of 1x{CLI_CROP}x"
                    f"{CLI_CROP} in 2 row bands vs one process on the card "
                    f"({card}) handed their support gradients: loss "
                    f"{first['loss']!r} vs {loss!r}; outer gradient "
                    + ", ".join(f"{g} {v:.3e}" for g, v in rel.items())
                    + f" of its norm apart; support gradients "
                    f"{inner_rel:.3e} of their norm, {dist['flips']} of "
                    f"{dist['n']} elements of the other sign")
            if model == "cain":
                # a random-init CAIN's float32 gradient carries ~2e-4 of its
                # norm of rounding: held against float64, handed the same
                # support gradients
                record = list(first["inner"])
                exact = cpu(with_attr(
                    InnerOptimizer, "update", handing_inner(
                        torch, InnerOptimizer.update, record, "cpu",
                        collections.Counter(), keep),
                    lambda: to_float64(torch, system).outer_grads(
                        frames, 0))()[2])
                ranks_d = group_rel(first["grads"], exact)
                own_d = group_rel(grads, exact)
                for g in exact:
                    check(ranks_d[g] <= 2 * own_d[g] + SPATIAL_GRAD_RTOL * 1e-2,
                          f"{path}: the ranks' {g} gradient {ranks_d[g]:.3e} "
                          f"of its norm from float64's, the one process's "
                          f"{own_d[g]:.3e}")
                line += ("; from the float64 gradient: ranks "
                         + ", ".join(f"{g} {v:.3e}" for g, v in ranks_d.items())
                         + ", one process "
                         + ", ".join(f"{g} {v:.3e}" for g, v in own_d.items()))
            else:
                for g, v in rel.items():
                    check(v <= SPATIAL_GRAD_RTOL,
                          f"{path}: the ranks' {g} gradient {v:.3e} of its "
                          f"norm from one process's")
                check(inner_rel <= SPATIAL_GRAD_RTOL,
                      f"{path}: the ranks' support gradients {inner_rel:.3e} "
                      f"of their norm from one process's")
            del system, grads
            print(line)
            print(f"[spatial] {path} training: a task's launches a rank "
                  f"{ {k: v for k, v in want.items() if v} } (one process's; "
                  f"on band entries {runs[0][0]['band']}); s/iteration ranks "
                  f"{[round(rank_runs[-1]['s'], 4) for rank_runs in runs]} "
                  f"({'second' if len(runs[0]) > 1 else 'only'} iteration; 2 "
                  f"ranks share the card), one process {one_s:.4f}; peak "
                  f"memory a rank "
                  f"{[round(rank_runs[-1]['peak_gib'], 3) for rank_runs in runs]}"
                  f" GiB, one process {one_peak:.3f} GiB over what each held "
                  f"before ({card})")
    for r, rank in enumerate(ranks):
        cli = rank["spatial_train"]["cli"]
        check(len(cli["saves"]) == (1 if r == 0 else 0),
              f"training CLI rank {r}: wrote {len(cli['saves'])} checkpoints")
        check(cli["stats"] == ranks[0]["spatial_train"]["cli"]["stats"],
              f"training CLI rank {r}: {cli['stats']}, rank 0's "
              f"{ranks[0]['spatial_train']['cli']['stats']}")
        check(all(cli["launches"][k] > 0 for k in KERNELS[2:4]),
              f"training CLI rank {r}: launches {cli['launches']}")
    cli = ranks[0]["spatial_train"]["cli"]
    print(f"[spatial] training CLI (VoxelFlow, 1 iteration, the epoch's "
          f"validation on bands) on 2 ranks: {cli['stats']}, the checkpoint "
          f"written once (rank 0: {cli['saves']}), K3 / K3-grad launches a "
          f"rank {[r['spatial_train']['cli']['launches'][KERNELS[2]] for r in ranks]}"
          f" / {[r['spatial_train']['cli']['launches'][KERNELS[3]] for r in ranks]}"
          f", {cli['s']:.1f} s")
    return launches


def parallel_phase(torch, mods, card):
    """run_sepconv.sh at batch 4 on 2 ranks of the one card over gloo
    (--mesh_shape 2), through the CLI: a warm-up and a timed train
    iteration of 2 tasks a rank, then the epoch's validation; the first
    iteration held against one process on the same batch and weights on
    the card (the loss, each group's gradient before the step against the
    card's own spread, the weights after it by adamax_step_bound); K1 and
    K2 launches a rank;
    the halo exchange and the row-sharded apply on CUDA tensors; and,
    beside the two, one rank alone over NCCL. Returns each rank's launches
    over its run."""
    import shutil
    import tempfile
    from meta_interpolation_tpu_torch.config import get_args
    from meta_interpolation_tpu_torch.meta.system import (
        SceneAdaptiveInterpolation as System)
    from meta_interpolation_tpu_torch.parallel.launch import spawn
    torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="smoke_parallel_",
                            dir=os.path.join(ROOT, "build"))
    try:
        write_septuplet(os.path.join(work, "vimeo"), FULL_HW)
        for name in ("hd", "hd_rrin"):
            write_frames(os.path.join(work, name), SPATIAL_HD, 4)
        # the warp kernels as built at the start: the ranks reuse them
        from meta_interpolation_tpu_torch.ops import _build
        os.makedirs(os.path.join(work, "kernels"))
        shutil.copy(_build.library_path("warp"),
                    os.path.join(work, "kernels"))
        # the NCCL rank beside the two gloo ranks, in a thread of its own
        nccl_failed = []

        def run_nccl():
            t = time.perf_counter()
            try:
                spawn(nccl_rank, 1, args=(work,), timeout=PARALLEL_TIMEOUT)
            except BaseException as e:  # re-raised after the gloo ranks
                nccl_failed.append(e)
            nccl_failed.append(time.perf_counter() - t)

        nccl_thread = threading.Thread(target=run_nccl)
        t0 = time.perf_counter()
        nccl_thread.start()
        spawn(parallel_rank, PARALLEL_RANKS, args=(work,),
              timeout=PARALLEL_TIMEOUT)
        ranks_s = time.perf_counter() - t0
        nccl_thread.join()
        if isinstance(nccl_failed[0], BaseException):
            raise nccl_failed[0]
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False)
                 for r in range(PARALLEL_RANKS)]
        first = torch.load(os.path.join(work, "first.pt"),
                           weights_only=False)
        want_iter = {"sepconv_forward": K1_PER_RANK_ITER,
                     "sepconv_grad_kernels": K2_PER_RANK_ITER}
        want_clip = {"sepconv_forward": K1_PER_CLIP,
                     "sepconv_grad_kernels": K2_PER_CLIP}
        for r, rank in enumerate(ranks):
            check(rank["backend"] == "gloo" and rank["device"] == "cuda:0",
                  f"rank {r}: {rank['backend']} on {rank['device']}")
            check(len(rank["trains"]) == 2 and len(rank["vals"]) == 2,
                  f"rank {r}: {len(rank['trains'])} train and "
                  f"{len(rank['vals'])} validation iterations")
            for _, got, _ in rank["trains"]:
                check({k: got[k] for k in want_iter} == want_iter,
                      f"rank {r}: a train iteration launched {got}, want "
                      f"{want_iter}")
            for _, got, _ in rank["vals"]:
                check({k: got[k] for k in want_clip} == want_clip,
                      f"rank {r}: a validation clip launched {got}, want "
                      f"{want_clip}")
            losses = [t[2]["loss"] for t in rank["trains"]]
            check(losses == [t[2]["loss"] for t in ranks[0]["trains"]]
                  and rank["stats"] == ranks[0]["stats"],
                  f"rank {r}: losses {losses}, stats {rank['stats']} differ "
                  f"from rank 0's")
            print(f"[parallel] rank {r}: {rank['backend']} on "
                  f"{rank['device']}, K1/K2 "
                  f"{[t[1]['sepconv_forward'] for t in rank['trains']]}/"
                  f"{[t[1]['sepconv_grad_kernels'] for t in rank['trains']]}"
                  f" a train iteration (want {K1_PER_RANK_ITER}/"
                  f"{K2_PER_RANK_ITER}), {want_clip} a validation clip; "
                  f"s/iteration warm-up {rank['trains'][0][0]:.4f}, timed "
                  f"{rank['trains'][1][0]:.4f} ({card}; 2 ranks share the "
                  f"card: no speed-up is measured); peak memory "
                  f"{rank['peak_gib']:.2f} GiB; K1/K2 built by both ranks "
                  f"at once into one directory in {rank['build_s']:.1f} s "
                  f"({rank['build']}); halo exchange {rank['halo']} bit for "
                  f"bit, row-sharded apply {rank['apply_err']:.3e} on "
                  f"interior rows (max {rank['apply_scale']:.3e})")

        # one process, the same batch and weights, on the card, with the
        # ranks' cuDNN setting: its outer gradient twice (the card's own
        # spread), then its train iteration
        system = System(get_args(PARALLEL_FLAGS))
        with torch.no_grad():
            for g, tree in first["before"].items():
                for k, v in tree.items():
                    system.meta_params[g][k].copy_(v)
        taken = []
        real = system.outer_grads
        system.outer_grads = lambda *a, **k: taken.append(
            real(*a, **k)) or taken[-1]

        def on_cpu(tree):
            return {g: {k: v.detach().cpu() for k, v in t.items()}
                    for g, t in tree.items() if g in first["grads"]}

        with deterministic(torch, False):
            system.outer_grads(first["frames"], 0, True)
            system.run_train_iter(first["frames"], 0, do_evaluation=True)
        (loss2, _, grads2), (loss, _, grads) = taken
        loss, loss2 = float(loss), float(loss2)
        grads, grads2 = on_cpu(grads), on_cpu(grads2)
        after, lr = on_cpu(system.meta_params), system.cfg.outer_lr
        del system, taken

        def group_rel(a, b):
            return {g: sum(float((v - b[g][k]).double().norm()) ** 2
                           for k, v in a[g].items()) ** 0.5
                    / sum(float(v.double().norm()) ** 2
                          for v in b[g].values()) ** 0.5 for g in b}

        rel, own = group_rel(first["grads"], grads), group_rel(grads2, grads)
        print(f"[parallel] vs one process on the card ({card}): loss "
              f"{first['loss']!r} vs {loss!r} (again {loss2!r}), gradient "
              + ", ".join(f"{g} {v:.3e}" for g, v in rel.items())
              + " of its norm; one process against itself "
              + ", ".join(f"{g} {v:.3e}" for g, v in own.items()))
        check(abs(first["loss"] - loss) <= PARALLEL_LOSS_RTOL * abs(loss),
              f"ranks' loss {first['loss']!r} vs one process {loss!r}")
        flips, total, worst = 0, 0, 0.0
        for g, tree in first["after"].items():
            for k, v in tree.items():
                want = after[g][k]
                d = (v - want).double().abs()
                bound = adamax_step_bound(
                    torch, lr, first["grads"][g][k] - grads[g][k], want)
                check(bool((d <= bound).all()),
                      f"{g}/{k}: weights after the step differ by "
                      f"{float(d.max()):.3e}, over the step's bound")
                flips += int((d > 0.1 * lr).sum())
                total += d.numel()
                worst = max(worst, float(d.max()))
        print(f"[parallel] weights after the Adamax step within the step's "
              f"bound, largest difference {worst:.3e} ({worst / lr:.3f} "
              f"lr), {flips} of {total} beyond 0.1 lr; the ranks' run took "
              f"{ranks_s:.1f} s")
        for g, v in rel.items():
            check(v <= PARALLEL_GRAD_RTOL + 2 * own[g],
                  f"{g} gradient: ranks vs one process {v:.3e} of its norm, "
                  f"over {PARALLEL_GRAD_RTOL:.0e} + 2 x {own[g]:.3e} (one "
                  f"process against itself)")

        for r, rank in enumerate(ranks):
            print(f"[spatial] rank {r}: the row-aware ops on 2 bands of "
                  f"{SPATIAL_OP_SHAPE} against the whole frame on the card, "
                  f"values and gradients, largest error "
                  f"{rank['spatial']['ops_err']:.3e}"
                  f"; the row-sharded runs took {rank['spatial_s']:.1f} s")
        print(f"[time] parallel_spatial_ranks: "
              f"{max(rank['spatial_s'] for rank in ranks):.1f} s")
        t = time.perf_counter()
        spatial_launches = spatial_against_one(torch, ranks, work, card)
        print(f"[time] parallel_spatial_one_process: "
              f"{time.perf_counter() - t:.1f} s")
        print(f"[time] parallel_spatial_train_ranks: "
              f"{max(rank['spatial_train_s'] for rank in ranks):.1f} s")
        t = time.perf_counter()
        check(os.path.exists(os.path.join(
            work, "ck_spatial_train", "exp", "checkpoint.pth")),
              "the training CLI on bands wrote no checkpoint")
        train_launches_ = spatial_train_against_one(torch, ranks, card)
        print(f"[time] parallel_spatial_train_one_process: "
              f"{time.perf_counter() - t:.1f} s")
        nccl = torch.load(os.path.join(work, "nccl.pt"), weights_only=False)
        check(nccl["backend"] == "nccl" and nccl["ok"],
              f"NCCL rank: {nccl}")
        print(f"[parallel] 1 rank alone, beside the two: {nccl['backend']} "
              f"on {nccl['device']}, all_reduce, all_gather, broadcast, "
              f"the halo exchange and the row bands' collectives with their "
              f"adjoints right, in {nccl_failed[0]:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {**{f"sepconv_parallel_rank{r}": rank["launches"]
               for r, rank in enumerate(ranks)},
            **{path: counts for path, counts in spatial_launches.items()
               if path.split("_")[0] in ("sepconv",) + tuple(WARP_MODELS)},
            **train_launches_}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--earlier-sepconv", metavar="PATH",
                        help="an earlier csrc/sepconv.cu to time K1/K2 "
                             "against, in turns")
    parser.add_argument("--earlier-projection", metavar="PATH",
                        help="an earlier csrc/flow_projection.cu to hold K4 "
                             "to bit for bit and time it against, in turns")
    parser.add_argument("--earlier-warp", metavar="PATH",
                        help="an earlier csrc/warp.cu: with today's C "
                             "interface (its bf16 entry points), to hold "
                             "K3, K3-grad and K3-grad² to bit for bit in "
                             "float32 and bf16 and time K3 and K3-grad "
                             "against, in turns; of the interface before "
                             "(K3 and its fy/fx gradient on coordinate "
                             "planes), to run in the plain glue, hold to "
                             "the plain composition and time against K3, "
                             "K3-grad, the warp call and the RRIN episode, "
                             "in turns")
    return parser.parse_args(argv)


def main():
    args = parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from meta_interpolation_tpu_torch.ops import _build
    from meta_interpolation_tpu_torch.ops import flow_projection_bounded as fpb
    from meta_interpolation_tpu_torch.ops import sepconv as sc
    from meta_interpolation_tpu_torch.ops import warp_bounded as wb

    card = card_line()
    print(card)
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    # earlier designs by source: (C signature binder, path, ptxas names)
    earlier = {source: (bind, path, entries)
               for source, bind, path, entries in [
                   ("sepconv", sc._bind, args.earlier_sepconv,
                    SEPCONV_KERNELS),
                   ("flow_projection", fpb._bind, args.earlier_projection,
                    PROJECTION_KERNELS),
                   ("warp", bind_earlier_warp, args.earlier_warp,
                    args.earlier_warp and earlier_warp_kernels(
                        args.earlier_warp))] if path}
    builds = {source: start_build(path, "earlier", source)
              for source, (_, path, _) in earlier.items()}
    report = _build.build()
    print(f"[build] {len(report)} source(s) in {time.perf_counter() - t0:.1f}"
          f" s")
    for name, rec in report.items():
        print(f"[build] {name}: {rec['seconds']:.1f} s")
        for line in str(rec["log"]).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build]   {line.strip()}")
    resources = sepconv_resources(report["sepconv"]["log"], "sepconv.cu")
    bf16_resources = kernel_resources(report["sepconv"]["log"], "sepconv.cu",
                                      BF16_SEPCONV_KERNELS)
    k3_resources = kernel_resources(report["warp"]["log"], "warp.cu",
                                    WARP_KERNELS)
    k4_resources = kernel_resources(report["flow_projection"]["log"],
                                    "flow_projection.cu", PROJECTION_KERNELS)
    libs = {source: finish_build(bind, *builds[source], f"earlier {path}",
                                 entries)
            for source, (bind, path, entries) in earlier.items()}
    earlier_k4 = (on_library(fpb, libs["flow_projection"],
                             fpb.flow_projection_bounded)
                  if "flow_projection" in libs else None)
    # an earlier warp.cu of the plane interface runs in the plain glue; one
    # with today's interface is bound as the checkout's (bf16: its one bf16
    # kernel, the gather design)
    warp_api, warp_lib = libs.get("warp", (None, None))
    earlier_k3 = (earlier_warp(torch, wb, warp_lib) if warp_api == "planes"
                  else None)
    earlier_grid_warp = warp_lib if warp_api == "grid" else None

    records = (timed("kernels", kernel_phase, torch, sc, card, resources,
                     libs.get("sepconv"))
               + timed("warp_kernels", warp_kernel_phase, torch, wb, card,
                       k3_resources, earlier_k3, earlier_grid_warp)
               + timed("projection_kernel", projection_kernel_phase, torch,
                       fpb, card, k4_resources, earlier_k4))
    # K3, K3-grad and K3-grad² on a band of rows (the row-sharded
    # evaluation and training)
    for rec, band in zip(records[2:5], timed(
            "warp_band", warp_band_phase, torch, wb, card,
            k3_resources).values()):
        rec["band"] = band
    mods = (sc, wb, fpb)
    bf16_records = timed("bf16_kernels", bf16_kernel_phase, torch, mods,
                         card, libs.get("sepconv"),
                         {**(bf16_resources or {}),
                          **{k: v for k, v in (k3_resources or {}).items()
                             if k.endswith("_bf16")}},
                         earlier_grid_warp)
    timed("sepconv", main_path_phase, torch, mods, libs.get("sepconv"))
    sepconv_launches = timed("sepconv_train", train_phase, torch, mods, sc,
                             card)
    earlier_sampler = earlier_k3[0] if earlier_k3 else None
    warp_paths = {model: timed(model, warp_model_phase, torch, mods, wb,
                               model, *preset, earlier=earlier_sampler)
                  for model, preset in WARP_MODELS.items()}
    timed("warp_call", warp_call_phase, torch, mods, earlier_sampler)
    grad2_record = Recording(wb._library(), (GRAD2, f"{GRAD2}_bf16"))
    train_paths = timed("warp_train", warp_train_phase, torch, mods, wb,
                        card, grad2_record)
    grad2_paths = timed("grad2_path", grad2_path_phase, torch, wb, card,
                        grad2_record, earlier_grid_warp)
    records[4]["main_path_shapes"] = grad2_paths["float32"]
    next(rec for rec in bf16_records if rec["name"] == f"{GRAD2}_bf16")[
        "main_path_shapes"] = grad2_paths["bf16"]
    dain_launches, served_ms = timed("dain", dain_phase, torch, mods,
                                     earlier_k4)
    records[-1]["served_ms"] = served_ms
    timed("cain", cain_phase, torch, mods, card)
    timed("cain_train", cain_train_phase, torch, mods, card)
    test_launches = timed("test_mode", test_mode_phase, torch, mods)
    engine_paths = timed("engine", engine_phase, torch, mods, wb, card)
    bf16_paths = timed("bf16", bf16_phase, torch, mods, card)
    rest_paths = timed("rest", rest_phase, torch, mods, sc, wb, card)
    parallel_paths = timed("parallel", parallel_phase, torch, mods, card)
    # each kernel's launches on the main paths that run it, each read on
    # its own: K1 and K2 on two; K3 and K3-grad on the three evaluation
    # CLIs and the six training paths of the warp models; K3-grad² on their
    # three second-order paths; K4 on the served DAIN frames
    warp_train_paths = {path: counts for path, counts in train_paths.items()
                        if not path.startswith("dain")}
    sepconv_engine = {path: counts for path, counts in engine_paths.items()
                      if not path.startswith("voxelflow")}
    warp_train_paths.update({path: counts for path, counts in
                             engine_paths.items()
                             if path.startswith("voxelflow")})
    by_path = {**{k: {"sepconv_train": sepconv_launches[k],
                      "sepconv_test": test_launches[k],
                      **{path: counts[k]
                         for path, counts in sepconv_engine.items()}}
                  for k in KERNELS[:2]},
               **{k: {path: counts[k] for path, counts in
                      {**warp_paths, **warp_train_paths}.items()}
                  for k in KERNELS[2:4]},
               KERNELS[4]: {path: counts[KERNELS[4]]
                            for path, counts in warp_train_paths.items()
                            if path.endswith("second_order")},
               **{k: {"dain_served": dain_launches[k]} for k in KERNELS[5:]}}
    check([rec["name"] for rec in records] == list(KERNELS),
          f"kernel records {[rec['name'] for rec in records]}")
    # the bf16 paths: K1, K2, K3, K3-grad and K3-grad² in their bf16
    # kernels (records of their own), K4 widened in its wrapper
    for k in KERNELS[5:]:
        by_path[k].update({path: counts[k] for path, counts in
                           bf16_paths.items() if counts.get(k)})
    for rec in bf16_records:
        base = rec["name"][:-len("_bf16")]
        by_path[rec["name"]] = {path: counts[base] for path, counts in
                                bf16_paths.items() if counts.get(base)}
    records += bf16_records
    # the rest of the package: K1/K2 on the SepConv paths (the VGG/SSIM
    # losses, --lpips, --profile_dir, --remat, the legacy trainers); K3 and
    # K3-grad on VoxelFlow's --remat paths, K3-grad² on its second order
    for path, counts in rest_paths.items():
        for k in (KERNELS[:2] if not path.startswith("voxelflow")
                  else KERNELS[2:4] + ((KERNELS[4],) if path.endswith(
                      "second_order") else ())):
            by_path[k][path] = counts[k]
    # task parallelism: K1/K2 in each rank's process, over its whole run;
    # the row-sharded evaluation: K1/K2 (SepConv) or K3/K3-grad (the warp
    # models) on each rank's bands, over each CLI run; the row-sharded
    # training: the same a rank's first iteration, and K3-grad² on the warp
    # models' second-order paths
    for path, counts in parallel_paths.items():
        warp = path.split("_")[0] in WARP_MODELS
        for k in (KERNELS[:2] if not warp else KERNELS[2:4] + (
                (KERNELS[4],) if "_second_" in path else ())):
            by_path[k][path] = counts[k]
    for rec in records:
        rec["launches_by_path"] = by_path[rec["name"]]
        rec["launches"] = sum(by_path[rec["name"]].values())
        check(by_path[rec["name"]]
              and all(n > 0 for n in by_path[rec["name"]].values()),
              f"{rec['name']} never ran on a main path: "
              f"{by_path[rec['name']]}")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
