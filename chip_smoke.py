#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pcmseg_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths (training, cross-validation, validation and
serving) at the flagship model's full width and checks every hand-written
kernel on them:

  1. device: the card's name and power limit (nvidia-smi); TF32 off;
  2. build: compiles csrc/*.cu for sm_90a, one nvcc per source in parallel
     (cached by content hash under build/pcmseg_tpu_torch/);
  3. B1 forward vs plain: the 3³ conv kernel at each of the 14 distinct
     (Ci, Co, size) shapes of a 128³ base-64 forward, bf16, ReLU on and
     off, at N=1 and N=4, against its plain PyTorch version in fp32 from the
     same bf16 inputs, with max|kernel − ref| ≤ 8e-3·|ref| + 1e-3·max|ref|
     (one bf16 rounding plus fp32 reassociation); median CUDA-event times at
     N=1 of the kernel, the plain version and cuDNN's conv alone, and each
     shape's TFLOP/s and share of its bound (the larger of its FLOP at the
     card's 989 TFLOP/s and its bytes, each input read once and each output
     written once, at 3.35 TB/s); two launches bitwise equal, and the
     kernel's launch plan (``pcmseg_conv3x3x3_plan``) equal to its mirror
     ``conv3d.conv_plan`` at every shape launched;
  4. B1 as dx: the 17 transposed shapes (relu off, no bias), same bound,
     two launches bitwise equal, the plan equal to its mirror; times
     beside the plain version and cuDNN's data gradient alone;
  5. B2 (weight gradient) vs plain: the 14 shapes at N=1, bf16 inputs,
     against the plain version in fp32, max|kernel − ref| ≤ 2e-3·max|ref|
     (fp32 sums of up to 2.1 M bf16 products in another order), two launches
     bitwise equal; times of the kernel, the plain version and cuDNN's
     weight gradient alone, TFLOP/s and share of the bound;
 5b. fp32_kernels: the fp32 operand paths of B1 (``csrc/conv3x3x3_f32.cu``;
     the 14 forward shapes and the 13 dx shapes of a 128³ microbatch's 18
     and 17 layers) and B2 (``csrc/conv3x3_dw_f32.cu``, the 14 shapes), N=1,
     fp32 inputs, each against a float64 conv of the
     same inputs: max|kernel − float64| ≤ FP32_MARGIN × the plain fp32
     version's (cuDNN, TF32 off) + FP32_SLACK·max|ref|; B2 two launches
     bitwise equal; median times of the kernel, the plain version and
     cuDNN's conv / dgrad / wgrad alone, TFLOP/s and the share of the bound
     at the card's fastest fp32-exact rate (3xTF32, 165 TFLOP/s, the
     kernels' own route; the FFMA bound at 66.9 beside it); then, error
     only, the FP32_CONTRACT shapes (an output-channel shard, a D-slab with
     its halo, N = 2) for all three;
 5c. fp16_kernels: the fp16 operand paths of B1 and B2 (the same sources
     as bf16's, entry points ``pcmseg_conv3x3x3_f16`` and
     ``pcmseg_conv3x3_dw_f16``): phases 3-5 on fp16 operands, each bound
     scaled by F16_REL (fp16's unit roundoff over bf16's), timed beside the
     plain version (fp32 from the fp16 inputs) and cuDNN's fp16 conv /
     dgrad / wgrad alone; the F16_CONTRACT shapes (a 64->32 shard, a
     66x128^2 slab) error only; fp16's edges: subnormal outputs kept, ±inf
     past 65504, B2 on a subnormal dy;
 5d. dw_sum: B2 at the 14 shapes in bf16 and fp16 on same-sign inputs (x,
     dy = |normal|, so every dW element is its own Σ|x·dy|), each element
     within DW_SAME_SIGN_BOUND·Σ|x·dy| of a float64 conv of the same
     rounded inputs, beside the plain fp32 version's error, the longest
     tensor-core chain and what the chains of a whole split-K slice were
     predicted to lose; ``conv3d_grad.dw_plan``'s workspace equal to the C
     workspace function's; fp16 B2 on dy over 26 binades and on
     channel-blocked dy (``dw_range``, ``dw_blocked``); B1 forwards at its longest chains (B1_SAME_SIGN)
     on same-sign inputs, error in ulps of the output, measured only.
     ``python3 chip_smoke.py --only dw_sum`` runs the build and this phase
     alone;
 5e. bn_kernels: the training BatchNorm + ReLU (``csrc/batchnorm_relu.cu``)
     at each level's shape of one 128³ microbatch, forward and backward:
     y, dx, dγ, dβ, the mean, the unbiased variance and the running
     statistics held against the plain version and float64, in bf16 and
     fp32 (``check_bn_outputs``); in bf16 its four kernels' device time by
     name, the plain version's and the stock SyncBatchNorm ops' with a ReLU
     (torch.profiler), against the least time, BN_BYTES an element at 3.35
     TB/s; the 18 layers' sums. ``python3 chip_smoke.py
     --only bn`` runs the build, this phase and the time phase (one step's
     B1, B2 and BatchNorm launches with remat off and on, step times);
  6. gradients: one 128³ microbatch through the base-64 model in BN
     training mode under the Dice loss; each conv's autograd Function as
     the kernel path ran it, layer by layer, against its plain version on
     the same bf16 tensors (forward and dx within B1's bound, each dW
     element within DW_SUM_BOUND·Σ|x·dy| of float64); the loss and every 3³ conv weight's gradient of the kernel
     path (bf16) no further from the fp32 plain-conv model's than 1.5× the
     plain conv's bf16 error (+1e-3 on relative errors), the BN-preceded
     conv biases left out (their true gradient is 0); beside it, as
     witnesses of why both bf16 gradients lie far from fp32, the fp32
     gradient with the input moved by one bf16 rounding, the same
     comparison under Σ logits·r / numel for a fixed random r, and the
     share of the cotangent each BatchNorm's backward keeps;
  7. train: ``Trainer(config).train()`` on 5 synthetic 128³ NIfTI cases
     in the flagship configuration (batch 4 as 4 microbatches, no remat,
     bf16, Dice, Adam 1e-4) for 2 epochs, from the device data cache (on
     by default; the stacks on the card): finite history, ``latest`` and
     ``best`` checkpoints, exact kernel launch counts (per step 4 × (18 B1
     forward + 17 B1 dx + 18 B2), 18 B1 per validation forward); a run
     killed after epoch 1 and resumed from ``latest`` equals the
     uninterrupted one bit for bit; one case served from ``best.pth``;
  8. time: median warm step time of the kernel step and the plain-conv step
     on one device batch, vol/s, peak device memory; launch counts of a
     remat step (18 more B1 per microbatch); device time by kernel;
  9. cv: ``CrossValidationTrainer(config).train()`` on the train phase's 5
     cases, 2 folds x 1 epoch in the flagship configuration: finite
     histories, ``cv_results.json``, ``best_fold_{0,1}.pth``, exact launch
     counts (the train phase's per step and per validation forward), one
     device-cache upload for both folds, the time in train epochs,
     validation and checkpoint writes; a resumed CrossValidationTrainer
     skips both folds and launches nothing;
 9b. cache: 12 synthetic 128³ cases (10 train, 2 val), the flagship step:
     (a) 2 epochs from the full cache bitwise equal to 2 streamed epochs
     from the same init (history and parameters); (b) a budget of exactly
     8 cases: 8 train cases resident, 2 train and 2 val cases streamed,
     their batch spread among the cached ones, every train case consumed
     once per epoch, and a run killed after epoch 1 and resumed bitwise
     equal to the uninterrupted one; (c) every augmentation on and 96³
     crops with 'center' foreground oversampling, one cold and two warm
     ``train_epoch()`` calls cached (on the card) and streamed (scipy on
     the host): seconds per epoch, vol/s of the unprofiled warm epoch, the
     card's idle share of a second warm epoch's own wall time under
     torch.profiler, one cached 96³ microbatch's 18 forward, 17 dx and 18
     dW convs (96³ to the 6³ bottleneck) held against the plain versions
     as in the gradients phase, the device ms of one batch's gather,
     crop and augmentation; then the warp, the blur and the gamma branch
     on one 128³×5 volume on the card and on the CPU, max |Δ|, no NaN.
     Exact launch counts in each part (96³ crops run the same 18 + 17 + 18
     convs per microbatch);
 9c. ds: one flagship step of a deep-supervision model (finite loss, 140
     B1 and 72 B2 launches, non-zero gradients at the three heads), then a
     1-epoch deep-supervision ``Trainer`` whose ``best.pth`` has no ``ds*``
     key and serves one case;
 9d. kclass: 5 synthetic 128³ cases labelled 0/1/2 and a base-64 K = 3
     GroupNorm model: (a) one flagship step under CE + foreground Dice
     (finite loss, 140 B1 and 72 B2 launches), the median of 5 warm steps
     and the peak memory beside the BatchNorm step of phase 8, the step's
     device time by kernel, and one microbatch's 18 forward, 17 dx and 18
     dW convs held against the plain versions (dW against float64, within
     DW_SUM_BOUND·Σ|x·dy|); (b) a
     1-epoch ``Trainer`` from the device cache, whose best.pth holds
     GroupNorm weight/bias, no running statistics and a 3-class head;
     (c) the ``Validator`` on best.pth (18 B1 per batch), then on a
     2-member ensemble with TTA (18 x 2 x 8 per batch): per-class Dice at
     keys "1" and "2", each case's Dice the mean of its classes; (d)
     ``PredictionServer.run_once`` of the serve phase's three cases with
     best.pth served unfolded: uint8 label maps in {0, 1, 2}, 18 B1 per
     forward, the device path timed and the K-channel probabilities held as
     in the serve phase on a whole-volume and the tiled case; (e) a folded
     K = 3 BatchNorm model serving one case the same way (18 B1);
 10. validate: the ``Validator`` over the 5 cases: (a) ``best_fold_0.pth``
     through the eval step (BatchNorm unfolded), 18 B1 launches per batch
     of 4; (b) the two folds as an ensemble with TTA, surface metrics and
     largest-component postprocessing, 18 x 2 members x 8 flips per batch,
     per-case Dice and hd95, the device path, postprocess and the surface
     EDT (host, scipy) timed apart; between them, one case's ensemble + TTA
     probabilities held as in the serve phase: no further from the same
     ensemble and TTA in fp32 (plain conv) than 1.5x the plain conv's bf16
     probabilities, and within PLAIN_MAX_DP / PLAIN_MEAN_DP of those;
     (c) ``validate_native`` of the ensemble with TTA on a 160x160x144 case
     at 0.75x0.75x1.5 mm (8 tiles in 2 batches), surface metrics in mm.
     Each of (a), (b), (c) launches no B2;
 11. cli: ``python -m pcmseg_tpu_torch check`` and ``validate --model_path
     'best_fold_*.pth' --tta``, each in its own process, each exiting 0;
 12. serve: three synthetic 5-modality NIfTI cases (two 128³, one
     160×160×144 that is tiled as 8 windows in two batches of 4) through
     ``PredictionServer.run_once`` with a seeded base-64 BatchNorm model
     (90,311,361 parameters, folded on load). Asserts 3 done, uint8 masks
     of each case's shape, and exactly 18 kernel launches per forward.
     Then, on one 128³ case and on the tiled case, the kernel's bf16
     probabilities must be no further from the same model in fp32 (plain
     conv, TF32 off) than 1.5× the distance of the plain conv's bf16
     probabilities (max and mean |dp|), and the two bf16 forwards must
     agree within PLAIN_MAX_DP / PLAIN_MEAN_DP;
 13. profile: where a warm 128³ case's time goes: host decode, device
     path and mask write each timed alone, the device path's time per
     kernel (torch.profiler), and the card's idle share over a warm
     ``run_once`` of four 128³ cases;
 14. profiling: ``profile_dir`` through each entry point that takes it,
     each in a process of its own (``chip_smoke.py --profiled WORK`` runs
     the first two): a flagship ``Trainer`` with ``profile_steps=2`` on the cache phase's
     12 cases (3 steps an epoch: the window, steps 1 and 2, closes at the
     epoch's end), whose trace file holds exactly 2 x 140 B1 and 2 x 72 B2
     kernel events by name, each step timed (synchronised) inside and
     outside the window; a ``PredictionServer`` over the serve cases whose
     window, written by ``close()``, holds 18 B1 per forward and one
     ``serve.case`` span per case; ``predict --profile`` in its own process;
 15. async_ckpt: the 12 cases, flagship configuration, 2 epochs from the
     same init with synchronous and asynchronous checkpoints: histories
     and parameters equal, latest, best and best.pth bitwise-equal tensors
     and equal meta (but the two config keys that differ); an async run
     killed after epoch 1 and resumed bitwise equal to the uninterrupted
     one; a writer that cannot write raised by ``train()``; exact launch
     counts; each run's wall time and epoch times (with and without a
     write in flight), the training thread's time in saves, the writer's
     seconds per task, collapsed tasks and the peak pinned host bytes;
 16. ingest: ``device_ingest`` over the serve cases: the device stack
     against the host path's bf16 stack (max |d| at most 2^-8, the share
     of elements that differ), the masks against the host path's except
     within 1e-2 of the threshold, 18 B1 per forward; then warm
     ``run_once`` of the four 128³ cases with host and device ingest in
     turns (host, device, device, host): vol/s, the card's idle share,
     host decode and normalize ms per case and the ingest's device ms;
 16b. fp32_train: ``compute_dtype='float32'``: 3 flagship steps from the
     seed, each exactly 4 x (18 + 17) fp32 B1 and 4 x 18 fp32 B2 launches
     and no bf16 one; step 1's loss and every gradient tensor (the
     BN-preceded conv biases logged apart) no further from the float64 step
     (dp_reference's) than FP32_STEP_MARGIN x the plain-conv fp32 step's +
     FP32_STEP_SLACK; warm step ms, vol/s, peak memory, device time by
     kernel; one epoch of an fp32 ``Trainer`` (no checkpoints) with exact
     launches; one 128³ case served by an fp32 ``Predictor`` (18 fp32 B1),
     its probabilities within FP32_MARGIN x the plain fp32 conv's distance
     from float64 + FP32_SLACK;
 16c. param_dtype: ``param_dtype='bfloat16'``, bf16 compute: 4 flagship
     steps (params and Adam moments bf16, count int32, BN statistics fp32,
     the bf16 step's launches), the median ms of the 3 warm ones and the
     peak memory beside the same steps with fp32 params; a 1-epoch bf16-param Trainer's ``best.pth``
     (bf16) served by a bf16-param ``Predictor`` (18 bf16 B1), within
     PLAIN_MAX_DP / PLAIN_MEAN_DP of the file served with fp32 params.
     ``python3 chip_smoke.py --only fp32`` runs the kernel checks and
     these two phases alone;
 16d. fp16_train: ``compute_dtype='float16'``, fp32 params: 3 flagship
     steps from the seed, each exactly 4 x (18 + 17) fp16 B1 and 4 x 18
     fp16 B2 launches and no bf16 or fp32 one; step 1's loss and every
     gradient tensor no further from the float64 step than
     FP16_STEP_MARGIN x the plain-conv fp16 step's + FP16_STEP_SLACK; the
     share of the head's fp16 output gradient that is zero or subnormal
     (no loss scaling, as in JAX); warm step ms, vol/s, peak memory,
     device time by kernel; one microbatch's convs held against the plain
     versions as in phase 6 (dW within DW_SUM_BOUND·Σ|x·dy|); one epoch of
     an fp16 ``Trainer`` (no checkpoints) with exact launches; one 128^3
     case served by an fp16
     ``Predictor`` (18 fp16 B1), as close to fp32 as check_probs holds
     bf16, the slack scaled by F16_REL. ``python3 chip_smoke.py --only
     fp16`` runs the kernel checks and this phase alone;
 17. dp: data parallelism across processes on the one card. (a) two ranks
     (``chip_smoke.py --dp-rank R 2 PORT WORK gloo``) in a gloo group on CUDA
     tensors (NCCL refuses two ranks on one device), 3 flagship steps from
     the same seeded weights and batches, each rank on its 2 whole
     microbatches (layout (b)), against the same steps in this process
     without a group: losses, grad norms and states bitwise equal across
     the ranks; the first loss and the running statistics after step 1
     bitwise equal to one process's, step 1's grad norm within
     DP_GRAD_NORM_RTOL and every parameter after it within DP_PARAM_ATOL
     of it; the later losses within DP_LOSS_RTOL; exactly 2 x (35 B1, 18 B2)
     launches per rank and step; each rank's step time and gradient
     all-reduce time (361.2 MB through the host: gloo's numbers on a shared
     card, not NCCL's). (b) a one-rank NCCL group (``--dp-trainer 0 1 PORT
     WORK nccl g1``): a 1-epoch flagship Trainer over the cache phase's 12 cases
     from the device cache sharded over the one rank, with asynchronous
     checkpoints, every collective through NCCL; exact launch counts,
     latest and best.pth, the history bitwise equal to the same run without
     a group. (c) layout (c): DP_C_RANKS gloo ranks (``--dp-c-rank``),
     batch 4 in 2 microbatches, which 4 ranks divide neither way: two
     groups of 2 ranks, one microbatch each; one step, every rank's state
     bitwise equal, 35 B1 / 18 B2 a rank, the loss within DP_LOSS_RTOL of
     one process's. ``python3 chip_smoke.py --only dp`` runs the kernel
     checks and this phase alone.
 18. sp: spatial parallelism, the volume's D axis split over SP_RANKS
     D-slabs, on the one card. B1 (forward and dx) and B2 at the shapes of
     one 128³ D-slab with its two halo slices, against their plain
     versions, timed; (a) the folded flagship model served with
     ``spatial_parallel`` 2 on shards ["cuda", "cuda"] (and across cards
     where the host has them): a 128³ case and a 256×128² one (whole when
     sharded, tiled unsharded) against an unsharded whole-volume forward,
     in fp32 through the plain conv within SP_FP32_BOUND, the bf16 kernel
     path as close to fp32 as the unsharded one (check_probs' rule), 18 B1
     a shard-forward each on a halo-extended slab, the device path's time;
     (b) two gloo ranks (``chip_smoke.py --sp-rank R 2 PORT WORK gloo``)
     on a data 1 × spatial 2 mesh, 3 flagship steps each on its 64×128²
     slabs of all 4 microbatches, against dp (a)'s one-process steps:
     ranks bitwise equal, step 1 in float64 through the plain conv against
     one process's within SP_EXACT_RTOL / SP_EXACT_SHARE, the bf16 step's
     loss within SP_LOSS1_RTOL and its gradients as close to float64 as one
     process's, 140 B1 / 72 B2 a rank-step, each rank's step, halo and
     all-reduce times, halo bytes and peak memory; (c) a 2-rank spatial
     Trainer (``--sp-trainer``) for 1 epoch with validation from the
     device cache on the 12 cases: histories equal, the primary's one
     checkpoint set, exact launches. ``python3 chip_smoke.py --only sp``
     runs the kernel checks and this phase alone.
 19. tp: tensor parallelism, every conv's, transposed conv's, head's and
     norm's output channels split over TP_RANKS ranks, on the one card. B1
     forward with Co halved, B1 as dx on a dy shard (Ci = Co / 2: 32 at
     level 1, which B1 pads to 64) and B2 with Co halved, at the 128³ base-64
     shapes, against their plain versions, timed; (b) two gloo ranks
     (``chip_smoke.py --tp-rank R 2 PORT WORK gloo``) on a data 1 × spatial
     1 × model 2 mesh, 2 flagship steps each on all 4 microbatches, held as
     (b) of sp holds its ranks: the gathered states bitwise equal, step 1 in
     float64 through the plain conv against one process's, the bf16 steps'
     losses and gradients, 140 B1 / 72 B2 a rank-step (each conv once a
     microbatch on its shard); each rank's step time, peak memory, and the
     time and bytes of the channel gathers and of their backward's
     gradient sums; (c) a 2-rank tp Trainer (``--tp-trainer``) for 1
     epoch with validation from the device cache on the 12 cases:
     histories bitwise equal, the primary's one checkpoint set in the whole
     reference layout, exact launches. ``python3 chip_smoke.py --only tp``
     runs the kernel checks and this phase alone.

Every phase prints its own lines; any failure raises and exits non-zero.
Without a CUDA device, or outside a checkout of the repository, it exits 1
before doing anything. The last lines are the kernels' JSON record (per
kernel the 128³-microbatch sums of the kernel, its plain version, cuDNN's
call (``library_ms``) and the bound; B1's ``dx_*`` keys are its dx use;
``launches_by_path`` counts each path's run, ``cache_a``, ``cache_b``,
``cache_c``, ``ds``, ``kclass``, ``profiling``, ``async_ckpt``, ``ingest``,
``dp_a`` (both ranks), ``dp_b``, ``dp_c`` (all ranks), ``sp_serve``, ``sp_train``, ``sp_trainer``,
``tp_train`` and ``tp_trainer`` (both ranks each), ``param_dtype_*`` those
of the phases of those names; ``slab_*`` the times at one D-slab's shapes,
``tp_*`` at one output-channel shard's; the fp32 kernels' entries, with
``launches`` of the fp32 step's first step and ``fp32_*`` paths, hold
their errors from float64, the bound at 3xTF32's rate and, as
``ffma_bound_ms``, at FFMA's; the fp16 entries, ``conv3x3x3_f16`` and
``conv3x3_dw_f16``, the same sources' fp16 entry points, with ``launches``
of the fp16 step's first step and ``fp16_*`` paths, errors from fp32 of
the same fp16 inputs and cuDNN's fp16 calls as ``library_ms``),
the nvidia-smi line, and the device JSON.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# (Ci, Co, cubic size, layers of a 128³ forward with this shape)
CONV_SHAPES = (
    (5, 64, 128, 1), (64, 64, 128, 2), (64, 128, 64, 1), (128, 128, 64, 2),
    (128, 256, 32, 1), (256, 256, 32, 2), (256, 512, 16, 1), (512, 512, 16, 2),
    (512, 1024, 8, 1), (1024, 1024, 8, 1), (1024, 512, 16, 1), (512, 256, 32, 1),
    (256, 128, 64, 1), (128, 64, 128, 1),
)
CASES = {"case_a": (128, 128, 128), "case_b": (128, 128, 128), "case_c": (160, 160, 144)}
BASE_FEATURES = 64
N_PARAMS = 90_311_361
# the kernel's bf16 forward may be at most this many times further from the
# fp32 forward than the plain conv's bf16 forward is (max and mean |dp|)
BF16_MARGIN = 1.5
# and the two bf16 forwards agree with each other within these bounds on
# |p_kernel - p_plain|: each rounds activations to bf16 at other points
# through 18 convs, and each lies within ~0.05 (max) / 5e-3 (mean) of fp32
PLAIN_MAX_DP = 0.1
PLAIN_MEAN_DP = 1e-2
# profile phase: 128³ cases in the warm run_once, forwards under torch.profiler
PROFILE_CASES = 4
PROFILE_FORWARDS = 5
# one H100 SXM at its 700 W limit (NVIDIA's data sheet): dense bf16 tensor
# rate and HBM3 bandwidth, for the least time a conv could take
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# fp32 on the same card: the fastest fp32-exact rate, 3xTF32 on the tensor
# cores (495 TFLOP/s TF32 over three passes), which bounds an fp32 conv; and
# FFMA on the CUDA cores (the rate of an fp32 kernel with exact products on
# the CUDA cores, the fp32 kernels' earlier design; kept as its yardstick)
PEAK_3XTF32_FLOPS = 494.7e12 / 3
PEAK_FFMA_FLOPS = 66.9e12
# an fp32 kernel's max |error| from a float64 conv of the same fp32 inputs
# may be FP32_MARGIN times the plain fp32 version's (cuDNN, TF32 off) plus
# FP32_SLACK of the largest |output|
FP32_MARGIN = 2.0
FP32_SLACK = 1e-6
# the fp32 kernels' contract beyond the model's N = 1 shapes, held to the same
# bound and timed in no sum: (label, N, D, size, Ci, Co, a D-slab with its
# halo): one output-channel shard of two (64 -> 32) at 128^3, one D-slab of
# two with its halo slices at 128^2, and N = 2 at 64^3
FP32_CONTRACT = (("64->32 @128^3, one of 2 output-channel shards", 1, 128, 128, 64, 32, False),
                 ("64->64 @66x128^2, one of 2 D-slabs with its halo", 1, 66, 128, 64, 64, True),
                 ("128->128 @64^3, N=2", 2, 64, 64, 128, 128, False))
# fp16 operands (compute_dtype='float16'): each bf16 kernel bound scaled by
# fp16's unit roundoff over bf16's, 2^-11 / 2^-8 = 1/8: B1 within 1e-3·|ref|
# + 1.25e-4·max|ref| of fp32 of the same fp16 inputs (bf16: 8e-3, 1e-3),
# B2 within 2.5e-4·max|ref| (bf16: DW_BOUND 2e-3)
F16_REL = 2.0**-11 / 2.0**-8
# the fp16 kernels' contract beyond the model's shapes (N = 4, the serving
# tile batch, is in the forward check), error only: (label, D, size, Ci, Co,
# a D-slab with its halo)
F16_CONTRACT = (("64->32 @128^3, one of 2 output-channel shards", 128, 128, 64, 32, False),
                ("64->64 @66x128^2, one of 2 D-slabs with its halo", 66, 128, 64, 64, True))
# the sp phase's spatial group: every rank holds one D-slab of its rows
SP_RANKS = 2
SLAB_NOTE = {False: "", True: f", one of {SP_RANKS} D-slabs with its halo"}
# the tp phase's model group: every rank holds one output-channel shard of each conv
TP_RANKS = 2


def shape_note(slab: bool, tp: int) -> str:
    return SLAB_NOTE[slab] + (f", one of {tp} output-channel shards" if tp > 1 else "")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def conv_bound(ci: int, co: int, size: int, n: int = 1, dw: bool = False, depth: int = 0, fp32: bool = False,
               peak: float = 0.0):
    """(least ms, FLOP, whether the operations and not the bytes bound it)
    of one 3³ conv at these shapes (D = ``depth`` where given, else
    ``size``) on one H100: the larger of its FLOP at PEAK_FLOPS and its
    bytes at PEAK_BYTES, each input read once and each output written
    once. Forward and dx read x (or dy) and the bf16 weight and write y (or
    dx), plus the fp32 bias; dW reads x and dy and writes the fp32 (27, Ci,
    Co) gradient. Ci is the real channel count (5 at the input conv, not
    the 8 the kernel reads). With ``fp32``: fp32 operands (4 bytes each)
    and the FLOP at PEAK_3XTF32_FLOPS, or at ``peak`` where given."""
    vox = n * (depth or size) * size**2
    flop = 2 * 27 * ci * co * vox
    elem = 4 if fp32 else 2
    moved = elem * vox * (ci + co) + (4 * 27 * ci * co if dw else elem * 27 * ci * co + 4 * co)
    ops_s, bytes_s = flop / (peak or (PEAK_3XTF32_FLOPS if fp32 else PEAK_FLOPS)), moved / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, flop, ops_s >= bytes_s


def plan_note(plan: dict) -> str:
    """B1's plan in a few words: the instruction, the splits of K (a
    cluster), the longest chain."""
    split = f"K split over a cluster of {plan['splits']}" if plan["splits"] > 1 else f"{plan['grid_x']} persistent blocks"
    return f"m64n{plan['bn']}k16, {split}, chains of {plan['chain_steps']} k16 steps"


def shape_line(k_ms: float, bound_ms: float, flop: int) -> str:
    return f"kernel {k_ms:.4f} ms ({flop / k_ms / 1e9:.1f} TFLOP/s, {bound_ms / k_ms:.3f} of the bound {bound_ms:.4f} ms)"


def summed(rows) -> dict:
    """Sums over layers of [(layers, kernel ms, plain ms, library ms, bound ms,
    ops-bound ms)]: the JSON record's times."""
    ms = sum(n * k for n, k, *_ in rows)
    ops = sum(n * o for n, *_, o in rows)
    bound = sum(n * b for n, _, _, _, b, _ in rows)
    return {"ms": ms, "plain_ms": sum(n * p for n, _, p, *_ in rows),
            "library_ms": sum(n * c for n, _, _, c, *_ in rows), "bound_ms": bound,
            "bound_by": "operations" if ops >= bound / 2 else "bytes"}


def median_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def slab_depth(size: int, slab: bool) -> int:
    """D of a conv's input at a level ``size`` deep: with ``slab``, one of
    SP_RANKS D-slabs with its two halo slices."""
    return size // SP_RANKS + 2 if slab else size


def operand_dtype(dtype) -> tuple:
    """(the operands' dtype, the bound's scale, the log tag) of a kernel
    check: bf16 by default; fp16 with its bound scaled by F16_REL."""
    import torch

    if dtype in (None, torch.bfloat16):
        return torch.bfloat16, 1.0, ""
    if dtype != torch.float16:
        raise ValueError(f"the 16-bit kernel checks take bf16 or fp16, got {dtype}")
    return dtype, F16_REL, "fp16 "


def check_b1_plan(n: int, d: int, s: int, ci: int, co: int, what: str) -> dict:
    """B1's launch plan for x (n, d, s, s, ci) into co channels as the
    library computes it for this card (its SMs and the clusters it holds at
    once), held equal to ``conv3d.conv_plan``'s for the same card."""
    import torch

    from pcmseg_tpu_torch.ops.kernels import build, conv3d

    lib, device = build.load_library(), torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clusters = conv3d.device_clusters(lib, device)
    got = conv3d.kernel_plan(lib, n, d, s, s, ci, co, sms, clusters)
    want = conv3d.conv_plan(n, d, s, s, ci, co, sms, clusters)
    if any(got[k] != want[k] for k in conv3d.PLAN_FIELDS):
        raise AssertionError(f"{what}: B1's launch plan {got} differs from conv3d.conv_plan's {want}")
    return got


def b1_twice(x, packed, b, relu: bool, what: str):
    """B1 launched twice on the same inputs; the two outputs bitwise equal."""
    import torch

    from pcmseg_tpu_torch.ops.kernels import conv3d

    got = conv3d.conv3x3x3(x, packed, b, relu)
    again = conv3d.conv3x3x3(x, packed, b, relu)
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two launches of B1 differ")
    return got


def check_kernels(device, card: str, batches, slab: bool = False, tp: int = 1, dtype=None) -> dict:
    """Kernel vs plain version at each shape and each batch size in
    ``batches`` (two launches bitwise equal, the launch plan equal to its
    mirror), timed at the first; returns the JSON record's numbers.
    With ``slab``, at a D-slab's shape (``slab_depth``); with ``tp`` > 1, at
    one output-channel shard's (Co / tp). Operands bf16, or ``dtype``
    (fp16: the bound scaled by F16_REL, logged with an "fp16 " tag)."""
    import torch
    import torch.nn.functional as F

    from pcmseg_tpu_torch.ops.kernels import conv3d

    dtype, rel, tag = operand_dtype(dtype)
    max_err, rows = 0.0, []
    g = torch.Generator(device=device).manual_seed(0)
    for ci, co, s, layers in CONV_SHAPES:
        d, co = slab_depth(s, slab), co // tp
        w = torch.randn((co, ci, 3, 3, 3), generator=g, device=device) * math.sqrt(2.0 / (27 * ci))
        b = torch.randn((co,), generator=g, device=device) * 0.1
        packed = conv3d.pack_weight(w, dtype)
        shape_err = 0.0
        for n in reversed(batches):  # the last x made is the timed one
            x = torch.randn((n, d, s, s, ci), generator=g, device=device).to(dtype)
            plan = check_b1_plan(n, d, s, ci, co, f"{tag}conv {ci}->{co} @{d}x{s}^2 N={n}")
            for relu in (True, False):
                got = b1_twice(x, packed, b, relu, f"{tag}conv {ci}->{co} @{d}x{s}^2 N={n} relu={relu}")
                torch.cuda.synchronize()
                ref = conv3d.conv3x3x3_reference(x.float(), packed.float(), b, relu)
                err = (got.float() - ref).abs()
                bound = rel * (8e-3 * ref.abs() + 1e-3 * ref.abs().max())
                if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
                    raise AssertionError(
                        f"{tag}conv {ci}->{co} @{d}x{s}^2 N={n} relu={relu}: kernel disagrees with the "
                        f"plain version (max err {err.max().item():.4g}, worst err/bound "
                        f"{(err / bound).max().item():.3g})"
                    )
                shape_err = max(shape_err, err.max().item())
                del got, ref, err, bound
        max_err = max(max_err, shape_err)
        k_ms = median_ms(lambda: conv3d.conv3x3x3(x, packed, b, True))
        p_ms = median_ms(lambda: conv3d.conv3x3x3_reference(x, packed, b, True))
        w5 = conv3d.unpack_weight(packed, ci).contiguous(memory_format=torch.channels_last_3d)
        xc = x.permute(0, 4, 1, 2, 3)
        c_ms = median_ms(lambda: F.conv3d(xc, w5, padding=1))
        bound, flop, ops = conv_bound(ci, co, s, batches[0], depth=d)
        log(f"{tag}conv {ci}->{co} @{d}x{s}^2 x{layers}: ok at N={'/'.join(map(str, batches))}, "
            f"max_abs_err {shape_err:.4g}, bitwise repeat, {plan_note(plan)}; N={batches[0]}: "
            f"{shape_line(k_ms, bound, flop)}, "
            f"plain {p_ms:.4f} ms, cudnn conv alone {c_ms:.4f} ms [{card}]")
        rows.append((layers, k_ms, p_ms, c_ms, bound, bound if ops else 0.0))
        del x, w, b, packed
    out = {"max_abs_err": max_err, **summed(rows)}
    log(f"{tag}forward, 18 layers of one 128^3 microbatch{shape_note(slab, tp)}: kernel {out['ms']:.3f} ms, "
        f"plain {out['plain_ms']:.3f} ms, "
        f"cudnn conv alone {out['library_ms']:.3f} ms, bound {out['bound_ms']:.3f} ms [{card}]")
    return out


def write_cases(root: str, modalities) -> None:
    """Synthetic int16 MRI-like volumes: a bright ellipsoid plus noise."""
    import numpy as np

    from pcmseg_tpu_torch.data.nifti import write_nifti

    rng = np.random.default_rng(0)
    for case_id, shape in CASES.items():
        z, y, x = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32) for n in shape], indexing="ij")
        blob = np.exp(-3 * (z**2 + 2 * y**2 + x**2))
        for i, m in enumerate(modalities):
            os.makedirs(os.path.join(root, case_id, m))
            vol = 300 * blob * (1 + 0.25 * i) + rng.normal(0, 25, size=shape).astype(np.float32)
            write_nifti(vol.astype(np.int16), os.path.join(root, case_id, m, "image.nii"))


def make_checkpoint(path: str, config, probe_case: str, device) -> None:
    """Seeded BatchNorm model with non-trivial running statistics, its
    output bias centred on the median logit of ``probe_case``."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.models.unet3d import BatchNorm, UNet3D, param_count
    from pcmseg_tpu_torch.train.checkpoints import load_pth, save_pth

    g = torch.Generator().manual_seed(1234)
    model = UNet3D.from_config(config, generator=g)
    if param_count(model) != N_PARAMS:
        raise AssertionError(f"{param_count(model)} parameters, expected {N_PARAMS}")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.8, 1.2, generator=g)
                m.bias.normal_(0.0, 0.05, generator=g)
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    save_pth(path, model.state_dict(), config.to_dict())
    del model
    probe = Predictor(config, path, device=device)
    p = probe.predict_probs(probe.load_case(probe_case)[0])
    if not np.isfinite(p).all():
        raise AssertionError("non-finite probabilities")
    p = np.clip(p, 1e-6, 1 - 1e-6)
    sd, snap = load_pth(path)
    sd["outc.bias"] -= float(np.median(np.log(p / (1 - p))))
    save_pth(path, sd, snap)


def expected_forwards(config) -> int:
    from pcmseg_tpu_torch.infer.sliding_window import tile_starts

    total = 0
    for shape in CASES.values():
        if config.sliding_window or any(s > w for s, w in zip(shape, config.window_size)):
            n = len(tile_starts(shape, config.window_size, config.window_overlap))
            total += math.ceil(n / min(config.window_tile_batch, n))
        else:
            total += 1
    return total


def serve(work: str, config, device, card: str):
    """The port's main path: PredictionServer.run_once over ``CASES``.
    Returns (the kernel launches counted during that run, the server)."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.data.io import read_volume
    from pcmseg_tpu_torch.infer.serve import PredictionServer
    from pcmseg_tpu_torch.ops.kernels import batchnorm, conv3d

    inbox, outbox, pth = (os.path.join(work, n) for n in ("inbox", "outbox", "model.pth"))
    t0 = time.perf_counter()
    write_cases(inbox, config.modalities)
    first = sorted(CASES)[0]
    make_checkpoint(pth, config, os.path.join(inbox, first), device)
    server = PredictionServer(config, pth, inbox, outbox, min_age=0.0, device=device)
    log(f"serve setup (cases, checkpoint, load + fold) {time.perf_counter() - t0:.1f} s")

    conv3d.launches = batchnorm.launches = 0
    t0 = time.perf_counter()
    stats = server.run_once()
    wall = time.perf_counter() - t0
    launches = conv3d.launches
    forwards = expected_forwards(server.config)
    if stats != {"done": len(CASES), "failed": 0, "skipped": 0, "waiting": 0}:
        raise AssertionError(f"serve stats {stats}")
    bn_launches = batchnorm.launches
    if launches != 18 * forwards or bn_launches:
        raise AssertionError(f"{launches} conv kernel launches for {forwards} forwards, expected {18 * forwards}; "
                             f"{bn_launches} BatchNorm launches, expected none (the folded graph)")
    log(f"served {stats['done']} cases, {forwards} forwards, {launches} conv kernel launches "
        f"(18 per forward), {wall:.2f} s cold [{card}]")
    for case_id, shape in CASES.items():
        mask = read_volume(os.path.join(outbox, case_id, "segmentation.nii.gz")).data
        if mask.dtype != np.uint8 or mask.shape != shape or not set(np.unique(mask)) <= {0, 1}:
            raise AssertionError(f"{case_id}: mask {mask.dtype} {mask.shape}, expected uint8 {shape}")
        log(f"  {case_id} {shape}: cold latency {server.latencies[case_id]:.3f} s, "
            f"foreground {mask.mean():.3f}")

    # warm serving: the same cases again, end to end (decode, H2D, forward, D2H, write)
    shutil.rmtree(outbox)
    t0 = time.perf_counter()
    server.run_once()
    wall = time.perf_counter() - t0
    log(f"warm serve: {len(CASES)} cases in {wall:.3f} s = {len(CASES) / wall:.3f} vol/s [{card}]")
    for case_id in sorted(CASES):
        log(f"  {case_id}: warm latency {server.latencies[case_id]:.3f} s [{card}]")

    # the device path alone (H2D, forward, threshold, D2H), kernel and plain conv
    predictor = server.predictor
    image, _ = predictor.load_case(os.path.join(inbox, first))

    def device_path_seconds():
        best = []
        for _ in range(3):
            t = time.perf_counter()
            predictor.predict_mask(image)
            best.append(time.perf_counter() - t)
        return min(best)

    kernel_s = device_path_seconds()
    with plain_conv(predictor.models, torch.bfloat16):
        plain_s = device_path_seconds()
    log(f"{first} device path (H2D, forward, threshold, D2H): kernel {kernel_s * 1e3:.1f} ms "
        f"= {1 / kernel_s:.2f} vol/s, plain conv {plain_s * 1e3:.1f} ms [{card}]")

    # numerics as served: whole-volume (N=1) and tiled (N=window_tile_batch)
    check_probs(predictor, image, first)
    tiled = max(CASES, key=lambda c: math.prod(CASES[c]))
    check_probs(predictor, predictor.load_case(os.path.join(inbox, tiled))[0], tiled)
    if device.type == "cuda":
        log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return (launches, bn_launches), server


@contextlib.contextmanager
def plain_conv(models, dtype):
    """Run ``models`` with the plain conv in place of the kernel, in ``dtype``."""
    from pcmseg_tpu_torch.models import unet3d
    from pcmseg_tpu_torch.ops.kernels import conv3d

    saved = [m.dtype for m in models]
    unet3d.conv3x3x3 = conv3d.conv3x3x3_reference
    for m in models:
        m.dtype = dtype
    try:
        yield
    finally:
        unet3d.conv3x3x3 = conv3d.conv3x3x3
        for m, d in zip(models, saved):
            m.dtype = d


def check_probs(predictor, image, label: str):
    """Hold the kernel's bf16 probabilities on ``image`` (through
    ``predict_probs``, whole-volume or tiled as served, ensemble and TTA
    as configured; all K channels of a K-class head) against the plain
    conv's bf16 forward and the same model in fp32 (plain conv, TF32 off).
    Returns the kernel's (the one channel of a binary head)."""
    import numpy as np
    import torch

    binary = predictor.config.n_classes < 2
    pick = (lambda p: p[..., 0]) if binary else (lambda p: p)
    probs = pick(predictor.predict_probs(image))
    with plain_conv(predictor.models, torch.bfloat16):
        plain = pick(predictor.predict_probs(image))
    with plain_conv(predictor.models, torch.float32):
        exact = pick(predictor.predict_probs(image))
    if not all(np.isfinite(a).all() for a in (probs, plain, exact)):
        raise AssertionError(f"{label}: non-finite probabilities")
    err_k, err_p = np.abs(probs - exact), np.abs(plain - exact)
    for name, p, err in (("kernel", probs, err_k), ("plain conv", plain, err_p)):
        if binary:
            flips = (p > 0.5) != (exact > 0.5)
            log(f"{label} bf16 {name} vs fp32: max|dp| {err.max():.4g}, mean|dp| {err.mean():.3g}, "
                f"mask voxels differing {int(flips.sum())} of {flips.size}, the farthest at "
                f"|p_fp32-0.5| {np.abs(exact[flips] - 0.5).max() if flips.any() else 0.0:.3g}")
        else:
            flips = p.argmax(-1) != exact.argmax(-1)
            top = np.sort(exact[flips], axis=-1)
            log(f"{label} bf16 {name} vs fp32: max|dp| {err.max():.4g}, mean|dp| {err.mean():.3g}, "
                f"label voxels differing {int(flips.sum())} of {flips.size}, the farthest at the fp32 "
                f"top-two gap {(top[:, -1] - top[:, -2]).max() if flips.any() else 0.0:.3g}")
    if err_k.max() > BF16_MARGIN * err_p.max() + 1e-3 or err_k.mean() > BF16_MARGIN * err_p.mean() + 1e-4:
        raise AssertionError(
            f"{label}: the kernel's bf16 forward is further from fp32 than {BF16_MARGIN}x the plain conv's"
        )
    dp = np.abs(probs - plain)
    log(f"{label} bf16 kernel vs bf16 plain conv: max|dp| {dp.max():.4g} (bound {PLAIN_MAX_DP}), "
        f"mean|dp| {dp.mean():.3g} (bound {PLAIN_MEAN_DP})")
    if dp.max() > PLAIN_MAX_DP or dp.mean() > PLAIN_MEAN_DP:
        raise AssertionError(f"{label}: the kernel's probabilities disagree with the plain conv's")
    return probs


def profile(work: str, server, card: str) -> None:
    """Where a warm 128³ case's time goes, on ``server``'s
    resident model. Host decode, device path and mask write of one case,
    each alone (medians of 5); the device time of PROFILE_FORWARDS
    forwards per kernel (torch.profiler); warm run_once of PROFILE_CASES
    128³ cases, unprofiled for vol/s, then profiled for the card's idle
    share (1 − the union of device activity over run_once's span)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as torch_profile

    predictor = server.predictor
    inbox, outbox = os.path.join(work, "profile_inbox"), os.path.join(work, "profile_outbox")
    source = min(CASES, key=lambda c: math.prod(CASES[c]))  # a whole-volume case
    for i in range(PROFILE_CASES):
        shutil.copytree(os.path.join(work, "inbox", source), os.path.join(inbox, f"case_{i}"))
    case = os.path.join(inbox, "case_0")

    def median_ms_host(fn, n=5):
        times = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times)[n // 2]

    image, reference = predictor.load_case(case)
    mask = predictor.predict_mask(image)
    probe = os.path.join(work, "probe", "segmentation.nii.gz")
    decode = median_ms_host(lambda: predictor.load_case(case))
    device_path = median_ms_host(lambda: predictor.predict_mask(image))
    write = median_ms_host(lambda: predictor.save_mask(mask, reference, probe))
    log(f"profile, one {CASES[source]} case alone: host decode + normalize {decode:.1f} ms, device path "
        f"{device_path:.1f} ms, mask write {write:.1f} ms [{card}]")

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch_profile(activities=activities) as prof:
        for _ in range(PROFILE_FORWARDS):
            predictor.predict_mask(image)
    kernels = {}  # device activity (kernels, copies) by name: [us, count]
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = kernels.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.end - e.time_range.start
            row[1] += 1
    if not kernels:
        raise AssertionError("torch.profiler recorded no device time")
    rows = sorted(((us, count, name) for name, (us, count) in kernels.items()), reverse=True)
    per = 1e3 * PROFILE_FORWARDS
    conv_us = sum(us for us, _, name in rows if "conv3x3x3" in name or "splitk" in name)
    log(f"profile, device time per device path: {sum(r[0] for r in rows) / per:.3f} ms, of "
        f"which the conv kernel {conv_us / per:.3f} ms [{card}]")
    for us, count, key in rows[:16]:
        log(f"  {us / per:8.3f} ms  {count / PROFILE_FORWARDS:5.1f}x  {key[:110]}")

    server.input_root, server.output_dir = inbox, outbox
    done = server.stats["done"]
    t0 = time.perf_counter()
    stats = server.run_once()
    wall = time.perf_counter() - t0
    if stats["done"] - done != PROFILE_CASES:
        raise AssertionError(f"profile serve stats {stats}, {done} done before")
    shutil.rmtree(outbox)
    with torch_profile(activities=activities) as prof:
        with record_function("profile_run_once"):
            server.run_once()
    events = prof.events()
    span = next(e.time_range for e in events
                if e.name == "profile_run_once" and e.device_type == DeviceType.CPU)
    busy, end = 0.0, span.start
    for lo, hi in sorted(
        (max(e.time_range.start, span.start), min(e.time_range.end, span.end)) for e in events
        if e.device_type == DeviceType.CUDA and e.name != "profile_run_once"
    ):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device activity in run_once")
    log(f"profile, warm run_once of {PROFILE_CASES} such cases: {PROFILE_CASES / wall:.3f} vol/s "
        f"unprofiled; profiled: card idle {1 - busy / (span.end - span.start):.3f} of "
        f"{(span.end - span.start) / 1e3:.1f} ms [{card}]")


# ---- the training path (slice 2) ------------------------------------------------

# the 17 dx convs: B1 on the flipped, transposed weight (Ci <-> Co), every
# conv but the input conv, whose input (the image) needs no gradient
DX_SHAPES = tuple((co, ci, s, layers) for ci, co, s, layers in CONV_SHAPES if ci % 8 == 0)
# B2 against the plain version in fp32 from the same bf16 inputs: fp32 sums
# of up to 2.1 M bf16 products each, in another order
DW_BOUND = 2e-3
# the conv Function's dW in the model against float64, per element, relative
# to Σ|x·dy| (the scale of an fp32 sum's rounding). On an H100 B2 reads
# 6.4e-7 (the gradients phase), 1.3e-6 (cache (c)), 2.07e-6 (kclass,
# GroupNorm) and 1.0e-7 (the fp16 step, whose dy is all zero or subnormal:
# 2.2e-5 before the fp16 entry point scaled dy by 2^k); the bound is 2x the
# worst. The plain fp32 version reads up to 9.3e-5 (kclass), so the
# reference is float64. One tensor-core chain a split-K slice loses up to
# 5.4e-4 of a same-sign sum (dw_sum); a missing corner tap is 7.7e-3.
DW_SUM_BOUND = 4e-6
# the flagship training configuration (bench.py:47-60): batch 4 as 4
# accumulated microbatches of 1, no remat, 128^3, bf16, Dice, Adam 1e-4
SIZE = 128
TRAIN = dict(batch_size=4, accum_steps=4, remat=False, target_size=(SIZE,) * 3,
             compute_dtype="bfloat16", loss="dice", learning_rate=1e-4, num_epochs=2)
TRAIN_CASES = 5  # 4 train, 1 val (val_fraction 0.2)
TIME_STEPS = 5
# the kernel path's bf16 gradient may be at most this many times further
# from the fp32 gradient than the plain conv's bf16 gradient is, plus an
# absolute slack on the relative errors for near-equal ones
GRAD_SLACK = 1e-3


def check_dw_kernels(device, card: str, slab: bool = False, tp: int = 1, dtype=None) -> dict:
    """B2 against its plain version at the 14 shapes (N=1, bf16 inputs, fp32
    reference with TF32 off), two launches bitwise equal; median times of
    the kernel, the plain version and cuDNN's weight gradient alone. With
    ``slab``, at a D-slab's shape with its halo, dy zero on the halo slices
    as the sharded conv's backward gives it. With ``tp`` > 1, at one
    output-channel shard's shape: the whole Ci, Co / tp. Operands bf16, or
    ``dtype`` (as in check_kernels)."""
    import torch

    from pcmseg_tpu_torch.ops.kernels import conv3d_grad

    dtype, rel, tag = operand_dtype(dtype)
    max_err, rows = 0.0, []
    g = torch.Generator(device=device).manual_seed(1)
    for ci, co, s, layers in CONV_SHAPES:
        d, co = slab_depth(s, slab), co // tp
        x = torch.randn((1, d, s, s, ci), generator=g, device=device).to(dtype)
        dy = torch.randn((1, d, s, s, co), generator=g, device=device).to(dtype)
        if slab:
            dy[:, 0] = dy[:, -1] = 0
        got = conv3d_grad.conv3x3_dw(x, dy)
        again = conv3d_grad.conv3x3_dw(x, dy)
        torch.cuda.synchronize()
        ref = conv3d_grad.conv3x3_dw_reference(x.float(), dy.float())
        err = (got - ref).abs().max().item()
        bound = rel * DW_BOUND * ref.abs().max().item()
        if not bool(torch.isfinite(got).all()) or err > bound:
            raise AssertionError(f"{tag}dW {ci}->{co} @{d}x{s}^2: kernel disagrees with the plain version "
                                 f"(max err {err:.4g}, bound {bound:.4g})")
        if not torch.equal(got, again):
            raise AssertionError(f"{tag}dW {ci}->{co} @{d}x{s}^2: two launches differ")
        max_err = max(max_err, err)
        del got, again, ref
        k_ms = median_ms(lambda: conv3d_grad.conv3x3_dw(x, dy))
        p_ms = median_ms(lambda: conv3d_grad.conv3x3_dw_reference(x, dy))
        xc, dyc = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
        c_ms = median_ms(lambda: torch.nn.grad.conv3d_weight(xc, (co, ci, 3, 3, 3), dyc, padding=1))
        least, flop, ops = conv_bound(ci, co, s, dw=True, depth=d)
        log(f"{tag}dW {ci}->{co} @{d}x{s}^2 x{layers}: ok, max_abs_err {err:.4g} (bound {bound:.4g}), bitwise "
            f"repeat; {shape_line(k_ms, least, flop)}, plain {p_ms:.4f} ms, cudnn wgrad alone {c_ms:.4f} ms [{card}]")
        rows.append((layers, k_ms, p_ms, c_ms, least, least if ops else 0.0))
        del x, dy
    out = {"max_abs_err": max_err, **summed(rows)}
    log(f"{tag}dW, 18 layers of one 128^3 microbatch{shape_note(slab, tp)}: kernel {out['ms']:.3f} ms, "
        f"plain {out['plain_ms']:.3f} ms, "
        f"cudnn wgrad alone {out['library_ms']:.3f} ms, bound {out['bound_ms']:.3f} ms [{card}]")
    return out


def check_dx_kernels(device, card: str, slab: bool = False, tp: int = 1, dtype=None) -> dict:
    """B1 as dx (relu off, no bias) at the 17 transposed shapes, N=1, against
    its plain version, with B1's bound; median times of the kernel, the
    plain version and cuDNN's data gradient alone. With ``slab``, at a
    D-slab's shape with its halo, dy zero on the halo slices. With ``tp`` >
    1, on one output-channel shard of dy (its Ci is the layer's Co / tp,
    zero-padded to what the kernel reads: 32 to 64 at level 1 for tp 2);
    the bound counts the real channels. Operands bf16, or ``dtype`` (as in
    check_kernels)."""
    import torch

    from pcmseg_tpu_torch.ops.kernels import conv3d

    dtype, rel, tag = operand_dtype(dtype)
    max_err, rows = 0.0, []
    g = torch.Generator(device=device).manual_seed(2)
    for ci, co, s, layers in DX_SHAPES:
        d, ci = slab_depth(s, slab), ci // tp
        dy = torch.randn((1, d, s, s, ci), generator=g, device=device).to(dtype)
        if slab:
            dy[:, 0] = dy[:, -1] = 0
        w = torch.randn((ci, co, 3, 3, 3), generator=g, device=device) * math.sqrt(2.0 / (27 * ci))
        packed = conv3d.pack_weight(w.flip(2, 3, 4).transpose(0, 1), dtype)
        plan = check_b1_plan(1, d, s, ci, co, f"{tag}dx {ci}->{co} @{d}x{s}^2")
        got = b1_twice(dy, packed, None, False, f"{tag}dx {ci}->{co} @{d}x{s}^2")
        torch.cuda.synchronize()
        ref = conv3d.conv3x3x3_reference(dy.float(), packed.float(), None, False)
        err = (got.float() - ref).abs()
        bound = rel * (8e-3 * ref.abs() + 1e-3 * ref.abs().max())
        if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
            raise AssertionError(f"{tag}dx {ci}->{co} @{d}x{s}^2: kernel disagrees with the plain version "
                                 f"(max err {err.max().item():.4g})")
        max_err = max(max_err, err.max().item())
        del got, ref, err, bound
        k_ms = median_ms(lambda: conv3d.conv3x3x3(dy, packed, None, False))
        p_ms = median_ms(lambda: conv3d.conv3x3x3_reference(dy, packed, None, False))
        # cuDNN's data gradient of the layer (ci <- co here), as autograd
        # calls it: the layer's own weight and a real channels-last input
        w_bf = w.to(dtype).contiguous(memory_format=torch.channels_last_3d)
        dyc = dy.permute(0, 4, 1, 2, 3)
        xc = torch.empty((1, d, s, s, co), dtype=dtype, device=device).permute(0, 4, 1, 2, 3)
        c_ms = median_ms(lambda: torch.ops.aten.convolution_backward(
            dyc, xc, w_bf, None, (1, 1, 1), (1, 1, 1), (1, 1, 1), False, (0, 0, 0), 1, (True, False, False)))
        bound, flop, ops = conv_bound(ci, co, s, depth=d)
        log(f"{tag}dx {ci}->{co} @{d}x{s}^2 x{layers}: ok, bitwise repeat, {plan_note(plan)}; "
            f"{shape_line(k_ms, bound, flop)}, plain {p_ms:.4f} ms, "
            f"cudnn dgrad alone {c_ms:.4f} ms [{card}]")
        rows.append((layers, k_ms, p_ms, c_ms, bound, bound if ops else 0.0))
        del dy, w, packed, w_bf, dyc, xc
    out = {"max_abs_err": max_err, **summed(rows)}
    log(f"{tag}dx, 17 layers of one 128^3 microbatch{shape_note(slab, tp)}: kernel {out['ms']:.3f} ms, "
        f"plain {out['plain_ms']:.3f} ms, "
        f"cudnn dgrad alone {out['library_ms']:.3f} ms, bound {out['bound_ms']:.3f} ms [{card}]")
    return out


# B2 on same-sign inputs (x, dy = |normal|), where every dW element is its
# own Σ|x·dy|: each element's relative error from float64 is what the
# kernel's fp32 summation loses. The tensor cores' fp32 sums lose about
# 2^-23 of the running sum a k16 step (SLICE_STEP_LOSS: the chain model
# that predicts the loss of one chain over a whole split-K slice); the
# kernel cuts every tensor-core chain to conv3d_grad.dw_plan's chain_steps
# and adds the chains in FADDs
DW_SAME_SIGN_BOUND = 2e-5
SLICE_STEP_LOSS = 2.0**-23
# B1 at its longest chains (conv3d.conv_plan's chain_steps, at most 432 k16
# steps), as forwards on same-sign inputs: their error in units of the
# 16-bit output's last place
B1_SAME_SIGN = ((512, 256, 32), (1024, 512, 16))


# fp16 dy spanning 26 binades, dy = |normal|·2^-U with U uniform in [lo, hi]
# (label, lo, hi): from the top of fp16's range (40% of dy subnormal), and
# from where the fp16 step's dy lies (no loss scaling: 89-92% zero, the rest
# subnormal at 2^-24..2^-21 at the 8^3 bottleneck); x = |normal|; same-sign
# and mixed-sign dy
DW_RANGE_DRAWS = (("wide", 0, 26), ("underflowing", 22, 48))
DW_RANGE_SHAPES = tuple((ci, co, s) for ci, co, s, _ in CONV_SHAPES if co >= 256)
# channel-blocked fp16 dy at the shapes with two or more 64-channel blocks:
# the first block |normal|·2^DW_BLOCKED_TOP (max|dy| near 2^13, where one
# exponent for the whole tensor is 0-2), every other channel subnormal,
# m·2^-24 with m in [1, hi) for (label, hi) in DW_BLOCKED_LOW: 2^-24..2^-21
# as the fp16 step's dy at 8^3 (3 significant bits: no product loses one
# in the tensor cores' alignment, with or without a scale), and every
# subnormal (10 bits)
DW_BLOCKED_SHAPES = tuple((ci, co, s) for ci, co, s, _ in CONV_SHAPES if co >= 128)
DW_BLOCKED_TOP = 11
DW_BLOCKED_LOW = (("2^-24..2^-21", 8), ("2^-24..2^-14", 1024))
# B2 on such dy: each element within DW_RANGE_BOUND·Σ|x·dy| of float64 (2x
# the worst reading on an H100, 2.33e-6, of the wide same-sign draw, whose
# tensor-core chains lose as same-sign sums do). B2 on the unscaled fp16 dy
# (before the kernel scaled it by 2^k) lost 8.4e-6 at 512->1024 @8^3 on the
# underflowing same-sign draw, and 2.2e-5 on the fp16 step's own dy
DW_RANGE_BOUND = 4.6e-6
# B1 as dx on such dy against float64: one fp16 unit of the output (its last
# place; 2^-24 below 2^-14) plus DX_RANGE_SUM·Σ|w·dy| (the fp32 sum's error;
# 2x the worst reading, 1.01e-6)
DX_RANGE_SUM = 2e-6


def fp16_unit(exact):
    """The last place of the fp16 value nearest each float64 ``exact``:
    2^(e - 11) for |exact| in [2^(e-1), 2^e) at or above 2^-14, else fp16's
    least subnormal 2^-24."""
    import torch

    ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact).exponent - 11)
    return torch.where(exact.abs() >= F16_NORMAL, ulp, torch.full_like(exact, 2.0**-24))


def dw_range(device, card: str) -> float:
    """fp16 B2 at DW_RANGE_SHAPES on dy from DW_RANGE_DRAWS, same-sign and
    mixed-sign: each element within DW_RANGE_BOUND·Σ|x·dy| of a float64
    conv of the same fp16 inputs; B1 as dx on the same dy within one fp16
    unit plus DX_RANGE_SUM·Σ|w·dy| of float64 (``fp16_unit``); then
    ``dw_blocked``. Returns the worst B2 error over Σ|x·dy|."""
    import torch

    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad

    f16 = torch.float16
    g = torch.Generator(device=device).manual_seed(8)
    worst = 0.0
    for ci, co, s in DW_RANGE_SHAPES:
        x = torch.randn((1, s, s, s, ci), generator=g, device=device).abs_().to(f16)
        w = torch.randn((co, ci, 3, 3, 3), generator=g, device=device) * math.sqrt(2.0 / (27 * co))
        w_t = conv3d.pack_weight(w.flip(2, 3, 4).transpose(0, 1), f16)
        for label, lo, hi in DW_RANGE_DRAWS:
            u = lo + (hi - lo) * torch.rand((1, s, s, s, co), generator=g, device=device)
            mag = torch.randn((1, s, s, s, co), generator=g, device=device).abs_() * torch.exp2(-u)
            for signs in ("same-sign", "mixed-sign"):
                dy = (mag if signs == "same-sign" else mag * (torch.rand(mag.shape, generator=g, device=device)
                                                             < 0.5).mul(2).sub(1)).to(f16)
                zero = (dy == 0).double().mean().item()
                sub = ((dy != 0) & (dy.abs() < F16_NORMAL)).double().mean().item()
                got = conv3d_grad.conv3x3_dw(x, dy)
                exact = conv3d_grad.conv3x3_dw_reference(x.double(), dy.double())
                scale = conv3d_grad.conv3x3_dw_reference(x.double(), dy.double().abs()).clamp_min(1e-300)
                err = ((got.double() - exact).abs() / scale).max().item()
                del got, exact, scale
                dx = conv3d.conv3x3x3(dy, w_t, None, False)
                exact = conv3d.conv3x3x3_reference(dy.double(), w_t.double(), None, False)
                sums = conv3d.conv3x3x3_reference(dy.double().abs(), w_t.double().abs(), None, False)
                over = (dx.double() - exact).abs() - fp16_unit(exact)
                dx_err = (over / sums.clamp_min(1e-300)).max().item()
                units = ((dx.double() - exact).abs() / fp16_unit(exact)).max().item()
                log(f"dw_sum fp16 B2 {ci}->{co} @{s}^3, {label} {signs} dy (U in [{lo}, {hi}]: {zero:.3f} zero, "
                    f"{sub:.3f} subnormal): max error {err:.3g}·Σ|x·dy| (bound {DW_RANGE_BOUND}); B1 dx: max "
                    f"{units:.3g} fp16 units, beyond one unit {max(dx_err, 0.0):.3g}·Σ|w·dy| (bound {DX_RANGE_SUM}) "
                    f"[{card}]")
                if not err <= DW_RANGE_BOUND:
                    raise AssertionError(f"fp16 dW {ci}->{co} @{s}^3 on {label} {signs} dy: {err:.3g}·Σ|x·dy| from "
                                         f"float64 (bound {DW_RANGE_BOUND})")
                if not dx_err <= DX_RANGE_SUM or not bool(torch.isfinite(dx).all()):
                    raise AssertionError(f"fp16 dx {co}->{ci} @{s}^3 on {label} {signs} dy: {dx_err:.3g}·Σ|w·dy| "
                                         f"beyond one fp16 unit (bound {DX_RANGE_SUM})")
                worst = max(worst, err)
                del dy, dx, exact, sums, over
            del u, mag
        del x, w, w_t
    return max(worst, dw_blocked(device, card))


def dw_blocked(device, card: str) -> float:
    """fp16 B2 at DW_BLOCKED_SHAPES on channel-blocked dy (DW_BLOCKED_TOP,
    DW_BLOCKED_LOW), same-sign and mixed-sign: each element within
    DW_RANGE_BOUND·Σ|x·dy| of a float64 conv of the same fp16 inputs. One
    exponent for the whole of dy leaves the subnormal blocks subnormal; each
    block's own chains lift them. Returns the worst error over Σ|x·dy|."""
    import torch

    from pcmseg_tpu_torch.ops.kernels import conv3d_grad

    f16 = torch.float16
    g = torch.Generator(device=device).manual_seed(9)
    worst = 0.0
    for ci, co, s in DW_BLOCKED_SHAPES:
        x = torch.randn((1, s, s, s, ci), generator=g, device=device).abs_().to(f16)
        for low, hi in DW_BLOCKED_LOW:
            mag = torch.randint(1, hi, (1, s, s, s, co), generator=g, device=device).double() * 2.0**-24
            mag[..., :64] = torch.randn((1, s, s, s, 64), generator=g, device=device).abs().double() * 2.0**DW_BLOCKED_TOP
            for signs in ("same-sign", "mixed-sign"):
                sign = 1.0 if signs == "same-sign" else (torch.rand(mag.shape, generator=g, device=device) < 0.5) * 2.0 - 1
                dy = (mag * sign).to(f16)
                got = conv3d_grad.conv3x3_dw(x, dy).double()
                exact = conv3d_grad.conv3x3_dw_reference(x.double(), dy.double())
                scale = conv3d_grad.conv3x3_dw_reference(x.double(), dy.double().abs()).clamp_min(1e-300)
                rel = (got - exact).abs() / scale
                err, sub_err = rel.max().item(), rel[..., 64:].max().item()
                log(f"dw_sum fp16 B2 {ci}->{co} @{s}^3, channel-blocked {signs} dy (max|dy| "
                    f"{dy[..., :64].abs().max().item():.6g} in channels 0-63, the rest subnormal in {low}): max "
                    f"error {err:.3g}·Σ|x·dy| (bound {DW_RANGE_BOUND}), {sub_err:.3g} in the subnormal channels "
                    f"[{card}]")
                if not bool(torch.isfinite(got).all()) or not err <= DW_RANGE_BOUND:
                    raise AssertionError(f"fp16 dW {ci}->{co} @{s}^3 on channel-blocked {signs} dy ({low}): "
                                         f"{err:.3g}·Σ|x·dy| from float64 (bound {DW_RANGE_BOUND})")
                worst = max(worst, err)
                del dy, got, exact, scale, rel
            del mag
        del x
    return worst


def dw_sum(device, card: str) -> dict:
    """B2 at the 14 shapes (N=1) in bf16 and fp16 on same-sign inputs, each
    element within DW_SAME_SIGN_BOUND·Σ|x·dy| of a float64 conv of the same
    rounded inputs; beside it the plain fp32 version's error, the longest
    tensor-core chain (``conv3d_grad.dw_plan``) and the error the chains of
    a whole split-K slice were predicted to lose (SLICE_STEP_LOSS a step);
    ``dw_plan``'s workspace bytes equal to the C workspace functions'. Then
    B1 forwards at B1_SAME_SIGN on same-sign inputs, error from float64 in
    ulps of the output (max, mean signed, the share not correctly rounded),
    measured only. First the fp16 range case (``dw_range``), and the fp16
    dy scale's exponent, ``conv3d_grad.f16_scale_exponent``, equal to the C
    function's at every fp16 magnitude. Returns {dtype name: worst B2
    same-sign error, "fp16_range": worst B2 error of ``dw_range``}."""
    import torch

    from pcmseg_tpu_torch.ops.kernels import build, conv3d, conv3d_grad

    worst = {"fp16_range": dw_range(device, card)}
    lib = build.load_library()
    index = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    bits = torch.arange(0x8000, dtype=torch.int32)
    values = bits.to(torch.int16).view(torch.float16).double().tolist()
    wrong = [b for b, v in zip(bits.tolist(), values)
             if lib.pcmseg_f16_scale_exponent(b) != conv3d_grad.f16_scale_exponent(v)]
    if wrong:
        raise AssertionError(f"f16_scale_exponent differs from the C function's at fp16 bits {wrong[:8]}")
    g = torch.Generator(device=device).manual_seed(7)
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float16, "fp16")):
        worst[name] = 0.0
        for ci, co, s, _ in CONV_SHAPES:
            plan = conv3d_grad.dw_plan(1, s, s, s, ci, co, sms)
            c_bytes = lib.pcmseg_conv3x3_dw_workspace_bytes(1, s, s, s, plan["ci"], co, index)
            if c_bytes != plan["workspace_bytes"]:
                raise AssertionError(f"{name} dW {ci}->{co} @{s}^3: dw_plan's workspace {plan['workspace_bytes']} "
                                     f"bytes, the kernel's {c_bytes}")
            x = torch.randn((1, s, s, s, ci), generator=g, device=device).abs_().to(dtype)
            dy = torch.randn((1, s, s, s, co), generator=g, device=device).abs_().to(dtype)
            got = conv3d_grad.conv3x3_dw(x, dy)
            exact = conv3d_grad.conv3x3_dw_reference(x.double(), dy.double())  # = Σ|x·dy|, each element
            rel = (got.double() - exact) / exact
            err = rel.abs().max().item()
            plain = ((conv3d_grad.conv3x3_dw_reference(x.float(), dy.float()).double() - exact) / exact).abs().max()
            slice_steps = plan["tiles_per_split"] * conv3d_grad.DW_STEPS_PER_TILE
            log(f"dw_sum {name} dW {ci}->{co} @{s}^3, same-sign: max error {err:.3g}·Σ|x·dy| (mean "
                f"{rel.mean().item():.3g}; bound {DW_SAME_SIGN_BOUND}), chains of {plan['chain_steps']} k16 steps in "
                f"{plan['splits']} splits (one chain a split, {slice_steps} steps, predicted "
                f"{slice_steps * SLICE_STEP_LOSS:.3g}); "
                f"plain fp32 {plain.item():.3g}; workspace {c_bytes} bytes [{card}]")
            if not bool(torch.isfinite(got).all()) or not err <= DW_SAME_SIGN_BOUND:
                raise AssertionError(f"{name} dW {ci}->{co} @{s}^3 on same-sign inputs: {err:.3g}·Σ|x·dy| from "
                                     f"float64 (bound {DW_SAME_SIGN_BOUND})")
            worst[name] = max(worst[name], err)
            del x, dy, got, exact, rel
        for ci, co, s in B1_SAME_SIGN:
            x = torch.randn((1, s, s, s, ci), generator=g, device=device).abs_().to(dtype)
            w = torch.randn((co, ci, 3, 3, 3), generator=g, device=device).abs_() * math.sqrt(2.0 / (27 * ci))
            packed = conv3d.pack_weight(w, dtype)
            got = conv3d.conv3x3x3(x, packed, None, False)
            exact = conv3d.conv3x3x3_reference(x.double(), packed.double(), None, False)
            # the output's last place: 2^(e - p) for exact = m·2^e, m in [0.5, 1), p significand bits
            bits = round(-math.log2(torch.finfo(dtype).eps)) + 1
            ulp = torch.ldexp(torch.ones_like(exact), torch.frexp(exact).exponent - bits)
            off = (got.double() - exact) / ulp
            plan = check_b1_plan(1, s, s, ci, co, f"dw_sum {name} B1 {ci}->{co} @{s}^3")
            log(f"dw_sum {name} B1 {ci}->{co} @{s}^3 forward ({plan['splits']} splits, chains of "
                f"{plan['chain_steps']} k16 steps), same-sign: error from float64 max "
                f"{off.abs().max().item():.3g} ulp, mean {off.mean().item():.3g} ulp (the fp32 sum's bias; one "
                f"rounding adds at most 0.5), {(got != exact.to(dtype)).float().mean().item():.3g} of the outputs "
                f"not the correctly rounded float64 [{card}]")
            del x, w, packed, got, exact, ulp, off
    log(f"dw_sum: worst B2 same-sign error bf16 {worst['bf16']:.3g}, fp16 {worst['fp16']:.3g}, fp16 range case "
        f"{worst['fp16_range']:.3g}·Σ|x·dy|; f16_scale_exponent equal to the C function's at all 32768 magnitudes "
        f"[{card}]")
    return worst


def fp32_error(got, ref64, plain, what: str) -> float:
    """The fp32 kernel's max |error| from the float64 ``ref64``, checked
    against FP32_MARGIN times the plain fp32 version's plus FP32_SLACK of
    max |ref64|."""
    import torch

    err = (got.double() - ref64).abs().max().item()
    plain_err = (plain.double() - ref64).abs().max().item()
    bound = FP32_MARGIN * plain_err + FP32_SLACK * ref64.abs().max().item()
    if not bool(torch.isfinite(got).all()) or err > bound:
        raise AssertionError(f"{what}: the fp32 kernel is {err:.4g} from float64, the plain fp32 version "
                             f"{plain_err:.4g} (bound {bound:.4g})")
    log(f"{what}: max|err| from float64 {err:.4g}, plain fp32 (cuDNN, TF32 off) {plain_err:.4g}, bound {bound:.4g}")
    return err


def fp32_shape_line(k_ms: float, ci: int, co: int, s: int, dw: bool = False) -> tuple:
    """(the log text of a timed fp32 shape, its bound ms, whether the
    operations bound it, its bound ms at FFMA's rate): TFLOP/s and the share
    of the bound (3xTF32), with the FFMA bound beside it."""
    bound, flop, ops = conv_bound(ci, co, s, dw=dw, fp32=True)
    ffma = conv_bound(ci, co, s, dw=dw, fp32=True, peak=PEAK_FFMA_FLOPS)[0]
    return (f"{shape_line(k_ms, bound, flop)}, FFMA bound {ffma:.4f} ms ({ffma / k_ms:.3f} of it)",
            bound, ops, ffma)


def check_fp32_kernels(device, card: str) -> dict:
    """The fp32 operand paths of B1 (the 14 forward and the 13 dx shapes of a
    128³ base-64 microbatch's 18 and 17 layers) and B2 (its 14 shapes), at N=1, each against a
    float64 conv of the same fp32 inputs within FP32_MARGIN times the plain
    fp32 version's error (cuDNN with TF32 off) plus FP32_SLACK; B2's two
    launches bitwise equal. Median times of the kernel, the plain version
    and cuDNN's call alone (conv, dgrad, wgrad), TFLOP/s and the share of
    the bound (3xTF32, with FFMA's beside it). Then the FP32_CONTRACT
    shapes, each of the three within the same bound, untimed. Returns
    {"fwd", "dx", "dw"}: the JSON record's numbers of each (the model's
    shapes), ``ffma_bound_ms`` among them."""
    import torch
    import torch.nn.functional as F

    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad

    g = torch.Generator(device=device).manual_seed(3)
    f32 = torch.float32
    out = {}
    max_err, rows, ffma = 0.0, [], 0.0
    for ci, co, s, layers in CONV_SHAPES:
        x = torch.randn((1, s, s, s, ci), generator=g, device=device)
        w = torch.randn((co, ci, 3, 3, 3), generator=g, device=device) * math.sqrt(2.0 / (27 * ci))
        b = torch.randn((co,), generator=g, device=device) * 0.1
        packed = conv3d.pack_weight(w, f32)
        got = conv3d.conv3x3x3(x, packed, b, True)
        torch.cuda.synchronize()
        ref = conv3d.conv3x3x3_reference(x.double(), packed.double(), b, True)
        plain = conv3d.conv3x3x3_reference(x, packed, b, True)
        max_err = max(max_err, fp32_error(got, ref, plain, f"fp32 conv {ci}->{co} @{s}^3"))
        del got, ref, plain
        k_ms = median_ms(lambda: conv3d.conv3x3x3(x, packed, b, True))
        p_ms = median_ms(lambda: conv3d.conv3x3x3_reference(x, packed, b, True))
        w5 = conv3d.unpack_weight(packed, ci).contiguous(memory_format=torch.channels_last_3d)
        xc = x.permute(0, 4, 1, 2, 3)
        c_ms = median_ms(lambda: F.conv3d(xc, w5, padding=1))
        text, bound, ops, f = fp32_shape_line(k_ms, ci, co, s)
        ffma += layers * f
        log(f"fp32 conv {ci}->{co} @{s}^3 x{layers}: {text}, plain {p_ms:.4f} ms, cudnn conv alone {c_ms:.4f} ms [{card}]")
        rows.append((layers, k_ms, p_ms, c_ms, bound, bound if ops else 0.0))
        del x, w, b, packed, w5, xc
    out["fwd"] = {"max_abs_err": max_err, **summed(rows), "ffma_bound_ms": ffma}
    max_err, rows, ffma = 0.0, [], 0.0
    for ci, co, s, layers in DX_SHAPES:
        dy = torch.randn((1, s, s, s, ci), generator=g, device=device)
        w = torch.randn((ci, co, 3, 3, 3), generator=g, device=device) * math.sqrt(2.0 / (27 * ci))
        packed = conv3d.pack_weight(w.flip(2, 3, 4).transpose(0, 1), f32)
        got = conv3d.conv3x3x3(dy, packed, None, False)
        torch.cuda.synchronize()
        ref = conv3d.conv3x3x3_reference(dy.double(), packed.double(), None, False)
        plain = conv3d.conv3x3x3_reference(dy, packed, None, False)
        max_err = max(max_err, fp32_error(got, ref, plain, f"fp32 dx {ci}->{co} @{s}^3"))
        del got, ref, plain
        k_ms = median_ms(lambda: conv3d.conv3x3x3(dy, packed, None, False))
        p_ms = median_ms(lambda: conv3d.conv3x3x3_reference(dy, packed, None, False))
        wc = w.contiguous(memory_format=torch.channels_last_3d)
        dyc = dy.permute(0, 4, 1, 2, 3)
        xc = torch.empty((1, s, s, s, co), device=device).permute(0, 4, 1, 2, 3)
        c_ms = median_ms(lambda: torch.ops.aten.convolution_backward(
            dyc, xc, wc, None, (1, 1, 1), (1, 1, 1), (1, 1, 1), False, (0, 0, 0), 1, (True, False, False)))
        text, bound, ops, f = fp32_shape_line(k_ms, ci, co, s)
        ffma += layers * f
        log(f"fp32 dx {ci}->{co} @{s}^3 x{layers}: {text}, plain {p_ms:.4f} ms, cudnn dgrad alone {c_ms:.4f} ms [{card}]")
        rows.append((layers, k_ms, p_ms, c_ms, bound, bound if ops else 0.0))
        del dy, w, packed, wc, dyc, xc
    out["dx"] = {"max_abs_err": max_err, **summed(rows), "ffma_bound_ms": ffma}
    max_err, rows, ffma = 0.0, [], 0.0
    for ci, co, s, layers in CONV_SHAPES:
        x = torch.randn((1, s, s, s, ci), generator=g, device=device)
        dy = torch.randn((1, s, s, s, co), generator=g, device=device)
        got = conv3d_grad.conv3x3_dw(x, dy)
        again = conv3d_grad.conv3x3_dw(x, dy)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"fp32 dW {ci}->{co} @{s}^3: two launches differ")
        ref = conv3d_grad.conv3x3_dw_reference(x.double(), dy.double())
        plain = conv3d_grad.conv3x3_dw_reference(x, dy)
        max_err = max(max_err, fp32_error(got, ref, plain, f"fp32 dW {ci}->{co} @{s}^3 (bitwise repeat)"))
        del got, again, ref, plain
        k_ms = median_ms(lambda: conv3d_grad.conv3x3_dw(x, dy))
        p_ms = median_ms(lambda: conv3d_grad.conv3x3_dw_reference(x, dy))
        xc, dyc = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)
        c_ms = median_ms(lambda: torch.nn.grad.conv3d_weight(xc, (co, ci, 3, 3, 3), dyc, padding=1))
        text, bound, ops, f = fp32_shape_line(k_ms, ci, co, s, dw=True)
        ffma += layers * f
        log(f"fp32 dW {ci}->{co} @{s}^3 x{layers}: {text}, plain {p_ms:.4f} ms, cudnn wgrad alone {c_ms:.4f} ms [{card}]")
        rows.append((layers, k_ms, p_ms, c_ms, bound, bound if ops else 0.0))
        del x, dy, xc, dyc
    out["dw"] = {"max_abs_err": max_err, **summed(rows), "ffma_bound_ms": ffma}
    for label, n, d, s, ci, co, slab in FP32_CONTRACT:
        x = torch.randn((n, d, s, s, ci), generator=g, device=device)
        w = torch.randn((co, ci, 3, 3, 3), generator=g, device=device) * math.sqrt(2.0 / (27 * ci))
        b = torch.randn((co,), generator=g, device=device) * 0.1
        dy = torch.randn((n, d, s, s, co), generator=g, device=device)
        if slab:  # the halo slices' outputs are dropped: their cotangent is zero
            dy[:, 0] = dy[:, -1] = 0
        packed = conv3d.pack_weight(w, f32)
        got = conv3d.conv3x3x3(x, packed, b, True)
        torch.cuda.synchronize()
        fp32_error(got, conv3d.conv3x3x3_reference(x.double(), packed.double(), b, True),
                   conv3d.conv3x3x3_reference(x, packed, b, True), f"fp32 conv {label}")
        packed = conv3d.pack_weight(w.flip(2, 3, 4).transpose(0, 1), f32)
        got = conv3d.conv3x3x3(dy, packed, None, False)
        torch.cuda.synchronize()
        fp32_error(got, conv3d.conv3x3x3_reference(dy.double(), packed.double(), None, False),
                   conv3d.conv3x3x3_reference(dy, packed, None, False), f"fp32 dx {label}")
        got, again = conv3d_grad.conv3x3_dw(x, dy), conv3d_grad.conv3x3_dw(x, dy)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"fp32 dW {label}: two launches differ")
        fp32_error(got, conv3d_grad.conv3x3_dw_reference(x.double(), dy.double()),
                   conv3d_grad.conv3x3_dw_reference(x, dy), f"fp32 dW {label} (bitwise repeat)")
        del x, w, b, dy, packed, got, again
    for name, n in (("fwd", 18), ("dx", 17), ("dw", 18)):
        r = out[name]
        log(f"fp32 {name}, {n} layers of one 128^3 microbatch: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"cudnn alone {r['library_ms']:.3f} ms, bound (3xTF32) {r['bound_ms']:.3f} ms "
            f"({r['bound_ms'] / r['ms']:.3f} of it), FFMA bound {r['ffma_bound_ms']:.3f} ms "
            f"({r['ffma_bound_ms'] / r['ms']:.3f} of it) [{card}]")
    return out


@contextlib.contextmanager
def plain_train_conv(model, dtype):
    """Train ``model`` with the plain conv (autograd of F.conv3d) and the
    plain BatchNorm + ReLU (``batchnorm_train_reference``) in ``dtype``."""
    from pcmseg_tpu_torch.models import unet3d
    from pcmseg_tpu_torch.ops import hybrid_conv
    from pcmseg_tpu_torch.ops.kernels import batchnorm

    saved = model.dtype
    unet3d.conv3x3_train, model.dtype = hybrid_conv.conv3x3_plain, dtype
    unet3d.batchnorm_train = batchnorm.batchnorm_train_reference
    try:
        yield
    finally:
        unet3d.conv3x3_train, model.dtype = hybrid_conv.conv3x3, saved
        unet3d.batchnorm_train = batchnorm.batchnorm_train


def blob_label(shape, device):
    import torch

    z, y, x = torch.meshgrid(*[torch.linspace(-1, 1, n, device=device) for n in shape], indexing="ij")
    return ((z**2 + 2 * y**2 + x**2) < 0.3).to(torch.uint8)[..., None]


def bn_surviving_share(model):
    """Hooks on every BatchNorm of ``model`` that record, for each backward,
    the share of the cotangent that BatchNorm's backward keeps:
    ‖dy − mean(dy) − x̂·mean(dy·x̂)‖ / ‖dy‖ per layer (1: nothing cancels).
    Returns (the list it fills, the hook handles)."""
    from pcmseg_tpu_torch.models.unet3d import BatchNorm

    shares, handles = [], []

    def on_forward(module, inputs, out):
        x = inputs[0]

        def on_grad(dy):
            dims = tuple(range(x.dim() - 1))
            # the norm's own cotangent: the ReLU inside the module masks it
            xf, dyf = x.float(), (dy * (out > 0) if module.relu else dy).float()
            xh = (xf - xf.mean(dims)) * (xf.var(dims, unbiased=False) + module.eps).rsqrt()
            kept = dyf - dyf.mean(dims) - xh * (dyf * xh).mean(dims)
            shares.append((kept.norm() / dyf.norm()).item())

        out.register_hook(on_grad)

    for m in model.modules():
        if isinstance(m, BatchNorm):
            handles.append(m.register_forward_hook(on_forward))
    return shares, handles


@contextlib.contextmanager
def conv_io(model):
    """Record, for each 3^3 conv of ``model``, what its autograd Function
    saw and gave in the next forward and backward: {name: {'x', 'y', 'dy',
    'dx'}} ('dx' only where x needs a gradient; each conv's x has no other
    consumer, so its gradient is the Function's dx)."""
    from pcmseg_tpu_torch.models.unet3d import Conv3x3

    records, handles = {}, []

    def hook(name):
        def on_forward(module, inputs, out):
            rec = records.setdefault(name, {"x": inputs[0], "y": out.detach()})
            out.register_hook(lambda dy: rec.__setitem__("dy", dy))
            if inputs[0].requires_grad:
                inputs[0].register_hook(lambda dx: rec.__setitem__("dx", dx))
        return on_forward

    for name, m in model.named_modules():
        if isinstance(m, Conv3x3):
            handles.append(m.register_forward_hook(hook(name)))
    try:
        yield records
    finally:
        for h in handles:
            h.remove()


def b1_bound(ref, dtype):
    """B1's bound on each output against the plain fp32 ``ref`` of the same
    16-bit inputs: 8e-3·|ref| + 1e-3·max|ref| for bf16 (one rounding plus
    fp32 reassociation); for fp16 that scaled by F16_REL, plus fp16's least
    subnormal, the spacing of outputs below 2^-14."""
    import torch

    if dtype == torch.float16:
        return F16_REL * (8e-3 * ref.abs() + 1e-3 * ref.abs().max()) + 2.0**-24
    return 8e-3 * ref.abs() + 1e-3 * ref.abs().max()


def check_conv_function(model, records, grads, card: str, what: str = "one 128^3 microbatch") -> None:
    """Each conv's Function, as the kernel path ran it in the model: its
    forward against the plain fp32 conv of the same 16-bit x with the
    packed weight in x's dtype, within B1's bound (``b1_bound``); its dW
    (the parameter's gradient) against the float64 weight gradient of the
    same x and dy, each element within DW_SUM_BOUND·Σ|x·dy| (the plain fp32
    version's error logged beside it); its dx against the plain fp32 conv
    of dy with the flipped, transposed weight in dy's dtype, within B1's
    bound. (db is Σ dy in plain PyTorch, no kernel: the CPU tests hold it.)"""
    import torch

    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad

    worst = {"forward": (0.0, ""), "dW": (0.0, ""), "dx": (0.0, ""), "plain dW": (0.0, "")}
    for name, rec in records.items():
        conv = model.get_submodule(name)
        w = conv.weight.detach()
        x, dy = rec["x"].float(), rec["dy"].float()
        ref = conv3d.conv3x3x3_reference(x, conv.packed_weight(rec["x"].dtype).float(), conv.bias.detach(), conv.relu)
        err = (rec["y"].float() - ref).abs()
        bound = b1_bound(ref, rec["y"].dtype)
        worst["forward"] = max(worst["forward"], ((err / bound).max().item(), name))
        if not bool((err <= bound).all()):
            raise AssertionError(f"{name} ({what}): the Function's forward disagrees with the plain version "
                                 f"(worst err/bound {(err / bound).max().item():.3g})")
        del ref, err, bound
        x64, dy64 = x.double(), dy.double()
        exact = conv3d_grad.conv3x3_dw_reference(x64, dy64).permute(4, 3, 0, 1, 2)
        # Σ|x·dy| per element: the scale of an fp32 sum's rounding, which
        # |dW| is not where the products cancel (x after ReLU, dy of zero mean)
        scale = conv3d_grad.conv3x3_dw_reference(x64.abs(), dy64.abs()).permute(4, 3, 0, 1, 2).clamp_min(1e-300)
        err = ((grads[name + ".weight"] - exact).abs() / scale).max().item()
        plain = conv3d_grad.conv3x3_dw_reference(x, dy).permute(4, 3, 0, 1, 2)
        worst["plain dW"] = max(worst["plain dW"], (((plain - exact).abs() / scale).max().item(), name))
        worst["dW"] = max(worst["dW"], (err, name))
        del x64, dy64, exact, scale, plain
        if not err <= DW_SUM_BOUND:
            raise AssertionError(f"{name} ({what}): the Function's dW is {err:.3g}·Σ|x·dy| from float64 "
                                 f"(bound {DW_SUM_BOUND})")
        if "dx" in rec:
            w_t = conv3d.pack_weight(w.flip(2, 3, 4).transpose(0, 1), rec["dy"].dtype).float()
            ref = conv3d.conv3x3x3_reference(dy, w_t, None, False)
            err = (rec["dx"].float() - ref).abs()
            bound = b1_bound(ref, rec["dx"].dtype)
            worst["dx"] = max(worst["dx"], ((err / bound).max().item(), name))
            if not bool((err <= bound).all()):
                raise AssertionError(f"{name} ({what}): the Function's dx disagrees with the plain version "
                                     f"(worst err/bound {(err / bound).max().item():.3g}, max |ref| "
                                     f"{ref.abs().max().item():.3g})")
            del ref, err, bound
        del x, dy
    shapes = sorted({(r["x"].shape[-1], r["y"].shape[-1], r["x"].shape[1]) for r in records.values()},
                    key=lambda t: (-t[2], t[0], t[1]))
    log(f"conv Function in the model, {what}, {len(records)} convs ({sum('dx' in r for r in records.values())} with "
        f"dx) at (Ci, Co, size) {shapes}: forward worst err/bound {worst['forward'][0]:.3g} at "
        f"{worst['forward'][1]}, dW from float64 worst {worst['dW'][0]:.3g}·Σ|x·dy| at {worst['dW'][1]} (bound "
        f"{DW_SUM_BOUND}; the plain fp32 version's worst {worst['plain dW'][0]:.3g} at {worst['plain dW'][1]}), "
        f"dx worst err/bound {worst['dx'][0]:.3g} at {worst['dx'][1]} [{card}]")


def check_gradients(device, card: str) -> None:
    """One 128^3 microbatch through the full-width model in BN training mode.

    Under the training loss (soft Dice): each 3^3 conv's autograd Function
    as the kernel path ran it, held layer by layer against its plain
    version on the same bf16 tensors (``check_conv_function``); then the
    loss and every parameter's gradient from the kernel path (bf16), the
    plain conv (bf16) and the plain conv in fp32 (TF32 off), each 3^3 conv
    weight's kernel gradient no further from fp32 than BF16_MARGIN times
    the plain conv's (+ GRAD_SLACK). Both bf16 gradients lie far from fp32
    at this random init, so beside them: fp32 again with the input moved by
    one bf16 rounding (the gradient's own sensitivity), the same comparison
    under Σ logits·r / numel for a fixed random r, and the share of the
    cotangent each BatchNorm's backward keeps."""
    import torch

    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.ops.kernels import batchnorm, conv3d, conv3d_grad
    from pcmseg_tpu_torch.ops.losses import dice_loss

    model = UNet3D(base_features=BASE_FEATURES, generator=torch.Generator().manual_seed(5)).to(device).train()
    g = torch.Generator(device=device).manual_seed(6)
    x = torch.randn((1, SIZE, SIZE, SIZE, 5), generator=g, device=device).to(torch.bfloat16)
    label = blob_label((SIZE,) * 3, device)[None]
    r = torch.randn((1, SIZE, SIZE, SIZE, 1), generator=g, device=device)
    # x moved by one bf16 rounding (±2^-9 relative), in fp32
    x_moved = x.float() * (1 + 2.0**-9 * (2 * torch.randint(0, 2, x.shape, generator=g, device=device) - 1))
    losses = {
        "dice": lambda logits: dice_loss(logits, label),
        "random cotangent": lambda logits: (logits.float() * r).mean(),
    }

    def grads(loss_of, inp=x):
        model.zero_grad(set_to_none=True)
        loss = loss_of(model(inp))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.float().clone() for k, p in model.named_parameters()}

    for loss_name, loss_of in losses.items():
        conv3d.launches = conv3d_grad.launches = batchnorm.launches = 0
        with conv_io(model) if loss_name == "dice" else contextlib.nullcontext({}) as records:
            loss_k, g_k = grads(loss_of)
        # 18 BatchNorm layers, two launches forward and two backward each
        if (conv3d.launches, conv3d_grad.launches, batchnorm.launches) != (18 + 17, 18, 18 * 4):
            raise AssertionError(f"kernel path launched B1 {conv3d.launches}x, B2 {conv3d_grad.launches}x, "
                                 f"BatchNorm {batchnorm.launches}x; expected 35, 18 and 72")
        if loss_name == "dice":
            check_conv_function(model, records, g_k, card)
        for rec in records.values():
            rec.clear()  # a record's x holds a hook that holds the record: free it now, not at gc
        del records
        batchnorm.launches = 0
        with plain_train_conv(model, torch.bfloat16):
            loss_p, g_p = grads(loss_of)
        if batchnorm.launches:
            raise AssertionError(f"the plain arm launched {batchnorm.launches} BatchNorm kernels")
        shares, handles = bn_surviving_share(model)
        with plain_train_conv(model, torch.float32):
            loss_32, g_32 = grads(loss_of)
            for h in handles:
                h.remove()
            _, g_moved = grads(loss_of, x_moved)
        shares.sort()
        log(f"gradient check ({loss_name}), one 128^3 microbatch, base 64, BN train mode: loss kernel "
            f"{loss_k:.6g}, plain bf16 {loss_p:.6g}, fp32 {loss_32:.6g}; fp32 BatchNorm backward keeps "
            f"{shares[len(shares) // 2]:.4g} of the cotangent (median of {len(shares)} layers, least "
            f"{shares[0]:.4g}) [{card}]")
        if abs(loss_k - loss_32) > BF16_MARGIN * abs(loss_p - loss_32) + 1e-4:
            raise AssertionError(f"{loss_name}: the kernel path's loss is further from fp32 than the plain conv's")
        conv_rows, other_rows = [], []  # in forward order
        for k, ref in g_32.items():
            parts = k.split(".")
            conv = ".conv." in k and parts[-2] in ("0", "3")  # a 3^3 conv of a DoubleConv
            if conv and parts[-1] == "bias":
                continue  # BatchNorm follows: the true gradient is 0, computed values are noise
            norm = ref.norm().item()
            rel_k = (g_k[k] - ref).norm().item() / norm
            rel_p = (g_p[k] - ref).norm().item() / norm
            rel_moved = (g_moved[k] - ref).norm().item() / norm
            (conv_rows if conv else other_rows).append((rel_k / max(rel_p, 1e-12), k, rel_k, rel_p, rel_moved))
            if not math.isfinite(rel_k):
                raise AssertionError(f"{loss_name} {k}: non-finite kernel-path gradient")
        for ratio, k, rel_k, rel_p, _ in conv_rows:
            if rel_k > BF16_MARGIN * rel_p + GRAD_SLACK:
                raise AssertionError(f"{loss_name} {k}: kernel gradient rel err {rel_k:.4g} vs plain bf16 "
                                     f"{rel_p:.4g}")
        if loss_name == "dice":
            log("  dice, ||g - g32||/||g32|| of the 3^3 conv weights from the output back (kernel / plain bf16 / "
                "fp32 with x moved): " + ", ".join(f"{k[:-len('.weight')]} {rk:.3g}/{rp:.3g}/{rm:.3g}"
                                                   for _, k, rk, rp, rm in reversed(conv_rows)))
        for name, rows in (("3^3 conv weights", conv_rows), ("other parameters", other_rows)):
            rows.sort(reverse=True)
            med = [sorted(row[i] for row in rows)[len(rows) // 2] for i in (2, 3, 4)]
            log(f"  {loss_name}, {len(rows)} {name}: ||g - g32||/||g32|| median kernel {med[0]:.4g}, plain bf16 "
                f"{med[1]:.4g}, fp32 with x moved by one bf16 rounding {med[2]:.4g}; worst kernel/plain "
                f"{rows[0][0]:.3f} at {rows[0][1]} ({rows[0][2]:.4g} / {rows[0][3]:.4g}) [{card}]")
        del g_k, g_p, g_32, g_moved
    del model, x, x_moved, r
    torch.cuda.empty_cache()


def write_train_tree(root: str, modalities, n_cases: int, ext: str = ".nii.gz", n_classes: int = 1) -> None:
    """Synthetic 128^3 cases in the training layout
    ({root}/BPH-PCA/BPH/{modality}/{case}{ext}, labels under ROI(BPH+PCA)).
    With ``n_classes`` 3 the lesion's core is class 2, the rest class 1."""
    import numpy as np

    from pcmseg_tpu_torch.data.nifti import write_nifti

    rng = np.random.default_rng(3)
    shape = TRAIN["target_size"]
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32) for n in shape], indexing="ij")
    for i in range(n_cases):
        case = f"case{i:03d}"
        c = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        r2 = (z - c[0]) ** 2 + 2 * (y - c[1]) ** 2 + (x - c[2]) ** 2
        label = (r2 < 0.15).astype(np.uint8)
        if n_classes == 3:
            label[r2 < 0.05] = 2
        for j, m in enumerate(modalities):
            vol = 300 * np.exp(-3 * r2) * (1 + 0.25 * j) + rng.normal(0, 25, size=shape).astype(np.float32)
            out = os.path.join(root, "BPH-PCA", "BPH", m)
            os.makedirs(out, exist_ok=True)
            write_nifti(vol.astype(np.int16), os.path.join(out, case + ext))
        out = os.path.join(root, "BPH-PCA", "ROI(BPH+PCA)", "BPH")
        os.makedirs(out, exist_ok=True)
        write_nifti(label, os.path.join(out, case + ext))


def expected_train_launches(config, steps: int, eval_forwards: int):
    """(B1, B2) launches of ``steps`` optimizer steps and ``eval_forwards``
    validation forwards: per microbatch 18 forward (18 more recomputed under
    remat) and 17 dx convs on B1, 18 dW on B2; 18 B1 per eval forward."""
    micro = config.accum_steps
    b1_step = micro * (18 + 17 + (18 if config.remat else 0))
    return steps * b1_step + 18 * eval_forwards, steps * micro * 18


def expected_bn_launches(config, steps: int) -> int:
    """Training BatchNorm + ReLU kernel launches of ``steps`` optimizer
    steps: per microbatch and BatchNorm layer (18) two forward (two more
    recomputed under remat) and two backward; none in eval forwards."""
    return steps * config.accum_steps * 18 * (4 + (2 if config.remat else 0))


def train(work: str, device, card: str):
    """The port's training path: ``Trainer(config).train()`` for 2 epochs on
    5 synthetic 128^3 cases in the flagship configuration, then a run killed
    after epoch 1 and resumed, then one case served from ``best.pth``.
    Returns the kernel launches counted during the first run."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.ops.kernels import batchnorm, conv3d, conv3d_grad
    from pcmseg_tpu_torch.train.checkpoints import train_checkpoint_path
    from pcmseg_tpu_torch.train.trainer import Trainer

    data = os.path.join(work, "train_data")
    t0 = time.perf_counter()
    config = get_config(base_features=BASE_FEATURES, data_dir=data, save_dir=os.path.join(work, "ckpt_a"),
                        cache_dir=os.path.join(work, "preproc"), seed=0, **TRAIN)
    write_train_tree(data, config.modalities, TRAIN_CASES)
    log(f"train setup ({TRAIN_CASES} synthetic 128^3 cases written) {time.perf_counter() - t0:.1f} s")

    trainer = Trainer(config, device=device)
    if len(trainer.train_indices) != 4 or len(trainer.val_indices) != 1:
        raise AssertionError(f"split {trainer.train_indices} / {trainer.val_indices}")
    log(f"train path: {data_path(trainer, TRAIN_CASES)}")
    conv3d.launches = conv3d_grad.launches = batchnorm.launches = 0
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (conv3d.launches, conv3d_grad.launches, batchnorm.launches)
    want = (*expected_train_launches(config, steps=2, eval_forwards=2), expected_bn_launches(config, steps=2))
    log(f"trained 2 epochs in {wall:.1f} s (first epoch cold, checkpoints included): history "
        f"{json.dumps(history)}; launches B1 {launches[0]}, B2 {launches[1]}, BatchNorm {launches[2]} (expected "
        f"{want}) [{card}]")
    if launches != want:
        raise AssertionError(f"kernel launches (B1, B2, BatchNorm) {launches}, expected {want}")
    if not all(math.isfinite(v) for vals in history.values() for v in vals):
        raise AssertionError(f"non-finite history {history}")
    for name in ("latest", "best"):
        if not os.path.isfile(train_checkpoint_path(config.save_dir, name)):
            raise AssertionError(f"no {name} checkpoint")

    # killed after epoch 1, resumed: epoch 2 again, from the checkpoint
    killed = config.replace(save_dir=os.path.join(work, "ckpt_b"), num_epochs=1)
    Trainer(killed, device=device).train()
    resumed = Trainer(killed.replace(num_epochs=2, resume=True), device=device)
    if resumed.start_epoch != 1:
        raise AssertionError(f"resumed at epoch {resumed.start_epoch}")
    again = resumed.train()
    same = same_params(trainer, resumed)
    log(f"resume from latest after epoch 1: history {json.dumps(again)}; bitwise equal to the "
        f"uninterrupted run: history {again == history}, params {same} [{card}]")
    # every op of the step is deterministic on the card (the kernels' split-K
    # partials and every reduction are summed in a fixed order; no atomics)
    if again != history or not same:
        raise AssertionError("the resumed run differs from the uninterrupted one")
    del trainer, resumed
    torch.cuda.empty_cache()

    # serve one case from the best model's reference-layout .pth
    predictor = Predictor(get_config(base_features=BASE_FEATURES), os.path.join(config.save_dir, "best.pth"),
                          device=device)
    case = os.path.join(work, "serve_case")
    for m in config.modalities:
        os.makedirs(os.path.join(case, m))
        shutil.copy(os.path.join(data, "BPH-PCA", "BPH", m, "case000.nii.gz"), os.path.join(case, m, "t.nii.gz"))
    out = predictor.predict_and_save(case, os.path.join(work, "served", "segmentation.nii.gz"))
    from pcmseg_tpu_torch.data.io import read_volume

    mask = read_volume(out).data
    if mask.dtype != np.uint8 or mask.shape != TRAIN["target_size"]:
        raise AssertionError(f"served mask {mask.dtype} {mask.shape}")
    log(f"served case000 from best.pth: mask {mask.shape}, foreground {mask.mean():.4f}")
    del predictor
    torch.cuda.empty_cache()
    return launches


def profile_step(run, what: str, card: str) -> None:
    """The device time of ``run()`` by kernel (torch.profiler): B1, B2 and
    the rest, then the 14 costliest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            row = by_name.setdefault(e.name, [0.0, 0])
            row[0] += e.time_range.end - e.time_range.start
            row[1] += 1
    total = sum(us for us, _ in by_name.values())
    groups = {"B1 (forward + dx)": ("conv3x3x3", "splitk_epilogue"), "B2 (dW)": ("conv3x3_dw", "dw_reduce")}
    parts = {k: sum(us for name, (us, _) in by_name.items() if any(p in name for p in pats))
             for k, pats in groups.items()}
    log(f"profile, {what}: device time {total / 1e3:.1f} ms, of which "
        + ", ".join(f"{k} {v / 1e3:.1f} ms" for k, v in parts.items())
        + f", other {(total - sum(parts.values())) / 1e3:.1f} ms [{card}]")
    for us, count, name in sorted(((us, c, k) for k, (us, c) in by_name.items()), reverse=True)[:14]:
        log(f"  {us / 1e3:8.3f} ms  {count:4d}x  {name[:100]}")


def time_steps(device, card: str) -> tuple:
    """Median warm train-step time at the flagship configuration on one
    synthetic device batch, kernel path and plain conv, peak device memory;
    the launch counts of one step with remat on; the device time of one
    kernel step by kernel (torch.profiler). Returns the kernel step's
    medians (seconds, remat off) and one step's BatchNorm launches with
    remat off and on (``time``, ``time_remat``)."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.ops.kernels import batchnorm, conv3d, conv3d_grad
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    g = torch.Generator(device=device).manual_seed(7)
    n = TRAIN["batch_size"]
    batch = {"image": torch.randn((n, SIZE, SIZE, SIZE, 5), generator=g, device=device).to(torch.bfloat16),
             "label": blob_label((SIZE,) * 3, device)[None].expand(n, -1, -1, -1, -1).contiguous()}
    results, bn_launches = {}, {}
    for remat in (False, True):
        config = get_config(base_features=BASE_FEATURES, **{**TRAIN, "remat": remat})
        model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
        state = create_train_state(model, config)
        step = make_train_step(model, config)
        conv3d.launches = conv3d_grad.launches = batchnorm.launches = 0
        float(step(state, batch)["loss"])
        want = expected_train_launches(config, steps=1, eval_forwards=0)
        bn_want = expected_bn_launches(config, steps=1)
        log(f"train step remat={remat}: launches B1 {conv3d.launches}, B2 {conv3d_grad.launches}, BatchNorm "
            f"{batchnorm.launches} (expected {want}, {bn_want}) [{card}]")
        if (conv3d.launches, conv3d_grad.launches) != want or batchnorm.launches != bn_want:
            raise AssertionError(f"remat={remat}: one step launched {(conv3d.launches, conv3d_grad.launches)}, "
                                 f"BatchNorm {batchnorm.launches}, expected {want}, {bn_want}")
        bn_launches["time_remat" if remat else "time"] = batchnorm.launches
        arms = (("kernel", None), ("plain", torch.bfloat16), ("kernel", None)) if not remat else (("kernel", None),)
        for arm, dtype in arms:
            ctx = plain_train_conv(model, dtype) if dtype else contextlib.nullcontext()
            with ctx:
                float(step(state, batch)["loss"])  # warm
                torch.cuda.reset_peak_memory_stats()
                times = []
                for _ in range(TIME_STEPS):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    float(step(state, batch)["loss"])
                    times.append(time.perf_counter() - t)
                peak = torch.cuda.max_memory_allocated() / 2**30
            med = sorted(times)[len(times) // 2]
            results.setdefault((arm, remat), []).append(med)
            log(f"train step remat={remat} {arm}: median {med * 1e3:.1f} ms of {TIME_STEPS} = {n / med:.3f} vol/s, "
                f"peak device memory {peak:.2f} GiB [{card}]")
        if not remat:
            profile_step(lambda: float(step(state, batch)["loss"]), "one kernel step (remat off)", card)
        del model, state, step
        torch.cuda.empty_cache()
    k = results[("kernel", False)]
    log(f"flagship step (batch 4 = 4 x 1, remat off): kernel {min(k) * 1e3:.1f}-{max(k) * 1e3:.1f} ms, "
        f"plain conv {results[('plain', False)][0] * 1e3:.1f} ms; remat on kernel "
        f"{results[('kernel', True)][0] * 1e3:.1f} ms [{card}]")
    return k, bn_launches


# the training BatchNorm + ReLU (csrc/batchnorm_relu.cu) at the 18 layers of
# a 128^3 base-64 microbatch: (layers, cubic side, channels) a level
BN_LAYERS = ((4, 128, 64), (4, 64, 128), (4, 32, 256), (4, 16, 512), (2, 8, 1024))
BN_REPS = 10
# bytes an element the four kernels move in bf16: x read by the statistics,
# x read and y written by the apply, x and dy read by the sums, x and dy
# read and dx written by dx
BN_BYTES = 16


def kernel_name(name: str) -> str:
    """A BatchNorm kernel's name without its namespace, template and arguments."""
    found = re.search(r"batchnorm_\w+_kernel", name)
    return found.group(0) if found else name


def bn_case(device, side: int, c: int, seed: int):
    """A conv output's like in bf16 (a per-channel scale and offset), γ, β
    (fp32) and a bf16 cotangent, at one level's shape."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((1, side, side, side, c), generator=g, device=device)
    x = x * (torch.rand(c, generator=g, device=device) * 2 + 0.2) + torch.randn(c, generator=g, device=device)
    gamma = torch.rand(c, generator=g, device=device) + 0.5
    beta = torch.randn(c, generator=g, device=device) * 0.3
    dy = torch.randn(x.shape, generator=g, device=device) * 1e-2
    return x.to(torch.bfloat16), gamma, beta, dy.to(torch.bfloat16)


def check_bn_outputs(x, gamma, beta, dy, what: str, card: str) -> float:
    """The kernels' y, dx, dγ, dβ, mean, unbiased variance and running
    statistics on one input, against the plain version's and float64's
    (both backwards on the kernels' ReLU mask). Held: each within twice the
    plain version's largest error from float64 of the plain version's
    value; the ReLU's mask no further from float64's rounded to x's dtype
    than the plain version's; the running statistics, moved from (0, 1),
    bit for bit the plain version's update (``momentum_update``) of the
    kernels' own mean and unbiased variance. No further from float64 than
    the plain version, as the largest and the rms error: y in every dtype
    (the plain version rounds mult, the product and the sum to it), and in
    fp32 also dx. (A 16-bit dx is the same fp32 formula rounded once on both
    sides, so which is nearer there is a tie that the last rounding breaks:
    logged, not held.) Returns the largest error from float64 of y, dx, dγ,
    dβ, the mean and the unbiased variance."""
    import torch

    from pcmseg_tpu_torch.models.unet3d import BatchNorm
    from pcmseg_tpu_torch.ops.kernels import batchnorm

    c, eps = x.shape[-1], 1e-5
    n = x.numel() // c
    kern, plain = (BatchNorm(c, relu=True).to(x.device).train() for _ in range(2))
    xin, w, b = (t.clone().requires_grad_() for t in (x, gamma, beta))
    before = batchnorm.launches
    y, mean, unbiased = batchnorm.batchnorm_train(xin, w, b, eps, relu=True, running=kern)
    y.backward(dy)
    torch.cuda.synchronize()
    if batchnorm.launches != before + 4:
        raise AssertionError(f"BatchNorm {what}: {batchnorm.launches - before} launches, expected 4")
    y, mask = y.detach(), y.detach() > 0
    got = {"y": y, "dx": xin.grad, "dgamma": w.grad, "dbeta": b.grad, "mean": mean, "unbiased": unbiased,
           "running_mean": kern.running_mean, "running_var": kern.running_var}
    y_p, mean_p, unbiased_p = batchnorm.batchnorm_train_reference(x, gamma, beta, eps, relu=True, running=plain)
    xin, w, b = (t.clone().requires_grad_() for t in (x, gamma, beta))
    batchnorm.BatchNormTrain.apply(xin, w, b, eps)[0].backward(dy * mask)
    ref = {"y": y_p, "dx": xin.grad, "dgamma": w.grad, "dbeta": b.grad, "mean": mean_p, "unbiased": unbiased_p,
           "running_mean": plain.running_mean, "running_var": plain.running_var}
    x64, g64, b64 = (t.double().requires_grad_() for t in (x, gamma, beta))
    z64, mean64, var64 = batchnorm.BatchNormTrain.apply(x64, g64, b64, eps)
    z64.backward(dy.double() * mask)
    unbiased64 = var64 * (n / (n - 1))
    exact = {"y": torch.relu(z64.detach()), "dx": x64.grad, "dgamma": g64.grad, "dbeta": b64.grad, "mean": mean64,
             "unbiased": unbiased64, "running_mean": 0.1 * mean64, "running_var": 0.9 + 0.1 * unbiased64}

    def errs(a, want):
        d = (a.double() - want).abs()
        return float(d.max()), float(d.square().mean().sqrt())

    flips = [float((m != (exact["y"].to(x.dtype) > 0)).double().mean()) for m in (mask, y_p > 0)]
    rows = {k: (errs(got[k], exact[k]), errs(ref[k], exact[k]), float((got[k].double() - ref[k].double()).abs().max()))
            for k in got}
    name = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}[x.dtype]
    log(f"BatchNorm + ReLU {what}, {name}: ReLU mask flips from float64 kernels {flips[0]:.3e}, plain "
        f"{flips[1]:.3e}; (max, rms) error from float64 kernels / plain, max |kernels - plain|: "
        + ", ".join(f"{k} ({a[0]:.6g}, {a[1]:.6g}) / ({p[0]:.6g}, {p[1]:.6g}), {d:.6g}"
                    for k, (a, p, d) in rows.items()) + f" [{card}]")
    nearer = ("y", "dx") if x.dtype == torch.float32 else ("y",)
    bad = [k for k, (_, (p_max, _), d) in rows.items() if not d <= 2 * p_max]
    bad += [k for k in nearer if not (rows[k][0][0] <= rows[k][1][0] and rows[k][0][1] <= rows[k][1][1])]
    if flips[0] > flips[1] or bad:
        raise AssertionError(f"BatchNorm {what} {name}: the kernels' {bad or 'ReLU mask'} off the plain version's")
    own = BatchNorm(c, relu=True).to(x.device)
    own.momentum_update(mean, unbiased)
    if not (torch.equal(kern.running_mean, own.running_mean) and torch.equal(kern.running_var, own.running_var)
            and int(kern.num_batches_tracked) == 1):
        raise AssertionError(f"BatchNorm {what}: the running statistics are not the plain update of the kernels' "
                             f"own mean and variance")
    return max(rows[k][0][0] for k in ("y", "dx", "dgamma", "dbeta", "mean", "unbiased"))


def bn_library(x, gamma, beta, dy):
    """The stock route to the same layer: PyTorch's SyncBatchNorm ops on the
    channels-last view of x (statistics, running update, apply), an
    in-place ReLU, its mask, and the two backward ops; fp32 sums, x in bf16.
    Returns a function that runs them once."""
    import torch

    c = x.shape[-1]
    xc, dyc = x.permute(0, 4, 1, 2, 3), dy.permute(0, 4, 1, 2, 3)  # (N, C, D, H, W), channels-last strides
    running = (torch.zeros(c, device=x.device), torch.ones(c, device=x.device))
    counts = torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)
    count_i32 = counts.to(torch.int32)

    def run():
        mean, invstd = torch.batch_norm_stats(xc, 1e-5)
        mean, invstd = torch.batch_norm_gather_stats_with_counts(xc, mean[None], invstd[None], *running, 0.1, 1e-5,
                                                                 counts)
        y = torch.batch_norm_elemt(xc, gamma, beta, mean, invstd, 1e-5).relu_()
        dz = torch.ops.aten.threshold_backward(dyc, y, 0)
        sum_dy, sum_dy_xmu, _, _ = torch.batch_norm_backward_reduce(dz, xc, mean, invstd, gamma, True, True, True)
        return torch.batch_norm_backward_elemt(dz, xc, mean, invstd, gamma, sum_dy, sum_dy_xmu, count_i32)

    return run


def bn_kernels(device, card: str) -> dict:
    """The training BatchNorm + ReLU at each level's shape of one 128^3
    microbatch in bf16, forward and backward: the outputs held against the
    plain version and float64, in bf16 and fp32 (``check_bn_outputs``); the
    four kernels' bf16 times by name, the plain version's and the stock
    library route's (``bn_library``; torch.profiler over BN_REPS passes,
    after a warm one), against the least time, BN_BYTES an element at
    PEAK_BYTES. Returns the
    18 layers' sums (ms), the kernels' time by name and the largest error
    from float64."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from pcmseg_tpu_torch.ops.kernels import batchnorm

    def device_ms(run) -> dict:
        run()
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(BN_REPS):
                run()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / BN_REPS
        return by_name

    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "other_ms": 0.0, "max_abs_err": 0.0}
    kernels = {}
    for count, side, c in BN_LAYERS:
        x, gamma, beta, dy = bn_case(device, side, c, seed=side * c + 1)
        what = f"{side}^3 x {c}"
        out["max_abs_err"] = max(out["max_abs_err"], check_bn_outputs(x, gamma, beta, dy, what, card))
        check_bn_outputs(x.float(), gamma, beta, dy.float(), what, card)

        def run_with(fn):
            def run():
                xin, w, b = (t.detach().requires_grad_() for t in (x, gamma, beta))
                fn(xin, w, b, 1e-5, relu=True)[0].backward(dy)
            return run

        kern = device_ms(run_with(batchnorm.batchnorm_train))
        plain = device_ms(run_with(batchnorm.batchnorm_train_reference))
        library = device_ms(bn_library(x, gamma, beta, dy))
        mine = {k: v for k, v in kern.items() if "batchnorm_" in k}
        bound = BN_BYTES * x.numel() / PEAK_BYTES * 1e3
        ms, plain_ms, library_ms = sum(mine.values()), sum(plain.values()), sum(library.values())
        log(f"BatchNorm + ReLU {what} bf16, forward + backward: kernels {ms:.4f} ms ({bound / ms:.3f} of the "
            f"{bound:.4f} ms bound), other device time {sum(kern.values()) - ms:.4f} ms; plain {plain_ms:.4f} ms "
            f"({len(plain)} kernels); library {library_ms:.4f} ms ({len(library)} kernels: "
            + ", ".join(f"{k[:60]} {v:.4f}" for k, v in sorted(library.items(), key=lambda kv: -kv[1]))
            + "); by kernel: " + ", ".join(f"{kernel_name(k)} {v:.4f}" for k, v in sorted(mine.items()))
            + f" [{card}]")
        out["ms"] += count * ms
        out["plain_ms"] += count * plain_ms
        out["library_ms"] += count * library_ms
        out["bound_ms"] += count * bound
        out["other_ms"] += count * (sum(kern.values()) - ms)
        for k, v in mine.items():
            kernels[kernel_name(k)] = kernels.get(kernel_name(k), 0.0) + count * v
        del x, gamma, beta, dy
        torch.cuda.empty_cache()
    log(f"BatchNorm + ReLU, the 18 layers of one 128^3 microbatch: kernels {out['ms']:.3f} ms ("
        f"{out['bound_ms'] / out['ms']:.3f} of the {out['bound_ms']:.3f} ms bound at {BN_BYTES} B an element), "
        f"other device time {out['other_ms']:.3f} ms, plain {out['plain_ms']:.3f} ms, library (SyncBatchNorm's ops "
        f"and a ReLU) {out['library_ms']:.3f} ms; by kernel "
        + ", ".join(f"{k} {v:.3f}" for k, v in sorted(kernels.items()))
        + f"; largest error from float64 {out['max_abs_err']:.4g} [{card}]")
    return {**out, "kernels_ms": kernels}


# ---- cross-validation and the Validator (slice 4) ----------------------------------

# 2 folds x 1 epoch over the 5 training cases, the flagship step otherwise
CV = dict(n_splits=2, num_epochs=1)
NATIVE_CASE = (160, 160, 144)  # tiled by 128^3 windows: 8 tiles in 2 batches of 4
NATIVE_SPACING = (0.75, 0.75, 1.5)  # (sx, sy, sz) mm: data axes (z, y, x) read (1.5, 0.75, 0.75)


@contextlib.contextmanager
def timed(owner, names, totals: dict):
    """Add the wall seconds of every call of ``owner.<name>`` to
    ``totals[name]`` (synchronising the card at the end of each call) while
    the context is open."""
    import torch

    saved = {n: getattr(owner, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                totals[name] = totals.get(name, 0.0) + time.perf_counter() - t
        return call

    for n in names:
        setattr(owner, n, wrap(n, saved[n]))
    try:
        yield totals
    finally:
        for n in names:
            setattr(owner, n, saved[n])


def cross_validate(work: str, device, card: str):
    """The port's K-fold path: ``CrossValidationTrainer(config).train()``
    over the train phase's 5 synthetic 128^3 cases, 2 folds x 1 epoch in
    the flagship configuration, with exact launch counts; then a resumed
    CrossValidationTrainer skips both completed folds and launches nothing.
    Returns (the launches of the first run, the run's save_dir)."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.data import device_cache
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.train.cv import CrossValidationTrainer
    from pcmseg_tpu_torch.train.trainer import Trainer

    config = get_config(base_features=BASE_FEATURES, data_dir=os.path.join(work, "train_data"),
                        save_dir=os.path.join(work, "cv"), cache_dir=os.path.join(work, "preproc"), seed=0,
                        **{**TRAIN, **CV})
    cv = CrossValidationTrainer(config, device=device)
    epochs, bs = config.num_epochs, config.batch_size
    want = expected_train_launches(
        config,
        steps=epochs * sum(math.ceil(len(tr) / bs) for tr, _ in cv.splits),
        eval_forwards=epochs * sum(math.ceil(len(va) / bs) for _, va in cv.splits),
    )
    totals = {}
    conv3d.launches = conv3d_grad.launches = 0
    device_cache.uploads = 0
    t0 = time.perf_counter()
    with timed(Trainer, ("train_epoch", "validate_epoch", "_save_epoch"), totals):
        results = cv.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (conv3d.launches, conv3d_grad.launches)
    log(f"  cv path: {device_cache.uploads} device-cache upload(s) of {len(cv.dataset)} cases for "
        f"{len(cv.splits)} folds, the stacks on {next(iter(cv.dataset._device_cache_memo))}")
    indexed = torch.device("cuda", torch.cuda.current_device())
    memo = cv.dataset._device_cache_memo
    same = device_cache.build_device_cache(cv.dataset, indexed) is memo[str(indexed)]  # 'cuda' is 'cuda:0'
    if device_cache.uploads != 1 or list(memo) != [str(indexed)] or not same:
        raise AssertionError(f"{device_cache.uploads} cache uploads for the folds and {indexed}, expected 1")
    log(f"cross-validation, {len(cv.splits)} folds x {epochs} epoch over {len(cv.dataset)} 128^3 cases "
        f"(train/val {[(len(tr), len(va)) for tr, va in cv.splits]}): {wall:.1f} s, of which train epochs "
        f"{totals['train_epoch']:.1f} s, validation {totals['validate_epoch']:.1f} s, checkpoint writes "
        f"{totals['_save_epoch']:.1f} s (host), the rest (fold set-up, model init, results) "
        f"{wall - sum(totals.values()):.1f} s; launches B1 {launches[0]}, B2 {launches[1]} (expected {want}) [{card}]")
    if launches != want:
        raise AssertionError(f"cross-validation launched {launches}, expected {want}")
    summary = results["summary"]
    log(f"  cv_results: mean val loss {summary['mean_val_loss']:.6g} +- {summary['std_val_loss']:.6g} over "
        f"{summary['total_folds']} folds; fold results {json.dumps(results['fold_results'])}")
    if summary["total_folds"] != 2 or not all(math.isfinite(r["best_val_loss"]) for r in results["fold_results"]):
        raise AssertionError(f"cross-validation results {results}")
    for k in range(2):
        with open(os.path.join(config.save_dir, f"fold_{k}_history.json")) as f:
            history = json.load(f)
        if not all(math.isfinite(v) for vals in history.values() for v in vals):
            raise AssertionError(f"fold {k}: non-finite history {history}")
        for name in (f"best_fold_{k}.pth", f"latest_fold_{k}.pt", f"best_fold_{k}.pt"):
            if not os.path.isfile(os.path.join(config.save_dir, name)):
                raise AssertionError(f"no {name}")
    if not os.path.isfile(os.path.join(config.save_dir, "cv_results.json")):
        raise AssertionError("no cv_results.json")

    conv3d.launches = conv3d_grad.launches = 0
    again = CrossValidationTrainer(config.replace(resume=True), device=device).train()
    log(f"  resumed CrossValidationTrainer: fold results equal {again['fold_results'] == results['fold_results']}, "
        f"launches B1 {conv3d.launches}, B2 {conv3d_grad.launches} (expected 0, 0)")
    if (conv3d.launches, conv3d_grad.launches) != (0, 0) or again["fold_results"] != results["fold_results"]:
        raise AssertionError("the resumed cross-validation did not skip both completed folds")
    del cv
    torch.cuda.empty_cache()
    return launches, config.save_dir


def write_native_tree(root: str, modalities) -> None:
    """One synthetic NATIVE_CASE case in the training layout, at
    NATIVE_SPACING: a bright ellipsoid plus noise, labelled."""
    import numpy as np

    from pcmseg_tpu_torch.data.nifti import write_nifti
    from pcmseg_tpu_torch.data.volume import Volume

    rng = np.random.default_rng(4)
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32) for n in NATIVE_CASE], indexing="ij")
    r2 = z**2 + 2 * y**2 + x**2
    for j, m in enumerate(modalities):
        vol = 300 * np.exp(-3 * r2) * (1 + 0.25 * j) + rng.normal(0, 25, size=NATIVE_CASE).astype(np.float32)
        os.makedirs(os.path.join(root, "BPH-PCA", "BPH", m))
        write_nifti(Volume(vol.astype(np.int16), spacing=NATIVE_SPACING),
                    os.path.join(root, "BPH-PCA", "BPH", m, "big000.nii.gz"))
    os.makedirs(os.path.join(root, "BPH-PCA", "ROI(BPH+PCA)", "BPH"))
    write_nifti(Volume((r2 < 0.15).astype(np.uint8), spacing=NATIVE_SPACING),
                os.path.join(root, "BPH-PCA", "ROI(BPH+PCA)", "BPH", "big000.nii.gz"))


def validate(work: str, cv_dir: str, device, card: str) -> int:
    """The Validator over the cross-validation folds: (a) ``validate()`` of
    ``best_fold_0.pth`` through the eval step (unfolded BatchNorm); the two
    folds as an ensemble with TTA on one case, held against the plain
    conv's probabilities through the same ensemble and TTA; (b) the
    ensemble with TTA, surface metrics and largest-component postprocessing;
    (c) ``validate_native()`` of the ensemble with TTA on a NATIVE_CASE
    case, tiled, surface metrics in mm. Exact launch counts in (a), (b) and
    (c): B1 as stated, B2 none. Returns the (B1, B2) launches of (a) + (b)
    + (c)."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer import validate as validate_module
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.infer.sliding_window import tile_starts
    from pcmseg_tpu_torch.infer.validate import Validator
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad

    folds = [os.path.join(cv_dir, f"best_fold_{k}.pth") for k in range(2)]
    base = get_config(data_dir=os.path.join(work, "train_data"), save_dir=os.path.join(work, "validate"),
                      cache_dir=os.path.join(work, "preproc"), batch_size=TRAIN["batch_size"])
    b1_total = b2_total = 0

    def counted(label: str, want: int, fault: str) -> None:
        """Check and add up the launches of one part, counted since the
        counts were last set to 0."""
        nonlocal b1_total, b2_total
        b1, b2 = conv3d.launches, conv3d_grad.launches
        log(f"  {label}: launches B1 {b1} (expected {want}), B2 {b2} (expected 0) [{card}]")
        if (b1, b2) != (want, 0):
            raise AssertionError(f"{label}: launched B1 {b1}x, B2 {b2}x; {fault}")
        b1_total += b1
        b2_total += b2

    # (a) one fold through the eval step
    v = Validator(base, folds[0], device=device)
    n = len(v.dataset)
    conv3d.launches = conv3d_grad.launches = 0
    t0 = time.perf_counter()
    res = v.validate()
    wall = time.perf_counter() - t0
    log(f"validate best_fold_0.pth ({n} 128^3 cases, eval step, BatchNorm unfolded): {wall:.2f} s, avg Dice "
        f"{res['avg_dice']:.4f}, per case {[round(r['dice'], 4) for r in res['case_results']]} [{card}]")
    counted("validate (a)", 18 * math.ceil(n / base.batch_size), f"results {res}")
    if res["case_count"] != n or not all(math.isfinite(r["dice"]) for r in res["case_results"]):
        raise AssertionError(f"validate: results {res}")
    image, case_id = v.dataset[0]["image"], v.dataset.case_ids[0]
    del v

    # the fold ensemble with TTA on one case, the kernel's bf16 probabilities
    # against the plain conv's and fp32's through the same ensemble and TTA.
    # After one step per fold every voxel's flip average lies above 0.5
    # (0.66-1.0 on an H100), so (a)'s mask at 0.5 is the whole volume; (b)
    # and (c) threshold at the 90th percentile, for masks that hold 10% of
    # the voxels and surface metrics that have surfaces
    cfg = base.replace(tta=True, surface_metrics=True, postprocess="largest_cc")
    ensemble = Predictor(cfg, folds, device=device)
    probs = check_probs(ensemble, image, f"{case_id} 2-fold ensemble + TTA")
    threshold = float(np.quantile(probs, 0.9))
    log(f"{case_id} ensemble + TTA probabilities {probs.min():.4f}-{probs.max():.4f}, threshold for (b) and (c) "
        f"at their 90th percentile {threshold:.4f} [{card}]")
    del ensemble
    cfg = cfg.replace(threshold=threshold)

    # (b) the fold ensemble with TTA, surface metrics and postprocessing
    v = Validator(cfg, folds, device=device)
    totals = {}
    conv3d.launches = conv3d_grad.launches = 0
    t0 = time.perf_counter()
    with timed(Predictor, ("predict_probs_batch",), totals), timed(Validator, ("_case_surface",), totals), \
            timed(validate_module, ("postprocess_from_config",), totals):
        res = v.validate()
    wall = time.perf_counter() - t0
    log(f"validate the 2-fold ensemble with TTA, largest_cc and surface metrics ({n} cases): {wall:.2f} s, of which "
        f"the ensemble's device path (H2D, 16 forwards a batch, D2H of the probabilities) "
        f"{totals['predict_probs_batch']:.2f} s, postprocess {totals['postprocess_from_config']:.2f} s (host); "
        f"avg Dice {res['avg_dice']:.4f}, avg hd95 {res['avg_hd95']} voxels [{card}]")
    log(f"  surface metrics (scipy EDT on the host, {n} 128^3 masks): {totals['_case_surface']:.2f} s [{card}]")
    for r in res["case_results"]:
        log(f"  {r['case_id']}: Dice {r['dice']:.4f}, IoU {r['iou']:.4f}, hd95 {r['hd95']}, ASSD {r['assd']}, "
            f"surface Dice {r['surface_dice']}")
    counted("validate (b)", 18 * 2 * 8 * math.ceil(n / cfg.batch_size), f"results {res}")
    if res["case_count"] != n or res["surface_units"] != "voxel":
        raise AssertionError(f"ensemble validate: results {res}")
    del v

    # (c) validate_native: the same ensemble, tiled
    native = os.path.join(work, "native_data")
    write_native_tree(native, cfg.modalities)
    v = Validator(cfg.replace(data_dir=native), folds, device=device)
    spacings = []
    real_surface = Validator._case_surface
    conv3d.launches = conv3d_grad.launches = 0
    t0 = time.perf_counter()
    Validator._case_surface = lambda self, m, lab, spacing: spacings.append(tuple(spacing)) or real_surface(self, m, lab, spacing)
    try:
        res = v.validate_native()
    finally:
        Validator._case_surface = real_surface
    wall = time.perf_counter() - t0
    tiles = len(tile_starts(NATIVE_CASE, cfg.window_size, cfg.window_overlap))
    batches = math.ceil(tiles / cfg.window_tile_batch)
    r = res["case_results"][0]
    log(f"validate_native, 2-fold ensemble + TTA, one {NATIVE_CASE} case ({tiles} tiles in {batches} batches): "
        f"{wall:.2f} s (host decode and resampling included), Dice {r['dice']:.4f}, hd95 {r['hd95']} mm, surface "
        f"spacing {spacings} [{card}]")
    counted("validate (c)", 18 * 2 * 8 * batches, f"results {res}")
    if res["surface_units"] != "mm" or r["shape"] != list(NATIVE_CASE) or spacings != [NATIVE_SPACING[::-1]]:
        raise AssertionError(f"validate_native: results {res}, spacings {spacings}")
    del v
    torch.cuda.empty_cache()
    return b1_total, b2_total


def cli(work: str, cv_dir: str, card: str) -> None:
    """``python -m pcmseg_tpu_torch check`` and ``validate`` of the fold
    glob with TTA, each in its own process, each exiting 0."""
    env = dict(os.environ, PYTHONPATH=REPO)
    data = os.path.join(work, "train_data")
    commands = {
        "check": ["check", "--data_dir", data, "--save_dir", cv_dir, "--output", os.path.join(work, "report.json")],
        "validate": ["validate", "--data_dir", data, "--model_path", os.path.join(cv_dir, "best_fold_*.pth"), "--tta",
                     "--save_dir", os.path.join(work, "cli"), "--cache_dir", os.path.join(work, "preproc"),
                     "--batch_size", str(TRAIN["batch_size"])],
    }
    for name, argv in commands.items():
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "pcmseg_tpu_torch", *argv], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=600)
        last = proc.stdout.strip().splitlines()[-1:] or [""]
        log(f"cli {name}: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s: {last[0]}")
        if proc.returncode != 0:
            raise AssertionError(f"python -m pcmseg_tpu_torch {name} exited {proc.returncode}: {proc.stderr[-2000:]}")


# ---- the device data cache and deep supervision (slice 5) ---------------------------

# 12 synthetic 128^3 cases (val_fraction 0.2: 10 train, 2 val) at the flagship step
CACHE_CASES = 12
CASE_BYTES = 128**3 * (2 * 5 + 1)  # one 128^3 5-modality case in the stacks: bf16 image, uint8 label
# (c): every augmentation on, 96^3 crops, a third of them centred on foreground
AUG = dict(data_augmentation=True, aug_scale=0.15, aug_rotate_deg=15.0, aug_gamma=0.3, aug_noise=0.1,
           aug_blur_prob=0.2, train_crop=(96, 96, 96), oversample_fg=0.33, oversample_mode="center")
# the warp, blur and gamma on the card against the CPU, same fp32 tensors
WARP = (0.2, 0.9)  # (radians, zoom)
BLUR_SIGMA = 0.8
GAMMA = 0.75
TRANSFORM_BOUND = 1e-4


def data_path(trainer, n_cases: int) -> str:
    """Which way ``trainer`` takes its batches; the stacks must be on its device."""
    if trainer._dcache is None:
        return f"streamed (all {n_cases} cases from the host every epoch)"
    images, labels = trainer._dcache["images"], trainer._dcache["labels"]
    if images.device.type != trainer.device.type or labels.device.type != trainer.device.type:
        raise AssertionError(f"cache stacks on {images.device} / {labels.device}, the step on {trainer.device}")
    kind = "partial cache" if trainer._dcache_partial else "full cache"
    return (f"{kind}, {images.shape[0]}/{n_cases} cases resident on {images.device} "
            f"({images.dtype} {tuple(images.shape)}, {labels.dtype} labels)")


def run_epochs(trainer, epochs: int) -> dict:
    """``epochs`` train and validation epochs of ``trainer`` without
    checkpoints: the history its ``train()`` would return."""
    history = {"train_loss": [], "val_loss": [], "val_dice": [], "val_iou": []}
    for _ in range(epochs):
        history["train_loss"].append(trainer.train_epoch())
        val = trainer.validate_epoch()
        for k in ("loss", "dice", "iou"):
            history["val_" + k].append(val[k])
    return history


def same_params(a, b) -> bool:
    """Whether two trainers' models are bitwise equal."""
    import torch

    return all(torch.equal(x, y) for x, y in zip(a.state.model.state_dict().values(),
                                                  b.state.model.state_dict().values()))


def idle_share(fn):
    """(fn's result, its wall seconds, the share of them in which no kernel or
    copy ran on the card, the busy ms): the union of the device intervals
    that torch.profiler records (device activity only, to keep its cost on
    the host small) against the host clock around ``fn`` and a sync."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, end = 0.0, -math.inf
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                         if e.device_type == DeviceType.CUDA):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    if busy <= 0:
        raise AssertionError("torch.profiler recorded no device activity")
    return out, wall, 1 - busy / 1e6 / wall, busy / 1e3


def cache_phase(work: str, device, card: str):
    """(a) cached against streamed, (b) the partial cache, (c) augmented
    throughput, then the transforms on the card against the CPU. Returns the
    (B1, B2) launches of (a), (b) and (c)."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.train.trainer import Trainer

    data = os.path.join(work, "cache_data")
    t0 = time.perf_counter()
    config = get_config(base_features=BASE_FEATURES, data_dir=data, save_dir=os.path.join(work, "cache_ckpt"),
                        cache_dir=os.path.join(work, "preproc"), seed=0, **TRAIN)
    write_train_tree(data, config.modalities, CACHE_CASES, ext=".nii")
    log(f"cache setup ({CACHE_CASES} synthetic 128^3 cases written) {time.perf_counter() - t0:.1f} s")
    steps = math.ceil(10 / config.batch_size)  # per epoch: 10 train cases in padded batches of 4
    launches = {}

    def counted(part: str, want) -> None:
        got = (conv3d.launches, conv3d_grad.launches)
        log(f"  cache ({part}): launches B1 {got[0]}, B2 {got[1]} (expected {want}) [{card}]")
        if got != want:
            raise AssertionError(f"cache ({part}) launched {got}, expected {want}")
        launches[part] = got

    # (a) 2 epochs from the full cache against 2 streamed epochs, the same init
    runs = {}
    for name, gb in (("streamed", 0.0), ("cached", config.device_data_cache_gb)):
        trainer = Trainer(config.replace(device_data_cache_gb=gb), device=device)
        log(f"cache (a) {name} path: {data_path(trainer, CACHE_CASES)}")
        conv3d.launches = conv3d_grad.launches = 0
        t0 = time.perf_counter()
        history = run_epochs(trainer, 2)
        torch.cuda.synchronize()
        log(f"cache (a) {name}: 2 epochs in {time.perf_counter() - t0:.2f} s (first cold), history "
            f"{json.dumps(history)} [{card}]")
        counted("a" if name == "cached" else "a, streamed", expected_train_launches(config, steps=2 * steps,
                                                                                    eval_forwards=2))
        runs[name] = (history, trainer)
    equal = runs["cached"][0] == runs["streamed"][0], same_params(runs["cached"][1], runs["streamed"][1])
    log(f"cache (a): cached epochs bitwise equal to streamed: history {equal[0]}, params {equal[1]} [{card}]")
    if not all(equal):
        raise AssertionError("the cached epochs differ from the streamed ones")
    for name, (_, trainer) in runs.items():  # a third, warm epoch of each under torch.profiler
        _, wall, idle, busy = idle_share(trainer.train_epoch)
        log(f"cache (a) {name}: a warm epoch (10 volumes, no augmentation) {wall:.3f} s = {10 / wall:.3f} vol/s "
            f"under torch.profiler, card busy {busy:.1f} ms, idle {idle:.3f} [{card}]")
    del runs, trainer
    torch.cuda.empty_cache()

    # (b) the partial cache: a budget of exactly 8 cases
    partial = config.replace(device_data_cache_gb=8 * CASE_BYTES / 1e9, save_dir=os.path.join(work, "cache_b"))
    trainer = Trainer(partial, device=device)
    log(f"cache (b) path: {data_path(trainer, CACHE_CASES)}")
    if (len(trainer._res_train), len(trainer._str_train), len(trainer._res_val), len(trainer._str_val)) != (8, 2, 0, 2):
        raise AssertionError(f"partial cache: train {trainer._res_train} / {trainer._str_train}, val "
                             f"{trainer._res_val} / {trainer._str_val}")
    seen, order = [], []
    cached_step, stream_step = trainer._cached_train_step, trainer._train_step
    row_case = {r: c for c, r in trainer._dcache_row.items()}
    ids = trainer.dataset.case_ids

    def spy_cached(state, images, labels, idx, weights, gen):
        seen.extend(ids[row_case[int(r)]] for r, w in zip(idx, weights) if w > 0)
        order.append("c")
        return cached_step(state, images, labels, idx, weights, gen)

    def spy_stream(state, batch):
        seen.extend(c for c, w in zip(batch["case_id"], batch["weight"].tolist()) if w > 0)
        order.append("s")
        return stream_step(state, batch)

    trainer._cached_train_step, trainer._train_step = spy_cached, spy_stream
    epoch_cases, epoch_s = [], []
    real_epoch = trainer.train_epoch

    def counted_epoch():
        before, t = len(seen), time.perf_counter()
        loss = real_epoch()
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t)
        epoch_cases.append(sorted(seen[before:]))
        return loss

    trainer.train_epoch = counted_epoch
    conv3d.launches = conv3d_grad.launches = 0
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want_cases = sorted(ids[i] for i in trainer.train_indices)
    log(f"cache (b): 2 epochs in {wall:.1f} s (checkpoints included; train epochs {epoch_s[0]:.3f} s cold, "
        f"{epoch_s[1]:.3f} s warm), step order {''.join(order)} (c cached, s streamed), history "
        f"{json.dumps(history)} [{card}]")
    log(f"  each train case once per epoch: {[cases == want_cases for cases in epoch_cases]}")
    if epoch_cases != [want_cases, want_cases] or order != ["c", "c", "s"] * 2:
        raise AssertionError(f"partial-cache epochs consumed {epoch_cases} in the order {order}")
    counted("b", expected_train_launches(partial, steps=2 * steps, eval_forwards=2))
    killed = partial.replace(save_dir=os.path.join(work, "cache_b_killed"), num_epochs=1)
    Trainer(killed, device=device).train()
    resumed = Trainer(killed.replace(num_epochs=2, resume=True), device=device)
    again = resumed.train()
    equal = again == history, same_params(resumed, trainer)
    log(f"cache (b): killed after epoch 1 and resumed, bitwise equal to the uninterrupted run: history "
        f"{equal[0]}, params {equal[1]} [{card}]")
    if resumed.start_epoch != 1 or not all(equal):
        raise AssertionError("the resumed partial-cache run differs from the uninterrupted one")
    del trainer, resumed
    torch.cuda.empty_cache()

    # (c) augmented throughput, cached against streamed (host scipy)
    conv3d.launches = conv3d_grad.launches = 0
    rates = {}
    for name, gb in (("cached", config.device_data_cache_gb), ("streamed", 0.0)):
        trainer = Trainer(config.replace(device_data_cache_gb=gb, **AUG), device=device)
        log(f"cache (c) {name} path: {data_path(trainer, CACHE_CASES)}")
        times, losses = [], []
        for _ in range(2):  # cold, then warm: vol/s
            t0 = time.perf_counter()
            losses.append(trainer.train_epoch())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        # a second warm epoch under torch.profiler: the idle share of its own wall time
        loss, wall, idle, busy = idle_share(trainer.train_epoch)
        losses.append(loss)
        if not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"cache (c) {name}: non-finite losses {losses}")
        rates[name] = 10 / times[1]
        log(f"cache (c) {name}, 96^3 crops, every augmentation: epochs (10 volumes) cold {times[0]:.3f} s, warm "
            f"{times[1]:.3f} s = {rates[name]:.3f} vol/s; a second warm epoch under torch.profiler {wall:.3f} s: "
            f"card busy {busy:.1f} ms, idle {idle:.3f} of that epoch; losses {losses} [{card}]")
        if name == "cached":
            check_path_convs(trainer, config.replace(**AUG), card)
            batch_device_ms(trainer, config.replace(**AUG), card)
        del trainer
        torch.cuda.empty_cache()
    log(f"cache (c): warm cached {rates['cached']:.3f} vol/s, streamed {rates['streamed']:.3f} vol/s "
        f"({rates['cached'] / rates['streamed']:.2f}x) [{card}]")
    counted("c", expected_train_launches(config, steps=2 * 3 * steps, eval_forwards=0))
    check_transforms(device, card)
    return launches


def check_path_convs(trainer, config, card: str) -> None:
    """One microbatch of ``trainer``'s cached path (rows of its stacks,
    cropped and augmented as its step does it: the 96^3 pyramid, 96^3 to the
    6^3 bottleneck) through its model in BN training mode under the Dice
    loss, each conv's forward, dx and dW held against the plain versions
    (``check_conv_function``). These launches compare and are not the
    path's: the counts are put back."""
    import torch

    from pcmseg_tpu_torch.data import device_cache
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.ops.losses import dice_loss

    saved = conv3d.launches, conv3d_grad.launches
    idx = next(iter(trainer._index_batches(trainer.train_indices, True, 0)))[0]
    img, lab = device_cache.cached_batch(trainer._dcache["images"], trainer._dcache["labels"], idx,
                                         torch.Generator().manual_seed(2), config)
    model = trainer.state.model.train()
    model.zero_grad(set_to_none=True)
    conv3d.launches = conv3d_grad.launches = 0
    with conv_io(model) as records:
        dice_loss(model(img[:1]), lab[:1]).backward()
        torch.cuda.synchronize()
    got = conv3d.launches, conv3d_grad.launches
    if got != (18 + 17, 18):
        raise AssertionError(f"one {tuple(img.shape[1:4])} microbatch launched B1 {got[0]}x, B2 {got[1]}x")
    grads = {k: p.grad.float() for k, p in model.named_parameters() if p.grad is not None}
    check_conv_function(model, records, grads, card, f"one {'x'.join(map(str, img.shape[1:4]))} microbatch of cache (c)")
    for rec in records.values():
        rec.clear()
    del records, grads, img, lab
    model.zero_grad(set_to_none=True)
    conv3d.launches, conv3d_grad.launches = saved


def batch_device_ms(trainer, config, card: str) -> None:
    """The device time of one batch's gather, crop and augmentation
    (``device_cache.cached_batch``), over 4 batches of the cached stacks."""
    import torch

    from pcmseg_tpu_torch.data import device_cache

    cache, n = trainer._dcache, 4
    gen = torch.Generator().manual_seed(1)
    batches = list(trainer._index_batches(trainer.train_indices, True, 0))
    device_cache.cached_batch(cache["images"], cache["labels"], batches[0][0], gen, config)  # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def run():
        for i in range(n):
            device_cache.cached_batch(cache["images"], cache["labels"], batches[i % len(batches)][0], gen, config)

    torch.cuda.synchronize()
    start.record()
    t0 = time.perf_counter()
    run()
    end.record()
    end.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / n
    _, _, idle, busy = idle_share(run)
    log(f"cache (c) gather + 96^3 crop + augmentation of a batch of {config.batch_size}: device busy "
        f"{busy / n:.2f} ms, CUDA-event span {start.elapsed_time(end) / n:.2f} ms, host {host:.2f} ms "
        f"(card idle {idle:.3f} of the profiled span) [{card}]")


def check_transforms(device, card: str) -> None:
    """The warp, the blur and the gamma branch at given parameters on one
    128^3 x 5 volume (fp32 values of bf16, the stacks' values) on the card
    and on the CPU: max |delta|, no NaN (the gamma's base is clamped where
    pow meets the minimum voxel)."""
    import torch

    from pcmseg_tpu_torch.data import device_cache

    g = torch.Generator().manual_seed(8)
    img = torch.randn((SIZE, SIZE, SIZE, 5), generator=g).to(torch.bfloat16).float()
    lab = blob_label((SIZE,) * 3, "cpu")
    rows = []
    cpu = device_cache._affine_warp(img, lab, *WARP)
    gpu = device_cache._affine_warp(img.to(device), lab.to(device), *WARP)
    rows.append(("warp", gpu[0].cpu(), cpu[0]))
    labels_equal = torch.equal(gpu[1].cpu(), cpu[1])
    rows.append(("blur", device_cache._separable_blur(img.to(device), BLUR_SIGMA).cpu(),
                 device_cache._separable_blur(img, BLUR_SIGMA)))
    rows.append(("gamma", device_cache._gamma(img.to(device), GAMMA).cpu(), device_cache._gamma(img, GAMMA)))
    report = []
    for name, got, want in rows:
        err = (got - want).abs().max().item()
        finite = bool(torch.isfinite(got).all())
        report.append(f"{name} max|d| {err:.3g}{'' if finite else ' NON-FINITE'}")
        if not finite or not err <= TRANSFORM_BOUND:
            raise AssertionError(f"{name} on the card: max |delta| {err:.3g} against the CPU, finite {finite}")
    log(f"transforms on the card against the CPU, one 128^3 x 5 volume (warp {WARP}, blur sigma {BLUR_SIGMA}, "
        f"gamma {GAMMA} with the minimum voxel present): {', '.join(report)}, warped labels equal {labels_equal} "
        f"(bound {TRANSFORM_BOUND}) [{card}]")
    if not labels_equal:
        raise AssertionError("the warped labels differ between the card and the CPU")


def deep_supervision(work: str, device, card: str):
    """One flagship step of a deep-supervision model, then a 1-epoch
    deep-supervision Trainer on the train phase's cases whose best.pth has
    no ds* key and serves one case. Returns the (B1, B2) launches of both."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.data.io import read_volume
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.train.checkpoints import load_pth
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step
    from pcmseg_tpu_torch.train.trainer import Trainer

    config = get_config(base_features=BASE_FEATURES, deep_supervision=True, data_dir=os.path.join(work, "train_data"),
                        save_dir=os.path.join(work, "ds_ckpt"), cache_dir=os.path.join(work, "preproc"), seed=0,
                        **{**TRAIN, "num_epochs": 1})
    model = UNet3D.from_config(config, deep_supervision=True, generator=torch.Generator().manual_seed(0)).to(device)
    state = create_train_state(model, config)
    g = torch.Generator(device=device).manual_seed(9)
    n = config.batch_size
    batch = {"image": torch.randn((n, SIZE, SIZE, SIZE, 5), generator=g, device=device).to(torch.bfloat16),
             "label": blob_label((SIZE,) * 3, device)[None].expand(n, -1, -1, -1, -1).contiguous()}
    conv3d.launches = conv3d_grad.launches = 0
    loss = float(make_train_step(model, config)(state, batch)["loss"])
    step_launches = (conv3d.launches, conv3d_grad.launches)
    heads = {f"ds{i}": getattr(model, f"ds{i}").weight.grad.abs().max().item() for i in (1, 2, 3)}
    want = expected_train_launches(config, steps=1, eval_forwards=0)
    log(f"ds: one flagship step with deep supervision: loss {loss:.6g}, launches B1 {step_launches[0]}, B2 "
        f"{step_launches[1]} (expected {want}), max |grad| of the heads {heads} [{card}]")
    if not math.isfinite(loss) or step_launches != want or not all(0 < v < math.inf for v in heads.values()):
        raise AssertionError("the deep-supervision step failed its checks")
    del model, state, batch
    torch.cuda.empty_cache()

    trainer = Trainer(config, device=device)
    conv3d.launches = conv3d_grad.launches = 0
    history = trainer.train()
    run_launches = (conv3d.launches, conv3d_grad.launches)
    want = expected_train_launches(config, steps=1, eval_forwards=1)
    sd, snapshot = load_pth(os.path.join(config.save_dir, "best.pth"))
    ds_keys = [k for k in sd if k.startswith("ds")]
    predictor = Predictor(get_config(base_features=BASE_FEATURES), os.path.join(config.save_dir, "best.pth"),
                          device=device)
    out = predictor.predict_and_save(os.path.join(work, "serve_case"), os.path.join(work, "ds_served", "seg.nii.gz"))
    mask = read_volume(out).data
    log(f"ds: 1-epoch deep-supervision Trainer: history {json.dumps(history)}, launches {run_launches} (expected "
        f"{want}); best.pth: {len(sd)} tensors, ds keys {ds_keys}, config deep_supervision "
        f"{snapshot['deep_supervision']}; served one case: mask {mask.shape}, foreground {mask.mean():.4f} [{card}]")
    if run_launches != want or ds_keys or mask.dtype != np.uint8 or mask.shape != TRAIN["target_size"]:
        raise AssertionError("the deep-supervision run failed its checks")
    del trainer, predictor
    torch.cuda.empty_cache()
    return step_launches[0] + run_launches[0], step_launches[1] + run_launches[1]


# ---- K-class heads and GroupNorm ------------------------------------------------------

# the flagship step with a 3-class head and GroupNorm (8 groups), CE + foreground Dice
KCLASS = dict(n_classes=3, norm_layer="group", loss="bce_dice", num_epochs=1)
N_PARAMS_K3 = N_PARAMS + 2 * (BASE_FEATURES + 1)  # two more output channels


def class_label(shape, device):
    """``blob_label``'s ellipsoid as class 1, its core as class 2."""
    import torch

    z, y, x = torch.meshgrid(*[torch.linspace(-1, 1, n, device=device) for n in shape], indexing="ij")
    r2 = z**2 + 2 * y**2 + x**2
    return ((r2 < 0.3).to(torch.uint8) + (r2 < 0.1).to(torch.uint8))[..., None]


def kclass(work: str, device, card: str, bn_step_s) -> tuple:
    """K = 3 heads with GroupNorm at full width, on 5 synthetic 128^3 cases
    labelled 0/1/2: (a) one flagship step (140 B1, 72 B2), its warm median
    beside the BatchNorm step's (``bn_step_s``) and its peak memory, its
    device time by kernel, and one microbatch's convs held against the
    plain versions; (b) a 1-epoch ``Trainer`` whose best.pth has GroupNorm
    weights and no running statistics; (c) the ``Validator`` on best.pth,
    then on a 2-member ensemble with TTA, per-class Dice; (d)
    ``PredictionServer.run_once`` of ``CASES`` with best.pth (unfolded),
    uint8 label maps, probabilities held against fp32 on a whole-volume and
    a tiled case; (e) a folded K = 3 BatchNorm model serving one case.
    Returns the (B1, B2) launches of (a)-(e)."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.data.io import read_volume
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.infer.serve import PredictionServer
    from pcmseg_tpu_torch.infer.validate import Validator
    from pcmseg_tpu_torch.models.unet3d import BatchNorm, UNet3D, param_count
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.ops.losses import loss_fn_from_config
    from pcmseg_tpu_torch.train.checkpoints import load_pth, save_pth
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step
    from pcmseg_tpu_torch.train.trainer import Trainer

    data = os.path.join(work, "kclass_data")
    t0 = time.perf_counter()
    config = get_config(base_features=BASE_FEATURES, data_dir=data, save_dir=os.path.join(work, "kclass_ckpt"),
                        cache_dir=os.path.join(work, "kclass_preproc"), seed=0, **{**TRAIN, **KCLASS})
    write_train_tree(data, config.modalities, TRAIN_CASES, ext=".nii", n_classes=3)
    log(f"kclass setup ({TRAIN_CASES} synthetic 128^3 cases, labels 0/1/2, written) {time.perf_counter() - t0:.1f} s")
    total = [0, 0]

    def counted(part: str, want) -> None:
        got = (conv3d.launches, conv3d_grad.launches)
        log(f"  kclass ({part}): launches B1 {got[0]}, B2 {got[1]} (expected {tuple(want)}) [{card}]")
        if got != tuple(want):
            raise AssertionError(f"kclass ({part}) launched {got}, expected {tuple(want)}")
        total[0] += got[0]
        total[1] += got[1]

    # (a) one flagship step of the K = 3 GroupNorm model
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    if param_count(model) != N_PARAMS_K3 or [k for k in model.state_dict() if "running" in k]:
        raise AssertionError(f"the K = 3 GroupNorm model has {param_count(model)} parameters, expected {N_PARAMS_K3}, "
                             "and no running statistics")
    state = create_train_state(model, config)
    step = make_train_step(model, config)
    g = torch.Generator(device=device).manual_seed(10)
    n = config.batch_size
    batch = {"image": torch.randn((n, SIZE, SIZE, SIZE, 5), generator=g, device=device).to(torch.bfloat16),
             "label": class_label((SIZE,) * 3, device)[None].expand(n, -1, -1, -1, -1).contiguous()}
    conv3d.launches = conv3d_grad.launches = 0
    loss = float(step(state, batch)["loss"])
    log(f"kclass (a): one flagship step of the K = 3 GroupNorm model ({param_count(model):,} parameters, "
        f"{config.loss}): loss {loss:.6g} [{card}]")
    counted("a", expected_train_launches(config, steps=1, eval_forwards=0))
    if not math.isfinite(loss):
        raise AssertionError(f"kclass (a): loss {loss}")
    float(step(state, batch)["loss"])  # warm
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIME_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        float(step(state, batch)["loss"])
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med, bn = sorted(times)[len(times) // 2], sorted(bn_step_s)[len(bn_step_s) // 2]
    log(f"kclass (a) step (batch 4 = 4 x 1, remat off): median {med * 1e3:.1f} ms of {TIME_STEPS} = {n / med:.3f} "
        f"vol/s, peak device memory {peak:.2f} GiB; the BatchNorm flagship step of the time phase {bn * 1e3:.1f} ms "
        f"= {n / bn:.3f} vol/s ({med / bn:.2f}x) [{card}]")
    profile_step(lambda: float(step(state, batch)["loss"]), "one K = 3 GroupNorm step (remat off)", card)

    # one microbatch's convs against the plain versions; these launches compare
    model.zero_grad(set_to_none=True)
    with conv_io(model) as records:
        loss_fn_from_config(config)(model(batch["image"][:1]), batch["label"][:1]).backward()
        torch.cuda.synchronize()
    grads = {k: p.grad.float() for k, p in model.named_parameters() if p.grad is not None}
    check_conv_function(model, records, grads, card, "one 128^3 microbatch of the K = 3 GroupNorm step")
    for rec in records.values():
        rec.clear()
    del records, grads
    member = save_pth(os.path.join(work, "kclass_member.pth"), model.state_dict(), config.to_dict())
    del model, state, step, batch
    torch.cuda.empty_cache()

    # (b) a 1-epoch Trainer from the device data cache
    trainer = Trainer(config, device=device)
    log(f"kclass (b) path: {data_path(trainer, TRAIN_CASES)}")
    conv3d.launches = conv3d_grad.launches = 0
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    log(f"kclass (b): 1-epoch Trainer in {time.perf_counter() - t0:.1f} s (cold, checkpoints included), history "
        f"{json.dumps(history)} [{card}]")
    counted("b", expected_train_launches(config, steps=1, eval_forwards=1))
    if not all(math.isfinite(v) for vals in history.values() for v in vals):
        raise AssertionError(f"kclass (b): non-finite history {history}")
    del trainer
    torch.cuda.empty_cache()
    best = os.path.join(config.save_dir, "best.pth")
    sd, snapshot = load_pth(best)
    running = [k for k in sd if "running" in k or "num_batches" in k]
    UNet3D.from_config(config, device="meta").load_state_dict(sd, strict=True, assign=True)
    log(f"kclass (b): best.pth {len(sd)} tensors, running statistics {running}, GroupNorm inc.conv.1 weight/bias "
        f"{tuple(sd['inc.conv.1.weight'].shape)}/{tuple(sd['inc.conv.1.bias'].shape)}, outc "
        f"{tuple(sd['outc.weight'].shape)}, config n_classes {snapshot['n_classes']} norm_layer "
        f"{snapshot['norm_layer']!r}; loads strictly into a GroupNorm UNet3D")
    if running or tuple(sd["outc.weight"].shape) != (3, BASE_FEATURES, 1, 1, 1) \
            or (snapshot["n_classes"], snapshot["norm_layer"]) != (3, "group"):
        raise AssertionError("kclass (b): best.pth is not a K = 3 GroupNorm checkpoint")

    # (c) the Validator: best.pth through the eval step, then a 2-member ensemble with TTA
    base = get_config(data_dir=data, save_dir=os.path.join(work, "kclass_validate"),
                      cache_dir=os.path.join(work, "kclass_preproc"), batch_size=TRAIN["batch_size"])
    for part, spec, cfg, per_batch in (("c, best.pth", best, base, 18),
                                       ("c, 2-member ensemble + TTA", [best, member], base.replace(tta=True), 18 * 2 * 8)):
        v = Validator(cfg, spec, device=device)
        if (v.config.n_classes, v.config.norm_layer) != (3, "group"):
            raise AssertionError(f"kclass ({part}): the Validator adopted {v.config.n_classes} / {v.config.norm_layer}")
        cases = len(v.dataset)
        conv3d.launches = conv3d_grad.launches = 0
        t0 = time.perf_counter()
        res = v.validate()
        wall = time.perf_counter() - t0
        log(f"kclass ({part}): {cases} 128^3 cases in {wall:.2f} s, avg Dice {res['avg_dice']:.4f}, per class "
            f"{res.get('avg_dice_per_class')}, per case {[r.get('dice_per_class') for r in res['case_results']]} "
            f"[{card}]")
        counted(part, (per_batch * math.ceil(cases / cfg.batch_size), 0))
        if sorted(res.get("avg_dice_per_class", {})) != ["1", "2"] or res["case_count"] != cases:
            raise AssertionError(f"kclass ({part}): results {res}")
        for r in res["case_results"]:
            per = list(r["dice_per_class"].values())
            if not all(math.isfinite(d) for d in per) or abs(r["dice"] - float(np.mean(per))) > 1e-6:
                raise AssertionError(f"kclass ({part}): case {r} (dice is not the mean of its classes)")
        del v

    # (d) serving: PredictionServer.run_once with best.pth, unfolded GroupNorm
    inbox, outbox = os.path.join(work, "kclass_inbox"), os.path.join(work, "kclass_outbox")
    write_cases(inbox, config.modalities)
    server = PredictionServer(get_config(base_features=BASE_FEATURES), best, inbox, outbox, min_age=0.0, device=device)
    predictor = server.predictor
    if predictor.models[0].norm_layer != "group" or predictor.config.n_classes != 3:
        raise AssertionError("kclass (d): the server does not serve the unfolded K = 3 GroupNorm model")
    conv3d.launches = conv3d_grad.launches = 0
    stats = server.run_once()
    counted("d", (18 * expected_forwards(server.config), 0))
    if stats != {"done": len(CASES), "failed": 0, "skipped": 0, "waiting": 0}:
        raise AssertionError(f"kclass (d): serve stats {stats}")
    for case_id, shape in CASES.items():
        mask = read_volume(os.path.join(outbox, case_id, "segmentation.nii.gz")).data
        values = sorted(int(c) for c in np.unique(mask))
        log(f"  kclass (d) {case_id} {shape}: label map {mask.dtype} {mask.shape}, values {values}, cold latency "
            f"{server.latencies[case_id]:.3f} s")
        if mask.dtype != np.uint8 or mask.shape != shape or not set(values) <= {0, 1, 2}:
            raise AssertionError(f"kclass (d) {case_id}: label map {mask.dtype} {mask.shape} values {values}")
    first, tiled = sorted(CASES)[0], max(CASES, key=lambda c: math.prod(CASES[c]))
    images = {}
    for case_id in (first, tiled):
        images[case_id] = image = predictor.load_case(os.path.join(inbox, case_id))[0]
        best_s = []
        for _ in range(3):
            t = time.perf_counter()
            predictor.predict_mask(image)
            best_s.append(time.perf_counter() - t)
        log(f"  kclass (d) {case_id} device path (H2D, forward, softmax, argmax, D2H), unfolded GroupNorm: "
            f"{min(best_s) * 1e3:.1f} ms [{card}]")
        check_probs(predictor, image, f"kclass (d) {case_id}")
    del server, predictor

    # (e) a K = 3 BatchNorm model, folded, serving one case
    gen = torch.Generator().manual_seed(1234)
    bn_config = get_config(base_features=BASE_FEATURES, n_classes=3)
    bn_model = UNet3D.from_config(bn_config, generator=gen)
    with torch.no_grad():
        for m in bn_model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    pth = save_pth(os.path.join(work, "kclass_bn.pth"), bn_model.state_dict(), bn_config.to_dict())
    del bn_model
    predictor = Predictor(get_config(base_features=BASE_FEATURES), pth, device=device)
    if predictor.models[0].norm_layer != "none":
        raise AssertionError("kclass (e): the K = 3 BatchNorm model is not folded")
    conv3d.launches = conv3d_grad.launches = 0
    mask = predictor.predict_mask(images[first])
    counted("e", (18, 0))
    values = sorted(int(c) for c in np.unique(mask))
    log(f"kclass (e): folded K = 3 BatchNorm model, {first}: label map {mask.dtype} {mask.shape}, values {values} "
        f"[{card}]")
    if mask.dtype != np.uint8 or not set(values) <= {0, 1, 2}:
        raise AssertionError(f"kclass (e): label map {mask.dtype} values {values}")
    check_probs(predictor, images[first], f"kclass (e) {first} folded BatchNorm")
    del predictor
    torch.cuda.empty_cache()
    return tuple(total)


# ---- profiling, asynchronous checkpoints and device ingest (slice 7) ----------------

PROFILE_STEPS = 2  # the trainer's profiled window: global steps 1 and 2 of epoch 0
# 2 epochs: the async run killed after epoch 1 resumes for the second (4
# until the tp phase joined: an epoch writes up to 2.5 GB of checkpoints,
# and the machine's disk counts every write, kept or not)
ASYNC_EPOCHS = 2
# device ingest against the host path's bf16 stack: one bf16 step at 1.0
INGEST_MAX_DIFF = 2.0**-8
UNDECIDED_P = 1e-2  # masks may differ only where the host path's p is this close to the threshold


def trace_events(log_dir: str) -> list:
    """The events of the one ``*.pt.trace.json`` that torch.profiler wrote under ``log_dir``."""
    import glob

    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"{log_dir}: {len(files)} trace files, expected 1")
    with open(files[0]) as f:
        events = [e for e in json.load(f)["traceEvents"] if isinstance(e, dict)]
    log(f"  trace {os.path.relpath(files[0], REPO)}: {os.path.getsize(files[0]) / 2**20:.1f} MiB, "
        f"{len(events)} events")
    return events


def kernel_events(events: list) -> tuple:
    """(B1, B2) launches recorded as device kernel events, by kernel name."""
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    return (sum("conv3x3x3_kernel" in n for n in names), sum("conv3x3_dw_kernel" in n for n in names))


def profiled_runs(work: str, device) -> dict:
    """The two profiled runs of the profiling phase, in a process of their
    own (``chip_smoke.py --profiled WORK``): a flagship Trainer with
    ``profile_steps=2`` on the cache phase's 12 cases, each step timed
    (synchronised), and a PredictionServer over the serve cases. Returns
    their launch counts, step seconds and stats."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.serve import PredictionServer
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.train.trainer import Trainer

    config = get_config(base_features=BASE_FEATURES, data_dir=os.path.join(work, "cache_data"),
                        save_dir=os.path.join(work, "prof_ckpt"), cache_dir=os.path.join(work, "preproc"), seed=0,
                        **{**TRAIN, "profile_dir": os.path.join(work, "prof_train"), "profile_steps": PROFILE_STEPS})
    trainer = Trainer(config, device=device)
    steps = math.ceil(len(trainer.train_indices) / config.batch_size)
    step_s = []
    real_step = trainer._cached_train_step

    def timed_step(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_step(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return out

    trainer._cached_train_step = timed_step
    conv3d.launches = conv3d_grad.launches = 0
    t0 = time.perf_counter()
    trainer.train()
    out = {"train_s": time.perf_counter() - t0, "steps": steps, "epochs": config.num_epochs, "step_s": step_s,
           "train_launches": [conv3d.launches, conv3d_grad.launches],
           "want_train": list(expected_train_launches(config, steps=config.num_epochs * steps,
                                                      eval_forwards=config.num_epochs))}
    del trainer
    torch.cuda.empty_cache()

    serve_config = get_config(base_features=BASE_FEATURES, norm_layer="batch",
                              profile_dir=os.path.join(work, "prof_serve"))
    server = PredictionServer(serve_config, os.path.join(work, "model.pth"), os.path.join(work, "inbox"),
                              os.path.join(work, "prof_outbox"), explicit=["profile_dir"], min_age=0.0, device=device)
    conv3d.launches = 0
    try:
        out["serve_stats"] = server.run_once()
    finally:
        server.close()
    out.update(serve_launches=conv3d.launches, forwards=expected_forwards(server.config),
               profile_steps=server.config.profile_steps)
    return out


def profiling_phase(work: str, device, card: str):
    """``profile_dir`` on the three entry points that take it, each in a
    process of its own, as a user's ``train --profile`` / ``serve
    --profile`` / ``predict --profile`` runs: the Trainer's trace file
    holds exactly 2 x 140 B1 and 2 x 72 B2 kernel events by name, the
    server's window 18 B1 per forward and one ``serve.case`` span per case, and
    ``predict --profile`` exits 0 with 18 B1 in its trace. (Run in this
    script's own process, after the phases before it, the Trainer's window
    lost one B1 kernel event of ~10,560 in each of three H100 runs.)
    Returns the (B1, B2) launches of the Trainer and the server."""
    env = dict(os.environ, PYTHONPATH=REPO)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--profiled", work], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"the profiled runs exited {proc.returncode}: {proc.stderr[-3000:]}")
    run = json.loads(proc.stdout.strip().splitlines()[-1])
    launches = tuple(run["train_launches"])
    events = trace_events(os.path.join(work, "prof_train"))
    traced = kernel_events(events)
    want_traced = (PROFILE_STEPS * 140, PROFILE_STEPS * 72)
    step_s, steps = run["step_s"], run["steps"]
    inside = step_s[1:1 + PROFILE_STEPS]
    outside = step_s[steps:]  # the warm epoch after the window
    log(f"profiling, Trainer ({run['epochs']} epochs of {steps} flagship steps, profile_steps {PROFILE_STEPS}, "
        f"{run['train_s']:.1f} s in a process of {time.perf_counter() - t0:.1f} s): trace kernel events B1 "
        f"{traced[0]}, B2 {traced[1]} (expected {want_traced}); step (synchronised) inside the window "
        f"{', '.join(f'{s * 1e3:.1f}' for s in inside)} ms, outside {', '.join(f'{s * 1e3:.1f}' for s in outside)} ms "
        f"(median {sorted(outside)[len(outside) // 2] * 1e3:.1f}); launches B1 {launches[0]}, B2 {launches[1]} "
        f"(expected {tuple(run['want_train'])}) [{card}]")
    if list(launches) != run["want_train"] or len(step_s) != run["epochs"] * steps:
        raise AssertionError(f"profiled trainer: launches {launches}, expected {run['want_train']}; "
                             f"{len(step_s)} steps")
    if traced != want_traced:
        kernels = sorted((e["ts"], e["name"][:40]) for e in events if e.get("cat") == "kernel")
        kernels = [(round(ts - kernels[0][0]), name) for ts, name in kernels]
        raise AssertionError(f"the trainer's trace holds {traced} conv kernels, expected {want_traced}; "
                             f"{len(kernels)} kernel events, the first (us) {kernels[:4]}, the last {kernels[-3:]}")

    events = trace_events(os.path.join(work, "prof_serve"))
    spans = sorted(e["name"] for e in events if e.get("cat") == "user_annotation" and e["name"] == "serve.case")
    traced, forwards = kernel_events(events), run["forwards"]
    log(f"profiling, PredictionServer over {len(CASES)} cases ({forwards} forwards, window of {run['profile_steps']} "
        f"cases written by close()): trace B1 {traced[0]} (expected {18 * forwards}), spans {spans}; launches B1 "
        f"{run['serve_launches']} [{card}]")
    if (run["serve_stats"]["done"] != len(CASES) or traced != (18 * forwards, 0)
            or run["serve_launches"] != 18 * forwards or spans != ["serve.case"] * len(CASES)):
        raise AssertionError(f"profiled server: stats {run['serve_stats']}, trace {traced}, spans {spans}")

    # predict --profile
    cli_dir = os.path.join(work, "prof_cli")
    argv = ["predict", "--model_path", os.path.join(work, "model.pth"), "--input_dir",
            os.path.join(work, "inbox", sorted(CASES)[0]), "--output_dir", os.path.join(work, "prof_cli_out"),
            "--profile", cli_dir]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pcmseg_tpu_torch", *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"predict --profile exited {proc.returncode}: {proc.stderr[-2000:]}")
    traced = kernel_events(trace_events(cli_dir))
    log(f"profiling, predict --profile: exit 0 in {time.perf_counter() - t0:.1f} s, trace B1 {traced[0]} "
        f"(expected 18) [{card}]")
    if traced != (18, 0):
        raise AssertionError(f"predict --profile traced {traced}")
    return launches[0] + run["serve_launches"], launches[1]


def same_tree(a, b, skip=()) -> bool:
    """Nested payloads equal: tensors bitwise, other leaves by ==, keys in ``skip`` left out."""
    import torch

    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and [k for k in a if k not in skip] == [k for k in b if k not in skip]
                and all(same_tree(a[k], b[k], skip) for k in a if k not in skip))
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(same_tree(x, y, skip) for x, y in zip(a, b))
    return a == b


def async_ckpt(work: str, device, card: str):
    """The cache phase's 12 cases in the flagship configuration for
    ASYNC_EPOCHS epochs from the same init, with synchronous and with
    asynchronous checkpoints: equal histories and parameters; latest, best
    and best.pth bitwise equal tensors and equal meta; an async run killed
    an epoch early and resumed bitwise equal to the uninterrupted one; a
    writer that cannot write raised by ``train()``. Returns the async run's
    (B1, B2) launches."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.train.checkpoints import train_checkpoint_path
    from pcmseg_tpu_torch.train.trainer import Trainer

    base = get_config(base_features=BASE_FEATURES, data_dir=os.path.join(work, "cache_data"),
                      cache_dir=os.path.join(work, "preproc"), seed=0, **{**TRAIN, "num_epochs": ASYNC_EPOCHS})
    runs = {}
    for name, on in (("sync", False), ("async", True)):
        config = base.replace(save_dir=os.path.join(work, f"ack_{name}"), async_checkpoint=on)
        trainer = Trainer(config, device=device)
        steps = math.ceil(len(trainer.train_indices) / config.batch_size)
        epochs, saves = [], []
        real_epoch, real_save = trainer.train_epoch, trainer._save_epoch

        def epoch(trainer=trainer, real_epoch=real_epoch, epochs=epochs):
            busy = trainer.writer is not None and trainer.writer.in_flight() > 0
            t = time.perf_counter()
            loss = real_epoch()  # ends with the host fetching the last loss
            epochs.append((time.perf_counter() - t, busy))
            return loss

        def save(*args, real_save=real_save, saves=saves):
            t = time.perf_counter()
            real_save(*args)
            saves.append(time.perf_counter() - t)

        trainer.train_epoch, trainer._save_epoch = epoch, save
        conv3d.launches = conv3d_grad.launches = 0
        t0 = time.perf_counter()
        history = trainer.train()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (conv3d.launches, conv3d_grad.launches)
        want = expected_train_launches(config, steps=ASYNC_EPOCHS * steps, eval_forwards=ASYNC_EPOCHS)
        if launches != want:
            raise AssertionError(f"{name} checkpoints: launches {launches}, expected {want}")
        line = (f"async_ckpt {name}: {ASYNC_EPOCHS} epochs in {wall:.2f} s; train epochs "
                f"{', '.join(f'{s:.3f}' + (' (write in flight)' if b else '') for s, b in epochs)} s; ")
        if trainer.writer is None:
            line += f"saves on the training thread {', '.join(f'{s:.3f}' for s in saves)} s = {sum(saves):.2f} s"
        else:
            st = trainer.writer.stats
            line += (f"training thread blocked in saves {st['blocked_s']:.3f} s (submits "
                     f"{', '.join(f'{s:.3f}' for s in saves)} s, backpressure and the final drain included); "
                     f"writer {', '.join(f'{s:.3f}' for s in st['task_s'])} s per task, {st['submitted']} submitted, "
                     f"{st['collapsed']} collapsed; peak pinned host {trainer.writer.snapshots.peak_pinned_bytes / 1e9:.3f} GB")
        log(line + f"; launches B1 {launches[0]}, B2 {launches[1]} (expected {want}) [{card}]")
        runs[name] = (history, trainer, config, launches)
    (h_sync, t_sync, c_sync, _), (h_async, t_async, c_async, launches) = runs["sync"], runs["async"]
    skip = ("save_dir", "async_checkpoint")
    same = {"history": h_sync == h_async, "params": same_params(t_sync, t_async)}
    for name in ("latest", "best"):
        a, b = (torch.load(train_checkpoint_path(c.save_dir, name), map_location="cpu", weights_only=True)
                for c in (c_sync, c_async))
        same[name] = same_tree(a, b, skip)
    a, b = (torch.load(os.path.join(c.save_dir, "best.pth"), map_location="cpu", weights_only=True)
            for c in (c_sync, c_async))
    same["best.pth"] = same_tree(a, b, skip)
    log(f"async_ckpt: async equal to sync (tensors bitwise, meta but save_dir/async_checkpoint): {same} [{card}]")
    if not all(same.values()):
        raise AssertionError(f"the asynchronous run differs from the synchronous one: {same}")
    del t_sync
    torch.cuda.empty_cache()

    killed = c_async.replace(save_dir=os.path.join(work, "ack_killed"), num_epochs=ASYNC_EPOCHS - 1)
    Trainer(killed, device=device).train()
    resumed = Trainer(killed.replace(num_epochs=ASYNC_EPOCHS, resume=True), device=device)
    again = resumed.train()
    equal = resumed.start_epoch == ASYNC_EPOCHS - 1 and again == h_async and same_params(resumed, t_async)
    log(f"async_ckpt: killed after epoch {ASYNC_EPOCHS - 1} and resumed from the async latest, bitwise equal to the "
        f"uninterrupted run: {equal} [{card}]")
    if not equal:
        raise AssertionError("the resumed asynchronous run differs from the uninterrupted one")
    del resumed, t_async
    torch.cuda.empty_cache()

    # a writer that cannot write: save_dir under a regular file
    blocker = os.path.join(work, "ack_blocker")
    with open(blocker, "w") as f:
        f.write("not a directory\n")
    failing = c_async.replace(save_dir=os.path.join(blocker, "ckpt"), num_epochs=1)
    try:
        Trainer(failing, device=device).train()
    except OSError as e:
        log(f"async_ckpt: a writer that cannot write surfaced from train(): {type(e).__name__}: {e}")
    else:
        raise AssertionError("a failing checkpoint writer did not surface from train()")
    torch.cuda.empty_cache()
    return launches


def ingest(work: str, server, device, card: str):
    """``device_ingest`` over the serve cases with the seeded base-64 model:
    the device stack against the host path's bf16 stack (max |d| at most one
    bf16 step at 1.0), the masks against the host path's (equal except
    where the host p is within UNDECIDED_P of the threshold), 18 B1 per
    forward; then warm run_once of the profile phase's four 128^3 cases,
    host and device ingest in turns (host, device, device, host): vol/s, the
    card's idle share, host decode and normalize ms per case, the ingest's
    device ms. Returns the device-ingest server run's B1 launches."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.infer.serve import PredictionServer
    from pcmseg_tpu_torch.ops.kernels import conv3d

    inbox = os.path.join(work, "inbox")
    host = server.predictor
    dev_server = PredictionServer(server.config.replace(device_ingest=True), os.path.join(work, "model.pth"), inbox,
                                  os.path.join(work, "ingest_outbox"), explicit=["device_ingest"], min_age=0.0,
                                  device=device)
    dev = dev_server.predictor
    if not dev.config.device_ingest:
        raise AssertionError("the device-ingest server lost device_ingest")
    forwards = expected_forwards(dev.config)
    conv3d.launches = 0
    stats = dev_server.run_once()
    launches = conv3d.launches
    log(f"ingest: device-ingest run_once over {len(CASES)} cases: stats {stats}, launches B1 {launches} "
        f"(expected {18 * forwards}) [{card}]")
    if stats["done"] != len(CASES) or launches != 18 * forwards:
        raise AssertionError(f"device-ingest serving: stats {stats}, {launches} launches")
    for case_id in sorted(CASES):
        case = os.path.join(inbox, case_id)
        want = host._upload(host.read_case(case)[0])  # the host path's bf16 stack on the card
        got = dev.load_case(case)[0]
        if got.device != want.device or got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{case_id}: device stack {got.dtype} {tuple(got.shape)} on {got.device}")
        diff = (got.float() - want.float()).abs()
        p_host = host.predict_probs(want)[..., 0]
        m_host, m_dev = host.predict_mask(want), dev.predict_mask(got)
        undecided = np.abs(p_host - dev.config.threshold) <= UNDECIDED_P
        differ = m_host != m_dev
        log(f"  {case_id} {CASES[case_id]}: stack max|d| {diff.max().item():.4g} (bound {INGEST_MAX_DIFF:.4g}), "
            f"elements differing {(diff > 0).float().mean().item():.4f}; mask voxels differing {int(differ.sum())}, "
            f"all within {UNDECIDED_P} of the threshold: {not (differ & ~undecided).any()} "
            f"({int(undecided.sum())} voxels there) [{card}]")
        if diff.max().item() > INGEST_MAX_DIFF or (differ & ~undecided).any():
            raise AssertionError(f"{case_id}: device ingest disagrees with the host path")

    # warm run_once of four 128^3 cases, host and device ingest in turns
    prof_inbox = os.path.join(work, "profile_inbox")
    case = os.path.join(prof_inbox, "case_0")
    servers = {"host": server, "device": dev_server}
    rates = {"host": [], "device": []}
    for turn in ("host", "device", "device", "host"):
        s = servers[turn]
        s.input_root, s.output_dir = prof_inbox, os.path.join(work, f"ingest_{turn}")
        shutil.rmtree(s.output_dir, ignore_errors=True)
        done = s.stats["done"]
        t0 = time.perf_counter()
        s.run_once()
        rates[turn].append(PROFILE_CASES / (time.perf_counter() - t0))
        if s.stats["done"] - done != PROFILE_CASES or s.stats["failed"]:
            raise AssertionError(f"warm {turn}-ingest run_once: stats {s.stats}, {done} done before")
    idle = {}
    for turn, s in servers.items():
        shutil.rmtree(s.output_dir, ignore_errors=True)
        _, wall, idle[turn], busy = idle_share(s.run_once)
        idle[turn] = (idle[turn], busy, wall)

    def median_host_ms(fn, n=5):
        times = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return sorted(times)[n // 2]

    decode = median_host_ms(lambda: dev.read_case(case))
    decode_normalize = median_host_ms(lambda: host.read_case(case))
    raw = dev.read_case(case)[0]
    _, ingest_wall, _, ingest_busy = idle_share(lambda: dev.ingest(raw))
    log(f"ingest, warm run_once of {PROFILE_CASES} 128^3 cases (host, device, device, host): host ingest "
        f"{', '.join(f'{r:.3f}' for r in rates['host'])} vol/s, device ingest "
        f"{', '.join(f'{r:.3f}' for r in rates['device'])} vol/s; profiled run_once: card idle "
        f"{idle['host'][0]:.3f} (host, {idle['host'][1]:.1f} busy ms of {idle['host'][2] * 1e3:.1f}) and "
        f"{idle['device'][0]:.3f} (device, {idle['device'][1]:.1f} of {idle['device'][2] * 1e3:.1f}) [{card}]")
    log(f"ingest, one 128^3 case: host decode {decode:.1f} ms, decode + normalize {decode_normalize:.1f} ms "
        f"(normalize {decode_normalize - decode:.1f} ms); device ingest (pinned upload of 5 int16 channels, "
        f"percentiles, scale, cast, stack) {ingest_busy:.2f} device-ms in {ingest_wall * 1e3:.1f} ms [{card}]")
    del dev_server
    torch.cuda.empty_cache()
    return launches



# ---- data parallelism across processes (slice 8) --------------------------------

DP_RANKS = 2
DP_STEPS = 3
# param_dtype phase: flagship steps with each param dtype (the first is cold)
PARAM_DTYPE_STEPS = 4
DP_SEED = 11
# (a) against the one-process steps: a rank's microbatches run the same
# forward and backward as one process's, so the first step's loss and the
# running statistics after it are bitwise equal; the gradient sums differ
# only in fp32 rounding ((g0+g1)+(g2+g3) against ((g0+g1)+g2)+g3), so step
# 1's grad norm lies within DP_GRAD_NORM_RTOL of one process's and every
# parameter after it within DP_PARAM_ATOL (measured 2.05e-8, NVIDIA H100
# 80GB HBM3, 700.00 W). Adam's first update is lr·g/(|g| + eps), about
# lr·sign(g) whatever the gradient's scale, so the grad norm is what holds
# the scale and the parameters what hold the signs. From the second step
# the two are bf16 trainings whose weights differ by Adam's ±lr on
# noise-level gradients: their parameters drift apart by about lr a step
# (measured 3.28e-4 after step 3), which no bound tighter than Adam's own
# separates from a wrong gradient, so they are reported; the losses, which
# move 3e-3 to 5e-3 a step, are held within DP_LOSS_RTOL (measured 1.89e-6)
DP_GRAD_NORM_RTOL = 1e-5
DP_PARAM_ATOL = 1e-6
DP_LOSS_RTOL = 2e-5
# 1 epoch (2 until the tp phase joined: the script's time and the machine's
# disk, which counts every checkpoint written, needed the room)
DP_EPOCHS = 1
# (c): layout (c), 4 ranks and batch 4 in 2 microbatches of 2
DP_C_RANKS = 4
DP_C_ACCUM = 2


def dp_batches(device):
    """DP_STEPS flagship batches (4 x 128^3 x 5 bf16, blob labels), the same
    in every process: drawn on the card from a seeded generator."""
    import torch

    g = torch.Generator(device=device).manual_seed(DP_SEED)
    n = TRAIN["batch_size"]
    label = blob_label((SIZE,) * 3, device)
    return [{"image": torch.randn((n, SIZE, SIZE, SIZE, 5), generator=g, device=device).to(torch.bfloat16),
             "label": torch.stack([label.roll(8 * i, 1) for i in range(n)])} for _ in range(DP_STEPS)]


def state_digest(state: dict) -> str:
    """SHA-256 of a state dict's names and bytes: two ranks' states are
    bitwise equal where their digests are (no state file written and read
    back)."""
    import torch

    digest = hashlib.sha256()
    for k, v in state.items():
        digest.update(k.encode())
        digest.update(v.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def dp_rank(rank: int, world: int, port: int, work: str, backend: str) -> dict:
    """One process of a data-parallel group (``chip_smoke.py --dp-rank RANK
    WORLD PORT WORK BACKEND``): gloo with every rank on card 0, or NCCL
    with one card a rank; the flagship model from the seed, DP_STEPS steps
    on this rank's rows of the batches (layout (b): 4 / WORLD whole
    microbatches of one sample), each step timed (synchronised) and its
    launches counted, the gradient all-reduce timed inside it; the state
    after the first step and the final one written to
    WORK/dp_rank{RANK}_{1,final}.pt."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.ops.kernels import batchnorm, conv3d, conv3d_grad
    from pcmseg_tpu_torch.parallel import collectives, multihost
    from pcmseg_tpu_torch.parallel.sharding import Mesh, shard_batch, shard_state
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    multihost.initialize(f"localhost:{port}", num_processes=world, process_id=rank, backend=backend)
    device = multihost.local_device() if backend == "nccl" else torch.device("cuda", 0)
    multihost.establish_collectives()
    config = get_config(base_features=BASE_FEATURES, **TRAIN)
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    shard_state(model, Mesh(world))
    state = create_train_state(model, config)
    step = make_train_step(model, config)
    reduce_s, real_reduce = [], collectives.GradientAllReduce.__call__

    def timed_reduce(self):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        real_reduce(self)
        torch.cuda.synchronize(device)
        reduce_s.append(time.perf_counter() - t)

    collectives.GradientAllReduce.__call__ = timed_reduce
    out = {"rank": rank, "device": str(device), "loss": [], "grad_norm": [], "step_s": [], "launches": []}
    for batch in dp_batches(device):
        local = shard_batch(batch, Mesh(world), rank=rank, accum=config.accum_steps)
        torch.cuda.synchronize(device)
        conv3d.launches = conv3d_grad.launches = batchnorm.launches = 0
        t = time.perf_counter()
        metrics = step(state, local)
        out["loss"].append(float(metrics["loss"]))
        torch.cuda.synchronize(device)
        out["step_s"].append(time.perf_counter() - t)
        out["launches"].append([conv3d.launches, conv3d_grad.launches, batchnorm.launches])
        out["grad_norm"].append(float(metrics["grad_norm"]))
        if len(out["loss"]) in (1, DP_STEPS):
            name = "1" if len(out["loss"]) == 1 else "final"
            torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
                       os.path.join(work, f"dp_rank{rank}_{name}.pt"))
    out.update(reduce_s=reduce_s, rows=len(local["image"]),
               reduce_bytes=4 * sum(p.numel() for p in model.parameters() if p.requires_grad))
    multihost.shutdown()
    return out


def dp_trainer(rank: int, world: int, port: int, work: str, backend: str, name: str) -> dict:
    """A flagship Trainer over the cache phase's 12 cases for DP_EPOCHS
    epochs from the device cache (sharded over the ranks: every batch's
    rows exchanged by an all-reduce) with asynchronous checkpoints
    (barriers on the writer thread), as rank ``rank`` of a WORLD-rank group
    of ``backend`` (``chip_smoke.py --dp-trainer ...``); with ``world`` 0,
    the same without a group. Returns its history, wall time and launches."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.parallel import multihost
    from pcmseg_tpu_torch.train.checkpoints import train_checkpoint_path
    from pcmseg_tpu_torch.train.trainer import Trainer

    run = {"rank": rank}
    if world:
        multihost.initialize(f"localhost:{port}", num_processes=world, process_id=rank, backend=backend)
        multihost.establish_collectives()
        import torch.distributed as dist

        run["backend"] = dist.get_backend()
    config = get_config(base_features=BASE_FEATURES, data_dir=os.path.join(work, "cache_data"),
                        cache_dir=os.path.join(work, "preproc"), seed=0, save_dir=os.path.join(work, f"dp_{name}"),
                        **{**TRAIN, "num_epochs": DP_EPOCHS, "async_checkpoint": True})
    trainer = Trainer(config, device=multihost.local_device() if world else torch.device("cuda"))
    steps = math.ceil(len(trainer.train_indices) / config.batch_size)
    val_batches = math.ceil(len(trainer.val_indices) / config.batch_size)
    micro = config.accum_steps // max(1, world) if world > 1 else config.accum_steps
    run.update(sharded_cache=trainer._dcache is not None and trainer._dcache["rows"] is not None,
               cached_rows=int(trainer._dcache["images"].shape[0]), collapse=trainer.writer.collapse,
               mesh=trainer.mesh.shape)
    conv3d.launches = conv3d_grad.launches = 0
    t0 = time.perf_counter()
    run["history"] = trainer.train()
    torch.cuda.synchronize()
    # a rank runs `micro` of each step's microbatches and its share of each
    # evaluation batch, which the eval step splits over the ranks
    run.update(wall_s=time.perf_counter() - t0, launches=[conv3d.launches, conv3d_grad.launches],
               want=[DP_EPOCHS * steps * micro * 35 + DP_EPOCHS * val_batches * 18, DP_EPOCHS * steps * micro * 18],
               latest_epoch=int(torch.load(train_checkpoint_path(config.save_dir, "latest"),
                                           weights_only=True)["meta"]["epoch"]),
               best_pth=os.path.isfile(os.path.join(config.save_dir, "best.pth")))
    if world:
        multihost.shutdown()
    return run


@contextlib.contextmanager
def first_gradients(model, sink: dict):
    """Inside, the first train step's summed gradients (before the clip and
    Adam) are copied to the host into ``sink``, by name."""
    from pcmseg_tpu_torch.train import steps

    real = steps.apply_gradients

    def apply_gradients(state, max_norm):
        if not sink:
            sink.update({k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()})
        return real(state, max_norm)

    steps.apply_gradients = apply_gradients
    try:
        yield
    finally:
        steps.apply_gradients = real


def dp_reference(device):
    """The dp steps in this process without a group: losses, grad norms,
    step seconds and the states after the first and the last step (on the
    host); step 1's gradients before the clip and Adam, and the peak device
    memory of the warm steps above what the process held before (the sp
    phase's reference too: in the whole script, earlier phases still hold
    some memory)."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    held = torch.cuda.memory_allocated(device)
    config = get_config(base_features=BASE_FEATURES, **TRAIN)
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    state, step = create_train_state(model, config), make_train_step(model, config)
    ref = {"loss": [], "grad_norm": [], "step_s": [], "grads": {}}
    with first_gradients(model, ref["grads"]):
        for batch in dp_batches(device):
            torch.cuda.synchronize()
            if len(ref["loss"]) == 1:
                torch.cuda.reset_peak_memory_stats(device)
            t = time.perf_counter()
            metrics = step(state, batch)
            ref["loss"].append(float(metrics["loss"]))
            torch.cuda.synchronize()
            ref["step_s"].append(time.perf_counter() - t)
            ref["grad_norm"].append(float(metrics["grad_norm"]))
            if len(ref["loss"]) in (1, DP_STEPS):
                ref["1" if len(ref["loss"]) == 1 else "final"] = {k: v.detach().cpu().clone()
                                                                  for k, v in model.state_dict().items()}
    ref["peak_gib"] = (torch.cuda.max_memory_allocated(device) - held) / 2**30
    del model, state, step
    torch.cuda.empty_cache()
    return ref


def spawn_ranks(args_of, world: int, timeout: int = 900) -> list:
    """``world`` processes of this script with ``args_of(rank)`` as
    arguments, all at once; each one's last stdout line as JSON. Fails if
    one exits non-zero or outlives ``timeout``; stops them all."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), *args_of(r)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
    outs = []
    try:
        deadline = time.perf_counter() + timeout
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.perf_counter())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, stderr) in zip(procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"a process of the group exited {p.returncode}: {stderr[-3000:]}")
    return [json.loads(stdout.strip().splitlines()[-1]) for stdout, _ in outs]


def dp_steps(work: str, ref: dict, world: int, backend: str, card: str, what: str) -> list:
    """``world`` ranks of ``backend`` through dp_rank, held against each
    other and against ``ref`` (dp_reference); logs each rank's step and
    all-reduce times. Returns the (B1, B2, BatchNorm) launches of all ranks."""
    import torch

    port, t0 = free_port(), time.perf_counter()
    ranks = spawn_ranks(lambda r: ["--dp-rank", str(r), str(world), str(port), work, backend], world)
    wall = time.perf_counter() - t0
    micro = TRAIN["accum_steps"] // world
    per_step = [micro * 35, micro * 18, micro * 18 * 4]  # B1, B2, BatchNorm (its statistics deferred)
    note = "; gloo through the host on one shared card, not NCCL numbers" if backend == "gloo" else ""
    compared = {}
    for when in ("1", "final"):
        states = [torch.load(os.path.join(work, f"dp_rank{r}_{when}.pt"), weights_only=True) for r in range(world)]
        worst, beyond, stats_rel, stats_equal = 0.0, 0, 0.0, True
        for k, want in ref[when].items():
            got = states[0][k]
            if "running" in k or "num_batches_tracked" in k:
                stats_equal = stats_equal and torch.equal(got, want)
                if "running" in k:
                    stats_rel = max(stats_rel, float(((got - want).abs() / want.abs().clamp_min(1e-3)).max()))
            else:
                d = (got - want).abs()
                worst, beyond = max(worst, float(d.max())), beyond + int((d > DP_PARAM_ATOL).sum())
        compared[when] = dict(worst=worst, beyond=beyond, stats_rel=stats_rel, stats_equal=stats_equal,
                              bitwise=all(torch.equal(states[0][k], st[k]) for st in states[1:] for k in ref[when]))
    first, final = compared["1"], compared["final"]
    for r in ranks:
        log(f"{what} rank {r['rank']} of {world} ({backend} on {r['device']}, {r['rows']} rows = {micro} whole "
            f"microbatches a step): losses {r['loss']}, grad norms {r['grad_norm']}; step "
            f"{', '.join(f'{s * 1e3:.1f}' for s in r['step_s'])} ms (the first cold); gradient all-reduce of "
            f"{r['reduce_bytes'] / 1e6:.1f} MB fp32 {', '.join(f'{s * 1e3:.1f}' for s in r['reduce_s'])} ms; "
            f"launches per step {r['launches']} (expected {per_step}) [{card}{note}]")
    log(f"{what} one process, no group, the same steps: losses {ref['loss']}; step "
        f"{', '.join(f'{s * 1e3:.1f}' for s in ref['step_s'])} ms [{card}]; the ranks in {wall:.1f} s of processes")
    for when, c, held in (("after step 1", first, "held"), (f"after step {DP_STEPS}", final, "reported")):
        log(f"{what} {when}: ranks' states bitwise equal {c['bitwise']}; against one process: max |d param| "
            f"{c['worst']:.3g} ({held}, bound {DP_PARAM_ATOL}; {c['beyond']} of {N_PARAMS} elements beyond it), "
            f"running statistics bitwise equal {c['stats_equal']}, max rel {c['stats_rel']:.3g} [{card}]")
    rel = max(abs(a - b) / b for a, b in zip(ranks[0]["loss"], ref["loss"]))
    norm_rel = abs(ranks[0]["grad_norm"][0] - ref["grad_norm"][0]) / ref["grad_norm"][0]
    log(f"{what} losses: ranks equal {all(r['loss'] == ranks[0]['loss'] for r in ranks)}, first equal to one "
        f"process's {ranks[0]['loss'][0] == ref['loss'][0]}, max rel {rel:.3g} (bound {DP_LOSS_RTOL}); step 1's "
        f"grad norm {ranks[0]['grad_norm'][0]!r} against one process's {ref['grad_norm'][0]!r}, rel {norm_rel:.3g} "
        f"(bound {DP_GRAD_NORM_RTOL}) [{card}]")
    if any(r["launches"] != [per_step] * DP_STEPS for r in ranks):
        raise AssertionError(f"dp ranks launched {[r['launches'] for r in ranks]}, expected {per_step} a step")
    if (any(r["loss"] != ranks[0]["loss"] or r["grad_norm"] != ranks[0]["grad_norm"] for r in ranks)
            or not first["bitwise"] or not final["bitwise"]):
        raise AssertionError("the dp ranks differ")
    # the running statistics after the last step are reported, not held:
    # they average bf16 forwards of weights that differ (above), and a
    # near-zero statistic moves by a large fraction of itself (measured up
    # to 4.12 relative to max(|x|, 1e-3))
    if ranks[0]["loss"][0] != ref["loss"][0] or not first["stats_equal"]:
        raise AssertionError(f"dp first step: loss {ranks[0]['loss'][0]} against {ref['loss'][0]}, running "
                             f"statistics bitwise equal {first['stats_equal']}")
    if not rel <= DP_LOSS_RTOL:
        raise AssertionError(f"dp losses {ranks[0]['loss']} against one process {ref['loss']}")
    if not norm_rel <= DP_GRAD_NORM_RTOL:
        raise AssertionError(f"dp step 1 grad norm {ranks[0]['grad_norm'][0]} against one process "
                             f"{ref['grad_norm'][0]}")
    if not first["worst"] <= DP_PARAM_ATOL:
        raise AssertionError(f"dp parameters after step 1 {first['worst']} from one process's")
    return [sum(sum(s[i] for s in r["launches"]) for r in ranks) for i in (0, 1, 2)]


def dp_trainers(work: str, world: int, backend: str, card: str, what: str) -> list:
    """dp_trainer as ``world`` ranks of ``backend``, then without a group:
    histories bitwise equal across the ranks, and to the run without a
    group for one rank (every collective an identity: measured so) or
    within DP_LOSS_RTOL of it for several, exact launch counts, latest and
    best.pth written. Returns the (B1, B2) launches of all ranks."""
    if not os.path.isdir(os.path.join(work, "cache_data")):
        from pcmseg_tpu_torch.core.config import get_config

        write_train_tree(os.path.join(work, "cache_data"), get_config().modalities, CACHE_CASES, ext=".nii")
    port, t0 = free_port(), time.perf_counter()
    runs = spawn_ranks(lambda r: ["--dp-trainer", str(r), str(world), str(port), work, backend, f"g{world}"], world)
    wall = time.perf_counter() - t0
    alone = spawn_ranks(lambda r: ["--dp-trainer", "0", "0", "0", work, backend, f"alone{world}"], 1)[0]
    ranks, walls = runs[0], ", ".join(f"{r['wall_s']:.1f}" for r in runs)
    rel = max(abs(a - b) / abs(b) for k in ("train_loss", "val_loss")
              for a, b in zip(ranks["history"][k], alone["history"][k]))
    log(f"{what} {world}-rank {ranks['backend']} group, Trainer over {CACHE_CASES} cases x {DP_EPOCHS} epochs "
        f"(cache sharded {ranks['sharded_cache']}, {[r['cached_rows'] for r in runs]} cases a rank, async "
        f"checkpoints, collapse {ranks['collapse']}, mesh {ranks['mesh']}): history {json.dumps(ranks['history'])}, "
        f"train() {walls} s; launches "
        f"{[r['launches'] for r in runs]} (expected {ranks['want']} a rank); without a group "
        f"{json.dumps(alone['history'])}, {alone['wall_s']:.1f} s; losses max rel diff {rel:.3g}; processes "
        f"{wall:.1f} s [{card}]")
    if ranks["backend"] != backend or not ranks["sharded_cache"] or ranks["collapse"] or alone["sharded_cache"]:
        raise AssertionError(f"{world}-rank {backend} trainer: {ranks}")
    if any(r["history"] != ranks["history"] for r in runs):
        raise AssertionError("the trainer's ranks differ")
    for r in runs + [alone]:
        if r["launches"] != r["want"] or r["latest_epoch"] != DP_EPOCHS - 1 or not r["best_pth"]:
            raise AssertionError(f"dp trainer: {r}")
        if not all(math.isfinite(v) for vals in r["history"].values() for v in vals):
            raise AssertionError(f"non-finite history {r['history']}")
    if world == 1 and ranks["history"] != alone["history"]:
        raise AssertionError(f"the one-rank group's history differs from no group's ({rel:.3g} apart)")
    if not rel <= DP_LOSS_RTOL:
        raise AssertionError(f"the {world}-rank group trains {rel:.3g} away from no group")
    return [sum(r["launches"][i] for r in runs) for i in (0, 1)]


def dp_c_rank(rank: int, world: int, port: int, work: str, backend: str) -> dict:
    """One rank of dp (c) (``chip_smoke.py --dp-c-rank RANK WORLD PORT WORK
    BACKEND``): the flagship model from the seed, one step on this rank's
    rows of the first dp batch in DP_C_ACCUM microbatches, in the layout
    ``sharding.microbatch_layout`` gives (c at WORLD 4), launches counted;
    its state's ``state_digest``."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.ops.kernels import batchnorm, conv3d, conv3d_grad
    from pcmseg_tpu_torch.parallel import multihost
    from pcmseg_tpu_torch.parallel.sharding import Mesh, microbatch_layout, shard_batch, shard_state
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    multihost.initialize(f"localhost:{port}", num_processes=world, process_id=rank, backend=backend)
    device = torch.device("cuda", 0)
    multihost.establish_collectives()
    config = get_config(base_features=BASE_FEATURES, **{**TRAIN, "accum_steps": DP_C_ACCUM})
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    shard_state(model, Mesh(world))
    state, step = create_train_state(model, config), make_train_step(model, config)
    local = shard_batch(dp_batches(device)[0], Mesh(world), rank=rank, accum=DP_C_ACCUM)
    torch.cuda.synchronize(device)
    conv3d.launches = conv3d_grad.launches = batchnorm.launches = 0
    t = time.perf_counter()
    metrics = step(state, local)
    torch.cuda.synchronize(device)
    out = {"rank": rank, "rows": len(local["image"]), "step_s": time.perf_counter() - t,
           "layout": microbatch_layout(TRAIN["batch_size"], DP_C_ACCUM, world),
           "loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
           "launches": [conv3d.launches, conv3d_grad.launches, batchnorm.launches]}
    out["state"] = state_digest(model.state_dict())
    multihost.shutdown()
    return out


def dp_layout_c(work: str, device, card: str) -> list:
    """(c) DP_C_RANKS gloo ranks sharing the card, batch 4 in DP_C_ACCUM
    microbatches: the ranks divide neither the microbatch of 2 nor the 2
    microbatches (layout (c)): two groups of 2 ranks, each group one
    microbatch, a row a rank, BatchNorm and the loss summed over the
    group. One step: every rank's state, loss and grad norm bitwise equal,
    35 B1, 18 B2 and 72 BatchNorm launches a rank (its one microbatch), the loss within
    DP_LOSS_RTOL of one process's same step (the group sums BatchNorm's
    statistics in another order) and the grad norm reported beside it.
    Returns the (B1, B2, BatchNorm) launches of all ranks."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    config = get_config(base_features=BASE_FEATURES, **{**TRAIN, "accum_steps": DP_C_ACCUM})
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    state, step = create_train_state(model, config), make_train_step(model, config)
    one = step(state, dp_batches(device)[0])
    one = {k: float(v) for k, v in one.items()}
    del model, state, step
    torch.cuda.empty_cache()
    port, t0 = free_port(), time.perf_counter()
    ranks = spawn_ranks(lambda r: ["--dp-c-rank", str(r), str(DP_C_RANKS), str(port), work, "gloo"], DP_C_RANKS)
    wall = time.perf_counter() - t0
    bitwise = all(r["state"] == ranks[0]["state"] for r in ranks)
    same = all((r["loss"], r["grad_norm"]) == (ranks[0]["loss"], ranks[0]["grad_norm"]) for r in ranks)
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    log(f"dp (c) {DP_C_RANKS} gloo ranks on one card, batch {TRAIN['batch_size']} in {DP_C_ACCUM} microbatches, "
        f"layout {ranks[0]['layout']} ({ranks[0]['rows']} row a rank): loss {ranks[0]['loss']:.8g}, grad norm "
        f"{ranks[0]['grad_norm']:.8g}; one process {one['loss']:.8g} / {one['grad_norm']:.8g}: loss rel "
        f"{rel(ranks[0]['loss'], one['loss']):.3g} (bound {DP_LOSS_RTOL}), grad norm rel "
        f"{rel(ranks[0]['grad_norm'], one['grad_norm']):.3g} (reported); every rank's state bitwise equal {bitwise}, "
        f"metrics equal {same}; launches {[r['launches'] for r in ranks]}; step "
        f"{', '.join(f'{r['step_s'] * 1e3:.0f}' for r in ranks)} ms (cold); processes {wall:.1f} s [{card}]")
    # a rank's one microbatch: 35 B1, 18 B2 and 72 BatchNorm launches, synchronised over its group
    if not bitwise or not same or any(r["layout"] != "c" or r["launches"] != [35, 18, 72] for r in ranks):
        raise AssertionError("dp (c): the ranks differ, or a rank ran other than one microbatch in layout (c)")
    if not math.isfinite(ranks[0]["loss"]) or rel(ranks[0]["loss"], one["loss"]) > DP_LOSS_RTOL:
        raise AssertionError("dp (c): the loss is off one process's")
    return [sum(r["launches"][i] for r in ranks) for i in (0, 1, 2)]


def dp_phase(work: str, device, card: str, ref: dict):
    """Data parallelism across processes on the one card: (a) DP_RANKS
    processes in a gloo group on CUDA tensors (NCCL refuses two ranks on
    one device) through ``dp_steps`` (gloo's all-reduce goes through the
    host: its times on a shared card are not NCCL's) against ``ref``
    (dp_reference); (b) a one-rank NCCL group through ``dp_trainers``; (c)
    layout (c) on DP_C_RANKS gloo ranks through ``dp_layout_c``. Returns the
    (B1, B2, BatchNorm) launches of (a)'s and of (c)'s ranks, and the (B1,
    B2) of (b)."""
    launches_a = dp_steps(work, ref, DP_RANKS, "gloo", card, "dp (a)")
    launches_b = dp_trainers(work, 1, "nccl", card, "dp (b)")
    return launches_a, launches_b, dp_layout_c(work, device, card)


# ---- spatial parallelism (slice 9) ------------------------------------------------

# (a) serving: a 128^3 case and one twice the window deep, which the sharded
# Predictor serves whole and the unsharded one tiles
SP_LONG = 2 * SIZE
# (a) the sharded fp32 forward (plain conv, TF32 off) against the unsharded
# one: the same sums in another order only
SP_FP32_BOUND = 1e-4
# (b) the sharded steps against the one-process steps (dp_reference: the same
# weights and batches). Each rank's bf16 forward differs from one process's
# in rounding only: BatchNorm sums its slabs' statistics, and B1 splits K
# otherwise at a slab's shape for one conv (dx: two), so some bf16
# activations round the other way, and this random-init network carries
# such differences far (the gradient phase's bf16-vs-fp32 distance, ~0.69);
# in fp32 through the plain conv the same sums in another order still moved
# one conv's weight gradient by 9% of its largest entry (on an H100, 700 W).
# So the sharding is held where rounding cannot hide a fault: step 1 again
# in float64 through the plain conv (the logits and the loss in fp32, as the
# model returns them), sharded against one process, the loss and grad norm
# within SP_EXACT_RTOL and each gradient tensor within SP_EXACT_SHARE of its
# largest entry. The bf16 kernel step is held as the gradient phase holds a
# bf16 gradient: its loss within SP_LOSS1_RTOL of one process's, and its
# grad norm and each gradient tensor no further from the float64 step's than
# BF16_MARGIN times one process's bf16 step is, plus GRAD_SLACK of the
# float64 value. The biases of the BN-preceded convs are left out of the
# shares: their true gradient is 0, and what remains is rounding. The float64
# step's gradients still meet one fp32 rounding: the gradient all-reduce sums
# each rank's partial in an fp32 buffer, and where a tensor's partials cancel
# that rounding is a larger share of its sum (2.5e-7 at base 4, 32^3 on the
# CPU), so SP_EXACT_SHARE sits above it, far below a fault's (a missing halo
# moves the gradients of every conv by the share of voxels at the seams).
# Steps 2-3: the losses within SP_LOSS_RTOL.
SP_EXACT_RTOL = 1e-9
SP_EXACT_SHARE = 1e-4
SP_LOSS1_RTOL = 1e-5
SP_LOSS_RTOL = 1e-4
SP_EPOCHS = 1


def halo_bytes(model, size: int, shards: int) -> int:
    """Bytes of the halo slices that cross between ``shards`` D-slabs in one
    forward of ``model`` at ``size`` (H = W): every 3³ conv's input, one bf16
    slice of its level each way across each of the shards - 1 seams."""
    from pcmseg_tpu_torch.models.unet3d import Conv3x3

    return sum(2 * (shards - 1) * (size >> m.level) ** 2 * m.weight.shape[1] * 2
               for m in model.modules() if isinstance(m, Conv3x3))


def split_plans(model, depth: int, size: int, shards: int, device) -> list:
    """Per 3³ conv of a forward at (depth, size, size): (B1's split-K count for
    the whole volume, for one of ``shards`` halo-extended D-slabs)."""
    import torch

    from pcmseg_tpu_torch.models.unet3d import Conv3x3
    from pcmseg_tpu_torch.ops.kernels.build import load_library
    from pcmseg_tpu_torch.ops.kernels.conv3d import device_clusters, kernel_plan

    lib, index = load_library(), torch_device_index(device)
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    clusters = device_clusters(lib, index)

    def splits(d, s, ci, co):
        return kernel_plan(lib, 1, d, s, s, ci, co, sms, clusters)["splits"]

    out = []
    for m in model.modules():
        if isinstance(m, Conv3x3):
            co, ci = m.weight.shape[:2]
            d, s = depth >> m.level, size >> m.level
            out.append((splits(d, s, ci, co), splits(d // shards + 2, s, ci, co)))
    return out


def torch_device_index(device) -> int:
    import torch

    return torch.device(device).index if torch.device(device).index is not None else torch.cuda.current_device()


def sp_serving(work: str, device, card: str) -> int:
    """(a) The folded flagship model served with spatial_parallel = SP_RANKS
    on shards ["cuda:0"] * SP_RANKS (and across cards where the host has
    them): a 128^3 case, and the case continued to SP_LONG deep (its
    mirror image below it), which the sharded Predictor serves whole and
    the unsharded one tiles, each against an unsharded whole-volume
    forward. The sharding is held in fp32 (the plain conv on both sides,
    within SP_FP32_BOUND); the kernel's bf16 probabilities bitwise equal to
    the unsharded ones where B1 splits K alike for every slab and volume,
    else as check_probs holds a bf16 forward: no further from fp32 than
    BF16_MARGIN times the unsharded kernel's distance, and its mask no
    further from fp32's than BF16_MARGIN times that one's; exactly 18 B1 a
    shard-forward, every one on a halo-extended slab. Returns the
    launches."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.models import unet3d
    from pcmseg_tpu_torch.ops.kernels import conv3d

    config = get_config(base_features=BASE_FEATURES, norm_layer="batch")
    inbox, pth = os.path.join(work, "inbox"), os.path.join(work, "model.pth")
    if not os.path.isfile(pth):  # the phase alone (--only sp)
        write_cases(inbox, config.modalities)
        make_checkpoint(pth, config, os.path.join(inbox, sorted(CASES)[0]), device)
    plain = Predictor(config, pth, device=device)
    sp_config = config.replace(spatial_parallel=SP_RANKS)
    arms = [(f"{SP_RANKS} shards on {device}", Predictor(sp_config, pth, device=device,
                                                          shard_devices=[str(device)] * SP_RANKS))]
    if torch.cuda.device_count() >= SP_RANKS:
        arms.append((f"{SP_RANKS} cards", Predictor(sp_config, pth, device=device)))
    else:
        log(f"sp (a): {torch.cuda.device_count()} card(s): the sharded forward across cards is not run")
    image = plain.load_case(os.path.join(inbox, "case_a"))[0]
    if image.shape[:3] != (SIZE,) * 3:
        raise AssertionError(f"case_a is {image.shape}")
    cases = {f"{SIZE}^3": image, f"{SP_LONG}x{SIZE}^2": np.concatenate([image, image[::-1]], axis=0)}
    real_conv, depths = unet3d.conv3x3x3, []

    def recording(x, *args, **kwargs):  # the D of every B1 input, from every shard's thread
        depths.append(x.shape[1])
        return real_conv(x, *args, **kwargs)

    def whole(img):  # the unsharded Predictor's forward of the whole volume, untiled
        with torch.inference_mode():
            return plain._apply(plain._upload(img)[None])[0].float().cpu().numpy()

    def flips(p, ref):
        return int(((p[..., 0] > 0.5) != (ref[..., 0] > 0.5)).sum())

    total = 0
    for name, img in cases.items():
        want = whole(img)
        with plain_conv(plain.models, torch.float32):
            exact = whole(img)
        tiled_plain = plain.predict_probs(img)
        if bool(plain._sw_fns) != (img.shape[0] > config.window_size[0]):
            raise AssertionError(f"{name}: the unsharded Predictor tiled {bool(plain._sw_fns)}")
        plans = split_plans(plain.models[0], img.shape[0], SIZE, SP_RANKS, device)
        same_splits = all(a == b for a, b in plans)
        err_un = np.abs(want - exact)
        for arm, sp in arms:
            sp._sw_fns.clear()
            conv3d.launches, depths[:] = 0, []
            unet3d.conv3x3x3 = recording
            try:
                got = sp.predict_probs(img)
            finally:
                unet3d.conv3x3x3 = real_conv
            launches, seen = conv3d.launches, sorted(set(depths))
            total += launches
            slabs = sorted({(img.shape[0] >> level) // SP_RANKS + 2 for level in range(5)})
            if sp._sw_fns or launches != 18 * SP_RANKS or seen != slabs or len(depths) != 18 * SP_RANKS:
                raise AssertionError(f"sp (a) {name} {arm}: tiled {bool(sp._sw_fns)}, {launches} B1 launches "
                                     f"(expected {18 * SP_RANKS}), input depths {seen} (expected {slabs})")
            with plain_conv([m for members in sp.replicas.values() for m in members], torch.float32):
                got_exact = sp.predict_probs(img)
            sp._sw_fns.clear()
            d, d32, err_sp = np.abs(got - want), np.abs(got_exact - exact), np.abs(got - exact)
            mask_s = min(timed_s(lambda: sp.predict_mask(img)) for _ in range(3))
            plain_s = min(timed_s(lambda: plain.predict_mask(img)) for _ in range(3))
            log(f"sp (a) {name} served by {arm}: whole (no tiles), {launches} B1 launches = 18 a shard-forward, "
                f"every conv on a halo-extended slab (input D {seen}); fp32 plain conv sharded against "
                f"unsharded: max|dp| {d32.max():.3g} (bound {SP_FP32_BOUND}); B1 splits K alike for slab and "
                f"volume at {sum(a == b for a, b in plans)} of 18 convs; bf16 kernel sharded against unsharded: "
                f"bitwise equal {bool(np.array_equal(got, want))}, max|dp| {d.max():.4g}, mean|dp| {d.mean():.3g}, "
                f"mask voxels differing {flips(got, want)} of {img[..., 0].size}; against fp32: sharded max|dp| "
                f"{err_sp.max():.4g} mean {err_sp.mean():.3g}, {flips(got, exact)} mask voxels off, unsharded "
                f"max|dp| {err_un.max():.4g} mean {err_un.mean():.3g}, {flips(want, exact)} off (bound "
                f"{BF16_MARGIN}x); the unsharded Predictor {'tiled' if plain._sw_fns else 'whole'}, "
                f"{np.abs(tiled_plain - want).max():.4g} from the whole forward; device path (H2D, forward, "
                f"threshold, D2H) sharded {mask_s * 1e3:.1f} ms, unsharded {plain_s * 1e3:.1f} ms"
                f"{' (tiled)' if plain._sw_fns else ''}; halo {halo_bytes(plain.models[0], SIZE, SP_RANKS) / 1e6:.1f}"
                f" MB across the seam a forward [{card}]")
            if not (np.isfinite(got).all() and d32.max() <= SP_FP32_BOUND):
                raise AssertionError(f"sp (a) {name} {arm}: the fp32 sharded forward {d32.max()} from the unsharded")
            if same_splits and not np.array_equal(got, want):
                raise AssertionError(f"sp (a) {name} {arm}: not bitwise equal where every split matches")
            if (err_sp.max() > BF16_MARGIN * err_un.max() + 1e-3 or err_sp.mean() > BF16_MARGIN * err_un.mean() + 1e-4
                    or flips(got, exact) > BF16_MARGIN * flips(want, exact) + 1e-5 * err_sp[..., 0].size):
                raise AssertionError(f"sp (a) {name} {arm}: the sharded bf16 forward is further from fp32 than "
                                     f"{BF16_MARGIN}x the unsharded one")
    del plain, arms
    torch.cuda.empty_cache()
    return total


def timed_s(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


@contextlib.contextmanager
def timed_halos(device, tally: dict):
    """Inside, every halo exchange (forward and backward) is synchronised and
    timed into ``tally``, with the bytes of the neighbours' slices a rank
    receives."""
    import torch

    from pcmseg_tpu_torch.parallel import collectives

    fn = collectives._HaloExchange
    saved = fn.forward, fn.backward

    def timed(real):
        def run(ctx, t, *args):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = real(ctx, t, *args)
            torch.cuda.synchronize(device)
            tally["s"] += time.perf_counter() - t0
            tally["bytes"] += 2 * (ctx.comm.size - 1) * t[:, :1].numel() * t.element_size()
            tally["calls"] += 1
            return out
        return staticmethod(run)

    fn.forward, fn.backward = timed(saved[0]), timed(saved[1])
    try:
        yield
    finally:
        fn.forward, fn.backward = staticmethod(saved[0]), staticmethod(saved[1])


def sp_rank(rank: int, world: int, port: int, work: str, backend: str) -> dict:
    """One rank of a spatial group (``chip_smoke.py --sp-rank RANK WORLD PORT
    WORK BACKEND``): the flagship model from the seed on a data 1 x spatial
    WORLD mesh, DP_STEPS steps of dp_batches, each rank on its D-slab of
    all 4 microbatches; each step timed and its launches counted, the
    gradient all-reduce timed inside it, the peak memory of the warm steps;
    then one more step with every halo exchange timed; then the float64
    step 1 on anchor_batch. Returns the ``state_digest`` after step 1 and
    after the last, and writes step 1's gradients (rank 0) to
    WORK/sp_grads.pt."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.parallel import collectives, multihost
    from pcmseg_tpu_torch.parallel.sharding import Mesh, shard_batch, shard_state
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    multihost.initialize(f"localhost:{port}", num_processes=world, process_id=rank, backend=backend)
    device = multihost.local_device() if backend == "nccl" else torch.device("cuda", 0)
    multihost.establish_collectives()
    config = get_config(base_features=BASE_FEATURES, spatial_parallel=world, **TRAIN)
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    mesh = Mesh(1, world)
    shard_state(model, mesh)
    state = create_train_state(model, config)
    step = make_train_step(model, config, mesh=mesh)
    reduce_s, real_reduce = [], collectives.GradientAllReduce.__call__

    def timed_reduce(self):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        real_reduce(self)
        torch.cuda.synchronize(device)
        reduce_s.append(time.perf_counter() - t)

    collectives.GradientAllReduce.__call__ = timed_reduce
    out = {"rank": rank, "device": str(device), "loss": [], "grad_norm": [], "step_s": [], "launches": []}
    grads = {}
    batches = dp_batches(device)
    with first_gradients(model, grads):
        for batch in batches:
            local = shard_batch(batch, mesh, rank=rank, accum=config.accum_steps)
            torch.cuda.synchronize(device)
            if len(out["loss"]) == 1:
                torch.cuda.reset_peak_memory_stats(device)
            conv3d.launches = conv3d_grad.launches = 0
            t = time.perf_counter()
            metrics = step(state, local)
            out["loss"].append(float(metrics["loss"]))
            torch.cuda.synchronize(device)
            out["step_s"].append(time.perf_counter() - t)
            out["launches"].append([conv3d.launches, conv3d_grad.launches])
            out["grad_norm"].append(float(metrics["grad_norm"]))
            if len(out["loss"]) in (1, DP_STEPS):
                out["1" if len(out["loss"]) == 1 else "final"] = state_digest(model.state_dict())
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    if rank == 0:
        torch.save(grads, os.path.join(work, "sp_grads.pt"))
    halo = {"s": 0.0, "bytes": 0, "calls": 0}
    with timed_halos(device, halo):
        local = shard_batch(batches[0], mesh, rank=rank, accum=config.accum_steps)
        t = time.perf_counter()
        float(step(state, local)["loss"])
        torch.cuda.synchronize(device)
        halo["step_s"] = time.perf_counter() - t
    out.update(reduce_s=reduce_s, rows=len(local["image"]), slab=list(local["d_slab"]), halo=halo,
               reduce_bytes=4 * sum(p.numel() for p in model.parameters() if p.requires_grad))
    del model, state, step
    out["exact"] = exact_first_step(anchor_config(config), anchor_batch(batches[0]), device, mesh, rank,
                                    os.path.join(work, "sp_grads64.pt"))
    multihost.shutdown()
    return out


def exact_first_step(config, batch, device, mesh=None, rank=0, path=None) -> dict:
    """Step 1 of the flagship model from the seed in float64 through the
    plain conv: on ``mesh`` (this rank's part of ``batch``; on a model axis
    this rank's shards of the model, the gradients gathered whole after),
    or in one process. Returns the loss and grad norm, and its gradients
    before the clip and Adam (written to ``path`` on rank 0 where given)."""
    import torch

    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.parallel import collectives
    from pcmseg_tpu_torch.parallel.sharding import shard_batch, shard_state, whole_payload
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    axes = shard_state(model, mesh) if mesh is not None else None
    state, step = create_train_state(model, config), make_train_step(model, config, mesh=mesh)
    grads = {}
    if mesh is not None:
        batch = shard_batch(batch, mesh, rank=rank, accum=config.accum_steps)
    with plain_train_conv(model, torch.float64), first_gradients(model, grads):
        metrics = step(state, batch)
        out = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
    if axes is not None:
        grads = whole_payload({"model": grads, "optimizer": {"state": {}}}, axes, [],
                              collectives.mesh_comms(mesh).model)["model"]
    if path is None:
        out["grads"] = grads
    elif rank == 0:
        torch.save(grads, path)
    del model, state, step
    torch.cuda.empty_cache()
    return out


def one_process_exact(ref: dict) -> dict:
    """exact_first_step in one process on the first dp batch, made once and
    kept in ``ref`` (dp_reference) for the fp32, fp16, sp and tp phases."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config

    if "exact" not in ref:
        ref["exact"] = exact_first_step(get_config(base_features=BASE_FEATURES, **TRAIN),
                                        dp_batches(torch.device("cuda"))[0], torch.device("cuda"))
    return ref["exact"]


# the sp and tp ranks' float64 step 1 (their exactness anchor) runs on the
# first row of the first dp batch as one microbatch: the mesh shards every
# microbatch alike, and on 4 microbatches it took 103 s a tp rank (gloo
# through the host on one card), the longest part of the script
def anchor_config(config):
    return config.replace(batch_size=1, accum_steps=1)


def anchor_batch(batch: dict) -> dict:
    return {k: v[:1] for k, v in batch.items()}


def one_process_anchor(ref: dict) -> dict:
    """exact_first_step in one process on anchor_batch of the first dp
    batch, made once and kept in ``ref`` for the sp and tp phases."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config

    if "anchor" not in ref:
        ref["anchor"] = exact_first_step(anchor_config(get_config(base_features=BASE_FEATURES, **TRAIN)),
                                         anchor_batch(dp_batches(torch.device("cuda"))[0]), torch.device("cuda"))
    return ref["anchor"]


# ---- fp32 compute and 16-bit parameters (slice 11) ---------------------------------

# the fp32 step's loss and each gradient may be at most this many times
# further from the float64 step than the plain-conv fp32 step's, plus FP32_STEP_SLACK
FP32_STEP_MARGIN = 1.5
FP32_STEP_SLACK = 1e-6


def all_counts() -> tuple:
    """(B1 bf16, B1 fp32, B1 fp16, B2 bf16, B2 fp32, B2 fp16) launches since
    the counts were set to 0."""
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad

    return (conv3d.launches, conv3d.launches_f32, conv3d.launches_f16,
            conv3d_grad.launches, conv3d_grad.launches_f32, conv3d_grad.launches_f16)


def counts() -> tuple:
    """(B1 bf16, B1 fp32, B2 bf16, B2 fp32) launches since the counts were
    set to 0, on a path that computes in bf16 or fp32: an fp16 launch there
    raises."""
    b1, b1_32, b1_16, b2, b2_32, b2_16 = all_counts()
    if b1_16 or b2_16:
        raise AssertionError(f"{b1_16} fp16 B1 and {b2_16} fp16 B2 launches on a bf16 / fp32 path")
    return b1, b1_32, b2, b2_32


def counts16() -> tuple:
    """(B1 fp16, B2 fp16) launches since the counts were set to 0, on a path
    that computes in fp16: a bf16 or fp32 launch there raises."""
    b1, b1_32, b1_16, b2, b2_32, b2_16 = all_counts()
    if b1 or b1_32 or b2 or b2_32:
        raise AssertionError(f"bf16 / fp32 launches (B1 {b1} / {b1_32}, B2 {b2} / {b2_32}) on an fp16 path")
    return b1_16, b2_16


def zero_counts() -> None:
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad

    for module in (conv3d, conv3d_grad):
        module.launches = module.launches_f32 = module.launches_f16 = 0


def train_tree(work: str, modalities) -> str:
    """The train phase's 5 synthetic 128^3 cases (written here when that
    phase has not run: ``--only fp32``)."""
    data = os.path.join(work, "train_data")
    if not os.path.isdir(os.path.join(data, "BPH-PCA")):
        write_train_tree(data, modalities, TRAIN_CASES)
    return data


def rel_dist(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300)).item()


def fp32_train(work: str, device, card: str, ref: dict) -> dict:
    """``compute_dtype='float32'`` on the card through the fp32 kernels.
    (a) 3 flagship steps (base 64, 128^3, batch 4 as 4 x 1, Dice, Adam
    1e-4) from the seed on the dp batches: per step exactly 4 x (18 + 17)
    fp32 B1 and 4 x 18 fp32 B2 launches and no bf16 launch; step 1's loss
    and every gradient tensor (the BN-preceded conv biases, of true
    gradient 0, logged apart) no further from the float64 step
    (``one_process_exact``) than FP32_STEP_MARGIN times the plain-conv fp32
    step's distance plus FP32_STEP_SLACK; the warm steps' ms, vol/s, peak
    memory and device time by kernel. (b) One epoch of a fp32 ``Trainer``
    (run_epochs, no checkpoints) on the train phase's 5 cases, exact
    launches. (c) One 128^3 case served by an fp32 ``Predictor``: 18 fp32
    B1 launches, its probabilities within FP32_MARGIN times the plain fp32
    conv's distance from float64 plus FP32_SLACK. Returns the launches of
    each part."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.ops.losses import loss_fn_from_config
    from pcmseg_tpu_torch.train.checkpoints import save_pth
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step
    from pcmseg_tpu_torch.train.trainer import Trainer

    out = {}
    exact = one_process_exact(ref)
    config = get_config(base_features=BASE_FEATURES, **{**TRAIN, "compute_dtype": "float32"})
    batches = [{k: v.float() if v.is_floating_point() else v for k, v in b.items()} for b in dp_batches(device)]
    # the plain-conv fp32 step 1, the yardstick
    plain_grads = {}
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    state, step = create_train_state(model, config), make_train_step(model, config)
    with plain_train_conv(model, torch.float32), first_gradients(model, plain_grads):
        plain_loss = float(step(state, batches[0])["loss"])
    del model, state, step
    # tensors of this and earlier phases that wait in reference cycles would
    # count toward the kernel steps' peak
    held = torch.cuda.memory_allocated(device)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"fp32 step: {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated before the model, "
        f"{(held - torch.cuda.memory_allocated(device)) / 2**30:.2f} GiB freed by gc.collect()")
    # the kernel steps
    grads, times = {}, []
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    state, step = create_train_state(model, config), make_train_step(model, config)
    with first_gradients(model, grads):
        for i, batch in enumerate(batches):
            zero_counts()
            if i == 1:
                torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = float(step(state, batch)["loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            got, want = counts(), (0, 4 * 35, 0, 4 * 18)
            if got != want:
                raise AssertionError(f"fp32 step {i + 1} launched (B1 bf16, B1 fp32, B2 bf16, B2 fp32) {got}, "
                                     f"expected {want}")
            if i == 0:
                out["step"] = (got[1], got[3])
                first_loss = loss
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    loss_k, loss_p = abs(first_loss - exact["loss"]), abs(plain_loss - exact["loss"])
    log(f"fp32 step 1: loss {first_loss:.8g} (float64 {exact['loss']:.8g}, plain fp32 {plain_loss:.8g}): "
        f"|dL| kernel {loss_k:.3g}, plain {loss_p:.3g}")
    if not math.isfinite(first_loss) or loss_k > FP32_STEP_MARGIN * loss_p + FP32_STEP_SLACK:
        raise AssertionError("the fp32 step's loss is further from float64 than the plain fp32 step's")
    worst, cancelled = (0.0, ""), []
    for k, g64 in exact["grads"].items():
        d_k, d_p = rel_dist(grads[k], g64), rel_dist(plain_grads[k], g64)
        if re.search(r"conv\.[03]\.bias$", k):
            cancelled.append((d_k, d_p))
            continue
        worst = max(worst, (d_k / (FP32_STEP_MARGIN * d_p + FP32_STEP_SLACK), k))
        if d_k > FP32_STEP_MARGIN * d_p + FP32_STEP_SLACK:
            raise AssertionError(f"{k}: the fp32 step's gradient is {d_k:.3g} from float64 (relative), the plain "
                                 f"fp32 step's {d_p:.3g}")
    log(f"fp32 step 1 gradients, {len(exact['grads'])} tensors against float64: worst distance/bound "
        f"{worst[0]:.3g} at {worst[1]}; the {len(cancelled)} BN-preceded conv biases (true gradient 0, logged "
        f"only): relative distance kernel up to {max(c[0] for c in cancelled):.3g}, plain "
        f"{max(c[1] for c in cancelled):.3g} [{card}]")
    warm = sorted(times[1:])[len(times[1:]) // 2]
    log(f"fp32 flagship step (batch 4 = 4 x 1): warm {warm * 1e3:.1f} ms ({', '.join(f'{t * 1e3:.1f}' for t in times)}"
        f" ms for steps 1-{len(times)}) = {TRAIN['batch_size'] / warm:.3f} vol/s, peak device memory {peak:.2f} GiB "
        f"[{card}]")
    profile_step(lambda: float(step(state, batches[-1])["loss"]), "one fp32 step", card)
    del model, state, step, grads, plain_grads
    torch.cuda.empty_cache()

    # (b) one epoch of an fp32 Trainer
    data = train_tree(work, config.modalities)
    tconfig = config.replace(data_dir=data, save_dir=os.path.join(work, "fp32_ckpt"),
                             cache_dir=os.path.join(work, "preproc"), seed=0, num_epochs=1)
    trainer = Trainer(tconfig, device=device)
    zero_counts()
    t = time.perf_counter()
    history = run_epochs(trainer, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    b1, b2 = expected_train_launches(tconfig, steps=1, eval_forwards=1)
    got = counts()
    log(f"fp32 Trainer, 1 epoch ({data_path(trainer, TRAIN_CASES)}): {wall:.1f} s, history {json.dumps(history)}; "
        f"launches (B1 bf16, B1 fp32, B2 bf16, B2 fp32) {got} [{card}]")
    if got != (0, b1, 0, b2):
        raise AssertionError(f"fp32 Trainer launched {got}, expected {(0, b1, 0, b2)}")
    if not all(math.isfinite(v) for vals in history.values() for v in vals):
        raise AssertionError(f"non-finite fp32 history {history}")
    out["trainer"] = (got[1], got[3])
    pth = os.path.join(work, "fp32_model.pth")
    save_pth(pth, trainer.state.model.state_dict(), tconfig.to_dict())
    del trainer
    torch.cuda.empty_cache()

    # (c) one case served in fp32
    predictor = Predictor(get_config(base_features=BASE_FEATURES, compute_dtype="float32"), pth, device=device)
    case = os.path.join(work, "fp32_case")
    for m in config.modalities:
        os.makedirs(os.path.join(case, m), exist_ok=True)
        shutil.copy(os.path.join(data, "BPH-PCA", "BPH", m, "case000.nii.gz"), os.path.join(case, m, "t.nii.gz"))
    image, _ = predictor.load_case(case)
    zero_counts()
    probs = predictor.predict_probs(image)
    got = counts()
    if got != (0, 18, 0, 0):
        raise AssertionError(f"fp32 serving launched {got}, expected 18 fp32 B1")
    with plain_conv(predictor.models, torch.float32):
        plain = predictor.predict_probs(image)
    with plain_conv(predictor.models, torch.float64):
        exact64 = predictor.predict_probs(image)
    err_k, err_p = np.abs(probs - exact64).max(), np.abs(plain - exact64).max()
    log(f"fp32 serving, one 128^3 case: 18 fp32 B1 launches; max|p - p_float64| kernel {err_k:.4g}, plain fp32 "
        f"{err_p:.4g} (bound {FP32_MARGIN * err_p + FP32_SLACK:.4g}), foreground {(probs > 0.5).mean():.4f}")
    if not np.isfinite(probs).all() or err_k > FP32_MARGIN * err_p + FP32_SLACK:
        raise AssertionError("the fp32 kernel's probabilities are further from float64 than the plain fp32 conv's")
    out["serve"] = got[1]
    del predictor
    shutil.rmtree(os.path.join(work, "fp32_ckpt"), ignore_errors=True)
    os.remove(pth)
    torch.cuda.empty_cache()
    return out


def param_dtype_phase(work: str, device, card: str) -> dict:
    """``param_dtype='bfloat16'`` on the card, bf16 compute. (a)
    PARAM_DTYPE_STEPS flagship steps from the seed: parameters and Adam's
    moments bf16 (``Adam16``, the count int32), BN running statistics fp32,
    each step exactly the bf16 step's 4 x 35 B1 and 4 x 18 B2 launches,
    finite losses; the median ms of the warm steps (all but the first) and
    the peak memory beside the same steps with fp32 parameters. (b) A
    1-epoch bf16-param Trainer on the train phase's 5 cases writes a bf16
    ``best.pth``, which a bf16-param Predictor serves (18 bf16 B1, its
    parameters bf16), within PLAIN_MAX_DP / PLAIN_MEAN_DP of the same file
    served with fp32 parameters. Returns the launches of each part."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.train.checkpoints import load_pth
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step
    from pcmseg_tpu_torch.train.trainer import Trainer

    out = {}
    batches = dp_batches(device)
    batches = [batches[i % len(batches)] for i in range(PARAM_DTYPE_STEPS)]
    peaks, step_ms = {}, {}
    for pdt in ("bfloat16", "float32"):
        gc.collect()  # as in fp32_train: only this step's tensors in its peak
        config = get_config(base_features=BASE_FEATURES, param_dtype=pdt, **TRAIN)
        model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
        state, step = create_train_state(model, config), make_train_step(model, config)
        warm = []
        for i, batch in enumerate(batches):
            zero_counts()
            if i == 1:
                torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = float(step(state, batch)["loss"])
            torch.cuda.synchronize()
            if i:
                warm.append((time.perf_counter() - t) * 1e3)
            got = counts()
            if got != (4 * 35, 0, 4 * 18, 0) or not math.isfinite(loss):
                raise AssertionError(f"param_dtype={pdt} step {i + 1}: loss {loss}, launches {got}, expected "
                                     f"{(4 * 35, 0, 4 * 18, 0)}")
            if pdt == "bfloat16" and i == 0:
                out["step"] = (got[0], got[2])
        peaks[pdt] = torch.cuda.max_memory_allocated(device) / 2**30
        step_ms[pdt] = float(np.median(warm))
        if pdt == "bfloat16":
            kinds = ({p.dtype for p in model.parameters()}, {m.dtype for s in state.optimizer.state.values()
                                                               for m in (s["mu"], s["nu"])},
                     {b.dtype for k, b in model.named_buffers() if "running" in k},
                     {s["step"].dtype for s in state.optimizer.state.values()})
            if kinds != ({torch.bfloat16}, {torch.bfloat16}, {torch.float32}, {torch.int32}):
                raise AssertionError(f"bf16-param state dtypes (params, moments, BN statistics, count) {kinds}")
            log(f"param_dtype=bfloat16: params and Adam moments bf16, BN running statistics fp32, count int32; "
                f"{len(batches)} steps, {got[0]} B1 and {got[2]} B2 launches each [{card}]")
        del model, state, step
        torch.cuda.empty_cache()
    log(f"flagship step with bf16 params: median of {len(batches) - 1} warm steps {step_ms['bfloat16']:.1f} ms, peak "
        f"device memory {peaks['bfloat16']:.2f} GiB; with fp32 params {step_ms['float32']:.1f} ms, "
        f"{peaks['float32']:.2f} GiB [{card}]")

    # (b) a bf16 best.pth, served by a bf16-param Predictor
    data = train_tree(work, get_config().modalities)
    tconfig = get_config(base_features=BASE_FEATURES, param_dtype="bfloat16", data_dir=data,
                         save_dir=os.path.join(work, "bf16_ckpt"), cache_dir=os.path.join(work, "preproc"), seed=0,
                         **{**TRAIN, "num_epochs": 1})
    zero_counts()
    history = Trainer(tconfig, device=device).train()
    b1, b2 = expected_train_launches(tconfig, steps=1, eval_forwards=1)
    got = counts()
    if got != (b1, 0, b2, 0) or not all(math.isfinite(v) for vals in history.values() for v in vals):
        raise AssertionError(f"bf16-param Trainer: history {history}, launches {got}, expected {(b1, 0, b2, 0)}")
    out["trainer"] = (got[0], got[2])
    pth = os.path.join(tconfig.save_dir, "best.pth")
    sd, snap = load_pth(pth)
    dtypes = {v.dtype for k, v in sd.items() if v.is_floating_point() and "running" not in k}
    if dtypes != {torch.bfloat16} or snap.get("param_dtype") != "bfloat16":
        raise AssertionError(f"best.pth holds {dtypes}, config param_dtype {snap.get('param_dtype')}")
    case = os.path.join(work, "bf16_case")
    for m in tconfig.modalities:
        os.makedirs(os.path.join(case, m), exist_ok=True)
        shutil.copy(os.path.join(data, "BPH-PCA", "BPH", m, "case001.nii.gz"), os.path.join(case, m, "t.nii.gz"))
    low = Predictor(get_config(base_features=BASE_FEATURES, param_dtype="bfloat16"), pth, device=device)
    if {p.dtype for m in low.models for p in m.parameters()} != {torch.bfloat16}:
        raise AssertionError("the bf16-param Predictor's parameters are not bf16")
    image, _ = low.load_case(case)
    zero_counts()
    probs = low.predict_probs(image)
    got = counts()
    if got != (18, 0, 0, 0):
        raise AssertionError(f"bf16-param serving launched {got}, expected 18 bf16 B1")
    out["serve"] = got[0]
    wide = Predictor(get_config(base_features=BASE_FEATURES), pth, device=device).predict_probs(image)
    dp = np.abs(probs - wide)
    log(f"bf16 best.pth ({len(sd)} tensors, params bf16) served with bf16 params: 18 bf16 B1 launches; against "
        f"fp32 params: max|dp| {dp.max():.4g} (bound {PLAIN_MAX_DP}), mean|dp| {dp.mean():.3g} (bound "
        f"{PLAIN_MEAN_DP}) [{card}]")
    if not np.isfinite(probs).all() or dp.max() > PLAIN_MAX_DP or dp.mean() > PLAIN_MEAN_DP:
        raise AssertionError("the bf16-param Predictor's probabilities disagree with fp32 params'")
    del low
    shutil.rmtree(tconfig.save_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# ---- fp16 compute (slice 13) ------------------------------------------------------

# the fp16 step's loss (relative) and each gradient tensor (relative L2)
# may be at most this many times further from the float64 step than the
# plain-conv fp16 step's, plus FP16_STEP_SLACK (one fp16 unit roundoff, 2^-11)
FP16_STEP_MARGIN = BF16_MARGIN
FP16_STEP_SLACK = 2.0**-11
# an fp16 value below this is subnormal
F16_NORMAL = 2.0**-14
# the fp16 phase's steps with fp16 parameters; Adam's eps in fp16 (1e-8,
# the default, rounds to 0 there and makes elements NaN, in JAX as here)
FP16_PARAM_STEPS = 2
FP16_PARAM_EPS = 1e-2


def check_f16_output(got, ref, what: str) -> float:
    """An fp16 B1 output against the fp32 ``ref`` of the same fp16 inputs
    within B1's bound scaled by F16_REL; returns max |err|."""
    import torch

    err = (got.float() - ref).abs()
    bound = F16_REL * (8e-3 * ref.abs() + 1e-3 * ref.abs().max())
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        raise AssertionError(f"fp16 {what}: kernel disagrees with the plain version (max err "
                             f"{err.max().item():.4g}, worst err/bound {(err / bound).max().item():.3g})")
    log(f"fp16 {what}: ok, max_abs_err {err.max().item():.4g}, worst err/bound {(err / bound).max().item():.3g}")
    return err.max().item()


def check_f16_dw(x, dy, what: str) -> float:
    """fp16 B2 against the fp32 plain version of the same inputs within
    F16_REL·DW_BOUND of the largest entry, two launches bitwise equal."""
    import torch

    from pcmseg_tpu_torch.ops.kernels import conv3d_grad

    got, again = conv3d_grad.conv3x3_dw(x, dy), conv3d_grad.conv3x3_dw(x, dy)
    torch.cuda.synchronize()
    ref = conv3d_grad.conv3x3_dw_reference(x.float(), dy.float())
    err, bound = (got - ref).abs().max().item(), F16_REL * DW_BOUND * ref.abs().max().item()
    if not bool(torch.isfinite(got).all()) or err > bound or not torch.equal(got, again):
        raise AssertionError(f"fp16 dW {what}: max err {err:.4g} (bound {bound:.4g}), bitwise repeat "
                             f"{torch.equal(got, again)}")
    log(f"fp16 dW {what}: ok, max_abs_err {err:.4g} (bound {bound:.4g}), bitwise repeat")
    return err


def check_fp16_kernels(device, card: str) -> dict:
    """The fp16 operand paths of B1 and B2 (the same sources as bf16's, the
    ``_f16`` entry points), the bf16 phases' checks with each bound scaled
    by F16_REL: B1 forward at the 14 shapes at N=1 and N=4 (the serving
    tile batch), ReLU on and off; B1 as dx at the 13 transposed shapes of
    the 17 dx layers; B2 at the 14 shapes, two launches bitwise equal; each
    against its plain version in fp32 from the same fp16 inputs, timed beside
    it and cuDNN's fp16 conv / dgrad / wgrad alone, with TFLOP/s and the
    share of the bound (989 TFLOP/s fp16, as bf16). Then the F16_CONTRACT
    shapes, error only (B1 also bitwise repeated, its plan held to the
    mirror), and fp16's edges: B1 outputs in the subnormal
    range kept (not flushed to zero), outputs past 65504 rounded to ±inf
    as fp16's rounding gives them, B2 on a dy that is nearly all
    subnormal. Returns {"fwd", "dx", "dw"}: the JSON record's numbers."""
    import torch

    from pcmseg_tpu_torch.ops.kernels import conv3d

    f16 = torch.float16
    out = {"fwd": check_kernels(device, card, (1, 4), dtype=f16), "dx": check_dx_kernels(device, card, dtype=f16),
           "dw": check_dw_kernels(device, card, dtype=f16)}
    g = torch.Generator(device=device).manual_seed(4)
    for label, d, s, ci, co, slab in F16_CONTRACT:
        x = torch.randn((1, d, s, s, ci), generator=g, device=device).to(f16)
        w = torch.randn((co, ci, 3, 3, 3), generator=g, device=device) * math.sqrt(2.0 / (27 * ci))
        b = torch.randn((co,), generator=g, device=device) * 0.1
        dy = torch.randn((1, d, s, s, co), generator=g, device=device).to(f16)
        if slab:  # the halo slices' outputs are dropped: their cotangent is zero
            dy[:, 0] = dy[:, -1] = 0
        packed = conv3d.pack_weight(w, f16)
        check_b1_plan(1, d, s, ci, co, f"fp16 conv {label}")
        check_f16_output(b1_twice(x, packed, b, True, f"fp16 conv {label}"),
                         conv3d.conv3x3x3_reference(x.float(), packed.float(), b, True), f"conv {label}")
        packed = conv3d.pack_weight(w.flip(2, 3, 4).transpose(0, 1), f16)
        check_b1_plan(1, d, s, co, ci, f"fp16 dx {label}")
        check_f16_output(b1_twice(dy, packed, None, False, f"fp16 dx {label}"),
                         conv3d.conv3x3x3_reference(dy.float(), packed.float(), None, False), f"dx {label}")
        check_f16_dw(x, dy, label)
        del x, w, b, dy, packed
    # fp16's edges, at 64 -> 64 on 8^3: weights scaled so that the sums land
    # in the subnormal range, and past the largest fp16
    x = torch.randn((1, 8, 8, 8, 64), generator=g, device=device).to(f16)
    w = torch.randn((64, 64, 3, 3, 3), generator=g, device=device) * math.sqrt(2.0 / (27 * 64))
    for scale, what in ((2.0**-18, "subnormal"), (2.0**14, "overflowing")):
        packed = conv3d.pack_weight(w * scale, f16)
        got = conv3d.conv3x3x3(x, packed, None, False)
        ref = conv3d.conv3x3x3_reference(x.float(), packed.float(), None, False)
        want = ref.half()  # astype's rounding: nearest even, subnormals kept, ±inf past 65504
        finite = torch.isfinite(want) & torch.isfinite(got)
        err = (got.float() - want.float()).abs()[finite]
        # a sum within a few ulps of 65520 may round to either side in another order
        edge = (ref.abs() - 65520.0).abs() <= 1e-3 * 65520.0
        sub = (want != 0) & (want.abs() < F16_NORMAL)
        kept = int(((got != 0) & sub).sum())
        ok = (bool((torch.isinf(got) == torch.isinf(want))[~edge].all())
              and bool((err <= 2.0**-24 + F16_REL * (8e-3 * want.float().abs()[finite]
                                                     + 1e-3 * want.float().abs()[finite].max())).all())
              and (scale > 1 or kept >= 0.99 * int(sub.sum()) > 0))
        log(f"fp16 conv, {what} outputs: {kept} of {int(sub.sum())} subnormal outputs kept, "
            f"{int(torch.isinf(got).sum())} of {got.numel()} inf (fp16 of the fp32 sum: "
            f"{int(torch.isinf(want).sum())}), max|err| of the finite {err.max().item():.4g} [{card}]")
        if not ok:
            raise AssertionError(f"fp16 conv with {what} outputs: subnormals or overflow not as fp16 rounds them")
    dy = (torch.randn((1, 8, 8, 8, 64), generator=g, device=device) * 2.0**-18).to(f16)
    share = ((dy != 0) & (dy.abs() < F16_NORMAL)).float().mean().item()
    check_f16_dw(x, dy, f"on a dy {share:.3f} subnormal")
    for name, n in (("fwd", 18), ("dx", 17), ("dw", 18)):
        r = out[name]
        log(f"fp16 {name}, {n} layers of one 128^3 microbatch: kernel {r['ms']:.3f} ms, plain (fp32) "
            f"{r['plain_ms']:.3f} ms, cudnn fp16 alone {r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_ms'] / r['ms']:.3f} of it) [{card}]")
    return out


def fp16_train(work: str, device, card: str, ref: dict) -> dict:
    """``compute_dtype='float16'`` on the card through the fp16 kernels, fp32
    parameters. (a) 3 flagship steps from the seed on the dp batches: per
    step exactly 4 x (18 + 17) fp16 B1 and 4 x 18 fp16 B2 launches and no
    bf16 or fp32 one; step 1's loss and every gradient tensor (the
    BN-preceded conv biases, of true gradient 0, logged apart) no further
    from the float64 step (``one_process_exact``) than FP16_STEP_MARGIN
    times the plain-conv fp16 step's distance plus FP16_STEP_SLACK (loss
    relative, gradients relative L2); the share of the head's output
    gradient (fp16, step 1) that is zero or subnormal (no loss scaling, as
    in JAX); warm step ms, vol/s, peak memory, device time by kernel; one
    microbatch's convs against the plain versions (``check_conv_function``,
    dW within DW_SUM_BOUND·Σ|x·dy|). (a') FP16_PARAM_STEPS flagship
    steps with fp16 parameters and Adam moments (eps FP16_PARAM_EPS):
    exact fp16 launches, finite losses, ms and peak memory. (b)
    One epoch of an fp16 ``Trainer`` (run_epochs, no checkpoints) on the
    train phase's 5 cases, exact launches. (c) One 128^3 case served by an
    fp16 ``Predictor``: 18 fp16 B1, its probabilities no further from the
    same model in fp32 (plain conv, TF32 off) than BF16_MARGIN times the
    plain fp16 conv's (max, plus 1e-3·F16_REL; mean, plus 1e-4·F16_REL).
    Returns the launches of each part."""
    import numpy as np
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.infer.predict import Predictor
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.ops.losses import loss_fn_from_config
    from pcmseg_tpu_torch.train.checkpoints import save_pth
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step
    from pcmseg_tpu_torch.train.trainer import Trainer

    out = {}
    exact = one_process_exact(ref)
    config = get_config(base_features=BASE_FEATURES, **{**TRAIN, "compute_dtype": "float16"})
    batches = dp_batches(device)
    plain_grads = {}
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    state, step = create_train_state(model, config), make_train_step(model, config)
    with plain_train_conv(model, torch.float16), first_gradients(model, plain_grads):
        plain_loss = float(step(state, batches[0])["loss"])
    del model, state, step
    gc.collect()
    torch.cuda.empty_cache()
    grads, times, head = {}, [], [0, 0, 0]  # head: zero, subnormal, all elements of the output gradient

    def record_head(grad):
        head[0] += int((grad == 0).sum())
        head[1] += int(((grad != 0) & (grad.abs() < F16_NORMAL)).sum())
        head[2] += grad.numel()

    def watch_head(module, inputs, output):
        if output.requires_grad:
            output.register_hook(record_head)

    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    hook = model.outc.register_forward_hook(watch_head)
    state, step = create_train_state(model, config), make_train_step(model, config)
    with first_gradients(model, grads):
        for i, batch in enumerate(batches):
            zero_counts()
            if i == 1:
                torch.cuda.reset_peak_memory_stats(device)
                hook.remove()
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = float(step(state, batch)["loss"])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            got, want = counts16(), (4 * 35, 4 * 18)
            if got != want:
                raise AssertionError(f"fp16 step {i + 1} launched (B1 fp16, B2 fp16) {got}, expected {want}")
            if i == 0:
                out["step"] = got
                first_loss = loss
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    rel = lambda a: abs(a - exact["loss"]) / abs(exact["loss"])  # noqa: E731
    loss_k, loss_p = rel(first_loss), rel(plain_loss)
    log(f"fp16 step 1: loss {first_loss:.8g} (float64 {exact['loss']:.8g}, plain fp16 {plain_loss:.8g}): "
        f"relative |dL| kernel {loss_k:.3g}, plain {loss_p:.3g} (bound {FP16_STEP_MARGIN * loss_p + FP16_STEP_SLACK:.3g})")
    if not math.isfinite(first_loss) or loss_k > FP16_STEP_MARGIN * loss_p + FP16_STEP_SLACK:
        raise AssertionError("the fp16 step's loss is further from float64 than the plain fp16 step's")
    log(f"fp16 step 1, the head's output gradient (fp16, {head[2]} elements over 4 microbatches): "
        f"{head[0] / head[2]:.4f} zero, {head[1] / head[2]:.4f} subnormal (below 2^-14), "
        f"{(head[0] + head[1]) / head[2]:.4f} together [{card}]")
    worst, cancelled, held = (0.0, ""), [], []
    for k, g64 in exact["grads"].items():
        d_k, d_p = rel_dist(grads[k], g64), rel_dist(plain_grads[k], g64)
        if re.search(r"conv\.[03]\.bias$", k):
            cancelled.append((d_k, d_p))
            continue
        held.append((d_k, d_p))
        worst = max(worst, (d_k / (FP16_STEP_MARGIN * d_p + FP16_STEP_SLACK), k))
        if not math.isfinite(d_k) or d_k > FP16_STEP_MARGIN * d_p + FP16_STEP_SLACK:
            raise AssertionError(f"{k}: the fp16 step's gradient is {d_k:.3g} from float64 (relative), the plain "
                                 f"fp16 step's {d_p:.3g}")
    log(f"fp16 step 1 gradients, {len(exact['grads'])} tensors against float64: relative distance kernel "
        f"{min(h[0] for h in held):.3g}-{max(h[0] for h in held):.3g} (median "
        f"{sorted(h[0] for h in held)[len(held) // 2]:.3g}), plain fp16 {min(h[1] for h in held):.3g}-"
        f"{max(h[1] for h in held):.3g}; worst distance/bound "
        f"{worst[0]:.3g} at {worst[1]}; the {len(cancelled)} BN-preceded conv biases (true gradient 0, logged "
        f"only): relative distance kernel up to {max(c[0] for c in cancelled):.3g}, plain "
        f"{max(c[1] for c in cancelled):.3g} [{card}]")
    warm = sorted(times[1:])[len(times[1:]) // 2]
    log(f"fp16 flagship step (batch 4 = 4 x 1): warm {warm * 1e3:.1f} ms ({', '.join(f'{t * 1e3:.1f}' for t in times)}"
        f" ms for steps 1-{len(times)}) = {TRAIN['batch_size'] / warm:.3f} vol/s, peak device memory {peak:.2f} GiB "
        f"[{card}]")
    profile_step(lambda: float(step(state, batches[-1])["loss"]), "one fp16 step", card)
    # one microbatch's convs against the plain versions; these launches compare
    model.zero_grad(set_to_none=True)
    with conv_io(model) as records:
        loss_fn_from_config(config)(model(batches[0]["image"][:1]), batches[0]["label"][:1]).backward()
        torch.cuda.synchronize()
    check_conv_function(model, records, {k: p.grad.float() for k, p in model.named_parameters() if p.grad is not None},
                        card, "one 128^3 microbatch of the fp16 step")
    for rec in records.values():
        rec.clear()
    del model, state, step, grads, plain_grads, records
    torch.cuda.empty_cache()

    # (a') fp16 parameters with fp16 compute: FP16_PARAM_STEPS steps
    gc.collect()
    pconfig = config.replace(param_dtype="float16", eps=FP16_PARAM_EPS)
    model = UNet3D.from_config(pconfig, generator=torch.Generator().manual_seed(0)).to(device)
    state, step = create_train_state(model, pconfig), make_train_step(model, pconfig)
    losses, times = [], []
    for i, batch in enumerate(batches[:FP16_PARAM_STEPS]):
        zero_counts()
        if i == 1:
            torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(step(state, batch)["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        got = counts16()
        if got != (4 * 35, 4 * 18) or not math.isfinite(losses[-1]):
            raise AssertionError(f"fp16-param fp16 step {i + 1}: loss {losses[-1]}, launches {got}, expected "
                                 f"{(4 * 35, 4 * 18)}")
    kinds = {p.dtype for p in model.parameters()} | {m.dtype for s in state.optimizer.state.values()
                                                     for m in (s["mu"], s["nu"])}
    if kinds != {torch.float16}:
        raise AssertionError(f"fp16-param state dtypes (params, Adam moments) {kinds}")
    out["param_f16"] = got
    log(f"fp16 compute with fp16 params and Adam moments (eps {FP16_PARAM_EPS}): {len(losses)} flagship steps, "
        f"losses {losses}, {got[0]} fp16 B1 and {got[1]} fp16 B2 launches each; "
        f"{', '.join(f'{t:.1f}' for t in times)} ms (the first cold), peak device memory of step 2 "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB [{card}]")
    del model, state, step
    torch.cuda.empty_cache()

    # (b) one epoch of an fp16 Trainer
    data = train_tree(work, config.modalities)
    tconfig = config.replace(data_dir=data, save_dir=os.path.join(work, "fp16_ckpt"),
                             cache_dir=os.path.join(work, "preproc"), seed=0, num_epochs=1)
    trainer = Trainer(tconfig, device=device)
    zero_counts()
    t = time.perf_counter()
    history = run_epochs(trainer, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    want = expected_train_launches(tconfig, steps=1, eval_forwards=1)
    got = counts16()
    log(f"fp16 Trainer, 1 epoch ({data_path(trainer, TRAIN_CASES)}): {wall:.1f} s, history {json.dumps(history)}; "
        f"launches (B1 fp16, B2 fp16) {got}, none in bf16 or fp32 [{card}]")
    if got != want:
        raise AssertionError(f"fp16 Trainer launched {got}, expected {want}")
    if not all(math.isfinite(v) for vals in history.values() for v in vals):
        raise AssertionError(f"non-finite fp16 history {history}")
    out["trainer"] = got
    pth = os.path.join(work, "fp16_model.pth")
    save_pth(pth, trainer.state.model.state_dict(), tconfig.to_dict())
    del trainer
    torch.cuda.empty_cache()

    # (c) one case served in fp16
    predictor = Predictor(get_config(base_features=BASE_FEATURES, compute_dtype="float16"), pth, device=device)
    case = os.path.join(work, "fp16_case")
    for m in config.modalities:
        os.makedirs(os.path.join(case, m), exist_ok=True)
        shutil.copy(os.path.join(data, "BPH-PCA", "BPH", m, "case000.nii.gz"), os.path.join(case, m, "t.nii.gz"))
    image, _ = predictor.load_case(case)
    zero_counts()
    probs = predictor.predict_probs(image)
    got = counts16()
    if got != (18, 0):
        raise AssertionError(f"fp16 serving launched {got}, expected 18 fp16 B1")
    with plain_conv(predictor.models, torch.float16):
        plain = predictor.predict_probs(image)
    with plain_conv(predictor.models, torch.float32):
        wide = predictor.predict_probs(image)
    err_k, err_p = np.abs(probs - wide), np.abs(plain - wide)
    log(f"fp16 serving, one 128^3 case: 18 fp16 B1 launches; against fp32 (plain conv): max|dp| kernel "
        f"{err_k.max():.4g}, plain fp16 {err_p.max():.4g}; mean|dp| kernel {err_k.mean():.3g}, plain fp16 "
        f"{err_p.mean():.3g}; foreground {(probs > 0.5).mean():.4f} [{card}]")
    if (not np.isfinite(probs).all() or err_k.max() > BF16_MARGIN * err_p.max() + 1e-3 * F16_REL
            or err_k.mean() > BF16_MARGIN * err_p.mean() + 1e-4 * F16_REL):
        raise AssertionError(f"the fp16 kernel's probabilities are further from fp32 than {BF16_MARGIN}x the "
                             "plain fp16 conv's")
    out["serve"] = got[0]
    del predictor
    shutil.rmtree(os.path.join(work, "fp16_ckpt"), ignore_errors=True)
    os.remove(pth)
    torch.cuda.empty_cache()
    return out


def sp_steps(work: str, ref: dict, card: str) -> list:
    """(b) SP_RANKS gloo ranks sharing the card through sp_rank, held against
    each other and against ``ref`` (dp_reference). Returns the (B1, B2)
    launches of all ranks."""
    import re

    import torch

    port, t0 = free_port(), time.perf_counter()
    ranks = spawn_ranks(lambda r: ["--sp-rank", str(r), str(SP_RANKS), str(port), work, "gloo"], SP_RANKS)
    wall = time.perf_counter() - t0
    micro = TRAIN["accum_steps"]
    per_step = [micro * 35, micro * 18]
    bitwise = {when: all(r[when] == ranks[0][when] for r in ranks) for when in ("1", "final")}
    exact = one_process_exact(ref)
    sharded = torch.load(os.path.join(work, "sp_grads.pt"), weights_only=True)
    sharded64 = torch.load(os.path.join(work, "sp_grads64.pt"), weights_only=True)

    def share(a, b):
        """max|a - b| / max|b| per tensor, the BN-preceded conv biases (true gradient 0) apart"""
        out = {k: float((a[k] - w).abs().max() / w.abs().max().clamp_min(1e-30)) for k, w in b.items()}
        return ({k: v for k, v in out.items() if not re.search(r"conv\.[03]\.bias$", k)},
                max(v for k, v in out.items() if re.search(r"conv\.[03]\.bias$", k)))

    anchor = one_process_anchor(ref)
    s64, b64 = share(sharded64, anchor["grads"])
    s_sp, _ = share(sharded, exact["grads"])
    s_un, _ = share(ref["grads"], exact["grads"])
    s_pair, b_pair = share(sharded, ref["grads"])
    r0 = ranks[0]
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    worst64 = max(s64, key=s64.get)
    beyond = sorted(k for k in s_sp if s_sp[k] > BF16_MARGIN * s_un[k] + GRAD_SLACK)
    worst_pair = max(s_pair, key=s_pair.get)
    norm64 = exact["grad_norm"]
    for r in ranks:
        h = r["halo"]
        log(f"sp (b) rank {r['rank']} of {SP_RANKS} (gloo on {r['device']}, {r['rows']} rows, D-slab {r['slab']}, "
            f"all {micro} microbatches a step): losses {r['loss']}, grad norms {r['grad_norm']}; step "
            f"{', '.join(f'{s * 1e3:.1f}' for s in r['step_s'])} ms (the first cold); gradient all-reduce of "
            f"{r['reduce_bytes'] / 1e6:.1f} MB fp32 {', '.join(f'{s * 1e3:.1f}' for s in r['reduce_s'])} ms; "
            f"halo exchanges of one more step, each synchronised: {h['calls']} calls, {h['s'] * 1e3:.1f} ms, "
            f"{h['bytes'] / 1e6:.1f} MB received, that step {h['step_s'] * 1e3:.1f} ms; peak device memory of "
            f"the warm steps {r['peak_gib']:.2f} GiB (one process {ref['peak_gib']:.2f}); launches per step "
            f"{r['launches']} (expected {per_step}) [{card}; gloo through the host on one shared card, not NCCL]")
    loss1, norm1 = rel(r0["loss"][0], ref["loss"][0]), rel(r0["grad_norm"][0], ref["grad_norm"][0])
    later = max(rel(a, b) for a, b in zip(r0["loss"][1:], ref["loss"][1:]))
    loss64, normrel64 = rel(r0["exact"]["loss"], anchor["loss"]), rel(r0["exact"]["grad_norm"], anchor["grad_norm"])
    norm_ok = abs(r0["grad_norm"][0] - norm64) <= BF16_MARGIN * abs(ref["grad_norm"][0] - norm64) + GRAD_SLACK * norm64
    log(f"sp (b) float64 step 1 through the plain conv on one row (anchor_batch), sharded against one process: "
        f"loss rel {loss64:.3g}, grad "
        f"norm rel {normrel64:.3g} (bound {SP_EXACT_RTOL}), the largest gradient difference over its tensor's "
        f"max|g| {s64[worst64]:.3g} at {worst64} (bound {SP_EXACT_SHARE}; the BN-preceded biases, reported: "
        f"{b64:.3g}) [{card}]")
    log(f"sp (b) bf16 kernel steps against one process ({', '.join(f'{s * 1e3:.1f}' for s in ref['step_s'])} ms a "
        f"step): ranks' states bitwise equal after step 1 {bitwise['1']} and step {DP_STEPS} {bitwise['final']}; "
        f"step 1 loss rel {loss1:.3g} (bound {SP_LOSS1_RTOL}), grad norm rel {norm1:.3g} (reported), the largest "
        f"gradient difference over its tensor's max|g| {s_pair[worst_pair]:.3g} at {worst_pair} (reported; the "
        f"BN-preceded biases {b_pair:.3g}); against the float64 step: grad norm {r0['grad_norm'][0]!r} sharded, "
        f"{ref['grad_norm'][0]!r} one process, {norm64!r} float64 (bound {BF16_MARGIN}x one process's distance + "
        f"{GRAD_SLACK}), the largest share sharded {max(s_sp.values()):.3g}, one process {max(s_un.values()):.3g}, "
        f"{len(beyond)} of {len(s_sp)} tensors beyond {BF16_MARGIN}x one process's + {GRAD_SLACK} {beyond[:3]}; "
        f"later losses rel {later:.3g} (bound {SP_LOSS_RTOL}); the ranks in {wall:.1f} s of processes [{card}]")
    if any(r["launches"] != [per_step] * DP_STEPS for r in ranks):
        raise AssertionError(f"sp ranks launched {[r['launches'] for r in ranks]}, expected {per_step} a step")
    if any(r["loss"] != r0["loss"] or r["grad_norm"] != r0["grad_norm"] or r["exact"] != r0["exact"] for r in ranks) \
            or not all(bitwise.values()):
        raise AssertionError("the sp ranks differ")
    if not (loss64 <= SP_EXACT_RTOL and normrel64 <= SP_EXACT_RTOL and s64[worst64] <= SP_EXACT_SHARE):
        raise AssertionError(f"sp float64 step against one process: loss {loss64}, grad norm {normrel64}, "
                             f"gradient share {s64[worst64]} ({worst64})")
    if not (loss1 <= SP_LOSS1_RTOL and norm_ok and not beyond and later <= SP_LOSS_RTOL):
        raise AssertionError(f"sp bf16 steps: loss {loss1}, grad norm {r0['grad_norm'][0]} against one process's "
                             f"{ref['grad_norm'][0]} and float64's {norm64}, tensors beyond the bound {beyond}, "
                             f"later losses {later}")
    return [sum(sum(s[i] for s in r["launches"]) for r in ranks) for i in (0, 1)]


def sp_trainer(rank: int, world: int, port: int, work: str, backend: str, name: str) -> dict:
    """A flagship Trainer on a data 1 x spatial WORLD mesh over the cache
    phase's 12 cases for SP_EPOCHS epoch with validation, from the device
    cache (``chip_smoke.py --sp-trainer ...``); with ``world`` 0 the same
    config in one process without a group (a mesh it cannot hold: 1x1x1).
    Returns its history, launches and the checkpoint writes it made."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.parallel import multihost
    from pcmseg_tpu_torch.train import trainer as trainer_module

    if world:
        multihost.initialize(f"localhost:{port}", num_processes=world, process_id=rank, backend=backend)
        multihost.establish_collectives()
    writes, real_write = [], trainer_module.write_train_checkpoint

    def counted_write(*args, **kwargs):
        writes.append(args[1])
        return real_write(*args, **kwargs)

    trainer_module.write_train_checkpoint = counted_write
    save_dir = os.path.join(work, f"sp_{name}")
    config = get_config(base_features=BASE_FEATURES, data_dir=os.path.join(work, "cache_data"),
                        cache_dir=os.path.join(work, "preproc"), seed=0, save_dir=save_dir,
                        spatial_parallel=SP_RANKS, **{**TRAIN, "num_epochs": SP_EPOCHS})
    trainer = trainer_module.Trainer(config, device=torch.device("cuda", 0))
    steps = math.ceil(len(trainer.train_indices) / config.batch_size)
    val_batches = math.ceil(len(trainer.val_indices) / config.batch_size)
    conv3d.launches = conv3d_grad.launches = 0
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    run = {"rank": rank, "history": history, "wall_s": time.perf_counter() - t0, "mesh": trainer.mesh.shape,
           "cached": trainer._dcache is not None, "launches": [conv3d.launches, conv3d_grad.launches],
           "want": [SP_EPOCHS * (steps * config.accum_steps * 35 + val_batches * 18),
                    SP_EPOCHS * steps * config.accum_steps * 18],
           "writes": writes, "files": sorted(os.listdir(save_dir)) if os.path.isdir(save_dir) else []}
    if world:
        multihost.shutdown()
    return run


def sp_trainers(work: str, card: str) -> list:
    """(c) sp_trainer as SP_RANKS gloo ranks sharing the card, then in one
    process without a group: the ranks' histories equal, one checkpoint set
    written (by the primary alone), exact launch counts. Returns the
    (B1, B2) launches of all ranks."""
    if not os.path.isdir(os.path.join(work, "cache_data")):
        from pcmseg_tpu_torch.core.config import get_config

        write_train_tree(os.path.join(work, "cache_data"), get_config().modalities, CACHE_CASES, ext=".nii")
    port, t0 = free_port(), time.perf_counter()
    runs = spawn_ranks(lambda r: ["--sp-trainer", str(r), str(SP_RANKS), str(port), work, "gloo", "g"], SP_RANKS)
    wall = time.perf_counter() - t0
    alone = spawn_ranks(lambda r: ["--sp-trainer", "0", "0", "0", work, "gloo", "alone"], 1)[0]
    rel = max(abs(a - b) / abs(b) for k in ("train_loss", "val_loss")
              for a, b in zip(runs[0]["history"][k], alone["history"][k]))
    log(f"sp (c) {SP_RANKS}-rank gloo Trainer, mesh {runs[0]['mesh']}, {CACHE_CASES} cases x {SP_EPOCHS} epoch with "
        f"validation, device cache {runs[0]['cached']}: history {json.dumps(runs[0]['history'])}, train() "
        f"{', '.join(f'{r['wall_s']:.1f}' for r in runs)} s; launches {[r['launches'] for r in runs]} (expected "
        f"{runs[0]['want']} a rank); checkpoint writes by rank {[r['writes'] for r in runs]}, files "
        f"{runs[0]['files']}; one process without a group (mesh {alone['mesh']}): "
        f"{json.dumps(alone['history'])}, {alone['wall_s']:.1f} s, losses max rel diff {rel:.3g} (reported); "
        f"processes {wall:.1f} s [{card}]")
    if any(r["history"] != runs[0]["history"] for r in runs):
        raise AssertionError("the sp trainer's ranks differ")
    want_files = sorted(["latest.pt", "best.pt", "best.pth"])
    if (runs[0]["writes"] != ["latest"] * SP_EPOCHS or any(r["writes"] for r in runs[1:])
            or runs[0]["files"] != want_files or alone["files"] != want_files):
        raise AssertionError(f"sp trainer checkpoints: writes {[r['writes'] for r in runs]}, "
                             f"files {runs[0]['files']} (expected {want_files})")
    for r in runs:
        if r["launches"] != r["want"] or not r["cached"] or r["mesh"] != {"data": 1, "spatial": SP_RANKS, "model": 1}:
            raise AssertionError(f"sp trainer: {r}")
        if not all(math.isfinite(v) for vals in r["history"].values() for v in vals):
            raise AssertionError(f"non-finite history {r['history']}")
    return [sum(r["launches"][i] for r in runs) for i in (0, 1)]


def sp_phase(work: str, device, card: str, ref: dict) -> dict:
    """Spatial parallelism on the one card: the kernels at a D-slab's shapes
    against their plain versions, then (a) sharded serving, (b) the sharded
    steps, (c) the sharded Trainer. Returns the launches of each path and
    the slab-shape kernel records."""
    slab = {"fwd": check_kernels(device, card, (1,), slab=True), "dx": check_dx_kernels(device, card, slab=True),
            "dw": check_dw_kernels(device, card, slab=True)}
    serve_launches = sp_serving(work, device, card)
    return {"serve": serve_launches, "train": sp_steps(work, ref, card), "trainer": sp_trainers(work, card),
            "slab": slab}


# ---- tensor parallelism (slice 10) -----------------------------------------------

# (b) is held as the sp phase holds its ranks: the float64 step 1 through
# the plain conv on anchor_batch against one process's (the loss within SP_EXACT_RTOL, each
# gradient tensor within SP_EXACT_SHARE), the bf16 kernel step by the loss
# bounds and, against the float64 step, by BF16_MARGIN x one process's
# distance + GRAD_SLACK. The float64 step's grad norm is held within
# TP_EXACT_NORM_RTOL, not SP_EXACT_RTOL: its gradients are fp32 (the
# parameters' dtype), each rounded from float64 sums in another order
# (cuDNN's algorithm for a shard's shape), so they differ from one
# process's by an fp32 ulp here and there (5.69e-8 of a tensor's largest
# entry), and the norm sums their squares in fp32 over the shards and then
# the model group, where one process sums whole tensors (measured 6.51e-8
# on an NVIDIA H100 80GB HBM3, 700.00 W). A shard's squares left out moves
# it by tens of percent; tests/test_torch_tp.py holds the sum to 1e-12 in
# float64 on the CPU.
TP_EXACT_NORM_RTOL = 1e-6
# (c): the tp Trainer on TP_TRAIN_CASES of the cache phase's cases (one
# batch of 4) and one val case, so each epoch is one step through the
# gathers staged in host memory (a rank-step takes seconds there); 1 epoch
# (2 until the fp16 phases joined: the script's time needed the room)
TP_EPOCHS = 1
TP_TRAIN_CASES = 4
# (b) runs the first TP_STEPS of the DP_STEPS batches: each bf16 rank-step
# takes 17-28 s through the host-staged gathers
TP_STEPS = 2


@contextlib.contextmanager
def timed_gathers(device, tally: dict):
    """Inside, every channel gather (forward) and every sum of a sharded
    layer's input gradient over the model group (backward) is synchronised
    and timed into ``tally``, with the bytes a rank receives (gathers) and
    the bytes all-reduced (sums, in the gradient's dtype)."""
    import torch

    from pcmseg_tpu_torch.parallel import collectives

    def timed(fn, name, kind):
        real = getattr(fn, name)

        def run(ctx, t, *args):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            out = real(ctx, t, *args)
            torch.cuda.synchronize(device)
            tally[kind + "_s"] += time.perf_counter() - t0
            moved = t.numel() * t.element_size() * ((ctx.comm.size - 1) if kind == "gather" else 1)
            tally[kind + "_bytes"] += moved
            tally[kind + "_calls"] += 1
            return out
        setattr(fn, name, staticmethod(run))
        return real

    saved = [(collectives._GatherChannels, "forward", timed(collectives._GatherChannels, "forward", "gather")),
             (collectives._SumInputGrads, "backward", timed(collectives._SumInputGrads, "backward", "sum"))]
    try:
        yield
    finally:
        for fn, name, real in saved:
            setattr(fn, name, staticmethod(real))


def tp_rank(rank: int, world: int, port: int, work: str, backend: str) -> dict:
    """One rank of a model group (``chip_smoke.py --tp-rank RANK WORLD PORT
    WORK BACKEND``): the flagship model from the seed, cut to this rank's
    output-channel shards on a data 1 x spatial 1 x model WORLD mesh;
    TP_STEPS steps of dp_batches, every rank on all 4 microbatches of all
    rows; each step timed and its launches counted, the peak memory of the
    warm steps, every channel gather and gradient sum of the last step
    synchronised and timed; then the float64 step 1 on anchor_batch. Returns the SHA-256 of
    the whole (gathered) state after step 1 and after the last, and writes
    step 1's whole gradients (rank 0) to WORK/tp_grads.pt."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.parallel import collectives, multihost
    from pcmseg_tpu_torch.parallel.sharding import Mesh, shard_batch, shard_state, whole_payload
    from pcmseg_tpu_torch.train.steps import create_train_state, make_train_step

    multihost.initialize(f"localhost:{port}", num_processes=world, process_id=rank, backend=backend)
    device = multihost.local_device() if backend == "nccl" else torch.device("cuda", 0)
    multihost.establish_collectives()
    config = get_config(base_features=BASE_FEATURES, tensor_parallel=world, **TRAIN)
    model = UNet3D.from_config(config, generator=torch.Generator().manual_seed(0)).to(device)
    mesh = Mesh(1, 1, world)
    axes = shard_state(model, mesh)
    comm = collectives.mesh_comms(mesh).model
    state = create_train_state(model, config)
    step = make_train_step(model, config, mesh=mesh)

    def whole(tensors: dict) -> dict:
        return whole_payload({"model": tensors, "optimizer": {"state": {}}}, axes, [], comm)["model"]

    out = {"rank": rank, "device": str(device), "loss": [], "grad_norm": [], "step_s": [], "launches": [],
           "shard_params": sum(p.numel() for p in model.parameters())}
    grads = {}
    tally = {f"{kind}_{what}": 0 for kind in ("gather", "sum") for what in ("s", "bytes", "calls")}
    batches = dp_batches(device)[:TP_STEPS]
    with first_gradients(model, grads):
        for batch in batches:
            local = shard_batch(batch, mesh, rank=rank, accum=config.accum_steps)
            torch.cuda.synchronize(device)
            if len(out["loss"]) == 1:
                torch.cuda.reset_peak_memory_stats(device)
            conv3d.launches = conv3d_grad.launches = 0
            last = len(out["loss"]) == TP_STEPS - 1
            t = time.perf_counter()
            with timed_gathers(device, tally) if last else contextlib.nullcontext():
                metrics = step(state, local)
                out["loss"].append(float(metrics["loss"]))
                torch.cuda.synchronize(device)
            out["step_s"].append(time.perf_counter() - t)
            out["launches"].append([conv3d.launches, conv3d_grad.launches])
            out["grad_norm"].append(float(metrics["grad_norm"]))
            if len(out["loss"]) in (1, TP_STEPS):
                out["1" if len(out["loss"]) == 1 else "final"] = state_digest(whole(model.state_dict()))
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2**30
    grads = whole(grads)
    if rank == 0:
        torch.save(grads, os.path.join(work, "tp_grads.pt"))
    out.update(gathers=tally, rows=len(local["image"]))
    del model, state, step
    torch.cuda.empty_cache()
    t = time.perf_counter()
    out["exact"] = exact_first_step(anchor_config(config), anchor_batch(batches[0]), device, mesh, rank,
                                    os.path.join(work, "tp_grads64.pt"))
    out["exact_s"] = time.perf_counter() - t
    multihost.shutdown()
    return out


def tp_steps(work: str, ref: dict, card: str) -> list:
    """(b) TP_RANKS gloo ranks sharing the card through tp_rank, held against
    each other and against ``ref`` (dp_reference) as sp_steps holds its
    ranks. Returns the (B1, B2) launches of all ranks."""
    import re

    import torch

    port, t0 = free_port(), time.perf_counter()
    ranks = spawn_ranks(lambda r: ["--tp-rank", str(r), str(TP_RANKS), str(port), work, "gloo"], TP_RANKS)
    wall = time.perf_counter() - t0
    micro = TRAIN["accum_steps"]
    per_step = [micro * 35, micro * 18]
    bitwise = {when: all(r[when] == ranks[0][when] for r in ranks) for when in ("1", "final")}
    exact = one_process_exact(ref)
    sharded = torch.load(os.path.join(work, "tp_grads.pt"), weights_only=True)
    sharded64 = torch.load(os.path.join(work, "tp_grads64.pt"), weights_only=True)

    def share(a, b):
        """max|a - b| / max|b| per tensor, the BN-preceded conv biases (true gradient 0) apart"""
        out = {k: float((a[k] - w).abs().max() / w.abs().max().clamp_min(1e-30)) for k, w in b.items()}
        return ({k: v for k, v in out.items() if not re.search(r"conv\.[03]\.bias$", k)},
                max(v for k, v in out.items() if re.search(r"conv\.[03]\.bias$", k)))

    anchor = one_process_anchor(ref)
    s64, b64 = share(sharded64, anchor["grads"])
    s_tp, _ = share(sharded, exact["grads"])
    s_un, _ = share(ref["grads"], exact["grads"])
    s_pair, b_pair = share(sharded, ref["grads"])
    r0 = ranks[0]
    rel = lambda a, b: abs(a - b) / abs(b)  # noqa: E731
    worst64 = max(s64, key=s64.get)
    beyond = sorted(k for k in s_tp if s_tp[k] > BF16_MARGIN * s_un[k] + GRAD_SLACK)
    worst_pair = max(s_pair, key=s_pair.get)
    norm64 = exact["grad_norm"]
    for r in ranks:
        g = r["gathers"]
        log(f"tp (b) rank {r['rank']} of {TP_RANKS} (gloo on {r['device']}, {r['rows']} rows, {r['shard_params']} of "
            f"{N_PARAMS} parameters, all {micro} microbatches a step): losses {r['loss']}, grad norms "
            f"{r['grad_norm']}; step {', '.join(f'{s * 1e3:.1f}' for s in r['step_s'])} ms (the first cold, the "
            f"last with its channel gathers synchronised: {g['gather_calls']} calls, {g['gather_s'] * 1e3:.1f} ms, "
            f"{g['gather_bytes'] / 1e6:.1f} MB received; their backward, the sums of the sharded layers' input "
            f"gradients: {g['sum_calls']} all-reduces, {g['sum_s'] * 1e3:.1f} ms, {g['sum_bytes'] / 1e6:.1f} MB of "
            f"bf16); the float64 step {r['exact_s']:.1f} s; peak device memory of "
            f"the warm steps {r['peak_gib']:.2f} GiB (one process {ref['peak_gib']:.2f}); launches per step "
            f"{r['launches']} (expected {per_step}) [{card}; gloo through the host on one shared card, not NCCL]")
    loss1, norm1 = rel(r0["loss"][0], ref["loss"][0]), rel(r0["grad_norm"][0], ref["grad_norm"][0])
    later = max(rel(a, b) for a, b in zip(r0["loss"][1:], ref["loss"][1:]))
    loss64, normrel64 = rel(r0["exact"]["loss"], anchor["loss"]), rel(r0["exact"]["grad_norm"], anchor["grad_norm"])
    norm_ok = abs(r0["grad_norm"][0] - norm64) <= BF16_MARGIN * abs(ref["grad_norm"][0] - norm64) + GRAD_SLACK * norm64
    log(f"tp (b) float64 step 1 through the plain conv on one row (anchor_batch), sharded against one process: "
        f"loss rel {loss64:.3g}, grad "
        f"norm rel {normrel64:.3g} (bounds {SP_EXACT_RTOL} / {TP_EXACT_NORM_RTOL}), the largest gradient difference "
        f"over its tensor's max|g| {s64[worst64]:.3g} at {worst64} (bound {SP_EXACT_SHARE}; the BN-preceded "
        f"biases, reported: {b64:.3g}) [{card}]")
    log(f"tp (b) bf16 kernel steps against one process ({', '.join(f'{s * 1e3:.1f}' for s in ref['step_s'])} ms a "
        f"step): ranks' gathered states bitwise equal after step 1 {bitwise['1']} and step {TP_STEPS} "
        f"{bitwise['final']}; step 1 loss rel {loss1:.3g} (bound {SP_LOSS1_RTOL}), grad norm rel {norm1:.3g} "
        f"(reported), the largest gradient difference over its tensor's max|g| {s_pair[worst_pair]:.3g} at "
        f"{worst_pair} (reported; the BN-preceded biases {b_pair:.3g}); against the float64 step: grad norm "
        f"{r0['grad_norm'][0]!r} sharded, {ref['grad_norm'][0]!r} one process, {norm64!r} float64 (bound "
        f"{BF16_MARGIN}x one process's distance + {GRAD_SLACK}), the largest share sharded {max(s_tp.values()):.3g}, "
        f"one process {max(s_un.values()):.3g}, {len(beyond)} of {len(s_tp)} tensors beyond {BF16_MARGIN}x one "
        f"process's + {GRAD_SLACK} {beyond[:3]}; later losses rel {later:.3g} (bound {SP_LOSS_RTOL}); the ranks in "
        f"{wall:.1f} s of processes [{card}]")
    if any(r["launches"] != [per_step] * TP_STEPS for r in ranks):
        raise AssertionError(f"tp ranks launched {[r['launches'] for r in ranks]}, expected {per_step} a step")
    if any(r["loss"] != r0["loss"] or r["grad_norm"] != r0["grad_norm"] or r["exact"] != r0["exact"] for r in ranks) \
            or not all(bitwise.values()):
        raise AssertionError("the tp ranks differ")
    if not (loss64 <= SP_EXACT_RTOL and normrel64 <= TP_EXACT_NORM_RTOL and s64[worst64] <= SP_EXACT_SHARE):
        raise AssertionError(f"tp float64 step against one process: loss {loss64}, grad norm {normrel64}, "
                             f"gradient share {s64[worst64]} ({worst64})")
    if not (loss1 <= SP_LOSS1_RTOL and norm_ok and not beyond and later <= SP_LOSS_RTOL):
        raise AssertionError(f"tp bf16 steps: loss {loss1}, grad norm {r0['grad_norm'][0]} against one process's "
                             f"{ref['grad_norm'][0]} and float64's {norm64}, tensors beyond the bound {beyond}, "
                             f"later losses {later}")
    return [sum(sum(s[i] for s in r["launches"]) for r in ranks) for i in (0, 1)]


def tp_trainer(rank: int, world: int, port: int, work: str, backend: str, name: str) -> dict:
    """A flagship Trainer on a data 1 x spatial 1 x model WORLD mesh over
    TP_TRAIN_CASES of the cache phase's cases and one val case for
    TP_EPOCHS epochs, from the device cache (``chip_smoke.py --tp-trainer
    ...``). Returns its history, launches, the checkpoint writes it made
    and (rank 0) the value count of its ``best.pth``."""
    import torch

    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.ops.kernels import conv3d, conv3d_grad
    from pcmseg_tpu_torch.parallel import multihost
    from pcmseg_tpu_torch.train import trainer as trainer_module
    from pcmseg_tpu_torch.train.checkpoints import load_pth

    multihost.initialize(f"localhost:{port}", num_processes=world, process_id=rank, backend=backend)
    multihost.establish_collectives()
    writes, real_write = [], trainer_module.write_train_checkpoint

    def counted_write(*args, **kwargs):
        writes.append(args[1])
        return real_write(*args, **kwargs)

    trainer_module.write_train_checkpoint = counted_write
    save_dir = os.path.join(work, f"tp_{name}")
    config = get_config(base_features=BASE_FEATURES, data_dir=os.path.join(work, "cache_data"),
                        cache_dir=os.path.join(work, "preproc"), seed=0, save_dir=save_dir,
                        tensor_parallel=TP_RANKS, **{**TRAIN, "num_epochs": TP_EPOCHS})
    trainer = trainer_module.Trainer(config, train_indices=range(TP_TRAIN_CASES), val_indices=[TP_TRAIN_CASES],
                                     device=torch.device("cuda", 0))
    steps = math.ceil(len(trainer.train_indices) / config.batch_size)
    val_batches = math.ceil(len(trainer.val_indices) / config.batch_size)
    conv3d.launches = conv3d_grad.launches = 0
    t0 = time.perf_counter()
    history = trainer.train()
    torch.cuda.synchronize()
    run = {"rank": rank, "history": history, "wall_s": time.perf_counter() - t0, "mesh": trainer.mesh.shape,
           "cached": trainer._dcache is not None, "launches": [conv3d.launches, conv3d_grad.launches],
           "want": [TP_EPOCHS * (steps * config.accum_steps * 35 + val_batches * 18),
                    TP_EPOCHS * steps * config.accum_steps * 18],
           "writes": writes, "files": sorted(os.listdir(save_dir)) if os.path.isdir(save_dir) else []}
    if rank == 0 and "best.pth" in run["files"]:
        run["pth_values"] = sum(v.numel() for v in load_pth(os.path.join(save_dir, "best.pth"))[0].values())
    multihost.shutdown()
    return run


def tp_trainers(work: str, card: str) -> list:
    """(c) tp_trainer as TP_RANKS gloo ranks sharing the card: the ranks'
    histories bitwise equal, one checkpoint set written (by the primary
    alone) in the whole reference layout (``best.pth`` holds as many values
    as the whole model's state dict), exact launch counts. Returns the
    (B1, B2) launches of all ranks."""
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.models.unet3d import UNet3D

    if not os.path.isdir(os.path.join(work, "cache_data")):
        write_train_tree(os.path.join(work, "cache_data"), get_config().modalities, CACHE_CASES, ext=".nii")
    port, t0 = free_port(), time.perf_counter()
    runs = spawn_ranks(lambda r: ["--tp-trainer", str(r), str(TP_RANKS), str(port), work, "gloo", "g"], TP_RANKS)
    wall = time.perf_counter() - t0
    whole = sum(v.numel() for v in UNet3D.from_config(get_config(base_features=BASE_FEATURES),
                                                      device="meta").state_dict().values())
    log(f"tp (c) {TP_RANKS}-rank gloo Trainer, mesh {runs[0]['mesh']}, {TP_TRAIN_CASES} + 1 of the {CACHE_CASES} cases "
        f"x {TP_EPOCHS} epochs with validation, device cache {runs[0]['cached']}: history {json.dumps(runs[0]['history'])}, train() "
        f"{', '.join(f'{r['wall_s']:.1f}' for r in runs)} s; launches {[r['launches'] for r in runs]} (expected "
        f"{runs[0]['want']} a rank); checkpoint writes by rank {[r['writes'] for r in runs]}, files "
        f"{runs[0]['files']}, best.pth {runs[0].get('pth_values')} values (the whole model's state dict {whole}); "
        f"processes {wall:.1f} s [{card}]")
    if any(r["history"] != runs[0]["history"] for r in runs):
        raise AssertionError("the tp trainer's ranks differ")
    want_files = sorted(["latest.pt", "best.pt", "best.pth"])
    if (runs[0]["writes"] != ["latest"] * TP_EPOCHS or any(r["writes"] for r in runs[1:])
            or runs[0]["files"] != want_files or runs[0].get("pth_values") != whole):
        raise AssertionError(f"tp trainer checkpoints: writes {[r['writes'] for r in runs]}, files "
                             f"{runs[0]['files']} (expected {want_files}), best.pth values {runs[0].get('pth_values')} "
                             f"against {whole}")
    for r in runs:
        if (r["launches"] != r["want"] or not r["cached"]
                or r["mesh"] != {"data": 1, "spatial": 1, "model": TP_RANKS}):
            raise AssertionError(f"tp trainer: {r}")
        if not all(math.isfinite(v) for vals in r["history"].values() for v in vals):
            raise AssertionError(f"non-finite history {r['history']}")
    return [sum(r["launches"][i] for r in runs) for i in (0, 1)]


def tp_phase(work: str, device, card: str, ref: dict) -> dict:
    """Tensor parallelism on the one card: the kernels at one output-channel
    shard's shapes (base 64 at TP_RANKS) against their plain versions, then
    (b) the sharded steps, (c) the sharded Trainer. Returns the launches of
    each path and the shard-shape kernel records. First the earlier phases'
    outputs but the cases and their preprocessing cache are deleted, so
    that (c)'s checkpoints reuse their blocks on the machine's disk."""
    for entry in os.listdir(work):
        if entry not in ("cache_data", "preproc"):
            path = os.path.join(work, entry)
            shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    shard = {"fwd": check_kernels(device, card, (1,), tp=TP_RANKS), "dx": check_dx_kernels(device, card, tp=TP_RANKS),
             "dw": check_dw_kernels(device, card, tp=TP_RANKS)}
    return {"train": tp_steps(work, ref, card), "trainer": tp_trainers(work, card), "shard": shard}


def phase(name: str, fn, *args):
    """``fn(*args)``, logging the seconds it took: where the script's time goes."""
    t = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "pcmseg_tpu_torch", "csrc")):
        print(f"chip_smoke: no pcmseg_tpu_torch package beside {__file__}; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    # fp32 means fp32 in every process of the script, its ranks' too
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if sys.argv[1:2] == ["--profiled"]:  # the profiling phase's own process
        print(json.dumps(profiled_runs(sys.argv[2], torch.device("cuda"))))
        return 0
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of the dp phase's steps
        rank, world, port, work, backend = sys.argv[2:7]
        print(json.dumps(dp_rank(int(rank), int(world), int(port), work, backend)))
        return 0
    if sys.argv[1:2] == ["--dp-c-rank"]:  # a rank of the dp phase's layout (c) step
        rank, world, port, work, backend = sys.argv[2:7]
        print(json.dumps(dp_c_rank(int(rank), int(world), int(port), work, backend)))
        return 0
    if sys.argv[1:2] == ["--dp-trainer"]:  # a rank of the dp phase's Trainer
        rank, world, port, work, backend, name = sys.argv[2:8]
        print(json.dumps(dp_trainer(int(rank), int(world), int(port), work, backend, name)))
        return 0
    if sys.argv[1:2] == ["--sp-rank"]:  # a rank of the sp phase's steps
        rank, world, port, work, backend = sys.argv[2:7]
        print(json.dumps(sp_rank(int(rank), int(world), int(port), work, backend)))
        return 0
    if sys.argv[1:2] == ["--sp-trainer"]:  # a rank of the sp phase's Trainer
        rank, world, port, work, backend, name = sys.argv[2:8]
        print(json.dumps(sp_trainer(int(rank), int(world), int(port), work, backend, name)))
        return 0
    if sys.argv[1:2] == ["--tp-rank"]:  # a rank of the tp phase's steps
        rank, world, port, work, backend = sys.argv[2:7]
        print(json.dumps(tp_rank(int(rank), int(world), int(port), work, backend)))
        return 0
    if sys.argv[1:2] == ["--tp-trainer"]:  # a rank of the tp phase's Trainer
        rank, world, port, work, backend, name = sys.argv[2:8]
        print(json.dumps(tp_trainer(int(rank), int(world), int(port), work, backend, name)))
        return 0
    from pcmseg_tpu_torch.core.config import get_config
    from pcmseg_tpu_torch.data.native import get_native_lib
    from pcmseg_tpu_torch.ops.kernels import build

    device = torch.device("cuda")
    card = card_label()
    log(f"device: {torch.cuda.get_device_name(0)} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}); nvidia-smi: {card}")

    info = build.build()
    log(f"build: {'cached' if info['cached'] else 'compiled'} {info['path']} "
        f"in {info['seconds']:.1f} s")

    config = get_config(base_features=BASE_FEATURES, norm_layer="batch")
    if sys.argv[1:] == ["--only", "dw_sum"]:  # the same-sign dW phase alone
        phase("dw_sum", dw_sum, device, card)
        print(card)
        return 0
    if sys.argv[1:] == ["--only", "bn"]:  # the BatchNorm kernels' times, then one step's launches and times
        phase("bn_kernels", bn_kernels, device, card)
        phase("time", time_steps, device, card)
        print(card)
        return 0
    record = phase("kernels", check_kernels, device, card, (1, config.window_tile_batch))
    dx = phase("dx", check_dx_kernels, device, card)
    dw = phase("dw", check_dw_kernels, device, card)
    fp32k = phase("fp32_kernels", check_fp32_kernels, device, card)
    fp16k = phase("fp16_kernels", check_fp16_kernels, device, card)
    same_sign = phase("dw_sum", dw_sum, device, card)
    bn = phase("bn_kernels", bn_kernels, device, card)
    phase("gradients", check_gradients, device, card)

    work = os.path.join(REPO, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if sys.argv[1:] in (["--only", "dp"], ["--only", "sp"], ["--only", "tp"]):  # one phase alone, after the kernels'
        ref = phase("dp_reference", dp_reference, device)
        phase(sys.argv[2], {"dp": dp_phase, "sp": sp_phase, "tp": tp_phase}[sys.argv[2]], work, device, card, ref)
        shutil.rmtree(work, ignore_errors=True)
        print(card)
        return 0
    if sys.argv[1:] == ["--only", "fp16"]:  # the fp16 step, Trainer and server alone, after the kernels'
        ref = phase("dp_reference", dp_reference, device)
        phase("fp16_train", fp16_train, work, device, card, ref)
        shutil.rmtree(work, ignore_errors=True)
        print(card)
        return 0
    if sys.argv[1:] == ["--only", "fp32"]:  # the fp32 and param_dtype phases alone, after the kernels'
        ref = phase("dp_reference", dp_reference, device)
        phase("fp32_train", fp32_train, work, device, card, ref)
        phase("param_dtype", param_dtype_phase, work, device, card)
        shutil.rmtree(work, ignore_errors=True)
        print(card)
        return 0
    train_launches = phase("train", train, work, device, card)
    bn_step_s, time_bn_launches = phase("time", time_steps, device, card)
    cv_launches, cv_dir = phase("cv", cross_validate, work, device, card)
    validate_launches = phase("validate", validate, work, cv_dir, device, card)
    phase("cli", cli, work, cv_dir, card)
    cache_launches = phase("cache", cache_phase, work, device, card)
    ds_launches = phase("ds", deep_supervision, work, device, card)
    kclass_launches = phase("kclass", kclass, work, device, card, bn_step_s)

    native = get_native_lib() is not None
    log(f"host preprocessing: {'native C++ normalize' if native else 'numpy fallback'}")
    (serve_launches, serve_bn_launches), server = phase("serve", serve, work, config, device, card)
    phase("profile", profile, work, server, card)
    profiling_launches = phase("profiling", profiling_phase, work, device, card)
    async_launches = phase("async_ckpt", async_ckpt, work, device, card)
    ingest_launches = phase("ingest", ingest, work, server, device, card)
    del server
    torch.cuda.empty_cache()
    ref = phase("dp_reference", dp_reference, device)
    fp32_launches = phase("fp32_train", fp32_train, work, device, card, ref)
    pd_launches = phase("param_dtype", param_dtype_phase, work, device, card)
    fp16_launches = phase("fp16_train", fp16_train, work, device, card, ref)
    dp_launches = phase("dp", dp_phase, work, device, card, ref)
    sp = phase("sp", sp_phase, work, device, card, ref)
    tp = phase("tp", tp_phase, work, device, card, ref)
    shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [
        {
            "name": "conv3x3x3",
            "route": "cuda",
            "source": "pcmseg_tpu_torch/csrc/conv3x3x3.cu",
            "replaces": "pcmseg_tpu/ops/pallas/conv3d.py:121",
            "launches": train_launches[0],
            "launches_by_path": {"train": train_launches[0], "serve": serve_launches, "cv": cv_launches[0],
                                 "validate": validate_launches[0],
                                 **{f"cache_{p}": cache_launches[p][0] for p in "abc"}, "ds": ds_launches[0],
                                 "kclass": kclass_launches[0], "profiling": profiling_launches[0],
                                 "async_ckpt": async_launches[0], "ingest": ingest_launches,
                                 "dp_a": dp_launches[0][0], "dp_b": dp_launches[1][0], "dp_c": dp_launches[2][0],
                                 "sp_serve": sp["serve"],
                                 "sp_train": sp["train"][0], "sp_trainer": sp["trainer"][0],
                                 "tp_train": tp["train"][0], "tp_trainer": tp["trainer"][0],
                                 "param_dtype_train": pd_launches["step"][0],
                                 "param_dtype_trainer": pd_launches["trainer"][0],
                                 "param_dtype_serve": pd_launches["serve"]},
            "max_abs_err": max(record["max_abs_err"], dx["max_abs_err"], sp["slab"]["fwd"]["max_abs_err"],
                               sp["slab"]["dx"]["max_abs_err"], tp["shard"]["fwd"]["max_abs_err"],
                               tp["shard"]["dx"]["max_abs_err"]),
            # the 18 forward convs of one 128^3 microbatch; dx_*: the 17 dx convs
            **{k: record[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **{f"dx_{k}": dx[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            # the same at one of SP_RANKS D-slabs of a 128^3 microbatch with its halo
            **{f"slab_{k}": sp["slab"]["fwd"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            **{f"slab_dx_{k}": sp["slab"]["dx"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            # the same at one of TP_RANKS output-channel shards of each conv (dx: of dy's channels)
            **{f"tp_{k}": tp["shard"]["fwd"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            **{f"tp_dx_{k}": tp["shard"]["dx"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        },
        {
            "name": "conv3x3_dw",
            "route": "cuda",
            "source": "pcmseg_tpu_torch/csrc/conv3x3_dw.cu",
            "replaces": "pcmseg_tpu/ops/pallas/conv3d_grad.py:147",
            "launches": train_launches[1],
            "launches_by_path": {"train": train_launches[1], "cv": cv_launches[1], "validate": validate_launches[1],
                                 **{f"cache_{p}": cache_launches[p][1] for p in "abc"}, "ds": ds_launches[1],
                                 "kclass": kclass_launches[1], "profiling": profiling_launches[1],
                                 "async_ckpt": async_launches[1], "dp_a": dp_launches[0][1],
                                 "dp_b": dp_launches[1][1], "dp_c": dp_launches[2][1], "sp_train": sp["train"][1],
                                 "sp_trainer": sp["trainer"][1], "tp_train": tp["train"][1],
                                 "tp_trainer": tp["trainer"][1], "param_dtype_train": pd_launches["step"][1],
                                 "param_dtype_trainer": pd_launches["trainer"][1]},
            **dw,
            "max_abs_err": max(dw["max_abs_err"], sp["slab"]["dw"]["max_abs_err"], tp["shard"]["dw"]["max_abs_err"]),
            # the dw_sum phase: the worst element's error from float64 on same-sign inputs, over Σ|x·dy|
            "same_sign_max_rel_err": same_sign["bf16"],
            **{f"slab_{k}": sp["slab"]["dw"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
            **{f"tp_{k}": tp["shard"]["dw"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        },
        {
            "name": "conv3x3x3_f32",
            "route": "cuda",
            "source": "pcmseg_tpu_torch/csrc/conv3x3x3_f32.cu",
            "replaces": "pcmseg_tpu/ops/pallas/conv3d.py:121",
            # the fp32 step's first step; the bf16-param phase launches none
            "launches": fp32_launches["step"][0],
            "launches_by_path": {"fp32_train": fp32_launches["step"][0], "fp32_trainer": fp32_launches["trainer"][0],
                                 "fp32_serve": fp32_launches["serve"]},
            # errors from float64 of the same fp32 inputs; the bound at 3xTF32's 165 TFLOP/s,
            # ffma_bound_ms at FFMA's 66.9
            "max_abs_err": max(fp32k["fwd"]["max_abs_err"], fp32k["dx"]["max_abs_err"]),
            **{k: fp32k["fwd"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "ffma_bound_ms")},
            **{f"dx_{k}": fp32k["dx"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "ffma_bound_ms")},
        },
        {
            "name": "conv3x3_dw_f32",
            "route": "cuda",
            "source": "pcmseg_tpu_torch/csrc/conv3x3_dw_f32.cu",
            "replaces": "pcmseg_tpu/ops/pallas/conv3d_grad.py:147",
            "launches": fp32_launches["step"][1],
            "launches_by_path": {"fp32_train": fp32_launches["step"][1], "fp32_trainer": fp32_launches["trainer"][1]},
            **fp32k["dw"],
        },
        {
            "name": "conv3x3x3_f16",
            "route": "cuda",
            "source": "pcmseg_tpu_torch/csrc/conv3x3x3.cu",
            "replaces": "pcmseg_tpu/ops/pallas/conv3d.py:121",
            # the fp16 step's first step (the entry point pcmseg_conv3x3x3_f16)
            "launches": fp16_launches["step"][0],
            "launches_by_path": {"fp16_train": fp16_launches["step"][0], "fp16_trainer": fp16_launches["trainer"][0],
                                 "fp16_serve": fp16_launches["serve"],
                                 "fp16_param_f16": fp16_launches["param_f16"][0]},
            # errors from fp32 of the same fp16 inputs; library_ms: cuDNN's fp16 conv / dgrad
            "max_abs_err": max(fp16k["fwd"]["max_abs_err"], fp16k["dx"]["max_abs_err"]),
            **{k: fp16k["fwd"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **{f"dx_{k}": fp16k["dx"][k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        },
        {
            "name": "conv3x3_dw_f16",
            "route": "cuda",
            "source": "pcmseg_tpu_torch/csrc/conv3x3_dw.cu",
            "replaces": "pcmseg_tpu/ops/pallas/conv3d_grad.py:147",
            "launches": fp16_launches["step"][1],
            "launches_by_path": {"fp16_train": fp16_launches["step"][1], "fp16_trainer": fp16_launches["trainer"][1],
                                 "fp16_param_f16": fp16_launches["param_f16"][1]},
            **fp16k["dw"],
            "same_sign_max_rel_err": same_sign["fp16"],
        },
        {
            "name": "batchnorm_relu",
            "route": "cuda",
            "source": "pcmseg_tpu_torch/csrc/batchnorm_relu.cu",
            # no Pallas kernel: the JAX package leaves BatchNorm and ReLU to XLA
            "replaces": None,
            # the train phase's 2 steps, held exact there
            "launches": train_launches[2],
            "launches_by_path": {"train": train_launches[2], **time_bn_launches, "serve": serve_bn_launches,
                                 "dp_a": dp_launches[0][2], "dp_c": dp_launches[2][2]},
            # the largest error from float64 of y, dx, dγ, dβ, the mean and the
            # unbiased variance at the 5 levels' shapes, bf16
            "max_abs_err": bn["max_abs_err"],
            # the 18 layers of one 128^3 microbatch, forward and backward, bf16;
            # library_ms: PyTorch's SyncBatchNorm ops and a ReLU
            **{k: bn[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "kernels_ms")},
        },
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
