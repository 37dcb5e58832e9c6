#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training and drift-forensics paths, the
fused ResNet stem, the static ISP's drift-synthesis path, segmentation,
the neural and identity ISPs, the drift evaluation harness, and the
folder datasets and the tile store, on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises (non-zero exit, no final
line):

1. device: the ``nvidia-smi`` name and power limit; TF32 off for cuDNN
   and matmul, so that every comparison below is full f32.
2. build: compile the CUDA sources (``fused_isp_fwd.cu``,
   ``fused_isp_bwd.cu``, ``ssim_aux.cu``, ``stem.cu``) with nvcc, in
   parallel, then the tile store (``tilestore.cpp``, the host C++
   compiler); print nvcc's register and spill report and each kernel's
   registers, CTAs per SM and shared bytes (``r2l_kernel_info``).
3. kernel vs plain: the serving kernel against its plain PyTorch
   version, at the serving shape (B=32, 256x256: edge and corner tiles
   included) and at shapes that are not multiples of the tile, with
   perturbed non-symmetric parameters, two cameras and inputs that reach
   both clip bounds (per-pixel tolerance ``KERNEL_TOL``).
4. train kernels vs plain, at the same shapes and cameras: the training
   forward (RGB as in 3 and bitwise equal to the serving kernel's,
   residuals within ``RES_TOL``), and both backward variants on the noisy
   inputs and on smoothed ones, each under a positive cotangent and under
   the mean-zero one that a training-mode output batch norm hands back
   (the statistical contract ``BWD_*`` against the plain version; on the
   smooth inputs also ``BWD_F64_*`` against the plain version computed in
   float64); the two variants within ``VARIANT_TOL`` of each other, and
   two launches bitwise identical.
5. serve: 64 synthetic 16-bit DNG mosaics through
   ``Predictor.predict_dir`` at full ResNet-18 width, counting kernel
   launches; then the same batches through a Predictor whose ISP takes
   the plain path, logits within 1e-4 abs.
6. train: ``make_train_step`` at full ResNet-18 width, B=32, for two
   classifiers (as built, and with perturbed batch norms) and two seeds
   each: one step through the kernel path, one through the plain path
   (twice, and once on a nudged input) and one through the plain path in
   float64, from identical weights, compared (loss, ISP and classifier
   gradients, running statistics); the kernel step's ISP gradients also
   against the float64 plain backward on the cotangent that step handed
   its ISP. Then 5 kernel-path steps, counting launches: every ISP
   parameter moves. Then the recompute backward as its users call it,
   ``fused_isp_bwd`` without residuals, on that batch and cotangent.
7. ssim kernel vs plain: the SSIM aux kernel against its plain version
   (autograd of ``ops/ssim.py``) at B=32 and five smaller shapes that cut
   its strips raggedly (``SSIM_SHAPES``), two
   weights, on the batch-normalised outputs of the default and a
   perturbed microscopy ISP and on random images with flat patches: the
   value within ``SSIM_VALUE_REL`` of the float64 plain version, the
   gradient within ``SSIM_GRAD_REL`` of the float32 one and no further
   from the float64 one than ``SSIM_F64_FACTOR`` times the float32 one
   is, two launches bitwise equal.
8. adversarial: the drift-forensics step (``bench.py``'s adversarial
   family: ResNet-18 frozen, SSIM aux weight 0.3, lr 1e-3) at B=32, one
   step through the kernel path against the plain path from identical
   weights, the SSIM cotangent and the ISP gradients held to float64
   witnesses on that step's own tensors; then 5 kernel-path steps,
   counting launches: the reference, the classifier and every BN
   statistic bitwise unchanged, every ISP parameter moved; then one step
   each targeting ``gamma_correct`` and ``additive_layer``.
9. cli: the forensics sequence through the training CLI
   (``python -m raw2logit_tpu_torch.training.train``): a pretraining run
   with a frozen ISP and weak augmentation, then an SSIM-regularised
   attack on gamma through the classifier file it wrote.
10. stem kernels vs plain: the five stem kernels (``kernels/stem.py``)
   against their plain versions at B=256 and B=32, 256x256 and at four
   small shapes with ragged tiles (``STEM_SHAPES``; the conv forward
   also without statistics, as serving runs it, bitwise the same act),
   on the batch-normalised outputs of the
   microscopy ISP and on random inputs whose conv output is quantised to
   multiples of 1/8 (planted ties in the pool), each kernel on the same
   inputs as its plain version (the pool backward on the kernel's own
   act), dW and d_x also against float64 plain versions (``STEM_*``); two
   launches bitwise equal. Then the five bfloat16 forms likewise
   (``BF16_SHAPES``, ``BF16_*``), each also against a float64 witness on
   the same bfloat16-rounded operands, with the bitwise shares.
11. stem train: ``make_train_step`` at full ResNet-18 width, B=32, with
   the ISP kernels, one step with ``stem_kernel=True`` against one with
   the plain stem from identical weights (loss, classifier gradients as
   one vector, ISP gradients, running statistics), the kernel step's stem
   gradients held to the float64 plain stem on that step's own input and
   cotangent; then 5 steps counting launches (each stem kernel once per
   step) in which every ISP and stem parameter moves.
12. stem serve: ``Predictor`` with ``stem_kernel=True``, logits against
   the plain stem's; only the two forward stem kernels launch.
13. bn: the ISP's output batch norm (``isp/batchnorm.py``, closed form)
   against nn.BatchNorm2d in float64 on the fused ISP's output at B=32
   and B=256 (``BN_*``), its CUDA-event and profiled device ms beside
   nn.BatchNorm2d's, and its reductions over (0, 2, 3) against two stages
   over a (B, C, H W) view.
13a. bf16 paths: the bfloat16 task models held to the float32 ones under
   JAX's bfloat16 contract (``BF16_DRIFT_*``, ``BF16_LOSS_REL``): the
   B=256 classification train step with the stem flag off and on and its
   eval call (logits float32), the B=32 segmentation and adversarial
   steps; the flag-on step and eval call are the bfloat16 forms' main
   path (each launched, no float32 form).
13b. staged: ``make_staged_train_step`` (the same update in explicit
   stages, each calling the kernels' wrappers), with and without
   fuse_opt, at full ResNet-18 width, float32, B=32 and B=256, stem flag
   off and on, against the one step from identical weights (phase 6's
   gates, the classifier leaf by leaf), its ISP gradients against the
   float64 plain backward on the cotangent its ISP-backward stage
   received; one adversarial SSIM staged step at B=32 (phase 8's gates);
   one bfloat16 staged step with the stem flag at B=256 (phase 13a's
   contract); each staged step's launches (kernels 2 and 3 once, kernel 4
   never; kernel 1 and the SSIM kernel once in adversarial, each stem form
   once with the flag); then CUDA-event ms and device idle share of the
   one, staged and staged fuse_opt steps at B=32 and B=256.
14. times: CUDA-event times of each kernel, its plain version, its bound
   and, for the stem's convolutions and pool backward, the nearest library
   call (``LIBRARY_CALLS``), of
   ``Predictor.__call__``, of a train step (with the fused stem and
   without) and of an adversarial step, at B=32 and B=256.
15. profile: device time by kernel and the device's idle share of
   ``Predictor.__call__`` and of a train step (each with the fused stem
   and without), of the bfloat16 train step with the fused stem (the
   stem's bfloat16 forms), of an adversarial step and of the recompute
   backward (torch.profiler), at B=32 and B=256; at B=256 beside the
   device ms of the redesigned kernels as first ported
   (``FIRST_PORT_DEVICE_MS``).
15a. bf16 times: CUDA-event ms and peak memory of each bfloat16 step
   beside its float32 one, and the forms' kernel, plain and library
   (bfloat16) ms beside their bound (2-byte storage, the bfloat16
   tensor-core peak) and their device ms from 15.
16. static gates: the static ISP (no kernel of the port on its path) on
   the card in float32 against the port's own float64 run on the CPU, at
   B=32, 256x256 (SyntheticMicroscopy mosaics at exposures from dark to
   bright): Menon's decision map (flipped share), the three demosaic
   stages, and the nine pipelines of tests/test_isp.py with TV-Chambolle
   and the bilateral filter, before and after gamma (``STATIC_*``,
   ``MENON_*``).
17. static cli: a 1-epoch --test_run of ``--processing_mode static
   --precompute_static`` through the training CLI, then ``serving.main``
   on that run over 64 synthetic DNGs: one record per file, the logits of
   ``Predictor.from_run`` equal to the trained classifier's, no ISP
   kernel launched (the CLI's classifier runs the fused stem,
   ``routed_stem``).
18. static precompute: ``precompute_pipeline_rgb`` in images/s for each
   debayer (batches of 256, 512 mosaics in host memory).
19. static times and profile: the static train step in graph (the CLI's
   choices, and menon2007) and on precomputed RGB at B=32 and B=256, its
   CUDA-event ms with the launch counts at 0 before and after, its device
   time by kernel and idle share (no port kernel in the profile).
20. seg train: ``make_train_step(task="segmentation")`` with the CLI's
   segmenter (resnet34 U-Net++, depth 5, decoder (256, 128, 64, 32, 16))
   behind the drone ISP on 256x256 SyntheticRawSegmentation mosaics: one
   step through the ISP kernels against one through the plain ISP from
   identical weights at B=8 (loss, IoU, U-Net++ gradients as one vector,
   running statistics), the kernel step's ISP gradients against the
   float64 plain backward on its own cotangent; then 3 kernel-path steps
   at B=32, counting launches (one training forward and one residual
   backward per step), every ISP parameter moved.
21. seg serve: ``Predictor.predict_dir`` with that pair on 64 synthetic
   16-bit DNGs, one serving launch per batch, masks against the plain
   ISP's within ``SEG_MASK_TOL``.
22. neural and identity: ``NNProcessing`` at its published widths in
   float32 on the card against itself in float64 on the card, eval and
   train mode, at B=4 (``NN_F64_REL``); ``RawToRGB`` on the card against
   the CPU (``IDENTITY_TOL``); one neural-ISP train step (ResNet-18
   behind it) that launches no kernel of the port and moves every
   parameter and running statistic.
23. seg and neural cli: a 1-epoch --test_run of SyntheticDrone with the
   ISP kernels through the training CLI, ``serving.main`` on that run over
   64 DNGs (``Predictor.from_run``'s masks equal to the trained modules'),
   then --test_run of --processing_mode neural_network and none.
24. seg times: CUDA-event ms, launches, peak device memory, device ms by
   kernel and idle share (a profile of more calls) of each step of
   ``SEG_TIMES``: the segmentation train step and serving at B=32 and at
   the largest batch that fits (the train step at 256 with ``remat``),
   and the neural and identity ISP train steps at B=32 and B=256.
25. eval gates: the corruption battery (all but jpeg_compression, PIL)
   at severities 1, 3 and 5 on the microscopy static pipeline's RGB of
   32 SyntheticMicroscopy mosaics, in float32 on the card against the
   port's float64 run on the CPU on the same draws (``EVAL_*``); the
   identity cell program's logits against the CPU's float64 run; every
   cell program of the C table run without a host synchronisation
   (torch's sync debug mode raising).
26. eval cli: two 1-epoch static --test_runs through the training CLI,
   then ``raw2logit_tpu_torch.figures.ABtesting`` with ABMakeTable (2 x
   12) and CMakeTable (2 x 11 x 5) over their classifiers: every cell
   finite, each diagonal cell equal to its classifier evaluated directly,
   a second invocation computing no cell, --N_runs 1 discarding the A/B
   table.
27. eval times: the full 12 x 12 A/B table (its first 2 rows at 256) and
   one row of the C table on 940 SyntheticMicroscopy mosaics (the valid
   split, 188 images) at B = 32 and 256, the wall seconds split into
   precomputes and cell programs, the C cells' images/s at severity 3,
   peak memory; profiles of the identity cell and of one precompute. No kernel of the port
   launches in 25-27.
28. examples: the three drivers of ``raw2logit_tpu_torch.examples`` with
   --use_pallas at B = 32 on the CLI's SyntheticMicroscopy (n = 64,
   256x256): forensics on gamma (1 + 2 epochs; kernels 1, 2, 3 and 5, only
   gamma drifting), optimisation (1 epoch per arm; kernels 1-3), the
   cycle's 1 x 12 A/B table; the reports carry the committed JAX
   artifacts' fields.
29. sweep: ``python -m raw2logit_tpu_torch.training.sweep --shard 0
   --n_shards 12 --epochs 1`` (one job, the CLI in a subprocess), its
   --resume training nothing, ABMakeTable over its manifest.
30. app: ``app.process`` on the card for a 256x256 microscopy mosaic and a
   3000x4000 drone frame against the float64 CPU run (the static gates'
   tolerances); the HTTP form and a POST's error reply.
31. data parallel: two gloo ranks on cuda:0 (torch.multiprocessing), one
   train step at global B = 64 with the stem flag off and on, against the
   one-process step (``DP_*``); a CLI run under an NCCL group of one,
   calling no collective.
32. parallel helpers: full 3000x4000 drone frames split by rows over
   [cuda:0, cuda:0] against the unsplit run (malvar2004 + median, the FFT
   denoiser, the eval-mode ISP through kernel 1), and the 12-pipeline
   grid against each pipeline alone.
32a. bf16 cli: a 5-step --test_run with --compute_dtype bfloat16,
   --classifier_pretrained (a synthesised weights/resnet18.npz in the JAX
   package's layout) and --profile, in a temporary directory.
32b. folder data, with neither PIL nor pandas: 940 seeded 256x256
   16-bit mosaics (the Raw-Microscopy count) written as DNGs, labelled in
   9 classes, read by ``FolderClassification``; one per-item-decode epoch
   through ``Loader``; float32 and uint16 tile stores of the folder (build
   s, bytes, a gather epoch at B = 32 and 256): the float32 store's
   batches bitwise the folder's in the same shuffled order, the uint16
   store's within 1 ulp, a ``Subset`` of the store on k_fold's train
   indices bitwise the same ``Subset`` of the folder; one epoch of the
   full-width train step (ISP kernels, ResNet-18, B = 32, stem flag off
   and on) fed by the store and by the folder: images/s, launches per
   step, idle share, the first step's loss within 1e-6; two 3000x4000
   drone frames with car masks as DNGs, read by ``FolderSegmentation``,
   tiled to 256 with ``split_img``, the tiles with a car in a
   segmentation store, a gather epoch, 2 U-Net++ steps at B = 32 fed by
   it.
33. the ``kernels`` line (with each kernel's launches on the segmentation
   path, on the store-fed train epochs and on the staged steps of 13b;
   the bfloat16 forms as ``<kernel>_bf16``), then the ``ok`` line.
"""

import contextlib
import copy
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from raw2logit_tpu_torch.data import (DRONE_CAMERA_PARAMS,
                                      MICROSCOPY_CAMERA_PARAMS,
                                      ArrayDataset, FolderClassification,
                                      FolderSegmentation, Loader, Subset,
                                      SyntheticRawClassification,
                                      SyntheticRawSegmentation,
                                      dataset_stats, k_fold, load_image,
                                      precompute_pipeline_rgb, read_dng,
                                      split_img, write_dng)
from raw2logit_tpu_torch.data import tilestore
from raw2logit_tpu_torch.data.tiling import keeps_tile
from raw2logit_tpu_torch.data.tilestore import TileStore, build_store
from raw2logit_tpu_torch.evaluation import CORRUPTIONS, ConfusionMetrics
from raw2logit_tpu_torch.evaluation import abtesting
from raw2logit_tpu_torch.evaluation.abtesting import (CORRUPTION_LIST,
                                                      ABTesting,
                                                      pipeline_grid,
                                                      pipeline_name)
from raw2logit_tpu_torch.isp import (NNProcessing, ParametrizedProcessing,
                                     RawToRGB, StaticPipeline,
                                     TorchBatchNorm, static_process)
from raw2logit_tpu_torch.kernels import (
    PARAM_NAMES, batch_stats, bn_backward_coef, bn_fold, bn_input_cotangent,
    fused_isp, fused_isp_bwd, fused_isp_bwd_reference, fused_isp_reference,
    fused_isp_train, fused_isp_train_reference, ssim_aux_reference,
    ssim_aux_value_grad, stem_bnpool, stem_bnpool_reference, stem_conv,
    stem_conv_dw, stem_conv_dw_reference, stem_conv_dx,
    stem_conv_dx_reference, stem_conv_reference, stem_pool_bwd,
    stem_pool_bwd_reference, stem_reference, unpack_grads, window_taps)
from raw2logit_tpu_torch.kernels.stem import rounded
from raw2logit_tpu_torch.kernels.build import build, kernel_info
from raw2logit_tpu_torch.isp.static import GAMMA as STATIC_GAMMA
from raw2logit_tpu_torch.isp.static import camera_stage, filter_stage
from raw2logit_tpu_torch.ops.color import (adjust_gamma, colour_correction,
                                           white_balance)
from raw2logit_tpu_torch.ops.demosaic import DEMOSAIC_FNS, menon_decision
from raw2logit_tpu_torch.ops.filters import conv2d_f32, full_float32
from raw2logit_tpu_torch.ops.mosaic import subtract_black_level_cfa
from raw2logit_tpu_torch.models import UNetPlusPlus, resnet_model
from raw2logit_tpu_torch.parallel import distributed
from raw2logit_tpu_torch.serving import Predictor
from raw2logit_tpu_torch.training.checkpoint import save_module
from raw2logit_tpu_torch.training import (TrainConfig, create_train_state,
                                          make_staged_train_step,
                                          make_train_step)

SEED = 0
# Fused kernel vs plain version: |kernel - plain| <= KERNEL_TOL + LIN_TOL *
# slope, where slope = p / (g * max(p^g, 1e-5)) is d out / d v of the gamma
# curve out = v^(1/g) at the plain output p. KERNEL_TOL is the 2e-5 abs of
# tests/test_pallas.py:32. LIN_TOL is a float32 rounding of the pre-gamma
# value (1e-6, about 8 ulp at 1): near the 1e-5 clip floor the slope
# reaches ~240, so over the 2M pixels of a served batch even the float32
# plain version differs from its float64 self by more than 2e-5 there,
# while a wrong tap or pad shows up off the floor, where slope < 1.
KERNEL_TOL, LIN_TOL = 2e-5, 1e-6
MILD_CAMERA = ([0.01, 0.012, 0.011, 0.013], [1.5, 1.0, 1.2],
               [1.2, -0.1, -0.05, -0.08, 1.1, -0.02, -0.03, -0.1, 1.15])
LOGIT_TOL = 1e-4   # kernel-path vs plain-path logits, TF32 off
SERVE_IMAGES, SERVE_BATCH, SIZE, BIG_BATCH = 64, 32, 256, 256
CHECK_SHAPES = ((SERVE_BATCH, SIZE, SIZE), (4, 250, 250), (3, 67, 45))

# Training kernels: residual planes vs their plain versions, abs (deb, s
# and t come before the gamma curve, so no slope term applies); the
# residual and recompute backward variants against each other, abs
# (tests/test_pallas.py:180).
RES_TOL, VARIANT_TOL = 2e-5, 1e-6
# Backward kernel vs plain (tests/test_pallas.py:153-159): median |d_raw
# error| below 1e-3 max|plain|, fewer than 2% of pixels above 1e-2 max,
# each parameter gradient within 2e-2 max-relative (floor 1e-3). Pixels
# just above the clip floor amplify float32 rounding by up to ~1e5, so
# the contract is statistical.
BWD_MEDIAN, BWD_OUTLIER, BWD_OUTLIER_SHARE, BWD_PARAM = 1e-3, 1e-2, 2e-2, 2e-2
# Tight limits where few pixels sit near the clip floor (the smooth
# inputs; in the train phase the inputs inside the clips), which a bug
# confined to the image border would not pass, though it could pass the
# statistical contract. d_raw: max |kernel - plain| over max|plain|
# (BWD_TIGHT_DRAW). Parameter gradients: max-relative (floor 1e-3)
# against the plain version computed in float64 from the same float32
# inputs (the witness), within BWD_F64_PARAM or twice the float32 plain
# version's own distance from it, whichever is larger: a mean-zero
# cotangent makes them sums that cancel, where float32 itself loses
# digits. (d_raw is not held to the witness: where a pre-clip value lies
# within float32 rounding of a clip bound, float32 and float64 take
# different sides of it, and both float32 routes differ from float64 by
# a whole gradient term there.)
BWD_TIGHT_DRAW, BWD_F64_PARAM = 1e-5, 1e-4
# Train step against the float64 step from identical weights: the kernel
# path's ISP gradients within BWD_PARAM, its classifier gradients (one
# vector) within CLF_GRAD_TOL, or within STEP_F64_FACTOR times the
# farther of the plain path and the nudged plain path from it, whichever
# is larger (phase_train says why)
STEP_F64_FACTOR = 2.0
# Train step, kernel path vs plain path from identical weights: loss abs,
# classifier gradients max-relative as one vector (phase_train says why),
# running statistics relative; ISP gradients at BWD_PARAM.
LOSS_TOL, CLF_GRAD_TOL, STATS_TOL = 1e-5, 1e-3, 1e-5
TRAIN_LR, TRAIN_STEPS = 1e-5, 5   # bench.py:106; a few steps at B = 32
# Classifiers of the train-step comparison (train_classifier), and seeds
CLF_SETUPS, TRAIN_SEEDS = ("as_built", "perturbed"), (0, 1)
# The ISP parameters' names in the module, by kernel parameter name
ISP_NAMES = dict(zip(PARAM_NAMES, (
    "black_level", "debayer.weight", "white_balance", "colour_correction",
    "sharpening_filter.weight", "gaussian_blur.weight", "gamma_correct")))
# raw * 0.02 + 0.025: the synthetic mosaics at an exposure where every
# output of the perturbed microscopy ISP lies inside the clips, between
# ~0.25 and ~0.91 (phase_train checks it)
INSIDE_CLIPS = (0.02, 0.025)

# Published peaks (NVIDIA data sheets): device-memory bytes/s, non-tensor
# f32 operations/s and dense bfloat16 tensor-core operations/s; first
# matching name wins.
PEAKS = (("H100 PCIe", 2.0e12, 51e12, 756e12),
         ("H100 NVL", 3.9e12, 60e12, 835e12),
         ("H200", 4.8e12, 67e12, 989e12), ("H100", 3.35e12, 67e12, 989e12))
# Bytes each kernel must move and f32 operations it must do, per pixel
# (an FMA is 2, a transcendental 1).
# fused_isp_fwd: read raw 4 B, write RGB 12 B; 174 operations: black
#   level 1, debayer 27 FMA (54), YUV matrix 9 FMA (18), sharpen 9 FMA
#   (18), blur 25 FMA (50), YUV->RGB 9 FMA (18), clip 6, gamma 3
#   multiplies and 6 transcendentals (log, exp per channel).
# fused_isp_fwd_train: the same, and writes 20 B of residuals.
# fused_isp_bwd_res: read raw 4, g 12, res 20 B, write d_raw 4 B; 386
#   operations: U, V 6 FMA (12); per channel pre-clip 3 FMA (6), clip 2,
#   log and exp 2, slope and cotangent 3, clip mask 3, d_gamma 5, the
#   transposed YUV->RGB 3 FMA (6), so 27 x 3 = 81; blur adjoint 25 FMA
#   (50); sharpen adjoint 9 FMA (18); Y 3 FMA (6); A^T 9 FMA (18); debayer
#   adjoint 27 FMA (54); partials dK_blur 25, dK_sharp 9, dA 9 and
#   dK_debayer 27 FMA (140), d_black_level 1.
# fused_isp_bwd: reads no residuals (20 B) and recomputes deb, s and t:
#   black level 1, debayer 54, Y 6, sharpen 18, blur 50, so 515.
# ssim_aux, per element of (B, 3, H, W): read x and y, write d/dy (12 B);
#   396 operations: x^2, y^2, xy 3; five fields of a vertical and a
#   horizontal 11-tap pass 220 (110 FMA); the map's terms A1 3, A2 4, D1 4,
#   D2 6, D1 D2 1, m 2, its three derivatives 13, the sum of m 1; three
#   adjoint blurs of two passes 132 (66 FMA); the combination at the pixel 7.
# The stem's kernels, per element of act (B, 64, H/2, W/2); x is 3/16 of an
# act element (0.75 B), the pooled plane 1/4 (1 B); operations count the
# 147 real taps (JAX's CostEstimate counts 192 padded slots):
# stem_conv_fwd: write act 4 B, read x 0.75 B; 147 FMA (294) and the
#   statistics' sum, square and sum (3).
# stem_bnpool: read act 4 B, write pooled 1 B; BN 2, ReLU 1, about 2 of
#   the window's 8 comparisons.
# stem_pool_bwd: read act 4 B and the pooled cotangent 1 B, write d_n 4 B;
#   BN and ReLU 3, about 2 comparisons of the argmax, at most 1 add of
#   the gather, the mask 1, xhat 2, the two sums 3.
# stem_conv_dw, stem_conv_dx: read act and d_n 8 B and x (or write d_x)
#   0.75 B; d_a 6, 147 FMA (294).
# The bfloat16 forms (``*_bf16``) store act, pooled, d_n and the pooled
# cotangent in 2 bytes (x and d_x stay float32) and do the same operations,
# bounded by the bfloat16 dense tensor-core peak.
KERNEL_COST = {"fused_isp_fwd": (16, 174), "fused_isp_fwd_train": (36, 174),
               "fused_isp_bwd_res": (40, 386), "fused_isp_bwd": (20, 515),
               "ssim_aux": (12, 396), "stem_conv_fwd": (4.75, 297),
               "stem_bnpool": (5, 5), "stem_pool_bwd": (9, 12),
               "stem_conv_dw": (8.75, 300), "stem_conv_dx": (8.75, 300),
               "stem_conv_fwd_bf16": (2.75, 297), "stem_bnpool_bf16": (2.5, 5),
               "stem_pool_bwd_bf16": (4.5, 12),
               "stem_conv_dw_bf16": (4.75, 300),
               "stem_conv_dx_bf16": (4.75, 300)}
STEM_KERNELS = ("stem_conv_fwd", "stem_bnpool", "stem_pool_bwd",
                "stem_conv_dw", "stem_conv_dx")
STEM_BF16 = tuple(f"{name}_bf16" for name in STEM_KERNELS)
# The TPU kernel each CUDA kernel replaces, and its source.
KERNELS = {
    "fused_isp_fwd": ("raw2logit_tpu/pallas/fused_isp.py:135",
                      "raw2logit_tpu_torch/csrc/fused_isp_fwd.cu"),
    "fused_isp_fwd_train": ("raw2logit_tpu/pallas/fused_isp.py:143",
                            "raw2logit_tpu_torch/csrc/fused_isp_fwd.cu"),
    "fused_isp_bwd_res": ("raw2logit_tpu/pallas/fused_isp_bwd.py:249",
                          "raw2logit_tpu_torch/csrc/fused_isp_bwd.cu"),
    "fused_isp_bwd": ("raw2logit_tpu/pallas/fused_isp_bwd.py:201",
                      "raw2logit_tpu_torch/csrc/fused_isp_bwd.cu"),
    "ssim_aux": ("raw2logit_tpu/pallas/ssim_aux.py:86",
                 "raw2logit_tpu_torch/csrc/ssim_aux.cu"),
    **{name: (f"raw2logit_tpu/pallas/stem.py:{line}",
              "raw2logit_tpu_torch/csrc/stem.cu")
       for names in (STEM_KERNELS, STEM_BF16)
       for name, line in zip(names, (142, 189, 231, 314, 348))},
}
# SSIM aux kernel vs its plain version: the value within SSIM_VALUE_REL
# of the float64 plain version (relative), or within SSIM_F64_FACTOR
# times the float32 plain version's own distance from it where that is
# larger (on the batch-normalised ISP pair the float32 plain value reads
# 1.8e-6 from float64 on the CPU at (2, 3, 40, 36): clipped regions are
# flat, where B11 - mu1^2 cancels against C2 = 9e-4); the gradient within
# SSIM_GRAD_REL of the float32 plain version (over its max |.|), and no
# further from the float64 plain version than SSIM_F64_FACTOR times the
# float32 plain version is.
SSIM_VALUE_REL, SSIM_GRAD_REL, SSIM_F64_FACTOR = 1e-6, 1e-5, 2.0
# B = 32 at 256x256, then shapes that cut the kernel's strips (at most
# 108 columns, all strips of a plane alike) raggedly: 250, 200 and 173
# wide (strips of 84, 100 and 87 columns), 67x45, and 5x7 and 7x200,
# lower than the 12 rows by which d/dy trails the input
SSIM_SHAPES = ((SERVE_BATCH, 3, SIZE, SIZE), (4, 3, 250, 250), (3, 3, 67, 45),
               (2, 3, 5, 7), (2, 3, 7, 200), (3, 3, 33, 173))
SSIM_WEIGHTS = (0.3, -1.0)
# The adversarial family of bench.py:88-99 (frozen ResNet-18, SSIM aux
# weight 0.3, lr 1e-3); the attacked ISP starts from the reference ISP
# perturbed by half the scale of ``processor``'s perturbation.
ADV_LR, ADV_AUX_WEIGHT, ADV_STEPS = 1e-3, 0.3, 5
# Stem kernels vs their plain versions on the same inputs: act within
# STEM_ACT_TOL of max |plain| (147-tap float32 sums in another order); the
# conv statistics and the pool backward's sums within STEM_SUM_TOL of the
# channel's sum of |terms| (float32 partial sums in another order); pooled
# and d_n bitwise (the same act, the same rounding, the same tie rule and
# order of the gather's sum); dW and d_x within STEM_GRAD_TOL of their
# scale (tests/test_stem_pallas.py:76-81) and no further from the float64
# plain version than STEM_F64_FACTOR times the float32 plain version is.
STEM_ACT_TOL, STEM_SUM_TOL, STEM_GRAD_TOL = 1e-5, 1e-5, 2e-4
STEM_F64_FACTOR = 2.0
# B = 256 and B = 32 at 256x256, then shapes that cut the tiles of every
# stem kernel raggedly: 68x44, 72x40 (H / 2 = 36 is a multiple of neither
# dW's 16-row nor d_x's 32-row tile), 4x8, and 100x140 (50 x 70 positions:
# three 16-row tiles of the conv forward and two rows more, two 32-column
# tiles and six columns more)
STEM_SHAPES = ((BIG_BATCH, 3, SIZE, SIZE), (SERVE_BATCH, 3, SIZE, SIZE),
               (3, 3, 68, 44), (2, 3, 72, 40), (1, 3, 4, 8),
               (2, 3, 100, 140))
# Device ms at B = 256 of the kernels redesigned for Hopper, as first
# ported (PERF.md's kernel table, this script on an H100 80GB HBM3 at
# 700 W): dW, d_x and the pool backward in the train step with the fused
# stem, the conv forward there and in serving with it, the SSIM aux kernel
# in the adversarial step, the residual ISP backward in the train step,
# the recompute ISP backward on its own, the serving ISP forward in
# serving and the training ISP forward in the train step; and the
# bfloat16 dW and d_x as first ported on FMA units, in the bfloat16 train
# step with the fused stem (the lower ends of PERF.md's rows 9b and 10b),
# and the bfloat16 conv forward and BN-pool as first ported (the <bf16>
# instances of the FMA kernels, rows 6b and 7b there)
FIRST_PORT_DEVICE_MS = {"stem_conv_dw": 5.3521, "stem_conv_dx": 7.8020,
                        "stem_conv_fwd": 3.2445, "ssim_aux": 2.7121,
                        "fused_isp_bwd_res": 2.1258, "fused_isp_bwd": 2.5632,
                        "stem_pool_bwd": 2.3177, "fused_isp_fwd": 0.4550,
                        "fused_isp_fwd_train": 0.5195,
                        "stem_conv_dw_bf16": 3.3849,
                        "stem_conv_dx_bf16": 3.3238,
                        "stem_conv_fwd_bf16": 2.2849,
                        "stem_bnpool_bf16": 0.7331}
# The ISP's output batch norm (isp/batchnorm.py) on the card, on the fused
# ISP's output at the train step's shapes, against nn.BatchNorm2d computed
# in float64 (the float32 nn.BatchNorm2d is not the yardstick: at B = 256
# its running mean read up to 8.6e-5 from float64 where the port's read
# 4e-8): output abs and input gradient over its max |.| as
# tests/test_torch_batchnorm.py holds them on the CPU (it says why);
# running statistics over their max |.|, one float32 update.
BN_Y_ATOL, BN_GRAD_REL, BN_STATS_REL = 1e-5, 1e-5, 1e-6
# The static ISP (static phases; no kernel of the port runs on its path):
# the nine pipelines of tests/test_isp.py:22-27, and TV-Chambolle and the
# bilateral filter behind the CLI's default debayer and sharpening, on the
# microscopy camera of SyntheticMicroscopy.
STATIC_PIPELINES = tuple(
    (d, s, n) for d in ("bilinear", "malvar2004", "menon2007")
    for s, n in (("sharpening_filter", "gaussian_denoising"),
                 ("unsharp_masking", "median_denoising"),
                 ("sharpening_filter", "fft_denoising"))) + (
    ("bilinear", "sharpening_filter", "tv_chambolle"),
    ("bilinear", "sharpening_filter", "bilateral"))
# The card's float32 run against the port's own float64 run on the CPU,
# abs: the demosaic stage and the pre-gamma (clipped) image at 2e-5; the
# final image at 5e-4 (tests/test_isp.py:37) plus what the gamma curve
# x^p, p = 1 / gamma, makes of the pixel's own pre-gamma difference d:
# the smaller of p min(a, b)^(p - 1) d (the mean value theorem: the
# slope is largest at the smaller value) and d^p (|a^p - b^p| <= |a - b|^p
# for p < 1), the second finite where the first is not, at a clipped 0.
# Near the clip floor a float32 rounding moves the output past 5e-4 (on
# the CPU, float32 against float64 at B = 32: 9.8e-4 after the FFT
# denoiser, 1.4e-3 after the bilateral filter, with pre-gamma differences
# below 5e-6).
STATIC_STAGE_TOL, STATIC_PRE_TOL, STATIC_FINAL_TOL = 2e-5, 2e-5, 5e-4
# The float64 witness of TV-Chambolle (200 iterations, most of the static
# gates' CPU time) runs on every STATIC_CHAMBOLLE_EVERY-th image of the
# batch, dark to bright: the filter works plane by plane, so a subset's
# result is the same rows of the batch's.
STATIC_CHAMBOLLE_EVERY = 4
# Menon's direction is the hard switch sum_v >= sum_h. Where float32 and
# float64 decide a near-tie differently, the demosaic moves by up to ~0.2
# at and around the site (the FFT denoiser spreads it along the row). So
# an image with a flipped site is left out of the Menon gates; every flip
# must be a near-tie, |sum_v - sum_h| <= MENON_TIE_REL (sum_v + sum_h) in
# float64, at most MENON_FLIP_SHARE of the sites may flip, and at least
# MENON_MIN_KEPT of the batch's images must stay in the gates.
MENON_TIE_REL, MENON_FLIP_SHARE, MENON_MIN_KEPT = 1e-5, 1e-5, 0.75
# The neural ISP (no kernel of the port on its path) in float32 on the
# card against the same module in float64 on the card, max |difference|
# over max |float64|: ten times what the port's CPU run reads at the same
# shape (B = 4, 256x256, 8.4e-7 in eval and 1.08e-6 in train mode,
# tests/test_torch_neural_isp.py); the identity ISP on the card against
# the CPU, abs.
NN_F64_REL, IDENTITY_TOL = 1e-5, 1e-7
# Segmentation (the CLI's segmenter: a resnet34 U-Net++, depth 5, decoder
# (256, 128, 64, 32, 16), one class, behind the drone ISP, on 256x256
# SyntheticRawSegmentation mosaics): the kernel path against the plain
# path at SEG_BATCH, then SEG_STEPS kernel-path steps at SERVE_BATCH. The
# two paths' IoU within SEG_IOU_TOL (a pixel whose probability crosses
# 0.5 moves it by 1 / union, about 2e-6 at B = 8), served masks within
# SEG_MASK_TOL abs; loss, U-Net++ gradients and running statistics as
# the classification step's (LOSS_TOL, CLF_GRAD_TOL, STATS_TOL).
SEG_BATCH, SEG_STEPS = 8, 3
SEG_IOU_TOL, SEG_MASK_TOL = 1e-4, 1e-4
# The steps timed: segmentation at B = 32 and at the largest batch that
# fits on the card (the train step peaks at 45 GiB at 128 and runs out
# of memory at 256, which fits with ``remat``; serving peaks near 41 GiB
# at 512, and 1024 would need about twice that); the neural and identity
# ISP steps (ResNet-18 as built behind them) at B = 32 and B = 256. At
# B = 32, the mean of 10 calls after 2 warm-ups and a profile of 2 more;
# above, where a call takes about a second, of BIG_ITERS calls after 1
# warm-up and a profile of 1.
SEG_TIMES = (("seg_train", SERVE_BATCH), ("seg_train", 128),
             ("seg_train_remat", BIG_BATCH), ("seg_serve", SERVE_BATCH),
             ("seg_serve", 512), ("neural_train", SERVE_BATCH),
             ("neural_train", BIG_BATCH), ("identity_train", SERVE_BATCH),
             ("identity_train", BIG_BATCH))
BIG_ITERS = 2
NN_BATCH = 4
# Evaluation (the corruption battery and the A/B and C tables; no kernel
# of the port on their path). Each transform but jpeg_compression (PIL,
# not on the card's machine) at EVAL_SEVERITIES on the card in float32
# against the port's float64 run on the CPU, on the same draws (float32,
# as JAX's): max abs difference within EVAL_TOL. The coordinates and the
# thresholded fields are float32 in both runs and the bodies sum in the
# same order, so what remains is float32 rounding of the values: the
# CPU's float32 run read 4.2e-7 at most (B = 4, 256x256) against float64;
# EVAL_TOL leaves ten times that for the card's convolutions. Spatter
# thresholds a gaussian-filtered float32 field, which the card's and the
# CPU's convolutions round differently: a near-tie may flip and move
# the pixels around it; at most EVAL_SPATTER_SITES of its (H, W) positions
# may differ by more. The identity cell program's logits (in graph, a
# seeded ResNet-18) on the card against the CPU in float64, abs:
# EVAL_LOGIT_TOL (LOGIT_TOL).
EVAL_SEVERITIES = (1, 3, 5)
EVAL_TRANSFORMS = tuple(n for n in CORRUPTIONS if n != "jpeg_compression")
EVAL_TOL, EVAL_SPATTER_SITES, EVAL_LOGIT_TOL = 1e-5, 64, LOGIT_TOL
EVAL_PIPELINE = ("bilinear", "sharpening_filter", "gaussian_denoising")
# The tables as a user pays for them: SyntheticMicroscopy at the
# Raw-Microscopy count (SURVEY.md:360), 256x256, the valid split of the
# CLI's --train_size 0.8 (188 images); ResNet-18 at full width, one fold;
# the CLI's batch (32) and 256; at 256 the A/B table's first EVAL_BIG_ROWS
# rows (each row's cells cost what they cost in the full table).
EVAL_N, EVAL_BATCHES, EVAL_BIG_ROWS = 940, (SERVE_BATCH, BIG_BATCH), 2


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def peaks(kind):
    for name, bw, ops, bf16_ops in PEAKS:
        if name in kind:
            return name, bw, ops, bf16_ops
    return "H100 (assumed)", 3.35e12, 67e12, 989e12


def bound(kind, n_pixels, kernel="fused_isp_fwd"):
    """Least time (ms) and what bounds it for ``kernel`` on n pixels (n
    elements of (B, 3, H, W) for ssim_aux); a bfloat16 form's operations
    at the bfloat16 tensor-core peak."""
    _, bw, ops, bf16_ops = peaks(kind)
    if kernel in STEM_BF16:
        ops = bf16_ops
    bytes_pp, ops_pp = KERNEL_COST[kernel]
    t_bytes = n_pixels * bytes_pp / bw * 1e3
    t_ops = n_pixels * ops_pp / ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# The PyTorch call timed beside a kernel as its nearest yardstick (times
# phase); the port calls none of them.
LIBRARY_CALLS = {
    "stem_conv_fwd": "nearest cuDNN call (F.conv2d), without the BN "
                     "statistics",
    "stem_pool_bwd": "nearest call (aten.max_pool2d_with_indices_backward, "
                     "indices computed outside the timed window), without "
                     "the BN fold, the ReLU mask or the sums",
    "stem_conv_dw": "nearest cuDNN call (aten.convolution_backward), "
                    "without the BN fold",
    "stem_conv_dx": "nearest cuDNN call (aten.convolution_backward), "
                    "without the BN fold"}
LIBRARY_CALLS.update({f"{name}_bf16": f"{call}, in bfloat16"
                      for name, call in list(LIBRARY_CALLS.items())})

STEM_WRAPPERS = dict(zip(STEM_KERNELS, (stem_conv, stem_bnpool, stem_pool_bwd,
                                        stem_conv_dw, stem_conv_dx)))


def reset_counts():
    fused_isp.launches = fused_isp_train.launches = 0
    fused_isp_bwd.launches = fused_isp_bwd.launches_res = 0
    ssim_aux_value_grad.launches = 0
    for fn in STEM_WRAPPERS.values():
        fn.launches = fn.launches_bf16 = 0


def counts():
    """Launches of each kernel since ``reset_counts`` (the stem's bfloat16
    forms under ``<kernel>_bf16``)."""
    return {"fused_isp_fwd": fused_isp.launches,
            "fused_isp_fwd_train": fused_isp_train.launches,
            "fused_isp_bwd_res": fused_isp_bwd.launches_res,
            "fused_isp_bwd": fused_isp_bwd.launches,
            "ssim_aux": ssim_aux_value_grad.launches,
            **{name: fn.launches for name, fn in STEM_WRAPPERS.items()},
            **{f"{name}_bf16": fn.launches_bf16
               for name, fn in STEM_WRAPPERS.items()}}


def launches(fwd=0, fwd_train=0, bwd_res=0, bwd=0, ssim=0, stem_fwd=0,
             stem_bwd=0, bf16_fwd=0, bf16_bwd=0):
    """An expected ``counts()``: ``stem_fwd`` launches of each forward stem
    kernel, ``stem_bwd`` of each backward one, and ``bf16_fwd``,
    ``bf16_bwd`` of their bfloat16 forms."""
    return {"fused_isp_fwd": fwd, "fused_isp_fwd_train": fwd_train,
            "fused_isp_bwd_res": bwd_res, "fused_isp_bwd": bwd,
            "ssim_aux": ssim,
            **{name: stem_fwd if i < 2 else stem_bwd
               for i, name in enumerate(STEM_KERNELS)},
            **{name: bf16_fwd if i < 2 else bf16_bwd
               for i, name in enumerate(STEM_BF16)}}


def routed_stem(seen):
    """``seen`` with the float32 stem kernels' counts set to 0, for a flow
    whose classifier the CLI or the evaluation built (``stem_kernel`` left
    to route by the input, so that its 256x256 batches on the card run the
    fused stem); raises unless those counts are whole fused stems: at
    least one forward, as many BN-pools as convs, no more pool backwards
    than forwards, no more d_x or dW launches than pool backwards, and no
    bfloat16 form."""
    conv, bnpool, pool_bwd, dw, dx = (seen[n] for n in STEM_KERNELS)
    check(0 < conv == bnpool >= pool_bwd >= max(dw, dx)
          and not any(seen[n] for n in STEM_BF16),
          f"the routed stem's launches {seen}")
    return dict(seen, **{n: 0 for n in STEM_KERNELS})


def processor(device, use_kernel, camera=MICROSCOPY_CAMERA_PARAMS,
              seed=SEED):
    """ISP with seeded perturbations: non-symmetric filters, cross-channel
    debayer taps, and non-trivial BN running statistics."""
    rng = np.random.default_rng(seed)
    proc = ParametrizedProcessing(
        camera_parameters=camera, batch_norm_output=True,
        use_kernel=use_kernel, device=device)
    scale = {"black_level": 2e-3, "white_balance": 0.05,
             "colour_correction": 0.05, "gamma_correct": 0.1,
             "sharpening_filter.weight": 0.05, "gaussian_blur.weight": 0.01,
             "debayer.weight": 0.05}
    with torch.no_grad():
        for name, p in proc.named_parameters():
            p.add_(torch.as_tensor(rng.normal(0.0, scale[name], p.shape),
                                   dtype=torch.float32, device=device))
        proc.batch_norm.running_mean.copy_(torch.as_tensor(
            rng.uniform(0.2, 0.6, 3)))
        proc.batch_norm.running_var.copy_(torch.as_tensor(
            rng.uniform(0.02, 0.1, 3)))
    return proc.eval()


def classifier(device, seed=SEED):
    """Full-width ResNet-18, seeded init on the device, with its BN scales
    and statistics perturbed so that every conv reaches the logits. Its
    stem is the plain (cuDNN) one, which the phases built on it measure
    or compare; those that time the fused stem set ``stem_kernel``."""
    gen = torch.Generator(device).manual_seed(seed)
    clf = resnet_model("resnet18", fc_out_features=9, device=device,
                       generator=gen, stem_kernel=False)
    return perturb_bns(clf, gen).eval()


@torch.no_grad()
def perturb_bns(module, gen):
    """Every affine batch norm of ``module`` with scales U(0.5, 1), biases
    and running means N(0, 0.1) and running variances U(0.5, 2) from
    ``gen``; returns ``module``."""
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d) and m.affine:
            m.weight.uniform_(0.5, 1.0, generator=gen)
            m.bias.normal_(0.0, 0.1, generator=gen)
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 2.0, generator=gen)
    return module


def test_mosaics(shape, seed=SEED):
    """Noise and smooth mosaics at exposures from dark to bright: with the
    microscopy white balance (a negative red gain) outputs reach both clip
    bounds."""
    b, h, w = shape
    rng = np.random.default_rng((seed, b, h, w))
    raw = rng.uniform(0.0, 1.0, size=shape)
    ds = SyntheticRawClassification(n=b, h=h, w=w, seed=seed)
    for i in range(1, b, 2):
        raw[i] = ds[i][0]
    # exposures from dark to bright, so that most pixels are off the clips
    raw *= np.linspace(0.05, 1.0, b)[:, None, None]
    return torch.as_tensor(raw, dtype=torch.float32)


def smooth_mosaics(shape, seed=SEED):
    """Mosaics smoothed by a 7x7 box filter into [0.25, 0.75], as
    tests/test_pallas.py:123-125 does, at exposures from 0.05 to 0.4: few
    pixels land near the clip floor, and with either camera some images
    stay inside both clips."""
    rng = np.random.default_rng((seed, 7) + tuple(shape))
    raw = torch.as_tensor(rng.uniform(0.0, 1.0, shape), dtype=torch.float32)
    x = torch.nn.functional.avg_pool2d(torch.nn.functional.pad(
        raw[:, None], (3, 3, 3, 3), mode="reflect"), 7, stride=1)[:, 0]
    x = 0.25 + 0.5 * (x - x.min()) / (x.max() - x.min() + 1e-9)
    return x * torch.linspace(0.05, 0.4, shape[0])[:, None, None]


def max_rel(got, want, floor=1e-30):
    """max |got - want| / max(max |want|, floor)."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 floor)


def witness(x, params, g):
    """The plain backward computed in float64 from the same float32
    inputs: (d_raw, {name: gradient}), both float64."""
    d, scal = fused_isp_bwd_reference(x, params, g, torch.float64)
    return d, unpack_grads(scal, {k: v.detach().double()
                                  for k, v in params.items()})


def witness_err(d_raw, grads, wit, scale):
    """Distance of a backward from the float64 witness: max |d_raw error|
    over ``scale``, and the largest max-relative parameter error."""
    d_64, grads_64 = wit
    return {"d_raw_max_abs_err_over_scale":
            float((d_raw.double() - d_64).abs().max()) / scale,
            "param_max_rel_err": max(max_rel(grads[k].double(), grads_64[k],
                                             1e-3) for k in grads_64)}


def bwd_agreement(run, plain, wit, tight):
    """A backward ``run`` = (d_raw, grads) against the float32 plain
    version under the contract (BWD_*), and its distance from the float64
    witness beside the plain version's own; with ``tight`` the tight
    limits (BWD_TIGHT_DRAW, BWD_F64_PARAM) must hold too. Returns
    (statistics, whether they hold)."""
    (d_raw, grads), (d_ref, grads_ref) = run, plain
    scale = float(d_ref.abs().max())
    check(scale > 0, "the backward's input has pixels inside the clips")
    err = (d_raw - d_ref).abs()
    stats = {
        "d_raw_scale": scale, "d_raw_max_abs_err": float(err.max()),
        "d_raw_median_err_over_scale": float(err.median()) / scale,
        "d_raw_outlier_share": float((err > BWD_OUTLIER * scale)
                                     .float().mean()),
        "param_max_rel_err": {k: max_rel(grads[k], grads_ref[k], 1e-3)
                              for k in grads_ref},
        "vs_float64": witness_err(d_raw, grads, wit, scale),
        "plain_vs_float64": witness_err(d_ref, grads_ref, wit, scale)}
    ok = (stats["d_raw_median_err_over_scale"] < BWD_MEDIAN
          and stats["d_raw_outlier_share"] < BWD_OUTLIER_SHARE
          and max(stats["param_max_rel_err"].values()) < BWD_PARAM)
    if tight:
        ok = (ok and stats["d_raw_max_abs_err"] <= BWD_TIGHT_DRAW * scale
              and stats["vs_float64"]["param_max_rel_err"] <= max(
                  BWD_F64_PARAM,
                  2 * stats["plain_vs_float64"]["param_max_rel_err"]))
    return stats, ok


def bn_cotangent(o, seed=SEED):
    """The cotangent that a training-mode output batch norm hands the ISP:
    its backward of a seeded normal upstream gradient. It has zero mean
    per channel, so the parameter gradients are sums that cancel."""
    gen = torch.Generator(o.device).manual_seed(seed)
    up = torch.randn(o.shape, device=o.device, generator=gen)
    x = o.detach().requires_grad_(True)
    with torch.enable_grad():
        out = torch.nn.functional.batch_norm(x, None, None, training=True,
                                             eps=1e-5)
        (g,) = torch.autograd.grad(out, x, up)
    return g.contiguous()


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "peaks": peaks(kind)[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return smi, kind


SOURCES = ("fused_isp_fwd", "fused_isp_bwd", "ssim_aux", "stem")


def phase_build():
    """Compile the four sources in parallel, then the tile store's C++
    (``data/tilestore.py``, the host compiler); print nvcc's register and
    spill report and each kernel's registers and CTAs per SM."""
    t0 = time.perf_counter()
    report = build(list(SOURCES))
    seconds = time.perf_counter() - t0
    store_lib = tilestore.load_library()._name
    emit({"phase": "build", "seconds": seconds, "compiled": report,
          "tilestore": {"seconds": time.perf_counter() - t0 - seconds,
                        "library": os.path.relpath(store_lib, REPO)},
          "occupancy": [k for name in SOURCES for k in kernel_info(name)]})


def kernel_tolerance(plain, gamma):
    """Per-pixel tolerance of the fused kernel against its plain version
    (see KERNEL_TOL)."""
    v = plain.double().pow(gamma).clamp_min(1e-5)
    return KERNEL_TOL + LIN_TOL * plain.double() / (gamma * v)


def phase_kernel_vs_plain(device, shapes=CHECK_SHAPES):
    """Kernel vs plain version for two cameras; returns the largest
    |kernel - plain|."""
    worst = 0.0
    for cam_name, camera in (("mild", MILD_CAMERA),
                             ("microscopy", MICROSCOPY_CAMERA_PARAMS)):
        proc = processor(device, use_kernel=True, camera=camera)
        params = proc.kernel_params()
        gamma = float(proc.gamma_correct.detach())
        floor = float(np.exp(np.log(np.float32(1e-5)) / gamma))
        for shape in shapes:
            raw = test_mosaics(shape).to(device)
            with torch.no_grad():
                got = fused_isp(raw, params)
                want = fused_isp_reference(raw, params)
            torch.cuda.synchronize()
            check(got.shape == (shape[0], 3) + shape[1:], f"shape {shape}")
            check(bool(torch.isfinite(got).all()), f"finite {shape}")
            diff = (got - want).abs()
            ratio = diff.double() / kernel_tolerance(want, gamma)
            err, worst_ratio = float(diff.max()), float(ratio.max())
            at = np.unravel_index(int(diff.argmax()), diff.shape)
            off_floor = want > 0.3  # slope < 1.5 there
            frac_floor = float((want <= floor * (1 + 1e-5)).float().mean())
            frac_one = float((want >= 1.0).float().mean())
            emit({"phase": "kernel_vs_plain", "camera": cam_name,
                  "shape": list(shape), "max_abs_err": err,
                  "worst_at": [int(i) for i in at],
                  "plain_at_worst": float(want[at]),
                  "max_abs_err_off_floor": float(diff[off_floor].max()),
                  "max_err_over_tol": worst_ratio,
                  "frac_at_clip_floor": frac_floor, "frac_at_one": frac_one})
            check(frac_floor > 0 and frac_one > 0, "inputs reach both clips")
            check(worst_ratio <= 1.0, f"{cam_name} {shape}: kernel vs plain "
                                      f"{worst_ratio} x the tolerance")
            worst = max(worst, err)
    return worst


def phase_train_kernels_vs_plain(device, shapes=CHECK_SHAPES):
    """The training forward and both backward variants against their plain
    versions, for two cameras. Returns the largest |kernel - plain| of
    each: the forward's RGB, and d_raw on the smooth inputs."""
    worst = dict.fromkeys(("fused_isp_fwd_train", "fused_isp_bwd_res",
                           "fused_isp_bwd"), 0.0)
    for cam_name, camera in (("mild", MILD_CAMERA),
                             ("microscopy", MICROSCOPY_CAMERA_PARAMS)):
        proc = processor(device, use_kernel=True, camera=camera)
        params = proc.kernel_params()
        gamma = float(proc.gamma_correct.detach())
        floor = float(np.exp(np.log(np.float32(1e-5)) / gamma))
        for shape in shapes:
            raw = test_mosaics(shape).to(device)
            with torch.no_grad():
                out, res = fused_isp_train(raw, params)
                served = fused_isp(raw, params)
                want, want_res = fused_isp_train_reference(raw, params)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            ratio = float(((out - want).abs().double()
                           / kernel_tolerance(want, gamma)).max())
            res_err = [float((res[:, k] - want_res[:, k]).abs().max())
                       for k in range(5)]
            emit({"phase": "train_kernels_vs_plain", "kernel":
                  "fused_isp_fwd_train", "camera": cam_name,
                  "shape": list(shape), "max_abs_err": err,
                  "max_err_over_tol": ratio,
                  "res_max_abs_err_deb0_deb1_deb2_s_t": res_err,
                  "bitwise_equal_to_serving": bool(torch.equal(out, served))})
            check(torch.equal(out, served), "training forward's RGB equals "
                                            "the serving kernel's bitwise")
            check(ratio <= 1.0, f"{cam_name} {shape}: training forward vs "
                                f"plain {ratio} x the tolerance")
            check(max(res_err) <= RES_TOL, f"residuals vs plain {res_err}")
            worst["fused_isp_fwd_train"] = max(
                worst["fused_isp_fwd_train"], err)
            for inputs, x in (("noisy", raw),
                              ("smooth", smooth_mosaics(shape).to(device))):
                with torch.no_grad():
                    o, r = fused_isp_train(x, params)
                frac_floor = float((o <= floor * (1 + 1e-5)).float().mean())
                for cot, g in (("positive", (o * 0.5 + 0.1).contiguous()),
                               ("bn_backward", bn_cotangent(o))):
                    with torch.no_grad():
                        runs = {"res": fused_isp_bwd(x, params, g, r),
                                "recompute": fused_isp_bwd(x, params, g),
                                "res_again": fused_isp_bwd(x, params, g, r)}
                    d_ref, scal = fused_isp_bwd_reference(x, params, g)
                    plain = d_ref, unpack_grads(scal, params)
                    wit = witness(x, params, g)
                    torch.cuda.synchronize()
                    for variant, name in (("res", "fused_isp_bwd_res"),
                                          ("recompute", "fused_isp_bwd")):
                        stats, ok = bwd_agreement(runs[variant], plain, wit,
                                                  tight=inputs == "smooth")
                        emit({"phase": "train_kernels_vs_plain",
                              "kernel": name, "camera": cam_name,
                              "shape": list(shape), "inputs": inputs,
                              "cotangent": cot,
                              "frac_at_clip_floor": frac_floor, **stats})
                        check(ok, f"{name} {cam_name} {shape} {inputs} "
                                  f"{cot}: backward vs plain {stats}")
                        if inputs == "smooth":
                            worst[name] = max(worst[name],
                                              stats["d_raw_max_abs_err"])
                    (d_a, g_a), (d_b, g_b), (d_c, g_c) = (
                        runs["res"], runs["recompute"], runs["res_again"])
                    variant_err = max([float((d_a - d_b).abs().max())] + [
                        float((g_a[k] - g_b[k]).abs().max()) for k in g_a])
                    same = torch.equal(d_a, d_c) and all(
                        torch.equal(g_a[k], g_c[k]) for k in g_a)
                    emit({"phase": "train_kernels_vs_plain",
                          "camera": cam_name, "shape": list(shape),
                          "inputs": inputs, "cotangent": cot,
                          "res_vs_recompute_max_abs": variant_err,
                          "res_run_to_run_identical": same})
                    check(variant_err <= VARIANT_TOL, f"backward variants "
                                                      f"differ by "
                                                      f"{variant_err}")
                    check(same, "two launches of the residual backward give "
                                "identical gradients")
    return worst


def train_classifier(device, setup="as_built", seed=SEED):
    """Full-width ResNet-18 with 9 classes, seeded on the device:
    ``as_built`` is ``resnet_model``'s init, where the last batch norm of
    every block starts at zero scale (so the first step's gradient skips
    most residual branches); ``perturbed`` is ``classifier``, where every
    conv reaches the logits. Both on the plain stem, as ``classifier``."""
    if setup == "perturbed":
        return classifier(device, seed).train()
    return resnet_model("resnet18", fc_out_features=9, device=device,
                        generator=torch.Generator(device).manual_seed(seed),
                        stem_kernel=False)


def labelled_mosaics(device, batch, size=SIZE, seed=SEED):
    """``batch`` synthetic mosaics and their labels, on the device."""
    ds = SyntheticRawClassification(n=batch, h=size, w=size, seed=seed)
    raw = torch.as_tensor(np.stack([ds[i][0] for i in range(batch)]),
                          dtype=torch.float32, device=device)
    y = torch.as_tensor([ds[i][1] for i in range(batch)], device=device)
    return raw, y


def train_setup(device, batch, size=SIZE):
    """Full-width train inputs: labelled synthetic mosaics on the device,
    the perturbed microscopy ISP (fused-kernel path, BN output) and the
    ResNet-18 as built."""
    raw, y = labelled_mosaics(device, batch, size)
    proc = processor(device, use_kernel=True).train()
    return raw, y, proc, train_classifier(device)


def train_copy(cfg, proc, clf, use_kernel=True, dtype=torch.float32):
    """Deep copies of the modules, in ``dtype``, with their train state
    and step."""
    p, c = copy.deepcopy(proc).to(dtype), copy.deepcopy(clf).to(dtype)
    p.use_kernel = use_kernel
    return p, c, create_train_state(cfg, p, c), make_train_step(cfg, p, c)


def capture_cotangent(p):
    """A dict that each step of processor ``p`` fills with the cotangent
    of the ISP's output (the output batch norm's input) under "g"."""
    seen = {}

    def hook(module, args):
        if args[0].requires_grad:
            args[0].register_hook(lambda g: seen.__setitem__("g", g))
    p.batch_norm.register_forward_pre_hook(hook)
    return seen


def grads_and_stats(p, c):
    """ISP gradients, classifier gradients, BN running statistics."""
    return ({n: t.grad for n, t in p.named_parameters()},
            {n: t.grad for n, t in c.named_parameters()},
            {f"{m}.{n}": b for m, mod in (("isp", p), ("clf", c))
             for n, b in mod.named_buffers() if "running" in n})


def step_agreement(run, ref):
    """Train-step agreement of ``run`` with ``ref`` (each
    ``(grads_and_stats, loss)``): loss, ISP gradients per parameter,
    classifier gradients as one vector and its worst tensor, running
    statistics."""
    (isp_g, clf_g, stats), loss = run
    (isp_r, clf_r, stats_r), loss_r = ref
    names = list(clf_g)
    flat = torch.cat([clf_g[n].flatten().double() for n in names])
    flat_r = torch.cat([clf_r[n].flatten().double() for n in names])
    worst = max((max_rel(clf_g[n].double(), clf_r[n].double()), n)
                for n in names)
    return {"loss_abs_err": abs(loss - loss_r),
            "isp_grad_max_rel_err": {
                n: max_rel(isp_g[n].double(), isp_r[n].double(), 1e-3)
                for n in isp_g},
            "clf_grad_max_rel_err": max_rel(flat, flat_r),
            "clf_worst_tensor": [worst[1], worst[0]],
            "running_stats_max_rel_err": max(
                max_rel(stats[n].double(), stats_r[n].double())
                for n in stats)}


def phase_train(device, batch=SERVE_BATCH, steps=TRAIN_STEPS,
                setups=CLF_SETUPS, seeds=TRAIN_SEEDS):
    """Train steps through the kernel path against the plain path from
    identical weights; then ``steps`` kernel-path steps; then the
    recompute backward as its users call it. Returns the launch counts
    of the ``steps`` steps and of the recompute backward.

    Each comparison runs the kernel path, the plain path twice, the plain
    path on its input times 1 + 1e-7 N(0, 1) (``nudged``) and the plain
    path in float64 (the witness), for each classifier of ``setups``, each
    seed of ``seeds`` and two exposures: the synthetic mosaics as they
    are, where many outputs of the ISP sit at 1 and some at the clip
    floor, and the same mosaics at ``INSIDE_CLIPS``, where every output
    lies inside the clips.

    A float32 train step is ill-conditioned: the kernel and plain forwards
    differ by float32 rounding (KERNEL_TOL), and the classifier's backward
    amplifies such differences in the cotangent it hands the ISP, the
    more so when every residual branch carries gradient (``perturbed``).
    So the phase holds the kernels where they act alone: the kernel step's
    ISP gradients against the float64 plain backward on the cotangent that
    step gave its ISP (as BWD_F64_PARAM inside the clips, BWD_PARAM where
    clips are reached). It holds the kernel step against the float64 step
    no further than the float32 plain path lands itself (STEP_F64_FACTOR),
    for every classifier, as well as the loss and running statistics
    against the plain path. The ISP gradients (BWD_PARAM, the TPU
    kernel's contract) and the classifier gradients (CLF_GRAD_TOL, as one
    vector) of the two paths are held to each other only for the
    classifier as built, where the step is well-conditioned: with
    perturbed batch norms the nudge alone moves them further (printed as
    ``spread``)."""
    raw, y, proc, clf = train_setup(device, batch)
    params = proc.kernel_params()
    gamma = float(proc.gamma_correct.detach())
    cfg = TrainConfig(lr=TRAIN_LR)
    main_cotangent = None
    for setup in setups:
        for seed in seeds:
            net = clf if (setup, seed) == ("as_built", SEED) else \
                train_classifier(device, setup, seed)
            gen = torch.Generator(device).manual_seed(seed)
            for inputs, x in (("synthetic", raw),
                              ("inside_clips", raw * INSIDE_CLIPS[0]
                               + INSIDE_CLIPS[1])):
                nudged = x * (1 + 1e-7 * torch.randn(
                    x.shape, device=device, generator=gen))
                with torch.no_grad():
                    rgb = fused_isp(x, params)
                shares = {"frac_at_one": float((rgb >= 1.0).float().mean()),
                          "frac_at_clip_floor": float(
                              (rgb <= np.exp(np.log(1e-5) / gamma)
                               * (1 + 1e-5)).float().mean())}
                check(inputs != "inside_clips" or not any(shares.values()),
                      f"every output inside the clips {shares}")
                runs = {}
                for name, use_kernel, x_in, dtype in (
                        ("kernel", True, x, torch.float32),
                        ("plain", False, x, torch.float32),
                        ("plain_again", False, x, torch.float32),
                        ("nudged", False, nudged, torch.float32),
                        ("float64", False, x, torch.float64)):
                    p, c, state, step = train_copy(cfg, proc, net,
                                                   use_kernel, dtype)
                    seen = capture_cotangent(p)
                    loss = float(step(state, x_in.to(dtype), y)["loss"])
                    runs[name] = grads_and_stats(p, c), loss
                    if name == "kernel":
                        g = seen["g"]
                _, grads_64 = witness(x, params, g)
                _, scal = fused_isp_bwd_reference(x, params, g)
                plain_bwd = unpack_grads(scal, params)
                isp_k = runs["kernel"][0][0]
                same_cot = {
                    "kernel_step": max(max_rel(isp_k[ISP_NAMES[k]].double(),
                                               grads_64[k], 1e-3)
                                       for k in grads_64),
                    "plain_bwd_f32": max(max_rel(plain_bwd[k].double(),
                                                 grads_64[k], 1e-3)
                                         for k in grads_64)}
                agree = step_agreement(runs["kernel"], runs["plain"])
                vs_f64 = {name: step_agreement(runs[name], runs["float64"])
                          for name in ("kernel", "plain", "plain_again",
                                       "nudged")}
                f64_errs = {name: (max(v["isp_grad_max_rel_err"].values()),
                                   v["clf_grad_max_rel_err"])
                            for name, v in vs_f64.items()}
                emit({"phase": "train_step_vs_plain", "classifier": setup,
                      "seed": seed, "inputs": inputs, **shares,
                      "batch": batch, "loss": runs["kernel"][1],
                      "loss_plain": runs["plain"][1], **agree,
                      "spread": {
                          name: step_agreement(runs[name], runs["plain"])
                          for name in ("plain_again", "nudged")},
                      "vs_float64": {
                          name: {"isp": f64_errs[name][0],
                                 "clf": f64_errs[name][1],
                                 "loss": v["loss_abs_err"]}
                          for name, v in vs_f64.items()},
                      "isp_grads_vs_float64_bwd_same_cotangent": same_cot,
                      "cotangent_abs_max": float(g.abs().max()),
                      "cotangent_channel_mean_over_abs_mean": [
                          float(g[:, ch].mean() / g[:, ch].abs().mean())
                          for ch in range(3)]})
                tag = f"{setup} seed {seed} {inputs}"
                check(agree["loss_abs_err"] <= LOSS_TOL, f"{tag}: loss")
                check(agree["running_stats_max_rel_err"] <= STATS_TOL,
                      f"{tag}: running statistics "
                      f"{agree['running_stats_max_rel_err']}")
                limit = (max(BWD_F64_PARAM, 2 * same_cot["plain_bwd_f32"])
                         if inputs == "inside_clips" else BWD_PARAM)
                check(same_cot["kernel_step"] <= limit,
                      f"{tag}: the kernel step's ISP gradients vs the "
                      f"float64 backward on its cotangent {same_cot}")
                k_isp, k_clf = f64_errs["kernel"]
                far_isp = max(f64_errs[n][0] for n in ("plain", "nudged"))
                far_clf = max(f64_errs[n][1] for n in ("plain", "nudged"))
                check(k_isp <= max(BWD_PARAM, STEP_F64_FACTOR * far_isp)
                      and k_clf <= max(CLF_GRAD_TOL,
                                       STEP_F64_FACTOR * far_clf),
                      f"{tag}: kernel step vs the float64 step (ISP, "
                      f"classifier) {f64_errs}")
                if setup == "as_built":
                    check(max(agree["isp_grad_max_rel_err"].values())
                          <= BWD_PARAM,
                          f"{tag}: ISP gradients "
                          f"{agree['isp_grad_max_rel_err']}")
                    check(agree["clf_grad_max_rel_err"] <= CLF_GRAD_TOL,
                          f"{tag}: classifier gradients "
                          f"{agree['clf_grad_max_rel_err']}")
                if (setup, seed, inputs) == ("as_built", SEED, "synthetic"):
                    main_cotangent = g, isp_k
                del runs, g, grads_64

    p, c, state, step = train_copy(cfg, proc, clf)
    before = {n: t.detach().clone() for n, t in p.named_parameters()}
    reset_counts()
    t0 = time.perf_counter()
    losses = [step(state, raw, y)["loss"] for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    main = counts()
    losses = [float(v) for v in losses]
    moved = {n: not torch.equal(before[n], t) for n, t in
             p.named_parameters()}
    emit({"phase": "train", "batch": batch, "steps": steps,
          "seconds": seconds, "losses": losses, "isp_params_moved": moved,
          "launches": main})
    check(all(np.isfinite(losses)), "finite losses")
    check(all(moved.values()), f"every ISP parameter moved {moved}")
    check(main == launches(fwd_train=steps, bwd_res=steps),
          f"main-path launches {main}")

    # The recompute backward (no training path runs it, as in the JAX
    # package): fused_isp_bwd without residuals on the main path's batch
    # and the cotangent its first step gave the ISP. Its gradients are the
    # residual backward's of that step.
    g, isp_k = main_cotangent
    reset_counts()
    d_raw, grads = fused_isp_bwd(raw, params, g)
    torch.cuda.synchronize()
    recompute = counts()
    diff = max(float((grads[k] - isp_k[ISP_NAMES[k]]).abs().max())
               for k in grads)
    emit({"phase": "isp_backward_recompute", "batch": batch,
          "launches": recompute, "vs_train_step_max_abs": diff})
    check(recompute == launches(bwd=1),
          f"recompute-path launches {recompute}")
    check(bool(torch.isfinite(d_raw).all()) and d_raw.shape == raw.shape,
          "finite d_raw of the input's shape")
    check(diff <= VARIANT_TOL, f"recompute backward vs the train step's "
                               f"ISP gradients {diff}")
    return main, recompute


def bn_like_pair(shape, seed=SEED):
    """Random images like batch-normalised ISP outputs (mean 0, std 1)
    with a flat patch near zero in both, where D1 D2 is small."""
    gen = torch.Generator().manual_seed(seed)
    ref = torch.randn(shape, generator=gen)
    x = ref + 0.3 * torch.randn(shape, generator=gen)
    h, w = max(1, shape[2] // 4), max(1, shape[3] // 4)
    ref[:, :, :h, :w] = 0.01
    x[:, :, :h, :w] = 0.012
    return ref, x


def isp_pair(device, shape):
    """The batch-normalised (batch statistics) outputs of the default and
    of a perturbed microscopy ISP on the same mosaics: the pair the
    adversarial step hands the SSIM aux kernel."""
    b, _, h, w = shape
    raw = test_mosaics((b, h, w)).to(device)
    default = ParametrizedProcessing(
        camera_parameters=MICROSCOPY_CAMERA_PARAMS, device=device)
    with torch.no_grad():
        return (default.train()(raw)[0].contiguous(),
                processor(device, use_kernel=False).train()(raw)[0]
                .contiguous())


def ssim_agreement(ref, x, weight, vs_plain=True):
    """The SSIM aux kernel on (ref, x) against the float32 and float64
    plain versions and against a second launch: (statistics, whether they
    hold the SSIM_* limits). ``vs_plain=False`` leaves out the gradient's
    limit against the float32 plain version and keeps the float64
    witness's (where float32 itself is far from float64, as on an ISP
    output with large clipped regions)."""
    value, d_x = ssim_aux_value_grad(ref, x, weight)
    value2, d_x2 = ssim_aux_value_grad(ref, x, weight)
    p_value, p_dx = ssim_aux_reference(ref, x, weight)
    w_value, w_dx = ssim_aux_reference(ref, x, weight, torch.float64)
    torch.cuda.synchronize()
    scale = float(p_dx.abs().max())
    stats = {"value": float(value),
             "value_rel_err_vs_float64": abs(float(value) - float(w_value))
             / abs(float(w_value)),
             "plain_value_rel_err_vs_float64": abs(
                 float(p_value) - float(w_value)) / abs(float(w_value)),
             "grad_scale": scale,
             "grad_max_abs_err": float((d_x - p_dx).abs().max()),
             "grad_vs_float64": float((d_x.double() - w_dx).abs().max()),
             "plain_grad_vs_float64": float((p_dx.double() - w_dx).abs()
                                            .max()),
             "bitwise_repeat": bool(torch.equal(d_x, d_x2)
                                    and torch.equal(value, value2))}
    ok = (bool(torch.isfinite(d_x).all())
          and stats["value_rel_err_vs_float64"] <= max(
              SSIM_VALUE_REL,
              SSIM_F64_FACTOR * stats["plain_value_rel_err_vs_float64"])
          and (not vs_plain
               or stats["grad_max_abs_err"] <= SSIM_GRAD_REL * scale)
          and stats["grad_vs_float64"] <= SSIM_F64_FACTOR
          * stats["plain_grad_vs_float64"]
          and stats["bitwise_repeat"])
    return stats, ok


def phase_ssim_kernel_vs_plain(device, shapes=SSIM_SHAPES,
                               weights=SSIM_WEIGHTS):
    """The SSIM aux kernel against its plain version on the ISP pair and
    on random images with flat patches; returns the largest |kernel -
    plain| of the gradient."""
    worst = 0.0
    for shape in shapes:
        pairs = {"isp_pair": isp_pair(device, shape),
                 "flat_patches": tuple(t.to(device)
                                       for t in bn_like_pair(shape))}
        for inputs, (ref, x) in pairs.items():
            for weight in weights:
                stats, ok = ssim_agreement(ref, x, weight)
                emit({"phase": "ssim_kernel_vs_plain", "shape": list(shape),
                      "inputs": inputs, "weight": weight, **stats})
                check(ok, f"ssim_aux {shape} {inputs} {weight}: {stats}")
                worst = max(worst, stats["grad_max_abs_err"])
        del pairs
    return worst


def adv_config(target="all"):
    return TrainConfig(lr=ADV_LR, adv_training=True, freeze_classifier=True,
                       loss_weight=-1.0, adv_aux_loss="ssim",
                       adv_aux_weight=ADV_AUX_WEIGHT, adv_parameters=target)


def adv_copy(cfg, proc, clf, use_kernel=True, seed=SEED + 1):
    """Deep copies of the reference ISP and the classifier, their
    adversarial state (the reference is the ISP as copied), and the step;
    then the attacked ISP is the reference perturbed with ``seed``."""
    p, c = copy.deepcopy(proc), copy.deepcopy(clf)
    p.use_kernel = use_kernel
    state = create_train_state(cfg, p, c)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in p.parameters():
            t.add_(torch.as_tensor(rng.normal(0.0, 0.02, t.shape),
                                   dtype=torch.float32, device=t.device))
    return p, c, state, make_train_step(cfg, p, c)


def adv_setup(device, batch, size=SIZE, noise_layer=False):
    """The adversarial step's inputs: labelled synthetic mosaics, the
    perturbed microscopy ISP (kernel path, BN output; optionally with the
    noise layer) as the reference, and the ResNet-18 as built, frozen."""
    raw, y, _, clf = train_setup(device, batch, size)
    proc = processor(device, use_kernel=True)
    if noise_layer:
        with_noise = ParametrizedProcessing(
            camera_parameters=MICROSCOPY_CAMERA_PARAMS, additive_layer=True,
            image_size=size, use_kernel=True, device=device)
        with_noise.load_state_dict(proc.state_dict(), strict=False)
        proc = with_noise
    return raw, y, proc, clf


def snapshot(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def phase_adversarial(device, batch=SERVE_BATCH, steps=ADV_STEPS):
    """One adversarial step through the kernel path against the plain
    path; then ``steps`` kernel-path steps counting launches; then one
    step each for two targets. Returns the launch counts of the
    ``steps`` steps."""
    raw, y, proc, clf = adv_setup(device, batch)
    cfg = adv_config()
    runs = {}
    for name, use_kernel in (("kernel", True), ("plain", False)):
        p, c, state, step = adv_copy(cfg, proc, clf, use_kernel)
        if name == "kernel":
            seen = capture_cotangent(p)
            params = {k: v.detach().clone()
                      for k, v in p.kernel_params().items()}
            with torch.no_grad():
                ref_rgb = state.ref_processor(raw)[0]
                rgb = p(raw)[0]
        mets = step(state, raw, y)
        runs[name] = ({n: t.grad for n, t in p.named_parameters()},
                      float(mets["loss"]), float(mets["loss_aux"]))
        if name == "kernel":
            g = seen["g"]
    (isp_k, loss_k, aux_k), (isp_p, loss_p, aux_p) = runs["kernel"], \
        runs["plain"]
    # a third of these values sit at the clipped regions' BN constant, where
    # the float32 plain gradient reads ~5e-4 of its scale from float64: the
    # float64 witness's limits only, as phase_train holds the backward
    ssim_stats, ssim_ok = ssim_agreement(ref_rgb, rgb.contiguous(),
                                         ADV_AUX_WEIGHT, vs_plain=False)
    _, grads_64 = witness(raw, params, g)
    _, scal = fused_isp_bwd_reference(raw, params, g)
    plain_bwd = unpack_grads(scal, params)
    same_cot = {
        "kernel_step": max(max_rel(isp_k[ISP_NAMES[k]].double(), grads_64[k],
                                   1e-3) for k in grads_64),
        "plain_bwd_f32": max(max_rel(plain_bwd[k].double(), grads_64[k],
                                     1e-3) for k in grads_64)}
    isp_err = {n: max_rel(isp_k[n].double(), isp_p[n].double(), 1e-3)
               for n in isp_k}
    emit({"phase": "adversarial_step_vs_plain", "batch": batch,
          "loss": loss_k, "loss_plain": loss_p, "loss_aux": aux_k,
          "loss_aux_plain": aux_p, "isp_grad_max_rel_err": isp_err,
          "ssim_cotangent_on_step_tensors": ssim_stats,
          "isp_grads_vs_float64_bwd_same_cotangent": same_cot})
    check(abs(loss_k - loss_p) <= LOSS_TOL, "adversarial loss")
    check(abs(aux_k - aux_p) <= LOSS_TOL, "adversarial loss_aux")
    check(max(isp_err.values()) <= BWD_PARAM,
          f"adversarial ISP gradients {isp_err}")
    check(ssim_ok, f"SSIM cotangent on the step's tensors {ssim_stats}")
    check(same_cot["kernel_step"] <= BWD_PARAM,
          f"adversarial ISP gradients vs the float64 backward {same_cot}")
    del runs, isp_k, isp_p, g

    p, c, state, step = adv_copy(cfg, proc, clf)
    before, clf_before = snapshot(p), snapshot(c)
    ref_before = snapshot(state.ref_processor)
    reset_counts()
    t0 = time.perf_counter()
    mets = [step(state, raw, y) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    main = counts()
    losses = [float(m["loss"]) for m in mets]
    aux = [float(m["loss_aux"]) for m in mets]
    moved = {n: not torch.equal(before[n], t.detach())
             for n, t in p.named_parameters()}
    frozen = {"reference": all(torch.equal(t, ref_before[n]) for n, t in
                               state.ref_processor.state_dict().items()),
              "classifier": all(torch.equal(t, clf_before[n])
                                for n, t in c.state_dict().items()),
              "isp_bn": all(torch.equal(t, before[n]) for n, t in
                            p.state_dict().items() if "running" in n)}
    emit({"phase": "adversarial", "batch": batch, "steps": steps,
          "seconds": seconds, "losses": losses, "loss_aux": aux,
          "isp_params_moved": moved, "bitwise_unchanged": frozen,
          "launches": main})
    check(all(np.isfinite(losses + aux)), "finite losses")
    check(all(moved.values()), f"every ISP parameter moved {moved}")
    check(all(frozen.values()), f"frozen modules unchanged {frozen}")
    check(main == launches(fwd=steps, fwd_train=steps, bwd_res=steps,
                           ssim=steps), f"adversarial launches {main}")

    for target, noise_layer, want in (
            ("gamma_correct", False, launches(fwd=1, fwd_train=1,
                                              bwd_res=1, ssim=1)),
            # no kernel parameter needs a gradient: the serving kernel
            ("additive_layer", True, launches(fwd=2, ssim=1))):
        raw_t, y_t, proc_t, clf_t = adv_setup(device, batch,
                                              noise_layer=noise_layer)
        p, c, state, step = adv_copy(adv_config(target), proc_t, clf_t)
        before = snapshot(p)
        reset_counts()
        step(state, raw_t, y_t)
        torch.cuda.synchronize()
        got = counts()
        moved = sorted(n for n, t in p.named_parameters()
                       if not torch.equal(before[n], t.detach()))
        emit({"phase": "adversarial_target", "target": target,
              "launches": got, "moved": moved})
        check(got == want, f"{target} launches {got}")
        check(moved == [target], f"{target}: only it moves, {moved}")
    return main


def write_dngs(img_dir, n_images, seed, size=SIZE, dataset=None):
    """``n_images`` 16-bit DNGs of SyntheticRawClassification mosaics (or
    of the class ``dataset``) in a new ``img_dir``; returns their paths in
    the order serving reads them."""
    ds = (dataset or SyntheticRawClassification)(n=n_images, h=size, w=size,
                                                 seed=seed)
    os.makedirs(img_dir)
    for i in range(n_images):
        write_dng(os.path.join(img_dir, f"img_{i:03d}.dng"),
                  np.round(ds[i][0] * 65535).astype(np.uint16))
    return [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))]


def served_records(out, paths, n_classes):
    """The records of a predictions file: one per file in ``paths``, in
    order, with finite logits; returns the logits (n, n_classes)."""
    with open(out) as fh:
        records = [json.loads(line) for line in fh]
    check([r["file"] for r in records] == paths, "one record per file")
    logits = np.array([r["logits"] for r in records])
    check(logits.shape == (len(paths), n_classes)
          and bool(np.isfinite(logits).all()), f"finite logits {logits.shape}")
    return logits


def phase_cli(device, batch=SERVE_BATCH, n_images=SERVE_IMAGES):
    """The forensics sequence through the training CLI on the card, with
    the fused kernels and --test_run: a pretraining run (frozen ISP, weak
    augmentation, 1 epoch), then an attack on gamma with the noise layer
    through the classifier file it wrote (SSIM aux weight -1, 2 epochs).
    Between them ``serving.main`` serves the pretraining run from its run
    directory on ``n_images`` synthetic DNGs: the fused serving kernel
    once per batch, and the logits of the trained modules. Returns the
    attack's launch counts."""
    from raw2logit_tpu_torch import serving
    from raw2logit_tpu_torch.training import train as cli
    common = ["--dataset", "SyntheticMicroscopy", "--batch_size", str(batch),
              "--n_splits", "1", "--use_pallas", "--test_run",
              "--experiment_name", "forensics"]
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.perf_counter()
            (pre,) = cli.main(common + [
                "--freeze_processor", "--augmentation", "weak", "--epochs",
                "1", "--lr", "1e-3", "--run_name", "pretrain"])
            pre_s = time.perf_counter() - t0
            paths = write_dngs("dng", n_images, SEED + 2)
            reset_counts()
            out = serving.main([
                "--experiment_name", "forensics", "--run_name", "pretrain",
                "--image_dir", "dng", "--dataset", "SyntheticMicroscopy",
                "--batch_size", str(batch), "--out", "pred.jsonl"])
            served = counts()
            logits = served_records(out, paths, 2)
            raws = np.stack([load_image(p) / 65535.0 for p in paths])
            clf_path = os.path.join(pre["run"].dir, "checkpoints",
                                    "classifier.pt")
            reset_counts()
            t0 = time.perf_counter()
            (adv,) = cli.main(common + [
                "--adv_training", "--freeze_classifier", "--classifier_uri",
                clf_path, "--adv_aux_loss", "ssim", "--adv_aux_weight", "-1",
                "--adv_noise_layer", "--adv_parameters", "gamma_correct",
                "--epochs", "2", "--lr", "1e-2", "--run_name", "adv_gamma"])
            torch.cuda.synchronize()
            adv_s = time.perf_counter() - t0
            attack = counts()
            metrics = adv["run"].read_metrics()
            pre_metrics = pre["run"].read_metrics()
        finally:
            os.chdir(cwd)
    trained = Predictor(copy.deepcopy(pre["state"].processor),
                        copy.deepcopy(pre["state"].classifier), device=device)
    trained_logits = np.concatenate([
        trained(raws[i:i + batch]).cpu().numpy()
        for i in range(0, n_images, batch)])
    serve_err = float(np.abs(logits - trained_logits).max())
    n_batches = -(-n_images // batch)
    state = adv["state"]
    ref = dict(state.ref_processor.named_parameters())
    drifted = sorted(n for n, t in state.processor.named_parameters()
                     if not torch.equal(t, ref[n]))
    aux = [m["val_loss_aux"] for m in metrics if "val_loss_aux" in m]
    emit({"phase": "cli", "pretrain_seconds": pre_s, "attack_seconds": adv_s,
          "pretrain_val_accuracy": [m["val_accuracy"] for m in pre_metrics
                                    if "val_accuracy" in m],
          "attack_val_accuracy": [m["val_accuracy"] for m in metrics
                                  if "val_accuracy" in m],
          "val_loss_aux": aux, "drifted": drifted, "launches": attack,
          "served_images": n_images, "served_launches": served,
          "served_vs_trained_max_abs": serve_err, "tol": LOGIT_TOL})
    # serving.main builds the classifier as the CLI does: the fused stem
    check(served == launches(fwd=n_batches, stem_fwd=n_batches),
          f"serving the pretraining run launched {served}")
    check(serve_err <= LOGIT_TOL, f"served logits against the trained "
                                  f"modules: {serve_err}")
    check(len(aux) == 2 and all(np.isfinite(aux)), f"val_loss_aux rows {aux}")
    check(set(drifted) <= {"gamma_correct", "additive_layer"}
          and "gamma_correct" in drifted, f"drifted parameters {drifted}")
    check(attack["ssim_aux"] > 0, f"the attack launched ssim_aux {attack}")
    return attack


def phase_serve(device, n_images=SERVE_IMAGES, size=SIZE,
                batch=SERVE_BATCH):
    proc = processor(device, use_kernel=True)
    clf = classifier(device)
    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "dng")
        write_dngs(img_dir, n_images, SEED, size)
        pred = Predictor(proc, clf, classes=[f"c{i}" for i in range(9)],
                         device=device)
        reset_counts()
        t0 = time.perf_counter()
        out = pred.predict_dir(img_dir, batch_size=batch,
                               out_path=os.path.join(tmp, "pred.jsonl"))
        seconds = time.perf_counter() - t0
        served = counts()
        check(served == launches(fwd=served["fused_isp_fwd"]),
              f"serving launches only the serving kernel: {served}")
        served = served["fused_isp_fwd"]
        with open(out) as fh:
            records = [json.loads(line) for line in fh]
        check(len(records) == n_images, f"{len(records)} records")
        logits = np.array([r["logits"] for r in records])
        check(logits.shape == (n_images, 9), f"logits {logits.shape}")
        check(bool(np.isfinite(logits).all()), "finite logits")
        n_batches = -(-n_images // batch)
        check(served == n_batches, f"{served} kernel launches for "
                                   f"{n_batches} batches")

        plain_proc = copy.deepcopy(proc)
        plain_proc.use_kernel = False
        plain = Predictor(plain_proc, clf, device=device)
        paths = [r["file"] for r in records]
        plain_logits = np.concatenate([
            plain(np.stack([load_image(p) / 65535.0
                            for p in paths[i:i + batch]])).cpu().numpy()
            for i in range(0, n_images, batch)])
    err = float(np.abs(plain_logits - logits).max())
    emit({"phase": "serve", "images": n_images, "batch": batch,
          "kernel_launches": served, "seconds": seconds,
          "logit_abs_max": float(np.abs(logits).max()),
          "max_abs_err_vs_plain": err, "tol": LOGIT_TOL,
          "preds": [r["pred"] for r in records][:8]})
    check(err <= LOGIT_TOL, f"logits vs plain path: {err}")
    return served, pred


def stem_params(device, seed=SEED):
    """A stem conv weight with lecun-normal scale (variance 1 / 147) and
    BN scale and shift near 1 and 0, seeded."""
    gen = torch.Generator(device).manual_seed(seed)
    w = torch.randn((64, 3, 7, 7), device=device, generator=gen) / 147 ** 0.5
    gamma = 1 + 0.1 * torch.randn(64, device=device, generator=gen)
    beta = 0.1 * torch.randn(64, device=device, generator=gen)
    return w, gamma, beta


def l2_rel(got, want):
    """||got - want|| / ||want||, in float64."""
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp_min(1e-300))


def sums_err(got, want, terms):
    """Largest per-channel |got - want| over the channel's sum of |terms|
    (the scale a float32 sum in another order is accurate to)."""
    scale = terms.double().abs().sum((0, 2, 3)).clamp_min(1e-30)
    return float(((got.double() - want.double()).abs() / scale).max())


def grad_agreement(run, again, plain, wit):
    """dW or d_x of a kernel against its float32 plain version and the
    float64 witness (STEM_GRAD_TOL, STEM_F64_FACTOR), and a second
    launch."""
    scale = float(wit.abs().max())
    err_k = float((run.double() - wit).abs().max()) / scale
    err_p = float((plain.double() - wit).abs().max()) / scale
    stats = {"max_abs_err": float((run - plain).abs().max()),
             "max_rel_err_vs_plain": max_rel(run.double(), plain.double()),
             "vs_float64": err_k, "plain_vs_float64": err_p,
             "bitwise_repeat": bool(torch.equal(run, again))}
    ok = (stats["max_rel_err_vs_plain"] <= STEM_GRAD_TOL
          and err_k <= STEM_F64_FACTOR * err_p
          and stats["bitwise_repeat"])
    return stats, ok


def stem_agreement(x, w, gamma, beta, ties, seed=SEED):
    """Each stem kernel against its plain version on the same inputs: the
    conv on (x, w); BN-pool, pool backward (a seeded normal pooled
    cotangent), dW and d_x on the kernel's act, quantised to multiples of
    1/8 with ``ties``, and on the coefficients of its batch statistics.
    Returns {kernel: (statistics, whether they hold the STEM_* limits)}."""
    out = {}
    act, s1, s2 = stem_conv(x, w)
    act2, s1b, s2b = stem_conv(x, w)
    act_eval, _, _ = stem_conv(x, w, stats=False)
    ra, r1, r2 = stem_conv_reference(x, w)
    stats = {"max_abs_err": float((act - ra).abs().max()),
             "act_max_rel_err": max_rel(act, ra),
             "sum_err": sums_err(s1, r1, ra),
             "sumsq_err": sums_err(s2, r2, ra * ra),
             "bitwise_repeat": bool(torch.equal(act, act2)
                                    and torch.equal(s1, s1b)
                                    and torch.equal(s2, s2b)),
             # the eval-mode route (no statistics) computes the same act
             "no_stats_bitwise_equal": bool(torch.equal(act_eval, act))}
    out["stem_conv_fwd"] = stats, (
        stats["act_max_rel_err"] <= STEM_ACT_TOL
        and max(stats["sum_err"], stats["sumsq_err"]) <= STEM_SUM_TOL
        and stats["bitwise_repeat"] and stats["no_stats_bitwise_equal"])
    del act2, act_eval, ra
    n = act.numel() // 64
    mean, var = batch_stats(s1, s2, n)
    inv, alpha, shift = bn_fold(gamma, beta, mean, var)
    if ties:
        act = torch.round(act * 8) / 8
    pooled = stem_bnpool(act, alpha, shift)
    pooled2 = stem_bnpool(act, alpha, shift)
    want = stem_bnpool_reference(act, alpha, shift)
    stats = {"max_abs_err": float((pooled - want).abs().max()),
             "bitwise_equal_to_plain": bool(torch.equal(pooled, want)),
             "bitwise_repeat": bool(torch.equal(pooled, pooled2))}
    out["stem_bnpool"] = stats, (stats["bitwise_equal_to_plain"]
                                 and stats["bitwise_repeat"])
    gen = torch.Generator(x.device).manual_seed(seed)
    dp = torch.randn(pooled.shape, device=x.device, generator=gen)
    del pooled2, want
    d_n, sd, sdx = stem_pool_bwd(act, dp, alpha, shift, mean, inv)
    d_n2, sd2, sdx2 = stem_pool_bwd(act, dp, alpha, shift, mean, inv)
    rn, rsd, rsdx = stem_pool_bwd_reference(act, dp, alpha, shift, mean, inv)
    xhat = (act - mean[:, None, None]) * inv[:, None, None]
    n_pos = float((rn > 0).float().mean())
    stats = {"max_abs_err": float((d_n - rn).abs().max()),
             "bitwise_equal_to_plain": bool(torch.equal(d_n, rn)),
             "sum_err": sums_err(sd, rsd, rn),
             "sum_xhat_err": sums_err(sdx, rsdx, rn * xhat),
             "share_positive": n_pos,
             "windows_with_positive_ties": window_ties(act, alpha, shift),
             "bitwise_repeat": bool(torch.equal(d_n, d_n2)
                                    and torch.equal(sd, sd2)
                                    and torch.equal(sdx, sdx2))}
    out["stem_pool_bwd"] = stats, (
        stats["bitwise_equal_to_plain"]
        and max(stats["sum_err"], stats["sum_xhat_err"]) <= STEM_SUM_TOL
        and stats["bitwise_repeat"])
    del d_n2, rn, xhat
    coef = bn_backward_coef(gamma, mean, inv, sd, sdx, n)
    coef64 = tuple(c.double() for c in coef)
    wit_in = act.double(), d_n.double()
    out["stem_conv_dw"] = grad_agreement(
        stem_conv_dw(x, act, d_n, coef), stem_conv_dw(x, act, d_n, coef),
        stem_conv_dw_reference(x, act, d_n, coef),
        stem_conv_dw_reference(x.double(), *wit_in, coef64))
    out["stem_conv_dx"] = grad_agreement(
        stem_conv_dx(act, d_n, coef, w), stem_conv_dx(act, d_n, coef, w),
        stem_conv_dx_reference(act, d_n, coef, w),
        stem_conv_dx_reference(*wit_in, coef64, w.double()))
    return out


def window_ties(act, alpha, shift):
    """Share of pooling windows whose maximum is positive and taken by two
    or more taps."""
    taps = window_taps(torch.relu(act * alpha[:, None, None]
                                  + shift[:, None, None]))
    best = taps.max(0).values
    return float(((taps == best).sum(0) > 1).logical_and(best > 0)
                 .float().mean())


def stem_input(device, shape, inputs):
    """The stem's input: the batch-normalised output (batch statistics)
    of the perturbed microscopy ISP on test mosaics (``isp``), or a
    seeded normal batch (``random``)."""
    b, _, h, w = shape
    if inputs == "random":
        gen = torch.Generator(device).manual_seed(SEED)
        return torch.randn(shape, device=device, generator=gen)
    with torch.no_grad():
        return processor(device, use_kernel=False).train()(
            test_mosaics((b, h, w)).to(device))[0].contiguous()


def phase_stem_kernels_vs_plain(device, shapes=STEM_SHAPES):
    """The five stem kernels against their plain versions, on the ISP's
    outputs and on random inputs with planted ties; returns the largest
    |kernel - plain| of each."""
    worst = dict.fromkeys(STEM_KERNELS, 0.0)
    w, gamma, beta = stem_params(device)
    for shape in shapes:
        for inputs, ties in (("isp", False), ("random", True)):
            x = stem_input(device, shape, inputs)
            results = stem_agreement(x, w, gamma, beta, ties)
            torch.cuda.synchronize()
            for name, (stats, ok) in results.items():
                emit({"phase": "stem_kernels_vs_plain", "kernel": name,
                      "shape": list(shape), "inputs": inputs,
                      "planted_ties": ties, **stats})
                check(ok, f"{name} {shape} {inputs}: {stats}")
                worst[name] = max(worst[name], stats["max_abs_err"])
            # the 4x8 input has 128 pooling windows, too few to promise
            # planted ties
            check(not ties or shape[2] * shape[3] < 1024
                  or results["stem_pool_bwd"][0][
                      "windows_with_positive_ties"] > 0.01, "ties planted")
            del x, results
    return worst


def capture_stem(c):
    """A dict that each train-mode forward of classifier ``c`` fills with
    its input ("x", detached), the stem parameters as they were ("w",
    "gamma", "beta") and, after the backward, the cotangents of its input
    ("d_x") and of the stem's output ("d_pooled")."""
    seen = {}

    def at_input(module, args):
        x = args[0]
        seen.update(x=x.detach().clone(), w=c.conv1.weight.detach().clone(),
                    gamma=c.bn1.weight.detach().clone(),
                    beta=c.bn1.bias.detach().clone())
        if x.requires_grad:
            x.register_hook(lambda g: seen.__setitem__("d_x", g))

    def at_stem_output(module, args):
        args[0].register_hook(lambda g: seen.__setitem__("d_pooled", g))
    c.register_forward_pre_hook(at_input)
    c.layer1.register_forward_pre_hook(at_stem_output)
    return seen


def stem_witness(seen, dtype):
    """Gradients (d_x, dW, dgamma, dbeta) of the plain stem in ``dtype``
    (autograd of ``stem_reference`` in train mode) for the captured input,
    parameters and cotangent."""
    args = [seen[k].detach().to(dtype).requires_grad_(True)
            for k in ("x", "w", "gamma", "beta")]
    zeros = torch.zeros(64, dtype=dtype, device=args[0].device)
    with torch.enable_grad():
        pooled, _, _ = stem_reference(*args, zeros, zeros + 1, True)
        return torch.autograd.grad(pooled, args, seen["d_pooled"].to(dtype))


def phase_stem_train(device, batch=SERVE_BATCH, steps=TRAIN_STEPS):
    """One train step with ``stem_kernel=True`` against one with the plain
    stem from identical weights (both through the ISP kernels); the kernel
    step's stem gradients against the float64 plain stem on its own input
    and cotangent; then ``steps`` kernel-path steps. Returns their launch
    counts."""
    raw, y, proc, clf = train_setup(device, batch)
    cfg = TrainConfig(lr=TRAIN_LR)
    runs = {}
    for name, flag in (("stem_kernel", True), ("plain_stem", False)):
        p, c, state, step = train_copy(cfg, proc, clf)
        c.stem_kernel = flag
        seen = capture_stem(c)
        loss = float(step(state, raw, y)["loss"])
        runs[name] = grads_and_stats(p, c), loss
        if flag:
            kernel_seen = seen
            kernel_grads = (seen["d_x"], c.conv1.weight.grad,
                            c.bn1.weight.grad, c.bn1.bias.grad)
    agree = step_agreement(runs["stem_kernel"], runs["plain_stem"])
    stats_k, stats_p = runs["stem_kernel"][0][2], runs["plain_stem"][0][2]
    bn1 = {k: max_rel(stats_k[f"clf.bn1.{k}"].double(),
                      stats_p[f"clf.bn1.{k}"].double())
           for k in ("running_mean", "running_var")}
    # relative L2 distances: the float64 forward's act differs from either
    # float32 one by rounding, which moves the pool's argmax in a few
    # near-tied windows (a few per 8.4 M at B = 32); each such flip moves
    # one whole cotangent, which a max-relative distance of d_x would read
    # as ~1e-2 for whichever path happens to flip
    wit = stem_witness(kernel_seen, torch.float64)
    plain = stem_witness(kernel_seen, torch.float32)
    names = ("d_x", "d_w", "d_gamma", "d_beta")
    vs_f64 = {n: (l2_rel(k, w64), l2_rel(p, w64))
              for n, k, p, w64 in zip(names, kernel_grads, plain, wit)}
    emit({"phase": "stem_train_vs_plain_stem", "batch": batch,
          "loss": runs["stem_kernel"][1], "loss_plain_stem":
          runs["plain_stem"][1], **agree, "bn1_running_max_rel_err": bn1,
          "stem_grads_vs_float64_same_cotangent": {
              n: {"kernel": k, "plain": p} for n, (k, p) in vs_f64.items()}})
    check(agree["loss_abs_err"] <= LOSS_TOL, "stem step: loss")
    check(agree["clf_grad_max_rel_err"] <= CLF_GRAD_TOL,
          f"stem step: classifier gradients {agree['clf_grad_max_rel_err']}")
    check(max(agree["isp_grad_max_rel_err"].values()) <= BWD_PARAM,
          f"stem step: ISP gradients {agree['isp_grad_max_rel_err']}")
    check(agree["running_stats_max_rel_err"] <= STATS_TOL,
          f"stem step: running statistics "
          f"{agree['running_stats_max_rel_err']}")
    check(all(k <= STEM_F64_FACTOR * p for k, p in vs_f64.values()),
          f"stem step: the kernel's stem gradients vs float64 {vs_f64}")
    del runs, kernel_seen, kernel_grads, wit, plain

    p, c, state, step = train_copy(cfg, proc, clf)
    c.stem_kernel = True
    before = {f"isp.{n}": t.detach().clone()
              for n, t in p.named_parameters()}
    before.update({n: t.detach().clone() for n, t in c.named_parameters()
                   if n.startswith(("conv1.", "bn1."))})
    reset_counts()
    t0 = time.perf_counter()
    losses = [step(state, raw, y)["loss"] for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    main = counts()
    losses = [float(v) for v in losses]
    now = {f"isp.{n}": t for n, t in p.named_parameters()}
    now.update(dict(c.named_parameters()))
    moved = {n: not torch.equal(before[n], now[n].detach()) for n in before}
    emit({"phase": "stem_train", "batch": batch, "steps": steps,
          "seconds": seconds, "losses": losses, "params_moved": moved,
          "launches": main})
    check(all(np.isfinite(losses)), "finite losses")
    check(all(moved.values()), f"every ISP and stem parameter moved {moved}")
    check(main == launches(fwd_train=steps, bwd_res=steps, stem_fwd=steps,
                           stem_bwd=steps), f"stem train launches {main}")
    return main


def stem_predictor(device, proc, clf, stem_kernel):
    c = copy.deepcopy(clf)
    c.stem_kernel = stem_kernel
    return Predictor(proc, c, device=device)


def phase_stem_serve(device, batch=SERVE_BATCH, n_batches=2):
    """``Predictor`` with the fused stem against the plain stem on the
    same device-resident mosaics; returns its launch counts and the
    Predictor."""
    proc = processor(device, use_kernel=True)
    clf = classifier(device)
    pred = stem_predictor(device, proc, clf, True)
    plain = stem_predictor(device, proc, clf, False)
    raws = [test_mosaics((batch, SIZE, SIZE), seed=SEED + i).to(device)
            for i in range(n_batches)]
    reset_counts()
    logits = [pred(r) for r in raws]
    torch.cuda.synchronize()
    served = counts()
    want = [plain(r) for r in raws]
    err = max(float((a - b).abs().max()) for a, b in zip(logits, want))
    emit({"phase": "stem_serve", "batch": batch, "batches": n_batches,
          "launches": served, "max_abs_err_vs_plain_stem": err,
          "logit_abs_max": max(float(a.abs().max()) for a in logits),
          "tol": LOGIT_TOL})
    check(all(bool(torch.isfinite(a).all()) and a.shape == (batch, 9)
              for a in logits), "finite logits of the batch's shape")
    check(served == launches(fwd=n_batches, stem_fwd=n_batches),
          f"stem serving launches {served}")
    check(err <= LOGIT_TOL, f"stem serving logits vs plain stem {err}")
    return served, pred


def cuda_ms(fn, inputs, iters):
    """Mean ms per call by CUDA events, cycling through ``inputs`` (several
    distinct inputs keep the raw reads out of the L2 cache)."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def train_runner(device, batch, use_kernel=True, stem_kernel=False,
                 dtype=torch.float32):
    """A train step at ``batch`` through the kernel path (or the plain
    path), with the fused stem or not, the classifier computing in
    ``dtype``: a callable taking and ignoring one argument (for
    ``cuda_ms``)."""
    raw, y, proc, clf = train_setup(device, batch)
    if dtype != torch.float32:
        clf = bf16_classifier(device, clf, stem_kernel)
    _, c, state, step = train_copy(TrainConfig(lr=TRAIN_LR), proc, clf,
                                   use_kernel)
    c.stem_kernel = stem_kernel
    return lambda _: step(state, raw, y)


def adv_runner(device, batch, use_kernel=True):
    """An adversarial step at ``batch`` through the kernel path (or the
    plain path), as ``train_runner``."""
    raw, y, proc, clf = adv_setup(device, batch)
    _, _, state, step = adv_copy(adv_config(), proc, clf, use_kernel)
    return lambda _: step(state, raw, y)


def stem_timings(device, b):
    """{kernel: (wrapper ms, plain ms, nearest library ms or None)} of the
    five stem kernels at B = ``b``, 256x256, by CUDA events. The nearest
    library calls lack the statistics (F.conv2d), the BN fold
    (convolution_backward on a ready d_a), or the BN fold, the ReLU mask
    and the sums (max_pool2d_with_indices_backward, its indices computed
    outside the timed window); the port never calls them."""
    x = stem_input(device, (b, 3, SIZE, SIZE), "random")
    w, gamma, beta = stem_params(device)
    with torch.no_grad():
        act, s1, s2 = stem_conv(x, w)
        n = act.numel() // 64
        mean, var = batch_stats(s1, s2, n)
        inv, alpha, shift = bn_fold(gamma, beta, mean, var)
        pooled = stem_bnpool(act, alpha, shift)
        dp = torch.randn_like(pooled)
        d_n, sd, sdx = stem_pool_bwd(act, dp, alpha, shift, mean, inv)
        coef = bn_backward_coef(gamma, mean, inv, sd, sdx, n)
        d_a = bn_input_cotangent(act, d_n, coef)
        r = torch.relu(act * alpha[:, None, None] + shift[:, None, None])
        _, pool_idx = torch.nn.functional.max_pool2d(
            r, 3, 2, padding=1, return_indices=True)
    one = [None]

    def pool_bwd_call(_):
        return torch.ops.aten.max_pool2d_with_indices_backward(
            dp, r, [3, 3], [2, 2], [1, 1], [1, 1], False, pool_idx)

    def cudnn_bwd(mask):
        return lambda _: torch.ops.aten.convolution_backward(
            d_a, x, w, None, [2, 2], [3, 3], [1, 1], False, [0, 0], 1, mask)

    with torch.no_grad(), full_float32():
        return {
            "stem_conv_fwd": (
                cuda_ms(lambda _: stem_conv(x, w), one, 20),
                cuda_ms(lambda _: stem_conv_reference(x, w), one, 5),
                cuda_ms(lambda _: torch.nn.functional.conv2d(
                    x, w, stride=2, padding=3), one, 20)),
            "stem_bnpool": (
                cuda_ms(lambda _: stem_bnpool(act, alpha, shift), one, 20),
                cuda_ms(lambda _: stem_bnpool_reference(act, alpha, shift),
                        one, 5), None),
            "stem_pool_bwd": (
                cuda_ms(lambda _: stem_pool_bwd(act, dp, alpha, shift, mean,
                                                inv), one, 20),
                cuda_ms(lambda _: stem_pool_bwd_reference(
                    act, dp, alpha, shift, mean, inv), one, 5),
                cuda_ms(pool_bwd_call, one, 20)),
            "stem_conv_dw": (
                cuda_ms(lambda _: stem_conv_dw(x, act, d_n, coef), one, 20),
                cuda_ms(lambda _: stem_conv_dw_reference(x, act, d_n, coef),
                        one, 5),
                cuda_ms(cudnn_bwd([False, True, False]), one, 20)),
            "stem_conv_dx": (
                cuda_ms(lambda _: stem_conv_dx(act, d_n, coef, w), one, 20),
                cuda_ms(lambda _: stem_conv_dx_reference(act, d_n, coef, w),
                        one, 5),
                cuda_ms(cudnn_bwd([True, False, False]), one, 20))}


def phase_times(device, kind, pred, trains, advs, pred_stem, trains_stem):
    """CUDA-event ms of each kernel's wrapper and its plain version beside
    the kernel's bound (and, for the stem's convolutions and pool backward,
    the nearest library call), of ``Predictor.__call__`` and of a train
    step (each with the fused stem and without) and of an adversarial step
    (and of the plain path's steps), at B = 32 and B = 256."""
    params = processor(device, use_kernel=True).kernel_params()
    rows = {}
    for b in (SERVE_BATCH, BIG_BATCH):
        n_inputs = max(2, 8 * SERVE_BATCH // b)
        raws = [test_mosaics((b, SIZE, SIZE), seed=SEED + i).to(device)
                for i in range(n_inputs)]
        with torch.no_grad():
            fwd = [fused_isp_train(x, params) for x in raws]
            bwd_in = [(x, (o * 0.5 + 0.1).contiguous(), r)
                      for x, (o, r) in zip(raws, fwd)]
            del fwd
            timed = {
                "fused_isp_fwd": (
                    cuda_ms(lambda x: fused_isp(x, params), raws, 50),
                    cuda_ms(lambda x: fused_isp_reference(x, params), raws,
                            10)),
                "fused_isp_fwd_train": (
                    cuda_ms(lambda x: fused_isp_train(x, params), raws, 50),
                    cuda_ms(lambda x: fused_isp_train_reference(x, params),
                            raws, 10)),
                "fused_isp_bwd_res": (
                    cuda_ms(lambda a: fused_isp_bwd(a[0], params, a[1], a[2]),
                            bwd_in, 50),
                    cuda_ms(lambda a: fused_isp_bwd_reference(a[0], params,
                                                              a[1]),
                            bwd_in, 10)),
                "fused_isp_bwd": (
                    cuda_ms(lambda a: fused_isp_bwd(a[0], params, a[1]),
                            bwd_in, 50),
                    None)}
        # the recompute variant computes the residual one's function
        timed["fused_isp_bwd"] = (timed["fused_isp_bwd"][0],
                                  timed["fused_isp_bwd_res"][1])
        pairs = [isp_pair(device, (b, 3, SIZE, SIZE)) for _ in range(2)]
        timed["ssim_aux"] = (
            cuda_ms(lambda a: ssim_aux_value_grad(a[0], a[1], ADV_AUX_WEIGHT),
                    pairs, 50),
            cuda_ms(lambda a: ssim_aux_reference(a[0], a[1], ADV_AUX_WEIGHT),
                    pairs, 10))
        del pairs
        timed = {name: (*ms, None) for name, ms in timed.items()}
        timed.update(stem_timings(device, b))
        kernels = {}
        for name, (k_ms, p_ms, lib_ms) in timed.items():
            elems = b * SIZE * SIZE * (3 if name == "ssim_aux" else 1)
            if name in STEM_KERNELS:
                elems = b * 64 * (SIZE // 2) ** 2
            b_ms, b_by = bound(kind, elems, name)
            kernels[name] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": lib_ms}
        s_ms = cuda_ms(pred, raws, 10)
        s_stem_ms = cuda_ms(pred_stem, raws, 10)
        t_ms = cuda_ms(trains[b], [None, None], 10)
        t_stem_ms = cuda_ms(trains_stem[b], [None, None], 10)
        t_plain_ms = cuda_ms(train_runner(device, b, use_kernel=False),
                             [None, None], 10)
        a_ms = cuda_ms(advs[b], [None, None], 10)
        a_plain_ms = cuda_ms(adv_runner(device, b, use_kernel=False),
                             [None, None], 10)
        rows[b] = {"batch": b, "kernels": kernels, "predictor_ms": s_ms,
                   "predictor_imgs_per_s": b / s_ms * 1e3,
                   "predictor_stem_kernel_ms": s_stem_ms,
                   "train_step_ms": t_ms,
                   "train_imgs_per_s": b / t_ms * 1e3,
                   "train_step_stem_kernel_ms": t_stem_ms,
                   "train_stem_kernel_imgs_per_s": b / t_stem_ms * 1e3,
                   "plain_path_train_step_ms": t_plain_ms,
                   "adversarial_step_ms": a_ms,
                   "adversarial_imgs_per_s": b / a_ms * 1e3,
                   "plain_path_adversarial_step_ms": a_plain_ms}
        emit({"phase": "times", "shape": [b, SIZE, SIZE], **rows[b]})
        del raws, bwd_in
    return rows


# The profiler now and then drops device records, in every retake of a
# trace alike and early in it: late in a long run the first device record
# of each trace, five traces in a row; in another run one of the two
# serving ISP records of a two-call segmentation trace, five traces in a
# row, 708 device records each time. So a trace opens with primers that
# take the records it loses at its start: torch's own spin kernel
# (``torch.cuda._sleep``), then one call of the function, each followed
# by PROFILE_SETTLE_S; the measured calls run back to back inside a
# ``record_function`` range (PROFILE_WINDOW). Only the device records that
# start in that range (less half a settle, for the clocks' skew) count,
# in every number and in the check that each launch of each port kernel
# has its record; a trace that lost one is taken again, at most
# PROFILE_ATTEMPTS times in all.
PROFILE_SETTLE_S, PROFILE_ATTEMPTS = 0.05, 5
PROFILE_PRIMER, PROFILE_WINDOW = "spin_kernel", "r2l_measured_call"
# ``record_function`` ranges, whose device-side records span the kernels
# launched inside them (counted as busy, they would read the gaps between
# those kernels as busy too): the measured window here, and the port's
# spans (``tracing``, named ``r2l.``; off unless tracing is on)
PROFILE_RANGES = (PROFILE_WINDOW,)


def measured_records(prof):
    """(device events of the measured calls, their window's start in the
    trace's us): the device records that start in the PROFILE_WINDOW
    range, primers and the ranges' and spans' own device-side records
    left out."""
    from torch.autograd import DeviceType
    events = prof.events()
    starts = [e.time_range.start for e in events
              if e.device_type != DeviceType.CUDA and e.name == PROFILE_WINDOW]
    t0 = (min(starts) if starts else float("-inf")) - PROFILE_SETTLE_S * 5e5
    return [e for e in events if e.device_type == DeviceType.CUDA
            and PROFILE_PRIMER not in e.name and e.name not in PROFILE_RANGES
            and not e.name.startswith("r2l.")
            and e.time_range.start >= t0], t0


def busy_ms(device):
    """Device ms during which at least one of the ``device`` events ran:
    the union of their intervals (a sum would count overlapping kernels
    twice)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    total, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def lost_launches(prof, t0):
    """Kernel launches on the host from ``t0`` (trace us) whose device
    record is missing, matched by CUPTI correlation id (some launches have
    none in any trace: a diagnostic, not a check): (their number, the
    first ten as [ms from t0, the names of the device records just before
    and after it]); None where the profiler does not expose its raw
    events."""
    from torch.autograd import DeviceType
    results = getattr(prof.profiler, "kineto_results", None)
    if results is None:
        return None
    raw = results.events()
    base = results.trace_start_ns()
    device = sorted((e.start_ns(), e.name()) for e in raw
                    if e.device_type() == DeviceType.CUDA)
    ids = {e.correlation_id() for e in raw
           if e.device_type() == DeviceType.CUDA}
    out = []
    for e in raw:
        at = (e.start_ns() - base) / 1e3
        if ("LaunchKernel" in e.name() and e.correlation_id() not in ids
                and at >= t0):
            before = [n for s, n in device if s <= e.start_ns()]
            after = [n for s, n in device if s > e.start_ns()]
            out.append([(at - t0) / 1e3, before[-1][:60] if before else None,
                        after[0][:60] if after else None])
    return len(out), out[:10]


def trace_losses(prof, launched, device, t0):
    """What the measured calls' records lost, {} if nothing: each port
    kernel whose records among ``device`` differ in number from
    ``launched``, its launches counted during those calls; on the card,
    every device record (calls that show none). With the loss, the
    device records counted, the ms from the window's start to the first
    of them and from the last of them to the last host event, and the
    launches whose record is missing (``lost_launches``)."""
    from torch.autograd import DeviceType
    recorded = {name: sum(1 for e in device if re.search(key, e.name))
                for name, key in PROFILE_KEYS.items()}
    lost = {name: [n, recorded[name]] for name, n in launched.items()
            if n != recorded[name]}
    if not lost and (device or not torch.cuda.is_available()):
        return {}
    host = [e.time_range for e in prof.events()
            if e.device_type != DeviceType.CUDA]
    edges = ([(min(e.time_range.start for e in device) - t0) / 1e3,
              (max(r.end for r in host)
               - max(e.time_range.end for e in device)) / 1e3]
             if device and host else None)
    return {"port_kernels_launched_recorded": lost,
            "device_records": len(device), "edge_gaps_ms": edges,
            "launches_without_record": lost_launches(prof, t0)}


def trace_calls(fn, arg, calls):
    """One trace of the primers and of ``calls`` measured calls of
    ``fn(arg)``: (the profiler, the wall ms per measured call, their
    launches of each port kernel)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if torch.cuda.is_available():
            torch.cuda._sleep(1000)  # the primers
            torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        fn(arg)
        torch.cuda.synchronize()
        time.sleep(PROFILE_SETTLE_S)
        before = counts()
        with record_function(PROFILE_WINDOW):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(arg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / calls
        launched = {name: n - before[name] for name, n in counts().items()}
        time.sleep(PROFILE_SETTLE_S)
    return prof, wall_ms, launched


def profile_calls(fn, arg, calls, warmups=3):
    """Device ms by kernel per call of ``fn(arg)`` (torch.profiler, after
    ``warmups`` warm-up calls), the device's busy ms per call and the wall
    ms per call, over ``calls`` measured calls from a trace that lost no
    record of them (``trace_calls``, ``trace_losses``). Returns ([(ms per
    call, kernel, launches per call)] largest first, busy ms, wall
    ms)."""
    for _ in range(warmups):
        fn(arg)
    for attempt in range(PROFILE_ATTEMPTS):
        prof, wall_ms, launched = trace_calls(fn, arg, calls)
        device, t0 = measured_records(prof)
        lost = trace_losses(prof, launched, device, t0)
        if not lost:
            break
        emit({"phase": "profile_trace_lost_records", "attempt": attempt,
              **lost})
    check(not lost, f"{PROFILE_ATTEMPTS} traces lost records: {lost}")
    by_name = {}
    for e in device:
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    kernels = sorted(((us / 1e3 / calls, name, n // calls)
                      for name, (us, n) in by_name.items()), reverse=True)
    return kernels, busy_ms(device) / calls, wall_ms


# Profile keys of the kernels, patterns searched in the profiler's names
# (template instances of the sources; the ISP forward's second argument is
# its row alignment; the stem's storage type is the last template
# argument, float or __nv_bfloat16, but for the bfloat16 conv forward, dW
# and d_x, which are kernels of their own on tensor cores, and BN-pool, a
# strip walk of its own).
PROFILE_KEYS = {"fused_isp_fwd": "fused_isp_fwd_kernel<false,",
                "fused_isp_fwd_train": "fused_isp_fwd_kernel<true,",
                "fused_isp_bwd_res": "fused_isp_bwd_kernel<true>",
                "fused_isp_bwd": "fused_isp_bwd_kernel<false>",
                "ssim_aux": "ssim_aux_kernel",
                **{name: f"{name}_kernel<[^>]*float>"
                   for name in STEM_KERNELS},
                "stem_conv_fwd_bf16": "stem_conv_fwd_mma_kernel",
                "stem_bnpool_bf16": "stem_bnpool_strip_kernel",
                "stem_pool_bwd_bf16": "stem_pool_bwd_kernel<[^>]*bfloat16",
                "stem_conv_dw_bf16": "stem_conv_dw_mma_kernel",
                "stem_conv_dx_bf16": "stem_conv_dx_mma_kernel"}


def port_kernel_ms(kernels):
    """{kernel: device ms per call} of the port's kernels that a profile's
    ``kernels`` (ms, name, count) show."""
    ours = {name: sum(k[0] for k in kernels if re.search(key, k[1]))
            for name, key in PROFILE_KEYS.items()}
    return {name: ms for name, ms in ours.items() if ms > 0}


def phase_profile(device, pred, trains, advs, pred_stem, trains_stem,
                  trains_bf16, calls=5):
    """Device time by kernel of ``Predictor.__call__`` and of a train step
    (each with the fused stem and without), of the bfloat16 train step
    with the fused stem (the stem's bfloat16 forms), of an adversarial
    step and of the recompute backward, and the device's idle share of
    the wall time, at B = 32 and B = 256. Returns {(what, batch): {kernel:
    device ms per call}}."""
    params = processor(device, use_kernel=True).kernel_params()

    def recompute_bwd(a):
        return fused_isp_bwd(a[0], params, a[1])

    found = {}
    for what, fn in (("serve", pred), ("serve_stem", pred_stem),
                     ("train", None), ("train_stem", None),
                     ("train_stem_bf16", None), ("adversarial", None),
                     ("bwd_recompute", recompute_bwd)):
        for b in (SERVE_BATCH, BIG_BATCH):
            arg = test_mosaics((b, SIZE, SIZE)).to(device)
            if what == "bwd_recompute":
                with torch.no_grad():
                    arg = arg, (fused_isp(arg, params) * 0.5 + 0.1)
            fn_b = fn or {"train": trains, "train_stem": trains_stem,
                          "train_stem_bf16": trains_bf16,
                          "adversarial": advs}[what][b]
            kernels, busy, wall_ms = profile_calls(fn_b, arg, calls)
            ours = port_kernel_ms(kernels)
            emit({"phase": "profile", "what": what, "batch": b,
                  "wall_ms": wall_ms, "device_busy_ms": busy,
                  "kernel_ms_sum": sum(k[0] for k in kernels),
                  "device_idle_share": 1 - busy / wall_ms,
                  "port_kernels_device_ms": ours,
                  **({"first_port_device_ms": {
                      name: ms for name, ms in FIRST_PORT_DEVICE_MS.items()
                      if name in ours}} if b == BIG_BATCH else {}),
                  "top_kernels_ms": [[k[1][:70], k[0], k[2]]
                                     for k in kernels[:15]]})
            want = {"serve": ("fused_isp_fwd",),
                    "serve_stem": ("fused_isp_fwd", *STEM_KERNELS[:2]),
                    "train": ("fused_isp_fwd_train", "fused_isp_bwd_res"),
                    "train_stem": ("fused_isp_fwd_train",
                                   "fused_isp_bwd_res", *STEM_KERNELS),
                    "train_stem_bf16": ("fused_isp_fwd_train",
                                        "fused_isp_bwd_res", *STEM_BF16),
                    "adversarial": ("fused_isp_fwd", "fused_isp_fwd_train",
                                    "fused_isp_bwd_res", "ssim_aux"),
                    "bwd_recompute": ("fused_isp_bwd",)}[what]
            check(all(n in ours for n in want) and not (
                      what == "train_stem_bf16"
                      and any(n in ours for n in STEM_KERNELS)),
                  f"the {what} profile shows {want}: {ours}")
            found[what, b] = ours
            del arg
    return found


def bn_agreement(x, dy):
    """The port's output batch norm against nn.BatchNorm2d(3, affine=False)
    computed in float64 on the same input and cotangent, all from running
    statistics (0, 1), one train-mode forward and backward each; the
    float32 nn.BatchNorm2d's distances from the same witness beside the
    port's. Returns (statistics, whether the port holds the BN_*
    limits)."""
    runs = {}
    for name, bn, dtype in (
            ("port", TorchBatchNorm(3, device=x.device), torch.float32),
            ("nn", torch.nn.BatchNorm2d(3, affine=False, device=x.device),
             torch.float32),
            ("float64", torch.nn.BatchNorm2d(3, affine=False, device=x.device,
                                             dtype=torch.float64),
             torch.float64)):
        xg = x.detach().to(dtype).requires_grad_(True)
        y = bn.train()(xg)
        (g,) = torch.autograd.grad(y, xg, dy.to(dtype))
        runs[name] = (y.detach().double(), g.double(),
                      bn.running_mean.double(), bn.running_var.double(),
                      int(bn.num_batches_tracked))
    y64, g64, m64, v64, _ = runs["float64"]

    def distances(y, g, m, v, _):
        return {"y_max_abs_err": float((y - y64).abs().max()),
                "grad_max_rel_err": max_rel(g, g64),
                "running_stats_max_rel_err": max(max_rel(m, m64),
                                                 max_rel(v, v64))}
    stats = {**distances(*runs["port"]),
             "nn_float32_vs_float64": distances(*runs["nn"]),
             "num_batches_tracked": runs["port"][4]}
    ok = (stats["y_max_abs_err"] <= BN_Y_ATOL
          and stats["grad_max_rel_err"] <= BN_GRAD_REL
          and stats["running_stats_max_rel_err"] <= BN_STATS_REL
          and stats["num_batches_tracked"] == 1)
    return stats, ok


def bn_step(bn, x, dy):
    """A train-mode forward and backward of ``bn`` on x under dy, as a
    callable taking and ignoring one argument (for ``cuda_ms``)."""
    def run(_):
        xg = x.detach().requires_grad_(True)
        return torch.autograd.grad(bn(xg), xg, dy)
    return run


def two_stage_var_mean(x):
    """Per-channel (biased variance, mean) of (B, C, H, W) through a (B, C,
    H W) view: per image, then combined over the batch."""
    v, m = torch.var_mean(x.view(x.shape[0], x.shape[1], -1), 2,
                          correction=0)
    mean = m.mean(0)
    return v.mean(0) + (m - mean).square().mean(0), mean


def phase_bn(device):
    """The ISP's output batch norm on the fused ISP's output at B = 32 and
    B = 256: against nn.BatchNorm2d in float64 (``bn_agreement``);
    CUDA-event ms and profiled device ms of its train-mode forward and
    backward beside nn.BatchNorm2d's; and the per-channel reductions over
    (0, 2, 3) against two stages over a (B, C, H W) view. Returns {batch:
    device ms of the forward and backward}."""
    params = processor(device, use_kernel=True).kernel_params()
    found = {}
    for b in (SERVE_BATCH, BIG_BATCH):
        with torch.no_grad():
            x = fused_isp(test_mosaics((b, SIZE, SIZE)).to(device), params)
        gen = torch.Generator(device).manual_seed(SEED)
        dy = torch.randn(x.shape, device=device, generator=gen)
        stats, ok = bn_agreement(x, dy)
        port = bn_step(TorchBatchNorm(3, device=device).train(), x, dy)
        native = bn_step(torch.nn.BatchNorm2d(3, affine=False,
                                              device=device).train(), x, dy)
        one = [None]
        view = x.view(b, 3, -1)
        times = {
            "ms": cuda_ms(port, one, 20),
            "native_ms": cuda_ms(native, one, 5),
            "mean_0_2_3_ms": cuda_ms(lambda _: x.mean((0, 2, 3)), one, 20),
            "mean_two_stage_ms": cuda_ms(lambda _: view.mean(2).mean(0), one,
                                         20),
            "var_mean_0_2_3_ms": cuda_ms(lambda _: torch.var_mean(
                x, (0, 2, 3), correction=0), one, 20),
            "var_mean_two_stage_ms": cuda_ms(
                lambda _: two_stage_var_mean(x), one, 20)}
        kernels, busy, wall_ms = profile_calls(port, None, 5)
        native_kernels, _, _ = profile_calls(native, None, 3)
        found[b] = sum(k[0] for k in kernels)
        emit({"phase": "bn", "shape": list(x.shape), **stats, **times,
              "device_ms": found[b], "device_busy_ms": busy,
              "wall_ms": wall_ms,
              "native_device_ms": sum(k[0] for k in native_kernels),
              "kernels_ms": [[k[1][:70], k[0], k[2]] for k in kernels],
              "native_kernels_ms": [[k[1][:70], k[0], k[2]]
                                    for k in native_kernels]})
        check(ok, f"output BN vs float64 nn.BatchNorm2d at B = {b}: "
                  f"{stats}")
        check(not any("batch_norm" in k[1] for k in kernels),
              "no native batch-norm kernel in the port's BN")
        del x, dy, view
    return found


def static_pipeline(debayer="bilinear", sharpening="sharpening_filter",
                    denoising="gaussian_denoising"):
    """A static pipeline on the microscopy camera; the defaults are the
    CLI's."""
    return StaticPipeline(camera_parameters=MICROSCOPY_CAMERA_PARAMS,
                          debayer=debayer, sharpening=sharpening,
                          denoising=denoising)


def menon_flips(cfa, cfa64):
    """Menon's decisions on the card against the float64 CPU run: (the
    flipped sites' mask (B, H, W) on the CPU, a report)."""
    m = menon_decision(cfa)[0].cpu()
    m64, sum_h, sum_v = menon_decision(cfa64)
    flips = m != m64
    gap = ((sum_v - sum_h).abs() / (sum_v + sum_h))[flips]
    sites = [[*map(int, at), float(sum_h[tuple(at)]), float(sum_v[tuple(at)])]
             for at in flips.nonzero()[:8]]
    return flips, {"menon_flipped_share": float(flips.double().mean()),
                   "menon_flips": int(flips.sum()),
                   "menon_flip_sites_b_y_x_sum_h_sum_v": sites,
                   "menon_flip_max_rel_gap": float(gap.max()) if len(gap)
                   else 0.0}


def final_tolerance(pre, pre64, pre_err):
    """The tolerance of a pipeline's output after gamma: STATIC_FINAL_TOL
    plus gamma's slope times the pixel's own pre-gamma difference
    ``pre_err`` (near the clip floor a float32 rounding moves the output
    past STATIC_FINAL_TOL)."""
    p = 1.0 / STATIC_GAMMA
    slope = p * torch.minimum(pre, pre64).pow(p - 1)
    return STATIC_FINAL_TOL + torch.where(
        pre_err > 0, torch.minimum(slope * pre_err, pre_err.pow(p)),
        torch.zeros_like(pre_err))


def static_gates(device, raw, pipelines=STATIC_PIPELINES):
    """The static ISP on the card in float32 against the port's own run of
    the same functions in float64 on the CPU, on mosaics ``raw`` (B, H,
    W): Menon's decision map, each demosaic stage, and each pipeline
    before gamma and after (``STATIC_*``, ``MENON_*``). The float64 camera
    stage runs once per debayer, for its gate and its pipelines. Returns
    one report per stage and pipeline."""
    black_level, wb, ccm = MICROSCOPY_CAMERA_PARAMS
    raw64 = raw.double().cpu()
    cfa = subtract_black_level_cfa(raw.to(device), black_level)
    cfa64 = subtract_black_level_cfa(raw64, black_level)
    flips, menon = menon_flips(cfa, cfa64)
    keep = ~flips.flatten(1).any(1)  # images without a flipped site
    menon["menon_images_left_out"] = int((~keep).sum())
    check(float(keep.double().mean()) >= MENON_MIN_KEPT,
          f"{MENON_MIN_KEPT} of the images without a Menon flip: {menon}")
    check(menon["menon_flipped_share"] <= MENON_FLIP_SHARE
          and menon["menon_flip_max_rel_gap"] <= MENON_TIE_REL,
          f"Menon's decisions against float64: {menon}")
    reports = [{"stage": "menon_decision", **menon}]

    camera64 = {}
    for name, fn in DEMOSAIC_FNS.items():
        dem64 = fn(cfa64)
        want = dem64[keep] if name == "menon2007" else dem64
        got = fn(cfa).cpu().double()
        got = got[keep] if name == "menon2007" else got
        err = float((got - want).abs().max())
        reports.append({"stage": "demosaic", "debayer": name,
                        "max_abs_err": err, "tol": STATIC_STAGE_TOL})
        check(err <= STATIC_STAGE_TOL, f"demosaic {name}: {err}")
        camera64[name] = colour_correction(white_balance(dem64, wb), ccm)
    every = torch.arange(raw.shape[0])
    for d, s, n in pipelines:
        pre_card = filter_stage(camera_stage(raw.to(device),
                                             *MICROSCOPY_CAMERA_PARAMS, d),
                                s, n)
        final_card = static_process(raw.to(device), *MICROSCOPY_CAMERA_PARAMS,
                                    debayer=d, sharpening=s, denoising=n)
        check(final_card.shape == (raw.shape[0], 3) + raw.shape[1:]
              and bool(torch.isfinite(final_card).all()),
              f"{d}/{s}/{n}: finite output of shape {tuple(final_card.shape)}")
        rows = every[::STATIC_CHAMBOLLE_EVERY if n == "tv_chambolle" else 1]
        pre64 = filter_stage(camera64[d][rows], s, n)
        if d == "menon2007":  # after the filter: the bilateral's coupling
            pre64, rows = pre64[keep[rows]], rows[keep[rows]]
        final64 = adjust_gamma(pre64, STATIC_GAMMA)
        pre = pre_card.cpu().double()[rows]
        final = final_card.cpu().double()[rows]
        pre_err = (pre - pre64).abs()
        final_err = (final - final64).abs()
        tol = final_tolerance(pre, pre64, pre_err)
        off_floor = pre64 > 0.01  # slope below 5.3 there
        rep = {"stage": "pipeline", "pipeline": [d, s, n],
               "images": len(rows),
               "pre_gamma_max_abs_err": float(pre_err.max()),
               "final_max_abs_err": float(final_err.max()),
               "final_max_abs_err_off_floor": float(
                   final_err[off_floor].max()),
               "final_max_err_over_tol": float((final_err / tol).max()),
               "share_clipped_to_0": float((pre64 == 0).double().mean()),
               "share_clipped_to_1": float((pre64 == 1).double().mean())}
        reports.append(rep)
        check(rep["pre_gamma_max_abs_err"] <= STATIC_PRE_TOL
              and rep["final_max_err_over_tol"] <= 1.0,
              f"static pipeline {d}/{s}/{n} against float64: {rep}")
    return reports


def phase_static_gates(device, batch=SERVE_BATCH, size=SIZE):
    """The gates of ``static_gates`` at B = 32, 256x256, on
    SyntheticMicroscopy mosaics at exposures from dark to bright (at full
    exposure the microscopy camera clips most pixels to 1)."""
    raw, _ = labelled_mosaics(torch.device("cpu"), batch, size)
    raw *= torch.linspace(0.05, 1.0, batch)[:, None, None]
    t0 = time.perf_counter()
    reports = static_gates(device, raw)
    for rep in reports:
        emit({"phase": "static_gates", "shape": [batch, size, size], **rep})
    emit({"phase": "static_gates", "seconds": time.perf_counter() - t0})


def static_runner(device, raw, y, debayer="bilinear", precomputed=False):
    """A static-mode train step on mosaics ``raw`` and labels ``y`` on the
    device (the CLI's defaults but for ``debayer``; ResNet-18 as built,
    the static ISP frozen), in graph or on RGB precomputed by the same
    pipeline: a callable taking and ignoring one argument (for
    ``cuda_ms``)."""
    from raw2logit_tpu_torch.training.train import _StaticAsModule
    stats = dataset_stats("SyntheticMicroscopy")
    proc = _StaticAsModule(static_pipeline(debayer), stats["mean"],
                           stats["std"], device)
    if precomputed:
        with torch.no_grad():
            raw, proc = proc(raw)[0], None
    cfg = TrainConfig(lr=TRAIN_LR, freeze_processor=True)
    clf = train_classifier(device)
    state = create_train_state(cfg, proc, clf)
    step = make_train_step(cfg, proc, clf)
    return lambda _: step(state, raw, y)


STATIC_STEPS = {"static_train": {},
                "static_train_menon2007": {"debayer": "menon2007"},
                "static_precomputed": {"precomputed": True}}


def phase_static_times(device, batches=(SERVE_BATCH, BIG_BATCH)):
    """CUDA-event ms of the static train steps (in graph with the CLI's
    choices and with menon2007, and on precomputed RGB), each run with the
    launch counts set to 0 just before and read just after: no kernel of
    the port runs on these paths. Returns {(what, batch): runner}."""
    runners = {}
    for b in batches:
        row = {}
        raw, y = labelled_mosaics(device, b)
        for what, kw in STATIC_STEPS.items():
            runners[what, b] = run = static_runner(device, raw, y, **kw)
            reset_counts()
            row[what + "_step_ms"] = cuda_ms(run, [None, None], 10)
            seen = counts()
            check(seen == launches(), f"{what} launches no kernel: {seen}")
            row[what + "_imgs_per_s"] = b / row[what + "_step_ms"] * 1e3
        emit({"phase": "static_times", "shape": [b, SIZE, SIZE], **row})
    return runners


def phase_static_precompute(device, n_images=2 * BIG_BATCH,
                            batch=BIG_BATCH):
    """``precompute_pipeline_rgb`` in images/s for each debayer (the CLI's
    sharpening and denoising), over ``n_images`` 256x256 mosaics held in
    host memory (their generation not timed), batches of ``batch``."""
    raw, y = labelled_mosaics(torch.device("cpu"), batch)
    ds = ArrayDataset(np.concatenate([raw.numpy()] * (n_images // batch)),
                      np.concatenate([y.numpy()] * (n_images // batch)))
    row = {}
    for name in DEMOSAIC_FNS:
        pipe = static_pipeline(name)
        precompute_pipeline_rgb(ds, pipe, batch_size=batch, device=device,
                                indices=range(batch))  # warm-up
        reset_counts()
        t0 = time.perf_counter()
        rgb = precompute_pipeline_rgb(ds, pipe, batch_size=batch,
                                      device=device)
        seconds = time.perf_counter() - t0
        check(counts() == launches(), f"precompute launches {counts()}")
        check(rgb.shape == (n_images, 3, *raw.shape[1:])
              and bool(np.isfinite(rgb).all()), f"precomputed {rgb.shape}")
        row[name + "_imgs_per_s"] = n_images / seconds
    emit({"phase": "static_precompute", "images": n_images, "batch": batch,
          **row})


def phase_static_cli(device, batch=SERVE_BATCH, n_images=SERVE_IMAGES):
    """The drift-synthesis flow through the CLIs on the card: a 1-epoch
    --test_run of --processing_mode static --precompute_static (the
    CLI's pipeline choices), then ``serving.main`` on that run over
    ``n_images`` synthetic DNGs: one record per file, the logits of
    ``Predictor.from_run`` equal to the trained classifier's behind the
    same pipeline, and no kernel of the port launched."""
    from raw2logit_tpu_torch import serving
    from raw2logit_tpu_torch.training import train as cli
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_counts()
            t0 = time.perf_counter()
            (res,) = cli.main([
                "--dataset", "SyntheticMicroscopy", "--processing_mode",
                "static", "--precompute_static", "--test_run", "--epochs",
                "1", "--batch_size", str(batch), "--n_splits", "1",
                "--experiment_name", "static", "--run_name", "s"])
            train_s = time.perf_counter() - t0
            paths = write_dngs("dng", n_images, SEED + 1)
            t0 = time.perf_counter()
            out = serving.main([
                "--experiment_name", "static", "--run_name", "s",
                "--image_dir", "dng", "--dataset", "SyntheticMicroscopy",
                "--processing_mode", "static", "--batch_size", str(batch),
                "--out", "pred.jsonl"])
            serve_s = time.perf_counter() - t0
            seen = counts()
            with open(out) as fh:
                records = [json.loads(line) for line in fh]
            logits = served_records(out, paths, 2)
            raws = np.stack([load_image(p) / 65535.0 for p in paths])
            pred = Predictor.from_run("static", "s",
                                      dataset_name="SyntheticMicroscopy",
                                      processing_mode="static")
            metrics = res["run"].read_metrics()
        finally:
            os.chdir(cwd)
    served = pred(raws).cpu().numpy()
    stats = dataset_stats("SyntheticMicroscopy")
    mean, std = (torch.tensor(stats[k], device=device).reshape(3, 1, 1)
                 for k in ("mean", "std"))
    clf = res["state"].classifier.eval()
    with torch.no_grad():
        x = torch.as_tensor(raws, dtype=torch.float32, device=device)
        trained = clf((static_pipeline()(x) - mean) / std).cpu().numpy()
    err = float(np.abs(served - trained).max())
    err_records = float(np.abs(logits - trained).max())
    emit({"phase": "static_cli", "train_seconds": train_s,
          "serve_seconds": serve_s, "images": n_images, "records":
          len(records), "val_accuracy": [m["val_accuracy"] for m in metrics
                                         if "val_accuracy" in m],
          "from_run_vs_trained_max_abs": err,
          "records_vs_trained_max_abs": err_records, "tol": LOGIT_TOL,
          "launches": seen, "preds": [r["pred"] for r in records][:8]})
    check(routed_stem(seen) == launches(),
          f"the static flow launched {seen}")
    check(err <= LOGIT_TOL and err_records <= LOGIT_TOL,
          f"from_run logits against the trained classifier {err}, "
          f"{err_records}")


def profile_without_port_kernels(phase, what, batch, fn, calls, warmups=3,
                                 allowed=()):
    """Device time by kernel and the device's idle share of ``fn(None)``
    (``profile_calls``), emitted as a ``phase`` line: no kernel of the
    port but those ``allowed`` may show in the profile."""
    kernels, busy, wall_ms = profile_calls(fn, None, calls, warmups)
    ours = port_kernel_ms(kernels)
    emit({"phase": phase, "what": what, "batch": batch, "calls": calls,
          "wall_ms": wall_ms, "device_busy_ms": busy,
          "kernel_ms_sum": sum(k[0] for k in kernels),
          "device_idle_share": 1 - busy / wall_ms,
          "port_kernels_device_ms": ours,
          "top_kernels_ms": [[k[1][:70], k[0], k[2]]
                             for k in kernels[:15]]})
    check(busy > 0 and not set(ours) - set(allowed),
          f"the {what} profile shows device time and no port kernel but "
          f"{allowed}: {ours}")


def phase_static_profile(device, runners, calls=5):
    """Device time by kernel and the device's idle share of each static
    train step (``phase_static_times``' runners): no kernel of the port
    in the profile."""
    for (what, b), run in runners.items():
        profile_without_port_kernels("profile", what, b, run, calls)


# --- segmentation, the neural and identity ISPs ----------------------------

def seg_batch(device, batch, size=SIZE, seed=SEED):
    """``batch`` SyntheticRawSegmentation mosaics and their masks, on the
    device."""
    ds = SyntheticRawSegmentation(n=batch, h=size, w=size, seed=seed)
    items = [ds[i] for i in range(batch)]
    return tuple(torch.as_tensor(np.stack(a), dtype=torch.float32,
                                 device=device) for a in zip(*items))


def seg_modules(device, use_kernel=True, seed=SEED, remat=False):
    """The drone ISP as ``processor`` perturbs it, and the CLI's U-Net++
    (resnet34, depth 5, decoder (256, 128, 64, 32, 16), one class, with
    ``remat`` or not) seeded on the device."""
    proc = processor(device, use_kernel, camera=DRONE_CAMERA_PARAMS,
                     seed=seed)
    net = UNetPlusPlus(remat=remat, device=device,
                       generator=torch.Generator(device).manual_seed(seed))
    return proc, net


def mosaic_stats():
    stats = dataset_stats("Microscopy")
    return {"normalize_mosaic_mean": stats["mosaic_mean"],
            "normalize_mosaic_std": stats["mosaic_std"]}


def phase_seg_train(device, batch=SEG_BATCH, big=SERVE_BATCH,
                    steps=SEG_STEPS, size=SIZE):
    """A segmentation train step through the ISP kernels against one
    through the plain ISP and one through the plain ISP in float64, from
    identical weights, at ``batch``; the kernel step's ISP gradients held
    to the float64 plain backward on that step's own cotangent; then
    ``steps`` kernel-path steps at ``big``, counting launches. Returns
    their launch counts.

    Loss and IoU are held to the plain path's (LOSS_TOL, SEG_IOU_TOL). The
    U-Net++ gradients (one vector) and the running statistics are held to
    the float64 step within CLF_GRAD_TOL and STATS_TOL, or STEP_F64_FACTOR
    times the float32 plain path's own distance from it, whichever is
    larger, as phase_train holds its perturbed classifiers: at small
    images the depth-5 U-Net++'s deepest batch norms normalise few values
    (2x2 positions per image at 64x64) and amplify float32 rounding (the
    two paths' gradients read 1.55e-3 apart at B = 2 there, 8.9e-5 at
    B = 8, 256x256)."""
    raw, y = seg_batch(device, batch, size)
    proc, net = seg_modules(device)
    params = proc.kernel_params()
    cfg = TrainConfig(task="segmentation", lr=TRAIN_LR)
    runs = {}
    for name, use_kernel, dtype in (("kernel", True, torch.float32),
                                    ("plain", False, torch.float32),
                                    ("float64", False, torch.float64)):
        p, c, state, step = train_copy(cfg, proc, net, use_kernel, dtype)
        seen = capture_cotangent(p)
        mets = step(state, raw.to(dtype), y.to(dtype))
        runs[name] = ((grads_and_stats(p, c), float(mets["loss"])),
                      float(mets["iou_score"]))
        if name == "kernel":
            g = seen["g"]
        del p, c, state, step
    agree = step_agreement(runs["kernel"][0], runs["plain"][0])
    vs_f64 = {name: step_agreement(runs[name][0], runs["float64"][0])
              for name in ("kernel", "plain")}
    _, grads_64 = witness(raw, params, g)
    isp_k = runs["kernel"][0][0][0]
    wit = max(max_rel(isp_k[ISP_NAMES[k]].double(), grads_64[k], 1e-3)
              for k in grads_64)
    iou_err = abs(runs["kernel"][1] - runs["plain"][1])
    keys = ("clf_grad_max_rel_err", "running_stats_max_rel_err")
    emit({"phase": "seg_step_vs_plain", "batch": batch, "size": size,
          "loss": runs["kernel"][0][1], "iou": runs["kernel"][1],
          "iou_abs_err": iou_err, **agree,
          "vs_float64": {name: {k: v[k] for k in keys}
                         for name, v in vs_f64.items()},
          "isp_grads_vs_float64_bwd_same_cotangent": wit,
          "cotangent_abs_max": float(g.abs().max())})
    check(agree["loss_abs_err"] <= LOSS_TOL, "segmentation loss")
    check(iou_err <= SEG_IOU_TOL, f"segmentation IoU {iou_err}")
    check(wit <= BWD_PARAM, f"the kernel step's ISP gradients vs the "
                            f"float64 backward on its cotangent {wit}")
    for key, tol, what in zip(keys, (CLF_GRAD_TOL, STATS_TOL),
                              ("U-Net++ gradients", "running statistics")):
        k_err, p_err = vs_f64["kernel"][key], vs_f64["plain"][key]
        check(k_err <= max(tol, STEP_F64_FACTOR * p_err),
              f"{what} vs the float64 step {k_err} (the plain path's "
              f"{p_err})")
    del runs, g, grads_64, isp_k

    raw, y = seg_batch(device, big, size, seed=SEED + 1)
    p, c, state, step = train_copy(cfg, proc, net)
    before = {n: t.detach().clone() for n, t in p.named_parameters()}
    reset_counts()
    t0 = time.perf_counter()
    mets = [step(state, raw, y) for _ in range(steps)]
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    main = counts()
    losses = [float(m["loss"]) for m in mets]
    moved = {n: not torch.equal(before[n], t)
             for n, t in p.named_parameters()}
    emit({"phase": "seg_train", "batch": big, "steps": steps,
          "seconds": seconds, "losses": losses,
          "iou": [float(m["iou_score"]) for m in mets],
          "isp_params_moved": moved, "launches": main})
    check(all(np.isfinite(losses)), "finite segmentation losses")
    check(all(moved.values()), f"every ISP parameter moved {moved}")
    check(main == launches(fwd_train=steps, bwd_res=steps),
          f"segmentation launches {main}")
    return main


def seg_masks(pred, raws, batch):
    return torch.cat([pred(raws[i:i + batch]).cpu()
                      for i in range(0, len(raws), batch)])


def served_masks(out, paths, masks):
    """The records of a segmentation predictions file: one per file in
    ``paths``, in order, with the JAX package's fields, whose mask means
    are those of ``masks``."""
    with open(out) as fh:
        records = [json.loads(line) for line in fh]
    check([r["file"] for r in records] == paths, "one record per file")
    check(all(sorted(r) == ["file", "mask_mean", "mask_pixels"]
              for r in records), "segmentation record fields")
    err = max(abs(r["mask_mean"] - float(m.double().mean()))
              for r, m in zip(records, masks))
    check(err <= 1e-6, f"record mask means vs the masks {err}")
    return records


def phase_seg_serve(device, n_images=SERVE_IMAGES, batch=SERVE_BATCH,
                    size=SIZE):
    """``Predictor.predict_dir`` with the drone ISP's kernel and the
    U-Net++ on ``n_images`` synthetic 16-bit DNGs: one serving-kernel
    launch per batch; the masks against a Predictor whose ISP takes the
    plain path, within SEG_MASK_TOL. Returns the launches."""
    proc, net = seg_modules(device)
    pred = Predictor(proc, net, task="segmentation", device=device)
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_dngs(os.path.join(tmp, "dng"), n_images, SEED, size,
                           dataset=SyntheticRawSegmentation)
        reset_counts()
        t0 = time.perf_counter()
        out = pred.predict_dir(os.path.join(tmp, "dng"), batch_size=batch,
                               out_path=os.path.join(tmp, "pred.jsonl"))
        seconds = time.perf_counter() - t0
        served = counts()
        raws = np.stack([load_image(p) / 65535.0 for p in paths])
        masks = seg_masks(pred, raws, batch)
        records = served_masks(out, paths, masks)
    plain_proc = copy.deepcopy(proc)
    plain_proc.use_kernel = False
    plain = Predictor(plain_proc, net, task="segmentation", device=device)
    err = float((seg_masks(plain, raws, batch) - masks).abs().max())
    n_batches = -(-n_images // batch)
    emit({"phase": "seg_serve", "images": n_images, "batch": batch,
          "seconds": seconds, "launches": served,
          "mask_pixels": [r["mask_pixels"] for r in records][:8],
          "max_abs_err_vs_plain": err, "tol": SEG_MASK_TOL})
    check(masks.shape == (n_images, 1, size, size)
          and bool(torch.isfinite(masks).all()), f"masks {masks.shape}")
    check(served == launches(fwd=n_batches), f"segmentation serving "
                                             f"launched {served}")
    check(err <= SEG_MASK_TOL, f"masks vs the plain ISP {err}")
    return served


def phase_neural_identity(device, batch=NN_BATCH, size=SIZE):
    """The neural ISP (published widths, the CLI's microscopy mosaic
    statistics) in float32 on the card against itself in float64 on the
    card, in eval and train mode (NN_F64_REL); the identity ISP on the
    card against the CPU (IDENTITY_TOL); one neural-ISP train step
    (ResNet-18 behind it, both with perturbed batch norms) in which no
    kernel of the port launches, every parameter but the U-Net++ head's
    bias moves (the output batch norm takes the mean out of its
    gradient, which is rounding noise) and every running statistic
    moves."""
    raw, y = labelled_mosaics(device, batch, size)
    gen = torch.Generator(device).manual_seed(SEED)
    nn32 = NNProcessing(**mosaic_stats(), device=device, generator=gen)
    nn64 = copy.deepcopy(nn32).double()
    errs = {}
    for mode, train in (("eval", False), ("train", True)):
        with torch.no_grad():
            got = nn32.train(train)(raw)[0]
            want = nn64.train(train)(raw.double())[0]
        errs[mode] = max_rel(got.double(), want)
    ident = RawToRGB(**mosaic_stats(), device=device)
    got, stages = ident(raw)
    want, _ = RawToRGB(**mosaic_stats(), device="cpu")(raw.cpu())
    ident_err = float((got.cpu() - want).abs().max())

    nn_isp = perturb_bns(NNProcessing(**mosaic_stats(), device=device,
                                      generator=gen), gen)
    clf = classifier(device)
    cfg = TrainConfig(lr=TRAIN_LR)
    state = create_train_state(cfg, nn_isp, clf)
    step = make_train_step(cfg, nn_isp, clf)
    before = {f"{m}.{n}": t.detach().clone()
              for m, mod in (("isp", nn_isp), ("clf", clf))
              for n, t in mod.state_dict().items()
              if t.is_floating_point()}
    reset_counts()
    loss = float(step(state, raw, y)["loss"])
    seen = counts()
    after = {f"{m}.{n}": t for m, mod in (("isp", nn_isp), ("clf", clf))
             for n, t in mod.state_dict().items() if t.is_floating_point()}
    head_bias = "isp.model.segmentation_head.bias"
    still = sorted(n for n in before if n != head_bias
                   and torch.equal(before[n], after[n]))
    head_grad = float(nn_isp.model.segmentation_head.bias.grad.abs().max())
    emit({"phase": "neural_identity", "batch": batch,
          "nn_float32_vs_float64_max_rel": errs, "tol": NN_F64_REL,
          "identity_card_vs_cpu_max_abs": ident_err,
          "identity_tol": IDENTITY_TOL, "train_loss": loss,
          "launches": seen, "unmoved": still,
          "head_bias_grad_abs_max": head_grad})
    check(all(e <= NN_F64_REL for e in errs.values()),
          f"neural ISP float32 vs float64 {errs}")
    check(got.shape == (batch, 3, size // 2, size // 2)
          and list(stages) == ["demosaic"], "identity ISP output")
    check(ident_err <= IDENTITY_TOL, f"identity ISP card vs CPU {ident_err}")
    check(np.isfinite(loss), "finite neural-ISP loss")
    check(seen == launches(), f"the neural-ISP step launched {seen}")
    check(not still, f"parameters or statistics that did not move {still}")


def phase_seg_cli(device, batch=16, n_images=SERVE_IMAGES):
    """Through the CLIs on the card: a 1-epoch --test_run of
    SyntheticDrone with the ISP kernels (``--use_pallas``), then
    ``serving.main`` on that run over ``n_images`` synthetic DNGs (one
    record per file, one serving launch per batch, the masks of
    ``Predictor.from_run`` equal to the trained modules'); then
    --test_run of --processing_mode neural_network and none on
    SyntheticMicroscopy (metrics rows written)."""
    from raw2logit_tpu_torch import serving
    from raw2logit_tpu_torch.training import train as cli
    common = ["--epochs", "1", "--batch_size", str(batch), "--n_splits",
              "1", "--test_run", "--experiment_name", "seg"]
    cwd = os.getcwd()
    seconds, rows = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_counts()
            t0 = time.perf_counter()
            (seg,) = cli.main(common + ["--dataset", "SyntheticDrone",
                                        "--use_pallas", "--run_name", "s"])
            torch.cuda.synchronize()
            seconds["segmentation"] = time.perf_counter() - t0
            trained = counts()
            paths = write_dngs("dng", n_images, SEED + 3,
                               dataset=SyntheticRawSegmentation)
            reset_counts()
            out = serving.main([
                "--experiment_name", "seg", "--run_name", "s",
                "--image_dir", "dng", "--dataset", "SyntheticDrone",
                "--batch_size", str(SERVE_BATCH), "--out", "pred.jsonl"])
            served = counts()
            raws = np.stack([load_image(p) / 65535.0 for p in paths])
            pred = Predictor.from_run("seg", "s",
                                      dataset_name="SyntheticDrone")
            masks = seg_masks(pred, raws, SERVE_BATCH)
            records = served_masks(out, paths, masks)
            rows["segmentation"] = seg["run"].read_metrics()
            for mode in ("neural_network", "none"):
                t0 = time.perf_counter()
                (res,) = cli.main(common + [
                    "--dataset", "SyntheticMicroscopy", "--processing_mode",
                    mode, "--run_name", mode])
                torch.cuda.synchronize()
                seconds[mode] = time.perf_counter() - t0
                rows[mode] = res["run"].read_metrics()
        finally:
            os.chdir(cwd)
    trained_pred = Predictor(copy.deepcopy(seg["state"].processor),
                             copy.deepcopy(seg["state"].classifier),
                             task="segmentation", device=device)
    err = float((seg_masks(trained_pred, raws, SERVE_BATCH)
                 - masks).abs().max())
    keys = {mode: [sorted(k for k in r if k not in ("time", "step"))
                   for r in got] for mode, got in rows.items()}
    emit({"phase": "seg_cli", "seconds": seconds, "metrics": rows,
          "train_launches": trained, "served_images": n_images,
          "served_launches": served,
          "mask_pixels": [r["mask_pixels"] for r in records][:8],
          "from_run_vs_trained_max_abs": err})
    check(keys["segmentation"] == [
        ["train_iou_score", "train_loss", "train_loss_aux"],
        ["val_iou_score", "val_loss"]], f"segmentation metrics {keys}")
    for mode in ("neural_network", "none"):
        check(keys[mode] == [
            ["train_accuracy", "train_loss", "train_loss_aux"],
            ["val_accuracy", "val_loss"]], f"{mode} metrics {keys}")
    check(all(np.isfinite(v) for got in rows.values() for r in got
              for k, v in r.items() if k not in ("time", "step")),
          "finite metrics")
    check(trained["fused_isp_fwd_train"] == 1
          and trained["fused_isp_bwd_res"] == 1,
          f"the segmentation run's one step launched {trained}")
    check(served == launches(fwd=-(-n_images // SERVE_BATCH)),
          f"serving the segmentation run launched {served}")
    check(err <= 1e-6, f"from_run masks vs the trained modules {err}")


def seg_train_runner(device, b, remat=False):
    """A segmentation train step at ``b`` through the ISP kernels (the
    U-Net++ with ``remat`` or not): a callable taking and ignoring one
    argument (for ``cuda_ms``)."""
    raw, y = seg_batch(device, b)
    proc, net = seg_modules(device, remat=remat)
    cfg = TrainConfig(task="segmentation", lr=TRAIN_LR)
    state = create_train_state(cfg, proc, net)
    step = make_train_step(cfg, proc, net)
    return lambda _: step(state, raw, y)


def seg_serve_runner(device, b):
    """``Predictor.__call__`` of the segmentation pair on ``b`` mosaics on
    the device, as ``seg_train_runner``."""
    raw, _ = seg_batch(device, b)
    pred = Predictor(*seg_modules(device), task="segmentation",
                     device=device)
    return lambda _: pred(raw)


def isp_train_runner(device, b, neural):
    """A train step at ``b`` of the neural ISP (or the identity ISP) in
    front of ResNet-18 as built, as ``seg_train_runner``."""
    raw, y = labelled_mosaics(device, b)
    proc = (NNProcessing(**mosaic_stats(), device=device,
                         generator=torch.Generator(device).manual_seed(SEED))
            if neural else RawToRGB(**mosaic_stats(), device=device))
    clf = train_classifier(device)
    cfg = TrainConfig(lr=TRAIN_LR)
    state = create_train_state(cfg, proc, clf)
    step = make_train_step(cfg, proc, clf)
    return lambda _: step(state, raw, y)


# what each timed step runs, and the launches of the port's kernels per
# call
SEG_TIMED = {
    "seg_train": (seg_train_runner,
                  {"fused_isp_fwd_train": 1, "fused_isp_bwd_res": 1}),
    "seg_train_remat": (lambda d, b: seg_train_runner(d, b, remat=True),
                        {"fused_isp_fwd_train": 1, "fused_isp_bwd_res": 1}),
    "seg_serve": (seg_serve_runner, {"fused_isp_fwd": 1}),
    "neural_train": (lambda d, b: isp_train_runner(d, b, True), {}),
    "identity_train": (lambda d, b: isp_train_runner(d, b, False), {})}


def timed_step(device, what, b):
    """CUDA-event ms of ``what`` at ``b`` (the mean of ``iters`` calls
    after the warm-ups), its launches per call, peak device memory, then its
    profile over ``profiled`` more calls (device ms by kernel, idle
    share); ``iters``, the warm-ups and ``profiled`` as SEG_TIMES says."""
    make, per_call = SEG_TIMED[what]
    iters, warm, profiled = ((10, 2, 2) if b <= SERVE_BATCH
                             else (BIG_ITERS, 1, 1))
    gc.collect()  # the last step's modules and batch, before the peak
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = make(device, b)
    reset_counts()
    ms = cuda_ms(run, [None] * warm, iters)
    seen = counts()
    peak = torch.cuda.max_memory_allocated()
    kernels, busy, wall_ms = profile_calls(run, None, profiled, warmups=0)
    ours = port_kernel_ms(kernels)
    row = {"phase": "seg_times", "what": what, "batch": b, "ms": ms,
           "timed_calls": iters, "profiled_calls": profiled,
           "imgs_per_s": b / ms * 1e3, "peak_memory_gib": peak / 2 ** 30,
           "device_memory_gib":
               torch.cuda.get_device_properties(0).total_memory / 2 ** 30,
           "launches": seen, "wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1 - busy / wall_ms,
           "port_kernels_device_ms": ours,
           "top_kernels_ms": [[k[1][:70], k[0], k[2]] for k in kernels[:10]]}
    emit(row)
    want = dict(launches(), **{k: n * (iters + warm)
                               for k, n in per_call.items()})
    check(seen == want, f"{what} at {b} launched {seen}")
    check(set(ours) == set(per_call), f"the {what} profile shows {ours}")
    return row


def phase_seg_times(device):
    """``timed_step`` of every step of SEG_TIMES."""
    return {(what, b): timed_step(device, what, b) for what, b in SEG_TIMES}


# --- evaluation: the corruption battery, the A/B and C tables -------------

def moved(draws, device):
    """The tensors of a draw dict (or list, tuple) on ``device``."""
    if isinstance(draws, torch.Tensor):
        return draws.to(device)
    if isinstance(draws, dict):
        return {k: moved(v, device) for k, v in draws.items()}
    if isinstance(draws, (list, tuple)):
        return type(draws)(moved(v, device) for v in draws)
    return draws


def eval_gates(device, rgb, severities=EVAL_SEVERITIES):
    """Each transform of EVAL_TRANSFORMS on ``rgb`` (B, 3, H, W) on the
    device in float32 against the port's float64 run on the CPU, on the
    same draws (made on the device from generators seeded per transform
    and severity): max abs difference by severity and the (H, W)
    positions past EVAL_TOL, which raise past what the gate allows.
    Returns one report per transform."""
    rgb64 = rgb.cpu().double()
    reports = []
    for k, name in enumerate(EVAL_TRANSFORMS):
        fn = CORRUPTIONS[name]
        errs, sites = {}, 0
        for sev in severities:
            seed = SEED + 100 * k + sev
            draws = fn.draw(rgb, sev, torch.Generator(device).manual_seed(
                seed), np.random.default_rng(seed))
            got = fn.apply(rgb, sev, **draws)
            want = fn.apply(rgb64, sev, **moved(draws, "cpu"))
            check(got.shape == rgb.shape and got.dtype == torch.float32
                  and want.dtype == torch.float64
                  and bool(torch.isfinite(got).all()), f"{name} output")
            err = (got.cpu().double() - want).abs()
            errs[sev] = float(err.max())
            sites = max(sites, int((err > EVAL_TOL).flatten(0, 1).any(0)
                                   .sum()))
        reports.append({"transform": name, "max_abs_by_severity": errs,
                        "positions_past_tol": sites})
        allowed = EVAL_SPATTER_SITES if name == "spatter" else 0
        check(sites <= allowed, f"{name} on the card against float64: "
                                f"{errs}, {sites} positions past {EVAL_TOL}")
    return reports


def without_sync(fn, *args):
    """``fn(*args)`` once, then again with torch's sync debug mode raising
    on any wait of the host for the card (on the card only); returns the
    second call's result."""
    fn(*args)
    if args[1].device.type != "cuda":
        return fn(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def eval_classifier(device, seed=SEED):
    """A seeded full-width ResNet-18 of SyntheticMicroscopy's 2 classes, in
    eval mode, on the plain stem (a checkpoint of it that the evaluation
    loads routes its stem by the input)."""
    return resnet_model("resnet18", fc_out_features=2, device=device,
                        generator=torch.Generator(device).manual_seed(seed),
                        stem_kernel=False).eval()


def eval_cell_gates(device, raw, n_logits=8):
    """The cell programs on the card: the identity program in graph
    (static pipeline, normalisation, classifier) on ``n_logits`` mosaics
    against the port's float64 run on the CPU; and each of them (in graph
    for identity; on precomputed RGB for every corruption of the C table
    at severity 3) run without a host synchronisation. Returns a
    report."""
    ab = ABTesting("SyntheticMicroscopy", batch_size=len(raw), device=device)
    ab64 = ABTesting("SyntheticMicroscopy", device="cpu")
    clf = eval_classifier(device)
    clf64 = copy.deepcopy(clf).cpu().double()
    x = raw[:n_logits]
    logits = without_sync(ab._run_for("resnet18", *EVAL_PIPELINE), clf, x,
                          torch.Generator(device).manual_seed(SEED))
    logits64 = ab64._run_for("resnet18", *EVAL_PIPELINE)(
        clf64, x.cpu().double(), torch.Generator().manual_seed(SEED))
    err = float((logits.cpu().double() - logits64).abs().max())
    with torch.no_grad():
        rgb = static_pipeline(*EVAL_PIPELINE)(raw)
    for corr in CORRUPTION_LIST:
        out = without_sync(ab._run_for_rgb("resnet18", corr, 3), clf, rgb,
                           torch.Generator(device).manual_seed(SEED))
        check(out.shape == (len(raw), 2) and bool(torch.isfinite(out).all()),
              f"the {corr} cell program's logits")
    check(err <= EVAL_LOGIT_TOL, f"identity cell program against float64 "
                                 f"{err}")
    return {"identity_logits_vs_float64_max_abs": err,
            "logits_abs_max": float(logits64.abs().max()),
            "logit_tol": EVAL_LOGIT_TOL,
            "programs_without_sync": ["identity in graph"] + [
                f"{c} s3 on RGB" for c in CORRUPTION_LIST]}


def phase_eval_gates(device, batch=SERVE_BATCH, size=SIZE):
    """``eval_gates`` on the microscopy static pipeline's RGB of ``batch``
    SyntheticMicroscopy mosaics, then ``eval_cell_gates``; no kernel of
    the port launches."""
    t0 = time.perf_counter()
    raw, _ = labelled_mosaics(device, batch, size)
    reset_counts()
    with torch.no_grad():
        rgb = static_pipeline(*EVAL_PIPELINE)(raw)
    for rep in eval_gates(device, rgb):
        emit({"phase": "eval_gates", "shape": [batch, 3, size, size],
              "tol": EVAL_TOL, **rep})
    emit({"phase": "eval_gates", **eval_cell_gates(device, raw)})
    check(counts() == launches(), f"the battery launched {counts()}")
    emit({"phase": "eval_gates", "seconds": time.perf_counter() - t0})


@contextlib.contextmanager
def recorded(cls, name):
    """While the block runs, each call of ``cls.name`` is recorded in the
    list it yields: (keyword arguments, wall seconds)."""
    calls, orig = [], getattr(cls, name)

    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = orig(*args, **kwargs)
        calls.append((kwargs, time.perf_counter() - t0))
        return out

    setattr(cls, name, wrapper)
    try:
        yield calls
    finally:
        setattr(cls, name, orig)


def direct_metrics(device, clf, dataset, indices, pipeline):
    """The classifier evaluated directly on ``dataset``'s ``indices`` behind
    ``pipeline`` (one batch): its confusion metrics and least |logit
    margin|."""
    raw = torch.as_tensor(np.stack([dataset[i][0] for i in indices]),
                          device=device)
    stats = dataset_stats("SyntheticMicroscopy")
    mean, std = (torch.tensor(stats[k], device=device).reshape(3, 1, 1)
                 for k in ("mean", "std"))
    with torch.no_grad():
        logits = clf.eval()((pipeline(raw) - mean) / std).cpu().numpy()
    cm = ConfusionMetrics(2)
    cm.update(logits.argmax(-1), [dataset[i][1] for i in indices])
    return cm.summary(), float(np.abs(logits[:, 0] - logits[:, 1]).min())


EVAL_CLI_RUNS = (("bilinear", "sharpening_filter", "gaussian_denoising"),
                 ("menon2007", "unsharp_masking", "median_denoising"))


def phase_eval_cli(device, batch=SERVE_BATCH):
    """Through the CLIs on the card, in a temporary directory: a 1-epoch
    static --test_run for each of EVAL_CLI_RUNS, then
    ``raw2logit_tpu_torch.figures.ABtesting`` with ABMakeTable (2 rows x
    12 columns) and CMakeTable (2 rows x 11 corruptions x 5 severities)
    over their classifiers (--checkpoints_json) and a run's
    state_dict.json. Every cell present and finite; each diagonal
    identity cell equal to its classifier evaluated directly on the valid
    set; a second invocation computes no cell; --N_runs 1 discards the A/B
    table; no kernel of the port launched."""
    from raw2logit_tpu_torch.figures import ABtesting as ab_cli
    from raw2logit_tpu_torch.training import train as cli
    cwd = os.getcwd()
    seconds, cells = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_counts()
            t0 = time.perf_counter()
            runs = {}
            for pip in EVAL_CLI_RUNS:
                with contextlib.redirect_stdout(io.StringIO()):
                    (runs[pip],) = cli.main([
                        "--dataset", "SyntheticMicroscopy",
                        "--processing_mode", "static", "--sp_debayer",
                        pip[0], "--sp_sharpening", pip[1], "--sp_denoising",
                        pip[2], "--test_run", "--epochs", "1",
                        "--batch_size", str(batch), "--n_splits", "1",
                        "--experiment_name", "eval", "--run_name",
                        pipeline_name(*pip)])
            seconds["train"] = time.perf_counter() - t0
            ckpts = {pipeline_name(*pip): [os.path.abspath(os.path.join(
                res["run"].dir, "checkpoints", "classifier.pt"))]
                for pip, res in runs.items()}
            with open("ckpts.json", "w") as fh:
                json.dump(ckpts, fh)
            state_dict = os.path.join(next(iter(runs.values()))["run"].dir,
                                      "state_dict.json")
            common = ["--dataset_name", "SyntheticMicroscopy",
                      "--checkpoints_json", "ckpts.json", "--state_dict",
                      state_dict, "--out_dir", "abt"]
            for what, mode, extra in (
                    ("ab", "ABMakeTable", []), ("c", "CMakeTable", []),
                    ("ab_again", "ABMakeTable", []),
                    ("c_again", "CMakeTable", []),
                    ("ab_n_runs_1", "ABMakeTable", ["--N_runs", "1"])):
                t0 = time.perf_counter()
                with recorded(ABTesting, "evaluate_runs") as calls, \
                        contextlib.redirect_stdout(io.StringIO()):
                    ab_cli.main(["--mode", mode] + common + extra)
                seconds[what] = time.perf_counter() - t0
                cells[what] = len(calls)
            seen = counts()
            tables = {}
            for which in ("AB", "C"):
                with open(f"abt/tables/{which}table_SyntheticMicroscopy_"
                          f"weak.json") as fh:
                    tables[which] = json.load(fh)
            with open(state_dict) as fh:
                valid = json.load(fh)["valid_indices"]
        finally:
            os.chdir(cwd)
    ab, c = tables["AB"], tables["C"]
    rows = [pipeline_name(*pip) for pip in runs]
    want_ab = {f"{t}__VS__{pipeline_name(*e)}" for t in rows
               for e in pipeline_grid()}
    want_c = {f"{t}__{corr}__s{sev}" for t in rows
              for corr in CORRUPTION_LIST for sev in range(1, 6)}
    finite = all(np.isfinite(v) for table in (ab, c)
                 for k, cell in table.items() if k != "_meta"
                 for v in cell.values())
    dataset = abtesting.get_dataset("SyntheticMicroscopy")  # the CLI's
    diagonal = {}
    for pip, res in runs.items():
        name = pipeline_name(*pip)
        got, margin = direct_metrics(device, res["state"].classifier,
                                     dataset, valid, static_pipeline(*pip))
        cell = ab[f"{name}__VS__{name}"]
        diagonal[name] = {"direct": got, "least_margin": margin,
                          "equal": all(cell[f"{k}_mean"] == v
                                       for k, v in got.items())}
    emit({"phase": "eval_cli", "seconds": seconds, "cells_computed": cells,
          "ab_cells": len(ab) - 1, "c_cells": len(c) - 1,
          "ab_meta": ab["_meta"], "valid_images": len(valid),
          "diagonal": diagonal, "launches": seen})
    check(set(ab) - {"_meta"} == want_ab and set(c) - {"_meta"} == want_c
          and finite, "every cell present and finite")
    check(cells == {"ab": 24, "c": 110, "ab_again": 0, "c_again": 0,
                    "ab_n_runs_1": 24}, f"cells computed {cells}")
    check(ab["_meta"]["n_runs"] == 1, f"the A/B table's _meta {ab['_meta']}")
    check(all(d["equal"] for d in diagonal.values()),
          f"diagonal cells against the classifiers {diagonal}")
    check(routed_stem(seen) == launches(),
          f"the evaluation CLI launched {seen}")


class InMemory:
    """A dataset's mosaics and labels held in host memory (made once,
    outside the timed tables, as a decoded dataset would be)."""

    def __init__(self, dataset):
        self.x = np.stack([dataset[i][0] for i in range(len(dataset))])
        self.labels = list(dataset.labels)
        self.task, self.classes = dataset.task, dataset.classes
        self.camera_parameters = dataset.camera_parameters

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.labels[i]


def phase_eval_times(device, n=EVAL_N, batches=EVAL_BATCHES, rows=None):
    """The tables as a user pays for them, at each of ``batches``: the full
    A/B table (12 x 12; its first EVAL_BIG_ROWS rows above B = 32) and
    the C table of one row (11 x 5) at one fold
    over 12 seeded ResNet-18s written with ``save_module``, on ``n``
    SyntheticMicroscopy mosaics held in memory, the CLI's valid split.
    Wall seconds split into the precomputes and the cell programs;
    images/s of each C cell (by corruption at severity 3); peak device
    memory; launch counts 0; then the profiles of the identity cell and of
    one precompute. ``rows`` limits the A/B rows (a CPU rehearsal)."""
    t0 = time.perf_counter()
    dataset = InMemory(SyntheticRawClassification(n=n))
    data_s = time.perf_counter() - t0
    (_, valid), = k_fold(dataset, n_splits=1, seed=1, train_size=0.8)
    valid = [int(i) for i in valid]
    grid = pipeline_grid()[:rows]
    with tempfile.TemporaryDirectory() as tmp:
        ckpts = {pipeline_name(*p): [save_module(
            eval_classifier(device, seed=SEED + i),
            os.path.join(tmp, str(i), "classifier.pt"))]
            for i, p in enumerate(grid)}
        for b in batches:
            ab_rows = dict(list(ckpts.items())[:None if b <= SERVE_BATCH
                                               else EVAL_BIG_ROWS])
            ab = ABTesting("SyntheticMicroscopy", batch_size=b, device=device)
            ab.dataset = dataset
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            row = {"phase": "eval_times", "batch": b, "images": n,
                   "ab_rows": len(ab_rows),
                   "valid_images": len(valid), "dataset_seconds": data_s}
            for table in ("ab", "c"):
                with recorded(abtesting, "precompute_pipeline_rgb") as pre, \
                        recorded(ABTesting, "evaluate_runs") as cells, \
                        contextlib.redirect_stdout(io.StringIO()):
                    t0 = time.perf_counter()
                    if table == "ab":
                        ab.ab_make_table(ab_rows, valid, os.path.join(
                            tmp, f"ab{b}.json"))
                    else:
                        ab.c_make_table(dict([next(iter(ckpts.items()))]),
                                        valid, os.path.join(tmp, f"c{b}.json"))
                    wall = time.perf_counter() - t0
                pre_s = sum(s for _, s in pre)
                row.update({
                    f"{table}_cells": len(cells),
                    f"{table}_wall_seconds": wall,
                    f"{table}_precomputes": len(pre),
                    f"{table}_precompute_seconds": pre_s,
                    f"{table}_cell_program_seconds": wall - pre_s,
                    f"{table}_cell_images_per_s":
                        len(cells) * len(valid) / (wall - pre_s)})
            # the C table's cells (the precompute runs in a column's first
            # cell: at severity 3 each cell is its program alone)
            row["c_images_per_s_s3"] = {
                kw["corruption"]: len(valid) / s for kw, s in cells
                if kw["severity"] == 3}
            row["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
            row["launches"] = counts()
            emit(row)
            check(routed_stem(row["launches"]) == launches(),
                  f"the tables launched {row['launches']}")
            check(row["ab_cells"] == len(ab_rows) * 12
                  and row["c_cells"] == 55,
                  f"cells computed {row['ab_cells']}, {row['c_cells']}")
            (path,) = next(iter(ckpts.values()))
            clf = ab.load_model(path)
            rgb = ab._pipeline_rgb(*grid[0])
            run = ab._run_for_rgb("resnet18")
            profile_without_port_kernels(
                "eval_profile", "identity_cell", b,
                lambda _: ab._evaluate_with(run, clf, valid, rgb_all=rgb),
                calls=3, warmups=1, allowed=STEM_KERNELS[:2])
            profile_without_port_kernels(
                "eval_profile", "precompute", b,
                lambda _: precompute_pipeline_rgb(
                    dataset, static_pipeline(*grid[0]), b, device=device),
                calls=1, warmups=1)
        phase_eval_padding(device, dataset, valid, rgb, path)


def phase_eval_padding(device, dataset, valid, rgb, path, turns=4):
    """The B = 256 table's identity cell as the port runs it (its
    ``len(valid)`` images in one batch) and as JAX runs it (the batch
    padded to BIG_BATCH with copies of its first image), in turns after
    one warm-up each: wall ms of each."""
    ab = ABTesting("SyntheticMicroscopy", batch_size=BIG_BATCH,
                   device=device)
    ab.dataset = dataset
    clf, run = ab.load_model(path), ab._run_for_rgb("resnet18")
    cells = {"unpadded": valid, "padded_as_jax":
             valid + [valid[0]] * (BIG_BATCH - len(valid))}
    ms = {what: [] for what in cells}
    for turn in range(turns + 1):
        for what, idx in cells.items():
            t0 = time.perf_counter()
            ab._evaluate_with(run, clf, idx, rgb_all=rgb)
            if turn:  # the first turn warms up
                ms[what].append((time.perf_counter() - t0) * 1e3)
    emit({"phase": "eval_padding", "valid_images": len(valid),
          "batch": BIG_BATCH, "identity_cell_ms": ms})


# --------------------------------------------------------------------------
# the experiment drivers, the sweep, the demo app, data parallelism, and
# the spatial and pipeline axes

REPO = os.path.dirname(os.path.abspath(__file__))
# the drivers' example run: the CLI's SyntheticMicroscopy (n = 64,
# 256x256) at B = 32 with the fused kernels
EXAMPLE_BATCH = 32
# A 3000x4000 drone frame (the full frames of parallel/spatial.py's
# docstring), smooth with noise, at the drone camera's levels.
DRONE_FRAME = (3000, 4000)
# Process-group step against the one-process step on the same 64 images
# on the card (TF32 off), relative: the loss, and the abs-sums of the
# ISP's and the classifier's parameters after Adam, at 1e-6 as
# tests/test_distributed.py holds JAX; the BN running statistics (max
# |difference| over max |statistic| of each buffer) at 1e-5: the ranks'
# statistics are float64 sums over their halves, the one-process step's
# cuDNN's float32 reduction over the whole batch.
DP_LOSS_REL, DP_PARAM_REL, DP_STATS_REL = 1e-6, 1e-6, 1e-5
# The parameter gradients. Adam's first update is about lr sign(g), so
# the abs-sums above cannot see a gradient's scale; a gradient counted
# twice (no 1 / N, a second all-reduce, the BN's weight and bias given
# the summed value) reads 1 on the leaves it reaches (|g - want| / |want|
# over the leaf, L2 norms; ``grad_rel``). The float32 step is
# ill-conditioned on the card (phase_train: a 1e-7 nudge of the inputs
# moves the ISP's gradients by up to 5%), so each rank's all-reduced
# gradient is held, leaf by leaf, against the one-process step in
# float64 through the plain paths (``dp_reference``): within DP_GRAD_REL
# or STEP_F64_FACTOR times the farther of the one-process float32 step
# and its nudged twin from it, whichever is larger.
DP_GRAD_REL = 1e-3
DP_BATCH = 64
DP_TIMED = 5  # steps timed after the compared one
# a block of rows against the whole frame (tests/test_spatial.py's 1e-6)
SPLIT_TOL = 1e-6


def _committed_keys(name):
    with open(os.path.join(REPO, "results", name)) as fh:
        return set(json.load(fh))


def phase_examples(device, batch=EXAMPLE_BATCH):
    """The three drivers of ``raw2logit_tpu_torch.examples`` in a temporary
    directory, with ``--use_pallas``: drift forensics on gamma (1 epoch of
    pretraining, 2 of attack: kernels 1, 2, 3 and 5 launched, every ISP
    parameter but gamma drifting by exactly 0.0, the committed JAX
    artifact's fields), drift optimisation (1 epoch per arm: kernels 1-3,
    the artifact's fields), and the drift cycle with one training
    pipeline and its 1 x 12 A/B table (finite; the heatmap needs
    matplotlib, which the card's machine lacks)."""
    from raw2logit_tpu_torch.examples import (drift_cycle, drift_forensics,
                                              drift_optimization)
    out, seconds, seen = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
            contextlib.redirect_stdout(io.StringIO()):
        reset_counts()
        t0 = time.perf_counter()
        (out["forensics"],) = drift_forensics.run_forensics(
            targets=("gamma_correct",), pre_epochs=1, adv_epochs=2,
            batch_size=batch, out_dir="out", extra=["--use_pallas"])
        torch.cuda.synchronize()
        seconds["forensics"] = time.perf_counter() - t0
        seen["forensics"] = counts()
        reset_counts()
        t0 = time.perf_counter()
        out["optimization"] = drift_optimization.run_optimization(
            epochs=1, batch_size=batch, out_dir="out",
            extra=["--use_pallas"])
        torch.cuda.synchronize()
        seconds["optimization"] = time.perf_counter() - t0
        seen["optimization"] = counts()
        reset_counts()
        t0 = time.perf_counter()
        summary = drift_cycle.run_cycle(
            train_pipelines=[EVAL_PIPELINE], epochs=1, batch_size=batch,
            table_path="tables/ab.json", device=device,
            test_pipelines=pipeline_grid(), heatmap=False)
        seconds["cycle"] = time.perf_counter() - t0
        seen["cycle"] = counts()
        with open(summary["table_path"]) as fh:
            table = json.load(fh)
    report = out["forensics"]
    cells = {k: v for k, v in table.items() if k != "_meta"}
    emit({"phase": "examples", "seconds": seconds, "launches": seen,
          "forensics": {k: report[k] for k in (
              "baseline_val_accuracy", "val_accuracy_per_epoch",
              "aux_ssim_per_epoch", "param_drift_relmax", "selected_epoch",
              "selection_replay_match")},
          "optimization": {k: out["optimization"][k] for k in (
              "frozen_val_loss", "joint_val_loss", "joint_better")},
          "cycle": {"cells": len(cells), "matched_acc":
                    summary["matched_acc"], "swapped_acc":
                    summary["swapped_acc"]}})
    for run, kernels in (("forensics", ("fused_isp_fwd", "fused_isp_fwd_train",
                                        "fused_isp_bwd_res", "ssim_aux")),
                         ("optimization", ("fused_isp_fwd",
                                           "fused_isp_fwd_train",
                                           "fused_isp_bwd_res"))):
        check(all(seen[run][k] > 0 for k in kernels),
              f"the {run} driver launched {seen[run]}")
    drift = report["param_drift_relmax"]
    check(drift["gamma_correct"] > 0 and all(
        v == 0.0 for k, v in drift.items() if k != "gamma_correct"),
        f"the targeted attack's drift {drift}")
    check(set(report) == _committed_keys("forensics_gamma_correct.json")
          and set(out["optimization"]) == _committed_keys(
              "drift_optimization.json"), "the reports' fields")
    check(len(cells) == 12 and all(np.isfinite(v) for c in cells.values()
                                   for v in c.values()),
          f"the cycle's A/B table {cells}")


def phase_sweep(device, batch=SERVE_BATCH):
    """``python -m raw2logit_tpu_torch.training.sweep --shard 0 --n_shards
    12 --epochs 1`` on SyntheticMicroscopy (one fold, B = 32): one job of
    the 12-pipeline grid, the training CLI in a subprocess on the card.
    The manifest holds the job; a --resume run trains nothing; the
    evaluation CLI's ABMakeTable over the manifest fills that row."""
    from raw2logit_tpu_torch.figures import ABtesting as ab_cli
    cmd = [sys.executable, "-m", "raw2logit_tpu_torch.training.sweep",
           "--shard", "0", "--n_shards", "12", "--epochs", "1",
           "--datasets", "SyntheticMicroscopy", "--n_splits", "1",
           "--batch_size", str(batch), "--out", "manifest.json"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    seconds = {}
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        t0 = time.perf_counter()
        first = subprocess.run(cmd, env=env, capture_output=True, text=True)
        seconds["sweep"] = time.perf_counter() - t0
        check(first.returncode == 0, f"the sweep: {first.stderr[-2000:]}")
        with open("manifest.json") as fh:
            manifest = json.load(fh)
        t0 = time.perf_counter()
        again = subprocess.run(cmd + ["--resume"], env=env,
                               capture_output=True, text=True)
        seconds["resume"] = time.perf_counter() - t0
        check(again.returncode == 0, f"the resume: {again.stderr[-2000:]}")
        t0 = time.perf_counter()
        with recorded(ABTesting, "evaluate_runs") as calls, \
                contextlib.redirect_stdout(io.StringIO()):
            ab_cli.main(["--mode", "ABMakeTable", "--dataset_name",
                         "SyntheticMicroscopy", "--checkpoints_json",
                         "manifest.json", "--batch_size", str(batch),
                         "--out_dir", "abt"])
        seconds["ab_table"] = time.perf_counter() - t0
        with open("abt/tables/ABtable_SyntheticMicroscopy_weak.json") as fh:
            table = json.load(fh)
    (job,) = manifest["jobs"]
    row = {k: v for k, v in table.items() if k != "_meta"}
    emit({"phase": "sweep", "seconds": seconds, "job": job["run_name"],
          "returncode": job["returncode"],
          "checkpoints": manifest["checkpoints"],
          "resume_stdout": again.stdout.strip().splitlines(),
          "cells": len(calls)})
    check(job["returncode"] == 0 and list(manifest["checkpoints"]) == [
        job["pipeline"]], f"the manifest {manifest}")
    check("skip (done)" in again.stdout
          and sweep_trained(again.stdout) == 0,
          f"the resume trained: {again.stdout}")
    check(len(row) == 12 and all(k.startswith(job["pipeline"] + "__VS__")
                                 and np.isfinite(v["accuracy_mean"])
                                 for k, v in row.items()),
          f"the table's row {sorted(row)}")


def sweep_trained(stdout):
    """The jobs a sweep's output says it started."""
    return sum(" -m raw2logit_tpu_torch.training.train " in ln
               for ln in stdout.splitlines())


def drone_frames(n, shape=DRONE_FRAME, seed=SEED):
    """``n`` smooth drone-like mosaics with noise, in [0.02, 0.9]."""
    rng = np.random.default_rng((seed, n) + shape)
    h, w = shape
    y = np.linspace(0, 1, h, dtype=np.float32)[:, None]
    x = np.linspace(0, 1, w, dtype=np.float32)[None, :]
    frames = [np.clip(0.45 + 0.3 * np.sin(9 * x + 3 * k) * np.cos(7 * y + k)
                      + rng.normal(0, 0.03, shape).astype(np.float32),
                      0.02, 0.9) for k in range(n)]
    return torch.as_tensor(np.stack(frames), dtype=torch.float32)


def app_gate(device, raw, camera):
    """``app.process`` of one mosaic on the card against the port's float64
    CPU run of its pipeline (the app's defaults), with the static gates'
    tolerances: the card's image before gamma within STATIC_PRE_TOL, the
    app's output within STATIC_FINAL_TOL plus gamma's slope times the
    pixel's own pre-gamma difference."""
    from raw2logit_tpu_torch import app
    params = app.CAMERAS[camera]
    pipe = ("bilinear", "sharpening_filter", "gaussian_denoising")
    t0 = time.perf_counter()
    got = torch.as_tensor(app.process(raw.numpy(), camera=camera,
                                      device=device)).permute(2, 0, 1)
    card_s = time.perf_counter() - t0
    pre = filter_stage(camera_stage(raw[None].to(device), *params, pipe[0]),
                       *pipe[1:])[0].cpu().double()
    pre64 = filter_stage(camera_stage(raw[None].double(), *params, pipe[0]),
                         *pipe[1:])[0]
    final64 = adjust_gamma(pre64, STATIC_GAMMA)
    pre_err = (pre - pre64).abs()
    final_err = (got.double() - final64).abs()
    over = float((final_err / final_tolerance(pre, pre64, pre_err)).max())
    rep = {"camera": camera, "shape": list(raw.shape), "card_seconds": card_s,
           "pre_gamma_max_abs_err": float(pre_err.max()),
           "final_max_abs_err": float(final_err.max()),
           "final_max_err_over_tol": over}
    check(rep["pre_gamma_max_abs_err"] <= STATIC_PRE_TOL and over <= 1.0,
          f"app.process on the card against float64: {rep}")
    return rep


def phase_app(device):
    """``app.process`` on the card for a 256x256 microscopy mosaic and a
    3000x4000 drone frame against the float64 CPU run; the HTTP demo
    served from a thread: the GET form, and a POST's error reply (PIL,
    which a POST's upload needs, is not on the card's machine)."""
    import urllib.error
    import urllib.request
    import threading
    from raw2logit_tpu_torch import app
    raw, _ = labelled_mosaics(torch.device("cpu"), 1)
    reports = [app_gate(device, raw[0], "Microscope"),
               app_gate(device, drone_frames(1)[0], "Drone")]
    server = app.make_server(port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        base = f"http://127.0.0.1:{server.server_port}"
        page = urllib.request.urlopen(f"{base}/", timeout=30).read()
        req = urllib.request.Request(
            f"{base}/process", data=b"--x--\r\n",
            headers={"Content-Type": "multipart/form-data; boundary=x"})
        try:
            urllib.request.urlopen(req, timeout=30)
            code = 200
        except urllib.error.HTTPError as e:
            code = e.code
    finally:
        server.shutdown()
        server.server_close()
    controls = all(c in page for c in (b"RawImage", b"menon2007",
                                       b"unsharp_masking", b"fft_denoising",
                                       b"Drone"))
    emit({"phase": "app", "gates": reports, "get_form": controls,
          "bad_post_status": code})
    check(controls and code == 400, f"the HTTP demo: form {controls}, "
                                    f"bad POST {code}")


def grad_rel(got, want):
    """(the largest over the parameters of |got - want| / |want|, L2 norms
    of the leaf's gradient; that parameter's name). Parameters with a
    gradient in only one of the two read infinity."""
    if got.keys() != want.keys():
        return float("inf"), sorted(set(got) ^ set(want))
    worst = (0.0, None)
    for k, w in want.items():
        w = w.double()
        gap = (float((got[k].double() - w).norm())
               / max(float(w.norm()), 1e-30))
        worst = max(worst, (gap, k), key=lambda t: t[0])
    return worst


def dp_grad_gaps(ranks, one, nudged, f64):
    """The ranks' gradients (a list of ``grads``) against the one-process
    step's, and against the float64 step's beside the one-process float32
    step and its nudged twin; ``ok`` if every rank is within the limit
    (DP_GRAD_REL)."""
    vs64 = {"ranks": [grad_rel(g, f64) for g in ranks],
            "one": grad_rel(one, f64), "nudged": grad_rel(nudged, f64)}
    limit = max(DP_GRAD_REL, STEP_F64_FACTOR * max(vs64["one"][0],
                                                   vs64["nudged"][0]))
    return {"vs_one": [grad_rel(g, one) for g in ranks],
            "vs_float64": vs64, "limit": limit,
            "ok": all(gap <= limit for gap, _ in vs64["ranks"])}


def module_grads(*named):
    """Each parameter's ``.grad`` on the host, by "<prefix>.<name>", of
    ``named`` (prefix, module) pairs."""
    return {f"{w}.{n}": p.grad.detach().cpu() for w, m in named
            for n, p in m.named_parameters() if p.grad is not None}


def dp_reference(device, batch=DP_BATCH, size=SIZE):
    """``dp_step``'s one-process step from the same weights and images, its
    parameter gradients only: in float64 through the plain paths (under
    "float64"; the stem flag changes only the path), and in float32
    through the kernels on the images nudged by 1e-7 relative, with the
    stem flag off and on ("nudged_stem0", "nudged_stem1")."""
    raw, y = labelled_mosaics(device, batch, size)
    gen = torch.Generator(device).manual_seed(SEED)
    nudged = raw * (1 + 1e-7 * torch.randn(raw.shape, device=device,
                                           generator=gen))
    out = {}
    for name, stem, x, dtype in (
            ("float64", False, raw, torch.float64),
            ("nudged_stem0", False, nudged, torch.float32),
            ("nudged_stem1", True, nudged, torch.float32)):
        proc = processor(device, use_kernel=dtype == torch.float32)
        proc = proc.train().to(dtype)
        clf = train_classifier(device, "perturbed").to(dtype)
        clf.stem_kernel = stem
        cfg = TrainConfig(lr=1e-3)
        state = create_train_state(cfg, proc, clf)
        make_train_step(cfg, proc, clf)(state, x.to(dtype), y)
        out[name] = module_grads(("isp", proc), ("clf", clf))
    return out


@contextlib.contextmanager
def counted_all_reduce(sizes):
    """Append the element count of every ``torch.distributed.all_reduce``
    made inside the block to ``sizes``."""
    import torch.distributed as dist
    real = dist.all_reduce

    def counted(t, *args, **kwargs):
        sizes.append(t.numel())
        return real(t, *args, **kwargs)
    dist.all_reduce = counted
    try:
        yield
    finally:
        dist.all_reduce = real


def dp_step(device, stem, batch=DP_BATCH, size=SIZE, grads=None):
    """One train step (the perturbed ISP through the kernels, the perturbed
    ResNet-18, Adam at lr 1e-3) on this process's rows of ``batch``
    seeded mosaics: its loss and accuracy, the parameters' abs-sums after
    Adam, the BN running statistics, the launches and the all-reduces;
    then the mean wall ms of DP_TIMED more steps. ``grads``, a dict,
    receives the step's parameter gradients (on the host)."""
    raw, y = labelled_mosaics(device, batch, size)
    proc = processor(device, use_kernel=True).train()
    clf = train_classifier(device, "perturbed")
    clf.stem_kernel = stem
    cfg = TrainConfig(lr=1e-3)
    state = create_train_state(cfg, proc, clf)
    step = make_train_step(cfg, proc, clf)
    raw, y = distributed.shard(raw), distributed.shard(y)
    reduced = []
    reset_counts()
    with counted_all_reduce(reduced):
        mets = step(state, raw, y)
    seen = counts()
    if grads is not None:
        grads.update(module_grads(("isp", proc), ("clf", clf)))

    def abssum(m):
        return float(sum(p.detach().double().abs().sum()
                         for p in m.parameters()))
    out = {"loss": float(mets["loss"]), "accuracy": float(mets["accuracy"]),
           "isp_abs_sum": abssum(proc), "clf_abs_sum": abssum(clf),
           "stats": {f"{w}.{n}": b.double().cpu().tolist()
                     for w, m in (("isp", proc), ("clf", clf))
                     for n, b in m.named_buffers() if "running" in n},
           "launches": seen, "all_reduces": len(reduced),
           "all_reduced_floats": sum(reduced)}
    # then the wall ms of a step: DP_TIMED more steps on the same state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_TIMED):
        mets = step(state, raw, y)
    float(mets["loss"])
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) * 1e3 / DP_TIMED
    return out


def dp_rank(rank, port, out_dir, kind="cuda", batch=DP_BATCH, size=SIZE):
    """A rank of the two-rank gloo group on cuda:0 (or the CPU for
    ``kind`` cpu): gloo's all_reduce and broadcast on the device's
    tensors first, then ``dp_step`` with the stem flag off and on; the
    reports go to ``out_dir``/<rank>.json, the gradients to <rank>.pt."""
    import torch.distributed as dist
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(kind, 0) if kind == "cuda" else torch.device(kind)
    distributed.initialize(f"127.0.0.1:{port}", 2, rank, "gloo")
    try:
        t = torch.full((4,), rank + 1.0, device=device)
        dist.all_reduce(t)
        b = torch.full((2,), float(rank), device=device)
        dist.broadcast(b, 0)
        ok = bool((t == 3).all()) and bool((b == 0).all())
        dp_step(device, False, 8, size)  # warm-up: cuDNN, the libraries
        grads = {"stem0": {}, "stem1": {}}
        out = {"gloo_on_cuda": ok, **{c: dp_step(
            device, c == "stem1", batch, size, g) for c, g in grads.items()}}
    finally:
        distributed.shutdown()
    with open(os.path.join(out_dir, f"{rank}.json"), "w") as fh:
        json.dump(out, fh)
    torch.save(grads, os.path.join(out_dir, f"{rank}.pt"))


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def stats_rel(got, want):
    """The largest over the BN buffers of max |difference| / max |want|."""
    worst = 0.0
    for k, w in want.items():
        w, g = np.asarray(w), np.asarray(got[k])
        worst = max(worst, float(np.abs(g - w).max())
                    / max(float(np.abs(w).max()), 1e-30))
    return worst


def phase_data_parallel(device, batch=DP_BATCH, size=SIZE):
    """Two ranks on the one card (both cuda:0; gloo, whose all_reduce and
    broadcast take CUDA tensors, where NCCL refuses two ranks on one
    device), started by torch.multiprocessing: one train step at global
    B = 64, 256x256, with the stem flag off and on, against the
    one-process step on the same 64 images, its parameter gradients
    against the float64 step's (``DP_*``). Then one CLI
    training with --n_devices 1 under an initialised NCCL group of one,
    which must call no collective."""
    import torch.distributed as dist
    import torch.multiprocessing as mp
    dp_step(device, False, 8, size)  # warm-up
    one_grads = {"stem0": {}, "stem1": {}}
    one = {c: dp_step(device, c == "stem1", batch, size, g)
           for c, g in one_grads.items()}
    ref = dp_reference(device, batch, size)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(dp_rank, args=(free_port(), tmp, device.type,
                                          batch, size),
                           nprocs=2, start_method="spawn")
        ranks, rank_grads = [], []
        for r in range(2):
            with open(os.path.join(tmp, f"{r}.json")) as fh:
                ranks.append(json.load(fh))
            rank_grads.append(torch.load(os.path.join(tmp, f"{r}.pt")))
    spawn_s = time.perf_counter() - t0
    rows = {}
    for case in ("stem0", "stem1"):
        want, r0, r1 = one[case], ranks[0][case], ranks[1][case]
        rows[case] = {
            "loss_rel": abs(r0["loss"] - want["loss"]) / abs(want["loss"]),
            "accuracy": [r0["accuracy"], want["accuracy"]],
            "isp_abs_sum_rel": abs(r0["isp_abs_sum"] - want["isp_abs_sum"])
            / want["isp_abs_sum"],
            "clf_abs_sum_rel": abs(r0["clf_abs_sum"] - want["clf_abs_sum"])
            / want["clf_abs_sum"],
            "stats_rel": stats_rel(r0["stats"], want["stats"]),
            # each rank's gradient against the one process's and the
            # float64 step's, each with the leaf that is furthest
            "grads": dp_grad_gaps([g[case] for g in rank_grads],
                                  one_grads[case], ref[f"nudged_{case}"],
                                  ref["float64"]),
            "grad_leaves": len(one_grads[case]),
            "rank_all_reduces": [r0["all_reduces"],
                                 r0["all_reduced_floats"]],
            "ranks_equal": {k: r0[k] == r1[k] for k in (
                "loss", "isp_abs_sum", "clf_abs_sum", "stats")},
            "two_rank_step_ms": [r0["ms"], r1["ms"]],
            "one_rank_step_ms": want["ms"],
            "rank_launches": r0["launches"], "launches": want["launches"]}
    # the CLI under a group of one: no collective
    from raw2logit_tpu_torch.training import train as cli
    distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                           "nccl" if device.type == "cuda" else "gloo")
    refused = []

    def refuse(*a, **k):
        refused.append(a)
        raise RuntimeError("a collective in a group of one")
    saved = {n: getattr(dist, n) for n in ("all_reduce", "broadcast",
                                           "all_gather", "barrier")}
    try:
        for n in saved:
            setattr(dist, n, refuse)
        with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp), \
                contextlib.redirect_stdout(io.StringIO()) as log:
            reset_counts()
            (res,) = cli.main([
                "--dataset", "SyntheticMicroscopy", "--use_pallas",
                "--test_run", "--epochs", "1", "--batch_size",
                str(SERVE_BATCH), "--n_devices", "1", "--experiment_name", "dp",
                "--run_name", "one",
                *(["--device", "cpu"] if device.type == "cpu" else [])])
            cli_launches = counts()
            wrote = os.path.exists(os.path.join(res["run"].dir,
                                                "metrics.jsonl"))
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
        distributed.shutdown()
    emit({"phase": "data_parallel", "ranks": 2, "device": str(device),
          "backend": "gloo", "gloo_on_cuda": [r["gloo_on_cuda"]
                                              for r in ranks],
          "spawn_seconds": spawn_s, "cases": rows,
          "tol": {"loss": DP_LOSS_REL, "abs_sums": DP_PARAM_REL,
                  "stats": DP_STATS_REL, "grads": DP_GRAD_REL},
          "cli_group_of_one": {"launches": cli_launches, "wrote": wrote,
                               "mesh_line": "data mesh: 1 device(s)"
                               in log.getvalue()}})
    check(all(r["gloo_on_cuda"] for r in ranks),
          "gloo's all_reduce and broadcast on CUDA tensors")
    for case, row in rows.items():
        check(row["loss_rel"] <= DP_LOSS_REL
              and row["isp_abs_sum_rel"] <= DP_PARAM_REL
              and row["clf_abs_sum_rel"] <= DP_PARAM_REL
              and row["stats_rel"] <= DP_STATS_REL
              and row["grads"]["ok"]
              and all(row["ranks_equal"].values()),
              f"two ranks against one, {case}: {row}")
        want = launches(fwd_train=1, bwd_res=1, stem_fwd=int(case[-1]),
                        stem_bwd=int(case[-1]))
        check(row["rank_launches"] == want and row["launches"] == want,
              f"the {case} steps launched {row['rank_launches']}, "
              f"{row['launches']}")
    check(not refused and wrote and cli_launches["fused_isp_fwd_train"] > 0,
          f"the CLI under a group of one: {cli_launches}")


def phase_parallel_helpers(device):
    """``process_full_frames`` over [cuda:0, cuda:0] on two 3000x4000
    drone frames against the unsplit run on the card (``SPLIT_TOL``):
    malvar2004 with median denoising, the FFT denoiser, and the eval-mode
    ISP through kernel 1 (two blocks, two launches); then
    ``process_pipeline_grid`` of the 12 pipelines over the same devices
    against each pipeline alone (bitwise: the same ops on the same
    card)."""
    from raw2logit_tpu_torch.parallel import (process_full_frames,
                                              process_pipeline_grid)
    devices = [device, device]
    frames = drone_frames(2).to(device)
    rows, seconds = {}, {}
    cases = {
        "malvar2004_median": StaticPipeline(
            DRONE_CAMERA_PARAMS, "malvar2004", "sharpening_filter",
            "median_denoising"),
        "fft_denoising": StaticPipeline(
            DRONE_CAMERA_PARAMS, "bilinear", "unsharp_masking",
            "fft_denoising"),
        "isp_kernel": processor(device, True, camera=DRONE_CAMERA_PARAMS)}
    with torch.no_grad():
        for name, pipe in cases.items():
            reset_counts()
            t0 = time.perf_counter()
            got = process_full_frames(pipe, devices, frames)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            split = counts()["fused_isp_fwd"]
            want = pipe(frames)
            want = want[0] if isinstance(want, tuple) else want
            rows[name] = {"max_abs_err": float((got - want).abs().max()),
                          "halo": pipe.halo_rows, "launches_split": split}
        pipes = [StaticPipeline(DRONE_CAMERA_PARAMS, *p)
                 for p in pipeline_grid()]
        t0 = time.perf_counter()
        grid = process_pipeline_grid(pipes, devices, frames)
        torch.cuda.synchronize()
        seconds["grid"] = time.perf_counter() - t0
        grid_equal = [bool(torch.equal(grid[i], p(frames)))
                      for i, p in enumerate(pipes)]
    emit({"phase": "parallel_helpers", "frames": [2, *DRONE_FRAME],
          "devices": [str(d) for d in devices], "split": rows,
          "grid_shape": list(grid.shape), "grid_equal": grid_equal,
          "seconds": seconds, "tol": SPLIT_TOL})
    check(all(r["max_abs_err"] <= SPLIT_TOL for r in rows.values())
          and rows["isp_kernel"]["launches_split"] == 2,
          f"split frames against unsplit: {rows}")
    check(all(grid_equal) and tuple(grid.shape) == (12, 2, 3, *DRONE_FRAME),
          f"the pipeline grid: {grid_equal}")


# ---------------------------------------------------------------------------
# bfloat16: the stem kernels' bfloat16 forms and the bfloat16 task models

# The bfloat16 forms against their plain versions: act (whose float32
# value rounds once) bitwise on at least BF16_BITWISE of the elements and
# within one bfloat16 ulp (``ulps``) on every one; pooled and d_n
# bitwise (the same float32 arithmetic on the same bfloat16 act, rounded
# once); the sums within STEM_SUM_TOL; dW and d_x within STEM_GRAD_TOL.
# Each also against a float64 witness on the same bfloat16-rounded
# operands: act, pooled and d_n within one ulp (d_n on at least
# BF16_DN_F64_SHARE of the elements: a ReLU decided at an exact zero in
# float32 may go the other way in float64), the sums within
# BF16_SUM_F64_TOL of the channel's sum of |terms|, dW and d_x no further
# than STEM_F64_FACTOR times the plain version is.
BF16_BITWISE, BF16_DN_F64_SHARE, BF16_SUM_F64_TOL = 0.99, 0.9999, 1e-4
# STEM_SHAPES (B = 256 and 32 at 256x256, the shapes that cut the tiles),
# B = 1100 at 4x8 (the pool backward's walk across 70,400 planes), two
# that cut the tensor-core dW and d_x tiles (16 x 32 positions) one stage
# and one column pair past a tile (36x68), and one k16 step past it
# across with 16-byte copies (68x96), and one that cuts the conv
# forward's 8 x 32 tile two rows and a column pair past and BN-pool's
# 128-column strips a column pair past, in rows that are not a multiple
# of 8 (36x260)
BF16_SHAPES = (*STEM_SHAPES, (1100, 3, 4, 8), (1, 3, 36, 68),
               (1, 3, 68, 96), (1, 3, 36, 260))
# JAX's bfloat16 contract (tests/test_bf16_parity.py): logit drift over
# each sample's logit spread, median and max; argmax agreement; a step's
# loss relative to the float32 step's
BF16_DRIFT_MEDIAN, BF16_DRIFT_MAX, BF16_ARGMAX, BF16_LOSS_REL = (
    0.02, 0.10, 0.99, 0.05)
BF16 = torch.bfloat16


def ulps(got, want):
    """|got - want| per element in bfloat16 ulps of the larger magnitude,
    no smaller than 2^-10 of max |want| (a near-cancelled output is as
    accurate as its terms, not as its own magnitude)."""
    g, w = got.double(), want.double()
    floor = float(w.abs().max()) * 2.0 ** -10
    big = torch.maximum(g.abs(), w.abs()).clamp_min(max(floor, 1e-30))
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(big)) - 7)


def ulp_agreement(got, want):
    """(share of elements equal, largest ``ulps``) of a bfloat16 tensor
    and a bfloat16 or float64 one."""
    return (float((got.double() == want.double()).double().mean()),
            float(ulps(got, want).max()))


def stem_bf16_agreement(x, w, gamma, beta, ties, seed=SEED):
    """Each bfloat16 form against its plain version and a float64 witness
    on the same bfloat16-rounded operands (``BF16_*``), as
    ``stem_agreement`` sets them up. Returns {kernel: (statistics, ok)}."""
    out = {}
    act, s1, s2 = stem_conv(x, w, dtype=BF16)
    act2, s1b, s2b = stem_conv(x, w, dtype=BF16)
    act_eval, _, _ = stem_conv(x, w, stats=False, dtype=BF16)
    ra, r1, r2 = stem_conv_reference(x, w, dtype=BF16)
    x64, w64 = rounded(x, BF16).double(), rounded(w, BF16).double()
    a64 = conv2d_f32(x64, w64, stride=2, padding=3)
    share, ulps_p = ulp_agreement(act, ra)
    share64, _ = ulp_agreement(act, a64.to(BF16))
    _, ulps64 = ulp_agreement(act, a64)
    stats = {"max_abs_err": float((act.float() - ra.float()).abs().max()),
             "bitwise_share_vs_plain": share, "max_ulps_vs_plain": ulps_p,
             "bitwise_share_vs_float64": share64,
             "max_ulps_vs_float64": ulps64,
             "sum_err": sums_err(s1, r1, a64), "sumsq_err": sums_err(
                 s2, r2, a64 * a64),
             "sum_err_vs_float64": sums_err(s1, a64.sum((0, 2, 3)), a64),
             "bitwise_repeat": bool(torch.equal(act, act2)
                                    and torch.equal(s1, s1b)
                                    and torch.equal(s2, s2b)),
             "no_stats_bitwise_equal": bool(torch.equal(act_eval, act))}
    out["stem_conv_fwd_bf16"] = stats, (
        share >= BF16_BITWISE and ulps_p <= 1 and share64 >= BF16_BITWISE
        and ulps64 <= 1
        and max(stats["sum_err"], stats["sumsq_err"]) <= STEM_SUM_TOL
        and stats["sum_err_vs_float64"] <= STEM_SUM_TOL
        and stats["bitwise_repeat"] and stats["no_stats_bitwise_equal"])
    del act2, act_eval, ra, x64, a64
    n = act.numel() // 64
    mean, var = batch_stats(s1, s2, n)
    inv, alpha, shift = bn_fold(gamma, beta, mean, var)
    if ties:
        act = (torch.round(act.float() * 8) / 8).to(BF16)
    c64 = [t.double()[:, None, None] for t in (alpha, shift, mean, inv)]
    pooled = stem_bnpool(act, alpha, shift)
    pooled2 = stem_bnpool(act, alpha, shift)
    want = stem_bnpool_reference(act, alpha, shift)
    p64 = torch.nn.functional.max_pool2d(
        torch.relu(act.double() * c64[0] + c64[1]), 3, 2, padding=1)
    _, ulps64 = ulp_agreement(pooled, p64)
    stats = {"max_abs_err": float((pooled.float() - want.float()).abs()
                                  .max()),
             "bitwise_equal_to_plain": bool(torch.equal(pooled, want)),
             "max_ulps_vs_float64": ulps64,
             "bitwise_repeat": bool(torch.equal(pooled, pooled2))}
    out["stem_bnpool_bf16"] = stats, (stats["bitwise_equal_to_plain"]
                                      and ulps64 <= 1
                                      and stats["bitwise_repeat"])
    del pooled2, want, p64
    gen = torch.Generator(x.device).manual_seed(seed)
    dp = torch.randn(pooled.shape, device=x.device, generator=gen).to(BF16)
    d_n, sd, sdx = stem_pool_bwd(act, dp, alpha, shift, mean, inv)
    d_n2, sd2, sdx2 = stem_pool_bwd(act, dp, alpha, shift, mean, inv)
    rn, rsd, rsdx = stem_pool_bwd_reference(act, dp, alpha, shift, mean, inv)
    n64, sd64, sdx64 = stem_pool_bwd_reference(
        act.double(), dp.double(), *(t.double() for t in (
            alpha, shift, mean, inv)))
    xhat64 = (act.double() - c64[2]) * c64[3]
    within = ulps(d_n, n64) <= 1
    stats = {"max_abs_err": float((d_n.float() - rn.float()).abs().max()),
             "bitwise_equal_to_plain": bool(torch.equal(d_n, rn)),
             "sum_err": sums_err(sd, rsd, n64),
             "sum_xhat_err": sums_err(sdx, rsdx, n64 * xhat64),
             "share_within_one_ulp_of_float64": float(
                 within.double().mean()),
             "sum_err_vs_float64": max(sums_err(sd, sd64, n64),
                                       sums_err(sdx, sdx64, n64 * xhat64)),
             "windows_with_positive_ties": window_ties(act.float(), alpha,
                                                       shift),
             "bitwise_repeat": bool(torch.equal(d_n, d_n2)
                                    and torch.equal(sd, sd2)
                                    and torch.equal(sdx, sdx2))}
    out["stem_pool_bwd_bf16"] = stats, (
        stats["bitwise_equal_to_plain"]
        and max(stats["sum_err"], stats["sum_xhat_err"]) <= STEM_SUM_TOL
        and stats["share_within_one_ulp_of_float64"] >= BF16_DN_F64_SHARE
        and stats["sum_err_vs_float64"] <= BF16_SUM_F64_TOL
        and stats["bitwise_repeat"])
    del d_n2, rn, n64, xhat64, within
    coef = bn_backward_coef(gamma, mean, inv, sd, sdx, n)
    # the witness contracts the same bfloat16 d_a (formed in float32, as
    # both versions form it) with the bfloat16-rounded x and w in float64
    d_a = rounded(bn_input_cotangent(act.float(), d_n.float(), coef),
                  BF16).double()
    xb, wb = rounded(x, BF16).double(), rounded(w, BF16).double()
    b_, _, h, wd = x.shape
    with full_float32():
        dw64 = torch.nn.grad.conv2d_weight(xb, (64, 3, 7, 7), d_a, stride=2,
                                           padding=3)
        dx64 = torch.nn.grad.conv2d_input((b_, 3, h, wd), wb, d_a, stride=2,
                                          padding=3)
    del d_a, xb
    out["stem_conv_dw_bf16"] = grad_agreement(
        stem_conv_dw(x, act, d_n, coef), stem_conv_dw(x, act, d_n, coef),
        stem_conv_dw_reference(x, act, d_n, coef), dw64)
    out["stem_conv_dx_bf16"] = grad_agreement(
        stem_conv_dx(act, d_n, coef, w), stem_conv_dx(act, d_n, coef, w),
        stem_conv_dx_reference(act, d_n, coef, w), dx64)
    return out


def phase_stem_bf16_kernels_vs_plain(device, shapes=BF16_SHAPES):
    """The five bfloat16 forms against their plain versions and float64
    witnesses (``stem_bf16_agreement``), on the ISP's outputs and on
    random inputs with planted ties; returns the largest |kernel - plain|
    of each."""
    worst = dict.fromkeys(STEM_BF16, 0.0)
    w, gamma, beta = stem_params(device)
    for shape in shapes:
        for inputs, ties in (("isp", False), ("random", True)):
            if shape[0] > 1000 and inputs == "isp":
                continue  # the walk across planes: random inputs suffice
            x = stem_input(device, shape, inputs)
            results = stem_bf16_agreement(x, w, gamma, beta, ties)
            torch.cuda.synchronize()
            for name, (stats, ok) in results.items():
                emit({"phase": "stem_bf16_kernels_vs_plain", "kernel": name,
                      "shape": list(shape), "inputs": inputs,
                      "planted_ties": ties, **stats})
                check(ok, f"{name} {shape} {inputs}: {stats}")
                worst[name] = max(worst[name], stats["max_abs_err"])
            del x, results
    return worst


def bf16_classifier(device, clf, stem_kernel=False):
    """A ResNet-18 computing in bfloat16 with ``clf``'s weights."""
    c = resnet_model("resnet18", fc_out_features=9, dtype=BF16,
                     device=device, stem_kernel=stem_kernel)
    c.load_state_dict(clf.state_dict())
    return c.train(clf.training)


def bf16_unetpp(device, net):
    """The CLI's U-Net++ computing in bfloat16 with ``net``'s weights."""
    u = UNetPlusPlus(device=device, dtype=BF16)
    u.load_state_dict(net.state_dict())
    return u


def drift(got, want):
    """JAX's bfloat16 contract: (median, max) over samples of the largest
    |got - want| over the sample's logit spread in ``want``, and the
    argmax agreement."""
    got, want = got.double().flatten(1), want.double().flatten(1)
    spread = (want.max(1).values - want.min(1).values).clamp_min(1e-6)
    rel = (got - want).abs().max(1).values / spread
    return (float(rel.median()), float(rel.max()),
            float((got.argmax(1) == want.argmax(1)).double().mean()))


def loss_rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-6)


def phase_bf16_steps(device, batch=BIG_BATCH, small=SERVE_BATCH):
    """The bfloat16 task models held to the port's float32 ones under JAX's
    contract: the classification train step at ``batch`` with the stem
    flag off and on (losses within 5%), its eval call (logits: drift and
    argmax), and the segmentation and adversarial steps at ``small``
    (losses within 5%). The flag-on step and its eval call are the
    bfloat16 forms' main path: counts set to 0 before, read after; returns
    them."""
    raw, y, proc, _ = train_setup(device, batch)
    clf = train_classifier(device, "perturbed")
    cfg = TrainConfig(lr=TRAIN_LR)
    main = None
    with torch.no_grad():  # the eval calls' input: the ISP's eval output
        rgb = copy.deepcopy(proc).eval()(raw)[0]
    for flag in (False, True):
        p, c, state, step = train_copy(cfg, proc, clf)
        c.stem_kernel = flag
        with torch.no_grad():
            want = copy.deepcopy(c).eval()(rgb)
        loss32 = float(step(state, raw, y)["loss"])
        del p, c, state, step
        p = copy.deepcopy(proc)
        c = bf16_classifier(device, clf, flag)
        state = create_train_state(cfg, p, c)
        step = make_train_step(cfg, p, c)
        torch.cuda.synchronize()
        reset_counts()
        loss16 = float(step(state, raw, y)["loss"])
        c.load_state_dict(clf.state_dict())  # the eval call's weights
        with torch.no_grad():
            got = c.eval()(rgb)
        torch.cuda.synchronize()
        seen = counts()
        med, mx, agree = drift(got, want)
        emit({"phase": "bf16_train_and_eval", "batch": batch,
              "stem_kernel": flag, "loss_float32": loss32,
              "loss_bfloat16": loss16, "loss_rel": loss_rel(loss16, loss32),
              "logits_dtype": str(got.dtype), "drift_median": med,
              "drift_max": mx, "argmax_agreement": agree,
              "launches": seen})
        check(np.isfinite(loss16) and loss_rel(loss16, loss32)
              < BF16_LOSS_REL, f"bfloat16 step loss {loss16} vs {loss32}")
        check(got.dtype == torch.float32 and med < BF16_DRIFT_MEDIAN
              and mx < BF16_DRIFT_MAX and agree >= BF16_ARGMAX,
              f"bfloat16 eval logits: {med}, {mx}, {agree}")
        check(seen == launches(fwd_train=1, bwd_res=1, bf16_fwd=2 * flag,
                               bf16_bwd=int(flag)),
              f"bfloat16 step and eval launches {seen}")
        if flag:
            main = seen
        del p, c, state, step, got, want
    del raw, y, proc, clf, rgb

    raw, masks = seg_batch(device, small)
    sproc, net = seg_modules(device)
    scfg = TrainConfig(task="segmentation", lr=TRAIN_LR)
    seg = {}
    for name, model in (("float32", net), ("bfloat16",
                                           bf16_unetpp(device, net))):
        p = copy.deepcopy(sproc)
        m = copy.deepcopy(model)
        state = create_train_state(scfg, p, m)
        seg[name] = float(make_train_step(scfg, p, m)(state, raw, masks)[
            "loss"])
    emit({"phase": "bf16_seg_step", "batch": small, "loss": seg,
          "loss_rel": loss_rel(seg["bfloat16"], seg["float32"])})
    check(loss_rel(seg["bfloat16"], seg["float32"]) < BF16_LOSS_REL,
          f"bfloat16 segmentation step {seg}")
    del raw, masks, sproc, net

    raw, y, aproc, aclf = adv_setup(device, small)
    adv = {}
    for name, model in (("float32", aclf),
                        ("bfloat16", bf16_classifier(device, aclf))):
        _, _, state, step = adv_copy(adv_config(), aproc, model)
        mets = step(state, raw, y)
        adv[name] = {k: float(mets[k]) for k in ("loss", "loss_aux")}
    emit({"phase": "bf16_adversarial_step", "batch": small, **adv})
    check(all(loss_rel(adv["bfloat16"][k], adv["float32"][k])
              < BF16_LOSS_REL for k in ("loss", "loss_aux")),
          f"bfloat16 adversarial step {adv}")
    return main


# --- the staged train step -------------------------------------------------

# The staged step against the one step from identical weights: loss,
# running statistics and ISP gradients (per parameter) at phase 6's gates
# (LOSS_TOL, STATS_TOL, BWD_PARAM); the classifier's gradients leaf by
# leaf within CLF_GRAD_TOL of the leaf's largest |gradient|, or of the
# whole classifier's largest times STAGED_LEAF_FLOOR where that is larger
# (the as-built ResNet's zero-scale batch norms leave leaves whose
# gradients are rounding noise). Timed: the mean of STAGED_ITERS calls
# after 2 warm-ups, in two rounds (one, staged, fused; then fused,
# staged, one), and a profile of 3 calls each.
STAGED_LEAF_FLOOR, STAGED_ITERS = 1e-3, 10
STAGED_KINDS = ("one", "staged", "fused")
# The update itself. Each step's first Adam step against the float64 Adam
# of that step's own gradient g: each parameter that trains against
# p - lr * g / (|g| + eps) within ADAM_TOL * lr plus two float32 ulps,
# its moments against (1 - b1) g and (1 - b2) g^2 within four ulps; the
# parameters that do not train unmoved. Each staged form's parameters
# against the one step's where the one step's gradient g is above
# ADAM_G_FLOOR and above twice the two gradients' difference: both Adams
# then move the same way, lr * g / (|g| + eps) differing by at most
# lr * eps / |g| <= 1e-2 lr, held within ADAM_NEAR_TOL * lr plus two
# ulps. (Elsewhere a sign flip of a gradient that is rounding noise moves
# the two 2 lr apart, which says nothing of the update.)
ADAM_TOL, ADAM_NEAR_TOL, ADAM_G_FLOOR, ADAM_EPS = 1e-4, 2e-2, 1e-6, 1e-8


def staged_copy(cfg, proc, clf, kind, stem=False):
    """Deep copies of the modules, their state and the step of ``kind``:
    the one step, the staged step, or the staged step with fuse_opt (a
    split state)."""
    p, c = copy.deepcopy(proc), copy.deepcopy(clf)
    c.stem_kernel = stem
    state = create_train_state(cfg, p, c, split_opt=kind == "fused")
    step = (make_train_step(cfg, p, c) if kind == "one" else
            make_staged_train_step(cfg, p, c, fuse_opt=kind == "fused"))
    return p, c, state, step


def stage4_cotangent(step):
    """A dict that each call of the staged ``step`` fills with the
    cotangent its ``isp_bwd`` stage receives (under "d"): that of the
    output BN's input with the train-mode BN in ``clf_grad_bn``, else of
    its output."""
    seen, isp_bwd = {}, step.programs["isp_bwd"]

    def spy(state, h, raw):
        seen["d"] = h.d
        return isp_bwd(state, h, raw)
    step.programs["isp_bwd"] = spy
    return seen


def leaf_agreement(got, want):
    """max over the classifier's leaves of |got - want| over the larger of
    the leaf's max |want| and STAGED_LEAF_FLOOR times the classifier's."""
    scale = max(float(g.abs().max()) for g in want.values())
    return max((max_rel(got[n].double(), want[n].double(),
                        STAGED_LEAF_FLOOR * scale), n) for n in want)


def named_params(p, c):
    """The ISP's and the classifier's parameters by "isp." / "clf."
    name."""
    return {f"{m}.{n}": t for m, mod in (("isp", p), ("clf", c))
            for n, t in mod.named_parameters()}


def adam_moments(state):
    """{parameter: its Adam state} over ``state``'s optimizers (the joint
    one, or the sides of a split pair)."""
    opts = (state.optimizer if isinstance(state.optimizer, tuple)
            else (state.optimizer,))
    return {q: o.state[q] for o in opts if o is not None
            for group in o.param_groups for q in group["params"]
            if q in o.state}


def adam_first_step(named, before, state, lr):
    """The first Adam step of ``state`` held to the float64 Adam of each
    parameter's own gradient: (worst error over its bound, 1 passes;
    that parameter or moment; the parameters that train without one Adam
    step, or moved without training)."""
    moments, worst, wrong = adam_moments(state), (0.0, ""), []
    for n, t in named.items():
        if not t.requires_grad:
            if not torch.equal(t.detach(), before[n]):
                wrong.append(n)
            continue
        st = moments.get(t)
        if st is None or float(st["step"]) != 1:
            wrong.append(n)
            continue
        g, ulp = t.grad.double(), torch.finfo(t.dtype).eps
        want = before[n].double() - lr * g / (g.abs() + ADAM_EPS)
        for what, got, w, bound in (
                ("", t.detach(), want, ADAM_TOL * lr + 2 * ulp * want.abs()),
                (" exp_avg", st["exp_avg"], 0.1 * g, 4 * ulp * 0.1 * g.abs()),
                (" exp_avg_sq", st["exp_avg_sq"], 1e-3 * g * g,
                 4 * ulp * 1e-3 * g * g)):
            err = float(((got.double() - w).abs() / (bound + 1e-30)).max())
            worst = max(worst, (err, n + what))
    return worst[0], worst[1], wrong


def update_agreement(after, after_one, grads, grads_one, lr):
    """Each staged form's updated parameters against the one step's where
    both Adams move the same way (see ADAM_NEAR_TOL): (worst error over
    its bound, 1 passes; the share of trained elements compared)."""
    worst, n_cmp, n_all = 0.0, 0, 0
    for n, w in after_one.items():
        if grads_one[n] is None:
            continue
        g1 = grads_one[n].double()
        near = ((g1.abs() > ADAM_G_FLOOR)
                & (g1.abs() > 2 * (grads[n].double() - g1).abs()))
        ulp = torch.finfo(w.dtype).eps
        ratio = ((after[n].double() - w.double()).abs()
                 / (ADAM_NEAR_TOL * lr + 2 * ulp * w.double().abs()))[near]
        if ratio.numel():
            worst = max(worst, float(ratio.max()))
        n_cmp, n_all = n_cmp + int(near.sum()), n_all + near.numel()
    return worst, n_cmp / max(n_all, 1)


def staged_runs(cfg, proc, clf, raw, y, kinds, stem):
    """One step of each of ``kinds`` (STAGED_KINDS) from identical
    weights: per kind (grads_and_stats and loss, launches, stage 4's
    cotangent or None, the updated parameters, their gradients, the first
    Adam step's check), each run's launches read after it alone."""
    runs = {}
    for kind in kinds:
        p, c, state, step = staged_copy(cfg, proc, clf, kind, stem)
        named = named_params(p, c)
        before = {n: t.detach().clone() for n, t in named.items()}
        seen = stage4_cotangent(step) if kind != "one" else None
        torch.cuda.synchronize()
        reset_counts()
        loss = float(step(state, raw, y)["loss"])
        torch.cuda.synchronize()
        got = counts()
        runs[kind] = ((grads_and_stats(p, c), loss), got, seen,
                      {n: t.detach().clone() for n, t in named.items()},
                      {n: t.grad for n, t in named.items()},
                      adam_first_step(named, before, state, cfg.lr))
        del p, c, state, step, named, before
    return runs


def update_of(runs, kind, lr):
    """The update of ``kind``'s run (``staged_runs``), to emit: its first
    Adam step and, for a staged form, its parameters against the one
    step's."""
    adam, adam_at, wrong = runs[kind][5]
    out = {"adam_first_step_err": [adam_at, adam], "adam_wrong": wrong}
    if kind != "one":
        near, share = update_agreement(runs[kind][3], runs["one"][3],
                                       runs[kind][4], runs["one"][4], lr)
        out.update(params_vs_one_step_err=near,
                   params_vs_one_step_share=share)
    return out


def check_update(tag, out):
    """The gates of an emitted ``update_of``."""
    adam_at, adam = out["adam_first_step_err"]
    check(adam <= 1 and not out["adam_wrong"],
          f"{tag}: first Adam step {adam_at} {adam} {out['adam_wrong']}")
    near = out.get("params_vs_one_step_err", 0.0)
    check(near <= 1, f"{tag}: parameters against the one step's {near}")


def staged_gates(device, batch, stem, size=SIZE):
    """One step, staged step and staged fuse_opt step from identical
    weights at ``batch``: each staged form held to the one step (phase 6's
    gates, the classifier leaf by leaf), its ISP gradients to the float64
    plain backward on the cotangent its stage 4 received, its update
    (``update_of``: the one step's too), and its launches. Returns the
    staged steps' launch counts."""
    raw, y, proc, clf = train_setup(device, batch, size)
    params = proc.kernel_params()
    cfg = TrainConfig(lr=TRAIN_LR)
    runs, total = staged_runs(cfg, proc, clf, raw, y, STAGED_KINDS, stem), \
        launches()
    for kind in STAGED_KINDS:
        tag = f"{kind} step (stem {stem}, B {batch})"
        update = update_of(runs, kind, cfg.lr)
        if kind == "one":
            emit({"phase": "staged_one_step_update", "batch": batch,
                  "stem_kernel": stem, **update})
            check_update(tag, update)
            continue
        got = runs[kind][1]
        check(got == launches(fwd_train=1, bwd_res=1, stem_fwd=stem,
                              stem_bwd=stem), f"{tag}: launches {got}")
        total = {k: total[k] + got[k] for k in total}
        agree = step_agreement(runs[kind][0], runs["one"][0])
        leaf, worst = leaf_agreement(runs[kind][0][0][1],
                                     runs["one"][0][0][1])
        _, grads_64 = witness(raw, params, runs[kind][2]["d"])
        isp = runs[kind][0][0][0]
        same_cot = max(max_rel(isp[ISP_NAMES[k]].double(), grads_64[k], 1e-3)
                       for k in grads_64)
        emit({"phase": "staged_vs_one_step", "kind": kind, "batch": batch,
              "stem_kernel": stem, "loss": runs[kind][0][1],
              "loss_one_step": runs["one"][0][1], **agree,
              "clf_leaf_max_rel_err": [worst, leaf],
              "isp_grads_vs_float64_bwd_same_cotangent": same_cot, **update})
        check(agree["loss_abs_err"] <= LOSS_TOL, f"{tag}: loss")
        check_update(tag, update)
        check(agree["running_stats_max_rel_err"] <= STATS_TOL,
              f"{tag}: running statistics")
        check(max(agree["isp_grad_max_rel_err"].values()) <= BWD_PARAM,
              f"{tag}: ISP gradients {agree['isp_grad_max_rel_err']}")
        check(leaf <= CLF_GRAD_TOL, f"{tag}: classifier leaf {worst} {leaf}")
        check(same_cot <= BWD_PARAM, f"{tag}: ISP gradients vs the float64 "
                                     f"backward on stage 4's cotangent "
                                     f"{same_cot}")
    return total


def staged_adversarial_gates(device, batch, size=SIZE):
    """The adversarial staged step (SSIM aux through ``SSIMAux``, which
    launches ``ssim_aux_value_grad``)
    against the adversarial one step at ``batch``, at phase 8's gates, its
    ISP gradients against the float64 backward on stage 4's cotangent, the
    update of each (``update_of``), and its launches. Returns them."""
    raw, y, proc, clf = adv_setup(device, batch, size)
    cfg = adv_config()
    runs, updates = {}, {}
    for kind in ("one", "staged"):
        p, c, state, step = adv_copy(cfg, proc, clf)
        named = named_params(p, c)
        before = {n: t.detach().clone() for n, t in named.items()}
        if kind == "staged":
            step = make_staged_train_step(cfg, p, c)
            seen = stage4_cotangent(step)
            params = {k: v.detach().clone()
                      for k, v in p.kernel_params().items()}
        torch.cuda.synchronize()
        reset_counts()
        mets = step(state, raw, y)
        torch.cuda.synchronize()
        got = counts()
        if kind == "staged":  # the eval-mode BN's input cotangent
            bn = p.batch_norm
            d_pre = seen["d"] * torch.rsqrt(bn.running_var
                                            + bn.eps)[:, None, None]
        runs[kind] = ({n: t.grad for n, t in p.named_parameters()},
                      float(mets["loss"]), float(mets["loss_aux"]))
        updates[kind] = (None, None, None,
                         {n: t.detach().clone() for n, t in named.items()},
                         {n: t.grad for n, t in named.items()},
                         adam_first_step(named, before, state, cfg.lr))
        del p, c, state, step, named, before
    update = {kind: update_of(updates, kind, cfg.lr) for kind in updates}
    (isp_s, loss_s, aux_s), (isp_o, loss_o, aux_o) = runs["staged"], \
        runs["one"]
    isp_err = {n: max_rel(isp_s[n].double(), isp_o[n].double(), 1e-3)
               for n in isp_s}
    _, grads_64 = witness(raw, params, d_pre)
    same_cot = max(max_rel(isp_s[ISP_NAMES[k]].double(), grads_64[k], 1e-3)
                   for k in grads_64)
    emit({"phase": "staged_adversarial_vs_one_step", "batch": batch,
          "loss": loss_s, "loss_one_step": loss_o, "loss_aux": aux_s,
          "loss_aux_one_step": aux_o, "isp_grad_max_rel_err": isp_err,
          "isp_grads_vs_float64_bwd_same_cotangent": same_cot,
          "update": update, "launches": got})
    check(abs(loss_s - loss_o) <= LOSS_TOL, "staged adversarial loss")
    for kind, out in update.items():
        check_update(f"adversarial {kind} step", out)
    check(abs(aux_s - aux_o) <= LOSS_TOL, "staged adversarial loss_aux")
    check(max(isp_err.values()) <= BWD_PARAM,
          f"staged adversarial ISP gradients {isp_err}")
    check(same_cot <= BWD_PARAM,
          f"staged adversarial ISP gradients vs float64 {same_cot}")
    check(got == launches(fwd=1, fwd_train=1, bwd_res=1, ssim=1),
          f"staged adversarial launches {got}")
    return got


def staged_bf16_gate(device, batch, size=SIZE):
    """One bfloat16 staged step with the stem flag against the bfloat16
    one step from the same weights, at the float32 staged gates (loss,
    running statistics, ISP gradients, the classifier leaf by leaf, the
    update): the two run the same bfloat16 forward and backward. And its
    launches (the stem's bfloat16 forms). Returns them."""
    raw, y, proc, _ = train_setup(device, batch, size)
    clf = bf16_classifier(device, train_classifier(device, "perturbed"),
                          True)
    cfg = TrainConfig(lr=TRAIN_LR)
    runs = staged_runs(cfg, proc, clf, raw, y, ("one", "staged"), True)
    agree = step_agreement(runs["staged"][0], runs["one"][0])
    leaf, worst = leaf_agreement(runs["staged"][0][0][1],
                                 runs["one"][0][0][1])
    update = {kind: update_of(runs, kind, cfg.lr)
              for kind in ("one", "staged")}
    got = runs["staged"][1]
    emit({"phase": "staged_bf16_vs_one_step", "batch": batch,
          "loss": runs["staged"][0][1], "loss_one_step": runs["one"][0][1],
          **agree, "clf_leaf_max_rel_err": [worst, leaf], "update": update,
          "launches": got})
    check(np.isfinite(runs["staged"][0][1])
          and agree["loss_abs_err"] <= LOSS_TOL, "bfloat16 staged step loss")
    for kind, out in update.items():
        check_update(f"bfloat16 {kind} step", out)
    check(agree["running_stats_max_rel_err"] <= STATS_TOL,
          "bfloat16 staged step running statistics")
    check(max(agree["isp_grad_max_rel_err"].values()) <= BWD_PARAM,
          f"bfloat16 staged step ISP gradients "
          f"{agree['isp_grad_max_rel_err']}")
    check(leaf <= CLF_GRAD_TOL,
          f"bfloat16 staged step classifier leaf {worst} {leaf}")
    check(got == launches(fwd_train=1, bwd_res=1, bf16_fwd=1, bf16_bwd=1),
          f"bfloat16 staged step launches {got}")
    return got


def staged_times(device, smi, batch, size=SIZE, iters=STAGED_ITERS,
                 calls=3):
    """CUDA-event ms of the one, staged and staged fuse_opt steps at
    ``batch`` in two rounds, then each one's device idle share from a
    profile of ``calls`` calls."""
    raw, y, proc, clf = train_setup(device, batch, size)
    cfg = TrainConfig(lr=TRAIN_LR)
    def runner(kind):
        _, _, state, step = staged_copy(cfg, proc, clf, kind)
        return lambda _: step(state, raw, y)
    runners = {kind: runner(kind) for kind in STAGED_KINDS}
    ms = {kind: [] for kind in STAGED_KINDS}
    for order in (STAGED_KINDS, STAGED_KINDS[::-1]):
        for kind in order:
            ms[kind].append(cuda_ms(runners[kind], [None] * 2, iters))
    for kind in STAGED_KINDS:
        kernels, busy, wall_ms = profile_calls(runners[kind], None, calls)
        emit({"phase": "staged_times", "kind": kind, "batch": batch,
              "ms": ms[kind], "imgs_per_s": batch / min(ms[kind]) * 1e3,
              "wall_ms": wall_ms, "device_busy_ms": busy,
              "device_idle_share": 1 - busy / wall_ms,
              "port_kernels_device_ms": port_kernel_ms(kernels),
              "card": smi})
    return ms


def phase_staged(device, smi, batches=(SERVE_BATCH, BIG_BATCH),
                 adv_batch=SERVE_BATCH, bf16_batch=BIG_BATCH, size=SIZE):
    """The staged train step (``make_staged_train_step``, with and without
    fuse_opt) at full ResNet-18 width, float32, at ``batches`` with the
    stem flag off and on against the one step; the adversarial staged
    step at ``adv_batch``; a bfloat16 staged step with the stem flag at
    ``bf16_batch``; then the three steps' times and idle shares. Returns
    the launches of every staged step of the gates: the staged path's
    counts, each read after that step alone."""
    total = launches()
    for b in batches:
        for stem in (False, True):
            got = staged_gates(device, b, stem, size)
            total = {k: total[k] + got[k] for k in total}
    for got in (staged_adversarial_gates(device, adv_batch, size),
                staged_bf16_gate(device, bf16_batch, size)):
        total = {k: total[k] + got[k] for k in total}
    for b in batches:
        staged_times(device, smi, b, size)
    emit({"phase": "staged", "launches": total})
    check(total["fused_isp_bwd"] == 0, "the staged path never recomputes")
    return total


def bf16_stem_timings(device, kind, b):
    """{form: {ms, plain_ms, bound_ms, bound_by, library_ms}} of the five
    bfloat16 forms at B = ``b``, 256x256, by CUDA events, beside the
    nearest library call in bfloat16 (which the port never calls)."""
    x = stem_input(device, (b, 3, SIZE, SIZE), "random")
    w, gamma, beta = stem_params(device)
    xb, wb = x.to(BF16), w.to(BF16)
    with torch.no_grad():
        act, s1, s2 = stem_conv(x, w, dtype=BF16)
        n = act.numel() // 64
        mean, var = batch_stats(s1, s2, n)
        inv, alpha, shift = bn_fold(gamma, beta, mean, var)
        pooled = stem_bnpool(act, alpha, shift)
        dp = torch.randn_like(pooled)
        d_n, sd, sdx = stem_pool_bwd(act, dp, alpha, shift, mean, inv)
        coef = bn_backward_coef(gamma, mean, inv, sd, sdx, n)
        d_a = bn_input_cotangent(act.float(), d_n.float(), coef).to(BF16)
        r = torch.relu(act.float() * alpha[:, None, None]
                       + shift[:, None, None]).to(BF16)
        _, pool_idx = torch.nn.functional.max_pool2d(
            r, 3, 2, padding=1, return_indices=True)
    one = [None]

    def cudnn_bwd(mask):
        return lambda _: torch.ops.aten.convolution_backward(
            d_a, xb, wb, None, [2, 2], [3, 3], [1, 1], False, [0, 0], 1, mask)

    with torch.no_grad():
        timed = {
            "stem_conv_fwd_bf16": (
                lambda _: stem_conv(x, w, dtype=BF16),
                lambda _: stem_conv_reference(x, w, dtype=BF16),
                lambda _: torch.nn.functional.conv2d(xb, wb, stride=2,
                                                     padding=3)),
            "stem_bnpool_bf16": (
                lambda _: stem_bnpool(act, alpha, shift),
                lambda _: stem_bnpool_reference(act, alpha, shift), None),
            "stem_pool_bwd_bf16": (
                lambda _: stem_pool_bwd(act, dp, alpha, shift, mean, inv),
                lambda _: stem_pool_bwd_reference(act, dp, alpha, shift,
                                                  mean, inv),
                lambda _: torch.ops.aten.max_pool2d_with_indices_backward(
                    dp, r, [3, 3], [2, 2], [1, 1], [1, 1], False, pool_idx)),
            "stem_conv_dw_bf16": (
                lambda _: stem_conv_dw(x, act, d_n, coef),
                lambda _: stem_conv_dw_reference(x, act, d_n, coef),
                cudnn_bwd([False, True, False])),
            "stem_conv_dx_bf16": (
                lambda _: stem_conv_dx(act, d_n, coef, w),
                lambda _: stem_conv_dx_reference(act, d_n, coef, w),
                cudnn_bwd([True, False, False]))}
        rows = {}
        for name, (kernel, plain, library) in timed.items():
            b_ms, b_by = bound(kind, b * 64 * (SIZE // 2) ** 2, name)
            rows[name] = {
                "ms": cuda_ms(kernel, one, 20),
                "plain_ms": cuda_ms(plain, one, 5),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": (None if library is None
                               else cuda_ms(library, one, 20))}
    return rows


def bf16_runners(device, b, small=SERVE_BATCH):
    """{step: (float32 runner, bfloat16 runner)}: the classification train
    step at ``b`` with the stem flag off and on, the segmentation and the
    adversarial steps at ``small`` (callables for ``cuda_ms``)."""
    def train(flag, dtype):
        return train_runner(device, b, stem_kernel=flag, dtype=dtype)

    def seg(bf16):
        raw, masks = seg_batch(device, small)
        proc, net = seg_modules(device)
        net = bf16_unetpp(device, net) if bf16 else net
        cfg = TrainConfig(task="segmentation", lr=TRAIN_LR)
        state = create_train_state(cfg, proc, net)
        step = make_train_step(cfg, proc, net)
        return lambda _: step(state, raw, masks)

    def adv(bf16):
        raw, y, proc, clf = adv_setup(device, small)
        c = bf16_classifier(device, clf) if bf16 else clf
        _, _, state, step = adv_copy(adv_config(), proc, c)
        return lambda _: step(state, raw, y)

    return {f"train_{b}": (lambda: train(False, torch.float32),
                           lambda: train(False, BF16)),
            f"train_stem_{b}": (lambda: train(True, torch.float32),
                                lambda: train(True, BF16)),
            f"seg_train_{small}": (lambda: seg(False), lambda: seg(True)),
            f"adversarial_{small}": (lambda: adv(False), lambda: adv(True))}


def phase_bf16_times(device, kind, device_ms, iters=5):
    """CUDA-event ms (``iters`` calls after 2 warm-ups) and peak memory of
    each bfloat16 step beside its float32 one, and the forms' kernel,
    plain and library ms at B = 32 and 256 beside their device ms in the
    bfloat16 flag-on train step (``device_ms``, from ``phase_profile``).
    Returns {batch: the forms' rows}."""
    for what, pair in bf16_runners(device, BIG_BATCH).items():
        row = {}
        for dtype, make in zip(("float32", "bfloat16"), pair):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            run = make()
            ms = cuda_ms(run, [None, None], iters)
            row[dtype] = {"ms": ms, "peak_memory_gib":
                          torch.cuda.max_memory_allocated() / 2 ** 30}
            del run
        emit({"phase": "bf16_step_times", "what": what, **row,
              "speedup": row["float32"]["ms"] / row["bfloat16"]["ms"]})
    forms = {}
    for b in (SERVE_BATCH, BIG_BATCH):
        forms[b] = bf16_stem_timings(device, kind, b)
        emit({"phase": "bf16_stem_times", "batch": b, "kernels": forms[b],
              "device_ms": {n: device_ms["train_stem_bf16", b].get(n)
                            for n in STEM_BF16}})
    return forms


def flax_path(name):
    """The flax module path of a port ResNet module name (the inverse of
    ``convert.resnet_name``): conv1 -> conv_init, layer1.0.conv2 ->
    layer1_0/Conv_1, layer2.0.downsample.1 -> layer2_0/downsample_bn."""
    parts, out = name.split("."), []
    while parts:
        head = parts.pop(0)
        if head.startswith("layer"):
            out.append(f"{head}_{parts.pop(0)}")
        elif head == "downsample":
            out.append(("downsample_conv", "downsample_bn")[int(parts.pop(0))])
        elif not out:
            out.append({"conv1": "conv_init", "bn1": "bn_init"}.get(head,
                                                                    head))
        elif head.startswith("conv"):
            out.append(f"Conv_{int(head[4:]) - 1}")
        elif head.startswith("bn"):
            out.append(f"BatchNorm_{int(head[2:]) - 1}")
        else:
            out.append(head)
    return out


def flax_npz(model):
    """The port's ResNet as the JAX package's converter writes ImageNet
    weights: {flax path: array}, conv kernels HWIO, fc left out."""
    flat = {}
    for key, t in model.state_dict().items():
        module, leaf = key.rsplit(".", 1)
        if module.startswith("fc") or leaf == "num_batches_tracked":
            continue
        a = t.detach().cpu().float().numpy()
        coll = "batch_stats" if leaf.startswith("running") else "params"
        leaf = {"running_mean": "mean", "running_var": "var",
                "bias": "bias"}.get(leaf, "kernel" if a.ndim == 4
                                    else "scale")
        if a.ndim == 4:
            a = np.transpose(a, (2, 3, 1, 0))
        flat["/".join([coll, *flax_path(module), leaf])] = a
    return flat


def phase_bf16_cli(device, batch=SERVE_BATCH):
    """A tiny training-CLI run on the card with --compute_dtype bfloat16,
    --classifier_pretrained (on a synthesised weights/resnet18.npz in the
    JAX package's layout) and --profile, in a temporary directory: the
    classifier trains in bfloat16 from the file's backbone, the trace
    lands in the run's profile/, the checkpoint is float32."""
    from raw2logit_tpu_torch.training import train as cli
    src = classifier(device, SEED + 7)
    flat = flax_npz(src)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            os.makedirs("weights")
            np.savez(os.path.join("weights", "resnet18.npz"), **flat)
            t0 = time.perf_counter()
            (res,) = cli.main([
                "--dataset", "SyntheticMicroscopy", "--batch_size",
                str(batch), "--n_splits", "1", "--use_pallas", "--test_run",
                "--epochs", "5", "--compute_dtype", "bfloat16",
                "--classifier_pretrained", "--profile",
                "--experiment_name", "bf16", "--run_name", "cli"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            trace = os.path.join(res["run"].dir, "profile", "trace.json")
            trace_bytes = os.path.getsize(trace) if os.path.exists(
                trace) else 0
            saved = torch.load(os.path.join(res["run"].dir, "checkpoints",
                                            "classifier.pt"))
            metrics = res["run"].read_metrics()
        finally:
            os.chdir(cwd)
    clf = res["state"].classifier
    got = dict(clf.named_parameters())
    src_params = dict(src.named_parameters())
    moved_from_file = max(
        float((got[n].detach() - src_params[n].detach()).abs().max())
        for n in got if not n.startswith(("conv1.", "fc.")))
    stem_init = float((got["conv1.weight"].detach()
                       - src_params["conv1.weight"].detach()).abs().max())
    losses = [m["train_loss"] for m in metrics if "train_loss" in m]
    emit({"phase": "bf16_cli", "seconds": seconds, "train_loss": losses,
          "classifier_dtype": str(clf.dtype),
          "backbone_max_abs_from_file": moved_from_file,
          "conv1_max_abs_from_file": stem_init, "trace_bytes": trace_bytes,
          "checkpoint_dtypes": sorted({str(v.dtype)
                                       for v in saved.values()})})
    check(clf.dtype == BF16, "the CLI's classifier computes in bfloat16")
    check(len(losses) == 5 and all(np.isfinite(losses)), f"losses {losses}")
    check(moved_from_file < 5 * 5e-5,
          f"the backbone starts from the file ({moved_from_file})")
    check(stem_init > 1e-2, "conv1 keeps its own init")
    check(trace_bytes > 0, "the profile trace was written")
    check(all(v.dtype in (torch.float32, torch.int64)
              for v in saved.values()), "the checkpoint is float32")
    return res


# --- the folder datasets and the tile path --------------------------------

# The Raw-Microscopy count (SURVEY.md:360), labelled in 9 classes.
FOLDER_N, FOLDER_CLASSES = 940, 9
# The store-fed first step's loss against the folder-fed one's (the same
# weights and, bitwise, the same batch).
FOLDER_LOSS_REL = 1e-6
# x * (1 / 65535) in the store's gather against x / 65535 in
# FolderClassification: at most one float32 ulp apart.
STORE_U16_ULPS = 1
DRONE_TILE, DRONE_CARS = 256, 60  # cars (rectangles) per drone frame
FOLDER_PROFILED = 5


def timed_epoch(loader):
    """(the batches of one epoch of ``loader``, its wall seconds)."""
    t0 = time.perf_counter()
    batches = list(loader)
    return batches, time.perf_counter() - t0


def same_batches(got, want):
    return len(got) == len(want) and all(
        np.array_equal(gx, wx) and np.array_equal(gy, wy)
        for (gx, gy), (wx, wy) in zip(got, want))


def endless(loader):
    """``loader``'s batches, epoch after epoch."""
    while True:
        yield from loader


def folder_step(device, proc, clf, stem, loader):
    """A train step at full width through the ISP kernels (the fused stem
    or not) on copies of ``proc`` and ``clf``, as fn(_) (for
    ``profile_calls``) taking the next batch of ``loader`` on each
    call."""
    _, c, state, step = train_copy(TrainConfig(lr=TRAIN_LR), proc, clf)
    c.stem_kernel = stem
    batches = endless(loader)

    def run(_):
        raw, y = next(batches)
        return step(state, torch.as_tensor(raw, device=device),
                    torch.as_tensor(y, device=device))
    return run


def folder_train(device, smi, datasets, batch):
    """One epoch of the train step fed by each of ``datasets`` ({feed:
    dataset}), with the stem flag off and on: images/s, launches per step,
    the first step's loss (the store-fed against the folder-fed), then
    each feed's device idle share over FOLDER_PROFILED more steps.
    Returns the store-fed epochs' launches."""
    proc = processor(device, use_kernel=True).train()
    clf = train_classifier(device)
    store_launches = launches()
    for stem in (False, True):
        # cuDNN's algorithm search and first launches, outside the epochs
        warm = Loader(datasets["store"], batch, shuffle=True, seed=SEED + 1)
        run = folder_step(device, proc, clf, stem, warm)
        for _ in range(3):
            run(None)
    for stem in (False, True):
        first = {}
        for feed, ds in datasets.items():
            loader = Loader(ds, batch, shuffle=True, seed=SEED)
            run = folder_step(device, proc, clf, stem, loader)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            loss = run(None)["loss"].clone()
            for _ in range(len(loader) - 1):
                run(None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            seen = counts()
            steps = len(loader)
            want = launches(fwd_train=steps, bwd_res=steps,
                            stem_fwd=steps if stem else 0,
                            stem_bwd=steps if stem else 0)
            first[feed] = float(loss)
            kernels, busy, wall_ms = profile_calls(
                folder_step(device, proc, clf, stem, loader), None,
                FOLDER_PROFILED)
            emit({"phase": "folder_data", "what": "train_epoch",
                  "feed": feed, "stem_kernel": stem, "batch": batch,
                  "steps": steps, "epoch_s": wall,
                  "imgs_per_s": steps * batch / wall,
                  "launches_per_step": {k: v / steps for k, v in seen.items()
                                        if v},
                  "first_loss": first[feed],
                  "profiled_steps": FOLDER_PROFILED, "wall_ms": wall_ms,
                  "device_busy_ms": busy,
                  "device_idle_share": 1 - busy / wall_ms,
                  "port_kernels_device_ms": port_kernel_ms(kernels),
                  "card": smi})
            check(seen == want, f"{feed}-fed epoch (stem {stem}) launched "
                                f"{seen}")
            if feed == "store":
                store_launches = {k: store_launches[k] + seen[k]
                                  for k in seen}
        rel = abs(first["store"] - first["folder"]) / abs(first["folder"])
        emit({"phase": "folder_data", "what": "first_loss",
              "stem_kernel": stem, "store_vs_folder_rel": rel,
              "limit": FOLDER_LOSS_REL, "card": smi})
        check(rel <= FOLDER_LOSS_REL, f"store-fed first loss {rel}")
    return store_launches


def drone_tiles(device, smi, root, shape, tile, batch, seed=SEED):
    """Two drone frames and their car masks as DNGs, read by
    FolderSegmentation, cut into tiles with ``split_img``, the tiles with
    a car kept (``keeps_tile``, as ``create_tiles_dataset`` keeps them),
    in memory; a segmentation store of them, a gather epoch against the
    in-memory tiles, then 2 U-Net++ train steps fed by the store."""
    t0 = time.perf_counter()
    img_dir, mask_dir = (os.path.join(root, d) for d in ("frames", "masks"))
    os.makedirs(img_dir)
    os.makedirs(mask_dir)
    rng = np.random.default_rng((seed,) + shape)
    for i, frame in enumerate(drone_frames(2, shape, seed).numpy()):
        write_dng(os.path.join(img_dir, f"f{i:02d}.dng"),
                  np.round(frame * 65535).astype(np.uint16))
        mask = np.zeros(shape, np.uint16)
        for _ in range(DRONE_CARS):
            h, w = rng.integers(16, 64, 2)
            y0 = rng.integers(0, shape[0] - h)
            x0 = rng.integers(0, shape[1] - w)
            mask[y0:y0 + h, x0:x0 + w] = 1
        write_dng(os.path.join(mask_dir, f"f{i:02d}_mask.dng"), mask)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames = FolderSegmentation(img_dir, mask_dir)
    X, Y, n_tiles = [], [], 0
    for img, mask in (frames[i] for i in range(len(frames))):
        tiles = split_img(img, ROIs=(tile, tile), step=(tile, tile))
        mtiles = split_img(mask, ROIs=(tile, tile), step=(tile, tile))
        n_tiles += len(tiles)
        for t, mt in zip(tiles, mtiles):
            if keeps_tile(mt):
                X.append(t)
                Y.append(mt)
    tile_s = time.perf_counter() - t0
    check(len(X) >= 2 * batch, f"{len(X)} drone tiles kept")
    tiles = ArrayDataset(np.stack(X), np.stack(Y))
    path = os.path.join(root, "drone.r2l")
    t0 = time.perf_counter()
    build_store(tiles, path)
    build_s = time.perf_counter() - t0
    store = TileStore(path)
    try:
        check(store.task == "segmentation", f"drone store {store.task}")
        got, gather_s = timed_epoch(Loader(store, batch, shuffle=True,
                                           seed=SEED))
        check(same_batches(got, list(Loader(tiles, batch, shuffle=True,
                                            seed=SEED))),
              "drone store batches equal the in-memory tiles")
        proc, net = seg_modules(device)
        _, _, state, step = train_copy(
            TrainConfig(task="segmentation", lr=TRAIN_LR), proc, net)
        reset_counts()
        t0 = time.perf_counter()
        losses = [float(step(state, torch.as_tensor(raw, device=device),
                             torch.as_tensor(y, device=device))["loss"])
                  for raw, y in got[:2]]
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t0
        seen = counts()
    finally:
        store.close()
    emit({"phase": "folder_data", "what": "drone_tiles",
          "frames": [2, *shape], "tile": tile, "tiles": n_tiles,
          "kept": len(X), "write_dng_s": write_s,
          "read_and_tile_s": tile_s, "build_store_s": build_s,
          "store_bytes": os.path.getsize(path), "gather_epoch_s": gather_s,
          "gather_imgs_per_s": len(got) * batch / gather_s if got else None,
          "seg_steps": 2, "seg_batch": batch, "seg_steps_s": steps_s,
          "seg_losses": losses, "launches": seen, "card": smi})
    check(all(np.isfinite(losses)), f"U-Net++ losses {losses}")
    check(seen == launches(fwd_train=2, bwd_res=2),
          f"store-fed U-Net++ steps launched {seen}")


def phase_folder_data(device, smi, n=FOLDER_N, size=SIZE,
                      batch=SERVE_BATCH, big=BIG_BATCH, drone=DRONE_FRAME,
                      tile=DRONE_TILE):
    """The folder datasets and the tile path, with neither PIL nor pandas:
    (a) ``n`` seeded ``size``-square 16-bit mosaics written as DNGs,
    labelled in FOLDER_CLASSES classes, read by FolderClassification, one
    per-item-decode epoch through Loader; (b) tile stores of that folder,
    float32 and uint16 (the counts), their build seconds and bytes, and a
    gather epoch at ``batch`` and ``big``: the float32 store's batches
    bitwise the folder loader's in the same shuffled order, the uint16
    store's within STORE_U16_ULPS, a Subset of the store on k_fold's train
    indices bitwise the same Subset of the folder; (c) ``folder_train``
    from the float32 store and from the folder; (d) ``drone_tiles``.
    Returns the store-fed train epochs' launches."""
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        paths = write_dngs(os.path.join(root, "dngs"), n, SEED, size)
        labels = np.random.default_rng((SEED, n)).integers(
            0, FOLDER_CLASSES, n).tolist()
        write_s = time.perf_counter() - t0
        folder = FolderClassification(paths, labels)
        counts16 = FolderClassification(paths, labels, bits=1)  # raw counts
        decoded, decode_s = timed_epoch(Loader(folder, batch, shuffle=True,
                                               seed=SEED))
        # where a decode's time goes: the file's bytes, then the parse
        t0 = time.perf_counter()
        for path in paths:
            with open(path, "rb") as fh:
                fh.read()
        bytes_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for path in paths:
            read_dng(path)
        parse_s = time.perf_counter() - t0
        emit({"phase": "folder_data", "what": "decode_epoch", "images": n,
              "size": size, "batch": batch, "write_dng_s": write_s,
              "epoch_s": decode_s,
              "imgs_per_s": len(decoded) * batch / decode_s,
              "read_bytes_s": bytes_s, "read_dng_s": parse_s, "card": smi})
        stores, epochs = {}, {}
        for name, ds, dtype in (("float32", folder, np.float32),
                                ("uint16", counts16, np.uint16)):
            path = os.path.join(root, f"{name}.r2l")
            t0 = time.perf_counter()
            build_store(ds, path, dtype=dtype)
            build_s = time.perf_counter() - t0
            stores[name] = TileStore(path)
            row = {"phase": "folder_data", "what": "store", "dtype": name,
                   "build_s": build_s, "bytes": os.path.getsize(path)}
            # the first epoch after opening faults the mapping in
            for key, b in (("first_epoch", batch), ("epoch", batch),
                           ("epoch", big)):
                got, s = timed_epoch(Loader(stores[name], b, shuffle=True,
                                            seed=SEED))
                row[f"{key}_s_b{b}"] = s
                row[f"{key}_imgs_per_s_b{b}"] = len(got) * b / s
                if key == "first_epoch":
                    epochs[name] = got
                elif b == big:  # the same permutation, in fewer batches
                    flat = np.concatenate([x for x, _ in epochs[name]])
                    check(np.array_equal(np.concatenate(
                        [x for x, _ in got]), flat[:len(got) * b]),
                        f"{name} store at B = {b}: the order of B = {batch}")
            emit(dict(row, card=smi))
        ulps = max(int(np.max(np.abs(x.view(np.int32).astype(np.int64)
                                     - w.view(np.int32))))
                   for (x, _), (w, _) in zip(epochs["uint16"], decoded))
        exact = same_batches(epochs["float32"], decoded)
        labels_equal = all(np.array_equal(y, w) for (_, y), (_, w) in
                           zip(epochs["uint16"], decoded))
        emit({"phase": "folder_data", "what": "store_vs_folder",
              "float32_bitwise": exact, "uint16_max_ulps": ulps,
              "uint16_labels_equal": labels_equal, "card": smi})
        check(exact, "float32 store batches bitwise the folder's")
        check(labels_equal and ulps <= STORE_U16_ULPS,
              f"uint16 store within {STORE_U16_ULPS} ulp: {ulps}")
        train_idx = k_fold(folder, n_splits=1, seed=SEED, train_size=0.8)[0][0]
        sub_store, sub_folder = (
            list(Loader(Subset(ds, train_idx), batch, shuffle=True,
                        seed=SEED)) for ds in (stores["float32"], folder))
        exact = len(sub_store) > 0 and same_batches(sub_store, sub_folder)
        emit({"phase": "folder_data", "what": "subset",
              "indices": len(train_idx), "bitwise_equal": exact,
              "card": smi})
        check(exact, "Subset(store) batches bitwise Subset(folder)'s")
        del decoded, epochs, got, sub_store, sub_folder
        stores["uint16"].close()
        try:
            found = folder_train(device, smi, {"store": stores["float32"],
                                               "folder": folder}, batch)
        finally:
            stores["float32"].close()
        drone_tiles(device, smi, os.path.join(root, "drone"), drone, tile,
                    batch)
    return found


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    started = time.perf_counter()
    seconds = {}

    def lap(what):
        """The seconds since the last lap, kept under ``what``."""
        seconds[what] = time.perf_counter() - started - sum(seconds.values())

    smi, kind = phase_device()
    phase_build()
    lap("device_and_build")
    max_err = {"fused_isp_fwd": phase_kernel_vs_plain(device),
               **phase_train_kernels_vs_plain(device)}
    max_err["ssim_aux"] = phase_ssim_kernel_vs_plain(device)
    max_err.update(phase_stem_kernels_vs_plain(device))
    max_err.update(phase_stem_bf16_kernels_vs_plain(device))
    lap("kernels_vs_plain")
    serve_launches, pred = phase_serve(device)
    path_launches = {"fused_isp_fwd": serve_launches}
    main_path, recompute = phase_train(device)
    path_launches.update(
        fused_isp_fwd_train=main_path["fused_isp_fwd_train"],
        fused_isp_bwd_res=main_path["fused_isp_bwd_res"],
        fused_isp_bwd=recompute["fused_isp_bwd"],
        ssim_aux=phase_adversarial(device)["ssim_aux"])
    phase_cli(device)
    stem_main = phase_stem_train(device)
    path_launches.update({n: stem_main[n] for n in STEM_KERNELS})
    _, pred_stem = phase_stem_serve(device)
    phase_bn(device)
    lap("parametrized_paths")
    # the bfloat16 task models: the forms' main path is the flag-on
    # bfloat16 train step and its eval call
    path_launches.update({n: v for n, v in phase_bf16_steps(device).items()
                          if n in STEM_BF16})
    lap("bf16_paths")
    # the staged train step: its gated steps are its path's run
    staged_launches = phase_staged(device, smi)
    lap("staged")
    batches = (SERVE_BATCH, BIG_BATCH)
    trains = {b: train_runner(device, b) for b in batches}
    trains_stem = {b: train_runner(device, b, stem_kernel=True)
                   for b in batches}
    trains_bf16 = {b: train_runner(device, b, stem_kernel=True, dtype=BF16)
                   for b in batches}
    advs = {b: adv_runner(device, b) for b in batches}
    rows = phase_times(device, kind, pred, trains, advs, pred_stem,
                       trains_stem)
    device_ms = phase_profile(device, pred, trains, advs, pred_stem,
                              trains_stem, trains_bf16)
    del pred, trains, advs, pred_stem, trains_stem, trains_bf16
    lap("times_and_profile")
    bf16_rows = phase_bf16_times(device, kind, device_ms)
    lap("bf16_times")
    # the static ISP's path, after the parametrized paths' measurements
    phase_static_gates(device)
    lap("static_gates")
    phase_static_cli(device)
    lap("static_cli")
    phase_static_precompute(device)
    lap("static_precompute")
    phase_static_profile(device, phase_static_times(device))
    lap("static_times_and_profile")
    # segmentation and the neural and identity ISPs, each path driven
    # with the counts set to 0 just before it and read just after
    seg_launches = dict(launches(), **phase_seg_train(device))
    seg_launches["fused_isp_fwd"] = phase_seg_serve(device)["fused_isp_fwd"]
    phase_neural_identity(device)
    lap("seg_and_neural_paths")
    phase_seg_cli(device)
    lap("seg_and_neural_cli")
    phase_seg_times(device)
    lap("seg_and_neural_times_and_profile")
    # evaluation: the corruption battery and the A/B and C tables
    phase_eval_gates(device)
    lap("eval_gates")
    phase_eval_cli(device)
    lap("eval_cli")
    phase_eval_times(device)
    lap("eval_times_and_profile")
    # the experiment drivers, the sweep, the app, data parallelism and the
    # spatial and pipeline axes, each in a temporary directory
    phase_examples(device)
    lap("examples")
    phase_sweep(device)
    lap("sweep")
    phase_app(device)
    lap("app")
    phase_data_parallel(device)
    lap("data_parallel")
    phase_parallel_helpers(device)
    lap("parallel_helpers")
    # the folder datasets and the tile path: the store-fed train step is
    # rows 2 and 3's path, and with the stem flag the stem kernels'
    folder_launches = phase_folder_data(device, smi)
    lap("folder_data")
    # the bfloat16 CLI run, whose --profile opens a trace of its own
    phase_bf16_cli(device)
    lap("bf16_cli")
    emit({"phase": "seconds", **seconds})
    entries = []
    for name, (replaces, source) in KERNELS.items():
        where = {"fused_isp_fwd": "serve", "fused_isp_bwd": "bwd_recompute",
                 "ssim_aux": "adversarial"}.get(name, "train")
        shape = ([SERVE_BATCH, 3, SIZE, SIZE]
                 if name == "ssim_aux" or name in STEM_KERNELS + STEM_BF16
                 else [SERVE_BATCH, SIZE, SIZE])
        if name in STEM_KERNELS:
            where = "train_stem"
        r = rows[SERVE_BATCH]["kernels"].get(name)
        if name in STEM_BF16:  # the bfloat16 flag-on train step
            where, r = "train_stem_bf16", bf16_rows[SERVE_BATCH][name]
        dev_ms = device_ms[where, SERVE_BATCH].get(name)
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[name],
            # launches of the segmentation path: its 3 train steps and
            # the 2 batches of its serving run
            "segmentation_launches": seg_launches[name],
            # launches of the store-fed train epochs (stem flag off and on)
            "folder_data_launches": folder_launches.get(name, 0),
            # launches of the staged step's gated steps (phase_staged)
            "staged_launches": staged_launches[name],
            "max_abs_err": max_err[name],
            # ms: CUDA events around the wrapper call (parameter packing,
            # and for the backward the partials' sum and unpacking,
            # included); device_ms: the kernel alone, from the profile of
            # the path that runs it
            "ms": r["ms"], "device_ms": dev_ms,
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            **({"library_call": LIBRARY_CALLS[name]}
               if r["library_ms"] is not None else {}),
            "shape": shape, "card": smi})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
