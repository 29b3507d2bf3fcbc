"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --k4-bwd [--parent DIR]
    python3 chip_smoke.py --data-parallel
    python3 chip_smoke.py --pcwnet
    python3 chip_smoke.py --iterative
    python3 chip_smoke.py --selective

The second form studies K4's backward kernel alone (`main_k4_bwd`), the
third runs phases 1, 2 and 19 alone (`main_data_parallel`), the fourth
phases 1, 2 and 20 (`main_pcwnet`), the fifth phases 1, 2 and 21
(`main_iterative`), the sixth phases 1, 2 and 22 (`main_selective`, with
K1 checked at IGEVStereo's shapes itself). The first runs
these phases, each of which raises on failure (exit code != 0,
no result line):

1. require CUDA; print the card and its power limit (nvidia-smi);
2. build the CUDA kernels from ``stereo_toolbox_tpu_torch/csrc`` (nvcc);
3. hold the gwc-volume kernel (K1, its "stream" design) against its plain
   PyTorch version at every launch shape of the stereo models' forwards and
   train steps and ragged cases, and its backward kernel (K1-bwd, its
   "rowpass" design) against ``torch.autograd`` of the plain forward at
   every eval and train launch shape of K1 (GwcNet_G's, GwcNet_GC's and
   ACVNet's; CFNet's three, C/G = 4 at 1/8) and ragged cases (W not a
   multiple of the strip, D > W, B 1 and 3, C/G 1 and 16, rows long enough
   for W tiles), both in float32 and bfloat16, each backward run twice for
   the same bits;
4. hold the fused 3x3x3 conv kernel (K2) likewise, each of its volume
   shapes also with both epilogue options on and off, and ragged cases (Ci
   1, 3, 33, 65; Co 8, 33; odd H and W; D 1 and 2); bfloat16 runs the
   tensor-core design "mma", float32 the tensor-core design "tf32x3"
   (3xTF32), each float32 launch twice for the same bits;
5. hold the plain 3x3x3 conv kernel (K3) likewise, with ragged cases (Ci
   5, 16; Co 8 and 33, odd H and W, D < 3): Co = 1 on its "stencil"
   design, Co > 1 on the "direct" one;
6. hold the sample-gather (K4) and sampled gwc-volume (K5) kernels, both
   on their "direct" designs, and the concat-volume kernel (K6, masked and
   not, its "rows" design) likewise, at CFNet's, GwcNet_GC's and ACVNet's
   launch shapes and ragged cases (K4: W not a multiple of the tile, C 1,
   5, 6 (12-byte bfloat16 pixels), 7 and 12, S = 1, a NaN sample, a right
   map one element past 16-byte alignment; K5: W not a multiple of the
   tile, blocks of a few pixels, S = 1, odd G, a C/G without a
   compile-time count; K6: bfloat16 C = 12 rows of 24-byte halves, odd C,
   rows not a multiple of 16 bytes, misaligned feature bases, W tiles);
   then their backward kernels (K6-bwd "direct", K4-bwd "staged" and K5-bwd
   "staged") against their plain versions in float32 and bfloat16, each run
   twice for the same bits, at every train launch shape and ragged cases
   (K6-bwd: D > W, odd C, a misaligned gradient, masked and not; K4-bwd
   and K5-bwd: W not a multiple of 32, S = 1, samples at 0, at max_shift,
   past both clamps and the image's edge, fractional, a NaN, a row whose
   every sample reads one right pixel; K4-bwd also a gradient one element
   past 16-byte alignment and rows whose chunks fit one block an SM);
7. hold the ViT attention kernel (K7) likewise, at DepthAnythingV2-vitl's
   launch shape, vits', DEFOMStereo_S's eval and train and MonSter's
   two-view shapes and ragged N (1, 15, 64, 65, 77, 200, 1025, 2048),
   bfloat16 on its design "mma", float32 on "tf32x3" (each float32 launch
   twice for the same bits); then its backward (K7-bwd: "dkv" and "dq", on
   the tensor cores in their type's design, bfloat16 "mma" and float32
   "tf32x3") at DEFOMStereo_S's train and eval shapes and the ragged N, in
   both types: the forward's row log-sum-exp against the plain one, each
   backward kernel against `attention_backward_reference` on the forward
   kernel's output and log-sum-exp (f32 1e-5, bf16 1e-2 x max|ref|; at
   N = 1, where dQ and dK are zero, against dV's scale), twice for the same
   bits, and autograd through `attention` against the plain chain
   (`K7_CHAIN_TOL`);
8. PSMNet, 9. GwcNet_G, 10. GwcNet_GC, 11. CFNet and 12. ACVNet (max_disp
   192, seeded random weights, settled and perturbed BatchNorm
   statistics), one after the other: the card against the port's CPU
   paths at 256x512 (ACVNet at 288x512, where its bottleneck attention pads
   H, and also in its ``attn_weights_only`` mode; GwcNet_G with both global
   TF32 flags set True, which the float32 forward must ignore), then in
   bfloat16 (built with ``create_model(..., dtype=torch.bfloat16)``) at the
   same size the card forward as the model runs against the card forward
   with K2 and K7 swapped for their plain versions (PSMNet and CFNet held
   by the costs before their soft argmax and first floor, ``classif3.2``
   and ``classif2.2``), then the 480x640 forward in float32 and bfloat16,
   with every kernel's launches by shape read around each forward
   (PSMNet: K2 x12 and K3 x3, no other kernel); PSMNet's phase also times
   its first 3D layer (`ConcatVolumeConvBNAct`, two 2D convs and strided
   copies, never building the concat volume) with its device launches
   against the layer it replaces, K6 (masked, C = 32, D 48) then K2 at Ci
   64 -> Co 32, in both types, first of all the traces (``torch.profiler``
   loses the events of short traces after long ones); 13. DepthAnythingV2
   (vitl, seeded random weights): the card against the CPU at 266x350 on
   the depth and the pre-ReLU ``out``, then the 518x518 forward in float32
   and bfloat16, launches by shape read likewise. For each model: time the
   whole forward and each of its stages with CUDA events recorded at the
   stage boundaries (one timed pass), sum the device time of each kernel
   family over a ``torch.profiler`` trace of the same forward, and time
   each kernel, its plain version and the library yardstick (device time
   of back-to-back calls) at the shapes and launch counts that the
   full-size forward recorded. Every forward requires its K2 and K7
   launches to have run the design of its type: "mma" in bfloat16,
   "tf32x3" in float32; every K1 launch "stream", every (Co = 1) K3 launch
   "stencil", every K4 and K5 launch "direct" and every K6 launch "rows";
14. train PSMNet, GwcNet_G, GwcNet_GC, ACVNet and CFNet (float32,
    max_disp 192, seeded random weights; CFNet with the sequence loss over
    its nine heads, the others with the multi-head loss): one train step
    (``trainer.make_train_step``) on the card against the same step on the
    port's CPU paths at 64x128, B 2, from the same weights and
    `SyntheticStereoDataset` batch (the loss, every gradient, the updated
    BatchNorm running statistics; CFNet's samples that differ between the
    two counted); the original's training crop, 256x512, B 4, through the
    port's `DataLoader`: one warm step and TRAIN_STEPS timed ones, each with
    its launches by shape required to be TRAIN_MIXES (every volume kernel
    of the forward and its backward kernel once a launch: GwcNet_G K1;
    GwcNet_GC and ACVNet K1 and K6; CFNet K1 and K6 x3, K4 and K5 x2;
    PSMNet: no kernel of the port); then 6 steps on one fixed 256x512, B 2
    batch (lr 1e-3, clip 1.0) whose losses must be finite and fall below
    0.9 x the first; then the same three in bfloat16 (JAX's ``--bf16``:
    the float32 model's parameters are the masters, each step computes on a
    bfloat16 view of them, ``make_train_step(..., dtype=torch.bfloat16)``):
    the card's bfloat16 step against the CPU's at 64x128, B 2 (also
    ACVNet's ``freeze_attn_weights`` and ``attn_weights_only``), held by
    the loss (its pixels' terms), each head, the running statistics and the
    gradients of the
    groups whose CPU float32 gradient is stable under a 1e-3 input
    perturbation, each within 2x the CPU's own bfloat16-vs-float32
    distance, by the dtypes of every conv, linear and BatchNorm call
    (equal to the CPU's), and by each backward kernel launch of the step
    against its plain version on the same arguments; its launches by shape
    the check mix, each kernel on its design and on bfloat16 data; the
    full-size steps (TRAIN_STEPS[BF16] timed) and the overfit likewise;
    each backward kernel timed at its train launches beside its plain
    version and ``torch.autograd`` of the plain forward, in both types
    (K4-bwd and K5-bwd also their list builds alone);
15. run the four disparity estimators on the card and on the CPU on one
    probability volume (the softmax of GwcNet_G's upsampled ``classif3``
    costs, [1, 192, 480, 640]): the argmax, the mode bounds and the modal
    mask the same, the soft estimators within 1e-5 x max_disp (the
    dominant-modal one may pick the other mode only at a pixel whose two
    masses lie within their float32 sums' rounding bound, `tie_bound`);
16. probe cuDNN's float32 conv at the two trunk shapes where its algorithm
    choice takes most of CFNet's f32 forward;
17. the evaluation suites: write dataset trees in the zoo's on-disk
    layouts at the real datasets' sizes (``datasets.fixtures``: SceneFlow
    540x960 PFM/PNG, KITTI 2015 and 2012 375x1242, Middlebury Eval3 H
    992x1436, ETH3D 458x739, DrivingStereo half 400x881 JPEG/PNG, two frames
    each, with their manifests), hold every file's native decode (where
    the port's native IO library built; else print why not) against the
    plain one; run ``sceneflow``, ``generalization`` and ``weather``
    through ``eval.py``'s functions with GwcNet_G (max_disp 192, settled
    seeded weights) in float32 and bfloat16, with the counts set to 0
    just before and every forward's K1, K2 and K3 launches required after
    (GwcNet_G's mix a frame, on their designs), printing each suite's
    frames/s and the loader's share of its wall time; hold the card's
    metric vectors against the CPU's on trees of 192x384 frames (every
    prediction within the forward's gates, every metric within
    ``evaluation.suite_slack``); then ``speed_and_memory_test`` at its
    three resolutions (SPEED_WARMUP, SPEED_ITERS) in both types;
18. DEFOMStereo_S (seeded random weights, the published widths; the
    sequence loss, max_disp 192 for its mask): its eval forward on the card
    against the CPU at 64x128 (f32: mean |d| < 5e-3, p99 < 2e-2 x
    max(mean |ref|, 1); bf16 against the same forward with K7 swapped for
    its plain version, mean |d| < 0.5 px); the 480x640 forward (32
    iterations, 8 of them scale updates) in f32 and bf16 and
    DEFOMStereo_L's in bf16, launches by shape required (12 and 24 K7 of
    two views, N 1201); one train step on the card against the CPU at
    64x128, B 2 (f32: the loss 1e-4, each group's gradient 5e-2 relative
    L2, the frozen depth head's zero on both sides; bf16: each K7-bwd
    launch against its plain version), its launches 12 K7 and 12 + 12
    K7-bwd; at the default crop 320x512, B 4, a warm and a timed step
    in each type with those launches every step, and eight steps on one
    batch whose last loss is below 0.9 x the first; each forward timed as
    phases 8-13 time theirs, K7-bwd timed at the train step's launches
    beside its plain version and autograd through
    ``F.scaled_dot_product_attention``;
19. data-parallel training (``parallel``, ``make_train_step(...,
    mesh=)``): GwcNet_G and CFNet at 256x512, global B 4 (ground truth NaN
    in regions of other sizes in each sample: the ranks hold different
    numbers of valid pixels), in float32 and in bfloat16 on float32
    masters, on two gloo ranks sharing the card (this process and a
    spawned one, B 2 each), on NCCL at world 1 (B 4) and, where there are
    two cards, on NCCL over both: each mesh's step against the one-process
    step on the global batch on the card, float32 at phase 14's card
    limits (the loss and the running statistics 1e-4, the gradients 3e-2 /
    0.2, CFNet 5e-3 / 5e-2) or twice the one-process step's own rounding
    floor where that is larger, bfloat16 as phase 14 holds it (the loss by
    its pixels' terms, each head, the running statistics and each stable
    group's gradient within twice the one-process bfloat16-vs-float32
    distance, every limit below 1); every rank's gradients, parameters and
    buffers the same bits, every step's launches on every rank the block's
    train mix (each volume kernel and its backward kernel); on two ranks
    the two negative controls (the per-rank loss mean, BatchNorm
    statistics reduced outside autograd) each beyond the float32 limits;
    each step's ms beside the one-process step's, its collectives, and
    ``evaluation.scaling.measure_scaling`` at [1];
20. PCWNet_G and PCWNet_GC eval (max_disp 192, seeded random weights,
    settled and perturbed BatchNorm statistics): K1, K2, K3 and K6 against
    their plain versions at every launch shape of the two forwards (K1 x4
    at C 320 from 1/4 to 1/32; K2 x17, every layer Mish, ``combine1..3``
    at Ci 104 / 168 / 168 or 128 / 192 / 192; K3 x1; K6 x4 masked for
    PCWNet_GC; each K2 shape also with both epilogue options on and off),
    both types, phases 3-6's checks and tolerances; each model on the
    card against the port's CPU paths at 256x512, float32: ``classif3``'s
    costs within 1e-3 x max|ref|, ``pred3`` and the output within mean
    < 5e-3 and max < 0.1 px (the pixels whose 0.999 warp mask flipped
    counted, the output held on the rows beyond the refinement's reach
    from them); bf16 against its K2 plain swap by those costs; the 480x640
    forwards in both types with their launches by shape, profiled and
    their kernels timed as phases 8-13 do;
21. RAFTStereo and IGEVStereo eval (the published widths, 32 iterations,
    max_disp 192, ``corr_impl='banded'``; seeded random weights,
    BatchNorm settled and perturbed): K1 against its plain version at
    IGEVStereo's launch shapes (C 96, G 8: C/G 12, at 480x640 and the check
    size, and a ragged row with D > W), both types, phase 3's tolerances;
    each model on the card against the port's CPU paths at 128x256 (W/4 >
    48: the band's cap binds), float32: the output's mean |d| < 5e-3 and
    99th percentile < 2e-2 of max(mean |ref|, 1), IGEVStereo's initial
    disparity mean < 1e-3, max < 1e-2 px at 1/4; the card's bfloat16
    forward within twice the CPU's own bfloat16-vs-float32 distance of
    its float32 one, and IGEVStereo's against the same forward with K1
    swapped for its plain version (mean |d| < 0.5 px); the 480x640 forwards
    in both types with their launches by shape (IGEVStereo K1 x1 "stream",
    RAFTStereo none of the port's kernels), profiled, and K1 timed, as
    phases 8-13 do;
22. SelectiveRAFT and SelectiveIGEV eval (the same widths, iterations
    and settings): phase 21's checks and gates on each (the card against
    the CPU at 128x256 in float32, SelectiveIGEV's initial disparity, bf16
    within twice the CPU's own distance, SelectiveIGEV's bf16 against its
    K1 plain swap, which launches K1 zero times), the 480x640 forwards
    with their launches by shape (SelectiveIGEV K1 x1 "stream" at
    IGEVStereo's shape, SelectiveRAFT none of the port's kernels),
    profiled, and K1 timed; phase 21's K1 check holds this shape, so K1
    is not checked again;
23. print one ``{"forward": {...}}``, one ``{"train": {...}}`` (phase 19
    under ``data_parallel``), one ``{"estimators": {...}}``, one
    ``{"eval": {...}}``, one ``{"kernels": [...]}`` line and one
    ``{"phase_seconds": {...}, "total_s": ...}`` line (each phase's
    seconds: where the time limit goes);
24. print ``{"ok": true, "device": {...}}`` as the last line.

Phase 14's float32 and bfloat16 card-vs-CPU checks share one CPU float32
step a model (`cpu_f32_step`): the same weights, batch and config.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import io
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter, defaultdict
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is false; this script "
             "needs an NVIDIA GPU")

from stereo_toolbox_tpu_torch import eval as eval_cli  # noqa: E402
from stereo_toolbox_tpu_torch import evaluation  # noqa: E402
from stereo_toolbox_tpu_torch import losses as port_losses  # noqa: E402
from stereo_toolbox_tpu_torch import native as port_native  # noqa: E402
from stereo_toolbox_tpu_torch import parallel  # noqa: E402
from stereo_toolbox_tpu_torch import metrics as port_metrics  # noqa: E402
from stereo_toolbox_tpu_torch import nn as port_nn  # noqa: E402
from stereo_toolbox_tpu_torch import (  # noqa: E402
    disparity_estimators as estimators)
from stereo_toolbox_tpu_torch.datasets import (  # noqa: E402
    DataLoader, SyntheticStereoDataset)
from stereo_toolbox_tpu_torch.datasets import io as port_io  # noqa: E402
from stereo_toolbox_tpu_torch.datasets.fixtures import (  # noqa: E402
    FULL_SIZES, write_eval_trees)
from stereo_toolbox_tpu_torch.evaluation.scaling import (  # noqa: E402
    measure_scaling)
from stereo_toolbox_tpu_torch.models import create_model  # noqa: E402
from stereo_toolbox_tpu_torch.models.defom_stereo import (  # noqa: E402
    get_danv2_io_size)
from stereo_toolbox_tpu_torch.models import igev_stereo  # noqa: E402
from stereo_toolbox_tpu_torch.models import pcwnet  # noqa: E402
port_attention = sys.modules["stereo_toolbox_tpu_torch.ops.attention"]
from stereo_toolbox_tpu_torch.nn import layers as port_layers  # noqa: E402
from stereo_toolbox_tpu_torch.nn.layers import ConvBNAct  # noqa: E402
from stereo_toolbox_tpu_torch.ops import _cuda  # noqa: E402
from stereo_toolbox_tpu_torch.ops import volume as port_volume  # noqa: E402
from stereo_toolbox_tpu_torch.ops.attention import (  # noqa: E402
    attention, attention_backward, attention_backward_dkv,
    attention_backward_dq, attention_backward_reference,
    attention_lse_reference, attention_reference, attention_with_lse)
from stereo_toolbox_tpu_torch.ops.conv3d import (  # noqa: E402
    conv3d, conv3d_reference)
from stereo_toolbox_tpu_torch.ops.conv3d_fused import (  # noqa: E402
    PackedConv3dWeight, conv3d_fused, conv3d_fused_reference,
    pack_conv3d_weight)
from stereo_toolbox_tpu_torch.ops.upsample import (  # noqa: E402
    interpolate as port_interpolate)
from stereo_toolbox_tpu_torch.ops.volume import (  # noqa: E402
    build_concat_volume, build_gwc_volume, concat_volume_backward,
    concat_volume_backward_reference, concat_volume_reference,
    gather_right_by_samples, gather_right_by_samples_backward,
    gather_right_by_samples_backward_reference,
    gather_right_by_samples_reference, gwc_volume_backward,
    gwc_volume_backward_reference, gwc_volume_from_samples,
    gwc_volume_from_samples_backward,
    gwc_volume_from_samples_backward_reference,
    gather_backward_plan,
    gwc_volume_from_samples_reference, gwc_volume_reference,
    sample_scratch_ints)
from stereo_toolbox_tpu_torch.train import LOSS_WEIGHTS  # noqa: E402
from stereo_toolbox_tpu_torch.trainer import (  # noqa: E402
    TrainConfig, TrainState, init_train_state, make_train_step, to_device)

DEV = torch.device("cuda")
MAX_DISP = 192
H, W = 480, 640
CHECK_H, CHECK_W = 256, 512                    # card vs CPU comparison
ACV_CHECK_H, ACV_CHECK_W = 288, 512            # bottleneck H 18 -> 20
DAV2_ENCODER = "vitl"
DAV2_H = DAV2_W = 518                          # the canonical 37x37 grid
DAV2_CHECK_H, DAV2_CHECK_W = 266, 350          # a 19x25 grid: pos resize
F32, BF16 = torch.float32, torch.bfloat16
DTYPE_NAME = {F32: "float32", BF16: "bfloat16"}

# Published peaks of the H100 SXM (NVIDIA data sheet, dense, 700 W):
# memory bytes/s, float32 FLOP/s outside the tensor cores, bfloat16 FLOP/s,
# TF32 FLOP/s on the tensor cores
PEAK = (3.35e12, 67e12, 989e12, 494.7e12)
# float32 designs that run three TF32 products a multiply-add (3xTF32):
# their operations bound counts those at the TF32 peak
TF32X3 = "tf32x3"

# The kernels: wrapper (its counts), source, the TPU kernel it replaces
# (pallas_call site; for the backward kernels, which no TPU kernel has, the
# XLA path whose gradient JAX takes)
KERNELS = {
    "K1": (build_gwc_volume, "gwc_volume",
           "stereo_toolbox_tpu_torch/csrc/gwc_volume.cu",
           "stereo_toolbox_tpu/ops/pallas/volume.py:87"),
    "K1-bwd": (gwc_volume_backward, "gwc_volume_backward",
               "stereo_toolbox_tpu_torch/csrc/gwc_volume.cu",
               "stereo_toolbox_tpu/ops/volume.py:168 (no TPU kernel: the "
               "gradient of the XLA path)"),
    "K2": (conv3d_fused, "conv3d_fused",
           "stereo_toolbox_tpu_torch/csrc/conv3d_fused.cu",
           "stereo_toolbox_tpu/ops/pallas/conv3d_fused.py:159"),
    "K3": (conv3d, "conv3d", "stereo_toolbox_tpu_torch/csrc/conv3d.cu",
           "stereo_toolbox_tpu/ops/pallas/conv3d.py:82"),
    "K4": (gather_right_by_samples, "gather_right_by_samples",
           "stereo_toolbox_tpu_torch/csrc/sample_gather.cu",
           "stereo_toolbox_tpu/ops/pallas/sample_gather.py:123"),
    "K5": (gwc_volume_from_samples, "gwc_volume_from_samples",
           "stereo_toolbox_tpu_torch/csrc/sample_gather.cu",
           "stereo_toolbox_tpu/ops/pallas/sample_gather.py:151"),
    "K6": (build_concat_volume, "concat_volume",
           "stereo_toolbox_tpu_torch/csrc/concat_volume.cu",
           "stereo_toolbox_tpu/ops/pallas/volume.py:137"),
    # the library Pallas flash_attention, called by _vit_attention_fn
    "K7": (attention, "vit_attention",
           "stereo_toolbox_tpu_torch/csrc/vit_attention.cu",
           "stereo_toolbox_tpu/models/depth_anything_v2.py:75"),
    "K6-bwd": (concat_volume_backward, "concat_volume_backward",
               "stereo_toolbox_tpu_torch/csrc/concat_volume.cu",
               "stereo_toolbox_tpu/ops/volume.py:98 (no TPU kernel: the "
               "gradient of the XLA path)"),
    "K4-bwd": (gather_right_by_samples_backward,
               "gather_right_by_samples_backward",
               "stereo_toolbox_tpu_torch/csrc/sample_gather.cu",
               "stereo_toolbox_tpu/ops/volume.py:291 (no TPU kernel: the "
               "gradient of the XLA path)"),
    "K5-bwd": (gwc_volume_from_samples_backward,
               "gwc_volume_from_samples_backward",
               "stereo_toolbox_tpu_torch/csrc/sample_gather.cu",
               "stereo_toolbox_tpu/ops/volume.py:336 (no TPU kernel: the "
               "gradient of the XLA path)"),
    # the library flash_attention's two backward Pallas kernels, which its
    # custom_vjp ties to the forward K7 ports
    "K7-bwd-dkv": (attention_backward_dkv, "vit_attention_bwd_dkv",
                   "stereo_toolbox_tpu_torch/csrc/vit_attention.cu",
                   "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
                   "(_flash_attention_bwd_dkv, :941), reached from "
                   "stereo_toolbox_tpu/models/depth_anything_v2.py:75"),
    "K7-bwd-dq": (attention_backward_dq, "vit_attention_bwd_dq",
                  "stereo_toolbox_tpu_torch/csrc/vit_attention.cu",
                  "jax/experimental/pallas/ops/tpu/flash_attention.py:1456 "
                  "(_flash_attention_bwd_dq, :1287), reached from "
                  "stereo_toolbox_tpu/models/depth_anything_v2.py:75"),
}

# Launches expected in one eval forward at 480x640, max_disp 192, keyed as
# the wrappers count them. Phases 7-9 require each forward's counts to
# equal these; the timing weights its times by the counts a forward recorded.
# K1: (B, H, W, C, D, G)
K1_MIX = {(1, 120, 160, 320, 48, 40): 1}
# K2: (B, D, H, W, Ci, Co, residual, relu)
K2_MIX = {
    (1, 48, 120, 160, 40, 32, False, True): 1,   # dres0[0]
    (1, 48, 120, 160, 32, 32, False, True): 3,   # dres0[1], dres1[0], classif3
    (1, 48, 120, 160, 32, 32, True, False): 1,   # dres1[1] (+ cost0)
    (1, 24, 60, 80, 64, 64, False, True): 3,     # hourglass conv2 x3
    (1, 12, 30, 40, 128, 128, False, True): 3,   # hourglass conv4 x3
}
# K3: (B, D, H, W, Ci, Co), classif3's last conv
K3_MIX = {(1, 48, 120, 160, 32, 1): 1}
# GwcNet_GC: dres0 takes the gwc (40) and concat (24) volumes
GC_K2_MIX = {(1, 48, 120, 160, 64, 32, False, True): 1,
             **{k: n for k, n in K2_MIX.items() if k[4] != 40}}
# K6: (B, H, W, C, D, mask_left)
GC_K6_MIX = {(1, 120, 160, 12, 48, True): 1}
# CFNet: volumes at 1/8, 1/16, 1/32 (C = 160, 320, 320; 12 concat channels)
CF_K1_MIX = {(1, 60, 80, 160, 24, 40): 1, (1, 30, 40, 320, 12, 40): 1,
             (1, 15, 20, 320, 6, 40): 1}
CF_K6_MIX = {(1, 60, 80, 12, 24, True): 1, (1, 30, 40, 12, 12, True): 1,
             (1, 15, 20, 12, 6, True): 1}
# classif2 at 1/8, confidence_classif1_s3 at 1/4, confidence_classif1_s2
CF_K3_MIX = {(1, 24, 60, 80, 32, 1): 1, (1, 16, 120, 160, 32, 1): 1,
             (1, 12, 240, 320, 16, 1): 1}
# K4: (B, H, W, C, S, max_shift), stages s3 (1/4) and s2 (1/2)
CF_K4_MIX = {(1, 120, 160, 12, 16, 48): 1, (1, 240, 320, 6, 12, 96): 1}
# K5: (B, H, W, C, S, G, max_shift)
CF_K5_MIX = {(1, 120, 160, 160, 16, 40, 48): 1,
             (1, 240, 320, 80, 12, 20, 96): 1}
# K2: every Mish layer launches without the ReLU epilogue
CF_K2_MIX = {
    (1, 24, 60, 80, 64, 32, False, False): 1,     # dres0.0
    (1, 24, 60, 80, 32, 32, False, False): 3,     # dres0.2, dres1.0, classif2
    (1, 24, 60, 80, 32, 32, True, False): 1,      # dres1.2
    (1, 12, 30, 40, 64, 64, False, False): 5,     # dres*_5 x3, *.conv2 x2
    (1, 12, 30, 40, 64, 64, True, False): 1,      # dres1_5.2
    (1, 12, 30, 40, 128, 64, False, False): 1,    # combine1.combine1
    (1, 6, 15, 20, 64, 64, False, False): 3,      # dres0_6, dres1_6.0
    (1, 6, 15, 20, 64, 64, True, False): 1,       # dres1_6.2
    (1, 6, 15, 20, 192, 128, False, False): 1,    # combine1.combine2
    (1, 6, 15, 20, 128, 128, False, False): 2,    # combine1/dres3 conv4
    (1, 16, 120, 160, 65, 32, False, False): 1,   # confidence0_s3.0
    (1, 16, 120, 160, 32, 32, False, False): 3,   # s3 stack, classif1_s3
    (1, 16, 120, 160, 32, 32, True, False): 1,    # confidence1_s3.2
    (1, 8, 60, 80, 64, 64, False, False): 2,      # confidence{2,3}_s3.conv2
    (1, 4, 30, 40, 128, 128, False, False): 2,    # confidence{2,3}_s3.conv4
    (1, 12, 240, 320, 33, 16, False, False): 1,   # confidence0_s2.0
    (1, 12, 240, 320, 16, 16, False, False): 3,   # s2 stack, classif1_s2
    (1, 12, 240, 320, 16, 16, True, False): 1,    # confidence1_s2.2
    (1, 6, 120, 160, 32, 32, False, False): 2,    # confidence{2,3}_s2.conv2
    (1, 3, 60, 80, 64, 64, False, False): 2,      # confidence{2,3}_s2.conv4
}
# ACVNet: K6 without the left mask; K3 for classif_att_ and classif2
ACV_K6_MIX = {(1, 120, 160, 32, 48, False): 1}
ACV_K3_MIX = {(1, 48, 120, 160, 32, 1): 2}
ACV_K2_MIX = {
    (1, 48, 120, 160, 40, 32, False, True): 1,   # dres1_att_.0
    (1, 48, 120, 160, 32, 32, False, False): 1,  # dres1_att_.2
    (1, 48, 120, 160, 64, 32, False, True): 1,   # dres0.0
    # classif_att_.0, dres0.2, dres1.0, classif2.0
    (1, 48, 120, 160, 32, 32, False, True): 4,
    (1, 48, 120, 160, 32, 32, True, False): 1,   # dres1.2 (+ cost0)
    (1, 24, 60, 80, 64, 64, False, True): 3,     # hourglass conv2 x3
    (1, 12, 30, 40, 128, 128, False, True): 3,   # hourglass conv4 x3
}
# DepthAnythingV2-vitl at 518x518: one K7 per block, (B, heads, N, head_dim)
DAV2_K7_MIX = {(1, 16, 1370, 64): 24}
# DEFOMStereo at 480x640 (B 1): one ViT pass over both views at the DAv2
# input 420x560, a 30x40 patch grid (N = 1201); 12 blocks of 6 heads (S),
# 24 of 16 (L)
DEFOM, DEFOM_L = "DEFOMStereo_S", "DEFOMStereo_L"
DEFOM_K7_MIX = {(2, 6, 1201, 64): 12}
DEFOM_L_K7_MIX = {(2, 16, 1201, 64): 24}
# PSMNet: no volume kernel (its first 3D layer never builds the volume)
PS_K2_MIX = {
    # dres0.2, dres1.0, classif1..3
    (1, 48, 120, 160, 32, 32, False, True): 5,
    (1, 48, 120, 160, 32, 32, True, False): 1,   # dres1.2 (+ cost0)
    (1, 24, 60, 80, 64, 64, False, True): 1,     # dres2.conv2
    (1, 24, 60, 80, 64, 64, True, True): 2,      # dres3/4.conv2 (+ postsqu)
    (1, 12, 30, 40, 64, 64, False, True): 3,     # hourglass conv4 x3
}
PS_K3_MIX = {(1, 48, 120, 160, 32, 1): 3}        # classif1..3's last conv
# PCWNet: gwc volumes (C 320, G 40) and, for PCWNet_GC, masked concat
# volumes (C 12) at 1/4, 1/8, 1/16 and 1/32
PCW_MODELS = ("PCWNet_G", "PCWNet_GC")
PCW_K1_MIX = {(1, 120 // s, 160 // s, 320, 48 // s, 40): 1
              for s in (1, 2, 4, 8)}
PCW_K6_MIX = {(1, 120 // s, 160 // s, 12, 48 // s, True): 1
              for s in (1, 2, 4, 8)}
PCW_K3_MIX = {(1, 48, 120, 160, 32, 1): 1}       # classif3's last conv
# The iterative models: RAFTStereo launches none of the port's kernels;
# IGEVStereo one K1, its 8-group volume of the 96-channel matching features
RAFT, IGEV = "RAFTStereo", "IGEVStereo"
ITERATIVE = (RAFT, IGEV)
IGEV_K1_MIX = {(1, 120, 160, 96, 48, 8): 1}
# Their Selective variants (phase 22): SelectiveRAFT launches none of the
# port's kernels, SelectiveIGEV IGEVStereo's one K1
SRAFT, SIGEV = "SelectiveRAFT", "SelectiveIGEV"
SELECTIVE = (SRAFT, SIGEV)
IGEV_FAMILY = (IGEV, SIGEV)


def pcw_k2_mix(cv: int) -> dict:
    """PCWNet's K2 launches with `cv`-channel volumes (40 G, 64 GC): every
    layer Mish, so no ReLU epilogue; ``combine1..3`` take ``[c, v]``."""
    return {
        (1, 48, 120, 160, cv, 32, False, False): 1,    # dres0.0
        (1, 48, 120, 160, 32, 32, False, False): 3,    # dres0.2, dres1.0,
        #                                                classif3.0
        (1, 48, 120, 160, 32, 32, True, False): 1,     # dres1.2 (+ cost0)
        (1, 24, 60, 80, 64 + cv, 64, False, False): 1,   # combine1.combine1
        (1, 24, 60, 80, 64, 64, False, False): 4,      # combine1.conv2,
        #                                                dres2-4.conv2
        (1, 12, 30, 40, 128 + cv, 128, False, False): 1,  # .combine2
        (1, 12, 30, 40, 128, 128, False, False): 4,    # .conv4, dres2-4.conv4
        (1, 6, 15, 20, 128 + cv, 128, False, False): 1,   # .combine3
        (1, 6, 15, 20, 128, 128, False, False): 1,     # combine1.conv6
    }


# Train steps at the original's crop 256x512, B 4, and at the card-vs-CPU
# check's 64x128, B 2, max_disp 192, float32. A step launches each volume
# kernel of the forward once and its backward kernel once; PSMNet launches
# no kernel of the port in a train step (every conv on cuDNN, its first 3D
# layer never builds the volume), and no train step launches K2, K3 or K7
# (JAX's train path reaches no Pallas kernel: convs on cuDNN)
TRAIN_MODELS = ("PSMNet", "GwcNet_G", "GwcNet_GC", "ACVNet", "CFNet")
TRAIN_H, TRAIN_W, TRAIN_B = 256, 512, 4
TRAIN_CHECK_H, TRAIN_CHECK_W, TRAIN_CHECK_B = 64, 128, 2
# 6 overfit steps since phase 19 came (12 before; the overfit losses fell
# below 0.9 x the first by the third step in every run)
OVERFIT_B, OVERFIT_STEPS = 2, 6
# 1 timed step a type since phase 22 came (2 since phase 21, 3 since
# phase 20, 5 before)
TRAIN_STEPS, TRAIN_WARMUP = {F32: 1, BF16: 1}, 1
# CFNet's nine heads take the sequence loss (the multi-head weights are
# four), as JAX's own CFNet gradient check does
TRAIN_LOSS = {"CFNet": "sequence"}


def train_mix(name, b, h, w, mode=None) -> dict:
    """The launches by tag and shape of one train step of `name` on a
    ``[b, h, w, 3]`` batch (shapes keyed as the wrappers count them); for
    ACVNet's staged `mode`, ``freeze_attn_weights`` launches no K1 backward
    (the attention branch gets no gradient) and ``attn_weights_only`` no K6
    (no main branch)."""
    g, c4, h4, w4 = 40, 320, h // 4, w // 4
    fwd = {}
    if name in ("GwcNet_G", "GwcNet_GC", "ACVNet"):
        fwd["K1"] = {(b, h4, w4, c4, MAX_DISP // 4, g): 1}
    if name == "GwcNet_GC":
        fwd["K6"] = {(b, h4, w4, 12, MAX_DISP // 4, True): 1}
    if name == "ACVNet":
        fwd["K6"] = {(b, h4, w4, 32, MAX_DISP // 4, False): 1}
    if name == "CFNet":
        scales = ((8, 160), (16, 320), (32, 320))
        fwd["K1"] = {(b, h // f, w // f, c, MAX_DISP // f, g): 1
                     for f, c in scales}
        fwd["K6"] = {(b, h // f, w // f, 12, MAX_DISP // f, True): 1
                     for f, _ in scales}
        fwd["K4"] = {(b, h4, w4, 12, 16, MAX_DISP // 4): 1,
                     (b, h // 2, w // 2, 6, 12, MAX_DISP // 2): 1}
        fwd["K5"] = {(b, h4, w4, 160, 16, 40, MAX_DISP // 4): 1,
                     (b, h // 2, w // 2, 80, 12, 20, MAX_DISP // 2): 1}
    if mode == "attn_weights_only":
        del fwd["K6"]
    bwd = {f"{tag}-bwd": mix for tag, mix in fwd.items()}
    if mode == "freeze_attn_weights":
        del bwd["K1-bwd"]
    return {**fwd, **bwd}


TRAIN_MIXES = {name: train_mix(name, TRAIN_B, TRAIN_H, TRAIN_W)
               for name in TRAIN_MODELS}
TRAIN_CHECK_MIXES = {name: train_mix(name, TRAIN_CHECK_B, TRAIN_CHECK_H,
                                     TRAIN_CHECK_W) for name in TRAIN_MODELS}
# card vs CPU train step at 64x128: the loss and the running statistics
# within TRAIN_REL (relative; a mean in units of its channel's spread), the
# gradients within TRAIN_GRAD's (global relative L2, each leaf's max|d| /
# its max|ref|) for the model, or its default. The float32 gradient is no
# better determined at this size, where a ReLU input within rounding of 0
# takes the other side of its kink and BatchNorm's batch statistics spread
# its gradient: on the CPU the port's float32 gradients are 2.5e-3
# (PSMNet) and 2.4e-2 (GwcNet_G) from float64, worst leaves 4.5e-2 and
# 7.9e-2.
# CFNet (Mish, no kink) is held tighter, from its clean readings (2.6e-4
# and 5.7e-3 with 2 of 49152 s2 samples moved by rounding, the same in
# every run: the comparison runs cuDNN's deterministic algorithms).
# `chip_train_faults.py` plants faults into the card's step against these
# limits.
TRAIN_REL = 1e-4
TRAIN_GRAD = {"default": (3e-2, 0.2), "CFNet": (5e-3, 5e-2)}
# bfloat16 train steps (JAX's --bf16: float32 masters, the forward on a
# bfloat16 view of them) of the same five models, and ACVNet's two staged
# modes at the card-vs-CPU check. At init a train-mode BatchNorm trunk
# amplifies every rounding in its backward, so the bfloat16 step is held by
# its well-conditioned readings, each within BF16_FACTOR x the CPU's own
# bfloat16-vs-float32 distance on the same batch (the CPU port's bfloat16
# step is held likewise against JAX's, tests/test_torch_train_bf16_*.py):
# the loss (by its pixels' terms, `loss_terms`), each head, the running
# statistics, and the gradient of each
# group (a top-level module) whose CPU float32 gradient moves less than
# STABLE under a PERTURBATION of the left image; and the dtypes every
# conv, linear and BatchNorm module computes with, exactly.
BF16_FACTOR, PERTURBATION, STABLE = 2.0, 1e-3, 0.1
BF16_MODES = {"freeze_attn_weights": (0.5, 0.7, 1.0),
              "attn_weights_only": (1.0,)}
AUDITED = (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.ConvTranspose3d,
           torch.nn.Linear, torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)
# the volume kernels' launchers, whose data type a train step records
LAUNCHERS = {"K1": "_launch_gwc_volume", "K1-bwd": "_launch_gwc_backward",
             "K6": "_launch_concat_volume",
             "K6-bwd": "_launch_concat_backward", "K4": "_launch_gather",
             "K4-bwd": "_launch_gather_backward",
             "K5": "_launch_gwc_samples",
             "K5-bwd": "_launch_gwc_samples_backward"}

MIXES = {
    "GwcNet_G": {"K1": K1_MIX, "K2": K2_MIX, "K3": K3_MIX},
    "GwcNet_GC": {"K1": K1_MIX, "K2": GC_K2_MIX, "K3": K3_MIX,
                  "K6": GC_K6_MIX},
    "CFNet": {"K1": CF_K1_MIX, "K2": CF_K2_MIX, "K3": CF_K3_MIX,
              "K4": CF_K4_MIX, "K5": CF_K5_MIX, "K6": CF_K6_MIX},
    "ACVNet": {"K1": K1_MIX, "K2": ACV_K2_MIX, "K3": ACV_K3_MIX,
               "K6": ACV_K6_MIX},
    "DepthAnythingV2": {"K7": DAV2_K7_MIX},
    "PSMNet": {"K2": PS_K2_MIX, "K3": PS_K3_MIX},
    DEFOM: {"K7": DEFOM_K7_MIX},
    DEFOM_L: {"K7": DEFOM_L_K7_MIX},
    "PCWNet_G": {"K1": PCW_K1_MIX, "K2": pcw_k2_mix(40), "K3": PCW_K3_MIX},
    "PCWNet_GC": {"K1": PCW_K1_MIX, "K2": pcw_k2_mix(64), "K3": PCW_K3_MIX,
                  "K6": PCW_K6_MIX},
    RAFT: {},
    IGEV: {"K1": IGEV_K1_MIX},
    SRAFT: {},
    SIGEV: {"K1": IGEV_K1_MIX},
}

# Stages of each forward, as (stage, first module, last module, label of the
# work between the previous stage and this one), and the label of the work
# after the last stage
STAGES = {
    "GwcNet_G": ([
        ("2D trunk", "feature_extraction", "feature_extraction",
         "input cast + view batching"),
        ("dres0", "dres0", "dres0", "cost volume (K1)"),
        ("dres1", "dres1.0", "dres1.2", "glue"),
        ("dres2", "dres2", "dres2", "glue"),
        ("dres3", "dres3", "dres3", "glue"),
        ("dres4", "dres4", "dres4", "glue"),
        ("classif3", "classif3.0", "classif3.2", "glue"),
    ], "head (upsample, softmax, regression)"),
    "GwcNet_GC": ([
        ("2D trunk", "feature_extraction", "feature_extraction",
         "input cast + view batching"),
        ("dres0", "dres0", "dres0", "cost volumes (K1, K6)"),
        ("dres1", "dres1.0", "dres1.2", "glue"),
        ("dres2", "dres2", "dres2", "glue"),
        ("dres3", "dres3", "dres3", "glue"),
        ("dres4", "dres4", "dres4", "glue"),
        ("classif3", "classif3.0", "classif3.2", "glue"),
    ], "head (upsample, softmax, regression)"),
    "ACVNet": ([
        ("2D trunk + concatconv", "feature_extraction", "concatconv.2",
         "input cast + view batching"),
        ("attention branch to att_weights (patch, dres*_att_, "
         "classif_att_)", "patch", "classif_att_.2", "gwc volume (K1)"),
        ("main stack (dres0-dres3)", "dres0", "dres3",
         "concat volume (K6) + attention filter"),
        ("classif2", "classif2.0", "classif2.2", "glue"),
    ], "head (upsample, softmax, regression)"),
    "CFNet": ([
        ("2D trunk", "feature_extraction", "feature_extraction",
         "input cast + view batching"),
        ("volumes 1/8-1/32 (K1, K6)", "volumes", "volumes", "glue"),
        ("1/8-1/32 stacks (dres*)", "dres0", "dres1_6.2", "glue"),
        ("combine1", "combine1", "combine1", "glue"),
        ("dres3", "dres3", "dres3", "glue"),
        ("classif2", "classif2.0", "classif2.2", "glue"),
        ("s3 volumes (K5, K4)", "volume_s3", "volume_s3",
         "s4 head + sampling"),
        ("s3 stack", "confidence0_s3", "confidence_classif1_s3.2", "glue"),
        ("s2 volumes (K5, K4)", "volume_s2", "volume_s2",
         "s3 head + sampling"),
        ("s2 stack", "confidence0_s2", "confidence_classif1_s2.2", "glue"),
    ], "s2 head + final upsample"),
    "DepthAnythingV2": ([
        ("ViT blocks 0-5", "pretrained.blocks.0", "pretrained.blocks.5",
         "input cast, patch embed + pos"),
        ("ViT blocks 6-11", "pretrained.blocks.6", "pretrained.blocks.11",
         "tap norms"),
        ("ViT blocks 12-17", "pretrained.blocks.12", "pretrained.blocks.17",
         "tap norms"),
        ("ViT blocks 18-23", "pretrained.blocks.18", "pretrained.blocks.23",
         "tap norms"),
        ("DPT reassemble", "depth_head.projects.0",
         "depth_head.scratch.layer4_rn", "tap norms"),
        ("DPT fusion chain", "depth_head.scratch.refinenet4",
         "depth_head.scratch.refinenet1", "glue"),
        ("DPT output head", "depth_head.scratch.output_conv1",
         "depth_head.scratch.output_conv2", "path_1 upsample"),
    ], "glue"),
    DEFOM: ([
        ("ViT blocks 0-11 (K7)", "defomencoder.depth_anything.pretrained."
         "blocks.0", "defomencoder.depth_anything.pretrained.blocks.11",
         "input resize, patch embed + pos"),
        ("DPT depth head", "defomencoder.depth_anything.depth_head",
         "defomencoder.depth_anything.depth_head", "tap norms"),
        ("DPT feature head", "defomencoder.depth_anything.depth_feat",
         "defomencoder.depth_anything.depth_feat", "glue"),
        ("cnet", "cnet", "cnet", "initial disparity"),
        ("fnet", "fnet", "fnet", "glue"),
        ("scale update blocks (8)", "scale_update_block",
         "scale_update_block",
         "context convs, correlation, pyramid, scale lookups"),
        ("update blocks (24)", "update_block", "update_block",
         "lookups, disparity updates"),
    ], "final convex upsample"),
    DEFOM_L: ([
        ("ViT blocks 0-23 (K7)", "defomencoder.depth_anything.pretrained."
         "blocks.0", "defomencoder.depth_anything.pretrained.blocks.23",
         "input resize, patch embed + pos"),
        ("DPT heads", "defomencoder.depth_anything.depth_head",
         "defomencoder.depth_anything.depth_feat", "tap norms"),
        ("cnet + fnet", "cnet", "fnet", "initial disparity"),
        ("scale update blocks (8)", "scale_update_block",
         "scale_update_block",
         "context convs, correlation, pyramid, scale lookups"),
        ("update blocks (24)", "update_block", "update_block",
         "lookups, disparity updates"),
    ], "final convex upsample"),
    "PSMNet": ([
        ("2D trunk (SPP)", "feature_extraction", "feature_extraction",
         "input cast + view batching"),
        ("dres0.0 (concat-volume conv)", "dres0.0", "dres0.0", "glue"),
        ("dres0.2 + dres1", "dres0.2", "dres1.2", "glue"),
        ("dres2", "dres2", "dres2", "glue"),
        ("dres3", "dres3", "dres3", "glue (+ cost0)"),
        ("dres4", "dres4", "dres4", "glue (+ cost0)"),
        ("classif1", "classif1.0", "classif1.2", "glue (+ cost0)"),
        ("classif2", "classif2.0", "classif2.2", "glue"),
        ("classif3", "classif3.0", "classif3.2", "glue (cascade adds)"),
    ], "cascade add + head (upsample, softmax, regression)"),
}
for _name, _volumes in (("PCWNet_G", "K1"), ("PCWNet_GC", "K1, K6")):
    STAGES[_name] = ([
        ("2D trunk", "feature_extraction", "feature_extraction",
         "input cast + view batching"),
        (f"volumes 1/4-1/32 ({_volumes})", "volumes", "volumes", "glue"),
        ("first stack (dres0, dres1)", "dres0", "dres1.2", "glue"),
        ("HourglassUp3 (combine1)", "combine1", "combine1", "glue"),
        ("hourglasses (dres2-dres4)", "dres2", "dres4", "glue"),
        ("classif3", "classif3.0", "classif3.2", "glue"),
        ("refinement warp + correlation", "warp", "warp",
         "regression (upsample, softmax)"),
        ("refinement net (dispupsample, refinenet3)", "dispupsample",
         "refinenet3", "glue"),
    ], "glue")
STAGES[RAFT] = ([
    ("fnet (both views)", "fnet", "fnet", "input normalisation"),
    ("cnet", "cnet", "cnet", "correlation volumes (bands, cuBLAS)"),
    ("context convs", "context_zqr_convs.0", "context_zqr_convs.2", "tanh"),
    ("update blocks (32)", "update_block", "update_block",
     "lookups, flow updates"),
], "final convex upsample")
STAGES[IGEV] = ([
    ("features + stems (both views)", "feature", "stem_4",
     "input normalisation"),
    ("descriptors", "conv", "desc", "glue"),
    ("corr_stem + corr_feature_att", "corr_stem", "corr_feature_att",
     "gwc volume (K1)"),
    ("GEV hourglass", "cost_agg", "cost_agg", "glue"),
    ("classifier", "classifier", "classifier", "glue"),
    ("cnet", "cnet", "cnet",
     "initial disparity, volume pyramid, correlation bands"),
    ("context convs", "context_zqr_convs.0", "context_zqr_convs.2", "tanh"),
    ("update blocks (32)", "update_block", "update_block",
     "geometry lookups, disparity updates"),
    ("superpixel weights", "spx_2_gru", "spx_gru", "glue"),
], "context upsample")
# the Selective models: CAM and SAM (one each, called at the three scales)
# in place of the context convs
ATTENTION = ("context attention (CAM, SAM; 3 scales)", "cam", "sam",
             "tanh, ReLU")
STAGES[SRAFT] = ([*STAGES[RAFT][0][:2], ATTENTION, (
    "update blocks (32)", "update_block", "update_block",
    "lookups, disparity updates")], STAGES[RAFT][1])
STAGES[SIGEV] = ([ATTENTION if first.startswith("context_zqr") else
                  (stage, first, last, before)
                  for stage, first, last, before in STAGES[IGEV][0]],
                 STAGES[IGEV][1])
GAP = "between forwards (host)"
# 3 timed forwards after 1 warm one since phase 22 came (5 after 2 since
# phase 20, 10 after 3 before), and one traced forward (3 before phase 20)
FWD_ITERS, FWD_WARMUP = 3, 1
TRACE_ITERS = 1        # forwards in the torch.profiler trace

# The design each type's K2, K7 and K7-bwd launches must run, and the one
# design every K1, (Co = 1) K3, K4, K5 and K6 launch of a forward (and each
# of their backward kernels) must run in both types
DESIGN = {F32: TF32X3, BF16: "mma"}
ONE_DESIGN = {"K1": "stream", "K1-bwd": "rowpass", "K3": "stencil",
              "K4": "direct", "K5": "direct", "K6": "rows",
              "K6-bwd": "direct", "K4-bwd": "staged", "K5-bwd": "staged"}
DESIGN_TAGS = tuple(KERNELS)                  # every wrapper has .designs
# bfloat16 forward with K2 and K7 against the same forward with their plain
# versions: mean |d| limit in px
PLAIN_SWAP_MEAN_PX = 0.5

# max|err| limits against the plain version, as a share of max|ref|
REL_TOL = {"K1": {F32: 1e-5, BF16: 1e-2}, "K1-bwd": {F32: 1e-5, BF16: 1e-2},
           "K2": {F32: 1e-4, BF16: 2e-2},
           "K3": {F32: 1e-4, BF16: 2e-2},
           "K4": {F32: 0.0, BF16: 0.0}, "K5": {F32: 1e-5, BF16: 1e-2},
           "K6": {F32: 0.0, BF16: 0.0}, "K7": {F32: 1e-5, BF16: 1e-2},
           "K6-bwd": {F32: 1e-5, BF16: 1e-2},
           "K4-bwd": {F32: 1e-5, BF16: 1e-2},
           "K5-bwd": {F32: 1e-5, BF16: 1e-2},
           "K7-bwd-dkv": {F32: 1e-5, BF16: 1e-2},
           "K7-bwd-dq": {F32: 1e-5, BF16: 1e-2}}
# K7's forward and backward kernels together (autograd through `attention`)
# against the plain chain (the plain output and log-sum-exp): the chain
# carries the forward kernel's own error (1e-5 of max|o| in float32) into
# di = rowsum(dO o) and into dS = P (dP - di), where dP - di cancels
K7_CHAIN_TOL = {F32: 1e-4, BF16: 2e-2}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def trace(fn, iters: int, grad: bool = False,
          host: bool = True) -> tuple[dict, dict]:
    """Device ms and launches per call of each kernel that `fn` launches
    (the forward's kernel families), and host ms and calls per call of each
    operator (none unless `host`: the device's activity alone is traced,
    and a trace of a train step's ~5,000-74,000 launches then parses a
    fraction of the events), from a ``torch.profiler`` trace of `iters`
    calls (with autograd off unless `grad`)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with torch.set_grad_enabled(grad):
        with profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
    events = prof.key_averages()
    device = {evt.key: (evt.self_device_time_total / 1e3 / iters,
                        evt.count / iters)
              for evt in events
              if evt.device_type == torch.autograd.DeviceType.CUDA
              and evt.self_device_time_total > 0}
    host = {evt.key: (evt.self_cpu_time_total / 1e3 / iters,
                      evt.count / iters)
            for evt in events
            if evt.device_type == torch.autograd.DeviceType.CPU
            and evt.self_cpu_time_total > 0}
    return device, host


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call of `fn`: CUDA events around `iters` calls
    that the host enqueues while a sleep kernel holds the stream, so that
    the calls run back to back and the host's launch overhead (the ctypes
    wrapper, ATen's dispatch) does not count for small kernels. (Device
    times from ``torch.profiler`` were tried and lost events after the
    trace of CFNet's f32 forward.)"""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)     # ~50 ms at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def reset_counts() -> None:
    for fn, *_ in KERNELS.values():
        fn.launches = 0
        fn.shapes.clear()
        fn.designs.clear()


def designs_of(tag) -> dict:
    """Launches of a kernel by design since the counts were reset, as
    ``{"mma 128x64": n}``: the design and its tile (K2, K7: voxels or
    queries x channels or keys of a block; K1: W tile x groups x
    disparities of a block; K3 "stencil": output planes a block; K4: pixels
    x threads of a block x bytes a word x samples a thread item; K5: pixels
    x threads of a block x groups a thread item; K6: bytes a store x bytes
    a shared word x W tile x disparities a run)."""
    return {" ".join([k[0], "x".join(map(str, k[1:]))]).strip(): n
            for k, n in sorted(KERNELS[tag][0].designs.items())}


def require_design(tag, kind, what) -> str:
    """The designs kernel `tag` ran since the counts were reset, required
    to be all of `kind`."""
    ran = designs_of(tag)
    require(list(ran) and all(k.split()[0] == kind for k in ran),
            f"{tag} {what} ran {ran}, not {kind}")
    return " ".join(ran)


def randn(shape, dtype, gen, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(DEV, dtype)


def samples_for(b, s, h, w, lo, hi, gen):
    """Integer-valued float32 disparity samples in [lo, hi] on the card."""
    return torch.randint(lo, hi + 1, (b, s, h, w), generator=gen).float().to(
        DEV)


def held(tag, dtype, got, want, what) -> float:
    """max|got - want|, required within REL_TOL · max|want|."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = REL_TOL[tag][dtype] * want.float().abs().max().item()
    print(f"  {tag} {DTYPE_NAME[dtype]} {what}: max|err| {err:.3e} "
          f"(tol {tol:.3e})")
    require(err <= tol, f"{tag} {DTYPE_NAME[dtype]} {what}")
    return err


def all_shapes(tag):
    """Every shape that an eval forward or a train step launches `tag`
    at, but PCWNet's and the iterative models' (phases 20-22 hold
    those)."""
    return {key for mixes in (MIXES, TRAIN_MIXES, TRAIN_CHECK_MIXES)
            for name, mix in mixes.items()
            if name not in PCW_MODELS + ITERATIVE + SELECTIVE
            for key in mix.get(tag, {})}


# ---------------------------------------------------------------- phase 3
def check_gwc(gen, model_cases=None) -> dict:
    """K1 at `model_cases` (default: every launch shape of the forwards and
    train steps of phases 8-19, with ragged cases)."""
    errs = {}
    cases = [] if model_cases else [
        # W not a multiple of the tile, W < D, C/G = 3, B = 2; odd G (one
        # group a bf16 thread); a row of 6 channels (plain staging, no
        # 16-byte copies)
        (2, 5, 37, 48, 48, 16), (1, 3, 21, 24, 9, 3), (1, 4, 70, 320, 48, 40),
        (1, 2, 9, 6, 13, 6)]
    model_cases = model_cases or all_shapes("K1")
    cases = [*sorted(model_cases), *cases]
    for dtype in (F32, BF16):
        worst = 0.0
        for b, h, w, c, d, g in cases:
            left = randn((b, h, w, c), dtype, gen)
            right = randn((b, h, w, c), dtype, gen)
            reset_counts()
            got = build_gwc_volume(left, right, d, g)
            design = require_design("K1", ONE_DESIGN["K1"],
                                    DTYPE_NAME[dtype])
            err = held("K1", dtype, got,
                       gwc_volume_reference(left.float(), right.float(), d,
                                            g),
                       f"{(b, h, w, c)} D={d} G={g} [{design}]")
            if (b, h, w, c, d, g) in model_cases:
                worst = max(worst, err)
        errs[dtype] = worst
    return errs


def check_gwc_backward(gen) -> dict:
    """K1's backward at every eval and train launch shape of K1 (GwcNet_G,
    GwcNet_GC and ACVNet's; CFNet's three, C/G = 4 at 1/8; the card-vs-CPU
    train check's; the eval rows at 480x640 take W tiles) and ragged cases,
    against ``torch.autograd.grad`` of `gwc_volume_reference` in float32 on
    the same inputs, with K1's tolerances; every launch on the "rowpass"
    design, twice for the same bits."""
    errs = {}
    model_cases = sorted(all_shapes("K1"))
    # W not a multiple of the strip with D > W and B = 1, C/G = 3; B = 3 with
    # C/G = 1; C/G = 16 with D > W; W 70, B 2 at GwcNet's widths; a long
    # row at GwcNet's widths (W tiles)
    cases = [*model_cases, (1, 3, 37, 48, 48, 16), (3, 2, 21, 24, 9, 24),
             (1, 2, 9, 32, 13, 2), (2, 3, 70, 320, 48, 40),
             (1, 2, 320, 320, 48, 40)]
    for dtype in (F32, BF16):
        worst = 0.0
        for b, h, w, c, d, g in cases:
            left = randn((b, h, w, c), dtype, gen)
            right = randn((b, h, w, c), dtype, gen)
            grad = randn((b, d, h, w, g), dtype, gen)
            (dl, dr), design = repeat_bits(
                "K1-bwd", lambda: gwc_volume_backward(left, right, grad, d, g))
            lf = left.float().requires_grad_()
            rf = right.float().requires_grad_()
            want = torch.autograd.grad(gwc_volume_reference(lf, rf, d, g),
                                       (lf, rf), grad.float())
            for name, got, ref in (("dl", dl, want[0]), ("dr", dr, want[1])):
                require(got.dtype == dtype and got.shape == left.shape,
                        f"K1-bwd {name} {got.dtype} {tuple(got.shape)}")
                err = held("K1-bwd", dtype, got, ref,
                           f"{name} {(b, h, w, c)} D={d} G={g} [{design}]")
                if (b, h, w, c, d, g) in model_cases:
                    worst = max(worst, err)
            del want, lf, rf
        errs[dtype] = worst
    return errs


# ---------------------------------------------------------------- phase 4
def k2_inputs(ci, co, d, h, w, residual, dtype, gen, b=1):
    x = randn((b, d, h, w, ci), dtype, gen)
    k = randn((3, 3, 3, ci, co), dtype, gen, (2.0 / (27 * ci)) ** 0.5)
    scale = (torch.rand(co, generator=gen) + 0.5).to(DEV)
    bias = randn((co,), F32, gen)
    res = randn((b, d, h, w, co), dtype, gen) if residual else None
    return x, k, scale, bias, res


def check_conv(gen, model_cases=None) -> dict:
    """K2 at `model_cases` (default: every launch shape of the forwards of
    phases 8-18, with ragged cases), each of their volume shapes also with
    both epilogue options on and off."""
    errs = {}
    ragged = not model_cases
    model_cases = model_cases or all_shapes("K2")
    cases = dict.fromkeys(sorted(model_cases))
    for key in sorted(model_cases):
        for res, relu in ((False, False), (True, True)):
            cases[key[:6] + (res, relu)] = None
    # ragged: Ci not a multiple of 16 (1, 3, 12, 33, 65; all but 40 also
    # not of 8, where the halo goes through plain loads), Co 8, 33 and 40
    # (ragged channel tiles, scalar stores at 33), odd H and W, D 1 and 2
    for key in ((2, 5, 7, 19, 12, 40, True, True),
                (1, 3, 7, 19, 1, 8, False, True),
                (2, 2, 9, 35, 3, 33, True, True),
                (1, 1, 5, 7, 33, 8, True, False),
                (1, 2, 11, 13, 65, 33, False, False)) if ragged else ():
        cases[key] = None
    for dtype in (F32, BF16):
        worst = 0.0
        for b, d, h, w, ci, co, res, relu in cases:
            x, k, scale, bias, r = k2_inputs(ci, co, d, h, w, res, dtype, gen,
                                             b)
            kp = pack_conv3d_weight(k)
            if dtype == F32:          # the same bits twice
                (got,), _ = repeat_bits(
                    "K2", lambda: conv3d_fused(x, kp, scale, bias, r, relu),
                    DESIGN[dtype])
            else:
                reset_counts()
                got = conv3d_fused(x, kp, scale, bias, r, relu)
            design = designs_of("K2")
            require(list(design) and all(key.split()[0] == DESIGN[dtype]
                                         for key in design),
                    f"K2 {DTYPE_NAME[dtype]} ran {design}")
            err = held("K2", dtype, got,
                       conv3d_fused_reference(
                           x.float(), k.float(), scale, bias,
                           None if r is None else r.float(), relu),
                       f"Ci={ci} Co={co} {(b, d, h, w)} res={res} "
                       f"relu={relu} [{' '.join(design)}]")
            if (b, d, h, w, ci, co) in {key[:6] for key in model_cases}:
                worst = max(worst, err)
        errs[dtype] = worst
    return errs


# ---------------------------------------------------------------- phase 5
def k3_inputs(b, d, h, w, ci, co, dtype, gen):
    x = randn((b, d, h, w, ci), dtype, gen)
    k = randn((3, 3, 3, ci, co), dtype, gen, (2.0 / (27 * ci)) ** 0.5)
    return x, k


def check_conv3d(gen, model_cases=None) -> dict:
    """K3 at `model_cases` (default: every launch shape of the stereo
    forwards of phases 8-12, with ragged cases: Co 8 and 33 (the second
    tile ragged), odd H and W, D < 3, Ci not a multiple of the staged
    chunk, B = 2)."""
    errs = {}
    cases = [] if model_cases else [
        (2, 5, 7, 37, 32, 1), (1, 2, 9, 33, 32, 1), (1, 1, 5, 7, 16, 1),
        (2, 3, 7, 19, 12, 8), (1, 4, 9, 35, 32, 33), (1, 3, 17, 30, 5, 1),
        (1, 2, 11, 9, 5, 1)]
    model_cases = model_cases or all_shapes("K3")
    cases = [*sorted(model_cases), *cases]
    for dtype in (F32, BF16):
        errs[dtype] = 0.0
        for b, d, h, w, ci, co in cases:
            x, k = k3_inputs(b, d, h, w, ci, co, dtype, gen)
            reset_counts()
            got = conv3d(x, k)
            design = require_design(
                "K3", ONE_DESIGN["K3"] if co == 1 else "direct",
                f"{DTYPE_NAME[dtype]} Co={co}")
            require(got.dtype == dtype and got.shape == (b, d, h, w, co),
                    f"K3 output {got.dtype} {tuple(got.shape)}")
            err = held("K3", dtype, got,
                       conv3d_reference(x.float(), k.float()),
                       f"{(b, d, h, w)} Ci={ci} Co={co} [{design}]")
            if (b, d, h, w, ci, co) in model_cases:
                errs[dtype] = max(errs[dtype], err)
    return errs


# ---------------------------------------------------------------- phase 6
def check_samples(gen) -> tuple[dict, dict]:
    """K4 and K5 at CFNet's launch shapes and ragged cases, with samples in
    [-3, max_shift + 4] so that both clamps and the x < 0 zeros are met. K4,
    on its "direct" design: W not a multiple of the tile (45, 37, 70, 19,
    40), C 1, 5 and 7 (2-byte bfloat16 words), 6 (12-byte bfloat16 pixels)
    and 12, S = 1, a wide row (C 320), B = 2, a NaN sample, and each case
    also on a right map one element past 16-byte alignment (narrower
    words). K5, on its "direct" design: W not a multiple of the tile (45,
    70), C/G = 3 with odd G (one group a bfloat16 thread), C/G = 5 (no
    compile-time count), S = 1, blocks of 2 (float32) or 4 (bfloat16)
    pixels (W 40, C 320), B = 2."""
    errs4, errs5 = {}, {}
    k4_cases = [*CF_K4_MIX, (2, 3, 45, 5, 7, 20), (1, 2, 40, 320, 3, 200),
                (1, 2, 37, 1, 3, 9), (1, 3, 70, 6, 1, 30),
                (2, 2, 19, 12, 4, 25), (1, 2, 40, 7, 5, 50)]
    k5_cases = [*CF_K5_MIX, (2, 3, 45, 12, 7, 4, 20),
                (1, 2, 40, 320, 3, 40, 200), (1, 3, 70, 15, 1, 3, 9),
                (1, 4, 70, 160, 16, 40, 48), (2, 2, 19, 10, 4, 2, 25)]
    for dtype in (F32, BF16):
        errs4[dtype] = errs5[dtype] = 0.0
        for b, h, w, c, s, ms in k4_cases:
            for shifted in (False, True):
                n = b * h * w * c
                right = randn((n + shifted,), dtype, gen)[
                    int(shifted):].view(b, h, w, c)
                smp = samples_for(b, s, h, w, -3, ms + 4, gen)
                smp[0, 0, 0, -1] = float("nan")
                reset_counts()
                got = gather_right_by_samples(right, smp, ms)
                design = require_design("K4", ONE_DESIGN["K4"],
                                        DTYPE_NAME[dtype])
                err = held("K4", dtype, got,
                           gather_right_by_samples_reference(
                               right, smp.nan_to_num(0.0), ms),
                           f"{(b, h, w, c)} S={s} max_shift={ms}"
                           f"{' misaligned base' if shifted else ''} "
                           f"[{design}]")
                if (b, h, w, c, s, ms) in CF_K4_MIX and not shifted:
                    errs4[dtype] = max(errs4[dtype], err)
        for b, h, w, c, s, g, ms in k5_cases:
            left = randn((b, h, w, c), dtype, gen)
            right = randn((b, h, w, c), dtype, gen)
            smp = samples_for(b, s, h, w, -3, ms + 4, gen)
            reset_counts()
            got = gwc_volume_from_samples(left, right, smp, g, ms)
            design = require_design("K5", ONE_DESIGN["K5"],
                                    DTYPE_NAME[dtype])
            err = held("K5", dtype, got,
                       gwc_volume_from_samples_reference(
                           left.float(), right.float(), smp, g, ms),
                       f"{(b, h, w, c)} S={s} G={g} max_shift={ms} "
                       f"[{design}]")
            if (b, h, w, c, s, g, ms) in CF_K5_MIX:
                errs5[dtype] = max(errs5[dtype], err)
    return errs4, errs5


def check_concat(gen, model_cases=None) -> dict:
    """K6 on its "rows" design at `model_cases` (default: the stereo
    models' launch shapes of phases 8-14, masked: CFNet, GwcNet_GC;
    unmasked: ACVNet, with ragged cases, the left half masked and not: D >
    W (zero planes, or zero right halves unmasked), odd C (rows of 8- and
    4-byte stores: W x C odd in bfloat16), bfloat16 C = 12 (24-byte halves,
    vectors that straddle them), a row past the plan's shared memory (W
    tiles); and feature bases one element past 16-byte alignment (narrow
    staging))."""
    errs = {}
    ragged = () if model_cases else (
        (2, 3, 37, 12, 45), (1, 2, 9, 5, 4), (1, 2, 10, 32, 14),
        (1, 3, 11, 3, 7), (1, 4, 160, 12, 48), (1, 2, 20, 700, 3))
    model_cases = model_cases or all_shapes("K6")
    cases = [*sorted(model_cases)]
    for key in ragged:
        cases += [(*key, True), (*key, False)]
    for dtype in (F32, BF16):
        errs[dtype] = 0.0
        for b, h, w, c, d, mask_left in cases:
            for shifted in (False, True):
                if shifted and (b, h, w, c, d, mask_left) in model_cases:
                    continue
                n = b * h * w * c
                left, right = (randn((n + shifted,), dtype, gen)[
                    int(shifted):].view(b, h, w, c) for _ in range(2))
                reset_counts()
                got = build_concat_volume(left, right, d, mask_left)
                design = require_design("K6", ONE_DESIGN["K6"],
                                        DTYPE_NAME[dtype])
                err = held("K6", dtype, got,
                           concat_volume_reference(left, right, d, mask_left),
                           f"{(b, h, w, c)} D={d} mask_left={mask_left}"
                           f"{' misaligned bases' if shifted else ''} "
                           f"[{design}]")
                zero = got[:, w:] if mask_left else got[:, w:, ..., c:]
                require(d <= w or not zero.any(),
                        f"K6 planes d >= W not zero at {(b, h, w, c, d)}")
                if (b, h, w, c, d, mask_left) in model_cases:
                    errs[dtype] = max(errs[dtype], err)
    return errs


def repeat_bits(tag, call, kind=None) -> tuple:
    """Two launches of kernel `tag` on the same inputs, required to give the
    same bits (no atomics), on design `kind` (default: its one design)."""
    reset_counts()
    first, again = call(), call()
    require(KERNELS[tag][0].launches == 2, f"{tag} launched "
                                           f"{KERNELS[tag][0].launches}x")
    design = require_design(tag, kind or ONE_DESIGN[tag], "")
    first = first if isinstance(first, tuple) else (first,)
    again = again if isinstance(again, tuple) else (again,)
    require(all(torch.equal(a, b) for a, b in zip(first, again)),
            f"{tag} differs between two runs on the same inputs")
    return first, design


def check_concat_backward(gen) -> dict:
    """K6's backward on its "direct" design at every train launch shape
    (GwcNet_GC and CFNet masked, ACVNet unmasked) and ragged cases, with
    the left half masked and not: D > W (planes with no right half), odd C
    (one channel a thread item), C = 3 and 5, a gradient one element past
    16-byte alignment (narrower words); against the plain version in
    float32 on the same inputs, and the same bits twice."""
    errs = {}
    model_cases = sorted(all_shapes("K6-bwd"))
    cases = [(*k, False) for k in model_cases]
    for ragged in ((2, 3, 37, 12, 45), (1, 2, 9, 5, 4), (1, 3, 11, 3, 7),
                   (1, 2, 10, 32, 14), (1, 4, 160, 12, 48)):
        cases += [(*ragged, m, shifted) for m in (True, False)
                  for shifted in (False, True)]
    for dtype in (F32, BF16):
        errs[dtype] = 0.0
        for b, h, w, c, d, mask_left, shifted in cases:
            n = b * d * h * w * 2 * c
            grad = randn((n + shifted,), dtype, gen)[int(shifted):].view(
                b, d, h, w, 2 * c)
            (dl, dr), design = repeat_bits(
                "K6-bwd", lambda: concat_volume_backward(grad, d, mask_left))
            want = concat_volume_backward_reference(grad.float(), d,
                                                    mask_left)
            for name, got, ref in (("dl", dl, want[0]), ("dr", dr, want[1])):
                require(got.dtype == dtype and got.shape == (b, h, w, c),
                        f"K6-bwd {name} {got.dtype} {tuple(got.shape)}")
                err = held("K6-bwd", dtype, got, ref,
                           f"{name} {(b, h, w, c)} D={d} mask_left="
                           f"{mask_left}{' misaligned' if shifted else ''} "
                           f"[{design}]")
                if (b, h, w, c, d, mask_left) in model_cases:
                    errs[dtype] = max(errs[dtype], err)
    return errs


def backward_samples(b, s, h, w, ms, gen):
    """Float32 samples in [-3, ms + 4] (both clamps, reads past the image's
    left edge), with a NaN, fractions in one plane, and one row whose every
    sample reads right pixel 0 wherever it can (w - d = 0: one pixel's list
    takes S x min(W, ms + 1) entries)."""
    smp = samples_for(b, s, h, w, -3, ms + 4, gen)
    smp[0, 0, 0, -1] = float("nan")
    smp[-1, -1] += 0.5
    if h > 1:
        smp[0, :, 1] = torch.arange(w, device=DEV, dtype=torch.float32)
    return smp


def check_samples_backward(gen) -> tuple[dict, dict]:
    """K4's and K5's backward kernels on their "staged" designs
    at every train launch shape (CFNet's s3 and s2 stages, and the
    card-vs-CPU check's) and ragged cases: W not a multiple of 32, C 1, 5,
    6 and 12, C/G 5 and 8, odd G, S = 1, samples at 0, at max_shift and
    past the image edge, fractional samples, a NaN, and a row whose every
    sample lands on one right pixel; K4's also with its gradient one
    element past 16-byte alignment (narrower copies, element by element in
    bfloat16) and rows of 800 pixels (chunks of 3 float32 channels, one
    block an SM; one bfloat16 channel a chunk); against the plain versions
    in float32 on the same inputs, and the same bits twice."""
    errs4, errs5 = {}, {}
    k4_model = sorted(all_shapes("K4-bwd"))
    k5_model = sorted(all_shapes("K5-bwd"))
    k4_cases = [*((*k, False) for k in k4_model), (2, 3, 45, 5, 7, 20, False),
                (2, 3, 45, 5, 7, 20, True), (1, 2, 37, 1, 3, 9, False),
                (1, 3, 70, 6, 1, 30, False), (2, 2, 19, 12, 4, 25, True),
                (1, 2, 800, 6, 12, 96, False)]
    k5_cases = [*k5_model, (2, 3, 45, 12, 7, 4, 20), (1, 3, 70, 15, 1, 3, 9),
                (1, 2, 40, 320, 3, 40, 200), (2, 2, 19, 10, 4, 2, 25)]
    for dtype in (F32, BF16):
        errs4[dtype] = errs5[dtype] = 0.0
        for b, h, w, c, s, ms, shifted in k4_cases:
            smp = backward_samples(b, s, h, w, ms, gen)
            n = b * s * h * w * c
            grad = randn((n + shifted,), dtype, gen)[int(shifted):].view(
                b, s, h, w, c)
            (got,), design = repeat_bits(
                "K4-bwd", lambda: gather_right_by_samples_backward(
                    grad, smp, ms))
            err = held("K4-bwd", dtype, got,
                       gather_right_by_samples_backward_reference(
                           grad.float(), smp.nan_to_num(0.0), ms),
                       f"{(b, h, w, c)} S={s} max_shift={ms}"
                       f"{' misaligned' if shifted else ''} [{design}]")
            if (b, h, w, c, s, ms) in k4_model:
                errs4[dtype] = max(errs4[dtype], err)
        for b, h, w, c, s, g, ms in k5_cases:
            left = randn((b, h, w, c), dtype, gen)
            right = randn((b, h, w, c), dtype, gen)
            smp = backward_samples(b, s, h, w, ms, gen)
            grad = randn((b, s, h, w, g), dtype, gen)
            (dl, dr), design = repeat_bits(
                "K5-bwd", lambda: gwc_volume_from_samples_backward(
                    left, right, smp, grad, g, ms))
            want = gwc_volume_from_samples_backward_reference(
                left.float(), right.float(), smp.nan_to_num(0.0),
                grad.float(), g, ms)
            for name, got, ref in (("dl", dl, want[0]), ("dr", dr, want[1])):
                err = held("K5-bwd", dtype, got, ref,
                           f"{name} {(b, h, w, c)} S={s} G={g} max_shift="
                           f"{ms} [{design}]")
                if (b, h, w, c, s, g, ms) in k5_model:
                    errs5[dtype] = max(errs5[dtype], err)
            del want
    return errs4, errs5


# ---------------------------------------------------------------- phase 7
def check_attention(gen) -> tuple[dict, dict]:
    """K7 at DepthAnythingV2-vitl's launch shape, vits' (6 heads),
    DEFOMStereo_S's eval (two views at 420x560, N = 1201) and train (B 4,
    N = 641) launches, MonSter's two views at 420x560 and ragged N (1, 77,
    1025), at the ViT's scale 1/8; and logits of ~±30 (scale 1), where a
    wrong running max shows. Returns the errors at DepthAnythingV2's and at
    DEFOMStereo_S's eval launch shape, by type."""
    errs, defom = {}, {}
    cases = [(*key[:3], 0.125) for key in DAV2_K7_MIX]
    cases += [(2, 6, 1201, 0.125), (8, 6, 641, 0.125)]
    cases += [(1, 6, 1370, 0.125), (2, 16, 1201, 0.125), (1, 2, 1, 0.125),
              (1, 3, 15, 0.125), (2, 2, 64, 0.125), (1, 2, 65, 1.0),
              (2, 3, 77, 0.125), (1, 4, 1025, 0.125), (1, 4, 2048, 0.125),
              (1, 2, 200, 1.0)]
    for dtype in (F32, BF16):
        errs[dtype] = 0.0
        for b, heads, n, scale in cases:
            q, k, v = (randn((b, heads, n, 64), dtype, gen) for _ in range(3))
            if dtype == F32:          # the same bits twice
                (got,), _ = repeat_bits(
                    "K7", lambda: attention(q, k, v, scale), DESIGN[dtype])
            else:
                reset_counts()
                got = attention(q, k, v, scale)
            require(list(designs_of("K7")) == [f"{DESIGN[dtype]} 64x64"],
                    f"K7 {DTYPE_NAME[dtype]} ran {designs_of('K7')}")
            require(got.dtype == dtype and got.shape == q.shape,
                    f"K7 output {got.dtype} {tuple(got.shape)}")
            err = held("K7", dtype, got,
                       attention_reference(q.float(), k.float(), v.float(),
                                           scale),
                       f"{(b, heads, n, 64)} scale={scale}")
            if (b, heads, n, 64) in DAV2_K7_MIX:
                errs[dtype] = max(errs[dtype], err)
            if (b, heads, n, 64) in DEFOM_K7_MIX:
                defom[dtype] = err
    return errs, defom


# K7-bwd: DEFOMStereo_S's train launch (B 4: 8 views x 6 heads, N 641), its
# 480x640 view pair (2 x 6, N 1201), and check_attention's ragged cases
K7_BWD_CASES = [(8, 6, 641, 0.125), (4, 6, 1201, 0.125), (1, 2, 1, 0.125),
                (1, 3, 15, 0.125), (2, 2, 64, 0.125), (1, 2, 65, 1.0),
                (2, 3, 77, 0.125), (1, 4, 1025, 0.125), (1, 2, 200, 1.0)]
K7_BWD_TRAIN_SHAPE = (8, 6, 641, 64)


def backward_gates(tag, dtype, got, want, what, floor=None) -> float:
    """max|got - want| of one K7-bwd output against REL_TOL · max(max|ref|,
    `floor`): at N = 1, dQ and dK are zero (the softmax of one key is
    constant) and both sides give rounding noise, held against dV's
    scale."""
    err = (got.float() - want.float()).abs().max().item()
    ref = max(want.float().abs().max().item(), floor or 0.0)
    tol = REL_TOL[tag][dtype] * ref
    print(f"  {tag} {DTYPE_NAME[dtype]} {what}: max|err| {err:.3e} (tol "
          f"{tol:.3e})")
    require(err <= tol, f"{tag} {DTYPE_NAME[dtype]} {what}")
    return err


def check_attention_backward(gen) -> dict:
    """K7-bwd at K7_BWD_CASES in both types: (1) the forward kernel's row
    log-sum-exp against the plain one, within K7's float32 gate · max|lse|
    in both types (its logits ~±30 at scale 1, where a wrong lse shows);
    (2) each backward kernel (dK, dV from "dkv", dQ from "dq", both on
    their type's design, DESIGN) against `attention_backward_reference` on
    the same q, k, v, dO and the forward kernel's output and lse, within
    REL_TOL, run twice for the same bits; (3) autograd through `attention` (the
    forward with its lse, then both backward kernels) against the plain
    chain within K7_CHAIN_TOL. Returns the largest gate (2) errors at
    DEFOMStereo_S's train launch, by tag and type."""
    errs = {"K7-bwd-dkv": {}, "K7-bwd-dq": {}}
    for dtype in (F32, BF16):
        for tag in errs:
            errs[tag][dtype] = 0.0
        for b, heads, n, scale in K7_BWD_CASES:
            shape = (b, heads, n, 64)
            q, k, v, do = (randn(shape, dtype, gen) for _ in range(4))
            out, lse = attention_with_lse(q, k, v, scale)
            want_lse = attention_lse_reference(q, k, scale)
            err = (lse - want_lse).abs().max().item()
            tol = REL_TOL["K7"][F32] * want_lse.abs().max().item()
            print(f"  K7 lse {DTYPE_NAME[dtype]} {shape} scale={scale}: "
                  f"max|err| {err:.3e} (tol {tol:.3e})")
            require(err <= tol, f"K7 {DTYPE_NAME[dtype]} lse {shape}")
            di = (do.float() * out.float()).sum(-1)
            (dk, dv), _ = repeat_bits("K7-bwd-dkv", lambda: (
                attention_backward_dkv(q, k, v, do, lse, di, scale)),
                DESIGN[dtype])
            (dq,), _ = repeat_bits("K7-bwd-dq", lambda: (
                attention_backward_dq(q, k, v, do, lse, di, scale)),
                DESIGN[dtype])
            for g in (dq, dk, dv):
                require(g.dtype == dtype and g.shape == q.shape,
                        f"K7-bwd output {g.dtype} {tuple(g.shape)}")
            wq, wk, wv = attention_backward_reference(
                q.float(), k.float(), v.float(), out.float(), do.float(),
                lse, scale)
            floor = wv.abs().max().item() if n == 1 else None
            what = f"{shape} scale={scale}"
            e = [backward_gates("K7-bwd-dkv", dtype, dk, wk, f"dK {what}",
                                floor),
                 backward_gates("K7-bwd-dkv", dtype, dv, wv, f"dV {what}"),
                 backward_gates("K7-bwd-dq", dtype, dq, wq, f"dQ {what}",
                                floor)]
            if shape == K7_BWD_TRAIN_SHAPE:
                errs["K7-bwd-dkv"][dtype] = max(e[:2])
                errs["K7-bwd-dq"][dtype] = e[2]
            # the chain: autograd through the kernels against the plain one
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            reset_counts()
            got = torch.autograd.grad(attention(*leaves, scale), leaves, do)
            require(attention.launches == 1
                    and attention_backward_dkv.launches == 1
                    and attention_backward_dq.launches == 1,
                    "autograd through attention did not launch K7, "
                    "K7-bwd-dkv and K7-bwd-dq once each")
            want = attention_backward_reference(
                q.float(), k.float(), v.float(),
                attention_reference(q.float(), k.float(), v.float(), scale),
                do.float(), want_lse, scale)
            for name, g, w in zip("QKV", got, want):
                ref = max(w.abs().max().item(), floor or 0.0)
                err = (g.float() - w).abs().max().item()
                tol = K7_CHAIN_TOL[dtype] * ref
                require(err <= tol, f"K7 + K7-bwd {DTYPE_NAME[dtype]} d{name}"
                                    f" {what}: {err:.3e} > {tol:.3e}")
            print(f"  K7 + K7-bwd {DTYPE_NAME[dtype]} {what}, autograd vs "
                  f"the plain chain: within {K7_CHAIN_TOL[dtype]} x max|ref|")
    return errs


# ------------------------------------------------------------ phases 8-13
def texture(b, h, w, gen):
    """Smooth random texture in [0, 1.1), ``[B, 3, H, W]``."""
    base = torch.rand(b, 3, h // 8, w // 8, generator=gen)
    tex = F.interpolate(base, size=(h, w), mode="bilinear",
                        align_corners=False)
    return tex + 0.1 * torch.rand(b, 3, h, w, generator=gen)


def imagenet_normalised(t):
    """``[B, 3, H, W]`` in [0, 1] → ImageNet-normalised ``[B, H, W, 3]``."""
    mean = torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1)
    return ((t - mean) / std).permute(0, 2, 3, 1).contiguous()


def stereo_pair(b, h, w, seed, shift=24):
    """ImageNet-normalised [B, H, W, 3] pair with a constant disparity."""
    tex = texture(b, h, w + 2 * shift, torch.Generator().manual_seed(seed))
    left, right = tex[..., shift:shift + w], tex[..., 2 * shift:]
    return [imagenet_normalised(t) for t in (left, right)]


def mono_image(b, h, w, seed):
    """ImageNet-normalised [B, H, W, 3] image."""
    return imagenet_normalised(texture(b, h, w,
                                       torch.Generator().manual_seed(seed)))


def settle_and_perturb_bn(model, left, right, gen) -> None:
    """Running statistics = one pass's batch statistics (so the random
    stack keeps O(1) activations), then perturbed by 0.1·|N(0, 1)|."""
    bns = [m for m in model.modules()
           if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d))]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None              # cumulative: first batch is exact
    for m in model.modules():
        if isinstance(m, ConvBNAct) or m in bns:
            m.train()                  # conv → batch-stat BN; model stays eval
    with torch.no_grad():
        model(left, right)
    model.eval()
    with torch.no_grad():
        for m in bns:
            m.momentum = 0.1
            for buf in (m.running_mean, m.running_var):
                buf += 0.1 * torch.randn(buf.shape, generator=gen).abs().to(
                    buf.device)


def forward_counted(name, model, *inputs, by_shape=False, **kwargs):
    """One forward ``model(*inputs, **kwargs)`` with the counts set to 0
    just before it; returns the output, the launches by shape of each
    kernel and the K2 and K7 launches by design. Requires each kernel's
    launches to total its count in MIXES[name], every K2 and K7 launch to
    have run the design of the inputs' type (DESIGN) and, with `by_shape`,
    the launches to be exactly MIXES[name] shape by shape."""
    reset_counts()
    with torch.no_grad():
        out = model(*inputs, **kwargs)
    torch.cuda.synchronize()
    shapes = {tag: Counter(fn.shapes) for tag, (fn, *_) in KERNELS.items()}
    want = {tag: Counter(MIXES[name].get(tag, {})) for tag in KERNELS}
    totals = {tag: c.total() for tag, c in shapes.items()}
    require(totals == {tag: c.total() for tag, c in want.items()},
            f"{name} launches per forward {totals} != {want}")
    if by_shape:
        require(shapes == want, f"{name} launches by shape {shapes} differ "
                                f"from {want}")
    designs = {tag: designs_of(tag) for tag in DESIGN_TAGS}
    for tag, got in designs.items():
        kind = ONE_DESIGN.get(tag) or DESIGN[inputs[0].dtype]
        ran = sum(n for key, n in got.items() if key.split()[0] == kind)
        require(ran == totals[tag], f"{name} {DTYPE_NAME[inputs[0].dtype]} "
                                    f"{tag} launches by design {got}, not all "
                                    f"{kind}")
    return out, shapes, designs


def conv3d_fused_plain_f32(x, kernel, scale=None, bias=None, residual=None,
                           relu=False):
    """K2's plain version in float32 arithmetic on x's values, cast back to
    x's type: the yardstick phase 4 holds the kernel to (one rounding of
    the output, as the kernel has)."""
    if isinstance(kernel, PackedConv3dWeight):
        kernel = kernel.kernel()
    return conv3d_fused_reference(
        x.float(), kernel.float(), scale, bias,
        None if residual is None else residual.float(), relu).to(x.dtype)


class plain_kernels:
    """Within it, the port's layers call the plain versions of K2 and K7
    (float32 arithmetic, output in the input's type) in place of their
    wrappers (names imported by ``nn.layers`` and ``nn.vit``)."""

    SWAPS = ((port_nn.layers, "conv3d_fused", conv3d_fused_plain_f32),
             (port_nn.vit, "attention", attention_reference))

    def __enter__(self):
        self.saved = [(mod, attr, getattr(mod, attr))
                      for mod, attr, _ in self.SWAPS]
        for mod, attr, plain in self.SWAPS:
            setattr(mod, attr, plain)

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


def bf16_vs_plain(name, model, size, hook=None) -> dict:
    """The bfloat16 copy of the float32 card model `model` at `size`: the
    card forward as the model runs (K2, K7 on their "mma" designs, launches
    required as MIXES[name]), run twice, against the card forward with K2
    and K7 swapped for their plain versions (no K2, K7 launch required),
    all with cuDNN's deterministic algorithms. Requires finite outputs and
    a mean |d| under PLAIN_SWAP_MEAN_PX; prints the |d| between the two
    kernel runs and each bf16 forward's mean |d| from `model`'s float32
    forward beside it.

    With `hook` the mean |d| of the output is printed, not required, and
    the hooked costs are required within K2's bf16 tolerance · max|ref|
    instead: CFNet's ``classif2.2``, the costs before its first floor (it
    floors its search bounds into integer samples, and in bfloat16 two
    correct roundings move enough samples to put the output's mean |d|
    near 1 px: 0.91 px, and 1.18 px between its bf16 and f32 forwards);
    PSMNet's ``classif3.2``, its last costs before the soft argmax (its
    random-weight costs reach |cost| ~35, where a bf16 ulp is 0.25, and the
    soft argmax over 192 planes turns one-ulp differences at near-ties into
    jumps of many px: two correct roundings of K2 put the output 0.65 px
    apart on the card and 0.95 px apart on the CPU, where no CUDA kernel
    runs, and each bf16 forward ~1.7 px from the f32 one)."""
    m = create_model(name, max_disp=MAX_DISP, dtype=BF16)
    m.load_state_dict(model.state_dict())
    left, right = (t.to(DEV, BF16) for t in stereo_pair(1, *size, seed=1))
    caught = []
    handle = hook and m.get_submodule(hook).register_forward_hook(
        lambda mod, inp, out: caught.append(out.float()))
    torch.backends.cudnn.deterministic = True
    try:
        got, _, _ = forward_counted(name, m, left, right)
        again, _, _ = forward_counted(name, m, left, right)
        reset_counts()
        with plain_kernels(), torch.no_grad():
            want = m(left, right)
        torch.cuda.synchronize()
        require(conv3d_fused.launches == 0 and attention.launches == 0,
                "the plain swap still launched K2 or K7")
        with torch.no_grad():
            f32 = model(left.float(), right.float()).float()
    finally:
        torch.backends.cudnn.deterministic = False
        if handle:
            handle.remove()
    require(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
            f"{name} bf16 non-finite output")
    d = (got.float() - want.float()).abs()
    rerun = (got.float() - again.float()).abs().max().item()
    row = {"shape": [1, *size, 3], "mean_abs": d.mean().item(),
           "median_abs": d.median().item(),
           "q90_abs": d.quantile(0.9).item(), "max_abs": d.max().item(),
           "rerun_max_abs": rerun,
           "kernels_vs_f32_mean_abs": (got.float() - f32).abs().mean().item(),
           "plain_vs_f32_mean_abs": (want.float() - f32).abs().mean().item()}
    print(f"  {name} {size[0]}x{size[1]} bf16, K2/K7 kernels vs their plain "
          f"versions on the card: mean |d| {row['mean_abs']:.3e} px (limit "
          f"{PLAIN_SWAP_MEAN_PX}{', not required' if hook else ''}), median "
          f"{row['median_abs']:.3e}, q90 {row['q90_abs']:.3e}, max "
          f"{row['max_abs']:.3e} px; kernels run twice: max |d| {rerun:.3e}"
          f" px; from the f32 forward: kernels "
          f"{row['kernels_vs_f32_mean_abs']:.3e}, plain "
          f"{row['plain_vs_f32_mean_abs']:.3e} px mean")
    if hook:
        cost, _, cost_plain = caught
        err = (cost - cost_plain).abs().max().item()
        tol = REL_TOL["K2"][BF16] * cost_plain.abs().max().item()
        row[f"{hook}_max_abs"] = err
        print(f"  {name} {hook} bf16, kernels vs plain: max|d| {err:.3e} "
              f"(tol {tol:.3e})")
        require(err <= tol, f"{name} bf16 {hook} differs from its plain "
                            f"kernels")
    else:
        require(row["mean_abs"] < PLAIN_SWAP_MEAN_PX,
                f"{name} bf16 forward differs from its plain kernels")
    del m
    return row


def card_vs_cpu(name, hook=None, size=(CHECK_H, CHECK_W), tf32=False):
    """The model on the card and on the CPU at `size`, float32, from the
    same settled weights. Returns (card model, |card - CPU| of the output,
    CPU and card outputs of the module `hook` names, the CPU model). With
    `tf32`, both global TF32 flags are True around the card's forward: the
    float32 forward turns them off for its length (`utils.precision`).

    The card side runs with cuDNN's deterministic algorithms and its own
    seed: CFNet's floors turn run-to-run rounding (atomics in cuDNN's
    transposed convs) into different samples, and so into a comparison that
    moved from run to run; this way it is the same in every run."""
    model = create_model(name, max_disp=MAX_DISP,
                         generator=torch.Generator().manual_seed(0))
    l_small, r_small = stereo_pair(1, *size, seed=1)
    torch.backends.cudnn.deterministic = True
    try:
        settle_and_perturb_bn(model, l_small.to(DEV), r_small.to(DEV),
                              torch.Generator().manual_seed(1234))
        cpu = create_model(name, max_disp=MAX_DISP, device="cpu")
        cpu.load_state_dict(model.state_dict())
        caught = []
        hooks = [m.get_submodule(hook).register_forward_hook(
            lambda mod, inp, out: caught.append(out.float().cpu()))
            for m in (cpu, model) if hook]
        t0 = time.perf_counter()
        with torch.no_grad():
            want = cpu(l_small, r_small)
        print(f"  {name} CPU reference forward at {size[0]}x{size[1]}: "
              f"{time.perf_counter() - t0:.1f} s")
        torch.backends.cudnn.allow_tf32 = tf32
        torch.backends.cuda.matmul.allow_tf32 = tf32
        got, _, _ = forward_counted(name, model, l_small.to(DEV),
                                    r_small.to(DEV))
        for h in hooks:
            h.remove()
    finally:
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    d = (got.cpu() - want).abs()
    flags = " (global TF32 flags True)" if tf32 else ""
    print(f"  {name} {size[0]}x{size[1]} f32{flags}, card vs CPU: mean |d| "
          f"{d.mean().item():.3e} px, median {d.median().item():.3e}, "
          f"q90 {d.quantile(0.9).item():.3e}, max {d.max().item():.3e} px "
          f"(range {want.min().item():.2f}..{want.max().item():.2f})")
    return model, d, caught, cpu


def full_size_runs(name, model):
    """The 480x640 forward in float32 and bfloat16, two pairs each, with
    the launches by shape required to be MIXES[name]. Returns, by dtype,
    (model, (left, right), launches by shape, last output, K2/K7 launches
    by design)."""
    runs = {}
    for dtype in (F32, BF16):
        m = model if dtype == F32 else create_model(
            name, max_disp=MAX_DISP, dtype=dtype)
        if dtype != F32:
            m.load_state_dict(model.state_dict())
        for seed in (2, 3):
            left, right = (t.to(DEV, dtype) for t in stereo_pair(1, H, W,
                                                                 seed))
            out, shapes, designs = forward_counted(name, m, left, right,
                                                   by_shape=True)
            require(out.shape == (1, H, W), f"output shape {out.shape}")
            require(bool(torch.isfinite(out).all()), "non-finite output")
            lo, hi = out.min().item(), out.max().item()
            require(0 <= lo and hi < MAX_DISP, f"output range {lo}..{hi}")
            print(f"  {name} {H}x{W} {DTYPE_NAME[dtype]} pair {seed}: "
                  f"disparity {lo:.2f}..{hi:.2f}, mean {out.mean().item():.2f}"
                  ", launches " + " ".join(
                      f"{t}={c.total()}" for t, c in shapes.items()))
        runs[dtype] = (m, (left, right), shapes, out.float(), designs)
    return runs


def check_gwcnet(name="GwcNet_G"):
    """GwcNet_G's card-vs-CPU check runs with both global TF32 flags True:
    its float32 forward holds the float32 gates all the same."""
    tf32 = name == "GwcNet_G"
    model, d, _, _ = card_vs_cpu(name, tf32=tf32)
    require(d.mean().item() < 5e-3 and d.max().item() < 0.1,
            f"{name} card output differs from the CPU port"
            f"{' with the global TF32 flags True' if tf32 else ''}")
    check = {"global_tf32_flags": tf32, "mean_abs": d.mean().item(),
             "max_abs": d.max().item(),
             "bf16_vs_plain": bf16_vs_plain(name, model, (CHECK_H, CHECK_W))}
    return full_size_runs(name, model), check


def check_acvnet():
    """ACVNet card vs CPU at ACV_CHECK (the bottleneck attention pads H 18
    to 20), full model and, on the same weights, ``attn_weights_only``;
    then the 480x640 runs."""
    size = (ACV_CHECK_H, ACV_CHECK_W)
    model, d, _, cpu = card_vs_cpu("ACVNet", size=size)
    check = {"shape": [1, *size, 3], "full": {
        "mean_abs": d.mean().item(), "max_abs": d.max().item()}}
    require(d.mean().item() < 5e-3 and d.max().item() < 0.1,
            "ACVNet card output differs from the CPU port")
    l_small, r_small = stereo_pair(1, *size, seed=1)
    for m in (cpu, model):
        m.attn_weights_only = True
    try:
        with torch.no_grad():
            want = cpu(l_small, r_small)
            got = model(l_small.to(DEV), r_small.to(DEV)).cpu()
    finally:
        model.attn_weights_only = False
    d = (got - want).abs()
    check["attn_weights_only"] = {"mean_abs": d.mean().item(),
                                  "max_abs": d.max().item()}
    print(f"  ACVNet {size[0]}x{size[1]} f32 attn_weights_only, card vs CPU:"
          f" mean |d| {d.mean().item():.3e} px, max {d.max().item():.3e} px "
          f"(range {want.min().item():.2f}..{want.max().item():.2f})")
    require(d.mean().item() < 5e-3 and d.max().item() < 0.1,
            "ACVNet attn_weights_only card output differs from the CPU port")
    del cpu
    check["bf16_vs_plain"] = bf16_vs_plain("ACVNet", model, size)
    return full_size_runs("ACVNet", model), check


def check_cfnet():
    """CFNet floors its search bounds into integer samples, so a ~1e-6
    difference can move one sample at a near-tie pixel: the output is held
    with quantile bounds, the classif2 costs (before the first floor)
    tightly."""
    model, d, (want_cost, got_cost), _ = card_vs_cpu("CFNet",
                                                      hook="classif2.2")
    err = (got_cost - want_cost).abs().max().item()
    ref = want_cost.abs().max().item()
    print(f"  CFNet classif2 costs, card vs CPU: max|d| {err:.3e} "
          f"(tol {1e-3 * ref:.3e})")
    require(err <= 1e-3 * ref, "CFNet classif2 costs differ from the CPU")
    require(d.median().item() < 5e-3 and d.quantile(0.9).item() < 0.1
            and d.mean().item() < 0.05,
            "CFNet card output differs from the CPU port")
    check = {"bf16_vs_plain": bf16_vs_plain("CFNet", model,
                                            (CHECK_H, CHECK_W),
                                            hook="classif2.2")}
    runs = full_size_runs("CFNet", model)
    diff = (runs[BF16][3] - runs[F32][3]).abs()
    print(f"  CFNet {H}x{W} pair 3, bfloat16 vs float32: mean |d| "
          f"{diff.mean().item():.3f} px, median {diff.median().item():.3f} px")
    return runs, check


# PSMNet's first 3D layer at 480x640: [1, 120, 160, 32] features of each
# view to a [1, 48, 120, 160, 32] cost
PS_FEATURE = (1, H // 4, W // 4, 32)


def launches_of(fn, tries: int = 3) -> int:
    """Device kernels one call of `fn` launches (a ``torch.profiler``
    trace). A trace that saw no device event is taken again, up to `tries`
    in all: the profiler loses a short trace's events now and then (a
    bf16 K6 + K2 call, 2 launches, read 0 once on the H100)."""
    for k in range(tries):
        n = round(sum(n for _, n in trace(fn, 1)[0].values()))
        if n:
            break
    if k:
        print(f"  launches_of: traced {k + 1} times, {k} saw no device event")
    return n


def time_concat_layer(model, dtype, gen) -> dict:
    """PSMNet's ``dres0.0`` (`ConcatVolumeConvBNAct`: two 2D convs on cuDNN,
    then strided copies and adds) on random features of PS_FEATURE,
    against what it replaces: the masked concat volume (K6, C = 32, D 48)
    then K2 at Ci 64 -> Co 32 with the same folded BatchNorm and ReLU.
    Device ms of each call and of K6 and K2 apart, device launches a call,
    and max|layer - (K6 + K2)| required within K2's tolerance."""
    layer = model.dres0[0]
    d = model.max_disp // 4
    left, right = (randn(PS_FEATURE, dtype, gen) for _ in range(2))
    kp = pack_conv3d_weight(layer[0].weight.permute(2, 3, 4, 1, 0).to(dtype))
    scale, bias = layer.folded_affine()

    def replaced():
        return conv3d_fused(build_concat_volume(left, right, d), kp, scale,
                            bias, None, True)
    with torch.no_grad():
        got, want = layer(left, right), replaced()
        vol = build_concat_volume(left, right, d)
        row = {
            "ms": device_ms(lambda: layer(left, right), 20),
            "launches": launches_of(lambda: layer(left, right)),
            "replaced_ms": device_ms(replaced, 10),
            "replaced_launches": launches_of(replaced),
            "k6_ms": device_ms(lambda: build_concat_volume(left, right, d),
                               20),
            "k2_ms": device_ms(lambda: conv3d_fused(vol, kp, scale, bias,
                                                    None, True), 10)}
    err = (got.float() - want.float()).abs().max().item()
    tol = REL_TOL["K2"][dtype] * want.float().abs().max().item()
    row.update(max_abs_err=err, tolerance=tol)
    print(f"  PSMNet dres0.0 (ConcatVolumeConvBNAct) {DTYPE_NAME[dtype]} at "
          f"{PS_FEATURE} x2, D={d}: {row['ms']:.4f} ms, {row['launches']} "
          f"launches; K6 + K2 at Ci 64: {row['replaced_ms']:.4f} ms (K6 "
          f"{row['k6_ms']:.4f}, K2 {row['k2_ms']:.4f}), "
          f"{row['replaced_launches']} launches; max|d| {err:.3e} (tol "
          f"{tol:.3e})")
    require(row["launches"] > 0 and row["replaced_launches"] > 0,
            "torch.profiler saw no launch of the concat layer")
    require(err <= tol, f"PSMNet {DTYPE_NAME[dtype]} concat layer differs "
                        f"from K6 + K2")
    return row


def check_psmnet():
    """PSMNet card vs CPU at 256x512; bf16 against its plain K2 swap, held
    by its ``classif3.2`` costs (`bf16_vs_plain`); the 480x640 runs; then
    its first 3D layer against K6 + K2."""
    model, d, _, _ = card_vs_cpu("PSMNet")
    require(d.mean().item() < 5e-3 and d.max().item() < 0.1,
            "PSMNet card output differs from the CPU port")
    check = {"mean_abs": d.mean().item(), "max_abs": d.max().item(),
             "bf16_vs_plain": bf16_vs_plain("PSMNet", model,
                                            (CHECK_H, CHECK_W),
                                            hook="classif3.2")}
    runs = full_size_runs("PSMNet", model)
    gen = torch.Generator().manual_seed(4321)
    check["concat_layer"] = {DTYPE_NAME[dtype]: time_concat_layer(
        runs[dtype][0], dtype, gen) for dtype in (F32, BF16)}
    return runs, check


def dav2_gates(got, want, what) -> dict:
    """The JAX package's cross-framework bounds for DepthAnythingV2
    (its ``tests/test_torch_import.py``): mean |d| < 5e-3 · scale and max |d|
    < 0.05 · scale, scale = mean |ref|."""
    d = (got.float().cpu() - want).abs()
    scale = max(want.abs().mean().item(), 1e-3)
    row = {"mean_abs": d.mean().item(), "max_abs": d.max().item(),
           "scale": scale}
    print(f"  DepthAnythingV2 {DAV2_CHECK_H}x{DAV2_CHECK_W} f32 {what}, card "
          f"vs CPU: mean |d| {row['mean_abs']:.3e} (tol {5e-3 * scale:.3e}), "
          f"max |d| {row['max_abs']:.3e} (tol {0.05 * scale:.3e})")
    require(row["mean_abs"] < 5e-3 * scale and row["max_abs"] < 0.05 * scale,
            f"DepthAnythingV2 card {what} differs from the CPU port")
    return row


def check_dav2():
    """DepthAnythingV2 (seeded random weights): the card against the port's
    CPU path at DAV2_CHECK (float32, TF32 off) on the depth and on the
    pre-ReLU ``out``; then the 518x518 forward in float32 and bfloat16 with
    the launches by shape required to be DAV2_K7_MIX. Returns the runs as
    `full_size_runs` does, and the check's numbers.

    The random head's last ReLU can zero most of the map: where fewer than
    a fifth of the CPU depth's pixels are positive, the check says so and
    lifts ``output_conv2.2``'s bias on both models."""
    name = "DepthAnythingV2"
    model = create_model(name, encoder=DAV2_ENCODER,
                         generator=torch.Generator().manual_seed(0))
    cpu = create_model(name, encoder=DAV2_ENCODER, device="cpu")
    cpu.load_state_dict(model.state_dict())
    x = mono_image(1, DAV2_CHECK_H, DAV2_CHECK_W, seed=1)
    t0 = time.perf_counter()
    for _ in range(20):
        with torch.no_grad():
            want, want_f = cpu(x, return_features=True)
        if (want > 0).float().mean().item() >= 0.2:
            break
        print("  DepthAnythingV2: degenerate depth (under a fifth of the "
              "pixels > 0); output_conv2.2 bias += 0.1")
        with torch.no_grad():
            for m in (cpu, model):
                m.depth_head.scratch.output_conv2[2].bias += 0.1
    print(f"  DepthAnythingV2 CPU reference at {DAV2_CHECK_H}x{DAV2_CHECK_W}:"
          f" {time.perf_counter() - t0:.1f} s, depth > 0 at "
          f"{100 * (want > 0).float().mean().item():.1f}% of pixels")
    (got, got_f), _, _ = forward_counted(name, model, x.to(DEV),
                                         return_features=True)
    check = {"shape": [1, DAV2_CHECK_H, DAV2_CHECK_W, 3],
             "depth": dav2_gates(got, want, "depth"),
             "out": dav2_gates(got_f["out"], want_f["out"], "out")}
    del cpu
    runs = {}
    for dtype in (F32, BF16):
        if dtype == F32:
            m = model
        else:
            m = create_model(name, encoder=DAV2_ENCODER, dtype=dtype)
            m.load_state_dict(model.state_dict())
        img = mono_image(1, DAV2_H, DAV2_W, seed=2).to(DEV, dtype)
        out, shapes, designs = forward_counted(name, m, img, by_shape=True)
        require(out.shape == (1, DAV2_H, DAV2_W), f"output shape {out.shape}")
        require(bool(torch.isfinite(out).all()), "non-finite output")
        lo, hi = out.min().item(), out.max().item()
        require(lo >= 0 and hi > 0, f"output range {lo}..{hi}")
        print(f"  {name} {DAV2_H}x{DAV2_W} {DTYPE_NAME[dtype]}: depth "
              f"{lo:.3f}..{hi:.3f}, > 0 at "
              f"{100 * (out > 0).float().mean().item():.1f}%, launches "
              + " ".join(f"{t}={c.total()}" for t, c in shapes.items()))
        runs[dtype] = (m, (img,), shapes, out.float(), designs)
    diff = (runs[BF16][3] - runs[F32][3]).abs()
    print(f"  {name} {DAV2_H}x{DAV2_W}, bfloat16 vs float32: mean |d| "
          f"{diff.mean().item():.3e}, max {diff.max().item():.3e} (f32 mean "
          f"{runs[F32][3].mean().item():.3e})")
    return runs, check


# --------------------------------------------------------------- phase 14
def train_config(name, **kw) -> TrainConfig:
    """The port's entry point's config for `name`: the multi-head loss on
    the model's heads (CFNet: the sequence loss, TRAIN_LOSS), max_disp
    192."""
    return TrainConfig(max_disp=MAX_DISP,
                       loss=TRAIN_LOSS.get(name, "multihead"),
                       loss_weights=LOSS_WEIGHTS[name], **kw)


def synthetic_loader(h, w, b, batches, seed, workers=4) -> DataLoader:
    """The port's `DataLoader` over `SyntheticStereoDataset` training crops
    of h x w (the dataset's images 64 px larger each way, disparities up to
    96), `batches` batches of `b`."""
    return DataLoader(SyntheticStereoDataset(
        num_samples=b * batches, height=h + 64, width=w + 64, max_disp=96,
        training=True, crop_size=(h, w), seed=seed), batch_size=b,
        shuffle=True, seed=seed, drop_last=True, num_workers=workers)


class GradRecorder:
    """An optimizer stand-in that keeps the gradients a step gives it."""
    count = 0

    def step(self, grads):
        self.dtypes = [g.dtype for g in grads]
        self.grads = [g.detach().float().cpu() for g in grads]


def bn_buffers(model) -> dict:
    """A copy of the model's running statistics, float32 on the CPU."""
    return {k: v.detach().float().cpu().clone()
            for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def check_batch() -> dict:
    """The card-vs-CPU checks' batch: TRAIN_CHECK_B samples of
    TRAIN_CHECK_H x TRAIN_CHECK_W from seed 5."""
    return next(iter(synthetic_loader(TRAIN_CHECK_H, TRAIN_CHECK_W,
                                      TRAIN_CHECK_B, 1, seed=5, workers=0)))


# The CPU's float32 step of each model on `check_batch`, by name: the
# float32 and the bfloat16 comparisons both hold the card to it, from the
# same weights (seed 0), batch and `train_config`, so it is computed once
CPU_F32_STEPS: dict = {}


def cpu_f32_step(name, model) -> tuple[dict, list]:
    """`step_readings` of the CPU's float32 step of `name` (weights those
    of the card's `model`, freshly built from seed 0) on `check_batch`,
    and for CFNet the samples of both cascade stages; computed at the first
    call and kept."""
    if name not in CPU_F32_STEPS:
        cpu = create_model(name, max_disp=MAX_DISP, device="cpu")
        cpu.load_state_dict(model.state_dict())
        caught = []
        hooks = [cpu.get_submodule(stage).register_forward_pre_hook(
            lambda mod, args: caught.append(args[2].detach().cpu()))
            for stage in ("volume_s3", "volume_s2") if name == "CFNet"]
        reset_counts()
        readings = step_readings(cpu, train_config(name), check_batch(), F32,
                                 "cpu")
        for hk in hooks:
            hk.remove()
        CPU_F32_STEPS[name] = (readings, caught)
    return CPU_F32_STEPS[name]


def compare_train_step(name) -> dict:
    """One train step on the card and on the port's CPU paths at 64x128, B
    2, from the same weights and batch: the loss, every gradient and the
    updated running statistics, each as far apart as it reads, the card's
    step launching TRAIN_CHECK_MIXES[name] (cuDNN's deterministic
    algorithms on the card: CFNet's floors turn run-to-run rounding into
    other samples). For CFNet, also the samples of both cascade stages
    that differ between the card and the CPU."""
    model = create_model(name, max_disp=MAX_DISP,
                         generator=torch.Generator().manual_seed(0))
    batch = check_batch()
    cpu32, cpu_samples = cpu_f32_step(name, model)
    got = {"cpu": (cpu32["loss"], cpu32["grads"], cpu32["stats"])}
    samples = {"cpu": cpu_samples}
    torch.backends.cudnn.deterministic = True
    try:
        rec = GradRecorder()
        caught = samples[DEV] = []
        hooks = [model.get_submodule(stage).register_forward_pre_hook(
            lambda mod, args: caught.append(args[2].detach().cpu()))
            for stage in ("volume_s3", "volume_s2") if name == "CFNet"]
        reset_counts()
        _, loss = make_train_step(model, train_config(name))(
            TrainState(model, rec), to_device(batch, DEV))
        for hk in hooks:
            hk.remove()
        got[DEV] = (loss.item(), rec.grads, bn_buffers(model))
    finally:
        torch.backends.cudnn.deterministic = False
    (l_cpu, _, _), (l_gpu, _, _) = got["cpu"], got[DEV]
    want = TRAIN_CHECK_MIXES[name]
    for tag, (fn, *_) in KERNELS.items():
        require(Counter(fn.shapes) == Counter(want.get(tag, {})),
                f"{name} card train step {tag} launches {dict(fn.shapes)}, "
                f"not {want.get(tag, {})}")
    apart = train_distances(got["cpu"], got[DEV])
    loss_rel, grad_l2, leaf, stats = (apart[k] for k in (
        "loss_rel", "grad_rel_l2", "grad_worst_leaf", "running_stats_rel"))
    moved = [int((a != b).sum()) for a, b in zip(samples["cpu"],
                                                  samples[DEV])]
    l2_tol, leaf_tol = TRAIN_GRAD.get(name, TRAIN_GRAD["default"])
    print(f"  {name} train step {TRAIN_CHECK_H}x{TRAIN_CHECK_W} B "
          f"{TRAIN_CHECK_B} f32, card vs CPU: loss {l_gpu:.6f} / {l_cpu:.6f}"
          f" (rel {loss_rel:.3e}, tol {TRAIN_REL}), gradients' relative L2 "
          f"{grad_l2:.3e} (tol {l2_tol}), worst leaf {leaf:.3e} (tol "
          f"{leaf_tol}), running statistics {stats:.3e} (tol {TRAIN_REL})"
          + (f"; samples that differ (s3, s2): {moved} of "
             f"{[a.numel() for a in samples['cpu']]}" if moved else ""))
    row = {"shape": [TRAIN_CHECK_B, TRAIN_CHECK_H, TRAIN_CHECK_W, 3],
           "loss_cpu": l_cpu, "loss_card": l_gpu, "loss_rel": loss_rel,
           "grad_rel_l2": grad_l2, "grad_worst_leaf": leaf,
           "running_stats_rel": stats, "model": name}
    if moved:
        row["samples_moved"] = moved
    return row


def train_distances(want, got) -> dict:
    """How far a train step's readings ``(loss, gradients, running
    statistics)`` `got` are from `want`'s: the loss relative, the
    gradients' global relative L2 and worst leaf (max|d| / its max|ref|),
    the running statistics' worst channel (a mean in units of its
    channel's spread, a variance relative)."""
    (l_ref, g_ref, s_ref), (loss, grads, stats) = want, got
    num = sum(((a - b) ** 2).sum().item() for a, b in zip(grads, g_ref))
    den = sum((b ** 2).sum().item() for b in g_ref)
    worst = 0.0
    for k, v in s_ref.items():
        if k.endswith("running_mean"):
            var = s_ref[k.replace("running_mean", "running_var")]
            worst = max(worst, ((stats[k] - v).abs() / var.sqrt()).max()
                        .item())
        else:
            worst = max(worst, ((stats[k] - v).abs() / v).max().item())
    return {"loss_rel": abs(loss - l_ref) / abs(l_ref),
            "grad_rel_l2": (num / den) ** 0.5,
            "grad_worst_leaf": max(
                (a - b).abs().max().item() / b.abs().max().item()
                for a, b in zip(grads, g_ref) if b.abs().max() > 0),
            "running_stats_rel": worst}


def train_step_within_limits(row) -> bool:
    """Whether a `compare_train_step` reading is within TRAIN_REL and its
    model's TRAIN_GRAD limits."""
    l2_tol, leaf_tol = TRAIN_GRAD.get(row["model"], TRAIN_GRAD["default"])
    return (row["loss_rel"] <= TRAIN_REL
            and row["running_stats_rel"] <= TRAIN_REL
            and row["grad_rel_l2"] <= l2_tol
            and row["grad_worst_leaf"] <= leaf_tol)


def train_card_vs_cpu(name) -> dict:
    """`compare_train_step`, required within the limits."""
    row = compare_train_step(name)
    require(train_step_within_limits(row),
            f"{name} card train step differs from the CPU port")
    return row


def train_full_size(name, dtype=F32) -> tuple[dict, dict]:
    """make_train_step in `dtype` at 256x512, B 4, on batches of the port's
    DataLoader (moved from pinned memory): TRAIN_WARMUP warm steps, then
    TRAIN_STEPS[dtype] timed ones (host clock around the step and a
    synchronize), each step's launches by shape required to be
    TRAIN_MIXES[name], each kernel on its design and on `dtype` data; the
    peak memory of the timed steps."""
    model = create_model(name, max_disp=MAX_DISP,
                         generator=torch.Generator().manual_seed(0))
    steps = TRAIN_STEPS[dtype]
    loader = synthetic_loader(TRAIN_H, TRAIN_W, TRAIN_B,
                              TRAIN_WARMUP + steps, seed=6)
    config = train_config(name)
    state = init_train_state(model, config, len(loader), dtype)
    step = make_train_step(model, config, dtype)
    want = {tag: Counter(TRAIN_MIXES[name].get(tag, {})) for tag in KERNELS}
    times, losses = [], []
    for i, batch in enumerate(loader):
        batch = to_device(batch, DEV)
        torch.cuda.synchronize()
        if i == TRAIN_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with launch_dtypes() as seen:
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        _, problems = train_launches(
            f"{name} {DTYPE_NAME[dtype]} train step {i}", TRAIN_MIXES[name],
            dtype, seen.seen)
        require(not problems, "; ".join(problems))
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    designs = {tag: designs_of(tag) for tag in TRAIN_MIXES[name]}
    require(all(np.isfinite(losses)), f"{name} train losses {losses}")
    # device time by kernel family of one more step (forward, backward and
    # optimizer), from a torch.profiler trace
    families: dict = defaultdict(float)
    t0 = time.perf_counter()
    kernels, _ = trace(lambda: step(state, batch), 1, grad=True, host=False)
    traced_s = time.perf_counter() - t0
    for key, (ms, _) in kernels.items():
        families[kernel_family(key)] += ms
    timed = sorted(times[TRAIN_WARMUP:])
    row = {"shape": [TRAIN_B, TRAIN_H, TRAIN_W, 3], "max_disp": MAX_DISP,
           "dtype": DTYPE_NAME[dtype], "warmup": TRAIN_WARMUP,
           "steps": steps,
           "step_ms_median": timed[len(timed) // 2], "step_ms": times,
           "peak_mib": peak / 2**20, "losses": losses,
           "launches_per_step": {tag: {str(k): n for k, n in c.items()}
                                 for tag, c in want.items() if c},
           "designs_last_step": designs,
           "traced_step_families_ms": dict(families) or None,
           "traced_step_launches": sum(n for _, n in kernels.values()),
           "traced_s": traced_s}
    print(f"  {name} train {TRAIN_H}x{TRAIN_W} B {TRAIN_B} "
          f"{DTYPE_NAME[dtype]}: median step "
          f"{row['step_ms_median']:.1f} ms over {steps} (all "
          + ", ".join(f"{t:.1f}" for t in times) + f" ms), peak "
          f"{row['peak_mib']:.1f} MiB, losses "
          + ", ".join(f"{v:.3f}" for v in losses) + "; launches a step: "
          + (", ".join(f"{tag} {dict(c)}" for tag, c in want.items() if c)
             or "none"))
    if families:
        busy = sum(families.values())
        print(f"    traced step: device busy {busy:.1f} ms in "
              f"{row['traced_step_launches']:g} launches ({traced_s:.1f} s "
              f"to trace)")
        for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
            print(f"    family {fam:40s} {ms:9.3f} ms")
        for key, (ms, n) in sorted(kernels.items(),
                                   key=lambda kv: -kv[1][0])[:8]:
            print(f"    kernel {ms:9.3f} ms x{n:g}  {key[:100]}")
    else:
        print("    torch.profiler saw no device time: the step's kernel "
              "families not measured")
    del state, step, model
    return row, want


def train_overfit(name, dtype=F32) -> dict:
    """OVERFIT_STEPS steps in `dtype` on one fixed 256x512 batch of
    OVERFIT_B with the configuration of the JAX package's overfit test (lr
    1e-3, the multi-head loss (CFNet: the sequence loss), clip 1.0, 30
    scheduled steps): every loss finite and the last below 0.9 x the
    first."""
    model = create_model(name, max_disp=MAX_DISP,
                         generator=torch.Generator().manual_seed(0))
    config = train_config(name, lr=1e-3, clip_grad=1.0)
    state = init_train_state(model, config, 30, dtype)
    step = make_train_step(model, config, dtype)
    batch = to_device(next(iter(synthetic_loader(
        TRAIN_H, TRAIN_W, OVERFIT_B, 1, seed=7, workers=0))), DEV)
    losses = []
    for _ in range(OVERFIT_STEPS):
        state, loss = step(state, batch)
        losses.append(loss.item())
    print(f"  {name} overfit {TRAIN_H}x{TRAIN_W} B {OVERFIT_B} "
          f"{DTYPE_NAME[dtype]}: losses "
          + ", ".join(f"{v:.3f}" for v in losses))
    require(all(np.isfinite(losses)) and losses[-1] < 0.9 * losses[0],
            f"{name} {DTYPE_NAME[dtype]} overfit losses {losses}")
    del state, step, model
    return {"shape": [OVERFIT_B, TRAIN_H, TRAIN_W, 3], "losses": losses}


def check_training(name) -> tuple[dict, dict]:
    """Phase 14 for `name`: card vs CPU, the full-size steps and the
    overfit in float32, then in bfloat16 (card vs CPU also in ACVNet's
    staged modes). Returns the train line's row and the launches a
    full-size step made."""
    t0 = time.perf_counter()
    row = {"card_vs_cpu": train_card_vs_cpu(name)}
    row["full_size"], mix = train_full_size(name)
    torch.cuda.empty_cache()
    row["overfit"] = train_overfit(name)
    torch.cuda.empty_cache()
    bf16 = row["bf16"] = {"card_vs_cpu": [train_card_vs_cpu_bf16(name)]}
    if name == "ACVNet":
        bf16["card_vs_cpu"] += [train_card_vs_cpu_bf16(name, mode)
                                for mode in BF16_MODES]
    bf16["full_size"], _ = train_full_size(name, BF16)
    torch.cuda.empty_cache()
    bf16["overfit"] = train_overfit(name, BF16)
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t0
    print(f"  {name} training phase: {row['seconds']:.1f} s")
    return row, mix


# the plain version of each backward kernel, on its launcher's arguments
BACKWARD_PLAIN = {
    "K1-bwd": gwc_volume_backward_reference,
    "K6-bwd": concat_volume_backward_reference,
    "K4-bwd": lambda grad, samples, right, max_shift:
        gather_right_by_samples_backward_reference(grad, samples, max_shift),
    "K5-bwd": gwc_volume_from_samples_backward_reference}


class launch_dtypes:
    """Within it, the data type each volume kernel's launcher was given,
    counted by tag (`LAUNCHERS`): what proves a step ran a kernel's
    bfloat16 design (its plan is taken from the type). With `check`, each
    backward launch is also held against its plain version on the same
    arguments (`BACKWARD_PLAIN`; uncounted): ``errors[tag]`` is the worst
    max|err| / (REL_TOL · max|ref|) of its launches."""

    def __init__(self, check: bool = False):
        self.check = check

    def __enter__(self):
        self.seen: dict = defaultdict(Counter)
        self.errors: dict = {}
        self.saved = {}
        for tag, attr in LAUNCHERS.items():
            launch = self.saved[attr] = getattr(port_volume, attr)

            def counted(*args, launch=launch, tag=tag):
                dtype = args[0].dtype
                self.seen[tag][DTYPE_NAME.get(dtype, str(dtype))] += 1
                out = launch(*args)
                if self.check and tag in BACKWARD_PLAIN:
                    want = BACKWARD_PLAIN[tag](*args)
                    pairs = zip(out, want) if isinstance(out, tuple) else [
                        (out, want)]
                    for got, ref in pairs:
                        err = (got.float() - ref.float()).abs().max().item()
                        tol = REL_TOL[tag][dtype] * ref.float().abs().max(
                        ).item()
                        self.errors[tag] = max(self.errors.get(tag, 0.0),
                                               err / tol if tol else (
                                                   0.0 if err == 0 else
                                                   float("inf")))
                return out
            setattr(port_volume, attr, counted)
        return self

    def __exit__(self, *exc):
        for attr, launch in self.saved.items():
            setattr(port_volume, attr, launch)


def train_launches(what, want, dtype, seen) -> tuple[dict, list]:
    """The kernels' launches since the counts were reset against `want`:
    by shape, each on its one design (`ONE_DESIGN`) and on `dtype` data
    (`seen`, from `launch_dtypes`). Returns the designs by tag and what
    differs, one message a kernel."""
    designs, problems = {}, []
    for tag, (fn, *_) in KERNELS.items():
        if Counter(fn.shapes) != Counter(want.get(tag, {})):
            problems.append(f"{what} {tag} launches {dict(fn.shapes)}, not "
                            f"{want.get(tag, {})}")
        if not want.get(tag):
            continue
        ran = designs[tag] = designs_of(tag)
        if not ran or any(k.split()[0] != ONE_DESIGN[tag] for k in ran):
            problems.append(f"{what} {tag} ran {ran}, not "
                            f"{ONE_DESIGN[tag]}")
        if dict(seen.get(tag, {})) != {DTYPE_NAME[dtype]:
                                       sum(want[tag].values())}:
            problems.append(f"{what} {tag} ran on {dict(seen.get(tag, {}))}"
                            f", not {DTYPE_NAME[dtype]}")
    return designs, problems


def step_readings(model, config, batch, dtype, dev) -> dict:
    """One train step of `model` in `dtype` on `batch` (on `dev`), the
    optimizer a `GradRecorder`: the loss and its type, the heads, the
    gradients handed to the optimizer, the running statistics after it,
    and the (input, weight, output) dtypes of each call of a conv, linear
    and BatchNorm module."""
    rec, heads, audit = GradRecorder(), [], defaultdict(list)
    hooks = [model.register_forward_hook(lambda mod, inp, out: heads.extend(
        o.detach().float().cpu() for o in out))]
    for key, m in model.named_modules():
        if isinstance(m, AUDITED):
            hooks.append(m.register_forward_hook(
                lambda mod, inp, out, key=key: audit[key].append(tuple(
                    DTYPE_NAME.get(t.dtype, str(t.dtype))
                    for t in (inp[0], mod.weight, out)))))
    _, loss = make_train_step(model, config, dtype)(TrainState(model, rec),
                                                    to_device(batch, dev))
    for hk in hooks:
        hk.remove()
    return {"loss": loss.item(), "loss_dtype": loss.dtype, "heads": heads,
            "grads": rec.grads, "grad_dtypes": set(rec.dtypes),
            "stats": bn_buffers(model), "audit": dict(audit)}


def _rel(a, b) -> float:
    return ((a.double() - b.double()).norm() / b.double().norm()).item()


def _stats_distance(got, want) -> dict:
    """RMS over every channel of |d mean| / sqrt(var) and |d var| / var."""
    sq = {"mean": [], "var": []}
    for k, v in want.items():
        if k.endswith("running_mean"):
            var = want[k.replace("running_mean", "running_var")].double()
            sq["mean"].append((got[k].double() - v.double()) ** 2 / var)
        else:
            sq["var"].append(((got[k].double() - v.double()) / v.double())
                             ** 2)
    return {k: torch.cat(v).mean().sqrt().item() for k, v in sq.items()}


def loss_terms(heads, batch, config) -> torch.Tensor:
    """The loss pixel by pixel: ``Σ_i w_i · smooth_l1(head_i − gt)`` over
    the valid pixels (the multi-head weights, or the sequence loss's
    ``γ'^(n−1−i)``), whose mean is the step's loss."""
    gt = torch.from_numpy(np.asarray(batch["gt_disp"], np.float32))
    mask = port_metrics.valid_mask(gt, config.max_disp)
    n = len(heads)
    weights = (config.loss_weights if config.loss == "multihead" else
               [(config.loss_gamma ** (15.0 / (n - 1)) if n > 1 else 1.0)
                ** (n - 1 - i) for i in range(n)])
    total = sum(w * port_losses.smooth_l1(h, gt)
                for w, h in zip(weights, heads))
    return total[mask]


def _groups(names, grads) -> dict:
    """The gradients by group (the first part of a parameter's name, in
    `names`), flattened."""
    out = defaultdict(list)
    for key, g in zip(names, grads):
        out[key.split(".")[0]].append(g.flatten())
    return {k: torch.cat(v) for k, v in out.items()}


def compare_train_step_bf16(name, mode=None) -> dict:
    """One bfloat16 train step on the card against the same step on the
    port's CPU paths at 64x128, B 2 (cuDNN's deterministic algorithms),
    from the same float32 masters and batch, beside the CPU's float32 step
    and its float32 step on the left image perturbed by PERTURBATION: the
    loss, each head and the running statistics within BF16_FACTOR x the
    CPU's bfloat16-vs-float32 distance, likewise the gradient of each group
    whose float32 gradient moves less than STABLE under the perturbation;
    the module dtypes of the card's step equal to the CPU's, every
    gradient float32, the loss and heads float32; the card's launches by
    shape the bfloat16 check mix, each kernel on bfloat16 data. For CFNet,
    also the samples of both cascade stages that differ between the card
    and the CPU."""
    kw = {mode: True} if mode else {}
    config = (train_config(name) if mode is None else TrainConfig(
        max_disp=MAX_DISP, loss="multihead", loss_weights=BF16_MODES[mode]))
    model = create_model(name, max_disp=MAX_DISP,
                         generator=torch.Generator().manual_seed(0), **kw)
    cpu = create_model(name, max_disp=MAX_DISP, device="cpu", **kw)
    cpu.load_state_dict(model.state_dict())
    init = {k: v.clone() for k, v in cpu.state_dict().items()}
    batch = check_batch()
    noise = np.random.RandomState(0).randn(*batch["left"].shape)
    perturbed = dict(batch, left=(batch["left"] + PERTURBATION * noise)
                     .astype(np.float32))
    what = f"{name}{' ' + mode if mode else ''} bf16 card train step"
    runs, samples = {}, {}
    steps = [("cpu32", cpu, "cpu", F32, batch),
             ("cpu32+", cpu, "cpu", F32, perturbed),
             ("cpu16", cpu, "cpu", BF16, batch),
             ("card16", model, DEV, BF16, batch)]
    if mode is None:            # the float32 comparison's CPU step
        runs["cpu32"], samples["cpu32"] = cpu_f32_step(name, model)
        steps = steps[1:]
    torch.backends.cudnn.deterministic = True
    try:
        for key, m, dev, dtype, b in steps:
            if m is cpu:
                cpu.load_state_dict(init)
            caught = samples[key] = []
            hooks = [m.get_submodule(stage).register_forward_pre_hook(
                lambda mod, args: caught.append(args[2].detach().cpu()))
                for stage in ("volume_s3", "volume_s2") if name == "CFNet"]
            reset_counts()
            with launch_dtypes(check=key == "card16") as seen:
                runs[key] = step_readings(m, config, b, dtype, dev)
            for hk in hooks:
                hk.remove()
            if key == "card16":
                designs, launch_problems = train_launches(
                    what, train_mix(name, TRAIN_CHECK_B, TRAIN_CHECK_H,
                                    TRAIN_CHECK_W, mode), BF16, seen.seen)
                kernel_errors = seen.errors
    finally:
        torch.backends.cudnn.deterministic = False
    c32, p32, c16, g16 = (runs[k] for k in ("cpu32", "cpu32+", "cpu16",
                                            "card16"))
    row = {"model": name, "mode": mode, "dtype": "bfloat16",
           "shape": [TRAIN_CHECK_B, TRAIN_CHECK_H, TRAIN_CHECK_W, 3],
           "loss_card": g16["loss"], "loss_cpu": c16["loss"],
           "loss_cpu_f32": c32["loss"], "designs": designs,
           "launch_problems": launch_problems,
           "backward_kernels_vs_plain": kernel_errors}
    # the loss by its pixels: |d loss| is one number whose own distance
    # can cancel to near nothing across pixels (GwcNet_G: 0.18 of a loss of
    # 173, where its heads are 4-8% apart); the mean |d| of the pixels'
    # loss terms bounds it and does not cancel
    terms = {k: loss_terms(runs[k]["heads"], batch, config)
             for k in ("cpu32", "cpu16", "card16")}
    row["loss"] = ((terms["card16"] - terms["cpu16"]).abs().mean().item(),
                   (terms["cpu16"] - terms["cpu32"]).abs().mean().item())
    row["loss_abs_diff"] = (abs(g16["loss"] - c16["loss"]),
                            abs(c16["loss"] - c32["loss"]))
    row["heads"] = [(_rel(a, b), _rel(b, c)) for a, b, c in
                    zip(g16["heads"], c16["heads"], c32["heads"])]
    card_stats = _stats_distance(g16["stats"], c16["stats"])
    own_stats = _stats_distance(c16["stats"], c32["stats"])
    row["stats"] = {k: (card_stats[k], own_stats[k]) for k in card_stats}
    names = [k for k, _ in cpu.named_parameters()]
    groups = {k: _groups(names, r["grads"]) for k, r in runs.items()}
    moves = {g: _rel(groups["cpu32+"][g], v) for g, v in
             groups["cpu32"].items() if v.abs().max() > 0}
    row["stable_groups"] = {
        g: (_rel(groups["card16"][g], groups["cpu16"][g]),
            _rel(groups["cpu16"][g], groups["cpu32"][g]), moves[g])
        for g in sorted(moves) if moves[g] < STABLE}
    row["audit_calls"] = sum(map(len, g16["audit"].values()))
    row["audit_equal"] = g16["audit"] == c16["audit"]
    row["float32_outputs"] = (
        g16["loss_dtype"] == F32 and g16["grad_dtypes"] == {F32}
        and all(h.dtype == F32 for h in g16["heads"]))
    moved = [int((a != b).sum()) for a, b in zip(samples["cpu16"],
                                                  samples["card16"])]
    if moved:
        row["samples_moved"] = moved
        row["samples"] = [a.numel() for a in samples["cpu16"]]
    print(f"  {what} {TRAIN_CHECK_H}x{TRAIN_CHECK_W} B {TRAIN_CHECK_B}, "
          f"card vs CPU (CPU bf16 vs f32): loss {g16['loss']:.6f} / "
          f"{c16['loss']:.6f} / {c32['loss']:.6f}, |d| "
          f"{row['loss_abs_diff'][0]:.3e} ({row['loss_abs_diff'][1]:.3e}),"
          f" its pixels' mean |d| {row['loss'][0]:.3e} ({row['loss'][1]:.3e})"
          f"; heads' relative L2 "
          + ", ".join(f"{a:.3e} ({b:.3e})" for a, b in row["heads"])
          + "; running statistics "
          + ", ".join(f"{k} {a:.3e} ({b:.3e})" for k, (a, b) in
                      row["stats"].items())
          + f"; {len(row['stable_groups'])} stable groups of {len(moves)}: "
          + ", ".join(f"{g} {a:.3e} ({b:.3e}, moved {m:.3f})" for g, (
              a, b, m) in row["stable_groups"].items())
          + f"; audit {row['audit_calls']} calls "
          f"{'equal' if row['audit_equal'] else 'DIFFER'}; backward kernels "
          f"in the step vs plain (max|err| / tol) "
          + ", ".join(f"{t} {e:.3f}" for t, e in kernel_errors.items())
          + (f"; samples that differ (s3, s2): {moved} of {row['samples']}"
             if moved else "")
          + "".join(f"; {p}" for p in launch_problems))
    return row


def bf16_step_failures(row) -> list:
    """The gates a `compare_train_step_bf16` reading fails: ``loss``,
    ``heads``, ``running statistics``, ``stable gradients`` (beyond
    BF16_FACTOR x the CPU's own distance, or no stable group), ``dtypes``
    (the audit, float32 loss, heads and gradients), ``backward kernels``
    (a launch of the step against its plain version), ``launches`` (by
    shape, design and data type), ``CPU yardstick`` (the CPU's own
    bf16-vs-f32 distance of a head or a stable group not finite or not
    below 1: its bf16 step is then no yardstick, as PyTorch's CPU dilated
    depthwise conv made ACVNet's ``patch_l2`` gradient 5e30 times its f32
    one on the card's host before `models.acvnet.depthwise_input`)."""
    def far(pairs):
        return any(a > BF16_FACTOR * b for a, b in pairs)
    yardsticks = [b for _, b in row["heads"]] + [
        b for _, b, _ in row["stable_groups"].values()]
    gates = {
        "CPU yardstick": not all(np.isfinite(b) and b < 1
                                 for b in yardsticks),
        "loss": far([row["loss"]]),
        "heads": far(row["heads"]),
        "running statistics": far(row["stats"].values()),
        "stable gradients": not row["stable_groups"] or far(
            (a, b) for a, b, _ in row["stable_groups"].values()),
        "dtypes": not (row["audit_equal"] and row["float32_outputs"]),
        "backward kernels": any(
            e > 1 for e in row["backward_kernels_vs_plain"].values()),
        "launches": bool(row["launch_problems"])}
    return [gate for gate, failed in gates.items() if failed]


def train_card_vs_cpu_bf16(name, mode=None) -> dict:
    """`compare_train_step_bf16`, required within its gates."""
    row = compare_train_step_bf16(name, mode)
    failed = bf16_step_failures(row)
    require(not failed, f"{name}{' ' + mode if mode else ''} bf16 card "
                        f"train step differs from the CPU port: {failed}")
    return row


# --------------------------------------------------------------- phase 15
# estimators held card vs CPU on one probability volume: the argmax, the
# mode bounds and the modal mask exactly; the soft estimators within
# EST_TOL x max_disp (a pixel whose two modes' masses lie within the
# rounding bound of their float32 sums, `tie_bound`, may take either mode:
# its decision is rounding)
EST_TOL = 1e-5
UNIT_ROUNDOFF = 2.0 ** -24          # float32's u


def gamma(k: int) -> float:
    """``γ_k = k·u / (1 − k·u)``: a float32 sum of k + 1 terms, in any
    order, lies within ``γ_k · Σ|terms|`` of the exact sum (Higham,
    Accuracy and Stability of Numerical Algorithms, §4.2)."""
    return k * UNIT_ROUNDOFF / (1 - k * UNIT_ROUNDOFF)


def modal_terms(prob) -> tuple[torch.Tensor, torch.Tensor]:
    """The terms ``[B, D, H, W]`` of the dominant-modal estimator's two
    masses, as it forms them: its top mode's (y) and its runner-up's
    (z)."""
    blur = estimators._box_blur_d(prob)
    mask = estimators.modal_mask(blur)
    y = prob * mask
    return y, (prob - y) * estimators.modal_mask(blur * ~mask)


def tie_bound(y, z, terms: int) -> torch.Tensor:
    """``2·γ_{terms−1}·(y + z)``: how far two float32 summation orders of
    y and z (nonnegative terms, `terms` a sum) can put ``y − z`` apart.
    Each order's ``ŷ − ẑ`` lies within ``γ_{terms−1}·(y + z)`` of the
    exact ``y − z``, so two orders lie within twice that of each other, and
    their decisions ``ŷ ≥ ẑ`` can differ only where ``|y − z|`` is within
    this bound."""
    return 2 * gamma(terms - 1) * (y + z)


def rounding_ties(prob) -> tuple[torch.Tensor, torch.Tensor]:
    """Where the dominant-modal estimator's choice of mode is rounding
    (``|y − z| ≤ tie_bound``), and ``|y − z|``, ``[B, H, W]``."""
    # summed in float64: exact to far below float32's rounding
    y, z = (t.double().sum(1) for t in modal_terms(prob))
    margin = (y - z).abs()
    return margin <= tie_bound(y, z, prob.shape[1]), margin


def check_estimators(gen) -> dict:
    """The four disparity estimators on the card and on the CPU, on a real
    probability volume: the softmax over D of GwcNet_G's (float32, seeded
    random weights, settled BatchNorm) ``classif3`` costs upsampled to
    ``[1, 192, 480, 640]``, as its head regresses them."""
    model = create_model("GwcNet_G", max_disp=MAX_DISP,
                         generator=torch.Generator().manual_seed(0))
    left, right = (t.to(DEV) for t in stereo_pair(1, H, W, seed=21))
    settle_and_perturb_bn(model, left, right, gen)
    costs = []
    hook = model.classif3[1].register_forward_hook(
        lambda mod, inp, out: costs.append(out))
    with torch.no_grad():
        model(left, right)
    hook.remove()
    cost = port_interpolate(costs[0][..., 0], (MAX_DISP, H, W), (1, 2, 3),
                            align_corners=False)
    prob = torch.softmax(cost.float(), dim=1)
    del model, costs, cost
    cpu = prob.cpu()
    row = {"shape": list(prob.shape), "tolerance_px": EST_TOL * MAX_DISP}
    for got, want, what in zip(estimators.mode_bounds(prob),
                               estimators.mode_bounds(cpu),
                               ("argmax index", "left bound", "right bound")):
        require(torch.equal(got.cpu(), want), f"estimators: {what} differs")
    require(torch.equal(estimators.modal_mask(prob).cpu(),
                        estimators.modal_mask(cpu)),
            "estimators: modal mask differs")
    tied, margin = rounding_ties(cpu)
    for name in ("argmax_disparity_estimator",
                 "softargmax_disparity_estimator",
                 "unimodal_disparity_estimator",
                 "dominant_modal_disparity_estimator"):
        fn = getattr(estimators, name)
        d = (fn(prob).cpu() - fn(cpu)).abs()
        ms = device_ms(lambda: fn(prob), 3, warmup=1)
        ties, widest = 0, 0.0
        if name.startswith("argmax"):
            require(d.max().item() == 0, f"estimators: {name} differs")
        elif name.startswith("dominant"):
            off = d > EST_TOL * MAX_DISP
            ties = int(off.sum())
            require(bool(tied[off].all()),
                    f"estimators: {name} differs beyond "
                    f"{EST_TOL * MAX_DISP} px where its modes are farther "
                    f"apart than their sums' rounding bound")
            widest = margin[off].max().item() if ties else 0.0
            d = d[~off] if ties else d
        else:
            require(d.max().item() <= EST_TOL * MAX_DISP,
                    f"estimators: {name} differs by {d.max().item()} px")
        row[name] = {"max_abs_px": d.max().item(), "card_ms": ms,
                     "tied_pixels": ties, "largest_excused_margin": widest}
        print(f"  {name}: card vs CPU max|d| {d.max().item():.3e} px (tol "
              f"{EST_TOL * MAX_DISP:.3e}; pixels excused as rounding ties: "
              f"{ties}, the largest |y - z| excused {widest:.3e}), card "
              f"{ms:.3f} ms")
    print(f"  modes: {int(tied.sum())} pixels tied within their sums' "
          f"rounding bound 2*gamma_{MAX_DISP - 1}*(y + z) (at most "
          f"{2 * gamma(MAX_DISP - 1):.3e} x (y + z)); argmax, bounds and "
          f"modal mask equal")
    return row


# --------------------------------------------------------------- phase 17
EVAL_MODEL = "GwcNet_G"
EVAL_FRAMES = 2                  # frames of each dataset written in full
EVAL_ROWS = 12                   # manifest lines a dataset: them, cycled
EVAL_CHECK = (192, 384)          # the frames of the card-vs-CPU trees
EVAL_MEAN_PX, EVAL_MAX_PX = 5e-3, 0.1   # the forward's card-vs-CPU gates
# speed rows: warm-up forwards, then SPEED_READINGS readings of the timed
# forwards at each resolution of the suite's ladder
# one reading since phase 21 came (2 since phase 20, 3 before)
SPEED_WARMUP, SPEED_READINGS = 2, 1
SPEED_ITERS = {(480, 640): 30, (736, 1280): 8, (1088, 1920): 8}
HOST_RUNS = 5                    # forwards enqueued alone on an idle card
HOST_BOUND = 0.9                 # their enqueue / the card's time: host-bound


class TimedLoader:
    """A loader that records, for each batch, the seconds the caller
    waited for it and the moment it arrived."""

    def __init__(self, loader):
        self.loader, self.waits, self.arrivals = loader, [], []

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            t1 = time.perf_counter()
            self.waits.append(t1 - t0)
            self.arrivals.append(t1)
            yield batch


def run_eval_suites(apply_fn, roots) -> dict:
    """Each data suite of ``eval.py`` on the trees at `roots`: its metrics,
    frames and wall seconds; and in steady state, from each loader's first
    batch to its last (the first batch, which waits for the workers to
    start and decode, left out), the frames a second and the loader's share
    of that time."""
    out = {}
    for suite in eval_cli.DATA_SUITES:
        loaders = eval_cli.suite_loaders(suite, roots[suite], roots["lists"])
        timed = ({k: TimedLoader(v) for k, v in loaders.items()}
                 if isinstance(loaders, dict) else TimedLoader(loaders))
        parts = timed.values() if isinstance(timed, dict) else [timed]
        t0 = time.perf_counter()
        metrics = eval_cli.run_suite(suite, apply_fn, timed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steady_s = sum(p.arrivals[-1] - p.arrivals[0] for p in parts)
        steady_frames = sum(len(p.arrivals) - 1 for p in parts)
        out[suite] = {"metrics": np.asarray(metrics).tolist(),
                      "frames": sum(len(p.arrivals) for p in parts),
                      "wall_s": wall, "steady_frames": steady_frames,
                      "steady_s": steady_s,
                      "frames_per_s": steady_frames / steady_s,
                      "loader_share": sum(sum(p.waits[1:]) for p in parts)
                      / steady_s,
                      "first_batch_s": [p.waits[0] for p in parts]}
    return out


def recording(apply_fn, preds):
    def fn(left, right):
        pred = apply_fn(left, right)
        preds.append(pred.cpu().numpy())
        return pred
    return fn


def check_native_decodes(root) -> dict:
    """Every file under `root` decoded by the port's native library and by
    its NumPy/PIL path: the same bits (images, disparity PNGs, PFMs), and
    the seconds each path took, by kind of file (warm reads: the files were
    just written)."""
    from PIL import Image
    row = {"available": port_native.available,
           "build_error": port_native.build_error}
    if not port_native.available:
        return row
    seconds = defaultdict(lambda: [0.0, 0.0, 0])   # kind → native, plain, n
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            if f.endswith(".pfm"):
                call, kind = port_io.pfm_imread, "pfm"
            elif f.endswith(".jpg"):
                call, kind = port_io.load_image_rgb, "jpeg rgb"
            elif f.endswith(".png") and Image.open(path).mode == "RGB":
                call, kind = port_io.load_image_rgb, "png rgb"
            elif f.endswith(".png"):
                call, kind = port_io.load_png_raw, "png raw"
            else:
                continue
            t0 = time.perf_counter()
            got = call(path)
            t1 = time.perf_counter()
            port_native.available = False
            try:
                want = call(path)
            finally:
                port_native.available = True
            t2 = time.perf_counter()
            seconds[kind][0] += t1 - t0
            seconds[kind][1] += t2 - t1
            seconds[kind][2] += 1
            got, want = (np.asarray(x[0] if isinstance(x, tuple) else x)
                         for x in (got, want))
            require(got.dtype == want.dtype and np.array_equal(
                got, want, equal_nan=got.dtype.kind == "f"),
                f"native decode of {path} differs from the plain one")
            if call is port_io.load_image_rgb:
                t0 = time.perf_counter()
                norm = port_io.normalize_u8(got)
                t1 = time.perf_counter()
                plain = port_io.imagenet_normalize(port_io.to_float01(got))
                t2 = time.perf_counter()
                seconds["normalize"][0] += t1 - t0
                seconds["normalize"][1] += t2 - t1
                seconds["normalize"][2] += 1
                require(np.abs(norm - plain).max() <= 2e-6,
                        f"native normalize of {path} off by more than 2e-6")
    row["files_held"] = sum(n for k, (_, _, n) in seconds.items()
                            if k != "normalize")
    row["ms_per_file"] = {k: {"native": 1e3 * a / n, "plain": 1e3 * b / n,
                              "files": n}
                          for k, (a, b, n) in seconds.items()}
    return row


def _suite_slack(suite, roots, cpu_preds, tol, epe_tol) -> np.ndarray:
    """`evaluation.suite_slack` of `suite`'s metric vector on the trees at
    `roots`, for predictions within `tol` px (mean `epe_tol`) of
    `cpu_preds`."""
    frames = eval_cli.suite_loaders(suite, roots[suite], roots["lists"])
    if not isinstance(frames, dict):
        return evaluation.suite_slack(list(frames), cpu_preds, (1, 2, 3),
                                      tol, epe_tol, maxdisp=MAX_DISP)
    slack, k = [], 0
    for idx, loader in enumerate(frames.values()):
        batches = list(loader)
        t = (evaluation.GENERALIZATION_THRESHOLDS[idx]
             if suite == "generalization" else 3.0)
        slack.append(evaluation.suite_slack(
            batches, cpu_preds[k:k + len(batches)], (t,), tol, epe_tol,
            regions=suite == "generalization"))
        k += len(batches)
    return np.stack(slack)


def eval_card_vs_cpu(models, root) -> dict:
    """The data suites on the card (`models`: the float32 model and its
    bfloat16 copy) and on the CPU (the same weights in both types) on trees
    of `EVAL_CHECK` frames. The float32 card predictions within the
    forward's gates of the CPU's; the bfloat16 card predictions' mean |d|
    from the CPU's float32 ones within BF16_FACTOR x the CPU bfloat16
    model's own (the rule of the bfloat16 train steps). Every metric within
    `evaluation.suite_slack` of the CPU float32 model's (the tests' rule),
    for bfloat16 with the largest |d| its predictions showed."""
    roots = write_eval_trees(root, frames=2, sizes={
        k: EVAL_CHECK for k in FULL_SIZES}, max_disp=MAX_DISP, seed=18)
    cpus = {}
    for dtype in (F32, BF16):
        cpus[dtype] = create_model(EVAL_MODEL, device="cpu",
                                   max_disp=MAX_DISP, dtype=dtype)
        cpus[dtype].load_state_dict(models[F32].state_dict())
    row = {}
    for suite in eval_cli.DATA_SUITES:
        metrics, preds = {}, {}
        for where, dtype, model in (("card", F32, models[F32]),
                                    ("cpu", F32, cpus[F32]),
                                    ("card", BF16, models[BF16]),
                                    ("cpu", BF16, cpus[BF16])):
            key = (where, dtype)
            preds[key] = []
            loaders = eval_cli.suite_loaders(suite, roots[suite],
                                             roots["lists"])
            metrics[key] = np.asarray(eval_cli.run_suite(
                suite, recording(evaluation.make_apply(model), preds[key]),
                loaders))
        want, want_m = preds["cpu", F32], metrics["cpu", F32]
        row[suite] = {"cpu": want_m.tolist()}
        for dtype in (F32, BF16):
            got = preds["card", dtype]
            d = [np.abs(a - b) for a, b in zip(got, want)]
            require(all(np.isfinite(x).all() for x in got),
                    f"eval {suite} {DTYPE_NAME[dtype]}: non-finite card "
                    f"predictions")
            mean = float(np.mean([x.mean() for x in d]))
            big = float(max(x.max() for x in d))
            if dtype == F32:
                require(max(x.mean() for x in d) < EVAL_MEAN_PX
                        and big < EVAL_MAX_PX,
                        f"eval {suite}: card vs CPU predictions mean|d| "
                        f"{mean}, max {big}")
                slack = _suite_slack(suite, roots, want, EVAL_MAX_PX,
                                     EVAL_MEAN_PX)
                gate = ""
            else:
                own = float(np.mean([np.abs(a - b).mean() for a, b in zip(
                    preds["cpu", BF16], want)]))
                require(mean <= BF16_FACTOR * own,
                        f"eval {suite} bf16: card vs CPU f32 predictions "
                        f"mean|d| {mean} beyond {BF16_FACTOR} x the CPU "
                        f"bf16's {own}")
                slack = _suite_slack(suite, roots, want, big, big)
                gate = (f" (limit {BF16_FACTOR} x the CPU bf16's "
                        f"{own:.3e})")
            card_m = metrics["card", dtype]
            diff = np.abs(card_m - want_m)
            require(diff.shape == slack.shape and (diff <= slack + 1e-6).all(),
                    f"eval {suite} {DTYPE_NAME[dtype]}: card "
                    f"{card_m.tolist()} vs CPU {want_m.tolist()} beyond "
                    f"{slack.tolist()}")
            row[suite][DTYPE_NAME[dtype]] = {
                "card": card_m.tolist(), "slack": slack.tolist(),
                "pred_mean_abs": mean, "pred_max_abs": big,
                **({"cpu_bf16_mean_abs": own} if dtype == BF16 else {})}
            print(f"  {suite} {DTYPE_NAME[dtype]} card vs CPU float32 at "
                  f"{EVAL_CHECK}: preds mean|d| {mean:.2e}{gate} max "
                  f"{big:.2e} px; max |metric d| {diff.max():.2e} within "
                  f"{slack.min():.2e}-{slack.max():.2e}")
    return row


def speed_rows(model) -> list:
    """`evaluation.speed_and_memory_test` at each resolution of its ladder,
    `SPEED_READINGS` times, each reading `SPEED_ITERS` timed forwards after
    `SPEED_WARMUP`; beside it the host's seconds to enqueue one forward on
    an idle card, the median of `HOST_RUNS` (in the timed loop the host
    waits on a full launch queue, so its time there reads the card's). A
    row whose idle enqueue reaches HOST_BOUND of the card's time a forward
    is bound by the host, and reads the host's speed."""
    apply_fn = evaluation.make_apply(model)
    rows = []
    for res, iters in SPEED_ITERS.items():
        readings = []
        for _ in range(SPEED_READINGS):
            with contextlib.redirect_stdout(io.StringIO()):
                _, (t,), (mem,) = evaluation.speed_and_memory_test(
                    apply_fn, model, resolutions=[res], num_iterations=iters,
                    warmup=SPEED_WARMUP)
            readings.append({"ms": 1e3 * t, "peak_mib": mem})
        x = torch.zeros(1, *res, 3, device=DEV)
        host = []
        for _ in range(HOST_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            apply_fn(x, x)
            host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        ms = sorted(r["ms"] for r in readings)[len(readings) // 2]
        host_ms = 1e3 * float(np.median(host))
        rows.append({"resolution": list(res), "iters": iters, "ms": ms,
                     "readings": readings, "host_ms": host_ms,
                     "host_bound": host_ms >= HOST_BOUND * ms,
                     "peak_mib": max(r["peak_mib"] for r in readings)})
    return rows


def check_eval_suites(gen, smi_line) -> dict:
    """Phase 17: the evaluation suites through ``eval.py``'s functions on
    the card, on dataset trees written in the zoo's layouts."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        t0 = time.perf_counter()
        roots = write_eval_trees(os.path.join(tmp, "full"),
                                 frames=EVAL_FRAMES, max_disp=MAX_DISP,
                                 seed=17, rows=EVAL_ROWS)
        row = {"tree_write_s": time.perf_counter() - t0,
               "sizes": {k: list(v) for k, v in FULL_SIZES.items()},
               "frames_written": EVAL_FRAMES, "manifest_rows": EVAL_ROWS,
               "native_io": check_native_decodes(os.path.join(tmp, "full"))}
        nat = row["native_io"]
        if nat["available"]:
            print(f"  native IO library: built, {nat['files_held']} files "
                  f"decoded to the plain path's bits; ms a file native / "
                  f"plain (warm reads): " + ", ".join(
                      f"{k} {v['native']:.2f} / {v['plain']:.2f} "
                      f"({v['files']})"
                      for k, v in nat["ms_per_file"].items()))
        else:
            print(f"  native IO library: unavailable: {nat['build_error']}")
        f32 = create_model(EVAL_MODEL, max_disp=MAX_DISP,
                           generator=torch.Generator().manual_seed(0))
        left, right = (t.to(DEV) for t in stereo_pair(1, H, W, seed=17))
        settle_and_perturb_bn(f32, left, right, gen)
        bf16 = create_model(EVAL_MODEL, max_disp=MAX_DISP, dtype=BF16)
        bf16.load_state_dict(f32.state_dict())
        for dtype, model in ((F32, f32), (BF16, bf16)):
            apply_fn = evaluation.make_apply(model)
            for size in {tuple(-(-s // 96) * 96 for s in hw)
                         for hw in FULL_SIZES.values()}:   # warm each shape
                x = torch.zeros(1, *size, 3, device=DEV)
                apply_fn(x, x)
            torch.cuda.synchronize()
            reset_counts()
            suites = run_eval_suites(apply_fn, roots)
            frames = sum(s["frames"] for s in suites.values())
            totals = {tag: fn.launches for tag, (fn, *_) in KERNELS.items()}
            want = {tag: frames * sum(MIXES[EVAL_MODEL].get(tag, {}).values())
                    for tag in KERNELS}
            require(totals == want, f"eval suites {DTYPE_NAME[dtype]}: "
                                    f"launches {totals} != {want}")
            require_design("K2", DESIGN[dtype], "in the eval suites")
            for tag in ("K1", "K3"):
                require_design(tag, ONE_DESIGN[tag], "in the eval suites")
            for name, s in suites.items():
                require(np.isfinite(s["metrics"]).all(),
                        f"eval {name} {DTYPE_NAME[dtype]}: {s['metrics']}")
                print(f"  {name} {DTYPE_NAME[dtype]}: {s['frames']} frames "
                      f"in {s['wall_s']:.3f} s; steady state "
                      f"{s['steady_frames']} frames in {s['steady_s']:.3f} "
                      f"s, {s['frames_per_s']:.2f} frames/s, loader "
                      f"{100 * s['loader_share']:.1f}% of it; first batch "
                      f"{', '.join(f'{x:.3f}' for x in s['first_batch_s'])}"
                      f" s; metrics {s['metrics']}")
            row[DTYPE_NAME[dtype]] = {"suites": suites, "launches": totals}
        row["card_vs_cpu"] = eval_card_vs_cpu({F32: f32, BF16: bf16},
                                              os.path.join(tmp, "small"))
        print(f"  speed ({smi_line}):")
        row["speed"] = {"warmup": SPEED_WARMUP, "readings": SPEED_READINGS,
                        "host_runs": HOST_RUNS, "card": smi_line}
        for dtype, model in ((F32, f32), (BF16, bf16)):
            rows = speed_rows(model)
            row["speed"][DTYPE_NAME[dtype]] = rows
            for r in rows:
                print(f"  {DTYPE_NAME[dtype]} {r['resolution'][0]}x"
                      f"{r['resolution'][1]}: {r['ms']:.3f} ms a forward "
                      f"(median of " + ", ".join(
                          f"{x['ms']:.3f}" for x in r["readings"])
                      + f"; {r['iters']} each), host enqueues one on an "
                      f"idle card in {r['host_ms']:.3f} ms"
                      f"{' (host-bound)' if r['host_bound'] else ''}, peak "
                      f"{r['peak_mib']:.1f} MiB")
        return row
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------- phase 18
DEFOM_CHECK = (64, 128)          # card vs CPU: a 4x8 patch grid, N = 33
DEFOM_CHECK_B = 2
# the card-vs-CPU checks run both phases at a cut depth (the CPU's forward
# of 32 iterations takes half a minute); the full-size runs take the
# published 32 (eval) and 18 (train) iterations, 8 of them scale updates
DEFOM_CHECK_ITERS = dict(valid_iters=4, train_iters=4, scale_iters=2)
DEFOM_TRAIN_H, DEFOM_TRAIN_W, DEFOM_TRAIN_B = 320, 512, 4
# 1 timed step a type since phase 22 came (2 since phase 21, 3 before)
DEFOM_TRAIN_STEPS, DEFOM_TRAIN_WARMUP = {F32: 1, BF16: 1}, 1
DEFOM_OVERFIT_B, DEFOM_OVERFIT_STEPS = 2, 8
# one forward a trace: a 480x640 forward launches ~11,000 kernels, and with
# three a trace the timing took half of phase 18 (96 of 196 s, H100)
DEFOM_TRACE_ITERS = 1
# the CPU test's f32 gradient floor a group (tests/test_torch_defom.py),
# and its eval gates (mean |d|, 99th percentile, / max(mean |ref|, 1))
DEFOM_GROUP_REL = 5e-2
DEFOM_EVAL_GATES = (5e-3, 2e-2)


def defom_train_mix(b, h, w) -> dict:
    """K7's and K7-bwd's launches in one DEFOMStereo_S train step on a
    ``[b, h, w, 3]`` batch: each kernel once a ViT block (12), on both views
    (2b) at the DAv2 input of (h, w)."""
    ih, iw, _, _ = get_danv2_io_size(h, w)
    key = (2 * b, 6, (ih // 14) * (iw // 14) + 1, 64)
    return {tag: {key: 12} for tag in ("K7", "K7-bwd-dkv", "K7-bwd-dq")}


DEFOM_TRAIN_MIX = defom_train_mix(DEFOM_TRAIN_B, DEFOM_TRAIN_H,
                                  DEFOM_TRAIN_W)
DEFOM_CHECK_MIX = defom_train_mix(DEFOM_CHECK_B, *DEFOM_CHECK)


def defom_config(**kw) -> TrainConfig:
    """``train.py``'s config for DEFOMStereo: the sequence loss over its
    iterations, max_disp 192 for the mask alone."""
    return TrainConfig(max_disp=MAX_DISP, loss="sequence", **kw)


class k7_backward_launches:
    """Within it, the data type of each K7-bwd launch (``seen``, by tag and
    type) and, with `check`, each launch against its plain version on the
    same arguments (uncounted): ``errors[tag]`` the worst max|err| /
    (REL_TOL · max|ref|)."""

    def __init__(self, check: bool = False):
        self.check = check

    def __enter__(self):
        self.seen, self.errors = Counter(), {}
        launch = self.saved = port_attention._launch_backward

        def counted(kind, q, k, v, do, lse, di, outs, scale):
            launch(kind, q, k, v, do, lse, di, outs, scale)
            tag = f"K7-bwd-{kind}"
            self.seen[(tag, DTYPE_NAME[q.dtype])] += 1
            if self.check:
                wq, wk, wv = attention_backward_reference(
                    q, k, v, None, do, lse, scale, di=di)
                for got, ref in zip(outs, (wk, wv) if kind == "dkv"
                                    else (wq,)):
                    err = (got.float() - ref.float()).abs().max().item()
                    tol = REL_TOL[tag][q.dtype] * ref.float().abs().max(
                    ).item()
                    self.errors[tag] = max(self.errors.get(tag, 0.0),
                                           err / tol if tol else (
                                               0.0 if err == 0 else
                                               float("inf")))
        port_attention._launch_backward = counted
        return self

    def __exit__(self, *exc):
        port_attention._launch_backward = self.saved


def defom_launch_problems(what, want, dtype, seen) -> list:
    """A DEFOM step's launches since the counts were reset against `want`:
    by shape, K7 and K7-bwd on their type's design, K7-bwd on `dtype`
    data (`seen`, from `k7_backward_launches`)."""
    problems = []
    for tag, (fn, *_) in KERNELS.items():
        if Counter(fn.shapes) != Counter(want.get(tag, {})):
            problems.append(f"{what} {tag} launches {dict(fn.shapes)}, not "
                            f"{want.get(tag, {})}")
        if not want.get(tag):
            continue
        kind = ONE_DESIGN.get(tag) or DESIGN[dtype]
        ran = designs_of(tag)
        if not ran or any(k.split()[0] != kind for k in ran):
            problems.append(f"{what} {tag} ran {ran}, not {kind}")
        if tag != "K7" and seen[(tag, DTYPE_NAME[dtype])] != sum(
                want[tag].values()):
            problems.append(f"{what} {tag} ran on {dict(seen)}, not "
                            f"{DTYPE_NAME[dtype]}")
    return problems


def defom_groups(model, grads) -> dict:
    """Gradients by group: a top-level module, and the ViT and the two DPT
    heads of ``defomencoder``, each flattened."""
    groups = defaultdict(list)
    for (name, _), g in zip(model.named_parameters(), grads):
        parts = name.split(".")
        key = (f"defomencoder.{parts[2]}" if parts[0] == "defomencoder"
               else parts[0])
        groups[key].append(g.reshape(-1))
    return {k: torch.cat(v) for k, v in groups.items()}


def compare_defom_train_step(dtype=F32) -> dict:
    """One DEFOMStereo_S train step on the card and on the port's CPU paths
    at DEFOM_CHECK, B 2, from the same seeded weights and batch (cuDNN's
    deterministic algorithms on the card): the loss and the gradients by
    group; the card's launches DEFOM_CHECK_MIX, each K7-bwd launch held
    against its plain version on its arguments; the frozen depth head's
    gradient zero on both sides."""
    model = create_model(DEFOM, generator=torch.Generator().manual_seed(0),
                         **DEFOM_CHECK_ITERS)
    cpu = create_model(DEFOM, device="cpu", **DEFOM_CHECK_ITERS)
    cpu.load_state_dict(model.state_dict())
    batch = next(iter(synthetic_loader(*DEFOM_CHECK, DEFOM_CHECK_B, 1,
                                       seed=5, workers=0)))
    got = {}
    torch.backends.cudnn.deterministic = True
    try:
        for m, dev in ((cpu, "cpu"), (model, DEV)):
            rec = GradRecorder()
            reset_counts()
            with k7_backward_launches(check=dev == DEV) as seen:
                _, loss = make_train_step(m, defom_config(), dtype)(
                    TrainState(m, rec), to_device(batch, dev))
            torch.cuda.synchronize()
            got[dev] = (loss.item(), defom_groups(m, rec.grads))
            if dev == DEV:
                problems = defom_launch_problems(
                    f"{DEFOM} card train step {DTYPE_NAME[dtype]}",
                    DEFOM_CHECK_MIX, dtype, seen.seen)
                kernel_errs = seen.errors
    finally:
        torch.backends.cudnn.deterministic = False
    (l_cpu, g_cpu), (l_gpu, g_gpu) = got["cpu"], got[DEV]
    zero = [k for k, g in g_cpu.items() if not g.any()]
    rel = {k: _rel(g_gpu[k], g) for k, g in g_cpu.items() if g.any()}
    row = {"shape": [DEFOM_CHECK_B, *DEFOM_CHECK, 3],
           "dtype": DTYPE_NAME[dtype], "loss_cpu": l_cpu,
           "loss_card": l_gpu, "loss_rel": abs(l_gpu - l_cpu) / abs(l_cpu),
           "groups_rel_l2": rel, "zero_groups": zero,
           "card_zero_groups": [k for k, g in g_gpu.items() if not g.any()],
           "k7_bwd_launch_errors": kernel_errs,
           "finite": bool(np.isfinite(l_gpu) and all(
               torch.isfinite(g).all() for g in g_gpu.values())),
           "problems": problems}
    print(f"  {DEFOM} train step {DEFOM_CHECK[0]}x{DEFOM_CHECK[1]} B "
          f"{DEFOM_CHECK_B} {DTYPE_NAME[dtype]}, card vs CPU: loss "
          f"{l_gpu:.6f} / {l_cpu:.6f} (rel {row['loss_rel']:.3e}); zero "
          f"groups {zero} / {row['card_zero_groups']}; each K7-bwd launch "
          f"vs plain (err / tol) {kernel_errs}")
    for k, r in sorted(rel.items()):
        print(f"    group {k}: relative L2 {r:.3e}")
    for p in problems:
        print(f"    {p}")
    return row


def defom_step_within_limits(row) -> bool:
    """Whether a float32 `compare_defom_train_step` reading is within
    TRAIN_REL (the loss) and DEFOM_GROUP_REL (each group), the depth head
    the only zero group on both sides, every K7-bwd launch within its gate
    and the launches as required."""
    return (row["finite"] and not row["problems"]
            and row["loss_rel"] <= TRAIN_REL
            and max(row["groups_rel_l2"].values()) <= DEFOM_GROUP_REL
            and row["zero_groups"] == row["card_zero_groups"]
            == ["defomencoder.depth_head"]
            and len(row["k7_bwd_launch_errors"]) == 2
            and max(row["k7_bwd_launch_errors"].values()) <= 1.0)


def defom_eval_check() -> tuple:
    """DEFOMStereo_S (seeded random weights) on the card and on the CPU at
    DEFOM_CHECK, float32: DEFOM_EVAL_GATES; then its bfloat16 copy on the
    card, K7 on "mma", against the same forward with K7 swapped for its
    plain version: mean |d| < PLAIN_SWAP_MEAN_PX. Returns the float32 card
    model and the readings."""
    model = create_model(DEFOM, generator=torch.Generator().manual_seed(0),
                         **DEFOM_CHECK_ITERS)
    cpu = create_model(DEFOM, device="cpu", **DEFOM_CHECK_ITERS)
    cpu.load_state_dict(model.state_dict())
    left, right = stereo_pair(1, *DEFOM_CHECK, seed=1)
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu(left, right)
    cpu_s = time.perf_counter() - t0
    got, _, _ = forward_counted(DEFOM, model, left.to(DEV), right.to(DEV))
    d = (got.cpu() - want).abs()
    scale = max(want.abs().mean().item(), 1.0)
    row = {"shape": [1, *DEFOM_CHECK, 3], "mean_abs": d.mean().item(),
           "p99_abs": d.quantile(0.99).item(), "max_abs": d.max().item(),
           "scale": scale, "cpu_s": cpu_s}
    print(f"  {DEFOM} {DEFOM_CHECK[0]}x{DEFOM_CHECK[1]} f32, card vs CPU "
          f"({cpu_s:.1f} s on the CPU): mean |d| {row['mean_abs']:.3e}, p99 "
          f"{row['p99_abs']:.3e}, max {row['max_abs']:.3e} px (scale "
          f"{scale:.3f}; limits {DEFOM_EVAL_GATES} x scale)")
    require(row["mean_abs"] < DEFOM_EVAL_GATES[0] * scale
            and row["p99_abs"] < DEFOM_EVAL_GATES[1] * scale,
            f"{DEFOM} card forward differs from the CPU port")
    m16 = create_model(DEFOM, dtype=BF16, **DEFOM_CHECK_ITERS)
    m16.load_state_dict(model.state_dict())
    l16, r16 = left.to(DEV, BF16), right.to(DEV, BF16)
    got16, _, _ = forward_counted(DEFOM, m16, l16, r16)
    reset_counts()
    with plain_kernels(), torch.no_grad():
        plain16 = m16(l16, r16)
    torch.cuda.synchronize()
    require(attention.launches == 0, "the plain swap still launched K7")
    require(bool(torch.isfinite(got16).all()), f"{DEFOM} bf16 non-finite")
    d16 = (got16.float() - plain16.float()).abs()
    row["bf16_vs_plain_mean_abs"] = d16.mean().item()
    row["bf16_vs_plain_max_abs"] = d16.max().item()
    row["bf16_vs_f32_mean_abs"] = (got16.float() - got).abs().mean().item()
    print(f"  {DEFOM} {DEFOM_CHECK[0]}x{DEFOM_CHECK[1]} bf16, K7 vs its plain "
          f"version on the card: mean |d| {row['bf16_vs_plain_mean_abs']:.3e}"
          f" px (limit {PLAIN_SWAP_MEAN_PX}), max "
          f"{row['bf16_vs_plain_max_abs']:.3e}; from the f32 forward "
          f"{row['bf16_vs_f32_mean_abs']:.3e} px mean")
    require(row["bf16_vs_plain_mean_abs"] < PLAIN_SWAP_MEAN_PX,
            f"{DEFOM} bf16 forward differs from its plain kernels")
    del cpu, m16
    return model, row


def defom_full_size(name, model, dtypes) -> dict:
    """The 480x640 eval forward (32 iterations, 8 of them scale updates) in
    each of `dtypes`, the launches by shape required to be MIXES[name], the
    output finite; without `model`, one of seeded random weights. Returns
    the runs as `full_size_runs` does."""
    runs = {}
    for dtype in dtypes:
        if model is None:
            m = create_model(name, dtype=dtype,
                             generator=torch.Generator().manual_seed(0))
        elif dtype == F32:
            m = model
        else:
            m = create_model(name, dtype=dtype)
            m.load_state_dict(model.state_dict())
        left, right = (t.to(DEV, dtype) for t in stereo_pair(1, H, W, 2))
        out, shapes, designs = forward_counted(name, m, left, right,
                                               by_shape=True)
        require(out.shape == (1, H, W), f"output shape {out.shape}")
        require(bool(torch.isfinite(out).all()), "non-finite output")
        print(f"  {name} {H}x{W} {DTYPE_NAME[dtype]}: disparity "
              f"{out.min().item():.2f}..{out.max().item():.2f}, mean "
              f"{out.float().mean().item():.2f}, launches " + " ".join(
                  f"{t}={c.total()}" for t, c in shapes.items() if c))
        runs[dtype] = (m, (left, right), shapes, out.float(), designs)
    return runs


def defom_train_full_size(dtype) -> tuple[dict, dict]:
    """DEFOMStereo_S's train step in `dtype` at 320x512, B 4 (the default
    crop), on batches of the port's DataLoader: DEFOM_TRAIN_WARMUP warm
    steps and DEFOM_TRAIN_STEPS[dtype] timed ones (host clock around the
    step and a synchronize), each step's launches required to be
    DEFOM_TRAIN_MIX (K7 and K7-bwd on their type's design, K7-bwd on
    `dtype` data), the losses finite; a traced step's kernel families."""
    model = create_model(DEFOM, generator=torch.Generator().manual_seed(0))
    steps = DEFOM_TRAIN_STEPS[dtype]
    loader = synthetic_loader(DEFOM_TRAIN_H, DEFOM_TRAIN_W, DEFOM_TRAIN_B,
                              DEFOM_TRAIN_WARMUP + steps, seed=6)
    config = defom_config()
    state = init_train_state(model, config, len(loader), dtype)
    step = make_train_step(model, config, dtype)
    times, losses = [], []
    for i, batch in enumerate(loader):
        batch = to_device(batch, DEV)
        torch.cuda.synchronize()
        if i == DEFOM_TRAIN_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with k7_backward_launches() as seen:
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        problems = defom_launch_problems(
            f"{DEFOM} {DTYPE_NAME[dtype]} train step {i}", DEFOM_TRAIN_MIX,
            dtype, seen.seen)
        require(not problems, "; ".join(problems))
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    designs = {tag: designs_of(tag) for tag in DEFOM_TRAIN_MIX}
    mix = {tag: Counter(KERNELS[tag][0].shapes) for tag in DEFOM_TRAIN_MIX}
    require(all(np.isfinite(losses)), f"{DEFOM} train losses {losses}")
    families: dict = defaultdict(float)
    t0 = time.perf_counter()
    kernels, _ = trace(lambda: step(state, batch), 1, grad=True, host=False)
    traced_s = time.perf_counter() - t0
    for key, (ms, _) in kernels.items():
        families[kernel_family(key)] += ms
    timed = sorted(times[DEFOM_TRAIN_WARMUP:])
    row = {"shape": [DEFOM_TRAIN_B, DEFOM_TRAIN_H, DEFOM_TRAIN_W, 3],
           "dtype": DTYPE_NAME[dtype], "iters": model.train_iters,
           "scale_iters": model.scale_iters, "warmup": DEFOM_TRAIN_WARMUP,
           "steps": steps, "step_ms_median": timed[len(timed) // 2],
           "step_ms": times, "peak_mib": peak / 2**20, "losses": losses,
           "launches_per_step": {tag: {str(k): n for k, n in c.items()}
                                 for tag, c in mix.items()},
           "designs_last_step": designs,
           "traced_step_families_ms": dict(families) or None,
           "traced_step_launches": sum(n for _, n in kernels.values()),
           "traced_s": traced_s}
    print(f"  {DEFOM} train {DEFOM_TRAIN_H}x{DEFOM_TRAIN_W} B "
          f"{DEFOM_TRAIN_B} {DTYPE_NAME[dtype]}: median step "
          f"{row['step_ms_median']:.1f} ms over {steps} (all "
          + ", ".join(f"{t:.1f}" for t in times) + f" ms), peak "
          f"{row['peak_mib']:.1f} MiB, losses "
          + ", ".join(f"{v:.3f}" for v in losses) + "; launches a step: "
          + ", ".join(f"{tag} {dict(c)}" for tag, c in mix.items()))
    if families:
        busy = sum(families.values())
        print(f"    traced step: device busy {busy:.1f} ms in "
              f"{row['traced_step_launches']:g} launches ({traced_s:.1f} s "
              f"to trace)")
        for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
            print(f"    family {fam:40s} {ms:9.3f} ms")
    else:
        print("    torch.profiler saw no device time: the step's kernel "
              "families not measured")
    del state, step, model
    return row, mix


def defom_overfit(dtype) -> dict:
    """DEFOM_OVERFIT_STEPS steps in `dtype` on one fixed 320x512 batch of
    DEFOM_OVERFIT_B (the default lr 2e-4, clip 1.0, 30 scheduled steps):
    every loss finite and the last below 0.9 x the first. (At lr 1e-3 the
    randomly initialised model's sequence loss swings by 2x from step to
    step, its scale updates compounding.)"""
    model = create_model(DEFOM, generator=torch.Generator().manual_seed(0))
    config = defom_config(clip_grad=1.0)
    state = init_train_state(model, config, 30, dtype)
    step = make_train_step(model, config, dtype)
    batch = to_device(next(iter(synthetic_loader(
        DEFOM_TRAIN_H, DEFOM_TRAIN_W, DEFOM_OVERFIT_B, 1, seed=7,
        workers=0))), DEV)
    losses = []
    for _ in range(DEFOM_OVERFIT_STEPS):
        state, loss = step(state, batch)
        losses.append(loss.item())
    print(f"  {DEFOM} overfit {DEFOM_TRAIN_H}x{DEFOM_TRAIN_W} B "
          f"{DEFOM_OVERFIT_B} {DTYPE_NAME[dtype]}: losses "
          + ", ".join(f"{v:.3f}" for v in losses))
    require(all(np.isfinite(losses)) and losses[-1] < 0.9 * losses[0],
            f"{DEFOM} {DTYPE_NAME[dtype]} overfit losses {losses}")
    del state, step, model
    return {"shape": [DEFOM_OVERFIT_B, DEFOM_TRAIN_H, DEFOM_TRAIN_W, 3],
            "losses": losses}


def check_defom() -> tuple[dict, dict, dict]:
    """Phase 18: DEFOMStereo_S eval card vs CPU (f32) and bf16 vs its plain
    K7 at DEFOM_CHECK; the 480x640 eval in f32 and bf16 and DEFOMStereo_L's
    in bf16; the train step card vs CPU at DEFOM_CHECK (f32 gated, bf16
    with each K7-bwd launch against its plain version), the full-size steps
    and the overfit in both types. Returns the eval runs by model and the
    train line's row."""
    t0 = time.perf_counter()
    seconds = {}
    model, check = defom_eval_check()
    seconds["eval_check"] = time.perf_counter() - t0
    full = create_model(DEFOM)
    full.load_state_dict(model.state_dict())
    runs = {DEFOM: defom_full_size(DEFOM, full, (F32, BF16))}
    del model, full
    torch.cuda.empty_cache()
    runs[DEFOM_L] = defom_full_size(DEFOM_L, None, (BF16,))
    torch.cuda.empty_cache()
    seconds["eval_full_size"] = time.perf_counter() - t0 - sum(
        seconds.values())
    row = {"card_vs_cpu": compare_defom_train_step(F32)}
    require(defom_step_within_limits(row["card_vs_cpu"]),
            f"{DEFOM} card train step differs from the CPU port")
    bf16 = compare_defom_train_step(BF16)
    require(bf16["finite"] and not bf16["problems"]
            and len(bf16["k7_bwd_launch_errors"]) == 2
            and max(bf16["k7_bwd_launch_errors"].values()) <= 1.0,
            f"{DEFOM} bf16 card train step: {bf16}")
    row["bf16"] = {"card_vs_cpu": bf16}
    seconds["train_check"] = time.perf_counter() - t0 - sum(
        seconds.values())
    row["full_size"], mix = defom_train_full_size(F32)
    torch.cuda.empty_cache()
    row["overfit"] = defom_overfit(F32)
    torch.cuda.empty_cache()
    row["bf16"]["full_size"], _ = defom_train_full_size(BF16)
    torch.cuda.empty_cache()
    row["bf16"]["overfit"] = defom_overfit(BF16)
    torch.cuda.empty_cache()
    seconds["train_full_size"] = time.perf_counter() - t0 - sum(
        seconds.values())
    row["eval_check"] = check
    row["seconds"] = seconds
    print(f"  {DEFOM} phase: " + ", ".join(f"{k} {v:.1f} s"
                                          for k, v in seconds.items()))
    return runs, row, mix


# --------------------------------------------------------------- phase 19
# Data-parallel train steps (`parallel`, ``make_train_step(..., mesh=)``)
# of GwcNet_G and CFNet at the original crop 256x512, global B 4, in
# float32 and in bfloat16 on float32 masters: two gloo ranks on the one
# card (this process rank 0, a spawned process rank 1; B 2 each) and NCCL
# at world 1 (B 4), and NCCL over two cards where there are two. The
# global batch's ground truth is NaN in regions of other sizes in each
# sample (DP_NAN_ROWS, DP_NAN_COLS), so that the ranks hold different
# numbers of valid pixels. Each mesh's step is held against the one-process
# step on the global batch on the card (cuDNN's deterministic algorithms in
# both). Float32: the loss, the reduced gradients and the running
# statistics within phase 14's card limits, TRAIN_REL and TRAIN_GRAD, or
# DP_FLOOR_FACTOR x the one-process step's own rounding floor where that is
# larger (the same step on the batch in the order DP_REORDER: the sums of
# its BatchNorm statistics and of its loss run in another order). Bfloat16
# as phase 14 holds it: the loss (by its pixels' terms), each head, the
# running statistics and the gradient of each group that the float32 step
# keeps stable under a PERTURBATION of the left image, each within
# BF16_FACTOR x the one-process step's own bfloat16-vs-float32 distance on
# the same batch, and every such limit below 1. Exactly: every rank's
# gradients, parameters and buffers the same bits, every step's launches on
# every rank the block's train mix. On the two-rank meshes the two
# negative controls (DP_CONTROLS) must each fail the float32 limits.
DP_MODELS = ("GwcNet_G", "CFNet")
DP_STEPS = 2                    # timed trainer steps after the recorded one
DP_TIMEOUT_S = 300              # a collective; a rank's join
DP_CASES = [(name, dtype) for name in DP_MODELS for dtype in (F32, BF16)]
DP_REORDER = (1, 0, 3, 2)
DP_FLOOR_FACTOR = 2.0
# NaN ground truth by sample: its first rows, its first columns (a share of
# the crop); ranks 0 and 1 of two keep 1.875 and 1.25 samples' pixels
DP_NAN_ROWS, DP_NAN_COLS = (1 / 8, 0, 0, 1 / 4), (0, 0, 1 / 2, 0)
DP_CONTROLS = ("per_rank_loss_mean", "detached_batch_statistics")


def dp_limits(name) -> dict:
    """Phase 14's float32 card limits of the readings a step of `name` is
    held by."""
    l2_tol, leaf_tol = TRAIN_GRAD.get(name, TRAIN_GRAD["default"])
    return {"loss_rel": TRAIN_REL, "running_stats_rel": TRAIN_REL,
            "grad_rel_l2": l2_tol, "grad_worst_leaf": leaf_tol}


def dp_batch() -> dict:
    """The global batch of every phase-19 step: B 4 at 256x512, its
    ground truth NaN by DP_NAN_ROWS and DP_NAN_COLS."""
    batch = next(iter(synthetic_loader(TRAIN_H, TRAIN_W, TRAIN_B, 1, seed=8,
                                       workers=0)))
    gt = np.array(batch["gt_disp"], np.float32)
    for i, (rows, cols) in enumerate(zip(DP_NAN_ROWS, DP_NAN_COLS)):
        gt[i, :int(rows * TRAIN_H)] = np.nan
        gt[i, :, :int(cols * TRAIN_W)] = np.nan
    return dict(batch, gt_disp=gt)


def sha256(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1)
                 .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def recorded_step(model, config, dtype, batch, mesh=None) -> tuple:
    """One train step of `model` in `dtype` on `batch` (tensors on the
    card; this rank's block under `mesh`), the optimizer a `GradRecorder`,
    cuDNN deterministic: ((loss, gradients, running statistics), heads),
    on the CPU."""
    rec, heads = GradRecorder(), []
    hook = model.register_forward_hook(lambda mod, inp, out: heads.extend(
        o.detach().float().cpu() for o in out))
    torch.backends.cudnn.deterministic = True
    try:
        _, loss = make_train_step(model, config, dtype, mesh=mesh)(
            TrainState(model.train(), rec), batch)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
        hook.remove()
    return (loss.item(), rec.grads, bn_buffers(model)), heads


def dp_model(name):
    return create_model(name, max_disp=MAX_DISP,
                        generator=torch.Generator().manual_seed(0))


def dp_steps(name, dtype, block, mesh=None) -> dict:
    """DP_STEPS trainer steps of `name` (from the phase's seed) in `dtype`
    on `block` (on the card) from ``init_train_state(..., mesh=)``, each
    timed (host clock to a synchronize). The counts are set to 0 before
    each step and read after it: every step's launches are required to be
    the block's train mix, on the type's designs and data. Returns the
    times, the losses, the collectives of each step, the launch problems
    and the digest of the state after the steps."""
    b = block["left"].shape[0]
    mix = train_mix(name, b, TRAIN_H, TRAIN_W)
    what = (f"{name} {DTYPE_NAME[dtype]}" + ("" if mesh is None else
            f" rank {mesh.rank} of {mesh.size}"))
    model = dp_model(name)
    config = train_config(name)
    state = init_train_state(model, config, 100, dtype, mesh=mesh)
    step = make_train_step(model, config, dtype, mesh=mesh)
    times, losses, collectives, problems = [], [], [], []
    for i in range(DP_STEPS):
        torch.cuda.synchronize()
        before = Counter(mesh.collectives if mesh else ())
        reset_counts()
        with launch_dtypes() as seen:
            t0 = time.perf_counter()
            state, loss = step(state, block)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        problems += train_launches(f"{what} step {i}", mix, dtype,
                                   seen.seen)[1]
        if mesh is not None:
            collectives.append(sum((mesh.collectives - before).values()))
        losses.append(loss.item())
    row = dict(step_ms=times, losses=losses, collectives=collectives,
               problems=problems,
               launches={tag: sum(c.values()) for tag, c in mix.items()},
               state_sha=sha256(model.state_dict().values()))
    del state, step, model
    torch.cuda.empty_cache()
    return row


def dp_reference(name, batch) -> dict:
    """The one-process steps of `name` on the global batch
    (`recorded_step`): in float32 (its reading and heads), in float32 on
    the batch in the order DP_REORDER (the float32 floor), in float32 on
    the left image perturbed by PERTURBATION (each group's move: the
    stable groups), and in bfloat16 (its reading and heads); then the
    one-process trainer steps of each type, timed (`dp_steps`)."""
    noise = np.random.RandomState(0).randn(*batch["left"].shape)
    variants = {
        "f32": (F32, batch),
        "reordered": (F32, {k: v[list(DP_REORDER)] for k, v in
                            batch.items()}),
        "perturbed": (F32, dict(batch, left=(batch["left"] + PERTURBATION
                                             * noise).astype(np.float32))),
        "bf16": (BF16, batch)}
    runs = {}
    for key, (dtype, b) in variants.items():
        model = dp_model(name)
        runs[key] = recorded_step(model, train_config(name), dtype,
                                  to_device(b, DEV))
        names = [k for k, _ in model.named_parameters()]
        del model
    groups = {k: _groups(names, runs[k][0][1]) for k in ("f32",
                                                         "perturbed")}
    moves = {g: _rel(groups["perturbed"][g], v)
             for g, v in groups["f32"].items() if v.abs().max() > 0}
    steps = {dtype: dp_steps(name, dtype, to_device(batch, DEV))
             for dtype in (F32, BF16)}
    return {"f32": runs["f32"], "bf16": runs["bf16"], "names": names,
            "floor": train_distances(runs["f32"][0], runs["reordered"][0]),
            "stable": sorted(g for g, m in moves.items() if m < STABLE),
            "moves": moves, "steps": steps}


def dp_bf16_readings(ref, reading, heads, block, config) -> tuple:
    """A bfloat16 mesh step's distances from the one-process bfloat16 step
    and their limits, as phase 14 holds a bfloat16 step: the loss by its
    pixels' terms over this rank's block (mean |d| over the float32 step's
    mean |term|), each head over the block (relative L2), the running
    statistics (`_stats_distance`) and each stable group's gradient
    (relative L2), each limit BF16_FACTOR x the one-process step's own
    bfloat16-vs-float32 distance."""
    b = block["left"].shape[0]
    (_, g16, s16), h16 = ref["bf16"]
    (_, g32, s32), h32 = ref["f32"]
    _, grads, stats = reading
    t = [loss_terms([h[:b] for h in hs], block, config)
         for hs in (heads, h16, h32)]
    scale = t[2].abs().mean().item()
    pairs = {"loss_terms": ((t[0] - t[1]).abs().mean().item() / scale,
                            (t[1] - t[2]).abs().mean().item() / scale)}
    for i, (a, c, d) in enumerate(zip(heads, h16, h32)):
        pairs[f"head {i}"] = (_rel(a, c[:b]), _rel(c[:b], d[:b]))
    got, own = _stats_distance(stats, s16), _stats_distance(s16, s32)
    for k in got:
        pairs[f"running {k}"] = (got[k], own[k])
    gs = [_groups(ref["names"], g) for g in (grads, g16, g32)]
    for g in ref["stable"]:
        pairs[f"grad {g}"] = (_rel(gs[0][g], gs[1][g]),
                              _rel(gs[1][g], gs[2][g]))
    apart = {k: a for k, (a, _) in pairs.items()}
    limits = {k: BF16_FACTOR * own for k, (_, own) in pairs.items()}
    return apart, limits


def dp_control_patches() -> dict:
    """Each negative control's (object, attribute, fault), planted here
    alone: the per-rank loss mean (each rank's own masked mean, averaged:
    DDP's fault), and BatchNorm statistics reduced outside autograd (the
    global statistics in the forward, each rank's own Σdy and Σdy·(x −
    mean) in the backward)."""
    backward = port_layers._GlobalBatchNorm.backward

    def local_backward(ctx, *grads):
        with patched(parallel, "all_reduce_sum", lambda ts, mesh: ts):
            return backward(ctx, *grads)
    return {"per_rank_loss_mean": (
                parallel, "pixel_share",
                lambda mask, mesh: torch.tensor(1.0 / mesh.size,
                                                dtype=torch.float64)),
            "detached_batch_statistics": (port_layers._GlobalBatchNorm,
                                          "backward",
                                          staticmethod(local_backward))}


@contextlib.contextmanager
def patched(obj, attr, value):
    saved = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, saved)


def dp_rank_run(name, dtype, batch, mesh) -> dict:
    """On this rank of `mesh`, `name` from the phase's seed: one step of
    ``make_train_step(..., mesh=)`` on the rank's block of `batch`, the
    optimizer a `GradRecorder`, cuDNN deterministic (its readings, its
    launches required to be the block's train mix), then `dp_steps`.
    Returns the readings and the digests of the gradients and of the
    state after the steps."""
    b = TRAIN_B // mesh.size
    what = f"{name} {DTYPE_NAME[dtype]} rank {mesh.rank} of {mesh.size}"
    block = to_device(parallel.shard_batch(batch, mesh), DEV)
    reset_counts()
    with launch_dtypes() as seen:
        reading, heads = recorded_step(dp_model(name), train_config(name),
                                       dtype, block, mesh)
    problems = train_launches(f"{what} recorded step",
                              train_mix(name, b, TRAIN_H, TRAIN_W), dtype,
                              seen.seen)[1]
    row = dp_steps(name, dtype, block, mesh)
    row.update(reading=reading, heads=heads, grads_sha=sha256(reading[1]),
               problems=problems + row["problems"])
    return row


def dp_control_runs(batch, mesh) -> dict:
    """Each model's float32 recorded step on this rank's block under each
    control of DP_CONTROLS: its readings."""
    block = to_device(parallel.shard_batch(batch, mesh), DEV)
    out = {}
    for name in DP_MODELS:
        for control, (obj, attr, fault) in dp_control_patches().items():
            with patched(obj, attr, fault):
                out[name, control] = recorded_step(
                    dp_model(name), train_config(name), F32, block, mesh)[0]
    torch.cuda.empty_cache()
    return out


def dp_rank1(store, backend, device_index) -> None:
    """Rank 1 of a two-rank mesh, in its own process: every case of
    DP_CASES, its rows (without the readings) gathered to rank 0, then the
    controls."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", device_index)
    parallel.init_distributed(device, backend=backend, init_method=store,
                              rank=1, world_size=2,
                              timeout=timedelta(seconds=DP_TIMEOUT_S))
    try:
        mesh = parallel.make_mesh(device=device)
        batch = dp_batch()
        for name, dtype in DP_CASES:
            row = dp_rank_run(name, dtype, batch, mesh)
            del row["reading"], row["heads"]
            torch.distributed.gather_object(row, None, dst=0)
        dp_control_runs(batch, mesh)
    finally:
        torch.distributed.destroy_process_group()


def dp_mesh_cases(label, mesh, batch, refs) -> list:
    """Every case of DP_CASES on `mesh` (this process its rank 0), held
    against the one-process step `refs`, and on a mesh of two ranks the
    controls: the rows of the train line."""
    rows = []
    b = TRAIN_B // mesh.size
    block = {k: v[:b] for k, v in batch.items()}
    for name, dtype in DP_CASES:
        row = dp_rank_run(name, dtype, batch, mesh)
        ranks = [row]
        if mesh.size > 1:
            ranks = [None] * mesh.size
            torch.distributed.gather_object(
                dict(row, reading=None, heads=None), ranks, dst=0)
        ref = refs[name]
        if dtype == F32:
            apart = train_distances(ref["f32"][0], row["reading"])
            floor = ref["floor"]
            limits = {k: max(v, DP_FLOOR_FACTOR * floor[k])
                      for k, v in dp_limits(name).items()}
        else:
            apart, limits = dp_bf16_readings(ref, row["reading"],
                                             row["heads"], block,
                                             train_config(name))
            floor = None
        one = ref["steps"][dtype]["step_ms"]
        out = {"mesh": label, "model": name, "dtype": DTYPE_NAME[dtype],
               "block": [b, TRAIN_H, TRAIN_W, 3], "apart": apart,
               "limits": limits, "one_process_floor": floor,
               "stable_groups": None if dtype == F32 else ref["stable"],
               "step_ms": [r["step_ms"] for r in ranks],
               "one_process_step_ms": one,
               "losses": row["losses"],
               "collectives_per_step": row["collectives"],
               "launches_per_step": row["launches"],
               "same_gradient_bits": len({r["grads_sha"] for r in ranks})
               == 1,
               "same_state_bits": len({r["state_sha"] for r in ranks}) == 1,
               "launch_problems": [p for r in ranks for p in r["problems"]],
               "same_losses": all(r["losses"] == row["losses"]
                                  for r in ranks)}
        out["within_limits"] = (
            all(apart[k] <= v for k, v in limits.items())
            and all(np.isfinite(v) and v < 1 for v in limits.values())
            and (dtype == F32 or bool(ref["stable"])))
        print(f"  {label} {name} {out['dtype']} B {b} a rank vs one process"
              f" B {TRAIN_B} (the limit"
              + ("; the one-process floor" if floor else "") + "): "
              + ", ".join(f"{k} {apart[k]:.3e} ({v:.3e}"
                          + (f"; {floor[k]:.3e}" if floor else "") + ")"
                          for k, v in limits.items())
              + (f"; {len(ref['stable'])} stable groups of "
                 f"{len(ref['moves'])}" if dtype == BF16 else "")
              + "; ranks' bits: "
              f"gradients {'same' if out['same_gradient_bits'] else 'DIFFER'}"
              f", state {'same' if out['same_state_bits'] else 'DIFFER'}; "
              f"step ms by rank "
              + "; ".join(", ".join(f"{t:.1f}" for t in r["step_ms"])
                          for r in ranks)
              + f" (one process B {TRAIN_B}: "
              + ", ".join(f"{t:.1f}" for t in one)
              + f"); {out['collectives_per_step'][-1]} collectives a step; "
              f"launches a step {out['launches_per_step']}"
              + "".join(f"; {p}" for p in out["launch_problems"]))
        rows.append(out)
    if mesh.size > 1:
        for (name, control), reading in dp_control_runs(batch,
                                                        mesh).items():
            apart = train_distances(refs[name]["f32"][0], reading)
            limits = {k: max(v, DP_FLOOR_FACTOR * refs[name]["floor"][k])
                      for k, v in dp_limits(name).items()}
            beyond = sorted(k for k, v in limits.items() if apart[k] > v)
            print(f"  {label} {name} float32 control {control} vs one "
                  f"process (the limit): "
                  + ", ".join(f"{k} {apart[k]:.3e} ({v:.3e})"
                              for k, v in limits.items())
                  + f"; {'caught by ' + ', '.join(beyond) if beyond else 'NOT CAUGHT'}")
            rows.append({"mesh": label, "model": name, "dtype": "float32",
                         "control": control, "apart": apart,
                         "limits": limits, "caught_by": beyond})
    return rows


def dp_failures(rows) -> list:
    """The rows phase 19 fails on: a case off its limits, across ranks or
    off its launches; a control within the limits."""
    failed = []
    for r in rows:
        what = f"{r['mesh']} {r['model']} {r['dtype']}"
        if "control" in r:
            if not r["caught_by"]:
                failed.append(f"{what} control {r['control']} not caught")
        elif not (r["within_limits"] and r["same_gradient_bits"]
                  and r["same_state_bits"] and r["same_losses"]) \
                or r["launch_problems"]:
            failed.append(what)
    return failed


def dp_two_ranks(label, backend, device_index, batch, refs, store,
                 proc) -> list:
    """This process as rank 0 of a two-rank `backend` mesh on cuda:0 and
    `proc` (started on `dp_rank1`) as rank 1: `dp_mesh_cases`. Raises if
    rank 1 fails or does not end."""
    device = torch.device("cuda", 0)
    parallel.init_distributed(device, backend=backend, init_method=store,
                              rank=0, world_size=2,
                              timeout=timedelta(seconds=DP_TIMEOUT_S))
    try:
        rows = dp_mesh_cases(label, parallel.make_mesh(device=device),
                             batch, refs)
    finally:
        torch.distributed.destroy_process_group()
        proc.join(timeout=DP_TIMEOUT_S)
        if proc.is_alive():
            proc.kill()
            proc.join(timeout=30)
    require(proc.exitcode == 0, f"{label}: rank 1 exited {proc.exitcode}")
    return rows


def check_data_parallel(smi_line) -> dict:
    """Phase 19: the one-process references, the two gloo ranks on the
    card, NCCL at world 1 (and over two cards where there are two), and
    `measure_scaling` at [1]; every row within its limits, every control
    caught."""
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_"))
    meshes = [("gloo x2 (one card)", "gloo", 0)]
    if torch.cuda.device_count() >= 2:
        meshes.append(("nccl x2 (two cards)", "nccl", 1))
    try:
        # rank 1 imports while the references run
        procs = []
        for i, (_, backend, index) in enumerate(meshes):
            procs.append(ctx.Process(target=dp_rank1, args=(
                f"file://{tmp}/store{i}", backend, index)))
        procs[0].start()
        batch = dp_batch()
        refs = {name: dp_reference(name, batch) for name in DP_MODELS}
        torch.cuda.empty_cache()
        rows = []
        for i, ((label, backend, index), proc) in enumerate(zip(meshes,
                                                                procs)):
            if i:
                proc.start()
            rows += dp_two_ranks(label, backend, index, batch, refs,
                                 f"file://{tmp}/store{i}", proc)
        device = torch.device("cuda", 0)
        parallel.init_distributed(device, init_method=f"file://{tmp}/nccl1",
                                  rank=0, world_size=1,
                                  timeout=timedelta(seconds=DP_TIMEOUT_S))
        try:
            mesh = parallel.make_mesh()
            rows += dp_mesh_cases("nccl x1", mesh, batch, refs)
            model = dp_model("GwcNet_G")
            scaling = {}
            for dtype in (F32, BF16):
                print(f"  measure_scaling GwcNet_G {DTYPE_NAME[dtype]} "
                      f"{TRAIN_H}x{TRAIN_W}, {TRAIN_B} a device ({smi_line})")
                scaling[DTYPE_NAME[dtype]] = measure_scaling(
                    model, train_config("GwcNet_G"), (TRAIN_H, TRAIN_W),
                    TRAIN_B, steps=DP_STEPS, device_counts=[1], dtype=dtype)
            del model
        finally:
            torch.distributed.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    failed = dp_failures(rows)
    seconds = time.perf_counter() - t0
    print(f"phase 19: {seconds:.1f} s ({smi_line})")
    require(not failed, f"data-parallel steps off the one-process step or "
                        f"across ranks, or a control passed: {failed}")
    return {"rows": rows, "scaling": scaling, "seconds": seconds,
            "card": smi_line}


# --------------------------------------------------------------- phase 20
# The refinement's reach in rows: refinenet3's 3x3 convs at dilations 1, 1,
# 2, 4, (8, 8), (16, 16), (1, 1) and conv8's 1. The warp mask and the
# signed correlation are per pixel and per row, so a pixel whose warp mask
# flipped moves the output only within this many rows of its own.
PCW_REFINE_REACH = 1 + 1 + 2 + 4 + 8 + 8 + 16 + 16 + 1 + 1 + 1


def pcw_shapes(tag) -> set:
    """Every launch shape of `tag` in PCWNet_G's and PCWNet_GC's forwards."""
    return {key for name in PCW_MODELS for key in MIXES[name].get(tag, {})}


def check_pcwnet(name):
    """Phase 20 for `name`: the card against the port's CPU paths at
    CHECK_H x CHECK_W, float32: ``classif3``'s costs within 1e-3 x
    max|ref|, ``pred3`` (their regression on each side) and the output
    within mean < 5e-3 and max < 0.1 px. The warp mask (a sampled mask of
    ones >= 0.999) can flip at a near-tie pixel; the flipped pixels are
    counted and printed, and the output is held on the rows farther than
    the refinement's reach from every flipped row (all rows where none
    flipped; at least half of them required). Then bf16 against its K2
    plain swap, held by those costs (`bf16_vs_plain`), and the 480x640
    runs."""
    size = (CHECK_H, CHECK_W)
    model, d, (want_cost, got_cost), _ = card_vs_cpu(name, hook="classif3.2",
                                                      size=size)
    err = (got_cost - want_cost).abs().max().item()
    ref = want_cost.abs().max().item()
    with torch.no_grad():      # pred3 as each side's forward computed it
        want3 = pcwnet.regress(want_cost[..., 0], MAX_DISP, *size)
        got3 = pcwnet.regress(got_cost[..., 0].to(DEV), MAX_DISP,
                              *size).cpu()
    d3 = (got3 - want3).abs()
    flipped = (pcwnet.warp_mask(pcwnet.warp_coords(got3))
               != pcwnet.warp_mask(pcwnet.warp_coords(want3)))[0]
    rows = flipped.any(dim=1).nonzero()[:, 0]
    far = torch.ones(size[0], dtype=torch.bool)
    for y in rows.tolist():
        far[max(0, y - PCW_REFINE_REACH):y + PCW_REFINE_REACH + 1] = False
    d_far = d[0, far]
    check = {"shape": [1, *size, 3], "classif3_max_abs": err,
             "pred3_mean_abs": d3.mean().item(),
             "pred3_max_abs": d3.max().item(),
             "mask_flipped": int(flipped.sum()),
             "rows_held": int(far.sum()), "mean_abs": d_far.mean().item(),
             "max_abs": d_far.max().item(),
             "all_rows_mean_abs": d.mean().item(),
             "all_rows_max_abs": d.max().item()}
    print(f"  {name} classif3 costs, card vs CPU: max|d| {err:.3e} (tol "
          f"{1e-3 * ref:.3e}); pred3 mean |d| {check['pred3_mean_abs']:.3e},"
          f" max {check['pred3_max_abs']:.3e} px; warp mask flipped at "
          f"{check['mask_flipped']} pixels; output held on "
          f"{check['rows_held']} of {size[0]} rows: mean |d| "
          f"{check['mean_abs']:.3e}, max {check['max_abs']:.3e} px")
    require(err <= 1e-3 * ref, f"{name} classif3 costs differ from the CPU")
    require(d3.mean().item() < 5e-3 and d3.max().item() < 0.1,
            f"{name} card pred3 differs from the CPU port")
    require(2 * check["rows_held"] >= size[0]
            and check["mean_abs"] < 5e-3 and check["max_abs"] < 0.1,
            f"{name} card output differs from the CPU port")
    check["bf16_vs_plain"] = bf16_vs_plain(name, model, size,
                                           hook="classif3.2")
    runs = full_size_runs(name, model)
    diff = (runs[BF16][3] - runs[F32][3]).abs()
    print(f"  {name} {H}x{W} pair 3, bfloat16 vs float32: mean |d| "
          f"{diff.mean().item():.3f} px, median {diff.median().item():.3f} px")
    return runs, check


def check_pcwnets(gen, forward, kernels) -> None:
    """Phase 20: PCWNet's kernels at its launch shapes, then each variant
    checked (`check_pcwnet`), profiled at 480x640 in both types and its
    kernels timed at the launches its forwards recorded. Fills `forward`
    and `kernels`."""
    t0 = time.perf_counter()
    # K1, K2, K3 and K6 at every launch shape of the two forwards (new to
    # the port: K1's 1/8 launch at C 320, K2's Mish layers and combine1..3
    # at Ci 104 / 168 / 128 / 192), both types, phases 3-6's tolerances
    errs = {tag: check(gen, pcw_shapes(tag)) for tag, check in (
        ("K1", check_gwc), ("K2", check_conv), ("K3", check_conv3d),
        ("K6", check_concat))}
    for model_name in PCW_MODELS:
        runs, checked = check_pcwnet(model_name)
        forward[model_name] = {"shape": [1, H, W, 3], "max_disp": MAX_DISP,
                               "iters": FWD_ITERS, "warmup": FWD_WARMUP,
                               "trace_iters": TRACE_ITERS,
                               "card_vs_cpu": checked}
        for dtype, (m, inputs, shapes, _, designs) in runs.items():
            forward[model_name][DTYPE_NAME[dtype]] = profile_forward(
                model_name, m, inputs, dtype)
            for tag in MIXES[model_name]:
                kernels.append(time_kernel(model_name, tag, dtype,
                                           shapes[tag], designs,
                                           errs[tag][dtype], gen))
        del runs, m, inputs
        torch.cuda.empty_cache()
    print(f"phase 20: {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------- phase 21
ITER_CHECK = (128, 256)    # card vs CPU: W/4 = 64 > 48, the band's cap binds
# the output's gates (DEFOM's): mean and p99 of |d| as shares of
# max(mean |ref|, 1); IGEV's initial disparity (1/4 units): mean, max px
ITER_EVAL_GATES = (5e-3, 2e-2)
IGEV_INIT_GATES = (1e-3, 1e-2)
# K1's launches of IGEV's forwards at ITER_CHECK and a ragged row (C/G 12,
# D > W), beside IGEV_K1_MIX's
IGEV_K1_CASES = {(1, 32, 64, 96, 48, 8), (1, 5, 37, 96, 48, 8)}


def iter_model(name, device=None, dtype=F32):
    """RAFTStereo, IGEVStereo or their Selective variants (the IGEV
    family at max_disp 192) with seeded random weights, 32 eval
    iterations."""
    kw = {"max_disp": MAX_DISP} if name in IGEV_FAMILY else {}
    return create_model(name, device=device, dtype=dtype,
                        generator=torch.Generator().manual_seed(0), **kw)


def gwc_volume_plain_f32(left, right, max_disp, num_groups):
    """K1's plain version in float32 arithmetic, cast to the features'
    type."""
    return gwc_volume_reference(left.float(), right.float(), max_disp,
                                num_groups).to(left.dtype)


def init_disparity(costs) -> torch.Tensor:
    """IGEV's initial disparity from ``classifier``'s ``[B, 1, D, H, W]``
    costs: softmax over D in float32, regressed."""
    prob = torch.softmax(costs[:, 0].float(), dim=1)
    return port_volume.disparity_regression(prob)


def iter_eval_check(name):
    """Phase 21's and 22's checks of `name` at ITER_CHECK (32
    iterations): the card against the CPU in float32 (ITER_EVAL_GATES; the
    IGEV family's initial disparity IGEV_INIT_GATES); the card's bfloat16
    forward against its float32 one, within twice the CPU's own
    bfloat16-vs-float32 distance on the same input; the IGEV family's
    bfloat16 forward against the same forward with K1 swapped for its
    plain version (mean |d| < PLAIN_SWAP_MEAN_PX). Both
    types take the float32 images, as the JAX models do. Returns the
    float32 card model (BatchNorm settled and perturbed) and the
    readings."""
    size = ITER_CHECK
    model = iter_model(name)
    left, right = stereo_pair(1, *size, seed=1)
    torch.backends.cudnn.deterministic = True
    try:
        settle_and_perturb_bn(model, left.to(DEV), right.to(DEV),
                              torch.Generator().manual_seed(1234))
        models = {"cpu": iter_model(name, "cpu"),
                  "cpu16": iter_model(name, "cpu", BF16), "card": model,
                  "card16": iter_model(name, dtype=BF16)}
        for m in models.values():
            m.load_state_dict(model.state_dict())
        costs, outs, cpu_s = {}, {}, {}

        def keep_costs(key):
            def hook(mod, inputs, out):     # returns None: out unchanged
                costs.setdefault(key, out.float().cpu())
            return hook
        for key, m in models.items():
            if name in IGEV_FAMILY:
                m.classifier.register_forward_hook(keep_costs(key))
            t0 = time.perf_counter()
            if key.startswith("cpu"):
                with torch.no_grad():
                    outs[key] = m(left, right).float()
                cpu_s[key] = time.perf_counter() - t0
            else:
                out, _, _ = forward_counted(name, m, left.to(DEV),
                                            right.to(DEV))
                outs[key] = out.float().cpu()
        if name in IGEV_FAMILY:
            reset_counts()
            l16, r16 = left.to(DEV), right.to(DEV)
            with patched(igev_stereo, "build_gwc_volume",
                              gwc_volume_plain_f32), torch.no_grad():
                plain16 = models["card16"](l16, r16).float().cpu()
            torch.cuda.synchronize()
            require(build_gwc_volume.launches == 0,
                    "the plain swap still launched K1")
    finally:
        torch.backends.cudnn.deterministic = False
    for key, out in outs.items():
        require(out.shape == (1, *size) and bool(torch.isfinite(out).all()),
                f"{name} {key} output {tuple(out.shape)} not finite")
    d = (outs["card"] - outs["cpu"]).abs()
    scale = max(outs["cpu"].abs().mean().item(), 1.0)
    own = (outs["cpu16"] - outs["cpu"]).abs().mean().item()
    card16 = (outs["card16"] - outs["card"]).abs().mean().item()
    row = {"shape": [1, *size, 3], "iters": 32, "mean_abs": d.mean().item(),
           "p99_abs": d.quantile(0.99).item(), "max_abs": d.max().item(),
           "scale": scale, "bf16_vs_f32_card_mean_abs": card16,
           "bf16_vs_f32_cpu_mean_abs": own, "cpu_s": cpu_s}
    print(f"  {name} {size[0]}x{size[1]} f32, card vs CPU ({cpu_s['cpu']:.1f}"
          f" s on the CPU): mean |d| {row['mean_abs']:.3e}, p99 "
          f"{row['p99_abs']:.3e}, max {row['max_abs']:.3e} px (scale "
          f"{scale:.3f}; limits {ITER_EVAL_GATES} x scale)")
    print(f"  {name} {size[0]}x{size[1]} bf16 vs f32: card {card16:.3e} px "
          f"mean, the CPU's own {own:.3e} ({cpu_s['cpu16']:.1f} s; limit 2x)")
    require(row["mean_abs"] < ITER_EVAL_GATES[0] * scale
            and row["p99_abs"] < ITER_EVAL_GATES[1] * scale,
            f"{name} card forward differs from the CPU port")
    require(card16 <= 2 * own, f"{name} card bf16 forward farther from its "
                               f"f32 one than twice the CPU's own distance")
    if name in IGEV_FAMILY:
        di = (init_disparity(costs["card"])
              - init_disparity(costs["cpu"])).abs()
        row["init_disp_mean_abs"] = di.mean().item()
        row["init_disp_max_abs"] = di.max().item()
        dp = (outs["card16"] - plain16).abs()
        row["bf16_vs_plain_k1_mean_abs"] = dp.mean().item()
        row["bf16_vs_plain_k1_max_abs"] = dp.max().item()
        print(f"  {name} initial disparity (1/4 px), card vs CPU: mean |d| "
              f"{row['init_disp_mean_abs']:.3e}, max "
              f"{row['init_disp_max_abs']:.3e} (limits {IGEV_INIT_GATES});"
              f" bf16, K1 vs its plain version: mean |d| "
              f"{row['bf16_vs_plain_k1_mean_abs']:.3e} px (limit "
              f"{PLAIN_SWAP_MEAN_PX}), max "
              f"{row['bf16_vs_plain_k1_max_abs']:.3e}")
        require(row["init_disp_mean_abs"] < IGEV_INIT_GATES[0]
                and row["init_disp_max_abs"] < IGEV_INIT_GATES[1],
                f"{name} initial disparity differs from the CPU port")
        require(row["bf16_vs_plain_k1_mean_abs"] < PLAIN_SWAP_MEAN_PX,
                f"{name} bf16 forward differs from its plain K1")
    del models
    return model, row


def iter_full_size(name, model) -> dict:
    """The 480x640 forward (32 iterations) in float32 and bfloat16 on the
    float32 images, the launches by shape required to be MIXES[name] (none
    for RAFTStereo), the output finite. Returns the runs as
    `full_size_runs` does."""
    runs = {}
    for dtype in (F32, BF16):
        m = model if dtype == F32 else iter_model(name, dtype=dtype)
        if dtype != F32:
            m.load_state_dict(model.state_dict())
        left, right = (t.to(DEV) for t in stereo_pair(1, H, W, 2))
        out, shapes, designs = forward_counted(name, m, left, right,
                                               by_shape=True)
        require(out.shape == (1, H, W) and bool(torch.isfinite(out).all()),
                f"{name} {DTYPE_NAME[dtype]} output {tuple(out.shape)} "
                f"not finite")
        print(f"  {name} {H}x{W} {DTYPE_NAME[dtype]}: disparity "
              f"{out.min().item():.2f}..{out.max().item():.2f}, mean "
              f"{out.float().mean().item():.2f}, launches "
              + (" ".join(f"{t}={c.total()}" for t, c in shapes.items() if c)
                 or "none of the port's kernels"))
        runs[dtype] = (m, (left, right), shapes, out.float(), designs)
    return runs


def check_iteratives(gen, forward, kernels, names=ITERATIVE, errs=None,
                     phase=21) -> dict:
    """Phase 21 (`names`: RAFTStereo, IGEVStereo) or 22 (their Selective
    variants): K1 at IGEVStereo's launch shapes (C 96, G 8: C/G 12) both
    ways unless `errs` holds that check's errors already, then each model
    checked (`iter_eval_check`), its 480x640 forwards run with their
    launches by shape, profiled in both types, and the IGEV family's K1
    timed at the launches its forwards recorded. Fills `forward` and
    `kernels`; returns K1's errors."""
    t0 = time.perf_counter()
    if errs is None:
        errs = check_gwc(gen, set(IGEV_K1_MIX) | IGEV_K1_CASES)
    for name in names:
        t1 = time.perf_counter()
        model, checked = iter_eval_check(name)
        t2 = time.perf_counter()
        runs = iter_full_size(name, model)
        print(f"  {name}: checks {t2 - t1:.1f} s, 480x640 forwards "
              f"{time.perf_counter() - t2:.1f} s")
        forward[name] = {"shape": [1, H, W, 3], "iters": FWD_ITERS,
                         "warmup": FWD_WARMUP, "trace_iters": TRACE_ITERS,
                         "valid_iters": 32, "card_vs_cpu": checked}
        if name in IGEV_FAMILY:
            forward[name]["max_disp"] = MAX_DISP
        for dtype, (m, inputs, shapes, _, designs) in runs.items():
            forward[name][DTYPE_NAME[dtype]] = profile_forward(
                name, m, inputs, dtype)
            for tag in MIXES[name]:
                kernels.append(time_kernel(name, tag, dtype, shapes[tag],
                                           designs, errs[dtype], gen))
        del runs, m, inputs, model
        torch.cuda.empty_cache()
    print(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    return errs


# ----------------------------------------------------- timing (phases 8-13)
def forward_breakdown(name, model, *inputs) -> dict:
    """Forward ms, peak memory (and the memory resident before the
    forwards) and ms per stage, from CUDA events that hooks record on the
    stream at the stage boundaries: FWD_ITERS forwards after FWD_WARMUP.
    The stages, with the gaps between forwards, add up to the forward's
    time. Also the host's time to enqueue one forward to an idle device
    (host clock, no synchronise inside; median of 3): where it is near the
    forward's time, the host sets the pace."""
    stages, tail = STAGES[name]
    marks: list = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((label, ev))

    hooks = [model.register_forward_pre_hook(lambda *a: mark(GAP)),
             model.register_forward_hook(lambda *a: mark(tail))]
    for stage, first, last, before in stages:
        hooks.append(model.get_submodule(first).register_forward_pre_hook(
            lambda *a, lb=before: mark(lb)))
        hooks.append(model.get_submodule(last).register_forward_hook(
            lambda *a, lb=stage: mark(lb)))
    try:
        with torch.no_grad():
            for _ in range(FWD_WARMUP):
                model(*inputs)
            enqueue = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(*inputs)
                enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            marks.clear()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            for _ in range(FWD_ITERS):
                model(*inputs)
        torch.cuda.synchronize()
    finally:
        for hook in hooks:
            hook.remove()
    per_stage: dict = defaultdict(float)
    for (_, a), (label, b) in zip(marks, marks[1:]):
        per_stage[label] += a.elapsed_time(b) / FWD_ITERS
    return {"ms": marks[0][1].elapsed_time(marks[-1][1]) / FWD_ITERS,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "resident_bytes": resident, "host_enqueue_ms": sorted(enqueue)[1],
            "stages_ms": dict(per_stage)}


def kernel_family(name: str) -> str:
    for mark, fam in (("conv3d_fused_kernel", "K2 conv3d_fused"),
                      ("conv3d_fused_mma_kernel", "K2 conv3d_fused"),
                      ("vit_attention_bwd_dkv_kernel",
                       "K7-bwd-dkv vit attention backward"),
                      ("vit_attention_bwd_dq_kernel",
                       "K7-bwd-dq vit attention backward"),
                      ("vit_attention_mma_kernel", "K7 vit attention"),
                      ("vit_attention_tf32x3_kernel", "K7 vit attention"),
                      ("conv3d_stencil_kernel", "K3 conv3d"),
                      ("::conv3d_kernel<", "K3 conv3d"),
                      ("gwc_stream_kernel", "K1 gwc_volume"),
                      ("gwc_rowpass_kernel", "K1-bwd gwc_volume_backward"),
                      ("gather_staged_kernel",
                       "K4-bwd gather_right_by_samples_backward"),
                      ("sample_lists_kernel",
                       "K5-bwd gwc_volume_from_samples_backward"),
                      ("gwc_samples_backward_kernel",
                       "K5-bwd gwc_volume_from_samples_backward"),
                      ("gather_direct_kernel", "K4 sample gather"),
                      ("gwc_direct_kernel", "K5 gwc volume from samples"),
                      ("concat_rows_kernel", "K6 concat volume"),
                      ("vit_attention_kernel", "K7 vit attention")):
        if mark in name:
            return fam
    low = name.lower()
    if "bn_fw" in low or "batch_norm" in low:
        return "BatchNorm (cuDNN or ATen)"
    if "layer_norm" in low:
        return "LayerNorm (ATen)"
    if "nhwctonchw" in low or "nchwtonhwc" in low:
        return "cuDNN layout transposes"
    # plain GEMMs: cuBLAS's (Linear layers) and any cuDNN runs as one; not
    # the implicit-GEMM convs nor the complex GEMMs of cuDNN's FFT convs
    if "nvjet" in low or ("_gemm_" in low and not any(
            s in low for s in ("fprop", "dgrad", "implicit", "cf32"))):
        return "GEMM (cuBLAS, cuDNN)"
    if any(s in low for s in ("conv", "xmma", "implicit", "dgrad", "wgrad",
                              "winograd", "fft", "gemm")):
        return "cuDNN conv"
    return "other (elementwise, copies, reductions)"


def profile_forward(name, model, inputs, dtype,
                    trace_iters=TRACE_ITERS) -> dict:
    t0 = time.perf_counter()
    fwd = forward_breakdown(name, model, *inputs)
    t1 = time.perf_counter()
    kernels, host_ops = trace(lambda: model(*inputs), trace_iters)
    fwd["seconds"] = {"timed": t1 - t0, "traced": time.perf_counter() - t1}
    families: dict = defaultdict(float)
    for key, (ms, _) in kernels.items():
        families[kernel_family(key)] += ms
    busy = sum(families.values())
    launches = sum(n for _, n in kernels.values())
    h, w = inputs[0].shape[1:3]
    print(f"  {name} forward {h}x{w} {DTYPE_NAME[dtype]}: {fwd['ms']:.3f} "
          f"ms, peak memory {fwd['peak_bytes'] / 2**20:.1f} MiB, of which "
          f"{fwd['resident_bytes'] / 2**20:.1f} MiB resident before the "
          f"forwards (both dtypes' weights, inputs); host enqueues a forward "
          f"in {fwd['host_enqueue_ms']:.3f} ms; {fwd['seconds']['timed']:.1f}"
          f" s timing, {fwd['seconds']['traced']:.1f} s tracing")
    for label, ms in sorted(fwd["stages_ms"].items(), key=lambda kv: -kv[1]):
        print(f"    stage {label:40s} {ms:8.3f} ms "
              f"{100 * ms / fwd['ms']:5.1f}%")
    if busy == 0:
        print("    torch.profiler saw no device time: kernel times not "
              "measured")
    else:
        print(f"    device busy {busy:.3f} ms of {fwd['ms']:.3f} ms "
              f"({100 * busy / fwd['ms']:.1f}%), {launches:g} kernel "
              f"launches a forward")
        for fam, ms in sorted(families.items(), key=lambda kv: -kv[1]):
            print(f"    family {fam:40s} {ms:8.3f} ms")
        for key, (ms, n) in sorted(kernels.items(),
                                   key=lambda kv: -kv[1][0])[:12]:
            print(f"    kernel {ms:8.3f} ms x{n:g}  {key[:100]}")
    # the host's side (traced, so slower than untraced): where the time to
    # enqueue a forward goes, by operator's own time
    for key, (ms, n) in sorted(host_ops.items(),
                               key=lambda kv: -kv[1][0])[:8]:
        print(f"    host op {ms:8.3f} ms x{n:g}  {key[:90]}")
    fwd.update(device_busy_ms=busy or None, kernel_families_ms=dict(families),
               kernel_launches=launches)
    return fwd


def time_gwc(mix, dtype, gen):
    """Times and work of a forward's K1 launches, weighted by `mix`."""
    ms = plain = 0.0
    nbytes = flops = 0
    shapes = []
    for (b, h, w, c, d, g), n in mix.items():
        left = randn((b, h, w, c), dtype, gen)
        right = randn((b, h, w, c), dtype, gen)
        reset_counts()
        t = device_ms(lambda: build_gwc_volume(left, right, d, g), 20)
        design = " ".join(designs_of("K1"))
        tp = device_ms(lambda: gwc_volume_reference(left, right, d, g), 5)
        ms, plain = ms + n * t, plain + n * tp
        nbytes += n * (2 * b * h * w * c + b * d * h * w * g) * \
            left.element_size()
        # this data's work: the w < d outputs are zero and need no products
        flops += n * 2 * c * b * h * sum(max(w - dd, 0) for dd in range(d))
        shapes.append({"bhwc": [b, h, w, c], "d": d, "g": g, "launches": n,
                       "design": design, "ms": t, "plain_ms": tp})
    return ms, plain, None, nbytes, flops, shapes


def time_conv(mix, dtype, gen):
    """Times and work of a forward's K2 launches, weighted by `mix`."""
    ms = plain = lib = 0.0
    nbytes = flops = 0
    shapes = []
    for (b, d, h, w, ci, co, res, relu), n in mix.items():
        x, k, scale, bias, r = k2_inputs(ci, co, d, h, w, res, dtype, gen, b)
        kp = pack_conv3d_weight(k)     # as the layers pass it, from a cache
        reset_counts()
        t = device_ms(lambda: conv3d_fused(x, kp, scale, bias, r, relu), 5)
        design = " ".join(designs_of("K2"))
        tp = device_ms(lambda: conv3d_fused_reference(x, k, scale, bias, r,
                                                    relu), 5)
        xv, kv = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)
        tl = device_ms(lambda: F.conv3d(xv, kv, padding=1), 5)
        vox = b * d * h * w
        nbytes += n * ((vox * (ci + co * (2 if res else 1)) + 27 * ci * co)
                       * x.element_size() + 2 * co * 4)
        flops += n * 2 * 27 * ci * co * vox
        ms, plain, lib = ms + n * t, plain + n * tp, lib + n * tl
        shapes.append({"b": b, "dhw": [d, h, w], "ci": ci, "co": co,
                       "residual": res, "relu": relu, "launches": n,
                       "design": design, "ms": t, "plain_ms": tp,
                       "library_ms": tl})
    return ms, plain, lib, nbytes, flops, shapes


def time_conv3d(mix, dtype, gen):
    """Times and work of a forward's K3 launches, weighted by `mix`; the
    library yardstick is ``F.conv3d`` on the channels-first views of the
    same tensors (cuDNN, TF32 off)."""
    ms = plain = lib = 0.0
    nbytes = flops = 0
    shapes = []
    for (b, d, h, w, ci, co), n in mix.items():
        x, k = k3_inputs(b, d, h, w, ci, co, dtype, gen)
        reset_counts()
        t = device_ms(lambda: conv3d(x, k), 20)
        design = " ".join(designs_of("K3"))
        tp = device_ms(lambda: conv3d_reference(x, k), 5)
        xv, kv = x.permute(0, 4, 1, 2, 3), k.permute(4, 3, 0, 1, 2)
        tl = device_ms(lambda: F.conv3d(xv, kv, padding=1), 20)
        vox = b * d * h * w
        nbytes += n * (vox * (ci + co) + 27 * ci * co) * x.element_size()
        flops += n * 2 * 27 * ci * co * vox
        ms, plain, lib = ms + n * t, plain + n * tp, lib + n * tl
        shapes.append({"b": b, "dhw": [d, h, w], "ci": ci, "co": co,
                       "launches": n, "design": design, "ms": t,
                       "plain_ms": tp, "library_ms": tl})
    return ms, plain, lib, nbytes, flops, shapes


def time_gather(mix, dtype, gen):
    """Times and work of a forward's K4 launches, weighted by `mix`; the
    library yardstick is one ``torch.gather`` on the right features padded
    with max_shift zero columns (the pad and the index outside the timed
    call)."""
    ms = plain = lib = 0.0
    nbytes = 0
    shapes = []
    for (b, h, w, c, s, mshift), n in mix.items():
        right = randn((b, h, w, c), dtype, gen)
        smp = samples_for(b, s, h, w, 0, mshift, gen)
        reset_counts()
        t = device_ms(lambda: gather_right_by_samples(right, smp, mshift),
                      20)
        design = " ".join(designs_of("K4"))
        tp = device_ms(lambda: gather_right_by_samples_reference(right, smp,
                                                               mshift), 5)
        padded = F.pad(right, (0, 0, mshift, 0))[:, None].expand(
            b, s, h, w + mshift, c)
        idx = (torch.arange(w, device=DEV) + mshift - smp.long())[
            ..., None].expand(b, s, h, w, c).contiguous()
        tl = device_ms(lambda: torch.gather(padded, 3, idx), 20)
        ms, plain, lib = ms + n * t, plain + n * tp, lib + n * tl
        nbytes += n * ((b * h * w * c + b * s * h * w * c)
                       * right.element_size() + b * s * h * w * 4)
        shapes.append({"bhwc": [b, h, w, c], "s": s, "max_shift": mshift,
                       "launches": n, "design": design, "ms": t,
                       "plain_ms": tp, "library_ms": tl})
    return ms, plain, lib, nbytes, 0, shapes


def time_gwc_samples(mix, dtype, gen):
    """Times and work of a forward's K5 launches, weighted by `mix`."""
    ms = plain = 0.0
    nbytes = flops = 0
    shapes = []
    for (b, h, w, c, s, g, mshift), n in mix.items():
        left = randn((b, h, w, c), dtype, gen)
        right = randn((b, h, w, c), dtype, gen)
        smp = samples_for(b, s, h, w, 0, mshift, gen)
        reset_counts()
        t = device_ms(lambda: gwc_volume_from_samples(left, right, smp, g,
                                                    mshift), 20)
        design = " ".join(designs_of("K5"))
        tp = device_ms(lambda: gwc_volume_from_samples_reference(
            left, right, smp, g, mshift), 5)
        ms, plain = ms + n * t, plain + n * tp
        nbytes += n * ((2 * b * h * w * c + b * s * h * w * g)
                       * left.element_size() + b * s * h * w * 4)
        # this data's work: samples reaching x < 0 give zeros, no products
        inside = (torch.arange(w, device=DEV) >= smp).sum().item()
        flops += n * 2 * c * inside
        shapes.append({"bhwc": [b, h, w, c], "s": s, "g": g,
                       "max_shift": mshift, "launches": n, "design": design,
                       "ms": t, "plain_ms": tp})
    return ms, plain, None, nbytes, flops, shapes


def time_concat(mix, dtype, gen):
    """Times and work of a forward's K6 launches, weighted by `mix`."""
    ms = plain = 0.0
    nbytes = 0
    shapes = []
    for (b, h, w, c, d, mask_left), n in mix.items():
        left = randn((b, h, w, c), dtype, gen)
        right = randn((b, h, w, c), dtype, gen)
        reset_counts()
        t = device_ms(lambda: build_concat_volume(left, right, d, mask_left),
                      20)
        design = " ".join(designs_of("K6"))
        tp = device_ms(lambda: concat_volume_reference(left, right, d,
                                                       mask_left), 5)
        ms, plain = ms + n * t, plain + n * tp
        nbytes += n * (2 * b * h * w * c + 2 * b * d * h * w * c) * \
            left.element_size()
        shapes.append({"bhwc": [b, h, w, c], "d": d, "mask_left": mask_left,
                       "launches": n, "design": design, "ms": t,
                       "plain_ms": tp})
    return ms, plain, None, nbytes, 0, shapes


def time_attention(mix, dtype, gen):
    """Times and work of a forward's K7 launches, weighted by `mix`; the
    library yardstick is ``F.scaled_dot_product_attention`` on the same
    ``[B, heads, N, 64]`` tensors."""
    ms = plain = lib = 0.0
    nbytes = flops = 0
    shapes = []
    for (b, heads, n, d), cnt in mix.items():
        q, k, v = (randn((b, heads, n, d), dtype, gen) for _ in range(3))
        scale = d ** -0.5
        t = device_ms(lambda: attention(q, k, v, scale), 20)
        tp = device_ms(lambda: attention_reference(q, k, v, scale), 5)
        tl = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 20)
        ms, plain, lib = ms + cnt * t, plain + cnt * tp, lib + cnt * tl
        nbytes += cnt * 4 * b * heads * n * d * q.element_size()
        flops += cnt * 4 * b * heads * n * n * d     # q·kᵀ and p·v
        shapes.append({"b": b, "heads": heads, "n": n, "head_dim": d,
                       "launches": cnt, "ms": t, "plain_ms": tp,
                       "library_ms": tl})
    return ms, plain, lib, nbytes, flops, shapes


def time_attention_backward(kind):
    """The timer of K7-bwd's `kind` kernel ("dkv" or "dq"): times and work
    of its launches weighted by `mix`, each on the forward kernel's output
    and log-sum-exp of seeded inputs. The plain version is
    `attention_backward_reference` (dQ, dK and dV together); the library
    yardstick is ``torch.autograd.grad`` through
    ``F.scaled_dot_product_attention`` for the kernel's outputs (its
    backward computes all three). The work counted is the function's own:
    dK, dV need S, dP = dO Vᵀ, dV and dK (8 N² d FLOP a head), dQ needs S,
    dP and dQ (6 N² d); bytes: q, k, v, dO, lse, di read once, the outputs
    written once."""
    launch = {"dkv": attention_backward_dkv, "dq": attention_backward_dq}[
        kind]

    def timer(mix, dtype, gen):
        ms = plain = lib = 0.0
        nbytes = flops = 0
        shapes = []
        for (b, heads, n, d), cnt in mix.items():
            q, k, v, do = (randn((b, heads, n, d), dtype, gen)
                           for _ in range(4))
            scale = d ** -0.5
            out, lse = attention_with_lse(q, k, v, scale)
            di = (do.float() * out.float()).sum(-1)
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            sdpa = F.scaled_dot_product_attention(*leaves, scale=scale)
            wrt = leaves[1:] if kind == "dkv" else leaves[:1]
            t = device_ms(lambda: launch(q, k, v, do, lse, di, scale), 20)
            tp = device_ms(lambda: attention_backward_reference(
                q, k, v, None, do, lse, scale, di=di), 5)
            tl = device_ms(lambda: torch.autograd.grad(
                sdpa, wrt, do, retain_graph=True), 20)
            ms, plain, lib = ms + cnt * t, plain + cnt * tp, lib + cnt * tl
            bh, es = b * heads, q.element_size()
            outs = 2 if kind == "dkv" else 1
            nbytes += cnt * (bh * n * d * es * (4 + outs) + 2 * bh * n * 4)
            flops += cnt * bh * n * n * d * (8 if kind == "dkv" else 6)
            shapes.append({"b": b, "heads": heads, "n": n, "head_dim": d,
                           "launches": cnt, "ms": t, "plain_ms": tp,
                           "library_ms": tl})
            del sdpa, leaves
        return ms, plain, lib, nbytes, flops, shapes
    return timer


# The two 3x3 convs of CFNet's 2D trunk (iconv3, gw3: Ci, Co, H, W, both
# views) for which cuDNN, with TF32 off, takes an algorithm that needs a
# workspace of many GB and most of the f32 forward
CUDNN_PROBE = [(256, 128, 120, 160), (128, 160, 120, 160)]


def cudnn_probe(gen) -> list:
    """``F.conv2d`` at CUDNN_PROBE (float32, channels-last, batch 2) with
    TF32 off and on: device ms and the memory the call takes beyond its
    inputs."""
    rows = []
    for ci, co, h, w in CUDNN_PROBE:
        x = randn((2, h, w, ci), F32, gen).permute(0, 3, 1, 2)
        k = randn((co, ci, 3, 3), F32, gen, 0.02)
        row = {"ci": ci, "co": co, "hw": [h, w]}
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = device_ms(lambda: F.conv2d(x, k, padding=1), 3)
            row["tf32" if tf32 else "f32"] = {
                "ms": ms, "extra_mib": (torch.cuda.max_memory_allocated()
                                        - base) / 2**20}
        torch.backends.cudnn.allow_tf32 = False
        print(f"  cuDNN conv2d {ci}->{co} at 2x{h}x{w}: TF32 off "
              f"{row['f32']['ms']:.3f} ms (+{row['f32']['extra_mib']:.0f} "
              f"MiB), TF32 on {row['tf32']['ms']:.3f} ms "
              f"(+{row['tf32']['extra_mib']:.0f} MiB)")
        rows.append(row)
    return rows


def time_gwc_backward(mix, dtype, gen):
    """Times and work of a train step's K1 backward launches, weighted by
    `mix`: the kernel, its plain version, and (the yardstick, beside the
    shapes) ``torch.autograd.grad`` of `gwc_volume_reference` through a
    kept graph (the backward alone)."""
    ms = plain = 0.0
    nbytes = flops = 0
    shapes = []
    for (b, h, w, c, d, g), n in mix.items():
        left = randn((b, h, w, c), dtype, gen)
        right = randn((b, h, w, c), dtype, gen)
        grad = randn((b, d, h, w, g), dtype, gen)
        reset_counts()
        t = device_ms(lambda: gwc_volume_backward(left, right, grad, d, g),
                      20)
        design = " ".join(designs_of("K1-bwd"))
        tp = device_ms(lambda: gwc_volume_backward_reference(
            left, right, grad, d, g), 3)
        lf, rf = (x.detach().requires_grad_() for x in (left, right))
        vol = gwc_volume_reference(lf, rf, d, g)
        ta = device_ms(lambda: torch.autograd.grad(
            vol, (lf, rf), grad, retain_graph=True), 3)
        del vol
        ms, plain = ms + n * t, plain + n * tp
        # the (d, w) with d <= w: the only entries of grad that reach an
        # output (the volume is zero elsewhere)
        used = sum(min(d, x + 1) for x in range(w))
        # read those of grad, left and right once, write dl and dr once
        nbytes += n * (b * h * g * used + 4 * b * h * w * c) * \
            left.element_size()
        # this data's work: dl[w] takes min(D, w + 1) products a channel,
        # dr[u] min(D, W - u), a multiply-add each
        flops += n * 2 * 2 * b * h * c * used
        shapes.append({"bhwc": [b, h, w, c], "d": d, "g": g, "launches": n,
                       "design": design, "ms": t, "plain_ms": tp,
                       "autograd_ms": ta})
    return ms, plain, None, nbytes, flops, shapes


def time_concat_backward(mix, dtype, gen):
    """Times and work of a train step's K6 backward launches, weighted by
    `mix`: the kernel, its plain version, and ``torch.autograd.grad`` of
    `concat_volume_reference` through a kept graph (the backward alone)
    beside the shapes."""
    ms = plain = 0.0
    nbytes = flops = 0
    shapes = []
    for (b, h, w, c, d, mask_left), n in mix.items():
        grad = randn((b, d, h, w, 2 * c), dtype, gen)
        reset_counts()
        t = device_ms(lambda: concat_volume_backward(grad, d, mask_left), 20)
        design = " ".join(designs_of("K6-bwd"))
        tp = device_ms(lambda: concat_volume_backward_reference(
            grad, d, mask_left), 3)
        lf, rf = (randn((b, h, w, c), dtype, gen).requires_grad_()
                  for _ in range(2))
        vol = concat_volume_reference(lf, rf, d, mask_left)
        ta = device_ms(lambda: torch.autograd.grad(
            vol, (lf, rf), grad, retain_graph=True), 3)
        del vol
        ms, plain = ms + n * t, plain + n * tp
        # the gradient values that reach an output: dl[w] sums min(D, w + 1)
        # of them masked (all D unmasked), dr[u] min(D, W - u)
        used = b * h * c * ((sum(min(d, x + 1) for x in range(w))
                             if mask_left else w * d)
                            + sum(min(d, w - u) for u in range(w)))
        # read those once, write dl and dr once
        nbytes += n * (used + 2 * b * h * w * c) * grad.element_size()
        # this data's work: one add for each of them
        flops += n * used
        shapes.append({"bhwc": [b, h, w, c], "d": d, "mask_left": mask_left,
                       "launches": n, "design": design, "ms": t,
                       "plain_ms": tp, "autograd_ms": ta})
    return ms, plain, None, nbytes, flops, shapes


def train_samples(b, s, h, w, ms, gen):
    """Samples like a CFNet train step's: per pixel, `s` integer-valued
    floats rising from a random low end, in [0, ms]."""
    lo = torch.randint(0, max(ms - s, 1), (b, 1, h, w), generator=gen)
    return (lo + torch.arange(s)[None, :, None, None]).clamp(0, ms).float()\
        .to(DEV)


def gather_backward_build(grad, smp, mshift):
    """K4-bwd's list build alone, on the kernel's plan (its grid, threads
    and shared memory): a kernel of the library that is not the wrapper's,
    so that no count moves."""
    b, s, h, w, c = grad.shape
    plan = gather_backward_plan(w, s, c, grad.dtype)
    offs = torch.empty(b * h * (w + 1), dtype=torch.int32, device=DEV)
    lib = _cuda.library("sample_gather")
    args = (smp.data_ptr(), offs.data_ptr(), b, h, w, c, s, mshift,
            _cuda.dtype_code(grad), *plan, _cuda.stream_of(grad))

    def run():
        _cuda.check(lib, lib.gather_right_by_samples_backward_build(*args),
                    "gather_right_by_samples_backward_build")
    return run


def gwc_samples_backward_lists(smp, mshift):
    """K5-bwd's first kernel (the row's lists to scratch) alone."""
    b, s, h, w = smp.shape
    lists = torch.empty(b * h * sample_scratch_ints(w, s), dtype=torch.int32,
                        device=DEV)
    lib = _cuda.library("sample_gather")
    args = (smp.data_ptr(), lists.data_ptr(), b, h, w, s, mshift,
            _cuda.stream_of(smp))

    def run():
        _cuda.check(lib, lib.gwc_volume_from_samples_backward_lists(*args),
                    "gwc_volume_from_samples_backward_lists")
    return run


def time_gather_backward(mix, dtype, gen):
    """Times and work of a train step's K4 backward launches, weighted by
    `mix`: the kernel, its list build alone, its plain version, the library
    yardstick (one ``index_add_`` of the masked gradient at precomputed
    targets) and ``torch.autograd.grad`` of the plain gather beside the
    shapes."""
    ms = plain = lib = 0.0
    nbytes = flops = 0
    shapes = []
    for (b, h, w, c, s, mshift), n in mix.items():
        smp = train_samples(b, s, h, w, mshift, gen)
        grad = randn((b, s, h, w, c), dtype, gen)
        reset_counts()
        t = device_ms(lambda: gather_right_by_samples_backward(
            grad, smp, mshift), 20)
        design = " ".join(designs_of("K4-bwd"))
        tb = device_ms(gather_backward_build(grad, smp, mshift), 20)
        tp = device_ms(lambda: gather_right_by_samples_backward_reference(
            grad, smp, mshift), 3)
        x = torch.arange(w, device=DEV) - smp.long()
        valid = x >= 0
        row = (torch.arange(b * h, device=DEV).view(b, 1, h, 1)) * w
        target = (row + x.clamp(min=0)).reshape(-1)
        gm = (grad * valid[..., None].to(dtype)).reshape(-1, c)
        tl = device_ms(lambda: torch.zeros(b * h * w, c, dtype=dtype,
                                           device=DEV).index_add_(
            0, target, gm), 20)
        rf = randn((b, h, w, c), dtype, gen).requires_grad_()
        out = gather_right_by_samples_reference(rf, smp, mshift)
        ta = device_ms(lambda: torch.autograd.grad(out, (rf,), grad,
                                                   retain_graph=True), 3)
        del out
        ms, plain, lib = ms + n * t, plain + n * tp, lib + n * tl
        used = c * int(valid.sum())   # the gradient values that reach dright
        # read those and the samples once, write dright once
        nbytes += n * ((used + b * h * w * c) * grad.element_size()
                       + b * s * h * w * 4)
        flops += n * used                       # this data's adds
        shapes.append({"bhwc": [b, h, w, c], "s": s, "max_shift": mshift,
                       "launches": n, "design": design, "ms": t,
                       "build_ms": tb, "plain_ms": tp, "library_ms": tl,
                       "autograd_ms": ta})
    return ms, plain, lib, nbytes, flops, shapes


def time_gwc_samples_backward(mix, dtype, gen):
    """Times and work of a train step's K5 backward launches, weighted by
    `mix`: the kernels, the first (the list build) alone, the plain version
    and ``torch.autograd.grad`` of the plain forward beside the shapes."""
    ms = plain = 0.0
    nbytes = flops = 0
    shapes = []
    for (b, h, w, c, s, g, mshift), n in mix.items():
        left = randn((b, h, w, c), dtype, gen)
        right = randn((b, h, w, c), dtype, gen)
        smp = train_samples(b, s, h, w, mshift, gen)
        grad = randn((b, s, h, w, g), dtype, gen)
        reset_counts()
        t = device_ms(lambda: gwc_volume_from_samples_backward(
            left, right, smp, grad, g, mshift), 20)
        design = " ".join(designs_of("K5-bwd"))
        tb = device_ms(gwc_samples_backward_lists(smp, mshift), 20)
        tp = device_ms(lambda: gwc_volume_from_samples_backward_reference(
            left, right, smp, grad, g, mshift), 3)
        lf, rf = (x.detach().requires_grad_() for x in (left, right))
        out = gwc_volume_from_samples_reference(lf, rf, smp, g, mshift)
        ta = device_ms(lambda: torch.autograd.grad(
            out, (lf, rf), grad, retain_graph=True), 3)
        del out
        ms, plain = ms + n * t, plain + n * tp
        # the samples that read an on-image pixel: the only ones whose
        # gradient reaches dl or dr
        inside = (torch.arange(w, device=DEV) >= smp.long()).sum().item()
        # read left, right, the samples and those of grad once, write dl
        # and dr once
        nbytes += n * ((4 * b * h * w * c + inside * g) * left.element_size()
                       + b * s * h * w * 4)
        # this data's work: a multiply-add into dl and one into dr for each
        # of their channels
        flops += n * 4 * c * inside
        shapes.append({"bhwc": [b, h, w, c], "s": s, "g": g,
                       "max_shift": mshift, "launches": n, "design": design,
                       "ms": t, "build_ms": tb, "plain_ms": tp,
                       "autograd_ms": ta})
    return ms, plain, None, nbytes, flops, shapes


def build_ms(shapes) -> float:
    """The list builds' ms of a backward timer's shapes, weighted by their
    launches."""
    return sum(r["build_ms"] * r["launches"] for r in shapes)


TIMERS = {"K1": time_gwc, "K1-bwd": time_gwc_backward, "K2": time_conv,
          "K3": time_conv3d, "K4": time_gather, "K5": time_gwc_samples,
          "K6": time_concat, "K7": time_attention,
          "K6-bwd": time_concat_backward, "K4-bwd": time_gather_backward,
          "K5-bwd": time_gwc_samples_backward,
          "K7-bwd-dkv": time_attention_backward("dkv"),
          "K7-bwd-dq": time_attention_backward("dq")}
BACKWARD_TAGS = ("K1-bwd", "K6-bwd", "K4-bwd", "K5-bwd")


def time_kernel(model_name, tag, dtype, mix, designs, err, gen) -> dict:
    """The ``kernels`` line's entry of kernel `tag` on the launches `mix`
    that a forward of `model_name` recorded, with the designs they ran."""
    _, kname, source, replaces = KERNELS[tag]
    ms, plain, lib, nbytes, flops, per_shape = TIMERS[tag](mix, dtype, gen)
    kinds = sorted({k.split()[0] for k in designs.get(tag) or {}})
    tf32x3 = kinds == [TF32X3]
    b_ms, b_by = bound(nbytes, flops, dtype, tf32x3)
    entry = {"name": f"{kname} ({DTYPE_NAME[dtype]})", "id": tag,
             "model": model_name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": mix.total(),
             "design": "/".join(kinds), "design_launches": designs.get(tag),
             "max_abs_err": err,
             "tolerance": f"{REL_TOL[tag][dtype]}*max|ref|",
             "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": lib, "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
             "shapes": per_shape}
    bounds = f"bound {b_ms:.4f} by {b_by}, {100 * b_ms / ms:.1f}% of it"
    if tf32x3:
        # the same float32 work on the CUDA cores, beside the bound of the
        # three TF32 products the design computes
        entry["bound_cuda_core_ms"] = bound(nbytes, flops, dtype)[0]
        bounds = (f"3xTF32 {bounds}; CUDA-core bound "
                  f"{entry['bound_cuda_core_ms']:.4f}, "
                  f"{100 * entry['bound_cuda_core_ms'] / ms:.1f}% of it")
    print(f"  {model_name} {tag} {kname} ({DTYPE_NAME[dtype]}, "
          f"{designs.get(tag)}): {ms:.4f} ms x{mix.total()} (plain "
          f"{plain:.4f}, library {lib}, {bounds})")
    return entry


def bound(nbytes, flops, dtype, tf32x3=False):
    """The least time for `nbytes` moved and `flops` of `dtype` computed:
    float32 at the CUDA cores' peak, or with `tf32x3` as three TF32
    products a multiply-add at the tensor cores' TF32 peak."""
    mem, f32, bf16, tf32 = PEAK
    t_bytes = nbytes / mem * 1e3
    if tf32x3:
        t_ops = 3 * flops / tf32 * 1e3
    else:
        t_ops = flops / (f32 if dtype == F32 else bf16) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------- K4-bwd study (--k4-bwd)

K4_BWD_MIX = TRAIN_MIXES["CFNet"]["K4-bwd"]
# phases between the stamps of csrc/sample_gather.cu (SAMPLE_BWD_STAMPS)
K4_BWD_PHASES = {"samples": (0, 1), "zero": (1, 2), "count": (2, 3),
                 "scan": (3, 4), "place": (4, 5), "sort": (5, 6),
                 "wait": (6, 7), "walk": (7, 8)}
# the backward timers of a tree, in a process of their own (sys.argv[1]
# names the tree)
K4_BWD_TIMER_CODE = """
import json, sys
from collections import Counter
import torch
import chip_smoke as cs
gen = torch.Generator().manual_seed(7)
for tag in ("K4-bwd", "K5-bwd"):
    for dtype in (cs.F32, cs.BF16):
        ms, plain, lib, nbytes, flops, shapes = cs.TIMERS[tag](
            Counter(cs.TRAIN_MIXES["CFNet"][tag]), dtype, gen)
        b_ms, _ = cs.bound(nbytes, flops, dtype)
        print(json.dumps({"tree": sys.argv[1], "kernel": tag,
                          "dtype": cs.DTYPE_NAME[dtype], "ms": ms,
                          "share": b_ms / ms, "library_ms": lib,
                          "shapes": [{k: r.get(k) for k in
                                      ("bhwc", "design", "ms", "build_ms")}
                                     for r in shapes]}), flush=True)
"""


def k4_bwd_inputs(key, dtype, gen):
    b, h, w, c, s, ms = key
    return (randn((b, s, h, w, c), dtype, gen),
            train_samples(b, s, h, w, ms, gen), ms)


def k4_bwd_check(gen) -> None:
    for dtype in (F32, BF16):
        for key in K4_BWD_MIX:
            grad, smp, ms = k4_bwd_inputs(key, dtype, gen)
            got = gather_right_by_samples_backward(grad, smp, ms)
            again = gather_right_by_samples_backward(grad, smp, ms)
            require(torch.equal(got, again), f"K4-bwd bits differ {key}")
            held("K4-bwd", dtype, got,
                 gather_right_by_samples_backward_reference(
                     grad.float(), smp, ms), f"{key}")


def k4_bwd_stamps(gen) -> None:
    lib = _cuda.variant("sample_gather", "stamps",
                        flags=("-DSAMPLE_BWD_STAMPS",))
    lib.bwd_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bwd_stamps_read.restype = ctypes.c_int
    with _cuda.loaded_as("sample_gather", lib):
        for dtype in (F32, BF16):
            for key in K4_BWD_MIX:
                grad, smp, ms = k4_bwd_inputs(key, dtype, gen)
                for _ in range(3):
                    gather_right_by_samples_backward(grad, smp, ms)
                torch.cuda.synchronize()
                b, h, w, c, s, _ = key
                plan = gather_backward_plan(w, s, c, dtype)
                blocks = b * h * (c // plan.chunk)
                buf = np.zeros((blocks, 10), np.uint64)
                _cuda.check(lib, lib.bwd_stamps_read(buf.ctypes.data, blocks),
                            "bwd_stamps_read")
                t = buf[:, :9].astype(np.int64) - int(buf[:, 0].min())
                per_sm = defaultdict(list)
                for i in range(blocks):
                    per_sm[int(buf[i, 9])].append((t[i, 0], t[i, 8]))
                conc = max(max(sum(1 for a, e in v if a <= t0 < e)
                               for t0, _ in v) for v in per_sm.values())
                print(json.dumps({
                    "stamps": DTYPE_NAME[dtype], "bhwc": key[:4],
                    "plan": plan._asdict(), "blocks": blocks,
                    "span_us": float(t[:, 8].max() / 1e3),
                    **{f"{p}_us": float(np.mean(t[:, e] - t[:, a]) / 1e3)
                       for p, (a, e) in K4_BWD_PHASES.items()},
                    "block_us": float(np.mean(t[:, 8] - t[:, 0]) / 1e3),
                    "last_start_us": float(t[:, 0].max() / 1e3),
                    "blocks_per_sm_at_once": conc}), flush=True)


def k4_bwd_parent_ab(parent: Path) -> None:
    here = Path(__file__).resolve().parent
    for tree in (parent, here, here, parent):
        env = {**os.environ, "PYTHONPATH": str(tree)}
        run = subprocess.run([sys.executable, "-c", K4_BWD_TIMER_CODE,
                              "parent" if tree == parent else "this"],
                             cwd=tree, env=env, capture_output=True,
                             text=True, timeout=600)
        if run.returncode:
            raise RuntimeError(f"timers in {tree} failed:\n{run.stderr}")
        print(run.stdout, end="", flush=True)


def main_k4_bwd(argv) -> None:
    """``python3 chip_smoke.py --k4-bwd [--parent DIR]``: K4's backward
    kernel ("staged") alone, at CFNet's two train launches, float32 and
    bfloat16: (1) held against its plain version, the same bits twice; (2)
    each block's phase stamps (%globaltimer, ns) from a copy of
    ``csrc/sample_gather.cu`` built with ``-DSAMPLE_BWD_STAMPS``: the list
    threads' samples held, scratch zeroed, entries counted, offsets
    scanned, entries placed, groups sorted, gd landed, lists walked, each
    phase's mean over the blocks, the launch's span and the blocks an SM
    held at once; (3) with ``--parent DIR`` (a checkout with a
    ``chip_smoke.py`` in a directory of this one, e.g. ``git archive`` of
    the parent commit unpacked into a git-ignored directory), `TIMERS` for
    K4-bwd and K5-bwd (each with its list build alone where the tree has
    one) in that tree and in this one, parent, this, this, parent, each in
    its own process. Prints one JSON object a reading. Needs one card."""
    import argparse
    ap = argparse.ArgumentParser(prog="chip_smoke.py --k4-bwd")
    ap.add_argument("--parent", type=Path, default=None)
    args = ap.parse_args(argv)
    parent = None
    if args.parent is not None:
        parent = args.parent.resolve()
        here = Path(__file__).resolve().parent
        if here not in parent.parents or not (parent / "chip_smoke.py"
                                              ).is_file():
            ap.error(f"--parent {args.parent}: not a checkout with a "
                     f"chip_smoke.py inside {here}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(21)
    k4_bwd_check(gen)
    k4_bwd_stamps(gen)
    if parent is not None:
        k4_bwd_parent_ab(parent)
    print(json.dumps({"k4_bwd_ok": True,
                      "device": torch.cuda.get_device_name(0)}))


class PhaseClock:
    """Seconds of each phase: `start` ends the running phase and starts
    the next."""

    def __init__(self):
        self.seconds: dict = {}
        self.phase, self.t = None, time.perf_counter()

    def start(self, phase) -> None:
        now = time.perf_counter()
        if self.phase is not None:
            self.seconds[self.phase] = (self.seconds.get(self.phase, 0.0)
                                        + now - self.t)
        self.phase, self.t = str(phase), now

    def line(self) -> str:
        """``{"phase_seconds": {phase: s, ...}, "total_s": s}``, the
        running phase ended."""
        self.start(None)
        return json.dumps({"phase_seconds": self.seconds,
                           "total_s": sum(self.seconds.values())})


def main() -> None:
    t_start = time.perf_counter()
    clock = PhaseClock()
    clock.start(1)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(f"phase 1: device {name}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}")
    print(smi[0] if smi else "nvidia-smi: no output")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    clock.start(2)
    t0 = time.perf_counter()
    logs = _cuda.build()
    for lib in _cuda.SIGNATURES:
        _cuda.library(lib)
    print(f"phase 2: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s")
    for lib, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {lib}: {line.strip()}")

    gen = torch.Generator().manual_seed(1234)
    errs = {}
    clock.start(3)
    print("phase 3: K1 gwc_volume kernel and its backward vs plain")
    errs["K1"] = check_gwc(gen)
    errs["K1-bwd"] = check_gwc_backward(gen)
    clock.start(4)
    print("phase 4: K2 conv3d_fused kernel vs plain")
    errs["K2"] = check_conv(gen)
    clock.start(5)
    print("phase 5: K3 conv3d kernel vs plain")
    errs["K3"] = check_conv3d(gen)
    clock.start(6)
    print("phase 6: K4, K5 sample kernels and K6 concat volume, and their "
          "backward kernels, vs plain")
    errs["K4"], errs["K5"] = check_samples(gen)
    errs["K6"] = check_concat(gen)
    errs["K6-bwd"] = check_concat_backward(gen)
    errs["K4-bwd"], errs["K5-bwd"] = check_samples_backward(gen)
    clock.start(7)
    print(f"phase 7: K7 vit_attention kernel and its backward (K7-bwd) vs "
          f"plain ({time.perf_counter() - t_start:.1f} s)")
    errs["K7"], errs["K7 DEFOM"] = check_attention(gen)
    errs.update(check_attention_backward(gen))
    kernels = []
    forward = {}
    stereo = {"shape": [1, H, W, 3], "max_disp": MAX_DISP}
    for phase, (model_name, check, meta) in enumerate((
            ("PSMNet", check_psmnet, stereo),
            ("GwcNet_G", check_gwcnet, stereo),
            ("GwcNet_GC", lambda: check_gwcnet("GwcNet_GC"), stereo),
            ("CFNet", check_cfnet, stereo),
            ("ACVNet", check_acvnet, stereo),
            ("DepthAnythingV2", check_dav2,
             {"shape": [1, DAV2_H, DAV2_W, 3], "encoder": DAV2_ENCODER})), 8):
        clock.start(phase)
        print(f"phase {phase}: {model_name} "
              f"({time.perf_counter() - t_start:.1f} s)")
        runs, checked = check()
        print(f"phase {phase}: {model_name} timing")
        forward[model_name] = {**meta, "iters": FWD_ITERS,
                               "warmup": FWD_WARMUP,
                               "trace_iters": TRACE_ITERS}
        if checked:
            forward[model_name]["card_vs_cpu"] = checked
        for dtype, (m, inputs, shapes, _, designs) in runs.items():
            forward[model_name][DTYPE_NAME[dtype]] = profile_forward(
                model_name, m, inputs, dtype)
            for tag in MIXES[model_name]:
                kernels.append(time_kernel(model_name, tag, dtype,
                                           shapes[tag], designs,
                                           errs[tag][dtype], gen))
        del runs, m, inputs   # the next model's peak memory is its own
        torch.cuda.empty_cache()

    clock.start(14)
    print(f"phase 14: training ({time.perf_counter() - t_start:.1f} s)")
    train = {}
    for model_name in TRAIN_MODELS:
        train[model_name], mix = check_training(model_name)
        # each backward kernel at the launches a full-size step made (the
        # same shapes in both types), in both types, with the designs the
        # step of that type ran
        for dtype, run in ((F32, train[model_name]["full_size"]),
                           (BF16, train[model_name]["bf16"]["full_size"])):
            for tag in BACKWARD_TAGS:
                if not mix.get(tag):
                    continue
                entry = time_kernel(f"{model_name} (train step)", tag, dtype,
                                    mix[tag], run["designs_last_step"],
                                    errs[tag][dtype], gen)
                entry["autograd_ms"] = sum(r["autograd_ms"] * r["launches"]
                                           for r in entry["shapes"])
                if "build_ms" in entry["shapes"][0]:
                    entry["build_ms"] = build_ms(entry["shapes"])
                    print(f"  {model_name} (train step) {tag} "
                          f"{DTYPE_NAME[dtype]} list build alone "
                          f"{entry['build_ms']:.4f} ms")
                kernels.append(entry)
        torch.cuda.empty_cache()
    clock.start(15)
    print(f"phase 15: disparity estimators, card vs CPU "
          f"({time.perf_counter() - t_start:.1f} s)")
    estimates = check_estimators(gen)
    torch.cuda.empty_cache()
    clock.start(16)
    print("phase 16: cuDNN float32 probe")
    forward["CFNet"]["cudnn_f32_probe"] = cudnn_probe(gen)
    torch.cuda.empty_cache()
    clock.start(17)
    print(f"phase 17: evaluation suites, {EVAL_MODEL} "
          f"({time.perf_counter() - t_start:.1f} s)")
    t0 = time.perf_counter()
    suites = check_eval_suites(gen, smi[0] if smi else "nvidia-smi: none")
    suites["phase_s"] = time.perf_counter() - t0
    print(f"phase 17: {suites['phase_s']:.1f} s")
    clock.start(18)
    print(f"phase 18: {DEFOM}, eval and training "
          f"({time.perf_counter() - t_start:.1f} s)")
    t0 = time.perf_counter()
    defom_runs, train[DEFOM], defom_mix = check_defom()
    print(f"phase 18: {DEFOM} timing")
    for model_name, runs in defom_runs.items():
        forward[model_name] = {"shape": [1, H, W, 3], "iters": FWD_ITERS,
                               "warmup": FWD_WARMUP,
                               "trace_iters": DEFOM_TRACE_ITERS,
                               "valid_iters": 32, "scale_iters": 8}
        if model_name == DEFOM:
            forward[model_name]["card_vs_cpu"] = train[DEFOM]["eval_check"]
        for dtype, (m, inputs, shapes, _, designs) in runs.items():
            forward[model_name][DTYPE_NAME[dtype]] = profile_forward(
                model_name, m, inputs, dtype, DEFOM_TRACE_ITERS)
            kernels.append(time_kernel(model_name, "K7", dtype, shapes["K7"],
                                       designs, errs["K7 DEFOM"][dtype],
                                       gen))
        del runs, m, inputs
        torch.cuda.empty_cache()
    for dtype, run in ((F32, train[DEFOM]["full_size"]),
                       (BF16, train[DEFOM]["bf16"]["full_size"])):
        pair = [time_kernel(f"{DEFOM} (train step)", tag, dtype,
                            defom_mix[tag], run["designs_last_step"],
                            errs[tag][dtype], gen)
                for tag in ("K7-bwd-dkv", "K7-bwd-dq")]
        kernels.extend(pair)
        # both kernels against one backward of SDPA (each entry's library
        # call computes dQ, dK and dV)
        ms, b_ms = (sum(e[key] for e in pair) for key in ("ms", "bound_ms"))
        sdpa = pair[0]["library_ms"]
        print(f"  {DEFOM} (train step) K7-bwd {DTYPE_NAME[dtype]} "
              f"({pair[0]['design']}): dkv {pair[0]['ms']:.4f} + dq "
              f"{pair[1]['ms']:.4f} = {ms:.4f} ms x{pair[0]['launches']}, "
              f"{100 * b_ms / ms:.1f}% of its bound {b_ms:.4f} "
              f"({pair[0]['bound_by']}); SDPA's backward {sdpa:.4f} ms, "
              f"{ms / sdpa:.2f}x its time")
    train[DEFOM]["seconds"]["timing"] = time.perf_counter() - t0 - sum(
        train[DEFOM]["seconds"].values())
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")
    clock.start(19)
    print(f"phase 19: data-parallel training "
          f"({time.perf_counter() - t_start:.1f} s)")
    train["data_parallel"] = check_data_parallel(
        smi[0] if smi else "nvidia-smi: none")
    clock.start(20)
    print(f"phase 20: PCWNet_G / PCWNet_GC eval "
          f"({time.perf_counter() - t_start:.1f} s)")
    check_pcwnets(gen, forward, kernels)
    clock.start(21)
    print(f"phase 21: RAFTStereo and IGEVStereo eval "
          f"({time.perf_counter() - t_start:.1f} s)")
    k1_errs = check_iteratives(gen, forward, kernels)
    clock.start(22)
    print(f"phase 22: SelectiveRAFT and SelectiveIGEV eval "
          f"({time.perf_counter() - t_start:.1f} s)")
    check_iteratives(gen, forward, kernels, SELECTIVE, k1_errs, 22)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    clock.start(23)
    print(json.dumps({"forward": forward}))
    print(json.dumps({"train": train}))
    print(json.dumps({"estimators": estimates}))
    print(json.dumps({"eval": suites}))
    print(json.dumps({"kernels": kernels}))
    print(clock.line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


def start_alone() -> list:
    """Phases 1 and 2 of a run of one phase: the card's name and power
    limit printed (nvidia-smi's lines returned), TF32 off, the kernels
    built and loaded."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build()
    for lib in _cuda.SIGNATURES:
        _cuda.library(lib)
    return smi


def main_pcwnet() -> None:
    """``python3 chip_smoke.py --pcwnet``: phases 1, 2 and 20."""
    start_alone()
    forward, kernels = {}, []
    check_pcwnets(torch.Generator().manual_seed(1234), forward, kernels)
    print(json.dumps({"forward": forward}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"pcwnet_ok": True,
                      "device": torch.cuda.get_device_name(0)}))


def main_iterative() -> None:
    """``python3 chip_smoke.py --iterative``: phases 1, 2 and 21."""
    clock = PhaseClock()
    clock.start("1-2")
    start_alone()
    clock.start(21)
    forward, kernels = {}, []
    check_iteratives(torch.Generator().manual_seed(1234), forward, kernels)
    print(json.dumps({"forward": forward}))
    print(json.dumps({"kernels": kernels}))
    print(clock.line())
    print(json.dumps({"iterative_ok": True,
                      "device": torch.cuda.get_device_name(0)}))


def main_selective() -> None:
    """``python3 chip_smoke.py --selective``: phases 1, 2 and 22 (K1
    checked at IGEVStereo's shapes here, as phase 21 checks it)."""
    clock = PhaseClock()
    clock.start("1-2")
    start_alone()
    clock.start(22)
    forward, kernels = {}, []
    check_iteratives(torch.Generator().manual_seed(1234), forward, kernels,
                     SELECTIVE, phase=22)
    print(json.dumps({"forward": forward}))
    print(json.dumps({"kernels": kernels}))
    print(clock.line())
    print(json.dumps({"selective_ok": True,
                      "device": torch.cuda.get_device_name(0)}))


def main_data_parallel() -> None:
    """``python3 chip_smoke.py --data-parallel``: phases 1, 2 and 19."""
    smi = start_alone()
    dp = check_data_parallel(smi[0] if smi else "nvidia-smi: none")
    print(json.dumps({"data_parallel": dp}))
    print(json.dumps({"data_parallel_ok": True,
                      "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--k4-bwd"]:
        main_k4_bwd(sys.argv[2:])
    elif sys.argv[1:2] == ["--data-parallel"]:
        main_data_parallel()
    elif sys.argv[1:2] == ["--pcwnet"]:
        main_pcwnet()
    elif sys.argv[1:2] == ["--iterative"]:
        main_iterative()
    elif sys.argv[1:2] == ["--selective"]:
        main_selective()
    else:
        main()
