"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --k4-bwd [--parent DIR]

The second form studies K4's backward kernel alone (`main_k4_bwd`). The
first runs these phases, each of which raises on failure (exit code != 0,
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
   launch shape, vits' and MonSter's two-view shapes and ragged N (1, 15,
   64, 65, 77, 200, 1025, 2048), bfloat16 on its design "mma", float32 on
   "tf32x3" (each float32 launch twice for the same bits);
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
    PSMNet: no kernel of the port); then 12 steps on one fixed 256x512, B 2
    batch (lr 1e-3, clip 1.0) whose losses must be finite and fall below
    0.9 x the first; each backward kernel timed at its train launches
    beside its plain version and ``torch.autograd`` of the plain forward
    (K4-bwd and K5-bwd also their list builds alone);
15. probe cuDNN's float32 conv at the two trunk shapes where its algorithm
    choice takes most of CFNet's f32 forward;
16. print one ``{"forward": {...}}``, one ``{"train": {...}}`` and one
    ``{"kernels": [...]}`` line;
17. print ``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is false; this script "
             "needs an NVIDIA GPU")

from stereo_toolbox_tpu_torch import nn as port_nn  # noqa: E402
from stereo_toolbox_tpu_torch.datasets import (  # noqa: E402
    DataLoader, SyntheticStereoDataset)
from stereo_toolbox_tpu_torch.models import create_model  # noqa: E402
from stereo_toolbox_tpu_torch.nn.layers import ConvBNAct  # noqa: E402
from stereo_toolbox_tpu_torch.ops import _cuda  # noqa: E402
from stereo_toolbox_tpu_torch.ops.attention import (  # noqa: E402
    attention, attention_reference)
from stereo_toolbox_tpu_torch.ops.conv3d import (  # noqa: E402
    conv3d, conv3d_reference)
from stereo_toolbox_tpu_torch.ops.conv3d_fused import (  # noqa: E402
    PackedConv3dWeight, conv3d_fused, conv3d_fused_reference,
    pack_conv3d_weight)
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
# Train steps at the original's crop 256x512, B 4, and at the card-vs-CPU
# check's 64x128, B 2, max_disp 192, float32. A step launches each volume
# kernel of the forward once and its backward kernel once; PSMNet launches
# no kernel of the port in a train step (every conv on cuDNN, its first 3D
# layer never builds the volume), and no train step launches K2, K3 or K7
# (JAX's train path reaches no Pallas kernel: convs on cuDNN)
TRAIN_MODELS = ("PSMNet", "GwcNet_G", "GwcNet_GC", "ACVNet", "CFNet")
TRAIN_H, TRAIN_W, TRAIN_B = 256, 512, 4
TRAIN_CHECK_H, TRAIN_CHECK_W, TRAIN_CHECK_B = 64, 128, 2
OVERFIT_B, OVERFIT_STEPS = 2, 12
TRAIN_STEPS, TRAIN_WARMUP = 5, 1
# CFNet's nine heads take the sequence loss (the multi-head weights are
# four), as JAX's own CFNet gradient check does
TRAIN_LOSS = {"CFNet": "sequence"}


def train_mix(name, b, h, w) -> dict:
    """The launches by tag and shape of one train step of `name` on a
    ``[b, h, w, 3]`` batch (shapes keyed as the wrappers count them)."""
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
    return {**fwd, **{f"{tag}-bwd": mix for tag, mix in fwd.items()}}


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
GAP = "between forwards (host)"
FWD_ITERS, FWD_WARMUP = 10, 3
TRACE_ITERS = 3        # forwards in the torch.profiler trace

# The design each type's K2 and K7 launches must run, and the one design
# every K1, (Co = 1) K3, K4, K5 and K6 launch of a forward must run in both
# types
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
           "K5-bwd": {F32: 1e-5, BF16: 1e-2}}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def trace(fn, iters: int, grad: bool = False) -> tuple[dict, dict]:
    """Device ms and launches per call of each kernel that `fn` launches
    (the forward's kernel families), and host ms and calls per call of each
    operator, from a ``torch.profiler`` trace of `iters` calls (with
    autograd off unless `grad`)."""
    from torch.profiler import ProfilerActivity, profile
    with torch.set_grad_enabled(grad):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
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
    at."""
    return {key for mixes in (MIXES, TRAIN_MIXES, TRAIN_CHECK_MIXES)
            for mix in mixes.values() for key in mix.get(tag, {})}


# ---------------------------------------------------------------- phase 3
def check_gwc(gen) -> dict:
    errs = {}
    model_cases = all_shapes("K1")
    # W not a multiple of the tile, W < D, C/G = 3, B = 2; odd G (one group
    # a bf16 thread); a row of 6 channels (plain staging, no 16-byte copies)
    cases = [*sorted(model_cases), (2, 5, 37, 48, 48, 16),
             (1, 3, 21, 24, 9, 3), (1, 4, 70, 320, 48, 40),
             (1, 2, 9, 6, 13, 6)]
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


def check_conv(gen) -> dict:
    """Every launch shape of both forwards, each of their volume shapes
    also with both epilogue options on and off, and a ragged case."""
    errs = {}
    model_cases = all_shapes("K2")
    cases = dict.fromkeys(sorted(model_cases))
    for key in sorted(model_cases):
        for res, relu in ((False, False), (True, True)):
            cases[key[:6] + (res, relu)] = None
    # ragged: Ci not a multiple of 16 (1, 3, 12, 33, 65; all but 40 also
    # not of 8, where the halo goes through plain loads), Co 8, 33 and 40
    # (ragged channel tiles, scalar stores at 33), odd H and W, D 1 and 2
    for ragged in ((2, 5, 7, 19, 12, 40, True, True),
                   (1, 3, 7, 19, 1, 8, False, True),
                   (2, 2, 9, 35, 3, 33, True, True),
                   (1, 1, 5, 7, 33, 8, True, False),
                   (1, 2, 11, 13, 65, 33, False, False)):
        cases[ragged] = None
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


def check_conv3d(gen) -> dict:
    """K3 at every launch shape of the stereo forwards and ragged cases:
    Co 8 and 33 (the second tile ragged), odd H and W, D < 3, Ci not a
    multiple of the staged chunk, B = 2."""
    errs = {}
    model_cases = all_shapes("K3")
    cases = [*sorted(model_cases), (2, 5, 7, 37, 32, 1), (1, 2, 9, 33, 32, 1),
             (1, 1, 5, 7, 16, 1), (2, 3, 7, 19, 12, 8), (1, 4, 9, 35, 32, 33),
             (1, 3, 17, 30, 5, 1), (1, 2, 11, 9, 5, 1)]
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


def check_concat(gen) -> dict:
    """K6 on its "rows" design at the stereo models' launch shapes (masked:
    CFNet, GwcNet_GC; unmasked: ACVNet) and ragged cases, with the left half
    masked and not: D > W (zero planes, or zero right halves unmasked), odd
    C (rows of 8- and 4-byte stores: W x C odd in bfloat16), bfloat16 C = 12
    (24-byte halves, vectors that straddle them), a row past the plan's
    shared memory (W tiles); and feature bases one element past 16-byte
    alignment (narrow staging)."""
    errs = {}
    model_cases = all_shapes("K6")
    cases = [*sorted(model_cases)]
    for ragged in ((2, 3, 37, 12, 45), (1, 2, 9, 5, 4), (1, 2, 10, 32, 14),
                   (1, 3, 11, 3, 7), (1, 4, 160, 12, 48), (1, 2, 20, 700, 3)):
        cases += [(*ragged, True), (*ragged, False)]
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
def check_attention(gen) -> dict:
    """K7 at DepthAnythingV2-vitl's launch shape, vits' (6 heads), MonSter's
    two views at 420x560 (N = 1201) and ragged N (1, 77, 1025), at the ViT's
    scale 1/8; and logits of ~±30 (scale 1), where a wrong running max
    shows."""
    errs = {}
    cases = [(*key[:3], 0.125) for key in DAV2_K7_MIX]
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
        self.grads = [g.detach().float().cpu() for g in grads]


def bn_buffers(model) -> dict:
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


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
    cpu = create_model(name, max_disp=MAX_DISP, device="cpu")
    cpu.load_state_dict(model.state_dict())
    batch = next(iter(synthetic_loader(TRAIN_CHECK_H, TRAIN_CHECK_W,
                                       TRAIN_CHECK_B, 1, seed=5, workers=0)))
    got, samples = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for m, dev in ((cpu, "cpu"), (model, DEV)):
            rec = GradRecorder()
            caught = samples[dev] = []
            hooks = [m.get_submodule(stage).register_forward_pre_hook(
                lambda mod, args: caught.append(args[2].detach().cpu()))
                for stage in ("volume_s3", "volume_s2") if name == "CFNet"]
            reset_counts()
            _, loss = make_train_step(m, train_config(name))(
                TrainState(m, rec), to_device(batch, dev))
            for hk in hooks:
                hk.remove()
            got[dev] = (loss.item(), rec.grads, bn_buffers(m))
    finally:
        torch.backends.cudnn.deterministic = False
    (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = got["cpu"], got[DEV]
    want = TRAIN_CHECK_MIXES[name]
    for tag, (fn, *_) in KERNELS.items():
        require(Counter(fn.shapes) == Counter(want.get(tag, {})),
                f"{name} card train step {tag} launches {dict(fn.shapes)}, "
                f"not {want.get(tag, {})}")
    loss_rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    num = sum(((a - b) ** 2).sum().item() for a, b in zip(g_gpu, g_cpu))
    den = sum((b ** 2).sum().item() for b in g_cpu)
    grad_l2 = (num / den) ** 0.5
    leaf = max((a - b).abs().max().item() / b.abs().max().item()
               for a, b in zip(g_gpu, g_cpu) if b.abs().max() > 0)
    stats = 0.0
    for k, v in s_cpu.items():
        if k.endswith("running_mean"):
            var = s_cpu[k.replace("running_mean", "running_var")]
            stats = max(stats, ((s_gpu[k] - v).abs() / var.sqrt()).max()
                        .item())
        else:
            stats = max(stats, ((s_gpu[k] - v).abs() / v).max().item())
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


def train_full_size(name) -> tuple[dict, dict]:
    """make_train_step at 256x512, B 4, on batches of the port's
    DataLoader (moved from pinned memory): TRAIN_WARMUP warm steps, then
    TRAIN_STEPS timed ones (host clock around the step and a synchronize),
    each step's launches by shape required to be TRAIN_MIXES[name]; the
    peak memory of the timed steps."""
    model = create_model(name, max_disp=MAX_DISP,
                         generator=torch.Generator().manual_seed(0))
    loader = synthetic_loader(TRAIN_H, TRAIN_W, TRAIN_B,
                              TRAIN_WARMUP + TRAIN_STEPS, seed=6)
    config = train_config(name)
    state = init_train_state(model, config, len(loader))
    step = make_train_step(model, config)
    want = {tag: Counter(TRAIN_MIXES[name].get(tag, {})) for tag in KERNELS}
    times, losses = [], []
    for i, batch in enumerate(loader):
        batch = to_device(batch, DEV)
        torch.cuda.synchronize()
        if i == TRAIN_WARMUP:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        shapes = {tag: Counter(fn.shapes) for tag, (fn, *_) in
                  KERNELS.items()}
        require(shapes == want, f"{name} train step {i} launches by shape "
                                f"{shapes} differ from {want}")
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    designs = {tag: designs_of(tag) for tag in TRAIN_MIXES[name]}
    require(all(np.isfinite(losses)), f"{name} train losses {losses}")
    # device time by kernel family of one more step (forward, backward and
    # optimizer), from a torch.profiler trace
    families: dict = defaultdict(float)
    kernels, _ = trace(lambda: step(state, batch), 1, grad=True)
    for key, (ms, _) in kernels.items():
        families[kernel_family(key)] += ms
    timed = sorted(times[TRAIN_WARMUP:])
    row = {"shape": [TRAIN_B, TRAIN_H, TRAIN_W, 3], "max_disp": MAX_DISP,
           "warmup": TRAIN_WARMUP, "steps": TRAIN_STEPS,
           "step_ms_median": timed[len(timed) // 2], "step_ms": times,
           "peak_mib": peak / 2**20, "losses": losses,
           "launches_per_step": {tag: {str(k): n for k, n in c.items()}
                                 for tag, c in want.items() if c},
           "designs_last_step": designs,
           "traced_step_families_ms": dict(families) or None,
           "traced_step_launches": sum(n for _, n in kernels.values())}
    print(f"  {name} train {TRAIN_H}x{TRAIN_W} B {TRAIN_B} f32: median step "
          f"{row['step_ms_median']:.1f} ms over {TRAIN_STEPS} (all "
          + ", ".join(f"{t:.1f}" for t in times) + f" ms), peak "
          f"{row['peak_mib']:.1f} MiB, losses "
          + ", ".join(f"{v:.3f}" for v in losses) + "; launches a step: "
          + (", ".join(f"{tag} {dict(c)}" for tag, c in want.items() if c)
             or "none"))
    if families:
        busy = sum(families.values())
        print(f"    traced step: device busy {busy:.1f} ms in "
              f"{row['traced_step_launches']:g} launches")
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


def train_overfit(name) -> dict:
    """OVERFIT_STEPS steps on one fixed 256x512 batch of OVERFIT_B with the
    configuration of the JAX package's overfit test (lr 1e-3, the multi-head
    loss (CFNet: the sequence loss), clip 1.0, 30 scheduled steps): every
    loss finite and the last below 0.9 x the first."""
    model = create_model(name, max_disp=MAX_DISP,
                         generator=torch.Generator().manual_seed(0))
    config = train_config(name, lr=1e-3, clip_grad=1.0)
    state = init_train_state(model, config, 30)
    step = make_train_step(model, config)
    batch = to_device(next(iter(synthetic_loader(
        TRAIN_H, TRAIN_W, OVERFIT_B, 1, seed=7, workers=0))), DEV)
    losses = []
    for _ in range(OVERFIT_STEPS):
        state, loss = step(state, batch)
        losses.append(loss.item())
    print(f"  {name} overfit {TRAIN_H}x{TRAIN_W} B {OVERFIT_B}: losses "
          + ", ".join(f"{v:.3f}" for v in losses))
    require(all(np.isfinite(losses)) and losses[-1] < 0.9 * losses[0],
            f"{name} overfit losses {losses}")
    del state, step, model
    return {"shape": [OVERFIT_B, TRAIN_H, TRAIN_W, 3], "losses": losses}


def check_training(name) -> tuple[dict, dict]:
    """Phase 14 for `name`: card vs CPU, the full-size steps, the overfit.
    Returns the train line's row and the launches a full-size step made."""
    t0 = time.perf_counter()
    row = {"card_vs_cpu": train_card_vs_cpu(name)}
    row["full_size"], mix = train_full_size(name)
    torch.cuda.empty_cache()
    row["overfit"] = train_overfit(name)
    torch.cuda.empty_cache()
    row["seconds"] = time.perf_counter() - t0
    print(f"  {name} training phase: {row['seconds']:.1f} s")
    return row, mix


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
                      ("vit_attention_mma_kernel", "K7 vit attention"),
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


def profile_forward(name, model, inputs, dtype) -> dict:
    fwd = forward_breakdown(name, model, *inputs)
    kernels, host_ops = trace(lambda: model(*inputs), TRACE_ITERS)
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
          f"in {fwd['host_enqueue_ms']:.3f} ms")
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
          "K5-bwd": time_gwc_samples_backward}
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


def main() -> None:
    t_start = time.perf_counter()
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
    print("phase 3: K1 gwc_volume kernel and its backward vs plain")
    errs["K1"] = check_gwc(gen)
    errs["K1-bwd"] = check_gwc_backward(gen)
    print("phase 4: K2 conv3d_fused kernel vs plain")
    errs["K2"] = check_conv(gen)
    print("phase 5: K3 conv3d kernel vs plain")
    errs["K3"] = check_conv3d(gen)
    print("phase 6: K4, K5 sample kernels and K6 concat volume, and their "
          "backward kernels, vs plain")
    errs["K4"], errs["K5"] = check_samples(gen)
    errs["K6"] = check_concat(gen)
    errs["K6-bwd"] = check_concat_backward(gen)
    errs["K4-bwd"], errs["K5-bwd"] = check_samples_backward(gen)
    print("phase 7: K7 vit_attention kernel vs plain")
    errs["K7"] = check_attention(gen)
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

    print(f"phase 14: training ({time.perf_counter() - t_start:.1f} s)")
    train = {}
    for model_name in TRAIN_MODELS:
        train[model_name], mix = check_training(model_name)
        designs = train[model_name]["full_size"]["designs_last_step"]
        for tag in BACKWARD_TAGS:
            if not mix.get(tag):
                continue
            entry = time_kernel(f"{model_name} (train step)", tag, F32,
                                mix[tag], designs, errs[tag][F32], gen)
            entry["autograd_ms"] = sum(r["autograd_ms"] * r["launches"]
                                       for r in entry["shapes"])
            if "build_ms" in entry["shapes"][0]:
                entry["build_ms"] = build_ms(entry["shapes"])
                print(f"  {model_name} (train step) {tag} float32 list build "
                      f"alone {entry['build_ms']:.4f} ms")
            kernels.append(entry)
            # the same launches in bfloat16 (their plans, times and bounds;
            # no train step runs bfloat16 yet)
            ms, _, _, nbytes, flops, shapes = TIMERS[tag](mix[tag], BF16,
                                                          gen)
            b_ms, b_by = bound(nbytes, flops, BF16)
            built = (f", list build alone {build_ms(shapes):.4f} ms"
                     if "build_ms" in shapes[0] else "")
            print(f"  {model_name} (train step) {tag} bfloat16: {ms:.4f} ms "
                  f"(bound {b_ms:.4f} by {b_by}, {100 * b_ms / ms:.1f}% of "
                  f"it{built})")
            train[model_name][f"{tag}_bf16"] = {
                "ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                "mbytes": nbytes / 1e6, "shapes": shapes}
            if built:
                train[model_name][f"{tag}_bf16"]["build_ms"] = build_ms(shapes)
        torch.cuda.empty_cache()
    print("phase 15: cuDNN float32 probe")
    forward["CFNet"]["cudnn_f32_probe"] = cudnn_probe(gen)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"forward": forward}))
    print(json.dumps({"train": train}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--k4-bwd"]:
        main_k4_bwd(sys.argv[2:])
    else:
        main()
