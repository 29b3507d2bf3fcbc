"""Selective-Stereo (CVPR'24): SelectiveRAFT and SelectiveIGEV (PyTorch).

Counterpart of ``stereo_toolbox_tpu/models/selective.py``, channels-last
like it, with the original toolbox's module names (``cam.fc.{0,2}``,
``sam.samconv``, ``update_block.gru04/08/16.{small,large}_gru.conv{z,r,q}``,
``encoder``, ``disp_head``, ``mask`` / ``mask_feat_4``):

  * `ChannelAttentionEnhancement` (CAM) and `SpatialAttentionExtractor`
    (SAM), one of each shared by the context network's three scales:
    ``inp = cam(relu(c)) · relu(c)``, ``att = sam(inp)``, the state
    ``tanh(h)`` (`cam_sam_context`); they take the place of
    ``context_zqr_convs``, and the GRUs take the context as an input, with
    no gate biases;
  * `SelectiveConvGRU`: a 1×1 and a 3×3 GRU (`nn.gru.ConvGRU`) blended per
    pixel, ``small · att + large · (1 − att)``;
  * `SelectiveUpdateBlock`: the three scales' SelectiveConvGRUs (the
    coarser ones only where they run), the motion encoder
    (`raft_stereo.BasicMotionEncoder`, one disparity channel: SelectiveRAFT
    names its convs ``convf``, SelectiveIGEV ``convd``), the disparity head
    and RAFT's convex mask (``'convex'``) or IGEV's superpixel features
    (``'superpixel'``), each × 0.25;
  * `SelectiveRAFT`: `RAFTStereo`'s encoders, correlation (``'banded'`` or
    ``'reg'``) and loop, carrying the one-channel signed offset and
    upsampling its negation;
  * `SelectiveIGEV`: `IGEVStereo`'s geometry (K1 once, at D = max_disp / 4
    and 8 groups, on the card), lookups, loop and superpixel upsampling.

Both evaluate (the last of `valid_iters` iterations, ``[B, H, W]`` float32
disparity); train mode is not ported yet (ROADMAP.md, Queue 1 item 5) and
raises. In bfloat16 the context, its attention and the GRU blends are
bfloat16; the carried disparity, the lookup positions, the softmaxes and the
upsampling float32, as in JAX. Seeded random weights are drawn as flax draws
them (`nn.layers.lecun_init`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.models.igev_stereo import IGEVStereo
from stereo_toolbox_tpu_torch.models.raft_stereo import (BasicMotionEncoder,
                                                         DispHead, RAFTStereo)
from stereo_toolbox_tpu_torch.nn.gru import ConvGRU, conv_nhwc, pool2x
from stereo_toolbox_tpu_torch.ops.upsample import interpolate


class ChannelAttentionEnhancement(nn.Module):
    """CAM: ``sigmoid(fc(mean) + fc(max))`` over the spatial axes, ``fc``
    two bias-free 1×1 convs (``fc.0``, ``fc.2``) around a ReLU, the middle
    width ``in_planes // ratio``. ``[B, H, W, C] → [B, 1, 1, C]``."""

    def __init__(self, in_planes: int = 128, ratio: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Conv2d(in_planes, in_planes // ratio, 1, bias=False),
            nn.ReLU(), nn.Conv2d(in_planes // ratio, in_planes, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def fc(v):
            return conv_nhwc(self.fc[2], F.relu(conv_nhwc(self.fc[0], v)))
        return torch.sigmoid(fc(x.mean(dim=(1, 2), keepdim=True))
                             + fc(x.amax(dim=(1, 2), keepdim=True)))


class SpatialAttentionExtractor(nn.Module):
    """SAM: ``sigmoid(samconv([mean_c, max_c]))``, a bias-free k×k conv
    (SAME padding) over the channel mean and max. ``[B, H, W, C] → [B, H,
    W, 1]``."""

    def __init__(self, kernel_size: int = 7):
        super().__init__()
        self.samconv = nn.Conv2d(2, 1, kernel_size, padding=kernel_size // 2,
                                 bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.cat([x.mean(dim=-1, keepdim=True),
                       x.amax(dim=-1, keepdim=True)], dim=-1)
        return torch.sigmoid(conv_nhwc(self.samconv, h))


class SelectiveConvGRU(nn.Module):
    """``small_gru`` (1×1 gates) and ``large_gru`` (3×3) on the same state
    and input, blended per pixel by the attention map: ``small · att +
    large · (1 − att)``."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        self.small_gru = ConvGRU(hidden_dim, input_dim, 1)
        self.large_gru = ConvGRU(hidden_dim, input_dim, 3)

    def forward(self, att: torch.Tensor, h: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
        return (self.small_gru(h, x) * att
                + self.large_gru(h, x) * (1 - att))


HEADS = ("convex", "superpixel")


class SelectiveUpdateBlock(nn.Module):
    """`n_gru_layers` SelectiveConvGRUs (``gru16``, ``gru08``, ``gru04``,
    coarse to fine; the coarser ones only where they run, as JAX creates
    them), each taking its scale's context beside the nets; the motion
    encoder (127 channels beside the disparity; its disparity convs
    ``{flow_convs}1``/``2``), the disparity head and `head`'s output:
    ``'convex'`` the upsampling mask (``mask``: 3×3 to 256, ReLU, 1×1 to
    9 · factor², × 0.25), ``'superpixel'`` the mask features
    (``mask_feat_4``: 3×3 to 32, ReLU, × 0.25). The context widths equal
    `hidden_dims` (the context network's)."""

    def __init__(self, cor_planes: int,
                 hidden_dims: Sequence[int] = (128, 128, 128),
                 n_gru_layers: int = 3, head: str = "superpixel",
                 factor: int = 4, flow_convs: str = "convd"):
        super().__init__()
        if n_gru_layers not in (1, 2, 3):
            raise ValueError(f"n_gru_layers {n_gru_layers} is not 1, 2 or 3")
        if head not in HEADS:
            raise ValueError(f"head {head!r} is not one of {HEADS}")
        h16, h08, h04 = hidden_dims
        self.n_gru_layers, self.head = n_gru_layers, head
        self.encoder = BasicMotionEncoder(cor_planes, 1, flow_convs)
        self.gru04 = SelectiveConvGRU(
            h04, h04 + 128 + (h08 if n_gru_layers > 1 else 0))
        if n_gru_layers > 1:
            self.gru08 = SelectiveConvGRU(
                h08, h08 + h04 + (h16 if n_gru_layers > 2 else 0))
        if n_gru_layers > 2:
            self.gru16 = SelectiveConvGRU(h16, h16 + h08)
        self.disp_head = DispHead(h04, 256, 1)
        if head == "convex":
            self.mask = nn.Sequential(nn.Conv2d(h04, 256, 3, padding=1),
                                      nn.ReLU(inplace=True),
                                      nn.Conv2d(256, factor * factor * 9, 1))
        else:
            self.mask_feat_4 = nn.Sequential(
                nn.Conv2d(h04, 32, 3, padding=1), nn.ReLU(inplace=True))

    def forward(self, nets, context, corr, disp):
        """``(net04, net08, net16)``, the context ``(inps, atts)`` (each
        fine to coarse), the lookup and the ``[B, h, w, 1]`` disparity →
        the new nets, the head's output and the disparity's delta."""
        net04, net08, net16 = nets
        (inp04, inp08, inp16), (att04, att08, att16) = context
        n = self.n_gru_layers
        if n == 3:
            net16 = self.gru16(att16, net16,
                               torch.cat([inp16, pool2x(net08)], dim=-1))
        if n >= 2:
            x08 = [inp08, pool2x(net04)]
            if n == 3:
                x08.append(interpolate(net16, net08.shape[1:3], (1, 2), True))
            net08 = self.gru08(att08, net08, torch.cat(x08, dim=-1))
        x04 = [inp04, self.encoder(disp, corr)]
        if n > 1:
            x04.append(interpolate(net08, net04.shape[1:3], (1, 2), True))
        net04 = self.gru04(att04, net04, torch.cat(x04, dim=-1))
        delta = self.disp_head(net04)
        if self.head == "convex":
            out = 0.25 * conv_nhwc(self.mask[2],
                                   F.relu(conv_nhwc(self.mask[0], net04)))
        else:
            out = 0.25 * F.relu(conv_nhwc(self.mask_feat_4[0], net04))
        return (net04, net08, net16), out, delta


def cam_sam_context(cam: ChannelAttentionEnhancement,
                    sam: SpatialAttentionExtractor, cnet_out) -> tuple:
    """The context network's ``[(h, c), ...]`` → ``(inps, atts)``: each
    scale's ``inp = cam(relu(c)) · relu(c)`` and ``att = sam(inp)``, one
    `cam` and one `sam` for every scale."""
    inps, atts = [], []
    for _, c in cnet_out:
        i = F.relu(c)
        i = cam(i) * i
        inps.append(i)
        atts.append(sam(i))
    return tuple(inps), tuple(atts)


def _one_width(hidden_dims: Sequence[int]) -> int:
    """The context width the shared CAM takes: every scale's."""
    if len(set(hidden_dims)) != 1:
        raise ValueError(f"hidden_dims {tuple(hidden_dims)}: one CAM serves "
                         f"every scale, so they must be equal")
    return hidden_dims[0]


class SelectiveRAFT(RAFTStereo):
    """The JAX package's fields with its defaults (`RAFTStereo`'s: hidden
    dims 128×3, 4 correlation levels of radius 4, 3 GRU layers, 32 eval
    iterations, ``corr_impl='banded'`` reaching ``band_max_disp`` 192 +
    ``band_margin`` 32 full-resolution pixels, or ``'reg'``), CAM/SAM and
    `SelectiveUpdateBlock` (``'convex'``, ``convf``) in place of
    ``context_zqr_convs`` and RAFT's update block. Its output is the convex
    upsample of the negated one-channel signed offset.
    ``forward(left, right, iters=None)``."""

    flow_channels = 1
    corr_impls = ("banded", "reg")

    def context_heads(self, cor_planes: int, n_gru_layers: int) -> None:
        self.cam = ChannelAttentionEnhancement(_one_width(self.hidden_dims))
        self.sam = SpatialAttentionExtractor()
        self.update_block = SelectiveUpdateBlock(
            cor_planes, self.hidden_dims, n_gru_layers, "convex",
            self.factor, "convf")

    def context(self, cnet_out) -> tuple:
        return cam_sam_context(self.cam, self.sam, cnet_out)


class SelectiveIGEV(IGEVStereo):
    """The JAX package's fields with its defaults (`IGEVStereo`'s: hidden
    dims 128×3, max_disp 192, 2 correlation levels of radius 4, 3 GRU
    layers, 32 eval iterations, ``corr_impl='banded'`` with
    ``band_margin`` 32, or ``'reg'``), CAM/SAM and `SelectiveUpdateBlock`
    (``'superpixel'``, ``convd``) in place of ``context_zqr_convs`` and
    IGEV's update block; the train-only ``spx_4``, ``spx_2`` and ``spx``
    registered. ``forward(left, right, iters=None)``."""

    def context_heads(self, hidden_dims: tuple, cor_planes: int,
                      n_gru_layers: int) -> None:
        self.cam = ChannelAttentionEnhancement(_one_width(hidden_dims))
        self.sam = SpatialAttentionExtractor()
        self.update_block = SelectiveUpdateBlock(cor_planes, hidden_dims,
                                                 n_gru_layers, "superpixel")

    def context(self, cnet_out) -> tuple:
        return cam_sam_context(self.cam, self.sam, cnet_out)


__all__ = ["ChannelAttentionEnhancement", "SelectiveConvGRU",
           "SelectiveIGEV", "SelectiveRAFT", "SelectiveUpdateBlock",
           "SpatialAttentionExtractor", "cam_sam_context"]
