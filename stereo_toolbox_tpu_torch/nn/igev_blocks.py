"""The IGEV family's shared blocks (PyTorch): LeakyReLU conv units, the
Conv2x fusion and the MobileNetV2 feature pyramid.

Counterpart of ``stereo_toolbox_tpu/nn/igev_blocks.py`` (`BasicConvBN`,
`BasicConvIN`, `Conv2x`, `InvertedResidual`, `MobileNetV2Trunk`,
`IGEVFeature`), channels-last like it, with the original toolbox's module
names (``conv``, ``bn``; ``conv1``, ``conv2``; timm's ``conv_stem``,
``bn1``, ``block0..4``, ``conv_pw``, ``conv_dw``, ``conv_pwl``,
``bn1..3``; ``deconv32_16``, ``deconv16_8``, ``deconv8_4``, ``conv4``).
Every conv runs on cuDNN, as JAX runs these as XLA convolutions: 2D or 3D
by the input's rank, transposed convs at kernel 4, stride 2, padding 1
(flax's ``'SAME'`` transposed conv at that kernel and stride). BatchNorm
normalises with its running statistics in eval mode; instance norm is
flax's ``GroupNorm(group_size=1)`` without scale or bias
(`nn.layers.InstanceNorm`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.nn.layers import (BN_EPS, BN_MOMENTUM,
                                                BatchNorm2d, BatchNorm3d,
                                                InstanceNorm, channels_first,
                                                channels_last)
from stereo_toolbox_tpu_torch.ops.upsample import resize_nearest

LEAKY_SLOPE = 0.01
_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_DECONV = {2: nn.ConvTranspose2d, 3: nn.ConvTranspose3d}
_BN = {2: BatchNorm2d, 3: BatchNorm3d}


def _conv(in_channels, out_channels, kernel_size, stride, deconv, dims,
          dilation=1, bias=False) -> nn.Module:
    """A bias-free conv (zero padding ``(k − 1) // 2 · dilation``) or a
    transposed conv at kernel 4, stride 2, padding 1 (output twice the
    input)."""
    if deconv:
        if (kernel_size, stride) != (4, 2):
            raise NotImplementedError("transposed convs run at kernel 4, "
                                      "stride 2 (flax 'SAME')")
        return _DECONV[dims](in_channels, out_channels, 4, 2, 1, bias=bias)
    return _CONV[dims](in_channels, out_channels, kernel_size, stride,
                       (kernel_size - 1) // 2 * dilation, dilation,
                       bias=bias)


class BasicConvBN(nn.Module):
    """conv or transposed conv (2D or 3D: `dims`), BatchNorm where `norm`,
    LeakyReLU(0.01) where `relu` (the original's ``BasicConv``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, deconv: bool = False,
                 norm: bool = True, relu: bool = True, dims: int = 2,
                 dilation: int = 1):
        super().__init__()
        self.relu = relu
        self.conv = _conv(in_channels, out_channels, kernel_size, stride,
                          deconv, dims, dilation)
        self.bn = (_BN[dims](out_channels, eps=BN_EPS, momentum=BN_MOMENTUM)
                   if norm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(channels_first(x.to(self.conv.weight.dtype)))
        if self.bn is not None:
            x = self.bn(x)
        if self.relu:
            x = F.leaky_relu(x, LEAKY_SLOPE)
        return channels_last(x)


class BasicConvIN(nn.Module):
    """2D conv or transposed conv, instance norm where `norm`,
    LeakyReLU(0.01) where `relu` (the original's ``BasicConv_IN``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, deconv: bool = False,
                 norm: bool = True, relu: bool = True):
        super().__init__()
        self.relu = relu
        self.conv = _conv(in_channels, out_channels, kernel_size, stride,
                          deconv, 2)
        self.IN = InstanceNorm() if norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = channels_last(self.conv(channels_first(
            x.to(self.conv.weight.dtype))))
        if self.IN is not None:
            x = self.IN(x)
        return F.leaky_relu(x, LEAKY_SLOPE) if self.relu else x


class Conv2x(nn.Module):
    """Up (transposed conv, kernel 4) or down (3×3) 2× of `x`, resized to
    the skip `rem`'s grid (nearest) where the two differ, fused with `rem`:
    concatenated (then ``2 · out_channels`` wide) or added, and a 3×3 conv
    (the original's ``Conv2x``; with `instance_norm` its ``Conv2x_IN``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 deconv: bool = False, concat: bool = True,
                 instance_norm: bool = False, norm: bool = True,
                 relu: bool = True):
        super().__init__()
        unit = BasicConvIN if instance_norm else BasicConvBN
        self.concat = concat
        self.conv1 = unit(in_channels, out_channels, 4 if deconv else 3, 2,
                          deconv)
        out = out_channels * 2 if concat else out_channels
        self.conv2 = unit(out, out, 3, 1, norm=norm, relu=relu)

    def forward(self, x: torch.Tensor, rem: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        if x.shape[1:-1] != rem.shape[1:-1]:
            x = resize_nearest(x, rem.shape[1:-1],
                               tuple(range(1, x.dim() - 1)))
        x = torch.cat([x, rem], dim=-1) if self.concat else x + rem
        return self.conv2(x)


def _relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)


def _bn2d(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


class InvertedResidual(nn.Module):
    """A MobileNetV2 unit, timm's names: with `expand` 1 its
    ``DepthwiseSeparableConv`` (``conv_dw``, ``bn1``, ReLU6, ``conv_pw``,
    ``bn2``), else ``conv_pw`` (1×1 to ``expand · C``), ``bn1``, ReLU6,
    ``conv_dw`` (3×3 depthwise, stride `stride`, padding 1), ``bn2``,
    ReLU6, ``conv_pwl`` (1×1), ``bn3``; plus the input where the stride is
    1 and the width is kept."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 expand: int = 6):
        super().__init__()
        self.expand = expand
        self.skip = stride == 1 and in_channels == out_channels
        hidden = in_channels * expand
        dw = nn.Conv2d(hidden, hidden, 3, stride, 1, groups=hidden,
                       bias=False)
        if expand == 1:
            self.conv_dw, self.bn1 = dw, _bn2d(hidden)
            self.conv_pw = nn.Conv2d(hidden, out_channels, 1, bias=False)
            self.bn2 = _bn2d(out_channels)
        else:
            self.conv_pw = nn.Conv2d(in_channels, hidden, 1, bias=False)
            self.bn1 = _bn2d(hidden)
            self.conv_dw, self.bn2 = dw, _bn2d(hidden)
            self.conv_pwl = nn.Conv2d(hidden, out_channels, 1, bias=False)
            self.bn3 = _bn2d(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-first in and out (the trunk stays channels-first)."""
        if self.expand == 1:
            h = self.bn2(self.conv_pw(_relu6(self.bn1(self.conv_dw(x)))))
        else:
            h = _relu6(self.bn1(self.conv_pw(x)))
            h = _relu6(self.bn2(self.conv_dw(h)))
            h = self.bn3(self.conv_pwl(h))
        return h + x if self.skip else h


# mobilenetv2_100's stages: (out channels, stride, expansion) a unit; the
# original groups them into block0..block4 (stages 3 and 4 are block3)
MOBILENET_STAGES = (((16, 1, 1),),
                    ((24, 2, 6), (24, 1, 6)),
                    ((32, 2, 6), (32, 1, 6), (32, 1, 6)),
                    ((64, 2, 6), (64, 1, 6), (64, 1, 6), (64, 1, 6)),
                    ((96, 1, 6), (96, 1, 6), (96, 1, 6)),
                    ((160, 2, 6), (160, 1, 6), (160, 1, 6)))
MOBILENET_BLOCKS = ((0,), (1,), (2,), (3, 4), (5,))


class MobileNetV2Trunk(nn.Module):
    """mobilenetv2_100's feature trunk (``conv_stem`` 3×3 stride 2, ``bn1``,
    ReLU6, then ``block0..4``): ``[B, H, W, 3]`` → the taps after each
    block, 16 / 24 / 32 / 96 / 160 channels at 1/2 … 1/32, channels-last."""

    def __init__(self):
        super().__init__()
        self.conv_stem = nn.Conv2d(3, 32, 3, 2, 1, bias=False)
        self.bn1 = _bn2d(32)
        c = 32
        for i, stages in enumerate(MOBILENET_BLOCKS):
            seqs = []
            for s in stages:
                units = []
                for out, stride, expand in MOBILENET_STAGES[s]:
                    units.append(InvertedResidual(c, out, stride, expand))
                    c = out
                seqs.append(nn.Sequential(*units))
            setattr(self, f"block{i}", nn.Sequential(*seqs))

    def taps(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = channels_first(x.to(self.conv_stem.weight.dtype))
        x = _relu6(self.bn1(self.conv_stem(x)))
        out = []
        for i in range(len(MOBILENET_BLOCKS)):
            x = getattr(self, f"block{i}")(x)
            out.append(channels_last(x))
        return out

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return self.taps(x)


class IGEVFeature(MobileNetV2Trunk):
    """The trunk and its deconv fusion (``deconv32_16``, ``deconv16_8``,
    ``deconv8_4``: `Conv2x` with instance norm; ``conv4``) → ``[x4 (48),
    x8 (64), x16 (192), x32 (160)]`` at 1/4 … 1/32 (the original's
    ``Feature``)."""

    def __init__(self):
        super().__init__()
        self.deconv32_16 = Conv2x(160, 96, True, instance_norm=True)
        self.deconv16_8 = Conv2x(192, 32, True, instance_norm=True)
        self.deconv8_4 = Conv2x(64, 24, True, instance_norm=True)
        self.conv4 = BasicConvIN(48, 48, 3, 1)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        _, x4, x8, x16, x32 = self.taps(x)
        x16 = self.deconv32_16(x32, x16)
        x8 = self.deconv16_8(x16, x8)
        x4 = self.conv4(self.deconv8_4(x8, x4))
        return [x4, x8, x16, x32]


__all__ = ["BasicConvBN", "BasicConvIN", "Conv2x", "IGEVFeature",
           "InvertedResidual", "LEAKY_SLOPE", "MobileNetV2Trunk"]
