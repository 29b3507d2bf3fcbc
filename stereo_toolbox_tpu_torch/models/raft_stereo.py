"""RAFT-Stereo's blocks that DEFOMStereo reuses (PyTorch).

Counterpart of ``_norm``, ``RAFTResBlock``, ``BasicMotionEncoder`` and
``BasicMultiUpdateBlock`` in ``stereo_toolbox_tpu/models/raft_stereo.py``,
channels-last like them, with the original toolbox's module names
(``conv1``, ``norm1``, ``downsample.{0,1}``; ``convc1``, ``convc2``,
``convd1``, ``convd2``, ``conv``; ``gru08/16/32``, ``disp_head``, ``mask``).
RAFTStereo itself is not ported yet.

Both norms are the JAX package's in train and eval alike: instance norm is
flax's ``GroupNorm(group_size=1)`` with no scale and no bias, and batch norm
is frozen (``use_running_average=True``, the reference's ``freeze_bn``): it
normalises with its running statistics, which no step updates.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.nn.gru import ConvGRU, conv_nhwc, pool2x
from stereo_toolbox_tpu_torch.ops.upsample import interpolate

NORM_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _wide(x: torch.Tensor) -> torch.Tensor:
    """`x` in at least float32 (flax's float32 reductions)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class InstanceNorm(nn.Module):
    """flax ``GroupNorm(group_size=1, use_scale=False, use_bias=False)`` on
    a channels-last ``[B, H, W, C]`` tensor: each channel's mean and
    ``E[x²] − E[x]²`` over H, W in float32, the output in x's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = _wide(x)
        mu = xf.mean(dim=(1, 2), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(1, 2), keepdim=True) - mu * mu,
                          min=0.0)
        return ((xf - mu) * torch.rsqrt(var + NORM_EPS)).to(x.dtype)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """flax ``BatchNorm(use_running_average=True)`` on a channels-last
    tensor, in train mode too: ``(x − mean) · (rsqrt(var + eps) · weight) +
    bias`` in float32 from the running statistics, the output in x's type.
    Its parameters train; its running statistics stay as loaded."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((_wide(x) - self.running_mean) * mul + self.bias).to(x.dtype)


def make_norm(kind: str, planes: int) -> nn.Module:
    """``"instance"`` or ``"batch"`` (frozen), as the JAX `_norm`."""
    if kind == "instance":
        return InstanceNorm()
    if kind == "batch":
        return FrozenBatchNorm2d(planes)
    raise ValueError(f"unknown norm {kind!r}")


class RAFTResBlock(nn.Module):
    """Residual block: 3×3 conv (stride `stride`, symmetric padding 1),
    norm, ReLU, 3×3 conv, norm, ReLU; a 1×1 strided conv and norm on the
    skip where the stride or the width changes; ReLU of the sum."""

    def __init__(self, in_planes: int, planes: int, norm: str = "instance",
                 stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.norm1 = make_norm(norm, planes)
        self.norm2 = make_norm(norm, planes)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_planes, planes, 1, stride), make_norm(norm, planes))
            if stride != 1 or in_planes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(conv_nhwc(self.conv1, x)))
        y = F.relu(self.norm2(conv_nhwc(self.conv2, y)))
        if self.downsample is not None:
            x = self.downsample[1](conv_nhwc(self.downsample[0], x))
        return F.relu(x + y)


class BasicMotionEncoder(nn.Module):
    """Correlation and flow → 128 motion features: the last conv emits
    ``128 − flow_channels``, concatenated with the raw flow."""

    def __init__(self, cor_planes: int, flow_channels: int = 1):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        self.convd1 = nn.Conv2d(flow_channels, 64, 7, padding=3)
        self.convd2 = nn.Conv2d(64, 64, 3, padding=1)
        self.conv = nn.Conv2d(128, 128 - flow_channels, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(conv_nhwc(self.convc2, F.relu(conv_nhwc(self.convc1,
                                                           corr))))
        f = F.relu(conv_nhwc(self.convd2, F.relu(conv_nhwc(self.convd1,
                                                           flow))))
        out = F.relu(conv_nhwc(self.conv, torch.cat([c, f], dim=-1)))
        return torch.cat([out, flow], dim=-1)


class DispHead(nn.Module):
    """3×3 conv to 256, ReLU, 3×3 conv to the flow's channels."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256,
                 output_dim: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, output_dim, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_nhwc(self.conv2, F.relu(conv_nhwc(self.conv1, x)))


class BasicMultiUpdateBlock(nn.Module):
    """Three ConvGRUs (1/16 → 1/8 → 1/4 of the 1/4 grid's scales: ``gru32``,
    ``gru16``, ``gru08``), the motion encoder, the flow head and the convex
    upsampling mask (× 0.25), for ``n_gru_layers = 3``."""

    def __init__(self, cor_planes: int,
                 hidden_dims: Sequence[int] = (128, 128, 128),
                 factor: int = 4, flow_channels: int = 1):
        super().__init__()
        h32, h16, h08 = hidden_dims
        self.encoder = BasicMotionEncoder(cor_planes, flow_channels)
        self.gru08 = ConvGRU(h08, 128 + h16)
        self.gru16 = ConvGRU(h16, h32 + h08)
        self.gru32 = ConvGRU(h32, h16)
        self.disp_head = DispHead(h08, 256, flow_channels)
        self.mask = nn.Sequential(nn.Conv2d(h08, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, factor * factor * 9, 1))

    def forward(self, nets, contexts, corr, flow):
        """``(net08, net16, net32)``, their contexts, the lookup and the
        flow → the new nets, the mask logits and the flow's delta."""
        net08, net16, net32 = nets
        ctx08, ctx16, ctx32 = contexts
        net32 = self.gru32(net32, pool2x(net16), ctx32)
        net16 = self.gru16(net16, torch.cat([
            pool2x(net08),
            interpolate(net32, net16.shape[1:3], (1, 2), True)], dim=-1),
            ctx16)
        motion = self.encoder(flow, corr)
        net08 = self.gru08(net08, torch.cat([
            motion, interpolate(net16, net08.shape[1:3], (1, 2), True)],
            dim=-1), ctx08)
        delta = self.disp_head(net08)
        m = F.relu(conv_nhwc(self.mask[0], net08))
        mask = 0.25 * conv_nhwc(self.mask[2], m)
        return (net08, net16, net32), mask, delta


__all__ = ["BasicMotionEncoder", "BasicMultiUpdateBlock", "DispHead",
           "FrozenBatchNorm2d", "IMAGENET_MEAN", "IMAGENET_STD",
           "InstanceNorm", "RAFTResBlock", "make_norm"]
