"""Conv/BN blocks shared by the cost-volume models (PyTorch).

Counterpart of ``stereo_toolbox_tpu/nn/layers.py``. Every block takes and
returns channels-last tensors (``[B, H, W, C]`` or ``[B, D, H, W, C]``), as
the JAX blocks do; cuDNN sees the channels-first view of the same memory
(``movedim`` copies nothing). Submodules are numbered like the original
toolbox's ``convbn``/``convbn_3d`` Sequentials (``0`` = conv, ``1`` = BN), so
a model's ``state_dict`` carries the original PyTorch parameter names.

In eval mode a 3D 3×3×3, stride-1, undilated, padding-1 ConvBNAct folds its
BatchNorm into a per-channel affine and runs `ops.conv3d_fused` (the CUDA
kernel on the card): the same condition under which the JAX package takes
its fused lowering.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.ops.conv3d_fused import conv3d_fused

BN_EPS = 1e-5
BN_MOMENTUM = 0.1

_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_BN = {2: nn.BatchNorm2d, 3: nn.BatchNorm3d}


def _tuple(v, n: int) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


class ConvBNAct(nn.Sequential):
    """Bias-free conv (2D or 3D) → BatchNorm → optional ReLU.

    ``forward(x, residual=None)``: with a residual, ``relu(bn(conv(x)) +
    residual)`` — the epilogue of the fused kernel.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=3, stride=1, padding=None, dilation=1,
                 dims: int = 2, relu: bool = True):
        k = _tuple(kernel_size, dims)
        s = _tuple(stride, dims)
        d = _tuple(dilation, dims)
        p = (tuple((kk - 1) // 2 * dd for kk, dd in zip(k, d))
             if padding is None else _tuple(padding, dims))
        super().__init__(
            _CONV[dims](in_channels, out_channels, k, s, p, d, bias=False),
            _BN[dims](out_channels, eps=BN_EPS, momentum=BN_MOMENTUM))
        self.relu = relu
        self.fusible = (dims == 3 and k == (3, 3, 3) and s == (1, 1, 1)
                        and d == (1, 1, 1) and p == (1, 1, 1))

    def folded_affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Eval BatchNorm as float32 ``(scale, bias)``:
        ``scale = γ / √(var + eps)``, ``bias = β − mean · scale``."""
        bn = self[1]
        scale = bn.weight.float() * torch.rsqrt(bn.running_var.float()
                                                + bn.eps)
        return scale, bn.bias.float() - bn.running_mean.float() * scale

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if self.fusible and not self.training:
            scale, bias = self.folded_affine()
            kernel = self[0].weight.permute(2, 3, 4, 1, 0).to(x.dtype)
            return conv3d_fused(
                x.contiguous(), kernel, scale, bias,
                None if residual is None else residual.contiguous(),
                relu=self.relu)
        y = self[1](self[0](channels_first(x)))
        if residual is not None:
            y = y + channels_first(residual)
        if self.relu:
            y = F.relu(y)
        return channels_last(y)


class ConvTransposeBN(nn.Sequential):
    """``ConvTranspose3d(k=3, s=2, p=1, output_padding=1)`` → BatchNorm: the
    output is exactly twice the input along D, H and W."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(
            nn.ConvTranspose3d(in_channels, out_channels, 3, stride=2,
                               padding=1, output_padding=1, bias=False),
            nn.BatchNorm3d(out_channels, eps=BN_EPS, momentum=BN_MOMENTUM))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channels_last(super().forward(channels_first(x)))


class BasicResBlock(nn.Module):
    """Two 3×3 conv-BN with a residual add and no ReLU after it (the
    original toolbox's ``BasicBlock``); 2D."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Sequential(
            ConvBNAct(in_channels, planes, 3, stride, dilation=dilation))
        self.conv2 = ConvBNAct(planes, planes, 3, 1, dilation=dilation,
                               relu=False)
        self.downsample = (ConvBNAct(in_channels, planes, 1, stride,
                                     padding=0, relu=False)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return out + x


def dual_view_apply(feat_fn, left: torch.Tensor, right: torch.Tensor):
    """Run a shared feature trunk on both views in eval: one call on the
    views batched together, which gives the same result as two calls with
    running BatchNorm statistics. `feat_fn` returns a dict of tensors."""
    b = left.shape[0]
    both = feat_fn(torch.cat([left, right], dim=0))
    return ({k: v[:b] for k, v in both.items()},
            {k: v[b:] for k, v in both.items()})


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The original toolbox's initialisation, drawn from `generator`:
    conv weights ~ N(0, 2 / (k_volume · out_channels)), BatchNorm γ = 1,
    β = 0."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                n = math.prod(m.kernel_size) * m.out_channels
                m.weight.normal_(0.0, math.sqrt(2.0 / n), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
