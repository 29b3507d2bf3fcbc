"""GwcNet (CVPR'19): group-wise correlation volume, redirected hourglasses.

Counterpart of ``stereo_toolbox_tpu/models/gwcnet.py`` (G variant: the
40-group correlation volume alone). Modules and their names follow the
original toolbox's ``models/GwcNet/gwcnet.py``, so ``state_dict`` keys are
its PyTorch names and published checkpoints load with ``load_state_dict``.

Contract: ImageNet-normalised ``[B, H, W, 3]`` left/right images → ``[B, H,
W]`` disparity (float32). Eval only: only ``classif3`` runs, but all four
classifiers are registered so the parameter set is the original's whole.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn as nn

from stereo_toolbox_tpu_torch.nn.layers import (BasicResBlock, ConvBNAct,
                                                ConvTransposeBN,
                                                channels_first,
                                                dual_view_apply, init_weights)
from stereo_toolbox_tpu_torch.ops.upsample import interpolate
from stereo_toolbox_tpu_torch.ops.volume import (build_gwc_volume,
                                                 disparity_regression)


def _every_other(*mods: nn.Module) -> nn.Sequential:
    """Sequential numbered 0, 2, 4, …: the original interleaves parameter-free
    ReLUs, which the blocks here apply themselves."""
    return nn.Sequential(OrderedDict((str(2 * i), m)
                                     for i, m in enumerate(mods)))


class GwcFeature(nn.Module):
    """Residual trunk → 320-channel gwc feature (concat of layer2..4) at
    1/4 resolution, channels-last."""

    def __init__(self):
        super().__init__()
        self.firstconv = _every_other(ConvBNAct(3, 32, 3, 2),
                                      ConvBNAct(32, 32, 3, 1),
                                      ConvBNAct(32, 32, 3, 1))
        self.inplanes = 32
        self.layer1 = self._layer(32, 3, 1, 1)
        self.layer2 = self._layer(64, 16, 2, 1)
        self.layer3 = self._layer(128, 3, 1, 1)
        self.layer4 = self._layer(128, 3, 1, 2)

    def _layer(self, planes, blocks, stride, dilation) -> nn.Sequential:
        down = stride != 1 or self.inplanes != planes
        mods = [BasicResBlock(self.inplanes, planes, stride, dilation, down)]
        self.inplanes = planes
        mods += [BasicResBlock(planes, planes, 1, dilation)
                 for _ in range(1, blocks)]
        return nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> dict:
        x = self.layer1(self.firstconv(x))
        l2 = self.layer2(x)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        return {"gwc_feature": torch.cat([l2, l3, l4], dim=-1)}


class HourglassRedir(nn.Module):
    """3D hourglass with 1×1 ``redir`` skips; channels-last."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Sequential(ConvBNAct(c, 2 * c, 3, 2, dims=3))
        self.conv2 = nn.Sequential(ConvBNAct(2 * c, 2 * c, 3, 1, dims=3))
        self.conv3 = nn.Sequential(ConvBNAct(2 * c, 4 * c, 3, 2, dims=3))
        self.conv4 = nn.Sequential(ConvBNAct(4 * c, 4 * c, 3, 1, dims=3))
        self.conv5 = ConvTransposeBN(4 * c, 2 * c)
        self.conv6 = ConvTransposeBN(2 * c, c)
        self.redir1 = ConvBNAct(c, c, 1, 1, 0, dims=3, relu=False)
        self.redir2 = ConvBNAct(2 * c, 2 * c, 1, 1, 0, dims=3, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c2 = self.conv2(self.conv1(x))
        c4 = self.conv4(self.conv3(c2))
        c5 = torch.relu(self.conv5(c4) + self.redir2(c2))
        return torch.relu(self.conv6(c5) + self.redir1(x))


def _classifier() -> nn.Sequential:
    return _every_other(ConvBNAct(32, 32, 3, 1, dims=3),
                        nn.Conv3d(32, 1, 3, 1, 1, bias=False))


class GwcNet(nn.Module):
    def __init__(self, max_disp: int = 192, num_groups: int = 40,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.max_disp = max_disp
        self.num_groups = num_groups
        self.feature_extraction = GwcFeature()
        self.dres0 = _every_other(ConvBNAct(num_groups, 32, 3, 1, dims=3),
                                  ConvBNAct(32, 32, 3, 1, dims=3))
        self.dres1 = _every_other(ConvBNAct(32, 32, 3, 1, dims=3),
                                  ConvBNAct(32, 32, 3, 1, dims=3, relu=False))
        self.dres2 = HourglassRedir(32)
        self.dres3 = HourglassRedir(32)
        self.dres4 = HourglassRedir(32)
        self.classif0 = _classifier()
        self.classif1 = _classifier()
        self.classif2 = _classifier()
        self.classif3 = _classifier()
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def forward(self, left: torch.Tensor, right: torch.Tensor
                ) -> torch.Tensor:
        if self.training:
            raise NotImplementedError("GwcNet runs in eval mode only; call "
                                      ".eval() first")
        _, h, w, _ = left.shape
        dtype = self.classif3[0][0].weight.dtype
        fl, fr = dual_view_apply(self.feature_extraction, left.to(dtype),
                                 right.to(dtype))
        volume = build_gwc_volume(fl["gwc_feature"].contiguous(),
                                  fr["gwc_feature"].contiguous(),
                                  self.max_disp // 4, self.num_groups)
        cost0 = self.dres0(volume)
        c = self.dres1[0](cost0)
        cost0 = self.dres1[1](c, residual=cost0)
        out3 = self.dres4(self.dres3(self.dres2(cost0)))
        cost = self.classif3[1](channels_first(self.classif3[0](out3)))
        cost = interpolate(cost[:, 0], (self.max_disp, h, w), (1, 2, 3),
                           align_corners=False)
        prob = torch.softmax(cost.float(), dim=1)
        return disparity_regression(prob, self.max_disp)


def GwcNet_G(max_disp: int = 192, **kw) -> GwcNet:
    return GwcNet(max_disp=max_disp, **kw)
