"""GwcNet (CVPR'19): group-wise correlation volume, redirected hourglasses.

Counterpart of ``stereo_toolbox_tpu/models/gwcnet.py``: GwcNet_G (the
40-group correlation volume alone) and GwcNet_GC (that volume beside a
12-channel concat volume). Modules and their names follow the original
toolbox's ``models/GwcNet/gwcnet.py``, so ``state_dict`` keys are its
PyTorch names and published checkpoints load with ``load_state_dict``.

Contract: ImageNet-normalised ``[B, H, W, 3]`` left/right images → ``[B, H,
W]`` disparity (float32). In eval only ``classif3`` runs; in train mode
(float32) the forward returns the four heads ``[classif0(cost0),
classif1(out1), classif2(out2), classif3(out3)]``, each regressed at full
resolution, as JAX's ``train=True`` does, with per-view BatchNorm batch
statistics in the 2D trunk.

On the card the eval forward launches K1 once (the gwc volume), K6 once for
GwcNet_GC (the masked concat volume), K2 on each stride-1 3×3×3 ConvBN of
the 3D stack and K3 once (``classif3``'s last conv). A train step launches
K1 once forward and its backward kernel once, and for GwcNet_GC K6 and its
backward kernel once each; every conv runs on cuDNN.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stereo_toolbox_tpu_torch.nn.layers import (BasicResBlock, ConvBNAct,
                                                HourglassRedir,
                                                channels_first, channels_last,
                                                classifier, dual_view_apply,
                                                every_other, init_weights)
from stereo_toolbox_tpu_torch.ops.upsample import interpolate
from stereo_toolbox_tpu_torch.ops.volume import (build_concat_volume,
                                                 build_gwc_volume,
                                                 disparity_regression)
from stereo_toolbox_tpu_torch.utils.precision import full_float32


class GwcFeature(nn.Module):
    """Residual trunk → 320-channel gwc feature (concat of layer2..4) at
    1/4 resolution, channels-last; with `concat_feature`, also the
    ``lastconv`` concat feature (3×3 ConvBN-ReLU to 128, bias-free 1×1 to
    `CONCAT_CHANNELS`)."""
    CONCAT_CHANNELS = 12

    def __init__(self, concat_feature: bool = False):
        super().__init__()
        self.firstconv = every_other(ConvBNAct(3, 32, 3, 2),
                                     ConvBNAct(32, 32, 3, 1),
                                     ConvBNAct(32, 32, 3, 1))
        self.inplanes = 32
        self.layer1 = self._layer(32, 3, 1, 1)
        self.layer2 = self._layer(64, 16, 2, 1)
        self.layer3 = self._layer(128, 3, 1, 1)
        self.layer4 = self._layer(128, 3, 1, 2)
        self.lastconv = (every_other(
            ConvBNAct(320, 128, 3),
            nn.Conv2d(128, self.CONCAT_CHANNELS, 1, bias=False))
            if concat_feature else None)

    def _layer(self, planes, blocks, stride, dilation) -> nn.Sequential:
        down = stride != 1 or self.inplanes != planes
        mods = [BasicResBlock(self.inplanes, planes, stride, dilation, down)]
        self.inplanes = planes
        mods += [BasicResBlock(planes, planes, 1, dilation)
                 for _ in range(1, blocks)]
        return nn.Sequential(*mods)

    def trunk(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """``layer2``, ``layer3`` and ``layer4``'s outputs (64, 128 and 128
        channels at 1/4 resolution)."""
        l2 = self.layer2(self.layer1(self.firstconv(x)))
        l3 = self.layer3(l2)
        return l2, l3, self.layer4(l3)

    def forward(self, x: torch.Tensor) -> dict:
        gwc = torch.cat(self.trunk(x), dim=-1)
        if self.lastconv is None:
            return {"gwc_feature": gwc}
        cf = self.lastconv[1](channels_first(self.lastconv[0](gwc)))
        return {"gwc_feature": gwc, "concat_feature": channels_last(cf)}


class GwcNet(nn.Module):
    def __init__(self, max_disp: int = 192, use_concat_volume: bool = False,
                 num_groups: int = 40,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.max_disp = max_disp
        self.use_concat_volume = use_concat_volume
        self.num_groups = num_groups
        self.feature_extraction = GwcFeature(use_concat_volume)
        ci = num_groups + (2 * GwcFeature.CONCAT_CHANNELS
                           if use_concat_volume else 0)
        self.dres0 = every_other(ConvBNAct(ci, 32, 3, 1, dims=3),
                                 ConvBNAct(32, 32, 3, 1, dims=3))
        self.dres1 = every_other(ConvBNAct(32, 32, 3, 1, dims=3),
                                 ConvBNAct(32, 32, 3, 1, dims=3, act=None))
        self.dres2 = HourglassRedir(32)
        self.dres3 = HourglassRedir(32)
        self.dres4 = HourglassRedir(32)
        self.classif0 = classifier()
        self.classif1 = classifier()
        self.classif2 = classifier()
        self.classif3 = classifier()
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        dtype = self.classif3[0][0].weight.dtype
        if self.training:
            refuse_bfloat16_training(dtype)
        with full_float32(dtype == torch.float32):
            return self._forward(left, right, dtype)

    def _forward(self, left, right, dtype):
        _, h, w, _ = left.shape
        fl, fr = dual_view_apply(self.feature_extraction, left.to(dtype),
                                 right.to(dtype), self.training)
        d4 = self.max_disp // 4
        volume = build_gwc_volume(fl["gwc_feature"].contiguous(),
                                  fr["gwc_feature"].contiguous(), d4,
                                  self.num_groups)
        if self.use_concat_volume:
            volume = torch.cat([volume, build_concat_volume(
                fl["concat_feature"].contiguous(),
                fr["concat_feature"].contiguous(), d4)], dim=-1)
        cost0 = self.dres0(volume)
        c = self.dres1[0](cost0)
        cost0 = self.dres1[1](c, residual=cost0)
        if not self.training:     # no hourglass output is kept
            out3 = self.dres4(self.dres3(self.dres2(cost0)))
            return regress(classify(self.classif3, out3), self.max_disp, h, w)
        out1 = self.dres2(cost0)
        out2 = self.dres3(out1)
        out3 = self.dres4(out2)
        return [regress(classify(head, x), self.max_disp, h, w)
                for head, x in ((self.classif0, cost0), (self.classif1, out1),
                                (self.classif2, out2), (self.classif3, out3))]


def classify(head: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A classifier's 3×3×3 ConvBN-ReLU, then its conv to one channel."""
    return head[1](head[0](x))


def regress(cost: torch.Tensor, max_disp: int, h: int, w: int
            ) -> torch.Tensor:
    """``[B, D/4, H/4, W/4, 1]`` costs → ``[B, H, W]`` disparity: trilinear
    upsampling to ``(max_disp, h, w)``, the softmax over D in float32 and
    the disparity regression."""
    cost = interpolate(cost[..., 0], (max_disp, h, w), (1, 2, 3),
                       align_corners=False)
    return disparity_regression(torch.softmax(cost.float(), dim=1), max_disp)


def refuse_bfloat16_training(dtype: torch.dtype) -> None:
    """Train mode takes no bfloat16 model (a float64 copy, ``.double()``,
    trains as the float32 model does, its head in float32)."""
    if dtype == torch.bfloat16:
        raise NotImplementedError(
            "bfloat16 training is not ported yet: it needs float32 master "
            "parameters cast at use, as flax keeps them (ROADMAP Queue 1, "
            "item 1)")


def GwcNet_G(max_disp: int = 192, **kw) -> GwcNet:
    return GwcNet(max_disp=max_disp, use_concat_volume=False, **kw)


def GwcNet_GC(max_disp: int = 192, **kw) -> GwcNet:
    return GwcNet(max_disp=max_disp, use_concat_volume=True, **kw)
