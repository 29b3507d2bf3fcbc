"""PCWNet (ECCV'22): volumes at four scales fused into one hourglass, Mish
hourglasses, and a full-resolution refinement over a warped correlation.

Counterpart of ``stereo_toolbox_tpu/models/pcwnet.py``: PCWNet_G (40-group
correlation volumes alone) and PCWNet_GC (each beside a 12-channel concat
volume). Modules and their names follow the original toolbox's
``models/PCWNet/pcwnet.py``, so ``state_dict`` keys are its PyTorch names;
the parameter set is the JAX package's, whose PCWNet_G also holds the
concat heads (`PCWFeature`).

Contract: ImageNet-normalised ``[B, H, W, 3]`` left/right images → ``[B, H,
W]`` disparity (float32). H and W must be multiples of 32. In eval only
``classif3`` runs, then the refinement: the right refinement features
warped by ``pred3`` (with the reference's ``W / (W − 1)`` and −0.5 scaling
and its sampled mask thresholded at 0.999), their signed correlation with
the left ones (with the reference's negative-offset slice) and `RefineNetV3`.
Every classifier head is registered.
Train mode is not ported yet (ROADMAP.md, Queue 1 item 10) and raises.

On the card the eval forward launches K1 four times (the gwc volumes at
1/4, 1/8, 1/16 and 1/32), K6 four times for PCWNet_GC (the masked concat
volumes), K2 on each of the 17 stride-1 3×3×3 ConvBNs of the 3D stacks
(Mish after the kernel, whose epilogue applies no ReLU) and K3 once
(``classif3``'s last conv); the stride-2, transposed, 1×1 and 2D convs run
on cuDNN.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stereo_toolbox_tpu_torch.models.cfnet import (CostVolumes, _classify,
                                                   _dres_pair, _head,
                                                   _run_dres, _run_head, mish)
from stereo_toolbox_tpu_torch.nn.layers import (BasicResBlock, ConvBNAct,
                                                ConvTransposeBN,
                                                HourglassRedir,
                                                channels_first, channels_last,
                                                classifier, dual_view_apply,
                                                every_other, init_weights)
from stereo_toolbox_tpu_torch.ops.sampling import (bilinear_sampler,
                                                   coords_grid)
from stereo_toolbox_tpu_torch.ops.upsample import interpolate
from stereo_toolbox_tpu_torch.ops.volume import disparity_regression
from stereo_toolbox_tpu_torch.utils.precision import full_float32


def signed_correlation_volume(left: torch.Tensor, right: torch.Tensor,
                              radius: int) -> torch.Tensor:
    """Mean correlation of ``[B, H, W, C]`` maps at the signed offsets
    −radius..radius → ``[B, H, W, 2 · radius + 1]``, zero where an offset
    has no partner. The original's ``build_corrleation_volume``, with its
    slice at negative offsets: for ``off = −k`` it writes columns ``:k``
    with ``left[..., :k] · right[..., W − k:]`` (the leading left columns
    against the trailing right ones). Published checkpoints were trained
    with it."""
    b, h, w, _ = left.shape
    out = left.new_zeros(b, h, w, 2 * radius + 1)
    for i, off in enumerate(range(-radius, radius + 1)):
        if off > 0:
            out[:, :, off:, i] = (left[:, :, off:]
                                  * right[:, :, :w - off]).mean(-1)
        elif off < 0:
            k = -off
            out[:, :, :k, i] = (left[:, :, :k] * right[:, :, w - k:]).mean(-1)
        else:
            out[..., i] = (left * right).mean(-1)
    return out


class DilatedBlock(BasicResBlock):
    """The original's ``BasicBlock`` at stride 1 with dilated 3×3 convs and
    Mish (JAX's ``_DilatedBlock``): a 1×1 ConvBN on the skip where the
    channels change."""

    def __init__(self, in_channels: int, planes: int, dilation: int):
        super().__init__(in_channels, planes, 1, dilation,
                         downsample=in_channels != planes, act="mish")


class PCWFeature(nn.Module):
    """Mish residual trunk to 1/32 (layer4 the dilated stage), with the
    320-channel gw heads at 1/4 (``layer11`` over ``[layer2, layer3,
    layer4]``), 1/8, 1/16 and 1/32, the 12-channel concat heads
    (``lastconv``, ``concat2..4``), and the refinement feature
    (``layer_refine``, 32 channels at 1/4); channels-last. The concat heads
    are registered in both variants, as the JAX package's ``PCWFeature``
    builds them (the original's PCWNet_G has none); they run only with
    `concat_feature` (PCWNet_GC), as only PCWNet_GC reads them."""

    def __init__(self, concat_feature: bool = True,
                 concat_channels: int = 12):
        super().__init__()
        self.firstconv = every_other(ConvBNAct(3, 32, 3, 2, act="mish"),
                                     ConvBNAct(32, 32, 3, 1, act="mish"),
                                     ConvBNAct(32, 32, 3, 1, act="mish"))
        self.inplanes = 32
        self.layer1 = self._layer(32, 3, 1)
        self.layer2 = self._layer(64, 16, 2)
        self.layer3 = self._layer(128, 3, 1)
        self.layer4 = nn.Sequential(*(DilatedBlock(128, 128, 2)
                                      for _ in range(3)))
        self.layer5 = self._layer(192, 3, 2)
        self.layer7 = self._layer(256, 3, 2)
        self.layer9 = self._layer(512, 3, 2)
        self.layer11 = _head(320, 320, 320)
        for s, ci in ((2, 192), (3, 256), (4, 512)):
            setattr(self, f"gw{s}", _head(ci, 320, 320))
        self.concat_feature = concat_feature
        self.lastconv = _head(320, 128, concat_channels)
        for s, ci in ((2, 192), (3, 256), (4, 512)):
            setattr(self, f"concat{s}", _head(ci, 128, concat_channels))
        self.layer_refine = every_other(
            ConvBNAct(320, 128, 3, act="mish"),
            ConvBNAct(128, 32, 1, padding=0, act="mish"))

    def _layer(self, planes: int, blocks: int, stride: int) -> nn.Sequential:
        down = stride != 1 or self.inplanes != planes
        mods = [BasicResBlock(self.inplanes, planes, stride, downsample=down,
                              act="mish")]
        self.inplanes = planes
        mods += [BasicResBlock(planes, planes, act="mish")
                 for _ in range(1, blocks)]
        return nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> dict:
        l2 = self.layer2(self.layer1(self.firstconv(x)))
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        l5 = self.layer5(l4)
        l6 = self.layer7(l5)
        l7 = self.layer9(l6)
        combine = torch.cat([l2, l3, l4], dim=-1)
        by_scale = {1: combine, 2: l5, 3: l6, 4: l7}
        out = {f"gw{s}": _run_head(self.layer11 if s == 1
                                   else getattr(self, f"gw{s}"), x)
               for s, x in by_scale.items()}
        if self.concat_feature:
            for s, x in by_scale.items():
                out[f"concat_feature{s}"] = _run_head(
                    self.lastconv if s == 1 else getattr(self, f"concat{s}"),
                    x)
        out["finetune_feature"] = self.layer_refine(combine)
        return out


class HourglassUp3(nn.Module):
    """The three-scale fusing hourglass: going down, each bias-free
    stride-2 conv's output is joined by the next scale's volume (``[c,
    v2 | v3 | v4]``, `volume_channels` each) in ``combine1..3``; coming up,
    three transposed ConvBNs with 1×1 ``redir`` skips, Mish after each sum;
    channels-last."""

    def __init__(self, c: int, volume_channels: int):
        super().__init__()
        v = volume_channels

        def convbn(ci, co):
            return nn.Sequential(ConvBNAct(ci, co, 3, 1, dims=3, act="mish"))

        self.conv1 = nn.Conv3d(c, 2 * c, 3, 2, 1, bias=False)
        self.combine1 = convbn(2 * c + v, 2 * c)
        self.conv2 = convbn(2 * c, 2 * c)
        self.conv3 = nn.Conv3d(2 * c, 4 * c, 3, 2, 1, bias=False)
        self.combine2 = convbn(4 * c + v, 4 * c)
        self.conv4 = convbn(4 * c, 4 * c)
        self.conv5 = nn.Conv3d(4 * c, 4 * c, 3, 2, 1, bias=False)
        self.combine3 = convbn(4 * c + v, 4 * c)
        self.conv6 = convbn(4 * c, 4 * c)
        self.conv7 = ConvTransposeBN(4 * c, 4 * c)
        self.conv8 = ConvTransposeBN(4 * c, 2 * c)
        self.conv9 = ConvTransposeBN(2 * c, c)
        self.redir3 = ConvBNAct(4 * c, 4 * c, 1, 1, 0, dims=3, act=None)
        self.redir2 = ConvBNAct(2 * c, 2 * c, 1, 1, 0, dims=3, act=None)
        self.redir1 = ConvBNAct(c, c, 1, 1, 0, dims=3, act=None)

    def forward(self, x: torch.Tensor, v2: torch.Tensor, v3: torch.Tensor,
                v4: torch.Tensor) -> torch.Tensor:
        def down(conv, y):
            return channels_last(conv(channels_first(y)))

        c2 = self.conv2(self.combine1(torch.cat([down(self.conv1, x), v2],
                                                -1)))
        c4 = self.conv4(self.combine2(torch.cat([down(self.conv3, c2), v3],
                                                -1)))
        c6 = self.conv6(self.combine3(torch.cat([down(self.conv5, c4), v4],
                                                -1)))
        c7 = mish(self.conv7(c6) + self.redir3(c4))
        c8 = mish(self.conv8(c7) + self.redir2(c2))
        return mish(self.conv9(c8) + self.redir1(x))


class RefineNetV3(nn.Module):
    """The original's ``refinenet_version3``: four ConvBN-Mish (dilations 1,
    1, 2, 4), three dilated Mish blocks (128 → 96 at 8, → 64 at 16, → 32 at
    1) and a bias-free 3×3 conv to the residual added to `disp`."""

    def __init__(self, in_channels: int):
        super().__init__()
        for i, (ci, dil) in enumerate(((in_channels, 1), (128, 1), (128, 2),
                                       (128, 4)), 1):
            setattr(self, f"conv{i}", nn.Sequential(
                ConvBNAct(ci, 128, 3, dilation=dil, act="mish")))
        self.conv5 = nn.Sequential(DilatedBlock(128, 96, 8))
        self.conv6 = nn.Sequential(DilatedBlock(96, 64, 16))
        self.conv7 = nn.Sequential(DilatedBlock(64, 32, 1))
        self.conv8 = nn.Conv2d(32, 1, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
        for i in range(1, 8):
            x = getattr(self, f"conv{i}")(x)
        return disp + self.conv8(channels_first(x))[:, 0].float()


def regress(cost: torch.Tensor, max_disp: int, h: int, w: int
            ) -> torch.Tensor:
    """``[B, D, h', w']`` costs → ``[B, h, w]`` disparity: trilinear
    upsampling to ``(max_disp, h, w)`` (``align_corners=True``) in float32,
    the softmax over D and the disparity regression."""
    cost = interpolate(cost.float(), (max_disp, h, w), (1, 2, 3),
                       align_corners=True)
    return disparity_regression(torch.softmax(cost, 1), max_disp)


def warp_coords(disp: torch.Tensor) -> torch.Tensor:
    """The original warp's sampling positions ``[B, H, W, 2]`` for the
    disparity `disp` ``[B, H, W]``. It normalises by ``W − 1`` but samples
    with ``align_corners=False``, so the position is ``(x − disp) · W /
    (W − 1) − 0.5`` (``y · H / (H − 1) − 0.5``)."""
    b, h, w = disp.shape
    grid = coords_grid(b, h, w, device=disp.device)
    return torch.stack([(grid[..., 0] - disp) * (w / (w - 1.0)) - 0.5,
                        grid[..., 1] * (h / (h - 1.0)) - 0.5], dim=-1)


def warp_mask(coords: torch.Tensor, dtype: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """The original warp's mask ``[B, H, W]``: where a map of ones, sampled
    in `dtype` at `coords`, reaches 0.999."""
    ones = torch.ones(*coords.shape[:3], 1, dtype=dtype,
                      device=coords.device)
    return bilinear_sampler(ones, coords)[..., 0] >= 0.999


class RefineWarp(nn.Module):
    """The refinement's inputs but `dispupsample`'s: both views' refinement
    features upsampled to ``(h, w)`` (``align_corners=True``), the right
    one warped by `pred3` at the original's positions (`warp_coords`) and
    zeroed off its mask (`warp_mask`), and the signed correlation of the
    left with the warped one. No parameters."""

    def __init__(self, radius: int):
        super().__init__()
        self.radius = radius

    def forward(self, feat_l: torch.Tensor, feat_r: torch.Tensor,
                pred3: torch.Tensor) -> tuple[torch.Tensor, ...]:
        h, w = pred3.shape[1:]
        rf_l = interpolate(feat_l, (h, w), (1, 2), align_corners=True)
        rf_r = interpolate(feat_r, (h, w), (1, 2), align_corners=True)
        coords = warp_coords(pred3)
        warped = bilinear_sampler(rf_r, coords)
        warped = warped * warp_mask(coords, rf_r.dtype)[..., None].to(
            warped.dtype)
        return rf_l, warped, signed_correlation_volume(rf_l, warped,
                                                       self.radius)


class PCWNet(nn.Module):
    def __init__(self, max_disp: int = 192, use_concat_volume: bool = True,
                 num_groups: int = 40, concat_channels: int = 12,
                 refine_radius: int = 24,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.max_disp = max_disp
        self.feature_extraction = PCWFeature(use_concat_volume,
                                             concat_channels)
        self.volumes = CostVolumes(max_disp, num_groups,
                                   {1: 4, 2: 8, 3: 16, 4: 32},
                                   use_concat_volume)
        cv = num_groups + (2 * concat_channels if use_concat_volume else 0)
        self.dres0, self.dres1 = _dres_pair(cv, 32)
        self.combine1 = HourglassUp3(32, cv)
        self.dres2 = HourglassRedir(32, act="mish")
        self.dres3 = HourglassRedir(32, act="mish")
        self.dres4 = HourglassRedir(32, act="mish")
        for i in range(5):
            setattr(self, f"classif{i}", classifier(32, "mish"))
        self.warp = RefineWarp(refine_radius)
        self.dispupsample = nn.Sequential(ConvBNAct(1, 32, 1, padding=0,
                                                    act="mish"))
        # [rf_l − warped, rf_l, pred3 feature, pred3, correlation]
        self.refinenet3 = RefineNetV3(3 * 32 + 1 + 2 * refine_radius + 1)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        if self.training:
            raise NotImplementedError(
                "PCWNet trains in a later slice of the port (ROADMAP.md, "
                "Queue 1 item 10); its eval forward runs")
        dtype = self.classif3[0][0].weight.dtype
        with full_float32(dtype == torch.float32):
            return self._forward(left, right, dtype)

    def _forward(self, left, right, dtype):
        _, h, w, _ = left.shape
        fl, fr = dual_view_apply(self.feature_extraction, left.to(dtype),
                                 right.to(dtype))
        v1, v2, v3, v4 = self.volumes(fl, fr)
        cost0 = _run_dres(self.dres0, self.dres1, v1)
        combine = self.combine1(cost0, v2, v3, v4)
        out3 = self.dres4(self.dres3(self.dres2(combine)))
        pred3 = regress(_classify(self.classif3, out3), self.max_disp, h, w)
        rf_l, warped, corr = self.warp(fl["finetune_feature"],
                                       fr["finetune_feature"], pred3)
        pred3_feat = self.dispupsample(pred3[..., None].to(dtype))
        refine_in = torch.cat([rf_l - warped, rf_l, pred3_feat,
                               pred3[..., None], corr], dim=-1)
        return self.refinenet3(refine_in.to(dtype), pred3)


def PCWNet_G(max_disp: int = 192, **kw) -> PCWNet:
    return PCWNet(max_disp=max_disp, use_concat_volume=False, **kw)


def PCWNet_GC(max_disp: int = 192, **kw) -> PCWNet:
    return PCWNet(max_disp=max_disp, use_concat_volume=True, **kw)
