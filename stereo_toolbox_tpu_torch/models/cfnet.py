"""CFNet (CVPR'21): fused multi-scale cost volumes and an uncertainty-driven
cascade over per-pixel disparity samples.

Counterpart of ``stereo_toolbox_tpu/models/cfnet.py``. Modules and their
names follow the original toolbox's ``models/CFNet/cfnet.py``, so
``state_dict`` keys are its PyTorch names. The
original's ``combine1.combine3`` and ``combine1.redir3`` are registered
there but never used by its forward; they are not registered here, so an
original checkpoint loads once those keys are dropped.

Contract: ImageNet-normalised ``[B, H, W, 3]`` left/right images → ``[B, H,
W]`` disparity (float32). H and W must be multiples of 32. Only the heads
of the eval path run (``classif2`` and ``confidence_classif1_s{3,2}``), but
every head and the cascade's ``gamma_s*``/``beta_s*`` are registered, so the
parameter set is the original's whole. In train mode (float32) the forward
returns JAX's nine predictions at full resolution: ``classif0`` and
``classif1`` regressed over the full range (trilinear upsampling with
``align_corners=True``), the 1/8 stage's ``pred2``, then each cascade
stage's ``confidence_classif0``, ``confidence_classifmid`` and
``confidence_classif1`` over its samples. The search range of the next
stage takes the prediction detached (JAX's ``stop_gradient``), in the
variance too; the samples are floored, so nothing reaches ``gamma_s*`` /
``beta_s*`` through them (zero gradients, as in JAX).

On the card the forward launches K1 three times (the gwc volumes at 1/8,
1/16, 1/32), K6 three times (the concat volumes), K5 and K4 once per
cascade stage (the sampled gwc and concat volumes at 1/4 and 1/2), K2 on
each stride-1 3×3×3 ConvBN of the 3D stacks and K3 on the last conv of each
of the three classifiers that run. A train step launches K1, K6, K4 and K5
as the forward does and each of their backward kernels as often; every
conv runs on cuDNN.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.models.gwcnet import refuse_bfloat16_training
from stereo_toolbox_tpu_torch.nn.layers import (BasicResBlock, ConvBNAct,
                                                ConvTransposeBN,
                                                HourglassRedir, avg_pool,
                                                channels_first, channels_last,
                                                classifier, dual_view_apply,
                                                every_other, init_weights)
from stereo_toolbox_tpu_torch.ops.upsample import interpolate, resize_nearest
from stereo_toolbox_tpu_torch.ops.volume import (
    build_concat_volume, build_gwc_volume, concat_volume_from_samples,
    disparity_regression, disparity_variance, disparity_variance_confidence,
    gwc_volume_from_samples)
from stereo_toolbox_tpu_torch.utils.precision import full_float32


def mish(x: torch.Tensor) -> torch.Tensor:
    return F.mish(x)


class _PoolPath(nn.Module):
    """One pyramid-pooling path: the original's ``conv2DBatchNormRelu``
    (with Mish), whose layers sit under ``cbr_unit``."""

    def __init__(self, c: int):
        super().__init__()
        self.cbr_unit = ConvBNAct(c, c, 1, padding=0, act="mish")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cbr_unit(x)


class PyramidPooling(nn.Module):
    """icnet sum-mode pyramid pooling: four average pools whose window
    sizes follow ``np.linspace(2, min(h, w), 4)``, each through a 1×1
    ConvBN-Mish and resized back, added at 0.25; then Mish of half the sum."""

    def __init__(self, c: int):
        super().__init__()
        self.path_module_list = nn.ModuleList(_PoolPath(c) for _ in range(4))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        k_sizes = [(max(h // int(ps), 1), max(w // int(ps), 1))
                   for ps in np.linspace(2, min(h, w), 4, dtype=int)][::-1]
        pp = x
        for path, k in zip(self.path_module_list, k_sizes):
            out = path(avg_pool(x, k, k))
            pp = pp + 0.25 * interpolate(out, (h, w), (1, 2),
                                         align_corners=False)
        return mish(pp / 2.0)


class _NearestUp2(nn.Module):
    """Parameter-free ×2 nearest upsampling of a channels-last map (the
    original's ``nn.Upsample(scale_factor=2)``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_nearest(x, (x.shape[1] * 2, x.shape[2] * 2), (1, 2))


def _head(ci: int, mid: int, out: int) -> nn.Sequential:
    """3×3 ConvBN-Mish then a bias-free 1×1 conv; applied by `_run_head`."""
    return every_other(ConvBNAct(ci, mid, 3, act="mish"),
                       nn.Conv2d(mid, out, 1, bias=False))


def _run_head(head: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    return channels_last(head[1](channels_first(head[0](x))))


class CFFeature(nn.Module):
    """UNet encoder-decoder with pyramid pooling; returns the gwc features
    (``gw2``..``gw6``) and concat features (``concat_feature2``..6) of the
    scales 1/2 .. 1/32, channels-last."""

    def __init__(self, concat_channels: int = 12):
        super().__init__()
        self.firstconv = every_other(ConvBNAct(3, 32, 3, 2, act="mish"),
                                     ConvBNAct(32, 32, 3, 1, act="mish"),
                                     ConvBNAct(32, 32, 3, 1, act="mish"))
        chans = (32, 64, 128, 192, 256, 512)
        for i, (ci, co) in enumerate(zip(chans, chans[1:])):
            setattr(self, f"layer{i + 2}", nn.Sequential(BasicResBlock(
                ci, co, 1 if i == 0 else 2, downsample=True, act="mish")))
        self.pyramid_pooling = PyramidPooling(512)
        for s, ci, co in ((6, 512, 256), (5, 256, 192), (4, 192, 128),
                          (3, 128, 64)):
            setattr(self, f"upconv{s}", nn.Sequential(
                _NearestUp2(), ConvBNAct(ci, co, 3, act="mish")))
            setattr(self, f"iconv{s - 1}", nn.Sequential(
                ConvBNAct(2 * co, co, 3, act="mish")))
        cc = concat_channels
        heads = {"gw2": (64, 80, 80), "gw3": (128, 160, 160),
                 "gw4": (192, 160, 160), "gw5": (256, 320, 320),
                 "gw6": (512, 320, 320), "concat2": (64, 32, cc // 2),
                 "concat3": (128, 128, cc), "concat4": (192, 128, cc),
                 "concat5": (256, 128, cc), "concat6": (512, 128, cc)}
        for name, (ci, mid, out) in heads.items():
            setattr(self, name, _head(ci, mid, out))

    def forward(self, x: torch.Tensor) -> dict:
        x = self.firstconv(x)
        l2 = self.layer2(x)
        l3 = self.layer3(l2)
        l4 = self.layer4(l3)
        l5 = self.layer5(l4)
        l6 = self.pyramid_pooling(self.layer6(l5))
        d5 = self.iconv5(torch.cat([l5, self.upconv6(l6)], -1))
        d4 = self.iconv4(torch.cat([l4, self.upconv5(d5)], -1))
        d3 = self.iconv3(torch.cat([l3, self.upconv4(d4)], -1))
        d2 = self.iconv2(torch.cat([l2, self.upconv3(d3)], -1))
        by_scale = {2: d2, 3: d3, 4: d4, 5: d5, 6: l6}
        out = {}
        for s, x in by_scale.items():
            out[f"gw{s}"] = _run_head(getattr(self, f"gw{s}"), x)
            out[f"concat_feature{s}"] = _run_head(
                getattr(self, f"concat{s}"), x)
        return out


class HourglassUp(nn.Module):
    """Multi-scale fusing hourglass: the 1/8 stack going down takes in the
    1/16 and 1/32 stacks (``feature4``, ``feature5``); channels-last."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Conv3d(c, 2 * c, 3, 2, 1, bias=False)
        self.combine1 = nn.Sequential(ConvBNAct(4 * c, 2 * c, 3, 1, dims=3,
                                                act="mish"))
        self.conv2 = nn.Sequential(ConvBNAct(2 * c, 2 * c, 3, 1, dims=3,
                                             act="mish"))
        self.conv3 = nn.Conv3d(2 * c, 4 * c, 3, 2, 1, bias=False)
        self.combine2 = nn.Sequential(ConvBNAct(6 * c, 4 * c, 3, 1, dims=3,
                                                act="mish"))
        self.conv4 = nn.Sequential(ConvBNAct(4 * c, 4 * c, 3, 1, dims=3,
                                             act="mish"))
        self.conv8 = ConvTransposeBN(4 * c, 2 * c)
        self.conv9 = ConvTransposeBN(2 * c, c)
        self.redir2 = ConvBNAct(2 * c, 2 * c, 1, 1, 0, dims=3, act=None)
        self.redir1 = ConvBNAct(c, c, 1, 1, 0, dims=3, act=None)

    def forward(self, x: torch.Tensor, feature4: torch.Tensor,
                feature5: torch.Tensor) -> torch.Tensor:
        c1 = channels_last(self.conv1(channels_first(x)))
        c1 = self.combine1(torch.cat([c1, feature4], -1))
        c2 = self.conv2(c1)
        c3 = channels_last(self.conv3(channels_first(c2)))
        c3 = self.combine2(torch.cat([c3, feature5], -1))
        c4 = self.conv4(c3)
        c8 = mish(self.conv8(c4) + self.redir2(c2))
        return mish(self.conv9(c8) + self.redir1(x))


def uniform_samples(min_d: torch.Tensor, max_d: torch.Tensor,
                    count: int) -> torch.Tensor:
    """`count` disparities spaced evenly strictly inside ``[min_d, max_d]``
    ``[B, H, W]``, with ``floor(min_d)`` and ``ceil(max_d)`` at the ends, all
    floored: ``[B, count + 2, H, W]`` integer-valued floats."""
    mult = (max_d - min_d) / (count + 1)
    steps = torch.arange(1.0, count + 1, dtype=min_d.dtype,
                         device=min_d.device)[None, :, None, None]
    samples = min_d[:, None] + mult[:, None] * steps
    samples = torch.cat([torch.floor(min_d)[:, None], samples,
                         torch.ceil(max_d)[:, None]], dim=1)
    return torch.floor(samples)


class CostVolumes(nn.Module):
    """The fused ``[gwc, concat]`` volumes at 1/8, 1/16 and 1/32 (K1, K6);
    no parameters."""

    def __init__(self, max_disp: int, num_groups: int):
        super().__init__()
        self.max_disp, self.num_groups = max_disp, num_groups

    def forward(self, fl: dict, fr: dict) -> list[torch.Tensor]:
        out = []
        for scale in (4, 5, 6):
            d = self.max_disp // 2 ** (scale - 1)
            gwc = build_gwc_volume(fl[f"gw{scale}"].contiguous(),
                                   fr[f"gw{scale}"].contiguous(), d,
                                   self.num_groups)
            cv = build_concat_volume(
                fl[f"concat_feature{scale}"].contiguous(),
                fr[f"concat_feature{scale}"].contiguous(), d)
            out.append(torch.cat([gwc, cv], -1))
        return out


class SampledVolume(nn.Module):
    """``[gwc, concat, sample]`` volume over per-pixel disparity samples at
    one cascade stage (K5, K4); no parameters."""

    def __init__(self, scale: int, num_groups: int, max_shift: int):
        super().__init__()
        self.scale, self.num_groups = scale, num_groups
        self.max_shift = max_shift

    def forward(self, fl: dict, fr: dict, samples: torch.Tensor
                ) -> torch.Tensor:
        s = self.scale
        gwc = gwc_volume_from_samples(
            fl[f"gw{s}"].contiguous(), fr[f"gw{s}"].contiguous(), samples,
            self.num_groups, self.max_shift)
        concat = concat_volume_from_samples(
            fl[f"concat_feature{s}"], fr[f"concat_feature{s}"].contiguous(),
            samples, self.max_shift)
        return torch.cat([gwc, concat, samples[..., None].to(gwc.dtype)], -1)


def _dres_pair(ci: int, c: int) -> tuple[nn.Sequential, nn.Sequential]:
    """The original's ``dres0``/``dres1`` pair: two ConvBN-Mish, then two
    more whose second has no activation and adds the pair's first output."""
    return (every_other(ConvBNAct(ci, c, 3, 1, dims=3, act="mish"),
                        ConvBNAct(c, c, 3, 1, dims=3, act="mish")),
            every_other(ConvBNAct(c, c, 3, 1, dims=3, act="mish"),
                        ConvBNAct(c, c, 3, 1, dims=3, act=None)))


def _run_dres(first: nn.Sequential, second: nn.Sequential,
              x: torch.Tensor) -> torch.Tensor:
    c = first(x)
    return second[1](second[0](c), residual=c)


def _classify(head: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """``[B, D, H, W, C]`` → ``[B, D, H, W]`` costs."""
    return head[1](head[0](x))[..., 0]


class CFNet(nn.Module):
    def __init__(self, max_disp: int = 192, num_groups: int = 40,
                 concat_channels: int = 12, sample_count_s2: int = 10,
                 sample_count_s3: int = 14,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.max_disp = max_disp
        self.num_groups = num_groups
        self.sample_count_s2 = sample_count_s2
        self.sample_count_s3 = sample_count_s3
        self.feature_extraction = CFFeature(concat_channels)
        self.volumes = CostVolumes(max_disp, num_groups)
        self.volume_s3 = SampledVolume(3, num_groups, max_disp // 4)
        self.volume_s2 = SampledVolume(2, num_groups // 2, max_disp // 2)
        cv = num_groups + 2 * concat_channels
        self.dres0, self.dres1 = _dres_pair(cv, 32)
        self.dres0_5, self.dres1_5 = _dres_pair(cv, 64)
        self.dres0_6, self.dres1_6 = _dres_pair(cv, 64)
        self.combine1 = HourglassUp(32)
        self.dres3 = HourglassRedir(32, act="mish")
        self.confidence0_s3, self.confidence1_s3 = _dres_pair(
            num_groups + 2 * concat_channels + 1, 32)
        self.confidence2_s3 = HourglassRedir(32, act="mish")
        self.confidence3_s3 = HourglassRedir(32, act="mish")
        self.confidence0_s2, self.confidence1_s2 = _dres_pair(
            num_groups // 2 + concat_channels + 1, 16)
        self.confidence2_s2 = HourglassRedir(16, act="mish")
        self.confidence3_s2 = HourglassRedir(16, act="mish")
        for name in ("classif0", "classif1", "classif2",
                     "confidence_classif0_s3", "confidence_classif1_s3",
                     "confidence_classifmid_s3"):
            setattr(self, name, classifier(32, "mish"))
        for name in ("confidence_classif0_s2", "confidence_classif1_s2",
                     "confidence_classifmid_s2"):
            setattr(self, name, classifier(16, "mish"))
        for name in ("gamma_s3", "beta_s3", "gamma_s2", "beta_s2"):
            setattr(self, name, nn.Parameter(torch.zeros(1)))
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def _search_range(self, count: int, lo: torch.Tensor, hi: torch.Tensor,
                      scale: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Widen ``[lo, hi]`` to at least `count` and clip it to the scale's
        disparity range."""
        cap = self.max_disp / (2 ** scale) - 1
        widen = torch.clamp(count - hi + lo, min=0) / 2.0
        return (torch.clamp(lo - widen, 0, cap),
                torch.clamp(hi + widen, 0, cap))

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        dtype = self.classif2[0][0].weight.dtype
        if self.training:
            refuse_bfloat16_training(dtype)
        with full_float32(dtype == torch.float32):
            return self._forward(left, right, dtype)

    def _forward(self, left, right, dtype):
        _, h, w, _ = left.shape
        train = self.training
        fl, fr = dual_view_apply(self.feature_extraction, left.to(dtype),
                                 right.to(dtype), train)
        preds = []    # the train-only heads, in JAX's order, as their inputs
        #               are ready (an eval forward keeps no stage's output)

        v4, v5, v6 = self.volumes(fl, fr)
        cost0_4 = _run_dres(self.dres0, self.dres1, v4)
        cost0_5 = _run_dres(self.dres0_5, self.dres1_5, v5)
        cost0_6 = _run_dres(self.dres0_6, self.dres1_6, v6)
        out1_4 = self.combine1(cost0_4, cost0_5, cost0_6)
        if train:
            preds += [self._regress_full(self.classif0, cost0_4, h, w),
                      self._regress_full(self.classif1, out1_4, h, w)]
        out2_4 = self.dres3(out1_4)
        del out1_4

        # stage s4 (1/8): the full-range volume
        d8 = self.max_disp // 8
        prob2_s4 = torch.softmax(_classify(self.classif2, out2_4).float(), 1)
        pred2_s4 = disparity_regression(prob2_s4, d8)
        if train:
            preds.append(_up_to(pred2_s4, 8, h, w))
        pred2_s4 = pred2_s4.detach()
        var_s4 = torch.sqrt(disparity_variance(prob2_s4, pred2_s4) + 1e-12)
        samples_s3 = self._samples(pred2_s4, var_s4, self.gamma_s3,
                                   self.beta_s3, self.sample_count_s3, 2)

        # stage s3 (1/4): volumes over the samples
        cost0_s3 = _run_dres(self.confidence0_s3, self.confidence1_s3,
                             self.volume_s3(fl, fr, samples_s3))
        out1_s3 = self.confidence2_s3(cost0_s3)
        if train:
            preds += [self._sampled(head, x, samples_s3, 4, h, w)
                      for head, x in ((self.confidence_classif0_s3, cost0_s3),
                                      (self.confidence_classifmid_s3,
                                       out1_s3))]
        out2_s3 = self.confidence3_s3(out1_s3)
        del out1_s3
        pred1_s3, prob1_s3 = self._sample_regress(
            _classify(self.confidence_classif1_s3, out2_s3), samples_s3)
        if train:
            preds.append(_up_to(pred1_s3, 4, h, w))
        pred1_s3 = pred1_s3.detach()
        var_s3 = torch.sqrt(disparity_variance_confidence(
            prob1_s3, samples_s3, pred1_s3) + 1e-12)
        samples_s2 = self._samples(pred1_s3, var_s3, self.gamma_s2,
                                   self.beta_s2, self.sample_count_s2, 1)

        # stage s2 (1/2)
        cost0_s2 = _run_dres(self.confidence0_s2, self.confidence1_s2,
                             self.volume_s2(fl, fr, samples_s2))
        out1_s2 = self.confidence2_s2(cost0_s2)
        if train:
            preds += [self._sampled(head, x, samples_s2, 2, h, w)
                      for head, x in ((self.confidence_classif0_s2, cost0_s2),
                                      (self.confidence_classifmid_s2,
                                       out1_s2))]
        out2_s2 = self.confidence3_s2(out1_s2)
        del out1_s2
        pred1_s2, _ = self._sample_regress(
            _classify(self.confidence_classif1_s2, out2_s2), samples_s2)
        pred1_s2 = _up_to(pred1_s2, 2, h, w)
        return preds + [pred1_s2] if train else pred1_s2

    def _regress_full(self, head, x, h, w):
        """A full-range head: its costs trilinearly upsampled to
        ``(max_disp, h, w)`` (``align_corners=True``, float32), the softmax
        and the disparity regression."""
        cost = interpolate(_classify(head, x).float(), (self.max_disp, h, w),
                           (1, 2, 3), align_corners=True)
        return disparity_regression(torch.softmax(cost, 1), self.max_disp)

    def _sampled(self, head, x, samples, factor, h, w):
        """A head over the samples, regressed and brought to ``(h, w)``."""
        return _up_to(self._sample_regress(_classify(head, x), samples)[0],
                      factor, h, w)

    def _samples(self, pred, var, gamma, beta, count, scale):
        """The next stage's samples: ``pred ∓ ((γ + 1)·σ + β)`` upsampled
        ×2 (values too), widened and clipped, then `uniform_samples`."""
        def upx2(d):
            return interpolate(d * 2.0, (d.shape[1] * 2, d.shape[2] * 2),
                               (1, 2), align_corners=True)

        # float32 in every model but a float64 copy, whose range then
        # computes in float64, as JAX's does
        gamma, beta = gamma[:1], beta[:1]
        lo = upx2(pred - (gamma + 1) * var - beta)
        hi = upx2(pred + (gamma + 1) * var + beta)
        lo, hi = self._search_range(count + 1, lo, hi, scale)
        return uniform_samples(lo, hi, count)

    @staticmethod
    def _sample_regress(cost, samples):
        """Softmax over the samples in float32 and the expected sample."""
        prob = torch.softmax(cost.float(), dim=1)
        return (prob * samples).sum(1), prob


def _up_to(d: torch.Tensor, factor: int, h: int, w: int) -> torch.Tensor:
    """``[B, h', w']`` disparities × `factor`, bilinearly resized to ``(h,
    w)`` with ``align_corners=True``."""
    return interpolate(d * factor, (h, w), (1, 2), align_corners=True)
