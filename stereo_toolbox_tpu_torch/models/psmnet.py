"""PSMNet (CVPR'18): SPP features, the concat cost volume, three stacked 3D
hourglasses.

Counterpart of ``stereo_toolbox_tpu/models/psmnet.py``. Modules and their
names follow the original toolbox's ``models/PSMNet/stackhourglass.py`` and
``submodule.py``, so ``state_dict`` keys are its PyTorch names and published
checkpoints load with ``load_state_dict``.

Contract: ImageNet-normalised ``[B, H, W, 3]`` left/right images → ``[B, H,
W]`` disparity (float32). The three classifiers run in both modes,
cascaded (``cost2 = classif2 + cost1``, ``cost3 = classif3 + cost2``); eval
regresses ``cost3``, train mode (float32) returns all three heads
regressed at full resolution, as JAX's ``train=True`` does, with per-view
BatchNorm batch statistics in the 2D trunk.

The concat volume is never built: its one consumer, ``dres0``'s first conv,
runs as `nn.layers.ConcatVolumeConvBNAct` (two 2D convs, then strided
copies and adds). On
the card the eval forward launches K2 on each stride-1 3×3×3 ConvBN of the
3D stack (12) and K3 on each classifier's last conv (3); a train step
launches no kernel of the port (every conv on cuDNN), as JAX's train step
reaches no Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.models.gwcnet import (GwcFeature, regress,
                                                    refuse_bfloat16_training)
from stereo_toolbox_tpu_torch.nn.layers import (ConcatVolumeConvBNAct,
                                                ConvBNAct, ConvTransposeBN,
                                                avg_pool, channels_first,
                                                channels_last, classifier,
                                                dual_view_apply, every_other,
                                                init_weights)
from stereo_toolbox_tpu_torch.ops.upsample import interpolate
from stereo_toolbox_tpu_torch.utils.precision import full_float32


class SPPPool(nn.Module):
    """Floor-mode average pool over a `size`-pixel window, clipped to the
    input (``(min(size, h), min(size, w))``, as the JAX package clips it)."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        return avg_pool(x, (min(self.size, h), min(self.size, w)))


class SPPFeature(GwcFeature):
    """GwcNet's residual trunk, four pooled branches of its ``layer4``
    output (windows of 64, 32, 16 and 8 px, a 1×1 ConvBN-ReLU to 32
    channels, bilinear back), then ``lastconv`` over ``[layer2, layer4,
    branch4..1]`` (320 channels): 3×3 ConvBN-ReLU to 128, bias-free 1×1 to
    32. Returns ``{"feature": [B, H/4, W/4, 32]}``."""
    POOLS = (64, 32, 16, 8)

    def __init__(self):
        super().__init__()
        for i, size in enumerate(self.POOLS, 1):
            self.add_module(f"branch{i}", nn.Sequential(
                SPPPool(size), ConvBNAct(128, 32, 1, padding=0)))
        self.lastconv = every_other(ConvBNAct(320, 128, 3),
                                    nn.Conv2d(128, 32, 1, bias=False))

    def forward(self, x: torch.Tensor) -> dict:
        x_raw, _, x_skip = self.trunk(x)
        size = x_skip.shape[1:3]
        branches = [interpolate(getattr(self, f"branch{i}")(x_skip), size,
                                (1, 2), align_corners=False)
                    for i in range(len(self.POOLS), 0, -1)]
        feat = self.lastconv[0](torch.cat([x_raw, x_skip, *branches], dim=-1))
        return {"feature": channels_last(
            self.lastconv[1](channels_first(feat)))}


class Hourglass3D(nn.Module):
    """3D encoder-decoder with the pre/post squeeze skips of the original's
    ``hourglass``: ``conv2`` is ``relu(bn(conv(x)) + postsqu)`` (K2's
    residual epilogue; plain ReLU without ``postsqu``), ``post = relu(
    conv5(·) + (presqu or pre))``. Returns ``(out, pre, post)``."""

    def __init__(self, c: int):
        super().__init__()
        self.conv1 = nn.Sequential(ConvBNAct(c, 2 * c, 3, 2, dims=3))
        self.conv2 = ConvBNAct(2 * c, 2 * c, 3, 1, dims=3)
        self.conv3 = nn.Sequential(ConvBNAct(2 * c, 2 * c, 3, 2, dims=3))
        self.conv4 = nn.Sequential(ConvBNAct(2 * c, 2 * c, 3, 1, dims=3))
        self.conv5 = ConvTransposeBN(2 * c, 2 * c)
        self.conv6 = ConvTransposeBN(2 * c, c)

    def forward(self, x: torch.Tensor, presqu: torch.Tensor | None,
                postsqu: torch.Tensor | None):
        pre = self.conv2(self.conv1(x), residual=postsqu)
        out = self.conv4(self.conv3(pre))
        post = F.relu(self.conv5(out) + (presqu if presqu is not None
                                         else pre))
        return self.conv6(post), pre, post


class PSMNet(nn.Module):
    """Stacked-hourglass PSMNet at the original's widths (32-channel
    features at 1/4 resolution, D/4 disparities)."""

    def __init__(self, max_disp: int = 192,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.max_disp = max_disp
        self.feature_extraction = SPPFeature()
        self.dres0 = every_other(ConcatVolumeConvBNAct(32, 32, max_disp // 4),
                                 ConvBNAct(32, 32, 3, 1, dims=3))
        self.dres1 = every_other(ConvBNAct(32, 32, 3, 1, dims=3),
                                 ConvBNAct(32, 32, 3, 1, dims=3, act=None))
        self.dres2 = Hourglass3D(32)
        self.dres3 = Hourglass3D(32)
        self.dres4 = Hourglass3D(32)
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
        cost0 = self.dres0[1](self.dres0[0](fl["feature"], fr["feature"]))
        cost0 = self.dres1[1](self.dres1[0](cost0), residual=cost0)
        out1, pre1, post1 = self.dres2(cost0, None, None)
        out1 = out1 + cost0
        out2, _, post2 = self.dres3(out1, pre1, post1)
        out2 = out2 + cost0
        out3, _, _ = self.dres4(out2, pre1, post2)
        out3 = out3 + cost0
        cost1 = self.classif1(out1)
        cost2 = self.classif2(out2) + cost1
        cost3 = self.classif3(out3) + cost2
        if not self.training:
            return regress(cost3, self.max_disp, h, w)
        return [regress(c, self.max_disp, h, w) for c in (cost1, cost2, cost3)]
