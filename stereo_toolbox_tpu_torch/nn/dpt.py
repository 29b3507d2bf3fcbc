"""DPT depth head of DepthAnythingV2 (PyTorch).

Counterpart of ``ResidualConvUnit``, ``FeatureFusionBlock`` and ``DPTHead``
in ``stereo_toolbox_tpu/models/depth_anything_v2.py``, with the original
DPT's PyTorch names (``projects.{i}``, ``resize_layers.{0,1,3}``,
``scratch.layer{1..4}_rn``, ``scratch.refinenet{1..4}``,
``scratch.output_conv1``, ``scratch.output_conv2.{0,2}``).

The fusion chain runs as the JAX package's does: every path stays at its own
scale and the ×2 upsample to the next level is a separate align-corners
resize, which yields the decoder features (``paths``) the foundation-tier
stereo models consume and the depth output from one chain.
``refinenet4.resConfUnit1`` is left out: the original constructs it but its
forward never applies it (there is no skip input at the coarsest level).

The convs run on cuDNN in channels-first layout inside the head; its inputs
are the ViT's tokens and its feature outputs are channels-last views, as in
JAX.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.nn.vit import PATCH


def resize(x: torch.Tensor, size, align_corners: bool = True
           ) -> torch.Tensor:
    """Bilinear resize of a ``[B, C, H, W]`` tensor to `size`."""
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=align_corners)


class ResidualConvUnit(nn.Module):
    """``x + conv2(relu(conv1(relu(x))))``, 3×3 convs with bias."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """Optional skip through ``resConfUnit1``, then ``resConfUnit2`` and the
    1×1 ``out_conv``, at the input's own scale."""

    def __init__(self, features: int, skip: bool = True):
        super().__init__()
        if skip:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None
                ) -> torch.Tensor:
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(self.resConfUnit2(x))


class Scratch(nn.Module):
    def __init__(self, features: int, out_channels):
        super().__init__()
        for i, oc in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(oc, features, 3, 1, 1, bias=False))
        for i in (1, 2, 3, 4):
            setattr(self, f"refinenet{i}",
                    FeatureFusionBlock(features, skip=i != 4))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, 1, 1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU())


class DPTHead(nn.Module):
    """Four ViT taps → relative inverse depth ``[B, ph · 14, pw · 14]``."""

    def __init__(self, in_channels: int, features: int, out_channels,
                 out_align_corners: bool = True):
        super().__init__()
        oc = out_channels
        self.out_align_corners = out_align_corners
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1)
                                      for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, 4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, 2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, 2, 1)])
        self.scratch = Scratch(features, oc)

    def forward(self, taps, ph: int, pw: int, return_path1: bool = False):
        """`taps`: four ``(patch_tokens [B, ph · pw, C], cls)`` pairs.
        Returns the depth, and with `return_path1` also ``{"path_1", "out",
        "paths"}``: the ×2 path of the finest level, ``output_conv1`` of it
        resized to the output (before the last convs and ReLUs), and the
        four fusion outputs from the coarsest, all channels-last."""
        s = self.scratch
        layers = []
        for i, (tokens, _cls) in enumerate(taps):
            b, _, c = tokens.shape
            x = tokens.transpose(1, 2).reshape(b, c, ph, pw)
            layers.append(self.resize_layers[i](self.projects[i](x)))
        l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(x)
                          for i, x in enumerate(layers))
        p4 = s.refinenet4(l4)
        p3 = s.refinenet3(resize(p4, l3.shape[2:]), l3)
        p2 = s.refinenet2(resize(p3, l2.shape[2:]), l2)
        p1 = s.refinenet1(resize(p2, l1.shape[2:]), l1)
        path_1 = resize(p1, (2 * l1.shape[2], 2 * l1.shape[3]))
        out = resize(s.output_conv1(path_1), (ph * PATCH, pw * PATCH),
                     self.out_align_corners)
        depth = s.output_conv2(out)[:, 0]
        if return_path1:
            return depth, {"path_1": path_1.movedim(1, -1),
                           "out": out.movedim(1, -1),
                           "paths": [p.movedim(1, -1)
                                     for p in (p4, p3, p2, p1)]}
        return depth
