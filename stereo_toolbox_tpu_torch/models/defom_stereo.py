"""DEFOMStereo (CVPR'25): depth-foundation-model priors in a RAFT loop
(PyTorch).

Counterpart of ``stereo_toolbox_tpu/models/defom_stereo.py``, with the
original toolbox's module names (``defomencoder.depth_anything.pretrained``,
``….depth_head``, ``….depth_feat``, ``fnet``, ``cnet``,
``context_zqr_convs``, ``update_block``, ``scale_update_block``), so its
``state_dict`` keys are the original's:

  * `DefomEncoder`: one DINOv2 pass over both views resized to the DAv2
    input size (`get_danv2_io_size`), then two DPT heads (`DEFOMHead`). The
    depth head sees the left view and gives the initial disparity
    ``idepth / max(idepth) · idepth_scale · W/4 + 0.01``; it runs without
    autograd, as JAX stops its output. The trainable feature head resizes
    its ``layer{1..4}_rn`` maps onto the 1/4-based pyramid and returns
    ``[rn1, rn2, rn3]`` of the left view (detached, as JAX stops them) and
    both views' ``p1`` (not detached: the train step differentiates the
    ViT through it);
  * ``fnet`` (instance norm) adds ``convd(p1)`` before its 1×1 output;
    ``cnet`` (frozen batch norm) adds ``conv08/16/32(d_feats[k])`` before
    each output head;
  * `scale_iters` iterations of the scale update block (a level-0 lookup at
    ``x0 − s · disp`` for each s of `scale_list`, radius 2; ``disp ←
    clip(exp(0.25 · x), 0, 6) · disp``), then additive updates with the
    delta clipped to the lookup's range, ``±2^(levels − 1) · radius``; each
    iteration starts from the detached disparity.

Contract: ImageNet-normalised ``[B, H, W, 3]`` left/right images → ``[B, H,
W]`` disparity (float32). In eval the final iteration alone is upsampled;
in train mode (`self.training`) the forward returns every iteration's
full-resolution map (``train_iters`` of them), which the trainer's sequence
loss takes. Frozen batch norm and instance norm are the same in both modes.

On the card the forward launches K7 once a ViT block (12 for ``vits``, 24
for ``vitl``), with the log-sum-exp a train step saves; a train step's
backward launches K7-bwd's two kernels once a block each. Every conv runs
on cuDNN, the correlation on cuBLAS. In bfloat16 the correlation, the
disparity and the convex blend stay float32, as in JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.models.depth_anything_v2 import (
    DEFAULT_FEATURES, VIT_CONFIGS, init_weights)
from stereo_toolbox_tpu_torch.models.raft_stereo import (
    IMAGENET_MEAN, IMAGENET_STD, BasicMultiUpdateBlock, FrozenBatchNorm2d,
    InstanceNorm, RAFTResBlock, make_norm)
from stereo_toolbox_tpu_torch.nn.dpt import FeatureFusionBlock
from stereo_toolbox_tpu_torch.nn.gru import conv_nhwc
from stereo_toolbox_tpu_torch.nn.layers import channels_last
from stereo_toolbox_tpu_torch.nn.vit import PATCH, DINOv2
from stereo_toolbox_tpu_torch.ops.corr import (all_pairs_correlation,
                                               build_corr_pyramid,
                                               corr_lookup_1d)
from stereo_toolbox_tpu_torch.ops.upsample import convex_upsample, interpolate
from stereo_toolbox_tpu_torch.utils.precision import (compute_dtype,
                                                      full_float32)


def get_danv2_io_size(h: int, w: int, factor: int = 4,
                      max_size: int = 2688) -> tuple[int, int, int, int]:
    """DAv2 input size (a multiple of 14, ≈ 3.5× the 1/`factor` grid,
    capped at `max_size`) and output size (the 1/`factor` grid)."""
    oh, ow = h // factor, w // factor
    ih = -(-int(3.5 * oh) // PATCH) * PATCH
    iw = -(-int(3.5 * ow) // PATCH) * PATCH
    cap = max_size // PATCH * PATCH
    return min(ih, cap), min(iw, cap), oh, ow


class _Scratch(nn.Module):
    def __init__(self, features: int, out_channels, with_output: bool):
        super().__init__()
        for i, oc in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(oc, features, 3, 1, 1, bias=False))
        for i in (1, 2, 3, 4):
            setattr(self, f"refinenet{i}",
                    FeatureFusionBlock(features, skip=i != 4))
        if with_output:
            self.output_conv1 = nn.Conv2d(features, features // 2, 3, 1, 1)
            self.output_conv2 = nn.Sequential(
                nn.Conv2d(features // 2, 32, 3, 1, 1), nn.ReLU(),
                nn.Conv2d(32, 1, 1), nn.ReLU())


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    """Align-corners bilinear resize of a ``[B, C, H, W]`` tensor, in the
    JAX package's arithmetic (`ops.upsample.interpolate`)."""
    return interpolate(x, tuple(size), (2, 3), True)


def _fuse(block: FeatureFusionBlock, x, skip, size) -> torch.Tensor:
    """The vendored fusion block: optional skip, residual unit, resize to
    `size` (never a 2× of its own), then the 1×1 ``out_conv``."""
    if skip is not None:
        x = x + block.resConfUnit1(skip)
    return block.out_conv(_resize(block.resConfUnit2(x), size))


class DEFOMHead(nn.Module):
    """DEFOM's vendored DPT pair: with `with_output` the depth head (the
    fusion chain at patch-grid sizes, ``output_conv1``, a resize to the 1/4
    grid, ``output_conv2``), else the feature head (``layer{1..4}_rn``
    resized onto the 1/4-based pyramid first). Convs on cuDNN in
    channels-first layout inside; its outputs are channels-last."""

    def __init__(self, in_channels: int, features: int, out_channels,
                 with_output: bool):
        super().__init__()
        oc = out_channels
        self.with_output = with_output
        self.projects = nn.ModuleList(nn.Conv2d(in_channels, c, 1)
                                      for c in oc)
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, 4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, 2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, 2, 1)])
        self.scratch = _Scratch(features, oc, with_output)

    def forward(self, taps, ph: int, pw: int, out_size):
        """`taps`: four ``(patch_tokens [B, ph · pw, C], cls)``. The depth
        head returns ``[B, oh, ow]``; the feature head ``([rn1, rn2, rn3],
        p1)``, channels-last."""
        s, (oh, ow) = self.scratch, out_size
        rn = []
        for i, (tokens, _cls) in enumerate(taps):
            b, _, c = tokens.shape
            x = tokens.transpose(1, 2).reshape(b, c, ph, pw)
            x = self.resize_layers[i](self.projects[i](x))
            rn.append(getattr(s, f"layer{i + 1}_rn")(x))
        if not self.with_output:
            rn = [_resize(x, (oh // 2 ** i, ow // 2 ** i))
                  for i, x in enumerate(rn)]
        l1, l2, l3, l4 = rn
        p4 = _fuse(s.refinenet4, l4, None, l3.shape[2:])
        p3 = _fuse(s.refinenet3, p4, l3, l2.shape[2:])
        p2 = _fuse(s.refinenet2, p3, l2, l1.shape[2:])
        p1 = _fuse(s.refinenet1, p2, l1, l1.shape[2:])
        if not self.with_output:
            return [channels_last(x) for x in (l1, l2, l3)], channels_last(p1)
        out = _resize(s.output_conv1(p1), (oh, ow))
        return s.output_conv2(out)[:, 0]


class DepthAnything(nn.Module):
    """The DAv2 trunk and DEFOM's two heads, under the original's
    ``depth_anything`` scope."""

    def __init__(self, encoder: str):
        super().__init__()
        cfg = VIT_CONFIGS[encoder]
        features = DEFAULT_FEATURES[encoder]
        self.pretrained = DINOv2(cfg["embed_dim"], cfg["depth"],
                                 cfg["num_heads"])
        self.depth_head = DEFOMHead(cfg["embed_dim"], features,
                                    cfg["out_channels"], with_output=True)
        self.depth_feat = DEFOMHead(cfg["embed_dim"], features,
                                    cfg["out_channels"], with_output=False)


class DefomEncoder(nn.Module):
    """DAv2 trunk + depth/feature heads + the initial disparity."""

    def __init__(self, encoder: str = "vits", idepth_scale: float = 0.5):
        super().__init__()
        self.taps = tuple(VIT_CONFIGS[encoder]["taps"])
        self.idepth_scale = idepth_scale
        self.depth_anything = DepthAnything(encoder)

    def forward(self, both: torch.Tensor, io_sizes):
        """Both views ``[2B, H, W, 3]`` → ``(d_feats, p1 left, p1 right,
        disp)``: the left view's ``[rn1, rn2, rn3]`` (detached), both views'
        ``p1`` and the initial disparity ``[B, H/4, W/4]``."""
        ih, iw, oh, ow = io_sizes
        da = self.depth_anything
        dtype = da.pretrained.patch_embed.proj.weight.dtype
        x = interpolate(both, (ih, iw), (1, 2), True)
        taps = da.pretrained.get_intermediate_layers(x.to(dtype), self.taps)
        b = both.shape[0] // 2
        ph, pw = ih // PATCH, iw // PATCH
        with torch.no_grad():           # JAX stops the depth head's output
            idepth = da.depth_head([(t[:b], c[:b]) for t, c in taps], ph, pw,
                                   (oh, ow))
            max_id = idepth.reshape(b, -1).amax(dim=1)[:, None, None] + 1e-8
        d_feats, p1 = da.depth_feat(taps, ph, pw, (oh, ow))
        disp = idepth / max_id * self.idepth_scale * ow + 0.01
        return [f[:b].detach() for f in d_feats], p1[:b], p1[b:], disp


class ConvBlock(nn.Module):
    """3×3 conv (bias) + norm + ReLU (the original's ``ConvBlock``; its
    unused ``norm2``/``norm3`` are left out)."""

    def __init__(self, in_planes: int, planes: int, norm: str):
        super().__init__()
        self.conv = nn.Conv2d(in_planes, planes, 3, padding=1)
        self.norm1 = make_norm(norm, planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm1(conv_nhwc(self.conv, x)))


def _stages(norm: str) -> list[nn.Sequential]:
    """``layer1..3``: two RAFTResBlocks at widths 64, 96, 128, the first of
    the last two with stride 2."""
    layers, planes = [], 64
    for dim, stride in ((64, 1), (96, 2), (128, 2)):
        layers.append(nn.Sequential(RAFTResBlock(planes, dim, norm, stride),
                                    RAFTResBlock(dim, dim, norm, 1)))
        planes = dim
    return layers


class DefomBasicEncoder(nn.Module):
    """``fnet``: 7×7 stem, instance norm, three residual stages, ``+
    convd(p1)``, 1×1 conv to `output_dim`."""

    def __init__(self, dfeat_dim: int, output_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, padding=3)
        self.norm1 = InstanceNorm()
        self.layer1, self.layer2, self.layer3 = _stages("instance")
        self.convd = ConvBlock(dfeat_dim, 128, "instance")
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor, dfeats: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(conv_nhwc(self.conv1, x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        return conv_nhwc(self.conv2, x + self.convd(dfeats))


class DefomMultiEncoder(nn.Module):
    """``cnet``: the trunk of ``fnet`` with frozen batch norm, then
    (hidden, context) heads at 1/4, 1/8 and 1/16 of the image, each after
    ``+ conv08/16/32`` of the DAv2 feature of its scale."""

    def __init__(self, dfeat_dim: int,
                 hidden_dims: Sequence[int] = (128, 128, 128)):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, padding=3)
        self.norm1 = FrozenBatchNorm2d(64)
        self.layer1, self.layer2, self.layer3 = _stages("batch")
        self.layer4 = nn.Sequential(RAFTResBlock(128, 128, "batch", 2),
                                    RAFTResBlock(128, 128, "batch", 1))
        self.layer5 = nn.Sequential(RAFTResBlock(128, 128, "batch", 2),
                                    RAFTResBlock(128, 128, "batch", 1))
        for s in ("08", "16", "32"):
            setattr(self, f"conv{s}", ConvBlock(dfeat_dim, 128, "batch"))
        for s, dim in (("08", hidden_dims[2]), ("16", hidden_dims[1])):
            setattr(self, f"outputs{s}", nn.ModuleList(
                nn.Sequential(RAFTResBlock(128, 128, "batch", 1),
                              nn.Conv2d(128, dim, 3, padding=1))
                for _ in range(2)))
        self.outputs32 = nn.ModuleList(
            nn.Conv2d(128, hidden_dims[0], 3, padding=1) for _ in range(2))

    def forward(self, x: torch.Tensor, d_feats):
        """``[(h04, c04), (h08, c08), (h16, c16)]``, fine to coarse."""
        x = F.relu(self.norm1(conv_nhwc(self.conv1, x)))
        x = self.layer3(self.layer2(self.layer1(x)))

        def heads(feat, outputs):
            return tuple(conv_nhwc(o[1], o[0](feat)) for o in outputs)

        out = [heads(x + self.conv08(d_feats[0]), self.outputs08)]
        y = self.layer4(x)
        out.append(heads(y + self.conv16(d_feats[1]), self.outputs16))
        z = self.layer5(y)
        feat = z + self.conv32(d_feats[2])
        out.append(tuple(conv_nhwc(o, feat) for o in self.outputs32))
        return out


class DEFOMStereo(nn.Module):
    """`dinov2_encoder` ``"vits"`` (DEFOMStereo_S) or ``"vitl"``
    (DEFOMStereo_L); the rest of the JAX package's fields with its
    defaults. ``forward(left, right, iters=None, scale_iters=None)``."""

    def __init__(self, dinov2_encoder: str = "vits", idepth_scale: float = 0.5,
                 hidden_dims: Sequence[int] = (128, 128, 128),
                 corr_levels: int = 2, corr_radius: int = 4,
                 scale_list: Sequence[float] = (0.125, 0.25, 0.5, 0.75, 1.0,
                                                1.25, 1.5, 2.0),
                 scale_corr_radius: int = 2, n_downsample: int = 2,
                 n_gru_layers: int = 3, train_iters: int = 18,
                 valid_iters: int = 32, scale_iters: int = 8,
                 imagenet_norm_input: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        if n_gru_layers != 3:
            raise NotImplementedError("DEFOMStereo runs 3 GRU layers")
        self.hidden_dims = tuple(hidden_dims)
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.scale_list = tuple(scale_list)
        self.scale_corr_radius = scale_corr_radius
        self.factor = 2 ** n_downsample
        self.train_iters, self.valid_iters = train_iters, valid_iters
        self.scale_iters = scale_iters
        self.imagenet_norm_input = imagenet_norm_input
        dfeat = DEFAULT_FEATURES[dinov2_encoder]
        self.defomencoder = DefomEncoder(dinov2_encoder, idepth_scale)
        self.cnet = DefomMultiEncoder(dfeat, hidden_dims)
        self.fnet = DefomBasicEncoder(dfeat, 256)
        self.context_zqr_convs = nn.ModuleList(
            nn.Conv2d(hidden_dims[i], hidden_dims[i] * 3, 3, padding=1)
            for i in range(3))
        self.update_block = BasicMultiUpdateBlock(
            corr_levels * (2 * corr_radius + 1), hidden_dims, self.factor)
        self.scale_update_block = BasicMultiUpdateBlock(
            len(scale_list) * (2 * scale_corr_radius + 1), hidden_dims,
            self.factor)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                iters: int | None = None, scale_iters: int | None = None):
        dtype = compute_dtype(self.fnet.conv1.weight, self.training)
        with full_float32(dtype == torch.float32):
            return self._forward(left, right, iters, scale_iters)

    def _forward(self, left, right, iters, scale_iters):
        train = self.training
        iters = iters or (self.train_iters if train else self.valid_iters)
        scale_iters = min(self.scale_iters if scale_iters is None
                          else scale_iters, iters)
        n2 = iters - scale_iters
        b, h, w, _ = left.shape
        io_sizes = get_danv2_io_size(h, w, self.factor)
        h4, w4 = io_sizes[2:]
        img1, img2 = left, right
        if not self.imagenet_norm_input:
            mean = torch.tensor(IMAGENET_MEAN, dtype=left.dtype,
                                device=left.device)
            std = torch.tensor(IMAGENET_STD, dtype=left.dtype,
                               device=left.device)
            img1, img2 = (left - mean) / std, (right - mean) / std
        both = torch.cat([img1, img2], dim=0)
        d_feats, dfeat1, dfeat2, disp = self.defomencoder(both, io_sizes)
        cnet_out = self.cnet(img1, d_feats)
        fmaps = self.fnet(both, torch.cat([dfeat1, dfeat2], dim=0))
        fmap1, fmap2 = fmaps[:b].float(), fmaps[b:].float()

        nets = tuple(torch.tanh(hh) for hh, _ in cnet_out)
        contexts = tuple(
            tuple(torch.chunk(conv_nhwc(conv, F.relu(cc)), 3, dim=-1))
            for conv, (_, cc) in zip(self.context_zqr_convs, cnet_out))
        pyramid = build_corr_pyramid(all_pairs_correlation(fmap1, fmap2),
                                     self.corr_levels)
        x0 = torch.arange(w4, dtype=torch.float32,
                          device=left.device).expand(b, h4, w4)
        disp = disp.float()
        lim = 2.0 ** (self.corr_levels - 1) * self.corr_radius
        preds = []
        for it in range(scale_iters):
            disp = disp.detach()
            corr = torch.cat([corr_lookup_1d(pyramid[:1], x0 - s * disp,
                                             self.scale_corr_radius)
                              for s in self.scale_list], dim=-1)
            nets, mask, x_disp = self.scale_update_block(nets, contexts, corr,
                                                         disp[..., None])
            disp = torch.clamp(torch.exp(0.25 * x_disp[..., 0]), 0.0,
                               6.0) * disp
            if train or (n2 == 0 and it == scale_iters - 1):
                preds.append(convex_upsample(disp, mask, self.factor))
        for it in range(n2):
            disp = disp.detach()
            corr = corr_lookup_1d(pyramid, x0 - disp, self.corr_radius)
            nets, mask, delta = self.update_block(nets, contexts, corr,
                                                  disp[..., None])
            disp = disp + torch.clamp(delta[..., 0], -lim, lim)
            if train or it == n2 - 1:
                preds.append(convex_upsample(disp, mask, self.factor))
        return preds if train else preds[-1]


def DEFOMStereo_S(**kw) -> DEFOMStereo:
    return DEFOMStereo(dinov2_encoder="vits", **kw)


def DEFOMStereo_L(**kw) -> DEFOMStereo:
    return DEFOMStereo(dinov2_encoder="vitl", **kw)


__all__ = ["DEFOMHead", "DEFOMStereo", "DEFOMStereo_L", "DEFOMStereo_S",
           "DefomBasicEncoder", "DefomEncoder", "DefomMultiEncoder",
           "get_danv2_io_size"]
