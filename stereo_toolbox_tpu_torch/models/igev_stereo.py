"""IGEV-Stereo (CVPR'23): a geometry encoding volume and a ConvGRU loop
(PyTorch).

Counterpart of ``stereo_toolbox_tpu/models/igev_stereo.py`` (`GEVHourglass`,
`IGEVMotionEncoder`, `IGEVUpdateBlock`, `combined_geo_lookup`, the loop
step and `IGEVStereo`), with the original toolbox's module names
(``feature``, ``stem_2``, ``stem_4``, ``conv``, ``desc``, ``corr_stem``,
``corr_feature_att``, ``cost_agg``, ``classifier``, ``cnet``,
``context_zqr_convs``, ``update_block``, ``spx_2_gru``, ``spx_gru`` and the
train-only ``spx_4``, ``spx_2``, ``spx``), so its ``state_dict`` keys are
the original's:

  * `nn.igev_blocks.IGEVFeature` on both views (batched: its BatchNorms
    use their running statistics and its instance norms are per sample),
    and the stems at 1/2 and 1/4 joined to the 1/4 features (96 channels);
  * the matching descriptors (``desc(conv(·))``) → the 8-group gwc volume
    at D = max_disp / 4 (`ops.build_gwc_volume`: K1 on the card) →
    ``corr_stem`` → ``corr_feature_att`` → the 3-scale `GEVHourglass` with
    a `FeatureAtt` at each scale: the geometry encoding volume;
  * the initial disparity, softmax over D (float32) of ``classifier``'s
    costs, regressed, at 1/4;
  * `valid_iters` iterations of `IGEVUpdateBlock` on `combined_geo_lookup`
    (the volume's pyramid at ``disp / 2^i ± 4`` and the correlation's at
    ``(x − disp) / 2^i ± 4``, two levels each; the correlation's as
    disparity-banded volumes reaching ``max_disp + band_margin`` with
    ``corr_impl='banded'``, as an all-pairs pyramid with ``'reg'``), each
    from the detached disparity;
  * the last iteration's disparity upsampled ×4 by the superpixel weights
    (``spx_2_gru``, ``spx_gru``, softmax in float32, `context_upsample`).

Contract: ImageNet-normalised ``[B, H, W, 3]`` left/right images (H, W
multiples of 32) → ``[B, H, W]`` disparity (float32). The train-only heads
are registered and never run: train mode is not ported yet (ROADMAP.md,
Queue 1 item 5) and raises.

On the card the forward launches K1 once (``(B, H/4, W/4, 96)``, D 48, G
8 at max_disp 192); every conv, 2D and 3D, runs on cuDNN, as JAX computes
IGEV's as XLA convolutions; the correlations on cuBLAS. In bfloat16 the
volumes and the band are bfloat16; the softmax, the carried disparity, the
lookup positions and the upsample float32, as in JAX. Seeded random
weights are drawn as flax draws them (`nn.layers.lecun_init`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.models.raft_stereo import (
    BasicMotionEncoder, DispHead, MultiBasicEncoder, context_biases,
    imagenet_to_unit)
from stereo_toolbox_tpu_torch.nn.gru import ConvGRU, conv_nhwc, pool2x
from stereo_toolbox_tpu_torch.nn.igev_blocks import (BasicConvBN,
                                                     BasicConvIN, Conv2x,
                                                     IGEVFeature)
from stereo_toolbox_tpu_torch.nn.layers import (FeatureAtt, InstanceNorm,
                                                channels_first, channels_last,
                                                lecun_init)
from stereo_toolbox_tpu_torch.ops.corr import (
    all_pairs_correlation, band_d_max, band_offsets, build_corr_band_pyramid,
    build_corr_pyramid, build_volume_pyramid, corr_lookup_1d,
    corr_lookup_1d_banded, volume_lookup_1d)
from stereo_toolbox_tpu_torch.ops.upsample import (context_upsample,
                                                   interpolate)
from stereo_toolbox_tpu_torch.ops.volume import (build_gwc_volume,
                                                 disparity_regression)
from stereo_toolbox_tpu_torch.utils.precision import (compute_dtype,
                                                      full_float32)

GWC_GROUPS = 8


class GEVHourglass(nn.Module):
    """The 3-scale 3D hourglass with a `FeatureAtt` at every scale
    (``features[1..3]``: the 1/8, 1/16 and 1/32 features, 64, 192 and 160
    channels) and a transposed conv back to 8 channels at the input's
    grid. Channels-last ``[B, D, H, W, C]``."""

    def __init__(self, c: int = 8):
        super().__init__()

        def conv(ci, co, k=3, s=1):
            return BasicConvBN(ci, co, k, s, dims=3)

        self.conv1 = nn.Sequential(conv(c, 2 * c, s=2), conv(2 * c, 2 * c))
        self.conv2 = nn.Sequential(conv(2 * c, 4 * c, s=2),
                                   conv(4 * c, 4 * c))
        self.conv3 = nn.Sequential(conv(4 * c, 6 * c, s=2),
                                   conv(6 * c, 6 * c))
        self.conv3_up = BasicConvBN(6 * c, 4 * c, 4, 2, deconv=True, dims=3)
        self.conv2_up = BasicConvBN(4 * c, 2 * c, 4, 2, deconv=True, dims=3)
        self.conv1_up = BasicConvBN(2 * c, 8, 4, 2, deconv=True, norm=False,
                                    relu=False, dims=3)
        self.agg_0 = nn.Sequential(conv(8 * c, 4 * c, 1), conv(4 * c, 4 * c),
                                   conv(4 * c, 4 * c))
        self.agg_1 = nn.Sequential(conv(4 * c, 2 * c, 1), conv(2 * c, 2 * c),
                                   conv(2 * c, 2 * c))
        self.feature_att_8 = FeatureAtt(2 * c, 64)
        self.feature_att_16 = FeatureAtt(4 * c, 192)
        self.feature_att_32 = FeatureAtt(6 * c, 160)
        self.feature_att_up_16 = FeatureAtt(4 * c, 192)
        self.feature_att_up_8 = FeatureAtt(2 * c, 64)

    def forward(self, x: torch.Tensor, features) -> torch.Tensor:
        c1 = self.feature_att_8(self.conv1(x), features[1])
        c2 = self.feature_att_16(self.conv2(c1), features[2])
        c3 = self.feature_att_32(self.conv3(c2), features[3])
        c2 = self.agg_0(torch.cat([self.conv3_up(c3), c2], dim=-1))
        c2 = self.feature_att_up_16(c2, features[2])
        c1 = self.agg_1(torch.cat([self.conv2_up(c2), c1], dim=-1))
        c1 = self.feature_att_up_8(c1, features[1])
        return self.conv1_up(c1)


class IGEVUpdateBlock(nn.Module):
    """`n_gru_layers` ConvGRUs (``gru16``, ``gru08``, ``gru04``, coarse to
    fine, the coarser ones only where they run), the motion encoder on the
    geometry lookup and the disparity (`raft_stereo.BasicMotionEncoder`:
    127 channels beside the disparity), the disparity head and the
    superpixel mask features (``mask_feat_4``: 3×3 to 32, ReLU)."""

    def __init__(self, cor_planes: int,
                 hidden_dims: Sequence[int] = (128, 128, 128),
                 n_gru_layers: int = 3):
        super().__init__()
        if n_gru_layers not in (1, 2, 3):
            raise ValueError(f"n_gru_layers {n_gru_layers} is not 1, 2 or 3")
        h16, h08, h04 = hidden_dims
        self.n_gru_layers = n_gru_layers
        self.encoder = BasicMotionEncoder(cor_planes, 1, "convd")
        self.gru04 = ConvGRU(h04, 128 + (h08 if n_gru_layers > 1 else 0))
        if n_gru_layers > 1:
            self.gru08 = ConvGRU(h08, h04 + (h16 if n_gru_layers > 2 else 0))
        if n_gru_layers > 2:
            self.gru16 = ConvGRU(h16, h08)
        self.disp_head = DispHead(h04, 256, 1)
        self.mask_feat_4 = nn.Sequential(nn.Conv2d(h04, 32, 3, padding=1),
                                         nn.ReLU(inplace=True))

    def forward(self, nets, contexts, geo, disp):
        """``(net04, net08, net16)``, their contexts, the lookup and the
        ``[B, h, w, 1]`` disparity → the new nets, the mask features and
        the disparity's delta."""
        net04, net08, net16 = nets
        ctx04, ctx08, ctx16 = contexts
        n = self.n_gru_layers
        if n == 3:
            net16 = self.gru16(net16, pool2x(net08), ctx16)
        if n >= 2:
            x08 = [pool2x(net04)]
            if n == 3:
                x08.append(interpolate(net16, net08.shape[1:3], (1, 2), True))
            net08 = self.gru08(net08, torch.cat(x08, dim=-1), ctx08)
        x04 = [self.encoder(disp, geo)]
        if n > 1:
            x04.append(interpolate(net08, net04.shape[1:3], (1, 2), True))
        net04 = self.gru04(net04, torch.cat(x04, dim=-1), ctx04)
        delta = self.disp_head(net04)
        mask_feat = F.relu(conv_nhwc(self.mask_feat_4[0], net04))
        return (net04, net08, net16), mask_feat, delta


def combined_geo_lookup(geo_pyr, corr_pyr, disp: torch.Tensor,
                        x0: torch.Tensor, radius: int,
                        band_offs=()) -> torch.Tensor:
    """Each level's geometry-volume samples at ``disp / 2^i + dx`` (``[B,
    H, W, D_i, C]`` volumes; channel-major, dx minor, the reference's
    flatten) then its correlation samples at ``(x0 − disp) / 2^i + dx``
    (banded volumes where `band_offs` is given, else all-pairs ones), level
    after level: ``[B, H, W, L · (C + 1) · (2r + 1)]``."""
    corr = (corr_lookup_1d_banded(corr_pyr, x0 - disp, band_offs, radius)
            if band_offs else corr_lookup_1d(corr_pyr, x0 - disp, radius))
    k = 2 * radius + 1
    out = []
    for i, gv in enumerate(geo_pyr):
        out += [volume_lookup_1d([gv], disp / 2 ** i, radius),
                corr[..., i * k:(i + 1) * k]]
    return torch.cat(out, dim=-1)


class _Stem(nn.Sequential):
    """The original's ``stem_2`` / ``stem_4`` / ``spx_4``: ``BasicConv_IN``,
    a bias-free 3×3 conv, instance norm, ReLU."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__(BasicConvIN(in_channels, out_channels, 3, stride),
                         nn.Conv2d(out_channels, out_channels, 3, 1, 1,
                                   bias=False),
                         InstanceNorm(), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self[2](conv_nhwc(self[1], self[0](x))))


class _TransposedHead(nn.Sequential):
    """``spx`` / ``spx_gru``: a 4×4 stride-2 transposed conv (with bias)
    to the 9 superpixel logits, channels-last."""

    def __init__(self, in_channels: int = 64):
        super().__init__(nn.ConvTranspose2d(in_channels, 9, 4, 2, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self[0]
        return channels_last(conv(channels_first(x.to(conv.weight.dtype))))


class IGEVStereo(nn.Module):
    """The JAX package's fields with its defaults (hidden dims 128×3,
    max_disp 192, 2 correlation levels of radius 4, 3 GRU layers, 32 eval
    iterations, ``corr_impl='banded'`` with ``band_margin`` 32).
    ``forward(left, right, iters=None)``."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128),
                 max_disp: int = 192, corr_levels: int = 2,
                 corr_radius: int = 4, n_gru_layers: int = 3,
                 train_iters: int = 22, valid_iters: int = 32,
                 imagenet_norm_input: bool = True, corr_impl: str = "banded",
                 band_margin: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if corr_impl not in ("banded", "reg"):
            raise ValueError(f"corr_impl {corr_impl!r} is not 'banded' or "
                             f"'reg'")
        self.max_disp = max_disp
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.train_iters, self.valid_iters = train_iters, valid_iters
        self.imagenet_norm_input = imagenet_norm_input
        self.corr_impl, self.band_margin = corr_impl, band_margin
        self.feature = IGEVFeature()
        self.stem_2 = _Stem(3, 32, 2)
        self.stem_4 = _Stem(32, 48, 2)
        self.conv = BasicConvIN(96, 96, 3, 1)
        self.desc = nn.Conv2d(96, 96, 1)
        self.corr_stem = BasicConvBN(GWC_GROUPS, GWC_GROUPS, 3, dims=3)
        self.corr_feature_att = FeatureAtt(GWC_GROUPS, 96)
        self.cost_agg = GEVHourglass(GWC_GROUPS)
        self.classifier = nn.Conv3d(GWC_GROUPS, 1, 3, 1, 1, bias=False)
        self.cnet = MultiBasicEncoder(hidden_dims, hidden_dims, "batch",
                                      ("outputs04", "outputs08", "outputs16"))
        self.context_heads(
            tuple(hidden_dims),
            corr_levels * (2 * corr_radius + 1) * (GWC_GROUPS + 1),
            n_gru_layers)
        self.spx_2_gru = Conv2x(32, 32, deconv=True)
        self.spx_gru = _TransposedHead()
        # the init disparity's upsampler, which only the train forward runs
        self.spx_4 = _Stem(96, 24, 1)
        self.spx_2 = Conv2x(24, 32, deconv=True, instance_norm=True)
        self.spx = _TransposedHead()
        lecun_init(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def context_heads(self, hidden_dims: tuple, cor_planes: int,
                      n_gru_layers: int) -> None:
        """The modules between the context network and the loop:
        ``context_zqr_convs`` and the update block."""
        self.context_zqr_convs = nn.ModuleList(
            nn.Conv2d(hidden_dims[i], hidden_dims[i] * 3, 3, padding=1)
            for i in range(3))
        self.update_block = IGEVUpdateBlock(cor_planes, hidden_dims,
                                            n_gru_layers)

    def context(self, cnet_out) -> tuple:
        """What the update block takes beside the nets from the context
        network's ``[(h, c), ...]``: each scale's gate biases."""
        return context_biases(self.context_zqr_convs, cnet_out)

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                iters: int | None = None) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                f"{type(self).__name__} trains in a later part of the port "
                f"(ROADMAP.md, Queue 1 item 5); its eval forward runs")
        dtype = compute_dtype(self.desc.weight, self.training)
        with full_float32(dtype == torch.float32):
            return self._forward(left, right, iters or self.valid_iters,
                                 dtype)

    def geometry(self, left, right):
        """The geometry encoding volume ``[B, D, H/4, W/4, 8]``, the
        initial disparity (1/4 units, float32), the matching features, the
        left 1/2 stem and the image given to the context network."""
        img = torch.cat([left, right], dim=0)
        if self.imagenet_norm_input:
            img = imagenet_to_unit(img)
        b = left.shape[0]
        feats = self.feature(img)
        stem_2 = self.stem_2(img)
        f0 = torch.cat([feats[0], self.stem_4(stem_2)], dim=-1)   # 96
        match = conv_nhwc(self.desc, self.conv(f0))
        d4 = self.max_disp // 4
        gwc = build_gwc_volume(match[:b].contiguous(),
                               match[b:].contiguous(), d4, GWC_GROUPS)
        gwc = self.corr_feature_att(self.corr_stem(gwc), f0[:b])
        gev = self.cost_agg(gwc, [f0[:b]] + [f[:b] for f in feats[1:]])
        cost = channels_last(self.classifier(channels_first(gev)))[..., 0]
        init_disp = disparity_regression(torch.softmax(cost.float(), dim=1),
                                         d4)
        return gev, init_disp, match, stem_2[:b], img[:b]

    def _forward(self, left, right, iters, dtype):
        b = left.shape[0]
        gev, disp, match, stem_2x, img1 = self.geometry(left, right)
        levels, radius = self.corr_levels, self.corr_radius
        geo_pyr = build_volume_pyramid(gev.permute(0, 2, 3, 1, 4).to(dtype),
                                       levels)
        ml, mr = match[:b], match[b:]
        offs = ()
        if self.corr_impl == "banded":
            db = band_d_max(self.max_disp // 4, ml.shape[2])
            m4 = max(self.band_margin // 4, 1)
            offs = band_offsets(levels, db, radius, m4)
            corr_pyr = tuple(c.to(dtype) for c in build_corr_band_pyramid(
                ml.to(dtype), mr.to(dtype), levels, db, radius, m4,
                normalize=False))
        else:
            corr_pyr = build_corr_pyramid(all_pairs_correlation(
                ml.float(), mr.float(), normalize=False), levels)
        cnet_out = self.cnet(img1)
        nets = tuple(torch.tanh(h) for h, _ in cnet_out)
        contexts = self.context(cnet_out)
        _, h4, w4 = disp.shape
        x0 = torch.arange(w4, dtype=torch.float32,
                          device=left.device).expand(b, h4, w4)
        for _ in range(iters):
            geo = combined_geo_lookup(geo_pyr, corr_pyr, disp, x0, radius,
                                      offs)
            nets, mask_feat, delta = self.update_block(nets, contexts, geo,
                                                       disp[..., None])
            disp = disp + delta[..., 0].float()
        spx = self.spx_gru(self.spx_2_gru(mask_feat, stem_2x))
        return context_upsample(disp * 4.0,
                                torch.softmax(spx.float(), dim=-1))


__all__ = ["GEVHourglass", "IGEVStereo", "IGEVUpdateBlock",
           "combined_geo_lookup"]
