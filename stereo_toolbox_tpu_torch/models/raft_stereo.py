"""RAFT-Stereo (3DV'21): all-pairs correlation and a multi-scale ConvGRU
loop (PyTorch), and the RAFT blocks that DEFOMStereo and IGEVStereo reuse.

Counterpart of ``stereo_toolbox_tpu/models/raft_stereo.py``: ``_norm``,
``RAFTResBlock``, ``BasicEncoder`` (``fnet``), ``MultiBasicEncoder``
(``cnet``), ``BasicMotionEncoder``, ``BasicMultiUpdateBlock`` and
``RAFTStereo`` with its loop step, channels-last like them, with the
original toolbox's module names (``conv1``, ``norm1``, ``layer1..5``,
``downsample.{0,1}``, ``outputs08/16/32``; ``convc1``, ``convc2``,
``convf1``/``convd1``, ``convf2``/``convd2``, ``conv``; ``gru08/16/32``,
``flow_head``/``disp_head``, ``mask``; ``context_zqr_convs``), so a
``state_dict`` carries the original's keys (without its doubly registered
``norm3``, the ``downsample.1`` norm under a second name).

Both norms are the JAX package's in train and eval alike: instance norm is
flax's ``GroupNorm(group_size=1)`` with no scale and no bias, and batch norm
is frozen (``use_running_average=True``, the reference's ``freeze_bn``): it
normalises with its running statistics, which no step updates.

`RAFTStereo` evaluates: ImageNet-normalised ``[B, H, W, 3]`` left/right
images → the last of `valid_iters` iterations' ``[B, H, W]`` disparity,
convex-upsampled (float32). Its correlation is ``corr_impl``'s: ``'banded'``
(the default: the disparity-banded volumes of `ops.corr`, reaching
``band_max_disp + band_margin`` full-resolution pixels), ``'reg'`` (the
all-pairs pyramid) or ``'alt'`` (recomputed rows at a time every
iteration). On the card it launches none of the port's kernels: cuDNN's
convs, cuBLAS's correlation and PyTorch's elementwise ops and gathers. In
bfloat16 the features are float32 before the correlation, the band volumes
bfloat16, the lookup positions, the flow and the convex blend float32, as
in JAX. Train mode is not ported yet (ROADMAP.md, Queue 1 item 5) and
raises. Seeded random weights are drawn as flax draws them
(`nn.layers.lecun_init`).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.nn.gru import ConvGRU, conv_nhwc, pool2x
from stereo_toolbox_tpu_torch.nn.layers import (InstanceNorm, lecun_init,
                                                widened)
from stereo_toolbox_tpu_torch.ops.corr import (
    all_pairs_correlation, band_d_max, band_offsets, build_corr_band_pyramid,
    build_corr_pyramid, corr_lookup_1d, corr_lookup_1d_alt,
    corr_lookup_1d_banded)
from stereo_toolbox_tpu_torch.ops.upsample import convex_upsample, interpolate
from stereo_toolbox_tpu_torch.utils.precision import (compute_dtype,
                                                      full_float32)

NORM_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class FrozenBatchNorm2d(nn.BatchNorm2d):
    """flax ``BatchNorm(use_running_average=True)`` on a channels-last
    tensor, in train mode too: ``(x − mean) · (rsqrt(var + eps) · weight) +
    bias`` in float32 from the running statistics, the output in x's type.
    Its parameters train; its running statistics stay as loaded."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((widened(x) - self.running_mean) * mul + self.bias).to(x.dtype)


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


def res_stages(norm: str) -> list[nn.Sequential]:
    """``layer1..3``: two RAFTResBlocks at widths 64, 96, 128, the first of
    the last two with stride 2."""
    layers, planes = [], 64
    for dim, stride in ((64, 1), (96, 2), (128, 2)):
        layers.append(nn.Sequential(RAFTResBlock(planes, dim, norm, stride),
                                    RAFTResBlock(dim, dim, norm, 1)))
        planes = dim
    return layers


class BasicEncoder(nn.Module):
    """``fnet``: 7×7 stem, `norm`, ReLU, three residual stages (1/4 of the
    image), 1×1 conv to `output_dim`."""

    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, padding=3)
        self.norm1 = make_norm(norm, 64)
        self.layer1, self.layer2, self.layer3 = res_stages(norm)
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.norm1(conv_nhwc(self.conv1, x)))
        return conv_nhwc(self.conv2, self.layer3(self.layer2(self.layer1(x))))


class MultiBasicEncoder(nn.Module):
    """``cnet``: the trunk of `BasicEncoder` with `norm`, then a (hidden,
    context) pair of heads at 1/4, 1/8 and 1/16 of the image: a residual
    block and a 3×3 conv at the two finer scales (`out_names` ``[0]``,
    ``[1]``), a 3×3 conv at the coarsest (``[2]``), after ``layer4`` and
    ``layer5`` (stride 2 each). `out_names` are the original's attributes:
    RAFT's ``outputs08/16/32``, IGEV's ``outputs04/08/16``."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128),
                 context_dims: Sequence[int] = (128, 128, 128),
                 norm: str = "batch",
                 out_names: Sequence[str] = ("outputs08", "outputs16",
                                             "outputs32")):
        super().__init__()
        self.out_names = tuple(out_names)
        self.conv1 = nn.Conv2d(3, 64, 7, padding=3)
        self.norm1 = make_norm(norm, 64)
        self.layer1, self.layer2, self.layer3 = res_stages(norm)
        self.layer4 = nn.Sequential(RAFTResBlock(128, 128, norm, 2),
                                    RAFTResBlock(128, 128, norm, 1))
        self.layer5 = nn.Sequential(RAFTResBlock(128, 128, norm, 2),
                                    RAFTResBlock(128, 128, norm, 1))
        for name, i in zip(self.out_names[:2], (2, 1)):
            setattr(self, name, nn.ModuleList(
                nn.Sequential(RAFTResBlock(128, 128, norm, 1),
                              nn.Conv2d(128, dim, 3, padding=1))
                for dim in (hidden_dims[i], context_dims[i])))
        setattr(self, self.out_names[2], nn.ModuleList(
            nn.Conv2d(128, dim, 3, padding=1)
            for dim in (hidden_dims[0], context_dims[0])))

    def forward(self, x: torch.Tensor) -> list:
        """``[(h, c) at 1/4, (h, c) at 1/8, (h, c) at 1/16]``."""
        x = F.relu(self.norm1(conv_nhwc(self.conv1, x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        fine, mid, coarse = (getattr(self, n) for n in self.out_names)
        out = [tuple(conv_nhwc(o[1], o[0](x)) for o in fine)]
        x = self.layer4(x)
        out.append(tuple(conv_nhwc(o[1], o[0](x)) for o in mid))
        x = self.layer5(x)
        out.append(tuple(conv_nhwc(o, x) for o in coarse))
        return out


class BasicMotionEncoder(nn.Module):
    """Correlation and flow → 128 motion features: the last conv emits
    ``128 − flow_channels``, concatenated with the raw flow. The flow's two
    convs are ``{flow_convs}1`` and ``{flow_convs}2`` (RAFT's ``convf``,
    DEFOM's and IGEV's ``convd``)."""

    def __init__(self, cor_planes: int, flow_channels: int = 1,
                 flow_convs: str = "convd"):
        super().__init__()
        self.flow_convs = flow_convs
        self.convc1 = nn.Conv2d(cor_planes, 64, 1)
        self.convc2 = nn.Conv2d(64, 64, 3, padding=1)
        setattr(self, f"{flow_convs}1",
                nn.Conv2d(flow_channels, 64, 7, padding=3))
        setattr(self, f"{flow_convs}2", nn.Conv2d(64, 64, 3, padding=1))
        self.conv = nn.Conv2d(128, 128 - flow_channels, 3, padding=1)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(conv_nhwc(self.convc2, F.relu(conv_nhwc(self.convc1,
                                                           corr))))
        f1, f2 = (getattr(self, f"{self.flow_convs}{i}") for i in (1, 2))
        f = F.relu(conv_nhwc(f2, F.relu(conv_nhwc(f1, flow))))
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
    """`n_gru_layers` ConvGRUs (1/16 → 1/8 → 1/4 of the 1/4 grid's scales:
    ``gru32``, ``gru16``, ``gru08``; the coarser ones only where they run,
    as JAX creates them), the motion encoder, the flow head (``head``:
    DEFOM's ``disp_head``, RAFT's ``flow_head``) and the convex upsampling
    mask (× 0.25)."""

    def __init__(self, cor_planes: int,
                 hidden_dims: Sequence[int] = (128, 128, 128),
                 factor: int = 4, flow_channels: int = 1,
                 n_gru_layers: int = 3, head: str = "disp_head",
                 flow_convs: str = "convd"):
        super().__init__()
        if n_gru_layers not in (1, 2, 3):
            raise ValueError(f"n_gru_layers {n_gru_layers} is not 1, 2 or 3")
        h32, h16, h08 = hidden_dims
        self.n_gru_layers, self.head = n_gru_layers, head
        self.encoder = BasicMotionEncoder(cor_planes, flow_channels,
                                          flow_convs)
        self.gru08 = ConvGRU(h08, 128 + (h16 if n_gru_layers > 1 else 0))
        if n_gru_layers > 1:
            self.gru16 = ConvGRU(h16, h08 + (h32 if n_gru_layers > 2 else 0))
        if n_gru_layers > 2:
            self.gru32 = ConvGRU(h32, h16)
        setattr(self, head, DispHead(h08, 256, flow_channels))
        self.mask = nn.Sequential(nn.Conv2d(h08, 256, 3, padding=1),
                                  nn.ReLU(inplace=True),
                                  nn.Conv2d(256, factor * factor * 9, 1))

    def forward(self, nets, contexts, corr, flow):
        """``(net08, net16, net32)``, their contexts, the lookup and the
        flow → the new nets, the mask logits and the flow's delta."""
        net08, net16, net32 = nets
        ctx08, ctx16, ctx32 = contexts
        n = self.n_gru_layers
        if n == 3:
            net32 = self.gru32(net32, pool2x(net16), ctx32)
        if n >= 2:
            x16 = [pool2x(net08)]
            if n == 3:
                x16.append(interpolate(net32, net16.shape[1:3], (1, 2), True))
            net16 = self.gru16(net16, torch.cat(x16, dim=-1), ctx16)
        x08 = [self.encoder(flow, corr)]
        if n > 1:
            x08.append(interpolate(net16, net08.shape[1:3], (1, 2), True))
        net08 = self.gru08(net08, torch.cat(x08, dim=-1), ctx08)
        delta = getattr(self, self.head)(net08)
        m = F.relu(conv_nhwc(self.mask[0], net08))
        mask = 0.25 * conv_nhwc(self.mask[2], m)
        return (net08, net16, net32), mask, delta


def imagenet_to_unit(x: torch.Tensor) -> torch.Tensor:
    """ImageNet-normalised images back to ``[−1, 1]``: ``2 · (x · std +
    mean) − 1``, in x's type, as the JAX models compute it."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return 2.0 * (x * std + mean) - 1.0


def context_biases(convs: nn.ModuleList, cnet_out) -> tuple:
    """Each scale's ``(cz, cr, cq)``: the context network's output, ReLU,
    through its ``context_zqr_convs`` conv, split in three."""
    return tuple(tuple(torch.chunk(conv_nhwc(conv, F.relu(c)), 3, dim=-1))
                 for conv, (_, c) in zip(convs, cnet_out))


CORR_IMPLS = ("banded", "reg", "alt")


class RAFTStereo(nn.Module):
    """The JAX package's fields with its defaults (hidden dims 128×3, 4
    correlation levels of radius 4, 3 GRU layers, 32 eval iterations,
    ``corr_impl='banded'`` reaching ``band_max_disp`` 192 + ``band_margin``
    32 full-resolution pixels; ``band_max_disp=None``: the whole width).
    ``forward(left, right, iters=None)``."""

    def __init__(self, hidden_dims: Sequence[int] = (128, 128, 128),
                 corr_levels: int = 4, corr_radius: int = 4,
                 n_downsample: int = 2, n_gru_layers: int = 3,
                 train_iters: int = 22, valid_iters: int = 32,
                 imagenet_norm_input: bool = True, corr_impl: str = "banded",
                 band_max_disp: int | None = 192, band_margin: int = 32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if corr_impl not in CORR_IMPLS:
            raise ValueError(f"corr_impl {corr_impl!r} is not one of "
                             f"{CORR_IMPLS}")
        if n_downsample != 2:
            raise NotImplementedError("RAFTStereo's encoders run at 1/4 "
                                      "(n_downsample 2), as JAX's")
        self.hidden_dims = tuple(hidden_dims)
        self.corr_levels, self.corr_radius = corr_levels, corr_radius
        self.factor = 2 ** n_downsample
        self.train_iters, self.valid_iters = train_iters, valid_iters
        self.imagenet_norm_input = imagenet_norm_input
        self.corr_impl = corr_impl
        self.band_max_disp, self.band_margin = band_max_disp, band_margin
        self.cnet = MultiBasicEncoder(hidden_dims, hidden_dims, "batch")
        self.fnet = BasicEncoder(256, "instance")
        self.context_zqr_convs = nn.ModuleList(
            nn.Conv2d(hidden_dims[i], hidden_dims[i] * 3, 3, padding=1)
            for i in range(3))
        self.update_block = BasicMultiUpdateBlock(
            corr_levels * (2 * corr_radius + 1), hidden_dims, self.factor,
            flow_channels=2, n_gru_layers=n_gru_layers, head="flow_head",
            flow_convs="convf")
        lecun_init(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def forward(self, left: torch.Tensor, right: torch.Tensor,
                iters: int | None = None) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "RAFTStereo trains in a later part of the port (ROADMAP.md, "
                "Queue 1 item 5); its eval forward runs")
        dtype = compute_dtype(self.fnet.conv1.weight, self.training)
        with full_float32(dtype == torch.float32):
            return self._forward(left, right, iters or self.valid_iters,
                                 dtype)

    def correlation(self, fmap1: torch.Tensor, fmap2: torch.Tensor, dtype):
        """The lookup function of the loop, ``x [B, H/4, W/4] → [B, H/4,
        W/4, levels · (2r + 1)]``, over `corr_impl`'s volumes (float32
        features; the bands held in `dtype`)."""
        levels, radius = self.corr_levels, self.corr_radius
        if self.corr_impl == "alt":
            return lambda x: corr_lookup_1d_alt(fmap1, fmap2, x, radius,
                                                levels)
        if self.corr_impl == "reg":
            pyramid = build_corr_pyramid(all_pairs_correlation(fmap1, fmap2),
                                         levels)
            return lambda x: corr_lookup_1d(pyramid, x, radius)
        d4 = band_d_max(None if self.band_max_disp is None
                        else max(self.band_max_disp // self.factor, 1),
                        fmap1.shape[2])
        m4 = max(self.band_margin // self.factor, 1)
        offs = band_offsets(levels, d4, radius, m4)
        bands = tuple(b.to(dtype) for b in build_corr_band_pyramid(
            fmap1.to(dtype), fmap2.to(dtype), levels, d4, radius, m4))
        return lambda x: corr_lookup_1d_banded(bands, x, offs, radius)

    def _forward(self, left, right, iters, dtype):
        img1, img2 = ((imagenet_to_unit(left), imagenet_to_unit(right))
                      if self.imagenet_norm_input else (left, right))
        b = left.shape[0]
        fmaps = self.fnet(torch.cat([img1, img2], dim=0)).float()
        lookup = self.correlation(fmaps[:b], fmaps[b:], dtype)
        cnet_out = self.cnet(img1)
        nets = tuple(torch.tanh(h) for h, _ in cnet_out)
        contexts = context_biases(self.context_zqr_convs, cnet_out)
        _, h4, w4 = fmaps[:b].shape[:3]
        x0 = torch.arange(w4, dtype=torch.float32,
                          device=left.device).expand(b, h4, w4)
        flow_x = torch.zeros(b, h4, w4, device=left.device)
        for _ in range(iters):
            flow = torch.stack([flow_x, torch.zeros_like(flow_x)], dim=-1)
            nets, mask, delta = self.update_block(nets, contexts,
                                                  lookup(x0 + flow_x), flow)
            flow_x = flow_x + delta[..., 0]
        return convex_upsample(-flow_x, mask, self.factor)


__all__ = ["BasicEncoder", "BasicMotionEncoder", "BasicMultiUpdateBlock",
           "DispHead", "FrozenBatchNorm2d", "IMAGENET_MEAN", "IMAGENET_STD",
           "InstanceNorm", "MultiBasicEncoder", "RAFTResBlock", "RAFTStereo",
           "context_biases", "imagenet_to_unit", "make_norm", "res_stages"]
