"""ACVNet (CVPR'22): attention concatenation volume.

Counterpart of ``stereo_toolbox_tpu/models/acvnet.py``. Modules and their
names follow the original toolbox's ``models/ACVNet/acv.py``, so
``state_dict`` keys are its PyTorch names:

  * ``feature_extraction``: GwcNet's trunk, gwc feature only (320 channels);
  * attention branch: the 40-group correlation volume (K1), the ``patch``
    depthwise (1, 3, 3) convs (``patch`` over all 40 channels, then
    ``patch_l1..3`` at dilations 1, 2, 3 over channel slices 8, 16, 16),
    ``dres1_att_``, ``dres2_att_`` (a redir hourglass with block attention
    at its bottleneck) and ``classif_att_`` → ``att_weights [B, D, H, W, 1]``;
  * main branch: ``concatconv`` (3×3 ConvBN-ReLU, bias-free 1×1 to 32) on
    both views, the concat volume with the left features at every d (K6,
    ``mask_left=False``), ``softmax(att_weights, D) × volume``, ``dres0``,
    ``dres1`` (+ ``cost0``), ``dres2``, ``dres3`` and ``classif2``.

Contract: ImageNet-normalised ``[B, H, W, 3]`` left/right images → ``[B, H,
W]`` disparity (float32): ``pred2``, or with `attn_weights_only` the
attention branch's ``pred_attention``. All heads are registered, so the
parameter set is the original's whole. In train mode (float32, or
bfloat16 on a view of float32 masters, ``models.bfloat16_view``) the forward
returns ``[pred_attention, pred0, pred1, pred2]`` (``classif_att_``,
``classif0`` on ``cost0``, ``classif1`` on ``dres2``'s output, ``classif2``),
each regressed at full resolution, with per-view BatchNorm batch statistics
in the 2D trunk and ``concatconv``; with `attn_weights_only`,
``[pred_attention]``. The staged-training flag `freeze_attn_weights` detaches
``att_weights`` (JAX's ``stop_gradient``): the attention branch gets no
gradient, and train mode drops ``pred_attention``.

On the card the full forward launches K1 and K6 once each, K2 on each
stride-1 3×3×3 ConvBN (14) and K3 on the last conv of ``classif_att_`` and
``classif2``. A train step launches K1 and K6 once each and their backward
kernels once each (no K1 backward with `freeze_attn_weights`, no K6 with
`attn_weights_only`); every conv runs on cuDNN. The depthwise ``patch``
convs and the block attention stay plain PyTorch (cuDNN, cuBLAS), as the
JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.models.gwcnet import GwcFeature
from stereo_toolbox_tpu_torch.nn.layers import (ConvBNAct, HourglassRedir,
                                                channels_first, channels_last,
                                                classifier, dual_view_apply,
                                                every_other, init_weights)
from stereo_toolbox_tpu_torch.ops.upsample import interpolate
from stereo_toolbox_tpu_torch.ops.volume import (build_concat_volume,
                                                 build_gwc_volume,
                                                 disparity_regression)
from stereo_toolbox_tpu_torch.utils.precision import (compute_dtype,
                                                      full_float32)

# logit of a key in a block's zero padding (the JAX package's, not -inf)
PAD_LOGIT = -1000.0


class BlockAttention3D(nn.Module):
    """Multi-head self-attention inside each (4, 4, 4) block of a ``[B, D,
    H, W, C]`` volume, zero-padded to whole blocks (padded keys score
    `PAD_LOGIT`), then a 1×1×1 conv with bias. The logits and the softmax
    are float32; the softmax is cast to x's type before it weights v."""

    def __init__(self, channels: int, num_heads: int = 16,
                 block: tuple[int, int, int] = (4, 4, 4)):
        super().__init__()
        self.num_heads, self.block = num_heads, block
        self.qkv_3d = nn.Linear(channels, 3 * channels)
        self.final1x1 = nn.Conv3d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, d0, h0, w0, c = x.shape
        bd, bh, bw = self.block
        x = F.pad(x, (0, 0, 0, -w0 % bw, 0, -h0 % bh, 0, -d0 % bd))
        dd, hh, ww = x.shape[1] // bd, x.shape[2] // bh, x.shape[3] // bw
        t, heads = bd * bh * bw, self.num_heads
        xb = x.reshape(b, dd, bd, hh, bh, ww, bw, c).permute(
            0, 1, 3, 5, 2, 4, 6, 7).reshape(b, dd, hh, ww, t, c)
        q, k, v = self.qkv_3d(xb).reshape(
            b, dd, hh, ww, t, 3, heads, c // heads).unbind(5)
        attn = torch.einsum("bdhwqnc,bdhwknc->bdhwnqk", q.float(),
                            k.float()) * (c // heads) ** -0.5
        if x.shape[1:4] != (d0, h0, w0):
            valid = torch.zeros(x.shape[1:4], dtype=torch.bool,
                                device=x.device)
            valid[:d0, :h0, :w0] = True
            valid = valid.reshape(dd, bd, hh, bh, ww, bw).permute(
                0, 2, 4, 1, 3, 5).reshape(dd, hh, ww, t)
            attn = attn.masked_fill(~valid[None, :, :, :, None, None, :],
                                    PAD_LOGIT)
        attn = torch.softmax(attn, dim=-1).to(x.dtype)
        out = torch.einsum("bdhwnqk,bdhwknc->bdhwqnc", attn, v)
        out = out.reshape(b, dd, hh, ww, bd, bh, bw, c).permute(
            0, 1, 4, 2, 5, 3, 6, 7).reshape(x.shape)[:, :d0, :h0, :w0]
        return F.linear(out, self.final1x1.weight[:, :, 0, 0, 0],
                        self.final1x1.bias)


def _hourglass_attn(c: int) -> HourglassRedir:
    """ACVNet's hourglass: GwcNet's redir hourglass with block attention on
    ``conv4``'s output."""
    return HourglassRedir(c, attention_block=BlockAttention3D(4 * c))


def _depthwise(c: int, dilation: int) -> nn.Conv3d:
    """Depthwise (1, 3, 3) conv, bias-free, at `dilation` in H and W."""
    return nn.Conv3d(c, c, (1, 3, 3), 1, (0, dilation, dilation),
                     (1, dilation, dilation), groups=c, bias=False)


def depthwise_input(x: torch.Tensor, dilation: int) -> torch.Tensor:
    """`x` as a `_depthwise` conv at `dilation` takes it. PyTorch's CPU
    bfloat16 depthwise conv3d returns a wrong weight gradient for a
    channels-last input at a dilation above 1 (1.04-1.13 relative L2 from
    float32's, where the forward, the input gradient, dilation 1 and a
    contiguous input are within bfloat16's 3e-3): on the CPU such an input
    is made contiguous first."""
    if dilation > 1 and x.dtype == torch.bfloat16 and not x.is_cuda:
        return x.contiguous()
    return x


class ACVNet(nn.Module):
    # the original's widths: 40 groups (split 8/16/16 by the patch convs)
    # and 32 concat channels a view
    NUM_GROUPS, CONCAT_CHANNELS = 40, 32

    def __init__(self, max_disp: int = 192, attn_weights_only: bool = False,
                 freeze_attn_weights: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.max_disp = max_disp
        self.attn_weights_only = attn_weights_only
        self.freeze_attn_weights = freeze_attn_weights
        cc = self.CONCAT_CHANNELS
        self.feature_extraction = GwcFeature()
        self.patch = _depthwise(self.NUM_GROUPS, 1)
        self.patch_l1 = _depthwise(8, 1)
        self.patch_l2 = _depthwise(16, 2)
        self.patch_l3 = _depthwise(16, 3)
        self.dres1_att_ = every_other(
            ConvBNAct(self.NUM_GROUPS, 32, 3, 1, dims=3),
            ConvBNAct(32, 32, 3, 1, dims=3, act=None))
        self.dres2_att_ = _hourglass_attn(32)
        self.classif_att_ = classifier()
        self.concatconv = every_other(ConvBNAct(320, 128, 3),
                                      nn.Conv2d(128, cc, 1, bias=False))
        self.dres0 = every_other(ConvBNAct(2 * cc, 32, 3, 1, dims=3),
                                 ConvBNAct(32, 32, 3, 1, dims=3))
        self.dres1 = every_other(ConvBNAct(32, 32, 3, 1, dims=3),
                                 ConvBNAct(32, 32, 3, 1, dims=3, act=None))
        self.dres2 = _hourglass_attn(32)
        self.dres3 = _hourglass_attn(32)
        self.classif0 = classifier()
        self.classif1 = classifier()
        self.classif2 = classifier()
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def _features(self, x: torch.Tensor) -> dict:
        out = self.feature_extraction(x)
        if not self.attn_weights_only:
            cf = self.concatconv[0](out["gwc_feature"])
            out["concat_feature"] = channels_last(
                self.concatconv[1](channels_first(cf)))
        return out

    def _regress(self, cost: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """``[B, D, H/4, W/4, 1]`` costs → ``[B, H, W]`` disparity."""
        cost = interpolate(cost[..., 0], (self.max_disp, h, w), (1, 2, 3),
                           align_corners=False)
        return disparity_regression(torch.softmax(cost.float(), dim=1),
                                    self.max_disp)

    def forward(self, left: torch.Tensor, right: torch.Tensor):
        dtype = compute_dtype(self.classif2[0][0].weight, self.training)
        with full_float32(dtype == torch.float32):
            return self._forward(left, right, dtype)

    def _forward(self, left, right, dtype):
        _, h, w, _ = left.shape
        fl, fr = dual_view_apply(self._features, left.to(dtype),
                                 right.to(dtype), self.training)
        d4 = self.max_disp // 4

        # attention branch
        gwc = build_gwc_volume(fl["gwc_feature"].contiguous(),
                               fr["gwc_feature"].contiguous(), d4,
                               self.NUM_GROUPS)
        gwc = channels_first(gwc)
        gwc = self.patch(gwc)
        patch_volume = channels_last(torch.cat(
            [self.patch_l1(gwc[:, :8]),
             self.patch_l2(depthwise_input(gwc[:, 8:24], 2)),
             self.patch_l3(depthwise_input(gwc[:, 24:40], 3))], dim=1))
        ca = self.dres2_att_(self.dres1_att_(patch_volume))
        att_weights = self.classif_att_[1](self.classif_att_[0](ca))
        if self.freeze_attn_weights:
            att_weights = att_weights.detach()
        if self.attn_weights_only:
            pred_attention = self._regress(att_weights, h, w)
            return [pred_attention] if self.training else pred_attention

        # main branch: the attention-filtered concat volume
        volume = build_concat_volume(fl["concat_feature"].contiguous(),
                                     fr["concat_feature"].contiguous(), d4,
                                     mask_left=False)
        volume = torch.softmax(att_weights, dim=1) * volume
        cost0 = self.dres0(volume)
        cost0 = self.dres1[1](self.dres1[0](cost0), residual=cost0)
        if not self.training:     # no hourglass output is kept
            out2 = self.dres3(self.dres2(cost0))
            return self._regress(self.classif2[1](self.classif2[0](out2)),
                                 h, w)
        out1 = self.dres2(cost0)
        out2 = self.dres3(out1)
        preds = [self._regress(head[1](head[0](x)), h, w)
                 for head, x in ((self.classif0, cost0), (self.classif1, out1),
                                 (self.classif2, out2))]
        if not self.freeze_attn_weights:
            preds = [self._regress(att_weights, h, w)] + preds
        return preds
