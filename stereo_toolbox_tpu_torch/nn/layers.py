"""Conv/BN blocks shared by the cost-volume models (PyTorch).

Counterpart of ``stereo_toolbox_tpu/nn/layers.py``. Every block takes and
returns channels-last tensors (``[B, H, W, C]`` or ``[B, D, H, W, C]``), as
the JAX blocks do; cuDNN sees the channels-first view of the same memory
(``movedim`` copies nothing). Submodules are numbered like the original
toolbox's ``convbn``/``convbn_3d`` Sequentials (``0`` = conv, ``1`` = BN), so
a model's ``state_dict`` carries the original PyTorch parameter names.

In eval mode a 3D 3×3×3, stride-1, undilated, padding-1 ConvBNAct folds its
BatchNorm into a per-channel affine and runs `ops.conv3d_fused` (the CUDA
kernel on the card): the same condition under which the JAX package takes
its fused lowering. The kernel's epilogue applies ReLU; Mish runs after it,
as in the JAX package's fused lowering. The bias-free 3×3×3 classifier convs
(`Conv3dSame`) run `ops.conv3d` in eval mode. PSMNet's first 3D layer
(`ConcatVolumeConvBNAct`) runs `ops.conv3d_concat_volume` on the features,
never building the concat volume. All three keep what they derive from
their parameters (the folded affine, the packed or permuted weight) per
(device, dtype) between eval forwards (`DerivedCache`), so a warm forward
refolds and copies nothing.

In train mode every conv runs on cuDNN (the kernels have no backward) and
every BatchNorm normalises with its batch statistics (of the global batch
in a data-parallel step) and updates its running statistics by flax's rule
(`FlaxRunningStats`: the biased batch variance), as the JAX package trains.
"""

from __future__ import annotations

import math
from collections import OrderedDict

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch import parallel
from stereo_toolbox_tpu_torch.ops.conv3d import (conv3d,
                                                 conv3d_concat_volume,
                                                 pack_concat_conv3d_weight)
from stereo_toolbox_tpu_torch.ops.conv3d_fused import (conv3d_fused,
                                                       pack_conv3d_weight)

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class FlaxRunningStats:
    """Mixin for a BatchNorm whose train-mode update is flax's: normalise
    with the batch statistics, then ``running = (1 − m) · running + m ·
    batch`` with the **biased** batch variance, where PyTorch's own
    BatchNorm writes the unbiased one (``n / (n − 1)`` larger: 0.5% at 200
    values a channel). ``momentum=None`` is PyTorch's cumulative average.
    Eval mode, the parameters and the buffers are PyTorch's.

    PyTorch's own update runs inside ``F.batch_norm``, in one pass over
    `x`; the unbiased part ``m · var · n / (n − 1)`` is then scaled back to
    ``m · var`` per channel.

    A bfloat16 `x` (a bfloat16 train step; the weight, bias and running
    statistics stay float32) is normalised as flax's
    ``BatchNorm(dtype=bfloat16)`` does it: the batch statistics and the
    normalisation in float32 on x widened exactly, the running statistics
    updated in float32, the output rounded to bfloat16 once. The widening
    is explicit, so that the CPU and the card take the same float32 path
    whatever mixed-type ``F.batch_norm`` calls each accepts.

    Inside ``parallel.global_batch_statistics(mesh)`` (a data-parallel
    train step) the batch statistics are those of the global batch, as
    flax's BatchNorm takes them over a sharded batch (`_GlobalBatchNorm`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if x.dtype == torch.bfloat16:
            return self.forward(x.float()).to(torch.bfloat16)
        self._check_input_dim(x)
        self.num_batches_tracked += 1
        m = (self.momentum if self.momentum is not None
             else 1.0 / int(self.num_batches_tracked))
        mesh = parallel.batch_statistics_mesh()
        if mesh is not None:
            return self._global_forward(x, m, mesh)
        # the op keeps the variance it updates for its backward: update a
        # copy, then write the corrected value into the buffer
        kept = (1.0 - m) * self.running_var
        var = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, var, self.weight, self.bias,
                         True, m, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            self.running_var.copy_((var - kept) * ((n - 1) / n) + kept)
        return y

    def _global_forward(self, x: torch.Tensor, m: float,
                        mesh) -> torch.Tensor:
        """Train mode over the global batch (`_GlobalBatchNorm`), then the
        running statistics' update with its mean and biased variance."""
        y, mean, var = _GlobalBatchNorm.apply(x, self.weight, self.bias,
                                              self.eps, mesh)
        with torch.no_grad():
            buffers = [self.running_mean, self.running_var]
            torch._foreach_mul_(buffers, 1.0 - m)
            torch._foreach_add_(buffers, [mean, var], alpha=m)
        return y


def widened(x: torch.Tensor) -> torch.Tensor:
    """`x` in at least float32 (flax's float32 reductions)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


class InstanceNorm(nn.Module):
    """flax ``GroupNorm(group_size=1, use_scale=False, use_bias=False)`` on
    a channels-last ``[B, H, W, C]`` tensor: each channel's mean and
    ``E[x²] − E[x]²`` over H, W in float32, the output in x's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = widened(x)
        mu = xf.mean(dim=(1, 2), keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=(1, 2), keepdim=True) - mu * mu,
                          min=0.0)
        return ((xf - mu) * torch.rsqrt(var + BN_EPS)).to(x.dtype)


def _channel_view(t: torch.Tensor, dim: int) -> torch.Tensor:
    return t.view((1, -1) + (1,) * (dim - 2))


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    """x's layout: channels-last where its strides are (the port's
    ``channels_first`` view of an NDHWC tensor), else contiguous."""
    fmt = {4: torch.channels_last, 5: torch.channels_last_3d}.get(x.dim())
    if fmt is not None and x.is_contiguous(memory_format=fmt):
        return fmt
    return torch.contiguous_format


def _bn_elemt(x, weight, bias, mean, invstd):
    """``(x − mean) · (scale · invstd) + bias`` per channel: flax's
    normalisation; on a card PyTorch's fused ``batch_norm_elemt``."""
    if x.is_cuda:
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, 0.0)
    mul = invstd if weight is None else invstd * weight
    y = (x - _channel_view(mean, x.dim())) * _channel_view(mul, x.dim())
    return y if bias is None else y + _channel_view(bias, x.dim())


def _bn_backward_reduce(dy, x, mean, invstd, weight, grads):
    """Per channel Σdy, Σdy·(x − mean), and the scale's and the bias's
    gradients (`grads`: whether x's, the scale's and the bias's are
    wanted); on a card PyTorch's fused ``batch_norm_backward_reduce``."""
    if x.is_cuda:
        return torch.batch_norm_backward_reduce(dy, x, mean, invstd, weight,
                                                *grads)
    dims = [0, *range(2, x.dim())]
    sum_dy = dy.sum(dims)
    sum_dy_xmu = (dy * (x - _channel_view(mean, x.dim()))).sum(dims)
    return (sum_dy, sum_dy_xmu, sum_dy_xmu * invstd if grads[1] else None,
            sum_dy if grads[2] else None)


def _bn_backward_elemt(dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu,
                       count):
    """x's gradient from the global Σdy and Σdy·(x − mean) over `count`
    values a channel: ``scale · invstd · (dy − Σdy / n − (x − mean) ·
    invstd² · Σdy·(x − mean) / n)``; on a card PyTorch's fused
    ``batch_norm_backward_elemt``."""
    if x.is_cuda:
        return torch.batch_norm_backward_elemt(
            dy, x, mean, invstd, weight, sum_dy, sum_dy_xmu,
            count.to(torch.int32))
    d = x.dim()
    mul = invstd if weight is None else invstd * weight
    xmu = x - _channel_view(mean, d)
    return (dy - _channel_view(sum_dy / count, d)
            - xmu * _channel_view(invstd * invstd * sum_dy_xmu / count, d)
            ) * _channel_view(mul, d)


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BatchNorm over the global batch of a mesh, as flax's
    `_compute_stats` computes it over a sharded batch: each channel's
    count, Σx and Σx² summed over the ranks in one all-reduce, the mean
    and the biased variance ``max(0, E[x²] − E[x]²)`` from them, and
    ``(x − mean) · (scale · rsqrt(var + eps)) + bias``. The backward sums
    Σdy and Σdy·(x − mean) over the ranks in one all-reduce, from which
    each rank's input gradient follows (SyncBatchNorm's backward). The
    count is the global one: a channel may hold one value on a rank
    (PSMNet's SPP at B = 1). Returns the output, the mean and the
    variance (for the running statistics; no gradient)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        x = x.contiguous(memory_format=_memory_format(x))
        c, dims = x.shape[1], [0, *range(2, x.dim())]
        local = torch.cat([x.sum(dims), (x * x).sum(dims),
                           x.new_full((1,), x.numel() // c)])
        sums = parallel.all_reduce_sum([local], mesh)[0]
        count = sums[2 * c:]
        mean, mean2 = sums[:2 * c].view(2, c) / count
        var = (mean2 - mean * mean).clamp_min_(0.0)
        invstd = (var + eps).rsqrt_()
        ctx.mesh = mesh
        ctx.save_for_backward(x, weight, mean, invstd, count)
        ctx.mark_non_differentiable(mean, var)
        return _bn_elemt(x, weight, bias, mean, invstd), mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, count = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dy = dy.contiguous(memory_format=_memory_format(x))
        sum_dy, sum_dy_xmu, dw, db = _bn_backward_reduce(
            dy, x, mean, invstd, weight, (need_x, need_w, need_b))
        dx = None
        if need_x:
            sum_dy, sum_dy_xmu = parallel.all_reduce_sum(
                [sum_dy, sum_dy_xmu], ctx.mesh)
            dx = _bn_backward_elemt(dy, x, mean, invstd, weight, sum_dy,
                                    sum_dy_xmu, count)
        return dx, dw, db, None, None


class BatchNorm2d(FlaxRunningStats, nn.BatchNorm2d):
    pass


class BatchNorm3d(FlaxRunningStats, nn.BatchNorm3d):
    pass


_CONV = {2: nn.Conv2d, 3: nn.Conv3d}
_BN = {2: BatchNorm2d, 3: BatchNorm3d}


def _tuple(v, n: int) -> tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


ACTIVATIONS = {"relu": F.relu, "mish": F.mish, None: lambda x: x}


def activate(x: torch.Tensor, act: str | None) -> torch.Tensor:
    """``act`` of ``{"relu", "mish", None}`` applied to `x`."""
    return ACTIVATIONS[act](x)


def avg_pool(x: torch.Tensor, window, stride=None) -> torch.Tensor:
    """Floor-mode average pool over the spatial axes of a channels-last
    ``[B, *spatial, C]`` tensor, no padding (torch ``AvgPool``)."""
    n = x.dim() - 2
    window = _tuple(window, n)
    stride = _tuple(stride if stride is not None else window, n)
    pool = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[n]
    return channels_last(pool(channels_first(x), window, stride))


def channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(-1, 1)


def channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.movedim(1, -1)


class DerivedCache:
    """Mixin for a module whose eval forward derives kernel arguments from
    its parameters and buffers. `derived` keeps each such value per key
    while every tensor it came from is the same tensor, at the same version
    (in-place edits and ``load_state_dict`` bump it) and the same address
    (``.to()`` moves it); ``train()`` and ``eval()`` drop them all."""

    def train(self, mode: bool = True):
        self.__dict__["_derived"] = {}
        return super().train(mode)

    def derived(self, key, sources, build):
        """``build()`` (run without autograd), or the value it gave for
        `key` while `sources` are unchanged."""
        cache = self.__dict__.setdefault("_derived", {})
        stamp = [(t, t._version, t.data_ptr()) for t in sources]
        hit = cache.get(key)
        if hit is not None and all(
                a is b and va == vb and pa == pb
                for (a, va, pa), (b, vb, pb) in zip(hit[0], stamp)):
            return hit[1]
        with torch.no_grad():
            value = build()
        cache[key] = (stamp, value)
        return value


class ConvBNAct(DerivedCache, nn.Sequential):
    """Bias-free conv (2D or 3D) → BatchNorm → activation `act` (``"relu"``,
    ``"mish"`` or None).

    ``forward(x, residual=None)``: with a residual, ``act(bn(conv(x)) +
    residual)`` — the epilogue of the fused kernel.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size=3, stride=1, padding=None, dilation=1,
                 dims: int = 2, act: str | None = "relu"):
        k = _tuple(kernel_size, dims)
        s = _tuple(stride, dims)
        d = _tuple(dilation, dims)
        p = (tuple((kk - 1) // 2 * dd for kk, dd in zip(k, d))
             if padding is None else _tuple(padding, dims))
        super().__init__(
            _CONV[dims](in_channels, out_channels, k, s, p, d, bias=False),
            _BN[dims](out_channels, eps=BN_EPS, momentum=BN_MOMENTUM))
        if act not in ACTIVATIONS:
            raise ValueError(f"act {act!r} is not relu, mish or None")
        self.act = act
        self.fusible = (dims == 3 and k == (3, 3, 3) and s == (1, 1, 1)
                        and d == (1, 1, 1) and p == (1, 1, 1))

    def folded_affine(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Eval BatchNorm as float32 ``(scale, bias)``:
        ``scale = γ / √(var + eps)``, ``bias = β − mean · scale``."""
        bn = self[1]
        scale = bn.weight.float() * torch.rsqrt(bn.running_var.float()
                                                + bn.eps)
        return scale, bn.bias.float() - bn.running_mean.float() * scale

    def fused_arguments(self, x: torch.Tensor):
        """``(packed kernel, scale, bias)`` of `ops.conv3d_fused` for x's
        device and dtype, kept between eval forwards (`DerivedCache`)."""
        conv, bn = self[0], self[1]

        def build():
            kernel = conv.weight.permute(2, 3, 4, 1, 0).to(x.dtype)
            return (pack_conv3d_weight(kernel), *self.folded_affine())
        return self.derived((x.device, x.dtype),
                            (conv.weight, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var), build)

    def forward(self, x: torch.Tensor,
                residual: torch.Tensor | None = None) -> torch.Tensor:
        if self.fusible and not self.training:
            kernel, scale, bias = self.fused_arguments(x)
            y = conv3d_fused(
                x.contiguous(), kernel, scale, bias,
                None if residual is None else residual.contiguous(),
                relu=self.act == "relu")
            return y if self.act == "relu" else activate(y, self.act)
        y = self[1](self[0](channels_first(x)))
        if residual is not None:
            y = y + channels_first(residual)
        return channels_last(activate(y, self.act))


class ConcatVolumeConvBNAct(ConvBNAct):
    """ReLU(BatchNorm(3×3×3 conv)) over the masked concat volume of two
    ``[B, H, W, channels]`` feature maps at depth `max_disp`, computed
    without building the volume (`ops.conv3d_concat_volume`): PSMNet's
    first 3D layer. Its parameters are ``ConvBNAct(2 · channels,
    out_channels, 3, dims=3)``'s, the original's ``convbn_3d``. In eval
    mode the BatchNorm is folded into the layer's 2D kernels, packed for
    the depth per (device, dtype) and kept between forwards
    (`DerivedCache`)."""

    def __init__(self, channels: int, out_channels: int, max_disp: int):
        super().__init__(2 * channels, out_channels, 3, 1, dims=3)
        self.max_disp = max_disp

    def forward(self, left: torch.Tensor, right: torch.Tensor
                ) -> torch.Tensor:
        conv, bn = self[0], self[1]
        if self.training:
            y = conv3d_concat_volume(left, right,
                                     conv.weight.permute(2, 3, 4, 1, 0),
                                     self.max_disp)
            return channels_last(F.relu(bn(channels_first(y))))
        packed = self.derived(
            (left.device, left.dtype),
            (conv.weight, bn.weight, bn.bias, bn.running_mean,
             bn.running_var),
            lambda: pack_concat_conv3d_weight(
                conv.weight.permute(2, 3, 4, 1, 0), self.max_disp,
                *self.folded_affine(), dtype=left.dtype))
        return conv3d_concat_volume(left, right, packed, self.max_disp,
                                    relu=True)


class Conv3dSame(DerivedCache, nn.Conv3d):
    """Bias-free 3×3×3 conv, stride 1, zero padding 1, on channels-last
    ``[B, D, H, W, Ci]`` → ``[B, D, H, W, Co]`` (the cost-volume
    classifiers). Its parameter is ``nn.Conv3d``'s ``weight [Co, Ci, 3, 3,
    3]``; in eval mode it runs `ops.conv3d` on a contiguous ``[3, 3, 3, Ci,
    Co]`` copy of it in x's type, kept between eval forwards
    (`DerivedCache`)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return channels_last(super().forward(channels_first(x)))
        kernel = self.derived(
            (x.device, x.dtype), (self.weight,),
            lambda: self.weight.permute(2, 3, 4, 1, 0).to(x.dtype)
            .contiguous())
        return conv3d(x.contiguous(), kernel)


def every_other(*mods: nn.Module) -> nn.Sequential:
    """Sequential numbered 0, 2, 4, …: the original toolbox interleaves
    parameter-free activation modules, which the blocks here apply
    themselves, so the parameters keep its indices."""
    return nn.Sequential(OrderedDict((str(2 * i), m)
                                     for i, m in enumerate(mods)))


def classifier(c: int = 32, act: str = "relu") -> nn.Sequential:
    """A cost-volume classifier: 3×3×3 ConvBN-`act` (K2), then the
    bias-free 3×3×3 conv to one channel (K3)."""
    return every_other(ConvBNAct(c, c, 3, 1, dims=3, act=act),
                       Conv3dSame(c, 1))


class ConvTransposeBN(nn.Sequential):
    """``ConvTranspose3d(k=3, s=2, p=1, output_padding=1)`` → BatchNorm: the
    output is exactly twice the input along D, H and W."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(
            nn.ConvTranspose3d(in_channels, out_channels, 3, stride=2,
                               padding=1, output_padding=1, bias=False),
            BatchNorm3d(out_channels, eps=BN_EPS, momentum=BN_MOMENTUM))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return channels_last(super().forward(channels_first(x)))


class BasicResBlock(nn.Module):
    """Two 3×3 conv-BN, `act` after the first, with a residual add and no
    activation after it (the original toolbox's ``BasicBlock``; with
    ``act="mish"`` CFNet's); 2D."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 act: str = "relu"):
        super().__init__()
        self.conv1 = nn.Sequential(
            ConvBNAct(in_channels, planes, 3, stride, dilation=dilation,
                      act=act))
        self.conv2 = ConvBNAct(planes, planes, 3, 1, dilation=dilation,
                               act=None)
        self.downsample = (ConvBNAct(in_channels, planes, 1, stride,
                                     padding=0, act=None)
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.conv1(x))
        if self.downsample is not None:
            x = self.downsample(x)
        return out + x


class HourglassRedir(nn.Module):
    """3D hourglass with 1×1 ``redir`` skips, `act` in all six places
    (GwcNet's with ReLU; CFNet's ``HourglassMish`` with Mish);
    channels-last. An `attention_block` (a module on ``[B, D, H, W, 4c]``)
    is applied to ``conv4``'s output: ACVNet's ``HourglassAttn``."""

    def __init__(self, c: int, act: str = "relu",
                 attention_block: nn.Module | None = None):
        super().__init__()
        self.act = act
        self.conv1 = nn.Sequential(ConvBNAct(c, 2 * c, 3, 2, dims=3, act=act))
        self.conv2 = nn.Sequential(ConvBNAct(2 * c, 2 * c, 3, 1, dims=3,
                                             act=act))
        self.conv3 = nn.Sequential(ConvBNAct(2 * c, 4 * c, 3, 2, dims=3,
                                             act=act))
        self.conv4 = nn.Sequential(ConvBNAct(4 * c, 4 * c, 3, 1, dims=3,
                                             act=act))
        self.conv5 = ConvTransposeBN(4 * c, 2 * c)
        self.conv6 = ConvTransposeBN(2 * c, c)
        self.redir1 = ConvBNAct(c, c, 1, 1, 0, dims=3, act=None)
        self.redir2 = ConvBNAct(2 * c, 2 * c, 1, 1, 0, dims=3, act=None)
        self.attention_block = attention_block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c2 = self.conv2(self.conv1(x))
        c4 = self.conv4(self.conv3(c2))
        if self.attention_block is not None:
            c4 = self.attention_block(c4)
        c5 = activate(self.conv5(c4) + self.redir2(c2), self.act)
        return activate(self.conv6(c5) + self.redir1(x), self.act)


class FeatureAtt(nn.Module):
    """A 2D feature map gating every disparity plane of a cost volume
    (IGEV's ``FeatureAtt``): ``sigmoid(feat_att(feat))[:, None] · cv``,
    ``feat_att`` a 1×1 ConvBN-LeakyReLU to half the feature's channels and
    a 1×1 conv (with bias) to the volume's. ``cv [B, D, H, W, Cv]``,
    ``feat [B, H, W, Cf]``."""

    def __init__(self, cv_channels: int, feat_channels: int):
        super().__init__()
        from stereo_toolbox_tpu_torch.nn.igev_blocks import BasicConvBN
        self.feat_att = nn.Sequential(
            BasicConvBN(feat_channels, feat_channels // 2, 1),
            nn.Conv2d(feat_channels // 2, cv_channels, 1))

    def forward(self, cv: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        conv = self.feat_att[1]
        att = channels_last(conv(channels_first(self.feat_att[0](feat))))
        return torch.sigmoid(att)[:, None] * cv


def dual_view_apply(feat_fn, left: torch.Tensor, right: torch.Tensor,
                    train: bool = False):
    """Run a shared feature trunk on both views. In train mode: two calls,
    left then right, so that each view gets its own BatchNorm batch
    statistics and the running statistics are updated twice, in that
    order (JAX's ``nn.layers.dual_view_apply``). In eval: one call on the
    views batched together, which gives the same result as two calls with
    running BatchNorm statistics. `feat_fn` returns a dict of tensors."""
    if train:
        return feat_fn(left), feat_fn(right)
    b = left.shape[0]
    both = feat_fn(torch.cat([left, right], dim=0))
    return ({k: v[:b] for k, v in both.items()},
            {k: v[b:] for k, v in both.items()})


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The original toolbox's initialisation, drawn from `generator`:
    conv weights ~ N(0, 2 / (k_volume · out_channels)), BatchNorm γ = 1,
    β = 0; biases 0. Linear weights (ACVNet's attention), which the original
    leaves to PyTorch's default, ~ N(0, 1 / in_features)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, m.in_features ** -0.5,
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose3d)):
                n = math.prod(m.kernel_size) * m.out_channels
                m.weight.normal_(0.0, math.sqrt(2.0 / n), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                m.weight.fill_(1.0)
                m.bias.zero_()


def lecun_init(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation (flax's defaults), drawn from
    `generator`: conv (2D and 3D, transposed too) and Linear weights ~ N(0,
    1 / fan_in), biases 0, BatchNorm γ = 1, β = 0. The iterative models
    take it: under `init_weights`' larger draws their 32 random update
    blocks turn float32 rounding into hundreds of px."""
    convs = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d,
             nn.Linear)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, convs):
                w = m.weight
                transposed = isinstance(m, (nn.ConvTranspose2d,
                                            nn.ConvTranspose3d))
                fan_in = w.shape[0] * w[0, 0].numel() if transposed \
                    else w[0].numel()
                w.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.BatchNorm3d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
