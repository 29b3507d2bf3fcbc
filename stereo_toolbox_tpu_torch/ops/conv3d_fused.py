"""Fused 3×3×3 conv + eval BatchNorm affine (+ residual) (+ ReLU).

Counterpart of ``stereo_toolbox_tpu/ops/pallas/conv3d_fused.py``, with the
same arguments and layouts: ``x [B, D, H, W, Ci]``, ``kernel [3, 3, 3, Ci,
Co]``, ``scale``/``bias`` ``[Co]`` float32, optional ``residual [B, D, H, W,
Co]``. Stride 1, zero padding 1.

`conv3d_fused` launches a hand-written CUDA kernel (``csrc/conv3d_fused.cu``)
on a CUDA tensor, one design per type: bfloat16 runs the tensor-core
implicit GEMM ("mma"), float32 the direct convolution on the CUDA cores
("simt", held to 1e-4 with TF32 off). On a CPU tensor it runs the plain
PyTorch version, `conv3d_fused_reference`. Both kernels take the weight
packed by `pack_conv3d_weight`; the wrapper packs a ``[3, 3, 3, Ci, Co]``
kernel on each call unless it is given a `PackedConv3dWeight` (as the eval
`nn.layers.ConvBNAct` does, from its cache). `conv3d_fused_gemm_reference`
computes the conv in the tensor-core kernel's order from the packed weight;
the CPU tests use it and nothing on the main path does.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.ops import _cuda

CI_ALIGN = 16    # the tensor-core kernel's K chunk (input channels a stage)
CO_ALIGN = 64    # its widest output-channel tile
# Tiles of the tensor-core kernel, indexed as its `tile` argument: (H rows of
# a 32-wide W tile, output channels)
MMA_TILES = ((4, 64), (8, 32), (8, 16), (2, 32))
SIMT_TILE = (4 * 32, 32)   # the float32 kernel's voxels and output channels


class PackedConv3dWeight(NamedTuple):
    """A 3×3×3 kernel in the CUDA kernels' layout: ``data [27, Co_pad,
    Ci_pad]`` (tap = kd·9 + kh·3 + kw; Ci_pad a multiple of 16, Co_pad of
    64, zeros in the padding), and the unpadded ``ci``, ``co``."""
    data: torch.Tensor
    ci: int
    co: int

    def kernel(self) -> torch.Tensor:
        """The ``[3, 3, 3, Ci, Co]`` view of the packed weight."""
        return (self.data[:, :self.co, :self.ci].unflatten(0, (3, 3, 3))
                .transpose(3, 4))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_conv3d_weight(kernel: torch.Tensor) -> PackedConv3dWeight:
    """``kernel [3, 3, 3, Ci, Co]`` → `PackedConv3dWeight` in its dtype and
    on its device (one copy)."""
    if kernel.dim() != 5 or kernel.shape[:3] != (3, 3, 3):
        raise ValueError(f"kernel {tuple(kernel.shape)} is not [3, 3, 3, Ci, "
                         f"Co]")
    ci, co = kernel.shape[3:]
    data = kernel.new_zeros((27, _round_up(co, CO_ALIGN),
                             _round_up(ci, CI_ALIGN)))
    data[:, :co, :ci] = kernel.reshape(27, ci, co).transpose(1, 2)
    return PackedConv3dWeight(data, ci, co)


def mma_tile(b: int, d: int, h: int, w: int, co: int, sms: int) -> int:
    """Index into `MMA_TILES` of the tensor-core kernel's tile for an output
    ``[b, d, h, w, co]`` on a card of `sms` SMs: the widest output-channel
    tile Co needs, or 64 voxels × 32 channels where that grid would be under
    two blocks an SM."""
    tile = 0 if co > 32 else 1 if co > 16 else 2
    rows, n = MMA_TILES[tile]
    blocks = b * d * -(-h // rows) * -(-w // 32) * -(-co // n)
    return tile if blocks >= 2 * sms else 3


def _defaults(x, co, scale, bias):
    if scale is None:
        scale = torch.ones(co, dtype=torch.float32, device=x.device)
    if bias is None:
        bias = torch.zeros(co, dtype=torch.float32, device=x.device)
    return scale, bias


def _epilogue(y, x, scale, bias, residual, relu):
    """``relu?(y · scale + bias + residual?)`` in float32, cast to x's
    type."""
    scale, bias = _defaults(x, y.shape[-1], scale, bias)
    y = y.float() * scale + bias
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def conv3d_fused_reference(x: torch.Tensor,
                           kernel: torch.Tensor | PackedConv3dWeight,
                           scale: torch.Tensor | None = None,
                           bias: torch.Tensor | None = None,
                           residual: torch.Tensor | None = None,
                           relu: bool = False) -> torch.Tensor:
    """Plain version: ``F.conv3d`` on the channels-first view, then the
    epilogue in float32, cast back to ``x.dtype``. Takes the kernel as
    ``[3, 3, 3, Ci, Co]`` or packed."""
    if isinstance(kernel, PackedConv3dWeight):
        kernel = kernel.kernel()
    w = kernel.permute(4, 3, 0, 1, 2)                       # [Co, Ci, 3, 3, 3]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1).permute(0, 2, 3, 4, 1)
    return _epilogue(y, x, scale, bias, residual, relu)


def conv3d_fused_gemm_reference(x: torch.Tensor, packed: PackedConv3dWeight,
                                scale: torch.Tensor | None = None,
                                bias: torch.Tensor | None = None,
                                residual: torch.Tensor | None = None,
                                relu: bool = False) -> torch.Tensor:
    """Plain version in the tensor-core kernel's order: float32 products of
    the packed weight with shifted slices of the zero-padded input, summed
    over kd, then 16-channel chunks (Ci zero-padded to Ci_pad), then the 9
    (kh, kw) taps; the epilogue in float32, cast back to ``x.dtype``."""
    b, d, h, w, ci = x.shape
    _, co_pad, ci_pad = packed.data.shape
    xp = F.pad(x.float(), (0, ci_pad - ci, 1, 1, 1, 1, 1, 1))
    wk = packed.data.float()
    acc = torch.zeros((b, d, h, w, co_pad), dtype=torch.float32,
                      device=x.device)
    for kd in range(3):
        for c0 in range(0, ci_pad, CI_ALIGN):
            for t in range(9):
                kh, kw = divmod(t, 3)
                a = xp[:, kd:kd + d, kh:kh + h, kw:kw + w, c0:c0 + CI_ALIGN]
                acc += a @ wk[kd * 9 + t, :, c0:c0 + CI_ALIGN].T
    return _epilogue(acc[..., :packed.co], x, scale, bias, residual, relu)


def conv3d_fused(x: torch.Tensor, kernel: torch.Tensor | PackedConv3dWeight,
                 scale: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None,
                 relu: bool = False) -> torch.Tensor:
    """``relu?(conv3d(x, kernel) * scale + bias + residual?)``.

    CPU tensors take `conv3d_fused_reference`; CUDA tensors launch the
    kernel of x's type (contiguous bfloat16: tensor cores; float32: CUDA
    cores) or raise. `kernel` is ``[3, 3, 3, Ci, Co]`` (packed here) or a
    `PackedConv3dWeight`, in x's type; residual in x's type; scale and bias
    float32.
    """
    if _cuda.on_cpu(x):
        return conv3d_fused_reference(x, kernel, scale, bias, residual, relu)
    _cuda.refuse_grad(
        "conv3d_fused (K2)", "Train mode's ConvBNAct runs its conv on cuDNN "
        "and its BatchNorm on batch statistics (model.train())", x,
        kernel.data if isinstance(kernel, PackedConv3dWeight) else kernel,
        scale, bias, residual)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _cuda.dtype_code(x)          # raises on a type no kernel takes
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, D, H, W, Ci] tensor, "
                         f"got {tuple(x.shape)}")
    b, d, h, w, ci = x.shape
    if not isinstance(kernel, PackedConv3dWeight):
        if kernel.dim() != 5 or kernel.shape[:4] != (3, 3, 3, ci):
            raise ValueError(f"kernel {tuple(kernel.shape)} is not [3, 3, 3, "
                             f"{ci}, Co]")
        kernel = pack_conv3d_weight(kernel)
    data, co = kernel.data, kernel.co
    if (kernel.ci != ci or data.shape != (27, _round_up(co, CO_ALIGN),
                                          _round_up(ci, CI_ALIGN))
            or not data.is_contiguous()):
        raise ValueError(f"packed kernel {tuple(data.shape)} (Ci {kernel.ci},"
                         f" Co {co}) does not fit x with Ci {ci}")
    if data.dtype != x.dtype or data.device != x.device:
        raise ValueError("kernel must share x's dtype and device")
    scale, bias = _defaults(x, co, scale, bias)
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.shape != (co,) or t.dtype != torch.float32
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 [{co}] "
                             f"tensor on {x.device}")
    if residual is not None and (
            residual.shape != (b, d, h, w, co) or residual.dtype != x.dtype
            or residual.device != x.device or not residual.is_contiguous()):
        raise ValueError("residual must be a contiguous [B, D, H, W, Co] "
                         "tensor of x's dtype and device")
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    lib = _cuda.library("conv3d_fused")
    args = (x.data_ptr(), data.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            b, d, h, w, ci, co, data.shape[2], data.shape[1], int(relu))
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            props = torch.cuda.get_device_properties(x.device)
            tile = mma_tile(b, d, h, w, co, props.multi_processor_count)
            rc = lib.conv3d_fused_mma(*args, tile, _cuda.stream_of(x))
            rows, n = MMA_TILES[tile]
            design = ("mma", rows * 32, n)
        else:
            rc = lib.conv3d_fused_simt(*args, _cuda.stream_of(x))
            design = ("simt", *SIMT_TILE)
    _cuda.check(lib, rc, "conv3d_fused")
    conv3d_fused.launches += 1
    conv3d_fused.shapes[(b, d, h, w, ci, co, residual is not None,
                         bool(relu))] += 1
    conv3d_fused.designs[design] += 1
    return out


# launches of the kernels, in all, by (B, D, H, W, Ci, Co, residual, relu)
# and by design ("mma" | "simt", voxels, output channels of a block's tile)
conv3d_fused.launches = 0
conv3d_fused.shapes = Counter()
conv3d_fused.designs = Counter()
