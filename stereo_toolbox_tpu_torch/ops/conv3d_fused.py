"""Fused 3×3×3 conv + eval BatchNorm affine (+ residual) (+ ReLU).

Counterpart of ``stereo_toolbox_tpu/ops/pallas/conv3d_fused.py``, with the
same arguments and layouts: ``x [B, D, H, W, Ci]``, ``kernel [3, 3, 3, Ci,
Co]``, ``scale``/``bias`` ``[Co]`` float32, optional ``residual [B, D, H, W,
Co]``. Stride 1, zero padding 1.

`conv3d_fused` launches a hand-written CUDA kernel (``csrc/conv3d_fused.cu``)
on a CUDA tensor: an implicit GEMM on the tensor cores in both types, with
the tile `mma_tile` picks by shape and type. bfloat16 runs ``mma.sync`` m16n8k16
("mma"); float32 runs 3xTF32 on ``mma.sync`` m16n8k8 ("tf32x3": each operand
split into a TF32 high part and a TF32 remainder, three products summed in
float32, held to 1e-4 of the plain version with TF32 off; one TF32 product
would miss that gate). Bound on the card by operations: bfloat16's products
at 989 TF/s, float32's three TF32 products a multiply-add at 495 TF/s. On a
CPU tensor it runs the plain PyTorch version, `conv3d_fused_reference`.
Both designs take the weight packed by `pack_conv3d_weight` (float32 also
split into its TF32 planes there, once); the wrapper packs a ``[3, 3, 3,
Ci, Co]`` kernel on each call unless it is given a `PackedConv3dWeight` (as
the eval `nn.layers.ConvBNAct` does, from its cache).
`conv3d_fused_gemm_reference` (bfloat16) and `conv3d_fused_tf32x3_reference`
(float32) compute the conv in each kernel's order and arithmetic from the
packed weight; the CPU tests use them and nothing on the main path does.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.ops import _cuda
from stereo_toolbox_tpu_torch.utils.precision import tf32_split

# The kernel's K chunk, input channels a stage (32 bytes of a pixel), by type
CI_ALIGN = {torch.bfloat16: 16, torch.float32: 8}
CO_ALIGN = 64    # its widest output-channel tile
# Tiles of the kernel, indexed as its `tile` argument: (H rows of a 32-wide
# W tile, output channels)
MMA_TILES = ((4, 64), (8, 32), (8, 16), (2, 32))
# The design of each type ("mma": bf16 products; "tf32x3": three TF32
# products of split float32 operands)
DESIGNS = {torch.bfloat16: "mma", torch.float32: "tf32x3"}


class PackedConv3dWeight(NamedTuple):
    """A 3×3×3 kernel in the CUDA kernels' layout: ``data [27, Co_pad,
    Ci_pad]`` (tap = kd·9 + kh·3 + kw; Ci_pad a multiple of the type's
    `CI_ALIGN`, Co_pad of 64, zeros in the padding), the unpadded ``ci``,
    ``co``, and for float32 ``split [2, 27, Co_pad, Ci_pad]``, data's TF32
    high parts and TF32 remainders (`tf32_split`), which the float32 kernel
    reads (None for bfloat16)."""
    data: torch.Tensor
    ci: int
    co: int
    split: torch.Tensor | None = None

    def kernel(self) -> torch.Tensor:
        """The ``[3, 3, 3, Ci, Co]`` view of the packed weight."""
        return (self.data[:, :self.co, :self.ci].unflatten(0, (3, 3, 3))
                .transpose(3, 4))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _ci_align(dtype) -> int:
    return CI_ALIGN.get(dtype, CI_ALIGN[torch.bfloat16])


def pack_conv3d_weight(kernel: torch.Tensor) -> PackedConv3dWeight:
    """``kernel [3, 3, 3, Ci, Co]`` → `PackedConv3dWeight` in its dtype and
    on its device (one copy; float32 also its TF32 split)."""
    if kernel.dim() != 5 or kernel.shape[:3] != (3, 3, 3):
        raise ValueError(f"kernel {tuple(kernel.shape)} is not [3, 3, 3, Ci, "
                         f"Co]")
    ci, co = kernel.shape[3:]
    data = kernel.new_zeros((27, _round_up(co, CO_ALIGN),
                             _round_up(ci, _ci_align(kernel.dtype))))
    data[:, :co, :ci] = kernel.reshape(27, ci, co).transpose(1, 2)
    split = (torch.stack(tf32_split(data))
             if kernel.dtype == torch.float32 else None)
    return PackedConv3dWeight(data, ci, co, split)


def mma_tile(b: int, d: int, h: int, w: int, co: int, sms: int,
             dtype=torch.bfloat16) -> int:
    """Index into `MMA_TILES` of the kernel's tile for an output ``[b, d, h,
    w, co]`` of `dtype` on a card of `sms` SMs: the widest output-channel
    tile Co needs (bfloat16) or 256 voxels x 32 channels, 256 x 16 at Co ≤
    16 (float32, whose 128 x 64 tile holds two weight planes a stage: slower
    at every launch shape of the forwards), or 64 voxels × 32 channels
    where that grid would be under two blocks an SM."""
    if dtype == torch.float32:
        tile = 1 if co > 16 else 2
    else:
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


def _taps(x: torch.Tensor, ci_pad: int):
    """x zero-padded by one voxel in D, H, W and to `ci_pad` channels, and
    the slice of it that tap (kd, kh, kw) reads for every output voxel."""
    b, d, h, w, ci = x.shape
    xp = F.pad(x, (0, ci_pad - ci, 1, 1, 1, 1, 1, 1))
    return lambda kd, kh, kw: xp[:, kd:kd + d, kh:kh + h, kw:kw + w]


def conv3d_fused_gemm_reference(x: torch.Tensor, packed: PackedConv3dWeight,
                                scale: torch.Tensor | None = None,
                                bias: torch.Tensor | None = None,
                                residual: torch.Tensor | None = None,
                                relu: bool = False) -> torch.Tensor:
    """Plain version in the bfloat16 kernel's order: float32 products of
    the packed weight with shifted slices of the zero-padded input, summed
    over kd, then 16-channel chunks (Ci zero-padded to Ci_pad), then the 9
    (kh, kw) taps; the epilogue in float32, cast back to ``x.dtype``."""
    _, co_pad, ci_pad = packed.data.shape
    tap = _taps(x.float(), ci_pad)
    wk = packed.data.float()
    chunk = CI_ALIGN[torch.bfloat16]
    acc = x.new_zeros((*x.shape[:4], co_pad), dtype=torch.float32)
    for kd in range(3):
        for c0 in range(0, ci_pad, chunk):
            for t in range(9):
                a = tap(kd, *divmod(t, 3))[..., c0:c0 + chunk]
                acc += a @ wk[kd * 9 + t, :, c0:c0 + chunk].T
    return _epilogue(acc[..., :packed.co], x, scale, bias, residual, relu)


def conv3d_fused_tf32x3_reference(x: torch.Tensor,
                                  packed: PackedConv3dWeight,
                                  scale: torch.Tensor | None = None,
                                  bias: torch.Tensor | None = None,
                                  residual: torch.Tensor | None = None,
                                  relu: bool = False,
                                  terms: int = 3) -> torch.Tensor:
    """Plain version in the float32 kernel's order and arithmetic: the
    zero-padded input split into TF32 high parts and remainders
    (`tf32_split`, as the kernel splits each fragment), the packed weight's
    two planes, and for each kd, 8-channel chunk and (kh, kw) tap the
    products lo·hi + hi·lo + hi·hi summed in float32; the epilogue in
    float32. ``terms=1`` keeps hi·hi alone: one TF32 product, what TF32
    mode computes, which the tests use to show that the float32 gate tells
    the two apart."""
    if terms not in (1, 3):
        raise ValueError(f"terms must be 1 or 3, got {terms}")
    _, co_pad, ci_pad = packed.data.shape
    split = (packed.split if packed.split is not None
             else torch.stack(tf32_split(packed.data.float())))
    xh, xl = (_taps(part, ci_pad) for part in tf32_split(x))
    chunk = CI_ALIGN[torch.float32]
    acc = x.new_zeros((*x.shape[:4], co_pad), dtype=torch.float32)
    for kd in range(3):
        for c0 in range(0, ci_pad, chunk):
            for t in range(9):
                kh, kw = divmod(t, 3)
                ah = xh(kd, kh, kw)[..., c0:c0 + chunk]
                bh, bl = split[:, kd * 9 + t, :, c0:c0 + chunk].transpose(1, 2)
                if terms == 3:
                    al = xl(kd, kh, kw)[..., c0:c0 + chunk]
                    acc += al @ bh
                    acc += ah @ bl
                acc += ah @ bh
    return _epilogue(acc[..., :packed.co], x, scale, bias, residual, relu)


def conv3d_fused(x: torch.Tensor, kernel: torch.Tensor | PackedConv3dWeight,
                 scale: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None,
                 relu: bool = False) -> torch.Tensor:
    """``relu?(conv3d(x, kernel) * scale + bias + residual?)``.

    CPU tensors take `conv3d_fused_reference`; CUDA tensors launch the
    kernel's design for x's type (contiguous bfloat16: "mma"; float32:
    "tf32x3") or raise. `kernel` is ``[3, 3, 3, Ci, Co]`` (packed here) or a
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
                                          _round_up(ci, _ci_align(x.dtype)))
            or not data.is_contiguous()):
        raise ValueError(f"packed kernel {tuple(data.shape)} (Ci {kernel.ci},"
                         f" Co {co}) does not fit x with Ci {ci}")
    if data.dtype != x.dtype or data.device != x.device:
        raise ValueError("kernel must share x's dtype and device")
    # what the kernel reads: bfloat16 the packed weight, float32 its TF32
    # planes
    weights = data
    if x.dtype == torch.float32:
        weights = kernel.split
        if (weights is None or weights.shape != (2, *data.shape)
                or weights.dtype != x.dtype or weights.device != x.device
                or not weights.is_contiguous()):
            raise ValueError("a float32 packed kernel needs its contiguous "
                             "TF32 split [2, 27, Co_pad, Ci_pad] on x's "
                             "device")
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
    design = DESIGNS[x.dtype]
    with torch.cuda.device(x.device):
        props = torch.cuda.get_device_properties(x.device)
        tile = mma_tile(b, d, h, w, co, props.multi_processor_count,
                        x.dtype)
        rc = getattr(lib, f"conv3d_fused_{design}")(
            x.data_ptr(), weights.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), None if residual is None else residual.data_ptr(),
            out.data_ptr(), b, d, h, w, ci, co, data.shape[2], data.shape[1],
            int(relu), tile, _cuda.stream_of(x))
    _cuda.check(lib, rc, "conv3d_fused")
    conv3d_fused.launches += 1
    conv3d_fused.shapes[(b, d, h, w, ci, co, residual is not None,
                         bool(relu))] += 1
    rows, n = MMA_TILES[tile]
    conv3d_fused.designs[(design, rows * 32, n)] += 1
    return out


# launches of the kernels, in all, by (B, D, H, W, Ci, Co, residual, relu)
# and by design ("mma" | "tf32x3", voxels, output channels of a block's
# tile)
conv3d_fused.launches = 0
conv3d_fused.shapes = Counter()
conv3d_fused.designs = Counter()
