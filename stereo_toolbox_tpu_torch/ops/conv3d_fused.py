"""Fused 3×3×3 conv + eval BatchNorm affine (+ residual) (+ ReLU).

Counterpart of ``stereo_toolbox_tpu/ops/pallas/conv3d_fused.py``, with the
same arguments and layouts: ``x [B, D, H, W, Ci]``, ``kernel [3, 3, 3, Ci,
Co]``, ``scale``/``bias`` ``[Co]`` float32, optional ``residual [B, D, H, W,
Co]``. Stride 1, zero padding 1.

`conv3d_fused` launches the hand-written CUDA kernel
(``csrc/conv3d_fused.cu``) on a CUDA tensor and runs the plain PyTorch
version, `conv3d_fused_reference`, on a CPU tensor.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.ops import _cuda


def _defaults(x, co, scale, bias):
    if scale is None:
        scale = torch.ones(co, dtype=torch.float32, device=x.device)
    if bias is None:
        bias = torch.zeros(co, dtype=torch.float32, device=x.device)
    return scale, bias


def conv3d_fused_reference(x: torch.Tensor, kernel: torch.Tensor,
                           scale: torch.Tensor | None = None,
                           bias: torch.Tensor | None = None,
                           residual: torch.Tensor | None = None,
                           relu: bool = False) -> torch.Tensor:
    """Plain version: ``F.conv3d`` on the channels-first view, then the
    epilogue in float32, cast back to ``x.dtype``."""
    scale, bias = _defaults(x, kernel.shape[-1], scale, bias)
    w = kernel.permute(4, 3, 0, 1, 2)                       # [Co, Ci, 3, 3, 3]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, padding=1).permute(0, 2, 3, 4, 1)
    y = y.float() * scale + bias
    if residual is not None:
        y = y + residual.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def conv3d_fused(x: torch.Tensor, kernel: torch.Tensor,
                 scale: torch.Tensor | None = None,
                 bias: torch.Tensor | None = None,
                 residual: torch.Tensor | None = None,
                 relu: bool = False) -> torch.Tensor:
    """``relu?(conv3d(x, kernel) * scale + bias + residual?)``.

    CPU tensors take `conv3d_fused_reference`; CUDA tensors launch the
    kernel (contiguous float32 or bfloat16; kernel and residual in x's type,
    scale and bias float32) or raise.
    """
    if x.device.type == "cpu":
        return conv3d_fused_reference(x, kernel, scale, bias, residual, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, D, H, W, Ci] tensor, "
                         f"got {tuple(x.shape)}")
    b, d, h, w, ci = x.shape
    if kernel.dim() != 5 or kernel.shape[:4] != (3, 3, 3, ci):
        raise ValueError(f"kernel {tuple(kernel.shape)} is not [3, 3, 3, "
                         f"{ci}, Co]")
    co = kernel.shape[4]
    if kernel.dtype != x.dtype or kernel.device != x.device:
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
    code = _cuda.dtype_code(x)
    wk = kernel.permute(3, 0, 1, 2, 4).contiguous()        # [Ci, 3, 3, 3, Co]
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    lib = _cuda.library("conv3d_fused")
    with torch.cuda.device(x.device):
        rc = lib.conv3d_fused(
            x.data_ptr(), wk.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            b, d, h, w, ci, co, int(relu), code, _cuda.stream_of(x))
    _cuda.check(lib, rc, "conv3d_fused")
    conv3d_fused.launches += 1
    conv3d_fused.shapes[(b, d, h, w, ci, co, residual is not None,
                         bool(relu))] += 1
    return out


# launches of the kernel, in all and by (B, D, H, W, Ci, Co, residual, relu)
conv3d_fused.launches = 0
conv3d_fused.shapes = Counter()
