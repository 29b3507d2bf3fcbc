"""Plain 3×3×3 convolution, stride 1, zero padding 1, no bias.

Counterpart of ``stereo_toolbox_tpu/ops/pallas/conv3d.py``, with the same
arguments and layouts: ``x [B, D, H, W, Ci]``, ``kernel [3, 3, 3, Ci, Co]``,
float32 or bfloat16, accumulation in float32 and the output in x's type. The
JAX kernel's padding of Ci to 128 lanes and of W to 16 sublanes is TPU layout
and has no counterpart here.

`conv3d` launches the hand-written CUDA kernel (``csrc/conv3d.cu``) on a CUDA
tensor and runs the plain PyTorch version, `conv3d_reference`, on a CPU
tensor.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.ops import _cuda


def conv3d_reference(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv3d`` on the channels-first view, float32
    arithmetic for a bfloat16 `x`, cast back to ``x.dtype``."""
    w = kernel.permute(4, 3, 0, 1, 2).float()              # [Co, Ci, 3, 3, 3]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w, padding=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def conv3d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``conv3d(x, kernel)``, SAME padding, ``[B, D, H, W, Co]``.

    CPU tensors take `conv3d_reference`; CUDA tensors launch the kernel
    (contiguous float32 or bfloat16 `x`, `kernel` in x's type) or raise.
    """
    if x.device.type == "cpu":
        return conv3d_reference(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 5 or not x.is_contiguous() or 0 in x.shape:
        raise ValueError(f"x must be a contiguous non-empty [B, D, H, W, Ci] "
                         f"tensor, got {tuple(x.shape)}")
    b, d, h, w, ci = x.shape
    if (kernel.dim() != 5 or kernel.shape[:4] != (3, 3, 3, ci)
            or kernel.shape[4] < 1):
        raise ValueError(f"kernel {tuple(kernel.shape)} is not [3, 3, 3, "
                         f"{ci}, Co]")
    co = kernel.shape[4]
    if kernel.dtype != x.dtype or kernel.device != x.device:
        raise ValueError("kernel must share x's dtype and device")
    code = _cuda.dtype_code(x)
    kernel = kernel.contiguous()
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    lib = _cuda.library("conv3d")
    with torch.cuda.device(x.device):
        rc = lib.conv3d(x.data_ptr(), kernel.data_ptr(), out.data_ptr(),
                        b, d, h, w, ci, co, code, _cuda.stream_of(x))
    _cuda.check(lib, rc, "conv3d")
    conv3d.launches += 1
    conv3d.shapes[(b, d, h, w, ci, co)] += 1
    return out


# launches of the kernel, in all and by (B, D, H, W, Ci, Co)
conv3d.launches = 0
conv3d.shapes = Counter()
