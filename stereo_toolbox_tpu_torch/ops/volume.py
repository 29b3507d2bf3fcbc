"""Cost-volume construction and disparity regression (PyTorch).

Counterpart of ``stereo_toolbox_tpu/ops/volume.py``, in the same
channels-last layouts: feature maps ``[B, H, W, C]``, cost volumes
``[B, D, H, W, C]``.

`build_gwc_volume` launches the hand-written CUDA kernel
(``csrc/gwc_volume.cu``) on a CUDA tensor and runs the plain PyTorch version,
`gwc_volume_reference`, on a CPU tensor.
"""

from __future__ import annotations

from collections import Counter

import torch

from stereo_toolbox_tpu_torch.ops import _cuda


def shifted_right_stack(right: torch.Tensor, max_disp: int) -> torch.Tensor:
    """``out[b, d, h, w, c] = right[b, h, w - d, c]`` (zero where w < d).

    Args:
      right: ``[B, H, W, C]``.
      max_disp: number of disparity candidates D.

    Returns:
      ``[B, D, H, W, C]``.
    """
    b, h, w, c = right.shape
    out = right.new_zeros((b, max_disp, h, w, c))
    for d in range(min(max_disp, w)):
        out[:, d, :, d:] = right[:, :, :w - d]
    return out


def groupwise_correlation(fea1: torch.Tensor, fea2: torch.Tensor,
                          num_groups: int) -> torch.Tensor:
    """Per-group mean of elementwise products over the last axis:
    ``[..., C]`` × ``[..., C]`` → ``[..., num_groups]``."""
    c = fea1.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    prod = fea1 * fea2
    return prod.reshape(prod.shape[:-1] + (num_groups, c // num_groups)).mean(-1)


def gwc_volume_reference(left: torch.Tensor, right: torch.Tensor,
                         max_disp: int, num_groups: int) -> torch.Tensor:
    """Plain group-wise correlation volume: the shifted right stack
    correlated with the left features. ``[B, D, H, W, G]``."""
    return groupwise_correlation(left[:, None],
                                 shifted_right_stack(right, max_disp),
                                 num_groups)


def build_gwc_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                     num_groups: int) -> torch.Tensor:
    """Group-wise correlation cost volume ``[B, D, H, W, G]`` (GwcNet):
    ``out[b,d,h,w,g] = mean_{c in g} left[b,h,w,c] * right[b,h,w-d,c]``,
    zero for w < d.

    CPU tensors take `gwc_volume_reference`; CUDA tensors launch the kernel
    (float32 or bfloat16, contiguous ``[B, H, W, C]``) or raise.
    """
    if left.device.type == "cpu":
        return gwc_volume_reference(left, right, max_disp, num_groups)
    if left.device.type != "cuda":
        raise ValueError(f"unsupported device {left.device}")
    if right.shape != left.shape or left.dim() != 4:
        raise ValueError(f"left {tuple(left.shape)} / right "
                         f"{tuple(right.shape)} must be equal [B, H, W, C]")
    if right.device != left.device or right.dtype != left.dtype:
        raise ValueError("left and right must share device and dtype")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("left and right must be contiguous")
    b, h, w, c = left.shape
    if c % num_groups or max_disp < 1:
        raise ValueError(f"bad groups {num_groups} / max_disp {max_disp} "
                         f"for C={c}")
    code = _cuda.dtype_code(left)
    out = torch.empty((b, max_disp, h, w, num_groups), dtype=left.dtype,
                      device=left.device)
    lib = _cuda.library("gwc_volume")
    with torch.cuda.device(left.device):
        rc = lib.gwc_volume(left.data_ptr(), right.data_ptr(), out.data_ptr(),
                            b, h, w, c, max_disp, num_groups, code,
                            _cuda.stream_of(left))
    _cuda.check(lib, rc, "gwc_volume")
    build_gwc_volume.launches += 1
    build_gwc_volume.shapes[(b, h, w, c, max_disp, num_groups)] += 1
    return out


# launches of the kernel, in all and by (B, H, W, C, D, G)
build_gwc_volume.launches = 0
build_gwc_volume.shapes = Counter()


def disparity_regression(prob: torch.Tensor, max_disp: int | None = None,
                         offset: float = 0.0) -> torch.Tensor:
    """Expectation of disparity over ``[B, D, H, W]`` probabilities →
    ``[B, H, W]``."""
    d = max_disp if max_disp is not None else prob.shape[1]
    values = torch.arange(d, dtype=prob.dtype, device=prob.device) + offset
    return torch.einsum("bdhw,d->bhw", prob, values)


def soft_argmax(cost: torch.Tensor, max_disp: int | None = None
                ) -> torch.Tensor:
    """Softmax over D of ``[B, D, H, W]`` costs, then disparity
    regression → ``[B, H, W]``."""
    return disparity_regression(torch.softmax(cost, dim=1), max_disp)
