"""Linear resizing with PyTorch ``F.interpolate`` semantics, over any axes.

Counterpart of ``stereo_toolbox_tpu/ops/upsample.py`` (`_resize_axis_linear`,
`interpolate`): separable, one axis at a time, in both ``align_corners``
modes, on channels-last or any other layout.
"""

from __future__ import annotations

import torch


def _resize_axis_linear(x: torch.Tensor, axis: int, out_size: int,
                        align_corners: bool) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    pos = torch.arange(out_size, dtype=torch.float32, device=x.device)
    if align_corners and out_size > 1:
        pos = pos * ((in_size - 1) / max(out_size - 1, 1))
    else:
        pos = (pos + 0.5) * (in_size / out_size) - 0.5
    lo = torch.clamp(torch.floor(pos), 0, in_size - 1)
    w = torch.clamp(pos - lo, 0.0, 1.0).to(x.dtype)
    lo_i = lo.long()
    hi_i = torch.clamp(lo_i + 1, 0, in_size - 1)
    shape = [1] * x.dim()
    shape[axis] = out_size
    w = w.reshape(shape)
    xl = torch.index_select(x, axis, lo_i)
    xh = torch.index_select(x, axis, hi_i)
    return xl * (1 - w) + xh * w


def interpolate(x: torch.Tensor, size: tuple[int, ...],
                axes: tuple[int, ...], align_corners: bool = True
                ) -> torch.Tensor:
    """Separable multi-linear resize of `axes` to `size` (bilinear /
    trilinear ``F.interpolate`` semantics in the chosen corner mode)."""
    if len(size) != len(axes):
        raise ValueError(f"size {size} and axes {axes} differ in length")
    for s, a in zip(size, axes):
        x = _resize_axis_linear(x, a, s, align_corners)
    return x
