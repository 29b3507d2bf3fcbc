"""Linear and nearest resizing with PyTorch ``F.interpolate`` semantics,
over any axes.

Counterpart of ``stereo_toolbox_tpu/ops/upsample.py`` (`_resize_axis_linear`,
`interpolate`, `resize_nearest`): separable, one axis at a time, in both
``align_corners`` modes, on channels-last or any other layout; and RAFT's
`convex_upsample` and IGEV's `context_upsample`. Also the
bicubic resize matrix of DINOv2's position-embedding interpolation
(`bicubic_matrix`, the port's copy of
``stereo_toolbox_tpu/models/depth_anything_v2.py::_torch_bicubic_matrix``).
"""

from __future__ import annotations

import numpy as np
import torch


def bicubic_matrix(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """``[n_out, n_in]`` float32 row-stochastic matrix of torch
    ``F.interpolate(mode='bicubic', align_corners=False,
    scale_factor=scale)`` along one axis: source ``(i + 0.5) / scale - 0.5``,
    cubic convolution kernel with A = −0.75, taps clamped at the edges."""
    a = -0.75

    def kernel(t):
        t = np.abs(t)
        return np.where(
            t <= 1, (a + 2) * t ** 3 - (a + 3) * t ** 2 + 1,
            np.where(t < 2, a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a,
                     0.0))

    m = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        src = (i + 0.5) / scale - 0.5
        x0 = np.floor(src)
        for j in range(-1, 3):
            idx = int(np.clip(x0 + j, 0, n_in - 1))
            m[i, idx] += kernel(src - (x0 + j))
    return m.astype(np.float32)


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


def resize_nearest(x: torch.Tensor, size: tuple[int, ...],
                   axes: tuple[int, ...]) -> torch.Tensor:
    """Nearest-neighbour resize of `axes` to `size` (PyTorch ``'nearest'``:
    source index ``floor(i · in / out)``)."""
    for s, a in zip(size, axes):
        in_size = x.shape[a]
        idx = torch.floor(torch.arange(s, dtype=torch.float32,
                                       device=x.device) * (in_size / s))
        x = torch.index_select(x, a, idx.long().clamp(0, in_size - 1))
    return x


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """3×3 neighbourhoods of a ``[B, H, W]`` map with zero padding →
    ``[B, H, W, 9]``, window index ``k = 3 · dy + dx`` (``F.unfold``'s
    order)."""
    b, h, w = x.shape
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    return torch.stack([xp[:, i:i + h, j:j + w] for i in range(3)
                        for j in range(3)], dim=-1)


def convex_upsample(disp: torch.Tensor, mask_logits: torch.Tensor,
                    factor: int = 4) -> torch.Tensor:
    """RAFT's convex upsampling: each output subpixel a softmax-weighted
    blend of the 3×3 neighbours of ``factor · disp``. `disp` ``[B, h, w]``,
    `mask_logits` ``[B, h, w, 9 · factor²]`` (k-major, then the subpixel
    row, then its column) → ``[B, h · factor, w · factor]``, in float32."""
    b, h, w = disp.shape
    f = factor
    m = torch.softmax(mask_logits.float().reshape(b, h, w, 9, f, f), dim=3)
    nb = unfold3x3(disp.float() * f)
    up = torch.einsum("bhwkij,bhwk->bhwij", m, nb)
    return up.permute(0, 1, 3, 2, 4).reshape(b, h * f, w * f)


def context_upsample(disp_low: torch.Tensor, up_weights: torch.Tensor,
                     factor: int = 4) -> torch.Tensor:
    """IGEV's superpixel upsampling: the 3×3 neighbourhoods of `disp_low`
    ``[B, h, w]`` (already in full-resolution units; zero padding),
    nearest-upsampled by `factor` and blended with the softmax weights
    `up_weights` ``[B, h · factor, w · factor, 9]`` → ``[B, h · factor, w ·
    factor]``."""
    b, h, w = disp_low.shape
    nb = resize_nearest(unfold3x3(disp_low), (h * factor, w * factor), (1, 2))
    return (nb * up_weights).sum(dim=-1)
