"""Bilinear sampling and linear interpolation (PyTorch).

Counterpart of ``stereo_toolbox_tpu/ops/sampling.py``: `coords_grid`,
`bilinear_sampler` (four reads a position, zeros outside ``[0, W − 1] × [0,
H − 1]``, ``F.grid_sample(..., align_corners=True, padding_mode="zeros")``
in pixel coordinates) and ``sample_1d``'s gather path (two reads a
position, zeros outside ``[0, N − 1]``). The dense hat-kernel path that JAX
takes on the TPU computes the same function with no gather (a TPU-specific
trade); on the card a gather is cheap. Channels-last, as the JAX ops.
"""

from __future__ import annotations

import torch


def coords_grid(batch: int, height: int, width: int,
                dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """``[B, H, W, 2]`` grid of (x, y) pixel coordinates (x first)."""
    y, x = torch.meshgrid(torch.arange(height, dtype=dtype, device=device),
                          torch.arange(width, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)[None].expand(batch, height, width, 2)


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor,
                     return_mask: bool = False):
    """Sample `img` ``[B, H, W, C]`` at the real (x, y) pixel positions
    `coords` ``[B, h, w, 2]`` → ``[B, h, w, C]``: the four neighbours of
    each position weighted bilinearly, a neighbour outside ``[0, W − 1] ×
    [0, H − 1]`` read as 0. The position arithmetic stays in `coords`'
    type; the weights are rounded to `img`'s. With `return_mask`, also the
    ``[B, h, w]`` mask of the positions strictly inside ``(0, W − 1) × (0,
    H − 1)``, in `img`'s type."""
    b, h, w, c = img.shape
    x, y = coords[..., 0], coords[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx = (x - x0).to(img.dtype)[..., None]
    wy = (y - y0).to(img.dtype)[..., None]
    flat = img.reshape(b, h * w, c)

    def gather(xi, yi):
        inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long())
        vals = torch.gather(flat, 1, idx.reshape(b, -1, 1).expand(-1, -1, c))
        return vals.reshape(*idx.shape, c) * inside[..., None].to(img.dtype)

    v00, v01 = gather(x0, y0), gather(x0 + 1, y0)
    v10, v11 = gather(x0, y0 + 1), gather(x0 + 1, y0 + 1)
    out = ((1 - wx) * (1 - wy) * v00 + wx * (1 - wy) * v01
           + (1 - wx) * wy * v10 + wx * wy * v11)
    if return_mask:
        mask = (x > 0) & (x < w - 1) & (y > 0) & (y < h - 1)
        return out, mask.to(img.dtype)
    return out


def sample_1d(values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear interpolation of `values` ``[..., N]`` at the real positions
    `x` ``[..., K]`` (batch axes broadcast) → ``[..., K]``.

    ``out = (1 − w) · v[⌊x⌋] + w · v[⌊x⌋ + 1]``, ``w = x − ⌊x⌋``, where a
    read outside ``[0, N − 1]`` gives 0: a position in (−1, 0) weights only
    index 0, one at or past N − 1 only its lower neighbour (and nothing at
    or past N). The position arithmetic stays in `x`'s type (float32 for
    bfloat16 values); only the weight is rounded to the values' type."""
    n = values.shape[-1]
    batch = torch.broadcast_shapes(values.shape[:-1], x.shape[:-1])
    values = values.expand(*batch, n)
    x = x.expand(*batch, x.shape[-1])
    x0 = torch.floor(x)
    w = (x - x0).to(values.dtype)

    def gather(xi):
        inside = (xi >= 0) & (xi <= n - 1)
        idx = torch.clamp(xi, 0, n - 1).long()
        return torch.gather(values, -1, idx) * inside.to(values.dtype)

    return (1 - w) * gather(x0) + w * gather(x0 + 1)


__all__ = ["bilinear_sampler", "coords_grid", "sample_1d"]
