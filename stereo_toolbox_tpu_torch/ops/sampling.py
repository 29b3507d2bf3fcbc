"""Linear interpolation along the last axis (PyTorch).

Counterpart of ``sample_1d`` in ``stereo_toolbox_tpu/ops/sampling.py``, its
gather path: two reads a position, zeros outside ``[0, N − 1]``. The dense
hat-kernel path that JAX takes on the TPU computes the same function with no
gather (a TPU-specific trade); on the card a gather is cheap.
"""

from __future__ import annotations

import torch


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


__all__ = ["sample_1d"]
