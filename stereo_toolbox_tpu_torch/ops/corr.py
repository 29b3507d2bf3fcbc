"""All-pairs correlation, its pyramid and the windowed 1-D lookup (PyTorch).

Counterpart of ``stereo_toolbox_tpu/ops/corr.py`` (`all_pairs_correlation`,
`avg_pool_last`, `build_corr_pyramid`, `corr_lookup_1d`), the parts that
DEFOMStereo runs. Layouts as there: features ``[B, H, W, C]``, the
correlation ``[B, H, W1, W2]`` (W2 the right image's x axis), a pyramid a
list of ``[B, H, W1, W2 / 2^i]``. The correlation is one batched matrix
product (``torch.matmul``), as JAX leaves it to XLA outside any kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch

from stereo_toolbox_tpu_torch.ops.sampling import sample_1d


def all_pairs_correlation(fmap1: torch.Tensor, fmap2: torch.Tensor,
                          normalize: bool = True) -> torch.Tensor:
    """``[B, H, W1, C]`` · ``[B, H, W2, C]`` → ``[B, H, W1, W2]`` in
    float32, divided by √C where `normalize`."""
    c = fmap1.shape[-1]
    corr = torch.matmul(fmap1.float(), fmap2.float().transpose(-1, -2))
    return corr / (c ** 0.5) if normalize else corr


def avg_pool_last(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Average-pool the last axis by `window` (stride = window, floor)."""
    n_out = x.shape[-1] // window
    x = x[..., :n_out * window]
    return x.reshape(*x.shape[:-1], n_out, window).mean(dim=-1)


def build_corr_pyramid(corr: torch.Tensor, num_levels: int
                       ) -> list[torch.Tensor]:
    """`num_levels` volumes, each half the last axis of the one before."""
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = avg_pool_last(corr)
        pyramid.append(corr)
    return pyramid


def corr_lookup_1d(pyramid: Sequence[torch.Tensor], x: torch.Tensor,
                   radius: int = 4) -> torch.Tensor:
    """Level i sampled at ``x / 2^i + dx``, dx in ``[−r, r]``, linear
    interpolation, zeros out of range: ``[B, H, W1]`` positions (level-0
    scale) → ``[B, H, W1, L · (2r + 1)]``, level-major, dx ascending."""
    dx = torch.arange(-radius, radius + 1, dtype=x.dtype, device=x.device)
    return torch.cat([sample_1d(corr, x[..., None] / (2.0 ** i) + dx)
                      for i, corr in enumerate(pyramid)], dim=-1)


__all__ = ["all_pairs_correlation", "avg_pool_last", "build_corr_pyramid",
           "corr_lookup_1d"]
