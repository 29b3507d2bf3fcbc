"""All-pairs correlation, its pyramids and the windowed 1-D lookups
(PyTorch).

Counterpart of ``stereo_toolbox_tpu/ops/corr.py``: `all_pairs_correlation`,
`avg_pool_last`, `build_corr_pyramid`, `corr_lookup_1d` and its
memory-light `corr_lookup_1d_alt`; the disparity-banded volumes
(`band_d_max`, `band_offsets`, `build_corr_band_pyramid`,
`corr_lookup_1d_banded`) that RAFTStereo and IGEVStereo look up by default;
IGEV's geometry-encoding-volume pyramid (`build_volume_pyramid`,
`volume_lookup_1d`). Layouts as there: features ``[B, H, W, C]``, the
correlation ``[B, H, W1, W2]`` (W2 the right image's x axis), a pyramid a
list of ``[B, H, W1, W2 / 2^i]``. The correlations are batched matrix
products (``torch.matmul``), as JAX leaves them to XLA outside any kernel.
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


def corr_lookup_1d_alt(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       x: torch.Tensor, radius: int = 4, num_levels: int = 4,
                       h_chunk: int = 16, normalize: bool = True
                       ) -> torch.Tensor:
    """`corr_lookup_1d` of the pyramid of ``all_pairs_correlation(fmap1,
    fmap2)``, computed `h_chunk` rows at a time, so that the ``[B, H, W1,
    W2]`` volume is never held whole (RAFT's ``corr_impl='alt'``): ``[B, H,
    W1]`` positions → ``[B, H, W1, num_levels · (2r + 1)]``."""
    out = [corr_lookup_1d(build_corr_pyramid(
        all_pairs_correlation(f1, f2, normalize), num_levels), xc, radius)
        for f1, f2, xc in zip(fmap1.split(h_chunk, 1),
                              fmap2.split(h_chunk, 1), x.split(h_chunk, 1))]
    return torch.cat(out, dim=1)


def band_d_max(d_max: int | None, width: int) -> int:
    """The banded volumes' reach at the 1/4 grid: `d_max` capped at the
    feature map's `width` (``None``: the whole width, every lookup of a
    disparity ≥ −margin answered as the all-pairs volume answers it)."""
    return width if d_max is None else min(d_max, width)


def band_offsets(num_levels: int, d_max: int, radius: int = 4,
                 margin: int = 8) -> tuple[tuple[int, int], ...]:
    """Each level's (lo, hi) offset bounds: level i covers ``dx − disp /
    2^i`` for ``dx ∈ [−radius, radius]`` and ``disp ∈ [−margin, d_max +
    margin]``, ``lo_i = −⌈(d_max + margin) / 2^i⌉ − radius``, ``hi_i =
    radius + 1 + ⌈margin / 2^i⌉``."""
    def ceil_div(a: int, b: int) -> int:
        return -((-a) // b)

    return tuple((-ceil_div(d_max + margin, 2 ** i) - radius,
                  radius + 1 + ceil_div(margin, 2 ** i))
                 for i in range(num_levels))


def build_corr_band_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                            num_levels: int, d_max: int, radius: int = 4,
                            margin: int = 8, normalize: bool = True
                            ) -> tuple[torch.Tensor, ...]:
    """The disparity-banded relative correlation volumes: level i holds
    ``band_i[b, h, w, j] = <f1[b, h, w], f2_i[b, h, ⌊w / 2^i⌋ + lo_i + j]>``
    (÷ √C where `normalize`) for ``j ∈ [0, hi_i − lo_i]``, with ``f2_i``
    fmap2 average-pooled in pairs along W i times (floor: a tail column is
    dropped), and zero where ``⌊w / 2^i⌋ + lo_i + j`` leaves ``[0,
    W_i)``, ``W_i`` the pooled row's length. That is JAX's zero edge: it
    shifts the pooled row repeated 2^i times, and zero-pads it to W1 where
    pooling truncated; both edges land where the pooled index leaves the
    pooled row.

    Each level is the all-pairs correlation of fmap1 with ``f2_i``
    (`all_pairs_correlation`, float32) gathered at the band: level 0 is
    `build_corr_pyramid`'s first volume's band, bit for bit; higher levels
    pool the features before the product, as JAX does, which re-associates
    the pooled correlation's sum. The bands are float32; pooled bfloat16
    features are rounded to bfloat16 once a level, as JAX's bfloat16 mean
    is. Returns ``[B, H, W1, hi_i − lo_i + 1]`` a level."""
    offs = band_offsets(num_levels, d_max, radius, margin)
    w1 = fmap1.shape[2]
    bands, f2 = [], fmap2
    for i, (lo, hi) in enumerate(offs):
        if i > 0:
            b, h, n, c = f2.shape
            f2 = f2[:, :, :n // 2 * 2].float().reshape(
                b, h, n // 2, 2, c).mean(dim=3).to(fmap2.dtype)
        n = f2.shape[2]
        idx = (torch.arange(w1, device=fmap1.device)[:, None] // 2 ** i
               + torch.arange(lo, hi + 1, device=fmap1.device))
        if n == 0:
            bands.append(fmap1.new_zeros(*fmap1.shape[:3], hi - lo + 1,
                                         dtype=torch.float32))
            continue
        corr = all_pairs_correlation(fmap1, f2, normalize)  # [B,H,W1,W_i]
        band = torch.gather(corr, -1, idx.clamp(0, n - 1).expand(
            *corr.shape[:2], -1, -1))
        bands.append(band * ((idx >= 0) & (idx < n)))
    return tuple(bands)


def corr_lookup_1d_banded(bands: Sequence[torch.Tensor], x: torch.Tensor,
                          offs: Sequence[tuple[int, int]],
                          radius: int = 4) -> torch.Tensor:
    """`corr_lookup_1d` on the banded volumes (`offs` from `band_offsets`,
    as built): level i sampled at ``x / 2^i + dx − ⌊w / 2^i⌋ − lo_i``;
    ``[B, H, W1]`` positions → ``[B, H, W1, L · (2r + 1)]``."""
    dx = torch.arange(-radius, radius + 1, dtype=x.dtype, device=x.device)
    w = torch.arange(x.shape[-1], device=x.device)
    out = []
    for i, (band, (lo, _)) in enumerate(zip(bands, offs)):
        base = (w // 2 ** i).to(x.dtype)[:, None]
        out.append(sample_1d(band, x[..., None] / 2 ** i + dx - base - lo))
    return torch.cat(out, dim=-1)


def build_volume_pyramid(volume: torch.Tensor, num_levels: int
                         ) -> list[torch.Tensor]:
    """`num_levels` ``[B, H, W, D_i, C]`` volumes, each the one before
    average-pooled in pairs along D (floor), in the volume's type."""
    pyramid = [volume]
    for _ in range(num_levels - 1):
        d = volume.shape[-2] // 2
        v = volume[..., :2 * d, :].float()
        volume = v.reshape(*v.shape[:-2], d, 2, v.shape[-1]).mean(
            dim=-2).to(volume.dtype)
        pyramid.append(volume)
    return pyramid


def volume_lookup_1d(pyramid: Sequence[torch.Tensor], x: torch.Tensor,
                     radius: int = 4) -> torch.Tensor:
    """Each ``[B, H, W, D_i, C]`` volume sampled along D at ``x / 2^i +
    dx``: ``[B, H, W]`` positions → ``[B, H, W, L · C · (2r + 1)]``,
    level-major, then channel-major, dx minor (the reference's flatten)."""
    dx = torch.arange(-radius, radius + 1, dtype=x.dtype, device=x.device)
    out = []
    for i, vol in enumerate(pyramid):
        pos = x[..., None] / 2 ** i + dx                  # [B, H, W, K]
        s = sample_1d(vol.movedim(-1, -2), pos[..., None, :])
        out.append(s.flatten(-2))
    return torch.cat(out, dim=-1)


__all__ = ["all_pairs_correlation", "avg_pool_last", "band_d_max",
           "band_offsets", "build_corr_band_pyramid", "build_corr_pyramid",
           "build_volume_pyramid", "corr_lookup_1d", "corr_lookup_1d_alt",
           "corr_lookup_1d_banded", "volume_lookup_1d"]
