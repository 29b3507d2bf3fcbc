"""Disparity evaluation metrics (PyTorch).

Counterpart of ``stereo_toolbox_tpu/metrics/__init__.py``, with its
protocol:

  * valid pixels: ``(gt > 0) & (gt < maxdisp - 1)``, NaN ground truth
    invalid;
  * EPE = mean |pred - gt| over valid pixels, per image;
  * outlier rate(τ) = fraction of valid pixels with |pred - gt| > τ;
  * metrics are averaged **per image**, not pooled over pixels;
  * occ = valid ∧ ¬noc.

Every mean is `where`-weighted (`masked_mean`), so an empty mask gives 0
and no shape depends on the data.
"""

from __future__ import annotations

import torch

DEFAULT_MAX_DISP = 192


def valid_mask(gt_disp: torch.Tensor,
               max_disp: int = DEFAULT_MAX_DISP) -> torch.Tensor:
    """Boolean validity mask; NaN GT (absent) is invalid."""
    finite = torch.isfinite(gt_disp)
    gt = torch.where(finite, gt_disp, torch.zeros_like(gt_disp))
    return finite & (gt > 0) & (gt < max_disp - 1)


def masked_mean(x: torch.Tensor, mask: torch.Tensor,
                axis=None) -> torch.Tensor:
    """Mean of x over mask; 0 where the mask is empty."""
    m = mask.to(x.dtype)
    if axis is None:
        num, den = (x * m).sum(), m.sum()
    else:
        num, den = (x * m).sum(dim=axis), m.sum(dim=axis)
    return torch.where(den > 0, num / den.clamp(min=1),
                       torch.zeros_like(num))


def end_point_error(pred: torch.Tensor, gt: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Per-image EPE: ``[B, H, W]`` inputs → ``[B]``."""
    gt = torch.where(mask, gt, torch.zeros_like(gt))
    return masked_mean((pred - gt).abs(), mask, axis=(1, 2))


def outlier_rate(pred: torch.Tensor, gt: torch.Tensor, mask: torch.Tensor,
                 threshold: float) -> torch.Tensor:
    """Per-image fraction (in [0, 1]) of valid pixels with error >
    threshold."""
    gt = torch.where(mask, gt, torch.zeros_like(gt))
    out = ((pred - gt).abs() > threshold) & mask
    return masked_mean(out.to(pred.dtype), mask, axis=(1, 2))


def epe_and_outliers(pred: torch.Tensor, gt: torch.Tensor,
                     mask: torch.Tensor,
                     thresholds=(1.0, 2.0, 3.0)) -> dict:
    """Per-image EPE and outlier rates, and the per-image valid count:
    ``{'epe', 'valid', 'out_1px', ...}`` of ``[B]`` tensors. Images with no
    valid pixel report 0; the caller excludes them by ``valid > 0``."""
    res = {"epe": end_point_error(pred, gt, mask),
           "valid": mask.sum(dim=(1, 2))}
    for t in thresholds:
        res[f"out_{int(t)}px"] = outlier_rate(pred, gt, mask, t)
    return res


def occ_noc_split(mask: torch.Tensor, noc_mask: torch.Tensor):
    """(all, noc, occ) masks; noc = all ∧ (noc_mask > 0.5), occ = all ∧
    ¬noc. A NaN in `noc_mask` (an absent noc file) counts as occluded: where
    the whole mask is NaN, noc is empty and occ is every valid pixel, as
    the JAX package's code computes (its docstring says the opposite)."""
    noc = torch.isfinite(noc_mask) & (noc_mask > 0.5) & mask
    return mask, noc, mask & ~noc


__all__ = ["DEFAULT_MAX_DISP", "end_point_error", "epe_and_outliers",
           "masked_mean", "occ_noc_split", "outlier_rate", "valid_mask"]
