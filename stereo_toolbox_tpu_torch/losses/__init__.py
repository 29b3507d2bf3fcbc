"""Supervised losses (PyTorch).

Counterpart of the supervised part of
``stereo_toolbox_tpu/losses/__init__.py``: the smooth-L1 of PyTorch's
``F.smooth_l1_loss``, its masked mean, the RAFT-style exponentially
weighted sequence loss and the fixed-weight multi-head loss of PSMNet and
GwcNet. Every mean is `where`-weighted (`metrics.masked_mean`), as in JAX,
so an empty mask gives 0. The self-supervised losses are not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch

from stereo_toolbox_tpu_torch.metrics import masked_mean


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber), ``F.smooth_l1_loss`` semantics: the
    quadratic branch for ``|diff| < beta``."""
    diff = (pred - target).abs()
    return torch.where(diff < beta, 0.5 * diff * diff / beta,
                       diff - 0.5 * beta)


def masked_smooth_l1(pred: torch.Tensor, gt: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 averaged over `mask`; masked-out pixels (NaN ground truth
    among them) contribute neither value nor gradient."""
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    gt = torch.where(mask, gt, zero)
    pred = torch.where(mask, pred, zero)
    return masked_mean(smooth_l1(pred, gt), mask)


def sequence_loss(disp_preds: Sequence[torch.Tensor] | torch.Tensor,
                  gt: torch.Tensor, mask: torch.Tensor,
                  init_disp: torch.Tensor | None = None,
                  loss_gamma: float = 0.9) -> torch.Tensor:
    """RAFT-style exponentially weighted smooth-L1 over a prediction
    sequence: ``L1(init) + Σ_i γ'^(n-1-i) L1(pred_i)`` with ``γ' =
    loss_gamma^(15/(n-1))``. `disp_preds` is a list of ``[B, H, W]`` maps
    or a stacked ``[n, B, H, W]`` tensor."""
    preds = list(disp_preds)
    n = len(preds)
    loss = 0.0
    if init_disp is not None:
        loss = masked_smooth_l1(init_disp, gt, mask)
    gamma = loss_gamma ** (15.0 / (n - 1)) if n > 1 else 1.0
    for i, p in enumerate(preds):
        loss = loss + (gamma ** (n - i - 1)) * masked_smooth_l1(p, gt, mask)
    return loss


def multi_head_loss(disp_preds: Sequence[torch.Tensor], gt: torch.Tensor,
                    mask: torch.Tensor,
                    weights: Sequence[float]) -> torch.Tensor:
    """Fixed-weight multi-head smooth-L1 (PSMNet/GwcNet staged heads)."""
    if len(disp_preds) != len(weights):
        raise ValueError(f"{len(disp_preds)} heads, {len(weights)} weights")
    loss = 0.0
    for w, p in zip(weights, disp_preds):
        loss = loss + w * masked_smooth_l1(p, gt, mask)
    return loss


__all__ = ["masked_smooth_l1", "multi_head_loss", "sequence_loss",
           "smooth_l1"]
