"""Disparity estimators: map a D-axis probability volume to disparity
(PyTorch).

Counterpart of ``stereo_toolbox_tpu/disparity_estimators/__init__.py``:
the soft argmax, the argmax, the unimodal estimator (the soft argmax inside
the mode that holds the argmax) and ADL's dominant-modal estimator (CVPR'24:
blur, the top mode and the runner-up, the heavier one's soft argmax).
Probability volumes are ``[B, D, H, W]``, already normalised over D;
outputs are ``[B, H, W]`` in the volume's type; the mode bounds are int32
``[B, 1, H, W]``. Plain tensor functions on either device: the JAX
package's estimators reach no Pallas kernel. Among ties the argmax is the
first index (``torch.argmax`` and ``jnp.argmax`` both document it).
"""

from __future__ import annotations

import torch


def softargmax_disparity_estimator(prob: torch.Tensor,
                                   maxdisp: int | None = None
                                   ) -> torch.Tensor:
    """The expectation of the disparity under `prob`."""
    d = maxdisp if maxdisp is not None else prob.shape[1]
    values = torch.arange(d, dtype=prob.dtype, device=prob.device)
    return torch.einsum("bdhw,d->bhw", prob, values)


def argmax_disparity_estimator(prob: torch.Tensor,
                               maxdisp: int | None = None) -> torch.Tensor:
    """The most probable disparity (the first among ties)."""
    del maxdisp
    return torch.argmax(prob, dim=1).to(prob.dtype)


def _positions(d: int, device) -> torch.Tensor:
    return torch.arange(d, dtype=torch.int32, device=device)[None, :, None,
                                                             None]


def mode_bounds(prob: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(index, index_l, index_r)``, each int32 ``[B, 1, H, W]``: the
    argmax and the bounds of the mode that holds it. With virtual values of
    1 beyond both ends, ``index_l`` is the largest k ≤ argmax where ``p[k] <
    p[k−1]`` (0 by default) and ``index_r`` is one before the first k >
    argmax where ``p[k] > p[k−1]`` (D − 1 by default)."""
    d = prob.shape[1]
    idx = torch.argmax(prob, dim=1, keepdim=True).to(torch.int32)
    pos = _positions(d, prob.device)
    diff = torch.diff(prob, dim=1)         # p[k + 1] − p[k], k in 0..D−2
    # k = 0 falls from the virtual 1 wherever p[0] < 1
    falling = torch.cat([prob[:, :1] < 1.0, diff < 0], dim=1)
    zero = torch.zeros((), dtype=torch.int32, device=prob.device)
    index_l = torch.where(falling & (pos <= idx), pos, zero).amax(
        dim=1, keepdim=True)
    # the first rise at or after the peak; the virtual rise past the right
    # end gives D − 1
    rises_next = torch.cat([diff > 0, torch.zeros_like(prob[:, :1],
                                                       dtype=torch.bool)],
                           dim=1)
    last = torch.full((), d - 1, dtype=torch.int32, device=prob.device)
    index_r = torch.where(rises_next & (pos >= idx), pos, last).amin(
        dim=1, keepdim=True)
    return idx, index_l, index_r


def modal_mask(prob: torch.Tensor) -> torch.Tensor:
    """``[B, D, H, W]`` boolean mask of the mode that holds the argmax, or,
    where that mode is too asymmetric (``|2·idx − l − r| ≥ 3``), of the
    symmetric window of radius ``min(r − idx, idx − l)`` around the
    argmax."""
    idx, index_l, index_r = mode_bounds(prob)
    pos = _positions(prob.shape[1], prob.device)
    mode = (pos >= index_l) & (pos <= index_r)
    r = torch.minimum(index_r - idx, idx - index_l)
    window = (pos >= idx - r) & (pos <= idx + r)
    return torch.where((2 * idx - index_r - index_l).abs() < 3, mode, window)


def unimodal_disparity_estimator(prob: torch.Tensor,
                                 maxdisp: int | None = None,
                                 eps: float = 1e-12) -> torch.Tensor:
    """The soft argmax over the mode that holds the argmax (its asymmetric
    bounds, no fallback), renormalised."""
    d = maxdisp if maxdisp is not None else prob.shape[1]
    _, index_l, index_r = mode_bounds(prob)
    pos = _positions(d, prob.device)
    p = prob * ((pos >= index_l) & (pos <= index_r)).to(prob.dtype)
    p = p / (p.sum(dim=1, keepdim=True) + eps)
    return softargmax_disparity_estimator(p, d)


def _box_blur_d(prob: torch.Tensor, k: int = 5) -> torch.Tensor:
    """The `k`-tap box filter along D with zero padding, output the size
    of the input: the k shifted planes summed in order, then divided by
    k."""
    pad = k // 2
    p = torch.nn.functional.pad(prob, (0, 0, 0, 0, pad, pad))
    d = prob.shape[1]
    out = p[:, 0:d]
    for i in range(1, k):
        out = out + p[:, i:i + d]
    return out / k


def dominant_modal_disparity_estimator(prob: torch.Tensor,
                                       maxdisp: int | None = None,
                                       eps: float = 1e-12) -> torch.Tensor:
    """ADL's dominant-modal estimator: blur the volume along D, take the
    mode of the blurred argmax (`modal_mask`) and the runner-up mode of
    what is left, keep whichever carries more probability, and take the
    soft argmax over it, renormalised."""
    d = maxdisp if maxdisp is not None else prob.shape[1]
    blur = _box_blur_d(prob)
    mask = modal_mask(blur)
    y = prob * mask
    z = prob - y
    z = z * modal_mask(blur * ~mask)
    dominant = y.sum(dim=1, keepdim=True) >= z.sum(dim=1, keepdim=True)
    p = torch.where(dominant, y, z)
    p = p / (p.sum(dim=1, keepdim=True) + eps)
    return softargmax_disparity_estimator(p, d)


__all__ = ["argmax_disparity_estimator", "dominant_modal_disparity_estimator",
           "modal_mask", "mode_bounds", "softargmax_disparity_estimator",
           "unimodal_disparity_estimator"]
