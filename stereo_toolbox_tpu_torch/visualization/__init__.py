"""Disparity / error map visualization (NumPy; matplotlib only for the
Spectral_r map, imported where it is drawn).

The port's own copy of ``stereo_toolbox_tpu/visualization/__init__.py``,
with its parity targets (the original toolbox's visualization/):
  * `colored_disparity_map_Spectral_r` — disparity_map.py:13-37 (the
    original uses cv2+cmapy; this uses matplotlib's Spectral_r directly,
    the same colormap)
  * `colored_disparity_map_KITTI` — disparity_map.py:40-82 (KITTI devkit
    piecewise-linear 8-anchor map)
  * `colored_error_map_KITTI` — error_map.py:14-69 (log-bucketed
    error/threshold map, invalid → black)

All functions take ``[H, W]`` arrays (numpy, or tensors on any device) and
return ``[H, W, 3]`` uint8 RGB (the original returns BGR for cv2.imwrite;
this stays RGB and converts only when saving via PIL).
"""

from __future__ import annotations

import os

import numpy as np

# KITTI stereo devkit disparity colormap anchors (RGB in [0,1], weight column)
_KITTI_MAP = np.array([
    [0, 0, 0], [0, 0, 1], [1, 0, 0], [1, 0, 1],
    [0, 1, 0], [0, 1, 1], [1, 1, 0], [1, 1, 1]], np.float64)
_KITTI_BINS = np.array(
    [0.0, 0.114, 0.299, 0.413, 0.587, 0.701, 0.886, 1.0])
_KITTI_WEIGHTS = 1.0 / np.maximum(np.diff(_KITTI_BINS, append=1.0), 1e-9)
_KITTI_WEIGHTS[-1] = 0.0

# KITTI devkit error-map buckets: (lo, hi) in units of error/threshold → RGB
_ERROR_BUCKETS = np.array([
    [0.0, 0.0625, 49, 54, 149],
    [0.0625, 0.125, 69, 117, 180],
    [0.125, 0.25, 116, 173, 209],
    [0.25, 0.5, 171, 217, 233],
    [0.5, 1, 224, 243, 248],
    [1, 2, 254, 224, 144],
    [2, 4, 253, 174, 97],
    [4, 8, 244, 109, 67],
    [8, 16, 215, 48, 39],
    [16, 1e9, 165, 0, 38]])


def _save(img_rgb: np.ndarray, save_file: str | None) -> None:
    if save_file is None:
        return
    from PIL import Image
    d = os.path.dirname(save_file)
    if d and not os.path.exists(d):
        os.makedirs(d, exist_ok=True)
    Image.fromarray(img_rgb).save(save_file)


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):              # a tensor, on any device
        x = x.detach().float().cpu().numpy()
    return np.squeeze(np.asarray(x)).astype(np.float64)


def colored_disparity_map_Spectral_r(disp, maxval: float = 0,
                                     save_file: str | None = None
                                     ) -> np.ndarray:
    """Spectral_r-colored disparity (disparity_map.py:13-37)."""
    import matplotlib
    disp = _to_numpy(disp)
    if maxval == 0:
        maxval = np.max(np.where(np.isinf(disp), -np.inf, disp))
    x = np.clip(disp / max(maxval, 1e-9), 0.0, 1.0)
    rgba = matplotlib.colormaps["Spectral_r"](x)
    out = (rgba[..., :3] * 255).astype(np.uint8)
    _save(out, save_file)
    return out


def colored_disparity_map_KITTI(disp, maxval: float = 0,
                                save_file: str | None = None) -> np.ndarray:
    """KITTI devkit piecewise-linear disparity colormap
    (disparity_map.py:40-82). Zero/negative disparity → black."""
    disp = _to_numpy(disp)
    if maxval == 0:
        maxval = np.max(np.where(np.isinf(disp), -np.inf, disp))
    v = np.clip(disp / max(maxval, 1e-9), 0.0, 1.0)

    idx = np.clip(np.searchsorted(_KITTI_BINS, v, side="right") - 1, 0, 6)
    lo = _KITTI_BINS[idx]
    w = 1.0 - (v - lo) * _KITTI_WEIGHTS[idx]
    w = np.clip(w, 0.0, 1.0)[..., None]
    c0 = _KITTI_MAP[idx]
    c1 = _KITTI_MAP[np.clip(idx + 1, 0, 7)]
    rgb = w * c0 + (1 - w) * c1
    rgb = rgb * (disp > 0)[..., None]
    out = (rgb * 255).astype(np.uint8)
    _save(out, save_file)
    return out


def colored_error_map_KITTI(pred, gt, save_file: str | None = None,
                            maxdisp: int = 192,
                            threshold: float = 3.0) -> np.ndarray:
    """Log-bucketed error map; invalid GT → black (error_map.py:14-69)."""
    pred = _to_numpy(pred)
    gt = _to_numpy(gt)
    assert pred.shape == gt.shape and pred.ndim == 2
    n_error = np.abs(gt - pred) / threshold
    out = np.zeros(pred.shape + (3,), np.float64)
    for lo, hi, r, g, b in _ERROR_BUCKETS:
        m = (n_error >= lo) & (n_error < hi)
        out[m] = (r, g, b)
    valid = (gt > 0) & (gt < maxdisp - 1)
    out[~valid] = 0
    out = out.astype(np.uint8)
    _save(out, save_file)
    return out
