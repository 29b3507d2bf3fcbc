"""Train/eval-time augmentation ops, NumPy-only with explicit RNG.

The port's own copy of ``stereo_toolbox_tpu/datasets/augmentation.py``:
the same draws from the same ``np.random.Generator``, so a sample is the
JAX package's for the same seed. Distribution parity with reference datasets/data_augmentation/__init__.py:
  * asymmetric color jitter per image (brightness/contrast/saturation 0.4,
    hue 0.5/3.14 rad, gamma [0.8, 1.2]) — :6-19
  * random crop 384×512 — :22-41
  * random right-image occlusion rectangle (p=0.5) — :44-54
  * eval pad up to multiples of 96 (top + right padding) — :57-80

The reference relies on torchvision's ColorJitter whose op-order is an
implicit global RNG draw; bit-exact stream parity is impossible (SURVEY.md §7
"Augmentation RNG"), so we match the distributions with an explicit
`np.random.Generator` — every sample is reproducible from its seed.
"""

from __future__ import annotations

import numpy as np

PAD_MULTIPLE = 96


def _rgb_to_gray(img: np.ndarray) -> np.ndarray:
    return (0.299 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])


def _adjust_hue(img01: np.ndarray, shift: float) -> np.ndarray:
    """Shift hue by `shift` (in [-0.5, 0.5] turns) via HSV round trip."""
    r, g, b = img01[..., 0], img01[..., 1], img01[..., 2]
    maxc = img01.max(-1)
    minc = img01.min(-1)
    v = maxc
    c = maxc - minc
    s = np.where(maxc > 0, c / np.maximum(maxc, 1e-8), 0.0)
    safe_c = np.maximum(c, 1e-8)
    rc = (maxc - r) / safe_c
    gc = (maxc - g) / safe_c
    bc = (maxc - b) / safe_c
    h = np.where(r == maxc, bc - gc,
                 np.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(c > 0, h, 0.0)

    h = (h + shift) % 1.0
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6
    out = np.zeros_like(img01)
    sextants = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
                (v, p, q)]
    for k, (rr, gg, bb) in enumerate(sextants):
        m = i == k
        out[..., 0] = np.where(m, rr, out[..., 0])
        out[..., 1] = np.where(m, gg, out[..., 1])
        out[..., 2] = np.where(m, bb, out[..., 2])
    return out


def color_jitter(img: np.ndarray, rng: np.random.Generator,
                 brightness: float = 0.4, contrast: float = 0.4,
                 saturation: float = 0.4, hue: float = 0.5 / 3.14,
                 gamma_range: tuple[float, float] = (0.8, 1.2)) -> np.ndarray:
    """Photometric jitter of one uint8 HWC image, random op order + gamma."""
    x = img.astype(np.float32) / 255.0
    ops = list(rng.permutation(4))
    for op in ops:
        if op == 0 and brightness > 0:
            x = x * rng.uniform(1 - brightness, 1 + brightness)
        elif op == 1 and contrast > 0:
            f = rng.uniform(1 - contrast, 1 + contrast)
            mean = _rgb_to_gray(np.clip(x, 0, 1)).mean()
            x = mean + (x - mean) * f
        elif op == 2 and saturation > 0:
            f = rng.uniform(1 - saturation, 1 + saturation)
            gray = _rgb_to_gray(np.clip(x, 0, 1))[..., None]
            x = gray + (x - gray) * f
        elif op == 3 and hue > 0:
            x = _adjust_hue(np.clip(x, 0, 1), rng.uniform(-hue, hue))
        x = np.clip(x, 0, 1)
    g = rng.uniform(*gamma_range)
    x = np.power(x, g)
    return (np.clip(x, 0, 1) * 255.0 + 0.5).astype(np.uint8)


def random_jitter(left: np.ndarray, right: np.ndarray,
                  rng: np.random.Generator):
    """Asymmetric (independent) jitter of the two views
    (data_augmentation/__init__.py:12-19)."""
    return color_jitter(left, rng), color_jitter(right, rng)


def random_crop(left, right, disp=None, mask=None,
                crop_size=(384, 512), rng: np.random.Generator | None = None):
    """Joint random crop (data_augmentation/__init__.py:22-41); crop size is
    clamped to the image."""
    rng = rng or np.random.default_rng()
    H, W = left.shape[:2]
    ch, cw = min(crop_size[0], H), min(crop_size[1], W)
    h = int(rng.integers(0, H - ch + 1))
    w = int(rng.integers(0, W - cw + 1))
    sl = np.s_[h:h + ch, w:w + cw]
    left, right = left[sl], right[sl]
    if disp is not None:
        disp = disp[..., h:h + ch, w:w + cw]
    if mask is not None:
        mask = mask[sl]
    return left, right, disp, mask


def random_mask(right: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """With p=0.5, paste a mean-color rectangle onto the right image
    (occlusion simulation; data_augmentation/__init__.py:44-54 — half-extent
    35-100 rows × 25-75 cols ⇒ 70-200×50-150 px)."""
    right = np.array(right)
    if rng.random() < 0.5:
        sx = int(rng.uniform(35, 100))
        sy = int(rng.uniform(25, 75))
        if right.shape[0] > 2 * sx and right.shape[1] > 2 * sy:
            cx = int(rng.uniform(sx, right.shape[0] - sx))
            cy = int(rng.uniform(sy, right.shape[1] - sy))
            right[cx - sx:cx + sx, cy - sy:cy + sy] = right.mean(
                axis=(0, 1), keepdims=True)
    return right


def pad_to_multiple(left, right, disp=None, mask=None,
                    multiple: int = PAD_MULTIPLE):
    """Pad H (top) and W (right side) up to the next multiple
    (data_augmentation/__init__.py:57-80). Returns the padded arrays plus the
    (top_pad, right_pad) offsets for un-padding predictions."""
    H, W = left.shape[:2]
    top = (-H) % multiple
    rpad = (-W) % multiple
    spec3 = ((top, 0), (0, rpad), (0, 0))
    spec2 = ((top, 0), (0, rpad))
    left = np.pad(left, spec3)
    right = np.pad(right, spec3)
    if disp is not None:
        disp = np.pad(disp, spec2 if disp.ndim == 2 else ((0, 0),) + spec2)
    if mask is not None:
        mask = np.pad(mask, spec2)
    return left, right, disp, mask, (top, rpad)
