"""Dataset IO: manifests, PFM/PNG16/packed-RGB disparity decoders, normalize.

The port's own copy of ``stereo_toolbox_tpu/datasets/io.py`` (the original
toolbox's datasets/utils.py:11-69 plus its per-dataset decode rules). The
decoders go to the port's native C++ runtime (``csrc/stereo_io.cpp``, bound
in `stereo_toolbox_tpu_torch.native`) when its library is available —
libpng / libjpeg decode and a fused normalize outside the GIL — and to the
NumPy/PIL paths below otherwise, file by file where the native decoder
refuses one. Both give the same bits; the fused normaliser rounds within
2 ulp of the NumPy one (tests/test_torch_native_io.py).
"""

from __future__ import annotations

import os
import re

import numpy as np
from PIL import Image

from stereo_toolbox_tpu_torch import native as _native

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def read_lines(filename: str):
    """Parse a file-list manifest: 2 or 3 space-separated relative paths per
    line (left, right[, disp]). Parity: datasets/utils.py:11-21."""
    lefts, rights, disps = [], [], []
    with open(filename) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            lefts.append(parts[0])
            rights.append(parts[1])
            disps.append(parts[2] if len(parts) > 2 else None)
    return lefts, rights, disps


def pfm_imread(filename: str):
    """Decode a PFM file → (HxW[x3] float array flipped to top-down, scale).

    Parity: datasets/utils.py:25-59 (PF/Pf header, endian from scale sign,
    flipud).
    """
    if _native.available:
        return _native.decode_pfm(filename)
    with open(filename, "rb") as f:
        header = f.readline().decode("latin-1").rstrip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"{filename}: not a PFM file (header {header!r})")
        color = header == "PF"
        dims = f.readline().decode("latin-1")
        m = re.match(r"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{filename}: malformed PFM dims {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("latin-1").rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f4")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy(), abs(scale)


def load_image_rgb(filename: str) -> np.ndarray:
    """Load an image as HxWx3 uint8 RGB."""
    if _native.available:
        try:
            return _native.decode_rgb(filename)
        except _native.NativeIOError:
            pass  # a format the native decoder does not read → PIL
    return np.asarray(Image.open(filename).convert("RGB"))


def load_png_raw(filename: str) -> np.ndarray:
    """Load a PNG preserving bit depth (uint8/uint16 as stored)."""
    if _native.available:
        try:
            return _native.decode_raw(filename)
        except _native.NativeIOError:
            pass
    return np.asarray(Image.open(filename))


# --- disparity decoders (one per GT encoding found in the reference) -------

def disp_from_pfm(filename: str, inf_to_zero: bool = False) -> np.ndarray:
    """SceneFlow/Middlebury/ETH3D/HR-VS PFM disparity
    (datasets/sceneflow.py:53-59; middleburyeval3.py:54-64 maps inf→0)."""
    disp, _ = pfm_imread(filename)
    disp = np.ascontiguousarray(disp, np.float32)
    if inf_to_zero:
        disp[~np.isfinite(disp)] = 0.0
    return disp


def disp_from_png_scaled(filename: str, divisor: float) -> np.ndarray:
    """uint16/uint8 PNG ÷ divisor (KITTI ÷256, InStereo2k ÷1024,
    CREStereo ÷32; datasets/kitti.py:55-61 etc.)."""
    return load_png_raw(filename).astype(np.float32) / divisor


def disp_from_rgb_packed(filename: str) -> np.ndarray:
    """Sintel packed-RGB disparity: R*4 + G/64 + B/16384
    (datasets/sintel.py:54-60)."""
    rgb = load_image_rgb(filename).astype(np.float32)
    return rgb[..., 0] * 4 + rgb[..., 1] / 64 + rgb[..., 2] / 16384


def disp_from_npy(filename: str) -> np.ndarray:
    """Booster .npy disparity (datasets/booster.py:53-59)."""
    return np.load(filename).astype(np.float32)


def disp_from_depth_png(filename: str, numerator: float,
                        depth_divisor: float = 1.0) -> np.ndarray:
    """Depth-encoded PNG → disparity = numerator / (depth / depth_divisor)
    (FallingThings: 768.16*6*100/depth, datasets/fallingthings.py:54-60;
    VirtualKITTI2: depth/100 then 0.532725*725.0087/depth,
    datasets/virtualkitti2.py:54-62). Zero/invalid depth → 0 disparity."""
    depth = load_png_raw(filename).astype(np.float32) / depth_divisor
    with np.errstate(divide="ignore", invalid="ignore"):
        disp = np.where(depth > 0, numerator / depth, 0.0)
    return disp.astype(np.float32)


def noc_from_png_eq(filename: str, value: int = 255) -> np.ndarray:
    """Mask PNG where ==value means non-occluded
    (middleburyeval3.py:67-78, booster.py:62-68)."""
    return (load_png_raw(filename) == value).astype(np.float32)


def noc_from_disp_png(filename: str, divisor: float = 256.0) -> np.ndarray:
    """KITTI-style: noc = (noc-file disparity > 0)
    (datasets/kitti.py:64-78)."""
    d = load_png_raw(filename).astype(np.float32) / divisor
    return (d > 0).astype(np.float32)


# --- normalization ---------------------------------------------------------

def to_float01(img: np.ndarray) -> np.ndarray:
    """uint8 HWC → float32 [0, 1] (ToTensor analogue, channels-last)."""
    return np.ascontiguousarray(img, np.float32) / 255.0


def imagenet_normalize(img01: np.ndarray) -> np.ndarray:
    """ImageNet mean/std normalize (datasets/utils.py:62-69)."""
    return (img01 - IMAGENET_MEAN) / IMAGENET_STD


def normalize_u8(img: np.ndarray) -> np.ndarray:
    """uint8 HxWx3 → ImageNet-normalized float32, fused in one pass.

    The native single-pass kernel when available (sio_normalize_imagenet),
    else ``imagenet_normalize(to_float01(img))``; within 2 ulp of each
    other.
    """
    if (_native.available and img.dtype == np.uint8 and img.ndim == 3
            and img.shape[-1] == 3):
        return _native.imagenet_normalize_u8(img)
    return imagenet_normalize(to_float01(img))


def resolve_root(root_dir: str) -> str:
    """Reference root-dir fallback: /data1 → /data
    (datasets/sceneflow.py:23-28)."""
    if os.path.exists(root_dir):
        return root_dir
    alt = root_dir.replace("/data1", "/data")
    if os.path.exists(alt):
        return alt
    # Like the reference, constructing a dataset with an absent root is fine
    # (datasets/sceneflow.py:23-28 only swaps prefixes); IO fails at load time.
    return root_dir
