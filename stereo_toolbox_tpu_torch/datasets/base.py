"""Base stereo dataset: manifest-driven samples with the 6-key dict contract.

The port's own copy of ``stereo_toolbox_tpu/datasets/base.py``: the same
samples for the same seed and index.

Every dataset yields numpy dicts (channels-last)::

    {left      [H, W, 3] float32  ImageNet-normalized,
     right     [H, W, 3] float32,
     gt_disp   [H, W]    float32  (NaN-filled when absent),
     noc_mask  [H, W]    float32  (NaN-filled when absent),
     raw_left  [H, W, 3] float32  in [0, 1] (pre-jitter),
     raw_right [H, W, 3] float32}

mirroring the reference dataloader contract (README.md:37-43,
datasets/sceneflow.py:96-103). Training samples are randomly cropped,
color-jittered (asymmetric), and right-occlusion-masked; eval samples are
padded to multiples of 96 (datasets/sceneflow.py:66-103).

Manifests use the reference's txt format (datasets/utils.py:11-21): per line,
2-3 space-separated paths relative to the dataset root. They are looked up in
`LISTS_DIR/<name>/<split>.txt` (the zoo's vendored manifests, the JAX
package's byte for byte) or passed as ``manifest=``.

Unlike the reference (implicit global torch RNG), every sample's augmentation
is derived from `(seed, epoch, index)` — fully reproducible and trivially
shardable across hosts.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from stereo_toolbox_tpu_torch.datasets import augmentation as aug
from stereo_toolbox_tpu_torch.datasets import io

LISTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lists")


class StereoDataset:
    """Map-style dataset over a stereo file-list manifest."""

    #: subdir of `lists/` holding this dataset's manifests
    list_name: str = ""
    #: allowed split names (checked when set)
    splits: tuple[str, ...] = ()

    def __init__(self, split: str, training: bool, root_dir: str,
                 crop_size: tuple[int, int] = (384, 512),
                 seed: int = 0, manifest: str | None = None):
        if self.splits and split not in self.splits:
            raise ValueError(
                f"Invalid split {split!r} for {type(self).__name__}; "
                f"expected one of {self.splits}")
        self.split = split
        self.training = training
        self.root_dir = io.resolve_root(root_dir)
        self.crop_size = tuple(crop_size)
        self.seed = seed
        self.epoch = 0

        manifest = manifest or os.path.join(
            LISTS_DIR, self.list_name, f"{split}.txt")
        if not os.path.exists(manifest):
            raise FileNotFoundError(
                f"Manifest {manifest} not found; pass manifest=...")
        lefts, rights, disps = io.read_lines(manifest)
        self.left_paths = [os.path.join(self.root_dir, p) for p in lefts]
        self.right_paths = [os.path.join(self.root_dir, p) for p in rights]
        self.disp_paths = [
            None if p is None else os.path.join(self.root_dir, p)
            for p in disps]

    # -- per-dataset decoders -------------------------------------------
    def load_image(self, path: str) -> np.ndarray:
        return io.load_image_rgb(path)

    def load_disp(self, path: str | None) -> np.ndarray | None:
        raise NotImplementedError

    def load_noc_mask(self, index: int) -> np.ndarray | None:
        """Default: no non-occlusion annotation."""
        return None

    # -- protocol -------------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.left_paths)

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, index]))

    def __getitem__(self, index: int) -> dict[str, np.ndarray]:
        left = self.load_image(self.left_paths[index])
        right = self.load_image(self.right_paths[index])
        disp = self.load_disp(self.disp_paths[index])
        mask = self.load_noc_mask(index)

        if self.training:
            rng = self._rng(index)
            left, right, disp, mask = aug.random_crop(
                left, right, disp, mask, self.crop_size, rng)
            raw_left = io.to_float01(left)
            raw_right = io.to_float01(right)
            left, right = aug.random_jitter(left, right, rng)
            right = aug.random_mask(right, rng)
        else:
            left, right, disp, mask, _ = aug.pad_to_multiple(
                np.asarray(left), np.asarray(right), disp, mask)
            raw_left = io.to_float01(left)
            raw_right = io.to_float01(right)

        left = io.normalize_u8(left)
        right = io.normalize_u8(right)

        h, w = left.shape[:2]
        if disp is None:
            disp = np.full((h, w), np.nan, np.float32)
        if mask is None:
            mask = np.full((h, w), np.nan, np.float32)

        return {
            "left": left.astype(np.float32),
            "right": right.astype(np.float32),
            "gt_disp": np.ascontiguousarray(disp, np.float32),
            "noc_mask": np.ascontiguousarray(mask, np.float32),
            "raw_left": raw_left,
            "raw_right": raw_right,
        }


class SyntheticStereoDataset(StereoDataset):
    """Procedural random-dot stereo pairs with exact ground truth.

    No reference counterpart — this is the framework's hermetic test/benchmark
    dataset: textured random-dot images where the right view is the left
    shifted by a known piecewise-constant disparity field, so the data layer,
    training loop, and evaluation suites are exercisable with zero downloads.
    """

    def __init__(self, num_samples: int = 16, height: int = 384,
                 width: int = 512, max_disp: int = 64, training: bool = True,
                 crop_size: tuple[int, int] = (256, 512), seed: int = 0):
        # bypass StereoDataset.__init__ (no files involved)
        self.training = training
        self.crop_size = crop_size
        self.seed = seed
        self.epoch = 0
        self.num_samples = num_samples
        self.height, self.width, self.max_disp = height, width, max_disp
        self.left_paths = [str(i) for i in range(num_samples)]

    def __len__(self):
        return self.num_samples

    def _make_pair(self, index: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([917, self.seed, index]))
        h, w = self.height, self.width
        # smooth random texture (few octaves of upsampled noise)
        tex = np.zeros((h, w, 3), np.float32)
        for cell in (8, 32):
            small = rng.random((h // cell + 2, w // cell + 2, 3)).astype(
                np.float32)
            up = np.kron(small, np.ones((cell, cell, 1), np.float32))
            tex += up[:h, :w]
        tex = (tex / tex.max() * 255).astype(np.uint8)

        # piecewise-constant disparity: background plane + random rectangles
        md = max(self.max_disp, 8)
        disp = np.full((h, w), rng.uniform(0.05 * md, 0.3 * md), np.float32)
        for _ in range(6):
            d = rng.uniform(0.3 * md, md - 2)
            y0 = int(rng.integers(0, h - 40))
            x0 = int(rng.integers(0, w - 40))
            hh = int(rng.integers(30, max(31, h // 3)))
            ww = int(rng.integers(30, max(31, w // 3)))
            disp[y0:y0 + hh, x0:x0 + ww] = d
        disp = np.round(disp)

        # right view: left pixel (x) appears at right-x = x - d
        xs = np.arange(w)[None, :].repeat(h, 0)
        src = (xs + disp).astype(np.int64)  # right[x] = left[x + d(right..)]
        src = np.clip(src, 0, w - 1)
        right = np.take_along_axis(
            tex, src[..., None].repeat(3, -1), axis=1)
        return tex, right.astype(np.uint8), disp

    def __getitem__(self, index: int):
        left, right, disp = self._make_pair(index)
        mask = None
        if self.training:
            rng = self._rng(index)
            left, right, disp, mask = aug.random_crop(
                left, right, disp, mask, self.crop_size, rng)
            raw_left = io.to_float01(left)
            raw_right = io.to_float01(right)
            left, right = aug.random_jitter(left, right, rng)
        else:
            left, right, disp, mask, _ = aug.pad_to_multiple(
                left, right, disp, mask)
            raw_left = io.to_float01(left)
            raw_right = io.to_float01(right)
        h, w = left.shape[:2]
        return {
            "left": io.normalize_u8(left),
            "right": io.normalize_u8(right),
            "gt_disp": np.ascontiguousarray(disp, np.float32),
            "noc_mask": np.full((h, w), np.nan, np.float32),
            "raw_left": raw_left,
            "raw_right": raw_right,
        }
