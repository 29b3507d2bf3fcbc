"""The dataset classes of the zoo (the original toolbox's datasets/*.py,
SURVEY §2.2): the 16 that ``train.py --dataset`` names, and MonoTrap.

The port's own copy of ``stereo_toolbox_tpu/datasets/zoo.py``: the same
classes, splits, manifests, default roots and decoders, so each yields the
JAX package's samples bit for bit. Each class pins its allowed splits, its
manifest directory under ``datasets/lists/``, its default root and its
ground-truth disparity / noc-mask decoders; loading, augmentation and the
6-key sample contract live in `StereoDataset`.

Default roots follow the original's convention (``/data1/xp/<Name>/`` with
the /data1 → /data fallback, datasets/sceneflow.py:23-28); pass
``root_dir=`` to override. Manifests are the original's txt format; the
vendored ones are byte-for-byte the JAX package's. CREStereo and
FallingThings have none: pass ``manifest=``.

KITTI's noc mask is the occ file's path with every "occ" replaced by "noc",
over the whole path as the JAX package does, so a root whose path holds
"occ" is rewritten too (ROADMAP, "Things that look like faults").
"""

from __future__ import annotations

import os

import numpy as np

from stereo_toolbox_tpu_torch.datasets import io
from stereo_toolbox_tpu_torch.datasets.base import StereoDataset


class SceneFlow_Dataset(StereoDataset):
    """reference datasets/sceneflow.py — PFM disparity, no noc mask."""
    list_name = "sceneflow"
    splits = ("train_cleanpass", "train_finalpass", "test_cleanpass",
              "test_finalpass")

    def __init__(self, split, training, root_dir="/data1/xp/Scene_Flow/",
                 **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None if path is None else io.disp_from_pfm(path)


class _KITTI_Dataset(StereoDataset):
    """reference datasets/kitti.py — uint16 PNG ÷256; noc = occ→noc file."""
    splits = ("train", "train_all", "val", "test")

    def load_disp(self, path):
        return None if path is None else io.disp_from_png_scaled(path, 256.0)

    def load_noc_mask(self, index):
        path = self.disp_paths[index]
        if path is None:
            return None
        noc = path.replace("occ", "noc")
        if not os.path.exists(noc):
            return None
        return io.noc_from_disp_png(noc)


class KITTI2015_Dataset(_KITTI_Dataset):
    list_name = "kitti2015"

    def __init__(self, split, training, root_dir="/data1/xp/KITTI_2015/",
                 **kw):
        super().__init__(split, training, root_dir, **kw)


class KITTI2012_Dataset(_KITTI_Dataset):
    list_name = "kitti2012"

    def __init__(self, split, training, root_dir="/data1/xp/KITTI_2012/",
                 **kw):
        super().__init__(split, training, root_dir, **kw)


class MiddleburyEval3_Dataset(StereoDataset):
    """reference datasets/middleburyeval3.py — PFM (inf→0), mask PNG ==255."""
    list_name = "middleburyeval3"
    splits = ("trainH", "trainH_all", "valH", "testH")

    def __init__(self, split, training,
                 root_dir="/data1/xp/Middlebury_Eval3/", **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None if path is None else io.disp_from_pfm(path,
                                                          inf_to_zero=True)

    def load_noc_mask(self, index):
        path = self.disp_paths[index]
        if path is None:
            return None
        mask = os.path.join(os.path.dirname(path), "mask0nocc.png")
        if not os.path.exists(mask):
            return None
        return io.noc_from_png_eq(mask, 255)


class ETH3D_Dataset(StereoDataset):
    """reference datasets/eth3d.py — PFM (inf→0), mask0nocc PNG."""
    list_name = "eth3d"
    splits = ("train", "train_all", "val", "test")

    def __init__(self, split, training, root_dir="/data1/xp/ETH3D/", **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None if path is None else io.disp_from_pfm(path,
                                                          inf_to_zero=True)

    def load_noc_mask(self, index):
        path = self.disp_paths[index]
        if path is None:
            return None
        mask = os.path.join(os.path.dirname(path), "mask0nocc.png")
        if not os.path.exists(mask):
            return None
        return io.noc_from_png_eq(mask, 255)


class DrivingStereo_Dataset(StereoDataset):
    """reference datasets/drivingstereo.py — uint16 PNG ÷256, weather
    splits."""
    list_name = "drivingstereo"
    splits = tuple(
        [f"{base}{w}" for base in ("train_half", "test_half", "test_full")
         for w in ("", "_sunny", "_cloudy", "_rainy", "_foggy")])

    def __init__(self, split, training,
                 root_dir="/data1/xp/DrivingStereo/", **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None if path is None else io.disp_from_png_scaled(path, 256.0)


class Middlebury2021_Dataset(StereoDataset):
    """reference datasets/middlebury2021.py — PFM (inf→0)."""
    list_name = "middlebury2021"
    splits = ("train",)

    def __init__(self, split, training,
                 root_dir="/data1/xp/Middlebury_2021/", **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None if path is None else io.disp_from_pfm(path,
                                                          inf_to_zero=True)


class Sintel_Dataset(StereoDataset):
    """reference datasets/sintel.py — packed-RGB disparity, occlusion PNG."""
    list_name = "sintel"
    splits = ("train_clean", "train_final")

    def __init__(self, split, training, root_dir="/data1/xp/Sintel/", **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None if path is None else io.disp_from_rgb_packed(path)

    def load_noc_mask(self, index):
        path = self.disp_paths[index]
        if path is None:
            return None
        occ = path.replace("disparities", "occlusions")
        if not os.path.exists(occ):
            return None
        # occlusion mask PNG: 255 = occluded → noc = not occluded
        return (np.asarray(io.load_png_raw(occ)) == 0).astype(np.float32)


class HR_VS_Dataset(StereoDataset):
    """reference datasets/hr_vs.py — PFM, train only (780 pairs)."""
    list_name = "hr_vs"
    splits = ("train",)

    def __init__(self, split, training, root_dir="/data1/xp/HR_VS/", **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None if path is None else io.disp_from_pfm(path)


class Booster_Dataset(StereoDataset):
    """reference datasets/booster.py — .npy disparity, mask PNG ==255."""
    list_name = "booster"
    splits = ("train_balanced",)

    def __init__(self, split, training, root_dir="/data1/xp/Booster/", **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None if path is None else io.disp_from_npy(path)

    def load_noc_mask(self, index):
        path = self.disp_paths[index]
        if path is None:
            return None
        mask = path.replace("disp_00.npy", "mask_00.png")
        if not os.path.exists(mask):
            return None
        return io.noc_from_png_eq(mask, 255)


class InStereo2k_Dataset(StereoDataset):
    """reference datasets/instereo2k.py — uint16 PNG ÷1024."""
    list_name = "instereo2k"
    splits = ("train", "test")

    def __init__(self, split, training, root_dir="/data1/xp/InStereo2K/",
                 **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None if path is None else io.disp_from_png_scaled(path,
                                                                 1024.0)


class CREStereo_Dataset(StereoDataset):
    """reference datasets/crestereo.py — PNG ÷32 (200k synthetic)."""
    list_name = "crestereo"
    splits = ("train",)

    def __init__(self, split, training, root_dir="/data1/xp/CREStereo/",
                 **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None if path is None else io.disp_from_png_scaled(path, 32.0)


class Argoverse_Dataset(StereoDataset):
    """reference datasets/argoverse.py — PNG ÷256."""
    list_name = "argoverse"
    splits = ("train", "val", "test")

    def __init__(self, split, training, root_dir="/data1/xp/Argoverse/",
                 **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None if path is None else io.disp_from_png_scaled(path, 256.0)


class Holopix50k_Dataset(StereoDataset):
    """reference datasets/holopix50k.py — stereo pairs with NO ground truth
    (self-supervised training data)."""
    list_name = "holopix50k"
    splits = ("train", "val", "test")

    def __init__(self, split, training, root_dir="/data1/xp/Holopix50k/",
                 **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None


class MonoTrap_Dataset(StereoDataset):
    """reference datasets/monotrap.py — perspective-illusion val benchmark,
    PNG ÷256 + mask."""
    list_name = "monotrap"
    splits = ("val",)

    def __init__(self, split, training, root_dir="/data1/xp/MonoTrap/",
                 **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        return None if path is None else io.disp_from_png_scaled(path, 256.0)

    def load_noc_mask(self, index):
        path = self.disp_paths[index]
        if path is None:
            return None
        mask = path.replace("disparity", "mask")
        if not os.path.exists(mask):
            return None
        return io.noc_from_png_eq(mask, 255)


class FallingThings_Dataset(StereoDataset):
    """reference datasets/fallingthings.py — depth PNG → disparity
    768.16*6*100/depth."""
    list_name = "fallingthings"
    splits = ("train",)

    def __init__(self, split, training,
                 root_dir="/data1/xp/FallingThings/", **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        if path is None:
            return None
        return io.disp_from_depth_png(path, 768.16 * 6 * 100)


class VirtualKITTI2_Dataset(StereoDataset):
    """reference datasets/virtualkitti2.py — depth PNG (cm) → disparity
    0.532725*725.0087/depth[m]."""
    list_name = "virtualkitti2"
    splits = ("train",)

    def __init__(self, split, training,
                 root_dir="/data1/xp/VirtualKITTI2/", **kw):
        super().__init__(split, training, root_dir, **kw)

    def load_disp(self, path):
        if path is None:
            return None
        return io.disp_from_depth_png(path, 0.532725 * 725.0087,
                                      depth_divisor=100.0)
