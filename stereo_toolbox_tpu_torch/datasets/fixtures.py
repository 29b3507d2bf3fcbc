"""Dataset trees in the zoo's on-disk layouts, written from a seed.

`write_eval_trees` writes the datasets the evaluation suites read, each at
the paths of the first lines of its vendored manifest and in its own
encodings, and those lines as manifests under ``<root>/lists`` (laid out as
``datasets/lists``; ``eval.py --lists``), so that a suite runs end to end
without the real data:

  * SceneFlow: PNG pair, PFM disparity;
  * KITTI 2015 / 2012: PNG pair, uint16 PNG disparity ÷256 with holes, the
    noc file at the occ path with "occ" replaced by "noc";
  * Middlebury Eval3 (H) and ETH3D: PNG pair, PFM disparity with inf holes,
    ``mask0nocc.png`` (255 non-occluded, 128 occluded, 0 invalid);
  * DrivingStereo (half, four weathers): JPEG pair, uint16 PNG ÷256.

The roots returned are the ``--root`` each suite of ``eval.py`` takes.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from stereo_toolbox_tpu_torch.datasets import zoo
from stereo_toolbox_tpu_torch.datasets.base import LISTS_DIR

# dataset → (class, split, subdirectory of the root)
EVAL_DATASETS = {
    "sceneflow": (zoo.SceneFlow_Dataset, "test_finalpass", "Scene_Flow"),
    "kitti2015": (zoo.KITTI2015_Dataset, "train", "KITTI_2015"),
    "kitti2012": (zoo.KITTI2012_Dataset, "train", "KITTI_2012"),
    "middeval3": (zoo.MiddleburyEval3_Dataset, "trainH", "MiddEval3"),
    "eth3d": (zoo.ETH3D_Dataset, "train", "ETH3D"),
    **{f"drivingstereo_{w}": (zoo.DrivingStereo_Dataset, f"test_half_{w}",
                              "DrivingStereo")
       for w in ("sunny", "cloudy", "rainy", "foggy")},
}
# the sizes of the real datasets' frames (H, W)
FULL_SIZES = {"sceneflow": (540, 960), "kitti2015": (375, 1242),
              "kitti2012": (375, 1242), "middeval3": (992, 1436),
              "eth3d": (458, 739), "drivingstereo": (400, 881)}


def _save(path: str, arr: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if path.endswith(".jpg"):
        Image.fromarray(arr).save(path, quality=95)
    else:
        Image.fromarray(arr).save(path)


def write_pfm(path: str, data: np.ndarray, scale: float = -1.0) -> None:
    """A PFM file ('Pf' for HxW, 'PF' for HxWx3), bottom-up, little-endian
    for a negative `scale`."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"PF\n" if data.ndim == 3 else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n{scale}\n".encode())
        f.write(np.flipud(data).astype("<f4" if scale < 0 else ">f4")
                .tobytes())


def _frame(rng, h: int, w: int, max_disp: int):
    """An image pair, a disparity in [0.5, max_disp - 2) and masks of its
    holes (invalid) and occluded pixels."""
    left = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    right = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    disp = rng.uniform(0.5, max_disp - 2, (h, w)).astype(np.float32)
    hole = rng.random((h, w)) < 0.15
    occ = ~hole & (rng.random((h, w)) < 0.2)
    return left, right, disp, hole, occ


def _write_frame(name: str, root: str, row: list, rng, size, max_disp):
    left, right, disp, hole, occ = _frame(rng, *size, max_disp)
    lp, rp, dp = (os.path.join(root, p) for p in row)
    _save(lp, left)
    _save(rp, right)
    if name == "sceneflow":
        write_pfm(dp, disp)
    elif name in ("middeval3", "eth3d"):
        write_pfm(dp, np.where(hole, np.inf, disp).astype(np.float32))
        mask = np.where(hole, 0, np.where(occ, 128, 255)).astype(np.uint8)
        _save(os.path.join(os.path.dirname(dp), "mask0nocc.png"), mask)
    else:                                   # KITTI, DrivingStereo: ÷256
        d16 = np.where(hole, 0, np.round(disp * 256)).astype(np.uint16)
        _save(dp, d16)
        if name.startswith("kitti"):
            _save(dp.replace("occ", "noc"), np.where(occ, 0, d16)
                  .astype(np.uint16))


def write_eval_trees(root: str, frames: int = 2, sizes: dict | None = None,
                     max_disp: int = 192, seed: int = 0,
                     datasets=tuple(EVAL_DATASETS),
                     rows: int | None = None) -> dict:
    """Write `frames` frames of each of `datasets` under `root` (sizes by
    dataset family, default `FULL_SIZES`) and their manifests under
    ``root/lists``, each of `rows` lines (default `frames`) that cycle
    through the frames written. Returns ``{"lists": ..., "sceneflow": root,
    "generalization": root, "weather": root}``, the roots of
    ``eval.py``'s suites."""
    sizes = {**FULL_SIZES, **(sizes or {})}
    rng = np.random.default_rng(seed)
    lists = os.path.join(root, "lists")
    for name in datasets:
        cls, split, sub = EVAL_DATASETS[name]
        with open(os.path.join(LISTS_DIR, cls.list_name,
                               f"{split}.txt")) as f:
            lines = [line.split() for line in f if line.strip()][:frames]
        size = sizes[name.split("_")[0]]
        for row in lines:
            _write_frame(name.split("_")[0], os.path.join(root, sub), row,
                         rng, size, max_disp)
        manifest = os.path.join(lists, cls.list_name, f"{split}.txt")
        os.makedirs(os.path.dirname(manifest), exist_ok=True)
        with open(manifest, "w") as f:
            f.writelines(" ".join(lines[i % len(lines)]) + "\n"
                         for i in range(rows or len(lines)))
    return {"lists": lists, "sceneflow": os.path.join(root, "Scene_Flow"),
            "generalization": root,
            "weather": os.path.join(root, "DrivingStereo")}
