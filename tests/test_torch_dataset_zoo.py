"""The port's zoo datasets against the JAX package's.

  * every vendored manifest is the JAX package's byte for byte;
  * every (class, split) with a manifest builds with the JAX class's length
    and paths;
  * every class decodes a tree written into ``tmp_path`` in its own
    encodings (PFM, PNG ÷256 / ÷1024 / ÷32, packed RGB, ``.npy``, depth
    PNG, JPEG, noc masks) to the JAX class's samples, eval padding and
    train crops: bit for bit with both packages on their NumPy/PIL paths,
    and with the port's native library every key but the normalised
    images bit for bit (those within the fused normaliser's 2e-6);
  * ``train.py``'s dataset builder gives ``examples/train.py``'s datasets,
    and a train step runs on a zoo class over a tree.
"""

import argparse
import filecmp
import importlib.util
import os

import numpy as np
import pytest
import torch
from PIL import Image

from stereo_toolbox_tpu import native as jax_native
from stereo_toolbox_tpu.datasets import zoo as jzoo
from stereo_toolbox_tpu_torch import native as port_native
from stereo_toolbox_tpu_torch import train as port_train
from stereo_toolbox_tpu_torch.datasets import zoo
from stereo_toolbox_tpu_torch.datasets.base import LISTS_DIR
from stereo_toolbox_tpu_torch.datasets.fixtures import (write_eval_trees,
                                                        write_pfm)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_LISTS = os.path.join(REPO, "stereo_toolbox_tpu", "datasets", "lists")
KEYS = ("left", "right", "gt_disp", "noc_mask", "raw_left", "raw_right")
def _classes(mod):
    return sorted(n for n in vars(mod)
                  if n.endswith("_Dataset") and not n.startswith("_"))


CLASSES = _classes(zoo)


def _manifests(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


MANIFESTS = _manifests(JAX_LISTS)


def test_the_same_manifests():
    assert len(MANIFESTS) == 51
    assert _manifests(LISTS_DIR) == MANIFESTS


@pytest.mark.parametrize("rel", MANIFESTS)
def test_manifest_is_byte_identical(rel):
    assert filecmp.cmp(os.path.join(LISTS_DIR, rel),
                       os.path.join(JAX_LISTS, rel), shallow=False)


def test_the_same_classes():
    assert CLASSES == _classes(jzoo)
    assert len(CLASSES) == 17


SPLITS = [(name, split) for name in CLASSES
          for split in getattr(zoo, name).splits
          if os.path.exists(os.path.join(
              LISTS_DIR, getattr(zoo, name).list_name, f"{split}.txt"))]


@pytest.mark.parametrize("name,split", SPLITS)
def test_vendored_split_builds_as_jax(name, split):
    kw = dict(split=split, training=False, root_dir="/nonexistent/root")
    port, ref = getattr(zoo, name)(**kw), getattr(jzoo, name)(**kw)
    assert len(port) == len(ref) > 0
    assert port.list_name == ref.list_name and port.splits == ref.splits
    for attr in ("left_paths", "right_paths", "disp_paths"):
        assert getattr(port, attr) == getattr(ref, attr), attr


@pytest.mark.parametrize("name", ["CREStereo_Dataset",
                                  "FallingThings_Dataset"])
def test_no_vendored_manifest_needs_one(name):
    for mod in (zoo, jzoo):
        with pytest.raises(FileNotFoundError):
            getattr(mod, name)("train", training=False, root_dir="/x")


# --------------------------------------------------------------- decoders
H, W, CROP = 48, 64, (32, 48)


def _save(path, arr, **kw):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(arr).save(path, **kw)


def _rgb(rng):
    return rng.integers(0, 256, (H, W, 3), dtype=np.uint8)


def _disp(rng, hi=60.0):
    d = rng.uniform(0.5, hi, (H, W)).astype(np.float32)
    d[rng.random((H, W)) < 0.2] = 0
    return d


def _u16(x):
    return np.round(x).astype(np.uint16)


def _png16(path, disp, divisor):
    _save(path, _u16(disp * divisor))


def _kitti(root, row, rng):
    d = _disp(rng)
    _png16(os.path.join(root, row[2]), d, 256)
    noc = np.where(rng.random((H, W)) < 0.3, 0, d)
    _png16(os.path.join(root, row[2]).replace("occ", "noc"), noc, 256)


def _pfm_mask(root, row, rng, mask_name="mask0nocc.png"):
    d = _disp(rng)
    write_pfm(os.path.join(root, row[2]), np.where(d == 0, np.inf, d)
              .astype(np.float32))
    if mask_name:
        mask = rng.choice(np.array([0, 128, 255], np.uint8), (H, W))
        _save(os.path.join(os.path.dirname(os.path.join(root, row[2])),
                           mask_name), mask)


def _sintel(root, row, rng):
    packed = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    _save(os.path.join(root, row[2]), packed)
    occ = rng.choice(np.array([0, 255], np.uint8), (H, W))
    _save(os.path.join(root, row[2]).replace("disparities", "occlusions"),
          occ)


def _booster(root, row, rng):
    path = os.path.join(root, row[2])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.save(path, _disp(rng).astype(np.float64))
    _save(path.replace("disp_00.npy", "mask_00.png"),
          rng.choice(np.array([0, 255], np.uint8), (H, W)))


def _monotrap(root, row, rng):
    _png16(os.path.join(root, row[2]), _disp(rng), 256)
    _save(os.path.join(root, row[2]).replace("disparity", "mask"),
          rng.choice(np.array([0, 255], np.uint8), (H, W)))


def _depth(root, row, rng):
    depth = rng.integers(0, 60000, (H, W)).astype(np.uint16)
    depth[rng.random((H, W)) < 0.1] = 0
    _save(os.path.join(root, row[2]), depth)


def _png_disp(divisor):
    return lambda root, row, rng: _png16(os.path.join(root, row[2]),
                                         _disp(rng), divisor)


def _pfm(root, row, rng):
    write_pfm(os.path.join(root, row[2]), _disp(rng))


# class → (relative left, right, disp paths of frame {i}; disp writer)
TREES = {
    "SceneFlow_Dataset": ("frames_finalpass/TEST/A/{i}/left/0006.png",
                          "frames_finalpass/TEST/A/{i}/right/0006.png",
                          "disparity/TEST/A/{i}/left/0006.pfm", _pfm),
    "KITTI2015_Dataset": ("training/image_2/{i:06d}_10.png",
                          "training/image_3/{i:06d}_10.png",
                          "training/disp_occ_0/{i:06d}_10.png", _kitti),
    "KITTI2012_Dataset": ("training/colored_0/{i:06d}_10.png",
                          "training/colored_1/{i:06d}_10.png",
                          "training/disp_occ/{i:06d}_10.png", _kitti),
    "MiddleburyEval3_Dataset": ("trainingH/S{i}/im0.png",
                                "trainingH/S{i}/im1.png",
                                "trainingH/S{i}/disp0GT.pfm", _pfm_mask),
    "ETH3D_Dataset": ("s{i}/im0.png", "s{i}/im1.png", "s{i}/disp0GT.pfm",
                      _pfm_mask),
    "DrivingStereo_Dataset": ("sunny/left/{i}.jpg", "sunny/right/{i}.jpg",
                              "sunny/disparity/{i}.png", _png_disp(256)),
    "Middlebury2021_Dataset": ("s{i}/im0.png", "s{i}/im1.png",
                               "s{i}/disp0.pfm",
                               lambda *a: _pfm_mask(*a, mask_name=None)),
    "Sintel_Dataset": ("clean_left/a/frame_{i:04d}.png",
                       "clean_right/a/frame_{i:04d}.png",
                       "disparities/a/frame_{i:04d}.png", _sintel),
    "HR_VS_Dataset": ("l/{i}.png", "r/{i}.png", "d/{i}.pfm", _pfm),
    "Booster_Dataset": ("s{i}/camera_00/im0.png", "s{i}/camera_02/im0.png",
                        "s{i}/disp_00.npy", _booster),
    "InStereo2k_Dataset": ("s{i}/left.png", "s{i}/right.png",
                           "s{i}/left_disp.png", _png_disp(1024)),
    "CREStereo_Dataset": ("hole/{i}_left.jpg", "hole/{i}_right.jpg",
                          "hole/{i}_left.disp.png", _png_disp(32)),
    "Argoverse_Dataset": ("l/{i}.png", "r/{i}.png", "d/{i}.png",
                          _png_disp(256)),
    "Holopix50k_Dataset": ("train/left/{i}.png", "train/right/{i}.png",
                           None, None),
    "MonoTrap_Dataset": ("s{i}/left.png", "s{i}/right.png",
                         "s{i}/disparity.png", _monotrap),
    "FallingThings_Dataset": ("a/{i:06d}.left.jpg", "a/{i:06d}.right.jpg",
                              "a/{i:06d}.left.depth.png", _depth),
    "VirtualKITTI2_Dataset": ("S{i}/rgb/Camera_0/rgb.jpg",
                              "S{i}/rgb/Camera_1/rgb.jpg",
                              "S{i}/depth/Camera_0/depth.png", _depth),
}


def write_tree(name: str, root: str, frames: int = 2, seed: int = 0) -> str:
    """`frames` frames of class `name` under `root`; returns the
    manifest's path."""
    left, right, disp, writer = TREES[name]
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(frames):
        row = [p.format(i=i) for p in (left, right, disp) if p is not None]
        for path in row[:2]:
            kw = {"quality": 90} if path.endswith(".jpg") else {}
            _save(os.path.join(root, path), _rgb(rng), **kw)
        if writer is not None:
            writer(root, row, rng)
        rows.append(" ".join(row))
    manifest = os.path.join(root, "manifest.txt")
    with open(manifest, "w") as f:
        f.write("\n".join(rows) + "\n")
    return manifest


def _samples(mod, name, root, manifest, training):
    cls = getattr(mod, name)
    ds = cls(cls.splits[0], training=training, root_dir=root,
             manifest=manifest, crop_size=CROP, seed=3)
    ds.set_epoch(1)
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("native", [False, True], ids=["plain", "native"])
@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", CLASSES)
def test_decoders_equal_jax(tmp_path, monkeypatch, name, training, native):
    """The JAX package on its NumPy/PIL path; the port on the same
    (`plain`) or on its native library (`native`)."""
    if native and not port_native.available:
        pytest.skip(f"native IO library: {port_native.build_error}")
    monkeypatch.setattr(jax_native, "available", False)
    monkeypatch.setattr(port_native, "available", native)
    root = str(tmp_path / "root")
    manifest = write_tree(name, root)
    got = _samples(zoo, name, root, manifest, training)
    want = _samples(jzoo, name, root, manifest, training)
    for g, w in zip(got, want):
        assert set(g) == set(w) == set(KEYS)
        for k in KEYS:
            assert g[k].dtype == w[k].dtype == np.float32, k
            assert g[k].shape == w[k].shape, k
            if native and k in ("left", "right"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=2e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        if training:
            assert g["left"].shape == (*CROP, 3)
        else:                                # padded to multiples of 96
            assert g["left"].shape == (96, 96, 3)
        if TREES[name][3] is not None:
            assert np.isfinite(g["gt_disp"]).any()


def test_kitti_noc_path_rewrites_occ_in_root(tmp_path):
    """KITTI's noc file is the occ path with every "occ" replaced, the root
    too: under a root holding "occ" (this test's own tmp_path) both packages
    look for the noc file under another root and miss the one beside the
    occ file."""
    root = str(tmp_path / "occluded_root")
    assert "occ" in root
    manifest = write_tree("KITTI2015_Dataset", root, frames=1)
    disp = os.path.join(root, "training/disp_occ_0/000000_10.png")
    beside = disp.replace("disp_occ_0", "disp_noc_0")
    os.makedirs(os.path.dirname(beside), exist_ok=True)
    os.replace(disp.replace("occ", "noc"), beside)
    for mod in (zoo, jzoo):
        ds = mod.KITTI2015_Dataset("train", training=False, root_dir=root,
                                   manifest=manifest)
        assert ds.disp_paths[0] == disp
        assert ds.load_noc_mask(0) is None
        assert np.isnan(ds[0]["noc_mask"]).all()


# ------------------------------------------------------------- train.py
def _jax_train():
    spec = importlib.util.spec_from_file_location(
        "jax_examples_train", os.path.join(REPO, "examples", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TRAIN = _jax_train()


@pytest.mark.parametrize("dataset", sorted(port_train.DATASETS) + [
    "kitti2015+sceneflow", "sceneflow+sintel+hr_vs"])
@pytest.mark.parametrize("split", [None, "val"])
def test_train_dataset_builder_matches_jax(dataset, split):
    assert port_train.DATASETS == JAX_TRAIN.DATASETS
    args = argparse.Namespace(dataset=dataset, split=split,
                              root="/nonexistent/DIR", crop=(256, 512),
                              seed=5, maxdisp=192, lists=None)
    try:
        want = JAX_TRAIN.build_dataset(args)
    except (FileNotFoundError, ValueError) as e:
        with pytest.raises(type(e)):
            port_train.build_dataset(args)
        return
    got = port_train.build_dataset(args)
    parts = lambda d: getattr(d, "datasets", [d])     # noqa: E731
    assert len(got) == len(want)
    assert [type(d).__name__ for d in parts(got)] == [
        type(d).__name__ for d in parts(want)]
    for g, w in zip(parts(got), parts(want)):
        assert (len(g), g.split, g.training, g.crop_size, g.seed,
                g.root_dir, g.left_paths) == (len(w), w.split, w.training,
                                              w.crop_size, w.seed,
                                              w.root_dir, w.left_paths)


def test_train_entry_point_steps_on_a_zoo_tree(tmp_path):
    """``train.py --dataset kitti2015 --root ... --lists ...`` on the CPU:
    one epoch of one step over a two-frame KITTI tree."""
    roots = write_eval_trees(str(tmp_path), frames=2,
                             sizes={"kitti2015": (48, 80)}, max_disp=16,
                             datasets=("kitti2015",))
    port_train.main([
        "--device", "cpu", "--model", "GwcNet_G", "--dataset", "kitti2015",
        "--root", os.path.join(roots["generalization"], "KITTI_2015"),
        "--lists", roots["lists"], "--epochs", "1", "--batch-size", "2",
        "--crop", "32", "48", "--maxdisp", "16", "--num-workers", "0",
        "--ckpt-dir", str(tmp_path / "ckpt")])
    assert os.path.exists(tmp_path / "ckpt" / "epoch_0000.pt")


def test_eval_tree_manifest_cycles_its_frames(tmp_path):
    """``write_eval_trees(rows=...)`` writes `frames` frames and a manifest
    of `rows` lines that cycle through them; the zoo class reads each."""
    roots = write_eval_trees(str(tmp_path), frames=2,
                             sizes={"kitti2015": (24, 40)}, max_disp=16,
                             datasets=("kitti2015",), rows=5)
    manifest = os.path.join(roots["lists"], "kitti2015", "train.txt")
    with open(manifest) as f:
        lines = f.read().splitlines()
    assert len(lines) == 5 and len(set(lines)) == 2
    assert lines == [lines[i % 2] for i in range(5)]
    ds = zoo.KITTI2015_Dataset(
        "train", training=False, manifest=manifest,
        root_dir=os.path.join(roots["generalization"], "KITTI_2015"))
    assert len(ds) == 5
    np.testing.assert_array_equal(ds[4]["left"], ds[0]["left"])
    np.testing.assert_array_equal(ds[3]["gt_disp"], ds[1]["gt_disp"])
