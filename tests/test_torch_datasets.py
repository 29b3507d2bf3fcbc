"""The port's data layer against the JAX package's: the same samples for
the same seed and index, the same batches in the same order per epoch.

Both sides are numpy; the port's copy never imports the JAX package. The
augmentation runs the same numpy operations on the same draws, so every
value is compared exactly but the ImageNet-normalised images: where one
package's C++ library is built and the other's is not, its fused
normaliser computes them and rounds differently from the numpy path (2 ulp
at most here), so those are held within 1e-6.
"""

import numpy as np
import pytest
from PIL import Image

from stereo_toolbox_tpu.datasets import base as jbase
from stereo_toolbox_tpu.datasets import io as jio
from stereo_toolbox_tpu.datasets import loader as jloader
from stereo_toolbox_tpu_torch import native as port_native
from stereo_toolbox_tpu_torch.datasets import (ConcatDataset, DataLoader,
                                               StereoDataset,
                                               SyntheticStereoDataset,
                                               augmentation, collate, io)

KEYS = ("left", "right", "gt_disp", "noc_mask", "raw_left", "raw_right")


NORMALISED = ("left", "right")


def _equal(got: dict, want: dict):
    assert set(got) == set(want) == set(KEYS)
    for k in KEYS:
        assert got[k].dtype == want[k].dtype == np.float32, k
        assert got[k].shape == want[k].shape, k
        if k in NORMALISED:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("training", [True, False])
def test_synthetic_samples_equal_jax(seed, training):
    kw = dict(num_samples=5, height=70, width=100, max_disp=24,
              training=training, crop_size=(48, 64), seed=seed)
    port, ref = SyntheticStereoDataset(**kw), jbase.SyntheticStereoDataset(
        **kw)
    for epoch in (0, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        for index in (0, 2, 4):
            got, want = port[index], ref[index]
            _equal(got, want)
            if training:
                assert got["left"].shape == (48, 64, 3)
            else:     # eval pads up to multiples of 96
                assert got["left"].shape == (96, 192, 3)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_order_equals_jax(shuffle, drop_last):
    """Per-epoch order from SeedSequence([seed, epoch]), collated batches
    equal, with and without shuffling, for two epochs."""
    kw = dict(num_samples=7, height=60, width=80, max_disp=12,
              training=True, crop_size=(32, 48), seed=3)
    port = DataLoader(SyntheticStereoDataset(**kw), batch_size=3,
                      shuffle=shuffle, seed=5, drop_last=drop_last,
                      num_workers=2)
    ref = jloader.DataLoader(jbase.SyntheticStereoDataset(**kw),
                             batch_size=3, shuffle=shuffle, seed=5,
                             drop_last=drop_last, num_workers=0)
    assert len(port) == len(ref) == (2 if drop_last else 3)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        np.testing.assert_array_equal(port._indices(), ref._indices())
        batches = list(port)
        assert len(batches) == len(ref)
        for got, want in zip(batches, ref):
            _equal(got, want)


def test_loader_shards_like_jax():
    ds = SyntheticStereoDataset(num_samples=10, height=60, width=80,
                                max_disp=12, crop_size=(32, 48))
    for rank in range(3):
        port = DataLoader(ds, 2, shuffle=True, seed=1, process_index=rank,
                          process_count=3, num_workers=0)
        ref = jloader.DataLoader(ds, 2, shuffle=True, seed=1,
                                 process_index=rank, process_count=3)
        np.testing.assert_array_equal(port._indices(), ref._indices())
        assert len(port._indices()) == 3


def test_concat_dataset_and_collate_equal_jax():
    parts = [SyntheticStereoDataset(num_samples=n, height=60, width=80,
                                    max_disp=12, crop_size=(32, 48), seed=s)
             for n, s in ((2, 0), (3, 1))]
    port = ConcatDataset(parts)
    ref = jloader.ConcatDataset(parts)
    port.set_epoch(1)
    assert len(port) == len(ref) == 5
    for i in (0, 1, 2, 4, -1):
        _equal(port[i], ref[i])
    batch = collate([port[0], port[3]])
    want = jloader.collate([ref[0], ref[3]])
    _equal(batch, want)


def _write_pair(root, rng, h=50, w=70):
    left = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    right = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    disp = (rng.rand(h, w) * 200).astype(np.uint16)
    Image.fromarray(left).save(root / "l.png")
    Image.fromarray(right).save(root / "r.png")
    Image.fromarray(disp).save(root / "d.png")
    (root / "list.txt").write_text("l.png r.png d.png\nl.png r.png\n")


class _PortPng(StereoDataset):
    def load_disp(self, path):
        return None if path is None else io.disp_from_png_scaled(path, 8.0)


class _JaxPng(jbase.StereoDataset):
    def load_disp(self, path):
        return None if path is None else jio.disp_from_png_scaled(path, 8.0)


@pytest.mark.parametrize("training", [True, False])
def test_manifest_dataset_equals_jax(tmp_path, training):
    """A manifest dataset over PNG files: decode, crop/jitter/mask or pad,
    normalise; absent disparity NaN-filled."""
    _write_pair(tmp_path, np.random.RandomState(0))
    kw = dict(split="any", training=training, root_dir=str(tmp_path),
              crop_size=(32, 48), seed=4,
              manifest=str(tmp_path / "list.txt"))
    port, ref = _PortPng(**kw), _JaxPng(**kw)
    assert len(port) == len(ref) == 2
    for i in range(2):
        _equal(port[i], ref[i])
    assert np.isnan(port[1]["gt_disp"]).all()
    with pytest.raises(FileNotFoundError):
        _PortPng("any", True, str(tmp_path), manifest=str(tmp_path / "no"))


def test_pfm_and_decoders_equal_jax(tmp_path, monkeypatch):
    rng = np.random.RandomState(1)
    data = rng.randn(5, 7).astype(np.float32)
    with open(tmp_path / "a.pfm", "wb") as f:
        f.write(b"Pf\n7 5\n-1.0\n")
        f.write(np.flipud(data).astype("<f4").tobytes())
    got, scale = io.pfm_imread(str(tmp_path / "a.pfm"))
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, jio.pfm_imread(str(tmp_path /
                                                          "a.pfm"))[0])
    assert scale == 1.0
    img = (rng.rand(6, 8, 3) * 255).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "p.png")
    for fn in ("disp_from_rgb_packed", "load_image_rgb"):
        np.testing.assert_array_equal(getattr(io, fn)(str(tmp_path /
                                                          "p.png")),
                                      getattr(jio, fn)(str(tmp_path /
                                                           "p.png")))
    np.testing.assert_allclose(io.normalize_u8(img), jio.normalize_u8(img),
                               rtol=0, atol=1e-6)
    # the port's numpy path (its native library off) is JAX's bit for bit
    monkeypatch.setattr(port_native, "available", False)
    np.testing.assert_array_equal(io.normalize_u8(img),
                                  jio.imagenet_normalize(jio.to_float01(img)))


def test_augmentation_draws_equal_jax():
    from stereo_toolbox_tpu.datasets import augmentation as jaug
    img = (np.random.RandomState(2).rand(120, 180, 3) * 255).astype(np.uint8)
    for seed in range(4):
        got = augmentation.random_mask(img, np.random.default_rng(seed))
        want = jaug.random_mask(img, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            augmentation.color_jitter(img, np.random.default_rng(seed)),
            jaug.color_jitter(img, np.random.default_rng(seed)))
    got = augmentation.pad_to_multiple(img, img, img[..., 0], None, 96)
    want = jaug.pad_to_multiple(img, img, img[..., 0], None, 96)
    assert got[4] == want[4] == (72, 12)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
