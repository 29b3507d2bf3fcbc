"""Port ops of CFNet's volumes against the JAX package: the concat volume,
the gather at disparity samples, the volumes over samples, the variances and
the resizes.

Inputs are made with numpy from a seed and fed to both. Gathers and copies
must agree exactly; reductions at 1e-5 (the same float32 arithmetic in
another summation order). The JAX Pallas sample kernels run in interpret
mode, as tests/test_pallas_volume.py runs them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu import ops as jops
from stereo_toolbox_tpu.nn import layers as jl
from stereo_toolbox_tpu.ops.pallas.sample_gather import (
    gather_right_by_samples_pallas, gwc_volume_from_samples_pallas)
from stereo_toolbox_tpu.ops.pallas.volume import build_concat_volume_pallas
from stereo_toolbox_tpu_torch import ops
from stereo_toolbox_tpu_torch.nn import avg_pool

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _feats(b, h, w, c, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, c).astype(np.float32),
            rng.randn(b, h, w, c).astype(np.float32))


def _samples(b, s, h, w, lo, hi, seed):
    """Integer-valued float32 samples in [lo, hi]."""
    rng = np.random.RandomState(seed)
    return rng.randint(lo, hi + 1, (b, s, h, w)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("mask_left", [True, False])
@pytest.mark.parametrize("b,h,w,c,d", [(2, 3, 10, 6, 4),    # D < W
                                       (1, 2, 5, 3, 9),     # D > W
                                       (1, 3, 40, 32, 12)])  # ACVNet's C
def test_build_concat_volume_matches_jax(b, h, w, c, d, mask_left):
    left, right = _feats(b, h, w, c, 0)
    got = ops.build_concat_volume(*_t(left, right), d, mask_left).numpy()
    want = np.asarray(jops.build_concat_volume(jnp.asarray(left),
                                               jnp.asarray(right), d,
                                               mask_left))
    assert got.shape == (b, d, h, w, 2 * c)
    np.testing.assert_array_equal(got, want)
    if d > w:   # planes d >= W: right half zero, left half too if masked
        assert not got[:, w:, ..., 0 if mask_left else c:].any()


def test_build_concat_volume_matches_pallas():
    """The masked volume against the JAX Pallas concat kernel (interpret)."""
    left, right = _feats(2, 8, 16, 8, 1)
    got = ops.build_concat_volume(*_t(left, right), 5).numpy()
    want = np.asarray(build_concat_volume_pallas(
        jnp.asarray(left), jnp.asarray(right), 5, block_h=2, interpret=True))
    np.testing.assert_array_equal(got, want)


def test_gather_right_by_samples_matches_jax():
    """Samples reach past the left edge of the image (x < 0 → zero)."""
    _, right = _feats(2, 3, 20, 5, 2)
    samples = _samples(2, 6, 3, 20, 0, 25, 3)
    got = ops.gather_right_by_samples(*_t(right, samples)).numpy()
    want = np.asarray(jops.gather_right_by_samples(jnp.asarray(right),
                                                   jnp.asarray(samples)))
    assert got.shape == (2, 6, 3, 20, 5)
    np.testing.assert_array_equal(got, want)


def test_concat_volume_from_samples_matches_jax():
    left, right = _feats(1, 4, 24, 6, 4)
    samples = _samples(1, 5, 4, 24, 0, 16, 5)
    got = ops.concat_volume_from_samples(*_t(left, right, samples),
                                         max_shift=16).numpy()
    want = np.asarray(jops.concat_volume_from_samples(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(samples)))
    assert got.shape == (1, 5, 4, 24, 12)
    np.testing.assert_array_equal(got, want)


def test_gwc_volume_from_samples_matches_jax():
    """W=256, samples up to 96, max_shift 96 (tests/test_pallas_volume.py's
    sample-gather case)."""
    left, right = _feats(1, 3, 256, 16, 6)
    samples = _samples(1, 5, 3, 256, 0, 96, 7)
    got = ops.gwc_volume_from_samples(*_t(left, right, samples), 4,
                                      max_shift=96).numpy()
    want = np.asarray(jops.gwc_volume_from_samples(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(samples), 4))
    assert got.shape == (1, 5, 3, 256, 4)
    np.testing.assert_allclose(got, want, **TOL)


def test_sample_ops_match_pallas_kernels():
    """The plain ops against the JAX Pallas K4/K5 (interpret mode), with
    samples outside [0, max_shift] that both clamp."""
    left, right = _feats(1, 3, 256, 16, 8)
    samples = _samples(1, 5, 3, 256, -5, 110, 9)
    lt, rt, st = _t(left, right, samples)
    lj, rj, sj = (jnp.asarray(a) for a in (left, right, samples))
    got = ops.gather_right_by_samples(rt, st, 96).numpy()
    want = np.asarray(gather_right_by_samples_pallas(rj, sj, 96,
                                                     interpret=True))
    np.testing.assert_array_equal(got, want)
    got = ops.gwc_volume_from_samples(lt, rt, st, 4, 96).numpy()
    want = np.asarray(gwc_volume_from_samples_pallas(lj, rj, sj, 4, 96,
                                                     interpret=True))
    np.testing.assert_allclose(got, want, **TOL)


def test_cpu_sample_ops_are_the_plain_versions():
    """On the CPU the wrappers launch nothing and equal their plain
    versions."""
    left, right = _feats(1, 2, 12, 8, 10)
    samples = _samples(1, 4, 2, 12, 0, 8, 11)
    lt, rt, st = _t(left, right, samples)
    fns = (ops.gather_right_by_samples, ops.gwc_volume_from_samples,
           ops.build_concat_volume)
    before = [(f.launches, dict(f.shapes)) for f in fns]
    torch.testing.assert_close(
        ops.gather_right_by_samples(rt, st, 8),
        ops.gather_right_by_samples_reference(rt, st, 8), rtol=0, atol=0)
    torch.testing.assert_close(
        ops.gwc_volume_from_samples(lt, rt, st, 2, 8),
        ops.gwc_volume_from_samples_reference(lt, rt, st, 2, 8),
        rtol=0, atol=0)
    torch.testing.assert_close(ops.build_concat_volume(lt, rt, 5),
                               ops.concat_volume_reference(lt, rt, 5),
                               rtol=0, atol=0)
    assert [(f.launches, dict(f.shapes)) for f in fns] == before


def test_disparity_variance_matches_jax():
    rng = np.random.RandomState(12)
    logits = rng.randn(2, 9, 4, 5).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    disp = (rng.rand(2, 4, 5) * 8).astype(np.float32)
    got = ops.disparity_variance(*_t(prob, disp)).numpy()
    want = np.asarray(jops.disparity_variance(jnp.asarray(prob),
                                              jnp.asarray(disp)))
    np.testing.assert_allclose(got, want, **TOL)


def test_disparity_variance_confidence_matches_jax():
    rng = np.random.RandomState(13)
    logits = rng.randn(2, 6, 4, 5).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    samples = _samples(2, 6, 4, 5, 0, 30, 14)
    disp = (prob * samples).sum(1)
    got = ops.disparity_variance_confidence(*_t(prob, samples, disp)).numpy()
    want = np.asarray(jops.volume.disparity_variance_confidence(
        jnp.asarray(prob), jnp.asarray(samples), jnp.asarray(disp)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("size", [(8, 14), (5, 3)])
def test_resize_nearest_matches_jax(size):
    x = np.random.RandomState(15).randn(2, 4, 7, 3).astype(np.float32)
    got = ops.resize_nearest(torch.from_numpy(x), size, (1, 2)).numpy()
    want = np.asarray(jops.resize_nearest(jnp.asarray(x), size, (1, 2)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("window,stride", [((2, 3), None), ((3, 2), (2, 3)),
                                           (1, None)])
def test_avg_pool_matches_jax(window, stride):
    x = np.random.RandomState(16).randn(2, 9, 11, 4).astype(np.float32)
    got = avg_pool(torch.from_numpy(x), window, stride).numpy()
    want = np.asarray(jl.avg_pool(jnp.asarray(x), window, stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)
