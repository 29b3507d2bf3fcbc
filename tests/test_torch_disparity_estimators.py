"""The port's disparity estimators against the JAX package's, on the CPU.

`stereo_toolbox_tpu_torch.disparity_estimators` against
``stereo_toolbox_tpu.disparity_estimators`` on the same seeded ``[B, D, H,
W]`` probability volumes: unimodal and multimodal ones, exact ties at the
peak, peaks at d = 0 and at d = D − 1, flat runs, and modes asymmetric
enough to take the symmetric fallback. The argmax and the mode bounds must
be the same integers; the soft estimators must agree within 1e-6 relative
in float32, and are run in float64 as well (1e-12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu import disparity_estimators as jde
from stereo_toolbox_tpu_torch import disparity_estimators as de

SOFT = ("softargmax_disparity_estimator", "unimodal_disparity_estimator",
        "dominant_modal_disparity_estimator")
D = 24


def _normalised(logits):
    p = np.exp(logits - logits.max(axis=1, keepdims=True))
    return p / p.sum(axis=1, keepdims=True)


def _volumes() -> dict:
    """Seeded ``[2, D, 4, 5]`` volumes, float64, each a case of the
    estimators' branches."""
    rng = np.random.RandomState(0)
    b, h, w = 2, 4, 5
    d = np.arange(D, dtype=np.float64)[None, :, None, None]
    centre = rng.uniform(2, D - 3, (b, 1, h, w))
    vols = {"random": _normalised(rng.randn(b, D, h, w) * 2.0),
            "unimodal": _normalised(-(d - centre) ** 2 / 4.0)}
    second = np.clip(centre + rng.choice([-9, 9], (b, 1, h, w)), 0, D - 1)
    vols["bimodal"] = _normalised(np.logaddexp(
        -(d - centre) ** 2 / 2.0, np.log(rng.uniform(0.3, 1.5, (b, 1, h, w)))
        - (d - second) ** 2 / 3.0))
    tie = _normalised(rng.randn(b, D, h, w))
    top = tie.max(axis=1, keepdims=True)
    at = rng.randint(0, D - 6, (b, 1, h, w))
    for k in (0, 5):        # the same peak value at two places
        np.put_along_axis(tie, at + k, top * 1.5, axis=1)
    vols["tie"] = tie / tie.sum(axis=1, keepdims=True)
    edge = -np.abs(d - np.where(rng.rand(b, 1, h, w) < 0.5, 0, D - 1))
    vols["edge_peaks"] = _normalised(edge + 0.1 * rng.randn(b, D, h, w))
    # runs of three equal values at random levels: ties along D that the
    # bounds must neither count as a fall nor as a rise
    flat = np.repeat(rng.uniform(0.5, 2.0, (b, D // 3, h, w)), 3, axis=1)
    vols["flat_runs"] = flat / flat.sum(axis=1, keepdims=True)
    # a long slow rise to a peak off the middle, then a sharp fall: the
    # mode spans 0..D−1, |2·idx − l − r| ≥ 3, the symmetric fallback
    peak = rng.choice([3, 5, 17, 20], (b, 1, h, w))
    skew = np.where(d <= peak, 0.3 * (d - peak), -3.0 * (d - peak))
    vols["asymmetric"] = _normalised(skew + 0.01 * rng.randn(b, D, h, w))
    return vols


VOLUMES = _volumes()


def _pair(vol, dtype):
    """The volume in `dtype` as a tensor and as a NumPy array (made a JAX
    array inside ``jax.enable_x64`` where it is float64)."""
    vol = vol.astype({torch.float32: np.float32,
                      torch.float64: np.float64}[dtype])
    return torch.from_numpy(vol), vol


def test_the_volumes_cover_every_branch():
    """Each case does what its name says: ties at the peak, peaks at both
    ends, flat runs, and pixels that take the symmetric fallback."""
    v = VOLUMES
    top = v["tie"].max(axis=1, keepdims=True)
    assert ((v["tie"] == top).sum(axis=1) == 2).all()
    idx = v["edge_peaks"].argmax(axis=1)
    assert (idx == 0).any() and (idx == D - 1).any()
    assert (np.diff(v["flat_runs"], axis=1) == 0).any()
    for name in ("asymmetric", "bimodal", "random"):
        idx, lo, hi = (t.numpy() for t in
                       de.mode_bounds(torch.from_numpy(v[name])))
        fallback = np.abs(2 * idx - lo - hi) >= 3
        print(f"{name}: {fallback.sum()} of {fallback.size} pixels take "
              f"the symmetric fallback")
        if name == "asymmetric":
            assert fallback.all()
    assert any(np.abs(2 * i - lo - hi).min() < 3 for i, lo, hi in [
        (t.numpy() for t in de.mode_bounds(torch.from_numpy(v["random"])))])


@pytest.mark.parametrize("case", sorted(VOLUMES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bounds_and_argmax_match_jax_exactly(case, dtype):
    got_t, want_t = _pair(VOLUMES[case], dtype)
    with jax.enable_x64(dtype == torch.float64):
        want_t = jnp.asarray(want_t)
        want = jde.mode_bounds(want_t)
        want_mask = np.asarray(jde.modal_mask(want_t))
        want_arg = np.asarray(jde.argmax_disparity_estimator(want_t))
    got = de.mode_bounds(got_t)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (2, 1, 4, 5)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(de.modal_mask(got_t).numpy(), want_mask)
    arg = de.argmax_disparity_estimator(got_t)
    assert arg.dtype == dtype
    np.testing.assert_array_equal(arg.numpy(), want_arg)


@pytest.mark.parametrize("case", sorted(VOLUMES))
@pytest.mark.parametrize("name", SOFT)
@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-6),
                                        (torch.float64, 1e-12)])
def test_soft_estimators_match_jax(case, name, dtype, rtol):
    got_t, want_t = _pair(VOLUMES[case], dtype)
    with jax.enable_x64(dtype == torch.float64):
        want = np.asarray(getattr(jde, name)(jnp.asarray(want_t)))
    got = getattr(de, name)(got_t)
    assert got.dtype == dtype and got.shape == (2, 4, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * D)


def test_first_index_among_ties():
    """The argmax and the mode's index take the first of equal peaks."""
    p = torch.tensor([0.1, 0.3, 0.1, 0.3, 0.2]).reshape(1, 5, 1, 1)
    assert de.argmax_disparity_estimator(p).item() == 1
    idx, lo, hi = de.mode_bounds(p)
    assert (idx.item(), lo.item(), hi.item()) == (1, 0, 2)


def test_box_blur_matches_jax():
    vol = VOLUMES["random"].astype(np.float32)
    np.testing.assert_allclose(
        de._box_blur_d(torch.from_numpy(vol)).numpy(),
        np.asarray(jde._box_blur_d(jnp.asarray(vol))), rtol=1e-6,
        atol=1e-7)
