"""The port's metrics and supervised losses against the JAX package's on
the same numpy arrays (NaN ground truth, empty masks, |diff| exactly 1 at
the smooth-L1 kink, sequences with and without an initial disparity).
Bound: 1e-6 relative (float32 elementwise work and sums in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu import losses as jlosses
from stereo_toolbox_tpu import metrics as jmetrics
from stereo_toolbox_tpu_torch import losses, metrics

RTOL = 1e-6


def _maps(seed, b=2, h=6, w=9, max_disp=16):
    """pred, gt ``[B, H, W]`` with NaN, zero, out-of-range and exactly-1
    differences in gt; image 1 has no valid pixel."""
    rng = np.random.RandomState(seed)
    gt = rng.uniform(-2, max_disp + 2, (b, h, w)).astype(np.float32)
    pred = (gt + rng.uniform(-4, 4, gt.shape)).astype(np.float32)
    gt[0, 0, :3] = np.nan
    gt[0, 1, 0] = 0.0
    pred[0, 2, :4] = gt[0, 2, :4] + np.float32(1.0)    # |diff| == 1
    pred[0, 3, :2] = gt[0, 3, :2] - np.float32(1.0)
    gt[1] = np.nan                                    # empty mask
    noc = rng.uniform(0, 1, (b, h, w)).astype(np.float32)
    noc[0, 4] = np.nan
    return pred, gt, noc


def _both(*arrays):
    return ([torch.from_numpy(a) for a in arrays],
            [jnp.asarray(a) for a in arrays])


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_valid_mask_and_split_match_jax(seed):
    pred, gt, noc = _maps(seed)
    (tg, tn), (jg, jn) = _both(gt, noc)
    mask = metrics.valid_mask(tg, 16)
    jmask = jmetrics.valid_mask(jg, 16)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert not mask[1].any() and mask[0].any()
    for got, want in zip(metrics.occ_noc_split(mask, tn),
                         jmetrics.occ_noc_split(jmask, jn)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("noc_kind", ["nan", "partly_nan", "finite"])
def test_occ_noc_split_of_nan_masks_matches_jax(noc_kind):
    """A NaN noc mask (an absent file), one NaN in part and a finite one:
    the port's split is JAX's, and NaN counts as occluded in both."""
    _, gt, noc = _maps(3)
    if noc_kind == "nan":
        noc = np.full_like(noc, np.nan)
    elif noc_kind == "partly_nan":
        noc[:, ::2] = np.nan
    else:
        noc = np.nan_to_num(noc, nan=0.75)
    (tg, tn), (jg, jn) = _both(gt, noc)
    got = metrics.occ_noc_split(metrics.valid_mask(tg, 16), tn)
    want = jmetrics.occ_noc_split(jmetrics.valid_mask(jg, 16), jn)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    every, noc_m, occ = got
    assert not (noc_m & torch.isnan(tn)).any()
    assert torch.equal(occ | noc_m, every) and not (occ & noc_m).any()
    if noc_kind == "nan":
        assert not noc_m.any() and torch.equal(occ, every) and every.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_epe_and_outliers_match_jax(seed):
    pred, gt, _ = _maps(seed)
    (tp, tg), (jp, jg) = _both(pred, gt)
    got = metrics.epe_and_outliers(tp, tg, metrics.valid_mask(tg, 16))
    want = jmetrics.epe_and_outliers(jp, jg, jmetrics.valid_mask(jg, 16))
    assert set(got) == set(want) == {"epe", "valid", "out_1px", "out_2px",
                                     "out_3px"}
    for key in got:
        _close(got[key], want[key])
    assert got["epe"][1] == 0 and got["valid"][1] == 0     # empty image


def test_masked_mean_of_an_empty_mask_is_zero():
    x = torch.ones(2, 3)
    empty = torch.zeros(2, 3, dtype=torch.bool)
    assert metrics.masked_mean(x, empty).item() == 0.0
    np.testing.assert_array_equal(
        metrics.masked_mean(x, empty, axis=(1,)).numpy(), [0.0, 0.0])
    want = jmetrics.masked_mean(jnp.ones((2, 3)), jnp.zeros((2, 3), bool))
    assert float(want) == 0.0


@pytest.mark.parametrize("beta", [1.0, 0.5])
def test_smooth_l1_matches_jax_and_torch_at_the_kink(beta):
    diff = np.array([-2.0, -1.0, -0.5, 0.0, 0.25, 0.5, 1.0, 1.5, 3.0],
                    np.float32)
    target = np.zeros_like(diff)
    (tp, tt), (jp, jt) = _both(diff, target)
    got = losses.smooth_l1(tp, tt, beta)
    _close(got, jlosses.smooth_l1(jp, jt, beta))
    torch.testing.assert_close(got, torch.nn.functional.smooth_l1_loss(
        tp, tt, reduction="none", beta=beta), rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_smooth_l1_matches_jax(seed):
    pred, gt, _ = _maps(seed)
    (tp, tg), (jp, jg) = _both(pred, gt)
    got = losses.masked_smooth_l1(tp, tg, metrics.valid_mask(tg, 16))
    _close(got, jlosses.masked_smooth_l1(jp, jg, jmetrics.valid_mask(jg, 16)))
    assert torch.isfinite(got)


def test_masked_smooth_l1_gradient_skips_nan_gt():
    pred, gt, _ = _maps(0)
    tp = torch.from_numpy(pred).requires_grad_()
    tg = torch.from_numpy(gt)
    losses.masked_smooth_l1(tp, tg, metrics.valid_mask(tg, 16)).backward()
    assert torch.isfinite(tp.grad).all()
    assert not tp.grad[1].any() and not tp.grad[0, 0, :3].any()


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("with_init", [False, True])
def test_sequence_loss_matches_jax(n, with_init):
    preds, jpreds = [], []
    for i in range(n):
        p, gt, _ = _maps(10 + i)
        preds.append(torch.from_numpy(p))
        jpreds.append(jnp.asarray(p))
    _, gt, _ = _maps(10)
    init = _maps(20)[0] if with_init else None
    tg, jg = torch.from_numpy(gt), jnp.asarray(gt)
    got = losses.sequence_loss(
        preds, tg, metrics.valid_mask(tg, 16),
        init_disp=None if init is None else torch.from_numpy(init),
        loss_gamma=0.8)
    want = jlosses.sequence_loss(
        jpreds, jg, jmetrics.valid_mask(jg, 16),
        init_disp=None if init is None else jnp.asarray(init),
        loss_gamma=0.8)
    _close(got, want)
    # a stacked [n, B, H, W] tensor is the same sequence
    stacked = losses.sequence_loss(
        torch.stack(preds), tg, metrics.valid_mask(tg, 16),
        init_disp=None if init is None else torch.from_numpy(init),
        loss_gamma=0.8)
    torch.testing.assert_close(stacked, got, rtol=0, atol=0)


def test_multi_head_loss_matches_jax():
    heads = [_maps(30 + i)[0] for i in range(3)]
    _, gt, _ = _maps(30)
    tg, jg = torch.from_numpy(gt), jnp.asarray(gt)
    weights = (0.5, 0.7, 1.0)
    got = losses.multi_head_loss([torch.from_numpy(h) for h in heads], tg,
                                 metrics.valid_mask(tg, 16), weights)
    want = jlosses.multi_head_loss([jnp.asarray(h) for h in heads], jg,
                                   jmetrics.valid_mask(jg, 16), weights)
    _close(got, want)
    with pytest.raises(ValueError):
        losses.multi_head_loss([torch.from_numpy(heads[0])], tg,
                               metrics.valid_mask(tg, 16), weights)
