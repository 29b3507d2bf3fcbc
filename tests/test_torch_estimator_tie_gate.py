"""The rounding bound behind ``chip_smoke.py``'s dominant-modal tie gate
(phase 15), on the CPU.

The card and the CPU sum the dominant-modal estimator's two masses (its top
mode's y and its runner-up's z, up to D = 192 float32 terms each) in
different orders, so at a near-tie they may pick different modes. Phase 15
excuses such a pixel only where ``|y − z| ≤ 2·γ_{D−1}·(y + z)``
(`chip_smoke.tie_bound`). Here, on a seeded near-tie ``[1, 192, H, W]``
volume whose first mode carries a softmax floor just below float32's half
ulp at 0.5 (so one order keeps the floor and the other rounds it away), the
two orders' ``ŷ − ẑ`` differ by more than the old fixed margin 1e-6, and by
no more than the bound at any pixel; a pixel whose masses are pushed apart
past the bound is not excused.

``chip_smoke`` exits at import without a card; it is imported here with
``torch.cuda.is_available`` stubbed (nothing else of it runs).
"""

import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
D, H, W = 192, 16, 32
OLD_TIE = 1e-6                   # phase 15's fixed margin before the bound
FLOOR = 60                       # floor planes around the first peak


@pytest.fixture(scope="module")
def chip_smoke():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "is_available", lambda: True)
        mp.syspath_prepend(str(ROOT))
        return importlib.import_module("chip_smoke")


def near_tie_volume(seed: int = 0) -> torch.Tensor:
    """Two one-plane peaks of mass ~0.5 each, 1e-6 apart at random, the
    first at c1 ∈ [30, 60) inside a floor of FLOOR planes of 1–2.9e-8 (a
    softmax's tail) that its modal window holds, the second at c2 ∈ [130,
    160); normalised over D in float64, then float32."""
    rng = np.random.RandomState(seed)
    p = np.zeros((D, H, W))
    c1 = rng.randint(30, 60, (H, W))
    c2 = rng.randint(130, 160, (H, W))
    eps = rng.uniform(1e-8, 2.9e-8, (H, W))
    rows, cols = np.indices((H, W))
    for k in range(-FLOOR // 2, FLOOR // 2 + 1):
        p[c1 + k, rows, cols] = eps
    a = 0.5 + 1e-6 * rng.randn(H, W)
    p[c1, rows, cols] = a
    p[c2, rows, cols] = 1.0 - a - FLOOR * eps
    p /= p.sum(0)
    return torch.from_numpy(p[None]).float()


def sorted_sum(terms: torch.Tensor, descending: bool) -> torch.Tensor:
    """Each pixel's terms summed one at a time in float32, smallest first
    or largest first."""
    t = torch.sort(terms, dim=1, descending=descending).values
    s = torch.zeros_like(t[:, 0])
    for i in range(t.shape[1]):
        s = s + t[:, i]
    return s.double()


def test_two_summation_orders_stay_within_the_bound(chip_smoke):
    prob = near_tie_volume()
    y_terms, z_terms = chip_smoke.modal_terms(prob)
    y, z = y_terms.double().sum(1), z_terms.double().sum(1)
    bound = chip_smoke.tie_bound(y, z, D)
    up, down = ((sorted_sum(y_terms, s) - sorted_sum(z_terms, s))
                for s in (False, True))
    apart = (up - down).abs()
    print(f"orders apart: max {apart.max().item():.3e}, pixels past "
          f"{OLD_TIE}: {int((apart > OLD_TIE).sum())} of {H * W}; bound "
          f"{bound.min().item():.3e}..{bound.max().item():.3e}")
    assert (apart > OLD_TIE).any()
    assert bool((apart <= bound).all())
    for order in (up, down):
        assert bool(((order - (y - z)).abs() <= bound / 2).all())
    # where the two orders pick different modes, the gate excuses the pixel
    tied, margin = chip_smoke.rounding_ties(prob)
    flips = (up >= 0) != (down >= 0)
    assert bool(tied[flips].all())
    assert torch.equal(margin, (y - z).abs())


def test_masses_apart_beyond_the_bound_are_not_excused(chip_smoke):
    prob = near_tie_volume()
    tied, _ = chip_smoke.rounding_ties(prob)
    assert bool(tied[0, 0, 0])
    y_terms, z_terms = chip_smoke.modal_terms(prob)
    y = y_terms[0, :, 0, 0].double().sum()
    z = z_terms[0, :, 0, 0].double().sum()
    # the runner-up's terms scaled so that y − z is twice the bound
    target = y - 2 * chip_smoke.tie_bound(y, z, D)
    pushed = prob.clone()
    runner_up = z_terms[0, :, 0, 0] > 0
    pushed[0, runner_up, 0, 0] *= float(target / z)
    tied, margin = chip_smoke.rounding_ties(pushed)
    y_terms, z_terms = chip_smoke.modal_terms(pushed)
    y, z = (t[0, :, 0, 0].double().sum() for t in (y_terms, z_terms))
    assert margin[0, 0, 0] > chip_smoke.tie_bound(y, z, D)
    assert margin[0, 0, 0] < 1e-4
    assert not bool(tied[0, 0, 0])
    assert bool(tied[0].flatten()[1:].all())
