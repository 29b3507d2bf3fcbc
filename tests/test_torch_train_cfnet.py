"""CFNet's train step in the port against the JAX package's, on the CPU.

One step of CFNet(max_disp=32, 6 samples a stage) at 64×64, B 2, on
``tests/test_trainer.py::_batch(2, 64, 64)``, from JAX's ``init``
variables carried across, against JAX's loss function under
``value_and_grad`` with the sequence loss over its nine heads, as JAX's own
CFNet gradient check takes (`_torch_train_parity`): the loss, the gradients
in float64 on both sides and in float32, the new running statistics, and
three trainer steps. The cascade floors its search bounds into integer
samples: a bound within rounding of an integer can take another sample on
either side, which moves every gradient behind it. The float32 bound is set
from the count of such bounds in this batch (`test_no_sample_bound_sits_
within_float32_rounding_of_an_integer`).
"""

import numpy as np
import pytest
import torch

from _torch_train_parity import (check_gradients32, check_gradients64,
                                 check_loss, check_statistics,
                                 check_three_steps, one_step as parity_step)
from stereo_toolbox_tpu.models import create_model as jax_create_model
from stereo_toolbox_tpu_torch.models import cfnet
from stereo_toolbox_tpu_torch.trainer import TrainConfig
from test_trainer import _batch

torch.set_num_threads(2)

MAX_DISP = 16 * 2
SAMPLES = dict(sample_count_s2=6, sample_count_s3=6)
# |value - its nearest integer| within float32 rounding: a few ulps of the
# values the cascade floors (below 32: an ulp is 2e-6 to 4e-6)
NEAR = 1e-5


@pytest.fixture(scope="module")
def one_step():
    """The parity step, recording every value the port's float32 step
    floors or ceils into a sample (`uniform_samples`' bounds and interior
    points)."""
    config = TrainConfig(lr=1e-3, max_disp=MAX_DISP, loss="sequence",
                         clip_grad=1.0)
    floored = []
    uniform = cfnet.uniform_samples

    def recording(min_d, max_d, count):
        if min_d.dtype == torch.float32:
            mult = (max_d - min_d) / (count + 1)
            steps = torch.arange(1.0, count + 1)[None, :, None, None]
            floored.append(torch.cat([min_d[:, None], max_d[:, None],
                                      min_d[:, None] + mult[:, None] * steps],
                                     1).detach())
        return uniform(min_d, max_d, count)

    cfnet.uniform_samples = recording
    try:
        step = parity_step("CFNet", jax_create_model("CFNet",
                                                     max_disp=MAX_DISP,
                                                     **SAMPLES),
                           config, _batch(2, 64, 64), model_kw=SAMPLES)
    finally:
        cfnet.uniform_samples = uniform
    step["floored"] = floored
    return step


def test_train_step_loss_matches_jax(one_step):
    check_loss(one_step)


def test_train_step_gradients_match_jax_in_float64(one_step):
    check_gradients64(one_step)


def test_no_sample_bound_sits_within_float32_rounding_of_an_integer(
        one_step):
    """Of the values the float32 step floors into samples (two stages, 2 ×
    8 × 16 × 16 and 2 × 8 × 32 × 32 of them), the exact integers are only
    the search range's clamps (0, and each stage's cap: 7 at 1/4, 15 at
    1/2), which both sides reach exactly, and none of the others lies
    within float32 rounding (1e-5) of an integer (8 lie within 1e-4): no
    sample can take another integer from float32 rounding, so the float32
    gradient is held to its rounding floor."""
    values = torch.cat([v.flatten() for v in one_step["floored"]])
    frac = (values - values.round()).abs()
    near = ((frac > 0) & (frac < NEAR)).sum().item()
    exact = values[frac == 0]
    print(f"CFNet float32: {exact.numel()} of {values.numel()} floored "
          f"values exact integers ({sorted(set(exact.tolist()))}), {near} "
          f"within {NEAR} of one, "
          f"{((frac > 0) & (frac < 1e-4)).sum().item()} within 1e-4")
    assert values.numel() == 2 * 8 * (16 * 16 + 32 * 32)
    assert set(exact.tolist()) <= {0.0, 7.0, 15.0}
    assert near == 0


def test_train_step_gradients_match_jax(one_step):
    """float32: global relative L2 ≤ 1e-3, each leaf ≤ 1e-2 · its
    max|ref|. With no sample bound near an integer (the test above) and
    Mish (smooth, no kink) in every layer, the float32 gradient is
    determined to its rounding (measured 2.6e-5 / 9.3e-5)."""
    check_gradients32(one_step, 1e-3, 1e-2)


def test_train_step_batchnorm_statistics_match_jax(one_step):
    check_statistics(one_step)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-4),
                                        (torch.float32, 1e-2)])
def test_three_steps_losses_match_jax(one_step, dtype, rtol):
    """float64 measured 6.2e-5 at the third step (the cascade runs in
    float32 on both sides), float32 5.8e-5."""
    check_three_steps(one_step, dtype, rtol)


def test_search_range_scales_get_zero_gradients(one_step):
    """``gamma_s*`` and ``beta_s*`` reach the loss only through floored
    samples: their gradients are exactly zero, in JAX as in the port."""
    names = [k for k, _ in one_step["model"].named_parameters()]
    for grads in (one_step["got_grads64"], one_step["got_grads"]):
        for key in ("gamma_s3", "beta_s3", "gamma_s2", "beta_s2"):
            assert grads[names.index(key)].abs().max().item() == 0
    for key in ("gamma_s3", "beta_s3", "gamma_s2", "beta_s2"):
        assert np.abs(one_step["grads64"][key]).max() == 0
