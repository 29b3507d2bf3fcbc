"""ACVNet's train step in the port against the JAX package's, on the CPU.

One step of ACVNet(max_disp=16) at 48×64, B 2, on the batch of
``tests/test_trainer.py::_batch``, from JAX's ``init`` variables carried
across, against JAX's loss function under ``value_and_grad``
(`_torch_train_parity`): the loss, the gradients in float64 on both sides
and in float32, the new running statistics (the 2D trunk and
``concatconv`` updated once per view, left first), and three trainer
steps. Four heads, ``[pred_attention, pred0, pred1, pred2]``, under the
multi-head weights (0.5, 0.5, 0.7, 1.0). The staged-training modes are in
`tests/test_torch_train_acvnet_staged.py`.
"""

import pytest
import torch

from _torch_train_parity import (check_gradients32, check_gradients64,
                                 check_loss, check_statistics,
                                 check_three_steps, one_step as parity_step)
from stereo_toolbox_tpu.models import create_model as jax_create_model
from stereo_toolbox_tpu_torch.train import LOSS_WEIGHTS
from stereo_toolbox_tpu_torch.trainer import TrainConfig
from test_trainer import _batch

torch.set_num_threads(2)

MAX_DISP = 16


@pytest.fixture(scope="module")
def one_step():
    config = TrainConfig(lr=1e-3, max_disp=MAX_DISP, loss="multihead",
                         clip_grad=1.0, loss_weights=LOSS_WEIGHTS["ACVNet"])
    return parity_step("ACVNet", jax_create_model("ACVNet", max_disp=MAX_DISP),
                       config, _batch())


def test_train_step_loss_matches_jax(one_step):
    check_loss(one_step)


def test_train_step_gradients_match_jax_in_float64(one_step):
    check_gradients64(one_step)


def test_train_step_gradients_match_jax(one_step):
    """float32: global relative L2 ≤ 5e-2, each leaf ≤ 0.5 · its max|ref|,
    the floor of the ReLU models (`tests/test_torch_trainer.py`): ACVNet's
    trunk, hourglasses and heads are GwcNet's ReLU blocks (measured 2.2e-2
    / 0.15)."""
    check_gradients32(one_step, 5e-2, 0.5)


def test_train_step_batchnorm_statistics_match_jax(one_step):
    check_statistics(one_step)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-4),
                                        (torch.float32, 1e-2)])
def test_three_steps_losses_match_jax(one_step, dtype, rtol):
    """float32 at 1e-2: Adam's sign-like first update turns the float32
    gradient's floor into full-size steps (measured 3.2e-3)."""
    check_three_steps(one_step, dtype, rtol)
