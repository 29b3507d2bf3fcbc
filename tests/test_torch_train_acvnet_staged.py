"""ACVNet's staged-training modes in the port against the JAX package's,
on the CPU.

As `tests/test_torch_train_acvnet.py`, for the two staged-training modes
of the original: ``freeze_attn_weights`` (the attention branch's output
detached, JAX's ``stop_gradient``; three heads, weights (0.5, 0.7, 1.0),
JAX's own frozen-ACVNet test's) and ``attn_weights_only`` (the attention
branch alone; one head). Both take the full model's JAX ``init`` variables,
so the parameter sets match; a parameter that the mode leaves out of the
loss has a zero gradient on both sides, exactly. With
``freeze_attn_weights`` every attention-branch parameter's gradient is
exactly zero, as ``tests/test_models_zoo.py::test_acvnet_freeze_attn``
requires of JAX.
"""

import pytest
import torch

from _torch_train_parity import (check_gradients32, check_gradients64,
                                 check_loss, check_statistics,
                                 check_three_steps, one_step as parity_step)
from stereo_toolbox_tpu.models import create_model as jax_create_model
from stereo_toolbox_tpu_torch.trainer import TrainConfig
from test_trainer import _batch

torch.set_num_threads(2)

MAX_DISP = 16
MODES = {"freeze_attn_weights": (0.5, 0.7, 1.0), "attn_weights_only": (1.0,)}
ATTENTION = ("patch", "dres1_att_", "dres2_att_", "classif_att_")


@pytest.fixture(scope="module", params=list(MODES))
def one_step(request):
    mode = request.param
    config = TrainConfig(lr=1e-3, max_disp=MAX_DISP, loss="multihead",
                         clip_grad=1.0, loss_weights=MODES[mode])
    return parity_step("ACVNet", jax_create_model("ACVNet", max_disp=MAX_DISP,
                                                  **{mode: True}),
                       config, _batch(), model_kw={mode: True},
                       init_model=jax_create_model("ACVNet",
                                                   max_disp=MAX_DISP))


def test_train_step_loss_matches_jax(one_step):
    check_loss(one_step)


def test_train_step_gradients_match_jax_in_float64(one_step):
    check_gradients64(one_step)


def test_train_step_gradients_match_jax(one_step):
    """float32: global relative L2 ≤ 5e-2, each leaf ≤ 0.5 · its max|ref|,
    the floor of ACVNet's full model (`tests/test_torch_train_acvnet.py`)."""
    check_gradients32(one_step, 5e-2, 0.5)


def test_train_step_batchnorm_statistics_match_jax(one_step):
    check_statistics(one_step)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-4),
                                        (torch.float32, 1e-2)])
def test_three_steps_losses_match_jax(one_step, dtype, rtol):
    check_three_steps(one_step, dtype, rtol)


def test_attention_branch_gradients(one_step):
    """Frozen: every attention-branch parameter's gradient is exactly zero
    in float64 and float32, and the main branch's is not. Attention only:
    the attention branch's gradient is not zero, the main branch's is."""
    model = one_step["model"]
    frozen = model.freeze_attn_weights
    for grads in (one_step["got_grads64"], one_step["got_grads"]):
        attn, main = [], []
        for (key, _), g in zip(model.named_parameters(), grads):
            if key.startswith(ATTENTION):
                attn.append(g.abs().max().item())
            elif key.startswith(("dres0", "dres1.", "dres2.", "dres3",
                                 "classif0", "classif1", "classif2")):
                main.append(g.abs().max().item())
        assert attn and main
        if frozen:
            assert max(attn) == 0 and max(main) > 0
        else:
            assert max(attn) > 0 and max(main) == 0
