"""ACVNet's bfloat16 train step in the port against the JAX package's
``--bf16`` step, on the CPU: the full model and its two staged-training
modes.

One step of ACVNet(max_disp=16) at 48×64, B 2, on the batch of
``tests/test_trainer.py::_batch``, from the full model's JAX ``init``
variables carried across (computed once, shared by the three): the full
model (four heads), ``freeze_attn_weights`` (the attention branch detached;
three heads, weights (0.5, 0.7, 1.0)) and ``attn_weights_only`` (the
attention branch alone; one head), as `tests/test_torch_train_acvnet.py` and
`tests/test_torch_train_acvnet_ staged.py` take them in float32. The port's
float32 model trains on a bfloat16 view of its parameters
(``make_train_step(..., dtype=torch.bfloat16)``), JAX's ``create_model(...,
dtype=jnp.bfloat16)`` casts its float32 params at use. The gates
(`_torch_train_parity`): the loss, each head and the running statistics
within 2× JAX's own bfloat16-vs-float32 distance; the gradients of the leaf
groups whose JAX float32 gradient moves less than 10% under a 1e-3 input
perturbation likewise; the dtypes of every conv, linear and BatchNorm call,
exactly (the depthwise ``patch`` convs, which JAX applies without a conv
module, by their multiset from JAX's jaxpr; ``final1x1``, which the port
applies by ``F.linear``, by that call); three trainer steps. A parameter
that a mode leaves out of the loss gets an exactly zero gradient.
"""

import jax.numpy as jnp
import pytest
import torch

from _torch_train_parity import (bf16_step, check_bf16_audit,
                                 check_bf16_loss_and_heads,
                                 check_bf16_stable_gradients,
                                 check_bf16_statistics,
                                 check_bf16_three_steps, init_variables)
from stereo_toolbox_tpu.models import create_model as jax_create_model
from stereo_toolbox_tpu_torch.train import LOSS_WEIGHTS
from stereo_toolbox_tpu_torch.trainer import TrainConfig
from test_trainer import _batch

torch.set_num_threads(2)

MAX_DISP = 16
MODES = {"full": LOSS_WEIGHTS["ACVNet"],
         "freeze_attn_weights": (0.5, 0.7, 1.0), "attn_weights_only": (1.0,)}
ATTENTION = ("patch", "dres1_att_", "dres2_att_", "classif_att_")


@pytest.fixture(scope="module")
def variables():
    """The full model's JAX init variables, shared by every mode."""
    return init_variables(jax_create_model("ACVNet", max_disp=MAX_DISP),
                          _batch())


@pytest.fixture(scope="module", params=list(MODES))
def step(request, variables):
    mode = request.param
    kw = {} if mode == "full" else {mode: True}
    config = TrainConfig(lr=1e-3, max_disp=MAX_DISP, loss="multihead",
                         clip_grad=1.0, loss_weights=MODES[mode])
    jmodels = {k: jax_create_model("ACVNet", max_disp=MAX_DISP, dtype=dtype,
                                   **kw)
               for k, dtype in (("f32", None), ("bf16", jnp.bfloat16))}
    return bf16_step("ACVNet", jmodels, config, _batch(), model_kw=kw,
                     variables=variables)


def test_bf16_loss_and_heads_match_jax(step):
    check_bf16_loss_and_heads(step)


def test_bf16_batchnorm_statistics_match_jax(step):
    check_bf16_statistics(step)


def test_bf16_stable_gradients_match_jax(step):
    check_bf16_stable_gradients(step)


def test_bf16_dtypes_match_jax(step):
    check_bf16_audit(step)


def test_bf16_three_steps_losses_match_jax(step):
    check_bf16_three_steps(step)


def test_bf16_left_out_branch_gets_zero_gradients(step):
    """Frozen: every attention-branch parameter's gradient is exactly
    zero; attention only: every main-branch parameter's is; the full
    model: neither."""
    model = step["model"]
    attn, main = [], []
    for (key, _), g in zip(model.named_parameters(), step["grads"]):
        if key.startswith(ATTENTION):
            attn.append(g.abs().max().item())
        elif key.startswith(("dres0", "dres1.", "dres2.", "dres3",
                             "classif0", "classif1", "classif2")):
            main.append(g.abs().max().item())
    assert attn and main
    if model.freeze_attn_weights:
        assert max(attn) == 0 and max(main) > 0
    elif model.attn_weights_only:
        assert max(attn) > 0 and max(main) == 0
    else:
        assert max(attn) > 0 and max(main) > 0
