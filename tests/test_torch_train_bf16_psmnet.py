"""PSMNet's bfloat16 train step in the port against the JAX package's
``--bf16`` step, on the CPU.

One step of PSMNet(max_disp=16) at 48×64, B 2, on the batch of
``tests/test_trainer.py::_batch``, from JAX's ``init`` variables carried
across: the port's float32 model trains on a bfloat16 view of its parameters
(``make_train_step(..., dtype=torch.bfloat16)``), JAX's ``create_model(...,
dtype=jnp.bfloat16)`` casts its float32 params at use. The gates
(`_torch_train_parity`): the loss, each head and the running statistics
within 2× JAX's own bfloat16-vs-float32 distance; the gradients of the leaf
groups whose JAX float32 gradient moves less than 10% under a 1e-3 input
perturbation (here the ``classif*`` heads) likewise; the dtypes of every
conv and BatchNorm call, exactly; three trainer steps' losses within 1e-2,
or 2× the spread of JAX's own trajectories where that is wider.
"""

import jax.numpy as jnp
import pytest
import torch

from _torch_train_parity import (bf16_step, check_bf16_audit,
                                 check_bf16_loss_and_heads,
                                 check_bf16_stable_gradients,
                                 check_bf16_statistics,
                                 check_bf16_three_steps)
from stereo_toolbox_tpu.models import create_model as jax_create_model
from stereo_toolbox_tpu_torch.train import LOSS_WEIGHTS
from stereo_toolbox_tpu_torch.trainer import TrainConfig
from test_trainer import _batch

torch.set_num_threads(2)

NAME, MAX_DISP = "PSMNet", 16


@pytest.fixture(scope="module")
def step():
    config = TrainConfig(lr=1e-3, max_disp=MAX_DISP, loss="multihead",
                         clip_grad=1.0, loss_weights=LOSS_WEIGHTS[NAME])
    jmodels = {k: jax_create_model(NAME, max_disp=MAX_DISP, dtype=dtype)
               for k, dtype in (("f32", None), ("bf16", jnp.bfloat16))}
    return bf16_step(NAME, jmodels, config, _batch())


def test_bf16_loss_and_heads_match_jax(step):
    check_bf16_loss_and_heads(step)


def test_bf16_batchnorm_statistics_match_jax(step):
    check_bf16_statistics(step)


def test_bf16_stable_gradients_match_jax(step):
    check_bf16_stable_gradients(step, expect="classif")


def test_bf16_dtypes_match_jax(step):
    check_bf16_audit(step)


def test_bf16_three_steps_losses_match_jax(step):
    check_bf16_three_steps(step)
