"""CFNet's bfloat16 train step in the port against the JAX package's ``--bf16``
step, on the CPU.

One step of CFNet(max_disp=32, 6 samples a stage) at 64×64, B 2, on
``tests/test_trainer.py::_batch(2, 64, 64)`` with the sequence loss over its
nine heads, as `tests/test_torch_train_cfnet.py` takes it, from JAX's
``init`` variables carried across: the port's float32 model trains on a
bfloat16 view of its parameters (``make_train_step(...,
dtype=torch.bfloat16)``), JAX's ``create_model(..., dtype=jnp.bfloat16)``
casts its float32 params at use. The gates (`_torch_train_parity`): the
loss, each head and the running statistics within 2× JAX's own bfloat16-vs-
float32 distance; the gradients of the leaf groups whose JAX float32
gradient moves less than 10% under a 1e-3 input perturbation likewise; the
dtypes of every conv and BatchNorm call, exactly; three trainer steps'
losses within 1e-2, or 2× the spread of JAX's own trajectories where that is
wider. The cascade floors its search bounds into samples, so rounding can
move a sample in either framework; JAX's own bfloat16-vs-float32 distance
carries such moves too. ``gamma_s*`` / ``beta_s*`` stay float32 leaves and
reach the loss only through the floors: zero gradients.
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
from stereo_toolbox_tpu_torch.trainer import TrainConfig
from test_trainer import _batch

torch.set_num_threads(2)

NAME, MAX_DISP = "CFNet", 32
SAMPLES = dict(sample_count_s2=6, sample_count_s3=6)


@pytest.fixture(scope="module")
def step():
    config = TrainConfig(lr=1e-3, max_disp=MAX_DISP, loss="sequence",
                         clip_grad=1.0)
    jmodels = {k: jax_create_model(NAME, max_disp=MAX_DISP, dtype=dtype,
                                   **SAMPLES)
               for k, dtype in (("f32", None), ("bf16", jnp.bfloat16))}
    return bf16_step(NAME, jmodels, config, _batch(2, 64, 64),
                     model_kw=SAMPLES)


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


def test_bf16_search_range_scales_get_zero_gradients(step):
    """``gamma_s*`` and ``beta_s*``: float32 leaves in the view, zero
    gradients, in JAX as in the port."""
    names = [k for k, _ in step["model"].named_parameters()]
    for key in ("gamma_s3", "beta_s3", "gamma_s2", "beta_s2"):
        grad = step["grads"][names.index(key)]
        assert grad.dtype == torch.float32 and grad.abs().max().item() == 0
        assert abs(step["bf16"][2][key]).max() == 0
