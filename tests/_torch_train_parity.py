"""The JAX side of the port's train-step parity tests, and the comparisons.

One train step of a port model against the JAX package's loss function
under ``value_and_grad`` on the same batch, from JAX's ``init`` variables
carried across (``utils.weights.from_jax_variables``): the loss, the
gradients (mapped to JAX names through the JAX package's own importer,
which is linear like the weight carry), the new BatchNorm running
statistics, and a few steps of the trainer on both sides. Used by
``tests/test_torch_trainer.py`` and ``tests/test_torch_train_*.py``.
"""

from __future__ import annotations

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from stereo_toolbox_tpu import metrics as jmetrics
from stereo_toolbox_tpu import trainer as jtrainer
from stereo_toolbox_tpu.utils.torch_import import import_torch_checkpoint
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.trainer import (TrainState, init_train_state,
                                              make_train_step, to_device)
from stereo_toolbox_tpu_torch.utils.weights import from_jax_variables

BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def jax_config(config):
    """The JAX trainer's config for the port's `config`."""
    return jtrainer.TrainConfig(lr=config.lr, max_disp=config.max_disp,
                                loss=config.loss, clip_grad=config.clip_grad,
                                loss_weights=config.loss_weights)


def grad_fn(model, config, batch, dtype=np.float32):
    """The JAX trainer's loss function of ``(params, batch_stats)`` under
    value_and_grad, on `batch` in `dtype`."""
    left, right, gt = (jnp.asarray(batch[k].astype(dtype))
                       for k in ("left", "right", "gt_disp"))
    mask = jmetrics.valid_mask(gt, config.max_disp)

    def loss_fn(params, stats):
        outputs, updates = model.apply(
            {"params": params, "batch_stats": stats}, left, right,
            train=True, mutable=["batch_stats"])
        return (jtrainer.compute_loss(outputs, gt, mask, config),
                updates["batch_stats"])
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def jax_side(model, config, batch, steps=3, init_model=None):
    """JAX's init variables (of `init_model`, `model` by default); for
    `steps` steps of the JAX trainer's loss function under value_and_grad
    plus its optimizer: the loss and gradients of the first, the new
    running statistics after it, the losses of all; and the first step's
    gradients and all losses in float64."""
    x = jnp.asarray(batch["left"][:1])
    variables = jax.jit((init_model or model).init, static_argnames="train")(
        jax.random.PRNGKey(0), x, x, train=True)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tx, _ = jtrainer.make_optimizer(config, 30)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    def run(fn, variables):
        params, stats = variables["params"], variables["batch_stats"]
        opt_state = jax.jit(tx.init)(params)
        losses = []
        for i in range(steps):
            (loss, new_stats), grads = fn(params, stats)
            if i == 0:
                first = (float(loss),
                         jax.tree_util.tree_map(np.asarray, grads),
                         jax.tree_util.tree_map(np.asarray, new_stats))
            params, opt_state = update(grads, opt_state, params)
            stats = new_stats
            losses.append(float(loss))
        return first, losses

    def run64():
        with jax.enable_x64(True):      # a thread-local setting
            return run(grad_fn(model, config, batch, np.float64),
                       jax.tree_util.tree_map(
                           lambda a: a.astype(np.float64), variables))

    # XLA compiles the float64 and float32 steps side by side
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(run64)
        first, losses = run(grad_fn(model, config, batch), variables)
        (_, grads64, _), losses64 = job.result()
    return variables, first, losses, (grads64, losses64)


class Recorder:
    """An optimizer that keeps the gradients it is given."""
    count = 0

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]


def one_step(name, jmodel, config, batch, model_kw=None, init_model=None):
    """The JAX side (`jax_side`) and one step of the port's `name` (built
    with `model_kw`, JAX's variables carried) in float64 and float32: the
    dict the parity tests read."""
    model_kw = model_kw or {}
    variables, (loss, grads, stats), losses, (grads64, losses64) = \
        jax_side(jmodel, jax_config(config), batch, init_model=init_model)
    got = {}
    for dtype in (torch.float64, torch.float32):
        model = create_model(name, max_disp=config.max_disp, device="cpu",
                             **model_kw)
        model.load_state_dict(from_jax_variables(name, variables))
        init = {k: v.clone() for k, v in model.state_dict().items()}
        model.to(dtype)
        recorder = Recorder()
        _, got_loss = make_train_step(model, config)(
            TrainState(model.train(), recorder),
            {k: v.to(dtype) for k, v in to_device(batch, "cpu").items()})
        got[dtype] = (float(got_loss), recorder.grads)
    after = {k: v.clone() for k, v in model.state_dict().items()}
    return dict(name=name, batch=batch, model=model, config=config,
                init=init, after=after, got_loss=got[torch.float32][0],
                got_grads=got[torch.float32][1],
                got_grads64=got[torch.float64][1], loss=loss, grads=grads,
                grads64=grads64, stats=stats, losses=losses,
                losses64=losses64)


def to_jax_names(name, model, tensors):
    """`tensors` (one per parameter of `model`, in order) as a JAX params
    tree, through the JAX package's importer with the model's buffers."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()
          if k.endswith(BUFFERS)}
    for (k, _), t in zip(model.named_parameters(), tensors):
        sd[k] = t.numpy()
    return import_torch_checkpoint(name, sd)


def leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def gradient_errors(step, got, want):
    """(global relative L2, worst leaf's max|Δ| / max|ref|) of the port's
    gradients `got` (one per parameter) against JAX's tree `want`; a leaf
    that is zero in JAX must be exactly zero in the port (else its error is
    infinite)."""
    got = leaves(to_jax_names(step["name"], step["model"],
                              [g.float() for g in got])["params"])
    want = leaves(want)
    assert set(got) == set(want)
    num = sum(float(((got[k] - want[k]) ** 2).sum()) for k in want)
    den = sum(float((want[k] ** 2).sum()) for k in want)
    leaf = 0.0
    for k, w in want.items():
        ref = np.abs(w).max()
        err = np.abs(got[k] - w).max()
        leaf = max(leaf, float(err / ref) if ref > 0
                   else (0.0 if err == 0 else float("inf")))
    return (num / den) ** 0.5, leaf


def stats_errors(step, state_dict):
    """The running statistics of the port's `state_dict` against JAX's
    after the step: the largest |Δmean| / √var and |Δvar| / var over every
    channel (a mean in units of its channel's spread: a mean near 0 is
    rounding noise)."""
    back = import_torch_checkpoint(
        step["name"], {k: v.numpy() for k, v in state_dict.items()}
    )["batch_stats"]
    errs = {"mean": 0.0, "var": 0.0}

    def visit(got, want):
        if "var" not in want:
            for k in want:
                visit(got[k], want[k])
            return
        var = np.asarray(want["var"], np.float64)
        errs["mean"] = max(errs["mean"], float(
            (np.abs(got["mean"] - want["mean"]) / np.sqrt(var)).max()))
        errs["var"] = max(errs["var"], float(
            (np.abs(got["var"] - var) / var).max()))
    visit(back, step["stats"])
    return errs


def trainer_losses(step, dtype, steps=3):
    """`steps` steps of the port's trainer (optimizer and all) from the
    carried weights in `dtype`: their losses. The model is left in
    float32."""
    model = step["model"]
    model.load_state_dict(step["init"])
    model.to(dtype)
    state = init_train_state(model, step["config"], 30)
    train_step = make_train_step(model, step["config"])
    batch = {k: v.to(dtype) for k, v in
             to_device(step["batch"], "cpu").items()}
    losses = []
    for _ in range(steps):
        state, loss = train_step(state, batch)
        losses.append(float(loss))
    model.to(torch.float32)
    assert state.step == steps
    return losses


# ------------------------------------------------------------ the checks
# Bounds of every parity step, as the acceptance of the port's training
# path fixes them: the loss 1e-5 relative; float64 gradients (both sides)
# 1e-4 global relative L2 and 1e-3 · max|ref| a leaf; the running
# statistics 1e-5; three trainer steps' losses 1e-4 in float64. The float32
# gradient bounds are each model's floor, stated by its test.


def check_loss(step):
    np.testing.assert_allclose(step["got_loss"], step["loss"], rtol=1e-5)


def check_gradients64(step):
    rel, leaf = gradient_errors(step, step["got_grads64"], step["grads64"])
    print(f"{step['name']} float64: gradients' global relative L2 "
          f"{rel:.3e}, worst leaf {leaf:.3e}")
    assert rel <= 1e-4 and leaf <= 1e-3


def check_gradients32(step, rel_bound, leaf_bound):
    rel, leaf = gradient_errors(step, step["got_grads"], step["grads"])
    print(f"{step['name']} float32: gradients' global relative L2 "
          f"{rel:.3e}, worst leaf {leaf:.3e}")
    assert rel <= rel_bound and leaf <= leaf_bound


def check_statistics(step):
    errs = stats_errors(step, step["after"])
    print(f"{step['name']}: running statistics, max relative error {errs}")
    assert errs["mean"] <= 1e-5 and errs["var"] <= 1e-5


def check_three_steps(step, dtype, rtol):
    losses = trainer_losses(step, dtype)
    want = step["losses64" if dtype == torch.float64 else "losses"]
    print(f"{step['name']} {dtype}: losses {losses} vs JAX {want}")
    np.testing.assert_allclose(losses, want, rtol=rtol)
