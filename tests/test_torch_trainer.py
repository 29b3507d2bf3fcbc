"""The port's training path against the JAX package's, on the CPU.

- The optimizer: the OneCycle schedule and Adam with global-norm clipping
  against optax (bound 1e-6 relative).
- One train step of PSMNet(max_disp=16) and GwcNet_G(max_disp=16) at 48×64,
  B = 2, on the batch of ``tests/test_trainer.py::_batch`` and JAX's
  ``init`` variables carried across (``utils.weights.from_jax_variables``):
  the loss (1e-5 relative), the gradients (global relative L2 ≤ 1e-4, each
  leaf's max|Δ| ≤ 1e-3 · its max|ref|; mapped to JAX names through the JAX
  package's own importer, which is linear like the weight carry) and the
  new BatchNorm running statistics (1e-5 relative) against JAX's loss
  function under ``value_and_grad``; then three steps' losses (1e-4
  relative). PyTorch's own BatchNorm update (the unbiased variance) misses
  the running-variance bound, and the test shows it.
- Overfit, resume (bit-exact on the CPU), the precision contract in
  training and the entry point.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_train_parity import (Recorder, check_gradients32,
                                 check_gradients64, check_loss,
                                 check_statistics, check_three_steps,
                                 one_step as parity_step, stats_errors)
from stereo_toolbox_tpu import trainer as jtrainer
from stereo_toolbox_tpu.models import create_model as jax_create_model
from stereo_toolbox_tpu_torch.datasets import (DataLoader,
                                               SyntheticStereoDataset)
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.nn.layers import FlaxRunningStats
from stereo_toolbox_tpu_torch.train import LOSS_WEIGHTS, TRAINABLE, parse_args
from stereo_toolbox_tpu_torch.trainer import (Adam, TrainConfig, TrainState,
                                              Trainer, init_train_state,
                                              make_optimizer,
                                              make_train_step,
                                              onecycle_schedule, to_device)
from test_trainer import _batch

torch.set_num_threads(2)

MAX_DISP = 16
WEIGHTS = {"PSMNet": (0.5, 0.7, 1.0), "GwcNet_G": (0.5, 0.5, 0.7, 1.0)}


def _config(name, **kw):
    return TrainConfig(lr=1e-3, max_disp=MAX_DISP, loss="multihead",
                       clip_grad=1.0, loss_weights=WEIGHTS[name], **kw)


# ------------------------------------------------------------- optimizer
@pytest.mark.parametrize("total,pct", [(100, 0.1), (37, 0.3), (5, 0.1)])
def test_schedule_matches_optax(total, pct):
    _, want = jtrainer.make_optimizer(
        jtrainer.TrainConfig(lr=2e-4, pct_start=pct), total)
    got = onecycle_schedule(2e-4, total, pct)
    warm = max(int(total * pct), 1)
    steps = {0, warm - 1, warm, (warm + total) // 2, total - 1, total}
    for s in sorted(steps):
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6)
    assert got(0) == pytest.approx(2e-4 / 25, rel=2e-6)   # float32


def _grad_tree(rng, scale):
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 3, 5)}
    return {k: (rng.randn(*s) * scale).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("clip", [1.0, None])
def test_adam_with_clipping_matches_optax(clip):
    """Five updates from gradients above and below max_norm (global norms
    ~8 and ~0.3), from zero parameters, against ``optax.chain(
    clip_by_global_norm, adam(schedule))``: parameters and both moments
    after every update within 1e-6 · max|ref| of each leaf."""
    rng = np.random.RandomState(0)
    total = 10
    config = jtrainer.TrainConfig(lr=1e-2, clip_grad=clip or 0.0)
    tx, _ = jtrainer.make_optimizer(config, total)
    names = ("a", "b", "c")
    jparams = {k: jnp.zeros(v.shape, jnp.float32)
               for k, v in _grad_tree(rng, 1).items()}
    opt_state = tx.init(jparams)
    params = [torch.zeros(jparams[k].shape) for k in names]
    opt = Adam(params, onecycle_schedule(1e-2, total, 0.1), clip=clip)
    for i, scale in enumerate((2.0, 0.05, 2.0, 0.05, 1.0)):
        grads = _grad_tree(rng, scale)
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, opt_state,
            jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.step([torch.from_numpy(grads[k]) for k in names])
        adam_state = opt_state[-1][0]
        for j, k in enumerate(names):
            for got, want in ((params[j], jparams[k]),
                              (opt.mu[j], adam_state.mu[k]),
                              (opt.nu[j], adam_state.nu[k])):
                want = np.asarray(want)
                err = np.abs(got.numpy() - want).max()
                assert err <= 1e-6 * np.abs(want).max(), (i, k, err)
    assert opt.count == 5


def test_optimizer_takes_no_weight_decay():
    model = torch.nn.Linear(3, 2)
    opt, _ = make_optimizer(model, TrainConfig(weight_decay=0.5), 10)
    before = [p.detach().clone() for p in model.parameters()]
    opt.step([torch.zeros_like(p) for p in model.parameters()])
    for p, b in zip(model.parameters(), before):
        torch.testing.assert_close(p.detach(), b, rtol=0, atol=0)


# ------------------------------------------------------- one train step
@pytest.fixture(scope="module", params=["PSMNet", "GwcNet_G"])
def one_step(request):
    name = request.param
    return parity_step(name, jax_create_model(name, max_disp=MAX_DISP),
                       _config(name), _batch())


def test_train_step_loss_matches_jax(one_step):
    check_loss(one_step)


def test_train_step_gradients_match_jax_in_float64(one_step):
    """The same step with float64 models on both sides (the heads' softmax
    and regression in float32 on both, as in the float32 step): global
    relative L2 ≤ 1e-4 and each leaf's max|Δ| ≤ 1e-3 · its max|ref|."""
    check_gradients64(one_step)


def test_train_step_gradients_match_jax(one_step):
    """float32, as the step runs: global relative L2 ≤ 5e-2, each leaf's
    max|Δ| ≤ 0.5 · its max|ref|. The gradient itself is not determined
    better than that in float32 at this size: a ReLU input within float32
    rounding of 0 (one of 49152 in PSMNet's ``classif1.0``) takes the
    other side of the kink, and the BatchNorm batch statistics spread that
    element's gradient over its channel and every layer above (the port's
    float32 gradient is 3.3e-3 (PSMNet) and 2.1e-2 (GwcNet_G) from its own
    float64 one, JAX's 1.6e-3 and 1.7e-2)."""
    check_gradients32(one_step, 5e-2, 0.5)


def test_train_step_batchnorm_statistics_match_jax(one_step):
    """Flax's update: momentum 0.1 on the biased batch variance; the 2D
    trunk updated twice a step, once per view, left first."""
    check_statistics(one_step)


def test_pytorch_batchnorm_update_misses_the_variance_bound(one_step,
                                                            monkeypatch):
    """The same step with PyTorch's own BatchNorm update (the unbiased
    batch variance, n / (n − 1) larger) is off JAX's running variance by
    more than the 1e-5 bound; the means still agree."""
    model = one_step["model"]
    model.load_state_dict(one_step["init"])
    monkeypatch.setattr(FlaxRunningStats, "forward",
                        lambda self, x: super(FlaxRunningStats,
                                              self).forward(x))
    step = make_train_step(model, _config(one_step["name"]))
    step(TrainState(model, Recorder()), to_device(one_step["batch"], "cpu"))
    errs = stats_errors(one_step, model.state_dict())
    print(f"{one_step['name']}: PyTorch's own update, max relative error "
          f"{errs}")
    assert errs["mean"] <= 1e-5
    assert errs["var"] > 1e-5


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-4),
                                        (torch.float32, 1e-2)])
def test_three_steps_losses_match_jax(one_step, dtype, rtol):
    """Three steps of the trainer (optimizer and all) on both sides: in
    float64 the losses agree to 1e-4; in float32 to 1e-2, because Adam's
    first update is sign-like (lr · g / |g|) and turns the float32
    gradient's floor (see `test_train_step_gradients_match_jax`) into
    full-size steps of either sign on the elements it touches."""
    check_three_steps(one_step, dtype, rtol)


# ------------------------------------------------------------- training
def test_loss_decreases_on_overfit():
    """tests/test_trainer.py::test_loss_decreases_on_overfit in the port."""
    config = TrainConfig(lr=1e-3, max_disp=MAX_DISP, loss="multihead",
                         clip_grad=1.0)
    model = create_model("PSMNet", max_disp=MAX_DISP, device="cpu")
    state = init_train_state(model, config, 30)
    step = make_train_step(model, config)
    batch = to_device(_batch(), "cpu")
    losses = []
    for _ in range(12):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses


def test_eval_after_a_train_step_keeps_no_stale_folded_batchnorm():
    """An eval forward, a train step, an eval forward: the second equals a
    fresh model's with the trained state (the folded BatchNorm and packed
    kernels the first eval cached are rebuilt)."""
    config = _config("GwcNet_G")
    model = create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu")
    batch = to_device(_batch(32, 48), "cpu")
    with torch.no_grad():
        before = model.eval()(batch["left"], batch["right"])
    step = make_train_step(model, config)
    step(init_train_state(model, config, 10), batch)
    fresh = create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu")
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        after = model.eval()(batch["left"], batch["right"])
        want = fresh(batch["left"], batch["right"])
    torch.testing.assert_close(after, want, rtol=0, atol=0)
    assert not torch.equal(after, before)


def _trainer_run(tmp_path, epochs, resume=None, start_epoch=0):
    config = TrainConfig(lr=1e-3, max_disp=MAX_DISP, loss="multihead",
                         clip_grad=1.0, ckpt_dir=str(tmp_path), log_every=1,
                         loss_weights=WEIGHTS["GwcNet_G"])
    model = create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    loader = DataLoader(SyntheticStereoDataset(
        num_samples=4, height=60, width=80, max_disp=12, crop_size=(32, 48),
        seed=2), batch_size=2, shuffle=True, seed=2, num_workers=0)
    state = init_train_state(model, config, 2 * len(loader))
    trainer = Trainer(model, config)
    if resume:
        state, last = trainer.load_checkpoint(state, resume)
        start_epoch = last + 1
    return trainer.train(state, loader, epochs=epochs,
                         start_epoch=start_epoch, log=lambda s: None)


def test_resume_is_bit_exact(tmp_path):
    """Two epochs straight equal one epoch, a checkpoint, a fresh model and
    optimizer loaded from it and one more epoch: parameters, running
    statistics and optimizer state bit for bit."""
    straight = _trainer_run(tmp_path / "a", 2)
    _trainer_run(tmp_path / "b", 1)
    assert (tmp_path / "b" / "epoch_0000.pt").exists()
    resumed = _trainer_run(tmp_path / "c", 2,
                           resume=str(tmp_path / "b" / "epoch_0000.pt"))
    assert straight.step == resumed.step == 4
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    for key in ("mu", "nu"):
        for x, y in zip(getattr(straight.optimizer, key),
                        getattr(resumed.optimizer, key)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    ckpt = torch.load(tmp_path / "a" / "epoch_0001.pt", weights_only=True)
    assert ckpt["step"] == 4 and ckpt["epoch"] == 1
    assert set(ckpt) == {"step", "epoch", "model", "optimizer", "schedule"}


def test_scalar_writer_mirrors_jsonl(tmp_path, monkeypatch):
    """With tensorboard absent the writer keeps its JSONL mirror."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    from stereo_toolbox_tpu_torch.utils.observability import ScalarWriter
    w = ScalarWriter(str(tmp_path))
    w.scalars(3, **{"train/loss": 1.5})
    w.close()
    rec = json.loads((tmp_path / "scalars.jsonl").read_text())
    assert rec["step"] == 3 and rec["train/loss"] == 1.5
    ScalarWriter(None).scalars(1, x=1.0)    # a no-op


# ------------------------------------------------------------- precision
@pytest.fixture
def tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.mark.parametrize("name", ["PSMNet", "GwcNet_G"])
def test_float32_train_step_runs_without_tf32(name, tf32_on):
    """The forward and the backward of a train step (the backward runs
    outside ``model.forward``) see both TF32 flags off; the caller's flags
    come back after the step."""
    model = create_model(name, max_disp=MAX_DISP, device="cpu")
    conv = next(m for m in model.modules()
                if isinstance(m, torch.nn.Conv2d))
    seen = {"forward": [], "backward": []}
    conv.register_forward_pre_hook(
        lambda mod, inp: seen["forward"].append(_flags()))
    conv.register_full_backward_hook(
        lambda mod, gi, go: seen["backward"].append(_flags()))
    config = _config(name)
    step = make_train_step(model, config)
    step(init_train_state(model, config, 10), to_device(_batch(32, 48),
                                                        "cpu"))
    # the trunk runs once per view in train mode
    assert seen == {"forward": [(False, False)] * 2,
                    "backward": [(False, False)] * 2}
    assert _flags() == (True, True)


@pytest.mark.parametrize("name", ["PSMNet", "GwcNet_G"])
def test_bfloat16_training_raises(name):
    model = create_model(name, max_disp=MAX_DISP, device="cpu",
                         dtype=torch.bfloat16).train()
    x = torch.zeros(1, 32, 48, 3)
    with pytest.raises(NotImplementedError, match="bfloat16 training"):
        model(x, x)


# ------------------------------------------------------------ entry point
def _run_entry(*args, timeout=240, env=None):
    return subprocess.run(
        [sys.executable, "-m", "stereo_toolbox_tpu_torch.train", *args],
        capture_output=True, text=True, timeout=timeout, env=env)


def test_entry_point_trains_one_epoch_on_the_cpu(tmp_path):
    r = _run_entry("--device", "cpu", "--model", "GwcNet_G", "--epochs", "1",
                   "--batch-size", "32", "--crop", "32",
                   "48", "--maxdisp", "16", "--num-workers", "0",
                   "--ckpt-dir", str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "epoch 0 done: 2 steps" in r.stdout
    ckpt = torch.load(tmp_path / "epoch_0000.pt", weights_only=True)
    assert ckpt["step"] == 2


def test_entry_point_refuses_what_is_not_ported(tmp_path):
    """Data parallelism outside torchrun's environment is refused (it
    trains under torchrun: `tests/test_torch_parallel.py`), and so is the
    card where there is none (``--bf16`` trains:
    `tests/test_torch_bf16_training.py`). Every
    model the port trains is taken, with JAX's multi-head weights (PSMNet's
    three heads, four for the others); CFNet's nine heads fail the default
    multi-head loss, as JAX's assert does, and train with ``--loss
    sequence``, DEFOMStereo's default."""
    env_free = {k: v for k, v in os.environ.items()
                if k not in ("RANK", "WORLD_SIZE")}
    r = _run_entry("--device", "cpu", "--distributed", timeout=120,
                   env=env_free)
    assert r.returncode != 0 and "torchrun" in r.stderr, r.stderr
    if not torch.cuda.is_available():
        r = _run_entry("--epochs", "1", timeout=120)
        assert r.returncode != 0 and "CUDA" in r.stderr, r.stderr
    assert TRAINABLE == ("PSMNet", "GwcNet_G", "GwcNet_GC", "ACVNet",
                         "CFNet", "DEFOMStereo_S", "DEFOMStereo_L")
    for name in TRAINABLE:
        assert parse_args(["--model", name]).model == name
        assert LOSS_WEIGHTS[name] == ((0.5, 0.7, 1.0) if name == "PSMNet"
                                      else (0.5, 0.5, 0.7, 1.0))
    cfnet = ("--device", "cpu", "--model", "CFNet", "--epochs", "1",
             "--batch-size", "2", "--crop", "32", "64", "--maxdisp", "32",
             "--num-workers", "0", "--ckpt-dir", str(tmp_path))
    r = _run_entry(*cfnet)
    assert r.returncode != 0 and "9 heads, 4 weights" in r.stderr, r.stderr
