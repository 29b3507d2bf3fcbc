"""The port's data-parallel training (``parallel``, ``make_train_step(...,
mesh=)``, ``train.py --distributed``, ``evaluation.scaling``) on the CPU:
two gloo ranks in spawned processes, ``file://`` rendezvous, against JAX's
sharded step.

- JAX parity: GwcNet_G (48×64) and PSMNet (32×48, where each SPP branch
  holds one value a channel on a rank), two samples whose NaN regions give
  the ranks different valid-pixel counts, one sample a rank, JAX's init
  carried across. JAX's reference is its step sharded over a two-device
  mesh (``make_train_step(model, config, mesh=make_mesh(data=2, devices=
  jax.devices()[:2]))`` and its loss under ``value_and_grad`` with the
  batch on ``P('data')``): the loss, the float64 gradients, the running
  statistics and three trainer steps at the gates of
  ``tests/_torch_train_parity.py``.
- Self-consistency: the two ranks' float64 step against one process's on
  the global batch (the gradients within SELF_CONSISTENT), and every
  rank's parameters and buffers bit-identical after three steps.
- Negative controls, each planted in the ranks only
  (``_torch_parallel_ranks.control_patches``): the per-rank loss mean and
  BatchNorm statistics reduced outside autograd must fail the parity gate.
- The entry point: ``train.py --distributed`` under torchrun, two gloo
  ranks, one checkpoint, rank 0 alone logging; every rank resumes to the same state; weak
  scaling over 1 and 2 ranks.
"""

import concurrent.futures
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parallel_ranks import (JOIN_S, Recorder, parity_rank,
                                   resume_rank, spawn)
from _torch_train_parity import (check_gradients64, check_loss,
                                 check_statistics, gradient_errors,
                                 init_variables, jax_config)
from stereo_toolbox_tpu import metrics as jmetrics
from stereo_toolbox_tpu import trainer as jtrainer
from stereo_toolbox_tpu.models import create_model as jax_create_model
from stereo_toolbox_tpu.parallel import make_mesh, shard_batch
from stereo_toolbox_tpu_torch import parallel
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.trainer import (TrainConfig, TrainState,
                                              make_train_step, to_device)
from stereo_toolbox_tpu_torch.utils.weights import from_jax_variables
from test_trainer import _batch

torch.set_num_threads(2)

MAX_DISP = 16
WEIGHTS = {"PSMNet": (0.5, 0.7, 1.0), "GwcNet_G": (0.5, 0.5, 0.7, 1.0)}
CROPS = {"GwcNet_G": (48, 64), "PSMNet": (32, 48)}
# the float64 gradients of two ranks against one process on the global
# batch (global relative L2; the heads' softmax and regression run in
# float32 in both): observed 3.6e-8 (GwcNet_G)
SELF_CONSISTENT = 1e-6
THREE_STEPS_RTOL = 1e-2     # tests/test_torch_trainer.py's float32 bound
MODELS = ["GwcNet_G", "PSMNet"]


def _config(name):
    return TrainConfig(lr=1e-3, max_disp=MAX_DISP, loss="multihead",
                       clip_grad=1.0, loss_weights=WEIGHTS[name])


def _two_counts_batch(name):
    """Two samples whose ground truth is NaN in regions of different
    sizes: rank 0's sample keeps more valid pixels than rank 1's."""
    batch = {k: v for k, v in _batch(2, *CROPS[name]).items()
             if k in ("left", "right", "gt_disp")}
    h, w = CROPS[name]
    batch["gt_disp"][0, :h // 8] = np.nan
    batch["gt_disp"][1, :, : w // 2] = np.nan
    return batch


def _jax_sharded(jmodel, config, batch, variables):
    """JAX's step sharded over a two-device mesh: three steps of
    ``make_train_step(..., mesh)`` (their losses, and the running
    statistics after the first), and the first step's float64 gradients
    (its loss under ``value_and_grad``, the batch on ``P('data')``)."""
    mesh = make_mesh(data=2, devices=jax.devices()[:2])

    def loss_fn(params, stats, left, right, gt):
        mask = jmetrics.valid_mask(gt, config.max_disp)
        outputs, updates = jmodel.apply(
            {"params": params, "batch_stats": stats}, left, right,
            train=True, mutable=["batch_stats"])
        return jtrainer.compute_loss(outputs, gt, mask, config)

    def grads64():
        with jax.enable_x64(True):      # a thread-local setting
            sharded = shard_batch({k: v.astype(np.float64)
                                   for k, v in batch.items()}, mesh)
            cast = jax.tree_util.tree_map(lambda a: a.astype(np.float64),
                                          variables)
            grads = jax.jit(jax.grad(loss_fn))(
                cast["params"], cast["batch_stats"], sharded["left"],
                sharded["right"], sharded["gt_disp"])
            return jax.tree_util.tree_map(np.asarray, grads)

    # XLA compiles the float64 gradient and the float32 step side by side
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(grads64)
        tx, _ = jtrainer.make_optimizer(config, 30)
        params = variables["params"]
        state = jtrainer.TrainState(
            step=jnp.zeros((), jnp.int32), params=params,
            batch_stats=variables["batch_stats"],
            opt_state=tx.init(params), tx=tx)
        step = jtrainer.make_train_step(jmodel, config, mesh=mesh)
        sharded = shard_batch(batch, mesh)
        losses = []
        for i in range(3):
            state, loss = step(state, sharded)
            losses.append(float(loss))
            if i == 0:
                stats = jax.tree_util.tree_map(np.asarray, state.batch_stats)
        return dict(loss=losses[0], stats=stats, grads64=job.result(),
                    losses=losses)


def _one_process64(name, config, state_dict, batch):
    """The port's float64 step on the global batch in one process: its
    gradients."""
    model = create_model(name, max_disp=MAX_DISP, device="cpu")
    model.load_state_dict(state_dict)
    model.to(torch.float64)
    rec = Recorder()
    make_train_step(model, config)(
        TrainState(model.train(), rec),
        {k: v.double() for k, v in to_device(batch, "cpu").items()})
    return rec.grads, model


def _jax_init(name):
    """The JAX model of `name`, its batch and its init variables."""
    batch = _two_counts_batch(name)
    jmodel = jax_create_model(name, max_disp=MAX_DISP)
    return jmodel, batch, init_variables(jmodel, batch)


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    """Both models: JAX's init variables, carried to the ranks, which run
    while JAX compiles its sharded sides (the models side by side), and the
    one-process float64 step."""
    url = f"file://{tmp_path_factory.mktemp('rdv')}/store"
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        inits = dict(zip(MODELS, pool.map(_jax_init, MODELS)))
        cases = {name: (name, _config(name),
                        from_jax_variables(name, variables), batch)
                 for name, (_, batch, variables) in inits.items()}
        ranks = pool.submit(spawn, parity_rank, 2, url, cases)
        wants = {name: pool.submit(_jax_sharded, jmodel,
                                   jax_config(_config(name)), batch,
                                   variables)
                 for name, (jmodel, batch, variables) in inits.items()}
        out = {}
        for name, (_, config, sd, batch) in cases.items():
            one64, model = _one_process64(name, config, sd, batch)
            out[name] = dict(name=name, model=model, one64=one64,
                             want=wants[name].result())
        got = ranks.result()
    for name in out:
        out[name]["ranks"] = [r[name] for r in got]
    return out


def _step(run, rank=0, key="step32", key64="step64"):
    """The dict the `_torch_train_parity` checks read, from rank `rank`'s
    readings."""
    r = run["ranks"][rank]
    loss, grads, after = r[key]
    want = run["want"]
    return dict(name=run["name"], model=run["model"], got_loss=loss,
                loss=want["loss"], stats=want["stats"],
                after={k: torch.from_numpy(v) for k, v in after.items()},
                got_grads64=[torch.from_numpy(g) for g in r[key64][1]],
                grads64=want["grads64"])


@pytest.mark.parametrize("name", MODELS)
def test_two_ranks_loss_matches_jax_sharded_step(parity, name):
    run = parity[name]
    assert run["ranks"][0]["step32"][0] == run["ranks"][1]["step32"][0]
    check_loss(_step(run))


@pytest.mark.parametrize("name", MODELS)
def test_two_ranks_gradients_match_jax_in_float64(parity, name):
    for rank in (0, 1):
        check_gradients64(_step(parity[name], rank))


@pytest.mark.parametrize("name", MODELS)
def test_two_ranks_batchnorm_statistics_match_jax(parity, name):
    """Flax's update over the global batch; PSMNet's SPP branches hold one
    value a channel on each rank, two over the mesh."""
    run = parity[name]
    for rank in (0, 1):
        check_statistics(_step(run, rank))
    if name == "PSMNet":
        assert run["ranks"][0]["spp_values"] == [1, 1]    # left, right view


@pytest.mark.parametrize("name", MODELS)
def test_two_ranks_three_steps_match_jax(parity, name):
    run = parity[name]
    losses = run["ranks"][0]["three32"][0]
    print(f"{name}: losses {losses} vs JAX {run['want']['losses']}")
    np.testing.assert_allclose(losses, run["want"]["losses"],
                               rtol=THREE_STEPS_RTOL)


@pytest.mark.parametrize("name", MODELS)
def test_two_ranks_equal_one_process_in_float64(parity, name):
    """The two ranks' reduced float64 gradients against one process's on
    the global batch; both ranks hold the same gradient bits."""
    run = parity[name]
    r0, r1 = (r["step64"][1] for r in run["ranks"])
    assert all(np.array_equal(a, b) for a, b in zip(r0, r1))
    num = sum(float(((a - b.double().numpy()) ** 2).sum())
              for a, b in zip(r0, run["one64"]))
    den = sum(float((b.double() ** 2).sum()) for b in run["one64"])
    rel = (num / den) ** 0.5
    print(f"{name}: two ranks vs one process, float64 gradients' relative "
          f"L2 {rel:.3e}")
    assert rel <= SELF_CONSISTENT


@pytest.mark.parametrize("dtype", ["32", "64"])
@pytest.mark.parametrize("name", MODELS)
def test_ranks_hold_the_same_bits_after_three_steps(parity, name, dtype):
    a, b = (r[f"three{dtype}"] for r in parity[name]["ranks"])
    assert a[0] == b[0]                 # the global losses
    assert a[1] == b[1] and a[2] == b[2]  # parameters; parameters + buffers


@pytest.mark.parametrize("control", ["per_rank_loss_mean",
                                     "detached_batch_statistics"])
@pytest.mark.parametrize("name", MODELS)
def test_negative_controls_fail_the_parity_gate(parity, name, control):
    """Averaging the ranks' own masked means (the ranks' valid counts
    differ), and BatchNorm statistics whose all-reduce has no backward,
    each miss JAX's float64 gradients; the first also its loss."""
    step = _step(parity[name], key=control, key64=control)
    rel, leaf = gradient_errors(step, step["got_grads64"], step["grads64"])
    print(f"{name} {control}: gradients' relative L2 {rel:.3e}, worst leaf "
          f"{leaf:.3e}")
    with pytest.raises(AssertionError):
        check_gradients64(step)
    if control == "per_rank_loss_mean":
        with pytest.raises(AssertionError):
            check_loss(step)


@pytest.mark.parametrize("name", MODELS)
def test_a_step_reduces_its_gradients_in_buckets(parity, name):
    """The all-reduces of one float32 step: the global count of valid
    pixels, each train BatchNorm call's statistics and their gradient, and
    the gradients with the loss in flat buckets (`parallel._buckets`),
    never one a parameter."""
    r = parity[name]["ranks"][0]
    grads = [torch.from_numpy(g) for g in r["step32"][1]]
    buckets = len(parallel._buckets([*grads, torch.zeros(1)],
                                    parallel.BUCKET_BYTES))
    print(f"{name}: {r['step32_collectives']} collectives in a step, "
          f"{r['bn_calls']} BatchNorm calls, {len(grads)} parameters in "
          f"{buckets} buckets")
    assert 1 <= buckets <= 3
    assert r["step32_collectives"] == {
        "all_reduce": 1 + 2 * r["bn_calls"] + buckets}


def test_buckets_split_by_kind_and_size():
    tensors = [torch.zeros(10), torch.zeros(5, dtype=torch.float64),
               torch.zeros(300), torch.zeros(3, dtype=torch.int64),
               torch.zeros(20)]
    assert parallel._buckets(tensors, 1 << 20) == [[0, 2, 4], [1], [3]]
    assert parallel._buckets(tensors, 1200) == [[0], [2], [4], [1], [3]]


def test_mesh_refuses_spatial_sharding_and_splits_the_batch():
    with pytest.raises(NotImplementedError, match="item 7"):
        parallel.make_mesh(spatial=2)
    mesh = parallel.Mesh(None, 1, 2, torch.device("cpu"))
    batch = {"left": np.arange(8).reshape(4, 2)}
    np.testing.assert_array_equal(parallel.shard_batch(batch, mesh)["left"],
                                  [[4, 5], [6, 7]])
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch({"left": np.zeros((3, 2))}, mesh)


# ------------------------------------------------------------ entry point
def test_distributed_entry_point_trains_and_every_rank_resumes(tmp_path):
    """``torchrun --standalone --nproc_per_node=2 -m
    stereo_toolbox_tpu_torch.train --distributed --device cpu`` (two gloo
    ranks, torchrun's env:// rendezvous) trains one epoch of two steps:
    rank 0 alone logs, and one checkpoint is written. Then two ranks whose
    models start from different seeds each load it into the same state,
    train one more epoch with the data-parallel `Trainer` into the same
    bits (each rank given a checkpoint directory of its own: rank 0 alone
    writes), and `measure_scaling` over 1 and 2 ranks gives finite
    frames/s."""
    logs = tmp_path / "logs"
    # two threads a rank: ranks that each take every core spin in their
    # collectives
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "--local-addr=127.0.0.1",
         f"--log-dir={logs}", "--redirects=3",
         "-m", "stereo_toolbox_tpu_torch.train", "--distributed",
         "--device", "cpu", "--model", "GwcNet_G", "--epochs", "1",
         "--batch-size", "16", "--crop", "32", "48", "--maxdisp", "16",
         "--num-workers", "0", "--ckpt-dir", str(tmp_path / "ckpt")],
        capture_output=True, text=True, timeout=JOIN_S,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    outs = {}
    for rank in (0, 1):
        found = list(logs.glob(f"**/attempt_0/{rank}/stdout.log"))
        assert len(found) == 1, (run.stdout + run.stderr, found)
        outs[rank] = found[0].read_text()
    assert run.returncode == 0, run.stdout + run.stderr + outs[0]
    assert "epoch 0 done: 2 steps" in outs[0]
    assert "x 2 processes" in outs[0]
    assert outs[1] == ""
    assert os.listdir(tmp_path / "ckpt") == ["epoch_0000.pt"]
    ckpt = torch.load(tmp_path / "ckpt" / "epoch_0000.pt",
                      weights_only=True)
    assert ckpt["step"] == 2

    config_kw = dict(lr=2e-4, max_disp=16, loss="multihead",
                     loss_weights=WEIGHTS["GwcNet_G"])
    loader_kw = {"dataset": dict(num_samples=64, height=96, width=112,
                                 max_disp=16, training=True,
                                 crop_size=(32, 48)),
                 "loader": dict(batch_size=16, shuffle=True, seed=0,
                                drop_last=True, num_workers=0)}
    r0, r1 = spawn(resume_rank, 2, f"file://{tmp_path}/store",
                   str(tmp_path / "ckpt" / "epoch_0000.pt"), config_kw,
                   loader_kw, str(tmp_path / "resumed"))
    assert r0["loaded"] == r1["loaded"]
    assert r0["loaded"][0] == r0["checkpoint"] and r0["loaded"][3] == 2
    assert r0["after"] == r1["after"] and r0["after"][3] == 4
    assert r0["files"] == ["epoch_0001.pt"] and r1["files"] == []
    assert sorted(r0["scaling"]) == [1, 2] and list(r1["scaling"]) == [2]
    for row in r0["scaling"].values():
        assert np.isfinite(row["frames_per_s_per_device"])
        assert row["frames_per_s_per_device"] > 0
