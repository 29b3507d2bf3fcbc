"""The ranks of the port's data-parallel tests: functions that spawned
processes run, each a gloo rank on the CPU (``tests/test_torch_parallel.py``).

This module imports neither JAX nor the JAX package, so that a spawned rank
pays only torch's import. Each rank joins a group by ``file://``
rendezvous, runs its cases and puts its readings on a queue as numpy.
"""

from __future__ import annotations

import contextlib
import hashlib
import multiprocessing
import os
import traceback
from collections import Counter
from datetime import timedelta

import torch

TIMEOUT = timedelta(seconds=120)      # every collective of a rank's group
JOIN_S = 240                          # a rank's whole run, in the parent


class Recorder:
    """An optimizer stand-in that keeps the gradients a step gives it."""
    count = 0

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]


def digest(tensors) -> str:
    """sha256 of the bytes of `tensors`, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def state_digest(model) -> str:
    return digest(model.state_dict().values())


def spawn(target, world: int, rendezvous: str, *args) -> list:
    """Run ``target(rank, world, rendezvous, *args)`` in `world` spawned
    processes and return what each put on the queue, by rank; raise if a
    rank raised or did not finish within JOIN_S."""
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_run, args=(queue, target, rank, world,
                                            rendezvous, *args))
             for rank in range(world)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, ok, value = queue.get(timeout=JOIN_S)
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            got[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in procs)
    return [got[r] for r in range(world)]


def _run(queue, target, rank, world, rendezvous, *args):
    torch.set_num_threads(1)
    try:
        from stereo_toolbox_tpu_torch import parallel
        parallel.init_distributed("cpu", init_method=rendezvous, rank=rank,
                                  world_size=world, timeout=TIMEOUT)
        try:
            queue.put((rank, True, target(rank, world, *args)))
        finally:
            torch.distributed.destroy_process_group()
    except Exception:       # the parent raises it with the traceback
        queue.put((rank, False, traceback.format_exc()))


# ------------------------------------------------------ the parity ranks
def _model(name, config, state_dict, dtype):
    from stereo_toolbox_tpu_torch.models import create_model
    model = create_model(name, max_disp=config.max_disp, device="cpu")
    model.load_state_dict(state_dict)
    return model.to(dtype).train()


def _block(batch, mesh, dtype):
    from stereo_toolbox_tpu_torch import parallel
    from stereo_toolbox_tpu_torch.trainer import to_device
    return {k: v.to(dtype) for k, v in
            to_device(parallel.shard_batch(batch, mesh), "cpu").items()}


def _recorded_step(name, config, state_dict, batch, mesh, dtype,
                   spp=None, bn_calls=None):
    """One data-parallel step of the carried model in `dtype`, its
    optimizer a `Recorder`: (loss, reduced gradients, state_dict after).
    `spp` gets the values a channel PSMNet's first SPP branch holds at each
    call, `bn_calls` one item a train BatchNorm call."""
    from stereo_toolbox_tpu_torch.nn.layers import FlaxRunningStats
    from stereo_toolbox_tpu_torch.trainer import TrainState, make_train_step
    model = _model(name, config, state_dict, dtype)
    hooks = []
    if spp is not None:
        bn = model.get_submodule("feature_extraction.branch1.1.1")
        hooks.append(bn.register_forward_pre_hook(
            lambda mod, args: spp.append(args[0].numel() // args[0].shape[1])))
    if bn_calls is not None:
        hooks += [m.register_forward_pre_hook(
            lambda mod, args: bn_calls.append(1))
            for m in model.modules() if isinstance(m, FlaxRunningStats)]
    rec = Recorder()
    _, loss = make_train_step(model, config, mesh=mesh)(
        TrainState(model, rec), _block(batch, mesh, dtype))
    for h in hooks:
        h.remove()
    return (float(loss), [g.numpy() for g in rec.grads],
            {k: v.numpy() for k, v in model.state_dict().items()})


@contextlib.contextmanager
def _patched(obj, attr, value):
    saved = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, saved)


def _per_rank_loss_mean(mask, mesh):
    """The fault DDP makes: each rank's own masked mean, averaged."""
    return torch.tensor(1.0 / mesh.size, dtype=torch.float64)


def control_patches() -> dict:
    """Each negative control's (object, attribute, fault): the per-rank
    loss mean, and BatchNorm statistics reduced outside autograd (the
    global statistics in the forward, each rank's own Σdy and Σdy·(x −
    mean) in the backward)."""
    from stereo_toolbox_tpu_torch import parallel
    from stereo_toolbox_tpu_torch.nn import layers
    backward = layers._GlobalBatchNorm.backward

    def local_backward(ctx, *grads):
        with _patched(parallel, "all_reduce_sum", lambda tensors, mesh:
                      tensors):
            return backward(ctx, *grads)
    return {"per_rank_loss_mean": (parallel, "pixel_share",
                                   _per_rank_loss_mean),
            "detached_batch_statistics": (layers._GlobalBatchNorm,
                                          "backward",
                                          staticmethod(local_backward))}


def parity_rank(rank, world, cases):
    """Every case of `cases` (``{key: (name, config, state_dict,
    batch)}``) on this rank: the float64 step, the float32 step, three
    trainer steps in each type (their losses and the parameters' digest
    after), and the float64 step under each of `control_patches`."""
    from stereo_toolbox_tpu_torch import parallel
    from stereo_toolbox_tpu_torch.trainer import (init_train_state,
                                                  make_train_step)
    mesh = parallel.make_mesh()
    out = {}
    for key, (name, config, state_dict, batch) in cases.items():
        spp = [] if name == "PSMNet" else None
        r = out[key] = {}
        r["step64"] = _recorded_step(name, config, state_dict, batch, mesh,
                                     torch.float64)
        before, bn_calls = Counter(mesh.collectives), []
        r["step32"] = _recorded_step(name, config, state_dict, batch, mesh,
                                     torch.float32, spp, bn_calls)
        r["step32_collectives"] = dict(mesh.collectives - before)
        r["bn_calls"] = len(bn_calls)
        r["spp_values"] = spp
        for dtype in (torch.float32, torch.float64):
            model = _model(name, config, state_dict, dtype)
            state = init_train_state(model, config, 30, mesh=mesh)
            step = make_train_step(model, config, mesh=mesh)
            block = _block(batch, mesh, dtype)
            losses = []
            for _ in range(3):
                state, loss = step(state, block)
                losses.append(float(loss))
            r[f"three{str(dtype)[-2:]}"] = (losses, digest(
                model.parameters()), state_digest(model))
        for control, (target, attr, fault) in control_patches().items():
            with _patched(target, attr, fault):
                r[control] = _recorded_step(name, config, state_dict, batch,
                                            mesh, torch.float64)
    return out


# ---------------------------------------------- the entry point's ranks
def resume_rank(rank, world, ckpt, config_kw, loader_kw, ckpt_dir):
    """Build the model from a seed of this rank's own, load `ckpt` on
    every rank, train one more epoch with the data-parallel `Trainer`
    (checkpoints into ``ckpt_dir/rank<r>``, a directory a rank), then
    `measure_scaling` over 1 and 2 ranks. Returns the state's digest after
    the load and after the epoch, the checkpoint's own digest, the files
    the rank wrote and the scaling rows."""
    from stereo_toolbox_tpu_torch import parallel
    from stereo_toolbox_tpu_torch.datasets import (DataLoader,
                                                   SyntheticStereoDataset)
    from stereo_toolbox_tpu_torch.evaluation.scaling import measure_scaling
    from stereo_toolbox_tpu_torch.models import create_model
    from stereo_toolbox_tpu_torch.trainer import (TrainConfig, Trainer,
                                                  init_train_state)
    mesh = parallel.make_mesh()
    ckpt_dir = os.path.join(ckpt_dir, f"rank{rank}")
    config = TrainConfig(ckpt_dir=ckpt_dir, **config_kw)
    model = create_model("GwcNet_G", max_disp=config.max_disp, device="cpu",
                         generator=torch.Generator().manual_seed(100 + rank))
    loader = DataLoader(SyntheticStereoDataset(**loader_kw["dataset"]),
                        process_index=rank, process_count=world,
                        **loader_kw["loader"])
    state = init_train_state(model, config, 2 * len(loader))
    trainer = Trainer(model, config, lr_schedule=state.optimizer.schedule,
                      mesh=mesh)
    state, epoch = trainer.load_checkpoint(state, ckpt)
    loaded = (state_digest(model), digest(state.optimizer.mu),
              digest(state.optimizer.nu), state.step)
    saved = torch.load(ckpt, map_location="cpu", weights_only=True)
    state = trainer.train(state, loader, epochs=epoch + 2,
                          start_epoch=epoch + 1, log=lambda s: None)
    after = (state_digest(model), digest(state.optimizer.mu),
             digest(state.optimizer.nu), state.step)
    scaling = measure_scaling(model, config, sample_shape=(32, 48),
                              per_device_batch=1, steps=2,
                              device_counts=[1, 2])
    return {"loaded": loaded, "checkpoint": digest(saved["model"].values()),
            "after": after, "scaling": scaling,
            "files": sorted(os.listdir(ckpt_dir))
            if os.path.isdir(ckpt_dir) else []}


__all__ = ["JOIN_S", "Recorder", "control_patches", "digest",
           "parity_rank", "resume_rank", "spawn", "state_digest"]
