"""Training throughput and weak-scaling efficiency over the ranks of a
process group.

Counterpart of ``stereo_toolbox_tpu/evaluation/scaling.py``: the train
step's throughput on meshes of increasing size, each a subgroup of the
initialised world (ranks ``0 … n − 1``), the global batch growing with the
mesh and the batch a device constant (weak scaling). A step's time is the
host's clock around the timed steps, ended by reading the last loss (which
waits for the device).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from stereo_toolbox_tpu_torch import parallel
from stereo_toolbox_tpu_torch.trainer import (TrainConfig, init_train_state,
                                              make_train_step, to_device)


def measure_scaling(model: torch.nn.Module, config: TrainConfig,
                    sample_shape=(320, 512), per_device_batch: int = 2,
                    steps: int = 8, device_counts=None,
                    dtype: torch.dtype = torch.float32) -> dict:
    """frames/s/device for each mesh size: ``{n: {"step_time_s",
    "frames_per_s_per_device", "efficiency"}}``, where ``efficiency(n) =
    frames/s/device(n) / frames/s/device(first n)``.

    Every rank of the world calls it (each subgroup is made by all); ranks
    ``0 … n − 1`` train `model` (on their device) from its state at the
    call, a warm step and `steps` timed ones on a seeded global batch of
    ``per_device_batch · n``, and rank 0 prints each row. Each rank returns
    the rows it took part in (rank 0 all of them) and leaves `model` as it
    found it. `device_counts` defaults to 1, 2 and the world size."""
    world = dist.get_world_size()
    rank = dist.get_rank()
    if device_counts is None:
        device_counts = sorted({1, 2, world})
    device_counts = [n for n in device_counts if n <= world]
    device = next(model.parameters()).device
    start = {k: v.clone() for k, v in model.state_dict().items()}
    training = model.training
    results, base = {}, None
    for n in device_counts:
        group = dist.new_group(list(range(n)))
        if rank >= n:
            continue
        mesh = parallel.make_mesh(group=group, device=device)
        gb = per_device_batch * n
        rng = np.random.RandomState(0)
        batch = {
            "left": rng.randn(gb, *sample_shape, 3).astype(np.float32),
            "right": rng.randn(gb, *sample_shape, 3).astype(np.float32),
            "gt_disp": np.abs(rng.randn(gb, *sample_shape) * 32).astype(
                np.float32)}
        batch = to_device(parallel.shard_batch(batch, mesh), device)
        model.load_state_dict(start)
        state = init_train_state(model, config, 100, dtype, mesh=mesh)
        step = make_train_step(model, config, dtype, mesh=mesh)
        state, loss = step(state, batch)             # warm
        float(loss)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = step(state, batch)
        float(loss)
        dt = (time.perf_counter() - t0) / steps
        fps = gb / dt / n
        base = fps if base is None else base
        results[n] = {"step_time_s": dt, "frames_per_s_per_device": fps,
                      "efficiency": fps / base}
        if rank == 0:
            print(f"devices={n}: {dt * 1e3:.1f} ms/step, {fps:.2f} "
                  f"frames/s/dev, eff {fps / base:.2%}", flush=True)
    model.load_state_dict(start)
    model.train(training)
    return results


__all__ = ["measure_scaling"]
