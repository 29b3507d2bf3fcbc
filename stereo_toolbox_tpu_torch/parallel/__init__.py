"""Process groups, the batch's split over ranks and the collectives of a
data-parallel train step (``torch.distributed``).

Counterpart of ``stereo_toolbox_tpu/parallel/__init__.py``. The JAX package
runs one program over a device mesh: the batch sharded on its ``data``
axis, the state replicated, and GSPMD inserting the collectives, so that
the sharded step computes what the one-device step computes on the global
batch. Here each rank is a process holding one device and its block of the
batch, and the step makes those collectives itself:

  JAX package (GSPMD)                      this port (torch.distributed)
  ---------------------------------------  --------------------------------
  jax.distributed.initialize()             `init_distributed`: torchrun's
                                           environment, NCCL on the card,
                                           gloo on the CPU
  make_mesh(data, spatial)                 `make_mesh` → `Mesh` (the group,
                                           the rank, the size, the device);
                                           ``spatial > 1`` raises
  shard_batch(batch, mesh)                 `shard_batch`: this rank's
                                           contiguous block along B
  the mean over a sharded B (BatchNorm's   `nn.layers.FlaxRunningStats`
  batch statistics, the masked loss)       within `global_batch_statistics`
                                           (one all-reduce forward, one
                                           backward); `pixel_share` for
                                           the loss
  the psum of a replicated parameter's     `all_reduce_sum`: SUM in a few
  gradient                                 flat buckets
  replicated parameters                    `broadcast_state` from the
                                           mesh's first rank

``batch_sharding``, ``replicated`` and ``shard_image_hw`` are GSPMD
sharding specs and constraints, with no counterpart: a rank holds its block
of the batch and the whole state. Spatial sharding (the ``spatial`` axis,
``parallel/spatial.py``) is not ported yet (ROADMAP Queue 1, item 7).

Every rank must make the same collectives in the same order: the same
model, the same step and batches of the same shape.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from collections import Counter
from datetime import timedelta

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = timedelta(minutes=10)
# the gradient all-reduce's bucket: DDP's default cap
BUCKET_BYTES = 25 * 2**20


def init_distributed(device=None, backend: str | None = None,
                     init_method: str = "env://", rank: int | None = None,
                     world_size: int | None = None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> torch.device:
    """Join the default process group (``jax.distributed.initialize()``)
    and return this rank's device.

    `rank` and `world_size` default to torchrun's ``RANK`` and
    ``WORLD_SIZE``; ``init_method="env://"`` reads its ``MASTER_ADDR`` and
    ``MASTER_PORT`` (a ``file://`` or ``tcp://`` URL needs neither).
    `device` ``None`` is the card ``cuda:LOCAL_RANK``, made the current
    one; ``"cpu"`` is the CPU; any other device is taken as given. The
    backend is NCCL on a card and gloo on the CPU, unless `backend` names
    one (gloo also reduces CUDA tensors: two ranks may share one card, which
    NCCL refuses). Every collective of the group fails after `timeout`."""
    env = os.environ
    if rank is None or world_size is None:
        missing = [k for k in ("RANK", "WORLD_SIZE") if k not in env]
        if missing:
            raise RuntimeError(
                f"init_distributed: {', '.join(missing)} not set; launch "
                f"with torchrun (torchrun --nproc_per_node=N -m "
                f"stereo_toolbox_tpu_torch.train --distributed ...) or pass "
                f"rank and world_size")
    rank = int(env["RANK"]) if rank is None else rank
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    if init_method == "env://":
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in env]
        if missing:
            raise RuntimeError(f"init_distributed: env:// needs "
                               f"{', '.join(missing)} (torchrun sets them)")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device; pass "
                               "device='cpu' to train on the CPU with gloo")
        device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A data-parallel mesh: the process group (``None``: the default
    one), this rank's index in it, its size and this rank's device.
    `collectives` counts the collectives made over it, by kind."""
    group: object
    rank: int
    size: int
    device: torch.device
    collectives: Counter = dataclasses.field(default_factory=Counter,
                                             compare=False, repr=False)

    @property
    def first_rank(self) -> int:
        """The global rank of the group's rank 0."""
        return 0 if self.group is None else dist.get_global_rank(
            self.group, 0)


def make_mesh(data: int | None = None, spatial: int = 1, group=None,
              device=None) -> Mesh:
    """The mesh of `group` (the default group by default), ``data`` ranks
    along the batch (its size when ``None``). `device` defaults to the
    current card under NCCL and to the CPU under gloo."""
    if spatial != 1:
        raise NotImplementedError(
            "spatial sharding is not ported yet (ROADMAP Queue 1, item 7)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "init_distributed first")
    size = dist.get_world_size(group)
    if data is not None and data != size:
        raise ValueError(f"a mesh of {data} ranks over a group of {size}")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend(group) == "nccl"
                  else torch.device("cpu"))
    return Mesh(group, dist.get_rank(group), size, torch.device(device))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous block along B of a global host batch, where
    ``P('data')`` places it: rank r holds ``[r · B/n, (r + 1) · B/n)``.
    Arrays and tensors are sliced, not copied or moved."""
    out = {}
    for key, v in batch.items():
        b = v.shape[0]
        if b % mesh.size:
            raise ValueError(f"{key}: a batch of {b} does not split over "
                             f"{mesh.size} ranks")
        per = b // mesh.size
        out[key] = v[mesh.rank * per:(mesh.rank + 1) * per]
    return out


def pixel_share(mask: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's share ``n_local / n_global`` of the valid pixels of the
    global batch (0 where it holds none), in float64: a rank's masked mean
    times it is its part of the masked mean over the global batch."""
    local = mask.sum().reshape(1).to(torch.int64)
    total = local.clone()
    dist.all_reduce(total, group=mesh.group)
    mesh.collectives["all_reduce"] += 1
    return (local.double() / total.clamp(min=1).double())[0]


def _buckets(tensors: list, bucket_bytes: int) -> list:
    """Indices of `tensors` in buckets of one dtype and device, in order
    within each, each bucket at most `bucket_bytes` unless one tensor is
    larger."""
    by_kind: dict = {}
    for i, t in enumerate(tensors):
        by_kind.setdefault((t.dtype, t.device), []).append(i)
    buckets = []
    for indices in by_kind.values():
        run, size = [], 0
        for i in indices:
            nbytes = tensors[i].numel() * tensors[i].element_size()
            if run and size + nbytes > bucket_bytes:
                buckets.append(run)
                run, size = [], 0
            run.append(i)
            size += nbytes
        buckets.append(run)
    return buckets


def all_reduce_sum(tensors: list, mesh: Mesh) -> list:
    """The sums over the mesh's ranks of `tensors` (new tensors, the inputs
    untouched), one all-reduce per flat bucket (`_buckets`)."""
    out = [None] * len(tensors)
    for run in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([tensors[i].reshape(-1) for i in run])
        dist.all_reduce(flat, group=mesh.group)
        mesh.collectives["all_reduce"] += 1
        offset = 0
        for i in run:
            n = tensors[i].numel()
            out[i] = flat[offset:offset + n].view(tensors[i].shape)
            offset += n
    return out


@torch.no_grad()
def broadcast_state(module: torch.nn.Module, mesh: Mesh) -> None:
    """Give every rank the mesh's first rank's parameters and buffers, in
    place (JAX's replicated state)."""
    tensors = [*module.parameters(), *module.buffers()]
    for run in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([tensors[i].reshape(-1) for i in run])
        dist.broadcast(flat, src=mesh.first_rank, group=mesh.group)
        mesh.collectives["broadcast"] += 1
        offset = 0
        for i in run:
            n = tensors[i].numel()
            tensors[i].copy_(flat[offset:offset + n].view(tensors[i].shape))
            offset += n


_BATCH_STATISTICS: contextvars.ContextVar = contextvars.ContextVar(
    "batch_statistics_mesh", default=None)


@contextlib.contextmanager
def global_batch_statistics(mesh: Mesh | None):
    """Within it, every train-mode `nn.layers.FlaxRunningStats` takes its
    batch statistics over the global batch of `mesh` (``None``: this
    rank's batch alone, the one-device step)."""
    token = _BATCH_STATISTICS.set(mesh)
    try:
        yield
    finally:
        _BATCH_STATISTICS.reset(token)


def batch_statistics_mesh() -> Mesh | None:
    """The mesh set by the innermost `global_batch_statistics`."""
    return _BATCH_STATISTICS.get()


__all__ = ["BUCKET_BYTES", "DEFAULT_TIMEOUT", "Mesh", "all_reduce_sum",
           "batch_statistics_mesh", "broadcast_state",
           "global_batch_statistics", "init_distributed", "make_mesh",
           "pixel_share", "shard_batch"]
