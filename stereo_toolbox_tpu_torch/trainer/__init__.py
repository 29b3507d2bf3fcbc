"""Training: config, optimizer, loss dispatch, the train step and the
epoch loop (PyTorch).

Counterpart of ``stereo_toolbox_tpu/trainer/__init__.py``:

  JAX package (optax, jit)                 this port
  ---------------------------------------  --------------------------------
  TrainConfig                              the same fields and defaults
  optax.clip_by_global_norm + optax.adam   `Adam`: optax's arithmetic, in
  on the linear OneCycle schedule          its order, with `clip`
  value_and_grad of the jitted step        autograd, forward and backward
                                           inside ``full_float32``
  create_model(dtype=bfloat16): float32    ``make_train_step(..., dtype=
  params cast at use, optax on them        torch.bfloat16)``: the float32
                                           model's parameters are the
                                           masters, the forward runs on
                                           `models.bfloat16_view` of them,
                                           `Adam` updates the masters
  TrainState (params, batch_stats, opt)    `TrainState` (model, `Adam`)
  orbax checkpoint, epoch-granular resume  ``torch.save`` to
                                           ``ckpt_dir/epoch_XXXX.pt``,
                                           epoch-granular resume
  make_train_step(..., mesh): the batch    ``make_train_step(..., mesh=)``
  sharded on 'data', GSPMD's collectives   (`parallel.Mesh`): each rank
                                           steps on its block of the
                                           global batch; the loss, the
                                           BatchNorm statistics and the
                                           gradients are the global
                                           batch's (see `make_train_step`)

JAX's `make_optimizer` takes no weight decay (``weight_decay`` is read
nowhere), and neither does this one. JAX's `TrainConfig` has no dtype: the
compute dtype is the model's side of the step there (``create_model(...,
dtype=)``) and `make_train_step`'s, `init_train_state`'s and `Trainer`'s
``dtype`` here; checkpoints hold the float32 masters and running
statistics in both dtypes.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Sequence

import numpy as np
import torch

from stereo_toolbox_tpu_torch import losses, metrics, parallel
from stereo_toolbox_tpu_torch.models import bfloat16_view
from stereo_toolbox_tpu_torch.utils.observability import ScalarWriter
from stereo_toolbox_tpu_torch.utils.precision import full_float32


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's config tree, field for field."""
    lr: float = 2e-4
    batch_size: int = 4           # global batch
    epochs: int = 20
    total_steps: int | None = None  # overrides epochs*len(loader) if set
    weight_decay: float = 1e-5    # read nowhere, as in JAX
    clip_grad: float = 1.0
    loss: str = "sequence"        # 'sequence' | 'multihead' | 'selfsup'
    loss_gamma: float = 0.9
    loss_weights: Sequence[float] = (0.5, 0.7, 1.0)
    smooth_weight: float = 0.1    # selfsup: smoothness-term weight
    max_disp: int = 192
    seed: int = 0
    pct_start: float = 0.1        # OneCycle warmup fraction
    ckpt_dir: str = "checkpoints"
    save_every: int = 1           # epochs
    log_every: int = 50           # steps
    log_dir: str | None = None    # TensorBoard/JSONL scalar directory


def onecycle_schedule(lr: float, total_steps: int, pct_start: float
                      ) -> Callable[[int], float]:
    """The JAX package's schedule (``optax.join_schedules`` of two
    ``linear_schedule``s, the PyTorch OneCycleLR's linear anneal): lr/25 →
    lr over the first ``warm = max(int(total · pct_start), 1)`` updates,
    then lr → lr/25e4 over ``max(total − warm, 1)``. Update n takes
    ``schedule(n)``, the first ``lr/25``. Computed in float32 in optax's
    order: ``(init − end) · (1 − count / steps) + end``."""
    warm = max(int(total_steps * pct_start), 1)
    rest = max(total_steps - warm, 1)
    f32 = np.float32

    def linear(init, end, steps, count):
        frac = f32(1) - f32(min(max(count, 0), steps)) / f32(steps)
        return float(f32(init - end) * frac + f32(end))

    def schedule(count: int) -> float:
        if count < warm:
            return linear(lr / 25.0, lr, warm, count)
        return linear(lr, lr / 25.0e4, rest, count - warm)
    return schedule


class Adam:
    """``optax.chain(clip_by_global_norm(clip), adam(schedule))`` over a
    list of float32 parameters, in optax's arithmetic and order:

      * clip: ``g ← (g / ‖g‖) · clip`` where ``‖g‖ ≥ clip`` (the global L2
        norm over every gradient; no epsilon);
      * ``mu ← (1 − b1) · g + b1 · mu``, ``nu ← (1 − b2) · g² + b2 · nu``;
      * ``count ← count + 1``; ``û = (mu / (1 − b1^count)) / (√(nu / (1 −
        b2^count)) + eps)``;
      * ``p ← p + (−schedule(count − 1)) · û``.

    No weight decay. `count` is the number of updates made."""

    def __init__(self, params, schedule: Callable[[int], float],
                 clip: float | None = None, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.schedule = schedule
        self.clip = clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def clip_grads(self, grads: list) -> list:
        """optax's ``clip_by_global_norm``."""
        if not self.clip:
            return grads
        norm = torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm(grads)))
        clipped = torch._foreach_div(grads, norm)
        torch._foreach_mul_(clipped, self.clip)
        keep = norm < self.clip          # no host sync: a select a tensor
        return [torch.where(keep, g, c) for g, c in zip(grads, clipped)]

    @torch.no_grad()
    def step(self, grads: list) -> None:
        """One update of every parameter from `grads` (one per
        parameter)."""
        grads = self.clip_grads(grads)
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) g + b1 mu; nu = (1 - b2) g² + b2 nu
        self.mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                     torch._foreach_mul(self.mu, b1))
        sq = torch._foreach_mul(grads, grads)
        self.nu = torch._foreach_add(torch._foreach_mul(sq, 1 - b2),
                                     torch._foreach_mul(self.nu, b2))
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1 - np.float32(b1) ** np.float32(self.count)
        c2 = 1 - np.float32(b2) ** np.float32(self.count)
        mu_hat = torch._foreach_div(self.mu, float(c1))
        nu_hat = torch._foreach_div(self.nu, float(c2))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        torch._foreach_mul_(upd, float(np.float32(-lr)))
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mu = [t.to(p.device) for t, p in zip(state["mu"], self.params)]
        self.nu = [t.to(p.device) for t, p in zip(state["nu"], self.params)]


def make_optimizer(model: torch.nn.Module, config: TrainConfig,
                   total_steps: int) -> tuple[Adam, Callable[[int], float]]:
    """Adam on the OneCycle schedule with global-norm clipping, over every
    parameter of `model` (`Adam`, `onecycle_schedule`). Returns the
    optimizer and the schedule."""
    sched = onecycle_schedule(config.lr, total_steps, config.pct_start)
    return Adam(model.parameters(), sched, clip=config.clip_grad), sched


@dataclasses.dataclass
class TrainState:
    """What a train step changes: the model (parameters and BatchNorm
    running statistics) and the optimizer; ``step`` is the updates made."""
    model: torch.nn.Module
    optimizer: Adam

    @property
    def step(self) -> int:
        return self.optimizer.count


def init_train_state(model: torch.nn.Module, config: TrainConfig,
                     total_steps: int, dtype: torch.dtype = torch.float32,
                     mesh: parallel.Mesh | None = None) -> TrainState:
    """The model in train mode with a fresh optimizer over its parameters.
    A step in ``dtype=torch.bfloat16`` updates float32 masters: every
    floating parameter of `model` must be float32. With a `mesh`, every
    rank first takes the mesh's first rank's parameters and buffers."""
    _check_compute_dtype(model, dtype)
    if mesh is not None:
        parallel.broadcast_state(model, mesh)
    return TrainState(model.train(),
                      make_optimizer(model, config, total_steps)[0])


def _check_compute_dtype(model: torch.nn.Module,
                         dtype: torch.dtype) -> None:
    """Raise unless `model` can train in `dtype`: float32 computes in its
    own parameters' type (a float64 copy trains in float64), bfloat16 only
    on float32 masters."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"a train step computes in float32 or bfloat16, "
                        f"not {dtype}")
    if dtype == torch.bfloat16:
        kept = {p.dtype for p in model.parameters() if p.is_floating_point()}
        if kept != {torch.float32}:
            raise TypeError(
                f"bfloat16 training updates float32 master parameters; "
                f"this model's are {sorted(map(str, kept))} (train the "
                f"float32 model)")


def compute_loss(outputs, gt: torch.Tensor, mask: torch.Tensor,
                 config: TrainConfig, batch=None) -> torch.Tensor:
    """The loss dispatch of the JAX trainer: ``(init_disp, preds)`` and
    ``(init_disp, preds, depth_mono)`` take the sequence loss; a list of
    heads takes the sequence loss or, with ``loss='multihead'``, the
    fixed-weight multi-head loss."""
    if config.loss == "selfsup":
        raise NotImplementedError(
            "the self-supervised losses are not ported yet (ROADMAP Queue 1,"
            " item 9)")
    if isinstance(outputs, tuple) and len(outputs) in (2, 3):
        init_disp, preds = outputs[:2]
        return losses.sequence_loss(preds, gt, mask, init_disp=init_disp,
                                    loss_gamma=config.loss_gamma)
    if config.loss == "sequence":
        return losses.sequence_loss(list(outputs), gt, mask,
                                    loss_gamma=config.loss_gamma)
    return losses.multi_head_loss(list(outputs), gt, mask,
                                  config.loss_weights)


def make_train_step(model: torch.nn.Module, config: TrainConfig,
                    dtype: torch.dtype = torch.float32,
                    mesh: parallel.Mesh | None = None
                    ) -> Callable[[TrainState, dict], tuple]:
    """The train step of `model`: ``step(state, batch) → (state, loss)``
    with ``batch`` a dict of ``left``, ``right`` ``[B, H, W, 3]`` and
    ``gt_disp`` ``[B, H, W]`` tensors on the model's device (``gt_disp``
    NaN or absent where there is none).

    float32: the forward and the backward run in train mode inside
    ``full_float32``, so that no cuDNN or cuBLAS call of either takes TF32.
    bfloat16 (JAX's ``--bf16``): the forward runs on a bfloat16 view of
    the float32 masters (`models.bfloat16_view`, anew each step), so it
    computes as the bfloat16 model does; the predictions, the loss and the
    running statistics stay float32, and the gradients are taken with
    respect to the masters, each the view's gradient widened to float32.
    Then the optimizer updates the parameters (the masters).

    With a `mesh` (every rank with the same state, `init_train_state`),
    each rank's ``batch`` is its block of the global batch, and the step
    computes what JAX's sharded step (the one-device step on the global
    batch) computes: every train BatchNorm takes the global batch's
    statistics (`parallel.global_batch_statistics`); the loss each rank
    differentiates is its share of the global masked mean (its masked loss
    times `parallel.pixel_share`: its valid pixels over the global count,
    since every term of the loss masks with the same mask); the gradients
    and that share are summed over the ranks (`parallel.all_reduce_sum`),
    and every rank makes the same update. The loss returned is the global
    one."""
    _check_compute_dtype(model, dtype)
    params = list(model.parameters())

    def forward_loss(batch, gt, mask):
        if dtype == torch.float32:
            outputs = model(batch["left"], batch["right"])
        else:
            outputs = torch.func.functional_call(
                model, bfloat16_view(model), (batch["left"], batch["right"]))
        return compute_loss(outputs, gt, mask, config, batch=batch)

    def step(state: TrainState, batch: dict):
        if state.model is not model:
            raise ValueError("the state holds another model than the step's")
        model.train()
        gt = batch.get("gt_disp")
        if gt is None:
            gt = torch.full(batch["left"].shape[:3], float("nan"),
                            dtype=batch["left"].dtype,
                            device=batch["left"].device)
        mask = metrics.valid_mask(gt, config.max_disp)
        share = None if mesh is None else parallel.pixel_share(mask, mesh)
        with full_float32(dtype == torch.float32), \
                parallel.global_batch_statistics(mesh):
            loss = forward_loss(batch, gt, mask)
            if share is not None:
                loss = loss * share.to(loss.dtype)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        if mesh is not None:
            *grads, loss = parallel.all_reduce_sum(
                [*grads, loss.detach().reshape(1)], mesh)
            loss = loss.reshape(())
        state.optimizer.step(grads)
        return state, loss.detach()
    return step


def make_eval_step(model: torch.nn.Module) -> Callable:
    """The eval forward ``eval_fn(left, right) → prediction`` (the JAX
    package's `make_eval_step`, the trainer-side twin of
    `evaluation.make_apply`): `model` in eval mode under
    ``torch.inference_mode()``, a float32 model inside ``full_float32``;
    the inputs (tensors or numpy arrays, ``[B, H, W, 3]``) are moved to the
    model's device, where the prediction stays, in the model's output type.
    A model whose class sets ``monocular = True`` takes `left` alone."""
    device = next(model.parameters()).device
    float32 = all(p.dtype != torch.bfloat16 for p in model.parameters())
    monocular = getattr(model, "monocular", False)

    def eval_fn(left, right):
        model.eval()
        inputs = (left,) if monocular else (left, right)
        inputs = [torch.as_tensor(x).to(device) for x in inputs]
        with torch.inference_mode(), full_float32(float32):
            return model(*inputs)
    return eval_fn


def to_device(batch: dict, device) -> dict:
    """The loader's numpy ``left``, ``right`` and ``gt_disp`` as tensors on
    `device`, through pinned memory to a card."""
    device = torch.device(device)
    out = {}
    for key in ("left", "right", "gt_disp"):
        if key in batch:
            t = torch.from_numpy(np.ascontiguousarray(batch[key]))
            if device.type == "cuda":
                t = t.pin_memory()
            out[key] = t.to(device, non_blocking=True)
    return out


class Trainer:
    """Epoch-driven training loop (the JAX package's `Trainer`). With a
    `mesh`, each rank trains on its own loader's batches (its block of the
    global batch: ``DataLoader(process_index=rank, process_count=size)``)
    with the data-parallel step; the mesh's rank 0 alone logs and saves
    checkpoints, and every rank loads them."""

    def __init__(self, model: torch.nn.Module, config: TrainConfig,
                 lr_schedule: Callable[[int], float] | None = None,
                 dtype: torch.dtype = torch.float32,
                 mesh: parallel.Mesh | None = None):
        self.model = model
        self.config = config
        self.mesh = mesh
        self.train_step = make_train_step(model, config, dtype, mesh=mesh)
        self.lr_schedule = lr_schedule
        self.lead = mesh is None or mesh.rank == 0
        self.writer = ScalarWriter(config.log_dir)

    # -- checkpointing ---------------------------------------------------
    def save_checkpoint(self, state: TrainState, epoch: int) -> str | None:
        """``torch.save`` of the step, the epoch, the model, the optimizer
        and the schedule's arguments to ``ckpt_dir/epoch_XXXX.pt``, on the
        mesh's rank 0 alone (its path; ``None`` on the other ranks)."""
        if not self.lead:
            return None
        os.makedirs(self.config.ckpt_dir, exist_ok=True)
        path = os.path.join(self.config.ckpt_dir, f"epoch_{epoch:04d}.pt")
        torch.save({"step": state.step, "epoch": epoch,
                    "model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "schedule": {"lr": self.config.lr,
                                 "pct_start": self.config.pct_start}}, path)
        return path

    def load_checkpoint(self, state: TrainState, path: str
                        ) -> tuple[TrainState, int]:
        """The state as `path` saved it, and the epoch it completed."""
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        state.optimizer.load_state_dict(ckpt["optimizer"])
        return state, int(ckpt["epoch"])

    # -- the loop --------------------------------------------------------
    def train(self, state: TrainState, loader, epochs: int | None = None,
              start_epoch: int = 0, log: Callable[[str], None] = print
              ) -> TrainState:
        """Run epochs ``[start_epoch, epochs)``. Pass the epoch returned by
        `load_checkpoint` + 1 as `start_epoch` to resume (epoch-granular,
        like the reference)."""
        epochs = epochs or self.config.epochs
        device = next(state.model.parameters()).device
        for epoch in range(start_epoch, epochs):
            loader.set_epoch(epoch)
            t0 = time.time()
            n = 0
            for batch in loader:
                state, loss = self.train_step(state, to_device(batch, device))
                n += 1
                if self.lead and n % self.config.log_every == 0:
                    running = float(loss)
                    scalars = {"train/loss": running, "train/epoch": epoch,
                               "perf/steps_per_s": n / max(time.time() - t0,
                                                           1e-9)}
                    if self.lr_schedule is not None:
                        scalars["train/lr"] = self.lr_schedule(state.step - 1)
                    self.writer.scalars(state.step, **scalars)
                    log(f"epoch {epoch} step {n}: loss {running:.4f}")
            dt = time.time() - t0
            if self.lead:
                log(f"epoch {epoch} done: {n} steps in {dt:.1f}s "
                    f"({n / max(dt, 1e-9):.2f} it/s)")
            self.writer.flush()
            if (epoch + 1) % self.config.save_every == 0:
                self.save_checkpoint(state, epoch)
        return state


__all__ = ["Adam", "TrainConfig", "TrainState", "Trainer", "compute_loss",
           "init_train_state", "make_eval_step", "make_optimizer",
           "make_train_step", "onecycle_schedule", "to_device"]
