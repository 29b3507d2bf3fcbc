"""The port's bfloat16 training plumbing, exactly, on the CPU, and the
planted faults its checks catch.

bfloat16 training keeps the float32 model's parameters as the masters and
runs each step on a bfloat16 view of them (`models.bfloat16_view`,
``trainer.make_train_step(..., dtype=torch.bfloat16)``). Here, without
JAX:

- the view: every BatchNorm value and CFNet's ``gamma_s*`` / ``beta_s*``
  are the float32 masters themselves, every other floating parameter the
  master rounded to bfloat16;
- the gradient the optimizer receives for each master is the view's
  gradient widened to float32, bit for bit;
- one step at updates below half a bfloat16 ulp moves every master whose
  gradient is nonzero and no bfloat16 view;
- a train BatchNorm on a bfloat16 input takes flax's statistics (float32,
  the biased variance) and rounds its output once;
- the loss and the heads are float32;
- save and resume in bfloat16 are bit-exact, and ``train.py --bf16`` trains
  on the CPU.

Each planted fault (Adam on bfloat16 leaves, BatchNorm statistics summed in
bfloat16, one `keeps_float32` value cast, the loss taken in bfloat16) makes
its check fail (`test_planted_fault_fails_its_check`).
"""

import contextlib
import os
import subprocess
import sys

import pytest
import torch
import torch.nn.functional as F

from stereo_toolbox_tpu_torch import models, trainer as port_trainer
from stereo_toolbox_tpu_torch.datasets import (DataLoader,
                                               SyntheticStereoDataset)
from stereo_toolbox_tpu_torch.models import (acvnet, bfloat16_view,
                                             create_model)
from stereo_toolbox_tpu_torch.nn.layers import BatchNorm3d, FlaxRunningStats
from stereo_toolbox_tpu_torch.train import LOSS_WEIGHTS
from stereo_toolbox_tpu_torch.trainer import (Adam, TrainConfig, TrainState,
                                              Trainer, compute_loss,
                                              init_train_state,
                                              make_train_step, to_device)
from test_trainer import _batch

torch.set_num_threads(2)

BF16 = torch.bfloat16
MAX_DISP = 16


def _config(**kw):
    kw.setdefault("lr", 1e-3)
    return TrainConfig(max_disp=MAX_DISP, loss="multihead", clip_grad=1.0,
                       loss_weights=LOSS_WEIGHTS["GwcNet_G"], **kw)


def _model(seed=0):
    return create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu",
                        generator=torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def batch():
    return to_device(_batch(2, 32, 48), "cpu")


class Recorder:
    count = 0

    def step(self, grads):
        self.grads = [g.detach().clone() for g in grads]


# ------------------------------------------------------------ the checks
def check_view(model):
    """The view of `model` (GwcNet_G or CFNet): the float32 values, named
    here without `keeps_float32` (every parameter of a BatchNorm module,
    CFNet's search-range scales), are the masters themselves; every other
    floating parameter is its master rounded to bfloat16."""
    kept = {f"{n}.{k}" for n, m in model.named_modules()
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d))
            for k, _ in m.named_parameters(recurse=False)}
    kept |= {k for k in ("gamma_s3", "beta_s3", "gamma_s2", "beta_s2")
             if hasattr(model, k)}
    view = bfloat16_view(model)
    masters = dict(model.named_parameters())
    assert set(view) == set(masters)
    assert kept and kept < set(masters)
    for k, p in masters.items():
        if k in kept:
            assert view[k] is p and p.dtype == torch.float32, k
        else:
            assert view[k].dtype == BF16 and not isinstance(
                view[k], torch.nn.Parameter), k
            assert torch.equal(view[k], p.detach().to(BF16)), k


def check_gradients_are_the_views(model, batch, config):
    """The trainer's bfloat16 step hands the optimizer, for each master,
    its view's gradient widened to float32, bit for bit: the step against
    ``autograd.grad`` of the same loss with respect to a fresh view."""
    init = {k: v.clone() for k, v in model.state_dict().items()}
    rec = Recorder()
    _, loss = make_train_step(model, config, BF16)(
        TrainState(model.train(), rec), batch)
    model.load_state_dict(init)
    view = bfloat16_view(model)
    names = [k for k, _ in model.named_parameters()]
    gt = batch["gt_disp"]
    outputs = torch.func.functional_call(model, view,
                                         (batch["left"], batch["right"]))
    want_loss = compute_loss(outputs, gt, port_trainer.metrics.valid_mask(
        gt, config.max_disp), config)
    grads = torch.autograd.grad(want_loss, [view[k] for k in names],
                                allow_unused=True)
    assert torch.equal(loss, want_loss.detach())
    for k, got, g in zip(names, rec.grads, grads):
        want = torch.zeros_like(got) if g is None else g.float()
        assert got.dtype == torch.float32, k
        assert torch.equal(got, want), k
    return rec.grads


def check_masters_move_and_views_do_not(model, batch):
    """Masters whose views are bfloat16 set to bfloat16 values of one
    binade, |x| in [1/16, 1/8) (half an ulp: 2⁻¹²); one step whose Adam
    updates are lr/25 = 1e-5: every master with a nonzero gradient has
    moved (each element whose gradient is above 1e-6), and no view has."""
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for k, p in bfloat16_view(model).items():
            if p.dtype == BF16:
                master = model.get_parameter(k)
                mag = (torch.rand(master.shape, generator=gen) + 1) / 16
                sign = torch.where(torch.rand(master.shape, generator=gen)
                                   < 0.5, -1.0, 1.0)
                master.copy_((sign * mag).to(BF16).float())
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    views = {k: v.detach().clone() for k, v in bfloat16_view(model).items()}
    config = _config(lr=25e-5)
    state = init_train_state(model, config, 10, BF16)
    rec = Recorder()
    opt_step = state.optimizer.step

    def recording(grads):
        rec.step(grads)
        opt_step(grads)
    state.optimizer.step = recording
    make_train_step(model, config, BF16)(state, batch)
    after = bfloat16_view(model)
    for (k, p), g in zip(model.named_parameters(), rec.grads):
        if g.abs().max() > 0:
            moved = p.detach() != before[k]
            assert moved.any(), k
            assert moved[g.abs() > 1e-6].all(), k
        if views[k].dtype == BF16:
            assert torch.equal(after[k], views[k]), k


def flax_statistics(x, running_mean, running_var, momentum=0.1, eps=1e-5):
    """flax's train BatchNorm in float64 on x widened: the output and the
    new running mean and (biased) variance."""
    x64 = x.double()
    dims = [0] + list(range(2, x.dim()))
    mean = x64.mean(dims)
    var = (x64 * x64).mean(dims) - mean * mean
    shape = [1, -1] + [1] * (x.dim() - 2)
    y = (x64 - mean.reshape(shape)) / torch.sqrt(var.reshape(shape) + eps)
    return (y, (1 - momentum) * running_mean.double() + momentum * mean,
            (1 - momentum) * running_var.double() + momentum * var)


def check_batchnorm_statistics():
    """A train BatchNorm3d on a bfloat16 input ``[2, 8, 6, 10, 12]`` with
    a large common offset (mean ~30, std ~1: where a bfloat16 sum loses
    the spread): float32 weight and buffers kept, the new running
    statistics flax's within 1e-5 of the spread, the output bfloat16 and
    its float64 value within half a bfloat16 ulp plus 1e-5."""
    gen = torch.Generator().manual_seed(2)
    x = (30 + torch.randn(2, 8, 6, 10, 12, generator=gen)).to(BF16)
    bn = BatchNorm3d(8).train()
    y = bn(x)
    want, mean, var = flax_statistics(x, torch.zeros(8), torch.ones(8))
    assert y.dtype == BF16 and bn.running_var.dtype == torch.float32
    spread = var.sqrt()
    assert ((bn.running_mean.double() - mean).abs() / spread).max() < 1e-5
    assert ((bn.running_var.double() - var).abs() / var).max() < 1e-5
    err = (y.double() - want).abs()
    assert (err <= want.abs() * 2.0 ** -8 + 1e-5).all()


def check_loss_is_float32(model, batch, config):
    """The bfloat16 step's heads and loss are float32: the loss equals the
    loss of the captured float32 heads, bit for bit."""
    heads = []
    hook = model.register_forward_hook(
        lambda mod, inp, out: heads.extend(o.detach() for o in out))
    _, loss = make_train_step(model, config, BF16)(
        TrainState(model.train(), Recorder()), batch)
    hook.remove()
    gt = batch["gt_disp"]
    assert all(h.dtype == torch.float32 for h in heads)
    assert loss.dtype == torch.float32
    want = compute_loss(heads, gt, port_trainer.metrics.valid_mask(
        gt, config.max_disp), config)
    assert torch.equal(loss, want)


# ------------------------------------------------------------- the tests
def test_view_keeps_float32_what_jax_keeps():
    check_view(_model())
    check_view(create_model("CFNet", max_disp=32, device="cpu"))


def test_optimizer_receives_the_views_gradients(batch):
    grads = check_gradients_are_the_views(_model(), batch, _config())
    assert sum(int(g.abs().max() > 0) for g in grads) > len(grads) // 2


def test_updates_below_half_an_ulp_move_masters_not_views(batch):
    check_masters_move_and_views_do_not(_model(), batch)


def test_batchnorm_takes_flax_float32_statistics_of_a_bfloat16_input():
    check_batchnorm_statistics()


def test_bfloat16_step_loss_is_float32(batch):
    check_loss_is_float32(_model(), batch, _config())


@pytest.mark.parametrize("dilation", [2, 3])
def test_acvnet_dilated_patch_conv_weight_gradient_on_the_cpu(dilation):
    """ACVNet's dilated depthwise ``patch`` convs on a channels-last slice
    of a ``[2, 48, 16, 32, 40]`` gwc volume, as its forward calls them
    (`acvnet.depthwise_input`): the bfloat16 weight gradient within 1e-2
    relative L2 of the float32 one (bfloat16's own: ~3e-3; PyTorch's CPU
    kernel on the channels-last slice itself: 1.0-1.2)."""
    gen = torch.Generator().manual_seed(4)
    vol = torch.randn(2, 48, 16, 32, 40, generator=gen).movedim(-1, 1)
    conv = acvnet._depthwise(16, dilation)
    grad = torch.randn(2, 16, 48, 16, 32, generator=gen)
    got = {}
    for dtype in (torch.float32, BF16):
        weight = conv.weight.detach().to(dtype).requires_grad_()
        x = acvnet.depthwise_input(vol[:, 8:24].to(dtype), dilation)
        y = F.conv3d(x, weight, None, 1, conv.padding, conv.dilation, 16)
        got[dtype] = torch.autograd.grad(y, weight, grad.to(dtype))[0].float()
    err = (got[BF16] - got[torch.float32]).norm() / got[torch.float32].norm()
    assert err < 1e-2, err.item()


def test_a_cast_model_does_not_train_and_a_bfloat16_step_needs_masters():
    """A bfloat16 model (``create_model(..., dtype=torch.bfloat16)``) has
    no masters: its train forward raises, and so does a bfloat16 step or
    train state built on it."""
    cast = create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu",
                        dtype=BF16)
    x = torch.zeros(1, 32, 48, 3)
    with pytest.raises(NotImplementedError, match="float32 model"):
        cast.train()(x, x)
    for build in (lambda: make_train_step(cast, _config(), BF16),
                  lambda: init_train_state(cast, _config(), 10, BF16)):
        with pytest.raises(TypeError, match="master"):
            build()
    with pytest.raises(TypeError, match="float16"):
        make_train_step(_model(), _config(), torch.float16)


def _trainer_run(tmp_path, epochs, resume=None):
    config = TrainConfig(lr=1e-3, max_disp=MAX_DISP, loss="multihead",
                         clip_grad=1.0, ckpt_dir=str(tmp_path), log_every=1,
                         loss_weights=LOSS_WEIGHTS["GwcNet_G"])
    model = _model(3)
    loader = DataLoader(SyntheticStereoDataset(
        num_samples=4, height=60, width=80, max_disp=12, crop_size=(32, 48),
        seed=2), batch_size=2, shuffle=True, seed=2, num_workers=0)
    state = init_train_state(model, config, 2 * len(loader), BF16)
    trainer = Trainer(model, config, dtype=BF16)
    start = 0
    if resume:
        state, last = trainer.load_checkpoint(state, resume)
        start = last + 1
    return trainer.train(state, loader, epochs=epochs, start_epoch=start,
                         log=lambda s: None)


def test_bfloat16_resume_is_bit_exact(tmp_path):
    """Two bfloat16 epochs straight equal one epoch, a checkpoint (float32
    masters and running statistics), a fresh model loaded from it and one
    more epoch, bit for bit."""
    straight = _trainer_run(tmp_path / "a", 2)
    _trainer_run(tmp_path / "b", 1)
    resumed = _trainer_run(tmp_path / "c", 2,
                           resume=str(tmp_path / "b" / "epoch_0000.pt"))
    assert straight.step == resumed.step == 4
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype in (torch.float32, torch.int64), k
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)
    for key in ("mu", "nu"):
        for x, y in zip(getattr(straight.optimizer, key),
                        getattr(resumed.optimizer, key)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    ckpt = torch.load(tmp_path / "a" / "epoch_0001.pt", weights_only=True)
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in ckpt["model"].values())


def test_entry_point_trains_in_bfloat16_on_the_cpu(tmp_path):
    """``train.py --bf16 --device cpu``: two steps on the synthetic
    dataset, a float32 checkpoint."""
    r = subprocess.run(
        [sys.executable, "-m", "stereo_toolbox_tpu_torch.train", "--bf16",
         "--device", "cpu", "--model", "GwcNet_G", "--epochs", "1",
         "--batch-size", "32", "--crop", "32", "48", "--maxdisp", "16",
         "--num-workers", "0", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "in bfloat16" in r.stdout and "epoch 0 done: 2 steps" in r.stdout
    ckpt = torch.load(tmp_path / "epoch_0000.pt", weights_only=True)
    assert ckpt["step"] == 2
    assert all(v.dtype in (torch.float32, torch.int64)
               for v in ckpt["model"].values())


# ------------------------------------------------------ planted faults
@contextlib.contextmanager
def _patched(obj, attr, value):
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


def _adam_on_bf16_leaves():
    """Adam updates bfloat16 copies of the masters and writes them back."""
    step = Adam.step

    def faulty(self, grads):
        masters = self.params
        self.params = [p.detach().to(BF16) for p in masters]
        self.mu = [m.to(BF16) for m in self.mu]
        self.nu = [n.to(BF16) for n in self.nu]
        step(self, [g.to(BF16) for g in grads])
        with torch.no_grad():
            for m, p in zip(masters, self.params):
                m.copy_(p.float())
        self.params = masters
    return _patched(Adam, "step", faulty)


def _bn_summed_in_bf16():
    """The train BatchNorm takes a bfloat16 input's statistics in bfloat16
    (its mean and mean square summed in bfloat16 partials) and normalises
    with them."""
    forward = FlaxRunningStats.forward

    def faulty(self, x):
        if x.dtype != BF16:
            return forward(self, x)
        flat = x.movedim(1, 0).reshape(x.shape[1], -1)
        total = torch.zeros(x.shape[1], dtype=BF16)
        square = torch.zeros(x.shape[1], dtype=BF16)
        for part in flat.split(64, dim=1):
            total = total + part.sum(1).to(BF16)
            square = square + (part.float() ** 2).sum(1).to(BF16)
        n = flat.shape[1]
        mean, var = total.float() / n, square.float() / n
        var = var - mean * mean
        m = self.momentum
        with torch.no_grad():
            self.num_batches_tracked += 1
            self.running_mean.mul_(1 - m).add_(m * mean)
            self.running_var.mul_(1 - m).add_(m * var)
        shape = [1, -1] + [1] * (x.dim() - 2)
        y = (x.float() - mean.reshape(shape)) * torch.rsqrt(
            var.reshape(shape) + self.eps)
        return (y * self.weight.reshape(shape)
                + self.bias.reshape(shape)).to(BF16)
    return _patched(FlaxRunningStats, "forward", faulty)


def _one_kept_value_cast():
    """CFNet's ``gamma_s3`` left out of `keeps_float32`: cast to
    bfloat16."""
    params = dict(models.F32_PARAMS)
    params[models.CFNet] = ("beta_s3", "gamma_s2", "beta_s2")
    return _patched(models, "F32_PARAMS", params)


def _loss_in_bf16():
    """The loss taken on the heads rounded to bfloat16."""
    loss = port_trainer.compute_loss

    def faulty(outputs, *args, **kw):
        return loss([o.to(BF16) for o in outputs], *args, **kw)
    return _patched(port_trainer, "compute_loss", faulty)


FAULTS = {
    "adam_on_bf16_leaves": (_adam_on_bf16_leaves,
                            lambda b: check_masters_move_and_views_do_not(
                                _model(), b)),
    "bn_summed_in_bf16": (_bn_summed_in_bf16,
                          lambda b: check_batchnorm_statistics()),
    "one_kept_value_cast": (_one_kept_value_cast,
                            lambda b: check_view(create_model(
                                "CFNet", max_disp=32, device="cpu"))),
    "loss_in_bf16": (_loss_in_bf16,
                     lambda b: check_loss_is_float32(_model(), b,
                                                     _config())),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_its_check(fault, batch):
    plant, check = FAULTS[fault]
    with plant(), pytest.raises(AssertionError):
        check(batch)
