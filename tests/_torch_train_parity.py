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
from collections import Counter

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


def init_variables(model, batch):
    """JAX's ``init`` variables of `model` (train mode, PRNGKey(0)) as
    numpy."""
    x = jnp.asarray(batch["left"][:1])
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), x, x, train=True)
    return jax.tree_util.tree_map(np.asarray, variables)


def jax_side(model, config, batch, steps=3, init_model=None):
    """JAX's init variables (of `init_model`, `model` by default); for
    `steps` steps of the JAX trainer's loss function under value_and_grad
    plus its optimizer: the loss and gradients of the first, the new
    running statistics after it, the losses of all; and the first step's
    gradients and all losses in float64."""
    variables = init_variables(init_model or model, batch)
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


# ------------------------------------------------- bfloat16 train steps
# A bfloat16 train step of the port against JAX's ``--bf16`` step
# (``create_model(..., dtype=jnp.bfloat16)``: float32 params cast at use,
# optax on the float32 leaves). At init a train-mode BatchNorm trunk
# amplifies every rounding in its backward: JAX's own float32 gradient
# moves by ~0.5 relative L2 under a 1e-3 input perturbation, and its
# bfloat16 gradient is ~0.5-0.9 from its float32 one. So the gates use the
# quantities that are well-conditioned, each against JAX's own bfloat16 vs
# float32 distance measured in the same run: the loss, every head's
# prediction, the running statistics, and the gradients of the leaf groups
# (a top-level module of JAX's params tree) whose float32 gradient moves
# less than STABLE under the perturbation. Where the precision goes is
# checked exactly instead, by the dtypes every conv, linear and BatchNorm
# module computes with (`port_audit`, `jax_audit`).

PERTURBATION = 1e-3     # the seeded noise added to the left image
STABLE = 0.1            # a group is stable below this relative L2 move
TRAJECTORIES = 4        # perturbed bfloat16 trainer runs of JAX's
BF16_FACTOR = 2.0       # the port within 2x JAX's bf16-vs-f32 distance
PORT_KINDS = (torch.nn.Conv2d, torch.nn.Conv3d, torch.nn.ConvTranspose3d,
              torch.nn.Linear, torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def heads_grad_fn(model, config, batch):
    """JAX's loss of ``(params, batch_stats, left)`` under value_and_grad,
    jitted, with the new running statistics and the model's outputs (its
    heads' predictions) as aux."""
    right, gt = (jnp.asarray(batch[k]) for k in ("right", "gt_disp"))
    mask = jmetrics.valid_mask(gt, config.max_disp)

    def loss_fn(params, stats, left):
        outputs, updates = model.apply(
            {"params": params, "batch_stats": stats}, left, right,
            train=True, mutable=["batch_stats"])
        return (jtrainer.compute_loss(outputs, gt, mask, config),
                (updates["batch_stats"], outputs))
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def jax_audit(model, config, batch, variables):
    """The dtypes JAX's bfloat16 loss function computes with, from one
    trace (no compile): ``{module path: [(input, weight, output), ...]}``
    for every call of a flax Conv, ConvTranspose, Dense, BatchNorm and the
    JAX package's Conv3dFlex (the input as the op takes it: a conv promotes
    its input and kernel to one type, flax's ``promote_dtype``; a
    BatchNorm takes its float32 scale and bias, flax's
    ``force_float32_reductions``), and the (input, weight, output) dtypes of
    every grouped convolution of the jaxpr (ACVNet's depthwise ``patch``
    convs, which JAX applies without a conv module)."""
    import flax.linen as fnn
    from stereo_toolbox_tpu.nn.layers import Conv3dFlex
    kinds = (fnn.Conv, fnn.ConvTranspose, fnn.Dense, fnn.BatchNorm,
             Conv3dFlex)
    calls: dict = {}

    def intercept(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        m = context.module
        if (context.method_name == "__call__" and isinstance(m, kinds)
                and not kwargs.get("raw")):
            x = args[0]
            if isinstance(m, fnn.BatchNorm):
                xin, w = x.dtype, jnp.float32
            else:
                xin = w = (m.dtype if m.dtype is not None
                           else jnp.result_type(x.dtype, jnp.float32))
            calls.setdefault(m.path, []).append(tuple(
                str(jnp.dtype(t)) for t in (xin, w, out.dtype)))
        return out

    right, gt = (jnp.asarray(batch[k]) for k in ("right", "gt_disp"))
    mask = jmetrics.valid_mask(gt, config.max_disp)

    def loss(v):
        with fnn.intercept_methods(intercept):
            outputs, _ = model.apply(v, jnp.asarray(batch["left"]), right,
                                     train=True, mutable=["batch_stats"])
        return jtrainer.compute_loss(outputs, gt, mask, config)

    grouped = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if (eqn.primitive.name == "conv_general_dilated"
                    and eqn.params["feature_group_count"] > 1):
                grouped.append(tuple(str(v.aval.dtype) for v in
                                     (*eqn.invars[:2], eqn.outvars[0])))
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)
    walk(jax.make_jaxpr(loss)(variables).jaxpr)
    return {"modules": calls, "grouped": grouped}


class PortAudit:
    """The dtypes the port's modules compute with during a step:
    ``{module name: [(input, weight, output), ...]}`` for every call of a
    conv, linear and BatchNorm module (forward hooks; under the bfloat16
    view a module's ``weight`` is the view's tensor), and for the weights
    of such modules that a forward applies without calling the module
    (ACVNet's ``final1x1``, applied by ``F.linear``) the call that takes
    them, caught as a torch function."""

    def __init__(self, model):
        self.model, self.calls, self.loose = model, {}, {}
        self.ptrs: dict = {}
        kinds = [(n, m) for n, m in model.named_modules()
                 if isinstance(m, PORT_KINDS)]
        self.grouped_names = [n for n, m in kinds if getattr(m, "groups", 1)
                              > 1]

        def record(name):
            def hook(mod, inp, out):
                self.calls.setdefault(name, []).append(tuple(
                    _dtype_name(t.dtype) for t in (inp[0], mod.weight, out)))
            return hook

        def weights(mod, inp):
            self.ptrs = {m.weight.data_ptr(): n for n, m in kinds}
        self.hooks = [m.register_forward_hook(record(n)) for n, m in kinds]
        self.hooks.append(model.register_forward_pre_hook(weights))

    def __enter__(self):
        audit = self

        class Mode(torch.overrides.TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if func is torch.nn.functional.linear:
                    name = audit.ptrs.get(args[1].data_ptr())
                    if name is not None:
                        audit.loose.setdefault(name, []).append(tuple(
                            _dtype_name(t.dtype) for t in
                            (args[0], args[1], out)))
                return out
        self.mode = Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        for h in self.hooks:
            h.remove()

    def records(self) -> dict:
        """Each module's calls: its own, or those of its weight where the
        module itself was never called."""
        return {**{k: v for k, v in self.loose.items()
                   if k not in self.calls}, **self.calls}


def module_paths(name, model) -> dict:
    """The port's conv, linear and BatchNorm modules by name → the JAX
    module path that holds the same weight, through the JAX package's own
    importer: each module's weight filled with its own number, every other
    value zero, imported, and each constant JAX kernel or scale read back."""
    sd = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    numbered = {}
    for i, (key, m) in enumerate(model.named_modules(), 1):
        if isinstance(m, PORT_KINDS):
            sd[f"{key}.weight"] = torch.full_like(sd[f"{key}.weight"], i)
            numbered[i] = key
    tree = import_torch_checkpoint(
        name, {k: v.float().numpy() for k, v in sd.items()})["params"]
    paths = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        values = np.unique(np.asarray(leaf))
        if (path[-1].key in ("kernel", "scale") and len(values) == 1
                and int(values[0]) in numbered):
            paths[numbered[int(values[0])]] = tuple(p.key for p in path[:-1])
    return paths


def bf16_jax_side(jmodels, config, batch, variables=None, steps=3):
    """JAX's float32 and bfloat16 steps on `batch` from `variables` (the
    float32 model's `init_variables` by default): ``jmodels`` maps
    ``"f32"`` and ``"bf16"`` to the model built with ``dtype=None`` and
    ``dtype=jnp.bfloat16``. Returns the variables; for each dtype the loss,
    heads, gradients and new running statistics of one step; the float32
    gradients on the left image perturbed by PERTURBATION (seeded); the
    losses of `steps` bfloat16 trainer steps; and JAX's bfloat16 audit."""
    config = jax_config(config)
    if variables is None:
        variables = init_variables(jmodels["f32"], batch)
    params, stats = variables["params"], variables["batch_stats"]
    left = jnp.asarray(batch["left"])

    def perturbed_left(seed):
        noise = np.random.RandomState(seed).randn(*batch["left"].shape)
        return jnp.asarray((batch["left"] + PERTURBATION * noise)
                           .astype(np.float32))
    perturbed = perturbed_left(0)

    def unpack(result):
        (loss, (new_stats, outputs)), grads = result
        return (float(loss), [np.asarray(o) for o in outputs],
                jax.tree_util.tree_map(np.asarray, grads),
                jax.tree_util.tree_map(np.asarray, new_stats))

    tx, _ = jtrainer.make_optimizer(config, 30)

    @jax.jit
    def update(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    def trajectory(fn, x):
        p, s, opt_state, losses = params, stats, jax.jit(tx.init)(params), []
        for _ in range(steps):
            (loss, (s, _)), grads = fn(p, s, x)
            p, opt_state = update(grads, opt_state, p)
            losses.append(float(loss))
        return losses

    def run32():
        fn = heads_grad_fn(jmodels["f32"], config, batch)
        return (unpack(fn(params, stats, left)),
                jax.tree_util.tree_map(np.asarray,
                                       fn(params, stats, perturbed)[1]),
                trajectory(fn, left))

    # XLA compiles the float32 and bfloat16 steps side by side
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(run32)
        fn = heads_grad_fn(jmodels["bf16"], config, batch)
        first = unpack(fn(params, stats, left))
        losses = trajectory(fn, left)
        others = [trajectory(fn, perturbed_left(seed))
                  for seed in range(TRAJECTORIES)]
        audit = jax_audit(jmodels["bf16"], config, batch, variables)
        f32, perturbed_grads, losses32 = job.result()
    return dict(variables=variables, f32=f32, bf16=first,
                perturbed_grads=perturbed_grads, losses=losses,
                other_losses=[losses32, *others], jax_audit=audit)


def bf16_port_step(name, config, batch, variables, model_kw=None):
    """One bfloat16 step of the port's trainer (`make_train_step(...,
    dtype=torch.bfloat16)`) on `batch` from JAX's `variables`, the
    optimizer a `Recorder`: the loss, the heads, the gradients handed to
    the optimizer, the state after, the model, and the audit."""
    model = create_model(name, max_disp=config.max_disp, device="cpu",
                         **(model_kw or {}))
    model.load_state_dict(from_jax_variables(name, variables))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    heads = []
    hook = model.register_forward_hook(
        lambda mod, inp, out: heads.extend(o.detach() for o in out))
    recorder = Recorder()
    with PortAudit(model) as audit:
        _, loss = make_train_step(model, config, torch.bfloat16)(
            TrainState(model.train(), recorder), to_device(batch, "cpu"))
    hook.remove()
    return dict(name=name, model=model, config=config, batch=batch,
                init=init, loss=loss, heads=heads, grads=recorder.grads,
                after={k: v.clone() for k, v in model.state_dict().items()},
                audit=audit, paths=module_paths(name, model))


def bf16_step(name, jmodels, config, batch, model_kw=None, variables=None):
    """`bf16_jax_side` and `bf16_port_step` together: the dict the bfloat16
    parity tests read."""
    side = bf16_jax_side(jmodels, config, batch, variables=variables)
    return {**side, **bf16_port_step(name, config, batch, side["variables"],
                             model_kw)}


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _stats_distance(got, want) -> dict:
    """The running statistics of `got` against `want` (JAX trees): the RMS
    over every channel of |Δmean| / √var and of |Δvar| / var."""
    sq = {"mean": [], "var": []}

    def visit(a, b):
        if "var" not in b:
            for k in b:
                visit(a[k], b[k])
            return
        var = np.asarray(b["var"], np.float64)
        sq["mean"].append(((np.asarray(a["mean"], np.float64) - b["mean"])
                           ** 2 / var).ravel())
        sq["var"].append(((np.asarray(a["var"], np.float64) - var) / var)
                         .ravel() ** 2)
    visit(got, want)
    return {k: float(np.sqrt(np.concatenate(v).mean())) for k, v in
            sq.items()}


def check_bf16_loss_and_heads(step):
    """The loss and each head within BF16_FACTOR x JAX's own bf16-vs-f32
    distance (the loss by |Δ|, a head by its relative L2)."""
    (loss32, heads32, _, _), (loss16, heads16, _, _) = step["f32"], \
        step["bf16"]
    got = float(step["loss"])
    print(f"{step['name']} bf16 loss {got:.6f}, JAX bf16 {loss16:.6f}, "
          f"f32 {loss32:.6f}")
    assert step["loss"].dtype == torch.float32
    assert abs(got - loss16) <= BF16_FACTOR * abs(loss16 - loss32)
    assert len(step["heads"]) == len(heads16) == len(heads32)
    for i, (p, a, b) in enumerate(zip(step["heads"], heads16, heads32)):
        assert p.dtype == torch.float32
        port, own = _rel(p.numpy(), a), _rel(a, b)
        print(f"  head {i}: port vs JAX bf16 {port:.3e}, JAX bf16 vs f32 "
              f"{own:.3e}")
        assert port <= BF16_FACTOR * own, i


def check_bf16_statistics(step):
    back = import_torch_checkpoint(
        step["name"], {k: v.numpy() for k, v in step["after"].items()}
    )["batch_stats"]
    port = _stats_distance(back, step["bf16"][3])
    own = _stats_distance(step["bf16"][3], step["f32"][3])
    print(f"{step['name']} bf16 running statistics: port vs JAX bf16 {port},"
          f" JAX bf16 vs f32 {own}")
    for k in port:
        assert port[k] <= BF16_FACTOR * own[k], k


def stable_groups(step) -> dict:
    """JAX's float32 gradient by top-level group: ``{group: relative L2
    move under the input perturbation}`` for the groups below STABLE."""
    grads, moved = step["f32"][2], step["perturbed_grads"]

    def flat(tree):
        return np.concatenate([np.ravel(v) for v in
                               jax.tree_util.tree_leaves(tree)])
    moves = {g: _rel(flat(moved[g]), flat(grads[g])) for g in grads
             if np.any(flat(grads[g]))}
    return {g: m for g, m in sorted(moves.items()) if m < STABLE}


def check_bf16_stable_gradients(step, expect=None):
    """Each stable group's gradient (the port's, handed to the optimizer,
    mapped to JAX names) within BF16_FACTOR x JAX's own bf16-vs-f32
    distance for it; `expect` (a prefix) names groups that must be among
    the stable ones."""
    groups = stable_groups(step)
    print(f"{step['name']} stable groups (f32 move under {PERTURBATION}): "
          f"{groups}")
    assert groups
    if expect:
        assert any(g.startswith(expect) for g in groups), groups
    got = to_jax_names(step["name"], step["model"],
                       [g.float() for g in step["grads"]])["params"]
    g16, g32 = step["bf16"][2], step["f32"][2]

    def flat(tree):
        return np.concatenate([np.ravel(v) for v in
                               jax.tree_util.tree_leaves(tree)])
    for g in groups:
        port, own = _rel(flat(got[g]), flat(g16[g])), _rel(flat(g16[g]),
                                                           flat(g32[g]))
        print(f"  {g}: port vs JAX bf16 {port:.3e}, JAX bf16 vs f32 "
              f"{own:.3e}")
        assert port <= BF16_FACTOR * own, g


def check_bf16_audit(step):
    """The dtype audit, exact: every module call the two map to each other
    (by the weight importer's names) computes with the same (input,
    weight, output) dtypes in both, call for call; the grouped convs JAX
    applies without a module (ACVNet's ``patch``) by their multiset; and
    every gradient handed to the optimizer is float32."""
    records, paths = step["audit"].records(), step["paths"]
    jax_calls = step["jax_audit"]["modules"]
    port = {paths[k]: v for k, v in records.items()
            if k not in step["audit"].grouped_names}
    grouped = sorted(t for k in step["audit"].grouped_names
                     for t in records.get(k, []))
    print(f"{step['name']} bf16 audit: {len(port)} modules, "
          f"{sum(map(len, port.values()))} calls, dtypes "
          f"{dict(Counter(t for v in port.values() for t in v))}; grouped "
          f"convs {grouped}")
    assert set(records) <= set(paths)
    assert port == jax_calls
    assert grouped == sorted(step["jax_audit"]["grouped"])
    assert all(g.dtype == torch.float32 for g in step["grads"])


def check_bf16_three_steps(step, rtol=1e-2):
    """Three bfloat16 trainer steps (optimizer and all) against JAX's:
    each loss within `rtol`, or, where it is wider, within BF16_FACTOR x
    the farthest that JAX's own trajectories lie from its bfloat16 one at
    that step: its float32 trajectory and its bfloat16 ones on
    TRAJECTORIES seeded PERTURBATION-sized perturbations of the left image.
    Adam's first updates are sign-like (lr·g/|g|) and the gradient at init
    is ill-conditioned (its float32 and bfloat16 versions are 0.2-0.5 apart
    a group, as the port's and JAX's bfloat16 ones are), so by the third
    step JAX's own trajectories spread by up to 2.3% (PSMNet)."""
    model = step["model"]
    model.load_state_dict(step["init"])
    state = init_train_state(model, step["config"], 30, torch.bfloat16)
    train_step = make_train_step(model, step["config"], torch.bfloat16)
    batch = to_device(step["batch"], "cpu")
    losses = []
    for _ in range(3):
        state, loss = train_step(state, batch)
        losses.append(float(loss))
    want = np.asarray(step["losses"])
    own = np.abs(np.asarray(step["other_losses"]) - want).max(axis=0)
    bound = np.maximum(rtol * np.abs(want), BF16_FACTOR * own)
    print(f"{step['name']} bf16: losses {losses} vs JAX {want.tolist()}; "
          f"JAX's own trajectories (f32, perturbed bf16) "
          f"{np.asarray(step['other_losses']).tolist()}; bounds "
          f"{bound.tolist()}")
    assert (np.abs(np.asarray(losses) - want) <= bound).all()
