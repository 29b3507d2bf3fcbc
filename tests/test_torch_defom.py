"""DEFOMStereo in the port against the JAX package, on the CPU.

DEFOMStereo_S (``vits`` trunk, the published widths) at 64×128 (a 4×8 patch
grid: N = 33 tokens), ``valid_iters = train_iters = 3``, ``scale_iters = 1``,
so that both phases run, from JAX's ``init`` variables carried across
(``utils.weights.from_jax_variables``):

  * the eval forward, mean |Δ| / max(mean |ref|, 1) < 5e-3 and the 99th
    percentile of |Δ| / max(mean |ref|, 1) < 2e-2 (the gate of
    ``tests/test_torch_import.py``'s cross-framework checks);
  * one float32 train step (B 2, the sequence loss over the three
    iterations, on ``tests/test_trainer.py::_batch``) against JAX's loss
    under ``value_and_grad``: the loss 1e-5, the gradients by leaf group (the
    ViT ``pretrained``, the ``depth_feat`` head, ``fnet``, ``cnet``, the
    context convs, both update blocks) each within 5e-2 relative L2, the f32
    CPU-vs-JAX floor of the ReLU models (``PERF.md`` §2), and ``depth_head``
    exactly zero on both sides (JAX stops its output). The ViT's gradient
    comes through the port's attention ``autograd.Function`` (its CPU path:
    ``attention_backward_reference``);
  * one bfloat16 step (``make_train_step(..., dtype=torch.bfloat16)``)
    against JAX's ``--bf16`` step, compiled with XLA's excess precision off
    (`NO_EXCESS_PRECISION`), by the bfloat16 gates of
    `_torch_train_parity`: the loss and each iteration's prediction within
    2× JAX's own spread (its float32 step and its bfloat16 steps on three
    seeded 1e-3 perturbations of the batch, against its bfloat16 step), the
    (frozen) running statistics and the stable leaf groups within 2× JAX's
    own distance, three trainer steps, and the dtypes of every conv and
    BatchNorm call that flax intercepts; the calls flax does not intercept
    (the GRUs' z and r gates, which JAX applies as one conv of its raw
    params, and the attention's projections, flax ``DenseGeneral``s) are
    required to compute in bfloat16;
  * `count_params` of DEFOMStereo_S and DEFOMStereo_L (built on the ``meta``
    device) against JAX's: 43,142,849 and 380,263,009 parameters, 8,256
    BatchNorm statistics each, less the three tap norms a ViT that JAX keeps
    beside the one ``norm``.

JAX's init and its float32 and bfloat16 steps are compiled once, in the
module fixture (the two steps side by side).
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_train_parity import (BF16_FACTOR, PERTURBATION, Recorder, _rel,
                                 bf16_port_step, check_bf16_stable_gradients,
                                 check_bf16_statistics,
                                 check_bf16_three_steps, heads_grad_fn,
                                 init_variables, jax_audit, jax_config,
                                 leaves, to_jax_names)
from stereo_toolbox_tpu import trainer as jtrainer
from stereo_toolbox_tpu.models import create_model as jax_create_model
from stereo_toolbox_tpu_torch.evaluation import count_params
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.models.defom_stereo import DEFOMStereo_L
from stereo_toolbox_tpu_torch.trainer import (TrainConfig, TrainState,
                                              make_train_step, to_device)
from stereo_toolbox_tpu_torch.utils.weights import (from_jax_variables,
                                                    reference_state_dict)
from test_trainer import _batch

torch.set_num_threads(2)

NAME = "DEFOMStereo_S"
KW = dict(train_iters=3, valid_iters=3, scale_iters=1)
H, W = 64, 128
F32_GROUP_BOUND = 5e-2
# JAX's parameters, BatchNorm statistics (jax.eval_shape of its init), and
# the tap norms it keeps beyond the port's one `norm` (3 × 2 × width)
JAX_COUNTS = {"DEFOMStereo_S": (43_142_849, 8_256, 3 * 2 * 384),
              "DEFOMStereo_L": (380_263_009, 8_256, 3 * 2 * 1024)}


# JAX's bfloat16 step is compiled with XLA's excess precision off: on the
# CPU, XLA otherwise keeps float32 through each fused chain of bfloat16
# elementwise ops (the initial disparity, the GRU gates, the scale
# updates), and its bfloat16 loss lands 0.0025 from its float32 one where,
# each op rounded as written, it is 0.078 away (DEFOMStereo_S at this size)
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
# seeded perturbations of the left image: each bfloat16 trajectory's first
# step is one more reading of JAX's own spread
TRAJECTORIES = 3


def jax_steps(jmodels, config, batch, variables):
    """JAX's float32 and bfloat16 (`NO_EXCESS_PRECISION`) steps from
    `variables`, as `_torch_train_parity.bf16_jax_side` gives them (the
    first step's loss, heads, gradients and statistics in each type; the
    float32 gradients on the first perturbed input; three bfloat16 trainer
    steps and, beside them, the float32 trajectory and the bfloat16 ones of
    TRAJECTORIES perturbed inputs; the dtype audit), and the first bfloat16
    step's loss, heads, gradients and statistics on each perturbed input
    (``perturbed16``)."""
    config = jax_config(config)
    params, stats = variables["params"], variables["batch_stats"]
    inputs = [jnp.asarray(batch["left"])] + [jnp.asarray((
        batch["left"] + PERTURBATION * np.random.RandomState(seed).randn(
            *batch["left"].shape)).astype(np.float32))
        for seed in range(TRAJECTORIES)]
    tx, _ = jtrainer.make_optimizer(config, 30)

    @jax.jit
    def update(grads, opt_state, p):
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state

    def unpack(result):
        (loss, (new_stats, outputs)), grads = result
        return (float(loss), [np.asarray(o) for o in outputs],
                jax.tree_util.tree_map(np.asarray, grads),
                jax.tree_util.tree_map(np.asarray, new_stats))

    def trajectory(fn, x):
        p, st, opt_state, first, losses = params, stats, \
            jax.jit(tx.init)(params), None, []
        for _ in range(3):
            result = fn(p, st, x)
            first = first or unpack(result)
            (loss, (st, _)), grads = result
            p, opt_state = update(grads, opt_state, p)
            losses.append(float(loss))
        return first, losses

    def run(dtype):
        fn = heads_grad_fn(jmodels[dtype], config, batch)
        if dtype == "bf16":
            fn = fn.lower(params, stats, inputs[0]).compile(
                compiler_options=NO_EXCESS_PRECISION)
        first, losses = trajectory(fn, inputs[0])
        if dtype == "f32":
            return first, losses, unpack(fn(params, stats, inputs[1]))[2]
        return first, losses, [trajectory(fn, x) for x in inputs[1:]]

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(run, "f32")
        first16, losses16, others16 = run("bf16")
        audit = jax_audit(jmodels["bf16"], config, batch, variables)
        first32, losses32, perturbed_grads = job.result()
    return dict(variables=variables, f32=first32, bf16=first16,
                perturbed_grads=perturbed_grads, losses=losses16,
                other_losses=[losses32] + [t for _, t in others16],
                perturbed16=[first for first, _ in others16],
                jax_audit=audit)


@pytest.fixture(scope="module")
def side():
    batch = _batch(2, H, W)
    config = TrainConfig(lr=1e-3, max_disp=64, loss="sequence",
                         clip_grad=1.0)
    jmodels = {k: jax_create_model(NAME, dtype=dtype, **KW)
               for k, dtype in (("f32", None), ("bf16", jnp.bfloat16))}
    variables = init_variables(jmodels["f32"], batch)
    side = jax_steps(jmodels, config, batch, variables)
    return dict(side, batch=batch, config=config, jmodel=jmodels["f32"])


def _port(variables):
    model = create_model(NAME, device="cpu", **KW)
    model.load_state_dict(from_jax_variables(NAME, variables))
    return model


def test_eval_forward_matches_jax(side):
    rng = np.random.RandomState(0)
    left, right = (rng.randn(1, H, W, 3).astype(np.float32)
                   for _ in range(2))
    jmodel = side["jmodel"]
    want = np.asarray(jax.jit(lambda v, l, r: jmodel.apply(v, l, r))(
        side["variables"], left, right))
    with torch.no_grad():
        got = _port(side["variables"])(torch.from_numpy(left),
                                       torch.from_numpy(right)).numpy()
    assert got.shape == want.shape == (1, H, W)
    d = np.abs(got - want)
    scale = max(float(np.abs(want).mean()), 1.0)
    print(f"{NAME} eval: mean |d| {d.mean():.3e}, p99 "
          f"{np.percentile(d, 99):.3e}, max {d.max():.3e}, scale {scale}")
    assert d.mean() / scale < 5e-3
    assert np.percentile(d, 99) / scale < 2e-2


@pytest.fixture(scope="module")
def f32_step(side):
    model = _port(side["variables"])
    recorder = Recorder()
    _, loss = make_train_step(model, side["config"])(
        TrainState(model.train(), recorder), to_device(side["batch"], "cpu"))
    return dict(name=NAME, model=model, loss=float(loss),
                grads=recorder.grads)


def test_float32_train_step_loss_matches_jax(side, f32_step):
    np.testing.assert_allclose(f32_step["loss"], side["f32"][0], rtol=1e-5)


def test_float32_gradients_by_group_match_jax(side, f32_step):
    """Each top-level group (and the ViT trunk and the two DPT heads of
    ``defomencoder``) within F32_GROUP_BOUND relative L2 of JAX's; the
    frozen depth head's gradient zero on both sides; the ViT's attention
    gets a gradient."""
    got = to_jax_names(NAME, f32_step["model"], f32_step["grads"])["params"]
    want = side["f32"][2]

    def flat(tree):
        return np.concatenate([np.ravel(v) for v in
                               jax.tree_util.tree_leaves(tree)])
    groups = {**{k: (got[k], want[k]) for k in want
                 if k != "defomencoder"},
              **{f"defomencoder/{k}": (got["defomencoder"][k],
                                       want["defomencoder"][k])
                 for k in want["defomencoder"]}}
    zero = groups.pop("defomencoder/depth_head")
    assert not flat(zero[0]).any() and not flat(zero[1]).any()
    for g, (a, b) in sorted(groups.items()):
        a, b = flat(a).astype(np.float64), flat(b).astype(np.float64)
        rel = np.linalg.norm(a - b) / np.linalg.norm(b)
        print(f"  {g}: relative L2 {rel:.3e} (|ref| {np.linalg.norm(b):.3e})")
        assert np.linalg.norm(b) > 0, g
        assert rel <= F32_GROUP_BOUND, g
    qkv = leaves(got)[tuple(jax.tree_util.DictKey(k) for k in (
        "defomencoder", "pretrained", "block0",
        "MultiHeadDotProductAttention_0", "query", "kernel"))]
    assert np.abs(qkv).max() > 0


@pytest.fixture(scope="module")
def bf16(side):
    return {**side, **bf16_port_step(NAME, side["config"], side["batch"],
                                     side["variables"], KW)}


def test_bf16_loss_and_iterations_match_jax(bf16):
    """The loss and each iteration's prediction (relative L2) within
    BF16_FACTOR x JAX's own spread: the farthest its float32 step on the
    batch and its bfloat16 steps on the TRAJECTORIES perturbed inputs lie
    from its bfloat16 step on the batch (the three-step check's yardstick,
    `check_bf16_three_steps`). At init the recurrence turns each rounding
    into a different prediction (the port's bfloat16 loss moves by 0.13
    between 2 and 4 CPU threads), so one distance is one draw of that
    noise."""
    (want, heads), (loss32, heads32) = bf16["bf16"][:2], bf16["f32"][:2]
    others = [(loss32, heads32)] + [b[:2] for b in bf16["perturbed16"]]
    own_loss = max(abs(loss - want) for loss, _ in others)
    got = float(bf16["loss"])
    print(f"{NAME} bf16 loss {got:.6f}, JAX bf16 {want:.6f}, f32 "
          f"{loss32:.6f}; JAX's own spread {own_loss:.3e} (f32 and "
          f"{len(others) - 1} perturbed bf16 steps)")
    assert bf16["loss"].dtype == torch.float32
    assert abs(got - want) <= BF16_FACTOR * own_loss
    assert len(bf16["heads"]) == len(heads) == KW["train_iters"]
    for i, (p, w) in enumerate(zip(bf16["heads"], heads)):
        own = max(_rel(h[i], w) for _, h in others)
        port = _rel(p.numpy(), w)
        print(f"  iteration {i}: port vs JAX bf16 {port:.3e}, JAX's own "
              f"spread {own:.3e}")
        assert p.dtype == torch.float32
        assert port <= BF16_FACTOR * own, i


def test_bf16_frozen_statistics_match_jax(bf16):
    check_bf16_statistics(bf16)
    back = {k: v for k, v in bf16["after"].items() if "running" in k}
    assert all(torch.equal(v, bf16["init"][k]) for k, v in back.items())


def test_bf16_stable_gradients_match_jax(bf16):
    check_bf16_stable_gradients(bf16)


def test_bf16_dtypes_match_jax(bf16):
    """The (input, weight, output) dtypes of each module's calls, as sets:
    flax traces a scan's body more than once, so the modules of the update
    blocks are intercepted more often than they run."""
    records, paths = bf16["audit"].records(), bf16["paths"]
    jax_calls = {p: set(v) for p, v in bf16["jax_audit"]["modules"].items()}
    assert set(records) <= set(paths)
    port = {paths[k]: set(v) for k, v in records.items()}
    extra = {p: v for p, v in port.items() if p not in jax_calls}
    print(f"{NAME} bf16 audit: {len(port)} modules, {len(extra)} that flax "
          f"does not intercept")
    assert {p: port.get(p) for p in jax_calls} == jax_calls
    assert extra and all(
        p[-1] in ("convz", "convr")
        or "MultiHeadDotProductAttention_0" in p for p in extra), extra
    assert all(t == ("bfloat16",) * 3 for v in extra.values() for t in v)
    assert all(g.dtype == torch.float32 for g in bf16["grads"])


def test_bf16_three_steps_losses_match_jax(bf16):
    check_bf16_three_steps(bf16)


@pytest.mark.parametrize("name", ["DEFOMStereo_S", "DEFOMStereo_L"])
def test_count_params_matches_jax(name):
    with torch.device("meta"):
        model = (DEFOMStereo_L() if name == "DEFOMStereo_L"
                 else create_model(name, device="meta"))
    total, learnable = count_params(model)
    params, stats, tap_norms = JAX_COUNTS[name]
    assert (learnable + tap_norms, total - learnable) == (params, stats)


def test_count_params_of_the_jax_init(side):
    """The JAX count of the fixture's init (DEFOMStereo_S at 64×128)."""
    v = side["variables"]
    n = sum(int(np.prod(np.shape(x))) for x in
            jax.tree_util.tree_leaves(v["params"]))
    s = sum(int(np.prod(np.shape(x))) for x in
            jax.tree_util.tree_leaves(v["batch_stats"]))
    assert (n, s) == JAX_COUNTS[NAME][:2]


def test_reference_checkpoint_keys(tmp_path):
    """An original DEFOMStereo checkpoint's keys that the port does not
    register (the JAX importer's: the ImageNet ``mean``/``std`` buffers, the
    doubly registered ``norm3``, ConvBlock's unused ``norm2``, DAv2's
    ``mask_token``) are dropped; a key that merely contains ``mean`` is
    kept."""
    keep = {"fnet.conv1.weight": torch.zeros(1),
            "module.cnet.norm1.running_mean": torch.zeros(1)}
    drop = {k: torch.zeros(1) for k in (
        "mean", "std", "cnet.layer2.0.norm3.weight", "cnet.conv08.norm2.bias",
        "defomencoder.depth_anything.pretrained.mask_token")}
    path = tmp_path / "defom.pth"
    torch.save({"model": {**keep, **drop}}, path)
    assert set(reference_state_dict(NAME, str(path))) == {
        "fnet.conv1.weight", "cnet.norm1.running_mean"}
