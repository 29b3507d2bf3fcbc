"""The port's evaluation suites, entry point and visualization against the
JAX package's.

  * each suite on the same dataset trees (``datasets.fixtures``) with the
    same oracle predictions (ground truth plus a seeded bias), port against
    JAX, within 1e-5;
  * GwcNet_G on 96x96 tiles, max_disp 48: the port on weights carried from
    JAX's by ``from_jax_variables``, JAX on its own; every prediction within
    the forward's gates of ``tests/test_torch_gwcnet.py`` (mean |d| < 5e-3,
    max < 0.1 px), every EPE within 5e-3 and every outlier rate within
    100·k/valid, k the valid pixels whose error lies within 0.1 px of the
    threshold (``evaluation.suite_slack``);
  * ``_write_back`` records, passes and raises on drift, in the JAX
    package's layout;
  * ``count_params`` against JAX's for the six models;
  * ``speed_and_memory_test`` on the CPU at a tiny ladder;
  * the visualization maps against JAX's;
  * ``eval.py --device cpu`` runs each suite on a tree, and ``--torch-ckpt``
    loads a reference-named ``state_dict`` with ``strict=True``.
"""

import argparse
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu import evaluation as jev
from stereo_toolbox_tpu import visualization as jviz
from stereo_toolbox_tpu.datasets import loader as jloader
from stereo_toolbox_tpu.datasets import zoo as jzoo
from stereo_toolbox_tpu.models import create_model as jax_create_model
from stereo_toolbox_tpu.models import GwcNet_G as JaxGwcNet_G
from stereo_toolbox_tpu.utils.torch_import import import_torch_checkpoint
from stereo_toolbox_tpu_torch import eval as port_eval
from stereo_toolbox_tpu_torch import evaluation as ev
from stereo_toolbox_tpu_torch import visualization as viz
from stereo_toolbox_tpu_torch.datasets.fixtures import write_eval_trees
from stereo_toolbox_tpu_torch.models import DepthAnythingV2, create_model
from stereo_toolbox_tpu_torch.trainer import make_eval_step
from stereo_toolbox_tpu_torch.utils.weights import (from_jax_variables,
                                                    reference_state_dict)
from test_torch_gwcnet import _settled_stats

torch.set_num_threads(2)

DATA_SUITES = port_eval.DATA_SUITES
TILE, MAX_DISP = 96, 48


def _trees(root, size, seed):
    sizes = {k: size for k in ("sceneflow", "kitti2015", "kitti2012",
                               "middeval3", "eth3d", "drivingstereo")}
    return write_eval_trees(str(root), frames=2, sizes=sizes,
                            max_disp=MAX_DISP, seed=seed)


def _jax_loaders(suite, roots):
    """The JAX package's loaders over the same trees and manifests."""
    def loader(cls, split, root):
        manifest = os.path.join(roots["lists"], cls.list_name, f"{split}.txt")
        return jloader.DataLoader(cls(split, training=False, root_dir=root,
                                      manifest=manifest),
                                  batch_size=1, num_workers=0)
    root = roots[suite]
    if suite == "sceneflow":
        return loader(jzoo.SceneFlow_Dataset, "test_finalpass", root)
    if suite == "generalization":
        return {name: loader(getattr(jzoo, cls.__name__), split,
                             os.path.join(root, sub))
                for name, (cls, split, sub)
                in port_eval.GENERALIZATION.items()}
    return {w: loader(jzoo.DrivingStereo_Dataset, f"test_half_{w}", root)
            for w in port_eval.WEATHERS}


def _port_loaders(suite, roots):
    return port_eval.suite_loaders(suite, roots[suite], roots["lists"])


def _frames(loaders):
    """Every batch of the suite's loaders, in the suites' order."""
    if isinstance(loaders, dict):
        return {k: list(v) for k, v in loaders.items()}
    return list(loaders)


def _jax_suite(suite, apply_fn, variables, loaders):
    if suite == "sceneflow":
        return jev.sceneflow_test(apply_fn, variables, loaders,
                                  maxdisp=192)
    if suite == "generalization":
        return jev.generalization_eval(apply_fn, variables, loaders)
    return jev.drivingstereo_weather_test(apply_fn, variables, loaders)


# ------------------------------------------------------ oracle predictions
@pytest.fixture(scope="module")
def oracle_trees(tmp_path_factory):
    return _trees(tmp_path_factory.mktemp("oracle"), (40, 56), seed=1)


@pytest.mark.parametrize("sigma", [0.5, 2.5])
@pytest.mark.parametrize("suite", DATA_SUITES)
def test_suites_on_oracle_predictions_match_jax(oracle_trees, suite, sigma):
    port_loaders = _port_loaders(suite, oracle_trees)
    batches = _frames(port_loaders)
    flat = (sum(batches.values(), []) if isinstance(batches, dict)
            else batches)
    rng = np.random.default_rng(int(sigma * 10))
    preds = [np.nan_to_num(b["gt_disp"]) + sigma * rng.standard_normal(
        b["gt_disp"].shape).astype(np.float32) for b in flat]
    port_preds, jax_preds = iter(preds), iter(preds)
    got = port_eval.run_suite(
        suite, lambda left, right: torch.from_numpy(next(port_preds)),
        port_loaders)
    want = _jax_suite(suite, lambda v, left, right: jnp.asarray(
        next(jax_preds)), {}, _jax_loaders(suite, oracle_trees))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert 0 < np.nanmax(got) and np.isfinite(got).all()


# ------------------------------------------------------ GwcNet_G, carried
@pytest.fixture(scope="module")
def gwcnet(tmp_path_factory):
    """JAX's GwcNet_G (settled and perturbed statistics, every head), the
    port's on the same weights, and trees of 96x96 frames."""
    rng = np.random.RandomState(0)
    model = JaxGwcNet_G(max_disp=MAX_DISP)
    x = jnp.asarray(rng.randn(1, TILE, TILE, 3).astype(np.float32))
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), x, x, train=True)
    v = jax.tree_util.tree_map(np.asarray, v)
    v = {"params": v["params"], "batch_stats": _settled_stats(model, v, x)}
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.abs(rng.randn(*a.shape)).astype(a.dtype),
        v["batch_stats"])
    port = create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu")
    port.load_state_dict(from_jax_variables("GwcNet_G", v))
    roots = _trees(tmp_path_factory.mktemp("gwcnet"), (TILE, TILE), seed=2)
    return model, v, port, roots


def _recording(apply_fn, out):
    def fn(*args):
        pred = apply_fn(*args)
        out.append(np.asarray(pred))
        return pred
    return fn


@pytest.mark.parametrize("suite", DATA_SUITES)
def test_gwcnet_suites_match_jax(gwcnet, suite):
    model, v, port, roots = gwcnet
    port_loaders = _port_loaders(suite, roots)
    port_preds, jax_preds = [], []
    got = port_eval.run_suite(
        suite, _recording(ev.make_apply(port), port_preds), port_loaders)
    want = _jax_suite(suite, _recording(jev.make_apply(model), jax_preds),
                      v, _jax_loaders(suite, roots))
    for a, b in zip(port_preds, jax_preds):
        d = np.abs(a - b)
        assert d.mean() < 5e-3 and d.max() < 0.1, (d.mean(), d.max())
    frames = _frames(port_loaders)
    if suite == "sceneflow":
        slack = ev.suite_slack(frames, jax_preds, (1, 2, 3), 0.1, 5e-3)
    else:
        slack, k = [], 0
        for idx, batches in enumerate(frames.values()):
            t = (ev.GENERALIZATION_THRESHOLDS[idx]
                 if suite == "generalization" else 3.0)
            slack.append(ev.suite_slack(
                batches, jax_preds[k:k + len(batches)], (t,), 0.1, 5e-3,
                regions=suite == "generalization"))
            k += len(batches)
        slack = np.stack(slack)
    print(f"{suite}: port {got.tolist()}\n  JAX {want.tolist()}\n  "
          f"slack {slack.tolist()}")
    assert got.shape == want.shape == slack.shape
    assert (np.abs(got - want) <= slack + 1e-6).all()


def test_make_eval_step_runs_eval_in_full_float32(gwcnet):
    """The eval step puts the model in eval mode, runs it in full float32
    under inference mode and equals the model's own forward."""
    port = gwcnet[2]
    seen = []
    hook = port.register_forward_pre_hook(lambda m, a: seen.append(
        (m.training, torch.is_inference_mode_enabled(),
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32)))
    x = torch.from_numpy(np.random.RandomState(3).randn(
        1, TILE, TILE, 3).astype(np.float32))
    port.train()
    try:
        got = make_eval_step(port)(x.numpy(), x.numpy())
    finally:
        hook.remove()
    assert seen == [(False, True, False, False)]
    with torch.no_grad():
        np.testing.assert_array_equal(got.numpy(), port(x, x).numpy())


def test_make_eval_step_feeds_a_monocular_model_left_alone():
    """A model whose class sets ``monocular`` (DepthAnythingV2) gets the
    left image alone; any other gets both."""
    class Mono(torch.nn.Module):
        monocular = True

        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))

        def forward(self, *images):
            return torch.stack(images).sum(0)[..., 0] * self.w

    class Stereo(Mono):
        monocular = False

    left, right = np.ones((1, 4, 6, 3), np.float32), np.full(
        (1, 4, 6, 3), 2, np.float32)
    assert (make_eval_step(Mono())(left, right) == 1).all()
    assert (make_eval_step(Stereo())(left, right) == 3).all()
    assert DepthAnythingV2.monocular


# ------------------------------------------------------------- write-back
def test_write_back_records_passes_and_raises(tmp_path):
    p = str(tmp_path / "metrics.json")
    value = np.array([[1.25, 3.0, 4.5, 2.0]])
    ev._write_back(p, "generalization", value)
    with open(p) as f:
        assert json.load(f) == {"generalization": value.tolist()}
    ev._write_back(p, "generalization", value + 5e-4)        # within 1e-3
    jev._write_back(p, "generalization", value)               # one file
    for fn in (ev._write_back, jev._write_back):
        with pytest.raises(AssertionError, match="drifted"):
            fn(p, "generalization", value + 2e-3)
        with pytest.raises(AssertionError, match="shape changed"):
            fn(p, "generalization", value[0])
    ev._write_back(p, "sceneflow", np.zeros(4))
    with open(p) as f:
        assert set(json.load(f)) == {"generalization", "sceneflow"}
    ev._write_back(None, "sceneflow", np.ones(4))             # off


# ------------------------------------------------------------ count_params
@pytest.mark.parametrize("name", ["PSMNet", "GwcNet_G", "GwcNet_GC",
                                  "ACVNet", "CFNet", "DepthAnythingV2"])
def test_count_params_matches_jax(name):
    """Against JAX's count of its every-head (``train=True``) variables,
    the original toolbox's model. DepthAnythingV2 (``vits``): JAX keeps one
    LayerNorm a tap (the four of the encoder's taps, equal when imported)
    where the port and DINOv2 keep the one ``norm``, so JAX counts three
    norms more."""
    if name == "DepthAnythingV2":
        kw = {"encoder": "vits"}
        args = (jnp.zeros((1, 56, 56, 3)),)
    else:
        kw = {"max_disp": 192}
        args = (jnp.zeros((1, 128, 256, 3)),) * 2
    jmodel = jax_create_model(name, **kw)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                *args, train=True))
    want_total, want_learnable = jev.count_params(shapes)
    got_total, got_learnable = ev.count_params(
        create_model(name, device="cpu", **kw))
    extra = 3 * 2 * 384 if name == "DepthAnythingV2" else 0
    assert (got_total + extra, got_learnable + extra) == (want_total,
                                                          want_learnable)
    assert got_learnable > 0
    assert (got_total > got_learnable) == (name != "DepthAnythingV2")


# ------------------------------------------------------------------ speed
def test_speed_and_memory_on_cpu(capsys):
    model = create_model("GwcNet_G", max_disp=16, device="cpu")
    calls = []

    def apply_fn(left, right):
        calls.append(tuple(left.shape))
        return ev.make_apply(model)(left, right)

    res, times, mems = ev.speed_and_memory_test(
        apply_fn, model, resolutions=[(32, 64), (64, 64)], num_iterations=2,
        warmup=1)
    assert res == [(32, 64), (64, 64)]
    assert calls == [(1, 32, 64, 3)] * 3 + [(1, 64, 64, 3)] * 3
    assert all(t > 0 for t in times) and np.isnan(mems).all()
    total, learnable = ev.count_params(model)
    assert f"Total number of parameters: {total / 1e6:.2f}M" in \
        capsys.readouterr().out


# ---------------------------------------------------------- visualization
@pytest.mark.parametrize("maxval", [0, 40.0])
def test_visualization_maps_equal_jax(tmp_path, maxval):
    rng = np.random.default_rng(4)
    disp = rng.uniform(0, 64, (32, 48)).astype(np.float32)
    disp[:3] = 0
    disp[5, 5] = np.inf
    for name in ("colored_disparity_map_KITTI",
                 "colored_disparity_map_Spectral_r"):
        got = getattr(viz, name)(torch.from_numpy(disp), maxval=maxval)
        np.testing.assert_array_equal(got, getattr(jviz, name)(
            disp, maxval=maxval))
    gt = rng.uniform(0, 80, (32, 48)).astype(np.float32)
    pred = gt + rng.normal(0, 4, gt.shape).astype(np.float32)
    path = str(tmp_path / "sub" / "err.png")
    got = viz.colored_error_map_KITTI(pred, gt, save_file=path)
    np.testing.assert_array_equal(got, jviz.colored_error_map_KITTI(pred, gt))
    assert os.path.exists(path)


# ----------------------------------------------------------------- eval.py
@pytest.fixture(scope="module")
def cli_trees(tmp_path_factory):
    return _trees(tmp_path_factory.mktemp("cli"), (40, 56), seed=3)


@pytest.mark.parametrize("suite", DATA_SUITES)
def test_eval_entry_point_runs_each_suite(cli_trees, tmp_path, suite):
    argv = ["--device", "cpu", "--model", "GwcNet_G", "--max-disp", "32",
            "--suite", suite, "--root", cli_trees[suite],
            "--lists", cli_trees["lists"],
            "--write-json", str(tmp_path / "m.json")]
    got = port_eval.main(argv)
    assert got.shape == {"sceneflow": (4,), "generalization": (4, 4),
                         "weather": (4, 2)}[suite]
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(port_eval.main(argv), got)   # the gate


def test_eval_entry_point_speed_suite(monkeypatch):
    """``--suite speed`` runs `speed_and_memory_test` on the built model
    (here narrowed to one small resolution and one forward)."""
    monkeypatch.setattr(ev, "speed_and_memory_test", functools.partial(
        ev.speed_and_memory_test, resolutions=[(32, 64)], num_iterations=1,
        warmup=0))
    res, times, mems = port_eval.main([
        "--device", "cpu", "--model", "GwcNet_G", "--max-disp", "32",
        "--suite", "speed"])
    assert res == [(32, 64)] and times[0] > 0


def test_eval_entry_point_needs_a_root():
    with pytest.raises(SystemExit):
        port_eval.main(["--device", "cpu", "--suite", "sceneflow"])


def test_torch_ckpt_round_trip(gwcnet, tmp_path):
    """A port ``state_dict``, saved as the original's trainer nests it
    (``{"state_dict": ...}``, DDP ``module.`` prefixes), goes through the
    JAX package's importer back to the variables it came from, and
    ``eval.py --torch-ckpt`` loads it with ``strict=True``."""
    _, v, port, _ = gwcnet
    sd = port.state_dict()
    path = str(tmp_path / "gwcnet.pth")
    torch.save({"epoch": 3, "state_dict": {f"module.{k}": t
                                           for k, t in sd.items()}}, path)
    back = import_torch_checkpoint("GwcNet_G", path)      # raises on leftovers
    want = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for key, a in want.items():
        np.testing.assert_array_equal(got[key], a)
    args = port_eval.parse_args(["--device", "cpu", "--model", "GwcNet_G",
                                 "--max-disp", str(MAX_DISP), "--torch-ckpt",
                                 path, "--seed", "9"])
    loaded = port_eval.build_model(args).state_dict()
    assert set(loaded) == set(sd)
    for k, t in sd.items():
        assert torch.equal(loaded[k], t), k


def test_reference_state_dict_drops_only_unused_keys(tmp_path):
    """CFNet's checkpoints hold ``combine1.combine3`` / ``redir3``, which its
    forward never uses (JAX's importer expects them unused): they are
    dropped, everything else loads strictly, and a missing key raises."""
    model = create_model("CFNet", device="cpu")
    sd = dict(model.state_dict())
    sd["combine1.combine3.0.0.weight"] = torch.zeros(3)
    sd["combine1.redir3.0.weight"] = torch.zeros(3)
    path = str(tmp_path / "cfnet.pth")
    torch.save({"model": sd}, path)
    model.load_state_dict(reference_state_dict("CFNet", path))
    del sd[next(k for k in sd if k.endswith("weight"))]
    torch.save(sd, path)
    with pytest.raises(RuntimeError, match="Missing key"):
        model.load_state_dict(reference_state_dict("CFNet", path))


def test_data_suites_refuse_a_monocular_model():
    with pytest.raises(SystemExit, match="speed suite only"):
        port_eval.main(["--device", "cpu", "--model", "DepthAnythingV2",
                        "--suite", "sceneflow", "--root", "/x"])


def test_eval_args_match_jax_flags():
    """Every flag of ``examples/eval.py`` but ``--dav2-ckpt`` (the
    foundation tier's graft, not ported) is the port's too."""
    port = vars(port_eval.parse_args([]))
    for flag in ("model", "suite", "root", "ckpt", "torch_ckpt", "max_disp",
                 "bf16", "write_json"):
        assert flag in port, flag
    assert isinstance(port_eval.parse_args([]), argparse.Namespace)
