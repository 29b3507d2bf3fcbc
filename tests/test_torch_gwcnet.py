"""GwcNet_G and GwcNet_GC in the PyTorch port against the JAX package on
carried weights.

JAX variables are initialised with every head (``train=True``), their
BatchNorm statistics perturbed, carried into the port with
``utils.weights.from_jax_variables``, and both eval forwards run on the same
numpy inputs on the CPU (the port's plain paths).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu.models import GwcNet_G as JaxGwcNet_G
from stereo_toolbox_tpu.models import GwcNet_GC as JaxGwcNet_GC
from stereo_toolbox_tpu.utils.torch_import import import_torch_checkpoint
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

H, W, MAX_DISP = 64, 128, 48


def _settled_stats(model, v, x):
    """Running statistics equal to one train-mode pass's batch statistics,
    so that eval activations stay O(1) through the random-weight stack.
    Flax updates ``new = 0.9 · old + 0.1 · batch``; the feature trunk runs
    once per view, twice in all, and both views are `x` here."""
    _, upd = jax.jit(lambda vv, a: model.apply(
        vv, a, a, train=True, mutable=["batch_stats"]))(v, x)

    def settle(path, new, old):
        twice = jax.tree_util.keystr(path).startswith("['feature_extraction']")
        keep = 0.81 if twice else 0.9
        return (np.asarray(new) - keep * old) / (1.0 - keep)

    return jax.tree_util.tree_map_with_path(settle, upd["batch_stats"],
                                            v["batch_stats"])


def _setup(jax_model):
    rng = np.random.RandomState(0)
    left = rng.randn(1, H, W, 3).astype(np.float32)
    right = np.roll(left, -3, axis=2) + 0.05 * rng.randn(1, H, W, 3).astype(
        np.float32)
    model = jax_model(max_disp=MAX_DISP)
    x = jnp.asarray(left)
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), x, x, train=True)
    v = jax.tree_util.tree_map(np.asarray, v)
    v = {"params": v["params"],
         "batch_stats": _settled_stats(model, v, x)}
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.abs(rng.randn(*a.shape)).astype(a.dtype),
        v["batch_stats"])
    pred = jax.jit(lambda vv, a, b: model.apply(vv, a, b, train=False))(
        v, x, jnp.asarray(right))
    return v, left, right, np.asarray(pred)


@pytest.fixture(scope="module")
def jax_setup():
    return _setup(JaxGwcNet_G)


@pytest.fixture(scope="module")
def jax_setup_gc():
    return _setup(JaxGwcNet_GC)


def test_gwcnet_g_matches_jax(jax_setup):
    v, left, right, want = jax_setup
    m = create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu")
    m.load_state_dict(from_jax_variables("GwcNet_G", v))
    with torch.no_grad():
        got = m(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    d = np.abs(got - want)
    print(f"GwcNet_G port vs JAX: mean |d| {d.mean():.3e} px, "
          f"max {d.max():.3e} px")
    assert got.shape == want.shape == (1, H, W)
    assert d.mean() < 5e-3
    assert d.max() < 0.1


def test_state_dict_round_trips_through_jax_importer(jax_setup):
    v = jax_setup[0]
    m = create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu")
    m.load_state_dict(from_jax_variables("GwcNet_G", v))
    sd = {k: t.numpy() for k, t in m.state_dict().items()}
    back = import_torch_checkpoint("GwcNet_G", sd)  # raises on leftovers
    want = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a)


def test_port_state_dict_has_original_torch_names():
    m = create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu")
    keys = set(m.state_dict())
    for k in ("feature_extraction.firstconv.0.0.weight",
              "feature_extraction.layer2.0.downsample.1.running_var",
              "dres0.0.0.weight", "dres1.2.1.bias", "dres2.conv5.0.weight",
              "dres2.redir2.0.weight", "dres4.conv6.1.running_mean",
              "classif0.2.weight", "classif3.2.weight"):
        assert k in keys, k


def test_gwcnet_gc_matches_jax(jax_setup_gc):
    """GwcNet_GC: the 12-channel concat feature and the masked concat
    volume (K6 on the card) beside the gwc volume."""
    v, left, right, want = jax_setup_gc
    m = create_model("GwcNet_GC", max_disp=MAX_DISP, device="cpu")
    m.load_state_dict(from_jax_variables("GwcNet_GC", v))
    with torch.no_grad():
        got = m(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    d = np.abs(got - want)
    print(f"GwcNet_GC port vs JAX: mean |d| {d.mean():.3e} px, "
          f"max {d.max():.3e} px")
    assert got.shape == want.shape == (1, H, W)
    assert d.mean() < 5e-3
    assert d.max() < 0.1


def test_gwcnet_gc_state_dict_round_trips_through_jax_importer(jax_setup_gc):
    v = jax_setup_gc[0]
    m = create_model("GwcNet_GC", max_disp=MAX_DISP, device="cpu")
    m.load_state_dict(from_jax_variables("GwcNet_GC", v))
    sd = {k: t.numpy() for k, t in m.state_dict().items()}
    back = import_torch_checkpoint("GwcNet_GC", sd)  # raises on leftovers
    want = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a)


def test_gwcnet_gc_state_dict_has_original_torch_names():
    sd = create_model("GwcNet_GC", max_disp=MAX_DISP, device="cpu"
                      ).state_dict()
    for k in ("feature_extraction.lastconv.0.0.weight",
              "feature_extraction.lastconv.0.1.running_mean",
              "feature_extraction.lastconv.2.weight", "dres0.0.0.weight",
              "classif3.2.weight"):
        assert k in sd, k
    assert tuple(sd["feature_extraction.lastconv.2.weight"].shape) == (
        12, 128, 1, 1)
    assert tuple(sd["dres0.0.0.weight"].shape) == (32, 64, 3, 3, 3)
    g = create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu")
    assert not any("lastconv" in k for k in g.state_dict())


def test_gwcnet_gc_defaults_to_cuda_and_train_mode_raises():
    """GwcNet_GC needs a card unless asked for the CPU; its float32 train
    mode returns the four heads (`tests/test_torch_train_gwcnet_gc.py`
    holds their values), its bfloat16 train mode raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_model("GwcNet_GC")
    m = create_model("GwcNet_GC", max_disp=MAX_DISP, device="cpu").train()
    x = torch.zeros(1, 32, 64, 3)
    heads = m(x, x)
    assert isinstance(heads, list) and len(heads) == 4
    assert all(h.shape == (1, 32, 64) and h.requires_grad for h in heads)
    bf16 = create_model("GwcNet_GC", max_disp=MAX_DISP, device="cpu",
                        dtype=torch.bfloat16).train()
    with pytest.raises(NotImplementedError, match="bfloat16"):
        bf16(x, x)


def test_create_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model("GwcNet_G")


def test_train_mode_is_not_implemented():
    """Train mode of GwcNet_G in float32 returns its four heads
    (``classif0``-``classif3``) at full resolution; in bfloat16 it is not
    implemented (GwcNet_GC's: see above)."""
    m = create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu").train()
    x = torch.zeros(1, 32, 64, 3)
    heads = m(x, x)
    assert isinstance(heads, list) and len(heads) == 4
    assert all(h.shape == (1, 32, 64) and h.requires_grad for h in heads)
    bf16 = create_model("GwcNet_G", max_disp=MAX_DISP, device="cpu",
                        dtype=torch.bfloat16).train()
    with pytest.raises(NotImplementedError, match="bfloat16"):
        bf16(x, x)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import stereo_toolbox_tpu_torch\n"
        "import stereo_toolbox_tpu_torch.ops, stereo_toolbox_tpu_torch.nn\n"
        "import stereo_toolbox_tpu_torch.models, stereo_toolbox_tpu_torch.utils\n"
        "import stereo_toolbox_tpu_torch.models.cfnet\n"
        "import stereo_toolbox_tpu_torch.models.acvnet\n"
        "import stereo_toolbox_tpu_torch.trainer, stereo_toolbox_tpu_torch.train\n"
        "import stereo_toolbox_tpu_torch.datasets\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'stereo_toolbox_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
