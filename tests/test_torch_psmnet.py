"""PSMNet in the PyTorch port against the JAX package on carried weights.

JAX variables are initialised with every head (``train=True``), their
BatchNorm statistics settled on one train-mode pass at 256×512 and then
perturbed, carried into the port with ``utils.weights.from_jax_variables``,
and both eval forwards run on the same numpy inputs on the CPU (the port's
plain paths), at 64×128 and at 256×512 (max_disp 48), where the SPP
windows are the real 64/32/16/8 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gwcnet as gwcnet_fixture
from stereo_toolbox_tpu.models import PSMNet as JaxPSMNet
from stereo_toolbox_tpu.utils.torch_import import import_torch_checkpoint
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

MAX_DISP = 48
SIZES = ((64, 128), (256, 512))


def _pair(h, w, seed):
    rng = np.random.RandomState(seed)
    left = rng.randn(1, h, w, 3).astype(np.float32)
    right = np.roll(left, -3, axis=2) + 0.05 * rng.randn(1, h, w, 3).astype(
        np.float32)
    return left, right


def setup(sizes=SIZES):
    """JAX PSMNet variables (settled at 256×512, perturbed) and its eval
    outputs at `sizes`, keyed by size."""
    rng = np.random.RandomState(0)
    model = JaxPSMNet(max_disp=MAX_DISP)
    x = jnp.asarray(_pair(*SIZES[1], seed=1)[0])
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), x[:, :64, :128], x[:, :64, :128], train=True)
    v = jax.tree_util.tree_map(np.asarray, v)
    v = {"params": v["params"],
         "batch_stats": gwcnet_fixture._settled_stats(model, v, x)}
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.abs(rng.randn(*a.shape)).astype(a.dtype),
        v["batch_stats"])
    apply = jax.jit(lambda vv, a, b: model.apply(vv, a, b, train=False))
    runs = {}
    for size in sizes:
        left, right = _pair(*size, seed=2 + SIZES.index(size))
        runs[size] = (left, right, np.asarray(apply(v, left, right)))
    return v, runs


@pytest.fixture(scope="module")
def jax_setup():
    return setup()


@pytest.mark.parametrize("size", SIZES)
def test_psmnet_matches_jax(jax_setup, size):
    v, runs = jax_setup
    left, right, want = runs[size]
    m = create_model("PSMNet", max_disp=MAX_DISP, device="cpu")
    m.load_state_dict(from_jax_variables("PSMNet", v))
    with torch.no_grad():
        got = m(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    d = np.abs(got - want)
    print(f"PSMNet {size} port vs JAX: mean |d| {d.mean():.3e} px, "
          f"max {d.max():.3e} px")
    assert got.shape == want.shape == (1, *size)
    assert d.mean() < 5e-3
    assert d.max() < 0.1


def test_psmnet_state_dict_round_trips_through_jax_importer(jax_setup):
    v = jax_setup[0]
    m = create_model("PSMNet", max_disp=MAX_DISP, device="cpu")
    m.load_state_dict(from_jax_variables("PSMNet", v))
    sd = {k: t.numpy() for k, t in m.state_dict().items()}
    back = import_torch_checkpoint("PSMNet", sd)   # raises on leftovers
    want = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a)


def test_psmnet_state_dict_has_original_torch_names():
    sd = create_model("PSMNet", max_disp=MAX_DISP, device="cpu").state_dict()
    fe = "feature_extraction"
    for k in (f"{fe}.firstconv.4.0.weight", f"{fe}.layer4.2.conv2.1.bias",
              f"{fe}.branch1.1.0.weight", f"{fe}.branch4.1.1.running_var",
              f"{fe}.lastconv.0.0.weight", f"{fe}.lastconv.0.1.running_mean",
              f"{fe}.lastconv.2.weight", "dres0.0.0.weight",
              "dres0.0.1.running_var", "dres0.2.0.weight", "dres1.2.1.bias",
              "dres2.conv1.0.0.weight", "dres2.conv2.0.weight",
              "dres3.conv2.1.running_mean", "dres4.conv4.0.1.weight",
              "dres2.conv5.0.weight", "dres2.conv5.1.bias",
              "dres4.conv6.1.running_var", "classif1.0.0.weight",
              "classif3.0.1.bias", "classif3.2.weight"):
        assert k in sd, k
    assert tuple(sd["dres0.0.0.weight"].shape) == (32, 64, 3, 3, 3)
    assert tuple(sd[f"{fe}.lastconv.2.weight"].shape) == (32, 128, 1, 1)
    assert tuple(sd["dres2.conv5.0.weight"].shape) == (64, 64, 3, 3, 3)
    assert not any(k.startswith(("classif0", f"{fe}.branch1.0."))
                   for k in sd)
    n = sum(t.numel() for k, t in sd.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked")))
    assert n == 5_224_768      # the original's 5.22M parameters


def test_psmnet_defaults_to_cuda_and_train_mode_raises():
    """CUDA by default; in train mode the float32 model returns its three
    heads at full resolution, and a bfloat16 model raises."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_model("PSMNet")
    m = create_model("PSMNet", max_disp=MAX_DISP, device="cpu").train()
    # B = 2: the 1/4-resolution SPP window pools each image to one pixel,
    # and a train BatchNorm needs more than one value a channel
    x = torch.zeros(2, 64, 128, 3)
    heads = m(x, x)
    assert isinstance(heads, list) and len(heads) == 3
    assert all(h.shape == (2, 64, 128) and h.requires_grad for h in heads)
    bf16 = create_model("PSMNet", max_disp=MAX_DISP, device="cpu",
                        dtype=torch.bfloat16).train()
    with pytest.raises(NotImplementedError, match="bfloat16"):
        bf16(x, x)


def test_psmnet_runs_no_concat_volume_and_no_3d_conv_over_it():
    """The first 3D layer takes the features, never the 64-channel concat
    volume: no module of the model receives a [B, D, H, W, 64] tensor."""
    m = create_model("PSMNet", max_disp=MAX_DISP, device="cpu")
    seen = []
    for mod in m.modules():
        mod.register_forward_pre_hook(lambda mod, inp: seen.extend(
            tuple(t.shape) for t in inp if isinstance(t, torch.Tensor)))
    x = torch.zeros(1, 64, 128, 3)
    with torch.no_grad():
        m(x, x)
    assert (1, MAX_DISP // 4, 16, 32, 32) in seen      # cost0
    assert not any(len(s) == 5 and s[-1] == 64 and s[1] == MAX_DISP // 4
                   for s in seen)
