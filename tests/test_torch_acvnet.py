"""ACVNet in the PyTorch port against the JAX package on carried weights.

JAX variables are initialised with every head (``train=True``), their
BatchNorm statistics settled on one train-mode pass and perturbed, carried
into the port with ``utils.weights.from_jax_variables``, and both eval
forwards run on the same numpy inputs on the CPU (the port's plain paths):
the full two-branch model and its ``attn_weights_only`` mode. At 80×144 and
max_disp 48 the bottleneck attention sees a 3×5×9 volume, padded to whole
4×4×4 blocks in all three axes. Bounds: mean |Δ| < 5e-3 px and max < 0.1 px,
those of the JAX package's cross-framework ACVNet test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu.models import ACVNet as JaxACVNet
from stereo_toolbox_tpu.utils.torch_import import import_torch_checkpoint
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.models.acvnet import BlockAttention3D
from stereo_toolbox_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

H, W, MAX_DISP = 80, 144, 48


def _settled_stats(model, v, x):
    """Running statistics equal to one train-mode pass's batch statistics.
    Flax updates ``new = 0.9 · old + 0.1 · batch``; the feature trunk and
    ``concatconv_0`` run once per view, twice in all, and both views are `x`
    here."""
    _, upd = jax.jit(lambda vv, a: model.apply(
        vv, a, a, train=True, mutable=["batch_stats"]))(v, x)

    def settle(path, new, old):
        key = jax.tree_util.keystr(path)
        twice = key.startswith(("['feature_extraction']",
                                "['concatconv_0']"))
        keep = 0.81 if twice else 0.9
        return (np.asarray(new) - keep * old) / (1.0 - keep)

    return jax.tree_util.tree_map_with_path(settle, upd["batch_stats"],
                                            v["batch_stats"])


@pytest.fixture(scope="module")
def jax_setup():
    rng = np.random.RandomState(0)
    left = rng.randn(1, H, W, 3).astype(np.float32)
    right = np.roll(left, -3, axis=2) + 0.05 * rng.randn(1, H, W, 3).astype(
        np.float32)
    model = JaxACVNet(max_disp=MAX_DISP)
    x = jnp.asarray(left)
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), x, x, train=True)
    v = jax.tree_util.tree_map(np.asarray, v)
    v = {"params": v["params"],
         "batch_stats": _settled_stats(model, v, x)}
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.abs(rng.randn(*a.shape)).astype(a.dtype),
        v["batch_stats"])
    preds = {}
    for attn_only in (False, True):
        m = JaxACVNet(max_disp=MAX_DISP, attn_weights_only=attn_only)
        preds[attn_only] = np.asarray(jax.jit(
            lambda vv, a, b, m=m: m.apply(vv, a, b, train=False))(
                v, x, jnp.asarray(right)))
    return v, left, right, preds


@pytest.mark.parametrize("attn_only", [False, True])
def test_acvnet_matches_jax(jax_setup, attn_only):
    v, left, right, preds = jax_setup
    m = create_model("ACVNet", max_disp=MAX_DISP, device="cpu",
                     attn_weights_only=attn_only)
    m.load_state_dict(from_jax_variables("ACVNet", v))
    with torch.no_grad():
        got = m(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    want = preds[attn_only]
    d = np.abs(got - want)
    print(f"ACVNet port vs JAX (attn_weights_only={attn_only}): mean |d| "
          f"{d.mean():.3e} px, max {d.max():.3e} px")
    assert got.shape == want.shape == (1, H, W)
    assert d.mean() < 5e-3
    assert d.max() < 0.1


@pytest.mark.parametrize("shape", [(1, 3, 5, 9, 128), (2, 4, 8, 4, 32)])
def test_block_attention_matches_jax(shape):
    """The bottleneck attention alone, padded in every axis or in none."""
    from stereo_toolbox_tpu.models.acvnet import \
        BlockAttention3D as JaxBlockAttention3D
    c = shape[-1]
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    jm = JaxBlockAttention3D(num_heads=16)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    p = jax.tree_util.tree_map(np.asarray, v["params"])
    m = BlockAttention3D(c)
    m.load_state_dict({
        "qkv_3d.weight": torch.from_numpy(p["qkv"]["kernel"].T.copy()),
        "qkv_3d.bias": torch.from_numpy(p["qkv"]["bias"].copy()),
        "final1x1.weight": torch.from_numpy(
            p["proj"]["kernel"].transpose(4, 3, 0, 1, 2).copy()),
        "final1x1.bias": torch.from_numpy(p["proj"]["bias"].copy())})
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_state_dict_round_trips_through_jax_importer(jax_setup):
    v = jax_setup[0]
    m = create_model("ACVNet", max_disp=MAX_DISP, device="cpu")
    m.load_state_dict(from_jax_variables("ACVNet", v))
    sd = {k: t.numpy() for k, t in m.state_dict().items()}
    back = import_torch_checkpoint("ACVNet", sd)  # raises on leftovers
    want = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a)


def test_port_state_dict_has_original_torch_names():
    m = create_model("ACVNet", max_disp=MAX_DISP, device="cpu")
    sd = m.state_dict()
    for k in ("feature_extraction.firstconv.0.0.weight",
              "feature_extraction.layer4.2.conv2.1.running_var",
              "patch.weight", "patch_l1.weight", "patch_l3.weight",
              "dres1_att_.2.1.bias", "dres2_att_.conv4.0.0.weight",
              "dres2_att_.attention_block.qkv_3d.weight",
              "dres2_att_.attention_block.qkv_3d.bias",
              "dres2_att_.attention_block.final1x1.bias",
              "dres3.attention_block.final1x1.weight",
              "dres2_att_.redir1.0.weight", "classif_att_.2.weight",
              "concatconv.0.0.weight", "concatconv.2.weight",
              "dres0.0.0.weight", "dres1.2.1.running_mean",
              "dres2.conv6.1.weight", "classif0.2.weight",
              "classif2.0.1.bias"):
        assert k in sd, k
    assert tuple(sd["patch_l3.weight"].shape) == (16, 1, 1, 3, 3)
    assert tuple(sd["classif_att_.2.weight"].shape) == (1, 32, 3, 3, 3)
    assert tuple(sd["dres2_att_.attention_block.qkv_3d.weight"].shape) == (
        384, 128)
    assert tuple(sd["dres0.0.0.weight"].shape) == (32, 64, 3, 3, 3)


def test_create_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model("ACVNet")


def test_train_mode_is_not_implemented():
    """Train mode of ACVNet in float32 returns its four heads at full
    resolution, three with `freeze_attn_weights` and one with
    `attn_weights_only` (`tests/test_torch_train_acvnet.py` holds their
    values); in bfloat16 it is not implemented."""
    x = torch.zeros(1, 32, 64, 3)
    for kw, n in (({}, 4), ({"freeze_attn_weights": True}, 3),
                  ({"attn_weights_only": True}, 1)):
        m = create_model("ACVNet", max_disp=MAX_DISP, device="cpu",
                         **kw).train()
        heads = m(x, x)
        assert isinstance(heads, list) and len(heads) == n, kw
        assert all(h.shape == (1, 32, 64) and h.requires_grad for h in heads)
    bf16 = create_model("ACVNet", max_disp=MAX_DISP, device="cpu",
                        dtype=torch.bfloat16).train()
    with pytest.raises(NotImplementedError, match="bfloat16"):
        bf16(x, x)
