"""CFNet in the PyTorch port against the JAX package on carried weights.

JAX variables are initialised with every head (``train=True``), their
BatchNorm statistics settled on one train-mode pass and perturbed, carried
into the port with ``utils.weights.from_jax_variables``, and both eval
forwards run on the same numpy inputs on the CPU (the port's plain paths).

CFNet floors its search bounds into integer disparity samples, so a float
difference of ~1e-6 can move one sample by 1 at a near-tie pixel and the
output there by a few px. The output is held with the quantile bounds of the
JAX package's own cross-framework CFNet test; the ``classif2`` costs, the
last tensor before the first floor, are held tightly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu.models import CFNet as JaxCFNet
from stereo_toolbox_tpu.utils.torch_import import import_torch_checkpoint
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

H, W, MAX_DISP = 64, 128, 64


def _settled_stats(model, v, x):
    """Running statistics equal to one train-mode pass's batch statistics.
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


@pytest.fixture(scope="module")
def jax_setup():
    rng = np.random.RandomState(0)
    left = rng.randn(1, H, W, 3).astype(np.float32)
    right = np.roll(left, -3, axis=2) + 0.05 * rng.randn(1, H, W, 3).astype(
        np.float32)
    model = JaxCFNet(max_disp=MAX_DISP)
    x = jnp.asarray(left)
    v = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), x, x, train=True)
    v = jax.tree_util.tree_map(np.asarray, v)
    v = {"params": v["params"],
         "batch_stats": _settled_stats(model, v, x)}
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: a + 0.1 * np.abs(rng.randn(*a.shape)).astype(a.dtype),
        v["batch_stats"])
    pred, state = jax.jit(lambda vv, a, b: model.apply(
        vv, a, b, train=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name == "classif2_out"))(
            v, x, jnp.asarray(right))
    cost = np.asarray(state["intermediates"]["classif2_out"]["__call__"][0])
    return v, left, right, np.asarray(pred), cost


def test_cfnet_matches_jax(jax_setup):
    v, left, right, want, want_cost = jax_setup
    m = create_model("CFNet", max_disp=MAX_DISP, device="cpu")
    m.load_state_dict(from_jax_variables("CFNet", v))
    costs = []
    hook = m.classif2[1].register_forward_hook(
        lambda mod, inp, out: costs.append(out))
    with torch.no_grad():
        got = m(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    hook.remove()
    # port and JAX both [B, D, H, W, 1]
    cost = costs[0][..., 0].numpy()
    err = np.abs(cost - want_cost[..., 0]).max()
    ref = np.abs(want_cost).max()
    d = np.abs(got - want)
    print(f"CFNet port vs JAX: classif2 max|d| {err:.3e} (max|ref| {ref:.3e});"
          f" output median {np.median(d):.3e}, q90 {np.quantile(d, 0.9):.3e},"
          f" mean {d.mean():.3e}, max {d.max():.3e} px")
    assert err <= 1e-4 * ref
    assert got.shape == want.shape == (1, H, W)
    assert np.median(d) < 5e-3
    assert np.quantile(d, 0.9) < 0.1
    assert d.mean() < 0.05


def test_state_dict_round_trips_through_jax_importer(jax_setup):
    v = jax_setup[0]
    m = create_model("CFNet", max_disp=MAX_DISP, device="cpu")
    m.load_state_dict(from_jax_variables("CFNet", v))
    sd = {k: t.numpy() for k, t in m.state_dict().items()}
    back = import_torch_checkpoint("CFNet", sd)  # raises on leftovers
    want = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a)


def test_port_state_dict_has_original_torch_names():
    m = create_model("CFNet", max_disp=MAX_DISP, device="cpu")
    keys = set(m.state_dict())
    for k in ("feature_extraction.firstconv.4.1.running_var",
              "feature_extraction.layer2.0.conv1.0.0.weight",
              "feature_extraction.layer6.0.downsample.1.bias",
              "feature_extraction.pyramid_pooling.path_module_list.3."
              "cbr_unit.0.weight",
              "feature_extraction.pyramid_pooling.path_module_list.0."
              "cbr_unit.1.running_mean",
              "feature_extraction.upconv6.1.0.weight",
              "feature_extraction.iconv2.0.1.weight",
              "feature_extraction.gw2.2.weight",
              "feature_extraction.concat6.0.0.weight",
              "dres0.0.0.weight", "dres1.2.1.bias", "dres0_5.2.0.weight",
              "dres1_6.0.1.running_var", "confidence0_s3.0.0.weight",
              "confidence1_s2.2.1.weight", "combine1.conv1.weight",
              "combine1.combine1.0.0.weight", "combine1.combine2.0.1.bias",
              "combine1.conv8.0.weight", "combine1.conv9.1.running_mean",
              "combine1.redir1.0.weight", "dres3.conv5.0.weight",
              "confidence3_s2.redir2.1.weight", "classif0.2.weight",
              "confidence_classifmid_s3.0.0.weight",
              "confidence_classif1_s2.2.weight", "gamma_s3", "beta_s2"):
        assert k in keys, k
    assert not any("combine3" in k or "redir3" in k for k in keys)


def test_create_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model("CFNet")


def test_train_mode_is_not_implemented():
    """Train mode of CFNet in float32 returns JAX's nine heads at full
    resolution (`tests/test_torch_train_cfnet.py` holds their values); in
    bfloat16 it is not implemented."""
    m = create_model("CFNet", max_disp=MAX_DISP, device="cpu").train()
    x = torch.zeros(1, 64, 128, 3)
    heads = m(x, x)
    assert isinstance(heads, list) and len(heads) == 9
    assert all(h.shape == (1, 64, 128) and h.requires_grad for h in heads)
    bf16 = create_model("CFNet", max_disp=MAX_DISP, device="cpu",
                        dtype=torch.bfloat16).train()
    with pytest.raises(NotImplementedError, match="bfloat16"):
        bf16(x, x)
