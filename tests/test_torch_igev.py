"""IGEVStereo in the PyTorch port against the JAX package, on the CPU.

The published widths (hidden dims 128×3, 3 GRU layers, 2 correlation
levels of radius 4, max_disp 192 with ``band_margin`` 32: the gwc volume at
D 48 and 8 groups, the band reaching 48 + 8 columns at 1/4) with
``valid_iters=3``, on seeded random JAX variables of an eval-mode init
(`_torch_jax_variables.random_variables`; every BatchNorm's statistics
random) carried into the port by ``utils.weights.from_jax_variables``:

  * the eval forward, ``corr_impl='banded'``, at 64×256 (W/4 = 64 > 48:
    the cap binds) and 64×128 (W/4 = 32: the width clamps it), by DEFOM's
    rule (mean |Δ| / max(mean |ref|, 1) < 5e-3, p99 < 2e-2), and the
    initial disparity (the softmax regression of ``classifier``'s costs,
    at 1/4) within mean < 1e-3 and max < 1e-2 px;
  * the bfloat16 forward against JAX's ``dtype=bfloat16``, compiled with
    XLA's excess precision off, within 2× JAX's own bfloat16-vs-float32
    distance (mean |Δ|);
  * the blocks, float32, 1e-4 × max|ref|: `IGEVFeature` (the MobileNetV2
    trunk and its deconv fusion), `Conv2x` with and without its nearest
    resize, `FeatureAtt`, `GEVHourglass`, each transposed conv alone (2D
    with instance norm, 3D with and without BatchNorm, the superpixel head
    with its bias) and the update block at ``n_gru_layers`` 2 and 3;
  * the ``state_dict``: JAX's importer takes it back to the same variables
    (the train-only heads carried from variables that have them, zeros
    where an eval-mode init lacks them), and its keys are the original
    toolbox's;
  * the entry point: the card by default, raising without one; train mode
    raises.
"""

import flax.linen as fnn
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_variables import carry, close, random_variables
from stereo_toolbox_tpu.models import create_model as jax_create_model
from stereo_toolbox_tpu.models import igev_stereo as jigev
from stereo_toolbox_tpu.nn import igev_blocks as jblocks
from stereo_toolbox_tpu.nn.layers import FeatureAtt as JFeatureAtt
from stereo_toolbox_tpu.utils.torch_import import import_torch_checkpoint
from stereo_toolbox_tpu_torch import eval as port_eval
from stereo_toolbox_tpu_torch.datasets.fixtures import write_eval_trees
from stereo_toolbox_tpu_torch.models import create_model, igev_stereo
from stereo_toolbox_tpu_torch.nn import igev_blocks
from stereo_toolbox_tpu_torch.nn.layers import FeatureAtt
from stereo_toolbox_tpu_torch.utils import weights
from stereo_toolbox_tpu_torch.utils.weights import (IGEV_TRAIN_HEADS,
                                                    from_jax_variables)

torch.set_num_threads(2)

NAME = "IGEVStereo"
ITERS = 3
D4 = 192 // 4
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}


def _pair(h, w, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(1, h, w, 3).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def variables():
    jm = jax_create_model(NAME, valid_iters=ITERS)
    return random_variables(jm.init, *_pair(64, 128), seed=1)


@pytest.fixture(scope="module")
def jax_forward(variables):
    """JAX's forward of `variables` by (H, W, dtype, corr_impl), each
    compiled and run once in the module."""
    return functools.lru_cache(maxsize=None)(
        lambda h, w, dtype=None, impl="banded": _jax_forward(
            variables, h, w, dtype, corr_impl=impl))


def _jax_forward(variables, h, w, dtype=None, **kw):
    """JAX's output and the initial disparity it regresses from
    ``classifier``'s costs (captured)."""
    jm = jax_create_model(NAME, valid_iters=ITERS, dtype=dtype, **kw)
    left, right = _pair(h, w)

    def apply(v, a, b):
        return jm.apply(v, a, b, capture_intermediates=lambda mdl, _:
                        mdl.name == "classifier")
    fn = jax.jit(apply)
    if dtype is not None:
        fn = fn.lower(variables, left, right).compile(
            compiler_options=NO_EXCESS_PRECISION)
    out, state = fn(variables, left, right)
    cost = state["intermediates"]["classifier"]["__call__"][0][..., 0]
    prob = jax.nn.softmax(cost.astype(jnp.float32), axis=1)
    init = jnp.einsum("bdhw,d->bhw", prob, jnp.arange(D4, dtype=jnp.float32))
    return np.asarray(out, np.float32), np.asarray(init)


def _port_forward(variables, h, w, dtype=torch.float32, **kw):
    m = create_model(NAME, device="cpu", dtype=dtype, valid_iters=ITERS,
                     **kw)
    sd = from_jax_variables(NAME, variables)
    m.load_state_dict({k: v.to(m.state_dict()[k].dtype)
                       for k, v in sd.items()})
    costs = []
    m.classifier.register_forward_hook(lambda mod, i, o: costs.append(o))
    with torch.no_grad():
        out = m(*map(torch.from_numpy, _pair(h, w)))
    assert out.dtype == torch.float32
    prob = torch.softmax(costs[0][:, 0].float(), dim=1)
    init = torch.einsum("bdhw,d->bhw", prob, torch.arange(D4).float())
    return out.numpy(), init.numpy()


@pytest.mark.parametrize("h,w,impl", [(64, 256, "banded"),
                                      (64, 128, "banded")])
def test_eval_forward_matches_jax(variables, jax_forward, h, w, impl):
    want, want_init = jax_forward(h, w, impl=impl)
    got, got_init = _port_forward(variables, h, w, corr_impl=impl)
    assert got.shape == want.shape == (1, h, w)
    assert got_init.shape == (1, h // 4, w // 4)
    di = np.abs(got_init - want_init)
    d = np.abs(got - want)
    scale = max(float(np.abs(want).mean()), 1.0)
    print(f"{NAME} {impl} {h}x{w}: init_disp mean |d| {di.mean():.3e}, max "
          f"{di.max():.3e} px; output mean |d| {d.mean():.3e}, p99 "
          f"{np.percentile(d, 99):.3e}, max {d.max():.3e}, scale {scale:.3f}")
    assert di.mean() < 1e-3 and di.max() < 1e-2
    assert d.mean() / scale < 5e-3
    assert np.percentile(d, 99) / scale < 2e-2


def test_bfloat16_forward_within_twice_jax_own_distance(variables,
                                                       jax_forward):
    want32, _ = jax_forward(64, 256)
    want16, _ = jax_forward(64, 256, jnp.bfloat16)
    got16, _ = _port_forward(variables, 64, 256, dtype=torch.bfloat16)
    own = float(np.abs(want16 - want32).mean())
    apart = float(np.abs(got16 - want16).mean())
    print(f"{NAME} bf16: port vs JAX mean |d| {apart:.3e}, JAX bf16 vs f32 "
          f"{own:.3e}")
    assert 0 < own and apart <= 2 * own


# ------------------------------------------------------------------ blocks
def _run(port, *inputs):
    with torch.no_grad():
        return port(*(torch.from_numpy(np.asarray(x)) for x in inputs))


def test_igev_feature_matches_jax():
    x = np.random.RandomState(2).randn(2, 64, 96, 3).astype(np.float32)
    jm = jblocks.IGEVFeature()
    v = random_variables(jm.init, x, seed=3)
    want = jax.jit(jm.apply)(v, x)
    got = _run(carry(igev_blocks.IGEVFeature(), v, weights._igev_feature), x)
    for a, b, c in zip(got, want, (48, 64, 192, 160)):
        assert a.shape[-1] == c
        close(a, b, 1e-4)


@pytest.mark.parametrize("instance_norm", [False, True])
@pytest.mark.parametrize("rem_hw", [(10, 14), (11, 15)])
def test_conv2x_matches_jax(instance_norm, rem_hw):
    """(11, 15): the transposed conv's 10×14 resized to the skip's grid."""
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, 7, 12).astype(np.float32)
    rem = rng.randn(2, *rem_hw, 8).astype(np.float32)
    jm = jblocks.Conv2x(8, deconv=True, instance_norm=instance_norm)
    v = random_variables(jm.init, x, rem, seed=5)
    want = jax.jit(jm.apply)(v, x, rem)
    port = carry(igev_blocks.Conv2x(12, 8, deconv=True,
                                    instance_norm=instance_norm), v,
                 lambda t, p, k: weights._conv2x(t, p, k, instance_norm))
    got = _run(port, x, rem)
    assert got.shape == (2, *rem_hw, 16)
    close(got, want, 1e-4)


def test_feature_att_matches_jax():
    rng = np.random.RandomState(6)
    cv = rng.randn(2, 6, 8, 10, 16).astype(np.float32)
    feat = rng.randn(2, 8, 10, 48).astype(np.float32)
    jm = JFeatureAtt(16)
    v = random_variables(jm.init, cv, feat, seed=7)
    want = jax.jit(jm.apply)(v, cv, feat)
    port = carry(FeatureAtt(16, 48), v, weights._feature_att)
    close(_run(port, cv, feat), want, 1e-4)


def test_gev_hourglass_matches_jax():
    rng = np.random.RandomState(8)
    x = rng.randn(1, 16, 16, 24, 8).astype(np.float32)
    feats = [rng.randn(1, 16 // s, 24 // s, c).astype(np.float32)
             for s, c in ((1, 96), (2, 64), (4, 192), (8, 160))]
    jm = jigev.GEVHourglass(8)
    v = random_variables(jm.init, x, feats, seed=9)
    want = jax.jit(jm.apply)(v, x, feats)
    port = carry(igev_stereo.GEVHourglass(8), v, weights._gev_hourglass)
    with torch.no_grad():
        got = port(torch.from_numpy(x), [torch.from_numpy(f) for f in feats])
    assert got.shape == x.shape
    close(got, want, 1e-4)


class _JaxHead(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(9, (4, 4), strides=(2, 2), padding="SAME",
                                 name="spx_gru")(x)


# each transposed conv alone: (JAX module, port module, converter, input)
TRANSPOSED = {
    "2d_instance_norm": (
        lambda: jblocks.BasicConvIN(8, 4, 2, deconv=True),
        lambda: igev_blocks.BasicConvIN(12, 8, 4, 2, deconv=True),
        lambda t, p, k: t.conv_transpose(f"{p}/ConvTranspose_0",
                                         f"{k}.conv"), (2, 5, 7, 12)),
    "3d_batch_norm": (
        lambda: jblocks.BasicConvBN(8, 4, 2, deconv=True),
        lambda: igev_blocks.BasicConvBN(12, 8, 4, 2, deconv=True, dims=3),
        lambda t, p, k: (t.conv_transpose(f"{p}/ConvTranspose_0",
                                          f"{k}.conv"),
                         t.bn(f"{p}/BatchNorm_0", f"{k}.bn")),
        (1, 3, 5, 7, 12)),
    "3d_plain": (
        lambda: jblocks.BasicConvBN(8, 4, 2, deconv=True, norm=False,
                                    relu=False),
        lambda: igev_blocks.BasicConvBN(12, 8, 4, 2, deconv=True, norm=False,
                                        relu=False, dims=3),
        lambda t, p, k: t.conv_transpose(f"{p}/ConvTranspose_0",
                                         f"{k}.conv"), (1, 3, 5, 7, 12)),
    "spx_head": (
        _JaxHead, lambda: igev_stereo._TransposedHead(12),
        lambda t, p, k: t.conv_transpose(f"{p}/spx_gru", f"{k}.0",
                                         bias=True), (2, 5, 7, 12)),
}


@pytest.mark.parametrize("kind", sorted(TRANSPOSED))
def test_transposed_convs_match_jax(kind):
    make_jax, make_port, convert, shape = TRANSPOSED[kind]
    x = np.random.RandomState(10).randn(*shape).astype(np.float32)
    jm = make_jax()
    v = random_variables(jm.init, x, seed=11)
    want = jax.jit(jm.apply)(v, x)
    got = _run(carry(make_port(), v, convert), x)
    assert got.shape[1:-1] == tuple(2 * s for s in shape[1:-1])
    close(got, want, 1e-4)


@pytest.mark.parametrize("n_gru_layers", [2, 3])
def test_update_block_matches_jax(n_gru_layers):
    rng = np.random.RandomState(12)
    hid = (16, 24, 32)
    b, h, w = 2, 8, 12
    nets = [rng.randn(b, h // s, w // s, c).astype(np.float32)
            for s, c in ((1, 32), (2, 24), (4, 16))]
    ctxs = [[rng.randn(*n.shape).astype(np.float32) for _ in range(3)]
            for n in nets]
    geo = rng.randn(b, h, w, 162).astype(np.float32)
    disp = rng.uniform(0, 20, (b, h, w, 1)).astype(np.float32)
    jm = jigev.IGEVUpdateBlock(hid, n_gru_layers)
    args = (tuple(nets), tuple(tuple(c) for c in ctxs), geo, disp)
    v = random_variables(jm.init, *args, seed=13)
    jn, jmask, jdelta = jax.jit(jm.apply)(v, *args)
    port = carry(igev_stereo.IGEVUpdateBlock(162, hid, n_gru_layers), v,
                 weights._igev_update_block)
    assert hasattr(port, "gru16") == (n_gru_layers == 3)
    with torch.no_grad():
        pn, pmask, pdelta = port(
            tuple(map(torch.from_numpy, nets)),
            tuple(tuple(map(torch.from_numpy, c)) for c in ctxs),
            torch.from_numpy(geo), torch.from_numpy(disp))
    for a, bb in zip(pn[:n_gru_layers], jn[:n_gru_layers]):
        close(a, bb, 1e-4)
    close(pmask, jmask, 1e-4)
    close(pdelta, jdelta, 1e-4)
    assert pmask.shape == (b, h, w, 32) and pdelta.shape == (b, h, w, 1)


# ----------------------------------------------------------------- weights
def _train_heads(seed):
    """Variables of the train-only heads as a JAX ``train=True`` init names
    them."""
    rng = np.random.RandomState(seed)
    shapes = {("spx_4", "Conv_0", "kernel"): (3, 3, 96, 24),
              ("spx_4b", "kernel"): (3, 3, 24, 24),
              ("spx_2", "BasicConvIN_0", "ConvTranspose_0", "kernel"):
                  (4, 4, 24, 32),
              ("spx_2", "BasicConvIN_1", "Conv_0", "kernel"): (3, 3, 64, 64),
              ("spx", "kernel"): (4, 4, 64, 9), ("spx", "bias"): (9,)}
    tree: dict = {}
    for path, shape in shapes.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = rng.randn(*shape).astype(np.float32)
    return tree


@pytest.mark.parametrize("heads", ["carried", "filled"])
def test_state_dict_round_trips_through_jax_importer(variables, heads):
    v = dict(variables)
    if heads == "carried":
        v["params"] = {**variables["params"], **_train_heads(14)}
    sd = from_jax_variables(NAME, v)
    if heads == "filled":
        assert all(not sd[k].any() and tuple(sd[k].shape) == shape
                   for k, shape in IGEV_TRAIN_HEADS.items())
    m = create_model(NAME, device="cpu")
    m.load_state_dict(sd)
    back = import_torch_checkpoint(
        NAME, {k: t.numpy() for k, t in m.state_dict().items()})
    want = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    heads_only = set(got) - set(want)
    assert all(str(p[1].key).startswith("spx") and "step" not in str(p)
               for p in heads_only) and (heads == "filled") == bool(
                   heads_only)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a)


def test_port_state_dict_has_original_torch_names():
    keys = set(create_model(NAME, device="cpu").state_dict())
    for k in ("feature.conv_stem.weight", "feature.bn1.running_var",
              "feature.block0.0.0.conv_dw.weight",
              "feature.block0.0.0.bn2.bias",
              "feature.block1.0.1.conv_pwl.weight",
              "feature.block3.0.3.bn3.running_mean",
              "feature.block3.1.2.conv_dw.weight",
              "feature.block4.0.2.conv_pw.weight",
              "feature.deconv32_16.conv1.conv.weight",
              "feature.deconv8_4.conv2.conv.weight",
              "feature.conv4.conv.weight", "stem_2.0.conv.weight",
              "stem_2.1.weight", "stem_4.1.weight", "conv.conv.weight",
              "desc.bias", "corr_stem.conv.weight", "corr_stem.bn.weight",
              "corr_feature_att.feat_att.0.conv.weight",
              "corr_feature_att.feat_att.0.bn.running_var",
              "corr_feature_att.feat_att.1.bias",
              "cost_agg.conv1.0.conv.weight", "cost_agg.conv3.1.bn.bias",
              "cost_agg.conv3_up.conv.weight", "cost_agg.agg_0.2.bn.weight",
              "cost_agg.conv1_up.conv.weight",
              "cost_agg.feature_att_up_8.feat_att.1.weight",
              "classifier.weight", "cnet.outputs04.0.1.weight",
              "cnet.outputs08.1.0.norm2.running_mean",
              "cnet.outputs16.1.weight", "context_zqr_convs.0.bias",
              "update_block.gru04.convz.weight",
              "update_block.gru16.convq.bias",
              "update_block.encoder.convd1.weight",
              "update_block.disp_head.conv2.weight",
              "update_block.mask_feat_4.0.weight",
              "spx_2_gru.conv1.conv.weight", "spx_2_gru.conv2.bn.bias",
              "spx_gru.0.weight", "spx_gru.0.bias", "spx_4.0.conv.weight",
              "spx_4.1.weight", "spx_2.conv1.conv.weight",
              "spx_2.conv2.conv.weight", "spx.0.bias"):
        assert k in keys, k
    assert "cost_agg.conv1_up.bn.weight" not in keys
    assert not any(".norm3." in k for k in keys)


# ------------------------------------------------------------- entry point
def test_create_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(NAME)


def test_train_mode_is_not_implemented():
    m = create_model(NAME, device="cpu").train()
    x = torch.zeros(1, 64, 64, 3)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        m(x, x)


def test_eval_entry_point_runs_the_model(tmp_path):
    """``python -m stereo_toolbox_tpu_torch.eval`` with this model on the
    CPU: SceneFlow's suite over one 40×56 frame (padded to 96×96)."""
    roots = write_eval_trees(str(tmp_path), frames=1,
                             sizes={"sceneflow": (40, 56)}, max_disp=32,
                             datasets=("sceneflow",))
    got = port_eval.main(["--device", "cpu", "--model", NAME,
                          "--max-disp", "32",
                          "--suite", "sceneflow", "--root",
                          roots["sceneflow"], "--lists", roots["lists"]])
    assert got.shape == (4,) and np.isfinite(got).all()
