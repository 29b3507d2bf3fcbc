"""PCWNet_G and PCWNet_GC in the PyTorch port against the JAX package.

JAX variables are initialised with every head (``train=True``; PCWNet_G's
cut from PCWNet_GC's, one ``init`` compile for both), their
BatchNorm statistics settled on one train-mode pass and perturbed, carried
into the port with ``utils.weights.from_jax_variables``, and both eval
forwards run on the same numpy inputs on the CPU (the port's plain paths),
at 64×128 with max_disp 64: volumes of D 16 / 8 / 4 / 2, the smallest size
at which ``HourglassUp3``'s three stride-2 steps meet v2, v3 and v4.

The refinement warp thresholds a sampled mask of ones at 0.999, which a
float difference can flip at a near-tie pixel. The comparison counts the
pixels where JAX's mask and the port's differ (each computed from its own
``pred3``) and states that count beside the output bounds; ``pred3`` and
``classif3``'s costs, before the mask, are held tightly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu import ops as jops
from stereo_toolbox_tpu.models import pcwnet as jax_pcwnet
from stereo_toolbox_tpu.ops import sampling as jax_sampling
from stereo_toolbox_tpu.utils.torch_import import import_torch_checkpoint
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.models.pcwnet import (DilatedBlock,
                                                    HourglassUp3, regress,
                                                    signed_correlation_volume,
                                                    warp_coords, warp_mask)
from stereo_toolbox_tpu_torch.ops.sampling import (bilinear_sampler,
                                                   coords_grid)
from stereo_toolbox_tpu_torch.utils import weights
from stereo_toolbox_tpu_torch.utils.weights import (JaxToTorch,
                                                    from_jax_variables)

torch.set_num_threads(2)

H, W, MAX_DISP = 64, 128, 64
VARIANTS = ("PCWNet_G", "PCWNet_GC")


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


def _jax_pred3(cost):
    """JAX's regression of ``classif3``'s costs ``[B, D, H/4, W/4]``."""
    full = jops.interpolate(jnp.asarray(cost, jnp.float32),
                            (MAX_DISP, H, W), (1, 2, 3), align_corners=True)
    return np.asarray(jops.disparity_regression(jax.nn.softmax(full, 1),
                                                MAX_DISP))


def _jax_mask(pred3):
    """JAX's warp mask (``pcwnet.py``'s refinement) at `pred3`."""
    grid = jax_sampling.coords_grid(1, H, W)
    coords = jnp.stack([(grid[..., 0] - pred3) * (W / (W - 1.0)) - 0.5,
                        grid[..., 1] * (H / (H - 1.0)) - 0.5], axis=-1)
    ones = jnp.ones((1, H, W, 1), jnp.float32)
    return np.asarray(jax_sampling.bilinear_sampler(ones, coords)[..., 0]
                      >= 0.999)


# the kernels whose input holds a volume: [c, v] with v = [gwc 40, concat 24]
# in PCWNet_GC; PCWNet_G's take the first c + 40 input channels
VOLUME_INPUTS = {("ConvBNAct_0", "Conv_0"): 0,
                 ("combine1", "combine1", "Conv_0"): 64,
                 ("combine1", "combine2", "Conv_0"): 128,
                 ("combine1", "combine3", "Conv_0"): 128}


def _g_from_gc(variables, g_shapes):
    """PCWNet_G's variables from PCWNet_GC's ``init``: the same tree (JAX's
    PCWFeature builds the concat heads in both) but for the volume inputs
    (`VOLUME_INPUTS`), cut to the gwc channels; checked against G's own
    shapes. One ``init`` compile for both variants."""
    params = jax.tree_util.tree_map(np.copy, variables["params"])
    for path, c in VOLUME_INPUTS.items():
        node = params
        for key in path:
            node = node[key]
        node["kernel"] = node["kernel"][..., :c + 40, :]
    v = {"params": params, "batch_stats": variables["batch_stats"]}
    assert (jax.tree_util.tree_map(np.shape, v)
            == jax.tree_util.tree_map(lambda a: a.shape, g_shapes))
    return v


@pytest.fixture(scope="module")
def jax_runs():
    """Per variant: settled, perturbed JAX variables, the inputs, JAX's
    eval output and ``classif3``'s costs. The variables come from
    PCWNet_GC's ``init(train=True)``, PCWNet_G's cut from them
    (`_g_from_gc`)."""
    rng = np.random.RandomState(0)
    left = rng.randn(1, H, W, 3).astype(np.float32)
    right = np.roll(left, -3, axis=2) + 0.05 * rng.randn(1, H, W, 3).astype(
        np.float32)
    x = jnp.asarray(left)
    gc = jax_pcwnet.PCWNet_GC(max_disp=MAX_DISP)
    gc_init = jax.tree_util.tree_map(np.asarray, jax.jit(
        gc.init, static_argnames="train")(jax.random.PRNGKey(0), x, x,
                                          train=True))
    runs = {}
    for name in VARIANTS:
        model = getattr(jax_pcwnet, name)(max_disp=MAX_DISP)
        v = gc_init if name == "PCWNet_GC" else _g_from_gc(
            gc_init, jax.eval_shape(lambda: model.init(
                jax.random.PRNGKey(0), x, x, train=True)))
        v = {"params": v["params"],
             "batch_stats": _settled_stats(model, v, x)}
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: a + 0.1 * np.abs(rng.randn(*a.shape)).astype(a.dtype),
            v["batch_stats"])
        pred, state = jax.jit(lambda vv, a, b: model.apply(
            vv, a, b, train=False, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name == "classif3_out"))(
                v, x, jnp.asarray(right))
        cost = np.asarray(
            state["intermediates"]["classif3_out"]["__call__"][0])[..., 0]
        runs[name] = (v, np.asarray(pred), cost)
    return left, right, runs


def _port(name, variables, dtype=torch.float32):
    m = create_model(name, max_disp=MAX_DISP, device="cpu", dtype=dtype)
    m.load_state_dict(from_jax_variables(name, variables))
    return m


def _run_with_costs(m, left, right):
    costs = []
    hook = m.classif3[1].register_forward_hook(
        lambda mod, inp, out: costs.append(out[..., 0].float()))
    with torch.no_grad():
        got = m(torch.from_numpy(left), torch.from_numpy(right))
    hook.remove()
    return got.float().numpy(), costs[0]


@pytest.mark.parametrize("name", VARIANTS)
def test_pcwnet_matches_jax(jax_runs, name):
    """``classif3``'s costs within 1e-4 × max|ref|, ``pred3`` within 1e-4
    px, and the output within mean < 5e-3 and max < 0.1 px (the bounds of
    the JAX package's own cross-framework PCWNet test), with the count of
    pixels whose warp mask flipped between the two beside it."""
    left, right, runs = jax_runs
    v, want, want_cost = runs[name]
    got, cost = _run_with_costs(_port(name, v), left, right)
    err = np.abs(cost.numpy() - want_cost).max()
    ref = np.abs(want_cost).max()
    want_pred3 = _jax_pred3(want_cost)
    pred3 = regress(cost, MAX_DISP, H, W)
    pred3_err = np.abs(pred3.numpy() - want_pred3).max()
    flipped = int((warp_mask(warp_coords(pred3)).numpy()
                   != _jax_mask(want_pred3)).sum())
    d = np.abs(got - want)
    print(f"{name} port vs JAX: classif3 max|d| {err:.3e} (max|ref| "
          f"{ref:.3e}); pred3 max|d| {pred3_err:.3e} px; warp mask flipped "
          f"at {flipped} of {H * W} pixels; output mean {d.mean():.3e}, "
          f"max {d.max():.3e} px")
    assert got.shape == want.shape == (1, H, W)
    assert err <= 1e-4 * ref
    assert pred3_err <= 1e-4
    assert flipped == 0
    assert d.mean() < 5e-3
    assert d.max() < 0.1


def test_pcwnet_gc_bfloat16_matches_jax_bfloat16(jax_runs):
    """Port bf16 against JAX ``PCWNet_GC(dtype=jnp.bfloat16)`` on the same
    variables, held by ``classif3``'s costs (before the soft argmax, whose
    near-ties turn one-ulp differences into jumps): the port's bf16 costs
    no further from the float32 costs than 1.5x JAX's bf16 costs are, and
    within 2x that distance of JAX's bf16 costs (two bf16 forwards that
    round the same float32 arithmetic at every layer, each its own way).
    Measured on the CPU: from the f32 costs port 1.31e-2, JAX 1.34e-2;
    port vs JAX 1.95e-2 (max|ref| 1.02); output mean |d| 0.097 px."""
    left, right, runs = jax_runs
    v, _, f32_cost = runs["PCWNet_GC"]
    model = jax_pcwnet.PCWNet_GC(max_disp=MAX_DISP, dtype=jnp.bfloat16)
    pred, state = jax.jit(lambda vv, a, b: model.apply(
        vv, a, b, train=False, mutable=["intermediates"],
        capture_intermediates=lambda mdl, _: mdl.name == "classif3_out"))(
            v, jnp.asarray(left), jnp.asarray(right))
    want_cost = np.asarray(
        state["intermediates"]["classif3_out"]["__call__"][0][..., 0],
        np.float32)
    got, cost = _run_with_costs(_port("PCWNet_GC", v, torch.bfloat16), left,
                                right)
    err = np.abs(cost.numpy() - want_cost).max()
    port_f32 = np.abs(cost.numpy() - f32_cost).max()
    jax_f32 = np.abs(want_cost - f32_cost).max()
    d = np.abs(got - np.asarray(pred, np.float32))
    print(f"PCWNet_GC bf16 port vs JAX bf16: classif3 max|d| {err:.3e} "
          f"(max|ref| {np.abs(want_cost).max():.3e}); from the f32 costs: "
          f"port {port_f32:.3e}, JAX {jax_f32:.3e}; output mean |d| "
          f"{d.mean():.4f} px, max {d.max():.4f} px")
    assert got.shape == (1, H, W) and np.isfinite(got).all()
    assert port_f32 <= 1.5 * jax_f32
    assert err <= 2 * jax_f32


def test_sampling_ops_match_jax():
    """`coords_grid` exactly, and `bilinear_sampler` (with its mask) within
    1e-6 at integer, fractional and off-image positions."""
    rng = np.random.RandomState(1)
    img = rng.randn(2, 7, 9, 5).astype(np.float32)
    coords = np.stack([rng.uniform(-2.5, 10.5, (2, 6, 11)),
                       rng.uniform(-2.5, 8.5, (2, 6, 11))], -1).astype(
                           np.float32)
    coords[0, 0, :4] = [[0, 0], [8, 6], [3, 2], [-1, 3]]   # on the grid, off
    coords[0, 1, :3] = [[8.5, 2], [2, -0.5], [4.25, 6.75]]  # half off
    np.testing.assert_array_equal(
        coords_grid(2, 7, 9).numpy(),
        np.asarray(jax_sampling.coords_grid(2, 7, 9)))
    got, got_mask = bilinear_sampler(torch.from_numpy(img),
                                     torch.from_numpy(coords),
                                     return_mask=True)
    want, want_mask = jax_sampling.bilinear_sampler(
        jnp.asarray(img), jnp.asarray(coords), return_mask=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert got_mask.numpy().any() and not got_mask.numpy().all()
    # x = -1 weights only the column left of the image; x = 8.5 reads half
    # of the last column and half of the zero past it
    assert not got[0, 0, 3].any()
    np.testing.assert_allclose(got[0, 1, 0].numpy(), 0.5 * img[0, 2, 8],
                               rtol=1e-6)


def test_signed_correlation_volume_matches_jax_and_its_slice():
    """Radius 24 on W 64 (> 48), against JAX; and the original's slice at
    negative offsets on both sides: ``off = −k`` correlates the first k
    left columns with the last k right ones, and zeros the rest."""
    rng = np.random.RandomState(2)
    left = rng.randn(1, 3, 64, 6).astype(np.float32)
    right = rng.randn(1, 3, 64, 6).astype(np.float32)
    got = signed_correlation_volume(torch.from_numpy(left),
                                    torch.from_numpy(right), 24).numpy()
    want = np.asarray(jax.jit(jax_pcwnet.signed_correlation_volume,
                              static_argnums=2)(jnp.asarray(left),
                                                jnp.asarray(right), 24))
    assert got.shape == want.shape == (1, 3, 64, 49)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for out in (got, want):
        for k in (1, 7, 24):
            neg = out[..., 24 - k]
            np.testing.assert_allclose(
                neg[..., :k], (left[..., :k, :] * right[..., 64 - k:, :])
                .mean(-1), rtol=0, atol=1e-6)
            assert not neg[..., k:].any()
            pos = out[..., 24 + k]
            np.testing.assert_allclose(
                pos[..., k:], (left[..., k:, :] * right[..., :64 - k, :])
                .mean(-1), rtol=0, atol=1e-6)
            assert not pos[..., :k].any()


def _perturbed(variables, seed):
    """JAX block variables with random BatchNorm statistics."""
    rng = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.randn(*a.shape) if "mean" in jax.tree_util.keystr(p)
                      else 0.5 + rng.rand(*a.shape)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    return {"params": jax.tree_util.tree_map(np.asarray,
                                             variables["params"]),
            "batch_stats": stats}


def test_dilated_block_matches_jax():
    """The dilated Mish block with a 1×1 skip (128 → 96 at dilation 8, as
    in ``refinenet3``) and without (dilation 2, as in ``layer4``)."""
    rng = np.random.RandomState(3)
    for ci, co, dil in ((24, 16, 8), (16, 16, 2)):
        x = rng.randn(1, 20, 24, ci).astype(np.float32)
        block = jax_pcwnet._DilatedBlock(co, dil)
        v = _perturbed(jax.jit(block.init)(jax.random.PRNGKey(ci),
                                           jnp.asarray(x)), ci)
        want = np.asarray(jax.jit(block.apply)(v, jnp.asarray(x)))
        t = JaxToTorch({k: {"b": tree} for k, tree in v.items()})
        weights._res_block(t, "b", "b")
        port = torch.nn.Module()
        port.b = DilatedBlock(ci, co, dil)
        port.load_state_dict(t.state_dict())
        with torch.no_grad():
            got = port.b.eval()(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_hourglass_up3_matches_jax():
    """The three-scale fusing hourglass at c 8 with 10-channel volumes at
    D 16 / 8 / 4 / 2 (the test's model sizes), against JAX's
    ``HourglassUp3`` carried by the converter's own map."""
    rng = np.random.RandomState(4)
    c, vc = 8, 10
    shapes = [(1, 16, 8, 16, c)] + [(1, 16 >> s, 8 >> s, 16 >> s, vc)
                                    for s in (1, 2, 3)]
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    hu = jax_pcwnet.HourglassUp3(c)
    v = _perturbed(jax.jit(hu.init)(jax.random.PRNGKey(5),
                                    *map(jnp.asarray, xs)), 5)
    want = np.asarray(jax.jit(hu.apply)(v, *map(jnp.asarray, xs)))
    t = JaxToTorch({k: {"hu": tree} for k, tree in v.items()})
    weights._hourglass_up3(t, "hu", "hu")
    port = torch.nn.Module()
    port.hu = HourglassUp3(c, vc)
    port.load_state_dict(t.state_dict())
    with torch.no_grad():
        got = port.hu.eval()(*map(torch.from_numpy, xs)).numpy()
    assert got.shape == want.shape == shapes[0]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", VARIANTS)
def test_state_dict_round_trips_through_jax_importer(jax_runs, name):
    v = jax_runs[2][name][0]
    m = _port(name, v)
    sd = {k: t.numpy() for k, t in m.state_dict().items()}
    back = import_torch_checkpoint(name, sd)  # raises on leftovers
    want = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a)


@pytest.mark.parametrize("name", VARIANTS)
def test_port_state_dict_has_original_torch_names(name):
    m = create_model(name, max_disp=MAX_DISP, device="cpu")
    keys = set(m.state_dict())
    for k in ("feature_extraction.firstconv.4.1.running_var",
              "feature_extraction.layer1.2.conv2.0.weight",
              "feature_extraction.layer2.0.downsample.1.bias",
              "feature_extraction.layer4.2.conv1.0.0.weight",
              "feature_extraction.layer9.0.downsample.0.weight",
              "feature_extraction.layer11.2.weight",
              "feature_extraction.gw4.0.1.running_mean",
              "feature_extraction.layer_refine.2.0.weight",
              "dres0.0.0.weight", "dres1.2.1.bias",
              "combine1.conv1.weight", "combine1.conv5.weight",
              "combine1.combine3.0.0.weight", "combine1.conv6.0.1.bias",
              "combine1.conv7.0.weight", "combine1.redir3.1.running_var",
              "dres4.conv5.0.weight", "classif0.2.weight",
              "classif4.0.1.weight", "dispupsample.0.0.weight",
              "refinenet3.conv1.0.0.weight", "refinenet3.conv4.0.1.bias",
              "refinenet3.conv7.0.downsample.1.running_mean",
              "refinenet3.conv8.weight"):
        assert k in keys, k
    # the concat heads in both variants, as JAX's PCWFeature builds them
    assert {"feature_extraction.lastconv.2.weight",
            "feature_extraction.concat4.0.0.weight"} <= keys
    assert not any(k.startswith("feature_extraction.layer6") for k in keys)


def test_create_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in VARIANTS:
        with pytest.raises(RuntimeError, match="CUDA"):
            create_model(name)


def test_train_mode_is_not_implemented():
    m = create_model("PCWNet_GC", max_disp=MAX_DISP, device="cpu").train()
    x = torch.zeros(1, H, W, 3)
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        m(x, x)
