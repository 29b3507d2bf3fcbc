"""DepthAnythingV2 in the PyTorch port against the JAX package.

A tiny encoder (embed 128, depth 4, 2 heads of 64, taps 0-3, out channels
16/32/64/64, features 32) is registered in both packages' ``VIT_CONFIGS``.
JAX variables are initialised, every LayerNorm, LayerScale and bias
perturbed and the tap norms made equal, carried into the port with
``utils.weights.from_jax_variables``, and both eval forwards run on the same
numpy image on the CPU (the port's plain paths): depth, the pre-ReLU
``out``, ``path_1`` and the four decoder ``paths`` are compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stereo_toolbox_tpu.models import depth_anything_v2 as jax_dav2
from stereo_toolbox_tpu.utils import torch_import
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.models import depth_anything_v2 as port_dav2
from stereo_toolbox_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

TINY = dict(embed_dim=128, depth=4, num_heads=2, taps=(0, 1, 2, 3),
            out_channels=(16, 32, 64, 64))
FEATURES = 32
REL_TOL = 1e-4          # max|Δ| as a share of max|ref|


@pytest.fixture(scope="module")
def tiny():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_dav2.VIT_CONFIGS, "tiny", TINY)
        mp.setitem(port_dav2.VIT_CONFIGS, "tiny", TINY)
        yield


def _perturbed(v, rng):
    """Every LayerNorm scale, LayerScale and bias moved by 0.1·N(0, 1);
    the tap norms then all set to the first one's values."""
    def move(path, a):
        keys = [getattr(p, "key", "") for p in path]
        if keys[-1] in ("bias", "ls1", "ls2") or (
                keys[-1] == "scale" and any("Norm" in k or "tapnorm" in k
                                            for k in keys)):
            return a + 0.1 * rng.randn(*a.shape).astype(a.dtype)
        return a

    v = jax.tree_util.tree_map_with_path(move, v)
    trunk = v["params"]["pretrained"]
    first = trunk[f"tapnorm{TINY['taps'][0]}"]
    for i in TINY["taps"]:
        trunk[f"tapnorm{i}"] = dict(first)
    return v


def _jax_run(b, h, w, align, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, 3).astype(np.float32)
    model = jax_dav2.DepthAnythingV2(encoder="tiny", features=FEATURES,
                                     out_align_corners=align)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    v = _perturbed(jax.tree_util.tree_map(np.array, v), rng)
    apply = jax.jit(lambda vv, a: model.apply(vv, a, return_features=True))
    for _ in range(20):
        depth, feats = apply(v, jnp.asarray(x))
        if (np.asarray(depth) > 0).mean() >= 0.2:
            break
        # degenerate: the last ReLU zeroes most of the random-weight map
        print("degenerate depth: lifting output_conv2b's bias by 0.1")
        v["params"]["depth_head"]["output_conv2b"]["bias"] += 0.1
    return v, x, np.asarray(depth), jax.tree_util.tree_map(np.asarray, feats)


@pytest.fixture(scope="module")
def carried(tiny):
    """The 70x84 case (5x6 grid, pos-embed interpolation on): JAX
    variables, input, outputs."""
    return _jax_run(1, 70, 84, True, seed=0)


def _port_model(v, align=True):
    m = create_model("DepthAnythingV2", encoder="tiny", features=FEATURES,
                     out_align_corners=align, device="cpu")
    m.load_state_dict(from_jax_variables("DepthAnythingV2", v))
    return m


def _compare(v, x, want_depth, want, align):
    m = _port_model(v, align)
    with torch.no_grad():
        depth, feats = m(torch.from_numpy(x), return_features=True)
    pairs = [("depth", depth, want_depth), ("out", feats["out"], want["out"]),
             ("path_1", feats["path_1"], want["path_1"])]
    pairs += [(f"paths[{i}]", g, w_) for i, (g, w_) in
              enumerate(zip(feats["paths"], want["paths"]))]
    for name, got, ref in pairs:
        got = got.numpy()
        assert got.shape == ref.shape, (name, got.shape, ref.shape)
        err, scale = np.abs(got - ref).max(), np.abs(ref).max()
        print(f"{name}: max|d| {err:.3e}, max|ref| {scale:.3e}, "
              f"ratio {err / scale:.2e}")
        assert err <= REL_TOL * scale, name
    assert want_depth.std() > 0 and (want_depth > 0).mean() > 0.05, \
        "degenerate reference depth"


def test_depth_anything_v2_matches_jax(carried):
    v, x, depth, feats = carried
    assert depth.shape == (1, 70, 84)
    _compare(v, x, depth, feats, True)


def test_depth_anything_v2_batch_two_align_corners_false(tiny):
    """28x42 (a 2x3 grid), B = 2, StereoAnywhere's last resize."""
    v, x, depth, feats = _jax_run(2, 28, 42, False, seed=1)
    assert depth.shape == (2, 28, 42)
    _compare(v, x, depth, feats, False)


def test_output_drops_the_patch_remainder(carried):
    v = carried[0]
    m = _port_model(v)
    with torch.no_grad():
        depth = m(torch.zeros(1, 75, 90, 3))
    assert depth.shape == (1, 70, 84)


def test_from_jax_variables_raises_on_unequal_tap_norms(carried):
    v = jax.tree_util.tree_map(np.array, carried[0])
    v["params"]["pretrained"]["tapnorm2"]["bias"] += 1.0
    with pytest.raises(ValueError, match="tap norms"):
        from_jax_variables("DepthAnythingV2", v)


def test_from_jax_variables_raises_on_a_variable_left_unread(carried):
    v = jax.tree_util.tree_map(np.array, carried[0])
    v["params"]["pretrained"]["mask_token"] = np.zeros((1, 128), np.float32)
    with pytest.raises(ValueError, match="not carried"):
        from_jax_variables("DepthAnythingV2", v)


def test_state_dict_round_trips_through_jax_converter(carried, monkeypatch):
    """The port's names are the original's: the JAX package's own importer
    reads the port's state_dict back into the variables it came from."""
    v = carried[0]
    for table, value in ((torch_import._DAV2_HEADS, TINY["num_heads"]),
                         (torch_import._DAV2_DEPTH, TINY["depth"]),
                         (torch_import._DAV2_TAPS, TINY["taps"])):
        monkeypatch.setitem(table, "tiny", value)
    sd = {k: t.numpy() for k, t in _port_model(v).state_dict().items()}
    back, leftovers = torch_import.convert_depth_anything_v2(sd, "tiny")
    assert leftovers == []
    want = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(
        {"params": back["params"]})[0])
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a)


def test_vitl_parameter_count_matches_jax():
    """At full width, without allocating the 1.3 GB of weights: JAX by
    `jax.eval_shape` of init, the port on the meta device."""
    model = jax_dav2.DepthAnythingV2(encoder="vitl")
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 28, 28, 3)))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        port = port_dav2.DepthAnythingV2(encoder="vitl")
    # JAX keeps one LayerNorm per tap (4 x 2 x 1024) where the port has one
    got = sum(p.numel() for p in port.parameters()) + 3 * 2 * 1024
    assert got == want


def test_pos_embed_resize_matches_torch_bicubic(carried):
    """The port's position embedding on a 5x6 grid is DINOv2's own
    ``F.interpolate(mode="bicubic", scale_factor=(g + 0.1) / 37)``."""
    trunk = _port_model(carried[0]).pretrained
    with torch.no_grad():
        got = trunk.position_embedding(5, 6)
        grid = trunk.pos_embed[:, 1:].reshape(1, 37, 37, -1).permute(
            0, 3, 1, 2)
        want = F.interpolate(grid, scale_factor=(5.1 / 37, 6.1 / 37),
                             mode="bicubic", align_corners=False)
    assert want.shape[2:] == (5, 6)
    want = want.permute(0, 2, 3, 1).reshape(1, 30, -1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_create_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model("DepthAnythingV2", encoder="vits")


def test_train_mode_is_not_implemented(tiny):
    m = create_model("DepthAnythingV2", encoder="tiny", features=FEATURES,
                     device="cpu").train()
    with pytest.raises(NotImplementedError):
        m(torch.zeros(1, 28, 28, 3))
