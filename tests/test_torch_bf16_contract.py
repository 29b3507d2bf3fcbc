"""What a bfloat16 model keeps in float32, against the JAX package's bf16.

In flax a raw ``self.param`` is float32, and JAX's type promotion keeps the
arithmetic with it in float32: DepthAnythingV2's token stream (``x +
pos_embed``, ``x + h * ls``) and CFNet's search ranges (``gamma_s*``,
``beta_s*``) are float32 in ``dtype=jnp.bfloat16``, and
``nn.LayerNorm(dtype=jnp.bfloat16)`` normalises in float32 with float32
scale and bias and rounds once. ``create_model(..., dtype=torch.bfloat16)``
keeps the same values in float32 (``models.keeps_float32``); these tests
hold one LayerNorm, one ViT block and the tiny DepthAnythingV2 of
``tests/test_torch_depth_anything_v2.py`` against JAX bf16 on the CPU, and
CFNet's params against rounding.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_depth_anything_v2 as dav2_fixture
from stereo_toolbox_tpu.models import depth_anything_v2 as jax_dav2
from stereo_toolbox_tpu_torch.models import cast_model, create_model
from stereo_toolbox_tpu_torch.nn.vit import Block
from stereo_toolbox_tpu_torch.utils.weights import (JaxToTorch,
                                                    from_jax_variables)

torch.set_num_threads(2)

BF16 = torch.bfloat16


def _bf16_bits(a) -> np.ndarray:
    """The bfloat16 bit patterns of `a` (a bf16 tensor, or an array whose
    values are bfloat16) as int32, ordered like the values."""
    t = torch.as_tensor(np.asarray(a, np.float32)).to(BF16) \
        if not isinstance(a, torch.Tensor) else a
    bits = t.view(torch.int16).numpy().astype(np.int32)
    # sign-magnitude → a monotone integer line, so |Δ| counts ulps
    return np.where(bits < 0, -32768 - bits, bits)


def _port_block(dim, heads, variables) -> Block:
    """A bfloat16 port `Block` carrying flax ``ViTBlock`` `variables`."""
    t = JaxToTorch({"params": variables})
    t.layernorm("LayerNorm_0", "norm1")
    t.attention("MultiHeadDotProductAttention_0", "attn")
    t.raw("ls1", "ls1.gamma")
    t.layernorm("LayerNorm_1", "norm2")
    t.dense("Dense_0", "mlp.fc1")
    t.dense("Dense_1", "mlp.fc2")
    t.raw("ls2", "ls2.gamma")
    block = cast_model(Block(dim, heads).eval(), BF16)
    block.load_state_dict(t.state_dict())
    return block


def _block_variables(dim, heads, rng):
    """flax ``ViTBlock`` variables with LayerNorm scales and biases and
    LayerScales away from their initial values (none representable in
    bfloat16)."""
    model = jax_dav2.ViTBlock(dim, heads, dtype=jnp.bfloat16)
    v = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, dim)))["params"]
    v = jax.tree_util.tree_map(np.array, v)
    for name in ("LayerNorm_0", "LayerNorm_1"):
        v[name]["scale"] = (1 + 0.3 * rng.randn(dim)).astype(np.float32)
        v[name]["bias"] = (0.3 * rng.randn(dim)).astype(np.float32)
    for name in ("ls1", "ls2"):
        v[name] = (0.5 + 0.3 * rng.randn(dim)).astype(np.float32)
    return model, v


def test_layer_norm_rounds_once_like_flax():
    """The LayerNorm a bf16 block feeds its attention, at ViT-L's width
    1024, against flax ``LayerNorm(dtype=bfloat16)`` on the same float32
    stream: at most 1 bf16 ulp anywhere, and under 0.1% of the elements
    differing. (A bfloat16 input with bfloat16 weights, the port's LayerNorm
    before, differs in 39.9% of these elements on the CPU.)"""
    dim, heads = 1024, 16
    rng = np.random.RandomState(0)
    _, v = _block_variables(dim, heads, rng)
    block = _port_block(dim, heads, v)
    assert block.norm1.weight.dtype == torch.float32
    x = (3 * rng.randn(2, 257, dim) + rng.randn(dim)).astype(np.float32)
    fed = []
    block.attn.register_forward_pre_hook(lambda m, a: fed.append(a[0]))
    with torch.no_grad():
        block(torch.from_numpy(x))
    got = fed[0]
    assert got.dtype == BF16
    ln = v["LayerNorm_0"]
    want = fnn.LayerNorm(dtype=jnp.bfloat16).apply(
        {"params": ln}, jnp.asarray(x))
    assert want.dtype == jnp.bfloat16
    ulps = np.abs(_bf16_bits(got) - _bf16_bits(want))
    print(f"LayerNorm bf16: {100 * (ulps > 0).mean():.4f}% of elements "
          f"differ, max {ulps.max()} ulp")
    assert ulps.max() <= 1
    assert (ulps > 0).mean() < 1e-3


def test_vit_block_matches_jax_bfloat16():
    """One block of a bf16 model against ``ViTBlock(dtype=bfloat16)`` on the
    same float32 stream: the output is float32, as JAX's, within 5e-3 ·
    max|ref| at most and 5e-4 · max|ref| on average (the branches compute
    in bfloat16 in both, with roundings in other places; measured on the
    CPU: max 1.8e-3, mean 1.5e-4 · max|ref|, printed below)."""
    dim, heads = 256, 4
    rng = np.random.RandomState(1)
    model, v = _block_variables(dim, heads, rng)
    block = _port_block(dim, heads, v)
    x = (2 * rng.randn(2, 50, dim)).astype(np.float32)
    want = model.apply({"params": v}, jnp.asarray(x))
    assert want.dtype == jnp.float32
    with torch.no_grad():
        got = block(torch.from_numpy(x))
    assert got.dtype == torch.float32
    d = np.abs(got.numpy() - np.asarray(want))
    scale = np.abs(np.asarray(want)).max()
    print(f"ViT block bf16 vs JAX bf16: max |d| {d.max():.3e}, mean "
          f"{d.mean():.3e}, max|ref| {scale:.3e}")
    assert d.max() <= 5e-3 * scale
    assert d.mean() <= 5e-4 * scale


@pytest.fixture(scope="module")
def carried_tiny():
    """The tiny encoder's 70x84 case of ``test_torch_depth_anything_v2``,
    with the JAX bf16 forward of the same variables."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_dav2.VIT_CONFIGS, "tiny", dav2_fixture.TINY)
        mp.setitem(dav2_fixture.port_dav2.VIT_CONFIGS, "tiny",
                   dav2_fixture.TINY)
        v, x, depth, _ = dav2_fixture._jax_run(1, 70, 84, True, seed=0)
        model = jax_dav2.DepthAnythingV2(
            encoder="tiny", features=dav2_fixture.FEATURES,
            dtype=jnp.bfloat16)
        bf16 = np.asarray(jax.jit(model.apply)(v, jnp.asarray(x)),
                          np.float32)
        yield v, x, depth, bf16


def test_tiny_depth_anything_v2_bfloat16_matches_jax_bfloat16(carried_tiny):
    """The tiny DepthAnythingV2 in bf16 against JAX ``dtype=bfloat16`` on
    the same variables, 70x84. Measured on the CPU (printed below): mean
    |Δ| 0.0046, max 0.029 with the float32 stream; a bfloat16 stream with
    bfloat16 LayerNorms gave 0.0059, max 0.039; JAX bf16 against JAX f32
    differs by 0.0046, the size of bf16 noise here. Bound: mean |Δ| <
    0.005, which the bfloat16 stream fails."""
    v, x, f32, want = carried_tiny
    m = create_model("DepthAnythingV2", encoder="tiny",
                     features=dav2_fixture.FEATURES, device="cpu",
                     dtype=BF16)
    m.load_state_dict(from_jax_variables("DepthAnythingV2", v))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.dtype == BF16 and got.shape == want.shape
    d = np.abs(got.float().numpy() - want)
    print(f"tiny DepthAnythingV2 bf16 vs JAX bf16: mean |d| {d.mean():.4f}, "
          f"max {d.max():.4f}; JAX bf16 vs JAX f32: mean |d| "
          f"{np.abs(want - f32).mean():.4f}")
    assert d.mean() < 0.005


def test_cfnet_bfloat16_keeps_its_search_range_params_in_float32():
    """``gamma_s*``/``beta_s*`` stay float32 in a bf16 CFNet, and a value
    that bfloat16 cannot hold comes through ``load_state_dict`` exact."""
    m = create_model("CFNet", max_disp=64, device="cpu", dtype=BF16)
    names = ("gamma_s3", "beta_s3", "gamma_s2", "beta_s2")
    sd = m.state_dict()
    value = 1 + 2 ** -12                 # rounds to 1.0 in bfloat16
    for i, name in enumerate(names):
        sd[name] = torch.tensor([value * (i + 1)])
    m.load_state_dict(sd)
    for i, name in enumerate(names):
        p = getattr(m, name)
        assert p.dtype == torch.float32
        assert p.item() == np.float32(value * (i + 1))
    assert m.classif2[0][0].weight.dtype == BF16
