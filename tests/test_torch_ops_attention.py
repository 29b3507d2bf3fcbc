"""The port's ViT attention (`ops.attention`) against the JAX package.

`attention_reference` is held against flax's ``dot_product_attention`` (the
JAX package's route off the TPU and for N < 1024) and against the JAX
package's TPU route itself: the library Pallas ``flash_attention``, reached
through ``_vit_attention_fn`` with ``jax.default_backend`` reporting
``"tpu"`` and run in Pallas's TPU interpret mode on the CPU (N padded to a
multiple of 1024 and masked with segment ids). Inputs come from a numpy
seed; the port runs its plain path on the CPU.

`attention_tf32x3_reference` (the float32 kernel's 3xTF32 arithmetic) is
held at DepthAnythingV2's launch (N 1370, scale 1/8, a few heads) and at
logits of ~±30 (scale 1): the split's own error (its products summed in
float64) is at least 5x inside the kernel's 1e-5 · max|ref| gate against
the float64 attention, one TF32 product (hi·hi) is outside it, and the
float32 emulation holds the gate against the float32 plain version and the
JAX package's Pallas flash route.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stereo_toolbox_tpu.models import depth_anything_v2 as jax_dav2
from stereo_toolbox_tpu_torch.ops.attention import (
    attention, attention_reference, attention_tf32x3_reference)
from stereo_toolbox_tpu_torch.utils.precision import tf32_split

torch.set_num_threads(2)


def _qkv(b, n, heads, d, seed):
    """q, k, v in flax's layout ``[B, N, heads, d]``."""
    rng = np.random.RandomState(seed)
    return [rng.randn(b, n, heads, d).astype(np.float32) for _ in range(3)]


def _port(q, k, v):
    """The port's plain attention on flax-layout numpy inputs, back in
    flax's layout."""
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    out = attention_reference(tq, tk, tv, q.shape[-1] ** -0.5)
    return out.transpose(1, 2).numpy()


@pytest.mark.parametrize("b,n,heads,d", [(1, 1, 2, 64), (2, 77, 3, 64),
                                         (1, 300, 2, 32)])
def test_attention_reference_matches_flax(b, n, heads, d):
    q, k, v = _qkv(b, n, heads, d, seed=n)
    want = np.asarray(fnn.dot_product_attention(q, k, v))
    got = _port(q, k, v)
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_attention_reference_matches_pallas_flash_route(monkeypatch):
    """N = 1100 ≥ 1024 takes the TPU route: padded to 2048, segment ids."""
    q, k, v = _qkv(1, 1100, 2, 64, seed=3)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_dav2._vit_attention_fn(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = _port(q, k, v)
    err = np.abs(got - want).max()
    print(f"attention_reference vs Pallas flash (interpret): max|d| "
          f"{err:.3e}, max|ref| {np.abs(want).max():.3e}")
    assert err <= 1e-5 * np.abs(want).max(), err


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 77, 64, generator=gen) for _ in range(3))
    before = attention.launches, sum(attention.shapes.values())
    got = attention(q, k, v, 0.125)
    assert torch.equal(got, attention_reference(q, k, v, 0.125))
    assert (attention.launches, sum(attention.shapes.values())) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_on_cpu_counts_no_design(dtype):
    """bfloat16 too: a CPU tensor takes the plain version and counts no
    launch by design (the card's "mma" and "tf32x3" kernels)."""
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 2, 65, 64, generator=gen).to(dtype)
               for _ in range(3))
    before = dict(attention.designs)
    got = attention(q, k, v, 0.125)
    assert got.dtype == dtype
    assert torch.equal(got, attention_reference(q, k, v, 0.125))
    assert dict(attention.designs) == before


def test_attention_reference_keeps_the_dtype_and_softmaxes_in_float32():
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 2, 33, 64, generator=gen) for _ in range(3))
    got = attention_reference(q.bfloat16(), k.bfloat16(), v.bfloat16(), 0.125)
    assert got.dtype == torch.bfloat16
    want = attention_reference(q.bfloat16().float(), k.bfloat16().float(),
                               v.bfloat16().float(), 0.125)
    assert torch.equal(got, want.bfloat16())


# (b, n, heads, scale): DepthAnythingV2-vitl's launch cut to 2 heads, its N
# one past a 1024 multiple, and logits of ~±30 at scale 1 (N 200, 65)
TF32_CASES = [(1, 1370, 2, 0.125), (1, 1025, 2, 0.125), (1, 200, 2, 1.0),
              (2, 65, 3, 1.0)]


def _torch_qkv(b, n, heads, seed):
    """q, k, v ``[B, heads, N, 64]`` float32 from a numpy seed."""
    return [torch.from_numpy(a).transpose(1, 2).contiguous()
            for a in _qkv(b, n, heads, 64, seed)]


def _attention_f64(q, k, v, scale):
    s = q.double() @ k.double().transpose(-1, -2) * scale
    return torch.softmax(s, dim=-1) @ v.double()


def _split_attention_f64(q, k, v, scale, terms):
    """Attention whose two products take the TF32 split operands (3xTF32,
    or hi·hi alone for terms 1), every sum in float64: the error of the
    split alone, without float32's rounding."""
    def product(a, b):
        (ah, al), (bh, bl) = tf32_split(a), tf32_split(b)
        ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
        hh = ah @ bh
        return hh + al @ bh + ah @ bl if terms == 3 else hh

    s = product(q, k.transpose(-1, -2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return product(p.float(), v) / p.sum(dim=-1, keepdim=True)


@pytest.mark.parametrize("b,n,heads,scale", TF32_CASES)
def test_tf32x3_is_inside_the_float32_gate_and_one_tf32_product_is_not(
        b, n, heads, scale):
    """3xTF32's own error ≤ 1e-5 / 5 of max|ref| against the float64
    attention; one TF32 product's > 1e-5."""
    q, k, v = _torch_qkv(b, n, heads, seed=n)
    want = _attention_f64(q, k, v, scale)
    ref = want.abs().max().item()
    err3 = (_split_attention_f64(q, k, v, scale, 3) - want).abs().max()
    err1 = (_split_attention_f64(q, k, v, scale, 1) - want).abs().max()
    print(f"K7 N {n} scale {scale}: 3xTF32 {err3 / ref:.2e}, 1xTF32 "
          f"{err1 / ref:.2e} of max|ref|")
    assert err3 <= 1e-5 / 5 * ref
    assert err1 > 1e-5 * ref


@pytest.mark.parametrize("b,n,heads,scale", TF32_CASES)
def test_tf32x3_reference_holds_the_gate_against_the_plain_version(
        b, n, heads, scale):
    """The float32 kernel's arithmetic against the float32 plain version,
    within 1e-5 · max|ref| (at scale 1 most of the difference is float32's
    own rounding of logits near ±30, in both), and one TF32 product
    outside it."""
    q, k, v = _torch_qkv(b, n, heads, seed=n + 1)
    want = attention_reference(q, k, v, scale)
    ref = want.abs().max().item()
    got = attention_tf32x3_reference(q, k, v, scale)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-5 * ref
    one = attention_tf32x3_reference(q, k, v, scale, terms=1)
    assert (one - want).abs().max().item() > 1e-5 * ref


def test_tf32x3_reference_matches_pallas_flash_route(monkeypatch):
    """The float32 kernel's arithmetic against the JAX package's TPU route
    (N = 1100: padded to 2048, segment ids), within the kernel's gate."""
    q, k, v = _qkv(1, 1100, 2, 64, seed=4)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_dav2._vit_attention_fn(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = attention_tf32x3_reference(tq, tk, tv, 64 ** -0.5).transpose(
        1, 2).numpy()
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err
