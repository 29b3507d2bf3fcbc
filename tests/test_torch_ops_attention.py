"""The port's ViT attention (`ops.attention`) against the JAX package.

`attention_reference` is held against flax's ``dot_product_attention`` (the
JAX package's route off the TPU and for N < 1024) and against the JAX
package's TPU route itself: the library Pallas ``flash_attention``, reached
through ``_vit_attention_fn`` with ``jax.default_backend`` reporting
``"tpu"`` and run in Pallas's TPU interpret mode on the CPU (N padded to a
multiple of 1024 and masked with segment ids). Inputs come from a numpy
seed; the port runs its plain path on the CPU.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from stereo_toolbox_tpu.models import depth_anything_v2 as jax_dav2
from stereo_toolbox_tpu_torch.ops.attention import (attention,
                                                    attention_reference)

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
    launch by design (the card's "mma" and "simt" kernels)."""
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
