"""K7's backward (K7-bwd) in its plain versions, on the CPU.

`ops.attention` is an ``autograd.Function`` where an input requires grad:
its forward saves each row's log-sum-exp, its backward is K7-bwd on the
card and `attention_backward_reference` on the CPU (the plain dQ, dK, dV
from the saved log-sum-exp; the card's oracle too). On the same numpy
inputs (``[B, heads, N, 64]``, N ∈ {1, 15, 65, 77}: one key, under, one
past and ragged past a 64-row tile):

  * `attention_backward_reference` against autograd of
    `attention_reference`, float32 1e-5 and bfloat16 1e-2 × max|ref| (at
    N = 1 dQ and dK are zero, the softmax of one key being constant: held
    against dV's scale);
  * against the VJP of the JAX library's own plain ``mha_reference``
    (``jax/experimental/pallas/ops/tpu/flash_attention.py:1530``, whose
    custom VJP, ``:1615``, recomputes the weights from the saved
    log-sum-exp as the Pallas backward kernels do) and of
    ``flax.linen.dot_product_attention`` (the attention JAX's ViT takes off
    the TPU), float32, 1e-5 × max|ref|;
  * `attention` on the CPU: the gradients autograd gives through it are
    `attention_backward_reference`'s, with the log-sum-exp
    `attention_with_lse` saves; without grad it is `attention_reference`
    itself;
  * the reference's ``di`` argument (the kernels take di = rowsum(dO ∘ O)
    from the caller) gives the same gradients.
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

A = importlib.import_module("stereo_toolbox_tpu_torch.ops.attention")

NS = [1, 15, 65, 77]
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _inputs(n, seed=0, b=2, heads=3):
    rng = np.random.RandomState(seed + n)
    return [rng.randn(b, heads, n, 64).astype(np.float32) for _ in range(4)]


def _held(got, want, rel, floor=0.0):
    got, want = (np.asarray(torch.as_tensor(x).float()) for x in (got, want))
    ref = max(float(np.abs(want).max()), floor)
    err = float(np.abs(got - want).max())
    assert err <= rel * ref, (err, rel * ref)


def _check(got, want, dtype):
    """dQ, dK, dV each within TOL · max|ref|; dQ and dK against dV's scale
    where their own is zero (N = 1)."""
    floor = float(torch.as_tensor(want[2]).float().abs().max())
    for i, (g, w) in enumerate(zip(got, want)):
        _held(g, w, TOL[dtype], floor * 1e-6 if i == 2 else floor)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_backward_matches_autograd(n, dtype):
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _inputs(n))
    scale = 0.125 if n != 65 else 1.0
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A.attention_reference(*leaves, scale)
    want = torch.autograd.grad(out, leaves, do)
    lse = A.attention_lse_reference(q, k, scale)
    got = A.attention_backward_reference(q, k, v, out.detach(), do, lse,
                                         scale)
    assert all(g.dtype == dtype for g in got)
    _check(got, want, dtype)


@pytest.mark.parametrize("n", NS)
def test_reference_backward_matches_the_jax_library(n):
    """Against the VJPs of the library's ``mha_reference`` and of flax's
    ``dot_product_attention`` (layout ``[B, N, heads, 64]``)."""
    q, k, v, do = _inputs(n, seed=1)
    scale = 0.125
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = A.attention_with_lse(tq, tk, tv, scale)
    got = A.attention_backward_reference(tq, tk, tv, out, tdo, lse, scale)
    # the library's custom VJP takes sm_scale 1 only: the queries come
    # scaled, and JAX's chain rule scales dQ back
    _, vjp = jax.vjp(lambda a, b, c: mha_reference(a * scale, b, c, None),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _check(got, vjp(jnp.asarray(do)), torch.float32)

    def flax_attention(a, b, c):
        # flax scales the queries by 1/sqrt(64), the ViT's scale
        t = (lambda x: jnp.swapaxes(x, 1, 2))
        return t(fnn.dot_product_attention(t(a), t(b), t(c)))
    _, vjp = jax.vjp(flax_attention, jnp.asarray(q), jnp.asarray(k),
                     jnp.asarray(v))
    _check(got, vjp(jnp.asarray(do)), torch.float32)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_function_on_the_cpu(n, dtype):
    q, k, v, do = (torch.from_numpy(x).to(dtype) for x in _inputs(n, 2))
    scale = 0.125
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A.attention(*leaves, scale)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    plain, lse = A.attention_with_lse(q, k, v, scale)
    assert torch.equal(out.detach(), plain)
    assert torch.equal(plain, A.attention_reference(q, k, v, scale))
    want = A.attention_backward_reference(q, k, v, plain, do, lse, scale)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with torch.no_grad():
        assert A.attention(*leaves, scale).grad_fn is None


def test_reference_takes_di_as_the_kernels_do():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(33, 3))
    out, lse = A.attention_with_lse(q, k, v, 0.125)
    want = A.attention_backward_reference(q, k, v, out, do, lse, 0.125)
    di = (do * out).sum(-1)
    got = A.attention_backward_reference(q, k, v, None, do, lse, 0.125,
                                         di=di)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert lse.shape == (2, 3, 33) and lse.dtype == torch.float32
