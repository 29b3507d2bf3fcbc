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
    from the caller) gives the same gradients;
  * the plain versions of the kernels' arithmetic (N ∈ {1, 15, 65, 77,
    200}, scale 1/8 and 1, where logits reach ~±30):
    `attention_backward_mma_reference` (bfloat16 "mma": P and dS rounded
    to bfloat16 where the library rounds them) within the bfloat16 kernel
    gate, 1e-2 × max|ref|, of `attention_backward_reference`, and
    `attention_backward_tf32x3_reference` (float32 "tf32x3") within the
    float32 gate, 1e-5 × max|ref|, with ``terms=3`` and outside it with
    ``terms=1`` (one TF32 product);
  * both against ``jax.vjp`` of the JAX package's TPU route
    (``_vit_attention_fn`` at N = 1100, padded to 2048 with segment ids,
    the library's Pallas forward and backward kernels in interpret mode)
    in their own type, within the chain tolerance of ``chip_smoke.py``
    (``K7_CHAIN_TOL``: JAX's VJP carries its own forward).
"""

import importlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

from stereo_toolbox_tpu.models import depth_anything_v2 as jax_dav2

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


# the kernels' designs at small shapes: one key, under, one past and ragged
# past a 64-row tile, and N 200 at logits of ~±30 (scale 1)
DESIGN_NS = [1, 15, 65, 77, 200]
# chip_smoke.K7_CHAIN_TOL: a backward whose forward is not the port's own
CHAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _worst(got, want):
    """The largest max|got − want| / max|ref| of dQ, dK, dV (dQ and dK
    against dV's scale where their own is zero, N = 1)."""
    got, want = ([torch.as_tensor(np.array(x, np.float32)) if not
                  torch.is_tensor(x) else x.float() for x in xs]
                 for xs in (got, want))
    floor = want[2].abs().max().item()
    return max((g - w).abs().max().item()
               / max(w.abs().max().item(), floor if i < 2 else 0.0)
               for i, (g, w) in enumerate(zip(got, want)))


def _design_inputs(n, scale, dtype):
    """q, k, v, dO in `dtype`, the plain forward's output and log-sum-exp,
    and the float32 plain backward on the same values."""
    q, k, v, do = (torch.from_numpy(x).to(dtype)
                   for x in _inputs(n, seed=4))
    out, lse = A.attention_with_lse(q, k, v, scale)
    want = A.attention_backward_reference(q.float(), k.float(), v.float(),
                                          out.float(), do.float(), lse,
                                          scale)
    return (q, k, v, out, do, lse), want


@pytest.mark.parametrize("scale", [0.125, 1.0])
@pytest.mark.parametrize("n", DESIGN_NS)
def test_mma_reference_is_inside_the_bf16_gate(n, scale):
    args, want = _design_inputs(n, scale, torch.bfloat16)
    got = A.attention_backward_mma_reference(*args, scale)
    assert all(g.dtype == torch.bfloat16 and g.shape == args[0].shape
               for g in got)
    worst = _worst(got, want)
    print(f"K7-bwd mma N {n} scale {scale}: {worst:.2e} of max|ref|, "
          f"margin {TOL[torch.bfloat16] / max(worst, 1e-30):.1f}x")
    assert worst <= TOL[torch.bfloat16]
    # the same di as the kernels take it
    di = (args[4].float() * args[3].float()).sum(-1)
    again = A.attention_backward_mma_reference(*args[:3], None, *args[4:],
                                               scale, di=di)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("scale", [0.125, 1.0])
@pytest.mark.parametrize("n", DESIGN_NS)
def test_tf32x3_reference_is_inside_the_f32_gate_and_one_product_is_not(
        n, scale):
    args, want = _design_inputs(n, scale, torch.float32)
    got = A.attention_backward_tf32x3_reference(*args, scale)
    assert all(g.dtype == torch.float32 for g in got)
    worst = _worst(got, want)
    one = _worst(A.attention_backward_tf32x3_reference(*args, scale,
                                                       terms=1), want)
    print(f"K7-bwd tf32x3 N {n} scale {scale}: 3xTF32 {worst:.2e}, one "
          f"TF32 product {one:.2e} of max|ref|")
    assert worst <= TOL[torch.float32]
    assert one > TOL[torch.float32]
    with pytest.raises(ValueError):
        A.attention_backward_tf32x3_reference(*args, scale, terms=2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_design_references_match_the_pallas_flash_backward(monkeypatch,
                                                           dtype):
    """N = 1100 ≥ 1024 takes the TPU route: ``jax.vjp`` through the
    library's Pallas forward and its two backward kernels (interpret
    mode), against the port's plain forward and the type's design."""
    rng = np.random.RandomState(11)
    q, k, v, do = (rng.randn(1, 1100, 2, 64).astype(np.float32)
                   for _ in range(4))
    jtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_dav2._vit_attention_fn,
                         *(jnp.asarray(x, jtype) for x in (q, k, v)))
        want = [np.asarray(g.astype(jnp.float32)).transpose(0, 2, 1, 3)
                for g in vjp(jnp.asarray(do, jtype))]
    tq, tk, tv, tdo = (torch.from_numpy(x).transpose(1, 2).contiguous().to(
        dtype) for x in (q, k, v, do))
    scale = 64 ** -0.5
    out, lse = A.attention_with_lse(tq, tk, tv, scale)
    design = (A.attention_backward_tf32x3_reference if dtype == torch.float32
              else A.attention_backward_mma_reference)
    got = design(tq, tk, tv, out, tdo, lse, scale)
    worst = _worst(got, want)
    print(f"K7-bwd {dtype} design vs the Pallas flash backward: "
          f"{worst:.2e} of max|ref|")
    assert worst <= CHAIN_TOL[dtype]
