"""The backward kernels' plain versions against autograd and JAX, on the
CPU.

K6, K4 and K5 are autograd Functions on the card whose backward launches a
kernel: `concat_volume_backward`, `gather_right_by_samples_backward` and
`gwc_volume_from_samples_backward`. Their plain versions
(``*_backward_reference``), which the card's kernels are held to, are held
here against three things on the same numpy inputs from a seed:

- ``torch.autograd`` of the port's plain forward;
- ``jax.vjp`` of the JAX package's XLA path (``ops/volume.py``:
  `build_concat_volume`, `gather_right_by_samples`,
  `gwc_volume_from_samples`), whose gradient JAX's train step takes (the
  Pallas kernels have no reverse-mode rule). JAX's gather does not clamp
  its samples (the port clamps to ``[0, max_shift]``), so the samples given
  to both lie in that range; the autograd comparison also takes samples
  past both ends and past the image's left edge;
- each wrapper on CPU tensors, which runs the plain version.

Bounds: float64 1e-12 · max|ref|, float32 1e-6 · max|ref|. The samples get
no gradient (``None``), as JAX's int cast gives them none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu.ops import volume as jvol
from stereo_toolbox_tpu_torch.ops import volume as V

REL = {torch.float64: 1e-12, torch.float32: 1e-6}
NP = {torch.float64: np.float64, torch.float32: np.float32}


def _close(got, want, dtype):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= REL[dtype] * np.abs(want).max(), err


def _jax_vjp(fn, primals, cotangent, dtype):
    """``jax.vjp`` of `fn` at numpy `primals` with numpy `cotangent`, in
    float64 where `dtype` is, jitted as the JAX trainer runs it (eager
    float64 ``vjp`` of ``jnp.pad`` gives garbage on the CPU with the JAX
    this was written against: 6e294 where jit gives 9e-16)."""
    with jax.enable_x64(dtype == torch.float64):
        grads = jax.jit(lambda p, ct: jax.vjp(fn, *p)[1](ct))(
            [jnp.asarray(p) for p in primals], jnp.asarray(cotangent))
        return [np.asarray(g) for g in grads]


def _grads(fn, tensors, grad):
    """``torch.autograd`` of `fn` at leaves made from `tensors`."""
    leaves = [t.clone().requires_grad_() for t in tensors]
    return torch.autograd.grad(fn(*leaves), leaves, grad)


DTYPES = [torch.float64, torch.float32]
# (b, h, w, c, d): D < W, D > W, C 1, B 2
CONCAT_CASES = [(2, 3, 9, 4, 5), (1, 2, 7, 3, 11), (2, 2, 12, 1, 12)]


@pytest.mark.parametrize("b,h,w,c,d", CONCAT_CASES)
@pytest.mark.parametrize("mask_left", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_concat_volume_backward_reference(b, h, w, c, d, mask_left, dtype):
    rng = np.random.RandomState(0)
    grad = rng.randn(b, d, h, w, 2 * c).astype(NP[dtype])
    feats = rng.randn(2, b, h, w, c).astype(NP[dtype])
    g = torch.from_numpy(grad)
    dl, dr = V.concat_volume_backward_reference(g, d, mask_left)
    auto = _grads(lambda l, r: V.concat_volume_reference(l, r, d, mask_left),
                  [torch.from_numpy(f) for f in feats], g)
    ref = _jax_vjp(lambda l, r: jvol.build_concat_volume(l, r, d, mask_left),
                   feats, grad, dtype)
    wrapper = V.concat_volume_backward(g, d, mask_left)
    for got, a, j, w_ in zip((dl, dr), auto, ref, wrapper):
        assert got.dtype == dtype and got.shape == (b, h, w, c)
        _close(got, a, dtype)
        _close(got, j, dtype)
        assert torch.equal(got, w_)


def _samples(rng, b, s, h, w, lo, hi):
    return rng.randint(lo, hi + 1, (b, s, h, w)).astype(np.float32)


# (b, h, w, c, s, max_shift): max_shift > W, C 1, S 1, a row whose every
# sample reads pixel 0
GATHER_CASES = [(2, 3, 9, 4, 5, 6), (1, 2, 7, 3, 4, 12), (2, 2, 11, 1, 1, 5)]


@pytest.mark.parametrize("b,h,w,c,s,max_shift", GATHER_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_right_by_samples_backward_reference(b, h, w, c, s, max_shift,
                                                    dtype):
    rng = np.random.RandomState(1)
    grad = rng.randn(b, s, h, w, c).astype(NP[dtype])
    right = rng.randn(b, h, w, c).astype(NP[dtype])
    g = torch.from_numpy(grad)
    for lo, hi in ((0, max_shift), (-3, max_shift + 4)):
        samples = _samples(rng, b, s, h, w, lo, hi)
        samples[0, :, -1] = np.minimum(np.arange(w), max_shift)
        smp = torch.from_numpy(samples)
        got = V.gather_right_by_samples_backward_reference(g, smp,
                                                           max_shift)
        assert got.dtype == dtype and got.shape == (b, h, w, c)
        smp.requires_grad_()
        r = torch.from_numpy(right).requires_grad_()
        out = V.gather_right_by_samples_reference(r, smp, max_shift)
        dr, ds = torch.autograd.grad(out, (r, smp), g, allow_unused=True)
        assert ds is None
        _close(got, dr, dtype)
        assert torch.equal(got, V.gather_right_by_samples_backward(
            g, smp.detach(), max_shift))
        if lo == 0:
            (ref,) = _jax_vjp(lambda x: jvol.gather_right_by_samples(
                x, jnp.asarray(samples), max_shift), [right], grad, dtype)
            _close(got, ref, dtype)


# (b, h, w, c, s, g, max_shift): C/G 1, 3 and 4, S 1
GWC_SAMPLE_CASES = [(2, 3, 9, 8, 5, 2, 6), (1, 2, 7, 6, 4, 2, 12),
                    (2, 2, 11, 4, 1, 4, 5)]


@pytest.mark.parametrize("b,h,w,c,s,g,max_shift", GWC_SAMPLE_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_gwc_volume_from_samples_backward_reference(b, h, w, c, s, g,
                                                    max_shift, dtype):
    rng = np.random.RandomState(2)
    grad = rng.randn(b, s, h, w, g).astype(NP[dtype])
    feats = rng.randn(2, b, h, w, c).astype(NP[dtype])
    gt = torch.from_numpy(grad)
    for lo, hi in ((0, max_shift), (-3, max_shift + 4)):
        samples = _samples(rng, b, s, h, w, lo, hi)
        smp = torch.from_numpy(samples)
        lf, rf = (torch.from_numpy(f) for f in feats)
        dl, dr = V.gwc_volume_from_samples_backward_reference(
            lf, rf, smp, gt, g, max_shift)
        smp.requires_grad_()
        leaves = [t.clone().requires_grad_() for t in (lf, rf)]
        out = V.gwc_volume_from_samples_reference(*leaves, smp, g, max_shift)
        *auto, ds = torch.autograd.grad(out, (*leaves, smp), gt,
                                        allow_unused=True)
        assert ds is None
        wrapper = V.gwc_volume_from_samples_backward(lf, rf, smp.detach(),
                                                     gt, g, max_shift)
        ref = (_jax_vjp(lambda x, y: jvol.gwc_volume_from_samples(
            x, y, jnp.asarray(samples), g, max_shift), feats, grad, dtype)
            if lo == 0 else auto)
        for got, a, j, w_ in zip((dl, dr), auto, ref, wrapper):
            assert got.dtype == dtype and got.shape == (b, h, w, c)
            _close(got, a, dtype)
            _close(got, j, dtype)
            assert torch.equal(got, w_)


# (b, h, w, s, g): CFNet's s3 and s2 stages in training and eval, a few
# rows with odd G
@pytest.mark.parametrize("b,h,w,s,g", [(4, 64, 128, 16, 40),
                                       (4, 128, 256, 12, 20),
                                       (1, 120, 160, 16, 40),
                                       (1, 240, 320, 12, 20),
                                       (2, 3, 45, 7, 3)])
def test_sample_backward_plan_chunks_cover_the_groups(b, h, w, s, g):
    """The K4/K5 backward plan: whole groups a chunk, the chunks covering G
    once, the fewest that give 4 blocks an SM (or one group each), and the
    row's lists within the shared-memory cap."""
    plan = V.sample_backward_plan(b, h, w, s, g, 132)
    chunks = -(-g // plan.groups)
    assert (chunks - 1) * plan.groups < g <= chunks * plan.groups
    assert b * h * chunks >= 4 * 132 or plan.groups == 1
    assert b * h * (chunks - 1) < 4 * 132 or chunks == 1
    assert plan.smem == 4 * (2 * s * w + 2 * w + 1) <= V.SAMPLE_BWD_MAX_SMEM
    assert V.sample_backward_plan(b, h, w, s, 1, 132).groups == 1


def test_sample_backward_plan_refuses_rows_past_shared_memory():
    with pytest.raises(ValueError, match="shared bytes"):
        V.sample_backward_plan(1, 1, 4000, 16, 1, 132)


@pytest.mark.parametrize("c", [1, 3, 5, 6, 12, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("align", [2, 4, 8, 16])
def test_concat_backward_plan_words(c, dtype, align):
    """K6's backward reads a word of `vec` channels: the widest of 16, 8,
    4 or 2 bytes whose channels divide C and whose bytes divide the bases'
    alignment (one channel where none does)."""
    size = 4 if dtype == torch.float32 else 2
    vec = V.concat_backward_plan(c, dtype, align).vec
    assert c % vec == 0 and (vec == 1 or align % (vec * size) == 0)
    wider = [v for v in (16, 8, 4, 2) if v // size > vec and v >= size]
    assert all(c % (v // size) or align % v for v in wider)
