"""Port ops (cost volume, regression, resize) against the JAX package.

Inputs are made with numpy from a seed and fed to both; the JAX Pallas gwc
kernel runs in interpret mode, as tests/test_pallas_volume.py runs it.
Tolerance 1e-5: the same float32 arithmetic in another summation order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu import ops as jops
from stereo_toolbox_tpu.ops.pallas.volume import build_gwc_volume_pallas
from stereo_toolbox_tpu_torch import ops

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-5)


def _feats(b, h, w, c, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, w, c).astype(np.float32),
            rng.randn(b, h, w, c).astype(np.float32))


# (b, h, w, c, max_disp, groups, seed): the odd-block and W-tiled cases of
# tests/test_pallas_volume.py, the default case there, and GwcNet's C=320/G=40
GWC_CASES = [(1, 6, 8, 8, 4, 2, 0), (1, 2, 256, 8, 48, 4, 3),
             (2, 8, 16, 16, 6, 4, 0), (1, 3, 40, 320, 12, 40, 5)]


@pytest.mark.parametrize("b,h,w,c,d,g,seed", GWC_CASES)
def test_build_gwc_volume_matches_jax_and_pallas(b, h, w, c, d, g, seed):
    left, right = _feats(b, h, w, c, seed)
    got = ops.build_gwc_volume(torch.from_numpy(left),
                               torch.from_numpy(right), d, g).numpy()
    want = np.asarray(jops.build_gwc_volume(jnp.asarray(left),
                                            jnp.asarray(right), d, g))
    pallas = np.asarray(build_gwc_volume_pallas(
        jnp.asarray(left), jnp.asarray(right), d, g, interpret=True))
    assert got.shape == (b, d, h, w, g)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, pallas, **TOL)


def test_build_gwc_volume_cpu_is_the_plain_version():
    left, right = _feats(1, 3, 20, 8, 1)
    lt, rt = torch.from_numpy(left), torch.from_numpy(right)
    before = ops.build_gwc_volume.launches, dict(ops.build_gwc_volume.shapes)
    got = ops.build_gwc_volume(lt, rt, 25, 2)   # D > W: all-zero planes
    assert (ops.build_gwc_volume.launches,
            dict(ops.build_gwc_volume.shapes)) == before
    torch.testing.assert_close(got, ops.gwc_volume_reference(lt, rt, 25, 2),
                               rtol=0, atol=0)
    assert not got[:, 20:].any()


def test_shifted_right_stack_matches_jax():
    _, right = _feats(2, 3, 10, 4, 2)
    got = ops.shifted_right_stack(torch.from_numpy(right), 12).numpy()
    want = np.asarray(jops.shifted_right_stack(jnp.asarray(right), 12))
    np.testing.assert_array_equal(got, want)


def test_groupwise_correlation_matches_jax():
    a, b = _feats(2, 5, 7, 24, 4)
    got = ops.groupwise_correlation(torch.from_numpy(a), torch.from_numpy(b),
                                    6).numpy()
    want = np.asarray(jops.groupwise_correlation(jnp.asarray(a),
                                                 jnp.asarray(b), 6))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("offset", [0.0, 2.5])
def test_disparity_regression_matches_jax(offset):
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 9, 4, 5).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    got = ops.disparity_regression(torch.from_numpy(prob),
                                   offset=offset).numpy()
    want = np.asarray(jops.disparity_regression(jnp.asarray(prob),
                                                offset=offset))
    np.testing.assert_allclose(got, want, **TOL)


def test_soft_argmax_matches_jax():
    cost = np.random.RandomState(7).randn(2, 12, 3, 4).astype(np.float32)
    got = ops.soft_argmax(torch.from_numpy(cost)).numpy()
    want = np.asarray(jops.soft_argmax(jnp.asarray(cost)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("align_corners", [True, False])
def test_interpolate_three_axes_matches_jax(align_corners):
    x = np.random.RandomState(8).randn(2, 6, 5, 7).astype(np.float32)
    size, axes = (24, 20, 13), (1, 2, 3)
    got = ops.interpolate(torch.from_numpy(x), size, axes,
                          align_corners=align_corners).numpy()
    want = np.asarray(jops.interpolate(jnp.asarray(x), size, axes,
                                       align_corners=align_corners))
    assert got.shape == (2, 24, 20, 13)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("align_corners", [True, False])
def test_interpolate_matches_torch_trilinear(align_corners):
    """The separable resize is F.interpolate(mode='trilinear')."""
    x = torch.from_numpy(np.random.RandomState(9).randn(1, 4, 3, 5, 6)
                         .astype(np.float32))
    got = ops.interpolate(x[:, 0], (12, 10, 24), (1, 2, 3),
                          align_corners=align_corners)
    want = torch.nn.functional.interpolate(
        x, (12, 10, 24), mode="trilinear", align_corners=align_corners)[:, 0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# (b, h, w, c, max_disp, groups, seed) for the gradient: GwcNet's C/G = 8,
# D > W, C/G = 1 (G = C), C/G = 3, B = 3
GWC_GRAD_CASES = [(1, 3, 20, 320, 12, 40, 0), (2, 2, 9, 16, 13, 2, 1),
                  (1, 2, 11, 6, 4, 6, 2), (3, 2, 17, 24, 7, 8, 3),
                  (1, 2, 5, 9, 8, 3, 4)]


def _grad_inputs(b, h, w, c, d, g, seed):
    left, right = _feats(b, h, w, c, seed)
    grad = np.random.RandomState(seed + 100).randn(
        b, d, h, w, g).astype(np.float32)
    return left, right, grad


@pytest.mark.parametrize("b,h,w,c,d,g,seed", GWC_GRAD_CASES)
def test_gwc_volume_backward_reference_matches_autograd_and_jax(
        b, h, w, c, d, g, seed):
    """The backward's plain version (the two sums over d) against
    torch.autograd of `gwc_volume_reference` and jax.grad of JAX's
    `build_gwc_volume` (its XLA path, which JAX differentiates: the Pallas
    K1 has no reverse-mode rule)."""
    import jax
    left, right, grad = _grad_inputs(b, h, w, c, d, g, seed)
    dl, dr = ops.gwc_volume_backward_reference(
        torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(grad), d, g)
    lt = torch.from_numpy(left).requires_grad_()
    rt = torch.from_numpy(right).requires_grad_()
    ops.gwc_volume_reference(lt, rt, d, g).backward(torch.from_numpy(grad))
    torch.testing.assert_close(dl, lt.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dr, rt.grad, rtol=1e-5, atol=1e-5)
    _, vjp = jax.vjp(lambda a, bb: jops.build_gwc_volume(a, bb, d, g),
                     jnp.asarray(left), jnp.asarray(right))
    jl, jr = vjp(jnp.asarray(grad))
    np.testing.assert_allclose(dl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(dr.numpy(), np.asarray(jr), **TOL)
    if d > w:   # right pixels reach no output past W - 1 - u
        assert dl.shape == lt.shape


def test_build_gwc_volume_is_differentiable_on_the_cpu():
    left, right, grad = _grad_inputs(1, 2, 10, 8, 6, 2, 5)
    lt = torch.from_numpy(left).requires_grad_()
    rt = torch.from_numpy(right).requires_grad_()
    before = ops.gwc_volume_backward.launches
    ops.build_gwc_volume(lt, rt, 6, 2).backward(torch.from_numpy(grad))
    dl, dr = ops.gwc_volume_backward(torch.from_numpy(left),
                                     torch.from_numpy(right),
                                     torch.from_numpy(grad), 6, 2)
    torch.testing.assert_close(lt.grad, dl, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rt.grad, dr, rtol=1e-5, atol=1e-5)
    assert ops.gwc_volume_backward.launches == before


def test_gwc_volume_function_routes_the_gradients(monkeypatch):
    """The card's path without a card: with the device checks passed and
    both launches replaced by the plain versions, `build_gwc_volume` is the
    autograd Function whose backward launches the backward once, with the
    saved features and the volume's gradient, and hands dl to left and dr
    to right."""
    from stereo_toolbox_tpu_torch.ops import _cuda
    from stereo_toolbox_tpu_torch.ops import volume as vol
    calls = []

    def fake_backward(left, right, grad, d, g):
        calls.append((left.shape, grad.shape, grad.is_contiguous()))
        return vol.gwc_volume_backward_reference(left, right, grad, d, g)
    monkeypatch.setattr(_cuda, "on_cpu", lambda t: False)
    monkeypatch.setattr(vol, "_check_features", lambda *f: None)
    monkeypatch.setattr(vol, "_launch_gwc_volume",
                        lambda l, r, d, g: vol.gwc_volume_reference(
                            l, r, d, g).detach())
    monkeypatch.setattr(vol, "_launch_gwc_backward", fake_backward)
    left, right, grad = _grad_inputs(2, 2, 9, 12, 5, 3, 6)
    lt = torch.from_numpy(left).requires_grad_()
    rt = torch.from_numpy(right).requires_grad_()
    out = vol.build_gwc_volume(lt, rt, 5, 3)
    assert out.grad_fn is not None
    # a non-contiguous gradient arrives contiguous
    g_t = torch.from_numpy(grad).transpose(2, 3).contiguous().transpose(2, 3)
    out.backward(g_t)
    assert calls == [((2, 2, 9, 12), (2, 5, 2, 9, 3), True)]
    want_l, want_r = vol.gwc_volume_backward_reference(
        torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(grad), 5, 3)
    torch.testing.assert_close(lt.grad, want_l, rtol=0, atol=0)
    torch.testing.assert_close(rt.grad, want_r, rtol=0, atol=0)
