"""The port's plain 3×3×3 conv (K3's plain version) and its conv over a
concat volume (PSMNet's first 3D layer) against the JAX package.

Inputs are made with numpy from a seed and fed to both. The JAX Pallas K3,
``conv3d_pallas``, runs in interpret mode, as tests/test_pallas_conv3d.py
runs it, beside XLA's conv. ``conv3d_concat_volume`` is held against JAX's
``ops.conv3d.conv3d_concat_volume`` and against XLA's conv over JAX's built
volume. Tolerance 1e-5 × max|ref|: the same float32 arithmetic in another
summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stereo_toolbox_tpu import ops as jax_ops
from stereo_toolbox_tpu.ops.conv3d import \
    conv3d_concat_volume as jax_conv3d_concat_volume
from stereo_toolbox_tpu.ops.pallas.conv3d import conv3d_pallas
from stereo_toolbox_tpu_torch import ops
from stereo_toolbox_tpu_torch.nn import ConcatVolumeConvBNAct, Conv3dSame
from stereo_toolbox_tpu_torch.ops.conv3d import pack_concat_conv3d_weight

torch.set_num_threads(2)


def _inputs(b, d, h, w, ci, co, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, d, h, w, ci).astype(np.float32)
    k = (rng.randn(3, 3, 3, ci, co) * (2.0 / (27 * ci)) ** 0.5).astype(
        np.float32)
    return x, k


# (b, d, h, w, ci, co, tile_h): the classifiers' Co = 1 at Ci = 32 and 16,
# Co = 8, ragged H (7: the Pallas tile falls to 1), D < 3, B = 2
CASES = [(1, 4, 8, 10, 32, 1, 4), (2, 3, 7, 9, 16, 1, 8),
         (1, 2, 6, 12, 16, 8, 2), (2, 5, 7, 5, 32, 8, 4)]


@pytest.mark.parametrize("b,d,h,w,ci,co,tile_h", CASES)
def test_conv3d_matches_pallas_and_lax(b, d, h, w, ci, co, tile_h):
    x, k = _inputs(b, d, h, w, ci, co, seed=ci + co)
    got = ops.conv3d(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    lax = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(k), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC")))
    pallas = np.asarray(conv3d_pallas(jnp.asarray(x), jnp.asarray(k),
                                      tile_h=tile_h, interpret=True))
    assert got.shape == (b, d, h, w, co)
    tol = 1e-5 * np.abs(lax).max()
    np.testing.assert_allclose(got, lax, rtol=0, atol=tol)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol)


def test_cpu_conv3d_is_the_plain_version_and_counts_nothing():
    x, k = _inputs(1, 3, 5, 6, 16, 1, seed=3)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    before = ops.conv3d.launches, dict(ops.conv3d.shapes)
    torch.testing.assert_close(ops.conv3d(xt, kt),
                               ops.conv3d_reference(xt, kt), rtol=0, atol=0)
    assert (ops.conv3d.launches, dict(ops.conv3d.shapes)) == before


def test_conv3d_reference_keeps_bfloat16():
    x, k = _inputs(1, 2, 4, 5, 8, 1, seed=4)
    xb, kb = torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16()
    got = ops.conv3d_reference(xb, kb)
    assert got.dtype == torch.bfloat16
    want = ops.conv3d_reference(xb.float(), kb.float())
    torch.testing.assert_close(got.float(), want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("co", [1, 8])
def test_conv3d_same_is_the_channels_last_conv3d(co):
    """`Conv3dSame` in eval (`ops.conv3d`) and in train (cuDNN's path on
    the channels-first view) equal ``nn.Conv3d(k=3, p=1, bias=False)`` on
    the same weight; its state_dict is nn.Conv3d's."""
    layer = Conv3dSame(16, co)
    ref = torch.nn.Conv3d(16, co, 3, 1, 1, bias=False)
    ref.load_state_dict(layer.state_dict())
    assert list(layer.state_dict()) == ["weight"]
    x = torch.from_numpy(_inputs(2, 3, 5, 7, 16, co, seed=5)[0])
    want = ref(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1)
    with torch.no_grad():
        for train in (False, True):
            got = layer.train(train)(x)
            torch.testing.assert_close(got, want.detach(), rtol=1e-5,
                                       atol=1e-5)


def _concat_inputs(b, d, h, w, c, co, seed):
    rng = np.random.RandomState(seed)
    left = rng.randn(b, h, w, c).astype(np.float32)
    right = rng.randn(b, h, w, c).astype(np.float32)
    k = (rng.randn(3, 3, 3, 2 * c, co) * 0.2).astype(np.float32)
    return left, right, k


def _jax_conv_over_volume(left, right, k, d):
    vol = jax_ops.build_concat_volume(jnp.asarray(left), jnp.asarray(right),
                                      d)
    return np.asarray(jax.lax.conv_general_dilated(
        vol, jnp.asarray(k), (1, 1, 1), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC")))


# (b, d, h, w, c, co): the JAX package's own cases (tests/test_conv3d.py:
# (d, h, w) = (8, 6, 12), (12, 5, 8), (4, 4, 4), C 5, Co 7, B 2); D > W + 2
# (whole planes left of the image); D = 2; Co 1 and 32
CONCAT_CASES = [(2, 8, 6, 12, 5, 7), (2, 12, 5, 8, 5, 7), (2, 4, 4, 4, 5, 7),
                (1, 9, 3, 5, 4, 3), (1, 2, 4, 6, 3, 2), (1, 6, 5, 9, 8, 1),
                (1, 6, 5, 9, 8, 32)]


@pytest.mark.parametrize("b,d,h,w,c,co", CONCAT_CASES)
def test_conv3d_concat_volume_matches_jax(b, d, h, w, c, co):
    """Against JAX's factorised op and XLA's conv over JAX's built volume,
    within 1e-5 × max|ref|."""
    left, right, k = _concat_inputs(b, d, h, w, c, co, seed=d + w + co)
    got = ops.conv3d_concat_volume(torch.from_numpy(left),
                                   torch.from_numpy(right),
                                   torch.from_numpy(k), d).numpy()
    lax = _jax_conv_over_volume(left, right, k, d)
    fact = np.asarray(jax_conv3d_concat_volume(
        jnp.asarray(left), jnp.asarray(right), jnp.asarray(k), d))
    assert got.shape == (b, d, h, w, co)
    tol = 1e-5 * np.abs(lax).max()
    np.testing.assert_allclose(got, fact, rtol=0, atol=tol)
    np.testing.assert_allclose(got, lax, rtol=0, atol=tol)


def test_conv3d_concat_volume_at_one_plane_is_the_conv_over_the_volume():
    """D = 1: the one plane reads no kd = 0 or kd = 2 plane. The port
    matches XLA's conv over JAX's built volume; JAX's factorised op gives
    that plane the first plane's taps (kd = 1, 2) and is not compared
    here."""
    left, right, k = _concat_inputs(1, 1, 4, 6, 3, 2, seed=1)
    got = ops.conv3d_concat_volume(torch.from_numpy(left),
                                   torch.from_numpy(right),
                                   torch.from_numpy(k), 1).numpy()
    lax = _jax_conv_over_volume(left, right, k, 1)
    np.testing.assert_allclose(got, lax, rtol=0,
                               atol=1e-5 * np.abs(lax).max())


@pytest.mark.parametrize("b,d,h,w,c,co", CONCAT_CASES + [(1, 1, 4, 6, 3, 2)])
@pytest.mark.parametrize("epilogue", [False, True])
def test_conv3d_concat_volume_matches_its_plain_version(b, d, h, w, c, co,
                                                        epilogue):
    """Against `conv3d_concat_volume_reference` (the volume built, then
    F.conv3d), with and without a folded scale, bias and ReLU, from the
    raw kernel and from weights packed once."""
    left, right, k = (torch.from_numpy(a) for a in _concat_inputs(
        b, d, h, w, c, co, seed=2 * d + h))
    rng = np.random.RandomState(co)
    scale = torch.from_numpy(rng.rand(co).astype(np.float32) + 0.5)
    bias = torch.from_numpy(rng.randn(co).astype(np.float32))
    args = (scale, bias, True) if epilogue else (None, None, False)
    want = ops.conv3d_concat_volume_reference(left, right, k, d, *args)
    packed = pack_concat_conv3d_weight(k, d, *args[:2])
    for got in (ops.conv3d_concat_volume(left, right, k, d, *args),
                ops.conv3d_concat_volume(left, right, packed, d,
                                         relu=args[2])):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * want.abs().max().item())


def test_packed_concat_weights_count_the_plane_sets():
    """Three sets for D ≥ 3 (first, inner, last planes), two at D = 2, one
    at D = 1: the left conv stacks a zero kernel and five a set, the right
    two a set (every tap, and without kw = 2, whose sum is the whole right
    half of the 3D kernel); and a pack for one depth is refused at
    another."""
    k = torch.randn(3, 3, 3, 8, 5)
    for d, n in ((48, 3), (3, 3), (2, 2), (1, 1)):
        p = pack_concat_conv3d_weight(k, d)
        assert len(set(p.plane_sets)) == n and len(p.plane_sets) == d
        assert p.left.shape == ((1 + 5 * n) * 5, 4, 3, 3)
        assert p.right.shape == (2 * n * 5, 4, 3, 5)
        assert not p.left[:5].any()
    p = pack_concat_conv3d_weight(k, 3)
    g = 2 * p.plane_sets[1] * 5                 # the inner plane's first
    inner = p.right[g:g + 5]
    torch.testing.assert_close(inner.sum((2, 3)),
                               k[..., 4:, :].sum((0, 1, 2)).T)
    x = torch.randn(1, 3, 7, 4)
    with pytest.raises(ValueError, match="packed for D=3"):
        ops.conv3d_concat_volume(x, x, pack_concat_conv3d_weight(k, 3), 4)


def test_concat_volume_conv_bn_act_is_relu_bn_conv_over_the_volume():
    """The layer in eval (BatchNorm folded into the packed kernels, kept
    between forwards) and in train mode (batch statistics) against
    ReLU(BatchNorm3d(Conv3d)) over the built volume; its state_dict is a
    ``convbn_3d``'s."""
    torch.manual_seed(0)
    layer = ConcatVolumeConvBNAct(4, 6, 5)
    assert list(layer.state_dict()) == [
        "0.weight", "1.weight", "1.bias", "1.running_mean",
        "1.running_var", "1.num_batches_tracked"]
    with torch.no_grad():
        layer[1].running_mean.normal_()
        layer[1].running_var.uniform_(0.5, 1.5)
        layer[1].weight.uniform_(0.5, 1.5)
        layer[1].bias.normal_()
    conv, bn = layer[0], layer[1]
    left, right = torch.randn(2, 3, 7, 4), torch.randn(2, 3, 7, 4)
    vol = ops.concat_volume_reference(left, right, 5).permute(0, 4, 1, 2, 3)
    for train in (False, True):
        layer.train(train)
        with torch.no_grad():
            want = torch.relu(F.batch_norm(
                conv(vol), bn.running_mean.clone(), bn.running_var.clone(),
                bn.weight, bn.bias, train, 0.0, bn.eps))
            for _ in range(2):
                got = layer(left, right)
        torch.testing.assert_close(got, want.permute(0, 2, 3, 4, 1),
                                   rtol=1e-5, atol=1e-5)
