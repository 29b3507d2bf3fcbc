"""The port's plain 3×3×3 conv (K3's plain version) against the JAX package.

Inputs are made with numpy from a seed and fed to both. The JAX Pallas K3,
``conv3d_pallas``, runs in interpret mode, as tests/test_pallas_conv3d.py
runs it, beside XLA's conv. Tolerance 1e-5 × max|ref|: the same float32
arithmetic in another summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu.ops.pallas.conv3d import conv3d_pallas
from stereo_toolbox_tpu_torch import ops
from stereo_toolbox_tpu_torch.nn import Conv3dSame

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
