"""The port's fused 3×3×3 conv against the JAX Pallas kernel.

`conv3d_fused_reference` (the plain version the CPU runs, and the yardstick
of the CUDA kernel on the card) is held against JAX ``conv3d_fused(...,
interpret=True)`` on the cases of tests/test_pallas_conv3d.py, plus GwcNet's
first 3D layer shape (Ci=40 → Co=32). Tolerance 1e-4, as there.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu.ops.pallas.conv3d_fused import conv3d_fused as jfused
from stereo_toolbox_tpu_torch.ops import conv3d_fused, conv3d_fused_reference

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _case(seed, shape, ci, co, affine, residual):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape, ci).astype(np.float32)
    k = (rng.randn(3, 3, 3, ci, co) * 0.1).astype(np.float32)
    scale = bias = res = None
    if affine:
        scale = (rng.rand(co) + 0.5).astype(np.float32)
        bias = rng.randn(co).astype(np.float32)
    if residual:
        res = rng.randn(*shape, co).astype(np.float32)
    return x, k, scale, bias, res


CASES = [
    # seed, [B, D, H, W], ci, co, affine, residual, relu, tile_h
    (0, (1, 4, 8, 10), 8, 8, False, False, False, 4),
    (0, (1, 4, 8, 10), 16, 8, False, False, False, 4),
    (1, (2, 3, 4, 6), 8, 8, True, False, True, 2),
    (2, (1, 5, 4, 6), 8, 8, True, True, True, 2),
    (3, (1, 4, 6, 10), 40, 32, True, False, True, 2),
]


@pytest.mark.parametrize("seed,shape,ci,co,affine,residual,relu,tile_h",
                         CASES)
def test_reference_matches_jax_pallas(seed, shape, ci, co, affine, residual,
                                      relu, tile_h):
    x, k, scale, bias, res = _case(seed, shape, ci, co, affine, residual)
    want = np.asarray(jfused(
        jnp.asarray(x), jnp.asarray(k),
        None if scale is None else jnp.asarray(scale),
        None if bias is None else jnp.asarray(bias),
        None if res is None else jnp.asarray(res),
        relu=relu, tile_h=tile_h, interpret=True))

    def t(a):
        return None if a is None else torch.from_numpy(a)

    got = conv3d_fused_reference(t(x), t(k), t(scale), t(bias), t(res),
                                 relu=relu).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(
        conv3d_fused(t(x), t(k), t(scale), t(bias), t(res), relu=relu)
        .numpy(), got)


def test_cpu_wrapper_never_counts_a_launch():
    x, k, scale, bias, res = _case(4, (1, 2, 3, 4), 4, 4, True, True)
    before = conv3d_fused.launches, dict(conv3d_fused.shapes)
    conv3d_fused(torch.from_numpy(x), torch.from_numpy(k),
                 torch.from_numpy(scale), torch.from_numpy(bias),
                 torch.from_numpy(res), relu=True)
    assert (conv3d_fused.launches, dict(conv3d_fused.shapes)) == before


def test_kernel_modules_import_without_nvcc():
    """Importing the kernel modules builds nothing: no nvcc on the PATH."""
    code = ("import stereo_toolbox_tpu_torch.ops.conv3d_fused\n"
            "import stereo_toolbox_tpu_torch.ops.volume\n"
            "from stereo_toolbox_tpu_torch.ops import _cuda\n"
            "assert not _cuda._libs\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env={"PATH": ""})
    assert r.returncode == 0, r.stdout + r.stderr
