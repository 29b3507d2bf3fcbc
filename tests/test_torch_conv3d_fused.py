"""The port's fused 3×3×3 conv against the JAX Pallas kernel.

`conv3d_fused_reference` (the plain version the CPU runs, and the yardstick
of the CUDA kernel on the card) is held against JAX ``conv3d_fused(...,
interpret=True)`` on the cases of tests/test_pallas_conv3d.py, plus GwcNet's
first 3D layer shape (Ci=40 → Co=32). Tolerance 1e-4, as there.

`pack_conv3d_weight` + `conv3d_fused_gemm_reference` (the tensor-core
kernel's layout and order of summation) are held against
`conv3d_fused_reference` and against the JAX kernel, within 1e-5 · max|ref|
in float32, at Ci and Co that are not multiples of the kernel's chunks.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu.ops.pallas.conv3d_fused import conv3d_fused as jfused
from stereo_toolbox_tpu_torch.ops import (_cuda, conv3d_fused,
                                          conv3d_fused_reference)
from stereo_toolbox_tpu_torch.ops.conv3d_fused import (
    MMA_TILES, PackedConv3dWeight, conv3d_fused_gemm_reference, mma_tile,
    pack_conv3d_weight)

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


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _within(got, want, rel=1e-5):
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), err


@pytest.mark.parametrize("ci", [1, 16, 33, 40, 65])
@pytest.mark.parametrize("co", [8, 16, 33])
@pytest.mark.parametrize("residual,relu", [(False, False), (True, True)])
def test_gemm_reference_matches_reference(ci, co, residual, relu):
    x, k, scale, bias, res = _case(ci * 7 + co, (1, 3, 4, 5), ci, co, True,
                                   residual)
    packed = pack_conv3d_weight(_t(k))
    got = conv3d_fused_gemm_reference(_t(x), packed, _t(scale), _t(bias),
                                      _t(res), relu).numpy()
    want = conv3d_fused_reference(_t(x), _t(k), _t(scale), _t(bias), _t(res),
                                  relu).numpy()
    _within(got, want)


@pytest.mark.parametrize("ci,co,residual,relu", [(1, 8, False, False),
                                                 (33, 16, True, True),
                                                 (40, 8, True, False),
                                                 (65, 33, False, True)])
def test_gemm_reference_matches_jax_pallas(ci, co, residual, relu):
    x, k, scale, bias, res = _case(ci + co, (1, 3, 4, 6), ci, co, True,
                                   residual)
    want = np.asarray(jfused(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(bias),
        None if res is None else jnp.asarray(res), relu=relu, tile_h=2,
        interpret=True))
    got = conv3d_fused_gemm_reference(_t(x), pack_conv3d_weight(_t(k)),
                                      _t(scale), _t(bias), _t(res),
                                      relu).numpy()
    _within(got, want)


def test_packed_weight_layout():
    k = torch.from_numpy(_case(5, (1, 1, 1, 1), 33, 40, False, False)[1])
    packed = pack_conv3d_weight(k)
    assert (packed.ci, packed.co) == (33, 40)
    assert packed.data.shape == (27, 64, 48) and packed.data.dtype == k.dtype
    assert torch.equal(packed.kernel(), k)
    assert torch.equal(packed.data[4, 7, :33], k[0, 1, 1, :, 7])
    assert not packed.data[:, 40:].any() and not packed.data[:, :, 33:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_path_is_the_plain_version_and_counts_nothing(dtype):
    """bfloat16 too: on a CPU tensor the wrapper runs the plain version, on
    a raw or a packed kernel, and counts no launch, shape or design."""
    x, k, scale, bias, res = (
        None if a is None else torch.from_numpy(a)
        for a in _case(6, (1, 2, 3, 5), 33, 8, True, True))
    x, k, res = x.to(dtype), k.to(dtype), res.to(dtype)
    counts = (conv3d_fused.launches, dict(conv3d_fused.shapes),
              dict(conv3d_fused.designs))
    want = conv3d_fused_reference(x, k, scale, bias, res, relu=True)
    assert want.dtype == dtype
    for kernel in (k, pack_conv3d_weight(k)):
        assert torch.equal(conv3d_fused(x, kernel, scale, bias, res, True),
                           want)
    assert (conv3d_fused.launches, dict(conv3d_fused.shapes),
            dict(conv3d_fused.designs)) == counts


@pytest.mark.parametrize("shape,co,tile", [
    ((1, 48, 120, 160), 32, (8, 32)),     # GwcNet's full-volume layers
    ((1, 24, 60, 80), 64, (4, 64)),       # hourglass conv2
    ((1, 12, 30, 40), 128, (4, 64)),      # hourglass conv4
    ((1, 12, 240, 320), 16, (8, 16)),     # CFNet's 1/2 stage
    ((1, 6, 15, 20), 128, (2, 32)),       # CFNet's 1/32 volume: few blocks
    ((1, 12, 30, 40), 64, (2, 32)),
])
def test_mma_tile_is_picked_by_shape(shape, co, tile):
    assert MMA_TILES[mma_tile(*shape, co, sms=132)] == tile


def test_wrapper_has_no_path_for_other_devices():
    """Neither CPU nor CUDA: the wrapper raises, packed kernel or not."""
    packed = pack_conv3d_weight(torch.zeros(3, 3, 3, 16, 4))
    assert isinstance(packed, PackedConv3dWeight)
    x = torch.zeros(1, 2, 3, 4, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3d_fused(x, packed)


def test_library_path_hashes_the_shared_headers(tmp_path, monkeypatch):
    """An edit to any csrc header renames the library of every source, so
    a stale build is never loaded."""
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n')
    (tmp_path / "a.cuh").write_text("// a\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    first = _cuda.library_path("k")
    assert first == _cuda.library_path("k")
    (tmp_path / "a.cuh").write_text("// a, edited\n")
    second = _cuda.library_path("k")
    (tmp_path / "b.cuh").write_text("// a new header\n")
    third = _cuda.library_path("k")
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n// edited\n')
    assert len({first, second, third, _cuda.library_path("k")}) == 4
    assert first.name.startswith("k-") and first.suffix == ".so"
