"""The port's fused 3×3×3 conv against the JAX Pallas kernel.

`conv3d_fused_reference` (the plain version the CPU runs, and the yardstick
of the CUDA kernel on the card) is held against JAX ``conv3d_fused(...,
interpret=True)`` on the cases of tests/test_pallas_conv3d.py, plus GwcNet's
first 3D layer shape (Ci=40 → Co=32). Tolerance 1e-4, as there.

`pack_conv3d_weight` + `conv3d_fused_gemm_reference` (the bfloat16
kernel's layout and order of summation) are held against
`conv3d_fused_reference` and against the JAX kernel, within 1e-5 · max|ref|
in float32, at Ci and Co that are not multiples of the kernel's chunks.

`conv3d_fused_tf32x3_reference` (the float32 kernel's 3xTF32 arithmetic:
operands split by `tf32_split`, lo·hi + hi·lo + hi·hi summed in float32) is
held at GwcNet's and CFNet's channel counts, cut to a few planes, against
the float64 conv and the float32 plain version: the split's own error (the
three products summed in float64) is at least 5x inside the kernel's 1e-4 ·
max|ref| gate, one TF32 product (hi·hi) is outside it, and the float32
emulation holds the gate against the plain version and the JAX kernel.
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
    CI_ALIGN, MMA_TILES, PackedConv3dWeight, conv3d_fused_gemm_reference,
    conv3d_fused_tf32x3_reference, mma_tile, pack_conv3d_weight)
from stereo_toolbox_tpu_torch.utils.precision import tf32_round, tf32_split

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
    """Ci padded to the type's 32-byte chunk (8 float32, 16 bfloat16), Co
    to 64, zeros in the padding."""
    k = torch.from_numpy(_case(5, (1, 1, 1, 1), 33, 40, False, False)[1])
    for dtype, ci_pad in ((torch.float32, 40), (torch.bfloat16, 48)):
        assert ci_pad % CI_ALIGN[dtype] == 0
        kd = k.to(dtype)
        packed = pack_conv3d_weight(kd)
        assert (packed.ci, packed.co) == (33, 40)
        assert packed.data.shape == (27, 64, ci_pad)
        assert packed.data.dtype == dtype
        assert torch.equal(packed.kernel(), kd)
        assert torch.equal(packed.data[4, 7, :33], kd[0, 1, 1, :, 7])
        assert not packed.data[:, 40:].any()
        assert not packed.data[:, :, 33:].any()
        assert (packed.split is None) == (dtype == torch.bfloat16)


@pytest.mark.parametrize("ci,co", [(33, 40), (1, 8), (128, 128)])
def test_packed_float32_weight_has_its_tf32_planes(ci, co):
    """The float32 pack's split: TF32 high parts and remainders (13 low
    bits zero) whose sum is the weight to 2⁻²² of |w|, zero in the
    padding."""
    rng = np.random.RandomState(ci + co)
    k = torch.from_numpy((rng.randn(3, 3, 3, ci, co)
                          * np.exp(rng.uniform(-20, 20, (3, 3, 3, ci, co))))
                         .astype(np.float32))
    packed = pack_conv3d_weight(k)
    hi, lo = packed.split
    assert packed.split.shape == (2, *packed.data.shape)
    assert packed.split.is_contiguous()
    for plane in (hi, lo):
        assert not (plane.view(torch.int32) & 0x1FFF).any()
        assert not plane[:, co:].any() and not plane[:, :, ci:].any()
    w = packed.data.double()
    err = (hi.double() + lo.double() - w).abs()
    assert (err <= 2.0 ** -22 * w.abs()).all()
    assert (lo.double().abs() <= 2.0 ** -11 * w.abs()).all()


def test_tf32_round_is_cvt_rna():
    """To nearest, ties away from zero, on the magnitude's bits: 1 + 2⁻¹¹
    (a tie) rounds to 1 + 2⁻¹⁰, just under it to 1; signs alike; values
    already in TF32, zero and infinities unchanged."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + 2.0 ** -11, 1 + 2.0 ** -11 - 2.0 ** -23,
                      -(1 + 2.0 ** -11), 1 + one_ulp, 0.0, -0.0,
                      float("inf"), float("-inf"), 3.0 * 2.0 ** -130],
                     dtype=torch.float32)
    want = torch.tensor([1 + one_ulp, 1.0, -(1 + one_ulp), 1 + one_ulp,
                         0.0, -0.0, float("inf"), float("-inf"),
                         3.0 * 2.0 ** -130], dtype=torch.float32)
    assert torch.equal(tf32_round(x), want)
    hi, lo = tf32_split(torch.tensor([1 + 2.0 ** -11 + 2.0 ** -20]))
    assert hi.item() == 1 + one_ulp
    assert lo.item() == 2.0 ** -20 - 2.0 ** -11


# GwcNet's and CFNet's channel counts (Ci -> Co), cut to a few planes; the
# ragged Ci 1, 3, 33, 65 (Ci % 4 != 0: the kernel stages them by plain
# loads) and Co 8 / 33
TF32_CASES = [(40, 32), (32, 32), (64, 64), (128, 128), (192, 128),
              (1, 8), (3, 33), (33, 16), (65, 32)]


def _k2_tf32_case(ci, co, seed):
    """x, k (He-scaled, as the models'), scale, bias, residual as torch
    float32; GwcNet's 1/4 volume cut to 3 planes of 10 x 12."""
    rng = np.random.RandomState(seed)
    x = rng.randn(1, 3, 10, 12, ci).astype(np.float32)
    k = (rng.randn(3, 3, 3, ci, co) * (2.0 / (27 * ci)) ** 0.5).astype(
        np.float32)
    scale = (rng.rand(co) + 0.5).astype(np.float32)
    bias = rng.randn(co).astype(np.float32)
    res = rng.randn(1, 3, 10, 12, co).astype(np.float32)
    return [torch.from_numpy(a) for a in (x, k, scale, bias, res)]


def _split_conv_f64(x, packed, terms):
    """The conv of the TF32 split operands with every product summed in
    float64: the error of 3xTF32 (terms 3) or one TF32 product (terms 1)
    alone, without float32's rounding of the sums."""
    (xh, xl), (wh, wl) = tf32_split(x), packed.split
    w = {"h": wh[:, :packed.co, :packed.ci], "l": wl[:, :packed.co, :packed.ci]}
    out = 0
    for a, b in ([("h", "h"), ("l", "h"), ("h", "l")] if terms == 3
                 else [("h", "h")]):
        xa = (xh if a == "h" else xl).double()
        k = w[b].double().unflatten(0, (3, 3, 3)).transpose(3, 4)
        out = out + conv3d_fused_reference(xa, k)
    return out


@pytest.mark.parametrize("ci,co", TF32_CASES)
def test_tf32x3_is_inside_the_float32_gate_and_one_tf32_product_is_not(ci,
                                                                        co):
    """3xTF32's own error ≤ 1e-4 / 5 of max|ref| against the float64 conv
    at every case; one TF32 product's > 1e-4 at every case too, so the
    gate tells the two apart."""
    x, k, *_ = _k2_tf32_case(ci, co, seed=ci * 3 + co)
    packed = pack_conv3d_weight(k)
    want = conv3d_fused_reference(x.double(), k.double())
    ref = want.abs().max().item()
    err3 = (_split_conv_f64(x, packed, 3) - want).abs().max().item() / ref
    err1 = (_split_conv_f64(x, packed, 1) - want).abs().max().item() / ref
    print(f"K2 Ci {ci} Co {co}: 3xTF32 {err3:.2e}, 1xTF32 {err1:.2e} of "
          f"max|ref|")
    assert err3 <= 1e-4 / 5
    assert err1 > 1e-4


@pytest.mark.parametrize("ci,co", TF32_CASES)
@pytest.mark.parametrize("residual,relu", [(False, True), (True, False)])
def test_tf32x3_reference_holds_the_gate_against_the_plain_version(
        ci, co, residual, relu):
    """The float32 kernel's arithmetic (float32 sums, its order) against
    the float32 plain version: inside 1e-4 · max|ref| by 5x; one TF32
    product outside it (without the ReLU, which can clip where it
    errs)."""
    x, k, scale, bias, res = _k2_tf32_case(ci, co, seed=ci + 7 * co)
    res = res if residual else None
    packed = pack_conv3d_weight(k)
    want = conv3d_fused_reference(x, k, scale, bias, res, relu)
    ref = want.abs().max().item()
    got = conv3d_fused_tf32x3_reference(x, packed, scale, bias, res, relu)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-4 / 5 * ref
    if not relu:
        one = conv3d_fused_tf32x3_reference(x, packed, scale, bias, res,
                                            relu, terms=1)
        assert (one - want).abs().max().item() > 1e-4 * ref


@pytest.mark.parametrize("ci,co,residual,relu", [(40, 32, False, True),
                                                 (3, 33, True, False),
                                                 (65, 16, True, True)])
def test_tf32x3_reference_matches_jax_pallas(ci, co, residual, relu):
    """Against the JAX Pallas kernel in interpret mode, within the float32
    kernel's gate."""
    x, k, scale, bias, res = _case(ci * 5 + co, (1, 3, 4, 6), ci, co, True,
                                   residual)
    want = np.asarray(jfused(
        jnp.asarray(x), jnp.asarray(k), jnp.asarray(scale), jnp.asarray(bias),
        None if res is None else jnp.asarray(res), relu=relu, tile_h=2,
        interpret=True))
    got = conv3d_fused_tf32x3_reference(_t(x), pack_conv3d_weight(_t(k)),
                                        _t(scale), _t(bias), _t(res),
                                        relu).numpy()
    _within(got, want, 1e-4 / 5)


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


@pytest.mark.parametrize("shape,co,tile", [
    ((1, 48, 120, 160), 32, (8, 32)),     # GwcNet's full-volume layers
    ((1, 24, 60, 80), 64, (8, 32)),       # hourglass conv2: not 128 x 64
    ((1, 12, 30, 40), 128, (8, 32)),      # hourglass conv4
    ((1, 12, 240, 320), 16, (8, 16)),     # CFNet's 1/2 stage
    ((1, 6, 15, 20), 128, (2, 32)),       # CFNet's 1/32 volume: few blocks
    ((1, 12, 30, 40), 64, (2, 32)),
    ((1, 3, 60, 80), 64, (2, 32)),        # CFNet's 1/2 hourglass bottom
])
def test_float32_tile_is_picked_by_shape(shape, co, tile):
    """float32 never takes the 128 x 64 tile (two weight planes a stage:
    one block an SM); otherwise the bfloat16 rule."""
    got = mma_tile(*shape, co, sms=132, dtype=torch.float32)
    assert MMA_TILES[got] == tile
    assert got != 0


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


def test_variant_needs_each_edit_once_in_the_source(tmp_path, monkeypatch):
    """An edited copy of a source (`_cuda.variant`, for phase stamps and
    planted faults) is refused before anything is written or compiled
    where a text it replaces is missing or occurs twice."""
    (tmp_path / "k.cu").write_text("a;\nb;\nb;\n")
    monkeypatch.setattr(_cuda, "CSRC", tmp_path)
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    for old in ("c;", "b;"):
        with pytest.raises(RuntimeError, match="not in k.cu once"):
            _cuda.variant("k", "edited", subs=((old, "x;"),))
    assert not (tmp_path / "build").exists()


def test_loaded_as_puts_the_library_back(monkeypatch):
    """The wrappers launch a variant's kernels only inside `loaded_as`,
    and the library they loaded before once it ends, also on an error."""
    monkeypatch.setattr(_cuda, "_libs", {"k": "built"})
    with _cuda.loaded_as("k", "variant"):
        assert _cuda.library("k") == "variant"
    with pytest.raises(ValueError):
        with _cuda.loaded_as("k", "variant"):
            raise ValueError
    assert _cuda.library("k") == "built"
