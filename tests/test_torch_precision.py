"""The port's precision contract, on the CPU.

- float32: a model's float32 forward computes in full float32. It turns
  cuDNN's and cuBLAS's TF32 off for its length, whatever the process-global
  flags are, and gives the caller's settings back, also after an exception
  (`utils.precision.full_float32`).
- bfloat16: ``create_model(..., dtype=torch.bfloat16)`` is the JAX package's
  ``dtype=jnp.bfloat16``: conv, linear and attention parameters in bfloat16,
  what ``models.keeps_float32`` names in float32 (every BatchNorm's values,
  so the folded BatchNorm is the float32 model's bit for bit; LayerNorms,
  DINOv2's token-stream params, CFNet's search-range scales:
  ``tests/test_torch_bf16_contract.py`` holds those against JAX). GwcNet_G and
  PSMNet in bfloat16 are held against JAX ``GwcNet_G(dtype=jnp.bfloat16)``
  and ``PSMNet(dtype=jnp.bfloat16)`` on the same carried variables (the
  fixtures of ``tests/test_torch_gwcnet.py`` and
  ``tests/test_torch_psmnet.py``); PSMNet with JAX's SPP pool summed in
  float32, as the port sums it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gwcnet as gwcnet_fixture
import test_torch_psmnet as psmnet_fixture
from stereo_toolbox_tpu.models import GwcNet_G as JaxGwcNet_G
from stereo_toolbox_tpu.models import PSMNet as JaxPSMNet
from stereo_toolbox_tpu.models import psmnet as jax_psmnet
from stereo_toolbox_tpu.nn.layers import avg_pool as jax_avg_pool
from stereo_toolbox_tpu_torch.models import create_model, keeps_float32
from stereo_toolbox_tpu_torch.nn.layers import ConvBNAct, avg_pool
from stereo_toolbox_tpu_torch.utils.precision import full_float32
from stereo_toolbox_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

BATCHNORMS = (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)

# small sizes each model takes: (constructor arguments, input H, W)
SMALL = {
    "GwcNet_G": (dict(max_disp=16), 32, 64),
    "GwcNet_GC": (dict(max_disp=16), 32, 64),
    "CFNet": (dict(max_disp=64), 64, 128),
    "ACVNet": (dict(max_disp=48), 64, 128),
    "DepthAnythingV2": (dict(encoder="vits"), 28, 42),
    "PSMNet": (dict(max_disp=16), 32, 64),
    "PCWNet_G": (dict(max_disp=64), 64, 128),
    "PCWNet_GC": (dict(max_disp=64), 64, 128),
}


def _inputs(name, h, w):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, h, w, 3).astype(np.float32))
    return (x,) if name == "DepthAnythingV2" else (x, x.roll(-2, 2))


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on():
    """Both global TF32 flags True for the test; PyTorch's defaults back
    after it (cuDNN's TF32 on, cuBLAS's off)."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")


def _first_conv(model):
    return next(m for m in model.modules() if isinstance(m, torch.nn.Conv2d))


@pytest.mark.parametrize("name", sorted(SMALL))
def test_float32_forward_runs_without_tf32(name, tf32_on):
    kw, h, w = SMALL[name]
    model = create_model(name, device="cpu", **kw)
    seen = []
    handle = _first_conv(model).register_forward_pre_hook(
        lambda mod, inp: seen.append(_tf32_flags()))
    with torch.no_grad():
        model(*_inputs(name, h, w))
    handle.remove()
    assert seen == [(False, False)]
    assert _tf32_flags() == (True, True)
    assert torch.get_float32_matmul_precision() == "high"


@pytest.mark.parametrize("name", sorted(SMALL))
def test_float32_forward_restores_the_flags_after_an_exception(name,
                                                               tf32_on):
    kw, h, w = SMALL[name]
    model = create_model(name, device="cpu", **kw)

    def fail(mod, inp):
        raise RuntimeError("stop inside the forward")

    _first_conv(model).register_forward_pre_hook(fail)
    with pytest.raises(RuntimeError, match="stop inside"):
        with torch.no_grad():
            model(*_inputs(name, h, w))
    assert _tf32_flags() == (True, True)


def test_full_float32_keeps_a_callers_settings(tf32_on):
    """The caller's values come back whatever they were and through
    whichever API they were set with, and ``enabled=False`` changes
    nothing."""
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("medium")
    with full_float32():
        assert _tf32_flags() == (False, False)
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "medium"
    torch.backends.cudnn.allow_tf32 = True
    with full_float32(enabled=False):
        assert torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "medium"
    # a flag set with the legacy API after the precision: PyTorch can no
    # longer read the precision, and the forward must still run
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = False
    for _ in range(2):
        with full_float32():
            assert _tf32_flags() == (False, False)
        assert _tf32_flags() == (True, False)


def test_full_float32_keeps_per_operator_settings(tf32_on):
    """TF32 set per operator (PyTorch's newer API) comes back as it was."""
    backends = torch.backends
    if not hasattr(backends.cuda.matmul, "fp32_precision"):
        pytest.skip("this PyTorch has no per-operator TF32 settings")
    backends.cudnn.conv.fp32_precision = "tf32"
    backends.cudnn.rnn.fp32_precision = "ieee"
    backends.cuda.matmul.fp32_precision = "tf32"
    with full_float32():
        assert _tf32_flags() == (False, False)
    assert (backends.cudnn.conv.fp32_precision,
            backends.cudnn.rnn.fp32_precision,
            backends.cuda.matmul.fp32_precision) == ("tf32", "ieee", "tf32")
    backends.cudnn.allow_tf32 = True             # the fixture's restore
    backends.cuda.matmul.allow_tf32 = True


def test_bfloat16_forward_leaves_the_flags_alone(tf32_on):
    """Only a float32 forward enters the contract: a bfloat16 one sees the
    caller's flags."""
    kw, h, w = SMALL["GwcNet_G"]
    model = create_model("GwcNet_G", device="cpu", dtype=torch.bfloat16,
                         **kw)
    seen = []
    _first_conv(model).register_forward_pre_hook(
        lambda mod, inp: seen.append(_tf32_flags()))
    with torch.no_grad():
        model(*_inputs("GwcNet_G", h, w))
    assert seen == [(True, True)]


def _perturb_norms(model, seed):
    """BatchNorm values away from their initial 1 / 0, with means large
    against the spread (a trained checkpoint's, where rounding them to bf16
    shows)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BATCHNORMS):
                for t in (m.weight, m.bias):
                    t.copy_(1 + 0.3 * torch.randn(t.shape, generator=gen))
                m.running_mean.copy_(
                    5 * torch.randn(m.running_mean.shape, generator=gen))
                m.running_var.copy_(
                    0.5 + torch.rand(m.running_var.shape, generator=gen))


BN_MODELS = ["ACVNet", "CFNet", "GwcNet_G", "GwcNet_GC", "PSMNet",
             "PCWNet_G", "PCWNet_GC"]


@pytest.mark.parametrize("name", BN_MODELS)
def test_bfloat16_model_keeps_batchnorm_values_in_float32(name):
    kw, _, _ = SMALL[name]
    f32 = create_model(name, device="cpu", **kw)
    _perturb_norms(f32, 1)
    bf16 = create_model(name, device="cpu", dtype=torch.bfloat16, **kw)
    bf16.load_state_dict(f32.state_dict())
    norms = [(a, b) for a, b in zip(f32.modules(), bf16.modules())
             if isinstance(a, BATCHNORMS)]
    assert norms
    for a, b in norms:
        for key, t in b.state_dict().items():
            if t.is_floating_point():
                assert t.dtype == torch.float32, key
                assert torch.equal(t, a.state_dict()[key]), key
    rest = [(key, p) for m in bf16.modules()
            for key, p in m.named_parameters(recurse=False)
            if not keeps_float32(m, key)]
    assert rest and all(p.dtype == torch.bfloat16 for _, p in rest)
    kept = {key for m in bf16.modules()
            for key, p in m.named_parameters(recurse=False)
            if keeps_float32(m, key) and not isinstance(m, BATCHNORMS)}
    assert kept == ({"gamma_s3", "beta_s3", "gamma_s2", "beta_s2"}
                    if name == "CFNet" else set())


def test_bfloat16_depth_anything_v2_keeps_its_stream_params_in_float32():
    """DepthAnythingV2 has no BatchNorm. Its LayerNorms, ``cls_token``,
    ``pos_embed`` and LayerScale ``gamma`` stay float32, as the JAX
    package's params (its token stream is float32); every other parameter
    is bfloat16, and the depth comes out in bfloat16."""
    kw, h, w = SMALL["DepthAnythingV2"]
    model = create_model("DepthAnythingV2", device="cpu",
                         dtype=torch.bfloat16, **kw)
    assert not any(isinstance(m, BATCHNORMS) for m in model.modules())
    f32 = {key for key, p in model.named_parameters()
           if p.dtype == torch.float32}
    depth = len(model.pretrained.blocks)
    # per block norm1, norm2 (weight, bias), ls1, ls2; the final norm
    assert len(f32) == 2 + 6 * depth + 2
    for key, p in model.named_parameters():
        want = ("norm" in key or key.endswith(("cls_token", "pos_embed",
                                               ".gamma")))
        assert (key in f32) == want, key
        assert p.dtype in (torch.float32, torch.bfloat16), key
    with torch.no_grad():
        depth = model(*_inputs("DepthAnythingV2", h, w))
    assert depth.dtype == torch.bfloat16
    assert bool(torch.isfinite(depth.float()).all())


@pytest.mark.parametrize("name", BN_MODELS)
def test_bfloat16_folded_batchnorm_equals_float32(name):
    """Each fused layer's folded affine is the float32 model's bit for bit;
    ``model.to(torch.bfloat16)`` rounds the statistics first and is not."""
    kw, _, _ = SMALL[name]
    f32 = create_model(name, device="cpu", **kw)
    _perturb_norms(f32, 2)
    bf16 = create_model(name, device="cpu", dtype=torch.bfloat16, **kw)
    bf16.load_state_dict(f32.state_dict())
    cast = create_model(name, device="cpu", **kw).to(torch.bfloat16)
    cast.load_state_dict(f32.state_dict())
    layers = [(a, b, c) for a, b, c in zip(f32.modules(), bf16.modules(),
                                           cast.modules())
              if isinstance(a, ConvBNAct)]
    assert layers
    rounded = 0
    for a, b, c in layers:
        want = a.folded_affine()
        got = b.folded_affine()
        assert all(torch.equal(x, y) for x, y in zip(got, want))
        rounded += not all(torch.equal(x, y)
                           for x, y in zip(c.folded_affine(), want))
    assert rounded == len(layers)


def test_create_model_takes_float32_or_bfloat16():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        create_model("GwcNet_G", device="cpu", dtype=torch.float16)


@pytest.fixture(scope="module")
def jax_setup():
    return gwcnet_fixture._setup(JaxGwcNet_G)


def test_gwcnet_g_bfloat16_matches_jax_bfloat16(jax_setup):
    """Port bf16 against JAX ``GwcNet_G(dtype=jnp.bfloat16)`` on the same
    variables, 64×128, max_disp 48. Measured on the CPU: mean |Δ| 0.0179 px,
    max 0.104 px (printed below): bf16 roundings in other places, amplified
    by the soft argmax. Bounds: mean < 0.03, max < 0.2 px."""
    v, left, right, _ = jax_setup
    model = JaxGwcNet_G(max_disp=gwcnet_fixture.MAX_DISP, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(lambda vv, a, b: model.apply(
        vv, a, b, train=False))(v, jnp.asarray(left), jnp.asarray(right)),
        dtype=np.float32)
    m = create_model("GwcNet_G", max_disp=gwcnet_fixture.MAX_DISP,
                     device="cpu", dtype=torch.bfloat16)
    m.load_state_dict(from_jax_variables("GwcNet_G", v))
    with torch.no_grad():
        got = m(torch.from_numpy(left), torch.from_numpy(right)).float()
    d = np.abs(got.numpy() - want)
    print(f"GwcNet_G bf16 port vs JAX bf16: mean |d| {d.mean():.4f} px, "
          f"max {d.max():.4f} px")
    assert got.shape == (1, gwcnet_fixture.H, gwcnet_fixture.W)
    assert d.mean() < 0.03
    assert d.max() < 0.2


@pytest.fixture(scope="module")
def psmnet_setup():
    return psmnet_fixture.setup(sizes=((64, 128),))


def _jax_avg_pool_summed_in_float32(x, window, stride=None):
    """The JAX package's ``avg_pool`` with its window summed in float32 and
    the mean rounded once to x's type."""
    return jax_avg_pool(x.astype(jnp.float32), window, stride).astype(x.dtype)


def test_avg_pool_rounds_once_where_jax_bfloat16_sums_in_bfloat16():
    """The port's bf16 average pool is the exact mean of its inputs rounded
    once (within one bf16 ulp, 2^-8 relative); the JAX package's bf16
    ``avg_pool`` sums its window in bf16 (``lax.reduce_window``), 2-5%
    off the mean at PSMNet's SPP windows at 64×128 (8×8 to 16×32), more at
    its real 64×64 windows. A known deviation of the reference
    (ROADMAP.md, Queue 3)."""
    x = np.random.RandomState(0).rand(1, 16, 32, 128).astype(np.float32)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    for window in ((16, 32), (8, 8)):
        exact = np.asarray(jax_avg_pool(jnp.asarray(xb), window))
        port = avg_pool(torch.from_numpy(xb).bfloat16(), window).float()
        jax_bf16 = np.asarray(jax_avg_pool(jnp.asarray(xb, jnp.bfloat16),
                                           window), np.float32)
        assert np.abs(port.numpy() - exact).max() <= 2 ** -8 * exact.max()
        assert np.abs(jax_bf16 - exact).max() > 0.01 * exact.max()


def test_psmnet_bfloat16_matches_jax_bfloat16(psmnet_setup, monkeypatch):
    """Port bf16 against JAX ``PSMNet(dtype=jnp.bfloat16)`` on the same
    variables, 64×128, max_disp 48, with JAX's SPP pool summed in float32
    (its bf16 sum, test above, puts JAX's bf16 forward 0.162 px from its
    own f32 forward, and 0.168 px from the port's bf16). Measured on the
    CPU: mean |Δ| 0.038 px, max 0.217 px; each bf16 forward is as far from
    JAX's f32 forward at every stage (feature 1.5% / 1.6%, dres0 1.9% /
    1.9%, first hourglass 3.7% / 3.6%; output 0.034 / 0.041 px): two
    correct roundings, amplified by the random-weight stack twice as much
    as GwcNet_G's (0.018 px above). Bounds: mean < 0.05, max < 0.3 px, and
    the port's bf16 no further from the f32 forward than 1.5× JAX's."""
    v, runs = psmnet_setup
    left, right, want_f32 = runs[(64, 128)]
    monkeypatch.setattr(jax_psmnet, "avg_pool",
                        _jax_avg_pool_summed_in_float32)
    model = JaxPSMNet(max_disp=psmnet_fixture.MAX_DISP, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(lambda vv, a, b: model.apply(
        vv, a, b, train=False))(v, jnp.asarray(left), jnp.asarray(right)),
        dtype=np.float32)
    m = create_model("PSMNet", max_disp=psmnet_fixture.MAX_DISP,
                     device="cpu", dtype=torch.bfloat16)
    m.load_state_dict(from_jax_variables("PSMNet", v))
    with torch.no_grad():
        got = m(torch.from_numpy(left), torch.from_numpy(right)).float()
    d = np.abs(got.numpy() - want)
    port_err = np.abs(got.numpy() - want_f32).mean()
    jax_err = np.abs(want - want_f32).mean()
    print(f"PSMNet bf16 port vs JAX bf16: mean |d| {d.mean():.4f} px, "
          f"max {d.max():.4f} px; from the f32 forward: port "
          f"{port_err:.4f}, JAX {jax_err:.4f} px mean")
    assert got.shape == (1, 64, 128)
    assert d.mean() < 0.05
    assert d.max() < 0.3
    assert port_err <= 1.5 * jax_err
