"""Port blocks against the JAX blocks, with weights carried by
``utils.weights.JaxToTorch`` and BatchNorm statistics perturbed so the eval
affine is not the identity. Inputs from numpy; tolerance 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stereo_toolbox_tpu.models.cfnet import HourglassMish, mish
from stereo_toolbox_tpu.nn import layers as jl
from stereo_toolbox_tpu_torch.models import create_model
from stereo_toolbox_tpu_torch.nn import (BasicResBlock, ConvBNAct,
                                         ConvTransposeBN, HourglassRedir,
                                         dual_view_apply, layers)
from stereo_toolbox_tpu_torch.nn.layers import Conv3dSame, DerivedCache
from stereo_toolbox_tpu_torch.ops.conv3d import pack_concat_conv3d_weight
from stereo_toolbox_tpu_torch.ops.conv3d_fused import (conv3d_fused,
                                                       pack_conv3d_weight)
from stereo_toolbox_tpu_torch.utils.weights import _hourglass
from stereo_toolbox_tpu_torch.utils.weights import JaxToTorch

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_run(module, x, seed=0):
    """Init `module` on x, perturb batch_stats, apply in eval; returns
    (numpy variables, numpy output)."""
    rng = np.random.RandomState(seed)
    xj = jnp.asarray(x)
    v = jax.tree_util.tree_map(np.asarray, module.init(
        jax.random.PRNGKey(seed), xj, train=False))
    v = {"params": v["params"],
         "batch_stats": jax.tree_util.tree_map(
             lambda a: a + 0.1 * np.abs(rng.randn(*a.shape)).astype(a.dtype),
             v["batch_stats"])}
    return v, np.asarray(module.apply(v, xj, train=False))


def _carry(v, pairs):
    t = JaxToTorch(v)
    for kind, path, key in pairs:
        getattr(t, kind)(path, key)
    return t.state_dict()


def _port(module, sd, x, **kw):
    module.load_state_dict(sd)
    module.eval()
    with torch.no_grad():
        return module(torch.from_numpy(x), **kw).numpy()


CONVBN = [("conv", "Conv_0", "0"), ("bn", "BatchNorm_0", "1")]


@pytest.mark.parametrize("name,shape,ci,co,stride,dilation,dims", [
    ("2d_dilated", (2, 9, 11), 8, 16, 1, 2, 2),
    ("3d_stride2", (1, 6, 8, 10), 4, 8, 2, 1, 3),
    ("3d_fusible", (1, 4, 6, 8), 8, 8, 1, 1, 3),
])
def test_convbnact_matches_jax(name, shape, ci, co, stride, dilation, dims):
    x = np.random.RandomState(1).randn(*shape, ci).astype(np.float32)
    v, want = _jax_run(jl.ConvBNAct(co, 3, stride, dilation=dilation), x)
    m = ConvBNAct(ci, co, 3, stride, dilation=dilation, dims=dims)
    assert m.fusible == (name == "3d_fusible")
    got = _port(m, _carry(v, CONVBN), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_convbnact_residual_is_added_before_relu():
    """``forward(x, residual)`` = JAX ``act(bn(conv(x))) + r`` with no act,
    and relu(bn(conv(x)) + r) with it."""
    rng = np.random.RandomState(2)
    x = rng.randn(1, 4, 5, 6, 8).astype(np.float32)
    r = rng.randn(1, 4, 5, 6, 8).astype(np.float32)
    v, want = _jax_run(jl.ConvBNAct(8, 3, act=None), x)
    sd = _carry(v, CONVBN)
    m = ConvBNAct(8, 8, 3, dims=3, act=None)
    got = _port(m, sd, x, residual=torch.from_numpy(r))
    np.testing.assert_allclose(got, want + r, **TOL)
    m = ConvBNAct(8, 8, 3, dims=3, act="relu")
    got = _port(m, sd, x, residual=torch.from_numpy(r))
    np.testing.assert_allclose(got, np.maximum(want + r, 0.0), **TOL)


def test_conv_transpose_bn_matches_jax():
    x = np.random.RandomState(3).randn(1, 3, 4, 5, 8).astype(np.float32)
    v, want = _jax_run(jl.ConvTransposeBN(6, 3, 2), x)
    sd = _carry(v, [("conv_transpose", "ConvTranspose_0", "0"),
                    ("bn", "BatchNorm_0", "1")])
    got = _port(ConvTransposeBN(8, 6), sd, x)
    assert got.shape == (1, 6, 8, 10, 6)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("ci,planes,stride,dilation,downsample", [
    (8, 16, 2, 1, True),
    (8, 8, 1, 2, False),
])
def test_basic_res_block_matches_jax(ci, planes, stride, dilation,
                                     downsample):
    x = np.random.RandomState(4).randn(2, 8, 10, ci).astype(np.float32)
    v, want = _jax_run(jl.BasicResBlock(planes, stride, dilation,
                                        downsample=downsample), x)
    pairs = [("convbn", "ConvBNAct_0", "conv1.0"),
             ("convbn", "ConvBNAct_1", "conv2")]
    if downsample:
        pairs.append(("convbn", "ConvBNAct_2", "downsample"))
    t = JaxToTorch(v)
    for _, path, key in pairs:
        t.convbn(path, f"{key}.0", f"{key}.1")
    got = _port(BasicResBlock(ci, planes, stride, dilation, downsample),
                t.state_dict(), x)
    np.testing.assert_allclose(got, want, **TOL)


def test_dual_view_apply_eval_equals_two_calls():
    m = ConvBNAct(3, 4, 3).eval()
    rng = np.random.RandomState(5)
    a, b = (torch.from_numpy(rng.randn(2, 6, 7, 3).astype(np.float32))
            for _ in range(2))
    with torch.no_grad():
        fa, fb = dual_view_apply(lambda z: {"f": m(z)}, a, b)
        torch.testing.assert_close(fa["f"], m(a), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(fb["f"], m(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("padding,fused", [(0, False), (1, True)])
def test_convbnact_fuses_only_with_padding_one(padding, fused):
    """A 3×3×3 stride-1 layer with an explicit padding other than 1 keeps
    its padding in eval: it is not lowered to the SAME-padded fused conv."""
    m = ConvBNAct(4, 6, 3, 1, padding=padding, dims=3)
    assert m.fusible == fused
    rng = np.random.RandomState(6)
    with torch.no_grad():
        for buf in (m[1].running_mean, m[1].running_var):
            buf += 0.1 * torch.from_numpy(np.abs(rng.randn(6)).astype(
                np.float32))
    x = torch.from_numpy(rng.randn(1, 5, 6, 7, 4).astype(np.float32))
    m.eval()
    with torch.no_grad():
        got = m(x)
        want = F.relu(m[1](m[0](x.movedim(-1, 1)))).movedim(1, -1)
    assert got.shape == (1, 5 - 2 + 2 * padding, 6 - 2 + 2 * padding,
                         7 - 2 + 2 * padding, 6)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("dims,shape", [(2, (2, 9, 11)), (3, (1, 4, 6, 8))])
def test_convbnact_mish_matches_jax(dims, shape):
    """Mish after the conv (in 3D, after the fused kernel's epilogue)."""
    x = np.random.RandomState(7).randn(*shape, 8).astype(np.float32)
    v, want = _jax_run(jl.ConvBNAct(8, 3, act=mish), x)
    m = ConvBNAct(8, 8, 3, dims=dims, act="mish")
    assert m.fusible == (dims == 3)
    np.testing.assert_allclose(_port(m, _carry(v, CONVBN), x), want, **TOL)


def test_convbnact_rejects_unknown_activation():
    with pytest.raises(ValueError):
        ConvBNAct(4, 4, 3, act="gelu")


def test_hourglass_mish_matches_jax():
    """CFNet's Mish hourglass: the port's HourglassRedir with act="mish"."""
    x = np.random.RandomState(8).randn(1, 4, 8, 12, 8).astype(np.float32)
    v, want = _jax_run(HourglassMish(8), x)
    t = JaxToTorch({c: {"hg": tree} for c, tree in v.items()})
    _hourglass(t, "hg", "hg")
    sd = {k.removeprefix("hg."): a for k, a in t.state_dict().items()}
    np.testing.assert_allclose(_port(HourglassRedir(8, act="mish"), sd, x),
                               want, **TOL)


# ---------------------------------------------------------------- eval cache
def _fused_layer(seed=9, act="relu"):
    """A fusible 3D ConvBNAct in eval with perturbed BatchNorm statistics,
    and an input for it."""
    gen = torch.Generator().manual_seed(seed)
    m = ConvBNAct(6, 5, 3, 1, dims=3, act=act)
    with torch.no_grad():
        m[0].weight.normal_(0.0, 0.2, generator=gen)
        m[1].running_mean.normal_(0.0, 0.1, generator=gen)
        m[1].running_var.uniform_(0.5, 1.5, generator=gen)
        m[1].weight.uniform_(0.5, 1.5, generator=gen)
        m[1].bias.normal_(0.0, 0.1, generator=gen)
    x = torch.randn(1, 3, 4, 5, 6, generator=gen)
    return m.eval(), x


def _uncached(m, x, residual=None):
    """The fused layer's forward from its parameters, nothing kept."""
    scale, bias = m.folded_affine()
    return conv3d_fused(x, m[0].weight.permute(2, 3, 4, 1, 0).to(x.dtype),
                        scale, bias, residual, relu=m.act == "relu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cached_fused_layer_matches_the_uncached_path_bit_for_bit(dtype):
    m, x = _fused_layer()
    m = m.to(dtype)
    x = x.to(dtype)
    r = torch.randn(1, 3, 4, 5, 5, generator=torch.Generator().manual_seed(3)
                    ).to(dtype)
    with torch.no_grad():
        for _ in range(2):            # cold, then warm
            assert torch.equal(m(x), _uncached(m, x))
            assert torch.equal(m(x, residual=r), _uncached(m, x, r))


def test_in_place_edit_of_running_var_changes_the_output():
    m, x = _fused_layer()
    with torch.no_grad():
        before = m(x)
        m[1].running_var.mul_(4.0)
        after = m(x)
    assert not torch.equal(before, after)
    assert torch.equal(after, _uncached(m, x))


def test_load_state_dict_changes_the_output():
    m, x = _fused_layer(seed=9)
    other, _ = _fused_layer(seed=10)
    with torch.no_grad():
        before = m(x)
        m.load_state_dict(other.state_dict())
        after = m(x)
    assert not torch.equal(before, after)
    assert torch.equal(after, other(x))


def test_train_then_eval_rebuilds_the_cache(monkeypatch):
    m, x = _fused_layer()
    folds = []
    fold = ConvBNAct.folded_affine
    monkeypatch.setattr(ConvBNAct, "folded_affine",
                        lambda self: folds.append(1) or fold(self))
    with torch.no_grad():
        first = m(x)
        m(x)
        assert len(folds) == 1
        m.train().eval()
        assert torch.equal(m(x), first)
    assert len(folds) == 2


def test_conv3d_same_keeps_its_kernel_until_the_weight_changes():
    gen = torch.Generator().manual_seed(11)
    m = Conv3dSame(4, 1).eval()
    x = torch.randn(1, 3, 4, 5, 4, generator=gen)
    with torch.no_grad():
        first = m(x)
        kept = next(iter(m._derived.values()))[1]
        assert torch.equal(m(x), first)
        assert next(iter(m._derived.values()))[1] is kept
        m.weight.mul_(2.0)
        torch.testing.assert_close(m(x), 2.0 * first)
    assert next(iter(m._derived.values()))[1] is not kept


@pytest.mark.parametrize("name,h,w,max_disp", [
    ("GwcNet_G", 64, 128, 48), ("GwcNet_GC", 64, 128, 48),
    ("CFNet", 64, 128, 64), ("ACVNet", 80, 144, 48),
    ("PSMNet", 64, 128, 48)])
def test_warm_forward_refolds_and_copies_no_weight(monkeypatch, name, h, w,
                                                   max_disp):
    """Over two eval forwards, each fused layer (and PSMNet's concat-volume
    layer) folds its BatchNorm and packs its kernel once, and each
    classifier conv copies its kernel once: the second forward derives
    nothing."""
    m = create_model(name, max_disp=max_disp, device="cpu")
    calls = {"fold": 0, "pack": 0}
    fold = ConvBNAct.folded_affine

    def counted_fold(self):
        calls["fold"] += 1
        return fold(self)

    def counted_pack(kernel):
        calls["pack"] += 1
        return pack_conv3d_weight(kernel)
    def counted_concat_pack(*args, **kwargs):
        calls["pack"] += 1
        return pack_concat_conv3d_weight(*args, **kwargs)
    monkeypatch.setattr(ConvBNAct, "folded_affine", counted_fold)
    monkeypatch.setattr(layers, "pack_conv3d_weight", counted_pack)
    monkeypatch.setattr(layers, "pack_concat_conv3d_weight",
                        counted_concat_pack)
    rng = np.random.RandomState(12)
    left, right = (torch.from_numpy(rng.randn(1, h, w, 3).astype(np.float32))
                   for _ in range(2))
    def kept():
        """What each module that ran its kernel's lowering keeps."""
        return {id(mod): list(mod.__dict__["_derived"].values())
                for mod in m.modules()
                if isinstance(mod, DerivedCache) and mod.__dict__.get(
                    "_derived")}
    with torch.no_grad():
        m(left, right)
        first = kept()
        fused = [mod for mod in m.modules()
                 if isinstance(mod, ConvBNAct) and id(mod) in first]
        assert fused and calls == {"fold": len(fused), "pack": len(fused)}
        assert any(isinstance(mod, Conv3dSame) and id(mod) in first
                   for mod in m.modules())
        m(left, right)
    assert calls == {"fold": len(fused), "pack": len(fused)}
    second = kept()
    assert second.keys() == first.keys()
    assert all(a[1] is b[1] for key in first
               for a, b in zip(first[key], second[key]))
