"""Port blocks against the JAX blocks, with weights carried by
``utils.weights.JaxToTorch`` and BatchNorm statistics perturbed so the eval
affine is not the identity. Inputs from numpy; tolerance 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stereo_toolbox_tpu.nn import layers as jl
from stereo_toolbox_tpu_torch.nn import (BasicResBlock, ConvBNAct,
                                         ConvTransposeBN, dual_view_apply)
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
    m = ConvBNAct(8, 8, 3, dims=3, relu=False)
    got = _port(m, sd, x, residual=torch.from_numpy(r))
    np.testing.assert_allclose(got, want + r, **TOL)
    m = ConvBNAct(8, 8, 3, dims=3, relu=True)
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
