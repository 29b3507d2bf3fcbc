"""Kernels without a backward refuse an input that requires grad.

A CUDA kernel's wrapper returns a fresh tensor without a ``grad_fn``: with
autograd on, an input that requires grad would lose its gradient with no
error. The wrappers of K2 and K3 raise instead (`ops._cuda.refuse_grad`),
naming the path that trains through cuDNN or autograd; K1, K4, K5, K6 and
K7 have backward kernels and are differentiable (the samples of K4 and K5
may require grad: they get none). On the CPU the wrappers run their plain
versions, which autograd differentiates; here the device check is
monkeypatched so that CPU tensors take the card's path up to the launch.
"""

import pytest
import torch

from stereo_toolbox_tpu_torch.ops import _cuda
from stereo_toolbox_tpu_torch.ops.attention import attention
from stereo_toolbox_tpu_torch.ops.conv3d import conv3d
from stereo_toolbox_tpu_torch.ops.conv3d_fused import (conv3d_fused,
                                                       pack_conv3d_weight)
from stereo_toolbox_tpu_torch.ops.volume import (build_concat_volume,
                                                 build_gwc_volume,
                                                 gather_right_by_samples,
                                                 gwc_volume_from_samples)


def _calls(requires_grad):
    """Each K2-K7 wrapper on small CPU tensors, the features (and the
    samples) requiring grad or not; with the name its error gives and the
    train path it names, None for a kernel with a backward."""
    def feat(*shape):
        return torch.randn(*shape).requires_grad_(requires_grad)
    x = feat(1, 2, 3, 4, 8)
    k = torch.randn(3, 3, 3, 8, 8)
    f = feat(1, 2, 5, 8)
    samples = torch.zeros(1, 3, 2, 5).requires_grad_(requires_grad)
    q = feat(1, 2, 4, 64)
    return [
        ("conv3d_fused (K2)", "ConvBNAct", lambda: conv3d_fused(x, k)),
        ("conv3d_fused (K2)", "ConvBNAct",
         lambda: conv3d_fused(x, pack_conv3d_weight(k))),
        ("conv3d (K3)", "Conv3dSame",
         lambda: conv3d(x, torch.randn(3, 3, 3, 8, 1))),
        ("gather_right_by_samples (K4)", None,
         lambda: gather_right_by_samples(f, samples, 4)),
        ("gwc_volume_from_samples (K5)", None,
         lambda: gwc_volume_from_samples(f, f, samples, 2, 4)),
        ("build_concat_volume (K6)", None,
         lambda: build_concat_volume(f, f, 3)),
        ("attention (K7)", None, lambda: attention(q, q, q, 0.125)),
    ]


@pytest.fixture
def card_path(monkeypatch):
    """CPU tensors take the wrappers' card path."""
    monkeypatch.setattr(_cuda, "on_cpu", lambda t: False)


@pytest.mark.parametrize("index", range(7))
def test_wrappers_refuse_an_input_that_requires_grad(card_path, index):
    """K2 and K3 refuse; K4, K5, K6 and K7, autograd Functions with a
    backward kernel, take the input and stop at the device check, past
    the point where the others refuse."""
    what, instead, call = _calls(True)[index]
    if instead is None:
        with pytest.raises(ValueError, match="device"):
            call()
        return
    with pytest.raises(RuntimeError, match="no backward") as err:
        call()
    assert what in str(err.value) and instead in str(err.value)


@pytest.mark.parametrize("index", range(7))
def test_the_refusal_is_the_gradient_check(card_path, index):
    """Without grad (no input requires it, or autograd off) the same calls
    pass the check and stop at the device check: a CPU tensor is no CUDA
    tensor."""
    _, _, call = _calls(False)[index]
    with pytest.raises(ValueError, match="device"):
        call()
    _, _, call = _calls(True)[index]
    with torch.no_grad(), pytest.raises(ValueError, match="device"):
        call()


def test_k1_takes_an_input_that_requires_grad(card_path):
    """K1 is exempt: its wrapper is an autograd Function (here it stops at
    the device check, past the point where the others refuse)."""
    f = torch.randn(1, 2, 5, 8, requires_grad=True)
    with pytest.raises(ValueError, match="device"):
        build_gwc_volume(f, f, 3, 2)


def test_plain_versions_stay_differentiable_on_the_cpu():
    for _, _, call in _calls(True):
        out = call()
        assert out.requires_grad
        out.float().sum().backward()
