"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where ``torch.cuda.is_available()`` is
false. On a machine with an NVIDIA Hopper card and ``nvcc``:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py -q

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine need not have.)
"""

import pytest
import torch

from stereo_toolbox_tpu_torch.ops import (build_gwc_volume, conv3d_fused,
                                          conv3d_fused_reference,
                                          gwc_volume_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("b,h,w,c,d,g", [(1, 4, 40, 320, 12, 40),
                                         (2, 3, 37, 48, 48, 16)])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_gwc_volume_kernel_matches_plain(dev, b, h, w, c, d, g, dtype, rel):
    gen = torch.Generator().manual_seed(0)
    left, right = (torch.randn(b, h, w, c, generator=gen).to(dev, dtype)
                   for _ in range(2))
    key = (b, h, w, c, d, g)
    before = build_gwc_volume.launches, build_gwc_volume.shapes[key]
    got = build_gwc_volume(left, right, d, g).float()
    assert (build_gwc_volume.launches,
            build_gwc_volume.shapes[key]) == (before[0] + 1, before[1] + 1)
    want = gwc_volume_reference(left.float(), right.float(), d, g)
    assert (got - want).abs().max().item() <= rel * want.abs().max().item()


@pytest.mark.parametrize("ci,co,residual,relu", [(40, 32, False, True),
                                                 (12, 40, True, True),
                                                 (64, 64, True, False)])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_conv3d_fused_kernel_matches_plain(dev, ci, co, residual, relu,
                                           dtype, rel):
    gen = torch.Generator().manual_seed(1)
    shape = (2, 5, 7, 37)
    x = torch.randn(*shape, ci, generator=gen).to(dev, dtype)
    k = (torch.randn(3, 3, 3, ci, co, generator=gen) * 0.1).to(dev, dtype)
    scale = (torch.rand(co, generator=gen) + 0.5).to(dev)
    bias = torch.randn(co, generator=gen).to(dev)
    res = (torch.randn(*shape, co, generator=gen).to(dev, dtype)
           if residual else None)
    key = (*shape, ci, co, residual, relu)
    before = conv3d_fused.launches, conv3d_fused.shapes[key]
    got = conv3d_fused(x, k, scale, bias, res, relu).float()
    assert (conv3d_fused.launches,
            conv3d_fused.shapes[key]) == (before[0] + 1, before[1] + 1)
    want = conv3d_fused_reference(x.float(), k.float(), scale, bias,
                                  None if res is None else res.float(), relu)
    assert (got - want).abs().max().item() <= rel * want.abs().max().item()


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(1, 2, 3, 4, 8, device=dev, dtype=torch.float16)
    k = torch.zeros(3, 3, 3, 8, 8, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        conv3d_fused(x, k)
    with pytest.raises(ValueError):
        conv3d_fused(x.float().transpose(2, 3), k.float())
    f = torch.zeros(1, 2, 3, 8, device=dev)
    with pytest.raises(ValueError):
        build_gwc_volume(f, f, 4, 3)
