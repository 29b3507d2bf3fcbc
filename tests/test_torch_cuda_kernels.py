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

from stereo_toolbox_tpu_torch.ops import (
    attention, attention_reference, build_concat_volume, build_gwc_volume,
    concat_volume_backward, concat_volume_backward_reference,
    concat_volume_reference, conv3d, conv3d_fused, conv3d_fused_reference,
    conv3d_reference,
    gather_right_by_samples, gather_right_by_samples_backward,
    gather_right_by_samples_backward_reference,
    gather_right_by_samples_reference,
    gwc_volume_backward, gwc_volume_backward_reference,
    gwc_volume_from_samples, gwc_volume_from_samples_backward,
    gwc_volume_from_samples_backward_reference,
    gwc_volume_from_samples_reference, gwc_volume_reference)
from stereo_toolbox_tpu_torch.ops.conv3d import (
    conv3d_concat_volume, conv3d_concat_volume_reference, stencil_run)
from stereo_toolbox_tpu_torch.ops.conv3d_fused import (MMA_TILES, mma_tile,
                                                       pack_conv3d_weight)
from stereo_toolbox_tpu_torch.ops.volume import (concat_plan, gather_plan,
                                                 gwc_plan, sample_gwc_plan)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (b, h, w, c, d, g): CFNet's three volumes, W not a multiple of the tile,
# D > W with C/G = 3 and B = 2, odd G in bfloat16 (one group a thread), a
# row of 6 channels (no 16-byte copies: plain staging)
GWC_CASES = [(1, 60, 80, 160, 24, 40), (1, 30, 40, 320, 12, 40),
             (1, 15, 20, 320, 6, 40), (1, 4, 70, 320, 48, 40),
             (2, 3, 37, 48, 48, 16), (1, 3, 21, 24, 9, 3),
             (1, 2, 9, 6, 13, 6)]


@pytest.mark.parametrize("b,h,w,c,d,g", GWC_CASES)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_gwc_volume_kernel_matches_plain(dev, b, h, w, c, d, g, dtype, rel):
    """The "stream" design with the plan `gwc_plan` makes; within rel ·
    max|ref|."""
    gen = torch.Generator().manual_seed(0)
    left, right = (torch.randn(b, h, w, c, generator=gen).to(dev, dtype)
                   for _ in range(2))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    design = ("stream", *gwc_plan(b, h, w, c, d, g, dtype, sms)[:3])
    before = build_gwc_volume.designs[design]
    got = _counted(build_gwc_volume, (b, h, w, c, d, g), left, right, d,
                   g).float()
    assert build_gwc_volume.designs[design] == before + 1
    want = gwc_volume_reference(left.float(), right.float(), d, g)
    assert (got - want).abs().max().item() <= rel * want.abs().max().item()


# (b, h, w, c, d, g): GwcNet_G's train launch at 4 rows, CFNet's 1/16
# volume, W not a multiple of the strip, D > W, B 3, C/G 1, 16 and 3, a
# row long enough for W tiles
GWC_BWD_CASES = [(4, 2, 128, 320, 48, 40), (1, 4, 40, 320, 12, 40),
                 (3, 2, 37, 48, 48, 16), (1, 2, 9, 6, 13, 6),
                 (1, 3, 33, 32, 5, 2), (2, 2, 21, 24, 9, 8),
                 (1, 2, 160, 320, 48, 40)]


@pytest.mark.parametrize("b,h,w,c,d,g", GWC_BWD_CASES)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_gwc_volume_backward_kernel_matches_plain(dev, b, h, w, c, d, g,
                                                  dtype, rel):
    """The backward kernel ("rowpass") against its plain version and
    against torch.autograd of `gwc_volume_reference`, within rel ·
    max|ref|; the same bits when run twice (no atomics)."""
    gen = torch.Generator().manual_seed(1)
    left, right = (torch.randn(b, h, w, c, generator=gen).to(dev, dtype)
                   for _ in range(2))
    grad = torch.randn(b, d, h, w, g, generator=gen).to(dev, dtype)
    before = gwc_volume_backward.launches
    dl, dr = gwc_volume_backward(left, right, grad, d, g)
    again = gwc_volume_backward(left, right, grad, d, g)
    assert gwc_volume_backward.launches == before + 2
    assert torch.equal(dl, again[0]) and torch.equal(dr, again[1])
    want = gwc_volume_backward_reference(left.float(), right.float(),
                                         grad.float(), d, g)
    lf = left.float().requires_grad_()
    rf = right.float().requires_grad_()
    gwc_volume_reference(lf, rf, d, g).backward(grad.float())
    for got, plain, auto in zip((dl, dr), want, (lf.grad, rf.grad)):
        assert got.dtype == dtype and got.shape == left.shape
        tol = rel * plain.abs().max().item()
        assert (got.float() - plain).abs().max().item() <= tol
        assert (got.float() - auto).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gwc_volume_is_differentiable_on_the_card(dev, dtype):
    """`build_gwc_volume` on CUDA tensors that require grad: one forward
    and one backward launch, the features' gradients the backward
    kernel's."""
    gen = torch.Generator().manual_seed(2)
    left, right = (torch.randn(2, 3, 40, 320, generator=gen).to(dev, dtype)
                   .requires_grad_() for _ in range(2))
    grad = torch.randn(2, 12, 3, 40, 40, generator=gen).to(dev, dtype)
    before = (build_gwc_volume.launches, gwc_volume_backward.launches)
    build_gwc_volume(left, right, 12, 40).backward(grad)
    assert (build_gwc_volume.launches,
            gwc_volume_backward.launches) == (before[0] + 1,
                                                    before[1] + 1)
    dl, dr = gwc_volume_backward(left.detach(), right.detach(), grad, 12, 40)
    assert torch.equal(left.grad, dl) and torch.equal(right.grad, dr)


def test_kernels_without_a_backward_refuse_grad(dev):
    """K2, K3 and K7 given a CUDA input that requires grad raise, naming
    the train path; under torch.no_grad() the same calls launch."""
    x = torch.randn(1, 2, 3, 4, 8, device=dev, requires_grad=True)
    k = torch.randn(3, 3, 3, 8, 8, device=dev)
    q = torch.randn(1, 2, 4, 64, device=dev, requires_grad=True)
    calls = [lambda: conv3d_fused(x, k),
             lambda: conv3d(x, torch.randn(3, 3, 3, 8, 1, device=dev)),
             lambda: attention(q, q, q, 0.125)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            assert call().grad_fn is None


# (b, h, w, c, d): GwcNet_GC's and ACVNet's train launches at 2 rows,
# CFNet's 1/8 volume; D > W; odd C (one channel a thread item); C = 3
CONCAT_BWD_CASES = [(4, 2, 128, 12, 48), (4, 2, 128, 32, 48),
                    (4, 3, 64, 12, 24), (2, 3, 37, 12, 45), (1, 2, 9, 5, 4),
                    (1, 3, 11, 3, 7)]


@pytest.mark.parametrize("b,h,w,c,d", CONCAT_BWD_CASES)
@pytest.mark.parametrize("mask_left", [True, False])
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_concat_volume_backward_kernel_matches_plain(dev, b, h, w, c, d,
                                                     mask_left, dtype, rel):
    """K6's backward ("direct") against its plain version and against
    torch.autograd of `concat_volume_reference`, within rel · max|ref|; the
    same bits when run twice (no atomics)."""
    gen = torch.Generator().manual_seed(11)
    grad = torch.randn(b, d, h, w, 2 * c, generator=gen).to(dev, dtype)
    before = concat_volume_backward.launches
    dl, dr = concat_volume_backward(grad, d, mask_left)
    again = concat_volume_backward(grad, d, mask_left)
    assert concat_volume_backward.launches == before + 2
    assert torch.equal(dl, again[0]) and torch.equal(dr, again[1])
    want = concat_volume_backward_reference(grad.float(), d, mask_left)
    lf, rf = (torch.zeros(b, h, w, c, device=dev, requires_grad=True)
              for _ in range(2))
    concat_volume_reference(lf, rf, d, mask_left).backward(grad.float())
    for got, plain, auto in zip((dl, dr), want, (lf.grad, rf.grad)):
        assert got.dtype == dtype and got.shape == (b, h, w, c)
        tol = rel * plain.abs().max().item()
        assert (got.float() - plain).abs().max().item() <= tol
        assert (got.float() - auto).abs().max().item() <= tol


def _backward_samples(dev, b, s, h, w, max_shift, gen):
    """Samples in [-3, max_shift + 4] with a NaN, fractions in one plane
    and a row whose every sample reads right pixel 0 where it can."""
    samples = torch.randint(-3, max_shift + 5, (b, s, h, w),
                            generator=gen).float()
    samples[0, 0, 0, -1] = float("nan")
    samples[-1, -1] += 0.5
    samples[0, :, -1] = torch.arange(w).float()
    return samples.to(dev)


# (b, h, w, c, s, max_shift): CFNet's s3 and s2 train launches at 3 rows;
# W not a multiple of 32, C 5 and 1, S = 1
GATHER_BWD_CASES = [(4, 3, 128, 12, 16, 48), (4, 3, 256, 6, 12, 96),
                    (2, 3, 45, 5, 7, 20), (1, 2, 37, 1, 3, 9),
                    (1, 3, 70, 6, 1, 30)]


@pytest.mark.parametrize("b,h,w,c,s,max_shift", GATHER_BWD_CASES)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_gather_backward_kernel_matches_plain(dev, b, h, w, c, s, max_shift,
                                              dtype, rel):
    """K4's backward ("staged") against its plain version and torch.autograd
    of the plain gather, within rel · max|ref|; the same bits twice."""
    gen = torch.Generator().manual_seed(12)
    samples = _backward_samples(dev, b, s, h, w, max_shift, gen)
    grad = torch.randn(b, s, h, w, c, generator=gen).to(dev, dtype)
    before = gather_right_by_samples_backward.launches
    got = gather_right_by_samples_backward(grad, samples, max_shift)
    again = gather_right_by_samples_backward(grad, samples, max_shift)
    assert gather_right_by_samples_backward.launches == before + 2
    assert torch.equal(got, again)
    clean = samples.nan_to_num(0.0)
    plain = gather_right_by_samples_backward_reference(grad.float(), clean,
                                                       max_shift)
    rf = torch.zeros(b, h, w, c, device=dev, requires_grad=True)
    gather_right_by_samples_reference(rf, clean, max_shift).backward(
        grad.float())
    assert got.dtype == dtype and got.shape == (b, h, w, c)
    tol = rel * plain.abs().max().item()
    assert (got.float() - plain).abs().max().item() <= tol
    assert (got.float() - rf.grad).abs().max().item() <= tol


# (b, h, w, c, s, g, max_shift): CFNet's s3 and s2 train launches at 2
# rows; C/G 3 and 5 with odd G; S = 1
GWC_SAMPLE_BWD_CASES = [(4, 2, 128, 160, 16, 40, 48),
                        (4, 2, 256, 80, 12, 20, 96), (2, 3, 45, 12, 7, 4, 20),
                        (1, 3, 70, 15, 1, 3, 9)]


@pytest.mark.parametrize("b,h,w,c,s,g,max_shift", GWC_SAMPLE_BWD_CASES)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_gwc_from_samples_backward_kernel_matches_plain(
        dev, b, h, w, c, s, g, max_shift, dtype, rel):
    """K5's backward ("staged") against its plain version and torch.autograd
    of the plain forward, within rel · max|ref|; the same bits twice."""
    gen = torch.Generator().manual_seed(13)
    left, right = (torch.randn(b, h, w, c, generator=gen).to(dev, dtype)
                   for _ in range(2))
    samples = _backward_samples(dev, b, s, h, w, max_shift, gen)
    grad = torch.randn(b, s, h, w, g, generator=gen).to(dev, dtype)
    before = gwc_volume_from_samples_backward.launches
    dl, dr = gwc_volume_from_samples_backward(left, right, samples, grad, g,
                                              max_shift)
    again = gwc_volume_from_samples_backward(left, right, samples, grad, g,
                                             max_shift)
    assert gwc_volume_from_samples_backward.launches == before + 2
    assert torch.equal(dl, again[0]) and torch.equal(dr, again[1])
    clean = samples.nan_to_num(0.0)
    want = gwc_volume_from_samples_backward_reference(
        left.float(), right.float(), clean, grad.float(), g, max_shift)
    lf = left.float().requires_grad_()
    rf = right.float().requires_grad_()
    gwc_volume_from_samples_reference(lf, rf, clean, g, max_shift).backward(
        grad.float())
    for got, plain, auto in zip((dl, dr), want, (lf.grad, rf.grad)):
        assert got.dtype == dtype and got.shape == left.shape
        tol = rel * plain.abs().max().item()
        assert (got.float() - plain).abs().max().item() <= tol
        assert (got.float() - auto).abs().max().item() <= tol


def test_volume_kernels_are_differentiable_on_the_card(dev):
    """K4, K5 and K6 on CUDA features that require grad (and samples that
    do): one forward and one backward launch each; the features' gradients
    the backward kernels', the samples' none."""
    gen = torch.Generator().manual_seed(14)
    left, right = (torch.randn(2, 3, 40, 24, generator=gen).to(dev)
                   .requires_grad_() for _ in range(2))
    samples = torch.randint(0, 12, (2, 4, 3, 40), generator=gen).float().to(
        dev).requires_grad_()
    wrappers = (build_concat_volume, concat_volume_backward,
                gather_right_by_samples, gather_right_by_samples_backward,
                gwc_volume_from_samples, gwc_volume_from_samples_backward)
    before = [fn.launches for fn in wrappers]
    vol = build_concat_volume(left, right, 12)
    g6 = torch.randn(vol.shape, generator=gen).to(dev)
    gat = gather_right_by_samples(right, samples, 12)
    g4 = torch.randn(gat.shape, generator=gen).to(dev)
    gwc = gwc_volume_from_samples(left, right, samples, 6, 12)
    g5 = torch.randn(gwc.shape, generator=gen).to(dev)
    dl, dr, ds = torch.autograd.grad((vol, gat, gwc), (left, right, samples),
                                     (g6, g4, g5), allow_unused=True)
    assert [fn.launches - n for fn, n in zip(wrappers, before)] == [1] * 6
    assert ds is None
    l6, r6 = concat_volume_backward(g6, 12)
    r4 = gather_right_by_samples_backward(g4, samples.detach(), 12)
    l5, r5 = gwc_volume_from_samples_backward(
        left.detach(), right.detach(), samples.detach(), g5, 6, 12)
    torch.testing.assert_close(dl, l6 + l5, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dr, r6 + r4 + r5, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ci,co,residual,relu", [(40, 32, False, True),
                                                 (12, 40, True, True),
                                                 (64, 64, True, False),
                                                 (65, 32, False, False),
                                                 (33, 16, True, False)])
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


# (b, d, h, w, ci, co, residual, relu), bfloat16 on the tensor cores: Ci not
# a multiple of 16 (1, 3, 33, 65; 1, 3, 33 and 65 also not of 8, where the
# halo is staged with plain loads), Co 8 and 33 (ragged tiles, scalar
# stores), odd H and W, D 1 and 2; and shapes whose grids pick each tile
MMA_CASES = [(1, 3, 7, 19, 1, 8, False, True),
             (2, 2, 9, 35, 3, 33, True, True),
             (1, 1, 5, 7, 33, 8, True, False),
             (1, 2, 11, 13, 65, 33, False, False),
             (1, 4, 6, 40, 40, 64, True, True),
             (1, 16, 40, 64, 64, 64, True, False),
             (1, 24, 64, 64, 32, 32, False, True),
             (1, 24, 64, 64, 16, 16, True, False),
             (1, 16, 30, 40, 128, 128, False, True)]


@pytest.mark.parametrize("b,d,h,w,ci,co,residual,relu", MMA_CASES)
def test_conv3d_fused_tf32x3_kernel_matches_plain(dev, b, d, h, w, ci, co,
                                                  residual, relu):
    """float32 launches the 3xTF32 design, with the tile `mma_tile` picks
    for float32, on a raw or a packed kernel alike; within 1e-4 · max|ref|
    of the plain version with TF32 off, the same bits twice."""
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(b, d, h, w, ci, generator=gen).to(dev)
    k = (torch.randn(3, 3, 3, ci, co, generator=gen)
         * (2.0 / (27 * ci)) ** 0.5).to(dev)
    scale = (torch.rand(co, generator=gen) + 0.5).to(dev)
    bias = torch.randn(co, generator=gen).to(dev)
    res = (torch.randn(b, d, h, w, co, generator=gen).to(dev)
           if residual else None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, n = MMA_TILES[mma_tile(b, d, h, w, co, sms, torch.float32)]
    want = conv3d_fused_reference(x, k, scale, bias, res, relu)
    for kernel in (k, pack_conv3d_weight(k)):
        before = conv3d_fused.designs[("tf32x3", rows * 32, n)]
        got = conv3d_fused(x, kernel, scale, bias, res, relu)
        again = conv3d_fused(x, kernel, scale, bias, res, relu)
        assert conv3d_fused.designs[("tf32x3", rows * 32, n)] == before + 2
        assert torch.equal(got, again)
        assert got.dtype == torch.float32 and got.shape == want.shape
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.parametrize("b,d,h,w,ci,co,residual,relu", MMA_CASES)
def test_conv3d_fused_mma_kernel_matches_plain(dev, b, d, h, w, ci, co,
                                               residual, relu):
    """bfloat16 launches the tensor-core design, with the tile `mma_tile`
    picks, on a raw or a packed kernel alike; within 2e-2 · max|ref|."""
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(b, d, h, w, ci, generator=gen).to(dev, torch.bfloat16)
    k = (torch.randn(3, 3, 3, ci, co, generator=gen)
         * (2.0 / (27 * ci)) ** 0.5).to(dev, torch.bfloat16)
    scale = (torch.rand(co, generator=gen) + 0.5).to(dev)
    bias = torch.randn(co, generator=gen).to(dev)
    res = (torch.randn(b, d, h, w, co, generator=gen).to(dev, torch.bfloat16)
           if residual else None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, n = MMA_TILES[mma_tile(b, d, h, w, co, sms)]
    want = conv3d_fused_reference(x.float(), k.float(), scale, bias,
                                  None if res is None else res.float(), relu)
    for kernel in (k, pack_conv3d_weight(k)):
        before = conv3d_fused.designs[("mma", rows * 32, n)]
        got = conv3d_fused(x, kernel, scale, bias, res, relu)
        assert conv3d_fused.designs[("mma", rows * 32, n)] == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == want.shape
        err = (got.float() - want).abs().max().item()
        assert err <= 2e-2 * want.abs().max().item(), err


# (b, d, h, w, ci, co): the classifiers' Co = 1 at GwcNet's Ci and CFNet's
# 1/2 stage's (shorter D and H); Ci 16, 32 and 5 (plain staging); D 1 and 2;
# odd H and W; B = 2; Co = 8 and 33 (the direct design, tiles of 8, the last
# one ragged); Ci not a multiple of the direct design's staged chunk
CONV3D_CASES = [(1, 6, 20, 40, 32, 1), (1, 4, 24, 64, 16, 1),
                (2, 5, 7, 37, 32, 1), (1, 2, 9, 33, 32, 1),
                (1, 1, 5, 7, 16, 1), (1, 3, 17, 30, 5, 1),
                (1, 2, 11, 9, 5, 1), (1, 1, 9, 45, 32, 1),
                (2, 3, 7, 19, 12, 8), (1, 4, 9, 35, 32, 33)]


@pytest.mark.parametrize("b,d,h,w,ci,co", CONV3D_CASES)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_conv3d_kernel_matches_plain(dev, b, d, h, w, ci, co, dtype, rel):
    """Co = 1 runs the "stencil" design with the run `stencil_run` picks,
    Co > 1 the "direct" one; within rel · max|ref|."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(b, d, h, w, ci, generator=gen).to(dev, dtype)
    k = (torch.randn(3, 3, 3, ci, co, generator=gen) * 0.1).to(dev, dtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    design = (("stencil", stencil_run(b, d, h, w, ci, dtype, sms))
              if co == 1 else ("direct",))
    before = conv3d.designs[design]
    got = _counted(conv3d, (b, d, h, w, ci, co), x, k)
    assert conv3d.designs[design] == before + 1
    assert got.dtype == dtype and got.shape == (b, d, h, w, co)
    want = conv3d_reference(x.float(), k.float())
    err = (got.float() - want).abs().max().item()
    assert err <= rel * want.abs().max().item()


def _counted(fn, key, *args):
    """Call wrapper `fn` and check that it counted one launch of `key`."""
    before = fn.launches, fn.shapes[key]
    out = fn(*args)
    assert (fn.launches, fn.shapes[key]) == (before[0] + 1, before[1] + 1)
    return out


def _sample_inputs(dev, dtype, b, h, w, c, s, max_shift, seed):
    """Features and float32 samples in [-3, max_shift + 4]: some reach x < 0
    and some are clamped at both ends."""
    gen = torch.Generator().manual_seed(seed)
    left, right = (torch.randn(b, h, w, c, generator=gen).to(dev, dtype)
                   for _ in range(2))
    samples = torch.randint(-3, max_shift + 5, (b, s, h, w),
                            generator=gen).float().to(dev)
    return left, right, samples


# (b, d, h, w, c, co): PSMNet's first 3D layer at a few rows; D > W + 2;
# D = 1 and 2
CONCAT_CONV_CASES = [(1, 48, 4, 160, 32, 32), (2, 9, 3, 5, 4, 3),
                     (1, 1, 4, 6, 3, 2), (1, 2, 5, 7, 8, 1)]


@pytest.mark.parametrize("b,d,h,w,c,co", CONCAT_CONV_CASES)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_conv3d_concat_volume_matches_plain(dev, b, d, h, w, c, co, dtype,
                                            rel):
    """PSMNet's concat-volume conv on the card (cuDNN's 2D convs with TF32
    off, strided copies and adds) with a folded scale, bias and ReLU,
    against the volume built and convolved in float32; within rel ·
    max|ref|."""
    gen = torch.Generator().manual_seed(7)
    left, right = (torch.randn(b, h, w, c, generator=gen).to(dev, dtype)
                   for _ in range(2))
    k = (0.2 * torch.randn(3, 3, 3, 2 * c, co, generator=gen)).to(dev, dtype)
    scale = (torch.rand(co, generator=gen) + 0.5).to(dev)
    bias = torch.randn(co, generator=gen).to(dev)
    got = conv3d_concat_volume(left, right, k, d, scale, bias, True)
    want = conv3d_concat_volume_reference(left.float(), right.float(),
                                          k.float(), d, scale, bias, True)
    assert got.dtype == dtype and got.shape == (b, d, h, w, co)
    err = (got.float() - want).abs().max().item()
    assert err <= rel * want.abs().max().item()


# (b, h, w, c, s, max_shift): ragged W, odd C; CFNet's s3 widths; a wide
# row (C 320) and a long shift
SAMPLE_CASES = [(2, 3, 45, 5, 7, 20), (1, 2, 70, 12, 16, 48),
                (1, 2, 40, 320, 3, 200)]


@pytest.mark.parametrize("b,h,w,c,s,max_shift", SAMPLE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sample_gather_kernel_matches_plain(dev, b, h, w, c, s, max_shift,
                                            dtype):
    _, right, samples = _sample_inputs(dev, dtype, b, h, w, c, s, max_shift,
                                       2)
    got = _counted(gather_right_by_samples, (b, h, w, c, s, max_shift),
                   right, samples, max_shift)
    want = gather_right_by_samples_reference(right, samples, max_shift)
    assert torch.equal(got, want)


# (b, h, w, c, s, max_shift): CFNet's s3 and s2 widths at 4 rows; W not a
# multiple of the tile; C = 1, 5, 6 (12-byte bfloat16 pixels), odd C; S = 1
DIRECT_GATHER_CASES = [(1, 4, 160, 12, 16, 48), (1, 4, 320, 6, 12, 96),
                       (2, 3, 45, 5, 7, 20), (1, 2, 37, 1, 3, 9),
                       (1, 3, 70, 6, 1, 30), (1, 2, 40, 7, 5, 50)]


@pytest.mark.parametrize("b,h,w,c,s,max_shift", DIRECT_GATHER_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shifted", [False, True])
def test_sample_gather_direct_design_matches_plain(dev, b, h, w, c, s,
                                                   max_shift, dtype, shifted):
    """K4 runs its "direct" design with the plan `gather_plan` makes, also
    on a right map one element past 16-byte alignment (narrower words);
    exactly equal to the plain version, with a NaN sample."""
    _, right, samples = _sample_inputs(dev, dtype, b, h, w, c, s, max_shift,
                                       6)
    if shifted:
        flat = torch.zeros(right.numel() + 1, dtype=dtype, device=dev)
        flat[1:] = right.flatten()
        right = flat[1:].view(b, h, w, c)
    samples[0, 0, 0, -1] = float("nan")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bits = right.data_ptr() | 16
    plan = gather_plan(b, h, w, c, s, dtype, sms, bits & -bits)
    design = ("direct", *plan)
    before = gather_right_by_samples.designs[design]
    got = _counted(gather_right_by_samples, (b, h, w, c, s, max_shift),
                   right, samples, max_shift)
    assert gather_right_by_samples.designs[design] == before + 1
    want = gather_right_by_samples_reference(right, samples.nan_to_num(0.0),
                                             max_shift)
    assert got.dtype == dtype and torch.equal(got, want)


# (b, h, w, c, s, g, max_shift): C/G = 3 (scalar sums); CFNet's s2 and s3
# widths; the split window
GWC_SAMPLE_CASES = [(2, 3, 45, 12, 7, 4, 20), (1, 2, 70, 80, 12, 20, 96),
                    (1, 2, 70, 160, 16, 40, 48), (1, 2, 40, 320, 3, 40, 200)]


@pytest.mark.parametrize("b,h,w,c,s,g,max_shift", GWC_SAMPLE_CASES)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_gwc_from_samples_kernel_matches_plain(dev, b, h, w, c, s, g,
                                               max_shift, dtype, rel):
    left, right, samples = _sample_inputs(dev, dtype, b, h, w, c, s,
                                          max_shift, 3)
    got = _counted(gwc_volume_from_samples, (b, h, w, c, s, g, max_shift),
                   left, right, samples, g, max_shift).float()
    want = gwc_volume_from_samples_reference(left.float(), right.float(),
                                             samples, g, max_shift)
    assert (got - want).abs().max().item() <= rel * want.abs().max().item()


# (b, h, w, c, s, g, max_shift): CFNet's s3 widths at 4 rows (a tile
# boundary inside the row), W not a multiple of the tile, S = 1 with odd G
# (one group a thread), C/G = 5 (no compile-time count), one-pixel blocks
DIRECT_SAMPLE_CASES = [(1, 4, 160, 160, 16, 40, 48), (2, 3, 45, 12, 7, 4, 20),
                       (1, 3, 70, 15, 1, 3, 9), (2, 2, 19, 10, 4, 2, 25),
                       (1, 2, 40, 320, 3, 40, 200)]


@pytest.mark.parametrize("b,h,w,c,s,g,max_shift", DIRECT_SAMPLE_CASES)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_gwc_from_samples_direct_design_matches_plain(dev, b, h, w, c, s, g,
                                                      max_shift, dtype, rel):
    """K5 runs its "direct" design with the plan `sample_gwc_plan` makes;
    within rel · max|ref|."""
    left, right, samples = _sample_inputs(dev, dtype, b, h, w, c, s,
                                          max_shift, 5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    design = ("direct", *sample_gwc_plan(b, h, w, c, s, g, dtype, sms))
    before = gwc_volume_from_samples.designs[design]
    got = _counted(gwc_volume_from_samples, (b, h, w, c, s, g, max_shift),
                   left, right, samples, g, max_shift)
    assert gwc_volume_from_samples.designs[design] == before + 1
    want = gwc_volume_from_samples_reference(left.float(), right.float(),
                                             samples, g, max_shift)
    assert got.dtype == dtype
    err = (got.float() - want).abs().max().item()
    assert err <= rel * want.abs().max().item()


# (b, h, w, c, d): GwcNet_GC's row (bfloat16: 24-byte halves, two words a
# store), odd C (8- and 4-byte stores, 2-byte words), W x C odd in bfloat16
# (a row not a multiple of 16 bytes), a row past the plan's shared memory
ROWS_CASES = [(1, 3, 160, 12, 48), (1, 2, 9, 5, 4), (1, 3, 11, 3, 7),
              (1, 2, 20, 700, 3)]


@pytest.mark.parametrize("b,h,w,c,d", ROWS_CASES)
@pytest.mark.parametrize("mask_left", [True, False])
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_concat_volume_rows_design_matches_plain(dev, b, h, w, c, d,
                                                 mask_left, shifted, dtype):
    """K6 runs its "rows" design with the plan `concat_plan` makes, exactly,
    also with feature bases one element past 16-byte alignment."""
    gen = torch.Generator().manual_seed(8)
    n = b * h * w * c
    left, right = (torch.randn(n + shifted, generator=gen).to(dev, dtype)[
        int(shifted):].view(b, h, w, c) for _ in range(2))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    design = ("rows", *concat_plan(b, h, w, c, d, dtype, sms)[:4])
    before = build_concat_volume.designs[design]
    got = _counted(build_concat_volume, (b, h, w, c, d, mask_left), left,
                   right, d, mask_left)
    assert build_concat_volume.designs[design] == before + 1
    assert torch.equal(got, concat_volume_reference(left, right, d,
                                                    mask_left))


# (b, h, w, c, d): D > W; odd C (4- and 2-byte copies); CFNet's C=12
CONCAT_CASES = [(2, 3, 37, 12, 45), (1, 2, 9, 5, 4), (1, 4, 80, 12, 24)]


@pytest.mark.parametrize("b,h,w,c,d", CONCAT_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_concat_volume_kernel_matches_plain(dev, b, h, w, c, d, dtype):
    gen = torch.Generator().manual_seed(4)
    left, right = (torch.randn(b, h, w, c, generator=gen).to(dev, dtype)
                   for _ in range(2))
    got = _counted(build_concat_volume, (b, h, w, c, d, True), left, right,
                   d)
    assert torch.equal(got, concat_volume_reference(left, right, d))
    if d > w:
        assert not got[:, w:].any()


# ACVNet's C = 32 and D > W beside the masked cases' shapes
UNMASKED_CASES = CONCAT_CASES + [(1, 3, 40, 32, 12), (1, 2, 10, 32, 14)]


@pytest.mark.parametrize("b,h,w,c,d", UNMASKED_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unmasked_concat_volume_kernel_matches_plain(dev, b, h, w, c, d,
                                                     dtype):
    """``mask_left=False`` (ACVNet) launches the kernel too, exact: the
    left half at every d, the right half zero where w < d."""
    gen = torch.Generator().manual_seed(7)
    left, right = (torch.randn(b, h, w, c, generator=gen).to(dev, dtype)
                   for _ in range(2))
    got = _counted(build_concat_volume, (b, h, w, c, d, False), left, right,
                   d, False)
    assert torch.equal(got, concat_volume_reference(left, right, d, False))
    assert torch.equal(got[..., :c], left[:, None].expand(b, d, h, w, c))
    if d > w:
        assert not got[:, w:, ..., c:].any()


# (b, heads, n, logit scale): one key (N = 1), ragged N, one past a tile,
# vits' heads, MonSter's two views, DepthAnythingV2-vitl's launch; the large
# scale gives logits of ~±30, where a wrong running max shows
ATTENTION_CASES = [(1, 2, 1, 0.125), (2, 3, 77, 0.125), (1, 4, 1025, 0.125),
                   (1, 6, 300, 0.125), (2, 16, 1201, 0.125),
                   (1, 16, 1370, 0.125), (1, 2, 200, 1.0)]
# ragged N of the bfloat16 tensor-core kernel: under, at and one past its
# 64-row tiles, and a long sequence
MMA_ATTENTION_CASES = [(1, 3, 15, 0.125), (2, 2, 64, 0.125), (1, 2, 65, 1.0),
                       (1, 4, 2048, 0.125)]


@pytest.mark.parametrize("b,heads,n,scale", ATTENTION_CASES)
@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_attention_kernel_matches_plain(dev, b, heads, n, scale, dtype, rel):
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(b, heads, n, 64, generator=gen).to(dev, dtype)
               for _ in range(3))
    out = _counted(attention, (b, heads, n, 64), q, k, v, scale)
    assert out.dtype == dtype and out.shape == q.shape
    want = attention_reference(q.float(), k.float(), v.float(), scale)
    err = (out.float() - want).abs().max().item()
    assert err <= rel * want.abs().max().item()


@pytest.mark.parametrize("b,heads,n,scale", MMA_ATTENTION_CASES)
def test_attention_mma_kernel_matches_plain(dev, b, heads, n, scale):
    """bfloat16 launches the tensor-core design; within 1e-2 · max|ref|."""
    gen = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(b, heads, n, 64, generator=gen).to(
        dev, torch.bfloat16) for _ in range(3))
    before = attention.designs[("mma", 64, 64)]
    out = _counted(attention, (b, heads, n, 64), q, k, v, scale)
    assert attention.designs[("mma", 64, 64)] == before + 1
    want = attention_reference(q.float(), k.float(), v.float(), scale)
    err = (out.float() - want).abs().max().item()
    assert err <= 1e-2 * want.abs().max().item(), err


@pytest.mark.parametrize("b,heads,n,scale", ATTENTION_CASES
                         + MMA_ATTENTION_CASES)
def test_attention_tf32x3_kernel_matches_plain(dev, b, heads, n, scale):
    """float32 launches the 3xTF32 design; within 1e-5 · max|ref| of the
    plain version with TF32 off, the same bits twice."""
    gen = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn(b, heads, n, 64, generator=gen).to(dev)
               for _ in range(3))
    before = attention.designs[("tf32x3", 64, 64)]
    out = _counted(attention, (b, heads, n, 64), q, k, v, scale)
    again = attention(q, k, v, scale)
    assert attention.designs[("tf32x3", 64, 64)] == before + 2
    assert torch.equal(out, again)
    want = attention_reference(q, k, v, scale)
    err = (out - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


def test_float32_launches_the_tf32x3_designs(dev):
    x = torch.zeros(1, 2, 3, 4, 8, device=dev)
    before = sum(n for key, n in conv3d_fused.designs.items()
                 if key[0] == "tf32x3")
    conv3d_fused(x, torch.zeros(3, 3, 3, 8, 8, device=dev))
    assert sum(n for key, n in conv3d_fused.designs.items()
               if key[0] == "tf32x3") == before + 1
    q = torch.zeros(1, 2, 10, 64, device=dev)
    before = attention.designs[("tf32x3", 64, 64)]
    attention(q, q, q, 0.1)
    assert attention.designs[("tf32x3", 64, 64)] == before + 1


def test_attention_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros(1, 2, 10, 32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        attention(q, q, q, 0.1)
    q = torch.zeros(1, 2, 10, 64, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        attention(q.transpose(1, 2).contiguous().transpose(1, 2), q, q, 0.1)
    with pytest.raises(TypeError):
        attention(q.half(), q.half(), q.half(), 0.1)


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
    with pytest.raises(ValueError):        # C/G = 5: no kernel instance
        build_gwc_volume(torch.zeros(1, 2, 3, 10, device=dev),
                         torch.zeros(1, 2, 3, 10, device=dev), 4, 2)
    samples = torch.zeros(1, 4, 2, 3, device=dev)
    with pytest.raises(ValueError):        # no bound on the samples
        gather_right_by_samples(f, samples)
    with pytest.raises(ValueError):        # a gradient of another shape
        gather_right_by_samples_backward(
            torch.zeros(1, 3, 2, 3, 8, device=dev), samples, 4)
    with pytest.raises(ValueError):        # a gradient of another depth
        concat_volume_backward(torch.zeros(1, 5, 2, 3, 16, device=dev), 4)
    with pytest.raises(ValueError):        # float64 samples
        gwc_volume_from_samples(f, f, samples.double(), 2, 4)
    with pytest.raises(TypeError):
        build_concat_volume(f.half(), f.half(), 4)
    k1 = torch.zeros(3, 3, 3, 8, 1, device=dev)
    with pytest.raises(TypeError):
        conv3d(x, k1.half())
    with pytest.raises(ValueError):        # not contiguous
        conv3d(x.float().transpose(2, 3), k1)
    with pytest.raises(ValueError):        # kernel of another Ci
        conv3d(x.float(), torch.zeros(3, 3, 3, 4, 1, device=dev))
    with pytest.raises(ValueError):        # kernel of another dtype
        conv3d(x.float(), k1.bfloat16())
