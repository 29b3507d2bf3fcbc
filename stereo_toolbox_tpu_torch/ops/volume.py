"""Cost-volume construction and disparity regression (PyTorch).

Counterpart of ``stereo_toolbox_tpu/ops/volume.py``, in the same
channels-last layouts: feature maps ``[B, H, W, C]``, cost volumes
``[B, D, H, W, C]``.

Each op with a kernel launches the hand-written CUDA kernel on a CUDA tensor
and runs its plain PyTorch version, named ``*_reference``, on a CPU tensor:

  * `build_gwc_volume` → ``csrc/gwc_volume.cu`` (K1);
  * `build_concat_volume` → ``csrc/concat_volume.cu`` (K6), with the left
    half masked or not;
  * `gather_right_by_samples` and `gwc_volume_from_samples` →
    ``csrc/sample_gather.cu`` (K4, K5).

On the card each of them is differentiable: an autograd Function whose
backward launches a backward kernel (`gwc_volume_backward`,
`concat_volume_backward`, `gather_right_by_samples_backward`,
`gwc_volume_from_samples_backward`; plain versions ``*_backward_reference``).
The samples get no gradient, as in JAX, where they pass through an integer
cast.

Each wrapper counts its launches, in all (``.launches``), by shape
(``.shapes``) and by design and plan (``.designs``), the plan coming from
`gwc_plan`, `gwc_backward_plan`, `gather_plan`, `sample_gwc_plan`,
`sample_backward_plan`, `concat_plan` and `concat_backward_plan`.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import NamedTuple

import torch

from stereo_toolbox_tpu_torch.ops import _cuda


def _check_features(*feats: torch.Tensor) -> None:
    """What the volume kernels take: contiguous ``[B, H, W, C]`` CUDA
    tensors, all of one shape, device and dtype."""
    first = feats[0]
    if first.device.type != "cuda":
        raise ValueError(f"unsupported device {first.device}")
    if first.dim() != 4 or any(f.shape != first.shape for f in feats):
        raise ValueError(f"features {[tuple(f.shape) for f in feats]} must "
                         f"be equal [B, H, W, C]")
    if any(f.device != first.device or f.dtype != first.dtype
           for f in feats):
        raise ValueError("features must share device and dtype")
    if not all(f.is_contiguous() for f in feats):
        raise ValueError("features must be contiguous")


def _check_samples(right: torch.Tensor, samples: torch.Tensor,
                   max_shift: int | None) -> None:
    """What the sample kernels take besides the features: contiguous float32
    ``[B, S, H, W]`` samples on the features' device and a bound
    ``max_shift``."""
    b, h, w, _ = right.shape
    if (samples.dim() != 4 or samples.shape[0] != b
            or samples.shape[2:] != (h, w)):
        raise ValueError(f"samples {tuple(samples.shape)} are not [B, S, H, W]"
                         f" for features {tuple(right.shape)}")
    if (samples.dtype != torch.float32 or samples.device != right.device
            or not samples.is_contiguous()):
        raise ValueError("samples must be contiguous float32 on the features'"
                         " device")
    if max_shift is None or max_shift < 0:
        raise ValueError(f"the kernels need a bound max_shift >= 0, got "
                         f"{max_shift}")


def shifted_right_stack(right: torch.Tensor, max_disp: int) -> torch.Tensor:
    """``out[b, d, h, w, c] = right[b, h, w - d, c]`` (zero where w < d).

    Args:
      right: ``[B, H, W, C]``.
      max_disp: number of disparity candidates D.

    Returns:
      ``[B, D, H, W, C]``.
    """
    b, h, w, c = right.shape
    out = right.new_zeros((b, max_disp, h, w, c))
    for d in range(min(max_disp, w)):
        out[:, d, :, d:] = right[:, :, :w - d]
    return out


def groupwise_correlation(fea1: torch.Tensor, fea2: torch.Tensor,
                          num_groups: int) -> torch.Tensor:
    """Per-group mean of elementwise products over the last axis:
    ``[..., C]`` × ``[..., C]`` → ``[..., num_groups]``."""
    c = fea1.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    prod = fea1 * fea2
    return prod.reshape(prod.shape[:-1] + (num_groups, c // num_groups)).mean(-1)


def gwc_volume_reference(left: torch.Tensor, right: torch.Tensor,
                         max_disp: int, num_groups: int) -> torch.Tensor:
    """Plain group-wise correlation volume: the shifted right stack
    correlated with the left features. ``[B, D, H, W, G]``."""
    return groupwise_correlation(left[:, None],
                                 shifted_right_stack(right, max_disp),
                                 num_groups)


GWC_CPG = (1, 2, 3, 4, 6, 8, 12, 16)   # channels a group the kernel takes
GWC_TILE_W = 16           # output pixels of W a block
GWC_MAX_SMEM = 200 * 1024  # bytes of a block's staged row, at most


class GwcPlan(NamedTuple):
    """How the K1 kernel cuts a launch: W tile `tw`, groups a slice `gs`,
    disparities a chunk `dc`, pixels a thread's strip `strip` (see
    ``csrc/gwc_volume.cu``)."""
    tw: int
    gs: int
    dc: int
    strip: int


def gwc_strip(cpg: int, ng: int) -> int:
    """Pixels of a K1 thread's strip for `ng` groups of `cpg` channels: the
    largest power of two ≤ 8 with strip · ng · cpg ≤ 32."""
    s = 8
    while s > 1 and s * ng * cpg > 32:
        s //= 2
    return s


def gwc_plan(b: int, h: int, w: int, c: int, d: int, g: int,
             dtype: torch.dtype, sms: int) -> GwcPlan:
    """The K1 kernel's plan for a ``[b, d, h, w, g]`` volume from ``[b, h,
    w, c]`` features of `dtype` on a card of `sms` SMs. A block is one row
    of one `GWC_TILE_W`-pixel W tile; its slice is the whole row of groups
    (the output's d planes then take contiguous stores) unless the grid
    has under 4 blocks an SM, where slices halve (16-byte aligned, down to
    32 thread items a block) and then the disparities are cut into chunks;
    slices and chunks are cut further until the staged row fits
    `GWC_MAX_SMEM`."""
    size = 4 if dtype == torch.float32 else 2
    cpg = c // g
    ng = 2 if size == 2 and g % 2 == 0 else 1
    s = gwc_strip(cpg, ng)
    tw = GWC_TILE_W
    step = math.lcm(ng, 16 // math.gcd(16, cpg * size))
    gs = g
    target = 4 * sms

    def blocks(gs, dc):
        return b * h * -(-w // tw) * -(-g // gs) * -(-d // dc)

    def smem(gs, dc):
        scp = -(-gs * cpg // (16 // size)) * (16 // size)
        return (2 * tw + dc - 1) * scp * size

    while (blocks(gs, d) < target and gs % (2 * step) == 0
           and gs // 2 // ng * (tw // s) >= 32):
        gs //= 2
    dc = d
    if blocks(gs, d) < target:
        n = min(-(-d // s), -(-target // blocks(gs, d)))
        dc = -(-(-(-d // n)) // s) * s
    while smem(gs, dc) > GWC_MAX_SMEM:
        if gs > step:
            gs = max(step, gs // 2 // step * step)
        elif dc > 1:
            dc = -(-dc // 2)
        else:
            raise ValueError(f"no K1 plan fits shared memory at C={c}, G={g}")
    return GwcPlan(tw, gs, dc, s)


def _check_gwc(left: torch.Tensor, right: torch.Tensor, max_disp: int,
               num_groups: int) -> None:
    """What both K1 kernels take: `_check_features`, and C / G in
    `GWC_CPG`."""
    _check_features(left, right)
    c = left.shape[-1]
    if num_groups < 1 or c % num_groups or max_disp < 1:
        raise ValueError(f"bad groups {num_groups} / max_disp {max_disp} "
                         f"for C={c}")
    if c // num_groups not in GWC_CPG:
        raise ValueError(f"the K1 kernels take C/G in {GWC_CPG}, got "
                         f"{c}/{num_groups}")


class _GwcVolume(torch.autograd.Function):
    """K1 with its gradient: the forward kernel, and the backward kernel
    (`gwc_volume_backward`) for the features' gradients."""

    @staticmethod
    def forward(ctx, left, right, max_disp, num_groups):
        ctx.save_for_backward(left, right)
        ctx.volume = (max_disp, num_groups)
        return _launch_gwc_volume(left, right, max_disp, num_groups)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        left, right = ctx.saved_tensors
        dl, dr = gwc_volume_backward(left, right, grad.contiguous(),
                                     *ctx.volume)
        return dl, dr, None, None


def build_gwc_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                     num_groups: int) -> torch.Tensor:
    """Group-wise correlation cost volume ``[B, D, H, W, G]`` (GwcNet):
    ``out[b,d,h,w,g] = mean_{c in g} left[b,h,w,c] * right[b,h,w-d,c]``,
    zero for w < d.

    CPU tensors take `gwc_volume_reference` (autograd differentiates it);
    CUDA tensors launch the kernel (float32 or bfloat16, contiguous ``[B,
    H, W, C]``, C / G in `GWC_CPG`), cut as `gwc_plan` says, or raise. On
    the card the volume is differentiable: its backward launches the
    backward kernel (`gwc_volume_backward`).
    """
    if _cuda.on_cpu(left):
        return gwc_volume_reference(left, right, max_disp, num_groups)
    _check_gwc(left, right, max_disp, num_groups)
    return _GwcVolume.apply(left, right, max_disp, num_groups)


def _launch_gwc_volume(left: torch.Tensor, right: torch.Tensor,
                       max_disp: int, num_groups: int) -> torch.Tensor:
    b, h, w, c = left.shape
    code = _cuda.dtype_code(left)
    out = torch.empty((b, max_disp, h, w, num_groups), dtype=left.dtype,
                      device=left.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(left.device).multi_processor_count
    plan = gwc_plan(b, h, w, c, max_disp, num_groups, left.dtype, sms)
    lib = _cuda.library("gwc_volume")
    with torch.cuda.device(left.device):
        rc = lib.gwc_volume(left.data_ptr(), right.data_ptr(), out.data_ptr(),
                            b, h, w, c, max_disp, num_groups, code, *plan,
                            _cuda.stream_of(left))
    _cuda.check(lib, rc, "gwc_volume")
    build_gwc_volume.launches += 1
    build_gwc_volume.shapes[(b, h, w, c, max_disp, num_groups)] += 1
    build_gwc_volume.designs[("stream", *plan[:3])] += 1
    return out


# launches of the kernel, in all, by (B, H, W, C, D, G) and by design
# ("stream", W tile, groups a slice, disparities a chunk)
build_gwc_volume.launches = 0
build_gwc_volume.shapes = Counter()
build_gwc_volume.designs = Counter()


def gwc_volume_backward_reference(left: torch.Tensor, right: torch.Tensor,
                                  grad: torch.Tensor, max_disp: int,
                                  num_groups: int
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain gradients of the gwc volume given its gradient ``grad [B, D,
    H, W, G]``: with g the group of channel c and cpg = C / G,
    ``dl[b,h,w,c] = 1/cpg · Σ_{d ≤ w} grad[b,d,h,w,g] · right[b,h,w-d,c]``
    and ``dr[b,h,u,c] = 1/cpg · Σ_{u+d < W} grad[b,d,h,u+d,g] ·
    left[b,h,u+d,c]``, summed in float32 (float64 for float64
    features), in the features' type."""
    b, h, w, c = left.shape
    cpg = c // num_groups
    acc = torch.promote_types(left.dtype, torch.float32)
    gx = grad.to(acc).repeat_interleave(cpg, dim=-1) / cpg   # [B, D, H, W, C]
    lf, rf = left.to(acc), right.to(acc)
    dl, dr = torch.zeros_like(lf), torch.zeros_like(rf)
    for d in range(min(max_disp, w)):
        dl[:, :, d:] += gx[:, d, :, d:] * rf[:, :, :w - d]
        dr[:, :, :w - d] += gx[:, d, :, d:] * lf[:, :, d:]
    return dl.to(left.dtype), dr.to(right.dtype)


class GwcBackwardPlan(NamedTuple):
    """How the K1 backward kernel cuts a launch: W tile `tw`, pixels a
    thread's strip `strip`, groups a thread `ng` (see
    ``csrc/gwc_volume.cu``)."""
    tw: int
    strip: int
    ng: int


def gwc_backward_plan(c: int, g: int, dtype: torch.dtype,
                      grad_align: int = 16) -> GwcBackwardPlan:
    """The K1 backward kernel's plan for ``[.., C]`` features of `dtype` in
    `g` groups, with the gradient's base aligned to `grad_align` bytes: a
    block is one row of a `GWC_TILE_W`-pixel W tile and one of the two
    outputs; a thread owns 2 groups in bfloat16 where G is even (one
    bf16x2 word of the gradient a load, on a 4-byte aligned base), else 1,
    and a strip of `gwc_strip` pixels, as in the forward."""
    ng = (2 if dtype == torch.bfloat16 and g % 2 == 0 and grad_align % 4 == 0
          else 1)
    return GwcBackwardPlan(GWC_TILE_W, gwc_strip(c // g, ng), ng)


def gwc_volume_backward(left: torch.Tensor, right: torch.Tensor,
                        grad: torch.Tensor, max_disp: int, num_groups: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(dl, dr)`` of `build_gwc_volume`'s features given the
    volume's gradient ``grad [B, D, H, W, G]``.

    CPU tensors take `gwc_volume_backward_reference`; CUDA tensors launch
    the backward kernel (the forward's types, layouts and C / G; `grad`
    contiguous in the features' type), cut as `gwc_backward_plan` says, or
    raise. Every output is written once, without atomics: the same inputs
    give the same bits in every run.
    """
    if _cuda.on_cpu(left):
        return gwc_volume_backward_reference(left, right, grad, max_disp,
                                             num_groups)
    _check_gwc(left, right, max_disp, num_groups)
    b, h, w, c = left.shape
    if (grad.shape != (b, max_disp, h, w, num_groups)
            or grad.dtype != left.dtype or grad.device != left.device
            or not grad.is_contiguous()):
        raise ValueError(f"grad must be a contiguous {left.dtype} [B, D, H, "
                         f"W, G] = {(b, max_disp, h, w, num_groups)} tensor "
                         f"on {left.device}, got {grad.dtype} "
                         f"{tuple(grad.shape)}")
    return _launch_gwc_backward(left, right, grad, max_disp, num_groups)


def _launch_gwc_backward(left: torch.Tensor, right: torch.Tensor,
                         grad: torch.Tensor, max_disp: int, num_groups: int
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    b, h, w, c = left.shape
    code = _cuda.dtype_code(left)
    dl, dr = torch.empty_like(left), torch.empty_like(right)
    if dl.numel() == 0:
        return dl, dr
    bits = grad.data_ptr() | 16
    plan = gwc_backward_plan(c, num_groups, left.dtype, bits & -bits)
    lib = _cuda.library("gwc_volume")
    with torch.cuda.device(left.device):
        rc = lib.gwc_volume_backward(
            left.data_ptr(), right.data_ptr(), grad.data_ptr(), dl.data_ptr(),
            dr.data_ptr(), b, h, w, c, max_disp, num_groups, code, *plan,
            _cuda.stream_of(left))
    _cuda.check(lib, rc, "gwc_volume_backward")
    gwc_volume_backward.launches += 1
    gwc_volume_backward.shapes[(b, h, w, c, max_disp, num_groups)] += 1
    gwc_volume_backward.designs[("window", *plan)] += 1
    return dl, dr


# launches of the backward kernel, in all, by (B, H, W, C, D, G) and by
# design ("window", W tile, strip, groups a thread)
gwc_volume_backward.launches = 0
gwc_volume_backward.shapes = Counter()
gwc_volume_backward.designs = Counter()


def concat_volume_reference(left: torch.Tensor, right: torch.Tensor,
                            max_disp: int, mask_left: bool = True
                            ) -> torch.Tensor:
    """Plain concatenation volume: the left features broadcast over D (zero
    where w < d with `mask_left`) beside the shifted right stack."""
    b, h, w, c = left.shape
    left_b = left[:, None].expand(b, max_disp, h, w, c)
    if mask_left:
        d = torch.arange(max_disp, device=left.device)[:, None]
        valid = torch.arange(w, device=left.device)[None, :] >= d   # [D, W]
        left_b = left_b * valid[None, :, None, :, None].to(left.dtype)
    return torch.cat([left_b, shifted_right_stack(right, max_disp)], dim=-1)


CONCAT_THREADS = 256            # the K6 kernel's most threads a block
CONCAT_MAX_SMEM = 96 * 1024     # bytes of a block's two staged rows, at most


class ConcatPlan(NamedTuple):
    """How the K6 kernel cuts a launch: bytes a store `vb`, bytes a shared
    word `sb`, W tile `tw`, disparities a run `dr`, threads a block
    `threads` (see ``csrc/concat_volume.cu``)."""
    vb: int
    sb: int
    tw: int
    dr: int
    threads: int


def concat_smem(tw: int, dr: int, w: int, c: int, size: int) -> int:
    """Shared bytes of a K6 block: the left tile (16-byte padded) and the
    right pixels its run of disparities reaches."""
    return -(-tw * c * size // 16) * 16 + min(w, tw + dr - 1) * c * size


def concat_plan(b: int, h: int, w: int, c: int, d: int, dtype: torch.dtype,
                sms: int) -> ConcatPlan:
    """The K6 kernel's plan for a ``[b, d, h, w, 2c]`` volume of `dtype` on
    a card of `sms` SMs. A block stages one row's left and right pixels (a
    W tile of 8k pixels where the row passes `CONCAT_MAX_SMEM`) and writes
    a run of disparities of it. Runs are cut short enough for 2 blocks an
    SM where D allows, or 1 where a half pixel is a multiple of 16 bytes
    (the rows are then staged with 16-byte copies, and longer runs amortise
    them); a run of one plane reads its rows from device memory unstaged.
    (On the H100 these runs were as fast as 4 blocks an SM at GwcNet_GC's
    and ACVNet's volumes, and faster at CFNet's three.) Stores are 16 bytes
    where the row's bytes (and the tile's) are a multiple of 16, else 8 or
    4, assembled from the widest shared words that divide a half pixel. The
    block's stores are spread evenly over the fewest rounds of at most
    `CONCAT_THREADS`."""
    size = 4 if dtype == torch.float32 else 2
    tw = w
    while concat_smem(tw, 1, w, c, size) > CONCAT_MAX_SMEM:
        if tw <= 8:
            raise ValueError(f"no K6 plan fits shared memory at C={c}")
        tw = max(8, tw // 2 // 8 * 8)
    rows = b * h * -(-w // tw)
    per_sm = 1 if (c * size) % 16 == 0 else 2
    dr = max(1, d // min(d, -(-per_sm * sms // rows)))
    while concat_smem(tw, dr, w, c, size) > CONCAT_MAX_SMEM:
        dr = -(-dr // 2)
    vb = next(v for v in (16, 8, 4)
              if (w * 2 * c * size) % v == 0 and (tw * 2 * c * size) % v == 0)
    sb = next(v for v in (16, 8, 4, 2) if v <= vb and (c * size) % v == 0)
    stores = tw * 2 * c * size // vb
    per_round = -(-stores // -(-stores // CONCAT_THREADS))
    return ConcatPlan(vb, sb, tw, dr, -(-per_round // 32) * 32)


def build_concat_volume(left: torch.Tensor, right: torch.Tensor,
                        max_disp: int, mask_left: bool = True
                        ) -> torch.Tensor:
    """Concatenation cost volume ``[B, D, H, W, 2C]``:
    ``[left[b,h,w] · (w ≥ d), right[b,h,w-d]]`` on the channel axis, the
    right half zero where w < d. ``mask_left=False`` keeps the left features
    at every d (ACVNet, IGEV, FoundationStereo).

    CPU tensors take `concat_volume_reference` (autograd differentiates
    it); CUDA tensors launch the kernel, with either `mask_left` (float32 or
    bfloat16, contiguous ``[B, H, W, C]``), cut as `concat_plan` says, or
    raise. On the card the volume is differentiable: its backward launches
    the backward kernel (`concat_volume_backward`).
    """
    if _cuda.on_cpu(left):
        return concat_volume_reference(left, right, max_disp, mask_left)
    _check_features(left, right)
    if max_disp < 1:
        raise ValueError(f"bad max_disp {max_disp}")
    return _ConcatVolume.apply(left, right, max_disp, bool(mask_left))


class _ConcatVolume(torch.autograd.Function):
    """K6 with its gradient: the forward kernel, and the backward kernel
    (`concat_volume_backward`) for the features' gradients."""

    @staticmethod
    def forward(ctx, left, right, max_disp, mask_left):
        ctx.volume = (max_disp, mask_left)
        return _launch_concat_volume(left, right, max_disp, mask_left)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        dl, dr = concat_volume_backward(grad.contiguous(), *ctx.volume)
        return dl, dr, None, None


def _launch_concat_volume(left: torch.Tensor, right: torch.Tensor,
                          max_disp: int, mask_left: bool) -> torch.Tensor:
    b, h, w, c = left.shape
    code = _cuda.dtype_code(left)
    out = torch.empty((b, max_disp, h, w, 2 * c), dtype=left.dtype,
                      device=left.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(left.device).multi_processor_count
    plan = concat_plan(b, h, w, c, max_disp, left.dtype, sms)
    lib = _cuda.library("concat_volume")
    with torch.cuda.device(left.device):
        rc = lib.concat_volume(left.data_ptr(), right.data_ptr(),
                               out.data_ptr(), b, h, w, c, max_disp,
                               int(mask_left), code, *plan,
                               _cuda.stream_of(left))
    _cuda.check(lib, rc, "concat_volume")
    build_concat_volume.launches += 1
    build_concat_volume.shapes[(b, h, w, c, max_disp, bool(mask_left))] += 1
    build_concat_volume.designs[("rows", *plan[:4])] += 1
    return out


# launches of the kernel, in all, by (B, H, W, C, D, mask_left) and by
# design ("rows", bytes a store, bytes a shared word, W tile, disparities a
# run)
build_concat_volume.launches = 0
build_concat_volume.shapes = Counter()
build_concat_volume.designs = Counter()


def concat_volume_backward_reference(grad: torch.Tensor, max_disp: int,
                                     mask_left: bool = True
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain gradients of the concat volume's features given its gradient
    ``grad [B, D, H, W, 2C]``: ``dl[b,h,w,c] = Σ_{d ≤ w} grad[b,d,h,w,c]``
    (``Σ_d`` without `mask_left`) and ``dr[b,h,u,c] = Σ_{u+d < W}
    grad[b,d,h,u+d,C+c]``, summed in float32 (float64 for a float64
    gradient), in the gradient's type. ``[B, H, W, C]`` each."""
    b, _, h, w, c2 = grad.shape
    c = c2 // 2
    g = grad.to(torch.promote_types(grad.dtype, torch.float32))
    dl = g.new_zeros((b, h, w, c))
    dr = g.new_zeros((b, h, w, c))
    for d in range(max_disp):
        if mask_left:
            dl[:, :, d:] += g[:, d, :, d:, :c]
        else:
            dl += g[:, d, ..., :c]
        if d < w:
            dr[:, :, :w - d] += g[:, d, :, d:, c:]
    return dl.to(grad.dtype), dr.to(grad.dtype)


CONCAT_BWD_THREADS = 256     # the K6 backward kernel's threads a block


class ConcatBackwardPlan(NamedTuple):
    """How the K6 backward kernel cuts a launch: channels a thread item
    `vec`, threads a block `threads` (see ``csrc/concat_volume.cu``)."""
    vec: int
    threads: int


def concat_backward_plan(c: int, dtype: torch.dtype,
                         align: int = 16) -> ConcatBackwardPlan:
    """The K6 backward kernel's plan for ``[.., 2C]`` gradients of `dtype`
    whose bases (the gradient's and both outputs') are aligned to `align`
    bytes: a thread item is `vec` channels of one output pixel, read as one
    word of each gradient plane: the widest of 16, 8, 4 or 2 bytes whose
    channels divide C (so that a word never straddles the halves) and
    whose bytes divide `align`."""
    size = 4 if dtype == torch.float32 else 2
    for v in (16, 8, 4, 2):
        if v >= size and c % (v // size) == 0 and align % v == 0:
            return ConcatBackwardPlan(v // size, CONCAT_BWD_THREADS)
    return ConcatBackwardPlan(1, CONCAT_BWD_THREADS)


def concat_volume_backward(grad: torch.Tensor, max_disp: int,
                           mask_left: bool = True
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(dl, dr)`` of `build_concat_volume`'s features given the
    volume's gradient ``grad [B, D, H, W, 2C]``.

    CPU tensors take `concat_volume_backward_reference`; CUDA tensors
    launch the backward kernel (float32 or bfloat16, `grad` contiguous),
    cut as `concat_backward_plan` says, or raise. Every output is written
    once, without atomics: the same inputs give the same bits in every
    run.
    """
    if _cuda.on_cpu(grad):
        return concat_volume_backward_reference(grad, max_disp, mask_left)
    if grad.device.type != "cuda":
        raise ValueError(f"unsupported device {grad.device}")
    if (grad.dim() != 5 or grad.shape[1] != max_disp or grad.shape[-1] % 2
            or not grad.is_contiguous()):
        raise ValueError(f"grad must be a contiguous [B, D={max_disp}, H, W, "
                         f"2C] tensor, got {tuple(grad.shape)}")
    return _launch_concat_backward(grad, max_disp, mask_left)


def _launch_concat_backward(grad: torch.Tensor, max_disp: int,
                            mask_left: bool
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    b, d, h, w, c2 = grad.shape
    c = c2 // 2
    code = _cuda.dtype_code(grad)
    dl = torch.empty((b, h, w, c), dtype=grad.dtype, device=grad.device)
    dr = torch.empty_like(dl)
    if dl.numel() == 0:
        return dl, dr
    bits = grad.data_ptr() | dl.data_ptr() | dr.data_ptr() | 16
    plan = concat_backward_plan(c, grad.dtype, bits & -bits)
    lib = _cuda.library("concat_volume")
    with torch.cuda.device(grad.device):
        rc = lib.concat_volume_backward(
            grad.data_ptr(), dl.data_ptr(), dr.data_ptr(), b, h, w, c, d,
            int(mask_left), code, *plan, _cuda.stream_of(grad))
    _cuda.check(lib, rc, "concat_volume_backward")
    concat_volume_backward.launches += 1
    concat_volume_backward.shapes[(b, h, w, c, d, bool(mask_left))] += 1
    concat_volume_backward.designs[("direct", *plan)] += 1
    return dl, dr


# launches of the backward kernel, in all, by (B, H, W, C, D, mask_left) and
# by design ("direct", channels a thread item, threads a block)
concat_volume_backward.launches = 0
concat_volume_backward.shapes = Counter()
concat_volume_backward.designs = Counter()


def gather_right_by_samples_reference(right: torch.Tensor,
                                      samples: torch.Tensor,
                                      max_shift: int | None = None
                                      ) -> torch.Tensor:
    """Plain gather: ``out[b,s,h,w,c] = right[b, h, w - d, c]`` with
    ``d = int(samples[b,s,h,w])`` (clamped to ``[0, max_shift]`` when it is
    given), zero where ``w - d`` is off the image. ``[B, S, H, W, C]``."""
    if max_shift is not None:
        samples = samples.clamp(0, max_shift)
    b, h, w, c = right.shape
    x = (torch.arange(w, device=right.device)[None, None, None, :]
         - samples.to(torch.int64))                               # [B,S,H,W]
    valid = (x >= 0) & (x <= w - 1)
    s = samples.shape[1]
    idx = x.clamp(0, w - 1)[..., None].expand(b, s, h, w, c)
    src = right[:, None].expand(b, s, h, w, c)
    return torch.gather(src, 3, idx) * valid[..., None].to(right.dtype)


GATHER_THREADS = 256        # the K4 kernel's most threads a block
GATHER_TILE_W = 32          # pixels of a row a K4 block
GATHER_ITEMS_PER_SM = 512   # thread items a K4 launch keeps an SM, at least


class GatherPlan(NamedTuple):
    """How the K4 kernel cuts a launch: pixels of a row a block `tw`,
    threads a block `threads`, bytes a word `vb`, samples a thread item
    `sc` (see ``csrc/sample_gather.cu``)."""
    tw: int
    threads: int
    vb: int
    sc: int


def gather_plan(b: int, h: int, w: int, c: int, s: int, dtype: torch.dtype,
                sms: int, align: int = 16) -> GatherPlan:
    """The K4 kernel's plan for a ``[b, s, h, w, c]`` gather from ``[b, h,
    w, c]`` features of `dtype` on a card of `sms` SMs, with both bases
    aligned to `align` bytes. A thread item is one pixel and one word of
    its row: the widest of 16, 8, 4 or 2 bytes that divides the row's bytes
    and `align`. A block is `GATHER_TILE_W` pixels of one row (at least a
    warp's items, at most the row), its items spread evenly over the fewest
    rounds of at most `GATHER_THREADS` threads. An item copies its word at
    `sc` samples: all S, halved while the launch has under
    `GATHER_ITEMS_PER_SM` items an SM (at CFNet's 1/4 stage: 8 samples an
    item). On the H100 this was the fastest, or within the noise of it, of
    blocks of 8-128 pixels and runs of 1-16 samples at both of CFNet's
    stages in both types. The kernel stages nothing in shared memory, so
    every shape has a plan."""
    size = 4 if dtype == torch.float32 else 2
    vb = next(v for v in (16, 8, 4, 2)
              if (c * size) % v == 0 and align % v == 0)
    wpp = c * size // vb
    tw = min(max(GATHER_TILE_W, -(-32 // wpp)), w)
    sc = s
    while sc > 1 and b * h * w * wpp * -(-s // sc) < GATHER_ITEMS_PER_SM * sms:
        sc = -(-sc // 2)
    items = tw * wpp
    per_round = -(-items // -(-items // GATHER_THREADS))
    return GatherPlan(tw, -(-per_round // 32) * 32, vb, sc)


def gather_right_by_samples(right: torch.Tensor, samples: torch.Tensor,
                            max_shift: int | None = None) -> torch.Tensor:
    """Right features at integer disparity samples ``[B, S, H, W]``:
    ``out[b,s,h,w,c] = right[b, h, w - samples[b,s,h,w], c]``, zero off the
    image (CFNet's ``SpatialTransformer``). ``[B, S, H, W, C]``.

    Samples are clamped to ``[0, max_shift]`` and truncated to integers.
    CPU tensors take `gather_right_by_samples_reference`; CUDA tensors launch
    the kernel (features float32 or bfloat16, samples float32, `max_shift`
    given), cut as `gather_plan` says, or raise. On the card the output is
    differentiable in `right`: its backward launches the backward kernel
    (`gather_right_by_samples_backward`); the samples get no gradient.
    """
    if _cuda.on_cpu(right):
        return gather_right_by_samples_reference(right, samples, max_shift)
    _check_features(right)
    _check_samples(right, samples, max_shift)
    return _GatherRight.apply(right, samples, max_shift)


class _GatherRight(torch.autograd.Function):
    """K4 with its gradient: the forward kernel, and the backward kernel
    (`gather_right_by_samples_backward`) for the right features'
    gradient."""

    @staticmethod
    def forward(ctx, right, samples, max_shift):
        ctx.save_for_backward(samples)
        ctx.max_shift = max_shift
        return _launch_gather(right, samples, max_shift)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (samples,) = ctx.saved_tensors
        dright = gather_right_by_samples_backward(grad.contiguous(), samples,
                                                  ctx.max_shift)
        return dright, None, None


def _launch_gather(right: torch.Tensor, samples: torch.Tensor,
                   max_shift: int) -> torch.Tensor:
    b, h, w, c = right.shape
    s = samples.shape[1]
    code = _cuda.dtype_code(right)
    out = torch.empty((b, s, h, w, c), dtype=right.dtype, device=right.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(right.device).multi_processor_count
    bits = right.data_ptr() | out.data_ptr() | 16
    align = bits & -bits           # the bases' alignment, at most 16 bytes
    plan = gather_plan(b, h, w, c, s, right.dtype, sms, align)
    lib = _cuda.library("sample_gather")
    with torch.cuda.device(right.device):
        rc = lib.gather_right_by_samples(
            right.data_ptr(), samples.data_ptr(), out.data_ptr(), b, h, w, c,
            s, max_shift, code, *plan, _cuda.stream_of(right))
    _cuda.check(lib, rc, "gather_right_by_samples")
    gather_right_by_samples.launches += 1
    gather_right_by_samples.shapes[(b, h, w, c, s, max_shift)] += 1
    gather_right_by_samples.designs[("direct", *plan)] += 1
    return out


# launches of the kernel, in all, by (B, H, W, C, S, max_shift) and by
# design ("direct", pixels a block, threads a block, bytes a word, samples a
# thread item)
gather_right_by_samples.launches = 0
gather_right_by_samples.shapes = Counter()
gather_right_by_samples.designs = Counter()


def gather_right_by_samples_backward_reference(grad: torch.Tensor,
                                               samples: torch.Tensor,
                                               max_shift: int | None = None
                                               ) -> torch.Tensor:
    """Plain gradient of the gather's right features given its gradient
    ``grad [B, S, H, W, C]``: ``dright[b,h,u,c] = Σ_{s,x : x − d = u}
    grad[b,s,h,x,c]`` with d the clamped, truncated sample at ``(b, s, h,
    x)``, every ``(s, x)`` that read an on-image pixel scattered to the
    pixel it read (`index_add_`), summed in float32 (float64 for a float64
    gradient), in the gradient's type. ``[B, H, W, C]``."""
    if max_shift is not None:
        samples = samples.clamp(0, max_shift)
    b, s, h, w, c = grad.shape
    x = (torch.arange(w, device=grad.device)[None, None, None, :]
         - samples.to(torch.int64))                                # [B,S,H,W]
    valid = (x >= 0) & (x <= w - 1)
    g = grad.to(torch.promote_types(grad.dtype, torch.float32))
    g = g * valid[..., None].to(g.dtype)
    row = (torch.arange(b, device=grad.device)[:, None, None, None] * h
           + torch.arange(h, device=grad.device)[None, None, :, None]) * w
    target = (row + x.clamp(0, w - 1)).reshape(-1)
    out = g.new_zeros((b * h * w, c)).index_add_(0, target, g.reshape(-1, c))
    return out.view(b, h, w, c).to(grad.dtype)


SAMPLE_BWD_THREADS = 256              # the K4/K5 backward kernels' threads
SAMPLE_BWD_MAX_SMEM = 200 * 1024      # a block's staged lists' bytes, at most


class SampleBackwardPlan(NamedTuple):
    """How the K4 and K5 backward kernels cut a launch: threads a block
    `threads`, shared bytes a block `smem`, and (K5) groups a block
    `groups` (see ``csrc/sample_gather.cu``)."""
    threads: int
    smem: int
    groups: int


def sample_backward_plan(b: int, h: int, w: int, s: int, g: int,
                         sms: int) -> SampleBackwardPlan:
    """The K4/K5 backward kernels' plan for `b` x `h` rows of `w` pixels and
    `s` samples, K5's features in `g` groups, on a card of `sms` SMs: a
    block is one row (b, h); it stages the row's shifts and the lists of
    (s, x) that read each right pixel in shared memory, 4 bytes a shift, 4
    an entry and 8 a pixel (its list's offset and fill cursor). K5's rows
    are cut into chunks of whole groups, as few as give the launch 4
    blocks an SM (K4 takes every channel of a row: pass g = 1)."""
    smem = 4 * (2 * s * w + 2 * w + 1)
    if smem > SAMPLE_BWD_MAX_SMEM or w > 0xFFFF or s > 0x7FFF:
        raise ValueError(f"no K4/K5 backward plan for rows of W={w}, S={s}: "
                         f"{smem} shared bytes")
    chunks = min(g, -(-4 * sms // (b * h)))
    return SampleBackwardPlan(SAMPLE_BWD_THREADS, smem, -(-g // chunks))


def _check_sample_grad(grad: torch.Tensor, shape: tuple, dtype) -> None:
    if (grad.shape != shape or grad.dtype != dtype
            or not grad.is_contiguous()):
        raise ValueError(f"grad must be a contiguous {dtype} {shape} tensor,"
                         f" got {grad.dtype} {tuple(grad.shape)}")


def gather_right_by_samples_backward(grad: torch.Tensor,
                                     samples: torch.Tensor,
                                     max_shift: int | None = None
                                     ) -> torch.Tensor:
    """Gradient of `gather_right_by_samples`'s right features given its
    gradient ``grad [B, S, H, W, C]``.

    CPU tensors take `gather_right_by_samples_backward_reference`; CUDA
    tensors launch the backward kernel (the forward's types; `grad`
    contiguous), cut as `sample_backward_plan` says, or raise. Each right
    pixel's gradient is summed by one thread in a fixed order, without
    atomics: the same inputs give the same bits in every run.
    """
    if _cuda.on_cpu(grad):
        return gather_right_by_samples_backward_reference(grad, samples,
                                                          max_shift)
    b, s, h, w, c = grad.shape
    right = grad.new_empty((b, h, w, c))
    _check_features(right)
    _check_samples(right, samples, max_shift)
    _check_sample_grad(grad, (b, samples.shape[1], h, w, c), grad.dtype)
    return _launch_gather_backward(grad, samples, right, max_shift)


def _launch_gather_backward(grad: torch.Tensor, samples: torch.Tensor,
                            right: torch.Tensor, max_shift: int
                            ) -> torch.Tensor:
    """`right` (empty, the features' shape) filled with the gradient."""
    b, s, h, w, c = grad.shape
    code = _cuda.dtype_code(grad)
    if right.numel() == 0:
        return right
    sms = torch.cuda.get_device_properties(grad.device).multi_processor_count
    plan = sample_backward_plan(b, h, w, s, 1, sms)
    lib = _cuda.library("sample_gather")
    with torch.cuda.device(grad.device):
        rc = lib.gather_right_by_samples_backward(
            grad.data_ptr(), samples.data_ptr(), right.data_ptr(), b, h, w, c,
            s, max_shift, code, *plan[:2], _cuda.stream_of(grad))
    _cuda.check(lib, rc, "gather_right_by_samples_backward")
    gather_right_by_samples_backward.launches += 1
    gather_right_by_samples_backward.shapes[(b, h, w, c, s, max_shift)] += 1
    gather_right_by_samples_backward.designs[("sort", plan.threads)] += 1
    return right


# launches of the backward kernel, in all, by (B, H, W, C, S, max_shift) and
# by design ("sort", threads a block)
gather_right_by_samples_backward.launches = 0
gather_right_by_samples_backward.shapes = Counter()
gather_right_by_samples_backward.designs = Counter()


def concat_volume_from_samples(left: torch.Tensor, right: torch.Tensor,
                               samples: torch.Tensor,
                               max_shift: int | None = None) -> torch.Tensor:
    """Concatenation volume over per-pixel disparity samples (CFNet's
    cascade): ``[left, gather_right_by_samples(right)]`` on the channel axis.
    ``[B, S, H, W, 2C]``."""
    gathered = gather_right_by_samples(right, samples, max_shift)
    return torch.cat([left[:, None].expand_as(gathered), gathered], dim=-1)


def gwc_volume_from_samples_reference(left: torch.Tensor,
                                      right: torch.Tensor,
                                      samples: torch.Tensor, num_groups: int,
                                      max_shift: int | None = None
                                      ) -> torch.Tensor:
    """Plain version: the gathered right features correlated with the left
    ones. ``[B, S, H, W, G]``."""
    return groupwise_correlation(
        left[:, None],
        gather_right_by_samples_reference(right, samples, max_shift),
        num_groups)


SAMPLE_GWC_THREADS = 256   # the K5 kernel's most threads a block
SAMPLE_GWC_ROW_BYTES = 64  # bytes of one channel's row a K5 block covers


class SampleGwcPlan(NamedTuple):
    """How the K5 kernel cuts a launch: pixels of a row a block `tw`,
    threads a block `threads`, groups a thread item `ng` (see
    ``csrc/sample_gather.cu``)."""
    tw: int
    threads: int
    ng: int


def sample_gwc_slot(g: int, dtype: torch.dtype) -> int:
    """Groups a K5 thread item takes: as many as make one 8-byte store (2
    in float32, 4 in bfloat16) where they divide G, else 2 or 1."""
    for ng in (2,) if dtype == torch.float32 else (4, 2):
        if g % ng == 0:
            return ng
    return 1


def sample_gwc_plan(b: int, h: int, w: int, c: int, s: int, g: int,
                    dtype: torch.dtype, sms: int) -> SampleGwcPlan:
    """The K5 kernel's plan for a ``[b, s, h, w, g]`` volume from ``[b, h,
    w, c]`` features of `dtype` on a card of `sms` SMs. A block is `tw`
    pixels of one row with every group: 16 in float32, 32 in bfloat16
    (`SAMPLE_GWC_ROW_BYTES` of a channel's row; on the H100 this was the
    fastest at both of CFNet's stages, whose grids are then 600-4800
    short blocks, 4.5-36 an SM), halved while the grid has under 4 blocks an
    SM, but at least a warp's thread items and at most the row. A thread
    item is one pixel and `sample_gwc_slot` groups; the block's items are
    spread evenly over the fewest rounds of at most `SAMPLE_GWC_THREADS`
    threads. The kernel stages nothing in shared memory, so every shape has
    a plan."""
    slots = g // sample_gwc_slot(g, dtype)
    size = 4 if dtype == torch.float32 else 2
    tw = SAMPLE_GWC_ROW_BYTES // size
    while tw > 1 and b * h * -(-w // tw) < 4 * sms:
        tw //= 2
    tw = min(max(tw, -(-32 // slots)), w)       # a warp's items at least
    items = tw * slots
    per_round = -(-items // -(-items // SAMPLE_GWC_THREADS))
    return SampleGwcPlan(tw, -(-per_round // 32) * 32,
                         sample_gwc_slot(g, dtype))


def gwc_volume_from_samples(left: torch.Tensor, right: torch.Tensor,
                            samples: torch.Tensor, num_groups: int,
                            max_shift: int | None = None) -> torch.Tensor:
    """Group-wise correlation over per-pixel disparity samples:
    ``out[b,s,h,w,g] = mean_{c in g} left[b,h,w,c] · right[b,h,w-d,c]`` with
    d the clamped, truncated sample, zero off the image. ``[B, S, H, W, G]``.

    CPU tensors take `gwc_volume_from_samples_reference`; CUDA tensors launch
    the kernel, which never writes the gathered ``[B, S, H, W, C]`` tensor
    (features float32 or bfloat16, samples float32, `max_shift` given), cut
    as `sample_gwc_plan` says, or raise. On the card the volume is
    differentiable in the features: its backward launches the backward
    kernel (`gwc_volume_from_samples_backward`); the samples get no
    gradient.
    """
    if _cuda.on_cpu(left):
        return gwc_volume_from_samples_reference(left, right, samples,
                                                 num_groups, max_shift)
    _check_features(left, right)
    _check_samples(right, samples, max_shift)
    if left.shape[-1] % num_groups:
        raise ValueError(f"channels {left.shape[-1]} not divisible by groups "
                         f"{num_groups}")
    return _GwcFromSamples.apply(left, right, samples, num_groups, max_shift)


class _GwcFromSamples(torch.autograd.Function):
    """K5 with its gradient: the forward kernel, and the backward kernel
    (`gwc_volume_from_samples_backward`) for the features' gradients."""

    @staticmethod
    def forward(ctx, left, right, samples, num_groups, max_shift):
        ctx.save_for_backward(left, right, samples)
        ctx.volume = (num_groups, max_shift)
        return _launch_gwc_samples(left, right, samples, num_groups,
                                   max_shift)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        left, right, samples = ctx.saved_tensors
        dl, dr = gwc_volume_from_samples_backward(
            left, right, samples, grad.contiguous(), *ctx.volume)
        return dl, dr, None, None, None


def _launch_gwc_samples(left: torch.Tensor, right: torch.Tensor,
                        samples: torch.Tensor, num_groups: int,
                        max_shift: int) -> torch.Tensor:
    b, h, w, c = left.shape
    s = samples.shape[1]
    code = _cuda.dtype_code(left)
    out = torch.empty((b, s, h, w, num_groups), dtype=left.dtype,
                      device=left.device)
    if out.numel() == 0:
        return out
    sms = torch.cuda.get_device_properties(left.device).multi_processor_count
    plan = sample_gwc_plan(b, h, w, c, s, num_groups, left.dtype, sms)
    lib = _cuda.library("sample_gather")
    with torch.cuda.device(left.device):
        rc = lib.gwc_volume_from_samples(
            left.data_ptr(), right.data_ptr(), samples.data_ptr(),
            out.data_ptr(), b, h, w, c, s, num_groups, max_shift, code,
            *plan, _cuda.stream_of(left))
    _cuda.check(lib, rc, "gwc_volume_from_samples")
    gwc_volume_from_samples.launches += 1
    gwc_volume_from_samples.shapes[(b, h, w, c, s, num_groups,
                                    max_shift)] += 1
    gwc_volume_from_samples.designs[("direct", *plan)] += 1
    return out


# launches of the kernel, in all, by (B, H, W, C, S, G, max_shift) and by
# design ("direct", pixels a block, threads a block, groups a thread item)
gwc_volume_from_samples.launches = 0
gwc_volume_from_samples.shapes = Counter()
gwc_volume_from_samples.designs = Counter()


def gwc_volume_from_samples_backward_reference(
        left: torch.Tensor, right: torch.Tensor, samples: torch.Tensor,
        grad: torch.Tensor, num_groups: int, max_shift: int | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain gradients of the sampled gwc volume's features given its
    gradient ``grad [B, S, H, W, G]``: with g the group of channel c, cpg =
    C / G and d the clamped, truncated sample at ``(b, s, h, w)``,
    ``dl[b,h,w,c] = 1/cpg · Σ_s grad[b,s,h,w,g] · right[b,h,w-d,c]`` (a
    gather) and ``dr`` the gather's scatter
    (`gather_right_by_samples_backward_reference`) of ``grad[b,s,h,w,g] ·
    left[b,h,w,c] / cpg``, summed in float32 (float64 for float64
    features), in the features' type."""
    c = left.shape[3]
    acc = torch.promote_types(left.dtype, torch.float32)
    gx = grad.to(acc).repeat_interleave(c // num_groups, dim=-1) / (
        c // num_groups)                                      # [B, S, H, W, C]
    gathered = gather_right_by_samples_reference(right.to(acc), samples,
                                                 max_shift)
    dl = (gx * gathered).sum(1)
    dr = gather_right_by_samples_backward_reference(
        gx * left.to(acc)[:, None], samples, max_shift)
    return dl.to(left.dtype), dr.to(right.dtype)


def gwc_volume_from_samples_backward(left: torch.Tensor, right: torch.Tensor,
                                     samples: torch.Tensor,
                                     grad: torch.Tensor, num_groups: int,
                                     max_shift: int | None = None
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gradients ``(dl, dr)`` of `gwc_volume_from_samples`'s features given
    the volume's gradient ``grad [B, S, H, W, G]``.

    CPU tensors take `gwc_volume_from_samples_backward_reference`; CUDA
    tensors launch the backward kernel (the forward's types and layouts;
    `grad` contiguous in the features' type), cut as `sample_backward_plan`
    says, or raise. Every output is written once, by one thread summing in
    a fixed order, without atomics: the same inputs give the same bits in
    every run.
    """
    if _cuda.on_cpu(left):
        return gwc_volume_from_samples_backward_reference(
            left, right, samples, grad, num_groups, max_shift)
    _check_features(left, right)
    _check_samples(right, samples, max_shift)
    b, h, w, c = left.shape
    s = samples.shape[1]
    if num_groups < 1 or c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    _check_sample_grad(grad, (b, s, h, w, num_groups), left.dtype)
    return _launch_gwc_samples_backward(left, right, samples, grad,
                                        num_groups, max_shift)


def _launch_gwc_samples_backward(left: torch.Tensor, right: torch.Tensor,
                                 samples: torch.Tensor, grad: torch.Tensor,
                                 num_groups: int, max_shift: int
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    b, h, w, c = left.shape
    s = samples.shape[1]
    code = _cuda.dtype_code(left)
    dl, dr = torch.empty_like(left), torch.empty_like(right)
    if dl.numel() == 0:
        return dl, dr
    sms = torch.cuda.get_device_properties(left.device).multi_processor_count
    plan = sample_backward_plan(b, h, w, s, num_groups, sms)
    lib = _cuda.library("sample_gather")
    with torch.cuda.device(left.device):
        rc = lib.gwc_volume_from_samples_backward(
            left.data_ptr(), right.data_ptr(), samples.data_ptr(),
            grad.data_ptr(), dl.data_ptr(), dr.data_ptr(), b, h, w, c, s,
            num_groups, max_shift, code, *plan, _cuda.stream_of(left))
    _cuda.check(lib, rc, "gwc_volume_from_samples_backward")
    gwc_volume_from_samples_backward.launches += 1
    gwc_volume_from_samples_backward.shapes[(b, h, w, c, s, num_groups,
                                             max_shift)] += 1
    gwc_volume_from_samples_backward.designs[("sort", plan.threads,
                                              plan.groups)] += 1
    return dl, dr


# launches of the backward kernel, in all, by (B, H, W, C, S, G, max_shift)
# and by design ("sort", threads a block, groups a block)
gwc_volume_from_samples_backward.launches = 0
gwc_volume_from_samples_backward.shapes = Counter()
gwc_volume_from_samples_backward.designs = Counter()


def disparity_regression(prob: torch.Tensor, max_disp: int | None = None,
                         offset: float = 0.0) -> torch.Tensor:
    """Expectation of disparity over ``[B, D, H, W]`` probabilities →
    ``[B, H, W]``."""
    d = max_disp if max_disp is not None else prob.shape[1]
    values = torch.arange(d, dtype=prob.dtype, device=prob.device) + offset
    return torch.einsum("bdhw,d->bhw", prob, values)


def soft_argmax(cost: torch.Tensor, max_disp: int | None = None
                ) -> torch.Tensor:
    """Softmax over D of ``[B, D, H, W]`` costs, then disparity
    regression → ``[B, H, W]``."""
    return disparity_regression(torch.softmax(cost, dim=1), max_disp)


def disparity_variance(prob: torch.Tensor, disp: torch.Tensor
                       ) -> torch.Tensor:
    """Per-pixel variance of a ``[B, D, H, W]`` disparity distribution
    about ``disp [B, H, W]`` (CFNet's uncertainty) → ``[B, H, W]``."""
    d = torch.arange(prob.shape[1], dtype=prob.dtype,
                     device=prob.device)[None, :, None, None]
    return (prob * (d - disp[:, None]) ** 2).sum(1)


def disparity_variance_confidence(prob: torch.Tensor, samples: torch.Tensor,
                                  disp: torch.Tensor) -> torch.Tensor:
    """Variance of a distribution over per-pixel disparity samples:
    ``prob``, ``samples`` ``[B, S, H, W]``, ``disp [B, H, W]`` →
    ``[B, H, W]``."""
    return (prob * (disp[:, None] - samples) ** 2).sum(1)
