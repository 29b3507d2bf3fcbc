"""Plain 3×3×3 convolution, stride 1, zero padding 1, no bias.

Counterpart of ``stereo_toolbox_tpu/ops/pallas/conv3d.py``, with the same
arguments and layouts: ``x [B, D, H, W, Ci]``, ``kernel [3, 3, 3, Ci, Co]``,
float32 or bfloat16, accumulation in float32 and the output in x's type. The
JAX kernel's padding of Ci to 128 lanes and of W to 16 sublanes is TPU layout
and has no counterpart here.

`conv3d` launches a hand-written CUDA kernel (``csrc/conv3d.cu``) on a CUDA
tensor and runs the plain PyTorch version, `conv3d_reference`, on a CPU
tensor. Co = 1 (every classifier conv of the forwards) runs the "stencil"
design: the 27 tap partials of each staged voxel on the tensor cores
(bfloat16, or 3xTF32 for float32), then a 27-point stencil over them. Co >
1, and a Co = 1 launch with Ci over `STENCIL_MAX_CI`, run the "direct"
design.

`conv3d_concat_volume` is the 3×3×3 conv over PSMNet's masked concat volume
computed without building the volume (counterpart of
``stereo_toolbox_tpu/ops/conv3d.py::conv3d_concat_volume``): two 2D convs
on cuDNN, then strided copies and adds, whatever the depth. It has no
kernel of its own; `conv3d_concat_volume_reference` builds the volume and
convolves it.
"""

from __future__ import annotations

import functools
import heapq
from collections import Counter
from typing import NamedTuple

import torch
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.ops import _cuda
from stereo_toolbox_tpu_torch.ops.conv3d_fused import conv3d_fused_reference
from stereo_toolbox_tpu_torch.ops.volume import concat_volume_reference

# The stencil kernel's tile and the shared memory a block may take
STENCIL_TILE = (8, 32)             # output rows × columns of a block
STENCIL_STAGES = 3                 # staged input planes (a cp.async ring)
STENCIL_MAX_CI = 64                # K steps the stencil kernel is built for
STENCIL_MAX_SMEM = 227 * 1024
SM_SHARED = 228 * 1024             # shared memory of an H100 SM
STENCIL_BLOCKS_PER_SM = 2          # at most (256 threads of ~110-150 registers)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def stencil_smem(ci: int, dtype: torch.dtype) -> int:
    """Shared bytes of a stencil block (``csrc/conv3d.cu``'s
    ``StencilSmem``): `STENCIL_STAGES` staged planes of the tile and its
    halo, the float32 partials ``[27][356]`` and the weights ``[32 taps]``
    in rows like the staged ones."""
    th, tw = STENCIL_TILE
    npos = (th + 2) * (tw + 2)
    ps = (npos - 4 + 31) // 32 * 32 + 4
    if dtype == torch.float32:
        row, size = _round_up(ci, 8) + 4, 4
    else:
        row, size = _round_up(ci, 16), 2
    return (STENCIL_STAGES * npos + 32) * row * size + 27 * ps * 4


@functools.lru_cache(maxsize=None)
def stencil_run(b: int, d: int, h: int, w: int, ci: int, dtype: torch.dtype,
                sms: int) -> int:
    """Output planes a stencil block walks: the run length whose grid ends
    soonest when the card's block slots take the blocks in launch order
    (list scheduling), a block costing the planes it stages (its run and
    the two neighbour planes it re-stages) plus one. Blocks a slot: as many
    as shared memory allows, at most two. Kept per shape (a forward calls it
    once a launch)."""
    th, tw = STENCIL_TILE
    tiles = b * -(-h // th) * -(-w // tw)
    per_sm = SM_SHARED // (stencil_smem(ci, dtype) + 1024)
    slots = sms * max(1, min(STENCIL_BLOCKS_PER_SM, per_sm))

    def makespan(run):
        finish = [0] * slots
        for d0 in range(0, d, run):
            planes = min(d0 + run, d - 1) - max(d0 - 1, 0) + 1
            for _ in range(tiles):
                heapq.heapreplace(finish, finish[0] + planes + 1)
        return max(finish)

    return min(range(d, 0, -1), key=makespan)


def conv3d_reference(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv3d`` on the channels-first view, float32
    arithmetic for a bfloat16 `x`, cast back to ``x.dtype``."""
    w = kernel.permute(4, 3, 0, 1, 2).float()              # [Co, Ci, 3, 3, 3]
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w, padding=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def conv3d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``conv3d(x, kernel)``, SAME padding, ``[B, D, H, W, Co]``.

    CPU tensors take `conv3d_reference`; CUDA tensors launch the kernel
    (contiguous float32 or bfloat16 `x`, `kernel` in x's type) or raise.
    """
    if x.device.type == "cpu":
        return conv3d_reference(x, kernel)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 5 or not x.is_contiguous() or 0 in x.shape:
        raise ValueError(f"x must be a contiguous non-empty [B, D, H, W, Ci] "
                         f"tensor, got {tuple(x.shape)}")
    b, d, h, w, ci = x.shape
    if (kernel.dim() != 5 or kernel.shape[:4] != (3, 3, 3, ci)
            or kernel.shape[4] < 1):
        raise ValueError(f"kernel {tuple(kernel.shape)} is not [3, 3, 3, "
                         f"{ci}, Co]")
    co = kernel.shape[4]
    if kernel.dtype != x.dtype or kernel.device != x.device:
        raise ValueError("kernel must share x's dtype and device")
    code = _cuda.dtype_code(x)
    kernel = kernel.contiguous()
    out = torch.empty((b, d, h, w, co), dtype=x.dtype, device=x.device)
    lib = _cuda.library("conv3d")
    with torch.cuda.device(x.device):
        if (co == 1 and ci <= STENCIL_MAX_CI
                and stencil_smem(ci, x.dtype) <= STENCIL_MAX_SMEM):
            sms = torch.cuda.get_device_properties(
                x.device).multi_processor_count
            run = stencil_run(b, d, h, w, ci, x.dtype, sms)
            rc = lib.conv3d_stencil(x.data_ptr(), kernel.data_ptr(),
                                    out.data_ptr(), b, d, h, w, ci, code,
                                    run, _cuda.stream_of(x))
            design = ("stencil", run)
        else:
            rc = lib.conv3d_direct(x.data_ptr(), kernel.data_ptr(),
                                   out.data_ptr(), b, d, h, w, ci, co, code,
                                   _cuda.stream_of(x))
            design = ("direct",)
    _cuda.check(lib, rc, "conv3d")
    conv3d.launches += 1
    conv3d.shapes[(b, d, h, w, ci, co)] += 1
    conv3d.designs[design] += 1
    return out


# launches of the kernels, in all, by (B, D, H, W, Ci, Co) and by design
# (("stencil", output planes a block) | ("direct",))
conv3d.launches = 0
conv3d.shapes = Counter()
conv3d.designs = Counter()


# ------------------------------------------------ conv over a concat volume
#
# The masked concat volume V[d, h, w] = [L[h, w] · (w ≥ d), R[h, w − d]] (R
# zero off the image) is d-invariant in its left half and a diagonal shift
# in its right half, so a 3×3×3 SAME conv over it depends on d only through
# u = w − d and through which kd taps fall inside [0, D) (the plane's "set":
# all three inside for the inner planes, kd = 0 or kd = 2 outside at the
# first and last). With K the kernel's left and right halves KL, KR:
#
#   * left: the tap (kd, kh, kw) reads L[h + kh − 1, w + kw − 1] where
#     u ≥ kd − kw. For u ≥ 2 every tap is in, for u ≤ −3 none, between
#     them (the four bands of the mask boundary) some; so the left half is
#     one of five 3×3 convs of L by set, t = min(u, 2) ≥ −2: kernel Σ KL[kd,
#     kh, kw] over the set's kd with kd − kw ≤ t, and zero for u ≤ −3;
#   * right: the tap reads R[h + kh − 1, u + kw − kd], so the right half is
#     one 3×5 conv of R by set, kernel KR[kd, kh, kw] at column kw − kd + 2,
#     read at column u, except at w = W − 1 where the volume's zero padding
#     drops the kw = 2 taps: there the same conv without them.
#
# Each family's kernels are stacked along the output channels of one conv.
# The right conv (column u + 2 holds u, −2 ≤ u ≤ W + 1) is then padded on
# the left by D − 3 columns of its bias (u ≤ −3 reads only zeros), so that
# column u + D − 1 holds u for every u of the volume, −(D − 1) ≤ u ≤ W − 1.
# (Padding R by D + 1 columns instead, in the conv or before it, made cuDNN
# take a generic kernel in bfloat16 or its FFT in float32 on the H100, each
# many times slower.) The inner planes are then assembled all at once: the right half as one strided copy (plane d is the W-wide window of
# the right conv that starts at column D − 1 − d: an unfolded view, flipped
# over d) with column W − 1 copied from the conv without the kw = 2 taps,
# the left half's u ≥ 2 region as one masked add and its four bands as
# adds through diagonal views of the output; the first and last planes are
# gathered row by row. ~3 GFLOP at PSMNet's
# 480×640 (D 48, C 32, Co 32) instead of the ~100 of the 3D conv over the
# built volume. An eval BatchNorm folds in: its scale into the kernels, its
# bias into the right conv's bias (every output reads one right value).

LEFT_BANDS = 5     # left kernels a set: t = -2 .. 2


def concat_conv_sets(max_disp: int) -> list[tuple[bool, bool]]:
    """The set of each output plane d: whether its kd = 0 and kd = 2 taps
    read a plane of the volume."""
    return [(d >= 1, d <= max_disp - 2) for d in range(max_disp)]


class ConcatConvWeights(NamedTuple):
    """`conv3d_concat_volume`'s 2D kernels for a depth: ``left [(1 + 5n) ·
    Co, C, 3, 3]`` (a zero kernel, then five a set) and ``right [2n · Co,
    C, 3, 5]`` (every tap, then without kw = 2, a set), in ``F.conv2d``'s
    layout, n the distinct sets of the planes; the right conv's ``bias [2n
    · Co]`` or None; the set of each plane as an index into the n; and
    Co."""
    left: torch.Tensor
    right: torch.Tensor
    bias: torch.Tensor | None
    plane_sets: tuple[int, ...]
    co: int


def pack_concat_conv3d_weight(kernel: torch.Tensor, max_disp: int,
                              scale: torch.Tensor | None = None,
                              bias: torch.Tensor | None = None,
                              dtype: torch.dtype | None = None
                              ) -> ConcatConvWeights:
    """``kernel [3, 3, 3, 2C, Co]`` (left channels first, as the volume),
    with an optional per-channel ``scale`` and ``bias`` (an eval
    BatchNorm), → `ConcatConvWeights` for depth `max_disp`, combined in
    float32 and cast once to `dtype` (the kernel's by default)."""
    if (kernel.dim() != 5 or kernel.shape[:3] != (3, 3, 3)
            or kernel.shape[3] % 2):
        raise ValueError(f"kernel {tuple(kernel.shape)} is not [3, 3, 3, 2C, "
                         f"Co]")
    if max_disp < 1:
        raise ValueError(f"bad max_disp {max_disp}")
    dtype = dtype or kernel.dtype
    c, co = kernel.shape[3] // 2, kernel.shape[4]
    k = kernel.float()
    if scale is not None:
        k = k * scale.float()
    kl, kr = k[..., :c, :], k[..., c:, :]
    plane = concat_conv_sets(max_disp)
    sets = sorted(set(plane))
    left, right = [kl.new_zeros((3, 3, c, co))], []
    for has0, has2 in sets:
        kds = [d for d, inside in enumerate((has0, True, has2)) if inside]
        for t in range(-2, 3):
            m = torch.tensor([[d in kds and d - w <= t for w in range(3)]
                              for d in range(3)], dtype=k.dtype,
                             device=k.device)                   # [kd, kw]
            left.append(torch.einsum("dw,dhwio->hwio", m, kl))
        for kws in (range(3), range(2)):       # every tap; w = W - 1's
            k5 = kr.new_zeros((3, 5, c, co))
            for d in kds:
                for w in kws:
                    k5[:, w - d + 2] += kr[d, :, w]
            right.append(k5)

    def stack(ks):
        # [G, kh, kw, C, Co] -> [G·Co, C, kh, kw]
        return (torch.stack(ks).permute(0, 4, 3, 1, 2).flatten(0, 1)
                .to(dtype).contiguous())
    rbias = (None if bias is None
             else bias.float().repeat(len(right)).to(dtype))
    return ConcatConvWeights(stack(left), stack(right), rbias,
                             tuple(sets.index(p) for p in plane), co)


@functools.lru_cache(maxsize=16)
def _concat_conv_rows(max_disp: int, h: int, w: int, plane_sets: tuple,
                      planes: tuple, device: torch.device
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row indices of the gathers that make `planes`, ``[len(planes) · H ·
    W]`` int32 each: the row of the left conv's ``[H · W · GL]`` and of the
    right conv's ``[H · (W + D + 1) · GR]`` rows that output (d, h, w)
    reads."""
    d = torch.tensor(planes, device=device)[:, None, None]
    hh = torch.arange(h, device=device)[None, :, None]
    ww = torch.arange(w, device=device)[None, None, :]
    u = ww - d                                                    # [P, 1, W]
    p = torch.tensor(plane_sets, device=device)[d]
    n = len(set(plane_sets))
    gl, gr, wr = 1 + LEFT_BANDS * n, 2 * n, w + max_disp + 1
    il = torch.where(u < -2, 0, 1 + p * LEFT_BANDS + u.clamp(max=2) + 2)
    ir = 2 * p + (ww == w - 1).long()
    left = (hh * w + ww) * gl + il
    right = (hh * wr + u + max_disp - 1) * gr + ir
    return (left.to(torch.int32).flatten(), right.to(torch.int32).flatten())


@functools.lru_cache(maxsize=16)
def _inside_band(max_disp: int, w: int, device: torch.device,
                 dtype: torch.dtype) -> torch.Tensor:
    """``[1, D, 1, W, 1]``: 1 where u = w − d ≥ 2, else 0."""
    u = torch.arange(w, device=device) - torch.arange(max_disp,
                                                      device=device)[:, None]
    return (u >= 2).to(dtype)[None, :, None, :, None]


def conv3d_concat_volume(left: torch.Tensor, right: torch.Tensor,
                         kernel: torch.Tensor | ConcatConvWeights,
                         max_disp: int, scale: torch.Tensor | None = None,
                         bias: torch.Tensor | None = None,
                         relu: bool = False) -> torch.Tensor:
    """``relu?(conv3d(build_concat_volume(left, right, D), kernel) · scale +
    bias)``, SAME, stride 1, without building the volume: ``left, right
    [B, H, W, C]`` → ``[B, D, H, W, Co]`` in left's type.

    `kernel` is ``[3, 3, 3, 2C, Co]`` (with `scale` and `bias` folded in on
    each call) or `ConcatConvWeights` packed for this depth with them (as
    the eval `nn.layers.ConcatVolumeConvBNAct` passes it, from its cache).
    The same PyTorch ops run on the CPU and on the card."""
    b, h, w, c = left.shape
    d = max_disp
    if right.shape != left.shape:
        raise ValueError(f"features {tuple(left.shape)} and "
                         f"{tuple(right.shape)} differ")
    if not isinstance(kernel, ConcatConvWeights):
        kernel = pack_concat_conv3d_weight(kernel, d, scale, bias,
                                           left.dtype)
    if len(kernel.plane_sets) != d:
        raise ValueError(f"weights packed for D={len(kernel.plane_sets)}, "
                         f"not {d}")
    co = kernel.co
    lf = F.conv2d(left.permute(0, 3, 1, 2), kernel.left, padding=1)
    rf = F.conv2d(right.permute(0, 3, 1, 2), kernel.right, kernel.bias,
                  padding=(1, 4))
    rf = F.pad(rf.permute(0, 2, 3, 1), (0, 0, d - 3, 0))  # column u + D - 1
    if kernel.bias is not None and d > 3:
        rf[:, :, :d - 3] = kernel.bias
    lf = lf.permute(0, 2, 3, 1).unflatten(-1, (-1, co))   # [B, H, W, GL, Co]
    rf = rf.unflatten(-1, (-1, co))                       # [B, H, W', GR, Co]
    edges = (0, d - 1) if d >= 3 else tuple(range(d))
    if d >= 3:
        s = kernel.plane_sets[1]                  # the inner planes' set
        g = rf[:, :, :, 2 * s]                              # [B, H, W', Co]
        # plane d: columns D - 1 - d + w of the right conv, w < W
        out = g.unfold(2, w, 1)[:, :, :d].permute(0, 2, 1, 4, 3).flip(1)
        last = rf[:, :, w - 1:w + d - 1, 2 * s + 1]     # w = W - 1, d reversed
        out[:, :, :, w - 1] = last.flip(2).transpose(1, 2)
        bands = lf[:, :, :, 1 + LEFT_BANDS * s:1 + LEFT_BANDS * (s + 1)]
        out.addcmul_(bands[:, None, :, :, 4],
                     _inside_band(d, w, left.device, out.dtype))
        for t in range(-2, 2):
            diag = out.diagonal(offset=t, dim1=1, dim2=3)   # [B, H, Co, n]
            w0 = max(t, 0)
            diag += bands[:, :, w0:w0 + diag.shape[-1], t + 2].transpose(2, 3)
    rows_l, rows_r = _concat_conv_rows(d, h, w, kernel.plane_sets, edges,
                                       left.device)
    edge = torch.index_select(lf.reshape(b, -1, co), 1, rows_l)
    edge += torch.index_select(rf.reshape(b, -1, co), 1, rows_r)
    edge = edge.view(b, len(edges), h, w, co)
    if d >= 3:
        out[:, 0], out[:, d - 1] = edge[:, 0], edge[:, 1]
    else:
        out = edge
    if relu:
        out.relu_()
    return out


def conv3d_concat_volume_reference(left: torch.Tensor, right: torch.Tensor,
                                   kernel: torch.Tensor, max_disp: int,
                                   scale: torch.Tensor | None = None,
                                   bias: torch.Tensor | None = None,
                                   relu: bool = False) -> torch.Tensor:
    """Plain version: the masked concat volume built
    (`concat_volume_reference`), then ``F.conv3d`` and the epilogue."""
    return conv3d_fused_reference(
        concat_volume_reference(left, right, max_disp), kernel, scale, bias,
        None, relu)
