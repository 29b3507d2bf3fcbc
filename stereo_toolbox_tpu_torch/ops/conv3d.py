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
"""

from __future__ import annotations

import functools
import heapq
from collections import Counter

import torch
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.ops import _cuda

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
