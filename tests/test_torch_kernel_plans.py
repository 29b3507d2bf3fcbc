"""The plans of the K1 (gwc volume) and K3 (Co = 1 conv) kernels, and a walk
of each kernel's blocks in numpy against the plain versions.

The CUDA kernels run only on the card. What decides their result besides
the arithmetic is how they cut the work: the wrapper's plan (tiles, slices,
disparity chunks, rows or runs of planes a block) and each block's walk
(K1: a thread's strip and its sliding window of right pixels; K3: the tap
partials of each staged plane and the 27-point stencil over them, with
rolling output planes). The walks below follow ``csrc/gwc_volume.cu`` and
``csrc/conv3d.cu`` block by block, index by index, on the plans the
wrappers compute, and must give the plain versions' output on every voxel.
"""

import math

import numpy as np
import pytest
import torch

from stereo_toolbox_tpu_torch.ops.conv3d import (STENCIL_MAX_SMEM,
                                                 STENCIL_TILE,
                                                 conv3d_reference,
                                                 stencil_run, stencil_smem)
from stereo_toolbox_tpu_torch.ops.volume import (GWC_MAX_SMEM, gwc_plan,
                                                 gwc_strip,
                                                 gwc_volume_reference)

F32, BF16 = torch.float32, torch.bfloat16


def walk_gwc(left, right, d_max, g_num, plan, ng):
    """K1's blocks (one row each), thread items and d steps, in numpy
    (float64)."""
    b_num, h_num, w_num, c = left.shape
    cpg = c // g_num
    tw, gs, dc, s = plan
    out = np.full((b_num, d_max, h_num, w_num, g_num), np.nan)
    tiles, slices = -(-w_num // tw), -(-g_num // gs)
    nchunks = -(-d_max // dc)
    for bx in range(tiles * slices):
        w0, g0 = (bx % tiles) * tw, (bx // tiles) * gs
        gsh = min(gs, g_num - g0)
        c0, scw = g0 * cpg, gsh * cpg
        for h in range(h_num):
            for bz in range(b_num * nchunks):
                b, dlo = bz // nchunks, (bz % nchunks) * dc
                dhi = min(dlo + dc, d_max)
                nwin, x0 = tw + (dhi - dlo) - 1, w0 - (dhi - 1)
                sl = np.zeros((tw, scw))
                sr = np.zeros((nwin, scw))
                for p in range(tw):
                    if w0 + p < w_num:
                        sl[p] = left[b, h, w0 + p, c0:c0 + scw]
                for p in range(nwin):
                    if 0 <= x0 + p < w_num:
                        sr[p] = right[b, h, x0 + p, c0:c0 + scw]
                slots = gsh // ng
                for item in range(slots * (tw // s)):
                    slot, strip = item % slots, item // slots
                    ws = w0 + strip * s
                    if ws >= w_num:
                        continue
                    cols = slice(slot * ng * cpg, (slot + 1) * ng * cpg)
                    lf = [sl[strip * s + j, cols] for j in range(s)]
                    rw = [sr[ws - dlo + j - x0, cols] for j in range(s)]
                    dz = min(max(ws + s, dlo), dhi)
                    g = g0 + slot * ng
                    for d0 in range(dlo, dz, s):
                        for u in range(s):
                            d = d0 + u
                            if d >= dz:
                                break
                            if u > 0 or d0 > dlo:
                                rw[(s - u) % s] = sr[ws - d - x0, cols]
                            for j in range(s):
                                r = rw[(j - u + s) % s]
                                a = (lf[j] * r).reshape(ng, cpg).sum(1)
                                if ws + j < w_num:
                                    out[b, d, h, ws + j, g:g + ng] = \
                                        a / cpg
                    for d in range(dz, dhi):
                        for j in range(s):
                            if ws + j < w_num:
                                out[b, d, h, ws + j, g:g + ng] = 0.0
    return out


# (b, h, w, c, d, g): CFNet's 1/16 and 1/32 widths (short rows), W not a
# multiple of either tile, D > W, C/G = 3, 4, 8 and 1, B = 2
GWC_CASES = [(1, 3, 40, 320, 12, 40), (1, 2, 20, 320, 6, 40),
             (2, 3, 37, 48, 48, 16), (1, 2, 70, 160, 24, 40),
             (1, 2, 9, 6, 13, 6), (2, 2, 33, 16, 5, 2)]


@pytest.mark.parametrize("b,h,w,c,d,g", GWC_CASES)
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("sms", [132, 2])
def test_gwc_kernel_walk_matches_plain(b, h, w, c, d, g, dtype, sms):
    """Every output voxel written once, equal to the plain version, for the
    plan the wrapper makes on an H100 (132 SMs) and on a 2-SM card (other
    slices and chunks)."""
    rng = np.random.RandomState(0)
    left, right = (rng.randn(b, h, w, c) for _ in range(2))
    ng = 2 if dtype == BF16 and g % 2 == 0 else 1
    plan = gwc_plan(b, h, w, c, d, g, dtype, sms)
    got = walk_gwc(left, right, d, g, plan, ng)
    want = gwc_volume_reference(torch.from_numpy(left),
                                torch.from_numpy(right), d, g).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(1, 120, 160, 320, 48, 40),
                                   (1, 60, 80, 160, 24, 40),
                                   (1, 30, 40, 320, 12, 40),
                                   (1, 15, 20, 320, 6, 40),
                                   (1, 64, 256, 96, 192, 8),
                                   (1, 8, 64, 320, 600, 40)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gwc_plan_fits_the_kernel(shape, dtype):
    """The plan takes what the kernel takes: a tile of whole strips, slices
    of whole thread slots on 16-byte boundaries, a staged row within
    `GWC_MAX_SMEM`; the forwards' launches get ~4 blocks an SM or more, and
    the full-size ones their whole row of groups a block."""
    b, h, w, c, d, g = shape
    size = 4 if dtype == F32 else 2
    cpg = c // g
    ng = 2 if dtype == BF16 and g % 2 == 0 else 1
    tw, gs, dc, s = gwc_plan(b, h, w, c, d, g, dtype, 132)
    assert s == gwc_strip(cpg, ng) and s * ng * cpg <= 32 and tw % s == 0
    assert gs % ng == 0 and (gs * cpg * size) % 16 == 0 and gs <= g
    scp = math.ceil(gs * cpg / (16 // size)) * (16 // size)
    assert (2 * tw + dc - 1) * scp * size <= GWC_MAX_SMEM
    blocks = b * h * -(-w // tw) * -(-g // gs) * -(-d // dc)
    if shape[-2] <= 48:
        assert blocks >= 132
    if shape == (1, 120, 160, 320, 48, 40):
        assert gs == g and dc == d


def walk_stencil(x, k, run):
    """K3's Co = 1 blocks in numpy (float64): per input plane the 27 tap
    partials of the tile and its halo, then each output voxel's 27-point
    stencil added to the three output planes the input plane feeds."""
    b_num, d_num, h_num, w_num, ci = x.shape
    th, tw = STENCIL_TILE
    wt = k.reshape(27, ci)                              # [tap, c]
    out = np.full((b_num, d_num, h_num, w_num), np.nan)
    tiles_w = -(-w_num // tw)
    for bx in range(tiles_w * -(-h_num // th)):
        h0, w0 = (bx // tiles_w) * th, (bx % tiles_w) * tw
        for by in range(-(-d_num // run)):
            d0, d1 = by * run, min(by * run + run, d_num)
            for b in range(b_num):
                zlo, zhi = max(d0 - 1, 0), min(d1, d_num - 1)
                prev, cur, nxt = (np.zeros((th, tw)) for _ in range(3))

                def put(d, v):
                    ys, xs = min(th, h_num - h0), min(tw, w_num - w0)
                    out[b, d, h0:h0 + ys, w0:w0 + xs] = v[:ys, :xs]

                for z in range(zlo, zhi + 1):
                    halo = np.zeros((th + 2, tw + 2, ci))
                    for yy in range(th + 2):
                        for xx in range(tw + 2):
                            gy, gx = h0 + yy - 1, w0 + xx - 1
                            if 0 <= gy < h_num and 0 <= gx < w_num:
                                halo[yy, xx] = x[b, z, gy, gx]
                    prod = halo @ wt.T                  # [th+2, tw+2, 27]
                    v = [sum(prod[kh:kh + th, kw:kw + tw, kd * 9 + kh * 3 + kw]
                             for kh in range(3) for kw in range(3))
                         for kd in range(3)]
                    nxt, cur, prev = nxt + v[0], cur + v[1], prev + v[2]
                    if d0 <= z - 1 < d1:
                        put(z - 1, prev)
                    prev, cur, nxt = cur, nxt, np.zeros((th, tw))
                if zhi < d1:
                    put(zhi, prev)
    return out


# (b, d, h, w, ci): Ci 16, 32 and 5; D 1 and 2; odd H and W; runs cut D
STENCIL_CASES = [(1, 5, 9, 37, 16), (2, 2, 11, 33, 32), (1, 1, 5, 7, 5),
                 (1, 7, 17, 30, 5), (1, 9, 8, 32, 3)]


@pytest.mark.parametrize("b,d,h,w,ci", STENCIL_CASES)
@pytest.mark.parametrize("run", [None, 1, 2, 3])
def test_stencil_kernel_walk_matches_plain(b, d, h, w, ci, run):
    """Every output voxel written once, equal to the plain version, for the
    run the wrapper picks on an H100 and for runs of 1-3 planes."""
    rng = np.random.RandomState(1)
    x = rng.randn(b, d, h, w, ci)
    k = rng.randn(3, 3, 3, ci, 1)
    if run is None:
        run = stencil_run(b, d, h, w, ci, F32, 132)
    got = walk_stencil(x, k, run)
    want = conv3d_reference(torch.from_numpy(x),
                            torch.from_numpy(k)).numpy()[..., 0]
    assert not np.isnan(got).any()
    # the plain version computes in float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", [(1, 48, 120, 160, 32),
                                   (1, 24, 60, 80, 32),
                                   (1, 16, 120, 160, 32),
                                   (1, 12, 240, 320, 16)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_stencil_plan_at_the_forwards_shapes(shape, dtype):
    """Every Co = 1 launch of the forwards fits the stencil kernel's shared
    memory, and its grid fills at least three quarters of the card's SMs."""
    b, d, h, w, ci = shape
    assert stencil_smem(ci, dtype) <= STENCIL_MAX_SMEM
    run = stencil_run(b, d, h, w, ci, dtype, 132)
    th, tw = STENCIL_TILE
    assert 1 <= run <= d
    assert b * -(-h // th) * -(-w // tw) * -(-d // run) >= 0.75 * 132
