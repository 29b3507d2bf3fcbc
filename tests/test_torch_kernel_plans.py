"""The plans of the K1 (gwc volume) forward and backward, K2 (fused 3×3×3
conv), K3 (Co = 1 conv), K4 (sample gather),
K5 (gwc volume over samples) and K6 (concat volume) kernels, and a walk of
each kernel's blocks in numpy against the plain versions.

The CUDA kernels run only on the card. What decides their result besides
the arithmetic is how they cut the work: the wrapper's plan (tiles, slices,
disparity chunks or runs, rows or runs of planes a block, store width) and
each block's walk (K1: a thread's strip and its sliding window of right
pixels; K1's backward: a thread's strip of one output and its window of
feature pixels sliding the other way for dr; K2: a block's voxel x channel
tile, its K loop over (kd, 32-byte channel chunk, tap) reading a halo plane
at shifted pixels, each warp's m16 x n8 fragments into the staged sums and
the epilogue's masked stores of 8 channels;
K3: the tap partials of each staged plane and the 27-point stencil
over them, with rolling output planes; K4: a thread's (pixel, word) items
over its run of samples; K4's backward: a row's lists built by atomics
and sorted, and a thread's (pixel, channels) items walking them, or a
warp's lanes for a long list; K5: a thread's (pixel, slot) items over
the samples; K6: a thread's vectors over the flat output row, stepped
without division, over a run of planes). The walks below follow
``csrc/gwc_volume.cu``, ``csrc/conv3d_fused.cu``, ``csrc/conv3d.cu``,
``csrc/sample_gather.cu`` and ``csrc/concat_volume.cu`` block by block, index by index, on the plans the
wrappers compute, and must give the plain versions' output on every voxel,
written once.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from stereo_toolbox_tpu_torch.ops.conv3d_fused import (
    CI_ALIGN, CO_ALIGN, MMA_TILES, conv3d_fused_reference, mma_tile,
    pack_conv3d_weight)
from stereo_toolbox_tpu_torch.ops.conv3d import (STENCIL_MAX_SMEM,
                                                 STENCIL_TILE,
                                                 conv3d_reference,
                                                 stencil_run, stencil_smem)
from stereo_toolbox_tpu_torch.ops.volume import (
    CONCAT_MAX_SMEM, CONCAT_THREADS, GATHER_ITEMS_PER_SM, GATHER_THREADS,
    GWC_BWD_MAX_SMEM, GWC_BWD_ROW_ALIGN, GWC_BWD_THREADS, GWC_MAX_SMEM,
    GATHER_BWD_ITEM_BYTES, GATHER_BWD_ITEMS, GATHER_BWD_LOADS,
    GATHER_BWD_THREADS, GWC_TILE_W,
    SAMPLE_BWD_LONG, SAMPLE_BWD_MAX_SMEM, SAMPLE_BWD_SMEM_LIMIT,
    SAMPLE_BWD_THREADS, SAMPLE_GWC_THREADS, _skipped,
    concat_plan, concat_smem, concat_volume_reference, gather_backward_plan,
    gather_backward_smem, gather_plan,
    gather_right_by_samples_backward_reference,
    gather_right_by_samples_reference, gwc_backward_plan, gwc_backward_smem,
    gwc_backward_tiles, gwc_plan, gwc_strip, gwc_volume_backward_reference,
    gwc_volume_from_samples_backward_reference,
    gwc_volume_from_samples_reference, gwc_volume_reference,
    sample_backward_plan, sample_chunk_smem, sample_gwc_plan,
    sample_gwc_slot, sample_item_groups, sample_list_ints)

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


def _rowpass_feat(arr, rows, x, slot, nv, s, epc, re):
    """A rowpass thread's `nv` values of its slot in staged feature rows
    `rows` of pixels `x` (chunks swizzled by ``(x / S) % 8``), one row per
    thread item."""
    ee = slot[:, None] * nv + np.arange(nv)[None, :]
    key = ((x // s) & 7)[:, None]
    return arr[rows[:, None] * re + ((ee // epc) ^ key) * epc + ee % epc]


def gwc_backward_fast(c, g, gs, ng, size, align=16):
    """Whether ``launch_rowpass`` (``csrc/gwc_volume.cu``) takes the FAST
    layout: every slice 16 bytes of gd a pixel (four 4-byte words of ng
    groups) on 16-byte boundaries (bases aligned to `align` bytes), the
    outputs in vector words."""
    nv = ng * (c // g) * size
    vf = next((v for v in (16, 8, 4) if nv % v == 0), size)
    return (ng * size == 4 and gs * size == 16 and g % gs == 0
            and (g * size) % 16 == 0 and align % 16 == 0
            and (c * size) % vf == 0)


def _banks_distinct(words, warp_of):
    """Whether the lanes of each warp (`warp_of`: the warp of each lane)
    read distinct banks at the 4-byte words `words` (lanes reading one word
    share it)."""
    for k in np.unique(warp_of):
        addr = np.unique(words[warp_of == k])
        if len(np.unique(addr % 32)) != len(addr):
            return False
    return True


def walk_gwc_backward(left, right, gd, d_max, g_num, plan, size, align=16):
    """K1 backward's "rowpass" blocks (a row, a W tile, a slice of groups),
    in numpy (float64): the slices each block stages in shared memory, laid
    out as ``csrc/gwc_volume.cu`` lays them out (gd planes of ``cap - a_d``
    pixels, 16 bytes a pixel permuted within each 8 on the FAST layout, a
    pixel's words in order otherwise; feature rows swizzled by 16-byte
    chunk; NaN where nothing is staged, so that a read of an unstaged word
    shows), then its thread items (a strip of S pixels of one slot, for dl
    or dr), all of a block at once, stepping d with their windows of S
    feature pixels. On the FAST layout it also requires the lanes of each
    warp to read distinct banks of gd at every step. Returns dl, dr (NaN
    where not written) and the count of writes of each."""
    b_num, h_num, w_num, c = left.shape
    cpg = c // g_num
    tw_p, gs_p, s, ng, threads, smem = plan
    a_ = GWC_BWD_ROW_ALIGN
    fast = gwc_backward_fast(c, g_num, gs_p, ng, size, align)
    km = s - 1
    dp = min(d_max, w_num)
    nr = min(w_num, tw_p + dp - 1)
    epc = 16 // size
    re = -(-(-(-gs_p * cpg * size // 16)) // 8) * 8 * epc
    nv = ng * cpg
    tiles = gwc_backward_tiles(w_num, d_max, tw_p)
    words = max(gs_p // ng * (dp * cap - _skipped(max(0, dp - w0), a_))
                for w0, _, cap in tiles)
    assert 2 * nr * re * size + -(-words * ng * size // 16) * 16 == smem
    outs = (np.full(left.shape, np.nan), np.full(left.shape, np.nan))
    writes = (np.zeros(left.shape, np.int64), np.zeros(left.shape, np.int64))
    for b in range(b_num):
        for h in range(h_num):
            for (w0, tw, cap), g0 in itertools.product(
                    tiles, range(0, g_num, gs_p)):
                gs = min(gs_p, g_num - g0)
                slots, c0, scw = gs // ng, g0 * cpg, gs * cpg
                assert not fast or slots == 4

                def word(x, slot):
                    if fast:
                        return (x ^ ((x >> 3) & km)) * 4 + slot
                    return x * slots + slot

                rlo = max(0, w0 - (dp - 1))
                rn = w0 + tw - rlo
                lhi = min(w_num, w0 + tw + dp - 1)
                sr, sl = np.full(nr * re, np.nan), np.full(nr * re, np.nan)
                sg = np.full((words, ng), np.nan)
                for d in range(dp):
                    m = max(0, d - w0)
                    a = a_ * (m // a_)
                    base = slots * (d * cap - _skipped(m, a_))
                    x = np.arange(cap - a)
                    xa = w0 + a + x
                    ok = (xa >= max(w0, d)) & (xa < min(w_num, w0 + tw + d))
                    for k in range(slots):
                        vals = gd[b, d, h, np.minimum(xa, w_num - 1),
                                  g0 + k * ng:g0 + (k + 1) * ng]
                        sg[base + word(x, k)] = np.where(ok[:, None], vals,
                                                         0.0)
                e = np.arange(scw)
                for p in range(rn + lhi - w0):
                    is_r = p < rn
                    x = rlo + p if is_r else w0 + p - rn
                    arr, row = (sr, p) if is_r else (sl, p - rn)
                    arr[row * re + ((e // epc) ^ ((x // s) & 7)) * epc
                        + e % epc] = (right if is_r else left)[b, h, x,
                                                               c0 + e]
                nstrips = -(-tw // s)
                it = np.arange(slots * nstrips)
                slot, ws = it % slots, w0 + (it // slots) * s
                for is_dr in (0, 1):
                    warp_of = (it + is_dr * len(it)) // 32
                    acc = np.zeros((s, len(it), nv))
                    win = np.zeros((s, len(it), nv))
                    arr, start, end = (sl, w0, lhi) if is_dr else (sr, rlo,
                                                                   w0 + tw)
                    for j in range(s):
                        x = ws + j
                        m = x < end
                        win[j][m] = _rowpass_feat(arr, x[m] - start, x[m],
                                                  slot[m], nv, s, epc, re)
                    dmax = (np.minimum(dp - 1, w_num - 1 - ws) if is_dr
                            else np.minimum(dp - 1, ws + s - 1))
                    for d in range(int(dmax.max()) + 1):
                        u = d % s
                        on = d <= dmax
                        if d > 0:
                            x = ws + d + s - 1 if is_dr else ws - d
                            ok = on & ((x < lhi) if is_dr else (x >= 0))
                            k = (u + s - 1) % s if is_dr else (s - u) % s
                            win[k][on & ~ok] = 0.0
                            win[k][ok] = _rowpass_feat(arr, x[ok] - start,
                                                       x[ok], slot[ok], nv,
                                                       s, epc, re)
                        m = max(0, d - w0)
                        a = a_ * (m // a_)
                        base = slots * (d * cap - _skipped(m, a_))
                        for j in range(s):
                            x = ws[on] - w0 + j - a + (d if is_dr else 0)
                            assert (x >= 0).all()
                            inside = x < cap - a   # the rest read clamped
                            x = np.minimum(x, cap - a - 1)
                            wd = base + word(x, slot[on])
                            if fast:
                                assert _banks_distinct(
                                    wd[inside] * ng * size // 4,
                                    warp_of[on][inside])
                            g = sg[wd]
                            if is_dr:
                                g = np.where((ws[on] + j + d < w_num)[:, None],
                                             g, 0.0)
                            r = win[(j + u) % s if is_dr else (j - u) % s][on]
                            acc[j][on] += np.repeat(g, cpg, axis=1) * r
                    for j in range(s):
                        m = ws + j < w0 + tw
                        cols = (c0 + slot[m, None] * nv
                                + np.arange(nv)[None, :])
                        px = ws[m, None]
                        outs[is_dr][b, h, px + j, cols] = acc[j][m] / cpg
                        writes[is_dr][b, h, px + j, cols] += 1
    return outs[0], outs[1], writes


# (b, h, w, c, d, g): W not a multiple of the strip, D > W, C/G = 8, 3, 1,
# 16 and 12, B = 3; a long row whose slice needs W tiles (GwcNet's eval
# width at 480x640)
GWC_BWD_CASES = [(1, 2, 40, 320, 12, 40), (2, 2, 37, 48, 48, 16),
                 (1, 2, 9, 6, 13, 6), (3, 1, 33, 32, 5, 2),
                 (1, 2, 20, 36, 7, 3), (1, 2, 160, 320, 48, 40)]


@pytest.mark.parametrize("b,h,w,c,d,g", GWC_BWD_CASES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gwc_backward_kernel_walk_matches_plain(b, h, w, c, d, g, dtype):
    """Every dl and dr value written once, equal to the plain backward, on
    the plan the wrapper makes (and with one group a thread in bfloat16
    where the gradient's base is only 2-byte aligned)."""
    rng = np.random.RandomState(1)
    left, right = (rng.randn(b, h, w, c) for _ in range(2))
    gd = rng.randn(b, d, h, w, g)
    want = gwc_volume_backward_reference(
        *(torch.from_numpy(a) for a in (left, right, gd)), d, g)
    size = 4 if dtype == F32 else 2
    for align in (16, 2):
        plan = gwc_backward_plan(w, c, d, g, dtype, align)
        if w == 160:
            assert plan.tw < w   # the row's slice needs tiles
        *got, writes = walk_gwc_backward(left, right, gd, d, g, plan, size,
                                         align)
        for got_t, want_t, n in zip(got, want, writes):
            assert (n == 1).all()
            np.testing.assert_allclose(got_t, want_t.numpy(), rtol=0,
                                       atol=1e-12)


# (C, G, W, D) of the train steps' K1 launches at 256x512: GwcNet's, and
# CFNet's at 1/8, 1/16 and 1/32
TRAIN_K1 = {(320, 40, 128, 48), (160, 40, 64, 24), (320, 40, 32, 12),
            (320, 40, 16, 6)}


@pytest.mark.parametrize("c,g", [(320, 40), (160, 40), (48, 16), (6, 6),
                                 (32, 2)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gwc_backward_plan_fits_the_kernel(c, g, dtype):
    """At GwcNet's and CFNet's train widths (W 128, 64, 32, 16), their eval
    widths at 480x640 (160, 80, 40, 20) and short rows: W tiles on
    `GWC_BWD_ROW_ALIGN` boundaries (or the whole row), the forward's
    strip up to 4 pixels, two groups a thread only in bfloat16 with G even and
    a 4-byte aligned gradient, slices of whole threads' groups, the staged
    bytes within `GWC_BWD_MAX_SMEM`, threads a block in whole warps; the
    train rows of GwcNet and CFNet are staged whole, their slices 16 bytes
    of gd a pixel, on the FAST layout."""
    size = 4 if dtype == F32 else 2
    cpg = c // g
    for w, d in ((128, 48), (64, 24), (32, 12), (16, 6), (160, 48),
                 (80, 24), (40, 12), (20, 6), (9, 13)):
        for align in (16, 4, 2):
            tw, gs, s, ng, threads, smem = gwc_backward_plan(w, c, d, g,
                                                             dtype, align)
            assert ng == (2 if dtype == BF16 and g % 2 == 0 and align >= 4
                          else 1)
            assert s == min(4, gwc_strip(cpg, ng)) and s * ng * cpg <= 32
            assert tw == w or (tw % GWC_BWD_ROW_ALIGN == 0 and tw < w)
            assert gs % ng == 0 and 0 < gs <= g
            assert smem == gwc_backward_smem(w, d, c, g, tw, gs, ng, size)
            assert smem <= GWC_BWD_MAX_SMEM
            assert threads % 32 == 0 and 32 <= threads <= GWC_BWD_THREADS
            if (c, g, w, d) in TRAIN_K1 and align >= 4:
                assert tw == w and gs * size == 16
                assert gwc_backward_fast(c, g, gs, ng, size, align) == (
                    align == 16)


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


# warps of each tile along the voxels x the channels, by type
# (conv3d_fused.cu::launch)
K2_WARPS = {BF16: ((2, 2), (4, 1), (4, 1), (4, 1)),
            F32: ((4, 2), (8, 1), (8, 1), (4, 1))}


def walk_conv3d_fused(x, kernel, scale, bias, res, relu, tile, dtype):
    """K2's blocks in numpy (float64) on the weight packed for `dtype`: a
    block's TH x 32 voxels x TN channels summed over (kd, channel chunk,
    tap) from its halo plane at the tap's shifted pixels, each warp's
    fragments written into the staged sums (each once), then the epilogue's
    8-channel steps, masked past H, W and Co. Returns the output and how
    often each element was stored."""
    b_num, d_num, h_num, w_num, ci = x.shape
    co = kernel.shape[-1]
    data = pack_conv3d_weight(torch.from_numpy(kernel).float()).data
    if dtype == BF16:
        data = pack_conv3d_weight(torch.from_numpy(kernel).to(BF16)).data
    wk = data.double().numpy()                       # [27, co_pad, ci_pad]
    _, co_pad, ci_pad = wk.shape
    chunk = CI_ALIGN[dtype]
    assert ci_pad % chunk == 0 and co_pad % CO_ALIGN == 0
    th, tn = MMA_TILES[tile]
    wm, wn = K2_WARPS[dtype][tile]
    km, warp_m, warp_n = th * 32, th * 32 // wm, tn // wn
    tiles_w, co_blocks = -(-w_num // 32), -(-co // tn)
    out = np.zeros((b_num, d_num, h_num, w_num, co))
    writes = np.zeros(out.shape, dtype=int)
    for bx in range(-(-h_num // th) * tiles_w):
        h0, w0 = (bx // tiles_w) * th, (bx % tiles_w) * 32
        for d in range(d_num):
            for bz in range(b_num * co_blocks):
                b, co0 = bz // co_blocks, (bz % co_blocks) * tn
                assert co0 + tn <= co_pad     # weight rows the block reads
                acc = np.zeros((km, tn))
                for kd in range(3):
                    halo = np.zeros((th + 2, 34, ci_pad))
                    if 0 <= d + kd - 1 < d_num:
                        for yy in range(th + 2):
                            for xx in range(34):
                                gy, gx = h0 + yy - 1, w0 + xx - 1
                                if 0 <= gy < h_num and 0 <= gx < w_num:
                                    halo[yy, xx, :ci] = x[b, d + kd - 1, gy,
                                                          gx]
                    for c0 in range(0, ci_pad, chunk):
                        for t in range(9):
                            kh, kw = divmod(t, 3)
                            m = np.arange(km)
                            a = halo[(m >> 5) + kh, (m & 31) + kw,
                                     c0:c0 + chunk]
                            acc += a @ wk[kd * 9 + t, co0:co0 + tn,
                                          c0:c0 + chunk].T
                staged = np.full((km, tn), np.nan)
                for warp in range(wm * wn):
                    wmi, wni = warp % wm, warp // wm
                    for i in range(warp_m // 16):
                        for j in range(warp_n // 8):
                            for lane in range(32):
                                g, tq = lane >> 2, lane & 3
                                for r in (0, 8):
                                    mm = wmi * warp_m + i * 16 + g + r
                                    nn = wni * warp_n + j * 8 + tq * 2
                                    assert np.isnan(staged[mm, nn:nn + 2]
                                                    ).all()
                                    staged[mm, nn:nn + 2] = acc[mm, nn:nn + 2]
                for e in range(km * (tn // 8)):
                    m, q = divmod(e, tn // 8)
                    y, xw, c = h0 + (m >> 5), w0 + (m & 31), co0 + q * 8
                    if y >= h_num or xw >= w_num or c >= co:
                        continue
                    n = min(8, co - c)
                    v = staged[m, q * 8:q * 8 + n] * scale[c:c + n] + \
                        bias[c:c + n]
                    if res is not None:
                        v = v + res[b, d, y, xw, c:c + n]
                    if relu:
                        v = np.maximum(v, 0)
                    out[b, d, y, xw, c:c + n] = v
                    writes[b, d, y, xw, c:c + n] += 1
    return out, writes


# (b, d, h, w, ci, co, residual, relu): chip_smoke's ragged K2 cases (Ci 12,
# 1, 3, 33, 65; Co 40, 8, 33; odd H and W; D 1 and 2) and a model one cut
K2_CASES = [(2, 5, 7, 19, 12, 40, True, True), (1, 3, 7, 19, 1, 8, False, True),
            (2, 2, 9, 35, 3, 33, True, True), (1, 1, 5, 7, 33, 8, True, False),
            (1, 2, 11, 13, 65, 33, False, False),
            (1, 3, 9, 40, 40, 32, False, True)]


@pytest.mark.parametrize("b,d,h,w,ci,co,res,relu", K2_CASES)
@pytest.mark.parametrize("tile", range(len(MMA_TILES)))
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_conv3d_fused_kernel_walk_matches_plain(b, d, h, w, ci, co, res,
                                                relu, tile, dtype):
    """Every output voxel and channel stored exactly once, equal to the
    plain version, on every tile and either type's channel chunk."""
    rng = np.random.RandomState(ci + co + tile)
    x = rng.randn(b, d, h, w, ci)
    k = rng.randn(3, 3, 3, ci, co) * 0.2
    scale, bias = rng.rand(co) + 0.5, rng.randn(co)
    r = rng.randn(b, d, h, w, co) if res else None
    got, writes = walk_conv3d_fused(x, k, scale, bias, r, relu, tile, dtype)
    assert (writes == 1).all()
    t = [None if a is None else torch.from_numpy(a) for a in (x, k, scale,
                                                              bias, r)]
    if dtype == BF16:       # the walk read the bf16-rounded weight
        t[1] = t[1].to(BF16).double()
    want = conv3d_fused_reference(*t, relu=relu).numpy()
    # the plain version's epilogue computes in float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def walk_gather(right, samples, max_shift, plan, size):
    """K4's blocks (`tw` pixels of one row and a run of `sc` samples each)
    and thread items (pixel, word of `vb` bytes) over their samples, in
    numpy. `size`: bytes an element (4 or 2). Returns the output (NaN where
    not written) and the count of writes of each output."""
    b_num, h_num, w_num, c = right.shape
    s_num = samples.shape[1]
    tw, threads, vb, sc = plan
    epw = vb // size                    # elements a word
    assert (c * size) % vb == 0
    wpp = c // epw
    tiles = -(-w_num // tw)
    out = np.full((b_num, s_num, h_num, w_num, c), np.nan)
    writes = np.zeros(out.shape, np.int64)
    for b in range(b_num):
        for by in range(-(-s_num // sc)):
            s0, s1 = by * sc, min(by * sc + sc, s_num)
            for bx in range(tiles * h_num):
                w0, h = (bx % tiles) * tw, bx // tiles
                items = min(tw, w_num - w0) * wpp
                for t in range(threads):
                    for item in range(t, items, threads):
                        p = item // wpp
                        w, word = w0 + p, item - p * wpp
                        cs = slice(word * epw, word * epw + epw)
                        for s in range(s0, s1):
                            v = samples[b, s, h, w]
                            d = 0 if np.isnan(v) else int(min(max(v, 0),
                                                              max_shift))
                            out[b, s, h, w, cs] = (right[b, h, w - d, cs]
                                                   if w >= d else 0)
                            writes[b, s, h, w, cs] += 1
    return out, writes


# (b, h, w, c, s, max_shift): CFNet's s3 and s2 widths at a few rows; W not
# a multiple of the tile; C = 1, 5 and odd C (2-byte words in bfloat16), 6
# (12-byte bfloat16 pixels) and 12; S = 1; B = 2
GATHER_CASES = [(1, 2, 160, 12, 16, 48), (1, 2, 320, 6, 12, 96),
                (2, 3, 45, 5, 7, 20), (1, 2, 37, 1, 3, 9),
                (1, 3, 70, 6, 1, 30), (2, 2, 19, 12, 4, 25),
                (1, 2, 40, 7, 5, 50)]


@pytest.mark.parametrize("b,h,w,c,s,ms", GATHER_CASES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gather_kernel_walk_matches_plain(b, h, w, c, s, ms, dtype):
    """Every output written once and exactly equal to the plain version,
    for the plan the wrapper makes on an H100 for the full shape (120 or
    240 rows at CFNet's widths), walked on inputs of two or three rows,
    with samples in [-3, max_shift + 4] (both clamps and w < d) and a
    NaN."""
    rng = np.random.RandomState(3)
    right = rng.randn(b, h, w, c)
    samples = rng.randint(-3, ms + 5, (b, s, h, w)).astype(np.float64)
    samples[0, 0, 0, -1] = np.nan
    full_h = {160: 120, 320: 240}.get(w, h)
    size = 4 if dtype == F32 else 2
    plan = gather_plan(b, full_h, w, c, s, dtype, 132)
    got, writes = walk_gather(right, samples, ms, plan, size)
    want = gather_right_by_samples_reference(
        torch.from_numpy(right),
        torch.from_numpy(np.nan_to_num(samples, nan=0.0)), ms).numpy()
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("align", [16, 8, 4, 2])
def test_gather_plan_words_divide_the_row_and_the_bases(align):
    """A word divides the row's bytes and the bases' alignment: a base one
    element past 16 bytes takes narrower words, never a split pixel."""
    for c in (1, 2, 3, 5, 6, 12, 32):
        for dtype, size in ((F32, 4), (BF16, 2)):
            if align < size:
                continue
            vb = gather_plan(1, 8, 40, c, 4, dtype, 132, align).vb
            assert (c * size) % vb == 0 and align % vb == 0
            assert vb == max(v for v in (16, 8, 4, 2)
                             if (c * size) % v == 0 and align % v == 0)


@pytest.mark.parametrize("shape,want_vb", [
    ((1, 120, 160, 12, 16, 48), {F32: 16, BF16: 8}),
    ((1, 240, 320, 6, 12, 96), {F32: 8, BF16: 4})])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gather_plan_at_cfnets_shapes(shape, want_vb, dtype):
    """CFNet's two K4 launches: three words a pixel (16 or 8 bytes in
    float32, 8 or 4 in bfloat16), 32-pixel blocks of whole warps within
    the kernel's threads, every sample of a pixel in one item unless the
    launch would keep an SM under `GATHER_ITEMS_PER_SM` items."""
    b, h, w, c, s, _ = shape
    tw, threads, vb, sc = gather_plan(b, h, w, c, s, dtype, 132)
    assert vb == want_vb[dtype]
    wpp = c * (4 if dtype == F32 else 2) // vb
    assert wpp == 3 and tw == 32
    assert threads % 32 == 0 and 32 <= threads <= GATHER_THREADS
    assert threads >= tw * wpp
    items = b * h * w * wpp
    assert items * -(-s // sc) >= GATHER_ITEMS_PER_SM * 132 or sc == 1
    assert sc == s or items * -(-s // (2 * sc)) < GATHER_ITEMS_PER_SM * 132


def walk_sample_gwc(left, right, samples, g_num, max_shift, plan):
    """K5's blocks (`tw` pixels of one row each) and thread items (pixel,
    slot of `ng` groups) over the samples, in numpy (float64). Returns the
    output (NaN where not written) and the count of writes of each
    output."""
    b_num, h_num, w_num, c = left.shape
    s_num = samples.shape[1]
    tw, threads, ng = plan
    cpg, slots = c // g_num, g_num // ng
    tiles = -(-w_num // tw)
    out = np.full((b_num, s_num, h_num, w_num, g_num), np.nan)
    writes = np.zeros(out.shape, np.int64)
    for b in range(b_num):
        for bx in range(tiles * h_num):
            w0, h = (bx % tiles) * tw, bx // tiles
            nw = min(tw, w_num - w0)
            items = nw * slots
            for t in range(threads):
                for item in range(t, items, threads):
                    p = item // slots
                    slot = item - p * slots
                    c0, w = slot * ng * cpg, w0 + p
                    lf = left[b, h, w, c0:c0 + ng * cpg] * (1.0 / cpg)
                    for s in range(s_num):
                        v = samples[b, s, h, w]
                        d = 0 if np.isnan(v) else int(min(max(v, 0),
                                                          max_shift))
                        a = np.zeros(ng)
                        if w >= d:
                            rv = right[b, h, w - d, c0:c0 + ng * cpg]
                            a = (lf * rv).reshape(ng, cpg).sum(1)
                        gs = slice(slot * ng, slot * ng + ng)
                        out[b, s, h, w, gs] = a
                        writes[b, s, h, w, gs] += 1
    return out, writes


# (b, h, w, c, s, g, max_shift): CFNet's s3 and s2 widths at a few rows;
# W not a multiple of the tile, C/G = 3 (odd G), 8 and 5 (no compile-time
# C/G), S = 1, B = 2
SAMPLE_GWC_CASES = [(1, 2, 160, 160, 16, 40, 48), (1, 2, 320, 80, 12, 20, 96),
                    (2, 3, 45, 12, 7, 4, 20), (1, 2, 40, 96, 3, 12, 30),
                    (1, 2, 37, 15, 1, 3, 9), (2, 2, 19, 10, 4, 2, 25)]


@pytest.mark.parametrize("b,h,w,c,s,g,ms", SAMPLE_GWC_CASES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_sample_gwc_kernel_walk_matches_plain(b, h, w, c, s, g, ms, dtype):
    """Every output written once, equal to the plain version, for the plan
    the wrapper makes on an H100 for the full shape (120 or 240 rows at
    CFNet's widths), walked on inputs of two or three rows, with samples in
    [-3, max_shift + 4] and a NaN."""
    rng = np.random.RandomState(2)
    left, right = (rng.randn(b, h, w, c) for _ in range(2))
    samples = rng.randint(-3, ms + 5, (b, s, h, w)).astype(np.float64)
    samples[0, 0, 0, -1] = np.nan
    full_h = {160: 120, 320: 240}.get(w, h)
    plan = sample_gwc_plan(b, full_h, w, c, s, g, dtype, 132)
    assert plan.ng == sample_gwc_slot(g, dtype) and g % plan.ng == 0
    got, writes = walk_sample_gwc(left, right, samples, g, ms, plan)
    want = gwc_volume_from_samples_reference(
        torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(np.nan_to_num(samples, nan=0.0)), g, ms).numpy()
    assert (writes == 1).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(1, 120, 160, 160, 16, 40, 48),
                                   (1, 240, 320, 80, 12, 20, 96)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_sample_gwc_plan_at_cfnets_shapes(shape, dtype):
    """CFNet's two K5 launches: 16-pixel (float32) or 32-pixel (bfloat16)
    blocks, at least 4 blocks an SM on 132 SMs, whole warps within the
    kernel's threads, and no shared memory, so the plan always fits."""
    b, h, w, c, s, g, _ = shape
    tw, threads, ng = sample_gwc_plan(b, h, w, c, s, g, dtype, 132)
    assert tw == (16 if dtype == F32 else 32)
    assert b * h * -(-w // tw) >= 4 * 132
    assert threads % 32 == 0 and 32 <= threads <= SAMPLE_GWC_THREADS
    # one 8-byte store a thread item: 2 groups in float32, 4 in bfloat16
    assert ng * (4 if dtype == F32 else 2) == 8
    items = tw * g // ng
    assert threads >= -(-items // -(-items // SAMPLE_GWC_THREADS))


def _shifts(samples, max_shift):
    """The kernels' d of float32 samples: clamped to [0, max_shift] and
    truncated, NaN -> 0."""
    return np.where(np.isnan(samples), 0,
                    np.clip(np.nan_to_num(samples), 0, max_shift)
                    ).astype(np.int64)


def walk_build_lists(smp, max_shift, threads=SAMPLE_BWD_THREADS):
    """``build_lists`` of ``csrc/sample_gather.cu`` on one row's samples
    ``[S, W]``, in numpy: each warp's run of the (s, w) counted 32 at a time
    (the lanes of one u count together), the warps' counts summed a pixel
    and scanned as the block scans them (a run of pixels a thread, its sum
    scanned within its warp, then over the warps' totals), each warp's
    cursor into each list, and the fill, 32 entries at a time, the lanes of
    one u taking consecutive places by lane. Returns u of each (s, w) (-1
    where w < d), the W + 1 offsets and the entries (s << 16 | w)."""
    s_num, w_num = smp.shape
    n = s_num * w_num
    warps = threads // 32
    i = np.arange(n)
    d = _shifts(smp, max_shift).reshape(-1)
    uof = np.where(d <= i % w_num, i % w_num - d, -1)
    run = -(-n // warps)
    runs = [(min(n, k * run), min(n, min(n, k * run) + run))
            for k in range(warps)]
    cnt = np.zeros((warps, w_num), np.int64)
    for k, (lo, hi) in enumerate(runs):
        for base in range(lo, hi, 32):
            lanes = uof[base:min(base + 32, hi)]
            for u in set(lanes[lanes >= 0].tolist()):
                cnt[k, u] += (lanes == u).sum()
    tot = cnt.sum(0)
    per = -(-w_num // threads)
    local = np.array([tot[t * per:(t + 1) * per].sum()
                      for t in range(threads)])
    incl = np.concatenate([np.cumsum(local[k:k + 32])
                           for k in range(0, threads, 32)])
    warp_total = incl[31::32]
    off = np.zeros(w_num + 1, np.int64)
    cur = np.zeros((warps, w_num), np.int64)
    for t in range(threads):
        at = incl[t] - local[t] + warp_total[:t // 32].sum()
        for u in range(min(w_num, t * per), min(w_num, (t + 1) * per)):
            off[u] = at
            cur[:, u] = at + np.concatenate([[0], np.cumsum(cnt[:-1, u])])
            at += tot[u]
    off[w_num] = warp_total.sum()
    entries = np.full(n, -1, np.int64)
    for k, (lo, hi) in enumerate(runs):
        for base in range(lo, hi, 32):
            lanes = uof[base:min(base + 32, hi)]
            for lane, u in enumerate(lanes):
                if u >= 0:
                    rank = (lanes[:lane] == u).sum()
                    ii = base + lane
                    entries[cur[k, u] + rank] = (ii // w_num) << 16 | (
                        ii % w_num)
            for u in set(lanes[lanes >= 0].tolist()):
                cur[k, u] += (lanes == u).sum()
    return uof, off, entries[:off[w_num]]


def walk_sample_gwc_backward(left, right, samples, gd, g_num, max_shift,
                             plan, size):
    """K5 backward's "staged" design in numpy (float64): each row's lists
    (`walk_build_lists`), then each (row, chunk of `plan.groups` groups)
    block's staged samples, gd, left and right rows (rows padded to the
    thread items' groups; NaN where nothing is staged) and its three
    passes, a thread item one pixel and `sample_item_groups` groups, the
    padding groups computed and not written: dl summing over s; dr's lists
    of at most `SAMPLE_BWD_LONG` entries a thread each; longer lists a warp
    each, lane k summing entries k, k + 32, ... and the lanes meeting in a
    butterfly. Returns dl, dr (NaN where not written) and the count of
    writes of each."""
    b_num, h_num, w_num, c = left.shape
    s_num = samples.shape[1]
    cpg = c // g_num
    gc_p = plan.groups
    ngi = sample_item_groups(cpg, size)
    gcp = -(-gc_p // ngi) * ngi
    epc = 16 // size
    ncp = -(-gcp * cpg // epc) * epc
    assert plan.chunk_smem == sample_chunk_smem(w_num, s_num, cpg, gc_p, size)
    assert plan.smem == 4 * sample_list_ints(w_num, s_num)
    outs = (np.full(left.shape, np.nan), np.full(left.shape, np.nan))
    writes = (np.zeros(left.shape, np.int64), np.zeros(left.shape, np.int64))
    for b in range(b_num):
        for h in range(h_num):
            uof, off, entries = walk_build_lists(samples[b, :, h], max_shift)
            order = np.argsort(np.where(uof >= 0, uof, w_num), kind="stable")
            ii = order[:off[-1]]
            assert (entries == (ii // w_num) << 16 | ii % w_num).all()
            lens = np.diff(off)
            shifts = _shifts(samples[b, :, h], max_shift)       # [S, W]
            for g0 in range(0, g_num, gc_p):
                gc = min(gc_p, g_num - g0)
                c0 = g0 * cpg
                sg = np.full((s_num * w_num, gcp), np.nan)
                sg[:, :gc] = gd[b, :, h, :, g0:g0 + gc].reshape(-1, gc)
                sl, sr = (np.full((w_num, ncp), np.nan) for _ in range(2))
                sl[:, :gc * cpg] = left[b, h, :, c0:c0 + gc * cpg]
                sr[:, :gc * cpg] = right[b, h, :, c0:c0 + gc * cpg]
                nq = -(-gc // ngi)
                ch = np.arange(ngi * cpg)        # an item's channels
                grp = ch // cpg                  # and their groups
                # dl: items (w, group quad)
                w, q = np.divmod(np.arange(w_num * nq), nq)
                n0 = q * ngi
                acc = np.zeros((len(w), ngi * cpg))
                for s in range(s_num):
                    d = shifts[s, w]
                    on = d <= w
                    u = (w - d)[on]
                    acc[on] += (sg[s * w_num + w[on, None], n0[on, None] + grp]
                                * sr[u[:, None], n0[on, None] * cpg + ch])
                real = n0[:, None] + grp < gc
                cols = c0 + n0[:, None] * cpg + ch
                for k in range(len(w)):
                    outs[0][b, h, w[k], cols[k][real[k]]] = acc[k][real[k]] / cpg
                    writes[0][b, h, w[k], cols[k][real[k]]] += 1
                # dr: lists of at most SAMPLE_BWD_LONG entries, items (u, quad)
                u, q = np.divmod(np.arange(w_num * nq), nq)
                short = lens[u] <= SAMPLE_BWD_LONG
                u, n0 = u[short], q[short] * ngi
                acc = np.zeros((len(u), ngi * cpg))
                for p in range(int(lens[u].max(initial=0))):
                    on = p < lens[u]
                    e = entries[off[u[on]] + p]
                    ws, ss = e & 0xFFFF, e >> 16
                    acc[on] += (sg[(ss * w_num + ws)[:, None],
                                   n0[on, None] + grp]
                                * sl[ws[:, None], n0[on, None] * cpg + ch])
                real = n0[:, None] + grp < gc
                cols = c0 + n0[:, None] * cpg + ch
                for k in range(len(u)):
                    outs[1][b, h, u[k], cols[k][real[k]]] = acc[k][real[k]] / cpg
                    writes[1][b, h, u[k], cols[k][real[k]]] += 1
                # dr: longer lists, a warp each
                for u in np.nonzero(lens > SAMPLE_BWD_LONG)[0]:
                    e = entries[off[u]:off[u + 1]]
                    ws, ss = e & 0xFFFF, e >> 16
                    for n0 in range(0, gc, ngi):
                        terms = (sg[(ss * w_num + ws)[:, None], n0 + grp]
                                 * sl[ws[:, None], n0 * cpg + ch])
                        lane = np.zeros((32, ngi * cpg))
                        for k in range(32):
                            for t in terms[k::32]:
                                lane[k] += t
                        for m in (16, 8, 4, 2, 1):
                            lane = lane + lane[np.arange(32) ^ m]
                        real = n0 + grp < gc
                        cols = (c0 + n0 * cpg + ch)[real]
                        outs[1][b, h, u, cols] = lane[0][real] / cpg
                        writes[1][b, h, u, cols] += 1
    return outs[0], outs[1], writes


# (b, h, w, c, s, g, max_shift): W not a multiple of 32, C/G 3 (odd G), 5
# (no compile-time C/G) and 8, S = 1; CFNet's s3 and s2 widths at two rows
SAMPLE_GWC_BWD_CASES = [(2, 3, 45, 12, 7, 4, 20), (1, 3, 70, 15, 1, 3, 9),
                        (1, 2, 40, 320, 3, 40, 200), (2, 2, 19, 10, 4, 2, 25),
                        (1, 2, 128, 160, 16, 40, 48),
                        (1, 2, 256, 80, 12, 20, 96)]


@pytest.mark.parametrize("b,h,w,c,s,g,ms", SAMPLE_GWC_BWD_CASES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_sample_gwc_backward_kernel_walk_matches_plain(b, h, w, c, s, g, ms,
                                                       dtype):
    """K5 backward's lists in (s, w) order and every dl and dr value written
    once, equal to the plain backward, on the plan the wrapper makes, with
    samples at 0, at max_shift and past both clamps (and past the image's
    left edge), fractions, a NaN, and a row whose every sample reads one
    right pixel wherever it can (one list of S x min(W, ms + 1)
    entries)."""
    rng = np.random.RandomState(3)
    left, right = (rng.randn(b, h, w, c) for _ in range(2))
    gd = rng.randn(b, s, h, w, g)
    samples = rng.randint(-3, ms + 5, (b, s, h, w)).astype(np.float32)
    samples[0, 0, 0, -1] = np.nan
    samples[-1, -1] += 0.5
    samples[0, :, 1] = np.arange(w)
    size = 4 if dtype == F32 else 2
    plan = sample_backward_plan(w, s, g, c // g, dtype)
    *got, writes = walk_sample_gwc_backward(left, right, samples, gd, g, ms,
                                            plan, size)
    want = gwc_volume_from_samples_backward_reference(
        torch.from_numpy(left), torch.from_numpy(right),
        torch.from_numpy(np.nan_to_num(samples, nan=0.0)),
        torch.from_numpy(gd), g, ms)
    assert (writes[0] == 1).all() and (writes[1] == 1).all()
    for got_t, want_t in zip(got, want):
        np.testing.assert_allclose(got_t, want_t.numpy(), rtol=0, atol=1e-12)


def walk_build_staged_lists(smp, max_shift, rng):
    """K4 backward's list build (``build_staged_lists`` in the source) on
    one row's samples ``[S, W]``, in numpy: each (s, u)'s count of entries,
    each u's prefix over s and the offsets (an exclusive scan of the
    totals); each entry placed at its (s, u)'s start + its arrival among
    them, in an order of the scheduler's (here `rng`'s), then each (s, u)
    of two or more entries sorted. Returns the W + 1 offsets and the
    entries (s * W + w)."""
    s_num, w_num = smp.shape
    d = _shifts(smp, max_shift)
    u = np.where(d <= np.arange(w_num), np.arange(w_num) - d, -1)   # [S, W]
    s, w = np.nonzero(u >= 0)
    cnt = np.zeros((s_num, w_num), np.int64)
    np.add.at(cnt, (s, u[s, w]), 1)
    start = np.cumsum(cnt, axis=0) - cnt             # each u's prefix over s
    off = np.concatenate([[0], np.cumsum(cnt.sum(0))])
    entries = np.full(off[-1], -1, np.int64)
    arrived = np.zeros((s_num, w_num), np.int64)
    for k in rng.permutation(len(s)):                 # atomicAdd's order
        x = u[s[k], w[k]]
        entries[off[x] + start[s[k], x] + arrived[s[k], x]] = (
            s[k] * w_num + w[k])
        arrived[s[k], x] += 1
    for sk, x in zip(*np.nonzero(cnt >= 2)):          # sort each (s, u)
        lo = off[x] + start[sk, x]
        entries[lo:lo + cnt[sk, x]].sort()
    return off, entries


def walk_gather_backward(gd, samples, max_shift, plan, size, rng):
    """K4 backward's "staged" design in numpy (float64): each (row, chunk
    of `plan.chunk` channels) block's lists (`walk_build_staged_lists`) and
    staged gd, then its thread items (pixel u, `plan.item` channels), each
    summing u's list in order, for lists of at most `SAMPLE_BWD_LONG`
    entries; a longer list a warp's, lane k summing its entries k, k + 32,
    ... and the lanes meeting in a butterfly. Returns dright (NaN where not
    written) and the count of writes of each value."""
    b_num, s_num, h_num, w_num, c = gd.shape
    chunk, item = plan.chunk, plan.item
    assert plan.smem == gather_backward_smem(w_num, s_num, chunk, size)
    out = np.full((b_num, h_num, w_num, c), np.nan)
    writes = np.zeros(out.shape, np.int64)
    d = _shifts(samples, max_shift)                          # [B, S, H, W]
    for b in range(b_num):
        for h in range(h_num):
            off, entries = walk_build_staged_lists(samples[b, :, h],
                                                   max_shift, rng)
            # each u's list: its (s, w) with w - d = u, in (s, w) order
            ss, ww = np.divmod(entries, w_num)
            uu = np.repeat(np.arange(w_num), np.diff(off))
            assert (ww - d[b, ss, h, ww] == uu).all()
            assert (np.diff(entries) > 0)[np.diff(uu) == 0].all()
            assert off[-1] == (d[b, :, h] <= np.arange(w_num)).sum()
            lens = np.diff(off)
            for c0 in range(0, c, chunk):
                sg = gd[b, :, h, :, c0:c0 + chunk].reshape(-1, chunk)
                short = np.nonzero(lens <= SAMPLE_BWD_LONG)[0]
                acc = np.zeros((len(short), chunk))
                for p in range(int(lens[short].max(initial=0))):
                    on = p < lens[short]
                    acc[on] += sg[entries[off[short[on]] + p]]
                for q in range(chunk // item):               # the items
                    cols = slice(c0 + q * item, c0 + (q + 1) * item)
                    out[b, h, short, cols] = acc[:, q * item:(q + 1) * item]
                    writes[b, h, short, cols] += 1
                for u in np.nonzero(lens > SAMPLE_BWD_LONG)[0]:
                    e = entries[off[u]:off[u + 1]]
                    lane = np.zeros((32, chunk))
                    for k in range(32):
                        for t in e[k::32]:
                            lane[k] += sg[t]
                    for m in (16, 8, 4, 2, 1):
                        lane = lane + lane[np.arange(32) ^ m]
                    for q in range(chunk // item):
                        cols = slice(c0 + q * item, c0 + (q + 1) * item)
                        out[b, h, u, cols] = lane[0, q * item:(q + 1) * item]
                        writes[b, h, u, cols] += 1
    return out, writes


# (b, h, w, c, s, max_shift): W not a multiple of 32, C 12, 5, 1 and 6, S =
# 1, max_shift past W; CFNet's s3 and s2 widths at two rows; rows of 800
# pixels (chunks of 3 float32 channels, one bfloat16 channel)
GATHER_BWD_WALK_CASES = [(2, 3, 45, 12, 7, 20), (1, 3, 70, 5, 1, 9),
                         (1, 2, 40, 1, 3, 200), (2, 2, 19, 6, 4, 25),
                         (1, 2, 128, 12, 16, 48), (1, 2, 256, 6, 12, 96),
                         (1, 2, 800, 6, 12, 96)]


@pytest.mark.parametrize("b,h,w,c,s,ms", GATHER_BWD_WALK_CASES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gather_backward_kernel_walk_matches_plain(b, h, w, c, s, ms, dtype):
    """K4 backward's lists in (s, w) order whatever order the atomics place
    their entries in, and every dright value written once, equal to the
    plain backward, on the plan the wrapper makes, with samples at 0, at
    max_shift and past both clamps (and the image's left edge), fractions,
    a NaN, and a row whose every sample reads one right pixel wherever it
    can (one list of S x min(W, ms + 1) entries, a warp's)."""
    rng = np.random.RandomState(5)
    gd = rng.randn(b, s, h, w, c)
    samples = rng.randint(-3, ms + 5, (b, s, h, w)).astype(np.float32)
    samples[0, 0, 0, -1] = np.nan
    samples[-1, -1] += 0.5
    samples[0, :, 1] = np.arange(w)
    size = 4 if dtype == F32 else 2
    plan = gather_backward_plan(w, s, c, dtype)
    got, writes = walk_gather_backward(gd, samples, ms, plan, size, rng)
    want = gather_right_by_samples_backward_reference(
        torch.from_numpy(gd),
        torch.from_numpy(np.nan_to_num(samples, nan=0.0)), ms)
    assert (writes == 1).all()
    np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gather_backward_plan_at_cfnets_shapes(dtype):
    """CFNet's two K4-bwd train launches, rows (W, S, C): every channel a
    block, whose shared memory fits two blocks an SM (1 KB of the SM's 228
    KB reserved a block; 112.5 KB a block at the 1/4 stage in float32);
    256 threads at the 1/4 stage, 512 (one list thread a pixel) at the 1/2."""
    for (w, s, c), threads in (((128, 16, 12), 256), ((256, 12, 6), 512)):
        plan = gather_backward_plan(w, s, c, dtype)
        assert plan.chunk == c and plan.threads == threads
        assert 2 * (plan.smem + 1024) <= 228 * 1024


# (w, s, c): CFNet's stages in training and eval, rows of 800 pixels (a
# chunk fits one block an SM only in float32), odd and prime C, C 32
@pytest.mark.parametrize("w,s,c", [(128, 16, 12), (256, 12, 6), (160, 16, 12),
                                   (320, 12, 6), (800, 12, 6), (45, 7, 5),
                                   (70, 1, 7), (96, 8, 32)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gather_backward_plan_fits_the_kernel(w, s, c, dtype):
    """The K4-bwd plan: a chunk dividing C, the largest whose block fits two
    blocks an SM, or where none does one block an SM; an item of the
    kernel's compile-time counts dividing the chunk within
    `GATHER_BWD_ITEM_BYTES`; the fewer threads of `GATHER_BWD_THREADS`
    where their list threads (all but the copying warp) number the row's
    pixels and hold its entries, `GATHER_BWD_LOADS` each, else the
    more."""
    size = 4 if dtype == F32 else 2
    plan = gather_backward_plan(w, s, c, dtype)
    lo, hi = GATHER_BWD_THREADS
    assert plan.threads in (lo, hi)
    assert (plan.threads - 32) * GATHER_BWD_LOADS >= s * w
    fits = w <= lo - 32 and (lo - 32) * GATHER_BWD_LOADS >= s * w
    assert plan.threads == (lo if fits else hi)
    assert c % plan.chunk == 0 and plan.chunk % plan.item == 0
    assert plan.item == max(n for n in GATHER_BWD_ITEMS if plan.chunk % n == 0
                            and n * size <= GATHER_BWD_ITEM_BYTES)
    assert plan.smem == gather_backward_smem(w, s, plan.chunk, size)
    cap = (SAMPLE_BWD_MAX_SMEM if plan.smem <= SAMPLE_BWD_MAX_SMEM
           else SAMPLE_BWD_SMEM_LIMIT)
    if cap == SAMPLE_BWD_SMEM_LIMIT:
        assert gather_backward_smem(w, s, 1, size) > SAMPLE_BWD_MAX_SMEM
    assert plan.smem <= cap
    assert all(gather_backward_smem(w, s, n, size) > cap
               for n in range(plan.chunk + 1, c + 1) if c % n == 0)


@pytest.mark.parametrize("w,s", [(4000, 4), (700, 16)])
def test_gather_backward_plan_refuses_rows_past_the_block(w, s):
    """A row whose entries pass what a block's list threads hold (its lists
    and one channel then fit the shared memory whatever the row)."""
    with pytest.raises(ValueError, match="no K4 backward plan"):
        gather_backward_plan(w, s, 12, torch.float32)


def walk_concat(left, right, d_max, mask_left, plan, size):
    """K6's blocks (one row's W tile and a run of disparities each) and
    thread stores over the flat output row, each assembled from shared
    words, in numpy, with the kernel's division-free stepping of a store's
    (pixel, channel). `size`: bytes an element (4 or 2). Returns the output
    and the writes of each element."""
    b_num, h_num, w_num, c = left.shape
    vb, sb, tw, dr, threads = plan
    epv, eps, c2 = vb // size, sb // size, 2 * c
    assert (c * size) % sb == 0 and vb % sb == 0
    tiles = -(-w_num // tw)
    out = np.full((b_num, d_max, h_num, w_num, c2), np.nan)
    writes = np.zeros(out.shape, np.int64)
    flat, flat_writes = (a.reshape(b_num, d_max, h_num, w_num * c2)
                         for a in (out, writes))
    for b in range(b_num):
        for by in range(-(-d_max // dr)):
            dlo = by * dr
            dhi = min(dlo + dr, d_max)
            ds = np.arange(dlo, dhi)
            for bx in range(tiles * h_num):
                w0, h = (bx % tiles) * tw, bx // tiles
                nw = min(tw, w_num - w0)
                x0 = max(w0 - (dhi - 1), 0)
                nr = max(w0 + nw - dlo - x0, 0)
                assert (-(-nw * c * size // 16) * 16 + nr * c * size
                        <= concat_smem(tw, dr, w_num, c, size))
                sl = left[b, h, w0:w0 + nw].reshape(-1)
                # the staged right pixels, then NaN (read by no written word)
                sr = np.concatenate([right[b, h, x0:x0 + nr].reshape(-1),
                                     np.full(sb // size, np.nan)])
                nvec = nw * c2 // epv
                step = threads * epv
                sq, sm = step // c2, step % c2
                for t in range(threads):
                    pw, pk = t * epv // c2, t * epv - (t * epv // c2) * c2
                    for v in range(t, nvec, threads):
                        x, k = w0 + pw, pk
                        for j in range(vb // sb):
                            e = w0 * c2 + v * epv + j * eps + np.arange(eps)
                            if k < c:
                                word = sl[(x - w0) * c + k + np.arange(eps)]
                                val = np.where(
                                    (mask_left & (x < ds))[:, None], 0.0,
                                    word[None])
                            else:
                                ro = (x - x0) * c + k - c
                                ok = x >= ds
                                idx = np.where(ok, ro - ds * c, 0)
                                assert (idx[ok] >= 0).all() and (
                                    idx[ok] + eps <= nr * c).all()
                                val = np.where(
                                    ok[:, None],
                                    sr[idx[:, None] + np.arange(eps)], 0.0)
                            flat[b, dlo:dhi, h][:, e] = val
                            flat_writes[b, dlo:dhi, h][:, e] += 1
                            k += eps
                            if k == c2:
                                k, x = 0, x + 1
                        pk, pw = pk + sm, pw + sq
                        if pk >= c2:
                            pk, pw = pk - c2, pw + 1
    return out, writes


# (b, h, w, c, d): GwcNet_GC's and ACVNet's rows (two of 120) and CFNet's
# 1/8 rows; D > W; odd C (8- and 4-byte stores); a row not a multiple of 16
# bytes; W tiles (a 700-channel float32 row past the shared-memory cap)
CONCAT_CASES = [(1, 2, 160, 12, 48), (1, 2, 160, 32, 48), (1, 2, 80, 12, 24),
                (2, 3, 37, 12, 45), (1, 2, 9, 5, 4), (1, 3, 11, 3, 7),
                (1, 2, 10, 32, 14), (1, 1, 20, 700, 3)]


@pytest.mark.parametrize("b,h,w,c,d", CONCAT_CASES)
@pytest.mark.parametrize("mask_left", [True, False])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_concat_kernel_walk_matches_plain(b, h, w, c, d, mask_left, dtype):
    """Every element written once, equal to the plain version, for the plan
    the wrapper makes on an H100 for the full shape (GwcNet_GC's and
    ACVNet's 120 rows, CFNet's 60), walked on inputs of one to three rows."""
    rng = np.random.RandomState(3)
    left, right = (rng.randn(b, h, w, c) for _ in range(2))
    full_h = {160: 120, 80: 60}.get(w, h)
    plan = concat_plan(b, full_h, w, c, d, dtype, 132)
    size = 4 if dtype == F32 else 2
    got, writes = walk_concat(left, right, d, mask_left, plan, size)
    want = concat_volume_reference(torch.from_numpy(left),
                                   torch.from_numpy(right), d,
                                   mask_left).numpy()
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 120, 160, 12, 48),
                                   (1, 120, 160, 32, 48),
                                   (1, 60, 80, 12, 24), (1, 30, 40, 12, 12),
                                   (1, 15, 20, 12, 6), (1, 64, 640, 320, 48)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_concat_plan_fits_the_kernel(shape, dtype):
    """Stores of 16 bytes at the forwards' rows (bfloat16 C = 12 from two
    8-byte words, the rest from one), within shared memory, whole warps
    within the kernel's threads, and at least 1 block an SM (2 where the
    rows stage in words under 16 bytes) where D allows: runs of several
    planes at GwcNet_GC's, ACVNet's and CFNet's 1/8 volumes (and CFNet's
    1/16 in float32), one plane at CFNet's 1/32."""
    b, h, w, c, d = shape
    size = 4 if dtype == F32 else 2
    vb, sb, tw, dr, threads = concat_plan(b, h, w, c, d, dtype, 132)
    assert (w * 2 * c * size) % vb == 0 and (tw * 2 * c * size) % vb == 0
    assert vb % sb == 0 and (c * size) % sb == 0 and sb >= size
    assert concat_smem(tw, dr, w, c, size) <= CONCAT_MAX_SMEM
    assert threads % 32 == 0 and 32 <= threads <= CONCAT_THREADS
    blocks = b * h * -(-w // tw) * -(-d // dr)
    per_sm = 1 if (c * size) % 16 == 0 else 2
    if b * h * d >= 2 * per_sm * 132:
        assert blocks >= per_sm * 132 and dr > 1
    else:                       # one d a block
        assert dr == 1
    if (h, d) == (30, 12):      # CFNet's 1/16
        assert dr == (2 if dtype == F32 else 1)
    if c in (12, 32):
        assert vb == 16 and tw == w
        assert sb == (8 if (c, dtype) == (12, BF16) else 16)
