"""The plans of the K1 (gwc volume) forward and backward, K3 (Co = 1 conv),
K4 (sample gather),
K5 (gwc volume over samples) and K6 (concat volume) kernels, and a walk of
each kernel's blocks in numpy against the plain versions.

The CUDA kernels run only on the card. What decides their result besides
the arithmetic is how they cut the work: the wrapper's plan (tiles, slices,
disparity chunks or runs, rows or runs of planes a block, store width) and
each block's walk (K1: a thread's strip and its sliding window of right
pixels; K1's backward: a thread's strip of one output and its window of
feature pixels sliding the other way for dr; K3: the tap partials of each staged plane and the 27-point stencil
over them, with rolling output planes; K4: a thread's (pixel, word) items
over its run of samples; K5: a thread's (pixel, slot) items over the
samples; K6: a thread's vectors over the flat output row, stepped without
division, over a run of planes). The walks below follow
``csrc/gwc_volume.cu``, ``csrc/conv3d.cu``, ``csrc/sample_gather.cu`` and
``csrc/concat_volume.cu`` block by block, index by index, on the plans the
wrappers compute, and must give the plain versions' output on every voxel,
written once.
"""

import math

import numpy as np
import pytest
import torch

from stereo_toolbox_tpu_torch.ops.conv3d import (STENCIL_MAX_SMEM,
                                                 STENCIL_TILE,
                                                 conv3d_reference,
                                                 stencil_run, stencil_smem)
from stereo_toolbox_tpu_torch.ops.volume import (
    CONCAT_MAX_SMEM, CONCAT_THREADS, GATHER_ITEMS_PER_SM, GATHER_THREADS,
    GWC_MAX_SMEM, GWC_TILE_W, SAMPLE_GWC_THREADS, concat_plan, concat_smem,
    concat_volume_reference, gather_plan, gather_right_by_samples_reference,
    gwc_backward_plan, gwc_plan, gwc_strip,
    gwc_volume_backward_reference, gwc_volume_from_samples_reference,
    gwc_volume_reference, sample_gwc_plan, sample_gwc_slot)

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


def walk_gwc_backward(left, right, gd, d_max, g_num, plan):
    """K1 backward's blocks (a row, a W tile, one output each), thread items
    and d steps with their sliding windows, in numpy (float64)."""
    b_num, h_num, w_num, c = left.shape
    cpg = c // g_num
    tw, s, ng = plan
    nv = ng * cpg
    outs = {0: np.full(left.shape, np.nan), 1: np.full(left.shape, np.nan)}
    slots = g_num // ng
    for bx in range(-(-w_num // tw)):
        w0 = bx * tw
        for h in range(h_num):
            for bz in range(2 * b_num):
                b, is_dr = bz >> 1, bz & 1
                feat = (left if is_dr else right)[b, h]
                for item in range(slots * (tw // s)):
                    slot, strip = item % slots, item // slots
                    ws = w0 + strip * s
                    if ws >= w_num:
                        continue
                    cols = slice(slot * nv, (slot + 1) * nv)
                    g0 = slot * ng
                    acc = np.zeros((s, nv))
                    win = [feat[ws + j, cols] if ws + j < w_num
                           else np.zeros(nv) for j in range(s)]
                    dmax = (min(d_max - 1, w_num - 1 - ws) if is_dr
                            else min(d_max - 1, ws + s - 1))
                    for d0 in range(0, dmax + 1, s):
                        for u in range(s):
                            d = d0 + u
                            if d > dmax:
                                continue
                            if not is_dr:
                                if d > 0:
                                    win[(s - u) % s] = (
                                        feat[ws - d, cols] if ws - d >= 0
                                        else np.zeros(nv))
                                for j in range(s):
                                    w = ws + j
                                    if w < w_num and d <= w:
                                        g = gd[b, d, h, w, g0:g0 + ng]
                                        acc[j] += (np.repeat(g, cpg)
                                                   * win[(j - u + s) % s])
                            else:
                                if d > 0:
                                    x = ws + d + s - 1
                                    win[(u + s - 1) % s] = (
                                        feat[x, cols] if x < w_num
                                        else np.zeros(nv))
                                for j in range(s):
                                    x = ws + j + d
                                    if x < w_num:
                                        g = gd[b, d, h, x, g0:g0 + ng]
                                        acc[j] += (np.repeat(g, cpg)
                                                   * win[(j + u) % s])
                    for j in range(s):
                        if ws + j < w_num:
                            outs[is_dr][b, h, ws + j, cols] = acc[j] / cpg
    return outs[0], outs[1]


# (b, h, w, c, d, g): W not a multiple of the tile, D > W, C/G = 8, 3, 1,
# 16 and 12, B = 3
GWC_BWD_CASES = [(1, 2, 40, 320, 12, 40), (2, 2, 37, 48, 48, 16),
                 (1, 2, 9, 6, 13, 6), (3, 1, 33, 32, 5, 2),
                 (1, 2, 20, 36, 7, 3)]


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
    for align in (16, 2):
        plan = gwc_backward_plan(c, g, dtype, align)
        got = walk_gwc_backward(left, right, gd, d, g, plan)
        for got_t, want_t in zip(got, want):
            assert not np.isnan(got_t).any()
            np.testing.assert_allclose(got_t, want_t.numpy(), rtol=0,
                                       atol=1e-12)


@pytest.mark.parametrize("c,g", [(320, 40), (160, 40), (48, 16), (6, 6),
                                 (32, 2)])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_gwc_backward_plan_fits_the_kernel(c, g, dtype):
    """A tile of whole strips; the forward's strip; two groups a thread only
    in bfloat16 with G even and a 4-byte aligned gradient."""
    for align in (16, 4, 2):
        tw, s, ng = gwc_backward_plan(c, g, dtype, align)
        assert tw == GWC_TILE_W and tw % s == 0
        assert s == gwc_strip(c // g, ng) and s * ng * (c // g) <= 32
        assert ng == (2 if dtype == BF16 and g % 2 == 0 and align >= 4
                      else 1)


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
