"""The RAFT pieces DEFOMStereo runs, in the port against the JAX package,
on the CPU, on the same numpy inputs (weights carried over where a module
has them, through ``utils.weights``'s name map):

  * ``ops.sampling.sample_1d`` (JAX's gather path; positions out of range,
    in (−1, 0) and past N − 1; bfloat16 values at float32 positions);
  * ``ops.corr``: `all_pairs_correlation` (float32, / √C), `avg_pool_last`
    (odd widths floor), `build_corr_pyramid` and `corr_lookup_1d`
    (level-major, dx ascending), exact to float32 rounding;
  * ``ops.corr``'s banded volumes (`build_corr_band_pyramid`,
    `corr_lookup_1d_banded`) where the cap binds and where the width clamps
    it, every band column (the zero edges included) at every level, and
    against the all-pairs pyramid inside the band (level 0 bit for bit);
    `corr_lookup_1d_alt`; IGEV's `build_volume_pyramid` and
    `volume_lookup_1d`;
  * ``ops.upsample``: `unfold3x3` (exact), `convex_upsample` and
    `context_upsample`;
  * ``nn.gru``: `ConvGRU` with context biases and `pool2x`;
  * ``models.raft_stereo``: `RAFTResBlock` with instance and with frozen
    batch norm, at stride 1 and 2 (symmetric padding), in train mode too;
    `BasicMultiUpdateBlock` (three GRUs, the motion encoder with one flow
    channel, the flow and mask heads).

Float32 throughout: 1e-5 × max|ref| for the ops, 1e-4 for the modules
(their convs on two backends); bfloat16 `sample_1d` within one bfloat16
rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereo_toolbox_tpu.models import raft_stereo as jraft
from stereo_toolbox_tpu.nn import gru as jgru
from stereo_toolbox_tpu.ops import corr as jcorr
from stereo_toolbox_tpu.ops import sampling as jsampling
from stereo_toolbox_tpu.ops import upsample as jupsample
from stereo_toolbox_tpu_torch.models import raft_stereo
from stereo_toolbox_tpu_torch.nn import gru
from stereo_toolbox_tpu_torch.ops import corr, sampling, upsample
from stereo_toolbox_tpu_torch.utils import weights


def _rng(seed):
    return np.random.RandomState(seed)


def _close(got, want, rel):
    got = np.asarray(torch.as_tensor(got).float())
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), err


# ------------------------------------------------------------------ ops
def test_sample_1d_matches_jax_gather_path():
    rng = _rng(0)
    values = rng.randn(2, 3, 11).astype(np.float32)
    # in range, (−1, 0), exactly N − 1, past N − 1, ≤ −1, ≥ N, integers
    x = np.concatenate([rng.uniform(-2, 13, (2, 3, 40)),
                        np.array([-0.5, -1.0, 0.0, 10.0, 10.5, 11.0, 3.0,
                                  -0.01])[None, None].repeat(2, 0)
                        .repeat(3, 1)], -1).astype(np.float32)
    want = jsampling.sample_1d(jnp.asarray(values), jnp.asarray(x),
                               method="gather")
    got = sampling.sample_1d(torch.from_numpy(values), torch.from_numpy(x))
    _close(got, want, 1e-6)
    # one position in (−1, 0) weights index 0 alone
    one = sampling.sample_1d(torch.tensor([[2.0, 5.0]]),
                             torch.tensor([[-0.25]]))
    assert torch.allclose(one, torch.tensor([[1.5]]))
    # bfloat16 values, float32 positions: the weight rounds, not the position
    vb = torch.from_numpy(values).bfloat16()
    got16 = sampling.sample_1d(vb, torch.from_numpy(x))
    want16 = jsampling.sample_1d(jnp.asarray(vb.float().numpy(),
                                             jnp.bfloat16), jnp.asarray(x),
                                 method="gather")
    assert got16.dtype == torch.bfloat16
    _close(got16, np.asarray(want16, np.float32), 1e-2)


def test_correlation_pyramid_and_lookup_match_jax():
    rng = _rng(1)
    f1, f2 = (rng.randn(2, 4, 13, 24).astype(np.float32) for _ in range(2))
    want = jcorr.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2))
    got = corr.all_pairs_correlation(torch.from_numpy(f1),
                                     torch.from_numpy(f2))
    assert got.dtype == torch.float32 and got.shape == (2, 4, 13, 13)
    _close(got, want, 1e-6)
    jpyr = jcorr.build_corr_pyramid(want, 3)
    pyr = corr.build_corr_pyramid(got, 3)
    assert [p.shape[-1] for p in pyr] == [13, 6, 3]
    for a, b in zip(pyr, jpyr):
        _close(a, b, 1e-6)
    x = rng.uniform(-3, 16, (2, 4, 13)).astype(np.float32)
    for radius in (2, 4):
        want_l = jcorr.corr_lookup_1d(jpyr, jnp.asarray(x), radius)
        got_l = corr.corr_lookup_1d(pyr, torch.from_numpy(x), radius)
        assert got_l.shape == (2, 4, 13, 3 * (2 * radius + 1))
        _close(got_l, want_l, 1e-6)
    # bfloat16 features: the correlation is float32
    got16 = corr.all_pairs_correlation(torch.from_numpy(f1).bfloat16(),
                                       torch.from_numpy(f2).bfloat16())
    assert got16.dtype == torch.float32


def test_unfold_and_convex_upsample_match_jax():
    rng = _rng(2)
    disp = rng.randn(2, 5, 7).astype(np.float32)
    mask = rng.randn(2, 5, 7, 9 * 16).astype(np.float32)
    assert np.array_equal(
        upsample.unfold3x3(torch.from_numpy(disp)).numpy(),
        np.asarray(jupsample.unfold3x3(jnp.asarray(disp))))
    want = jupsample.convex_upsample(jnp.asarray(disp), jnp.asarray(mask), 4)
    got = upsample.convex_upsample(torch.from_numpy(disp),
                                   torch.from_numpy(mask), 4)
    assert got.shape == (2, 20, 28) and got.dtype == torch.float32
    _close(got, want, 1e-5)


# JAX's band volumes, compiled (eagerly it dispatches one product a column)
_jax_bands = jax.jit(jcorr.build_corr_band_pyramid,
                     static_argnums=(2, 3, 4, 5, 6))


@pytest.mark.parametrize("w,d_max", [(64, 48), (32, 48), (13, 5)])
def test_band_pyramid_and_lookup_match_jax(w, d_max):
    """The cap binds at W 64 (48 < 64) and at the ragged W 13 (odd pooled
    rows, a truncated tail at every level); the width clamps it at W 32.
    Every column of every band, edges included, against JAX's."""
    rng = _rng(6)
    f1, f2 = (rng.randn(2, 3, w, 16).astype(np.float32) for _ in range(2))
    levels, radius, margin = 4, 4, 8
    d = jcorr.band_d_max(d_max, w)
    assert corr.band_d_max(d_max, w) == d == min(d_max, w)
    assert corr.band_d_max(None, w) == jcorr.band_d_max(None, w) == w
    offs = jcorr.band_offsets(levels, d, radius, margin)
    assert corr.band_offsets(levels, d, radius, margin) == offs
    # one compile a width: the √C division where the cap binds, none else
    for normalize in [d < w]:
        want = _jax_bands(jnp.asarray(f1), jnp.asarray(f2), levels, d,
                          radius, margin, normalize)
        got = corr.build_corr_band_pyramid(
            torch.from_numpy(f1), torch.from_numpy(f2), levels, d, radius,
            margin, normalize)
        for a, b, (lo, hi) in zip(got, want, offs):
            assert a.shape == b.shape == (2, 3, w, hi - lo + 1)
            assert a.dtype == torch.float32
            _close(a, b, 1e-5)
            # the zero edge, column by column: zero exactly where JAX's is
            assert np.array_equal(a.numpy() == 0, np.asarray(b) == 0)
    x = np.concatenate([rng.uniform(-margin - 3, w + 3, (2, 3, w)),
                        np.arange(w)[None, None].repeat(2, 0).repeat(3, 1)
                        - rng.uniform(0, d, (2, 3, w))], 1).astype(
                            np.float32)
    f1, f2 = (np.concatenate([f, f], 1) for f in (f1, f2))  # 6 rows
    bands = corr.build_corr_band_pyramid(torch.from_numpy(f1),
                                         torch.from_numpy(f2), levels, d,
                                         radius, margin)
    jbands = _jax_bands(jnp.asarray(f1), jnp.asarray(f2), levels, d, radius,
                        margin, True)
    want = jax.jit(jcorr.corr_lookup_1d_banded, static_argnums=(2, 3))(
        jbands, jnp.asarray(x), offs, radius)
    got = corr.corr_lookup_1d_banded(bands, torch.from_numpy(x), offs,
                                     radius)
    assert got.shape == (2, 6, w, levels * (2 * radius + 1))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("w,d_max", [(64, 48), (32, 48)])
def test_band_lookup_equals_all_pairs_inside_the_band(w, d_max):
    """At disparities in ``[−margin, d_max + margin]`` the banded lookup
    reads what the all-pairs pyramid reads, to float32 rounding (its
    positions, ``x − ⌊w / 2^i⌋ − lo_i``, round otherwise; the pooled levels
    re-associate). Level 0's band is the all-pairs volume gathered, bit for
    bit."""
    rng = _rng(7)
    f1, f2 = (torch.from_numpy(rng.randn(2, 3, w, 16).astype(np.float32))
              for _ in range(2))
    levels, radius, margin = 4, 4, 8
    d = corr.band_d_max(d_max, w)
    offs = corr.band_offsets(levels, d, radius, margin)
    bands = corr.build_corr_band_pyramid(f1, f2, levels, d, radius, margin)
    pyramid = corr.build_corr_pyramid(corr.all_pairs_correlation(f1, f2),
                                      levels)
    disp = torch.from_numpy(rng.uniform(-margin, d + margin, (2, 3, w))
                            .astype(np.float32))
    x = torch.arange(w, dtype=torch.float32) - disp
    lo, hi = offs[0]
    cols = torch.arange(w)[:, None] + torch.arange(lo, hi + 1)
    inside = (cols >= 0) & (cols < w)
    assert torch.equal(bands[0][..., inside],
                       pyramid[0][..., torch.arange(w)[:, None].expand(
                           -1, hi - lo + 1)[inside], cols[inside]])
    got = corr.corr_lookup_1d_banded(bands, x, offs, radius)
    want = corr.corr_lookup_1d(pyramid, x, radius)
    err = (got - want).abs().max().item()
    print(f"banded vs all-pairs lookup: max|d| {err:.3e}")
    _close(got, want.numpy(), 1e-5)


def test_alt_lookup_matches_jax():
    rng = _rng(8)
    f1, f2 = (rng.randn(2, 21, 24, 16).astype(np.float32) for _ in range(2))
    x = rng.uniform(-3, 27, (2, 21, 24)).astype(np.float32)
    want = jcorr.corr_lookup_1d_alt(jnp.asarray(f1), jnp.asarray(f2),
                                    jnp.asarray(x), 4, 4, h_chunk=8)
    got = corr.corr_lookup_1d_alt(torch.from_numpy(f1), torch.from_numpy(f2),
                                  torch.from_numpy(x), 4, 4, h_chunk=8)
    assert got.shape == (2, 21, 24, 36)
    _close(got, want, 1e-5)


def test_volume_pyramid_lookup_and_context_upsample_match_jax():
    rng = _rng(9)
    vol = rng.randn(2, 5, 7, 13, 8).astype(np.float32)     # D 13: floors
    jpyr = jcorr.build_volume_pyramid(jnp.asarray(vol), 3)
    pyr = corr.build_volume_pyramid(torch.from_numpy(vol), 3)
    assert [p.shape[-2] for p in pyr] == [13, 6, 3]
    for a, b in zip(pyr, jpyr):
        _close(a, b, 1e-6)
    x = rng.uniform(-3, 16, (2, 5, 7)).astype(np.float32)
    want = jcorr.volume_lookup_1d(jpyr, jnp.asarray(x), 4)
    got = corr.volume_lookup_1d(pyr, torch.from_numpy(x), 4)
    assert got.shape == (2, 5, 7, 3 * 8 * 9)
    _close(got, want, 1e-6)
    disp = rng.uniform(0, 20, (2, 5, 7)).astype(np.float32)
    wts = rng.rand(2, 20, 28, 9).astype(np.float32)
    want = jupsample.context_upsample(jnp.asarray(disp), jnp.asarray(wts), 4)
    got = upsample.context_upsample(torch.from_numpy(disp),
                                    torch.from_numpy(wts), 4)
    assert got.shape == (2, 20, 28)
    _close(got, want, 1e-6)


# -------------------------------------------------------------- modules
class _Holder(torch.nn.Module):
    def __init__(self, module):
        super().__init__()
        self.m = module


def _carry(module, variables, convert):
    """The JAX `variables` of one module into the port's `module`, through
    `convert(t, "m", "m")` of ``utils.weights``."""
    t = weights.JaxToTorch({"params": {"m": variables["params"]},
                            "batch_stats": {"m": variables.get(
                                "batch_stats", {})}})
    convert(t, "m", "m")
    holder = _Holder(module)
    holder.load_state_dict(t.state_dict(), strict=False)
    missing = set(holder.state_dict()) - set(t.sd)
    assert all(k.endswith("num_batches_tracked") for k in missing), missing
    return module


def _gru_convert(t, path, key):
    for c in ("convz", "convr", "convq"):
        t.conv(f"{path}/{c}", f"{key}.{c}", bias=True)


def test_conv_gru_and_pool2x_match_jax():
    rng = _rng(3)
    h = rng.randn(2, 6, 9, 16).astype(np.float32)
    x = rng.randn(2, 6, 9, 24).astype(np.float32)
    ctx = [rng.randn(2, 6, 9, 16).astype(np.float32) for _ in range(3)]
    jm = jgru.ConvGRU(16)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(h), jnp.asarray(x),
                tuple(map(jnp.asarray, ctx)))
    want = jm.apply(v, jnp.asarray(h), jnp.asarray(x),
                    tuple(map(jnp.asarray, ctx)))
    port = _carry(gru.ConvGRU(16, 24), jax.tree_util.tree_map(np.asarray, v),
                  _gru_convert)
    got = port(torch.from_numpy(h), torch.from_numpy(x),
               tuple(map(torch.from_numpy, ctx)))
    _close(got.detach(), want, 1e-4)
    _close(gru.pool2x(torch.from_numpy(x)), jgru.pool2x(jnp.asarray(x)),
           1e-6)


@pytest.mark.parametrize("norm", ["instance", "batch"])
@pytest.mark.parametrize("stride,cin,cout", [(1, 16, 16), (2, 16, 24),
                                             (1, 8, 16)])
def test_raft_res_block_matches_jax(norm, stride, cin, cout):
    rng = _rng(4)
    x = rng.randn(2, 10, 14, cin).astype(np.float32)
    jm = jraft.RAFTResBlock(cout, norm, stride)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(1),
                                                   jnp.asarray(x)))
    if norm == "batch":        # running statistics away from 0 / 1
        v["batch_stats"] = jax.tree_util.tree_map(
            lambda a: a + rng.uniform(0.1, 0.5, a.shape).astype(a.dtype),
            v["batch_stats"])
    want = jm.apply(v, jnp.asarray(x))
    port = _carry(raft_stereo.RAFTResBlock(cin, cout, norm, stride), v,
                  lambda t, p, k: weights._raft_res(t, p, k, norm))
    for mode in (False, True):      # the norms are the same in train mode
        got = port.train(mode)(torch.from_numpy(x))
        _close(got.detach(), want, 1e-4)


def test_basic_multi_update_block_matches_jax():
    rng = _rng(5)
    hid = (16, 16, 16)
    b, h, w = 2, 8, 12
    nets = [rng.randn(b, h // s, w // s, 16).astype(np.float32)
            for s in (1, 2, 4)]
    ctxs = [[rng.randn(b, h // s, w // s, 16).astype(np.float32)
             for _ in range(3)] for s in (1, 2, 4)]
    corr_in = rng.randn(b, h, w, 18).astype(np.float32)
    flow = rng.uniform(0, 5, (b, h, w, 1)).astype(np.float32)
    jm = jraft.BasicMultiUpdateBlock(hid, 3, 4, flow_channels=1)
    args = (tuple(map(jnp.asarray, nets)),
            tuple(tuple(map(jnp.asarray, c)) for c in ctxs),
            jnp.asarray(corr_in), jnp.asarray(flow))
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(2),
                                                   *args))
    (jn, jmask, jdelta) = jm.apply(v, *args)
    port = _carry(raft_stereo.BasicMultiUpdateBlock(18, hid, 4), v,
                  weights._update_block)
    (pn, pmask, pdelta) = port(
        tuple(map(torch.from_numpy, nets)),
        tuple(tuple(map(torch.from_numpy, c)) for c in ctxs),
        torch.from_numpy(corr_in), torch.from_numpy(flow))
    for a, bb in zip(pn, jn):
        _close(a.detach(), bb, 1e-4)
    _close(pmask.detach(), jmask, 1e-4)
    _close(pdelta.detach(), jdelta, 1e-4)
    assert pmask.shape == (b, h, w, 144) and pdelta.shape == (b, h, w, 1)
