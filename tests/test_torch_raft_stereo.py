"""RAFTStereo in the PyTorch port against the JAX package, on the CPU.

The published widths (hidden dims 128×3, 3 GRU layers, 4 correlation
levels of radius 4, ``band_max_disp`` 192 with ``band_margin`` 32: a band
reaching 48 + 8 columns at 1/4) with ``valid_iters=3``, on seeded random
JAX variables (`_torch_jax_variables.random_variables`; the frozen
BatchNorms' statistics random too) carried into the port by
``utils.weights.from_jax_variables``:

  * the eval forward, ``corr_impl='banded'``, at 64×256 (W/4 = 64 > 48:
    the cap binds) and 64×128 (W/4 = 32: the width clamps it), and
    ``'reg'`` at 64×128: mean |Δ| / max(mean |ref|, 1) < 5e-3 and the 99th
    percentile < 2e-2 (DEFOM's rule, ``tests/test_torch_defom.py``);
    ``'alt'`` equal to ``'reg'`` in the port;
  * the bfloat16 forward against JAX's ``dtype=bfloat16``, compiled with
    XLA's excess precision off, within 2× JAX's own bfloat16-vs-float32
    distance (mean |Δ|);
  * `BasicEncoder`, `MultiBasicEncoder` and the update block (two flow
    channels, RAFT's names) at ``n_gru_layers`` 2 and 3, 1e-4 × max|ref|;
  * the ``state_dict``: JAX's importer takes it back to the same variables,
    and its keys are the original toolbox's;
  * the entry point: the card by default, raising without one; train mode
    raises.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_variables import carry, close, random_variables
from stereo_toolbox_tpu.models import create_model as jax_create_model
from stereo_toolbox_tpu.models import raft_stereo as jraft
from stereo_toolbox_tpu.utils.torch_import import import_torch_checkpoint
from stereo_toolbox_tpu_torch import eval as port_eval
from stereo_toolbox_tpu_torch.datasets.fixtures import write_eval_trees
from stereo_toolbox_tpu_torch.models import create_model, raft_stereo
from stereo_toolbox_tpu_torch.utils import weights
from stereo_toolbox_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

NAME = "RAFTStereo"
ITERS = 3
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}


def _pair(h, w, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(1, h, w, 3).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def variables():
    jm = jax_create_model(NAME, valid_iters=ITERS)
    return random_variables(jm.init, *_pair(64, 128), seed=1)


@pytest.fixture(scope="module")
def jax_forward(variables):
    """JAX's forward of `variables` by (H, W, dtype, corr_impl), each
    compiled and run once in the module."""
    cache = {}

    def forward(h, w, dtype=None, impl="banded"):
        if (h, w, dtype, impl) not in cache:
            cache[h, w, dtype, impl] = _jax_forward(variables, h, w, dtype,
                                                    corr_impl=impl)
        return cache[h, w, dtype, impl]
    return forward


def _jax_forward(variables, h, w, dtype=None, **kw):
    jm = jax_create_model(NAME, valid_iters=ITERS, dtype=dtype, **kw)
    left, right = _pair(h, w)
    fn = jax.jit(jm.apply)
    if dtype is not None:
        fn = fn.lower(variables, left, right).compile(
            compiler_options=NO_EXCESS_PRECISION)
    return np.asarray(fn(variables, left, right), np.float32)


def _port_forward(variables, h, w, dtype=torch.float32, **kw):
    m = create_model(NAME, device="cpu", dtype=dtype, valid_iters=ITERS,
                     **kw)
    sd = from_jax_variables(NAME, variables)
    m.load_state_dict({k: v.to(m.state_dict()[k].dtype)
                       for k, v in sd.items()})
    with torch.no_grad():
        out = m(*map(torch.from_numpy, _pair(h, w)))
    assert out.dtype == torch.float32
    return out.numpy()


def _defom_rule(got, want, what):
    assert got.shape == want.shape
    d = np.abs(got - want)
    scale = max(float(np.abs(want).mean()), 1.0)
    print(f"{what}: mean |d| {d.mean():.3e}, p99 {np.percentile(d, 99):.3e}"
          f", max {d.max():.3e}, scale {scale:.3f}")
    assert d.mean() / scale < 5e-3
    assert np.percentile(d, 99) / scale < 2e-2


@pytest.mark.parametrize("h,w,impl", [(64, 256, "banded"),
                                      (64, 128, "banded"), (64, 128, "reg")])
def test_eval_forward_matches_jax(variables, jax_forward, h, w, impl):
    want = jax_forward(h, w, impl=impl)
    got = _port_forward(variables, h, w, corr_impl=impl)
    assert got.shape == (1, h, w)
    _defom_rule(got, want, f"{NAME} {impl} {h}x{w}")


def test_alt_correlation_equals_reg(variables):
    """``corr_impl='alt'`` recomputes the all-pairs rows a chunk at a time:
    the same output as ``'reg'`` (`corr_lookup_1d_alt` is held against
    JAX in ``tests/test_torch_raft_ops.py``)."""
    alt = _port_forward(variables, 64, 128, corr_impl="alt")
    reg = _port_forward(variables, 64, 128, corr_impl="reg")
    np.testing.assert_allclose(alt, reg, rtol=0,
                               atol=1e-6 * np.abs(reg).max())


def test_bfloat16_forward_within_twice_jax_own_distance(variables,
                                                       jax_forward):
    want32 = jax_forward(64, 256)
    want16 = jax_forward(64, 256, jnp.bfloat16)
    got16 = _port_forward(variables, 64, 256, dtype=torch.bfloat16)
    own = float(np.abs(want16 - want32).mean())
    apart = float(np.abs(got16 - want16).mean())
    print(f"{NAME} bf16: port vs JAX mean |d| {apart:.3e}, JAX bf16 vs f32 "
          f"{own:.3e}")
    assert 0 < own and apart <= 2 * own


# ------------------------------------------------------------------ blocks
def test_encoders_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 32, 48, 3).astype(np.float32)
    fnet = jraft.BasicEncoder(256, "instance")
    v = random_variables(fnet.init, x, seed=3)
    want = jax.jit(fnet.apply)(v, x)

    def convert(t, p, k):
        weights._raft_trunk(t, p, k, "instance")
        t.conv(f"{p}/Conv_1", f"{k}.conv2", bias=True)
    port = carry(raft_stereo.BasicEncoder(256, "instance"), v, convert)
    with torch.no_grad():
        close(port(torch.from_numpy(x)), want, 1e-4)
    cnet = jraft.MultiBasicEncoder((96, 112, 128), (64, 80, 32), "batch")
    v = random_variables(cnet.init, x, seed=4)
    want = jax.jit(cnet.apply)(v, x)
    port = carry(raft_stereo.MultiBasicEncoder((96, 112, 128), (64, 80, 32),
                                               "batch"), v,
                 weights._multi_basic_encoder)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for (gh, gc), (wh, wc), s in zip(got, want, (4, 8, 16)):
        assert gh.shape[1:3] == (32 // s, 48 // s)
        close(gh, wh, 1e-4)
        close(gc, wc, 1e-4)


@pytest.mark.parametrize("n_gru_layers", [2, 3])
def test_update_block_matches_jax(n_gru_layers):
    rng = np.random.RandomState(5)
    hid = (16, 24, 32)
    b, h, w = 2, 8, 12
    nets = [rng.randn(b, h // s, w // s, c).astype(np.float32)
            for s, c in ((1, 32), (2, 24), (4, 16))]
    ctxs = [[rng.randn(*n.shape).astype(np.float32) for _ in range(3)]
            for n in nets]
    corr_in = rng.randn(b, h, w, 36).astype(np.float32)
    flow = np.stack([rng.uniform(-5, 0, (b, h, w)), np.zeros((b, h, w))],
                    -1).astype(np.float32)
    jm = jraft.BasicMultiUpdateBlock(hid, n_gru_layers, 4, flow_channels=2)
    args = (tuple(nets), tuple(tuple(c) for c in ctxs), corr_in, flow)
    v = random_variables(jm.init, *args, seed=6)
    jn, jmask, jdelta = jax.jit(jm.apply)(v, *args)
    port = carry(raft_stereo.BasicMultiUpdateBlock(
        36, hid, 4, flow_channels=2, n_gru_layers=n_gru_layers,
        head="flow_head", flow_convs="convf"), v,
        lambda t, p, k: weights._update_block(t, p, k, "convf", "flow_head"))
    assert hasattr(port, "gru32") == (n_gru_layers == 3)
    with torch.no_grad():
        pn, pmask, pdelta = port(
            tuple(map(torch.from_numpy, nets)),
            tuple(tuple(map(torch.from_numpy, c)) for c in ctxs),
            torch.from_numpy(corr_in), torch.from_numpy(flow))
    for a, bb in zip(pn[:n_gru_layers], jn[:n_gru_layers]):
        close(a, bb, 1e-4)
    close(pmask, jmask, 1e-4)
    close(pdelta, jdelta, 1e-4)
    assert pdelta.shape == (b, h, w, 2)


# ----------------------------------------------------------------- weights
def test_state_dict_round_trips_through_jax_importer(variables):
    m = create_model(NAME, device="cpu")
    m.load_state_dict(from_jax_variables(NAME, variables))
    back = import_torch_checkpoint(
        NAME, {k: t.numpy() for k, t in m.state_dict().items()})
    want = dict(jax.tree_util.tree_flatten_with_path(variables)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert set(got) == set(want)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a)


def test_port_state_dict_has_original_torch_names():
    keys = set(create_model(NAME, device="cpu").state_dict())
    for k in ("fnet.conv1.weight", "fnet.layer2.0.downsample.0.bias",
              "fnet.layer3.1.conv2.weight", "fnet.conv2.bias",
              "cnet.norm1.running_var", "cnet.layer1.0.norm2.weight",
              "cnet.layer4.0.downsample.1.running_mean",
              "cnet.layer5.1.conv1.weight", "cnet.outputs08.1.0.norm1.bias",
              "cnet.outputs08.0.1.weight", "cnet.outputs16.1.1.bias",
              "cnet.outputs32.0.weight", "context_zqr_convs.2.weight",
              "update_block.encoder.convc1.weight",
              "update_block.encoder.convf1.weight",
              "update_block.encoder.convf2.bias",
              "update_block.encoder.conv.weight",
              "update_block.gru08.convz.weight",
              "update_block.gru16.convr.bias",
              "update_block.gru32.convq.weight",
              "update_block.flow_head.conv1.weight",
              "update_block.flow_head.conv2.bias",
              "update_block.mask.0.weight", "update_block.mask.2.bias"):
        assert k in keys, k
    # instance norm has no parameters; the doubly registered norm3 is not
    # the port's (weights.UNUSED_REFERENCE_KEYS)
    assert not any(k.startswith("fnet.") and "norm" in k for k in keys)
    assert not any(".norm3." in k for k in keys)


# ------------------------------------------------------------- entry point
def test_create_model_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(NAME)


def test_train_mode_is_not_implemented():
    m = create_model(NAME, device="cpu").train()
    x = torch.zeros(1, 32, 64, 3)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        m(x, x)


def test_eval_entry_point_runs_the_model(tmp_path):
    """``python -m stereo_toolbox_tpu_torch.eval`` with this model on the
    CPU: SceneFlow's suite over one 40×56 frame (padded to 96×96)."""
    roots = write_eval_trees(str(tmp_path), frames=1,
                             sizes={"sceneflow": (40, 56)}, max_disp=32,
                             datasets=("sceneflow",))
    got = port_eval.main(["--device", "cpu", "--model", NAME,
                          "--suite", "sceneflow", "--root",
                          roots["sceneflow"], "--lists", roots["lists"]])
    assert got.shape == (4,) and np.isfinite(got).all()
