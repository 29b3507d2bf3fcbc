"""SelectiveRAFT and SelectiveIGEV in the PyTorch port against the JAX
package, on the CPU.

The published widths (hidden dims 128×3, 3 GRU layers, radius 4; RAFT 4
correlation levels with ``band_max_disp`` 192, IGEV 2 levels with max_disp
192; ``band_margin`` 32) with ``valid_iters=3``, on seeded random JAX
variables (`_torch_jax_variables.random_variables`: ``jax.eval_shape`` of an
eval-mode init filled from numpy; every BatchNorm's statistics random)
carried into the port by ``utils.weights.from_jax_variables``:

  * the eval forwards at 32×256 (W/4 = 64 > 48: the band's cap binds),
    ``corr_impl='banded'`` and ``'reg'``: mean |Δ| / max(mean |ref|, 1) <
    5e-3 and the 99th percentile < 2e-2 (DEFOM's rule, as
    ``tests/test_torch_igev.py``); SelectiveIGEV's initial disparity (the
    softmax regression of ``classifier``'s costs, at 1/4) within mean <
    1e-3 and max < 1e-2 px;
  * the bfloat16 forwards against JAX's ``dtype=bfloat16``, compiled with
    XLA's excess precision off, within 2× JAX's own bfloat16-vs-float32
    distance (mean |Δ|);
  * the blocks, float32, 1e-4 × max|ref|: CAM, SAM, the GRU at kernel
    sizes 1 and 3 and the SelectiveConvGRU blending both, the motion
    encoder under both models' names, and `SelectiveUpdateBlock` at
    ``n_gru_layers`` 1–3 with both heads;
  * the ``state_dict``: JAX's importer takes it back to the same variables
    (SelectiveIGEV's train-only heads carried where the variables have
    them, zeros where an eval-mode init lacks them); its keys are the
    original toolbox's, and an original checkpoint's dead keys are dropped;
  * the entry points: the card by default, raising without one; train mode
    raises; ``python -m stereo_toolbox_tpu_torch.eval`` runs both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_jax_variables import carry, close, random_variables
from stereo_toolbox_tpu.models import create_model as jax_create_model
from stereo_toolbox_tpu.models import selective as jsel
from stereo_toolbox_tpu.utils.torch_import import import_torch_checkpoint
from stereo_toolbox_tpu_torch import eval as port_eval
from stereo_toolbox_tpu_torch.datasets.fixtures import write_eval_trees
from stereo_toolbox_tpu_torch.models import create_model, selective
from stereo_toolbox_tpu_torch.nn.gru import ConvGRU
from stereo_toolbox_tpu_torch.models.raft_stereo import BasicMotionEncoder
from stereo_toolbox_tpu_torch.utils import weights
from stereo_toolbox_tpu_torch.utils.weights import (IGEV_TRAIN_HEADS,
                                                    from_jax_variables,
                                                    reference_state_dict)

torch.set_num_threads(2)

RAFT, IGEV = "SelectiveRAFT", "SelectiveIGEV"
NAMES = (RAFT, IGEV)
ITERS = 3
D4 = 192 // 4
SIZE = (32, 256)                 # W/4 = 64 > 48: the band's cap binds
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
# the output's gates (mean, p99 of |d| over max(mean |ref|, 1)) and the
# initial disparity's (mean, max px at 1/4)
EVAL_GATES = (5e-3, 2e-2)
INIT_GATES = (1e-3, 1e-2)


def _pair(h, w, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(1, h, w, 3).astype(np.float32) for _ in range(2))


@pytest.fixture(scope="module")
def variables():
    """Each model's JAX variables, from one eval-mode ``eval_shape``."""
    return {name: random_variables(
        jax_create_model(name, valid_iters=ITERS).init, *_pair(*SIZE),
        seed=1) for name in NAMES}


@pytest.fixture(scope="module")
def jax_forward(variables):
    """JAX's forward by (model, dtype, corr_impl), each compiled and run
    once in the module."""
    cache = {}

    def forward(name, dtype=None, impl="banded"):
        if (name, dtype, impl) not in cache:
            cache[name, dtype, impl] = _jax_forward(
                name, variables[name], dtype, corr_impl=impl)
        return cache[name, dtype, impl]
    return forward


def _jax_forward(name, variables, dtype=None, **kw):
    """JAX's output and, for SelectiveIGEV, the initial disparity it
    regresses from ``classifier``'s costs (captured)."""
    jm = jax_create_model(name, valid_iters=ITERS, dtype=dtype, **kw)
    left, right = _pair(*SIZE)

    def apply(v, a, b):
        return jm.apply(v, a, b, capture_intermediates=lambda mdl, _:
                        mdl.name == "classifier")
    fn = jax.jit(apply)
    if dtype is not None:
        fn = fn.lower(variables, left, right).compile(
            compiler_options=NO_EXCESS_PRECISION)
    out, state = fn(variables, left, right)
    init = None
    if name == IGEV:
        cost = state["intermediates"]["classifier"]["__call__"][0][..., 0]
        prob = jax.nn.softmax(cost.astype(jnp.float32), axis=1)
        init = np.asarray(jnp.einsum("bdhw,d->bhw", prob,
                                     jnp.arange(D4, dtype=jnp.float32)))
    return np.asarray(out, np.float32), init


def _port_forward(name, variables, dtype=torch.float32, **kw):
    m = create_model(name, device="cpu", dtype=dtype, valid_iters=ITERS,
                     **kw)
    sd = from_jax_variables(name, variables)
    m.load_state_dict({k: v.to(m.state_dict()[k].dtype)
                       for k, v in sd.items()})
    costs = []
    if name == IGEV:
        m.classifier.register_forward_hook(lambda mod, i, o: costs.append(o))
    with torch.no_grad():
        out = m(*map(torch.from_numpy, _pair(*SIZE)))
    assert out.dtype == torch.float32
    init = None
    if costs:
        prob = torch.softmax(costs[0][:, 0].float(), dim=1)
        init = torch.einsum("bdhw,d->bhw", prob,
                            torch.arange(D4).float()).numpy()
    return out.numpy(), init


@pytest.mark.parametrize("impl", ["banded", "reg"])
@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_jax(variables, jax_forward, name, impl):
    want, want_init = jax_forward(name, impl=impl)
    got, got_init = _port_forward(name, variables[name], corr_impl=impl)
    assert got.shape == want.shape == (1, *SIZE)
    d = np.abs(got - want)
    scale = max(float(np.abs(want).mean()), 1.0)
    print(f"{name} {impl}: output mean |d| {d.mean():.3e}, p99 "
          f"{np.percentile(d, 99):.3e}, max {d.max():.3e}, scale "
          f"{scale:.3f}")
    assert d.mean() / scale < EVAL_GATES[0]
    assert np.percentile(d, 99) / scale < EVAL_GATES[1]
    if name == IGEV:
        assert got_init.shape == (1, SIZE[0] // 4, SIZE[1] // 4)
        di = np.abs(got_init - want_init)
        print(f"{name} {impl}: init_disp mean |d| {di.mean():.3e}, max "
              f"{di.max():.3e} px")
        assert di.mean() < INIT_GATES[0] and di.max() < INIT_GATES[1]


@pytest.mark.parametrize("name", NAMES)
def test_bfloat16_forward_within_twice_jax_own_distance(variables,
                                                       jax_forward, name):
    want32, _ = jax_forward(name)
    want16, _ = jax_forward(name, jnp.bfloat16)
    got16, _ = _port_forward(name, variables[name], dtype=torch.bfloat16)
    own = float(np.abs(want16 - want32).mean())
    apart = float(np.abs(got16 - want16).mean())
    print(f"{name} bf16: port vs JAX mean |d| {apart:.3e}, JAX bf16 vs f32 "
          f"{own:.3e}")
    assert 0 < own and apart <= 2 * own


# ------------------------------------------------------------------ blocks
def _run(port, *inputs):
    with torch.no_grad():
        return port(*(torch.from_numpy(np.asarray(x)) for x in inputs))


@pytest.mark.parametrize("kind", ["cam", "sam"])
def test_attention_matches_jax(kind):
    x = np.abs(np.random.RandomState(2).randn(2, 6, 10, 32)).astype(
        np.float32)
    if kind == "cam":
        jm, port = jsel.ChannelAttentionEnhancement(), \
            selective.ChannelAttentionEnhancement(32)

        def convert(t, p, k):
            t.conv(f"{p}/fc1", f"{k}.fc.0")
            t.conv(f"{p}/fc2", f"{k}.fc.2")
        shape = (2, 1, 1, 32)
    else:
        jm, port = jsel.SpatialAttentionExtractor(), \
            selective.SpatialAttentionExtractor()

        def convert(t, p, k):
            t.conv(f"{p}/Conv_0", f"{k}.samconv")
        shape = (2, 6, 10, 1)
    v = random_variables(jm.init, x, seed=3)
    got = _run(carry(port, v, convert), x)
    assert got.shape == shape
    close(got, jax.jit(jm.apply)(v, x), 1e-4)


def _gru_convert(t, p, k):
    for c in ("convz", "convr", "convq"):
        t.conv(f"{p}/{c}", f"{k}.{c}", bias=True)


@pytest.mark.parametrize("kind", ["small", "large", "selective"])
def test_conv_gru_matches_jax(kind):
    """The 1×1 (``small``) and 3×3 (``large``) GRUs alone, and the
    SelectiveConvGRU that blends them by the attention map."""
    rng = np.random.RandomState(4)
    h = np.tanh(rng.randn(2, 6, 10, 16)).astype(np.float32)
    x = rng.randn(2, 6, 10, 24).astype(np.float32)
    att = rng.uniform(0, 1, (2, 6, 10, 1)).astype(np.float32)
    if kind == "selective":
        jm = jsel.SelectiveConvGRU(16)
        args = (att, h, x)
        port = selective.SelectiveConvGRU(16, 24)

        def convert(t, p, k):
            for sub in ("small_gru", "large_gru"):
                _gru_convert(t, f"{p}/{sub}", f"{k}.{sub}")
    else:
        k = 1 if kind == "small" else 3
        jm, args, port = jsel.RaftConvGRU(16, k), (h, x), ConvGRU(16, 24, k)
        convert = _gru_convert
    v = random_variables(jm.init, *args, seed=5)
    close(_run(carry(port, v, convert), *args), jax.jit(jm.apply)(v, *args),
          1e-4)


@pytest.mark.parametrize("flow_convs", ["convf", "convd"])
def test_motion_encoder_matches_jax(flow_convs):
    """SelectiveRAFT's names (``convf``, 36 correlation channels) and
    SelectiveIGEV's (``convd``, 162)."""
    planes = 36 if flow_convs == "convf" else 162
    rng = np.random.RandomState(6)
    disp = rng.uniform(-20, 0, (2, 8, 12, 1)).astype(np.float32)
    corr = rng.randn(2, 8, 12, planes).astype(np.float32)
    jm = jsel.SelectiveMotionEncoder()
    v = random_variables(jm.init, disp, corr, seed=7)

    def convert(t, p, k):
        for i, name in enumerate(("convc1", "convc2", f"{flow_convs}1",
                                  f"{flow_convs}2", "conv")):
            t.conv(f"{p}/Conv_{i}", f"{k}.{name}", bias=True)
    port = carry(BasicMotionEncoder(planes, 1, flow_convs), v, convert)
    got = _run(port, disp, corr)
    assert got.shape == (2, 8, 12, 128)
    close(got, jax.jit(jm.apply)(v, disp, corr), 1e-4)


@pytest.mark.parametrize("head", ["convex", "superpixel"])
@pytest.mark.parametrize("n_gru_layers", [1, 2, 3])
def test_update_block_matches_jax(n_gru_layers, head):
    rng = np.random.RandomState(8)
    hid = (16, 24, 32)
    b, h, w = 2, 8, 12
    nets = [np.tanh(rng.randn(b, h // s, w // s, c)).astype(np.float32)
            for s, c in ((1, 32), (2, 24), (4, 16))]
    inps = [np.abs(rng.randn(*n.shape)).astype(np.float32) for n in nets]
    atts = [rng.uniform(0, 1, n.shape[:3] + (1,)).astype(np.float32)
            for n in nets]
    corr = rng.randn(b, h, w, 36).astype(np.float32)
    disp = rng.uniform(-20, 0, (b, h, w, 1)).astype(np.float32)
    jm = jsel.SelectiveUpdateBlock(hid, n_gru_layers, head)
    args = (tuple(nets), tuple(inps), tuple(atts), corr, disp)
    v = random_variables(jm.init, *args, seed=9)
    jn, jout, jdelta = jax.jit(jm.apply)(v, *args)
    port = carry(selective.SelectiveUpdateBlock(36, hid, n_gru_layers, head),
                 v, lambda t, p, k: weights._selective_update_block(
                     t, p, k, "convd", head))
    assert hasattr(port, "gru16") == (n_gru_layers == 3)
    assert hasattr(port, "gru08") == (n_gru_layers > 1)
    with torch.no_grad():
        pn, pout, pdelta = port(
            tuple(map(torch.from_numpy, nets)),
            (tuple(map(torch.from_numpy, inps)),
             tuple(map(torch.from_numpy, atts))),
            torch.from_numpy(corr), torch.from_numpy(disp))
    for a, bb in zip(pn, jn):
        close(a, bb, 1e-4)
    close(pout, jout, 1e-4)
    close(pdelta, jdelta, 1e-4)
    assert pout.shape == (b, h, w, 144 if head == "convex" else 32)
    assert pdelta.shape == (b, h, w, 1)


# ----------------------------------------------------------------- weights
def _train_heads(seed):
    """Variables of SelectiveIGEV's train-only heads as a JAX
    ``train=True`` init names them."""
    rng = np.random.RandomState(seed)
    shapes = {("spx_4", "Conv_0", "kernel"): (3, 3, 96, 24),
              ("spx_4b", "kernel"): (3, 3, 24, 24),
              ("spx_2", "BasicConvIN_0", "ConvTranspose_0", "kernel"):
                  (4, 4, 24, 32),
              ("spx_2", "BasicConvIN_1", "Conv_0", "kernel"): (3, 3, 64, 64),
              ("spx", "kernel"): (4, 4, 64, 9), ("spx", "bias"): (9,)}
    tree: dict = {}
    for path, shape in shapes.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = rng.randn(*shape).astype(np.float32)
    return tree


@pytest.mark.parametrize("name,heads", [(RAFT, None), (IGEV, "carried"),
                                        (IGEV, "filled")])
def test_state_dict_round_trips_through_jax_importer(variables, name, heads):
    v = dict(variables[name])
    if heads == "carried":
        v["params"] = {**v["params"], **_train_heads(10)}
    sd = from_jax_variables(name, v)
    if heads == "filled":
        assert all(not sd[k].any() and tuple(sd[k].shape) == shape
                   for k, shape in IGEV_TRAIN_HEADS.items())
    m = create_model(name, device="cpu")
    m.load_state_dict(sd)
    back = import_torch_checkpoint(
        name, {k: t.numpy() for k, t in m.state_dict().items()})
    want = dict(jax.tree_util.tree_flatten_with_path(v)[0])
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    heads_only = set(got) - set(want)
    assert (heads == "filled") == bool(heads_only)
    assert all(str(p[1].key).startswith("spx") for p in heads_only)
    assert set(want) <= set(got)
    for path, a in want.items():
        np.testing.assert_array_equal(got[path], a)


NAMED_KEYS = {
    RAFT: ("fnet.conv1.weight", "fnet.layer2.0.downsample.0.bias",
           "cnet.norm1.running_var", "cnet.outputs08.0.1.weight",
           "cnet.outputs32.1.bias", "cam.fc.0.weight", "cam.fc.2.weight",
           "sam.samconv.weight", "update_block.gru04.small_gru.convz.weight",
           "update_block.gru08.large_gru.convq.bias",
           "update_block.gru16.small_gru.convr.weight",
           "update_block.encoder.convf1.weight",
           "update_block.encoder.convf2.bias",
           "update_block.disp_head.conv1.weight",
           "update_block.mask.0.weight", "update_block.mask.2.bias"),
    IGEV: ("feature.conv_stem.weight", "stem_2.1.weight", "desc.bias",
           "corr_stem.bn.running_mean", "cost_agg.conv1_up.conv.weight",
           "classifier.weight", "cnet.outputs04.0.1.weight",
           "cnet.outputs16.1.bias", "cam.fc.0.weight", "cam.fc.2.weight",
           "sam.samconv.weight", "update_block.gru04.large_gru.convz.bias",
           "update_block.gru08.small_gru.convq.weight",
           "update_block.gru16.large_gru.convr.weight",
           "update_block.encoder.convd1.weight",
           "update_block.disp_head.conv2.bias",
           "update_block.mask_feat_4.0.weight", "spx_2_gru.conv2.bn.bias",
           "spx_gru.0.weight", "spx_4.0.conv.weight", "spx_2.conv1.conv.weight",
           "spx.0.bias"),
}
# what an original checkpoint holds that the port does not register: the
# doubly registered residual norms and SelectiveIGEV's BatchNorm beside its
# bn=False conv1_up
DEAD_KEYS = {RAFT: ("fnet.layer2.0.norm3.weight",),
             IGEV: ("cnet.layer2.0.norm3.running_mean",
                    "cost_agg.conv1_up.bn.weight",
                    "cost_agg.conv1_up.bn.running_var")}


@pytest.mark.parametrize("name", NAMES)
def test_port_state_dict_has_original_torch_names(name, tmp_path):
    """The original's names, one CAM and one SAM (not one a scale), no
    zqr convs; an original checkpoint loads strictly once its dead keys
    are dropped."""
    sd = create_model(name, device="cpu").state_dict()
    for k in NAMED_KEYS[name]:
        assert k in sd, k
    assert not any(k.startswith("context_zqr") for k in sd)
    assert sum(k.startswith(("cam.", "sam.")) for k in sd) == 3
    assert not any(".norm3." in k or "conv1_up.bn" in k for k in sd)
    path = tmp_path / "original.pth"
    torch.save({"state_dict": {
        **{f"module.{k}": v for k, v in sd.items()},
        **{f"module.{k}": torch.ones(8) for k in DEAD_KEYS[name]}}}, path)
    got = reference_state_dict(name, str(path))
    assert set(got) == set(sd)
    create_model(name, device="cpu").load_state_dict(got, strict=True)


# ------------------------------------------------------------- entry point
@pytest.mark.parametrize("name", NAMES)
def test_create_model_defaults_to_cuda_and_raises_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        create_model(name)


@pytest.mark.parametrize("name", NAMES)
def test_train_mode_is_not_implemented(name):
    m = create_model(name, device="cpu").train()
    x = torch.zeros(1, 32, 64, 3)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        m(x, x)


@pytest.mark.parametrize("name", NAMES)
def test_eval_entry_point_runs_the_model(name, tmp_path):
    """``python -m stereo_toolbox_tpu_torch.eval`` with this model on the
    CPU: SceneFlow's suite over one 40×56 frame (padded to 96×96)."""
    roots = write_eval_trees(str(tmp_path), frames=1,
                             sizes={"sceneflow": (40, 56)}, max_disp=32,
                             datasets=("sceneflow",))
    argv = ["--device", "cpu", "--model", name, "--suite", "sceneflow",
            "--root", roots["sceneflow"], "--lists", roots["lists"]]
    if name == IGEV:
        argv += ["--max-disp", "32"]
    got = port_eval.main(argv)
    assert got.shape == (4,) and np.isfinite(got).all()
