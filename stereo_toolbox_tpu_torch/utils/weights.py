"""Carry weights from the JAX package's variables into the port.

`from_jax_variables(name, variables)` takes a JAX model's variables as numpy
nested dicts (``{"params": …, "batch_stats": …}``) and returns the port's
``state_dict``, keyed by the original toolbox's PyTorch names. It is the
inverse of the JAX package's checkpoint importer for the same model, kept here
as the port's own copy of the name map:

  * conv ``[k…, I, O]`` → ``[O, I, k…]``;
  * transposed conv: ``[k…, I, O]`` → ``[I, O, k…]``, spatial axes flipped
    (PyTorch's transposed conv correlates with the flipped kernel);
  * both with their bias where the layer has one;
  * Dense ``[I, O]`` → Linear ``[O, I]``; LayerNorm ``scale``/``bias`` →
    ``weight``/``bias``;
  * flax attention's query / key / value ``[dim, heads, hd]`` (+ bias
    ``[heads, hd]``) → one ``qkv`` Linear ``[3 · dim, dim]`` in q, k, v
    order, and its ``out [heads, hd, dim]`` → ``proj [dim, dim]``;
  * BatchNorm ``scale``/``bias``/``mean``/``var`` →
    ``weight``/``bias``/``running_mean``/``running_var``;
  * a bare parameter (CFNet's ``gamma_s3``, LayerScale) is copied as it is.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _leaves(tree: dict, prefix: str = "") -> set:
    out = set()
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out |= _leaves(v, path) if isinstance(v, Mapping) else {path}
    return out


class JaxToTorch:
    """Reads JAX variables by ``/``-joined path and writes PyTorch
    ``state_dict`` entries; `state_dict()` raises on any variable left
    unread."""

    def __init__(self, variables: dict):
        self.trees = {"params": variables["params"],
                      "batch_stats": variables.get("batch_stats", {})}
        self.sd: dict[str, np.ndarray] = {}
        self.used: set = set()

    def _find(self, collection: str, path: str):
        node = self.trees[collection]
        for part in path.split("/"):
            if not isinstance(node, Mapping) or part not in node:
                return None
            node = node[part]
        return node

    def _take(self, collection: str, path: str) -> np.ndarray:
        node = self._find(collection, path)
        if node is None:
            raise KeyError(f"JAX variables lack {collection}/{path}")
        self.used.add(f"{collection}/{path}")
        return np.asarray(node)

    def has(self, path: str) -> bool:
        return self._find("params", path) is not None

    def _bias(self, path: str, key: str) -> None:
        self.sd[f"{key}.bias"] = self._take("params", f"{path}/bias")

    def conv(self, path: str, key: str, bias: bool = False) -> None:
        k = self._take("params", f"{path}/kernel")
        rank = k.ndim - 2
        self.sd[f"{key}.weight"] = k.transpose((rank + 1, rank)
                                               + tuple(range(rank)))
        if bias:
            self._bias(path, key)

    def conv_transpose(self, path: str, key: str, bias: bool = False) -> None:
        k = self._take("params", f"{path}/kernel")
        rank = k.ndim - 2
        w = k.transpose((rank, rank + 1) + tuple(range(rank)))
        self.sd[f"{key}.weight"] = w[(slice(None),) * 2
                                     + (slice(None, None, -1),) * rank]
        if bias:
            self._bias(path, key)

    def dense(self, path: str, key: str) -> None:
        self.sd[f"{key}.weight"] = self._take("params", f"{path}/kernel").T
        self._bias(path, key)

    def layernorm(self, path: str, key: str) -> None:
        self.sd[f"{key}.weight"] = self._take("params", f"{path}/scale")
        self._bias(path, key)

    def attention(self, path: str, key: str) -> None:
        """A flax ``MultiHeadDotProductAttention`` → ``{key}.qkv`` and
        ``{key}.proj`` Linears."""
        ws, bs = [], []
        for name in ("query", "key", "value"):
            k = self._take("params", f"{path}/{name}/kernel")  # [dim, h, hd]
            ws.append(k.reshape(k.shape[0], -1).T)
            bs.append(self._take("params", f"{path}/{name}/bias").reshape(-1))
        self.sd[f"{key}.qkv.weight"] = np.concatenate(ws, axis=0)
        self.sd[f"{key}.qkv.bias"] = np.concatenate(bs, axis=0)
        out = self._take("params", f"{path}/out/kernel")     # [h, hd, dim]
        self.sd[f"{key}.proj.weight"] = out.reshape(-1, out.shape[-1]).T
        self._bias(f"{path}/out", f"{key}.proj")

    def bn(self, path: str, key: str) -> None:
        self.sd[f"{key}.weight"] = self._take("params", f"{path}/scale")
        self.sd[f"{key}.bias"] = self._take("params", f"{path}/bias")
        self.sd[f"{key}.running_mean"] = self._take("batch_stats",
                                                    f"{path}/mean")
        self.sd[f"{key}.running_var"] = self._take("batch_stats",
                                                   f"{path}/var")
        self.sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)

    def raw(self, path: str, key: str) -> None:
        self.sd[key] = self._take("params", path)

    def convbn(self, path: str, conv_key: str, bn_key: str) -> None:
        """A JAX ``ConvBNAct`` (``Conv_0`` + ``BatchNorm_0``)."""
        self.conv(f"{path}/Conv_0", conv_key)
        self.bn(f"{path}/BatchNorm_0", bn_key)

    def state_dict(self) -> dict[str, torch.Tensor]:
        left = sorted(set().union(*(
            {f"{c}/{p}" for p in _leaves(t)} for c, t in self.trees.items()))
            - self.used)
        if left:
            raise ValueError(f"{len(left)} JAX variables were not carried "
                             f"over, e.g. {left[:5]}")
        return {k: torch.from_numpy(np.array(v))
                for k, v in self.sd.items()}


def _hourglass(t: JaxToTorch, path: str, key: str) -> None:
    """A JAX ``HourglassRedir`` (GwcNet), ``HourglassMish`` (CFNet) or
    ``HourglassAttn`` (ACVNet, with its ``BlockAttention3D_0``) → the port's
    ``HourglassRedir``."""
    for j in range(4):
        t.convbn(f"{path}/ConvBNAct_{j}", f"{key}.conv{j + 1}.0.0",
                 f"{key}.conv{j + 1}.0.1")
    att = f"{path}/BlockAttention3D_0"
    if t.has(att):
        t.dense(f"{att}/qkv", f"{key}.attention_block.qkv_3d")
        t.conv(f"{att}/proj", f"{key}.attention_block.final1x1", bias=True)
    for j, conv in enumerate(("conv5", "conv6")):
        t.conv_transpose(f"{path}/ConvTransposeBN_{j}/ConvTranspose_0",
                         f"{key}.{conv}.0")
        t.bn(f"{path}/ConvTransposeBN_{j}/BatchNorm_0", f"{key}.{conv}.1")
    t.convbn(f"{path}/ConvBNAct_4", f"{key}.redir2.0", f"{key}.redir2.1")
    t.convbn(f"{path}/ConvBNAct_5", f"{key}.redir1.0", f"{key}.redir1.1")


def _res_block(t: JaxToTorch, path: str, key: str) -> None:
    """A JAX residual block (``BasicResBlock``, CFNet's ``CFBasicBlock``,
    PCWNet's ``_DilatedBlock``) → the port's ``BasicResBlock``, with its
    ``downsample`` where the JAX block has a third ConvBNAct."""
    t.convbn(f"{path}/ConvBNAct_0", f"{key}.conv1.0.0", f"{key}.conv1.0.1")
    t.convbn(f"{path}/ConvBNAct_1", f"{key}.conv2.0", f"{key}.conv2.1")
    if t.has(f"{path}/ConvBNAct_2"):
        t.convbn(f"{path}/ConvBNAct_2", f"{key}.downsample.0",
                 f"{key}.downsample.1")


def _res_trunk(t: JaxToTorch) -> None:
    """The residual trunk of GwcNet, ACVNet and PSMNet: ``firstconv`` and
    ``layer1..4``."""
    fe = "feature_extraction"
    for i in range(3):
        t.convbn(f"{fe}/ConvBNAct_{i}", f"{fe}.firstconv.{2 * i}.0",
                 f"{fe}.firstconv.{2 * i}.1")
    n = 0
    for layer, blocks in (("layer1", 3), ("layer2", 16), ("layer3", 3),
                          ("layer4", 3)):
        for blk in range(blocks):
            _res_block(t, f"{fe}/BasicResBlock_{n}", f"{fe}.{layer}.{blk}")
            n += 1


def _lastconv(t: JaxToTorch, convbn: str) -> None:
    """``lastconv``: the ConvBNAct `convbn` of the JAX feature extractor,
    then its bias-free 1×1 ``Conv_0``."""
    fe = "feature_extraction"
    t.convbn(f"{fe}/{convbn}", f"{fe}.lastconv.0.0", f"{fe}.lastconv.0.1")
    t.conv(f"{fe}/Conv_0", f"{fe}.lastconv.2")


def _gwc_trunk(t: JaxToTorch) -> None:
    """GwcNet's feature trunk (also ACVNet's), with GwcNet_GC's ``lastconv``
    where the variables have it."""
    _res_trunk(t)
    if t.has("feature_extraction/ConvBNAct_3"):
        _lastconv(t, "ConvBNAct_3")


def _gwcnet(t: JaxToTorch) -> None:
    _gwc_trunk(t)
    for i, key in enumerate(("dres0.0", "dres0.2", "dres1.0", "dres1.2")):
        t.convbn(f"ConvBNAct_{i}", f"{key}.0", f"{key}.1")
    for i, dres in enumerate(("dres2", "dres3", "dres4")):
        _hourglass(t, f"HourglassRedir_{i}", dres)
    for i in range(4):
        t.convbn(f"classif{i}_conv", f"classif{i}.0.0", f"classif{i}.0.1")
        t.conv(f"classif{i}_out", f"classif{i}.2")


def _psmnet(t: JaxToTorch) -> None:
    """Inverse of the JAX package's ``convert_psmnet``."""
    _res_trunk(t)
    for i in range(4):        # branch{i}.0 is the parameter-free pool
        t.convbn(f"feature_extraction/ConvBNAct_{3 + i}",
                 f"feature_extraction.branch{i + 1}.1.0",
                 f"feature_extraction.branch{i + 1}.1.1")
    _lastconv(t, "ConvBNAct_7")
    for i, key in enumerate(("dres0.0", "dres0.2", "dres1.0", "dres1.2")):
        t.convbn(f"ConvBNAct_{i}", f"{key}.0", f"{key}.1")
    for i, dres in enumerate(("dres2", "dres3", "dres4")):
        hg = f"Hourglass3D_{i}"
        for j, key in enumerate(("conv1.0", "conv2", "conv3.0", "conv4.0")):
            t.convbn(f"{hg}/ConvBNAct_{j}", f"{dres}.{key}.0",
                     f"{dres}.{key}.1")
        for j, conv in enumerate(("conv5", "conv6")):
            t.conv_transpose(f"{hg}/ConvTransposeBN_{j}/ConvTranspose_0",
                             f"{dres}.{conv}.0")
            t.bn(f"{hg}/ConvTransposeBN_{j}/BatchNorm_0", f"{dres}.{conv}.1")
    for i in (1, 2, 3):
        t.convbn(f"classif{i}_conv", f"classif{i}.0.0", f"classif{i}.0.1")
        t.conv(f"classif{i}_out", f"classif{i}.2")


def _acvnet(t: JaxToTorch) -> None:
    """Inverse of the JAX package's ``convert_acvnet``."""
    _gwc_trunk(t)
    for p in ("patch", "patch_l1", "patch_l2", "patch_l3"):
        t.conv(p, p)
    t.convbn("ConvBNAct_0", "dres1_att_.0.0", "dres1_att_.0.1")
    t.convbn("ConvBNAct_1", "dres1_att_.2.0", "dres1_att_.2.1")
    _hourglass(t, "HourglassAttn_0", "dres2_att_")
    t.convbn("ConvBNAct_2", "classif_att_.0.0", "classif_att_.0.1")
    t.conv("Conv_0", "classif_att_.2")
    t.convbn("concatconv_0", "concatconv.0.0", "concatconv.0.1")
    t.conv("concatconv_1", "concatconv.2")
    for i, key in enumerate(("dres0.0", "dres0.2", "dres1.0", "dres1.2"), 3):
        t.convbn(f"ConvBNAct_{i}", f"{key}.0", f"{key}.1")
    _hourglass(t, "HourglassAttn_1", "dres2")
    _hourglass(t, "HourglassAttn_2", "dres3")
    for i in range(3):
        t.convbn(f"classif{i}_conv", f"classif{i}.0.0", f"classif{i}.0.1")
        t.conv(f"classif{i}_out", f"classif{i}.2")


def _cfnet(t: JaxToTorch) -> None:
    fe = "feature_extraction"
    for i in range(3):
        t.convbn(f"{fe}/ConvBNAct_{i}", f"{fe}.firstconv.{2 * i}.0",
                 f"{fe}.firstconv.{2 * i}.1")
    for n, layer in enumerate(("layer2", "layer3", "layer4", "layer5",
                               "layer6")):
        _res_block(t, f"{fe}/CFBasicBlock_{n}", f"{fe}.{layer}.0")
    for i in range(4):
        k = f"{fe}.pyramid_pooling.path_module_list.{i}.cbr_unit"
        t.convbn(f"{fe}/PyramidPooling_0/path{i}", f"{k}.0", f"{k}.1")
    for up in ("upconv6", "upconv5", "upconv4", "upconv3"):
        t.convbn(f"{fe}/{up}", f"{fe}.{up}.1.0", f"{fe}.{up}.1.1")
    for ic in ("iconv5", "iconv4", "iconv3", "iconv2"):
        t.convbn(f"{fe}/{ic}", f"{fe}.{ic}.0.0", f"{fe}.{ic}.0.1")
    for head in ("gw2", "gw3", "gw4", "gw5", "gw6", "concat2", "concat3",
                 "concat4", "concat5", "concat6"):
        t.convbn(f"{fe}/{head}_0", f"{fe}.{head}.0.0", f"{fe}.{head}.0.1")
        t.conv(f"{fe}/{head}_1", f"{fe}.{head}.2")
    for path, k0, k1 in (
            ("dres4", "dres0", "dres1"), ("dres5", "dres0_5", "dres1_5"),
            ("dres6", "dres0_6", "dres1_6"),
            ("confidence_s3", "confidence0_s3", "confidence1_s3"),
            ("confidence_s2", "confidence0_s2", "confidence1_s2")):
        t.convbn(f"{path}_a", f"{k0}.0.0", f"{k0}.0.1")
        t.convbn(f"{path}_b", f"{k0}.2.0", f"{k0}.2.1")
        t.convbn(f"{path}_c", f"{k1}.0.0", f"{k1}.0.1")
        t.convbn(f"{path}_d", f"{k1}.2.0", f"{k1}.2.1")
    hu = "combine1"
    t.conv(f"{hu}/Conv_0", "combine1.conv1")
    t.convbn(f"{hu}/combine1", "combine1.combine1.0.0",
             "combine1.combine1.0.1")
    t.convbn(f"{hu}/ConvBNAct_0", "combine1.conv2.0.0", "combine1.conv2.0.1")
    t.conv(f"{hu}/Conv_1", "combine1.conv3")
    t.convbn(f"{hu}/combine2", "combine1.combine2.0.0",
             "combine1.combine2.0.1")
    t.convbn(f"{hu}/ConvBNAct_1", "combine1.conv4.0.0", "combine1.conv4.0.1")
    for j, conv in enumerate(("conv8", "conv9")):
        t.conv_transpose(f"{hu}/ConvTransposeBN_{j}/ConvTranspose_0",
                         f"combine1.{conv}.0")
        t.bn(f"{hu}/ConvTransposeBN_{j}/BatchNorm_0", f"combine1.{conv}.1")
    t.convbn(f"{hu}/ConvBNAct_2", "combine1.redir2.0", "combine1.redir2.1")
    t.convbn(f"{hu}/ConvBNAct_3", "combine1.redir1.0", "combine1.redir1.1")
    for hg in ("dres3", "confidence2_s3", "confidence3_s3", "confidence2_s2",
               "confidence3_s2"):
        _hourglass(t, hg, hg)
    for cl in ("classif0", "classif1", "classif2", "confidence_classif0_s3",
               "confidence_classif1_s3", "confidence_classifmid_s3",
               "confidence_classif0_s2", "confidence_classif1_s2",
               "confidence_classifmid_s2"):
        t.convbn(f"{cl}_conv", f"{cl}.0.0", f"{cl}.0.1")
        t.conv(f"{cl}_out", f"{cl}.2")
    for p in ("gamma_s3", "beta_s3", "gamma_s2", "beta_s2"):
        t.raw(p, p)


def _hourglass_up3(t: JaxToTorch, path: str, key: str) -> None:
    """PCWNet's JAX ``HourglassUp3`` → the port's: the stride-2 ``Conv_i``
    → ``conv1/3/5``, ``combine1..3``, ``ConvBNAct_0..2`` → ``conv2/4/6``,
    ``ConvTransposeBN_0..2`` → ``conv7..9`` and ``ConvBNAct_3..5`` →
    ``redir3..1``."""
    for i, (down, comb, conv) in enumerate((("conv1", "combine1", "conv2"),
                                            ("conv3", "combine2", "conv4"),
                                            ("conv5", "combine3", "conv6"))):
        t.conv(f"{path}/Conv_{i}", f"{key}.{down}")
        t.convbn(f"{path}/{comb}", f"{key}.{comb}.0.0", f"{key}.{comb}.0.1")
        t.convbn(f"{path}/ConvBNAct_{i}", f"{key}.{conv}.0.0",
                 f"{key}.{conv}.0.1")
    for i, (up, redir) in enumerate((("conv7", "redir3"), ("conv8", "redir2"),
                                     ("conv9", "redir1"))):
        t.conv_transpose(f"{path}/ConvTransposeBN_{i}/ConvTranspose_0",
                         f"{key}.{up}.0")
        t.bn(f"{path}/ConvTransposeBN_{i}/BatchNorm_0", f"{key}.{up}.1")
        t.convbn(f"{path}/ConvBNAct_{i + 3}", f"{key}.{redir}.0",
                 f"{key}.{redir}.1")


def _pcwnet(t: JaxToTorch) -> None:
    """Inverse of the JAX package's ``convert_pcwnet`` (either variant)."""
    fe = "feature_extraction"
    for i in range(3):
        t.convbn(f"{fe}/ConvBNAct_{i}", f"{fe}.firstconv.{2 * i}.0",
                 f"{fe}.firstconv.{2 * i}.1")
    n = 0
    for layer, blocks in (("layer1", 3), ("layer2", 16), ("layer3", 3),
                          ("layer5", 3), ("layer7", 3), ("layer9", 3)):
        for blk in range(blocks):
            _res_block(t, f"{fe}/CFBasicBlock_{n}", f"{fe}.{layer}.{blk}")
            n += 1
    for blk in range(3):
        _res_block(t, f"{fe}/_DilatedBlock_{blk}", f"{fe}.layer4.{blk}")
    # the concat heads in both variants: JAX's PCWFeature builds them
    for path, key in (("gw1", "layer11"), ("gw2", "gw2"), ("gw3", "gw3"),
                      ("gw4", "gw4"), ("concat1", "lastconv"),
                      ("concat2", "concat2"), ("concat3", "concat3"),
                      ("concat4", "concat4")):
        t.convbn(f"{fe}/{path}_0", f"{fe}.{key}.0.0", f"{fe}.{key}.0.1")
        t.conv(f"{fe}/{path}_1", f"{fe}.{key}.2")
    for i in range(2):
        t.convbn(f"{fe}/refine_{i}", f"{fe}.layer_refine.{2 * i}.0",
                 f"{fe}.layer_refine.{2 * i}.1")
    for i, key in enumerate(("dres0.0", "dres0.2", "dres1.0", "dres1.2")):
        t.convbn(f"ConvBNAct_{i}", f"{key}.0", f"{key}.1")
    _hourglass_up3(t, "combine1", "combine1")
    for i, dres in enumerate(("dres2", "dres3", "dres4")):
        _hourglass(t, f"HourglassMish_{i}", dres)
    for i in range(5):
        t.convbn(f"classif{i}_conv", f"classif{i}.0.0", f"classif{i}.0.1")
        t.conv(f"classif{i}_out", f"classif{i}.2")
    t.convbn("dispupsample", "dispupsample.0.0", "dispupsample.0.1")
    rf = "refinenet3"
    for i in range(4):
        t.convbn(f"{rf}/ConvBNAct_{i}", f"{rf}.conv{i + 1}.0.0",
                 f"{rf}.conv{i + 1}.0.1")
    for i in range(3):
        _res_block(t, f"{rf}/_DilatedBlock_{i}", f"{rf}.conv{i + 5}.0")
    t.conv(f"{rf}/Conv_0", f"{rf}.conv8")


def _numbered(tree: dict, prefix: str) -> list[int]:
    """Sorted i of the keys ``{prefix}{i}`` of `tree`."""
    return sorted(int(k[len(prefix):]) for k in tree
                  if k.startswith(prefix) and k[len(prefix):].isdigit())


def _dinov2(t: JaxToTorch, p: str, k: str) -> None:
    """The JAX DINOv2 at path `p` → the port's at key `k`. The JAX trunk
    has one LayerNorm per tap where the original has one ``norm`` applied
    at every tap: carried only if all tap norms are equal."""
    tree = t._find("params", p)
    t.conv(f"{p}/patch_embed", f"{k}.patch_embed.proj", bias=True)
    t.raw(f"{p}/cls_token", f"{k}.cls_token")
    t.raw(f"{p}/pos_embed", f"{k}.pos_embed")
    for i in _numbered(tree, "block"):
        f, b = f"{p}/block{i}", f"{k}.blocks.{i}"
        t.layernorm(f"{f}/LayerNorm_0", f"{b}.norm1")
        t.attention(f"{f}/MultiHeadDotProductAttention_0", f"{b}.attn")
        t.raw(f"{f}/ls1", f"{b}.ls1.gamma")
        t.layernorm(f"{f}/LayerNorm_1", f"{b}.norm2")
        t.dense(f"{f}/Dense_0", f"{b}.mlp.fc1")
        t.dense(f"{f}/Dense_1", f"{b}.mlp.fc2")
        t.raw(f"{f}/ls2", f"{b}.ls2.gamma")
    norms = [(t._take("params", f"{p}/tapnorm{i}/scale"),
              t._take("params", f"{p}/tapnorm{i}/bias"))
             for i in _numbered(tree, "tapnorm")]
    if not norms or not all(np.array_equal(s, norms[0][0])
                            and np.array_equal(b, norms[0][1])
                            for s, b in norms):
        raise ValueError("the JAX tap norms differ (or are missing): the "
                         "original has one norm applied at every tap")
    t.sd[f"{k}.norm.weight"], t.sd[f"{k}.norm.bias"] = norms[0]


def _dpt_head(t: JaxToTorch, h: str, k: str, with_output: bool = True
              ) -> None:
    """A JAX ``DPTHead`` (or DEFOM's ``DEFOMHead``) at path `h` → the
    port's at key `k`; the feature head has no output convs."""
    for i in range(4):
        t.conv(f"{h}/project{i}", f"{k}.projects.{i}", bias=True)
        if i in (0, 1):
            t.conv_transpose(f"{h}/resize{i}", f"{k}.resize_layers.{i}",
                             bias=True)
        elif i == 3:
            t.conv(f"{h}/resize{i}", f"{k}.resize_layers.{i}", bias=True)
        t.conv(f"{h}/layer{i + 1}_rn", f"{k}.scratch.layer{i + 1}_rn")
    for i in (1, 2, 3, 4):
        f, r = f"{h}/refine{i}", f"{k}.scratch.refinenet{i}"
        units = ("resConfUnit2",) if i == 4 else ("resConfUnit1",
                                                   "resConfUnit2")
        for j, unit in enumerate(units):
            for c in (0, 1):
                t.conv(f"{f}/ResidualConvUnit_{j}/Conv_{c}",
                       f"{r}.{unit}.conv{c + 1}", bias=True)
        t.conv(f"{f}/Conv_0", f"{r}.out_conv", bias=True)
    if with_output:
        t.conv(f"{h}/output_conv1", f"{k}.scratch.output_conv1", bias=True)
        t.conv(f"{h}/output_conv2a", f"{k}.scratch.output_conv2.0",
               bias=True)
        t.conv(f"{h}/output_conv2b", f"{k}.scratch.output_conv2.2",
               bias=True)


def _depth_anything_v2(t: JaxToTorch) -> None:
    """Inverse of the JAX package's ``convert_depth_anything_v2``."""
    _dinov2(t, "pretrained", "pretrained")
    _dpt_head(t, "depth_head", "depth_head")


def _raft_res(t: JaxToTorch, path: str, key: str, norm: str) -> None:
    """A JAX ``RAFTResBlock`` → the port's: ``Conv_0/1`` → ``conv1/2``,
    ``Conv_2`` → ``downsample.0`` where it has one; with batch norm
    ``BatchNorm_0/1/2`` → ``norm1``, ``norm2``, ``downsample.1``."""
    t.conv(f"{path}/Conv_0", f"{key}.conv1", bias=True)
    t.conv(f"{path}/Conv_1", f"{key}.conv2", bias=True)
    if norm == "batch":
        t.bn(f"{path}/BatchNorm_0", f"{key}.norm1")
        t.bn(f"{path}/BatchNorm_1", f"{key}.norm2")
    if t.has(f"{path}/Conv_2"):
        t.conv(f"{path}/Conv_2", f"{key}.downsample.0", bias=True)
        if norm == "batch":
            t.bn(f"{path}/BatchNorm_2", f"{key}.downsample.1")


def _update_block(t: JaxToTorch, path: str, key: str, flow: str = "convd",
                  head: str = "disp_head") -> None:
    """A JAX ``BasicMultiUpdateBlock`` (DEFOM's, one flow channel; RAFT's,
    two, with ``flow="convf"`` and ``head="flow_head"``), with the GRUs its
    `n_gru_layers` creates."""
    for g in ("gru08", "gru16", "gru32"):
        if t.has(f"{path}/{g}"):
            for c in ("convz", "convr", "convq"):
                t.conv(f"{path}/{g}/{c}", f"{key}.{g}.{c}", bias=True)
    _motion_encoder(t, path, key, flow)
    t.conv(f"{path}/flow_head_1", f"{key}.{head}.conv1", bias=True)
    t.conv(f"{path}/flow_head_2", f"{key}.{head}.conv2", bias=True)
    t.conv(f"{path}/mask_1", f"{key}.mask.0", bias=True)
    t.conv(f"{path}/mask_2", f"{key}.mask.2", bias=True)


def _motion_encoder(t: JaxToTorch, path: str, key: str, flow: str) -> None:
    """An update block's motion encoder (``encoder/Conv_0..4``), its flow
    or disparity convs named `flow` (``convf``, ``convd``)."""
    for i, name in enumerate(("convc1", "convc2", f"{flow}1", f"{flow}2",
                              "conv")):
        t.conv(f"{path}/encoder/Conv_{i}", f"{key}.encoder.{name}",
               bias=True)


def _raft_trunk(t: JaxToTorch, path: str, key: str, norm: str) -> None:
    """The stem (``Conv_0`` and, for batch norm, ``BatchNorm_0``) and the
    three residual stages (``RAFTResBlock_0..5``) of a JAX ``BasicEncoder``
    or ``MultiBasicEncoder``."""
    t.conv(f"{path}/Conv_0", f"{key}.conv1", bias=True)
    if norm == "batch":
        t.bn(f"{path}/BatchNorm_0", f"{key}.norm1")
    for n, stage in enumerate(f"layer{i}.{j}" for i in (1, 2, 3)
                              for j in (0, 1)):
        _raft_res(t, f"{path}/RAFTResBlock_{n}", f"{key}.{stage}", norm)


def _multi_basic_encoder(t: JaxToTorch, path: str, key: str,
                         out_names=("outputs08", "outputs16", "outputs32")
                         ) -> None:
    """A JAX ``MultiBasicEncoder`` (batch norm) → the port's: the trunk,
    ``RAFTResBlock_6..13`` (the two finer heads' blocks around ``layer4``
    and ``layer5``) and ``Conv_1..6`` (the heads' convs, hidden then
    context at each scale)."""
    _raft_trunk(t, path, key, "batch")
    fine, mid, coarse = out_names
    blocks = [f"{fine}.0.0", f"{fine}.1.0", "layer4.0", "layer4.1",
              f"{mid}.0.0", f"{mid}.1.0", "layer5.0", "layer5.1"]
    for n, name in enumerate(blocks, 6):
        _raft_res(t, f"{path}/RAFTResBlock_{n}", f"{key}.{name}", "batch")
    convs = [f"{fine}.0.1", f"{fine}.1.1", f"{mid}.0.1", f"{mid}.1.1",
             f"{coarse}.0", f"{coarse}.1"]
    for n, name in enumerate(convs, 1):
        t.conv(f"{path}/Conv_{n}", f"{key}.{name}", bias=True)


def _raft_encoders(t: JaxToTorch) -> None:
    """RAFT's ``fnet`` (instance norm) and ``cnet``."""
    _raft_trunk(t, "fnet", "fnet", "instance")
    t.conv("fnet/Conv_1", "fnet.conv2", bias=True)
    _multi_basic_encoder(t, "cnet", "cnet")


def _raft_stereo(t: JaxToTorch) -> None:
    """Inverse of the JAX package's ``convert_raft_stereo``."""
    _raft_encoders(t)
    for i in range(3):
        t.conv(f"context_zqr_{i}", f"context_zqr_convs.{i}", bias=True)
    _update_block(t, "step/update_block", "update_block", flow="convf",
                  head="flow_head")


def _defom(t: JaxToTorch) -> None:
    """Inverse of the JAX package's ``convert_defom`` (either encoder)."""
    da = "defomencoder.depth_anything"
    _dinov2(t, "defomencoder/pretrained", f"{da}.pretrained")
    _dpt_head(t, "defomencoder/depth_head", f"{da}.depth_head")
    _dpt_head(t, "defomencoder/depth_feat", f"{da}.depth_feat",
              with_output=False)
    stages = [f"layer{i}.{j}" for i in (1, 2, 3) for j in (0, 1)]
    for net, norm in (("fnet", "instance"), ("cnet", "batch")):
        t.conv(f"{net}/conv1", f"{net}.conv1", bias=True)
        for n, key in enumerate(stages):
            _raft_res(t, f"{net}/RAFTResBlock_{n}", f"{net}.{key}", norm)
    t.conv("fnet/convd/conv", "fnet.convd.conv", bias=True)
    t.conv("fnet/conv2", "fnet.conv2", bias=True)
    t.bn("cnet/norm1", "cnet.norm1")
    for n, key in enumerate(("layer4.0", "layer4.1", "layer5.0",
                             "layer5.1"), 6):
        _raft_res(t, f"cnet/RAFTResBlock_{n}", f"cnet.{key}", "batch")
    for s in ("08", "16", "32"):
        t.conv(f"cnet/conv{s}/conv", f"cnet.conv{s}.conv", bias=True)
        t.bn(f"cnet/conv{s}/norm1", f"cnet.conv{s}.norm1")
    for j in range(2):
        for s in ("08", "16"):
            _raft_res(t, f"cnet/res{s}_{j}", f"cnet.outputs{s}.{j}.0",
                      "batch")
            t.conv(f"cnet/out{s}_{j}", f"cnet.outputs{s}.{j}.1", bias=True)
        t.conv(f"cnet/out32_{j}", f"cnet.outputs32.{j}", bias=True)
    for i in range(3):
        t.conv(f"context_zqr_{i}", f"context_zqr_convs.{i}", bias=True)
    _update_block(t, "refine_phase/update_block", "update_block")
    _update_block(t, "scale_phase/scale_update_block", "scale_update_block")


def _conv2x(t: JaxToTorch, path: str, key: str, instance_norm: bool
            ) -> None:
    """A JAX ``Conv2x`` (transposed ``conv1``, then ``conv2``) → the
    port's, with their BatchNorms unless `instance_norm`."""
    unit = "BasicConvIN" if instance_norm else "BasicConvBN"
    t.conv_transpose(f"{path}/{unit}_0/ConvTranspose_0", f"{key}.conv1.conv")
    t.conv(f"{path}/{unit}_1/Conv_0", f"{key}.conv2.conv")
    if not instance_norm:
        t.bn(f"{path}/{unit}_0/BatchNorm_0", f"{key}.conv1.bn")
        t.bn(f"{path}/{unit}_1/BatchNorm_0", f"{key}.conv2.bn")


def _feature_att(t: JaxToTorch, path: str, key: str) -> None:
    """A JAX ``FeatureAtt`` → the port's ``feat_att.{0,1}``."""
    t.conv(f"{path}/ConvBNAct_0/Conv_0", f"{key}.feat_att.0.conv")
    t.bn(f"{path}/ConvBNAct_0/BatchNorm_0", f"{key}.feat_att.0.bn")
    t.conv(f"{path}/Conv_0", f"{key}.feat_att.1", bias=True)


def _mobilenet_trunk(t: JaxToTorch, path: str, key: str) -> None:
    """The JAX ``MobileNetV2Trunk`` → the port's (timm's names):
    ``InvertedResidual_n`` → ``block{b}.{s}.{j}``."""
    # here, not at the top: ops and nn import utils, which imports this
    from stereo_toolbox_tpu_torch.nn.igev_blocks import (MOBILENET_BLOCKS,
                                                         MOBILENET_STAGES)
    t.conv(f"{path}/Conv_0", f"{key}.conv_stem")
    t.bn(f"{path}/BatchNorm_0", f"{key}.bn1")
    n = 0
    for blk, stages in enumerate(MOBILENET_BLOCKS):
        for s, stage in enumerate(stages):
            for j, (_, _, expand) in enumerate(MOBILENET_STAGES[stage]):
                f = f"{path}/InvertedResidual_{n}"
                k = f"{key}.block{blk}.{s}.{j}"
                names = ((("conv_dw", "bn1"), ("conv_pw", "bn2"))
                         if expand == 1 else
                         (("conv_pw", "bn1"), ("conv_dw", "bn2"),
                          ("conv_pwl", "bn3")))
                for i, (conv, bn) in enumerate(names):
                    t.conv(f"{f}/Conv_{i}", f"{k}.{conv}")
                    t.bn(f"{f}/BatchNorm_{i}", f"{k}.{bn}")
                n += 1


def _gev_hourglass(t: JaxToTorch, path: str, key: str) -> None:
    """A JAX ``GEVHourglass`` (``BasicConvBN_0..14`` in call order, the
    transposed ones at 6, 10 and 14; ``FeatureAtt_0..4``) → the port's."""
    for i, name in enumerate(("conv1.0", "conv1.1", "conv2.0", "conv2.1",
                              "conv3.0", "conv3.1", "conv3_up", "agg_0.0",
                              "agg_0.1", "agg_0.2", "conv2_up", "agg_1.0",
                              "agg_1.1", "agg_1.2", "conv1_up")):
        f = f"{path}/BasicConvBN_{i}"
        if name.endswith("_up"):
            t.conv_transpose(f"{f}/ConvTranspose_0", f"{key}.{name}.conv")
        else:
            t.conv(f"{f}/Conv_0", f"{key}.{name}.conv")
        if name != "conv1_up":
            t.bn(f"{f}/BatchNorm_0", f"{key}.{name}.bn")
    for i, att in enumerate(("feature_att_8", "feature_att_16",
                             "feature_att_32", "feature_att_up_16",
                             "feature_att_up_8")):
        _feature_att(t, f"{path}/FeatureAtt_{i}", f"{key}.{att}")


def _igev_feature(t: JaxToTorch, path: str, key: str) -> None:
    """A JAX ``IGEVFeature`` → the port's (one flat scope, as the
    original's ``Feature``)."""
    _mobilenet_trunk(t, f"{path}/trunk", key)
    for name in ("deconv32_16", "deconv16_8", "deconv8_4"):
        _conv2x(t, f"{path}/{name}", f"{key}.{name}", True)
    t.conv(f"{path}/conv4/Conv_0", f"{key}.conv4.conv")


def _igev_update_block(t: JaxToTorch, path: str, key: str) -> None:
    """A JAX ``IGEVUpdateBlock``, with the GRUs its `n_gru_layers`
    creates."""
    for g in ("gru04", "gru08", "gru16"):
        if t.has(f"{path}/{g}"):
            for c in ("convz", "convr", "convq"):
                t.conv(f"{path}/{g}/{c}", f"{key}.{g}.{c}", bias=True)
    _motion_encoder(t, path, key, "convd")
    t.conv(f"{path}/disp_head_1", f"{key}.disp_head.conv1", bias=True)
    t.conv(f"{path}/disp_head_2", f"{key}.disp_head.conv2", bias=True)
    t.conv(f"{path}/mask_feat_4", f"{key}.mask_feat_4.0", bias=True)


# The train-only heads of IGEVStereo (the initial disparity's upsampler) and
# their shapes, which a JAX init in eval mode does not create
IGEV_TRAIN_HEADS = {"spx_4.0.conv.weight": (24, 96, 3, 3),
                    "spx_4.1.weight": (24, 24, 3, 3),
                    "spx_2.conv1.conv.weight": (24, 32, 4, 4),
                    "spx_2.conv2.conv.weight": (64, 64, 3, 3),
                    "spx.0.weight": (64, 9, 4, 4), "spx.0.bias": (9,)}


def _igev_stereo(t: JaxToTorch) -> None:
    """Inverse of the JAX package's ``convert_igev_stereo``."""
    _igev_geometry(t)
    for i in range(3):
        t.conv(f"context_zqr_{i}", f"context_zqr_convs.{i}", bias=True)
    _igev_update_block(t, "step/update_block", "update_block")
    _igev_upsamplers(t)


def _igev_geometry(t: JaxToTorch) -> None:
    """The IGEV family's features, stems, descriptors, volume stem and
    attention, GEV hourglass, classifier and context network."""
    _igev_feature(t, "feature", "feature")
    for stem in ("stem_2", "stem_4"):
        t.conv(f"{stem}a/Conv_0", f"{stem}.0.conv")
        t.conv(f"{stem}b", f"{stem}.1")
    t.conv("conv/Conv_0", "conv.conv")
    t.conv("desc", "desc", bias=True)
    t.conv("corr_stem/Conv_0", "corr_stem.conv")
    t.bn("corr_stem/BatchNorm_0", "corr_stem.bn")
    _feature_att(t, "corr_feature_att", "corr_feature_att")
    _gev_hourglass(t, "cost_agg", "cost_agg")
    t.conv("classifier", "classifier")
    _multi_basic_encoder(t, "cnet", "cnet",
                         ("outputs04", "outputs08", "outputs16"))


def _igev_upsamplers(t: JaxToTorch) -> None:
    """The IGEV family's superpixel upsamplers: the loop's ``spx_2_gru`` and
    ``spx_gru``, and the train-only heads ``spx_4``, ``spx_2`` and ``spx``,
    carried from variables that have them (a JAX init with ``train=True``);
    variables of an eval-mode init lack them, and they are then filled with
    zeros (`IGEV_TRAIN_HEADS`), which the eval forward never reads: its
    output is the JAX model's."""
    _conv2x(t, "step/spx_2_gru", "spx_2_gru", False)
    t.conv_transpose("step/spx_gru", "spx_gru.0", bias=True)
    if t.has("spx_4"):
        t.conv("spx_4/Conv_0", "spx_4.0.conv")
        t.conv("spx_4b", "spx_4.1")
        _conv2x(t, "spx_2", "spx_2", True)
        t.conv_transpose("spx", "spx.0", bias=True)
    else:
        t.sd.update({k: np.zeros(shape, np.float32)
                     for k, shape in IGEV_TRAIN_HEADS.items()})


def _selective_update_block(t: JaxToTorch, path: str, key: str,
                            flow: str = "convd", head: str = "superpixel"
                            ) -> None:
    """A JAX ``SelectiveUpdateBlock``, with the GRUs its `n_gru_layers`
    creates (each a 1×1 ``small_gru`` and a 3×3 ``large_gru``), the motion
    encoder's disparity convs named `flow`, and `head`'s output convs."""
    for g in ("gru04", "gru08", "gru16"):
        if t.has(f"{path}/{g}"):
            for sub in ("small_gru", "large_gru"):
                for c in ("convz", "convr", "convq"):
                    t.conv(f"{path}/{g}/{sub}/{c}", f"{key}.{g}.{sub}.{c}",
                           bias=True)
    _motion_encoder(t, path, key, flow)
    t.conv(f"{path}/disp_head_1", f"{key}.disp_head.conv1", bias=True)
    t.conv(f"{path}/disp_head_2", f"{key}.disp_head.conv2", bias=True)
    if head == "convex":
        t.conv(f"{path}/mask_1", f"{key}.mask.0", bias=True)
        t.conv(f"{path}/mask_2", f"{key}.mask.2", bias=True)
    else:
        t.conv(f"{path}/mask_feat_4", f"{key}.mask_feat_4.0", bias=True)


def _cam_sam(t: JaxToTorch) -> None:
    """The shared CAM (``fc1``, ``fc2`` → ``fc.0``, ``fc.2``) and SAM
    (``Conv_0`` → ``samconv``), bias-free."""
    t.conv("cam/fc1", "cam.fc.0")
    t.conv("cam/fc2", "cam.fc.2")
    t.conv("sam/Conv_0", "sam.samconv")


def _selective_raft(t: JaxToTorch) -> None:
    """Inverse of the JAX package's ``convert_selective_raft``."""
    _raft_encoders(t)
    _cam_sam(t)
    _selective_update_block(t, "step/update_block", "update_block",
                            flow="convf", head="convex")


def _selective_igev(t: JaxToTorch) -> None:
    """Inverse of the JAX package's ``convert_selective_igev``; the
    train-only heads as `_igev_upsamplers` carries them."""
    _igev_geometry(t)
    _cam_sam(t)
    _selective_update_block(t, "step/update_block", "update_block")
    _igev_upsamplers(t)


CONVERTERS = {"ACVNet": _acvnet, "CFNet": _cfnet,
              "DEFOMStereo_L": _defom, "DEFOMStereo_S": _defom,
              "DepthAnythingV2": _depth_anything_v2, "GwcNet_G": _gwcnet,
              "GwcNet_GC": _gwcnet, "IGEVStereo": _igev_stereo,
              "PCWNet_G": _pcwnet,
              "PCWNet_GC": _pcwnet, "PSMNet": _psmnet,
              "RAFTStereo": _raft_stereo, "SelectiveIGEV": _selective_igev,
              "SelectiveRAFT": _selective_raft}


def from_jax_variables(name: str, variables: dict) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for model `name` from the JAX model's
    variables (numpy nested dicts, initialised with every head, i.e. in
    train mode)."""
    if name not in CONVERTERS:
        raise KeyError(f"No converter for {name!r}; have {sorted(CONVERTERS)}")
    t = JaxToTorch(variables)
    CONVERTERS[name](t)
    return t.state_dict()


# Keys of the original toolbox's checkpoints that its forward never uses and
# the port does not register (the JAX importer's ``expect_unused``,
# utils/torch_import.py:444-447, :992-997; RAFT's residual blocks register
# their downsample norm twice, as ``norm3`` and ``downsample.1``, :700)
UNUSED_REFERENCE_KEYS = {
    **{name: (".norm3.",) for name in ("IGEVStereo", "RAFTStereo",
                                       "SelectiveRAFT")},
    # SelectiveIGEV's BasicConv registers a BatchNorm beside a bn=False conv
    # (``convert_selective_igev``, utils/torch_import.py:920-924)
    "SelectiveIGEV": (".norm3.", "cost_agg.conv1_up.bn."),
    "CFNet": ("combine1.combine3.", "combine1.redir3."),
    "DepthAnythingV2": ("refinenet4.resConfUnit1.", "pretrained.mask_token"),
    # convert_defom's (:1324-1327): the doubly registered downsample norms,
    # ConvBlock's unused norm2/norm3 and DAv2's artifacts
    **{name: (".norm3.", "convd.norm2", "conv08.norm2", "conv16.norm2",
              "conv32.norm2", "refinenet4.resConfUnit1.", "mask_token")
       for name in ("DEFOMStereo_S", "DEFOMStereo_L")},
}
# Whole keys dropped likewise: DEFOM's ImageNet ``mean``/``std`` buffers
# (utils/torch_import.py:1217)
UNUSED_REFERENCE_NAMES = {name: ("mean", "std")
                          for name in ("DEFOMStereo_S", "DEFOMStereo_L")}


def reference_state_dict(name: str, path: str) -> dict[str, torch.Tensor]:
    """The original toolbox's checkpoint of model `name` at `path` as the
    port's ``state_dict``, for ``load_state_dict(strict=True)``: the port
    keeps the original's names, so the tensors are taken as they are. As
    the JAX importer does, a ``{"model" | "state_dict" |
    "model_state_dict": ...}`` nesting is unwrapped and DDP's ``module.``
    prefixes are stripped; the keys `UNUSED_REFERENCE_KEYS` names are
    dropped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model", "state_dict", "model_state_dict"):
        if isinstance(obj, Mapping) and isinstance(obj.get(key), Mapping):
            obj = obj[key]
            break
    unused = UNUSED_REFERENCE_KEYS.get(name, ())
    names = UNUSED_REFERENCE_NAMES.get(name, ())
    obj = {k.removeprefix("module."): v for k, v in obj.items()}
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)
            and k not in names and not any(u in k for u in unused)}
