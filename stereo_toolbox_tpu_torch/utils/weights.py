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
            f, k = f"{fe}/BasicResBlock_{n}", f"{fe}.{layer}.{blk}"
            t.convbn(f"{f}/ConvBNAct_0", f"{k}.conv1.0.0", f"{k}.conv1.0.1")
            t.convbn(f"{f}/ConvBNAct_1", f"{k}.conv2.0", f"{k}.conv2.1")
            if t.has(f"{f}/ConvBNAct_2"):
                t.convbn(f"{f}/ConvBNAct_2", f"{k}.downsample.0",
                         f"{k}.downsample.1")
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
        f, k = f"{fe}/CFBasicBlock_{n}", f"{fe}.{layer}.0"
        t.convbn(f"{f}/ConvBNAct_0", f"{k}.conv1.0.0", f"{k}.conv1.0.1")
        t.convbn(f"{f}/ConvBNAct_1", f"{k}.conv2.0", f"{k}.conv2.1")
        t.convbn(f"{f}/ConvBNAct_2", f"{k}.downsample.0", f"{k}.downsample.1")
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


def _update_block(t: JaxToTorch, path: str, key: str) -> None:
    """A JAX ``BasicMultiUpdateBlock`` (DEFOM's, one flow channel)."""
    for g in ("gru08", "gru16", "gru32"):
        for c in ("convz", "convr", "convq"):
            t.conv(f"{path}/{g}/{c}", f"{key}.{g}.{c}", bias=True)
    for i, name in enumerate(("convc1", "convc2", "convd1", "convd2",
                              "conv")):
        t.conv(f"{path}/encoder/Conv_{i}", f"{key}.encoder.{name}",
               bias=True)
    t.conv(f"{path}/flow_head_1", f"{key}.disp_head.conv1", bias=True)
    t.conv(f"{path}/flow_head_2", f"{key}.disp_head.conv2", bias=True)
    t.conv(f"{path}/mask_1", f"{key}.mask.0", bias=True)
    t.conv(f"{path}/mask_2", f"{key}.mask.2", bias=True)


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


CONVERTERS = {"ACVNet": _acvnet, "CFNet": _cfnet,
              "DEFOMStereo_L": _defom, "DEFOMStereo_S": _defom,
              "DepthAnythingV2": _depth_anything_v2, "GwcNet_G": _gwcnet,
              "GwcNet_GC": _gwcnet, "PSMNet": _psmnet}


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
# utils/torch_import.py:444-447, :992-997)
UNUSED_REFERENCE_KEYS = {
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
