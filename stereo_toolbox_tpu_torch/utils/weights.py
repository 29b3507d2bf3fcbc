"""Carry weights from the JAX package's variables into the port.

`from_jax_variables(name, variables)` takes a JAX model's variables as numpy
nested dicts (``{"params": …, "batch_stats": …}``) and returns the port's
``state_dict``, keyed by the original toolbox's PyTorch names. It is the
inverse of the JAX package's checkpoint importer for the same model, kept here
as the port's own copy of the name map:

  * conv ``[k…, I, O]`` → ``[O, I, k…]``;
  * transposed conv: ``[k…, I, O]`` → ``[I, O, k…]``, spatial axes flipped
    (PyTorch's transposed conv correlates with the flipped kernel);
  * BatchNorm ``scale``/``bias``/``mean``/``var`` →
    ``weight``/``bias``/``running_mean``/``running_var``.
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

    def conv(self, path: str, key: str) -> None:
        k = self._take("params", f"{path}/kernel")
        rank = k.ndim - 2
        self.sd[f"{key}.weight"] = k.transpose((rank + 1, rank)
                                               + tuple(range(rank)))

    def conv_transpose(self, path: str, key: str) -> None:
        k = self._take("params", f"{path}/kernel")
        rank = k.ndim - 2
        w = k.transpose((rank, rank + 1) + tuple(range(rank)))
        self.sd[f"{key}.weight"] = w[(slice(None),) * 2
                                     + (slice(None, None, -1),) * rank]

    def bn(self, path: str, key: str) -> None:
        self.sd[f"{key}.weight"] = self._take("params", f"{path}/scale")
        self.sd[f"{key}.bias"] = self._take("params", f"{path}/bias")
        self.sd[f"{key}.running_mean"] = self._take("batch_stats",
                                                    f"{path}/mean")
        self.sd[f"{key}.running_var"] = self._take("batch_stats",
                                                   f"{path}/var")
        self.sd[f"{key}.num_batches_tracked"] = np.zeros((), np.int64)

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


def _gwcnet(t: JaxToTorch) -> None:
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
    for i, key in enumerate(("dres0.0", "dres0.2", "dres1.0", "dres1.2")):
        t.convbn(f"ConvBNAct_{i}", f"{key}.0", f"{key}.1")
    for i, dres in enumerate(("dres2", "dres3", "dres4")):
        hg = f"HourglassRedir_{i}"
        for j in range(4):
            t.convbn(f"{hg}/ConvBNAct_{j}", f"{dres}.conv{j + 1}.0.0",
                     f"{dres}.conv{j + 1}.0.1")
        for j, conv in enumerate(("conv5", "conv6")):
            t.conv_transpose(f"{hg}/ConvTransposeBN_{j}/ConvTranspose_0",
                             f"{dres}.{conv}.0")
            t.bn(f"{hg}/ConvTransposeBN_{j}/BatchNorm_0", f"{dres}.{conv}.1")
        t.convbn(f"{hg}/ConvBNAct_4", f"{dres}.redir2.0", f"{dres}.redir2.1")
        t.convbn(f"{hg}/ConvBNAct_5", f"{dres}.redir1.0", f"{dres}.redir1.1")
    for i in range(4):
        t.convbn(f"classif{i}_conv", f"classif{i}.0.0", f"classif{i}.0.1")
        t.conv(f"classif{i}_out", f"classif{i}.2")


CONVERTERS = {"GwcNet_G": _gwcnet}


def from_jax_variables(name: str, variables: dict) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for model `name` from the JAX model's
    variables (numpy nested dicts, initialised with every head, i.e. in
    train mode)."""
    if name not in CONVERTERS:
        raise KeyError(f"No converter for {name!r}; have {sorted(CONVERTERS)}")
    t = JaxToTorch(variables)
    CONVERTERS[name](t)
    return t.state_dict()
