"""Model registry of the PyTorch port (counterpart of
``stereo_toolbox_tpu.models``).

`create_model(name, device=None, dtype=torch.float32)` builds an eval-mode
model on the card (``device=None`` means ``"cuda"``) and raises when there
is no card; the CPU runs only when asked for with ``device="cpu"``. A float32
forward computes in full float32 (no TF32), a bfloat16 model keeps its
BatchNorm values in float32 (`stereo_toolbox_tpu_torch.utils.precision`).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from stereo_toolbox_tpu_torch.models.acvnet import ACVNet
from stereo_toolbox_tpu_torch.models.cfnet import CFNet
from stereo_toolbox_tpu_torch.models.depth_anything_v2 import DepthAnythingV2
from stereo_toolbox_tpu_torch.models.gwcnet import (GwcNet, GwcNet_G,
                                                    GwcNet_GC)

MODEL_REGISTRY: dict[str, Callable[..., Any]] = {
    "ACVNet": ACVNet,
    "CFNet": CFNet,
    "DepthAnythingV2": DepthAnythingV2,
    "GwcNet_G": GwcNet_G,
    "GwcNet_GC": GwcNet_GC,
}

# Layers whose values a bfloat16 model keeps in float32. LayerNorm is not one:
# on the card F.layer_norm takes no float32 weight with a bfloat16 input
# (PyTorch 2.11, "expected scalar type BFloat16 but found Float").
NORMS = (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)


def create_model(name: str, device=None, dtype: torch.dtype = torch.float32,
                 **kwargs) -> torch.nn.Module:
    """Build registry model `name` (keyword arguments go to its
    constructor, e.g. ``max_disp``, ``encoder`` and ``generator``), in
    eval mode, on `device`, computing in `dtype`.

    ``dtype=torch.bfloat16`` is the JAX package's ``dtype=jnp.bfloat16``:
    every conv, linear and attention parameter in bfloat16 (and the
    LayerNorms'), every BatchNorm's values (`NORMS`: weight, bias, running
    statistics) kept in float32, as flax's ``param_dtype``.
    ``model.to(torch.bfloat16)`` rounds those too and is not that model."""
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"models compute in float32 or bfloat16, not {dtype}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "run the plain PyTorch paths on the CPU")
    model = MODEL_REGISTRY[name](**kwargs).eval()
    if dtype != torch.float32:
        for m in model.modules():
            if not isinstance(m, NORMS):
                m._apply(lambda t: t.to(dtype) if t.is_floating_point()
                         else t, recurse=False)
    return model.to(device)


__all__ = ["ACVNet", "CFNet", "DepthAnythingV2", "GwcNet", "GwcNet_G",
           "GwcNet_GC", "MODEL_REGISTRY", "NORMS", "create_model"]
