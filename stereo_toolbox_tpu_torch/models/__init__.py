"""Model registry of the PyTorch port (counterpart of
``stereo_toolbox_tpu.models``).

`create_model(name, device=None)` builds an eval-mode model on the card
(``device=None`` means ``"cuda"``) and raises when there is no card; the CPU
runs only when asked for with ``device="cpu"``.
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


def create_model(name: str, device=None, **kwargs) -> torch.nn.Module:
    """Build registry model `name` (keyword arguments go to its
    constructor, e.g. ``max_disp``, ``encoder`` and ``generator``), in
    eval mode, on `device`."""
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "run the plain PyTorch paths on the CPU")
    return MODEL_REGISTRY[name](**kwargs).eval().to(device)


__all__ = ["ACVNet", "CFNet", "DepthAnythingV2", "GwcNet", "GwcNet_G",
           "GwcNet_GC", "MODEL_REGISTRY", "create_model"]
