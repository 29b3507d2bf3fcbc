"""Model registry of the PyTorch port (counterpart of
``stereo_toolbox_tpu.models``).

`create_model(name, device=None)` builds an eval-mode model on the card
(``device=None`` means ``"cuda"``) and raises when there is no card; the CPU
runs only when asked for with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from stereo_toolbox_tpu_torch.models.gwcnet import GwcNet, GwcNet_G

MODEL_REGISTRY: dict[str, Callable[..., Any]] = {
    "GwcNet_G": GwcNet_G,
}


def create_model(name: str, device=None, **kwargs) -> torch.nn.Module:
    """Build registry model `name` (keyword arguments go to its
    constructor, e.g. ``max_disp`` and ``generator``), in eval mode, on
    `device`."""
    if name not in MODEL_REGISTRY:
        raise KeyError(
            f"Unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "run the plain PyTorch paths on the CPU")
    return MODEL_REGISTRY[name](**kwargs).eval().to(device)


__all__ = ["GwcNet", "GwcNet_G", "MODEL_REGISTRY", "create_model"]
