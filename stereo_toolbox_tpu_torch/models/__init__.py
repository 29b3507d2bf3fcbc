"""Model registry of the PyTorch port (counterpart of
``stereo_toolbox_tpu.models``): ACVNet, CFNet, DEFOMStereo_S and _L,
DepthAnythingV2, GwcNet_G and _GC, IGEVStereo (eval only), PCWNet_G and
_GC (eval only), PSMNet, RAFTStereo, SelectiveIGEV and SelectiveRAFT
(eval only).

`create_model(name, device=None, dtype=torch.float32)` builds an eval-mode
model on the card (``device=None`` means ``"cuda"``) and raises when there
is no card; the CPU runs only when asked for with ``device="cpu"``. A float32
forward computes in full float32 (no TF32), a bfloat16 model keeps in
float32 what the JAX package keeps and computes with in float32
(`F32_MODULES`, `F32_PARAMS`; `stereo_toolbox_tpu_torch.utils.precision`).

Such a cast model evaluates; it does not train. bfloat16 training keeps the
float32 model's parameters as the masters, as flax does, and runs the
forward on a bfloat16 view of them (`bfloat16_view`, through
``torch.func.functional_call``), so that every gradient flows back to its
float32 leaf (`trainer.make_train_step(..., dtype=torch.bfloat16)`).
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from stereo_toolbox_tpu_torch.models.acvnet import ACVNet
from stereo_toolbox_tpu_torch.models.cfnet import CFNet
from stereo_toolbox_tpu_torch.models.defom_stereo import (DEFOMStereo,
                                                          DEFOMStereo_L,
                                                          DEFOMStereo_S)
from stereo_toolbox_tpu_torch.models.depth_anything_v2 import DepthAnythingV2
from stereo_toolbox_tpu_torch.models.gwcnet import (GwcNet, GwcNet_G,
                                                    GwcNet_GC)
from stereo_toolbox_tpu_torch.models.igev_stereo import IGEVStereo
from stereo_toolbox_tpu_torch.models.pcwnet import (PCWNet, PCWNet_G,
                                                    PCWNet_GC)
from stereo_toolbox_tpu_torch.models.psmnet import PSMNet
from stereo_toolbox_tpu_torch.models.raft_stereo import RAFTStereo
from stereo_toolbox_tpu_torch.models.selective import (SelectiveIGEV,
                                                       SelectiveRAFT)
from stereo_toolbox_tpu_torch.nn.vit import DINOv2, LayerScale

MODEL_REGISTRY: dict[str, Callable[..., Any]] = {
    "ACVNet": ACVNet,
    "CFNet": CFNet,
    "DEFOMStereo_L": DEFOMStereo_L,
    "DEFOMStereo_S": DEFOMStereo_S,
    "DepthAnythingV2": DepthAnythingV2,
    "GwcNet_G": GwcNet_G,
    "GwcNet_GC": GwcNet_GC,
    "IGEVStereo": IGEVStereo,
    "PCWNet_G": PCWNet_G,
    "PCWNet_GC": PCWNet_GC,
    "PSMNet": PSMNet,
    "RAFTStereo": RAFTStereo,
    "SelectiveIGEV": SelectiveIGEV,
    "SelectiveRAFT": SelectiveRAFT,
}

# What a bfloat16 model keeps in float32: what the JAX package keeps as a
# float32 param and computes with in float32 (flax's ``param_dtype`` for the
# norms; JAX's type promotion where a raw ``self.param`` meets a bfloat16
# value). Every value of these modules ...
F32_MODULES = (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d, torch.nn.LayerNorm)
# ... and these parameters, by the module that holds them: DINOv2's token
# stream (``x + pos``, ``x + h * ls``) and CFNet's search-range scales.
F32_PARAMS = {DINOv2: ("cls_token", "pos_embed"), LayerScale: ("gamma",),
              CFNet: ("gamma_s3", "beta_s3", "gamma_s2", "beta_s2")}


def keeps_float32(module: torch.nn.Module, name: str) -> bool:
    """Whether a bfloat16 model keeps `module`'s value `name` in float32."""
    return isinstance(module, F32_MODULES) or any(
        isinstance(module, kind) and name in names
        for kind, names in F32_PARAMS.items())


def create_model(name: str, device=None, dtype: torch.dtype = torch.float32,
                 **kwargs) -> torch.nn.Module:
    """Build registry model `name` (keyword arguments go to its
    constructor, e.g. ``max_disp``, ``encoder`` and ``generator``), in
    eval mode, on `device`, computing in `dtype`.

    ``dtype=torch.bfloat16`` is the JAX package's ``dtype=jnp.bfloat16``:
    every conv, linear and attention parameter in bfloat16; kept in float32
    (`keeps_float32`) every BatchNorm's values (weight, bias, running
    statistics) and every LayerNorm's, as flax's ``param_dtype``, DINOv2's
    ``cls_token``, ``pos_embed`` and LayerScale ``gamma`` (its token stream
    is then float32) and CFNet's ``gamma_s*`` / ``beta_s*``.
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
    return cast_model(model, dtype).to(device)


def bfloat16_view(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The float32 `model`'s parameters by name as a bfloat16 model uses
    them, for ``torch.func.functional_call(model, view, inputs)``: each
    floating parameter cast to bfloat16 with ``.to()``, whose backward
    casts the gradient back to the float32 leaf (JAX's
    ``convert_element_type`` of a flax ``param_dtype=float32`` leaf); the
    parameters `keeps_float32` names are the float32 leaves themselves.
    Buffers are not in the view: the module's own float32 running
    statistics are read and updated in place. Build it anew each step,
    after the masters' update."""
    view = {}
    for prefix, m in model.named_modules():
        for key, p in m.named_parameters(recurse=False):
            cast = p.is_floating_point() and not keeps_float32(m, key)
            view[f"{prefix}.{key}" if prefix else key] = (
                p.to(torch.bfloat16) if cast else p)
    return view


def cast_model(model: torch.nn.Module, dtype: torch.dtype
               ) -> torch.nn.Module:
    """`model` (or one of its layers) cast in place to compute in `dtype`:
    every floating value in `dtype` but those `keeps_float32` names. A
    bfloat16 model cast so evaluates; in train mode it raises, having no
    float32 masters (train the float32 model through `bfloat16_view`)."""
    for m in model.modules():
        for group in (m._parameters, m._buffers):
            for key, t in group.items():
                if (t is not None and t.is_floating_point()
                        and not keeps_float32(m, key)):
                    t.data = t.data.to(dtype)
    return model


__all__ = ["ACVNet", "CFNet", "DEFOMStereo", "DEFOMStereo_L",
           "DEFOMStereo_S", "DepthAnythingV2", "F32_MODULES",
           "F32_PARAMS", "GwcNet", "GwcNet_G", "GwcNet_GC", "IGEVStereo",
           "MODEL_REGISTRY", "PCWNet", "PCWNet_G", "PCWNet_GC", "PSMNet",
           "RAFTStereo", "SelectiveIGEV", "SelectiveRAFT", "bfloat16_view",
           "cast_model", "create_model", "keeps_float32"]
