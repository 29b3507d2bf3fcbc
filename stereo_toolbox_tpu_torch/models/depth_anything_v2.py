"""DepthAnythingV2: DINOv2 ViT encoder + DPT depth head (PyTorch).

Counterpart of ``stereo_toolbox_tpu/models/depth_anything_v2.py``: the
monocular relative-depth model, and the frozen trunk of the foundation-tier
stereo models. Module names follow the original's ``pretrained`` (DINOv2)
and ``depth_head`` (DPT), so ``state_dict`` keys are its PyTorch names.

Contract: ImageNet-normalised ``[B, H, W, 3]`` image → ``[B, ph · 14, pw ·
14]`` relative inverse depth, ``ph, pw = H // 14, W // 14`` (a remainder of
H or W is dropped by the patch embedding). Eval only. The ViT's attention
runs on K7 (``csrc/vit_attention.cu``) on the card, at every token count.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from stereo_toolbox_tpu_torch.nn.dpt import DPTHead
from stereo_toolbox_tpu_torch.nn.vit import PATCH, DINOv2
from stereo_toolbox_tpu_torch.utils.precision import full_float32

VIT_CONFIGS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6,
                 taps=(2, 5, 8, 11), out_channels=(48, 96, 192, 384)),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12,
                 taps=(2, 5, 8, 11), out_channels=(96, 192, 384, 768)),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16,
                 taps=(4, 11, 17, 23), out_channels=(256, 512, 1024, 1024)),
}
DEFAULT_FEATURES = {"vits": 64, "vitb": 128, "vitl": 256}


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisation, drawn from `generator`: conv and
    Linear weights ~ N(0, 1 / fan_in), biases 0, LayerNorm 1 / 0, LayerScale
    1, cls token 0, position embedding ~ N(0, 0.02²)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                fan_in = (w.shape[0] * w[0, 0].numel()
                          if isinstance(m, nn.ConvTranspose2d)
                          else w[0].numel())
                w.normal_(0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, DINOv2):
                m.cls_token.zero_()
                m.pos_embed.normal_(0.0, 0.02, generator=generator)


class DepthAnythingV2(nn.Module):
    """`encoder` of `VIT_CONFIGS`; `features` defaults to the encoder's
    (64 / 128 / 256); ``out_align_corners=False`` is StereoAnywhere's
    variant of the last resize."""

    def __init__(self, encoder: str = "vits", features: int | None = None,
                 out_align_corners: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = VIT_CONFIGS[encoder]
        self.encoder = encoder
        self.taps = tuple(cfg["taps"])
        self.pretrained = DINOv2(cfg["embed_dim"], cfg["depth"],
                                 cfg["num_heads"])
        self.depth_head = DPTHead(cfg["embed_dim"],
                                  features or DEFAULT_FEATURES[encoder],
                                  cfg["out_channels"], out_align_corners)
        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor, return_features: bool = False):
        """Depth ``[B, ph · 14, pw · 14]``; with `return_features` also the
        head's ``{"path_1", "out", "paths"}`` and the ViT's ``"taps"``."""
        if self.training:
            raise NotImplementedError("DepthAnythingV2 runs in eval mode "
                                      "only; call .eval() first")
        dtype = self.pretrained.patch_embed.proj.weight.dtype
        with full_float32(dtype == torch.float32):
            return self._forward(x, dtype, return_features)

    def _forward(self, x, dtype, return_features):
        ph, pw = x.shape[1] // PATCH, x.shape[2] // PATCH
        taps = self.pretrained.get_intermediate_layers(x.to(dtype), self.taps)
        if return_features:
            depth, feats = self.depth_head(taps, ph, pw, return_path1=True)
            feats["taps"] = taps
            return depth, feats
        return self.depth_head(taps, ph, pw)
