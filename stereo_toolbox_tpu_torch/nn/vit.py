"""DINOv2 ViT encoder of DepthAnythingV2 (PyTorch).

Counterpart of ``ViTBlock`` and ``DINOv2`` in
``stereo_toolbox_tpu/models/depth_anything_v2.py``: patch-14 embedding, a
cls token, the position embedding stored at the canonical 37×37 grid and
resized bicubically to other grids, pre-norm blocks with LayerScale, and
`get_intermediate_layers`. Modules carry the original DINOv2's PyTorch names
(``patch_embed.proj``, ``blocks.{i}.attn.qkv``, ``ls1.gamma``, ``norm``, …),
so ``state_dict`` keys are the ones the original checkpoints use.

Left out of the original's parameters: ``mask_token``, a training-time
masking artifact that no forward reads. The one final ``norm`` is applied at
every tap, as the original's ``get_intermediate_layers(norm=True)``.

The attention core is `ops.attention` (K7 on the card); the Linear layers
run on cuBLAS and LayerNorm and GELU in ATen, as the JAX package leaves them
to XLA. LayerNorm's eps is DINOv2's (and flax's) 1e-6; GELU is exact.

In a bfloat16 model (``models.create_model(..., dtype=torch.bfloat16)``) the
token stream is float32, as in the JAX package, where the float32
``pos_embed``, ``cls_token`` and LayerScale params promote it: the
patch embedding (bfloat16) plus the float32 position embedding gives float32
tokens, each LayerNorm normalises the float32 stream with float32 weights
and rounds once to bfloat16 (flax's ``LayerNorm(dtype=bfloat16)``), the
attention and MLP branches compute in bfloat16, and each residual add
``x + h * gamma`` is one float32 ``addcmul``. The working type is the patch
embedding's weight's; a float32 model computes in float32 throughout.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.ops.attention import attention
from stereo_toolbox_tpu_torch.ops.upsample import bicubic_matrix

PATCH = 14
POS_GRID = 37          # the position embedding's grid (518 / 14)
LN_EPS = 1e-6


class PatchEmbed(nn.Module):
    """Non-overlapping 14×14 patches of a channels-last image → tokens
    ``[B, ph · pw, dim]`` (a remainder of H or W is dropped)."""

    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, PATCH, PATCH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.movedim(-1, 1)).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    """Multi-head self-attention with one fused ``qkv`` projection."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, dim = x.shape
        hd = dim // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = (t.transpose(1, 2).contiguous() for t in qkv.unbind(2))
        o = attention(q, k, v, hd ** -0.5)           # [B, heads, N, hd]
        return self.proj(o.transpose(1, 2).reshape(b, n, dim))


class LayerScale(nn.Module):
    """The per-channel ``gamma`` of a residual branch; `Block` adds
    ``x + h * gamma`` in one ``addcmul``."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm transformer block with LayerScale on both branches."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The stream `x` (float32 in a bfloat16 model) → the stream; each
        branch runs in the Linear layers' type."""
        dtype = self.attn.qkv.weight.dtype
        x = torch.addcmul(x, self.attn(self.norm1(x).to(dtype)),
                          self.ls1.gamma)
        return torch.addcmul(x, self.mlp(self.norm2(x).to(dtype)),
                             self.ls2.gamma)


class DINOv2(nn.Module):
    """Patch-14 ViT returning intermediate ``(patch_tokens, cls)`` pairs."""

    def __init__(self, embed_dim: int, depth: int, num_heads: int):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, POS_GRID * POS_GRID + 1, embed_dim))
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def position_embedding(self, ph: int, pw: int) -> torch.Tensor:
        """Patch position embedding ``[1, ph · pw, dim]`` for a ph×pw grid:
        DINOv2's bicubic resize at scale ``(g + 0.1) / 37``, computed in
        float32 as a product with `bicubic_matrix` on each axis."""
        pos = self.pos_embed[:, 1:]
        if (ph, pw) == (POS_GRID, POS_GRID):
            return pos
        dim = pos.shape[-1]
        grid = pos.reshape(POS_GRID, POS_GRID, dim).float()
        mh, mw = (torch.from_numpy(bicubic_matrix(POS_GRID, g,
                                                  (g + 0.1) / POS_GRID)).to(
            pos.device) for g in (ph, pw))
        grid = torch.einsum("oh,hwc->owc", mh, grid)
        grid = torch.einsum("ow,hwc->hoc", mw, grid)
        return grid.reshape(1, ph * pw, dim).to(pos.dtype)

    def get_intermediate_layers(self, x: torch.Tensor, taps
                                ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """Channels-last image ``[B, H, W, 3]`` → for each block index in
        `taps`, the normed ``(patch_tokens [B, ph · pw, dim], cls [B,
        dim])`` after that block, in the patch embedding's type."""
        b, h, w, _ = x.shape
        ph, pw = h // PATCH, w // PATCH
        dtype = self.patch_embed.proj.weight.dtype
        tokens = self.patch_embed(x) + self.position_embedding(ph, pw)
        cls = (self.cls_token + self.pos_embed[:, :1]).expand(b, -1, -1)
        x = torch.cat([cls, tokens], dim=1)
        outputs = []
        tapset = set(taps)
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i in tapset:
                n = self.norm(x).to(dtype)
                outputs.append((n[:, 1:], n[:, 0]))
        return outputs
