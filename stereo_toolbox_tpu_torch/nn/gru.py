"""Convolutional GRU cell of the iterative models (PyTorch).

Counterpart of ``ConvGRU`` and ``pool2x`` in
``stereo_toolbox_tpu/nn/gru.py``, channels-last like them. The gates keep the
original toolbox's names (``convz``, ``convr``, ``convq``); JAX evaluates z
and r in one conv of concatenated kernels, which gives the same values.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from stereo_toolbox_tpu_torch.nn.layers import channels_first, channels_last


def conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`conv` on a channels-last ``[B, H, W, C]`` tensor, its input cast to
    the conv's weight type (flax's ``nn.Conv(dtype=...)``)."""
    return channels_last(conv(channels_first(x.to(conv.weight.dtype))))


class ConvGRU(nn.Module):
    """GRU cell with k×k conv gates over ``[h, x]`` and the context
    network's per-gate biases ``(cz, cr, cq)`` added before the
    nonlinearities."""

    def __init__(self, hidden_dim: int, input_dim: int, kernel_size: int = 3):
        super().__init__()
        pad = kernel_size // 2
        self.convz = nn.Conv2d(hidden_dim + input_dim, hidden_dim,
                               kernel_size, padding=pad)
        self.convr = nn.Conv2d(hidden_dim + input_dim, hidden_dim,
                               kernel_size, padding=pad)
        self.convq = nn.Conv2d(hidden_dim + input_dim, hidden_dim,
                               kernel_size, padding=pad)

    def forward(self, h: torch.Tensor, x: torch.Tensor,
                context=None) -> torch.Tensor:
        hx = torch.cat([h, x], dim=-1)
        z, r = conv_nhwc(self.convz, hx), conv_nhwc(self.convr, hx)
        if context is not None:
            cz, cr, _ = context
            z, r = z + cz, r + cr
        z, r = torch.sigmoid(z), torch.sigmoid(r)
        q = conv_nhwc(self.convq, torch.cat([r * h, x], dim=-1))
        if context is not None:
            q = q + context[2]
        return (1 - z) * h + z * torch.tanh(q)


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-2 average pool with zero padding 1 (the padding counts),
    channels-last."""
    return channels_last(F.avg_pool2d(channels_first(x), 3, 2, 1))


__all__ = ["ConvGRU", "conv_nhwc", "pool2x"]
