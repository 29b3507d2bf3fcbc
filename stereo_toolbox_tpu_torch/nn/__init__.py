"""Layers of the PyTorch port (counterpart of ``stereo_toolbox_tpu.nn``)."""

from stereo_toolbox_tpu_torch.nn.layers import (BasicResBlock, ConvBNAct,
                                                ConvTransposeBN,
                                                HourglassRedir, avg_pool,
                                                dual_view_apply, init_weights)

__all__ = ["BasicResBlock", "ConvBNAct", "ConvTransposeBN", "HourglassRedir",
           "avg_pool", "dual_view_apply", "init_weights"]
