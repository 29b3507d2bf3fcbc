"""Layers of the PyTorch port (counterpart of ``stereo_toolbox_tpu.nn``)."""

from stereo_toolbox_tpu_torch.nn.dpt import DPTHead
from stereo_toolbox_tpu_torch.nn.layers import (BasicResBlock,
                                                ConcatVolumeConvBNAct,
                                                Conv3dSame, ConvBNAct,
                                                ConvTransposeBN, FeatureAtt,
                                                HourglassRedir, avg_pool,
                                                dual_view_apply, init_weights)
from stereo_toolbox_tpu_torch.nn.vit import DINOv2

__all__ = ["BasicResBlock", "ConcatVolumeConvBNAct", "Conv3dSame",
           "ConvBNAct", "ConvTransposeBN", "DINOv2", "DPTHead", "FeatureAtt",
           "HourglassRedir", "avg_pool",
           "dual_view_apply", "init_weights"]
