"""Shared ops of the PyTorch port (counterpart of ``stereo_toolbox_tpu.ops``)."""

from stereo_toolbox_tpu_torch.ops.conv3d_fused import (conv3d_fused,
                                                       conv3d_fused_reference)
from stereo_toolbox_tpu_torch.ops.upsample import interpolate
from stereo_toolbox_tpu_torch.ops.volume import (build_gwc_volume,
                                                 disparity_regression,
                                                 groupwise_correlation,
                                                 gwc_volume_reference,
                                                 shifted_right_stack,
                                                 soft_argmax)

__all__ = ["build_gwc_volume", "conv3d_fused", "conv3d_fused_reference",
           "disparity_regression", "groupwise_correlation",
           "gwc_volume_reference", "interpolate", "shifted_right_stack",
           "soft_argmax"]
