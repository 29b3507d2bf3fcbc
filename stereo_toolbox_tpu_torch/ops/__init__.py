"""Shared ops of the PyTorch port (counterpart of ``stereo_toolbox_tpu.ops``)."""

from stereo_toolbox_tpu_torch.ops.attention import (attention,
                                                    attention_reference)
from stereo_toolbox_tpu_torch.ops.conv3d import (
    conv3d, conv3d_concat_volume, conv3d_concat_volume_reference,
    conv3d_reference)
from stereo_toolbox_tpu_torch.ops.conv3d_fused import (conv3d_fused,
                                                       conv3d_fused_reference)
from stereo_toolbox_tpu_torch.ops.upsample import interpolate, resize_nearest
from stereo_toolbox_tpu_torch.ops.volume import (
    build_concat_volume, build_gwc_volume, concat_volume_from_samples,
    concat_volume_reference, disparity_regression, disparity_variance,
    disparity_variance_confidence, gather_right_by_samples,
    gather_right_by_samples_reference, groupwise_correlation,
    gwc_volume_from_samples, gwc_volume_from_samples_reference,
    gwc_volume_reference, shifted_right_stack, soft_argmax)

__all__ = ["attention", "attention_reference", "build_concat_volume",
           "build_gwc_volume",
           "concat_volume_from_samples", "concat_volume_reference",
           "conv3d", "conv3d_concat_volume",
           "conv3d_concat_volume_reference", "conv3d_fused",
           "conv3d_fused_reference",
           "conv3d_reference", "disparity_regression",
           "disparity_variance", "disparity_variance_confidence",
           "gather_right_by_samples", "gather_right_by_samples_reference",
           "groupwise_correlation", "gwc_volume_from_samples",
           "gwc_volume_from_samples_reference", "gwc_volume_reference",
           "interpolate", "resize_nearest", "shifted_right_stack",
           "soft_argmax"]
