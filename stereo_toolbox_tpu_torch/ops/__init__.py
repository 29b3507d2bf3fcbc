"""Shared ops of the PyTorch port (counterpart of ``stereo_toolbox_tpu.ops``)."""

from stereo_toolbox_tpu_torch.ops.attention import (
    attention, attention_backward, attention_backward_dkv,
    attention_backward_dq, attention_backward_reference,
    attention_lse_reference, attention_reference, attention_with_lse)
from stereo_toolbox_tpu_torch.ops.corr import (all_pairs_correlation,
                                               build_corr_pyramid,
                                               corr_lookup_1d)
from stereo_toolbox_tpu_torch.ops.sampling import sample_1d
from stereo_toolbox_tpu_torch.ops.conv3d import (
    conv3d, conv3d_concat_volume, conv3d_concat_volume_reference,
    conv3d_reference)
from stereo_toolbox_tpu_torch.ops.conv3d_fused import (conv3d_fused,
                                                       conv3d_fused_reference)
from stereo_toolbox_tpu_torch.ops.upsample import (convex_upsample,
                                                   interpolate,
                                                   resize_nearest)
from stereo_toolbox_tpu_torch.ops.volume import (
    build_concat_volume, build_gwc_volume, concat_volume_backward,
    concat_volume_backward_reference, concat_volume_from_samples,
    concat_volume_reference, disparity_regression, disparity_variance,
    disparity_variance_confidence, gather_right_by_samples,
    gather_right_by_samples_backward,
    gather_right_by_samples_backward_reference,
    gather_right_by_samples_reference, groupwise_correlation,
    gwc_volume_backward, gwc_volume_backward_reference,
    gwc_volume_from_samples, gwc_volume_from_samples_backward,
    gwc_volume_from_samples_backward_reference,
    gwc_volume_from_samples_reference, gwc_volume_reference,
    shifted_right_stack, soft_argmax)

__all__ = ["all_pairs_correlation", "attention", "attention_backward",
           "attention_backward_dkv", "attention_backward_dq",
           "attention_backward_reference", "attention_lse_reference",
           "attention_reference", "attention_with_lse",
           "build_concat_volume", "build_corr_pyramid", "convex_upsample",
           "corr_lookup_1d",
           "build_gwc_volume", "concat_volume_backward",
           "concat_volume_backward_reference",
           "concat_volume_from_samples", "concat_volume_reference",
           "conv3d", "conv3d_concat_volume",
           "conv3d_concat_volume_reference", "conv3d_fused",
           "conv3d_fused_reference",
           "conv3d_reference", "disparity_regression",
           "disparity_variance", "disparity_variance_confidence",
           "gather_right_by_samples", "gather_right_by_samples_backward",
           "gather_right_by_samples_backward_reference",
           "gather_right_by_samples_reference",
           "groupwise_correlation", "gwc_volume_backward",
           "gwc_volume_backward_reference", "gwc_volume_from_samples",
           "gwc_volume_from_samples_backward",
           "gwc_volume_from_samples_backward_reference",
           "gwc_volume_from_samples_reference", "gwc_volume_reference",
           "interpolate", "resize_nearest", "sample_1d",
           "shifted_right_stack",
           "soft_argmax"]
