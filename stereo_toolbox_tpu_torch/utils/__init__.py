"""Utilities of the PyTorch port."""

from stereo_toolbox_tpu_torch.utils.weights import (JaxToTorch,
                                                    from_jax_variables)

__all__ = ["JaxToTorch", "from_jax_variables"]
