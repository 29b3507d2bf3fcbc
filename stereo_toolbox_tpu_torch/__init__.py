"""stereo_toolbox_tpu_torch — the PyTorch/CUDA port of stereo_toolbox_tpu.

Runs on an NVIDIA Hopper card (H100). Plain tensor code is PyTorch; the
kernels the JAX package wrote in Pallas are hand-written CUDA C++ under
``csrc/``, built with ``nvcc`` at first use. The package imports neither JAX
nor the JAX package. Entry points: ``models.create_model`` and, for
training (float32, or ``--bf16`` on float32 master weights), ``python -m
stereo_toolbox_tpu_torch.train`` (``trainer``); ``disparity_estimators``
maps a probability volume to disparity.
"""

__version__ = "0.1.0"
