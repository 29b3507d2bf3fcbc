"""Data layer of the PyTorch port: the synthetic dataset, the base
manifest dataset, the loader and the IO and augmentation they use; the
port's own copies of the JAX package's modules, yielding the same numpy
samples and batches for the same seeds. The 16 real datasets come later.
"""

from stereo_toolbox_tpu_torch.datasets.base import (StereoDataset,
                                                    SyntheticStereoDataset)
from stereo_toolbox_tpu_torch.datasets.loader import (ConcatDataset,
                                                      DataLoader, collate)

__all__ = ["ConcatDataset", "DataLoader", "StereoDataset",
           "SyntheticStereoDataset", "collate"]
