"""Data layer of the PyTorch port: the synthetic dataset, the zoo's dataset
classes over their vendored manifests, the base manifest dataset, the
loader and the IO (with its native decoders) and augmentation they use; the
port's own copies of the JAX package's modules, yielding the same numpy
samples and batches for the same seeds.
"""

from stereo_toolbox_tpu_torch.datasets import zoo
from stereo_toolbox_tpu_torch.datasets.base import (StereoDataset,
                                                    SyntheticStereoDataset)
from stereo_toolbox_tpu_torch.datasets.loader import (ConcatDataset,
                                                      DataLoader, collate)
from stereo_toolbox_tpu_torch.datasets.zoo import (
    Argoverse_Dataset,
    Booster_Dataset,
    CREStereo_Dataset,
    DrivingStereo_Dataset,
    ETH3D_Dataset,
    FallingThings_Dataset,
    HR_VS_Dataset,
    Holopix50k_Dataset,
    InStereo2k_Dataset,
    KITTI2012_Dataset,
    KITTI2015_Dataset,
    Middlebury2021_Dataset,
    MiddleburyEval3_Dataset,
    MonoTrap_Dataset,
    SceneFlow_Dataset,
    Sintel_Dataset,
    VirtualKITTI2_Dataset,
)

__all__ = [
    "Argoverse_Dataset", "Booster_Dataset", "CREStereo_Dataset",
    "ConcatDataset", "DataLoader", "DrivingStereo_Dataset", "ETH3D_Dataset",
    "FallingThings_Dataset", "HR_VS_Dataset", "Holopix50k_Dataset",
    "InStereo2k_Dataset", "KITTI2012_Dataset", "KITTI2015_Dataset",
    "Middlebury2021_Dataset", "MiddleburyEval3_Dataset", "MonoTrap_Dataset",
    "SceneFlow_Dataset", "Sintel_Dataset", "StereoDataset",
    "SyntheticStereoDataset", "VirtualKITTI2_Dataset", "collate", "zoo",
]
