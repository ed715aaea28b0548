"""Datasets: the Zaragoza and Stanford .mat loaders, the synthetic scenes
and scan grids, and the physical validation of a loaded capture."""

from nlos_gaussian_renderer_tpu_torch.data.stanford import load_stanford_data
from nlos_gaussian_renderer_tpu_torch.data.synthetic import make_synthetic_dataset
from nlos_gaussian_renderer_tpu_torch.data.zaragoza import NLOSData, load_zaragoza256_data

__all__ = [
    "NLOSData",
    "load_zaragoza256_data",
    "load_stanford_data",
    "make_synthetic_dataset",
]
