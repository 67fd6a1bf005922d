"""Data layer: manifest datasets, datamodules, loaders and the manifest
preprocessing (counterpart of ``tdanet_tpu/datas``; the C++ loader is
``datas/native_loader.py`` over ``native/loader.cc``)."""

from tdanet_tpu_torch.datas.datasets import (  # noqa: F401
    Loader, SeparationDataset, normalize_wav, pad_to_lattice)
from tdanet_tpu_torch.datas.modules import (  # noqa: F401
    Libri2MixDataModule, LibriCSSDataModule, LibriCSSDataset,
    LRS2DataModule, WhamDataModule, WSJ0DataModule)
from tdanet_tpu_torch.datas.preprocess import (  # noqa: F401
    preprocess_dataset, preprocess_one_dir)

__all__ = [
    "Loader", "SeparationDataset", "normalize_wav", "pad_to_lattice",
    "Libri2MixDataModule", "LibriCSSDataModule", "LibriCSSDataset",
    "LRS2DataModule", "WhamDataModule", "WSJ0DataModule",
    "preprocess_dataset", "preprocess_one_dir",
]
