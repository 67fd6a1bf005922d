"""Data layer: manifest datasets, datamodules and the loader (counterpart
of ``tdanet_tpu/datas``; the C++ native loader and ``preprocess`` are not
ported yet, ROADMAP A #9)."""

from tdanet_tpu_torch.datas.datasets import (  # noqa: F401
    Loader, SeparationDataset, normalize_wav, pad_to_lattice)
from tdanet_tpu_torch.datas.modules import (  # noqa: F401
    Libri2MixDataModule, LibriCSSDataModule, LibriCSSDataset,
    LRS2DataModule, WhamDataModule, WSJ0DataModule)

__all__ = [
    "Loader", "SeparationDataset", "normalize_wav", "pad_to_lattice",
    "Libri2MixDataModule", "LibriCSSDataModule", "LibriCSSDataset",
    "LRS2DataModule", "WhamDataModule", "WSJ0DataModule",
]
