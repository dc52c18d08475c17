"""SpecsDataModule, fit stage (counterpart of storm_tpu/data/datamodule.py).

Owns the data settings, the training and validation datasets and their
loaders. The test stage (and the test set's metrics) is ROADMAP R5.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .datasets import Specs
from .loader import DataLoader


@dataclasses.dataclass
class SpecsDataModule:
    base_dir: str = ""
    format: str = "wsj0"
    spatial_channels: int = 1
    batch_size: int = 8
    hop_length: int = 128
    num_frames: int = 256
    num_workers: int = 8
    dummy: bool = False
    seed: int = 10

    def __post_init__(self):
        self.train_set: Optional[Specs] = None
        self.valid_set: Optional[Specs] = None
        self._train_loader: Optional[DataLoader] = None

    def setup(self, stage: str = "fit") -> None:
        if stage != "fit":
            raise NotImplementedError(f"stage {stage!r}: only 'fit' is ported (ROADMAP R5)")
        kwargs = dict(num_frames=self.num_frames, format=self.format,
                      hop_length=self.hop_length, spatial_channels=self.spatial_channels,
                      dummy=self.dummy)
        self.train_set = Specs(self.base_dir, "train", shuffle_spec=True,
                               rng=np.random.default_rng(self.seed), **kwargs)
        self.valid_set = Specs(self.base_dir, "valid", shuffle_spec=False, **kwargs)

    def train_dataloader(self) -> DataLoader:
        """One loader for the run, shuffled by (seed, epoch)."""
        if self._train_loader is None:
            self._train_loader = DataLoader(self.train_set, batch_size=self.batch_size,
                                            shuffle=True, num_workers=self.num_workers,
                                            seed=self.seed)
        return self._train_loader

    def val_dataloader(self) -> DataLoader:
        """Every validation file in order; the last batch may be short."""
        return DataLoader(self.valid_set, batch_size=self.batch_size, shuffle=False,
                          drop_last=False, num_workers=self.num_workers)
