"""SpecsDataModule (counterpart of storm_tpu/data/datamodule.py).

Owns the data settings, the training, validation and test datasets and
their loaders; `SpecsAndTranscriptionsDataModule` is the TIMIT test set with
transcripts, for the evaluation's WER.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .datasets import Specs, SpecsAndTranscriptions
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
        self.test_set: Optional[Specs] = None
        self._train_loader: Optional[DataLoader] = None

    def setup(self, stage: Optional[str] = None) -> None:
        """"fit": the training and validation sets; "test": the test set;
        None: all three."""
        kwargs = dict(num_frames=self.num_frames, format=self.format,
                      hop_length=self.hop_length, spatial_channels=self.spatial_channels,
                      dummy=self.dummy)
        if stage in ("fit", None):
            self.train_set = Specs(self.base_dir, "train", shuffle_spec=True,
                                   rng=np.random.default_rng(self.seed), **kwargs)
            self.valid_set = Specs(self.base_dir, "valid", shuffle_spec=False, **kwargs)
        if stage in ("test", None):
            self.test_set = Specs(self.base_dir, "test", shuffle_spec=False, **kwargs)

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

    def test_dataloader(self) -> DataLoader:
        """Every test file in order; the last batch may be short."""
        return DataLoader(self.test_set, batch_size=self.batch_size, shuffle=False,
                          drop_last=False, num_workers=self.num_workers)


@dataclasses.dataclass
class SpecsAndTranscriptionsDataModule(SpecsDataModule):
    """The TIMIT test set with its transcripts; test only."""

    def setup(self, stage: Optional[str] = None) -> None:
        if stage == "fit":
            raise NotImplementedError("SpecsAndTranscriptionsDataModule has a test set only")
        self.test_set = SpecsAndTranscriptions(self.base_dir, "test", num_frames=self.num_frames,
                                               hop_length=self.hop_length, dummy=self.dummy)
