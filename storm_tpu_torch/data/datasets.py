"""Paired clean/noisy speech datasets (counterpart of storm_tpu/data/datasets.py).

The host loads wavs, crops or pads them to a fixed sample count and
normalises both by the noisy file's max; the STFT and the amplitude
compression run on the device in the trainer. The reference's file-format
conventions (wsj0, vctk, voicebank, dns, reverb_wsj0, timit) and its crop
rules are kept: target_len = (num_frames - 1) * hop, a random crop for
training, a centre crop for validation, a centred zero pad for short files.
A training crop is a pure function of (seed, item, epoch).
"""
from __future__ import annotations

from glob import glob
from os.path import join
from typing import List, Optional, Tuple

import numpy as np

from .audio import load_wav

_SUBSET_DIRS = {"train": "tr", "valid": "cv", "test": "tt"}


def paired_files(data_dir: str, subset: str, format: str) -> Tuple[List[str], List[str]]:
    """Clean and noisy file lists of `subset` ("train", "valid", "test")."""
    if format in ("wsj0", "vctk"):
        sub = _SUBSET_DIRS[subset]
        clean = sorted(glob(join(data_dir, sub) + "/clean/*.wav"))
        noisy = sorted(glob(join(data_dir, sub) + "/noisy/*.wav"))
    elif format == "voicebank":
        clean = sorted(glob(join(data_dir, subset) + "/clean/*.wav"))
        noisy = sorted(glob(join(data_dir, subset) + "/noisy/*.wav"))
    elif format == "dns":
        noisy = sorted(glob(join(data_dir, subset) + "/noisy/*.wav"))
        clean_dir = join(data_dir, subset) + "/clean/"
        clean = [clean_dir + "clean_fileid_" + f.split("/")[-1].split("_fileid_")[-1]
                 for f in noisy]
    elif format == "reverb_wsj0":
        sub = _SUBSET_DIRS[subset]
        clean = sorted(glob(join(data_dir, sub) + "/anechoic/*.wav"))
        noisy = sorted(glob(join(data_dir, sub) + "/reverb/*.wav"))
    elif format == "timit":
        sub = _SUBSET_DIRS[subset]
        clean = sorted(glob(join(data_dir, "audio", sub) + "/clean/*.wav"))
        noisy = sorted(glob(join(data_dir, "audio", sub) + "/noisy/*.wav"))
    else:
        raise ValueError(f"Unknown dataset format {format!r}")
    return clean, noisy


class Specs:
    """Paired dataset of fixed-length waveforms: `ds[i]` -> (x, y), float32
    (spatial_channels, target_len), both divided by max|y| of the whole file.
    `ds.__getitem__(i, raw=True)` gives the whole pair as read, cut to the
    shorter file and to `spatial_channels`, not normalised: what the
    in-training evaluation enhances."""

    def __init__(self, data_dir: str, subset: str, dummy: bool = False,
                 shuffle_spec: bool = False, num_frames: int = 256, format: str = "wsj0",
                 hop_length: int = 128,
                 spatial_channels: int = 1, rng: Optional[np.random.Generator] = None):
        self.data_dir = data_dir
        self.subset = subset
        self.format = format
        self.spatial_channels = spatial_channels
        self.clean_files, self.noisy_files = paired_files(data_dir, subset, format)
        self.dummy = dummy
        self.num_frames = num_frames
        self.shuffle_spec = shuffle_spec
        self.hop_length = hop_length
        # items load in a thread pool, so each crop draws from its own
        # generator seeded with (base seed, item, epoch)
        self._base_seed = int(rng.integers(2**31)) if rng is not None else 10
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """The epoch that the training crops are drawn for (set by DataLoader)."""
        self._epoch = int(epoch)

    @property
    def target_len(self) -> int:
        return (self.num_frames - 1) * self.hop_length  # num_frames centred STFT frames

    def __getitem__(self, i: int, raw: bool = False):
        x, _ = load_wav(self.clean_files[i])
        y, _ = load_wav(self.noisy_files[i])
        n = min(x.shape[-1], y.shape[-1])
        x, y = x[..., :n], y[..., :n]
        if self.spatial_channels > x.shape[0]:
            raise ValueError(f"You asked too many channels ({self.spatial_channels}) "
                             f"for the given dataset ({x.shape[0]})")
        x, y = x[: self.spatial_channels], y[: self.spatial_channels]
        if raw:
            return x, y

        normfac = np.abs(y).max()
        target_len = self.target_len
        pad = max(target_len - n, 0)
        if pad == 0:
            if self.shuffle_spec:
                rng = np.random.default_rng((self._base_seed, i, self._epoch))
                start = int(rng.uniform(0, n - target_len))
            else:
                start = int((n - target_len) / 2)
            x = x[..., start: start + target_len]
            y = y[..., start: start + target_len]
        else:
            widths = [(0, 0)] * (x.ndim - 1) + [(pad // 2, pad // 2 + pad % 2)]
            x, y = np.pad(x, widths), np.pad(y, widths)
        # both by the noisy max, so the clean signal keeps its level relative to y
        return (x / normfac).astype(np.float32), (y / normfac).astype(np.float32)

    def __len__(self) -> int:
        if self.dummy:
            return int(len(self.clean_files) / 10)
        if self.format == "vctk":
            return len(self.clean_files) // 2
        return len(self.clean_files)


class SpecsAndTranscriptions(Specs):
    """The TIMIT test layout with transcripts: `ds[i]` (and the raw item)
    is (x, y, transcript), the transcript without its first two tokens (the
    sample indices TIMIT's .txt files start with)."""

    def __init__(self, data_dir: str, subset: str, **kwargs):
        super().__init__(data_dir, subset, format="timit", **kwargs)
        self.transcriptions = sorted(
            glob(join(data_dir, "transcriptions", _SUBSET_DIRS[subset]) + "/*.txt"))

    def __getitem__(self, i: int, raw: bool = False):
        x, y = super().__getitem__(i, raw=raw)
        with open(self.transcriptions[i], "r") as f:
            transcription = f.read()
        return x, y, " ".join(transcription.split(" ")[2:])

    def __len__(self) -> int:
        if self.dummy:
            return int(len(self.clean_files) / 10)
        return len(self.clean_files)
