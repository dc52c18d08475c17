"""Mix speech into wind noise nonlinearly (counterpart of
preprocessing/nonlinear_mixing.py).

    python -m storm_tpu_torch.preprocessing.nonlinear_mixing --speech_dir 'speech/{}' \\
        --noise_dir 'wind/{}' --root DIR [--sr 16000] [--dummy]

For each split cv, tr, tt (`{}` in the directory templates): the speech
ducked by a random noise excerpt through the sidechain compressor
(`compressor.nonlinear_mix`) at an SNR in [-6, 14] dB, then clipped at
0.85-1.0 of its extremes with a 75% chance. Output:
`<root>/speech_in_noise_nonlinear/<split>/{clean,noisy}` (noisy files
`<name>_<i>_snr=<snr>.wav`) and `log_stats.txt`. The draws come from one
`np.random.default_rng(100)` in the JAX script's order.
"""
from __future__ import annotations

import argparse
import glob
import os
import shutil
from os.path import join
from typing import Optional, Sequence

import numpy as np

from ..data.audio import load_wav, save_wav
from .compressor import hard_clip, nonlinear_mix

SEED = 100

params = {
    "snr_range": [-6, 14],
    "threshold_range": [0.1, 0.3],
    "ratio_range": [1, 20],
    "attack_range": [5, 100],
    "release_range": [5, 500],
    "sc_gain_range": [0.8, 1.2],
    "clipping_threshold_range": [0.85, 1.0],
    "clipping_chance": 0.75,
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--speech_dir", type=str, required=True,
                        help="clean speech dir template with {} for split")
    parser.add_argument("--noise_dir", type=str, required=True,
                        help="wind noise dir template with {} for split")
    parser.add_argument("--root", type=str, required=True, help="output root directory")
    parser.add_argument("--sr", type=int, default=16000)
    parser.add_argument("--dummy", action="store_true")
    return parser.parse_args(argv)


def _load_mono(path: str, sr: int) -> np.ndarray:
    x, got = load_wav(path)
    if got != sr:
        raise ValueError(f"{path}: sampling rate {got}, expected {sr}")
    return x[0]


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    rng = np.random.default_rng(SEED)
    output_dir = join(args.root, "speech_in_noise_nonlinear")
    if os.path.exists(output_dir):
        shutil.rmtree(output_dir)
    os.makedirs(output_dir, exist_ok=True)
    with open(join(output_dir, "log_stats.txt"), "w") as log:
        log.write("Parameters \n ========== \n")
        for key, param in params.items():
            log.write(f"{key} : {param}\n")

    for split in ("cv", "tr", "tt"):
        print(f"Processing split {split}...")
        speech_split = sorted(glob.glob(join(args.speech_dir.format(split), "*.wav")))
        noise_split = sorted(glob.glob(join(args.noise_dir.format(split), "*.wav")))
        clean_dir = join(output_dir, split, "clean")
        noisy_dir = join(output_dir, split, "noisy")
        os.makedirs(clean_dir, exist_ok=True)
        os.makedirs(noisy_dir, exist_ok=True)

        n = min(5, len(speech_split)) if args.dummy else len(speech_split)
        for i in range(n):
            speech = _load_mono(speech_split[i], args.sr)
            noise = _load_mono(noise_split[rng.integers(len(noise_split))], args.sr)

            if len(noise) < len(speech):
                noise = np.pad(noise, (0, len(speech) - len(noise)))
            else:
                offset = rng.integers(max(len(noise) - len(speech), 1))
                noise = noise[offset: offset + len(speech)]

            snr = rng.uniform(*params["snr_range"])
            npow = np.sum(noise**2) / len(noise)
            spow = np.sum(speech**2) / len(speech)
            scaling = np.sqrt(spow * 10 ** (-snr / 10) / max(npow, 1e-30))
            noise = noise * scaling

            mix = nonlinear_mix(
                speech, noise, sr=args.sr,
                threshold=rng.uniform(*params["threshold_range"]),
                ratio=rng.uniform(*params["ratio_range"]),
                attack=rng.uniform(*params["attack_range"]),
                release=rng.uniform(*params["release_range"]),
                sc_gain=rng.uniform(*params["sc_gain_range"]),
            )
            if rng.random() < params["clipping_chance"]:
                mix = hard_clip(mix, rng.uniform(*params["clipping_threshold_range"]))

            out = os.path.basename(speech_split[i])[:-4] + f"_{i}_snr={snr:.1f}.wav"
            save_wav(join(noisy_dir, out), mix, args.sr)
            save_wav(join(clean_dir, os.path.basename(speech_split[i])), speech, args.sr)
    print("done.")


if __name__ == "__main__":
    main()
