"""Write wind-noise files (counterpart of preprocessing/simulate_wind_noise.py).

    python -m storm_tpu_torch.preprocessing.simulate_wind_noise --dir DIR --n 100 [--sr 16000]

Each file `simulated_<i>.wav` is 8 s of `wind.WindNoiseGenerator` noise: a
gustiness in [1, 10] and a wind-speed profile of magnitudes 200-500 with
steps under 100, drawn from one `np.random.default_rng(100)`, the noise
itself from seed 100 + i; the JAX script writes the same bytes.
"""
from __future__ import annotations

import argparse
import os
import shutil
from typing import Optional, Sequence

import numpy as np

from .wind import WindNoiseGenerator, make_wind_profile

SEED = 100

wind_params = {
    "duration": 8,
    "fs": 16000,
    "gustiness_range": [1, 10],
    "wind_profile_magnitude_range": [200, 500],
    "wind_profile_acceptable_transition_threshold": 100,
}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dir", type=str, required=True)
    parser.add_argument("--n", type=int, required=True, help="number of samples")
    parser.add_argument("--sr", default=16000, type=int)
    return parser.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if os.path.exists(args.dir):
        shutil.rmtree(args.dir)
    os.makedirs(args.dir, exist_ok=True)

    rng = np.random.default_rng(SEED)
    for i in range(args.n):
        gustiness = rng.uniform(*wind_params["gustiness_range"])
        profile = make_wind_profile(
            rng, gustiness,
            magnitude_range=wind_params["wind_profile_magnitude_range"],
            transition_threshold=wind_params["wind_profile_acceptable_transition_threshold"],
        )
        wn = WindNoiseGenerator(
            fs=args.sr, duration=wind_params["duration"], generate=True,
            wind_profile=profile, gustiness=gustiness, start_seed=SEED + i,
        )
        signal, _ = wn.generate_wind_noise()
        wn.save_signal(signal, os.path.join(args.dir, f"simulated_{i}.wav"))
    print(f"wrote {args.n} wind noise files to {args.dir}")


if __name__ == "__main__":
    main()
