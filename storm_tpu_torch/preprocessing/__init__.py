"""Dataset creation (counterpart of storm_tpu/preprocessing/ and the root
preprocessing/ CLIs).

Host code in numpy and scipy, as in the JAX package: rooms (`room.py`), the
sidechain compressor (`compressor.py`), wind noise (`wind.py`) and noise
sampling (`utils.py`); one seed writes the same WAV bytes with either
package. The CLIs:

    python -m storm_tpu_torch.preprocessing.create_data --task enh --root DIR ...
    python -m storm_tpu_torch.preprocessing.simulate_wind_noise --dir DIR --n 100
    python -m storm_tpu_torch.preprocessing.nonlinear_mixing --speech_dir ... --noise_dir ... --root DIR
"""
from .compressor import hard_clip, nonlinear_mix, sidechain_compress
from .room import (
    inverse_sabine,
    measure_rt60,
    shoebox_rir,
    simulate_dry,
    simulate_shoebox,
)
from .utils import obtain_noise_file
from .wind import WindNoiseGenerator, generate_wind_noise, make_wind_profile

__all__ = [
    "sidechain_compress",
    "nonlinear_mix",
    "hard_clip",
    "inverse_sabine",
    "shoebox_rir",
    "simulate_shoebox",
    "simulate_dry",
    "measure_rt60",
    "obtain_noise_file",
    "WindNoiseGenerator",
    "generate_wind_noise",
    "make_wind_profile",
]
