"""File-to-file StoRM enhancement on the GPU (counterpart of enhancement.py).

    python -m storm_tpu_torch.enhancement --test_dir noisy/ --enhanced_dir out/ \\
        --ckpt model.pt --mode storm [--device cuda]

Flags and defaults are those of the reference CLI for `--mode storm
--sampler pc`: reverse diffusion with the ald corrector, one corrector step,
snr 0.5, N=50, EMA weights unless `--no-ema`. Files are enhanced one at a
time, with noise from one torch.Generator seeded with 0.
"""
from __future__ import annotations

import argparse
import glob
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .ckpt import load_checkpoint
from .data.audio import load_wav, save_wav
from .models.factory import STORM_MODES, build_model
from .sampling.correctors import CORRECTORS
from .sampling.predictors import PREDICTORS

MODEL_SR = 16000


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--test_dir", type=str, required=True,
                   help="Directory containing corrupted .wav files to enhance.")
    p.add_argument("--enhanced_dir", type=str, required=True,
                   help="Where to write the cleaned files.")
    p.add_argument("--ckpt", type=str, required=True,
                   help="Checkpoint file (.pt, storm_tpu_torch.ckpt).")
    p.add_argument("--mode", required=True, choices=["storm"])
    p.add_argument("--sampler", type=str, choices=("pc",), default="pc")
    p.add_argument("--predictor", type=str, default="reverse_diffusion",
                   choices=tuple(PREDICTORS))
    p.add_argument("--corrector", type=str, default="ald", choices=tuple(CORRECTORS))
    p.add_argument("--corrector-steps", dest="corrector_steps", type=int, default=1)
    p.add_argument("--snr", type=float, default=0.5)
    p.add_argument("--N", type=int, default=50)
    p.add_argument("--no-ema", action="store_true",
                   help="use raw instead of EMA parameters")
    p.add_argument("--timeit", action="store_true", help="report RTF per file")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    device = torch.device(args.device)
    config, params, ema_params = load_checkpoint(args.ckpt)
    if config.get("mode", "regen-joint-training") not in STORM_MODES:
        raise SystemExit(f"--mode storm incompatible with checkpoint mode {config['mode']}")
    model = build_model(config, device=device)
    model.load_state_dict(params if args.no_ema else ema_params, strict=True)

    noisy_files = sorted(glob.glob(os.path.join(args.test_dir, "*.wav")))
    if not noisy_files:
        raise SystemExit(f"no .wav files in {args.test_dir}")
    os.makedirs(args.enhanced_dir, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(0)

    for f in noisy_files:
        y, sr = load_wav(f)
        if sr != MODEL_SR:
            raise SystemExit(f"{f}: sample rate {sr}, the model needs {MODEL_SR}: resample first")
        y = torch.from_numpy(y[:1]).to(device)  # (1, T), first channel
        t0 = time.perf_counter()
        x_hat, nfe = model.enhance(
            y, N=args.N, predictor=args.predictor, corrector=args.corrector,
            corrector_steps=args.corrector_steps, snr=args.snr, generator=gen,
        )
        x_hat = x_hat[0].cpu().numpy()  # waits for the device
        elapsed = time.perf_counter() - t0
        save_wav(os.path.join(args.enhanced_dir, os.path.basename(f)), x_hat, MODEL_SR)
        if args.timeit:
            rtf = elapsed / (x_hat.shape[-1] / MODEL_SR)
            print(f"{os.path.basename(f)}: nfe={nfe} rtf={rtf:.4f} seconds={elapsed:.3f}")
        else:
            print(os.path.basename(f))


if __name__ == "__main__":
    main()
