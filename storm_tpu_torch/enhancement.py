"""File-to-file StoRM enhancement on the GPU (counterpart of enhancement.py).

    python -m storm_tpu_torch.enhancement --test_dir noisy/ --enhanced_dir out/ \\
        --ckpt model.pt --mode storm [--batch 4] [--stream_chunk_s 2.0] [--device cuda]

Flags and defaults are those of the reference CLI for `--mode storm
--sampler pc`: reverse diffusion with the ald corrector, one corrector step,
snr 0.5, N=50, EMA weights unless `--no-ema`. Every file goes through
`BucketedEnhancer`, zero-padded to a multiple of 64 hops as the reference
pads it, with noise from one torch.Generator seeded with 0.

`--batch k` groups the files by padded length (probed from their WAV
headers) and enhances up to k of a group per call, each call row-padded to k
rows. `--stream_chunk_s s` enhances each file in crossfaded chunks of s
seconds (rounded up to the bucket), 8 chunks per call unless `--batch` sets
another count.

`--dtype` sets the NCSN++ compute dtype: `checkpoint` (the default) keeps
the checkpoint config's, `float32` or `bfloat16` overrides it; parameters
stay float32 either way, and the STFT, the SDE and the sampler run in
float32.

`--quant int8` serves W8A8: activation scales are calibrated on the first 4
files (cut to one chunk in streaming mode; noise from a generator of its
own, seeded with 1, so serving draws the same noise as without it) and cached
beside the checkpoint as `<ckpt>.quant_int8_scales.json`; the convs with at
least `--quant_min_channels` input and output channels then run on the int8
path.
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
from .data.audio import load_wav, save_wav, wav_info
from .models.factory import STORM_MODES, build_model
from .sampling.correctors import CORRECTORS
from .sampling.predictors import PREDICTORS
from .utils.inference import BucketedEnhancer
from .utils.serving import calibrate_or_load_scales
from .utils.streaming import stream_enhance

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
    p.add_argument("--dtype", default="checkpoint", choices=("checkpoint", "float32", "bfloat16"),
                   help="NCSN++ compute dtype: bfloat16 is the reference's production serving "
                        "program; the default keeps the checkpoint's (reference-exact)")
    p.add_argument("--timeit", action="store_true", help="report RTF per file or batch")
    p.add_argument("--batch", type=int, default=1,
                   help="group files by padded-length bucket and enhance up to this many "
                        "per call")
    p.add_argument("--stream_chunk_s", type=float, default=0.0,
                   help="long-form mode: enhance in crossfaded chunks of this many seconds "
                        "(0: whole files)")
    p.add_argument("--stream_overlap_s", type=float, default=0.5,
                   help="crossfaded overlap between streaming chunks")
    p.add_argument("--data_parallel", action="store_true",
                   help="not ported yet (ROADMAP R7): raises")
    p.add_argument("--seq_parallel", type=int, default=0,
                   help="not ported yet (ROADMAP R7): raises when > 1")
    p.add_argument("--quant", default=None, choices=("int8",),
                   help="post-training W8A8 int8 serving: calibrates activation scales on "
                        "the first files, then runs the large NCSN++ convs as int8 x int8 -> "
                        "int32 products (storm_tpu_torch/models/quant.py)")
    p.add_argument("--quant_min_channels", type=int, default=128,
                   help="int8 coverage threshold: convs whose in AND out channel counts are "
                        ">= this run int8; smaller (quality-critical) convs stay float32")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    device = torch.device(args.device)
    config, params, ema_params = load_checkpoint(args.ckpt)
    if config.get("mode", "regen-joint-training") not in STORM_MODES:
        raise SystemExit(f"--mode storm incompatible with checkpoint mode {config['mode']}")
    if args.dtype != "checkpoint":
        config = dict(config, dtype=args.dtype)
    model = build_model(config, device=device)
    model.load_state_dict(params if args.no_ema else ema_params, strict=True)

    noisy_files = sorted(glob.glob(os.path.join(args.test_dir, "*.wav")))
    if not noisy_files:
        raise SystemExit(f"no .wav files in {args.test_dir}")
    os.makedirs(args.enhanced_dir, exist_ok=True)

    def load_checked(path) -> np.ndarray:
        """(T,) float32: the file's first channel."""
        y, sr = load_wav(path)
        if sr != MODEL_SR:
            raise SystemExit(f"{path}: sample rate {sr}, the model needs {MODEL_SR}: resample first")
        return y[0]

    def save(path, x_hat, nfe, elapsed):
        save_wav(os.path.join(args.enhanced_dir, os.path.basename(path)), x_hat, MODEL_SR)
        if args.timeit:
            rtf = elapsed / (x_hat.shape[-1] / MODEL_SR)
            print(f"{os.path.basename(path)}: nfe={nfe} rtf={rtf:.4f} seconds={elapsed:.3f}")
        else:
            print(os.path.basename(path))

    quant = None
    if args.quant == "int8":
        quant = calibrate_or_load_scales(
            model, args.mode, args.ckpt, lambda: [load_checked(f) for f in noisy_files[:4]],
            torch.Generator(device=device).manual_seed(1), N=args.N,
            min_channels=args.quant_min_channels, stream_chunk_s=args.stream_chunk_s,
            params_source="raw" if args.no_ema else "ema", model_sr=MODEL_SR)

    enhancer = BucketedEnhancer(
        model, minibatch=args.batch if args.batch > 1 else None,
        data_parallel=args.data_parallel, seq_parallel=args.seq_parallel, N=args.N,
        predictor=args.predictor, corrector=args.corrector,
        corrector_steps=args.corrector_steps, snr=args.snr, quant=quant)
    gen = torch.Generator(device=device).manual_seed(0)

    if args.stream_chunk_s > 0:
        if enhancer.minibatch is None:
            enhancer.minibatch = 8
        for f in noisy_files:
            y = load_checked(f)
            t0 = time.perf_counter()
            x_hat, nfe = stream_enhance(
                enhancer, y, gen, chunk_samples=int(args.stream_chunk_s * MODEL_SR),
                overlap_samples=int(args.stream_overlap_s * MODEL_SR),
                max_batch=enhancer.minibatch)
            save(f, x_hat, nfe, time.perf_counter() - t0)
        return

    if args.batch <= 1:
        for f in noisy_files:
            y = load_checked(f)
            t0 = time.perf_counter()
            x_hat, nfe = enhancer(y, gen)  # a numpy result: the device is done
            save(f, x_hat, nfe, time.perf_counter() - t0)
        return

    # batched: files grouped by padded length, probed from their headers (the
    # waveforms are loaded one group at a time); the enhancer row-pads each
    # group to --batch rows, one shape per bucket
    buckets = {}
    for f in noisy_files:
        buckets.setdefault(enhancer.padded_len(wav_info(f)[2]), []).append(f)
    for padded, files in sorted(buckets.items()):
        for i in range(0, len(files), args.batch):
            group = files[i: i + args.batch]
            waves = [load_checked(f) for f in group]
            ys = np.stack([np.pad(y, (0, padded - y.shape[-1])) for y in waves])
            t0 = time.perf_counter()
            x_hats, nfe = enhancer(ys, gen)
            elapsed = time.perf_counter() - t0
            for f, y, x_hat in zip(group, waves, x_hats):
                save_wav(os.path.join(args.enhanced_dir, os.path.basename(f)),
                         x_hat[: y.shape[-1]], MODEL_SR)
                print(os.path.basename(f))
            if args.timeit:
                audio_s = sum(y.shape[-1] for y in waves) / MODEL_SR
                print(f"  batch of {len(group)}: nfe={nfe} rtf={elapsed / audio_s:.4f}")


if __name__ == "__main__":
    main()
