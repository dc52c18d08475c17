"""File-to-file enhancement on the GPU (counterpart of enhancement.py).

    python -m storm_tpu_torch.enhancement --test_dir noisy/ --enhanced_dir out/ \\
        --ckpt model.pt --mode storm|score-only|denoiser-only [--batch 4] \\
        [--stream_chunk_s 2.0] [--device cuda]

`--mode` names the model the checkpoint holds: storm (either StoRM training
mode), score-only (SGMSE+: the samplers run around the noisy spec),
denoiser-only (one forward; the sampler flags are ignored, NFE 1) or distill
(the denoiser and the one-step student, NFE 2; the sampler flags are
ignored and `--deepcache` is refused); another checkpoint mode exits with
the reference's message. Flags and defaults are
those of the reference CLI:
`--sampler pc` with reverse diffusion and the ald corrector, one corrector
step, snr 0.5, N=50, EMA weights unless `--no-ema`. `--sampler ode`
integrates the probability-flow ODE with `--ode-method` (default etd2, 2N +
1 score evaluations; rk45 is adaptive under `--rtol` / `--atol` and ignores
N); `--sampler picard` runs `--sweeps` Picard sweeps of it, each one
score-net call on N rows per file. Every file goes through
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
own, seeded with 1, so serving draws the same noise as without it; always
on the pc trajectory, whatever the sampler served) and cached
beside the checkpoint as `<ckpt>.quant_int8_scales.json`; the convs with at
least `--quant_min_channels` input and output channels then run on the int8
path.

`--deepcache K` refreshes the score net's deep U-Net features every K
sampler steps and recomputes only the top `--deepcache_depth` levels per
score evaluation (DeepCache-style, arXiv:2312.00858); 0, the default, is the
exact trajectory. It works with `--sampler pc` and `ode` (not etd2-ms or
rk45), `--batch`, streaming, `--quant int8` and `--dtype bfloat16`; int8
calibration runs the exact trajectory either way.
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
from .models.distill import refuse_deepcache
from .models.factory import SERVING_MODES, build_model, check_checkpoint_mode
from .sampling.correctors import CORRECTORS
from .sampling.predictors import PREDICTORS
from .sampling.samplers import ODE_METHODS
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
    p.add_argument("--mode", required=True, choices=SERVING_MODES,
                   help="storm, score-only (SGMSE+), denoiser-only or distill (the one-step "
                        "student)")
    p.add_argument("--sampler", type=str, choices=("pc", "ode", "picard"), default="pc",
                   help="pc: predictor-corrector (the reference's default); ode: the "
                        "deterministic probability-flow integrator (--ode-method); picard: "
                        "parallel-in-time probability flow (--sweeps)")
    p.add_argument("--predictor", type=str, default="reverse_diffusion",
                   choices=tuple(PREDICTORS),
                   help="pc sampler predictor; etd integrates the OUVE linear drift exactly")
    p.add_argument("--corrector", type=str, default="ald", choices=tuple(CORRECTORS))
    p.add_argument("--corrector-steps", dest="corrector_steps", type=int, default=1)
    p.add_argument("--snr", type=float, default=0.5)
    p.add_argument("--N", type=int, default=50)
    p.add_argument("--ode-method", dest="ode_method", type=str, default="etd2",
                   choices=ODE_METHODS,
                   help="integrator for --sampler ode; rk45 is the adaptive Dormand-Prince "
                        "pair (scipy's RK45 controller): it chooses its own steps from "
                        "--rtol/--atol and ignores --N")
    p.add_argument("--rtol", type=float, default=1e-5,
                   help="relative tolerance for --ode-method rk45")
    p.add_argument("--atol", type=float, default=1e-5,
                   help="absolute tolerance for --ode-method rk45")
    p.add_argument("--sweeps", type=int, default=8, help="Picard sweeps for --sampler picard")
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
    p.add_argument("--deepcache", type=int, default=0,
                   help="deep-feature cache refresh interval for the pc/ode samplers "
                        "(DeepCache-style, arXiv:2312.00858): refresh the score net's deep "
                        "U-Net features every K steps and recompute only the top levels per "
                        "score eval. 0 = off (exact reference trajectory); quality vs K "
                        "measured in BASELINE.md")
    p.add_argument("--deepcache_depth", type=int, default=1,
                   help="number of top U-Net levels recomputed per cached score eval "
                        "(--deepcache)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.mode == "distill":  # NFE 2: no trajectory to cache along
        refuse_deepcache(args.deepcache)
    device = torch.device(args.device)
    config, params, ema_params = load_checkpoint(args.ckpt)
    check_checkpoint_mode(args.mode, config)
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
        sampler_type=args.sampler, predictor=args.predictor, corrector=args.corrector,
        corrector_steps=args.corrector_steps, snr=args.snr, method=args.ode_method,
        rtol=args.rtol, atol=args.atol, sweeps=args.sweeps, quant=quant,
        deepcache=args.deepcache, deepcache_depth=args.deepcache_depth)
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
