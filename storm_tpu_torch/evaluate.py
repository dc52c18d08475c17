"""Test-set evaluation on the GPU: PESQ, SI-SDR and ESTOI per test file, with
their means and 95% confidence intervals, and WER on TIMIT (counterpart of
evaluate.py).

    python -m storm_tpu_torch.evaluate --ckpt model.pt --mode storm --base_dir corpus/ \\
        [--format wsj0|timit|...] [--N 50 --sampler pc|ode ...] [--csv out.csv] \\
        [--wer --asr_cmd 'whisper-cli {wav}'] [--device cuda]

Flags and defaults are the reference CLI's. The test split's files are
grouped by their padded length (read from the WAV headers), shortest bucket
first, and each group goes through `BucketedEnhancer` in chunks of
`--batch` rows, with noise from one torch.Generator seeded with `--seed`
(int8 calibration, on the first 4 files, from its own seeded `--seed` + 1).
Each file prints a line of its metrics; then `--- mean +/- 95% CI ---` and a
line per metric; `--csv` writes the per-file rows. PESQ is NaN without the
`pesq` package. A checkpoint of D > 1 spatial channels enhances each test
pair's first D channels and scores the first (evaluate.py:123).

`--wer` evaluates the TIMIT layout's test split with its transcripts: each
enhanced file is written to a temporary WAV and transcribed by `--asr_cmd`,
a shell command whose `{wav}` placeholder is replaced by the file's quoted
path and whose standard output is the hypothesis (600 s per call).

`--mode` is storm, score-only (SGMSE+), denoiser-only or distill (the
one-step student, NFE 2), the checkpoint's own.
"""
from __future__ import annotations

import argparse
import csv
import os
import shlex
import subprocess
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from .ckpt import load_checkpoint
from .data.audio import save_wav, wav_info
from .data.datamodule import SpecsAndTranscriptionsDataModule, SpecsDataModule
from .models.base import spatial_channels
from .models.distill import refuse_deepcache
from .models.factory import SERVING_MODES, build_model, check_checkpoint_mode
from .sampling.correctors import CORRECTORS
from .sampling.predictors import PREDICTORS
from .sampling.samplers import ODE_METHODS
from .utils.inference import BucketedEnhancer
from .utils.metrics import Method, pesq_wb, si_sdr, wer
from .utils.serving import calibrate_or_load_scales, load_gagnet_batch_stats
from .utils.stoi import stoi

MODEL_SR = 16000
ASR_TIMEOUT_S = 600


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="Checkpoint file (.pt, storm_tpu_torch.ckpt).")
    ap.add_argument("--mode", required=True, choices=SERVING_MODES,
                    help="storm, score-only (SGMSE+), denoiser-only or distill (the one-step "
                         "student)")
    ap.add_argument("--base_dir", required=True)
    ap.add_argument("--format", default="wsj0",
                    choices=["wsj0", "vctk", "dns", "reverb_wsj0", "timit", "voicebank"])
    ap.add_argument("--num_files", type=int, default=0, help="cap on test files (0 = all)")
    ap.add_argument("--sampler", choices=("pc", "ode"), default="pc")
    ap.add_argument("--predictor", default="reverse_diffusion", choices=tuple(PREDICTORS))
    ap.add_argument("--corrector", choices=tuple(CORRECTORS), default="ald")
    ap.add_argument("--corrector-steps", dest="corrector_steps", type=int, default=1)
    ap.add_argument("--snr", type=float, default=0.5)
    ap.add_argument("--N", type=int, default=50)
    ap.add_argument("--ode-method", dest="ode_method", default="etd2",
                    choices=tuple(m for m in ODE_METHODS if m != "rk45"))
    ap.add_argument("--batch", type=int, default=8,
                    help="enhancement minibatch per length bucket")
    ap.add_argument("--quant", default=None, choices=("int8",),
                    help="evaluate int8 W8A8 serving (the enhancement CLI's calibration "
                         "and scale cache)")
    ap.add_argument("--quant_min_channels", type=int, default=128,
                    help="int8 coverage threshold (see the enhancement CLI)")
    ap.add_argument("--deepcache", type=int, default=0,
                    help="deep-feature cache refresh interval for the pc/ode samplers; 0 = off")
    ap.add_argument("--deepcache_depth", type=int, default=1)
    ap.add_argument("--dtype", default="checkpoint", choices=("checkpoint", "float32", "bfloat16"),
                    help="NCSN++ compute dtype; the default keeps the checkpoint's")
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--csv", default=None, help="write per-file metrics here")
    ap.add_argument("--wer", action="store_true",
                    help="also compute WER (timit-format transcriptions/ and --asr_cmd)")
    ap.add_argument("--asr_cmd", default=None,
                    help="shell command with a {wav} placeholder whose stdout is the "
                         "transcript of that wav")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    return ap


def transcribe(asr_cmd: str, x_hat: np.ndarray) -> str:
    """`asr_cmd`'s standard output for `x_hat` written to a temporary WAV."""
    with tempfile.NamedTemporaryFile(suffix=".wav", delete=False) as f:
        wav_path = f.name
    try:
        save_wav(wav_path, x_hat, MODEL_SR)
        cmd = asr_cmd.format(wav=shlex.quote(wav_path))
        return subprocess.run(cmd, shell=True, capture_output=True, text=True,
                              timeout=ASR_TIMEOUT_S).stdout.strip()
    finally:
        os.unlink(wav_path)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_argparser().parse_args(argv)
    if args.mode == "distill":  # NFE 2: no trajectory to cache along
        refuse_deepcache(args.deepcache)
    if args.wer and not args.asr_cmd:
        raise SystemExit("--wer requires --asr_cmd")
    device = torch.device(args.device)
    config, params, ema_params = load_checkpoint(args.ckpt)
    check_checkpoint_mode(args.mode, config)
    if args.dtype != "checkpoint":
        config = dict(config, dtype=args.dtype)
    model = build_model(config, device=device)
    model.load_state_dict(params if args.no_ema else ema_params, strict=True)

    D = spatial_channels(model)
    if args.wer:
        dm = SpecsAndTranscriptionsDataModule(base_dir=args.base_dir, format="timit",
                                              spatial_channels=D)
    else:
        dm = SpecsDataModule(base_dir=args.base_dir, format=args.format, spatial_channels=D)
    dm.setup("test")
    test_set = dm.test_set
    n = len(test_set) if not args.num_files else min(args.num_files, len(test_set))
    print(f"evaluating {n} test files from {args.base_dir}")

    def wave(y: np.ndarray) -> np.ndarray:
        """A raw item's noisy (C, T) as the model takes it: (D, T), or (T,) for D = 1."""
        return y if D > 1 else y[0]

    quant = None
    if args.quant == "int8":
        quant = calibrate_or_load_scales(
            model, args.mode, args.ckpt,
            lambda: [wave(test_set.__getitem__(i, raw=True)[1]) for i in range(min(4, n))],
            torch.Generator(device=device).manual_seed(args.seed + 1), N=args.N,
            min_channels=args.quant_min_channels,
            params_source="raw" if args.no_ema else "ema", model_sr=MODEL_SR)

    enhancer = BucketedEnhancer(
        model, minibatch=args.batch, N=args.N, sampler_type=args.sampler,
        predictor=args.predictor, corrector=args.corrector,
        corrector_steps=args.corrector_steps, snr=args.snr, method=args.ode_method,
        quant=quant, batch_stats=load_gagnet_batch_stats(args.ckpt, model),
        deepcache=args.deepcache, deepcache_depth=args.deepcache_depth)
    generator = torch.Generator(device=device).manual_seed(args.seed)

    metrics = ["pesq", "si_sdr", "estoi"] + (["wer"] if args.wer else [])
    method = Method(name=args.mode, base_dir=args.base_dir, metrics=metrics)
    rows = [None] * n

    def score_one(i, x0, x_hat0, transcription):
        row = {"file": os.path.basename(test_set.clean_files[i]),
               "pesq": pesq_wb(MODEL_SR, x0, x_hat0),
               "si_sdr": si_sdr(x0, x_hat0),
               "estoi": stoi(x0, x_hat0, MODEL_SR, extended=True)}
        if args.wer:
            hyp = transcribe(args.asr_cmd, x_hat0)
            row["wer"] = wer(transcription.lower().split(), hyp.lower().split())
        for m in metrics:
            method.append(m, row[m])
        rows[i] = row
        print(" ".join([row["file"]] + [f"{m}={row[m]:.3f}" for m in metrics]), flush=True)

    # files grouped by padded length, probed from their headers; waveforms
    # are loaded one chunk at a time
    buckets = {}
    for i in range(n):
        buckets.setdefault(enhancer.padded_len(wav_info(test_set.noisy_files[i])[2]),
                           []).append(i)
    for padded, idxs in sorted(buckets.items()):
        for s in range(0, len(idxs), args.batch):
            group = idxs[s: s + args.batch]
            items = [test_set.__getitem__(i, raw=True) for i in group]
            ys = [wave(it[1]) for it in items]
            y_batch = np.stack([np.pad(y, [(0, 0)] * (y.ndim - 1) + [(0, padded - y.shape[-1])])
                                for y in ys])
            x_hats, _ = enhancer(y_batch.astype(np.float32), generator)
            for j, i in enumerate(group):
                x_hat = x_hats[j][..., : ys[j].shape[-1]]
                # the metrics take the first channel (evaluate.py:123, 232-234)
                score_one(i, items[j][0][0], x_hat[0] if D > 1 else x_hat,
                          items[j][2] if args.wer else None)

    print("--- mean +/- 95% CI ---")
    for m in metrics:
        mean, h = method.get_mean_ci(m)
        print(f"{m}: {mean:.3f} +/- {h:.3f}")

    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["file"] + metrics)
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {args.csv}")


if __name__ == "__main__":
    main()
