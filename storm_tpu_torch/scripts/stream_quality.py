"""What streaming costs in quality: SI-SDR and ESTOI of long utterances
enhanced whole and in crossfaded chunks (counterpart of
scripts/stream_quality.py).

    python -m storm_tpu_torch.scripts.stream_quality --ckpt model.pt [--dur_s 64] \\
        [--n_files 4] [--chunk_s 4] [--overlap_s 0.5] [--batch 8] [--N 30] \\
        [--dtype bfloat16] [--quant int8 --quant_min_channels 128] \\
        [--deepcache 3 --deepcache_depth 1] [--timeit] [--json out.json] [--device cpu]

`--n_files` synthetic pairs of `--dur_s` seconds (the corpus script's
`make_utterance` and `make_noise` at `--snr_db`, drawn from
`np.random.default_rng(--seed)`: the JAX script's pairs) go through the pc
sampler (reverse diffusion, no corrector, `--N` steps) twice: whole, through
`BucketedEnhancer(minibatch=1)`, and streamed, through
`utils/streaming.stream_enhance` in chunks of `--chunk_s` overlapping by
`--overlap_s`, `--batch` chunks per call. The noise of both comes from one
`torch.Generator` seeded with `--seed`, drawn in order (file 0 whole, file 0
streamed, file 1 whole, ...). One JSON row per file and a `SUMMARY` line
with the JAX script's keys.

`--quant int8` calibrates on the first 4 files' first 8 s (one multiple of
64 hops; noise from a generator seeded with `--seed` + 1) and serves both
sides with those scales. `--timeit` streams every file once more afterwards
(noise from `--seed` + 2) and reports audio s per wall s.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ckpt import load_checkpoint
from ..models import quant as quant_mod
from ..models.factory import build_model
from ..utils.inference import BucketedEnhancer
from ..utils.metrics import si_sdr
from ..utils.serving import n_quantized
from ..utils.stoi import stoi
from ..utils.streaming import stream_enhance
from .make_synth_corpus import SR, make_noise, make_utterance


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="Checkpoint file (.pt, storm_tpu_torch.ckpt).")
    ap.add_argument("--dur_s", type=float, default=64.0)
    ap.add_argument("--n_files", type=int, default=4)
    ap.add_argument("--chunk_s", type=float, default=4.0)
    ap.add_argument("--overlap_s", type=float, default=0.5)
    ap.add_argument("--snr_db", type=float, default=5.0)
    ap.add_argument("--N", type=int, default=30)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None)
    ap.add_argument("--quant", default=None, choices=("int8",),
                    help="serve both sides with W8A8 int8, calibrated on 8 s crops of the test "
                         "files")
    ap.add_argument("--quant_min_channels", type=int, default=128)
    ap.add_argument("--deepcache", type=int, default=0,
                    help="deep-feature cache refresh interval K (bench.py's production value: 3)")
    ap.add_argument("--dtype", default="checkpoint",
                    choices=("checkpoint", "float32", "bfloat16"),
                    help="compute dtype: bfloat16 is the production serving program; the "
                         "default keeps the checkpoint's")
    ap.add_argument("--deepcache_depth", type=int, default=1)
    ap.add_argument("--timeit", action="store_true",
                    help="also stream every file once more and report audio s per wall s")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    return ap.parse_args(argv)


def make_pairs(n_files: int, dur_s: float, snr_db: float, seed: int
               ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(clean, noisy) float32 pairs, the JAX script's draws."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n_files):
        x = make_utterance(rng, dur_s)
        n = make_noise(rng, len(x))
        g = np.sqrt((x**2).mean() / ((n**2).mean() * 10 ** (snr_db / 10)))
        pairs.append((x.astype(np.float32), (x + g * n).astype(np.float32)))
    return pairs


def calibrate(model, pairs, args, device) -> dict:
    """StoRM's int8 scales on the first 4 files' first 8 s (rounded up to
    64 hops; shorter files as they are)."""
    hop = model.stft_config.hop_length
    L = -(-8 * SR // (64 * hop)) * (64 * hop)
    y_cal = torch.from_numpy(np.stack([y[:L] for _, y in pairs[:4]])).to(device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    quant = quant_mod.calibrate_storm(model, y_cal, N=10, min_channels=args.quant_min_channels,
                                      generator=gen)
    n_q = n_quantized(quant)
    if n_q == 0:
        raise SystemExit("--quant int8 quantized 0 convs; lower --quant_min_channels")
    print(f"int8 calibration done ({n_q} convs quantized)")
    return quant


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    config, _, ema_params = load_checkpoint(args.ckpt)
    if args.dtype != "checkpoint":
        config = dict(config, dtype=args.dtype)
    model = build_model(config, device=device)
    model.load_state_dict(ema_params, strict=True)

    pairs = make_pairs(args.n_files, args.dur_s, args.snr_db, args.seed)
    quant = calibrate(model, pairs, args, device) if args.quant == "int8" else None
    serve_kw = dict(sampler_type="pc", N=args.N, corrector="none", quant=quant)
    if args.deepcache:
        serve_kw.update(deepcache=args.deepcache, deepcache_depth=args.deepcache_depth)
    # chunks are batched `--batch` per call; the whole side runs B=1 (every
    # call is row-padded to `minibatch`, and 8 rows of 64 s need 8x the memory)
    enhancer = BucketedEnhancer(model, minibatch=args.batch, **serve_kw)
    whole_enhancer = BucketedEnhancer(model, minibatch=1, **serve_kw)
    stream_kw = dict(chunk_samples=int(args.chunk_s * SR),
                     overlap_samples=int(args.overlap_s * SR), max_batch=args.batch)

    rows = []
    gen = torch.Generator(device=device).manual_seed(args.seed)
    for i, (x, y) in enumerate(pairs):
        xw = whole_enhancer(y, gen)[0][: len(x)]
        xs = stream_enhance(enhancer, y, gen, **stream_kw)[0][: len(x)]
        row = {
            "file": i,
            "noisy_sisdr": float(si_sdr(x, y)),
            "whole_sisdr": float(si_sdr(x, xw)),
            "stream_sisdr": float(si_sdr(x, xs)),
            "noisy_estoi": float(stoi(x, y, SR, extended=True)),
            "whole_estoi": float(stoi(x, xw, SR, extended=True)),
            "stream_estoi": float(stoi(x, xs, SR, extended=True)),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    def mean(k):
        return float(np.mean([r[k] for r in rows]))

    stream_tput = None
    if args.timeit:  # every shape ran above; a numpy result is synced
        gen_t = torch.Generator(device=device).manual_seed(args.seed + 2)
        t0, audio = time.perf_counter(), 0.0
        for x, y in pairs:
            stream_enhance(enhancer, y, gen_t, **stream_kw)
            audio += len(x) / SR
        stream_tput = round(audio / (time.perf_counter() - t0), 2)
        print(f"chunked-serving throughput: {stream_tput} audio-s/s")

    summary = {
        "dur_s": args.dur_s, "chunk_s": args.chunk_s,
        "overlap_s": args.overlap_s, "N": args.N,
        "quant": args.quant, "deepcache": args.deepcache,
        "deepcache_depth": args.deepcache_depth if args.deepcache else None,
        "noisy": [mean("noisy_sisdr"), mean("noisy_estoi")],
        "whole": [mean("whole_sisdr"), mean("whole_estoi")],
        "stream": [mean("stream_sisdr"), mean("stream_estoi")],
        "delta_sisdr": mean("stream_sisdr") - mean("whole_sisdr"),
        "delta_estoi": mean("stream_estoi") - mean("whole_estoi"),
        "stream_audio_s_per_s": stream_tput,
    }
    print("SUMMARY " + json.dumps(summary), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return {"rows": rows, "summary": summary}


if __name__ == "__main__":
    main()
