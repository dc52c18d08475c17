"""Quality of a checkpoint over a grid of sampler configurations: SI-SDR and
ESTOI against NFE on the test split (counterpart of scripts/nfe_quality.py).

    python -m storm_tpu_torch.scripts.nfe_quality --ckpt model.pt --base_dir corpus/ \\
        [--num_files 16] [--dtype bfloat16] [--quant int8 --quant_min_channels 32] \\
        [--deepcache 3] [--configs 'pc N=50 ald,ode etd2 N=10'] [--json out.json]

The first `--num_files` files of the test split (`tt` in the wsj0 layout) are
grouped by their bucket's length (`--bucket_frames` hops), shortest first;
each group goes through `BucketedEnhancer` in chunks of `--batch` rows with
noise from one torch.Generator seeded with `--seed`, drawn in order. NFE
counts backbone forwards per call, the denoiser included for StoRM. The
noisy row scores the unprocessed input. A distilled checkpoint runs its one
step (NFE 2) whatever the configuration says.

`--quant int8` calibrates once, on the first 4 files padded to one multiple
of 64 hops (noise from a generator seeded with `--seed` + 1), with the
calibration of the checkpoint's mode, and serves every configuration with
those scales; a run that quantizes no conv exits, since it would measure the
unquantized model. The JSON holds the unrounded means.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..ckpt import load_checkpoint
from ..data.datamodule import SpecsDataModule
from ..models import quant as quant_mod
from ..models.factory import build_model
from ..utils.inference import BucketedEnhancer
from ..utils.metrics import si_sdr
from ..utils.serving import n_quantized
from ..utils.stoi import stoi

SR = 16000
CONFIGS = [
    ("pc N=50 ald", dict(sampler_type="pc", N=50, corrector="ald", corrector_steps=1)),
    ("pc N=50 none", dict(sampler_type="pc", N=50, corrector="none")),
    ("pc N=30 none", dict(sampler_type="pc", N=30, corrector="none")),
    ("ode heun N=20", dict(sampler_type="ode", N=20, method="heun")),
    ("ode etd2 N=20", dict(sampler_type="ode", N=20, method="etd2")),
    ("ode etd2 N=10", dict(sampler_type="ode", N=10, method="etd2")),
    ("ode etd1 N=10", dict(sampler_type="ode", N=10, method="etd1")),
    ("ode etd2-ms N=20", dict(sampler_type="ode", N=20, method="etd2-ms")),
    ("ode etd2-ms N=10", dict(sampler_type="ode", N=10, method="etd2-ms")),
    # the adaptive integrator of the upstream ODE path (scipy's RK45 at
    # rtol = atol = 1e-5); its nfe column is the first call's
    ("ode rk45 tol=1e-5", dict(sampler_type="ode", N=30, method="rk45", rtol=1e-5, atol=1e-5)),
    ("ode rk45 tol=1e-3", dict(sampler_type="ode", N=30, method="rk45", rtol=1e-3, atol=1e-3)),
]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="Checkpoint file (.pt, storm_tpu_torch.ckpt).")
    ap.add_argument("--base_dir", required=True)
    ap.add_argument("--format", default="wsj0")
    ap.add_argument("--num_files", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--bucket_frames", type=int, default=128,
                    help="bucket granularity in hops (coarser: fewer shapes, more padding)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quant", default=None, choices=("int8",),
                    help="serve every configuration with W8A8 int8 (models/quant.py)")
    ap.add_argument("--quant_min_channels", type=int, default=128,
                    help="quantize convs with >= this many in and out channels (128 is "
                         "production; an nf=32 net needs 32, or nothing is quantized)")
    ap.add_argument("--configs", default=None,
                    help="comma-separated substrings: run only the configurations whose name "
                         "contains one (e.g. 'pc N=30,pc N=50 ald')")
    ap.add_argument("--deepcache", type=int, default=0,
                    help="deep-feature cache refresh interval for the pc and ode "
                         "configurations (etd2-ms and rk45 are skipped when set)")
    ap.add_argument("--deepcache_depth", type=int, default=1)
    ap.add_argument("--dtype", default="checkpoint",
                    choices=("checkpoint", "float32", "bfloat16"),
                    help="compute dtype: bfloat16 is the production serving program; the "
                         "default keeps the checkpoint's")
    ap.add_argument("--timeit", action="store_true",
                    help="also time each configuration's batches once more (audio s per s)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    return ap.parse_args(argv)


def calibrate(model, mode: str, ys, args, device) -> dict:
    """int8 scales of the checkpoint's mode on the first 4 files."""
    hop = model.stft_config.hop_length
    L = max(len(y) for y in ys[:4])
    L = -(-L // (64 * hop)) * (64 * hop)
    y_cal = torch.from_numpy(np.stack([np.pad(y, (0, L - len(y))) for y in ys[:4]])
                             .astype(np.float32)).to(device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    mc = args.quant_min_channels
    if mode.startswith("regen"):
        return quant_mod.calibrate_storm(model, y_cal, N=10, min_channels=mc, generator=gen)
    if mode == "score-only":
        return quant_mod.calibrate_score_model(model, y_cal, N=10, min_channels=mc,
                                               generator=gen)
    if mode == "distill":
        return quant_mod.calibrate_distill(model, y_cal, min_channels=mc, generator=gen)
    return quant_mod.calibrate_discriminative(model, y_cal, min_channels=mc)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    device = torch.device(args.device)
    config, _, ema_params = load_checkpoint(args.ckpt)
    if args.dtype != "checkpoint":
        config = dict(config, dtype=args.dtype)
    model = build_model(config, device=device)
    model.load_state_dict(ema_params, strict=True)

    dm = SpecsDataModule(base_dir=args.base_dir, format=args.format)
    dm.setup("test")
    n = min(args.num_files, len(dm.test_set))
    items = [dm.test_set.__getitem__(i, raw=True) for i in range(n)]
    xs = [it[0][0] for it in items]
    ys = [it[1][0] for it in items]
    noisy_sisdr = float(np.mean([si_sdr(x, y) for x, y in zip(xs, ys)]))
    noisy_estoi = float(np.mean([stoi(x, y, SR, extended=True) for x, y in zip(xs, ys)]))
    print(f"{n} test files; noisy: SI-SDR {noisy_sisdr:.2f} dB, ESTOI {noisy_estoi:.3f}")

    quant = None
    if args.quant == "int8":
        quant = calibrate(model, config.get("mode", "regen-joint-training"), ys, args, device)
        n_q = n_quantized(quant)
        if n_q == 0:
            raise SystemExit(f"--quant int8 quantized 0 convs at min_channels="
                             f"{args.quant_min_channels}; lower --quant_min_channels or the "
                             "run would measure the unquantized model")
        print(f"int8 calibration done ({n_q} convs quantized)")

    configs = CONFIGS
    if args.configs:
        pats = [p.strip() for p in args.configs.split(",")]
        configs = [(nm, kw) for nm, kw in CONFIGS if any(p in nm for p in pats)]
    if args.deepcache:
        configs = [(nm, kw) for nm, kw in configs
                   if kw["sampler_type"] in ("pc", "ode")
                   and kw.get("method") not in ("etd2-ms", "rk45")]
    if not configs:
        raise SystemExit("no configs selected (--configs filter"
                         + (" + --deepcache supported-sampler filter" if args.deepcache else "")
                         + " matched nothing)")

    results = []
    for name, kw in configs:
        if quant is not None:
            name += " +int8"
        if args.deepcache:
            name += f" +dc{args.deepcache}"
            kw = dict(kw, deepcache=args.deepcache, deepcache_depth=args.deepcache_depth)
        enhancer = BucketedEnhancer(model, bucket_frames=args.bucket_frames,
                                    minibatch=args.batch, quant=quant, **kw)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        groups = {}
        for i, y in enumerate(ys):
            groups.setdefault(enhancer.padded_len(len(y)), []).append(i)
        x_hats = [None] * n
        nfe = None
        for L, idxs in sorted(groups.items()):
            batch = np.stack([np.pad(ys[i], (0, L - len(ys[i]))) for i in idxs])
            xh, nfe_g = enhancer(batch.astype(np.float32), gen)
            if nfe is None:  # the enhancer sums NFE over its chunks: one call's
                nfe = nfe_g // -(-len(idxs) // args.batch)
            for j, i in enumerate(idxs):
                x_hats[i] = xh[j][: len(ys[i])]
        sisdr = float(np.mean([si_sdr(x, xh) for x, xh in zip(xs, x_hats)]))
        estoi = float(np.mean([stoi(x, xh, SR, extended=True) for x, xh in zip(xs, x_hats)]))
        row = {"config": name, "nfe": int(nfe), "si_sdr": sisdr, "estoi": estoi, **kw}
        if args.timeit:  # every shape has run once above
            t0, audio = time.perf_counter(), 0.0
            for L, idxs in sorted(groups.items()):
                batch = np.stack([np.pad(ys[i], (0, L - len(ys[i]))) for i in idxs])
                enhancer(batch.astype(np.float32), gen)  # a numpy result: synced
                audio += sum(len(ys[i]) for i in idxs) / SR
            row["audio_s_per_s"] = audio / (time.perf_counter() - t0)
        results.append(row)
        print(f"{name:18s} nfe={nfe:4d}  SI-SDR {sisdr:6.2f} dB  ESTOI {estoi:.3f}"
              + (f"  {row['audio_s_per_s']:.2f} audio-s/s" if args.timeit else ""), flush=True)

    tcol = " audio-s/s |" if args.timeit else ""
    print("\n| config | NFE | SI-SDR (dB) | ESTOI |" + tcol)
    print("|---|---|---|---|" + ("---|" if tcol else ""))
    print(f"| noisy input | — | {noisy_sisdr:.2f} | {noisy_estoi:.3f} |"
          + (" — |" if tcol else ""))
    for r in results:
        print(f"| {r['config']} | {r['nfe']} | {r['si_sdr']:.2f} | {r['estoi']:.3f} |"
              + (f" {r['audio_s_per_s']:.2f} |" if tcol else ""))
    out = {"noisy": {"si_sdr": noisy_sisdr, "estoi": noisy_estoi}, "results": results,
           "num_files": n}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"wrote {args.json}")
    return out


if __name__ == "__main__":
    main()
