"""Throughput benchmark of the port on one card (counterpart of bench.py).

    python -m storm_tpu_torch.bench [--batch 16] [--frames 256] [--N 50] \\
        [--quant int8|none] [--deepcache 3] [--dtype bfloat16] [--train] [--device cuda]

Primary metric: audio seconds enhanced per wall-clock second on one card
at 50-step PC sampling with the reference CLI's sampler (reverse-diffusion
predictor and one ald corrector step: NFE 101), in the reference bench's
production configuration: bfloat16 compute, W8A8 int8 convs and deep-feature
caching at interval 3 (`--quant none`, `--deepcache 0` and `--dtype float32`
measure the others). The weights are random, drawn from a fixed seed: the
program, not its weights, sets the time. y is 0.1 x standard normal from
`np.random.default_rng(0)`; int8 scales are calibrated on y[:4] with
N = min(N, 10) and 4 probes, as the reference bench does. One warm-up call,
then `--reps` timed calls, each with its own seeded generator and ending
with the output's copy to the host (the sync); the wall is the fastest rep.
On a card every call is the replay of its captured CUDA graph
(`utils/graphs.graphed_enhance`), as the reference times its jitted
program: the warm-up call makes it (`warm_up`: the eager loop, then the
capture).

Extras in `detail`, run while the wall clock since the start is under
STORM_TPU_BENCH_BUDGET_S (default 1800 s; a malformed value falls back to
it): the model's own schedule (N=30, no corrector, NFE 31) and, when the
headline caches, the exact trajectory (`deepcache` 0) at the same schedule.
The variable and its fallback are bench.py's, so that a caller that runs
either bench under a wall-clock limit sets one budget for both.

`program_tflops` is counted once, on the warm-up call, outside the timed
region (on a card the warm-up runs the body twice, eagerly and then under
capture, and the count is halved): 2 x the multiply-adds of every convolution and matrix product the
call runs (NCSN++'s convolutions, its attention and dense layers, the
STFT's DFT), from their shapes, whatever computes them: float32, bfloat16
or the int8 product (`torch._int_mm`), cuDNN or the port's own kernels.
`torch.utils.flop_counter.FlopCounterMode` counts the torch operators, with
the int8 product's formula added to it. Not counted, on either device:
upfirdn2d's FIR taps (4 or 16 per output, a small share of the convs' work)
and elementwise work (GroupNorm, activations, the quantizer).
`achieved_tflops_per_s` is that count over the wall.

`--train` measures the joint training step at B = `--batch`, `--frames`
frames and `--dtype` instead: the fastest of `--reps` runs of 5 steps, each
synced by reading the loss. `--profile DIR` writes a torch.profiler trace of
the timed region to DIR/bench_trace.json.

`vs_baseline` is the ratio against the north-star of 10x real time per
chip (BASELINE.json), as in the reference bench; no TPU figure applies to
the port. `--distill` measures the distilled one-step program instead (NFE
2: the denoiser and the student; int8 scales from `calibrate_distill`, no
deepcache), one warm-up and `--reps` timed calls, under the reference's
metric name `audio_sec_per_sec_per_chip_distill_nfe2`. Backbones other than
ncsnpp are not ported and raise, naming their ROADMAP item.

Prints ONE JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .models.base import init_train_state
from .models.factory import build_model
from .models.distill import DistilledModel
from .models.quant import calibrate_distill, calibrate_storm, num_quantized_convs
from .utils.graphs import graphed_enhance, programs_of

SR = 16000
TARGET = 10.0  # the north-star: >= 10x real time per chip
BUDGET_ENV, BUDGET_DEFAULT_S = "STORM_TPU_BENCH_BUDGET_S", 1800.0
TRAIN_STEPS_PER_REP = 5


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--frames", type=int, default=256,
                    help="STFT frames per utterance (256 ~ 2.04 s)")
    ap.add_argument("--N", type=int, default=50, help="reverse steps")
    ap.add_argument("--corrector", default="ald")
    ap.add_argument("--corrector-steps", dest="corrector_steps", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--train", action="store_true",
                    help="measure training throughput (joint StoRM step) instead of enhancement")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the timed region to "
                         "DIR/bench_trace.json")
    ap.add_argument("--nf", type=int, default=None,
                    help="override backbone width (default: full 27.8M)")
    ap.add_argument("--backbone", default="ncsnpp",
                    help="backbone of both nets; only ncsnpp is ported (ROADMAP R4)")
    ap.add_argument("--quant", default="int8", choices=["none", "int8"],
                    help="serving quantization (default int8 W8A8; 'none' serves the nets in "
                         "--dtype)")
    ap.add_argument("--deepcache", type=int, default=3,
                    help="deep-feature cache refresh interval (DeepCache-style, "
                         "arXiv:2312.00858); default 3, the production serving config; "
                         "0 = exact")
    ap.add_argument("--deepcache_depth", type=int, default=1)
    ap.add_argument("--distill", action="store_true",
                    help="measure distilled one-step serving (NFE 2: the denoiser and the "
                         "one-shot student, models/distill.py) instead of the N-step sampler; "
                         "the time does not depend on the weights, so random ones measure the "
                         "program a trained student serves")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    return ap.parse_args(argv)


def extras_budget_s() -> float:
    """The soft wall-clock budget of the optional extras; a malformed value
    falls back to the default instead of killing the primary measurement."""
    raw = os.environ.get(BUDGET_ENV, str(BUDGET_DEFAULT_S))
    try:
        return float(raw)
    except ValueError:
        print(f"warning: ignoring malformed {BUDGET_ENV}={raw!r}; using {BUDGET_DEFAULT_S:g}",
              file=sys.stderr)
        return BUDGET_DEFAULT_S


def _int_mm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """torch._int_mm (M, K) x (K, N): 2 x M x N x K, as FlopCounterMode counts mm."""
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


def program_flops():
    """A FlopCounterMode that counts the operations of the convolutions and
    matrix products run inside it, from their shapes (see the module
    docstring); `get_total_flops()` after the block."""
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False,
                           custom_mapping={torch.ops.aten._int_mm: _int_mm_flops})


@contextlib.contextmanager
def profiled(directory: Optional[str], device: torch.device):
    """A torch.profiler trace of the block written to DIR/bench_trace.json,
    or nothing without a directory."""
    if not directory:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])
    os.makedirs(directory, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(directory, "bench_trace.json"))


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def bench_train(args, model, device: torch.device) -> dict:
    """The joint training step's throughput at (batch, frames) in --dtype."""
    model.train()
    state = init_train_state(model, model.lr)
    gen = generator(device, 1)
    shape = (args.batch, model.stft_config.n_fft // 2 + 1, args.frames, 2)
    batch = (0.1 * torch.randn(shape, generator=gen, device=device),
             0.1 * torch.randn(shape, generator=gen, device=device))
    aux = model.train_step(state, batch, gen)  # warm-up at the same shapes
    float(aux["loss"])
    times = []
    with profiled(args.profile, device):
        for _ in range(args.reps):
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS_PER_REP):
                aux = model.train_step(state, batch, gen)
            float(aux["loss"])  # the sync
            times.append((time.perf_counter() - t0) / TRAIN_STEPS_PER_REP)
    wall = min(times)
    return {
        "metric": "train_utt_per_sec_per_chip",
        "value": round(args.batch / wall, 2),
        "unit": "utterances/s/chip",
        "vs_baseline": None,
        "detail": {
            "batch": args.batch, "frames": args.frames, "step_ms": round(wall * 1000, 1),
            "dtype": args.dtype, "backend": device.type, "device_name": device_name(device),
            "backbone": args.backbone,
        },
    }


def bench_distill(args, model, device: torch.device) -> dict:
    """Distilled one-step serving (NFE 2) at (batch, frames) in --dtype, int8
    scales from `calibrate_distill` on y[:4] (bench.py:173-200)."""
    num_samples = (args.frames - 1) * model.stft_config.hop_length
    audio_sec = args.batch * num_samples / SR
    y = torch.from_numpy((np.random.default_rng(0).standard_normal((args.batch, num_samples))
                          * 0.1).astype(np.float32)).to(device)
    quant = None
    if args.quant == "int8":
        quant = calibrate_distill(model, y[:4], generator=generator(device, 7))
        print("int8-quantized convs (distill): "
              f"{({k: num_quantized_convs(v) for k, v in quant.items()})}", file=sys.stderr)

    def enhance(seed: int, warm_up: bool = False) -> int:
        x_hat, nfe = graphed_enhance(model, y, generator(device, seed), warm_up=warm_up,
                                     quant=quant)
        x_hat.cpu()  # the output's copy to the host is the sync
        return nfe

    enhance(1, warm_up=True)
    times = []
    with profiled(args.profile, device):
        for i in range(args.reps):
            t0 = time.perf_counter()
            nfe = enhance(i + 2)
            times.append(time.perf_counter() - t0)
    wall = min(times)
    value = audio_sec / wall
    return {
        "metric": "audio_sec_per_sec_per_chip_distill_nfe2",
        "value": round(value, 2),
        "unit": "audio-sec/s/chip",
        "vs_baseline": round(value / TARGET, 3),
        "detail": {
            "batch": args.batch, "nfe": int(nfe), "wall_s": round(wall, 4),
            "dtype": args.dtype, "quant": args.quant, "backend": device.type,
            "device_name": device_name(device),
        },
    }


def bench_serving(args, model, device: torch.device, budget_s: float, t_start: float) -> dict:
    """Enhancement throughput at bench.py's schedule and configuration."""
    def extras_allowed() -> bool:
        return time.perf_counter() - t_start < budget_s

    hop = model.stft_config.hop_length
    num_samples = (args.frames - 1) * hop  # the reference's crop formula
    audio_sec = args.batch * num_samples / SR
    y = torch.from_numpy((np.random.default_rng(0).standard_normal((args.batch, num_samples))
                          * 0.1).astype(np.float32)).to(device)

    quant = None
    if args.quant == "int8":
        quant = calibrate_storm(model, y[:4], N=min(args.N, 10), num_probe=4,
                                generator=generator(device, 7))
        print(f"int8-quantized convs: {({k: num_quantized_convs(v) for k, v in quant.items()})}",
              file=sys.stderr)

    def enhance(seed: int, warm_up: bool = False, **overrides):
        kw = dict(N=args.N, corrector=args.corrector, corrector_steps=args.corrector_steps,
                  quant=quant, deepcache=args.deepcache, deepcache_depth=args.deepcache_depth)
        kw.update(overrides)
        x_hat, nfe = graphed_enhance(model, y, generator(device, seed), warm_up=warm_up, **kw)
        x_hat.cpu()  # the output's copy to the host is the sync
        return nfe

    def timed(first_seed: int, warmup_ctx=contextlib.nullcontext(),
              timed_ctx=contextlib.nullcontext(), **overrides):
        """(the fastest of --reps calls after a warm-up call, nfe); the
        warm-up (which captures the program) runs inside `warmup_ctx`, the
        timed calls inside `timed_ctx`."""
        with warmup_ctx:
            enhance(first_seed - 1, warm_up=True, **overrides)
        times = []
        with timed_ctx:
            for i in range(args.reps):
                t0 = time.perf_counter()
                nfe = enhance(first_seed + i, **overrides)
                times.append(time.perf_counter() - t0)
        return min(times), nfe

    # the warm-up runs the program's body once eagerly and, on a card, once
    # more to capture it: the same operators twice
    progs = programs_of(model)
    captures = progs.stats["captures"]
    counter = program_flops()
    wall, nfe = timed(2, warmup_ctx=counter, timed_ctx=profiled(args.profile, device))
    flops = counter.get_total_flops() // (1 + progs.stats["captures"] - captures)

    # the model's own serving schedule (N=30, no corrector, NFE 31)
    nfe31 = None
    if args.N == 50 and args.corrector == "ald" and extras_allowed():
        try:
            nfe31 = round(audio_sec / timed(100, N=30, corrector="none")[0], 2)
        except Exception as e:  # an extra must not sink the headline; say why it is missing
            print(f"nfe31 measurement skipped: {type(e).__name__}: {e}", file=sys.stderr)

    # the exact trajectory at the same schedule, when the headline caches
    exact = None
    if args.deepcache and extras_allowed():
        try:
            exact = round(audio_sec / timed(201, deepcache=0)[0], 2)
        except Exception as e:
            print(f"exact-trajectory measurement skipped: {type(e).__name__}: {e}",
                  file=sys.stderr)

    value = audio_sec / wall
    return {
        "metric": "audio_sec_per_sec_per_chip_50step_pc",
        "value": round(value, 2),
        "unit": "audio-sec/s/chip",
        "vs_baseline": round(value / TARGET, 3),
        "detail": {
            "batch": args.batch,
            "utt_sec": round(num_samples / SR, 3),
            "N": args.N,
            "nfe": int(nfe),
            "wall_s": round(wall, 4),
            "rtf_inv": round(value / args.batch, 2),
            "dtype": args.dtype,
            "backend": device.type,
            "device_name": device_name(device),
            "storm_default_nfe31_audio_sec_per_sec": nfe31,
            "exact_nfe101_audio_sec_per_sec": exact,
            "quant": args.quant,
            "deepcache": args.deepcache,
            "deepcache_depth": args.deepcache_depth,
            "backbone": args.backbone,
            "program_tflops": round(flops / 1e12, 3),
            "achieved_tflops_per_s": round(flops / wall / 1e12, 2),
        },
    }


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    t_start = time.perf_counter()
    if args.backbone != "ncsnpp":
        raise NotImplementedError(f"--backbone {args.backbone}: only ncsnpp is ported yet "
                                  "(ROADMAP R4)")
    budget_s = extras_budget_s()
    config = {"mode": "regen-joint-training", "dtype": args.dtype}
    if args.nf:
        config["nf"] = args.nf
    model = build_model(config, device=args.device, seed=0)
    device = next(model.parameters()).device
    if args.train:
        line = bench_train(args, model, device)
    elif args.distill:
        line = bench_distill(args, DistilledModel(model), device)
    else:
        line = bench_serving(args, model, device, budget_s, t_start)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
