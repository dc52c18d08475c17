"""Smoke run of the PyTorch port (storm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off.
2. build: every CUDA source of the port with nvcc (sm_90a), timed.
3. kernel against plain: upfirdn2d at every shape the full-width main path
   gives it (4 s request: 256 bins x 576 frames, B=1: the wave padded to its
   bucket of 64 hops, 65536 samples, 513 frames padded to 576), with the NCSN++ FIR and
   with an asymmetric one, held to atol = rtol = 1e-5 against the plain
   PyTorch version; kernel, plain and library-call times (CUDA events, back to
   back: a small call shows the host's enqueue cost) and the kernel's device
   time (`device_ms`, from profiler kernel events, each call after a read
   that clears the L2) beside the memory bound.
   The same check, untimed, at the widths of the shorter files (192 and 384
   frames).
4. full-width NCSN++: one 27.8M score-net forward through the kernel and
   through the plain version, same weights, held to 1e-4 of the output scale.
5. main path: the full-width StoRM model (2 x 27.8M, seeded random weights)
   saved as a checkpoint and run through `python -m storm_tpu_torch.enhancement`
   (CLI defaults: pc, reverse_diffusion, ald, N=50) on three synthesized 16 kHz
   files of 1, 2.5 and 4 s; outputs must be finite and as long as the inputs,
   and upfirdn2d must have launched 18 times per NCSN++ forward.

6. (with `--profile`) one enhancement of the 4 s file traced with
   torch.profiler: the device time by kernel and the device's busy share.
7. kernels against plain at a train step's shapes (B=8, 256 bins x 256
   frames, which validation shares): the forward output at every forward
   shape, and the gradient at every backward shape from
   `torch.autograd.grad` through the kernel path (forward and backward
   kernels) against PyTorch's autograd of the plain version, NCSN++ and
   asymmetric FIRs, atol = rtol = 1e-5; backward kernel (event and device
   time), plain backward and library-call times beside the memory bound.
8. training: (a) one full-width step's gradients (B=2, same weights, t, z
   and batch) through the kernels against the plain path, with cuDNN
   deterministic; (b) `python -m storm_tpu_torch.train` for 8 steps at B=8
   on a synthesized wsj0-layout corpus: finite losses, parameters and EMA
   moved, `last.pt` and `best_loss.pt` written, exactly 36 forward and 33
   backward upfirdn2d launches per step; ms per step (CUDA events, no sync
   added to the trainer's loop), audio seconds trained per second and peak
   memory; (c) the written checkpoint enhances one file
   through `python -m storm_tpu_torch.enhancement` at N=2.
9. (with `--profile`) two full-width train steps traced with torch.profiler.
10. int8 quantizer (K3) against plain: activation scales calibrated on the
   4 s file, then the input of every quantized conv of one denoiser and one
   score forward at the 4 s request's width (110 calls, f32), with exact .5
   ties and values beyond +-127 written in; the codes must be identical.
   Kernel (event and device time) and plain times per input shape beside the
   memory bound (5 B per element). The same at the probe's shape, (16*256*256, 128) bf16, s = 12.7
   (3 B per element), and with bf16 ties at s = 2. The record's error is
   the largest |kernel code - plain code| over all these inputs.
11. int8 main path: `python -m storm_tpu_torch.enhancement --quant int8` on
   phase 5's checkpoint and files: the first run calibrates and writes the
   scale cache, the second loads it; outputs finite and as long as the
   inputs; per file exactly 55 + 55 x 100 = 5555 quantizer launches and 18
   upfirdn2d launches per forward (calibration runs with quantization off:
   no quantizer launch, 18 per calibration forward). Then, with cuDNN
   deterministic and the same noise, the 4 s file's int8 output through the
   kernel against the same path with the plain quantizer (<= 1e-6 of the
   output's scale), and each file's int8 output against float32; RTF int8
   against float32 (phase 5).
12. fused_leaky_relu (K2) through its op API at (8, 256, 256, 128) and
   (3, 17, 33, 6): forward against the plain version at atol = rtol = 1e-6,
   and both gradients (torch.autograd.grad) equal to autograd of the plain
   version's, bit for bit; kernel (event and device time) and plain times
   beside the memory bound (8 B per element).
13. (with `--profile`) one int8 enhancement of the 4 s file traced.
14. batched CLI: `python -m storm_tpu_torch.enhancement --batch 4 --timeit` at
   the CLI defaults on 8 files of 1.0-4.0 s, two length buckets of 4: outputs
   finite and as long as the inputs, exactly 18 x 101 upfirdn2d launches per
   batch call; upfirdn2d against plain at every shape the batches gave it;
   one batch with injected noise against each of its rows enhanced alone with
   that row's noise (N=5, 1e-4 of the row's scale).
15. HTTP server: `storm_tpu_torch.serve --dtype float32` built in this process
   (port 0, --batch 4, --N 10, both traffic buckets warmed at every row
   size); 12 requests of
   1-4 s from 8 client threads: every reply 200, a finite WAV of the input's
   length, X-NFE = 21; /stats: 12 requests, 0 errors, a batch of more than one
   row; exactly 18 x 21 upfirdn2d launches per warm-up call and batch. Then
   with --quant int8 --calib_dir on 8 requests: 55 x 21 quantizer launches per
   warm-up call and batch (calibration launches none). Prints throughput
   (audio s per wall s), latency p50 / p95 / max (over 12 requests the p95
   lies between the two slowest: smoke readings, not a serving baseline),
   batch fill and device_s; both kernels against plain at every shape the
   server gave them.
16. streaming: `--stream_chunk_s 2.0 --stream_overlap_s 0.5 --N 10` on one 12 s
   file, f32 then int8 (the scale cache records stream_chunk_s 2.0): output
   finite and as long as the input, 18 x 21 upfirdn2d launches per call of 8
   chunks (B=8, 256 x 320) and, int8, 55 x 21 quantizer launches per call;
   upfirdn2d against plain at every shape both runs gave it, the quantizer's
   codes at every input shape the int8 run gave it.
17. (with `--profile`) one B=4 enhancement at the 4 s bucket traced.
18. bfloat16 kernels: upfirdn2d at every main-path shape (B=1, 576 frames)
   against plain, within 1 ulp of each element (NCSN++'s FIR: equal; an
   asymmetric FIR's inexact products add their float32 rounding), the
   elements that differ counted; kernel (event and L2-cold device time),
   plain and bf16 library-call times beside the 2 B-per-element bound. The
   adjoint's bf16 instance at every train-step backward shape. GroupNorm on
   bf16 with float32 scale and bias against float32 GroupNorm rounded once.
   One full-width NCSN++ forward in bf16 through the kernel and the plain
   version, and its time against float32's.
19. `python -m storm_tpu_torch.enhancement --dtype bfloat16` at the CLI
   defaults on phase 5's three files, with `--batch 4` on phase 14's eight,
   and with `--quant int8`: exact launch counts (18 upfirdn2d and, int8, 55
   quantizer launches per forward), every launch in bf16, RTF, and
   max|bf16 - f32| / max|f32| against the float32 runs on the same files
   and seed; upfirdn2d against plain at every shape the runs gave it.
20. the quantizer's bf16-product mode at every quantized-conv input of one
   int8 bf16 forward of each net (110 calls), ties of the bf16 product
   written in: codes identical to plain; per-shape times for the score net;
   and at every input shape of phase 19's int8 run.
21. the HTTP server at its default dtype, bfloat16, then int8 + bf16, on
   phase 15's burst: replies, launch counts, /healthz's dtype, both kernels
   against plain at every shape the servers gave them.
22. streaming in bf16 on phase 16's file: launch counts, K1 at its shapes.
23. (with `--profile`) one bf16 enhancement of the 4 s file traced: the
   shares of convolutions, layout transforms, GroupNorm statistics,
   elementwise kernels and K1.

A profile's kernel times come from its device events, each counted once;
shares are of the summed kernel time. The busy time is the union of the
kernels' intervals, which kernels running side by side on several streams
(cuDNN's FFT convolutions in a train step) do not count twice. A profile
fails if K1's or K3's wrapper counted launches in the traced window and one
of their groups (kernel-name stems: K1's down and up configurations) matches
no device event, or if the groups' events fall short of 95% of the counted
launches or exceed them.

The line before the last holds the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import functools
import http.client
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from storm_tpu_torch import enhancement, serve, train
from storm_tpu_torch.backbones.ncsnpp import NCSNpp, count_parameters
from storm_tpu_torch.ckpt import load_training_checkpoint, save_checkpoint
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.kernels import build
from storm_tpu_torch.kernels import fused_act as kfa
from storm_tpu_torch.kernels import quant as kq
from storm_tpu_torch.kernels import upfirdn as kup
from storm_tpu_torch.models import quant as quant_mod
from storm_tpu_torch.models.base import init_train_state
from storm_tpu_torch.models.factory import build_model, resolve_device
from storm_tpu_torch.models.storm import StochasticRegenerationModel
from storm_tpu_torch.nn import qconv, resample
from storm_tpu_torch.nn.cast import cast_params
from storm_tpu_torch.nn.init import reset_parameters
from storm_tpu_torch.nn.layers import group_norm
from storm_tpu_torch.signal.transforms import pad_spec_amount
from storm_tpu_torch.utils.inference import BucketedEnhancer
from storm_tpu_torch.utils.server import decode_wav_bytes, encode_wav_bytes
from storm_tpu_torch.utils.serving import n_quantized, scale_cache_path

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

NF, CH_MULT = 128, (1, 2, 2, 2)
SR, HOP = 16000, 128
BUCKET = 64 * HOP  # BucketedEnhancer pads every waveform to a multiple of 64 hops


def bucket_frames(samples: int) -> int:
    """NCSN++ input width of a wave of `samples`, as BucketedEnhancer gives
    it: the wave padded to its bucket, its centred STFT frames padded to 64."""
    n = 1 + -(-samples // BUCKET) * BUCKET // HOP
    return n + pad_spec_amount(n)


def padded_frames(seconds: float) -> int:
    return bucket_frames(int(seconds * SR))


def bucketed(y: np.ndarray) -> torch.Tensor:
    """(B, T) waves on the card, zero-padded at the tail to their bucket as
    BucketedEnhancer pads them (for the phases that call the model directly)."""
    T = y.shape[-1]
    return torch.from_numpy(np.pad(y, [(0, 0), (0, -(-T // BUCKET) * BUCKET - T)])).cuda()


FREQS, FRAMES = 256, padded_frames(4.0)  # a 4 s request: 65536 samples, 513 frames -> 576
FIR = resample.setup_kernel((1, 3, 3, 1))
CONFIGS = {"down": dict(up=1, down=2, pad=(1, 1), kernel=FIR),
           "up": dict(up=2, down=1, pad=(2, 1), kernel=FIR * 4.0)}
# full-width StoRM; init_scale 1 so that no branch of the random net starts at ~0
STORM_CONFIG = {"mode": "regen-joint-training", "init_scale": 1.0}
N_STEPS, NFE = 50, 1 + 50 * 2  # CLI defaults: 1 denoiser + N x (ald + predictor)
SECONDS = (1.0, 2.5, 4.0)
GAP_S = 0.02  # host pause between the runs of `device_ms`
L2_FLUSH_BYTES = 256 << 20  # read before each call of `device_ms`: 5x the H100's 50 MB L2
# a profile fails unless the device events of each counted kernel number at
# least this share of its wrapper's counted launches (the profiler may drop a
# few) and at most all of them
PROFILE_MIN_MATCHED = 0.95


# the other widths the enhancement path gives upfirdn2d (the trained
# checkpoint's 1 s file included): 192 and 384
OTHER_FRAMES = sorted({padded_frames(s) for s in SECONDS} - {FRAMES})
# training: the CLI defaults' batch and crop (256 frames = 32640 samples, 2.04 s)
TRAIN_B, TRAIN_FRAMES, TRAIN_STEPS = 8, 256, 8
TRAIN_AUDIO_S = (TRAIN_FRAMES - 1) * 128 / SR
TRAIN_FILES, VALID_FILES, FILE_S = 32, 4, 2.5  # 4 steps per epoch, 2 epochs
# upfirdn2d launches per joint-training step: 18 per forward of each net, and
# a backward for every call whose input needs a gradient, which is all but
# the denoiser's input pyramid (3 calls on the raw noisy spec)
STEP_FWD, STEP_BWD = 2 * 18, 2 * 18 - 3
# gradients through the kernels against the plain path, per tensor:
# max|kernel - plain| <= GRAD_RTOL * max|plain| + GRAD_FLOOR * (largest gradient
# element), the floor for tensors whose exact gradient is 0 (the attention key
# bias); and the global L2 norm of the difference <= GRAD_NORM_RTOL * the norm.
# The two paths differ only in K1's summation order.
GRAD_RTOL, GRAD_FLOOR, GRAD_NORM_RTOL = 1e-3, 1e-5, 1e-4
# int8 serving at --quant_min_channels 128: every resblock's Conv_0, Conv_1 and
# Conv_2 of each full-width net; per file 1 denoiser forward and N x 2 score
# forwards, each launching the quantizer once per quantized conv
QUANT_MIN_CHANNELS, N_QUANT = 128, 55
K3_PER_FILE = N_QUANT + N_QUANT * N_STEPS * 2
# calibration (quantization off): the denoiser, a trajectory of min(N, 10)
# steps, then the prior and 8 probes spread over it (np.unique of 8 indices)
CALIB_N = min(N_STEPS, 10)


def calib_forwards(calib_n: int) -> int:
    return 1 + calib_n + 1 + len(np.unique(np.linspace(0, calib_n - 1, 8).astype(int)))


CALIB_FORWARDS = calib_forwards(CALIB_N)
PROBE_SHAPE, PROBE_S = (16 * 256 * 256, 128), 12.7  # scripts/perf_fusion_probe.py's qkernel
K2_SHAPES = [(8, 256, 256, 128), (3, 17, 33, 6)]


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def k1_calls(pyramid_ch: int, frames: int = FRAMES):
    """(config, C, H, W) of the 18 upfirdn2d calls of one NCSN++ forward."""
    calls = []
    L = len(CH_MULT)
    for i in range(L - 1):  # down resblocks (h and x), then the input pyramid
        H, W = FREQS >> i, frames >> i
        calls += [("down", NF * CH_MULT[i], H, W)] * 2 + [("down", pyramid_ch, H, W)]
    for i in range(L - 1, 0, -1):  # output pyramid, then up resblocks (h and x)
        H, W = FREQS >> i, frames >> i
        calls += [("up", pyramid_ch, H, W)] + [("up", NF * CH_MULT[i], H, W)] * 2
    return calls


def k1_bwd_calls():
    """(forward config, C, H, W) of the upfirdn2d calls whose backward runs in
    one joint-training step: every call of the score net (its input holds
    D(Y)), every call of the denoiser but its input pyramid's."""
    denoiser = [c for c in k1_calls(2, TRAIN_FRAMES) if c[:2] != ("down", 2)]
    calls = denoiser + k1_calls(6, TRAIN_FRAMES)
    check(len(calls) == STEP_BWD, f"{len(calls)} backward calls, expected {STEP_BWD}")
    return calls


def time_ms(fn, reps: int = 20, repeats: int = 5) -> float:
    """Median over `repeats` of the mean time of `reps` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_events(prof):
    """The trace's kernel events as sorted (start us, end us, name, stream)
    tuples: the spans of record_function ranges on the device's timeline
    (user annotations, such as the optimizer's step) cover kernels and are
    left out; an event listed twice (same name, stream and interval) counts
    once."""
    from torch.autograd import DeviceType

    return sorted({(e.time_range.start, e.time_range.end, e.name,
                    getattr(e, "device_resource_id", e.thread))
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)})


def device_ms(fns, stem: str, reps: int = 20):
    """Mean device time per call (ms) of each function in `fns`, each of which
    launches one kernel whose name holds `stem`: the durations of that
    kernel's events in a torch.profiler trace of `reps` calls of each. Unlike
    `time_ms`, the host's enqueue between calls does not count. Each call
    finds the L2 cold, as the memory bound assumes: a read of L2_FLUSH_BYTES
    (another kernel, not counted) runs before it. A pause of GAP_S after each
    function's calls splits the trace's events into one run per function
    (the profiler may miss a few events, so they are not split by count).
    A first run of the first function, dropped, takes the tracer's start:
    it has been seen to lose half the events of the run it starts with."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in [fns[0], *fns]:
            for _ in range(reps):
                flush.sum()
                fn()
            torch.cuda.synchronize()
            time.sleep(GAP_S)
    runs, last_end = [], -float("inf")
    for start, end, name, _ in kernel_events(prof):
        if stem not in name:
            continue
        if start - last_end > GAP_S * 1e6 / 2:  # microseconds
            runs.append([])
        runs[-1].append(end - start)
        last_end = end
    runs = runs[-len(fns):]  # without the first run, or what the tracer kept of it
    check(len(runs) == len(fns) and all(len(r) >= reps // 2 for r in runs),
          f"device events of {stem}: runs of {[len(r) for r in runs]}, expected "
          f"{len(fns)} runs of {reps}")
    return [statistics.mean(r) / 1e3 for r in runs]


def library_call(cfg: str, C: int, backward: bool = False, dtype=torch.float32):
    """One PyTorch call computing the same function (yardstick only); with
    `backward`, the adjoint of the forward call of `cfg`, which is the other
    call with the same weight. In bfloat16 the weight is the FIR cast to it,
    which is exact."""
    k = torch.as_tensor(CONFIGS[cfg]["kernel"], device="cuda").to(dtype)
    if cfg == "down":  # correlation with the flipped FIR on the 1-padded input
        w = k.flip(0, 1).expand(C, 1, 4, 4).contiguous()
        if backward:
            return lambda g: F.conv_transpose2d(g, w, stride=2, padding=1, groups=C)
        return lambda x: F.conv2d(x, w, stride=2, padding=1, groups=C)
    w = k.expand(C, 1, 4, 4).contiguous()  # transposed conv with the FIR as is
    if backward:
        return lambda g: F.conv2d(g, w, stride=2, padding=1, groups=C)
    return lambda x: F.conv_transpose2d(x, w, stride=2, padding=1, groups=C)


def bound_ms(n_in: int, n_out: int, taps: int, elem_bytes: int = 4):
    """(bytes bound, operations bound) in ms: in and out once (`elem_bytes`
    per element: 4 float32, 2 bfloat16) over the memory rate; `taps`
    multiply-adds per output, in float32 either way, over the f32 peak."""
    return (elem_bytes * (n_in + n_out) / PEAK_BYTES_PER_S * 1e3,
            2.0 * taps * n_out / PEAK_F32_FLOP_PER_S * 1e3)


ASYM = torch.randn(4, 4, generator=torch.Generator().manual_seed(1)).numpy()


def forward_shapes(frames: int):
    return sorted(set(k1_calls(6, frames) + k1_calls(2, frames)),
                  key=lambda s: (s[0], -s[1], -s[2]))


# bfloat16 checks of a kernel against its plain version, by kernel and FIR
# (NCSN++'s or the asymmetric one): [elements compared, elements that differ]
BF16_FLIPS = {k: {"ncsnpp": [0, 0], "asym": [0, 0]} for k in ("upfirdn2d", "upfirdn2d_bwd")}


def ulps_of_scale(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bfloat16 ulps of max |want|: 2^-7 of its leading
    power of two."""
    scale = want.float().abs().max().clamp_min(2.0 ** -126)
    return ((got.float() - want.float()).abs().max()
            / torch.exp2(torch.floor(torch.log2(scale)) - 7)).item()


def compare(what: str, got: torch.Tensor, want: torch.Tensor, kernel: str = "upfirdn2d",
            terms: torch.Tensor = None, fir: str = "ncsnpp") -> float:
    """max |got - want|; fails unless they agree to atol = rtol = 1e-5 in
    float32, or in bfloat16 to 1 ulp of each element plus 2^-18 of `terms`
    (the sum of the element's products' magnitudes): both sum in float32
    and round once, but the kernel's fused multiply-add rounds a product
    that is not exact once less, which shows where an asymmetric FIR's sum
    cancels; NCSN++'s FIR's products are exact. The elements that differ
    are counted in BF16_FLIPS[kernel][fir]."""
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    check(got.dtype == want.dtype, f"{what}: dtype {got.dtype} vs {want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.bfloat16:
        w = want.float().abs().clamp_min(2.0 ** -126)
        allowed = torch.exp2(torch.floor(torch.log2(w)) - 7) + 2.0 ** -18 * terms.float()
        worst = ((got.float() - want.float()).abs() / allowed).max().item()
        flips = int((got != want).sum().item())
        BF16_FLIPS[kernel][fir][0] += got.numel()
        BF16_FLIPS[kernel][fir][1] += flips
        check(worst <= 1.0, f"{what}: kernel {worst:.2f} of its allowance from plain ({flips} "
                            f"elements differ)")
    else:
        check(torch.allclose(got, want, atol=1e-5, rtol=1e-5),
              f"{what}: kernel disagrees with plain (max {err:.3e})")
    return err


def check_forward(cfg: str, x: torch.Tensor) -> float:
    """upfirdn2d_cuda against the plain version on x (float32 or bfloat16),
    both FIRs."""
    c = CONFIGS[cfg]
    args = dict(up=c["up"], down=c["down"], pad=c["pad"])
    return max(compare(f"upfirdn2d {cfg} {tuple(x.shape)} {x.dtype}",
                       kup.upfirdn2d_cuda(x, kern, **args), kup.upfirdn2d_plain(x, kern, **args),
                       terms=kup.upfirdn2d_plain(x.abs(), np.abs(kern), **args), fir=fir)
               for fir, kern in (("ncsnpp", c["kernel"]), ("asym", ASYM)))


def phase_kernel_vs_plain(gen: torch.Generator):
    per_shape, launch, max_err = {}, {}, 0.0
    for frames in OTHER_FRAMES:  # correctness only
        errs = [check_forward(cfg, torch.randn(1, C, H, W, device="cuda", generator=gen))
                for cfg, C, H, W in forward_shapes(frames)]
        max_err = max(max_err, *errs)
        print(f"  upfirdn2d at 256 x {frames} (B=1): {len(errs)} shapes agree with plain, "
              f"max abs err {max(errs):.2e}", flush=True)
    for cfg, C, H, W in forward_shapes(FRAMES):
        c = CONFIGS[cfg]
        args = dict(up=c["up"], down=c["down"], pad=c["pad"])
        x = torch.randn(1, C, H, W, device="cuda", generator=gen)
        max_err = max(max_err, check_forward(cfg, x))
        lib = library_call(cfg, C)
        want = kup.upfirdn2d_plain(x, c["kernel"], **args)
        lib_err = (lib(x) - want).abs().max().item()
        check(lib_err <= 1e-5 + 1e-5 * want.abs().max().item(),
              f"library yardstick {cfg} C={C}: not the same function (max {lib_err:.3e})")
        ms = time_ms(lambda: kup.upfirdn2d_cuda(x, c["kernel"], **args))
        plain_ms = time_ms(lambda: kup.upfirdn2d_plain(x, c["kernel"], **args), reps=5)
        library_ms = time_ms(lambda: lib(x))
        Ho, Wo = want.shape[-2:]
        bound_bytes_ms, bound_ops_ms = bound_ms(C * H * W, C * Ho * Wo, 16 // (c["up"] ** 2))
        per_shape[(cfg, C, H, W)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                         bytes_ms=bound_bytes_ms, ops_ms=bound_ops_ms,
                                         lib_err=lib_err, out=f"{Ho}x{Wo}")
        launch[(cfg, C, H, W)] = functools.partial(kup.upfirdn2d_cuda, x, c["kernel"], **args)
    print_per_shape("upfirdn2d", per_shape, launch, "upfirdn2d_")
    return per_shape, max_err


def print_per_shape(what: str, per_shape, launch, stem: str):
    """Add each shape's device time to its times and print one line per shape."""
    for key, dev in zip(launch, device_ms(list(launch.values()), stem)):
        per_shape[key]["device_ms"] = dev
    for (cfg, C, H, W), r in per_shape.items():
        by = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
        print(f"  {what} {cfg:4s} C={C:3d} {H:3d}x{W:3d} -> {r['out']}: ms={r['ms']:.5f} "
              f"device_ms={r['device_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"library_ms={r['library_ms']:.5f} bound_ms={max(r['bytes_ms'], r['ops_ms']):.5f} "
              f"({by}) device/bound={r['device_ms'] / max(r['bytes_ms'], r['ops_ms']):.2f} "
              f"lib_err={r['lib_err']:.2e}"
              + (f" flips={r['flips']}" if "flips" in r else ""), flush=True)


def phase_full_width_forward(gen: torch.Generator):
    net = NCSNpp(input_channels=6, init_scale=1.0)
    reset_parameters(net, torch.Generator().manual_seed(0))
    net = net.cuda().eval()
    check(count_parameters(net) > 27_000_000, "NCSN++ is not full width")
    x = 0.5 * torch.randn(1, 3, FREQS, FRAMES, 2, device="cuda", generator=gen)
    t = torch.full((1,), 0.5, device="cuda")
    with torch.inference_mode():
        kup.upfirdn2d_cuda.launches = 0
        out_k = net(x, t)
        torch.cuda.synchronize()
        launches = kup.upfirdn2d_cuda.launches
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            out_p = net(x, t)
            torch.cuda.synchronize()
            check(kup.upfirdn2d_cuda.launches == launches, "plain path launched the kernel")
        fwd_ms = time_ms(lambda: net(x, t), reps=3, repeats=3)
    check(launches == 18, f"one NCSN++ forward launched upfirdn2d {launches} times, expected 18")
    check(bool(torch.isfinite(out_k).all()), "NCSN++ output is not finite")
    err = (out_k - out_p).abs().max().item()
    scale = out_p.abs().max().item()
    print(f"  NCSN++ {count_parameters(net)} params, out {tuple(out_k.shape)}: "
          f"kernel vs plain max abs err {err:.3e} (scale {scale:.3e}), forward {fwd_ms:.2f} ms",
          flush=True)
    check(err <= 1e-4 * scale, f"full-width NCSN++ kernel path disagrees with plain ({err:.3e})")


def synth_wav(seconds: float, i: int, rng: np.random.Generator) -> np.ndarray:
    """A modulated tone in white noise, float32 at 16 kHz."""
    n = int(seconds * SR)
    tt = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * 220 * (i + 1) * tt) * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * tt))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


def write_wavs(directory: str):
    """One synthesized file per entry of SECONDS; returns {name: samples}."""
    os.makedirs(directory)
    rng = np.random.default_rng(0)
    lengths = {}
    for i, s in enumerate(SECONDS):
        name = f"utt{i}_{s:.1f}s.wav"
        x = synth_wav(s, i, rng)
        save_wav(os.path.join(directory, name), x, SR)
        lengths[name] = x.shape[-1]
    return lengths


def captured(fn, *args):
    """fn(*args) with its standard output captured, then printed indented;
    returns (fn's result, the output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    torch.cuda.synchronize()
    text = buf.getvalue()
    print("".join(f"    | {line}\n" for line in text.splitlines()), end="", flush=True)
    return result, text


def run_enhancement(argv, outputs=None) -> str:
    """`python -m storm_tpu_torch.enhancement` in this process; its standard
    output is printed and returned. With `outputs` (a dict), each enhanced
    waveform is also kept there by file name, as float32 before the WAV
    writer's 16-bit rounding."""
    if outputs is None:
        return captured(enhancement.main, argv)[1]
    real = enhancement.save_wav

    def save_wav(path, x, sr=SR):
        outputs[os.path.basename(path)] = np.array(x, np.float32)
        real(path, x, sr)

    with mock.patch.object(enhancement, "save_wav", save_wav):
        return captured(enhancement.main, argv)[1]


def rtf_of(text: str):
    """{file name: RTF} from the CLI's --timeit lines."""
    return {m.group(1): float(m.group(2))
            for m in re.finditer(r"^(\S+\.wav): nfe=\d+ rtf=([0-9.]+)", text, re.M)}


def check_outputs(out: str, lengths):
    for name, n in lengths.items():
        x, sr = load_wav(os.path.join(out, name))
        check(sr == SR and x.shape == (1, n), f"{name}: output shape {x.shape}, expected (1, {n})")
        check(bool(np.isfinite(x).all()), f"{name}: output not finite")


def phase_main_path(workdir: str):
    """Returns (upfirdn2d launches, {file: RTF}, {file: samples}, {file: output});
    leaves the checkpoint and the files in `workdir` for phase 11."""
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    ckpt = os.path.join(workdir, "storm.pt")
    save_checkpoint(ckpt, STORM_CONFIG, model.state_dict())
    noisy, out = os.path.join(workdir, "noisy"), os.path.join(workdir, "enhanced")
    lengths = write_wavs(noisy)

    kup.upfirdn2d_cuda.launches = 0
    t0 = time.perf_counter()
    outputs = {}
    text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                            "--mode", "storm", "--timeit", "--device", "cuda"], outputs)
    wall = time.perf_counter() - t0
    launches = kup.upfirdn2d_cuda.launches
    check_outputs(out, lengths)
    expected = 18 * NFE * len(SECONDS)
    print(f"  enhanced {len(SECONDS)} files ({sum(SECONDS)} s of audio) in {wall:.2f} s wall; "
          f"upfirdn2d launches {launches} (expected 18 x {NFE} x {len(SECONDS)} = {expected})",
          flush=True)
    check(launches == expected, f"upfirdn2d launched {launches} times, expected {expected}")

    # the whole path once more on the shortest file, kernel against plain, same noise
    y = bucketed(load_wav(os.path.join(noisy, next(iter(lengths))))[0])
    runs = []
    for plain in (False, True):
        gen = torch.Generator(device="cuda").manual_seed(0)
        ctx = (mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain) if plain
               else contextlib.nullcontext())
        with ctx:
            x_hat, _ = model.enhance(y, N=N_STEPS, corrector="ald", generator=gen)
        runs.append(x_hat)
    err = (runs[0] - runs[1]).abs().max().item()
    scale = runs[1].abs().max().item()
    print(f"  enhance (1 s file) kernel vs plain: max abs err {err:.3e} (scale {scale:.3e})",
          flush=True)
    check(err <= 1e-3 * scale, f"main path with the kernel disagrees with plain ({err:.3e})")
    return launches, rtf_of(text), lengths, outputs


def phase_backward_vs_plain(gen: torch.Generator):
    """upfirdn2d at each forward shape of a train step, through the autograd
    Function the model calls: its output, and where the step takes one its
    gradient, against the plain version. Returns (per-shape backward times,
    backward max error, forward max error)."""
    bwd_calls = set(k1_bwd_calls())
    per_shape, launch, max_err, fwd_err = {}, {}, 0.0, 0.0
    for cfg, C, H, W in forward_shapes(TRAIN_FRAMES):
        c = CONFIGS[cfg]
        args = dict(up=c["up"], down=c["down"], pad=c["pad"])
        needs_grad = (cfg, C, H, W) in bwd_calls
        what = f"{cfg} B={TRAIN_B} C={C} {H}x{W}"
        x = torch.randn(TRAIN_B, C, H, W, device="cuda", generator=gen)
        Ho, Wo = (kup.output_size(n, 4, c["up"], c["down"], c["pad"]) for n in (H, W))
        g = torch.randn(TRAIN_B, C, Ho, Wo, device="cuda", generator=gen)
        for kern in (ASYM, c["kernel"]):  # the NCSN++ FIR last: `want` serves below
            xk = x.clone().requires_grad_(needs_grad)
            xp = x.clone().requires_grad_(needs_grad)
            out_k, out_p = kup.upfirdn2d(xk, kern, **args), kup.upfirdn2d_plain(xp, kern, **args)
            fwd_err = max(fwd_err, compare(f"upfirdn2d {what}", out_k.detach(), out_p.detach()))
            if needs_grad:
                (got,) = torch.autograd.grad(out_k, xk, g)
                (want,) = torch.autograd.grad(out_p, xp, g)
                check(got.shape == x.shape, f"upfirdn2d_bwd {what}: shape")
                max_err = max(max_err, compare(f"upfirdn2d_bwd {what}", got, want))
        if not needs_grad:
            continue
        lib = library_call(cfg, C, backward=True)
        lib_err = (lib(g) - want).abs().max().item()
        check(lib_err <= 1e-5 + 1e-5 * want.abs().max().item(),
              f"library yardstick bwd {cfg} C={C}: not the same function (max {lib_err:.3e})")
        bwd = (g, c["kernel"], c["up"], c["down"], c["pad"], (H, W))
        ms = time_ms(lambda: kup.upfirdn2d_bwd_cuda(*bwd))
        plain_ms = time_ms(lambda: kup.upfirdn2d_bwd_plain(*bwd), reps=5)
        library_ms = time_ms(lambda: lib(g))
        bytes_ms, ops_ms = bound_ms(g.numel(), x.numel(), 16 // (c["down"] ** 2))
        per_shape[(cfg, C, H, W)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                         bytes_ms=bytes_ms, ops_ms=ops_ms, lib_err=lib_err,
                                         out=f"(g {Ho}x{Wo} -> grad x {H}x{W})")
        launch[(cfg, C, H, W)] = functools.partial(kup.upfirdn2d_bwd_cuda, *bwd)
    print_per_shape(f"upfirdn2d_bwd (B={TRAIN_B}) of", per_shape, launch, "upfirdn2d_")
    print(f"  forward at every train-step shape: max abs err {fwd_err:.2e}; backward: "
          f"max abs err {max_err:.2e}", flush=True)
    return per_shape, max_err, fwd_err


def grads_of(model, batch, t, z):
    model.compute_gradients(batch, t, z)
    return {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.requires_grad}


def phase_train_gradients(gen: torch.Generator):
    """One full-width step's gradients through the kernels against the plain path."""
    model = build_model(STORM_CONFIG, device="cuda", seed=0).train()
    B = 2
    x = 0.3 * torch.randn(B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
    y = x + 0.2 * torch.randn(B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
    t = torch.tensor([0.3, 0.8], device="cuda")
    z = torch.randn(B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen) / 2 ** 0.5
    torch.backends.cudnn.deterministic = True
    try:
        kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
        g_k = grads_of(model, (x, y), t, z)
        torch.cuda.synchronize()
        counts = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            g_p = grads_of(model, (x, y), t, z)
            torch.cuda.synchronize()
        check(counts == (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches),
              "the plain path launched a kernel")
    finally:
        torch.backends.cudnn.deterministic = False
    check(counts == (STEP_FWD, STEP_BWD),
          f"one step's gradients launched {counts}, expected {(STEP_FWD, STEP_BWD)}")
    check(all(bool(torch.isfinite(v).all()) for v in g_k.values()), "gradients not finite")
    g_max = max(v.abs().max().item() for v in g_p.values())
    worst, worst_name = 0.0, None
    for name, want in g_p.items():
        err = (g_k[name] - want).abs().max().item()
        ratio = err / (GRAD_RTOL * want.abs().max().item() + GRAD_FLOOR * g_max)
        if ratio > worst:
            worst, worst_name = ratio, name
    d_norm = torch.sqrt(sum(((g_k[n] - g_p[n]) ** 2).sum() for n in g_p)).item()
    norm = torch.sqrt(sum((v ** 2).sum() for v in g_p.values())).item()
    print(f"  B={B} full-width gradients, kernel vs plain: {len(g_p)} tensors, launches "
          f"{counts}; worst tensor at {worst:.3f} of its tolerance ({worst_name}); "
          f"global norm {norm:.6e}, |diff| {d_norm:.3e} ({d_norm / norm:.3e} relative)",
          flush=True)
    check(worst <= 1.0, f"gradient of {worst_name} disagrees with the plain path")
    check(d_norm <= GRAD_NORM_RTOL * norm, "global gradient disagrees with the plain path")
    del model, g_k, g_p
    torch.cuda.empty_cache()


def write_corpus(root: str):
    """wsj0 layout: TRAIN_FILES `tr` and VALID_FILES `cv` pairs of FILE_S seconds."""
    rng = np.random.default_rng(1)
    for sub, n in (("tr", TRAIN_FILES), ("cv", VALID_FILES)):
        for kind in ("clean", "noisy"):
            os.makedirs(os.path.join(root, sub, kind))
        for i in range(n):
            clean = synth_wav(FILE_S, i, rng)
            noisy = clean + 0.1 * rng.standard_normal(clean.shape[-1]).astype(np.float32)
            save_wav(os.path.join(root, sub, "clean", f"u{i:03d}.wav"), clean, SR)
            save_wav(os.path.join(root, sub, "noisy", f"u{i:03d}.wav"), noisy, SR)


def phase_train(workdir: str):
    """The training path through `python -m storm_tpu_torch.train`."""
    corpus, logs = os.path.join(workdir, "corpus"), os.path.join(workdir, "logs")
    write_corpus(corpus)
    steps, first_params = [], {}
    original = StochasticRegenerationModel.train_step

    def timed_step(model, state, batch, generator=None):
        """train_step between two CUDA events; adds no host sync to the loop."""
        if not first_params:
            first_params.update({k: v.detach().clone() for k, v in model.state_dict().items()})
        before = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        aux = original(model, state, batch, generator)
        end.record()
        steps.append(dict(start=start, end=end, loss=aux["loss"],
                          launches=(kup.upfirdn2d_cuda.launches - before[0],
                                    kup.upfirdn2d_bwd_cuda.launches - before[1])))
        return aux

    # the loss is logged at the last step of each epoch only, where the epoch's
    # mean reads it back anyway: the loop keeps its own host syncs and no more
    epoch_len = TRAIN_FILES // TRAIN_B
    argv = ["--mode", "regen-joint-training", "--base_dir", corpus, "--format", "wsj0",
            "--batch_size", str(TRAIN_B), "--num_frames", str(TRAIN_FRAMES),
            "--max_steps", str(TRAIN_STEPS), "--num_eval_files", "0", "--log_dir", logs,
            "--log_every_n_steps", str(epoch_len), "--num_workers", "4", "--seed", "0",
            "--device", "cuda"]
    torch.cuda.reset_peak_memory_stats()
    kup.upfirdn2d_cuda.launches = kup.upfirdn2d_bwd_cuda.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(StochasticRegenerationModel, "train_step", timed_step):
        train.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (kup.upfirdn2d_cuda.launches, kup.upfirdn2d_bwd_cuda.launches)
    peak = torch.cuda.max_memory_allocated()

    (run,) = os.listdir(logs)
    rows = [json.loads(line) for line in open(os.path.join(logs, run, "metrics.jsonl"))]
    losses = [s["loss"].item() for s in steps]
    logged = [r["step"] for r in rows if "train_loss" in r]
    valid = [r["valid_loss"] for r in rows if "valid_loss" in r]
    check(len(steps) == TRAIN_STEPS, f"{len(steps)} steps, expected {TRAIN_STEPS}")
    check(logged == list(range(epoch_len, TRAIN_STEPS + 1, epoch_len)),
          f"train losses logged at steps {logged}")
    check(len(valid) == TRAIN_STEPS // epoch_len, f"{len(valid)} validations")
    check(all(np.isfinite(losses))
          and all(np.isfinite(v) for r in rows for k, v in r.items() if k != "step"),
          "a training or validation loss is not finite")
    check(all(s["launches"] == (STEP_FWD, STEP_BWD) for s in steps),
          f"launches per step {[s['launches'] for s in steps]}, expected {(STEP_FWD, STEP_BWD)}")
    n_valid_fwd = STEP_FWD * len(valid) * -(-VALID_FILES // TRAIN_B)  # no backward
    check(launches == (STEP_FWD * TRAIN_STEPS + n_valid_fwd, STEP_BWD * TRAIN_STEPS),
          f"training launched {launches}")
    ckpt_dir = os.path.join(logs, run, "checkpoints")
    check(sorted(os.listdir(ckpt_dir)) == ["best_loss.pt", "last.pt"],
          f"checkpoints {os.listdir(ckpt_dir)}")
    last = load_training_checkpoint(os.path.join(ckpt_dir, "last.pt"))
    check(last["step"] == TRAIN_STEPS, f"last.pt at step {last['step']}")
    moved = [k for k, v in last["params"].items() if not torch.equal(v, first_params[k].cpu())]
    ema_moved = [k for k in moved if not torch.equal(last["ema_params"][k], first_params[k].cpu())]
    check(len(moved) > 0.9 * len(first_params) and len(ema_moved) == len(moved),
          f"{len(moved)} of {len(first_params)} tensors moved, {len(ema_moved)} in the EMA")

    # step time on the card's clock: the loop's period between the ends of
    # consecutive steps of one epoch (data loading included), and one
    # train_step call from its first launch to its last kernel's end
    periods = [steps[i - 1]["end"].elapsed_time(steps[i]["end"])
               for i in range(1, len(steps)) if i % epoch_len]
    calls = [s["start"].elapsed_time(s["end"]) for s in steps[1:]]
    first_s = steps[0]["start"].elapsed_time(steps[0]["end"]) / 1e3
    step_ms = statistics.median(periods)
    print(f"  trained {TRAIN_STEPS} steps at B={TRAIN_B} x {TRAIN_FRAMES} frames in {wall:.1f} s "
          f"wall (setup, validation and checkpoints included); losses "
          f"{[round(v, 2) for v in losses]}; valid {[round(v, 2) for v in valid]}", flush=True)
    print(f"  step: {step_ms:.2f} ms median period {[round(p, 2) for p in periods]} "
          f"(first step {first_s:.3f} s; train_step alone median {statistics.median(calls):.2f} ms); "
          f"{TRAIN_B * TRAIN_AUDIO_S / (step_ms / 1e3):.3f} audio s trained per s; "
          f"peak memory {peak / 2**30:.2f} GiB; launches per step {steps[-1]['launches']}, "
          f"in all {launches}; {len(moved)} of {len(first_params)} tensors moved",
          flush=True)

    # the written checkpoint serves
    noisy, out = os.path.join(workdir, "noisy_one"), os.path.join(workdir, "enhanced_one")
    os.makedirs(noisy)
    x = synth_wav(1.0, 3, np.random.default_rng(2))
    save_wav(os.path.join(noisy, "one.wav"), x, SR)
    enhancement.main(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt",
                      os.path.join(ckpt_dir, "last.pt"), "--mode", "storm", "--N", "2",
                      "--device", "cuda"])
    y, sr = load_wav(os.path.join(out, "one.wav"))
    check(sr == SR and y.shape == (1, x.shape[-1]) and bool(np.isfinite(y).all()),
          f"enhancing with the trained checkpoint gave {y.shape}")
    print(f"  the trained checkpoint enhanced a {x.shape[-1] / SR:.1f} s file at N=2", flush=True)
    return launches


# profile groups: label -> (kernel-name stems, the launch counter of the
# wrapper that launches them, or None for a library's kernels)
K1_GROUPS = {"upfirdn2d (K1) down config": (("upfirdn2d_down",), "K1"),
             "upfirdn2d (K1) up config": (("upfirdn2d_up",), "K1")}
INT8_GROUPS = {**K1_GROUPS, "quantize_int8 (K3)": (("quantize_int8_kernel",), "K3"),
               "int8 GEMM (torch._int_mm)": (("gemm_s8", "imma", "i8i8", "s8s8"), None)}
LAUNCH_COUNTERS = {
    "K1": lambda: kup.upfirdn2d_cuda.launches + kup.upfirdn2d_bwd_cuda.launches,
    "K3": lambda: kq.quantize_int8_cuda.launches,
}


def print_profile(what: str, prof, wall_ms: float, groups, launched):
    """Device time by kernel from the trace's kernel events (`kernel_events`).
    The busy time is the union of the intervals; each kernel's share is of the
    summed kernel time. Also printed: the sum of key_averages' device time
    over every device row (annotations included), the annotation spans and
    the kernels that overlap, if any. `launched` holds {counter: launches in
    the traced window}. Fails if a group whose counter counted launches
    matches no device event (a renamed kernel would otherwise show 0 ms), or
    if a counter's groups together match fewer than PROFILE_MIN_MATCHED of
    its launches, or more."""
    from torch.autograd import DeviceType

    spans = [e for e in prof.events() if e.device_type == DeviceType.CUDA
             and getattr(e, "is_user_annotation", False)]
    unique = kernel_events(prof)
    check(len(unique) > 0, "the profiler saw no device time")
    by_name = {}
    busy_us, end, end_name, overlaps = 0.0, -float("inf"), None, {}
    for start, stop, name, _ in unique:
        ms, n = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + (stop - start) / 1e3, n + 1)
        if start < end:
            pair = (end_name[:40], name[:40])
            overlaps[pair] = overlaps.get(pair, 0.0) + (min(stop, end) - start) / 1e3
        busy_us += max(0.0, stop - max(start, end))
        if stop > end:
            end, end_name = stop, name
    rows = sorted(((k, ms, n) for k, (ms, n) in by_name.items()), key=lambda r: -r[1])
    summed_ms, busy_ms = sum(r[1] for r in rows), busy_us / 1e3
    averages_ms = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA) / 1e3
    span_ms = {}
    for e in spans:
        span_ms[e.name] = span_ms.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    print(f"  {what} under the profiler: wall {wall_ms:.1f} ms; {len(unique)} distinct kernel "
          f"events, {len({u[3] for u in unique})} stream ids; kernel time summed "
          f"{summed_ms:.1f} ms, device busy (union) {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall); key_averages' device time summed "
          f"{averages_ms:.1f} ms; annotation spans {sum(span_ms.values()):.1f} ms "
          f"{ {k[:40]: round(v, 2) for k, v in sorted(span_ms.items(), key=lambda kv: -kv[1])[:4]} }",
          flush=True)
    for (a, b), ms in sorted(overlaps.items(), key=lambda o: -o[1])[:5]:
        print(f"    overlap {ms:8.2f} ms: {a} | {b}")
    for key, ms, count in rows[:20]:
        print(f"    {100 * ms / summed_ms:5.1f}%  {ms:9.2f} ms  x{count:6d}  {key[:90]}")
    matched = dict.fromkeys(launched, 0)
    for label, (keys, counter) in groups.items():
        sel = [r for r in rows if any(k in r[0] for k in keys)]
        ms, n = sum(r[1] for r in sel), sum(r[2] for r in sel)
        print(f"  {label}: {ms:.2f} ms in {n} launches ({100 * ms / summed_ms:.2f}% of kernel "
              f"time)", flush=True)
        if counter is not None:
            matched[counter] += n
            check(launched[counter] == 0 or n > 0,
                  f"{what}: {counter}'s wrapper counted {launched[counter]} launches, but no "
                  f"device event matches the group {label!r} ({keys})")
    for counter, n in launched.items():
        print(f"  {counter}: {matched[counter]} device events for {n} counted launches",
              flush=True)
        check(PROFILE_MIN_MATCHED * n <= matched[counter] <= n,
              f"{what}: {counter}'s groups match {matched[counter]} device events for {n} "
              f"counted launches")


def profile_run(what: str, fn, groups=K1_GROUPS):
    """Trace fn() with torch.profiler (after the caller's warm-up) and print
    where the device time went."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = {k: count() for k, count in LAUNCH_COUNTERS.items()}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launched = {k: count() - before[k] for k, count in LAUNCH_COUNTERS.items()}
    print_profile(what, prof, wall_ms, groups, launched)


def phase_profile_train():
    """Trace two full-width train steps (B=8, 256 x 256)."""
    model = build_model({"mode": "regen-joint-training"}, device="cuda", seed=0).train()
    state = init_train_state(model, model.lr)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = 0.3 * torch.randn(TRAIN_B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
    batch = (x, x + 0.2 * torch.randn(x.shape, device="cuda", generator=gen))
    model.train_step(state, batch, gen)  # warm-up at the same shapes

    def two_steps():
        for _ in range(2):
            model.train_step(state, batch, gen)

    profile_run(f"two train steps (B={TRAIN_B}, {FREQS} x {TRAIN_FRAMES})", two_steps)


def phase_profile():
    """Trace one enhancement of the longest file (CLI defaults) and print where
    the device time goes."""
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    y = bucketed(synth_wav(max(SECONDS), 0, np.random.default_rng(0))[None])
    model.enhance(y, N=2, corrector="ald")  # warm-up at the same shapes
    profile_run(f"enhance {max(SECONDS)} s file",
                lambda: model.enhance(y, N=N_STEPS, corrector="ald"))


# --- int8 serving (phases 10, 11, 13) and fused_leaky_relu (phase 12)


def f32_ties(inv: float) -> np.ndarray:
    """float32 values x with x * inv (a float32 product) exactly k + 0.5, for
    k in [-130, 130) where such an x exists."""
    inv32 = np.float32(inv)
    want = (np.arange(-130, 130) + 0.5).astype(np.float32)
    base = (want.astype(np.float64) / float(inv32)).astype(np.float32)
    found = [c[(c * inv32) == want]
             for c in (base, np.nextafter(base, np.float32(np.inf)),
                       np.nextafter(base, np.float32(-np.inf)))]
    return np.unique(np.concatenate(found))


def bf16_ties(inv: float) -> np.ndarray:
    """Every bfloat16 value (as float32) whose float32 product with inv is
    exactly k + 0.5, |k + 0.5| < 130."""
    x = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) < np.float32(130 / inv))]
    v = x * np.float32(inv)
    return x[v - np.floor(v) == 0.5]


def bf16_product_ties(inv: float) -> np.ndarray:
    """Every bfloat16 value (as float32) whose product with bf16(inv),
    rounded to bfloat16, is exactly k + 0.5, |k + 0.5| < 130, where its
    float32 product with inv is not: the bfloat16-product mode's ties, at
    which the two modes' codes part."""
    inv_b = np.float32(torch.tensor(np.float32(inv)).bfloat16().item())
    x = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) < np.float32(130 / inv))]
    p = torch.from_numpy(x * inv_b).bfloat16().float().numpy()  # x * inv_b is exact
    f = x * np.float32(inv)
    return x[(p - np.floor(p) == 0.5) & (f - np.floor(f) != 0.5)]


def with_ties(x: torch.Tensor, inv: float, product: torch.dtype = torch.float32) -> int:
    """Write exact .5 ties of the product in `product` (tiled over the first
    elements) and values beyond +-127 (the last ones) into x in place;
    returns the count of ties."""
    if product == torch.bfloat16:
        ties = bf16_product_ties(inv)
    else:
        ties = bf16_ties(inv) if x.dtype == torch.bfloat16 else f32_ties(inv)
    flat = x.view(-1)
    n = min(len(ties) * 64, flat.numel() // 2)
    if n:
        flat[:n] = torch.from_numpy(np.resize(ties, n)).to(flat)
    sat = np.array([200, -200, 1e4, -1e4, 127.49, -127.6], np.float32) / np.float32(inv)
    flat[-len(sat):] = torch.from_numpy(sat).to(flat)
    return n


def check_codes(what: str, x: torch.Tensor, inv: float,
                product: torch.dtype = torch.float32) -> int:
    """Hold the kernel's codes to plain's, exactly; returns max |got - want|."""
    got, want = kq.quantize_int8_cuda(x, inv, product), kq.quantize_int8_plain(x, inv, product)
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    differ, err = int((diff != 0).sum().item()), int(diff.max().item())
    check(differ == 0, f"quantize_int8 {what}: {differ} codes differ from plain, by up to {err}")
    return err


def k3_bound_ms(x: torch.Tensor):
    """(bytes bound, operations bound) in ms: the input and one byte per
    element once over the memory rate; multiply, round and clip (3 ops) per
    element over the f32 peak."""
    return ((x.element_size() + 1) * x.numel() / PEAK_BYTES_PER_S * 1e3,
            3.0 * x.numel() / PEAK_F32_FLOP_PER_S * 1e3)


def phase_quantizer_vs_plain(workdir: str, gen: torch.Generator):
    """K3 at every quantized-conv input of the 4 s request, and at the probe's
    shape. Returns ({input shape: times}, the score forward's shapes, probe,
    the largest |kernel code - plain code| over every input)."""
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    name = f"utt{len(SECONDS) - 1}_{SECONDS[-1]:.1f}s.wav"
    y = bucketed(load_wav(os.path.join(workdir, "noisy", name))[0])
    quant = quant_mod.calibrate_storm(model, y, N=CALIB_N, min_channels=QUANT_MIN_CHANNELS,
                                      generator=torch.Generator(device="cuda").manual_seed(1))
    check(n_quantized(quant) == 2 * N_QUANT,
          f"{n_quantized(quant)} convs quantized, expected {2 * N_QUANT}")
    calls = []  # (net, input, inv) of every quantized conv call of one forward per net

    def capture(net):
        def hook(mod, inp, out):
            if mod.a_scale is not None:
                calls.append((net, inp[0].clone(), qconv.activation_inverse(mod.a_scale)))
        return hook

    hooks = [m.register_forward_hook(capture(net))
             for net in ("denoiser", "score")
             for m in qconv.quantizable_convs(getattr(model, f"{net}_net")).values()]
    try:
        with torch.inference_mode():
            model.enhance(y, N=1, corrector="none", quant=quant)  # one forward of each net
    finally:
        for h in hooks:
            h.remove()
    check(len(calls) == 2 * N_QUANT, f"{len(calls)} quantized conv calls, expected {2 * N_QUANT}")
    per_shape, launch, score_shapes, ties, max_err = {}, {}, [], 0, 0
    with torch.inference_mode():  # the captured inputs are inference tensors
        for net, x, inv in calls:
            shape = tuple(x.shape)
            ties += with_ties(x, inv)
            max_err = max(max_err, check_codes(f"{net} {shape}", x, inv))
            if net != "score":
                continue
            score_shapes.append(shape)
            if shape not in per_shape:
                bytes_ms, ops_ms = k3_bound_ms(x)
                per_shape[shape] = dict(
                    ms=time_ms(lambda: kq.quantize_int8_cuda(x, inv)),
                    plain_ms=time_ms(lambda: kq.quantize_int8_plain(x, inv), reps=5),
                    bytes_ms=bytes_ms, ops_ms=ops_ms, calls=0)
                launch[shape] = functools.partial(kq.quantize_int8_cuda, x, inv)
            per_shape[shape]["calls"] += 1
        for shape, dev in zip(launch, device_ms(list(launch.values()), "quantize_int8_kernel")):
            per_shape[shape]["device_ms"] = dev
    del calls, launch
    print(f"  {2 * N_QUANT} quantized conv inputs (f32), {ties} exact ties written in: codes "
          f"identical to plain", flush=True)
    for shape, r in per_shape.items():
        print(f"  quantize_int8 f32 {shape} x{r['calls']} per score forward: ms={r['ms']:.5f} "
              f"device_ms={r['device_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"bound_ms={max(r['bytes_ms'], r['ops_ms']):.5f} (bytes) "
              f"ratio={r['ms'] / r['bytes_ms']:.2f} device/bound="
              f"{r['device_ms'] / r['bytes_ms']:.2f}", flush=True)

    x = (10.0 * torch.randn(PROBE_SHAPE, device="cuda", generator=gen)).to(torch.bfloat16)
    probe_ties = with_ties(x, PROBE_S)
    max_err = max(max_err, check_codes(f"probe {PROBE_SHAPE} bf16", x, PROBE_S))
    bytes_ms, ops_ms = k3_bound_ms(x)
    probe = dict(shape=PROBE_SHAPE, dtype="bfloat16", s=PROBE_S, ties=probe_ties,
                 ms=time_ms(lambda: kq.quantize_int8_cuda(x, PROBE_S)),
                 plain_ms=time_ms(lambda: kq.quantize_int8_plain(x, PROBE_S), reps=5),
                 bound_ms=max(bytes_ms, ops_ms))
    half = x[: PROBE_SHAPE[0] // 16].clone()  # bf16 ties exist at s = 2
    two_ties = with_ties(half, 2.0)
    check(two_ties > 0, "no bf16 tie at s = 2")
    max_err = max(max_err, check_codes("bf16 at s = 2", half, 2.0))
    print(f"  probe {PROBE_SHAPE} bf16 s={PROBE_S} ({probe_ties} exact ties): "
          f"ms={probe['ms']:.5f} plain_ms={probe['plain_ms']:.5f} "
          f"bound_ms={probe['bound_ms']:.5f} (bytes); bf16 at s=2 with {two_ties} ties: codes "
          f"identical; max |kernel code - plain code| over all {2 * N_QUANT + 2} inputs: "
          f"{max_err}", flush=True)
    return per_shape, score_shapes, probe, max_err


def phase_int8_path(workdir: str, f32_rtf, lengths):
    """`python -m storm_tpu_torch.enhancement --quant int8` twice on phase 5's
    checkpoint and files; then the int8 path against the plain quantizer and
    against float32. Returns the first run's quantizer launches."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy, out = os.path.join(workdir, "noisy"), os.path.join(workdir, "enhanced_int8")
    cache = scale_cache_path(ckpt)
    argv = ["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt, "--mode", "storm",
            "--timeit", "--device", "cuda", "--quant", "int8",
            "--quant_min_channels", str(QUANT_MIN_CHANNELS)]
    per_file = []
    original = StochasticRegenerationModel.enhance

    def counted(model, *args, **kwargs):
        before = (kq.quantize_int8_cuda.launches, kup.upfirdn2d_cuda.launches)
        result = original(model, *args, **kwargs)
        per_file.append((kq.quantize_int8_cuda.launches - before[0],
                         kup.upfirdn2d_cuda.launches - before[1]))
        return result

    runs = []
    for run in (1, 2):
        per_file.clear()
        kq.quantize_int8_cuda.launches = kup.upfirdn2d_cuda.launches = 0
        t0 = time.perf_counter()
        with mock.patch.object(StochasticRegenerationModel, "enhance", counted):
            text = run_enhancement(argv)
        wall = time.perf_counter() - t0
        totals = (kq.quantize_int8_cuda.launches, kup.upfirdn2d_cuda.launches)
        check_outputs(out, lengths)
        calibrated = 1 if run == 1 else 0
        if run == 1:
            check(f"int8 calibration done ({2 * N_QUANT} convs quantized; scales saved to "
                  f"{cache})" in text and os.path.exists(cache), "run 1 did not calibrate")
        else:
            check(f"int8 scales loaded from {cache} ({2 * N_QUANT} convs quantized" in text,
                  "run 2 did not load the cached scales")
        check(per_file == [(K3_PER_FILE, 18 * NFE)] * len(SECONDS),
              f"run {run}: launches per file {per_file}, expected "
              f"{(K3_PER_FILE, 18 * NFE)} for each of {len(SECONDS)}")
        check(totals == (K3_PER_FILE * len(SECONDS),
                         18 * (NFE * len(SECONDS) + calibrated * CALIB_FORWARDS)),
              f"run {run}: launches {totals}")
        runs.append(dict(rtf=rtf_of(text), totals=totals, wall=wall))
        print(f"  run {run}: {wall:.2f} s wall; quantizer launches {totals[0]} "
              f"({K3_PER_FILE} per file), upfirdn2d {totals[1]} (18 x {NFE} per file"
              f"{f' + 18 x {CALIB_FORWARDS} calibration forwards' if calibrated else ''})",
              flush=True)

    # the same files and noise, direct: int8 through the kernel, int8 with
    # the plain quantizer (4 s file), float32; cuDNN deterministic
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    quant = quant_mod.load_scales(cache)
    torch.backends.cudnn.deterministic = True
    try:
        for name in lengths:
            y = bucketed(load_wav(os.path.join(noisy, name))[0])

            def enhance(**kw):
                gen = torch.Generator(device="cuda").manual_seed(0)
                return model.enhance(y, N=N_STEPS, corrector="ald", generator=gen, **kw)[0]

            x8, x32 = enhance(quant=quant), enhance()
            check(bool(torch.isfinite(x8).all()), f"{name}: int8 output not finite")
            scale = x32.abs().max().item()
            rel = (x8 - x32).abs().max().item() / scale
            line = (f"  {name}: RTF f32 {f32_rtf[name]:.4f} (phase 5), int8 "
                    f"{runs[0]['rtf'][name]:.4f} / {runs[1]['rtf'][name]:.4f} (runs 1 / 2); "
                    f"max|int8 - f32| / max|f32| = {rel:.4e}")
            if name == max(lengths, key=lengths.get):
                with mock.patch.object(qconv, "quantize_int8", kq.quantize_int8_plain):
                    xp = enhance(quant=quant)
                err, s8 = (x8 - xp).abs().max().item(), xp.abs().max().item()
                line += f"; kernel vs plain quantizer max abs err {err:.3e} (scale {s8:.3e})"
                check(err <= 1e-6 * s8, f"{name}: int8 path with the kernel disagrees with the "
                                        f"plain quantizer ({err:.3e})")
            print(line, flush=True)
    finally:
        torch.backends.cudnn.deterministic = False
    return runs[0]["totals"][0]


def phase_fused_act(gen: torch.Generator):
    """K2 through its op API, forward and gradient, against autograd of plain."""
    inputs = [tuple(torch.randn(shape if i != 1 else shape[-1:], device="cuda", generator=gen)
                    for i in range(3)) for shape in K2_SHAPES]
    kfa.fused_leaky_relu_cuda.launches = 0
    results = []
    for x, b, g in inputs:
        xk, bk = x.clone().requires_grad_(), b.clone().requires_grad_()
        out = kfa.fused_leaky_relu(xk, bk)
        results.append((out.detach(), *torch.autograd.grad(out, (xk, bk), g)))
    torch.cuda.synchronize()
    launches = kfa.fused_leaky_relu_cuda.launches
    check(launches == len(K2_SHAPES), f"fused_leaky_relu launched {launches} times")
    max_err = 0.0
    for (x, b, g), (out, gx, gb) in zip(inputs, results):
        xp, bp = x.clone().requires_grad_(), b.clone().requires_grad_()
        want = kfa.fused_leaky_relu_plain(xp, bp)
        hx, hb = torch.autograd.grad(want, (xp, bp), g)
        what = f"fused_leaky_relu {tuple(x.shape)}"
        errs = []
        # the forward at atol = rtol = 1e-6; both gradients exactly: the
        # backward is autograd's own arithmetic on the kernel's mask
        for part, got, ref, exact in (("forward", out, want.detach(), False),
                                      ("grad x", gx, hx, True), ("grad bias", gb, hb, True)):
            errs.append((got - ref).abs().max().item())
            ok = torch.equal(got, ref) if exact else torch.allclose(got, ref, atol=1e-6, rtol=1e-6)
            check(ok, f"{what} {part}: max abs err {errs[-1]:.3e}"
                      f"{' (must be 0)' if exact else ''}")
        max_err = max(max_err, *errs)
        print(f"  {what}: max abs err forward {errs[0]:.2e}, grad x {errs[1]:.2e}, grad bias "
              f"{errs[2]:.2e} (largest grad bias {hb.abs().max().item():.3e})", flush=True)
    x, b, _ = inputs[0]
    n = x.numel()
    bytes_ms = (8.0 * n + 4.0 * b.numel()) / PEAK_BYTES_PER_S * 1e3
    ops_ms = 4.0 * n / PEAK_F32_FLOP_PER_S * 1e3
    with torch.no_grad():
        r = dict(ms=time_ms(lambda: kfa.fused_leaky_relu_cuda(x, b)),
                 device_ms=device_ms([lambda: kfa.fused_leaky_relu_cuda(x, b)],
                                     "fused_leaky_relu_kernel")[0],
                 mask_ms=time_ms(lambda: kfa.fused_leaky_relu_cuda(x, b, with_mask=True)),
                 plain_ms=time_ms(lambda: kfa.fused_leaky_relu_plain(x, b), reps=5),
                 bytes_ms=bytes_ms, ops_ms=ops_ms, launches=launches, max_abs_err=max_err)
    print(f"  fused_leaky_relu {tuple(x.shape)}: ms={r['ms']:.5f} device_ms={r['device_ms']:.5f} "
          f"(with the mask "
          f"{r['mask_ms']:.5f}) plain_ms={r['plain_ms']:.5f} bound_ms={max(bytes_ms, ops_ms):.5f} "
          f"(bytes; 9 B per element with the mask: "
          f"{9.0 * n / PEAK_BYTES_PER_S * 1e3:.5f})", flush=True)
    return r


def phase_profile_int8(workdir: str):
    """Trace one int8 enhancement of the 4 s file (CLI defaults)."""
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    quant = quant_mod.load_scales(scale_cache_path(os.path.join(workdir, "storm.pt")))
    y = bucketed(synth_wav(max(SECONDS), 0, np.random.default_rng(0))[None])
    model.enhance(y, N=2, corrector="ald", quant=quant)  # warm-up at the same shapes
    profile_run(f"int8 enhance {max(SECONDS)} s file",
                lambda: model.enhance(y, N=N_STEPS, corrector="ald", quant=quant), INT8_GROUPS)


# --- serving at batch > 1 (phases 14-17)

# the batched CLI: two buckets of four files, 1 s (16384 samples, 192 frames)
# and 4 s (65536 samples, 576 frames), 19.6 s of audio
CLI_BATCH, BATCH_SECONDS = 4, (1.0, 1.0, 1.01, 1.02, 3.7, 3.85, 4.0, 4.0)
INVARIANCE_N = 5
# the server and streaming runs use N=10 (21 NFE) to stay within time
SERVE_N = 10
SERVE_NFE = 1 + 2 * SERVE_N
SERVE_BATCH, SERVE_CLIENTS, INT8_REQUESTS = 4, 8, 8
SERVE_SECONDS = (1.0, 3.6, 1.0, 3.7, 1.01, 3.8, 1.02, 3.9, 1.0, 4.0, 1.015, 4.0)
SERVE_WARMUP = "1.0,4.0"  # the two buckets the requests span
STREAM_S, STREAM_CHUNK_S, STREAM_OVERLAP_S, STREAM_ROWS = 12.0, 2.0, 0.5, 8
K1_PER_FORWARD = len(k1_calls(6))  # 18 upfirdn2d calls per NCSN++ forward


@contextlib.contextmanager
def shapes_recorded():
    """While active, every upfirdn2d call of NCSN++ (nn/resample.py) adds its
    (config, B, C, H, W, dtype) to the first yielded set and every activation
    quantizer call (nn/qconv.py) its (input shape, dtype, product dtype) to
    the second; the calls run as before (threads included)."""
    k1, k3 = set(), set()

    def upfirdn2d(x, kernel, up=1, down=1, pad=(0, 0)):
        k1.add(("up" if up == 2 else "down", *x.shape, x.dtype))
        return kup.upfirdn2d(x, kernel, up=up, down=down, pad=pad)

    def quantize_int8(x, inv, product=torch.float32):
        k3.add((tuple(x.shape), x.dtype, product))
        return kq.quantize_int8(x, inv, product)

    with mock.patch.object(resample, "upfirdn2d", upfirdn2d), \
            mock.patch.object(qconv, "quantize_int8", quantize_int8):
        yield k1, k3


def check_k1_at(what: str, shapes, gen) -> float:
    """upfirdn2d against plain (both FIRs) at every recorded shape, in its
    recorded dtype."""
    flips = {fir: n[1] for fir, n in BF16_FLIPS["upfirdn2d"].items()}
    errs = [check_forward(cfg, torch.randn(B, C, H, W, device="cuda", generator=gen).to(dtype))
            for cfg, B, C, H, W, dtype in sorted(shapes, key=str)]
    tops = sorted({(B, W) for cfg, B, C, H, W, _ in shapes if cfg == "down" and H == FREQS})
    dtypes = sorted({str(s[-1]).split(".")[-1] for s in shapes})
    flips = {fir: n[1] - flips[fir] for fir, n in BF16_FLIPS["upfirdn2d"].items()}
    print(f"  upfirdn2d against plain at the {len(shapes)} shapes {what} gave it ({dtypes}; "
          f"(B, W) at the top level: {tops}): max abs err {max(errs):.2e}"
          + (f"; bfloat16 elements that differ (by 1 ulp): {flips['ncsnpp']} with NCSN++'s "
             f"FIR, {flips['asym']} with the asymmetric one" if "bfloat16" in dtypes else ""),
          flush=True)
    torch.cuda.empty_cache()
    return max(errs)


def check_k3_at(what: str, shapes, gen) -> int:
    """The quantizer's codes against plain at every recorded (input shape,
    dtype, product), ties of that product's mode and saturating values
    written in, s = 12.7."""
    err = 0
    for shape, dtype, product in sorted(shapes, key=str):
        x = (10.0 * torch.randn(shape, device="cuda", generator=gen)).to(dtype)
        with_ties(x, PROBE_S, product)
        err = max(err, check_codes(f"{what} {shape} {dtype} product {product}", x, PROBE_S,
                                   product))
    print(f"  quantize_int8 codes identical to plain at the {len(shapes)} input shapes {what} "
          f"gave it (batch rows {sorted({s[0][0] for s in shapes})}; "
          f"{sorted({(str(d), str(p)) for _, d, p in shapes})})", flush=True)
    torch.cuda.empty_cache()
    return err


def write_named_wavs(directory: str, seconds, prefix: str, seed: int):
    """One synthesized file per entry of `seconds`; returns {name: samples}."""
    os.makedirs(directory)
    rng = np.random.default_rng(seed)
    lengths = {}
    for i, s in enumerate(seconds):
        name = f"{prefix}{i:02d}_{s:.3f}s.wav"
        x = synth_wav(s, i, rng)
        save_wav(os.path.join(directory, name), x, SR)
        lengths[name] = x.shape[-1]
    return lengths


class SlicedNoise:
    """A noise source handing out pre-drawn (B, F, T, 2) draws in order,
    rows `rows` of each."""

    def __init__(self, draws, rows):
        self.draws, self.rows, self.used = draws, rows, 0

    def __call__(self, shape):
        z = self.draws[self.used][self.rows]
        check(tuple(z.shape[:-1]) == tuple(shape), f"noise {tuple(z.shape)} for {shape}")
        self.used += 1
        return z


def phase_batch_invariance(model, ys: np.ndarray, gen: torch.Generator) -> float:
    """One batch with injected noise against each row enhanced alone with its
    rows of the same noise; returns the largest |row alone - row in batch| /
    max|row in batch|."""
    B, T = ys.shape
    enh = BucketedEnhancer(model, N=INVARIANCE_N, corrector="ald")
    draws = [torch.randn(B, FREQS, bucket_frames(T), 2, device="cuda", generator=gen) * 0.5 ** 0.5
             for _ in range(1 + 2 * INVARIANCE_N)]
    torch.backends.cudnn.deterministic = True
    try:
        x_all, _ = enh(ys, noise=SlicedNoise(draws, slice(None)))
        worst = 0.0
        for i in range(B):
            xi, _ = enh(ys[i: i + 1], noise=SlicedNoise(draws, slice(i, i + 1)))
            worst = max(worst, float(np.abs(xi[0] - x_all[i]).max() / np.abs(x_all[i]).max()))
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"  batch invariance (B={B} at {bucket_frames(T)} frames, N={INVARIANCE_N}, injected "
          f"noise): max |row alone - row in batch| / max |row| = {worst:.3e}", flush=True)
    check(worst <= 1e-4, f"a row enhanced alone differs from its batch by {worst:.3e} (> 1e-4)")
    return worst


def phase_batched_cli(workdir: str, gen: torch.Generator):
    """Phase 14. Returns (upfirdn2d launches, the kernel's max error, the files'
    directory, {file: output})."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy, out = os.path.join(workdir, "batch_noisy"), os.path.join(workdir, "batch_enhanced")
    lengths = write_named_wavs(noisy, BATCH_SECONDS, "b", seed=3)
    buckets = {}
    for n in lengths.values():
        buckets[-(-n // BUCKET)] = buckets.get(-(-n // BUCKET), 0) + 1
    calls = sum(-(-k // CLI_BATCH) for k in buckets.values())
    kup.upfirdn2d_cuda.launches = 0
    t0 = time.perf_counter()
    outputs = {}
    with shapes_recorded() as (k1_shapes, _):
        text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                                "--mode", "storm", "--batch", str(CLI_BATCH), "--timeit",
                                "--device", "cuda"], outputs)
    wall = time.perf_counter() - t0
    launches = kup.upfirdn2d_cuda.launches
    check_outputs(out, lengths)
    batches = [(int(k), int(nfe), float(rtf)) for k, nfe, rtf in
               re.findall(r"batch of (\d+): nfe=(\d+) rtf=([0-9.]+)", text)]
    check(len(batches) == calls and all(nfe == NFE for _, nfe, _ in batches),
          f"batch lines {batches}, expected {calls} of nfe {NFE}")
    expected = K1_PER_FORWARD * NFE * calls
    audio_s = sum(lengths.values()) / SR
    print(f"  {len(lengths)} files ({audio_s:.3f} s of audio) in {calls} calls of B={CLI_BATCH} "
          f"(buckets {sorted(b * BUCKET for b in buckets)} samples): {wall:.2f} s wall, "
          f"{audio_s / wall:.4f} audio s per wall s; RTF per batch {[b[2] for b in batches]}; "
          f"upfirdn2d launches {launches} (expected {K1_PER_FORWARD} x {NFE} x {calls} = "
          f"{expected})",
          flush=True)
    check(launches == expected, f"upfirdn2d launched {launches} times, expected {expected}")
    err = check_k1_at("the batched CLI", k1_shapes, gen)

    model = build_model(STORM_CONFIG, device="cuda", seed=0)  # the checkpoint's weights
    first = sorted(lengths)[:CLI_BATCH]  # the 1 s bucket
    padded = -(-max(lengths[f] for f in first) // BUCKET) * BUCKET
    ys = np.stack([np.pad(load_wav(os.path.join(noisy, f))[0][0], (0, padded - lengths[f]))
                   for f in first])
    phase_batch_invariance(model, ys, gen)
    del model
    torch.cuda.empty_cache()
    return launches, err, noisy, outputs


def serve_args(ckpt: str, *extra):
    return serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--port", "0", "--batch", str(SERVE_BATCH),
         "--N", str(SERVE_N), "--warmup_buckets", SERVE_WARMUP, "--device", "cuda", *extra])


def http_call(host, port, method, path, body=None):
    """(status, headers, payload, seconds) of one request on its own connection."""
    conn = http.client.HTTPConnection(host, port, timeout=900)
    try:
        t0 = time.perf_counter()
        conn.request(method, path, body=body)
        r = conn.getresponse()
        payload = r.read()
        return r.status, dict(r.getheaders()), payload, time.perf_counter() - t0
    finally:
        conn.close()


def run_server(what: str, args, waves):
    """Build the server in this process, send `waves` from SERVE_CLIENTS
    client threads, read /healthz and /stats, stop it. Returns a dict of what
    was measured, with the kernels' launches from before the build (warm-up
    and calibration included) and the shapes the kernels were given."""
    kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
    with shapes_recorded() as (k1_shapes, k3_shapes):
        t0 = time.perf_counter()
        (httpd, batcher), build_text = captured(serve.build_server, args)
        build_s = time.perf_counter() - t0
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            host, port = httpd.server_address[:2]
            health = json.loads(http_call(host, port, "GET", "/healthz")[2])
            bodies = [encode_wav_bytes(w, SR) for w in waves]
            with concurrent.futures.ThreadPoolExecutor(SERVE_CLIENTS) as pool:
                t0 = time.perf_counter()
                replies = list(pool.map(
                    lambda body: http_call(host, port, "POST", "/enhance", body), bodies))
                wall = time.perf_counter() - t0
            stats = json.loads(http_call(host, port, "GET", "/stats")[2])
        finally:
            httpd.shutdown()
            httpd.server_close()
            batcher.close()
            thread.join(timeout=60)
    torch.cuda.synchronize()
    check(not thread.is_alive(), f"{what}: the server thread did not stop")
    for (status, headers, payload, _), w in zip(replies, waves):
        check(status == 200, f"{what}: reply {status}: {payload[:300]!r}")
        x, sr = decode_wav_bytes(payload)
        check(sr == SR and x.shape == (1, w.shape[-1]) and bool(np.isfinite(x).all()),
              f"{what}: reply of shape {x.shape} for {w.shape[-1]} samples")
        check(int(headers["X-NFE"]) == SERVE_NFE, f"{what}: X-NFE {headers['X-NFE']}")
    n = len(waves)
    check(stats["requests"] == n and stats["errors"] == 0 and stats["batched_requests"] == n,
          f"{what}: /stats {stats}")
    check(stats["batched_requests"] > stats["batches"], f"{what}: no batch of more than one row")
    latency = np.array([r[3] for r in replies])
    warmups = len(health["warmup_buckets_s"]) * len(health["row_sizes"])
    audio_s = sum(w.shape[-1] for w in waves) / SR
    print(f"  {what} on {health['device_name']} ({health['device']}), N={SERVE_N} "
          f"({SERVE_NFE} NFE), row sizes {health['row_sizes']}, {warmups} warm-up calls; "
          f"built in {build_s:.2f} s", flush=True)
    print(f"  {what}: {n} requests ({audio_s:.3f} s of audio) from {SERVE_CLIENTS} clients in "
          f"{wall:.3f} s: {audio_s / wall:.4f} audio s served per wall s", flush=True)
    print(f"  {what}: latency p50 {np.percentile(latency, 50):.3f} s, p95 "
          f"{np.percentile(latency, 95):.3f} s, max {latency.max():.3f} s (over {n} requests "
          f"the p95 is interpolated between the two slowest: a smoke reading, not a tail)",
          flush=True)
    print(f"  {what}: {stats['batches']} batches, batch fill {stats['batch_fill']} "
          f"({stats['batched_requests']} requests in {stats['row_slots']} rows), device_s "
          f"{stats['device_s']:.3f}, /stats rtf {stats['rtf']}", flush=True)
    check(health["dtype"] == args.dtype, f"{what}: /healthz reports dtype {health['dtype']}")
    return dict(stats=stats, warmups=warmups, k1=kup.upfirdn2d_cuda.launches,
                k3=kq.quantize_int8_cuda.launches, k1_shapes=k1_shapes, k3_shapes=k3_shapes,
                build_text=build_text, audio_per_s=audio_s / wall,
                p50=float(np.percentile(latency, 50)), max=float(latency.max()))


def phase_server(workdir: str, calib_dir: str, gen: torch.Generator):
    """Phase 15. Returns ({path: upfirdn2d launches}, K3 launches, K1 error, K3 error)."""
    rng = np.random.default_rng(4)
    waves = [synth_wav(s, i, rng) for i, s in enumerate(SERVE_SECONDS)]
    ckpt = os.path.join(workdir, "storm.pt")
    f32 = run_server("f32 server", serve_args(ckpt, "--dtype", "float32"), waves)
    want = K1_PER_FORWARD * SERVE_NFE * (f32["warmups"] + f32["stats"]["batches"])
    print(f"  f32 server: upfirdn2d launches {f32['k1']} (expected {K1_PER_FORWARD} x "
          f"{SERVE_NFE} x "
          f"({f32['warmups']} warm-up + {f32['stats']['batches']} batches) = {want})", flush=True)
    check(f32["k1"] == want and f32["k3"] == 0, f"f32 server launched {f32['k1']}, {f32['k3']}")

    # int8 at a checkpoint path of its own, so that it calibrates
    ckpt8 = os.path.join(workdir, "storm_serve.pt")
    os.link(ckpt, ckpt8)
    q = run_server("int8 server", serve_args(ckpt8, "--dtype", "float32", "--quant", "int8",
                                             "--calib_dir", calib_dir), waves[:INT8_REQUESTS])
    check(os.path.exists(scale_cache_path(ckpt8)), "the int8 server did not write its scales")
    served = q["warmups"] + q["stats"]["batches"]
    want1 = K1_PER_FORWARD * (calib_forwards(min(SERVE_N, 10)) + SERVE_NFE * served)
    want3 = N_QUANT * SERVE_NFE * served
    print(f"  int8 server: quantizer launches {q['k3']} (expected {N_QUANT} x {SERVE_NFE} x "
          f"({q['warmups']} warm-up + {q['stats']['batches']} batches) = {want3}; calibration "
          f"launches none), upfirdn2d {q['k1']} (expected {want1}, calibration included)",
          flush=True)
    check(q["k3"] == want3 and q["k1"] == want1, f"int8 server launched {q['k3']}, {q['k1']}")
    k1_err = check_k1_at("the servers", f32["k1_shapes"] | q["k1_shapes"], gen)
    k3_err = check_k3_at("the int8 server", q["k3_shapes"], gen)
    return {"server": f32["k1"], "server_int8": q["k1"]}, q["k3"], k1_err, k3_err


def phase_streaming(workdir: str, gen: torch.Generator):
    """Phase 16: the streaming CLI on one long file, f32 then int8, with K1
    held to plain at every shape both runs gave it and K3 at every input
    shape of the int8 run. Returns ({path: upfirdn2d launches}, K3 launches,
    K1 error, K3 error)."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy = os.path.join(workdir, "stream_noisy")
    out = os.path.join(workdir, "stream_enhanced")
    lengths = write_named_wavs(noisy, (STREAM_S,), "long", seed=5)
    T = next(iter(lengths.values()))
    chunk = -(-int(STREAM_CHUNK_S * SR) // BUCKET) * BUCKET
    overlap = int(STREAM_OVERLAP_S * SR)
    chunks = len(range(0, T - overlap, chunk - overlap))
    calls = -(-chunks // STREAM_ROWS)
    argv = ["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt, "--mode", "storm",
            "--N", str(SERVE_N), "--stream_chunk_s", str(STREAM_CHUNK_S), "--stream_overlap_s",
            str(STREAM_OVERLAP_S), "--timeit", "--device", "cuda"]
    k1, k3_launches, shapes, k3_shapes = {}, 0, set(), set()
    for run, extra in (("streaming", []), ("streaming_int8", ["--quant", "int8"])):
        kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
        t0 = time.perf_counter()
        with shapes_recorded() as (k1_shapes, q_shapes):
            text = run_enhancement(argv + extra)
        wall = time.perf_counter() - t0
        check_outputs(out, lengths)
        shapes |= k1_shapes
        k3_shapes |= q_shapes
        k1[run] = kup.upfirdn2d_cuda.launches
        k3 = kq.quantize_int8_cuda.launches
        calib = calib_forwards(min(SERVE_N, 10)) if extra else 0
        want1 = K1_PER_FORWARD * (calib + SERVE_NFE * calls)
        want3 = N_QUANT * SERVE_NFE * calls if extra else 0
        rtf = rtf_of(text)
        print(f"  {run}: {T / SR:.1f} s file in {chunks} chunks of {chunk} samples "
              f"({bucket_frames(chunk)} frames), {calls} call(s) of {STREAM_ROWS} rows; "
              f"{wall:.2f} s wall, RTF {list(rtf.values())}; upfirdn2d launches {k1[run]} "
              f"(expected {want1}{' with calibration' if calib else ''}), quantizer {k3} "
              f"(expected {want3})", flush=True)
        check(k1[run] == want1 and k3 == want3, f"{run}: launches {k1[run]}, {k3}")
        if extra:
            k3_launches = k3
            meta = quant_mod.load_scales_with_meta(scale_cache_path(ckpt))[1]
            check(meta["stream_chunk_s"] == STREAM_CHUNK_S and meta["calib_len"] == chunk,
                  f"int8 scale cache meta {meta}")
            print(f"  int8 scale cache: stream_chunk_s {meta['stream_chunk_s']}, calib_len "
                  f"{meta['calib_len']}", flush=True)
    check(bool(k3_shapes), "the int8 streaming run gave the quantizer no input")
    return (k1, k3_launches, check_k1_at("streaming", shapes, gen),
            check_k3_at("the int8 streaming run", k3_shapes, gen))


def phase_profile_batch():
    """Phase 17: trace one B=4 enhancement at the 4 s bucket (CLI defaults)."""
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    ys = np.stack([synth_wav(max(SECONDS), i, rng) for i in range(CLI_BATCH)])
    BucketedEnhancer(model, N=2, corrector="ald")(ys)  # warm-up at the same shapes
    enh = BucketedEnhancer(model, N=N_STEPS, corrector="ald")
    profile_run(f"enhance B={CLI_BATCH} x {max(SECONDS)} s ({FRAMES} frames)", lambda: enh(ys))


# --- bfloat16 serving (phases 18-23)

BF16 = torch.bfloat16
# GroupNorm inputs of a full-width net: 128 channels at the top level of a
# 4 s request (B=1) and 256 channels one level down at B=4
GN_SHAPES = [(1, 128, FREQS, FRAMES), (4, 256, FREQS // 2, FRAMES // 2)]
BF16_GROUPS = {
    **K1_GROUPS,
    "convolutions (cuDNN)": (("fprop", "implicit_convolve", "conv2d", "convolve"), None),
    "NCHW/NHWC layout transforms": (("ToNhwc", "ToNchw", "nchwToNhwc", "nhwcToNchw"), None),
    "matrix products (cuBLAS)": (("nvjet", "xmma_gemm", "gemv"), None),
    "GroupNorm statistics (reductions)": (("reduce_kernel",), None),
    "elementwise": (("elementwise",), None),
}


def phase_bf16_kernels(gen: torch.Generator):
    """Phase 18. K1 in bfloat16 against plain at the main path's shapes (B=1,
    576 frames), timed; the adjoint's bfloat16 instance at every train-step
    backward shape (B=8, 256 x 256); GroupNorm on bfloat16 with float32 scale
    and bias against float32 GroupNorm rounded once; one full-width NCSN++
    forward in bfloat16 through the kernel and the plain version, and its
    time against float32's. Returns (per-shape times, the kernel's max error)."""
    per_shape, launch, max_err = {}, {}, 0.0
    for cfg, C, H, W in forward_shapes(FRAMES):
        c = CONFIGS[cfg]
        args = dict(up=c["up"], down=c["down"], pad=c["pad"])
        x = torch.randn(1, C, H, W, device="cuda", generator=gen).to(BF16)
        flips = [n[1] for n in BF16_FLIPS["upfirdn2d"].values()]
        max_err = max(max_err, check_forward(cfg, x))
        flips = "/".join(str(n[1] - f) for n, f in zip(BF16_FLIPS["upfirdn2d"].values(), flips))
        lib = library_call(cfg, C, dtype=BF16)
        want = kup.upfirdn2d_plain(x, c["kernel"], **args)
        lib_err = ulps_of_scale(lib(x), want)
        check(lib_err <= 2.0, f"library yardstick bf16 {cfg} C={C}: {lib_err:.2f} ulps off")
        Ho, Wo = want.shape[-2:]
        bytes_ms, ops_ms = bound_ms(C * H * W, C * Ho * Wo, 16 // (c["up"] ** 2), elem_bytes=2)
        per_shape[(cfg, C, H, W)] = dict(
            ms=time_ms(lambda: kup.upfirdn2d_cuda(x, c["kernel"], **args)),
            plain_ms=time_ms(lambda: kup.upfirdn2d_plain(x, c["kernel"], **args), reps=5),
            library_ms=time_ms(lambda: lib(x)), bytes_ms=bytes_ms, ops_ms=ops_ms,
            lib_err=lib_err, out=f"{Ho}x{Wo}", flips=flips)
        launch[(cfg, C, H, W)] = functools.partial(kup.upfirdn2d_cuda, x, c["kernel"], **args)
    print_per_shape("upfirdn2d bf16", per_shape, launch, "upfirdn2d_")
    print("  (bf16 lib_err in ulps of the output's scale; flips: elements that differ from "
          "plain, NCSN++'s FIR / the asymmetric one)", flush=True)

    bwd_calls = set(k1_bwd_calls())
    bwd_err = 0.0
    for cfg, C, H, W in forward_shapes(TRAIN_FRAMES):
        if (cfg, C, H, W) not in bwd_calls:
            continue
        c = CONFIGS[cfg]
        Ho, Wo = (kup.output_size(n, 4, c["up"], c["down"], c["pad"]) for n in (H, W))
        g = torch.randn(TRAIN_B, C, Ho, Wo, device="cuda", generator=gen).to(BF16)
        for fir, kern in (("ncsnpp", c["kernel"]), ("asym", ASYM)):
            bwd = (g, kern, c["up"], c["down"], c["pad"], (H, W))
            terms = kup.upfirdn2d_bwd_plain(g.abs(), np.abs(kern), *bwd[2:])
            bwd_err = max(bwd_err, compare(f"upfirdn2d_bwd bf16 {cfg} B={TRAIN_B} C={C} {H}x{W}",
                                           kup.upfirdn2d_bwd_cuda(*bwd),
                                           kup.upfirdn2d_bwd_plain(*bwd), "upfirdn2d_bwd", terms,
                                           fir))
    flips = BF16_FLIPS["upfirdn2d_bwd"]
    print(f"  upfirdn2d_bwd bf16 at every train-step backward shape (B={TRAIN_B}): within its "
          f"allowance of plain; elements that differ (by 1 ulp): {flips['ncsnpp'][1]} of "
          f"{flips['ncsnpp'][0]} with NCSN++'s FIR, {flips['asym'][1]} of {flips['asym'][0]} "
          f"with the asymmetric one; max abs err {bwd_err:.2e}", flush=True)
    torch.cuda.empty_cache()

    for shape in GN_SHAPES:
        C = shape[1]
        gn = group_norm(C).cuda().eval()
        with torch.no_grad():
            gn.weight.copy_(1.0 + 0.1 * torch.randn(C, device="cuda", generator=gen))
            gn.bias.copy_(0.1 * torch.randn(C, device="cuda", generator=gen))
        x = (torch.randn(shape, device="cuda", generator=gen) * 0.7 + 0.5).to(BF16)
        with torch.inference_mode():
            got = gn(x)
            want = F.group_norm(x.float(), gn.num_groups, gn.weight, gn.bias, gn.eps).to(BF16)
            worst = ulps_of_scale(got, want)
            differ = (got != want).float().mean().item()
            ms = time_ms(lambda: gn(x))
            f32 = x.float()
            ms_f32 = time_ms(lambda: F.group_norm(f32, gn.num_groups, gn.weight, gn.bias, gn.eps))
        print(f"  GroupNorm bf16 {shape} (float32 statistics, scale and bias): {worst:.2f} ulps "
              f"of the output's scale from float32 GroupNorm rounded once ({100 * differ:.4f}% "
              f"of elements differ); "
              f"{ms:.4f} ms against {ms_f32:.4f} ms for float32 GroupNorm of the float32 "
              f"tensor", flush=True)
        check(worst <= 1.0 and differ < 1e-3,
              f"GroupNorm bf16 {shape}: {worst:.2f} ulps, {differ:.2e} of elements from float32 "
              f"rounded once")
    torch.cuda.empty_cache()

    nets = {}
    for dtype in (torch.float32, BF16):
        net = NCSNpp(input_channels=6, init_scale=1.0, dtype=dtype)
        reset_parameters(net, torch.Generator().manual_seed(0))
        nets[dtype] = net.cuda().eval()
    x = 0.5 * torch.randn(1, 3, FREQS, FRAMES, 2, device="cuda", generator=gen)
    t = torch.full((1,), 0.5, device="cuda")
    with torch.inference_mode(), cast_params(nets[BF16], BF16):
        kup.upfirdn2d_cuda.launches = 0
        out_k = nets[BF16](x, t)
        torch.cuda.synchronize()
        launches = kup.upfirdn2d_cuda.launches
        with mock.patch.object(resample, "upfirdn2d", kup.upfirdn2d_plain):
            out_p = nets[BF16](x, t)
        out_32 = nets[torch.float32](x, t)
        ms = {dtype: time_ms(lambda: nets[dtype](x, t), reps=5, repeats=3) for dtype in nets}
    check(launches == 18, f"a bf16 NCSN++ forward launched upfirdn2d {launches} times")
    check(out_k.dtype == torch.float32 and bool(torch.isfinite(out_k).all()),
          "bf16 NCSN++ output is not finite float32")
    scale = out_32.abs().max().item()
    err = (out_k - out_p).abs().max().item()
    rel = (out_k - out_32).abs().max().item() / scale
    print(f"  NCSN++ forward in bf16 (full width, B=1, {FREQS} x {FRAMES}): kernel vs plain "
          f"path max abs err {err:.3e}; max|bf16 - f32| / max|f32| = {rel:.4e}; "
          f"{ms[BF16]:.2f} ms per forward against {ms[torch.float32]:.2f} ms in float32 "
          f"({ms[torch.float32] / ms[BF16]:.2f}x)", flush=True)
    check(err <= 1e-2 * scale, f"bf16 NCSN++ kernel path disagrees with plain ({err:.3e})")
    del nets
    torch.cuda.empty_cache()
    return per_shape, max(max_err, bwd_err)


def relative_to(outputs, reference):
    """{file: max|out - reference| / max|reference|} over the files of both."""
    return {name: float(np.abs(outputs[name] - reference[name]).max()
                        / np.abs(reference[name]).max()) for name in reference}


def phase_bf16_cli(workdir: str, f32_outputs, f32_rtf, lengths, batch_dir, batch_outputs,
                   gen: torch.Generator):
    """Phase 19. `python -m storm_tpu_torch.enhancement --dtype bfloat16` at the
    CLI defaults: the three files of phase 5, then `--batch 4` on phase 14's
    files, then `--quant int8`, which calibrates in bfloat16 (phase 16's
    streaming run left scales of another configuration in the cache; a
    cache of the same configuration would be reused whatever its dtype, as
    the reference's meta has none); exact launch counts, RTF, max|bf16 -
    f32| / max|f32| against the float32 runs on the same files and seed, K1
    at every shape. Returns ({path: K1 launches}, K3 launches, the K3 input
    shapes, K1's max error)."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy = os.path.join(workdir, "noisy")
    base = ["--ckpt", ckpt, "--mode", "storm", "--timeit", "--device", "cuda", "--dtype",
            "bfloat16"]
    k1, shapes, k3_shapes = {}, set(), set()
    outputs = {}
    kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
    with shapes_recorded() as (k1_shapes, _):
        text = run_enhancement(["--test_dir", noisy, "--enhanced_dir",
                                os.path.join(workdir, "enhanced_bf16"), *base], outputs)
    check_outputs(os.path.join(workdir, "enhanced_bf16"), lengths)
    shapes |= k1_shapes
    k1["enhancement_bf16"] = kup.upfirdn2d_cuda.launches
    want = 18 * NFE * len(SECONDS)
    rtf, rel = rtf_of(text), relative_to(outputs, f32_outputs)
    for name in lengths:
        print(f"  {name}: RTF bf16 {rtf[name]:.4f} against f32 {f32_rtf[name]:.4f} (phase 5); "
              f"max|bf16 - f32| / max|f32| = {rel[name]:.4e}", flush=True)
    print(f"  bf16 CLI: upfirdn2d launches {k1['enhancement_bf16']} (expected {want})",
          flush=True)
    check(k1["enhancement_bf16"] == want and kq.quantize_int8_cuda.launches == 0,
          f"bf16 CLI launched {k1['enhancement_bf16']}, {kq.quantize_int8_cuda.launches}")

    out, outputs = os.path.join(workdir, "batch_enhanced_bf16"), {}
    kup.upfirdn2d_cuda.launches = 0
    t0 = time.perf_counter()
    with shapes_recorded() as (k1_shapes, _):
        text = run_enhancement(["--test_dir", batch_dir, "--enhanced_dir", out, "--batch",
                                str(CLI_BATCH), *base], outputs)
    wall = time.perf_counter() - t0
    batches = [float(r) for r in re.findall(r"batch of \d+: nfe=\d+ rtf=([0-9.]+)", text)]
    shapes |= k1_shapes
    k1["batched_cli_bf16"] = kup.upfirdn2d_cuda.launches
    want = K1_PER_FORWARD * NFE * len(batches)
    rel = relative_to(outputs, batch_outputs)
    audio_s = sum(len(v) for v in batch_outputs.values()) / SR
    print(f"  bf16 --batch {CLI_BATCH}: {len(batches)} calls, RTF per batch {batches}; "
          f"{audio_s / wall:.4f} audio s per wall s; max|bf16 - f32| / max|f32| up to "
          f"{max(rel.values()):.4e}; upfirdn2d launches {k1['batched_cli_bf16']} "
          f"(expected {want})", flush=True)
    check(len(batches) == 2 and k1["batched_cli_bf16"] == want,
          f"bf16 batched CLI: {batches}, {k1['batched_cli_bf16']} launches")

    out, outputs = os.path.join(workdir, "enhanced_int8_bf16"), {}
    kup.upfirdn2d_cuda.launches = kq.quantize_int8_cuda.launches = 0
    with shapes_recorded() as (k1_shapes, q_shapes):
        text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--quant", "int8",
                                "--quant_min_channels", str(QUANT_MIN_CHANNELS), *base], outputs)
    check_outputs(out, lengths)
    calibrated = "int8 calibration done" in text
    check(calibrated or f"int8 scales loaded from {scale_cache_path(ckpt)}" in text,
          "the int8 bf16 run neither calibrated nor loaded scales")
    shapes |= k1_shapes
    k3_shapes |= q_shapes
    k1["enhancement_int8_bf16"] = kup.upfirdn2d_cuda.launches
    k3 = kq.quantize_int8_cuda.launches
    rtf, rel = rtf_of(text), relative_to(outputs, f32_outputs)
    for name in lengths:
        print(f"  {name}: RTF int8 bf16 {rtf[name]:.4f}; max|int8 bf16 - f32| / max|f32| = "
              f"{rel[name]:.4e}", flush=True)
    want = 18 * (NFE * len(SECONDS) + (CALIB_FORWARDS if calibrated else 0))
    print(f"  int8 bf16 CLI ({'calibrated in bf16' if calibrated else 'scales loaded'}): "
          f"quantizer launches {k3} (expected {K3_PER_FILE * len(SECONDS)}), upfirdn2d "
          f"{k1['enhancement_int8_bf16']} (expected {want})", flush=True)
    check(k3 == K3_PER_FILE * len(SECONDS) and k1["enhancement_int8_bf16"] == want,
          f"int8 bf16 CLI launched {k3}, {k1['enhancement_int8_bf16']}")
    check({s[-1] for s in shapes} == {BF16}, f"a bf16 run gave upfirdn2d {shapes}")
    check({(d, p) for _, d, p in k3_shapes} == {(BF16, BF16)},
          f"the int8 bf16 run's quantizer inputs {k3_shapes}")
    return k1, k3, k3_shapes, check_k1_at("the bf16 CLI runs", shapes, gen)


def phase_bf16_quantizer(workdir: str):
    """Phase 20. K3's bfloat16-product mode at every quantized-conv input of
    one int8 bf16 forward of each net at the 4 s request's width (110 calls),
    bfloat16-product ties and saturating values written in: codes identical
    to plain; per-shape times for the score net. Returns (per-shape times,
    the score forward's shapes, the largest |kernel code - plain code|)."""
    model = build_model(dict(STORM_CONFIG, dtype="bfloat16"), device="cuda", seed=0)
    quant = quant_mod.load_scales(scale_cache_path(os.path.join(workdir, "storm.pt")))
    name = f"utt{len(SECONDS) - 1}_{SECONDS[-1]:.1f}s.wav"
    y = bucketed(load_wav(os.path.join(workdir, "noisy", name))[0])
    calls = []

    def capture(net):
        def hook(mod, inp, out):
            if mod.a_scale is not None:
                calls.append((net, inp[0].clone(), qconv.activation_inverse(mod.a_scale)))
        return hook

    hooks = [m.register_forward_hook(capture(net))
             for net in ("denoiser", "score")
             for m in qconv.quantizable_convs(getattr(model, f"{net}_net")).values()]
    try:
        with torch.inference_mode():
            model.enhance(y, N=1, corrector="none", quant=quant)
    finally:
        for h in hooks:
            h.remove()
    check(len(calls) == 2 * N_QUANT and all(x.dtype == BF16 for _, x, _ in calls),
          f"{len(calls)} bf16 quantized conv calls, expected {2 * N_QUANT}")
    per_shape, launch, score_shapes, ties, max_err = {}, {}, [], 0, 0
    with torch.inference_mode():
        for net, x, inv in calls:
            shape = tuple(x.shape)
            ties += with_ties(x, inv, BF16)
            max_err = max(max_err, check_codes(f"{net} {shape} bf16", x, inv, BF16))
            if net != "score":
                continue
            score_shapes.append(shape)
            if shape not in per_shape:
                bytes_ms, ops_ms = k3_bound_ms(x)
                per_shape[shape] = dict(
                    ms=time_ms(lambda: kq.quantize_int8_cuda(x, inv, BF16)),
                    plain_ms=time_ms(lambda: kq.quantize_int8_plain(x, inv, BF16), reps=5),
                    bytes_ms=bytes_ms, ops_ms=ops_ms, calls=0)
                launch[shape] = functools.partial(kq.quantize_int8_cuda, x, inv, BF16)
            per_shape[shape]["calls"] += 1
        for shape, dev in zip(launch, device_ms(list(launch.values()), "quantize_int8_kernel")):
            per_shape[shape]["device_ms"] = dev
    del calls, launch, model
    print(f"  {2 * N_QUANT} quantized conv inputs (bf16, product in bf16), {ties} bf16-product "
          f"ties written in: codes identical to plain", flush=True)
    for shape, r in per_shape.items():
        print(f"  quantize_int8 bf16-product {shape} x{r['calls']} per score forward: "
              f"ms={r['ms']:.5f} device_ms={r['device_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
              f"bound_ms={max(r['bytes_ms'], r['ops_ms']):.5f} (bytes) device/bound="
              f"{r['device_ms'] / r['bytes_ms']:.2f}", flush=True)
    torch.cuda.empty_cache()
    return per_shape, score_shapes, max_err


def phase_bf16_server(workdir: str, gen: torch.Generator):
    """Phase 21. The server at its default dtype (bfloat16) on phase 15's
    burst, then int8 + bf16 on phase 15's int8 checkpoint (its scales
    loaded). Returns ({path: K1 launches}, K3 launches, K1 error, K3 error)."""
    rng = np.random.default_rng(4)
    waves = [synth_wav(s, i, rng) for i, s in enumerate(SERVE_SECONDS)]
    ckpt = os.path.join(workdir, "storm.pt")
    args = serve_args(ckpt)
    check(args.dtype == "bfloat16", f"the server's default dtype is {args.dtype}")
    bf = run_server("bf16 server", args, waves)
    want = K1_PER_FORWARD * SERVE_NFE * (bf["warmups"] + bf["stats"]["batches"])
    print(f"  bf16 server: upfirdn2d launches {bf['k1']} (expected {want})", flush=True)
    check(bf["k1"] == want and bf["k3"] == 0, f"bf16 server launched {bf['k1']}, {bf['k3']}")
    ckpt8 = os.path.join(workdir, "storm_serve.pt")
    q = run_server("int8 bf16 server", serve_args(ckpt8, "--quant", "int8"),
                   waves[:INT8_REQUESTS])
    check("int8 scales loaded" in q["build_text"], "the int8 bf16 server did not load its scales")
    served = q["warmups"] + q["stats"]["batches"]
    want1, want3 = K1_PER_FORWARD * SERVE_NFE * served, N_QUANT * SERVE_NFE * served
    print(f"  int8 bf16 server: quantizer launches {q['k3']} (expected {want3}), upfirdn2d "
          f"{q['k1']} (expected {want1}); audio s per wall s {q['audio_per_s']:.4f} against "
          f"bf16's {bf['audio_per_s']:.4f}", flush=True)
    check(q["k3"] == want3 and q["k1"] == want1, f"int8 bf16 server launched {q['k3']}, {q['k1']}")
    check({s[-1] for s in bf["k1_shapes"] | q["k1_shapes"]} == {BF16}, "a bf16 server ran f32")
    k1_err = check_k1_at("the bf16 servers", bf["k1_shapes"] | q["k1_shapes"], gen)
    k3_err = check_k3_at("the int8 bf16 server", q["k3_shapes"], gen)
    return {"server_bf16": bf["k1"], "server_int8_bf16": q["k1"]}, q["k3"], k1_err, k3_err


def phase_bf16_streaming(workdir: str, gen: torch.Generator):
    """Phase 22. The streaming CLI in bfloat16 on phase 16's 12 s file.
    Returns (K1 launches, K1 error)."""
    ckpt = os.path.join(workdir, "storm.pt")
    noisy, out = os.path.join(workdir, "stream_noisy"), os.path.join(workdir, "stream_bf16")
    lengths = {f: load_wav(os.path.join(noisy, f))[0].shape[-1] for f in os.listdir(noisy)}
    T = next(iter(lengths.values()))
    chunk = -(-int(STREAM_CHUNK_S * SR) // BUCKET) * BUCKET
    overlap = int(STREAM_OVERLAP_S * SR)
    calls = -(-len(range(0, T - overlap, chunk - overlap)) // STREAM_ROWS)
    kup.upfirdn2d_cuda.launches = 0
    t0 = time.perf_counter()
    with shapes_recorded() as (k1_shapes, _):
        text = run_enhancement(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                                "--mode", "storm", "--N", str(SERVE_N), "--stream_chunk_s",
                                str(STREAM_CHUNK_S), "--stream_overlap_s", str(STREAM_OVERLAP_S),
                                "--timeit", "--device", "cuda", "--dtype", "bfloat16"])
    wall = time.perf_counter() - t0
    check_outputs(out, lengths)
    launches = kup.upfirdn2d_cuda.launches
    want = K1_PER_FORWARD * SERVE_NFE * calls
    print(f"  streaming bf16: {T / SR:.1f} s file, {calls} call(s) of {STREAM_ROWS} rows; "
          f"{wall:.2f} s wall, RTF {list(rtf_of(text).values())}; upfirdn2d launches "
          f"{launches} (expected {want})", flush=True)
    check(launches == want and {s[-1] for s in k1_shapes} == {BF16},
          f"streaming bf16 launched {launches}")
    return launches, check_k1_at("bf16 streaming", k1_shapes, gen)


def phase_profile_bf16():
    """Phase 23: trace one bfloat16 enhancement of the 4 s file (CLI defaults)."""
    model = build_model(dict(STORM_CONFIG, dtype="bfloat16"), device="cuda", seed=0)
    y = bucketed(synth_wav(max(SECONDS), 0, np.random.default_rng(0))[None])
    model.enhance(y, N=2, corrector="ald")  # warm-up at the same shapes
    profile_run(f"bf16 enhance {max(SECONDS)} s file",
                lambda: model.enhance(y, N=N_STEPS, corrector="ald"), BF16_GROUPS)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace one enhancement, two train steps, one int8 "
                             "enhancement, one B=4 enhancement and one bf16 enhancement and "
                             "print the device time by kernel")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py runs on a card only")
    t_start = time.perf_counter()

    print("== phase 1: device", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    resolve_device("cuda")  # TF32 off for float32 matmuls and convolutions
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}", flush=True)

    print("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    logs = build.build()
    kup._lib(), kq._lib(), kfa._lib()
    print(f"  built {list(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.2f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  [{name}] {line.strip()}")

    print("== phase 3: upfirdn2d kernel against plain at the main path's shapes", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    per_shape, max_err = phase_kernel_vs_plain(gen)

    print("== phase 4: full-width NCSN++ forward, kernel path against plain path", flush=True)
    phase_full_width_forward(gen)

    with tempfile.TemporaryDirectory() as workdir:  # phase 5's checkpoint and files, for 10-11
        print("== phase 5: main path through storm_tpu_torch.enhancement", flush=True)
        launches, f32_rtf, lengths, f32_outputs = phase_main_path(workdir)

        if args.profile:
            print("== phase 6: where the device time goes", flush=True)
            phase_profile()

        print("== phase 7: upfirdn2d forward and backward kernels against plain at a train "
              "step's shapes", flush=True)
        bwd_shape, bwd_err, train_fwd_err = phase_backward_vs_plain(gen)

        print("== phase 8: training through storm_tpu_torch.train", flush=True)
        phase_train_gradients(gen)
        with tempfile.TemporaryDirectory() as train_dir:
            train_launches = phase_train(train_dir)

        if args.profile:
            print("== phase 9: where a train step's device time goes", flush=True)
            phase_profile_train()

        print("== phase 10: int8 quantizer kernel against plain at the int8 path's inputs",
              flush=True)
        k3_shape, k3_calls, probe, k3_err = phase_quantizer_vs_plain(workdir, gen)

        print("== phase 11: int8 main path through storm_tpu_torch.enhancement --quant int8",
              flush=True)
        k3_launches = phase_int8_path(workdir, f32_rtf, lengths)

        print("== phase 12: fused_leaky_relu kernel through its op API against plain",
              flush=True)
        k2 = phase_fused_act(gen)

        if args.profile:
            print("== phase 13: where an int8 enhancement's device time goes", flush=True)
            phase_profile_int8(workdir)

        print(f"== phase 14: batched CLI (--batch {CLI_BATCH})", flush=True)
        batch_launches, batch_err, batch_dir, batch_outputs = phase_batched_cli(workdir, gen)

        print("== phase 15: HTTP server with dynamic batching (storm_tpu_torch.serve)",
              flush=True)
        serve_launches, serve_k3, serve_err, serve_k3_err = phase_server(workdir, batch_dir, gen)

        print(f"== phase 16: streaming (--stream_chunk_s {STREAM_CHUNK_S})", flush=True)
        stream_launches, stream_k3, stream_err, stream_k3_err = phase_streaming(workdir, gen)

        if args.profile:
            print(f"== phase 17: where a B={CLI_BATCH} enhancement's device time goes", flush=True)
            phase_profile_batch()

        print("== phase 18: bfloat16 kernels against plain: upfirdn2d at the main path's "
              "shapes and the adjoint at a train step's, GroupNorm, one NCSN++ forward",
              flush=True)
        bf16_shape, bf16_err = phase_bf16_kernels(gen)

        print("== phase 19: bfloat16 CLI (--dtype bfloat16; --batch 4; --quant int8)",
              flush=True)
        bf16_k1, bf16_k3, bf16_k3_shapes, bf16_cli_err = phase_bf16_cli(
            workdir, f32_outputs, f32_rtf, lengths, batch_dir, batch_outputs, gen)

        print("== phase 20: the quantizer's bfloat16-product mode against plain at the int8 "
              "bf16 path's inputs", flush=True)
        k3b_shape, k3b_calls, k3b_err = phase_bf16_quantizer(workdir)
        k3b_err = max(k3b_err, check_k3_at("the int8 bf16 CLI", bf16_k3_shapes, gen))

        print("== phase 21: HTTP server at its default dtype (bfloat16), then int8 + bf16",
              flush=True)
        bf16_serve_k1, bf16_serve_k3, bf16_serve_err, bf16_serve_k3_err = phase_bf16_server(
            workdir, gen)

        print("== phase 22: streaming in bfloat16", flush=True)
        bf16_stream_k1, bf16_stream_err = phase_bf16_streaming(workdir, gen)

        if args.profile:
            print("== phase 23: where a bfloat16 enhancement's device time goes", flush=True)
            phase_profile_bf16()

    def entry(name, source, replaces, per_shape_ms, calls, err, launches, work, **extra):
        keys = ("ms", "device_ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")
        total = {k: sum(per_shape_ms[c][k] for c in calls) if k in per_shape_ms[calls[0]]
                 else None for k in keys}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": total["ms"], "device_ms": total["device_ms"], "plain_ms": total["plain_ms"],
                "bound_ms": max(total["bytes_ms"], total["ops_ms"]),
                "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations",
                "library_ms": total["library_ms"], "work": work, **extra}

    k1_by_path = {"enhancement": launches, "train": train_launches[0],
                  "batched_cli": batch_launches, **serve_launches, **stream_launches}
    k3_by_path = {"enhancement_int8": k3_launches, "server_int8": serve_k3,
                  "streaming_int8": stream_k3}
    k1_bf16_by_path = {**bf16_k1, **bf16_serve_k1, "streaming_bf16": bf16_stream_k1}
    k3_bf16_by_path = {"enhancement_int8_bf16": bf16_k3, "server_int8_bf16": bf16_serve_k3}
    k1_src = "storm_tpu_torch/csrc/upfirdn2d.cu"
    no_library = "no single PyTorch call computes this function"
    record = {"kernels": [
        entry("upfirdn2d", k1_src, "storm_tpu/kernels/upfirdn.py:139", per_shape, k1_calls(6),
              max(max_err, train_fwd_err, batch_err, serve_err, stream_err),
              sum(k1_by_path.values()),
              f"the 18 calls of one full-width score-net forward, B=1, 256 x {FRAMES}",
              launches_by_path=k1_by_path),
        entry("upfirdn2d_bwd", k1_src, "storm_tpu/kernels/upfirdn.py:172-181", bwd_shape,
              k1_bwd_calls(), bwd_err, train_launches[1],
              f"the {STEP_BWD} backward calls of one full-width joint-training step, "
              f"B={TRAIN_B}, 256 x {TRAIN_FRAMES}"),
        entry("quantize_int8", "storm_tpu_torch/csrc/quantize_int8.cu",
              "scripts/perf_fusion_probe.py:88", k3_shape, k3_calls,
              max(k3_err, serve_k3_err, stream_k3_err),
              sum(k3_by_path.values()),
              f"the {N_QUANT} quantized-conv inputs of one full-width score-net forward, "
              f"B=1, 256 x {FRAMES}, float32", library=no_library, launches_by_path=k3_by_path,
              probe={k: probe[k] for k in ("shape", "dtype", "s", "ms", "plain_ms", "bound_ms")}),
        {"name": "fused_leaky_relu", "route": "cuda", "source": "storm_tpu_torch/csrc/fused_act.cu",
         "replaces": "storm_tpu/kernels/fused_act.py:61", "launches": k2["launches"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "device_ms": k2["device_ms"],
         "plain_ms": k2["plain_ms"],
         "bound_ms": max(k2["bytes_ms"], k2["ops_ms"]),
         "bound_by": "bytes" if k2["bytes_ms"] >= k2["ops_ms"] else "operations",
         "library_ms": None, "work": f"forward at {K2_SHAPES[0]} float32, no mask",
         "library": no_library},
        entry("upfirdn2d_bf16", k1_src, "storm_tpu/kernels/upfirdn.py:139", bf16_shape,
              k1_calls(6), max(bf16_err, bf16_cli_err, bf16_serve_err, bf16_stream_err),
              sum(k1_bf16_by_path.values()),
              f"the 18 calls of one full-width score-net forward, B=1, 256 x {FRAMES}, "
              f"bfloat16 in and out", launches_by_path=k1_bf16_by_path,
              bf16_elements_that_differ={k: {f: n[1] for f, n in v.items()}
                                         for k, v in BF16_FLIPS.items()},
              bf16_elements_compared={k: {f: n[0] for f, n in v.items()}
                                      for k, v in BF16_FLIPS.items()}),
        entry("quantize_int8_bf16_product", "storm_tpu_torch/csrc/quantize_int8.cu",
              "scripts/perf_fusion_probe.py:88", k3b_shape, k3b_calls,
              max(k3b_err, bf16_serve_k3_err), sum(k3_bf16_by_path.values()),
              f"the {N_QUANT} quantized-conv inputs of one full-width score-net forward, "
              f"B=1, 256 x {FRAMES}, bfloat16, the product in bfloat16", library=no_library,
              launches_by_path=k3_bf16_by_path),
    ]}
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
