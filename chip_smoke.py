"""Smoke run of the PyTorch port (storm_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--profile]

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off.
2. build: every CUDA source of the port with nvcc (sm_90a), timed.
3. kernel against plain: upfirdn2d at every shape the full-width main path
   gives it (4 s request: 256 bins x 512 frames, B=1), with the NCSN++ FIR and
   with an asymmetric one, held to atol = rtol = 1e-5 against the plain
   PyTorch version; kernel, plain and library-call times (CUDA events) beside
   the memory bound. The same check, untimed, at the widths of the shorter
   files (128 and 320 frames).
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
   asymmetric FIRs, atol = rtol = 1e-5; backward kernel, plain backward and
   library-call times beside the memory bound.
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

A profile's kernel times come from its device events, each counted once;
shares are of the summed kernel time. The busy time is the union of the
kernels' intervals, which kernels running side by side on several streams
(cuDNN's FFT convolutions in a train step) do not count twice.

The line before the last holds the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from storm_tpu_torch import enhancement, train
from storm_tpu_torch.backbones.ncsnpp import NCSNpp, count_parameters
from storm_tpu_torch.ckpt import load_training_checkpoint, save_checkpoint
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.kernels import build
from storm_tpu_torch.kernels import upfirdn as kup
from storm_tpu_torch.models.base import init_train_state
from storm_tpu_torch.models.factory import build_model, resolve_device
from storm_tpu_torch.models.storm import StochasticRegenerationModel
from storm_tpu_torch.nn import resample
from storm_tpu_torch.nn.init import reset_parameters
from storm_tpu_torch.signal.transforms import pad_spec_amount

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12

NF, CH_MULT = 128, (1, 2, 2, 2)
FREQS, FRAMES = 256, 512  # a 4 s request: 501 STFT frames padded to 512
FIR = resample.setup_kernel((1, 3, 3, 1))
CONFIGS = {"down": dict(up=1, down=2, pad=(1, 1), kernel=FIR),
           "up": dict(up=2, down=1, pad=(2, 1), kernel=FIR * 4.0)}
# full-width StoRM; init_scale 1 so that no branch of the random net starts at ~0
STORM_CONFIG = {"mode": "regen-joint-training", "init_scale": 1.0}
N_STEPS, NFE = 50, 1 + 50 * 2  # CLI defaults: 1 denoiser + N x (ald + predictor)
SECONDS = (1.0, 2.5, 4.0)
SR = 16000


def padded_frames(seconds: float) -> int:
    """NCSN++ input width of a file: centred STFT frames, padded to 64."""
    n = 1 + int(seconds * SR) // 128
    return n + pad_spec_amount(n)


# the other widths the enhancement path gives upfirdn2d (the trained
# checkpoint's 1 s file included)
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


def library_call(cfg: str, C: int, backward: bool = False):
    """One PyTorch call computing the same function (yardstick only); with
    `backward`, the adjoint of the forward call of `cfg`, which is the other
    call with the same weight."""
    k = torch.as_tensor(CONFIGS[cfg]["kernel"], device="cuda")
    if cfg == "down":  # correlation with the flipped FIR on the 1-padded input
        w = k.flip(0, 1).expand(C, 1, 4, 4).contiguous()
        if backward:
            return lambda g: F.conv_transpose2d(g, w, stride=2, padding=1, groups=C)
        return lambda x: F.conv2d(x, w, stride=2, padding=1, groups=C)
    w = k.expand(C, 1, 4, 4).contiguous()  # transposed conv with the FIR as is
    if backward:
        return lambda g: F.conv2d(g, w, stride=2, padding=1, groups=C)
    return lambda x: F.conv_transpose2d(x, w, stride=2, padding=1, groups=C)


def bound_ms(n_in: int, n_out: int, taps: int):
    """(bytes bound, operations bound) in ms: float32 in and out once over the
    memory rate; `taps` multiply-adds per output over the f32 peak."""
    return (4.0 * (n_in + n_out) / PEAK_BYTES_PER_S * 1e3,
            2.0 * taps * n_out / PEAK_F32_FLOP_PER_S * 1e3)


ASYM = torch.randn(4, 4, generator=torch.Generator().manual_seed(1)).numpy()


def forward_shapes(frames: int):
    return sorted(set(k1_calls(6, frames) + k1_calls(2, frames)),
                  key=lambda s: (s[0], -s[1], -s[2]))


def compare(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want|; fails unless they agree to atol = rtol = 1e-5."""
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    err = (got - want).abs().max().item()
    check(torch.allclose(got, want, atol=1e-5, rtol=1e-5),
          f"{what}: kernel disagrees with plain (max {err:.3e})")
    return err


def check_forward(cfg: str, x: torch.Tensor) -> float:
    """upfirdn2d_cuda against the plain version on x, both FIRs."""
    c = CONFIGS[cfg]
    args = dict(up=c["up"], down=c["down"], pad=c["pad"])
    return max(compare(f"upfirdn2d {cfg} {tuple(x.shape)}", kup.upfirdn2d_cuda(x, kern, **args),
                       kup.upfirdn2d_plain(x, kern, **args))
               for kern in (c["kernel"], ASYM))


def phase_kernel_vs_plain(gen: torch.Generator):
    per_shape, max_err = {}, 0.0
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
                                         bytes_ms=bound_bytes_ms, ops_ms=bound_ops_ms)
        by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
        print(f"  upfirdn2d {cfg:4s} C={C:3d} {H:3d}x{W:3d} -> {Ho}x{Wo}: "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
              f"bound_ms={max(bound_bytes_ms, bound_ops_ms):.5f} ({by}) "
              f"lib_err={lib_err:.2e}", flush=True)
    return per_shape, max_err


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


def phase_main_path(workdir: str):
    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    ckpt = os.path.join(workdir, "storm.pt")
    save_checkpoint(ckpt, STORM_CONFIG, model.state_dict())
    noisy, out = os.path.join(workdir, "noisy"), os.path.join(workdir, "enhanced")
    lengths = write_wavs(noisy)

    kup.upfirdn2d_cuda.launches = 0
    t0 = time.perf_counter()
    enhancement.main(["--test_dir", noisy, "--enhanced_dir", out, "--ckpt", ckpt,
                      "--mode", "storm", "--timeit", "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kup.upfirdn2d_cuda.launches

    for name, n in lengths.items():
        x, sr = load_wav(os.path.join(out, name))
        check(sr == SR and x.shape == (1, n), f"{name}: output shape {x.shape}, expected (1, {n})")
        check(bool(np.isfinite(x).all()), f"{name}: output not finite")
    expected = 18 * NFE * len(SECONDS)
    print(f"  enhanced {len(SECONDS)} files ({sum(SECONDS)} s of audio) in {wall:.2f} s wall; "
          f"upfirdn2d launches {launches} (expected 18 x {NFE} x {len(SECONDS)} = {expected})",
          flush=True)
    check(launches == expected, f"upfirdn2d launched {launches} times, expected {expected}")

    # the whole path once more on the shortest file, kernel against plain, same noise
    y = torch.from_numpy(load_wav(os.path.join(noisy, next(iter(lengths))))[0]).cuda()
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
    return launches


def phase_backward_vs_plain(gen: torch.Generator):
    """upfirdn2d at each forward shape of a train step, through the autograd
    Function the model calls: its output, and where the step takes one its
    gradient, against the plain version. Returns (per-shape backward times,
    backward max error, forward max error)."""
    bwd_calls = set(k1_bwd_calls())
    per_shape, max_err, fwd_err = {}, 0.0, 0.0
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
                                         bytes_ms=bytes_ms, ops_ms=ops_ms)
        print(f"  upfirdn2d_bwd of {cfg:4s} B={TRAIN_B} C={C:3d} {Ho:3d}x{Wo:3d} -> {H}x{W}: "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
              f"bound_ms={max(bytes_ms, ops_ms):.5f} "
              f"({'bytes' if bytes_ms >= ops_ms else 'operations'}) lib_err={lib_err:.2e}",
              flush=True)
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


def print_profile(what: str, prof, wall_ms: float):
    """Device time by kernel from the trace's device events. The spans of
    record_function ranges on the device's timeline (user annotations, such
    as the optimizer's step) cover kernels and are left out; an event listed
    twice (same name, stream and interval) counts once. The busy time is the
    union of the intervals; each kernel's share is of the summed kernel
    time. Also printed: the sum of key_averages' device time over every
    device row (annotations included) and the kernels that overlap, if any."""
    from torch.autograd import DeviceType

    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = [e for e in device if getattr(e, "is_user_annotation", False)]
    events = [e for e in device if not getattr(e, "is_user_annotation", False)]
    unique = sorted({(e.time_range.start, e.time_range.end, e.name,
                      getattr(e, "device_resource_id", e.thread)) for e in events})
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
    print(f"  {what} under the profiler: wall {wall_ms:.1f} ms; {len(events)} device events, "
          f"{len(unique)} distinct, {len({u[3] for u in unique})} stream ids; kernel time summed "
          f"{summed_ms:.1f} ms, device busy (union) {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of wall); key_averages' device time summed "
          f"{averages_ms:.1f} ms; annotation spans {sum(span_ms.values()):.1f} ms "
          f"{ {k[:40]: round(v, 2) for k, v in sorted(span_ms.items(), key=lambda kv: -kv[1])[:4]} }",
          flush=True)
    for (a, b), ms in sorted(overlaps.items(), key=lambda o: -o[1])[:5]:
        print(f"    overlap {ms:8.2f} ms: {a} | {b}")
    for key, ms, count in rows[:15]:
        print(f"    {100 * ms / summed_ms:5.1f}%  {ms:9.2f} ms  x{count:6d}  {key[:90]}")
    for name in ("upfirdn2d_k4<1, 2>", "upfirdn2d_k4<2, 1>"):
        sel = [r for r in rows if name in r[0]]
        print(f"  {name}: {sum(r[1] for r in sel):.2f} ms in {sum(r[2] for r in sel)} launches "
              f"({100 * sum(r[1] for r in sel) / summed_ms:.2f}% of kernel time)", flush=True)


def phase_profile_train():
    """Trace two full-width train steps (B=8, 256 x 256)."""
    from torch.profiler import ProfilerActivity, profile

    model = build_model({"mode": "regen-joint-training"}, device="cuda", seed=0).train()
    state = init_train_state(model, model.lr)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = 0.3 * torch.randn(TRAIN_B, FREQS, TRAIN_FRAMES, 2, device="cuda", generator=gen)
    batch = (x, x + 0.2 * torch.randn(x.shape, device="cuda", generator=gen))
    model.train_step(state, batch, gen)  # warm-up at the same shapes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            model.train_step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_profile(f"two train steps (B={TRAIN_B}, {FREQS} x {TRAIN_FRAMES})", prof, wall_ms)


def phase_profile():
    """Trace one enhancement of the longest file (CLI defaults) and print where
    the device time goes."""
    from torch.profiler import ProfilerActivity, profile

    model = build_model(STORM_CONFIG, device="cuda", seed=0)
    y = torch.from_numpy(synth_wav(max(SECONDS), 0, np.random.default_rng(0))[None]).cuda()
    model.enhance(y, N=2, corrector="ald")  # warm-up at the same shapes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.enhance(y, N=N_STEPS, corrector="ald")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print_profile(f"enhance {max(SECONDS)} s file", prof, wall_ms)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace one enhancement and two train steps and print "
                             "the device time by kernel")
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
    kup._lib()
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

    print("== phase 5: main path through storm_tpu_torch.enhancement", flush=True)
    with tempfile.TemporaryDirectory() as workdir:
        launches = phase_main_path(workdir)

    if args.profile:
        print("== phase 6: where the device time goes", flush=True)
        phase_profile()

    print("== phase 7: upfirdn2d forward and backward kernels against plain at a train "
          "step's shapes",
          flush=True)
    bwd_shape, bwd_err, train_fwd_err = phase_backward_vs_plain(gen)

    print("== phase 8: training through storm_tpu_torch.train", flush=True)
    phase_train_gradients(gen)
    with tempfile.TemporaryDirectory() as workdir:
        train_launches = phase_train(workdir)

    if args.profile:
        print("== phase 9: where a train step's device time goes", flush=True)
        phase_profile_train()

    def entry(name, replaces, per_shape_ms, calls, err, launches, work, **extra):
        total = {k: sum(per_shape_ms[c][k] for c in calls)
                 for k in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
        return {"name": name, "route": "cuda", "source": "storm_tpu_torch/csrc/upfirdn2d.cu",
                "replaces": replaces, "launches": launches, "max_abs_err": err,
                "ms": total["ms"], "plain_ms": total["plain_ms"],
                "bound_ms": max(total["bytes_ms"], total["ops_ms"]),
                "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations",
                "library_ms": total["library_ms"], "work": work, **extra}

    record = {"kernels": [
        entry("upfirdn2d", "storm_tpu/kernels/upfirdn.py:139", per_shape, k1_calls(6),
              max(max_err, train_fwd_err),
              launches + train_launches[0],
              "the 18 calls of one full-width score-net forward, B=1, 256 x 512",
              launches_by_path={"enhancement": launches, "train": train_launches[0]}),
        entry("upfirdn2d_bwd", "storm_tpu/kernels/upfirdn.py:172-181", bwd_shape, k1_bwd_calls(),
              bwd_err, train_launches[1],
              f"the {STEP_BWD} backward calls of one full-width joint-training step, "
              f"B={TRAIN_B}, 256 x {TRAIN_FRAMES}"),
    ]}
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
