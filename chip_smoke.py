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
   the memory bound.
4. full-width NCSN++: one 27.8M score-net forward through the kernel and
   through the plain version, same weights, held to 1e-4 of the output scale.
5. main path: the full-width StoRM model (2 x 27.8M, seeded random weights)
   saved as a checkpoint and run through `python -m storm_tpu_torch.enhancement`
   (CLI defaults: pc, reverse_diffusion, ald, N=50) on three synthesized 16 kHz
   files of 1, 2.5 and 4 s; outputs must be finite and as long as the inputs,
   and upfirdn2d must have launched 18 times per NCSN++ forward.

With `--profile`, a last phase traces one enhancement of the 4 s file with
torch.profiler and prints the device time by kernel and the device's busy
share of the wall time.

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

from storm_tpu_torch import enhancement
from storm_tpu_torch.backbones.ncsnpp import NCSNpp, count_parameters
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.kernels import build
from storm_tpu_torch.kernels import upfirdn as kup
from storm_tpu_torch.models.factory import build_model, resolve_device
from storm_tpu_torch.nn import resample
from storm_tpu_torch.nn.init import reset_parameters

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


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def k1_calls(pyramid_ch: int):
    """(config, C, H, W) of the 18 upfirdn2d calls of one NCSN++ forward."""
    calls = []
    L = len(CH_MULT)
    for i in range(L - 1):  # down resblocks (h and x), then the input pyramid
        H, W = FREQS >> i, FRAMES >> i
        calls += [("down", NF * CH_MULT[i], H, W)] * 2 + [("down", pyramid_ch, H, W)]
    for i in range(L - 1, 0, -1):  # output pyramid, then up resblocks (h and x)
        H, W = FREQS >> i, FRAMES >> i
        calls += [("up", pyramid_ch, H, W)] + [("up", NF * CH_MULT[i], H, W)] * 2
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


def library_call(cfg: str, C: int):
    """One PyTorch call computing the same function (yardstick only)."""
    k = torch.as_tensor(CONFIGS[cfg]["kernel"], device="cuda")
    if cfg == "down":  # correlation with the flipped FIR on the 1-padded input
        w = k.flip(0, 1).expand(C, 1, 4, 4).contiguous()
        return lambda x: F.conv2d(x, w, stride=2, padding=1, groups=C)
    w = k.expand(C, 1, 4, 4).contiguous()  # transposed conv with the FIR as is
    return lambda x: F.conv_transpose2d(x, w, stride=2, padding=1, groups=C)


def phase_kernel_vs_plain(gen: torch.Generator):
    asym = torch.randn(4, 4, generator=torch.Generator().manual_seed(1)).numpy()
    shapes = sorted(set(k1_calls(6) + k1_calls(2)), key=lambda s: (s[0], -s[1], -s[2]))
    per_shape, max_err = {}, 0.0
    for cfg, C, H, W in shapes:
        c = CONFIGS[cfg]
        x = torch.randn(1, C, H, W, device="cuda", generator=gen)
        for kern in (c["kernel"], asym):
            got = kup.upfirdn2d_cuda(x, kern, up=c["up"], down=c["down"], pad=c["pad"])
            want = kup.upfirdn2d_plain(x, kern, up=c["up"], down=c["down"], pad=c["pad"])
            torch.cuda.synchronize()
            check(got.shape == want.shape, f"upfirdn2d {cfg} C={C} {H}x{W}: shape")
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            check(torch.allclose(got, want, atol=1e-5, rtol=1e-5),
                  f"upfirdn2d {cfg} C={C} {H}x{W}: kernel disagrees with plain (max {err:.3e})")
        lib = library_call(cfg, C)
        want = kup.upfirdn2d_plain(x, c["kernel"], up=c["up"], down=c["down"], pad=c["pad"])
        lib_err = (lib(x) - want).abs().max().item()
        check(lib_err <= 1e-5 + 1e-5 * want.abs().max().item(),
              f"library yardstick {cfg} C={C}: not the same function (max {lib_err:.3e})")
        args = dict(up=c["up"], down=c["down"], pad=c["pad"])
        ms = time_ms(lambda: kup.upfirdn2d_cuda(x, c["kernel"], **args))
        plain_ms = time_ms(lambda: kup.upfirdn2d_plain(x, c["kernel"], **args), reps=5)
        library_ms = time_ms(lambda: lib(x))
        Ho, Wo = want.shape[-2:]
        n_in, n_out = C * H * W, C * Ho * Wo
        taps = 16 // (c["up"] ** 2)
        bound_bytes_ms = 4.0 * (n_in + n_out) / PEAK_BYTES_PER_S * 1e3
        bound_ops_ms = 2.0 * taps * n_out / PEAK_F32_FLOP_PER_S * 1e3
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


def phase_profile():
    """Trace one enhancement of the longest file (CLI defaults) and print where
    the device time goes."""
    from torch.autograd import DeviceType
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
    # kernel rows only: an operator's row repeats the time of the kernels it launched
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    check(device_ms > 0, "the profiler saw no device time")
    print(f"  enhance {max(SECONDS)} s file under the profiler: wall {wall_ms:.1f} ms, "
          f"device busy {device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}%)", flush=True)
    for key, ms, count in rows[:15]:
        print(f"    {100 * ms / device_ms:5.1f}%  {ms:9.2f} ms  x{count:6d}  {key[:90]}")
    ufd = [r for r in rows if "upfirdn2d" in r[0]]
    print(f"  upfirdn2d: {sum(r[1] for r in ufd):.2f} ms in {sum(r[2] for r in ufd)} launches "
          f"({100 * sum(r[1] for r in ufd) / device_ms:.2f}% of device time)", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace one enhancement and print the device time by kernel")
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

    # one score-net forward's worth of upfirdn2d work (its 18 calls)
    calls = k1_calls(6)
    total = {k: sum(per_shape[c][k] for c in calls)
             for k in ("ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")}
    record = {"kernels": [{
        "name": "upfirdn2d",
        "route": "cuda",
        "source": "storm_tpu_torch/csrc/upfirdn2d.cu",
        "replaces": "storm_tpu/kernels/upfirdn.py:139",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": total["ms"],
        "plain_ms": total["plain_ms"],
        "bound_ms": max(total["bytes_ms"], total["ops_ms"]),
        "bound_by": "bytes" if total["bytes_ms"] >= total["ops_ms"] else "operations",
        "library_ms": total["library_ms"],
        "work": "the 18 calls of one full-width score-net forward, B=1, 256 x 512",
    }]}
    print(f"  total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
