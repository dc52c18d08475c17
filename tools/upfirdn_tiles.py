"""Host enqueue cost and tile heights of the upfirdn2d kernel (K1), on one CUDA card.

    python3 tools/upfirdn_tiles.py [--repo DIR] [--host-only]

1. host: microseconds of host time per call over 1000 calls at a small shape,
   (1, 6, 32, 64), with no sync inside the loop (median of 5 such loops):
   `upfirdn2d_cuda` in both configurations, and `downsample_2d` /
   `upsample_2d` under inference mode, as the model calls them (autograd
   Function and FIR set-up included). The package is imported from DIR
   (default: this checkout), so a parent checkout is measured by the same
   script on the same card.
2. tiles (unless --host-only): copies of csrc/upfirdn2d.cu with both tile
   heights (`kDownRows`, output rows per thread of the down configuration,
   and `kUpQuadRows`, quad rows per thread of the up configuration) set to
   1, 2 and 4, compiled with the package's nvcc flags into a temporary
   directory and called through their C entry; each is held to the plain
   version and timed (CUDA events, 20 back-to-back calls, median of 5) at
   the largest calls of a full-width score forward (B=1) and of a train
   step's backward (B=8), beside the bytes bound.

Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# (configuration, B, C, H, W) of the largest calls: the score forward's
# down and up resblock calls, and the step's backward of each (the other
# configuration at B=8 with the adjoint's pad)
SHAPES = [("down", 1, 128, 256, 512), ("up", 1, 256, 128, 256),
          ("down", 8, 256, 256, 256), ("up", 8, 128, 128, 128)]
PADS = {"down": (1, 2, (1, 1)), "up": (2, 1, (2, 1))}
HEIGHTS = (1, 2, 4)  # rows per thread (down) = quad rows per thread (up)


def host_us(fn, calls: int = 1000, loops: int = 5) -> float:
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def event_ms(fn, reps: int = 20, repeats: int = 5) -> float:
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


def build_variant(build, rows: int, workdir: str):
    """The C entry of csrc/upfirdn2d.cu compiled with both tile heights set to `rows`."""
    src = (build.CSRC / "upfirdn2d.cu").read_text()
    for name in ("kDownRows", "kUpQuadRows"):
        line = f"constexpr int {name} = 2;"
        if line not in src:
            sys.exit(f"FAIL: {line!r} is not in csrc/upfirdn2d.cu")
        src = src.replace(line, f"constexpr int {name} = {rows};")
    cu, so = (os.path.join(workdir, f"upfirdn2d_{rows}.{ext}") for ext in ("cu", "so"))
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"FAIL: nvcc on the variant with {rows} rows:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    if hasattr(lib, "storm_upfirdn2d"):  # float32 (dtype 0) or bfloat16
        entry = lib.storm_upfirdn2d
        entry.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                          + [ctypes.c_int] * 8 + [ctypes.c_void_p])

        def fn(*args):
            return entry(*args[:-1], 0, args[-1])
    else:  # an older checkout: float32 only, no dtype argument
        fn = entry = lib.storm_upfirdn2d_f32
        entry.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                          + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    entry.restype = ctypes.c_int
    return fn, proc.stdout + proc.stderr


def phase_tiles(kup, build, resample):
    fir = resample.setup_kernel((1, 3, 3, 1))
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(HEIGHTS)) as pool:  # one nvcc each, side by side
            variants = list(pool.map(lambda n: build_variant(build, n, workdir), HEIGHTS))
        print(f"  built {len(HEIGHTS)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
        for rows, (_, log) in zip(HEIGHTS, variants):
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  [{rows}] {line.strip()}")
        gen = torch.Generator(device="cuda").manual_seed(0)
        inputs = {s: torch.randn(s[1:], device="cuda", generator=gen) for s in SHAPES}
        for rows, (fn, _) in zip(HEIGHTS, variants):
            for s, x in inputs.items():
                up, down, pad = PADS[s[0]]
                k = fir * (4.0 if up == 2 else 1.0)
                want = kup.upfirdn2d_plain(x, k, up=up, down=down, pad=pad)
                got = torch.empty_like(want)
                B, C, H, W = x.shape

                def launch():
                    err = fn(x.data_ptr(), got.data_ptr(), k.ctypes.data, 0, x.get_device(),
                             B * C, H, W, *got.shape[-2:], up, down, pad[0],
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        sys.exit(f"FAIL: variant {rows} launch error {err}")

                launch()
                err = (got - want).abs().max().item()
                if not torch.allclose(got, want, atol=1e-5, rtol=1e-5):
                    sys.exit(f"FAIL: variant {rows} disagrees with plain at {s} (max {err:.3e})")
                ms = event_ms(launch)
                bound = 4.0 * (x.numel() + got.numel()) / PEAK_BYTES_PER_S * 1e3
                print(f"  rows/thread {rows} {s[0]:4s} B={s[1]} C={s[2]} {s[3]}x{s[4]}: "
                      f"ms={ms:.5f} bound_ms={bound:.5f} ratio={ms / bound:.2f} "
                      f"err={err:.2e}", flush=True)


def phase_host(kup, resample):
    fir = resample.setup_kernel((1, 3, 3, 1))
    fir4 = fir * 4.0
    x = torch.randn(1, 6, 32, 64, device="cuda")
    rows = {
        "upfirdn2d_cuda down": lambda: kup.upfirdn2d_cuda(x, fir, up=1, down=2, pad=(1, 1)),
        "upfirdn2d_cuda up": lambda: kup.upfirdn2d_cuda(x, fir4, up=2, down=1, pad=(2, 1)),
        "downsample_2d": lambda: resample.downsample_2d(x, (1, 3, 3, 1)),
        "upsample_2d": lambda: resample.upsample_2d(x, (1, 3, 3, 1)),
    }
    with torch.inference_mode():
        for name, fn in rows.items():
            print(f"  host us per call, {name} (1, 6, 32, 64): {host_us(fn):.3f}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        help="checkout whose storm_tpu_torch is measured")
    parser.add_argument("--host-only", action="store_true", help="skip the tile comparison")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("FAIL: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.repo))
    from storm_tpu_torch.kernels import build
    from storm_tpu_torch.kernels import upfirdn as kup
    from storm_tpu_torch.nn import resample

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"== host enqueue cost, package from {kup.__file__}", flush=True)
    phase_host(kup, resample)
    if not args.host_only:
        print("== tile heights", flush=True)
        phase_tiles(kup, build, resample)


if __name__ == "__main__":
    main()
