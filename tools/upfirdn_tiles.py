"""Host cost, launch-plan knobs and old against new of the upfirdn2d kernel (K1), on a card.

    python3 tools/upfirdn_tiles.py [--repo DIR] [--host-only] [--against FILE] [--no-sweep]

1. host: microseconds of host time per call over 1000 calls at a small shape,
   (1, 6, 32, 64), with no sync inside the loop (median of 5 such loops):
   `upfirdn2d_cuda` in both configurations and both storage types, and
   `downsample_2d` / `upsample_2d` under inference mode, as the model calls
   them (autograd Function, FIR set-up, launch plan and tensor map included).
   The package is imported from DIR (default: this checkout).
2. against (with --against FILE): FILE, another `csrc/upfirdn2d.cu` (a parent's,
   unpacked with `git archive` into the git-ignored `_checkout/`), compiled
   with the package's nvcc flags into a temporary directory and launched
   with the launch plans of its own checkout's `kernels/upfirdn.py`, and this
   checkout's kernel, each held to the plain version (bfloat16 equal with
   NCSN++'s FIR) and timed in turns (old, new, new, old) in bfloat16 and
   float32 at the 18 calls of a full-width score forward (B=1, 256 x 576),
   the 33 adjoint calls of a joint-training step (B=8, 256 x 256), the 12
   stride-1 calls of a full-width DDPM + residual NCSN++ forward (B=1, 256 x
   576) and their 12 adjoints (B=8, 256 x 256): device ms per call from
   profiler kernel events, each call after a 256 MB read that clears the
   L2, summed per forward and per step beside the bytes bound. FILE's host
   cost per call comes from this script run with --repo on FILE's
   checkout, in a process of its own.
3. sweep (unless --no-sweep or --host-only): the launch plan's knobs (ring
   stages, the widest column tile, a box's byte budget; `tile_plan`'s
   defaults first) at the 18 forward calls and the 33 adjoint calls in
   bfloat16, per forward and per step, with each call's device us; then at
   the stride-1 calls and adjoints in both types, with row copies also
   where TMA could load the box.

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
from pathlib import Path

import torch

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
L2_FLUSH_BYTES = 256 << 20  # 5x the H100's 50 MB L2
GAP_S = 0.1  # host pause between two functions' runs in a trace (half of it splits runs)
REPS = 20
NF, CH_MULT, FREQS = 128, (1, 2, 2, 2), 256
PADS = {"down": (1, 2, (1, 1)), "up": (2, 1, (2, 1))}
# (stages, widest column tile, box bytes) swept after the defaults
KNOBS = [(2, 144, 24 << 10), (3, 144, 24 << 10), (6, 144, 16 << 10), (4, 288, 24 << 10),
         (4, 96, 24 << 10), (4, 144, 12 << 10)]
# the same at stride 1 (None: the instance's default width); then the defaults with row
# copies for every box (each input planned as if off 16 bytes)
S1_KNOBS = [(4, 128, 24 << 10), (4, 96, 24 << 10), (4, None, 16 << 10), (3, None, 32 << 10),
            (6, None, 16 << 10)]


def forward_calls(pyramid_ch: int, frames: int):
    """(config, C, H, W) of the 18 upfirdn2d calls of one NCSN++ forward."""
    calls, L = [], len(CH_MULT)
    for i in range(L - 1):  # down resblocks (h and x), then the input pyramid
        H, W = FREQS >> i, frames >> i
        calls += [("down", NF * CH_MULT[i], H, W)] * 2 + [("down", pyramid_ch, H, W)]
    for i in range(L - 1, 0, -1):  # output pyramid, then up resblocks (h and x)
        H, W = FREQS >> i, frames >> i
        calls += [("up", pyramid_ch, H, W)] + [("up", NF * CH_MULT[i], H, W)] * 2
    return calls


def step_adjoint_calls(frames: int = 256):
    """(forward config, C, H, W) of the 33 backward calls of one joint step:
    every call of the score net, every call of the denoiser but its input
    pyramid's."""
    return ([c for c in forward_calls(2, frames) if c[:2] != ("down", 2)]
            + forward_calls(6, frames))


def stride1_calls(frames: int, pyramid_ch: int = 6):
    """(pad0, C, H, W) of the 12 stride-1 calls of one DDPM + residual NCSN++
    forward: per down level the trunk's and the input pyramid's
    conv_downsample_2d (pad 2 on the level's size), per up level the output
    pyramid's and the trunk's upsample_conv_2d (pad 1 on the transposed
    conv's 2n + 1). A backward's adjoints are the same calls' (all of them:
    the input pyramid's first call has a gradient when the input has one)."""
    chans, L, calls = [NF * m for m in CH_MULT], len(CH_MULT), []
    for i in range(L - 1):
        H, W = FREQS >> i, frames >> i
        calls += [(2, chans[i], H, W), (2, pyramid_ch if i == 0 else chans[i - 1], H, W)]
    for i in range(L - 1, -1, -1):
        if i < L - 1:
            calls.append((1, chans[i], 2 * (FREQS >> (i + 1)) + 1, 2 * (frames >> (i + 1)) + 1))
        if i > 0:
            calls.append((1, chans[i], 2 * (FREQS >> i) + 1, 2 * (frames >> i) + 1))
    return calls


def parent_upfirdn(root: Path):
    """`storm_tpu_torch/kernels/upfirdn.py` of the checkout at root, imported
    as a module of its own (with its `build` beside it, not its package), so
    that its kernel source is launched with the plans it was written for."""
    import importlib.util
    import types

    name = "_against_kernels"
    pkg = types.ModuleType(name)
    pkg.__path__ = [str(root / "storm_tpu_torch" / "kernels")]
    sys.modules[name] = pkg
    spec = importlib.util.spec_from_file_location(f"{name}.upfirdn", pkg.__path__[0] + "/upfirdn.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


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


def device_ms(fns, reps: int = REPS):
    """Mean device time per call (ms) of each function in `fns`, each of which
    launches one upfirdn2d kernel: its events in a profiler trace of `reps`
    calls, each after an L2-clearing read; a pause after each function's
    calls splits the trace into runs (a first, dropped run starts the tracer)."""
    from torch.autograd import DeviceType
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
    events = sorted({(e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type == DeviceType.CUDA and "upfirdn2d_" in e.name})
    runs, last_end = [], -float("inf")
    for start, end in events:
        if start - last_end > GAP_S * 1e6 / 2:
            runs.append([])
        runs[-1].append(end - start)
        last_end = end
    runs = runs[-len(fns):]
    if len(runs) != len(fns) or any(len(r) < reps // 2 for r in runs):
        sys.exit(f"FAIL: upfirdn2d device events: runs of {[len(r) for r in runs]}, expected "
                 f"{len(fns)} runs of {reps}")
    return [statistics.mean(r) / 1e3 for r in runs]


def compile_source(build, src: Path, workdir: str, name: str):
    so = os.path.join(workdir, f"lib{name}.so")
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so, str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"FAIL: nvcc on {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(so), proc.stdout + proc.stderr


class Entry:
    """One build's C entry. A build with a launch plan (`storm_upfirdn2d_plan_len`)
    takes `tile_plan`'s array as its last argument, computed here with `knobs`."""

    def __init__(self, lib, kup, knobs=None):
        self.fn, self.kup, self.knobs = lib.storm_upfirdn2d, kup, knobs or {}
        self.planned = hasattr(lib, "storm_upfirdn2d_plan_len")
        args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_longlong]
        args += [ctypes.c_int] * 8 + [ctypes.c_void_p] * (2 if self.planned else 1)
        self.fn.argtypes, self.fn.restype = args, ctypes.c_int

    def plan(self, x, out, up, down, pad0):
        """The launch's plan; a knob `x_aligned` overrides the input's own alignment."""
        B, C, H, W = x.shape
        knobs = {"x_aligned": x.data_ptr() % 16 == 0, **self.knobs}
        return self.kup.tile_plan(up, down, pad0, H, W, *out.shape[-2:], B * C,
                                  x.element_size(), out_aligned=out.data_ptr() % 16 == 0,
                                  sms=self.kup._sms(x.get_device()), **knobs)

    def paths(self, kup, x, out, up, down, pad0):
        """(load, store) of the launch, named by `kup.paths` (a field that
        the plan's own checkout lacks taken as 0)."""
        if not self.planned:
            return "element copy", "elements"
        plan = self.plan(x, out, up, down, pad0)._asdict()
        return kup.paths(kup.TilePlan(**{f: plan.get(f, 0) for f in kup.TilePlan._fields}),
                         up, down)

    def call(self, x, out, taps, flip, up, down, pad0):
        B, C, H, W = x.shape
        Ho, Wo = out.shape[-2:]
        device = x.get_device()
        args = [x.data_ptr(), out.data_ptr(), taps.ctypes.data, flip, device, B * C, H, W, Ho,
                Wo, up, down, pad0, self.kup._DTYPES[x.dtype],
                torch.cuda.current_stream().cuda_stream]
        if self.planned:
            plan = self.plan(x, out, up, down, pad0)
            args.append((ctypes.c_int * len(plan))(*plan))
        err = self.fn(*args)
        if err:
            sys.exit(f"FAIL: upfirdn2d launch error {err} at {tuple(x.shape)} -> {Ho}x{Wo}")


def call_cases(kup, fir, dtype, gen, stride1: bool = True):
    """{"forward" / "step" / "s1 forward" / "s1 step": [(name, launch args, plain
    output)]}: the forward calls at 576 frames (B=1) and the adjoint calls of
    a step (B=8, 256 x 256); with `stride1`, the DDPM net's stride-1 calls at
    576 frames (B=1) and their adjoints at B=8, 256 x 256."""
    cases = {"forward": [], "step": []}
    for cfg, C, H, W in forward_calls(6, 576):
        up, down, pad = PADS[cfg]
        k = fir * (4.0 if up == 2 else 1.0)
        x = torch.randn(1, C, H, W, device="cuda", generator=gen).to(dtype)
        want = kup.upfirdn2d_plain(x, k, up=up, down=down, pad=pad)
        cases["forward"].append((f"{cfg} C={C} {H}x{W}", (x, k, 0, up, down, pad[0]), want))
    for cfg, C, H, W in step_adjoint_calls():
        up, down, pad = PADS[cfg]
        k = fir * (4.0 if up == 2 else 1.0)
        Ho, Wo = (kup.output_size(n, 4, up, down, pad) for n in (H, W))
        g = torch.randn(8, C, Ho, Wo, device="cuda", generator=gen).to(dtype)
        want = kup.upfirdn2d_bwd_plain(g, k, up, down, pad, (H, W))
        g_up, g_down, g_pad0 = kup._adjoint(up, down, pad)
        cases["step"].append((f"bwd of {cfg} C={C} {H}x{W}", (g, k, 1, g_up, g_down, g_pad0),
                              want))
    if not stride1:
        return cases
    cases["s1 forward"], cases["s1 step"] = [], []
    for what, B, frames in (("s1 forward", 1, 576), ("s1 step", 8, 256)):
        for pad0, C, H, W in stride1_calls(frames):
            k = fir * (4.0 if pad0 == 1 else 1.0)  # upsample_conv_2d's FIR carries the gain
            pad = (pad0, pad0)
            if what == "s1 forward":
                x = torch.randn(B, C, H, W, device="cuda", generator=gen).to(dtype)
                want = kup.upfirdn2d_plain(x, k, pad=pad)
                cases[what].append((f"same{pad0} C={C} {H}x{W}", (x, k, 0, 1, 1, pad0), want))
                continue
            Ho, Wo = (kup.output_size(n, 4, 1, 1, pad) for n in (H, W))
            g = torch.randn(B, C, Ho, Wo, device="cuda", generator=gen).to(dtype)
            want = kup.upfirdn2d_bwd_plain(g, k, 1, 1, pad, (H, W))
            cases[what].append((f"bwd of same{pad0} C={C} {H}x{W}", (g, k, 1, 1, 1, 3 - pad0),
                                want))
    return cases


def timed(entries, cases, kup):
    """Check each entry against plain at every case, then time them in the
    order given; returns {entry index: [ms per case]}."""
    fns, owners = [], []
    for idx, entry in enumerate(entries):
        for name, (x, k, flip, up, down, pad0), want in cases:
            out = torch.empty_like(want)
            entry.call(x, out, k, flip, up, down, pad0)
            torch.cuda.synchronize()
            if want.dtype == torch.bfloat16:
                if not torch.equal(out, want):
                    sys.exit(f"FAIL: entry {idx} differs from plain at {name} bf16")
            elif not torch.allclose(out, want, atol=1e-5, rtol=1e-5):
                sys.exit(f"FAIL: entry {idx} disagrees with plain at {name}")
            fns.append(lambda e=entry, a=(x, out, k, flip, up, down, pad0): e.call(*a))
            owners.append(idx)
    times = device_ms(fns)
    per = {}
    for idx, ms in zip(owners, times):
        per.setdefault(idx, []).append(ms)
    return per


def bound_ms(cases):
    return sum((x.numel() + want.numel()) * x.element_size() for _, (x, *_), want in cases) \
        / PEAK_BYTES_PER_S * 1e3


def phase_against(kup, build, resample, against: Path):
    with tempfile.TemporaryDirectory() as workdir:
        old_lib, _ = compile_source(build, against, workdir, "upfirdn2d_old")
        new_lib, log = compile_source(build, build.CSRC / "upfirdn2d.cu", workdir,
                                      "upfirdn2d_new")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [new] {line.strip()}")
        old_kup = parent_upfirdn(against.resolve().parent.parent.parent)
        old, new = Entry(old_lib, old_kup), Entry(new_lib, kup)
        fir = resample.setup_kernel((1, 3, 3, 1))
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype in (torch.bfloat16, torch.float32):
            cases = call_cases(kup, fir, dtype, gen)
            for what, cs in cases.items():
                per = timed([old, new, new, old], cs, kup)
                olds = [(a + b) / 2 for a, b in zip(per[0], per[3])]
                news = [(a + b) / 2 for a, b in zip(per[1], per[2])]
                for (name, (x, k, flip, up, down, pad0), want), o, n in zip(cs, olds, news):
                    b = (x.numel() + want.numel()) * x.element_size() / PEAK_BYTES_PER_S * 1e3
                    paths = [" / ".join(e.paths(kup, x, want, up, down, pad0))
                             for e in (old, new)]
                    print(f"  {str(dtype)[6:]:8s} {name:26s} old {o:.5f} new {n:.5f} ms "
                          f"bound {b:.5f} (old {o / b:.2f}x, new {n / b:.2f}x) paths old "
                          f"{paths[0]}, new {paths[1]}", flush=True)
                bound = bound_ms(cs)
                print(f"  {str(dtype)[6:]} per {what} ({len(cs)} calls): old "
                      f"{sum(per[0]):.4f} / {sum(per[3]):.4f} ms, new {sum(per[1]):.4f} / "
                      f"{sum(per[2]):.4f} ms (runs 1 / 2 of each), bound {bound:.4f} ms",
                      flush=True)
            del cases
            torch.cuda.empty_cache()


def phase_sweep(kup, build, resample):
    lib = build.load("upfirdn2d")
    fir = resample.setup_kernel((1, 3, 3, 1))
    gen = torch.Generator(device="cuda").manual_seed(1)
    default = dict(stages=kup.STAGES, max_tw=None, stage_bytes=kup.STAGE_BYTES)
    knobs = [default] + [dict(stages=s, max_tw=t, stage_bytes=b) for s, t, b in KNOBS]
    s1_knobs = ([default] + [dict(stages=s, max_tw=t, stage_bytes=b) for s, t, b in S1_KNOBS]
                + [dict(default, x_aligned=False)])
    for dtype in (torch.bfloat16, torch.float32):
        cases = call_cases(kup, fir, dtype, gen)
        for what, cs in cases.items():
            stride1 = what.startswith("s1")
            if dtype == torch.float32 and not stride1:
                continue
            ks = s1_knobs if stride1 else knobs
            per = timed([Entry(lib, kup, k) for k in ks], cs, kup)
            for idx, k in enumerate(ks):
                print(f"  {str(dtype)[6:]} per {what}: "
                      + " ".join(f"{n} {v}" for n, v in k.items())
                      + f": {sum(per[idx]):.4f} ms (bound {bound_ms(cs):.4f}); per call "
                      + " ".join(f"{ms * 1e3:.2f}" for ms in per[idx]) + " us", flush=True)
        del cases
        torch.cuda.empty_cache()


def phase_host(kup, resample):
    fir = resample.setup_kernel((1, 3, 3, 1))
    fir4 = fir * 4.0
    x = torch.randn(1, 6, 32, 64, device="cuda")
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        rows[f"upfirdn2d_cuda down {str(dtype)[6:]}"] = \
            lambda xd=xd: kup.upfirdn2d_cuda(xd, fir, up=1, down=2, pad=(1, 1))
        rows[f"upfirdn2d_cuda up {str(dtype)[6:]}"] = \
            lambda xd=xd: kup.upfirdn2d_cuda(xd, fir4, up=2, down=1, pad=(2, 1))
    rows["downsample_2d"] = lambda: resample.downsample_2d(x, (1, 3, 3, 1))
    rows["upsample_2d"] = lambda: resample.upsample_2d(x, (1, 3, 3, 1))
    with torch.inference_mode():
        for name, fn in rows.items():
            try:
                us = f"{host_us(fn):.3f}"
            except (ValueError, RuntimeError) as err:  # an older checkout without bf16
                us = f"not run ({err})"
            print(f"  host us per call, {name} (1, 6, 32, 64): {us}", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = Path(__file__).resolve().parent.parent
    parser.add_argument("--repo", default=str(here),
                        help="checkout whose storm_tpu_torch is measured")
    parser.add_argument("--host-only", action="store_true", help="the host phase alone")
    parser.add_argument("--against", type=Path,
                        help="another csrc/upfirdn2d.cu to compare with, in turns")
    parser.add_argument("--no-sweep", action="store_true", help="skip the knob sweep")
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
    if args.host_only:
        return
    if args.against:
        root = args.against.resolve().parent.parent.parent  # <root>/storm_tpu_torch/csrc/
        print(f"== host enqueue cost, package from {root}", flush=True)
        proc = subprocess.run([sys.executable, __file__, "--repo", str(root), "--host-only"],
                              capture_output=True, text=True)
        print("\n".join(proc.stdout.splitlines()[2:]) or proc.stderr, flush=True)
        print(f"== {args.against} (old) against {build.CSRC / 'upfirdn2d.cu'} (new)", flush=True)
        phase_against(kup, build, resample, args.against)
    if not args.no_sweep:
        print("== launch-plan knobs", flush=True)
        phase_sweep(kup, build, resample)


if __name__ == "__main__":
    main()
