"""Serving across the cards of one host, against one card.

    python3 tools/multi_card_serving.py [--reps 2] [--out chiprun_out/multi_card.json]
    python3 tools/multi_card_serving.py --one-card [--N 4]   (every group on cuda:0: a dry run)

Full-width StoRM (2 x 27.8M NCSN++, seeded random weights, bfloat16), the
reference CLI's sampler (pc, reverse diffusion + ald, N=50: NFE 101), on
the visible cards (at least 2; `--one-card` lays every group on cuda:0):

1. the cards: `nvidia-smi topo -m`, and each card's name and power limit.
2. data parallel at bench.py's shape, B=16 x 32640 samples (2.04 s):
   one card (one call of 16 rows) against `data_parallel` over every card
   (16 / cards rows a replica), and the same replicas all on cuda:0, whose
   output the cards' must equal bit for bit (the same kernels on the same
   rows, from the same draws). Each enhancer's first call is its eager loop,
   its second captures; then `--reps` replays are timed (the wall of the
   fastest, ending with the output's copy to the host): audio s/s.
3. sequence parallel at B=1 on a 4 s file (65536 samples, 576 frames):
   one card (a replay), `seq_parallel` = cards over every card, and
   `seq_parallel` = cards / 2 with `data_parallel` (two replicas, the row
   padded to 2): the real-time factor of the fastest of `--reps` calls after
   two warm-up calls, how each call ran (`execution`: a group across cards
   runs eagerly), and each output against the same groups laid on cuda:0
   (eager there: bit for bit) and against one card's (bfloat16 rounding
   order; printed).
4. whether a CUDA graph captures work queued on two cards (a stream of the
   second forked into the capture of the first by events), in a process of
   its own: what a group across cards would need to replay.

Prints one JSON object (also written to `--out`).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from storm_tpu_torch.models.factory import build_model, resolve_device  # noqa: E402
from storm_tpu_torch.utils.inference import BucketedEnhancer  # noqa: E402

CONFIG = {"mode": "regen-joint-training", "init_scale": 1.0, "dtype": "bfloat16"}
SR, N = 16000, 50
BENCH_B, BENCH_T = 16, 32640  # bench.py's shape: 256 frames at hop 128
SP_T = 65536  # 4 s, padded to its bucket: 576 frames

PROBE = r"""
import torch
a, b = torch.device("cuda", 0), torch.device("cuda", 1)
x = torch.ones(1 << 20, device=a)
s0, s1 = torch.cuda.Stream(a), torch.cuda.Stream(b)
g = torch.cuda.CUDAGraph()
torch.cuda.synchronize(a); torch.cuda.synchronize(b)
with torch.cuda.stream(s0):
    g.capture_begin()
    y = x * 2
    s1.wait_stream(s0)
    with torch.cuda.stream(s1):
        z = y.to(b) + 1
    s0.wait_stream(s1)
    w = z.to(a) * 3
    g.capture_end()
g.replay()
torch.cuda.synchronize(a); torch.cuda.synchronize(b)
print("replayed", float(w[0]))
"""


def cards_line():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()


def gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda:0").manual_seed(seed)


def timed(enhancer, y, seed: int, reps: int):
    """(fastest wall s of `reps` calls, the last output); every call from a
    generator seeded with `seed`."""
    walls, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = enhancer(y, gen(seed))  # ends with the copy to the host
        walls.append(time.perf_counter() - t0)
    return min(walls), out


def rel(a, b) -> float:
    return float(np.abs(a - b).max() / np.abs(b).max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--N", type=int, default=N, help="reverse steps (a dry run may cut them)")
    ap.add_argument("--one-card", action="store_true",
                    help="lay every group on cuda:0 (a dry run on one card)")
    ap.add_argument("--out", default="chiprun_out/multi_card.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("multi_card_serving.py needs CUDA cards")
    resolve_device("cuda")  # TF32 off
    n = 4 if args.one_card else torch.cuda.device_count()
    if n < 2:
        raise SystemExit(f"{n} card visible: run with --one-card, or on a host with several")
    cards = ["cuda:0"] * n if args.one_card else [f"cuda:{i}" for i in range(n)]
    on_one = ["cuda:0"] * n
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True)
    print(topo.stdout, flush=True)
    names = cards_line()
    print("\n".join(names), flush=True)
    record = {"cards": names, "devices": cards, "N": args.N, "dtype": "bfloat16"}

    model = build_model(CONFIG, device="cuda:0", seed=0)
    rng = np.random.default_rng(0)
    kw = dict(N=args.N, corrector="ald")

    # --- data parallel at the bench's shape
    y = (0.1 * rng.standard_normal((BENCH_B, BENCH_T))).astype(np.float32)
    audio_s = BENCH_B * BENCH_T / SR
    dp = {}
    for name, extra in (("one_card", {}),
                        ("data_parallel", dict(data_parallel=True, devices=cards)),
                        ("data_parallel_on_cuda0", dict(data_parallel=True, devices=on_one))):
        enhancer = BucketedEnhancer(model, minibatch=BENCH_B, **extra, **kw)
        t0 = time.perf_counter()
        enhancer(y, gen(1))
        enhancer(y, gen(1))  # the warm-up and capture
        warm = time.perf_counter() - t0
        wall, out = timed(enhancer, y, 2, args.reps)
        dp[name] = out
        record[f"dp_{name}"] = {"audio_s_per_s": audio_s / wall, "wall_s": wall,
                                "first_two_calls_s": warm, "execution": enhancer.execution,
                                "replicas": len(enhancer.replicas) or 1,
                                "graphs": enhancer.graph_stats}
        print(f"{name}: {audio_s / wall:.4f} audio s/s ({wall:.4f} s for {BENCH_B} x "
              f"{BENCH_T / SR:.2f} s; first two calls {warm:.1f} s; {enhancer.execution})",
              flush=True)
        del enhancer
        torch.cuda.empty_cache()
    record["dp_speedup"] = (record["dp_data_parallel"]["audio_s_per_s"]
                            / record["dp_one_card"]["audio_s_per_s"])
    record["dp_equal_to_cuda0_replicas"] = bool(
        np.array_equal(dp["data_parallel"], dp["data_parallel_on_cuda0"]))
    record["dp_rel_to_one_card"] = rel(dp["data_parallel"], dp["one_card"])
    print(f"data parallel over {n}: {record['dp_speedup']:.3f}x one card; bit for bit the "
          f"replicas on cuda:0: {record['dp_equal_to_cuda0_replicas']}; against one card's "
          f"16-row call {record['dp_rel_to_one_card']:.3e} of the scale", flush=True)

    # --- sequence parallel at B=1, 4 s
    y1 = (0.1 * rng.standard_normal(SP_T)).astype(np.float32)
    sp = {}
    for name, extra, ref_extra in (
            ("one_card", {}, None),
            (f"seq_parallel_{n}", dict(seq_parallel=n, devices=cards),
             dict(seq_parallel=n, devices=on_one, graphs=False)),
            (f"seq_parallel_{n // 2}_data_parallel",
             dict(seq_parallel=n // 2, data_parallel=True, devices=cards),
             dict(seq_parallel=n // 2, data_parallel=True, devices=on_one, graphs=False))):
        enhancer = BucketedEnhancer(model, **extra, **kw)
        t0 = time.perf_counter()
        enhancer(y1, gen(1))
        enhancer(y1, gen(1))
        warm = time.perf_counter() - t0
        wall, out = timed(enhancer, y1, 3, args.reps)
        sp[name] = out
        entry = {"rtf": wall / (SP_T / SR), "wall_s": wall, "first_two_calls_s": warm,
                 "execution": enhancer.execution, "minibatch": enhancer.minibatch,
                 "groups": enhancer.groups, "graphs": enhancer.graph_stats}
        if ref_extra is not None:
            ref, _ = BucketedEnhancer(model, **ref_extra, **kw)(y1, gen(3))
            entry["equal_to_cuda0_groups"] = bool(np.array_equal(out, ref))
            entry["rel_to_one_card"] = rel(out, sp["one_card"])
            entry["rtf_over_one_card"] = entry["rtf"] / record["sp_one_card"]["rtf"]
        record[f"sp_{name}"] = entry
        print(f"{name}: RTF {entry['rtf']:.4f} ({enhancer.execution}; first two calls "
              f"{warm:.1f} s)" + (f"; {entry['rtf_over_one_card']:.2f}x one card's RTF; bit for "
                                  f"bit the groups on cuda:0: {entry['equal_to_cuda0_groups']}; "
                                  f"against one card {entry['rel_to_one_card']:.3e} of the scale"
                                  if ref_extra is not None else ""), flush=True)
        del enhancer
        torch.cuda.empty_cache()

    # --- a capture across two cards, in a process of its own
    if not args.one_card:
        probe = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                               timeout=300)
        record["capture_across_cards"] = {
            "rc": probe.returncode, "stdout": probe.stdout.strip()[-400:],
            "stderr": probe.stderr.strip()[-600:]}
        print(f"capture across two cards: rc {probe.returncode}: "
              f"{(probe.stdout or probe.stderr).strip()[-300:]}", flush=True)

    text = json.dumps(record, default=str)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
