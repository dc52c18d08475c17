"""How far apart one process and two Gloo processes land on GaGNet-BN's
gradients, and how far each lies from the float64 step.

    python tools/gagnet_bn_precision.py [--width full|test]

One optimizer step's gradients of a seeded `--mode denoiser-only` GaGNet
with `--norm_type BN`, on the CPU, at the reference CLI's width (`full`) or
at the CPU tests' (`test`: n_fft 126, c 8, d_feat 64, p 1, q 1), for a
seeded batch of ROWS waveforms of 32 frames: as one process, and as two
processes of half the rows each whose BN moments span both
(`backbones/gagnet.moments_across`), their gradients summed and divided by
two as the trainer's split step does for a mean loss. Each in float32 and
in float64 (the net's parameters and its `dtype`). Prints each run's
distance from the one-process float64 gradients, |a - b| / |b| over every
element, and the two float32 runs' distance from each other.
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from storm_tpu_torch.backbones.gagnet import batch_norms, moments_across  # noqa: E402
from storm_tpu_torch.models.base import wav_to_spec  # noqa: E402
from storm_tpu_torch.models.factory import build_model  # noqa: E402
from storm_tpu_torch.utils.distributed import World  # noqa: E402

ROWS = 4
TEST_WIDTH = {"n_fft": 126, "hop_length": 32, "fft_num": 128, "d_feat": 64, "c": 8, "cd1": 8,
              "p": 1, "q": 1}


def gradients(config, rows: int, dtype: torch.dtype, rank: int = 0, size: int = 1):
    """This process's share of one step's gradients (rows rank * rows / size
    onward), summed over the processes and divided by their count."""
    torch.manual_seed(0)
    model = build_model(config, device="cpu", seed=0).train()
    if dtype == torch.float64:
        model = model.double()
        model.dnn.dtype = torch.float64
    hop = config.get("hop_length", 128)
    rng = np.random.default_rng(0)
    clean = 0.3 * rng.standard_normal((rows, 31 * hop))
    noisy = clean + 0.1 * rng.standard_normal(clean.shape)
    mine = slice(rank * rows // size, (rank + 1) * rows // size)
    batch = tuple(wav_to_spec(torch.from_numpy(w[mine]).to(dtype), model.stft_config,
                              model.transform) for w in (clean, noisy))
    world = World(rank, size, "gloo", torch.device("cpu")) if size > 1 else World()
    with moments_across(batch_norms(model), world):
        model.compute_gradients(batch, *model.draw_step(batch, None))
    grads = [p.grad.detach().double() for p in model.parameters() if p.requires_grad]
    if size > 1:
        for g in grads:
            dist.all_reduce(g)
            g /= size
    return grads


def _process(rank: int, port: int, config, rows: int, dtype, out: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    grads = gradients(config, rows, dtype, rank, 2)
    if rank == 0:
        torch.save(grads, out)
    dist.destroy_process_group()


def two_processes(config, rows: int, dtype: torch.dtype):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "grads.pt")
        mp.spawn(_process, args=(port, config, rows, dtype, out), nprocs=2)
        return torch.load(out)


def distance(a, b) -> float:
    return float(torch.cat([(x - y).flatten() for x, y in zip(a, b)]).norm()
                 / torch.cat([y.flatten() for y in b]).norm())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", choices=("full", "test"), default="full")
    args = ap.parse_args(argv)
    config = {"mode": "denoiser-only", "backbone_denoiser": "gagnet", "norm_type": "BN",
              **(TEST_WIDTH if args.width == "test" else {})}
    runs = {(n, str(dt).split(".")[-1]): (gradients(config, ROWS, dt) if n == "one"
                                          else two_processes(config, ROWS, dt))
            for dt in (torch.float64, torch.float32) for n in ("one", "two")}
    exact = runs[("one", "float64")]
    for (n, dt), g in runs.items():
        print(f"{n} process(es), {dt}: {distance(g, exact):.3e} from one process in float64")
    apart = distance(runs[("two", "float32")], runs[("one", "float32")])
    print(f"the two float32 runs: {apart:.3e} apart")


if __name__ == "__main__":
    main()
