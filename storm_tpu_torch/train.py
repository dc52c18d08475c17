"""StoRM training on the GPU (counterpart of train.py, single process).

    python -m storm_tpu_torch.train --mode regen-joint-training --base_dir corpus/ \\
        [--batch_size 8 --num_frames 256 --num_eval_files 0 --device cuda]

The flags and defaults are the reference CLI's for the two StoRM modes:
NCSN++ denoiser and score nets, OUVE SDE, spec_factor 0.33, Adam at lr 1e-4,
an EMA of 0.999 with warmup. Each epoch runs the training batches, a
validation loss over every validation file with the EMA weights, early
stopping on it, and a checkpoint (`last.pt`, and `best_loss.pt` when the
loss improved). Per-step training losses and the epoch's losses go to
`metrics.jsonl` under the reference's keys. A value this port does not run
yet raises NotImplementedError naming its ROADMAP item; without a CUDA card
the default device raises (pass `--device cpu` for the plain versions).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from .ckpt import CheckpointManager, load_training_checkpoint
from .data.datamodule import SpecsDataModule
from .models.base import init_train_state, swapped_in, wav_to_spec
from .models.factory import STORM_MODES, build_model, resolve_device

MODES = ("score-only", "denoiser-only", "regen-freeze-denoiser", "regen-joint-training",
         "distill")
FORMATS = ("wsj0", "vctk", "dns", "reverb_wsj0", "timit", "voicebank")
MODEL_CONFIG_KEYS = [
    "mode", "backbone_denoiser", "backbone_score", "sde", "lr", "ema_decay", "t_eps",
    "loss_type", "loss_type_denoiser", "loss_type_score", "weighting_denoiser_to_score",
    "condition", "spatial_channels", "sde_n", "theta", "sigma_min", "sigma_max",
    "n_fft", "hop_length", "window", "spec_factor", "spec_abs_exponent", "dtype",
]


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", required=True, choices=MODES)
    p.add_argument("--backbone_denoiser", type=str, default="ncsnpp")
    p.add_argument("--pretrained_denoiser", default=None)
    p.add_argument("--backbone_score", type=str, default="ncsnpp")
    p.add_argument("--pretrained_score", default=None)
    p.add_argument("--sde", type=str, default="ouve", choices=("ouve", "ouvp"))
    p.add_argument("--nolog", action="store_true", help="write no metrics and no checkpoints")
    p.add_argument("--resume_from_checkpoint", default=None,
                   help="a last.pt or best_loss.pt written by this trainer")
    # model
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--ema_decay", type=float, default=0.999)
    p.add_argument("--t_eps", type=float, default=0.03)
    p.add_argument("--num_eval_files", type=int, default=10,
                   help="files enhanced per epoch for PESQ/SI-SDR/ESTOI (ROADMAP R5: "
                        "pass 0 until then)")
    p.add_argument("--loss_type", type=str, default="mse", choices=("mse", "mae", "sisdr"))
    p.add_argument("--loss_type_denoiser", type=str, default="mse",
                   choices=("none", "mse", "mae"))
    p.add_argument("--loss_type_score", type=str, default="mse", choices=("mse", "mae"))
    p.add_argument("--weighting_denoiser_to_score", type=float, default=0.5)
    p.add_argument("--condition", default="both", choices=("noisy", "post_denoiser", "both"))
    p.add_argument("--spatial_channels", type=int, default=1)
    # SDE
    p.add_argument("--sde-n", dest="sde_n", type=int, default=1000)
    p.add_argument("--theta", type=float, default=1.5)
    p.add_argument("--sigma-min", dest="sigma_min", type=float, default=0.05)
    p.add_argument("--sigma-max", dest="sigma_max", type=float, default=0.5)
    # data
    p.add_argument("--format", type=str, default="wsj0", choices=FORMATS)
    p.add_argument("--base_dir", type=str, required=True)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--n_fft", type=int, default=510)
    p.add_argument("--hop_length", type=int, default=128)
    p.add_argument("--num_frames", type=int, default=256)
    p.add_argument("--window", type=str, choices=("sqrthann", "hann"), default="hann")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--dummy", action="store_true")
    p.add_argument("--spec_factor", type=float, default=0.33)
    p.add_argument("--spec_abs_exponent", type=float, default=0.5)
    p.add_argument("--return_time", action="store_true")
    # trainer
    p.add_argument("--max_epochs", type=int, default=1000)
    p.add_argument("--max_steps", type=int, default=None,
                   help="stop after this many optimizer steps")
    p.add_argument("--patience", type=int, default=50,
                   help="early-stopping patience on valid_loss")
    p.add_argument("--log_dir", type=str, default="./.logs")
    p.add_argument("--log_every_n_steps", type=int, default=10)
    p.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--nf", type=int, default=None, help="override the backbones' base width")
    p.add_argument("--ch_mult", type=str, default=None,
                   help="override the backbones' channel multipliers, e.g. 1,2,2,2")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    return p.parse_args(argv)


def check_supported(args: argparse.Namespace) -> None:
    """Raise NotImplementedError for a value this slice does not run."""
    todo = []
    if args.mode not in STORM_MODES:
        todo.append(f"--mode {args.mode} (ROADMAP R3)")
    for flag in ("backbone_denoiser", "backbone_score"):
        if getattr(args, flag) != "ncsnpp":
            todo.append(f"--{flag} {getattr(args, flag)} (ROADMAP R4)")
    if args.sde != "ouve":
        todo.append(f"--sde {args.sde} (ROADMAP R3)")
    if args.pretrained_denoiser or args.pretrained_score:
        todo.append("--pretrained_denoiser / --pretrained_score (ROADMAP M7)")
    if args.num_eval_files > 0:
        todo.append(f"--num_eval_files {args.num_eval_files} > 0: the in-training "
                    "PESQ/SI-SDR/ESTOI evaluation (ROADMAP R5); pass --num_eval_files 0")
    if args.return_time:
        todo.append("--return_time (ROADMAP R4, time-domain backbones)")
    if args.dtype != "float32":
        todo.append(f"--dtype {args.dtype} (ROADMAP M9b, bfloat16 training)")
    if args.spatial_channels != 1:
        todo.append(f"--spatial_channels {args.spatial_channels} (ROADMAP R7)")
    if todo:
        raise NotImplementedError("not ported yet: " + "; ".join(todo))


def model_config(args: argparse.Namespace) -> dict:
    config = {k: getattr(args, k) for k in MODEL_CONFIG_KEYS}
    if args.nf is not None:
        config["nf"] = args.nf
    if args.ch_mult is not None:
        config["ch_mult"] = [int(c) for c in args.ch_mult.split(",")]
    return config


def seeded_generator(device: torch.device, *entropy: int) -> torch.Generator:
    """A generator that is a pure function of `entropy`: a training step's is
    seeded with (seed, epoch, 0, step) and an epoch's validation with
    (seed, epoch, 1), so a resumed run draws what a continuous run would."""
    s = int(np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    check_supported(args)
    device = resolve_device(args.device)
    config = model_config(args)
    model = build_model(config, device=device, seed=args.seed).train()
    state = init_train_state(model, args.lr)

    dm = SpecsDataModule(base_dir=args.base_dir, format=args.format,
                         spatial_channels=args.spatial_channels, batch_size=args.batch_size,
                         hop_length=args.hop_length, num_frames=args.num_frames,
                         num_workers=args.num_workers, dummy=args.dummy, seed=args.seed)
    dm.setup("fit")
    print(f"train files: {len(dm.train_set)}, valid files: {len(dm.valid_set)}")

    start_epoch, meta = 0, None
    if args.resume_from_checkpoint:
        ckpt = load_training_checkpoint(args.resume_from_checkpoint)
        if ckpt["optimizer"] is None or ckpt["step"] is None:
            raise SystemExit(f"{args.resume_from_checkpoint}: no optimizer state to resume from")
        model.load_state_dict(ckpt["params"], strict=True)
        state.ema = {k: v.to(device) for k, v in ckpt["ema_params"].items()}
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = ckpt["step"]
        meta = ckpt["meta"] or {}
        if meta.get("epoch") is not None:
            start_epoch = int(meta["epoch"]) + 1
        print(f"resumed from {args.resume_from_checkpoint} at step {state.step}, "
              f"epoch {start_epoch}")

    run_name = (f"mode={args.mode}_sde=OUVESDE_score={args.backbone_score}"
                f"_denoiser={args.backbone_denoiser}_condition={args.condition}"
                f"_data={args.format}_ch={args.spatial_channels}")
    log_dir = os.path.join(args.log_dir, run_name)
    metrics_file, ckpt_mgr = None, None
    if not args.nolog:
        os.makedirs(log_dir, exist_ok=True)
        metrics_file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        ckpt_mgr = CheckpointManager(os.path.join(log_dir, "checkpoints"), config)
        print(f"logging to {log_dir}")

    def log(step: int, **metrics) -> None:
        if metrics_file is not None:
            metrics_file.write(json.dumps({"step": step, **metrics}) + "\n")
            metrics_file.flush()

    def prepare(batch):
        """(x, y) waveforms (B, T) -> compressed specs (B, F, T', 2) on the device."""
        with torch.no_grad():
            return tuple(wav_to_spec(torch.from_numpy(np.asarray(b)).to(device),
                                     model.stft_config, model.transform) for b in batch)

    best_valid, bad_epochs = math.inf, 0
    if meta:
        best_valid = float(meta["best_valid"]) if meta.get("best_valid") is not None else math.inf
        bad_epochs = int(meta.get("bad_epochs") or 0)
        if ckpt_mgr is not None:
            ckpt_mgr.restore_from_meta(meta)
    t_start = time.time()
    try:
        for epoch in range(start_epoch, args.max_epochs):
            loader = dm.train_dataloader()
            loader.set_epoch(epoch)
            model.train()
            epoch_losses = []
            for batch in loader:
                gen = seeded_generator(device, args.seed, epoch, 0, state.step)
                aux = model.train_step(state, prepare(batch), gen)
                if state.step % args.log_every_n_steps == 0:
                    log(state.step, **{f"train_{k}": float(v) for k, v in aux.items()})
                epoch_losses.append(aux["loss"])
                if args.max_steps and state.step >= args.max_steps:
                    break
            train_loss = float(torch.stack(epoch_losses).mean()) if epoch_losses else math.nan

            # validation over every file with the EMA weights; the short last
            # batch is padded and masked, and the mean keeps the batch-sum
            # scale of the training loss
            model.eval()
            gen = seeded_generator(device, args.seed, epoch, 1)
            v_sum, v_count = 0.0, 0
            with torch.no_grad(), swapped_in(model, state.ema):
                for bx, by in dm.val_dataloader():
                    n = bx.shape[0]
                    if n < args.batch_size:
                        widths = [(0, args.batch_size - n)] + [(0, 0)] * (bx.ndim - 1)
                        bx, by = np.pad(bx, widths), np.pad(by, widths)
                    per_example = model.loss_per_example(prepare((bx, by)), gen)
                    v_sum += float(per_example[:n].sum())
                    v_count += n
            valid_loss = v_sum / v_count * args.batch_size if v_count else math.nan

            print(f"epoch {epoch}: train_loss={train_loss:.4f} valid_loss={valid_loss:.4f} "
                  f"step={state.step} ({time.time() - t_start:.0f}s)", flush=True)
            log(state.step, train_loss_epoch=train_loss, valid_loss=valid_loss)
            if valid_loss < best_valid:
                best_valid, bad_epochs = valid_loss, 0
            else:
                bad_epochs += 1
            if ckpt_mgr is not None:
                ckpt_mgr.step(state, valid_loss=valid_loss, epoch=epoch,
                              bad_epochs=bad_epochs, best_valid=best_valid)
            if bad_epochs >= args.patience:
                print(f"early stopping at epoch {epoch}")
                break
            if args.max_steps and state.step >= args.max_steps:
                break
    finally:
        if metrics_file is not None:
            metrics_file.close()
    print("training done.")


if __name__ == "__main__":
    main()
