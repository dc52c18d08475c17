"""Training on the GPU (counterpart of train.py), in one process or data
parallel across several.

    python -m storm_tpu_torch.train --mode regen-joint-training --base_dir corpus/ \\
        [--batch_size 8 --num_frames 256 --num_eval_files 10 --eval_N 30 \\
         --sde ouve|ouvp --dtype float32|bfloat16 --device cuda]

The flags and defaults are the reference CLI's for the five trainable
modes: the two StoRM modes (a denoiser and a score net of the backbone
registry, `--backbone_denoiser` / `--backbone_score`: ncsnpp, ncsnpplarge,
ncsnpp12M, ncsnpp6M, and for the denoiser the time-domain convtasnet and
ae-ncsnpp; the chosen backbones add their own flags, as ConvTasNet's
`--causal`), `score-only`
(SGMSE+: one score net, denoising score matching, `--loss_type mse|mae`),
`denoiser-only` (one predictive net, `--loss_type mse|mae|sisdr`) and
`distill` (the one-step student of `--teacher_ckpt`, a StoRM checkpoint,
matched to `--distill_N` steps of its probability-flow ODE by
`--distill_method`; every model, signal and dtype field is the teacher's,
and params and EMA start at its EMA weights; the evaluation runs the
student at NFE 2); the
OUVE SDE or, with `--sde ouvp`, the OUVP SDE of `--beta-min` / `--beta-max`
/ `--stiffness` (the config keeps only the chosen SDE's keys, as the
reference's does); spec_factor 0.33, Adam at lr 1e-4,
an EMA of 0.999 with warmup, computing in `--dtype` with float32 parameters
(the loss, Adam and the EMA in float32). Each epoch runs the training
batches, a validation loss over every validation file with the EMA weights
(its per-example losses combined as the model's loss combines the batch:
summed for StoRM and the student, the mean for the other two), then, with
the EMA weights too, the evaluation: the first `--num_eval_files` validation files enhanced
whole (`--eval_N` reverse steps; unset, the model's default: StoRM's 30
without a corrector, the score model's 50 with ald; the denoiser runs one
forward) and scored by PESQ (NaN without the `pesq` package), SI-SDR and
ESTOI (utils/inference.py `evaluate_model`). Early stopping
follows the validation loss. Each epoch writes `last.pt`, and `best_loss.pt`
when the loss improved and `best_pesq.pt` when PESQ, or ESTOI where PESQ is
NaN, improved. Per-step training losses and the epoch's losses and metrics
go to `metrics.jsonl` under the reference's keys. An evaluation that fails
is printed and logged as NaN, and training goes on, as in the reference.
The run exits with a message for `--return_time` without a denoiser-only
model on a mono time-domain net, for `--mode distill` without a StoRM
`--teacher_ckpt`, and for a `--batch_size` the processes do not divide.

Each training step and each validation batch runs as the replay of a
captured CUDA graph from its program's third call, the first running
eagerly and the second warming up and capturing (utils/train_graphs.py,
the counterpart of the reference's jitted programs); a step reads the
device only where the log reads its losses, every `--log_every_n_steps`
steps, and the validation loss is summed on the device and read once per
epoch. `--debug_nans` runs the steps eagerly under
`torch.autograd.set_detect_anomaly`, which reads the device inside
backward, and raises on a non-finite loss. Checkpoints are written by
`ckpt.AsyncCheckpointManager`: a snapshot on the device, then the copy to
the host and the write in a thread while the next epoch trains.
`--return_time` (denoiser-only with a time-domain backbone) trains on the
waveforms themselves, with no STFT on the loss path.
`--pretrained_denoiser` / `--pretrained_score` graft a net's parameters
and EMA from a StoRM checkpoint or a one-net (denoiser-only, score-only)
one into a StoRM model (train.py:396-419). Without a CUDA card the default
device raises (pass `--device cpu` for the plain versions).
`--spatial_channels D` trains on the first D channels of every file: the
batches are (B, D, T), both nets take D-channel spectrograms, and the
evaluation enhances D channels and scores the first (train.py:127, 319,
331).

Data parallel (train.py:220-360): every process runs this command with
STORM_TPU_COORDINATOR=host:port, STORM_TPU_NUM_PROCESSES=n and
STORM_TPU_PROCESS_ID=p (utils/distributed.py: NCCL with a card per process,
process p on cuda:p; Gloo for processes that share a card or run on the
CPU; the choice is printed first). `--batch_size` stays the global batch:
each process loads its rows of every global batch (the loader's `shard`),
draws the random inputs of the whole batch and keeps its rows, and sums its
gradients and losses with the others' before Adam and the EMA
(utils/train_graphs.py), so that n processes compute what one does at the
same global batch. The validation sums each process's rows, masked by
global row index, across the processes. Only process 0 logs, writes
`metrics.jsonl` and checkpoints, and runs the evaluation; the others wait
for it at a barrier, and take its validation loss and metrics, so that
early stopping and the best checkpoints are decided once for all. A resumed
run reads the checkpoint on process 0 and broadcasts it
(`ckpt.resume_training_state`).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import backbones
from .ckpt import (AsyncCheckpointManager, CheckpointManager, load_checkpoint,
                   resume_training_state)
from .data.datamodule import SpecsDataModule
from .models.base import TrainState, init_train_state, is_time_domain, swapped_in
from .models.distill import DISTILL_METHODS
from .models.factory import build_model, resolve_device
from .models.storm import StochasticRegenerationModel
from .utils.distributed import World, all_reduce_, init_from_env
from .utils.inference import evaluate_model
from .utils.train_graphs import TrainPrograms, use_expandable_segments

MODES = ("score-only", "denoiser-only", "regen-freeze-denoiser", "regen-joint-training",
         "distill")
FORMATS = ("wsj0", "vctk", "dns", "reverb_wsj0", "timit", "voicebank")
VIS_EPOCHS = 5  # the evaluation's examples go to TensorBoard every this many epochs
MODEL_CONFIG_KEYS = [
    "mode", "backbone_denoiser", "backbone_score", "sde", "lr", "ema_decay", "t_eps",
    "loss_type", "loss_type_denoiser", "loss_type_score", "weighting_denoiser_to_score",
    "condition", "spatial_channels", "sde_n", "theta", "sigma_min", "sigma_max",
    "beta_min", "beta_max", "stiffness", "n_fft", "hop_length", "window", "spec_factor",
    "spec_abs_exponent", "dtype",
]


class DedupGroup:
    """An argument group that skips an option string already registered, as
    when two chosen backbones contribute the same flag (`--causal`): the
    first registration wins and its value reaches both nets. A duplicate
    registered with another arity or type is reported on stderr
    (train.py `_DedupGroup`)."""

    def __init__(self, group):
        self._group = group

    def add_argument(self, *a, **kw):
        try:
            return self._group.add_argument(*a, **kw)
        except argparse.ArgumentError:
            existing = getattr(self._group, "_option_string_actions", {})
            want_nargs = 0 if kw.get("action") in ("store_true", "store_false") else kw.get("nargs")
            for opt in a:
                act = existing.get(opt)
                if act is not None and (act.nargs != want_nargs
                                        or getattr(act.type, "__name__", None)
                                        != getattr(kw.get("type"), "__name__", None)):
                    print(f"warning: duplicate flag {opt} skipped with a different arity/type "
                          "than its first registration", file=sys.stderr)
            return None


def add_backbone_groups(parser: argparse.ArgumentParser, names: Sequence[str]) -> List[str]:
    """Attach the argparse group of each chosen backbone class (once per
    class; an unknown name adds nothing, and the model factory reports it)
    and return the dests they added (train.py:176-196)."""
    keys, seen = [], set()
    for name in names:
        try:
            cls = backbones.get_by_name(name)
        except ValueError:
            continue
        add = getattr(cls, "add_argparse_args", None)
        if add is None or cls in seen:
            continue
        seen.add(cls)
        before = {a.dest for a in parser._actions}
        add(DedupGroup(parser.add_argument_group(f"{name} backbone")))
        keys += [a.dest for a in parser._actions if a.dest not in before]
    return keys


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    # a pre-parse picks the backbones, whose groups then join the parser
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--backbone_denoiser", type=str, default="ncsnpp")
    pre.add_argument("--backbone_score", type=str, default="ncsnpp")
    pre_args, _ = pre.parse_known_args(argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", required=True, choices=MODES)
    # distillation (storm_tpu/models/distill.py)
    p.add_argument("--teacher_ckpt", default=None,
                   help="converged storm checkpoint to distill (required with --mode distill); "
                        "the student inherits its full architecture and initializes from its "
                        "EMA weights")
    p.add_argument("--distill_N", type=int, default=8,
                   help="teacher probability-flow ODE steps per distillation target")
    p.add_argument("--distill_method", default="etd2", choices=DISTILL_METHODS,
                   help="teacher ODE integrator for the targets")
    p.add_argument("--distill_gt_weight", type=float, default=0.0,
                   help="optional auxiliary clean-target MSE weight on top of the pure "
                        "teacher-matching loss")
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
                   help="validation files enhanced per epoch for PESQ/SI-SDR/ESTOI (0: none)")
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
    p.add_argument("--beta-min", dest="beta_min", type=float, default=0.1)
    p.add_argument("--beta-max", dest="beta_max", type=float, default=1.0)
    p.add_argument("--stiffness", type=float, default=1.0)
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
    p.add_argument("--eval_N", type=int, default=None,
                   help="reverse steps of the in-training evaluation (default: the model's)")
    p.add_argument("--debug_nans", action="store_true",
                   help="enable jax_debug_nans (the reference keeps torch detect_anomaly always "
                        "on, model.py:22 — here it is opt-in); the steps run eagerly")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    keys = add_backbone_groups(p, (pre_args.backbone_denoiser, pre_args.backbone_score))
    args = p.parse_args(argv)
    args.backbone_config_keys = keys
    return args


RETURN_TIME_REFUSED = ("--return_time requires --mode denoiser-only with a mono time-domain "
                       "backbone (convtasnet)")


def check_return_time(args: argparse.Namespace, model) -> None:
    """Exit with the reference's message unless `--return_time` has a
    denoiser-only model on a one-channel time-domain net."""
    if args.return_time and (args.mode != "denoiser-only"
                             or not is_time_domain(getattr(model, "dnn", None))
                             or args.spatial_channels != 1):
        raise SystemExit(RETURN_TIME_REFUSED)


def model_config(args: argparse.Namespace) -> dict:
    """The checkpoint's config: the model's flags, without the other SDE's
    (train.py:308-313)."""
    config = {k: getattr(args, k) for k in MODEL_CONFIG_KEYS}
    # the flags of the chosen backbones' groups
    config.update({k: getattr(args, k) for k in getattr(args, "backbone_config_keys", [])})
    other_sde = {"ouve": ("beta_min", "beta_max", "stiffness"),
                 "ouvp": ("theta", "sigma_min", "sigma_max")}[args.sde]
    for k in other_sde:
        config.pop(k)
    if args.nf is not None:
        config["nf"] = args.nf
    if args.ch_mult is not None:
        config["ch_mult"] = [int(c) for c in args.ch_mult.split(",")]
    return config


def distill_config(args: argparse.Namespace):
    """(the student's config, the teacher's EMA weights) for `--mode distill`:
    every model and signal field is the teacher checkpoint's, and the data
    flags follow them; the optimizer and distillation flags are this run's
    (train.py:266-298)."""
    if not args.teacher_ckpt:
        raise SystemExit("--mode distill requires --teacher_ckpt")
    t_config, _, t_ema = load_checkpoint(args.teacher_ckpt)
    if t_config.get("mode") not in ("regen-joint-training", "regen-freeze-denoiser"):
        raise SystemExit("--teacher_ckpt must be a storm (regen-*) checkpoint, got "
                         f"mode={t_config.get('mode')!r}")
    config = dict(t_config, mode="distill", lr=args.lr, ema_decay=args.ema_decay,
                  distill_N=args.distill_N, distill_method=args.distill_method,
                  distill_gt_weight=args.distill_gt_weight)
    for k in ("n_fft", "hop_length", "window", "spec_factor", "spec_abs_exponent",
              "backbone_denoiser", "backbone_score", "condition", "spatial_channels", "sde"):
        if k in config:
            setattr(args, k, config[k])
    return config, t_ema


def seeded_generator(device: torch.device, *entropy: int) -> torch.Generator:
    """A generator that is a pure function of `entropy`: a training step's is
    seeded with (seed, epoch, 0, step) and an epoch's validation with
    (seed, epoch, 1), so a resumed run draws what a continuous run would."""
    s = int(np.random.SeedSequence(list(entropy)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def graft_pretrained(state: TrainState, path: str, net: str) -> None:
    """Set StoRM's `net` ("denoiser_net" or "score_net") and its EMA to the
    parameters of the checkpoint `path`: its `net` if it is a StoRM
    checkpoint, else the one net (`dnn`) of a denoiser-only or score-only
    one (train.py:396-419, which grafts the source's parameters, not its
    EMA). Raises ValueError for a model that is not StoRM, as the reference
    asserts."""
    model = state.model
    if not isinstance(model, StochasticRegenerationModel):
        raise ValueError(f"grafting a pretrained {net} needs a StoRM model (regen-*), "
                         f"not {type(model).__name__}")
    params = load_checkpoint(path)[1]
    prefix = f"{net}." if any(k.startswith(f"{net}.") for k in params) else "dnn."
    target = getattr(model, net)
    target.load_state_dict({k[len(prefix):]: v for k, v in params.items()
                            if k.startswith(prefix)}, strict=True)
    for k, v in target.state_dict().items():
        state.ema[f"{net}.{k}"].copy_(v)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    world = init_from_env(args.device)
    if world.size > 1:
        print(f"process {world.rank} of {world.size}: backend {world.backend} on "
              f"{world.device}", flush=True)
    try:
        train(args, world)
    except BaseException:
        world.close(barrier=False)  # the others fail at their next collective
        raise
    world.close()


def train(args: argparse.Namespace, world: World = World()) -> None:
    """The training run of `args`, as process `world.rank` of `world.size`."""
    say = print if world.is_main else (lambda *a, **k: None)
    teacher = None
    if args.mode == "distill":
        config, teacher = distill_config(args)
    else:
        config = model_config(args)
    device = resolve_device(world.device or args.device)
    model = build_model(config, device=device, seed=args.seed).train()
    check_return_time(args, model)
    if world.size > 1:
        if args.batch_size % world.size:
            raise SystemExit(f"--batch_size {args.batch_size} not divisible by "
                             f"{world.size} processes")
    if teacher is not None:
        # the student starts at the teacher: params and EMA are its EMA weights,
        # and the denoiser rides along frozen, so the checkpoint serves alone
        model.load_state_dict(teacher, strict=True)
        model.with_teacher({k[len("score_net."):]: v for k, v in teacher.items()
                            if k.startswith("score_net.")})
        say(f"distilling teacher {args.teacher_ckpt} "
              f"(N={args.distill_N} {args.distill_method} targets)")
    state = init_train_state(model, args.lr)

    dm = SpecsDataModule(base_dir=args.base_dir, format=args.format,
                         spatial_channels=args.spatial_channels, batch_size=args.batch_size,
                         hop_length=args.hop_length, num_frames=args.num_frames,
                         num_workers=args.num_workers, dummy=args.dummy, seed=args.seed,
                         shard=world.shard)
    dm.setup("fit")
    say(f"train files: {len(dm.train_set)}, valid files: {len(dm.valid_set)}")

    start_epoch, meta = 0, None
    if args.resume_from_checkpoint:
        meta = resume_training_state(args.resume_from_checkpoint, state, world)
        if meta.get("epoch") is not None:
            start_epoch = int(meta["epoch"]) + 1
        say(f"resumed from {args.resume_from_checkpoint} at step {state.step}, "
              f"epoch {start_epoch}")
    # component grafting, after a resume as in the reference (train.py:396-419)
    for path, net, what in ((args.pretrained_denoiser, "denoiser_net", "denoiser"),
                            (args.pretrained_score, "score_net", "score model")):
        if path:
            graft_pretrained(state, path, net)
            say(f"grafted pretrained {what} from {path}")
    programs = TrainPrograms(state, debug_nans=args.debug_nans, return_time=args.return_time,
                             world=world)
    say(f"training steps and validation: {programs.execution}")

    sde_name = {"ouve": "OUVESDE", "ouvp": "OUVPSDE"}[args.sde]
    run_name = (f"mode={args.mode}_sde={sde_name}_score={args.backbone_score}"
                f"_denoiser={args.backbone_denoiser}_condition={args.condition}"
                f"_data={args.format}_ch={args.spatial_channels}")
    log_dir = os.path.join(args.log_dir, run_name)
    metrics_file, ckpt_mgr, writer = None, None, None
    if not args.nolog and world.is_main:
        os.makedirs(log_dir, exist_ok=True)
        try:  # TensorBoard where it is installed, as the reference logs
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(log_dir)
        except ImportError:
            writer = None
        metrics_file = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        ckpt_mgr = AsyncCheckpointManager(
            CheckpointManager(os.path.join(log_dir, "checkpoints"), config))
        say(f"logging to {log_dir}")

    def log(step: int, **metrics) -> None:
        if writer is not None:
            for k, v in metrics.items():
                if np.isfinite(v):
                    writer.add_scalar(k, v, step)
        if metrics_file is not None:
            metrics_file.write(json.dumps({"step": step, **metrics}) + "\n")
            metrics_file.flush()

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
                aux = programs.step(batch, gen)
                if args.debug_nans and not bool(torch.isfinite(aux["loss"])):
                    raise FloatingPointError(
                        f"non-finite loss {float(aux['loss'])} at step {state.step}")
                if world.is_main and state.step % args.log_every_n_steps == 0:
                    log(state.step, **{f"train_{k}": float(v) for k, v in aux.items()})
                # a copy: the program's next replay overwrites its output
                epoch_losses.append(aux["loss"].clone())
                if args.max_steps and state.step >= args.max_steps:
                    break
            train_loss = float(torch.stack(epoch_losses).mean()) if epoch_losses else math.nan

            # validation over every file with the EMA weights, cast once per
            # batch to the compute dtype; the short last batch is padded and
            # its rows masked by global row index, the sum is taken on the
            # device (across the processes) and read once, and the mean keeps
            # the scale of the model's batch reduction (a sum for StoRM,
            # train.py:548-575). Then the evaluation enhances with them
            # (model.py:605-622), on process 0; a failure is printed and
            # logged as NaN, and training goes on
            model.eval()
            gen = seeded_generator(device, args.seed, epoch, 1)
            v_sum, v_count = torch.zeros((), device=device), 0
            pesq = si_sdr = estoi = math.nan
            rows = args.batch_size // world.size
            row_ids = world.rank * rows + np.arange(rows)
            with swapped_in(model, state.ema):
                for bi, (bx, by) in enumerate(dm.val_dataloader()):
                    if bx.shape[0] < rows:  # one process's short last batch
                        widths = [(0, rows - bx.shape[0])] + [(0, 0)] * (bx.ndim - 1)
                        bx, by = np.pad(bx, widths), np.pad(by, widths)
                    mask = row_ids < min(args.batch_size, len(dm.valid_set) - bi * args.batch_size)
                    # a new tensor: the program's next replay overwrites its output
                    v_sum = v_sum + programs.validate((bx, by, mask), gen)
                    v_count += int(mask.sum())
                if world.size > 1:
                    total = all_reduce_(torch.stack([v_sum, v_sum.new_tensor(v_count)]), world)
                    v_sum, v_count = total[0], int(total[1])
                if args.num_eval_files and world.is_main:
                    eval_kwargs = {"N": args.eval_N} if args.eval_N else {}
                    # audio and spectrograms every VIS_EPOCHS epochs, where
                    # a TensorBoard writer imports (model.py:20, 624-641)
                    visualize = writer is not None and epoch % VIS_EPOCHS == 0
                    try:
                        pesq, si_sdr, estoi, spec, audio = evaluate_model(
                            model, dm.valid_set, args.num_eval_files, spec=visualize,
                            audio=visualize, **eval_kwargs)
                        print(f"PESQ at epoch {epoch} : {pesq:.2f}")
                        print(f"SISDR at epoch {epoch} : {si_sdr:.1f}")
                        print(f"ESTOI at epoch {epoch} : {estoi:.2f}", flush=True)
                        if visualize:
                            log_examples(writer, epoch, spec, audio)
                    except Exception as e:  # the evaluation must not end the training
                        print(f"eval failed at epoch {epoch}: {e}", flush=True)
                        traceback.print_exc()
            valid_loss = float(v_sum) / v_count if v_count else math.nan
            if model.batch_reduction == "sum":
                valid_loss *= args.batch_size
            # process 0 evaluated: every process waits for it and takes its numbers
            valid_loss, pesq, si_sdr, estoi = world.agree((valid_loss, pesq, si_sdr, estoi))

            say(f"epoch {epoch}: train_loss={train_loss:.4f} valid_loss={valid_loss:.4f} "
                  f"step={state.step} ({time.time() - t_start:.0f}s)", flush=True)
            log(state.step, train_loss_epoch=train_loss, valid_loss=valid_loss,
                ValidationPESQ=pesq, ValidationSISDR=si_sdr, ValidationESTOI=estoi)
            if valid_loss < best_valid:
                best_valid, bad_epochs = valid_loss, 0
            else:
                bad_epochs += 1
            if ckpt_mgr is not None:
                ckpt_mgr.step(state, valid_loss=valid_loss, epoch=epoch,
                              bad_epochs=bad_epochs, best_valid=best_valid, pesq=pesq,
                              estoi=estoi)
            if bad_epochs >= args.patience:
                say(f"early stopping at epoch {epoch}")
                break
            if args.max_steps and state.step >= args.max_steps:
                break
        if ckpt_mgr is not None:
            ckpt_mgr.wait()  # the last save lands before the run ends
    finally:
        if ckpt_mgr is not None:
            ckpt_mgr.close()
        if metrics_file is not None:
            metrics_file.close()
        if writer is not None:
            writer.close()
    say("training done.")


def log_examples(writer, epoch: int, spec, audio, sr: int = 16000) -> None:
    """The evaluation's examples to TensorBoard, as the reference logs
    them: the mixture and clean audio at epoch 0, the estimate every time,
    and, where matplotlib imports, each example's three-panel spectrogram
    figure."""
    from .utils.graphics import visualize_example

    for idx, (yv, xh, xv) in enumerate(zip(*audio)):
        if epoch == 0:
            writer.add_audio(f"Epoch={epoch} Mix/{idx}", yv / (np.abs(yv).max() + 1e-9),
                             epoch, sr)
            writer.add_audio(f"Epoch={epoch} Clean/{idx}", xv / (np.abs(xv).max() + 1e-9),
                             epoch, sr)
        writer.add_audio(f"Epoch={epoch} Estimate/{idx}", xh / (np.abs(xh).max() + 1e-9),
                         epoch, sr)
    if importlib.util.find_spec("matplotlib") is None:
        return
    for idx, (ys, xs, cs) in enumerate(zip(*spec)):
        writer.add_figure(f"Epoch={epoch}/Spec/{idx}", visualize_example(ys, xs, cs,
                                                                         return_fig=True))


if __name__ == "__main__":
    use_expandable_segments()
    main()
