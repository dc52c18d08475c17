"""The trainer's programs (storm_tpu_torch/utils/train_graphs.py) on the CPU,
where a program's later calls run its body eagerly on its static buffers:
every piece of a captured training step and validation batch but the
capture itself.

A key's first call runs the eager step, its second makes the program (on a
card: the warm-up and the capture) and later calls fill the static batch
and random inputs and run the program. Each step equals `train_step` from
the same generator state bit for bit (parameters, EMA, Adam's moments and
step counts, losses), for StoRM, score-only, denoiser-only (sisdr) and the
distilled student; a program's step holds the JAX package's
`make_train_step` at test_torch_score's tolerances (1e-6; 2 lr where Adam
steps by the sign of a gradient that is rounding noise); the device-count
EMA equals JAX's `ema_update` bit for bit; Adam's state made at
`init_train_state` steps as Adam's own lazily made state. Through the CLI: the epoch's
mean loss and the validation loss (a ragged last batch, padded and masked)
equal the eager loop's bit for bit, which pins the outputs a replay
overwrites; two epochs equal one epoch and a resume from `last.pt`.

Tiny nets (nf 16, three levels; the CLI's nf 8), n_fft 62, hop 16, B=2
crops of 32 frames (496 samples).
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import random_params, to_numpy_tree

from storm_tpu.models.base import ema_update as jema_update
from storm_tpu.models.base import init_train_state as jinit_state
from storm_tpu.models.base import make_optimizer as jmake_optimizer
from storm_tpu.models.base import wav_to_spec as jwav_to_spec
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.signal import cplx as jcplx
from storm_tpu_torch import train
from storm_tpu_torch.ckpt import load_training_checkpoint
from storm_tpu_torch.convert import params_from_jax
from storm_tpu_torch.models.base import ema_update, init_train_state, wav_to_spec
from storm_tpu_torch.models.factory import build_model
from storm_tpu_torch.utils.train_graphs import TrainPrograms

from test_torch_train import TRAIN_ARGS, _run, _write_corpus

TINY = {"nf": 16, "ch_mult": [1, 2, 2], "init_scale": 1.0, "n_fft": 62, "hop_length": 16,
        "sde": "ouve"}
B, F, FRAMES = 2, 32, 32
SAMPLES = (FRAMES - 1) * 16
MODES = {
    "storm": dict(mode="regen-joint-training"),
    "score-only": dict(mode="score-only"),
    "denoiser-only-sisdr": dict(mode="denoiser-only", loss_type="sisdr"),
    "distill": dict(mode="distill", distill_N=2, distill_method="etd2"),
}


def wav_batch(seed: int):
    """(clean, noisy) float32 waves (B, SAMPLES)."""
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(200, 900, (B, 1)) * np.arange(SAMPLES) / 16000)
    y = x + 0.05 * rng.standard_normal((B, SAMPLES))
    return x.astype(np.float32), y.astype(np.float32)


def tiny(name: str):
    """A tiny model of MODES[name] in training mode (a distilled student is
    taught by a StoRM of another seed)."""
    model = build_model(dict(TINY, **MODES[name]), device="cpu", seed=0).train()
    if name == "distill":
        teacher = build_model(dict(TINY), device="cpu", seed=1).score_net.state_dict()
        model.with_teacher(teacher)
    return model


def gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def state_tensors(state):
    """Everything a step changes, by name."""
    out = {f"param {k}": v for k, v in state.model.state_dict().items()}
    out.update({f"ema {k}": v for k, v in state.ema.items()})
    for i, s in enumerate(state.optimizer.state.values()):
        out.update({f"adam {i} {k}": v for k, v in s.items()})
    out["device_step"] = state.device_step
    return out


def assert_states_equal(got, want):
    assert got.step == want.step
    g, w = state_tensors(got), state_tensors(want)
    assert g.keys() == w.keys()
    for k in w:
        assert torch.equal(g[k], w[k]), k


@pytest.mark.parametrize("name", list(MODES))
def test_program_steps_equal_train_step(name):
    """Four steps through the programs (the eager first call, the warm-up,
    two calls of the program's body on its static buffers) against four
    `train_step` calls on a copy of the model, from the same generator
    states: equal bit for bit, step by step. From the third call on, the
    losses are the program's static tensors, refilled in place."""
    ours, ref = tiny(name), tiny(name)
    state, ref_state = init_train_state(ours, ours.lr), init_train_state(ref, ref.lr)
    programs = TrainPrograms(state)
    statics = []
    for i in range(4):
        batch = wav_batch(i)
        aux = programs.step(batch, gen(10 + i))
        specs = tuple(wav_to_spec(torch.from_numpy(b), ref.stft_config, ref.transform)
                      for b in batch)
        want = ref.train_step(ref_state, specs, gen(10 + i))
        assert aux.keys() == want.keys()
        for k in want:
            assert torch.equal(aux[k], want[k]), (i, k)
        assert_states_equal(state, ref_state)
        statics.append(aux["loss"])
    assert statics[2] is statics[3] and statics[1] is not statics[2]
    assert state.step == 4 and int(state.device_step) == 4
    assert programs.execution == "graph"
    st = programs.stats
    assert (st["first_calls"], st["captures"], st["replays"], st["eager"]) == (1, 0, 2, 0)
    assert st["static_bytes"] > 0


def test_adam_state_made_at_init_equals_adams_own():
    """`init_train_state` makes Adam's state before any step (so that it is
    not carved out of a step's freed activations); two steps from it equal
    two steps of an Adam that makes its state itself, bit for bit."""
    from storm_tpu_torch.models.base import make_optimizer
    ours, ref = tiny("storm"), tiny("storm")
    state = init_train_state(ours, ours.lr)
    lazy = make_optimizer(ref, ref.lr)
    assert len(state.optimizer.state) == len(list(state.optimizer.param_groups[0]["params"]))
    assert not lazy.state
    for i in range(2):
        g = torch.Generator().manual_seed(i)
        for p, q in zip(ours.parameters(), ref.parameters()):
            if p.requires_grad:
                p.grad = torch.randn(p.shape, generator=g)
                q.grad = p.grad.clone()
        state.optimizer.step()
        lazy.step()
    for p, q in zip(ours.parameters(), ref.parameters()):
        assert torch.equal(p, q)
    for a, b in zip(state.optimizer.state.values(), lazy.state.values()):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in b)


def test_program_key_separates_what_changes_the_step():
    """A batch of another shape and a changed learning rate make new
    programs; the eager reference (graphs=False) and debug_nans keep none
    and say so."""
    model = tiny("storm")
    state = init_train_state(model, model.lr)
    programs = TrainPrograms(state)
    one_row = tuple(b[:1] for b in wav_batch(0))
    for batch in (wav_batch(0), wav_batch(1), one_row, one_row):
        programs.step(batch, gen(0))
    assert len(programs.programs) == len(programs.seen) == 2
    state.optimizer.param_groups[0]["lr"] = 2e-4
    programs.step(wav_batch(2), gen(0))
    assert len(programs.seen) == 3
    for kw, execution in ((dict(graphs=False), "eager"), (dict(debug_nans=True),
                                                           "eager: debug_nans")):
        eager = TrainPrograms(state, **kw)
        for _ in range(3):
            eager.step(wav_batch(0), gen(0))
        assert eager.execution == execution and not eager.programs
        assert eager.stats["eager"] == 3


def test_moved_storage_drops_the_programs():
    """An EMA tensor in new storage (a program reads it in place) drops
    every program; the next call makes them anew and still equals the
    eager step."""
    ours, ref = tiny("storm"), tiny("storm")
    state, ref_state = init_train_state(ours, ours.lr), init_train_state(ref, ref.lr)
    programs = TrainPrograms(state)
    for i in range(6):
        if i == 3:
            for s in (state, ref_state):
                k = next(iter(s.ema))
                s.ema[k] = s.ema[k].clone()
        batch = wav_batch(i)
        programs.step(batch, gen(i))
        ref.train_step(ref_state, tuple(wav_to_spec(torch.from_numpy(b), ref.stft_config,
                                                    ref.transform) for b in batch), gen(i))
        assert_states_equal(state, ref_state)
    assert programs.stats["invalidated"] == 1 and len(programs.programs) == 1


def _jax_models(cfg, seed=0):
    """The reference model and the port's with the same random weights."""
    jmodel = jbuild(dict(cfg))
    params = random_params(jax.eval_shape(
        lambda: jmodel.init_params(jax.random.PRNGKey(0), (B, F, FRAMES))), seed)
    pmodel = build_model(dict(cfg), device="cpu").train()
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    return jmodel, params, pmodel


def test_program_step_matches_reference():
    """The program's step (its third call: the body on the static buffers,
    with the reference's t and z written into the draw buffers) from the
    starting weights, against one step of the reference's jitted
    `make_train_step` on the reference's STFT of the same waves, key split
    three ways as its `loss_fn` splits it. Before it, two steps make the
    program; the state is then set back in place to the start."""
    jmodel, params, pmodel = _jax_models(dict(TINY, mode="regen-joint-training"))
    x, y = wav_batch(5)
    key = jax.random.PRNGKey(9)
    jspec = tuple(jwav_to_spec(jnp.asarray(w), jmodel.stft_config, jmodel.transform)
                  for w in (x, y))
    jstate, jaux = jmodel.make_train_step(donate=False)(
        jinit_state(params, jmake_optimizer(jmodel.lr)), jspec, key)
    kt, kz, _ = jax.random.split(key, 3)
    t = jax.random.uniform(kt, (B,), jnp.float32) * (jmodel.sde.T - jmodel.t_eps) + jmodel.t_eps
    z = jcplx.complex_normal(kz, jspec[0].shape[:-1])

    state = init_train_state(pmodel, pmodel.lr)
    start = {k: v.clone() for k, v in state_tensors(state).items()}
    programs = TrainPrograms(state)
    for i in range(2):
        programs.step(wav_batch(i), gen(i))
    for k, v in state_tensors(state).items():  # back to the start, in place
        v.copy_(start[k] if k in start else torch.zeros_like(v))
    state.step = 0
    real_draw = pmodel.draw_step
    pmodel.draw_step = lambda batch, generator: (torch.from_numpy(np.array(t)),
                                                 torch.from_numpy(np.array(z)))
    try:
        aux = programs.step((x, y), gen(0))
    finally:
        pmodel.draw_step = real_draw
    assert programs.stats["replays"] == 1
    grads = {n: p.grad.clone() for n, p in pmodel.named_parameters() if p.requires_grad}
    floor = 1e-5 * max(float(g.abs().max()) for g in grads.values())
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    assert state.step == int(jstate.step) == 1
    for got, want in ((pmodel.state_dict(), jstate.params), (state.ema, jstate.ema_params)):
        want = params_from_jax(to_numpy_tree(want), target=pmodel)
        for name, w in want.items():
            err = (got[name] - w).abs()
            g = grads.get(name)
            noise = g.abs() <= floor if g is not None else torch.zeros_like(err, dtype=bool)
            if bool((~noise).any()):
                assert float(err[~noise].max()) <= 1e-6, name
            if bool(noise.any()):
                assert float(err[noise].max()) <= 2 * pmodel.lr, name


def test_device_count_ema_equals_the_reference_bit_for_bit():
    """Steps 1-20 of the EMA from the device step count, chained, against
    the reference's jitted `ema_update` in float32: equal bit for bit (both
    round d*e inside a fused multiply-add), on tensors of odd sizes too."""
    rng = np.random.default_rng(0)
    shapes = {"a": (64, 33), "b": (7,), "c": (3, 5, 11), "d": (1000,)}
    e0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    jema = jax.jit(lambda e, p, s: jema_update(e, p, 0.999, s))
    je, pe = dict(e0), {k: torch.from_numpy(v.copy()) for k, v in e0.items()}
    for step in range(1, 21):
        p = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        je = jema(je, p, jnp.asarray(step, jnp.int32))
        ema_update(pe, {k: torch.from_numpy(v) for k, v in p.items()}, 0.999,
                   torch.tensor(step, dtype=torch.int32))
        for k in shapes:
            np.testing.assert_array_equal(pe[k].numpy(), np.asarray(je[k]), err_msg=f"{step} {k}")


CLI = TRAIN_ARGS[:-2] + ["--log_every_n_steps", "1", "--device", "cpu", "--seed", "3"]


def _rows(logs):
    return [json.loads(line) for line in open(_run(logs) / "metrics.jsonl")]


def test_loop_through_programs_equals_the_eager_loop_and_resumes(tmp_path):
    """Three steps an epoch (the third replays) and three validation
    batches (2, 2 and a ragged 1, padded and masked; the third replays),
    two epochs: through the programs and eagerly (`TrainPrograms(graphs=
    False)`), every logged loss, the epoch's mean and the validation loss
    equal bit for bit. One epoch and a resume from its `last.pt` to the second equal
    the two epochs in one run, bit for bit (parameters, EMA, Adam)."""
    root = _write_corpus(tmp_path / "corpus", n_train=6, n_valid=5)
    base = CLI + ["--base_dir", root, "--max_epochs", "2"]
    graphed, eager, split = tmp_path / "graphed", tmp_path / "eager", tmp_path / "split"
    train.main(base + ["--log_dir", str(graphed)])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train, "TrainPrograms", functools.partial(TrainPrograms, graphs=False))
        train.main(base + ["--log_dir", str(eager)])
    got, want = _rows(graphed), _rows(eager)
    assert got == want
    epochs = [r for r in got if "valid_loss" in r]
    assert [r["step"] for r in epochs] == [3, 6]
    assert len({r["train_loss"] for r in got if "train_loss" in r}) == 6
    steps = [r["train_loss"] for r in got if "train_loss" in r]
    assert epochs[0]["train_loss_epoch"] == pytest.approx(np.mean(steps[:3]), rel=1e-6)

    train.main(CLI + ["--base_dir", root, "--max_epochs", "1", "--log_dir", str(split)])
    ckpts = _run(split) / "checkpoints"
    train.main(base + ["--log_dir", str(split), "--resume_from_checkpoint",
                       str(ckpts / "last.pt")])
    got = load_training_checkpoint(str(ckpts / "last.pt"))
    want = load_training_checkpoint(str(_run(graphed) / "checkpoints" / "last.pt"))
    assert got["step"] == want["step"] == 6 and got["meta"] == want["meta"]
    for key in ("params", "ema_params"):
        for name, w in want[key].items():
            assert torch.equal(got[key][name], w), (key, name)
    for sg, sw in zip(got["optimizer"]["state"].values(), want["optimizer"]["state"].values()):
        assert all(torch.equal(sg[k], sw[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert _rows(split)[-1] == _rows(graphed)[-1]


def test_debug_nans_runs_eagerly_and_says_so(tmp_path, capsys):
    root = _write_corpus(tmp_path / "corpus", n_train=2, n_valid=1)
    train.main(CLI + ["--base_dir", root, "--max_steps", "1", "--log_dir", str(tmp_path / "a"),
                      "--debug_nans"])
    assert "training steps and validation: eager: debug_nans" in capsys.readouterr().out
    train.main(CLI + ["--base_dir", root, "--max_steps", "1", "--log_dir", str(tmp_path / "b")])
    assert "training steps and validation: graph" in capsys.readouterr().out


def test_entry_points_ask_for_expandable_segments(monkeypatch):
    """The training CLI and the bench ask for PyTorch's expandable segments
    before they allocate on a card, unless the caller chose a setting."""
    from storm_tpu_torch.utils.train_graphs import ALLOC_CONF, use_expandable_segments
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    use_expandable_segments()
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == ALLOC_CONF == "expandable_segments:True"
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "max_split_size_mb:128")
    use_expandable_segments()
    assert os.environ["PYTORCH_CUDA_ALLOC_CONF"] == "max_split_size_mb:128"
    for module in ("train", "bench"):
        src = open(os.path.join(os.path.dirname(train.__file__), f"{module}.py")).read()
        assert 'if __name__ == "__main__":\n    use_expandable_segments()\n    main()' in src
