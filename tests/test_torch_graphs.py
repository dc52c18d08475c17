"""The captured enhancement programs (storm_tpu_torch/utils/graphs.py) on the
CPU, where a program's body runs eagerly on its static buffers: every piece
of a graph's serving call but the capture itself.

A shape's first call runs the eager loop and keeps no program; its second
makes the program (on a card: the warm-up and the capture), and later calls
run the program. Each call equals `model.enhance` from the same generator
state bit for bit (the same operations on the same numbers), for StoRM's pc + ald,
etd2 ODE, Picard, deep-feature caching and int8, and for the score-only,
denoiser-only and distilled models; one configuration is also held to the
JAX package's enhancer within test_torch_inference's tolerance (1e-4 of the
waveform's scale). The pre-drawn noise buffers hold the generator's draws
in the sampler's order, bit for bit; the cache key separates what changes a
program; swapped-in weights are served at the next call; outputs do not
alias; rk45 runs eagerly; `warm_up` makes a program at a shape's first
call; a program's static bytes are counted. Tiny nets (nf 16, three levels, n_fft 62, hop 16:
a bucket of 64 hops is 1024 samples).
"""
import jax
import numpy as np
import pytest
import torch
from torch_parity import ReplayNoise, assert_close_rel, jax_noise_schedule

from storm_tpu.utils.inference import BucketedEnhancer as JBucketed
from storm_tpu_torch.models.base import swapped_in
from storm_tpu_torch.models.distill import DistilledModel
from storm_tpu_torch.models.factory import build_model
from storm_tpu_torch.nn.qconv import quantizable_convs
from storm_tpu_torch.sampling import samplers
from storm_tpu_torch.utils import graphs
from storm_tpu_torch.utils.inference import BucketedEnhancer

from test_torch_inference import F, frames, tiny_storm_pair, wave

TINY = {"nf": 16, "ch_mult": [1, 2, 2], "init_scale": 1.0, "n_fft": 62, "hop_length": 16,
        "sde": "ouve"}
N = 2


def tiny(mode="regen-joint-training", seed=0):
    return build_model(dict(TINY, mode=mode), device="cpu", seed=seed)


@pytest.fixture(scope="module")
def storm():
    return tiny()


def waves(rows=2, T=1500, seed=0):
    return np.stack([wave(T, seed + i) for i in range(rows)])


def all_int8(model):
    """A scale of 0.5 on every quantizable conv of each net with 16 or more
    input and output channels (the card's int8 product needs multiples of 8)."""
    per_net = {n: {name: 0.5 for name, m in quantizable_convs(getattr(model, n)).items()
                   if m.in_channels >= 16 and m.out_channels >= 16}
               for n in model.NETS}
    return per_net["dnn"] if model.NETS == ("dnn",) else {
        "denoiser": per_net["denoiser_net"], "score": per_net["score_net"]}


def gen(seed):
    return torch.Generator().manual_seed(seed)


def assert_program_equals_eager(model, y, seeds=(0, 1, 2), **kw):
    """Calls through the programs (the first runs the eager loop, the
    second records, the later ones run the body on the static buffers)
    equal the eager loop bit for bit."""
    eager = BucketedEnhancer(model, graphs=False, **kw)
    graphed = BucketedEnhancer(model, **kw)
    for seed in seeds:
        want, nfe = eager(y, gen(seed))
        got, gnfe = graphed(y, gen(seed))
        assert gnfe == nfe
        np.testing.assert_array_equal(got, want)


STORM_CONFIGS = {
    "pc-ald": dict(N=N, corrector="ald"),
    "ode-etd2": dict(N=N, sampler_type="ode", method="etd2"),
    "picard": dict(N=N, sampler_type="picard", sweeps=2),
    "dc3": dict(N=4, corrector="ald", deepcache=3),
}


@pytest.mark.parametrize("name", sorted(STORM_CONFIGS))
def test_storm_program_equals_eager(storm, name):
    assert_program_equals_eager(storm, waves(), **STORM_CONFIGS[name])


def test_storm_int8_program_equals_eager(storm):
    assert_program_equals_eager(storm, waves(), N=N, corrector="ald", quant=all_int8(storm))


@pytest.mark.parametrize("mode,kw", [
    ("score-only", dict(N=N, corrector="ald")),
    ("score-only", dict(N=N, sampler_type="ode", method="etd2", quant="int8")),
    ("denoiser-only", dict()),
    ("denoiser-only", dict(quant="int8")),
], ids=["score-pc", "score-ode-int8", "denoiser", "denoiser-int8"])
def test_single_net_program_equals_eager(mode, kw):
    model = tiny(mode)
    if kw.get("quant") == "int8":
        kw = dict(kw, quant=all_int8(model))
    assert_program_equals_eager(model, waves(), **kw)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_distilled_program_equals_eager(storm, int8):
    model = DistilledModel(storm)
    assert_program_equals_eager(model, waves(), quant=all_int8(model) if int8 else None)


def test_bf16_program_equals_eager():
    model = build_model(dict(TINY, mode="regen-joint-training", dtype="bfloat16"),
                        device="cpu", seed=1)
    assert_program_equals_eager(model, waves(1), N=N, corrector="ald")


def test_program_matches_the_reference_enhancer():
    """Every call (the eager loop, the program's first run, the body on
    the static buffers; JAX's draws injected) against JAX's
    BucketedEnhancer, as test_b1_matches_reference."""
    jmodel, params, pmodel = tiny_storm_pair(seed=5)
    y, T = wave(1500, 1), 1500
    enhancer = BucketedEnhancer(pmodel, N=N, corrector="ald")
    for i, seed in enumerate((2, 3, 4)):
        key = jax.random.PRNGKey(seed)
        want, nfe = JBucketed(jmodel, params, N=N, corrector="ald")(y, key)
        noise = ReplayNoise(jax_noise_schedule(key, (1, F, frames(2048)), N))
        got, pnfe = enhancer(y, noise=noise)
        assert noise.exhausted() and got.shape == (T,) and pnfe == int(nfe)
        assert_close_rel(got, np.asarray(want), 1e-4, f"call {i}")
    assert graphs.programs_of(pmodel).stats["replays"] == 1


def test_noise_buffers_hold_the_generator_draws_in_order(storm):
    """The static buffers after a call hold exactly the draws the eager
    loop takes from the same generator state, in its order: the prior, then
    per step the corrector's and the predictor's."""
    y = torch.from_numpy(waves(2, 2048))
    for seed in (0, 1):  # the eager loop, then the program's first run
        graphs.graphed_enhance(storm, y, gen(seed), N=3, corrector="ald")
    prog, = [p for p in graphs.programs_of(storm).programs.values()
             if p.key == graphs.program_key(storm, y, dict(N=3, corrector="ald"))]
    drawn = []
    real = samplers.generator_noise

    def watched(*args, **kwargs):
        draw = real(*args, **kwargs)
        return lambda shape: drawn.append(draw(shape)) or drawn[-1]

    samplers.generator_noise = watched
    try:
        storm.enhance(y, N=3, corrector="ald", generator=gen(7))
        graphs.graphed_enhance(storm, y, gen(7), N=3, corrector="ald")
    finally:
        samplers.generator_noise = real
    assert len(prog.noise) == 1 + 2 * 3
    assert len(drawn) == 2 * len(prog.noise)  # eager, then the program's fill
    for buf, want in zip(prog.noise, drawn):
        assert torch.equal(buf, want)


def test_injected_noise_fills_the_same_buffers(storm):
    """An injected source is drawn in the same order into the same buffers,
    and gives the eager loop's output with that source."""
    y = waves(1, 1000)
    shape = (1, F, frames(1024))
    rng = np.random.default_rng(0)
    draws = [rng.standard_normal(shape + (2,)).astype(np.float32) for _ in range(1 + 2 * N)]
    enhancer = BucketedEnhancer(storm, N=N, corrector="ald")
    enhancer.warm_up(y, gen(0))  # the program's first run, from a generator
    got, _ = enhancer(y, noise=ReplayNoise(draws))
    want, _ = BucketedEnhancer(storm, graphs=False, N=N, corrector="ald")(
        y, noise=ReplayNoise(draws))
    np.testing.assert_array_equal(got, want)
    prog = next(p for p in graphs.programs_of(storm).programs.values()
                if p.key[0] == (1, 1024) and dict(p.key[-1]) == dict(N=N, corrector="ald"))
    for buf, d in zip(prog.noise, draws):
        np.testing.assert_array_equal(buf.numpy(), d)


@pytest.mark.parametrize("change", ["rows", "width", "N", "sampler", "dtype", "scales"])
def test_the_key_separates_what_changes_a_program(change):
    model = tiny(seed=2)
    progs = graphs.programs_of(model)
    base = dict(N=N, corrector="ald")
    y = waves(2, 1000)
    for seed in (0, 1, 2):  # the eager loop, the program's first run, its reuse
        BucketedEnhancer(model, **base)(y, gen(seed))
    assert (len(progs.programs), progs.stats["replays"]) == (1, 1)
    kw = dict(base)
    if change == "rows":
        y = waves(1, 1000)
    elif change == "width":
        y = waves(2, 1500)
    elif change == "N":
        kw["N"] = N + 1
    elif change == "sampler":
        kw.update(sampler_type="ode", method="etd2")
    elif change == "dtype":
        model.score_net.dtype = torch.bfloat16
    else:
        kw["quant"] = all_int8(model)
        BucketedEnhancer(model, **kw).warm_up(y, gen(2))
        kw["quant"] = {k: {n: 0.25 for n in v} for k, v in kw["quant"].items()}
    BucketedEnhancer(model, **kw).warm_up(y, gen(2))
    assert len(progs.programs) == (3 if change == "scales" else 2)
    assert progs.stats["replays"] == 1


def test_weights_swapped_in_place_are_served(storm):
    """`swapped_in` copies weights into the parameters' storage: the next
    call of the same program serves them, and after the block the model's
    own again."""
    y = waves(1, 1000)
    enhancer = BucketedEnhancer(storm, N=N, corrector="ald")
    enhancer.warm_up(y, gen(0))
    own, _ = enhancer(y, gen(0))
    other = tiny(seed=9).state_dict()
    with swapped_in(storm, other):
        got, _ = enhancer(y, gen(0))
        want, _ = BucketedEnhancer(storm, graphs=False, N=N, corrector="ald")(y, gen(0))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, own)
    back, _ = enhancer(y, gen(0))
    np.testing.assert_array_equal(back, own)


def test_moved_parameters_drop_the_programs():
    model = tiny(seed=3)
    y = torch.from_numpy(waves(1, 1000))
    graphs.graphed_enhance(model, y, gen(0), N=N, warm_up=True)
    p = next(model.parameters())
    p.data = p.data.clone()  # new storage: a program would read the old
    got, _ = graphs.graphed_enhance(model, y, gen(1), N=N)
    want, _ = model.enhance(y, N=N, generator=gen(1))
    assert torch.equal(got, want)
    stats = graphs.programs_of(model).stats
    assert (stats["invalidated"], stats["replays"], stats["first_calls"]) == (1, 0, 0)
    assert len(graphs.programs_of(model).programs) == 1  # made anew at once


def test_outputs_of_two_calls_do_not_alias(storm):
    y = torch.from_numpy(waves(2, 1000))
    graphs.graphed_enhance(storm, y, gen(0), N=N, warm_up=True)
    a, _ = graphs.graphed_enhance(storm, y, gen(0), N=N)
    a_copy = a.clone()
    b, _ = graphs.graphed_enhance(storm, y, gen(1), N=N)
    assert a.data_ptr() != b.data_ptr()
    assert torch.equal(a, a_copy) and not torch.equal(a, b)


def test_enhance_async_returns_a_tensor_of_its_own(storm):
    enhancer = BucketedEnhancer(storm, N=N)
    y = waves(2, 1000)
    enhancer.warm_up(y, gen(0))
    a, _ = enhancer.enhance_async(y, gen(0))
    b, _ = enhancer.enhance_async(y, gen(0))
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)


def test_rk45_runs_eagerly_and_says_so(storm):
    kw = dict(N=N, sampler_type="ode", method="rk45", rtol=1e-2, atol=1e-2)
    enhancer = BucketedEnhancer(storm, **kw)
    assert enhancer.execution == "eager: rk45"
    assert BucketedEnhancer(storm, N=N).execution == "graph"
    assert BucketedEnhancer(storm, graphs=False, N=N).execution == "eager"
    before = graphs.programs_of(storm).stats["eager"]
    y = waves(1, 1000)
    got, nfe = enhancer(y, gen(0))
    want, wnfe = BucketedEnhancer(storm, graphs=False, **kw)(y, gen(0))
    np.testing.assert_array_equal(got, want)
    assert nfe == wnfe and graphs.programs_of(storm).stats["eager"] == before + 1


def test_a_shapes_first_call_runs_the_eager_loop_and_keeps_no_program():
    """A shape met once costs the eager loop and keeps only its key; its
    second call makes the program, its third runs it."""
    model = tiny(seed=4)
    progs = graphs.programs_of(model)
    y = torch.from_numpy(waves(1, 1000))
    counts = []
    for seed in (0, 1, 2):
        got, _ = graphs.graphed_enhance(model, y, gen(seed), N=N)
        want, _ = model.enhance(y, N=N, generator=gen(seed))
        assert torch.equal(got, want)
        counts.append((len(progs.programs), progs.stats["first_calls"],
                       progs.stats["replays"]))
    assert counts == [(0, 1, 0), (1, 1, 0), (1, 1, 1)]


def test_warm_up_makes_the_program_at_a_shapes_first_call(storm):
    enhancer = BucketedEnhancer(storm, N=N, corrector="ald")
    progs = graphs.programs_of(storm)
    y = waves(1, 3000)
    before = dict(progs.stats)
    enhancer.warm_up(y, gen(0))
    assert progs.stats["first_calls"] == before["first_calls"]
    got, _ = enhancer(y, gen(1))
    want, _ = BucketedEnhancer(storm, graphs=False, N=N, corrector="ald")(y, gen(1))
    np.testing.assert_array_equal(got, want)
    assert progs.stats["replays"] == before["replays"] + 1


def test_a_programs_static_buffers_are_counted():
    """The static input and the 1 + 2N noise buffers, outside the pool."""
    model = tiny(seed=6)
    y = torch.from_numpy(waves(2, 1024))
    graphs.graphed_enhance(model, y, gen(0), N=N, corrector="ald", warm_up=True)
    spec = 2 * F * frames(1024) * 2 * 4  # (rows, F, frames, re/im) float32
    want = y.numel() * 4 + (1 + 2 * N) * spec
    prog, = graphs.programs_of(model).programs.values()
    assert prog.static_bytes() == want
    assert graphs.programs_of(model).stats["static_bytes"] == want
