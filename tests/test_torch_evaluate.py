"""The port's test-set evaluation against the reference's: the metrics of
utils/metrics.py, the data module's test stage and the TIMIT transcripts,
graphics.py's dB magnitude, `evaluate_model`'s spectrogram and audio lists,
and `python -m storm_tpu_torch.evaluate` on a tiny checkpoint on the CPU.

Inputs are made with numpy from a seed. Tolerances: numpy metrics equal to
1e-12 relative (the same float64 operations); the STFT-based LSD 1e-5
relative (float32 DFT products in another order); the enhanced audio and
its spectrograms 1e-4 of their scale (the tiny StoRM of
test_torch_inference through two sampler steps, as there), and the
metrics of that audio 1e-3 relative; file lists, transcripts and raw items
exact. The CLI parsers are compared with the
reference CLIs' own parsers, captured as they parse.
"""
import argparse
import csv
import importlib.util
import os
import re
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from test_torch_inference import STORM_TINY, jax_chunk_noise, tiny_storm_pair
from torch_parity import ReplayNoise, assert_close_rel

from storm_tpu.data import datamodule as jdm
from storm_tpu.data import datasets as jds
from storm_tpu.utils import graphics as jgraphics
from storm_tpu.utils import metrics as jm
from storm_tpu.utils.inference import evaluate_model as jevaluate_model
from storm_tpu_torch import enhancement, evaluate, serve
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.data import datamodule as pdm
from storm_tpu_torch.data import datasets as pds
from storm_tpu_torch.data.audio import save_wav
from storm_tpu_torch.utils import graphics as pgraphics
from storm_tpu_torch.utils import metrics as pm
from storm_tpu_torch.utils.inference import evaluate_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 32  # frequency bins at n_fft 62
TEXTS = ["the cat sat now", "a dog ran fast", "she had your dark suit"]


def _signals(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    s = np.sin(2 * np.pi * 220 * np.arange(n) / 16000) + 0.1 * rng.standard_normal(n)
    noise = rng.standard_normal(n)
    return s, s + 0.3 * noise + 0.05 * rng.standard_normal(n), noise


# --- metrics


def test_energy_ratios_and_components_match_reference():
    s, s_hat, n = _signals(0)
    for got, want in zip(pm.si_sdr_components(s_hat, s, n), jm.si_sdr_components(s_hat, s, n)):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(pm.energy_ratios(s_hat, s, n), jm.energy_ratios(s_hat, s, n),
                               rtol=1e-12)
    assert pm.si_sdr(s, s_hat) == jm.si_sdr(s, s_hat)


def test_snr_helpers_hp_filter_and_align_match_reference():
    s, s_hat, n = _signals(1)
    assert pm.snr_dB(s, n) == pytest.approx(jm.snr_dB(s, n), rel=1e-12)
    assert pm.snr_scale_factor(s, n, 5.0) == pytest.approx(jm.snr_scale_factor(s, n, 5.0),
                                                           rel=1e-12)
    np.testing.assert_allclose(pm.hp_filter(s_hat), jm.hp_filter(s_hat), rtol=1e-12)
    shifted = np.roll(s, 37)
    got = pm.align(shifted, s)
    np.testing.assert_array_equal(got, jm.align(shifted, s))
    np.testing.assert_array_equal(got, s)


def test_lsd_matches_reference():
    s, s_hat, _ = _signals(2)
    got, want = pm.lsd(s_hat, s), jm.lsd(s_hat, s)
    assert got == pytest.approx(want, rel=1e-5) and got > 0


@pytest.mark.parametrize("ref,hyp", [
    ("the cat sat", "the cat sat"), ("the cat sat", "a cat sat down"),
    ("a b c d", "x y z w"), ("one", ""), ("a b", "a c b d e")])
def test_wer_matches_reference(ref, hyp):
    assert pm.wer(ref.split(), hyp.split()) == jm.wer(ref.split(), hyp.split())


def test_confidence_intervals_and_method_match_reference():
    data = np.random.default_rng(3).standard_normal(9)
    np.testing.assert_allclose(pm.mean_conf_int(data), jm.mean_conf_int(data), rtol=1e-12)
    with_nan = np.concatenate([data, [np.nan]])
    np.testing.assert_allclose(pm.mean_std(with_nan), jm.mean_std(with_nan), rtol=1e-12)
    pmeth, jmeth = (m.Method("storm", "/d", ["si_sdr", "wer"]) for m in (pm, jm))
    for v in data:
        pmeth.append("si_sdr", v)
        jmeth.append("si_sdr", v)
    np.testing.assert_allclose(pmeth.get_mean_ci("si_sdr"), jmeth.get_mean_ci("si_sdr"),
                               rtol=1e-12)
    assert pmeth.metrics["wer"] == [] and (pmeth.name, pmeth.base_dir) == ("storm", "/d")


def test_pydub_read_without_pydub_raises_as_reference(tmp_path):
    if importlib.util.find_spec("pydub") is not None:
        pytest.skip("pydub is installed")
    for mod in (pm, jm):
        with pytest.raises(ImportError, match="pydub is not installed"):
            mod.pydub_read(str(tmp_path / "x.mp3"))


# --- graphics


def test_mag_db_matches_reference():
    rng = np.random.default_rng(4)
    packed = rng.standard_normal((16, 20, 2)).astype(np.float32)
    np.testing.assert_array_equal(pgraphics._mag_db(packed), jgraphics._mag_db(packed))
    cplx = packed[..., 0] + 1j * packed[..., 1]
    np.testing.assert_array_equal(pgraphics._mag_db(cplx), jgraphics._mag_db(cplx))
    assert pgraphics._mag_db(packed).min() >= -60 and pgraphics._mag_db(packed).max() == 0


def test_visualize_example_draws_three_panels(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    rng = np.random.default_rng(5)
    specs = [rng.standard_normal((16, 20, 2)) for _ in range(3)]
    fig = pgraphics.visualize_example(*specs, return_fig=True)
    assert [ax.get_title() for ax in fig.axes[:3]] == ["Mixture", "Estimate", "Target"]
    pgraphics.visualize_one(specs[0], name=str(tmp_path / "one"))
    assert os.path.exists(tmp_path / "one.png")


# --- data: the test stage and the transcripts


def _write_pairs(root, lengths, seed=0):
    rng = np.random.default_rng(seed)
    for kind in ("clean", "noisy"):
        os.makedirs(os.path.join(root, kind), exist_ok=True)
    for i, n in enumerate(lengths):
        x = (0.3 * np.sin(2 * np.pi * 300 * (i + 1) * np.arange(n) / 16000)).astype(np.float32)
        save_wav(os.path.join(root, "clean", f"u{i}.wav"), x)
        save_wav(os.path.join(root, "noisy", f"u{i}.wav"),
                 (x + 0.05 * rng.standard_normal(n)).astype(np.float32))


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """A wsj0 layout (tr, cv, tt) and a timit layout with transcripts."""
    wsj0 = str(tmp_path_factory.mktemp("wsj0"))
    for sub, lengths in (("tr", [3000, 3200]), ("cv", [7000, 7100]),
                         ("tt", [6600, 9000, 7000])):
        _write_pairs(os.path.join(wsj0, sub), lengths, seed=len(sub))
    timit = str(tmp_path_factory.mktemp("timit"))
    _write_pairs(os.path.join(timit, "audio", "tt"), [6600, 7000, 9000], seed=9)
    os.makedirs(os.path.join(timit, "transcriptions", "tt"))
    for i, text in enumerate(TEXTS):
        with open(os.path.join(timit, "transcriptions", "tt", f"u{i}.txt"), "w") as f:
            f.write(f"0 {6600 + i} {text}")  # TIMIT: two sample indices, then the words
    return wsj0, timit


def _same_items(pset, jset, n_fields):
    assert len(pset) == len(jset)
    assert pset.clean_files == jset.clean_files and pset.noisy_files == jset.noisy_files
    for i in range(len(pset)):
        for raw in (True, False):
            got, want = pset.__getitem__(i, raw=raw), jset.__getitem__(i, raw=raw)
            assert len(got) == len(want) == n_fields
            for g, w in zip(got, want):
                if isinstance(w, str):
                    assert g == w
                else:
                    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("layout", ["wsj0", "timit"])
def test_setup_test_matches_reference(corpora, layout):
    base = corpora[0] if layout == "wsj0" else corpora[1]
    pmod = pdm.SpecsDataModule(base_dir=base, format=layout, num_workers=1)
    jmod = jdm.SpecsDataModule(base_dir=base, format=layout, num_workers=1)
    pmod.setup("test")
    jmod.setup("test")
    assert pmod.train_set is None and len(pmod.test_set) == 3
    _same_items(pmod.test_set, jmod.test_set, 2)
    loader = pmod.test_dataloader()
    assert sum(b[0].shape[0] for b in loader) == 3
    if layout == "wsj0":
        pmod.setup(None)  # all three stages
        assert len(pmod.train_set) == 2 and len(pmod.valid_set) == 2


def test_specs_and_transcriptions_match_reference(corpora):
    timit = corpora[1]
    pmod = pdm.SpecsAndTranscriptionsDataModule(base_dir=timit, format="timit")
    jmod = jdm.SpecsAndTranscriptionsDataModule(base_dir=timit, format="timit")
    pmod.setup("test")
    jmod.setup("test")
    assert pmod.test_set.transcriptions == jmod.test_set.transcriptions
    _same_items(pmod.test_set, jmod.test_set, 3)
    assert [pmod.test_set.__getitem__(i, raw=True)[2] for i in range(3)] == TEXTS
    with pytest.raises(NotImplementedError):
        pmod.setup("fit")
    ds = pds.SpecsAndTranscriptions(timit, "test", dummy=True)
    assert len(ds) == len(jds.SpecsAndTranscriptions(timit, "test", dummy=True)) == 0


# --- evaluate_model's lists


@pytest.fixture(scope="module")
def pair():
    return tiny_storm_pair(seed=6)


def test_evaluate_model_lists_match_reference(pair, corpora):
    """Two validation files of one bucket enhanced in one chunk of two rows,
    with the reference's noise: the metrics, and the spectrogram and audio
    lists (noisy, enhanced, clean) the trainer logs."""
    jmodel, params, pmodel = pair
    base = corpora[0]
    N, key = 2, jax.random.PRNGKey(0)
    jset = jds.Specs(base, "valid", format="wsj0")
    pset = pds.Specs(base, "valid", format="wsj0")
    want = jevaluate_model(jmodel, params, jset, 2, key=key, spec=True, audio=True,
                           minibatch=2, N=N)
    group_key = jax.random.split(key)[1]
    noise = ReplayNoise(jax_chunk_noise(group_key, [(2, F, 512)], N, corrector="none"))
    got = evaluate_model(pmodel, pset, 2, noise=noise, spec=True, audio=True, minibatch=2, N=N)
    assert noise.exhausted()
    np.testing.assert_allclose(got[1:3], want[1:3], rtol=1e-3)  # SI-SDR, ESTOI
    assert np.isnan(got[0]) == np.isnan(want[0])
    for what, g_lists, w_lists, tol in (("spec", got[3], want[3], 1e-4),
                                        ("audio", got[4], want[4], 1e-4)):
        assert len(g_lists) == len(w_lists) == 3
        for name, g, w in zip(("noisy", "enhanced", "clean"), g_lists, w_lists):
            assert len(g) == len(w) == 2
            for a, b in zip(g, w):
                assert_close_rel(a, np.asarray(b), tol, f"{what} {name}")
    plain = evaluate_model(pmodel, pset, 2, minibatch=2, N=N)
    assert plain[3] is None and plain[4] is None


# --- the CLI


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory, pair):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pt")
    save_checkpoint(path, STORM_TINY, pair[2].state_dict())
    return path


def _evaluate(capsys, *argv):
    evaluate.main(["--device", "cpu", "--N", "2", "--corrector", "none", "--batch", "2",
                   *argv])
    return capsys.readouterr().out


@pytest.mark.parametrize("sampler", [["--sampler", "pc"], ["--sampler", "ode", "--ode-method",
                                                            "euler"]], ids=["pc", "ode"])
def test_cli_writes_rows_and_means(capsys, tmp_path, corpora, tiny_ckpt, sampler):
    out_csv = str(tmp_path / "rows.csv")
    text = _evaluate(capsys, "--ckpt", tiny_ckpt, "--mode", "storm", "--base_dir", corpora[0],
                     "--csv", out_csv, *sampler)
    rows = list(csv.DictReader(open(out_csv)))
    assert [r["file"] for r in rows] == ["u0.wav", "u1.wav", "u2.wav"]
    assert list(rows[0]) == ["file", "pesq", "si_sdr", "estoi"]
    assert all(np.isfinite(float(r["si_sdr"])) and np.isfinite(float(r["estoi"])) for r in rows)
    assert "evaluating 3 test files" in text and "--- mean +/- 95% CI ---" in text
    mean, h = pm.mean_conf_int([float(r["si_sdr"]) for r in rows])
    assert f"si_sdr: {mean:.3f} +/- {h:.3f}" in text
    for r in rows:
        assert f"{r['file']} pesq=" in text


def test_cli_rows_are_the_enhancers_outputs(capsys, corpora, tiny_ckpt, pair):
    """The CLI scores what BucketedEnhancer serves: the same grouping (by
    padded length, shortest bucket first, --batch rows a call) and the same
    generator give the same SI-SDR per file."""
    from storm_tpu_torch.utils.inference import BucketedEnhancer

    text = _evaluate(capsys, "--ckpt", tiny_ckpt, "--mode", "storm", "--base_dir", corpora[0],
                     "--sampler", "ode", "--ode-method", "etd2", "--num_files", "3")
    printed = dict(re.findall(r"^(u\d\.wav) pesq=\S+ si_sdr=(\S+)", text, re.M))
    pset = pds.Specs(corpora[0], "test", format="wsj0")
    enh = BucketedEnhancer(pair[2], minibatch=2, N=2, sampler_type="ode", method="etd2",
                           corrector="none")
    gen = torch.Generator().manual_seed(0)
    items = [pset.__getitem__(i, raw=True) for i in range(3)]
    groups = {}
    for i, (_, y) in enumerate(items):
        groups.setdefault(enh.padded_len(y.shape[-1]), []).append(i)
    for L, idxs in sorted(groups.items()):
        ys = np.stack([np.pad(items[i][1][0], (0, L - items[i][1].shape[-1])) for i in idxs])
        x_hats, _ = enh(ys, gen)
        for j, i in enumerate(idxs):
            want = pm.si_sdr(items[i][0][0], x_hats[j][: items[i][1].shape[-1]])
            assert printed[f"u{i}.wav"] == f"{want:.3f}", (i, want, printed)


def test_cli_wer_with_a_stub_asr(capsys, tmp_path, corpora, tiny_ckpt):
    """A stub ASR that always says TEXTS[1]: WER 0 on that file, 1 on
    TEXTS[0] (four words, four substitutions); the {wav} path is quoted."""
    asr = tmp_path / "asr dir" / "asr.sh"
    asr.parent.mkdir()
    asr.write_text(f"#!/bin/sh\ntest -f \"$1\" && echo '{TEXTS[1]}'\n")
    os.chmod(asr, 0o755)
    out_csv = str(tmp_path / "wer.csv")
    text = _evaluate(capsys, "--ckpt", tiny_ckpt, "--mode", "storm", "--base_dir", corpora[1],
                     "--format", "timit", "--wer", "--asr_cmd", f"'{asr}' {{wav}}",
                     "--csv", out_csv)
    rows = {r["file"]: r for r in csv.DictReader(open(out_csv))}
    assert float(rows["u1.wav"]["wer"]) == 0.0
    assert float(rows["u0.wav"]["wer"]) == 1.0
    assert "wer: " in text
    with pytest.raises(SystemExit, match="--wer requires --asr_cmd"):
        evaluate.main(["--ckpt", tiny_ckpt, "--mode", "storm", "--base_dir", corpora[1],
                       "--wer", "--device", "cpu"])


@pytest.mark.parametrize("mode", ["score-only", "denoiser-only", "distill"])
def test_cli_other_modes_raise(corpora, tiny_ckpt, mode):
    """score-only, denoiser-only and distill are served, but not from a StoRM
    checkpoint: the reference's message."""
    with pytest.raises(SystemExit, match=f"--mode {mode} incompatible with checkpoint mode "
                                         "regen-joint-training"):
        evaluate.main(["--ckpt", tiny_ckpt, "--mode", mode, "--base_dir", corpora[0],
                       "--device", "cpu"])


# --- the parsers against the reference CLIs'


class _Parsed(Exception):
    pass


def _reference_parser(script, argv):
    """The argparse parser a reference CLI builds, caught as it parses."""
    caught = {}

    def parse_args(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Parsed()

    spec = importlib.util.spec_from_file_location(f"reference_{script}",
                                                  os.path.join(REPO, f"{script}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with mock.patch.object(argparse.ArgumentParser, "parse_args", parse_args), \
            mock.patch("sys.argv", [script] + argv):
        with pytest.raises(_Parsed):
            module.build_argparser().parse_args() if hasattr(module, "build_argparser") \
                else module.main()
    return caught["parser"]


def _options(parser, names):
    actions = {a.dest: a for a in parser._actions}
    return {n: (actions[n].default, sorted(actions[n].choices or []), actions[n].option_strings)
            for n in names}


SAMPLER_FLAGS = {
    "enhancement": ["sampler", "predictor", "corrector", "corrector_steps", "snr", "N",
                    "ode_method", "rtol", "atol", "sweeps", "mode", "deepcache",
                    "deepcache_depth", "dtype"],
    "serve": ["sampler", "predictor", "corrector", "corrector_steps", "snr", "N", "ode_method",
              "mode", "deepcache", "deepcache_depth", "dtype"],
    "evaluate": ["sampler", "predictor", "corrector", "corrector_steps", "snr", "N",
                 "ode_method", "mode", "batch", "num_files", "format", "csv", "wer", "asr_cmd",
                 "seed", "quant", "quant_min_channels", "deepcache", "dtype"],
}


@pytest.mark.parametrize("script", sorted(SAMPLER_FLAGS))
def test_parsers_have_the_reference_sampler_flags(script):
    ours = {"enhancement": lambda: _port_parser(enhancement.parse_args),
            "serve": serve.build_argparser, "evaluate": evaluate.build_argparser}[script]()
    want = _options(_reference_parser(script, []), SAMPLER_FLAGS[script])
    assert _options(ours, SAMPLER_FLAGS[script]) == want


def _port_parser(parse):
    caught = {}

    def parse_args(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Parsed()

    with mock.patch.object(argparse.ArgumentParser, "parse_args", parse_args):
        with pytest.raises(_Parsed):
            parse([])
    return caught["parser"]


def test_trainer_logs_examples_as_the_reference():
    """The trainer's TensorBoard examples: mixture and clean audio at epoch
    0 only, the estimate every time, and one figure per example where
    matplotlib imports."""
    from storm_tpu_torch import train

    class Writer:
        def __init__(self):
            self.calls = []

        def add_audio(self, tag, value, step, sr):
            self.calls.append(("audio", tag, float(np.abs(value).max())))

        def add_figure(self, tag, fig):
            self.calls.append(("figure", tag))

    rng = np.random.default_rng(6)
    audio = [[rng.standard_normal(100) for _ in range(2)] for _ in range(3)]
    spec = [[rng.standard_normal((8, 10, 2)) for _ in range(2)] for _ in range(3)]
    figures = importlib.util.find_spec("matplotlib") is not None
    for epoch in (0, 5):
        w = Writer()
        train.log_examples(w, epoch, spec, audio)
        tags = [c[1] for c in w.calls]
        kinds = ["Mix", "Clean", "Estimate"] if epoch == 0 else ["Estimate"]
        assert tags[: 2 * len(kinds)] == [f"Epoch={epoch} {k}/{i}" for i in range(2)
                                          for k in kinds]
        assert all(c[2] == pytest.approx(1.0, abs=1e-6) for c in w.calls if c[0] == "audio")
        assert tags[2 * len(kinds):] == ([f"Epoch={epoch}/Spec/{i}" for i in range(2)]
                                         if figures else [])
