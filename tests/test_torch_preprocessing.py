"""The port's dataset creation (storm_tpu_torch/preprocessing/) against the
JAX package's (storm_tpu/preprocessing/ and the root preprocessing/ CLIs).

Each CLI of the JAX package runs in-process (`runpy.run_path`, `sys.argv`
patched) and the port's `main(argv)` runs on the same seeded tree of inputs;
the two must write the same file names and the same bytes. The library
functions are held to the JAX ones at float64, atol 0, and the port's WAV
reader to the JAX package's native decoder sample for sample.
"""
import os
import runpy
import shutil
import struct
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from storm_tpu.data.audio import load_wav as jload_wav
from storm_tpu.preprocessing import compressor as jcompressor
from storm_tpu.preprocessing import room as jroom
from storm_tpu.preprocessing import utils as jutils
from storm_tpu.preprocessing import wind as jwind
from storm_tpu_torch import preprocessing
from storm_tpu_torch.data.audio import load_wav
from storm_tpu_torch.preprocessing import (compressor, create_data, nonlinear_mixing, room,
                                           simulate_wind_noise, utils, wind)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
SPLITS = ("cv", "tr", "tt")
CHIME_TYPES = ("CAF", "PED", "STR", "BUS")


def _wav(path, x, sr=SR):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    wavfile.write(path, sr, (np.clip(x, -1, 1) * 32767).astype(np.int16))


def _signal(rng, seconds, sr=SR, channels=1):
    n = int(seconds * sr)
    t = np.arange(n) / sr
    x = 0.3 * np.sin(2 * np.pi * rng.uniform(100, 300) * t) * (1 + np.sin(2 * np.pi * 3 * t))
    x = x + 0.05 * rng.standard_normal((channels, n))
    return x[0] if channels == 1 else x.T


def write_tree(root, seed=0):
    """Speech per split (<root>/speech/<split>/*.wav, 0.4-0.6 s), wham-style
    noise per split (one file at 8 kHz, one stereo), CHiME-style CH1/CH2
    recordings of every noise type and a toy directory of plain WAVs."""
    rng = np.random.default_rng(seed)
    for split in SPLITS:
        for i in range(2):
            _wav(f"{root}/speech/{split}/s{i}.wav", _signal(rng, rng.uniform(0.4, 0.6)))
        _wav(f"{root}/wham/{split}/n0.wav", _signal(rng, 1.5))
        _wav(f"{root}/wham/{split}/n1.wav", _signal(rng, 1.5, sr=8000), sr=8000)
        _wav(f"{root}/wham/{split}/n2.wav", _signal(rng, 0.3, channels=2))
    for kind in CHIME_TYPES:
        for ch in (1, 2):
            _wav(f"{root}/chime/r_{kind}.CH{ch}.wav", _signal(rng, 1.2))
    for i in range(2):
        _wav(f"{root}/toy/t{i}.wav", _signal(rng, 1.0 + 0.5 * i))
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return write_tree(str(tmp_path_factory.mktemp("inputs")))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _run_reference_cli(name, argv):
    """preprocessing/<name>.py of the JAX package, in-process, as its CLI runs."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [name] + list(argv))
        runpy.run_path(os.path.join(REPO, "preprocessing", f"{name}.py"), run_name="__main__")


def assert_same_outputs(port, ref, min_wavs):
    """The same file names, every WAV byte for byte, log_stats.txt up to the
    output root (the directory above `port`); clean and noisy of a pair of
    one length."""
    names = _files(port)
    assert names == _files(ref)
    wavs = [n for n in names if n.endswith(".wav")]
    assert len(wavs) >= min_wavs, names
    for name in names:
        with open(os.path.join(port, name), "rb") as a, open(os.path.join(ref, name), "rb") as b:
            got, want = a.read(), b.read()
        if name.endswith("log_stats.txt"):  # it names the output root
            got = got.replace(os.path.dirname(port).encode(), b"ROOT")
            want = want.replace(os.path.dirname(ref).encode(), b"ROOT")
        assert got == want, name
    for name in wavs:
        if os.sep + "noisy" + os.sep in name:
            clean = name.replace(os.sep + "noisy" + os.sep, os.sep + "clean" + os.sep)
            if clean in names:
                assert load_wav(os.path.join(port, name))[0].shape == \
                    load_wav(os.path.join(port, clean))[0].shape, name
    return names


def _create_both(tmp_path, argv):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    create_data.main(["--root", port] + argv)
    _run_reference_cli("create_data", ["--root", ref] + argv)
    return port, ref


CREATE_CASES = {
    "enh_wham": (["--task", "enh", "--noise", "wham", "--noise_dir", "{tree}/wham/{{split}}"],
                 "dir_enh_wham", ("_snr=",)),
    "enh_chime": (["--task", "enh", "--noise", "chime", "--noise_dir", "{tree}/chime"],
                  "dir_enh_chime", ("_snr=",)),
    "enh_chime_toy_dir": (["--task", "enh", "--noise", "chime", "--noise_dir", "{tree}/toy"],
                          "dir_enh_chime", ("_snr=",)),
    "derev": (["--task", "derev", "--noise", "none"], "dir_derev", ("_t60=",)),
    "derev+enh": (["--task", "derev+enh", "--noise", "wham",
                   "--noise_dir", "{tree}/wham/{{split}}"], "dir_derev+enh", ("_t60=", "_snr=")),
    "bwe_polyphase": (["--task", "bwe", "--bwe-method", "polyphase"], "dir_bwe", ("_down=",)),
    "bwe_decimate": (["--task", "bwe", "--bwe-method", "decimate"], "dir_bwe", ("_down=",)),
}


@pytest.mark.parametrize("case", list(CREATE_CASES))
def test_create_data_writes_the_reference_bytes(tmp_path, tree, case):
    argv, out, tags = CREATE_CASES[case]
    argv = [a.format(tree=tree) for a in argv] + [
        "--speech", "dir", "--speech_dir", f"{tree}/speech", "--corruption-per-sample", "2"]
    port, ref = _create_both(tmp_path, argv)
    # cv and tr: 2 files x 2 corruptions; tt: one corruption; clean + noisy
    names = assert_same_outputs(os.path.join(port, out), os.path.join(ref, out), 2 * (4 + 4 + 2))
    noisy = [n for n in names if "noisy" in n]
    assert all(all(tag in n for tag in tags) for n in noisy), noisy
    assert os.path.join("audio", "tr", "noisy", "s1_3" + tags[0]) in "".join(noisy)


def test_create_data_dummy_keeps_five_files_of_one_split(tmp_path, tree):
    os.makedirs(tmp_path / "sp" / "tr")
    for i in range(7):
        shutil.copy(f"{tree}/speech/tr/s{i % 2}.wav", tmp_path / "sp" / "tr" / f"x{i}.wav")
    argv = ["--task", "bwe", "--speech", "dir", "--speech_dir", str(tmp_path / "sp"),
            "--splits", "tr", "--dummy"]
    port, ref = _create_both(tmp_path, argv)
    names = assert_same_outputs(os.path.join(port, "dir_bwe"), os.path.join(ref, "dir_bwe"), 10)
    assert len([n for n in names if n.endswith(".wav")]) == 10


def _layouts(root, tree):
    """wsj0, VCTK and TIMIT layouts under `root`, a file per directory."""
    src = f"{tree}/speech/tr/s0.wav"
    paths = [f"WSJ0/wsj0/{d}/spk/a.wav" for d in ("si_dt_05", "si_tr_s", "si_et_05")]
    for spk in ["p280", "p315"] + [f"p{400 + i}" for i in range(107)]:  # 107 kept
        paths.append(f"VCTK-Corpus/wav48/{spk}/{spk}_001.wav")
    for sdr, dr in (("train", 1), ("train", 7), ("test", 3)):
        paths.append(f"TIMIT/timit/{sdr}/dr{dr}/spk/sa1.wav")
    for p in paths:
        os.makedirs(os.path.dirname(os.path.join(root, p)), exist_ok=True)
        shutil.copy(src, os.path.join(root, p))
        if p.startswith("TIMIT"):
            with open(os.path.join(root, p[:-4] + ".txt"), "w") as f:
                f.write("0 1 she had your dark suit\n")


@pytest.mark.parametrize("speech", ["wsj0", "vctk", "timit"])
def test_speech_file_lists_of_each_layout(tmp_path, tree, speech):
    """The corpora's file lists as the JAX script finds them; TIMIT writes
    its transcriptions beside the audio."""
    ref_mod = runpy.run_path(os.path.join(REPO, "preprocessing", "create_data.py"))
    _layouts(str(tmp_path), tree)
    args = create_data.parse_args(["--task", "bwe", "--root", str(tmp_path), "--speech", speech])
    got = create_data.speech_file_lists(args, list(SPLITS))
    assert got == ref_mod["speech_file_lists"](args, list(SPLITS))
    assert sum(len(v) for v in got[0].values()) >= 3
    if speech == "timit":
        argv = ["--task", "bwe", "--speech", "timit"]
        port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
        for r in (port, ref):
            _layouts(r, tree)
        create_data.main(["--root", port] + argv)
        _run_reference_cli("create_data", ["--root", ref] + argv)
        names = assert_same_outputs(os.path.join(port, "timit_bwe"),
                                    os.path.join(ref, "timit_bwe"), 4)
        assert any(n.startswith("transcriptions") and n.endswith(".txt") for n in names)


def test_create_data_refuses_as_the_reference(tmp_path, tree):
    with pytest.raises(ValueError, match="dns"):
        create_data.main(["--task", "bwe", "--root", str(tmp_path / "p"), "--speech", "dns"])
    with pytest.raises(ValueError, match="dns"):
        _run_reference_cli("create_data", ["--task", "bwe", "--root", str(tmp_path / "r"),
                                           "--speech", "dns"])
    argv = ["--task", "enh", "--noise", "qut", "--speech", "dir", "--noise_dir",
            f"{tree}/toy", "--speech_dir", f"{tree}/speech", "--splits", "tt"]
    with pytest.raises(NotImplementedError, match="qut"):
        create_data.main(["--root", str(tmp_path / "p")] + argv)
    with pytest.raises(NotImplementedError, match="qut"):
        _run_reference_cli("create_data", ["--root", str(tmp_path / "r")] + argv)


def test_create_data_has_the_reference_defaults_and_tables():
    """The flags' defaults (every run's log_stats.txt, compared above, lists
    the parsed flags of both) and the parameter tables."""
    ref_mod = runpy.run_path(os.path.join(REPO, "preprocessing", "create_data.py"))
    ours = vars(create_data.parse_args(["--task", "enh", "--root", "r"]))
    assert ours == {"task": "enh", "speech": "wsj0", "noise": "chime", "sr": 16000,
                    "splits": "cv,tr,tt", "corruption_per_sample": 1, "dummy": False,
                    "bwe_method": "polyphase", "root": "r", "speech_dir": None,
                    "noise_dir": None}
    for name in ("SEED", "bwe_params", "enh_params", "derev_params"):
        assert getattr(create_data, name) == ref_mod[name], name
    for mod, name in ((nonlinear_mixing, "nonlinear_mixing"), (simulate_wind_noise,
                                                               "simulate_wind_noise")):
        ref = runpy.run_path(os.path.join(REPO, "preprocessing", f"{name}.py"))
        table = "params" if name == "nonlinear_mixing" else "wind_params"
        assert getattr(mod, table) == ref[table] and mod.SEED == ref["SEED"]


def test_wind_noise_cli_writes_the_reference_bytes(tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    simulate_wind_noise.main(["--dir", port, "--n", "2"])
    _run_reference_cli("simulate_wind_noise", ["--dir", ref, "--n", "2"])
    names = assert_same_outputs(port, ref, 2)
    assert names == ["simulated_0.wav", "simulated_1.wav"]
    x, sr = load_wav(os.path.join(port, names[0]))
    assert sr == SR and x.shape == (1, 8 * SR)


def test_nonlinear_mixing_writes_the_reference_bytes(tmp_path, tree):
    wind_dir = str(tmp_path / "wind")
    simulate_wind_noise.main(["--dir", wind_dir, "--n", "2"])
    argv = ["--speech_dir", f"{tree}/speech/{{}}", "--noise_dir", wind_dir]
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    nonlinear_mixing.main(["--root", port] + argv)
    _run_reference_cli("nonlinear_mixing", ["--root", ref] + argv)
    out = "speech_in_noise_nonlinear"
    names = assert_same_outputs(os.path.join(port, out), os.path.join(ref, out), 12)
    assert os.path.join("tr", "noisy", "s1_1_snr=") in "".join(names)


# --------------------------------------------------------------------------
# The library functions, seeded, at float64 with atol 0
# --------------------------------------------------------------------------

ROOMS = [  # (room, source, mic, t60)
    ([6.0, 7.5, 3.0], [2.0, 3.1, 1.5], [4.2, 2.2, 1.2], 0.45),
    ([12.3, 9.1, 4.4], [1.5, 7.0, 2.2], [9.9, 2.5, 1.7], 0.9),
]


@pytest.mark.parametrize("i", range(len(ROOMS)))
def test_rooms_equal_the_reference(i):
    dim, src, mic, t60 = ROOMS[i]
    assert room.inverse_sabine(t60, dim) == jroom.inverse_sabine(t60, dim)
    sig = np.random.default_rng(i).standard_normal(4000)
    got = room.simulate_shoebox(sig, dim, src, mic, t60, rng=np.random.default_rng(7))
    want = jroom.simulate_shoebox(sig, dim, src, mic, t60, rng=np.random.default_rng(7))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert room.measure_rt60(got[1]) == jroom.measure_rt60(want[1]) > 0
    for g, w in zip(room.simulate_dry(sig, dim, src, mic), jroom.simulate_dry(sig, dim, src, mic)):
        np.testing.assert_array_equal(g, w)
    for order in (0, 2):
        np.testing.assert_array_equal(room.shoebox_rir(dim, src, mic, 0.3, order),
                                      jroom.shoebox_rir(dim, src, mic, 0.3, order))
    assert room.measure_rt60(np.ones(3)) == jroom.measure_rt60(np.ones(3)) == 0.0


def test_inverse_sabine_refuses_a_room_too_large_as_the_reference():
    for fn in (room.inverse_sabine, jroom.inverse_sabine):
        with pytest.raises(ValueError, match="too large"):
            fn(0.05, [15.0, 15.0, 6.0])


@pytest.mark.parametrize("seed", [0, 1])
def test_compressor_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    speech, noise = rng.standard_normal(6000) * 0.3, rng.standard_normal(5000) * 0.5
    kw = dict(threshold=rng.uniform(0.1, 0.3), ratio=rng.uniform(1, 20),
              attack=rng.uniform(5, 100), release=rng.uniform(5, 500), sc_gain=1.1)
    np.testing.assert_array_equal(compressor.sidechain_compress(speech, noise, **kw),
                                  jcompressor.sidechain_compress(speech, noise, **kw))
    mix = compressor.nonlinear_mix(speech, noise, **kw)
    np.testing.assert_array_equal(mix, jcompressor.nonlinear_mix(speech, noise, **kw))
    assert mix.shape == (5000,)
    np.testing.assert_array_equal(compressor.hard_clip(mix, 0.9), jcompressor.hard_clip(mix, 0.9))


@pytest.mark.parametrize("gustiness", [1.0, 4.7, 9.5])
def test_wind_equals_the_reference(gustiness):
    a = wind.make_wind_profile(np.random.default_rng(3), gustiness)
    assert a == jwind.make_wind_profile(np.random.default_rng(3), gustiness)
    assert len(a) == max(1, int(1.5 * gustiness))
    assert all(abs(p - q) < 100 for p, q in zip(a, a[1:]))
    for profile in (a, None):
        got = wind.generate_wind_noise(0.5, gustiness=gustiness, wind_profile=profile, seed=5)
        want = jwind.generate_wind_noise(0.5, gustiness=gustiness, wind_profile=profile, seed=5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    gen = wind.WindNoiseGenerator(SR, 0.25, wind_profile=a, gustiness=gustiness, start_seed=2)
    jgen = jwind.WindNoiseGenerator(SR, 0.25, wind_profile=a, gustiness=gustiness, start_seed=2)
    np.testing.assert_array_equal(gen.generate_wind_noise()[0], jgen.generate_wind_noise()[0])


@pytest.mark.parametrize("dataset,sub,channels", [
    ("wham", "wham/tr", 1), ("wham", "wham/tr", 2), ("chime", "chime", 1),
    ("chime", "chime", 2), ("chime", "toy", 1)])
def test_obtain_noise_file_equals_the_reference(tree, dataset, sub, channels):
    for i_sample in range(3):
        for n in (4000, 40000):  # shorter and longer than the recordings
            kw = dict(dataset=dataset, sample_rate=SR, len_speech=n)
            got = utils.obtain_noise_file(f"{tree}/{sub}", i_sample, channels, **kw,
                                          rng=np.random.default_rng(i_sample))
            want = jutils.obtain_noise_file(f"{tree}/{sub}", i_sample, channels, **kw,
                                            rng=np.random.default_rng(i_sample))
            assert got[1] == want[1] == SR
            np.testing.assert_array_equal(got[0], want[0])


def test_obtain_noise_file_refuses_as_the_reference(tree, tmp_path):
    for fn in (utils.obtain_noise_file, jutils.obtain_noise_file):
        with pytest.raises(NotImplementedError, match="qut"):
            fn(f"{tree}/toy", 0, 1, "qut", SR, 100)
        with pytest.raises(ValueError, match="unknown noise dataset"):
            fn(f"{tree}/toy", 0, 1, "dns", SR, 100)
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path), 0, 1, "wham", SR, 100)


def test_package_exports_the_reference_names():
    import storm_tpu.preprocessing as jpre
    assert preprocessing.__all__ == jpre.__all__


# --------------------------------------------------------------------------
# The WAV reader: the port's scipy decoder against the JAX package's native one
# --------------------------------------------------------------------------

def _pcm24(path, ints):
    raw = b"".join(int(v).to_bytes(3, "little", signed=True) for v in ints)
    fmt = struct.pack("<HHIIHH", 1, 1, SR, SR * 3, 3, 24)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"junk" + struct.pack("<I", 3) + b"abc\0"  # an odd chunk before the data
            + b"data" + struct.pack("<I", len(raw)) + raw)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)


@pytest.mark.parametrize("encoding", ["int16", "int16_stereo", "int32", "pcm24", "float32",
                                      "float64", "int16_8ch"])
def test_wav_reader_decodes_every_sample_as_the_native_decoder(tmp_path, encoding):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "x.wav")
    full = np.iinfo(np.int16)
    if encoding == "pcm24":
        _pcm24(path, np.concatenate([[-2**23, 2**23 - 1, 0, -1], rng.integers(-2**23, 2**23, 500)]))
    elif encoding.startswith("int16"):
        ch = {"int16": 1, "int16_stereo": 2, "int16_8ch": 8}[encoding]
        x = rng.integers(full.min, full.max + 1, (500, ch)).astype(np.int16)
        x[:2] = [[full.min], [full.max]]
        wavfile.write(path, SR, x[:, 0] if ch == 1 else x)
    elif encoding == "int32":
        x = rng.integers(-2**31, 2**31, 500, dtype=np.int64).astype(np.int32)
        x[:2] = [-2**31, 2**31 - 1]
        wavfile.write(path, SR, x)
    else:
        wavfile.write(path, SR, rng.standard_normal(500).astype(encoding))
    got, sr = load_wav(path)
    want, jsr = jload_wav(path)
    assert sr == jsr == SR and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_wav_reader_differs_from_the_native_decoder_only_where_the_reference_does(tmp_path):
    """Two accepted differences (ROADMAP Queue 3): past 8 channels the native
    decoder keeps the first 8, the port all; an 8-bit file raises KeyError
    in the JAX package's scipy path, the port decodes it."""
    rng = np.random.default_rng(1)
    path = str(tmp_path / "ten.wav")
    wavfile.write(path, SR, rng.integers(-30000, 30000, (300, 10)).astype(np.int16))
    got, want = load_wav(path)[0], jload_wav(path)[0]
    assert got.shape == (10, 300) and want.shape == (8, 300)
    np.testing.assert_array_equal(got[:8], want)
    path = str(tmp_path / "u8.wav")
    wavfile.write(path, SR, np.array([0, 128, 255], np.uint8))
    np.testing.assert_array_equal(load_wav(path)[0], [[-1.0, 0.0, 127 / 128]])
    with pytest.raises(KeyError):
        jload_wav(path)
