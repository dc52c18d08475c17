"""The port's benchmark and load client on the CPU: `python -m
storm_tpu_torch.bench` prints one JSON line with the keys of the reference's
bench.py (read from its source), serving and `--train`; its unported flags
raise naming their ROADMAP items; its operation count is the same whatever
computes the work (float32, bfloat16, the int8 product); and
`python -m storm_tpu_torch.serve_load` reports the keys of
scripts/serve_load.py against an in-process server.

Tiny sizes: nf 16 at the bench's 256 frequency bins, B=2, 32 frames, N=2;
the operation counts on StoRM at n_fft 62. Counts are held exactly.
"""
import ast
import json
import os
import pathlib
import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_inference import STORM_TINY, wave

from storm_tpu_torch import bench, serve, serve_load
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.data.audio import save_wav
from storm_tpu_torch.models import quant as pquant
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.nn import resample
from storm_tpu_torch.nn.qconv import QuantizableConv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--nf", "16", "--batch", "2", "--frames", "32", "--N", "2",
        "--reps", "1"]
WAIT = 60  # seconds: the bound of every wait in this file


def _dict_keys(node: ast.Dict):
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def reference_bench_lines():
    """{metric: (top-level keys, detail keys)} of the JSON lines the
    reference's bench.py prints, from its source."""
    tree = ast.parse(pathlib.Path(REPO, "bench.py").read_text())
    lines = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and "metric" in _dict_keys(node):
            metric = node.values[[k.value for k in node.keys].index("metric")].value
            detail = node.values[[k.value for k in node.keys].index("detail")]
            lines[metric] = (_dict_keys(node), _dict_keys(detail))
    return lines


def _bench_line(capsys, *argv):
    bench.main([*TINY, *argv])
    out = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(out) == 1, out
    return json.loads(out[0])


def test_serving_line_has_the_reference_keys(capsys):
    line = _bench_line(capsys)
    top, detail = reference_bench_lines()["audio_sec_per_sec_per_chip_50step_pc"]
    assert set(line) == top
    assert set(line["detail"]) == detail | {"device_name"}
    d = line["detail"]
    assert line["unit"] == "audio-sec/s/chip" and line["value"] > 0
    assert d["nfe"] == 1 + 2 * 2 and d["batch"] == 2 and d["utt_sec"] == round(31 * 128 / 16000, 3)
    assert (d["backend"], d["device_name"], d["dtype"], d["quant"]) == ("cpu", "cpu", "bfloat16",
                                                                        "int8")
    assert (d["deepcache"], d["deepcache_depth"], d["backbone"]) == (3, 1, "ncsnpp")
    assert d["exact_nfe101_audio_sec_per_sec"] > 0  # the headline caches: the exact extra ran
    assert d["storm_default_nfe31_audio_sec_per_sec"] is None  # only at N=50 + ald
    assert d["program_tflops"] > 0 and d["achieved_tflops_per_s"] >= 0


def test_exact_float32_line_has_no_exact_extra(capsys):
    line = _bench_line(capsys, "--deepcache", "0", "--quant", "none", "--dtype", "float32")
    d = line["detail"]
    assert (d["deepcache"], d["quant"], d["dtype"]) == (0, "none", "float32")
    assert d["exact_nfe101_audio_sec_per_sec"] is None


def test_train_line_has_the_reference_keys(capsys):
    line = _bench_line(capsys, "--train")
    top, detail = reference_bench_lines()["train_utt_per_sec_per_chip"]
    assert set(line) == top
    assert set(line["detail"]) == detail | {"device_name"}
    assert line["vs_baseline"] is None and line["value"] > 0
    assert line["detail"]["step_ms"] > 0 and line["detail"]["frames"] == 32


def test_distill_line_has_the_reference_keys(capsys):
    """`--distill`: the one-step program (NFE 2) under the reference's metric
    and `detail` keys, int8 through `calibrate_distill`."""
    for extra, quant in (([], "int8"), (["--quant", "none", "--dtype", "float32"], "none")):
        line = _bench_line(capsys, "--distill", *extra)
        top, detail = reference_bench_lines()["audio_sec_per_sec_per_chip_distill_nfe2"]
        assert set(line) == top
        assert set(line["detail"]) == detail | {"device_name"}
        d = line["detail"]
        assert line["value"] > 0 and (d["nfe"], d["batch"], d["quant"]) == (2, 2, quant)


@pytest.mark.parametrize("argv,item", [(["--backbone", "ncsnpp12M"], "R4")])
def test_unported_flags_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        bench.main([*TINY, *argv])


def test_default_device_and_defaults():
    args = bench.parse_args([])
    assert (args.batch, args.frames, args.N, args.corrector, args.corrector_steps, args.reps,
            args.dtype, args.quant, args.deepcache, args.deepcache_depth, args.device) == (
        16, 256, 50, "ald", 1, 3, "bfloat16", "int8", 3, 1, "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            bench.main([])


def test_budget_falls_back_on_a_malformed_value(monkeypatch, capsys):
    monkeypatch.setenv(bench.BUDGET_ENV, "soon")
    assert bench.extras_budget_s() == bench.BUDGET_DEFAULT_S
    assert "ignoring malformed" in capsys.readouterr().err
    monkeypatch.setenv(bench.BUDGET_ENV, "12.5")
    assert bench.extras_budget_s() == 12.5


def test_operation_count_of_a_conv_and_an_fir():
    """A 3x3 conv counts 2 x MACs in float32 and on the int8 path; an FIR,
    up or down, counts nothing on the CPU (its plain version) as on the card
    (a ctypes kernel the counter cannot see)."""
    g = torch.Generator().manual_seed(0)
    conv = QuantizableConv(16, 24, 3, padding=1)
    x = torch.randn(2, 16, 8, 10, generator=g)
    want = 2 * 2 * 8 * 10 * 24 * 16 * 9
    with torch.no_grad(), bench.program_flops() as f32:
        conv(x)
    conv.set_scale(0.05)
    with torch.no_grad(), bench.program_flops() as int8:
        conv(x)
    assert f32.get_total_flops() == int8.get_total_flops() == want
    with bench.program_flops() as fir:
        resample.downsample_2d(x, (1, 3, 3, 1))
        resample.upsample_2d(x, (1, 3, 3, 1))
    assert fir.get_total_flops() == 0
    with bench.program_flops() as mm:
        F.linear(x[0, 0], torch.randn(7, 10, generator=g))
    assert mm.get_total_flops() == 2 * 8 * 10 * 7


def test_operation_count_is_the_same_whatever_computes_it():
    """One enhancement at dc3 counts the same operations in float32, in
    bfloat16 and with the int8 path on every conv of 8 channels or more."""
    y = torch.from_numpy(wave(1500, 1)[None])
    counts = {}
    for name, dtype, int8 in (("f32", "float32", False), ("bf16", "bfloat16", False),
                              ("int8", "float32", True)):
        model = pbuild(dict(STORM_TINY, dtype=dtype), device="cpu", seed=0)
        quant = (pquant.calibrate_storm(model, y, N=1, min_channels=8,
                                        generator=torch.Generator().manual_seed(1))
                 if int8 else None)
        assert not int8 or pquant.num_quantized_convs(quant["score"]) == 41
        with bench.program_flops() as n:
            model.enhance(y, N=2, corrector="ald", quant=quant, deepcache=3,
                          generator=torch.Generator().manual_seed(0))
        counts[name] = n.get_total_flops()
    assert counts["f32"] > 0 and counts["f32"] == counts["bf16"] == counts["int8"], counts


# --- serve_load


def reference_load_report_keys():
    tree = ast.parse(pathlib.Path(REPO, "scripts", "serve_load.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "report"
                and isinstance(node.value, ast.Dict)):
            return _dict_keys(node.value)
    raise AssertionError("no report dict in scripts/serve_load.py")


def test_serve_load_reports_the_reference_keys(tmp_path, capsys):
    ckpt = str(tmp_path / "tiny.pt")
    save_checkpoint(ckpt, STORM_TINY, pbuild(dict(STORM_TINY), device="cpu").state_dict())
    noisy = tmp_path / "noisy"
    noisy.mkdir()
    for i, n in enumerate((900, 1500, 2500)):
        save_wav(str(noisy / f"{i}.wav"), wave(n, i))
    args = serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--N", "1", "--corrector", "none", "--port", "0",
         "--device", "cpu", "--batch", "2", "--max_wait_ms", "50", "--deepcache", "1"])
    httpd, batcher = serve.build_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = httpd.server_address[:2]
        report = serve_load.main(["--url", f"http://{host}:{port}", "--dir", str(noisy),
                                  "--requests", "5", "--concurrency", "2", "--json",
                                  str(tmp_path / "report.json")])
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=WAIT)
    assert not thread.is_alive()
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == report == json.loads((tmp_path / "report.json").read_text())
    assert set(report) == reference_load_report_keys()
    assert report["requests"] == 5 and report["errors"] == 0 and report["server_batches"] >= 3
    assert np.isclose(report["audio_s"], (900 + 1500 + 2500 + 900 + 1500) / 16000, atol=0.01)
    assert report["server_config"]["deepcache"] == 1 and "status" not in report["server_config"]
