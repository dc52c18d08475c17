"""Data-parallel serving in the port: `BucketedEnhancer(data_parallel=True)`
keeps one replica per device and splits each chunk's rows over them, each
row with the draws of unsharded serving. Held against the reference's
`BucketedEnhancer(data_parallel=True)` on its 8-device CPU mesh (the port's
counterpart: `devices=["cpu"] * 8`) with the reference's noise replayed and
its weights converted, for StoRM, score-only, denoiser-only and distill;
against the port's own unsharded serving; and the rules: the minibatch
rounding, no async path, the CLI's `--data_parallel` (B=1 becomes --batch
8) and the server's mesh mode.

Tiny nets (nf 16, two levels; distill nf 8), n_fft 62, buckets of 16 frames,
N=2. Tolerances: against the reference 1e-4 of the output's scale (the
port's enhance parity tests', tests/test_torch_inference.py); against the
port's unsharded serving 1e-5 of the output's scale (float32 sums of other
batch widths).
"""
import http.client
import json
import os
import threading
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from test_torch_inference import random_params, wave
from torch_parity import ReplayNoise, assert_close_rel, jax_noise_schedule

from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.signal import cplx as jcplx
from storm_tpu.utils.inference import BucketedEnhancer as JBucketed
from storm_tpu_torch import enhancement, serve
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.convert import params_from_jax
from storm_tpu_torch.data.audio import save_wav
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.utils import inference
from storm_tpu_torch.utils.inference import BucketedEnhancer

F = 32  # frequency bins at n_fft 62
BASE = {"nf": 16, "ch_mult": [1, 2], "init_scale": 1.0, "n_fft": 62, "hop_length": 16,
        "sde": "ouve"}
CONFIGS = {
    "storm": dict(BASE, mode="regen-joint-training"),
    "score-only": dict(BASE, mode="score-only"),
    "denoiser-only": dict(BASE, mode="denoiser-only"),
    "distill": dict(BASE, mode="distill", nf=8, ch_mult=[1, 1]),
}
CPUS = ["cpu"] * 8  # the reference tests' 8-device CPU mesh
KW = dict(N=2, corrector="ald", bucket_frames=16)
LENGTH = 1800  # samples: a bucket of 2048, 129 frames, NCSN++ at 192


def frames(T: int = LENGTH) -> int:
    """NCSN++'s width for a T-sample input in buckets of 16 hops."""
    n = -(-T // 256) * 256 // 16 + 1
    return -(-n // 64) * 64


PAIRS = {}


def pair(mode):
    """(reference model, its random weights, the port model with them), made
    once per mode."""
    if mode not in PAIRS:
        cfg = CONFIGS[mode]
        jmodel = jbuild(dict(cfg))
        params = random_params(jmodel, (1, F, 64), seed=len(PAIRS))
        pmodel = pbuild(dict(cfg), device="cpu")
        pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
        PAIRS[mode] = (jmodel, params, pmodel)
    return PAIRS[mode]


def chunk_noise(mode, key, rows, chunks, n_steps=KW["N"], corrector="ald", spec=(F, None)):
    """The reference `BucketedEnhancer`'s draws with `minibatch` set: a key
    split off per chunk, the chunk's sampler drawing from it (pc for StoRM
    and score-only, the one prior of distill, none for the denoiser).
    `spec`: the (bins, frames) of a draw (frames None: `frames()`)."""
    draws = []
    for _ in range(chunks):
        key, k = jax.random.split(key)
        shape = (rows, spec[0], spec[1] or frames())
        if mode == "distill":
            draws.append(np.asarray(jcplx.complex_normal(k, shape), np.float32))
        elif mode != "denoiser-only":
            draws += jax_noise_schedule(k, shape, n_steps, corrector=corrector)
    return draws


def waves(n, seed=0):
    return np.stack([wave(LENGTH, seed + i) for i in range(n)])


@pytest.mark.parametrize("mode", list(CONFIGS))
def test_dp_matches_reference_mesh_and_unsharded(mode):
    """Eight rows over the eight devices: the reference's mesh program
    against the port's replicas, with the same draws; and the port's replicas
    against its one-call batch."""
    jmodel, params, pmodel = pair(mode)
    y, key = waves(8), jax.random.PRNGKey(3)
    want, jnfe = JBucketed(jmodel, params, minibatch=8, data_parallel=True, **KW)(y, key)
    draws = chunk_noise(mode, key, 8, 1)
    dp = BucketedEnhancer(pmodel, minibatch=8, data_parallel=True, devices=CPUS, **KW)
    assert len(dp.replicas) == 8 and dp.devices == CPUS
    noise = ReplayNoise(draws)
    got, nfe = dp(y, noise=noise)
    assert noise.exhausted() and nfe == int(jnfe)
    assert_close_rel(got, np.asarray(want), 1e-4, f"{mode}: data parallel against the reference")
    plain, nfe0 = BucketedEnhancer(pmodel, minibatch=8, **KW)(y, noise=ReplayNoise(draws))
    assert nfe0 == nfe
    assert_close_rel(got, plain, 1e-5, f"{mode}: data parallel against unsharded")


def test_dp_rows_see_the_unsharded_draws():
    """Each replica's rows of every draw are the unsharded call's: a ragged
    group of 5 rows in a chunk rounded to 8, from one generator, equals the
    unsharded minibatch of 8 from the same seed."""
    _, _, pmodel = pair("storm")
    y = waves(5, seed=4)
    dp = BucketedEnhancer(pmodel, minibatch=5, data_parallel=True, devices=CPUS, **KW)
    assert dp.minibatch == 8  # rounded up to the eight replicas
    got, nfe = dp(y, torch.Generator().manual_seed(7))
    want, nfe0 = BucketedEnhancer(pmodel, minibatch=8, **KW)(y, torch.Generator().manual_seed(7))
    assert nfe == nfe0 and got.shape == y.shape
    assert_close_rel(got, want, 1e-5, "data parallel from one generator")


@pytest.mark.parametrize("predrawn", [False, True])
def test_row_split_hands_each_replica_its_rows(predrawn):
    """`RowSplit`: the j-th draw is the source's j-th at the chunk's rows,
    whichever replica asks first; each replica gets its rows of it. Drawn in
    advance (the replicas then ask from threads of their own), a replica
    that asks past the drawn ones raises instead of drawing out of order."""
    g = torch.Generator().manual_seed(0)
    source = lambda shape: torch.randn(tuple(shape) + (2,), generator=g)  # noqa: E731
    ref = torch.Generator().manual_seed(0)
    want = [torch.randn((6, 3, 4, 2), generator=ref) for _ in range(3)]
    cpu = torch.device("cpu")
    split = inference.RowSplit(source, [(0, 2, cpu), (2, 4, cpu), (4, 6, cpu)])
    if predrawn:
        split.predraw([(2, 3, 4)] * 3)
    parts = [split.part(r) for r in (2, 0, 1)]  # the last replica asks first
    for j in range(3):
        for r, part in zip((2, 0, 1), parts):
            assert torch.equal(part((2, 3, 4)), want[j][2 * r:2 * r + 2])
    if predrawn:
        with pytest.raises(RuntimeError, match="not the chunk's"):
            parts[0]((2, 3, 4))
    with pytest.raises(RuntimeError, match="not the chunk's"):
        split.part(0)((3, 3, 4))  # another row count than the replica's


def test_dp_rules():
    """The reference's minibatch rule (None -> the device count; rounded up
    to a multiple of it), no async path in a mesh mode, a graph per
    replica's call."""
    _, _, pmodel = pair("storm")
    assert BucketedEnhancer(pmodel, data_parallel=True, devices=CPUS, **KW).minibatch == 8
    dp = BucketedEnhancer(pmodel, minibatch=9, data_parallel=True, devices=CPUS[:4], **KW)
    assert dp.minibatch == 12 and not dp.supports_async and dp.execution == "graph"
    with pytest.raises(NotImplementedError, match="minibatch=None"):
        dp.enhance_async(waves(12))
    assert BucketedEnhancer(pmodel, **KW).supports_async


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_cli")
    ckpt = str(root / "storm.pt")
    save_checkpoint(ckpt, CONFIGS["storm"], pair("storm")[2].state_dict())
    noisy = root / "noisy"
    noisy.mkdir()
    for i, n in enumerate((1800, 1700, 900)):
        save_wav(str(noisy / f"f{i}.wav"), wave(n, 10 + i))
    return root, ckpt


def eight_cpus(model_device, devices=None):
    """The default device set replaced by eight CPU devices (the CLI has no
    device-list flag)."""
    return [torch.device(d) for d in (devices or CPUS)]


def run_cli(root, ckpt, name, *extra):
    """{file: the enhanced waveform the CLI wrote} (before its 16-bit PCM
    rounding, so that float32 differences are not read at the file's step)."""
    saved = {}
    with mock.patch.object(enhancement, "save_wav",
                           lambda path, x, sr: saved.update({os.path.basename(path): x})):
        enhancement.main(["--test_dir", str(root / "noisy"), "--enhanced_dir", str(root / name),
                          "--ckpt", ckpt, "--mode", "storm", "--N", "2", "--device", "cpu",
                          *extra])
    assert sorted(saved) == ["f0.wav", "f1.wav", "f2.wav"]
    return saved


@pytest.mark.parametrize("extra", [(), ("--batch", "3"),
                                   ("--stream_chunk_s", "0.06", "--stream_overlap_s", "0.01")])
def test_cli_data_parallel_is_batch_8(ckpt_dir, extra):
    """`--data_parallel` at B=1, with `--batch 3` (rounded up to the eight
    replicas) and streaming serves as `--batch 8` does."""
    root, ckpt = ckpt_dir
    stream = tuple(e for e in extra if e != "--batch" and e != "3")
    want = run_cli(root, ckpt, "batch8", "--batch", "8", *stream)
    with mock.patch.object(inference, "serving_devices", eight_cpus):
        got = run_cli(root, ckpt, "dp", "--data_parallel", *extra)
    for f in want:
        assert got[f].shape == want[f].shape
        assert_close_rel(got[f], want[f], 1e-5, f"--data_parallel {extra} {f}")


def test_server_mesh_mode_reports_its_devices(ckpt_dir):
    """The server in `--data_parallel` mode: one row size, the batch rounded
    to the replicas, the synchronous batcher, and /healthz naming the
    devices."""
    root, ckpt = ckpt_dir
    args = serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--N", "1", "--corrector", "none", "--port", "0",
         "--device", "cpu", "--dtype", "float32", "--batch", "6", "--data_parallel"])
    with mock.patch.object(inference, "serving_devices", eight_cpus):
        httpd, batcher = serve.build_server(args)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        assert batcher.row_sizes == [8] and not batcher._async
        conn = http.client.HTTPConnection(*httpd.server_address[:2], timeout=60)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["data_parallel"] is True and health["seq_parallel"] == 0
        assert health["devices"] == CPUS and health["batch"] == 8
        x, nfe = batcher.submit(wave(900, 1), timeout=60)
        assert x.shape == (900,) and nfe == 2 and np.isfinite(x).all()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
