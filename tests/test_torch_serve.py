"""The port's serving layer on the CPU: the dynamic batcher (the reference's
tests/test_serve.py cases, run against the port, and `_pick_locked` against
the reference's on the same queues), the WAV bytes codec against the
reference's, `build_server`'s warm-up and row sizes, the HTTP endpoints, the
refusals, and `python -m storm_tpu_torch.serve` draining on SIGTERM.

Every wait has a timeout; servers bind port 0 and close in `finally`.
Batch choices, codec bytes and the batcher's results are held exactly.
"""
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from test_torch_inference import STORM_TINY, wave

from storm_tpu.utils import server as jserver
from storm_tpu_torch import serve
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.models.storm import StochasticRegenerationModel
from storm_tpu_torch.utils.inference import BucketedEnhancer
from storm_tpu_torch.utils.server import (
    DynamicBatcher,
    _default_row_sizes,
    _Request,
    decode_wav_bytes,
    encode_wav_bytes,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 60  # seconds: the bound of every wait in this file


class FakeEnhancer:
    """Length-bucketing double: output = 2 * input, records batch shapes."""

    def __init__(self, bucket=64, delay_s=0.0):
        self.bucket = bucket
        self.delay_s = delay_s
        self.calls = []

    def padded_len(self, T):
        return -(-T // self.bucket) * self.bucket

    def __call__(self, ys, generator):
        self.calls.append(ys.shape)
        if self.delay_s:
            time.sleep(self.delay_s)
        return 2.0 * ys, 7


class _SlowResult:
    """A device result stand-in whose conversion to numpy blocks."""

    def __init__(self, value, delay_s):
        self._value = value
        self._delay_s = delay_s

    def __array__(self, dtype=None, copy=None):
        time.sleep(self._delay_s)
        return np.asarray(self._value, dtype)


class FakeAsyncEnhancer(FakeEnhancer):
    supports_async = True

    def __init__(self, bucket=64, device_s=0.1):
        super().__init__(bucket)
        self.device_s = device_s
        self.dispatch_t = []

    def enhance_async(self, ys, generator):
        self.calls.append(ys.shape)
        self.dispatch_t.append(time.monotonic())
        return _SlowResult(2.0 * ys, self.device_s), 7


def _submit_concurrently(batcher, waves, stagger_s=0.0):
    outs = [None] * len(waves)

    def work(i):
        outs[i] = batcher.submit(waves[i], timeout=WAIT)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(waves))]
    for t in threads:
        t.start()
        time.sleep(stagger_s)
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    return outs


def test_batcher_pipelines_async_dispatch():
    enh = FakeAsyncEnhancer(device_s=0.15)
    b = DynamicBatcher(enh, None, max_batch=2, max_wait_ms=10.0, pipeline_depth=2)
    try:
        waves = [np.full(100 + i, 0.5, np.float32) for i in range(6)]
        outs = _submit_concurrently(b, waves)
        for y, (x, nfe) in zip(waves, outs):
            assert x.shape == y.shape and nfe == 7
            np.testing.assert_allclose(x, 2.0 * y)
        assert b.stats["batches"] == len(enh.dispatch_t)
        assert b.stats["batched_requests"] == 6 and b.stats["errors"] == 0
        # a dispatch gap shorter than the fake device time: batches overlapped
        gaps = [t1 - t0 for t0, t1 in zip(enh.dispatch_t, enh.dispatch_t[1:])]
        assert gaps and min(gaps) < enh.device_s
    finally:
        b.close()


def test_batcher_async_propagates_finalize_errors():
    class Boom(_SlowResult):
        def __array__(self, dtype=None, copy=None):
            raise RuntimeError("device exploded")

    class FailingAsync(FakeAsyncEnhancer):
        def enhance_async(self, ys, generator):
            self.calls.append(ys.shape)
            return Boom(None, 0.0), 7

    b = DynamicBatcher(FailingAsync(), None, max_batch=2, max_wait_ms=10.0)
    try:
        with pytest.raises(RuntimeError, match="device exploded"):
            b.submit(np.zeros(50, np.float32), timeout=WAIT)
        assert b.stats["errors"] == 1
        assert b._worker.is_alive() and b._finalizer.is_alive()
    finally:
        b.close()
    assert not b._worker.is_alive() and not b._finalizer.is_alive()


def test_batcher_coalesces_full_bucket():
    enh = FakeEnhancer(delay_s=0.05)
    b = DynamicBatcher(enh, None, max_batch=4, max_wait_ms=5000.0)
    try:
        waves = [np.full(100 + i, 0.5, np.float32) for i in range(4)]
        outs = _submit_concurrently(b, waves)
        for y, (x, nfe) in zip(waves, outs):
            assert x.shape == y.shape and nfe == 7
            np.testing.assert_allclose(x, 2.0 * y)
        assert enh.calls == [(4, 128)]  # all four pad to one bucket: one call
        assert b.stats["batched_requests"] == 4
    finally:
        b.close()


def test_batcher_linger_dispatches_partial_batch():
    enh = FakeEnhancer()
    b = DynamicBatcher(enh, None, max_batch=8, max_wait_ms=30.0)
    try:
        t0 = time.monotonic()
        x, _ = b.submit(np.ones(50, np.float32), timeout=WAIT)
        assert time.monotonic() - t0 < 5.0
        assert x.shape == (50,) and enh.calls == [(1, 64)]
    finally:
        b.close()


def test_batcher_coalesces_across_buckets():
    enh = FakeEnhancer(delay_s=0.05)
    b = DynamicBatcher(enh, None, max_batch=4, max_wait_ms=2000.0)
    try:
        waves = [np.ones(40, np.float32), np.ones(200, np.float32),
                 np.ones(50, np.float32), np.ones(220, np.float32)]
        outs = _submit_concurrently(b, waves)
        for y, (x, _) in zip(waves, outs):
            assert x.shape == y.shape
        assert enh.calls == [(4, 256)]  # padded to the largest bucket taken
        assert b.stats["batches"] == 1 and b.stats["batched_requests"] == 4
    finally:
        b.close()


def test_batcher_prefers_same_bucket_fill():
    enh = FakeEnhancer(delay_s=0.4)
    b = DynamicBatcher(enh, None, max_batch=2, max_wait_ms=50.0)
    try:
        waves = [np.ones(70, np.float32),   # dispatched alone
                 np.ones(40, np.float32),   # bucket 64, the next head
                 np.ones(200, np.float32),  # bucket 256, skipped over
                 np.ones(50, np.float32)]   # bucket 64, taken with the head
        outs = _submit_concurrently(b, waves, stagger_s=0.1)
        for y, (x, _) in zip(waves, outs):
            assert x.shape == y.shape
        assert enh.calls == [(1, 128), (2, 64), (1, 256)]
    finally:
        b.close()


def test_batcher_pads_rows_to_power_of_two():
    enh = FakeEnhancer(delay_s=0.05)
    b = DynamicBatcher(enh, None, max_batch=16, max_wait_ms=100.0)
    try:
        waves = [np.ones(40 + i, np.float32) for i in range(3)]
        outs = _submit_concurrently(b, waves)
        for y, (x, _) in zip(waves, outs):
            assert x.shape == y.shape
        assert enh.calls == [(4, 64)]  # 3 requests -> a 4-row batch
        assert b.stats["row_slots"] == 4 and b.stats["batched_requests"] == 3
    finally:
        b.close()


def test_batcher_pinned_row_size():
    enh = FakeEnhancer()
    b = DynamicBatcher(enh, None, max_batch=4, max_wait_ms=20.0, row_sizes=[4])
    try:
        x, _ = b.submit(np.ones(50, np.float32), timeout=WAIT)
        assert x.shape == (50,) and enh.calls == [(4, 64)]
    finally:
        b.close()


def test_batcher_propagates_errors():
    class Boom(FakeEnhancer):
        def __call__(self, ys, generator):
            raise ValueError("kaput")

    b = DynamicBatcher(Boom(), None, max_batch=1, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="kaput"):
            b.submit(np.ones(10, np.float32), timeout=WAIT)
        assert b.stats["errors"] == 1
    finally:
        b.close()


def test_batcher_close_drains_the_queue():
    enh = FakeEnhancer(delay_s=0.1)
    b = DynamicBatcher(enh, None, max_batch=2, max_wait_ms=10_000.0)
    outs = []
    threads = [threading.Thread(target=lambda i=i: outs.append(
        b.submit(np.ones(30 + i, np.float32), timeout=WAIT))) for i in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.3)  # queued behind a 10 s linger
    b.close()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    assert len(outs) == 3 and b.stats["batched_requests"] == 3
    with pytest.raises(RuntimeError, match="closed"):
        b.submit(np.ones(10, np.float32), timeout=WAIT)


@pytest.mark.parametrize("max_batch,row_sizes", [(1, None), (4, None), (8, None), (6, None),
                                                 (16, [1, 4]), (8, [8])])
def test_row_sizes_match_reference(max_batch, row_sizes):
    assert _default_row_sizes(max_batch) == jserver._default_row_sizes(max_batch)
    b = DynamicBatcher(FakeEnhancer(), None, max_batch=max_batch, row_sizes=row_sizes)
    jb = jserver.DynamicBatcher(FakeEnhancer(), jax.random.PRNGKey(0), max_batch=max_batch,
                                row_sizes=row_sizes)
    try:
        assert b.row_sizes == jb.row_sizes
    finally:
        b.close()
        jb.close()


def _queue(lengths_ages, cls):
    now = time.monotonic()
    reqs = []
    for T, age in lengths_ages:
        r = cls(np.zeros(T, np.float32))
        r.t_enqueue = now - age
        reqs.append(r)
    return reqs


@pytest.mark.parametrize("seed", range(6))
def test_pick_locked_matches_reference(seed):
    """Both batchers, their threads stopped, pick from the same queues: the
    same batches in the same order, lingering alike."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 14))
    # ages well away from the 150 ms linger, so both picks read them alike
    items = [(int(rng.integers(1, 400)), float(rng.uniform(0.0, 0.1) + 0.2 * rng.integers(2)))
             for _ in range(n)]
    items.sort(key=lambda it: -it[1])  # the queue is age-ordered
    max_batch = int(rng.choice([1, 2, 3, 4, 8]))
    port = DynamicBatcher(FakeEnhancer(), None, max_batch=max_batch, max_wait_ms=150.0)
    ref = jserver.DynamicBatcher(FakeEnhancer(), jax.random.PRNGKey(0), max_batch=max_batch,
                                 max_wait_ms=150.0)
    port.close()
    ref.close()
    for closed in (False, True):
        port._closed = ref._closed = closed
        port._pending = _queue(items, _Request)
        ref._pending = _queue(items, jserver._Request)
        index = {id(r): i for q in (port._pending, ref._pending) for i, r in enumerate(q)}
        while True:
            got, want = port._pick_locked(), ref._pick_locked()
            assert (got is None) == (want is None)
            if got is None:
                break
            assert [index[id(r)] for r in got] == [index[id(r)] for r in want]
        assert len(port._pending) == len(ref._pending)
        if closed:
            assert not port._pending


# --- the WAV bytes codec


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_bytes_equal_reference(channels):
    rng = np.random.default_rng(channels)
    x = (0.6 * rng.standard_normal((channels, 1001))).astype(np.float32)
    x = x[0] if channels == 1 else x  # includes values beyond +-1: clipped alike
    body = encode_wav_bytes(x, 16000)
    assert body == jserver.encode_wav_bytes(x, 16000)
    y, sr = decode_wav_bytes(body)
    jy, jsr = jserver.decode_wav_bytes(body)
    assert sr == jsr == 16000 and y.dtype == np.float32 and y.shape == (channels, 1001)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_allclose(y, np.clip(np.atleast_2d(x), -1, 1), atol=2.5 / 32768)


@pytest.mark.parametrize("dtype", [np.int16, np.int32, np.float32, np.uint8])
def test_wav_decode_equals_reference_for_each_sample_type(dtype):
    import io

    from scipy.io import wavfile

    rng = np.random.default_rng(0)
    info = np.iinfo(dtype) if np.dtype(dtype).kind in "iu" else None
    data = (rng.integers(info.min, info.max, (300, 2), endpoint=True).astype(dtype) if info
            else rng.uniform(-1, 1, (300, 2)).astype(dtype))
    buf = io.BytesIO()
    wavfile.write(buf, 8000, data)
    y, sr = decode_wav_bytes(buf.getvalue())
    assert sr == 8000 and y.shape == (2, 300) and y.dtype == np.float32
    if dtype == np.uint8:
        # the reference's codec indexes its scales by the converted float32
        # array's dtype and raises; the port scales as its WAV reader does
        with pytest.raises(KeyError):
            jserver.decode_wav_bytes(buf.getvalue())
        np.testing.assert_array_equal(y, ((data.astype(np.float32) - 128.0) / 128.0).T)
    else:
        np.testing.assert_array_equal(y, jserver.decode_wav_bytes(buf.getvalue())[0])


# --- build_server, HTTP, main


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srv") / "tiny.pt")
    save_checkpoint(path, STORM_TINY, pbuild(dict(STORM_TINY), device="cpu").state_dict())
    return path


def _args(ckpt, *extra):
    return serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--N", "1", "--corrector", "none", "--port", "0",
         "--device", "cpu", *extra])


def test_build_server_warmup_buckets_and_row_sizes(tiny_ckpt):
    shapes = []
    enhance = StochasticRegenerationModel.enhance

    def recorded(model, y, **kw):
        shapes.append(tuple(y.shape))
        return enhance(model, y, **kw)

    with mock.patch.object(StochasticRegenerationModel, "enhance", recorded):
        httpd, batcher = serve.build_server(_args(
            tiny_ckpt, "--batch", "2", "--warmup_s", "0.05", "--warmup_buckets", "0.03,0.1",
            "--row_sizes", "1"))
    try:
        assert batcher.row_sizes == [1, 2]  # --batch appended
        # a bucket is 64 hops of 16 = 1024 samples: 0.03 s and 0.05 s share it
        assert shapes == [(1, 1024), (2, 1024), (1, 2048), (2, 2048)]
        assert isinstance(batcher.enhancer, BucketedEnhancer) and batcher._async
    finally:
        httpd.server_close()
        batcher.close()


@pytest.fixture(scope="module")
def tiny_server(tiny_ckpt):
    httpd, batcher = serve.build_server(_args(tiny_ckpt, "--batch", "2", "--max_wait_ms",
                                              "200"))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield httpd.server_address[:2], batcher
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=WAIT)


def _get(conn, path):
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, json.loads(r.read())


def test_http_healthz_stats_and_enhance(tiny_server):
    (host, port), batcher = tiny_server
    conn = http.client.HTTPConnection(host, port, timeout=WAIT)
    try:
        status, health = _get(conn, "/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["device"] == "cpu" and health["device_name"] == "cpu"
        assert health["dtype"] == "bfloat16" and health["row_sizes"] == [1, 2]
        assert (health["backbone_denoiser"], health["backbone_score"]) == ("ncsnpp", "ncsnpp")

        wav = encode_wav_bytes(wave(4000, 1))
        conn.request("POST", "/enhance", body=wav, headers={"Content-Type": "audio/wav"})
        r = conn.getresponse()
        assert r.status == 200, r.read()[:500]
        assert int(r.getheader("X-NFE")) == 2 and float(r.getheader("X-RTF")) > 0
        x, sr = decode_wav_bytes(r.read())
        assert sr == 16000 and x.shape == (1, 4000) and np.isfinite(x).all()

        status, stats = _get(conn, "/stats")
        assert status == 200 and stats["requests"] == 1 and stats["audio_s"] == 0.25
        assert stats["batches"] == 1 and stats["batch_fill"] == 1.0 and stats["errors"] == 0

        conn.request("POST", "/enhance", body=b"not a wav")
        r = conn.getresponse()
        assert r.status == 400 and "not a WAV" in json.loads(r.read())["error"]
        conn.request("POST", "/enhance", body=encode_wav_bytes(wave(100, 2), sr=8000))
        r = conn.getresponse()
        assert r.status == 400 and "sample rate" in json.loads(r.read())["error"]
        assert _get(conn, "/nowhere")[0] == 404
    finally:
        conn.close()


def test_batched_requests_equal_the_enhancer_on_the_same_batch(tiny_ckpt):
    """Two concurrent requests become one 2-row batch whose results are the
    enhancer's on that batch with the server's generator: the dispatcher
    alone draws the noise."""
    httpd, batcher = serve.build_server(_args(tiny_ckpt, "--batch", "2", "--max_wait_ms",
                                              "20000", "--seed", "3"))
    httpd.server_close()
    try:
        waves = [wave(900, 1), wave(1500, 2)]
        outs = _submit_concurrently(batcher, waves)
        assert batcher.stats["batches"] == 1 and batcher.stats["row_slots"] == 2
        ys = np.stack([np.pad(w, (0, 2048 - w.shape[0])) for w in waves])
        want, nfe = batcher.enhancer(ys, torch.Generator().manual_seed(3))
        for (x, n), w, row in zip(outs, waves, want):
            assert n == nfe == 2
            np.testing.assert_array_equal(x, row[: w.shape[0]])
    finally:
        batcher.close()


@pytest.mark.parametrize("extra,item", [
    (["--dtype", "float32", "--mode", "distill"], "incompatible"),
    (["--mode", "distill"], "incompatible"),
    pytest.param(["--data_parallel"], None, id="extra2-R7"),
    pytest.param(["--seq_parallel", "2"], "must divide", id="extra3-R7")])
def test_unported_flags_raise(tiny_ckpt, extra, item):
    """`--mode distill` on a StoRM checkpoint exits with the reference's
    message. The mesh flags are served (tests/test_torch_sp_serving.py): on
    the one CPU device `--data_parallel` serves one replica, and a
    `--seq_parallel` group of 2 raises the reference's "must divide"."""
    if item is None:
        httpd, batcher = serve.build_server(_args(tiny_ckpt, *extra))
        httpd.server_close()
        batcher.close()
        assert batcher.enhancer.devices == ["cpu"] and batcher.row_sizes == [8]
        return
    error = SystemExit if item == "incompatible" else ValueError
    with pytest.raises(error, match=item):
        serve.build_server(_args(tiny_ckpt, *extra))


def test_default_device_raises_without_a_card(tiny_ckpt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = serve.build_argparser().parse_args(["--ckpt", tiny_ckpt, "--mode", "storm",
                                               "--port", "0"])
    assert args.device == "cuda" and args.dtype == "bfloat16"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_server(args)


def test_main_serves_then_drains_on_sigterm(tiny_ckpt):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "storm_tpu_torch.serve", "--ckpt", tiny_ckpt, "--mode", "storm",
         "--N", "1", "--corrector", "none", "--port", "0", "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = ""
        deadline = time.monotonic() + WAIT
        while "serving on" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
        assert "serving on http://" in line, proc.stderr.read()[-2000:]
        port = int(line.split(":")[-1].split()[0].strip("/"))
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
        assert _get(conn, "/healthz")[0] == 200
        conn.close()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=WAIT)
        assert proc.returncode == 0, err[-2000:]
        assert "drained; bye" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=WAIT)
