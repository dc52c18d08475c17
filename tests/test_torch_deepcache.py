"""Deep-feature caching in the port against the reference's
(storm_tpu/backbones/ncsnpp.py `deep_features` / `forward_shallow`,
models/base.py `make_deepcache_fns`, samplers.py `pc_sample` with a
`DeepCache`): the cache split of NCSN++, the cached sampler, `enhance` in float32, int8
and bfloat16 with the reference's noise replayed, streaming, the CLI and the
server.

Tiny sizes: NCSN++ with nf 16 and three levels (so that cache_depth 2
resumes below the top and a wrong module index cannot pass on matching
channel counts), StoRM at n_fft 62. Tolerances: the port's own cache split
bit for bit (the shallow pass reruns the very operations of the full
forward); against the reference 1e-4 relative to the output's scale, as in
test_torch_ncsnpp and test_torch_storm; int8 conv outputs 1e-5 of their
scale at every quantized conv call, as in test_torch_inference; bfloat16 in
the whole-net ratio form of test_torch_bf16 (RATIO, REALLY).
"""
import glob
import http.client
import json
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bf16 import REALLY, _ratios
from test_torch_inference import (
    STORM_TINY,
    random_params,
    tiny_storm_pair,
    wave,
)
from test_torch_quant import MIN_CH, _flax_node, _recorded_calls
from torch_parity import ReplayNoise, assert_close_rel, jax_noise_schedule, nchw, nhwc, tt
from torch_parity import random_params as tree_params

from storm_tpu.backbones.ncsnpp import NCSNpp as JNCSNpp
from storm_tpu.models import quant as jquant
from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.nn.qconv import QuantizableConv as JConv
from storm_tpu_torch import enhancement, serve
from storm_tpu_torch.backbones.ncsnpp import NCSNpp
from storm_tpu_torch.ckpt import save_checkpoint
from storm_tpu_torch.convert import module_params_from_jax, params_from_jax
from storm_tpu_torch.data.audio import load_wav, save_wav
from storm_tpu_torch.models import quant as pquant
from storm_tpu_torch.models.base import check_deepcache_config, make_deepcache_fns
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.nn.qconv import scales_attached
from storm_tpu_torch.sampling.samplers import DeepCache, pc_sample
from storm_tpu_torch.utils.inference import BucketedEnhancer
from storm_tpu_torch.utils.server import decode_wav_bytes, encode_wav_bytes
from storm_tpu_torch.utils.streaming import stream_enhance

F = 32  # frequency bins at n_fft 62
NET = dict(nf=16, ch_mult=(1, 2, 2), init_scale=1.0, input_channels=6)
NETS = {"plain": {}, "attn": dict(image_size=32, attn_resolutions=(16,))}  # attention at level 1
WAIT = 60  # seconds: the bound of every wait in this file


def _net_case(variant):
    kw = dict(NET, **NETS[variant])
    rng = np.random.default_rng(0)
    x = (0.5 * rng.standard_normal((2, 3, 32, 64, 2))).astype(np.float32)
    t = np.asarray([0.3, 0.8], np.float32)
    jnet = JNCSNpp.from_kwargs(**kw)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(t))["params"]
    params = tree_params(shapes, seed=1)
    pnet = NCSNpp.from_kwargs(**kw).eval()
    pnet.load_state_dict(module_params_from_jax(params), strict=True)
    return jnet, params, pnet, x, t


# --- NCSN++: the cache split


@pytest.mark.parametrize("variant", sorted(NETS))
@pytest.mark.parametrize("depth", [1, 2])
def test_shallow_of_deep_is_the_forward_bit_for_bit(variant, depth):
    _, _, pnet, x, t = _net_case(variant)
    with torch.no_grad():
        full = pnet(tt(x), tt(t))
        cache = pnet.deep_features(tt(x), tt(t), cache_depth=depth)
        shallow = pnet.forward_shallow(tt(x), tt(t), cache, cache_depth=depth)
    # (h, pyramid) at the entry of up level depth - 1: its width and channels
    h, pyramid = cache
    assert h.shape == (2, 16 * NET["ch_mult"][depth], 32 >> (depth - 1), 64 >> (depth - 1))
    assert pyramid.shape == (2, 6, 32 >> depth, 64 >> depth)
    torch.testing.assert_close(shallow, full, rtol=0, atol=0)


@pytest.mark.parametrize("variant", sorted(NETS))
@pytest.mark.parametrize("depth", [1, 2])
def test_deep_and_shallow_match_reference(variant, depth):
    """The port's cache against the reference's, and the port's shallow pass
    on the reference's cache against the reference's shallow pass."""
    jnet, params, pnet, x, t = _net_case(variant)
    v = {"params": params}
    jx, jt = jnp.asarray(x), jnp.asarray(t)
    jcache = jax.jit(lambda v, x, t: jnet.apply(v, x, t, method="deep_features",
                                                cache_depth=depth))(v, jx, jt)
    jshallow = jax.jit(lambda v, x, t, c: jnet.apply(v, x, t, method="forward_shallow", cache=c,
                                                     cache_depth=depth))(v, jx, jt, jcache)
    with torch.no_grad():
        cache = pnet.deep_features(tt(x), tt(t), cache_depth=depth)
        shallow = pnet.forward_shallow(tt(x), tt(t), tuple(nchw(c) for c in jcache),
                                       cache_depth=depth)
    for name, got, want in zip(("h", "pyramid"), cache, jcache):
        assert_close_rel(nhwc(got), np.asarray(want), 1e-4, f"cache {name}")
    assert_close_rel(shallow.numpy(), np.asarray(jshallow), 1e-4, "forward_shallow")


def test_cache_depth_bounds_are_refused():
    pnet = NCSNpp.from_kwargs(**NET).eval()
    x, t = torch.zeros(1, 3, 32, 64, 2), torch.ones(1)
    assert NCSNpp.SUPPORTS_DEEPCACHE
    with torch.no_grad():
        for depth in (0, 3):
            with pytest.raises(ValueError, match=r"cache_depth must be in \[1, 2\]"):
                pnet.deep_features(x, t, cache_depth=depth)
        cache = pnet.deep_features(x, t, cache_depth=1)
        with pytest.raises(ValueError, match="cache_depth"):
            pnet.forward_shallow(x, t, cache, cache_depth=3)


def test_deepcache_config_refusals():
    pnet = NCSNpp.from_kwargs(**NET)
    with pytest.raises(ValueError, match="deepcache must be >= 0"):
        check_deepcache_config(pnet, -1, "pc")
    with pytest.raises(ValueError, match="pc or ode"):
        check_deepcache_config(pnet, 2, "picard")
    with pytest.raises(ValueError, match="does not support the cache split"):
        check_deepcache_config(torch.nn.Linear(2, 2), 2, "pc")
    with pytest.raises(ValueError, match="cache_depth"):
        check_deepcache_config(pnet, 2, "pc", cache_depth=3)
    check_deepcache_config(pnet, 2, "pc", cache_depth=2)

    # enhance refuses before any work: the denoiser never runs
    model = pbuild(dict(STORM_TINY), device="cpu")
    ran = []
    model.denoiser_net.register_forward_pre_hook(lambda *a: ran.append(1))
    y = torch.from_numpy(wave(1024, 0)[None])
    for kw in ({"deepcache": -1}, {"deepcache": 2, "deepcache_depth": 3},
               {"deepcache": 2, "deepcache_depth": 0}):
        with pytest.raises(ValueError):
            model.enhance(y, N=2, **kw)
    assert not ran


# --- the sampler and `enhance`


@pytest.fixture(scope="module")
def pair():
    return tiny_storm_pair(seed=5)


def test_pc_deepcache1_without_corrector_is_the_exact_trajectory(pair):
    """Interval 1 and no corrector: every predictor evaluation reads a cache
    made at its own (x, t), so the trajectory is the exact one, bit for bit;
    nfe is unchanged (refreshes are not counted)."""
    _, _, pmodel = pair
    y = torch.from_numpy(wave(2000, 1)[None])
    runs = {dc: pmodel.enhance(y, N=4, corrector="none", deepcache=dc,
                               generator=torch.Generator().manual_seed(3))
            for dc in (0, 1)}
    assert runs[0][1] == runs[1][1] == 1 + 4
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=0)


def test_refresh_schedule(pair):
    """The cache is made at the prior (t = T) and refreshed at the top of
    every step i with i % K == 0 and i > 0, before the corrector, at that
    step's (x, t); the corrector's and the predictor's evaluations read the
    newest cache; the noise is drawn as without the cache."""
    _, _, pmodel = pair
    events = []

    def deep_fn(x, t):
        events.append(("refresh", round(float(t[0]), 4), x.clone()))
        return len([e for e in events if e[0] == "refresh"])

    def cached_score_fn(x, t, cache):
        events.append(("eval", cache, x.clone()))
        return torch.zeros_like(x)

    draws = []

    def noise(shape):
        draws.append(shape)
        return torch.randn(shape + (2,), generator=gen)

    gen = torch.Generator().manual_seed(0)
    y = torch.randn(1, F, 64, 2, generator=gen)
    N, K = 7, 3
    pc_sample(pmodel.sde, None, y, corrector="ald", N=N, noise=noise,
              deepcache=DeepCache(K, deep_fn, cached_score_fn))
    ts = [round(t, 4) for t in torch.linspace(pmodel.sde.T, 0.03, N).tolist()]
    want, cache = [], 0
    for i in range(N):
        if i % K == 0:
            cache += 1
            want.append(("refresh", ts[i]))
        want += [("eval", cache), ("eval", cache)]  # corrector, then predictor
    assert [e[:2] for e in events] == want
    # each refresh sees the x the step's corrector evaluates
    for j, e in enumerate(events):
        if e[0] == "refresh":
            torch.testing.assert_close(e[2], events[j + 1][2], rtol=0, atol=0)
    assert len(draws) == 1 + 2 * N


@pytest.mark.parametrize("depth", [1, 2])
def test_enhance_dc3_ald_matches_reference(pair, depth):
    """dc=3 + ald at N=6, float32, against the reference's make_enhance with
    its noise replayed (the cached path draws exactly what the exact one
    draws)."""
    jmodel, params, pmodel = pair
    N, T = 6, 1500  # 94 frames, padded to 128
    y = wave(T, 2)[None]
    key = jax.random.PRNGKey(9)
    want, jnfe = jmodel.make_enhance(N=N, corrector="ald", deepcache=3,
                                     deepcache_depth=depth)(params, jnp.asarray(y), key)
    noise = ReplayNoise(jax_noise_schedule(key, (1, F, 128), N, corrector="ald"))
    got, nfe = pmodel.enhance(tt(y), N=N, corrector="ald", deepcache=3, deepcache_depth=depth,
                              noise=noise)
    assert noise.exhausted() and nfe == int(jnfe) == 1 + 2 * N
    assert_close_rel(got.numpy(), np.asarray(want), 1e-4, f"enhance dc3 depth {depth}")


def test_int8_dc3_matches_reference_per_conv_call(pair, tmp_path):
    """int8 + dc3 through the enhancer: every quantized conv call of the deep
    and shallow passes held to the reference's QuantizableConv with the same
    scales on the input the port gave it, and the calls counted pass by
    pass: the denoiser's 41, one deep pass at the prior and one per refresh,
    a shallow pass per score evaluation."""
    jmodel, params, pmodel = pair
    N, T, K = 6, 700, 3
    pq = pquant.calibrate_storm(pmodel, tt(wave(1024, 8)[None]), N=1, min_channels=MIN_CH,
                                generator=torch.Generator().manual_seed(1))
    pquant.save_scales(str(tmp_path / "scales.json"), pq, meta=None)
    quant = jax.tree_util.tree_map(jnp.float32, jquant.load_scales(str(tmp_path / "scales.json")))

    # the quantized convs each kind of pass runs, from one pass of each
    net = pmodel.score_net
    x5 = torch.zeros(1, 3, F, 128, 2)
    t1 = torch.ones(1)
    per_pass = {}
    with torch.no_grad(), scales_attached(net, pq["score"]):
        for kind, fn in (("deep", lambda: net.deep_features(x5, t1)),
                         ("shallow", lambda: net.forward_shallow(x5, t1, net.deep_features(
                             x5, t1)))):
            calls, hooks = _recorded_calls({"score": (net, pq["score"])})
            try:
                fn()
            finally:
                for h in hooks:
                    h.remove()
            per_pass[kind] = [name for _, name, _, _ in calls]
    shallow = per_pass["shallow"][len(per_pass["deep"]):]
    # the shallow pass reruns level 0's down resblock: the two share its convs only
    assert set(per_pass["deep"]) | set(shallow) == set(pq["score"])
    assert sorted(set(per_pass["deep"]) & set(shallow)) == [
        "all_modules.4.Conv_0", "all_modules.4.Conv_1"]

    calls, hooks = _recorded_calls({n: (getattr(pmodel, f"{n}_net"), pq[n])
                                    for n in ("denoiser", "score")})
    try:
        got, nfe = BucketedEnhancer(pmodel, N=N, corrector="ald", quant=pq, deepcache=K)(
            wave(T, 7), torch.Generator().manual_seed(0))
    finally:
        for h in hooks:
            h.remove()
    assert got.shape == (T,) and np.isfinite(got).all() and nfe == 1 + 2 * N
    deep_passes = 1 + len([i for i in range(N) if i % K == 0 and i > 0])
    assert len(calls) == 41 + deep_passes * len(per_pass["deep"]) + 2 * N * len(shallow)
    jconvs = {}
    for n, name, x, out in calls:
        conv = _flax_node(params[n], name)
        k, cout = conv["kernel"].shape[0], conv["kernel"].shape[-1]
        if (k, cout) not in jconvs:
            jconvs[k, cout] = jax.jit(JConv(cout, (k, k), padding=[(k // 2, k // 2)] * 2).apply)
        ref = jconvs[k, cout]({"params": conv, "quant": _flax_node(quant[n], name)},
                              jnp.asarray(nhwc(x)))
        assert_close_rel(nhwc(out), np.asarray(ref), 1e-5, f"{n} {name}")


# max|port_bf16 - reference_bf16| <= RATIO_DC3 * max|reference_bf16 - reference_f32|
# for a dc3 trajectory of six steps. The argument of test_torch_bf16's RATIO
# (two independent bfloat16 roundings of one program sit about sqrt(2)
# apart) holds, but over six steps the maximum spreads more than over
# test_torch_bf16's three. Measured at N=6 on seeds 2, 3, 4 of the weights:
# the exact trajectory 1.42, 1.01, 1.33; dc3 1.63, 0.90, 1.37 (this test:
# seed 2). The cache adds no disagreement beyond the exact path's spread;
# REALLY still fails a path that runs in float32.
RATIO_DC3 = 2.0


def test_bf16_dc3_matches_reference_in_ratio_form():
    """dc=3 + ald at N=6 in bfloat16 against the reference's in bfloat16,
    with the reference's noise: the port and the reference part by bfloat16's
    own noise (RATIO_DC3), and the port's bfloat16 run parts from its
    float32 run (REALLY: it fails if the cache or the net ran in float32).
    The cache is carried in bfloat16, as the reference carries it."""
    config = dict(STORM_TINY)
    jmodel = jbuild(dict(config))
    params = random_params(jmodel, (1, 32, 64), seed=2)
    N, T = 6, 700
    y = wave(T, 0)[None]
    key = jax.random.PRNGKey(5)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        want, _ = jbuild(dict(config, dtype=dtype)).make_enhance(
            N=N, corrector="ald", deepcache=3)(params, jnp.asarray(y), key)
        pmodel = pbuild(dict(config, dtype=dtype), device="cpu")
        pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
        noise = ReplayNoise(jax_noise_schedule(key, (1, F, 64), N, corrector="ald"))
        got, nfe = pmodel.enhance(tt(y), N=N, corrector="ald", deepcache=3, noise=noise)
        assert noise.exhausted() and nfe == 1 + 2 * N and got.dtype == torch.float32
        runs[dtype] = (got.numpy(), np.asarray(want))
        with torch.no_grad(), pmodel.cast_nets():
            h, pyramid = pmodel.score_net.deep_features(torch.zeros(1, 3, F, 64, 2),
                                                        torch.ones(1))
        assert h.dtype == pyramid.dtype == getattr(torch, dtype)
    against_ref, really = _ratios(runs["bfloat16"][0], runs["float32"][0],
                                  runs["bfloat16"][1], runs["float32"][1])
    assert against_ref <= RATIO_DC3, against_ref
    assert really >= REALLY, really


def test_make_deepcache_fns_packs_like_forward_score(pair):
    """The deep and shallow calls see the score input forward_score packs
    ([x, Y, D(Y)]), and the cached score is -out, squeezed like x."""
    _, _, pmodel = pair
    g = torch.Generator().manual_seed(0)
    x, Y, D = (torch.randn(2, F, 64, 2, generator=g) for _ in range(3))
    t = torch.tensor([0.4, 0.9])
    deep_fn, cached = make_deepcache_fns(
        pmodel.score_net, lambda x: pmodel._score_input(x, [Y, D]), 1)
    with torch.no_grad():
        got = cached(x, t, deep_fn(x, t))
        want = pmodel.forward_score(x, t, [Y, D])
    assert got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- streaming, the CLI, the server


def test_streaming_over_a_dc1_enhancer_equals_streaming_without(pair):
    _, _, pmodel = pair
    y = (0.1 * np.random.default_rng(3).standard_normal(6000)).astype(np.float32)
    kw = dict(chunk_samples=2048, overlap_samples=512, max_batch=4)
    outs = {}
    for dc in (0, 1):
        enh = BucketedEnhancer(pmodel, minibatch=4, N=3, corrector="none", deepcache=dc)
        outs[dc] = stream_enhance(enh, y, torch.Generator().manual_seed(4), **kw)
    assert outs[0][1] == outs[1][1]
    np.testing.assert_array_equal(outs[1][0], outs[0][0])


@pytest.fixture(scope="module")
def tiny_files(tmp_path_factory, pair):
    root = tmp_path_factory.mktemp("dc")
    ckpt = str(root / "tiny.pt")
    save_checkpoint(ckpt, STORM_TINY, pair[2].state_dict())
    noisy = root / "noisy"
    noisy.mkdir()
    lengths = {"a.wav": 900, "b.wav": 1531, "c.wav": 2600}
    for name, n in lengths.items():
        save_wav(str(noisy / name), wave(n, n))
    return ckpt, str(noisy), lengths


@pytest.mark.parametrize("extra", [
    [], ["--batch", "2"], ["--stream_chunk_s", "0.1", "--stream_overlap_s", "0.02"],
    ["--quant", "int8", "--quant_min_channels", str(MIN_CH), "--dtype", "bfloat16"]],
    ids=["whole", "batch", "stream", "int8-bf16"])
def test_cli_deepcache(pair, tiny_files, tmp_path, capsys, extra):
    """`--deepcache 3` on the CPU with each serving mode: every file written,
    finite, of its length; NFE 1 + 2N; whole files equal the enhancer's at
    dc3 with the CLI's generator."""
    ckpt, noisy, lengths = tiny_files
    out = tmp_path / "out"
    ckpt_copy = str(tmp_path / "tiny.pt")  # int8 writes its scales beside the checkpoint
    os.link(ckpt, ckpt_copy)
    enhancement.main(["--test_dir", noisy, "--enhanced_dir", str(out), "--ckpt", ckpt_copy,
                      "--mode", "storm", "--N", "3", "--device", "cpu", "--timeit",
                      "--deepcache", "3", *extra])
    text = capsys.readouterr().out
    assert sorted(os.path.basename(p) for p in glob.glob(str(out / "*.wav"))) == sorted(lengths)
    for name, n in lengths.items():
        x, sr = load_wav(str(out / name))
        assert sr == 16000 and x.shape == (1, n) and np.isfinite(x).all()
    nfes = {int(v) for v in re.findall(r"nfe=(\d+)", text)}
    assert nfes <= {7, 14, 21} and nfes, text  # 1 + 2 x 3 per call, summed over stream calls
    if not extra:
        gen = torch.Generator().manual_seed(0)
        enh = BucketedEnhancer(pair[2], N=3, corrector="ald", deepcache=3)
        for name in sorted(lengths):
            want, _ = enh(load_wav(os.path.join(noisy, name))[0][0], gen)
            save_wav(str(tmp_path / name), want, 16000)  # the CLI's 16-bit writer
            np.testing.assert_array_equal(load_wav(str(out / name))[0],
                                          load_wav(str(tmp_path / name))[0])


def test_cli_refuses_a_bad_deepcache_depth(tiny_files, tmp_path):
    ckpt, noisy, _ = tiny_files
    with pytest.raises(ValueError, match="cache_depth"):
        enhancement.main(["--test_dir", noisy, "--enhanced_dir", str(tmp_path / "o"), "--ckpt",
                          ckpt, "--mode", "storm", "--device", "cpu", "--deepcache", "3",
                          "--deepcache_depth", "3"])


def _serve_args(ckpt, *extra):
    return serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--N", "2", "--port", "0", "--device", "cpu",
         "--batch", "2", "--max_wait_ms", "100", *extra])


def test_server_serves_deepcache_and_reports_it(tiny_files):
    ckpt, _, _ = tiny_files
    with pytest.raises(ValueError, match="cache_depth"):
        serve.build_server(_serve_args(ckpt, "--deepcache", "3", "--deepcache_depth", "5"))
    httpd, batcher = serve.build_server(_serve_args(ckpt, "--deepcache", "3",
                                                    "--deepcache_depth", "2"))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        assert batcher.enhancer.enhance_kwargs["deepcache"] == 3
        host, port = httpd.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=WAIT)
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["deepcache"] == 3 and health["deepcache_depth"] == 2
        conn.request("POST", "/enhance", body=encode_wav_bytes(wave(3000, 1)))
        r = conn.getresponse()
        assert r.status == 200 and int(r.getheader("X-NFE")) == 1 + 2 * 2
        x, sr = decode_wav_bytes(r.read())
        assert x.shape == (1, 3000) and np.isfinite(x).all()
        conn.close()
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.close()
        thread.join(timeout=WAIT)
    assert not thread.is_alive()
