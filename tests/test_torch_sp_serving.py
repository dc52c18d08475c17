"""Sequence-parallel serving in the port: `BucketedEnhancer(seq_parallel=k)`
shards every NCSN++ net's activations along the frame axis over k devices
(nn/seqpar.py: halo exchange, cross-shard GroupNorm moments, attention with
gathered keys and values), composing with data parallelism on the rest.

Held against the reference's `BucketedEnhancer(seq_parallel=4)` on its
8-device CPU mesh (GSPMD's halo exchange) with its noise replayed and its
weights converted (StoRM, score-only, denoiser-only, distill; sp x dp;
sp x deepcache); against the port's unsharded serving, with unequal shards
too; layer by layer at k = 2, 3 and 4 (the last with unequal shards): the
halo conv (float32 and the int8 path), GroupNorm's moments (float32 and
bfloat16), attention, K1's plain version at (1, 2), (2, 1) and (1, 1) on
halo'd shards, and nets whose deepest level is narrower than its halo; and
the rules: "must divide", no async path, the CLI (B=1, --batch,
streaming) and the server.

Tolerances: against the reference 1e-4 of the output's scale (the port's
enhance parity tests'); sharded float32 against unsharded 1e-5 of the
output's scale (layers 1e-6: sums in another order); the int8 conv bit for
bit (the same codes and integer products); bfloat16 GroupNorm within one
bfloat16 ulp of each element (moments in float32, one rounding), or 1e-5 of
the output's scale where its terms cancel.
"""
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from test_torch_dp_serving import (
    CONFIGS,
    CPUS,
    KW,
    chunk_noise,
    ckpt_dir,  # noqa: F401 (a fixture)
    eight_cpus,
    pair,
    run_cli,
    waves,
)
from torch_parity import ReplayNoise, assert_close_rel

from storm_tpu.utils.inference import BucketedEnhancer as JBucketed
from storm_tpu_torch import enhancement, serve
from storm_tpu_torch.backbones.ncsnpp import NCSNpp, ShardedNCSNpp
from storm_tpu_torch.nn import seqpar
from storm_tpu_torch.nn.cast import cast_params
from storm_tpu_torch.nn.layers import (AttnBlockpp, Downsample, GroupNorm, Upsample, conv1x1,
                                       conv3x3)
from storm_tpu_torch.nn.qconv import quantizable_convs, scales_attached
from storm_tpu_torch.utils import inference
from storm_tpu_torch.utils.inference import BucketedEnhancer


def _against(mode, key, y, jkw, pkw, rows, chunks, n_steps=KW["N"], corrector="ald"):
    """(port, reference) outputs of one configuration with the same draws;
    the port's unsharded serving from the same draws checked within 1e-5."""
    jmodel, params, pmodel = pair(mode)
    want, jnfe = JBucketed(jmodel, params, **jkw)(y, key)
    draws = chunk_noise(mode, key, rows, chunks, n_steps, corrector)
    noise = ReplayNoise(draws)
    got, nfe = BucketedEnhancer(pmodel, devices=CPUS, **pkw)(y, noise=noise)
    assert noise.exhausted() and nfe == int(jnfe)
    plain_kw = {k: v for k, v in pkw.items() if k not in ("seq_parallel", "data_parallel")}
    plain, nfe0 = BucketedEnhancer(pmodel, **plain_kw)(y, noise=ReplayNoise(draws))
    assert nfe0 == nfe
    assert_close_rel(got, plain, 1e-5, f"{mode}: sharded against unsharded")
    return got, np.asarray(want)


@pytest.mark.parametrize("mode", list(CONFIGS))
def test_sp_matches_reference_mesh(mode):
    """seq_parallel=4, one utterance per call (two calls)."""
    kw = dict(KW, minibatch=1, seq_parallel=4)
    got, want = _against(mode, jax.random.PRNGKey(1), waves(2), kw, kw, 1, 2)
    assert_close_rel(got, want, 1e-4, f"{mode}: seq parallel against the reference")


def test_sp_composes_with_dp():
    """Two replicas of four shards each (8 devices / seq 4), two rows per call."""
    kw = dict(KW, minibatch=2, seq_parallel=4, data_parallel=True)
    got, want = _against("storm", jax.random.PRNGKey(2), waves(4, seed=3), kw, kw, 2, 2)
    assert_close_rel(got, want, 1e-4, "sp x dp against the reference")


def test_sp_composes_with_deepcache():
    """The deep-feature cache stays sharded between the refreshes."""
    kw = dict(KW, N=4, corrector="none", minibatch=1, seq_parallel=4, deepcache=2)
    got, want = _against("storm", jax.random.PRNGKey(4), waves(1, seed=5), kw, kw, 1, 1,
                         n_steps=4, corrector="none")
    assert_close_rel(got, want, 1e-4, "sp x deepcache against the reference")


def test_sp_unequal_shards_match_unsharded():
    """Three shards of a 192-frame spec (coarsest level 96: 32 frames each)
    and five (coarsest 96 frames: 20, 19, 19, 19, 19, unequal) in a group
    of 5 devices, against unsharded serving."""
    _, _, pmodel = pair("storm")
    y = waves(1, seed=6)
    want, _ = BucketedEnhancer(pmodel, minibatch=1, **KW)(y, torch.Generator().manual_seed(9))
    for k in (3, 5):
        got, _ = BucketedEnhancer(pmodel, minibatch=1, seq_parallel=k, devices=["cpu"] * k,
                                  **KW)(y, torch.Generator().manual_seed(9))
        assert_close_rel(got, want, 1e-5, f"{k} shards against unsharded")


# --- layer by layer


def _split(x, widths):
    owner = torch.nn.Identity()  # the layers' own modules serve every part
    ctx = seqpar.ShardContext(["cpu"] * len(widths), owner, [owner] * len(widths))
    return seqpar.Sharded(seqpar.scatter(x, widths, ["cpu"] * len(widths), dim=-1), ctx)


def _joined(s):
    return seqpar.gather(s.parts, torch.device("cpu"), dim=-1)


WIDTHS = {2: [16, 16], 3: [12, 10, 10], 4: [10, 8, 8, 6]}  # k = 4: unequal


def _init(module, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    return module


@pytest.mark.parametrize("k", [2, 3, 4])
def test_halo_conv_float32_and_int8(k):
    x = torch.randn(2, 8, 6, 32, generator=torch.Generator().manual_seed(k))
    for conv in (_init(conv3x3(8, 12)), _init(conv1x1(8, 12))):
        assert_close_rel(_joined(conv(_split(x, WIDTHS[k]))).detach(), conv(x).detach(), 1e-6,
                         f"halo conv k={k}")
        with torch.no_grad(), scales_attached(conv, {"": 0.05}):
            assert torch.equal(_joined(conv(_split(x, WIDTHS[k]))), conv(x))


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_moments_across_shards(k, dtype):
    gn = _init(GroupNorm(4, 16, eps=1e-6))
    with torch.no_grad():
        gn.weight.add_(1.0)
    x = (3.0 + torch.randn(2, 16, 6, 32, generator=torch.Generator().manual_seed(k))).to(dtype)
    mean, var = seqpar.group_norm_moments(_split(x, WIDTHS[k]), 4)
    v, m = torch.var_mean(x.float().reshape(2, 4, -1), dim=-1, correction=0)
    assert_close_rel(mean, m, 1e-6, "means")
    assert_close_rel(var, v, 1e-5, "variances")
    with torch.no_grad():
        got, want = _joined(gn(_split(x, WIDTHS[k]))).float(), gn(x).float()
    if dtype == torch.float32:
        assert_close_rel(got, want, 1e-6, f"GroupNorm k={k}")
    else:  # float32 moments, one rounding: an ulp of the element apart at most, or
        # float32 rounding of the moments where x * mul and add cancel
        bound = torch.clamp(want.abs() * 2.0 ** -7, min=1e-5 * float(want.abs().max()))
        assert bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("k", [2, 3, 4])
def test_attention_with_gathered_keys_and_values(k):
    blk = _init(AttnBlockpp(16, skip_rescale=True))
    x = torch.randn(2, 16, 4, 32, generator=torch.Generator().manual_seed(k))
    with torch.no_grad():
        assert_close_rel(_joined(blk(_split(x, WIDTHS[k]))), blk(x), 1e-6, f"attention k={k}")


@pytest.mark.parametrize("k", [2, 3, 4])
def test_k1_resamplers_on_halod_shards(k):
    """K1's plain version at (1, 2) and (2, 1) (the pyramids' resamplers),
    and the stride-1 instance inside the resamplers with a 3x3 conv, on
    shards whose widths are even (as frame_widths makes them)."""
    widths = [2 * w for w in WIDTHS[k]]
    x = torch.randn(1, 4, 8, 64, generator=torch.Generator().manual_seed(k))
    for resampler in (Downsample(fir=True), Upsample(fir=True),
                      _init(Downsample(4, 6, with_conv=True, fir=True)),
                      _init(Upsample(4, 6, with_conv=True, fir=True)),
                      _init(Downsample(4, 6, with_conv=True, fir=False)),
                      Downsample(fir=False)):
        with torch.no_grad():
            got, want = _joined(resampler(_split(x, widths))), resampler(x)
        assert_close_rel(got, want, 1e-6, f"{type(resampler).__name__} k={k}")


@pytest.mark.parametrize("kw,k", [
    (dict(ch_mult=(1, 2, 2, 2, 2), attn_resolutions=(4,)), 3),  # deepest: 2, 1, 1 frames
    (dict(ch_mult=(1, 1, 2, 2, 2), num_res_blocks=2, attn_resolutions=(8,),
          resblock_type="ddpm", progressive="residual", progressive_input="residual"), 3),
    (dict(ch_mult=(1, 2), fir=False, resblock_type="ddpm", progressive="residual",
          progressive_input="residual", embedding_type="positional"), 4),
])
def test_nets_narrower_than_their_halo(kw, k):
    """Nets whose deepest level's shards are narrower than a resampler's
    halo of 2 frames (an ncsnpplarge-like net with attention, a DDPM +
    residual one with the stride-1 instance), and the plain resamplers with
    the positional embedding, sharded against whole: forward, and the
    deep-feature cache's split."""
    net = _init(NCSNpp(nf=8, image_size=32, init_scale=1.0, **kw), seed=1).eval()
    x = torch.randn(2, 2, 32, 64, 2, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([0.3, 0.9])
    with torch.no_grad():
        want = net(x, t)
        sharded = ShardedNCSNpp(net, ["cpu"] * k)
        assert_close_rel(sharded(x, t), want, 1e-5, f"{kw} k={k}")
        if kw.get("resblock_type", "biggan") == "biggan":
            cache = sharded.deep_features(x, t, cache_depth=2)
            assert_close_rel(sharded.forward_shallow(x, t, cache, cache_depth=2), want, 1e-5,
                             "deep-feature cache over shards")


def test_replicas_take_the_nets_weights_casts_and_scales():
    """Each part runs its own replica's modules (here copies on the CPU):
    weights copied in at every call, bfloat16 casts and int8 scales attached
    for the call only."""
    net = _init(NCSNpp(nf=8, ch_mult=(1, 2), image_size=32, init_scale=1.0,
                       dtype=torch.bfloat16), seed=3).eval()
    copies = [net, seqpar.replica(net, torch.device("cpu"))]
    x = torch.randn(1, 2, 32, 64, 2, generator=torch.Generator().manual_seed(4))
    t = torch.tensor([0.5])
    convs = {n: 0.1 for n, m in net.named_modules() if type(m).__name__ == "Conv2d"}
    replica_convs = quantizable_convs(copies[1]).values()
    with torch.no_grad(), cast_params(net, torch.bfloat16), scales_attached(net, convs):
        want = ShardedNCSNpp(net, ["cpu"] * 2)(x, t)  # the net's own modules for both parts
        sharded = ShardedNCSNpp(net, ["cpu"] * 2, nets=copies)
        with mock.patch.dict(net.__dict__, {"_seq_parallel": {("cpu", "cpu"): sharded}}):
            with ShardedNCSNpp.serving(net, ["cpu", "cpu"]) as s:
                assert s is sharded and s.replicas() == [copies[1]]
                assert [c.a_scale for c in replica_convs] == [
                    c.a_scale for c in quantizable_convs(net).values()] != [None] * len(convs)
                assert all("_cast" in c.__dict__ for c in replica_convs)
                got = s(x, t)
    assert all(c.a_scale is None and "_cast" not in c.__dict__ for c in replica_convs)
    assert torch.equal(got, want)


# --- the rules


def test_sp_rules():
    _, _, pmodel = pair("storm")
    with pytest.raises(ValueError, match="must divide"):
        BucketedEnhancer(pmodel, seq_parallel=3, devices=CPUS, **KW)
    sp = BucketedEnhancer(pmodel, seq_parallel=4, devices=CPUS, **KW)
    assert sp.minibatch == 1 and len(sp.replicas) == 1 and not sp.supports_async
    assert sp.replicas[0][1]["shards"] == tuple(CPUS[:4]) and sp.execution == "graph"
    spdp = BucketedEnhancer(pmodel, minibatch=3, seq_parallel=2, data_parallel=True,
                            devices=CPUS, **KW)
    assert spdp.minibatch == 4 and [g for g in spdp.groups] == [("cpu", "cpu")] * 4


def test_cli_seq_parallel_batch_and_streaming(ckpt_dir):
    """`--seq_parallel 4` through the CLI at B=1, with `--batch 2`, and
    streaming (8 chunks a call), each against the same CLI unsharded."""
    root, ckpt = ckpt_dir
    for extra in ([], ["--batch", "2"], ["--batch", "8", "--stream_chunk_s", "0.06",
                                         "--stream_overlap_s", "0.01"]):
        want = run_cli(root, ckpt, "plain", *extra)
        with mock.patch.object(inference, "serving_devices", eight_cpus):
            got = run_cli(root, ckpt, "sp", "--seq_parallel", "4", *extra)
        for f in want:
            assert_close_rel(got[f], want[f], 1e-5, f"--seq_parallel 4 {extra} {f}")
    with pytest.raises(ValueError, match="must divide"), \
            mock.patch.object(inference, "serving_devices", eight_cpus):
        enhancement.main(["--test_dir", str(root / "noisy"), "--enhanced_dir", str(root / "x"),
                          "--ckpt", ckpt, "--mode", "storm", "--device", "cpu",
                          "--seq_parallel", "3"])


def test_server_sp_x_dp_mode(ckpt_dir):
    root, ckpt = ckpt_dir
    args = serve.build_argparser().parse_args(
        ["--ckpt", ckpt, "--mode", "storm", "--N", "1", "--corrector", "none", "--port", "0",
         "--device", "cpu", "--batch", "1", "--seq_parallel", "4", "--data_parallel",
         "--warmup_s", "0.1"])
    with mock.patch.object(inference, "serving_devices", eight_cpus):
        httpd, batcher = serve.build_server(args)
    try:
        assert batcher.row_sizes == [2] and batcher.enhancer.minibatch == 2
        assert batcher.enhancer.groups == [tuple(CPUS[:4]), tuple(CPUS[4:])]
        x, nfe = batcher.submit(np.zeros(900, np.float32) + 0.01, timeout=60)
        assert x.shape == (900,) and nfe == 2 and np.isfinite(x).all()
    finally:
        httpd.server_close()
        batcher.close()
