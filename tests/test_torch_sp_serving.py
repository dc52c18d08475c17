"""Sequence-parallel serving in the port: `BucketedEnhancer(seq_parallel=k)`
shards every NCSN++ net's activations along the frame axis over k devices
(nn/seqpar.py: halo exchange, cross-shard GroupNorm moments, attention with
gathered keys and values), composing with data parallelism on the rest.

Held against the reference's `BucketedEnhancer(seq_parallel=4)` on its
8-device CPU mesh (GSPMD's halo exchange) with its noise replayed and its
weights converted (StoRM, score-only, denoiser-only, distill; sp x dp;
sp x deepcache), and with more shards than the coarsest level holds frames
(parts that start on odd frames, and parts with no frames at the deep
levels); against the port's unsharded serving, with unequal shards too; the
shard plan (`seqpar.FramePlan`); layer by layer at k = 2, 3 and 4 (the last
with unequal shards) and on parts that start on odd frames, are empty or
are narrower than any halo: the halo conv (float32 and the int8 path),
GroupNorm's moments (float32 and bfloat16), attention, K1's plain version at
(1, 2), (2, 1) and (1, 1) on halo'd shards, and nets whose deepest level is
narrower than its halo; and the rules: "must divide", no async path, the
CLI (B=1, --batch, streaming) and the server.

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
    LENGTH,
    chunk_noise,
    ckpt_dir,  # noqa: F401 (a fixture)
    eight_cpus,
    frames,
    pair,
    run_cli,
    waves,
)
from test_torch_inference import random_params, wave
from torch_parity import ReplayNoise, assert_close_rel

from storm_tpu.models.factory import build_model as jbuild
from storm_tpu.utils.inference import BucketedEnhancer as JBucketed
from storm_tpu_torch import enhancement, serve
from storm_tpu_torch.backbones.ncsnpp import NCSNpp, ShardedNCSNpp
from storm_tpu_torch.convert import params_from_jax
from storm_tpu_torch.kernels.quant import quantize_int8
from storm_tpu_torch.kernels.upfirdn import upfirdn2d
from storm_tpu_torch.models.factory import build_model as pbuild
from storm_tpu_torch.nn import seqpar
from storm_tpu_torch.nn.cast import cast_params
from storm_tpu_torch.nn.layers import (AttnBlockpp, Downsample, GroupNorm, Upsample, conv1x1,
                                       conv3x3)
from storm_tpu_torch.nn.qconv import quantizable_convs, scales_attached
from storm_tpu_torch.nn.resample import setup_kernel
from storm_tpu_torch.utils import inference
from storm_tpu_torch.utils.inference import BucketedEnhancer


def _against(mode, key, y, jkw, pkw, rows, chunks, n_steps=KW["N"], corrector="ald",
             models=None, spec=(32, None)):
    """(port, reference) outputs of one configuration with the same draws;
    the port's unsharded serving from the same draws checked within 1e-5.
    `models`: another (reference, params, port) than `pair(mode)`'s, whose
    draws are of `spec` (`chunk_noise`)."""
    jmodel, params, pmodel = models or pair(mode)
    want, jnfe = JBucketed(jmodel, params, **jkw)(y, key)
    draws = chunk_noise(mode, key, rows, chunks, n_steps, corrector, spec)
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


def _pair_of(cfg, seed):
    """(reference model, random weights, the port model with them) of `cfg`."""
    jmodel = jbuild(dict(cfg))
    params = random_params(jmodel, (1, cfg["n_fft"] // 2 + 1, 64), seed=seed)
    pmodel = pbuild(dict(cfg), device="cpu")
    pmodel.load_state_dict(params_from_jax(params, target=pmodel), strict=True)
    return jmodel, params, pmodel


@pytest.mark.parametrize("mode,cfg,length,k", [
    # the reference runs it and the port refused it: 6 frames at the coarsest
    # level (192 / 32) for 8 shards
    ("score-only", dict(CONFIGS["score-only"], nf=8, ch_mult=[1] * 6), LENGTH, 8),
    # 1 frame at the coarsest level (64 / 64; 64 bins take 7 levels) for 4 shards
    ("storm", dict(CONFIGS["storm"], nf=8, ch_mult=[1] * 7, n_fft=126), 700, 4),
], ids=["score-only-192-frames-8-shards", "storm-64-frames-4-shards"])
def test_sp_with_more_shards_than_coarse_frames(mode, cfg, length, k):
    """More shards than the coarsest level holds frames: parts that start on
    odd frames and parts with no frames at the deep levels, against the
    reference mesh and the port's unsharded serving."""
    models = _pair_of(cfg, seed=11)
    levels, T = len(cfg["ch_mult"]), frames(length)
    plan = seqpar.FramePlan.of(T, levels, k)
    assert T >> (levels - 1) < k and 0 in plan.widths(T >> (levels - 1))
    kw = dict(KW, minibatch=1, seq_parallel=k)
    y = np.stack([wave(length, 21)])
    got, want = _against(mode, jax.random.PRNGKey(6), y, kw, kw, 1, 1, models=models,
                         spec=(cfg["n_fft"] // 2 + 1, T))
    assert_close_rel(got, want, 1e-4, f"{mode}: {k} shards of {T} frames against the reference")


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


def _split(x, top, levels=1):
    """x cut at its level of the plan whose top level has the widths `top`."""
    owner = torch.nn.Identity()  # the layers' own modules serve every part
    ctx = seqpar.ShardContext(["cpu"] * len(top), owner, [owner] * len(top))
    plan = seqpar.FramePlan(top, levels)
    parts = seqpar.scatter(x, plan.widths(x.shape[-1]), ["cpu"] * len(top), dim=-1)
    return seqpar.Sharded(parts, ctx, plan)


def _joined(s):
    return seqpar.gather(s.parts, torch.device("cpu"), dim=-1)


# 32 frames; k = 4: unequal; "odd": a part that starts on frame 5 and an
# empty one; "narrow": parts of 1 frame, narrower than any halo
WIDTHS = {2: [16, 16], 3: [12, 10, 10], 4: [10, 8, 8, 6], "odd": [5, 0, 11, 16],
          "narrow": [1, 1, 29, 1]}
KS = list(WIDTHS)
# the resamplers' plans: 128 frames at the top, the input at 64, the down
# output at 32. The k cases are whole halvings; "odd" starts parts on odd
# frames at every level (64 frames: 5, 1, 27, 31; 32: 3, 0, 14, 15) and
# "narrow" has a part empty at the input's level that is not at the up
# output's (64 frames: 1, 1, 0, 62; 128: 2, 1, 1, 124)
def _seed(k):
    return k if isinstance(k, int) else 10 + KS.index(k)


RESAMPLED = {**{k: [4 * w for w in WIDTHS[k]] for k in (2, 3, 4)}, "odd": [10, 2, 53, 63],
             "narrow": [2, 1, 1, 124]}


def test_frame_plan_nests_and_leaves_deep_parts_empty():
    """The plan: the coarse-aligned split wherever the coarsest level holds
    the shards (the partition the port served before, bit for bit), else
    the top level split evenly; each level's boundaries the finer level's
    halved and rounded up; parts empty where the coarse frames run out."""
    assert seqpar.frame_widths(576, 7, 4) == [192, 128, 128, 128]  # 9 coarse: 3, 2, 2, 2
    assert seqpar.frame_widths(192, 4, 5) == [40, 40, 40, 40, 32]  # 24 coarse: 5, 5, 5, 5, 4
    assert seqpar.frame_widths(192, 6, 8) == [24] * 8
    assert seqpar.frame_widths(64, 2, 80) == [1] * 64 + [0] * 16
    plan = seqpar.FramePlan.of(64, 7, 4)  # ncsnpplarge at a 64-frame bucket
    assert [plan.widths(64 >> lv) for lv in range(7)] == [
        [16] * 4, [8] * 4, [4] * 4, [2] * 4, [1] * 4, [1, 0, 1, 0], [1, 0, 0, 0]]
    for T, levels, k in ((64, 7, 4), (128, 7, 8), (192, 6, 8), (576, 7, 4), (256, 4, 3)):
        plan = seqpar.FramePlan.of(T, levels, k)
        for lv in range(levels - 1):
            fine, coarse = plan.bounds(T >> lv), plan.bounds(T >> (lv + 1))
            assert coarse == tuple(-(-b // 2) for b in fine)
            assert coarse[0] == 0 and coarse[-1] == T >> (lv + 1)
        if (T >> (levels - 1)) >= k:  # every boundary a multiple of 2^(levels - 1)
            assert all(b % (1 << (levels - 1)) == 0 for b in plan.bounds(T))
    with pytest.raises(ValueError, match="no level"):
        plan.bounds(7)


def _init(module, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=g))
    return module


@pytest.mark.parametrize("k", KS)
def test_halo_conv_float32_and_int8(k):
    x = torch.randn(2, 8, 6, 32, generator=torch.Generator().manual_seed(_seed(k)))
    for conv in (_init(conv3x3(8, 12)), _init(conv1x1(8, 12))):
        assert_close_rel(_joined(conv(_split(x, WIDTHS[k]))).detach(), conv(x).detach(), 1e-6,
                         f"halo conv k={k}")
        with torch.no_grad(), scales_attached(conv, {"": 0.05}):
            assert torch.equal(_joined(conv(_split(x, WIDTHS[k]))), conv(x))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_moments_across_shards(k, dtype):
    gn = _init(GroupNorm(4, 16, eps=1e-6))
    with torch.no_grad():
        gn.weight.add_(1.0)
    g = torch.Generator().manual_seed(_seed(k))
    x = (3.0 + torch.randn(2, 16, 6, 32, generator=g)).to(dtype)
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


@pytest.mark.parametrize("k", KS)
def test_attention_with_gathered_keys_and_values(k):
    blk = _init(AttnBlockpp(16, skip_rescale=True))
    x = torch.randn(2, 16, 4, 32, generator=torch.Generator().manual_seed(_seed(k)))
    with torch.no_grad():
        assert_close_rel(_joined(blk(_split(x, WIDTHS[k]))), blk(x), 1e-6, f"attention k={k}")


@pytest.mark.parametrize("k", KS)
def test_k1_resamplers_on_halod_shards(k):
    """K1's plain version at (1, 2) and (2, 1) (the pyramids' resamplers),
    and the stride-1 instance inside the resamplers with a 3x3 conv, on
    shards of whole halvings (k), on parts that start on odd frames or are
    empty (RESAMPLED); each output part at its level's boundaries, and no
    call for an empty one."""
    x = torch.randn(1, 4, 8, 64, generator=torch.Generator().manual_seed(_seed(k)))
    for resampler in (Downsample(fir=True), Upsample(fir=True),
                      _init(Downsample(4, 6, with_conv=True, fir=True)),
                      _init(Upsample(4, 6, with_conv=True, fir=True)),
                      _init(Downsample(4, 6, with_conv=True, fir=False)),
                      Downsample(fir=False)):
        before = seqpar.Sharded.empty_parts
        with torch.no_grad():
            sharded = resampler(_split(x, RESAMPLED[k], levels=3))
            got, want = _joined(sharded), resampler(x)
        assert sharded.widths == sharded.plan.widths(want.shape[-1])
        assert seqpar.Sharded.empty_parts - before == sharded.widths.count(0)
        assert_close_rel(got, want, 1e-6, f"{type(resampler).__name__} k={k}")


def test_k1_and_k3_refuse_an_input_of_no_elements():
    """A sharded op skips an empty part (`halo_map` calls nothing for it);
    the kernels' wrappers refuse one on every device, before a launch or a
    count, rather than meet it at a grid of 0."""
    empty = torch.zeros(1, 4, 8, 0)
    with pytest.raises(ValueError, match="no elements"):
        upfirdn2d(empty, setup_kernel((1, 3, 3, 1)), up=1, down=1, pad=(2, 2))
    with pytest.raises(ValueError, match="no elements"):
        quantize_int8(empty, 10.0)


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
