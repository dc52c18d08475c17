"""Port parity: STFT, iSTFT, spectrogram transform and padding against storm_tpu.signal.

Tolerance 1e-5 relative to the signal's scale: both sides are float32 DFT
matmuls whose sums run in different orders.
"""
import sys

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import assert_close_rel, tt

import storm_tpu.signal.stft  # noqa: F401
from storm_tpu.signal import transforms as jtr
from storm_tpu_torch.signal import stft as pstft
from storm_tpu_torch.signal import transforms as ptr

# storm_tpu.signal re-exports a function named `stft`, which hides the module
jstft = sys.modules["storm_tpu.signal.stft"]

SMALL = dict(n_fft=62, hop_length=16)


@pytest.mark.parametrize("cfg", [SMALL, {}], ids=["n_fft62", "default"])
@pytest.mark.parametrize("length", [500, 517])
def test_stft_real_matches(cfg, length):
    x = np.random.default_rng(length).standard_normal((2, length)).astype(np.float32)
    want = np.asarray(jstft.stft_real(jnp.asarray(x), jstft.STFTConfig(**cfg)))
    got = pstft.stft_real(tt(x), pstft.STFTConfig(**cfg)).numpy()
    assert_close_rel(got, want, 1e-5, "stft_real")


@pytest.mark.parametrize("length", [None, 300, 517, 700])
def test_istft_real_matches(length):
    cfg = SMALL
    spec = np.random.default_rng(1).standard_normal((2, 32, 33, 2)).astype(np.float32)
    want = np.asarray(jstft.istft_real(jnp.asarray(spec), jstft.STFTConfig(**cfg), length=length))
    got = pstft.istft_real(tt(spec), pstft.STFTConfig(**cfg), length=length).numpy()
    assert_close_rel(got, want, 1e-5, "istft_real")


@pytest.mark.parametrize("length", [512, 517, 1001])
def test_stft_roundtrip(length):
    cfg = pstft.STFTConfig(**SMALL)
    x = np.random.default_rng(2).standard_normal((3, length)).astype(np.float32)
    y = pstft.istft_real(pstft.stft_real(tt(x), cfg), cfg, length=length).numpy()
    assert_close_rel(y, x, 1e-5, "roundtrip")


def test_spec_transform_matches_with_exact_zeros():
    rng = np.random.default_rng(3)
    p = rng.standard_normal((2, 16, 20, 2)).astype(np.float32)
    p[0, :3, :4] = 0.0  # exact zeros take the safe-zero branch
    for kw in ({}, dict(factor=0.33, abs_exponent=0.5), dict(abs_exponent=1.0)):
        jt, pt = jtr.SpecTransform(**kw), ptr.SpecTransform(**kw)
        fwd = pt.forward_packed(tt(p)).numpy()
        assert_close_rel(fwd, np.asarray(jt.forward_packed(jnp.asarray(p))), 1e-5, "forward")
        assert np.all(fwd[0, :3, :4] == 0.0)
        bwd = pt.backward_packed(tt(p)).numpy()
        assert_close_rel(bwd, np.asarray(jt.backward_packed(jnp.asarray(p))), 1e-5, "backward")
        assert np.isfinite(bwd).all()


@pytest.mark.parametrize("frames,axis", [(20, -2), (64, -2), (65, -2), (33, -1)])
def test_pad_spec_matches(frames, axis):
    shape = (1, 8, frames, 2) if axis == -2 else (1, 8, frames)
    Y = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    want = np.asarray(jtr.pad_spec(jnp.asarray(Y), axis=axis))
    got = ptr.pad_spec(tt(Y), axis=axis).numpy()
    np.testing.assert_array_equal(got, want)
