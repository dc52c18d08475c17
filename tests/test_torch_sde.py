"""Port parity: OUVE SDE and its reverse against storm_tpu.sde.sdes.

Tolerance 1e-5 relative: the same float32 closed forms, evaluated by two
libraries' exp/pow.
"""
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity import assert_close_rel, tt

from storm_tpu.sde.sdes import OUVESDE as JOUVE
from storm_tpu_torch.sde.sdes import OUVESDE as POUVE
from storm_tpu_torch.utils.tensors import batch_broadcast, right_pad_dims

RNG = np.random.default_rng(0)
X = RNG.standard_normal((3, 8, 10, 2)).astype(np.float32)
Y = RNG.standard_normal((3, 8, 10, 2)).astype(np.float32)
Z = RNG.standard_normal((3, 8, 10, 2)).astype(np.float32)
T = np.asarray([0.03, 0.5, 1.0], np.float32)


def _pair():
    kw = dict(theta=1.5, sigma_min=0.05, sigma_max=0.5, N=30)
    return JOUVE(**kw), POUVE(**kw)


def test_forward_sde_closed_forms():
    j, p = _pair()
    jx, jy, jt = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(T)
    px, py, pt = tt(X), tt(Y), tt(T)
    for a, b in zip(j.sde(jx, jt, jy), p.sde(px, pt, py)):
        assert_close_rel(b.numpy(), np.asarray(a), 1e-5, "sde")
    assert_close_rel(p._std(pt).numpy(), np.asarray(j._std(jt)), 1e-5, "_std")
    for a, b in zip(j.marginal_prob(jx, jt, jy), p.marginal_prob(px, pt, py)):
        assert_close_rel(b.numpy(), np.asarray(a), 1e-5, "marginal_prob")
    for a, b in zip(j.discretize(jx, jt, jy), p.discretize(px, pt, py)):
        assert_close_rel(b.numpy(), np.asarray(a), 1e-5, "discretize")


def test_prior_sampling_with_injected_noise():
    j, p = _pair()
    z = Z / np.sqrt(2.0)
    # the reference draws z inside; rebuild its formula from its own _std
    std_T = np.asarray(j._std(jnp.ones(3)))
    want = Y + z * std_T[:, None, None, None]
    got = p.prior_sampling(tt(Y), tt(z)).numpy()
    assert_close_rel(got, want, 1e-5, "prior_sampling")


def test_reverse_sde_matches():
    j, p = _pair()
    jscore = lambda x, t, y: -(x - y) * (1.0 + t)[:, None, None, None]  # noqa: E731
    pscore = lambda x, t, y: -(x - y) * (1.0 + t)[:, None, None, None]  # noqa: E731
    for pf in (False, True):
        jr, pr = j.reverse(jscore, pf), p.reverse(pscore, pf)
        jx, jy, jt = jnp.asarray(X), jnp.asarray(Y), jnp.asarray(T)
        px, py, pt = tt(X), tt(Y), tt(T)
        for a, b in zip(jr.sde(jx, jt, jy), pr.sde(px, pt, py)):
            assert_close_rel(b.numpy(), np.asarray(a), 1e-5, f"rsde.sde pf={pf}")
        for a, b in zip(jr.discretize(jx, jt, jy), pr.discretize(px, pt, py)):
            assert_close_rel(b.numpy(), np.asarray(a), 1e-5, f"rsde.discretize pf={pf}")


def test_tensor_helpers():
    x = torch.zeros(3, 4, 5)
    assert right_pad_dims(torch.ones(3), x).shape == (3, 1, 1)
    assert batch_broadcast(2.0, x).shape == (1, 1, 1)
    assert batch_broadcast(torch.ones(3), x).shape == (3, 1, 1)
