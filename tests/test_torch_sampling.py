"""Port parity: pc_sample against storm_tpu.sampling.samplers.pc_sample with
the reference's noise replayed (its key schedule drawn with jax.random and
handed to the port's noise source in the same order).

The score is a fixed analytic function, the same in both, so the test holds
the sampler's grid, step rules, noise order and NFE. Tolerance 1e-5 relative:
float32 updates accumulated over a few steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import ReplayNoise, assert_close_rel, jax_noise_schedule, tt

from storm_tpu.sampling.samplers import pc_sample as jpc_sample
from storm_tpu.sde.sdes import OUVESDE as JOUVE
from storm_tpu_torch.sampling.samplers import pc_sample as ppc_sample
from storm_tpu_torch.sde.sdes import OUVESDE as POUVE


def _score(x, t, y):
    return -(x - y) * (1.0 + t)[:, None, None, None]


@pytest.mark.parametrize("predictor,corrector,steps", [
    ("reverse_diffusion", "ald", 1),
    ("reverse_diffusion", "none", 1),
    ("reverse_diffusion", "ald", 2),
    ("euler_maruyama", "langevin", 1),
    ("none", "ald", 1),
])
def test_pc_sample_replayed_noise(predictor, corrector, steps):
    N = 4
    y = np.random.default_rng(0).standard_normal((2, 8, 6, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want, nfe_j = jpc_sample(key, JOUVE(), _score, jnp.asarray(y), predictor=predictor,
                             corrector=corrector, N=N, corrector_steps=steps, eps=0.03)
    noise = ReplayNoise(jax_noise_schedule(key, y.shape[:-1], N, predictor, corrector, steps))
    got, nfe_p = ppc_sample(POUVE(), _score, tt(y), predictor=predictor, corrector=corrector,
                            N=N, corrector_steps=steps, eps=0.03, noise=noise)
    assert noise.exhausted()
    assert nfe_p == nfe_j == N * (steps * (corrector != "none") + 1)
    assert_close_rel(got.numpy(), np.asarray(want), 1e-5, f"{predictor}/{corrector}")
