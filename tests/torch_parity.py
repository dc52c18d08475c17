"""Shared helpers for the port's parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
results come back as numpy arrays. Everything runs on the CPU, in float32
unless a test says bfloat16: then the values handed over are bfloat16 values
held in float32 arrays, exact in both types.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from storm_tpu.signal import cplx as jcplx

torch.set_num_threads(1)


def tt(a) -> torch.Tensor:
    """numpy/JAX array -> float32 CPU tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32, order="C"))


def nhwc(a: torch.Tensor) -> np.ndarray:
    """NCHW tensor -> NHWC numpy (the reference layout)."""
    return a.detach().numpy().transpose(0, 2, 3, 1)


def nchw(a) -> torch.Tensor:
    """NHWC array -> NCHW tensor."""
    return tt(np.asarray(a).transpose(0, 3, 1, 2))


def to_numpy_tree(tree):
    return jax.tree.map(lambda v: np.asarray(v, np.float32), tree)


def perturb_tree(tree, seed: int = 0, scale: float = 0.05):
    """Add noise to biases and norm scales, so that a mapping error in them
    shows (they start as exact zeros and ones)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            else:
                v = np.asarray(v, np.float32)
                if k in ("bias", "scale", "b"):
                    v = v + scale * rng.standard_normal(v.shape).astype(np.float32)
                out[k] = v
        return out

    return walk(tree)


def jax_noise_schedule(key, shape, n_steps, predictor="reverse_diffusion",
                       corrector="ald", corrector_steps=1):
    """The standard complex normal draws of the reference `pc_sample`, in the
    order they are consumed: the prior, then per step the corrector's draws
    and the predictor's (storm_tpu/sampling/samplers.py, correctors.py)."""
    zs = []
    key, kprior = jax.random.split(key)
    zs.append(jcplx.complex_normal(kprior, shape))
    k = key
    for _ in range(n_steps):
        k, kc, kp = jax.random.split(k, 3)
        if corrector != "none":
            for _ in range(corrector_steps):
                kc, kz = jax.random.split(kc)
                zs.append(jcplx.complex_normal(kz, shape))
        if predictor != "none":
            zs.append(jcplx.complex_normal(kp, shape))
    return [np.asarray(z, np.float32) for z in zs]


class ReplayNoise:
    """A port noise source that hands out pre-drawn arrays in order."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.used = 0

    def __call__(self, shape):
        z = self.draws[self.used]
        assert tuple(z.shape) == tuple(shape) + (2,), (z.shape, shape)
        self.used += 1
        return tt(z)

    def exhausted(self) -> bool:
        return self.used == len(self.draws)


def assert_close_rel(got, want, rtol, what=""):
    """|got - want| <= rtol * max|want| elementwise (a tolerance relative to
    the tensor's scale, for sums whose order differs between frameworks)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{what}: max abs err {err:.3e} > {rtol} * {scale:.3e}"


def bf16_values(a) -> np.ndarray:
    """`a` rounded to bfloat16 (to nearest even), as a float32 numpy array."""
    return np.asarray(jnp.asarray(np.asarray(a, np.float32)).astype(jnp.bfloat16)
                      .astype(jnp.float32))


def bf16_ulp(scale: float) -> float:
    """One bfloat16 ulp at `scale`: 2^-7 of its leading power of two."""
    return float(2.0 ** (np.floor(np.log2(scale)) - 7))


def ulps_of_scale(got, want) -> float:
    """max |got - want| in bfloat16 ulps of max |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / bf16_ulp(np.abs(want).max()))


def random_params(shapes, seed: int = 0):
    """Weights for a reference parameter tree of the shapes in `shapes` (from
    `jax.eval_shape` of an init: the tree without running the reference's
    initialisers, which take most of a test's time on the CPU), drawn with
    numpy in the tree's order: fan-in scaled kernels, the Fourier features'
    W at scale 16, biases and norm scales near 0 and 1."""
    rng = np.random.default_rng(seed)

    def draw(name, s):
        z = rng.standard_normal(s).astype(np.float32)
        if name == "W" and len(s) == 1:
            return 16.0 * z
        if name in ("kernel", "W"):
            return z / np.sqrt(np.prod(s[:-1]))
        return (1.0 if name == "scale" else 0.0) + 0.05 * z

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else draw(k, v.shape) for k, v in tree.items()}

    return walk(shapes)
