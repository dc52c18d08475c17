"""Convert a checkpoint of the JAX package (an orbax directory with
config.json) into the PyTorch port's `.pt`.

    python tools/orbax_to_pt.py --ckpt runs/storm/checkpoints/best_loss --out best_loss.pt

It runs where JAX is installed, on the CPU: `storm_tpu.ckpt.load_checkpoint`
restores the state into a skeleton initialized at the config's frequency
bins (the JAX loader's own skeleton has 256 bins, which a GaGNet built for
another `fft_num` cannot take), `storm_tpu_torch.convert.params_from_jax` maps the raw
and the EMA parameters onto the port's state_dicts, checked against the
model the port builds from the same config, and
`storm_tpu_torch.ckpt.save_checkpoint` writes them with the config. A
GaGNet-BN side file `gagnet_batch_stats.json` in the directory is copied to
`<out>.gagnet_batch_stats.json`, the name the port's CLIs read; both hold
the same JSON. This is the one file besides the tests that imports both
packages.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
from typing import Optional, Sequence

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="checkpoint directory of the JAX package")
    ap.add_argument("--out", required=True, help="the port's .pt file to write")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from storm_tpu.ckpt import load_checkpoint, load_config
    from storm_tpu.models.factory import build_model as build_jax_model
    from storm_tpu_torch.ckpt import save_checkpoint
    from storm_tpu_torch.convert import params_from_jax
    from storm_tpu_torch.models.factory import build_model
    from storm_tpu_torch.utils.serving import batch_stats_path

    config = load_config(args.ckpt)
    bins = int(config.get("n_fft", 510)) // 2 + 1
    jmodel = build_jax_model(dict(config))
    skeleton = jax.jit(lambda key: jmodel.init_state(key, (1, bins, 64)))(jax.random.PRNGKey(0))
    config, state = load_checkpoint(args.ckpt, target=skeleton)
    target = build_model(dict(config), device="cpu")

    def to_numpy(tree):
        return jax.tree.map(lambda v: np.asarray(v, np.float32), jax.device_get(tree))

    params = params_from_jax(to_numpy(state.params), target=target)
    ema = params_from_jax(to_numpy(state.ema_params), target=target)
    save_checkpoint(args.out, config, params, ema, step=int(state.step))
    side = os.path.join(os.path.abspath(args.ckpt), "gagnet_batch_stats.json")
    if os.path.exists(side):
        shutil.copyfile(side, batch_stats_path(args.out))
        print(f"BatchNorm running stats copied to {batch_stats_path(args.out)}")
    n = sum(v.numel() for v in params.values())
    print(f"converted {args.ckpt} -> {args.out} ({n / 1e6:.2f}M params, "
          f"mode={config.get('mode', 'regen-joint-training')})")
    return args.out


if __name__ == "__main__":
    main()
