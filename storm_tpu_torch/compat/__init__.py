"""Reading checkpoints made outside the port: a reference Lightning `.ckpt`
(`torch_ckpt`, the `convert` CLI)."""
