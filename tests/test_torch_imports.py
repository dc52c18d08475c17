"""The port imports no JAX: neither jax, flax, orbax nor any storm_tpu module.

A subprocess installs a meta-path finder that refuses those names, then
imports every module of storm_tpu_torch and chip_smoke.py (its imports only:
the script's work runs under its __main__ guard).
"""
import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, runpy, sys

    BANNED = ("jax", "jaxlib", "flax", "orbax", "storm_tpu")
    refused = []

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BANNED:
                refused.append(name)
                raise ImportError(f"the port must not import {name}")
            return None

    for name in list(sys.modules):
        if name.split(".")[0] in BANNED:
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    import storm_tpu_torch
    modules = ["storm_tpu_torch"]
    for info in pkgutil.walk_packages(storm_tpu_torch.__path__, "storm_tpu_torch."):
        importlib.import_module(info.name)
        modules.append(info.name)
    runpy.run_path("chip_smoke.py", run_name="chip_smoke_imports_only")
    assert not refused, refused
    print("IMPORTED", len(modules), " ".join(sorted(modules)))
""")


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", GUARD], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("IMPORTED")][-1]
    names = line.split()[2:]
    for expected in ("storm_tpu_torch.kernels.upfirdn", "storm_tpu_torch.enhancement",
                     "storm_tpu_torch.models.storm", "storm_tpu_torch.convert",
                     "storm_tpu_torch.train", "storm_tpu_torch.data.datasets",
                     "storm_tpu_torch.data.loader", "storm_tpu_torch.data.datamodule",
                     "storm_tpu_torch.serve", "storm_tpu_torch.utils.inference",
                     "storm_tpu_torch.utils.server", "storm_tpu_torch.utils.streaming",
                     "storm_tpu_torch.utils.metrics", "storm_tpu_torch.utils.stoi",
                     "storm_tpu_torch.bench", "storm_tpu_torch.serve_load",
                     "storm_tpu_torch.evaluate", "storm_tpu_torch.utils.graphics",
                     "storm_tpu_torch.models.score", "storm_tpu_torch.models.discriminative",
                     "storm_tpu_torch.models.distill",
                     "storm_tpu_torch.scripts.make_synth_corpus",
                     "storm_tpu_torch.scripts.nfe_quality", "storm_tpu_torch.utils.graphs"):
        assert expected in names, names
