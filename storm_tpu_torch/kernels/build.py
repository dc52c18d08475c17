"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own into
`storm_tpu_torch/_build/lib<name>-<digest>.so` (a git-ignored directory),
where the digest covers the source and the flags, so an edited source is
rebuilt and an unchanged one is reused. Several sources build in parallel:
one nvcc process each, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

# every CUDA source of the port; a new kernel adds its name here
SOURCES = ("upfirdn2d", "quantize_int8", "fused_act")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME, else the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that has no current library.

    Returns {name: compiler output} for the sources compiled now (with
    `-Xptxas -v` it lists registers, shared memory and spills per kernel).
    """
    BUILD_DIR.mkdir(exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out)
    logs = {}
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
        logs[name] = log
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed. Every
    source exports `storm_cuda_error_string(int) -> const char*`."""
    if name not in _loaded:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.storm_cuda_error_string.argtypes = [ctypes.c_int]
        lib.storm_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return _loaded[name]


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise unless a C entry point returned 0 (cudaSuccess) for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed: "
                           + lib.storm_cuda_error_string(err).decode())
