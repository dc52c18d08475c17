"""Per-tensor int8 quantizer: q = int8(clip(round(x * inv), -127, 127)), with the
product in float32 or in bfloat16.

Replaces the Pallas TPU kernel `qkernel` (scripts/perf_fusion_probe.py, its
`pl.pallas_call` over (TILE, 128) row blocks) with a CUDA kernel written for
sm_90a (`csrc/quantize_int8.cu`). It is the activation quantizer of the int8
W8A8 serving path: `QuantizableConv` (`nn/qconv.py`) calls it once per
quantized conv with inv = 1 / a_scale, 55 times per forward of a full-width
NCSN++ at the 128-channel threshold.

Bound on the card: memory, (input bytes + 1 byte per element) / 3.35 TB/s.
`round` is half to even (`jnp.round`, CUDA `rintf`) and the clip comes
before the cast. `product` is the type the product is formed in, the
compute dtype of the reference's qconv (storm_tpu/nn/qconv.py:143-146):
float32 (`qkernel`'s, for float32 and bfloat16 inputs alike) or bfloat16,
where x and inv are each rounded to bfloat16 and so is their product.

`quantize_int8` dispatches on the tensor's device: a CUDA tensor launches
the kernel (or raises), a CPU tensor takes `quantize_int8_plain`.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

# the kernel's codes for the input's type and for the product's (its mode)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_int8_plain(x: torch.Tensor, inv: float,
                        product: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: the product in `product`, round half to even,
    clip to [-127, 127], cast. (The product of two float32 values is exact
    in double, and of two bfloat16 values in float32, so it rounds to the
    product in `product` however the scalar is promoted.)"""
    inv = np.float32(inv)
    if product == torch.bfloat16:
        inv = torch.tensor(inv).to(torch.bfloat16).item()  # inv.astype(bf16)
    v = x.to(product) * float(inv)
    return torch.round(v).clamp_(-127.0, 127.0).to(torch.int8)


def _check_contract(x: torch.Tensor, product: torch.dtype) -> None:
    """Raise unless the kernel takes `x` and `product`; the CPU path checks
    them too, so a CPU run refuses what a card would."""
    if x.dtype not in _DTYPES:
        raise ValueError(f"quantize_int8: float32 or bfloat16 only, got {x.dtype}")
    if product not in _DTYPES:
        raise ValueError(f"quantize_int8: a float32 or bfloat16 product only, got {product}")
    if not x.is_contiguous():
        raise ValueError("quantize_int8: input must be contiguous")
    if x.numel() == 0:  # a sharded caller skips a part with no frames (nn/seqpar.py)
        raise ValueError(f"quantize_int8: an input of no elements {tuple(x.shape)}")


def _lib() -> ctypes.CDLL:
    lib = build.load("quantize_int8")
    fn = lib.storm_quantize_int8
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def quantize_int8_cuda(x: torch.Tensor, inv: float,
                       product: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch the sm_90a kernel on a contiguous float32 or bfloat16 CUDA
    tensor; `inv` travels by value as a float32 (the C entry rounds it to
    bfloat16 for a bfloat16 product)."""
    if not x.is_cuda:
        raise ValueError("quantize_int8_cuda: input must be a CUDA tensor")
    _check_contract(x, product)
    out = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    lib = _lib()
    err = lib.storm_quantize_int8(x.data_ptr(), out.data_ptr(), x.numel(), _DTYPES[x.dtype],
                                  _DTYPES[product], float(np.float32(inv)), x.device.index,
                                  torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "quantize_int8_cuda")
    quantize_int8_cuda.launches += 1
    return out


# kernel launches since the caller last set it to 0
quantize_int8_cuda.launches = 0


def quantize_int8(x: torch.Tensor, inv: float,
                  product: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return quantize_int8_cuda(x, inv, product)
    if x.device.type != "cpu":
        raise ValueError(f"quantize_int8: no implementation for device {x.device}")
    _check_contract(x, product)
    return quantize_int8_plain(x, inv, product)
