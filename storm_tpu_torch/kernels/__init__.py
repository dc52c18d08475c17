"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

The op API (counterpart of `storm_tpu.kernels`): `upfirdn2d` (K1, both
directions), `fused_leaky_relu` (K2) and `quantize_int8` (K3). Each launches
its sm_90a kernel on a CUDA tensor and takes its plain version on a CPU
tensor.
"""
from .fused_act import fused_leaky_relu, fused_leaky_relu_plain
from .quant import quantize_int8, quantize_int8_plain
from .upfirdn import upfirdn2d, upfirdn2d_plain

__all__ = [
    "upfirdn2d",
    "upfirdn2d_plain",
    "fused_leaky_relu",
    "fused_leaky_relu_plain",
    "quantize_int8",
    "quantize_int8_plain",
]
