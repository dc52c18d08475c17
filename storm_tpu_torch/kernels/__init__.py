"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

The op API (counterpart of `storm_tpu.kernels`): `upfirdn2d` (K1, both
directions), `fused_leaky_relu` (K2) and `quantize_int8` (K3). Each launches
its sm_90a kernel on a CUDA tensor and takes its plain version on a CPU
tensor.

`LAUNCH_COUNTERS`: every CUDA wrapper, each counting its launches in its
`launches` attribute (a captured graph's replays add theirs there too).
"""
from .fused_act import fused_leaky_relu, fused_leaky_relu_cuda, fused_leaky_relu_plain
from .quant import quantize_int8, quantize_int8_cuda, quantize_int8_plain
from .upfirdn import upfirdn2d, upfirdn2d_bwd_cuda, upfirdn2d_cuda, upfirdn2d_plain

LAUNCH_COUNTERS = (upfirdn2d_cuda, upfirdn2d_bwd_cuda, quantize_int8_cuda,
                   fused_leaky_relu_cuda)

__all__ = [
    "upfirdn2d",
    "upfirdn2d_plain",
    "fused_leaky_relu",
    "fused_leaky_relu_plain",
    "quantize_int8",
    "quantize_int8_plain",
    "LAUNCH_COUNTERS",
]
