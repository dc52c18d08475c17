"""StoRM speech enhancement in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package `storm_tpu`, which stays in the repository as the
reference. The port imports neither JAX nor `storm_tpu`: everything it needs
lives in this package. Public boundaries keep the reference's conventions so
both can be compared one to one:

- waveforms are (B, T) float32;
- spectrograms are packed-real (..., F, T, 2) with (real, imag) last;
- NCSN++ takes (B, Cc, F, T, 2) and returns (B, D, F, T, 2).

Inside NCSN++ tensors are NCHW. FIR resampling (upfirdn2d) runs as a CUDA
kernel written for sm_90a (`kernels/upfirdn.py`, `csrc/upfirdn2d.cu`); a
tensor on the CPU takes the kernel's plain PyTorch version instead.

Entry points take an explicit `device`, defaulting to "cuda".
"""
