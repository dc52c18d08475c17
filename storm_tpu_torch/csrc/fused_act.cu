// Fused bias + leaky ReLU for Hopper (sm_90a), bias on the last axis:
//   h = x + bias[c],  out = scale * (h >= 0 ? h : slope * h),
// on a contiguous float32 (..., C) tensor; optionally also the 1-byte mask
// (h >= 0) that the gradient needs.
//
// Replaces the Pallas kernel `fused_leaky_relu_pallas`
// (storm_tpu/kernels/fused_act.py, `pl.pallas_call` over the whole (rows, C)
// array in VMEM); the mask is what the custom VJP's forward (`_fla_fwd`)
// keeps. The arithmetic is the reference expression's, in the same order:
// one add, the slope product on the negative side, then the scale product.
//
// Bound: memory. Four operations per element, far below the card's rate,
// so the least time is the bytes over 3.35 TB/s: 8 per element (x in, out),
// 9 with the mask. The design: a grid-stride loop in which each thread moves
// 16 bytes of x and of out per step (4 elements of one row, as C % 4 == 0)
// and the 4 mask bytes in one write; other shapes and unaligned tensors go
// one element at a time. The bias (C floats) stays in L1. Indices are 32-bit:
// the wrapper refuses tensors of 2^31 elements or more.
//
// C interface for ctypes: returns cudaGetLastError() after the launch (0 on
// success). `mask` may be null.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float act(float h, float slope, float scale) {
  return scale * (h >= 0.f ? h : slope * h);
}

template <bool MASK>
__global__ void fused_leaky_relu_kernel(const float* __restrict__ x,
                                        const float* __restrict__ bias,
                                        float* __restrict__ out, uint8_t* __restrict__ mask,
                                        unsigned n, unsigned C, float slope, float scale,
                                        int vectorized) {
  const unsigned stride = gridDim.x * blockDim.x;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned done = 0;
  if (vectorized) {
    const unsigned nvec = n / 4;
    for (unsigned v = tid; v < nvec; v += stride) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(x) + v);
      const unsigned c = (4 * v) % C;  // C % 4 == 0: the 4 elements share a row
      const float h[4] = {xv.x + __ldg(bias + c), xv.y + __ldg(bias + c + 1),
                          xv.z + __ldg(bias + c + 2), xv.w + __ldg(bias + c + 3)};
      reinterpret_cast<float4*>(out)[v] =
          make_float4(act(h[0], slope, scale), act(h[1], slope, scale),
                      act(h[2], slope, scale), act(h[3], slope, scale));
      if constexpr (MASK) {
        reinterpret_cast<uint32_t*>(mask)[v] =
            (uint32_t)(h[0] >= 0.f) | (uint32_t)(h[1] >= 0.f) << 8 |
            (uint32_t)(h[2] >= 0.f) << 16 | (uint32_t)(h[3] >= 0.f) << 24;
      }
    }
    done = nvec * 4;
  }
  for (unsigned i = done + tid; i < n; i += stride) {
    const float h = __ldg(x + i) + __ldg(bias + i % C);
    out[i] = act(h, slope, scale);
    if constexpr (MASK) mask[i] = h >= 0.f;
  }
}

}  // namespace

extern "C" int storm_fused_leaky_relu_f32(const void* x, const void* bias, void* out,
                                          void* mask, long long n, int C, float slope,
                                          float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C <= 0 || n < 0 || n % C != 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int vectorized = C % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(mask) % 4 == 0;
  const int threads = 256;
  const long long work = vectorized ? (n + 3) / 4 : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // the loop does the rest
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  if (mask != nullptr) {
    fused_leaky_relu_kernel<true><<<(int)blocks, threads, 0, s>>>(
        xi, b, o, static_cast<uint8_t*>(mask), (unsigned)n, (unsigned)C, slope, scale,
        vectorized);
  } else {
    fused_leaky_relu_kernel<false><<<(int)blocks, threads, 0, s>>>(
        xi, b, o, nullptr, (unsigned)n, (unsigned)C, slope, scale, vectorized);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* storm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
