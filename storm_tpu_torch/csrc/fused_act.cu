// Fused bias + leaky ReLU for Hopper (sm_90a), bias on the last axis:
//   h = x + bias[c],  out = scale * (h >= 0 ? h : slope * h),
// on a contiguous (..., C) tensor of float32 or bfloat16 (x, bias and out of
// one type); optionally also the 1-byte mask (h >= 0) that the gradient needs.
//
// Replaces the Pallas kernel `fused_leaky_relu_pallas`
// (storm_tpu/kernels/fused_act.py, `pl.pallas_call` over the whole (rows, C)
// array in VMEM); the mask is what the custom VJP's forward (`_fla_fwd`)
// keeps. The arithmetic is the reference expression's, in the same order:
// one add, the slope product on the negative side, then the scale product.
// In bfloat16 the reference rounds each of the three to bfloat16 (its
// Python scalars are rounded to bfloat16 first, as JAX's weak typing does;
// the wrapper passes them so): here each is computed in float32, where the
// sum or product of two bfloat16 values is exact or rounds below half a
// bfloat16 ulp, and rounded to nearest even at once, so the kernel equals the
// reference bit for bit. The mask is the sign of the rounded h.
//
// Bound: memory. Four operations per element, far below the card's rate,
// so the least time is the bytes over 3.35 TB/s: x in and out once (8 bytes
// per float32 element, 4 per bfloat16), plus 1 with the mask. The design: a
// grid-stride loop in which each thread moves 16 bytes of x and of out per
// step (4 float32 or 8 bfloat16 elements of one row, as C is a multiple of
// 4 or 8) and their mask bytes in one write; other shapes and unaligned
// tensors go one element at a time. The bias (C values) stays in L1.
// Indices are 32-bit: the wrapper refuses tensors of 2^31 elements or more.
//
// C interface for ctypes: returns cudaGetLastError() after the launch (0 on
// success). `mask` may be null. dtype 0 is float32, 1 bfloat16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <class T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

// v rounded to T's precision, as a float: a no-op for float32
template <class T>
__device__ __forceinline__ float rnd(float v) { return to_float(from_float<T>(v)); }

// one element: its output in T and (through `pos`) the sign of h
template <class T>
__device__ __forceinline__ T act(T x, T b, float slope, float scale, bool* pos) {
  const float h = rnd<T>(to_float(x) + to_float(b));
  *pos = h >= 0.f;
  return from_float<T>(scale * (*pos ? h : rnd<T>(slope * h)));
}

template <class T, bool MASK>
__global__ void fused_leaky_relu_kernel(const T* __restrict__ x, const T* __restrict__ bias,
                                        T* __restrict__ out, uint8_t* __restrict__ mask,
                                        unsigned n, unsigned C, float slope, float scale,
                                        int vectorized) {
  constexpr unsigned V = 16 / sizeof(T);  // elements per 16-byte step
  const unsigned stride = gridDim.x * blockDim.x;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned done = 0;
  if (vectorized) {
    const unsigned nvec = n / V;
    for (unsigned v = tid; v < nvec; v += stride) {
      const uint4 xraw = __ldg(reinterpret_cast<const uint4*>(x) + v);
      const T* xv = reinterpret_cast<const T*>(&xraw);
      const unsigned c = (V * v) % C;  // C % V == 0: the V elements share a row
      uint4 oraw;
      T* ov = reinterpret_cast<T*>(&oraw);
      unsigned long long bits = 0;
#pragma unroll
      for (unsigned j = 0; j < V; ++j) {
        bool pos;
        ov[j] = act<T>(xv[j], bias[c + j], slope, scale, &pos);
        bits |= (unsigned long long)pos << (8 * j);
      }
      reinterpret_cast<uint4*>(out)[v] = oraw;
      if constexpr (MASK) {
        if constexpr (V == 4) {
          reinterpret_cast<uint32_t*>(mask)[v] = (uint32_t)bits;
        } else {
          reinterpret_cast<unsigned long long*>(mask)[v] = bits;
        }
      }
    }
    done = nvec * V;
  }
  for (unsigned i = done + tid; i < n; i += stride) {
    bool pos;
    out[i] = act<T>(x[i], bias[i % C], slope, scale, &pos);
    if constexpr (MASK) mask[i] = pos;
  }
}

template <class T>
void launch(const void* x, const void* bias, void* out, void* mask, long long n, int C,
            float slope, float scale, cudaStream_t s) {
  constexpr unsigned V = 16 / sizeof(T);
  const int vectorized = C % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(mask) % V == 0;
  const int threads = 256;
  const long long work = vectorized ? (n + V - 1) / V : n;
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;  // the loop does the rest
  const T* xi = static_cast<const T*>(x);
  const T* b = static_cast<const T*>(bias);
  T* o = static_cast<T*>(out);
  if (mask != nullptr) {
    fused_leaky_relu_kernel<T, true><<<(int)blocks, threads, 0, s>>>(
        xi, b, o, static_cast<uint8_t*>(mask), (unsigned)n, (unsigned)C, slope, scale,
        vectorized);
  } else {
    fused_leaky_relu_kernel<T, false><<<(int)blocks, threads, 0, s>>>(
        xi, b, o, nullptr, (unsigned)n, (unsigned)C, slope, scale, vectorized);
  }
}

}  // namespace

extern "C" int storm_fused_leaky_relu(const void* x, const void* bias, void* out, void* mask,
                                      long long n, int C, float slope, float scale, int dtype,
                                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (C <= 0 || n < 0 || n % C != 0 || n >= (1LL << 31) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, bias, out, mask, n, C, slope, scale, s);
  } else {
    launch<bf16>(x, bias, out, mask, n, C, slope, scale, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* storm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
