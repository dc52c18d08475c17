// Per-tensor int8 activation quantizer for Hopper (sm_90a):
//   q = int8(clip(round(float32(x) * inv), -127, 127)), round half to even,
// on a contiguous float32 or bfloat16 tensor of any shape.
//
// Replaces the Pallas kernel `qkernel` (scripts/perf_fusion_probe.py, the
// `pl.pallas_call` over (TILE, 128) row blocks), which is the activation
// quantizer of the int8 W8A8 serving path (storm_tpu/nn/qconv.py
// `QuantizableConv._int8_conv`, with inv = 1 / a_scale). The product is taken
// in float32 whatever the input type, as `qkernel` does; `rintf` rounds half
// to even like `jnp.round`, and the clip happens in float before the cast.
//
// Bound: memory. Each element costs one multiply, one rounding and two
// compares, far below the card's rate, so the least time is (input bytes +
// one output byte per element) / 3.35 TB/s: 5 B per element from float32,
// 3 from bfloat16. The design: each thread loads 16 bytes of input per step
// (4 float32 or 8 bfloat16 values) and stores their codes in one 4- or 8-byte
// write, in a grid-stride loop over those vectors; the elements after the
// last whole vector (and every element of an input not aligned to 16 bytes)
// go one by one. The scale comes by value, so no thread reads it from memory.
// bfloat16 is read as raw 16-bit words: its float32 value is the word shifted
// left by 16, exactly.
//
// C interface for ctypes: returns cudaGetLastError() after the launch (0 on
// success). dtype: 0 float32, 1 bfloat16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t quantize(float v, float inv) {
  const float r = rintf(v * inv);
  return static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(fminf(fmaxf(r, -127.f), 127.f))));
}

template <bool BF16>
__device__ __forceinline__ float element(const void* __restrict__ x, long long i) {
  if constexpr (BF16) {
    return __uint_as_float(static_cast<uint32_t>(__ldg(static_cast<const uint16_t*>(x) + i)) << 16);
  } else {
    return __ldg(static_cast<const float*>(x) + i);
  }
}

template <bool BF16>
__global__ void quantize_int8_kernel(const void* __restrict__ x, int8_t* __restrict__ out,
                                     long long n, float inv, int vectorized) {
  constexpr int VEC = BF16 ? 8 : 4;  // elements per 16-byte load
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long done = 0;
  if (vectorized) {
    const long long nvec = n / VEC;
    for (long long v = tid; v < nvec; v += stride) {
      const uint4 raw = __ldg(static_cast<const uint4*>(x) + v);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t packed[VEC / 4] = {};
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float f;
        if constexpr (BF16) {
          f = __uint_as_float((w[j / 2] >> (16 * (j % 2))) << 16);  // low half first
        } else {
          f = __uint_as_float(w[j]);
        }
        packed[j / 4] |= quantize(f, inv) << (8 * (j % 4));
      }
      if constexpr (BF16) {
        reinterpret_cast<uint2*>(out)[v] = make_uint2(packed[0], packed[1]);
      } else {
        reinterpret_cast<uint32_t*>(out)[v] = packed[0];
      }
    }
    done = nvec * VEC;
  }
  for (long long i = done + tid; i < n; i += stride) {
    out[i] = static_cast<int8_t>(quantize(element<BF16>(x, i), inv));
  }
}

}  // namespace

extern "C" int storm_quantize_int8(const void* x, void* out, long long n, int dtype,
                                   float inv, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  // 16-byte loads need a 16-byte aligned input; the codes of one vector are
  // then stored at a multiple of their 4 or 8 bytes
  const int vectorized = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                         (reinterpret_cast<uintptr_t>(out) % 8 == 0);
  const int threads = 256;
  const int vec = dtype == 0 ? 4 : 8;
  const long long work = vectorized ? (n + vec - 1) / vec : n;
  // enough blocks to fill the card many times over; the loop does the rest
  long long blocks = (work + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* o = static_cast<int8_t*>(out);
  if (dtype == 0) {
    quantize_int8_kernel<false><<<(int)blocks, threads, 0, s>>>(x, o, n, inv, vectorized);
  } else {
    quantize_int8_kernel<true><<<(int)blocks, threads, 0, s>>>(x, o, n, inv, vectorized);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* storm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
