// Per-tensor int8 activation quantizer for Hopper (sm_90a), on a contiguous
// float32 or bfloat16 tensor of any shape, in one of two modes:
//   mode 0, the product in float32:   q = int8(clip(rint(f32(x) * inv), -127, 127))
//   mode 1, the product in bfloat16:  q = int8(clip(rint(bf16(bf16(x) * bf16(inv))), -127, 127))
// rint rounds half to even.
//
// Replaces the Pallas kernel `qkernel` (scripts/perf_fusion_probe.py, the
// `pl.pallas_call` over (TILE, 128) row blocks), which is the activation
// quantizer of the int8 W8A8 serving path (storm_tpu/nn/qconv.py
// `QuantizableConv._int8_conv`, with inv = 1 / a_scale). Mode 0 is
// `qkernel`'s, and production's under float32 compute. Mode 1 is
// production's under bfloat16 compute, which rounds
// `v.astype(bf16) * inv.astype(bf16)` in bfloat16 before `jnp.round`: the
// product of two bfloat16 values is exact in float32, so rounding it once
// to bfloat16 (nearest even) gives XLA's bfloat16 product, and the codes
// part from mode 0's where the two products round to different sides of a
// .5. `rintf` rounds half to even like `jnp.round`, and the clip happens in
// float before the cast.
//
// Bound: memory. Each element costs one or two multiplies, roundings and
// two compares, far below the card's rate, so the least time is (input bytes
// + one output byte per element) / 3.35 TB/s: 5 B per element from float32,
// 3 from bfloat16. The design: each thread loads 16 bytes of input per step
// (4 float32 or 8 bfloat16 values) and stores their codes in one 4- or 8-byte
// write, in a grid-stride loop over those vectors; the elements after the
// last whole vector (and every element of an input not aligned to 16 bytes)
// go one by one. The scale comes by value (rounded to bfloat16 on the host
// in mode 1), so no thread reads it from memory. bfloat16 is read as raw
// 16-bit words: its float32 value is the word shifted left by 16, exactly.
//
// C interface for ctypes: returns cudaGetLastError() after the launch (0 on
// success). dtype: 0 float32, 1 bfloat16; mode: 0 float32 product, 1
// bfloat16 product.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The code of v (its input value in float32) in the mode BF16_PRODUCT, whose
// inv is already a bfloat16 value.
template <bool BF16_PRODUCT>
__device__ __forceinline__ uint32_t quantize(float v, float inv) {
  const float p = BF16_PRODUCT ? round_bf16(round_bf16(v) * inv) : v * inv;
  const float r = rintf(p);
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

template <bool BF16, bool BF16_PRODUCT>
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
        packed[j / 4] |= quantize<BF16_PRODUCT>(f, inv) << (8 * (j % 4));
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
    out[i] = static_cast<int8_t>(quantize<BF16_PRODUCT>(element<BF16>(x, i), inv));
  }
}

template <bool BF16_PRODUCT>
void launch(const void* x, int8_t* out, long long n, int dtype, float inv, int vectorized,
            int blocks, int threads, cudaStream_t s) {
  if (dtype == 0) {
    quantize_int8_kernel<false, BF16_PRODUCT><<<blocks, threads, 0, s>>>(x, out, n, inv,
                                                                         vectorized);
  } else {
    quantize_int8_kernel<true, BF16_PRODUCT><<<blocks, threads, 0, s>>>(x, out, n, inv,
                                                                        vectorized);
  }
}

}  // namespace

extern "C" int storm_quantize_int8(const void* x, void* out, long long n, int dtype, int mode,
                                   float inv, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((dtype != 0 && dtype != 1) || (mode != 0 && mode != 1)) return (int)cudaErrorInvalidValue;
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
  if (mode == 0) {
    launch<false>(x, o, n, dtype, inv, vectorized, (int)blocks, threads, s);
  } else {
    launch<true>(x, o, n, dtype, round_bf16(inv), vectorized, (int)blocks, threads, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* storm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
