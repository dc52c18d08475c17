// upfirdn2d for Hopper (sm_90a): zero-insert upsample -> pad -> 2-D FIR
// (true convolution) -> keep every `down`-th sample, on NCHW float32.
//
// Replaces the Pallas kernel `upfirdn2d_pallas` (storm_tpu/kernels/upfirdn.py,
// body `_fir_down_kernel`), which materialised the zero-insertion and the pad
// in device memory before a tiled K x K stencil.
//
// Semantics (those of the reference op):
//   xu[i]  = x[i / up] if i % up == 0 else 0, for i in [0, H*up)   (zeros also
//            follow the last sample)
//   xp[j]  = xu[j - pad0]  (zero outside [0, H*up); negative pads crop)
//   out[o] = sum_k xp[o*down + k] * kernel[K-1-k]      (the kernel is flipped)
// in both spatial axes, with Ho = (H*up + pad0 + pad1 - K) / down + 1.
//
// Bound: memory. Each output costs K*K/up^2 multiply-adds on f32 values that
// are read once from device memory and then from L1/L2, so the least time is
// (bytes read + bytes written) / 3.35 TB/s. The design moves no byte it does
// not have to: one thread per output pixel, neighbouring threads on
// neighbouring output columns (coalesced stores); the zero-insertion and the
// padding are index arithmetic, so for up=2 only the K/up x K/up taps that
// land on real samples are read and nothing is materialised; the taps travel
// as a by-value kernel argument (constant bank), not through memory. The grid
// is (output columns, output rows, planes), so a thread finds its pixel
// without integer division. Shared-memory tiling, vector loads and bf16 are
// later work.
//
// C interface for ctypes: the function returns cudaGetLastError() after the
// launch (0 on success); `taps` is a host pointer to K*K floats.

#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 4;

struct Taps {
  float w[kTaps * kTaps];
};

template <int UP, int DOWN>
__global__ void upfirdn2d_k4(const float* __restrict__ x, float* __restrict__ out,
                             Taps taps, int planes, int H, int W, int Ho, int Wo,
                             int pad0) {
  constexpr int K = kTaps;
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  if (ox >= Wo) return;
  const int Hu = H * UP, Wu = W * UP;
  // tap k reads upsampled coordinate (o*DOWN - pad0 + k); it holds a real
  // sample only inside [0, n*UP) and at a multiple of UP. Other taps are
  // skipped before their load. The loops unroll fully, so every tap index
  // is a compile-time constant.
  const int y0 = oy * DOWN - pad0;
  const int x0 = ox * DOWN - pad0;

  for (int plane = blockIdx.z; plane < planes; plane += gridDim.z) {
    const float* __restrict__ xs = x + (long long)plane * H * W;
    float acc = 0.f;
#pragma unroll
    for (int ky = 0; ky < K; ++ky) {
      const int iy = y0 + ky;
      if (iy < 0 || iy >= Hu || (UP > 1 && iy % UP != 0)) continue;
      const float* __restrict__ row = xs + (long long)(iy / UP) * W;
#pragma unroll
      for (int kx = 0; kx < K; ++kx) {
        const int ix = x0 + kx;
        if (ix < 0 || ix >= Wu || (UP > 1 && ix % UP != 0)) continue;
        acc += taps.w[(K - 1 - ky) * K + (K - 1 - kx)] * __ldg(row + ix / UP);
      }
    }
    out[((long long)plane * Ho + oy) * Wo + ox] = acc;
  }
}

}  // namespace

extern "C" int storm_upfirdn2d_f32(const void* x, void* out, const void* taps_host,
                                   int device, int planes, int H, int W,
                                   int Ho, int Wo, int up, int down, int pad0,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Taps taps;
  const float* t = static_cast<const float*>(taps_host);
  for (int i = 0; i < kTaps * kTaps; ++i) taps.w[i] = t[i];

  if (planes <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaSuccess;
  if (Ho > 65535) return (int)cudaErrorInvalidValue;  // one grid row per output row
  // one warp-multiple of threads across the output row, at most 256
  const int threads = Wo >= 256 ? 256 : (Wo + 31) / 32 * 32;
  const dim3 grid((Wo + threads - 1) / threads, Ho,
                  planes < 65535 ? planes : 65535);  // the kernel loops over the rest
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);

  if (up == 1 && down == 2) {
    upfirdn2d_k4<1, 2><<<grid, threads, 0, s>>>(xi, o, taps, planes, H, W, Ho, Wo, pad0);
  } else if (up == 2 && down == 1) {
    upfirdn2d_k4<2, 1><<<grid, threads, 0, s>>>(xi, o, taps, planes, H, W, Ho, Wo, pad0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* storm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
