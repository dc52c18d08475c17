// upfirdn2d for Hopper (sm_90a): zero-insert upsample -> pad -> 2-D FIR
// (true convolution) -> keep every `down`-th sample, on NCHW float32.
//
// Replaces the Pallas kernel `upfirdn2d_pallas` (storm_tpu/kernels/upfirdn.py,
// body `_fir_down_kernel`), which materialised the zero-insertion and the pad
// in device memory before a tiled K x K stencil, and serves its gradient (the
// custom VJP `_ufd_bwd`: the same op with flipped taps, up and down swapped
// and pad0' = K - pad0 - 1) with the same two configurations.
//
// Semantics (those of the reference op):
//   xu[i]  = x[i / up] if i % up == 0 else 0, for i in [0, H*up)   (zeros also
//            follow the last sample)
//   xp[j]  = xu[j - pad0]  (zero outside [0, H*up); negative pads crop)
//   out[o] = sum_k xp[o*down + k] * kernel[K-1-k]      (the kernel is flipped)
// in both spatial axes; the caller gives the output size (Ho, Wo), which
// carries pad1. K = 4; (up, down) is (1, 2) or (2, 1).
//
// Bound: memory. An output costs 16/up^2 multiply-adds, far below the card's
// float32 rate, so the least time is (4 B * (planes*H*W + planes*Ho*Wo)) /
// 3.35 TB/s: every input read once, every output written once.
//
// Design. A block of 256 threads owns one output tile of one plane at a
// time (down: 16 x 64 outputs, up: 32 x 128) and loops over tiles with two
// shared-memory buffers: while it computes one tile, `cp.async` fills the
// other with the next tile's input window and halo (down: 2*TH+2 rows x
// 2*TW+2 columns; up: TH/2+2 x TW/2+2). The fill writes the zeros of the pad,
// of a negative pad's crop and of the ragged edges (`cp.async` with a source
// size of 0), so the inner loops have no bounds tests. Where every input row
// starts on 16 bytes (W % 4 == 0 and an aligned base) the fill copies 16
// bytes at a time; otherwise 4. The window's first column is a multiple of 4
// in the input, so the offset of a thread's columns within its 16-byte
// shared-memory chunks depends on pad0 modulo 4 or 8 alone; it is the
// template argument S, and every register index is a compile-time constant.
// The tile's origin absorbs pad0: for up=2 a tile starts on an even
// zero-inserted coordinate, so it may begin one output row or column before
// the image (those outputs are not stored), and each 2 x 2 output quad reads
// a 3 x 3 input neighbourhood with its taps known at compile time.
// Several outputs per thread, read from 16-byte shared-memory loads:
//   down: a thread computes 2 rows x 2 neighbouring columns (8-byte stores);
//         the 6 input columns they share are loaded once per input row.
//   up:   a thread computes two quad rows x two quads, 4 x 4 outputs
//         (16-byte stores), from 4 x 4 input values.
// A warp stores whole contiguous output row segments. Stores fall back to
// scalars at the ragged edge or where the output row is not aligned; nothing
// else depends on the shape, so any H, W >= 1, any plane count (the grid is
// one-dimensional over tiles) and any 4-byte-aligned pointers work. The taps
// travel as a by-value kernel argument (constant bank). bf16 input and output
// (for a bf16 model) are later work.
//
// C interface for ctypes: the function returns cudaGetLastError() after the
// launch (0 on success); `taps` is a host pointer to K*K floats, used flipped
// in both axes when `flip` is set (the adjoint's taps).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Tile heights: output rows per thread (down) and quad rows per thread (up).
// Of 1, 2 and 4, timed on an H100 at the largest calls of a score forward
// and of a train step's backward (tools/upfirdn_tiles.py), 2 was within 4%
// of the fastest at each, the fastest at the forward's up call, and needs
// fewer registers than 4 (PERF.md).
constexpr int kDownRows = 2;
constexpr int kUpQuadRows = 2;
constexpr int kTaps = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;

struct Taps {
  float w[kTaps * kTaps];
};

// Where a tile lies: its plane, its first output row and column, and the
// input coordinates of its shared-memory window's first row and column.
struct Tile {
  long long plane;
  int oy0, ox0, iy0, ix0;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool copy) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(copy ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool copy) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(copy ? 4 : 0) : "memory");
}

__device__ __forceinline__ float tap(const Taps& t, int ky, int kx) {
  return t.w[(kTaps - 1 - ky) * kTaps + (kTaps - 1 - kx)];  // the flip
}

// up=1, down=2. A warp owns kRows output rows of the tile, lane t the
// columns 2t and 2t+1. Output (j, i) of the tile reads window rows 2j + ky
// and columns S + 2i + kx.
struct Down {
  static constexpr int kRows = kDownRows;
  static constexpr int TH = kRows * kWarps;
  static constexpr int TW = 64;
  static constexpr int ROWS = 2 * TH + 2;
  static constexpr int PITCH = 4 * (TW / 2 + 2);  // >= 3 + 2*TW + 2 columns
  static constexpr int FLOATS = ROWS * PITCH;      // one buffer

  static __host__ __device__ int shift(int pad0) { return -pad0 & 3; }
  static __host__ int tiles_y(int Ho, int) { return (Ho + TH - 1) / TH; }
  static __host__ int tiles_x(int Wo, int) { return (Wo + TW - 1) / TW; }

  template <int S>
  static __device__ __forceinline__ Tile locate(long long plane, int ty, int tx, int pad0) {
    const int oy0 = ty * TH, ox0 = tx * TW;
    return {plane, oy0, ox0, 2 * oy0 - pad0, 2 * ox0 - pad0 - S};
  }

  template <int S>
  static __device__ __forceinline__ void compute(const float* buf, float* __restrict__ out,
                                                 const Taps& taps, int Ho, int Wo, int oy0,
                                                 int ox0) {
    constexpr int NCH = S == 3 ? 3 : 2;  // 16-byte chunks that hold columns S .. S+5
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const float* base = buf + 2 * kRows * warp * PITCH + 4 * lane;
    float acc[kRows][2] = {};
#pragma unroll
    for (int rr = 0; rr < 2 * kRows + 2; ++rr) {
      float v[4 * NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 q = reinterpret_cast<const float4*>(base + rr * PITCH)[c];
        v[4 * c] = q.x, v[4 * c + 1] = q.y, v[4 * c + 2] = q.z, v[4 * c + 3] = q.w;
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int ky = rr - 2 * j;
        if (ky < 0 || ky >= kTaps) continue;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int kx = 0; kx < kTaps; ++kx)
            acc[j][i] = fmaf(v[S + 2 * i + kx], tap(taps, ky, kx), acc[j][i]);
      }
    }
    const int ox = ox0 + 2 * lane;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int oy = oy0 + kRows * warp + j;
      if (oy >= Ho || ox >= Wo) continue;
      float* p = out + (long long)oy * Wo + ox;
      if (ox + 1 < Wo && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
        *reinterpret_cast<float2*>(p) = make_float2(acc[j][0], acc[j][1]);
      } else {
        p[0] = acc[j][0];
        if (ox + 1 < Wo) p[1] = acc[j][1];
      }
    }
  }
};

// up=2, down=1. The tile starts on an even coordinate of the zero-inserted,
// padded input, so its origin is output (-(pad0 & 1) + TH*ty, ...). A warp
// owns kQuadRows quad rows (2 output rows each), lane t the quads 2t and 2t+1
// (output columns 4t .. 4t+3). Output quad (a, b) reads window rows a .. a+2
// and columns S + b .. S + b + 2: output row 2a + dy takes window row a + aa
// with tap ky = 2aa - dy, and the same for columns.
struct Up {
  static constexpr int kQuadRows = kUpQuadRows;
  static constexpr int TH = 2 * kQuadRows * kWarps;
  static constexpr int TW = 128;
  static constexpr int ROWS = TH / 2 + 2;
  static constexpr int PITCH = 4 * (TW / 8 + 2);  // >= 3 + TW/2 + 2 columns
  static constexpr int FLOATS = ROWS * PITCH;

  // first even coordinate at or before output 0, halved
  static __host__ __device__ int first_half(int pad0) { return (-pad0 & ~1) >> 1; }
  static __host__ __device__ int shift(int pad0) { return first_half(pad0) & 3; }
  static __host__ int tiles_y(int Ho, int pad0) { return (Ho + (pad0 & 1) + TH - 1) / TH; }
  static __host__ int tiles_x(int Wo, int pad0) { return (Wo + (pad0 & 1) + TW - 1) / TW; }

  template <int S>
  static __device__ __forceinline__ Tile locate(long long plane, int ty, int tx, int pad0) {
    const int h = first_half(pad0), lead = -(pad0 & 1);
    return {plane, lead + ty * TH, lead + tx * TW, h + ty * (TH / 2), h + tx * (TW / 2) - S};
  }

  template <int S>
  static __device__ __forceinline__ void compute(const float* buf, float* __restrict__ out,
                                                 const Taps& taps, int Ho, int Wo, int oy0,
                                                 int ox0) {
    constexpr int B = S & 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // the thread's 4 window columns start at S + 2*lane: in the chunk
    // (S + 2*lane) / 4, at offset B or B + 2 by the lane's parity
    const bool odd = (((S >> 1) + lane) & 1) != 0;
    const float* base = buf + kQuadRows * warp * PITCH + 4 * ((S + 2 * lane) >> 2);
    float acc[2 * kQuadRows][4] = {};
#pragma unroll
    for (int rr = 0; rr < kQuadRows + 2; ++rr) {
      const float4* row = reinterpret_cast<const float4*>(base + rr * PITCH);
      const float4 q0 = row[0], q1 = row[1];
      const float f[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = odd ? f[B + 2 + i] : f[B + i];
#pragma unroll
      for (int a = 0; a < kQuadRows; ++a) {
        const int aa = rr - a;
        if (aa < 0 || aa > 2) continue;
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
          const int ky = 2 * aa - dy;
          if (ky < 0 || ky >= kTaps) continue;
#pragma unroll
          for (int b = 0; b < 2; ++b)
#pragma unroll
            for (int dx = 0; dx < 2; ++dx)
#pragma unroll
              for (int bb = 0; bb < 3; ++bb) {
                const int kx = 2 * bb - dx;
                if (kx < 0 || kx >= kTaps) continue;
                acc[2 * a + dy][2 * b + dx] =
                    fmaf(v[b + bb], tap(taps, ky, kx), acc[2 * a + dy][2 * b + dx]);
              }
        }
      }
    }
    const int ox = ox0 + 4 * lane;
#pragma unroll
    for (int r = 0; r < 2 * kQuadRows; ++r) {
      const int oy = oy0 + 2 * kQuadRows * warp + r;
      if (oy < 0 || oy >= Ho) continue;
      float* p = out + (long long)oy * Wo + ox;
      if (ox >= 0 && ox + 3 < Wo && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
        *reinterpret_cast<float4*>(p) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ox + e >= 0 && ox + e < Wo) p[e] = acc[r][e];
      }
    }
  }
};

// Start the copies of one tile's window into `buf`: zeros where the window
// leaves the input. vec: every row starts on 16 bytes (W % 4 == 0, aligned
// base), so a 16-byte chunk (its first column a multiple of 4) is wholly
// inside or wholly outside.
template <class Cfg>
__device__ __forceinline__ void fill(float* buf, const float* __restrict__ x, const Tile& t,
                                     int H, int W, bool vec) {
  const float* xs = x + t.plane * H * W;
  if (vec) {
    constexpr int CH = Cfg::PITCH / 4;
    for (int i = threadIdx.x; i < Cfg::ROWS * CH; i += kThreads) {
      const int r = i / CH, c = i - r * CH;
      const int gy = t.iy0 + r, gx = t.ix0 + 4 * c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async16(buf + r * Cfg::PITCH + 4 * c, in ? xs + (long long)gy * W + gx : x, in);
    }
  } else {
    for (int i = threadIdx.x; i < Cfg::FLOATS; i += kThreads) {
      const int r = i / Cfg::PITCH, c = i - r * Cfg::PITCH;
      const int gy = t.iy0 + r, gx = t.ix0 + c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async4(buf + i, in ? xs + (long long)gy * W + gx : x, in);
    }
  }
}

// The block's loop over tiles blockIdx.x, + gridDim.x, ...: the copy of the
// next tile is in flight while this one is computed and stored.
template <class Cfg, int S>
__device__ __forceinline__ void run(const float* __restrict__ x, float* __restrict__ out,
                                    const Taps& taps, long long tiles, int tiles_y, int tiles_x,
                                    int H, int W, int Ho, int Wo, int pad0, bool vec) {
  extern __shared__ float4 smem[];
  float* const bufs[2] = {reinterpret_cast<float*>(smem),
                          reinterpret_cast<float*>(smem) + Cfg::FLOATS};
  const long long per_plane = (long long)tiles_y * tiles_x;
  auto locate = [&](long long tile) {
    const long long plane = tile / per_plane;
    const int rem = (int)(tile - plane * per_plane);
    const int ty = rem / tiles_x;
    return Cfg::template locate<S>(plane, ty, rem - ty * tiles_x, pad0);
  };
  auto prefetch = [&](long long tile, float* buf) {
    if (tile < tiles) fill<Cfg>(buf, x, locate(tile), H, W, vec);
    asm volatile("cp.async.commit_group;\n" ::: "memory");  // empty past the end
  };
  int k = 0;
  prefetch(blockIdx.x, bufs[0]);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, k ^= 1) {
    prefetch(tile + gridDim.x, bufs[k ^ 1]);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's copies landed
    __syncthreads();
    const Tile t = locate(tile);
    Cfg::template compute<S>(bufs[k], out + t.plane * Ho * Wo, taps, Ho, Wo, t.oy0, t.ox0);
    __syncthreads();  // the buffer is refilled next iteration
  }
}

template <int S>
__global__ void __launch_bounds__(kThreads)
upfirdn2d_down2(const float* __restrict__ x, float* __restrict__ out, Taps taps, long long tiles,
                int tiles_y, int tiles_x, int H, int W, int Ho, int Wo, int pad0, int vec) {
  run<Down, S>(x, out, taps, tiles, tiles_y, tiles_x, H, W, Ho, Wo, pad0, vec != 0);
}

template <int S>
__global__ void __launch_bounds__(kThreads)
upfirdn2d_up2(const float* __restrict__ x, float* __restrict__ out, Taps taps, long long tiles,
              int tiles_y, int tiles_x, int H, int W, int Ho, int Wo, int pad0, int vec) {
  run<Up, S>(x, out, taps, tiles, tiles_y, tiles_x, H, W, Ho, Wo, pad0, vec != 0);
}

using KernelFn = void (*)(const float*, float*, Taps, long long, int, int, int, int, int, int,
                          int, int);

// One instance per (configuration, S). Its dynamic shared-memory limit is
// raised (where the two buffers exceed 48 KB) and its resident blocks per SM
// are looked up once per device.
template <class Cfg>
struct Instance {
  KernelFn fn;
  int per_sm[kMaxDevices];
};

template <class Cfg>
cudaError_t launch(Instance<Cfg>& inst, int device, const float* x, float* out, const Taps& taps,
                   long long planes, int H, int W, int Ho, int Wo, int pad0, cudaStream_t s) {
  constexpr size_t smem = 2 * sizeof(float) * Cfg::FLOATS;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  static int sms[kMaxDevices] = {};
  cudaError_t err;
  if (inst.per_sm[device] == 0) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(inst.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&inst.per_sm[device], inst.fn, kThreads,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (inst.per_sm[device] < 1) return cudaErrorInvalidConfiguration;
  }
  if (sms[device] == 0) {
    err = cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  const int tiles_y = Cfg::tiles_y(Ho, pad0), tiles_x = Cfg::tiles_x(Wo, pad0);
  const long long tiles = planes * tiles_y * tiles_x;
  const long long resident = (long long)inst.per_sm[device] * sms[device];
  const int blocks = (int)(tiles < resident ? tiles : resident);
  const int vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  inst.fn<<<blocks, kThreads, smem, s>>>(x, out, taps, tiles, tiles_y, tiles_x, H, W, Ho, Wo,
                                         pad0, vec);
  return cudaGetLastError();
}

Instance<Down> down_instances[4] = {{upfirdn2d_down2<0>, {}}, {upfirdn2d_down2<1>, {}},
                                    {upfirdn2d_down2<2>, {}}, {upfirdn2d_down2<3>, {}}};
Instance<Up> up_instances[4] = {{upfirdn2d_up2<0>, {}}, {upfirdn2d_up2<1>, {}},
                                {upfirdn2d_up2<2>, {}}, {upfirdn2d_up2<3>, {}}};

}  // namespace

extern "C" int storm_upfirdn2d_f32(const void* x, void* out, const void* taps_host, int flip,
                                   int device, long long planes, int H, int W,
                                   int Ho, int Wo, int up, int down, int pad0,
                                   void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (planes <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaSuccess;
  Taps taps;
  const float* t = static_cast<const float*>(taps_host);
  for (int i = 0; i < kTaps * kTaps; ++i) taps.w[i] = t[flip ? kTaps * kTaps - 1 - i : i];
  const float* xi = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  if (up == 1 && down == 2) {
    err = launch(down_instances[Down::shift(pad0)], device, xi, o, taps, planes, H, W, Ho, Wo,
                 pad0, s);
  } else if (up == 2 && down == 1) {
    err = launch(up_instances[Up::shift(pad0)], device, xi, o, taps, planes, H, W, Ho, Wo, pad0,
                 s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

extern "C" const char* storm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
