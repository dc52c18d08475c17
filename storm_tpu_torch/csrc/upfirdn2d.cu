// upfirdn2d for Hopper (sm_90a): zero-insert upsample -> pad -> 2-D FIR
// (true convolution) -> keep every `down`-th sample, on NCHW float32 or
// bfloat16 (the output in the input's type, the sum in float32).
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
// float32 rate, so the least time is (E * (planes*H*W + planes*Ho*Wo)) /
// 3.35 TB/s, E = 4 bytes per element for float32 and 2 for bfloat16: every
// input read once, every output written once.
//
// Design. A block of 256 threads owns one output tile of one plane at a
// time (down: 16 x 64 outputs, up: 32 x 128) and loops over tiles with two
// shared-memory buffers: while it computes one tile, `cp.async` fills the
// other with the next tile's input window and halo (down: 2*TH+2 rows x
// 2*TW+2 columns; up: TH/2+2 x TW/2+2). The fill writes the zeros of the pad,
// of a negative pad's crop and of the ragged edges (`cp.async` with a source
// size of 0), so the inner loops have no bounds tests. Shared memory holds
// the input's own type, in chunks of 4 elements (16 bytes of float32, 8 of
// bfloat16). Where every input row starts on a chunk (W % 4 == 0 and an
// aligned base) the fill copies a chunk at a time (`cp.async` of 16 or 8
// bytes); otherwise one element at a time: `cp.async` of 4 bytes for
// float32, and for bfloat16, whose 2-byte elements `cp.async` cannot copy, a
// plain load and shared-memory store (the main path's widths are all
// multiples of 8 and never take it). The window's first column is a multiple
// of 4 in the input, so the offset of a thread's columns within its chunks
// depends on pad0 modulo 4 or 8 alone; it is the template argument S, and
// every register index is a compile-time constant.
// The tile's origin absorbs pad0: for up=2 a tile starts on an even
// zero-inserted coordinate, so it may begin one output row or column before
// the image (those outputs are not stored), and each 2 x 2 output quad reads
// a 3 x 3 input neighbourhood with its taps known at compile time.
// Several outputs per thread, read from shared memory a chunk at a time and
// summed in float32 (fused multiply-adds):
//   down: a thread computes 2 rows x 2 neighbouring columns (stores of 2
//         elements); the 6 input columns they share are loaded once per
//         input row.
//   up:   a thread computes two quad rows x two quads, 4 x 4 outputs
//         (stores of 4 elements), from 4 x 4 input values.
// A bfloat16 output is rounded once, to nearest even. A warp stores whole
// contiguous output row segments. Stores fall back to scalars at the ragged
// edge or where the output row is not aligned; nothing else depends on the
// shape, so any H, W >= 1, any plane count (the grid is one-dimensional over
// tiles) and any element-aligned pointers work. The taps travel as a
// by-value kernel argument (constant bank), in float32 for both types: the
// NCSN++ FIR, outer([1,3,3,1]) / 64 (times 4 for up), is exact in bfloat16,
// so they are the taps the reference casts to x's type, and a bfloat16 input
// times a tap is exact in float32.
//
// C interface for ctypes: the function returns cudaGetLastError() after the
// launch (0 on success); `taps` is a host pointer to K*K floats, used flipped
// in both axes when `flip` is set (the adjoint's taps); dtype 0 is float32,
// 1 bfloat16.

#include <cuda_bf16.h>
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

using bf16 = __nv_bfloat16;

// One chunk of 4 elements, global -> shared, or zeros when !copy: 16 bytes
// of float32, 8 of bfloat16.
__device__ __forceinline__ void cp_async_chunk(float* dst, const float* src, bool copy) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(copy ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_chunk(bf16* dst, const bf16* src, bool copy) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(copy ? 8 : 0) : "memory");
}

// One element, global -> shared, or a zero when !copy.
__device__ __forceinline__ void copy_element(float* dst, const float* src, bool copy) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(copy ? 4 : 0) : "memory");
}

__device__ __forceinline__ void copy_element(bf16* dst, const bf16* src, bool copy) {
  *reinterpret_cast<uint16_t*>(dst) = copy ? *reinterpret_cast<const uint16_t*>(src) : 0;
}

// A chunk of shared memory as 4 floats (a bfloat16's float is its bits
// shifted left by 16, exactly; the lower address holds the lower half).
__device__ __forceinline__ float4 load_chunk(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load_chunk(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// Stores of 1, 2 and 4 outputs; bfloat16 rounds to nearest even.
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store4(bf16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
}

__device__ __forceinline__ float tap(const Taps& t, int ky, int kx) {
  return t.w[(kTaps - 1 - ky) * kTaps + (kTaps - 1 - kx)];  // the flip
}

// Elements of one shared-memory buffer of `rows` x `pitch`, rounded up so
// that the second buffer starts on 16 bytes in either type.
constexpr int buffer_elems(int rows, int pitch) { return (rows * pitch + 7) & ~7; }

// up=1, down=2. A warp owns kRows output rows of the tile, lane t the
// columns 2t and 2t+1. Output (j, i) of the tile reads window rows 2j + ky
// and columns S + 2i + kx.
struct Down {
  static constexpr int kRows = kDownRows;
  static constexpr int TH = kRows * kWarps;
  static constexpr int TW = 64;
  static constexpr int ROWS = 2 * TH + 2;
  static constexpr int PITCH = 4 * (TW / 2 + 2);  // >= 3 + 2*TW + 2 columns
  static constexpr int ELEMS = buffer_elems(ROWS, PITCH);  // one buffer

  static __host__ __device__ int shift(int pad0) { return -pad0 & 3; }
  static __host__ int tiles_y(int Ho, int) { return (Ho + TH - 1) / TH; }
  static __host__ int tiles_x(int Wo, int) { return (Wo + TW - 1) / TW; }

  template <int S>
  static __device__ __forceinline__ Tile locate(long long plane, int ty, int tx, int pad0) {
    const int oy0 = ty * TH, ox0 = tx * TW;
    return {plane, oy0, ox0, 2 * oy0 - pad0, 2 * ox0 - pad0 - S};
  }

  template <int S, class T>
  static __device__ __forceinline__ void compute(const T* buf, T* __restrict__ out,
                                                 const Taps& taps, int Ho, int Wo, int oy0,
                                                 int ox0) {
    constexpr int NCH = S == 3 ? 3 : 2;  // chunks of 4 that hold columns S .. S+5
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const T* base = buf + 2 * kRows * warp * PITCH + 4 * lane;
    float acc[kRows][2] = {};
#pragma unroll
    for (int rr = 0; rr < 2 * kRows + 2; ++rr) {
      float v[4 * NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float4 q = load_chunk(base + rr * PITCH + 4 * c);
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
      T* p = out + (long long)oy * Wo + ox;
      if (ox + 1 < Wo && (reinterpret_cast<uintptr_t>(p) % (2 * sizeof(T))) == 0) {
        store2(p, acc[j][0], acc[j][1]);
      } else {
        store1(p, acc[j][0]);
        if (ox + 1 < Wo) store1(p + 1, acc[j][1]);
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
  static constexpr int ELEMS = buffer_elems(ROWS, PITCH);

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

  template <int S, class T>
  static __device__ __forceinline__ void compute(const T* buf, T* __restrict__ out,
                                                 const Taps& taps, int Ho, int Wo, int oy0,
                                                 int ox0) {
    constexpr int B = S & 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // the thread's 4 window columns start at S + 2*lane: in the chunk
    // (S + 2*lane) / 4, at offset B or B + 2 by the lane's parity
    const bool odd = (((S >> 1) + lane) & 1) != 0;
    const T* base = buf + kQuadRows * warp * PITCH + 4 * ((S + 2 * lane) >> 2);
    float acc[2 * kQuadRows][4] = {};
#pragma unroll
    for (int rr = 0; rr < kQuadRows + 2; ++rr) {
      const float4 q0 = load_chunk(base + rr * PITCH), q1 = load_chunk(base + rr * PITCH + 4);
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
      T* p = out + (long long)oy * Wo + ox;
      if (ox >= 0 && ox + 3 < Wo && (reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T))) == 0) {
        store4(p, acc[r]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (ox + e >= 0 && ox + e < Wo) store1(p + e, acc[r][e]);
      }
    }
  }
};

// Start the copies of one tile's window into `buf`: zeros where the window
// leaves the input. vec: every row starts on a chunk (W % 4 == 0, aligned
// base), so a chunk (its first column a multiple of 4) is wholly inside or
// wholly outside.
template <class Cfg, class T>
__device__ __forceinline__ void fill(T* buf, const T* __restrict__ x, const Tile& t, int H, int W,
                                     bool vec) {
  const T* xs = x + t.plane * H * W;
  if (vec) {
    constexpr int CH = Cfg::PITCH / 4;
    for (int i = threadIdx.x; i < Cfg::ROWS * CH; i += kThreads) {
      const int r = i / CH, c = i - r * CH;
      const int gy = t.iy0 + r, gx = t.ix0 + 4 * c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async_chunk(buf + r * Cfg::PITCH + 4 * c, in ? xs + (long long)gy * W + gx : x, in);
    }
  } else {
    for (int i = threadIdx.x; i < Cfg::ROWS * Cfg::PITCH; i += kThreads) {
      const int r = i / Cfg::PITCH, c = i - r * Cfg::PITCH;
      const int gy = t.iy0 + r, gx = t.ix0 + c;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      copy_element(buf + i, in ? xs + (long long)gy * W + gx : x, in);
    }
  }
}

// The block's loop over tiles blockIdx.x, + gridDim.x, ...: the copy of the
// next tile is in flight while this one is computed and stored (for
// bfloat16 rows that are not chunk-aligned, the fill's plain stores land
// before the barrier that precedes the tile's compute).
template <class Cfg, int S, class T>
__device__ __forceinline__ void run(const T* __restrict__ x, T* __restrict__ out,
                                    const Taps& taps, long long tiles, int tiles_y, int tiles_x,
                                    int H, int W, int Ho, int Wo, int pad0, bool vec) {
  extern __shared__ float4 smem[];
  T* const bufs[2] = {reinterpret_cast<T*>(smem), reinterpret_cast<T*>(smem) + Cfg::ELEMS};
  const long long per_plane = (long long)tiles_y * tiles_x;
  auto locate = [&](long long tile) {
    const long long plane = tile / per_plane;
    const int rem = (int)(tile - plane * per_plane);
    const int ty = rem / tiles_x;
    return Cfg::template locate<S>(plane, ty, rem - ty * tiles_x, pad0);
  };
  auto prefetch = [&](long long tile, T* buf) {
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

template <int S, class T>
__global__ void __launch_bounds__(kThreads)
upfirdn2d_down2(const T* __restrict__ x, T* __restrict__ out, Taps taps, long long tiles,
                int tiles_y, int tiles_x, int H, int W, int Ho, int Wo, int pad0, int vec) {
  run<Down, S>(x, out, taps, tiles, tiles_y, tiles_x, H, W, Ho, Wo, pad0, vec != 0);
}

template <int S, class T>
__global__ void __launch_bounds__(kThreads)
upfirdn2d_up2(const T* __restrict__ x, T* __restrict__ out, Taps taps, long long tiles,
              int tiles_y, int tiles_x, int H, int W, int Ho, int Wo, int pad0, int vec) {
  run<Up, S>(x, out, taps, tiles, tiles_y, tiles_x, H, W, Ho, Wo, pad0, vec != 0);
}

template <class T>
using KernelFn = void (*)(const T*, T*, Taps, long long, int, int, int, int, int, int, int, int);

// One instance per (configuration, S, type). Its dynamic shared-memory limit
// is raised (where the two buffers exceed 48 KB) and its resident blocks per
// SM are looked up once per device.
template <class Cfg, class T>
struct Instance {
  KernelFn<T> fn;
  int per_sm[kMaxDevices];
};

template <class Cfg, class T>
cudaError_t launch(Instance<Cfg, T>& inst, int device, const T* x, T* out, const Taps& taps,
                   long long planes, int H, int W, int Ho, int Wo, int pad0, cudaStream_t s) {
  constexpr size_t smem = 2 * sizeof(T) * Cfg::ELEMS;
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
  const int vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T))) == 0;
  inst.fn<<<blocks, kThreads, smem, s>>>(x, out, taps, tiles, tiles_y, tiles_x, H, W, Ho, Wo,
                                         pad0, vec);
  return cudaGetLastError();
}

// The four instances (S = 0 .. 3) of each configuration for type T.
template <class T>
struct Instances {
  Instance<Down, T> down[4] = {{upfirdn2d_down2<0, T>, {}}, {upfirdn2d_down2<1, T>, {}},
                               {upfirdn2d_down2<2, T>, {}}, {upfirdn2d_down2<3, T>, {}}};
  Instance<Up, T> up[4] = {{upfirdn2d_up2<0, T>, {}}, {upfirdn2d_up2<1, T>, {}},
                           {upfirdn2d_up2<2, T>, {}}, {upfirdn2d_up2<3, T>, {}}};
};

Instances<float> f32_instances;
Instances<bf16> bf16_instances;

template <class T>
cudaError_t dispatch(Instances<T>& inst, int device, const void* x, void* out, const Taps& taps,
                     long long planes, int H, int W, int Ho, int Wo, int up, int down, int pad0,
                     cudaStream_t s) {
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (up == 1 && down == 2) {
    return launch(inst.down[Down::shift(pad0)], device, xi, o, taps, planes, H, W, Ho, Wo, pad0,
                  s);
  }
  if (up == 2 && down == 1) {
    return launch(inst.up[Up::shift(pad0)], device, xi, o, taps, planes, H, W, Ho, Wo, pad0, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int storm_upfirdn2d(const void* x, void* out, const void* taps_host, int flip,
                               int device, long long planes, int H, int W, int Ho, int Wo,
                               int up, int down, int pad0, int dtype, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (planes <= 0 || Ho <= 0 || Wo <= 0) return (int)cudaSuccess;
  Taps taps;
  const float* t = static_cast<const float*>(taps_host);
  for (int i = 0; i < kTaps * kTaps; ++i) taps.w[i] = t[flip ? kTaps * kTaps - 1 - i : i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    err = dispatch(f32_instances, device, x, out, taps, planes, H, W, Ho, Wo, up, down, pad0, s);
  } else {
    err = dispatch(bf16_instances, device, x, out, taps, planes, H, W, Ho, Wo, up, down, pad0, s);
  }
  return (int)err;
}

extern "C" const char* storm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
