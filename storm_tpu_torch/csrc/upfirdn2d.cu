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
// carries pad1. K = 4; (up, down) is (1, 2), (2, 1) or (1, 1): the last is
// the FIR between a transposed and a strided 3x3 conv (pad0 1 after
// `upsample_conv_2d`'s, 2 before `conv_downsample_2d`'s), whose adjoint is
// itself at pad0' = 3 - pad0.
//
// Bound: memory. An output costs at most 16 multiply-adds, far below the card's
// float32 rate, so the least time is (E * (planes*H*W + planes*Ho*Wo)) /
// 3.35 TB/s, E = 4 bytes per element for float32 and 2 for bfloat16: every
// input read once, every output written once.
//
// Design. The wrapper (kernels/upfirdn.py `tile_plan`) cuts the output into
// tiles of th x tw of one plane and hands the kernel the plan: tiles per
// axis, the output origin of tile (0, 0) (the up config's lead: a tile starts
// on an even zero-inserted coordinate, so it may begin one output row or
// column before the image), the input origin of its box and the step per
// tile, the box size, the window's shift in the box, the ring's depth and
// the grid. The column tile divides the bucket widths (64 k frames) wherever
// a width allows it, and the row tile is sized in bytes, so a bfloat16 box
// holds as many bytes as a float32 one. A persistent block of 8 consumer
// warps and one producer warp walks the tiles blockIdx.x, + gridDim.x, ...:
// the producer's elected thread keeps the next stages of a ring in shared
// memory loading (full / empty mbarriers) while the consumers compute the
// current one. Each stage is one TMA tiled copy (`cp.async.bulk.tensor.3d`,
// tensor map over (W, H, planes), encoded per call by cuTensorMapEncodeTiled,
// looked up through the runtime, and passed as a __grid_constant__
// parameter, which a captured graph keeps by value): its out-of-bounds zero
// fill writes the pad, the negative pad's crop and the ragged edges, so the
// inner loops have no bounds tests.
// A box's first column is a multiple of 16 bytes (a copy whose innermost
// start coordinate is not has faulted with an illegal instruction on an
// H100), so the tile's window starts S columns into it, S = 0 .. n-1 (n =
// 16 / sizeof(T)): one instance per S keeps every register index a
// compile-time constant. Rows TMA cannot take (W * E not a multiple of 16
// bytes, or a base off 16 bytes) are filled by the producer warp's 32
// threads element by element into the same layout; the default NCSN++
// never takes that fill, ncsnpplarge's 3- and 9-frame levels do.
// Consumers read shared memory and write device memory 16 bytes at a time:
// a work item is two output rows of one tile by one 16-byte chunk of n
// outputs, so a warp's lanes store consecutive chunks of a row (down: rows
// 2j .. 2j+5 of the window and columns 2i .. 2i+2n+1; up: one quad row, each
// 2 x 2 output quad reading a 3 x 3 input neighbourhood with its taps known
// at compile time). Each
// output is summed in float32 from +0 with fused multiply-adds, ky outer
// and kx inner (the plain version's order; the zero taps of the
// zero-insertion are skipped), and a bfloat16 output is rounded
// once, to nearest even: with NCSN++'s FIR, outer([1,3,3,1]) / 64 (times 4
// for up), whose taps are exact in bfloat16 and whose products with
// bfloat16 values are exact in float32, the output equals the plain version
// bit for bit. Stores fall back to elements at the ragged edge, for a lead
// column or an unaligned output; any H, W >= 1 and any plane count below
// 2^31 work. The taps travel as a by-value kernel argument (constant bank),
// in float32. The 18 calls of a full-width score forward take 1.53x their
// bound in bfloat16 and 1.33x in float32 on an NVIDIA H100 80GB HBM3 at
// 700 W (chip_smoke.py; PERF.md §6).
//
// The stride-1 instance (`Same`, kernel upfirdn2d_same1) never has both
// rows of whole 16-byte chunks: its calls read a transposed conv's 2n + 1
// columns or write n + 1, so neither a tensor map nor 16-byte stores fit
// every call. Its box arrives by TMA where the input's rows allow it, and
// otherwise row by row through 1-D bulk copies (`copy_rows`: the copy engine
// needs 16-byte aligned addresses and sizes, not a row pitch), each row
// landing at its own shift of 0 .. n-1 elements. Its consumers read four
// columns a lane in aligned groups and apply that runtime shift in
// registers, and each warp writes its finished rows through a staging row
// in shared memory, 32 neighbouring outputs per store instruction
// (`consume_quads`), so no call loads element by element or stores in a
// lane-strided pattern.
//
// C interface for ctypes: the function returns cudaGetLastError() after the
// launch (0 on success); `taps` is a host pointer to K*K floats, used flipped
// in both axes when `flip` is set (the adjoint's taps); dtype 0 is float32,
// 1 bfloat16; `plan` points to kPlanLen ints laid out as PlanField.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

namespace {

constexpr int kTaps = 4;
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
constexpr int kMinBlocks = 2;              // resident blocks per SM the registers must allow
constexpr int kMaxStages = 8;
constexpr int kMaxDynSmem = 112 * 1024;    // two blocks' rings fit in an SM's 228 KB

// The plan's fields, in the order kernels/upfirdn.py writes them.
enum PlanField {
  kTh, kTw, kTilesY, kTilesX, kOy0, kOx0, kIy0, kIx0, kIyStep, kIxStep, kBoxH, kBoxW, kGrid,
  kStages, kTma, kVecOut, kSx, kRows, kPlanLen
};

struct Taps {
  float w[kTaps * kTaps];
};

struct Plan {
  long long tiles;
  int th, tw, tiles_y, tiles_x, oy0, ox0, iy0, ix0, iy_step, ix_step, box_h, box_w, stages;
  int sx;  // the window's column in a box (TMA); the chunked configs take it as S
  int stage_elems;  // elements between two stages' first elements (128-byte multiples)
  long long x_elems;  // the input's elements: a row copy reads none past them
  bool tma, vec_out, rows;
};

using bf16 = __nv_bfloat16;

// Elements of T in 16 bytes: a chunk.
template <class T>
__host__ __device__ constexpr int chunk() {
  return 16 / sizeof(T);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One box of the tensor map at (column, row, plane) into shared memory,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int x, int y, int plane) {
  asm volatile("cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%3, %4, %5}], [%2];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y),
                  "r"(plane)
               : "memory");
}

// Add `bytes` to the barrier's expected transaction count, without arriving.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16) from a 16-byte aligned global address into
// shared memory (16-byte aligned), completing them on the barrier: a 1-D
// bulk copy by the copy engine, which needs no tensor map and so no row pitch.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1], %2, [%3];\n"
               :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
               : "memory");
}

// 16 bytes of shared memory as floats: 4 of float32, 8 of bfloat16 (a
// bfloat16's float is its bits shifted left by 16, exactly; the lower address
// holds the lower half).
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

__device__ __forceinline__ void load16(const bf16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(u[i] << 16);
    v[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// 16 bytes of outputs to device memory; bfloat16 rounds to nearest even.
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t bf16_pair(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store16(bf16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                            bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// One output row's chunk of n = 16 / sizeof(T) values at column ox: a 16-byte
// store, or element stores where the chunk leaves [0, Wo) or `vec` is off.
template <class T>
__device__ __forceinline__ void store_chunk(T* row, const float* v, int ox, int Wo, bool vec) {
  constexpr int n = chunk<T>();
  if (vec && ox + n <= Wo) {
    store16(row + ox, v);
  } else {
#pragma unroll
    for (int e = 0; e < n; ++e)
      if (ox + e >= 0 && ox + e < Wo) store1(row + ox + e, v[e]);
  }
}

__device__ __forceinline__ float tap(const Taps& t, int ky, int kx) {
  return t.w[(kTaps - 1 - ky) * kTaps + (kTaps - 1 - kx)];  // the flip
}

// Chunks an item row reads from its first chunk: `cols` columns that start
// `s` columns into it.
__host__ __device__ constexpr int chunks_read(int s, int cols, int e) {
  return (s + cols + e - 1) / e;
}

// up=1, down=2. An item is output rows 2r, 2r+1 of the tile by the n outputs
// of chunk c (n = chunk<T>()): output (j, i) reads window rows 2j + ky and
// columns 2i + kx, so the item reads box rows 4r .. 4r+5 and, from box column
// 2nc on, columns S .. S+2n+1 (S: the window's first column in the box,
// which starts on 16 bytes, as TMA needs).
struct Down {
  template <class T>  // a tile's width is a multiple of this
  __host__ __device__ static constexpr int tw_unit() { return chunk<T>(); }
  __host__ __device__ static constexpr int th_unit() { return 2; }
  // box columns the items of a tile read
  __host__ __device__ static constexpr int need_w(int tw, int s, int e) {
    return 2 * tw + (s + 2 + e - 1) / e * e;
  }
  __host__ __device__ static constexpr int need_h(int th) { return 2 * th + 2; }
  __device__ static int box_offset(int r, int c, int box_w, int n) {
    return 4 * r * box_w + 2 * n * c;
  }

  template <int S, class T>
  static __device__ __forceinline__ void item(const T* box, int box_w, T* __restrict__ out,
                                              const Taps& taps, int Ho, int Wo, int oy, int ox,
                                              bool vec, int) {
    constexpr int n = chunk<T>(), nch = chunks_read(S, 2 * n + 2, n);
    float acc[2][n];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < n; ++i) acc[j][i] = 0.0f;
#pragma unroll
    for (int rr = 0; rr < 6; ++rr) {
      float v[nch * n];
#pragma unroll
      for (int c = 0; c < nch; ++c) load16(box + rr * box_w + c * n, v + c * n);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ky = rr - 2 * j;
        if (ky < 0 || ky >= kTaps) continue;
#pragma unroll
        for (int i = 0; i < n; ++i)
#pragma unroll
          for (int kx = 0; kx < kTaps; ++kx)
            acc[j][i] = fmaf(v[S + 2 * i + kx], tap(taps, ky, kx), acc[j][i]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (oy + j >= 0 && oy + j < Ho)
        store_chunk(out + (long long)(oy + j) * Wo, acc[j], ox, Wo, vec);
  }
};

// up=2, down=1. An item is one quad row r (output rows 2r, 2r+1) by the n
// outputs of one chunk c (h = n/2 quads): quad (a, b) reads window rows
// a .. a+2 and columns b .. b+2; output row 2a + dy takes window row a + aa
// with tap ky = 2aa - dy, and the same for columns. The item reads box rows
// r .. r+2 and, from box column n*(c/2) on, columns S + h*(c%2) .. + h+1:
// two neighbouring items read the same chunks (a broadcast) and pick their
// half, so a warp's lanes store consecutive chunks of a row. A tile's width
// is a multiple of 2n, so the last pair's reads stay in the box.
struct Up {
  template <class T>
  __host__ __device__ static constexpr int tw_unit() { return 2 * chunk<T>(); }
  __host__ __device__ static constexpr int th_unit() { return 2; }
  __host__ __device__ static constexpr int need_w(int tw, int s, int e) {
    return tw / 2 + (s + 2 + e - 1) / e * e;
  }
  __host__ __device__ static constexpr int need_h(int th) { return th / 2 + 2; }
  __device__ static int box_offset(int r, int c, int box_w, int n) {
    return r * box_w + n * (c >> 1);
  }

  template <int S, class T>
  static __device__ __forceinline__ void item(const T* box, int box_w, T* __restrict__ out,
                                              const Taps& taps, int Ho, int Wo, int oy, int ox,
                                              bool vec, int c) {
    constexpr int n = chunk<T>(), h = n / 2, nch = chunks_read(S, n + 2, n);
    const bool odd = (c & 1) != 0;
    float acc[2][n];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int i = 0; i < n; ++i) acc[dy][i] = 0.0f;
#pragma unroll
    for (int aa = 0; aa < 3; ++aa) {
      float f[nch * n], v[h + 2];
#pragma unroll
      for (int k = 0; k < nch; ++k) load16(box + aa * box_w + k * n, f + k * n);
#pragma unroll
      for (int j = 0; j < h + 2; ++j) v[j] = odd ? f[S + h + j] : f[S + j];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int ky = 2 * aa - dy;
        if (ky < 0 || ky >= kTaps) continue;
#pragma unroll
        for (int b = 0; b < h; ++b)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx)
#pragma unroll
            for (int bb = 0; bb < 3; ++bb) {
              const int kx = 2 * bb - dx;
              if (kx < 0 || kx >= kTaps) continue;
              acc[dy][2 * b + dx] = fmaf(v[b + bb], tap(taps, ky, kx), acc[dy][2 * b + dx]);
            }
      }
    }
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
      if (oy + dy >= 0 && oy + dy < Ho)
        store_chunk(out + (long long)(oy + dy) * Wo, acc[dy], ox, Wo, vec);
  }
};

// up=1, down=1, in strips: an item of a consumer warp is kStripRows output
// rows by up to 32 x 4 output columns, four a lane (consume_quads). Output
// (j, c) reads window rows j .. j+3 and columns c .. c+3, so a lane reads 7
// columns of kStripRows + 3 window rows. The window's column 0 sits `delta`
// elements into each stage row: sx for a TMA box, and for a row copy that
// row's own address mod 16 bytes (a runtime value, 0 .. n-1 for n = 16 /
// sizeof(T)), so a lane loads three aligned groups of four elements from
// its own columns (16 bytes each in float32, 8 in bfloat16) and applies
// the shift in registers. A box covers up to n - 1 columns before the
// window and tw + 3 after, in whole 16 bytes: tw + 2n.
constexpr int kStripRows = 8;
constexpr int kStagingBytes = kConsumerWarps * 32 * 4 * 4;  // a row of 128 float32 a warp

struct Same {
  template <class T>  // a tile's width is a multiple of 16 bytes
  __host__ __device__ static constexpr int tw_unit() { return chunk<T>(); }
  __host__ __device__ static constexpr int th_unit() { return kStripRows; }
  // box columns a tile reads: tw + 3 from column s of the box (s <= e - 1)
  __host__ __device__ static constexpr int need_w(int tw, int s, int e) {
    return tw + (s + 3 + e - 1) / e * e;
  }
  __host__ __device__ static constexpr int need_h(int th) { return th + 3; }
};

struct TileAt {
  long long plane;
  int oy, ox, iy, ix;
};

__device__ __forceinline__ TileAt locate(const Plan& p, long long tile) {
  const long long per_plane = (long long)p.tiles_y * p.tiles_x;
  const long long plane = tile / per_plane;
  const int rem = (int)(tile - plane * per_plane);
  const int ty = rem / p.tiles_x, tx = rem - ty * p.tiles_x;
  return {plane, p.oy0 + ty * p.th, p.ox0 + tx * p.tw, p.iy0 + ty * p.iy_step,
          p.ix0 + tx * p.ix_step};
}

// Copy the box rows of lane's share (rows lane, lane + 32, ...) into a stage,
// each row by one 1-D bulk copy, whatever the input's row pitch: row r of
// the stage holds the input's bytes from the 16-byte boundary at or before
// the address of its window column 0 on, so that column sits `delta` =
// (address mod 16) / E elements into the row. A row copies the 16-byte
// floor of its first window column inside the input to the ceiling of its
// last, clamped to the 16-byte boundaries inside the tensor; the elements
// of those columns that clamping leaves out (at most 15 bytes at either end
// of the tensor) are copied one by one. Rows outside [0, H) are not copied.
// The lane adds its rows' bytes to the stage's expected count before it
// starts their copies, and arrives after them.
template <class T>
__device__ __forceinline__ void copy_rows(const T* __restrict__ x, const Plan& p, const TileAt& t,
                                          T* box, uint32_t bar, int lane, int H, int W) {
  constexpr int E = sizeof(T);
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  const uintptr_t lo16 = (base + 15) & ~(uintptr_t)15;
  const uintptr_t hi16 = (base + (uintptr_t)p.x_elems * E) & ~(uintptr_t)15;
  const int wx = t.ix + p.sx;  // the tile's window column 0
  const int c_lo = max(wx, 0), c_hi = min(wx + p.tw + 3, W);
  for (int r = lane; r < p.box_h; r += 32) {
    const int gy = t.iy + r;
    if (gy < 0 || gy >= H || c_lo >= c_hi) continue;
    const long long row = (t.plane * H + gy) * (long long)W;
    const uintptr_t row_a = (base + (uintptr_t)(row + wx) * E) & ~(uintptr_t)15;
    const uintptr_t a_lo = base + (uintptr_t)(row + c_lo) * E;
    const uintptr_t a_hi = base + (uintptr_t)(row + c_hi) * E;
    const uintptr_t f0 = a_lo & ~(uintptr_t)15, f1 = (a_hi + 15) & ~(uintptr_t)15;
    uintptr_t c0 = f0 > lo16 ? f0 : lo16, c1 = f1 < hi16 ? f1 : hi16;
    char* dst = reinterpret_cast<char*>(box + r * p.box_w);
    if (c1 > c0) {
      mbar_expect(bar, (uint32_t)(c1 - c0));
      bulk_load(smem_addr(dst + (c0 - row_a)), reinterpret_cast<const void*>(c0),
                (uint32_t)(c1 - c0), bar);
    } else {
      c0 = c1 = a_hi;  // no whole 16 bytes inside the tensor: every element alone
    }
    for (uintptr_t a = a_lo; a < c0 && a < a_hi; a += E)
      *reinterpret_cast<T*>(dst + (a - row_a)) = *reinterpret_cast<const T*>(a);
    for (uintptr_t a = c1 > a_lo ? c1 : a_lo; a < a_hi; a += E)
      *reinterpret_cast<T*>(dst + (a - row_a)) = *reinterpret_cast<const T*>(a);
  }
}

// The producer warp: the loads of the block's tiles, in order, into the ring.
// TMA: one elected thread waits for a stage to empty and starts its box's
// copy. Row copies (`rows`, the stride-1 instance only): the warp's 32
// threads each copy their share of the box's rows (copy_rows) and arrive on
// the stage's full barrier. Otherwise the 32 threads copy the box element by
// element, zeros outside the input, and each arrives.
template <class T>
__device__ __forceinline__ void produce(const CUtensorMap* map, const T* __restrict__ x,
                                        const Plan& p, T* ring, const uint64_t* full,
                                        const uint64_t* empty, int H, int W) {
  const int lane = threadIdx.x & 31;
  if (p.tma && lane != 0) return;
  const uint32_t box_bytes = (uint32_t)(p.box_h * p.box_w * sizeof(T));
  int s = 0;
  uint32_t phase = 0;
  for (long long tile = blockIdx.x, i = 0; tile < p.tiles; tile += gridDim.x, ++i) {
    if (i >= p.stages) mbar_wait(smem_addr(&empty[s]), phase ^ 1);
    const TileAt t = locate(p, tile);
    T* box = ring + (long long)s * p.stage_elems;
    if (p.tma) {
      mbar_expect_tx(smem_addr(&full[s]), box_bytes);
      tma_load(smem_addr(box), map, smem_addr(&full[s]), t.ix, t.iy, (int)t.plane);
    } else if (p.rows) {
      // the copy engine's writes come after this stage's element writes of an earlier tile
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      copy_rows(x, p, t, box, smem_addr(&full[s]), lane, H, W);
      mbar_arrive(smem_addr(&full[s]));
    } else {
      const T* xs = x + t.plane * H * W;
      for (int r = 0; r < p.box_h; ++r) {
        const int gy = t.iy + r;
        for (int c = lane; c < p.box_w; c += 32) {
          const int gx = t.ix + c;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          box[r * p.box_w + c] = in ? xs[(long long)gy * W + gx] : T(0.0f);
        }
      }
      mbar_arrive(smem_addr(&full[s]));
    }
    if (++s == p.stages) s = 0, phase ^= 1;
  }
}

// The consumer warps: each tile's items, as its stage fills; each warp
// releases the stage when its items are stored.
template <class Cfg, int S, class T>
__device__ __forceinline__ void consume(T* __restrict__ out, const Taps& taps, const Plan& p,
                                        const T* ring, const uint64_t* full,
                                        const uint64_t* empty, int Ho, int Wo) {
  constexpr int n = chunk<T>();  // an item's outputs per row
  const int cols = p.tw / n;
  const int items = (p.th / 2) * cols;
  int s = 0;
  uint32_t phase = 0;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    mbar_wait(smem_addr(&full[s]), phase);
    const TileAt t = locate(p, tile);
    const T* box = ring + (long long)s * p.stage_elems;
    T* plane = out + t.plane * Ho * Wo;
    for (int it = threadIdx.x; it < items; it += kConsumers) {
      const int r = it / cols, c = it - r * cols;
      Cfg::template item<S>(box + Cfg::box_offset(r, c, p.box_w, n), p.box_w, plane, taps, Ho,
                            Wo, t.oy + 2 * r, t.ox + n * c, p.vec_out, c);
    }
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(smem_addr(&empty[s]));
    if (++s == p.stages) s = 0, phase ^= 1;
  }
}

// A lane of the stride-1 instance's consumers: four output columns, read as
// three aligned groups of four elements (16 bytes in float32, 8 in
// bfloat16) from the stage row, words in order.
constexpr int kLaneCols = 4;

__device__ __forceinline__ void load_quads(const float* p, uint32_t* w) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint4 u = q[k];
    w[4 * k] = u.x, w[4 * k + 1] = u.y, w[4 * k + 2] = u.z, w[4 * k + 3] = u.w;
  }
}

__device__ __forceinline__ void load_quads(const bf16* p, uint32_t* w) {
  const uint2* q = reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const uint2 u = q[k];
    w[2 * k] = u.x, w[2 * k + 1] = u.y;
  }
}

// The 7 elements that start `s` (0 .. 3) elements into the three groups,
// as floats: selects on s's bits, which are uniform over a warp.
__device__ __forceinline__ void window(const uint32_t* w, int s, float* v, float) {
  uint32_t g[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) g[i] = s & 1 ? w[i + 1] : w[i];
#pragma unroll
  for (int i = 0; i < 7; ++i) v[i] = __uint_as_float(s & 2 ? g[i + 2] : g[i]);
}

__device__ __forceinline__ void window(const uint32_t* w, int s, float* v, bf16) {
  uint32_t a[5];  // a whole word, then half a word by a funnel shift
#pragma unroll
  for (int i = 0; i < 5; ++i) a[i] = s & 2 ? w[i + 1] : w[i];
  const uint32_t half = (s & 1) * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t d = __funnelshift_r(a[i], a[i + 1], half);
    v[2 * i] = __uint_as_float(d << 16);
    if (2 * i + 1 < 7) v[2 * i + 1] = __uint_as_float(d & 0xffff0000u);
  }
}

// Four outputs to shared memory: 16 bytes of float32, 8 of bfloat16.
__device__ __forceinline__ void store_quad(float* p, const float* v) { store16(p, v); }
__device__ __forceinline__ void store_quad(bf16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
}

// The stride-1 instance's consumer warps. A warp's item is one strip of
// kStripRows output rows by up to 32 x kLaneCols columns (a lane each 4),
// so a tile of th x tw is th / kStripRows x ceil(tw / 128) items, which go
// round-robin to the warps from where the previous tile's left off. Each
// lane walks its strip's kStripRows + 3 window rows once: three aligned
// loads from its columns, the row's shift applied in registers (`window`),
// columns outside the input selected to zero on a tile at the image's edge,
// rows outside it skipped (their terms are exact zeros), and each row feeds
// the up to four output rows whose sums it continues, ky outer and kx
// inner. A finished output row leaves through the warp's staging row in
// shared memory: four outputs per lane in, then 32 neighbouring outputs per
// store instruction out.
template <class T>
__device__ __forceinline__ void consume_quads(const T* __restrict__ x, T* __restrict__ out,
                                              const Taps& taps, const Plan& p, const T* ring,
                                              T* staging, const uint64_t* full,
                                              const uint64_t* empty, int H, int W, int Ho,
                                              int Wo) {
  constexpr int E = sizeof(T), L = kLaneCols, span = 32 * L;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* stage_row = staging + warp * span;
  const int groups = (p.tw + span - 1) / span;
  const int items = p.th / kStripRows * groups;
  const uint32_t x_mod = (uint32_t)(reinterpret_cast<uintptr_t>(x) & 15);
  const uint32_t row_mod = ((uint32_t)W * E) & 15;  // bytes a row moves an address mod 16
  int s = 0, first = warp;
  uint32_t phase = 0;
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    mbar_wait(smem_addr(&full[s]), phase);
    const TileAt t = locate(p, tile);
    const T* box = ring + (long long)s * p.stage_elems;
    T* plane = out + t.plane * Ho * Wo;
    const int wx = t.ix + p.sx;  // the tile's window column 0
    const bool edge = wx < 0 || wx + p.tw + 3 > W;
    // stage row 0's window column 0, in bytes past a 16-byte boundary (row copies)
    const uint32_t mod0 =
        (x_mod + (uint32_t)(uint64_t)((t.plane * H + t.iy) * (long long)W + wx) * E) & 15;
    for (int it = first; it < items; it += kConsumerWarps) {
      const int seg = it / groups, col0 = (it - seg * groups) * span;
      const int oy = t.oy + seg * kStripRows;
      const int cnt = min(min(span, p.tw - col0), Wo - t.ox - col0);  // columns stored
      if (oy >= Ho || cnt <= 0) continue;
      const int c0 = col0 + lane * L;  // the lane's first tile column
      const bool active = lane * L < cnt;
      float acc[kStripRows][L];
#pragma unroll
      for (int j = 0; j < kStripRows; ++j)
#pragma unroll
        for (int i = 0; i < L; ++i) acc[j][i] = 0.0f;
#pragma unroll
      for (int rr = 0; rr < kStripRows + kTaps - 1; ++rr) {
        const int r = seg * kStripRows + rr;
        if (active && (unsigned)(t.iy + r) < (unsigned)H) {
          // the window's column 0 in this stage row: groups of 4 past c0, then elements
          const int delta = p.rows ? (int)(((mod0 + (uint32_t)r * row_mod) & 15) / E) : p.sx;
          uint32_t w[3 * L * E / 4];
          load_quads(box + r * p.box_w + c0 + (delta & ~(L - 1)), w);
          float v[L + kTaps - 1];
          window(w, delta & (L - 1), v, T{});
          if (edge) {
#pragma unroll
            for (int i = 0; i < L + kTaps - 1; ++i)
              v[i] = (unsigned)(wx + c0 + i) < (unsigned)W ? v[i] : 0.0f;
          }
#pragma unroll
          for (int ky = 0; ky < kTaps; ++ky) {
            const int j = rr - ky;  // the output row this row is tap row ky of
            if (j < 0 || j >= kStripRows) continue;
#pragma unroll
            for (int i = 0; i < L; ++i)
#pragma unroll
              for (int kx = 0; kx < kTaps; ++kx)
                acc[j][i] = fmaf(v[i + kx], tap(taps, ky, kx), acc[j][i]);
          }
        }
        const int done = rr - (kTaps - 1);  // the output row whose last tap row this was
        if (done >= 0 && oy + done < Ho) {
          __syncwarp();  // the row before is read
          store_quad(stage_row + lane * L, acc[done]);
          __syncwarp();
          T* row = plane + (long long)(oy + done) * Wo + t.ox + col0;
#pragma unroll
          for (int k = 0; k < L; ++k) {
            const int col = k * 32 + lane;
            if (col < cnt) row[col] = stage_row[col];
          }
        }
      }
    }
    first = ((first - items) % kConsumerWarps + kConsumerWarps) % kConsumerWarps;
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
    if (++s == p.stages) s = 0, phase ^= 1;
  }
}

template <class Cfg, int S, class T>
__device__ __forceinline__ void run(const CUtensorMap* map, const T* __restrict__ x,
                                    T* __restrict__ out, const Taps& taps, const Plan& p, int H,
                                    int W, int Ho, int Wo) {
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  extern __shared__ __align__(128) unsigned char dyn[];
  // the ring starts on 128 bytes (TMA's alignment for a box in shared memory)
  T* ring = reinterpret_cast<T*>(dyn + ((128 - (smem_addr(dyn) & 127)) & 127));
  if (threadIdx.x == kConsumers) {  // the producer's elected thread
    if (p.tma) {
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
    }
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_addr(&full[s]), p.tma ? 1 : 32);
      mbar_init(smem_addr(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {
    produce(map, x, p, ring, full, empty, H, W);
  } else if constexpr (std::is_same<Cfg, Same>::value) {
    T* staging = ring + (long long)p.stages * p.stage_elems;  // after the ring, on 128 bytes
    consume_quads(x, out, taps, p, ring, staging, full, empty, H, W, Ho, Wo);
  } else {
    consume<Cfg, S>(out, taps, p, ring, full, empty, Ho, Wo);
  }
}

// One instance per configuration, window shift S (0 .. chunk - 1) and type;
// the stride-1 instance reads at a runtime shift and has one per type.
template <int S, class T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
upfirdn2d_down2(const __grid_constant__ CUtensorMap map, const T* __restrict__ x,
                T* __restrict__ out, Taps taps, Plan p, int H, int W, int Ho, int Wo) {
  run<Down, S>(&map, x, out, taps, p, H, W, Ho, Wo);
}

template <int S, class T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
upfirdn2d_up2(const __grid_constant__ CUtensorMap map, const T* __restrict__ x,
              T* __restrict__ out, Taps taps, Plan p, int H, int W, int Ho, int Wo) {
  run<Up, S>(&map, x, out, taps, p, H, W, Ho, Wo);
}

template <class T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
upfirdn2d_same1(const __grid_constant__ CUtensorMap map, const T* __restrict__ x,
                T* __restrict__ out, Taps taps, Plan p, int H, int W, int Ho, int Wo) {
  run<Same, 0>(&map, x, out, taps, p, H, W, Ho, Wo);
}

template <class T>
using KernelFn = void (*)(const CUtensorMap, const T*, T*, Taps, Plan, int, int, int, int);

template <class Cfg, int S, class T>
constexpr KernelFn<T> kernel_of() {
  if constexpr (std::is_same<Cfg, Down>::value) {
    return upfirdn2d_down2<S, T>;
  } else if constexpr (std::is_same<Cfg, Up>::value) {
    return upfirdn2d_up2<S, T>;
  } else {
    return upfirdn2d_same1<T>;
  }
}

// The instance for shift s.
template <class Cfg, class T, int... S>
KernelFn<T> instance(int s, std::integer_sequence<int, S...>) {
  constexpr KernelFn<T> fns[] = {kernel_of<Cfg, S, T>()...};
  return fns[s];
}

// cuTensorMapEncodeTiled, found once through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

template <class T>
constexpr CUtensorMapDataType tensor_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// Check a plan against what the kernel reads and TMA takes, and unpack it.
template <class Cfg, class T>
cudaError_t unpack(const int* f, const void* x, const void* out, long long planes, int H,
                   int W, int Wo, Plan* p, int* sx) {
  constexpr int e = chunk<T>();
  constexpr bool kSame = std::is_same<Cfg, Same>::value;
  *p = Plan{};
  p->th = f[kTh], p->tw = f[kTw], p->tiles_y = f[kTilesY], p->tiles_x = f[kTilesX];
  p->oy0 = f[kOy0], p->ox0 = f[kOx0], p->iy0 = f[kIy0], p->ix0 = f[kIx0];
  p->iy_step = f[kIyStep], p->ix_step = f[kIxStep], p->box_h = f[kBoxH], p->box_w = f[kBoxW];
  p->stages = f[kStages], p->tma = f[kTma] != 0, p->vec_out = f[kVecOut] != 0;
  p->rows = f[kRows] != 0;
  p->tiles = planes * p->tiles_y * p->tiles_x;
  p->x_elems = planes * H * (long long)W;
  p->stage_elems = (p->box_h * p->box_w * (int)sizeof(T) + 127) / 128 * 128 / (int)sizeof(T);
  *sx = p->sx = f[kSx];
  const bool ok =
      p->th > 0 && p->th % Cfg::th_unit() == 0 && p->tw > 0 &&
      p->tw % Cfg::template tw_unit<T>() == 0 && p->tiles_y > 0 && p->tiles_x > 0 &&
      f[kGrid] > 0 && p->stages >= 1 && p->stages <= kMaxStages && *sx >= 0 && *sx < e &&
      p->box_h >= Cfg::need_h(p->th) && p->box_w >= Cfg::need_w(p->tw, kSame ? e - 1 : *sx, e) &&
      p->box_w % e == 0 && p->box_h <= 256 &&
      p->box_w <= 256 && planes < (1LL << 31) &&
      (long long)p->stages * p->stage_elems * sizeof(T) + 128 + (kSame ? kStagingBytes : 0) <=
          kMaxDynSmem &&
      // TMA: rows and the base on 16 bytes, each box's first column too
      (!p->tma || (W % e == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   ((p->ix0 % e) + e) % e == 0 && p->ix_step % e == 0)) &&
      (!p->vec_out || (Wo % e == 0 && p->ox0 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0)) &&
      // row copies: the stride-1 instance's consumers read at a runtime shift
      (!p->rows || (kSame && !p->tma &&
                    reinterpret_cast<uintptr_t>(x) % sizeof(T) == 0));
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

template <class Cfg, class T>
cudaError_t launch(const T* x, T* out, const Taps& taps, const int* fields,
                   long long planes, int H, int W, int Ho, int Wo, cudaStream_t s) {
  constexpr int e = chunk<T>();
  Plan p;
  int sx;
  cudaError_t err = unpack<Cfg, T>(fields, x, out, planes, H, W, Wo, &p, &sx);
  if (err != cudaSuccess) return err;
  const KernelFn<T> fn = instance<Cfg, T>(sx, std::make_integer_sequence<int, e>{});
  const size_t smem = (size_t)p.stages * p.stage_elems * sizeof(T) + 128 +
                      (std::is_same<Cfg, Same>::value ? kStagingBytes : 0);
  // above 48 KB at every launch: an attribute set once was seen refused from
  // another thread after a profiler trace had run
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  CUtensorMap map = {};
  if (p.tma) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)planes};
    const cuuint64_t strides[2] = {(cuuint64_t)W * sizeof(T), (cuuint64_t)H * W * sizeof(T)};
    const cuuint32_t box[3] = {(cuuint32_t)p.box_w, (cuuint32_t)p.box_h, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    if (encode(&map, tensor_type<T>(), 3, const_cast<T*>(x), dims, strides, box, unit,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
        CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  fn<<<fields[kGrid], kThreads, smem, s>>>(map, x, out, taps, p, H, W, Ho, Wo);
  return cudaGetLastError();
}

template <class T>
cudaError_t dispatch(const void* x, void* out, const Taps& taps, const int* plan,
                     long long planes, int H, int W, int Ho, int Wo, int up, int down,
                     cudaStream_t s) {
  const T* xi = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (up == 1 && down == 2) {
    return launch<Down, T>(xi, o, taps, plan, planes, H, W, Ho, Wo, s);
  }
  if (up == 2 && down == 1) {
    return launch<Up, T>(xi, o, taps, plan, planes, H, W, Ho, Wo, s);
  }
  if (up == 1 && down == 1) {
    return launch<Same, T>(xi, o, taps, plan, planes, H, W, Ho, Wo, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int storm_upfirdn2d(const void* x, void* out, const void* taps_host, int flip,
                               int device, long long planes, int H, int W, int Ho, int Wo,
                               int up, int down, int pad0, int dtype, void* stream,
                               const int* plan) {
  (void)pad0;  // the plan's origins carry it
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
    err = dispatch<float>(x, out, taps, plan, planes, H, W, Ho, Wo, up, down, s);
  } else {
    err = dispatch<bf16>(x, out, taps, plan, planes, H, W, Ho, Wo, up, down, s);
  }
  return (int)err;
}

// The plan's length, its field order's version for callers that build plans.
extern "C" int storm_upfirdn2d_plan_len() { return kPlanLen; }

extern "C" const char* storm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
