// The 8^3 block grid of a dense volume for Hopper (sm_90a): per block b of
// tap anchors the least and the largest byte over the texels [8b, 8b + 8] of
// each axis (clamped to the edge, or wrapped for "repeat"), the grid that
// block_grid.cuh's BlockGrid reads.
//
// Replaces no TPU kernel: the JAX package builds its bind tables in jnp.  It
// computes exactly volumerenderer_tpu_torch/ops/blockgrid.py::iso_block_grid
// (a chain of torch reductions, one axis at a time, with an index_select copy
// of the volume for each axis's apron texel), bit for bit: a uint8 volume's
// bytes as they are, a float32 volume quantized as it is read,
// round(clamp(v, 0, 1) * 255) with ties to even (rintf, as torch.round; a NaN
// reads as 0, as the marches' taps read it).
//
// What bounds it on this card: it streams the volume once (3.22 GB for the
// 2048x2048x768 byte volume, 0.96 ms at 3.35 TB/s) and writes 2 bytes a
// block; a few integer operations a byte.  Only the memory rate matters.
//
// What this design does about it: each thread owns a column of 16 x texels
// (x-blocks 2t and 2t + 1) of one y-block: one 16-byte load a row (four for
// float32), neighbouring threads on neighbouring addresses.  It issues the
// loads of the 9 rows [8by, 8by + 8] of a plane together, before the first
// is used (the apron row, 1/8 more, comes from L2, where the next y-block's
// thread reads it too), and keeps each texel's least and largest byte in
// 16-bit lanes (__vminu2 and __vmaxu2 are one instruction each here; the
// byte-lane __vminu4 several).  It walks z through up to kWalk z-blocks
// itself, carrying plane 8b + 8 into block b + 1, so each plane is read
// about once, and no copy of the volume is made.  The x apron texel 16t +
// 16 is the next lane's first texel: at each block's end one
// __shfl_down_sync hands over its block-wide least and largest byte; a lane
// whose neighbour does not hold it (the last lane of a warp or of a row of
// threads, or the volume's edge) loads that texel itself.  Offsets are
// 64-bit: the volume may exceed 2^31 bytes.  Where a row is not 16-byte
// aligned (an X that is not a multiple of 16, a misaligned view) or the
// column is cut by the edge, the thread takes one load a texel, each index
// clamped or wrapped.
//
// Measured on the H100 at 2048x2048x768 bytes, against 0.96 ms: loading and
// reducing one row at a time (a load in flight per thread) 1.80 ms, of
// which __vminu4 and __vmaxu4 on byte lanes took 11 % (against AND and OR
// in their place).  With the loads issued together and 16-bit lanes: a
// grid of one wave of resident blocks, each walking 48 z-blocks, 1.18 ms
// against 1.07 for walks of 4 or 8 (many waves); the three-input
// __vimin3_u16x2 no faster than __vminu2; fewer registers forced by
// __launch_bounds__ (spills) slower.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // a block's threads: a row of columns per y-block
constexpr int kColumn = 16;     // x texels a thread owns: two x-blocks
constexpr int kWalk = 8;        // z-blocks a thread walks at most
constexpr int kWaves = 4;       // waves of resident blocks at least, where the volume allows
constexpr int kMaxDevices = 64;

// Index i >= 0 on an axis of n texels, clamped to the edge or wrapped.
template <bool kRepeat>
__device__ __forceinline__ int fold(int i, int n) {
  if (i < n) return i;
  return kRepeat ? i % n : n - 1;
}

__device__ __forceinline__ uint32_t quantize(float v) {
  return static_cast<uint32_t>(rintf(fminf(fmaxf(v, 0.0f), 1.0f) * 255.0f));
}

__device__ __forceinline__ uint32_t byte_at(const uint8_t* row, int x) {
  return __ldg(row + x);
}

__device__ __forceinline__ uint32_t byte_at(const float* row, int x) {
  return quantize(__ldg(row + x));
}

// The bytes of texels [x0, x0 + 16) of a row as 4 words, texel x0 + i in
// byte i % 4 of word i / 4: one 16-byte load (four for float32) where the
// column is whole and aligned (vec), else one load a texel, its index
// clamped or wrapped.
template <bool kRepeat>
__device__ __forceinline__ void load_column(const uint8_t* row, int x0, int X, bool vec,
                                            uint32_t w[4]) {
  if (vec) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + x0));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[j] |= byte_at(row, fold<kRepeat>(x0 + 4 * j + i, X)) << 8 * i;
  }
}

template <bool kRepeat>
__device__ __forceinline__ void load_column(const float* row, int x0, int X, bool vec,
                                            uint32_t w[4]) {
  if (vec) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + x0) + j);
      w[j] = quantize(v.x) | quantize(v.y) << 8 | quantize(v.z) << 16 | quantize(v.w) << 24;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w[j] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) w[j] |= byte_at(row, fold<kRepeat>(x0 + 4 * j + i, X)) << 8 * i;
  }
}

// A word's 4 texel bytes as two words of 16-bit lanes, the even texels
// (bytes 0, 2) and the odd (1, 3): a min or max of 16-bit lanes is one
// instruction on sm_90, of byte lanes several.
__device__ __forceinline__ uint32_t evens(uint32_t w) { return __byte_perm(w, 0u, 0x4240); }
__device__ __forceinline__ uint32_t odds(uint32_t w) { return __byte_perm(w, 0u, 0x4341); }

// The least and largest byte of each texel of a thread's column over a set
// of rows, in 16-bit lanes: word j of *_e holds texels 4j and 4j + 2, of
// *_o texels 4j + 1 and 4j + 3; and of its apron texel x0 + 16, where the
// thread reads that itself.
struct Span {
  uint32_t lo_e[4], lo_o[4], hi_e[4], hi_o[4], apron_lo, apron_hi;

  __device__ __forceinline__ void add(const Span& s) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo_e[j] = __vminu2(lo_e[j], s.lo_e[j]), lo_o[j] = __vminu2(lo_o[j], s.lo_o[j]);
      hi_e[j] = __vmaxu2(hi_e[j], s.hi_e[j]), hi_o[j] = __vmaxu2(hi_o[j], s.hi_o[j]);
    }
    apron_lo = min(apron_lo, s.apron_lo), apron_hi = max(apron_hi, s.apron_hi);
  }
};

// Span of the 9 rows [y0, y0 + 8] of plane p of the thread's column: the
// rows' loads all issued before the first is used.
template <class T, bool kRepeat>
__device__ __forceinline__ void plane_span(const T* __restrict__ vol, int p, int y0, int x0,
                                           bool vec, bool own_apron, int X, int Y, int Z,
                                           size_t sy, size_t sz, Span& s) {
  const T* plane = vol + static_cast<size_t>(fold<kRepeat>(p, Z)) * sz;
  const T* row[9];
  uint32_t w[9][4], apron[9];
#pragma unroll
  for (int k = 0; k <= 8; ++k) {
    row[k] = plane + static_cast<size_t>(fold<kRepeat>(y0 + k, Y)) * sy;
  }
#pragma unroll
  for (int k = 0; k <= 8; ++k) load_column<kRepeat>(row[k], x0, X, vec, w[k]);
#pragma unroll
  for (int k = 0; k <= 8; ++k) {
    apron[k] = own_apron ? byte_at(row[k], fold<kRepeat>(x0 + kColumn, X)) : 0u;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t lo_e = evens(w[0][j]), lo_o = odds(w[0][j]);
    uint32_t hi_e = lo_e, hi_o = lo_o;
#pragma unroll
    for (int k = 1; k <= 8; ++k) {
      const uint32_t e = evens(w[k][j]), o = odds(w[k][j]);
      lo_e = __vminu2(lo_e, e), lo_o = __vminu2(lo_o, o);
      hi_e = __vmaxu2(hi_e, e), hi_o = __vmaxu2(hi_o, o);
    }
    s.lo_e[j] = lo_e, s.lo_o[j] = lo_o, s.hi_e[j] = hi_e, s.hi_o[j] = hi_o;
  }
  s.apron_lo = s.apron_hi = apron[0];
#pragma unroll
  for (int k = 1; k <= 8; ++k) {
    s.apron_lo = min(s.apron_lo, apron[k]), s.apron_hi = max(s.apron_hi, apron[k]);
  }
}

// The least (kMin) or largest of the 16-bit lanes of a, b, c and d.
template <bool kMin>
__device__ __forceinline__ uint32_t fold_lanes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  const uint32_t m = kMin ? __vminu2(__vminu2(a, b), __vminu2(c, d))
                          : __vmaxu2(__vmaxu2(a, b), __vmaxu2(c, d));
  return kMin ? min(m & 0xFFFFu, m >> 16) : max(m & 0xFFFFu, m >> 16);
}

// Thread (threadIdx.x, threadIdx.y) of block (blockIdx.x, blockIdx.y): x
// column t and y-block by of x tile blockIdx.x % x_tiles and y tile
// blockIdx.x / x_tiles, z-blocks [blockIdx.y * nz_each, + nz_each).
// aligned: every row starts on 16 bytes.
template <class T, bool kRepeat>
__global__ void __launch_bounds__(kThreads)
block_grid_kernel(const T* __restrict__ vol, uint16_t* __restrict__ cells, int X, int Y, int Z,
                  size_t sy, size_t sz, bool aligned, int nbx, int nby, int nbz, int x_tiles,
                  int nz_each) {
  const int t = (blockIdx.x % x_tiles) * blockDim.x + threadIdx.x;
  const int by = (blockIdx.x / x_tiles) * blockDim.y + threadIdx.y;
  const int bz0 = blockIdx.y * nz_each;
  const int bz1 = min(bz0 + nz_each, nbz);
  // threads past the edge read the last column or y-block and write nothing
  const int x0 = kColumn * min(t, (X - 1) / kColumn);
  const int y0 = 8 * min(by, nby - 1);
  const bool vec = aligned && x0 + kColumn <= X;
  const int lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
  // the next lane holds texel x0 + 16 unless it is in another row of
  // threads or warp, or x0 + 16 is past the edge
  const bool own_apron = threadIdx.x + 1 == blockDim.x || lane == 31 || x0 + kColumn >= X;
  const int bx = 2 * t;
  const bool writes = by < nby && bx < nbx;

  Span carry, s;
  plane_span<T, kRepeat>(vol, 8 * bz0, y0, x0, vec, own_apron, X, Y, Z, sy, sz, carry);
  for (int bz = bz0; bz < bz1; ++bz) {
    Span block = carry;
#pragma unroll 1
    for (int k = 1; k <= 8; ++k) {
      plane_span<T, kRepeat>(vol, 8 * bz + k, y0, x0, vec, own_apron, X, Y, Z, sy, sz, s);
      block.add(s);
    }
    carry = s;  // plane 8bz + 8, the first of block bz + 1
    const uint32_t next_lo = __shfl_down_sync(0xFFFFFFFFu, block.lo_e[0], 1) & 0xFFFFu;
    const uint32_t next_hi = __shfl_down_sync(0xFFFFFFFFu, block.hi_e[0], 1) & 0xFFFFu;
    if (!writes) continue;
    uint16_t* cell = cells + (static_cast<size_t>(bz) * nby + by) * nbx + bx;
    // texels 0..7 and 8 (the first of block bx + 1), then 8..15 and the apron
    const uint32_t lo0 = min(fold_lanes<true>(block.lo_e[0], block.lo_e[1], block.lo_o[0],
                                              block.lo_o[1]), block.lo_e[2] & 0xFFFFu);
    const uint32_t hi0 = max(fold_lanes<false>(block.hi_e[0], block.hi_e[1], block.hi_o[0],
                                               block.hi_o[1]), block.hi_e[2] & 0xFFFFu);
    cell[0] = static_cast<uint16_t>(lo0 | hi0 << 8);
    if (bx + 1 < nbx) {
      const uint32_t lo1 = min(fold_lanes<true>(block.lo_e[2], block.lo_e[3], block.lo_o[2],
                                                block.lo_o[3]),
                               own_apron ? block.apron_lo : next_lo);
      const uint32_t hi1 = max(fold_lanes<false>(block.hi_e[2], block.hi_e[3], block.hi_o[2],
                                                 block.hi_o[3]),
                               own_apron ? block.apron_hi : next_hi);
      cell[1] = static_cast<uint16_t>(lo1 | hi1 << 8);
    }
  }
}

// Resident blocks of `kernel` on the whole current device, once per device.
template <class Kernel>
int resident_blocks(Kernel kernel, int cache[kMaxDevices]) {
  int device = 0;
  cudaGetDevice(&device);
  if (device >= 0 && device < kMaxDevices && cache[device] > 0) return cache[device];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int n = sms * per_sm > 0 ? sms * per_sm : 1;
  if (device >= 0 && device < kMaxDevices) cache[device] = n;
  return n;
}

template <class T, bool kRepeat>
int launch(const void* vol, void* cells, int X, int Y, int Z, long long sy, long long sz,
           void* stream) {
  static int resident[kMaxDevices] = {};
  auto* kernel = block_grid_kernel<T, kRepeat>;
  const int nbx = (X + 7) / 8, nby = (Y + 7) / 8, nbz = (Z + 7) / 8;
  const int columns = (X + kColumn - 1) / kColumn;
  int bdx = 1;  // a power of two up to kThreads, so a warp's rows of threads align
  while (bdx < columns && bdx < kThreads) bdx *= 2;
  const int bdy = kThreads / bdx;
  const long long x_tiles = (columns + bdx - 1) / bdx;
  const long long tiles = x_tiles * ((nby + bdy - 1) / bdy);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  // each thread walks up to kWalk z-blocks, fewer where the volume is too
  // small to give kWaves waves of resident blocks otherwise
  const long long walk = tiles * nbz / (kWaves * static_cast<long long>(
                                            resident_blocks(kernel, resident)));
  const int nz_each = static_cast<int>(walk < 1 ? 1 : (walk > kWalk ? kWalk : walk));
  const long long chunks = (nbz + nz_each - 1) / nz_each;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool aligned = reinterpret_cast<uintptr_t>(vol) % 16 == 0 &&
                       sy * sizeof(T) % 16 == 0 && sz * sizeof(T) % 16 == 0;
  kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(chunks)), dim3(bdx, bdy), 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vol), static_cast<uint16_t*>(cells), X, Y, Z,
      static_cast<size_t>(sy), static_cast<size_t>(sz), aligned, nbx, nby, nbz,
      static_cast<int>(x_tiles), nz_each);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launch writes the (ceil(Z/8), ceil(Y/8), ceil(X/8)) cells (2 bytes:
// the least byte low, the largest high) of the (Z, Y, X) volume at vol, x
// contiguous, rows sy and planes sz elements apart, on `stream`, and returns
// cudaGetLastError() (0 on success).  repeat: 0 clamp, 1 wrap.
extern "C" int block_grid_launch(const void* vol, void* cells, int X, int Y, int Z, int repeat,
                                 long long sy, long long sz, void* stream) {
  return repeat ? launch<uint8_t, true>(vol, cells, X, Y, Z, sy, sz, stream)
                : launch<uint8_t, false>(vol, cells, X, Y, Z, sy, sz, stream);
}

extern "C" int block_grid_f32_launch(const void* vol, void* cells, int X, int Y, int Z,
                                     int repeat, long long sy, long long sz, void* stream) {
  return repeat ? launch<float, true>(vol, cells, X, Y, Z, sy, sz, stream)
                : launch<float, false>(vol, cells, X, Y, Z, sy, sz, stream);
}

extern "C" const char* block_grid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
