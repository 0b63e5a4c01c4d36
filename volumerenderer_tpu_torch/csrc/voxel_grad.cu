// Voxel gradient of the TF compositing march for Hopper (sm_90a), one thread
// per ray: a forward replay of the march that forms each step's sample
// cotangent in closed form and scatters it into the gradient volume.
//
// Replaces the TPU voxel-gradient march: volumerenderer_tpu/ops/pallas/
// voxel_grad_kernel.py::_launch_vg (its pl.pallas_call) with the bodies
// _vg_kernel -> _vg_one_tile.  It computes
// volumerenderer_tpu_torch/diff/closed_form.py::voxel_grad_steps on the
// 8-bit volume: per ray, the march of tf_march.cu (alpha and the prefix P
// with the pre-update alpha, the same bounds exit and 0.99 early-out), and
// at every step the ray is alive, even at s = 0,
//   g_s = gc*((1 - a)*sc + pa*G) + K*(gaT_term - gc*(P_total - P)) / max(1 - K*s, 1e-12)
// added as g_s*wz*wy*wx into the 8 taps of the clamp-mode trilinear sample
// (trilinear.cuh, vrt::trilinear_adjoint).  gc, gaT_term = g_alpha*(1 - a_T)
// and P_total are per-ray (H, W) f32 inputs; the gradient volume (Z*Y*X f32)
// must be zero on entry.  The gradient is the float volume's, straight
// through the 8-bit quantization.
//
// What it reads: the kernel body is a template on its sampler, as
// tf_march.cu's.  voxel_grad_launch reads the 8-bit volume;
// voxel_grad_f32_launch reads the float32 volume the fit updates and
// quantizes each tap as it reads it (trilinear.cuh, VolumeSampler<float>),
// so a fit step's backward makes no byte copy of the volume.  Those taps are
// bit for bit the byte taps of quantize_u8(volume), so every step's s, g_s
// and tap weights, and every block's box, are the byte route's on that copy.
//
// What bounds it on this card: the adds.  A ray makes 8 per alive step, and
// the rays of a block cross the same few voxels (at 1024^2 rays over 256^3,
// about 4 rays per voxel side).  Float atomicAdds into the 67 MB gradient
// volume, which leaves the 50 MB L2, serialize on those addresses; in
// shared memory a float atomicAdd is a compare-and-swap loop (ATOMS.CAST.SPIN),
// which retries for every lane of a warp that hit the same address.  The
// march itself (tf_march.cu's, without the sums) is cheap.
//
// What this design does about it, in the spirit of the TPU kernel's
// window-local accumulator flushed once: each 8x8-pixel block accumulates in
// a shared-memory tile and flushes it once.
//   Pass 1 replays the forward march (alpha only) to each ray's last alive
//   step.  A straight ray's positions are monotone on each axis (each
//   rounded p + d moves with d's sign), so the tap anchors of its alive
//   steps lie in the box of its first and last alive anchors, plus one
//   texel; the block reduces that box in shared memory.
//   Pass 2, if the box fits kTileBudget floats: zero the tile, replay the
//   march with shared-memory atomicAdds, then flush each nonzero entry with
//   one global atomicAdd.  A block whose box does not fit adds to device
//   memory as before; both paths form the same sum.
//   Each lane takes its 8 taps starting at another corner (lane mod 8), so
//   neighbouring lanes, which share most of their taps, seldom add to one
//   address in the same instruction.
// Measured on the H100 and not kept: 16x8, 32x8 and 32x16 blocks; warp-
// aggregated adds (__match_any_sync, one add per distinct address) into
// device memory or into the tile; pairs of x taps added by one 64-bit
// compare-and-swap; tiles past 2048 floats, which cost blocks per SM.
// With `stats`, each block also writes its box voxels, its global adds and
// its alive steps.
//
// Rounding: built with --fmad=false, each product and sum in the plain
// version's order; IEEE division.  The order of the sums (shared, then
// global atomics) is not fixed, so the result matches the plain version to
// a tolerance, not bits.

#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr int kBlockX = 8;
constexpr int kBlockY = 8;
constexpr int kThreads = kBlockX * kBlockY;
// blocks per SM the registers must allow (40 registers a thread; ptxas
// spills 52-92 bytes a thread at this bound, on both routes, as it did
// before the sampler template); a tile of 2048 floats (8 KB) lets shared
// memory hold as many
constexpr int kMinBlocks = 24;
constexpr int kTileBudget = 2048;

__device__ __forceinline__ bool inside(float p0, float p1, float p2) {
  return p0 > 0.0f && p0 < 1.0f && p1 > 0.0f && p1 < 1.0f && p2 > 0.0f && p2 < 1.0f;
}

// v[k] for a k known only at run time, by selects (v stays in registers).
__device__ __forceinline__ float pick8(const float v[8], int k) {
  const float a = (k & 1) ? v[1] : v[0];
  const float b = (k & 1) ? v[3] : v[2];
  const float c = (k & 1) ? v[5] : v[4];
  const float d = (k & 1) ? v[7] : v[6];
  const float ab = (k & 2) ? b : a;
  const float cd = (k & 2) ? d : c;
  return (k & 4) ? cd : ab;
}

template <class Sampler>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
voxel_grad_kernel(const float* __restrict__ entry_uv, const float* __restrict__ dir_step,
                  const uint8_t* __restrict__ hit, Sampler sample, const float* __restrict__ tf,
                  const float* __restrict__ gc_img, const float* __restrict__ gaT_img,
                  const float* __restrict__ P_tot_img, int H, int W, int X, int Y, int Z,
                  int max_samples, float* __restrict__ g_vol, int* __restrict__ stats) {
  __shared__ float tile[kTileBudget];
  __shared__ int box[6];  // the block's lowest x, y, z tap index, then its highest
  __shared__ int n_global, n_steps;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const int px = blockIdx.x * kBlockX + threadIdx.x;
  const int py = blockIdx.y * kBlockY + threadIdx.y;
  const size_t ray = static_cast<size_t>(py) * static_cast<size_t>(W) + static_cast<size_t>(px);
  // no early return: every thread takes part in the block's barriers
  const bool active = px < W && py < H && hit[ray];

  const float K = __ldg(tf + 0);
  const float G = __ldg(tf + 1);
  const float B = __ldg(tf + 2);
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f, d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  if (active) {
    p0 = entry_uv[3 * ray + 0];
    p1 = entry_uv[3 * ray + 1];
    p2 = entry_uv[3 * ray + 2];
    d0 = dir_step[3 * ray + 0];
    d1 = dir_step[3 * ray + 1];
    d2 = dir_step[3 * ray + 2];
  }

  // pass 1: the box of the block's taps
  if (tid < 6) box[tid] = tid < 3 ? INT_MAX : INT_MIN;
  if (tid == 0) n_global = n_steps = 0;
  __syncthreads();
  {
    int lo[3] = {INT_MAX, INT_MAX, INT_MAX};
    int hi[3] = {INT_MIN, INT_MIN, INT_MIN};
    if (active) {
      float q0 = p0, q1 = p1, q2 = p2;
      float a = 0.0f;
      int steps = 0;
      for (int i = 0; i < max_samples; ++i) {
        const float r0 = q0 + d0;
        const float r1 = q1 + d1;
        const float r2 = q2 + d2;
        if (!inside(r0, r1, r2)) break;
        q0 = r0;
        q1 = r1;
        q2 = r2;
        ++steps;
        const float s = sample(q0, q1, q2);
        a = a + (s - s * a) * K;
        if (!(a <= 0.99f)) break;
      }
      if (steps > 0) {
        const float first[3] = {p0 + d0, p1 + d1, p2 + d2};
        const float last[3] = {q0, q1, q2};
        const int n[3] = {X, Y, Z};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float frac;
          const int f = vrt::texel(first[k], n[k], frac);
          const int l = vrt::texel(last[k], n[k], frac);
          lo[k] = vrt::wrap_index(min(f, l), n[k], false);
          hi[k] = vrt::wrap_index(max(f, l) + 1, n[k], false);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      lo[k] = __reduce_min_sync(0xffffffffu, lo[k]);
      hi[k] = __reduce_max_sync(0xffffffffu, hi[k]);
    }
    if ((tid & 31) == 0) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        atomicMin(&box[k], lo[k]);
        atomicMax(&box[3 + k], hi[k]);
      }
    }
  }
  __syncthreads();
  const int bx = box[0];
  const int by = box[1];
  const int bz = box[2];
  int nx = 0, ny = 0;
  long long box_voxels = 0;
  if (box[3] >= bx) {  // some ray of the block has an alive step
    nx = box[3] - bx + 1;
    ny = box[4] - by + 1;
    box_voxels = static_cast<long long>(nx) * ny * (box[5] - bz + 1);
  }
  const bool tiled = box_voxels > 0 && box_voxels <= kTileBudget;
  if (tiled) {
    for (int k = tid; k < box_voxels; k += kThreads) tile[k] = 0.0f;
    __syncthreads();
  }

  // pass 2: the march and its adds
  if (active) {
    const float gc = gc_img[ray];
    const float gaT_term = gaT_img[ray];
    const float P_tot = P_tot_img[ray];
    float a = 0.0f;
    float P = 0.0f;
    int steps = 0;
    for (int i = 0; i < max_samples; ++i) {
      p0 = p0 + d0;
      p1 = p1 + d1;
      p2 = p2 + d2;
      if (!inside(p0, p1, p2)) break;
      ++steps;

      const float s = sample(p0, p1, p2);
      const float sc = s * G + B;
      const float pa = s - s * a;
      P = P + s * sc * (1.0f - a);
      const float denom = fmaxf(1.0f - K * s, 1e-12f);
      const float ga_term = K * (gaT_term - gc * (P_tot - P)) / denom;
      const float g_s = gc * ((1.0f - a) * sc + pa * G) + ga_term;

      int xs[2], ys[2], zs[2];
      float weight[8];
      vrt::trilinear_adjoint(p0, p1, p2, X, Y, Z, g_s, xs, ys, zs, weight);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int k = (j + tid) & 7;  // this lane's j-th tap
        const float wk = pick8(weight, k);
        const int x = (k & 1) ? xs[1] : xs[0];
        const int y = (k & 2) ? ys[1] : ys[0];
        const int z = (k & 4) ? zs[1] : zs[0];
        if (tiled) {
          atomicAdd(tile + ((z - bz) * ny + (y - by)) * nx + (x - bx), wk);
        } else {
          atomicAdd(g_vol + (static_cast<size_t>(z) * Y + y) * X + x, wk);
        }
      }

      a = a + pa * K;
      if (!(a <= 0.99f)) break;
    }
    if (stats != nullptr) {
      atomicAdd(&n_steps, steps);
      if (!tiled) atomicAdd(&n_global, 8 * steps);
    }
  }

  // the flush: one global add per nonzero entry of the tile
  if (tiled) {
    __syncthreads();
    for (int k = tid; k < box_voxels; k += kThreads) {
      const float v = tile[k];
      if (v != 0.0f) {
        const int x = bx + k % nx;
        const int y = by + (k / nx) % ny;
        const int z = bz + k / (nx * ny);
        atomicAdd(g_vol + (static_cast<size_t>(z) * Y + y) * X + x, v);
        if (stats != nullptr) atomicAdd(&n_global, 1);
      }
    }
  }
  if (stats != nullptr) {
    __syncthreads();
    if (tid == 0) {
      const size_t block = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
      stats[3 * block + 0] = static_cast<int>(min(box_voxels, static_cast<long long>(INT_MAX)));
      stats[3 * block + 1] = n_global;
      stats[3 * block + 2] = n_steps;
    }
  }
}

template <class Sampler>
int launch(const void* entry_uv, const void* dir_step, const void* hit, Sampler sample,
           const void* tf, const void* gc, const void* gaT_term, const void* P_tot, int H, int W,
           int X, int Y, int Z, int max_samples, void* g_vol, void* stats, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  voxel_grad_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entry_uv), static_cast<const float*>(dir_step),
      static_cast<const uint8_t*>(hit), sample, static_cast<const float*>(tf),
      static_cast<const float*>(gc), static_cast<const float*>(gaT_term),
      static_cast<const float*>(P_tot), H, W, X, Y, Z, max_samples, static_cast<float*>(g_vol),
      static_cast<int*>(stats));
  return static_cast<int>(cudaGetLastError());
}

// B5 on a dense volume of T (uint8_t: bytes; float: taps quantized as read),
// clamp-only, with B4's sampler.
template <class T>
int launch_dense(const void* entry_uv, const void* dir_step, const void* hit, const void* vol,
                 const void* tf, const void* gc, const void* gaT_term, const void* P_tot, int H,
                 int W, int X, int Y, int Z, int max_samples, void* g_vol, void* stats,
                 void* stream) {
  return vrt::with_volume_sampler<T, false>(vol, X, Y, Z, [&](auto sample) {
    return launch(entry_uv, dir_step, hit, sample, tf, gc, gaT_term, P_tot, H, W, X, Y, Z,
                  max_samples, g_vol, stats, stream);
  });
}

}  // namespace

// Each launch runs the gradient march on `stream` for an H x W ray image and
// returns cudaGetLastError() (0 on success).  Pointers are device pointers:
// entry_uv and dir_step (H*W*3 f32), hit (H*W u8), tf (3 f32: K, G, B), gc,
// gaT_term and P_tot (H*W f32), g_vol (Z*Y*X f32, zero on entry; the
// gradient is added into it).  stats is null, or 3 i32 per block of the grid
// (blocks_x = ceil(W / block_x) fastest): the block's box voxels (0 for a
// block without an alive step), the global atomicAdds it made and its rays'
// alive steps.

// vol: Z*Y*X u8, x fastest.
extern "C" int voxel_grad_launch(const void* entry_uv, const void* dir_step, const void* hit,
                                 const void* vol, const void* tf, const void* gc,
                                 const void* gaT_term, const void* P_tot, int H, int W, int X,
                                 int Y, int Z, int max_samples, void* g_vol, void* stats,
                                 void* stream) {
  return launch_dense<uint8_t>(entry_uv, dir_step, hit, vol, tf, gc, gaT_term, P_tot, H, W, X, Y,
                               Z, max_samples, g_vol, stats, stream);
}

// vol: Z*Y*X f32, x fastest, each tap quantized to 8 bits as it is read: the
// same gradient and block counters as voxel_grad_launch on quantize_u8 of the
// volume, with no quantize pass before it.
extern "C" int voxel_grad_f32_launch(const void* entry_uv, const void* dir_step, const void* hit,
                                     const void* vol, const void* tf, const void* gc,
                                     const void* gaT_term, const void* P_tot, int H, int W,
                                     int X, int Y, int Z, int max_samples, void* g_vol,
                                     void* stats, void* stream) {
  return launch_dense<float>(entry_uv, dir_step, hit, vol, tf, gc, gaT_term, P_tot, H, W, X, Y, Z,
                             max_samples, g_vol, stats, stream);
}

// The block shape, so that the caller can size `stats`, and the tile's size
// in floats.
extern "C" int voxel_grad_block_x() { return kBlockX; }
extern "C" int voxel_grad_block_y() { return kBlockY; }
extern "C" int voxel_grad_tile_budget() { return kTileBudget; }

extern "C" const char* voxel_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
