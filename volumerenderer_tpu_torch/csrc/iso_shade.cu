// Isosurface shading for Hopper (sm_90a), one thread per ray.
//
// Replaces the TPU shade pass: volumerenderer_tpu/ops/pallas/
// isosurface_kernel.py::_launch_shade (body _shade_one_tile) (B3).  It computes
// exactly volumerenderer_tpu_torch/ops/isosurface.py::shade_hits on the 8-bit
// volume, with the arithmetic of the reference (isosurface.frag:23-75).  For
// each ray with found set:
//   near = entry + (t_hit + 1) repeated additions of dir_step (the march's own
//          position recurrence, never entry + (t_hit + 1) * dir_step), as
//          the march stored it (iso_march.cu's near output);
//   far  = near + dir_step;
//   4-step bisection of [near, far]: mid = (right + left) * 0.5,
//          left = mid if s(mid) < iso else right = mid;  tc = (right + left) * 0.5;
//   normal from 6 taps at tc -/+ DELTA along each axis: g = (s1 - s2) / 2,
//          N = g / (|g| > 0 ? |g| : 1);
//   Phong headlight with L = V = -direction: diffuse = max(L.N, 0),
//          h = (L + V) / |L + V|, spec = max(1e-5, h.N)^250,
//          rgb = diffuse * (0.39, 0.58, 0.93) + spec, clipped to [0, 1].
// Rays without found come out white.
//
// What bounds it on this card: ten data-dependent 8-tap gathers per hit ray,
// four of them a dependent chain (each bisection midpoint waits on the side
// of iso of the one before), then six independent normal taps; the taps
// spread over +-DELTA (2.56 texels at 256^3) but stay in L2.  The bytes are
// few (the hit rays' near, dir_step and direction, the voxels the taps read,
// 12 B of rgb per pixel); the instructions per hit bound it, more than the
// gathers' latency (see the variants below).
//
// What this design does about it: one thread per ray in 16x8-pixel blocks,
// taps through __ldg from the u8 volume with the fetched indices clamped or
// wrapped, so no window or pad has to hold them; the march hands over each
// hit's near bracket (kFromNear), so no thread repeats the t_hit + 1
// additions by which the march reached it (about 130 a hit on a 256^3
// volume), and the sampler is trilinear.cuh's VolumeSampler, its wrap and
// 32-bit voxel offsets fixed at compile time.  The chain instantiation (kFromNear = false) rebuilds near
// from t_hit for callers that hold only (found, t_hit); it is bit for bit the
// same.  Measured on the H100 and not kept: the four midpoints' taps taken
// from the 3x3x3 voxels around the bracket, loaded at once (fewer dependent
// gathers, but half again the instructions); the hit rays of a block
// compacted into a shared list first; 8x8, 8x16 and 32x4 blocks.  nvcc
// already shares the normal taps' texel math.  The TPU design's shade
// windows, their pads and word tables (_shade_pads, build_shade_words,
// build_shade_xwords) are not carried over.
//
// The pooled shade is the same body with the slab-pool sampler
// (trilinear.cuh, PoolSampler), reading the pool the pooled march
// read.  The JAX package shades pooled renders from a second, packed-
// neighbourhood pool (sampling.py::build_shade_pool) because its shade taps
// overrun the TPU march windows; here every tap reads rows z0 and z0 + 1 of
// one slot through the map, so one pool serves both passes.  Clamp only.
//
// Rounding: build with --fmad=false; dot products add left to right
// ((a0*b0 + a1*b1) + a2*b2), and lengths take XLA's fused rounding of
// jnp.linalg.norm (norm3), as the plain version computes them.  Literals are
// float.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr float kDelta = 0.01f;
constexpr float kSpecPower = 250.0f;
constexpr float kDiffuseR = 0.39f;
constexpr float kDiffuseG = 0.58f;
constexpr float kDiffuseB = 0.93f;

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return a0 * b0 + a1 * b1 + a2 * b2;
}

// |a| rounded as XLA computes jnp.linalg.norm (and the plain version's _norm):
// a0*a0, then the other squares added by fused multiply-adds.  An explicit
// fmaf is kept under --fmad=false.
__device__ __forceinline__ float norm3(float a0, float a1, float a2) {
  return sqrtf(fmaf(a2, a2, fmaf(a1, a1, a0 * a0)));
}

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// The color of the hit ray `ray` into (r, g, b).  kFromNear: its near
// bracket read from `near` (the march's); else rebuilt from entry_uv and
// t_hit by the march's own additions.
template <bool kFromNear, class Sampler>
__device__ __forceinline__ void shade_hit(size_t ray, const float* __restrict__ entry_uv,
                                          const float* __restrict__ dir_step,
                                          const float* __restrict__ direction,
                                          const int32_t* __restrict__ t_hit,
                                          const float* __restrict__ near, Sampler& sample,
                                          float iso, float& r, float& g, float& b) {
  const float d0 = dir_step[3 * ray + 0];
  const float d1 = dir_step[3 * ray + 1];
  const float d2 = dir_step[3 * ray + 2];
  float l0, l1, l2;
  if constexpr (kFromNear) {
    l0 = near[3 * ray + 0];
    l1 = near[3 * ray + 1];
    l2 = near[3 * ray + 2];
  } else {
    l0 = entry_uv[3 * ray + 0];
    l1 = entry_uv[3 * ray + 1];
    l2 = entry_uv[3 * ray + 2];
    const int n_add = t_hit[ray] + 1;
    for (int k = 0; k < n_add; ++k) {
      l0 = l0 + d0;
      l1 = l1 + d1;
      l2 = l2 + d2;
    }
  }
  float r0 = l0 + d0;
  float r1 = l1 + d1;
  float r2 = l2 + d2;
  for (int k = 0; k < 4; ++k) {
    const float m0 = (r0 + l0) * 0.5f;
    const float m1 = (r1 + l1) * 0.5f;
    const float m2 = (r2 + l2) * 0.5f;
    if (sample(m0, m1, m2) < iso) {
      l0 = m0; l1 = m1; l2 = m2;
    } else {
      r0 = m0; r1 = m1; r2 = m2;
    }
  }
  const float t0 = (r0 + l0) * 0.5f;
  const float t1 = (r1 + l1) * 0.5f;
  const float t2 = (r2 + l2) * 0.5f;

  const float g0 = (sample(t0 - kDelta, t1, t2) - sample(t0 + kDelta, t1, t2)) / 2.0f;
  const float g1 = (sample(t0, t1 - kDelta, t2) - sample(t0, t1 + kDelta, t2)) / 2.0f;
  const float g2 = (sample(t0, t1, t2 - kDelta) - sample(t0, t1, t2 + kDelta)) / 2.0f;
  const float gn = norm3(g0, g1, g2);
  const float gd = gn > 0.0f ? gn : 1.0f;
  const float n0 = g0 / gd;
  const float n1 = g1 / gd;
  const float n2 = g2 / gd;

  const float v0 = -direction[3 * ray + 0];
  const float v1 = -direction[3 * ray + 1];
  const float v2 = -direction[3 * ray + 2];
  const float diffuse = fmaxf(dot3(v0, v1, v2, n0, n1, n2), 0.0f);
  float h0 = v0 + v0;
  float h1 = v1 + v1;
  float h2 = v2 + v2;
  const float hn = norm3(h0, h1, h2);
  h0 = h0 / hn;
  h1 = h1 / hn;
  h2 = h2 / hn;
  const float spec = powf(fmaxf(1e-5f, dot3(h0, h1, h2, n0, n1, n2)), kSpecPower);
  r = clip01(diffuse * kDiffuseR + spec);
  g = clip01(diffuse * kDiffuseG + spec);
  b = clip01(diffuse * kDiffuseB + spec);
}

template <bool kFromNear, class Sampler>
__global__ void __launch_bounds__(kBlockX * kBlockY)
iso_shade_kernel(const float* __restrict__ entry_uv, const float* __restrict__ dir_step,
                 const float* __restrict__ direction, const uint8_t* __restrict__ found,
                 const int32_t* __restrict__ t_hit, const float* __restrict__ near,
                 Sampler sample, int H, int W, float iso, float* __restrict__ rgb) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= W || py >= H) return;
  const size_t ray = static_cast<size_t>(py) * static_cast<size_t>(W) + static_cast<size_t>(px);
  float r = 1.0f, g = 1.0f, b = 1.0f;
  if (found[ray]) {
    shade_hit<kFromNear>(ray, entry_uv, dir_step, direction, t_hit, near, sample, iso, r, g, b);
  }
  rgb[3 * ray + 0] = r;
  rgb[3 * ray + 1] = g;
  rgb[3 * ray + 2] = b;
}

template <class Sampler>
int launch(const void* entry_uv, const void* dir_step, const void* direction, const void* found,
           const void* t_hit, const void* near, Sampler sample, int H, int W, float iso,
           void* rgb, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  auto* kernel = near ? iso_shade_kernel<true, Sampler> : iso_shade_kernel<false, Sampler>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entry_uv), static_cast<const float*>(dir_step),
      static_cast<const float*>(direction), static_cast<const uint8_t*>(found),
      static_cast<const int32_t*>(t_hit), static_cast<const float*>(near), sample, H, W, iso,
      static_cast<float*>(rgb));
  return static_cast<int>(cudaGetLastError());
}

template <vrt::PoolFormat F>
int launch_pooled(const void* entry_uv, const void* dir_step, const void* direction,
                  const void* found, const void* t_hit, const void* near, const void* pool,
                  const void* slab_map, int H, int W, int X, int Y, int Z, int n_slots,
                  float iso, void* rgb, void* stream) {
  return vrt::with_pool_sampler<F>(pool, slab_map, n_slots, X, Y, Z, [&](auto sample) {
    return launch(entry_uv, dir_step, direction, found, t_hit, near, sample, H, W, iso, rgb,
                  stream);
  });
}

}  // namespace

// Each launch runs the shade pass on `stream` for an H x W ray image and
// returns cudaGetLastError() (0 on success).  Pointers are device pointers:
// dir_step and direction (H*W*3 f32), found (H*W u8) and rgb (H*W*3 f32);
// near (H*W*3 f32, the march's near output, read for the hit rays alone), or
// null, and then entry_uv (H*W*3 f32) and t_hit (H*W i32) rebuild it (with
// near given, those two are not read and may be null).

// B3: vol (Z*Y*X u8, x fastest); repeat != 0 selects GL_REPEAT wrapping.
extern "C" int iso_shade_launch(const void* entry_uv, const void* dir_step, const void* direction,
                                const void* found, const void* t_hit, const void* near,
                                const void* vol, int H, int W, int X, int Y, int Z, int repeat,
                                float iso, void* rgb, void* stream) {
  return vrt::with_volume_sampler<uint8_t>(vol, X, Y, Z, repeat != 0, [&](auto sample) {
    return launch(entry_uv, dir_step, direction, found, t_hit, near, sample, H, W, iso, rgb,
                  stream);
  });
}

// The pooled shade on the narrow f32 pool (n_slots*16*Y*X) and slab_map (Z/8
// i32), clamp.
extern "C" int iso_shade_pooled_narrow_launch(const void* entry_uv, const void* dir_step,
                                              const void* direction, const void* found,
                                              const void* t_hit, const void* near,
                                              const void* pool, const void* slab_map, int H,
                                              int W, int X, int Y, int Z, int n_slots,
                                              float iso, void* rgb, void* stream) {
  return launch_pooled<vrt::PoolFormat::kNarrowF32>(entry_uv, dir_step, direction, found, t_hit,
                                                    near, pool, slab_map, H, W, X, Y, Z, n_slots,
                                                    iso, rgb, stream);
}

// The pooled shade on the pair16 pool (n_slots*16*Y*(X/2) i32), clamp.
extern "C" int iso_shade_pooled_pair16_launch(const void* entry_uv, const void* dir_step,
                                              const void* direction, const void* found,
                                              const void* t_hit, const void* near,
                                              const void* pool, const void* slab_map, int H,
                                              int W, int X, int Y, int Z, int n_slots,
                                              float iso, void* rgb, void* stream) {
  return launch_pooled<vrt::PoolFormat::kPair16>(entry_uv, dir_step, direction, found, t_hit,
                                                 near, pool, slab_map, H, W, X, Y, Z, n_slots,
                                                 iso, rgb, stream);
}

extern "C" const char* iso_shade_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
