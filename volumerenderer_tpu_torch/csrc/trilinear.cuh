// Trilinear sampling of the 8-bit volume with OpenGL texture semantics, shared
// by the march, shade and gradient kernels (composite_march.cu, iso_march.cu,
// iso_shade.cu, tf_march.cu, voxel_grad.cu), its adjoint for the voxel
// gradient, and the same sampler fetching from a sparse z-slab pool
// (sample_trilinear_pool, for the pooled marches and shade).  The samplers
// differ only in how they fetch: the texel math (texel) and the seven lerps
// (trilerp) are written once, so their bit-for-bit agreement rests on one
// copy.  The segment marches (seg_march.cu) take their taps from the anchors
// of their ownership test and share trilerp.
//
// The device counterpart of volumerenderer_tpu_torch/ops/sampling.py::
// sample_trilinear on the 8-bit grid: texel centers at (i + 0.5) / N, bytes
// normalized by 255, clamp-to-edge or GL_REPEAT wrapping, and the seven lerps
// in that function's order, each product and sum rounded on its own (the
// including sources are built with --fmad=false).  The volume is indexed
// [z][y][x], x fastest; a position is (u, v, w) = (x, y, z) in texture space.
// Any position may be sampled: the fetched indices are wrapped, so taps
// outside the cube read the edge (clamp) or the wrapped texel (repeat).

#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace vrt {

__device__ __forceinline__ int wrap_index(int i, int n, bool repeat) {
  if (repeat) {
    const int r = i % n;
    return r < 0 ? r + n : r;
  }
  return min(max(i, 0), n - 1);
}

// The texel math every sampler here shares: the anchor floor(u * n - 0.5) of
// coordinate u on an axis of n texels, and the fraction past it.
__device__ __forceinline__ int texel(float u, int n, float& frac) {
  const float t = u * static_cast<float>(n) - 0.5f;
  const float i = floorf(t);
  frac = t - i;
  return static_cast<int>(i);
}

// The seven lerps of the 8 taps c<x><y><z> (index 1 = the upper tap of that
// axis): along x, then y, then z.
__device__ __forceinline__ float trilerp(float c000, float c100, float c010, float c110,
                                         float c001, float c101, float c011, float c111,
                                         float fx, float fy, float fz) {
  const float c00 = c000 + (c100 - c000) * fx;
  const float c10 = c010 + (c110 - c010) * fx;
  const float c01 = c001 + (c101 - c001) * fx;
  const float c11 = c011 + (c111 - c011) * fx;
  const float c0 = c00 + (c10 - c00) * fy;
  const float c1 = c01 + (c11 - c01) * fy;
  return c0 + (c1 - c0) * fz;
}

__device__ __forceinline__ float tap(const uint8_t* __restrict__ vol, size_t offset) {
  return static_cast<float>(__ldg(vol + offset)) * (1.0f / 255.0f);
}

// trilerp of the bytes vol[z + y + x], given the flat offsets of each axis's
// lower and upper tap (64-bit: z*Y*X overflows int32 past 2^31 voxels).
__device__ __forceinline__ float gather_trilerp(const uint8_t* __restrict__ vol, size_t x0,
                                                size_t x1, size_t y0, size_t y1, size_t z0,
                                                size_t z1, float fx, float fy, float fz) {
  return trilerp(tap(vol, z0 + y0 + x0), tap(vol, z0 + y0 + x1), tap(vol, z0 + y1 + x0),
                 tap(vol, z0 + y1 + x1), tap(vol, z1 + y0 + x0), tap(vol, z1 + y0 + x1),
                 tap(vol, z1 + y1 + x0), tap(vol, z1 + y1 + x1), fx, fy, fz);
}

__device__ __forceinline__ size_t wrapped(int i, int n, bool repeat, size_t stride) {
  return static_cast<size_t>(wrap_index(i, n, repeat)) * stride;
}

__device__ __forceinline__ float sample_trilinear(const uint8_t* __restrict__ vol, float u,
                                                  float v, float w, int X, int Y, int Z,
                                                  bool repeat) {
  if (repeat) {
    u = u - floorf(u);
    v = v - floorf(v);
    w = w - floorf(w);
  }
  float fx, fy, fz;
  const int i0x = texel(u, X, fx);
  const int i0y = texel(v, Y, fy);
  const int i0z = texel(w, Z, fz);
  const size_t sy = static_cast<size_t>(X);
  const size_t sz = static_cast<size_t>(X) * static_cast<size_t>(Y);
  return gather_trilerp(vol, wrapped(i0x, X, repeat, 1), wrapped(i0x + 1, X, repeat, 1),
                        wrapped(i0y, Y, repeat, sy), wrapped(i0y + 1, Y, repeat, sy),
                        wrapped(i0z, Z, repeat, sz), wrapped(i0z + 1, Z, repeat, sz), fx, fy, fz);
}

// The dense volume as a sampler object: the march and shade bodies are
// templates on their sampler (DenseSampler, PoolSampler below).
struct DenseSampler {
  const uint8_t* vol;
  int X, Y, Z;
  bool repeat;
  __device__ __forceinline__ float operator()(float u, float v, float w) const {
    return sample_trilinear(vol, u, v, w, X, Y, Z, repeat);
  }
};

// The two slab-pool layouts of volumerenderer_tpu_torch/ops/cuda/
// raycast_kernel.py: slot s holds z rows [8b, 8b + 16) of the z-block b that
// maps to it, as 16-bit pairs p16[x] = s[x] * 256 + s[x + 1] (x + 1 clamped
// to the edge).
//   kPair16:    (n_slots, 16, Y, X / 2) int32, pairs x and x + 1 (x even)
//               in the low and high halves of one word;
//   kNarrowF32: (n_slots, 16, Y, X) float32 pair values.
enum class PoolFormat { kPair16, kNarrowF32 };

template <PoolFormat F>
__device__ __forceinline__ int pool_pair(const void* pool, size_t row, int x, int X) {
  if constexpr (F == PoolFormat::kPair16) {
    const int32_t word =
        __ldg(static_cast<const int32_t*>(pool) + row * static_cast<size_t>(X / 2) + (x >> 1));
    return (x & 1) ? static_cast<int>(static_cast<uint32_t>(word) >> 16) : (word & 0xFFFF);
  } else {
    return static_cast<int>(
        __ldg(static_cast<const float*>(pool) + row * static_cast<size_t>(X) + x));
  }
}

// Clamp-mode sample_trilinear of the 8-bit volume the pool was built from,
// bit for bit: the same index math, taps byte * (1/255), the same lerps.
// z-block b = z0 >> 3 reads slot slab_map[b] (clamped into [0, n_slots) so
// a bad map cannot read outside the pool); both z taps lie in that slot's
// rows z0 - 8b <= 7 and z1 - 8b <= 8 < 16.  One pair fetch gives both x taps
// of a (z, y) row, except at the low x face: where i0x < 0 both x indices
// clamp to 0 and the high byte s[0] serves both (the low byte is s[1]).
template <PoolFormat F>
__device__ __forceinline__ float sample_trilinear_pool(const void* pool,
                                                       const int32_t* __restrict__ slab_map,
                                                       int n_slots, float u, float v, float w,
                                                       int X, int Y, int Z) {
  float fx, fy, fz;
  const int i0x = texel(u, X, fx);
  const int i0y = texel(v, Y, fy);
  const int i0z = texel(w, Z, fz);

  const int x0 = wrap_index(i0x, X, false);
  const size_t y0 = static_cast<size_t>(wrap_index(i0y, Y, false));
  const size_t y1 = static_cast<size_t>(wrap_index(i0y + 1, Y, false));
  const int z0 = wrap_index(i0z, Z, false);
  const int z1 = wrap_index(i0z + 1, Z, false);
  const int block = z0 >> 3;
  const int slot = min(max(__ldg(slab_map + block), 0), n_slots - 1);
  const size_t first = static_cast<size_t>(slot) * 16;
  const size_t row0 = (first + static_cast<size_t>(z0 - 8 * block)) * static_cast<size_t>(Y);
  const size_t row1 = (first + static_cast<size_t>(z1 - 8 * block)) * static_cast<size_t>(Y);
  const bool low_edge = i0x < 0;

  const int p00 = pool_pair<F>(pool, row0 + y0, x0, X);
  const int p10 = pool_pair<F>(pool, row0 + y1, x0, X);
  const int p01 = pool_pair<F>(pool, row1 + y0, x0, X);
  const int p11 = pool_pair<F>(pool, row1 + y1, x0, X);
  constexpr float kInv255 = 1.0f / 255.0f;
  const float c000 = static_cast<float>(p00 >> 8) * kInv255;
  const float c010 = static_cast<float>(p10 >> 8) * kInv255;
  const float c001 = static_cast<float>(p01 >> 8) * kInv255;
  const float c011 = static_cast<float>(p11 >> 8) * kInv255;
  const float c100 = low_edge ? c000 : static_cast<float>(p00 & 255) * kInv255;
  const float c110 = low_edge ? c010 : static_cast<float>(p10 & 255) * kInv255;
  const float c101 = low_edge ? c001 : static_cast<float>(p01 & 255) * kInv255;
  const float c111 = low_edge ? c011 : static_cast<float>(p11 & 255) * kInv255;
  return trilerp(c000, c100, c010, c110, c001, c101, c011, c111, fx, fy, fz);
}

template <PoolFormat F>
struct PoolSampler {
  const void* pool;
  const int32_t* slab_map;
  int n_slots;
  int X, Y, Z;
  __device__ __forceinline__ float operator()(float u, float v, float w) const {
    return sample_trilinear_pool<F>(pool, slab_map, n_slots, u, v, w, X, Y, Z);
  }
};

// The adjoint of clamp-mode sample_trilinear at (u, v, w): the clamped
// indices of each axis's two taps and the cotangent g times each tap's
// weight, g*wz*wy*wx in that order; tap k = 4a + 2b + c lies at (zs[a],
// ys[b], xs[c]), z outermost and x innermost (the order of
// volumerenderer_tpu_torch/ops/sampling.py::trilinear_scatter_add_ and of
// the JAX package's diff/vjp.py::_trilinear_scatter).  Two taps clamped onto
// one voxel keep their own entries, so both add.  The index arithmetic is
// sample_trilinear's, which stays as it is.
__device__ __forceinline__ void trilinear_adjoint(float u, float v, float w, int X, int Y, int Z,
                                                  float g, int xs[2], int ys[2], int zs[2],
                                                  float weight[8]) {
  float fx, fy, fz;
  const int i0x = texel(u, X, fx);
  const int i0y = texel(v, Y, fy);
  const int i0z = texel(w, Z, fz);

  xs[0] = wrap_index(i0x, X, false);
  xs[1] = wrap_index(i0x + 1, X, false);
  ys[0] = wrap_index(i0y, Y, false);
  ys[1] = wrap_index(i0y + 1, Y, false);
  zs[0] = wrap_index(i0z, Z, false);
  zs[1] = wrap_index(i0z + 1, Z, false);
  const float wxs[2] = {1.0f - fx, fx};
  const float wys[2] = {1.0f - fy, fy};
  const float wzs[2] = {1.0f - fz, fz};
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int c = 0; c < 2; ++c) weight[4 * a + 2 * b + c] = g * wzs[a] * wys[b] * wxs[c];
    }
  }
}

}  // namespace vrt
