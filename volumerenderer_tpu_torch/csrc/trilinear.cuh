// Trilinear sampling of the 8-bit volume with OpenGL texture semantics, shared
// by the march, shade and gradient kernels (composite_march.cu, iso_march.cu,
// iso_shade.cu, tf_march.cu, voxel_grad.cu), its adjoint for the voxel
// gradient, the same sampler reading the float32 volume and quantizing each
// tap to 8 bits as it reads it (VolumeSampler<float>, for B1 and B4), and the
// same sampler fetching from a sparse z-slab pool (PoolSampler, for the
// pooled marches and shade).  The samplers differ only in how they fetch:
// the texel math (texel) and the seven lerps (trilerp) are written once, so
// their bit-for-bit agreement rests on one copy.  The segment marches
// (seg_march.cu) take their taps from the anchors of their ownership test
// and share trilerp.
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

// A tap of the float32 volume, quantized as it is read: the voxel v as
// volumerenderer_tpu_torch/ops/cuda/raycast_kernel.py::quantize_u8 makes its
// byte (clamp to [0, 1], times 255, rounded half to even), then scaled as a
// byte tap is.  Clamp, product and rounding each round on their own
// (--fmad=false) and rintf rounds half to even as torch.round does, so for
// every finite v and for +-inf this is the float the byte tap gives for
// quantize_u8(v).  A NaN reads as 0.
__device__ __forceinline__ float tap(const float* __restrict__ vol, size_t offset) {
  return rintf(fminf(fmaxf(__ldg(vol + offset), 0.0f), 1.0f) * 255.0f) * (1.0f / 255.0f);
}

// trilerp of the taps vol[z + y + x], given the flat offsets of each axis's
// lower and upper tap.  Offset is size_t (z*Y*X overflows int32 past 2^31
// voxels), or uint32_t where the caller knows the volume has at most 2^32
// voxels: fewer instructions per tap.
template <class T, class Offset>
__device__ __forceinline__ float gather_trilerp(const T* __restrict__ vol, Offset x0, Offset x1,
                                                Offset y0, Offset y1, Offset z0, Offset z1,
                                                float fx, float fy, float fz) {
  return trilerp(tap(vol, z0 + y0 + x0), tap(vol, z0 + y0 + x1), tap(vol, z0 + y1 + x0),
                 tap(vol, z0 + y1 + x1), tap(vol, z1 + y0 + x0), tap(vol, z1 + y0 + x1),
                 tap(vol, z1 + y1 + x0), tap(vol, z1 + y1 + x1), fx, fy, fz);
}

template <class Offset>
__device__ __forceinline__ Offset wrapped(int i, int n, bool repeat, Offset stride) {
  return static_cast<Offset>(wrap_index(i, n, repeat)) * stride;
}

// T = uint8_t: the 8-bit volume; T = float: the float32 volume, each tap
// quantized to 8 bits as it is read (the same samples as the 8-bit volume
// quantize_u8 makes of it).  Offset as for gather_trilerp.
template <class Offset = size_t, class T>
__device__ __forceinline__ float sample_trilinear(const T* __restrict__ vol, float u, float v,
                                                  float w, int X, int Y, int Z, bool repeat) {
  if (repeat) {
    u = u - floorf(u);
    v = v - floorf(v);
    w = w - floorf(w);
  }
  float fx, fy, fz;
  const int i0x = texel(u, X, fx);
  const int i0y = texel(v, Y, fy);
  const int i0z = texel(w, Z, fz);
  const Offset sx = 1;
  const Offset sy = static_cast<Offset>(X);
  const Offset sz = static_cast<Offset>(X) * static_cast<Offset>(Y);
  return gather_trilerp(vol, wrapped(i0x, X, repeat, sx), wrapped(i0x + 1, X, repeat, sx),
                        wrapped(i0y, Y, repeat, sy), wrapped(i0y + 1, Y, repeat, sy),
                        wrapped(i0z, Z, repeat, sz), wrapped(i0z + 1, Z, repeat, sz), fx, fy, fz);
}

// The dense volume as a sampler object, its wrap and its offset type fixed
// at compile time: the march and shade bodies are templates on their sampler
// (VolumeSampler here, PoolSampler below).  T = uint8_t reads the 8-bit
// volume (B1's byte route, B2, B3, B4); T = float reads the float32 volume
// and quantizes each tap to 8 bits as it reads it (B1, B4), bit for bit the
// 8-bit volume quantize_u8 makes of it, with no byte copy made.  Offset =
// uint32_t needs a volume of at most 2^32 voxels.
template <class T, bool kRepeat, class Offset>
struct VolumeSampler {
  const T* vol;
  int X, Y, Z;
  __device__ __forceinline__ float operator()(float u, float v, float w) const {
    return sample_trilinear<Offset>(vol, u, v, w, X, Y, Z, kRepeat);
  }

  // operator()'s sample into s, unless skip(x0, y0, z0), asked with the
  // sample's lower tap anchor wrapped onto the volume, holds: then no tap is
  // read and false is returned.  One texel computation serves the skip test
  // and the taps, with operator()'s arithmetic, so a sample taken is bit for
  // bit operator()'s.  (operator() keeps its own copy, so that the marches
  // without a skip compile as they do without this.)
  template <class Skip>
  __device__ __forceinline__ bool sample_unless(float u, float v, float w, Skip skip,
                                                float& s) const {
    if (kRepeat) {
      u = u - floorf(u);
      v = v - floorf(v);
      w = w - floorf(w);
    }
    float fx, fy, fz;
    const int i0x = texel(u, X, fx);
    const int i0y = texel(v, Y, fy);
    const int i0z = texel(w, Z, fz);
    const int x0 = wrap_index(i0x, X, kRepeat);
    const int y0 = wrap_index(i0y, Y, kRepeat);
    const int z0 = wrap_index(i0z, Z, kRepeat);
    if (skip(x0, y0, z0)) return false;
    const Offset sx = 1;
    const Offset sy = static_cast<Offset>(X);
    const Offset sz = static_cast<Offset>(X) * static_cast<Offset>(Y);
    s = gather_trilerp(vol, static_cast<Offset>(x0) * sx, wrapped(i0x + 1, X, kRepeat, sx),
                       static_cast<Offset>(y0) * sy, wrapped(i0y + 1, Y, kRepeat, sy),
                       static_cast<Offset>(z0) * sz, wrapped(i0z + 1, Z, kRepeat, sz), fx, fy,
                       fz);
    return true;
  }
};

// Host side: returns launch(sampler) with the VolumeSampler of the dense
// (Z, Y, X) volume of T at vol and the wrap kRepeat, its offset type
// (uint32_t where the volume has at most 2^32 voxels) chosen here from the
// run-time extent.  A clamp-only march (B4, B5) calls this one alone, so it
// builds no repeat instantiation.
template <class T, bool kRepeat, class Launch>
inline int with_volume_sampler(const void* vol, int X, int Y, int Z, Launch&& launch) {
  const auto v = static_cast<const T*>(vol);
  const bool small = static_cast<size_t>(X) * static_cast<size_t>(Y) * static_cast<size_t>(Z) <=
                     (size_t{1} << 32);
  if (small) return launch(VolumeSampler<T, kRepeat, uint32_t>{v, X, Y, Z});
  return launch(VolumeSampler<T, kRepeat, size_t>{v, X, Y, Z});
}

// As above, the wrap too chosen from the run-time flag.
template <class T, class Launch>
inline int with_volume_sampler(const void* vol, int X, int Y, int Z, bool repeat,
                               Launch&& launch) {
  if (repeat) return with_volume_sampler<T, true>(vol, X, Y, Z, launch);
  return with_volume_sampler<T, false>(vol, X, Y, Z, launch);
}

// The two slab-pool layouts of volumerenderer_tpu_torch/ops/cuda/
// raycast_kernel.py: slot s holds z rows [8b, 8b + 16) of the z-block b that
// maps to it, as 16-bit pairs p16[x] = s[x] * 256 + s[x + 1] (x + 1 clamped
// to the edge).
//   kPair16:    (n_slots, 16, Y, X / 2) int32, pairs x and x + 1 (x even)
//               in the low and high halves of one word;
//   kNarrowF32: (n_slots, 16, Y, X) float32 pair values.
enum class PoolFormat { kPair16, kNarrowF32 };

// A byte b as its tap, b * (1/255), for a pair16 word: one byte permute
// makes 0x4B0000bb, the float 2^23 + b, from byte `selector & 3` of the
// word, and subtracting 2^23 leaves b exactly (the float static_cast<float>(b)
// gives), with no shift and no int-to-float conversion.  A selector is 0x7440
// plus the byte's index: bytes 4-6 of the permute's second word are 0 and
// byte 7 is 0x4B.
__device__ __forceinline__ float pool_tap(uint32_t word, uint32_t selector) {
  return (__uint_as_float(__byte_perm(word, 0x4B000000u, selector)) - 8388608.0f) *
         (1.0f / 255.0f);
}

// The two x taps (s[x0], s[x0 + 1]) of the pair at word `offset`, or s[x0]
// twice at the low x face (low_edge).  pair16: the pair's low byte by
// selector lo (0x7440 + its byte index) and its high byte by lo + 1.  narrow:
// the pair value p split in the float domain, hi = truncf(p / 256) and lo =
// p - hi * 256, each exact for p < 2^16, in place of a float-to-int
// conversion and shifts.
template <PoolFormat F, class Offset>
__device__ __forceinline__ void pair_taps(const void* pool, Offset offset, uint32_t lo,
                                          bool low_edge, float& c0, float& c1) {
  constexpr float kInv255 = 1.0f / 255.0f;
  if constexpr (F == PoolFormat::kPair16) {
    const auto word = static_cast<uint32_t>(__ldg(static_cast<const int32_t*>(pool) + offset));
    c0 = pool_tap(word, lo + 1);
    c1 = pool_tap(word, low_edge ? lo + 1 : lo);
  } else {
    const float p = __ldg(static_cast<const float*>(pool) + offset);
    const float h = truncf(p * (1.0f / 256.0f));
    c0 = h * kInv255;
    c1 = low_edge ? c0 : (p - h * 256.0f) * kInv255;
  }
}

// Clamp-mode sample_trilinear of the 8-bit volume the pool was built from,
// bit for bit: the same index math, taps byte * (1/255), the same lerps.
// z-block b = z0 >> 3 reads slot slab_map[b] (clamped into [0, n_slots) so
// a bad map cannot read outside the pool); both z taps lie in that slot's
// rows z0 - 8b <= 7 and z1 - 8b <= 8 < 16.  One pair fetch gives both x taps
// of a (z, y) row, except at the low x face: where i0x < 0 both x indices
// clamp to 0 and the high byte s[0] serves both (the low byte is s[1]).
//
// Offset is uint32_t where the pool has at most 2^32 words (with_pool_sampler
// chooses), else size_t; every word offset is formed in it, from the block's
// word base (16 slot - 8 b) * Y * words_per_row, a sum mod 2^32 (or 2^64):
// each word offset it is part of is below the pool's size, so the sums land
// on it exactly.  The sampler is a per-ray cursor: it keeps the last z-block
// it read the map for and that block's word base, and reads the map again
// only when z0 >> 3 changes (at most once per 8 voxels of z along a march),
// so nearly every sample's fetches wait on no map load.  The cursor is keyed
// by the block alone, so positions may come in any order (the shade's
// bisection and normal taps off the march's line).
template <PoolFormat F, class Offset>
struct PoolSampler {
  const void* pool;
  const int32_t* slab_map;
  int n_slots;
  int X, Y, Z;
  Offset words_per_row;  // X / 2 (pair16) or X (narrow)
  Offset plane;          // Y * words_per_row: one z row of a slot
  int block = -1;        // the cursor's z-block (none yet) and its word base
  Offset base = 0;

  __device__ __forceinline__ float operator()(float u, float v, float w) {
    float fx, fy, fz;
    const int i0x = texel(u, X, fx);
    const int i0y = texel(v, Y, fy);
    const int i0z = texel(w, Z, fz);

    const int x0 = wrap_index(i0x, X, false);
    const int y0 = wrap_index(i0y, Y, false);
    const int y1 = wrap_index(i0y + 1, Y, false);
    const int z0 = wrap_index(i0z, Z, false);
    const int z1 = wrap_index(i0z + 1, Z, false);
    return taps(i0x, x0, y0, y1, z0, z1, fx, fy, fz);
  }

  // operator()'s sample into s, unless skip(x0, y0, z0), asked with the
  // sample's lower tap anchor clamped onto the volume, holds: then neither
  // the slab map nor a tap is read and false is returned (as
  // VolumeSampler::sample_unless).
  template <class Skip>
  __device__ __forceinline__ bool sample_unless(float u, float v, float w, Skip skip,
                                                float& s) {
    float fx, fy, fz;
    const int i0x = texel(u, X, fx);
    const int i0y = texel(v, Y, fy);
    const int i0z = texel(w, Z, fz);
    const int x0 = wrap_index(i0x, X, false);
    const int y0 = wrap_index(i0y, Y, false);
    const int z0 = wrap_index(i0z, Z, false);
    if (skip(x0, y0, z0)) return false;
    s = taps(i0x, x0, y0, wrap_index(i0y + 1, Y, false), z0, wrap_index(i0z + 1, Z, false), fx,
             fy, fz);
    return true;
  }

  // The sample from its anchor: x0, y0, z0 the lower taps clamped onto the
  // volume, y1, z1 the upper ones, i0x the unclamped x anchor.
  __device__ __forceinline__ float taps(int i0x, int x0, int y0, int y1, int z0, int z1,
                                        float fx, float fy, float fz) {
    const int b = z0 >> 3;
    if (b != block) {
      const int slot = min(max(__ldg(slab_map + b), 0), n_slots - 1);
      block = b;
      base = static_cast<Offset>(16 * slot - 8 * b) * plane;
    }
    constexpr bool kPair16 = F == PoolFormat::kPair16;
    const Offset at = base + static_cast<Offset>(z0) * plane +
                      static_cast<Offset>(y0) * words_per_row +
                      static_cast<Offset>(kPair16 ? x0 >> 1 : x0);
    const Offset dy = static_cast<Offset>(y1 - y0) * words_per_row;
    const Offset dz = static_cast<Offset>(z1 - z0) * plane;
    // a pair16 word holds the pair of x0 in its low half (bytes 1, 0) for x0
    // even and in its high half (bytes 3, 2) for x0 odd
    const bool low_edge = i0x < 0;
    const uint32_t lo = 0x7440u + (static_cast<uint32_t>(x0 & 1) << 1);
    float c000, c100, c010, c110, c001, c101, c011, c111;
    pair_taps<F>(pool, at, lo, low_edge, c000, c100);
    pair_taps<F>(pool, at + dy, lo, low_edge, c010, c110);
    pair_taps<F>(pool, at + dz, lo, low_edge, c001, c101);
    pair_taps<F>(pool, at + dz + dy, lo, low_edge, c011, c111);
    return trilerp(c000, c100, c010, c110, c001, c101, c011, c111, fx, fy, fz);
  }
};

// Host side: returns launch(sampler) with the PoolSampler of a pool of format
// F holding a (Z, Y, X) volume in n_slots slots, its offset type chosen here
// by the pool's size in words: uint32_t up to 2^32 words, size_t beyond.
template <PoolFormat F, class Launch>
inline int with_pool_sampler(const void* pool, const void* slab_map, int n_slots, int X, int Y,
                             int Z, Launch&& launch) {
  const auto map = static_cast<const int32_t*>(slab_map);
  const size_t words_per_row = F == PoolFormat::kPair16 ? X / 2 : X;
  const size_t plane = static_cast<size_t>(Y) * words_per_row;
  if (static_cast<size_t>(n_slots) * 16 * plane <= (size_t{1} << 32)) {
    return launch(PoolSampler<F, uint32_t>{pool, map, n_slots, X, Y, Z,
                                           static_cast<uint32_t>(words_per_row),
                                           static_cast<uint32_t>(plane)});
  }
  return launch(PoolSampler<F, size_t>{pool, map, n_slots, X, Y, Z, words_per_row, plane});
}

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
