// The 8^3 block grid of volumerenderer_tpu_torch/ops/blockgrid.py on the
// device, shared by the exact skips of the isosurface marches (iso_march.cu)
// and of the compositing marches (composite_march.cu).
//
// Per 8^3 block of trilinear tap anchors a cell holds the least byte (low)
// and the largest byte (high) that the taps of those anchors can read.  A
// march looks up the block of each sample's lower tap anchor, by the
// sampler's own texel math (trilinear.cuh), the anchor clamped or wrapped
// onto the volume, and reads the cell through __ldg (2 bytes a block, 64 KB
// at 256^3).

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace vrt {

// The block grid: cells (nbz, nby, nbx) of 2 bytes, the least byte low and
// the largest high.
struct BlockGrid {
  static constexpr bool kBound = true;
  const uint16_t* cells;
  int X, Y, Z, nbx, nby;
  bool repeat;
  // a block lies below iso iff its largest byte is under below_under (max +
  // 0.5 < iso*255), above it iff its least byte is at least above_from (min -
  // 0.5 >= iso*255): the float tests, counted once per launch.  The
  // compositing skip needs neither (empty_at()).
  unsigned below_under, above_from;

  // The cell of the block of the lower tap anchor of the sample at (u, v, w).
  __device__ __forceinline__ unsigned cell(float u, float v, float w) const {
    if (repeat) {
      u = u - floorf(u);
      v = v - floorf(v);
      w = w - floorf(w);
    }
    float f;
    const int bx = wrap_index(texel(u, X, f), X, repeat) >> 3;
    const int by = wrap_index(texel(v, Y, f), Y, repeat) >> 3;
    const int bz = wrap_index(texel(w, Z, f), Z, repeat) >> 3;
    return __ldg(cells + (bz * nby + by) * nbx + bx);
  }

  // The side of iso of the sample's block: -1 every sample there is below
  // iso, 1 none is, 0 mixed.
  __device__ __forceinline__ int side(float u, float v, float w) const {
    const unsigned bytes = cell(u, v, w);
    if ((bytes >> 8) < below_under) return -1;
    if ((bytes & 255u) >= above_from) return 1;
    return 0;
  }

  // Every tap of the block of the anchor (x0, y0, z0), already wrapped onto
  // the volume by the sampler, reads 0, so the sample is 0.
  __device__ __forceinline__ bool empty_at(int x0, int y0, int z0) const {
    return __ldg(cells + ((z0 >> 3) * nby + (y0 >> 3)) * nbx + (x0 >> 3)) < 256u;
  }
};

// No grid: the unbound march.  An empty argument, so that the unbound
// instantiation of a kernel is the code it is without a grid.
struct NoGrid {
  static constexpr bool kBound = false;
};

// Host side: the BlockGrid of the cells at `grid` for a (Z, Y, X) volume.
inline BlockGrid block_grid(const void* grid, int X, int Y, int Z, bool repeat,
                            unsigned below_under = 0, unsigned above_from = 0) {
  return BlockGrid{static_cast<const uint16_t*>(grid), X, Y, Z, (X + 7) / 8, (Y + 7) / 8,
                   repeat, below_under, above_from};
}

}  // namespace vrt
