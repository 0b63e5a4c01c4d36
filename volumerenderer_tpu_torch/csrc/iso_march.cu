// Isosurface crossing march for Hopper (sm_90a), one thread per ray.
//
// Replaces the TPU isosurface march: volumerenderer_tpu/ops/pallas/
// isosurface_kernel.py::_launch_group (body _iso_one_tile_group, driven by
// march_phased) and ::_launch (body _iso_one_tile, the per-step plans) (B2).
// It
// computes exactly volumerenderer_tpu_torch/ops/isosurface.py::iso_march_steps
// on the 8-bit volume: per ray, for i = 1..max_samples,
//   pos += dir_step;  leave once pos is outside the open cube (0,1)^3;
//   s  = sample at pos (the previous step's lookahead, bit-equal to
//        resampling: both positions are pos_{i-1} + dir_step);
//   s2 = sample at pos + dir_step (a lookahead, sampled even outside the cube);
//   if (s - iso) < 0 && (s2 - iso) >= 0: found = 1, t_hit = i - 1, leave.
// (iso_march_steps(..., bound=) with a block grid: the same result.)
// t_hit is -1 for a miss.  Given a near buffer, the march also stores each
// hit's near bracket there: the position it holds when it sets found, entry +
// (t_hit + 1) repeated additions of dir_step, which the shade (iso_shade.cu)
// then reads instead of rebuilding it; a miss's entry is not written.  That
// store is the whole cost of the bracket: the instantiation without it
// (kNear = false) has none.  It is made where found is set: made after the
// loop, the bound marches of the volume and of the narrow pool measured 2-3 %
// slower on an H100, the pair16 pool's 4 % faster.
//
// What bounds it on this card: one data-dependent 8-tap gather per step
// (the lookahead; the current sample is carried), served by L1/L2 (a 256^3
// u8 volume is 16.8 MB and stays in the 50 MB L2); up to ~300 dependent steps
// per ray; and the rays of one warp leave at different steps.  The flops per
// step are small beside the gather latency.
//
// What this design does about it: one thread per ray in 16x8-pixel blocks
// (neighbouring rays share cache lines), taps through __ldg from the u8
// volume (trilinear.cuh's VolumeSampler: the wrap and 32-bit voxel offsets
// fixed at compile time where the volume has at most 2^32 voxels), the
// lookahead carried so each step gathers once, and a thread leaves as soon
// as its ray hits or exits.  With a block grid (a BlockBound
// of ops/blockgrid.py: per 8^3 block of tap anchors the least and largest
// byte its taps read, block_grid.cuh, shared with composite_march.cu)
// the march skips exactly, as the TPU plan's bind does with its word tables.
// The crossing test needs only each sample's side of iso.  A sample whose
// anchor block lies wholly below iso (max + 0.5 < iso*255) or above it (min -
// 0.5 >= iso*255) has a known side, so it is not gathered: -inf or +inf
// stands in for it.  The half-byte margin covers the ulps by which a lerp
// may leave its taps' range.  Positions still advance by one addition per
// step, skipped steps included, so (found, t_hit) are bit for bit the
// unbound march's.  A skipped sample still costs its block's classification
// (the texel math and one 2-byte load), and a warp gathers whenever one of
// its lanes needs a sample, so the time falls less than the gathers do.
// Measured on the H100 and not kept: a tight loop of additions while the
// lookahead stays in a one-sided block; the same with a float range test in
// place of the classification; 2, 4 or 8 steps at a time with their gathers
// issued together; 8x8, 8x16 and 32x4 blocks; a floor on blocks per SM; the
// block coordinates in float arithmetic; the side carried as a bool.  The
// TPU design's window DMAs, lane groups, texr rows and resumable state rows
// feed VMEM windows and change no result; none is carried over.
//
// The pooled marches are the same body with the slab-pool sampler
// (trilinear.cuh, PoolSampler): they replace isosurface_kernel.py::
// _launch_group_pooled_narrow (B8, the narrow f32 pool) and ::_launch_pooled
// (B9, the pair16 pool).  Their TPU state rows (resumable phases) feed the
// phased march of bind and are left out, as for B2.  Each tap reads its pair
// through the slab map (re-read only when the ray's z-block changes); a
// slot-0 read (an empty slab) is exact, every tap there being 0.  Clamp only,
// as the TPU pooled plans.
//
// Rounding: build with --fmad=false; the crossing test compares normalized
// samples with iso rounded once to f32 (not the TPU kernel's 0-255 scale),
// as the plain version does.  Literals are float.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "block_grid.cuh"
#include "trilinear.cuh"

namespace {

using vrt::BlockGrid;

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

template <bool kBound, bool kNear, class Sampler>
__global__ void __launch_bounds__(kBlockX * kBlockY)
iso_march_kernel(const float* __restrict__ entry_uv, const float* __restrict__ dir_step,
                 const uint8_t* __restrict__ hit, Sampler sample, BlockGrid grid, int H, int W,
                 int max_samples, float iso, uint8_t* __restrict__ found_out,
                 int32_t* __restrict__ t_hit_out, float* __restrict__ near_out) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= W || py >= H) return;
  const size_t ray = static_cast<size_t>(py) * static_cast<size_t>(W) + static_cast<size_t>(px);

  uint8_t found = 0;
  int32_t t_hit = -1;
  if (hit[ray]) {
    float p0 = entry_uv[3 * ray + 0];
    float p1 = entry_uv[3 * ray + 1];
    float p2 = entry_uv[3 * ray + 2];
    const float d0 = dir_step[3 * ray + 0];
    const float d1 = dir_step[3 * ray + 1];
    const float d2 = dir_step[3 * ray + 2];
    // the sample at (u, v, w); with a grid, in a one-sided block -inf or
    // +inf in its place, which lies on the same side of iso
    auto sample_or_side = [&](float u, float v, float w) -> float {
      if constexpr (kBound) {
        const int side = grid.side(u, v, w);
        if (side != 0) return side < 0 ? -INFINITY : INFINITY;
      }
      return sample(u, v, w);
    };
    float s = 0.0f;
    for (int i = 1; i <= max_samples; ++i) {
      p0 = p0 + d0;
      p1 = p1 + d1;
      p2 = p2 + d2;
      if (!(p0 > 0.0f && p0 < 1.0f && p1 > 0.0f && p1 < 1.0f && p2 > 0.0f && p2 < 1.0f)) break;
      if (i == 1) s = sample_or_side(p0, p1, p2);
      const float s2 = sample_or_side(p0 + d0, p1 + d1, p2 + d2);
      if ((s - iso) < 0.0f && (s2 - iso) >= 0.0f) {
        found = 1;
        t_hit = i - 1;
        if constexpr (kNear) {  // p: entry + (t_hit + 1) additions, the near bracket
          near_out[3 * ray + 0] = p0;
          near_out[3 * ray + 1] = p1;
          near_out[3 * ray + 2] = p2;
        }
        break;
      }
      s = s2;
    }
  }
  found_out[ray] = found;
  t_hit_out[ray] = t_hit;
}

template <class Sampler>
int launch(const void* entry_uv, const void* dir_step, const void* hit, Sampler sample,
           const void* grid, int X, int Y, int Z, bool repeat, int H, int W, int max_samples,
           float iso, void* found, void* t_hit, void* near, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 blocks((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  const float iso255 = iso * 255.0f;
  unsigned below_under = 0, above_from = 0;
  while (below_under < 256 && static_cast<float>(below_under) + 0.5f < iso255) ++below_under;
  while (above_from < 256 && !(static_cast<float>(above_from) - 0.5f >= iso255)) ++above_from;
  const BlockGrid cells = vrt::block_grid(grid, X, Y, Z, repeat, below_under, above_from);
  auto* kernel = grid ? (near ? iso_march_kernel<true, true, Sampler>
                              : iso_march_kernel<true, false, Sampler>)
                     : (near ? iso_march_kernel<false, true, Sampler>
                             : iso_march_kernel<false, false, Sampler>);
  kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entry_uv), static_cast<const float*>(dir_step),
      static_cast<const uint8_t*>(hit), sample, cells, H, W, max_samples, iso,
      static_cast<uint8_t*>(found), static_cast<int32_t*>(t_hit), static_cast<float*>(near));
  return static_cast<int>(cudaGetLastError());
}

template <vrt::PoolFormat F>
int launch_pooled(const void* entry_uv, const void* dir_step, const void* hit, const void* pool,
                  const void* slab_map, const void* grid, int H, int W, int X, int Y, int Z,
                  int n_slots, int max_samples, float iso, void* found, void* t_hit,
                  void* near, void* stream) {
  return vrt::with_pool_sampler<F>(pool, slab_map, n_slots, X, Y, Z, [&](auto sample) {
    return launch(entry_uv, dir_step, hit, sample, grid, X, Y, Z, false, H, W, max_samples, iso,
                  found, t_hit, near, stream);
  });
}

}  // namespace

// Each launch runs the march on `stream` for an H x W ray image and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers:
// entry_uv and dir_step (H*W*3 f32), hit (H*W u8), found (H*W u8) and t_hit
// (H*W i32); grid is null (every sample is taken) or the block grid of the
// volume for this iso and wrap, ceil(Z/8)*ceil(Y/8)*ceil(X/8) pairs of u8
// (least, largest); near is null (not stored) or H*W*3 f32, written for the
// hit rays alone.

// B2: vol (Z*Y*X u8, x fastest); repeat != 0 selects GL_REPEAT wrapping.
extern "C" int iso_march_launch(const void* entry_uv, const void* dir_step, const void* hit,
                                const void* vol, const void* grid, int H, int W, int X, int Y,
                                int Z, int max_samples, int repeat, float iso, void* found,
                                void* t_hit, void* near, void* stream) {
  return vrt::with_volume_sampler<uint8_t>(vol, X, Y, Z, repeat != 0, [&](auto sample) {
    return launch(entry_uv, dir_step, hit, sample, grid, X, Y, Z, repeat != 0, H, W,
                  max_samples, iso, found, t_hit, near, stream);
  });
}

// B8: pool (n_slots*16*Y*X f32 pair values), slab_map (Z/8 i32), clamp.
extern "C" int iso_march_pooled_narrow_launch(const void* entry_uv, const void* dir_step,
                                              const void* hit, const void* pool,
                                              const void* slab_map, const void* grid, int H,
                                              int W, int X, int Y, int Z, int n_slots,
                                              int max_samples, float iso, void* found,
                                              void* t_hit, void* near, void* stream) {
  return launch_pooled<vrt::PoolFormat::kNarrowF32>(entry_uv, dir_step, hit, pool, slab_map,
                                                    grid, H, W, X, Y, Z, n_slots, max_samples,
                                                    iso, found, t_hit, near, stream);
}

// B9: pool (n_slots*16*Y*(X/2) i32 pair16 words), slab_map (Z/8 i32), clamp.
extern "C" int iso_march_pooled_pair16_launch(const void* entry_uv, const void* dir_step,
                                              const void* hit, const void* pool,
                                              const void* slab_map, const void* grid, int H,
                                              int W, int X, int Y, int Z, int n_slots,
                                              int max_samples, float iso, void* found,
                                              void* t_hit, void* near, void* stream) {
  return launch_pooled<vrt::PoolFormat::kPair16>(entry_uv, dir_step, hit, pool, slab_map, grid,
                                                 H, W, X, Y, Z, n_slots, max_samples, iso,
                                                 found, t_hit, near, stream);
}

extern "C" const char* iso_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
