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
// t_hit is -1 for a miss; the near bracket of a hit is entry + (t_hit + 1)
// repeated additions of dir_step, as iso_shade.cu rebuilds it.
//
// What bounds it on this card: one data-dependent 8-tap gather per step
// (the lookahead; the current sample is carried), served by L1/L2 (a 256^3
// u8 volume is 16.8 MB and stays in the 50 MB L2); up to ~300 dependent steps
// per ray; and the rays of one warp leave at different steps.  The flops per
// step are small beside the gather latency.
//
// What this simple design does about it: one thread per ray in 16x8-pixel
// blocks (neighbouring rays share cache lines), taps through __ldg from the u8
// volume, the lookahead carried so each step gathers once, and a thread leaves
// as soon as its ray hits or exits.  The TPU design's occupancy word tables
// (bind), window DMAs, lane groups, texr rows and resumable state rows feed
// VMEM windows and change no result; none is carried over.  Left for later:
// empty-space skipping.
//
// The pooled marches are the same body with the slab-pool sampler
// (trilinear.cuh, sample_trilinear_pool): they replace isosurface_kernel.py::
// _launch_group_pooled_narrow (B8, the narrow f32 pool) and ::_launch_pooled
// (B9, the pair16 pool).  Their TPU state rows (resumable phases) feed the
// phased march of bind and are left out, as for B2.  Each tap reads its pair
// through the slab map; a slot-0 read (an empty slab) is exact, every tap
// there being 0.  Clamp only, as the TPU pooled plans.
//
// Rounding: build with --fmad=false; the crossing test compares normalized
// samples with iso rounded once to f32 (not the TPU kernel's 0-255 scale),
// as the plain version does.  Literals are float.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

template <class Sampler>
__global__ void __launch_bounds__(kBlockX * kBlockY)
iso_march_kernel(const float* __restrict__ entry_uv, const float* __restrict__ dir_step,
                 const uint8_t* __restrict__ hit, Sampler sample, int H, int W, int max_samples,
                 float iso, uint8_t* __restrict__ found_out, int32_t* __restrict__ t_hit_out) {
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
    float s = 0.0f;
    for (int i = 1; i <= max_samples; ++i) {
      p0 = p0 + d0;
      p1 = p1 + d1;
      p2 = p2 + d2;
      if (!(p0 > 0.0f && p0 < 1.0f && p1 > 0.0f && p1 < 1.0f && p2 > 0.0f && p2 < 1.0f)) break;
      if (i == 1) s = sample(p0, p1, p2);
      const float s2 = sample(p0 + d0, p1 + d1, p2 + d2);
      if ((s - iso) < 0.0f && (s2 - iso) >= 0.0f) {
        found = 1;
        t_hit = i - 1;
        break;
      }
      s = s2;
    }
  }
  found_out[ray] = found;
  t_hit_out[ray] = t_hit;
}

template <class Sampler>
int launch(const void* entry_uv, const void* dir_step, const void* hit, Sampler sample, int H,
           int W, int max_samples, float iso, void* found, void* t_hit, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  iso_march_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entry_uv), static_cast<const float*>(dir_step),
      static_cast<const uint8_t*>(hit), sample, H, W, max_samples, iso,
      static_cast<uint8_t*>(found), static_cast<int32_t*>(t_hit));
  return static_cast<int>(cudaGetLastError());
}

template <vrt::PoolFormat F>
int launch_pooled(const void* entry_uv, const void* dir_step, const void* hit, const void* pool,
                  const void* slab_map, int H, int W, int X, int Y, int Z, int n_slots,
                  int max_samples, float iso, void* found, void* t_hit, void* stream) {
  const vrt::PoolSampler<F> sample{pool, static_cast<const int32_t*>(slab_map), n_slots, X, Y, Z};
  return launch(entry_uv, dir_step, hit, sample, H, W, max_samples, iso, found, t_hit, stream);
}

}  // namespace

// Each launch runs the march on `stream` for an H x W ray image and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers:
// entry_uv and dir_step (H*W*3 f32), hit (H*W u8), found (H*W u8) and t_hit
// (H*W i32).

// B2: vol (Z*Y*X u8, x fastest); repeat != 0 selects GL_REPEAT wrapping.
extern "C" int iso_march_launch(const void* entry_uv, const void* dir_step, const void* hit,
                                const void* vol, int H, int W, int X, int Y, int Z,
                                int max_samples, int repeat, float iso, void* found,
                                void* t_hit, void* stream) {
  const vrt::DenseSampler sample{static_cast<const uint8_t*>(vol), X, Y, Z, repeat != 0};
  return launch(entry_uv, dir_step, hit, sample, H, W, max_samples, iso, found, t_hit, stream);
}

// B8: pool (n_slots*16*Y*X f32 pair values), slab_map (Z/8 i32), clamp.
extern "C" int iso_march_pooled_narrow_launch(const void* entry_uv, const void* dir_step,
                                              const void* hit, const void* pool,
                                              const void* slab_map, int H, int W, int X, int Y,
                                              int Z, int n_slots, int max_samples, float iso,
                                              void* found, void* t_hit, void* stream) {
  return launch_pooled<vrt::PoolFormat::kNarrowF32>(entry_uv, dir_step, hit, pool, slab_map, H,
                                                    W, X, Y, Z, n_slots, max_samples, iso,
                                                    found, t_hit, stream);
}

// B9: pool (n_slots*16*Y*(X/2) i32 pair16 words), slab_map (Z/8 i32), clamp.
extern "C" int iso_march_pooled_pair16_launch(const void* entry_uv, const void* dir_step,
                                              const void* hit, const void* pool,
                                              const void* slab_map, int H, int W, int X, int Y,
                                              int Z, int n_slots, int max_samples, float iso,
                                              void* found, void* t_hit, void* stream) {
  return launch_pooled<vrt::PoolFormat::kPair16>(entry_uv, dir_step, hit, pool, slab_map, H, W,
                                                 X, Y, Z, n_slots, max_samples, iso, found,
                                                 t_hit, stream);
}

extern "C" const char* iso_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
