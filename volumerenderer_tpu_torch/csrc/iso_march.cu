// Isosurface crossing march for Hopper (sm_90a), one thread per ray.
//
// Replaces the TPU isosurface march: volumerenderer_tpu/ops/pallas/
// isosurface_kernel.py::_launch_group (body _iso_one_tile_group, driven by
// march_phased) and ::_launch (body _iso_one_tile, the per-step plans).  It
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

__global__ void __launch_bounds__(kBlockX * kBlockY)
iso_march_kernel(const float* __restrict__ entry_uv, const float* __restrict__ dir_step,
                 const uint8_t* __restrict__ hit, const uint8_t* __restrict__ vol,
                 int H, int W, int X, int Y, int Z, int max_samples, bool repeat, float iso,
                 uint8_t* __restrict__ found_out, int32_t* __restrict__ t_hit_out) {
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
      if (i == 1) s = vrt::sample_trilinear(vol, p0, p1, p2, X, Y, Z, repeat);
      const float s2 =
          vrt::sample_trilinear(vol, p0 + d0, p1 + d1, p2 + d2, X, Y, Z, repeat);
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

}  // namespace

// Launches the march on `stream` for an H x W ray image and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers:
// entry_uv and dir_step (H*W*3 f32), hit (H*W u8), vol (Z*Y*X u8, x fastest),
// found (H*W u8) and t_hit (H*W i32).  repeat != 0 selects GL_REPEAT wrapping.
extern "C" int iso_march_launch(const void* entry_uv, const void* dir_step, const void* hit,
                                const void* vol, int H, int W, int X, int Y, int Z,
                                int max_samples, int repeat, float iso, void* found,
                                void* t_hit, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  iso_march_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entry_uv), static_cast<const float*>(dir_step),
      static_cast<const uint8_t*>(hit), static_cast<const uint8_t*>(vol), H, W, X, Y, Z,
      max_samples, repeat != 0, iso, static_cast<uint8_t*>(found),
      static_cast<int32_t*>(t_hit));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* iso_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
