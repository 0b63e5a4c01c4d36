// Front-to-back compositing ray march for Hopper (sm_90a), one thread per ray.
//
// Replaces the TPU compositing march: volumerenderer_tpu/ops/pallas/
// raycast_kernel.py::_launch (its pl.pallas_call) with the bodies
// _march_one_tile and _march_tiles_group -> _march_one_tile_group.  It computes
// exactly volumerenderer_tpu_torch/ops/raycast.py::composite_march_steps on the
// 8-bit volume: per ray, up to max_samples steps of
//   pos += dir_step;  leave once pos is outside the open cube (0,1)^3;
//   s = trilinear sample of the u8 volume (clamp-to-edge or repeat,
//       trilinear.cuh);
//   pa = s - s*a;  c += pa*s;  a += pa*0.6;  leave once a > 0.99.
//
// What bounds it on this card: every step is a data-dependent 8-tap gather
// whose addresses spread across a warp as the rays fan out, served by L1/L2
// (a 256^3 u8 volume is 16.8 MB and stays resident in the 50 MB L2); each ray
// runs up to ~300 dependent steps; and the rays of one warp terminate at
// different steps (bounds exit, early-out), idling the lanes that finished.
// The ~40 flops per step are small beside the gather latency.
//
// What this simple design does about it: one thread per ray in 16x8-pixel
// blocks, so a warp holds neighbouring rays whose taps overlap in the cache;
// taps come through the read-only data path (__ldg) from the u8 volume, a
// quarter of the bytes of f32; a thread leaves its loop as soon as its ray
// terminates.  The TPU design's pair-packed volume, DMA windows, word tables
// and lane groups are not carried over.  Left for later: empty-space
// skipping, shared-memory bricks, a fused transfer.
//
// Rounding: build with --fmad=false so every product and sum rounds on its
// own, as in the PyTorch and JAX versions.  A fused multiply-add moves the
// (0,1) bounds test and the 0.99 early-out by an ulp.  Literals are float
// (0.6f, 0.99f) so no comparison is promoted to double.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

__global__ void __launch_bounds__(kBlockX * kBlockY)
composite_march_kernel(const float* __restrict__ entry_uv, const float* __restrict__ dir_step,
                       const uint8_t* __restrict__ hit, const uint8_t* __restrict__ vol,
                       int H, int W, int X, int Y, int Z, int max_samples, bool repeat,
                       float* __restrict__ color, float* __restrict__ alpha) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= W || py >= H) return;
  const size_t ray = static_cast<size_t>(py) * static_cast<size_t>(W) + static_cast<size_t>(px);

  float c = 0.0f;
  float a = 0.0f;
  if (hit[ray]) {
    float p0 = entry_uv[3 * ray + 0];
    float p1 = entry_uv[3 * ray + 1];
    float p2 = entry_uv[3 * ray + 2];
    const float d0 = dir_step[3 * ray + 0];
    const float d1 = dir_step[3 * ray + 1];
    const float d2 = dir_step[3 * ray + 2];
    for (int i = 0; i < max_samples; ++i) {
      p0 = p0 + d0;
      p1 = p1 + d1;
      p2 = p2 + d2;
      if (!(p0 > 0.0f && p0 < 1.0f && p1 > 0.0f && p1 < 1.0f && p2 > 0.0f && p2 < 1.0f)) break;

      const float s = vrt::sample_trilinear(vol, p0, p1, p2, X, Y, Z, repeat);
      const float pa = s - s * a;
      c = c + pa * s;
      a = a + pa * 0.6f;
      if (!(a <= 0.99f)) break;
    }
  }
  color[ray] = c;
  alpha[ray] = a;
}

}  // namespace

// Launches the march on `stream` for an H x W ray image and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers:
// entry_uv and dir_step (H*W*3 f32), hit (H*W u8), vol (Z*Y*X u8, x fastest),
// color and alpha (H*W f32).  repeat != 0 selects GL_REPEAT wrapping.
extern "C" int composite_march_launch(const void* entry_uv, const void* dir_step, const void* hit,
                                      const void* vol, int H, int W, int X, int Y, int Z,
                                      int max_samples, int repeat, void* color, void* alpha,
                                      void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  composite_march_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entry_uv), static_cast<const float*>(dir_step),
      static_cast<const uint8_t*>(hit), static_cast<const uint8_t*>(vol), H, W, X, Y, Z,
      max_samples, repeat != 0, static_cast<float*>(color), static_cast<float*>(alpha));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* composite_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
