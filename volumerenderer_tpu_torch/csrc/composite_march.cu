// Front-to-back compositing ray march for Hopper (sm_90a), one thread per ray.
//
// Replaces the TPU compositing march: volumerenderer_tpu/ops/pallas/
// raycast_kernel.py::_launch (its pl.pallas_call) with the bodies
// _march_one_tile and _march_tiles_group -> _march_one_tile_group (B1).  It
// computes exactly volumerenderer_tpu_torch/ops/raycast.py::
// composite_march_steps on the 8-bit volume: per ray, up to max_samples steps
// of
//   pos += dir_step;  leave once pos is outside the open cube (0,1)^3;
//   s = trilinear sample of the u8 volume (clamp-to-edge or repeat,
//       trilinear.cuh);
//   pa = s - s*a;  c += pa*s;  a += pa*0.6;  leave once a > 0.99.
//
// What bounds it on this card: every step is a data-dependent 8-tap gather
// whose addresses spread across a warp as the rays fan out; each ray runs up
// to ~300 dependent steps; the rays of one warp may end at different steps.
// Measured on the benchmark orbit (1024^2 rays, 256^3 turbulence): a frame's
// taps read ~40 K voxels, each by hundreds of rays, so the gathers hit L1; a
// warp's lanes are busy 99.5 % of its steps; a one-step tap prefetch is
// slower.  What is left is the instructions of a step (texel math, index
// clamps and offsets, 8 loads, the taps' scale or quantize, 7 lerps): their
// count tracks the time (PERF.md, the B1 variants).
//
// What this design does about it: one thread per ray in 16x8-pixel blocks,
// so a warp holds neighbouring rays whose taps overlap in the cache; taps
// come through the read-only data path (__ldg); a thread leaves its loop as
// soon as its ray terminates.  The TPU design's pair-packed volume, DMA
// windows, word tables and lane groups are not carried over.
//
// The whole TPU launch is one kernel here.  The TPU launch quantizes the
// float volume to 8 bits inside its jit (raycast_kernel.py::pack_pairs); a
// separate quantize pass reads the 67 MB float32 volume and writes a 16.8 MB
// byte copy every frame, three times the march's own time.  The main path's
// entry (composite_march_f32_launch) reads the float32 volume instead and
// quantizes each tap as it reads it (trilinear.cuh, VolumeSampler<float>),
// so a frame touches only the voxels its rays sample.  The f32 volume does
// not fit the 50 MB L2, so a field whose rays run deep reads up to four
// times the bytes of the u8 route.  With rgb != 0 the epilogue also writes
// the displayed image (the reference transfer), so a frame is one launch.
// The wrap and the width of the voxel offsets are compile-time choices of
// the sampler, so the per-tap index math carries no wrap test and no 64-bit
// sums where the volume has at most 2^32 voxels.
//
// The pooled marches are the same body with the slab-pool sampler
// (trilinear.cuh, sample_trilinear_pool): they replace raycast_kernel.py::
// _launch_pooled_narrow (B6, the narrow f32 pool) and ::_launch_pooled (B7,
// the pair16 pool), whose TPU designs DMA windows out of the pool.  Here each
// tap reads its pair through the slab map from device memory: four pair
// fetches per sample instead of eight bytes, plus the map read.  A pool is
// larger than the u8 volume (2 B per voxel of an occupied slab for pair16, 4
// B for narrow, slabs overlapping by 8 rows), so at 256^3 a full narrow pool
// (138 MB) no longer fits the 50 MB L2 the dense march lives in.  Clamp only,
// as the TPU pooled plans: with GL_REPEAT the last slab's z + 1 tap would
// wrap into slab 0.
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

// kRgb: the epilogue writes the displayed image, rgb (H, W, 3) = (1 - c,
// 1 - c, 1) (ops/raycast.py::apply_reference_transfer, bit for bit), into
// `out`, with alpha; otherwise `out` is the (H, W) color c.
template <class Sampler, bool kRgb>
__global__ void __launch_bounds__(kBlockX * kBlockY)
composite_march_kernel(const float* __restrict__ entry_uv, const float* __restrict__ dir_step,
                       const uint8_t* __restrict__ hit, Sampler sample, int H, int W,
                       int max_samples, float* __restrict__ out, float* __restrict__ alpha) {
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

      const float s = sample(p0, p1, p2);
      const float pa = s - s * a;
      c = c + pa * s;
      a = a + pa * 0.6f;
      if (!(a <= 0.99f)) break;
    }
  }
  if constexpr (kRgb) {
    const float inv = 1.0f - c;
    out[3 * ray + 0] = inv;
    out[3 * ray + 1] = inv;
    out[3 * ray + 2] = 1.0f;
  } else {
    out[ray] = c;
  }
  alpha[ray] = a;
}

template <class Sampler>
int launch(const void* entry_uv, const void* dir_step, const void* hit, Sampler sample, int H,
           int W, int max_samples, int rgb, void* out, void* alpha, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto e = static_cast<const float*>(entry_uv);
  const auto d = static_cast<const float*>(dir_step);
  const auto h = static_cast<const uint8_t*>(hit);
  if (rgb) {
    composite_march_kernel<Sampler, true><<<grid, block, 0, s>>>(
        e, d, h, sample, H, W, max_samples, static_cast<float*>(out), static_cast<float*>(alpha));
  } else {
    composite_march_kernel<Sampler, false><<<grid, block, 0, s>>>(
        e, d, h, sample, H, W, max_samples, static_cast<float*>(out), static_cast<float*>(alpha));
  }
  return static_cast<int>(cudaGetLastError());
}

template <vrt::PoolFormat F>
int launch_pooled(const void* entry_uv, const void* dir_step, const void* hit, const void* pool,
                  const void* slab_map, int H, int W, int X, int Y, int Z, int n_slots,
                  int max_samples, int rgb, void* out, void* alpha, void* stream) {
  const vrt::PoolSampler<F> sample{pool, static_cast<const int32_t*>(slab_map), n_slots, X, Y, Z};
  return launch(entry_uv, dir_step, hit, sample, H, W, max_samples, rgb, out, alpha, stream);
}

// B1 on a dense volume of T (uint8_t: bytes; float: taps quantized as read),
// the wrap and the offset type fixed at compile time in the kernel.
template <class T>
int launch_dense(const void* entry_uv, const void* dir_step, const void* hit, const void* vol,
                 int H, int W, int X, int Y, int Z, int max_samples, int repeat, int rgb,
                 void* out, void* alpha, void* stream) {
  return vrt::with_volume_sampler<T>(vol, X, Y, Z, repeat != 0, [&](auto sample) {
    return launch(entry_uv, dir_step, hit, sample, H, W, max_samples, rgb, out, alpha, stream);
  });
}

}  // namespace

// Each launch runs the march on `stream` for an H x W ray image and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers:
// entry_uv and dir_step (H*W*3 f32), hit (H*W u8), alpha (H*W f32), and out:
// the color (H*W f32), or with rgb != 0 the displayed image (H*W*3 f32).

// B1: vol (Z*Y*X u8, x fastest); repeat != 0 selects GL_REPEAT wrapping.
extern "C" int composite_march_launch(const void* entry_uv, const void* dir_step, const void* hit,
                                      const void* vol, int H, int W, int X, int Y, int Z,
                                      int max_samples, int repeat, int rgb, void* out,
                                      void* alpha, void* stream) {
  return launch_dense<uint8_t>(entry_uv, dir_step, hit, vol, H, W, X, Y, Z, max_samples, repeat,
                               rgb, out, alpha, stream);
}

// B1 on the float32 volume (Z*Y*X f32, x fastest), each tap quantized to 8
// bits as it is read (trilinear.cuh, VolumeSampler<float>): bit for bit B1
// on quantize_u8 of the volume, with no quantize pass before it.
extern "C" int composite_march_f32_launch(const void* entry_uv, const void* dir_step,
                                          const void* hit, const void* vol, int H, int W, int X,
                                          int Y, int Z, int max_samples, int repeat, int rgb,
                                          void* out, void* alpha, void* stream) {
  return launch_dense<float>(entry_uv, dir_step, hit, vol, H, W, X, Y, Z, max_samples, repeat,
                             rgb, out, alpha, stream);
}

// B6: pool (n_slots*16*Y*X f32 pair values), slab_map (Z/8 i32), clamp.
extern "C" int composite_march_pooled_narrow_launch(const void* entry_uv, const void* dir_step,
                                                    const void* hit, const void* pool,
                                                    const void* slab_map, int H, int W, int X,
                                                    int Y, int Z, int n_slots, int max_samples,
                                                    int rgb, void* out, void* alpha,
                                                    void* stream) {
  return launch_pooled<vrt::PoolFormat::kNarrowF32>(entry_uv, dir_step, hit, pool, slab_map, H,
                                                    W, X, Y, Z, n_slots, max_samples, rgb, out,
                                                    alpha, stream);
}

// B7: pool (n_slots*16*Y*(X/2) i32 pair16 words), slab_map (Z/8 i32), clamp.
extern "C" int composite_march_pooled_pair16_launch(const void* entry_uv, const void* dir_step,
                                                    const void* hit, const void* pool,
                                                    const void* slab_map, int H, int W, int X,
                                                    int Y, int Z, int n_slots, int max_samples,
                                                    int rgb, void* out, void* alpha,
                                                    void* stream) {
  return launch_pooled<vrt::PoolFormat::kPair16>(entry_uv, dir_step, hit, pool, slab_map, H, W,
                                                 X, Y, Z, n_slots, max_samples, rgb, out, alpha,
                                                 stream);
}

extern "C" const char* composite_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
