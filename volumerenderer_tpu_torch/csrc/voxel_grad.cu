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
// What bounds it on this card: the march's gathers, as in tf_march.cu, and
// the 8 float atomicAdds per step into the 67 MB gradient volume of a 256^3
// field, which leaves the L2 (50 MB).  Neighbouring rays of a warp cross the
// same voxels (at 1024^2 rays over 256^3, about 16 rays per voxel column),
// so atomics to one address serialize.
//
// What this simple design does about it: one thread per ray in 16x8-pixel
// blocks (as B1), every tap a plain atomicAdd to device memory.  The TPU
// design's window-local accumulator flushed by a read-modify-write DMA
// relies on sequential grid programs and does not carry over: blocks run in
// parallel here, so the sum needs atomics.  Warp-aggregated or
// shared-memory-tiled accumulation is left for later.
//
// Rounding: built with --fmad=false, each product and sum in the plain
// version's order; IEEE division.  The order of the atomic sums is not
// fixed, so the result matches the plain version to a tolerance, not bits.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

__global__ void __launch_bounds__(kBlockX * kBlockY)
voxel_grad_kernel(const float* __restrict__ entry_uv, const float* __restrict__ dir_step,
                  const uint8_t* __restrict__ hit, const uint8_t* __restrict__ vol,
                  const float* __restrict__ tf, const float* __restrict__ gc_img,
                  const float* __restrict__ gaT_img, const float* __restrict__ P_tot_img,
                  int H, int W, int X, int Y, int Z, int max_samples,
                  float* __restrict__ g_vol) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= W || py >= H) return;
  const size_t ray = static_cast<size_t>(py) * static_cast<size_t>(W) + static_cast<size_t>(px);
  if (!hit[ray]) return;

  const float K = __ldg(tf + 0);
  const float G = __ldg(tf + 1);
  const float B = __ldg(tf + 2);
  const float gc = gc_img[ray];
  const float gaT_term = gaT_img[ray];
  const float P_tot = P_tot_img[ray];
  float p0 = entry_uv[3 * ray + 0];
  float p1 = entry_uv[3 * ray + 1];
  float p2 = entry_uv[3 * ray + 2];
  const float d0 = dir_step[3 * ray + 0];
  const float d1 = dir_step[3 * ray + 1];
  const float d2 = dir_step[3 * ray + 2];
  float a = 0.0f;
  float P = 0.0f;
  for (int i = 0; i < max_samples; ++i) {
    p0 = p0 + d0;
    p1 = p1 + d1;
    p2 = p2 + d2;
    if (!(p0 > 0.0f && p0 < 1.0f && p1 > 0.0f && p1 < 1.0f && p2 > 0.0f && p2 < 1.0f)) break;

    const float s = vrt::sample_trilinear(vol, p0, p1, p2, X, Y, Z, false);
    const float sc = s * G + B;
    const float pa = s - s * a;
    P = P + s * sc * (1.0f - a);
    const float denom = fmaxf(1.0f - K * s, 1e-12f);
    const float ga_term = K * (gaT_term - gc * (P_tot - P)) / denom;
    const float g_s = gc * ((1.0f - a) * sc + pa * G) + ga_term;

    size_t offset[8];
    float weight[8];
    vrt::trilinear_adjoint(p0, p1, p2, X, Y, Z, g_s, offset, weight);
#pragma unroll
    for (int k = 0; k < 8; ++k) atomicAdd(g_vol + offset[k], weight[k]);

    a = a + pa * K;
    if (!(a <= 0.99f)) break;
  }
}

}  // namespace

// Launches the gradient march on `stream` for an H x W ray image and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers:
// entry_uv and dir_step (H*W*3 f32), hit (H*W u8), vol (Z*Y*X u8, x fastest),
// tf (3 f32: K, G, B), gc, gaT_term and P_tot (H*W f32), g_vol (Z*Y*X f32,
// zero on entry; the gradient is added into it).
extern "C" int voxel_grad_launch(const void* entry_uv, const void* dir_step, const void* hit,
                                 const void* vol, const void* tf, const void* gc,
                                 const void* gaT_term, const void* P_tot, int H, int W, int X,
                                 int Y, int Z, int max_samples, void* g_vol, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  voxel_grad_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entry_uv), static_cast<const float*>(dir_step),
      static_cast<const uint8_t*>(hit), static_cast<const uint8_t*>(vol),
      static_cast<const float*>(tf), static_cast<const float*>(gc),
      static_cast<const float*>(gaT_term), static_cast<const float*>(P_tot), H, W, X, Y, Z,
      max_samples, static_cast<float*>(g_vol));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* voxel_grad_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
