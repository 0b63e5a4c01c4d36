// Compositing ray march with a learnable transfer function and, in the same
// pass, every TF gradient sum, for Hopper (sm_90a), one thread per ray.
//
// Replaces the TPU TF-gradient march: volumerenderer_tpu/ops/pallas/
// tf_kernel.py::_launch_tf (its pl.pallas_call) with the bodies _tf_kernel
// -> _tf_one_tile.  It computes exactly
// volumerenderer_tpu_torch/diff/closed_form.py::tf_march_steps on the 8-bit
// volume: per ray, up to max_samples steps of
//   pos += dir_step;  leave once pos is outside the open cube (0,1)^3;
//   s = clamp-to-edge trilinear sample of the u8 volume (trilinear.cuh);
//   sc = s*G + B;  pa = s - s*a;  r = s / max(1 - K*s, 1e-12);
//   P += s*sc*(1 - a)  (the pre-update alpha);  R += r;  QP += r*P  (the
//   inclusive P);  SG += pa*s;  SB += pa;
//   c += pa*sc;  a += pa*K;  leave once a > 0.99.
// It writes seven (H, W) f32 images, plane after plane: color, alpha, R,
// P_total, QP, SG, SB.  (K, G, B) come from a (3,) f32 device array, so a
// fit step never reads them on the host.
//
// What bounds it on this card: as for composite_march.cu, the data-dependent
// 8-tap gather of every step (the 16.8 MB u8 volume of a 256^3 field stays in
// the 50 MB L2), up to ~300 dependent steps per ray, and lanes idled by rays
// of one warp that stop at different steps.  The five extra sums cost ~12
// flops and 5 registers per step and 20 bytes more of output per ray.
//
// What this simple design does about it: B1's design (composite_march.cu):
// one thread per ray in 16x8-pixel blocks, taps through __ldg, the loop left
// as soon as the ray stops, with the sums in registers.  As B1 does, the fit
// step's entry (tf_march_f32_launch) reads the float32 volume and quantizes
// each tap as it reads it, so a step makes no byte copy of the volume.  The
// TPU design's field-major state rows, DMA windows and word tables are not
// carried over.
//
// Rounding: built with --fmad=false, every product and sum rounds on its own
// as in the plain version, in its order; the division is IEEE (no fast math).
// Literals are float (0.99f, 1e-12f) so no comparison is promoted to double.
// At K = 0.6, G = 1, B = 0 the color and alpha are composite_march.cu's bit
// for bit (s*1 + 0 == s).

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

template <class Sampler>
__global__ void __launch_bounds__(kBlockX * kBlockY)
tf_march_kernel(const float* __restrict__ entry_uv, const float* __restrict__ dir_step,
                const uint8_t* __restrict__ hit, Sampler sample, const float* __restrict__ tf,
                int H, int W, int max_samples, float* __restrict__ out) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= W || py >= H) return;
  const size_t ray = static_cast<size_t>(py) * static_cast<size_t>(W) + static_cast<size_t>(px);

  float c = 0.0f;
  float a = 0.0f;
  float R = 0.0f;
  float P = 0.0f;
  float QP = 0.0f;
  float SG = 0.0f;
  float SB = 0.0f;
  if (hit[ray]) {
    const float K = __ldg(tf + 0);
    const float G = __ldg(tf + 1);
    const float B = __ldg(tf + 2);
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
      const float sc = s * G + B;
      const float pa = s - s * a;
      const float r = s / fmaxf(1.0f - K * s, 1e-12f);
      P = P + s * sc * (1.0f - a);
      R = R + r;
      QP = QP + r * P;
      SG = SG + pa * s;
      SB = SB + pa;
      c = c + pa * sc;
      a = a + pa * K;
      if (!(a <= 0.99f)) break;
    }
  }
  const size_t plane = static_cast<size_t>(H) * static_cast<size_t>(W);
  out[0 * plane + ray] = c;
  out[1 * plane + ray] = a;
  out[2 * plane + ray] = R;
  out[3 * plane + ray] = P;
  out[4 * plane + ray] = QP;
  out[5 * plane + ray] = SG;
  out[6 * plane + ray] = SB;
}

template <class Sampler>
int launch(const void* entry_uv, const void* dir_step, const void* hit, Sampler sample,
           const void* tf, int H, int W, int max_samples, void* out, void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  tf_march_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entry_uv), static_cast<const float*>(dir_step),
      static_cast<const uint8_t*>(hit), sample, static_cast<const float*>(tf), H, W,
      max_samples, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// B4 on a dense volume of T (uint8_t: bytes; float: taps quantized as read),
// clamp-only, with B1's sampler.
template <class T>
int launch_dense(const void* entry_uv, const void* dir_step, const void* hit, const void* vol,
                 const void* tf, int H, int W, int X, int Y, int Z, int max_samples, void* out,
                 void* stream) {
  return vrt::with_volume_sampler<T, false>(vol, X, Y, Z, [&](auto sample) {
    return launch(entry_uv, dir_step, hit, sample, tf, H, W, max_samples, out, stream);
  });
}

}  // namespace

// Each launch runs the march on `stream` for an H x W ray image and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers:
// entry_uv and dir_step (H*W*3 f32), hit (H*W u8), tf (3 f32: K, G, B), out
// (7*H*W f32, the seven images plane after plane).

// vol: Z*Y*X u8, x fastest.
extern "C" int tf_march_launch(const void* entry_uv, const void* dir_step, const void* hit,
                               const void* vol, const void* tf, int H, int W, int X, int Y,
                               int Z, int max_samples, void* out, void* stream) {
  return launch_dense<uint8_t>(entry_uv, dir_step, hit, vol, tf, H, W, X, Y, Z, max_samples, out,
                               stream);
}

// vol: Z*Y*X f32, x fastest, each tap quantized to 8 bits as it is read
// (trilinear.cuh, VolumeSampler<float>): bit for bit tf_march_launch on
// quantize_u8 of the volume, with no quantize pass before it.
extern "C" int tf_march_f32_launch(const void* entry_uv, const void* dir_step, const void* hit,
                                   const void* vol, const void* tf, int H, int W, int X, int Y,
                                   int Z, int max_samples, void* out, void* stream) {
  return launch_dense<float>(entry_uv, dir_step, hit, vol, tf, H, W, X, Y, Z, max_samples, out,
                             stream);
}

extern "C" const char* tf_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
