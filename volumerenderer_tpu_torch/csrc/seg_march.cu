// Segment marches on one volume shard for Hopper (sm_90a), one thread per ray.
//
// Replace the TPU segment kernels of the volume-sharded layouts:
// volumerenderer_tpu/ops/pallas/seg_kernel.py::launch_seg (B10, body
// _seg_one_tile) and ::launch_seg_tf (B11, body _seg_tf_one_tile).  One body,
// templated on the sums it keeps, computes exactly
// volumerenderer_tpu_torch/ops/raycast.py::seg_march_steps (B10) and
// volumerenderer_tpu_torch/diff/closed_form.py::seg_tf_march_steps (B11) on
// the shard's halo-extended u8 slab: per ray, up to max_samples steps of
//   pos += dir_step;  leave once pos is outside the open cube (0,1)^3;
//   owned = the clamped floor anchors (z0, y0) of pos lie in the shard's box
//           [z_lo, z_hi) x [y_lo, y_hi);
//   where owned: s = the global volume's trilinear sample (ShardSampler,
//   trilinear.cuh), then
//     B10: pa = s - s*a;  c += pa*s;  a += pa*0.6;
//     B11: sc = s*G + B;  pa = s - s*a;  r = s / max(1 - K*s, 1e-12);
//          P += s*sc*(1 - a);  R += r;  QP += r*P;  SG += pa*s;  SB += pa;
//          c += pa*sc;  a += pa*K;
//   t_first = the first owned step index (0-based; BIG_T = 1e9 if none).
// There is no a > 0.99 early-out: a shard cannot see the ray's global alpha.
// A ray whose samples the shard does not own writes c = a = 0 and t_first =
// BIG_T, the identity segment.  B10 writes three (H, W) f32 planes (c, a,
// t_first), B11 eight (c, a, t_first, R, P, QP, SG, SB), plane after plane.
//
// In place of the TPU word table's group skip, each step advances the
// position, tests inside, computes the anchor (no memory read) and samples
// only when the ray is alive and the sample owned.  A ray leaves its loop
// once it has been owned and is owned no more: positions built by repeated
// addition of one step move monotonically along each axis (float addition is
// monotone), so their clamped floor anchors do too, and the owned steps of a
// ray form one interval.  Leaving after it changes no output.
//
// What bounds it on this card: every hit ray walks its chord to the far end
// of the shard's owned interval with no early-out, so the samples summed over
// the shards of a frame are about the chord length of every hit ray (up to
// 300 samples), against the ~13 of the dense march B1 on the orbit, which
// stops at a > 0.99: each step is a data-dependent 8-tap
// gather that the 16.8 MB volume serves from L2, like B2's 175 samples per
// ray.  The steps before the shard are a position add and an anchor test.
//
// What this simple design does about it: B1's design (composite_march.cu) and
// B4's (tf_march.cu): one thread per ray in 16x8-pixel blocks, taps through
// __ldg from the u8 slab, state in registers, no memory read for a step the
// shard does not own, and the loop left after the owned interval.  The TPU
// design's pair-packed slabs, DMA windows, per-shard word tables and lane
// groups are not carried over.  Left for later: starting each ray at its
// shard's entry step, and skipping empty space.
//
// Rounding: built with --fmad=false, every product and sum rounds on its own
// in the plain versions' order; the division is IEEE.  Literals are float
// (0.6f, 1e-12f) so no comparison is promoted to double.

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "trilinear.cuh"

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;
constexpr float kBigT = 1.0e9f;

struct Box {
  float z_lo, z_hi, y_lo, y_hi;
};

template <bool kTF>
__global__ void __launch_bounds__(kBlockX * kBlockY)
seg_march_kernel(const float* __restrict__ entry_uv, const float* __restrict__ dir_step,
                 const uint8_t* __restrict__ hit, vrt::ShardSampler sample, Box box,
                 const float* __restrict__ tf, int H, int W, int max_samples,
                 float* __restrict__ out) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= W || py >= H) return;
  const size_t ray = static_cast<size_t>(py) * static_cast<size_t>(W) + static_cast<size_t>(px);

  float c = 0.0f;
  float a = 0.0f;
  float t_first = kBigT;
  float R = 0.0f;
  float P = 0.0f;
  float QP = 0.0f;
  float SG = 0.0f;
  float SB = 0.0f;
  if (hit[ray]) {
    float K = 0.6f, G = 1.0f, B = 0.0f;
    if constexpr (kTF) {
      K = __ldg(tf + 0);
      G = __ldg(tf + 1);
      B = __ldg(tf + 2);
    }
    const float fY = static_cast<float>(sample.Y);
    const float fZ = static_cast<float>(sample.Z);
    float p0 = entry_uv[3 * ray + 0];
    float p1 = entry_uv[3 * ray + 1];
    float p2 = entry_uv[3 * ray + 2];
    const float d0 = dir_step[3 * ray + 0];
    const float d1 = dir_step[3 * ray + 1];
    const float d2 = dir_step[3 * ray + 2];
    bool was_owned = false;
    for (int i = 0; i < max_samples; ++i) {
      p0 = p0 + d0;
      p1 = p1 + d1;
      p2 = p2 + d2;
      if (!(p0 > 0.0f && p0 < 1.0f && p1 > 0.0f && p1 < 1.0f && p2 > 0.0f && p2 < 1.0f)) break;

      const float z0 = fminf(fmaxf(floorf(p2 * fZ - 0.5f), 0.0f), fZ - 1.0f);
      const float y0 = fminf(fmaxf(floorf(p1 * fY - 0.5f), 0.0f), fY - 1.0f);
      if (!(z0 >= box.z_lo && z0 < box.z_hi && y0 >= box.y_lo && y0 < box.y_hi)) {
        if (was_owned) break;  // past the owned interval: nothing more to add
        continue;
      }
      was_owned = true;

      const float s = sample(p0, p1, p2);
      if constexpr (kTF) {
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
      } else {
        const float pa = s - s * a;
        c = c + pa * s;
        a = a + pa * 0.6f;
      }
      t_first = fminf(t_first, static_cast<float>(i));
    }
  }
  const size_t plane = static_cast<size_t>(H) * static_cast<size_t>(W);
  out[0 * plane + ray] = c;
  out[1 * plane + ray] = a;
  out[2 * plane + ray] = t_first;
  if constexpr (kTF) {
    out[3 * plane + ray] = R;
    out[4 * plane + ray] = P;
    out[5 * plane + ray] = QP;
    out[6 * plane + ray] = SG;
    out[7 * plane + ray] = SB;
  }
}

template <bool kTF>
int launch(const void* entry_uv, const void* dir_step, const void* hit, const void* slab,
           const void* tf, int H, int W, int X, int Y, int Z, int z_lo, int z_hi, int y_lo,
           int y_hi, int Ez, int Ey, int max_samples, void* out, void* stream) {
  const vrt::ShardSampler sample{static_cast<const uint8_t*>(slab), X, Y, Z, z_lo, y_lo, Ez, Ey};
  const Box box{static_cast<float>(z_lo), static_cast<float>(z_hi), static_cast<float>(y_lo),
                static_cast<float>(y_hi)};
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
  seg_march_kernel<kTF><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entry_uv), static_cast<const float*>(dir_step),
      static_cast<const uint8_t*>(hit), sample, box, static_cast<const float*>(tf), H, W,
      max_samples, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launch runs the march on `stream` for an H x W ray image and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers:
// entry_uv and dir_step (H*W*3 f32), hit (H*W u8), slab (Ez*Ey*X u8, x
// fastest: the global rows [z_lo, z_lo + Ez) x [y_lo, y_lo + Ey) of an
// (X, Y, Z) volume), out (3 or 8 planes of H*W f32).  The owned anchor box is
// [z_lo, z_hi) x [y_lo, y_hi) in global texel indices.

// B10: out holds c, alpha, t_first.
extern "C" int seg_march_launch(const void* entry_uv, const void* dir_step, const void* hit,
                                const void* slab, int H, int W, int X, int Y, int Z, int z_lo,
                                int z_hi, int y_lo, int y_hi, int Ez, int Ey, int max_samples,
                                void* out, void* stream) {
  return launch<false>(entry_uv, dir_step, hit, slab, nullptr, H, W, X, Y, Z, z_lo, z_hi, y_lo,
                       y_hi, Ez, Ey, max_samples, out, stream);
}

// B11: tf (3 f32: K, G, B); out holds c, alpha, t_first, R, P, QP, SG, SB.
extern "C" int seg_tf_march_launch(const void* entry_uv, const void* dir_step, const void* hit,
                                   const void* slab, const void* tf, int H, int W, int X, int Y,
                                   int Z, int z_lo, int z_hi, int y_lo, int y_hi, int Ez, int Ey,
                                   int max_samples, void* out, void* stream) {
  return launch<true>(entry_uv, dir_step, hit, slab, tf, H, W, X, Y, Z, z_lo, z_hi, y_lo, y_hi,
                      Ez, Ey, max_samples, out, stream);
}

extern "C" const char* seg_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
