// Segment marches on one volume shard for Hopper (sm_90a), one thread per ray,
// and the per-camera entry table they start from.
//
// Replace the TPU segment kernels of the volume-sharded layouts:
// volumerenderer_tpu/ops/pallas/seg_kernel.py::launch_seg (B10, body
// _seg_one_tile) and ::launch_seg_tf (B11, body _seg_tf_one_tile), and, for
// the table, that file's build_word_table_seg (its group skip and DMA window
// origins).  One march body, templated on the sums it keeps, computes exactly
// volumerenderer_tpu_torch/ops/raycast.py::seg_march_steps (B10) and
// volumerenderer_tpu_torch/diff/closed_form.py::seg_tf_march_steps (B11) on
// the shard's halo-extended u8 slab: per ray, up to max_samples steps of
//   pos += dir_step;  leave once pos is outside the open cube (0,1)^3;
//   owned = the clamped floor anchors (z0, y0) of pos lie in the shard's box
//           [z_lo, z_hi) x [y_lo, y_hi);
//   where owned: s = the global volume's trilinear sample (the arithmetic
//   of ops/sampling.py::sample_trilinear_shard, trilinear.cuh's lerps), then
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
// The entry table (seg_entry_kernel; plain version ops/raycast.py::
// seg_entry_table) walks each ray once per plan and owned box with the
// march's own recurrence and tests, and writes per ray one float4: the
// position after i0 additions and the int32 bits of i0, the first owned step
// (-1: none).  The march's next addition therefore lands bit for bit on the
// first owned sample.  Positions built by repeated addition move
// monotonically along each axis, so do their clamped floor anchors, and the
// owned steps of a ray form one interval: the march runs from i0 until the
// ray leaves the cube, its max_samples or the box, testing each step as the
// walk did, and a ray without owned steps writes the identity at once.
//
// What bounds it on this card: every hit ray samples its whole owned
// interval with no early-out (66.7 owned samples per ray and shard on the
// 16-frame orbit at 256^3), each sample a data-dependent 8-tap gather of
// bytes: a chain of address math, eight loads and seven lerps, whose loads
// the next step cannot issue before the current step's exit tests.  The
// taps come from L1/L2 (the 16.8 MB volume fits L2).
//
// What the design does about it: the entry table, cached on the plan per
// (box, max_samples, device) (parallel/kernel_sharded.py::shard_starts),
// lets a launch do work only for owned steps; the ownership test's anchors
// and fractions feed the sampler directly; slab offsets are 32-bit (the
// wrapper checks the slab is under 2^31 bytes).  A tile's taps are not
// staged in shared memory: on the orbit a 16x8 tile's owned samples spread
// over 40 KB (z-slab) to 197 KB (brick) of texels at the median, too much
// to keep enough blocks per SM, and L1 already serves the repeated taps.

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
constexpr int kThreads = kBlockX * kBlockY;
constexpr float kBigT = 1.0e9f;
constexpr int kNoEntry = -1;

// The owned anchor box [z_lo, z_hi) x [y_lo, y_hi) of a volume of Y rows
// and Z planes: all the entry table reads.
struct Box {
  int Y, Z;
  int z_lo, z_hi, y_lo, y_hi;
};

// One shard: its box, the global row length X and the slab's extents
// (Ez, Ey, X).
struct Shard : Box {
  int X;
  int Ez, Ey;
};

// One axis of a position u on n texels: t = u*n - 0.5, its floor a, and the
// anchor a clamped into [0, n - 1] (in float, as the ownership test and
// ops/raycast.py::shard_owned compute it).
struct Axis {
  float t, a, anchor;
};

__device__ __forceinline__ Axis axis(float u, float n) {
  const float t = u * n - 0.5f;
  const float a = floorf(t);
  return {t, a, fminf(fmaxf(a, 0.0f), n - 1.0f)};
}

__device__ __forceinline__ bool inside(float p0, float p1, float p2) {
  return p0 > 0.0f && p0 < 1.0f && p1 > 0.0f && p1 < 1.0f && p2 > 0.0f && p2 < 1.0f;
}

__device__ __forceinline__ bool owned(const Axis& z, const Axis& y, const Box& box) {
  return z.anchor >= static_cast<float>(box.z_lo) && z.anchor < static_cast<float>(box.z_hi) &&
         y.anchor >= static_cast<float>(box.y_lo) && y.anchor < static_cast<float>(box.y_hi);
}

__device__ __forceinline__ int clampi(int i, int n) { return min(max(i, 0), n - 1); }

// ---------------------------------------------------------------------------
// The entry table.

__global__ void __launch_bounds__(kThreads)
seg_entry_kernel(const float* __restrict__ entry_uv, const float* __restrict__ dir_step,
                 const uint8_t* __restrict__ hit, Box box, int H, int W, int max_samples,
                 float4* __restrict__ starts) {
  const int px = blockIdx.x * kBlockX + threadIdx.x;
  const int py = blockIdx.y * kBlockY + threadIdx.y;
  if (px >= W || py >= H) return;
  const size_t ray = static_cast<size_t>(py) * static_cast<size_t>(W) + static_cast<size_t>(px);
  float4 entry = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(kNoEntry));
  if (hit[ray]) {
    const float fY = static_cast<float>(box.Y);
    const float fZ = static_cast<float>(box.Z);
    float p0 = entry_uv[3 * ray + 0];
    float p1 = entry_uv[3 * ray + 1];
    float p2 = entry_uv[3 * ray + 2];
    const float d0 = dir_step[3 * ray + 0];
    const float d1 = dir_step[3 * ray + 1];
    const float d2 = dir_step[3 * ray + 2];
    for (int i = 0; i < max_samples; ++i) {
      const float q0 = p0 + d0;
      const float q1 = p1 + d1;
      const float q2 = p2 + d2;
      if (!inside(q0, q1, q2)) break;
      if (owned(axis(q2, fZ), axis(q1, fY), box)) {
        entry = make_float4(p0, p1, p2, __int_as_float(i));
        break;
      }
      p0 = q0;
      p1 = q1;
      p2 = q2;
    }
  }
  starts[ray] = entry;
}

// ---------------------------------------------------------------------------
// The march.

__device__ __forceinline__ float tap(const uint8_t* __restrict__ slab, int offset) {
  return static_cast<float>(__ldg(slab + offset)) * (1.0f / 255.0f);
}

// The march body of both kernels: one thread per ray, from its table entry.
template <bool kTF>
__device__ __forceinline__ void seg_march(const float4* __restrict__ starts,
                                          const float* __restrict__ dir_step,
                                          const uint8_t* __restrict__ slab, const Shard& sh,
                                          const float* __restrict__ tf, int H, int W,
                                          int max_samples, float* __restrict__ out) {
  const int px = blockIdx.x * kBlockX + threadIdx.x;
  const int py = blockIdx.y * kBlockY + threadIdx.y;
  if (px >= W || py >= H) return;
  const size_t ray = static_cast<size_t>(py) * static_cast<size_t>(W) + static_cast<size_t>(px);

  const float4 entry = starts[ray];
  const int i0 = __float_as_int(entry.w);
  float c = 0.0f;
  float a = 0.0f;
  float R = 0.0f;
  float P = 0.0f;
  float QP = 0.0f;
  float SG = 0.0f;
  float SB = 0.0f;
  if (i0 != kNoEntry) {
    float K = 0.6f, G = 1.0f, B = 0.0f;
    if constexpr (kTF) {
      K = __ldg(tf + 0);
      G = __ldg(tf + 1);
      B = __ldg(tf + 2);
    }
    const float fX = static_cast<float>(sh.X);
    const float fY = static_cast<float>(sh.Y);
    const float fZ = static_cast<float>(sh.Z);
    const int sy = sh.X;
    const int sz = sh.Ey * sh.X;
    float p0 = entry.x;
    float p1 = entry.y;
    float p2 = entry.z;
    const float d0 = dir_step[3 * ray + 0];
    const float d1 = dir_step[3 * ray + 1];
    const float d2 = dir_step[3 * ray + 2];
    for (int i = i0; i < max_samples; ++i) {
      p0 = p0 + d0;
      p1 = p1 + d1;
      p2 = p2 + d2;
      if (!inside(p0, p1, p2)) break;
      const Axis z = axis(p2, fZ);
      const Axis y = axis(p1, fY);
      if (!owned(z, y, sh)) break;  // past the owned interval

      // the shard sampler's taps from the anchors the test just computed: an
      // owned anchor lies in the slab, and so does its upper tap (check_shard)
      const float tx = p0 * fX - 0.5f;
      const float ax = floorf(tx);
      const int ix = static_cast<int>(ax);
      const int x0 = clampi(ix, sh.X);
      const int x1 = clampi(ix + 1, sh.X);
      const int y0 = (static_cast<int>(y.anchor) - sh.y_lo) * sy;
      const int y1 = min(clampi(static_cast<int>(y.a) + 1, sh.Y) - sh.y_lo, sh.Ey - 1) * sy;
      const int z0 = (static_cast<int>(z.anchor) - sh.z_lo) * sz;
      const int z1 = min(clampi(static_cast<int>(z.a) + 1, sh.Z) - sh.z_lo, sh.Ez - 1) * sz;
      const float s = vrt::trilerp(tap(slab, z0 + y0 + x0), tap(slab, z0 + y0 + x1),
                                   tap(slab, z0 + y1 + x0), tap(slab, z0 + y1 + x1),
                                   tap(slab, z1 + y0 + x0), tap(slab, z1 + y0 + x1),
                                   tap(slab, z1 + y1 + x0), tap(slab, z1 + y1 + x1), tx - ax,
                                   y.t - y.a, z.t - z.a);
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
    }
  }
  const size_t plane = static_cast<size_t>(H) * static_cast<size_t>(W);
  out[0 * plane + ray] = c;
  out[1 * plane + ray] = a;
  out[2 * plane + ray] = i0 != kNoEntry ? static_cast<float>(i0) : kBigT;
  if constexpr (kTF) {
    out[3 * plane + ray] = R;
    out[4 * plane + ray] = P;
    out[5 * plane + ray] = QP;
    out[6 * plane + ray] = SG;
    out[7 * plane + ray] = SB;
  }
}

using MarchKernel = void (*)(const float4*, const float*, const uint8_t*, Shard, const float*,
                             int, int, int, float*);

// B10 asks for ten blocks of 128 threads per SM (at most 48 registers): that
// measured 5 % faster than no floor.  B11 with the same floor measured 4 %
// slower, and with a floor of one block 2 % slower, so it asks for none.
__global__ void __launch_bounds__(kThreads, 10)
seg_march_kernel(const float4* __restrict__ starts, const float* __restrict__ dir_step,
                 const uint8_t* __restrict__ slab, Shard sh, const float* __restrict__ tf, int H,
                 int W, int max_samples, float* __restrict__ out) {
  seg_march<false>(starts, dir_step, slab, sh, tf, H, W, max_samples, out);
}

__global__ void __launch_bounds__(kThreads)
seg_tf_march_kernel(const float4* __restrict__ starts, const float* __restrict__ dir_step,
                    const uint8_t* __restrict__ slab, Shard sh, const float* __restrict__ tf,
                    int H, int W, int max_samples, float* __restrict__ out) {
  seg_march<true>(starts, dir_step, slab, sh, tf, H, W, max_samples, out);
}

dim3 grid_of(int H, int W) {
  return dim3((W + kBlockX - 1) / kBlockX, (H + kBlockY - 1) / kBlockY);
}

int launch(MarchKernel kernel, const void* starts, const void* dir_step, const void* slab,
           const void* tf, int H, int W, int X, int Y, int Z, int z_lo, int z_hi, int y_lo,
           int y_hi, int Ez, int Ey, int max_samples, void* out, void* stream) {
  kernel<<<grid_of(H, W), dim3(kBlockX, kBlockY), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(starts), static_cast<const float*>(dir_step),
      static_cast<const uint8_t*>(slab), Shard{{Y, Z, z_lo, z_hi, y_lo, y_hi}, X, Ez, Ey},
      static_cast<const float*>(tf), H, W, max_samples, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each launch runs on `stream` for an H x W ray image and returns
// cudaGetLastError() (0 on success).  Pointers are device pointers:
// entry_uv and dir_step (H*W*3 f32), hit (H*W u8), starts (H*W float4,
// 16-byte aligned), slab (Ez*Ey*X u8 under 2^31 bytes, x fastest: the global
// rows [z_lo, z_lo + Ez) x [y_lo, y_lo + Ey) of an (X, Y, Z) volume), out (3
// or 8 planes of H*W f32).  The owned anchor box is [z_lo, z_hi) x
// [y_lo, y_hi) in global texel indices.

// The entry table: starts, from the rays alone.
extern "C" int seg_entry_launch(const void* entry_uv, const void* dir_step, const void* hit,
                                int H, int W, int Y, int Z, int z_lo, int z_hi, int y_lo,
                                int y_hi, int max_samples, void* starts, void* stream) {
  seg_entry_kernel<<<grid_of(H, W), dim3(kBlockX, kBlockY), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(entry_uv), static_cast<const float*>(dir_step),
      static_cast<const uint8_t*>(hit), Box{Y, Z, z_lo, z_hi, y_lo, y_hi}, H, W, max_samples,
      static_cast<float4*>(starts));
  return static_cast<int>(cudaGetLastError());
}

// B10: out holds c, alpha, t_first.
extern "C" int seg_march_launch(const void* starts, const void* dir_step, const void* slab, int H,
                                int W, int X, int Y, int Z, int z_lo, int z_hi, int y_lo,
                                int y_hi, int Ez, int Ey, int max_samples, void* out,
                                void* stream) {
  return launch(seg_march_kernel, starts, dir_step, slab, nullptr, H, W, X, Y, Z, z_lo, z_hi,
                y_lo, y_hi, Ez, Ey, max_samples, out, stream);
}

// B11: tf (3 f32: K, G, B); out holds c, alpha, t_first, R, P, QP, SG, SB.
extern "C" int seg_tf_march_launch(const void* starts, const void* dir_step, const void* slab,
                                   const void* tf, int H, int W, int X, int Y, int Z, int z_lo,
                                   int z_hi, int y_lo, int y_hi, int Ez, int Ey, int max_samples,
                                   void* out, void* stream) {
  return launch(seg_tf_march_kernel, starts, dir_step, slab, tf, H, W, X, Y, Z, z_lo, z_hi,
                y_lo, y_hi, Ez, Ey, max_samples, out, stream);
}

extern "C" const char* seg_march_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
