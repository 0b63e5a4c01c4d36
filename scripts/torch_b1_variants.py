"""Design variants of the port's kernels on the card: the fused B1
(``--target b1``, the default), the pooled B6 (narrow pool) and B7 (pair16
pool) (``--target pool``), and the isosurface shade, B3 and the pooled shade
on both pools (``--target shade``).

Each variant is the source with a change made to a copy of
``volumerenderer_tpu_torch/csrc/composite_march.cu``, ``iso_shade.cu`` or
``trilinear.cuh``.  B1's: one of the sampler's compile-time choices undone (32-bit voxel
offsets, the wrap fixed at compile time), the tap's clamp as one saturate,
another block shape (so another warp shape), or the next step's taps issued
before this step composites (the positions do not depend on the samples;
only the exit does).  The pool's: one of the slab-pool sampler's choices
undone (32-bit word offsets, the per-ray cursor that reads the slab map only
when the ray's z-block changes, the byte permute and float add that make a
pair16 byte its tap, the narrow pair value split in the float domain by
``truncf``), the texel anchor's float-to-int conversion done by a float add,
or another block shape (the one B1 shares).  The shade's (each on the
route ``render`` launches, from the march's near bracket): the bisection's
four midpoints taken from the 3x3x3 voxels around the bracket, loaded at
once (the dense sampler; a gather where the bracket spans more), the hit
rays of each block compacted into a shared list before they are shaded,
the bisection's loop unrolled, or another block shape.  With ``--parent
DIR`` the ``csrc`` of another tree (for example the parent commit, unpacked
by ``git archive`` under the git-ignored ``build/``) is built and timed
beside them as ``parent`` (``b1`` and ``pool``, a tree whose compositing
entry points take the arguments this one's take: the shade's entry points
differ).

All are built with the package's nvcc flags, one nvcc each, all at once,
into the git-ignored ``build/<target>_variants/``.  Each is timed on the
16-frame orbit at 1024^2 rays on the 256^3 turbulence (seed 0), min of 5
after a warm call, in each of the target's cases: B1 as the main path
launches it (float32 taps quantized as read, the transfer in the epilogue)
and on the byte route; B6 and B7 as ``render_pooled`` launches them (the
transfer in the epilogue) on the turbulence's pools; B3 and the pooled
shade on both pools from the near bracket of the package's march at the
volume's median, and B3 in GL_REPEAT at 128^2.  Every case's images are held
bit-equal to the source's; the static SASS instructions of the target's
kernels (cuobjdump; for the shade also its floors, FRND, and global loads,
LDG, which show whether nvcc shares the normal taps' texel math) and the
ptxas report are printed beside.  Prints one JSON line per variant.

``--ab A B --pairs N`` builds only variants A and B and times them in N
pairs, A then B and B then A in turns, one JSON line per pair and a last
one with each case's median ratio B / A and the pairs in which B was the
slower.

Usage, from the root of a checkout with a CUDA card:
    python3 scripts/torch_b1_variants.py          # every variant of B1
    python3 scripts/torch_b1_variants.py --once   # B1's source, one orbit, for a profiler
    python3 scripts/torch_b1_variants.py --target pool [--parent build/base]
    python3 scripts/torch_b1_variants.py --target pool --ab source map_every_sample --pairs 10
    python3 scripts/torch_b1_variants.py --target shade
"""
import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays  # noqa: E402
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume  # noqa: E402
from volumerenderer_tpu_torch.ops.cuda import _build  # noqa: E402
from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK  # noqa: E402
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK  # noqa: E402

W = H = 1024
LOOP = """    for (int i = 0; i < max_samples; ++i) {
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
"""
# the same steps, the same additions; step i+1's taps are read before step i
# composites (a tap outside the cube reads a clamped index, and is dropped)
PREFETCH = """    p0 = p0 + d0;
    p1 = p1 + d1;
    p2 = p2 + d2;
    bool inside = max_samples > 0 &&
                  (p0 > 0.0f && p0 < 1.0f && p1 > 0.0f && p1 < 1.0f && p2 > 0.0f && p2 < 1.0f);
    float s = sample(p0, p1, p2);
    for (int i = 1; inside; ++i) {
      const float q0 = p0 + d0;
      const float q1 = p1 + d1;
      const float q2 = p2 + d2;
      const float s_next = sample(q0, q1, q2);
      const float pa = s - s * a;
      c = c + pa * s;
      a = a + pa * 0.6f;
      if (!(a <= 0.99f) || i >= max_samples) break;
      p0 = q0;
      p1 = q1;
      p2 = q2;
      inside = p0 > 0.0f && p0 < 1.0f && p1 > 0.0f && p1 < 1.0f && p2 > 0.0f && p2 < 1.0f;
      s = s_next;
    }
"""

BLOCK = "constexpr int kBlockX = 16;\nconstexpr int kBlockY = 8;\n"
CM, TRI, SHADE = "composite_march.cu", "trilinear.cuh", "iso_shade.cu"

# B1: the source's two compile-time choices in the sampler, each undone:
# 64-bit voxel offsets (the size test made false at run time) and the wrap a
# run-time test (a comparison the compiler cannot fold); and the tap's clamp
# as one __saturatef (NaN and -0 aside, which both read as 0, the same)
OFFSETS64 = (TRI, "(size_t{1} << 32);\n  if (small)",
             "(size_t{1} << 32) && X < 0;\n  if (small)")
SATURATE = (TRI, "rintf(fminf(fmaxf(__ldg(vol + offset), 0.0f), 1.0f) * 255.0f)",
            "rintf(__saturatef(__ldg(vol + offset)) * 255.0f)")
RUNTIME_WRAP = (TRI, "return sample_trilinear<Offset>(vol, u, v, w, X, Y, Z, kRepeat);",
                "return sample_trilinear<Offset>(vol, u, v, w, X, Y, Z, kRepeat == (X > 0));")

# the pool: 64-bit word offsets (the size test made false at run time)
POOL_OFFSETS64 = (TRI, "if (static_cast<size_t>(n_slots) * 16 * plane <= (size_t{1} << 32)) {",
                  "if (static_cast<size_t>(n_slots) * 16 * plane <= (size_t{1} << 32) && X < 0) {")
# the slab map read on every sample (the cursor's test dropped)
MAP_EVERY_SAMPLE = (TRI, "    if (b != block) {\n", "    {\n")
# a pair16 byte to its tap by shift, mask and int-to-float conversion
SHIFT_I2F = (TRI, "  return (__uint_as_float(__byte_perm(word, 0x4B000000u, selector)) - "
                  "8388608.0f) *\n         (1.0f / 255.0f);",
             "  return static_cast<float>((word >> ((selector & 3u) * 8u)) & 255u) * "
             "(1.0f / 255.0f);")
NARROW_SPLIT = """    const float p = __ldg(static_cast<const float*>(pool) + offset);
    const float h = truncf(p * (1.0f / 256.0f));
    c0 = h * kInv255;
    c1 = low_edge ? c0 : (p - h * 256.0f) * kInv255;
"""
# the narrow pair value to bits (p + 2^23, exact: the low 16 bits are p) and
# its bytes by the pair16 byte permute (the pair in the low half)
NARROW_BITS = (TRI, NARROW_SPLIT, """    const uint32_t word =
        __float_as_uint(__ldg(static_cast<const float*>(pool) + offset) + 8388608.0f);
    c0 = pool_tap(word, 0x7441u);
    c1 = pool_tap(word, low_edge ? 0x7441u : 0x7440u);
""")
# the narrow pair value to bits by a float-to-int conversion
NARROW_F2I = (TRI, NARROW_SPLIT, """    const auto word =
        static_cast<uint32_t>(__ldg(static_cast<const float*>(pool) + offset));
    c0 = pool_tap(word, 0x7441u);
    c1 = pool_tap(word, low_edge ? 0x7441u : 0x7440u);
""")
# the pair16 pair as one value (two bytes and 0x4B by one byte permute, less
# 2^23) split as the narrow value is
PAIR16_SPLIT = (TRI, """    c0 = pool_tap(word, lo + 1);
    c1 = pool_tap(word, low_edge ? lo + 1 : lo);
""", """    const float p =
        __uint_as_float(__byte_perm(word, 0x4B000000u, (lo & 2u) ? 0x7432u : 0x7410u)) -
        8388608.0f;
    const float h = truncf(p * (1.0f / 256.0f));
    c0 = h * kInv255;
    c1 = low_edge ? c0 : (p - h * 256.0f) * kInv255;
""")
# the texel anchor as int by a float add (floor(t) + 1.5 * 2^23, exact for
# |floor(t)| < 2^22) in place of the float-to-int conversion (every sampler)
TEXEL_MAGIC = (TRI, "  return static_cast<int>(i);",
               "  return __float_as_int(i + 12582912.0f) - 0x4B400000;")


def block(x, y, file=CM):
    return (file, BLOCK, f"constexpr int kBlockX = {x};\nconstexpr int kBlockY = {y};\n")


# the shade: (a) the bisection from the 3x3x3 box of voxels around the
# bracket, every tap of the four midpoints taken from registers (the dense
# sampler; a ray whose bracket's anchors span more than two texels on an
# axis, or cross a wrap, gathers as the source does)
BISECTION = """  for (int k = 0; k < 4; ++k) {
    const float m0 = (r0 + l0) * 0.5f;
    const float m1 = (r1 + l1) * 0.5f;
    const float m2 = (r2 + l2) * 0.5f;
    if (sample(m0, m1, m2) < iso) {
      l0 = m0; l1 = m1; l2 = m2;
    } else {
      r0 = m0; r1 = m1; r2 = m2;
    }
  }
"""
BOX_HELPERS = """// the texel anchor and fraction of coordinate u as the dense sampler takes
// them (GL_REPEAT: u less its floor first)
template <bool kRepeat>
__device__ __forceinline__ int box_texel(float u, int n, float& frac) {
  if (kRepeat) u = u - floorf(u);
  return vrt::texel(u, n, frac);
}

// the bisection of [l, r] from the 27 voxels of anchors lo..lo+2 per axis,
// if every midpoint's anchors lie in them; else false and nothing changed
template <class T, bool kRepeat, class Offset>
__device__ __forceinline__ bool box_bisect(const vrt::VolumeSampler<T, kRepeat, Offset>& s,
                                           float& l0, float& l1, float& l2, float& r0,
                                           float& r1, float& r2, float iso) {
  const float lw[3] = {l0, l1, l2}, rw[3] = {r0, r1, r2};
  const int n[3] = {s.X, s.Y, s.Z};
  const Offset stride[3] = {Offset(1), static_cast<Offset>(s.X),
                            static_cast<Offset>(s.X) * static_cast<Offset>(s.Y)};
  int lo[3];
  Offset off[3][3];
  bool ok = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (kRepeat) ok = ok && floorf(lw[k]) == floorf(rw[k]);
    float f;
    const int a = box_texel<kRepeat>(lw[k], n[k], f);
    const int b = box_texel<kRepeat>(rw[k], n[k], f);
    lo[k] = min(a, b);
    ok = ok && max(a, b) - lo[k] <= 1;
#pragma unroll
    for (int j = 0; j < 3; ++j) off[k][j] = vrt::wrapped(lo[k] + j, n[k], kRepeat, stride[k]);
  }
  if (!ok) return false;
  float v[3][3][3];
#pragma unroll
  for (int z = 0; z < 3; ++z)
#pragma unroll
    for (int y = 0; y < 3; ++y)
#pragma unroll
      for (int x = 0; x < 3; ++x) v[z][y][x] = vrt::tap(s.vol, off[2][z] + off[1][y] + off[0][x]);
  for (int it = 0; it < 4; ++it) {
    const float m0 = (r0 + l0) * 0.5f;
    const float m1 = (r1 + l1) * 0.5f;
    const float m2 = (r2 + l2) * 0.5f;
    float fx, fy, fz;
    const bool sx = box_texel<kRepeat>(m0, s.X, fx) != lo[0];
    const bool sy = box_texel<kRepeat>(m1, s.Y, fy) != lo[1];
    const bool sz = box_texel<kRepeat>(m2, s.Z, fz) != lo[2];
    float c[2][2][2];
#pragma unroll
    for (int z = 0; z < 2; ++z)
#pragma unroll
      for (int y = 0; y < 2; ++y)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float row0 = sx ? v[z][y][x + 1] : v[z][y][x];
          const float row1 = sx ? v[z][y + 1][x + 1] : v[z][y + 1][x];
          const float col0 = sy ? row1 : row0;
          const float row2 = sx ? v[z + 1][y][x + 1] : v[z + 1][y][x];
          const float row3 = sx ? v[z + 1][y + 1][x + 1] : v[z + 1][y + 1][x];
          const float col1 = sy ? row3 : row2;
          c[z][y][x] = sz ? col1 : col0;
        }
    const float sm = vrt::trilerp(c[0][0][0], c[0][0][1], c[0][1][0], c[0][1][1], c[1][0][0],
                                  c[1][0][1], c[1][1][0], c[1][1][1], fx, fy, fz);
    if (sm < iso) {
      l0 = m0; l1 = m1; l2 = m2;
    } else {
      r0 = m0; r1 = m1; r2 = m2;
    }
  }
  return true;
}

template <class S>
__device__ __forceinline__ bool box_bisect(const S&, float&, float&, float&, float&, float&,
                                           float&, float) {
  return false;
}

// The color of the hit ray"""
BOX_BISECTION = [(SHADE, "// The color of the hit ray", BOX_HELPERS),
                 (SHADE, BISECTION, "  if (!box_bisect(sample, l0, l1, l2, r0, r1, r2, iso)) {\n" +
                  BISECTION + "  }\n")]
# (c) the hit rays of each block compacted into a shared list (a ballot per
# warp, one shared add), then shaded by the block's first threads in turn
KERNEL_BODY = """  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  if (px >= W || py >= H) return;
  const size_t ray = static_cast<size_t>(py) * static_cast<size_t>(W) + static_cast<size_t>(px);
  float r = 1.0f, g = 1.0f, b = 1.0f;
  if (found[ray]) {
    shade_hit<kFromNear>(ray, entry_uv, dir_step, direction, t_hit, near, sample, iso, r, g, b);
  }
  rgb[3 * ray + 0] = r;
  rgb[3 * ray + 1] = g;
  rgb[3 * ray + 2] = b;
"""
COMPACT_BODY = """  __shared__ int list[kBlockX * kBlockY];
  __shared__ int count;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid == 0) count = 0;
  __syncthreads();
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y * blockDim.y + threadIdx.y;
  const bool inside = px < W && py < H;
  const size_t ray = static_cast<size_t>(py) * static_cast<size_t>(W) + static_cast<size_t>(px);
  const bool hit = inside && found[ray];
  if (inside && !hit) {
    rgb[3 * ray + 0] = 1.0f;
    rgb[3 * ray + 1] = 1.0f;
    rgb[3 * ray + 2] = 1.0f;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, hit);
  const int lane = tid & 31;
  int base = 0;
  if (lane == 0 && ballot) base = atomicAdd(&count, __popc(ballot));
  base = __shfl_sync(0xffffffffu, base, 0);
  if (hit) list[base + __popc(ballot & ((1u << lane) - 1u))] = tid;
  __syncthreads();
  for (int k = tid; k < count; k += kBlockX * kBlockY) {
    const int t = list[k];
    const size_t hray = static_cast<size_t>(blockIdx.y * blockDim.y + t / kBlockX) *
                            static_cast<size_t>(W) +
                        static_cast<size_t>(blockIdx.x * blockDim.x + t % kBlockX);
    float r, g, b;
    shade_hit<kFromNear>(hray, entry_uv, dir_step, direction, t_hit, near, sample, iso, r, g, b);
    rgb[3 * hray + 0] = r;
    rgb[3 * hray + 1] = g;
    rgb[3 * hray + 2] = b;
  }
"""
COMPACT = (SHADE, KERNEL_BODY, COMPACT_BODY)


B1_VARIANTS = {"source": [], "offsets64": [OFFSETS64], "runtime_wrap": [RUNTIME_WRAP],
               "offsets64_runtime_wrap": [OFFSETS64, RUNTIME_WRAP], "saturate": [SATURATE],
               "prefetch": [(CM, LOOP, PREFETCH)], "block32x4": [block(32, 4)],
               "block8x8": [block(8, 8)], "block4x32": [block(4, 32)]}
POOL_VARIANTS = {"source": [], "offsets64": [POOL_OFFSETS64],
                 "map_every_sample": [MAP_EVERY_SAMPLE], "shift_i2f": [SHIFT_I2F],
                 "narrow_bits": [NARROW_BITS], "narrow_f2i": [NARROW_F2I],
                 "pair16_split": [PAIR16_SPLIT],
                 # the four choices undone together: the earlier sampler's costs
                 "all_undone": [POOL_OFFSETS64, MAP_EVERY_SAMPLE, SHIFT_I2F, NARROW_F2I],
                 "texel_magic": [TEXEL_MAGIC], "block8x8": [block(8, 8)],
                 "block32x4": [block(32, 4)]}
# the bisection's four steps unrolled (nvcc keeps the loop)
UNROLL = (SHADE, BISECTION, "#pragma unroll\n" + BISECTION)
SHADE_VARIANTS = {"source": [], "box_bisection": BOX_BISECTION, "compact": [COMPACT],
                  "unroll_bisection": [UNROLL],
                  "box_bisection_compact": BOX_BISECTION + [COMPACT],
                  "block8x8": [block(8, 8, SHADE)], "block32x4": [block(32, 4, SHADE)],
                  "block8x16": [block(8, 16, SHADE)]}


def sass_ops(lib, keep):
    """The SASS instructions of each kernel of ``lib`` whose mangled name
    ``keep`` admits, by cuobjdump: {name: {opcode: count}}."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True)
    ops, name = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ops[name] = {}
        elif name and line.strip().startswith("/*") and "*/" in line and ";" in line:
            words = line.split("*/", 1)[1].split()
            op = words[1] if words[0].startswith("@") else words[0]
            ops[name][op] = ops[name].get(op, 0) + 1
    return {n: c for n, c in ops.items() if keep(n)}


def sass_counts(lib, keep):
    """The number of SASS instructions of each kernel ``keep`` admits."""
    return {n: sum(c.values()) for n, c in sass_ops(lib, keep).items()}


def b1_sass(lib):
    """The composite_march_kernel instantiations that read the float32
    volume."""
    return sass_counts(lib, lambda n: "composite_march_kernel" in n and "VolumeSamplerIfL" in n)


def pool_sass(lib):
    """The pooled composite_march_kernel instantiations, keyed by pool
    format and offset type."""
    out = {}
    for n, c in sass_counts(lib, lambda n: "composite_march_kernel" in n
                            and "PoolSampler" in n).items():
        m = re.search(r"PoolFormatE(\d)E(j|m)?E", n)
        fmt = "pair16" if m.group(1) == "0" else "narrow"
        out[f"{fmt}_{ {'j': 'u32', 'm': 'u64'}.get(m.group(2), 'size_t')}"] = c
    return out


def shade_sass(lib):
    """The shade's instantiations from near with 32-bit offsets (dense clamp
    and repeat, each pool): all instructions, floors (FRND) and global loads
    (LDG)."""
    out = {}
    for n, c in sass_ops(lib, lambda n: "iso_shade_kernel" in n and "ILb1E" in n).items():
        m = re.search(r"VolumeSamplerIhLb(\d)EjE|PoolFormatE(\d)EjE", n)
        if not m:
            continue
        key = ("repeat" if m.group(1) == "1" else "clamp") if m.group(1) is not None else \
            ("pair16" if m.group(2) == "0" else "narrow")
        out[key] = {"all": sum(c.values()),
                    "FRND": sum(v for k, v in c.items() if k.startswith("FRND")),
                    "LDG": sum(v for k, v in c.items() if k.startswith("LDG"))}
    return out


@dataclasses.dataclass
class Case:
    """One launch of a variant over the orbit: its C entry point, that
    entry's ctypes argument types (pointers, ints and floats as the source
    declares them, the stream last), the arguments of each launch (the
    stream appended), the images they write, compared between variants, and
    the tensors those pointers point into, kept alive with the case."""
    entry: str
    argtypes: list
    args: list
    images: list
    keep: list


def _ptrs(*tensors):
    return [None if x is None else x.data_ptr() for x in tensors]


P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def b1_cases(dev, turb, u8, rays):
    """B1 as the main path launches it (the float32 volume) and on the byte
    route, unbound, each writing rgb."""
    plans = [RK.CompositingPlan(r.entry_uv, r.direction, r.hit, (256, 256, 256)) for r in rays]
    cases = {}
    for case, entry, vol in (("fused_f32_rgb", "composite_march_f32_launch", turb),
                             ("byte_route_rgb", "composite_march_launch", u8)):
        outs = [(torch.empty((H, W, 3), device=dev), torch.empty((H, W), device=dev))
                for _ in plans]
        # entry_uv, dir_step, hit, vol, grid; H, W, X, Y, Z, max_samples, repeat; out, alpha
        cases[case] = Case(entry, [P] * 5 + [I] * 7 + [P] * 3,
                           [_ptrs(p.entry_uv, p.dir_step, p.hit, vol, None) +
                            [H, W, 256, 256, 256, p.max_samples, 0] + _ptrs(o, a)
                            for p, (o, a) in zip(plans, outs)],
                           [x for pair in outs for x in pair], [plans, vol])
    return cases


def pool_cases(dev, turb, u8, rays):
    """B6 and B7 as render_pooled launches them (rgb in the epilogue)."""
    plans = [RK.CompositingPlan(r.entry_uv, r.direction, r.hit, (256, 256, 256)) for r in rays]
    cases = {}
    for fmt, (pool, smap) in (("narrow", RK.build_slab_pool_narrow(u8)),
                              ("pair16", RK.build_slab_pool(u8))):
        outs = [(torch.empty((H, W, 3), device=dev), torch.empty((H, W), device=dev))
                for _ in plans]
        # entry_uv, dir_step, hit, pool, slab_map, grid; H, W, X, Y, Z, n_slots,
        # max_samples; out, alpha
        cases[fmt] = Case(f"composite_march_pooled_{fmt}_launch", [P] * 6 + [I] * 7 + [P] * 3,
                          [_ptrs(p.entry_uv, p.dir_step, p.hit, pool, smap, None) +
                           [H, W, 256, 256, 256, int(pool.shape[0]), p.max_samples] +
                           _ptrs(o, a) for p, (o, a) in zip(plans, outs)],
                          [x for pair in outs for x in pair], [plans, pool, smap])
    return cases


def shade_cases(dev, turb, u8, rays):
    """B3 and the pooled shade on both pools as render and render_pooled
    launch them, from the near bracket of the package's march at the
    volume's median; B3 in GL_REPEAT on a 128^2 frame beside."""
    iso = IK.volume_median(turb)
    plans = [IK.IsosurfacePlan(r.entry_uv, r.direction, r.hit, (256, 256, 256)) for r in rays]
    r128 = generate_rays(Camera(width=128, height=128, position=(0.375, 0.0, -0.65),
                                front=(-0.5, 0.0, 0.866)), device=dev)
    repeat = IK.IsosurfacePlan(r128.entry_uv, r128.direction, r128.hit, (256, 256, 256),
                               wrap="repeat")

    def hits(p):
        return IK.iso_march_cuda(u8, p.entry_uv, p.dir_step, p.hit, iso, wrap=p.wrap,
                                 with_near=True)

    def shade(p, data, n_ints):
        f, _, near = hits(p)
        h, w = p.shape
        rgb = torch.empty((h, w, 3), device=dev)
        # entry_uv, dir_step, direction, found, t_hit, near, the data; H, W, X, Y, Z and
        # the ints; iso; rgb
        return (_ptrs(p.entry_uv, p.dir_step, p.direction, f.view(torch.uint8), None, near,
                      *data) + [h, w, 256, 256, 256, *n_ints, float(iso)] + _ptrs(rgb), rgb,
                [p, f, near, *data])

    def case(entry, data, n_ints, on):
        runs = [shade(p, data, n_ints) for p in on]
        return Case(entry, [P] * (6 + len(data)) + [I] * (5 + len(n_ints)) + [F, P, P],
                    [a for a, _, _ in runs], [rgb for _, rgb, _ in runs],
                    [k for _, _, k in runs])

    cases = {"b3": case("iso_shade_launch", (u8,), (0,), plans),
             "b3_repeat_128": case("iso_shade_launch", (u8,), (1,), [repeat] * 16)}
    for fmt, (pool, smap) in (("narrow", RK.build_slab_pool_narrow(u8)),
                              ("pair16", RK.build_slab_pool(u8))):
        cases[f"pooled_{fmt}"] = case(f"iso_shade_pooled_{fmt}_launch", (pool, smap),
                                      (int(pool.shape[0]),), plans)
    return cases


# target: (variants, SASS counts, cases, the source built)
TARGETS = {"b1": (B1_VARIANTS, b1_sass, b1_cases, CM),
           "pool": (POOL_VARIANTS, pool_sass, pool_cases, CM),
           "shade": (SHADE_VARIANTS, shade_sass, shade_cases, SHADE)}


def compile_variant(out, name, edits, source, csrc_from=None):
    """``csrc/<source>`` of a copy of ``csrc_from`` (default: the package's
    csrc) with each (file, old, new) of ``edits`` applied, built with the
    package's nvcc flags into ``out/name``.  Returns the library's path and
    the ptxas register lines."""
    csrc = out / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(csrc_from or _build.CSRC_DIR, csrc)
    for file, old, new in edits:
        path = csrc / file
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: the text it changes is not in {file}")
        path.write_text(text.replace(old, new))
    lib = out / name / f"lib{Path(source).stem}.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                           str(lib), str(csrc / source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs = sorted({ln.split(":")[-1].strip() for ln in (proc.stdout + proc.stderr).splitlines()
                   if "registers" in ln})
    return lib, regs


def sleep_cycles_per_ms():
    """The clock cycles ``torch.cuda._sleep`` spins per ms on this card."""
    if not hasattr(sleep_cycles_per_ms, "rate"):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        torch.cuda._sleep(1_000_000)
        e.record()
        e.synchronize()
        sleep_cycles_per_ms.rate = 1_000_000 / s.elapsed_time(e)
    return sleep_cycles_per_ms.rate


def time_ms(fn, reps=5):
    """Min over ``reps`` after a warm call, by CUDA events; the card first
    spins for twice the warm call's host time (at most 50 ms), so that the
    host has queued the launches before the start event: a kernel shorter
    than its wrapper's host cost is timed on the card."""
    t0 = time.perf_counter()
    fn()
    spin_ms = min(2e3 * (time.perf_counter() - t0), 50.0)
    best = math.inf
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * sleep_cycles_per_ms()))
        s.record()
        fn()
        e.record()
        e.synchronize()
        best = min(best, s.elapsed_time(e))
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", choices=TARGETS, default="b1")
    ap.add_argument("--once", action="store_true", help="the source, one orbit, for a profiler")
    ap.add_argument("--parent", type=Path, help="a tree whose csrc is timed as 'parent'")
    ap.add_argument("--ab", nargs=2, metavar=("A", "B"), help="time only A and B, in pairs")
    ap.add_argument("--pairs", type=int, default=10)
    args = ap.parse_args()
    variants, sass, make_cases, source = TARGETS[args.target]
    if args.parent and args.target == "shade":
        ap.error("--parent: the parent's shade has other entry points; time it with "
                 "scripts/torch_kernel_ab.py")
    out = ROOT / "build" / f"{args.target}_variants"
    out.mkdir(parents=True, exist_ok=True)
    jobs = {name: (edits, None) for name, edits in variants.items()}
    if args.parent:
        jobs["parent"] = ([], args.parent.resolve() / "volumerenderer_tpu_torch" / "csrc")
    if args.once:
        jobs = {"source": jobs["source"]}
    elif args.ab:
        jobs = {name: jobs[name] for name in args.ab}

    dev = torch.device("cuda", 0)
    turb = as_normalized_volume(turbulence_volume((256, 256, 256), seed=0), device=dev)
    rays = []
    for i in range(16):
        a = math.radians(2.0 * i)
        rays.append(generate_rays(Camera(width=W, height=H, position=(0.75 * math.sin(a), 0.0,
                                                                      -0.75 * math.cos(a)),
                                         front=(-math.sin(a), 0.0, math.cos(a))), device=dev))
    cases = make_cases(dev, turb, RK.quantize_u8(turb), rays)

    def build(name, edits, csrc_from):
        lib, regs = compile_variant(out, name, edits, source, csrc_from)
        fns = {}
        for case, c in cases.items():
            fn = getattr(ctypes.CDLL(str(lib)), c.entry)
            fn.argtypes = c.argtypes
            fn.restype = ctypes.c_int
            fns[case] = fn
        return fns, regs, sass(lib)

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    stream = torch.cuda.current_stream(dev).cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()

    def runner(name, case):
        fn, c = built[name][0][case], cases[case]

        def run():
            for a in c.args:
                err = fn(*a, stream)
                if err:
                    raise RuntimeError(f"variant {name}: CUDA error {err}")
        return run

    # each variant's images, every case, held bit-equal to the first built's
    # (the source's, or A's)
    reference = {}
    for name in built:
        for case in cases:
            runner(name, case)()
            torch.cuda.synchronize()
            if args.once:  # one orbit, for a profiler
                return
            images = [x.clone() for x in cases[case].images]
            reference.setdefault(case, images)
            if not all(torch.equal(a, b) for a, b in zip(images, reference[case])):
                raise SystemExit(f"variant {name} differs from {next(iter(built))}'s images "
                                 f"({case})")

    def per_launch(name, case):
        return time_ms(runner(name, case)) / len(cases[case].args)

    if args.ab:
        a, b = args.ab
        ratios = {case: [] for case in cases}
        for i in range(args.pairs):
            order = (a, b) if i % 2 == 0 else (b, a)
            ms = {name: {case: per_launch(name, case) for case in cases} for name in order}
            for case in cases:
                ratios[case].append(ms[b][case] / ms[a][case])
            print(json.dumps({"pair": i, "order": order, "ms_per_launch": ms, "gpu": smi}),
                  flush=True)
        print(json.dumps({"ab": [a, b], "pairs": args.pairs, "median_ratio_b_over_a": {
            case: statistics.median(r) for case, r in ratios.items()},
            "pairs_b_slower": {case: sum(x > 1.0 for x in r) for case, r in ratios.items()},
            "sass": {n: built[n][2] for n in (a, b)}, "gpu": smi}), flush=True)
        return
    for name, (_, regs, counts) in built.items():
        ms = {case: per_launch(name, case) for case in cases}
        print(json.dumps({"variant": name, "ms_per_launch": ms, "bit_equal_to_source": True,
                          "ptxas": regs, "sass": counts, "gpu": smi}), flush=True)


if __name__ == "__main__":
    main()
