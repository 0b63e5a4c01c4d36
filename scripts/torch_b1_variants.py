"""Design variants of the compositing marches on the card: the fused B1
(``--target b1``, the default) and the pooled B6 (narrow pool) and B7
(pair16 pool) (``--target pool``).

Each variant is the source with a change made to a copy of
``volumerenderer_tpu_torch/csrc/composite_march.cu`` or ``trilinear.cuh``.
B1's: one of the sampler's compile-time choices undone (32-bit voxel
offsets, the wrap fixed at compile time), the tap's clamp as one saturate,
another block shape (so another warp shape), or the next step's taps issued
before this step composites (the positions do not depend on the samples;
only the exit does).  The pool's: one of the slab-pool sampler's choices
undone (32-bit word offsets, the per-ray cursor that reads the slab map only
when the ray's z-block changes, the byte permute and float add that make a
pair16 byte its tap, the narrow pair value split in the float domain by
``truncf``), the texel anchor's float-to-int conversion done by a float add,
or another block shape (the one B1 shares).  With ``--parent DIR`` the
``csrc`` of another tree (for example the parent commit, unpacked by ``git
archive`` under the git-ignored ``build/``) is built and timed beside them
as ``parent``.

All are built with the package's nvcc flags, one nvcc each, all at once,
into the git-ignored ``build/b1_variants/`` (``build/pool_variants/``).
Each is timed on the 16-frame orbit at 1024^2 rays on the 256^3 turbulence
(seed 0), min of 5 after a warm call, in each of the target's cases: B1 as
the main path launches it (float32 taps quantized as read, the transfer in
the epilogue) and on the byte route; B6 and B7 as ``render_pooled``
launches them (the transfer in the epilogue) on the turbulence's pools.
Every case's images are held bit-equal to the source's; the static SASS
instructions of the target's rgb kernels (cuobjdump) and the ptxas report
are printed beside.  Prints one JSON line per variant.

``--ab A B --pairs N`` builds only variants A and B and times them in N
pairs, A then B and B then A in turns, one JSON line per pair and a last
one with each case's median ratio B / A and the pairs in which B was the
slower.

Usage, from the root of a checkout with a CUDA card:
    python3 scripts/torch_b1_variants.py          # every variant of B1
    python3 scripts/torch_b1_variants.py --once   # B1's source, one orbit, for a profiler
    python3 scripts/torch_b1_variants.py --target pool [--parent build/base]
    python3 scripts/torch_b1_variants.py --target pool --ab source map_every_sample --pairs 10
"""
import argparse
import concurrent.futures
import ctypes
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from volumerenderer_tpu_torch import Camera, as_normalized_volume, generate_rays  # noqa: E402
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume  # noqa: E402
from volumerenderer_tpu_torch.ops.cuda import _build  # noqa: E402
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
CM, TRI = "composite_march.cu", "trilinear.cuh"

# B1: the source's two compile-time choices in the sampler, each undone:
# 64-bit voxel offsets (the size test made false at run time) and the wrap a
# run-time test (a comparison the compiler cannot fold); and the tap's clamp
# as one __saturatef (NaN and -0 aside, which both read as 0, the same)
OFFSETS64 = (TRI, "(size_t{1} << 32);\n  if (small && repeat)",
             "(size_t{1} << 32) && X < 0;\n  if (small && repeat)")
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


def block(x, y):
    return (CM, BLOCK, f"constexpr int kBlockX = {x};\nconstexpr int kBlockY = {y};\n")


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


def sass_counts(lib, keep):
    """SASS instructions of each kernel of ``lib`` whose mangled name ``keep``
    admits, by cuobjdump."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True)
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name and line.strip().startswith("/*") and "*/" in line and ";" in line:
            counts[name] += 1
    return {n: c for n, c in counts.items() if keep(n)}


def b1_sass(lib):
    """The composite_march_kernel instantiations that read the float32
    volume and write rgb."""
    return sass_counts(lib, lambda n: "VolumeSamplerIfL" in n and "ELb1EE" in n)


def pool_sass(lib):
    """The pooled composite_march_kernel instantiations that write rgb,
    keyed by pool format and offset type."""
    out = {}
    for n, c in sass_counts(lib, lambda n: "PoolSampler" in n and "Lb1E" in n).items():
        m = re.search(r"PoolFormatE(\d)E(j|m)?E", n)
        fmt = "pair16" if m.group(1) == "0" else "narrow"
        out[f"{fmt}_{ {'j': 'u32', 'm': 'u64'}.get(m.group(2), 'size_t')}"] = c
    return out


def b1_cases(turb, u8):
    """B1's cases: (entry, the data after the rays, the ints after the
    extents: max_samples, repeat, rgb)."""
    return {"fused_f32_rgb": ("composite_march_f32_launch", (turb,),
                              lambda p: (p.max_samples, 0, 1)),
            "byte_route_color": ("composite_march_launch", (u8,),
                                 lambda p: (p.max_samples, 0, 0))}


def pool_cases(turb, u8):
    """B6's and B7's cases: (entry, pool and slab map, the ints after the
    extents: n_slots, max_samples, rgb)."""
    pools = {"narrow": RK.build_slab_pool_narrow(u8), "pair16": RK.build_slab_pool(u8)}
    return {fmt: (f"composite_march_pooled_{fmt}_launch", (pool, smap),
                  lambda p, n=pool.shape[0]: (n, p.max_samples, 1))
            for fmt, (pool, smap) in pools.items()}


TARGETS = {"b1": (B1_VARIANTS, b1_sass, b1_cases), "pool": (POOL_VARIANTS, pool_sass, pool_cases)}


def compile_variant(out, name, edits, csrc_from=None):
    """``csrc/composite_march.cu`` of a copy of ``csrc_from`` (default: the
    package's csrc) with each (file, old, new) of ``edits`` applied, built
    with the package's nvcc flags into ``out/name``.  Returns the library's
    path and the ptxas register lines."""
    csrc = out / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(csrc_from or _build.CSRC_DIR, csrc)
    for file, old, new in edits:
        path = csrc / file
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: the text it changes is not in {file}")
        path.write_text(text.replace(old, new))
    lib = out / name / "libcomposite_march.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                           str(lib), str(csrc / CM)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs = sorted({ln.split(":")[-1].strip() for ln in (proc.stdout + proc.stderr).splitlines()
                   if "registers" in ln})
    return lib, regs


def time_ms(fn, reps=5):
    fn()
    best = math.inf
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
    variants, sass, make_cases = TARGETS[args.target]
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
    cases = make_cases(turb, RK.quantize_u8(turb))

    def build(name, edits, csrc_from):
        lib, regs = compile_variant(out, name, edits, csrc_from)
        fns = {}
        for case, (entry, data, _) in cases.items():
            fn = getattr(ctypes.CDLL(str(lib)), entry)
            # entry_uv, dir_step, hit, the data; H, W, X, Y, Z and three
            # ints; out, alpha, stream
            fn.argtypes = [ctypes.c_void_p] * (3 + len(data)) + [ctypes.c_int] * 8 + \
                [ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
            fns[case] = fn
        return fns, regs, sass(lib)

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: build(kv[0], *kv[1]), jobs.items())))
    plans = []
    for i in range(16):
        a = math.radians(2.0 * i)
        r = generate_rays(Camera(width=W, height=H, position=(0.75 * math.sin(a), 0.0,
                                                               -0.75 * math.cos(a)),
                                 front=(-math.sin(a), 0.0, math.cos(a))), device=dev)
        plans.append(RK.CompositingPlan(r.entry_uv, r.direction, r.hit, (256, 256, 256)))
    outs = [(torch.empty((H, W, 3), device=dev), torch.empty((H, W), device=dev))
            for _ in plans]
    stream = torch.cuda.current_stream(dev).cuda_stream
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()

    def runner(name, case):
        fn, (_, data, ints) = built[name][0][case], cases[case]

        def run():
            for p, (o, al) in zip(plans, outs):
                err = fn(p.entry_uv.data_ptr(), p.dir_step.data_ptr(), p.hit.data_ptr(),
                         *(d.data_ptr() for d in data), H, W, 256, 256, 256, *ints(p),
                         o.data_ptr(), al.data_ptr(), stream)
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
            images = [(o.clone(), al.clone()) for o, al in outs]
            reference.setdefault(case, images)
            if not all(torch.equal(a, b) and torch.equal(c, d)
                       for (a, c), (b, d) in zip(images, reference[case])):
                raise SystemExit(f"variant {name} differs from {next(iter(built))}'s images "
                                 f"({case})")

    if args.ab:
        a, b = args.ab
        ratios = {case: [] for case in cases}
        for i in range(args.pairs):
            order = (a, b) if i % 2 == 0 else (b, a)
            ms = {name: {case: time_ms(runner(name, case)) / 16 for case in cases}
                  for name in order}
            for case in cases:
                ratios[case].append(ms[b][case] / ms[a][case])
            print(json.dumps({"pair": i, "order": order, "ms_per_launch": ms, "gpu": smi}),
                  flush=True)
        print(json.dumps({"ab": [a, b], "pairs": args.pairs, "median_ratio_b_over_a": {
            case: statistics.median(r) for case, r in ratios.items()},
            "pairs_b_slower": {case: sum(x > 1.0 for x in r) for case, r in ratios.items()},
            "sass_rgb": {n: built[n][2] for n in (a, b)}, "gpu": smi}), flush=True)
        return
    for name, (_, regs, counts) in built.items():
        ms = {case: time_ms(runner(name, case)) / 16 for case in cases}
        print(json.dumps({"variant": name, "ms_per_launch": ms, "bit_equal_to_source": True,
                          "ptxas": regs, "sass_rgb": counts, "gpu": smi}), flush=True)


if __name__ == "__main__":
    main()
