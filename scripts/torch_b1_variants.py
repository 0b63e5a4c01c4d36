"""Design variants of the fused compositing march B1 on the card.

Each variant is the source with a change made to a copy of
``volumerenderer_tpu_torch/csrc/composite_march.cu`` or ``trilinear.cuh``:
one of the sampler's compile-time choices undone (32-bit voxel offsets, the
wrap fixed at compile time), the tap's clamp as one saturate, another block
shape (so another warp shape), or the next step's taps issued before this
step composites (the positions do not depend on the samples; only the exit
does).  All variants are built with the package's nvcc flags, one nvcc
each, all at once, into the git-ignored ``build/b1_variants/``.  Each is
timed on the 16-frame orbit at 1024^2 rays on the 256^3 turbulence (seed
0), min of 5 after a warm call, as the main path launches it (float32 taps
quantized as read, the transfer in the epilogue) and on the byte route, and
its images are held bit-equal to the source's; the SASS instructions of its
float32, rgb kernels (cuobjdump) are printed beside.  Prints one JSON line
per variant.

Usage, from the root of a checkout with a CUDA card:
    python3 scripts/torch_b1_variants.py          # every variant
    python3 scripts/torch_b1_variants.py --once   # the source, one orbit, for a profiler
"""
import concurrent.futures
import ctypes
import json
import math
import shutil
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

OUT = ROOT / "build" / "b1_variants"
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
# the source's two compile-time choices in the sampler, each undone: 64-bit
# voxel offsets (the size test made false at run time) and the wrap a
# run-time test (a comparison the compiler cannot fold); and the tap's clamp
# as one __saturatef (NaN and -0 aside, which both read as 0, the same)
OFFSETS64 = (TRI, "(size_t{1} << 32);\n  if (small && repeat)",
             "(size_t{1} << 32) && X < 0;\n  if (small && repeat)")
SATURATE = (TRI, "rintf(fminf(fmaxf(__ldg(vol + offset), 0.0f), 1.0f) * 255.0f)",
            "rintf(__saturatef(__ldg(vol + offset)) * 255.0f)")
RUNTIME_WRAP = (TRI, "return sample_trilinear<Offset>(vol, u, v, w, X, Y, Z, kRepeat);",
                "return sample_trilinear<Offset>(vol, u, v, w, X, Y, Z, kRepeat == (X > 0));")


def block(x, y):
    return (CM, BLOCK, f"constexpr int kBlockX = {x};\nconstexpr int kBlockY = {y};\n")


VARIANTS = {"source": [], "offsets64": [OFFSETS64], "runtime_wrap": [RUNTIME_WRAP],
            "offsets64_runtime_wrap": [OFFSETS64, RUNTIME_WRAP], "saturate": [SATURATE],
            "prefetch": [(CM, LOOP, PREFETCH)], "block32x4": [block(32, 4)],
            "block8x8": [block(8, 8)], "block4x32": [block(4, 32)]}


def sass_counts(lib):
    """SASS instructions of each composite_march_kernel instantiation that
    reads the float32 volume and writes rgb, by cuobjdump."""
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True)
    counts, name = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name and line.strip().startswith("/*") and "*/" in line and ";" in line:
            counts[name] += 1
    return {n: c for n, c in counts.items() if "VolumeSamplerIfL" in n and "ELb1EE" in n}


def build(name, edits):
    csrc = OUT / name / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, csrc)
    src = csrc / "composite_march.cu"
    for file, old, new in edits:
        path = csrc / file
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name}: the text it changes is not in {file}")
        path.write_text(text.replace(old, new))
    lib = OUT / name / "libcomposite_march.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs = sorted({ln.split(":")[-1].strip() for ln in (proc.stdout + proc.stderr).splitlines()
                   if "registers" in ln})
    fns = {"sass": sass_counts(lib)}
    for entry in ("composite_march_launch", "composite_march_f32_launch"):
        fn = getattr(ctypes.CDLL(str(lib)), entry)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
        fns[entry] = fn
    return fns, regs


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
    dev = torch.device("cuda", 0)
    OUT.mkdir(parents=True, exist_ok=True)
    variants = {"source": []} if "--once" in sys.argv else VARIANTS
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = dict(zip(variants, pool.map(lambda kv: build(*kv), variants.items())))
    turb = as_normalized_volume(turbulence_volume((256, 256, 256), seed=0), device=dev)
    u8 = RK.quantize_u8(turb)
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
    reference = None
    for name, (fns, regs) in built.items():
        def run(entry, vol, rgb):
            for p, (o, al) in zip(plans, outs):
                err = fns[entry](p.entry_uv.data_ptr(), p.dir_step.data_ptr(), p.hit.data_ptr(),
                                 vol.data_ptr(), H, W, 256, 256, 256, p.max_samples, 0, rgb,
                                 o.data_ptr(), al.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"variant {name}: CUDA error {err}")

        run("composite_march_f32_launch", turb, 1)
        torch.cuda.synchronize()
        if "--once" in sys.argv:  # one orbit, for a profiler
            return
        images = [(o.clone(), al.clone()) for o, al in outs]
        if reference is None:
            reference = images
        equal = all(torch.equal(a, b) and torch.equal(c, d)
                    for (a, c), (b, d) in zip(images, reference))
        ms = {"fused_f32_rgb": time_ms(lambda: run("composite_march_f32_launch", turb, 1)) / 16,
              "byte_route_color": time_ms(lambda: run("composite_march_launch", u8, 0)) / 16}
        print(json.dumps({"variant": name, "ms_per_launch": ms, "bit_equal_to_source": equal,
                          "ptxas": regs, "sass_f32_rgb": fns["sass"], "gpu": smi}), flush=True)
        if not equal:
            raise SystemExit(f"variant {name} differs from the source's images")


if __name__ == "__main__":
    main()
