"""Per-launch times of the port's kernels that share csrc/trilinear.cuh (B1,
B2 at the volume's median, B3, B4, B5, the pooled marches B6–B9) and of the
segment marches (B10, B11) on both volume-sharded layouts (z-slabs n = 4,
bricks (2, 2, 1)), over the 16-frame orbit at 1024^2 rays on the 256^3
turbulence (seed 0), min of 5 after a warm call, for the
``volumerenderer_tpu_torch`` package found under ROOT.  Prints one JSON
line.  Where the package has ``IsosurfacePlan.bind``, ``B2_bound`` (and
``B8_bound``, ``B9_bound`` from each pool) is the march with one bound of
the volume and isovalue, which every plan shares (bound once, outside the
timing).

``B1`` and ``B4`` are the marches on the byte volume (``quantize_u8`` of the
turbulence, made once).  Where the package has the float32 route,
``B1_fused`` is B1 as the main path launches it (the float32 volume, each
tap quantized as read, the transfer in the epilogue), ``B4_fused`` B4 on the
float32 volume and ``B6_rgb`` / ``B7_rgb`` the pooled marches with the
transfer in their epilogue.  ``frame`` is ``CompositingPlan.render`` of the
float32 volume, per frame (whatever the package runs for it: a quantize
pass, B1 and the transfer, or one launch); ``pooled_frame_*``
``render_pooled`` per frame; ``tf_fit_step`` one ``tf_fit_step_fast`` of the
config-4 fit at orbit frame 0.

B10 and B11 are timed three ways: one launch per shard (``*_launch``, ms per
launch, from each shard's cached entry table where the package has one),
through ``kernel_sharded._seg_launches`` (``*_seg_launches``, ms per frame:
the per-frame quantize, halo exchange and copies of the four shards
included), and the whole ``render_{z,brick}sharded_kernel`` frame
(``frame_*``).  Where the package builds entry tables, ``table_*`` is the
table kernel's ms per launch.

To compare two trees on one card, unpack the other tree into a git-ignored
directory of the checkout and run both in turns within one command:

    for r in build/base . . build/base; do python3 scripts/torch_kernel_ab.py $r $r; done
"""
import json
import math
import sys

ROOT, LABEL = sys.argv[1], sys.argv[2]
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from volumerenderer_tpu_torch import Camera, TFParams, as_normalized_volume, generate_rays  # noqa
from volumerenderer_tpu_torch.diff import closed_form as CF  # noqa: E402
from volumerenderer_tpu_torch.io.synthetic import turbulence_volume  # noqa: E402
from volumerenderer_tpu_torch.models import plan_compositing  # noqa: E402
from volumerenderer_tpu_torch.ops.cuda import isosurface_kernel as IK  # noqa: E402
from volumerenderer_tpu_torch.ops.cuda import raycast_kernel as RK  # noqa: E402
from volumerenderer_tpu_torch.ops.cuda import seg_kernel as SK  # noqa: E402
from volumerenderer_tpu_torch.ops.cuda import tf_kernel as TK  # noqa: E402
from volumerenderer_tpu_torch.ops.cuda import voxel_grad_kernel as VK  # noqa: E402
from volumerenderer_tpu_torch.parallel import bricks as PB  # noqa: E402
from volumerenderer_tpu_torch.parallel import context as PC  # noqa: E402
from volumerenderer_tpu_torch.parallel import kernel_sharded as KS  # noqa: E402

dev = torch.device("cuda", 0)
W = H = 1024


def orbit(az):
    a = math.radians(az)
    return Camera(width=W, height=H, position=(0.75 * math.sin(a), 0.0, -0.75 * math.cos(a)),
                  front=(-math.sin(a), 0.0, math.cos(a)))


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


turb = as_normalized_volume(turbulence_volume((256, 256, 256), seed=0), device=dev)
u8 = RK.quantize_u8(turb)
plans, iplans = [], []
for i in range(16):
    r = generate_rays(orbit(2.0 * i), device=dev)
    plans.append(plan_compositing(r.entry_uv, r.direction, r.hit, (256, 256, 256)))
    iplans.append(IK.IsosurfacePlan(r.entry_uv, r.direction, r.hit, (256, 256, 256)))
iso = IK.volume_median(turb)
ref = TFParams.reference(dev)
tf = CF.tf_scalars(ref)
target = torch.full((H, W, 3), 0.5, device=dev)
cots = []
for p in plans:
    k = TK.tf_march_cuda(u8, p.entry_uv, p.dir_step, p.hit, tf)
    rgb = ref.flip_sign * k[0][..., None] + ref.flip_bias
    g_rgb = (rgb - target) * (2.0 / rgb.numel())
    cots.append((*CF.cotangent_images(ref, g_rgb, None, k[1]), k[3]))
fused = hasattr(RK, "composite_march_f32_cuda")
hits = [IK.iso_march_cuda(u8, p.entry_uv, p.dir_step, p.hit, iso) for p in iplans]
pools = {"narrow": RK.build_slab_pool_narrow(u8), "pair16": RK.build_slab_pool(u8)}
pooled = {"narrow": (RK.composite_march_pooled_narrow_cuda, IK.iso_march_pooled_narrow_cuda),
          "pair16": (RK.composite_march_pooled_pair16_cuda, IK.iso_march_pooled_pair16_cuda)}
f_tf = TK.make_render_tf_kernel(plans[0])
ms = {
    "B1": time_ms(lambda: [RK.composite_march_cuda(u8, p.entry_uv, p.dir_step, p.hit)
                           for p in plans]) / 16,
    "frame": time_ms(lambda: [p.render(turb) for p in plans]) / 16,
    "tf_fit_step": time_ms(lambda: TK.tf_fit_step_fast(f_tf, ref, turb, target, lr=0.05)),
    "B3": time_ms(lambda: [IK.iso_shade_cuda(u8, p.entry_uv, p.dir_step, p.direction, f, t, iso)
                           for p, (f, t) in zip(iplans, hits)]) / 16,
    "B4": time_ms(lambda: [TK.tf_march_cuda(u8, p.entry_uv, p.dir_step, p.hit, tf)
                           for p in plans]) / 16,
    "B5": time_ms(lambda: [VK.voxel_grad_cuda(u8, p.entry_uv, p.dir_step, p.hit, tf, *c)
                           for p, c in zip(plans, cots)]) / 16,
    "B2": time_ms(lambda: [IK.iso_march_cuda(u8, p.entry_uv, p.dir_step, p.hit, iso)
                           for p in iplans]) / 16,
}
if fused:
    ms["B1_fused"] = time_ms(lambda: [RK.composite_march_f32_cuda(
        turb, p.entry_uv, p.dir_step, p.hit, transfer=True) for p in plans]) / 16
    ms["B4_fused"] = time_ms(lambda: [TK.tf_march_f32_cuda(turb, p.entry_uv, p.dir_step, p.hit, tf)
                                      for p in plans]) / 16
for fmt, b in (("narrow", "B6"), ("pair16", "B7")):
    pool, smap = pools[fmt]
    ms[b] = time_ms(lambda: [pooled[fmt][0](pool, smap, p.entry_uv, p.dir_step, p.hit)
                             for p in plans]) / 16
    if fused:
        ms[f"{b}_rgb"] = time_ms(lambda: [pooled[fmt][0](pool, smap, p.entry_uv, p.dir_step, p.hit,
                                                         transfer=True) for p in plans]) / 16
    ms[f"pooled_frame_{fmt}"] = time_ms(lambda: [p.render_pooled(pool, smap) for p in plans]) / 16
for fmt, b in (("narrow", "B8"), ("pair16", "B9")):
    pool, smap = pools[fmt]
    ms[b] = time_ms(lambda: [pooled[fmt][1](pool, smap, p.entry_uv, p.dir_step, p.hit, iso)
                             for p in iplans]) / 16
if hasattr(IK.IsosurfacePlan, "bind"):
    bound = iplans[0].bind(turb, iso)
    ms["B2_bound"] = time_ms(lambda: [IK.iso_march_cuda(u8, p.entry_uv, p.dir_step, p.hit, iso,
                                                        bound=bound)
                                      for p in iplans]) / 16
    for fmt, b in (("narrow", "B8"), ("pair16", "B9")):
        pool, smap = pools[fmt]
        pb = iplans[0].bind(iso_value=iso, pool=(pool, smap))
        ms[f"{b}_bound"] = time_ms(lambda: [pooled[fmt][1](pool, smap, p.entry_uv, p.dir_step,
                                                           p.hit, iso, bound=pb)
                                            for p in iplans]) / 16

has_table = hasattr(KS, "shard_starts")
meshes = {"z4": PC.make_z_mesh(4), "bricks221": PB.make_brick_mesh((2, 2, 1))}
render = {"z4": KS.render_zsharded_kernel, "bricks221": KS.render_bricksharded_kernel}
for name, mesh in meshes.items():
    sv = PB.shard_volume(mesh, turb)
    shards = KS.seg_shards(mesh, plans[0], sv)  # the slabs; every plan shares them
    on = []
    for p in plans:
        for slab, kw in shards:
            starts = {"starts": KS.shard_starts(p, kw, dev)} if has_table else {}
            on.append((slab, kw, (p.entry_uv, p.dir_step, p.hit), starts))
    if has_table:
        ms[f"table_{name}"] = time_ms(lambda: [SK.seg_entry_table_cuda(*r, **kw)
                                               for _, kw, r, _ in on]) / len(on)
    ms[f"B10_launch_{name}"] = time_ms(lambda: [SK.seg_march_cuda(s, *r, **kw, **st)
                                                for s, kw, r, st in on]) / len(on)
    ms[f"B11_launch_{name}"] = time_ms(lambda: [SK.seg_tf_march_cuda(s, *r, tf, **kw, **st)
                                                for s, kw, r, st in on]) / len(on)
    ms[f"B10_seg_launches_{name}"] = time_ms(
        lambda: [KS._seg_launches(mesh, p, sv, None) for p in plans]) / 16
    ms[f"B11_seg_launches_{name}"] = time_ms(
        lambda: [KS._seg_launches(mesh, p, sv, tf) for p in plans]) / 16
    ms[f"frame_{name}"] = time_ms(lambda: [render[name](mesh, p, sv) for p in plans]) / 16
print(json.dumps({"label": LABEL, "ms": ms, "gpu": torch.cuda.get_device_name(0),
                  "from": VK.__file__}), flush=True)
