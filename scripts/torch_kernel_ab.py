"""Per-launch times of the port's kernels that share csrc/trilinear.cuh (B1,
B2 at the volume's median, B3, B4, B5, the pooled marches B6–B9 and the
pooled shade on each pool, ``shade_pooled_*``) and of the
segment marches (B10, B11) on both volume-sharded layouts (z-slabs n = 4,
bricks (2, 2, 1)), over the 16-frame orbit at 1024^2 rays on the 256^3
turbulence (seed 0), min of 5 after a warm call, for the
``volumerenderer_tpu_torch`` package found under ROOT.  Prints one JSON
line.  Where the package has ``IsosurfacePlan.bind``, ``B2_bound`` (and
``B8_bound``, ``B9_bound`` from each pool) is the march with one bound of
the volume and isovalue, which every plan shares (bound once, outside the
timing).  ``B1_fused_{sphere,dim2}`` and ``B6_rgb_*`` / ``B7_rgb_*`` are the
compositing marches on a 256^3 sphere (its outside empty) and on the
turbulence dimmed to 2 %; where the package has ``CompositingPlan.bind``,
``*_bound*`` are the bound kernels, one bound of each data (B1 from the
volume, B6 and B7 from their pool), launched by their wrappers as render
launches them (render itself marches unbound where a grid has no empty
block), and ``digests`` holds every one's (rgb, alpha) over the orbit.

Where the package's isosurface march returns the near bracket
(``with_near``), ``B2``, ``B8``, ``B9`` (and their ``_bound``) are timed as
``render`` launches them, storing near, and ``B3`` and ``shade_pooled_*``
shade from that near (``B3_chain``, ``shade_pooled_*_chain``: the chain
instantiation beside; ``*_bound_without_near``: the bound marches without
the store); on a tree without it, the march without near and the
shade that rebuilds the bracket from ``t_hit``.  ``iso_frame`` and
``iso_frame_bound`` are ``IsosurfacePlan.render`` per frame, unbound and
with one bound; ``digests`` hashes the marches' ``(found, t_hit)`` (both
wraps, bound and unbound) and the shades' rgb, so that two trees' outputs
can be held bit-equal.

``B1`` and ``B4`` are the marches on the byte volume (``quantize_u8`` of the
turbulence, made once).  ``B1_fused`` is B1 as the main path launches it
(the float32 volume, each tap quantized as read), ``B4_fused`` B4 on the
float32 volume and ``B6_rgb`` / ``B7_rgb`` the pooled marches; every
compositing march writes the displayed image in its epilogue.  ``B5`` is
the voxel-gradient march on the byte volume (its zero fill included);
``B5_quantize_u8`` the same after a ``quantize_u8`` of the float32 volume on
every launch (the fit's backward where B5 reads bytes) and ``B5f32`` B5 on
the float32 volume itself, each tap quantized as read.
``frame`` is ``CompositingPlan.render`` of the float32 volume, per frame
(whatever the package runs for it: a quantize pass, B1 and the transfer, or
one launch); ``pooled_frame_*`` ``render_pooled`` per frame;
``tf_fit_step`` one ``tf_fit_step_fast`` of the config-4 fit at orbit frame
0.

B10 and B11 are timed three ways: one launch per shard (``*_launch``, ms per
launch, from each shard's cached entry table where the package has one),
through ``kernel_sharded._seg_launches`` (``*_seg_launches``, ms per frame:
the per-frame quantize, halo exchange and copies of the four shards
included), and the whole ``render_{z,brick}sharded_kernel`` frame
(``frame_*``).  Where the package builds entry tables, ``table_*`` is the
table kernel's ms per launch.

The script calls the wrappers of a tree with one wrapper per march for both
volume dtypes; an older tree is timed by its own copy of the script.  To
compare two trees on one card, unpack the other tree into a git-ignored
directory of the checkout and run each tree's script in turns within one
command:

    for r in build/base . . build/base; do python3 $r/scripts/torch_kernel_ab.py $r $r; done
"""
import hashlib
import inspect
import json
import math
import sys
import time

ROOT, LABEL = sys.argv[1], sys.argv[2]
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from volumerenderer_tpu_torch import Camera, TFParams, as_normalized_volume, generate_rays  # noqa
from volumerenderer_tpu_torch.diff import closed_form as CF  # noqa: E402
from volumerenderer_tpu_torch.io.synthetic import sphere_volume, turbulence_volume  # noqa: E402
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
has_bind = hasattr(IK.IsosurfacePlan, "bind")
# the marches as render launches them: storing near where the tree has it
near = {"with_near": True} if "with_near" in inspect.signature(IK.iso_march_cuda).parameters \
    else {}
hits = [IK.iso_march_cuda(u8, p.entry_uv, p.dir_step, p.hit, iso, **near) for p in iplans]


def shade_args(found, t_hit, near=None):
    """The shade's (found, t_hit) and its near keyword: from near where
    the march stored it, else the chain from t_hit."""
    if near is None:
        return (found, t_hit), {}
    return (found, None), {"near": near}


def digest(*tensors):
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def b3(p, h, chain=False):
    (f, t), kw = shade_args(*(h[:2] if chain else h))
    return IK.iso_shade_cuda(u8, p.entry_uv, p.dir_step, p.direction, f, t, iso, **kw)


def shade_pooled(pool, smap, p, h, chain=False):
    (f, t), kw = shade_args(*(h[:2] if chain else h))
    return IK.iso_shade_pooled_cuda(pool, smap, p.entry_uv, p.dir_step, p.direction, f, t, iso,
                                    **kw)


pools = {"narrow": RK.build_slab_pool_narrow(u8), "pair16": RK.build_slab_pool(u8)}
pooled = {"narrow": (RK.composite_march_pooled_narrow_cuda, IK.iso_march_pooled_narrow_cuda),
          "pair16": (RK.composite_march_pooled_pair16_cuda, IK.iso_march_pooled_pair16_cuda)}
f_tf = TK.make_render_tf_kernel(plans[0])
ms = {
    "B1": time_ms(lambda: [RK.composite_march_cuda(u8, p.entry_uv, p.dir_step, p.hit)
                           for p in plans]) / 16,
    "frame": time_ms(lambda: [p.render(turb) for p in plans]) / 16,
    "tf_fit_step": time_ms(lambda: TK.tf_fit_step_fast(f_tf, ref, turb, target, lr=0.05)),
    "B3": time_ms(lambda: [b3(p, h) for p, h in zip(iplans, hits)]) / 16,
    "B4": time_ms(lambda: [TK.tf_march_cuda(u8, p.entry_uv, p.dir_step, p.hit, tf)
                           for p in plans]) / 16,
    "B5": time_ms(lambda: [VK.voxel_grad_cuda(u8, p.entry_uv, p.dir_step, p.hit, tf, *c)
                           for p, c in zip(plans, cots)]) / 16,
    "B2": time_ms(lambda: [IK.iso_march_cuda(u8, p.entry_uv, p.dir_step, p.hit, iso, **near)
                           for p in iplans]) / 16,
    "iso_frame": time_ms(lambda: [p.render(turb, iso) for p in iplans]) / 16,
}
digests = {"B3": digest(*(b3(p, h) for p, h in zip(iplans, hits))),
           "B2": digest(*(x for h in hits for x in h[:2]))}
if near:
    ms["B3_chain"] = time_ms(lambda: [b3(p, h, chain=True) for p, h in zip(iplans, hits)]) / 16
    digests["B3_chain"] = digest(*(b3(p, h, chain=True) for p, h in zip(iplans, hits)))
ms["B5_quantize_u8"] = time_ms(lambda: [VK.voxel_grad_cuda(RK.quantize_u8(turb), p.entry_uv,
                                                          p.dir_step, p.hit, tf, *c)
                                       for p, c in zip(plans, cots)]) / 16
ms["B5f32"] = time_ms(lambda: [VK.voxel_grad_cuda(turb, p.entry_uv, p.dir_step, p.hit, tf, *c)
                               for p, c in zip(plans, cots)]) / 16
ms["B1_fused"] = time_ms(lambda: [RK.composite_march_cuda(turb, p.entry_uv, p.dir_step, p.hit)
                                  for p in plans]) / 16
ms["B4_fused"] = time_ms(lambda: [TK.tf_march_cuda(turb, p.entry_uv, p.dir_step, p.hit, tf)
                                  for p in plans]) / 16
for fmt, b in (("narrow", "B6"), ("pair16", "B7")):
    pool, smap = pools[fmt]
    ms[f"{b}_rgb"] = time_ms(lambda: [pooled[fmt][0](pool, smap, p.entry_uv, p.dir_step, p.hit)
                                      for p in plans]) / 16
    ms[f"pooled_frame_{fmt}"] = time_ms(lambda: [p.render_pooled(pool, smap) for p in plans]) / 16
for fmt, b in (("narrow", "B8"), ("pair16", "B9")):
    pool, smap = pools[fmt]
    ms[b] = time_ms(lambda: [pooled[fmt][1](pool, smap, p.entry_uv, p.dir_step, p.hit, iso,
                                            **near) for p in iplans]) / 16
    digests[b] = digest(*(x for p in iplans for x in pooled[fmt][1](
        pool, smap, p.entry_uv, p.dir_step, p.hit, iso)))
    # the pooled shade on this pool, fed B2's hits (the pooled march's, bit for bit)
    ms[f"shade_pooled_{fmt}"] = time_ms(lambda: [shade_pooled(pool, smap, p, h)
                                                 for p, h in zip(iplans, hits)]) / 16
    digests[f"shade_pooled_{fmt}"] = digest(*(shade_pooled(pool, smap, p, h)
                                              for p, h in zip(iplans, hits)))
    if near:
        ms[f"shade_pooled_{fmt}_chain"] = time_ms(lambda: [
            shade_pooled(pool, smap, p, h, chain=True) for p, h in zip(iplans, hits)]) / 16
# B2 in GL_REPEAT on the same orbit, for the digests
rplans = [IK.IsosurfacePlan(p.entry_uv, p.direction, p.hit, (256, 256, 256), wrap="repeat")
          for p in iplans]
digests["B2_repeat"] = digest(*(x for p in rplans for x in IK.iso_march_cuda(
    u8, p.entry_uv, p.dir_step, p.hit, iso, wrap="repeat")))
if has_bind:
    bound = iplans[0].bind(turb, iso)
    ms["B2_bound"] = time_ms(lambda: [IK.iso_march_cuda(u8, p.entry_uv, p.dir_step, p.hit, iso,
                                                        bound=bound, **near)
                                      for p in iplans]) / 16
    ms["iso_frame_bound"] = time_ms(lambda: [p.render(turb, iso, bound=bound)
                                             for p in iplans]) / 16
    if near:
        ms["B2_bound_without_near"] = time_ms(lambda: [IK.iso_march_cuda(
            u8, p.entry_uv, p.dir_step, p.hit, iso, bound=bound) for p in iplans]) / 16
    rbound = rplans[0].bind(turb, iso)
    digests["B2_bound"] = digest(*(x for p in iplans for x in IK.iso_march_cuda(
        u8, p.entry_uv, p.dir_step, p.hit, iso, bound=bound)))
    digests["B2_bound_repeat"] = digest(*(x for p in rplans for x in IK.iso_march_cuda(
        u8, p.entry_uv, p.dir_step, p.hit, iso, wrap="repeat", bound=rbound)))
    for fmt, b in (("narrow", "B8"), ("pair16", "B9")):
        pool, smap = pools[fmt]
        pb = iplans[0].bind(iso_value=iso, pool=(pool, smap))
        ms[f"{b}_bound"] = time_ms(lambda: [pooled[fmt][1](pool, smap, p.entry_uv, p.dir_step,
                                                           p.hit, iso, bound=pb, **near)
                                            for p in iplans]) / 16
        if near:
            ms[f"{b}_bound_without_near"] = time_ms(lambda: [pooled[fmt][1](
                pool, smap, p.entry_uv, p.dir_step, p.hit, iso, bound=pb) for p in iplans]) / 16
        ms[f"pooled_iso_frame_{fmt}"] = time_ms(lambda: [p.render_pooled(pool, smap, iso)
                                                         for p in iplans]) / 16

# the compositing marches as render and render_pooled launch them on the
# turbulence, on a sphere whose outside is empty and on the turbulence dimmed
# to 2 %; where the package has CompositingPlan.bind, bound (one bind of
# each data, shared by every plan) beside unbound
has_cbind = hasattr(RK.CompositingPlan, "bind")
fields = {"turbulence": turb, "sphere": as_normalized_volume(
    sphere_volume((256, 256, 256)), device=dev), "dim2": turb * 0.02}
for fname, vol in fields.items():
    sfx = "" if fname == "turbulence" else f"_{fname}"
    vol_u8 = RK.quantize_u8(vol)
    fpools = {"B6": RK.build_slab_pool_narrow(vol_u8), "B7": RK.build_slab_pool(vol_u8)}
    if fname != "turbulence":
        ms[f"B1_fused{sfx}"] = time_ms(lambda: [p.render(vol) for p in plans]) / 16
        for b, pool in fpools.items():
            ms[f"{b}_rgb{sfx}"] = time_ms(lambda: [p.render_pooled(*pool) for p in plans]) / 16
    digests[f"B1_fused{sfx}"] = digest(*(x for p in plans for x in p.render(vol)))
    for b, pool in fpools.items():
        digests[f"{b}_rgb{sfx}"] = digest(*(x for p in plans for x in p.render_pooled(*pool)))
    if has_cbind:  # the bound kernels, launched as render launches them
        cb = plans[0].bind(vol)
        marches = {"B1_fused": (RK.composite_march_cuda, (vol,), cb),
                   **{b: (pooled[fmt][0], fpools[b], plans[0].bind(pool=fpools[b]))
                      for fmt, b in (("narrow", "B6"), ("pair16", "B7"))}}
        for b, (march, data, bd) in marches.items():
            name = f"{b}_bound{sfx}" if b == "B1_fused" else f"{b}_rgb_bound{sfx}"

            def run(p, march=march, data=data, bd=bd):
                return march(*data, p.entry_uv, p.dir_step, p.hit, bound=bd)

            ms[name] = time_ms(lambda: [run(p) for p in plans]) / 16
            digests[name] = digest(*(x for p in plans for x in run(p)))

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
print(json.dumps({"label": LABEL, "ms": ms, "digests": digests, "near_route": bool(near),
                  "gpu": torch.cuda.get_device_name(0), "from": VK.__file__}), flush=True)
