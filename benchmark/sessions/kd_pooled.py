"""kd_pooled: the upstream viewer's own pipeline (``main.cpp:242-281``): the
volume compressed by the progressive kd-tree on the card
(``build_device``), the packed tree resident (``CompressedRenderer``), its
full level cut decoded once into the pair16 z-slab pool, and each frame
one compositing render of a camera's plan over that pool
(``make_plan(pooled=True)``: B7).  All of it is set-up; the window renders.

In the traced run the set-up runs under a profiler of its own, so that the
card's time in the build (``vr.kd.build``), the cut's decode
(``vr.kd.decode``) and the pool's build (``vr.pool.build``), and the
host's in the Δ seeding (``vr.kd.seed``), reach the readers through
:meth:`Session.work`.

The check holds the program's packed tree and a decode of its cut, taken
after the window, and the Δ seeds it recorded, against the plain codec in
``vrbench/reference_kd.py``, and each kept frame against the plain render of
that reference's own cut."""
from __future__ import annotations

import contextlib
import os
import tempfile
import types

import torch

from vrbench import reference as R
from vrbench import reference_kd as RKD
from vrbench import tracing, traffic
from vrbench.peaks import least_time

SETUP_SPANS = ("vr.kd.build", "vr.kd.decode", "vr.pool.build")


class Session(traffic.RenderSession):
    def __init__(self, cfg, mix, seed, device, program, span, *rest):
        self.renderer = None
        self.setup = {}
        with _profiled_setup(span.on, device, self.setup):
            super().__init__(cfg, mix, seed, device, program, span, *rest)
        # alpha, not the iso hit
        self.buf_aux = torch.empty(self.buf_aux.shape, dtype=torch.float32, device=device)
        self.prog = self.ref_cut = None
        # the deployment holds only the packed tree and the slab pool: the
        # source volume waits on the host for the check
        self.vol_u8 = self.vol_u8.cpu()

    @classmethod
    def load_program(cls):
        from volumerenderer_tpu_torch.codecs.device import level_cut_device
        from volumerenderer_tpu_torch.codecs.device_build import build_device
        from volumerenderer_tpu_torch.models import CompressedRenderer

        return types.SimpleNamespace(**vars(super().load_program()), build_device=build_device,
                                     CompressedRenderer=CompressedRenderer,
                                     level_cut_device=level_cut_device)

    @staticmethod
    def shrink(cfg, mix):
        cfg["volume"]["shape"] = [16, 32, 32]
        cfg["image"] = [20, 16]
        mix["trace"] = {"warm": 2, "frames": 4}

    @classmethod
    def planted_faults(cls) -> dict:
        return {"altered_pooled_answer": _altered_pooled_answer,
                "delta_off_by_one": _delta_off_by_one,
                "chain_code_dropped": _chain_code_dropped}

    def compress(self):
        """The build on the card and the packed tree resident; the tree the
        build returned is dropped (the renderer holds it packed)."""
        codec = self.cfg["codec"]
        if codec["pool"] != "pair16":
            raise ValueError(f"a compositing plan marches the pair16 pool, not {codec['pool']!r}")
        tree = self.P.build_device(self.vol_u8, tolerance=int(codec["tolerance"]),
                                   max_epochs=int(codec["max_epochs"]), device=self.device)
        self.seeds = [float(s) for s in tree.seeds]
        self.renderer = self.P.CompressedRenderer(tree, self.device)
        del tree
        spec = self.renderer.spec
        self.cut = spec["max_depth"] if codec["cut"] == "max_depth" else int(codec["cut"])

    def make_plan(self, cam):
        if self.renderer is None:
            self.compress()
        return self.renderer.make_plan(self.program_rays(cam), cut_depth=self.cut,
                                       max_samples=self.max_samples, pooled=True)

    def frame(self, keep=None):
        t = self.t
        self.t += 1
        with self.span("render"):
            rgb, alpha = self.plans[self.path.index(t)]()
        if keep is not None:
            self.buf_rgb[keep].copy_(rgb)
            self.buf_aux[keep].copy_(alpha)
            self.kept[keep] = t
        if self.log is not None:
            self.log.append(t)
        self.present(t)

    def after_window(self):
        """The program's packed tree and one decode of its cut."""
        d, spec = self.renderer.dtree, self.renderer.spec
        self.prog = {"dm": d.distance_map.cpu().tolist(), "levels": d.packed_levels,
                     "chains": d.packed_chains,
                     "cut": self.P.level_cut_device(d, spec, self.cut)}

    def release(self):
        super().release()
        self.renderer = None

    def check(self, stand_in=None) -> dict:
        """The tree's and the cut's gaps (:func:`reference_kd.check_tree`),
        then each kept frame against the plain render of the reference's cut
        (``stand_in`` "bfloat16": that render in bfloat16 in the program's
        place)."""
        codec = self.cfg["codec"]
        if self.ref_cut is None:
            self.tree_numbers, self.ref_cut = RKD.check_tree(
                self.vol_u8.to(self.device), int(codec["tolerance"]), int(codec["max_epochs"]),
                self.seeds,
                self.cut, self.prog["dm"], self.prog["levels"], self.prog["chains"],
                self.prog["cut"])
        dtype = traffic.STAND_INS[stand_in] if stand_in else torch.float32
        rgb_err = alpha_err = 0.0
        for slot, t in sorted(self.kept.items()):
            rays = R.generate_rays(self.path(t), self.device)
            rgb_ref, alpha_ref, _ = R.composite(self.ref_cut, rays, self.max_samples)
            rgb, alpha = self.buf_rgb[slot], self.buf_aux[slot]
            if dtype != torch.float32:
                rgb, alpha, _ = R.composite(self.ref_cut, rays, self.max_samples, dtype=dtype)
            rgb_err = max(rgb_err, float((rgb - rgb_ref).abs().max()))
            alpha_err = max(alpha_err, float((alpha - alpha_ref).abs().max()))
        return {**self.tree_numbers, "rgb_err": rgb_err, "alpha_err": alpha_err}

    def work(self) -> dict:
        """The set-up's span times, and B7's work over the traced frames:
        the pool words its taps read (``work/pooled.py``), counted on the
        reference's cut by the reference's march."""
        W = self.W["pooled"]
        Z, Y, X = self.ref_cut.shape
        per_cam, out = {}, [0.0, 0.0, 0.0]
        for t in self.log or []:
            i = self.path.index(t)
            if i not in per_cam:
                rays = R.generate_rays(self.path(t), self.device)
                words = W.TapWords(self.ref_cut.shape)
                _, _, n = R.composite(self.ref_cut, rays, self.max_samples, record=words)
                per_cam[i] = W.march(float(rays.hit.numel()), float(n.sum()), words.count())
            b, o = per_cam[i]
            out = [out[0] + b, out[1] + o, out[2] + least_time(b, o)]
        return {"pooled": out, "setup": dict(self.setup)}


@contextlib.contextmanager
def _profiled_setup(on: bool, device, into: dict):
    """With ``on``, the block under a profiler of its own, its card's time in
    each of ``SETUP_SPANS`` and its host's time in ``vr.kd.seed`` put in
    ``into`` (seconds)."""
    if not on:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function("window"):
            yield
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "setup.json")
        prof.export_chrome_trace(path)
        trace = tracing.load(path, 1)
    for name in SETUP_SPANS:
        if trace.ranges.get(name):
            into[name] = trace.device_s(name)
    if trace.ranges.get("vr.kd.seed"):
        into["vr.kd.seed.host"] = trace.host_s("vr.kd.seed")


def _altered_pooled_answer(program, patch):
    """Each frame's image with an 8x8 tile 0.05 darker."""

    class Altered(program.CompressedRenderer):
        def make_plan(self, *a, **k):
            render = super().make_plan(*a, **k)

            def altered():
                rgb, alpha = render()
                rgb = rgb.clone()
                rgb[:8, :8] -= 0.05
                return rgb, alpha

            return altered

    return types.SimpleNamespace(**{**vars(program), "CompressedRenderer": Altered})


def _built_then(program, alter):
    def build(*a, **k):
        tree = program.build_device(*a, **k)
        alter(tree)
        return tree

    return types.SimpleNamespace(**{**vars(program), "build_device": build})


def _delta_off_by_one(program, patch):
    """The leaf level's Δ one more after the build."""

    def alter(tree):
        tree.distance_map[tree.orig_depth] += 1

    return _built_then(program, alter)


def _chain_code_dropped(program, patch):
    """The first chain whose first node moves its leaf (code 1 or 2) loses
    that node: it reads as absent."""

    def alter(tree):
        first = tree.chain_codes[:, 0]
        leaf = int(torch.nonzero((first == 1) | (first == 2))[0, 0])
        tree.chain_codes[leaf, 0] = 255

    return _built_then(program, alter)
