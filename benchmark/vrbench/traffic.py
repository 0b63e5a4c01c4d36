"""The one generator of the benchmark's traffic: a mix file
(``benchmark/traffic/<mix>.json``) names what the user does each frame, and
this module turns it, a configuration and a seed into a session.

A mix's keys:

* ``render``: ``composite`` (a compositing render a frame), ``iso`` (a bind
  and an isosurface render a frame), ``fit`` (a step of the multi-view
  inverse render), or the name of a session of its own,
  ``sessions/<render>.py`` (:func:`session_class`);
* ``camera``: the camera path (``cameras.Path``): ``fixed`` or ``orbit``
  (``count``, ``step_deg``, ``take_every``); each camera's rays and plan
  are made in set-up;
* ``iso`` (iso): ``first``, ``step``, ``last`` over ``scale``: the isovalue
  starts at ``first`` and steps up each frame and back down;
* ``fit``: ``views``, ``lr`` (``params``, ``volume``), ``perturb``
  (``params``: what is added to each TF parameter; ``volume``: the
  standard deviation of the seeded noise added to the volume),
  ``check_steps`` (the steps the check follows, from the start and again
  from the state the window ends in);
* ``in_flight`` (composite, iso; default 1): the frames the viewer lets
  run ahead of its display: 1 waits for each frame once it is issued, 2
  (a swap chain) for the frame before it;
* ``check``: how many frames of the window the reference checks;
* ``limits``: the limit of each number compared;
* ``trace``: ``warm`` and ``frames`` of the traced window.

A session makes its inputs on the device from the seed, calls the program
only through the public entry points its class loads (``load_program``),
and keeps what the check needs.  ``frame(keep)`` is one unit of the user's
loop; ``after_window()`` takes what the check needs from the state the
window ended in; ``check()`` compares the kept outputs with the plain
reference once the program's state is released; ``work()`` counts the
traced frames' work.  Its class also gives the cell's sizes in the CPU
tests (``shrink``) and the faults those tests plant (``planted_faults``).
"""
from __future__ import annotations

import random
import types

import torch

from . import reference as R
from . import volumes
from .cameras import Path
from .named import BENCH_DIR, load_named
from .peaks import least_time


def _sync(device):
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class Session:
    """What every mix shares: the volume, the camera path, the spans."""

    def __init__(self, cfg, mix, seed, device, program, span, work, bench_dir=BENCH_DIR):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, int(seed), device
        self.P, self.span, self.W = program, span, work
        self.vol_u8 = volumes.make(cfg["volume"], seed, device, bench_dir)
        Z, Y, X = self.vol_u8.shape
        self.dims = (X, Y, Z)
        self.max_samples = int(cfg["max_samples"])
        self.path = Path(cfg, mix["camera"], seed)
        self.t = 0
        self.log = None  # frame numbers of the traced window
        self.kept = {}

    @classmethod
    def load_program(cls):
        """The program's public entry points the session calls, imported
        now (never at module import); a session of its own adds its own."""
        import volumerenderer_tpu_torch as port
        from volumerenderer_tpu_torch.models import plan_compositing
        from volumerenderer_tpu_torch.ops.cuda.isosurface_kernel import IsosurfacePlan
        from volumerenderer_tpu_torch.ops.cuda.voxel_grad_kernel import make_render_tf_voxel

        return types.SimpleNamespace(Camera=port.Camera, generate_rays=port.generate_rays,
                                     TFParams=port.TFParams, plan_compositing=plan_compositing,
                                     IsosurfacePlan=IsosurfacePlan,
                                     make_render_tf_voxel=make_render_tf_voxel)

    @staticmethod
    def shrink(cfg, mix):
        """The cell at the size of the CPU tests: a volume of a few tens of
        voxels a side, a few hundred rays, a short trace."""
        cfg["volume"]["shape"] = [24, 28, 32]
        cfg["image"] = [20, 16]
        mix["trace"] = {"warm": 2, "frames": 4}

    @classmethod
    def planted_faults(cls) -> dict:
        """name -> ``plant(program, patch)``: the program with a fault that
        the check has to refuse planted under the timed path; ``patch(obj,
        attr, value)`` replaces an attribute for one run (pytest's
        ``monkeypatch.setattr``).  The CPU tests plant each in turn."""
        return {}

    def program_camera(self, cam: R.Camera):
        return self.P.Camera(position=cam.position, front=cam.front, up=cam.up,
                             fov_y_degrees=cam.fov_y_degrees, width=cam.width,
                             height=cam.height)

    def program_rays(self, cam: R.Camera):
        return self.P.generate_rays(self.program_camera(cam), device=self.device)

    @property
    def cycle(self) -> int:
        return self.path.cycle

    def check_frames(self, expected: int) -> list:
        """The frames of the window whose outputs the check compares: drawn
        from the seed among the first ``expected``."""
        n = int(self.mix["check"]["frames"])
        rng = random.Random(self.seed ^ 0xC0FFEE)
        return sorted(rng.sample(range(max(expected, n)), n))

    def after_window(self):
        """Take what the check needs from the state the window ended in."""

    def release(self):
        """Drop the program's state (plans, bounds) before the reference runs."""


class RenderSession(Session):
    """A compositing or isosurface render each frame, synchronised as a
    viewer displays it."""

    def __init__(self, *a):
        super().__init__(*a)
        mix = self.mix
        self.iso_values = None
        if mix["render"] == "iso":
            it = mix["iso"]
            up = [(it["first"] + it["step"] * k) / it["scale"]
                  for k in range(int((it["last"] - it["first"]) // it["step"]) + 1)]
            self.iso_values = up + up[-2:0:-1]
        self.plans = [self.make_plan(c) for c in self.path.cameras]
        self.in_flight = int(mix.get("in_flight", 1))
        self.fences = ([torch.cuda.Event() for _ in range(self.in_flight)]
                       if self.device.type == "cuda" and self.in_flight > 1 else None)
        w, h = self.cfg["image"]
        n = int(mix["check"]["frames"])
        self.buf_rgb = torch.empty((n, h, w, 3), dtype=torch.float32, device=self.device)
        self.buf_aux = torch.empty((n, h, w), dtype=torch.float32 if mix["render"] == "composite"
                                   else torch.bool, device=self.device)

    def make_plan(self, cam):
        rays = self.program_rays(cam)
        if self.mix["render"] == "iso":
            return self.P.IsosurfacePlan(rays.entry_uv, rays.direction, rays.hit, self.dims,
                                         self.max_samples)
        return self.P.plan_compositing(rays.entry_uv, rays.direction, rays.hit, self.dims,
                                       self.max_samples)

    @property
    def cycle(self) -> int:
        n = self.path.cycle
        return max(n, len(self.iso_values)) if self.iso_values else n

    def iso_at(self, t: int) -> float:
        return self.iso_values[t % len(self.iso_values)]

    def frame(self, keep=None):
        t = self.t
        self.t += 1
        plan = self.plans[self.path.index(t)]
        if self.iso_values is None:
            with self.span("render"):
                rgb, aux = plan.render(self.vol_u8)
        else:
            iso = self.iso_at(t)
            with self.span("bind"):
                bound = plan.bind(self.vol_u8, iso)
            with self.span("iso_render"):
                rgb, aux = plan.render(self.vol_u8, iso, bound=bound)
        if keep is not None:
            self.buf_rgb[keep].copy_(rgb)
            self.buf_aux[keep].copy_(aux)
            self.kept[keep] = t
        if self.log is not None:
            self.log.append(t)
        self.present(t)

    def present(self, t: int):
        """The viewer's display of frame ``t``: it waits for the frame
        ``in_flight - 1`` before it to finish (for 1, for frame ``t``)."""
        if self.fences is None:
            _sync(self.device)
            return
        n = self.in_flight
        self.fences[t % n].record(torch.cuda.current_stream(self.device))
        if t >= n - 1:
            self.fences[(t - n + 1) % n].synchronize()

    def release(self):
        self.plans = None

    def check(self, stand_in=None) -> dict:
        """Each kept frame against the reference's render of the same camera
        (and isovalue) on the same bytes: for compositing the largest
        |rgb| and |alpha| gap, for the isosurface the pixels whose hit
        differs or whose rgb differs by more than 1e-4.  ``stand_in``
        "bfloat16" puts the reference in that precision in the program's
        place (the control)."""
        return check_render(self, stand_in)

    def work(self) -> dict:
        frames = self.log or []
        if self.iso_values is None:
            return self._work_composite(frames)
        return self._work_iso(frames)

    def _work_composite(self, frames) -> dict:
        W = self.W["composite"]
        per_cam, out = {}, [0.0, 0.0, 0.0]
        for t in frames:
            i = self.path.index(t)
            if i not in per_cam:
                rays = R.generate_rays(self.path(t), self.device)
                touched = torch.zeros(self.vol_u8.numel(), dtype=torch.bool, device=self.device)
                _, _, n = R.composite(self.vol_u8, rays, self.max_samples, record=touched)
                per_cam[i] = W.march(float(rays.hit.numel()), float(n.sum()),
                                     float(touched.sum()), 1)
            b, o = per_cam[i]
            out = [out[0] + b, out[1] + o, out[2] + least_time(b, o)]
        return {"composite": out, "frame": out}

    def _work_iso(self, frames) -> dict:
        W = self.W["iso"]
        grid = R.block_grid(self.vol_u8)
        grid_bytes = float(grid.numel())
        per_iso, out = {}, {"iso": [0.0] * 3, "bind": [0.0] * 3, "frame": [0.0] * 3}
        bind = W.bind(float(self.vol_u8.numel()), grid_bytes)
        for t in frames:
            iso = self.iso_at(t)
            if (iso, self.path.index(t)) not in per_iso:
                rays = R.generate_rays(self.path(t), self.device)
                touched = torch.zeros(self.vol_u8.numel(), dtype=torch.bool, device=self.device)
                found, near, c = R.iso_march(self.vol_u8, rays, iso, self.max_samples,
                                             grid=grid, record=touched)
                rays_n = float(rays.hit.numel())
                hits = float(found.sum())
                samples = float(((c["steps"] + 1) * rays.hit).sum())
                march = W.march(rays_n, hits, samples, float(c["gathered"].sum()),
                                float(touched.sum()), grid_bytes)
                touched.zero_()
                R.iso_shade(self.vol_u8, rays, found, near, iso, record=touched)
                shade = W.shade(rays_n, hits, float(touched.sum()))
                per_iso[iso, self.path.index(t)] = (march, shade)
            march, shade = per_iso[iso, self.path.index(t)]
            parts = {"iso": [march, shade], "bind": [bind], "frame": [march, shade, bind]}
            for k, works in parts.items():
                for b, o in works:
                    out[k] = [out[k][0] + b, out[k][1] + o, out[k][2] + least_time(b, o)]
        return out

    @classmethod
    def planted_faults(cls) -> dict:
        """Each render's answer altered where it is produced."""
        return {"altered_answer": _altered_answer}


def _altered_answer(program, patch):
    """The program whose plans' ``render`` gives each image with an 8x8
    tile 0.05 darker."""

    def wrap(plan):
        render = plan.render

        def altered(*a, **k):
            rgb, aux = render(*a, **k)
            rgb = rgb.clone()
            rgb[:8, :8] -= 0.05
            return rgb, aux

        plan.render = altered
        return plan

    return types.SimpleNamespace(**{**vars(program),
                                    "plan_compositing": lambda *a, **k: wrap(
                                        program.plan_compositing(*a, **k)),
                                    "IsosurfacePlan": lambda *a, **k: wrap(
                                        program.IsosurfacePlan(*a, **k))})


STAND_INS = {"bfloat16": torch.bfloat16}


def check_render(s: RenderSession, stand_in=None) -> dict:
    """The numbers of :meth:`RenderSession.check`."""
    dtype = STAND_INS[stand_in] if stand_in else torch.float32
    bad, rgb_err, alpha_err = 0, 0.0, 0.0
    for slot, t in sorted(s.kept.items()):
        rays = R.generate_rays(s.path(t), s.device)
        rgb, aux = s.buf_rgb[slot], s.buf_aux[slot]
        if s.iso_values is None:
            rgb_ref, alpha_ref, _ = R.composite(s.vol_u8, rays, s.max_samples)
            if dtype != torch.float32:
                rgb, aux, _ = R.composite(s.vol_u8, rays, s.max_samples, dtype=dtype)
            rgb_err = max(rgb_err, float((rgb - rgb_ref).abs().max()))
            alpha_err = max(alpha_err, float((aux - alpha_ref).abs().max()))
        else:
            iso = s.iso_at(t)
            rgb_ref, found_ref = R.iso_render(s.vol_u8, rays, iso)
            if dtype != torch.float32:
                rgb, aux = R.iso_render(s.vol_u8, rays, iso, dtype=dtype)
            wrong = (aux != found_ref) | ((rgb - rgb_ref).abs().amax(dim=-1) > 1e-4)
            bad += int(wrong.sum())
    if s.iso_values is None:
        return {"rgb_err": rgb_err, "alpha_err": alpha_err}
    return {"iso_bad_px": float(bad)}


class FitSession(Session):
    """The multi-view inverse render: every step renders all views as one
    stacked plan, takes the mean squared error against the targets, its
    gradients to the TF parameters and the volume, and an SGD step.  The
    first ``check_steps`` steps run in set-up through :meth:`frame`, and
    ``check_steps`` more after the window from the state it ended in; of
    each run the program's losses and, per leaf, the norms of its first
    gradient as SGD applied it and of its change are kept for the check."""

    LEAVES = ["alpha_scale", "color_gain", "color_bias", "flip_sign", "flip_bias", "volume"]

    def __init__(self, *a):
        super().__init__(*a)
        fit = self.mix["fit"]
        dev = self.device
        self.cams = list(self.path.cameras)[:int(fit["views"])]
        # the targets: the reference's render of each view at the reference
        # parameters on the seeded volume
        ref_params = [torch.tensor(v, dtype=torch.float32, device=dev)
                      for v in (0.6, 1.0, 0.0, [-1.0, -1.0, 0.0], [1.0, 1.0, 1.0])]
        with torch.no_grad():
            targets = [R.tf_render(ref_params, self.vol_u8, R.generate_rays(c, dev))[0]
                       for c in self.cams]
        self.target = torch.cat(targets, dim=0).contiguous()
        del targets
        # the parameters start from a fixed perturbation, the same for every
        # seed, so that every seed's fit takes the same path in parameter
        # space; the volume's noise is drawn from the seed
        self.params0 = [(p + torch.tensor(d, dtype=torch.float32, device=dev)).contiguous()
                        for p, d in zip(ref_params, fit["perturb"]["params"])]
        self.lr = {"params": float(fit["lr"]["params"]), "volume": float(fit["lr"]["volume"])}
        self.steps = int(fit["check_steps"])
        rays = [self.program_rays(c) for c in self.cams]
        cat = [torch.cat([getattr(r, k) for r in rays], dim=0) for k in
               ("entry_uv", "direction", "hit")]
        del rays
        self.plan = self.P.plan_compositing(*cat, self.dims, self.max_samples)
        del cat
        self.render = self.P.make_render_tf_voxel(self.plan)
        self.leaves = [p.clone().requires_grad_(True) for p in self.params0]
        self.vol = self.volume0().requires_grad_(True)
        self.first, _ = self.program_steps()
        self.end = self.end_start = None
        self.ref = {}
        self.facts = {"first_losses": self.first["losses"]}

    def volume0(self) -> torch.Tensor:
        """The volume the fit starts from, made from the seed (again for the
        check): the field's bytes over 255 plus N(0, ``perturb.volume``)
        noise, clamped to [0, 1], a slab of z at a time."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed ^ 0xF17) % (1 << 63))
        sigma = float(self.mix["fit"]["perturb"]["volume"])
        Z, Y, X = self.vol_u8.shape
        out = torch.empty((Z, Y, X), dtype=torch.float32, device=self.device)
        rows = max(1, R.CHUNK // (Y * X))
        for z0 in range(0, Z, rows):
            z1 = min(Z, z0 + rows)
            noise = torch.randn((z1 - z0, Y, X), generator=gen, device=self.device)
            out[z0:z1] = torch.clamp(self.vol_u8[z0:z1].to(torch.float32) * (1.0 / 255.0)
                                     + sigma * noise, 0.0, 1.0)
        return out

    def current(self) -> list:
        return [p.detach() for p in self.leaves] + [self.vol.detach()]

    def program_steps(self):
        """``check_steps`` steps of the user's loop from the program's
        current state.  Returns (the program's numbers: each step's loss,
        each leaf's first gradient as SGD applied it, norm((before -
        after) / lr), and its change over the steps, norm(after - before);
        the state they started from)."""
        start = [t.clone() for t in self.current()]
        lrs = [self.lr["params"]] * (len(start) - 1) + [self.lr["volume"]]
        losses, grad = [], None
        for _ in range(self.steps):
            self.frame()
            losses.append(float(self.loss))
            if grad is None:
                grad = [R.norm(a, b) / lr for a, b, lr in zip(start, self.current(), lrs)]
        change = [R.norm(b, a) for a, b in zip(start, self.current())]
        return {"losses": losses, "grad": grad, "change": change}, start

    @property
    def cycle(self) -> int:
        return 1

    def frame(self, keep=None):
        with self.span("forward"):
            rgb, _ = self.render(self.P.TFParams(*self.leaves), self.vol)
            loss = torch.mean((rgb - self.target) ** 2)
        with self.span("backward"):
            grads = torch.autograd.grad(loss, [*self.leaves, self.vol])
        with self.span("sgd"), torch.no_grad():
            for leaf, g in zip(self.leaves, grads[:-1]):
                leaf.sub_(self.lr["params"] * g)
            self.vol.sub_(self.lr["volume"] * grads[-1])
        self.loss = loss.detach()
        if self.log is not None:
            self.log.append(self.t)
        self.t += 1

    def after_window(self):
        self.end, self.end_start = self.program_steps()

    def release(self):
        self.plan = self.render = self.leaves = self.vol = self.loss = None

    def check(self, stand_in=None) -> dict:
        """The program's steps against the reference's (:func:`check_fit`);
        ``stand_in`` "bfloat16" (the control) or "half_batch" (the
        reference over half of the views, a planted fault) in the
        program's place."""
        return check_fit(self, stand_in)

    def work(self) -> dict:
        W = self.W["fit"]
        frames = len(self.log or [])
        rays = float(self.target.shape[0] * self.target.shape[1])
        samples, touched_n = 0.0, 0.0
        q = R.quantize(self.volume0())
        touched = torch.zeros(q.numel(), dtype=torch.bool, device=self.device)
        for c in self.cams:
            touched.zero_()
            _, _, n = R.composite(q, R.generate_rays(c, self.device), self.max_samples,
                                  record=touched, alpha_scale=float(self.params0[0]))
            samples += float(n.sum())
            touched_n += float(touched.sum())
        voxels = float(q.numel())
        del q, touched
        fwd, bwd = W.forward(rays, samples, touched_n), W.backward(rays, samples, voxels)
        step = W.step(rays, samples, voxels)
        kernels = [frames * (fwd[0] + bwd[0]), frames * (fwd[1] + bwd[1]),
                   frames * (least_time(*fwd) + least_time(*bwd))]
        return {"fit_kernels": kernels,
                "step": [frames * step[0], frames * step[1], frames * least_time(*step)]}

    @classmethod
    def planted_faults(cls) -> dict:
        """A step that returns its state unchanged; half of the batch left
        out, the loss's mean taken over the rest; and a step gone wrong
        only after set-up: from the window on, each step moves the volume
        twice as far, so the first steps agree with the reference and the
        steps from the state the window ended in do not."""

        def half_batch(program, patch):
            patch(cls, "frame", _half_batch_frame)
            return program

        def wrong_after_set_up(program, patch):
            frame = cls.frame

            def late_double(self, keep=None):
                before = self.vol.detach().clone()
                frame(self, keep)
                if self.t > self.steps:
                    with torch.no_grad():
                        self.vol.add_(self.vol - before)

            patch(cls, "frame", late_double)
            return program

        return {"unchanged_state": _unchanged_state, "half_batch": half_batch,
                "wrong_after_set_up": wrong_after_set_up}


def _unchanged_state(program, patch):
    """The program whose render passes no gradient: every step returns its
    state unchanged."""

    def make(plan):
        f = program.make_render_tf_voxel(plan)

        def g(params, vol):
            rgb, alpha = f(params, vol)
            return rgb - rgb + rgb.detach(), alpha

        return g

    return types.SimpleNamespace(**{**vars(program), "make_render_tf_voxel": make})


def _half_batch_frame(self, keep=None):
    """:meth:`FitSession.frame` with the loss's mean over the first half of
    the rays alone."""
    h = self.target.shape[0] // 2
    rgb, _ = self.render(self.P.TFParams(*self.leaves), self.vol)
    loss = torch.mean((rgb[:h] - self.target[:h]) ** 2)
    grads = torch.autograd.grad(loss, [*self.leaves, self.vol])
    with torch.no_grad():
        for leaf, g in zip(self.leaves, grads[:-1]):
            leaf.sub_(self.lr["params"] * g)
        self.vol.sub_(self.lr["volume"] * grads[-1])
    self.loss = loss.detach()
    self.t += 1


def check_fit(s: FitSession, stand_in=None) -> dict:
    """The program's steps against the reference's, from the start the
    benchmark made and again from the state the window ended in (the
    numbers of the latter end in ``.end``): each step's loss (the largest
    gap over the reference's), the first gradient as SGD applied it and
    the change after the last step, each by the worst leaf: |norm(program)
    - norm(reference)| over the larger of the reference's norm of that leaf
    and of the median leaf.  Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out."""
    views = [R.generate_rays(c, s.device) for c in s.cams]
    H = s.target.shape[0] // len(s.cams)
    targets = list(torch.split(s.target, H, dim=0))
    out, detail = {}, {"leaves": FitSession.LEAVES}
    runs = [("", lambda: s.params0 + [s.volume0()], s.first)]
    if s.end is not None:
        runs.append((".end", lambda: s.end_start, s.end))
    for tag, start_of, prog in runs:
        start = start_of()

        def steps(views_, targets_, dtype=torch.float32):
            losses, grad, params, volume = R.fit_steps(start[:-1], start[-1], views_, targets_,
                                                       s.lr, s.steps, dtype=dtype)
            change = [R.norm(b, a) for a, b in zip(start, params + [volume])]
            return {"losses": losses, "grad": grad, "change": change}

        if tag not in s.ref:  # the reference's steps, kept for the stand-ins' checks
            s.ref[tag] = steps(views, targets)
        ref = s.ref[tag]
        if stand_in is not None:
            half = len(views) // 2 if stand_in == "half_batch" else len(views)
            prog = steps(views[:half], targets[:half], STAND_INS.get(stand_in, torch.float32))
        del start
        g_ref, c_ref = ref["grad"], ref["change"]
        med_g = sorted(g_ref)[len(g_ref) // 2]
        med_c = sorted(c_ref)[len(c_ref) // 2]
        keep = [i for i, g in enumerate(g_ref) if g >= 1e-3 * med_g]
        detail[tag or "start"] = {"grad_norm_ref": g_ref, "grad_norm": prog["grad"],
                                  "change_norm_ref": c_ref, "change_norm": prog["change"],
                                  "losses_ref": ref["losses"], "losses": prog["losses"]}
        out["loss_gap" + tag] = max(abs(a - b) / abs(b)
                                    for a, b in zip(prog["losses"], ref["losses"]))
        out["grad_gap" + tag] = max(abs(prog["grad"][i] - g_ref[i]) / max(g_ref[i], med_g)
                                    for i in keep)
        out["change_gap" + tag] = max(abs(prog["change"][i] - c_ref[i]) / max(c_ref[i], med_c)
                                      for i in keep)
    s.check_detail = detail
    return out


SESSIONS = {"composite": RenderSession, "iso": RenderSession, "fit": FitSession}


def session_class(render: str, bench_dir=BENCH_DIR) -> type:
    """The session class of a mix's ``render``: its entry in
    :data:`SESSIONS`, else the ``Session`` class of ``sessions/<render>.py``
    under ``bench_dir``, a subclass of :class:`Session` (as a rule of
    :class:`RenderSession` or :class:`FitSession`)."""
    if render in SESSIONS:
        return SESSIONS[render]
    module = load_named(bench_dir, "sessions", render)
    cls = getattr(module, "Session", None)
    if not (isinstance(cls, type) and issubclass(cls, Session)):
        raise TypeError(f"{module.__file__} has no class Session that subclasses "
                        f"vrbench.traffic.Session")
    return cls


def make_session(cfg, mix, seed, device, program, span, work, bench_dir=BENCH_DIR) -> Session:
    """The session of the mix; ``program`` None: the entry points its class
    loads."""
    cls = session_class(mix["render"], bench_dir)
    return cls(cfg, mix, seed, device, program or cls.load_program(), span, work, bench_dir)
