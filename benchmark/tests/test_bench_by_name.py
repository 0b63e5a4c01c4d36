"""A configuration, a traffic mix, a session and a volume generator added to
the benchmark as new files only: a copy of the benchmark's directory in a
temporary one, with a soft sphere of bytes made by a generator of its own
and a session of its own that renders each frame from the volume's z-slab
pool (B7 on the card), run to ``correct`` windowed and traced, and its own
planted fault refused.  A name that has no file fails at set-up with the
path it looked for."""
import copy
import hashlib
import json
import re
import shutil
import time

import pytest
import torch

import tiny

GENERATOR = '''"""soft_sphere: bytes 255 at the centre falling linearly to 0 at
``radius`` (a share of the half-width), each byte inside moved by the seed's
noise in [-noise, noise]."""
import torch


def make(spec, seed, device):
    Z, Y, X = (int(n) for n in spec["shape"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    z, y, x = torch.meshgrid(*(torch.linspace(-1.0, 1.0, n, device=device) for n in (Z, Y, X)),
                             indexing="ij")
    v = torch.clamp(255.0 * (1.0 - torch.sqrt(x * x + y * y + z * z) / spec["radius"]), 0, 255)
    noise = torch.randint(-spec["noise"], spec["noise"] + 1, v.shape, generator=gen,
                          device=device)
    return torch.where(v > 0, torch.clamp(v.round() + noise, 0, 255), 0).to(torch.uint8)
'''

SESSION = '''"""pooled_orbit: a compositing render a frame from the volume's pair16
z-slab pool, built once in set-up."""
import types

from vrbench import traffic


class Session(traffic.RenderSession):
    def __init__(self, *a):
        super().__init__(*a)
        self.buf_aux = self.buf_aux.to(self.buf_rgb.dtype)  # alpha, not the iso hit
        self.pool, self.slab_map = self.P.build_slab_pool(self.vol_u8)

    @classmethod
    def load_program(cls):
        from volumerenderer_tpu_torch.ops.cuda.raycast_kernel import build_slab_pool

        return types.SimpleNamespace(**vars(super().load_program()),
                                     build_slab_pool=build_slab_pool)

    @staticmethod
    def shrink(cfg, mix):
        cfg["volume"]["shape"] = [32, 32, 32]
        cfg["image"] = [20, 16]
        mix["trace"] = {"warm": 2, "frames": 4}

    @classmethod
    def planted_faults(cls):
        return {"altered_pooled_answer": altered_pooled_answer}

    def frame(self, keep=None):
        t = self.t
        self.t += 1
        with self.span("render"):
            rgb, alpha = self.plans[self.path.index(t)].render_pooled(self.pool, self.slab_map)
        if keep is not None:
            self.buf_rgb[keep].copy_(rgb)
            self.buf_aux[keep].copy_(alpha)
            self.kept[keep] = t
        if self.log is not None:
            self.log.append(t)
        self.present(t)

    def release(self):
        super().release()
        self.pool = self.slab_map = None


def altered_pooled_answer(program, patch):
    def plan(*a, **k):
        p = program.plan_compositing(*a, **k)
        render = p.render_pooled

        def altered(*a, **k):
            rgb, alpha = render(*a, **k)
            rgb = rgb.clone()
            rgb[:8, :8] -= 0.05
            return rgb, alpha

        p.render_pooled = altered
        return p

    return types.SimpleNamespace(**{**vars(program), "plan_compositing": plan})
'''

READERS = {
    "frames_per_s.pooled_orbit": "def read(run):\n"
                                 "    return run.window.frames / run.window.seconds\n",
    "device_idle_pct.pooled_orbit": "def read(run):\n"
                                    "    t = run.trace\n"
                                    "    return 100.0 * (1.0 - t.busy_s / t.window_s)\n",
}
CELL = "sphere.pooled_orbit"


def _files(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def added(tmp_path_factory):
    """(BENCHMARK.json's dict, the benchmark directory) of a copy of the
    benchmark with the new cell and two cells whose names have no file, all
    as new files; the copy's other files are the repository's, byte for
    byte."""
    root = tmp_path_factory.mktemp("bench")
    bench_dir = root / "benchmark"
    shutil.copytree(tiny.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = _files(bench_dir)
    bench = copy.deepcopy(tiny.BENCH)
    rm384 = json.loads((tiny.ROOT / bench["configs"][0]["file"]).read_text())
    new = {
        "generators/soft_sphere.py": GENERATOR,
        "sessions/pooled_orbit.py": SESSION,
        "traffic/pooled_orbit.json": {
            "render": "pooled_orbit", "camera": {"path": "orbit", "count": 4, "step_deg": 2.0},
            "check": {"frames": 2}, "limits": {"rgb_err": 1e-4, "alpha_err": 1e-4}},
        "traffic/no_session.json": {"render": "no_such_session", "camera": {"path": "fixed"},
                                    "check": {"frames": 1}, "limits": {}},
        **{f"metrics/{name}.py": code for name, code in READERS.items()},
    }
    for name, kind in (("sphere_u8", "soft_sphere"), ("nothing_u8", "no_such_kind")):
        cfg = {**rm384, "name": name, "source": "the benchmark's test",
               "volume": {"kind": kind, "shape": [512, 512, 512], "dtype": "uint8",
                          "radius": 0.8, "noise": 2}}
        new[f"configs/{name}.json"] = cfg
        bench["configs"].append({"name": name, "source": "the benchmark's test",
                                 "file": f"benchmark/configs/{name}.json", "reduced": [],
                                 "why": "a cell added as new files"})
    for cell, config, mix in ((CELL, "sphere_u8", "pooled_orbit"),
                              ("sphere.no_session", "sphere_u8", "no_session"),
                              ("nothing.pooled_orbit", "nothing_u8", "pooled_orbit")):
        bench["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1,
                                   "why": "a cell added as new files"})
    bench["end_to_end"].append({"name": "frames_per_s.pooled_orbit", "unit": "frames/s",
                                "better": "higher", "bound": 0.01, "source": "host_clock",
                                "workloads": [CELL]})
    bench["per_layer"].append({"name": "device_idle_pct.pooled_orbit", "unit": "%",
                               "better": "lower", "source": "device_trace", "layer": "device",
                               "moves": "frames_per_s.pooled_orbit", "workloads": [CELL]})
    for rel, body in new.items():
        path = bench_dir / rel
        path.parent.mkdir(exist_ok=True)
        path.write_text(body if isinstance(body, str) else json.dumps(body))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _files(bench_dir)
    assert set(after) == set(before) | set(new)
    assert all(after[rel] == digest for rel, digest in before.items())
    return bench, bench_dir


@pytest.fixture
def repo_unchanged():
    files = _files(tiny.BENCH_DIR)
    yield
    assert _files(tiny.BENCH_DIR) == files


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
def test_a_cell_added_as_new_files_runs_correct(added, repo_unchanged, trace):
    bench, bench_dir = added
    result, checks, _ = tiny.run(CELL, trace=trace, bench=bench, bench_dir=bench_dir)
    assert result["correct"], checks
    assert set(checks) == {"rgb_err", "alpha_err"} and result["attempted"] > 0
    want = {"device_idle_pct.pooled_orbit"} if trace else {"frames_per_s.pooled_orbit",
                                                            "setup_s"}
    assert set(result["metrics"]) == want


def test_the_added_sessions_fault_is_refused(added, repo_unchanged, monkeypatch):
    bench, bench_dir = added
    cls = tiny.session_class(CELL, bench, bench_dir)
    assert cls.__module__.startswith("_vrbench_sessions_")
    program = cls.planted_faults()["altered_pooled_answer"](cls.load_program(),
                                                            monkeypatch.setattr)
    result, checks, _ = tiny.run(CELL, program=program, bench=bench, bench_dir=bench_dir)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell,missing", [("sphere.no_session", "sessions/no_such_session.py"),
                                          ("nothing.pooled_orbit",
                                           "generators/no_such_kind.py")],
                         ids=["session", "generator"])
def test_a_name_with_no_file_fails_at_set_up(added, cell, missing):
    from vrbench import harness

    bench, bench_dir = added
    with pytest.raises(FileNotFoundError, match=re.escape(str(bench_dir / missing))):
        harness.run_cell(bench, cell, 2147483900, 0.3, False, torch.device("cpu"),
                         time.perf_counter(), quiet=True, bench_dir=bench_dir)
