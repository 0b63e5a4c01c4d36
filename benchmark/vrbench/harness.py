"""One run of one cell: set-up, a warm-up to a steady allocator, the measured
(or traced) window, the check against the plain reference, and the result.

Everything that belongs to one configuration, traffic mix or metric is found
by name: ``configs/<config>.json`` (the file ``BENCHMARK.json`` names),
``traffic/<mix>.json``, ``metrics/<metric>.py`` (a ``read(run)`` that
returns the metric's value or None), ``work/<layer>.py`` (the work counts
the rooflines divide), and, beside the built-in ones, a mix's session
``sessions/<render>.py`` (:func:`traffic.session_class`) and a volume's
generator ``generators/<kind>.py`` (:func:`volumes.make`).
"""
from __future__ import annotations

import contextlib
import gc
import json
import os
import statistics
import sys
import tempfile
import time
import types
from pathlib import Path

import torch

from . import host, tracing
from . import traffic as traffic_mod
from .named import BENCH_DIR, load_module

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "volumerenderer_tpu", "bench", "__graft_entry__"})


def forbidden_modules(modules=None) -> list:
    """The top-level names of loaded modules that the benchmark must not
    load: JAX and the JAX package (compared whole: the port's name begins
    with the JAX package's)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    """The metric entries this cell reports: with ``trace`` its per-layer
    metrics, else its end-to-end metrics."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def load_cell(bench: dict, name: str, bench_dir: Path = BENCH_DIR):
    """(cell, configuration, mix) of the workload ``name``."""
    cell = find_cell(bench, name)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((bench_dir.parent / conf["file"]).read_text())
    mix = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, mix


def work_modules(bench_dir: Path = BENCH_DIR) -> dict:
    return {p.stem: load_module(p, "work") for p in sorted((bench_dir / "work").glob("*.py"))}


def reader(name: str, bench_dir: Path = BENCH_DIR):
    return load_module(bench_dir / "metrics" / f"{name}.py", "metric").read


class Spans:
    """``spans(name)``: a ``torch.profiler.record_function`` range when on,
    else nothing."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def note(obj: dict) -> None:
    print("# " + json.dumps(obj), flush=True)


def run_window(session, seconds: float, keep: dict, device):
    """The user's loop for ``seconds``: frames until the host clock passes the
    window's end, then the card drained.  Returns the window record: frames,
    seconds (all of them, to the drained card), each frame's host time from
    its issue to the end of the wait that displays it (its own sync, or,
    with frames in flight, the sync of the frame before it), and frames
    issued in each second."""
    _sync(device)
    lat, n = [], 0
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        session.frame(keep.get(n))
        b = time.perf_counter()
        lat.append(b - a)
        n += 1
        if b - t0 >= seconds:
            break
    _sync(device)
    t1 = time.perf_counter()
    per_second = [0] * (int(seconds) + 1)
    acc = t0
    for x in lat:
        acc += x
        per_second[min(int(acc - t0), len(per_second) - 1)] += 1
    return types.SimpleNamespace(frames=n, seconds=t1 - t0, latencies=lat,
                                 per_second=per_second)


def run_traced(session, spans: Spans, warm: int, frames: int, keep: dict, device, tmpdir):
    """``warm`` frames under the profiler (its first records are lost), then
    the ``window`` range: ``frames`` frames, each in a ``frame`` range, and
    the card drained.  Returns the :class:`tracing.Trace`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        for _ in range(warm):
            session.frame()
        _sync(device)
        session.log = []
        with record_function("window"):
            for i in range(frames):
                with record_function("frame"):
                    session.frame(keep.get(i))
            _sync(device)
    path = os.path.join(tmpdir, "trace.json")
    prof.export_chrome_trace(path)
    return tracing.load(path, frames)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, program=None, bench_dir: Path = BENCH_DIR, quiet: bool = False,
             edit=None, stand_ins=(), detail=None):
    """One run of the cell ``name``.  Returns (result dict for the last line,
    checks dict of name -> {"value", "limit"}, the numbers of each of
    ``stand_ins`` put in the program's place: the control and planted
    faults, which ``control.py`` reads).  ``program`` stands in for the
    entry points the cell's session class loads (``load_program``) and
    ``edit(cfg, mix)`` changes the cell's sizes:
    both for the tests, which run tiny cells on the CPU.  ``detail``, a
    dict, receives what the check saw beyond its numbers (a fit's per-leaf
    norms)."""
    say = (lambda obj: None) if quiet else note
    t_enter = time.perf_counter()
    cell, cfg, mix = load_cell(bench, name, bench_dir)
    if edit is not None:
        edit(cfg, mix)
    if device.type == "cuda":
        pinned = host.pin(device.index or 0)
        say({"host": pinned})
    spans = Spans(trace)
    session = traffic_mod.make_session(cfg, mix, seed, device, program, spans,
                                       work_modules(bench_dir), bench_dir)
    _sync(device)
    t_session = time.perf_counter()
    warm_frames = host.warm(session.frame, device, min_frames=max(session.cycle, 3))
    _sync(device)
    warm_s = time.perf_counter() - t_session
    gc.collect()
    gc.freeze()
    tr = mix.get("trace", {})
    n_traced = int(tr.get("frames", 16))
    expected = n_traced if trace else max(1, int(0.8 * seconds * warm_frames / max(warm_s, 1e-9)))
    keep = {t: slot for slot, t in enumerate(session.check_frames(expected))}
    setup_s = time.perf_counter() - t_start
    smi_before = host.smi() if device.type == "cuda" else "no card"
    if device.type == "cuda":  # the served state's peak: set-up's temporaries left out
        torch.cuda.reset_peak_memory_stats(device)
    window = trace_obj = None
    with tempfile.TemporaryDirectory() as tmpdir:
        if trace:
            trace_obj = run_traced(session, spans, int(tr.get("warm", 4)), n_traced, keep,
                                   device, tmpdir)
        else:
            window = run_window(session, seconds, keep, device)
    smi_after = host.smi() if device.type == "cuda" else "no card"
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)
    session.after_window()
    session.release()
    gc.collect()
    t_check = time.perf_counter()
    numbers = session.check()
    check_s = time.perf_counter() - t_check
    limits = mix["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in sorted(numbers)}
    failed = [k for k, c in checks.items() if not (c["value"] <= c["limit"])]
    if detail is not None:
        detail.update(getattr(session, "check_detail", {}))
    stand_in_numbers = {k: session.check(k) for k in stand_ins}
    facts = {"cell": name, "seed": seed, "smi_before": smi_before, "smi_after": smi_after,
             "warm_frames": warm_frames, "warm_s": warm_s, "setup_s": setup_s, "check_s": check_s,
             "setup_parts_s": {"to_the_cell": t_enter - t_start, "session": t_session - t_enter,
                               "warm": warm_s},
             "kept_frames": sorted(session.kept.values()), **getattr(session, "facts", {})}
    run = types.SimpleNamespace(setup_s=setup_s, window=window, trace=trace_obj, work={})
    if trace:
        run.work = session.work()
        facts.update({"traced_frames": n_traced, "work": run.work})
    else:
        lat = sorted(window.latencies)
        facts.update({"frames": window.frames, "window_s": window.seconds,
                      "per_second": window.per_second,
                      "frame_ms_median": 1e3 * statistics.median(lat),
                      "host_frame_ms_max": 1e3 * lat[-1]})
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        value = reader(m["name"], bench_dir)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    attempted = window.frames if window is not None else n_traced
    result = {"correct": not failed, "attempted": attempted, "failed": len(failed),
              "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = trace_obj.busy_s
        dev["window_s"] = trace_obj.window_s
        result["breakdown"] = trace_obj.breakdown()
    result["checks"] = checks
    say(facts)
    return result, checks, stand_in_numbers


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f"modules loaded that the benchmark must not load: {names}")
        self.names = names


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by ``statistics.quantiles`` (exclusive
    method), over 100 cut points."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100)[int(round(q)) - 1]
