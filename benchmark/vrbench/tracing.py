"""Reading a ``torch.profiler`` trace of the traced window.

The harness marks the window (``window``, closed after the card has
finished), each frame or step (``frame``), and its own ranges around the
calls into each layer of the program (``plan``, ``bind``, ``render``,
``iso_render``, ``forward``, ``backward``, ``sgd``).  :class:`Trace` takes
the chrome trace the profiler exports and answers what the per-layer
readers ask:

* ``device_s(range, launcher)``: the card's time of the kernels (and copies
  and fills) whose launch on the host lies inside the harness's range,
  whichever thread launched them (autograd's backward runs on a thread of
  its own); ``launcher="torch"`` keeps those launched inside a PyTorch
  operator (``aten::``), ``"program"`` those the program launched itself;
* ``host_s(range)``: the host's time inside the range;
* ``busy_s``, ``window_s``: the union of the card's activity within the
  window, and the window's length;
* ``breakdown()``: the device operations that took most time, and the
  longest idle gaps by what the host was doing.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Trace:
    def __init__(self, trace_events: list, frames: int):
        self.frames = frames
        events = [e for e in trace_events if e.get("ph") == "X" and "dur" in e]
        windows = [e for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == "window"]
        if len(windows) != 1:
            raise ValueError(f"the trace holds {len(windows)} window ranges, not 1")
        w = windows[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.main_tid = w.get("tid")
        self.window_s = (self.t1 - self.t0) * 1e-6
        self.ranges = defaultdict(list)
        self.host_events = defaultdict(list)  # tid -> [(ts, end, name, cat)]
        launch = {}
        for e in events:
            cat = e.get("cat")
            ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if cat == "user_annotation":
                self.ranges[e["name"]].append((ts, end))
            if cat in HOST_CATS:
                self.host_events[e.get("tid")].append((ts, end, e.get("name", ""), cat))
            if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = (ts, e.get("tid"))
        for lst in self.host_events.values():
            lst.sort()
        self.device = []  # (start, end, name, launch_ts, launch_tid)
        for e in events:
            if e.get("cat") in DEVICE_CATS:
                ts = float(e["ts"])
                lt, tid = launch.get(e.get("args", {}).get("correlation"), (None, None))
                self.device.append((ts, ts + float(e["dur"]), e.get("name", ""), lt, tid))
        self.device.sort()
        self.busy_s = self._union_s([(a, b) for a, b, *_ in self.device])

    def _union_s(self, intervals) -> float:
        total, cur_a, cur_b = 0.0, None, None
        for a, b in sorted(intervals):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    total += cur_b - cur_a
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
        if cur_b is not None:
            total += cur_b - cur_a
        return total * 1e-6

    def _inside(self, name: str, ts) -> bool:
        return ts is not None and self.t0 <= ts <= self.t1 and any(
            a <= ts <= b for a, b in self.ranges.get(name, ()))

    def _innermost(self, tid, ts, cats):
        """The name of the innermost host event of ``cats`` on thread
        ``tid`` that holds the moment ``ts``, or None."""
        best = None
        lst = self.host_events.get(tid, [])
        i = bisect.bisect_right(lst, (ts, float("inf")))
        for a, b, name, cat in lst[max(0, i - 4096):i]:
            if cat in cats and a <= ts <= b and (best is None or a >= best[0]):
                best = (a, name)
        return None if best is None else best[1]

    def launched_by_torch(self, launch_ts, tid) -> bool:
        name = self._innermost(tid, launch_ts, ("cpu_op",))
        return name is not None and name.startswith("aten::")

    def device_s(self, *names: str, launcher: str | None = None) -> float:
        """Seconds of device activity launched inside any of the ranges
        ``names`` within the window; ``launcher`` "torch" or "program"
        keeps one side."""
        total = 0.0
        for a, b, _, lt, tid in self.device:
            if not any(self._inside(n, lt) for n in names):
                continue
            if launcher is not None and self.launched_by_torch(lt, tid) != (launcher == "torch"):
                continue
            total += b - a
        return total * 1e-6

    def host_s(self, name: str) -> float:
        """Seconds the host spent inside the range ``name`` within the window."""
        return sum(min(b, self.t1) - max(a, self.t0) for a, b in self.ranges.get(name, ())
                   if b > self.t0 and a < self.t1) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(float)
        for a, b, name, *_ in self.device:
            lo, hi = max(a, self.t0), min(b, self.t1)
            if hi > lo:
                ops[name[:120]] += (hi - lo) * 1e-6
        gaps = defaultdict(float)
        cursor = self.t0
        for a, b, *_ in self.device + [(self.t1, self.t1)]:
            if a > cursor:
                gaps[self._host_doing((cursor + a) / 2)] += (min(a, self.t1) - cursor) * 1e-6
            cursor = max(cursor, b)
            if cursor >= self.t1:
                break
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}

    def _host_doing(self, ts) -> str:
        ranges = [(a, n) for n, lst in self.ranges.items() if n not in ("window", "frame")
                  for a, b in lst if a <= ts <= b]
        rng = max(ranges)[1] if ranges else None
        op = self._innermost(self.main_tid, ts, ("cpu_op", "cuda_runtime", "cuda_driver"))
        parts = [p for p in (rng, op) if p]
        return " / ".join(parts) if parts else "python between calls"


def load(path: str, frames: int) -> Trace:
    with open(path) as f:
        return Trace(json.load(f)["traceEvents"], frames)
