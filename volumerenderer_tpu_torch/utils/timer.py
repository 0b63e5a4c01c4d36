"""Phase timing: the reference ``DebugTimer`` (``DebugTimer.cpp:6-31``), a
label -> accumulated wall time map that prints the mean ms and rate every
n-th ``end``, with an optional ``torch.profiler`` trace of a scope; and
:func:`span`, the named ranges of the program's own work that a profiler
sees beside the card's kernels.

Counterpart of ``volumerenderer_tpu/utils/timer.py``, with the same labels,
prints and JSON.  PyTorch returns before the card finishes, so ``end`` takes
the scope's result (``sync``) and waits for the CUDA devices its tensors lie
on before it reads the clock, as the reference waits on ``glFinish``
(``main.cpp:377-408``).  Tensors on the CPU need no wait.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

__all__ = ["DebugTimer", "timed", "Metrics", "span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A named range of the program's work, to be entered with ``with``.
    While a profiler is active (``torch.profiler.profile``, or
    ``torch.autograd.profiler.emit_nvtx`` for NVTX), a
    ``record_function(name)`` range: a ``user_annotation`` on the
    profiler's clock, the clock of its CUDA kernel records, and the
    kernels launched inside it are the range's.  Otherwise one shared no-op
    context, for the cost of one check of the profiler's state.  It never
    synchronises, allocates on a device or reads a tensor.  The program's
    names start with ``vr.``."""
    if _profiler_enabled():
        return record_function(name)
    return _OFF


@dataclass
class _Entry:
    report_every: int = 1
    count: int = 0
    total: float = 0.0
    start: float = 0.0


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _synchronize(x) -> None:
    """Wait for every CUDA device that holds a tensor of ``x`` (a tensor, or
    lists, tuples and dicts of them, named tuples too)."""
    for device in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(device)


class DebugTimer:
    """Static label -> timer map, like the reference's ``DebugTimer::Begin/End``."""

    _timers: dict[str, _Entry] = {}
    verbose: bool = True

    @classmethod
    def begin(cls, report_every: int, label: str) -> None:
        e = cls._timers.setdefault(label, _Entry(report_every=report_every))
        e.report_every = report_every
        e.start = time.perf_counter()

    @classmethod
    def end(cls, label: str, sync: object = None) -> float:
        """Close the scope ``label`` after ``sync``'s CUDA devices finish;
        returns its seconds."""
        if sync is not None:
            _synchronize(sync)
        e = cls._timers[label]
        dt = time.perf_counter() - e.start
        e.total += dt
        e.count += 1
        if e.count % e.report_every == 0:
            mean_ms = e.total / e.count * 1000.0
            if cls.verbose:
                fps = 1000.0 / mean_ms if mean_ms > 0 else float("inf")
                print(f"[{label}] mean {mean_ms:.3f} ms over {e.count} calls ({fps:.1f}/s)")
        return dt

    @classmethod
    def mean_ms(cls, label: str) -> float:
        e = cls._timers[label]
        return e.total / max(e.count, 1) * 1000.0

    @classmethod
    def reset(cls) -> None:
        cls._timers.clear()


@contextlib.contextmanager
def timed(label: str, sync_value=None, report_every: int = 1,
          profile: bool = False, profile_dir: str | None = None):
    """Timed scope, yielding a dict that gets ``seconds`` at its end.  With
    ``profile=True`` the scope also runs under ``torch.profiler.profile``
    (the CPU, and the CUDA devices where there are any) inside a
    ``record_function(label)``, and its Chrome trace is written to
    ``<profile_dir>/<label>.pt.trace.json`` (``profile_dir`` defaults to
    ``<temp dir>/vrtpu_trace/<label>``); ``trace_dir`` and ``trace_file``
    name them.  The seconds include writing the trace, as the JAX timer's
    include its trace's.  On the H100 (torch 2.11) a profiler run that
    follows GPU work done while nothing was profiled can lose the records of
    its first kernels (from 1 to 27 of them were lost), so a scope whose
    trace must hold given kernels launches a few hundred small ones before
    them (``scripts/torch_profiler_probe.py``)."""
    from torch.profiler import ProfilerActivity

    DebugTimer.begin(report_every, label)
    result = {}
    try:
        if not profile:
            yield result
        else:
            tdir = profile_dir or os.path.join(tempfile.gettempdir(), "vrtpu_trace", label)
            os.makedirs(tdir, exist_ok=True)
            result["trace_dir"] = tdir
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities) as prof:
                with record_function(label):
                    yield result
                if sync_value is not None:
                    _synchronize(sync_value)
            result["trace_file"] = os.path.join(tdir, f"{label}.pt.trace.json")
            prof.export_chrome_trace(result["trace_file"])
    finally:
        result["seconds"] = DebugTimer.end(label, sync=sync_value)


@dataclass
class Metrics:
    """Structured per-phase metrics (error, compression, rates), emitted as
    JSON in place of the reference's prints
    (``VolumeKdTree_recover.cpp:71-84,115-129,134-139``)."""

    values: dict = field(default_factory=dict)

    def record(self, **kwargs) -> None:
        self.values.update(kwargs)

    def json(self) -> str:
        return json.dumps(self.values, sort_keys=True)

    def print(self) -> None:
        print(self.json())
