"""The port's ``DebugTimer``, ``timed`` and ``Metrics`` against the JAX
package's: seconds reported, a ``torch.profiler`` trace written on the CPU,
the same prints and the same JSON."""
import json
import os

import jax.numpy as jnp
import torch

from volumerenderer_tpu.utils import timer as JT
from volumerenderer_tpu_torch.utils import timer as TT


def test_timed_reports_seconds():
    TT.DebugTimer.reset()
    with TT.timed("phase", report_every=10) as r:
        _ = torch.ones((8, 8)).sum()
    assert r["seconds"] >= 0.0 and "trace_dir" not in r
    assert TT.DebugTimer.mean_ms("phase") >= 0.0


def test_timed_profile_writes_trace(tmp_path):
    TT.DebugTimer.reset()
    tdir = str(tmp_path / "trace")
    with TT.timed("traced_phase", profile=True, profile_dir=tdir) as r:
        x = torch.ones((64, 64)) @ torch.ones((64, 64))
    assert float(x[0, 0]) == 64.0
    assert r["trace_dir"] == tdir and r["seconds"] >= 0.0
    assert os.path.dirname(r["trace_file"]) == tdir and os.path.getsize(r["trace_file"]) > 0
    with open(r["trace_file"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "traced_phase" in names  # the scope's record_function


def test_end_prints_as_jax(capsys):
    for mod in (JT, TT):
        mod.DebugTimer.reset()
        for _ in range(4):
            mod.DebugTimer.begin(2, "LOOP")
            mod.DebugTimer.end("LOOP", sync=torch.zeros(2) if mod is TT else jnp.zeros(2))
        lines = capsys.readouterr().out.splitlines()
        assert len(lines) == 2 and all(ln.startswith("[LOOP] mean ") for ln in lines)
        assert lines[1].split(" ms over ")[1].startswith("4 calls")
        assert mod.DebugTimer._timers["LOOP"].count == 4
    TT.DebugTimer.reset()


def test_end_syncs_nested_cpu_tensors():
    TT.DebugTimer.reset()
    TT.DebugTimer.begin(1, "x")
    dt = TT.DebugTimer.end("x", sync={"a": (torch.ones(2), [torch.zeros(1)]), "b": 3})
    assert dt >= 0.0


def test_metrics_json_equals_jax():
    values = dict(volume_gb=0.016777216, num_active_nodes=25339,
                  compressed_bits_per_voxel=12.37255859375, frame_ms=1.5, name="run")
    j, t = JT.Metrics(), TT.Metrics()
    for m in (j, t):
        m.record(**values)
        m.record(frame_ms=2.25)
    assert t.json() == j.json()
    assert json.loads(t.json())["frame_ms"] == 2.25
