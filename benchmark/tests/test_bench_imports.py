"""Nothing the benchmark runs imports JAX or the JAX package: after a whole
tiny run on the CPU (set-up, window, trace, check, every metric reader and
work count), no loaded module's top-level name is one of them.  Names are
compared whole, since the port's name begins with the JAX package's."""
import subprocess
import sys
import textwrap

from tiny import ROOT
from vrbench import harness


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["volumerenderer_tpu_torch", "volumerenderer_tpu_torch.ops",
                                      "benchmark_x", "jaxtyping"]) == []
    assert harness.forbidden_modules(["volumerenderer_tpu.ops.raycast", "jax.numpy", "bench",
                                      "__graft_entry__", "flax"]) == [
        "__graft_entry__", "bench", "flax", "jax", "volumerenderer_tpu"]


def test_a_whole_run_loads_no_forbidden_module():
    code = textwrap.dedent(f"""
        import sys
        sys.path[:0] = [{str(ROOT / "benchmark" / "tests")!r}, {str(ROOT / "benchmark")!r},
                        {str(ROOT)!r}]
        import tiny
        from vrbench import harness
        for cell in tiny.CELLS:
            for trace in (False, True):
                tiny.run(cell, trace=trace)
        for m in tiny.BENCH["end_to_end"] + tiny.BENCH["per_layer"]:
            harness.reader(m["name"])
        harness.work_modules()
        print("FORBIDDEN", harness.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout[-2000:]
