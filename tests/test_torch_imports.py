"""The port stands alone: it imports neither jax nor ``volumerenderer_tpu``,
and importing its kernel modules needs no CUDA compiler."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "volumerenderer_tpu_torch"


def test_port_imports_without_jax():
    """Every module of the port, found by walking the package (the sharded
    layouts, the multi-process layer, ``dryrun_multichip``, the segment
    kernels' wrappers and the application layer included)."""
    code = ("import importlib, pkgutil, sys, volumerenderer_tpu_torch as P; "
            "names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')]; "
            "[importlib.import_module(n) for n in names]; "
            "need = {'volumerenderer_tpu_torch.parallel.kernel_sharded', "
            "'volumerenderer_tpu_torch.parallel.bricks', "
            "'volumerenderer_tpu_torch.parallel.context', "
            "'volumerenderer_tpu_torch.parallel.sharding', "
            "'volumerenderer_tpu_torch.ops.cuda.seg_kernel', "
            "'volumerenderer_tpu_torch.interop', 'volumerenderer_tpu_torch.app', "
            "'volumerenderer_tpu_torch.config', 'volumerenderer_tpu_torch.io.streaming', "
            "'volumerenderer_tpu_torch.codecs.reference_impl', "
            "'volumerenderer_tpu_torch.utils.timer', 'volumerenderer_tpu_torch.native', "
            "'volumerenderer_tpu_torch.parallel.multihost', 'volumerenderer_tpu_torch.entry'}; "
            "assert need <= set(names), need - set(names); "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'volumerenderer_tpu' or m.startswith('volumerenderer_tpu.')); "
            "assert not bad, bad")
    # no nvcc reachable: importing must not try to build anything
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "PYTHONPATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("script", ["torch_rm_smoke", "torch_render_demo"])
def test_port_scripts_import_without_jax(script):
    """The RM smoke test's and the render demo's modules (imported by the
    tests and ``chip_smoke.py``) load neither jax, the JAX package nor PIL."""
    code = (f"import sys; sys.path.insert(0, 'scripts'); import {script}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'volumerenderer_tpu', 'PIL')); assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "PYTHONPATH")}
    env["PATH"] = os.path.dirname(sys.executable)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("pattern", [r"\bimport\s+jax\b", r"\bfrom\s+jax\b",
                                     r"\bvolumerenderer_tpu\.",
                                     r"\b(import|from)\s+volumerenderer_tpu\b(?!_torch)",
                                     r"\b(import|from)\s+PIL\b"])
def test_port_sources_never_name_jax_modules(pattern):
    """Prose names a JAX counterpart by its path (``volumerenderer_tpu/...``),
    so any dotted module name or import of jax is an import in the making.
    The port's scripts are scanned too, and nothing imports PIL: the render
    demo writes its PNGs itself, so the port needs no imaging library."""
    sources = [p for p in PACKAGE.rglob("*") if p.suffix in (".py", ".cu", ".cuh")
               and "build" not in p.relative_to(PACKAGE).parts]
    sources += [REPO / "chip_smoke.py", REPO / "scripts" / "torch_scaling_probe.py",
                REPO / "scripts" / "torch_rm_smoke.py", REPO / "scripts" / "torch_render_demo.py"]
    assert len(sources) > 10
    offenders = [f"{path.relative_to(REPO)}:{n}: {line.strip()}"
                 for path in sources
                 for n, line in enumerate(path.read_text().splitlines(), 1)
                 if re.search(pattern, line)]
    assert not offenders, offenders
