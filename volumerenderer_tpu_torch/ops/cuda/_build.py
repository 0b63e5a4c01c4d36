"""Builds the package's CUDA sources with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its own
into ``build/lib<name>-<hash>.so`` inside the package, then loaded with
``ctypes``.  The hash covers the source, every shared header ``csrc/*.cuh``
(the sources include them) and the compiler flags, so an edit to any of them
builds anew.  Nothing is
compiled when a module is imported: machines without ``nvcc`` import the
package and run the plain PyTorch versions on CPU tensors.
"""
from __future__ import annotations

import ctypes
import concurrent.futures
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

# --fmad=false keeps every product and sum separately rounded, as in the
# PyTorch and JAX versions the kernels are held against.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
# Flags of one library only: the kd-tree's native passes fork threads
# (std::async), which the host compiler links with -pthread.
EXTRA_FLAGS = {"kdtree_native": ("-Xcompiler", "-pthread")}

_lock = threading.Lock()  # guards _name_locks
_name_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, "BuiltLibrary"] = {}


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    """A compiled kernel library: the loaded ``ctypes`` handle, the seconds
    this process spent building it (0.0 when an earlier build was reused) and
    the compiler's report (``ptxas`` registers and spills)."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float
    log: str


def find_nvcc() -> str:
    """``nvcc`` from PATH, then ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for path in candidates:
        if path.is_file() and os.access(path, os.X_OK):
            return str(path)
    raise RuntimeError(
        "nvcc not found on PATH, in $CUDA_HOME/bin or in /usr/local/cuda/bin; "
        "the CUDA kernels of volumerenderer_tpu_torch are built with it at first use")


def flags(name: str) -> tuple[str, ...]:
    """The nvcc flags of ``csrc/<name>.cu``."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str, csrc_dir: Path = CSRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """Where the build of ``csrc_dir/<name>.cu`` lives: named by a hash of the
    source, of every header ``csrc_dir/*.cuh`` (name and bytes) and of its
    flags."""
    digest = hashlib.sha256()
    for path in [csrc_dir / f"{name}.cu", *sorted(csrc_dir.glob("*.cuh"))]:
        data = path.read_bytes()
        digest.update(f"{path.name}\0{len(data)}\0".encode())
        digest.update(data)
    digest.update("\0".join(flags(name)).encode())
    return build_dir / f"lib{name}-{digest.hexdigest()[:16]}.so"


def load(name: str) -> BuiltLibrary:
    """Build ``csrc/<name>.cu`` if no build of this source and its headers
    exists, and load it.  Different sources build concurrently."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _loaded:
            return _loaded[name]
        source = CSRC_DIR / f"{name}.cu"
        out = library_path(name)
        log_path = out.with_suffix(".log")
        seconds = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = find_nvcc()
            t0 = time.perf_counter()
            # build under a private name, then rename: concurrent processes
            # never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run([nvcc, *flags(name), "-I", str(CSRC_DIR), "-o", tmp,
                                       str(source)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed to build {source} "
                                       f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
                log_path.write_text(proc.stdout + proc.stderr)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            seconds = time.perf_counter() - t0
        log = log_path.read_text() if log_path.exists() else ""
        built = BuiltLibrary(ctypes.CDLL(str(out)), out, seconds, log)
        _loaded[name] = built
        return built


def load_many(names) -> dict[str, BuiltLibrary]:
    """``load`` each name, one ``nvcc`` per source, all started together."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(load, names)))
