"""Files of the benchmark found by name under its directory
(``benchmark/``): each module is loaded from its path when it is asked for,
never imported by name, so a later change adds one as a new file."""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_module(path: Path, prefix: str):
    name = f"_vrbench_{prefix}_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_named(bench_dir: Path, folder: str, name: str):
    """The module ``<bench_dir>/<folder>/<name>.py``.  A name that is not a
    benchmark name (letters, digits, ``_``, ``.``, ``-``), or a file that
    is not there, raises FileNotFoundError with the path it looked for."""
    path = Path(bench_dir) / folder / f"{name}.py"
    if not (isinstance(name, str) and NAME.match(name) and path.is_file()):
        raise FileNotFoundError(f"no file {path} for the {folder} name {name!r}")
    return load_module(path, folder)
