"""Compare the SASS of one kernel library in two trees of the port.

    python3 scripts/torch_sass_diff.py BASE_ROOT NEW_ROOT composite_march [NEEDLE]

Builds (or reuses) ``csrc/<name>.cu`` of the ``volumerenderer_tpu_torch``
package under each root, disassembles both libraries with ``cuobjdump
-sass`` and pairs their kernels by the template arguments the two share:
each demangled kernel name with ``NEEDLE`` (default ``NoGrid``) and the
argument around it removed; with ``NEEDLE`` "" every kernel, paired by its
own name (namespaces dropped on both sides).  For each pair it prints whether the
instruction sequences (opcodes and operands, addresses and the kernel's own
name stripped) are identical.  One JSON line; exit code 1 if a pair
differs.  Needs ``nvcc``'s ``cuobjdump`` and ``c++filt``.
"""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path


def library(root: str, name: str) -> Path:
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from volumerenderer_tpu_torch.ops.cuda import _build; "
            "print(_build.load(sys.argv[2]).path)")
    out = subprocess.run([sys.executable, "-c", code, root, name], capture_output=True,
                         text=True, check=True)
    return Path(out.stdout.strip().splitlines()[-1])


def kernels(path: Path) -> dict:
    """Demangled kernel name -> its SASS instructions, normalized."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    out, name, body = {}, None, []
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                out[name] = body
            name, body = m.group(1), []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if name and m:
            body.append(re.sub(r"\b_Z\w+", "SELF", m.group(1)))
    if name:
        out[name] = body
    demangled = subprocess.run(["c++filt"], input="\n".join(out), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    return dict(zip(demangled, out.values()))


def key(name: str, needle: str) -> str:
    """The name with the template argument ``needle`` removed and the
    namespaces dropped (a type may move between namespaces)."""
    name = re.sub(r"\(anonymous namespace\)::|\bvrt::", "", name)
    if not needle:
        return name
    return re.sub(r",\s*[\w:()\s]*" + needle + r"[\w:]*", "", name)


def main() -> int:
    base_root, new_root, lib = sys.argv[1:4]
    needle = sys.argv[4] if len(sys.argv) > 4 else "NoGrid"
    base = {key(n, ""): body for n, body in kernels(library(base_root, lib)).items()}
    new = {key(n, needle): body for n, body in kernels(library(new_root, lib)).items()
           if needle in n}
    pairs = {n: {"identical": base[n] == body, "instructions": [len(base[n]), len(body)]}
             for n, body in new.items() if n in base}
    same = bool(pairs) and all(p["identical"] for p in pairs.values())
    print(json.dumps({"library": lib, "needle": needle, "paired": len(pairs),
                      "unpaired": sorted(set(new) - set(base)), "all_identical": same,
                      "pairs": pairs}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
