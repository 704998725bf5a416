#!/usr/bin/env python3
"""Whether the kernels of two trees compile to the same SASS:

    python tools/compare_sass.py --repo DIR [--sources turbo_step,flagship_step]
                                 [--geometries 10x20,30x20,61x12]

Builds each source of ``--sources`` at each geometry in this tree and in the
tree under ``DIR`` (each into its own ``build/``; ``fn_env`` at the compat
``EnvConfig`` of the geometry: ``10x20``, ``30x20`` and ``8x12-pad2``, 8x12
with padding 2), dumps every kernel's SASS
with ``cuobjdump -sass`` and compares each kernel of the other tree with
this tree's kernel of the same name and template arguments, where a
template argument this tree added (a trailing ``bool``, such as a sampling
build's) is false.  Parameter offsets (``c[0x0][...]``) and addresses are
ignored, so that a parameter added at the end of a kernel's list does not
count.  Prints one JSON line: for each pair, equal or not and its
instruction count, and the kernels of this tree that the other lacks.
Needs ``nvcc`` and ``cuobjdump`` (``/usr/local/cuda/bin``).
"""
import argparse
import importlib
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRIES = {"10x20": {}, "30x20": dict(width=30, height=20), "61x12": dict(width=61, height=12, queue_size=3)}
FN_GEOMETRIES = {"10x20": {}, "30x20": dict(width=30), "8x12-pad2": dict(width=8, height=12, padding=2)}

_FUNCTION = re.compile(r"^\s*Function : (\S+)", re.MULTILINE)
# a kernel's base name and its template's int and bool arguments (Itanium
# mangling: ILi8ELb0EE is <8, false>)
_KERNEL = re.compile(r"\d+([a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?")


def _kernels_of(repo, source, kw):
    """``{(kernel, template args): SASS lines}`` of ``source`` built at ``kw`` in ``repo``."""
    for name in [m for m in sys.modules if m.startswith("tetris_gymnasium_torch")]:
        del sys.modules[name]
    sys.path.insert(0, repo)
    try:
        kernels = importlib.import_module("tetris_gymnasium_torch.kernels")
        from tetris_gymnasium_torch.config import EngineConfig
        from tetris_gymnasium_torch.ops import bitboard as bb
        from tetris_gymnasium_torch.pieces import PIECES

        if source == "fn_env":
            from tetris_gymnasium_torch.config import EnvConfig

            defines = kernels.fn_defines(EnvConfig(**kw), PIECES)
        else:
            defines = kernels.engine_defines(EngineConfig(**kw), bb.turbo_tables(PIECES),
                                             flagship=source in kernels.FLAGSHIP_SOURCES)
        kernels._compile(source, defines)
        lib = str(kernels._lib_path(kernels.SOURCES[source], defines))
    finally:
        sys.path.remove(repo)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True, check=True).stdout
    parts = _FUNCTION.split(sass)
    out = {}
    for mangled, body in zip(parts[1::2], parts[2::2]):
        m = _KERNEL.search(mangled)
        base = m.group(1) if m else mangled
        args = tuple(re.findall(r"L([ib])(\d+)E", m.group(2))) if m and m.group(2) else ()
        lines = []
        for line in body.splitlines():
            line = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)  # addresses
            line = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]", line)  # parameter offsets
            line = re.sub(r"/\*\s*0x[0-9a-f]+\s*\*/", "", line).strip()  # encodings
            if line and not line.startswith((".", "..")):
                lines.append(line)
        out[(base, args)] = lines
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", required=True)
    ap.add_argument("--sources", default="turbo_step,flagship_step")
    ap.add_argument("--geometries", default="10x20,30x20,61x12")
    args = ap.parse_args()
    other = os.path.abspath(args.repo)
    result = {}
    for source in args.sources.split(","):
        for geo in args.geometries.split(","):
            kw = (FN_GEOMETRIES if source == "fn_env" else GEOMETRIES)[geo]
            mine = _kernels_of(HERE, source, kw)
            theirs = _kernels_of(other, source, kw)
            pairs = {}
            for (base, targs), lines in theirs.items():
                match = [k for k in mine if k[0] == base and k[1][:len(targs)] == targs
                         and all(v == ("b", "0") for v in k[1][len(targs):])]
                key = f"{base}<{','.join(v for _, v in targs)}>"
                if not match:
                    pairs[key] = {"equal": False, "missing_here": True}
                    continue
                pairs[key] = {"equal": mine[match[0]] == lines, "instructions": len(lines),
                              "instructions_here": len(mine[match[0]])}
            new = [f"{b}<{','.join(v for _, v in t)}>" for b, t in mine
                   if (b, t) not in theirs and not any(b == b2 and t[:len(t2)] == t2 and
                                                      all(v == ("b", "0") for v in t[len(t2):])
                                                      for b2, t2 in theirs)]
            result[f"{source}@{geo}"] = {"pairs": pairs, "only_here": new}
    print(json.dumps({"repo": other, "sass": result}), flush=True)


if __name__ == "__main__":
    main()
