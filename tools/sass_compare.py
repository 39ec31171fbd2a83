#!/usr/bin/env python3
"""Each kernel's machine code against another checkout's, on a machine with
the CUDA toolkit: which kernels compile to the same SASS.

    python3 tools/sass_compare.py --compare LABEL=DIR [--out FILE]

Builds both packages' five sources (``DIR`` holds another checkout's
``tacotron2_torch``, as for the probes), disassembles each library with
``cuobjdump -sass`` and compares, kernel by kernel, the instruction
streams without their addresses.  A kernel whose SASS is identical runs
the same code: its time in another build can differ only by where it was
placed and what ran beside it.  JSON to ``--out`` (default
``chiprun_out/sass_compare.json``).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))

from bwd_chain_probe import load_package  # noqa: E402

# the anonymous namespace's mangled name holds a hash of the file's path
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")
# a last template argument `false` that one side lacks (a bool added with
# that default) is left out of the name, so the two builds pair up
FALSE_LAST = re.compile(r"ELb0EE")


def kernels(cuobjdump: str, lib: Path) -> dict:
    """{kernel name: [instruction, ...]} of one library."""
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = FALSE_LAST.sub("EE", ANON.sub("ANON", m.group(1)))
            funcs[name] = []
        elif name is not None:
            m = re.match(r"\s*/\*[0-9a-f]+\*/\s*(.*?);", line)
            if m:
                funcs[name].append(re.sub(r"\s+", " ", m.group(1)))
    return funcs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", required=True, metavar="LABEL=DIR")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "sass_compare.json")
    opts = ap.parse_args()
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    label, path = opts.compare.split("=", 1)
    builds = {k: load_package(d / "tacotron2_torch", f"t2s_{k}",
                              ("ops._build",))["ops._build"]
              for k, d in ((label, Path(path)), ("this", ROOT))}
    for b in builds.values():
        b.build()
    rows = []
    for src in builds["this"].CUDA_SOURCES:
        other = kernels(cuobjdump, builds[label].library_path(src))
        this = kernels(cuobjdump, builds["this"].library_path(src))
        for name in sorted(set(other) | set(this)):
            if name in other and name in this:
                result = ("identical" if other[name] == this[name]
                          else "differs")
                sizes = (len(other[name]), len(this[name]))
            else:
                result = f"only in {'this' if name in this else label}"
                sizes = None
            rows.append(dict(source=src, kernel=name, result=result,
                             instructions=sizes))
            print(f"[sass {src}] {name}: {result}"
                  + (f" ({sizes[0]} / {sizes[1]} instructions)"
                     if sizes else ""), flush=True)
    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
