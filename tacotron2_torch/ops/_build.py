"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` into ``tacotron2_torch/_build/lib<name>-<hash>.so`` (the
hash covers the source and the flags, so an edited source rebuilds), then
loaded with ``ctypes``.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CUDA_SOURCES = ("decoder_infer",)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or under /usr/local/cuda)")
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = CUDA_SOURCES) -> Dict[str, str]:
    """Compile every source in ``names`` that is not built yet.  Returns
    each new build's compiler log (register and shared-memory use from
    ``-Xptxas -v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"kernel build failed: {name}: nvcc exit "
                               f"{proc.returncode}\n{logs[name]}")
        os.replace(tmp, out)
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
