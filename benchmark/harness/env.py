"""Process environment of a benchmark run, set before torch is imported.

Every build and kernel cache lives at a fixed path inside the checkout, so
that only a cell's first run in a checkout builds: the program's own
kernels go to ``tacotron2_torch/_build/`` (fixed in the program), the rest
under ``.bench_cache/``.  Both are git-ignored.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
CACHE = ROOT / ".bench_cache"

# top-level module names that must never load in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "tacotron2_tpu", "bench")


def prepare() -> None:
    CACHE.mkdir(exist_ok=True)
    fixed = {"TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
             "TRITON_CACHE_DIR": CACHE / "triton",
             "CUDA_CACHE_PATH": CACHE / "cuda"}
    for key, path in fixed.items():
        os.environ[key] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of :data:`FORBIDDEN`, compared whole."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})
