"""Find a cell's files and modules by the names in ``BENCHMARK.json``.

Nothing here names a cell, a configuration, a traffic mix or a metric:
each lives in a file of its own that a later change adds beside the
others.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

from .env import BENCH, ROOT


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, spec_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    spec = load_json(spec_path)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"benchmark: no workload {name!r} in {spec_path}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(ROOT / conf["file"]),
        traffic=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)])


def load_module(kind: str, name: str) -> ModuleType:
    """``benchmark/<kind>/<name>.py`` (a name may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_path(metric: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<name>.py``, or for a
    quantity split by the end-to-end metric it moves (``idle_share.train``)
    the reader the parts share, ``metrics/<name up to the last dot>.py``."""
    own = BENCH / "metrics" / f"{metric}.py"
    if own.is_file() or "." not in metric:
        return own
    return BENCH / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"


def load_reader(metric: str) -> ModuleType:
    return load_module("metrics", reader_path(metric).stem)


def data_file(rel: str) -> Dict:
    return load_json(BENCH / rel)
