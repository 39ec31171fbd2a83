"""``BENCHMARK.json`` against the rules its readers rely on: every file it
names exists under its paths, every cell reports ``setup_s``, another
end-to-end metric and a per-layer one, each per-layer metric has its
reader and moves an end-to-end metric its cells report."""

import json
import re

import pytest

from benchmark.harness import registry
from benchmark.harness.env import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def applies(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51


def test_names():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell(w):
    cell = registry.load_cell(w["name"])
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert registry.reader_path(m["name"]).is_file()
        assert m["moves"] in e2e
    assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").is_file()
    assert w["chips"] == 1
    assert cell.limits and all(isinstance(v, (int, float))
                               for v in cell.limits.values())


def test_bounds():
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m["bound"] for m in SPEC["end_to_end"]}[
        "setup_s"] == 0.25


def test_config_files():
    for c in SPEC["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/")
        assert json.loads(path.read_text())["name"] == c["name"]
        assert c["reduced"] == []


def test_roofline_names():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
