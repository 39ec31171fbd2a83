"""Nothing of the benchmark imports JAX, the JAX package or ``bench.py``,
compared by whole top-level module names; the reference imports nothing of
the program; a run's own check of ``sys.modules`` finds what was loaded."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark.harness import env

FILES = sorted(p for p in env.BENCH.rglob("*.py") if "tests" not in p.parts)


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(env.ROOT)))
def test_no_jax(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & set(env.FORBIDDEN), tops & set(env.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((env.BENCH / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert "tacotron2_torch" not in tops


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", object())
    monkeypatch.setitem(sys.modules, "tacotron2_torch_x", object())
    assert env.forbidden_modules() == [m for m in env.forbidden_modules()
                                       if m.split(".")[0] in env.FORBIDDEN]
    assert "jaxtyping_lookalike" not in env.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tacotron2_tpu.config", object())
    assert "tacotron2_tpu.config" in env.forbidden_modules()
