"""The port stands alone and runs on the card unless told otherwise.

No module of ``tacotron2_torch``, no ``*_torch.py`` CLI at the root or in
``tools/``, and not ``chip_smoke.py`` imports ``jax``, ``orbax`` or
``tacotron2_tpu``: not at the top of a file, and not inside a function
(read from the source), and a fresh interpreter that imports them all
holds none of those modules.  Every function or class of the package that
takes a device by default takes ``"cuda"``, and so does every CLI's
``--device`` flag.  Imports nothing of JAX itself.
"""

import ast
import glob
import importlib
import inspect
import os
import pkgutil
import re
import subprocess
import sys

import pytest

import tacotron2_torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FORBIDDEN = ("jax", "jaxlib", "orbax", "tacotron2_tpu")
GROUPS = {
    "package": sorted(glob.glob(os.path.join(ROOT, "tacotron2_torch", "**",
                                             "*.py"), recursive=True)),
    "clis": sorted(glob.glob(os.path.join(ROOT, "*_torch.py"))),
    "tools": sorted(glob.glob(os.path.join(ROOT, "tools", "*_torch.py"))),
    "chip_smoke": [os.path.join(ROOT, "chip_smoke.py")],
}


def imported_roots(path):
    """The top-level names of every module ``path`` imports, anywhere in
    the file."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("group", list(GROUPS))
def test_sources_import_nothing_of_jax(group):
    files = GROUPS[group]
    assert files, group
    bad = [f"{os.path.relpath(path, ROOT)}:{line} {name}"
           for path in files for name, line in imported_roots(path)
           if name in FORBIDDEN]
    assert not bad, bad


def test_fresh_interpreter_holds_no_jax_module():
    """Every module of the package, every CLI and tool of the port and
    ``chip_smoke.py`` imported (not run) in one fresh interpreter."""
    scripts = GROUPS["clis"] + GROUPS["tools"] + GROUPS["chip_smoke"]
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import tacotron2_torch\n"
        "for m in pkgutil.walk_packages(tacotron2_torch.__path__, "
        "'tacotron2_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"for i, path in enumerate({scripts!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'_s{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "tools")]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]


def test_package_defaults_to_cuda():
    """A ``device`` parameter with a default defaults to ``"cuda"``, in
    every public function and class of the package.  ``StepTimer``'s is
    the device it synchronises before reading the clock (None: none), not
    where it runs."""
    seen, bad = 0, []
    for info in pkgutil.walk_packages(tacotron2_torch.__path__,
                                      "tacotron2_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if (name.startswith("_") or getattr(obj, "__module__", None)
                    != info.name):
                continue
            fn = obj.__init__ if inspect.isclass(obj) else obj
            if not callable(fn):
                continue
            try:
                param = inspect.signature(fn).parameters.get("device")
            except (TypeError, ValueError):
                continue
            if param is None or param.default is inspect.Parameter.empty:
                continue
            seen += 1
            if param.default != "cuda" and name != "StepTimer":
                bad.append(f"{info.name}.{name}: {param.default!r}")
    assert seen > 20 and not bad, bad


@pytest.mark.parametrize("group", ["clis", "tools"])
def test_cli_device_flags_default_to_cuda(group):
    """Every ``--device`` flag of a CLI or tool of the port defaults to
    ``cuda``; the ones without the flag run on the host alone."""
    flagged = 0
    for path in GROUPS[group]:
        src = open(path, encoding="utf-8").read()
        for m in re.finditer(r'add_argument\(\s*"--device"([^)]*)\)', src):
            flagged += 1
            assert re.search(r'default\s*=\s*"cuda"', m.group(1)), path
    assert flagged >= 5
