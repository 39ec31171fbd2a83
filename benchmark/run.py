#!/usr/bin/env python3
"""Run one cell of the benchmark of ``tacotron2_torch`` on the card.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell is found by name in ``BENCHMARK.json`` at the repository root:
its configuration file (``benchmark/configs/``), its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``driver`` names the module of
``benchmark/drivers/`` that drives it), its limits
(``benchmark/limits/<workload>.json``) and its metrics (end-to-end ones
from the driver, per-layer ones from ``benchmark/metrics/<name>.py``).
The run makes its inputs and weights from ``--seed``, sets up and warms
every shape the traffic uses, measures for ``--seconds``, checks what the
timed path produced against the plain reference in
``benchmark/reference/``, and prints one JSON line last on standard output;
the compared numbers and their limits also go last to standard error.
With ``--trace 1`` the window runs under ``torch.profiler`` and the line
carries the per-layer metrics, the device's busy time and a breakdown.
It exits non-zero, with no result line, without a card, with fewer cards
than the cell asks for, or if a JAX module was loaded.
"""

import time

_T_START = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import env  # noqa: E402

env.prepare()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None) -> int:
    args = parse_args(argv)
    from benchmark.harness import registry
    cell = registry.load_cell(args.workload)

    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < cell.chips:
        fail(f"the cell asks for {cell.chips} cards, "
             f"{torch.cuda.device_count()} present")

    from benchmark.harness.session import Session
    session = Session(cell, args, _T_START)
    result = session.run()
    found = env.forbidden_modules()
    if found:
        fail(f"JAX or the JAX package was loaded: {found}", 3)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
