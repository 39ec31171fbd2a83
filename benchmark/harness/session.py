"""One run of one cell: set-up, window, metrics, then the check.

A driver (``benchmark/drivers/<name>.py``, named by the traffic mix) is a
class ``Driver(session)`` with

* ``setup()``: everything before the window (weights, inputs, warm-up of
  every shape the traffic uses, and for training the first steps the
  reference follows);
* ``window(seconds) -> (start_ns, end_ns)``: the measured work, ending
  with the device synchronised; spans go to ``session.spans``;
* ``end_to_end() -> {metric: value}`` (``setup_s`` is the session's);
* ``counts() -> (attempted, failed)``;
* ``release()``: drop the program's state before the reference runs;
* ``check() -> [(name, value, limit)]``: what the timed path produced,
  against the reference; correct when every value is at most its limit.

Per-layer metrics are ``benchmark/metrics/<name>.py`` modules
(:func:`registry.reader_path`) with
``read(session, driver)`` returning a number or None (nothing to read:
the metric is left out of the line).
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Dict

import torch

from . import device as D
from . import registry
from .spans import Spans
from .trace import DeviceTrace, breakdown


class Session:
    def __init__(self, cell: registry.Cell, args, t_start_ns: int,
                 device: str = "cuda") -> None:
        self.cell = cell
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.traced = bool(args.trace)
        self.t_start_ns = t_start_ns
        self.device = torch.device(device, 0) if device == "cuda" \
            else torch.device(device)
        self.spans = Spans()
        self.trace = None
        self.window_ns = (0, 0)
        self.peak_window_bytes = 0

    def log(self, msg: str) -> None:
        print(f"[bench {self.cell.name}] {msg}", file=sys.stderr, flush=True)

    def run(self) -> Dict:
        cell = self.cell
        driver = registry.load_module("drivers",
                                      cell.traffic["driver"]).Driver(self)
        driver.setup()
        D.sync(self.device)
        setup_s = (time.perf_counter_ns() - self.t_start_ns) / 1e9
        peak_setup = D.peak_bytes(self.device)
        D.reset_peak(self.device)
        self.log(f"set-up {setup_s:.3f} s, peak {peak_setup / 1e9:.3f} GB")
        if self.traced:
            self.trace = DeviceTrace(self.device)
            self.trace.start()
        self.window_ns = driver.window(self.seconds)
        if self.trace is not None:
            self.trace.stop(self.window_ns)
        self.peak_window_bytes = D.peak_bytes(self.device)

        metrics = {}
        if not self.traced:
            values = dict(driver.end_to_end(), setup_s=setup_s)
            wanted = cell.end_to_end
        else:
            values = {m["name"]: registry.load_reader(m["name"])
                      .read(self, driver) for m in cell.per_layer}
            wanted = cell.per_layer
        for m in wanted:
            v = values.get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        device = {"platform": "gpu",
                  "kind": D.name(self.device),
                  "count": cell.chips,
                  "memory_peak_bytes": int(max(peak_setup,
                                               self.peak_window_bytes))}
        result = {"correct": False, "attempted": 0, "failed": 0,
                  "metrics": metrics, "device": device}
        if self.trace is not None:
            device.update(busy_s=self.trace.busy_s,
                          window_s=self.trace.window_s)
            result["breakdown"] = breakdown(self.trace,
                                            self.spans.items)
        result["attempted"], result["failed"] = driver.counts()

        driver.release()
        self.trace = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        checks = driver.check()
        self.log(f"check took {time.perf_counter() - t0:.1f} s")
        result["correct"] = bool(checks) and all(
            math.isfinite(v) and v <= lim for _, v, lim in checks)
        result["checks"] = {n: {"value": v if math.isfinite(v) else repr(v),
                                "limit": lim} for n, v, lim in checks}
        return result
