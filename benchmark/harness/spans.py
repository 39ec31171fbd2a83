"""Host spans the benchmark records around its calls into the program.

A span is (name, start ns, end ns) on ``time.perf_counter_ns``; the traced
run maps device events onto this clock (``trace.py``) and names each idle
gap of the device by the span in flight.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import List, Tuple


class Spans:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.items: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            with self._lock:
                self.items.append((name, t0, t1))

    def add(self, name: str, t0: int, t1: int) -> None:
        with self._lock:
            self.items.append((name, t0, t1))
