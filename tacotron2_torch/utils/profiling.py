"""Per-step wall-time statistics for the training loop.

Counterpart of ``tacotron2_tpu/utils/profiling.py::StepTimer``.  On a CUDA
device each tick waits for the card (``torch.cuda.synchronize``), so a
step's time is the card's and not the time to enqueue it.  The JAX
module's ``trace`` reads xprof traces and is not ported:
``torch.profiler`` stands in for it.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Optional, Union

import torch


class StepTimer:
    """Rolling wall-clock stats over the last ``window`` steps."""

    def __init__(self, window: int = 50,
                 device: Optional[Union[str, torch.device]] = None):
        self._durations: Deque[float] = deque(maxlen=window)
        self._last: Optional[float] = None
        self.total_steps = 0
        self.device = None if device is None else torch.device(device)

    def tick(self) -> None:
        """Call once per completed step."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._last is not None:
            self._durations.append(now - self._last)
        self._last = now
        self.total_steps += 1

    @property
    def mean_step_time(self) -> float:
        if not self._durations:
            return float("nan")
        return sum(self._durations) / len(self._durations)

    def stats(self, frames_per_step: Optional[int] = None
              ) -> Dict[str, float]:
        mean = self.mean_step_time
        ok = mean == mean and mean > 0
        out = {"step_time_s": mean,
               "steps_per_sec": 1.0 / mean if ok else float("nan")}
        if frames_per_step and ok:
            out["mel_frames_per_sec"] = frames_per_step / mean
        return out
