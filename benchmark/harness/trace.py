"""The traced run's device timeline: ``torch.profiler`` (CUDA activity
only), read from its raw device events, mapped onto the host spans' clock.

The raw-event reading and the merged busy time are copied from the
program's ``tools/profile_train_step_torch.py`` (``device_events``,
``busy_us``); the readers find each kernel by its symbol's prefix.  The profiler's clock is put
onto ``time.perf_counter_ns`` by a marker: on an idle device, right after
the host reads its clock, one elementwise kernel is launched; its start
is taken as that host instant (the launch's few microseconds are the
error).  The profiler starts after set-up, right before the window, and
runs in the traced run only: its tracer stays on in a process once used
and slows every later launch.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Event = Tuple[str, int, int]   # name, start ns, end ns (host clock)

def _raw_device_events(prof) -> List[Tuple[str, int, int]]:
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def merged(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class DeviceTrace:
    """Start before the window, stop after it; then read."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.events: List[Event] = []
        self.window: Tuple[int, int] = (0, 0)
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        marker = torch.zeros(1, device=self.device)
        torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize(self.device)
        self._host_mark = time.perf_counter_ns()
        marker.add_(1.0)
        torch.cuda.synchronize(self.device)

    def stop(self, window: Tuple[int, int]) -> None:
        torch.cuda.synchronize(self.device)
        self._prof.stop()
        raw = sorted(_raw_device_events(self._prof), key=lambda x: x[1])
        self._prof = None
        if len(raw) < 2:
            raise RuntimeError("torch.profiler traced no device events")
        offset = raw[0][1] - self._host_mark
        w0, w1 = window
        self.window = window
        self.events = [(n, max(s - offset, w0), min(e - offset, w1))
                       for n, s, e in raw[1:]
                       if e - offset > w0 and s - offset < w1]

    # --------------------------------------------------------- readings
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in merged([(s, e) for _, s, e
                                              in self.events])) / 1e9

    def kernel_time_s(self, symbol_prefix: str) -> Tuple[float, int]:
        """(device seconds, events) of kernels whose name holds the
        prefix, within the window."""
        hits = [(s, e) for n, s, e in self.events if symbol_prefix in n]
        return sum(e - s for s, e in hits) / 1e9, len(hits)

    def top_ops(self, k: int = 10) -> List[List]:
        by = collections.Counter()
        for n, s, e in self.events:
            by[n[:160]] += (e - s) / 1e9
        return [[n, t] for n, t in by.most_common(k)]

    def idle_by_span(self, spans: Sequence[Tuple[str, int, int]],
                     k: int = 10) -> List[List]:
        """Idle seconds of the device within the window, summed by the
        name of the host span in flight at each gap's midpoint (the span
        that started last among those covering it)."""
        busy = merged([(s, e) for _, s, e in self.events])
        w0, w1 = self.window
        gaps, t = [], w0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < w1:
            gaps.append((t, w1))
        ordered = sorted(spans, key=lambda x: x[1])
        starts = [s for _, s, _ in ordered]
        by = collections.Counter()
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            name: Optional[str] = None
            i = bisect.bisect_right(starts, mid) - 1
            for n, _, e in reversed(ordered[max(0, i - 63):i + 1]):
                if e >= mid:
                    name = n
                    break
            by[name or "outside the benchmark's spans"] += (g1 - g0) / 1e9
        return [[n, t] for n, t in by.most_common(k)]


def breakdown(trace: DeviceTrace, spans) -> Dict[str, List[List]]:
    return {"device_ops": trace.top_ops(), "idle_gaps":
            trace.idle_by_span(spans)}
