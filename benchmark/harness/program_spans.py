"""The program's own spans in a traced run (``tacotron2_torch/utils/
profiling.py``), read beside the device trace.

The program's tracer records while ``torch.profiler`` runs, which is the
traced window alone, so its buffer holds the window's spans: each with a
host interval on ``time.perf_counter_ns`` (the clock ``trace.py`` maps the
device events onto) and, on the card, a device interval in stream order.
A program without the tracer gives no spans, and every reader then
returns None.
"""

from __future__ import annotations

import bisect
from typing import List, Optional

from .trace import merged


def window_spans(session) -> List:
    """The program's spans that overlap the traced window."""
    from tacotron2_torch.utils import profiling
    read = getattr(profiling, "spans", None)
    if read is None:
        return []
    w0, w1 = session.trace.window
    return [s for s in read() if s.end_ns > w0 and s.start_ns < w1]


def counter(name: str) -> int:
    """A counter of the program's tracer (0 where it has none)."""
    from tacotron2_torch.utils import profiling
    read = getattr(profiling, "counts", None)
    return 0 if read is None else int(read().get(name, 0))


def idle_share(session, name: str) -> Optional[float]:
    """Per cent of the window in which the device sat idle while a span
    ``name`` was the innermost program span in flight, on any thread
    (``DeviceTrace.idle_by_span`` over the program's spans; an idle gap
    outside every program span counts for none)."""
    spans = window_spans(session)
    if not any(s.name == name for s in spans):
        return None
    idle = dict(session.trace.idle_by_span(
        [(s.name, s.start_ns, s.end_ns) for s in spans], k=len(spans) + 1))
    return 100.0 * idle.get(name, 0.0) / session.trace.window_s


def busy_within(events, intervals) -> float:
    """Seconds of the union of the device events' intervals that fall
    inside the given intervals (each counted once, clipped to it)."""
    busy = merged([(s, e) for _, s, e in events])
    starts = [s for s, _ in busy]
    total = 0
    for a, b in merged(intervals):
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(busy) and busy[i][0] < b:
            total += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
    return total / 1e9


def device_busy_s(session, name: str) -> Optional[float]:
    """The device's busy seconds inside the device intervals of the spans
    ``name``; None where no such span has one."""
    intervals = [(s.device_start_ns, s.device_end_ns)
                 for s in window_spans(session)
                 if s.name == name and s.device_start_ns is not None]
    if not intervals:
        return None
    return busy_within(session.trace.events, intervals)
