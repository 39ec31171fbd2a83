"""Step-rate statistics for the training loop, and the port's tracer.

``StepTimer`` is the counterpart of ``tacotron2_tpu/utils/profiling.py::
StepTimer``.  It waits for the card only when its statistics are read, so
the loop it times is not held to the card on every step.  The JAX
module's ``trace`` reads xprof traces and is not ported:
``torch.profiler`` stands in for it.

The tracer names the port's layers in time.  ``span(name)`` is a context
manager put at a layer's boundary (never inside a per-frame loop) and
``count(name, n)`` adds to a named counter.  A span records its name, its
start and end on ``time.perf_counter_ns``, its parent (the span open
around it on the same thread), its thread, and the id of the root span it
belongs to (``span(name, root=True)``: a train step, a ``synthesize_wav``
call).  A span opened with no span open on its thread joins the newest
root open on any thread (autograd runs a step's backward on threads of
its own), unless it is a root itself.  On a CUDA device
it also records a pair of timing events on the current stream, so each
span has a device interval in stream order beside its host one; they are
put on the host clock by one anchor (synchronise, read the clock, record
an event on the idle stream: ``benchmark/harness/trace.py``'s marker) and
resolved only when the spans are read.

The tracer is off by default: ``span`` then returns a shared null context
after one check and records nothing.  It is on after :func:`enable`, and
while a ``torch.profiler`` session is active, so a traced run records the
spans with no change to the code that runs the profiler.  Spans go to a
bounded buffer in memory: :func:`spans` reads it, :func:`drain` reads and
clears it.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Deque, Dict, List, NamedTuple, Optional, Union

import torch


class StepTimer:
    """Steps per second over the steps since the previous read.

    :meth:`tick` once per completed step only counts it (the first tick
    waits for the card and starts the first interval).  :meth:`stats`
    waits for the card, reports the steps of the interval over its wall
    time, and starts the next interval.  ``window`` is the JAX class's
    signature and is not used: the interval is the steps between reads.
    """

    def __init__(self, window: int = 50,
                 device: Optional[Union[str, torch.device]] = None):
        self.window = window
        self.device = None if device is None else torch.device(device)
        self.total_steps = 0
        self._mark: Optional[float] = None
        self._steps = 0

    def _now(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def tick(self) -> None:
        """Call once per completed step."""
        self.total_steps += 1
        if self._mark is None:
            self._mark = self._now()
        else:
            self._steps += 1

    def stats(self, frames_per_step: Optional[int] = None
              ) -> Dict[str, float]:
        step = float("nan")
        if self._mark is not None:
            now = self._now()
            if self._steps:
                step = (now - self._mark) / self._steps
            self._mark, self._steps = now, 0
        ok = step == step and step > 0
        out = {"step_time_s": step,
               "steps_per_sec": 1.0 / step if ok else float("nan")}
        if frames_per_step and ok:
            out["mel_frames_per_sec"] = frames_per_step / step
        return out


# ------------------------------------------------------------------ tracer

BUFFER_SPANS = 1 << 16


class Span(NamedTuple):
    """One recorded span; times in ns on ``time.perf_counter_ns``, the
    device interval None where no CUDA events were recorded."""
    name: str
    id: int
    parent: Optional[int]
    root: int
    thread: int
    start_ns: int
    end_ns: int
    device_start_ns: Optional[int]
    device_end_ns: Optional[int]


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()
_profiler_active = torch.autograd._profiler_enabled
_enabled = False
_lock = threading.Lock()
_buffer: Deque["_Open"] = collections.deque(maxlen=BUFFER_SPANS)
_counts: Dict[str, int] = collections.defaultdict(int)
_ids = itertools.count(1)
_local = threading.local()
_open_roots: List[int] = []
_anchor = None            # (event, host ns) once CUDA events are recorded


def _record():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _synchronize() -> None:
    torch.cuda.synchronize()


def _device_timing() -> bool:
    """Whether spans record CUDA events: once CUDA is in use in the
    process.  The first time, take the anchor."""
    global _anchor
    if not torch.cuda.is_initialized():
        return False
    if _anchor is None:
        ev = _record()            # made on its first record
        _synchronize()
        host = time.perf_counter_ns()
        ev.record()               # on the idle stream: at once
        _anchor = (ev, host)
    return True


class _Open:
    __slots__ = ("name", "is_root", "id", "parent", "root", "thread",
                 "start_ns", "end_ns", "ev0", "ev1")

    def __init__(self, name: str, is_root: bool):
        self.name = name
        self.is_root = is_root

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent = None
            with _lock:
                joins = _open_roots and not self.is_root
                self.root = _open_roots[-1] if joins else self.id
                if self.root == self.id:
                    _open_roots.append(self.id)
        self.thread = threading.get_ident()
        stack.append(self)
        self.ev0 = self.ev1 = None
        self.start_ns = time.perf_counter_ns()
        if _device_timing():
            self.ev0 = _record()
        return self

    def __exit__(self, *exc):
        if self.ev0 is not None:
            self.ev1 = _record()
        self.end_ns = time.perf_counter_ns()
        _local.stack.pop()
        with _lock:
            if self.root == self.id:
                _open_roots.remove(self.id)
            if len(_buffer) == _buffer.maxlen:
                _counts["tracer.spans_dropped"] += 1
            _buffer.append(self)
        return False


def span(name: str, root: bool = False):
    """A context manager that records ``name`` around its body while the
    tracer is on; a shared null context while it is off.  ``root`` marks a
    unit of work (a step, a request) whose id the spans inside it share."""
    if not (_enabled or _profiler_active()):
        return _NULL
    return _Open(name, root)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the tracer is on."""
    if not (_enabled or _profiler_active()):
        return
    with _lock:
        _counts[name] += n


def enable() -> None:
    """Turn the tracer on until :func:`disable` (it is also on while a
    ``torch.profiler`` session is active)."""
    global _enabled
    _enabled = True
    _device_timing()


def disable() -> None:
    global _enabled
    _enabled = False


def _resolve(raw: List[_Open]) -> List[Span]:
    if any(o.ev0 is not None for o in raw):
        _synchronize()
    out = []
    for o in sorted(raw, key=lambda o: o.start_ns):
        d0 = d1 = None
        if o.ev0 is not None and _anchor is not None:
            ev, host = _anchor
            try:
                d0 = host + round(ev.elapsed_time(o.ev0) * 1e6)
                d1 = host + round(ev.elapsed_time(o.ev1) * 1e6)
            except RuntimeError:      # another device than the anchor's
                d0 = d1 = None
        out.append(Span(o.name, o.id, o.parent, o.root, o.thread,
                        o.start_ns, o.end_ns, d0, d1))
    return out


def spans() -> List[Span]:
    """The buffered spans, by start time, their device intervals
    resolved (this waits for the card)."""
    with _lock:
        raw = list(_buffer)
    return _resolve(raw)


def counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def drain() -> List[Span]:
    """:func:`spans`, then clear the buffer and the counters."""
    with _lock:
        raw = list(_buffer)
        _buffer.clear()
        _counts.clear()
    return _resolve(raw)
