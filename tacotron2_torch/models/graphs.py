"""A function of tensors captured as CUDA graphs and replayed.

:class:`GraphCache` runs ``fn(*args)`` on CUDA tensors by replaying a
CUDA graph of it: one capture for each shape, stride and dtype of the
arguments, device and set of arguments that want a gradient, made the
first time the cache sees it.  Before a capture ``fn`` runs once eagerly
on a side stream, over the first two rows and four steps of its first
argument, which is (B, T, ...): the libraries' lazy set-up (handles,
workspaces, the process's first backward) must not fall inside a capture,
and it costs the same at that size, where a pass at the real size would
cost seconds more of set-up.  Where a gradient is wanted the backward is
captured too (``torch.autograd.grad`` over ``fn``'s autograd graph, as
``torch.cuda.make_graphed_callables`` does), and the replay is one node
of the caller's autograd graph whose backward is one replay.  The graph
holds ``fn``'s own operations in their own order, so its values and
gradients are the eager call's bits.

Every argument is an input: each replay copies all of them into the
capture's own buffers, so weights that change between calls, or that are
new tensors on every call (a cast of fp32 masters), are read as they are
now.  Outputs and gradients are copied out of the graph's buffers, so a
caller may keep them across calls.  What a replay keeps for its backward
lives in the graph's buffers until that backward runs: a second forward at
the same key while an earlier one's backward is still to come runs
eagerly, so neither overwrites the other.

It is made for loops of small launches whose host time exceeds their
device time (``models/layers.py::BiLSTM``).  ``fn`` must draw no random
numbers, must not synchronise and must give one tensor.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import count


def input_buffers(args: Tuple[torch.Tensor, ...], wants: Tuple[bool, ...]
                  ) -> Tuple[torch.Tensor, ...]:
    """A capture's own copies of ``args``, with their strides (the
    libraries may choose by layout): leaves of no autograd graph, each
    wanting a gradient where ``wants`` says, so that the captured backward
    ends at them and reaches nothing of the first caller's graph."""
    with torch.no_grad():
        bufs = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                    device=a.device).copy_(a) for a in args]
    return tuple(b.requires_grad_(w) for b, w in zip(bufs, wants))


@contextlib.contextmanager
def _capturing(graph: torch.cuda.CUDAGraph, pool, stream: torch.cuda.Stream
               ) -> Iterator[None]:
    """Capture the work queued inside into ``graph`` on ``stream``.  This
    is ``torch.cuda.graph`` without the synchronise and ``empty_cache`` it
    starts with: a capture in a running program would release the
    allocator's whole cache, and the caller's next allocations (a train
    step's 30 GB) would pay ``cudaMalloc`` again."""
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            yield
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)


class _Capture:
    """``fn`` captured at one key: its input buffers (the callers' strides),
    the forward graph and its output and, where ``wants`` marks an
    argument, the backward graph, its incoming gradient and the
    gradients it leaves."""

    def __init__(self, fn: Callable[..., torch.Tensor],
                 args: Tuple[torch.Tensor, ...], wants: Tuple[bool, ...]):
        self.wants = wants
        stream = torch.cuda.Stream()
        small = input_buffers((args[0][:2, :4],) + tuple(args[1:]), wants)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            out = fn(*small)
            if any(wants):
                torch.autograd.grad(out.sum(), [x for x, w in zip(small, wants)
                                                if w])
            del out, small
        self.inputs = input_buffers(args, wants)
        leaves = [x for x, w in zip(self.inputs, wants) if w]
        pool = torch.cuda.graph_pool_handle()
        self.fwd = torch.cuda.CUDAGraph()
        with _capturing(self.fwd, pool, stream):
            self.out = fn(*self.inputs)
        self.bwd = self.grad_out = self.grads = None
        if leaves:
            self.grad_out = torch.empty_like(self.out)
            self.bwd = torch.cuda.CUDAGraph()
            with _capturing(self.bwd, pool, stream):
                # From a scalar, so that the backward starts from 1 x
                # grad_out, grad_out's own bits: handed a gradient tensor,
                # torch.autograd.grad imports its symbolic-shape checks,
                # seconds of set-up the first time in a process.
                self.grads = torch.autograd.grad(
                    (self.out * self.grad_out).sum(), leaves)
        # the autograd node of the newest replay whose backward is to come
        self.pending: Optional[weakref.ref] = None

    def busy(self) -> bool:
        return self.pending is not None and self.pending() is not None

    def forward(self, args: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        with torch.no_grad():
            for buf, a in zip(self.inputs, args):
                buf.copy_(a)
        self.fwd.replay()
        return self.out.detach().clone()

    def backward(self, grad: torch.Tensor) -> Tuple[Optional[torch.Tensor],
                                                    ...]:
        self.grad_out.copy_(grad)
        self.bwd.replay()
        self.pending = None
        grads = iter(self.grads)
        return tuple(next(grads).clone() if w else None for w in self.wants)


class _Replay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, capture: _Capture, *args: torch.Tensor) -> torch.Tensor:
        ctx.capture = capture
        if capture.bwd is not None:
            capture.pending = weakref.ref(ctx)
        return capture.forward(args)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad: torch.Tensor):
        return (None,) + ctx.capture.backward(grad)


class GraphCache:
    """``fn`` over CUDA tensors by graph replay, a capture a key (module
    docstring).  ``name`` prefixes the
    counters ``<name>.graph_captures`` and ``<name>.graph_replays``
    (``utils/profiling.py::count``).  A copy of the cache (a deep copy of
    the module that holds it) starts empty."""

    def __init__(self, fn: Callable[..., torch.Tensor], name: str):
        self.fn = fn
        self.name = name
        self._captures: Dict[tuple, _Capture] = {}

    def __deepcopy__(self, memo) -> "GraphCache":
        return GraphCache(self.fn, self.name)

    def __call__(self, *args: torch.Tensor) -> torch.Tensor:
        grad = torch.is_grad_enabled()
        wants = tuple(grad and a.requires_grad for a in args)
        key = (args[0].device, wants) + tuple(
            (a.shape, a.stride(), a.dtype) for a in args)
        capture = self._captures.get(key)
        if capture is None:
            capture = self._captures[key] = _Capture(self.fn, args, wants)
            count(f"{self.name}.graph_captures")
        elif capture.busy():
            return self.fn(*args)
        count(f"{self.name}.graph_replays")
        return _Replay.apply(capture, *args)
