"""The port's tracer (``tacotron2_torch/utils/profiling.py``) and the
benchmark's reading of its spans (``benchmark/harness/program_spans.py``).

Off, the tracer records nothing and makes no CUDA event; on (``enable()``
or a ``torch.profiler`` session), spans nest by thread, share their root's
id across threads, fill a bounded buffer and carry a device interval from
their events (stand-in events here, real ones in the ``cuda`` test).  A
tiny ``train_step`` and ``synthesize_wav`` on the CPU give their layer
spans in order.  The readers name each idle gap of the device by the
innermost program span over it and sum the device's busy time inside
spans' device intervals, on hand-made events.
"""

import collections
import os
import sys
import threading

import numpy as np
import pytest
import torch

from tacotron2_torch.config import (AudioConfig, Config, ModelConfig,
                                    TrainConfig)
from tacotron2_torch.infer import fused
from tacotron2_torch.models.hifigan import HiFiGAN
from tacotron2_torch.models.tacotron2 import Tacotron2, init_weights
from tacotron2_torch.train import step as port_step
from tacotron2_torch.train.optim import make_optimizer
from tacotron2_torch.train.state import create_train_state
from tacotron2_torch.utils import profiling
from tacotron2_torch.utils.profiling import Span, count, span

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
from benchmark.harness import program_spans  # noqa: E402
from benchmark.harness.trace import DeviceTrace  # noqa: E402

SMALL = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
             decoder_rnn_dim=48, prenet_dim=16, attention_rnn_dim=48,
             attention_dim=24, location_n_filters=8, location_kernel_size=15,
             postnet_embedding_dim=24, max_decoder_steps=12)
AUDIO = dict(n_fft=64, hop_length=16, win_length=64)


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


class FakeEvent:
    """A CUDA event's stand-in: records the fake device clock (ns)."""
    clock = [0]

    def __init__(self):
        self.record()

    def record(self):
        FakeEvent.clock[0] += 1000
        self.t = FakeEvent.clock[0]

    def elapsed_time(self, other):
        return (other.t - self.t) / 1e6


@pytest.fixture
def fake_cuda(monkeypatch):
    made = []

    def record():
        made.append(FakeEvent())
        return made[-1]

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(profiling, "_record", record)
    monkeypatch.setattr(profiling, "_synchronize", lambda: None)
    monkeypatch.setattr(profiling, "_anchor", None)
    yield made
    profiling.disable()
    profiling.drain()           # before the stand-ins go


def names(spans):
    return [s.name for s in spans]


def test_off_records_nothing_and_no_event(fake_cuda):
    assert span("a") is span("b")           # the shared null context
    with span("a"):
        with span("b"):
            count("c", 3)
    assert profiling.spans() == [] and profiling.counts() == {}
    assert fake_cuda == [] and profiling._anchor is None


def test_enable_and_disable():
    profiling.enable()
    with span("on"):
        count("c")
        count("c", 2)
    profiling.disable()
    with span("off"):
        count("c")
    assert names(profiling.spans()) == ["on"]
    assert profiling.counts() == {"c": 3}
    s, = profiling.spans()
    assert s.start_ns <= s.end_ns and s.device_start_ns is None


def test_profiler_session_turns_the_tracer_on():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with span("traced"):
            count("c")
    with span("after"):
        count("c")
        pass
    assert names(profiling.spans()) == ["traced"]
    assert profiling.counts() == {"c": 1}


def test_nesting_parents_and_roots():
    profiling.enable()
    with span("step", root=True) as root:
        with span("forward") as fwd:
            with span("encoder"):
                pass
        with span("loss"):
            pass
    with span("step", root=True):
        with span("optimizer"):
            pass
    got = profiling.spans()
    assert names(got) == ["step", "forward", "encoder", "loss", "step",
                          "optimizer"]
    by = {s.id: s for s in got}
    step1, forward, encoder, loss, step2, opt = got
    assert step1.id == root.id and forward.id == fwd.id
    assert step1.parent is None and step1.root == step1.id
    assert forward.parent == step1.id and encoder.parent == forward.id
    assert loss.parent == step1.id
    assert {forward.root, encoder.root, loss.root} == {step1.id}
    assert step2.root == step2.id != step1.id and opt.root == step2.id
    assert all(s.thread == threading.get_ident() for s in by.values())
    assert encoder.start_ns >= forward.start_ns
    assert encoder.end_ns <= forward.end_ns <= loss.start_ns


def test_span_on_another_thread_shares_the_root():
    profiling.enable()
    seen = {}

    def worker():
        with span("worker"):
            seen["thread"] = threading.get_ident()

    with span("step", root=True):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    step, work = profiling.spans()
    assert work.name == "worker" and work.parent is None
    assert work.root == step.id and work.thread == seen["thread"]
    assert work.thread != step.thread


def test_span_in_autograd_backward_belongs_to_the_step():
    """Autograd runs a backward on its own thread for CUDA tensors and on
    the caller's for CPU ones: either way the span joins the step."""

    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2.0 * x

        @staticmethod
        def backward(ctx, g):
            with span("inside backward"):
                return 2.0 * g

    profiling.enable()
    x = torch.ones(3, requires_grad=True)
    with span("train_step", root=True):
        with span("backward"):
            Scale.apply(x).sum().backward()
    step, bwd, inner = profiling.spans()
    assert (step.name, bwd.name, inner.name) == ("train_step", "backward",
                                                 "inside backward")
    assert inner.root == step.id and bwd.root == step.id
    assert inner.parent == (bwd.id if inner.thread == bwd.thread else None)
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_threads_lose_no_span_and_no_count():
    """More threads than cores, each opening spans under its own root and
    adding to one counter, with the interpreter switching threads often:
    every span and every count arrives, each span under its thread's
    root."""
    n_threads, n_spans = 2 * (os.cpu_count() or 4), 200
    profiling.enable()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with span("root", root=True):
                    with span("child"):
                        count("n")
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    got = profiling.spans()
    assert len(got) == 2 * n_threads * n_spans
    assert profiling.counts() == {"n": n_threads * n_spans}
    by = {s.id: s for s in got}
    assert len(by) == len(got)
    for s in got:
        if s.name == "child":
            root = by[s.parent]
            assert root.name == "root" and root.thread == s.thread
            assert s.root == root.id


def test_bounded_buffer_and_drain(monkeypatch):
    monkeypatch.setattr(profiling, "_buffer", collections.deque(maxlen=4))
    profiling.enable()
    for i in range(6):
        with span(f"s{i}"):
            pass
    count("frames", 5)
    assert names(profiling.spans()) == ["s2", "s3", "s4", "s5"]
    assert profiling.counts() == {"tracer.spans_dropped": 2, "frames": 5}
    assert names(profiling.drain()) == ["s2", "s3", "s4", "s5"]
    assert profiling.spans() == [] and profiling.counts() == {}


def test_device_interval_from_events_and_anchor(fake_cuda):
    profiling.enable()
    anchor_ev, anchor_host = profiling._anchor
    assert fake_cuda == [anchor_ev]
    with span("outer"):
        with span("inner"):
            pass
    outer, inner = profiling.spans()
    assert len(fake_cuda) == 5
    base = anchor_host - anchor_ev.t
    assert (outer.device_start_ns, inner.device_start_ns,
            inner.device_end_ns, outer.device_end_ns) == tuple(
        base + e.t for e in fake_cuda[1:])


def tiny_batch(seed=0, t_dec=16):
    rng = np.random.default_rng(seed)
    return {"text": rng.integers(1, 72, (2, 8)).astype(np.int32),
            "text_lengths": np.array([8, 6], np.int32),
            "mel": (rng.standard_normal((2, 80, t_dec)) - 5.0
                    ).astype(np.float32),
            "mel_lengths": np.array([t_dec, 12], np.int32)}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_spans(accum):
    cfg = Config(model=ModelConfig(**SMALL),
                 train=TrainConfig(precision="float32"))
    tx = make_optimizer(cfg.train)
    state = create_train_state(cfg, seed=0, tx=tx, device="cpu")
    batch = tiny_batch()
    profiling.enable()
    if accum == 1:
        port_step.train_step(state, batch, cfg=cfg, tx=tx, use_postnet=True,
                             sigma_warmup_steps=800)
    else:
        micro = {k: np.concatenate([v, v]).reshape((2,) + v.shape)
                 for k, v in batch.items()}
        port_step.train_step_accum(state, micro, cfg=cfg, tx=tx,
                                   use_postnet=True, sigma_warmup_steps=800,
                                   accum_steps=2)
    profiling.disable()
    got = profiling.spans()
    micro_step = ["forward", "encoder", "loss", "backward"]
    assert names(got) == ["train_step"] + micro_step * accum + ["optimizer"]
    root = got[0]
    by = {s.id: s for s in got}
    for s in got[1:]:
        assert s.root == root.id
        want = "forward" if s.name == "encoder" else "train_step"
        assert by[s.parent].name == want
    for a, b in zip(got[1:], got[2:]):
        if b.name != "encoder":
            assert a.end_ns <= b.start_ns


@pytest.mark.parametrize("vocoder", ["griffinlim", "hifigan"])
def test_synthesize_wav_spans(vocoder):
    n_mels = 80 if vocoder == "hifigan" else 8
    mcfg = ModelConfig(**SMALL, n_mels=n_mels)
    cfg = Config(model=mcfg, audio=AudioConfig(**AUDIO, n_mels=n_mels))
    model = init_weights(Tacotron2(mcfg), seed=0).eval()
    hifigan = HiFiGAN().eval() if vocoder == "hifigan" else None
    texts = ["Hello world.", "It costs four wugs."]
    profiling.enable()
    wavs = fused.synthesize_wav(model, texts, cfg, gl_iters=2,
                                hifigan_params=hifigan, device="cpu")
    profiling.disable()
    got = profiling.spans()
    assert names(got) == ["synthesize_wav", "frontend", "encoder", "decode",
                          "trim", "postnet", "vocoder", "fetch"]
    root = got[0]
    assert all(s.parent == root.id and s.root == root.id for s in got[1:])
    for a, b in zip(got[1:], got[2:]):
        assert a.end_ns <= b.start_ns
    assert profiling.counts() == {
        "postnet.frames": 2 * SMALL["max_decoder_steps"],
        "vocoder.frames": 2 * SMALL["max_decoder_steps"]}
    assert len(wavs) == 2


# ------------------------------------------------ the benchmark's readers

def mk(name, t0, t1, id_, parent=None, root=None, thread=1, dev=None):
    d0, d1 = dev or (None, None)
    return Span(name, id_, parent, root or id_, thread, t0, t1, d0, d1)


class FakeSession:
    def __init__(self, events, window):
        self.trace = DeviceTrace(torch.device("cpu"))
        self.trace.events = events
        self.trace.window = window


def test_idle_goes_to_the_innermost_span_across_threads(monkeypatch):
    """Window 0-1000 ns; the device is busy 0-100, 300-400, 600-650 and
    900-1000.  Idle gaps: 100-300 (midpoint 200, inside ``a`` on thread
    1), 400-600 (500: ``b`` on thread 2 started after ``a``, so it wins),
    650-900 (775: ``root`` alone).  A second run with spans ending at 700
    leaves the last gap to no program span."""
    spans = [mk("root", 0, 1000, 1), mk("a", 50, 600, 2, 1, 1, 1),
             mk("b", 450, 700, 3, None, 1, 2)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    events = [("k", 0, 100), ("k", 300, 400), ("k", 600, 650),
              ("k", 900, 1000)]
    s = FakeSession(events, (0, 1000))
    window_s = 1000 / 1e9
    assert program_spans.idle_share(s, "a") == pytest.approx(
        100 * 200e-9 / window_s)
    assert program_spans.idle_share(s, "b") == pytest.approx(
        100 * 200e-9 / window_s)
    assert program_spans.idle_share(s, "root") == pytest.approx(
        100 * 250e-9 / window_s)
    assert program_spans.idle_share(s, "absent") is None
    spans[:] = [mk("root", 0, 700, 1), mk("a", 50, 600, 2, 1, 1)]
    assert program_spans.idle_share(s, "root") == pytest.approx(0.0)
    assert program_spans.idle_share(s, "a") == pytest.approx(
        100 * 400e-9 / window_s)


def test_device_busy_inside_device_intervals(monkeypatch):
    """Busy time is the union of the events clipped to the spans' device
    intervals: overlapping events count once, an event across an
    interval's edge counts its inside part, and spans outside the window
    or without a device interval count for nothing."""
    spans = [mk("vocoder", 100, 200, 1, dev=(1000, 2000)),
             mk("vocoder", 300, 400, 2, dev=(3000, 3500)),
             mk("vocoder", 5000, 6000, 3, dev=(9000, 9900)),
             mk("decode", 100, 200, 4, dev=(500, 1000)),
             mk("postnet", 100, 200, 5)]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    events = [("a", 900, 1200), ("b", 1100, 1300), ("c", 1500, 1600),
              ("d", 1900, 3100), ("e", 3400, 3600), ("f", 9000, 9500)]
    s = FakeSession(events, (0, 4000))
    assert program_spans.device_busy_s(s, "vocoder") == pytest.approx(
        (300 + 100 + 100 + 100 + 100) / 1e9)
    assert program_spans.device_busy_s(s, "decode") == pytest.approx(
        100 / 1e9)
    assert program_spans.device_busy_s(s, "postnet") is None
    assert program_spans.busy_within(events, [(0, 10000)]) == \
        pytest.approx((400 + 100 + 1200 + 200 + 500) / 1e9)


def test_readers_give_none_without_the_tracer(monkeypatch):
    """A program with no ``spans`` (a checkout from before the tracer):
    every reader returns None and does not raise."""
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(profiling, "counts")
    s = FakeSession([("k", 0, 10)], (0, 100))
    assert program_spans.window_spans(s) == []
    assert program_spans.idle_share(s, "encoder") is None
    assert program_spans.device_busy_s(s, "vocoder") is None
    assert program_spans.counter("vocoder.frames") == 0


@pytest.mark.cuda
def test_cuda_span_device_interval_holds_its_kernels():
    """On the card: a span's device interval lies after the anchor, in
    stream order, and covers the work queued inside it (a matmul a few
    ms long), whatever the host did meanwhile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    profiling.enable()
    with span("work"):
        for _ in range(8):
            x = x @ x
            x = x / x.norm()
    with span("after"):
        pass
    torch.cuda.synchronize()
    work, after = profiling.spans()
    assert work.device_start_ns is not None
    assert work.device_start_ns <= work.device_end_ns
    assert work.device_end_ns <= after.device_start_ns
    assert work.device_end_ns - work.device_start_ns > 1e6
    # the host returns from its launches before the card is done
    assert work.device_end_ns > work.end_ns
