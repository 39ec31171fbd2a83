"""The encoder's BiLSTM as replayed CUDA graphs (``models/graphs.py``,
``models/layers.py::BiLSTM``), without JAX.

On the CPU: the eager loop and the function the graphs capture give the
bits of the cell loop the BiLSTM ran before it had graphs, values and
gradients; the graph cache's keys, counters and its guard for a forward
whose backward is still to come, with the two graphs played by eager
calls.  The tests marked ``cuda`` capture real graphs and hold them to
the eager loop bit for bit; they skip where there is no card.  This file
imports nothing of JAX, so on a machine with a card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_encoder_graph.py -q
"""

import numpy as np
import pytest
import torch

from tacotron2_torch.config import Config, ModelConfig, TrainConfig
from tacotron2_torch.data.dataset import Example, collate
from tacotron2_torch.models import graphs
from tacotron2_torch.models.encoder import Encoder, encoder_apply
from tacotron2_torch.models.layers import (BiLSTM, bilstm_scan, linear,
                                           lstm_update)
from tacotron2_torch.models.tacotron2 import (Tacotron2, init_projection_bias,
                                              init_weights)
from tacotron2_torch.train.optim import make_optimizer
from tacotron2_torch.train.state import create_train_state
from tacotron2_torch.train.step import train_step
from tacotron2_torch.utils import profiling


@pytest.fixture(autouse=True)
def _tracer_off():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def cell_loop(xs: torch.Tensor, w: dict) -> torch.Tensor:
    """The BiLSTM's forward as it was before the graphs, written out: each
    direction's cell stepped in a loop, its gates ``linear(x, weight_ih) +
    linear(h, weight_hh) + bias_ih + bias_hh``."""
    outs = []
    for d, reverse in (("fwd", False), ("bwd", True)):
        b, t, _ = xs.shape
        hidden = w[f"{d}.weight_hh"].shape[1]
        h = xs.new_zeros(b, hidden)
        c = xs.new_zeros(b, hidden)
        out = [None] * t
        for i in (range(t - 1, -1, -1) if reverse else range(t)):
            gates = (linear(xs[:, i], w[f"{d}.weight_ih"])
                     + linear(h, w[f"{d}.weight_hh"])
                     + w[f"{d}.bias_ih"].float() + w[f"{d}.bias_hh"].float())
            h, c = lstm_update(gates, c)
            out[i] = h
        outs.append(torch.stack(out, dim=1))
    return torch.cat(outs, dim=-1)


def seeded_lstm(in_dim, hidden, seed=0):
    lstm = BiLSTM(in_dim, hidden)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1)
                    * hidden ** -0.5)
    return lstm


def transposed_input(b, t, d, seed=1, device="cpu"):
    """(B, T, D) with the strides the encoder hands the BiLSTM: a
    transposed (B, D, T) conv output."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(b, d, t, generator=gen).to(device).requires_grad_()
    return x, x.transpose(1, 2)


ROUTES = {
    "cell loop": lambda lstm, xs, w: cell_loop(xs, w),
    "module": lambda lstm, xs, w: torch.func.functional_call(lstm, w, (xs,)),
    "function": lambda lstm, xs, w: bilstm_scan(xs, *(
        w[f"{d}.{n}"] for d in ("fwd", "bwd")
        for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))),
}


def values_and_grads(route, lstm, dtype, b=3, t=7, d=6):
    """Output and the gradients of a fixed random cotangent with respect to
    the fp32 masters and the input, with the weights cast to ``dtype`` as
    ``train/step.py::cast_params_for_compute`` casts them."""
    x, xs = transposed_input(b, t, d)
    masters = list(lstm.parameters())
    stand_ins = {n: p.to(dtype) for n, p in lstm.named_parameters()}
    out = ROUTES[route](lstm, xs, stand_ins)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    return out.detach(), torch.autograd.grad(out, masters + [x], g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["module", "function"])
def test_eager_loop_gives_the_cell_loops_bits(route, dtype):
    """On the CPU, ``BiLSTM.forward`` (which runs the loop eagerly there)
    and ``bilstm_scan`` on ``BiLSTM.weights()``' stand-ins, the function
    the graphs capture, give the cell loop's values and gradients bit for
    bit, through the bf16 cast of the masters as in training."""
    lstm = seeded_lstm(6, 5)
    want = values_and_grads("cell loop", lstm, dtype)
    got = values_and_grads(route, lstm, dtype)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert torch.equal(g, w)


class Play:
    """A stand-in for a ``torch.cuda.CUDAGraph``: ``replay`` runs ``fn``."""

    def __init__(self, fn):
        self.replay = fn


class CPUCapture(graphs._Capture):
    """``_Capture`` with its two graphs played by eager calls of ``fn`` on
    its own buffers, so that its buffers are shared between calls as a
    graph's are: a backward computes from the inputs the newest forward
    copied in.  The copies in and out, the guard and the counters are the
    class's own."""

    made = []

    def __init__(self, fn, args, wants):
        CPUCapture.made.append(wants)
        self.fn = fn
        self.wants = wants
        self.inputs = graphs.input_buffers(args, wants)
        self.out = torch.empty_like(fn(*self.inputs))
        self.fwd = Play(lambda: self.out.copy_(fn(*self.inputs)))
        self.bwd = self.grad_out = self.grads = None
        if any(wants):
            self.grad_out = torch.empty_like(self.out)
            self.grads = [torch.empty_like(a)
                          for a, w in zip(self.inputs, wants) if w]
            self.bwd = Play(self._backward)
        self.pending = None

    def _backward(self):
        with torch.enable_grad():
            ins = [a.detach().clone().requires_grad_(w)
                   for a, w in zip(self.inputs, self.wants)]
            gs = torch.autograd.grad(self.fn(*ins),
                                     [a for a, w in zip(ins, self.wants)
                                      if w], self.grad_out)
        for buf, g in zip(self.grads, gs):
            buf.copy_(g)


@pytest.fixture
def cpu_graphs(monkeypatch):
    CPUCapture.made = []
    monkeypatch.setattr(graphs, "_Capture", CPUCapture)
    profiling.enable()
    return graphs.GraphCache(bilstm_scan, "encoder")


def weights_of(lstm, dtype=torch.float32, grad=True):
    return [w.detach().to(dtype).requires_grad_(grad) for w in lstm.weights()]


CHANGE = {"same": {}, "B": dict(b=4), "T_enc": dict(t=9),
          "dtype": dict(dtype=torch.bfloat16), "grad": dict(grad=False)}


@pytest.mark.parametrize("change", list(CHANGE))
def test_cache_key_separates_shape_dtype_and_grad(change, cpu_graphs):
    """A call at a new B, T_enc, weight dtype or grad mode captures its own
    graph; new tensors with new values at the same key replay the first,
    and every call gives the eager loop's values."""
    lstm = seeded_lstm(6, 5)
    first = dict(b=3, t=7, dtype=torch.float32, grad=True)
    second = dict(first, **CHANGE[change])
    for i, kw in enumerate((first, second)):
        _, xs = transposed_input(kw["b"], kw["t"], 6, seed=i)
        ws = weights_of(lstm, kw["dtype"])
        with torch.set_grad_enabled(kw["grad"]):
            got = cpu_graphs(xs, *ws)
            want = bilstm_scan(xs, *ws)
        assert torch.equal(got, want)
        del got, want
    same = change == "same"
    assert profiling.counts() == {"encoder.graph_captures": 1 if same else 2,
                                  "encoder.graph_replays": 2}
    assert CPUCapture.made[-1] == (((False,) * 9) if change == "grad"
                                   else (True,) * 9)


@pytest.mark.parametrize("grad", [True, False])
def test_input_buffers_are_leaves_with_the_callers_strides(grad):
    """A capture's input buffers hold the arguments' values with their
    strides and are leaves, wanting a gradient as asked, even where an
    argument is a cast inside the caller's autograd graph: the captured
    backward must end at them."""
    lstm = seeded_lstm(6, 5)
    _, xs = transposed_input(3, 7, 6)
    args = (xs,) + tuple(w.to(torch.bfloat16) for w in lstm.weights())
    wants = (grad,) * len(args)
    for buf, a in zip(graphs.input_buffers(args, wants), args):
        assert buf.is_leaf and buf.requires_grad == grad
        assert buf.stride() == a.stride() and torch.equal(buf, a)


def test_a_forward_waits_for_its_backward(cpu_graphs):
    """Two forwards at one key before either backward: the second runs
    eagerly (the first's state in the graph's buffers is kept for its
    backward), both backwards give the eager loop's gradients, and once a
    backward has run, or a forward's outputs are dropped, the next forward
    replays again."""
    lstm = seeded_lstm(6, 5)
    runs = []
    for seed in (1, 2):
        x, xs = transposed_input(3, 7, 6, seed=seed)
        ws = weights_of(lstm)
        runs.append((x, ws, cpu_graphs(xs, *ws), bilstm_scan(xs, *ws)))
    assert profiling.counts()["encoder.graph_replays"] == 1
    for x, ws, got, want in runs:
        assert torch.equal(got, want)
        g = torch.randn(got.shape)
        for a, b in zip(torch.autograd.grad(got, ws + [x], g),
                        torch.autograd.grad(want, ws + [x], g)):
            assert torch.equal(a, b)
    _, xs = transposed_input(3, 7, 6, seed=3)
    dropped = cpu_graphs(xs, *weights_of(lstm))
    del dropped
    cpu_graphs(xs, *weights_of(lstm))
    assert profiling.counts() == {"encoder.graph_captures": 1,
                                  "encoder.graph_replays": 3}


def test_no_grad_capture_and_deep_copy(cpu_graphs):
    """Under ``no_grad`` the capture holds no backward, even for inputs
    that require grad, and its output is the caller's own copy; a deep copy
    of a module starts with an empty cache."""
    lstm = seeded_lstm(6, 5)
    _, xs = transposed_input(2, 5, 6)
    with torch.no_grad():
        a, b = (cpu_graphs(xs, *lstm.weights()) for _ in range(2))
    assert CPUCapture.made == [(False,) * 9]
    assert profiling.counts() == {"encoder.graph_captures": 1,
                                  "encoder.graph_replays": 2}
    assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    import copy
    assert copy.deepcopy(cpu_graphs)._captures == {}


@pytest.mark.parametrize("train", [False, True])
def test_encoder_counts_its_calls(train):
    """``encoder_apply`` counts ``encoder.calls`` on every call; on the
    CPU the BiLSTM runs eagerly, so nothing is captured or replayed."""
    mc = ModelConfig(n_symbols=20, symbols_embedding_dim=16,
                     encoder_embedding_dim=16)
    enc = Encoder(mc)
    tokens = torch.randint(1, 20, (2, 9))
    profiling.enable()
    for _ in range(3):
        encoder_apply(enc, tokens, train)
    assert profiling.counts() == {"encoder.calls": 3}


# ---------------------------------------------------------------- the card

def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def eager(monkeypatch):
    """Run the BiLSTM's loop eagerly on the card too."""
    monkeypatch.setattr(graphs.GraphCache, "__call__",
                        lambda self, *args: self.fn(*args))


@pytest.mark.cuda
def test_cuda_train_shape_through_the_cast():
    """At ``train-b128``'s shape (B=128, T_enc=160, 512 wide) the graphed
    BiLSTM's output and the gradients ``torch.autograd.grad`` takes
    through the bf16 cast to the fp32 masters and the input equal the
    eager loop's bit for bit, on two calls with other inputs and
    weights: the first captures, the second replays."""
    dev = cuda_device()
    lstm = seeded_lstm(512, 256).to(dev)
    profiling.enable()
    for seed in (1, 2):
        with torch.no_grad():
            for p in lstm.parameters():
                p.mul_(1.0 + 0.01 * seed)
        runs = []
        for graphed in (False, True):
            x, xs = transposed_input(128, 160, 512, seed=seed, device=dev)
            casts = [w.to(torch.bfloat16) for w in lstm.weights()]
            out = (lstm.graphs if graphed else bilstm_scan)(xs, *casts)
            g = torch.randn(out.shape, generator=torch.Generator().manual_seed(
                seed)).to(dev)
            runs.append((out.detach(), torch.autograd.grad(
                out, list(lstm.weights()) + [x], g)))
        (want, want_g), (got, got_g) = runs
        assert torch.equal(got, want)
        for a, b in zip(got_g, want_g):
            assert torch.equal(a, b)
    assert profiling.counts() == {"encoder.graph_captures": 1,
                                  "encoder.graph_replays": 2}


@pytest.mark.cuda
def test_cuda_eval_shapes_and_weight_changes(monkeypatch):
    """Eval (fp32, ``no_grad``) through ``encoder_apply`` at B=64 and the
    batch cells' T_enc of 48 and 64: each shape captures its own graph,
    the first stays intact after the second is made, a replay after the
    weights change in place reads the new weights, and every output equals
    the eager loop's bit for bit."""
    dev = cuda_device()
    model = init_weights(Tacotron2(ModelConfig()), seed=0).to(dev).eval()
    enc = model.encoder
    tokens = {t: torch.randint(1, 72, (64, t), generator=torch.Generator()
                               .manual_seed(t)).to(dev) for t in (48, 64)}
    orig = [p.detach().clone() for p in enc.lstm.parameters()]

    def change():
        enc.lstm.fwd.weight_hh.mul_(0.5)
        enc.lstm.bwd.bias_ih.add_(0.1)

    profiling.enable()
    with torch.no_grad():
        got = [encoder_apply(enc, tokens[t]) for t in (48, 64, 48)]
        change()
        got += [encoder_apply(enc, tokens[t]) for t in (64, 48)]
    counts = profiling.counts()
    eager(monkeypatch)
    with torch.no_grad():
        for p, o in zip(enc.lstm.parameters(), orig):
            p.copy_(o)
        want = [encoder_apply(enc, tokens[t]) for t in (48, 64, 48)]
        change()
        want += [encoder_apply(enc, tokens[t]) for t in (64, 48)]
    assert counts == {"encoder.calls": 5, "encoder.graph_captures": 2,
                      "encoder.graph_replays": 5}
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got[1], got[3])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_two_train_steps_under_the_graph(dtype, monkeypatch):
    """Two ``train_step``s of the full-width model with the BiLSTM under
    its graphs (the first step captures them) give the eager loop's
    losses, gradients and weights bit for bit (cuDNN's convolutions held
    to its deterministic algorithms, so that only the BiLSTM's route
    differs)."""
    dev = cuda_device()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    rng = np.random.default_rng(5)
    batch = collate([Example(
        text=rng.integers(1, 72, n).astype(np.int32),
        mel=(rng.standard_normal((80, m)) - 4.0).astype(np.float32))
        for n, m in ((30, 120), (21, 90), (25, 101), (17, 64))], 32, 64)
    cfg = Config(model=ModelConfig(), train=TrainConfig(precision=dtype))
    runs = {}
    for route in ("graph", "eager"):
        if route == "eager":
            eager(monkeypatch)
        tx = make_optimizer(cfg.train)
        seen = []

        class Recorded:
            @staticmethod
            def update(model, opt_state, grads, names):
                seen.append({n: g.clone() for n, g in grads.items()})
                tx.update(model, opt_state, grads, names)

        state = create_train_state(cfg, seed=0, tx=tx, device=dev)
        init_projection_bias(state.model, batch["mel"])
        profiling.enable()
        losses = [train_step(state, batch, cfg=cfg, tx=Recorded,
                             use_postnet=True, sigma_warmup_steps=100)[1]
                  for _ in range(2)]
        torch.cuda.synchronize()
        runs[route] = (losses, seen, state, profiling.counts())
        profiling.disable()
        profiling.drain()
    (g_l, g_g, g_s, g_c), (e_l, e_g, e_s, _) = runs["graph"], runs["eager"]
    assert g_c == {"encoder.calls": 2, "encoder.graph_captures": 1,
                   "encoder.graph_replays": 2}
    for a, b in zip(g_l, e_l):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(g_g, e_g):
        assert set(a) == set(b)
        for n in a:
            assert torch.equal(a[n], b[n]), n
    for (n, p), q in zip(g_s.model.named_parameters(),
                         e_s.model.parameters()):
        assert torch.equal(p, q), n
