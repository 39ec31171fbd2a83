"""WaveGlow's WN layer in two hand-written passes (``ops/
waveglow_kernel.py``, ``csrc/waveglow_wn.cu``, ``models/waveglow.py::
_wn``), without JAX.

On the CPU: ``_wn`` against the layer as it was written before the
passes, bit for bit; each plain version against the expressions it
replaced, bit for bit; the wrappers' refusals; the counters and their
reader.  The tests marked ``cuda`` hold each kernel to its plain version
run on the card, bit for bit, and ``waveglow_infer`` to the former layer
at the published widths; they skip where there is no card.  This file
imports nothing of JAX, so on a machine with a card and no JAX it runs
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_waveglow_kernel.py -q

Before the passes each product took its bias inside ``nn.Conv1d``.  On
the card that is cuDNN's product followed by PyTorch's own add of the
bias (``aten::_convolution``), the order ``_wn`` now takes, so the card
gives the former bits.  PyTorch's CPU convolution sums the bias into the
product itself, so on the CPU the former module calls part from ``_wn``
by that one rounding of each product, carried through the layers
(observed 1.8e-7 on outputs of size about 1; ``MODULE_TOL`` 2e-6).
"""

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import registry
from tacotron2_torch.models import waveglow as W
from tacotron2_torch.ops import waveglow_kernel as K
from tacotron2_torch.utils import profiling

MODULE_TOL = 2e-6
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def _tracer_off():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def former_wn(wn, x0, cond_in, c, bias_after=True):
    """``_wn`` as it was before the two passes.  With ``bias_after`` each
    of the layer's three products takes its bias after the product, as
    ``nn.Conv1d`` does on the card; else through the modules themselves."""
    def conv(mod, x, weight=None, bias=None):
        weight = mod.weight if weight is None else weight
        bias = mod.bias if bias is None else bias
        if not bias_after:
            return F.conv1d(x, weight, bias, mod.stride, mod.padding,
                            mod.dilation)
        return F.conv1d(x, weight, None, mod.stride, mod.padding,
                        mod.dilation) + bias[:, None]

    x = wn.start(x0)
    skip = None
    last = len(wn.in_layers) - 1
    for i, (layer, res_skip) in enumerate(zip(wn.in_layers,
                                              wn.res_skip_layers)):
        rows = slice(2 * c * i, 2 * c * (i + 1))
        a = conv(layer, x).add_(conv(wn.cond_layer, cond_in,
                                     wn.cond_layer.weight[rows],
                                     wn.cond_layer.bias[rows]))
        r = conv(res_skip, torch.tanh(a[:, :c]).mul_(torch.sigmoid(a[:, c:])))
        del a
        if i < last:
            x = x + r[:, :c]
            r = r[:, c:]
        skip = r if skip is None else skip + r
    out = wn.end(skip)
    h = out.shape[1] // 2
    return out[:, :h], out[:, h:]


def small_wn(n_layers, c=32, seed=0, device="cpu", dtype=torch.float32):
    cfg = W.WaveGlowConfig(n_channels=c, n_layers=n_layers, n_flows=1)
    return W.waveglow_init(seed, cfg).WN[0].to(device, dtype)


def randn(*shape, seed, device="cpu", dtype=torch.float32, scale=1.0):
    """Standard normal values drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(*shape, generator=gen, device=device)
            * scale).to(dtype)


# ------------------------------------------------------------- the CPU

@pytest.mark.parametrize("n_layers", [1, 3])
@torch.no_grad()
def test_wn_is_the_former_layer_bit_for_bit(n_layers):
    """fp32: ``_wn`` gives the former layer's bits (biases after the
    products): three layers hold a first, a middle and a last layer, one
    a layer that is first and last."""
    wn = small_wn(n_layers)
    x0 = randn(2, 4, 67, seed=1)
    cond = randn(2, 640, 67, seed=2)
    for got, want in zip(W._wn(wn, x0, cond, 32),
                         former_wn(wn, x0, cond, 32)):
        assert torch.equal(got, want)


@torch.no_grad()
def test_wn_near_the_former_module_calls():
    wn = small_wn(3)
    x0 = randn(2, 4, 67, seed=3)
    cond = randn(2, 640, 67, seed=4)
    for got, want in zip(W._wn(wn, x0, cond, 32),
                         former_wn(wn, x0, cond, 32, bias_after=False)):
        torch.testing.assert_close(got, want, rtol=0, atol=MODULE_TOL)


def gate_inputs(b, c, n, seed, device="cpu", dtype=torch.float32):
    return (randn(b, 2 * c, n, seed=seed, device=device, dtype=dtype,
                  scale=2.0),
            randn(b, 2 * c, n, seed=seed + 1, device=device, dtype=dtype,
                  scale=2.0),
            randn(2 * c, seed=seed + 2, device=device, dtype=dtype,
                  scale=0.1),
            randn(2 * c, seed=seed + 3, device=device, dtype=dtype,
                  scale=0.1))


def former_gate(p, q, b_in, b_cond):
    """The former passes on the biased products ``in_layers[i](x)`` and
    the conditioning's slice."""
    a = (p + b_in[:, None]).add_(q + b_cond[:, None])
    c = a.shape[1] // 2
    return torch.tanh(a[:, :c]).mul_(torch.sigmoid(a[:, c:]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_gate_is_the_former_passes(dtype):
    ins = gate_inputs(2, 16, 45, seed=5, dtype=dtype)
    want = former_gate(*ins)
    assert torch.equal(K.wn_gate_reference(*ins), want)
    assert torch.equal(K.wn_gate(*ins), want)
    assert want.dtype == dtype and want.shape == (2, 16, 45)


LAYERS = {"first": (True, False), "middle": (False, False),
          "last": (False, True), "only": (True, True)}


def res_skip_inputs(b, c, n, layer, seed, device="cpu",
                    dtype=torch.float32):
    """r, bias, x, skip of one layer: r of 2C channels below the last
    layer, C on it; skip None on the first."""
    first, last = LAYERS[layer]
    rc = c if last else 2 * c
    return (randn(b, rc, n, seed=seed, device=device, dtype=dtype),
            randn(rc, seed=seed + 1, device=device, dtype=dtype, scale=0.1),
            randn(b, c, n, seed=seed + 2, device=device, dtype=dtype),
            None if first else randn(b, c, n, seed=seed + 3, device=device,
                                     dtype=dtype))


def former_res_skip(r, bias, x, skip):
    """The former passes: the biased ``res_skip_layers[i](g)``, then
    ``x + r[:, :C]`` below the last layer and ``skip + r``.  Returns the
    new x and skip."""
    c = x.shape[1]
    r = r + bias[:, None]
    if r.shape[1] == 2 * c:
        x = x + r[:, :c]
        r = r[:, c:]
    return x, (r if skip is None else skip + r)


@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_res_skip_is_the_former_passes(layer, dtype):
    """Both the plain version and the wrapper on the CPU: x updated in
    place below the last layer and left alone on it, skip updated in
    place or (first layer) made."""
    for fn in (K.wn_res_skip_reference, K.wn_res_skip):
        r, bias, x, skip = res_skip_inputs(2, 16, 45, layer, seed=7,
                                           dtype=dtype)
        want_x, want_skip = former_res_skip(r, bias, x.clone(),
                                            None if skip is None
                                            else skip.clone())
        x_ptr = x.data_ptr()
        got = fn(r, bias, x, skip)
        assert torch.equal(x, want_x) and x.data_ptr() == x_ptr
        assert torch.equal(got, want_skip) and got.is_contiguous()
        assert got is skip if skip is not None else got.shape == x.shape


def bad_gate_cases():
    p, q, bi, bc = gate_inputs(2, 8, 12, seed=9)
    wide = torch.zeros(2, 16, 24)[:, :, ::2]
    return {
        "float16": ((p.half(), q.half(), bi.half(), bc.half()), TypeError),
        "float64": ((p.double(), q.double(), bi.double(), bc.double()),
                    TypeError),
        "mixed": ((p, q.bfloat16(), bi, bc), TypeError),
        "odd channels": ((p[:, :15], q[:, :15], bi[:15], bc[:15]),
                         ValueError),
        "q's shape": ((p, q[:, :, :11], bi, bc), ValueError),
        "bias length": ((p, q, bi[:8], bc), ValueError),
        "two dims": ((p[0], q[0], bi, bc), ValueError),
        "strided positions": ((wide, q, bi, bc), ValueError),
        "transposed": ((p.transpose(1, 2).contiguous().transpose(1, 2), q,
                        bi, bc), ValueError),
        "strided bias": ((p, q, torch.zeros(32)[::2], bc), ValueError),
        "meta device": ((p.to("meta"), q.to("meta"), bi.to("meta"),
                         bc.to("meta")), ValueError),
    }


@pytest.mark.parametrize("case", list(bad_gate_cases()))
def test_gate_refuses(case):
    args, error = bad_gate_cases()[case]
    with pytest.raises(error, match="wn_gate"):
        K.wn_gate(*args)


def bad_res_skip_cases():
    r, bias, x, skip = res_skip_inputs(2, 8, 12, "middle", seed=11)
    return {
        "float16": ((r.half(), bias.half(), x.half(), skip.half()),
                    TypeError),
        "float64": ((r.double(), bias.double(), x.double(), skip.double()),
                    TypeError),
        "mixed": ((r, bias, x, skip.bfloat16()), TypeError),
        "three C": ((torch.cat([r, x], 1), torch.zeros(24), x, skip),
                    ValueError),
        "bias length": ((r, bias[:8], x, skip), ValueError),
        "skip's shape": ((r, bias, x, skip[:, :, :11]), ValueError),
        "r's positions": ((r[:, :, :11], bias, x, skip), ValueError),
        "strided x": ((r, bias, torch.zeros(2, 8, 24)[:, :, ::2], skip),
                      ValueError),
        "transposed r": ((r.transpose(1, 2).contiguous().transpose(1, 2),
                          bias, x, skip), ValueError),
        "meta device": ((r.to("meta"), bias.to("meta"), x.to("meta"),
                         skip.to("meta")), ValueError),
    }


@pytest.mark.parametrize("case", list(bad_res_skip_cases()))
def test_res_skip_refuses(case):
    args, error = bad_res_skip_cases()[case]
    with pytest.raises(error, match="wn_res_skip"):
        K.wn_res_skip(*args)


def test_counters_count_one_call_and_their_reader():
    """One ``waveglow_infer`` call counts every WN layer it ran; on the CPU
    none went through the kernels.  ``waveglow_fused_share`` reads their
    ratio, and None without them."""
    reader = registry.load_reader("waveglow_fused_share")
    assert reader.read(None, None) is None
    cfg = W.WaveGlowConfig(n_channels=16, n_layers=2, n_flows=4,
                           n_early_every=2)
    model = W.waveglow_init(0, cfg)
    profiling.enable()
    W.waveglow_infer(model, randn(2, 80, 3, seed=13))
    profiling.disable()
    counts = profiling.counts()
    assert counts["waveglow.wn_layers"] == 4 * 2
    assert "waveglow.wn_layers_fused" not in counts
    assert reader.read(None, None) == 0.0
    profiling.enable()
    profiling.count("waveglow.wn_layers_fused", 8)
    assert reader.read(None, None) == 100.0


def counted(fn):
    """``fn`` with a launch count that every call adds to, as the wrappers'
    count their kernels' launches on the card."""
    def wrapper(*args):
        wrapper.launches += 1
        return fn(*args)
    wrapper.launches = 0
    return wrapper


@pytest.mark.parametrize("launching", [(), ("wn_gate",), ("wn_res_skip",),
                                       ("wn_gate", "wn_res_skip")])
def test_fused_counter_follows_the_launches(launching, monkeypatch):
    """``waveglow.wn_layers_fused`` counts a layer only where both of its
    passes launched a kernel, read from the wrappers' launch counts (and
    not from the device the tensors are on)."""
    for name in launching:
        monkeypatch.setattr(W, name, counted(getattr(K, name)))
    cfg = W.WaveGlowConfig(n_channels=16, n_layers=3, n_flows=2,
                           n_early_every=4)
    model = W.waveglow_init(0, cfg)
    profiling.enable()
    W.waveglow_infer(model, randn(1, 80, 2, seed=17))
    profiling.disable()
    counts = profiling.counts()
    assert counts["waveglow.wn_layers"] == 2 * 3
    fused = counts.get("waveglow.wn_layers_fused", 0)
    assert fused == (2 * 3 if len(launching) == 2 else 0)


# ------------------------------------------------------------- the card

def cuda_device() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a hand-written kernel has no CPU "
                    "mode")
    return torch.device("cuda")


def padded(t, pad):
    """``t`` (B, R, N) as a view into rows of N + pad positions that start
    four channels into a larger tensor: every row still on 16 bytes,
    the batch and channel strides not the contiguous ones."""
    b, rows, n = t.shape
    big = torch.zeros(b, rows + 8, n + pad, dtype=t.dtype, device=t.device)
    view = big[:, 4:4 + rows, :n]
    view.copy_(t)
    return view


SHAPES = {"B1": (1, 512, 16384, 0), "B64": (64, 512, 16384, 0),
          "ragged": (3, 512, 4099, 0), "ragged in padded rows": (3, 512,
                                                                 4099, 5)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_gate_is_its_plain_version(dtype, shape):
    """The kernel against its plain version on the card, same inputs, bit
    for bit: B=1 and B=64 at C=512 (the vector build), N=4099 contiguous
    (ragged against the vector width: one value a thread) and in padded,
    offset rows (the vector build with a masked last tile)."""
    dev = cuda_device()
    b, c, n, pad = SHAPES[shape]
    p, q, bi, bc = gate_inputs(b, c, n, seed=17, device=dev, dtype=dtype)
    if pad:
        p, q = padded(p, pad), padded(q, pad)
    launches = K.wn_gate.launches
    got = K.wn_gate(p, q, bi, bc)
    want = K.wn_gate_reference(p, q, bi, bc)
    torch.cuda.synchronize()
    assert K.wn_gate.launches == launches + 1
    assert got.dtype == dtype and got.shape == (b, c, n)
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("layer", list(LAYERS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_res_skip_is_its_plain_version(dtype, layer, shape):
    dev = cuda_device()
    b, c, n, pad = SHAPES[shape]
    r, bias, x, skip = res_skip_inputs(b, c, n, layer, seed=19, device=dev,
                                       dtype=dtype)
    if pad:
        r, x = padded(r, pad), padded(x, pad)
        skip = None if skip is None else padded(skip, pad)
    x_ref = x.clone()
    skip_ref = None if skip is None else skip.clone()
    launches = K.wn_res_skip.launches
    got = K.wn_res_skip(r, bias, x, skip)
    want = K.wn_res_skip_reference(r, bias, x_ref, skip_ref)
    torch.cuda.synchronize()
    assert K.wn_res_skip.launches == launches + 1
    assert got is skip if skip is not None else got.shape == (b, c, n)
    assert torch.equal(x, x_ref)
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@torch.no_grad()
def test_cuda_wn_is_the_former_layer(dtype):
    """One WN at the published widths (8 layers, 512 channels) under
    cuDNN's defaults: with the kernels, the former layer's bits."""
    dev = cuda_device()
    wn = W.WN(4, 640, W.WaveGlowConfig())
    for m in wn.modules():
        if isinstance(m, torch.nn.Conv1d):
            m.weight.copy_(randn(*m.weight.shape, seed=29, scale=0.03))
            m.bias.copy_(randn(*m.bias.shape, seed=31, scale=0.1))
    wn = wn.to(dev, dtype)
    x0 = randn(2, 4, 2048, seed=37, device=dev, dtype=dtype)
    cond = randn(2, 640, 2048, seed=41, device=dev, dtype=dtype)
    for got, want in zip(W._wn(wn, x0, cond, 512),
                         former_wn(wn, x0, cond, 512, bias_after=False)):
        assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@torch.no_grad()
def test_cuda_waveglow_infer_is_the_former_layer(dtype, monkeypatch):
    """At the published widths (12 flows of 8 layers, 512 channels), fp32
    weights in TF32 as the benchmark runs them and bf16: the waveform of
    ``waveglow_infer`` with the kernels is the former layer's (its
    ``nn.Conv1d`` calls with their biases), bit for bit; every one of the
    96 layers went through both kernels and the counters say so.

    cuDNN's default algorithm for the upsampling's transposed convolution
    at this shape (B=2, 64 frames) is not deterministic: on an H100 its
    output moved by 3e-8 from call to call, and the waveform of one
    unchanged program by 3.5e-3.  So both sides ask cuDNN for
    deterministic algorithms; a single WN with the kernels and without
    them gives the same bits under cuDNN's defaults too."""
    dev = cuda_device()
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = W.waveglow_init(0).to(dev, dtype)
    mel = randn(2, 80, 64, seed=23, device=dev)
    gate, res_skip = K.wn_gate.launches, K.wn_res_skip.launches
    profiling.enable()
    got = W.waveglow_infer(model, mel)
    profiling.disable()
    torch.cuda.synchronize()
    counts = profiling.counts()
    assert counts["waveglow.wn_layers"] == 96
    assert counts["waveglow.wn_layers_fused"] == 96
    assert K.wn_gate.launches - gate == 96
    assert K.wn_res_skip.launches - res_skip == 96
    monkeypatch.setattr(W, "_wn", lambda wn, x0, cond, c: former_wn(
        wn, x0, cond, c, bias_after=False))
    want = W.waveglow_infer(model, mel)
    assert got.shape == want.shape == (2, 64 * 256)
    assert torch.equal(got, want), (got - want).abs().max().item()
