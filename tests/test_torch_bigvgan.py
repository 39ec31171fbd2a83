"""BigVGAN (``models/bigvgan.py``) against the benchmark's plain reference
(``benchmark/reference/bigvgan.py``), on the CPU.

The generator at a small width (64 initial channels, the published rates,
kernels and dilations) against the reference on seeded weights; the
anti-aliasing filter's values; the replicate edges; the parameter count
at the published widths (built on ``meta``); the receptive radius, pinned
by gradients in float64; NVIDIA's layout through the loader and the seam
(``load_vocoder("bigvgan")``, the fallback); ``synthesize_wav(...,
vocoder=)`` on the cut route against the reference, and the same as its
``hifigan_params=`` and ``waveglow=`` aliases; the tracer's spans and
counters; ``inference_torch.py --vocoder bigvgan`` on a seeded file.

Limits.  Both sides compute in fp32, in different orders (the reference
upsamples by a zero-stuffed convolution and divides by exp(beta), the
program takes a grouped transposed convolution and multiplies by the
reciprocal), so they part by round-off: observed 6e-8 at the small width
and 8e-8 at the published widths, on outputs up to 0.35.  ``WAV_TOL`` 2e-6
leaves 25 times that; the program in bfloat16 reads above 1e-3 against the
fp32 reference and fails it (:func:`test_bf16_fails_the_limit`).
"""

import dataclasses
import os
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.counts import bigvgan as counts
from benchmark.reference import bigvgan as R
from tacotron2_torch.config import Config, ModelConfig
from tacotron2_torch.infer import fused, vocode
from tacotron2_torch.models import bigvgan as B
from tacotron2_torch.models.hifigan import hifigan_init
from tacotron2_torch.models.tacotron2 import Tacotron2, init_weights
from tacotron2_torch.models.waveglow import WaveGlowConfig, waveglow_init
from tacotron2_torch.utils import profiling

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints", "r4_synth_bf16")
WAV_TOL = 2e-6
SMALL = B.BigVGANConfig(upsample_initial_channel=64)
# the filter's first six taps, to 6 digits (the rest mirror them)
TAPS = (0.002029, 0.009389, -0.025543, -0.057657, 0.128573, 0.443210)
TACO = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
            decoder_rnn_dim=48, prenet_dim=16, attention_rnn_dim=48,
            attention_dim=24, location_n_filters=8, location_kernel_size=15,
            postnet_embedding_dim=24, max_decoder_steps=300)


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


@pytest.fixture(scope="module")
def small():
    return B.bigvgan_init(0, SMALL).eval()


def widths(cfg: B.BigVGANConfig) -> dict:
    return dataclasses.asdict(cfg)


def mel_for(b: int, t: int, seed: int) -> torch.Tensor:
    """A log-mel of realistic range (floor -11.5 to about 0)."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, 80, t, generator=g) * -11.5


def test_generator_matches_reference(small):
    mel = mel_for(2, 6, 5)
    got = B.bigvgan_apply(small, mel)
    want = R.infer(small.state_dict(), widths(SMALL), mel)
    assert got.shape == (2, 6 * 256) and got.dtype == torch.float32
    assert float(want.abs().max()) > 0.05
    assert float((got - want).abs().max()) < WAV_TOL


def test_bf16_fails_the_limit(small):
    """The program in bfloat16 parts from the fp32 reference by far more
    than ``WAV_TOL``: the limit would catch a step down in precision."""
    mel = mel_for(2, 6, 5)
    want = R.infer(small.state_dict(), widths(SMALL), mel)
    got = B.bigvgan_apply(B.bigvgan_init(0, SMALL).to(torch.bfloat16), mel)
    assert float((got - want).abs().max()) > 100 * WAV_TOL


def test_filter():
    f = B.kaiser_sinc_filter()
    assert f.shape == (12,) and f.dtype == torch.float32
    assert np.allclose(f[:6].numpy(), TAPS, atol=1e-6)
    assert torch.equal(f, f.flip(0))
    assert abs(float(f.sum()) - 1.0) < 1e-6
    assert torch.equal(f, R.lowpass(widths(B.BigVGANConfig())))


def test_replicate_edges():
    """At the edges the activation pads by copying the end samples: the
    reference's edge copies agree, a zero-padded variant does not."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 40, generator=g) + 2.0
    la, lb = (torch.rand(8, generator=g) - 0.5 for _ in range(2))
    f = B.kaiser_sinc_filter()
    got = B.anti_aliased_snake_beta(x, la, lb, f)
    want = R.activation(x, la, lb, f, 2)
    assert got.shape == x.shape
    assert float((got - want).abs().max()) < 1e-5
    zero_pad = types.SimpleNamespace(
        pad=lambda t, pad, mode: F.pad(t, pad), conv1d=F.conv1d,
        conv_transpose1d=F.conv_transpose1d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(B, "F", zero_pad)
        zeroed = B.anti_aliased_snake_beta(x, la, lb, f)
    edges = (got - zeroed).abs()
    assert float(edges[..., :3].max()) > 0.05
    assert float(edges[..., -3:].max()) > 0.05
    assert float(edges[..., 8:-8].max()) == 0.0


def test_parameter_count_at_published_widths():
    with torch.device("meta"):
        model = B.BigVGAN()
    n = sum(p.numel() for p in model.parameters())
    h = widths(B.BigVGANConfig())
    assert n == counts.params(h) == 112_199_473
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        R.shapes(h)
    assert counts.activations(h) == 109
    assert counts.act_elems(h) == 614_400
    assert 1.80e9 < counts.frame(h) < 1.81e9
    assert model.ups[0][0].in_channels == 1536
    assert model.conv_post.in_channels == 24 and model.conv_post.bias \
        is not None


def test_receptive_radius():
    """``RECEPTIVE_FRAMES`` (38 at the published widths) is exact: the
    gradients of an output sample in float64 reach the mel frames the
    count gives, and none further."""
    assert B.RECEPTIVE_FRAMES == B.receptive_frames(SMALL) == 38
    assert B.RECEPTIVE_FRAMES > fused.TRIM_MARGIN
    lo, hi = B._receptive_span(SMALL)
    model = B.bigvgan_init(1, SMALL).double()
    t0 = 40
    mel = mel_for(1, 2 * t0, 6).double().requires_grad_()
    reach = {}
    with torch.enable_grad():
        y = B.bigvgan_apply.__wrapped__(model, mel)
        for n in (t0 * 256, t0 * 256 + 255):
            g, = torch.autograd.grad(y[0, n], mel, retain_graph=True)
            frames = torch.nonzero(g[0].abs().sum(0)).flatten()
            reach[n] = (int(frames.min()) - t0, int(frames.max()) - t0)
            assert reach[n] == (-(-(n - hi) // 256) - t0,
                                (n - lo) // 256 - t0)
    assert list(reach.values()) == [(-38, 37), (-37, 38)]


def test_nvidia_loader_and_seam(small, tmp_path, monkeypatch, capsys):
    """NVIDIA's layout (weight norm, the filter buffers, under
    ``generator``) folds back to the module; the seam loads it by name,
    from the argument or ``$BIGVGAN_CHECKPOINT``, and falls back with a
    line where there is no file or a filter is wrong."""
    sd = B.nvidia_state_dict(small)
    assert "conv_pre.weight_g" in sd and "ups.0.0.weight_v" in sd
    assert "resblocks.0.activations.5.act.beta" in sd
    assert "resblocks.17.activations.0.downsample.lowpass.filter" in sd
    assert "activation_post.upsample.filter" in sd
    path = tmp_path / "bigvgan_generator.pt"
    torch.save({"generator": sd}, path)
    mel = mel_for(1, 6, 8)
    want = B.bigvgan_apply(small, mel)
    loaded = vocode.load_vocoder("bigvgan", str(path), device="cpu")
    assert isinstance(loaded, B.BigVGAN) and loaded.cfg == SMALL
    assert float((loaded(mel) - want).abs().max()) < WAV_TOL
    monkeypatch.setenv("BIGVGAN_CHECKPOINT", str(path))
    plain = tmp_path / "plain.pt"
    torch.save(B.nvidia_state_dict(small, weight_norm=False), plain)
    for p in (None, str(plain)):
        back = B.load_bigvgan_params(p, device="cpu")
        for k, v in small.state_dict().items():
            assert torch.allclose(back.state_dict()[k], v, atol=1e-6), k
    bad = dict(sd)
    bad["activation_post.upsample.filter"] = torch.ones(1, 1, 12) / 12
    with pytest.raises(ValueError, match="activation_post.upsample.filter"):
        B.params_from_nvidia_state_dict(bad)
    assert vocode.try_load_vocoder("bigvgan", "no/such/file.pt",
                                   device="cpu") is None
    out = capsys.readouterr().out
    assert "BigVGAN unavailable (FileNotFoundError: " in out
    assert "falling back to Griffin-Lim." in out
    assert vocode.VOCODERS["bigvgan"] == "BigVGAN"


@pytest.fixture(scope="module")
def taco():
    return init_weights(Tacotron2(ModelConfig(**TACO)), seed=0).eval()


def forced(monkeypatch, ends):
    """Stops forced at frame 96, frame ends as given: the 128 bucket."""
    calls = []
    orig = fused.tacotron2_infer

    def infer(*args, **kw):
        kw["forced_stop_at"] = 96
        out, n_frames, _ = orig(*args, **kw)
        frame_ends = torch.tensor(ends, dtype=torch.int32)
        calls.append((out, frame_ends))
        return out, n_frames, frame_ends

    monkeypatch.setattr(fused, "tacotron2_infer", infer)
    return calls


def test_synthesize_wav_matches_reference(taco, small, monkeypatch):
    """``synthesize_wav(..., vocoder=)``: BigVGAN over the whole masked
    cut buffer, each row trimmed at ``frame_ends * hop``; the reference on
    the buffer the program vocoded; 109 activation spans a call, their
    counters."""
    calls = forced(monkeypatch, [96, 60])
    cfg = Config(model=ModelConfig(**TACO))
    profiling.enable()
    wavs = fused.synthesize_wav(taco, ["Hello world.", "It costs four."],
                                cfg, vocoder=small, device="cpu")
    profiling.disable()
    out, ends = calls[-1]
    masked = fused._mask_and_slice(out.mel_postnet, ends, 128,
                                   cfg.audio.mel_eps)
    want = R.infer(small.state_dict(), widths(SMALL), masked.transpose(1, 2))
    for b, e in enumerate(ends.tolist()):
        assert wavs[b].shape == (e * 256,)
        assert np.abs(wavs[b] - want[b, :e * 256].numpy()).max() < WAV_TOL
    names = [s.name for s in profiling.spans()]
    assert names.count("vocoder") == 1
    assert names.count("bigvgan.act") == counts.activations(
        widths(SMALL)) == 109
    c = profiling.counts()
    assert c["bigvgan.acts"] == 109
    assert c["bigvgan.act_elems"] == 2 * 128 * counts.act_elems(
        widths(SMALL))


@pytest.mark.parametrize("alias", ["hifigan_params", "waveglow"])
def test_vocoder_keyword_and_its_aliases(taco, monkeypatch, alias):
    """``vocoder=`` and the older keyword give the same samples; two
    vocoders at once are refused."""
    forced(monkeypatch, [96])
    cfg = Config(model=ModelConfig(**TACO))
    voc = (hifigan_init(2) if alias == "hifigan_params" else waveglow_init(
        2, WaveGlowConfig(n_channels=16, n_layers=2, n_flows=4,
                          n_early_every=2))).eval()
    texts = ["Hello world."]
    a = fused.synthesize_wav(taco, texts, cfg, vocoder=voc, device="cpu")
    b = fused.synthesize_wav(taco, texts, cfg, device="cpu", **{alias: voc})
    assert len(a) == len(b) == 1 and np.array_equal(a[0], b[0])
    with pytest.raises(ValueError, match="give one of"):
        fused.synthesize_wav(taco, texts, cfg, vocoder=voc, device="cpu",
                             **{alias: voc})


def test_inference_cli_bigvgan(tmp_path, capsys):
    """``inference_torch.py --vocoder bigvgan --bigvgan_checkpoint F`` on
    the trained acoustic checkpoint and a seeded generator file in
    NVIDIA's layout writes the WAV of the length-proportional path with
    BigVGAN."""
    import inference_torch
    from tacotron2_torch.dsp.wav import load_audio
    path = tmp_path / "bigvgan_generator.pt"
    torch.save({"generator": B.nvidia_state_dict(B.bigvgan_init(4, SMALL))},
               path)
    out_dir = tmp_path / "out"
    inference_torch.main(["Hello world.", "--checkpoint", CKPT, "--device",
                          "cpu", "--vocoder", "bigvgan",
                          "--bigvgan_checkpoint", str(path),
                          "--output_dir", str(out_dir)])
    assert "(BigVGAN length-proportional path)" in capsys.readouterr().out
    wav, sr = load_audio(str(out_dir / "output_1.wav"))
    assert sr == 22050 and len(wav) % 256 == 0 and np.abs(wav).max() > 0
