"""WaveGlow (``models/waveglow.py``) against the benchmark's plain
reference (``benchmark/reference/waveglow.py``), on the CPU.

The program's inverse pass at a small size and at the published widths
(on a 3-frame mel), the reference's forward pass of the program's audio
(which must give back the drawn noise: the equations pinned from the
other side), ``synthesize_wav(..., waveglow=...)`` on the cut route
against the reference on the masked cut buffer with the seed-0 noise, the
parameter count against ``benchmark/counts/waveglow.py``, the NVIDIA
loader, the tracer's spans and counter, and ``inference_torch.py
--vocoder waveglow`` on a seeded file in the test's temporary directory.

Limits.  Both sides compute in fp32 here, in different orders (the
program forms each layer's conditioning from its own slice of
``cond_layer`` and multiplies by exp(-s), the reference takes the whole
product and divides by exp(s)), so they part by round-off carried through
the flows: observed 6e-7 at the small size and 1.4e-6 at the published
widths on outputs of rms 0.7-0.8.  ``WAV_TOL`` 2e-5 leaves ten times that;
the program in bfloat16 reads 3e-2 to 5e-2 against the fp32 reference and
fails it (:func:`test_bf16_fails_the_limit`).  The forward pass gives the
noise back within the same round-off (observed 1e-6, held to ``Z_TOL``).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.counts import waveglow as counts
from benchmark.reference import waveglow as R
from tacotron2_torch.config import Config, ModelConfig
from tacotron2_torch.dsp.wav import load_audio
from tacotron2_torch.infer import fused, vocode
from tacotron2_torch.models import waveglow as W
from tacotron2_torch.models.tacotron2 import Tacotron2, init_weights
from tacotron2_torch.text import pad_sequences, text_to_sequence
from tacotron2_torch.utils import profiling

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "checkpoints", "r4_synth_bf16")
WAV_TOL = 2e-5
Z_TOL = 2e-5
SMALL = W.WaveGlowConfig(n_channels=32, n_layers=4, n_flows=4,
                         n_early_every=2)
TINY = W.WaveGlowConfig(n_channels=16, n_layers=2, n_flows=4,
                        n_early_every=2)
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
    return W.waveglow_init(0, SMALL).eval()


@pytest.fixture(scope="module")
def published():
    return W.waveglow_init(1).eval()


def widths(cfg: W.WaveGlowConfig) -> dict:
    return dataclasses.asdict(cfg)


def mel_for(b: int, t: int, seed: int) -> torch.Tensor:
    """A log-mel of realistic range (floor -11.5 to about 0)."""
    g = torch.Generator().manual_seed(seed)
    return torch.rand(b, 80, t, generator=g) * -11.5


def reference(model: W.WaveGlow, mel: torch.Tensor, seed: int = 0,
              sigma=None, q=None) -> torch.Tensor:
    w = widths(model.cfg)
    b, _, t = mel.shape
    z = R.noise(b, t * 256 // 8, w, seed, mel.device)
    kw = {} if q is None else {"q": q}
    return R.infer(model.state_dict(), w, mel, z,
                   model.cfg.sigma if sigma is None else sigma, **kw)


@pytest.mark.parametrize("which,frames", [("small", 24), ("published", 3)])
def test_inverse_matches_reference(request, which, frames):
    model = request.getfixturevalue(which)
    mel = mel_for(2, frames, 5)
    got = W.waveglow_infer(model, mel)
    want = reference(model, mel)
    assert got.shape == (2, frames * 256) and got.dtype == torch.float32
    assert 0.3 < float(want.pow(2).mean().sqrt()) < 2.0
    assert float((got - want).abs().max()) < WAV_TOL


def test_reference_forward_gives_back_the_noise(small):
    """Audio -> z by the reference's forward pass (W, exp(s) * a1 + b,
    the early outputs in order) is sigma times the draw the program
    started from, slice by slice; its log-determinant is finite."""
    mel = mel_for(2, 24, 6)
    noise = W.draw_noise(2, 24 * 32, 8, "cpu", seed=3)
    audio = W.waveglow_infer(small, mel, noise=noise)
    z, log_det = R.forward(small.state_dict(), widths(SMALL), mel, audio)
    assert float((z - SMALL.sigma * noise).abs().max()) < Z_TOL
    assert torch.isfinite(log_det).all() and log_det.shape == (2,)


def test_noise_convention(small):
    """The default draw is seed 0 on the mel's device, once a call, and
    the reference draws the same; another seed or tensor changes it."""
    mel = mel_for(1, 8, 7)
    base = W.waveglow_infer(small, mel)
    n0 = W.draw_noise(1, 8 * 32, 8, "cpu")
    assert torch.equal(n0, R.noise(1, 8 * 32, widths(SMALL), 0, "cpu"))
    assert torch.equal(W.waveglow_infer(small, mel, noise=n0), base)
    assert torch.equal(W.waveglow_infer(small, mel, seed=0), base)
    assert not torch.allclose(W.waveglow_infer(small, mel, seed=1), base)
    louder = W.waveglow_infer(small, mel, sigma=1.0)
    assert float((louder - reference(small, mel, sigma=1.0)).abs().max()) \
        < WAV_TOL


def test_bf16_fails_the_limit(small):
    """The program in bfloat16 parts from the fp32 reference by far more
    than ``WAV_TOL``: the limit would catch a step down in precision."""
    mel = mel_for(2, 24, 5)
    want = reference(small, mel)
    got = W.waveglow_infer(W.waveglow_init(0, SMALL).to(torch.bfloat16),
                           mel)
    assert float((got - want).abs().max()) > 100 * WAV_TOL


def test_w_inverse_is_formed_once(small):
    """W^-1 is kept between calls and formed again when W changes."""
    model = W.waveglow_init(2, TINY)
    conv = model.convinv[0]
    first = conv.inverse()
    assert conv.inverse() is first
    eye = torch.eye(first.shape[0])
    assert torch.allclose(first[:, :, 0] @ conv.conv.weight[:, :, 0], eye,
                          atol=1e-6)
    model.load_state_dict(W.waveglow_init(3, TINY).state_dict())
    second = conv.inverse()
    assert second is not first
    assert torch.allclose(second[:, :, 0] @ conv.conv.weight[:, :, 0], eye,
                          atol=1e-6)


def test_init_orthogonal_and_end_drawn(small):
    for k, conv in enumerate(small.convinv):
        wt = conv.conv.weight.detach()[:, :, 0].double()
        assert torch.allclose(wt @ wt.T, torch.eye(wt.shape[0],
                                                   dtype=torch.float64),
                              atol=1e-6), k
        assert float(torch.det(wt)) > 0
        assert float(small.WN[k].end.weight.detach().abs().max()) > 0


def test_parameter_count_at_published_widths():
    with torch.device("meta"):
        model = W.WaveGlow()
    n = sum(p.numel() for p in model.parameters())
    w = widths(W.WaveGlowConfig())
    assert n == counts.params(w) == 267_999_848
    assert W.WaveGlowConfig().flow_channels() == [8] * 4 + [6] * 4 + [4] * 4
    assert [m.conv.weight.shape[0] for m in model.convinv] == \
        W.WaveGlowConfig().flow_channels()
    assert [layer.dilation[0] for layer in model.WN[0].in_layers] == \
        [1, 2, 4, 8, 16, 32, 64, 128]


def test_nvidia_loader_round_trip(small, tmp_path):
    """glow.py's layout with weight norm (and DeepLearningExamples'
    ``module.`` prefix under ``state_dict``) folds back to the module's
    weights, its widths read from the shapes."""
    sd = W.nvidia_state_dict(small)
    assert "WN.0.in_layers.0.weight_g" in sd and "WN.0.end.weight" in sd
    assert "convinv.0.conv.weight" in sd and "upsample.weight" in sd
    assert "WN.0.start.weight" not in sd
    back = W.params_from_nvidia_state_dict(sd)
    assert back.cfg == SMALL
    for k, v in small.state_dict().items():
        assert torch.allclose(back.state_dict()[k], v, atol=1e-6), k
    path = tmp_path / "waveglow.pt"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
               path)
    loaded = W.load_waveglow_params(str(path), device="cpu")
    mel = mel_for(1, 6, 8)
    assert float((W.waveglow_infer(loaded, mel)
                  - W.waveglow_infer(small, mel)).abs().max()) < WAV_TOL
    plain = W.params_from_nvidia_state_dict(
        W.nvidia_state_dict(small, weight_norm=False))
    for k, v in small.state_dict().items():
        assert torch.equal(plain.state_dict()[k], v), k


@pytest.fixture(scope="module")
def taco():
    return init_weights(Tacotron2(ModelConfig(**TACO)), seed=0).eval()


def test_synthesize_wav_matches_reference(taco, small, monkeypatch):
    """``synthesize_wav(..., waveglow=)``: the cut route (stops forced at
    frame 96 and 60, so the 128-frame bucket), WaveGlow over the whole
    masked cut buffer from the seed-0 noise, each row trimmed at
    ``frame_ends * hop``; the reference on the buffer the program
    vocoded; the spans and counters of the path."""
    calls = []
    orig = fused.tacotron2_infer

    def infer(*args, **kw):
        kw["forced_stop_at"] = 96
        out, n_frames, frame_ends = orig(*args, **kw)
        frame_ends = torch.tensor([96, 60], dtype=frame_ends.dtype)
        calls.append((out, frame_ends))
        return out, n_frames, frame_ends

    monkeypatch.setattr(fused, "tacotron2_infer", infer)
    cfg = Config(model=ModelConfig(**TACO))
    profiling.enable()
    wavs = fused.synthesize_wav(taco, ["Hello world.", "It costs four."],
                                cfg, waveglow=small, device="cpu")
    profiling.disable()
    out, ends = calls[-1]
    mel = out.mel_postnet
    assert mel.shape[1] == 128
    masked = fused._mask_and_slice(mel, ends, 128, cfg.audio.mel_eps)
    floor = float(np.float32(np.log(cfg.audio.mel_eps)))
    assert float(masked[1, 60:].max()) == float(masked[1, 60:].min()) \
        == floor
    want = reference(small, masked.transpose(1, 2))
    for b, e in enumerate(ends.tolist()):
        assert wavs[b].shape == (e * 256,)
        assert np.abs(wavs[b] - want[b, :e * 256].numpy()).max() < WAV_TOL
    names = [s.name for s in profiling.spans()]
    for name in ("vocoder", "waveglow.upsample", "waveglow.flows"):
        assert names.count(name) == 1, name
    c = profiling.counts()
    assert c["waveglow.groups"] == 2 * 128 * 32
    assert c["vocoder.frames"] == 2 * 128


def test_pcm_proportional_and_fallback(taco, small, capsys):
    """The length-proportional path takes WaveGlow where it is given, and
    where no file is the loader raises and its ``try_`` form falls back to
    Griffin-Lim, with a message."""
    tokens, lengths = pad_sequences([text_to_sequence("Hi there.")],
                                    pad_multiple=16)
    cfg = Config(model=ModelConfig(**TACO))
    pcm, ends, bucket = fused.synthesize_pcm_proportional(
        taco, cfg.audio, tokens, lengths, forced_stop_at=40, vocoder=small,
        device="cpu")
    mel, _, fe = fused.decode_mel_fused(taco, tokens, lengths,
                                        max_steps=bucket, forced_stop_at=40,
                                        device="cpu")
    masked = fused._mask_and_slice(mel, fe, bucket, cfg.audio.mel_eps)
    want = fused._to_pcm16(W.waveglow_infer(small, masked.transpose(1, 2)))
    assert np.array_equal(pcm, want.numpy())
    assert vocode.try_load_vocoder(
        "waveglow", "no/such/file.pt", device="cpu") is None
    out = capsys.readouterr().out
    assert out.count("WaveGlow unavailable (FileNotFoundError: ") == 1
    with pytest.raises(FileNotFoundError, match="WaveGlow checkpoint"):
        vocode.load_vocoder("waveglow", "no/such/file.pt", device="cpu")
    assert "falling back to Griffin-Lim." in out


def test_inference_cli_waveglow(tmp_path):
    """``inference_torch.py --vocoder waveglow --waveglow_checkpoint F``
    on the trained acoustic checkpoint and a seeded WaveGlow file (glow.py's
    layout, weight-normed) writes the WAV of the length-proportional path
    with WaveGlow; without the file it falls back to Griffin-Lim."""
    path = tmp_path / "waveglow.pt"
    torch.save(W.nvidia_state_dict(W.waveglow_init(4, TINY)), path)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    base = [sys.executable, os.path.join(ROOT, "inference_torch.py"),
            "Hello world.", "--checkpoint", CKPT, "--device", "cpu",
            "--vocoder", "waveglow"]
    runs = {}
    for name, extra in (("waveglow", ["--waveglow_checkpoint", str(path)]),
                        ("fallback", ["--waveglow_checkpoint",
                                      str(tmp_path / "none.pt")])):
        out_dir = tmp_path / name
        proc = subprocess.run(base + extra + ["--output_dir", str(out_dir)],
                              capture_output=True, text=True, env=env,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        runs[name] = (proc.stdout, load_audio(str(out_dir / "output_1.wav")))
    out, (wav, sr) = runs["waveglow"]
    assert "(WaveGlow length-proportional path)" in out
    assert sr == 22050 and len(wav) % 256 == 0 and np.abs(wav).max() > 0
    out_gl, (wav_gl, _) = runs["fallback"]
    assert "WaveGlow unavailable (FileNotFoundError: " in out_gl
    assert "(Griffin-Lim length-proportional path)" in out_gl
    assert len(wav_gl) == len(wav) and not np.array_equal(wav_gl, wav)
