"""The cut route of the fused synthesis path on the CPU, small seeded
models: ``trim`` of ``models/tacotron2.py::tacotron2_infer`` with
``infer/fused.py::trim_to_bucket``, which ``synthesize_wav`` takes.

Cut, the postnet and the vocoder run over the bucket that covers the
batch's last stop plus ``TRIM_MARGIN``.  Each row's frames up to its stop
are the whole buffer's, and so are HiFi-GAN's delivered samples; Griffin-
Lim's are Griffin-Lim over the cut buffer with the seed-0 phase drawn for
its shape, as the benchmark's check computes them.  Without ``trim`` every
buffer keeps ``max_steps``.  Stops are forced (``forced_stop_at``, passed
into the wrapped ``tacotron2_infer`` where a caller has no such keyword):
seeded weights fire no gate.
"""

import numpy as np
import pytest
import torch

from tacotron2_torch.config import AudioConfig, Config, ModelConfig
from tacotron2_torch.infer import fused
from tacotron2_torch.models.hifigan import hifigan_init
from tacotron2_torch.models.tacotron2 import (Tacotron2, init_weights,
                                              tacotron2_infer)
from tacotron2_torch.text import pad_sequences, text_to_sequence
from tacotron2_torch.utils import profiling

MAX_STEPS = 300
SMALL = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
             decoder_rnn_dim=48, prenet_dim=16, attention_rnn_dim=48,
             attention_dim=24, location_n_filters=8, location_kernel_size=15,
             postnet_embedding_dim=24, max_decoder_steps=MAX_STEPS)
GL_AUDIO = dict(n_fft=64, hop_length=16, win_length=64, n_mels=8)
TEXTS = ["Hello world.", "It costs four wugs."]
# 96 frames + the margin fill the 128-frame bucket exactly: HiFi-GAN's
# samples at the stop see 32 frames of the buffer past it
STOP = 96


@pytest.fixture(autouse=True)
def clean_tracer():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


@pytest.fixture(scope="module")
def models():
    """n_mels 80 (HiFi-GAN's) and 8 (Griffin-Lim at a small n_fft)."""
    out = {}
    for n_mels in (80, 8):
        mcfg = ModelConfig(**SMALL, n_mels=n_mels)
        out[n_mels] = init_weights(Tacotron2(mcfg), seed=0).eval()
    return out


def batch():
    return pad_sequences([text_to_sequence(t) for t in TEXTS],
                         pad_multiple=16)


def force_stop(monkeypatch, at):
    """Every decode the fused path runs stops all rows at ``at``."""
    orig = fused.tacotron2_infer

    def infer(*args, **kw):
        kw["forced_stop_at"] = at
        return orig(*args, **kw)

    monkeypatch.setattr(fused, "tacotron2_infer", infer)


@pytest.mark.parametrize("stop,want", [(24, 128), (STOP, 128), (100, 256),
                                       (200, 256), (None, MAX_STEPS)])
def test_cut_length_and_frames_before_the_stop(models, stop, want):
    """The cut buffers are ``pick_bucket(n_frames + 32, max_steps)`` long
    (``max_steps`` where no gate fires); the decode's outputs are the
    whole buffer's first frames, and each row's postnet frames up to its
    stop the whole buffer's within round-off."""
    model = models[80]
    tokens, lengths = batch()
    kw = dict(text_lengths=lengths, stop_mode="all", forced_stop_at=stop,
              gate_threshold=1.0, device="cpu")
    full, n_frames, ends = tacotron2_infer(model, tokens, **kw)
    cut, n_cut, ends_cut = tacotron2_infer(model, tokens,
                                           trim=fused.trim_to_bucket, **kw)
    n = int(n_frames)
    assert n == (MAX_STEPS if stop is None else stop) == int(n_cut)
    assert fused.pick_bucket(n + fused.TRIM_MARGIN, MAX_STEPS) == want
    assert torch.equal(ends, ends_cut)
    for a, b in zip(full, cut):
        assert a.shape[1] == MAX_STEPS and b.shape[1] == want
        assert b.shape[0] == a.shape[0] and b.shape[2:] == a.shape[2:]
    assert torch.equal(cut.mel_coarse, full.mel_coarse[:, :want])
    assert torch.equal(cut.gate_logits, full.gate_logits[:, :want])
    assert torch.equal(cut.alignments, full.alignments[:, :want])
    for b, e in enumerate(ends.tolist()):
        np.testing.assert_allclose(cut.mel_postnet[b, :e].numpy(),
                                   full.mel_postnet[b, :e].numpy(),
                                   rtol=0, atol=1e-5)


def test_postnet_frames_count_the_buffer(models):
    """``postnet.frames`` adds B x the postnet's buffer on every
    ``tacotron2_infer`` call, and the cut runs in a ``trim`` span between
    ``decode`` and ``postnet``."""
    tokens, lengths = batch()
    kw = dict(text_lengths=lengths, stop_mode="all", forced_stop_at=STOP,
              device="cpu")
    profiling.enable()
    tacotron2_infer(models[80], tokens, **kw)
    assert profiling.counts() == {"encoder.calls": 1,
                                  "postnet.frames": 2 * MAX_STEPS}
    assert "trim" not in [s.name for s in profiling.drain()]
    profiling.enable()
    tacotron2_infer(models[80], tokens, trim=fused.trim_to_bucket, **kw)
    assert profiling.counts() == {"encoder.calls": 1,
                                  "postnet.frames": 2 * 128}
    assert [s.name for s in profiling.spans()] == ["encoder", "decode",
                                                   "trim", "postnet"]


def test_hifigan_route_delivers_the_whole_buffers_samples(models,
                                                          monkeypatch):
    """HiFi-GAN: ``synthesize_wav`` (cut to 128 frames) delivers each
    row's samples of the uncut route within round-off;
    ``synthesize_wav_fused_hifigan`` keeps ``max_steps`` without ``trim``
    and vocodes 128 frames with it."""
    model = models[80]
    cfg = Config(model=model.cfg, audio=AudioConfig())
    hop = cfg.audio.hop_length
    hifigan = hifigan_init(0).eval()
    tokens, lengths = batch()
    force_stop(monkeypatch, STOP)
    kw = dict(stop_mode="all", device="cpu")
    with torch.no_grad():
        full_wav, full_mel, _, ends = fused.synthesize_wav_fused_hifigan(
            model, hifigan, cfg.audio, tokens, lengths, **kw)
        cut_wav, cut_mel, _, cut_ends = fused.synthesize_wav_fused_hifigan(
            model, hifigan, cfg.audio, tokens, lengths,
            trim=fused.trim_to_bucket, **kw)
        profiling.enable()
        wavs = fused.synthesize_wav(model, TEXTS, cfg,
                                    hifigan_params=hifigan, device="cpu")
        profiling.disable()
    assert full_mel.shape[1] == MAX_STEPS
    assert full_wav.shape == (2, MAX_STEPS * hop)
    assert cut_mel.shape[1] == 128 and cut_wav.shape == (2, 128 * hop)
    assert profiling.counts() == {"encoder.calls": 1,
                                  "postnet.frames": 2 * 128,
                                  "vocoder.frames": 2 * 128}
    assert torch.equal(ends, cut_ends) and ends.tolist() == [STOP, STOP]
    for b, e in enumerate(ends.tolist()):
        want = full_wav[b, :e * hop].numpy()
        assert wavs[b].shape == want.shape
        np.testing.assert_allclose(wavs[b], want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(cut_wav[b, :e * hop].numpy(), want,
                                   rtol=0, atol=1e-5)


def test_griffin_lim_route_draws_its_phase_for_the_cut(models, monkeypatch):
    """Griffin-Lim: ``synthesize_wav`` delivers Griffin-Lim over the cut
    buffer, masked past each stop, from the seed-0 phase drawn for
    (B, F, 128); the uncut route, its phase drawn for ``max_steps``
    frames, delivers other samples.  ``synthesize_wav_fused`` keeps
    ``max_steps`` without ``trim``."""
    model = models[8]
    acfg = AudioConfig(**GL_AUDIO)
    cfg = Config(model=model.cfg, audio=acfg)
    hop = acfg.hop_length
    tokens, lengths = batch()
    force_stop(monkeypatch, STOP)
    wavs = fused.synthesize_wav(model, TEXTS, cfg, gl_iters=2, device="cpu")
    full_wav, _, ends = fused.synthesize_wav_fused(
        model, acfg, tokens, lengths, stop_mode="all", gl_iters=2,
        device="cpu")
    assert full_wav.shape == (2, MAX_STEPS * hop)
    out, _, cut_ends = tacotron2_infer(model, tokens, text_lengths=lengths,
                                       stop_mode="all", forced_stop_at=STOP,
                                       trim=fused.trim_to_bucket,
                                       device="cpu")
    assert out.mel_postnet.shape[1] == 128
    assert torch.equal(ends, cut_ends)
    mel = fused._mask_and_slice(out.mel_postnet, cut_ends, 128, acfg.mel_eps)
    ref = fused._griffin_lim_wav(mel, acfg, 2)
    assert ref.shape == (2, 128 * hop)
    for b, e in enumerate(ends.tolist()):
        np.testing.assert_allclose(wavs[b], ref[b, :e * hop].numpy(),
                                   rtol=0, atol=1e-6)
        assert not np.allclose(wavs[b], full_wav[b, :e * hop].numpy(),
                               rtol=0, atol=1e-3)
