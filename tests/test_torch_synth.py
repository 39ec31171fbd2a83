"""The text -> PCM slice as a whole against the JAX package (CPU).

Small config: shared weights (``load_jax_params``), shared token ids, and
the JAX package's own initial Griffin-Lim phase handed to the port, through
``synthesize_wav_fused``, ``synthesize_pcm_proportional``,
``synthesize_wav`` and ``vocode_mels``, and each of them with HiFi-GAN (a
seeded generator bridged into the JAX package's params, at 80 mels); the export tool's weights file
against the checkpoint it was made from.  Full width, on
``checkpoints/r4_synth_bf16`` through ``load_jax_params``: the sentences
that ``chip_smoke.py`` speaks, with the gate firing by itself at the pinned
frame, and ``synthesize`` from a weights file the export tool writes into
the test's temporary directory.

Limits.  Mels: the repo's 2e-3 (``tests/test_torch_model.py``).  Waveforms
after a few Griffin-Lim iterations: 2e-3 of the peak (the iteration
amplifies the mel's 1e-6 differences; observed ~1e-4).  PCM: one LSB for
the two roundings (both round half to even) plus the waveform limit.
Full width in bf16 is an autoregressive rollout of 130-220 steps that
feeds every rounding difference back in: the two sides agree on the gate
stop (observed: exactly; held to 3 frames) and on the attention's path
(observed 1-2 positions; held to 3), the first ten frames stay within 0.2
(observed 0.14 on log-mels of mean size 9) and the whole utterance within
0.1 on average (observed 0.002-0.05), while single late frames may differ
by more than 1.
"""

import functools
import importlib
import os
import re
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tacotron2_tpu.config import AudioConfig as JaxAudioConfig
from tacotron2_tpu.config import Config as JaxConfig
from tacotron2_tpu.config import ModelConfig as JaxModelConfig
from tacotron2_tpu.infer import fused as jfused
from tacotron2_tpu.infer import vocode as jvocode
from tacotron2_tpu.models.tacotron2 import (cast_params_bf16 as
                                            jax_cast_params_bf16)
from tacotron2_tpu.models.tacotron2 import tacotron2_infer_jit, tacotron2_init
from tacotron2_tpu.train.checkpoint import save_params_only
from tacotron2_torch.config import AudioConfig, Config, ModelConfig
from tacotron2_torch.dsp import griffinlim as tgl
from tacotron2_torch.dsp.wav import load_audio
from tacotron2_torch.infer import fused, vocode
from tacotron2_torch.infer import synthesize as synth
from tacotron2_torch.models import hifigan, waveglow
from tacotron2_torch.models.tacotron2 import (Tacotron2, cast_params_bf16,
                                              tacotron2_infer)
from tacotron2_torch.text import pad_sequences, text_to_sequence
from tacotron2_torch.utils import profiling
from tacotron2_torch.utils.weights import (export_jax_hifigan_params,
                                           load_jax_params)

# the module, not the function of the same name that its package exports
jsynth = importlib.import_module("tacotron2_tpu.infer.synthesize")
ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from tools.export_torch_weights import export  # noqa: E402
CKPT = os.path.join(ROOT, "checkpoints", "r4_synth_bf16")
SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32,
             max_decoder_steps=16)
AUDIO = dict(n_fft=64, hop_length=16, win_length=64, n_mels=8)
TEXTS = ["Hello world.", "It costs 42 wugs, they're sure."]
# chip_smoke.py's sentences and the gate stops the JAX package gives for
# them on the CPU (bf16 serving cast, one sentence at a time)
SMOKE_FRAME_ENDS = {"The quick brown fox.": 131,
                    "Speech synthesis on one card.": 220,
                    "It costs 42 dollars.": 174,
                    "A zorblaxian wug sings.": 171}
MEL_TOL, WAV_TOL = 2e-3, 2e-3
WAVEGLOW_TINY = waveglow.WaveGlowConfig(n_channels=16, n_layers=2,
                                        n_flows=4, n_early_every=2)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def small():
    params, state = tacotron2_init(jax.random.PRNGKey(3),
                                   JaxModelConfig(**SMALL))
    model = load_jax_params(Tacotron2(ModelConfig(**SMALL)), np_tree(params),
                            np_tree(state))
    jcfg = JaxConfig(model=JaxModelConfig(**SMALL),
                     audio=JaxAudioConfig(**AUDIO))
    cfg = Config(model=ModelConfig(**SMALL), audio=AudioConfig(**AUDIO))
    return params, state, model, jcfg, cfg


@pytest.fixture
def jax_phase(monkeypatch):
    """Hand the port the JAX package's own initial-phase draw."""
    def draw(shape, seed, device):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.PRNGKey(seed), tuple(shape), minval=0.0,
            maxval=2.0 * np.pi)))
    monkeypatch.setattr(tgl, "_initial_phase", draw)


def batch(texts):
    return pad_sequences([text_to_sequence(t) for t in texts],
                         pad_multiple=16)


def assert_wav_close(got, ref):
    assert got.shape == ref.shape
    peak = float(np.abs(ref).max())
    assert peak > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=WAV_TOL * peak, rtol=0)


def assert_pcm_close(got, ref):
    assert got.dtype == ref.dtype == np.int16 and got.shape == ref.shape
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32)).max()
    assert diff <= 1 + WAV_TOL * np.abs(ref.astype(np.int32)).max(), diff


@pytest.mark.parametrize("forced", [None, 5])
def test_synthesize_wav_fused(small, jax_phase, forced):
    params, state, model, jcfg, cfg = small
    tokens, lengths = batch(TEXTS)
    ref_wav, ref_n, ref_ends = jfused.synthesize_wav_fused(
        params, state, jcfg.model, jcfg.audio, jnp.asarray(tokens),
        jnp.asarray(lengths), max_steps=12, stop_mode="all", gl_iters=2,
        forced_stop_at=None if forced is None else jnp.int32(forced))
    wav, _, n, ends = fused.synthesize_wav_fused(
        model, vocode.GriffinLim(cfg.audio, 2), cfg.audio, tokens, lengths,
        max_steps=12, stop_mode="all", forced_stop_at=forced, device="cpu")
    assert int(n) == int(ref_n) == (12 if forced is None else forced)
    np.testing.assert_array_equal(ends.numpy(), np.asarray(ref_ends))
    assert wav.shape == (2, 12 * 16)
    assert_wav_close(wav.numpy(), np.asarray(ref_wav))
    if forced is not None:      # past the stop: the log floor, near silence
        tail = wav.numpy()[:, (forced + 4) * 16:]
        assert np.abs(tail).max() < 1e-2 * np.abs(wav.numpy()).max()


@pytest.mark.parametrize("expected,forced,bucket", [
    (3, 3, 4),        # the bucket holds the stop: no escalation
    (3, 6, 16),       # the gate is still open at the cap: one escalation
    (None, 6, 16),    # bucket from the text length (7/token + 40 > limit)
    (7, None, 16),    # never fires: escalates, ends at the limit
])
def test_synthesize_pcm_proportional(small, jax_phase, expected, forced,
                                     bucket):
    params, state, model, jcfg, cfg = small
    tokens, lengths = batch(TEXTS[:1])
    kw = dict(expected_frames=expected, gl_iters=2, buckets=(4, 8, 16),
              return_mel=True)
    ref = jfused.synthesize_pcm_proportional(
        params, state, jcfg.model, jcfg.audio, jnp.asarray(tokens),
        jnp.asarray(lengths),
        forced_stop_at=None if forced is None else jnp.int32(forced), **kw)
    got = fused.synthesize_pcm_proportional(
        model, cfg.audio, tokens, lengths, forced_stop_at=forced,
        device="cpu", **kw)
    assert got[2] == ref[2] == bucket
    np.testing.assert_array_equal(got[1], ref[1])
    assert int(got[1][0]) == (forced if forced is not None else 16)
    assert got[0].shape == (1, bucket * 16)
    assert_pcm_close(got[0], ref[0])
    assert got[3].shape == (1, bucket, SMALL["n_mels"])
    np.testing.assert_allclose(got[3], ref[3], atol=MEL_TOL, rtol=0)
    assert len(fused.synthesize_pcm_proportional(
        model, cfg.audio, tokens, lengths, expected_frames=3,
        forced_stop_at=2, gl_iters=0, buckets=(4, 16), device="cpu")) == 3


def test_synthesize_wav_buckets_and_texts(small, jax_phase):
    params, state, model, jcfg, cfg = small
    tokens, lengths = batch(TEXTS)
    kw = dict(max_steps=12, stop_mode="all", gl_iters=1, buckets=(4, 8, 16))
    ref_pcm, ref_ends = jfused.synthesize_wav_buckets(
        params, state, jcfg.model, jcfg.audio, jnp.asarray(tokens),
        jnp.asarray(lengths), forced_stop_at=jnp.int32(7), **kw)
    pcm, ends = fused.synthesize_wav_buckets(
        model, cfg.audio, tokens, lengths, forced_stop_at=7, device="cpu",
        **kw)
    np.testing.assert_array_equal(ends, ref_ends)
    assert pcm.shape == (2, 8 * 16)                 # 7 frames -> bucket 8
    assert_pcm_close(pcm.numpy(), np.asarray(ref_pcm))
    # texts in, trimmed float waveforms out
    ref_wavs = jfused.synthesize_wav(params, state, TEXTS, cfg=jcfg,
                                     max_steps=9, gl_iters=1)
    wavs = fused.synthesize_wav(model, TEXTS, cfg=cfg, max_steps=9,
                                gl_iters=1, device="cpu")
    assert len(wavs) == 2
    for w, r in zip(wavs, ref_wavs):
        assert w.dtype == np.float32
        assert_wav_close(w, np.asarray(r))


def test_helpers_match():
    for n, limit in ((1, 1000), (128, 1000), (129, 1000), (900, 640),
                     (5000, 1000)):
        assert fused.pick_bucket(n, limit) == jfused.pick_bucket(n, limit)
    assert fused.VOCODE_BUCKETS == jfused.VOCODE_BUCKETS
    for n in (0, 17, 160):
        assert fused.estimate_frames(n) == jfused.estimate_frames(n)
    wav = np.array([0.0, 0.5 / 32767, 1.5 / 32767, -2.5 / 32767, 2.0, -2.0],
                   np.float32)
    np.testing.assert_array_equal(
        fused._to_pcm16(torch.from_numpy(wav)).numpy(),
        np.asarray(jfused._to_pcm16(jnp.asarray(wav))))
    mel = np.random.default_rng(0).standard_normal((2, 6, 8)).astype(
        np.float32)
    ends = np.array([2, 9], np.int32)
    np.testing.assert_array_equal(
        fused._mask_and_slice(torch.from_numpy(mel), torch.from_numpy(ends),
                              5, 1e-5).numpy(),
        np.asarray(jfused._mask_and_slice(jnp.asarray(mel), jnp.asarray(ends),
                                          5, 1e-5)))


def test_vocode_mels(small, jax_phase):
    *_, jcfg, cfg = small
    rng = np.random.default_rng(1)
    mels = [(rng.standard_normal((t, 8)) - 4).astype(np.float32)
            for t in (5, 130, 128, 7, 3)]
    gl = vocode.GriffinLim(cfg.audio, 2)
    ref = jvocode.vocode_mels(mels, jcfg.audio, griffinlim_iters=2,
                              max_group=2)
    got = vocode.vocode_mels(mels, cfg.audio, gl, max_group=2, device="cpu")
    for m, g, r in zip(mels, got, ref):
        assert g.shape == (m.shape[0] * 16,)
        assert_wav_close(g, np.asarray(r))
    one = vocode.vocode_mel(mels[0], cfg.audio, gl, device="cpu")
    assert_wav_close(one, np.asarray(jvocode.vocode_mel(
        mels[0], jcfg.audio, griffinlim_iters=2)))
    # a vocoder callable takes the place of Griffin-Lim: a device tensor
    # in, a device tensor out
    calls = []

    def fake(mel_ct):
        assert torch.is_tensor(mel_ct) and mel_ct.dtype == torch.float32
        calls.append(tuple(mel_ct.shape))
        return torch.zeros(mel_ct.shape[0], mel_ct.shape[2] * 16)

    out = vocode.vocode_mels(mels, cfg.audio, fake, device="cpu")
    assert [o.shape[0] for o in out] == [m.shape[0] * 16 for m in mels]
    assert all(isinstance(o, np.ndarray) for o in out)
    assert sorted(calls) == [(1, 8, 256), (4, 8, 128)]
    # a group is vocoded at its own size: no batch padding to discard
    calls.clear()
    vocode.vocode_mels(mels, cfg.audio, fake, max_group=3, device="cpu")
    assert sorted(calls) == [(1, 8, 128), (1, 8, 256), (3, 8, 128)]
    np.testing.assert_array_equal(
        vocode._pad_frames(mels[0], 8, 1e-5),
        jvocode._pad_frames(mels[0], 8, 1e-5))
    assert vocode._FRAME_BUCKET == jvocode._FRAME_BUCKET


@pytest.fixture(scope="module")
def small80():
    """The small model at the 80 mels and 256-sample hop of the HiFi-GAN
    generator, and one generator: the port's seeded one, bridged into the
    JAX package's params."""
    mcfg = dict(SMALL, n_mels=80)
    params, state = tacotron2_init(jax.random.PRNGKey(4),
                                   JaxModelConfig(**mcfg))
    model = load_jax_params(Tacotron2(ModelConfig(**mcfg)), np_tree(params),
                            np_tree(state))
    gen = hifigan.hifigan_init(seed=0)
    jcfg = JaxConfig(model=JaxModelConfig(**mcfg))
    return (params, state, export_jax_hifigan_params(gen), model, gen, jcfg,
            Config(model=ModelConfig(**mcfg)))


def test_hifigan_branches_match_jax(small80):
    """Every HiFi-GAN branch of the fused path against the JAX package's,
    on the same Tacotron 2 weights and the same generator."""
    params, state, jgen, model, gen, jcfg, cfg = small80
    tokens, lengths = batch(TEXTS)
    ref = jfused.synthesize_wav_fused_hifigan(
        params, state, jgen, jcfg.model, jcfg.audio, jnp.asarray(tokens),
        jnp.asarray(lengths), max_steps=5, stop_mode="all")
    got = fused.synthesize_wav_fused(
        model, gen, cfg.audio, tokens, lengths, max_steps=5,
        stop_mode="all", device="cpu")
    assert got[0].shape == (2, 5 * 256) and int(got[2]) == int(ref[2]) == 5
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               atol=MEL_TOL, rtol=0)
    assert_wav_close(got[0].numpy(), np.asarray(ref[0]))
    # the exact chunked generator (six windows) as the vocoder
    one, one_len = batch(TEXTS[:1])
    kw = dict(max_steps=44, device="cpu")
    whole = fused.synthesize_wav_fused(model, gen, cfg.audio, one, one_len,
                                       **kw)
    chunked = fused.synthesize_wav_fused(
        model, functools.partial(hifigan.hifigan_apply_chunked, gen,
                                 chunk=8), cfg.audio, one, one_len, **kw)
    np.testing.assert_allclose(chunked[0].numpy(), whole[0].numpy(),
                               atol=2e-5, rtol=0)
    # the two-phase pipeline's HiFi-GAN vocode of the bucket
    kw = dict(max_steps=12, stop_mode="all", buckets=(4, 8, 16))
    ref_pcm, ref_ends = jfused.synthesize_wav_buckets(
        params, state, jcfg.model, jcfg.audio, jnp.asarray(tokens),
        jnp.asarray(lengths), forced_stop_at=jnp.int32(3),
        hifigan_params=jgen, **kw)
    pcm, ends = fused.synthesize_wav_buckets(
        model, cfg.audio, tokens, lengths, forced_stop_at=3, vocoder=gen,
        device="cpu", **kw)
    np.testing.assert_array_equal(ends, ref_ends)
    assert pcm.shape == (2, 4 * 256)
    assert_pcm_close(pcm.numpy(), np.asarray(ref_pcm))
    # the length-proportional path picks the bucket before the decode
    kw = dict(expected_frames=3, buckets=(4, 8, 16), return_mel=True)
    ref = jfused.synthesize_pcm_proportional(
        params, state, jcfg.model, jcfg.audio, jnp.asarray(one),
        jnp.asarray(one_len), forced_stop_at=jnp.int32(3),
        hifigan_params=jgen, **kw)
    got = fused.synthesize_pcm_proportional(
        model, cfg.audio, one, one_len, forced_stop_at=3, vocoder=gen,
        device="cpu", **kw)
    assert got[2] == ref[2] == 4 and got[0].shape == (1, 4 * 256)
    np.testing.assert_array_equal(got[1], ref[1])
    assert_pcm_close(got[0], ref[0])
    np.testing.assert_allclose(got[3], ref[3], atol=MEL_TOL, rtol=0)
    # texts in, trimmed float waveforms out
    ref_wavs = jfused.synthesize_wav(params, state, TEXTS, cfg=jcfg,
                                     max_steps=5, hifigan_params=jgen)
    wavs = fused.synthesize_wav(model, TEXTS, cfg=cfg, max_steps=5,
                                hifigan_params=gen, device="cpu")
    for w, r in zip(wavs, ref_wavs):
        assert w.dtype == np.float32 and w.shape == (5 * 256,)
        assert_wav_close(w, np.asarray(r))


@pytest.mark.parametrize("path", ["synthesize_wav_fused",
                                  "synthesize_pcm_proportional"])
@pytest.mark.parametrize("name", ["griffinlim", "hifigan", "waveglow"])
def test_each_vocoder_through_the_seam(small80, name, path):
    """Each vocoder of ``infer/vocode.py`` through either path: exactly the
    vocoder's own waveform of the masked mel the path returns, one
    ``vocoder`` span, and ``vocoder.frames`` = B x S."""
    *_, model, gen, _, cfg = small80
    voc = {"griffinlim": vocode.GriffinLim(cfg.audio, 2), "hifigan": gen,
           "waveglow": waveglow.waveglow_init(0, WAVEGLOW_TINY).eval()}[name]
    tokens, lengths = batch(TEXTS)
    kw = dict(stop_mode="all", forced_stop_at=5, device="cpu")
    profiling.disable()
    profiling.drain()
    profiling.enable()
    try:
        if path == "synthesize_wav_fused":
            wav, mel, _, ends = fused.synthesize_wav_fused(
                model, voc, cfg.audio, tokens, lengths, max_steps=8, **kw)
        else:
            pcm, ends, bucket, mel = fused.synthesize_pcm_proportional(
                model, cfg.audio, tokens, lengths, expected_frames=6,
                buckets=(4, 8, 16), vocoder=voc, return_mel=True, **kw)
            assert bucket == 8
            mel = torch.from_numpy(mel)
    finally:
        profiling.disable()
    names = [s.name for s in profiling.spans()]
    counts = profiling.counts()
    profiling.drain()
    assert names.count("vocoder") == 1, names
    assert counts["vocoder.frames"] == 2 * 8
    assert mel.shape == (2, 8, 80) and list(ends) == [5, 5]
    floor = float(np.float32(np.log(cfg.audio.mel_eps)))
    assert bool((mel[:, 5:] == floor).all())
    want = voc(mel.transpose(1, 2))
    assert want.shape == (2, 8 * 256)
    if path == "synthesize_wav_fused":
        assert torch.equal(wav, want)
    else:
        assert np.array_equal(pcm, fused._to_pcm16(want).numpy())


FALLBACK = re.compile(r"^HiFi-GAN unavailable \((\w+): .+\); falling back "
                      r"to Griffin-Lim\.$", re.M)


def test_hifigan_falls_back_to_griffin_lim(small, tmp_path, capsys):
    """``synthesize(vocoder="hifigan")`` finds no HiFi-GAN, says so in the
    JAX package's words and writes the Griffin-Lim WAV, bit for bit; any
    other name is Griffin-Lim too."""
    _, _, model, _, cfg = small
    weights = str(tmp_path / "weights.pt")
    torch.save(model.state_dict(), weights)
    assert jvocode.try_load_hifigan_params() is None
    jax_line = FALLBACK.search(capsys.readouterr().out)
    paths = {v: synth.synthesize("Hello world.", weights,
                                 str(tmp_path / v), vocoder=v, cfg=cfg,
                                 griffinlim_iters=2, device="cpu")
             for v in ("griffinlim", "HiFiGAN", "other")}
    out = capsys.readouterr().out
    assert jax_line and len(FALLBACK.findall(out)) == 1
    assert vocode.try_load_vocoder("hifigan", device="cpu") is None
    assert FALLBACK.search(capsys.readouterr().out)
    assert vocode.try_load_vocoder("griffinlim", device="cpu") is None
    assert not capsys.readouterr().out
    ref, _ = load_audio(paths["griffinlim"])
    for v in ("HiFiGAN", "other"):
        got, _ = load_audio(paths[v])
        assert got.dtype == ref.dtype and np.array_equal(got, ref), v


def test_load_model_round_trip(small, tmp_path):
    _, _, model, _, cfg = small
    path = str(tmp_path / "weights.pt")
    sd = {k: (v.to(torch.bfloat16) if k.endswith("weight") else v)
          for k, v in model.state_dict().items()}
    torch.save(sd, path)
    loaded = synth.load_model(path, cfg, device="cpu")
    for k, v in loaded.state_dict().items():    # upcast on load
        assert v.dtype == torch.float32 and torch.equal(v, sd[k].float()), k
    out, _, _ = tacotron2_infer(loaded, [[3, 4, 5]], max_steps=4,
                                device="cpu")
    assert torch.isfinite(out.mel_postnet).all()
    with pytest.raises(FileNotFoundError):
        synth.load_model(str(tmp_path / "none.pt"), cfg, device="cpu")
    with pytest.raises(ValueError, match="Orbax"):
        synth.load_model(CKPT, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="could not load"):
        synth.load_model(path, Config(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            synth.load_model(path, cfg)


def test_load_model_serves_fp32(small, tmp_path):
    """A bf16 weights file loads as fp32 parameters and buffers equal to
    the file's values, as the JAX package restores a bf16 checkpoint into
    its fp32 template; the file itself stays bf16."""
    _, _, model, _, cfg = small
    path = str(tmp_path / "bf16.pt")
    sd = cast_params_bf16(model).state_dict()
    torch.save(sd, path)
    loaded = synth.load_model(path, cfg, device="cpu")
    named = dict(loaded.named_parameters())
    assert any(sd[k].dtype == torch.bfloat16 for k in named)
    for k, v in list(loaded.named_parameters()) + list(loaded.named_buffers()):
        assert v.dtype == torch.float32 and torch.equal(v, sd[k].float()), k
    assert all(v.dtype == sd[k].dtype for k, v in torch.load(
        path, weights_only=True).items())


def test_synthesize_mels_from_texts(small):
    params, state, model, jcfg, _ = small
    ref_mels, ref_al = jsynth.synthesize_mels(params, state, TEXTS, cfg=jcfg,
                                              max_steps=10)
    mels, al = synth.synthesize_mels(model, TEXTS, max_steps=10, device="cpu")
    for r, g in zip(ref_mels, mels):
        assert r.shape == g.shape
        np.testing.assert_allclose(r, g, atol=MEL_TOL, rtol=0)
    np.testing.assert_allclose(ref_al, al, atol=5e-4, rtol=0)
    tok_mels, _ = synth.synthesize_mels_tokens(
        model, [text_to_sequence(t) for t in TEXTS], max_steps=10,
        device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(mels, tok_mels))


def test_next_output_path_and_mel_stats(tmp_path, capsys):
    first = synth.next_output_path(str(tmp_path / "out"))
    assert first.endswith("output_1.wav")
    open(first, "w").close()
    assert synth.next_output_path(str(tmp_path / "out")).endswith(
        "output_2.wav")
    synth.print_mel_stats(np.full((4, 8), -3.0), "x")
    jsynth.print_mel_stats(np.full((4, 8), -3.0), "x")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:2] == lines[2:] and "likely log-compressed" in lines[1]


def test_export_tool_round_trip(small, tmp_path):
    """``tools/export_torch_weights.py`` on a small seeded model: a
    params-only checkpoint of the JAX package (stored as bf16 numbers) ->
    weights file -> ``load_model``, tensor for tensor against
    ``load_jax_params``; the file holds bf16 parameters and fp32
    statistics, and both load as fp32."""
    params, state, _, _, cfg = small
    params = jax_cast_params_bf16(params)
    ckpt = str(tmp_path / "ckpt")
    save_params_only(ckpt, params, state)
    path = str(tmp_path / "weights.pt")
    sd = export(ckpt, path, **SMALL)
    ref = load_jax_params(Tacotron2(ModelConfig(**SMALL)), np_tree(
        jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)),
        np_tree(state)).state_dict()
    loaded = synth.load_model(path, cfg, device="cpu")
    named = dict(loaded.named_parameters())
    assert set(sd) == set(ref) == set(loaded.state_dict())
    for k, v in loaded.state_dict().items():    # the file: bf16 parameters
        assert sd[k].dtype == (torch.bfloat16 if k in named
                               else torch.float32), k
        assert v.dtype == torch.float32, k
        assert torch.equal(v, ref[k]) and torch.equal(v, sd[k].float()), k


@pytest.fixture(scope="module")
def full_width():
    params, state = jsynth.load_model(CKPT)
    model = load_jax_params(Tacotron2(ModelConfig()), np_tree(params),
                            np_tree(state))
    return params, state, cast_params_bf16(model)


@pytest.mark.parametrize("text", list(SMOKE_FRAME_ENDS))
def test_smoke_sentences_full_width(full_width, text):
    """The gate fires by itself, at the pinned frame, on both sides."""
    params, state, model = full_width
    tokens, lengths = batch([text])
    ref, ref_n, ref_ends = tacotron2_infer_jit(
        jax_cast_params_bf16(params), state, JaxModelConfig(),
        jnp.asarray(tokens), max_steps=256,
        text_lengths=jnp.asarray(lengths))
    got, n, ends = tacotron2_infer(model, tokens, max_steps=256,
                                   text_lengths=lengths, device="cpu")
    want = SMOKE_FRAME_ENDS[text]
    assert int(ref_ends[0]) == int(ref_n) == want < 256
    assert int(ends[0]) == int(n) and abs(int(n) - want) <= 3
    k = min(int(n), want)
    diff = np.abs(got.mel_postnet[0, :k].numpy()
                  - np.asarray(ref.mel_postnet)[0, :k])
    assert diff[:10].max() <= 0.2 and diff.mean() <= 0.1
    path = got.alignments[0, :k].argmax(-1).numpy()
    ref_path = np.asarray(ref.alignments)[0, :k].argmax(-1)
    assert np.abs(path - ref_path).max() <= 3
    assert ref_path[-1] >= int(lengths[0]) - 3      # it read to the end


def test_synthesize_writes_the_same_wav(jax_phase, tmp_path):
    """``synthesize(text, weights file)``, the file exported from the
    checkpoint into the temporary directory, against the JAX package's
    ``synthesize(text, checkpoint)``: same frames, same audio."""
    text = "The quick brown fox."
    ref_path = jsynth.synthesize(text, CKPT, str(tmp_path / "jax"),
                                 griffinlim_iters=2)
    weights = str(tmp_path / "r4_synth_bf16.pt")
    sd = export(CKPT, weights)
    assert all(v.dtype == torch.bfloat16 for k, v in sd.items()
               if "running_" not in k)
    path = synth.synthesize(text, weights, str(tmp_path / "port"),
                            griffinlim_iters=2, device="cpu")
    assert os.path.basename(path) == "output_1.wav"
    ref, sr_ref = load_audio(ref_path)
    got, sr = load_audio(path)
    assert sr == sr_ref == 22050
    # both loaders serve the bf16 checkpoint upcast to fp32: the same gate
    # stop, the pinned one, and the same audio within the waveform limit
    # (observed 1.2e-4 of the peak)
    assert len(got) == len(ref) == SMOKE_FRAME_ENDS[text] * 256
    assert_wav_close(got, ref)
