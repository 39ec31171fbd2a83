"""Streaming and long-form synthesis of the port against the JAX package
(CPU).

The tiny config of ``tests/test_server.py``, one set of weights from
``tacotron2_init(PRNGKey(0))`` bridged into the port
(``load_jax_params``), and the same texts on both sides.  The JAX side runs
once per module, in the fixture.

Limits.  Streamed mels against the JAX package's stream and against the
port's own offline decode: 1e-5 (the same fp32 arithmetic step by step;
the postnet over windows of other lengths sums in another order; observed
~1e-6).  Long-form: the mels within the repo's 2e-3
(``tests/test_torch_model.py``), PCM after two Griffin-Lim iterations on
the JAX package's initial phase within one LSB plus 2e-3 of the peak
(``tests/test_torch_synth.py``), lengths exactly.
"""

import numpy as np
import pytest

import jax
import torch

from tacotron2_tpu.config import Config as JaxConfig
from tacotron2_tpu.config import ModelConfig as JaxModelConfig
from tacotron2_tpu.infer import longform as jlongform
from tacotron2_tpu.infer import streaming as jstreaming
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_torch.config import Config, ModelConfig
from tacotron2_torch.dsp import griffinlim as tgl
from tacotron2_torch.infer import longform, streaming
from tacotron2_torch.models import hifigan
from tacotron2_torch.models.tacotron2 import Tacotron2, tacotron2_infer
from tacotron2_torch.text import pad_sequences, text_to_sequence
from tacotron2_torch.utils.weights import (export_jax_hifigan_params,
                                           load_jax_params)

TINY = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
            decoder_rnn_dim=48, prenet_dim=16, attention_rnn_dim=48,
            attention_dim=24, location_n_filters=8, location_kernel_size=15,
            postnet_embedding_dim=24, max_decoder_steps=24)
TEXT = "Streaming matches batch decoding."
CHUNKS = (4, 7, 16)
STREAM_TOL, MEL_TOL, WAV_TOL = 1e-5, 2e-3, 2e-3
PARAGRAPH = ("Hello world. A second, somewhat longer sentence follows here "
             "to land in another token bucket! Short; and done?")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def drain(gen):
    """A generator's items and its return value."""
    items = []
    while True:
        try:
            items.append(next(gen))
        except StopIteration as stop:
            return items, stop.value


def gated(params):
    """A copy of the params whose gate fires at once (bias 10)."""
    params = jax.tree_util.tree_map(lambda x: x, params)
    params["decoder"] = dict(params["decoder"])
    params["decoder"]["gate"] = dict(params["decoder"]["gate"])
    params["decoder"]["gate"]["b"] = np.full_like(
        params["decoder"]["gate"]["b"], 10.0)
    return params


@pytest.fixture(scope="module")
def tiny():
    """Shared weights, the port's models, and the JAX package's streams."""
    jcfg = JaxConfig(model=JaxModelConfig(**TINY))
    params, state = (np_tree(t) for t in tacotron2_init(
        jax.random.PRNGKey(0), jcfg.model))
    gparams = gated(params)
    model = load_jax_params(Tacotron2(ModelConfig(**TINY)), params, state)
    gmodel = load_jax_params(Tacotron2(ModelConfig(**TINY)), gparams, state)
    ref = {}
    for k in CHUNKS:
        ref["coarse", k] = drain(jstreaming.stream_mels(
            params, state, TEXT, jcfg, chunk_frames=k, max_steps=20))
    ref["postnet", 7] = drain(jstreaming.stream_mels(
        params, state, TEXT, jcfg, chunk_frames=7, max_steps=20,
        apply_postnet=True))
    ref["gate"] = drain(jstreaming.stream_mels(
        gparams, state, "Short.", jcfg, chunk_frames=8, max_steps=30))
    ref["gate postnet"] = drain(jstreaming.stream_mels(
        gparams, state, "Short.", jcfg, chunk_frames=8, max_steps=30,
        apply_postnet=True))
    return dict(params=params, state=state, jcfg=jcfg, model=model,
                gmodel=gmodel, ref=ref)


def offline(model, text, max_steps, drop_first_frame=True):
    """The port's offline decode: (coarse, postnet) mels up to the stop."""
    tokens, lengths = pad_sequences([text_to_sequence(text)],
                                    pad_multiple=16)
    out, n, _ = tacotron2_infer(model, tokens, max_steps=max_steps,
                                text_lengths=lengths, device="cpu",
                                drop_first_frame=drop_first_frame)
    n = int(n)
    return out.mel_coarse[0, :n].numpy(), out.mel_postnet[0, :n].numpy()


@pytest.mark.parametrize("k", CHUNKS)
def test_coarse_chunks_match_jax_and_offline(tiny, k):
    chunks, end = drain(streaming.stream_mels(
        tiny["model"], TEXT, chunk_frames=k, max_steps=20, device="cpu"))
    ref_chunks, ref_end = tiny["ref"]["coarse", k]
    assert [c.shape for c in chunks] == [c.shape for c in ref_chunks]
    assert all(c.shape[0] <= k and c.dtype == np.float32 for c in chunks)
    assert end == ref_end == ("cap", 0)
    streamed = np.concatenate(chunks)
    np.testing.assert_allclose(streamed, np.concatenate(ref_chunks),
                               atol=STREAM_TOL, rtol=0)
    coarse, _ = offline(tiny["model"], TEXT, 20)
    assert streamed.shape == coarse.shape == (20, 80)
    np.testing.assert_allclose(streamed, coarse, atol=STREAM_TOL, rtol=0)


def test_first_frame_kept_when_asked(tiny):
    """``drop_first_frame=False`` streams the frame the default drops."""
    streamed = np.concatenate(list(streaming.stream_mels(
        tiny["model"], TEXT, chunk_frames=7, max_steps=12,
        drop_first_frame=False, device="cpu")))
    coarse, _ = offline(tiny["model"], TEXT, 12, drop_first_frame=False)
    np.testing.assert_allclose(streamed, coarse, atol=STREAM_TOL, rtol=0)
    dropped, _ = offline(tiny["model"], TEXT, 12)
    assert not np.allclose(coarse[0], dropped[0])


def test_gate_stop_truncates_stream(tiny):
    chunks, end = drain(streaming.stream_mels(
        tiny["gmodel"], "Short.", chunk_frames=8, max_steps=30,
        device="cpu"))
    ref_chunks, ref_end = tiny["ref"]["gate"]
    # the gate fires as soon as more than one frame is out
    assert sum(c.shape[0] for c in chunks) == 2
    assert end == tuple(ref_end) == ("gate", 28)
    np.testing.assert_allclose(np.concatenate(chunks),
                               np.concatenate(ref_chunks),
                               atol=STREAM_TOL, rtol=0)


@pytest.mark.parametrize("k", [4, 7])
def test_postnet_stream_matches_offline(tiny, k):
    streamed = np.concatenate(list(streaming.stream_mels(
        tiny["model"], TEXT, chunk_frames=k, max_steps=20,
        apply_postnet=True, device="cpu")))
    _, post = offline(tiny["model"], TEXT, 20)
    assert streamed.shape == post.shape
    np.testing.assert_allclose(streamed, post, atol=STREAM_TOL, rtol=0)
    if k == 7:
        np.testing.assert_allclose(
            streamed, np.concatenate(tiny["ref"]["postnet", 7][0]),
            atol=STREAM_TOL, rtol=0)


def test_postnet_stream_gate_stop_parity(tiny):
    """A gate-ended stream takes the other flush branch (the offline buffer
    holds real zero frames past the stop)."""
    streamed = np.concatenate(list(streaming.stream_mels(
        tiny["gmodel"], "Short.", chunk_frames=8, max_steps=30,
        apply_postnet=True, device="cpu")))
    _, post = offline(tiny["gmodel"], "Short.", 30)
    assert streamed.shape == post.shape == (2, 80)
    np.testing.assert_allclose(streamed, post, atol=STREAM_TOL, rtol=0)
    np.testing.assert_allclose(
        streamed, np.concatenate(tiny["ref"]["gate postnet"][0]),
        atol=STREAM_TOL, rtol=0)


def refine_case(tiny, seed, t_total, cf, end, tail_rows):
    """Stream a seeded coarse mel through the port's and the JAX package's
    ``_refine_stream`` (ending with ``end``), and the port's postnet over
    the offline buffer (``tail_rows`` zero rows past it, then its end)."""
    mcfg = tiny["model"].cfg
    coarse = np.random.default_rng(seed).standard_normal(
        (t_total, mcfg.n_mels)).astype(np.float32)

    def gen():
        for i in range(0, t_total, cf):
            yield coarse[i:i + cf]
        return end

    got = np.concatenate(list(streaming._refine_stream(
        tiny["model"], gen(), cf)))
    ref = np.concatenate(list(jstreaming._refine_stream(
        tiny["params"], tiny["state"], tiny["jcfg"].model, gen(), cf)))
    buf = np.concatenate([coarse, np.zeros((tail_rows, mcfg.n_mels),
                                           np.float32)])
    off = streaming._postnet_window(tiny["model"], buf)[:t_total]
    assert got.shape == ref.shape == off.shape == (t_total, mcfg.n_mels)
    np.testing.assert_allclose(got, off, atol=STREAM_TOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=STREAM_TOL, rtol=0)


def test_refine_stream_small_chunk_gate_flush_parity(tiny):
    """chunk_frames < r - 2: a gate-stop flush with a full 2r-frame buffer
    needs r - 2 zero rows past the last emitted frame."""
    mcfg = tiny["model"].cfg
    r = mcfg.postnet_n_convolutions * ((mcfg.postnet_kernel_size - 1) // 2)
    assert 4 < r - 2
    refine_case(tiny, seed=0, t_total=25, cf=4, end="gate", tail_rows=r + 4)


def test_refine_stream_gate_near_cap_parity(tiny):
    """The gate fires within r frames of max_steps: the offline buffer
    holds only 3 real zero rows before it ends."""
    refine_case(tiny, seed=1, t_total=25, cf=8, end=("gate", 3),
                tail_rows=3)


def test_refine_stream_cap_flush_parity(tiny):
    """Stopped by the cap: the offline buffer ends at the last frame."""
    refine_case(tiny, seed=2, t_total=21, cf=8, end=("cap", 0),
                tail_rows=0)


# ---------------------------------------------------------------------------
# long-form
# ---------------------------------------------------------------------------
@pytest.fixture
def jax_phase(monkeypatch):
    """Hand the port the JAX package's own initial-phase draw."""
    def draw(shape, seed, device):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.PRNGKey(seed), tuple(shape), minval=0.0,
            maxval=2.0 * np.pi)))
    monkeypatch.setattr(tgl, "_initial_phase", draw)


def assert_pcm_close(got, ref):
    """Float waveforms of int16 PCM (pcm / 32767), as PCM."""
    got, ref = (np.round(np.asarray(w) * 32767.0).astype(np.int32)
                for w in (got, ref))
    assert got.shape == ref.shape
    diff = np.abs(got - ref).max()
    assert diff <= 1 + WAV_TOL * np.abs(ref).max(), diff


def test_split_sentences_and_buckets_match():
    for text in (PARAGRAPH, "", "  One.Two. Three!  ", "No stop at all",
                 "Why? Because; it is."):
        assert longform.split_sentences(text) == \
            jlongform.split_sentences(text)
    for n in (1, 32, 33, 64, 200, 300):
        assert longform._bucket_len(n, (32, 64, 128, 256)) == \
            jlongform._bucket_len(n, (32, 64, 128, 256))


def test_longform_matches_jax(tiny, jax_phase, capsys):
    """Griffin-Lim, token buckets of 16 and 32: the second sentence is
    longer than 32 tokens and is split, the third shares a bucket with the
    first."""
    kw = dict(max_steps_per_sentence=10, griffinlim_iters=2,
              token_buckets=(16, 32))
    ref_wav, ref_mels = jlongform.synthesize_longform(
        tiny["params"], tiny["state"], PARAGRAPH, tiny["jcfg"], **kw)
    wav, mels = longform.synthesize_longform(
        tiny["model"], PARAGRAPH, Config(model=ModelConfig(**TINY)),
        device="cpu", **kw)
    printed = capsys.readouterr().out
    assert printed.count("[longform] splitting") == 2, printed
    assert len(mels) == len(ref_mels) == 6
    for m, r in zip(mels, ref_mels):
        assert m.shape == r.shape
        np.testing.assert_allclose(m, r, atol=MEL_TOL, rtol=0)
    assert wav.dtype == np.float32 and wav.shape == np.asarray(ref_wav).shape
    assert_pcm_close(wav, ref_wav)
    assert longform.synthesize_longform(
        tiny["model"], "  ", device="cpu")[0].shape == (0,)


def test_longform_hifigan_matches_jax(tiny):
    gen = hifigan.hifigan_init(seed=1)
    kw = dict(max_steps_per_sentence=4, token_buckets=(32, 64))
    ref_wav, _ = jlongform.synthesize_longform(
        tiny["params"], tiny["state"], "Hello world. Bye.", tiny["jcfg"],
        hifigan_params=export_jax_hifigan_params(gen), **kw)
    wav, mels = longform.synthesize_longform(
        tiny["model"], "Hello world. Bye.", Config(model=ModelConfig(**TINY)),
        vocoder=gen, device="cpu", **kw)
    silence = int(22050 * 0.12)
    assert wav.shape == (4 * 256 * 2 + silence,) == np.asarray(ref_wav).shape
    assert_pcm_close(wav, ref_wav)


def test_longform_external_vocoder_matches_jax(tiny):
    """The modular path (the JAX package's, where a vocoder is given; the
    port's with ``modular``): decode per bucket, then the caller's
    vocoder, on the host there and on device tensors here."""
    def vocoder(mel_bct):       # (B, n_mels, T) -> (B, T * 256)
        return np.repeat(np.tanh(np.asarray(mel_bct).mean(axis=1)), 256, -1)

    def device_vocoder(mel_bct):
        return torch.tanh(mel_bct.mean(dim=1)).repeat_interleave(256, -1)

    kw = dict(max_steps_per_sentence=6)
    ref_wav, ref_mels = jlongform.synthesize_longform(
        tiny["params"], tiny["state"], "Hello world. Bye.", tiny["jcfg"],
        vocoder=vocoder, **kw)
    wav, mels = longform.synthesize_longform(
        tiny["model"], "Hello world. Bye.", Config(model=ModelConfig(**TINY)),
        vocoder=device_vocoder, modular=True, device="cpu", **kw)
    for m, r in zip(mels, ref_mels):
        np.testing.assert_allclose(m, r, atol=MEL_TOL, rtol=0)
    np.testing.assert_allclose(wav, np.asarray(ref_wav), atol=MEL_TOL,
                               rtol=0)
