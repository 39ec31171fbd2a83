"""The port's DSP against the JAX package's, on the same numpy signals
made from a seed (CPU, fp32).

Limits.  Window, filterbank, pseudo-inverse and the window-sum envelope are
numpy on both sides: exactly equal.  STFT power and log-mel: two FFT
libraries (pocketfft in both, other summation order), 1e-4 relative on
power, 2e-5 on log values (observed 7e-7).  ``mel_to_linear``: 100
projected-gradient steps of fp32 products, 1e-5 of the result's largest
value (observed 4e-6).  ``griffin_lim`` starts both sides from the same
phase draw and amplifies differences as it iterates (observed 2e-7 of the
peak at 0 iterations, 2e-4 at 4, 1e-2 at 60): held to 1e-5 of the peak at
0 and 1 iterations, 1e-3 at 4, and at 60 to what it is for: spectral
convergence of each side and a waveform correlation above 0.999.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import test_dsp as jax_dsp_tests
from tacotron2_tpu import dsp as jd
from tacotron2_torch import dsp as td
from tacotron2_torch.config import AudioConfig

# the modules, not the functions of the same name their packages export
jstft = importlib.import_module("tacotron2_tpu.dsp.stft")
tstft = importlib.import_module("tacotron2_torch.dsp.stft")
CFG = AudioConfig()
STFT = dict(n_fft=1024, hop_length=256, win_length=1024)
MEL = dict(sr=22050, n_fft=1024, n_mels=80, fmin=0.0, fmax=8000.0)


def signal(seed=0, n=6000, batch=None):
    """A chirp plus noise: broadband, with dynamics."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    y = 0.5 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
    y = y + 0.05 * rng.standard_normal(n)
    if batch:
        y = np.stack([np.roll(y, 500 * i) * (1 - 0.2 * i)
                      for i in range(batch)])
    return y.astype(np.float32)


def jax_phase(shape, seed=0):
    """The JAX package's own initial-phase draw."""
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                       minval=0.0, maxval=2.0 * np.pi))


@pytest.mark.parametrize("win,n_fft", [(1024, 1024), (800, 1024), (6, 8)])
def test_windows(win, n_fft):
    np.testing.assert_array_equal(td.hann_window(win), jd.hann_window(win))
    np.testing.assert_array_equal(td.padded_window(win, n_fft),
                                  jd.padded_window(win, n_fft))
    assert td.n_frames(6000, 256) == jd.n_frames(6000, 256) == 24
    with pytest.raises(ValueError, match="win_length"):
        td.padded_window(n_fft + 1, n_fft)


@pytest.mark.parametrize("n_fft,hop,center", [(1024, 256, True),
                                              (1024, 256, False),
                                              (16, 6, True), (16, 4, False)])
def test_frame_signal(n_fft, hop, center):
    """Framing is pure data movement: exactly equal, also where the hop
    does not divide the frame (the JAX package's gather path)."""
    y = signal(1, 2000, batch=2)
    ref = np.asarray(jstft.frame_signal(jnp.asarray(y), n_fft, hop, center))
    got = tstft.frame_signal(torch.from_numpy(y), n_fft, hop, center)
    np.testing.assert_array_equal(ref, got.numpy())
    np.testing.assert_array_equal(
        np.asarray(jstft.reflect_pad_last(jnp.asarray(y), 5)),
        tstft.reflect_pad_last(torch.from_numpy(y), 5).numpy())


@pytest.mark.parametrize("win", [1024, 800])
def test_stft_power_and_magnitude(win):
    y = signal(2, batch=2)
    kw = dict(STFT, win_length=win)
    ref = np.asarray(jd.stft_magnitude_squared(jnp.asarray(y), **kw))
    got = td.stft_magnitude_squared(torch.from_numpy(y), **kw).numpy()
    assert got.shape == ref.shape == (2, 513, 24)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * ref.max())
    mag = td.stft_magnitude(torch.from_numpy(y), **kw).numpy()
    np.testing.assert_allclose(
        mag, np.asarray(jd.stft_magnitude(jnp.asarray(y), **kw)),
        rtol=1e-4, atol=1e-4 * np.sqrt(ref.max()))


def test_istft_round_trip_and_parity():
    y = signal(3, 256 * 20)
    spec_t = td.stft(torch.from_numpy(y), **STFT)
    spec_j = jd.stft(jnp.asarray(y), **STFT)
    assert spec_t.dtype == torch.complex64 and spec_t.shape == (513, 21)
    np.testing.assert_allclose(spec_t.numpy(), np.asarray(spec_j), atol=2e-4)
    back = td.istft(spec_t, **STFT).numpy()
    assert back.shape == y.shape
    np.testing.assert_allclose(back, y, atol=1e-5)         # the round trip
    np.testing.assert_allclose(
        back, np.asarray(jd.istft(spec_j, **STFT)), atol=1e-5)
    # an explicit length that covers every frame, as the vocoders ask
    longer = td.istft(spec_t, length=21 * 256, **STFT).numpy()
    ref = np.asarray(jd.istft(spec_j, length=21 * 256, **STFT))
    assert longer.shape == ref.shape == (21 * 256,)
    np.testing.assert_allclose(longer, ref, atol=1e-5)
    np.testing.assert_array_equal(
        tstft._window_sumsquare(td.padded_window(1024, 1024), 21, 1024, 256),
        jstft._window_sumsquare(jd.padded_window(1024, 1024), 21, 1024, 256))
    with pytest.raises(NotImplementedError, match="hop_length"):
        td.istft(spec_t, n_fft=1024, hop_length=300, win_length=1024)


def test_filterbank_and_mel_scale():
    np.testing.assert_array_equal(td.mel_filterbank(**MEL),
                                  jd.mel_filterbank(**MEL))
    np.testing.assert_array_equal(td.default_filterbank(CFG),
                                  jd.default_filterbank(CFG))
    hz = np.array([0.0, 440.0, 1000.0, 4000.0, 8000.0])
    np.testing.assert_array_equal(td.hz_to_mel(hz), jd.hz_to_mel(hz))
    np.testing.assert_array_equal(td.mel_to_hz(td.hz_to_mel(hz)),
                                  jd.mel_to_hz(jd.hz_to_mel(hz)))


@pytest.mark.parametrize("batch", [None, 3])
def test_log_mel_spectrogram(batch):
    y = signal(4, batch=batch)
    ref = np.asarray(jd.log_mel_spectrogram(jnp.asarray(y)))
    got = td.log_mel_spectrogram(torch.from_numpy(y))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    if batch is None:
        np.testing.assert_allclose(
            td.get_mel_spectrogram_array(y, CFG, device="cpu"), ref,
            atol=2e-5)


def test_log_mel_golden_fixture():
    """The frozen log-mel of a real speech signal (the JAX package's
    regression anchor, ``tests/test_dsp.py``), where its WAV is present."""
    import os
    anchor = jax_dsp_tests.TestGoldenFixture
    if not os.path.isfile(anchor.WAV):
        pytest.skip("reference WAV not present")
    golden = np.load(anchor.FIXTURE)
    y, sr = td.load_audio(anchor.WAV, target_sr=22050)
    y = y / np.abs(y).max() * 0.95
    mel = td.get_mel_spectrogram_array(y, device="cpu")
    assert mel.shape == golden.shape
    np.testing.assert_allclose(mel, golden, rtol=1e-5, atol=1e-4)


def test_batched_log_mel_with_lengths():
    sigs = [signal(5, n) for n in (3000, 4100, 2560)]
    lens = np.array([len(s) for s in sigs], np.int32)
    total = int(lens.max()) + 1024
    padded = td.reflect_pad_batch(sigs, 512, total)
    np.testing.assert_array_equal(padded,
                                  jd.reflect_pad_batch(sigs, 512, total))
    ref, ref_len = jd.batched_log_mel_with_lengths(jnp.asarray(padded),
                                                   jnp.asarray(lens))
    got, got_len = td.batched_log_mel_with_lengths(torch.from_numpy(padded),
                                                   torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    # each item's frames equal its own centred transform; padding at floor
    for i, s in enumerate(sigs):
        n = int(got_len[i])
        own = td.log_mel_spectrogram(torch.from_numpy(s)).numpy()
        np.testing.assert_allclose(got[i, :, :n].numpy(), own, atol=2e-5)
        assert np.all(got[i, :, n:].numpy() == np.float32(np.log(1e-5)))


@pytest.fixture(scope="module")
def linear_pair():
    y = signal(6, 256 * 12, batch=2)
    mel_power = np.exp(np.asarray(jd.log_mel_spectrogram(jnp.asarray(y))))
    ref = np.asarray(jd.mel_to_linear(jnp.asarray(mel_power), **MEL))
    got = td.mel_to_linear(torch.from_numpy(mel_power), **MEL).numpy()
    return mel_power, ref, got


def test_mel_to_linear(linear_pair):
    mel_power, ref, got = linear_pair
    assert got.shape == ref.shape == (2, 513, 13) and (got >= 0).all()
    np.testing.assert_allclose(got, ref, atol=1e-5 * ref.max())
    fb = td.mel_filterbank(**MEL)
    resid = (np.linalg.norm(fb @ got - mel_power)
             / np.linalg.norm(mel_power))
    assert resid < 0.05


@pytest.mark.parametrize("n_iter,tol", [(0, 1e-5), (1, 1e-5), (4, 1e-3)])
def test_griffin_lim_shared_phase(linear_pair, n_iter, tol):
    _, ref_lin, _ = linear_pair
    length = 13 * 256
    ref = np.asarray(jd.griffin_lim(jnp.asarray(ref_lin), n_iter=n_iter,
                                    length=length, seed=0, **STFT))
    got = td.griffin_lim(torch.from_numpy(ref_lin.copy()), n_iter=n_iter,
                         length=length,
                         init_phase=torch.from_numpy(jax_phase(ref_lin.shape)),
                         **STFT).numpy()
    assert got.shape == ref.shape == (2, length)
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max())


def test_griffin_lim_converges_at_60(linear_pair):
    _, ref_lin, _ = linear_pair
    ref = np.asarray(jd.griffin_lim(jnp.asarray(ref_lin), n_iter=60, seed=0,
                                    **STFT))
    got = td.griffin_lim(torch.from_numpy(ref_lin.copy()), n_iter=60,
                         init_phase=torch.from_numpy(jax_phase(ref_lin.shape)),
                         **STFT).numpy()
    assert got.shape == ref.shape == (2, 12 * 256)
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.999
    for wav in (got, ref):      # each side's spectrum approaches the target
        mag = td.stft_magnitude(torch.from_numpy(np.array(wav)),
                                **STFT).numpy()
        err = np.linalg.norm(mag - ref_lin) / np.linalg.norm(ref_lin)
        assert err < 0.35, err


def test_griffin_lim_seed():
    """Without a phase the draw comes from ``seed``: repeatable, and
    another seed gives another waveform."""
    mag = torch.from_numpy(np.abs(np.random.default_rng(7).standard_normal(
        (513, 9))).astype(np.float32))
    a = td.griffin_lim(mag, n_iter=2, seed=3, **STFT)
    b = td.griffin_lim(mag, n_iter=2, seed=3, **STFT)
    c = td.griffin_lim(mag, n_iter=2, seed=4, **STFT)
    assert a.shape == (8 * 256,) and torch.equal(a, b)
    assert not torch.equal(a, c)


def test_mel_to_audio_heuristics(monkeypatch):
    """Orientation auto-fix and log-vs-linear auto-detect, against the JAX
    function on the JAX phase draw."""
    from tacotron2_torch.dsp import griffinlim as tgl
    monkeypatch.setattr(
        tgl, "_initial_phase",
        lambda shape, seed, device: torch.from_numpy(jax_phase(shape, seed)))
    logmel = np.asarray(jd.log_mel_spectrogram(jnp.asarray(signal(8, 2560))))
    cases = {"log": logmel, "transposed": logmel.T,
             "linear": np.exp(logmel) / np.exp(logmel).max()}
    for name, mel in cases.items():
        ref = jd.mel_to_audio(mel, n_iter=2)
        got = td.mel_to_audio(mel, n_iter=2, device="cpu")
        assert got.shape == ref.shape and np.isfinite(got).all(), name
        np.testing.assert_allclose(got, ref, atol=1e-3 * np.abs(ref).max(),
                                   err_msg=name)
    with pytest.raises(ValueError, match="2-D"):
        td.mel_to_audio(logmel[None], device="cpu")


def test_wav_io(tmp_path):
    from scipy.io import wavfile
    y = signal(9, 4000)
    path = str(tmp_path / "t.wav")
    td.save_wav(path, y, 22050)
    back, sr = td.load_audio(path, target_sr=22050)
    assert sr == 22050
    np.testing.assert_array_equal(back, jd.load_audio(path, 22050)[0])
    np.testing.assert_allclose(back, y, atol=1e-6)
    wavfile.write(path, 44100, (y * 32767).astype(np.int16))
    down, sr = td.load_audio(path, target_sr=22050)
    assert sr == 22050 and abs(len(down) - 2000) <= 1
    np.testing.assert_array_equal(down, jd.load_audio(path, 22050)[0])
    assert td.get_mel_spectrogram(path, device="cpu").shape[0] == 80


def test_mel_diagnostics(capsys):
    from tacotron2_tpu.utils import diagnostics as jdiag
    from tacotron2_torch.utils import diagnostics as tdiag
    rng = np.random.default_rng(10)
    mel = rng.standard_normal((30, 80)) * 2 - 5
    assert tdiag.mel_stats(mel) == jdiag.mel_stats(mel)
    for m in (mel, rng.uniform(0, 1, (30, 80)), rng.uniform(0, 3, (4, 80))):
        s = tdiag.mel_stats(m)
        assert tdiag.classify_mel_scale(s) == jdiag.classify_mel_scale(s)
    assert tdiag.print_mel_diagnostics(mel, "x") == jdiag.mel_stats(mel)
    assert "log-compressed" in capsys.readouterr().out
    a = rng.dirichlet(np.ones(12), (2, 9))
    assert tdiag.attention_entropy(a) == jdiag.attention_entropy(a)
