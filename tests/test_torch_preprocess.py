"""The port's data preparation against the JAX package's, on the CPU.

* ``prepare_ljspeech_metadata`` / ``prepare_librispeech_metadata``: the
  same CSV byte for byte on temporary LJSpeech and LibriSpeech layouts, and
  the same errors.
* The port's native WAV loader (``native/wavio.cc``, built by the port into
  ``tacotron2_torch/_build/``; the JAX package's library is not loaded):
  ``decode_wav`` and ``decode_batch_padded`` against the JAX package's
  ``dsp/wav.py::load_audio`` plus ``dsp/mel.py::reflect_pad_batch`` over
  PCM 8/16/32-bit, float32, stereo and truncated files (limit 1e-6: the C
  side sums channels in float32, scipy's path averages in float32 too,
  one rounding apart), and failed files.
* ``preprocess_corpus`` with the native path on and off against the JAX
  package's with it off, on seven WAVs of which one is at 16 kHz (the
  resampling fallback) and one is unreadable (skipped): token files
  equal, counters equal, mels within atol 1e-4 + rtol 1e-5 (both sides
  frame, FFT and project in float32 in another order; the largest gap,
  8.5e-5, sits at the log floor near -11, where a 1e-9 power difference
  moves the log by that much).  The text stage through its spawn pool too.
* ``gt_vocoder_check_torch.py`` against ``gt_vocoder_check.py`` on one of
  those items: the same report keys, scale guesses and mel statistics
  (rtol 1e-4).
* The CLIs, run in this process on the CPU.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
from scipy.io import wavfile

from tacotron2_tpu.data import metadata as jax_metadata
from tacotron2_tpu.data.preprocess import \
    preprocess_corpus as jax_preprocess_corpus
from tacotron2_tpu.dsp.mel import reflect_pad_batch as jax_reflect_pad_batch
from tacotron2_tpu.dsp.wav import load_audio as jax_load_audio
from tacotron2_torch.data import metadata, native_loader
from tacotron2_torch.data.preprocess import preprocess_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 22050
MEL_ATOL, MEL_RTOL = 1e-4, 1e-5
TEXTS = ["Hello world, this is a test.", "The quick brown fox.",
         "It costs 42 dollars.", "A zorblaxian wug sings.",
         "Printing, in the only sense with which we are at present "
         "concerned.", "Dr. Smith read the book.", "Broken file here."]


def _tone(n: int, i: int) -> np.ndarray:
    t = np.arange(n) / SR
    rng = np.random.default_rng(i)
    return (0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t)
            + 0.01 * rng.standard_normal(n)).astype(np.float32)


def _write_kind(path: str, kind: str, i: int = 0) -> None:
    """One WAV of ``kind``; ``truncated`` loses the end of its data chunk
    (the header still claims it), ``garbage`` is no WAV at all."""
    y = _tone(9000 + 1234 * i, i)
    if kind == "float32":
        wavfile.write(path, SR, y)
    elif kind == "int16":
        wavfile.write(path, SR, (y * 32767).astype(np.int16))
    elif kind == "int32":
        wavfile.write(path, SR, (y * 2147483000).astype(np.int32))
    elif kind == "uint8":
        wavfile.write(path, SR, (y * 127 + 128).astype(np.uint8))
    elif kind == "stereo_int16":
        st = np.stack([y, 0.5 * y[::-1]], axis=1)
        wavfile.write(path, SR, (st * 32767).astype(np.int16))
    elif kind == "stereo_float32":
        wavfile.write(path, SR, np.stack([y, -0.25 * y], axis=1))
    elif kind == "truncated":
        wavfile.write(path, SR, (y * 32767).astype(np.int16))
        with open(path, "rb") as f:
            blob = f.read()
        with open(path, "wb") as f:
            f.write(blob[:-1001])
    elif kind == "garbage":
        with open(path, "wb") as f:
            f.write(np.random.default_rng(i).integers(
                0, 256, 3000, dtype=np.uint8).tobytes())
    else:
        raise ValueError(kind)


GOOD_KINDS = ["float32", "int16", "int32", "uint8", "stereo_int16",
              "stereo_float32", "truncated"]


@pytest.fixture(scope="module")
def native():
    lib = native_loader.get_library()
    assert lib is not None, "g++ could not build native/wavio.cc"
    path = native_loader.library_path()
    assert path.parent == native_loader.BUILD_DIR and path.exists()
    return lib


# ---------------------------------------------------------------- metadata

def _lj_layout(root: str) -> None:
    os.makedirs(os.path.join(root, "wavs"))
    lines = [f"LJ001-000{i}|raw {t}|{t}" for i, t in enumerate(TEXTS)]
    lines += ["", "short|line", 'LJ002-0001|"quoted", raw|"quoted", text']
    with open(os.path.join(root, "metadata.csv"), "w",
              encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    for i in range(3):     # some wavs exist, the rest are missing
        _write_kind(os.path.join(root, "wavs", f"LJ001-000{i}.wav"),
                    "int16", i)


@pytest.mark.parametrize("debug", [False, True])
def test_prepare_ljspeech_metadata_bytes(tmp_path, capsys, debug):
    root = str(tmp_path / "LJSpeech-1.1")
    _lj_layout(root)
    got, ref = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    n = metadata.prepare_ljspeech_metadata(root, got, debug=debug)
    said = capsys.readouterr().out
    assert n == jax_metadata.prepare_ljspeech_metadata(root, ref,
                                                       debug=debug)
    assert said.replace(got, ref) == capsys.readouterr().out
    with open(got, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_prepare_librispeech_metadata_bytes(tmp_path):
    root = tmp_path / "LibriSpeech" / "dev-clean"
    for spk, chap, n in (("1089", "134686", 3), ("2300", "131720", 2),
                         ("84", "121123", 2)):
        d = root / spk / chap
        d.mkdir(parents=True)
        lines = []
        for k in range(n):
            utt = f"{spk}-{chap}-{k:04d}"
            lines.append(f"{utt} HE HOPED THERE WOULD BE STEW {k}")
            if k != 1:     # one transcript line without its audio
                (d / f"{utt}.flac").write_bytes(b"")
        (d / f"{spk}-{chap}.trans.txt").write_text(
            "\n".join(lines) + "\n\n", encoding="utf-8")
    got, ref = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    n = metadata.prepare_librispeech_metadata(str(tmp_path / "LibriSpeech"),
                                              got)
    assert n == jax_metadata.prepare_librispeech_metadata(
        str(tmp_path / "LibriSpeech"), ref) == 4
    with open(got, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()


def test_prepare_librispeech_metadata_errors(tmp_path):
    for fn in (metadata.prepare_librispeech_metadata,
               jax_metadata.prepare_librispeech_metadata):
        with pytest.raises(FileNotFoundError, match="not found"):
            fn(str(tmp_path / "absent"), str(tmp_path / "m.csv"))
        with pytest.raises(FileNotFoundError, match="trans.txt"):
            fn(str(tmp_path), str(tmp_path / "m.csv"))


# ------------------------------------------------------------ native loader

@pytest.mark.parametrize("kind", GOOD_KINDS)
def test_decode_wav_matches_load_audio(native, tmp_path, kind):
    path = str(tmp_path / f"{kind}.wav")
    _write_kind(path, kind, 2)
    y, rate = native_loader.decode_wav(path)
    ref, ref_rate = jax_load_audio(path)
    assert rate == ref_rate == SR
    assert y.dtype == np.float32 and y.shape == ref.shape
    np.testing.assert_allclose(y, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("kind", ["garbage", "missing"])
def test_decode_wav_failures(native, tmp_path, kind):
    path = str(tmp_path / f"{kind}.wav")
    if kind != "missing":
        _write_kind(path, kind)
    with pytest.raises(IOError, match="native WAV decode failed"):
        native_loader.decode_wav(path)


def test_decode_batch_padded_matches_reflect_pad_batch(native, tmp_path):
    """Every kind in one batch, one row failing and one too long for the
    row; the rest equal to the JAX package's host path."""
    paths, sigs = [], []
    for i, kind in enumerate(GOOD_KINDS):
        p = str(tmp_path / f"{kind}.wav")
        _write_kind(p, kind, i)
        paths.append(p)
        sigs.append(jax_load_audio(p)[0])
    bad = str(tmp_path / "garbage.wav")
    _write_kind(bad, "garbage")
    long_path = str(tmp_path / "long.wav")
    wavfile.write(long_path, 16000, _tone(40000, 9))
    pad, total = 512, max(len(s) for s in sigs) + 1024
    batch, lengths, rates = native_loader.decode_batch_padded(
        paths + [bad, long_path], pad, total, n_threads=3)
    assert batch.shape == (len(paths) + 2, total) and batch.dtype == np.float32
    assert lengths.dtype == np.int64 and rates.dtype == np.int32
    np.testing.assert_array_equal(lengths, [len(s) for s in sigs] + [0, 0])
    np.testing.assert_array_equal(rates, [SR] * len(sigs) + [0, 16000])
    ref = jax_reflect_pad_batch(sigs, pad, total)
    np.testing.assert_allclose(batch[:len(sigs)], ref, rtol=0, atol=1e-6)
    assert not batch[len(sigs):].any()


def test_native_build_is_atomic_and_keyed(native, monkeypatch, tmp_path):
    """A changed source or flag builds a new name; the build writes a
    temporary name and moves it into place."""
    first = native_loader.library_path()
    monkeypatch.setattr(native_loader, "CXX_FLAGS",
                        native_loader.CXX_FLAGS + ("-DT2X_TEST_KEY=1",))
    assert native_loader.library_path() != first
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path)
    out = native_loader.build()
    assert out.parent == tmp_path and out.exists()
    assert [p.name for p in tmp_path.iterdir()] == [out.name]
    assert native_loader.build() == out          # built: not again


def test_unavailable_native_loader_raises(monkeypatch):
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_load_attempted", True)
    assert not native_loader.native_available()
    for call in (lambda: native_loader.decode_wav("x.wav"),
                 lambda: native_loader.decode_batch_padded(["x.wav"], 4, 8)):
        with pytest.raises(RuntimeError, match="not available"):
            call()


# -------------------------------------------------------------- preprocess

@pytest.fixture(scope="module")
def raw_corpus(tmp_path_factory):
    """Seven rows: five at 22.05 kHz (float32, int16, stereo, 8-bit), one
    at 16 kHz and one unreadable."""
    root = tmp_path_factory.mktemp("raw")
    kinds = ["float32", "int16", "stereo_int16", "uint8", "float32",
             "rate16k", "garbage"]
    rows = []
    for i, (kind, text) in enumerate(zip(kinds, TEXTS)):
        path = str(root / f"UTT-{i:02d}.wav")
        if kind == "rate16k":
            wavfile.write(path, 16000, _tone(12000, i))
        else:
            _write_kind(path, kind, i)
        rows.append({"filepath": path, "text": text,
                     "speaker_id": str([7, 1089][i % 2])})
    meta = str(root / "metadata.csv")
    metadata._write_csv(meta, rows, ["filepath", "text", "speaker_id"])
    return meta


@pytest.fixture(scope="module")
def jax_processed(raw_corpus, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_processed"))
    stats = jax_preprocess_corpus(raw_corpus, out, batch_size=4,
                                  use_native=False, text_workers=1)
    return out, stats


def _same_cache(got_dir: str, ref_dir: str) -> None:
    for sub in ("text", "mels"):
        assert sorted(os.listdir(os.path.join(got_dir, sub))) == sorted(
            os.listdir(os.path.join(ref_dir, sub))), sub
    for name in os.listdir(os.path.join(ref_dir, "text")):
        got = np.load(os.path.join(got_dir, "text", name))
        ref = np.load(os.path.join(ref_dir, "text", name))
        assert got.dtype == ref.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    for name in os.listdir(os.path.join(ref_dir, "mels")):
        got = np.load(os.path.join(got_dir, "mels", name))
        ref = np.load(os.path.join(ref_dir, "mels", name))
        assert got.dtype == ref.dtype == np.float32
        assert got.shape == ref.shape, name
        np.testing.assert_allclose(got, ref, rtol=MEL_RTOL, atol=MEL_ATOL,
                                   err_msg=name)
    with open(os.path.join(got_dir, "metadata.csv"), "rb") as a, \
            open(os.path.join(ref_dir, "metadata.csv"), "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("use_native", [True, False])
def test_preprocess_matches_jax(raw_corpus, jax_processed, tmp_path, capsys,
                                use_native):
    ref_dir, ref_stats = jax_processed
    assert ref_stats == {"ok": 6, "skipped": 1}
    if use_native:
        assert native_loader.native_available()
    out = str(tmp_path / "port")
    stats = preprocess_corpus(raw_corpus, out, batch_size=4,
                              use_native=use_native, text_workers=1,
                              device="cpu")
    said = capsys.readouterr().out
    assert stats == ref_stats
    assert f"native loader: {use_native}" in said
    assert "Skipping (mel)" in said and "UTT-06.wav" in said
    _same_cache(out, ref_dir)


def test_preprocess_text_stage_in_spawned_workers(raw_corpus, jax_processed,
                                                  tmp_path):
    """Seven rows over two workers: more than two jobs a worker, so the
    spawn pool runs the text stage."""
    out = str(tmp_path / "pool")
    stats = preprocess_corpus(raw_corpus, out, batch_size=8, text_workers=2,
                              device="cpu")
    assert stats == jax_processed[1]
    _same_cache(out, jax_processed[0])


def test_preprocess_native_forced_without_library(raw_corpus, monkeypatch,
                                                  tmp_path):
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_load_attempted", True)
    with pytest.raises(RuntimeError, match="not available"):
        preprocess_corpus(raw_corpus, str(tmp_path / "x"), use_native=True,
                          text_workers=1, device="cpu")


def test_preprocess_cuda_without_card_raises(raw_corpus, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        preprocess_corpus(raw_corpus, str(tmp_path / "x"), text_workers=1)


# ------------------------------------------------------ gt_vocoder_check

def test_gt_vocoder_check_matches_jax(raw_corpus, jax_processed, tmp_path):
    sys.path.insert(0, ROOT)
    try:
        import gt_vocoder_check as jax_check
        import gt_vocoder_check_torch as port_check
    finally:
        sys.path.remove(ROOT)
    common = ["--metadata", raw_corpus, "--processed_root",
              jax_processed[0], "--index", "1", "--gl_iters", "2",
              "--hifigan"]
    got = port_check.main(port_check.parse_args(
        common + ["--output_dir", str(tmp_path / "port"), "--device",
                  "cpu"]))
    ref_args = port_check.parse_args(
        common + ["--output_dir", str(tmp_path / "jax")])
    jax_check.main(ref_args)
    with open(tmp_path / "jax" / "UTT-01_vocoder_check.json") as f:
        ref = json.load(f)
    with open(tmp_path / "port" / "UTT-01_vocoder_check.json") as f:
        assert json.load(f) == got
    assert set(got) == set(ref)
    assert got["recomputed_mel_scale_guess"] == "LIKELY_LOG"
    for key in ("wav_path", "text", "basename", "processed_mel_stats",
                "processed_mel_scale_guess", "recomputed_mel_scale_guess"):
        assert got[key] == ref[key], key
    for k, v in ref["recomputed_mel_stats"].items():
        assert got["recomputed_mel_stats"][k] == pytest.approx(v, rel=1e-4,
                                                               abs=1e-5), k
    for d in ("port", "jax"):
        y, rate = jax_load_audio(str(tmp_path / d /
                                     "UTT-01_gt_griffinlim.wav"))
        assert rate == SR and np.isfinite(y).all() and np.abs(y).max() > 0


# --------------------------------------------------------------------- CLIs

def _run_cli(monkeypatch, script: str, *argv: str) -> None:
    monkeypatch.setattr(sys, "argv", [script, *argv])
    monkeypatch.syspath_prepend(ROOT)
    runpy.run_path(os.path.join(ROOT, script), run_name="__main__")


def test_clis_prepare_then_preprocess(monkeypatch, tmp_path, jax_processed):
    lj = str(tmp_path / "LJSpeech-1.1")
    _lj_layout(lj)
    clean = str(tmp_path / "clean.csv")
    _run_cli(monkeypatch, "prepare_ljspeech_torch.py", lj, clean)
    ref = str(tmp_path / "ref.csv")
    jax_metadata.prepare_ljspeech_metadata(lj, ref)
    with open(clean, "rb") as a, open(ref, "rb") as b:
        assert a.read() == b.read()

    libri = tmp_path / "Libri" / "19" / "198"
    libri.mkdir(parents=True)
    (libri / "19-198.trans.txt").write_text("19-198-0000 NORTHANGER ABBEY\n")
    (libri / "19-198-0000.flac").write_bytes(b"")
    out = str(tmp_path / "libri.csv")
    _run_cli(monkeypatch, "prepare_metadata_torch.py",
             str(tmp_path / "Libri"), "--output", out, "--device", "cpu")
    assert metadata.read_metadata(out) == [
        {"filepath": str((libri / "19-198-0000.flac").resolve()),
         "text": "NORTHANGER ABBEY", "speaker_id": "19"}]

    # the JAX output's metadata.csv lists the seven rows of raw_corpus
    processed = str(tmp_path / "processed")
    _run_cli(monkeypatch, "preprocess_torch.py",
             os.path.join(jax_processed[0], "metadata.csv"), processed,
             "--batch_size", "4", "--device", "cpu")
    _same_cache(processed, jax_processed[0])
