"""The port's data layer and training utilities against the JAX package's
on the CPU: the metadata reader, ``TextMelDataset`` with its speaker map
and lengths, ``BatchLoader``'s epoch order and padded shapes for several
seeds and epochs, the loader's skip of resumed epochs, the corpus writer,
the step timer, the log file and the heatmap PNG written without
matplotlib."""

import os
import struct
import sys
import zlib

import numpy as np
import pytest

from tacotron2_tpu.data import dataset as jax_dataset
from tacotron2_tpu.data import metadata as jax_metadata
from tacotron2_tpu.utils.logging import TrainingLogger as JaxLogger
from tacotron2_torch.config import AudioConfig
from tacotron2_torch.data import dataset, metadata
from tacotron2_torch.data.synth_corpus import (token_tone, write_corpus,
                                               write_sine_corpus)
from tacotron2_torch.text import text_to_sequence
from tacotron2_torch.utils import plotting
from tacotron2_torch.utils.logging import TrainingLogger
from tacotron2_torch.utils.profiling import StepTimer

AUDIO = AudioConfig(n_mels=8)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """20 utterances of 1 to 4 words; a second CSV gives them speakers."""
    root = str(tmp_path_factory.mktemp("corpus"))
    train_csv, _ = write_corpus(root, 20, seed=4, words=(1, 4), audio=AUDIO,
                                device="cpu")
    rows = metadata.read_metadata(train_csv)
    for i, row in enumerate(rows):
        row["speaker_id"] = str([1089, 7, 1089, 42][i % 4])
    multi = os.path.join(root, "speakers.csv")
    metadata._write_csv(multi, rows, ["filepath", "text", "speaker_id"])
    return train_csv, multi


def batches_equal(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_metadata_copy_matches(corpus):
    train_csv, multi = corpus
    for path in (train_csv, multi):
        assert metadata.read_metadata(path) == jax_metadata.read_metadata(
            path)
    for name in ("a/LJ001-0001.wav", "b/x.flac", "plain", "c.wav.wav"):
        assert metadata.basename_of(name) == jax_metadata.basename_of(name)


def test_corpus_layout(corpus):
    """The writer's files: token ids of the text, (n_mels, T) log-mels of
    the tones, one tone a token."""
    train_csv, _ = corpus
    root = os.path.dirname(train_csv)
    row = metadata.read_metadata(train_csv)[0]
    base = metadata.basename_of(row["filepath"])
    tokens = np.load(os.path.join(root, "text", f"{base}.npy"))
    mel = np.load(os.path.join(root, "mels", f"{base}.npy"))
    assert tokens.dtype == np.int32
    assert tokens.tolist() == text_to_sequence(row["text"])
    samples = sum(len(token_tone(int(t), AUDIO.sampling_rate))
                  for t in tokens)
    assert mel.shape == (8, 1 + samples // AUDIO.hop_length)
    assert mel.dtype == np.float32 and np.isfinite(mel).all()
    assert mel.min() >= np.log(AUDIO.mel_eps) - 1e-4


def test_sine_corpus_is_the_verify_recipes(tmp_path):
    """16 utterances, the recipe's two texts in turn, utterance i a sine
    of 0.8 + 0.1 i s."""
    meta = write_sine_corpus(str(tmp_path), audio=AUDIO, device="cpu")
    rows = metadata.read_metadata(meta)
    assert [r["text"] for r in rows] == [
        "Hello world, this is a test.", "The quick brown fox."] * 8
    for i, row in enumerate(rows):
        base = metadata.basename_of(row["filepath"])
        mel = np.load(os.path.join(str(tmp_path), "mels", f"{base}.npy"))
        samples = int(AUDIO.sampling_rate * (0.8 + 0.1 * i))
        assert mel.shape == (8, 1 + samples // AUDIO.hop_length)
        assert np.load(os.path.join(str(tmp_path), "text", f"{base}.npy")
                       ).tolist() == text_to_sequence(row["text"])


@pytest.mark.parametrize("csv", [0, 1], ids=["one speaker", "speakers"])
def test_dataset_matches(corpus, csv):
    path = corpus[csv]
    got, ref = dataset.TextMelDataset(path), jax_dataset.TextMelDataset(path)
    assert len(got) == len(ref) == 20
    assert got.n_speakers == ref.n_speakers == (1, 3)[csv]
    assert got.speaker_map == ref.speaker_map
    for i in range(len(ref)):
        g, r = got[i], ref[i]
        np.testing.assert_array_equal(g.text, r.text)
        np.testing.assert_array_equal(g.mel, r.mel)
        assert g.speaker_id == r.speaker_id
        assert got.text_length(i) == ref.text_length(i)
        assert got.mel_length(i) == ref.mel_length(i)


@pytest.mark.parametrize("seed", [0, 7, 1234])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True),
                                               (False, False)])
def test_loader_matches_jax(corpus, seed, shuffle, drop_last):
    """Three epochs of each loader: the same batches in the same order,
    padded to the same quantised shapes (batch 3 of 20: pools, a
    dropped or short last batch)."""
    train_csv, _ = corpus
    kw = dict(seed=seed, shuffle=shuffle, drop_last=drop_last,
              text_pad_multiple=8, mel_pad_multiple=16)
    got = dataset.BatchLoader(dataset.TextMelDataset(train_csv), 3, **kw)
    ref = jax_dataset.BatchLoader(jax_dataset.TextMelDataset(train_csv), 3,
                                  **kw)
    assert len(got) == len(ref)
    for _ in range(3):
        batches_equal(list(got), list(ref))


@pytest.mark.parametrize("skip", [1, 2])
def test_loader_skips_epochs(corpus, skip):
    """A loader that skips n epochs yields what a fresh one yields in its
    epoch n + 1 (a resumed run sees the unbroken run's order)."""
    train_csv, _ = corpus
    data = dataset.TextMelDataset(train_csv)
    whole = dataset.BatchLoader(data, 4, seed=3)
    for _ in range(skip):
        list(whole)
    resumed = dataset.BatchLoader(data, 4, seed=3)
    resumed.skip_epochs(skip)
    batches_equal(list(resumed), list(whole))


def test_loader_refuses_an_empty_epoch(corpus):
    data = dataset.TextMelDataset(corpus[0])
    with pytest.raises(ValueError, match="zero batches"):
        dataset.BatchLoader(data, 21)
    assert len(dataset.BatchLoader(data, 21, allow_empty=True)) == 0
    assert len(dataset.BatchLoader(data, 21, drop_last=False)) == 1


def test_loader_hands_on_a_reader_error(corpus, tmp_path):
    """A file missing under the prefetch thread raises in the consumer."""
    rows = metadata.read_metadata(corpus[0])
    rows.append({"filepath": "wavs/missing.wav", "text": "x"})
    path = str(tmp_path / "broken.csv")
    metadata._write_csv(path, rows, ["filepath", "text"])
    os.symlink(os.path.join(os.path.dirname(corpus[0]), "text"),
               tmp_path / "text")
    os.symlink(os.path.join(os.path.dirname(corpus[0]), "mels"),
               tmp_path / "mels")
    loader = dataset.BatchLoader(dataset.TextMelDataset(path), 21,
                                 shuffle=False, drop_last=False)
    with pytest.raises(FileNotFoundError):
        list(loader)


def read_gray_png(path):
    """(height, width) uint8 pixels of an 8-bit grayscale PNG."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body) & 0xFFFFFFFF, kind
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w, h, depth, color, _, _, _ = struct.unpack(">IIBBBBB", chunks[b"IHDR"])
    assert (depth, color) == (8, 0) and b"IEND" in chunks
    raw = zlib.decompress(chunks[b"IDAT"])
    rows = np.frombuffer(raw, np.uint8).reshape(h, w + 1)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:]


def test_alignment_png_without_matplotlib(tmp_path, monkeypatch):
    """Where matplotlib does not import, the heatmap is written as a
    grayscale PNG that reads back pixel for pixel: decoder step 0 at the
    bottom, the matrix's minimum black and its maximum white."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.default_rng(0)
    align = rng.random((2, 9, 5)).astype(np.float32)
    path = str(tmp_path / "a.png")
    plotting.save_alignment_plot(align, path, sample_index=1)
    pixels = read_gray_png(path)
    m = align[1]
    expected = np.round((m[::-1] - m.min()) / (m.max() - m.min()) * 255)
    np.testing.assert_array_equal(pixels, expected.astype(np.uint8))
    assert pixels.min() == 0 and pixels.max() == 255
    plotting.save_alignment_plot(np.zeros((1, 3, 4)), path)   # flat
    assert (read_gray_png(path) == 0).all()


def test_alignment_png_with_matplotlib(tmp_path):
    pytest.importorskip("matplotlib")
    path = str(tmp_path / "a.png")
    plotting.save_alignment_plot(np.random.default_rng(0).random((1, 6, 4)),
                                 path)
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_step_timer_and_logger(tmp_path, capsys):
    timer = StepTimer(window=2, device="cpu")
    assert timer.stats()["steps_per_sec"] != timer.stats()["steps_per_sec"]
    for _ in range(4):
        timer.tick()
    stats = timer.stats(frames_per_step=100)
    assert timer.total_steps == 4 and stats["step_time_s"] > 0
    assert stats["mel_frames_per_sec"] == pytest.approx(
        100 / stats["step_time_s"])
    for cls, sub in ((TrainingLogger, "port"), (JaxLogger, "jax")):
        cls(str(tmp_path / sub)).log("Epoch 1 complete.")
        cls(str(tmp_path / sub)).log("Epoch 2 complete.")
    lines = capsys.readouterr().out.splitlines()
    assert lines == ["Epoch 1 complete.", "Epoch 2 complete."] * 2
    texts = [(tmp_path / sub / "training_log.txt").read_text().splitlines()
             for sub in ("port", "jax")]
    for text in texts:
        assert len(text) == 2 and text[1].endswith("] Epoch 2 complete.")
    assert [t[21:] for t in texts[0]] == [t[21:] for t in texts[1]]
