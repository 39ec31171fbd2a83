"""The traffic generators: the same sizes for every run seed, the order
from the seed, the distributions the traffic files state."""

import numpy as np

from benchmark.harness import registry, serving
from benchmark.harness.env import BENCH
from benchmark.harness.training_data import (batch_order, dropout_masks,
                                             lengths_pool, make_rows,
                                             pad_batch)

TRAIN = registry.load_json(BENCH / "traffic" / "ljspeech-b128.json")
BATCH = registry.load_json(BENCH / "traffic" / "batch64-vocab.json")


def test_ljspeech_lengths():
    frames, tokens = lengths_pool(TRAIN)
    assert len(frames) == TRAIN["pool_rows"]
    assert frames.min() >= 96 and frames.max() <= 870
    assert abs(frames.mean() - 566) < 15
    ratio = frames / tokens
    assert 6.3 / 1.12 < ratio.min() and ratio.max() < 6.3 / 0.88
    again = lengths_pool(TRAIN)
    assert (again[0] == frames).all() and (again[1] == tokens).all()


def test_batch_order_by_seed():
    a = batch_order(4096, 128, 2**31 + 3, 0)
    assert (a == batch_order(4096, 128, 2**31 + 3, 0)).all()
    assert not (a == batch_order(4096, 128, 5, 0)).all()
    epoch = np.concatenate([batch_order(4096, 128, 7, k) for k in range(32)])
    assert len(set(epoch.tolist())) == 4096       # rows all differ
    nxt = batch_order(4096, 128, 7, 32)           # the next epoch reshuffles
    assert not (nxt == batch_order(4096, 128, 7, 0)).all()


def test_rows_and_padding():
    t = dict(TRAIN, pool_rows=16)
    m = registry.load_json(BENCH / "configs" / "tacotron2.json")["model"]
    rows = make_rows(t, m, 11, "cpu")
    frames, tokens = lengths_pool(t)
    assert [r.mel.shape for r in rows] == [(80, int(f)) for f in frames]
    assert [len(r.text) for r in rows] == tokens.tolist()
    assert all(0 <= r.text.min() and r.text.max() < 72 for r in rows)
    b = pad_batch([r.text for r in rows], [r.mel for r in rows], 32, 64)
    assert b["text"].shape[1] % 32 == 0 and b["mel"].shape[2] % 64 == 0
    assert (np.diff(b["text_lengths"]) <= 0).all()


def test_dropout_masks_by_seed():
    m = registry.load_json(BENCH / "configs" / "tacotron2.json")["model"]
    m = dict(m, decoder_rnn_dim=8, prenet_dim=4, postnet_embedding_dim=4,
             n_mels=3)
    a = dropout_masks(m, 2, 5, 123, "cpu")
    b = dropout_masks(m, 2, 5, 123, "cpu")
    assert (a["attention"] == b["attention"]).all()
    assert a["attention"].shape == (5, 2, 8)
    assert [x.shape for x in a["postnet"]] == [(2, 4, 5)] * 4 + [(2, 3, 5)]
    assert abs(float(dropout_masks(m, 64, 64, 1, "cpu")["prenet"][0]
                     .float().mean()) - 0.5) < 0.02


def test_sentence_pool():
    vocab = set(registry.data_file("data/vocab.json")["words"])
    pool = serving.sentence_pool(BATCH)
    assert len(pool) == BATCH["pool_sentences"] == len(set(pool))
    assert pool == serving.sentence_pool(BATCH)
    for s in pool[:500]:
        words = s.rstrip(".").split(" ")
        assert s.endswith(".") and 3 <= len(words) <= 8
        assert set(words) <= vocab

