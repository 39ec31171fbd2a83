"""Tiny cells for the CPU tests: the configurations' files with the
model's widths cut down (training) or the traffic cut to a few rows, so
that a whole run (set-up, window, check) takes seconds on the CPU, where
every kernel of the program takes its plain version."""

from __future__ import annotations

import time
import types

from benchmark.harness import env, registry
from benchmark.harness.session import Session

env.prepare()

TINY_MODEL = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
                  decoder_rnn_dim=32, attention_rnn_dim=32, prenet_dim=16,
                  attention_dim=8, location_n_filters=4,
                  location_kernel_size=5, postnet_embedding_dim=16, n_mels=8)

TRAIN_LIMITS = {"loss1_gap": 1e-5, "loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4}
SERVE_LIMITS = {"token_mismatch": 0, "mel_gap": 1e-4, "gate_gap": 1e-4,
                "stop_gap": 1e-4, "postnet_gap": 1e-4, "pcm_gap": 2e-3}


def train_cell(precision: str = "float32", limits=None) -> registry.Cell:
    cfg = registry.load_json(env.BENCH / "configs" / "tacotron2.json")
    cfg["model"].update(TINY_MODEL)
    cfg["train"]["precision"] = precision
    t = registry.load_json(env.BENCH / "traffic" / "ljspeech-b128.json")
    t.update(batch=4, pool_rows=64, frames_per_token=3.0,
             mel_frames={"mean": 20, "sd": 6, "min": 8, "max": 30})
    return registry.Cell("train-tiny", 1, cfg, t, limits or TRAIN_LIMITS,
                         [{"name": "setup_s", "unit": "s"},
                          {"name": "train_frames_per_s", "unit": "frames/s"}],
                         [])


def batch_cell(config: str = "tacotron2", limits=None) -> registry.Cell:
    cfg = registry.load_json(env.BENCH / "configs" / f"{config}.json")
    t = registry.load_json(env.BENCH / "traffic" / "batch64-vocab.json")
    t.update(batch=2, pool_sentences=64, check_batches=1)
    return registry.Cell("batch-tiny", 1, cfg, t, limits or SERVE_LIMITS,
                         [{"name": "setup_s", "unit": "s"},
                          {"name": "audio_s_per_s", "unit": "s/s"}], [])


def run(cell: registry.Cell, seed: int = 2**31 + 11, seconds: float = 0.5):
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=0)
    return Session(cell, args, time.perf_counter_ns(), device="cpu").run()
