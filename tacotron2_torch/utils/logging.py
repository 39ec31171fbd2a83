"""Timestamped training log file.

An own copy of ``tacotron2_tpu/utils/logging.py`` for one process (the
JAX logger's switch for the other processes of a multi-host run has no
use here)."""

from __future__ import annotations

import os
from datetime import datetime


class TrainingLogger:
    """Appends timestamped lines to ``<checkpoint_dir>/training_log.txt``
    and mirrors them to stdout."""

    def __init__(self, checkpoint_dir: str):
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.path = os.path.join(checkpoint_dir, "training_log.txt")

    def log(self, msg: str) -> None:
        ts = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(f"[{ts}] {msg}\n")
        print(msg)
