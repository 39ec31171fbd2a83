"""Timestamped training log file.

An own copy of ``tacotron2_tpu/utils/logging.py``."""

from __future__ import annotations

import os
from datetime import datetime


class TrainingLogger:
    """Appends timestamped lines to ``<checkpoint_dir>/training_log.txt``
    and mirrors them to stdout.  ``enabled=False`` leaves the file alone
    and still prints: the ranks of a data-parallel run share
    ``checkpoint_dir``, and only rank 0 writes."""

    def __init__(self, checkpoint_dir: str, enabled: bool = True):
        os.makedirs(checkpoint_dir, exist_ok=True)
        self.path = os.path.join(checkpoint_dir, "training_log.txt")
        self.enabled = enabled

    def log(self, msg: str) -> None:
        if self.enabled:
            ts = datetime.now().strftime("%Y-%m-%d %H:%M:%S")
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(f"[{ts}] {msg}\n")
        print(msg)
