"""Metadata CSVs of preprocessed corpora.

An own copy of ``read_metadata``, ``_write_csv`` and ``basename_of`` from
``tacotron2_tpu/data/metadata.py`` (standard library only): a corpus
directory holds ``metadata.csv`` (columns ``filepath,text`` and optionally
``speaker_id``) beside ``text/<basename>.npy`` and ``mels/<basename>.npy``.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List


def read_metadata(path: str) -> List[Dict[str, str]]:
    """Read a metadata CSV into a list of dict rows."""
    with open(path, "r", encoding="utf-8", newline="") as f:
        return list(csv.DictReader(f))


def _write_csv(path: str, rows: List[Dict[str, str]],
               fieldnames: List[str]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(rows)


def basename_of(filepath: str) -> str:
    """Cache key of an audio file: its name without ``.flac`` / ``.wav``."""
    base = os.path.basename(filepath)
    for ext in (".flac", ".wav"):
        if base.endswith(ext):
            base = base[: -len(ext)]
    return base
