"""Dataset metadata: preparation (LJSpeech, LibriSpeech) and reading.

An own copy of ``tacotron2_tpu/data/metadata.py`` (standard library only),
with the same CSV contracts:
  * LJSpeech: pipe-separated ``metadata.csv`` -> columns ``filepath,text``
    (basename column 0, normalized-text column 2, absolute wav paths).
  * LibriSpeech: walk ``*.trans.txt`` files -> columns
    ``filepath,text,speaker_id``.

A preprocessed corpus directory holds ``metadata.csv`` beside
``text/<basename>.npy`` and ``mels/<basename>.npy``.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Dict, List


def prepare_ljspeech_metadata(dataset_path: str, output_path: str,
                              debug: bool = False) -> int:
    """LJSpeech root -> clean ``filepath,text`` CSV.  Returns row count."""
    metadata_file = os.path.join(dataset_path, "metadata.csv")
    wavs_path = os.path.join(dataset_path, "wavs")
    rows: List[Dict[str, str]] = []
    with open(metadata_file, "r", encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            # pipe-separated, no header, no quoting (csv.QUOTE_NONE semantics)
            parts = line.split("|")
            if len(parts) < 3:
                continue
            basename, _, norm_text = parts[0], parts[1], parts[2]
            fp = os.path.abspath(os.path.join(wavs_path, f"{basename}.wav"))
            rows.append({"filepath": fp, "text": norm_text})

    if debug:
        print(f"[DEBUG] parsed {len(rows)} rows from {metadata_file}")
        missing = [r["filepath"] for r in rows[:200]
                   if not os.path.isfile(r["filepath"])]
        if missing:
            print(f"[DEBUG][WARN] {len(missing)} missing wavs in first 200, "
                  f"e.g. {missing[:3]}")
        empties = sum(1 for r in rows if not r["text"].strip())
        if empties:
            print(f"[DEBUG][WARN] {empties} empty-text rows")

    _write_csv(output_path, rows, ["filepath", "text"])
    print(f"Clean LJSpeech metadata written: {output_path} ({len(rows)} rows)")
    return len(rows)


def prepare_librispeech_metadata(librispeech_root: str,
                                 output_path: str) -> int:
    """LibriSpeech root -> ``filepath,text,speaker_id`` CSV.

    speaker_id is carried through the pipeline for the multi-speaker model
    variant (the reference captures it but never consumes it,
    reference: prepare_metadata.py:47-51).
    """
    root = Path(librispeech_root)
    if not root.exists():
        raise FileNotFoundError(f"LibriSpeech root not found: {root}")
    trans_files = sorted(root.rglob("*.trans.txt"))
    if not trans_files:
        raise FileNotFoundError(
            "No '*.trans.txt' files found under the given root.")

    rows: List[Dict[str, str]] = []
    for trans in trans_files:
        chapter_dir = trans.parent
        speaker_id = chapter_dir.parent.name
        with open(trans, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                utt_id, _, text = line.partition(" ")
                audio = chapter_dir / f"{utt_id}.flac"
                if audio.exists():
                    rows.append({"filepath": str(audio.resolve()),
                                 "text": text,
                                 "speaker_id": speaker_id})
    _write_csv(output_path, rows, ["filepath", "text", "speaker_id"])
    print(f"LibriSpeech metadata written: {output_path} ({len(rows)} rows)")
    return len(rows)


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
