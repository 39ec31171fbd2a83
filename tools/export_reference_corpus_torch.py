#!/usr/bin/env python3
"""Export a processed corpus to the reference trainer's cache format, with
the PyTorch port alone.

The counterpart of ``tools/export_reference_corpus.py``, with its flags:
the reference trainer reads per-utterance ``torch.save``'d caches,
``mels/<base>.pt`` holding an (n_mels, T) float32 tensor and
``text/<base>.pt`` a 1-D int64 tensor of token ids, found through a
``metadata.csv`` with a ``filepath`` column (reference:
src/data_utils.py:14-40).  This writes the processed corpus's ``.npy``
caches (``preprocess_torch.py``'s layout, the JAX package's) in that
layout, so that both trainers can run on the same mels and token ids.

    python tools/export_reference_corpus_torch.py PROCESSED_DIR OUT_DIR \\
        [--val_count N]

With ``--val_count N`` the last N metadata rows go to
``metadata_val.csv`` and the rest to ``metadata_train.csv``, in both
directories, so the two trainers also share the split.  The casts to the
cache types run on ``--device`` (default ``cuda``; ``--device cpu`` off
the card), as every entry point of the port does.
"""

from __future__ import annotations

import argparse
import csv
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # runnable from any cwd

from tacotron2_torch.data.metadata import basename_of  # noqa: E402


def export(processed_dir: str, out_dir: str, val_count: int = 0,
           device="cuda") -> int:
    """Write the caches and CSVs; returns the number of items."""
    import torch

    from tacotron2_torch.utils.device import resolve_device
    device = resolve_device(device)
    cast = lambda x, dtype: torch.from_numpy(x).to(device, dtype).cpu()

    os.makedirs(os.path.join(out_dir, "mels"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "text"), exist_ok=True)
    meta_path = os.path.join(processed_dir, "metadata.csv")
    with open(meta_path, newline="") as f:
        rows = list(csv.DictReader(f))

    for row in rows:
        base = basename_of(row["filepath"])
        mel = np.load(os.path.join(processed_dir, "mels", f"{base}.npy"))
        seq = np.load(os.path.join(processed_dir, "text", f"{base}.npy"))
        torch.save(cast(mel, torch.float32),
                   os.path.join(out_dir, "mels", f"{base}.pt"))
        torch.save(cast(seq, torch.int64),
                   os.path.join(out_dir, "text", f"{base}.pt"))
    shutil.copy(meta_path, os.path.join(out_dir, "metadata.csv"))

    if val_count > 0:
        if val_count >= len(rows):
            raise SystemExit(f"--val_count {val_count} >= corpus {len(rows)}")
        header = list(rows[0].keys())
        for d in (processed_dir, out_dir):
            for name, subset in (("metadata_train.csv", rows[:-val_count]),
                                 ("metadata_val.csv", rows[-val_count:])):
                with open(os.path.join(d, name), "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=header)
                    w.writeheader()
                    w.writerows(subset)
    return len(rows)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("processed_dir")
    p.add_argument("out_dir")
    p.add_argument("--val_count", type=int, default=0,
                   help="split the last N rows into metadata_val.csv "
                        "(written to BOTH dirs)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = p.parse_args(argv)
    n = export(a.processed_dir, a.out_dir, a.val_count, a.device)
    print(f"Exported {n} items -> {a.out_dir}"
          + (f" (train/val split: {n - a.val_count}/{a.val_count})"
             if a.val_count else ""))
    return n


if __name__ == "__main__":
    main()
