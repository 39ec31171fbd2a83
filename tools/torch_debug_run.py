#!/usr/bin/env python3
"""The debug-overfit recipe of the training CLI, on one CUDA card.

    python3 tools/torch_debug_run.py [--corpus sines|tones] [--epochs 10]

Writes a corpus into a temporary directory in the preprocessed layout,
then runs ``python3 train_torch.py <corpus>/metadata.csv <dir> --debug
--epochs N --lr 1e-3`` on it and prints the iteration at which the mel L1
fell below 1.0 (or the last one it reached), the wall time of the run,
the export's files and the card's name and power limit.  Both corpora are
``tacotron2_torch/data/synth_corpus.py``'s: ``sines`` is the JAX package's
verification corpus (``write_sine_corpus``), ``tones`` 16 utterances of
formant tones, one a token (``write_corpus``).  Nothing is kept: the temporary directory goes at the
end.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", choices=["sines", "tones"], default="sines")
    ap.add_argument("--epochs", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_debug_run: needs a CUDA card", file=sys.stderr)
        return 2
    from tacotron2_torch.data.synth_corpus import (write_corpus,
                                                   write_sine_corpus)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        meta = (write_sine_corpus(corpus) if args.corpus == "sines"
                else write_corpus(corpus, 16, seed=0, device="cuda")[0])
        run = os.path.join(tmp, "run")
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "train_torch.py"), meta, run,
             "--debug", "--epochs", str(args.epochs), "--lr", "1e-3"],
            capture_output=True, text=True, cwd=ROOT)
        wall = time.perf_counter() - t0
        print(out.stdout[-3000:])
        if out.returncode != 0:
            print(out.stderr[-3000:], file=sys.stderr)
            return out.returncode
        mels = [float(m) for m in re.findall(r"^  Mel ([0-9.]+)", out.stdout,
                                             re.M)]
        success = re.search(r"SUCCESS: mel L1 ([0-9.]+) < [0-9.]+ at "
                            r"iteration (\d+)", out.stdout)
        export = os.path.join(run, "debug_export")
        files = sorted(os.listdir(export)) if os.path.isdir(export) else []
        print(f"[debug {args.corpus}] "
              + (f"mel L1 {success.group(1)} < 1.0 at iteration "
                 f"{success.group(2)}" if success else
                 f"no success in {args.epochs * 20} iterations; last mel L1 "
                 f"printed {mels[-1] if mels else None}")
              + f"; {wall:.1f} s wall for the whole run (start-up, corpus "
              f"read, training, export); export: {files}; {card}")
        if "Debug export failed" in out.stdout:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
