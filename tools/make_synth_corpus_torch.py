#!/usr/bin/env python3
"""Generate the synthetic speech-like corpus with the PyTorch port alone.

The flags and output of ``tools/make_synth_corpus.py`` (``wavs/`` of
float32 WAV; pipe-format ``metadata.csv`` for ``prepare_ljspeech_torch.py``
with one speaker, ``filepath,text,speaker_id`` for ``preprocess_torch.py``
with more), bit for bit from the same seed, through
``tacotron2_torch/data/synth_corpus.py::make_synth_corpus``:

    python tools/make_synth_corpus_torch.py OUTDIR --n 256 --seed 0 \\
        [--n_speakers 4] [--prosody 0.2] [--rows 2000:2048]

``--rows A:B`` writes only utterances A..B-1 to disk (all are synthesized,
so each written file is the one the whole corpus holds).
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # runnable from any cwd


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min_words", type=int, default=3)
    ap.add_argument("--max_words", type=int, default=8)
    ap.add_argument("--prosody", type=float, default=0.0,
                    help="naturalistic variation strength (0 = the "
                         "deterministic corpus; 0.2 adds rate/duration "
                         "jitter, pitch wobble and a noise floor)")
    ap.add_argument("--n_speakers", type=int, default=1,
                    help="with >1, utterances round-robin over speakers "
                         "whose formants are scaled apart; metadata.csv "
                         "is written in filepath,text,speaker_id CSV form")
    ap.add_argument("--rows", default=None,
                    help="A:B -- write only utterances A..B-1 to disk")
    args = ap.parse_args()

    from tacotron2_torch.data.synth_corpus import make_synth_corpus

    rows = None
    if args.rows:
        lo, hi = (int(x) for x in args.rows.split(":"))
        rows = range(lo, hi)
    make_synth_corpus(args.outdir, n=args.n, seed=args.seed,
                      min_words=args.min_words, max_words=args.max_words,
                      prosody=args.prosody, n_speakers=args.n_speakers,
                      rows=rows)


if __name__ == "__main__":
    main()
