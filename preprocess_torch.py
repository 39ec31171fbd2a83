#!/usr/bin/env python3
"""One-time corpus preprocessing on the PyTorch port: wav -> cached
log-mels on the card, text -> token IDs.

The flags of ``preprocess.py``, plus ``--device``:

    python preprocess_torch.py metadata.csv processed/ [--batch_size 64] \\
        [--device cuda|cpu]

The C++ WAV loader (``native/wavio.cc``) is built on first use into
``tacotron2_torch/_build/`` when ``g++`` is there; without it every file
takes the Python path.
"""

import argparse

from tacotron2_torch.data.preprocess import preprocess_corpus

if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Pre-process dataset for Tacotron 2 training.")
    parser.add_argument("metadata", type=str,
                        help="Path to the original metadata file.")
    parser.add_argument("output_dir", type=str,
                        help="Directory to save the processed data.")
    parser.add_argument("--batch_size", type=int, default=64,
                        help="Device batch size for mel extraction.")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args()

    preprocess_corpus(args.metadata, args.output_dir,
                      batch_size=args.batch_size, device=args.device)
