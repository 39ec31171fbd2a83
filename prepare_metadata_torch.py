#!/usr/bin/env python3
"""Prepare LibriSpeech metadata with the PyTorch port (the contract of
``prepare_metadata.py``, the same CSV byte for byte):

    python prepare_metadata_torch.py /data/LibriSpeech [--output metadata.csv]

``--device`` is taken for symmetry with the other CLIs of the port; the
step runs on the host.
"""

import argparse

from tacotron2_torch.data.metadata import prepare_librispeech_metadata

if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Prepare LibriSpeech metadata.")
    parser.add_argument("librispeech_path", type=str,
                        help="Root of the LibriSpeech dataset.")
    parser.add_argument("--output", type=str, default="metadata.csv")
    parser.add_argument("--device", type=str, default="cuda",
                        help="unused: the step runs on the host")
    args = parser.parse_args()

    prepare_librispeech_metadata(args.librispeech_path, args.output)
