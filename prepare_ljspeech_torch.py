#!/usr/bin/env python3
"""Prepare LJSpeech metadata with the PyTorch port (the contract of
``prepare_ljspeech.py``, the same CSV byte for byte):

    python prepare_ljspeech_torch.py /data/LJSpeech-1.1 metadata.csv [--debug]

``--device`` is taken for symmetry with the other CLIs of the port; the
step runs on the host.
"""

import argparse

from tacotron2_torch.data.metadata import prepare_ljspeech_metadata

if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Prepare LJSpeech metadata.")
    parser.add_argument("dataset_path", type=str,
                        help="Root of the LJSpeech dataset directory.")
    parser.add_argument("output_path", type=str,
                        help="Path for the clean metadata CSV.")
    parser.add_argument("--debug", action="store_true",
                        help="Verbose validations.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="unused: the step runs on the host")
    args = parser.parse_args()

    prepare_ljspeech_metadata(args.dataset_path, args.output_path,
                              debug=args.debug)
