#!/usr/bin/env python3
"""Quality-regression evaluation on the PyTorch port: MCD, gate timing,
alignment diagonality.

The counterpart of ``tools/eval_quality.py``, with the same flags plus
``--device`` and the same report (per-item detail included): a checkpoint
evaluated on a held-out preprocessed metadata set with the metrics of
``tacotron2_torch/utils/quality.py``:

  * teacher-forced MCD (frame-aligned) per item,
  * autoregressive MCD (DTW-aligned) + gate-timing error per item,
  * alignment diagonality (teacher-forced attention).

    python tools/eval_quality_torch.py CKPT processed/metadata.csv \\
        [--n 16] [--out report.json] [--skip-ar] [--n_speakers 4] \\
        [--device cuda|cpu]

The weights are served in fp32 as ``load_model`` loads them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional, Union

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # runnable from any cwd


def evaluate(checkpoint: str, metadata: str, n: int = 16,
             skip_ar: bool = False, max_steps: int = 1000,
             n_speakers: Optional[int] = None,
             device: Union[str, "torch.device"] = "cuda") -> dict:
    """The report of ``tools/eval_quality.py`` for ``checkpoint`` on the
    first ``n`` items of ``metadata``, computed on ``device``."""
    import torch

    from tacotron2_torch.config import Config
    from tacotron2_torch.data.dataset import TextMelDataset
    from tacotron2_torch.infer.synthesize import load_model
    from tacotron2_torch.models.tacotron2 import (tacotron2_forward,
                                                  tacotron2_infer)
    from tacotron2_torch.utils.device import resolve_device
    from tacotron2_torch.utils.quality import (alignment_diagonality,
                                               gate_timing_error, mcd_dtw,
                                               mcd_frame_aligned, summarize)

    device = resolve_device(device)
    cfg = Config()
    if n_speakers:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, n_speakers=n_speakers))
    model = load_model(checkpoint, cfg, device=device)
    ds = TextMelDataset(metadata)
    n = min(n, len(ds))
    print(f"Evaluating {n} items from {metadata}")

    tf_mcd, diag, ar_mcd, gate_err = [], [], [], []
    per_item = []
    for i in range(n):
        item = ds[i]
        text = np.asarray(item.text, np.int32)
        mel = np.asarray(item.mel, np.float32)             # (80, T)
        t_dec = mel.shape[1]
        spk = [int(item.speaker_id)]
        detail = {"index": i, "text_len": int(len(text)),
                  "mel_len": int(t_dec),
                  "speaker_id": int(item.speaker_id)}
        per_item.append(detail)

        # ---- teacher-forced: frame-aligned MCD + diagonality ----
        with torch.no_grad():
            out = tacotron2_forward(model, text[None], mel[None],
                                    [len(text)], train=False,
                                    use_postnet=True, speaker_ids=spk,
                                    device=device)
        pred_tf = out.mel_postnet[0].float().cpu().numpy()   # (T, 80)
        tf_mcd.append(mcd_frame_aligned(pred_tf, mel.T))
        diag.append(alignment_diagonality(
            out.alignments[0].float().cpu().numpy(), text_len=len(text),
            mel_len=t_dec))
        detail["mcd_tf_db"] = round(float(tf_mcd[-1]), 3)
        detail["diagonality"] = round(float(diag[-1]), 4)

        # ---- autoregressive: DTW MCD + gate timing ----
        if not skip_ar:
            aout, _, ends = tacotron2_infer(model, text[None],
                                            max_steps=max_steps,
                                            speaker_ids=spk, device=device)
            end = int(ends[0])
            pred_ar = aout.mel_postnet[0, :max(end, 1)].float().cpu().numpy()
            ar_mcd.append(mcd_dtw(pred_ar, mel.T))
            gate_err.append(gate_timing_error(end, t_dec))
            detail["ar_end_frames"] = end
            detail["mcd_ar_dtw_db"] = round(float(ar_mcd[-1]), 3)
            detail["gate_err_frames"] = round(float(gate_err[-1]), 1)
        if (i + 1) % 8 == 0:
            print(f"  {i + 1}/{n}")

    report = {
        "checkpoint": checkpoint,
        "n_items": n,
        "mcd_teacher_forced_db": summarize(tf_mcd),
        "alignment_diagonality": summarize(diag),
    }
    if not skip_ar:
        report["mcd_autoregressive_dtw_db"] = summarize(ar_mcd)
        report["gate_timing_error_frames"] = summarize(gate_err)
    # Per-item detail so tail outliers in the summary are traceable to
    # the exact val item.
    report["per_item"] = per_item
    return report


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("metadata", help="preprocessed metadata.csv (the "
                                     "directory must hold text/ and mels/)")
    ap.add_argument("--n", type=int, default=16,
                    help="max items to evaluate (default 16)")
    ap.add_argument("--out", default=None, help="also write JSON here")
    ap.add_argument("--skip-ar", action="store_true",
                    help="skip the autoregressive pass (faster; "
                         "teacher-forced metrics only)")
    ap.add_argument("--max_steps", type=int, default=1000)
    ap.add_argument("--n_speakers", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    report = evaluate(args.checkpoint, args.metadata, n=args.n,
                      skip_ar=args.skip_ar, max_steps=args.max_steps,
                      n_speakers=args.n_speakers, device=args.device)
    print(json.dumps(report, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
