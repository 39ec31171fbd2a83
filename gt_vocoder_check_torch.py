#!/usr/bin/env python3
"""Ground-truth vocoder sanity check on the PyTorch port.

The counterpart of ``gt_vocoder_check.py``, with the same flags plus
``--device`` and the same report keys: pick a metadata row, recompute its
mel from the raw wav (authoritative), classify the mel scale
(LIKELY_LINEAR_0_1 / LIKELY_LOG / AMBIGUOUS), optionally compare with the
preprocessed cache, run Griffin-Lim (and optionally HiFi-GAN) on it, and
write a JSON report -- a check of the DSP round trip independent of the
model.

    python gt_vocoder_check_torch.py --metadata processed/metadata.csv \\
        [--processed_root processed/] [--index N] [--output_dir DIR] \\
        [--hifigan] [--gl_iters 60] [--try_pseudo_log] [--device cuda|cpu]
"""

import argparse
import json
import os
import random
from datetime import datetime, timezone
from typing import List, Optional

import numpy as np

from tacotron2_torch.config import AudioConfig
from tacotron2_torch.data.metadata import basename_of, read_metadata
from tacotron2_torch.dsp import get_mel_spectrogram, save_wav
from tacotron2_torch.utils.diagnostics import classify_mel_scale, mel_stats


def _prepare_mel_for_griffin_lim(mel: np.ndarray, scale_guess: str,
                                 cfg: AudioConfig) -> np.ndarray:
    """Return a linear mel for Griffin-Lim.

    LIKELY_LINEAR_0_1: undo assumed (db+80)/80 normalization back to power;
    LIKELY_LOG: exponentiate natural-log mel; AMBIGUOUS: pass through.
    """
    if scale_guess == "LIKELY_LINEAR_0_1":
        mel_db = mel * 80.0 - 80.0
        return np.power(10.0, mel_db / 10.0)  # dB -> power
    if scale_guess == "LIKELY_LOG":
        return np.exp(mel)
    return mel


def _linear_mel_to_audio(mel_lin: np.ndarray, n_iter: int,
                         cfg: AudioConfig, device) -> np.ndarray:
    """Griffin-Lim a mel that is already linear (power=1.0 semantics),
    bypassing mel_to_audio's log-detect heuristic."""
    import torch

    from tacotron2_torch.dsp import griffin_lim, mel_to_linear
    linear = mel_to_linear(
        torch.from_numpy(np.maximum(mel_lin, 0.0).astype(np.float32)).to(
            device), sr=cfg.sampling_rate, n_fft=cfg.n_fft,
        n_mels=cfg.n_mels, fmin=cfg.fmin, fmax=cfg.fmax)
    return griffin_lim(linear, n_fft=cfg.n_fft, hop_length=cfg.hop_length,
                       win_length=cfg.win_length,
                       n_iter=n_iter).cpu().numpy()


def approximate_linear01_to_log(mel_linear01: np.ndarray) -> np.ndarray:
    """Diagnostic pseudo-log mapping 0..1 -> [-6, 0]."""
    x = np.clip(mel_linear01, 0.0, 1.0)
    return -6.0 + 6.0 * x


def main(args) -> dict:
    from tacotron2_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    cfg = AudioConfig()
    rows = read_metadata(args.metadata)
    if not rows:
        raise ValueError("Empty metadata.")
    if "filepath" not in rows[0] or "text" not in rows[0]:
        raise ValueError("Metadata must contain 'filepath' and 'text'.")

    if args.index is not None:
        if not (0 <= args.index < len(rows)):
            raise IndexError(f"--index out of range (0..{len(rows) - 1})")
        row = rows[args.index]
    else:
        row = rows[random.randint(0, len(rows) - 1)]
    wav_path, text = row["filepath"], row["text"]
    basename = basename_of(wav_path)
    print(f"Selected sample: basename={basename}")

    os.makedirs(args.output_dir, exist_ok=True)
    report = {"timestamp": datetime.now(timezone.utc).isoformat(),
              "wav_path": wav_path, "text": text, "basename": basename}

    # Optional: the preprocessed cache's mel
    if args.processed_root:
        mel_path = os.path.join(args.processed_root, "mels",
                                f"{basename}.npy")
        if os.path.isfile(mel_path):
            proc = np.load(mel_path)
            if proc.shape[0] != cfg.n_mels and proc.shape[1] == cfg.n_mels:
                proc = proc.T
            stats = mel_stats(proc)
            guess = classify_mel_scale(stats)
            print(f"[PROC MEL] stats={stats} scale_guess={guess}")
            report["processed_mel_stats"] = stats
            report["processed_mel_scale_guess"] = guess
        else:
            print(f"Processed mel not found: {mel_path}")

    # Authoritative: recompute from the raw wav
    mel = get_mel_spectrogram(wav_path, cfg, device=device)
    stats = mel_stats(mel)
    guess = classify_mel_scale(stats)
    print(f"[RECOMP MEL] stats={stats} scale_guess={guess}")
    report["recomputed_mel_stats"] = stats
    report["recomputed_mel_scale_guess"] = guess

    print(f"Preparing mel for Griffin-Lim (scale guess: {guess})")
    mel_lin = _prepare_mel_for_griffin_lim(mel, guess, cfg)
    print("Running Griffin-Lim on prepared mel...")
    # Invert the already-linear mel directly: fed back through
    # mel_to_audio, its log/linear heuristic would fire on the wide linear
    # dynamic range and exponentiate a second time.
    wav_gl = _linear_mel_to_audio(mel_lin, args.gl_iters, cfg, device)
    gl_path = os.path.join(args.output_dir, f"{basename}_gt_griffinlim.wav")
    save_wav(gl_path, wav_gl, cfg.sampling_rate)
    print(f"Saved: {gl_path}")

    if guess == "LIKELY_LINEAR_0_1" and args.try_pseudo_log:
        pseudo = np.exp(approximate_linear01_to_log(mel))
        print("Running Griffin-Lim on pseudo-log transformed mel...")
        wav_p = _linear_mel_to_audio(pseudo, args.gl_iters, cfg, device)
        p_path = os.path.join(args.output_dir,
                              f"{basename}_gt_griffinlim_pseudolog.wav")
        save_wav(p_path, wav_p, cfg.sampling_rate)
        print(f"Saved: {p_path}")

    if args.hifigan:
        from tacotron2_torch.infer.vocode import try_load_hifigan
        vocode = try_load_hifigan(device=device)
        if vocode is None:
            print("HiFi-GAN synthesis failed: generator unavailable")
            report["hifigan_error"] = "generator unavailable"
        else:
            wav_h = vocode(mel[None])[0]
            h_path = os.path.join(args.output_dir,
                                  f"{basename}_gt_hifigan.wav")
            save_wav(h_path, wav_h, cfg.sampling_rate)
            print(f"Saved: {h_path}")

    report_path = os.path.join(args.output_dir,
                               f"{basename}_vocoder_check.json")
    with open(report_path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2)
    print(f"Report saved: {report_path}")
    print("Done.")
    return report


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Ground-truth vocoder sanity check.")
    parser.add_argument("--metadata", type=str, required=True)
    parser.add_argument("--processed_root", type=str, default=None)
    parser.add_argument("--index", type=int, default=None)
    parser.add_argument("--output_dir", type=str, default="gt_vocoder_check")
    parser.add_argument("--hifigan", action="store_true")
    parser.add_argument("--gl_iters", type=int, default=60)
    parser.add_argument("--try_pseudo_log", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
