"""Text-to-speech synthesis pipeline, the port's serving entry points.

Counterpart of ``tacotron2_tpu/infer/synthesize.py``: load weights ->
text_to_sequence -> autoregressive mel decode -> Griffin-Lim ->
auto-numbered output WAV.  Batched synthesis is a first-class capability.
:func:`synthesize_mels_tokens` is the same from token ids on.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..dsp.wav import save_wav
from ..models.tacotron2 import Tacotron2, make_speaker_ids, tacotron2_infer
from ..text import pad_sequences, text_to_sequence
from ..utils.device import resolve_device
from ..utils.weight_files import load_weights

Device = Union[str, torch.device]


def print_mel_stats(mel, tag: str) -> None:
    """Pred-mel stats + scale warning (reference: inference.py:98-111)."""
    from ..utils.diagnostics import mel_stats
    s = mel_stats(mel)
    print(f"[MEL STATS] {tag}: min {s['min']:.4f} max {s['max']:.4f} "
          f"mean {s['mean']:.4f} std {s['std']:.4f} p01 {s['p01']:.4f} "
          f"p50 {s['p50']:.4f} p99 {s['p99']:.4f}")
    if s["min"] >= -1e-4 and 0.0 <= s["max"] <= 1.05:
        print(f"[WARN] {tag}: Mel appears 0-1 linear; pretrained HiFi-GAN "
              f"expects log-mel (negative values).")
    else:
        print(f"[INFO] {tag}: Mel dynamic range includes negatives or >1 "
              f"values; likely log-compressed.")


def load_model(checkpoint_path: str, cfg: Optional[Config] = None,
               device: Device = "cuda") -> Tacotron2:
    """Load a model on ``device`` from a checkpoint: an Orbax checkpoint
    directory of the JAX package (params-only or full; read without JAX by
    ``utils/orbax_reader.py`` and mapped by ``utils/weights.py::
    load_jax_params``), a directory the port's trainer wrote
    (``train/checkpoint.py``), or the port's weights file (the model's
    ``state_dict`` written by ``torch.save``; ``tools/export_torch_weights.py``
    writes one from a checkpoint of the JAX package).  Every floating
    tensor is upcast to fp32 on load, as the JAX package restores a bf16
    checkpoint into its fp32 template
    (``tacotron2_tpu/train/checkpoint.py::restore_params_only``): the model
    serves in fp32.  For bf16 serving cast it with
    ``models/tacotron2.py::cast_params_bf16``.

    ``cfg`` must match the checkpoint's architecture (a multi-speaker
    checkpoint needs ``cfg.model.n_speakers`` set to its table's rows)."""
    cfg = cfg or Config()
    device = resolve_device(device)
    if not os.path.exists(checkpoint_path):
        raise FileNotFoundError(f"checkpoint not found: {checkpoint_path}")
    if os.path.isdir(checkpoint_path):
        return load_weights(checkpoint_path, Tacotron2(cfg.model)).to(device)
    sd = torch.load(checkpoint_path, weights_only=True, map_location=device)
    sd = {k: v.float() if v.is_floating_point() else v for k, v in sd.items()}
    model = Tacotron2(cfg.model)
    try:
        model.load_state_dict(sd, strict=True, assign=True)
    except RuntimeError as e:
        raise RuntimeError(
            f"could not load weights {checkpoint_path!r}: {e} (a "
            f"multi-speaker file needs a matching n_speakers config)") from e
    return model.to(device)


def synthesize_mels_tokens(model: Tacotron2,
                           token_seqs: Sequence[Sequence[int]],
                           max_steps: Optional[int] = None,
                           gate_threshold: Optional[float] = None,
                           speaker_id=None, device: Device = "cuda"
                           ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Token-id sequences -> list of (T_i, n_mels) postnet mels, each
    trimmed at its own gate stop, and the alignments (B, n_frames, T_enc).

    The batch is padded to a multiple of 16 tokens and the padding masked.
    One sequence decodes with the "any" stop rule, a batch with "all"
    (until every item's gate has fired).
    """
    tokens, lengths = pad_sequences(token_seqs, pad_multiple=16)
    speaker_ids = make_speaker_ids(speaker_id, len(token_seqs), model.cfg)
    out, n_frames, frame_ends = tacotron2_infer(
        model, tokens, max_steps=max_steps, gate_threshold=gate_threshold,
        text_lengths=lengths, speaker_ids=speaker_ids,
        stop_mode="all" if len(token_seqs) > 1 else "any", device=device)
    n = int(n_frames)
    mel_post = out.mel_postnet[:, :n].cpu().numpy()
    if n < 3:
        print(f"[WARN] Very short mel length ({n}) - possible premature "
              f"stop. Gate threshold={model.cfg.gate_threshold}")
    ends = frame_ends.cpu().numpy()
    mels = [mel_post[b, :int(ends[b])] for b in range(mel_post.shape[0])]
    return mels, out.alignments[:, :n].cpu().numpy()


def synthesize_mels(model: Tacotron2, texts: Sequence[str],
                    max_steps: Optional[int] = None,
                    gate_threshold: Optional[float] = None,
                    speaker_id=None, device: Device = "cuda"
                    ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Texts -> list of (T_i, n_mels) postnet mels (gate-trimmed per item)
    and the alignments; :func:`synthesize_mels_tokens` after the text
    frontend."""
    return synthesize_mels_tokens(
        model, [text_to_sequence(t) for t in texts], max_steps,
        gate_threshold, speaker_id, device)


def next_output_path(output_dir: str, stem: str = "output",
                     ext: str = ".wav") -> str:
    """First free ``output_N.wav`` path (reference: inference.py:86-91)."""
    os.makedirs(output_dir, exist_ok=True)
    counter = 1
    while True:
        path = os.path.join(output_dir, f"{stem}_{counter}{ext}")
        if not os.path.exists(path):
            return path
        counter += 1


def synthesize(text: str, checkpoint_path: str, output_dir: str,
               vocoder: str = "griffinlim", cfg: Optional[Config] = None,
               griffinlim_iters: int = 60, speaker_id: Optional[int] = None,
               device: Device = "cuda") -> str:
    """Full single-utterance pipeline; returns the written WAV path."""
    cfg = cfg or Config()
    print("Loading Tacotron 2 model...")
    model = load_model(checkpoint_path, cfg, device)
    print("Tacotron 2 model loaded.")

    # "hifigan" tries HiFi-GAN and falls back to Griffin-Lim with a
    # message; any other name is Griffin-Lim (as in the JAX package)
    from .vocode import try_load_hifigan_params
    hifigan_params = (try_load_hifigan_params()
                      if vocoder.lower() == "hifigan" else None)

    # Length-proportional path: the mel bucket is picked from the text
    # length before any device work, encoder + decode + postnet + vocoder
    # run bucket-sized without a host synchronisation, and int16 PCM +
    # frame_ends + the diagnostic mel come back in one round
    # (infer/fused.py).
    from .fused import synthesize_pcm_proportional
    print("Processing input text + generating waveform (Griffin-Lim "
          "length-proportional path)...")
    tokens, lengths = pad_sequences([text_to_sequence(text) or [0]],
                                    pad_multiple=16)
    speaker_ids = make_speaker_ids(speaker_id, 1, cfg.model)
    pcm, ends, bucket, mel = synthesize_pcm_proportional(
        model, cfg.audio, tokens, lengths, speaker_ids,
        gl_iters=griffinlim_iters, hifigan_params=hifigan_params,
        return_mel=True, device=device)
    n0 = int(ends[0])
    if n0 < 3:
        print(f"[WARN] Very short mel length ({n0}) - possible "
              f"premature stop. Gate threshold="
              f"{cfg.model.gate_threshold}")
    print_mel_stats(mel[0, :max(n0, 1)], "Pred PostNet Mel")
    audio = pcm[0, : n0 * cfg.audio.hop_length].astype(np.float32) / 32767.0

    out_path = next_output_path(output_dir)
    save_wav(out_path, np.asarray(audio), cfg.audio.sampling_rate)
    print(f"\nAudio successfully saved to: {out_path}")
    return out_path
