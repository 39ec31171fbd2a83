"""Long-form paragraph synthesis: sentence-chunked, bucketed, batched.

Counterpart of ``tacotron2_tpu/infer/longform.py``.  The reference caps any
utterance at ``max_decoder_steps=1000`` frames (~11.6 s; reference:
src/config.py:37); here a paragraph is split into sentences, sentences are
grouped by token bucket and decoded a group at a time, vocoded, and
concatenated with short inter-sentence silences.  Decoding is batched
across the sentences of a bucket, so a long paragraph costs one batched
decode a bucket instead of one decode a sentence.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..models.tacotron2 import Tacotron2, make_speaker_ids, tacotron2_infer
from ..text import pad_sequences, text_to_sequence
from .vocode import GriffinLim, Vocoder, vocode_mel

_SENTENCE_SPLIT = re.compile(r"(?<=[.!?;])\s+")


def split_sentences(text: str) -> List[str]:
    """Split a paragraph into sentence chunks (punctuation-aware)."""
    parts = [p.strip() for p in _SENTENCE_SPLIT.split(text.strip())]
    return [p for p in parts if p]


def _bucket_len(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def synthesize_longform(model: Tacotron2, text: str,
                        cfg: Optional[Config] = None,
                        max_steps_per_sentence: Optional[int] = None,
                        gate_threshold: Optional[float] = None,
                        silence_ms: float = 120.0,
                        token_buckets: Sequence[int] = (32, 64, 128, 256),
                        vocoder: Optional[Vocoder] = None,
                        griffinlim_iters: int = 60,
                        speaker_id: Optional[int] = None,
                        modular: bool = False,
                        device: Union[str, torch.device] = "cuda"
                        ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Paragraph -> (waveform, per-sentence mels).

    ``vocoder`` is a callable of the seam ``infer/vocode.py``; None is
    Griffin-Lim at ``griffinlim_iters``.  Default route: each token-bucket
    group goes through the length-proportional pipeline
    (``infer/fused.py::synthesize_pcm_proportional``) -- batched sentence
    decode capped at the text-predicted mel bucket, bucket-length vocode,
    and int16 PCM + frame_ends + mels fetched in one round a group.

    ``modular`` takes the modular route instead: decode per bucket, fetch
    the mels, vocode each sentence on its own (``vocode_mel``, padded to
    its 128-frame bucket).
    """
    cfg = cfg or Config()
    max_steps = max_steps_per_sentence or model.cfg.max_decoder_steps
    sentences = split_sentences(text)
    if not sentences:
        return np.zeros(0, np.float32), []

    seqs = []
    max_bucket = token_buckets[-1]
    for s in sentences:
        ids = text_to_sequence(s) or [0]
        if len(ids) <= max_bucket:
            seqs.append(ids)
        else:
            # run-on sentence beyond the largest bucket: chunk it rather
            # than silently truncating words
            print(f"[longform] splitting a {len(ids)}-token sentence into "
                  f"{-(-len(ids) // max_bucket)} chunks")
            for start in range(0, len(ids), max_bucket):
                seqs.append(ids[start:start + max_bucket])

    # Group chunks into token-length buckets -> one decode per bucket.
    groups = {}
    for i, s in enumerate(seqs):
        groups.setdefault(_bucket_len(len(s), token_buckets), []).append(i)

    mels: List[Optional[np.ndarray]] = [None] * len(seqs)
    silence = np.zeros(int(cfg.audio.sampling_rate * silence_ms / 1000.0),
                       np.float32)
    hop = cfg.audio.hop_length

    if not modular:
        # Proportional path: one bucket pipeline per token group, PCM +
        # frame_ends + mels in a single fetch round.
        from .fused import synthesize_pcm_proportional
        wavs: List[Optional[np.ndarray]] = [None] * len(seqs)
        for bucket, idxs in sorted(groups.items()):
            tokens, lengths = pad_sequences([seqs[i] for i in idxs],
                                            pad_to=bucket)
            speaker_ids = make_speaker_ids(speaker_id, len(idxs), model.cfg)
            pcm, ends, _, mel = synthesize_pcm_proportional(
                model, cfg.audio, tokens, lengths, speaker_ids,
                max_steps=max_steps, gate_threshold=gate_threshold,
                stop_mode="all", gl_iters=griffinlim_iters,
                vocoder=vocoder, return_mel=True, device=device)
            for row, i in enumerate(idxs):
                n = int(ends[row])
                mels[i] = np.asarray(mel[row, :n])          # (n, n_mels)
                wavs[i] = (pcm[row, : n * hop]
                           .astype(np.float32) / 32767.0)
        pieces: List[np.ndarray] = []
        for i, wav in enumerate(wavs):
            pieces.append(wav if wav is not None
                          else np.zeros(0, np.float32))
            if i < len(wavs) - 1:
                pieces.append(silence)
        return np.concatenate(pieces), [m for m in mels if m is not None]

    # Modular path: decode per bucket, fetch mels, vocode per sentence.
    for bucket, idxs in sorted(groups.items()):
        tokens, lengths = pad_sequences([seqs[i] for i in idxs],
                                        pad_to=bucket)
        speaker_ids = make_speaker_ids(speaker_id, len(idxs), model.cfg)
        out, n_frames, frame_ends = tacotron2_infer(
            model, tokens, max_steps=max_steps,
            gate_threshold=gate_threshold, drop_first_frame=True,
            text_lengths=lengths, speaker_ids=speaker_ids,
            stop_mode="all" if len(idxs) > 1 else "any", device=device)
        n = int(n_frames)
        mel_post = out.mel_postnet[:, :n].cpu().numpy()
        ends = frame_ends.cpu().numpy()
        for row, i in enumerate(idxs):
            mels[i] = mel_post[row, :int(ends[row])]

    # Vocode + concatenate with inter-sentence silence.
    vocoder = vocoder or GriffinLim(cfg.audio, griffinlim_iters)
    pieces = []
    for i, mel in enumerate(mels):
        wav = vocode_mel(mel, cfg.audio, vocoder, device=device)
        pieces.append(np.asarray(wav, np.float32))
        if i < len(mels) - 1:
            pieces.append(silence)
    return np.concatenate(pieces), [m for m in mels if m is not None]
