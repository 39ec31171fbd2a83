"""Tokens -> waveform without leaving the device.

Counterpart of ``tacotron2_tpu/infer/fused.py``.  There each function is
one compiled program; here each is one eager function on device tensors
with no host synchronisation inside it: encoder + decode kernel + postnet
+ vocoder are queued on the current stream back to back, and the host
waits once, when it fetches the result.  The vocoder is one argument, a
callable of the seam ``infer/vocode.py`` (``GriffinLim``, the HiFi-GAN
generator of ``models/hifigan.py`` in place of the JAX package's params
pytree, WaveGlow of ``models/waveglow.py`` or BigVGAN of
``models/bigvgan.py``); every function here vocodes through
:func:`_vocode`, inside the ``vocoder`` span.

Frames beyond the gate stop are masked to the log floor before vocoding,
so the vocoder sees silence there; the caller trims the returned waveform
at ``frame_ends * hop``.  The vocoder runs over the whole buffer: fixed at
``max_steps`` frames, or on the cut route (``trim=trim_to_bucket``, which
:func:`synthesize_wav` takes) at the bucket that ends just past the
batch's last stop, read from the device once after the decode.

``synthesize_pcm_proportional`` keeps the whole pipeline proportional to
the output's length, compute and transfer both: it

  1. picks a mel-length BUCKET from the text length before any device work
     (speech length tracks text length; LJSpeech averages ~6.2 mel frames
     per character, the default heuristic pads that to 7/char + 40 so
     under-prediction is rare);
  2. runs the pipeline for that bucket: decode capped at the bucket,
     bucket-length vocode, int16 PCM out (the bytes a WAV stores);
  3. fetches PCM + ``frame_ends`` with non-blocking copies and one
     synchronise;
  4. escalates once to the full ``max_steps`` if the gate never fired
     inside the bucket (``frame_ends`` hit the cap).

The two-phase split (``decode_mel_fused`` + ``vocode_bucket_pcm16``) keeps
the postnet mel on the device between the phases and picks the bucket from
the decoded length; it costs a second synchronise, which suits serving
where one decode feeds retries or batches.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import AudioConfig, Config
from ..models.tacotron2 import Tacotron2, make_speaker_ids, tacotron2_infer
from ..models.waveglow import WaveGlow
from ..text import pad_sequences, text_to_sequence
from ..utils.profiling import count, span
from .vocode import GriffinLim, Vocoder

Device = Union[str, torch.device]
Trim = Optional[Callable[[int, int], int]]


def _fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """Device tensors -> numpy: non-blocking copies into pinned memory
    started together, then one synchronise."""
    with span("fetch"):
        if all(t.device.type == "cpu" for t in tensors):
            return [t.numpy() for t in tensors]
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(tensors[0].device).synchronize()
        return [h.numpy() for h in host]


def _vocode(vocoder: Vocoder, mel: torch.Tensor) -> torch.Tensor:
    """Masked (B, S, n_mels) mel -> (B, S * hop) waveform, the vocoder's
    call alone inside the ``vocoder`` span."""
    with span("vocoder"):
        count("vocoder.frames", mel.shape[0] * mel.shape[1])
        return vocoder(mel.transpose(1, 2))


def synthesize_wav_fused(model: Tacotron2, vocoder: Vocoder,
                         acfg: AudioConfig, tokens, text_lengths=None,
                         speaker_ids=None, *,
                         max_steps: Optional[int] = None,
                         gate_threshold: Optional[float] = None,
                         stop_mode: str = "any",
                         forced_stop_at: Optional[int] = None,
                         trim: Trim = None, device: Device = "cuda"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """tokens (B, T_enc) -> (wav (B, S*hop), mel_postnet (B, S, n_mels),
    n_frames, frame_ends), all on the device, with ``vocoder``
    (``infer/vocode.py``) queued behind the decode.

    The reference's primary synthesis path is Tacotron 2 -> HiFi-GAN
    (reference: inference.py:40-54,71-74).  Frames past the gate stop are
    masked to the log-mel floor, so the vocoder renders silence there and
    the returned mel is the masked one; sample b's audio is valid up to
    ``frame_ends[b] * hop_length``.  The vocoder runs over the whole
    buffer: Griffin-Lim from the seed-0 phase drawn for its (B, F, S)
    shape, WaveGlow from the seed-0 noise drawn for its (B, 8, S * 32).
    ``forced_stop_at`` force-fires the gate at that frame — see
    models/decoder.py::decoder_infer.  ``trim`` cuts the buffer after the
    decode (``models/tacotron2.py::tacotron2_infer``), so S is
    ``max_steps`` or the cut length.
    """
    mel, n_frames, frame_ends = decode_mel_fused(
        model, tokens, text_lengths, speaker_ids, max_steps=max_steps,
        gate_threshold=gate_threshold, stop_mode=stop_mode,
        forced_stop_at=forced_stop_at, trim=trim,
        device=device)                                   # (B, S, n_mels)
    mel = _mask_and_slice(mel, frame_ends, mel.shape[1], acfg.mel_eps)
    return _vocode(vocoder, mel), mel, n_frames, frame_ends


# Mel-length buckets for the length-proportional path: the 128-frame grid
# the modular vocoder already uses (infer/vocode.py), densified toward
# short utterances where proportionality matters most.
VOCODE_BUCKETS = (128, 256, 384, 512, 640, 768, 896, 1000)


def decode_mel_fused(model: Tacotron2, tokens, text_lengths=None,
                     speaker_ids=None, *, max_steps: Optional[int] = None,
                     gate_threshold: Optional[float] = None,
                     stop_mode: str = "any",
                     forced_stop_at: Optional[int] = None,
                     trim: Trim = None, device: Device = "cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens (B, T_enc) -> (mel_postnet (B, S, n_mels), n_frames,
    frame_ends), all on the device; S is ``max_steps``, or the cut length
    where ``trim`` is given (``models/tacotron2.py::tacotron2_infer``).

    Phase 1 of the bucketed pipeline: callers fetch only ``frame_ends``
    (4 bytes/item) and hand the mel straight to :func:`vocode_bucket_pcm16`
    — the (B, S, n_mels) buffer never crosses to the host."""
    out, n_frames, frame_ends = tacotron2_infer(
        model, tokens, max_steps=max_steps, gate_threshold=gate_threshold,
        text_lengths=text_lengths, speaker_ids=speaker_ids,
        stop_mode=stop_mode, forced_stop_at=forced_stop_at, trim=trim,
        device=device)
    return out.mel_postnet, n_frames, frame_ends


def _mask_and_slice(mel: torch.Tensor, frame_ends: torch.Tensor,
                    bucket: int, mel_eps: float) -> torch.Tensor:
    """(B, S, n_mels) -> (B, bucket, n_mels) with post-gate frames at the
    log floor."""
    mel = mel[:, :bucket]
    valid = (torch.arange(bucket, device=mel.device)[None, :, None]
             < frame_ends[:, None, None])
    floor = mel.new_tensor(float(np.float32(np.log(mel_eps))))
    return torch.where(valid, mel, floor)


def _to_pcm16(wav: torch.Tensor) -> torch.Tensor:
    """float waveform -> int16 PCM on the device (the bytes a WAV stores;
    half the transfer of fp32).  Rounds half to even, as ``jnp.round``."""
    return torch.clamp(torch.round(wav * 32767.0),
                       -32768.0, 32767.0).to(torch.int16)


def vocode_bucket_pcm16(vocoder: Vocoder, mel: torch.Tensor,
                        frame_ends: torch.Tensor, acfg: AudioConfig,
                        bucket: int) -> torch.Tensor:
    """Device-resident mel (B, S, n_mels) -> int16 PCM (B, bucket*hop)
    via ``vocoder`` over just the ``bucket``-frame prefix.

    Phase 2 of the bucketed pipeline: compute AND output transfer
    proportional to the bucket — a 300-frame utterance runs 384 frames,
    not the 1000-frame tail."""
    mel = _mask_and_slice(mel, frame_ends, bucket, acfg.mel_eps)
    return _to_pcm16(_vocode(vocoder, mel))


def pick_bucket(n_frames: int, max_steps: int,
                buckets: Tuple[int, ...] = VOCODE_BUCKETS) -> int:
    """Smallest bucket covering ``n_frames``, capped at ``max_steps``."""
    for b in buckets:
        if b >= n_frames:
            return min(b, max_steps)
    return max_steps


# The cut route's margin past the batch's last stop: the postnet reaches
# 10 frames either side (five 5-tap layers) and HiFi-GAN 16, so every
# delivered sample sees the inputs it sees in the whole buffer.  WaveGlow
# and BigVGAN (38 frames) reach further: where a bucket ends within their
# radius of the last stop, that row's last samples see the buffer's end.
TRIM_MARGIN = 32


def trim_to_bucket(n_frames: int, max_steps: int) -> int:
    """The cut route's buffer length (``trim`` of :func:`tacotron2_infer`):
    the smallest bucket covering the batch's last stop plus
    ``TRIM_MARGIN``; ``max_steps`` where no stop came."""
    return pick_bucket(n_frames + TRIM_MARGIN, max_steps)


def synthesize_wav_buckets(model: Tacotron2, acfg: AudioConfig, tokens,
                           text_lengths=None, speaker_ids=None, *,
                           max_steps: Optional[int] = None,
                           gate_threshold: Optional[float] = None,
                           stop_mode: str = "any", gl_iters: int = 60,
                           vocoder: Optional[Vocoder] = None,
                           forced_stop_at: Optional[int] = None,
                           buckets: Tuple[int, ...] = VOCODE_BUCKETS,
                           device: Device = "cuda"
                           ) -> Tuple[torch.Tensor, np.ndarray]:
    """tokens (B, T_enc) -> (pcm16 (B, bucket*hop) int16 on the device,
    frame_ends np).

    The two-phase length-proportional pipeline: decode (mel stays on the
    device) -> fetch frame_ends (scalars) -> pick the smallest covering
    bucket -> bucket-sized vocode (``vocoder``, Griffin-Lim at ``gl_iters``
    where None) returning int16 PCM.  Sample b's audio is valid up to
    ``frame_ends[b] * hop_length`` samples; divide by 32767 for float."""
    mel, _, frame_ends = decode_mel_fused(
        model, tokens, text_lengths, speaker_ids, max_steps=max_steps,
        gate_threshold=gate_threshold, stop_mode=stop_mode,
        forced_stop_at=forced_stop_at, device=device)
    ends_np, = _fetch(frame_ends)                          # tiny copy
    bucket = pick_bucket(max(int(ends_np.max()), 1), mel.shape[1], buckets)
    pcm = vocode_bucket_pcm16(vocoder or GriffinLim(acfg, gl_iters), mel,
                              frame_ends, acfg, bucket)
    return pcm, ends_np


# LJSpeech averages ~6.2 mel frames per input character (24 h of audio /
# ~1.2 M transcript characters at 86.13 frames/s); the default predictor
# pads that to 7/char + 40 frames so the gate rarely outruns the bucket.
FRAMES_PER_TOKEN = 7.0
FRAMES_MARGIN = 40


def estimate_frames(n_tokens: int, frames_per_token: float = FRAMES_PER_TOKEN,
                    margin: int = FRAMES_MARGIN) -> int:
    """Predicted mel-frame count for an ``n_tokens``-character input —
    the bucket picker of the length-proportional path."""
    return int(np.ceil(frames_per_token * n_tokens + margin))


def synthesize_pcm_proportional(model: Tacotron2, acfg: AudioConfig, tokens,
                                text_lengths=None, speaker_ids=None, *,
                                expected_frames: Optional[int] = None,
                                max_steps: Optional[int] = None,
                                gate_threshold: Optional[float] = None,
                                stop_mode: str = "any", gl_iters: int = 60,
                                vocoder: Optional[Vocoder] = None,
                                forced_stop_at: Optional[int] = None,
                                buckets: Tuple[int, ...] = VOCODE_BUCKETS,
                                frames_per_token: float = FRAMES_PER_TOKEN,
                                frames_margin: int = FRAMES_MARGIN,
                                return_mel: bool = False,
                                device: Device = "cuda"):
    """tokens (B, T_enc) -> (pcm16 (B, bucket*hop) int16 np, frame_ends np,
    bucket) — the LENGTH-PROPORTIONAL synthesis path.

    Picks the mel bucket from the text length BEFORE any device work (or
    from ``expected_frames`` when the caller knows better), then decodes
    capped at the bucket, masks past the gate stop and vocodes the bucket
    (``vocoder``, Griffin-Lim at ``gl_iters`` where None) to int16 PCM
    with no host synchronisation, and fetches PCM + frame_ends with
    non-blocking copies and one synchronise.  If the gate never fired
    inside the bucket, escalates once to the full ``max_steps``.  Sample
    b's audio is valid up to ``frame_ends[b] * hop_length`` samples;
    divide by 32767 for float.

    ``return_mel=True`` appends the (B, bucket, n_mels) post-gate-masked
    postnet mel as a fourth element, fetched in the same round (for
    diagnostics — the reference prints mel stats before vocoding,
    reference: inference.py:98-111)."""
    vocoder = vocoder or GriffinLim(acfg, gl_iters)
    limit = (model.cfg.max_decoder_steps if max_steps is None else max_steps)
    if expected_frames is None:
        if text_lengths is not None:
            n_tok = int(np.max(np.asarray(text_lengths)))
        else:
            n_tok = int(np.asarray(tokens).shape[1])
        expected_frames = estimate_frames(n_tok, frames_per_token,
                                          frames_margin)
    bucket = pick_bucket(expected_frames, limit, buckets)
    while True:
        mel, _, ends = decode_mel_fused(
            model, tokens, text_lengths, speaker_ids, max_steps=bucket,
            gate_threshold=gate_threshold, stop_mode=stop_mode,
            forced_stop_at=forced_stop_at, device=device)
        mel = _mask_and_slice(mel, ends, bucket, acfg.mel_eps)
        pcm = _to_pcm16(_vocode(vocoder, mel))
        fetched = _fetch(pcm, ends, *([mel] if return_mel else []))
        pcm_np, ends_np = fetched[:2]
        if bucket >= limit or int(ends_np.max()) < bucket:
            if return_mel:
                return pcm_np, ends_np, bucket, fetched[2]
            return pcm_np, ends_np, bucket
        # Gate still open at the bucket cap: the prediction was short.
        # One escalation to the full length settles it (a gate that fired
        # EXACTLY at the cap reruns too — indistinguishable from a miss,
        # and the rerun returns the identical audio).
        bucket = limit


def synthesize_wav(model: Tacotron2, texts: Sequence[str],
                   cfg: Optional[Config] = None,
                   max_steps: Optional[int] = None, gl_iters: int = 60,
                   speaker_id=None, hifigan_params=None,
                   device: Device = "cuda",
                   waveglow: Optional[WaveGlow] = None,
                   vocoder: Optional[Vocoder] = None) -> List[np.ndarray]:
    """Host convenience: texts -> list of trimmed float32 waveforms via
    :func:`synthesize_wav_fused` on the cut route (:func:`trim_to_bucket`):
    the postnet and the vocoder run over the bucket that ends just past
    the batch's last stop.  The vocoder is ``vocoder``, any callable of
    the seam ``infer/vocode.py`` (``GriffinLim``, ``HiFiGAN``,
    ``WaveGlow``, ``BigVGAN``), where given; ``hifigan_params`` and
    ``waveglow`` are aliases for it; Griffin-Lim at ``gl_iters`` where
    none is given.  Griffin-Lim draws its initial phase for the cut
    bucket, so where the route cuts its audio differs from the whole
    buffer's (and the JAX package's)."""
    cfg = cfg or Config()
    given = [v for v in (vocoder, hifigan_params, waveglow) if v is not None]
    if len(given) > 1:
        raise ValueError("give one of vocoder=, hifigan_params=, waveglow=")
    vocoder = given[0] if given else GriffinLim(cfg.audio, gl_iters)
    with span("synthesize_wav", root=True):
        with span("frontend"):
            seqs = [text_to_sequence(t) or [0] for t in texts]
            tokens, lengths = pad_sequences(seqs, pad_multiple=16)
        speaker_ids = make_speaker_ids(speaker_id, len(texts), model.cfg)
        stop_mode = "all" if len(texts) > 1 else "any"
        wav, _, _, ends = synthesize_wav_fused(
            model, vocoder, cfg.audio, tokens, lengths, speaker_ids,
            max_steps=max_steps, stop_mode=stop_mode, trim=trim_to_bucket,
            device=device)
        wav_np, ends_np = _fetch(wav, ends)
        return [wav_np[b, : int(ends_np[b]) * cfg.audio.hop_length]
                for b in range(len(texts))]
