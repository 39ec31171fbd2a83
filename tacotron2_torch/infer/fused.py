"""Tokens -> waveform without leaving the device.

Counterpart of ``tacotron2_tpu/infer/fused.py``.  There each function is
one compiled program; here each is one eager function on device tensors
with no host synchronisation inside it: encoder + decode kernel + postnet
+ vocoder (mel inversion + Griffin-Lim, or the HiFi-GAN generator of
``models/hifigan.py`` where ``hifigan_params`` is given) are queued on the
current stream back to back, and the host waits once, when it fetches the
result.

Frames beyond the gate stop are masked to the log floor before vocoding,
so the (fixed-shape) vocoder sees silence there; the caller trims the
returned waveform at ``frame_ends * hop``.

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

``hifigan_params`` is the generator (``models/hifigan.py::HiFiGAN``) on
the model's device, in place of the JAX package's params pytree.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import AudioConfig, Config
from ..dsp.griffinlim import griffin_lim, mel_to_linear
from ..models.hifigan import HiFiGAN, hifigan_apply, hifigan_apply_chunked
from ..models.tacotron2 import Tacotron2, make_speaker_ids, tacotron2_infer
from ..text import pad_sequences, text_to_sequence
from ..utils.profiling import count, span

Device = Union[str, torch.device]


def _griffin_lim_wav(mel: torch.Tensor, acfg: AudioConfig,
                     gl_iters: int,
                     init_phase: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """(B, S, n_mels) masked log-power mel -> (B, S * hop) waveform."""
    mel_lin = torch.exp(mel.transpose(1, 2))               # (B, n_mels, S)
    linear = mel_to_linear(mel_lin, sr=acfg.sampling_rate, n_fft=acfg.n_fft,
                           n_mels=acfg.n_mels, fmin=acfg.fmin,
                           fmax=acfg.fmax)
    return griffin_lim(linear, n_fft=acfg.n_fft, hop_length=acfg.hop_length,
                       win_length=acfg.win_length, n_iter=gl_iters,
                       length=mel.shape[1] * acfg.hop_length,
                       init_phase=init_phase)


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


def synthesize_wav_fused(model: Tacotron2, acfg: AudioConfig, tokens,
                         text_lengths=None, speaker_ids=None, *,
                         max_steps: Optional[int] = None,
                         gate_threshold: Optional[float] = None,
                         stop_mode: str = "any", gl_iters: int = 60,
                         forced_stop_at: Optional[int] = None,
                         init_phase: Optional[torch.Tensor] = None,
                         device: Device = "cuda"
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens (B, T_enc) -> (wav (B, S*hop), n_frames, frame_ends), all on
    the device.

    Waveforms are Griffin-Lim reconstructions of the postnet mels; sample
    b's audio is valid up to ``frame_ends[b] * hop_length``.
    ``forced_stop_at`` force-fires the gate at that frame — see
    models/decoder.py::decoder_infer.  ``init_phase`` (B, n_fft // 2 + 1,
    S) is Griffin-Lim's initial phase (default: drawn from seed 0 for
    this batch).
    """
    mel, n_frames, frame_ends = decode_mel_fused(
        model, tokens, text_lengths, speaker_ids, max_steps=max_steps,
        gate_threshold=gate_threshold, stop_mode=stop_mode,
        forced_stop_at=forced_stop_at, device=device)     # (B, S, n_mels)
    mel = _mask_and_slice(mel, frame_ends, mel.shape[1], acfg.mel_eps)
    with span("vocoder"):
        count("vocoder.frames", mel.shape[0] * mel.shape[1])
        wav = _griffin_lim_wav(mel, acfg, gl_iters, init_phase)
    return wav, n_frames, frame_ends


def synthesize_wav_fused_hifigan(model: Tacotron2, hifigan_params: HiFiGAN,
                                 acfg: AudioConfig, tokens,
                                 text_lengths=None, speaker_ids=None, *,
                                 max_steps: Optional[int] = None,
                                 gate_threshold: Optional[float] = None,
                                 stop_mode: str = "any",
                                 vocoder_chunk_frames: Optional[int] = None,
                                 device: Device = "cuda"
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor, torch.Tensor]:
    """tokens (B, T_enc) -> (wav (B, S*hop), mel_postnet (B, S, n_mels),
    n_frames, frame_ends), all on the device, with the neural vocoder
    queued behind the decode.

    The reference's primary synthesis path is Tacotron 2 -> HiFi-GAN
    (reference: inference.py:40-54,71-74).  Frames past the gate stop are
    masked to the log-mel floor, so the vocoder renders silence there;
    trim returned audio at ``frame_ends[b] * hop_length`` (the generator's
    total upsampling 256 == hop_length).

    ``vocoder_chunk_frames`` bounds the generator's peak activation memory
    by vocoding the mel in exact receptive-field-overlapped windows of that
    many frames (``models/hifigan.py::hifigan_apply_chunked``).
    """
    mel, n_frames, frame_ends = decode_mel_fused(
        model, tokens, text_lengths, speaker_ids, max_steps=max_steps,
        gate_threshold=gate_threshold, stop_mode=stop_mode, device=device)
    mel = _mask_and_slice(mel, frame_ends, mel.shape[1], acfg.mel_eps)
    mel_ct = mel.transpose(1, 2)                           # (B, n_mels, S)
    with span("vocoder"):
        count("vocoder.frames", mel.shape[0] * mel.shape[1])
        if vocoder_chunk_frames:
            wav = hifigan_apply_chunked(hifigan_params, mel_ct,
                                        chunk=vocoder_chunk_frames)
        else:
            wav = hifigan_apply(hifigan_params, mel_ct)
    return wav, mel, n_frames, frame_ends


# Mel-length buckets for the length-proportional path: the 128-frame grid
# the modular vocoder already uses (infer/vocode.py), densified toward
# short utterances where proportionality matters most.
VOCODE_BUCKETS = (128, 256, 384, 512, 640, 768, 896, 1000)


def decode_mel_fused(model: Tacotron2, tokens, text_lengths=None,
                     speaker_ids=None, *, max_steps: Optional[int] = None,
                     gate_threshold: Optional[float] = None,
                     stop_mode: str = "any",
                     forced_stop_at: Optional[int] = None,
                     device: Device = "cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens (B, T_enc) -> (mel_postnet (B, S, n_mels), n_frames,
    frame_ends), all on the device.

    Phase 1 of the bucketed pipeline: callers fetch only ``frame_ends``
    (4 bytes/item) and hand the mel straight to :func:`vocode_bucket_pcm16`
    — the (B, S, n_mels) buffer never crosses to the host."""
    out, n_frames, frame_ends = tacotron2_infer(
        model, tokens, max_steps=max_steps, gate_threshold=gate_threshold,
        text_lengths=text_lengths, speaker_ids=speaker_ids,
        stop_mode=stop_mode, forced_stop_at=forced_stop_at, device=device)
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


def vocode_bucket_pcm16(mel: torch.Tensor, frame_ends: torch.Tensor,
                        acfg: AudioConfig, bucket: int,
                        gl_iters: int = 60) -> torch.Tensor:
    """Device-resident mel (B, S, n_mels) -> int16 PCM (B, bucket*hop)
    via Griffin-Lim over just the ``bucket``-frame prefix.

    Phase 2 of the bucketed pipeline: compute AND output transfer
    proportional to the bucket — a 300-frame utterance runs 384 frames,
    not the 1000-frame tail."""
    mel = _mask_and_slice(mel, frame_ends, bucket, acfg.mel_eps)
    return _to_pcm16(_griffin_lim_wav(mel, acfg, gl_iters))


def vocode_bucket_hifigan_pcm16(hifigan_params: HiFiGAN, mel: torch.Tensor,
                                frame_ends: torch.Tensor, acfg: AudioConfig,
                                bucket: int) -> torch.Tensor:
    """HiFi-GAN twin of :func:`vocode_bucket_pcm16` (the reference's
    primary vocoder, reference: inference.py:40-54)."""
    mel = _mask_and_slice(mel, frame_ends, bucket, acfg.mel_eps)
    return _to_pcm16(hifigan_apply(hifigan_params, mel.transpose(1, 2)))


def pick_bucket(n_frames: int, max_steps: int,
                buckets: Tuple[int, ...] = VOCODE_BUCKETS) -> int:
    """Smallest bucket covering ``n_frames``, capped at ``max_steps``."""
    for b in buckets:
        if b >= n_frames:
            return min(b, max_steps)
    return max_steps


def synthesize_wav_buckets(model: Tacotron2, acfg: AudioConfig, tokens,
                           text_lengths=None, speaker_ids=None, *,
                           max_steps: Optional[int] = None,
                           gate_threshold: Optional[float] = None,
                           stop_mode: str = "any", gl_iters: int = 60,
                           hifigan_params=None,
                           forced_stop_at: Optional[int] = None,
                           buckets: Tuple[int, ...] = VOCODE_BUCKETS,
                           device: Device = "cuda"
                           ) -> Tuple[torch.Tensor, np.ndarray]:
    """tokens (B, T_enc) -> (pcm16 (B, bucket*hop) int16 on the device,
    frame_ends np).

    The two-phase length-proportional pipeline: decode (mel stays on the
    device) -> fetch frame_ends (scalars) -> pick the smallest covering
    bucket -> bucket-sized vocode returning int16 PCM.  Sample b's audio
    is valid up to ``frame_ends[b] * hop_length`` samples; divide by
    32767 for float."""
    mel, _, frame_ends = decode_mel_fused(
        model, tokens, text_lengths, speaker_ids, max_steps=max_steps,
        gate_threshold=gate_threshold, stop_mode=stop_mode,
        forced_stop_at=forced_stop_at, device=device)
    ends_np, = _fetch(frame_ends)                          # tiny copy
    bucket = pick_bucket(max(int(ends_np.max()), 1), mel.shape[1], buckets)
    if hifigan_params is not None:
        pcm = vocode_bucket_hifigan_pcm16(hifigan_params, mel, frame_ends,
                                          acfg, bucket)
    else:
        pcm = vocode_bucket_pcm16(mel, frame_ends, acfg, bucket,
                                  gl_iters=gl_iters)
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


def _synthesize_pcm_bucket(model: Tacotron2,
                           hifigan_params: Optional[HiFiGAN],
                           acfg: AudioConfig, tokens, text_lengths,
                           speaker_ids, *, bucket: int,
                           gate_threshold: Optional[float], stop_mode: str,
                           gl_iters: int, forced_stop_at: Optional[int],
                           device: Device
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Decode capped at ``bucket`` -> mask past the gate stop ->
    bucket-length vocode (HiFi-GAN where ``hifigan_params`` is given,
    Griffin-Lim otherwise) -> int16 PCM, with no host synchronisation.
    Returns (pcm, frame_ends, masked mel), all on the device."""
    mel, _, frame_ends = decode_mel_fused(
        model, tokens, text_lengths, speaker_ids, max_steps=bucket,
        gate_threshold=gate_threshold, stop_mode=stop_mode,
        forced_stop_at=forced_stop_at, device=device)
    mel = _mask_and_slice(mel, frame_ends, bucket, acfg.mel_eps)
    if hifigan_params is not None:
        wav = hifigan_apply(hifigan_params, mel.transpose(1, 2))
    else:
        wav = _griffin_lim_wav(mel, acfg, gl_iters)
    return _to_pcm16(wav), frame_ends, mel


def synthesize_pcm_proportional(model: Tacotron2, acfg: AudioConfig, tokens,
                                text_lengths=None, speaker_ids=None, *,
                                expected_frames: Optional[int] = None,
                                max_steps: Optional[int] = None,
                                gate_threshold: Optional[float] = None,
                                stop_mode: str = "any", gl_iters: int = 60,
                                hifigan_params=None,
                                forced_stop_at: Optional[int] = None,
                                buckets: Tuple[int, ...] = VOCODE_BUCKETS,
                                frames_per_token: float = FRAMES_PER_TOKEN,
                                frames_margin: int = FRAMES_MARGIN,
                                return_mel: bool = False,
                                device: Device = "cuda"):
    """tokens (B, T_enc) -> (pcm16 (B, bucket*hop) int16 np, frame_ends np,
    bucket) — the LENGTH-PROPORTIONAL synthesis path.

    Picks the mel bucket from the text length BEFORE any device work (or
    from ``expected_frames`` when the caller knows better), runs the
    bucket-sized pipeline, and fetches PCM + frame_ends with non-blocking
    copies and one synchronise.  If the gate never fired inside the
    bucket, escalates once to the full ``max_steps``.  Sample b's audio is
    valid up to ``frame_ends[b] * hop_length`` samples; divide by 32767
    for float.

    ``return_mel=True`` appends the (B, bucket, n_mels) post-gate-masked
    postnet mel as a fourth element, fetched in the same round (for
    diagnostics — the reference prints mel stats before vocoding,
    reference: inference.py:98-111)."""
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
        pcm, ends, mel = _synthesize_pcm_bucket(
            model, hifigan_params, acfg, tokens, text_lengths, speaker_ids,
            bucket=bucket,
            gate_threshold=gate_threshold, stop_mode=stop_mode,
            gl_iters=gl_iters, forced_stop_at=forced_stop_at, device=device)
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
                   device: Device = "cuda") -> List[np.ndarray]:
    """Host convenience: texts -> list of trimmed float32 waveforms via
    :func:`synthesize_wav_fused_hifigan` when ``hifigan_params`` is given,
    :func:`synthesize_wav_fused` (Griffin-Lim) otherwise."""
    cfg = cfg or Config()
    with span("synthesize_wav", root=True):
        with span("frontend"):
            seqs = [text_to_sequence(t) or [0] for t in texts]
            tokens, lengths = pad_sequences(seqs, pad_multiple=16)
        speaker_ids = make_speaker_ids(speaker_id, len(texts), model.cfg)
        stop_mode = "all" if len(texts) > 1 else "any"
        if hifigan_params is not None:
            wav, _, _, ends = synthesize_wav_fused_hifigan(
                model, hifigan_params, cfg.audio, tokens, lengths,
                speaker_ids, max_steps=max_steps, stop_mode=stop_mode,
                device=device)
        else:
            wav, _, ends = synthesize_wav_fused(
                model, cfg.audio, tokens, lengths, speaker_ids,
                max_steps=max_steps, gl_iters=gl_iters, stop_mode=stop_mode,
                device=device)
        wav_np, ends_np = _fetch(wav, ends)
        return [wav_np[b, : int(ends_np[b]) * cfg.audio.hop_length]
                for b in range(len(texts))]
