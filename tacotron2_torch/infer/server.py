"""Minimal production TTS HTTP server.

Counterpart of ``tacotron2_tpu/infer/server.py``: loads the model once on
the card, builds its kernels and fills their caches before the first
request, and exposes

    POST /synthesize   {"text": "...", "vocoder": "griffinlim"|"hifigan",
                        "speaker_id": 0}
        -> audio/wav bytes (22.05 kHz 16-bit WAV)
    POST /synthesize_streaming  {"text": "...", "vocoder": ...,
                                 "chunk_frames": 64}
        -> raw 16-bit PCM (audio/L16), streamed until the connection closes
    GET  /healthz      -> {"status": "ok", ...}

Requests synthesize through the same pipeline as the CLI
(``synthesize_mels`` + Griffin-Lim / HiFi-GAN): the encoder convs and the
postnet by ``ops/convbn_kernel.py``, the decode by
``ops/decoder_megakernel.py``, each step of a stream by the attention tail
of ``ops/attention_kernel.py``.

Two service variants (``serve()`` always runs the batching one, so the
backpressure bound and request timeout apply in every mode --
``max_batch=1`` just serializes requests through the worker):

  * :class:`TTSService` -- one request per device call (the base
    synthesis service; also usable directly as a library).
  * :class:`BatchingTTSService` -- dynamic micro-batching: concurrent
    requests are coalesced into ONE batched decode by a single device
    worker.  With ``batch_window_ms=0`` (default) the worker simply drains
    whatever queued while the device was busy -- adaptive batching with
    ZERO added latency when idle; a positive window waits that long after
    the first request to let stragglers join (deeper batches, bounded
    extra latency).

One thread at a time uses the device: whoever holds the service's
``_lock``, the batch worker for a batch and a stream for each of its
chunks.  The kernels' loaders and caches (built libraries, folded conv
weights, decode plans) are not safe under concurrent first use, so the
constructor builds and fills them.
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union

import numpy as np
import torch

from ..config import Config
from ..models.tacotron2 import cast_params_bf16, make_speaker_ids
from ..utils.device import resolve_device
from .synthesize import load_model, synthesize_mels
from .vocode import (GriffinLim, load_vocoder, vocode_array, vocode_mel,
                     vocode_mels)

# the CUDA sources of the serving path's kernels (ops/_build.py)
SERVING_KERNELS = ("decoder_infer", "conv_bn_act", "attention_tail")

# Mel frames of left context re-vocoded with each streamed GRIFFIN-LIM
# chunk (then trimmed from the audio): covers the STFT window (4 frames
# at n_fft=1024 / hop=256) with margin to suppress chunk-boundary
# clicks.  Griffin-Lim is inherently chunk-local (its phase iteration
# only ever sees one chunk), so its streamed output is an approximation
# of the one-shot vocode; the HiFi-GAN streaming path is EXACT instead
# (receptive-field hold-back, see ``_stream_pcm_hifigan``).
_STREAM_CTX_GL = 8


def _pcm16(audio: np.ndarray) -> bytes:
    """Float audio -> little-endian 16-bit PCM bytes."""
    pcm = np.clip(audio, -1.0, 1.0)
    return (pcm * 32767.0).astype("<i2").tobytes()


def _wav_bytes(audio: np.ndarray, sr: int) -> bytes:
    """Encode float audio as 16-bit PCM WAV bytes."""
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(_pcm16(audio))
    return buf.getvalue()


class TTSService:
    """Model-owning synthesis service (thread-safe; device access
    serialized).  The model serves on ``device`` (the card unless the
    caller asks for the CPU), in fp32, or in bf16 with ``bf16``."""

    def __init__(self, checkpoint_path: str, cfg: Optional[Config] = None,
                 griffinlim_iters: int = 60, bf16: bool = False,
                 vocoder_chunk_frames: Optional[int] = None,
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = cfg or Config()
        self.device = resolve_device(device)
        self.model = load_model(checkpoint_path, self.cfg, self.device)
        if bf16:
            self.model = cast_params_bf16(self.model)
        self.griffinlim_iters = griffinlim_iters
        self._griffinlim = GriffinLim(self.cfg.audio, griffinlim_iters)
        self._bf16 = bf16
        self._vocoder_chunk_frames = vocoder_chunk_frames
        self._lock = threading.Lock()
        self._hifigan_lock = threading.Lock()
        self._hifigan_vocoder = None
        self._requests = 0
        if self.device.type == "cuda":
            self._warm_up()
        self._announce_decode_program(b=1)

    def _warm_up(self) -> None:
        """Build the serving kernels (one nvcc a source, all together),
        then run one short request and one short stream, so that every
        library, fold and decode plan a request needs exists before two
        request threads could race to make it."""
        from ..ops import _build
        from .streaming import stream_mels
        _build.build(SERVING_KERNELS)
        synthesize_mels(self.model, ["Warm up."], max_steps=2,
                        device=self.device)
        for _ in stream_mels(self.model, "Warm up.", chunk_frames=2,
                             max_steps=2, apply_postnet=True,
                             device=self.device):
            pass
        torch.cuda.synchronize(self.device)

    def _announce_decode_program(self, b: int) -> None:
        """One startup line naming the decode that runs at batch ``b``: the
        decode kernel where the config asks for it on the card, the step
        loop otherwise."""
        on_card = self.device.type == "cuda"
        prog = ("decode kernel (decoder_infer_mega)"
                if on_card and self.model.cfg.decoder_megakernel else
                "step loop with the attention_tail kernel" if on_card else
                "step loop")
        print(f"[serve] decode at batch {b} on {self.device} "
              f"({'bf16' if self._bf16 else 'fp32'} weights): {prog}",
              flush=True)

    def _hifigan(self):
        with self._hifigan_lock:
            if self._hifigan_vocoder is None:
                # --bf16 applies to the generator too (halved
                # activations); chunk_frames bounds its peak activations
                # for large-batch / long-utterance configurations (exact
                # chunked evaluation).
                self._hifigan_vocoder = load_vocoder(
                    "hifigan", bf16=self._bf16,
                    chunk_frames=self._vocoder_chunk_frames,
                    device=self.device)
            return self._hifigan_vocoder

    def _vocoder(self, name: str):
        """The vocoder a request names: HiFi-GAN for "hifigan" (loaded on
        first use), Griffin-Lim for any other name."""
        return self._hifigan() if name == "hifigan" else self._griffinlim

    def _vocode_to_wav(self, mel, vocoder: str) -> bytes:
        audio = vocode_mel(mel, self.cfg.audio, self._vocoder(vocoder),
                           device=self.device)
        return _wav_bytes(audio, self.cfg.audio.sampling_rate)

    def stream_pcm(self, text: str, vocoder: str = "griffinlim",
                   speaker_id=None, chunk_frames: int = 64):
        """Generator of 16-bit PCM byte chunks, yielded while the decoder
        is still running (infer/streaming.py) -- time-to-first-audio is one
        encoder pass + ``chunk_frames`` decode steps instead of the whole
        utterance.

        Streams POSTNET-REFINED mels (``apply_postnet=True``: same
        spectral quality as /synthesize, at a fixed 10-frame ~116 ms
        lookahead delay).  Vocoding per chunk:

        * ``hifigan`` -- EXACT: the generator's receptive radius is
          ``RECEPTIVE_FRAMES`` (16) mel frames (models/hifigan.py), so
          the stream holds back the last 16 frames of each chunk and
          vocodes every emitted frame with >= 16 real frames of context
          on both sides (or the true utterance edge).  With an fp32
          generator the concatenated stream equals the one-shot
          ``hifigan_apply`` of the full mel (within 1 LSB of PCM16), at a
          further 16-frame (~186 ms) lookahead delay.  With a bf16
          generator (``--bf16``) the windows round differently from the
          one-shot call: the stream differs from it by a few tens of LSB.
        * ``griffinlim`` -- approximate: each chunk is vocoded with
          ``_STREAM_CTX_GL`` frames of left context (trimmed from the
          audio); GL's phase iteration is chunk-local by nature, so the
          streamed audio deviates from one-shot GL.

        The device lock is taken per chunk, so a long stream interleaves
        with other requests (including a BatchingTTSService's batch
        worker) instead of monopolizing the card.
        """
        # validate eagerly so errors raise before any bytes are sent
        make_speaker_ids(speaker_id, 1, self.model.cfg)
        if vocoder == "hifigan":
            self._hifigan()   # raises FileNotFoundError before streaming
        with self._lock:
            self._requests += 1
        if vocoder == "hifigan":
            return self._stream_pcm_hifigan(text, speaker_id, chunk_frames)
        return self._stream_pcm_griffinlim(text, speaker_id, chunk_frames)

    def _mel_stream(self, text: str, speaker_id, chunk_frames: int):
        from .streaming import stream_mels
        return stream_mels(self.model, text, chunk_frames=chunk_frames,
                           speaker_id=speaker_id, apply_postnet=True,
                           device=self.device)

    def _stream_pcm_griffinlim(self, text: str, speaker_id,
                               chunk_frames: int):
        ctx: Optional[np.ndarray] = None
        mel_gen = self._mel_stream(text, speaker_id, chunk_frames)
        hop = self.cfg.audio.hop_length
        while True:
            with self._lock:
                try:
                    chunk = next(mel_gen)
                except StopIteration:
                    return
                mel = (chunk if ctx is None
                       else np.concatenate([ctx, chunk], axis=0))
                audio = vocode_mel(mel, self.cfg.audio, self._griffinlim,
                                   device=self.device)
                if ctx is not None:
                    audio = audio[ctx.shape[0] * hop:]
                ctx = mel[-_STREAM_CTX_GL:]
            yield _pcm16(audio)

    def _stream_pcm_hifigan(self, text: str, speaker_id, chunk_frames: int):
        """Receptive-field-exact streamed HiFi-GAN vocoding.

        Same hold-back scheme as the postnet stream
        (infer/streaming.py::_refine_stream): emit a frame's audio only
        once ``r = RECEPTIVE_FRAMES`` real frames exist on its right (or
        the stream ended -- the true edge, matching the one-shot conv
        zero-padding), vocoding a window with ``r`` frames of emitted
        left context.  Mid-stream windows are right-padded to one shape
        (the emitted frames' receptive cones never reach the padding); the
        flush window runs at its exact length.
        """
        from ..models.hifigan import RECEPTIVE_FRAMES, TOTAL_UPSAMPLE

        hop = self.cfg.audio.hop_length
        if TOTAL_UPSAMPLE != hop:   # pragma: no cover - config invariant
            raise RuntimeError(
                f"HiFi-GAN upsampling {TOTAL_UPSAMPLE} != hop {hop}")
        voc = self._hifigan()
        n_mels = self.model.cfg.n_mels
        log_eps = float(np.log(self.cfg.audio.mel_eps))
        r = RECEPTIVE_FRAMES
        bufmax = 2 * r + chunk_frames
        left = np.zeros((0, n_mels), np.float32)     # emitted context
        pending = np.zeros((0, n_mels), np.float32)  # hold-back
        mel_gen = self._mel_stream(text, speaker_id, chunk_frames)
        while True:
            piece = flush = None
            with self._lock:
                try:
                    chunk = np.asarray(next(mel_gen), np.float32)
                except StopIteration:
                    if not pending.shape[0]:
                        return
                    # True end of stream: vocode the tail at its EXACT
                    # length -- the generator's conv zero-padding at the
                    # right edge is then the same one the one-shot call
                    # sees at the utterance end.
                    buf = np.concatenate([left, pending])
                    audio = vocode_array(voc, buf[None], self.device)[0]
                    flush = audio[left.shape[0] * hop:]
                else:
                    body = np.concatenate([pending, chunk])
                    emit = body.shape[0] - r
                    if emit > 0:
                        buf = np.concatenate([left, body])
                        lo = buf.shape[0] - body.shape[0]
                        if buf.shape[0] < bufmax:
                            buf = np.concatenate([buf, np.full(
                                (bufmax - buf.shape[0], n_mels), log_eps,
                                np.float32)])
                        audio = vocode_array(voc, buf[None],
                                             self.device)[0]
                        piece = audio[lo * hop:(lo + emit) * hop]
                        left = np.concatenate([left, body[:emit]])[-r:]
                        pending = body[emit:]
                    else:
                        pending = body
            if flush is not None:
                yield _pcm16(flush)
                return
            if piece is not None:
                yield _pcm16(piece)

    def synthesize(self, text: str, vocoder: str = "griffinlim",
                   speaker_id=None) -> bytes:
        with self._lock:
            self._requests += 1
            # decode, then vocode the gate-trimmed mel padded to a
            # 128-frame bucket: device time stays proportional to the
            # utterance (the fused path's vocoder would run over the whole
            # max_decoder_steps buffer)
            mels, _ = synthesize_mels(self.model, [text],
                                      speaker_id=speaker_id,
                                      device=self.device)
            return self._vocode_to_wav(mels[0], vocoder)

    @property
    def request_count(self) -> int:
        return self._requests

    @property
    def stats(self) -> dict:
        return {}


class ServiceOverloadedError(RuntimeError):
    """Batching queue is full: the request is shed (HTTP 503 +
    ``Retry-After``) instead of queueing unboundedly."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class ServiceTimeoutError(RuntimeError):
    """Request exceeded the configured service timeout (HTTP 504)."""


class _Pending:
    __slots__ = ("text", "vocoder", "speaker_id", "done", "wav", "error",
                 "cancelled")

    def __init__(self, text, vocoder, speaker_id):
        self.text = text
        self.vocoder = vocoder
        self.speaker_id = speaker_id
        self.done = threading.Event()
        self.wav: Optional[bytes] = None
        self.error: Optional[Exception] = None
        # Set by the request thread on timeout; the worker drops the item
        # from its batch (best effort -- a race just wastes one decode).
        self.cancelled = False


class BatchingTTSService(TTSService):
    """TTS service with dynamic micro-batching (see module docstring).

    Request threads enqueue and block; ONE worker thread owns the device:
    it drains up to ``max_batch`` queued requests (waiting at most
    ``batch_window_ms`` after the first), decodes them as one padded
    batch with per-item gate stops and per-item speaker ids
    (``synthesize_mels`` stop_mode 'all'), then vocodes/encodes each item.
    Note batching couples tail latency: a batch runs until its longest
    item's gate fires.  A failing batch is retried per-item so one bad
    request cannot fail its batch-mates.
    """

    def __init__(self, checkpoint_path: str, cfg: Optional[Config] = None,
                 griffinlim_iters: int = 60, bf16: bool = False,
                 max_batch: int = 16, batch_window_ms: float = 0.0,
                 vocoder_chunk_frames: Optional[int] = None,
                 max_queue: int = 64,
                 request_timeout_s: Optional[float] = None,
                 device: Union[str, torch.device] = "cuda"):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if request_timeout_s is not None and request_timeout_s <= 0:
            raise ValueError(f"request_timeout_s must be > 0, got "
                             f"{request_timeout_s}")
        super().__init__(checkpoint_path, cfg, griffinlim_iters, bf16=bf16,
                         vocoder_chunk_frames=vocoder_chunk_frames,
                         device=device)
        self.max_batch = max_batch
        self.batch_window_s = batch_window_ms / 1000.0
        if max_batch > 1:   # full batches decode stop_mode="all"
            self._announce_decode_program(b=max_batch)
        # Backpressure: at most max_queue requests wait for the worker;
        # beyond that, synthesize() sheds with ServiceOverloadedError
        # (503) instead of growing the queue (and client timeouts)
        # without bound.  request_timeout_s bounds a request's total
        # time in the service (queue wait + decode); on expiry the
        # waiter gets ServiceTimeoutError (504) and the worker drops the
        # item from its next batch.
        self.max_queue = max_queue
        self.request_timeout_s = request_timeout_s
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._pending_count = 0      # guarded by _close_lock
        self._rejected = 0           # guarded by _close_lock
        self._timeouts = 0           # guarded by _close_lock
        self._batches = 0
        self._batched_requests = 0
        self._max_batch_observed = 0
        self._batch_retries = 0
        self._closed = False
        # Serializes the closed-check+enqueue against close(): no request
        # can slip into the queue after the shutdown sentinel.
        self._close_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="tts-batch-worker")
        self._worker.start()

    def synthesize(self, text: str, vocoder: str = "griffinlim",
                   speaker_id=None) -> bytes:
        # Validate per-request inputs HERE (the request thread) so a bad
        # request 400s on its own instead of poisoning a batch.
        make_speaker_ids(speaker_id, 1, self.model.cfg)
        item = _Pending(text, vocoder, speaker_id)
        with self._close_lock:
            if self._closed:
                raise RuntimeError("service is closed")
            if self._pending_count >= self.max_queue:
                self._rejected += 1
                # Hint: one worker drains up to max_batch per device
                # call; a full queue clears in ~queue/max_batch batches.
                # 1 s is a serviceable floor for this model.
                raise ServiceOverloadedError(
                    f"queue full ({self.max_queue} pending requests)",
                    retry_after_s=max(
                        1.0, self.max_queue / max(1, self.max_batch)))
            self._pending_count += 1
            self._queue.put(item)
        if not item.done.wait(self.request_timeout_s):
            item.cancelled = True
            with self._close_lock:
                self._timeouts += 1
            raise ServiceTimeoutError(
                f"request timed out after {self.request_timeout_s:g}s")
        if item.error is not None:
            raise item.error
        if item.wav is None:  # pragma: no cover - _process guarantees one
            raise RuntimeError("request completed without a result")
        return item.wav

    def close(self, join_timeout: float = 60.0) -> None:
        """Stop the worker (pending requests finish first)."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        self._worker.join(timeout=join_timeout)
        if self._worker.is_alive():
            # join() timed out mid-batch.  Leave the queue untouched: every
            # pending request precedes the sentinel (FIFO + close lock), so
            # the still-live worker will serve them all and then exit on
            # the sentinel -- draining here would 500 requests the worker
            # was about to complete.
            return
        # Worker is dead (normally it drains everything incl. the sentinel
        # before exiting, so this is a crash safety net): never strand a
        # waiter.
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:  # pragma: no cover
                item.error = RuntimeError("service is closed")
                item.done.set()

    def _collect(self, first: _Pending) -> list:
        batch = [first]
        deadline = time.monotonic() + self.batch_window_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            try:
                nxt = (self._queue.get_nowait() if timeout <= 0
                       else self._queue.get(timeout=timeout))
            except queue.Empty:
                break
            if nxt is None:            # close() sentinel: put it back so
                self._queue.put(None)  # the outer loop exits after this
                break                  # batch completes
            batch.append(nxt)
        return batch

    def _run(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:
                return
            batch = self._collect(first)
            with self._close_lock:
                self._pending_count -= len(batch)
            # Drop requests whose waiter already timed out (their result
            # would be discarded; skipping keeps the batch slot for live
            # requests).  done is still set for them -- harmless.
            live = [i for i in batch if not i.cancelled]
            for item in batch:
                if item.cancelled:      # keep the done-is-always-set
                    item.done.set()     # invariant for cancelled items too
            if not live:
                continue
            batch = live
            with self._lock:
                self._requests += len(batch)
                self._batches += 1
                if len(batch) > 1:
                    self._batched_requests += len(batch)
                self._max_batch_observed = max(self._max_batch_observed,
                                               len(batch))
                try:
                    self._process(batch)
                except Exception as e:  # pragma: no cover - backstop
                    for item in batch:
                        if item.error is None and item.wav is None:
                            item.error = e
            for item in batch:
                item.done.set()

    def _bucket_size(self, n: int) -> int:
        """Next power-of-two batch bucket (capped at max_batch): the batch
        sizes the decode runs at, as the JAX package compiles them."""
        b = 1
        while b < n:
            b *= 2
        return min(b, self.max_batch)

    def _process(self, batch: list) -> None:
        n = len(batch)
        b = self._bucket_size(n)
        # Pad to the bucket by repeating the last request (a real text, so
        # padding rows gate-stop normally under stop_mode='all'); results
        # beyond n are discarded.
        texts = [r.text for r in batch] + [batch[-1].text] * (b - n)
        spk = ([r.speaker_id for r in batch]
               + [batch[-1].speaker_id] * (b - n))
        try:
            mels, _ = synthesize_mels(self.model, texts, speaker_id=spk,
                                      device=self.device)
        except Exception as batch_err:
            # Batch-level failure: isolate it -- retry each item alone so
            # only the offending request errors.  LOG and COUNT it: a fault
            # in the batched decode would otherwise be served as B=1 decodes
            # with every request still answering 200.
            print(f"[serve] batched decode of {b} rows failed "
                  f"({type(batch_err).__name__}: {batch_err}); "
                  f"retrying {n} items individually")
            self._batch_retries += 1
            for item in batch:
                try:
                    item.wav = self._solo(item)
                except Exception as e:
                    item.error = e
            return
        # Vocode per REQUESTED vocoder, each group batched on the device:
        # mels sharing a length bucket go through one vocoder call
        # (vocode_mels) instead of one per request.
        by_voc: dict = {}
        for item, mel in zip(batch, mels[:n]):
            by_voc.setdefault(item.vocoder, []).append((item, mel))
        for voc, pairs in by_voc.items():
            try:
                wavs = vocode_mels([m for _, m in pairs], self.cfg.audio,
                                   self._vocoder(voc), device=self.device)
                for (item, _), w in zip(pairs, wavs):
                    item.wav = _wav_bytes(w, self.cfg.audio.sampling_rate)
            except Exception as group_err:
                # Group failure (e.g. missing HiFi-GAN checkpoint):
                # isolate per item so only the offending requests error.
                # LOG it -- a deterministic bug here would otherwise
                # silently disable the batched path on every batch.
                print(f"[serve] grouped {voc} vocode failed "
                      f"({type(group_err).__name__}: {group_err}); "
                      f"retrying {len(pairs)} items individually")
                for item, mel in pairs:
                    try:
                        item.wav = self._vocode_to_wav(mel, item.vocoder)
                    except Exception as e:
                        item.error = e

    def _solo(self, item: _Pending) -> bytes:
        mels, _ = synthesize_mels(self.model, [item.text],
                                  speaker_id=item.speaker_id,
                                  device=self.device)
        return self._vocode_to_wav(mels[0], item.vocoder)

    @property
    def stats(self) -> dict:
        with self._close_lock:
            depth, rejected, timeouts = (self._pending_count,
                                         self._rejected, self._timeouts)
        return {"batches": self._batches,
                "batched_requests": self._batched_requests,
                "max_batch_observed": self._max_batch_observed,
                "batch_retries": self._batch_retries,
                "max_batch": self.max_batch,
                "batch_window_ms": self.batch_window_s * 1000.0,
                "queue_depth": depth,
                "max_queue": self.max_queue,
                "rejected": rejected,
                "timeouts": timeouts,
                "request_timeout_s": self.request_timeout_s}


def make_handler(service: TTSService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet default access log
            pass

        def _json(self, code: int, obj, headers=None) -> None:
            body = json.dumps(obj).encode()
            try:
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError):
                # client hung up before the error/info could be written
                self.close_connection = True

        def do_GET(self):
            if self.path == "/healthz":
                info = {"status": "ok", "requests": service.request_count}
                info.update(service.stats)
                self._json(200, info)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/synthesize", "/synthesize_streaming"):
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
                text = payload.get("text", "")
                if not isinstance(text, str) or not text.strip():
                    self._json(400, {"error": "missing 'text'"})
                    return
                vocoder = payload.get("vocoder", "griffinlim")
                if vocoder not in ("griffinlim", "hifigan"):
                    self._json(400, {"error": f"unknown vocoder {vocoder!r}"})
                    return
                speaker_id = payload.get("speaker_id")
                if speaker_id is not None and (isinstance(speaker_id, bool)
                                               or not isinstance(speaker_id,
                                                                 int)):
                    self._json(400, {"error": "speaker_id must be an int"})
                    return
                if self.path == "/synthesize_streaming":
                    chunk_frames = payload.get("chunk_frames", 64)
                    if (isinstance(chunk_frames, bool)
                            or not isinstance(chunk_frames, int)
                            or chunk_frames < 2):
                        self._json(400, {"error": "chunk_frames must be an "
                                                  "int >= 2"})
                        return
                    pcm_gen = service.stream_pcm(
                        text, vocoder, speaker_id=speaker_id,
                        chunk_frames=chunk_frames)
                    sr = service.cfg.audio.sampling_rate
                    self.send_response(200)
                    # raw little-endian 16-bit mono PCM, streamed until
                    # connection close (no Content-Length by design)
                    self.send_header("Content-Type",
                                     f"audio/L16;rate={sr};channels=1")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    try:
                        for pcm in pcm_gen:
                            self.wfile.write(pcm)
                            self.wfile.flush()
                    except Exception:
                        # headers already sent: just drop the connection
                        # (client sees a truncated stream)
                        self.close_connection = True
                    return
                wav = service.synthesize(text, vocoder,
                                         speaker_id=speaker_id)
            except json.JSONDecodeError:
                self._json(400, {"error": "invalid JSON body"})
                return
            except ValueError as e:  # e.g. speaker_id out of range
                self._json(400, {"error": str(e)})
                return
            except ServiceOverloadedError as e:  # queue full: shed load
                self._json(503, {"error": str(e)},
                           headers={"Retry-After":
                                    str(int(round(e.retry_after_s)))})
                return
            except ServiceTimeoutError as e:
                self._json(504, {"error": str(e)})
                return
            except FileNotFoundError as e:  # hifigan checkpoint missing
                self._json(503, {"error": str(e)})
                return
            except (BrokenPipeError, ConnectionResetError):
                # client hung up while the streaming headers were being
                # written (the synthesize path writes nothing in the try)
                self.close_connection = True
                return
            except Exception as e:  # pragma: no cover
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                self.send_response(200)
                self.send_header("Content-Type", "audio/wav")
                self.send_header("Content-Length", str(len(wav)))
                self.end_headers()
                self.wfile.write(wav)
            except (BrokenPipeError, ConnectionResetError):
                # client hung up before/while the response was written
                self.close_connection = True

    return Handler


def serve(checkpoint_path: str, host: str = "127.0.0.1", port: int = 8080,
          cfg: Optional[Config] = None,
          griffinlim_iters: int = 60,
          bf16: bool = False,
          max_batch: int = 16,
          batch_window_ms: float = 0.0,
          vocoder_chunk_frames: Optional[int] = None,
          max_queue: int = 64,
          request_timeout_s: Optional[float] = None,
          device: Union[str, torch.device] = "cuda"
          ) -> ThreadingHTTPServer:
    """Start the TTS server (blocking).  Returns the server on shutdown.

    Always serves through :class:`BatchingTTSService` so the
    backpressure bound (``max_queue`` -> 503 + Retry-After on overflow)
    and ``request_timeout_s`` (expiry -> 504) are honored in every mode;
    ``max_batch=1`` simply serializes requests through the worker
    without coalescing.  ``vocoder_chunk_frames`` bounds the HiFi-GAN
    generator's peak activation memory (exact chunked evaluation) for
    large-batch/long-utterance configurations.  The model runs on
    ``device``, the card unless the caller asks for the CPU.
    """
    service = BatchingTTSService(
        checkpoint_path, cfg, griffinlim_iters, bf16=bf16,
        max_batch=max_batch, batch_window_ms=batch_window_ms,
        vocoder_chunk_frames=vocoder_chunk_frames,
        max_queue=max_queue, request_timeout_s=request_timeout_s,
        device=device)
    mode = ("per-request (serialized)" if max_batch == 1 else
            f"micro-batching <= {max_batch}, "
            f"window {batch_window_ms:g} ms")
    mode += f", queue <= {max_queue}"
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    print(f"TTS server listening on http://{host}:{httpd.server_address[1]} "
          f"(POST /synthesize, POST /synthesize_streaming, GET /healthz; "
          f"{mode})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
        httpd.server_close()
    return httpd
