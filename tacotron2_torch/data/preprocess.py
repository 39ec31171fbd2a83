"""Offline corpus preprocessing: audio -> cached log-mels, text -> token IDs.

Counterpart of ``tacotron2_tpu/data/preprocess.py``.  The pass is a
pipeline over three overlapping resources:

  * **decode** -- the C++ thread-pool WAV loader (``native/wavio.cc``,
    bound by ``data/native_loader.py``) reads and reflect-pads whole
    batches outside the GIL,
  * **device** -- waveform batches become log-mels on the card as (B, S)
    programs (``dsp/mel.py::batched_log_mel_with_lengths``: framing, rFFT,
    filterbank product), grouped into length buckets; the main thread
    queues each batch's copy and mel program without waiting and records a
    CUDA event after it,
  * **writeback** -- writer threads wait on each batch's event, copy its
    mels to the host on a stream of their own and write per-item ``.npy``
    files while the main thread decodes and queues the next batches.

The text stage (normalize -> G2P -> token IDs, pure-Python host work) can
fan out over a process pool (``text_workers``; auto = one worker per CPU,
capped at 8).

Cache layout: ``mels/<base>.npy`` ((n_mels, T) float32),
``text/<base>.npy`` (int32 token ids) and a copied ``metadata.csv``.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import AudioConfig
from ..dsp.mel import batched_log_mel_with_lengths, reflect_pad_batch
from ..dsp.wav import load_audio
from ..text.frontend import text_to_sequence
from ..utils.device import resolve_device
from .metadata import basename_of, read_metadata
from .native_loader import decode_batch_padded, native_available

# Padded-signal buckets: multiples of 2^15 samples (~1.5 s at 22.05 kHz).
_BUCKET_QUANTUM = 1 << 15

# Device batches allowed in flight before the producer blocks: bounds
# device memory while keeping decode / compute / writeback overlapped.
_MAX_INFLIGHT = 8

# Concurrent device->host copies (each on its own stream).
_WRITER_THREADS = 4


def _bucket_len(n_samples: int) -> int:
    return -(-n_samples // _BUCKET_QUANTUM) * _BUCKET_QUANTUM


def _estimated_wav_samples(path: str) -> int:
    """Upper-bound sample estimate from file size (PCM16 mono: the
    LJSpeech case).  Only used for bucketing; the decoder reports truth."""
    try:
        return max(0, (os.path.getsize(path) - 44) // 2)
    except OSError:
        return 0


def _tokenize_one(args: Tuple[str, str]) -> Tuple[str, Optional[List[int]],
                                                  str]:
    """(base, text) -> (base, seq | None, error).  Top-level so process
    pools can pickle it; the G2P singleton loads once per worker."""
    base, text = args
    try:
        return base, text_to_sequence(text), ""
    except Exception as e:  # pragma: no cover - G2P failures are data bugs
        return base, None, f"{type(e).__name__}: {e}"


def _run_text_stage(rows, text_dir: str, workers: Optional[int]
                    ) -> Tuple[Dict[str, bool], int]:
    """Tokenize + save every row's text.  Returns (ok-by-base, skipped)."""
    if workers is None:
        workers = min(os.cpu_count() or 1, 8)
    jobs = [(basename_of(r["filepath"]), r["text"]) for r in rows]
    if workers > 1 and len(jobs) > 2 * workers:
        # spawn, not fork: the parent may hold an initialized CUDA context,
        # which a forked child must not inherit.  Workers only run the text
        # frontend, so they never touch CUDA.
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            results = list(ex.map(
                _tokenize_one, jobs,
                chunksize=max(1, len(jobs) // (4 * workers))))
    else:
        results = [_tokenize_one(j) for j in jobs]
    ok: Dict[str, bool] = {}
    skipped = 0
    for (base, seq, err), row in zip(results, rows):
        if seq is None:
            print(f"Skipping (text) {row['filepath']}: {err}")
            skipped += 1
            ok[base] = False
            continue
        np.save(os.path.join(text_dir, f"{base}.npy"),
                np.asarray(seq, dtype=np.int32))
        ok[base] = True
    return ok, skipped


class _DeviceBatch:
    """One batch's mels, queued on the device: the output tensor, the
    event recorded after its program (None on the CPU, where the program
    has run) and the pinned input, kept alive until that event."""

    def __init__(self, mels: torch.Tensor, event: Optional[torch.cuda.Event],
                 staged: Optional[torch.Tensor]):
        self.mels = mels
        self.event = event
        self.staged = staged

    def to_host(self) -> np.ndarray:
        if self.event is None:
            return self.mels.numpy()
        stream = torch.cuda.Stream(self.mels.device)
        with torch.cuda.stream(stream):
            stream.wait_event(self.event)
            mels = self.mels.cpu()      # waits on this stream only
        self.staged = None
        return mels.numpy()


class _MelWriter:
    """Writeback stage: device->host copy + per-item .npy saves on worker
    threads, overlapping the producer's decode and device queueing.

    ``submit`` never waits on the device; the copy happens on a writer
    thread (its wait releases the GIL).  In-flight batches are bounded by
    ``_MAX_INFLIGHT``.
    """

    def __init__(self, mels_dir: str):
        from concurrent.futures import ThreadPoolExecutor
        self.mels_dir = mels_dir
        self._ex = ThreadPoolExecutor(max_workers=_WRITER_THREADS)
        self._futures: deque = deque()
        self._lock = threading.Lock()
        self.ok = 0
        self.fallback: List[dict] = []
        self.transfer_sec = 0.0

    def _write(self, batch: _DeviceBatch, mel_lens, chunk, usable):
        # mel_lens is HOST-computed (1 + samples // hop): only the mel
        # array itself crosses the device boundary.
        t0 = time.perf_counter()
        mels = batch.to_host()         # waits HERE, off the main thread
        dt = time.perf_counter() - t0
        n_ok = 0
        for j, c in enumerate(chunk):
            if usable is None or usable[j]:
                np.save(os.path.join(self.mels_dir, f"{c['base']}.npy"),
                        mels[j, :, :int(mel_lens[j])])
                n_ok += 1
            else:
                with self._lock:
                    self.fallback.append(c)
        with self._lock:
            self.ok += n_ok
            self.transfer_sec += dt

    def submit(self, batch: _DeviceBatch, mel_lens, chunk, usable=None):
        while len(self._futures) >= _MAX_INFLIGHT:
            self._futures.popleft().result()
        self._futures.append(
            self._ex.submit(self._write, batch, mel_lens, chunk, usable))

    def drain(self) -> None:
        while self._futures:
            self._futures.popleft().result()

    def close(self) -> None:
        try:
            self.drain()
        finally:
            self._ex.shutdown()


def _device_mels_async(batch: np.ndarray, lengths: np.ndarray,
                      cfg: AudioConfig, device: torch.device
                      ) -> Tuple[_DeviceBatch, np.ndarray]:
    """Queue one padded batch's mel program on ``device`` without waiting;
    returns (the queued batch, HOST mel lengths).  The frame count is
    deterministic (1 + samples // hop, the formula ``dsp/mel.py`` applies
    on the device), so the lengths never come back from the device."""
    x = torch.from_numpy(batch)
    staged = None
    if device.type == "cuda":
        staged = x.pin_memory()
        x = staged.to(device, non_blocking=True)
    lens = torch.from_numpy(np.asarray(lengths, np.int64)).to(device)
    mels, _ = batched_log_mel_with_lengths(
        x, lens, sr=cfg.sampling_rate, n_fft=cfg.n_fft,
        hop_length=cfg.hop_length, win_length=cfg.win_length,
        n_mels=cfg.n_mels, fmin=cfg.fmin, fmax=cfg.fmax, mel_eps=cfg.mel_eps)
    event = None
    if device.type == "cuda":
        event = torch.cuda.Event()
        event.record()
    return (_DeviceBatch(mels, event, staged),
            1 + np.asarray(lengths, np.int64) // cfg.hop_length)


def preprocess_corpus(metadata_path: str, output_dir: str,
                      cfg: Optional[AudioConfig] = None,
                      batch_size: int = 64,
                      log_every: int = 50,
                      use_native: Optional[bool] = None,
                      text_workers: Optional[int] = None,
                      device: Union[str, torch.device] = "cuda"
                      ) -> Dict[str, int]:
    """Run the full offline preprocessing pass on ``device``.

    Per-file failures are skipped with a warning.  Returns counters
    (``ok``, ``skipped``).

    With the native C++ loader (``use_native=None`` means
    :func:`native_available`; ``True`` without the library raises), WAV
    audio never touches Python: files are bucketed by size, a C++ thread
    pool decodes and reflect-pads whole batches, and the device turns each
    batch into mels.  Files the native path cannot handle (other formats or
    rates) fall back per file to Python (``dsp/wav.py::load_audio``).
    """
    cfg = cfg or AudioConfig()
    device = resolve_device(device)
    rows = read_metadata(metadata_path)
    mels_dir = os.path.join(output_dir, "mels")
    text_dir = os.path.join(output_dir, "text")
    os.makedirs(mels_dir, exist_ok=True)
    os.makedirs(text_dir, exist_ok=True)
    if use_native is None:
        use_native = native_available()

    print(f"Preprocessing {len(rows)} files -> {output_dir} "
          f"(native loader: {use_native}, device: {device})")
    stats = {"ok": 0, "skipped": 0}
    pad = cfg.n_fft // 2
    wall0 = time.perf_counter()

    # ---- Stage 1 (host, process-pool): tokenize + save text ----
    t0 = time.perf_counter()
    text_ok, text_skipped = _run_text_stage(rows, text_dir, text_workers)
    stats["skipped"] += text_skipped
    t_text = time.perf_counter() - t0

    # Partition surviving rows: native fast path (WAV, bucketed by size
    # estimate) vs per-file Python decode.
    native_buckets: Dict[int, List[dict]] = {}
    python_rows: List[dict] = []
    for row in rows:
        base = basename_of(row["filepath"])
        if not text_ok.get(base, False):
            continue
        item = {"base": base, "path": row["filepath"]}
        if use_native and row["filepath"].lower().endswith(".wav"):
            est = _estimated_wav_samples(row["filepath"])
            native_buckets.setdefault(_bucket_len(est), []).append(item)
        else:
            python_rows.append(item)

    # ---- Stage 2a: C++ decode -> queued device mels -> writer threads ----
    t0 = time.perf_counter()
    writer = _MelWriter(mels_dir)
    try:
        done = 0
        for bucket_samples in sorted(native_buckets):
            items = native_buckets[bucket_samples]
            total_len = bucket_samples + cfg.n_fft
            for start in range(0, len(items), batch_size):
                chunk = items[start:start + batch_size]
                padded_chunk = chunk + [chunk[-1]] * (batch_size - len(chunk))
                batch, lengths, rates = decode_batch_padded(
                    [c["path"] for c in padded_chunk], pad, total_len)
                usable = (lengths > 0) & (rates == cfg.sampling_rate)
                queued, mel_lens = _device_mels_async(batch, lengths, cfg,
                                                     device)
                writer.submit(queued, mel_lens, chunk, usable)
                done += len(chunk)
                if log_every and done % log_every < batch_size:
                    print(f"  native: {done}/{len(rows)}")
        writer.drain()
        python_rows.extend(writer.fallback)   # wrong rate/size: slow path
        writer.fallback = []
        t_native = time.perf_counter() - t0

        # ---- Stage 2b: per-file Python load, bucketed, same pipeline ----
        t0 = time.perf_counter()
        py_buckets: Dict[int, List[dict]] = {}
        for item in python_rows:
            try:
                y, _ = load_audio(item["path"], target_sr=cfg.sampling_rate)
            except Exception as e:
                print(f"Skipping (mel) {item['path']}: {e}")
                stats["skipped"] += 1
                continue
            py_buckets.setdefault(_bucket_len(len(y)), []).append(
                {**item, "wav": y})
        for bucket_samples in sorted(py_buckets):
            items = py_buckets[bucket_samples]
            total_len = bucket_samples + cfg.n_fft
            for start in range(0, len(items), batch_size):
                chunk = items[start:start + batch_size]
                padded_chunk = chunk + [chunk[-1]] * (batch_size - len(chunk))
                sigs = [c["wav"] for c in padded_chunk]
                lengths = np.asarray([len(s) for s in sigs], dtype=np.int64)
                batch = reflect_pad_batch(sigs, pad, total_len)
                queued, mel_lens = _device_mels_async(batch, lengths, cfg,
                                                     device)
                writer.submit(queued, mel_lens, chunk)
    finally:
        writer.close()   # close() drains; no per-bucket barrier
    stats["ok"] += writer.ok
    t_python = time.perf_counter() - t0

    shutil.copyfile(metadata_path, os.path.join(output_dir, "metadata.csv"))
    wall = time.perf_counter() - wall0
    print(f"  stage breakdown: text {t_text:.2f}s | native pipeline "
          f"{t_native:.2f}s (D2H+save {writer.transfer_sec:.2f}s "
          f"overlapped) | python path {t_python:.2f}s | total {wall:.2f}s")
    print(f"Preprocessing complete: {stats['ok']} ok, "
          f"{stats['skipped']} skipped -> {output_dir}")
    return stats
