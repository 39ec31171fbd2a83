"""Preprocessed (text, mel) dataset and batch assembly for training.

An own copy of ``tacotron2_tpu/data/dataset.py`` (numpy only):
:class:`TextMelDataset` reads the ``.npy`` caches a metadata CSV lists,
:func:`collate` pads a batch to quantised shapes, and :class:`BatchLoader`
iterates an epoch.  For one seed, each epoch's order and padded shapes
are the JAX loader's, and so is its split of every global batch over the
processes of a data-parallel run; :meth:`BatchLoader.skip_epochs` lets a
resumed run see the epochs an unbroken run would.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, NamedTuple, Optional, Sequence

import numpy as np

from .metadata import basename_of, read_metadata


class Example(NamedTuple):
    text: np.ndarray        # (T_text,) int token ids
    mel: np.ndarray         # (n_mels, T_mel) float32 log-mel
    speaker_id: int = 0


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def collate(examples: Sequence[Example], text_pad_multiple: int = 32,
            mel_pad_multiple: int = 64,
            fixed_text_len: Optional[int] = None,
            fixed_mel_len: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Assemble a batch dict with quantised padded shapes.

    Sorts by text length descending, zero-pads text and mel, rounds the
    padded dims up to the given multiples.
    """
    order = np.argsort([-len(e.text) for e in examples], kind="stable")
    examples = [examples[i] for i in order]

    text_lengths = np.asarray([len(e.text) for e in examples], dtype=np.int32)
    mel_lengths = np.asarray([e.mel.shape[1] for e in examples],
                             dtype=np.int32)
    t_text = fixed_text_len or _round_up(int(text_lengths.max()),
                                         text_pad_multiple)
    t_mel = fixed_mel_len or _round_up(int(mel_lengths.max()),
                                       mel_pad_multiple)
    n_mels = examples[0].mel.shape[0]

    b = len(examples)
    text = np.zeros((b, t_text), dtype=np.int32)
    mel = np.zeros((b, n_mels, t_mel), dtype=np.float32)
    for i, e in enumerate(examples):
        text[i, :len(e.text)] = e.text
        mel[i, :, :e.mel.shape[1]] = e.mel
    speakers = np.asarray([e.speaker_id for e in examples], dtype=np.int32)
    return {"text": text, "text_lengths": text_lengths, "mel": mel,
            "mel_lengths": mel_lengths, "speaker_ids": speakers}


class TextMelDataset:
    """Loads the preprocessed ``.npy`` caches listed in a metadata CSV.

    Raw ``speaker_id`` values (LibriSpeech speaker numbers such as 1089)
    map to contiguous indices 0..N-1; ``n_speakers`` is N, which sizes the
    trainer's speaker embedding table."""

    def __init__(self, metadata_path: str):
        self.rows = read_metadata(metadata_path)
        self.data_dir = os.path.dirname(os.path.abspath(metadata_path))
        raw_ids = sorted({int(r.get("speaker_id", 0) or 0)
                          for r in self.rows})
        self.speaker_map = {raw: i for i, raw in enumerate(raw_ids)}
        self._text_lengths: Dict[int, int] = {}
        self._mel_lengths: Dict[int, int] = {}

    @property
    def n_speakers(self) -> int:
        return len(self.speaker_map)

    def __len__(self) -> int:
        return len(self.rows)

    def _path(self, index: int, kind: str) -> str:
        base = basename_of(self.rows[index]["filepath"])
        return os.path.join(self.data_dir, kind, f"{base}.npy")

    def __getitem__(self, index: int) -> Example:
        row = self.rows[index]
        text = np.load(self._path(index, "text"))
        mel = np.load(self._path(index, "mels"))
        speaker = self.speaker_map[int(row.get("speaker_id", 0) or 0)]
        return Example(text=text.astype(np.int32),
                       mel=mel.astype(np.float32), speaker_id=speaker)

    def text_length(self, index: int) -> int:
        """Token count of an example (kept: the loader asks every epoch)."""
        if index not in self._text_lengths:
            self._text_lengths[index] = int(
                np.load(self._path(index, "text"), mmap_mode="r").shape[0])
        return self._text_lengths[index]

    def mel_length(self, index: int) -> int:
        """Mel frame count of an example, from the ``.npy`` header."""
        if index not in self._mel_lengths:
            self._mel_lengths[index] = int(
                np.load(self._path(index, "mels"), mmap_mode="r").shape[1])
        return self._mel_lengths[index]


class BatchLoader:
    """Shuffling epoch iterator of quantised-shape batches.

    ``drop_last`` keeps every batch ``batch_size`` rows (validation passes
    False so a small set still evaluates); a training loader that would
    yield no batch raises unless ``allow_empty``.  Up to ``PREFETCH``
    batches are assembled ahead on a background thread.  Shuffled indices
    are sorted by text length in pools of 32 global batches, then the
    batch order is shuffled.

    Data parallelism: with ``process_count`` > 1 every process derives the
    same global order from the seed, and of each global batch of
    ``batch_size * process_count`` rows loads only its own ``batch_size``
    (rows ``[process_index * batch_size, ...)``).  The padded dims come
    from the length headers of the whole global batch, so every process
    collates to the same shapes.  ``drop_last`` is forced: every process
    must see every step."""

    PREFETCH = 2

    def __init__(self, dataset: TextMelDataset, batch_size: int,
                 seed: int = 1234, shuffle: bool = True,
                 text_pad_multiple: int = 32, mel_pad_multiple: int = 64,
                 drop_last: bool = True, allow_empty: bool = False,
                 process_index: int = 0, process_count: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} not in "
                             f"[0, {process_count})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.text_pad_multiple = text_pad_multiple
        self.mel_pad_multiple = mel_pad_multiple
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last or process_count > 1
        if self.drop_last and len(dataset) < self.global_batch_size:
            msg = (f"dataset has {len(dataset)} examples but the global "
                   f"batch is {self.global_batch_size} (batch_size "
                   f"{batch_size} x {process_count} processes) with "
                   "drop_last: every epoch yields zero batches")
            if not allow_empty:
                raise ValueError(msg)
            print(f"[loader] WARNING: {msg}")
        self._rng = np.random.default_rng(seed)

    @property
    def global_batch_size(self) -> int:
        return self.batch_size * self.process_count

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.dataset) // self.global_batch_size
        return -(-len(self.dataset) // self.global_batch_size)

    def skip_epochs(self, n: int) -> None:
        """Draw the shuffles of ``n`` epochs without loading anything, so
        that the next epoch is the one an unbroken run would see next."""
        if not self.shuffle:
            return
        for _ in range(n):
            self._rng.shuffle(np.arange(len(self.dataset)))
            self._rng.shuffle(np.arange(len(self)))

    def _epoch_order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        if len(idx) > self.global_batch_size:
            pool = self.global_batch_size * 32
            chunks = []
            for s in range(0, len(idx), pool):
                chunk = idx[s:s + pool]
                lens = np.asarray([self.dataset.text_length(i)
                                   for i in chunk])
                chunks.append(chunk[np.argsort(-lens, kind="stable")])
            idx = np.concatenate(chunks)
        return idx

    def _iter_sync(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._epoch_order()
        gb = self.global_batch_size
        batch_starts = np.arange(len(self)) * gb
        if self.shuffle:
            self._rng.shuffle(batch_starts)
        for s in batch_starts:
            rows = idx[s:s + gb]
            # the whole global batch's padded dims, from length headers
            t_text = _round_up(max(self.dataset.text_length(int(i))
                                   for i in rows), self.text_pad_multiple)
            t_mel = _round_up(max(self.dataset.mel_length(int(i))
                                  for i in rows), self.mel_pad_multiple)
            lo = self.process_index * self.batch_size
            yield collate([self.dataset[int(i)]
                           for i in rows[lo:lo + self.batch_size]],
                          self.text_pad_multiple, self.mel_pad_multiple,
                          fixed_text_len=t_text, fixed_mel_len=t_mel)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # one producer thread an epoch behind a bounded queue
        import queue
        import threading
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        sentinel = object()
        stop = threading.Event()

        def put_or_abort(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for batch in self._iter_sync():
                    if not put_or_abort(batch):
                        return
                put_or_abort(sentinel)
            except Exception as e:              # handed to the consumer
                put_or_abort(e)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="batch-prefetch")
        thread.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=5.0)
