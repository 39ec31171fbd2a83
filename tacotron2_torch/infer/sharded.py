"""Batched synthesis over device replicas: data-parallel serving.

Counterpart of ``tacotron2_tpu/infer/sharded.py``, in one process.  There
GSPMD partitions one fused program over the mesh's ``data`` axis.  Here
the synthesizer keeps one model replica per device of a
``parallel/mesh.py::make_mesh`` (weights copied once, at construction),
splits the padded batch into one shard per replica and runs each shard
through ``infer/fused.py``'s tokens -> waveform functions on its own
device.  Every shard's work is queued before any result is fetched, so
several cards decode at once.  Griffin-Lim starts each shard from its
rows of the initial phase one process draws for the whole batch.  Each shard decodes with
``stop_mode="all"`` and stops when all of its own items have, as the JAX
megakernel stops per shard (``tacotron2_tpu/ops/decoder_megakernel.py:
112-124``); every item is trimmed at its own ``frame_end``.

Replicas may share a card (``make_mesh(devices=["cuda:0", "cuda:0"])``):
that runs the split, the padding, the trim and the per-shard launches, and
gives no speed-up, as the shards then queue on one card.

``tensor_parallel=True`` over a ``make_mesh(n_data, n_model, devices)``
grid (``n_model`` at least 2) shards the decoder's LSTM gates and output
heads of each data shard's replica over its row of devices, in the JAX
package's layout (``parallel/mesh.py::param_shardings``): device ``(d,
0)``, the lead, holds everything replicated and shard 0, device ``(d, m)``
shard m, each moved there once.  The decode then runs the step loop (the
decode kernel holds those weights whole), its products on their shards,
the gate slices gathered and the head partials summed on the lead
(``parallel/model_axis.py::DeviceAxis``); the attention tail's kernel runs
on every step and the conv kernel on every encoder and postnet layer, as
without tensor parallelism.
"""

from __future__ import annotations

import contextlib
import copy
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..dsp import griffinlim
from ..models.tacotron2 import Tacotron2, make_speaker_ids
from ..parallel.mesh import Mesh, param_shardings, shard_of
from ..parallel.model_axis import DeviceAxis
from ..text import pad_sequences, text_to_sequence
from .fused import _fetch, synthesize_wav_fused, synthesize_wav_fused_hifigan


def _pad_rows(arr: np.ndarray, n_rows: int) -> np.ndarray:
    """Pad the leading (batch) axis to ``n_rows`` by repeating the last
    row (a real row, so the padding decodes, and gate-stops, like its
    original; dummy all-zero rows would never fire the gate and pin the
    whole shard at the step cap under stop_mode='all')."""
    if arr.shape[0] == n_rows:
        return arr
    reps = np.repeat(arr[-1:], n_rows - arr.shape[0], axis=0)
    return np.concatenate([arr, reps], axis=0)


def _on(device: torch.device):
    """Make ``device`` the current CUDA device (nothing for the CPU)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


@torch.no_grad()
def _tp_replica(model: Tacotron2, devices: Sequence[torch.device]
                ) -> Tacotron2:
    """A replica of ``model`` on ``devices[0]`` whose decoder holds shard
    0 of each tensor-parallel tensor, with a model axis holding shard m on
    ``devices[m]``."""
    n = len(devices)
    replica = copy.deepcopy(model)
    peers = {}
    for name, spec in param_shardings(model, True).items():
        if not spec:
            continue
        whole = model.get_parameter(name).data
        replica.get_parameter(name).data = shard_of(whole, spec, 0, n, name)
        peers[name] = [shard_of(whole, spec, m, n, name).to(devices[m])
                       for m in range(1, n)]
    replica = replica.to(devices[0])
    replica.decoder.model_axis = DeviceAxis(devices, peers)
    return replica


class ShardedSynthesizer:
    """Batched texts -> waveforms, data-parallel over device replicas, and
    with ``tensor_parallel`` each replica's decoder sharded over its row
    of the grid.

    Usage::

        mesh = make_mesh(devices=["cuda:0", "cuda:1"])
        with ShardedSynthesizer(model, mesh, cfg) as synth:
            wavs = synth(["First text.", "Second text.", ...])
        grid = make_mesh(n_data=2, n_model=2, devices=[...])  # 4 devices
        synth = ShardedSynthesizer(model, grid, cfg, tensor_parallel=True)

    ``hifigan_params`` (a ``models/hifigan.py::HiFiGAN``) switches the
    vocoder from Griffin-Lim to HiFi-GAN.  Batches whose size is not a
    multiple of the replica count are padded by repeating the last item;
    outputs are trimmed back.
    """

    def __init__(self, model: Tacotron2, mesh: Mesh,
                 cfg: Optional[Config] = None, hifigan_params=None,
                 gl_iters: int = 60, tensor_parallel: bool = False):
        if "data" not in getattr(mesh, "axis_names", ()):
            raise ValueError(f"mesh must have a 'data' axis, has "
                             f"{getattr(mesh, 'axis_names', mesh)}")
        if tensor_parallel and mesh.shape.get("model", 1) < 2:
            raise ValueError("tensor_parallel needs a 'model' mesh axis "
                             f"wider than 1, mesh: {mesh.shape}")
        self.cfg = cfg or Config()
        self.mesh = mesh
        self.n_data = mesh.shape["data"]
        self.gl_iters = gl_iters
        self.leads = [row[0] for row in mesh.devices]
        self.replicas = [_tp_replica(model, row) if tensor_parallel
                         else copy.deepcopy(model).to(row[0])
                         for row in mesh.devices]
        self.vocoders = [None if hifigan_params is None
                         else copy.deepcopy(hifigan_params).to(d)
                         for d in self.leads]

    def close(self):
        """Drop the replicas.  Idempotent."""
        self.replicas, self.vocoders = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __call__(self, texts: Sequence[str], speaker_id=None,
                 max_steps: Optional[int] = None) -> List[np.ndarray]:
        """Synthesize ``texts`` -> list of trimmed float32 waveforms.

        ``speaker_id``: one id for all items or a per-item sequence
        (None entries default), as in :func:`make_speaker_ids`.
        """
        if not texts:
            return []
        if not self.replicas:
            raise RuntimeError("ShardedSynthesizer is closed")
        n = len(texts)
        cfg = self.cfg
        seqs = [text_to_sequence(t) or [0] for t in texts]
        tokens, lengths = pad_sequences(seqs, pad_multiple=16)
        spk = make_speaker_ids(speaker_id, n, cfg.model)

        per = -(-n // self.n_data)         # rows a shard, padded batch
        b = per * self.n_data
        tokens = _pad_rows(np.asarray(tokens), b)
        lengths = _pad_rows(np.asarray(lengths), b)
        spk = None if spk is None else _pad_rows(np.asarray(spk), b)
        steps = (self.replicas[0].cfg.max_decoder_steps if max_steps is None
                 else max_steps)

        def phase(dev, rows):
            """Rows of the initial phase one process draws for the batch."""
            p = griffinlim._initial_phase(
                (n, cfg.audio.n_fft // 2 + 1, steps), 0, dev)
            return torch.cat([p, p[-1:].expand(b - n, -1, -1)])[rows]

        # queue every shard before fetching any result
        outs = []
        for i, (dev, model, voc) in enumerate(zip(
                self.leads, self.replicas, self.vocoders)):
            rows = slice(i * per, (i + 1) * per)
            args = (tokens[rows], lengths[rows],
                    None if spk is None else spk[rows])
            with _on(dev):
                if voc is not None:
                    wav, _, _, ends = synthesize_wav_fused_hifigan(
                        model, voc, cfg.audio, *args, max_steps=max_steps,
                        stop_mode="all", device=dev)
                else:
                    wav, _, ends = synthesize_wav_fused(
                        model, cfg.audio, *args, max_steps=max_steps,
                        gl_iters=self.gl_iters, stop_mode="all",
                        init_phase=phase(dev, rows),
                        device=dev)
            outs.append((dev, wav, ends))
        hop = cfg.audio.hop_length
        wavs = []
        for dev, wav, ends in outs:
            with _on(dev):
                wav_np, ends_np = _fetch(wav, ends)
            wavs += [wav_np[j, : int(ends_np[j]) * hop]
                     for j in range(wav_np.shape[0])]
        return wavs[:n]
