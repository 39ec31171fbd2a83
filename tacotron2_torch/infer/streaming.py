"""Streaming synthesis: yield mel chunks while the decoder is still running.

Counterpart of ``tacotron2_tpu/infer/streaming.py``.  The autoregressive
loop runs in chunks of K decoder steps (a Python loop of
``models/decoder.py::decode_step``, whose attention tail is the CUDA
kernel ``ops/attention_kernel.py::attention_tail`` on the card) with the
decoder carry kept on the device between chunks; each chunk's K frames and
gate logits come to the host in one synchronise and are yielded at once.
Time to the first mel is one encoder pass + K decode steps instead of the
whole utterance.

The mel-level generator is the stable API; chunk vocoding is left to the
caller (convolutional vocoders need overlap handling that depends on the
vocoder's receptive field; ``infer/server.py`` does it).
"""

from __future__ import annotations

from typing import Generator, Optional, Tuple, Union

import numpy as np
import torch

from ..models.attention import precompute_memory
from ..models.decoder import DecoderCarry, decode_step, init_carry, \
    prenet_apply
from ..models.encoder import encoder_apply
from ..models.postnet import postnet_apply
from ..models.tacotron2 import (Tacotron2, _condition_memory, make_pad_mask,
                                make_speaker_ids)
from ..text import pad_sequences, text_to_sequence
from ..utils.device import check_module_device, resolve_device
from .fused import _fetch


@torch.no_grad()
def _encode(model: Tacotron2, tokens: torch.Tensor,
            text_lengths: torch.Tensor, speaker_ids: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    memory = encoder_apply(model.encoder, tokens)
    memory = _condition_memory(model, memory, speaker_ids)
    processed = precompute_memory(model.decoder.attention, memory)
    mask = make_pad_mask(text_lengths, tokens.shape[1])
    return memory, processed, mask


@torch.no_grad()
def _decode_chunk(model: Tacotron2, carry: DecoderCarry,
                  mel_in: torch.Tensor, memory: torch.Tensor,
                  processed: torch.Tensor, mask: torch.Tensor, k: int
                  ) -> Tuple[DecoderCarry, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Run K decoder steps from ``carry`` on the device; returns (carry',
    last_mel, mels (B, K, n_mels), gate_logits (B, K)), all on the device."""
    dec = model.decoder
    mels, gates = [], []
    for _ in range(k):
        carry, (mel_in, gate, _attn) = decode_step(
            dec, prenet_apply(dec, mel_in), carry, memory, processed, mask)
        mels.append(mel_in)
        gates.append(gate)
    return (carry, mel_in, torch.stack(mels, 1).float(),
            torch.stack(gates, 1).float())


@torch.no_grad()
def _postnet_window(model: Tacotron2, mel_tn: np.ndarray) -> np.ndarray:
    """Postnet over one (T, n_mels) window on the model's device ->
    refined (T, n_mels) on the host."""
    dev = model.postnet.convs[0].weight.device
    x = torch.from_numpy(np.ascontiguousarray(mel_tn.T[None])).to(dev)
    return (x + postnet_apply(model.postnet, x))[0].T.cpu().numpy()


def _refine_stream(model: Tacotron2, coarse_gen, chunk_frames: int
                   ) -> Generator[np.ndarray, None, None]:
    """Apply the postnet to a coarse-mel chunk stream EXACTLY, with an
    ``r``-frame lookahead delay.

    The postnet is a non-causal conv stack with receptive radius
    ``r = n_layers * (kernel-1)/2`` (10 frames at reference dims): a
    frame's refinement needs r future coarse frames.  The stream holds
    back the last r frames of each chunk and refines every emitted frame
    with full left+right coarse context, so the concatenated output
    matches the offline postnet.

    Mid-stream windows are padded to one shape (the emit region never sees
    the padding: its receptive cone stays inside the real frames).  The
    FLUSH window's tail frames do see past the end, where offline
    semantics depend on how the stream ended: a gate stop leaves real zero
    frames in the offline buffer (zero padding reproduces them, phantom
    BatchNorm activations and all), while hitting the step cap means the
    offline conv pads each LAYER with zeros at the boundary -- only an
    unpadded window reproduces that, so cap flushes run the window at its
    exact length.
    """
    mcfg = model.cfg
    n_mels = mcfg.n_mels
    r = mcfg.postnet_n_convolutions * ((mcfg.postnet_kernel_size - 1) // 2)
    bufmax = 2 * r + chunk_frames
    left = np.zeros((0, n_mels), np.float32)      # emitted coarse tail
    pending = np.zeros((0, n_mels), np.float32)   # lookahead hold-back

    def refine(buf: np.ndarray, lo: int, hi: int,
               pad: bool = True) -> np.ndarray:
        t = buf.shape[0]
        # On a gate-stop flush the last emitted frame's cone reads r zero
        # frames past the end (the offline buffer's trailing zeros), and
        # when chunk_frames < r, bufmax leaves fewer than r rows after a
        # full 2r-frame flush buffer: pad to at least hi + r rows.
        target = max(bufmax, hi + r)
        if pad and t < target:
            buf = np.concatenate(
                [buf, np.zeros((target - t, n_mels), np.float32)])
        return _postnet_window(model, buf)[lo:hi]

    end_reason, tail = "cap", 0
    gen = iter(coarse_gen)
    while True:
        try:
            chunk = next(gen)
        except StopIteration as stop:
            # ("gate", zero_tail): zero_tail = how many REAL zero rows
            # the offline buffer holds past the stop (max_steps - n).
            if isinstance(stop.value, tuple):
                end_reason, tail = stop.value
            else:
                # bare reason string: a gate stop with unspecified tail
                # assumes ample offline zeros
                end_reason = stop.value or "cap"
                tail = r if end_reason == "gate" else 0
            break
        body = np.concatenate([pending, np.asarray(chunk, np.float32)])
        emit = body.shape[0] - r
        if emit <= 0:
            pending = body
            continue
        buf = np.concatenate([left, body])
        yield refine(buf, left.shape[0], left.shape[0] + emit)
        hist = buf[: left.shape[0] + emit]
        left = hist[-r:]
        pending = body[emit:]
    if pending.shape[0]:
        buf = np.concatenate([left, pending])
        if end_reason == "gate" and tail < r:
            # Gate fired within r frames of the step cap: the offline
            # buffer holds only ``tail`` real zero rows before it ENDS.
            # Append those zeros and run the window at its true length.
            buf = np.concatenate(
                [buf, np.zeros((tail, n_mels), np.float32)])
            yield refine(buf, left.shape[0], buf.shape[0] - tail,
                         pad=False)
        else:
            yield refine(buf, left.shape[0], buf.shape[0],
                         pad=(end_reason == "gate"))


def stream_mels(model: Tacotron2, text: str, chunk_frames: int = 64,
                max_steps: Optional[int] = None,
                gate_threshold: Optional[float] = None,
                drop_first_frame: bool = True,
                speaker_id: Optional[int] = None,
                apply_postnet: bool = False,
                device: Union[str, torch.device] = "cuda"
                ) -> Generator[np.ndarray, None, object]:
    """Generator of mel chunks ((<=chunk_frames, n_mels) numpy each) for
    one utterance, ending at the gate firing or the step cap; the model
    must lie on ``device``.  The generator returns ``("gate", zero_rows)``
    or ``("cap", 0)`` (see :func:`_refine_stream`).

    By default streams the decoder's coarse mels.  ``apply_postnet=True``
    streams postnet-refined mels instead, at the cost of a fixed 10-frame
    (~116 ms of audio) lookahead delay -- the refined stream concatenates
    to the offline postnet output (see :func:`_refine_stream`).
    """
    device = resolve_device(device)
    check_module_device(model, device)
    if apply_postnet:
        coarse = stream_mels(model, text, chunk_frames, max_steps,
                             gate_threshold, drop_first_frame, speaker_id,
                             apply_postnet=False, device=device)
        yield from _refine_stream(model, coarse, chunk_frames)
        return None
    mcfg = model.cfg
    max_steps = mcfg.max_decoder_steps if max_steps is None else max_steps
    thr = mcfg.gate_threshold if gate_threshold is None else gate_threshold

    seq = text_to_sequence(text) or [0]
    tokens, lengths = pad_sequences([seq], pad_multiple=16)
    ids = make_speaker_ids(speaker_id, 1, mcfg)
    memory, processed, mask = _encode(
        model, torch.from_numpy(tokens).long().to(device),
        torch.from_numpy(lengths).long().to(device),
        None if ids is None else torch.from_numpy(ids).to(device))

    carry = init_carry(1, tokens.shape[1], mcfg, device)
    mel_in = torch.zeros(1, mcfg.n_mels, device=device)

    # The tail is trimmed on the host, and the reference's dropped-first-
    # frame quirk (src/model.py:309-316) is realized by discarding the
    # first frame of the first chunk (the loop feeds it forward, so the
    # state trajectory is identical).
    produced = 0            # recorded (yielded) frame count
    first_chunk = drop_first_frame
    while produced < max_steps:
        carry, mel_in, mels, gates = _decode_chunk(
            model, carry, mel_in, memory, processed, mask, chunk_frames)
        mels_np, gates_np = _fetch(mels[0], gates[0])     # one synchronise
        sig = 1.0 / (1.0 + np.exp(-gates_np))              # (K,)
        if first_chunk:
            mels_np = mels_np[1:]
            sig = sig[1:]
            first_chunk = False
        k = min(len(mels_np), max_steps - produced)
        mels_np, sig = mels_np[:k], sig[:k]
        # gate semantics: stop once >1 total recorded frames AND sig > thr
        fired = np.nonzero((sig > thr)
                           & (np.arange(produced + 1,
                                        produced + k + 1) > 1))[0]
        if len(fired):
            end = int(fired[0]) + 1
            if end:
                yield mels_np[:end]
            # why the stream ended + how many real zero rows the offline
            # max_steps buffer holds past the stop (the postnet flush
            # needs this to reproduce offline semantics when the gate
            # fires within the postnet radius of the cap)
            return ("gate", max_steps - (produced + end))
        produced += k
        if k:
            yield mels_np
    return ("cap", 0)
