"""Tacotron 2 autoregressive decoder: prenet + attention + 2 LSTMs + heads.

Counterpart of ``tacotron2_tpu/models/decoder.py`` in eval mode (no
dropout).  Per step: prenet -> attention LSTM -> attention -> decoder LSTM
-> fused projection + gate head.  :func:`decoder_infer` is the gate-stopped
autoregressive decode; on CUDA tensors with ``cfg.decoder_megakernel`` it
runs as one persistent kernel (``ops/decoder_megakernel.py``), otherwise
as the step loop here, whose attention tail is the Triton kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.attention_kernel import attention_tail
from .attention import Attention, TailFn, attention_step, precompute_memory
from .layers import Linear, LSTMCell, linear


class DecoderCarry(NamedTuple):
    h_att: torch.Tensor     # (B, H) attention-LSTM hidden
    c_att: torch.Tensor
    h_dec: torch.Tensor     # (B, H) decoder-LSTM hidden
    c_dec: torch.Tensor
    context: torch.Tensor   # (B, D_enc) attention context
    prev_attn: torch.Tensor  # (B, T_enc)
    cum_attn: torch.Tensor   # (B, T_enc)


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        e, h = cfg.encoder_embedding_dim, cfg.decoder_rnn_dim
        self.prenet = nn.ModuleList([
            Linear(cfg.n_mels, cfg.prenet_dim, bias=False),
            Linear(cfg.prenet_dim, cfg.prenet_dim, bias=False)])
        self.attention = Attention(cfg)
        self.attention_lstm = LSTMCell(cfg.prenet_dim + e, h)
        self.decoder_lstm = LSTMCell(h + e, h)
        self.linear_projection = Linear(h + e, cfg.n_mels)
        self.gate_layer = Linear(h + e, 1)


def prenet_apply(dec: Decoder, x: torch.Tensor) -> torch.Tensor:
    """PreNet (..., n_mels) -> (..., prenet_dim), eval mode."""
    for layer in dec.prenet:
        x = torch.relu(layer(x))
    return x


def init_carry(batch: int, t_enc: int, cfg: ModelConfig,
               device: torch.device) -> DecoderCarry:
    z = lambda d: torch.zeros(batch, d, device=device)
    h = cfg.decoder_rnn_dim
    return DecoderCarry(z(h), z(h), z(h), z(h), z(cfg.encoder_embedding_dim),
                        z(t_enc), z(t_enc))


def decode_step(dec: Decoder, prenet_out: torch.Tensor, carry: DecoderCarry,
                memory: torch.Tensor, processed_memory: torch.Tensor,
                mask: Optional[torch.Tensor], tail: TailFn = attention_tail
                ) -> Tuple[DecoderCarry, Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]]:
    """One decoder step from an already-prenetted frame.

    Returns (new_carry, (mel (B, n_mels), gate_logit (B,), attn (B, T_enc))).
    """
    attn_in = torch.cat([prenet_out, carry.context], dim=-1)
    h_att, c_att = dec.attention_lstm(attn_in, carry.h_att, carry.c_att)
    context, attn, cum = attention_step(
        dec.attention, h_att, memory, processed_memory, carry.prev_attn,
        carry.cum_attn, mask, tail)
    dec_in = torch.cat([h_att, context], dim=-1)
    h_dec, c_dec = dec.decoder_lstm(dec_in, carry.h_dec, carry.c_dec)
    proj_in = torch.cat([h_dec, context], dim=-1)
    # fused output heads: one (B, 1536) x (1536, n_mels + 1) product
    w_heads = torch.cat([dec.linear_projection.weight,
                         dec.gate_layer.weight], dim=0)
    b_heads = torch.cat([dec.linear_projection.bias, dec.gate_layer.bias])
    out = linear(proj_in, w_heads, b_heads)
    new_carry = DecoderCarry(h_att, c_att, h_dec, c_dec, context, attn, cum)
    return new_carry, (out[:, :-1], out[:, -1], attn)


def decoder_infer(dec: Decoder, memory: torch.Tensor, max_steps: int,
                  gate_threshold: float, drop_first_frame: bool = True,
                  mask: Optional[torch.Tensor] = None,
                  stop_mode: str = "any",
                  forced_stop_at: Optional[int] = None):
    """Gate-stopped autoregressive decode (eval mode).

    ``stop_mode`` "any" stops the whole batch once more than one frame is
    out and any item's gate sigmoid exceeds the threshold; "all" runs until
    every item's gate has fired (or ``max_steps``).  ``mask`` (B, T_enc),
    True = pad, masks padded encoder positions.  ``drop_first_frame``
    advances the state with a first frame that is not recorded.
    ``forced_stop_at`` treats the gate as fired once that many frames are
    out.

    Returns (mels (B, S, n_mels), gate_logits (B, S), aligns (B, S, T_enc),
    n_frames 0-d int32, frame_ends (B,) int32) with S = max_steps; rows
    past the stop hold zero mels and aligns and -1e9 gate logits;
    ``frame_ends[b] = min(frame count at item b's own stop, n_frames)``.
    """
    if stop_mode not in ("any", "all"):
        raise ValueError(f"stop_mode must be 'any' or 'all', got {stop_mode}")
    args = (dec, memory, max_steps, gate_threshold, drop_first_frame, mask,
            stop_mode, forced_stop_at)
    if dec.cfg.decoder_megakernel and memory.is_cuda:
        from ..ops.decoder_megakernel import decoder_infer_mega
        return decoder_infer_mega(*args)
    return decoder_infer_steps(*args, tail=attention_tail)


def decoder_infer_steps(dec: Decoder, memory: torch.Tensor, max_steps: int,
                        gate_threshold: float, drop_first_frame: bool = True,
                        mask: Optional[torch.Tensor] = None,
                        stop_mode: str = "any",
                        forced_stop_at: Optional[int] = None,
                        tail: TailFn = attention_tail):
    """The step loop behind :func:`decoder_infer` (same returns); ``tail``
    is the attention tail each step calls.  The stop test reads one flag
    back to the host per step."""
    cfg = dec.cfg
    b, t_enc, _ = memory.shape
    dev = memory.device
    processed_memory = precompute_memory(dec.attention, memory)
    carry = init_carry(b, t_enc, cfg, dev)

    def run_step(carry, mel_in):
        return decode_step(dec, prenet_apply(dec, mel_in), carry, memory,
                           processed_memory, mask, tail)

    mel_in = torch.zeros(b, cfg.n_mels, device=dev)
    if drop_first_frame:
        carry, (mel_in, _, _) = run_step(carry, mel_in)

    mels = torch.zeros(max_steps, b, cfg.n_mels, device=dev)
    gates = torch.full((max_steps, b), -1e9, device=dev)
    aligns = torch.zeros(max_steps, b, t_enc, device=dev)
    item_done = torch.zeros(b, dtype=torch.bool, device=dev)
    item_end = torch.full((b,), max_steps, dtype=torch.int32, device=dev)
    step = 0
    while step < max_steps:
        carry, (mel, gate, attn) = run_step(carry, mel_in)
        mels[step], gates[step], aligns[step] = mel, gate, attn
        n_out = step + 1
        fired = (torch.sigmoid(gate) > gate_threshold) & (n_out > 1)
        if forced_stop_at is not None and n_out >= forced_stop_at:
            fired = torch.ones_like(fired)
        item_end = torch.where(fired & ~item_done,
                               torch.full_like(item_end, n_out), item_end)
        item_done = item_done | fired
        step, mel_in = n_out, mel
        stop = item_done.any() if stop_mode == "any" else item_done.all()
        if bool(stop):
            break
    n_frames = torch.tensor(step, dtype=torch.int32, device=dev)
    frame_ends = torch.minimum(item_end, n_frames)
    return (mels.transpose(0, 1), gates.transpose(0, 1),
            aligns.transpose(0, 1), n_frames, frame_ends)
