"""Location-sensitive attention with explicit carried state.

Counterpart of ``tacotron2_tpu/models/attention.py``:

    e = energy_scale * v . tanh(W_q q + W_m memory + W_l F(prev, cum))

with a 2-channel (previous + cumulative alignment) location conv of 32
filters, kernel 31, no bias, and -1e9 masking of encoder padding.  The
per-step tail (energies -> softmax -> context) is
``ops.attention_kernel.attention_tail``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.attention_kernel import attention_tail
from .layers import Conv1d, Linear


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        a = cfg.attention_dim
        self.query_layer = Linear(cfg.attention_rnn_dim, a, bias=False)
        self.memory_layer = Linear(cfg.encoder_embedding_dim, a, bias=False)
        self.location_conv = Conv1d(2, cfg.location_n_filters,
                                    cfg.location_kernel_size, bias=False)
        self.location_dense = Linear(cfg.location_n_filters, a, bias=False)
        self.v = Linear(a, 1, bias=True)
        self.energy_scale = nn.Parameter(torch.tensor(cfg.energy_scale_init))


def precompute_memory(att: Attention, memory: torch.Tensor) -> torch.Tensor:
    """W_m @ memory, once per utterance: (B, T_enc, attention_dim) fp32."""
    return att.memory_layer(memory)


def _qsum(att: Attention, query: torch.Tensor, processed_memory: torch.Tensor,
          prev_attn: torch.Tensor, cum_attn: torch.Tensor) -> torch.Tensor:
    """Pre-tanh energy sum (B, T_enc, attention_dim) fp32."""
    processed_query = att.query_layer(query)[:, None, :]
    loc = att.location_conv(torch.stack([prev_attn, cum_attn], dim=1))
    loc = att.location_dense(loc.transpose(1, 2))
    return processed_query + processed_memory + loc


def attention_energies(att: Attention, query: torch.Tensor,
                       processed_memory: torch.Tensor,
                       prev_attn: torch.Tensor, cum_attn: torch.Tensor,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Alignment energies (B, T_enc) for one decoder step."""
    qsum = _qsum(att, query, processed_memory, prev_attn, cum_attn)
    energies = att.v(torch.tanh(qsum))[..., 0] * att.energy_scale
    if mask is not None:
        energies = energies.masked_fill(mask, -1e9)
    return energies


TailFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def attention_step(att: Attention, query: torch.Tensor, memory: torch.Tensor,
                   processed_memory: torch.Tensor, prev_attn: torch.Tensor,
                   cum_attn: torch.Tensor, mask: Optional[torch.Tensor],
                   tail: TailFn = attention_tail
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One attention step.

    Returns (context (B, D_enc), attn (B, T_enc), new cum_attn); the new
    prev_attn is ``attn``.  ``qsum`` is cast to the ``v`` weight dtype
    before the tail; ``memory`` stays fp32 at that boundary (the tail
    reads it in the compute dtype).
    """
    qsum = _qsum(att, query, processed_memory, prev_attn, cum_attn)
    qsum = qsum.to(att.v.weight.dtype)
    if mask is None:
        mask = torch.zeros(qsum.shape[:2], dtype=torch.bool,
                           device=qsum.device)
    attn, context = tail(qsum, att.v.weight[0], att.v.bias[0],
                         att.energy_scale, mask, memory)
    return context, attn, cum_attn + attn
