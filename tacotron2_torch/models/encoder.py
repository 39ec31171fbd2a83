"""Tacotron 2 encoder: embedding -> 3 x (conv, BN, ReLU) -> BiLSTM.

Counterpart of ``tacotron2_tpu/models/encoder.py`` in eval mode.  Outputs
the attention memory (B, T_enc, 512).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from .layers import BatchNorm, BiLSTM, Conv1d, Embedding


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        e = cfg.encoder_embedding_dim
        self.embedding = Embedding(cfg.n_symbols, cfg.symbols_embedding_dim)
        self.convs = nn.ModuleList(
            Conv1d(e, e, cfg.encoder_kernel_size)
            for _ in range(cfg.encoder_n_convolutions))
        self.bns = nn.ModuleList(
            BatchNorm(e, cfg.batchnorm_eps)
            for _ in range(cfg.encoder_n_convolutions))
        self.lstm = BiLSTM(e, e // 2)


def encoder_apply(encoder: Encoder, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, T_enc) int -> memory (B, T_enc, 512) fp32."""
    x = encoder.embedding(tokens).transpose(1, 2)         # (B, D, T)
    for conv, bn in zip(encoder.convs, encoder.bns):
        x = torch.relu(bn(conv(x)))
    return encoder.lstm(x.transpose(1, 2))
