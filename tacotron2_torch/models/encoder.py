"""Tacotron 2 encoder: embedding -> 3 x (conv, BN, ReLU) -> BiLSTM.

Counterpart of ``tacotron2_tpu/models/encoder.py`` (no dropout here).
Outputs the attention memory (B, T_enc, 512).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.convbn_kernel import conv_bn_act
from ..utils.profiling import count, span
from .layers import BatchNorm, BiLSTM, Conv1d, Embedding


class Encoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.encoder_embedding_dim
        self.embedding = Embedding(cfg.n_symbols, cfg.symbols_embedding_dim)
        self.convs = nn.ModuleList(
            Conv1d(e, e, cfg.encoder_kernel_size)
            for _ in range(cfg.encoder_n_convolutions))
        self.bns = nn.ModuleList(
            BatchNorm(e, cfg.batchnorm_eps, cfg.batchnorm_momentum)
            for _ in range(cfg.encoder_n_convolutions))
        self.lstm = BiLSTM(e, e // 2)


def encoder_apply(encoder: Encoder, tokens: torch.Tensor,
                  train: bool = False) -> torch.Tensor:
    """tokens (B, T_enc) int -> memory (B, T_enc, 512) fp32.  ``train``
    normalises with batch statistics and updates the running ones; eval
    mode with ``cfg.fused_convbn`` runs each layer as one folded
    conv + BatchNorm + ReLU (``ops/convbn_kernel.py``).  On a CUDA device
    the BiLSTM replays CUDA graphs (``models/layers.py::BiLSTM``); the
    counter ``encoder.calls`` counts the calls, beside the BiLSTM's
    ``encoder.graph_replays`` and ``encoder.graph_captures``."""
    count("encoder.calls")
    with span("encoder"):
        x = encoder.embedding(tokens).transpose(1, 2)     # (B, D, T)
        fused_eval = not train and encoder.cfg.fused_convbn
        for conv, bn in zip(encoder.convs, encoder.bns):
            if fused_eval:
                x = conv_bn_act(x, conv, bn, encoder.cfg.batchnorm_eps,
                                "relu")
            else:
                x = torch.relu(bn(conv(x), train))
        return encoder.lstm(x.transpose(1, 2))
