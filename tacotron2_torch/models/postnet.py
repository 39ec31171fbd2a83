"""PostNet: 5 conv layers predicting a mel residual.

Counterpart of ``tacotron2_tpu/models/postnet.py`` in eval mode: 80 -> 512
-> 512 -> 512 -> 512 -> 80 channels, kernel 5, BatchNorm on every layer,
tanh on all but the last.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import ModelConfig
from .layers import BatchNorm, Conv1d


class Postnet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        n = cfg.postnet_n_convolutions
        dims_in = [cfg.n_mels] + [cfg.postnet_embedding_dim] * (n - 1)
        dims_out = [cfg.postnet_embedding_dim] * (n - 1) + [cfg.n_mels]
        self.convs = nn.ModuleList(
            Conv1d(i, o, cfg.postnet_kernel_size)
            for i, o in zip(dims_in, dims_out))
        self.bns = nn.ModuleList(BatchNorm(o, cfg.batchnorm_eps)
                                 for o in dims_out)


def postnet_apply(post: Postnet, x: torch.Tensor) -> torch.Tensor:
    """x (B, n_mels, T) coarse mel -> residual (B, n_mels, T)."""
    n = len(post.convs)
    for i, (conv, bn) in enumerate(zip(post.convs, post.bns)):
        x = bn(conv(x))
        if i < n - 1:
            x = torch.tanh(x)
    return x
