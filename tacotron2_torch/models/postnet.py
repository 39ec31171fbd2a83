"""PostNet: 5 conv layers predicting a mel residual.

Counterpart of ``tacotron2_tpu/models/postnet.py``: 80 -> 512 -> 512 -> 512
-> 512 -> 80 channels, kernel 5, BatchNorm on every layer, tanh on all but
the last, dropout on every layer when training.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.convbn_kernel import conv_bn_act
from .layers import BatchNorm, Conv1d, dropout


class Postnet(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        n = cfg.postnet_n_convolutions
        dims_in = [cfg.n_mels] + [cfg.postnet_embedding_dim] * (n - 1)
        dims_out = [cfg.postnet_embedding_dim] * (n - 1) + [cfg.n_mels]
        self.convs = nn.ModuleList(
            Conv1d(i, o, cfg.postnet_kernel_size)
            for i, o in zip(dims_in, dims_out))
        self.bns = nn.ModuleList(
            BatchNorm(o, cfg.batchnorm_eps, cfg.batchnorm_momentum)
            for o in dims_out)
        self.p_dropout = cfg.p_postnet_dropout


def postnet_apply(post: Postnet, x: torch.Tensor, train: bool = False,
                  generator: Optional[torch.Generator] = None,
                  masks: Optional[Sequence[torch.Tensor]] = None
                  ) -> torch.Tensor:
    """x (B, n_mels, T) coarse mel -> residual (B, n_mels, T) fp32.

    Train mode uses batch statistics and drops out after every layer
    (masks drawn from ``generator``, or ``masks[i]`` for layer i); under
    low-precision weights the activations between layers stay in the weight
    dtype, while BatchNorm statistics are taken in fp32 and the residual
    comes out fp32.  Eval mode keeps fp32 between layers, and with
    ``cfg.fused_convbn`` runs each layer as one folded conv + BatchNorm +
    tanh (none on the last) (``ops/convbn_kernel.py``).
    """
    n = len(post.convs)
    if not train and post.cfg.fused_convbn:
        for i, (conv, bn) in enumerate(zip(post.convs, post.bns)):
            x = conv_bn_act(x, conv, bn, post.cfg.batchnorm_eps,
                            "tanh" if i < n - 1 else "none")
        return x
    cdt = post.convs[0].weight.dtype
    mid_dtype = cdt if (train and cdt != torch.float32) else None
    for i, (conv, bn) in enumerate(zip(post.convs, post.bns)):
        x = conv(x)
        if mid_dtype is not None and i < n - 1:
            x = x.to(mid_dtype)
        x = bn(x, train)
        if i < n - 1:
            x = torch.tanh(x)
        x = dropout(x, post.p_dropout, train, generator,
                    None if masks is None else masks[i])
    return x
