"""Layers of the port, with the JAX package's dtype policy.

Counterpart of ``tacotron2_tpu/models/layers.py``.  Every matrix product
casts its input to the weight dtype and accumulates and returns fp32; with
bf16 weights that is "bf16 inputs, fp32 sum", written here as an fp32
product of bf16-rounded values so that the result is never rounded back to
bf16.  The LSTM cell state stays fp32.  Weight layouts are PyTorch's:
linear ``(out, in)``, LSTM ``(4H, in)`` in gate order i, f, g, o, conv
``(out, in, k)``; ``utils/weights.py`` transposes the JAX package's
``(in, out)`` layouts on load.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum_grad, is_distributed


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T (+ bias)`` in fp32 from weight-dtype inputs."""
    y = torch.matmul(x.to(weight.dtype).float(), weight.float().t())
    if bias is not None:
        y = y + bias.float()
    return y


def conv1d_same(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, C_in, T) -> (B, C_out, T) fp32 with 'same' padding
    ``((k-1)//2, k//2)``.  Low-precision weights convolve in their own
    dtype and the result is upcast, as the JAX package does."""
    k = weight.shape[-1]
    x = F.pad(x.to(weight.dtype), ((k - 1) // 2, k // 2))
    y = F.conv1d(x, weight).float()
    if bias is not None:
        y = y + bias.float()[None, :, None]
    return y


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_dim, in_dim))
        self.bias = nn.Parameter(torch.empty(out_dim)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


class Conv1d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1d_same(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, n: int, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n, dim))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight)


class BatchNorm(nn.Module):
    """BatchNorm over (B, C, T).

    Eval mode normalises with the running statistics.  Train mode
    (``train=True``) normalises with the batch's statistics over batch and
    time (one-pass fp32 moments, biased variance clamped at 0) and updates
    the running statistics in place with the unbiased variance.  Under a
    data-parallel group the moments are the global batch's: ``sum x``,
    ``sum x^2`` and the count are summed over the ranks, whose backward
    sums too (``parallel/collectives.py::all_reduce_sum_grad``), and the
    running statistics take the global count in the unbiased factor."""

    def __init__(self, ch: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            xf = x.float()
            if is_distributed():
                n_local = x.shape[0] * x.shape[2]
                moments = all_reduce_sum_grad(torch.stack([
                    xf.sum(dim=(0, 2)), xf.square().sum(dim=(0, 2)),
                    xf.new_full((x.shape[1],), float(n_local))]))
                n = moments[2].detach()
                mean = moments[0] / n
                var = (moments[1] / n - mean * mean).clamp_min(0.0)
                unbiased = n / (n - 1).clamp_min(1.0)
            else:
                mean = xf.mean(dim=(0, 2))
                var = (xf.square().mean(dim=(0, 2))
                       - mean * mean).clamp_min(0.0)
                n = x.shape[0] * x.shape[2]
                unbiased = n / max(n - 1, 1)
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var.float() + self.eps)
        y = ((x - mean[None, :, None]) * (inv * self.weight)[None, :, None]
             + self.bias[None, :, None])
        return y.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverted dropout; identity when not training or ``rate == 0``.
    ``mask`` (0/1 or bool, x's shape, True = keep) is used where given,
    else one is drawn from ``generator``, which lies on x's device."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if mask is None:
        if generator is None:
            raise ValueError("dropout in train mode needs a generator or a "
                             "mask")
        mask = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class LSTMCell(nn.Module):
    """LSTM cell, gate order i, f, g, o; ``bias_ih + bias_hh`` summed."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.hidden = hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * hidden, in_dim))
        self.weight_hh = nn.Parameter(torch.empty(4 * hidden, hidden))
        self.bias_ih = nn.Parameter(torch.empty(4 * hidden))
        self.bias_hh = nn.Parameter(torch.empty(4 * hidden))

    def gates(self, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """Pre-activation gates (B, 4H), fp32."""
        return (linear(x, self.weight_ih) + linear(h, self.weight_hh)
                + self.bias_ih.float() + self.bias_hh.float())

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        i, f, g, o = self.gates(x, h).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, c_new


class BiLSTM(nn.Module):
    """Bidirectional LSTM over the full padded length (unpacked, as the
    reference feeds padded batches to ``nn.LSTM``), written as a loop over
    the cell so that the dtype policy is the cell's."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.fwd = LSTMCell(in_dim, hidden)
        self.bwd = LSTMCell(in_dim, hidden)

    @staticmethod
    def _scan(cell: LSTMCell, xs: torch.Tensor, reverse: bool
              ) -> torch.Tensor:
        b, t, _ = xs.shape
        h = xs.new_zeros(b, cell.hidden)
        c = xs.new_zeros(b, cell.hidden)
        out = [None] * t
        for i in (range(t - 1, -1, -1) if reverse else range(t)):
            h, c = cell(xs[:, i], h, c)
            out[i] = h
        return torch.stack(out, dim=1)

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        """(B, T, in) -> (B, T, 2H)."""
        return torch.cat([self._scan(self.fwd, xs, False),
                          self._scan(self.bwd, xs, True)], dim=-1)
