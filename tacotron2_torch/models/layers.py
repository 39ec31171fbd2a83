"""Layers of the port, with the JAX package's dtype policy.

Counterpart of ``tacotron2_tpu/models/layers.py``.  Every matrix product
casts its input to the weight dtype and accumulates and returns fp32; with
bf16 weights that is "bf16 inputs, fp32 sum", written here as an fp32
product of bf16-rounded values so that the result is never rounded back to
bf16.  The LSTM cell state stays fp32.  Weight layouts are PyTorch's:
linear ``(out, in)``, LSTM ``(4H, in)`` in gate order i, f, g, o, conv
``(out, in, k)``; ``utils/weights.py`` transposes the JAX package's
``(in, out)`` layouts on load.

:func:`lstm_cell_on_axis` and :func:`linear_on_axis` run the decoder's two
LSTM cells and its fused heads over the decoder's model axis
(``parallel/model_axis.py``): under tensor parallelism (``parallel/
mesh.py``) each shard multiplies by its own weights only and the axis
gathers the gate slices or sums the partial head products; on an
unsharded decoder the axis is one shard and the four are identities.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum_grad, is_distributed
from .graphs import GraphCache


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
        return lstm_gates(x, h, self.weight_ih, self.weight_hh,
                          self.bias_ih, self.bias_hh)

    def forward(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return lstm_update(self.gates(x, h), c)


def lstm_gates(x: torch.Tensor, h: torch.Tensor, weight_ih: torch.Tensor,
               weight_hh: torch.Tensor, bias_ih: torch.Tensor,
               bias_hh: torch.Tensor) -> torch.Tensor:
    """:class:`LSTMCell`'s pre-activation gates (B, 4H), fp32, from its four
    tensors given explicitly."""
    return (linear(x, weight_ih) + linear(h, weight_hh)
            + bias_ih.float() + bias_hh.float())


def lstm_update(gates: torch.Tensor, c: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cell's new (h, c) from its pre-activation gates (B, 4H)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_scan(xs: torch.Tensor, weight_ih: torch.Tensor,
              weight_hh: torch.Tensor, bias_ih: torch.Tensor,
              bias_hh: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One direction of :class:`BiLSTM`: the cell stepped over (B, T, in)
    from zero state, last step first where ``reverse``; (B, T, H)."""
    b, t, _ = xs.shape
    h = xs.new_zeros(b, weight_hh.shape[1])
    c = xs.new_zeros(b, weight_hh.shape[1])
    out = [None] * t
    for i in (range(t - 1, -1, -1) if reverse else range(t)):
        h, c = lstm_update(lstm_gates(xs[:, i], h, weight_ih, weight_hh,
                                      bias_ih, bias_hh), c)
        out[i] = h
    return torch.stack(out, dim=1)


def bilstm_scan(xs: torch.Tensor, *weights: torch.Tensor) -> torch.Tensor:
    """:class:`BiLSTM` as a function of its input and its eight tensors
    (:meth:`BiLSTM.weights`' order): (B, T, in) -> (B, T, 2H)."""
    return torch.cat([lstm_scan(xs, *weights[:4], reverse=False),
                      lstm_scan(xs, *weights[4:], reverse=True)], dim=-1)


class BiLSTM(nn.Module):
    """Bidirectional LSTM over the full padded length (unpacked, as the
    reference feeds padded batches to ``nn.LSTM``), written as a loop over
    the cell so that the dtype policy is the cell's.

    On the CPU the loop runs eagerly.  On a CUDA device it is
    :func:`bilstm_scan` captured as CUDA graphs, one forward (and, where a
    gradient is wanted, one backward) a shape, at the shape's first call,
    and replayed (``models/graphs.py``): the same operations in the same
    order, so the same bits, for one launch where the loop makes about 25
    a step each way (and as many again in its backward)."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.fwd = LSTMCell(in_dim, hidden)
        self.bwd = LSTMCell(in_dim, hidden)
        self.graphs = GraphCache(bilstm_scan, "encoder")

    def weights(self) -> Tuple[torch.Tensor, ...]:
        """The eight tensors :func:`bilstm_scan` takes: each direction's
        ``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh``, forward
        first (under ``torch.func.functional_call``, the stand-ins)."""
        return tuple(getattr(cell, n) for cell in (self.fwd, self.bwd)
                     for n in ("weight_ih", "weight_hh", "bias_ih",
                               "bias_hh"))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        """(B, T, in) -> (B, T, 2H)."""
        if xs.is_cuda:
            return self.graphs(xs, *self.weights())
        return bilstm_scan(xs, *self.weights())


def lstm_cell_on_axis(cell: LSTMCell, names: Sequence[str], axis,
                      x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:class:`LSTMCell`'s step with its four tensors split on the 4H gate
    axis over ``axis``: each shard's gate slice from its own weights, the
    slices gathered in model order (i, f, g, o whole again), the cell
    replicated.  ``names`` are the cell's four sharded tensors
    (``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh``).  On an
    unsharded axis this is ``cell(x, h, c)``, operation for operation."""
    local = (cell.weight_ih, cell.weight_hh, cell.bias_ih, cell.bias_hh)
    parts = [linear(xm, wi) + linear(hm, wh) + bi.float() + bh.float()
             for (wi, wh, bi, bh), (xm, hm) in zip(axis.shards(names, local),
                                                   axis.copy_in(x, h))]
    return lstm_update(axis.gather_out(parts), c)


def linear_on_axis(weights: Tuple[torch.Tensor, ...], names: Sequence[str],
                   axis, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x @ cat(weights).T + bias`` with the weights (``(out_i, in)``
    each, stacked on ``out``) split on their input axis over ``axis``:
    each shard's partial product on its slice of ``x``, the partials
    summed, then the replicated bias.  On an unsharded axis this is
    ``linear(x, cat(weights), bias)``, operation for operation."""
    parts = [linear(xm, torch.cat(ws, dim=0))
             for ws, xm in zip(axis.shards(names, weights), axis.split_in(x))]
    return axis.reduce_out(parts) + bias.float()
