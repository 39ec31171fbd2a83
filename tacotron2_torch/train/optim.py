"""Optimizer: Adam with an attention learning-rate group and milestone decay.

Counterpart of ``tacotron2_tpu/train/optim.py``, which builds it from optax:

  * global-norm gradient clipping at ``max_grad_norm`` before Adam;
  * Adam (betas 0.9 / 0.999, eps 1e-8) in optax's form, written out by
    hand so that it does not depend on ``torch.optim.Adam``'s choices:
    ``m_hat = m / (1 - b1^n)``, ``v_hat = v / (1 - b2^n)``, update
    ``-lr * m_hat / (sqrt(v_hat) + eps)``: eps is added after the bias
    correction, outside the square root;
  * attention parameters (everything under ``decoder.attention``) train at
    ``lr x attention_lr_multiplier`` (the debug multiplier in debug mode);
  * step-milestone decay: lr *= gamma after steps {50k, 100k, 150k}; the
    learning rate of an update is read at the count of updates made before
    it, and the boundary sits at ``m + 1``, so the milestone step itself
    still uses the old rate.

A parameter that got no gradient counts as a zero gradient, as it does in
the JAX package (its moments decay and it may still move).

Under tensor parallelism a rank holds the gradients of its shards and of
the replicated parameters; the clip's norm is the whole gradient's, as
optax's ``clip_by_global_norm`` reads it on the global arrays: the shards'
squares summed over the model group, plus the replicated parameters'
squares counted once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Sequence

import torch
from torch import nn

from ..config import TrainConfig
from ..parallel.collectives import model_axis_sum

ATTENTION_PREFIX = "decoder.attention."


def milestone_schedule(base_lr: float, milestones: Sequence[int],
                       gamma: float) -> Callable[[int], float]:
    """lr(count) = base * gamma^|{m in milestones : m < count}|."""
    bounds = sorted(int(m) + 1 for m in milestones)

    def schedule(count: int) -> float:
        lr = base_lr
        for bound in bounds:
            if count >= bound:
                lr = lr * gamma
        return lr

    return schedule


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Clip by global norm, then two-group Adam.  The state is a dict
    ``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}`` with fp32
    moments shaped like the model's parameters."""
    base_schedule: Callable[[int], float]
    attention_schedule: Callable[[int], float]
    max_grad_norm: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, model: nn.Module) -> Dict[str, object]:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)
                         for n, p in model.named_parameters()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, model: nn.Module, opt_state: Dict[str, object],
               grads: Dict[str, torch.Tensor],
               sharded: FrozenSet[str] = frozenset()) -> None:
        """One optimizer step, in place on the parameters and on
        ``opt_state``.  ``grads`` maps parameter names to gradients; a
        missing gradient is zero.  ``sharded`` names the parameters this
        rank holds a model-axis shard of (``parallel/mesh.py::
        sharded_names``); their squares are summed over the model group
        for the clip's norm."""
        names, params, gs = [], [], []
        for n, p in model.named_parameters():
            g = grads.get(n)
            names.append(n)
            params.append(p)
            gs.append(torch.zeros_like(p, dtype=torch.float32) if g is None
                      else g.float())
        if sharded:
            squares = [g.square().sum() for g in gs]
            g_norm = torch.sqrt(
                model_axis_sum(sum(q for n, q in zip(names, squares)
                                   if n in sharded))
                + sum(q for n, q in zip(names, squares) if n not in sharded))
        else:
            g_norm = torch.sqrt(sum(g.square().sum() for g in gs))
        within = g_norm < self.max_grad_norm
        count = int(opt_state["count"])
        n = count + 1
        bc1 = 1.0 - self.b1 ** n
        bc2 = 1.0 - self.b2 ** n
        lrs = (self.base_schedule(count), self.attention_schedule(count))
        for name, p, g in zip(names, params, gs):
            # clip_by_global_norm: g if norm < max else g / norm * max
            g = torch.where(within, g, g / g_norm * self.max_grad_norm)
            mu, nu = opt_state["mu"][name], opt_state["nu"][name]
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            lr = lrs[1] if name.startswith(ATTENTION_PREFIX) else lrs[0]
            step = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(step.to(p.dtype), alpha=-lr)
        opt_state["count"] = n


def make_optimizer(cfg: TrainConfig, debug: bool = False) -> Optimizer:
    mult = (cfg.debug_attention_lr_multiplier if debug
            else cfg.attention_lr_multiplier)
    return Optimizer(
        base_schedule=milestone_schedule(
            cfg.learning_rate, cfg.lr_decay_milestones, cfg.lr_decay_gamma),
        attention_schedule=milestone_schedule(
            cfg.learning_rate * mult, cfg.lr_decay_milestones,
            cfg.lr_decay_gamma),
        max_grad_norm=cfg.max_grad_norm)
