"""Train state.

Counterpart of ``tacotron2_tpu/train/state.py``: everything a training step
reads and changes, in one object: the model (fp32 master weights and the
BatchNorm running statistics), the optimizer state, the two counters and
the generator that draws the dropout masks.  A step updates it in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from ..config import Config
from ..models.tacotron2 import Tacotron2, init_weights
from ..utils.device import resolve_device
from .optim import Optimizer, make_optimizer


@dataclasses.dataclass
class TrainState:
    model: Tacotron2                 # fp32 masters + BatchNorm statistics
    opt_state: Dict[str, object]     # Adam moments and update count
    step: int                        # optimizer steps taken
    loss_step: int                   # criterion evaluations
    generator: torch.Generator       # dropout draws, on the model's device


def create_train_state(cfg: Config, seed: Optional[int] = None,
                       debug: bool = False, tx: Optional[Optimizer] = None,
                       device: Union[str, torch.device] = "cuda"
                       ) -> TrainState:
    """Fresh state on ``device``: weights drawn from ``seed`` (default
    ``cfg.train.seed``) on the CPU and moved, zero moments, a generator
    seeded with ``seed + 1``.  Pass the optimizer ``tx`` that will drive
    training; when omitted an equivalent one is built."""
    device = resolve_device(device)
    seed = cfg.train.seed if seed is None else seed
    model = init_weights(Tacotron2(cfg.model), seed=seed).to(device)
    if tx is None:
        tx = make_optimizer(cfg.train, debug=debug)
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(model=model, opt_state=tx.init(model), step=0,
                      loss_step=0, generator=generator)
