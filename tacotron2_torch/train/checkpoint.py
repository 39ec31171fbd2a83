"""Checkpoints of the training loop.

Counterpart of ``tacotron2_tpu/train/checkpoint.py``, with ``torch.save``
in place of Orbax.  A checkpoint is a directory, named as the JAX loop
names them (``tacotron2_epoch_N``, ``best_model``, ``step_N``,
``debug_export/overfit_model``), holding one file:

* ``train_state.pt``, a full checkpoint: the model's ``state_dict``
  (fp32 masters and BatchNorm statistics), the Adam moments and update
  count, ``step``, ``loss_step``, the dropout generator's state, ``epoch``
  and ``best_val_mel``;
* ``weights.pt``, a params-only checkpoint: the ``state_dict`` alone.

Tensors are saved from the CPU, so a checkpoint loads on any device.
Each save writes a temporary file beside the final one and ``os.replace``
s it, so a save that is cut off leaves the checkpoint before it whole.

:func:`load_any_checkpoint` also reads the JAX package's Orbax directories
and a file holding the reference implementation's PyTorch checkpoint dict,
their weights only (``utils/weight_files.py``, which serving shares).
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..models.tacotron2 import Tacotron2
from ..utils.weight_files import (FULL_FILE, PARAMS_FILE, checkpoint_kind,
                                  load_file, load_weights)
from .state import TrainState

def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _save(obj: Dict[str, Any], directory: str, name: str) -> None:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, name)
    tmp = f"{final}.tmp{os.getpid()}"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    best_val_mel: float) -> None:
    """Save a full training checkpoint into the directory ``path``."""
    opt = state.opt_state
    _save({"model": _cpu(state.model.state_dict()),
           "opt_state": {"count": int(opt["count"]), "mu": _cpu(opt["mu"]),
                         "nu": _cpu(opt["nu"])},
           "step": int(state.step), "loss_step": int(state.loss_step),
           "generator": state.generator.get_state(),
           "epoch": int(epoch), "best_val_mel": float(best_val_mel)},
          path, FULL_FILE)


@torch.no_grad()
def restore_checkpoint(path: str, template: TrainState
                       ) -> Tuple[TrainState, int, float]:
    """Restore a full checkpoint into ``template`` (a fresh state of the
    same architecture, on the device to train on), in place; returns
    (state, epoch, best_val_mel)."""
    saved = load_file(os.path.join(path, FULL_FILE))
    template.model.load_state_dict(saved["model"], strict=True)
    opt = template.opt_state
    for moment in ("mu", "nu"):
        if set(saved["opt_state"][moment]) != set(opt[moment]):
            raise ValueError(f"{path}: the optimizer's {moment} does not "
                             "match the model's parameters")
        for name, t in opt[moment].items():
            t.copy_(saved["opt_state"][moment][name])
    opt["count"] = int(saved["opt_state"]["count"])
    template.step = int(saved["step"])
    template.loss_step = int(saved["loss_step"])
    template.generator.set_state(saved["generator"])
    return template, int(saved["epoch"]), float(saved["best_val_mel"])


def save_params_only(path: str, model: Tacotron2) -> None:
    """Weights and BatchNorm statistics only, into the directory
    ``path`` (the reference's debug export saves a bare ``state_dict``)."""
    _save({"model": _cpu(model.state_dict())}, path, PARAMS_FILE)


@torch.no_grad()
def restore_params_only(path: str, model: Tacotron2) -> Tacotron2:
    """Fill ``model`` in place from a params-only checkpoint of the port,
    each tensor cast to the model's dtype."""
    return load_weights(path, model, "params_only")


def load_any_checkpoint(path: str, template: TrainState
                        ) -> Tuple[Optional[TrainState], int, float]:
    """Load a full or a params-only checkpoint into ``template``.

    A full checkpoint restores the model, the moments, the counters and
    the generator: returns (state, epoch, best_val_mel).  Any other kind
    loads the weights and BatchNorm statistics into ``template.model``
    and returns (None, 0, inf): resuming from it restarts the moments,
    the epoch counter and best-val tracking (``train._resume`` warns).
    An unknown layout is tried as both, and the error names both
    failures."""
    kind = checkpoint_kind(path)
    if kind == "full":
        return restore_checkpoint(path, template)
    if kind != "unknown":
        load_weights(path, template.model, kind)
        return None, 0, math.inf
    try:
        return restore_checkpoint(path, template)
    except Exception as full_err:
        try:
            restore_params_only(path, template.model)
            return None, 0, math.inf
        except Exception as params_err:
            raise RuntimeError(
                f"could not load checkpoint {path!r} as a full training "
                f"state ({type(full_err).__name__}: {full_err}) or as "
                f"params-only ({type(params_err).__name__}: {params_err})"
            ) from params_err
