"""Weights from any checkpoint the port reads, for serving and training.

* the port's own checkpoint directories (``train/checkpoint.py`` writes
  them): ``train_state.pt``, a full training state, or ``weights.pt``, the
  ``state_dict`` alone;
* the JAX package's Orbax directories (``utils/orbax_reader.py``);
* a file holding the reference implementation's PyTorch checkpoint dict
  (``utils/torch_compat.py``).

:func:`checkpoint_kind` tells them apart by layout; :func:`load_weights`
fills a model from any of them.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from ..models.tacotron2 import Tacotron2
from .orbax_reader import (as_float32, is_orbax_checkpoint, map_leaves,
                           read_checkpoint)
from .torch_compat import is_reference_state_dict, load_reference_state_dict
from .weights import load_jax_params

FULL_FILE = "train_state.pt"
PARAMS_FILE = "weights.pt"


def load_file(path: str) -> Dict[str, Any]:
    """What ``torch.save`` wrote to ``path``, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def _file_dict(path: str) -> Optional[Dict[str, Any]]:
    """The dict of tensors a ``torch.save`` file holds (the reference's
    checkpoint keeps it under ``model_state_dict``); None where the file
    is not one."""
    try:
        obj = load_file(path)
    except Exception:    # torch.load raises many types on foreign bytes
        return None
    if not isinstance(obj, dict):
        return None
    sd = obj.get("model_state_dict", obj)
    return sd if isinstance(sd, dict) else None


def checkpoint_kind(path: str) -> str:
    """Classify a checkpoint by its layout, without reading its arrays:

    * ``"full"``: the port's full checkpoint directory;
    * ``"params_only"``: the port's params-only directory;
    * ``"orbax"``: an Orbax directory of the JAX package (its weights and
      BatchNorm statistics are read; optimizer state and counters are not);
    * ``"reference"``: a file holding the reference implementation's
      PyTorch checkpoint dict;
    * ``"unknown"``: anything else.
    """
    if os.path.isdir(path):
        if os.path.isfile(os.path.join(path, FULL_FILE)):
            return "full"
        if os.path.isfile(os.path.join(path, PARAMS_FILE)):
            return "params_only"
        if is_orbax_checkpoint(path):
            return "orbax"
        return "unknown"
    if os.path.isfile(path):
        sd = _file_dict(path)
        if sd is not None and is_reference_state_dict(sd):
            return "reference"
    return "unknown"


@torch.no_grad()
def load_weights(path: str, model: Tacotron2, kind: Optional[str] = None
                 ) -> Tacotron2:
    """Fill ``model`` in place from the weights and BatchNorm statistics
    of any checkpoint :func:`checkpoint_kind` knows, each tensor cast to
    the model's dtype (fp32 from a bf16 checkpoint)."""
    kind = kind or checkpoint_kind(path)
    if kind in ("full", "params_only"):
        name = FULL_FILE if kind == "full" else PARAMS_FILE
        model.load_state_dict(load_file(os.path.join(path, name))["model"],
                              strict=True)
        return model
    if kind == "orbax":
        return _load_orbax(path, model)
    if kind == "reference":
        return load_reference_state_dict(model, _file_dict(path))
    raise ValueError(f"{path!r} is not a checkpoint this port reads")


def _load_orbax(path: str, model: Tacotron2) -> Tacotron2:
    tree = read_checkpoint(path)
    params = map_leaves(as_float32, tree.get("params", {}))
    state = map_leaves(as_float32, tree.get("model_state", {}))
    n_speakers = model.cfg.n_speakers
    table = params.get("speaker", {}).get("embedding", {}).get("table")
    rows = 1 if table is None else int(table.shape[0])
    if rows != n_speakers:
        has = ("no speaker table" if table is None
               else f"a speaker table of {rows} rows")
        raise ValueError(f"could not load the Orbax checkpoint {path!r}: it "
                         f"has {has}, the config asks for "
                         f"n_speakers={n_speakers}")
    try:
        return load_jax_params(model, params, state)
    except (KeyError, IndexError, ValueError) as e:
        raise ValueError(f"could not load the Orbax checkpoint {path!r} "
                         f"into this config: {e}") from e
