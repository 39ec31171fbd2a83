#!/usr/bin/env python3
"""Training-step scaling of the PyTorch port: ms a step and frames a second
at given batch sizes, on one CUDA card.

The counterpart of ``tools/bench_train_scaling.py``, with its batch list
(default 16,128) plus ``--iters``, ``--t_enc``, ``--t_dec`` and
``--device``.  Each batch size runs with the split-BPTT decoder backward
(``ModelConfig.decoder_split_bptt``) on and off: on, ``train_step`` runs
the teacher-forced forward and the reverse chain as the two kernels of
``ops/decoder_train_kernel.py`` and ``ops/decoder_bwd_kernel.py``; off,
``torch.autograd`` runs through the plain step loop.  As in the JAX tool
the batch is put on the device before the clock starts (the training
loop's prefetch overlaps that with compute), and the clock stops after a
synchronise.  A configuration that fails prints ``FAILED`` and the sweep
goes on.

    python tools/bench_train_scaling_torch.py 16,128 [--iters 5]

Full ``Config()`` (bf16 compute over fp32 masters), seeded weights
(``create_train_state(seed=0)``), random token ids and log-mels from
``numpy.random.default_rng(0)``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))   # runnable from any cwd

import torch  # noqa: E402


def log_line(msg: str) -> None:
    print(msg, flush=True)


def make_batch(rng: np.random.Generator, b: int, t_enc: int, t_dec: int,
               n_mels: int = 80) -> Dict[str, np.ndarray]:
    """The JAX tool's batch: full-length random token ids and log-mels."""
    return {
        "text": rng.integers(1, 72, (b, t_enc)).astype(np.int32),
        "text_lengths": np.full((b,), t_enc, np.int32),
        "mel": rng.standard_normal((b, n_mels, t_dec)).astype(np.float32)
        - 5.0,
        "mel_lengths": np.full((b,), t_dec, np.int32),
        "speaker_ids": np.zeros((b,), np.int32),
    }


def stage(batch: Dict[str, np.ndarray], device: torch.device
          ) -> Dict[str, torch.Tensor]:
    """The batch as tensors on ``device``, there before this returns."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def split_config(cfg, split: bool):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, decoder_split_bptt=split))


def measure(split: bool, b: int, device: torch.device, t_enc: int = 128,
            t_dec: int = 512, iters: int = 5, cfg=None, state=None,
            rng: Optional[np.random.Generator] = None,
            log: Callable[[str], None] = log_line) -> Dict:
    """One configuration: a first step (untimed), then ``iters`` timed
    steps on freshly staged batches.  ``cfg`` defaults to ``Config()`` and
    ``state`` to ``create_train_state(cfg, seed=0)``; either way
    ``decoder_split_bptt`` is set to ``split``.  Returns the record: the
    first step's losses, the least and median step time, frames a second
    at the least time, and the last step's total loss."""
    from tacotron2_torch.config import Config
    from tacotron2_torch.models.tacotron2 import replace_config
    from tacotron2_torch.train.optim import make_optimizer
    from tacotron2_torch.train.state import create_train_state
    from tacotron2_torch.train.step import train_step

    cfg = split_config(cfg or Config(), split)
    rng = rng or np.random.default_rng(0)
    tx = make_optimizer(cfg.train)
    if state is None:
        state = create_train_state(cfg, seed=0, tx=tx, device=device)
    replace_config(state.model, decoder_split_bptt=split)
    sigma = cfg.guided_attention.sigma_warmup_steps
    n_mels = cfg.model.n_mels
    sync = ((lambda: torch.cuda.synchronize(device))
            if device.type == "cuda" else (lambda: None))

    t0 = time.perf_counter()
    state, losses0, _ = train_step(state, make_batch(rng, b, t_enc, t_dec,
                                                     n_mels),
                                   cfg=cfg, tx=tx, use_postnet=True,
                                   sigma_warmup_steps=sigma)
    l0 = float(losses0.total)
    log(f"  split={split} B={b}: first step {time.perf_counter() - t0:.1f}s "
        f"loss {l0:.4f}")
    walls = []
    for _ in range(iters):
        tb = stage(make_batch(rng, b, t_enc, t_dec, n_mels), device)
        t0 = time.perf_counter()
        state, losses, _ = train_step(state, tb, cfg=cfg, tx=tx,
                                      use_postnet=True,
                                      sigma_warmup_steps=sigma)
        sync()
        walls.append(time.perf_counter() - t0)
        float(losses.total)
    w = float(np.min(walls))
    fps = b * t_dec / w
    log(f"  split={split} B={b}: {w * 1000:.1f} ms/step = {fps / 1000:.1f}k "
        f"frames/s (median {np.median(walls) * 1000:.1f} ms) "
        f"loss {float(losses.total):.4f}")
    return dict(split=split, b=b, t_enc=t_enc, t_dec=t_dec,
                first_losses={k: float(v)
                              for k, v in losses0._asdict().items()},
                ms_per_step=w * 1e3,
                median_ms=float(np.median(walls)) * 1e3,
                frames_per_s=fps, last_loss=float(losses.total))


def main(argv: Optional[Sequence[str]] = None,
         log: Callable[[str], None] = log_line) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batches", nargs="?", default="16,128",
                    help="comma-separated batch sizes")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--t_enc", type=int, default=128)
    ap.add_argument("--t_dec", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from tacotron2_torch.utils.device import resolve_device
    device = resolve_device(args.device)
    log("device: " + (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"))
    records = []
    for b in (int(x) for x in args.batches.split(",")):
        for split in (False, True):
            try:
                records.append(measure(split, b, device, args.t_enc,
                                       args.t_dec, args.iters, log=log))
            except Exception as e:  # the JAX tool's report: FAILED, go on
                log(f"  split={split} B={b}: FAILED {type(e).__name__}: "
                    f"{str(e)[:300]}")
                records.append(dict(split=split, b=b, failed=repr(e)))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return records


if __name__ == "__main__":
    main()
