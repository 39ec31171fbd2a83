"""Training driver: epochs, validation, checkpoints, debug-overfit mode.

Counterpart of ``tacotron2_tpu/train/loop.py``, with the same observable
behaviour on one device:

  * the postnet bypassed for the first ``postnet_freeze_steps`` steps;
  * a console line every 200 steps and ``training_log.txt``;
  * three checkpoint cadences: every ``save_every_steps`` steps, every
    epoch (the newest ``keep_epoch_ckpts`` of this run kept) and on the
    best validation mel;
  * validation: teacher-forced mel and gate loss and attention entropy;
  * an alignment heatmap PNG per epoch;
  * debug-overfit mode: one batch of ``debug_batch_size``, success when
    mel L1 < ``debug_success_mel_l1``, a heatmap every 10 iterations, then
    the model, the batch and autoregressive inference artifacts exported.

Data parallelism: launched as ``torchrun --nproc_per_node N train_torch.py
...``, each rank trains on its card (``cuda:LOCAL_RANK``; ranks that share
a card use gloo, ``parallel/distributed.py``) on its own rows of every
global batch of ``batch_size * N`` (the loader is process-sharded), and
every step is the one a single process takes on the whole global batch
(``train/step.py``).  Rank 0 alone writes the log, the checkpoints and the
plots; the others wait for each save and resume from the same files.
``--debug`` stays on rank 0 alone while the others wait.  The JAX loop
also drives several chips from one process; PyTorch runs one process per
card, so without torchrun the port trains on the one device it is given,
however many cards are visible.

Tensor parallelism (``tensor_parallel=N``, ``train_torch.py --tp N``
under ``torchrun --nproc_per_node D*N``): the ranks form a ``data=D`` x
``model=N`` grid (``parallel/distributed.py::init_tensor_parallel``),
each rank keeps its shard of the decoder's LSTM gates and output heads
and of their Adam moments (``parallel/mesh.py``), and the step is still
the one a single process takes on the global batch, as GSPMD's is.  The
global micro-batch stays ``batch_size`` times the number of processes, as
in the JAX loop, so ``--tp`` changes where the products run and not the
step: each data index loads ``batch_size * N`` rows, which its N model
peers share.  A save gathers the shards (every rank takes part) and rank 0
writes a checkpoint of the unsharded layout, which any ``--tp``, one
process and ``load_model`` read; a resume re-shards it.

Decoder rematerialisation (``remat``, ``train_torch.py --remat``) runs
each step of the decoder's step loop inside ``torch.utils.checkpoint``
(``models/decoder.py::decoder_teacher_forced``), as the JAX loop's
``jax.checkpoint``; it turns the split BPTT off.

Where the port differs: a full checkpoint records the epochs
completed, and a run resumed from an epoch's or the best checkpoint
starts at the next epoch with the data order an unbroken run would have
had (:meth:`BatchLoader.skip_epochs`); the JAX loop stores the index of
the epoch that just ended and runs it again on resume.
"""

from __future__ import annotations

import csv
import dataclasses
import math
import os
import shutil
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..config import Config
from ..data.dataset import BatchLoader, TextMelDataset, collate
from ..dsp.wav import save_wav
from ..models.tacotron2 import init_projection_bias, tacotron2_infer
from ..parallel.collectives import (barrier, broadcast_object, local_only,
                                    rank, world_rank, world_size)
from ..parallel.distributed import (init_tensor_parallel,
                                    initialize_distributed, rank_device)
from ..parallel.mesh import gather_train_state, shard_train_state
from ..text import sequence_to_text
from ..utils.device import resolve_device
from ..utils.logging import TrainingLogger
from ..utils.plotting import save_alignment_plot
from ..utils.profiling import StepTimer
from .checkpoint import load_any_checkpoint, save_checkpoint, save_params_only
from .loss import LossOutput
from .optim import make_optimizer
from .state import TrainState, create_train_state
from .step import compute_dtype_of, eval_step, train_step, train_step_accum


def _fmt_losses(losses: LossOutput) -> str:
    return (f"Mel {float(losses.mel):.4f} Gate {float(losses.gate):.4f} "
            f"KL {float(losses.attention_kl):.4f} "
            f"w {float(losses.attention_weight):.2f} "
            f"σ {float(losses.sigma):.2f}")


def validate(state: TrainState, loader: BatchLoader, cfg: Config,
             sigma_warmup_steps: int) -> Dict[str, float]:
    """Mean validation mel and gate loss and attention entropy."""
    total_mel = total_gate = total_ent = 0.0
    count = 0
    for batch in loader:
        losses, _, entropy = eval_step(state, batch, cfg=cfg,
                                       sigma_warmup_steps=sigma_warmup_steps)
        total_mel += float(losses.mel)
        total_gate += float(losses.gate)
        total_ent += float(entropy)
        count += 1
    if count == 0:
        return {"mel": float("nan"), "gate": float("nan"), "entropy": 0.0,
                "batches": 0}
    return {"mel": total_mel / count, "gate": total_gate / count,
            "entropy": total_ent / count, "batches": count}


def export_debug_inference(state: TrainState, batch: Dict[str, np.ndarray],
                           cfg: Config, export_dir: str) -> None:
    """Autoregressive inference on the overfit batch and its artifacts:
    alignment PNG, per-sample gate-trimmed mels, phoneme text, Griffin-Lim
    WAV, ``pairs.csv``."""
    os.makedirs(export_dir, exist_ok=True)
    device = next(state.model.parameters()).device
    max_len_cap = int(batch["mel_lengths"].max() * 1.10)
    out, n_frames, _ = tacotron2_infer(
        state.model, batch["text"],
        max_steps=min(cfg.model.max_decoder_steps, max_len_cap),
        device=device)
    n = int(n_frames)
    mel_post = out.mel_postnet[:, :n].float().cpu().numpy()  # (B, T, n_mels)
    gates = torch.sigmoid(out.gate_logits[:, :n]).float().cpu().numpy()
    alignments = out.alignments[:, :n].float().cpu().numpy()

    align_path = os.path.join(export_dir, "debug_infer_alignment.png")
    save_alignment_plot(alignments, align_path)
    print(f"Inference alignment saved: {align_path}")

    from ..infer.vocode import GriffinLim, vocode_mel
    rows = []
    for b in range(mel_post.shape[0]):
        stops = np.nonzero(gates[b] > 0.5)[0]
        end = (int(batch["mel_lengths"][b]) if len(stops) == 0
               else int(stops[0]) + 1)
        mel_b = mel_post[b, :end]                          # (T_trim, n_mels)
        mel_file = f"debug_infer_mel_{b}.npy"
        np.save(os.path.join(export_dir, mel_file), mel_b)

        length = int(batch["text_lengths"][b])
        txt_file = f"sample_{b}.txt"
        with open(os.path.join(export_dir, txt_file), "w",
                  encoding="utf-8") as f:
            f.write(sequence_to_text(batch["text"][b][:length]) + "\n")

        wav_file = f"debug_infer_{b}.wav"
        save_wav(os.path.join(export_dir, wav_file),
                 vocode_mel(mel_b, cfg.audio, GriffinLim(cfg.audio),
                            device=device),
                 cfg.audio.sampling_rate)
        rows.append({"sample_index": b, "text_file": txt_file,
                     "mel_file": mel_file, "wav_file": wav_file})

    pairs = os.path.join(export_dir, "pairs.csv")
    with open(pairs, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["sample_index", "text_file",
                                          "mel_file", "wav_file"])
        w.writeheader()
        w.writerows(rows)
    print(f"Paired metadata written: {pairs}")


def tensor_parallel_grid(n_devices: int, tp: int,
                         global_micro_batch: int) -> int:
    """The ``data`` axis's width of a grid of ``n_devices`` with ``tp``
    along ``model``; raises, in the JAX loop's words, when ``tp`` does not
    divide the devices or the global micro-batch does not split over the
    data axis (the port's loop hands it ``batch_size`` times the number of
    processes, which always does)."""
    if n_devices % tp:
        raise RuntimeError(f"--tp {tp} does not divide the "
                           f"{n_devices} visible devices")
    n_data = n_devices // tp
    if global_micro_batch % n_data:
        raise RuntimeError(
            f"global batch {global_micro_batch} not divisible by the "
            f"data-axis width {n_data} (= {n_devices} devices / tp {tp}) — "
            f"adjust --batch_size or --tp")
    return n_data


def train(metadata_path: str, checkpoint_dir: str, *,
          cfg: Optional[Config] = None, epochs: Optional[int] = None,
          batch_size: Optional[int] = None,
          learning_rate: Optional[float] = None,
          debug_overfit: bool = False, val_metadata: Optional[str] = None,
          resume: Optional[str] = None,
          postnet_freeze_steps_override: Optional[int] = None,
          accum_steps: int = 1,
          precision: Optional[str] = None,
          remat: Optional[str] = None,
          tensor_parallel: int = 1,
          keep_epoch_ckpts: Optional[int] = None,
          device: Union[str, torch.device] = "cuda") -> TrainState:
    """Main training routine on ``device`` (under a process group, this
    rank's card); the arguments are those of
    ``tacotron2_tpu/train/loop.py::train``.  ``remat``: None keeps the
    config; "off" turns decoder-step rematerialisation off; "full" or
    "dots" turns it on with that policy (``ModelConfig.
    decoder_remat_policy``), for batches whose decoder activations
    overflow the card's memory.  Returns the final state (under tensor
    parallelism, this rank's shards)."""
    cfg = cfg or Config()
    if precision is not None:
        precision = {"bf16": "bfloat16", "fp32": "float32"}.get(precision,
                                                                precision)
    if (learning_rate is not None or batch_size is not None
            or epochs is not None or precision is not None):
        tr = dataclasses.replace(
            cfg.train,
            **({"learning_rate": learning_rate} if learning_rate else {}),
            **({"batch_size": batch_size} if batch_size else {}),
            **({"epochs": epochs} if epochs else {}),
            **({"precision": precision} if precision else {}))
        cfg = dataclasses.replace(cfg, train=tr)
    if remat is not None:
        if remat not in ("off", "full", "dots"):
            raise ValueError(f"remat must be 'off', 'full', or 'dots'; "
                             f"got {remat!r}")
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat_decoder_step=remat != "off",
            **({} if remat == "off" else {"decoder_remat_policy": remat})))
    compute_dtype_of(cfg.train.precision)   # validate before any work
    # the process group first (a no-op without torchrun's WORLD_SIZE)
    initialize_distributed(
        backend="gloo" if torch.device(device).type == "cpu" else None)
    world, is_lead = world_size(), world_rank() == 0
    tp = max(1, tensor_parallel)
    device = resolve_device(rank_device(device))

    os.makedirs(checkpoint_dir, exist_ok=True)
    # the ranks share checkpoint_dir: only rank 0 writes the log file
    logger = TrainingLogger(checkpoint_dir, enabled=is_lead)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"Device: {device} ({name})")
    logger.log(f"Precision: {cfg.train.precision} "
               "(fp32 master weights; products in the compute dtype)")

    dataset = TextMelDataset(metadata_path)
    tcfg = cfg.train
    if keep_epoch_ckpts is not None:
        tcfg = dataclasses.replace(tcfg, keep_epoch_ckpts=keep_epoch_ckpts)

    # a multi-speaker corpus (metadata with speaker_id) sizes the table
    if dataset.n_speakers > 1 and cfg.model.n_speakers < dataset.n_speakers:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model,
                                           n_speakers=dataset.n_speakers))
        logger.log(f"Multi-speaker corpus: {dataset.n_speakers} speakers")

    tx = make_optimizer(tcfg, debug=debug_overfit)
    state = create_train_state(cfg, debug=debug_overfit, tx=tx,
                               device=device)

    if debug_overfit:
        postnet_freeze_steps = 0
        sigma_warmup = tcfg.debug_sigma_warmup_steps
    else:
        postnet_freeze_steps = (postnet_freeze_steps_override
                                if postnet_freeze_steps_override is not None
                                else tcfg.postnet_freeze_steps)
        sigma_warmup = cfg.guided_attention.sigma_warmup_steps

    start_epoch, best_val_mel = 0, math.inf
    if resume:
        state, start_epoch, best_val_mel = _resume(resume, state)
        logger.log(f"Resumed from {resume} (epoch {start_epoch + 1}, "
                   f"step {state.step})")
    projection_bias_done = bool(resume)

    if debug_overfit:
        if tp > 1:
            logger.log("NOTE: --tp ignored in --debug overfit mode "
                       "(single-device diagnostic)")
        init_tensor_parallel(1)
        if world == 1:
            return _debug_overfit(dataset, state, tx, cfg, checkpoint_dir,
                                  sigma_warmup, iters=tcfg.epochs * 20)
        if is_lead:
            logger.log(f"NOTE: --debug runs on rank 0 alone (a single-device "
                       f"diagnostic); the other {world - 1} ranks wait")
            with local_only():
                state = _debug_overfit(dataset, state, tx, cfg,
                                       checkpoint_dir, sigma_warmup,
                                       iters=tcfg.epochs * 20)
        barrier()
        return state

    # the grid, then every rank from rank 0's state, bit for bit (under
    # tensor parallelism, its shards of it)
    global_micro_batch = tcfg.batch_size * world
    n_data = tensor_parallel_grid(world, tp, global_micro_batch)
    init_tensor_parallel(tp)
    state = shard_train_state(state, tensor_parallel=tp > 1)
    if tp > 1:
        logger.log(f"SPMD mesh: data={n_data} x model={tp} (tensor "
                   f"parallel), {world} processes, global micro-batch "
                   f"{global_micro_batch}")
    elif world > 1:
        logger.log(f"Data parallel: {world} devices, {world} processes, "
                   f"global micro-batch {global_micro_batch}")
    rows = global_micro_batch // n_data     # a data index's rows

    accum_steps = max(1, accum_steps)
    # with accumulation the loader draws accum_steps micro-batches at once
    # (one padded shape), taken one after another by train_step_accum
    loader = BatchLoader(dataset, rows * accum_steps,
                         seed=tcfg.seed,
                         text_pad_multiple=tcfg.text_pad_multiple,
                         mel_pad_multiple=tcfg.mel_pad_multiple,
                         process_index=rank(), process_count=n_data)
    loader.skip_epochs(start_epoch)
    val_loader = None
    if val_metadata:
        # allow_empty: a val set smaller than the global batch skips
        # validation (validate() reports 'batches': 0)
        val_loader = BatchLoader(TextMelDataset(val_metadata),
                                 rows, shuffle=False,
                                 seed=tcfg.seed,
                                 text_pad_multiple=tcfg.text_pad_multiple,
                                 mel_pad_multiple=tcfg.mel_pad_multiple,
                                 drop_last=False, allow_empty=True,
                                 process_index=rank(), process_count=n_data)
        logger.log(f"Loaded {len(val_loader.dataset)} validation samples.")

    timer = StepTimer(device=device)
    gstep = state.step
    run_saved_epochs: list = []   # epoch checkpoints this run wrote
    for epoch in range(start_epoch, tcfg.epochs):
        t0 = time.time()
        loss_totals = []
        n_batches = 0
        print(f"\nEpoch: {epoch + 1}/{tcfg.epochs}")
        alignments = None
        for batch in loader:
            if not projection_bias_done:
                # the decoder projection bias from the first batch's means
                init_projection_bias(state.model, batch["mel"])
                projection_bias_done = True
            use_postnet = gstep >= postnet_freeze_steps
            if accum_steps > 1:
                micro = {k: v.reshape((accum_steps,
                                       v.shape[0] // accum_steps)
                                      + v.shape[1:])
                         for k, v in batch.items()}
                state, losses, alignments = train_step_accum(
                    state, micro, cfg=cfg, tx=tx, use_postnet=use_postnet,
                    sigma_warmup_steps=sigma_warmup,
                    accum_steps=accum_steps)
            else:
                state, losses, alignments = train_step(
                    state, batch, cfg=cfg, tx=tx, use_postnet=use_postnet,
                    sigma_warmup_steps=sigma_warmup)
            loss_totals.append(losses.total)
            n_batches += 1
            gstep += 1
            timer.tick()
            if gstep % 200 == 0:
                perf = timer.stats(
                    frames_per_step=int(batch["mel_lengths"].sum()))
                running = float(np.mean([float(x) for x in loss_totals]))
                logger.log(
                    f"Step {gstep} | Ep {epoch + 1} B {n_batches}/"
                    f"{len(loader)} Total {running:.4f} "
                    + _fmt_losses(losses)
                    + f" | {perf['steps_per_sec']:.2f} it/s "
                    f"{perf.get('mel_frames_per_sec', 0):.0f} frames/s")
            if tcfg.save_every_steps and gstep % tcfg.save_every_steps == 0:
                # mid-epoch: a resume runs this epoch again from its start
                _save_best_effort(
                    os.path.join(checkpoint_dir, f"step_{gstep}"),
                    state, epoch, best_val_mel, logger)

        avg = (float(np.mean([float(x) for x in loss_totals]))
               if loss_totals else 0.0)
        logger.log(f"Epoch {epoch + 1} complete. Avg Loss: {avg:.6f}, "
                   f"Time: {time.time() - t0:.2f}s")

        if val_loader is not None:
            metrics = validate(state, val_loader, cfg, sigma_warmup)
            # the criterion's counter advances on validation batches too
            state.loss_step += int(metrics["batches"])
            logger.log(f"Validation | Epoch {epoch + 1} "
                       f"Mel {metrics['mel']:.4f} Gate {metrics['gate']:.4f} "
                       f"AttnEntropy {metrics['entropy']:.3f}")
            # best_val_mel advances only on a save that succeeded
            if metrics["mel"] < best_val_mel and _save_best_effort(
                    os.path.join(checkpoint_dir, "best_model"),
                    state, epoch + 1, metrics["mel"], logger):
                best_val_mel = metrics["mel"]
                logger.log(f"Saved best checkpoint "
                           f"(val mel {best_val_mel:.4f})")

        if _save_best_effort(
                os.path.join(checkpoint_dir, f"tacotron2_epoch_{epoch + 1}"),
                state, epoch + 1, best_val_mel, logger):
            run_saved_epochs.append(epoch + 1)
        if is_lead:
            _prune_epoch_ckpts(checkpoint_dir, tcfg.keep_epoch_ckpts, logger,
                               run_saved_epochs)
        if alignments is not None and is_lead:
            save_alignment_plot(alignments, os.path.join(
                checkpoint_dir, f"alignment_epoch_{epoch + 1}.png"))
    print("\nTraining complete.")
    return state


def _save_best_effort(path: str, state: TrainState, epoch: int,
                      best_val_mel: float, logger) -> bool:
    """Save a cadence checkpoint; a failed save (a full disk, a quota) is
    logged and training goes on.  ``epoch`` is the epoch a resume starts
    at.  Under a process group every rank gathers the shards (under tensor
    parallelism), rank 0 writes and the others wait for its outcome, which
    every rank returns."""
    ok = True
    whole = gather_train_state(state)
    if world_rank() == 0:
        try:
            save_checkpoint(path, whole, epoch, best_val_mel)
        except (OSError, RuntimeError) as e:
            logger.log(f"[WARN] checkpoint save failed for {path}: "
                       f"{type(e).__name__}: {e} — training continues")
            ok = False
    return broadcast_object(ok)


def _prune_epoch_ckpts(checkpoint_dir: str, keep: int, logger,
                       run_saved_epochs) -> None:
    """Keep only the newest ``keep`` of the per-epoch checkpoints THIS
    RUN created (0 keeps all).  Checkpoints of earlier runs in the same
    directory are never touched; every deletion is logged."""
    if not keep or keep <= 0:
        return
    for epoch_n in sorted(run_saved_epochs)[:-keep]:
        path = os.path.join(checkpoint_dir, f"tacotron2_epoch_{epoch_n}")
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
            logger.log(f"Pruned epoch checkpoint {path} "
                       f"(keep_epoch_ckpts={keep})")
    del run_saved_epochs[: max(0, len(run_saved_epochs) - keep)]


def _resume(resume: str, template: TrainState):
    full, epoch, best = load_any_checkpoint(resume, template)
    if full is not None:
        return full, epoch, best
    print(f"[resume] WARNING: {resume!r} is a params-only checkpoint "
          "(weights + BN stats). Optimizer state, epoch counter, LR "
          "schedule position, and best-val tracking restart from scratch.")
    return template, 0, best


def _debug_overfit(dataset: TextMelDataset, state: TrainState, tx,
                   cfg: Config, checkpoint_dir: str, sigma_warmup: int,
                   iters: int) -> TrainState:
    """Overfit one batch as a smoke test of the whole training path."""
    tcfg = cfg.train
    print("DEBUG MODE: overfitting a single batch "
          "(L1 loss, log-power mels)")
    rng = np.random.default_rng(tcfg.seed)
    idx = rng.permutation(len(dataset))[:tcfg.debug_batch_size]
    batch = collate([dataset[int(i)] for i in idx],
                    tcfg.text_pad_multiple, tcfg.mel_pad_multiple)
    print(f"Debug batch shapes: text {batch['text'].shape} "
          f"mel {batch['mel'].shape}")
    print(f"  Mel range: [{batch['mel'].min():.3f}, {batch['mel'].max():.3f}]")
    print(f"  Lengths: {batch['mel_lengths'].tolist()}")

    init_projection_bias(state.model, batch["mel"])
    for it in range(iters):
        state, losses, alignments = train_step(
            state, batch, cfg=cfg, tx=tx, use_postnet=True,
            sigma_warmup_steps=sigma_warmup)
        if (it + 1) % 5 == 0:
            eff = float(losses.attention_weight) * float(losses.attention_kl)
            print(f"Iteration {it + 1:4d}, Total: {float(losses.total):.6f}")
            print(f"  {_fmt_losses(losses)} | w*KL: {eff:.4f} | "
                  f"entropy: {float(losses.attention_entropy):.3f}")
        if (it + 1) % 10 == 0:
            p = os.path.join(checkpoint_dir,
                             f"debug_alignment_iter_{it + 1}.png")
            save_alignment_plot(alignments, p)
            print(f"Alignment saved: {p}")
        if float(losses.mel) < tcfg.debug_success_mel_l1:
            print(f"SUCCESS: mel L1 {float(losses.mel):.4f} < "
                  f"{tcfg.debug_success_mel_l1} at iteration {it + 1}")
            save_alignment_plot(alignments, os.path.join(
                checkpoint_dir, f"debug_alignment_iter_{it + 1}.png"))
            break

    export_dir = os.path.join(checkpoint_dir, "debug_export")
    try:
        save_params_only(os.path.join(export_dir, "overfit_model"),
                         state.model)
        np.savez(os.path.join(export_dir, "debug_batch.npz"), **batch)
        print(f"Saved overfit model + batch to {export_dir}")
        export_debug_inference(state, batch, cfg, export_dir)
    except Exception as e:    # a diagnostic export never ends the run
        print(f"Debug export failed: {type(e).__name__}: {e}")
    print("DEBUG MODE COMPLETE")
    return state
