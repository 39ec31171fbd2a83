"""Train and eval steps.

Counterpart of ``tacotron2_tpu/train/step.py``: forward (encoder, decoder,
postnet), loss, backward, clip, Adam.  The steps update the state IN PLACE:
parameters, Adam moments, BatchNorm running statistics, the counters and
the generator (the JAX step donates its state for the same reason: no
second copy of ~340 MB of parameters and moments).  They return the same
state object, so ``state = train_step(state, ...)[0]`` reads as it does
there.

Gradient accumulation averages the micro-batches' gradients and applies
the optimizer once; the criterion's counter advances once per micro-batch.

Under a data-parallel group each rank steps on its own rows of the global
batch, and the step is the one a single process takes on the whole
batch: BatchNorm and the loss reduce over the global batch
(``models/layers.py``, ``train/loss.py``), the gradients are summed over
the ranks in one flat all-reduce before the clip, so every rank applies
the same Adam step, and the dropout masks are drawn for the global batch
from each rank's generator (identical on every rank) and cut to the
rank's rows (:func:`global_dropout_masks`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ..config import Config
from ..models.tacotron2 import Tacotron2, tacotron2_forward
from ..parallel.collectives import (all_reduce_gradients, data_axis_size,
                                    global_sums, is_distributed, rank)
from .loss import LossOutput, tacotron2_loss
from .optim import Optimizer
from .state import TrainState

Batch = Dict[str, object]


def compute_dtype_of(precision: str) -> Optional[torch.dtype]:
    """Map a TrainConfig.precision string to a compute dtype (None =
    fp32)."""
    if precision in ("bfloat16", "bf16"):
        return torch.bfloat16
    if precision in ("float32", "fp32"):
        return None
    raise ValueError(f"unknown precision {precision!r} "
                     "(expected 'bfloat16' or 'float32')")


def cast_params_for_compute(model: Tacotron2,
                            compute_dtype: Optional[torch.dtype]
                            ) -> Optional[Dict[str, torch.Tensor]]:
    """A differentiable cast of the fp32 master weights to the compute
    dtype, by parameter name; None for fp32.  The forward runs on the cast
    tensors; because the cast is part of the differentiated function, the
    gradients arrive on the masters in fp32, and gradients, clipping and
    Adam moments all stay fp32 (no loss scaling: bf16 has fp32's exponent
    range)."""
    if compute_dtype is None:
        return None
    return {n: p.to(compute_dtype) if p.dtype == torch.float32 else p
            for n, p in model.named_parameters()}


def _device_of(model: Tacotron2) -> torch.device:
    return next(model.parameters()).device


def _to_device(batch: Batch, device: torch.device) -> Batch:
    out = {}
    for k, v in batch.items():
        if v is None:
            continue
        t = v if torch.is_tensor(v) else torch.as_tensor(v)
        out[k] = t.to(device)
    return out


def global_dropout_masks(model: Tacotron2, batch: Batch,
                         generator: torch.Generator, use_postnet: bool
                         ) -> Dict[str, object]:
    """This rank's rows of the keep-masks a single process would draw for
    the whole global batch, drawn from ``generator`` in the forward's own
    order: the prenet's two layers (B, T_dec, prenet_dim), the attention-
    and decoder-LSTM states (T_dec, B, H), then each postnet layer
    (B, C, T_dec); none where a rate is 0."""
    cfg = model.cfg
    world, r = data_axis_size(), rank()
    b, _, t_dec = batch["mel"].shape
    gb = b * world
    dev = batch["mel"].device
    rows = slice(r * b, (r + 1) * b)

    def keep(shape, rate, batch_dim):
        if rate <= 0.0:
            return None
        m = torch.rand(shape, generator=generator, device=dev) < 1.0 - rate
        return m[rows] if batch_dim == 0 else m[:, rows]

    h = cfg.decoder_rnn_dim
    masks = {"prenet": [keep((gb, t_dec, cfg.prenet_dim),
                             cfg.p_prenet_dropout, 0) for _ in range(2)],
             "attention": keep((t_dec, gb, h), cfg.p_attention_dropout, 1),
             "decoder": keep((t_dec, gb, h), cfg.p_decoder_dropout, 1)}
    if use_postnet:
        masks["postnet"] = [
            keep((gb, conv.weight.shape[0], t_dec), cfg.p_postnet_dropout, 0)
            for conv in model.postnet.convs]
    return masks


def _forward_loss(model: Tacotron2, cfg: Config, batch: Batch,
                  generator: Optional[torch.Generator], loss_step: int,
                  use_postnet: bool, sigma_warmup_steps: int,
                  masks: Optional[Dict[str, object]] = None):
    """Train-mode forward and loss on the compute-dtype cast of the
    parameters.  Returns (total, (losses, alignments)); BatchNorm running
    statistics are updated in place.  Under a data-parallel group the
    masks not handed in are the global draw's rows."""
    if masks is None and is_distributed():
        masks = global_dropout_masks(model, batch, generator, use_postnet)
    params = cast_params_for_compute(
        model, compute_dtype_of(cfg.train.precision))
    out = tacotron2_forward(
        model, batch["text"], batch["mel"], batch["text_lengths"],
        train=True, use_postnet=use_postnet,
        speaker_ids=batch.get("speaker_ids"), generator=generator,
        masks=masks, params=params, device=_device_of(model))
    losses = tacotron2_loss(
        out.mel_postnet, out.mel_coarse, out.gate_logits, out.alignments,
        batch["mel"], batch["mel_lengths"], batch["text_lengths"],
        loss_step, cfg.guided_attention,
        sigma_warmup_steps=sigma_warmup_steps)
    return losses.total, (losses, out.alignments)


def _detach(losses: LossOutput) -> LossOutput:
    return LossOutput(*(x.detach() for x in losses))


def _grads(model: Tacotron2, total: torch.Tensor) -> Dict[str, torch.Tensor]:
    """This rank's gradients of ``total`` by parameter name."""
    names, params = zip(*model.named_parameters())
    gs = torch.autograd.grad(total, params, allow_unused=True)
    return {n: g for n, g in zip(names, gs) if g is not None}


def train_step(state: TrainState, batch: Batch, *, cfg: Config,
               tx: Optimizer, use_postnet: bool, sigma_warmup_steps: int,
               masks: Optional[Dict[str, object]] = None
               ) -> Tuple[TrainState, LossOutput, torch.Tensor]:
    """One optimizer step on one batch, in place on ``state``.

    ``batch`` holds ``text`` (B, T_enc), ``text_lengths``, ``mel``
    (B, n_mels, T_dec), ``mel_lengths`` and optionally ``speaker_ids`` as
    arrays or tensors (``data/dataset.py::collate``).  ``masks`` hands in
    the dropout masks instead of drawing them from the state's generator
    (under a data-parallel group: this rank's rows of them).  Returns
    (state, losses, alignments (B, T_dec, T_enc)).
    """
    batch = _to_device(batch, _device_of(state.model))
    total, (losses, alignments) = _forward_loss(
        state.model, cfg, batch, state.generator, state.loss_step,
        use_postnet, sigma_warmup_steps, masks)
    tx.update(state.model, state.opt_state,
              all_reduce_gradients(_grads(state.model, total)))
    state.step += 1
    state.loss_step += 1
    return state, _detach(losses), alignments.detach()


def train_step_accum(state: TrainState, batch: Batch, *, cfg: Config,
                     tx: Optimizer, use_postnet: bool,
                     sigma_warmup_steps: int, accum_steps: int,
                     masks: Optional[Sequence[Dict[str, object]]] = None
                     ) -> Tuple[TrainState, LossOutput, torch.Tensor]:
    """Gradient-accumulated step: the batch arrays carry a leading
    ``(accum_steps, micro_batch, ...)`` axis.  Returns the last
    micro-batch's losses and alignments."""
    batch = _to_device(batch, _device_of(state.model))
    acc: Dict[str, torch.Tensor] = {}
    for i in range(accum_steps):
        micro = {k: v[i] for k, v in batch.items()}
        total, (losses, alignments) = _forward_loss(
            state.model, cfg, micro, state.generator, state.loss_step,
            use_postnet, sigma_warmup_steps,
            None if masks is None else masks[i])
        for n, g in _grads(state.model, total).items():
            acc[n] = acc[n] + g if n in acc else g
        state.loss_step += 1
    all_reduce_gradients(acc)
    tx.update(state.model, state.opt_state,
              {n: g / accum_steps for n, g in acc.items()})
    state.step += 1
    return state, _detach(losses), alignments.detach()


@torch.no_grad()
def eval_step(state: TrainState, batch: Batch, *, cfg: Config,
              sigma_warmup_steps: int
              ) -> Tuple[LossOutput, torch.Tensor, torch.Tensor]:
    """Teacher-forced validation pass (eval mode: running BatchNorm
    statistics, no dropout, fp32 master weights).  Returns (losses,
    alignments, mean attention entropy).  The entropy is deliberately
    UNMASKED over all decoder rows, and so distinct from
    ``losses.attention_entropy``, which is masked to the gate window
    because it drives the adaptive KL weight.  Under a data-parallel group
    the entropy is the global batch's mean."""
    device = _device_of(state.model)
    batch = _to_device(batch, device)
    out = tacotron2_forward(
        state.model, batch["text"], batch["mel"], batch["text_lengths"],
        train=False, use_postnet=True, speaker_ids=batch.get("speaker_ids"),
        device=device)
    losses = tacotron2_loss(
        out.mel_postnet, out.mel_coarse, out.gate_logits, out.alignments,
        batch["mel"], batch["mel_lengths"], batch["text_lengths"],
        state.loss_step, cfg.guided_attention,
        sigma_warmup_steps=sigma_warmup_steps)
    a = out.alignments.float().clamp_min(1e-8)
    rows = -(a * torch.log(a)).sum(dim=-1)
    ent_sum, n_rows = global_sums(
        rows.sum(), torch.full((), float(rows.numel()), device=device))
    return losses, out.alignments, ent_sum / n_rows
