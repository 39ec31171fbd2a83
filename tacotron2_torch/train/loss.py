"""Tacotron 2 training loss.

Counterpart of ``tacotron2_tpu/train/loss.py``, formula for formula:

  * masked mean L1 on the coarse and the postnet mels;
  * BCE-with-logits gate loss averaged over the batch's max mel length
    (positions beyond an item's length but within the batch max count, and
    hold target 1);
  * guided-attention KL against a per-sample diagonal Gaussian target whose
    sigma anneals from clamp(0.05 * text_len, 3, 20) to 1.0 over
    ``sigma_warmup_steps``; KL divided by the max mel length and clamped at
    150;
  * an entropy-adaptive KL weight, decayed from 1.0 toward 0.2 once the
    attention entropy is at or below 3.5;
  * ``loss_step`` counts criterion evaluations (per micro-batch under
    gradient accumulation) and is carried in the train state.

Decoder time is padded to quantised lengths, so every reduction is masked
to the batch's true max mel length.

Under a data-parallel group every batch reduction is the global batch's,
as GSPMD makes it on the JAX side: the max mel length is a MAX over the
ranks, and the numerators and denominators (the L1 terms' valid count,
the gate window, the KL's batch size, the entropy's rows and the mean
sigma) are summed over the ranks in one
``parallel/collectives.py::global_sums`` call with an identity backward.
Every rank then computes the same total, and every ``LossOutput`` field
equals the one-process value on the whole batch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import GuidedAttentionConfig
from ..parallel.collectives import all_reduce_max, global_sums


class LossOutput(NamedTuple):
    total: torch.Tensor
    mel: torch.Tensor
    gate: torch.Tensor
    attention_kl: torch.Tensor
    attention_weight: torch.Tensor
    attention_entropy: torch.Tensor
    sigma: torch.Tensor


def build_gate_target(mel_lengths: torch.Tensor, t_dec: int) -> torch.Tensor:
    """(B,) lengths -> (B, T) gate targets: 1 at and after the last real
    frame."""
    t = torch.arange(t_dec, device=mel_lengths.device)[None, :]
    return (t >= (mel_lengths[:, None] - 1)).float()


def diagonal_attention_target(text_lengths: torch.Tensor, t_dec_max: int,
                              t_enc_max: int, eff_steps: torch.Tensor,
                              loss_step: int, g: GuidedAttentionConfig,
                              sigma_warmup_steps: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form diagonal Gaussian targets (B, T_dec, T_enc) and each
    sample's sigma (B,).  Per-sample initial sigma = clamp(0.05 * L, 3,
    20), annealed linearly to 1.0; expected position floor(t * L / T)
    clipped to L - 1; normalised over the true encoder length.  ``eff_steps`` is the batch's
    true max decoder length; rows t >= eff_steps are zero."""
    dev = text_lengths.device
    lb = text_lengths.float()[:, None, None]                     # (B,1,1)
    init_sigma = torch.clamp(lb * g.initial_sigma_factor, 3.0,
                             g.max_sigma_cap)
    progress = min(1.0, float(loss_step) / float(sigma_warmup_steps))
    sigma = init_sigma - (init_sigma - g.min_sigma) * progress   # (B,1,1)

    t = torch.arange(t_dec_max, dtype=torch.float32, device=dev)[None, :, None]
    pos = torch.arange(t_enc_max, dtype=torch.float32,
                       device=dev)[None, None, :]
    eff = eff_steps.float()
    expected = torch.minimum(torch.floor(t * lb / eff), lb - 1.0)
    gauss = torch.exp(-0.5 * ((pos - expected) / sigma) ** 2)
    gauss = torch.where(pos < lb, gauss, torch.zeros_like(gauss))
    gauss = gauss / (gauss.sum(dim=2, keepdim=True) + 1e-8)
    target = torch.where(t < eff, gauss, torch.zeros_like(gauss))
    return target, sigma.reshape(-1)


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE with logits."""
    return (torch.clamp(logits, min=0.0) - logits * labels
            + torch.log1p(torch.exp(-torch.abs(logits))))


def tacotron2_loss(mel_postnet: torch.Tensor, mel_coarse: torch.Tensor,
                   gate_logits: torch.Tensor, alignments: torch.Tensor,
                   mel_target: torch.Tensor, mel_lengths: torch.Tensor,
                   text_lengths: Optional[torch.Tensor], loss_step: int,
                   g: GuidedAttentionConfig,
                   sigma_warmup_steps: Optional[int] = None) -> LossOutput:
    """Full loss.  ``mel_target`` is (B, n_mels, T); predictions are
    (B, T, n_mels)."""
    sigma_warmup_steps = (g.sigma_warmup_steps if sigma_warmup_steps is None
                          else sigma_warmup_steps)
    b, t_dec, n_mels = mel_coarse.shape
    dev = mel_coarse.device
    tgt = mel_target.transpose(1, 2)                      # (B, T, n_mels)
    steps = torch.arange(t_dec, device=dev)[None, :]

    fv = (steps < mel_lengths[:, None])[..., None].float()
    max_mel = all_reduce_max(mel_lengths.max())
    gate_window = (steps < max_mel).expand(b, t_dec).float()
    per_elem = sigmoid_binary_cross_entropy(
        gate_logits, build_gate_target(mel_lengths, t_dec))
    with_kl = text_lengths is not None and t_dec > 1
    if with_kl:
        target, sigma = diagonal_attention_target(
            text_lengths, t_dec, alignments.shape[2], max_mel, loss_step, g,
            sigma_warmup_steps)
        attn_safe = alignments.clamp_min(1e-8)
        log_pred = torch.log(attn_safe)
        # kl_div(log_pred, target, 'batchmean')
        tlogt = torch.where(target > 0,
                            target * torch.log(target.clamp_min(1e-30)),
                            torch.zeros_like(target))
        kl_sum = (tlogt - target * log_pred).sum()
        ent_rows = -(attn_safe * log_pred).sum(dim=2)         # (B, T)
        ent_sum = (ent_rows * gate_window).sum()
    else:
        kl_sum = ent_sum = torch.zeros((), device=dev)
        sigma = torch.zeros(b, device=dev)

    # the batch's sums; global ones under a data-parallel group
    (n_valid, l1c_sum, l1p_sum, gate_sum, window_sum, kl_sum, ent_sum,
     sigma_sum, b_sum) = global_sums(
        fv.sum(), ((mel_coarse - tgt).abs() * fv).sum(),
        ((mel_postnet - tgt).abs() * fv).sum(),
        (per_elem * gate_window).sum(), gate_window.sum(), kl_sum, ent_sum,
        sigma.sum(), torch.full((), float(b), device=dev))

    # masked mean L1 (x2)
    n_valid = n_valid * n_mels
    loss_mel = l1c_sum / n_valid + l1p_sum / n_valid

    # gate BCE over the batch-max mel window
    loss_gate = gate_sum / (window_sum + 1e-8)

    # guided-attention KL
    if with_kl:
        kl = torch.clamp(kl_sum / b_sum / max_mel.float(), max=g.kl_clamp)
        # entropy over valid decoder rows
        entropy = ent_sum / window_sum
        sigma = sigma_sum / b_sum
        weight = torch.where(
            entropy <= g.entropy_target,
            torch.clamp(g.weight_start * entropy.clamp_min(0.0)
                        / g.entropy_target, min=g.min_weight),
            torch.full_like(entropy, g.weight_start))
    else:
        kl = entropy = sigma = torch.zeros((), device=dev)
        weight = torch.full((), g.weight_start, device=dev)

    total = loss_mel + loss_gate + weight * kl
    return LossOutput(total=total, mel=loss_mel, gate=loss_gate,
                      attention_kl=kl, attention_weight=weight,
                      attention_entropy=entropy, sigma=sigma)
