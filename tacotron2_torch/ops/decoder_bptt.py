"""Split BPTT for the teacher-forced decoder: the training hot loop.

Counterpart of ``tacotron2_tpu/ops/decoder_bptt.py``.  The decoder is
differentiated by hand, split into its two structurally different parts:

1. **the sequential dx chain**, which must run step by step: a reverse
   loop over the series the forward stored, carrying the state gradients
   and no weight-gradient accumulator; it EMITS the per-step gate
   gradients (``ops/decoder_bwd_kernel.py``);
2. **the weight-gradient contractions**, parallel over time: single
   time-batched products after the loop (:func:`_bptt_weight_grads` and the
   attention-weight gradients in :func:`_attention_weight_grads`); these are
   large plain products and go to ``torch.matmul``.

:func:`decoder_scan_bptt` is a ``torch.autograd.Function`` around the pair.
On CUDA tensors with ``cfg.decoder_megakernel`` both halves run as the
persistent CUDA kernels; otherwise the forward is the step loop of
``decoder_fwd_train_reference`` with the CUDA ``attention_tail`` and the
reverse chain is the plain loop; on CPU tensors always the plain versions.
The residuals are those of the JAX package's kernel route: the hidden
states after dropout in the compute dtype, the fp32 cell states, the
alignments, the rounded qsum rows, the pre-activation gate stacks and the
dropout masks.

Numerics: gate gradients are emitted in the compute dtype; ``d_memory``
and the processed-memory gradient accumulate in fp32; every gradient comes
back in its input's dtype.
"""

from __future__ import annotations

import functools
from operator import attrgetter
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import ModelConfig
from .attention_kernel import attention_tail
from .decoder_bwd_kernel import (decoder_bwd_chain_mega,
                                 decoder_bwd_chain_reference)
from .decoder_train_kernel import (PARAM_NAMES, acc_dtype,
                                   decoder_fwd_train_mega,
                                   decoder_fwd_train_reference,
                                   kernel_operands)


def step_dropout_masks(cfg: ModelConfig, t_dec: int, b: int,
                       generator: torch.Generator, device
                       ) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """The two (T, B, H) keep-masks of the decoder's hidden-state dropout:
    one draw of the whole stack per mask from ``generator`` (which lies on
    ``device``).  None where the rate is 0."""
    h = cfg.decoder_rnn_dim

    def draw(rate):
        if rate <= 0.0:
            return None
        return torch.rand(t_dec, b, h, generator=generator,
                          device=device) < 1.0 - rate

    return draw(cfg.p_attention_dropout), draw(cfg.p_decoder_dropout)


def _dw(g_series: torch.Tensor, x_series: torch.Tensor) -> torch.Tensor:
    """sum over (t, b) of g (x) x: (T, B, G), (T, B, I) -> (G, I), summed in
    fp32 (the weight's PyTorch layout)."""
    f = acc_dtype(g_series.dtype)
    g2 = g_series.reshape(-1, g_series.shape[-1]).to(f)
    x2 = x_series.reshape(-1, x_series.shape[-1]).to(f)
    return g2.t() @ x2


def _bptt_weight_grads(cfg, cdt, prenet_tbd, memory, attns, ha_s, hd_s,
                       d_out_s, g_att_s, g_dec_s, d_ctx_s):
    """The hoisted weight-gradient contractions: one time-batched product
    per weight.  Shifted operand series are never built: the products over
    step t-1 inputs drop the zero t = 0 term and contract slices; inputs
    that were concatenated contract per part."""
    f = acc_dtype(cdt)
    n_mels = cfg.n_mels
    # the context is not stored: ctx_t = attn_t @ memory, with memory in the
    # compute dtype as the forward read it
    ctx_c = torch.einsum("tbs,bsd->tbd", attns.to(f),
                         memory.to(cdt).to(f)).to(cdt)
    d_out_c = d_out_s.to(cdt)
    d_w_heads = torch.cat([_dw(d_out_c, hd_s), _dw(d_out_c, ctx_c)], dim=1)
    d_b_heads = d_out_s.sum(dim=(0, 1))
    d_b_a = g_att_s.to(f).sum(dim=(0, 1))
    d_b_d = g_dec_s.to(f).sum(dim=(0, 1))
    grads = {
        "attention_lstm.weight_ih": torch.cat(
            [_dw(g_att_s, prenet_tbd.to(cdt)),
             _dw(g_att_s[1:], ctx_c[:-1])], dim=1),   # ctx_prev_t = ctx_{t-1}
        "attention_lstm.weight_hh": _dw(g_att_s[1:], ha_s[:-1]),
        "attention_lstm.bias_ih": d_b_a, "attention_lstm.bias_hh": d_b_a,
        "decoder_lstm.weight_ih": torch.cat(
            [_dw(g_dec_s, ha_s), _dw(g_dec_s, ctx_c)], dim=1),
        "decoder_lstm.weight_hh": _dw(g_dec_s[1:], hd_s[:-1]),
        "decoder_lstm.bias_ih": d_b_d, "decoder_lstm.bias_hh": d_b_d,
        "linear_projection.weight": d_w_heads[:n_mels],
        "linear_projection.bias": d_b_heads[:n_mels],
        "gate_layer.weight": d_w_heads[n_mels:],
        "gate_layer.bias": d_b_heads[n_mels:],
    }
    # d_memory: the fp32 context path (the processed-memory path reaches
    # the caller through d_pm)
    d_memory = torch.einsum("tbs,tbd->bsd", attns.to(f), d_ctx_s.to(f))
    return grads, d_memory


def _attention_weight_grads(cfg, p, cdt, attns, ha_s, d_qsum_s, d_pq_s, dv,
                            scal):
    """The attention-weight gradients from the chain's emitted ``d_qsum``
    and ``d_pq`` series, as single time-batched contractions."""
    f = acc_dtype(cdt)
    t_dec, b, t_enc = attns.shape
    a, k = cfg.attention_dim, cfg.location_kernel_size
    lpad = (k - 1) // 2
    # the states each step consumed.  Shift-then-cumsum, NOT cumsum minus
    # attns: the subtraction cancels catastrophically on early steps.
    prev_s = torch.cat([torch.zeros_like(attns[:1]), attns[:-1]])
    cum_s = torch.cumsum(prev_s, dim=0)
    # d_comp[c*K+k, a] = sum_{t,b,s} prevcat[t,b,c,s+k] * d_qsum[t,b,s,a]:
    # the location windows against the d_qsum rows, one product
    pc = F.pad(torch.stack([prev_s, cum_s], dim=2),
               (lpad, k - 1 - lpad)).to(cdt)                  # (T, B, 2, S+K-1)
    win = pc.unfold(3, k, 1).permute(0, 1, 3, 2, 4)           # (T, B, S, 2, K)
    d_comp = (win.reshape(-1, 2 * k).to(f).t()
              @ d_qsum_s.reshape(-1, a).to(f))                # (2K, A)
    # chain rule through comp = wl @ wld
    lw = p["attention.location_conv.weight"].to(f)            # (F, 2, K)
    n_f = lw.shape[0]
    wl = lw.permute(1, 2, 0).reshape(2 * k, n_f)              # (2K, F)
    wld = p["attention.location_dense.weight"].to(f)          # (A, F)
    d_wl = d_comp @ wld                                       # (2K, F)
    scale = p["attention.energy_scale"].to(f)
    return {
        "attention.query_layer.weight": torch.einsum(
            "tba,tbh->ah", d_pq_s.to(f), ha_s.to(f)),
        "attention.location_conv.weight":
            d_wl.reshape(2, k, n_f).permute(2, 0, 1),
        "attention.location_dense.weight": d_comp.t() @ wl,   # (A, F)
        "attention.v.weight": dv.sum(dim=0)[None, :],
        "attention.v.bias": (scal[1] * scale)[None],
        "attention.energy_scale": scal[0],
    }


class _DecoderScanBPTT(torch.autograd.Function):

    @staticmethod
    def forward(ctx, cfg, prenet_tbd, memory, pm, mask, mka_s, mkd_s,
                *params):
        p = dict(zip(PARAM_NAMES, params))
        ops = kernel_operands(p)
        mega = cfg.decoder_megakernel
        fwd = decoder_fwd_train_mega if mega else functools.partial(
            decoder_fwd_train_reference, tail=attention_tail)
        (frames, attns, ha_s, ca_s, hd_s, cd_s, qsum_s, aa_s,
         ad_s) = fwd(cfg, ops, prenet_tbd, memory, pm, mask, mka_s, mkd_s)
        ctx.cfg = cfg
        ctx.has_masks = (mka_s is not None, mkd_s is not None)
        saved = [prenet_tbd, memory, pm, attns, ha_s, ca_s, hd_s, cd_s,
                 qsum_s, aa_s, ad_s]
        saved += [m for m in (mka_s, mkd_s) if m is not None]
        ctx.save_for_backward(*saved, *params)
        ctx.n_series = len(saved)
        n_mels = cfg.n_mels
        return frames[..., :n_mels], frames[..., n_mels], attns

    @staticmethod
    def backward(ctx, d_mels, d_gates, d_attn_out):
        cfg = ctx.cfg
        saved = ctx.saved_tensors
        series, params = saved[:ctx.n_series], saved[ctx.n_series:]
        (prenet_tbd, memory, pm, attns, ha_s, ca_s, hd_s, cd_s, qsum_s,
         aa_s, ad_s) = series[:11]
        masks = list(series[11:])
        mka_s = masks.pop(0) if ctx.has_masks[0] else None
        mkd_s = masks.pop(0) if ctx.has_masks[1] else None
        p = dict(zip(PARAM_NAMES, params))
        ops = kernel_operands(p)
        cdt = ops["wi_a"].dtype
        f = acc_dtype(cdt)
        d_out_s = torch.cat([d_mels, d_gates[..., None]], dim=-1).to(f)
        bwd = (decoder_bwd_chain_mega if cfg.decoder_megakernel
               else decoder_bwd_chain_reference)
        (g_att_s, g_dec_s, d_ctx_s, d_pre_s, d_qsum_s, d_pq_s, dv, dpm,
         scal) = bwd(cfg, ops, memory, mka_s, mkd_s, aa_s, ad_s, ca_s, cd_s,
                     attns, qsum_s, d_out_s, d_attn_out.to(f).contiguous())
        grads, d_memory = _bptt_weight_grads(
            cfg, cdt, prenet_tbd, memory, attns, ha_s, hd_s, d_out_s,
            g_att_s, g_dec_s, d_ctx_s)
        grads.update(_attention_weight_grads(
            cfg, p, cdt, attns, ha_s, d_qsum_s, d_pq_s, dv, scal))
        d_params = tuple(
            grads[n].reshape(p[n].shape).to(p[n].dtype)
            if ctx.needs_input_grad[7 + i] else None
            for i, n in enumerate(PARAM_NAMES))
        return (None, d_pre_s.to(prenet_tbd.dtype),
                d_memory.to(memory.dtype),
                dpm.reshape(pm.shape).to(pm.dtype), None, None, None,
                *d_params)


def core_params(dec) -> Dict[str, torch.Tensor]:
    """The decoder's parameters that :func:`decoder_scan_bptt` reads, by
    name (whatever tensors currently stand in the module, so a
    ``functional_call`` with cast parameters is seen)."""
    return {n: attrgetter(n)(dec) for n in PARAM_NAMES}


def decoder_scan_bptt(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                      prenet_tbd: torch.Tensor, memory: torch.Tensor,
                      pm: torch.Tensor, mask: torch.Tensor,
                      mka_s: Optional[torch.Tensor],
                      mkd_s: Optional[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Teacher-forced decoder over all steps with the split-BPTT backward.

    Args:
        params: the decoder parameters keyed by ``PARAM_NAMES`` (see
            :func:`core_params`); the prenet and the memory layer act
            outside and get their gradients through ``prenet_tbd`` / ``pm``.
        prenet_tbd: (T_dec, B, prenet_dim) prenetted go-shifted targets.
        memory: (B, T_enc, D_enc) encoder outputs (fp32).
        pm: (B, T_enc, attention_dim) processed memory.
        mask: (B, T_enc) bool, True = encoder padding (required; callers
            with no padding pass all-False).
        mka_s, mkd_s: (T_dec, B, H) keep-masks of the attention-LSTM and
            decoder-LSTM hidden-state dropout (:func:`step_dropout_masks`);
            None where the rate is 0.
    Returns:
        (mels (T, B, n_mels), gate_logits (T, B), attn (T, B, T_enc)), fp32.
    """
    return _DecoderScanBPTT.apply(cfg, prenet_tbd, memory, pm, mask, mka_s,
                                  mkd_s, *(params[n] for n in PARAM_NAMES))
