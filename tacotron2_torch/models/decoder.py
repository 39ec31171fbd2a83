"""Tacotron 2 autoregressive decoder: prenet + attention + 2 LSTMs + heads.

Counterpart of ``tacotron2_tpu/models/decoder.py``.  Per step: prenet ->
attention LSTM -> attention -> decoder LSTM -> fused projection + gate
head, with dropout on the prenet and on both LSTM hidden states when
training.  :func:`decoder_infer` is the gate-stopped autoregressive decode;
on CUDA tensors with ``cfg.decoder_megakernel`` it runs as one persistent
kernel (``ops/decoder_megakernel.py``), otherwise as the step loop here,
whose attention tail is a CUDA kernel.  :func:`decoder_teacher_forced`
is the training forward: all frames through the prenet at once, then
``ops/decoder_bptt.py::decoder_scan_bptt``, or the step loop under
autograd, each step rematerialised in the backward where the config asks
(``ModelConfig.remat_decoder_step``, :func:`remat_context`).

Under tensor parallelism (``Decoder.model_axis`` set by
``parallel/mesh.py`` or ``infer/sharded.py``) the two LSTM cells and the
fused heads run on their shards (``models/layers.py``), and both decodes
take the step loop with the CUDA attention tail on every step: the decode
kernel and the teacher-forced kernel pair hold the very weights that are
sharded, whole, as the JAX package's kernels do, which it turns off on a
mesh with a ``model`` axis (``tacotron2_tpu/ops/decoder_megakernel.py::
megakernel_enabled``, ``decoder_train_kernel.py::
train_megakernel_enabled``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils import checkpoint

from ..config import ModelConfig
from ..ops.attention_kernel import attention_tail
from .attention import Attention, TailFn, attention_step, precompute_memory
from ..parallel.model_axis import LOCAL
from .layers import Linear, LSTMCell, dropout, linear_on_axis, lstm_cell_on_axis

ATTENTION_LSTM = tuple(f"decoder.attention_lstm.{n}" for n in
                       ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
DECODER_LSTM = tuple(n.replace("attention_lstm", "decoder_lstm")
                     for n in ATTENTION_LSTM)
HEADS = ("decoder.linear_projection.weight", "decoder.gate_layer.weight")


class DecoderCarry(NamedTuple):
    h_att: torch.Tensor     # (B, H) attention-LSTM hidden
    c_att: torch.Tensor
    h_dec: torch.Tensor     # (B, H) decoder-LSTM hidden
    c_dec: torch.Tensor
    context: torch.Tensor   # (B, D_enc) attention context
    prev_attn: torch.Tensor  # (B, T_enc)
    cum_attn: torch.Tensor   # (B, T_enc)


class Decoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        e, h = cfg.encoder_embedding_dim, cfg.decoder_rnn_dim
        self.prenet = nn.ModuleList([
            Linear(cfg.n_mels, cfg.prenet_dim, bias=False),
            Linear(cfg.prenet_dim, cfg.prenet_dim, bias=False)])
        self.attention = Attention(cfg)
        self.attention_lstm = LSTMCell(cfg.prenet_dim + e, h)
        self.decoder_lstm = LSTMCell(h + e, h)
        self.linear_projection = Linear(h + e, cfg.n_mels)
        self.gate_layer = Linear(h + e, 1)
        # the axis the LSTMs' gates and the heads' inputs are split over;
        # parallel/mesh.py and infer/sharded.py set a sharded one
        self.model_axis = LOCAL


def prenet_apply(dec: Decoder, x: torch.Tensor, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 masks: Optional[Sequence[torch.Tensor]] = None
                 ) -> torch.Tensor:
    """PreNet (..., n_mels) -> (..., prenet_dim); when training, dropout
    after each layer with a fresh mask (drawn from ``generator``, or
    ``masks[i]`` for layer i)."""
    for i, layer in enumerate(dec.prenet):
        x = torch.relu(layer(x))
        x = dropout(x, dec.cfg.p_prenet_dropout, train, generator,
                    None if masks is None else masks[i])
    return x


def init_carry(batch: int, t_enc: int, cfg: ModelConfig,
               device: torch.device) -> DecoderCarry:
    z = lambda d: torch.zeros(batch, d, device=device)
    h = cfg.decoder_rnn_dim
    return DecoderCarry(z(h), z(h), z(h), z(h), z(cfg.encoder_embedding_dim),
                        z(t_enc), z(t_enc))


def decode_step(dec: Decoder, prenet_out: torch.Tensor, carry: DecoderCarry,
                memory: torch.Tensor, processed_memory: torch.Tensor,
                mask: Optional[torch.Tensor], tail: TailFn = attention_tail,
                train: bool = False,
                step_masks: Optional[Tuple[Optional[torch.Tensor],
                                           Optional[torch.Tensor]]] = None
                ) -> Tuple[DecoderCarry, Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]]:
    """One decoder step from an already-prenetted frame.  With ``train``,
    ``step_masks`` holds this step's (B, H) keep-masks for the attention-LSTM
    and decoder-LSTM hidden states (None where the rate is 0).

    Returns (new_carry, (mel (B, n_mels), gate_logit (B,), attn (B, T_enc))).
    """
    cfg = dec.cfg
    axis = dec.model_axis
    mka, mkd = step_masks if train else (None, None)
    attn_in = torch.cat([prenet_out, carry.context], dim=-1)
    h_att, c_att = lstm_cell_on_axis(dec.attention_lstm, ATTENTION_LSTM, axis,
                                     attn_in, carry.h_att, carry.c_att)
    h_att = dropout(h_att, cfg.p_attention_dropout, train, mask=mka)
    context, attn, cum = attention_step(
        dec.attention, h_att, memory, processed_memory, carry.prev_attn,
        carry.cum_attn, mask, tail)
    dec_in = torch.cat([h_att, context], dim=-1)
    h_dec, c_dec = lstm_cell_on_axis(dec.decoder_lstm, DECODER_LSTM, axis,
                                     dec_in, carry.h_dec, carry.c_dec)
    h_dec = dropout(h_dec, cfg.p_decoder_dropout, train, mask=mkd)
    proj_in = torch.cat([h_dec, context], dim=-1)
    # fused output heads: one (B, 1536) x (1536, n_mels + 1) product
    b_heads = torch.cat([dec.linear_projection.bias, dec.gate_layer.bias])
    out = linear_on_axis((dec.linear_projection.weight,
                          dec.gate_layer.weight), HEADS, axis, proj_in,
                         b_heads)
    new_carry = DecoderCarry(h_att, c_att, h_dec, c_dec, context, attn, cum)
    return new_carry, (out[:, :-1], out[:, -1], attn)


@contextlib.contextmanager
def _standing_in(module: nn.Module, tensors: Dict[str, torch.Tensor]):
    """``tensors`` stand in for ``module``'s parameters of those names
    within, as ``torch.func.functional_call`` puts them."""
    saved = []
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner)
        saved.append((sub, leaf, sub._parameters[leaf]))
        sub._parameters[leaf] = t
    try:
        yield
    finally:
        for sub, leaf, t in saved:
            sub._parameters[leaf] = t


# The matrix products that ``torch.matmul`` reaches under the dispatcher
# (``linear``'s are ``aten.mm``): jax.checkpoint_policies.dots_saveable's
# dot_general.  The CUDA tail is a ctypes call, which no policy sees: under
# "dots" it runs again in the backward, as under "full".
PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default)


def dots_policy(ctx, op, *args, **kwargs) -> checkpoint.CheckpointPolicy:
    """Keep the matrix products' outputs, recompute everything else."""
    if op in PRODUCTS:
        return checkpoint.CheckpointPolicy.MUST_SAVE
    return checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def remat_context(policy: str) -> Callable:
    """``torch.utils.checkpoint``'s ``context_fn`` for a remat policy: none
    for "full" (the whole step recomputed), the selective contexts of
    :func:`dots_policy` for "dots"; raises the JAX package's ValueError
    for any other."""
    if policy == "full":
        return checkpoint.noop_context_fn
    if policy == "dots":
        return functools.partial(
            checkpoint.create_selective_checkpoint_contexts, dots_policy)
    raise ValueError(f"unknown decoder_remat_policy {policy!r} "
                     "(expected 'full' or 'dots')")


def _step_weights(dec: Decoder) -> Dict[str, torch.Tensor]:
    """The low-precision tensors every decoder step reads (the prenet and
    the memory layer run once, before the steps)."""
    return {n: t for n, t in dec.named_parameters()
            if t.dtype != torch.float32
            and not n.startswith(("prenet.", "attention.memory_layer."))}


def decoder_teacher_forced(dec: Decoder, memory: torch.Tensor,
                           mel_targets: torch.Tensor,
                           mask: Optional[torch.Tensor], train: bool = False,
                           generator: Optional[torch.Generator] = None,
                           masks: Optional[Dict[str, object]] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Teacher-forced decode of a whole utterance batch.

    Args:
        memory: (B, T_enc, D_enc) encoder outputs.
        mel_targets: (B, n_mels, T_dec) ground-truth mels.
        mask: (B, T_enc) bool, True = encoder padding.
        generator: draws the dropout masks when training.
        masks: dropout keep-masks handed in instead of drawn: ``"prenet"``
            (one (B, T_dec, prenet_dim) mask per prenet layer),
            ``"attention"`` and ``"decoder"`` ((T_dec, B, H) each).
    Returns:
        (mels (B, T_dec, n_mels), gate_logits (B, T_dec),
         alignments (B, T_dec, T_enc))

    Train mode with ``cfg.decoder_split_bptt`` on an unsharded decoder
    and no remat runs ``decoder_scan_bptt`` (the kernel pair on CUDA
    tensors); otherwise the plain step loop, differentiated by
    ``torch.autograd``.  With ``cfg.remat_decoder_step`` in train mode each
    step of the loop runs inside ``torch.utils.checkpoint`` (policy
    ``cfg.decoder_remat_policy``, :func:`remat_context`): only the carry,
    the step's frame and masks and the one fp32 weight copy cross the
    region's edge, and the backward runs the step again on them.  The
    dropout masks are drawn before the loop, so the recompute sees the
    same ones; nothing in the region draws from a generator.
    """
    from ..ops.decoder_bptt import (core_params, decoder_scan_bptt,
                                    step_dropout_masks)
    cfg = dec.cfg
    b, t_enc, _ = memory.shape
    t_dec = mel_targets.shape[2]
    masks = masks or {}

    # go-frame shift: (B, T_dec, n_mels), frame t-1 feeds step t
    tgt = mel_targets.transpose(1, 2)
    dec_inputs = torch.cat([torch.zeros_like(tgt[:, :1]), tgt[:, :-1]], dim=1)
    # the prenet over all frames at once: one large product, not T small
    prenet_out = prenet_apply(dec, dec_inputs, train, generator,
                              masks.get("prenet")).transpose(0, 1)
    processed_memory = precompute_memory(dec.attention, memory)
    if mask is None:
        mask = torch.zeros(b, t_enc, dtype=torch.bool, device=memory.device)

    remat = train and cfg.remat_decoder_step
    context_fn = remat_context(cfg.decoder_remat_policy) if remat else None
    mka_s = mkd_s = None
    if train:
        if "attention" in masks or "decoder" in masks:
            mka_s, mkd_s = masks.get("attention"), masks.get("decoder")
        else:
            mka_s, mkd_s = step_dropout_masks(cfg, t_dec, b, generator,
                                              memory.device)
        if (cfg.decoder_split_bptt and not remat
                and not dec.model_axis.sharded):
            mels, gates, aligns = decoder_scan_bptt(
                cfg, core_params(dec), prenet_out, memory, processed_memory,
                mask, mka_s, mkd_s)
            return (mels.transpose(0, 1), gates.transpose(0, 1),
                    aligns.transpose(0, 1))

    carry = init_carry(b, t_enc, cfg, memory.device)
    # Under autograd a weight that every step reads sums its gradient over
    # the steps in its own dtype, and a bf16 sum of T_dec terms loses their
    # low bits (the split BPTT sums its weight gradients in fp32).  So each
    # step reads its own cast of one fp32 copy, whose gradient sums in fp32.
    low = _step_weights(dec) if train else {}
    copies = {n: t.float() for n, t in low.items()}

    def step(pre_t, carry, step_masks):
        with _standing_in(dec, {n: c.to(low[n].dtype)
                                for n, c in copies.items()}):
            return decode_step(dec, pre_t, carry, memory, processed_memory,
                               mask, train=train, step_masks=step_masks)

    outs = []
    for t in range(t_dec):
        step_masks = (None if mka_s is None else mka_s[t],
                      None if mkd_s is None else mkd_s[t])
        if remat:
            # no generator state to keep: the region draws nothing
            carry, out = checkpoint.checkpoint(
                step, prenet_out[t], carry, step_masks, use_reentrant=False,
                preserve_rng_state=False, context_fn=context_fn)
        else:
            carry, out = step(prenet_out[t], carry, step_masks)
        outs.append(out)
    mels, gates, aligns = (torch.stack(x, dim=1) for x in zip(*outs))
    return mels, gates, aligns


def decoder_infer(dec: Decoder, memory: torch.Tensor, max_steps: int,
                  gate_threshold: float, drop_first_frame: bool = True,
                  mask: Optional[torch.Tensor] = None,
                  stop_mode: str = "any",
                  forced_stop_at: Optional[int] = None):
    """Gate-stopped autoregressive decode (eval mode).

    ``stop_mode`` "any" stops the whole batch once more than one frame is
    out and any item's gate sigmoid exceeds the threshold; "all" runs until
    every item's gate has fired (or ``max_steps``).  ``mask`` (B, T_enc),
    True = pad, masks padded encoder positions.  ``drop_first_frame``
    advances the state with a first frame that is not recorded.
    ``forced_stop_at`` treats the gate as fired once that many frames are
    out.

    Returns (mels (B, S, n_mels), gate_logits (B, S), aligns (B, S, T_enc),
    n_frames 0-d int32, frame_ends (B,) int32) with S = max_steps; rows
    past the stop hold zero mels and aligns and -1e9 gate logits;
    ``frame_ends[b] = min(frame count at item b's own stop, n_frames)``.
    """
    if stop_mode not in ("any", "all"):
        raise ValueError(f"stop_mode must be 'any' or 'all', got {stop_mode}")
    args = (dec, memory, max_steps, gate_threshold, drop_first_frame, mask,
            stop_mode, forced_stop_at)
    if dec.cfg.decoder_megakernel and memory.is_cuda \
            and not dec.model_axis.sharded:
        from ..ops.decoder_megakernel import decoder_infer_mega
        return decoder_infer_mega(*args)
    return decoder_infer_steps(*args, tail=attention_tail)


def decoder_infer_steps(dec: Decoder, memory: torch.Tensor, max_steps: int,
                        gate_threshold: float, drop_first_frame: bool = True,
                        mask: Optional[torch.Tensor] = None,
                        stop_mode: str = "any",
                        forced_stop_at: Optional[int] = None,
                        tail: TailFn = attention_tail):
    """The step loop behind :func:`decoder_infer` (same returns); ``tail``
    is the attention tail each step calls.  The stop test reads one flag
    back to the host per step."""
    cfg = dec.cfg
    b, t_enc, _ = memory.shape
    dev = memory.device
    processed_memory = precompute_memory(dec.attention, memory)
    carry = init_carry(b, t_enc, cfg, dev)

    def run_step(carry, mel_in):
        return decode_step(dec, prenet_apply(dec, mel_in), carry, memory,
                           processed_memory, mask, tail)

    mel_in = torch.zeros(b, cfg.n_mels, device=dev)
    if drop_first_frame:
        carry, (mel_in, _, _) = run_step(carry, mel_in)

    mels = torch.zeros(max_steps, b, cfg.n_mels, device=dev)
    gates = torch.full((max_steps, b), -1e9, device=dev)
    aligns = torch.zeros(max_steps, b, t_enc, device=dev)
    item_done = torch.zeros(b, dtype=torch.bool, device=dev)
    item_end = torch.full((b,), max_steps, dtype=torch.int32, device=dev)
    step = 0
    while step < max_steps:
        carry, (mel, gate, attn) = run_step(carry, mel_in)
        mels[step], gates[step], aligns[step] = mel, gate, attn
        n_out = step + 1
        fired = (torch.sigmoid(gate) > gate_threshold) & (n_out > 1)
        if forced_stop_at is not None and n_out >= forced_stop_at:
            fired = torch.ones_like(fired)
        item_end = torch.where(fired & ~item_done,
                               torch.full_like(item_end, n_out), item_end)
        item_done = item_done | fired
        step, mel_in = n_out, mel
        stop = item_done.any() if stop_mode == "any" else item_done.all()
        if bool(stop):
            break
    n_frames = torch.tensor(step, dtype=torch.int32, device=dev)
    frame_ends = torch.minimum(item_end, n_frames)
    return (mels.transpose(0, 1), gates.transpose(0, 1),
            aligns.transpose(0, 1), n_frames, frame_ends)
