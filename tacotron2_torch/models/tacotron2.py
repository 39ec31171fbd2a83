"""Full Tacotron 2 model: encoder + decoder + postnet (+ optional speaker).

Counterpart of ``tacotron2_tpu/models/tacotron2.py``:
:func:`tacotron2_infer` is the eval-mode token -> mel path,
:func:`tacotron2_forward` the teacher-forced forward that training and
validation run.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..parallel.collectives import all_reduce_replicated, is_distributed
from ..utils.device import check_module_device, resolve_device
from ..utils.profiling import span
from .decoder import Decoder, decoder_infer, decoder_teacher_forced
from .encoder import Encoder, encoder_apply
from .layers import BatchNorm, Conv1d, Embedding, Linear, LSTMCell
from .postnet import Postnet, postnet_apply


ArrayLike = Union[torch.Tensor, np.ndarray, Sequence]


class Tacotron2Output(NamedTuple):
    mel_postnet: torch.Tensor   # (B, T_dec, n_mels)
    mel_coarse: torch.Tensor    # (B, T_dec, n_mels)
    gate_logits: torch.Tensor   # (B, T_dec)
    alignments: torch.Tensor    # (B, T_dec, T_enc)


class Tacotron2(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.postnet = Postnet(cfg)
        if cfg.n_speakers > 1:
            self.speaker_embedding = Embedding(cfg.n_speakers,
                                               cfg.speaker_embedding_dim)
            self.speaker_proj = Linear(cfg.speaker_embedding_dim,
                                       cfg.encoder_embedding_dim, bias=False)

    def forward(self, *args, **kwargs) -> Tacotron2Output:
        """The teacher-forced forward (:func:`tacotron2_forward`'s body),
        so that ``torch.func.functional_call`` can run it on a cast copy of
        the parameters."""
        return _teacher_forced(self, *args, **kwargs)


def replace_config(model: Tacotron2, **changes) -> ModelConfig:
    """Change fields of the model's config (``decoder_megakernel``,
    ``fused_convbn``, ...) in place: the model and each of its parts that
    keeps the config get the same new one, so they cannot drift apart.
    Fields that size a layer cannot be changed on a built model."""
    cfg = dataclasses.replace(model.cfg, **changes)
    for m in model.modules():
        if isinstance(getattr(m, "cfg", None), ModelConfig):
            m.cfg = cfg
    return cfg


@torch.no_grad()
def init_weights(model: Tacotron2, seed: int) -> Tacotron2:
    """Random weights drawn from ``seed`` with the JAX package's init
    distributions (uniform +-1/sqrt(fan_in) for linear and conv layers,
    +-1/sqrt(H) for LSTMs, N(0, 1) embeddings, identity BatchNorm, gate
    bias ``cfg.gate_bias_init``).  Drawn on the CPU, so the weights do not
    depend on the model's device."""
    gen = torch.Generator().manual_seed(seed)

    def uniform(p, bound):
        p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)

    for m in model.modules():
        if isinstance(m, Linear):
            bound = m.weight.shape[1] ** -0.5
            uniform(m.weight, bound)
            if m.bias is not None:
                uniform(m.bias, bound)
        elif isinstance(m, Conv1d):
            bound = (m.weight.shape[1] * m.weight.shape[2]) ** -0.5
            uniform(m.weight, bound)
            if m.bias is not None:
                uniform(m.bias, bound)
        elif isinstance(m, LSTMCell):
            for p in (m.weight_ih, m.weight_hh, m.bias_ih, m.bias_hh):
                uniform(p, m.hidden ** -0.5)
        elif isinstance(m, Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen))
        elif isinstance(m, BatchNorm):
            for t, v in ((m.weight, 1.0), (m.bias, 0.0),
                         (m.running_mean, 0.0), (m.running_var, 1.0)):
                t.fill_(v)
    model.decoder.gate_layer.bias.fill_(model.cfg.gate_bias_init)
    model.decoder.attention.energy_scale.fill_(model.cfg.energy_scale_init)
    return model


def cast_params_bf16(model: Tacotron2) -> Tacotron2:
    """bf16 copy of the model's float weights for serving (BatchNorm running
    statistics stay fp32); products still accumulate in fp32."""
    out = copy.deepcopy(model)
    for p in out.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)
    return out


def make_pad_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool mask, True where padding."""
    ids = torch.arange(max_len, device=lengths.device)[None, :]
    return ids >= lengths[:, None]


@torch.no_grad()
def init_projection_bias(model: Tacotron2, mel_targets: ArrayLike) -> None:
    """Set the decoder projection bias, in place, to the per-channel means
    of a batch of mel targets (B, n_mels, T); under a data-parallel group,
    of the global batch (each rank holds its rows)."""
    bias = model.decoder.linear_projection.bias
    if not torch.is_tensor(mel_targets):
        mel_targets = torch.from_numpy(np.asarray(mel_targets))
    mel = mel_targets.to(bias.device).float()
    if not is_distributed():
        bias.copy_(mel.mean(dim=(0, 2)))
        return
    sums = all_reduce_replicated(torch.cat([
        mel.sum(dim=(0, 2)),
        mel.new_full((1,), float(mel.shape[0] * mel.shape[2]))]))
    bias.copy_(sums[:-1] / sums[-1])


_warned_default_speaker = False


def make_speaker_ids(speaker_id, batch: int, cfg: ModelConfig
                     ) -> Optional[np.ndarray]:
    """Validated (B,) speaker ids: one id for the batch or one per item;
    ``None`` entries default to speaker 0 on a multi-speaker model.
    Out-of-range ids raise.  Returns None for a single-speaker model."""
    if isinstance(speaker_id, (list, tuple)):
        if len(speaker_id) != batch:
            raise ValueError(f"got {len(speaker_id)} speaker_ids for a "
                             f"batch of {batch}")
        per_item = list(speaker_id)
    else:
        per_item = [speaker_id] * batch
    if cfg.n_speakers <= 1:
        for sid in per_item:
            if sid not in (None, 0):
                raise ValueError(
                    f"speaker_id={sid} given but the model is "
                    f"single-speaker (n_speakers={cfg.n_speakers})")
        return None
    if any(sid is None for sid in per_item):
        global _warned_default_speaker
        if not _warned_default_speaker:
            _warned_default_speaker = True
            print("[speaker] multi-speaker model, no speaker_id given: "
                  "using speaker 0 (notice printed once)")
    ids = []
    for sid in per_item:
        sid = 0 if sid is None else int(sid)
        if not (0 <= sid < cfg.n_speakers):
            raise ValueError(f"speaker_id={sid} out of range "
                             f"[0, {cfg.n_speakers})")
        ids.append(sid)
    return np.asarray(ids, np.int64)


def _condition_memory(model: Tacotron2, memory: torch.Tensor,
                      speaker_ids: Optional[torch.Tensor]) -> torch.Tensor:
    """Add the projected speaker embedding to every encoder position."""
    if model.cfg.n_speakers > 1 and speaker_ids is not None:
        emb = model.speaker_embedding(speaker_ids)
        memory = memory + model.speaker_proj(emb)[:, None, :]
    return memory


def _as_long(x: ArrayLike, device: torch.device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=torch.long)


@torch.no_grad()
def tacotron2_infer(model: Tacotron2, text: ArrayLike,
                    max_steps: Optional[int] = None,
                    gate_threshold: Optional[float] = None,
                    drop_first_frame: bool = True,
                    speaker_ids: Optional[ArrayLike] = None,
                    text_lengths: Optional[ArrayLike] = None,
                    stop_mode: str = "any",
                    forced_stop_at: Optional[int] = None,
                    device: Union[str, torch.device] = "cuda"):
    """Autoregressive inference (eval mode) on ``device``, where the model
    must already lie.

    ``text`` (B, T_enc) token ids; ``text_lengths`` masks padded encoder
    positions (None = unpadded); ``stop_mode`` as in ``decoder_infer``.
    Returns (Tacotron2Output with time axis S = max_steps, n_frames 0-d
    int32, frame_ends (B,) int32).
    """
    device = resolve_device(device)
    check_module_device(model, device)
    cfg = model.cfg
    max_steps = cfg.max_decoder_steps if max_steps is None else max_steps
    gate_threshold = (cfg.gate_threshold if gate_threshold is None
                      else gate_threshold)
    text = _as_long(text, device)
    memory = encoder_apply(model.encoder, text)
    with span("decode"):
        if speaker_ids is not None:
            speaker_ids = _as_long(speaker_ids, device)
        memory = _condition_memory(model, memory, speaker_ids)
        mask = None
        if text_lengths is not None:
            mask = make_pad_mask(_as_long(text_lengths, device),
                                 text.shape[1])
        (mel_coarse, gate_logits, alignments, n_frames,
         frame_ends) = decoder_infer(
            model.decoder, memory, max_steps, gate_threshold,
            drop_first_frame=drop_first_frame, mask=mask,
            stop_mode=stop_mode, forced_stop_at=forced_stop_at)
    with span("postnet"):
        residual = postnet_apply(model.postnet, mel_coarse.transpose(1, 2))
        mel_postnet = mel_coarse + residual.transpose(1, 2)
    out = Tacotron2Output(mel_postnet=mel_postnet, mel_coarse=mel_coarse,
                          gate_logits=gate_logits, alignments=alignments)
    return out, n_frames, frame_ends


def _teacher_forced(model: Tacotron2, text: torch.Tensor,
                    mel_targets: torch.Tensor,
                    text_lengths: Optional[torch.Tensor], train: bool,
                    use_postnet: bool,
                    speaker_ids: Optional[torch.Tensor],
                    generator: Optional[torch.Generator],
                    masks: Optional[Dict[str, object]]) -> Tacotron2Output:
    b, t_enc = text.shape
    memory = encoder_apply(model.encoder, text, train)
    memory = _condition_memory(model, memory, speaker_ids)
    if text_lengths is None:
        text_lengths = torch.full((b,), t_enc, device=text.device)
    enc_mask = make_pad_mask(text_lengths, t_enc)
    mel_coarse, gate_logits, alignments = decoder_teacher_forced(
        model.decoder, memory, mel_targets, enc_mask, train, generator, masks)
    if use_postnet:
        residual = postnet_apply(
            model.postnet, mel_coarse.transpose(1, 2), train, generator,
            None if masks is None else masks.get("postnet"))
        mel_postnet = mel_coarse + residual.transpose(1, 2)
    else:
        mel_postnet = mel_coarse  # postnet-freeze bypass
    return Tacotron2Output(mel_postnet=mel_postnet, mel_coarse=mel_coarse,
                           gate_logits=gate_logits, alignments=alignments)


def tacotron2_forward(model: Tacotron2, text: ArrayLike,
                      mel_targets: ArrayLike,
                      text_lengths: Optional[ArrayLike], train: bool,
                      use_postnet: bool = True,
                      speaker_ids: Optional[ArrayLike] = None,
                      generator: Optional[torch.Generator] = None,
                      masks: Optional[Dict[str, object]] = None,
                      params: Optional[Dict[str, torch.Tensor]] = None,
                      device: Union[str, torch.device] = "cuda"
                      ) -> Tacotron2Output:
    """Teacher-forced forward pass on ``device``, where the model must
    already lie.

    Args:
        text: (B, T_enc) token ids (zero-padded).
        mel_targets: (B, n_mels, T_dec) float32.
        text_lengths: (B,) true lengths; None = unpadded.
        train: batch statistics in BatchNorm (the running ones are updated
            in place) and dropout; masks are drawn from ``generator`` or
            taken from ``masks`` (keys ``"prenet"``, ``"attention"``,
            ``"decoder"``, ``"postnet"``; see ``decoder_teacher_forced`` and
            ``postnet_apply``).
        use_postnet: False bypasses the postnet (the freeze phase).
        params: tensors that stand in for the model's parameters by name
            (a compute-dtype cast of the masters, ``train/step.py``).
    """
    device = resolve_device(device)
    check_module_device(model, device)
    text = _as_long(text, device)
    if not torch.is_tensor(mel_targets):
        mel_targets = torch.from_numpy(np.asarray(mel_targets))
    mel_targets = mel_targets.to(device=device, dtype=torch.float32)
    if text_lengths is not None:
        text_lengths = _as_long(text_lengths, device)
    if speaker_ids is not None:
        speaker_ids = _as_long(speaker_ids, device)
    args = (text, mel_targets, text_lengths, train, use_postnet, speaker_ids,
            generator, masks)
    if params is None:
        return model(*args)
    return torch.func.functional_call(model, params, args)
