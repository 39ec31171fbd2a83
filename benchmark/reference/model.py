"""Plain Tacotron 2 in PyTorch: the benchmark's reference for the acoustic model.

Written from the paper (arXiv:1712.05884) and the layer equations the
configuration files state, with no kernel, cache or batching of the program
under test; it imports nothing of the program.  Parameters are a dict of
tensors under the program's state-dict names, so one set of seeded or
loaded weights feeds both sides.

Every matrix product and convolution reads its inputs through ``q``, the
rounding of the precision the caller asks for (:func:`rounding`): identity
for float32, a round trip through bfloat16 or float8 (e4m3, saturated at
+-448) otherwise.  Sums, LSTM cell states, BatchNorm statistics, softmax and
the loss stay float32.  The reference runs in float32 with TF32 off; the
lower precisions serve the correctness controls.

Shapes: tokens (B, T_enc); mel targets (B, n_mels, T_dec); decoder outputs
(B, T, n_mels), gate logits (B, T), alignments (B, T, T_enc).
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Params = Dict[str, torch.Tensor]
Round = Callable[[torch.Tensor], torch.Tensor]

FP8_MAX = 448.0


def rounding(precision: str) -> Round:
    """The rounding of product inputs for ``precision``: "float32",
    "bfloat16" or "float8_e4m3fn"."""
    if precision == "float32":
        return lambda x: x.float()
    if precision == "bfloat16":
        return lambda x: x.to(torch.bfloat16).float()
    if precision == "float8_e4m3fn":
        return lambda x: (x.float().clamp(-FP8_MAX, FP8_MAX)
                          .to(torch.float8_e4m3fn).float())
    raise ValueError(f"unknown precision {precision!r}")


def linear(x, w, b=None, q: Round = rounding("float32")):
    y = torch.matmul(q(x), q(w).t())
    return y if b is None else y + b.float()


def conv_same(x, w, b=None, q: Round = rounding("float32")):
    """(B, C_in, T) -> (B, C_out, T), padding ((k-1)//2, k//2)."""
    k = w.shape[-1]
    y = F.conv1d(F.pad(q(x), ((k - 1) // 2, k // 2)), q(w))
    return y if b is None else y + b.float()[None, :, None]


def batchnorm(x, p: Params, name: str, train: bool, eps: float):
    """Batch statistics over (B, T) when training (biased variance, one
    pass), running statistics otherwise."""
    if train:
        mean = x.mean(dim=(0, 2))
        var = (x.square().mean(dim=(0, 2)) - mean * mean).clamp_min(0.0)
    else:
        mean, var = p[name + ".running_mean"], p[name + ".running_var"]
    inv = torch.rsqrt(var + eps) * p[name + ".weight"]
    return (x - mean[None, :, None]) * inv[None, :, None] \
        + p[name + ".bias"][None, :, None]


def dropout(x, keep_mask: Optional[torch.Tensor], rate: float):
    if keep_mask is None or rate <= 0.0:
        return x
    return torch.where(keep_mask.bool(), x / (1.0 - rate),
                       torch.zeros_like(x))


def lstm_cell(p: Params, name: str, x, h, c, q: Round):
    g = (linear(x, p[name + ".weight_ih"], q=q)
         + linear(h, p[name + ".weight_hh"], q=q)
         + p[name + ".bias_ih"] + p[name + ".bias_hh"])
    i, f, gg, o = g.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


def encoder(p: Params, cfg: dict, tokens, train: bool, q: Round):
    """(B, T_enc) -> memory (B, T_enc, 512): embedding, three conv + BN +
    ReLU, a bidirectional LSTM over the whole padded length."""
    x = F.embedding(tokens, p["encoder.embedding.weight"]).transpose(1, 2)
    for i in range(cfg["encoder_n_convolutions"]):
        x = conv_same(x, p[f"encoder.convs.{i}.weight"],
                      p[f"encoder.convs.{i}.bias"], q)
        x = torch.relu(batchnorm(x, p, f"encoder.bns.{i}", train,
                                 cfg["batchnorm_eps"]))
    xs = x.transpose(1, 2)
    b, t, _ = xs.shape
    outs = []
    for direction, steps in (("fwd", range(t)),
                             ("bwd", range(t - 1, -1, -1))):
        hid = cfg["encoder_embedding_dim"] // 2
        h = xs.new_zeros(b, hid)
        c = xs.new_zeros(b, hid)
        seq = [None] * t
        for i in steps:
            h, c = lstm_cell(p, f"encoder.lstm.{direction}", xs[:, i], h, c, q)
            seq[i] = h
        outs.append(torch.stack(seq, dim=1))
    return torch.cat(outs, dim=-1)


def prenet(p: Params, x, masks: Optional[List], rate: float, q: Round):
    for i in range(2):
        x = torch.relu(linear(x, p[f"decoder.prenet.{i}.weight"], q=q))
        x = dropout(x, None if masks is None else masks[i], rate)
    return x


class Carry(NamedTuple):
    h_att: torch.Tensor
    c_att: torch.Tensor
    h_dec: torch.Tensor
    c_dec: torch.Tensor
    context: torch.Tensor
    prev: torch.Tensor
    cum: torch.Tensor


def init_carry(b: int, t_enc: int, cfg: dict, device) -> Carry:
    z = lambda d: torch.zeros(b, d, device=device)
    h = cfg["decoder_rnn_dim"]
    return Carry(z(h), z(h), z(h), z(h), z(cfg["encoder_embedding_dim"]),
                 z(t_enc), z(t_enc))


def decoder_step(p: Params, cfg: dict, pre, carry: Carry, memory, pm, mask,
                 q: Round, mka=None, mkd=None):
    """One decoder step from a prenetted frame.  Returns (carry, mel
    (B, n_mels), gate logit (B,), alignment (B, T_enc))."""
    a = "decoder.attention"
    h_att, c_att = lstm_cell(p, "decoder.attention_lstm",
                             torch.cat([pre, carry.context], -1),
                             carry.h_att, carry.c_att, q)
    h_att = dropout(h_att, mka, cfg["p_attention_dropout"])
    loc = conv_same(torch.stack([carry.prev, carry.cum], 1),
                    p[a + ".location_conv.weight"], q=q)
    qsum = (linear(h_att, p[a + ".query_layer.weight"], q=q)[:, None, :]
            + pm + linear(loc.transpose(1, 2),
                          p[a + ".location_dense.weight"], q=q))
    energies = ((torch.matmul(q(torch.tanh(qsum)), q(p[a + ".v.weight"][0]))
                 + p[a + ".v.bias"][0]) * p[a + ".energy_scale"])
    attn = torch.softmax(energies.masked_fill(mask, -1e9), dim=1)
    context = torch.einsum("bt,btd->bd", q(attn), q(memory))
    h_dec, c_dec = lstm_cell(p, "decoder.decoder_lstm",
                             torch.cat([h_att, context], -1),
                             carry.h_dec, carry.c_dec, q)
    h_dec = dropout(h_dec, mkd, cfg["p_decoder_dropout"])
    heads = linear(torch.cat([h_dec, context], -1),
                   torch.cat([p["decoder.linear_projection.weight"],
                              p["decoder.gate_layer.weight"]]),
                   torch.cat([p["decoder.linear_projection.bias"],
                              p["decoder.gate_layer.bias"]]), q)
    carry = Carry(h_att, c_att, h_dec, c_dec, context, attn,
                  carry.cum + attn)
    return carry, heads[:, :-1], heads[:, -1], attn


def pad_mask(lengths, t: int):
    return torch.arange(t, device=lengths.device)[None, :] >= lengths[:, None]


def postnet(p: Params, cfg: dict, mel_btm, train: bool, q: Round,
            masks: Optional[List] = None):
    """Coarse mels (B, T, n_mels) -> residual (B, T, n_mels)."""
    n = cfg["postnet_n_convolutions"]
    x = mel_btm.transpose(1, 2)
    for i in range(n):
        x = conv_same(x, p[f"postnet.convs.{i}.weight"],
                      p[f"postnet.convs.{i}.bias"], q)
        x = batchnorm(x, p, f"postnet.bns.{i}", train, cfg["batchnorm_eps"])
        if i < n - 1:
            x = torch.tanh(x)
        if train:
            x = dropout(x, None if masks is None else masks[i],
                        cfg["p_postnet_dropout"])
    return x.transpose(1, 2)


def teacher_forced(p: Params, cfg: dict, tokens, text_lengths, mel_targets,
                   masks: Dict, q: Round, remat: bool = False):
    """The training forward (batch statistics, the dropout keep-masks
    ``masks`` of the program's ``train_step``: "prenet" [2 x (B, T, 256)],
    "attention" and "decoder" (T, B, H), "postnet" [5 x (B, C, T)]).
    With ``remat`` each decoder step is recomputed in the backward
    (``torch.utils.checkpoint``): the same arithmetic in less memory, for
    the lower-precision controls whose roundings keep a copy of every
    product input.  Returns (mel_postnet, mel_coarse, gates,
    alignments)."""
    memory = encoder(p, cfg, tokens, True, q)
    b, t_enc, _ = memory.shape
    t_dec = mel_targets.shape[2]
    tgt = mel_targets.transpose(1, 2)
    frames = torch.cat([torch.zeros_like(tgt[:, :1]), tgt[:, :-1]], 1)
    pre = prenet(p, frames, masks["prenet"], cfg["p_prenet_dropout"], q)
    pm = linear(memory, p["decoder.attention.memory_layer.weight"], q=q)
    mask = pad_mask(text_lengths, t_enc)
    carry = init_carry(b, t_enc, cfg, memory.device)
    mels, gates, aligns = [], [], []
    for t in range(t_dec):
        args = (p, cfg, pre[:, t], carry, memory, pm, mask, q,
                masks["attention"][t], masks["decoder"][t])
        carry, mel, gate, attn = (
            checkpoint(decoder_step, *args, use_reentrant=False) if remat
            else decoder_step(*args))
        mels.append(mel)
        gates.append(gate)
        aligns.append(attn)
    coarse = torch.stack(mels, 1)
    post = coarse + postnet(p, cfg, coarse, True, q, masks["postnet"])
    return post, coarse, torch.stack(gates, 1), torch.stack(aligns, 1)


# ---------------------------------------------------------------- loss
def _bce(logits, labels):
    return (logits.clamp_min(0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def loss(post, coarse, gates, aligns, mel_targets, mel_lengths,
         text_lengths, loss_step: int, g: dict, sigma_warmup_steps: int):
    """Masked L1 on both mels + gate BCE over the batch's longest mel +
    guided-attention KL with the entropy-adaptive weight (the equations of
    the configuration file's ``loss`` block).  Returns the total."""
    b, t_dec, n_mels = coarse.shape
    t_enc = aligns.shape[2]
    dev = coarse.device
    tgt = mel_targets.transpose(1, 2)
    steps = torch.arange(t_dec, device=dev)[None, :]
    valid = (steps < mel_lengths[:, None])[..., None].float()
    max_mel = mel_lengths.max()
    window = (steps < max_mel).expand(b, t_dec).float()
    n_valid = valid.sum() * n_mels
    l_mel = (((coarse - tgt).abs() * valid).sum()
             + ((post - tgt).abs() * valid).sum()) / n_valid
    gate_tgt = (steps >= (mel_lengths[:, None] - 1)).float()
    l_gate = (_bce(gates, gate_tgt) * window).sum() / (window.sum() + 1e-8)

    lb = text_lengths.float()[:, None, None]
    init_sigma = torch.clamp(lb * g["initial_sigma_factor"], 3.0,
                             g["max_sigma_cap"])
    progress = min(1.0, float(loss_step) / float(sigma_warmup_steps))
    sigma = init_sigma - (init_sigma - g["min_sigma"]) * progress
    t = torch.arange(t_dec, dtype=torch.float32, device=dev)[None, :, None]
    pos = torch.arange(t_enc, dtype=torch.float32, device=dev)[None, None, :]
    eff = max_mel.float()
    expected = torch.minimum(torch.floor(t * lb / eff), lb - 1.0)
    gauss = torch.exp(-0.5 * ((pos - expected) / sigma) ** 2)
    gauss = torch.where(pos < lb, gauss, torch.zeros_like(gauss))
    gauss = gauss / (gauss.sum(dim=2, keepdim=True) + 1e-8)
    target = torch.where(t < eff, gauss, torch.zeros_like(gauss))
    log_pred = torch.log(aligns.clamp_min(1e-8))
    tlogt = torch.where(target > 0,
                        target * torch.log(target.clamp_min(1e-30)),
                        torch.zeros_like(target))
    kl = torch.clamp((tlogt - target * log_pred).sum() / b / eff,
                     max=g["kl_clamp"])
    entropy = ((-(aligns.clamp_min(1e-8) * log_pred).sum(dim=2)) * window
               ).sum() / window.sum()
    weight = torch.where(
        entropy <= g["entropy_target"],
        torch.clamp(g["weight_start"] * entropy.clamp_min(0.0)
                    / g["entropy_target"], min=g["min_weight"]),
        torch.full_like(entropy, g["weight_start"]))
    return l_mel + l_gate + weight * kl


# ------------------------------------------------------------ optimizer
def adam_step(params: Params, grads: Params, state: Dict, opt: dict,
              count: int, attention_prefix: str = "decoder.attention."):
    """Clip by global norm, then Adam in optax's form (eps outside the
    square root, bias-corrected), the attention parameters at
    ``lr * attention_lr_multiplier``; in place.  Returns the clipped
    gradients the moments took."""
    names = list(grads)
    g_norm = torch.sqrt(sum(grads[n].square().sum() for n in names))
    scale = torch.where(g_norm < opt["max_grad_norm"],
                        torch.ones_like(g_norm),
                        opt["max_grad_norm"] / g_norm)
    n = count + 1
    bc1, bc2 = 1.0 - opt["b1"] ** n, 1.0 - opt["b2"] ** n
    clipped = {}
    for name in names:
        g = grads[name] * scale
        clipped[name] = g
        m = state.setdefault("mu", {}).setdefault(name, torch.zeros_like(g))
        v = state.setdefault("nu", {}).setdefault(name, torch.zeros_like(g))
        m.mul_(opt["b1"]).add_(g, alpha=1.0 - opt["b1"])
        v.mul_(opt["b2"]).addcmul_(g, g, value=1.0 - opt["b2"])
        lr = opt["learning_rate"] * (opt["attention_lr_multiplier"]
                                     if name.startswith(attention_prefix)
                                     else 1.0)
        params[name].sub_(lr * (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"]))
    return clipped


# ------------------------------------------------------------ inference
@torch.no_grad()
def encode(p: Params, cfg: dict, tokens, text_lengths, q: Round):
    memory = encoder(p, cfg, tokens, False, q)
    pm = linear(memory, p["decoder.attention.memory_layer.weight"], q=q)
    return memory, pm, pad_mask(text_lengths, tokens.shape[1])


@torch.no_grad()
def follow(p: Params, cfg: dict, tokens, text_lengths, served_coarse,
           n_steps: int, q: Round):
    """The eval-mode decoder fed the program's own served frames: a first
    step on the zero frame (not recorded, as the program drops it), then
    step t on served frame t - 1 (step 0 on the dropped frame's own
    output).  Returns (mels (B, n_steps, n_mels), gate logits (B,
    n_steps)); each is the reference's prediction of the served frame."""
    memory, pm, mask = encode(p, cfg, tokens, text_lengths, q)
    b, t_enc, _ = memory.shape
    carry = init_carry(b, t_enc, cfg, memory.device)
    rate = cfg["p_prenet_dropout"]
    frame = torch.zeros(b, cfg["n_mels"], device=memory.device)
    carry, frame, _, _ = decoder_step(
        p, cfg, prenet(p, frame, None, rate, q), carry, memory, pm, mask, q)
    mels, gates = [], []
    for t in range(n_steps):
        if t > 0:
            frame = served_coarse[:, t - 1]
        carry, mel, gate, _ = decoder_step(
            p, cfg, prenet(p, frame, None, rate, q), carry, memory, pm,
            mask, q)
        mels.append(mel)
        gates.append(gate)
    return torch.stack(mels, 1), torch.stack(gates, 1)


@torch.no_grad()
def decode(p: Params, cfg: dict, tokens, text_lengths, max_steps: int,
           stop_mode: str, q: Round):
    """Free-running gate-stopped decode (the control's stand-in for the
    program): returns (coarse (B, max_steps, n_mels) with zeros past the
    last step, gate logits (B, max_steps), frame_ends (B,), n_frames)."""
    memory, pm, mask = encode(p, cfg, tokens, text_lengths, q)
    b, t_enc, _ = memory.shape
    dev = memory.device
    carry = init_carry(b, t_enc, cfg, dev)
    rate = cfg["p_prenet_dropout"]
    frame = torch.zeros(b, cfg["n_mels"], device=dev)
    carry, frame, _, _ = decoder_step(
        p, cfg, prenet(p, frame, None, rate, q), carry, memory, pm, mask, q)
    mels = torch.zeros(b, max_steps, cfg["n_mels"], device=dev)
    gates = torch.full((b, max_steps), -1e9, device=dev)
    ends = torch.full((b,), max_steps, dtype=torch.int64, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    step = 0
    while step < max_steps:
        carry, frame, gate, _ = decoder_step(
            p, cfg, prenet(p, frame, None, rate, q), carry, memory, pm,
            mask, q)
        mels[:, step] = frame
        gates[:, step] = gate
        step += 1
        fired = (torch.sigmoid(gate) > cfg["gate_threshold"]) & (step > 1)
        ends = torch.where(fired & ~done, torch.full_like(ends, step), ends)
        done |= fired
        if bool(done.any() if stop_mode == "any" else done.all()):
            break
    return (mels, gates, torch.minimum(ends, torch.full_like(ends, step)),
            step)
