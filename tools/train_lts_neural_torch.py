#!/usr/bin/env python
"""Train the neural LTS (attention seq2seq) on CMUdict, with PyTorch on a card.

The port's copy of ``tools/train_lts_neural.py``: the same data, model,
loss, schedule, optimiser, loop and export, written in PyTorch, and run on
``--device`` (``cuda`` unless asked otherwise).  A BiLSTM character
encoder and a Luong-attention LSTM phoneme decoder (3,229,960 parameters
at the defaults) learn CMUdict's pronunciations; the weights are exported
as one fp16 ``.npz`` that both packages' ``text/lts_neural.py`` read.

Holdout protocol: words with ``crc32(word) % 10 == 0`` are excluded from
training, as for the graphone n-gram, so the held-out accuracy is an
out-of-vocabulary measurement.

What differs from the JAX tool: the random numbers.  The initial weights
come from a ``torch.Generator`` seeded by ``--seed`` and the per-step
dropout masks from another, seeded by ``--seed + 1``; JAX's
``PRNGKey``/``fold_in`` streams cannot be matched.  The epoch permutation
is the JAX tool's (``np.random.default_rng(seed)``).

The recurrences (both encoder directions, the decoder) are loops of LSTM
cell steps with the input products hoisted out of the loop: one bias per
LSTM, gates in the order i, f, g, o, the padded positions walked as the
JAX scans walk them.  No hand-written kernel stands behind the JAX tool
(XLA runs its scans), and at a batch of 512 either form is bound by its
launches.

    python tools/train_lts_neural_torch.py [--epochs 30] [--batch 512]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tacotron2_torch.text.lexicon import load_lexicon  # noqa: E402
from tacotron2_torch.text.lts_neural import (  # noqa: E402
    BOS, EOS, MAX_PHONES, MAX_WORD_LEN, PAD, letter_ids)
from tacotron2_torch.utils.device import resolve_device  # noqa: E402

L_EMB = 64
ENC_H = 256          # per direction
DEC_H = 512
DEFAULT_OUT = os.path.join(ROOT, "tacotron2_torch", "text", "data",
                           "lts_neural.npz")

Params = Dict[str, torch.Tensor]


def is_holdout(word: str) -> bool:
    return zlib.crc32(word.encode()) % 10 == 0


def build_data():
    """``(letters (n, MAX_WORD_LEN), targets (n, MAX_PHONES), symbols,
    rows, hold)``: the training words' letter ids and phone ids + EOS
    (int32, zero-padded), the phone vocabulary (PAD, BOS, EOS, then the
    sorted phones), and the training and held-out ``(word, ids, phones)``
    in alphabetical order."""
    lex = load_lexicon()
    phone_set = sorted({p for ph in lex.values() for p in ph})
    phone_id = {p: i + 3 for i, p in enumerate(phone_set)}   # 0/1/2 special
    rows = []
    hold = []
    for w, ph in sorted(lex.items()):
        ids = letter_ids(w)
        if ids is None or not 1 <= len(ids) <= MAX_WORD_LEN \
                or len(ph) > MAX_PHONES - 1:
            continue
        (hold if is_holdout(w) else rows).append((w, ids, ph))
    n = len(rows)
    letters = np.zeros((n, MAX_WORD_LEN), np.int32)
    targets = np.zeros((n, MAX_PHONES), np.int32)            # phones + EOS
    for i, (_, ids, ph) in enumerate(rows):
        letters[i, :len(ids)] = ids
        targets[i, :len(ph)] = [phone_id[p] for p in ph]
        targets[i, len(ph)] = EOS
    symbols = ["<pad>", "<s>", "</s>"] + phone_set
    return letters, targets, symbols, rows, hold


def param_shapes(n_phones: int) -> Dict[str, Tuple[int, ...]]:
    """The 14 leaves of the JAX tool's ``init_params``, in its order."""
    return {
        "enc_emb": (27, L_EMB),
        "enc_fwd_wi": (L_EMB, 4 * ENC_H),
        "enc_fwd_wh": (ENC_H, 4 * ENC_H),
        "enc_fwd_b": (4 * ENC_H,),
        "enc_bwd_wi": (L_EMB, 4 * ENC_H),
        "enc_bwd_wh": (ENC_H, 4 * ENC_H),
        "enc_bwd_b": (4 * ENC_H,),
        "dec_emb": (n_phones, L_EMB),
        "dec_wi": (L_EMB + 2 * ENC_H, 4 * DEC_H),
        "dec_wh": (DEC_H, 4 * DEC_H),
        "dec_b": (4 * DEC_H,),
        "attn_w": (2 * ENC_H, DEC_H),
        "out_w": (DEC_H + 2 * ENC_H, n_phones),
        "out_b": (n_phones,),
    }


def init_params(seed: int, n_phones: int, device="cpu") -> Params:
    """Matrices uniform in +-1/sqrt(fan_in) (fan_in: the first dim),
    drawn in the JAX tool's order from a ``torch.Generator`` seeded by
    ``seed``; biases zero.  fp32, on ``device``."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in param_shapes(n_phones).items():
        if len(shape) == 1:
            out[name] = torch.zeros(shape)
        else:
            bound = 1.0 / math.sqrt(shape[0])
            out[name] = (torch.rand(shape, generator=g) * 2 - 1) * bound
    return {k: v.to(device) for k, v in out.items()}


def params_from_numpy(arrays: Dict[str, np.ndarray], device="cpu") -> Params:
    """Parameters from numpy arrays keyed as the JAX tool keys them (its
    ``init_params`` or an exported npz), as fp32 on ``device``."""
    names = param_shapes(int(np.shape(arrays["out_b"])[0]))
    return {k: torch.from_numpy(np.array(arrays[k], np.float32)).to(device)
            for k in names}


# ---------------------------------------------------------------------------
# the model: make_fns of the JAX tool


def lstm_cell(gx: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              wh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step from the hoisted input product ``gx = x @ wi + b``; gates
    i, f, g, o."""
    g = gx + h @ wh
    i, f, gg, o = g.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c2), c2


def encode(p: Params, letters: torch.Tensor) -> torch.Tensor:
    """(B, L) letter ids -> (B, L, 2 ENC_H): forward and reverse scans over
    the whole padded length."""
    xs = p["enc_emb"][letters]                           # (B, L, E)
    b, n = letters.shape
    outs = []
    for d, order in (("fwd", range(n)), ("bwd", range(n - 1, -1, -1))):
        gx = xs @ p[f"enc_{d}_wi"] + p[f"enc_{d}_b"]      # (B, L, 4H)
        h = c = xs.new_zeros(b, ENC_H)
        hs = [None] * n
        for t in order:
            h, c = lstm_cell(gx[:, t], h, c, p[f"enc_{d}_wh"])
            hs[t] = h
        outs.append(torch.stack(hs, 1))
    return torch.cat(outs, -1)


def dec_step(p: Params, enc: torch.Tensor, keys: torch.Tensor,
             lmask: torch.Tensor, gx_emb: torch.Tensor, h: torch.Tensor,
             c: torch.Tensor, ctx: torch.Tensor,
             drop: Optional[torch.Tensor] = None):
    """One decoder step.  ``gx_emb``: the previous phone's embedding
    through its rows of ``dec_wi``, plus the bias.  Dropout, where
    given, applies to the projection view only; the carried state stays
    clean.  Returns ``(h, c, ctx, logits)``."""
    gx = gx_emb + ctx @ p["dec_wi"][L_EMB:]
    h, c = lstm_cell(gx, h, c, p["dec_wh"])
    hd = h * drop if drop is not None else h
    score = torch.einsum("blh,bh->bl", keys, hd)
    score = torch.where(lmask, score, torch.full_like(score, -1e9))
    a = torch.softmax(score, -1)
    ctx = torch.einsum("bl,blh->bh", a, enc)
    logits = torch.cat([hd, ctx], -1) @ p["out_w"] + p["out_b"]
    return h, c, ctx, logits


def _start(p: Params, letters: torch.Tensor):
    enc = encode(p, letters)
    keys = enc @ p["attn_w"]
    b = letters.shape[0]
    z = enc.new_zeros(b, DEC_H)
    return enc, keys, letters > 0, z, z, enc.new_zeros(b, 2 * ENC_H)


def forward_tf(p: Params, letters: torch.Tensor, targets: torch.Tensor,
               masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Teacher-forced logits (B, P, V).  ``masks`` (P, B, DEC_H): the
    steps' dropout multipliers (keep / (1 - rate), else 0), or None."""
    enc, keys, lmask, h, c, ctx = _start(p, letters)
    b = letters.shape[0]
    prev = torch.cat([torch.full((b, 1), BOS, dtype=targets.dtype,
                                 device=targets.device), targets[:, :-1]], 1)
    gx_emb = p["dec_emb"][prev] @ p["dec_wi"][:L_EMB] + p["dec_b"]
    logits = []
    for t in range(targets.shape[1]):
        h, c, ctx, lg = dec_step(p, enc, keys, lmask, gx_emb[:, t], h, c,
                                 ctx, None if masks is None else masks[t])
        logits.append(lg)
    return torch.stack(logits, 1)


def loss_fn(p: Params, letters: torch.Tensor, targets: torch.Tensor,
            masks: Optional[torch.Tensor] = None,
            label_smooth: float = 0.0) -> torch.Tensor:
    """PAD-masked token cross-entropy, label-smoothed toward the uniform
    distribution by ``label_smooth``, over the target tokens."""
    logits = forward_tf(p, letters, targets, masks)
    mask = (targets != PAD).float()
    lp = F.log_softmax(logits, -1)
    nll = -lp.gather(-1, targets[..., None].long())[..., 0]
    if label_smooth > 0.0:
        nll = (1.0 - label_smooth) * nll - label_smooth * lp.mean(-1)
    return (nll * mask).sum() / mask.sum()


@torch.no_grad()
def greedy(p: Params, letters: torch.Tensor) -> torch.Tensor:
    """Greedy decode (B, MAX_PHONES) of phone ids."""
    enc, keys, lmask, h, c, ctx = _start(p, letters)
    prev = torch.full((letters.shape[0],), BOS, dtype=torch.long,
                      device=letters.device)
    out = []
    for _ in range(MAX_PHONES):
        gx_emb = p["dec_emb"][prev] @ p["dec_wi"][:L_EMB] + p["dec_b"]
        h, c, ctx, logits = dec_step(p, enc, keys, lmask, gx_emb, h, c, ctx)
        prev = logits.argmax(-1)
        out.append(prev)
    return torch.stack(out, 1).to(torch.int32)


def dropout_masks(gen: torch.Generator, rate: float, steps: int, b: int,
                  device) -> Optional[torch.Tensor]:
    """(steps, B, DEC_H) keep / (1 - rate) multipliers from ``gen`` (on
    ``device``), or None at rate 0."""
    if rate <= 0.0:
        return None
    keep = 1.0 - rate
    u = torch.rand((steps, b, DEC_H), generator=gen, device=device)
    return (u < keep).float() / keep


# ---------------------------------------------------------------------------
# the optimiser: optax's warmup_cosine_decay_schedule and adam


def warmup_cosine(lr: float, total_steps: int):
    """optax.warmup_cosine_decay_schedule(0, lr, W, total, lr * 0.02) with
    W = min(200, max(total // 10, 1)): a linear warmup from 0, then a
    cosine decay to 2% of ``lr`` at ``total_steps``."""
    warmup = min(200, max(total_steps // 10, 1))
    decay = total_steps - warmup
    alpha = 0.02

    def schedule(count: int) -> float:
        if count < warmup:
            return lr * min(count, warmup) / warmup
        k = min(count - warmup, decay)
        cosine = 0.5 * (1 + math.cos(math.pi * k / decay))
        return lr * ((1 - alpha) * cosine + alpha)

    return schedule


class Adam:
    """optax.adam(schedule) written out: b1 0.9, b2 0.999, eps 1e-8, the
    moments bias-corrected by the step count, the update scaled by
    ``-schedule(count)`` with the count before this step."""

    def __init__(self, params: Params, schedule, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Params, grads: Params) -> None:
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for k, p in params.items():
            g = grads[k]
            mu, nu = self.mu[k], self.nu[k]
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.add_(upd, alpha=-lr)


# ---------------------------------------------------------------------------


def heldout_batch(hold, n: int) -> Tuple[np.ndarray, List[Tuple[str, ...]]]:
    """The first ``n`` held-out words' letter ids (zero-padded) and truths."""
    sel = hold[:n]
    letters = np.zeros((len(sel), MAX_WORD_LEN), np.int32)
    for i, (_, ids, _) in enumerate(sel):
        letters[i, :len(ids)] = ids
    return letters, [tuple(ph) for _, _, ph in sel]


def word_accuracy(ids: np.ndarray, truths, symbols) -> Tuple[float, float]:
    """Greedy outputs against the truths: word accuracy, and stress-blind."""
    ok = ok_ns = 0
    for row, truth in zip(ids, truths):
        seq = []
        for t in row:
            if t == EOS:
                break
            if t > EOS:
                seq.append(symbols[t])
        ok += tuple(seq) == truth
        ok_ns += (tuple(s.rstrip("012") for s in seq)
                  == tuple(s.rstrip("012") for s in truth))
    n = max(len(truths), 1)
    return ok / n, ok_ns / n


def export(params: Params, symbols: List[str], path: str) -> None:
    """The weights as fp16 and the phone symbols into one npz."""
    out = {k: v.detach().cpu().numpy().astype(np.float16)
           for k, v in params.items()}
    out["phone_symbols"] = np.array(symbols)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **out)


def train_step(params: Params, opt: Adam, letters: torch.Tensor,
               targets: torch.Tensor, masks, smooth: float) -> torch.Tensor:
    """One optimiser step on a batch; returns the loss (not synchronised)."""
    for v in params.values():
        v.requires_grad_(True)
    loss = loss_fn(params, letters, targets, masks, smooth)
    grads = torch.autograd.grad(loss, list(params.values()))
    for v in params.values():
        v.requires_grad_(False)
    opt.step(params, dict(zip(params, grads)))
    return loss.detach()


def main(argv=None) -> dict:
    """The CLI.  Returns a summary: each epoch's mean loss, the steps, the
    training seconds, the last held-out accuracies and the file written."""
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        epilog="Dropout masks and initial weights come from torch "
               "Generators seeded by --seed: the JAX tool's PRNGKey and "
               "fold_in streams cannot be matched, so two runs of the "
               "two tools from one seed differ in their random numbers.")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--eval-n", type=int, default=1500)
    ap.add_argument("--limit", type=int, default=0,
                    help="cap training words (smoke tests)")
    ap.add_argument("--dropout", type=float, default=0.25,
                    help="decoder projection-view dropout")
    ap.add_argument("--smooth", type=float, default=0.1,
                    help="label smoothing")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)

    letters, targets, symbols, rows, hold = build_data()
    if a.limit:
        letters, targets = letters[:a.limit], targets[:a.limit]
    n, v = len(letters), len(symbols)
    print(f"train words: {n}  holdout: {len(hold)}  phone vocab: {v}",
          flush=True)

    params = init_params(a.seed, v, dev)
    steps_per_epoch = n // a.batch
    total_steps = a.epochs * steps_per_epoch
    opt = Adam(params, warmup_cosine(a.lr, total_steps))
    gen = torch.Generator(device=dev).manual_seed(a.seed + 1)

    hl, htruth = heldout_batch(hold, a.eval_n)
    hl_dev = torch.from_numpy(hl).long().to(dev)

    def heldout_acc():
        return word_accuracy(greedy(params, hl_dev).cpu().numpy(), htruth,
                             symbols)

    rng = np.random.default_rng(a.seed)
    lb_dev = torch.from_numpy(letters).long().to(dev)
    tb_dev = torch.from_numpy(targets).long().to(dev)
    losses, acc = [], None
    t0 = time.time()
    for epoch in range(a.epochs):
        perm = rng.permutation(n)
        te = time.time()
        tot = torch.zeros((), device=dev)
        for s in range(steps_per_epoch):
            idx = torch.from_numpy(
                perm[s * a.batch:(s + 1) * a.batch]).to(dev)
            masks = dropout_masks(gen, a.dropout, MAX_PHONES, len(idx), dev)
            tot += train_step(params, opt, lb_dev[idx], tb_dev[idx], masks,
                              a.smooth)
        losses.append(float(tot) / max(steps_per_epoch, 1))
        msg = (f"epoch {epoch + 1}/{a.epochs}: loss {losses[-1]:.4f} "
               f"({time.time() - te:.1f}s)")
        if (epoch + 1) % a.eval_every == 0 or epoch + 1 == a.epochs:
            acc = heldout_acc()
            msg += (f"  heldout greedy word acc {acc[0]:.4f} "
                    f"(stress-blind {acc[1]:.4f})")
        print(msg, flush=True)

    seconds = time.time() - t0
    print(f"training done in {seconds:.0f}s", flush=True)
    export(params, symbols, a.out)
    print(f"model written: {a.out} "
          f"({os.path.getsize(a.out) / 1e6:.1f} MB)", flush=True)
    return dict(losses=losses, steps=total_steps, seconds=seconds,
                heldout_acc=acc, out=a.out)


if __name__ == "__main__":
    main()
