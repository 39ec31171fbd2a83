"""The training traffic: row lengths, batch order and dropout masks.

Lengths are fixed by the traffic file (``pool_seed``), so every run seed
trains on rows of the same sizes; the seed picks the rows' contents, the
order of the batches and the masks.  Both the driver and the reference
draw from here, so they see the same batches and masks.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch


def lengths_pool(t: dict):
    """(mel frames, tokens) of the pool's rows."""
    rng = np.random.default_rng(t["pool_seed"])
    m = t["mel_frames"]
    frames = np.clip(np.rint(rng.normal(m["mean"], m["sd"], t["pool_rows"])),
                     m["min"], m["max"]).astype(np.int64)
    jitter = rng.uniform(1 - t["token_jitter"], 1 + t["token_jitter"],
                         t["pool_rows"])
    tokens = np.maximum(1, np.rint(frames / t["frames_per_token"] * jitter)
                        ).astype(np.int64)
    return frames, tokens


class Row(NamedTuple):
    text: np.ndarray        # (tokens,) int32 ids
    mel: np.ndarray         # (n_mels, frames) float32 log-mel


def make_rows(t: dict, m: dict, seed: int, device) -> List[Row]:
    """The pool's rows: lengths from :func:`lengths_pool`, token ids
    uniform over the symbols and mel values from a clipped normal, both
    drawn from ``seed`` (the mels on the card, in one draw)."""
    frames, tokens = lengths_pool(t)
    ids = np.random.default_rng(seed).integers(
        0, m["n_symbols"], int(tokens.sum()), dtype=np.int32)
    mv, n_mels = t["mel_values"], m["n_mels"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    flat = (torch.randn(int(frames.sum()) * n_mels, generator=gen,
                        device=device) * mv["sd"] + mv["mean"]).clamp_(
        mv["min"], mv["max"]).cpu().numpy()
    rows, io, im = [], 0, 0
    for f, k in zip(frames, tokens):
        rows.append(Row(ids[io:io + k], flat[im:im + f * n_mels].reshape(
            n_mels, f)))
        io += k
        im += f * n_mels
    return rows


def batch_order(n_rows: int, batch: int, seed: int, step: int) -> np.ndarray:
    """Rows of the step's batch: epochs of random order, no bucketing."""
    per_epoch = n_rows // batch
    epoch, k = divmod(step, per_epoch)
    perm = np.random.default_rng([seed, epoch]).permutation(n_rows)
    return perm[k * batch:(k + 1) * batch]


def mask_seed(seed: int, step: int) -> int:
    return (seed << 16) + step


def postnet_channels(model: dict) -> List[int]:
    n = model["postnet_n_convolutions"]
    return [model["postnet_embedding_dim"]] * (n - 1) + [model["n_mels"]]


def dropout_masks(model: dict, b: int, t_dec: int, seed: int, device
                  ) -> Dict:
    """Keep-masks of one step in ``train_step``'s layout, drawn on the
    card from the step's seed."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def keep(shape, rate):
        return torch.rand(shape, generator=gen, device=device) < 1.0 - rate

    h = model["decoder_rnn_dim"]
    return {"prenet": [keep((b, t_dec, model["prenet_dim"]),
                            model["p_prenet_dropout"]) for _ in range(2)],
            "attention": keep((t_dec, b, h), model["p_attention_dropout"]),
            "decoder": keep((t_dec, b, h), model["p_decoder_dropout"]),
            "postnet": [keep((b, c, t_dec), model["p_postnet_dropout"])
                        for c in postnet_channels(model)]}


def pad_batch(texts: Sequence[np.ndarray], mels: Sequence[np.ndarray],
              text_multiple: int, mel_multiple: int) -> Dict[str, np.ndarray]:
    """The loader's padding, written again for the reference: rows sorted
    by text length, longest first (a stable sort), zero-padded, each
    padded length rounded up to its multiple."""
    order = np.argsort([-len(t) for t in texts], kind="stable")
    texts = [texts[i] for i in order]
    mels = [mels[i] for i in order]
    up = lambda x, m: -(-x // m) * m
    tl = np.asarray([len(t) for t in texts], np.int64)
    ml = np.asarray([m.shape[1] for m in mels], np.int64)
    text = np.zeros((len(texts), up(int(tl.max()), text_multiple)), np.int64)
    mel = np.zeros((len(mels), mels[0].shape[0],
                    up(int(ml.max()), mel_multiple)), np.float32)
    for i, (t, m) in enumerate(zip(texts, mels)):
        text[i, :len(t)] = t
        mel[i, :, :m.shape[1]] = m
    return {"text": text, "text_lengths": tl, "mel": mel, "mel_lengths": ml}
