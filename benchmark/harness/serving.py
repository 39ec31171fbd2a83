"""What the serving cells share: the sentence pool, the seeded HiFi-GAN,
the recorder of each decode the timed path runs, and the judgement of its
outputs against the reference.

The recorder replaces ``tacotron2_infer`` in the namespace of the
program's module that calls it (``infer/fused.py``) by a wrapper that
calls the original and keeps, per call, the padded token ids and lengths,
the decode's ``n_frames`` and ``frame_ends`` (device scalars, read after
the window) and, for the calls the cell keeps for its check, the outputs
themselves (references to the tensors the program made; no copy, no
synchronisation).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.harness import weights as seeded
from benchmark.harness.env import ROOT
from benchmark.harness.registry import data_file


def sentence_pool(t: dict) -> List[str]:
    """``pool`` distinct sentences of ``words.min``-``words.max`` words of
    the vocabulary, fixed by ``pool_seed``; runs take them in an order
    drawn from their seed."""
    vocab = data_file(t["vocab"])["words"]
    rng = np.random.default_rng(t["pool_seed"])
    seen, out = set(), []
    while len(out) < t["pool_sentences"]:
        k = int(rng.integers(t["words"]["min"], t["words"]["max"] + 1))
        s = " ".join(vocab[int(j)] for j in rng.integers(0, len(vocab), k))
        s += "."
        if s not in seen:
            seen.add(s)
            out.append(s)
    return out


def hifigan_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    """The V1 generator's tensors by name, drawn on the card."""
    from tacotron2_torch.models.hifigan import HiFiGAN
    shapes = {k: tuple(v.shape) for k, v in HiFiGAN().state_dict().items()}
    return seeded.draw(shapes, seeded.hifigan_rules(shapes), seed, device)


class InferRecorder:
    """Stands in for ``module.tacotron2_infer`` until :meth:`restore`."""

    def __init__(self, module) -> None:
        self.module = module
        self.orig = module.tacotron2_infer
        self.calls: List[Dict] = []
        module.tacotron2_infer = self

    def __call__(self, model, text, max_steps=None, **kw):
        out, n_frames, frame_ends = self.orig(model, text,
                                              max_steps=max_steps, **kw)
        self.calls.append({
            "tokens": np.asarray(text), "lengths":
            np.asarray(kw.get("text_lengths")),
            "max_steps": (model.cfg.max_decoder_steps if max_steps is None
                          else int(max_steps)),
            "stop_mode": kw.get("stop_mode", "any"),
            "n_frames": n_frames, "frame_ends": frame_ends, "out": out})
        return out, n_frames, frame_ends

    def restore(self) -> None:
        self.module.tacotron2_infer = self.orig

    def settle(self) -> None:
        """After the window: device scalars to host numbers."""
        for c in self.calls:
            if torch.is_tensor(c["n_frames"]):
                c["n_frames"] = int(c["n_frames"])
                c["frame_ends"] = c["frame_ends"].cpu().numpy()


class Reservoir:
    """Keeps ``k`` items drawn uniformly from a stream (a seeded
    reservoir), plus the item of the largest key seen."""

    def __init__(self, k: int, seed: int) -> None:
        self.k = k
        self.rng = np.random.default_rng([seed, 7])
        self.items: List = []
        self.seen = 0
        self.longest = None
        self.longest_key = -1

    def offer(self, item, key: float) -> List:
        """Offer an item; returns the items this offer let go of."""
        before = self.kept()
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = item
        if key > self.longest_key:
            self.longest, self.longest_key = item, key
        now = {id(x) for x in self.kept()}
        return [x for x in before + [item] if id(x) not in now]

    def kept(self) -> List:
        out = list(self.items)
        if self.longest is not None and all(x is not self.longest
                                            for x in out):
            out.append(self.longest)
        return out


# ------------------------------------------------------------- judgement
def judge(batches: Sequence[Dict], cfgj: dict, hifigan_seed: int, device,
          log=print, precision: str = "float32") -> Dict[str, float]:
    """Each batch: ``texts`` (the decode's rows), ``n`` (rows that answer
    a request), ``call`` (the recorder's entry, with ``out``), ``pcm`` (per
    answering row, the delivered audio as float) and ``griffinlim_iters``.
    Returns the widest gaps: rows whose token ids differ, the mel and the
    gate logit the reference predicts from each served frame's
    predecessors against the served ones, the served stops
    (:func:`_stop_gap`), the postnet's and the vocoder's output, each on
    what the program fed that stage."""
    from benchmark.reference import checkpoint, model as M, text
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, audio = cfgj["model"], cfgj["audio"]
    q = M.rounding(precision)
    params = checkpoint.load(str(ROOT / cfgj["serve"]["checkpoint"]), m,
                             device)
    lexicon = text.read_lexicon(
        str(ROOT / "third_party" / "cmudict" / "cmudict.gz"),
        data_file("data/vocab.json")["words"])
    hifi = None
    if cfgj["serve"]["vocoder"] == "hifigan":
        hifi = hifigan_weights(hifigan_seed, device)
    floor = float(np.float32(np.log(audio["mel_eps"])))
    hop = audio["hop_length"]
    gaps = dict(token_mismatch=0.0, mel_gap=0.0, gate_gap=0.0,
                stop_gap=0.0, postnet_gap=0.0, pcm_gap=0.0)
    threshold = float(np.log(m["gate_threshold"] / (1 - m["gate_threshold"])))
    rows = 0
    for bt in batches:
        call, n = bt["call"], bt["n"]
        ids = [text.token_ids(s, lexicon, cfgj["symbols"])
               for s in bt["texts"]]
        t_enc = call["tokens"].shape[1]
        tok = np.zeros((len(ids), t_enc), np.int64)
        for i, x in enumerate(ids):
            tok[i, :len(x)] = x
        lengths = np.asarray([len(x) for x in ids])
        same = [(tok[i] == call["tokens"][i]).all() and
                lengths[i] == call["lengths"][i] for i in range(len(ids))]
        gaps["token_mismatch"] = max(gaps["token_mismatch"],
                                     float(len(ids) - sum(same)))
        out = call["out"]
        nf, fe = call["n_frames"], call["frame_ends"]
        coarse = out.mel_coarse.float()
        tok_t = torch.as_tensor(tok, device=device)
        len_t = torch.as_tensor(lengths, device=device)
        pred, gate = M.follow(params, m, tok_t, len_t, coarse[:, :nf], nf, q)
        with torch.no_grad():
            post = coarse + M.postnet(params, m, coarse, False, q)
        gaps["stop_gap"] = max(gaps["stop_gap"], _stop_gap(
            gate[:n] - threshold, fe[:n], nf, call))
        for b in range(n):
            e = int(fe[b])
            gaps["mel_gap"] = max(gaps["mel_gap"], float(
                (pred[b, :e] - coarse[b, :e]).abs().max()))
            gaps["postnet_gap"] = max(gaps["postnet_gap"], float(
                (post[b, :e] - out.mel_postnet[b, :e].float()).abs().max()))
            gaps["gate_gap"] = max(gaps["gate_gap"], float(
                (gate[b, :e] - out.gate_logits[b, :e].float()).abs().max()))
        wav = _vocode(bt, out, fe, n, hifi, audio, floor, q, device)
        for b in range(n):
            e = int(fe[b]) * hop
            prog = torch.as_tensor(bt["pcm"][b][:e], device=device)
            if prog.numel() != e:
                gaps["pcm_gap"] = float("inf")
                continue
            gaps["pcm_gap"] = max(gaps["pcm_gap"], float(
                (wav[b][:e] - prog).abs().max()))
        rows += n
    log(f"judged {rows} rows of {len(batches)} batches: {gaps}")
    if not rows:
        return {k: float("inf") for k in gaps}
    return gaps


def _stop_gap(g, fe, nf: int, call) -> float:
    """How far the reference's gate logits ``g`` (B, n_frames), less the
    threshold's logit, lie on the wrong side of the served stops: above it
    before a row's stop (the reference stops earlier; the first frame's
    gate never stops a row), below it where a row stopped (``stop_mode``
    "all": at each row's own stop; "any": the batch stops where some row
    fires).  A stop past the decode's frames is no stop at all: inf."""
    worst = 0.0
    gated = nf < call["max_steps"]
    for b in range(len(fe)):
        e = int(fe[b])
        if not 1 <= e <= nf:
            return float("inf")
        stopped = e < call["max_steps"]
        before = g[b, 1:e - 1] if stopped else g[b, 1:e]
        if before.numel():
            worst = max(worst, float(before.max()))
        if stopped and call["stop_mode"] == "all":
            worst = max(worst, -float(g[b, e - 1]))
    if gated and call["stop_mode"] == "any":
        worst = max(worst, -float(g[:, nf - 1].max()))
    return worst


def _vocode(bt, out, fe, n, hifi, audio, floor, q, device):
    """The reference vocoder on the mel the program's vocoder was given:
    the whole buffer with each row's frames past its stop at the log
    floor, as the fused path vocodes it."""
    from benchmark.reference import vocoders
    mel = out.mel_postnet.float()
    s = mel.shape[1]
    valid = torch.arange(s, device=device)[None, :, None] < torch.as_tensor(
        fe, device=device)[:, None, None]
    mel = torch.where(valid, mel, torch.full_like(mel, floor))
    if hifi is not None:
        # the generator's receptive radius is 16 frames: 32 past the last
        # stop give every delivered sample its whole input
        cut = min(s, int(max(fe[:n])) + 32)
        wav = vocoders.hifigan(hifi, mel[:n, :cut].transpose(1, 2), q)
    else:
        # Griffin-Lim is not local and draws its initial phase for the
        # whole (B, F, S) buffer: all rows, all frames
        wav = vocoders.griffin_lim(mel.transpose(1, 2), audio,
                                   bt["griffinlim_iters"], 0, q)
    return [wav[b] for b in range(n)]
