"""Training cells: ``train/step.py::train_step`` on collated batches.

Set-up builds one training state (the program's model with weights drawn
on the card from the seed, its optimizer state), then drives it through
the traffic's ``check_steps`` first steps and ``warm_steps`` more by the
window's own call and feed, recording what the reference follows: each
step's loss, the per-leaf norm of the first gradient as Adam took it
(its first moment after one step over 1 - b1) and the per-leaf norm of
the parameters' change after the check steps.  The window goes on with
the same state.  A step is: ``collate`` of the batch's examples (the
loader's padding), the dropout masks drawn on the card from the step's
own seed and handed to ``train_step``, the step (the host-to-device copy
inside it), then a synchronise, as the loop's ``StepTimer`` does.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import device as D
from benchmark.harness import weights as seeded
from benchmark.harness.training_data import (batch_order, dropout_masks,
                                             make_rows, mask_seed)


class Driver:
    def __init__(self, session) -> None:
        self.s = session
        self.cfgj = session.cell.config
        self.t = session.cell.traffic
        self.steps: List[Dict] = []      # per window step: shapes, frames

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from tacotron2_torch.config import (AudioConfig, Config,
                                            GuidedAttentionConfig,
                                            ModelConfig, TrainConfig)
        from tacotron2_torch.data.dataset import Example, collate
        from tacotron2_torch.models.tacotron2 import Tacotron2
        from tacotron2_torch.train.optim import make_optimizer
        from tacotron2_torch.train.state import TrainState
        from tacotron2_torch.train.step import train_step

        s, t, cj = self.s, self.t, self.cfgj
        dev = s.device
        D.build_kernels(dev)
        tr = cj["train"]
        self.cfg = Config(
            audio=AudioConfig(**cj["audio"]),
            model=ModelConfig(**cj["model"]),
            guided_attention=GuidedAttentionConfig(**cj["guided_attention"]),
            train=TrainConfig(
                learning_rate=tr["learning_rate"],
                attention_lr_multiplier=tr["attention_lr_multiplier"],
                max_grad_norm=tr["max_grad_norm"], precision=tr["precision"],
                text_pad_multiple=t["text_pad_multiple"],
                mel_pad_multiple=t["mel_pad_multiple"]))
        model = Tacotron2(self.cfg.model).to(dev)
        shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        model.load_state_dict(seeded.draw(
            shapes, seeded.tacotron2_rules(shapes, cj["model"]), s.seed, dev))
        self.tx = make_optimizer(self.cfg.train)
        self.state = TrainState(
            model=model, opt_state=self.tx.init(model), step=0, loss_step=0,
            generator=torch.Generator(device=dev).manual_seed(s.seed))

        # the pool: lengths fixed by the traffic, contents from the seed
        self.examples = [Example(text=r.text, mel=r.mel) for r in
                         make_rows(t, cj["model"], s.seed, dev)]
        self._collate = lambda ex: collate(ex, t["text_pad_multiple"],
                                           t["mel_pad_multiple"])
        self._train_step = train_step

        # the first steps, which the reference follows, then warm steps
        named = dict(model.named_parameters())
        p0 = {n: p.detach().clone() for n, p in named.items()}
        self.prog_losses, self.prog_grad_norms = [], {}
        b1 = tr["b1"]
        for k in range(t["check_steps"]):
            losses = self._step(k)
            self.prog_losses.append(float(losses.total))
            if k == 0:
                mu = self.state.opt_state["mu"]
                self.prog_grad_norms = {
                    n: float(torch.linalg.vector_norm(mu[n].double()))
                    / (1.0 - b1) for n in named}
        self.prog_change_norms = {
            n: float(torch.linalg.vector_norm((named[n].detach() - p0[n])
                                              .double())) for n in named}
        del p0
        self.next_step = t["check_steps"]
        for _ in range(t.get("warm_steps", 1)):
            self._step(self.next_step)
            self.next_step += 1
        D.sync(dev)

    def _step(self, k: int, spans=None):
        rows = batch_order(len(self.examples), self.t["batch"], self.s.seed, k)
        spans = spans or (lambda name: contextlib.nullcontext())
        with spans("collate"):
            batch = self._collate([self.examples[i] for i in rows])
        with spans("dropout masks"):
            masks = dropout_masks(self.cfgj["model"], len(rows),
                                  batch["mel"].shape[2],
                                  mask_seed(self.s.seed, k), self.s.device)
        with spans("train_step"):
            _, losses, _ = self._train_step(
                self.state, batch, cfg=self.cfg, tx=self.tx,
                use_postnet=self.cfgj["train"]["use_postnet"],
                sigma_warmup_steps=self.cfgj["train"]["sigma_warmup_steps"],
                masks=masks)
        with spans("synchronize"):
            D.sync(self.s.device)
        self.steps.append(dict(
            b=len(rows), t_enc=int(batch["text"].shape[1]),
            t_dec=int(batch["mel"].shape[2]),
            mel_lengths=batch["mel_lengths"].astype(np.int64),
            text_lengths=batch["text_lengths"].astype(np.int64)))
        return losses

    # ------------------------------------------------------------ window
    def window(self, seconds: float):
        import time
        self.steps = []
        t0 = time.perf_counter_ns()
        while time.perf_counter_ns() - t0 < seconds * 1e9:
            self._step(self.next_step, self.s.spans)
            self.next_step += 1
        return t0, time.perf_counter_ns()

    def end_to_end(self) -> Dict[str, float]:
        w0, w1 = self.s.window_ns
        frames = sum(int(st["mel_lengths"].sum()) for st in self.steps)
        return {"train_frames_per_s": frames / ((w1 - w0) / 1e9)}

    def counts(self):
        return len(self.steps), 0

    def release(self) -> None:
        self.state = None
        self._train_step = None

    # ------------------------------------------------------------- check
    def check(self):
        from benchmark.reference import train as ref_train
        ref = ref_train.follow(self.cfgj, self.t, self.examples, self.s.seed,
                               self.s.device, precision="float32",
                               log=self.s.log)
        return compare(self.prog_losses, self.prog_grad_norms,
                       self.prog_change_norms, ref, self.s.cell.limits,
                       self.s.log)


def compare(losses: List[float], grad_norms: Dict[str, float],
            change_norms: Dict[str, float], ref: Dict, limits: Dict,
            log=print):
    """The training cell's numbers against the reference's, each with its
    limit: the first step's loss and the worst step's, relative to the
    reference's.  Norms are compared by the worst leaf: the gap between the two
    norms over the reference's norm of that leaf or of the median leaf,
    whichever is larger.  Leaves whose reference gradient is under a
    thousandth of the median leaf's (the biases before a BatchNorm and
    under the softmax, nought to rounding) are left out of the gradient
    and of the change: bf16 rounding alone moves them."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                       ref["losses"]))
    loss1_gap = abs(losses[0] - ref["losses"][0]) / abs(ref["losses"][0])
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]

    def worst(prog, ref_norms, names, med):
        gaps = {n: abs(prog[n] - ref_norms[n]) / max(ref_norms[n], med)
                for n in names}
        name = max(gaps, key=gaps.get)
        return gaps[name], name

    grad_gap, g_leaf = worst(grad_norms, g_ref, moved, g_med)
    all_gap, a_leaf = worst(grad_norms, g_ref, list(g_ref), g_med)
    c_ref = ref["change_norms"]
    c_med = statistics.median(c_ref[n] for n in moved)
    change_gap, c_leaf = worst(change_norms, c_ref, moved, c_med)
    log(f"losses program {losses} reference {ref['losses']}")
    log(f"leaves {len(g_ref)}, {len(moved)} moved by the rule, left out: "
        f"{sorted(set(g_ref) - set(moved))}; median gradient {g_med:.6g}, "
        f"median change {c_med:.6g}")
    log(f"worst gradient leaf {g_leaf}: program {grad_norms[g_leaf]:.6g} "
        f"reference {g_ref[g_leaf]:.6g}; over every leaf {all_gap!r} at "
        f"{a_leaf}; worst change leaf {c_leaf}: program "
        f"{change_norms[c_leaf]:.6g} reference {c_ref[c_leaf]:.6g}")
    return [(name, value, limits[name]) for name, value in
            (("loss1_gap", loss1_gap), ("loss_gap", loss_gap),
             ("grad_gap", grad_gap), ("change_gap", change_gap))
            if name in limits]
