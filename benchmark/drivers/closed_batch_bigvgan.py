"""Offline batch synthesis with BigVGAN: ``closed_batch``'s loop of
64-sentence batches through ``infer/fused.py::synthesize_wav``, with the
vocoder ``models/bigvgan.py::BigVGAN`` at the configuration's widths
(``vocoder=``), its weights drawn on the card from ``--seed`` + 3
(``harness/bigvgan.py``).

Set-up makes the vocoder first, so that a program without
``tacotron2_torch.models.bigvgan`` fails at once with an ImportError, then
loads the acoustic model and warms one batch as ``closed_batch`` does.
Each batch is cut to the bucket past its last stop (512 frames as a rule)
and every row is vocoded over the whole cut buffer.

The check judges the acoustic stages as ``serving.judge`` does, and
``pcm_gap`` with ``reference/bigvgan.py`` on every answering row of each
kept batch (two seeded batches and the longest): the masked cut buffer the
program vocoded.
"""

from __future__ import annotations

import torch

from benchmark.drivers import closed_batch
from benchmark.harness import bigvgan as bv


class Driver(closed_batch.Driver):
    def setup(self) -> None:
        from tacotron2_torch.models.bigvgan import BigVGAN, BigVGANConfig
        h = bv.widths(self.cfgj)
        self.bigvgan_seed = self.s.seed + 3
        with torch.device(self.s.device):
            self.bigvgan = BigVGAN(BigVGANConfig(**h))
        self.bigvgan.load_state_dict(
            bv.weights(h, self.bigvgan_seed, self.s.device))
        super().setup()

    def _synthesize(self, texts):
        return self.fused.synthesize_wav(self.model, texts, self.cfg,
                                         device=self.s.device,
                                         vocoder=self.bigvgan)

    def release(self) -> None:
        super().release()
        self.bigvgan = None

    def check(self):
        gaps = bv.judge(self.keep.kept(), self.cfgj, self.bigvgan_seed,
                        self.s.device, self.s.log)
        lim = self.s.cell.limits
        return [(k, v, lim[k]) for k, v in gaps.items() if k in lim]
