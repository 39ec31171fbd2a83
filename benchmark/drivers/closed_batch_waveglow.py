"""Offline batch synthesis with WaveGlow: ``closed_batch``'s loop of
64-sentence batches through ``infer/fused.py::synthesize_wav``, with the
vocoder ``models/waveglow.py::WaveGlow`` at the configuration's widths
(``waveglow=``), its weights drawn on the card from ``--seed`` + 2
(``harness/waveglow.py``).

Set-up makes the vocoder first, so that a program without
``tacotron2_torch.models.waveglow`` fails at once with an ImportError,
then loads the acoustic model and warms one batch as ``closed_batch``
does.  Each batch is cut to the bucket past its last stop (512 frames as
a rule) and every row is vocoded over the whole cut buffer.

The check judges the acoustic stages as ``serving.judge`` does, and
``pcm_gap`` with ``reference/waveglow.py`` on every answering row of each
kept batch (two seeded batches and the longest): the masked cut buffer the
program vocoded, from the same seed-0 noise.
"""

from __future__ import annotations

import torch

from benchmark.drivers import closed_batch
from benchmark.harness import waveglow as wg


class Driver(closed_batch.Driver):
    def setup(self) -> None:
        from tacotron2_torch.models.waveglow import WaveGlow, WaveGlowConfig
        w = wg.widths(self.cfgj)
        self.waveglow_seed = self.s.seed + 2
        with torch.device(self.s.device):
            self.waveglow = WaveGlow(WaveGlowConfig(**w))
        self.waveglow.load_state_dict(
            wg.weights(w, self.waveglow_seed, self.s.device))
        super().setup()

    def _synthesize(self, texts):
        return self.fused.synthesize_wav(self.model, texts, self.cfg,
                                         device=self.s.device,
                                         waveglow=self.waveglow)

    def release(self) -> None:
        super().release()
        self.waveglow = None

    def check(self):
        gaps = wg.judge(self.keep.kept(), self.cfgj, self.waveglow_seed,
                        self.s.device, self.s.log)
        lim = self.s.cell.limits
        return [(k, v, lim[k]) for k, v in gaps.items() if k in lim]
