"""Offline batch synthesis: a closed loop of batches of sentences through
``infer/fused.py::synthesize_wav``, the route of ``inference_torch.py
--batch_file``, with the configuration's vocoder (HiFi-GAN from seeded
weights, or Griffin-Lim).

Set-up loads the trained checkpoint as ``load_model`` serves it, makes the
HiFi-GAN generator on the card where the configuration has one, and runs
one batch of the traffic end to end, which warms every shape a batch uses
(the fused path's buffers are ``max_decoder_steps`` long whatever the
text).  The window sends batch after batch, each the next ``batch``
sentences of the seed's order of the pool; a batch is done when its
trimmed waveforms are on the host.  The decodes of a seeded sample of the
window's batches, with the longest among them, are kept for the check.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from benchmark.harness import device as D
from benchmark.harness import serving


class Driver:
    def __init__(self, session) -> None:
        self.s = session
        self.cfgj = session.cell.config
        self.t = session.cell.traffic
        self.batches: List[Dict] = []

    def setup(self) -> None:
        from tacotron2_torch.config import AudioConfig, Config, ModelConfig
        from tacotron2_torch.infer import fused
        from tacotron2_torch.infer.synthesize import load_model

        s, cj = self.s, self.cfgj
        dev = s.device
        D.build_kernels(dev, ("decoder_infer", "conv_bn_act",
                              "attention_tail"))
        self.cfg = Config(audio=AudioConfig(**cj["audio"]),
                          model=ModelConfig(**cj["model"]))
        from benchmark.harness.env import ROOT
        self.model = load_model(str(ROOT / cj["serve"]["checkpoint"]),
                                self.cfg, dev)
        self.hifigan = None
        self.hifigan_seed = s.seed + 1
        if cj["serve"]["vocoder"] == "hifigan":
            from tacotron2_torch.models.hifigan import HiFiGAN
            self.hifigan = HiFiGAN().to(dev)
            self.hifigan.load_state_dict(
                serving.hifigan_weights(self.hifigan_seed, dev))
        self.pool = serving.sentence_pool(self.t)
        self.order = np.random.default_rng(s.seed).permutation(len(self.pool))
        self.fused = fused
        self.recorder = serving.InferRecorder(fused)
        self.keep = serving.Reservoir(self.t["check_batches"], s.seed)
        warm = np.random.default_rng([s.seed, 1]).choice(
            len(self.pool), self.t["batch"], replace=False)
        self._synthesize([self.pool[i] for i in warm])
        self.recorder.calls.clear()
        self.next_batch = 0

    def _synthesize(self, texts):
        return self.fused.synthesize_wav(
            self.model, texts, self.cfg, hifigan_params=self.hifigan,
            gl_iters=self.cfgj["serve"].get("griffinlim_iters", 60),
            device=self.s.device)

    def _texts(self, k: int) -> List[str]:
        b = self.t["batch"]
        n = len(self.pool) // b
        idx = self.order[(k % n) * b:(k % n + 1) * b]
        return [self.pool[i] for i in idx]

    def window(self, seconds: float):
        sr = self.cfgj["audio"]["sampling_rate"]
        t0 = time.perf_counter_ns()
        while time.perf_counter_ns() - t0 < seconds * 1e9:
            texts = self._texts(self.next_batch)
            self.next_batch += 1
            with self.s.spans("synthesize_wav"):
                wavs = self._synthesize(texts)
            call = self.recorder.calls[-1]
            bt = {"texts": texts, "n": len(texts), "call": call,
                  "pcm": wavs, "audio_s": sum(len(w) for w in wavs) / sr,
                  "vocode": "full",
                  "griffinlim_iters": self.cfgj["serve"].get(
                      "griffinlim_iters", 60)}
            self.batches.append(bt)
            key = max(len(w) for w in wavs)
            for gone in self.keep.offer(bt, key):
                gone["call"]["out"] = None      # outputs the check skips
                gone["pcm"] = None
        t1 = time.perf_counter_ns()
        self.recorder.settle()
        return t0, t1

    def end_to_end(self) -> Dict[str, float]:
        w0, w1 = self.s.window_ns
        return {"audio_s_per_s": sum(b["audio_s"] for b in self.batches)
                / ((w1 - w0) / 1e9)}

    def counts(self):
        return len(self.batches), 0

    def release(self) -> None:
        self.recorder.restore()
        self.model = None
        self.hifigan = None

    def check(self):
        kept = self.keep.kept()
        gaps = serving.judge(kept, self.cfgj, self.hifigan_seed,
                             self.s.device, self.s.log)
        lim = self.s.cell.limits
        return [(k, v, lim[k]) for k, v in gaps.items() if k in lim]
