"""Whole runs, on the CPU at a tiny size, with the timed path broken
underneath: each fault the cell can have must come out not correct under
the cell's own limits, and the unbroken run correct.  (The harness's look
for a card is skipped: the session is given the CPU.)"""

import copy

import pytest
import torch

from benchmark.harness import registry
from benchmark.harness.env import BENCH

from .helpers import batch_cell, run, train_cell


def limits(workload):
    return registry.load_json(BENCH / "limits" / f"{workload}.json")


@pytest.fixture
def train_step_module():
    import tacotron2_torch.train.step as step
    return step


def test_sound_training_run_is_correct():
    r = run(train_cell("float32", limits("train-b128")))
    assert r["correct"], r["checks"]


def test_a_step_that_leaves_its_state_unchanged(monkeypatch,
                                                train_step_module):
    real = train_step_module.train_step

    def unchanged(state, batch, **kw):
        params = {n: p.detach().clone()
                  for n, p in state.model.named_parameters()}
        opt = copy.deepcopy(state.opt_state)
        out = real(state, batch, **kw)
        with torch.no_grad():
            for n, p in state.model.named_parameters():
                p.copy_(params[n])
        state.opt_state.clear()
        state.opt_state.update(opt)
        return out

    monkeypatch.setattr(train_step_module, "train_step", unchanged)
    r = run(train_cell("float32", limits("train-b128")))
    assert not r["correct"], r["checks"]


def test_half_the_batch_left_out(monkeypatch, train_step_module):
    real = train_step_module.train_step

    def half(state, batch, masks=None, **kw):
        h = len(batch["text"]) // 2
        batch = {k: v[:h] for k, v in batch.items()}
        masks = {"prenet": [m[:h] for m in masks["prenet"]],
                 "attention": masks["attention"][:, :h],
                 "decoder": masks["decoder"][:, :h],
                 "postnet": [m[:h] for m in masks["postnet"]]}
        return real(state, batch, masks=masks, **kw)

    monkeypatch.setattr(train_step_module, "train_step", half)
    r = run(train_cell("float32", limits("train-b128")))
    assert not r["correct"], r["checks"]


@pytest.fixture
def fused_module():
    import tacotron2_torch.infer.fused as fused
    return fused


def test_a_served_frame_altered_where_it_is_decoded(monkeypatch,
                                                    fused_module):
    real = fused_module.tacotron2_infer

    def altered(model, text, **kw):
        out, n_frames, frame_ends = real(model, text, **kw)
        out.mel_coarse[0, 5] += 0.5
        out.mel_postnet[0, 5] += 0.5
        return out, n_frames, frame_ends

    monkeypatch.setattr(fused_module, "tacotron2_infer", altered)
    r = run(batch_cell("tacotron2", limits("batch-b64-gl")))
    assert not r["correct"], r["checks"]
    assert r["checks"]["mel_gap"]["value"] > 0.1


@pytest.mark.parametrize("shift", [-1, 1], ids=["early", "late"])
def test_a_stop_one_frame_off(monkeypatch, fused_module, shift):
    """The decode's stop rule off by a frame: each row's ``frame_ends``
    one before its gate fires, or one after (where the decode ran on); the
    audio is cut at the wrong stop, consistently."""
    real = fused_module.tacotron2_infer

    def off(model, text, **kw):
        out, n_frames, frame_ends = real(model, text, **kw)
        moved = torch.minimum(torch.clamp(frame_ends + shift, min=2),
                              n_frames)
        return out, n_frames, moved.to(frame_ends.dtype)

    monkeypatch.setattr(fused_module, "tacotron2_infer", off)
    r = run(batch_cell("tacotron2", limits("batch-b64-gl")))
    assert not r["correct"], r["checks"]
    assert r["checks"]["stop_gap"]["value"] > 0.5


def test_delivered_audio_altered(monkeypatch, fused_module):
    real = fused_module.synthesize_wav

    def altered(*a, **kw):
        wavs = real(*a, **kw)
        wavs[-1][len(wavs[-1]) // 2] += 4.0    # a click
        return wavs

    monkeypatch.setattr(fused_module, "synthesize_wav", altered)
    r = run(batch_cell("tacotron2", limits("batch-b64-gl")))
    assert not r["correct"], r["checks"]
    assert r["checks"]["pcm_gap"]["value"] > 3.0

