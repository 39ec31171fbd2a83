"""The WaveGlow cell (``batch-b64-waveglow``): its counts against a hand
sum of the layers, its files through ``registry.load_cell``, its seeded
weights, and the planted faults, which must come out not correct under the
cell's limits on the CPU at small widths (the acoustic model at its own
widths, a batch of two); the bf16 control at the cell's size on the card
(``cuda``: skips without one)."""

import copy

import pytest
import torch

from benchmark import controls_waveglow
from benchmark.counts import waveglow as K
from benchmark.harness import registry
from benchmark.harness import waveglow as wg
from benchmark.harness.env import BENCH

from .helpers import run

CELL = "batch-b64-waveglow"
SMALL = dict(n_channels=16, n_layers=2, n_flows=4, n_early_every=2)


def published():
    return wg.widths(registry.load_cell(CELL).config)


def test_counts_by_hand():
    w = published()
    c, cond = 512, 80 * 8
    per_flow = {h: h * c + 8 * (c * 2 * c * 3) + 8 * cond * 2 * c
                + 7 * c * 2 * c + c * c + c * 2 * h for h in (4, 3, 2)}
    wn = 4 * (per_flow[4] + per_flow[3] + per_flow[2])
    assert K.wn_group(w) == wn == 261_150_720
    invertible = 4 * (8 * 8 + 6 * 6 + 4 * 4)
    upsample = 80 * 80 * 1024 // 32
    assert K.group(w) == wn + invertible + upsample
    assert K.frame(w) == 2 * K.group(w) * 32
    assert 16.7e9 < K.frame(w) < 16.8e9
    # one 64-row batch of 512 frames: about 548 TFLOP
    assert 548e12 < K.ops(w, 64 * 512 * 32) < 549e12
    assert K.params(w) == 267_999_848
    assert K.nbytes(w, [10, 20], 4) == 4 * (K.params(w) + 30 * (640 + 16))


def test_cell_files_load():
    cell = registry.load_cell(CELL)
    hifi = registry.load_cell("batch-b64-hifigan")
    assert cell.config["name"] == "tacotron2-waveglow"
    assert cell.config["serve"]["vocoder"] == "waveglow"
    for key in ("model", "audio", "symbols"):
        assert cell.config[key] == hifi.config[key], key
    assert cell.config["serve"]["checkpoint"] == \
        hifi.config["serve"]["checkpoint"]
    assert cell.traffic["driver"] == "closed_batch_waveglow"
    assert {k: v for k, v in cell.traffic.items()
            if k not in ("driver", "about")} == \
        {k: v for k, v in hifi.traffic.items() if k not in ("driver",
                                                            "about")}
    assert set(cell.limits) == set(hifi.limits)
    assert {k: v for k, v in cell.limits.items() if k != "pcm_gap"} == \
        {k: v for k, v in hifi.limits.items() if k != "pcm_gap"}
    names = {m["name"] for m in cell.per_layer}
    assert {"waveglow_roofline", "mfu.synth_waveglow", "idle_share.batch",
            "idle_share.batch.frontend", "idle_share.batch.encoder",
            "decoder_infer_roofline", "conv_bn_act_roofline",
            "postnet_buffer_share", "vocoder_ms_per_audio_s"} == names
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "audio_s_per_s"]


def test_widths_are_the_programs():
    from tacotron2_torch.models.waveglow import WaveGlowConfig
    import dataclasses
    assert published() == dataclasses.asdict(WaveGlowConfig())


def test_seeded_weights():
    w = dict(published(), **SMALL)
    a = wg.weights(w, 2**31 + 3, "cpu")
    b = wg.weights(w, 2**31 + 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["upsample.weight"],
                           wg.weights(w, 5, "cpu")["upsample.weight"])
    for k in range(w["n_flows"]):
        m = a[f"convinv.{k}.conv.weight"][:, :, 0].double()
        assert torch.allclose(m @ m.T, torch.eye(m.shape[0],
                                                 dtype=torch.float64),
                              atol=1e-6)
        assert float(torch.det(m)) > 0
    bound = (w["n_channels"] * w["kernel_size"]) ** -0.5
    assert float(a["WN.0.in_layers.0.weight"].abs().max()) <= bound
    assert float(a["WN.0.end.weight"].abs().max()) > 0
    from tacotron2_torch.models.waveglow import WaveGlow, WaveGlowConfig
    model = WaveGlow(WaveGlowConfig(**{k: v for k, v in w.items()}))
    model.load_state_dict(a)       # the program's keys, strict


def small_cell():
    cell = registry.load_cell(CELL)
    cell.traffic.update(batch=2, pool_sentences=64, check_batches=1)
    cell.config["waveglow"].update(SMALL)
    return cell


@pytest.fixture
def waveglow_module():
    import tacotron2_torch.models.waveglow as waveglow
    return waveglow


@pytest.fixture
def fused_module():
    import tacotron2_torch.infer.fused as fused
    return fused


def test_sound_run_is_correct():
    r = run(small_cell())
    assert r["correct"], r["checks"]
    assert r["checks"]["pcm_gap"]["value"] < 1e-4


def noise_from_seed_1(monkeypatch, waveglow_module, fused_module):
    real = waveglow_module.draw_noise
    monkeypatch.setattr(waveglow_module, "draw_noise",
                        lambda *a, **kw: real(*a[:4], seed=1))


def w_in_place_of_its_inverse(monkeypatch, waveglow_module, fused_module):
    monkeypatch.setattr(waveglow_module.Invertible1x1Conv, "inverse",
                        lambda self: self.conv.weight)


@pytest.mark.parametrize("fault", [noise_from_seed_1,
                                   w_in_place_of_its_inverse],
                         ids=lambda f: f.__name__)
def test_planted_fault_fails(monkeypatch, waveglow_module, fused_module,
                             fault):
    """Whole runs with the program broken underneath (the other two
    faults, one coupling left out and sigma 1.0, are the controls
    script's below: a whole run takes about a minute here)."""
    fault(monkeypatch, waveglow_module, fused_module)
    r = run(small_cell())
    assert not r["correct"], r["checks"]
    assert r["checks"]["pcm_gap"]["value"] > 10 * \
        r["checks"]["pcm_gap"]["limit"]


def test_controls_script_faults_at_a_small_size():
    """The controls script's faults, at small widths on the CPU: each far
    past the limit.  (Its bf16 control is judged at the cell's size: at
    16 channels and 2 layers it reads within it.)"""
    cell = small_cell()
    gaps = controls_waveglow.run_seed(
        cell, 2**31 + 5, torch.device("cpu"),
        ["noise_seed", "coupling", "w_forward", "sigma"], 1,
        log=lambda m: None)
    limit = cell.limits["pcm_gap"]
    assert all(v > 10 * limit for v in gaps.values()), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("kind", controls_waveglow.KINDS)
def test_control_and_faults_fail_at_the_cells_size(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    cell = registry.load_cell(CELL)
    gaps = controls_waveglow.run_seed(cell, 2**31 + 37,
                                      torch.device("cuda", 0), [kind], 1,
                                      log=lambda m: None)
    assert gaps[kind] > cell.limits["pcm_gap"], gaps


def test_limits_file():
    lim = registry.load_json(BENCH / "limits" / f"{CELL}.json")
    assert 0 < lim["pcm_gap"] < 1
    assert copy.deepcopy(lim) == registry.load_cell(CELL).limits
