"""The BigVGAN cell (``batch-b64-bigvgan``): its counts against a hand sum
of the layers, its files through ``registry.load_cell``, its seeded
weights, and the planted faults, which must come out not correct under the
cell's limits on the CPU at a small width (64 initial channels; the
acoustic model at its own widths, a batch of two); the bf16 control and
the faults at the cell's size on the card (``cuda``: skips without one)."""

import copy
import dataclasses
import types

import pytest
import torch
import torch.nn.functional as F

from benchmark import controls_bigvgan
from benchmark.counts import bigvgan as K
from benchmark.harness import bigvgan as bv
from benchmark.harness import registry
from benchmark.harness.env import BENCH

from .helpers import run

CELL = "batch-b64-bigvgan"
SMALL = dict(upsample_initial_channel=64)


def published():
    return bv.widths(registry.load_cell(CELL).config)


def test_counts_by_hand():
    h = published()
    chans = [1536, 768, 384, 192, 96, 48, 24]
    spf = [1, 4, 16, 32, 64, 128, 256]
    kernels = (8, 8, 4, 4, 4, 4)
    params = 80 * 1536 * 7 + 1536 + 24 * 7 + 1 + 2 * 24
    ops = 2 * 80 * 1536 * 7 + 2 * 24 * 7 * 256
    elems = 24 * 256
    for i, k in enumerate(kernels):
        c_in, c = chans[i], chans[i + 1]
        params += c_in * c * k + c
        ops += 2 * c_in * c * k * spf[i]
        for rk in (3, 7, 11):
            params += 3 * (2 * (c * c * rk + c) + 4 * c)
            ops += 3 * 2 * 2 * c * c * rk * spf[i + 1]
        elems += 18 * c * spf[i + 1]
    assert K.params(h) == params == 112_199_473
    assert K.frame(h) == ops == 1_803_718_656
    assert K.act_elems(h) == elems == 614_400
    assert K.activations(h) == 109
    assert K.act_ops_per_elem(h) == 60
    # one 64-row batch of 512 frames: 59.1 TFLOP of convolutions, 20.1 G
    # activation inputs, 0.048 s of their bytes at 3.35 TB/s
    assert 59.1e12 < K.frame(h) * 64 * 512 < 59.2e12
    assert 0.0480 < K.act_bytes(h, 64 * 512) / 3.35e12 < 0.0481
    assert K.act_ops(h, 10) == 60 * 614_400 * 10
    assert K.nbytes(h, [10, 20], 4) == 4 * (K.params(h) + 30 * (80 + 256))


def test_cell_files_load():
    cell = registry.load_cell(CELL)
    hifi = registry.load_cell("batch-b64-hifigan")
    assert cell.config["name"] == "tacotron2-bigvgan"
    assert cell.config["serve"]["vocoder"] == "bigvgan"
    for key in ("model", "audio", "symbols", "serve", "precision"):
        if key in ("serve", "precision"):
            assert set(cell.config[key]) == set(hifi.config[key]), key
        else:
            assert cell.config[key] == hifi.config[key], key
    assert cell.config["bigvgan"]["parameters"] == 112_199_473
    assert cell.config["reduced"] == []
    assert cell.traffic["driver"] == "closed_batch_bigvgan"
    assert {k: v for k, v in cell.traffic.items()
            if k not in ("driver", "about")} == \
        {k: v for k, v in hifi.traffic.items() if k not in ("driver",
                                                            "about")}
    assert set(cell.limits) == set(hifi.limits)
    assert {k: v for k, v in cell.limits.items() if k != "pcm_gap"} == \
        {k: v for k, v in hifi.limits.items() if k != "pcm_gap"}
    names = {m["name"] for m in cell.per_layer}
    assert {"bigvgan_act_roofline", "bigvgan_roofline", "mfu.synth_bigvgan",
            "idle_share.batch", "idle_share.batch.frontend",
            "idle_share.batch.encoder", "decoder_infer_roofline",
            "conv_bn_act_roofline", "postnet_buffer_share",
            "vocoder_ms_per_audio_s", "encoder_graph_share.batch"} == names
    assert [m["name"] for m in cell.end_to_end] == ["setup_s",
                                                    "audio_s_per_s"]


def test_widths_are_the_programs():
    from tacotron2_torch.models.bigvgan import BigVGANConfig
    assert published() == dataclasses.asdict(BigVGANConfig())


def test_seeded_weights():
    h = dict(published(), **SMALL)
    a = bv.weights(h, 2**31 + 3, "cpu")
    b = bv.weights(h, 2**31 + 3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_pre.weight"],
                           bv.weights(h, 5, "cpu")["conv_pre.weight"])
    assert float(a["conv_pre.weight"].abs().max()) <= (80 * 7) ** -0.5
    assert float(a["ups.0.0.weight"].abs().max()) <= (64 * 8) ** -0.5
    alpha = a["resblocks.0.activations.0.act.alpha"]
    beta = a["resblocks.0.activations.0.act.beta"]
    assert float(alpha.abs().max()) <= 0.5 and float(alpha.std()) > 0.1
    assert not torch.equal(alpha, beta)
    from tacotron2_torch.models.bigvgan import BigVGAN, BigVGANConfig
    BigVGAN(BigVGANConfig(**h)).load_state_dict(a)  # the program's keys


def small_cell():
    cell = registry.load_cell(CELL)
    cell.traffic.update(batch=2, pool_sentences=64, check_batches=1)
    cell.config["bigvgan"].update(SMALL)
    return cell


@pytest.fixture
def bigvgan_module():
    import tacotron2_torch.models.bigvgan as bigvgan
    return bigvgan


def test_sound_run_is_correct():
    r = run(small_cell())
    assert r["correct"], r["checks"]
    assert r["checks"]["pcm_gap"]["value"] < 1e-5


def snake_at_the_base_rate(monkeypatch, bigvgan_module):
    def act(x, la, lb, f, ratio=2):
        return x + torch.sin(la.exp()[None, :, None] * x) ** 2 \
            / (lb.exp()[None, :, None] + 1e-9)
    monkeypatch.setattr(bigvgan_module, "anti_aliased_snake_beta", act)


def alpha_and_beta_swapped(monkeypatch, bigvgan_module):
    real = bigvgan_module.anti_aliased_snake_beta
    monkeypatch.setattr(bigvgan_module, "anti_aliased_snake_beta",
                        lambda x, la, lb, f, ratio=2: real(x, lb, la, f,
                                                           ratio))


def zero_padding(monkeypatch, bigvgan_module):
    monkeypatch.setattr(bigvgan_module, "F", types.SimpleNamespace(
        pad=lambda t, pad, mode: F.pad(t, pad), conv1d=F.conv1d,
        conv_transpose1d=F.conv_transpose1d))


@pytest.mark.parametrize("fault", [snake_at_the_base_rate,
                                   alpha_and_beta_swapped, zero_padding],
                         ids=lambda f: f.__name__)
def test_planted_fault_fails(monkeypatch, bigvgan_module, fault):
    """Whole runs with the program broken underneath (the other faults,
    one MRF branch left out and weights of another seed, are the controls
    script's below)."""
    fault(monkeypatch, bigvgan_module)
    r = run(small_cell())
    assert not r["correct"], r["checks"]
    assert r["checks"]["pcm_gap"]["value"] > 10 * \
        r["checks"]["pcm_gap"]["limit"]


def test_controls_script_faults_at_a_small_size():
    """The controls script's faults, at a small width on the CPU: each
    past the limit.  (Its bf16 control is judged at the cell's size.)"""
    cell = small_cell()
    kinds = [k for k in controls_bigvgan.KINDS if k != "control"]
    gaps = controls_bigvgan.run_seed(cell, 2**31 + 5, torch.device("cpu"),
                                     kinds, 1, log=lambda m: None)
    limit = cell.limits["pcm_gap"]
    assert set(gaps) == set(kinds)
    assert all(v > 10 * limit for v in gaps.values()), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("kind", controls_bigvgan.KINDS)
def test_control_and_faults_fail_at_the_cells_size(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    cell = registry.load_cell(CELL)
    gaps = controls_bigvgan.run_seed(cell, 2**31 + 37,
                                     torch.device("cuda", 0), [kind], 1,
                                     log=lambda m: None)
    assert gaps[kind] > cell.limits["pcm_gap"], gaps


def test_limits_file():
    lim = registry.load_json(BENCH / "limits" / f"{CELL}.json")
    assert 0 < lim["pcm_gap"] < 1
    assert copy.deepcopy(lim) == registry.load_cell(CELL).limits
