"""The plain reference against the program's own plain paths on the CPU,
at a tiny size (or on a short input at the configurations' widths): the
two must agree to float32 rounding where they compute the same thing."""

import numpy as np
import pytest
import torch

from benchmark.harness import registry, serving
from benchmark.harness.env import BENCH, ROOT
from benchmark.reference import checkpoint, model as M, text, vocoders
from benchmark.reference.train import param_shapes

from .helpers import run, train_cell

CFG = registry.load_json(BENCH / "configs" / "tacotron2-hifigan.json")


def test_param_shapes_are_the_programs():
    from tacotron2_torch.config import ModelConfig
    from tacotron2_torch.models.tacotron2 import Tacotron2
    model = Tacotron2(ModelConfig(**CFG["model"]))
    assert param_shapes(CFG["model"]) == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_checkpoint_reader_matches_load_model():
    from tacotron2_torch.config import Config, ModelConfig
    from tacotron2_torch.infer.synthesize import load_model
    path = str(ROOT / CFG["serve"]["checkpoint"])
    prog = load_model(path, Config(model=ModelConfig(**CFG["model"])),
                      "cpu").state_dict()
    ref = checkpoint.load(path, CFG["model"], "cpu")
    assert set(ref) == set(prog)
    for k in ref:
        assert torch.equal(ref[k], prog[k]), k


def test_token_ids_match_the_frontend():
    from tacotron2_torch.text import text_to_sequence
    t = registry.load_json(BENCH / "traffic" / "batch64-vocab.json")
    lexicon = text.read_lexicon(
        str(ROOT / "third_party" / "cmudict" / "cmudict.gz"),
        registry.data_file("data/vocab.json")["words"])
    for s in serving.sentence_pool(t)[:200]:
        assert text.token_ids(s, lexicon, CFG["symbols"]) == \
            text_to_sequence(s), s


def test_train_steps_match_the_programs_fp32_step():
    r = run(train_cell("float32"))
    assert r["correct"], r["checks"]
    assert r["checks"]["loss_gap"]["value"] < 1e-6


def test_decode_postnet_and_gate_follow_the_program():
    from tacotron2_torch.config import Config, ModelConfig
    from tacotron2_torch.infer.synthesize import load_model
    from tacotron2_torch.models.tacotron2 import tacotron2_infer
    from tacotron2_torch.text import pad_sequences, text_to_sequence
    path = str(ROOT / CFG["serve"]["checkpoint"])
    model = load_model(path, Config(model=ModelConfig(**CFG["model"])),
                       "cpu")
    texts = ["water river shadow.", "golden morning light never fails."]
    tokens, lengths = pad_sequences([text_to_sequence(s) for s in texts],
                                    pad_multiple=16)
    out, nf, fe = tacotron2_infer(model, tokens, text_lengths=lengths,
                                  stop_mode="all", device="cpu")
    p = checkpoint.load(path, CFG["model"], "cpu")
    q = M.rounding("float32")
    tok, ln = torch.as_tensor(tokens).long(), torch.as_tensor(lengths)
    coarse, _, ends, steps = M.decode(p, CFG["model"], tok, ln, 1000, "all",
                                      q)
    assert steps == int(nf) and ends.tolist() == fe.tolist()
    assert (coarse[:, :steps] - out.mel_coarse[:, :steps]).abs().max() < 1e-4
    pred, gate = M.follow(p, CFG["model"], tok, ln, out.mel_coarse[:, :steps],
                          steps, q)
    for b, e in enumerate(fe.tolist()):
        assert (pred[b, :e] - out.mel_coarse[b, :e]).abs().max() < 1e-4
        assert gate[b, e - 1] > 0 and gate[b, 1:e - 1].max() < 0
    post = out.mel_coarse + M.postnet(p, CFG["model"], out.mel_coarse, False,
                                      q)
    assert (post - out.mel_postnet).abs().max() < 1e-4


def test_hifigan_matches_the_programs_generator():
    from tacotron2_torch.models.hifigan import HiFiGAN, hifigan_apply
    w = serving.hifigan_weights(5, "cpu")
    gen = HiFiGAN()
    gen.load_state_dict(w)
    mel = torch.randn(1, 80, 12, generator=torch.Generator().manual_seed(0))
    want = hifigan_apply(gen, mel)
    got = vocoders.hifigan(w, mel)
    assert got.shape == want.shape == (1, 12 * 256)
    assert (got - want).abs().max() < 1e-5


def test_griffin_lim_matches_the_programs():
    from tacotron2_torch.config import AudioConfig
    from tacotron2_torch.dsp.griffinlim import griffin_lim, mel_to_linear
    a = CFG["audio"]
    acfg = AudioConfig(**a)
    log_mel = -6 + 2 * torch.randn(2, 80, 40,
                                   generator=torch.Generator().manual_seed(1))
    lin = mel_to_linear(torch.exp(log_mel), sr=acfg.sampling_rate,
                        n_fft=acfg.n_fft, n_mels=acfg.n_mels,
                        fmin=acfg.fmin, fmax=acfg.fmax)
    want = griffin_lim(lin, n_fft=acfg.n_fft, hop_length=acfg.hop_length,
                       win_length=acfg.win_length, n_iter=60,
                       length=40 * acfg.hop_length)
    got = vocoders.griffin_lim(log_mel, a, 60, 0)
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) < 1e-2 * scale


def test_mel_filterbank_matches_the_programs():
    from tacotron2_torch.dsp.mel import mel_filterbank
    a = CFG["audio"]
    want = mel_filterbank(a["sampling_rate"], a["n_fft"], a["n_mels"],
                          a["fmin"], a["fmax"])
    got = vocoders.mel_filterbank(a["sampling_rate"], a["n_fft"],
                                  a["n_mels"], a["fmin"], a["fmax"])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("precision", ["bfloat16", "float8_e4m3fn"])
def test_lower_precisions_round(precision):
    q = M.rounding(precision)
    x = torch.tensor([1.0 + 2 ** -12, 1000.0, -1000.0])
    y = q(x)
    assert y[0] == 1.0
    if precision == "float8_e4m3fn":
        assert y[1] == 448.0 and y[2] == -448.0
