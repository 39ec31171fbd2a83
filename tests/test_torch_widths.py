"""Widths the kernels were not written for, on the CPU, without JAX.

The decoder kernels (#2, #3, #4) run at widths that are multiples of 8:
their wrappers zero-pad the weights and inputs of any other config
(``ops/decoder_megakernel.py::pad_operands``,
``ops/decoder_train_kernel.py::pad_series``) and cut the padding off what
comes back.  These tests run the plain versions on padded operands, which
is the arithmetic the kernels do on them, and hold the result to the
unpadded config's: the padding only adds zero terms.  The conv takes any
kernel size up to 9 taps, odd or even: its plain version is checked here
(the attention tail's plan for any A and D in
``tests/test_torch_tail_plan.py``), the launches in
``tests/test_torch_kernels.py`` on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tacotron2_torch.config import ModelConfig
from tacotron2_torch.models.decoder import Decoder, decoder_infer_steps
from tacotron2_torch.models.layers import BatchNorm, Conv1d
from tacotron2_torch.models.tacotron2 import (Tacotron2, init_weights,
                                              make_pad_mask)
from tacotron2_torch.ops.attention_kernel import attention_tail_reference
from tacotron2_torch.ops.convbn_kernel import (MAX_TAPS, conv_bn_act,
                                               conv_bn_act_reference)
from tacotron2_torch.ops.decoder_bwd_kernel import decoder_bwd_chain_reference
from tacotron2_torch.ops.decoder_megakernel import (_weights, _widths,
                                                    check_launch,
                                                    kernel_widths, pad_gates,
                                                    pad_operands, pad_to,
                                                    unpad_gates)
from tacotron2_torch.ops.decoder_train_kernel import (
    decoder_fwd_train_reference, kernel_operands, pad_series, unpad_series)
from tacotron2_torch.ops.decoder_bptt import core_params

SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32)
# configs whose widths are no multiples of 8, and the full width
ODD = {"prenet_dim=12": dict(SMALL, prenet_dim=12),
       "attention_dim=30": dict(SMALL, attention_dim=30),
       "n_mels=9": dict(SMALL, n_mels=9),
       "all odd": dict(SMALL, prenet_dim=13, attention_dim=14, n_mels=9,
                       encoder_embedding_dim=30, decoder_rnn_dim=60,
                       attention_rnn_dim=60)}
# relative error of the padded plain versions against the unpadded ones:
# the same sums with zero terms added, in CPU products that may block
# their K differently
PAD_TOL = 1e-6


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / (ref.abs().max() + 1e-30))


def padded_decoder(dec: Decoder) -> Decoder:
    """The decoder at ``kernel_widths``, every added row and column 0."""
    cfg = dec.cfg
    dims, kd = _widths(cfg), kernel_widths(cfg)
    big = Decoder(dataclasses.replace(
        cfg, decoder_rnn_dim=kd["H"], attention_rnn_dim=kd["H"],
        prenet_dim=kd["P"], encoder_embedding_dim=kd["E"],
        attention_dim=kd["A"], n_mels=kd["M"]))
    h, hk = dims["H"], kd["H"]

    def cols(w, *names):
        parts = w.split([dims[n] for n in names], 1)
        return torch.cat([pad_to(x, kd[n]) for x, n in zip(parts, names)], 1)

    lstm = lambda w, *names: pad_gates(cols(w, *names).t(), h, hk).t()
    sd = dec.state_dict()
    new = {
        "prenet.0.weight": pad_to(sd["prenet.0.weight"], kd["P"], kd["M"]),
        "prenet.1.weight": pad_to(sd["prenet.1.weight"], kd["P"], kd["P"]),
        "attention.energy_scale": sd["attention.energy_scale"],
        "attention.query_layer.weight": pad_to(
            sd["attention.query_layer.weight"], kd["A"], hk),
        "attention.memory_layer.weight": pad_to(
            sd["attention.memory_layer.weight"], kd["A"], kd["E"]),
        "attention.location_conv.weight":
            sd["attention.location_conv.weight"],
        "attention.location_dense.weight": pad_to(
            sd["attention.location_dense.weight"], kd["A"],
            cfg.location_n_filters),
        "attention.v.weight": pad_to(sd["attention.v.weight"], 1, kd["A"]),
        "attention.v.bias": sd["attention.v.bias"],
        "linear_projection.weight": pad_to(
            cols(sd["linear_projection.weight"], "H", "E"), kd["M"],
            hk + kd["E"]),
        "linear_projection.bias": pad_to(sd["linear_projection.bias"],
                                         kd["M"]),
        "gate_layer.weight": cols(sd["gate_layer.weight"], "H", "E"),
        "gate_layer.bias": sd["gate_layer.bias"],
    }
    for name, segs in (("attention_lstm", ("P", "E")),
                       ("decoder_lstm", ("H", "E"))):
        new[f"{name}.weight_ih"] = lstm(sd[f"{name}.weight_ih"], *segs)
        new[f"{name}.weight_hh"] = lstm(sd[f"{name}.weight_hh"], "H")
        for b in ("bias_ih", "bias_hh"):
            new[f"{name}.{b}"] = pad_gates(sd[f"{name}.{b}"], h, hk)
    big.load_state_dict(new)
    return big


def decoder_of(kw, seed=0) -> Decoder:
    return init_weights(Tacotron2(ModelConfig(**kw)), seed=seed).decoder


def memory_for(cfg: ModelConfig, b=2, t=11, seed=0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(
        (b, t, cfg.encoder_embedding_dim)) * 0.5).astype(np.float32))


@pytest.mark.parametrize("name", list(ODD))
def test_kernel_widths_round_up_to_8(name):
    cfg = ModelConfig(**ODD[name])
    dims, kd = _widths(cfg), kernel_widths(cfg)
    for k, v in dims.items():
        assert kd[k] % 8 == 0 and v <= kd[k] < v + 8
    full = ModelConfig()
    assert kernel_widths(full) == _widths(full)


def test_full_width_operands_are_not_copied():
    dec = decoder_of(SMALL)
    ops = _weights(dec)
    assert pad_operands(ops, _widths(dec.cfg), kernel_widths(dec.cfg)) is ops


@pytest.mark.parametrize("name", list(ODD))
def test_padded_operands_are_a_padded_decoders(name):
    """What the decode kernel is handed (``pad_operands`` of the
    decoder's operands) is exactly the operands of the decoder padded
    with zero rows and columns."""
    dec = decoder_of(ODD[name])
    got = pad_operands(_weights(dec), _widths(dec.cfg),
                       kernel_widths(dec.cfg))
    ref = _weights(padded_decoder(dec))
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("name", list(ODD))
def test_padded_decode_equals_the_configs(name):
    """The plain decode of the padded decoder on zero-padded memory gives
    the config's decode: the padded units stay 0, the stops agree."""
    dec = decoder_of(ODD[name])
    big = padded_decoder(dec)
    memory = memory_for(dec.cfg)
    mask = make_pad_mask(torch.tensor([11, 7]), 11)
    kd = kernel_widths(dec.cfg)
    with torch.no_grad():
        ref = decoder_infer_steps(dec, memory, 9, 0.5, True, mask, "all", 7,
                                  tail=attention_tail_reference)
        got = decoder_infer_steps(big, pad_to(memory, kd["E"]), 9, 0.5, True,
                                  mask, "all", 7,
                                  tail=attention_tail_reference)
    m = dec.cfg.n_mels
    assert int(got[3]) == int(ref[3]) and torch.equal(got[4], ref[4])
    assert not got[0][..., m:].any()
    for g, r in zip((got[0][..., :m], got[1], got[2]), ref[:3]):
        assert rel_err(g, r) <= PAD_TOL


def train_inputs(cfg: ModelConfig, t_dec=6, b=2, t_enc=11, seed=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    pre = f(t_dec, b, cfg.prenet_dim).abs() * 0.3
    memory = f(b, t_enc, cfg.encoder_embedding_dim) * 0.5
    mask = make_pad_mask(torch.tensor([t_enc, t_enc - 3]), t_enc)
    h = cfg.decoder_rnn_dim
    mka = torch.from_numpy(rng.random((t_dec, b, h)) < 0.9)
    mkd = torch.from_numpy(rng.random((t_dec, b, h)) < 0.9)
    return pre, memory, mask, mka, mkd


def padded_cfg(cfg: ModelConfig) -> ModelConfig:
    kd = kernel_widths(cfg)
    return dataclasses.replace(
        cfg, decoder_rnn_dim=kd["H"], attention_rnn_dim=kd["H"],
        prenet_dim=kd["P"], encoder_embedding_dim=kd["E"],
        attention_dim=kd["A"], n_mels=kd["M"])


FWD_KINDS = (None, None, "H", "H", "H", "H", "TA", "4H", "4H")
BWD_KINDS = ("4H", "4H", "E", "P", "TA", "A", "A", "TA", None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", list(ODD))
def test_padded_train_pair_equals_the_configs(name, dtype):
    """The teacher-forced forward and the reverse chain, plain versions,
    on the operands and series the kernels' wrappers pad (dropout on,
    masks padded), cut back: the config's nine outputs each."""
    cfg = ModelConfig(**dict(ODD[name], p_attention_dropout=0.1,
                             p_decoder_dropout=0.1))
    dec = decoder_of(dataclasses.asdict(cfg))
    dims, kd, big = _widths(cfg), kernel_widths(cfg), padded_cfg(cfg)
    pad = lambda x, kind: pad_series(x, kind, dims, kd)
    unpad = lambda x, kind: x if kind is None else unpad_series(
        x, kind, dims, kd)
    p = {n: x.detach().to(dtype) if x.is_floating_point() else x
         for n, x in core_params(dec).items()}
    ops = kernel_operands(p)
    ops_k = pad_operands(ops, dims, kd)
    pre, memory, mask, mka, mkd = train_inputs(cfg)
    with torch.no_grad():
        pm = dec.attention.memory_layer(memory)
    ref = decoder_fwd_train_reference(cfg, ops, pre, memory, pm, mask, mka,
                                      mkd)
    got = decoder_fwd_train_reference(
        big, ops_k, pad(pre, "P"), pad(memory, "E"), pad(pm, "A"), mask,
        pad(mka, "H"), pad(mkd, "H"))
    frames = got[0]
    assert not frames[..., dims["M"]:kd["M"]].any()
    got = (unpad(got[0], "M+1"),) + tuple(
        unpad(x, k) for x, k in zip(got[1:], FWD_KINDS[1:]))
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == r.dtype, i
        assert rel_err(g, r) <= PAD_TOL, i

    (frames, attns, ha_s, ca_s, hd_s, cd_s, qsum_s, aa_s, ad_s) = ref
    rng = np.random.default_rng(3)
    d_out = torch.from_numpy(rng.standard_normal(frames.shape).astype(
        np.float32))
    d_attn = torch.from_numpy(rng.standard_normal(attns.shape).astype(
        np.float32)) * 0.1
    ref_b = decoder_bwd_chain_reference(cfg, ops, memory, mka, mkd, aa_s,
                                        ad_s, ca_s, cd_s, attns, qsum_s,
                                        d_out, d_attn)
    got_b = decoder_bwd_chain_reference(
        big, ops_k, pad(memory, "E"), pad(mka, "H"), pad(mkd, "H"),
        pad(aa_s, "4H"), pad(ad_s, "4H"), pad(ca_s, "H"), pad(cd_s, "H"),
        attns, pad(qsum_s, "TA"), pad(d_out, "M+1"), d_attn)
    for i, (g, r, k) in enumerate(zip(got_b, ref_b, BWD_KINDS)):
        g = unpad(g, k)
        assert g.shape == r.shape and g.dtype == r.dtype, i
        assert rel_err(g, r) <= PAD_TOL, i


@pytest.mark.parametrize("kind", ["H", "E", "P", "A", "4H", "TA", "M+1"])
def test_pad_series_round_trip(kind):
    cfg = ModelConfig(**ODD["all odd"])
    dims, kd = _widths(cfg), kernel_widths(cfg)
    width = {"4H": 4 * dims["H"], "TA": 5 * dims["A"],
             "M+1": dims["M"] + 1}.get(kind, dims.get(kind))
    x = torch.randn(3, 2, width)
    padded = pad_series(x, kind, dims, kd)
    assert padded.shape[-1] == {"4H": 4 * kd["H"], "TA": 5 * kd["A"],
                                "M+1": kd["M"] + 1}.get(kind, kd.get(kind))
    assert float(padded.abs().sum()) == pytest.approx(float(x.abs().sum()))
    assert torch.equal(unpad_series(padded, kind, dims, kd), x)
    if kind == "4H":
        assert torch.equal(unpad_gates(pad_gates(x, dims["H"], kd["H"]),
                                       dims["H"], kd["H"]), x)


def test_decode_checks_still_raise():
    dec = decoder_of(SMALL)
    memory = memory_for(dec.cfg)
    with pytest.raises(ValueError, match="mask"):
        check_launch(dec, memory, 9, torch.zeros(2, 11), "any")
    with pytest.raises(ValueError, match="memory width"):
        check_launch(dec, memory[..., :30], 9, None, "any")
    dec.cfg = dataclasses.replace(dec.cfg, attention_rnn_dim=32)
    with pytest.raises(ValueError, match="attention rnn dim"):
        check_launch(dec, memory, 9, None, "any")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [2, 4, 5, 6, 8, MAX_TAPS])
def test_conv_plain_version_pads_as_the_model(k, dtype):
    """The folded conv's plain version, odd or even K, equals the model's
    unfused conv + eval BatchNorm + ReLU ('same' padding of
    ``conv1d_same``: (k - 1) // 2 before, k // 2 after), to fp32 rounding
    (bf16: the weights folded before, not after, the rounding)."""
    g = torch.Generator().manual_seed(k)
    conv, bn = Conv1d(8, 6, k), BatchNorm(6)
    with torch.no_grad():
        for prm in (conv.weight, conv.bias, bn.weight, bn.bias):
            prm.copy_(torch.randn(prm.shape, generator=g) * 0.3)
        bn.running_mean.copy_(torch.randn(6, generator=g) * 0.1)
        bn.running_var.copy_(torch.rand(6, generator=g) + 0.5)
    x = torch.randn(2, 8, 13, generator=g)
    with torch.no_grad():
        got = conv_bn_act(x, conv.to(dtype), bn, 1e-5, "relu")
        ref = torch.relu(bn(conv.float()(x)))
    assert got.shape == ref.shape == (2, 6, 13)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    assert rel_err(got, ref) <= tol
    assert torch.equal(got, conv_bn_act_reference(x, conv.to(dtype), bn,
                                                  1e-5, "relu"))
