"""The port's fused eval-mode conv + BatchNorm + activation against the JAX
package: the fold, the plain folded version against the JAX reference and
the Pallas kernel in interpret mode, and the encoder and postnet eval
outputs by the fused route against the JAX fused route and against the
port's unfused route.  CPU; the same numpy inputs made from a seed go to
both sides.

Limits.  fp32: both sides sum the same fp32 products in another order, 2e-5
on outputs of size ~1 (observed ~2e-6).  bf16 weights: both sides round the
folded weight and the input to bf16 at the same places and sum in fp32, so
the limit against the Pallas kernel stays 2e-4 (a folded weight that rounds
the other way after a 1-ulp difference in the fp32 fold moves one product
by 2^-9 of its size); against the *unfused* chain, which rounds W and
scales after the conv, the limit is the JAX package's own 3e-2
(``tests/test_ops.py``).
"""


import gc
import weakref

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tacotron2_tpu.config import ModelConfig as JaxModelConfig
from tacotron2_tpu.models.encoder import encoder_apply as jax_encoder_apply
from tacotron2_tpu.models.postnet import postnet_apply as jax_postnet_apply
from tacotron2_tpu.models.tacotron2 import (cast_params_bf16 as
                                            jax_cast_params_bf16)
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_tpu.ops import convbn_kernel as jk
from tacotron2_torch.config import ModelConfig
from tacotron2_torch.models import layers as tl
from tacotron2_torch.models.encoder import encoder_apply
from tacotron2_torch.models.postnet import postnet_apply
from tacotron2_torch.models.tacotron2 import (Tacotron2, cast_params_bf16,
                                              replace_config)
from tacotron2_torch.ops.convbn_kernel import (conv_bn_act,
                                               conv_bn_act_reference,
                                               fold_conv_bn, folded_weights,
                                               split_count)
from tacotron2_torch.utils.weights import load_jax_params

EPS = 1e-5
SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32)
TOL = {"float32": 2e-5, "bfloat16": 2e-4}
UNFUSED_TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def make_layer(c_in, c_out, k, dtype, seed, bias=True):
    """One conv + BatchNorm layer with non-identity statistics, as numpy
    (fp32 values; ``dtype`` is the weight dtype both sides cast to)."""
    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    bound = (c_in * k) ** -0.5
    p = dict(w=f(rng.uniform(-bound, bound, (c_out, c_in, k))),
             b=f(rng.uniform(-bound, bound, c_out)) if bias else None,
             scale=f(rng.uniform(0.5, 1.5, c_out)),
             bias=f(rng.standard_normal(c_out) * 0.1),
             mean=f(rng.standard_normal(c_out) * 0.2),
             var=f(rng.uniform(0.3, 2.0, c_out)))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    conv_p = {"w": jnp.asarray(p["w"]).astype(jdt)}
    if bias:
        conv_p["b"] = jnp.asarray(p["b"]).astype(jdt)
    bn_p = {"scale": jnp.asarray(p["scale"]).astype(jdt),
            "bias": jnp.asarray(p["bias"]).astype(jdt)}
    bn_s = {"mean": jnp.asarray(p["mean"]), "var": jnp.asarray(p["var"])}
    conv = tl.Conv1d(c_in, c_out, k, bias=bias)
    bn = tl.BatchNorm(c_out, EPS)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(p["w"]))
        if bias:
            conv.bias.copy_(torch.from_numpy(p["b"]))
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(p["mean"]))
        bn.running_var.copy_(torch.from_numpy(p["var"]))
    if dtype == "bfloat16":
        for q in list(conv.parameters()) + list(bn.parameters()):
            q.data = q.data.to(torch.bfloat16)
    return (conv_p, bn_p, bn_s), (conv, bn)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [True, False])
def test_fold_conv_bn(dtype, bias):
    (conv_p, bn_p, bn_s), (conv, bn) = make_layer(6, 10, 5, dtype, 0, bias)
    ref_w, ref_h = jk.fold_conv_bn(conv_p, bn_p, bn_s, EPS)
    wmat, h = fold_conv_bn(conv, bn, EPS)
    assert wmat.shape == (5, 6, 10) and h.shape == (10,)
    assert wmat.dtype == h.dtype == torch.float32
    assert ref_w.dtype == ref_h.dtype == jnp.float32
    # fp32 arithmetic on the same values; rsqrt may differ by an ulp
    np.testing.assert_allclose(np.asarray(ref_w), wmat.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(ref_h), h.numpy(), rtol=1e-6,
                               atol=1e-6)


CASES = [
    # c_in, c_out, k, B, T, act
    (16, 24, 5, 2, 13, "relu"),
    (24, 16, 5, 3, 1, "tanh"),
    (10, 40, 5, 1, 37, "none"),
    (40, 10, 3, 2, 8, "tanh"),
    (80, 96, 5, 2, 21, "none"),
    # longer kernels than the model's 5 taps (the card's kernel stages a
    # wider halo for them)
    (24, 16, 11, 2, 19, "relu"),
    (16, 24, 15, 1, 23, "tanh"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_reference_matches_pallas_interpret(case, dtype):
    c_in, c_out, k, b, t, act = case
    jax_layer, (conv, bn) = make_layer(c_in, c_out, k, dtype, seed=c_in + t)
    x = np.random.default_rng(t).standard_normal((b, c_in, t)).astype(
        np.float32)
    pallas = np.asarray(jk.conv_bn_act_pallas(jnp.asarray(x), *jax_layer,
                                              eps=EPS, act=act))
    unfused = np.asarray(jk.conv_bn_act_reference(jnp.asarray(x), *jax_layer,
                                                  EPS, act))
    got = conv_bn_act_reference(torch.from_numpy(x), conv, bn, EPS, act)
    assert got.shape == (b, c_out, t) and got.dtype == torch.float32
    np.testing.assert_allclose(pallas, got.numpy(), atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(unfused, got.numpy(), atol=UNFUSED_TOL[dtype],
                               rtol=0)
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(conv_bn_act(torch.from_numpy(x), conv, bn, EPS, act),
                       got)


def test_reference_matches_unfused_port_layers():
    """The plain folded version against the port's own Conv1d -> BatchNorm
    -> act chain (fp32: summation order only)."""
    _, (conv, bn) = make_layer(12, 20, 5, "float32", seed=9)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 12, 19)).astype(np.float32))
    with torch.no_grad():
        unfused = torch.tanh(bn(conv(x)))
    np.testing.assert_allclose(
        unfused.numpy(), conv_bn_act_reference(x, conv, bn, EPS, "tanh"),
        atol=2e-5, rtol=0)


def fresh_fold(conv, bn, eps):
    """``fold_conv_bn`` cast and laid out afresh as the kernel takes it:
    (K, C_out, C_in) in the weight dtype, zero-padded to 64 output and 32
    input channels."""
    wmat, h = fold_conv_bn(conv, bn, eps)
    k, c_in, c_out = wmat.shape
    w = torch.zeros(k, -(-c_out // 64) * 64, -(-c_in // 32) * 32,
                    dtype=conv.weight.dtype)
    w[:, :c_out, :c_in] = wmat.permute(0, 2, 1).to(conv.weight.dtype)
    return w, h


def assert_fresh(fold, conv, bn, eps):
    w, h = fresh_fold(conv, bn, eps)
    assert fold.w.dtype == w.dtype and fold.h.dtype == torch.float32
    assert torch.equal(fold.w, w) and torch.equal(fold.h, h)


def test_fold_is_made_once():
    _, (conv, bn) = make_layer(40, 70, 5, "bfloat16", seed=3)
    fold = folded_weights(conv, bn, EPS)
    assert fold.w.shape == (5, 128, 64) and fold.h.shape == (70,)
    assert_fresh(fold, conv, bn, EPS)
    again = folded_weights(conv, bn, EPS)
    assert again is fold and again.w is fold.w and again.h is fold.h


def _copy_into_weight(conv, bn, eps):
    with torch.no_grad():
        conv.weight.copy_(-0.5 * conv.weight)
    return eps


def _optimizer_step(conv, bn, eps):
    with torch.no_grad():
        bn.weight.add_(torch.ones_like(bn.weight), alpha=-0.25)
    return eps


def _load_state_dict(assign):
    def change(conv, bn, eps):
        sd = {k: v * 1.5 for k, v in conv.state_dict().items()}
        conv.load_state_dict(sd, assign=assign)
        return eps
    return change


def _cast(conv, bn, eps):
    conv.to(torch.bfloat16)
    return eps


def _train_mode_batchnorm(conv, bn, eps):
    x = torch.randn(3, bn.weight.shape[0], 9,
                    generator=torch.Generator().manual_seed(0))
    bn(x, train=True)
    return eps


FOLD_CHANGES = {
    "copy_ into the weight": _copy_into_weight,
    "optimizer step": _optimizer_step,
    "load_state_dict": _load_state_dict(False),
    "load_state_dict assign": _load_state_dict(True),
    ".to(dtype)": _cast,
    "train-mode BatchNorm update": _train_mode_batchnorm,
    "another eps": lambda conv, bn, eps: 1e-3,
}


@pytest.mark.parametrize("change", list(FOLD_CHANGES))
def test_fold_is_made_again_after(change):
    _, (conv, bn) = make_layer(36, 20, 5, "float32", seed=5)
    old = folded_weights(conv, bn, EPS)
    eps = FOLD_CHANGES[change](conv, bn, EPS)
    fold = folded_weights(conv, bn, eps)
    assert fold is not old
    assert fold.w.dtype != old.w.dtype or not (
        torch.equal(fold.w, old.w) and torch.equal(fold.h, old.h))
    assert_fresh(fold, conv, bn, eps)
    assert folded_weights(conv, bn, eps) is fold


@pytest.mark.parametrize("change", ["load_state_dict assign",
                                    ".to(dtype)"])
def test_fold_does_not_keep_replaced_weights(change):
    """The fold holds no storage of its sources: once a weight is replaced
    its old storage is freed, and the fold is made again."""
    _, (conv, bn) = make_layer(36, 20, 5, "float32", seed=5)
    folded_weights(conv, bn, EPS)
    old = weakref.ref(conv.weight.untyped_storage())
    FOLD_CHANGES[change](conv, bn, EPS)
    gc.collect()
    assert old() is None
    assert_fresh(folded_weights(conv, bn, EPS), conv, bn, EPS)


def test_fold_after_cast_params_bf16():
    """``cast_params_bf16`` serves a bf16 copy: its layers fold afresh in
    bf16, and the fp32 model keeps its own fold."""
    _, _, _, model = model_pair(14, "float32")
    conv, bn = model.postnet.convs[0], model.postnet.bns[0]
    old = folded_weights(conv, bn, EPS)
    cast = cast_params_bf16(model)
    c16, b16 = cast.postnet.convs[0], cast.postnet.bns[0]
    fold = folded_weights(c16, b16, EPS)
    assert fold is not old and fold.w.dtype == torch.bfloat16
    assert_fresh(fold, c16, b16, EPS)
    assert folded_weights(conv, bn, EPS) is old


# clusters of 1, 2, 4 and 8 blocks that a card holds at once
TWO_AN_SM = (264, 132, 64, 32)
FOUR_AN_SM = (528, 264, 132, 64)


@pytest.mark.parametrize("shape,capacity,split", [
    ((1, 32, 512, 512), TWO_AN_SM, 8),    # one sentence's encoder: 8 tiles
    ((1, 256, 512, 512), TWO_AN_SM, 8),   # its postnet: 32 tiles
    ((4, 32, 512, 512), (264, 132, 64, 30), 4),   # 32 tiles, 30 clusters
    ((4, 400, 512, 512), TWO_AN_SM, 1),   # the batched postnet fills a wave
    ((4, 400, 512, 512), FOUR_AN_SM, 2),
    ((1, 32, 80, 512), TWO_AN_SM, 2),     # 3 chunks of C_in
    ((1, 32, 36, 40), TWO_AN_SM, 2),      # ragged C_in: 2 chunks
    ((16, 1000, 512, 512), TWO_AN_SM, 1),
])
def test_split_count(shape, capacity, split):
    assert split_count(*shape, capacity) == split


def test_wrapper_rejects_bad_act():
    _, (conv, bn) = make_layer(4, 4, 5, "float32", seed=1)
    with pytest.raises(ValueError, match="act must be"):
        conv_bn_act(torch.zeros(1, 4, 3), conv, bn, EPS, "gelu")


def model_pair(seed, dtype):
    """Shared weights with non-identity BatchNorm statistics on both sides."""
    cfg = JaxModelConfig(**SMALL)
    params, state = tacotron2_init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for part in ("encoder", "postnet"):
        for p, s in zip(params[part]["bn"], state[part]["bn"]):
            n = s["mean"].shape
            s["mean"] = jnp.asarray(rng.standard_normal(n) * 0.2, jnp.float32)
            s["var"] = jnp.asarray(rng.uniform(0.5, 2, n), jnp.float32)
            p["scale"] = jnp.asarray(rng.uniform(0.5, 1.5, n), jnp.float32)
            p["bias"] = jnp.asarray(rng.standard_normal(n) * 0.1, jnp.float32)
    model = Tacotron2(ModelConfig(**SMALL))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    load_jax_params(model, to_np(params), to_np(state))
    if dtype == "bfloat16":
        params = jax_cast_params_bf16(params)
        model = cast_params_bf16(model)
    return cfg, params, state, model


def set_fused(model, on):
    replace_config(model, fused_convbn=on)


def test_replace_config_reaches_every_part():
    """One call changes the config of the model and of each part that keeps
    it: encoder, decoder and postnet cannot drift apart."""
    model = Tacotron2(ModelConfig(**SMALL))
    new = replace_config(model, fused_convbn=False, decoder_megakernel=False)
    assert not new.fused_convbn and not new.decoder_megakernel
    for part in (model, model.encoder, model.decoder, model.postnet):
        assert part.cfg is new
    assert new.n_mels == SMALL["n_mels"]


# The encoder's BiLSTM follows the conv stack and, in bf16, rounds its
# input: a conv output that rounds the other way moves the memory by a
# bf16 step of a value below 1 (4e-3).  The postnet's last layer has no
# activation; its outputs reach ~3 at this size.
STACK_TOL = {"float32": 2e-5, "bfloat16": 8e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_fused_route(monkeypatch, dtype):
    cfg, params, state, model = model_pair(11, dtype)
    tokens = np.random.default_rng(11).integers(0, 72, (3, 13))
    monkeypatch.setenv("TACOTRON2_FUSED_CONVBN", "1")
    ref, _ = jax_encoder_apply(params["encoder"], state["encoder"],
                               jnp.asarray(tokens, jnp.int32), cfg,
                               train=False)
    assert model.cfg.fused_convbn
    with torch.no_grad():
        fused = encoder_apply(model.encoder, torch.from_numpy(tokens))
        set_fused(model, False)
        unfused = encoder_apply(model.encoder, torch.from_numpy(tokens))
    assert fused.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(ref), fused.numpy(),
                               atol=STACK_TOL[dtype], rtol=0)
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(),
                               atol=UNFUSED_TOL[dtype], rtol=0)
    if dtype == "bfloat16":
        assert not torch.equal(fused, unfused)     # the routes do differ


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 15])
def test_postnet_fused_route(monkeypatch, dtype, t):
    cfg, params, state, model = model_pair(12, dtype)
    x = np.random.default_rng(12).standard_normal(
        (2, SMALL["n_mels"], t)).astype(np.float32)
    monkeypatch.setenv("TACOTRON2_FUSED_CONVBN", "1")
    ref, _ = jax_postnet_apply(params["postnet"], state["postnet"],
                               jnp.asarray(x), cfg,
                               jnp.zeros((2,), jnp.uint32), train=False)
    with torch.no_grad():
        fused = postnet_apply(model.postnet, torch.from_numpy(x))
        set_fused(model, False)
        unfused = postnet_apply(model.postnet, torch.from_numpy(x))
    assert fused.shape == (2, SMALL["n_mels"], t)
    assert fused.dtype == torch.float32
    np.testing.assert_allclose(np.asarray(ref), fused.numpy(),
                               atol=STACK_TOL[dtype], rtol=0)
    np.testing.assert_allclose(unfused.numpy(), fused.numpy(),
                               atol=5 * UNFUSED_TOL[dtype], rtol=0)


def test_train_mode_keeps_unfused_route(monkeypatch):
    """train=True never reaches the folded layer (it is serving only)."""
    import tacotron2_torch.models.encoder as enc_mod
    import tacotron2_torch.models.postnet as post_mod
    _, _, _, model = model_pair(13, "float32")

    def boom(*a, **k):
        raise AssertionError("conv_bn_act reached in train mode")

    monkeypatch.setattr(enc_mod, "conv_bn_act", boom)
    monkeypatch.setattr(post_mod, "conv_bn_act", boom)
    tokens = torch.from_numpy(np.random.default_rng(13).integers(0, 72,
                                                                 (2, 9)))
    encoder_apply(model.encoder, tokens, train=True)
    x = torch.randn(2, SMALL["n_mels"], 7,
                    generator=torch.Generator().manual_seed(0))
    postnet_apply(model.postnet, x, train=True,
                  generator=torch.Generator().manual_seed(1))
    with pytest.raises(AssertionError, match="train mode"):
        encoder_apply(model.encoder, tokens)


def test_full_width_fused_route_bf16(monkeypatch):
    """Full width, bf16 serving cast, on the trained ``r4_synth_bf16``
    checkpoint: the port's fused encoder and postnet against the JAX
    package's fused route (the Pallas kernel in interpret mode, un-jitted so
    that the environment switch is read), and against the port's unfused
    route.  Against the JAX fused route: the memory within ``STACK_TOL``
    (the BiLSTM rounds its input; observed 1.4e-3), the postnet residual
    within ``TOL`` (observed 3e-6).  Against the unfused route:
    ``UNFUSED_TOL`` (observed 1.7e-2 on the memory, 4e-4 on the residual).
    Each as a share of the output's largest value where that is above 1."""
    import importlib
    import os
    jsynth = importlib.import_module("tacotron2_tpu.infer.synthesize")
    ckpt = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                        "r4_synth_bf16")
    params, state = jsynth.load_model(ckpt)
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    model = cast_params_bf16(load_jax_params(
        Tacotron2(ModelConfig()), to_np(params), to_np(state)))
    params = jax_cast_params_bf16(params)
    cfg = JaxModelConfig()
    rng = np.random.default_rng(21)
    tokens = rng.integers(0, 72, (2, 32))
    coarse = (rng.standard_normal((2, 80, 23)) * 2 - 5).astype(np.float32)
    monkeypatch.setenv("TACOTRON2_FUSED_CONVBN", "1")
    ref_mem, _ = jax_encoder_apply(params["encoder"], state["encoder"],
                                   jnp.asarray(tokens, jnp.int32), cfg,
                                   train=False)
    ref_res, _ = jax_postnet_apply(params["postnet"], state["postnet"],
                                   jnp.asarray(coarse), cfg,
                                   jnp.zeros((2,), jnp.uint32), train=False)
    with torch.no_grad():
        fused = (encoder_apply(model.encoder, torch.from_numpy(tokens)),
                 postnet_apply(model.postnet, torch.from_numpy(coarse)))
        set_fused(model, False)
        unfused = (encoder_apply(model.encoder, torch.from_numpy(tokens)),
                   postnet_apply(model.postnet, torch.from_numpy(coarse)))
    limits = (STACK_TOL["bfloat16"], TOL["bfloat16"])
    for ref, f, u, tol in zip((ref_mem, ref_res), fused, unfused, limits):
        ref = np.asarray(ref)
        scale = max(1.0, float(np.abs(ref).max()))
        assert f.shape == ref.shape and f.dtype == torch.float32
        np.testing.assert_allclose(ref, f.numpy(), rtol=0, atol=tol * scale)
        np.testing.assert_allclose(u.numpy(), f.numpy(), rtol=0,
                                   atol=UNFUSED_TOL["bfloat16"] * scale)
