"""The port's eval-mode layers, encoder, postnet and weight bridge against
the JAX package, on the same numpy inputs made from a seed (CPU, fp32)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tacotron2_tpu import config as jax_config
from tacotron2_tpu.config import ModelConfig as JaxModelConfig
from tacotron2_tpu.models import layers as jl
from tacotron2_tpu.models.encoder import encoder_apply as jax_encoder_apply
from tacotron2_tpu.models.postnet import postnet_apply as jax_postnet_apply
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_torch import config as port_config
from tacotron2_torch.config import ModelConfig
from tacotron2_torch.models import layers as tl
from tacotron2_torch.models.encoder import encoder_apply
from tacotron2_torch.models.postnet import postnet_apply
from tacotron2_torch.models.tacotron2 import Tacotron2
from tacotron2_torch.utils.weights import export_jax_params, load_jax_params

ATOL = 1e-5
SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_pair(seed=0, **over):
    kw = {**SMALL, **over}
    params, state = tacotron2_init(jax.random.PRNGKey(seed),
                                   JaxModelConfig(**kw))
    model = Tacotron2(ModelConfig(**kw))
    load_jax_params(model, np_tree(params), np_tree(state))
    return params, state, model


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), atol=atol,
                               rtol=0)


def test_linear():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((24, 40)).astype(np.float32) * 0.2
    bias = rng.standard_normal(40).astype(np.float32)
    x = rng.standard_normal((5, 24)).astype(np.float32)
    ref = jl.linear_apply({"w": jnp.asarray(w), "b": jnp.asarray(bias)},
                          jnp.asarray(x))
    close(ref, tl.linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                         torch.from_numpy(bias)))


@pytest.mark.parametrize("k", [5, 4, 31])
def test_conv1d_same(k):
    rng = np.random.default_rng(k)
    w = rng.standard_normal((6, 3, k)).astype(np.float32) * 0.3
    bias = rng.standard_normal(6).astype(np.float32)
    x = rng.standard_normal((2, 3, 17)).astype(np.float32)
    ref = jl.conv1d_apply({"w": jnp.asarray(w), "b": jnp.asarray(bias)},
                          jnp.asarray(x))
    got = tl.conv1d_same(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(bias))
    assert got.shape == (2, 6, 17)
    close(ref, got)


def test_batchnorm_eval():
    rng = np.random.default_rng(1)
    p = {"scale": rng.uniform(0.5, 2, 7).astype(np.float32),
         "bias": rng.standard_normal(7).astype(np.float32)}
    s = {"mean": rng.standard_normal(7).astype(np.float32),
         "var": rng.uniform(0.2, 3, 7).astype(np.float32)}
    x = rng.standard_normal((3, 7, 11)).astype(np.float32)
    ref, _ = jl.batchnorm_apply(np_tree(p), np_tree(s), jnp.asarray(x),
                                train=False)
    bn = tl.BatchNorm(7)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
        close(ref, bn(torch.from_numpy(x)))


def _lstm_params(rng, in_dim, hidden):
    b = hidden ** -0.5
    u = lambda *shape: rng.uniform(-b, b, shape).astype(np.float32)
    return {"wi": u(in_dim, 4 * hidden), "wh": u(hidden, 4 * hidden),
            "bi": u(4 * hidden), "bh": u(4 * hidden)}


def _torch_cell(p, in_dim, hidden):
    cell = tl.LSTMCell(in_dim, hidden)
    with torch.no_grad():
        cell.weight_ih.copy_(torch.from_numpy(p["wi"].T.copy()))
        cell.weight_hh.copy_(torch.from_numpy(p["wh"].T.copy()))
        cell.bias_ih.copy_(torch.from_numpy(p["bi"]))
        cell.bias_hh.copy_(torch.from_numpy(p["bh"]))
    return cell


def test_lstm_cell():
    rng = np.random.default_rng(2)
    p = _lstm_params(rng, 10, 8)
    x, h, c = (rng.standard_normal((3, d)).astype(np.float32)
               for d in (10, 8, 8))
    rh, rc = jl.lstm_cell_apply(np_tree(p), jnp.asarray(x), jnp.asarray(h),
                                jnp.asarray(c))
    with torch.no_grad():
        gh, gc = _torch_cell(p, 10, 8)(*map(torch.from_numpy, (x, h, c)))
    close(rh, gh)
    close(rc, gc)


def test_bilstm():
    rng = np.random.default_rng(3)
    p = {"fwd": _lstm_params(rng, 6, 5), "bwd": _lstm_params(rng, 6, 5)}
    xs = rng.standard_normal((2, 9, 6)).astype(np.float32)
    ref = jl.bilstm_apply(np_tree(p), jnp.asarray(xs))
    lstm = tl.BiLSTM(6, 5)
    lstm.fwd = _torch_cell(p["fwd"], 6, 5)
    lstm.bwd = _torch_cell(p["bwd"], 6, 5)
    with torch.no_grad():
        close(ref, lstm(torch.from_numpy(xs)))


def test_encoder():
    params, state, model = make_pair(seed=4)
    tokens = np.random.default_rng(4).integers(0, 72, (3, 13))
    ref, _ = jax_encoder_apply(params["encoder"], state["encoder"],
                               jnp.asarray(tokens, jnp.int32),
                               JaxModelConfig(**SMALL), train=False)
    with torch.no_grad():
        got = encoder_apply(model.encoder, torch.from_numpy(tokens))
    close(ref, got)


def test_postnet():
    params, state, model = make_pair(seed=5)
    # non-trivial running statistics, so the eval BatchNorm matters
    rng = np.random.default_rng(5)
    for bn in state["postnet"]["bn"]:
        bn["mean"] = jnp.asarray(rng.standard_normal(bn["mean"].shape),
                                 jnp.float32)
        bn["var"] = jnp.asarray(rng.uniform(0.5, 2, bn["var"].shape),
                                jnp.float32)
    load_jax_params(model, np_tree(params), np_tree(state))
    x = rng.standard_normal((2, SMALL["n_mels"], 15)).astype(np.float32)
    ref, _ = jax_postnet_apply(params["postnet"], state["postnet"],
                               jnp.asarray(x), JaxModelConfig(**SMALL),
                               jnp.zeros((2,), jnp.uint32), train=False)
    with torch.no_grad():
        close(ref, postnet_apply(model.postnet, torch.from_numpy(x)))


@pytest.mark.parametrize("n_speakers", [1, 2])
def test_weight_bridge_roundtrip(n_speakers):
    params, state, model = make_pair(seed=6, n_speakers=n_speakers)
    p2, s2 = export_jax_params(model)
    for a, b in ((params, p2), (state, s2)):
        assert (jax.tree_util.tree_structure(np_tree(a))
                == jax.tree_util.tree_structure(b))
        for x, y in zip(jax.tree_util.tree_leaves(a),
                        jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(np.asarray(x), y)
    if n_speakers > 1:
        np.testing.assert_array_equal(
            model.speaker_proj.weight.detach().numpy(),
            np.asarray(params["speaker"]["proj"]["w"]).T)


def test_weight_bridge_rejects_wrong_shape():
    params, state, model = make_pair(seed=7)
    bad = Tacotron2(ModelConfig(**{**SMALL, "prenet_dim": 24}))
    with pytest.raises(ValueError, match="does not fit"):
        load_jax_params(bad, np_tree(params), np_tree(state))


@pytest.mark.parametrize("name", ["ModelConfig", "AudioConfig",
                                  "GuidedAttentionConfig", "TrainConfig",
                                  "Config"])
def test_config_copy_matches(name):
    """The port's own config copy: every field it keeps has the JAX
    package's default, and the symbol table is the same.  One field is the
    port's alone: ``ModelConfig.fused_convbn`` (there an environment
    variable switches the kernel)."""
    assert port_config.SYMBOLS == jax_config.SYMBOLS
    ours = dataclasses.asdict(getattr(port_config, name)())
    theirs = dataclasses.asdict(getattr(jax_config, name)())
    if name == "Config":       # nested: compare what each part keeps
        assert set(ours) == set(theirs)
        assert ours["model"].pop("fused_convbn") is True
        for part in ours:
            assert {k: theirs[part][k] for k in ours[part]} == ours[part]
        return
    if name == "ModelConfig":
        assert ours.pop("fused_convbn") is True
    assert {k: theirs[k] for k in ours} == ours
    if name != "ModelConfig":
        assert set(ours) == set(theirs)
    else:
        # the training slice's fields are kept; only the XLA scan and
        # rematerialisation knobs are left out
        assert set(theirs) - set(ours) == {
            "decoder_scan_unroll", "remat_decoder_step",
            "decoder_remat_policy"}
