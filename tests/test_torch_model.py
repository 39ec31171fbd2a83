"""The port's token -> mel serving path against the JAX package.

``tacotron2_infer`` and ``synthesize_mels`` at a small two-speaker config
(B=3, ragged lengths) and at full width on the committed checkpoint
``checkpoints/r4_synth_bf16``, with the repo's tolerances
(``tests/test_model.py``: mel_coarse and gate 1e-3, mel_postnet 2e-3,
alignments 5e-4; ``n_frames`` exact).
"""

import importlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tacotron2_tpu.config import Config as JaxConfig
from tacotron2_tpu.config import ModelConfig as JaxModelConfig
from tacotron2_tpu.models.tacotron2 import tacotron2_infer_jit, tacotron2_init
from tacotron2_torch.config import ModelConfig
from tacotron2_torch.infer.synthesize import (synthesize_mels,
                                              synthesize_mels_tokens)
from tacotron2_torch.models.tacotron2 import (Tacotron2, cast_params_bf16,
                                              init_weights, tacotron2_infer)
from tacotron2_torch.utils.weights import load_jax_params

# the module, not the function of the same name that its package exports
jax_synth = importlib.import_module("tacotron2_tpu.infer.synthesize")
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "r4_synth_bf16")
SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32, n_speakers=2,
             speaker_embedding_dim=8)
TOLS = dict(mel_coarse=1e-3, gate_logits=1e-3, mel_postnet=2e-3,
            alignments=5e-4)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(params, state, **cfg):
    model = Tacotron2(ModelConfig(**cfg))
    return load_jax_params(model, np_tree(params), np_tree(state))


def assert_outputs_close(ref, got, n):
    for name, tol in TOLS.items():
        r = np.asarray(getattr(ref, name))[:, :n]
        g = getattr(got, name)[:, :n].numpy()
        np.testing.assert_allclose(r, g, atol=tol, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def small():
    params, state = tacotron2_init(jax.random.PRNGKey(3),
                                   JaxModelConfig(**SMALL))
    return params, state, port_model(params, state, **SMALL)


def ragged_tokens(seed, lengths):
    rng = np.random.default_rng(seed)
    return [list(rng.integers(0, 72, n)) for n in lengths]


def test_infer_small_two_speakers(small):
    params, state, model = small
    seqs = ragged_tokens(5, (11, 7, 16))
    tokens = np.zeros((3, 16), np.int32)
    for i, s in enumerate(seqs):
        tokens[i, :len(s)] = s
    lengths = np.array([len(s) for s in seqs], np.int32)
    spk = np.array([1, 0, 1], np.int32)
    ref, ref_n, ref_ends = tacotron2_infer_jit(
        params, state, JaxModelConfig(**SMALL), jnp.asarray(tokens),
        max_steps=12, text_lengths=jnp.asarray(lengths),
        speaker_ids=jnp.asarray(spk), stop_mode="all")
    got, n, ends = tacotron2_infer(model, tokens, max_steps=12,
                                   text_lengths=lengths, speaker_ids=spk,
                                   stop_mode="all", device="cpu")
    assert int(n) == int(ref_n)
    np.testing.assert_array_equal(np.asarray(ref_ends), ends.numpy())
    assert_outputs_close(ref, got, int(n))


@pytest.mark.parametrize("n_items", [1, 3])
def test_synthesize_mels_small(small, monkeypatch, n_items):
    params, state, model = small
    seqs = ragged_tokens(6, (9, 14, 5)[:n_items])
    # JAX's synthesize_mels starts from text: map "0", "1", ... to seqs
    monkeypatch.setattr(jax_synth, "text_to_sequence",
                        lambda text: seqs[int(text)])
    ref_mels, ref_al = jax_synth.synthesize_mels(
        params, state, [str(i) for i in range(n_items)],
        cfg=JaxConfig(model=JaxModelConfig(**SMALL)), max_steps=10,
        speaker_id=1)
    mels, al = synthesize_mels_tokens(model, seqs, max_steps=10,
                                      speaker_id=1, device="cpu")
    assert len(mels) == n_items
    for r, g in zip(ref_mels, mels):
        assert r.shape == g.shape
        np.testing.assert_allclose(r, g, atol=TOLS["mel_postnet"], rtol=0)
    assert ref_al.shape == al.shape
    np.testing.assert_allclose(ref_al, al, atol=TOLS["alignments"], rtol=0)


def test_cuda_requested_without_card_raises(small):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    _, _, model = small
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tacotron2_infer(model, np.zeros((1, 8), np.int32), max_steps=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthesize_mels_tokens(model, [[1, 2, 3]], max_steps=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthesize_mels(model, ["hello"], max_steps=3)


def test_cast_params_bf16(small):
    _, _, model = small
    bf = cast_params_bf16(model)
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
    assert bf.encoder.bns[0].running_var.dtype == torch.float32
    assert next(model.parameters()).dtype == torch.float32   # a copy
    out, n, ends = tacotron2_infer(bf, [[3, 4, 5, 6]], max_steps=6,
                                   device="cpu")
    assert out.mel_postnet.shape == (1, 6, SMALL["n_mels"])
    assert torch.isfinite(out.mel_postnet).all()


def test_init_weights_is_seeded():
    cfg = ModelConfig(**SMALL)
    a = init_weights(Tacotron2(cfg), seed=7).state_dict()
    b = init_weights(Tacotron2(cfg), seed=7).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["decoder.gate_layer.bias"][0]) == cfg.gate_bias_init


@pytest.fixture(scope="module")
def full_width():
    params, state = jax_synth.load_model(CKPT)
    return params, state, port_model(params, state)


def test_full_width_checkpoint_parity(full_width):
    """Full width on the trained r4 checkpoint: B=1, 40 tokens, 30 steps."""
    params, state, model = full_width
    tokens = np.random.default_rng(8).integers(0, 72, (1, 40)).astype(
        np.int32)
    ref, ref_n, ref_ends = tacotron2_infer_jit(
        params, state, JaxModelConfig(), jnp.asarray(tokens), max_steps=30)
    got, n, ends = tacotron2_infer(model, tokens, max_steps=30, device="cpu")
    assert int(n) == int(ref_n)
    np.testing.assert_array_equal(np.asarray(ref_ends), ends.numpy())
    assert_outputs_close(ref, got, int(n))
