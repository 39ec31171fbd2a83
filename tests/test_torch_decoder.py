"""The port's gate-stopped decode against the JAX package.

At the ``SMALL`` decoder config of ``tests/test_megakernel.py``, the port's
``decoder_infer`` (on the CPU: the step loop with the plain attention tail)
is held against JAX's ``decoder_infer`` and against the Pallas
``decoder_infer_mega`` in interpret mode: ``n_frames`` and ``frame_ends``
exactly, mels, gates and alignments at 2e-4 (the tolerance of
``test_megakernel.py``), post-stop rows exactly.  The CUDA kernel against
the plain version is in ``test_torch_kernels.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tacotron2_tpu.config import ModelConfig as JaxModelConfig
from tacotron2_tpu.models.decoder import decoder_infer as jax_decoder_infer
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_tpu.ops.decoder_megakernel import \
    decoder_infer_mega as pallas_decoder_infer_mega
from tacotron2_torch.config import ModelConfig
from tacotron2_torch.models.decoder import decoder_infer
from tacotron2_torch.models.tacotron2 import Tacotron2
from tacotron2_torch.ops.decoder_megakernel import (
    decoder_infer_mega, decoder_infer_mega_reference)
from tacotron2_torch.utils.weights import load_jax_params

SMALL = dict(n_mels=8, prenet_dim=16, encoder_embedding_dim=32,
             symbols_embedding_dim=32, postnet_embedding_dim=32,
             decoder_rnn_dim=64, attention_rnn_dim=64, attention_dim=16,
             location_n_filters=4, location_kernel_size=7)
JCFG = JaxModelConfig(**SMALL)
B, T_ENC, MAX = 2, 12, 14
TOL = 2e-4
STATIC = ("cfg", "max_steps", "gate_threshold", "drop_first_frame",
          "stop_mode")
jax_loop = jax.jit(jax_decoder_infer, static_argnames=STATIC)
jax_mega = jax.jit(pallas_decoder_infer_mega, static_argnames=STATIC)


@pytest.fixture(scope="module")
def setup():
    params, state = tacotron2_init(jax.random.PRNGKey(0), JCFG)
    model = Tacotron2(ModelConfig(**SMALL))
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state))
    rng = np.random.default_rng(1)
    memory = (rng.standard_normal((B, T_ENC, 32)) * 0.5).astype(np.float32)
    mask = np.zeros((B, T_ENC), bool)
    mask[1, 9:] = True
    return params["decoder"], model, memory, mask


def run_all(jdec, model, memory, mask, **kw):
    force = kw.pop("forced_stop_at", None)
    jkw = dict(kw, mask=None if mask is None else jnp.asarray(mask),
               forced_stop_at=None if force is None else jnp.int32(force))
    refs = [f(jdec, cfg=JCFG, memory=jnp.asarray(memory), max_steps=MAX,
              gate_threshold=0.5, **jkw) for f in (jax_loop, jax_mega)]
    with torch.no_grad():
        got = decoder_infer(model.decoder, torch.from_numpy(memory), MAX, 0.5,
                            mask=None if mask is None
                            else torch.from_numpy(mask),
                            forced_stop_at=force, **kw)
    return refs, got


def assert_parity(ref, got):
    assert int(ref[3]) == int(got[3])
    np.testing.assert_array_equal(np.asarray(ref[4]), got[4].numpy())
    n = int(ref[3])
    for i, name in enumerate(("mels", "gates", "aligns")):
        r, g = np.asarray(ref[i]), got[i].numpy()
        assert r.shape == g.shape, name
        err = np.max(np.abs(r[:, :n] - g[:, :n]))
        assert err < TOL, (name, err)
        # rows past the stop: zero mels and aligns, -1e9 gates, exactly
        np.testing.assert_array_equal(r[:, n:], g[:, n:])


@pytest.mark.parametrize("force", [None, 0, 1, 5])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("stop_mode", ["any", "all"])
@pytest.mark.parametrize("drop", [True, False])
def test_decode_parity(setup, drop, stop_mode, masked, force):
    jdec, model, memory, mask = setup
    refs, got = run_all(jdec, model, memory, mask if masked else None,
                        drop_first_frame=drop, stop_mode=stop_mode,
                        forced_stop_at=force)
    for ref in refs:
        assert_parity(ref, got)
    if force is None:
        assert int(got[3]) == MAX      # random weights: the gate never fires
    else:
        assert int(got[3]) == max(force, 1)


def test_natural_gate_fire(setup):
    jdec, model, memory, mask = setup
    hot = jax.tree_util.tree_map(lambda x: x, jdec)
    hot["gate"] = dict(jdec["gate"], b=jnp.full_like(jdec["gate"]["b"], 5.0))
    hot_model = Tacotron2(ModelConfig(**SMALL))
    hot_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        hot_model.decoder.gate_layer.bias.fill_(5.0)
    refs, got = run_all(hot, hot_model, memory, mask)
    assert int(got[3]) == 2            # fires at the first eligible step
    for ref in refs:
        assert_parity(ref, got)


def test_megakernel_wrapper_on_cpu_is_plain(setup):
    _, model, memory, mask = setup
    before = decoder_infer_mega.launches
    args = (model.decoder, torch.from_numpy(memory), MAX, 0.5, True,
            torch.from_numpy(mask), "all", 6)
    with torch.no_grad():
        got = decoder_infer_mega(*args)
        ref = decoder_infer_mega_reference(*args)
    assert decoder_infer_mega.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_stop_mode_validated(setup):
    _, model, memory, _ = setup
    with pytest.raises(ValueError, match="stop_mode"):
        decoder_infer(model.decoder, torch.from_numpy(memory), MAX, 0.5,
                      stop_mode="first")
