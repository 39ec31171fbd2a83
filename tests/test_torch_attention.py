"""The port's attention tail and attention step against the JAX package.

On the CPU the port's ``attention_tail`` takes its plain version; it is
held against JAX's plain ``attention_tail_reference`` and against the
Pallas kernel, which runs in interpret mode on the CPU.  The Triton kernel
against the plain version is in ``test_torch_kernels.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tacotron2_tpu.config import ModelConfig as JaxModelConfig
from tacotron2_tpu.models import attention as jatt
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_tpu.ops.attention_kernel import attention_tail as pallas_tail
from tacotron2_tpu.ops.attention_kernel import \
    attention_tail_reference as jax_tail_ref
from tacotron2_torch.config import ModelConfig
from tacotron2_torch.models.attention import (attention_energies,
                                              attention_step,
                                              precompute_memory)
from tacotron2_torch.models.tacotron2 import Tacotron2
from tacotron2_torch.ops.attention_kernel import (attention_tail,
                                                  attention_tail_reference)
from tacotron2_torch.utils.weights import load_jax_params

A, D = 16, 24


def tail_inputs(b, t, seed):
    rng = np.random.default_rng(seed)
    qsum = rng.standard_normal((b, t, A)).astype(np.float32)
    v_w = (rng.standard_normal(A) * 0.5).astype(np.float32)
    v_b = np.float32(rng.standard_normal())
    scale = np.float32(1.2)
    lens = rng.integers(t // 2, t + 1, b)
    lens[0] = t
    mask = np.arange(t)[None, :] >= lens[:, None]
    memory = rng.standard_normal((b, t, D)).astype(np.float32)
    return qsum, v_w, v_b, scale, mask, memory


def port_tail(fn, qsum, v_w, v_b, scale, mask, memory, dtype=torch.float32):
    return fn(torch.from_numpy(qsum).to(dtype), torch.from_numpy(v_w),
              torch.tensor(v_b), torch.tensor(scale), torch.from_numpy(mask),
              torch.from_numpy(memory))


@pytest.mark.parametrize("b", [1, 3])
def test_tail_reference_fp32(b):
    ins = tail_inputs(b, 19, seed=b)
    j_ins = [jnp.asarray(x) for x in ins]
    attn, ctx = port_tail(attention_tail_reference, *ins)
    for ref_attn, ref_ctx in (jax_tail_ref(*j_ins), pallas_tail(*j_ins)):
        np.testing.assert_allclose(np.asarray(ref_attn), attn.numpy(),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(np.asarray(ref_ctx), ctx.numpy(),
                                   atol=1e-5, rtol=0)
    # masked positions get no weight
    assert np.all(attn.numpy()[ins[4]] == 0.0)


@pytest.mark.parametrize("b", [1, 3])
def test_tail_reference_bf16_qsum(b):
    """bf16 qsum: the kernel's policy (fp32 tanh, memory read in bf16)
    against the Pallas kernel."""
    qsum, v_w, v_b, scale, mask, memory = tail_inputs(b, 21, seed=10 + b)
    ref_attn, ref_ctx = pallas_tail(
        jnp.asarray(qsum, jnp.bfloat16), jnp.asarray(v_w), jnp.asarray(v_b),
        jnp.asarray(scale), jnp.asarray(mask), jnp.asarray(memory))
    attn, ctx = port_tail(attention_tail_reference, qsum, v_w, v_b, scale,
                          mask, memory, dtype=torch.bfloat16)
    np.testing.assert_allclose(np.asarray(ref_attn), attn.numpy(), atol=1e-3,
                               rtol=0)
    np.testing.assert_allclose(np.asarray(ref_ctx), ctx.numpy(), atol=1e-3,
                               rtol=0)


def test_tail_wrapper_on_cpu_is_plain():
    ins = tail_inputs(2, 9, seed=3)
    before = attention_tail.launches
    got = port_tail(attention_tail, *ins)
    ref = port_tail(attention_tail_reference, *ins)
    assert attention_tail.launches == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32)


@pytest.fixture(scope="module")
def att_pair():
    params, state = tacotron2_init(jax.random.PRNGKey(11),
                                   JaxModelConfig(**SMALL))
    model = Tacotron2(ModelConfig(**SMALL))
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params),
                    jax.tree_util.tree_map(np.asarray, state))
    return params["decoder"]["attention"], model.decoder.attention


def step_inputs(b=3, t=13, seed=12):
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((b, 64)).astype(np.float32)
    memory = rng.standard_normal((b, t, 32)).astype(np.float32)
    prev = rng.dirichlet(np.ones(t), b).astype(np.float32)
    cum = (prev + rng.dirichlet(np.ones(t), b)).astype(np.float32)
    mask = np.zeros((b, t), bool)
    mask[1, 9:] = True
    return query, memory, prev, cum, mask


def test_attention_energies(att_pair):
    jp, att = att_pair
    query, memory, prev, cum, mask = step_inputs()
    pm = jatt.precompute_memory(jp, jnp.asarray(memory))
    ref = jatt.attention_energies(
        jp, jnp.asarray(query), pm,
        jatt.AttentionState(jnp.asarray(prev), jnp.asarray(cum)),
        jnp.asarray(mask))
    with torch.no_grad():
        tpm = precompute_memory(att, torch.from_numpy(memory))
        np.testing.assert_allclose(np.asarray(pm), tpm.numpy(), atol=1e-5,
                                   rtol=0)
        got = attention_energies(att, torch.from_numpy(query), tpm,
                                 torch.from_numpy(prev),
                                 torch.from_numpy(cum),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=1e-5,
                               rtol=0)


def test_attention_step(att_pair):
    jp, att = att_pair
    query, memory, prev, cum, mask = step_inputs()
    pm = jatt.precompute_memory(jp, jnp.asarray(memory))
    ctx, attn, new_state = jatt.attention_step(
        jp, jnp.asarray(query), jnp.asarray(memory), pm,
        jatt.AttentionState(jnp.asarray(prev), jnp.asarray(cum)),
        jnp.asarray(mask))
    with torch.no_grad():
        t = lambda x: torch.from_numpy(x)
        g_ctx, g_attn, g_cum = attention_step(
            att, t(query), t(memory), precompute_memory(att, t(memory)),
            t(prev), t(cum), t(mask))
    for r, g in ((ctx, g_ctx), (attn, g_attn), (new_state.cum_attn, g_cum)):
        np.testing.assert_allclose(np.asarray(r), g.numpy(), atol=1e-5,
                                   rtol=0)
