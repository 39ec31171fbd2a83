"""The port's training pieces against the JAX package on the CPU: train-mode
BatchNorm and dropout, the loss, the attention tail's gradient, the
optimizer and its schedule, the batch collation and the gradient bridge.
Inputs (and dropout masks) are made with numpy from a seed and handed to
both sides; fp32 unless a test says otherwise."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from tacotron2_tpu.config import (GuidedAttentionConfig as JaxGuided,
                                  ModelConfig as JaxModelConfig,
                                  TrainConfig as JaxTrainConfig)
from tacotron2_tpu.data import dataset as jax_dataset
from tacotron2_tpu.models import layers as jl
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_tpu.ops.attention_kernel import attention_tail as jax_tail
from tacotron2_tpu.train import loss as jax_loss
from tacotron2_tpu.train.optim import (make_optimizer as jax_make_optimizer,
                                       milestone_schedule as jax_schedule)
from tacotron2_torch.config import (GuidedAttentionConfig, ModelConfig,
                                    TrainConfig)
from tacotron2_torch.data import dataset as port_dataset
from tacotron2_torch.models import layers as tl
from tacotron2_torch.models.tacotron2 import Tacotron2
from tacotron2_torch.ops.attention_kernel import attention_tail
from tacotron2_torch.train import loss as port_loss
from tacotron2_torch.train.optim import make_optimizer, milestone_schedule
from tacotron2_torch.utils.weights import (export_jax_grads,
                                           export_jax_params, load_jax_params)

SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------------
# BatchNorm in train mode, dropout
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train(dtype):
    """Output and new running statistics.  fp32: 1e-5 (one-pass moments
    summed in another order).  bf16 input: statistics are fp32 on both
    sides (1e-5), the output is rounded to bf16 (one bf16 ulp at |y| < 4:
    3.2e-2)."""
    rng = np.random.default_rng(1)
    p = {"scale": rng.uniform(0.5, 2, 7).astype(np.float32),
         "bias": rng.standard_normal(7).astype(np.float32)}
    s = {"mean": rng.standard_normal(7).astype(np.float32),
         "var": rng.uniform(0.2, 3, 7).astype(np.float32)}
    x = (rng.standard_normal((3, 7, 11)) * 1.5 + 0.3).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    ref, new = jl.batchnorm_apply(np_tree(p), np_tree(s), jx, train=True)
    bn = tl.BatchNorm(7)
    with torch.no_grad():
        bn.weight.copy_(t(p["scale"]))
        bn.bias.copy_(t(p["bias"]))
        bn.running_mean.copy_(t(s["mean"]))
        bn.running_var.copy_(t(s["var"]))
        got = bn(t(x).to(getattr(torch, dtype)), train=True)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(np.asarray(ref.astype(jnp.float32)),
                               got.float().numpy(),
                               atol=1e-5 if dtype == "float32" else 3.2e-2,
                               rtol=0)
    np.testing.assert_allclose(np.asarray(new["mean"]),
                               bn.running_mean.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.asarray(new["var"]),
                               bn.running_var.numpy(), atol=1e-5, rtol=0)


def test_batchnorm_eval_leaves_statistics():
    bn = tl.BatchNorm(4)
    x = torch.randn(2, 4, 5, generator=torch.Generator().manual_seed(0))
    bn(x)
    assert torch.equal(bn.running_mean, torch.zeros(4))
    assert torch.equal(bn.running_var, torch.ones(4))


def test_dropout_mask_and_generator():
    x = torch.arange(1.0, 13.0).reshape(3, 4)
    mask = (torch.arange(12).reshape(3, 4) % 3 != 0)
    got = tl.dropout(x, 0.25, True, mask=mask)
    assert torch.equal(got, torch.where(mask, x / 0.75, torch.zeros(())))
    assert tl.dropout(x, 0.25, False, mask=mask) is x
    assert tl.dropout(x, 0.0, True) is x
    a = tl.dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    b = tl.dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert set(np.unique((a / x).numpy())) <= {0.0, 2.0}
    with pytest.raises(ValueError, match="generator or a mask"):
        tl.dropout(x, 0.5, True)


# --------------------------------------------------------------------------
# loss
# --------------------------------------------------------------------------
def _loss_inputs(sharp: bool):
    rng = np.random.default_rng(2)
    b, t_dec, t_enc, m = 3, 12, 9, 8
    logits = rng.standard_normal((b, t_dec, t_enc)) * (12.0 if sharp else 1.0)
    text_lengths = np.asarray([9, 7, 5], np.int32)
    logits[np.arange(t_enc)[None, None, :] >= text_lengths[:, None, None]
           * np.ones((1, t_dec, 1), np.int32)] = -1e9
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return dict(
        mel_postnet=rng.standard_normal((b, t_dec, m)).astype(np.float32),
        mel_coarse=rng.standard_normal((b, t_dec, m)).astype(np.float32),
        gate_logits=(rng.standard_normal((b, t_dec)) * 3).astype(np.float32),
        alignments=(e / e.sum(-1, keepdims=True)).astype(np.float32),
        mel_target=rng.standard_normal((b, m, t_dec)).astype(np.float32),
        mel_lengths=np.asarray([10, 7, 4], np.int32),
        text_lengths=text_lengths)


@pytest.mark.parametrize("sharp", [False, True])
@pytest.mark.parametrize("with_text", [True, False])
@pytest.mark.parametrize("loss_step", [0, 30, 500])
def test_loss_terms(loss_step, with_text, sharp):
    """Every term against the JAX loss, 1e-5 relative (fp32 sums in another
    order); warm-up 100 steps, so the three loss_steps are the start, the
    middle and past the end; ``sharp`` alignments have an entropy below the
    target, which moves the adaptive weight off 1."""
    ins = _loss_inputs(sharp)
    if not with_text:
        ins["text_lengths"] = None
    ref = jax_loss.tacotron2_loss(
        *(None if v is None else jnp.asarray(v) for v in ins.values()),
        jnp.int32(loss_step), JaxGuided(), sigma_warmup_steps=100)
    got = port_loss.tacotron2_loss(
        *(None if v is None else t(v) for v in ins.values()),
        loss_step, GuidedAttentionConfig(), sigma_warmup_steps=100)
    for name in ref._fields:
        np.testing.assert_allclose(
            float(getattr(got, name)), float(getattr(ref, name)), rtol=1e-5,
            atol=1e-6, err_msg=name)
    if with_text and sharp:
        assert float(got.attention_entropy) < 3.5
        assert float(got.attention_weight) < 1.0
    if with_text:
        assert float(got.attention_kl) > 0.0


def test_gate_target_and_bce():
    lengths = np.asarray([4, 1, 6], np.int32)
    np.testing.assert_array_equal(
        np.asarray(jax_loss.build_gate_target(jnp.asarray(lengths), 6)),
        port_loss.build_gate_target(t(lengths), 6).numpy())
    x = np.linspace(-30, 30, 13).astype(np.float32)
    y = (np.arange(13) % 2).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(jax_loss.sigmoid_binary_cross_entropy(jnp.asarray(x),
                                                         jnp.asarray(y))),
        port_loss.sigmoid_binary_cross_entropy(t(x), t(y)).numpy(),
        rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# attention tail gradient
# --------------------------------------------------------------------------
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [True, False])
def test_attention_tail_gradient(masked, qdtype):
    """Value and every gradient against jax.grad through the JAX
    attention_tail (its Pallas forward in interpret mode, its jnp
    backward).  fp32: 1e-5.  bf16 qsum: the gradient of qsum is rounded to
    bf16 on both sides (one ulp of its size, 1e-3); d_memory stays fp32."""
    rng = np.random.default_rng(3)
    b, te, a, d = 3, 11, 16, 24
    qsum = rng.standard_normal((b, te, a)).astype(np.float32)
    v_w = (rng.standard_normal(a) * 0.3).astype(np.float32)
    v_b, scale = np.float32(0.1), np.float32(1.2)
    mask = np.zeros((b, te), bool)
    if masked:
        mask[1, 8:] = True
        mask[2, 5:] = True
    memory = rng.standard_normal((b, te, d)).astype(np.float32)
    w_attn = rng.standard_normal((b, te)).astype(np.float32)
    w_ctx = rng.standard_normal((b, d)).astype(np.float32)

    def jloss(q, vw, vb, sc, mem):
        attn, ctx = jax_tail(q.astype(qdtype), vw, vb, sc, jnp.asarray(mask),
                             mem)
        return jnp.sum(attn * w_attn) + jnp.sum(ctx * w_ctx)

    ref_l, ref_g = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *map(jnp.asarray, (qsum, v_w, v_b, scale, memory)))
    ins = [t(x).requires_grad_(True) for x in (qsum, v_w, np.asarray(v_b),
                                               np.asarray(scale), memory)]
    attn, ctx = attention_tail(ins[0].to(getattr(torch, qdtype)), ins[1],
                               ins[2], ins[3], t(mask), ins[4])
    loss = (attn * t(w_attn)).sum() + (ctx * t(w_ctx)).sum()
    loss.backward()
    tol = 1e-5 if qdtype == "float32" else 1e-3
    assert abs(float(loss.detach()) - float(ref_l)) < tol * 10
    for name, x, r in zip(("qsum", "v_w", "v_b", "scale", "memory"), ins,
                          ref_g):
        assert x.grad.dtype == torch.float32
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(r), atol=tol,
                                   rtol=tol, err_msg=name)
    if masked:
        assert float(ins[0].grad[2, 5:].abs().max()) == 0.0


# --------------------------------------------------------------------------
# optimizer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("offset", [-1, 0, 1, 2])
def test_milestone_schedule(offset):
    """The boundary sits at m + 1: the update made after m updates still
    has the old rate."""
    ms, gamma = (5, 9), 0.8
    ref, got = jax_schedule(1e-3, ms, gamma), milestone_schedule(1e-3, ms,
                                                                 gamma)
    for m in ms:
        count = m + offset
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-6)
    assert got(5) == 1e-3 and got(6) == pytest.approx(8e-4)
    assert got(10) == pytest.approx(6.4e-4)


@pytest.mark.parametrize("debug", [False, True])
def test_adam_two_groups_clip_milestone(debug):
    """Four updates on seeded gradient trees, the second milestone-free,
    the third and fourth past a milestone at 2; gradients alternately
    above and below the clip norm.  Parameters against optax's after every
    update: 2e-6 (fp32 Adam arithmetic in another order on values of size
    ~0.1-1)."""
    kw = {**SMALL, "n_speakers": 2}
    params, state = tacotron2_init(jax.random.PRNGKey(0),
                                   JaxModelConfig(**kw))
    model = Tacotron2(ModelConfig(**kw))
    load_jax_params(model, np_tree(params), np_tree(state))
    sched = dict(learning_rate=1e-2, lr_decay_milestones=(2,),
                 lr_decay_gamma=0.5)
    jtx = jax_make_optimizer(JaxTrainConfig(**sched), debug=debug)
    tx = make_optimizer(TrainConfig(**sched), debug=debug)
    jopt = jtx.init(params)
    opt = tx.init(model)
    rng = np.random.default_rng(4)
    holder = Tacotron2(ModelConfig(**kw))
    for i, scale in enumerate((5.0, 0.01, 3.0, 0.002)):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape) * scale,
                                  jnp.float32), params)
        updates, jopt = jtx.update(grads, jopt, params)
        params = optax.apply_updates(params, updates)
        load_jax_params(holder, np_tree(grads), np_tree(state))
        tx.update(model, opt, {n: p.detach().clone()
                               for n, p in holder.named_parameters()})
        got, _ = export_jax_params(model)
        for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(params),
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(
                g, np.asarray(r), atol=2e-6, rtol=0,
                err_msg=f"update {i} {jax.tree_util.keystr(path)}")
    assert opt["count"] == 4
    # the attention group moved further than the base group by its multiplier
    # on the last (unclipped, past-milestone) update is covered by the match
    # above; here: a missing gradient counts as zero and still decays moments
    before = model.postnet.convs[0].weight.detach().clone()
    tx.update(model, opt, {})
    assert not torch.equal(before, model.postnet.convs[0].weight)


# --------------------------------------------------------------------------
# data and bridge
# --------------------------------------------------------------------------
def test_collate_copy_matches():
    rng = np.random.default_rng(5)
    lens = [(7, 33), (12, 70), (3, 20), (12, 64)]
    mk = lambda cls: [cls(text=rng.integers(0, 72, a).astype(np.int32),
                          mel=rng.standard_normal((8, b)).astype(np.float32),
                          speaker_id=i) for i, (a, b) in enumerate(lens)]
    rng = np.random.default_rng(5)
    ref = jax_dataset.collate(mk(jax_dataset.Example), 8, 16)
    rng = np.random.default_rng(5)
    got = port_dataset.collate(mk(port_dataset.Example), 8, 16)
    assert got["text"].shape == (4, 16) and got["mel"].shape == (4, 8, 80)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
        assert ref[k].dtype == got[k].dtype
    fixed = port_dataset.collate(mk(port_dataset.Example), fixed_text_len=40,
                                 fixed_mel_len=96)
    assert fixed["text"].shape == (4, 40) and fixed["mel"].shape == (4, 8, 96)
    assert port_dataset._round_up(65, 64) == jax_dataset._round_up(65, 64)


@pytest.mark.parametrize("n_speakers", [1, 2])
def test_gradient_bridge_layout(n_speakers):
    """export_jax_grads lays ``.grad`` out as the JAX parameter tree, with
    linear and LSTM weights transposed back, and zeros where no gradient
    arrived."""
    kw = {**SMALL, "n_speakers": n_speakers}
    params, state = tacotron2_init(jax.random.PRNGKey(1),
                                   JaxModelConfig(**kw))
    model = Tacotron2(ModelConfig(**kw))
    load_jax_params(model, np_tree(params), np_tree(state))
    for p in model.parameters():
        p.grad = 2.0 * p.detach()
    model.postnet.convs[1].weight.grad = None
    tree = export_jax_grads(model)
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(np_tree(params)))
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree_util.tree_leaves(tree)):
        want = 2.0 * np.asarray(r)
        if jax.tree_util.keystr(path) == "['postnet']['convs'][1]['w']":
            want = np.zeros_like(want)
        np.testing.assert_array_equal(g, want)
