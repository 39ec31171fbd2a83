"""The port's split-BPTT decoder and train step against the JAX package on
the CPU: the plain versions of the two training kernels against the Pallas
kernels in interpret mode, ``decoder_scan_bptt`` in value and gradient, the
hand-derived backward against ``torch.autograd``, and the slice as a whole
(``_forward_loss`` gradients, ``train_step`` / ``train_step_accum``).
Inputs and dropout masks are made from a seed and handed to both sides."""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from tacotron2_tpu import config as jax_config
from tacotron2_tpu.models.attention import precompute_memory
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_tpu.ops.decoder_bptt import (_step_dropout_masks,
                                            decoder_scan_bptt as jax_bptt)
from tacotron2_tpu.ops.decoder_bwd_kernel import (
    decoder_bwd_chain_mega as jax_bwd_mega)
from tacotron2_tpu.ops.decoder_train_kernel import (
    build_wband, decoder_fwd_train_mega as jax_fwd_mega)
from tacotron2_tpu.train import step as jax_step
from tacotron2_tpu.train.optim import make_optimizer as jax_make_optimizer
from tacotron2_tpu.train.state import TrainState as JaxTrainState
from tacotron2_torch import config as port_config
from tacotron2_torch.data.dataset import Example, collate
from tacotron2_torch.models.tacotron2 import Tacotron2, cast_params_bf16
from tacotron2_torch.ops.decoder_bptt import (core_params, decoder_scan_bptt,
                                              step_dropout_masks)
from tacotron2_torch.ops.decoder_bwd_kernel import (
    decoder_bwd_chain_mega, decoder_bwd_chain_reference)
from tacotron2_torch.ops.decoder_train_kernel import (
    decoder_fwd_train_mega, decoder_fwd_train_reference, kernel_operands)
from tacotron2_torch.train import step as port_step
from tacotron2_torch.train.optim import make_optimizer
from tacotron2_torch.train.state import TrainState
from tacotron2_torch.utils.weights import (export_jax_grads,
                                           export_jax_params, load_jax_params)

SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32)
B, T_ENC, T_DEC = 2, 12, 10
CORE = ("attention", "attn_lstm", "dec_lstm", "proj", "gate")
FWD_OUT = ("frames", "attn", "ha_s", "ca_s", "hd_s", "cd_s", "qsum_s",
           "aa_s", "ad_s")
BWD_OUT = ("g_att_s", "g_dec_s", "d_ctx_s", "d_pre_s", "d_qsum_s", "d_pq_s",
           "dv", "dpm", "scal")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def kernel_env():
    """Route the JAX functions through their Pallas kernels (interpret mode
    off the TPU), as the JAX package's own kernel tests do."""
    os.environ["TACOTRON2_FUSED_ATTENTION"] = "1"
    os.environ["TACOTRON2_MEGA_TRAIN"] = "1"
    jax.clear_caches()
    yield
    os.environ.pop("TACOTRON2_FUSED_ATTENTION", None)
    os.environ.pop("TACOTRON2_MEGA_TRAIN", None)
    jax.clear_caches()


def make_setup(bf16=False, saturate=False):
    """Shared weights and inputs for both sides; the JAX decoder ``core``
    tree, the port's model, and the inputs as numpy."""
    jcfg = jax_config.ModelConfig(**SMALL)
    params, state = tacotron2_init(jax.random.PRNGKey(0), jcfg)
    if saturate:
        # push input- and forget-gate pre-activations to ~|6..8|, where fp32
        # keeps derivative factors ~1e-3 and a bf16-rounded activation
        # would zero them
        h = SMALL["decoder_rnn_dim"]
        for k in ("attn_lstm", "dec_lstm"):
            bi = params["decoder"][k]["bi"]
            params["decoder"][k]["bi"] = bi.at[:h].add(7.0).at[h:2 * h].add(
                -7.0)
    model = Tacotron2(port_config.ModelConfig(**SMALL))
    load_jax_params(model, np_tree(params), np_tree(state))
    core = {k: params["decoder"][k] for k in CORE}
    if bf16:
        model = cast_params_bf16(model)
        core = jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), core)
    rng = np.random.default_rng(0)
    pre = (rng.standard_normal((T_DEC, B, 16)) * 0.3).astype(np.float32)
    memory = (rng.standard_normal((B, T_ENC, 32)) * 0.5).astype(np.float32)
    pm = np.asarray(precompute_memory(
        params["decoder"]["attention"], jnp.asarray(memory)))
    mask = np.zeros((B, T_ENC), bool)
    mask[1, 9:] = True
    keys = jax.random.split(jax.random.PRNGKey(7), T_DEC)
    mka, mkd = map(np.asarray, _step_dropout_masks(jcfg, keys, B, 64))
    return dict(jcfg=jcfg, cfg=model.cfg, core=core, model=model, pre=pre,
                memory=memory, pm=pm, mask=mask, keys=keys, mka=mka, mkd=mkd)


@pytest.fixture(scope="module")
def fwd_pair(kernel_env):
    s = make_setup()
    (mels, gates, attns), res = jax_fwd_mega(
        s["jcfg"], s["core"], *map(jnp.asarray, (s["pre"], s["memory"],
                                                 s["pm"], s["mask"],
                                                 s["mka"], s["mkd"])))
    ref = (jnp.concatenate([mels, gates[..., None]], -1), attns) + tuple(res)
    ops = kernel_operands(core_params(s["model"].decoder))
    with torch.no_grad():
        got = decoder_fwd_train_reference(
            s["cfg"], ops, *map(t, (s["pre"], s["memory"], s["pm"],
                                    s["mask"], s["mka"], s["mkd"])))
    return s, ops, dict(zip(FWD_OUT, ref)), dict(zip(FWD_OUT, got))


@pytest.mark.parametrize("name", FWD_OUT)
def test_plain_forward_matches_pallas(fwd_pair, name):
    """The plain version of kernel #3 against ``decoder_fwd_train_mega`` in
    interpret mode, fp32, dropout 0.1/0.1 with the JAX masks: 2e-6 on values
    of size <= 1 (the same products summed in another order; the banded
    matrix holds the composed one on its diagonals)."""
    _, _, ref, got = fwd_pair
    assert tuple(got[name].shape) == tuple(ref[name].shape)
    np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]),
                               atol=2e-6, rtol=0)


@pytest.fixture(scope="module")
def bwd_pair(fwd_pair):
    s, ops, ref_f, _ = fwd_pair
    rng = np.random.default_rng(1)
    d_out = (rng.standard_normal((T_DEC, B, 9)) * 0.5).astype(np.float32)
    d_attn = rng.standard_normal((T_DEC, B, T_ENC)).astype(np.float32)
    jcfg, core = s["jcfg"], s["core"]
    wband = build_wband(core["attention"], T_ENC, jcfg.attention_dim,
                        jcfg.location_kernel_size, jnp.float32)
    series = [ref_f[n] for n in ("aa_s", "ad_s", "ca_s", "cd_s", "attn",
                                 "qsum_s")]
    ref = jax_bwd_mega(jcfg, core, wband, jnp.asarray(s["memory"]),
                       jnp.asarray(s["mka"]), jnp.asarray(s["mkd"]), *series,
                       jnp.asarray(d_out), jnp.asarray(d_attn))
    with torch.no_grad():
        got = decoder_bwd_chain_reference(
            s["cfg"], ops, t(s["memory"]), t(s["mka"]), t(s["mkd"]),
            *(t(np.asarray(x)) for x in series), t(d_out), t(d_attn))
    return dict(zip(BWD_OUT, ref)), dict(zip(BWD_OUT, got))


@pytest.mark.parametrize("name", BWD_OUT)
def test_plain_backward_matches_pallas(bwd_pair, name):
    """The plain version of kernel #4 against ``decoder_bwd_chain_mega`` in
    interpret mode on the series the Pallas forward stored: 1e-5 relative
    to each output's largest value (fp32 sums in another order; the 7-tap
    correlation against the banded product)."""
    ref, got = bwd_pair
    r = np.asarray(ref[name])
    assert tuple(got[name].shape) == r.shape
    np.testing.assert_allclose(got[name].numpy(), r,
                               atol=1e-5 * np.abs(r).max(), rtol=0)


def test_wrappers_take_plain_version_on_cpu(fwd_pair):
    s, ops, _, got = fwd_pair
    before = (decoder_fwd_train_mega.launches, decoder_bwd_chain_mega.launches)
    with torch.no_grad():
        again = decoder_fwd_train_mega(
            s["cfg"], ops, *map(t, (s["pre"], s["memory"], s["pm"],
                                    s["mask"], s["mka"], s["mkd"])))
    for name, x in zip(FWD_OUT, again):
        assert torch.equal(x, got[name]), name
    assert before == (decoder_fwd_train_mega.launches,
                      decoder_bwd_chain_mega.launches)


def both_value_and_grad(s, weights=(1.0, 1.0, 0.1)):
    """loss = sum(mels^2) + sum(gates^2) + 0.1 sum(attn^2) through the JAX
    ``decoder_scan_bptt`` (Pallas pair in interpret mode) and the port's;
    gradients w.r.t. the parameters and the prenet / memory / pm inputs."""
    mask, keys = jnp.asarray(s["mask"]), s["keys"]

    def jloss(c, p_in, m_in, pm_in):
        out = jax_bptt(s["jcfg"], c, p_in, m_in, pm_in, mask, keys)
        return sum(w * jnp.sum(o.astype(jnp.float32) ** 2)
                   for w, o in zip(weights, out))

    ref_l, ref_g = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3))(
        s["core"], *map(jnp.asarray, (s["pre"], s["memory"], s["pm"])))
    model = s["model"]
    for p in model.parameters():
        p.grad = None
    ins = [t(s[k]).requires_grad_(True) for k in ("pre", "memory", "pm")]
    out = decoder_scan_bptt(s["cfg"], core_params(model.decoder), *ins,
                            t(s["mask"]), t(s["mka"]), t(s["mkd"]))
    loss = sum(w * (o ** 2).sum() for w, o in zip(weights, out))
    loss.backward()
    got_g = {k: export_jax_grads(model)["decoder"][k] for k in CORE}
    return (float(ref_l), ref_g), (float(loss.detach()), got_g,
                                   [x.grad.numpy() for x in ins])


def leaf_errors(ref_tree, got_tree, floor):
    """The JAX kernel tests' rule: per leaf, max |diff| over (max |ref| +
    floor * the largest gradient in the tree)."""
    leaves = jax.tree_util.tree_leaves_with_path(ref_tree)
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    f32 = lambda v: np.asarray(v.astype(jnp.float32))
    gscale = max(float(np.abs(f32(v)).max()) for _, v in leaves)
    return {jax.tree_util.keystr(path):
            float(np.abs(got[path] - f32(v)).max())
            / (float(np.abs(f32(v)).max()) + floor * gscale)
            for path, v in leaves}


def test_scan_bptt_value_and_grad_fp32(kernel_env):
    """fp32, at the JAX kernel test's rule: 1e-3 relative."""
    s = make_setup()
    (l0, g0), (l1, g1, gin) = both_value_and_grad(s)
    assert abs(l1 - l0) < 1e-3 * abs(l0)
    for key, rel in leaf_errors(g0[0], g1, 1e-3).items():
        assert rel < 1e-3, (key, rel)
    for name, r, g in zip(("prenet", "memory", "pm"), g0[1:], gin):
        r = np.asarray(r)
        assert np.abs(g - r).max() < 1e-3 * np.abs(r).max(), name
    # the memory layer acts outside: its gradient arrives through pm
    assert np.abs(g1["attention"]["memory"]["w"]).max() == 0.0


def test_scan_bptt_value_and_grad_bf16(kernel_env):
    """bf16 weights, at the JAX kernel test's bf16 rule (2e-2 on the value,
    5e-2 per leaf with a 1e-2 floor): both sides round at the same places,
    but a sum in another order can flip a bf16 rounding."""
    s = make_setup(bf16=True)
    (l0, g0), (l1, g1, gin) = both_value_and_grad(s)
    assert abs(l1 - l0) < 2e-2 * abs(l0)
    for key, rel in leaf_errors(g0[0], g1, 1e-2).items():
        assert rel < 5e-2, (key, rel)
    for name, r, g in zip(("prenet", "memory", "pm"), g0[1:], gin):
        r = np.asarray(r)
        assert np.abs(g - r).max() < 5e-2 * np.abs(r).max(), name
    assert gin[1].dtype == np.float32        # d_memory stays fp32


def test_saturated_gates_keep_gradients_bf16(kernel_env):
    """Saturated LSTM gates under bf16: the LSTM weight gradients keep
    their mass and track the JAX kernel pair (5e-2 of the norm), because
    activations are re-derived from rounded inputs, never rounded
    outputs."""
    s = make_setup(bf16=True, saturate=True)
    (_, g0), (_, g1, _) = both_value_and_grad(s, weights=(1.0, 1.0, 0.0))
    for k in ("attn_lstm", "dec_lstm"):
        for w in ("wi", "wh"):
            v0 = np.asarray(g0[0][k][w].astype(jnp.float32))
            n0 = float(np.linalg.norm(v0))
            assert n0 > 0.0
            assert float(np.linalg.norm(g1[k][w])) > 0.5 * n0, (k, w)
            assert float(np.linalg.norm(g1[k][w] - v0)) / n0 < 5e-2, (k, w)


def _plain_loop64(p, cfg, pre, memory, pm, mask, mka, mkd):
    """An independent float64 step loop from the raw parameters: the real
    location conv and dense layer (no composed matrix), torch.where
    dropout, no stored series."""
    b, t_enc, _ = memory.shape
    k = cfg.location_kernel_size
    lpad = (k - 1) // 2
    keep_a, keep_d = 1 - cfg.p_attention_dropout, 1 - cfg.p_decoder_dropout
    z = lambda d: torch.zeros(b, d, dtype=torch.float64)
    h = cfg.decoder_rnn_dim
    h_a, c_a, h_d, c_d = z(h), z(h), z(h), z(h)
    ctx, prev, cum = z(memory.shape[2]), z(t_enc), z(t_enc)

    def cell(name, x, hh, cc):
        g = (x @ p[f"{name}.weight_ih"].t() + hh @ p[f"{name}.weight_hh"].t()
             + p[f"{name}.bias_ih"] + p[f"{name}.bias_hh"])
        i, f, gg, o = g.chunk(4, dim=-1)
        cc = torch.sigmoid(f) * cc + torch.sigmoid(i) * torch.tanh(gg)
        return torch.sigmoid(o) * torch.tanh(cc), cc

    outs = []
    for step in range(pre.shape[0]):
        h_a, c_a = cell("attention_lstm", torch.cat([pre[step], ctx], -1),
                        h_a, c_a)
        h_a = torch.where(mka[step], h_a / keep_a, 0.0)
        pq = h_a @ p["attention.query_layer.weight"].t()
        loc = F.conv1d(F.pad(torch.stack([prev, cum], 1),
                             (lpad, k - 1 - lpad)),
                       p["attention.location_conv.weight"])
        loc = loc.transpose(1, 2) @ p["attention.location_dense.weight"].t()
        e = (torch.tanh(pq[:, None] + pm + loc) @ p["attention.v.weight"][0]
             + p["attention.v.bias"][0]) * p["attention.energy_scale"]
        attn = torch.softmax(e.masked_fill(mask, -1e9), dim=1)
        ctx = torch.einsum("bt,btd->bd", attn, memory)
        prev, cum = attn, cum + attn
        h_d, c_d = cell("decoder_lstm", torch.cat([h_a, ctx], -1), h_d, c_d)
        h_d = torch.where(mkd[step], h_d / keep_d, 0.0)
        x = torch.cat([h_d, ctx], -1)
        outs.append((x @ p["linear_projection.weight"].t()
                     + p["linear_projection.bias"],
                     (x @ p["gate_layer.weight"].t()
                      + p["gate_layer.bias"])[:, 0], attn))
    return tuple(torch.stack(x) for x in zip(*outs))


def test_hand_backward_matches_autograd_float64():
    """The hand-derived split backward against torch.autograd through an
    independent step loop, both in float64: 1e-9 relative to each
    gradient's largest value plus a floor of 1e-3 of the largest gradient
    (nothing is rounded in float64, so only summation order differs)."""
    s = make_setup()
    dec = s["model"].decoder.double()
    cfg = s["cfg"]
    f64 = lambda k: t(s[k]).double()
    fixed = (t(s["mask"]), t(s["mka"]), t(s["mkd"]))
    w = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (T_DEC, B, T_ENC)))
    results = []
    for fn in ("hand", "autograd"):
        p = {n: x.detach().clone().requires_grad_(True)
             for n, x in core_params(dec).items()}
        ins = [f64(k).requires_grad_(True) for k in ("pre", "memory", "pm")]
        if fn == "hand":
            out = decoder_scan_bptt(cfg, p, *ins, *fixed)
        else:
            out = _plain_loop64(p, cfg, *ins, *fixed)
        loss = (out[0] ** 2).sum() + (out[1] ** 2).sum() + (out[2] * w).sum()
        loss.backward()
        results.append((float(loss.detach()), {**{n: x.grad for n, x in p.items()},
                                      **dict(zip(("pre", "memory", "pm"),
                                                 (x.grad for x in ins)))}))
    (l0, g0), (l1, g1) = results
    assert abs(l0 - l1) < 1e-12 * abs(l1)
    gscale = max(float(g.abs().max()) for g in g1.values())
    for n in g1:
        # the v bias shifts every energy alike, so its gradient is zero up
        # to rounding: hence the floor
        scale = float(g1[n].abs().max()) + 1e-3 * gscale
        assert float((g0[n] - g1[n]).abs().max()) < 1e-9 * scale, n


def test_step_dropout_masks_draw():
    cfg = port_config.ModelConfig(**SMALL)
    gen = torch.Generator().manual_seed(0)
    mka, mkd = step_dropout_masks(cfg, 50, 4, gen, "cpu")
    assert mka.shape == mkd.shape == (50, 4, 64) and mka.dtype == torch.bool
    assert not torch.equal(mka, mkd)
    assert 0.85 < float(mka.float().mean()) < 0.95      # keep = 0.9
    off = dataclasses.replace(cfg, p_attention_dropout=0.0)
    assert step_dropout_masks(off, 5, 2, gen, "cpu")[0] is None


# --------------------------------------------------------------------------
# the slice as a whole
# --------------------------------------------------------------------------
NO_DROPOUT = dict(p_attention_dropout=0.0, p_decoder_dropout=0.0,
                  p_prenet_dropout=0.0, p_postnet_dropout=0.0)
TRAIN = dict(precision="float32", learning_rate=1e-3)


def slice_setup(seed=0, n_items=4):
    """A two-speaker model on shared weights, dropout off on both sides
    (torch cannot reproduce JAX's prenet and postnet draws), and collated
    batches with ragged text and mel lengths."""
    kw = {**SMALL, **NO_DROPOUT, "n_speakers": 2}
    jcfg = jax_config.Config(model=jax_config.ModelConfig(**kw),
                             train=jax_config.TrainConfig(**TRAIN))
    cfg = port_config.Config(model=port_config.ModelConfig(**kw),
                             train=port_config.TrainConfig(**TRAIN))
    params, state = tacotron2_init(jax.random.PRNGKey(seed), jcfg.model)
    model = Tacotron2(cfg.model)
    load_jax_params(model, np_tree(params), np_tree(state))
    rng = np.random.default_rng(seed)

    def batch():
        ex = [Example(text=rng.integers(0, 72, n).astype(np.int32),
                      mel=rng.standard_normal((8, m)).astype(np.float32),
                      speaker_id=int(rng.integers(0, 2)))
              for n, m in zip(rng.integers(5, 13, n_items),
                              rng.integers(6, 15, n_items))]
        return collate(ex, text_pad_multiple=4, mel_pad_multiple=4,
                       fixed_text_len=12, fixed_mel_len=16)

    return jcfg, cfg, params, state, model, batch


def assert_trees_close(ref, got, atol, what, loose=None):
    assert (jax.tree_util.tree_structure(np_tree(ref))
            == jax.tree_util.tree_structure(got))
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref),
                            jax.tree_util.tree_leaves(got)):
        r = np.asarray(r)
        key = jax.tree_util.keystr(path)
        tol = (loose or {}).get(key, atol * max(1.0, float(np.abs(r).max())))
        np.testing.assert_allclose(g, r, atol=tol, rtol=0,
                                   err_msg=f"{what} {key}")


@pytest.mark.parametrize("use_postnet", [True, False])
def test_forward_loss_gradients(use_postnet):
    """``_forward_loss`` and its gradient, leaf by leaf, against
    ``jax.grad`` of the JAX ``_forward_loss`` (its default CPU route),
    speaker conditioning on: 2e-5 of each leaf's size or of 1 (fp32, the
    whole model's sums in another order)."""
    jcfg, cfg, params, state, model, batch = slice_setup(seed=3)
    b = batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (ref_l, (ref_losses, ref_state, _)), ref_g = jax.value_and_grad(
        jax_step._forward_loss, has_aux=True)(
        params, state, jcfg, jb, jax.random.PRNGKey(0), jnp.int32(7),
        use_postnet, 50)
    tb = port_step._to_device(b, torch.device("cpu"))
    total, (losses, _) = port_step._forward_loss(
        model, cfg, tb, None, 7, use_postnet, 50)
    grads = port_step._grads(model, total)
    assert abs(float(total) - float(ref_l)) < 1e-5 * abs(float(ref_l))
    for name in ref_losses._fields:
        np.testing.assert_allclose(float(getattr(losses, name)),
                                   float(getattr(ref_losses, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert_trees_close(ref_g, export_jax_grads(model, grads), 2e-5, "grad")
    if not use_postnet:
        assert not any(n.startswith("postnet.") for n in grads)
    # train mode moved the BatchNorm running statistics, as in JAX
    assert_trees_close(ref_state, export_jax_params(model)[1], 1e-5, "state")


# Parameters whose true gradient is zero: the attention's v bias shifts
# every energy alike (softmax cancels it), and a conv bias straight before a
# train-mode BatchNorm is cancelled by the batch mean.  What either side
# computes for them is rounding noise near Adam's eps, so each update moves
# them by an arbitrary share of lr = 1e-3.
ZERO_GRAD = {"['decoder']['attention']['v']['b']": 3e-3,
             **{f"['encoder']['convs'][{i}]['b']": 3e-3 for i in range(3)},
             **{f"['postnet']['convs'][{i}]['b']": 3e-3 for i in range(5)}}


def test_forward_loss_gradients_bf16(kernel_env):
    """The bf16 policy as a whole: ``_forward_loss`` under
    ``precision="bfloat16"`` against ``jax.grad`` of the JAX one on the same
    fp32 masters, the JAX decoder through its Pallas pair (which rounds
    where the port's plain pair does), dropout off.  The total to 2e-3
    relative.  Every gradient leaf to 1e-1 of its largest value plus 1e-2
    of the tree's: outside the decoder the two sides round their bf16
    products at different places, and at this size bf16 itself moves a leaf
    by up to a quarter of its size against the fp32 gradient on either
    side, so the JAX kernel tests' 5e-2 for the decoder alone is out of
    reach for the whole model.  The ``ZERO_GRAD`` leaves hold only rounding
    noise and are left out.  The gradients land in fp32."""
    jcfg, cfg, params, state, model, batch = slice_setup(seed=3)
    bf16 = lambda c: dataclasses.replace(c, train=dataclasses.replace(
        c.train, precision="bfloat16"))
    jcfg, cfg = bf16(jcfg), bf16(cfg)
    b = batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (ref_l, _), ref_g = jax.value_and_grad(
        jax_step._forward_loss, has_aux=True)(
        params, state, jcfg, jb, jax.random.PRNGKey(0), jnp.int32(7),
        True, 50)
    tb = port_step._to_device(b, torch.device("cpu"))
    total, _ = port_step._forward_loss(model, cfg, tb, None, 7, True, 50)
    grads = port_step._grads(model, total)
    assert all(g.dtype == torch.float32 for g in grads.values())
    assert abs(float(total.detach()) - float(ref_l)) < 2e-3 * abs(float(ref_l))
    errs = leaf_errors(ref_g, export_jax_grads(model, grads), 1e-2)
    assert len(errs) > len(ZERO_GRAD)
    for key, rel in errs.items():
        if key not in ZERO_GRAD:
            assert rel < 1e-1, (key, rel)


def test_train_steps_match_jax():
    """Two ``train_step``s (the first with the postnet bypassed) and one
    ``train_step_accum`` of two micro-batches from shared weights: losses
    to 1e-4 relative, updated parameters to 5e-5 (Adam's first updates are
    lr * g / (|g| + eps): where a gradient is near zero, fp32 noise in it
    moves the update by a visible share of lr = 1e-3), BatchNorm state to
    3e-4, and the counters exactly.  The leaves of ``ZERO_GRAD`` have their
    own limit of 3 * lr."""
    jcfg, cfg, params, state, model, batch = slice_setup(seed=5)
    jtx = jax_make_optimizer(jcfg.train)
    tx = make_optimizer(cfg.train)
    jstate = JaxTrainState(params=params, model_state=state,
                           opt_state=jtx.init(params), step=jnp.int32(0),
                           loss_step=jnp.int32(0), rng=jax.random.PRNGKey(1))
    tstate = TrainState(model=model, opt_state=tx.init(model), step=0,
                        loss_step=0, generator=torch.Generator())

    def compare(jl, tl_, what):
        for name in jl._fields:
            np.testing.assert_allclose(
                float(getattr(tl_, name)), float(getattr(jl, name)),
                rtol=1e-4, atol=1e-6, err_msg=f"{what} {name}")
        p, s = export_jax_params(tstate.model)
        assert_trees_close(jstate.params, p, 5e-5, what, loose=ZERO_GRAD)
        # the running means see the conv biases, which are ZERO_GRAD
        # leaves: momentum 0.1 times their limit
        assert_trees_close(jstate.model_state, s, 3e-4, what)
        assert (int(jstate.step), int(jstate.loss_step)) == (
            tstate.step, tstate.loss_step)

    for i, use_postnet in enumerate((False, True)):
        b = batch()
        jstate, jl, ja = jax_step.train_step(
            jstate, {k: jnp.asarray(v) for k, v in b.items()}, cfg=jcfg,
            tx=jtx, use_postnet=use_postnet, sigma_warmup_steps=50)
        tstate, tl_, ta = port_step.train_step(
            tstate, b, cfg=cfg, tx=tx, use_postnet=use_postnet,
            sigma_warmup_steps=50)
        compare(jl, tl_, f"step {i}")
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    micro = [batch(), batch()]
    stacked = {k: np.stack([m[k] for m in micro]) for k in micro[0]}
    jstate, jl, _ = jax_step.train_step_accum(
        jstate, {k: jnp.asarray(v) for k, v in stacked.items()}, cfg=jcfg,
        tx=jtx, use_postnet=True, sigma_warmup_steps=50, accum_steps=2)
    tstate, tl_, _ = port_step.train_step_accum(
        tstate, stacked, cfg=cfg, tx=tx, use_postnet=True,
        sigma_warmup_steps=50, accum_steps=2)
    compare(jl, tl_, "accumulated step")
    assert (tstate.step, tstate.loss_step) == (3, 4)

    # eval_step: eval mode, fp32 masters, unmasked entropy
    b = batch()
    jl, ja, jent = jax_step.eval_step(
        jstate, {k: jnp.asarray(v) for k, v in b.items()}, cfg=jcfg,
        sigma_warmup_steps=50)
    before = export_jax_params(tstate.model)
    tl_, ta, tent = port_step.eval_step(tstate, b, cfg=cfg,
                                        sigma_warmup_steps=50)
    for name in jl._fields:
        np.testing.assert_allclose(float(getattr(tl_, name)),
                                   float(getattr(jl, name)), rtol=1e-4,
                                   atol=1e-6, err_msg=f"eval {name}")
    np.testing.assert_allclose(float(tent), float(jent), rtol=1e-5)
    after = export_jax_params(tstate.model)
    for x, y in zip(jax.tree_util.tree_leaves(before),
                    jax.tree_util.tree_leaves(after)):
        np.testing.assert_array_equal(x, y)      # eval changes nothing
    assert (tstate.step, tstate.loss_step) == (3, 4)


def test_bf16_policy_casts_and_keeps_masters():
    """Under ``precision="bfloat16"`` the forward runs on a bf16 cast, the
    gradients land on the fp32 masters in fp32, and the masters stay fp32
    through a step."""
    jcfg, cfg, params, state, model, batch = slice_setup(seed=6)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, precision="bfloat16"))
    assert port_step.compute_dtype_of("bf16") == torch.bfloat16
    assert port_step.compute_dtype_of("float32") is None
    with pytest.raises(ValueError, match="unknown precision"):
        port_step.compute_dtype_of("fp16")
    cast = port_step.cast_params_for_compute(model, torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in cast.values())
    tx = make_optimizer(cfg.train)
    tstate = TrainState(model=model, opt_state=tx.init(model), step=0,
                        loss_step=0, generator=torch.Generator())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    tstate, losses, _ = port_step.train_step(
        tstate, batch(), cfg=cfg, tx=tx, use_postnet=True,
        sigma_warmup_steps=50)
    assert np.isfinite(float(losses.total))
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32
        assert bool(torch.isfinite(p).all())
        assert not torch.equal(p, before[n]), n
    assert all(v.dtype == torch.float32
               for v in tstate.opt_state["mu"].values())
