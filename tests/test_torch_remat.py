"""The port's decoder-step rematerialisation (``--remat off|full|dots``)
against its own step loop and against the JAX package on the CPU.

``full`` and ``dots`` replay the step loop's arithmetic, so one
``train_step`` matches the loop without remat at ``tests/test_remat.py``'s
own limits (loss 1e-6 relative, ``proj`` 1e-6); against the JAX
``train_step`` under the same remat fields, on shared weights, at
``tests/test_torch_bptt.py::test_train_steps_match_jax``'s limits.  An
explicit remat turns the split BPTT off on both sides, an unknown policy
raises the JAX package's ``ValueError``, the CLI's flag reaches the model's
config, and in bf16 the step keeps fewer bytes for the backward under
``full`` and no more under ``dots``.  Widths are ``tests/test_remat.py``'s
``BASE``.
"""

import os
import runpy
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tacotron2_tpu import config as jax_config
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_tpu.train import step as jax_step
from tacotron2_tpu.train.optim import make_optimizer as jax_make_optimizer
from tacotron2_tpu.train.state import TrainState as JaxTrainState
from tacotron2_torch import config as port_config
from tacotron2_torch.models import decoder as port_decoder
from tacotron2_torch.models.tacotron2 import Tacotron2
from tacotron2_torch.ops import decoder_bptt
from tacotron2_torch.train import loop as port_loop
from tacotron2_torch.train import step as port_step
from tacotron2_torch.train.optim import make_optimizer
from tacotron2_torch.train.state import TrainState, create_train_state
from tacotron2_torch.utils.weights import (export_jax_grads,
                                           export_jax_params, load_jax_params)
from test_torch_bptt import assert_trees_close, np_tree
from test_torch_parallel import assert_params_close

ROOT = os.path.join(os.path.dirname(__file__), "..")

# tests/test_remat.py::BASE, less its decoder_split_bptt=False: here the
# remat request itself turns the split BPTT off
BASE = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
            decoder_rnn_dim=48, prenet_dim=16, attention_rnn_dim=48,
            attention_dim=24, location_n_filters=8, location_kernel_size=15,
            postnet_embedding_dim=24, max_decoder_steps=40)
NO_DROPOUT = dict(p_attention_dropout=0.0, p_decoder_dropout=0.0,
                  p_prenet_dropout=0.0, p_postnet_dropout=0.0)
POLICIES = ("full", "dots")
VARIANTS = {"plain": dict(decoder_split_bptt=False),
            "full": dict(remat_decoder_step=True,
                         decoder_remat_policy="full"),
            "dots": dict(remat_decoder_step=True,
                         decoder_remat_policy="dots")}


def remat_batch(seed=0, t_dec=16):
    """``tests/test_remat.py::_batch`` (its T_dec by default)."""
    rng = np.random.default_rng(seed)
    return {
        "text": rng.integers(1, 72, (2, 8)).astype(np.int32),
        "text_lengths": np.array([8, 6], np.int32),
        "mel": (rng.standard_normal((2, 80, t_dec)) - 5.0).astype(np.float32),
        "mel_lengths": np.array([t_dec, 12], np.int32),
        "speaker_ids": np.zeros((2,), np.int32),
    }


def port_cfg(precision="float32", **model):
    return port_config.Config(
        model=port_config.ModelConfig(**{**BASE, **model}),
        train=port_config.TrainConfig(precision=precision))


def one_step(name, precision="float32"):
    """One ``train_step`` of the port from seed-0 weights and generator in
    variant ``name``: (total loss, the updated ``proj`` weight)."""
    cfg = port_cfg(precision, **VARIANTS[name])
    tx = make_optimizer(cfg.train)
    state = create_train_state(cfg, seed=0, tx=tx, device="cpu")
    state, losses, _ = port_step.train_step(
        state, remat_batch(), cfg=cfg, tx=tx, use_postnet=True,
        sigma_warmup_steps=800)
    return (float(losses.total),
            state.model.decoder.linear_projection.weight.detach().clone())


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", POLICIES)
def test_remat_step_matches_plain_step_loop(policy, precision):
    """``tests/test_remat.py::test_remat_step_matches_plain_step`` on the
    port, dropout on (the same masks: drawn before the loop from the same
    generator): loss within 1e-6 relative and ``proj`` within 1e-6 of
    the step loop without remat; the same bits here."""
    ref_loss, ref_w = one_step("plain", precision)
    loss, w = one_step(policy, precision)
    assert np.isclose(ref_loss, loss, rtol=1e-6)
    np.testing.assert_allclose(w.numpy(), ref_w.numpy(), atol=1e-6, rtol=0)
    assert loss == ref_loss and torch.equal(w, ref_w)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_step_matches_jax(policy):
    """The JAX ``train_step`` and the port's under the same
    ``remat_decoder_step`` / ``decoder_remat_policy`` (the split BPTT on in
    both configs, turned off by the request), on the JAX package's seed-0
    weights, dropout off: losses to 1e-4 relative, updated parameters to
    5e-5 of each leaf's size, 3 lr where the step's gradient is at noise
    (``ZERO_GRAD``'s leaves, and elements below 1e-3 of their leaf's
    largest gradient: ``tests/test_torch_parallel.py::
    assert_params_close``), BatchNorm state to 3e-4, the counters
    exactly."""
    remat = dict(remat_decoder_step=True, decoder_remat_policy=policy)
    kw = {**BASE, **NO_DROPOUT, **remat}
    train = dict(precision="float32", learning_rate=1e-3)
    jcfg = jax_config.Config(model=jax_config.ModelConfig(**kw),
                             train=jax_config.TrainConfig(**train))
    cfg = port_config.Config(model=port_config.ModelConfig(**kw),
                             train=port_config.TrainConfig(**train))
    params, state = tacotron2_init(jax.random.PRNGKey(0), jcfg.model)
    model = load_jax_params(Tacotron2(cfg.model), np_tree(params),
                            np_tree(state))
    jtx, tx = jax_make_optimizer(jcfg.train), make_optimizer(cfg.train)
    jstate = JaxTrainState(params=params, model_state=state,
                           opt_state=jtx.init(params), step=jnp.int32(0),
                           loss_step=jnp.int32(0), rng=jax.random.PRNGKey(1))
    tstate = TrainState(model=model, opt_state=tx.init(model), step=0,
                        loss_step=0, generator=torch.Generator())
    b = remat_batch(seed=1)
    jstate, jl, _ = jax_step.train_step(
        jstate, {k: jnp.asarray(v) for k, v in b.items()}, cfg=jcfg, tx=jtx,
        use_postnet=True, sigma_warmup_steps=800)
    seen = {}

    class Recorded:
        """The optimizer, keeping the gradients it is handed."""
        @staticmethod
        def update(model, opt_state, grads, names):
            seen["grads"] = export_jax_grads(model, grads)
            tx.update(model, opt_state, grads, names)

    tstate, tl_, _ = port_step.train_step(
        tstate, b, cfg=cfg, tx=Recorded, use_postnet=True,
        sigma_warmup_steps=800)
    for name in jl._fields:
        np.testing.assert_allclose(float(getattr(tl_, name)),
                                   float(getattr(jl, name)), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    p, s = export_jax_params(tstate.model)
    assert_params_close(np_tree(jstate.params), p, seen["grads"], policy)
    assert_trees_close(jstate.model_state, s, 3e-4, policy)
    assert (int(jstate.step), int(jstate.loss_step)) == (tstate.step,
                                                         tstate.loss_step)


@pytest.mark.parametrize("variant", ["split", "plain", *POLICIES])
def test_split_bptt_only_without_remat(variant, monkeypatch):
    """A spy on ``decoder_scan_bptt``: the default config calls it once a
    forward; the step loop without remat and either policy never do, though
    ``decoder_split_bptt`` stays on under remat."""
    calls = []
    real = decoder_bptt.decoder_scan_bptt
    monkeypatch.setattr(decoder_bptt, "decoder_scan_bptt",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = {} if variant == "split" else VARIANTS[variant]
    cfg = port_cfg(**model)
    assert cfg.model.decoder_split_bptt == (variant != "plain")
    state = create_train_state(cfg, seed=0, device="cpu")
    total, _ = port_step._forward_loss(
        state.model, cfg, port_step._to_device(remat_batch(),
                                               torch.device("cpu")),
        torch.Generator().manual_seed(0), 0, True, 800)
    assert torch.isfinite(total)
    assert len(calls) == (1 if variant == "split" else 0)


def test_unknown_policy_rejected(tmp_path):
    """The config route raises the JAX package's ValueError in train mode
    (``tests/test_remat.py::test_unknown_remat_policy_rejected``) and
    leaves eval mode alone; ``train(remat=...)`` raises the JAX loop's."""
    cfg = port_cfg(remat_decoder_step=True, decoder_remat_policy="bogus")
    tx = make_optimizer(cfg.train)
    state = create_train_state(cfg, seed=0, tx=tx, device="cpu")
    with pytest.raises(ValueError, match="decoder_remat_policy"):
        port_step.train_step(state, remat_batch(), cfg=cfg, tx=tx,
                             use_postnet=True, sigma_warmup_steps=800)
    losses, _, _ = port_step.eval_step(state, remat_batch(), cfg=cfg,
                                       sigma_warmup_steps=800)
    assert np.isfinite(float(losses.total))
    with pytest.raises(ValueError, match="remat must be 'off', 'full', or "
                                         "'dots'; got 'bogus'"):
        port_loop.train(str(tmp_path / "meta.csv"), str(tmp_path / "ckpt"),
                        remat="bogus", device="cpu")


class _Built(Exception):
    pass


@pytest.mark.parametrize("flag,on,policy", [
    (None, False, "full"), ("off", False, "full"), ("full", True, "full"),
    ("dots", True, "dots")])
def test_cli_remat_reaches_the_model_config(flag, on, policy, monkeypatch,
                                            tmp_path):
    """``train_torch.py --remat X`` builds its model from a config whose
    ``remat_decoder_step`` and ``decoder_remat_policy`` the flag set, as
    ``train.py``'s does (``tacotron2_tpu/train/loop.py:186-193``)."""
    seen = {}

    class Dataset:
        n_speakers = 1

        def __init__(self, path):
            pass

    def build(cfg, **kw):
        seen["model"] = cfg.model
        raise _Built

    monkeypatch.setattr(port_loop, "TextMelDataset", Dataset)
    monkeypatch.setattr(port_loop, "create_train_state", build)
    argv = ["train_torch.py", "meta.csv", str(tmp_path / "ckpt"),
            "--device", "cpu"] + ([] if flag is None else ["--remat", flag])
    monkeypatch.setattr(sys, "argv", argv)
    with pytest.raises(_Built):
        runpy.run_path(os.path.join(ROOT, "train_torch.py"),
                       run_name="__main__")
    assert seen["model"].remat_decoder_step is on
    assert seen["model"].decoder_remat_policy == policy


def saved_bytes(name, monkeypatch):
    """Bytes a bf16 forward at T_dec=16 keeps for its backward, by
    ``torch.autograd.graph.saved_tensors_hooks`` (which a remat region's
    own hooks take over), plus under "dots" the outputs of the products
    that the policy keeps beside them."""
    kept = []
    policy = port_decoder.dots_policy

    def recording(ctx, op, *args, **kwargs):
        choice = policy(ctx, op, *args, **kwargs)
        if (not ctx.is_recompute
                and choice == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE):
            out = op(*args, **kwargs)
            kept.append(out.numel() * out.element_size())
        return choice

    monkeypatch.setattr(port_decoder, "dots_policy", recording)
    cfg = port_cfg("bfloat16", **VARIANTS[name])
    state = create_train_state(cfg, seed=0, device="cpu")
    packed = []

    def pack(x):
        packed.append(x.numel() * x.element_size())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        total, _ = port_step._forward_loss(
            state.model, cfg, port_step._to_device(remat_batch(),
                                                   torch.device("cpu")),
            torch.Generator().manual_seed(0), 0, True, 800)
    port_step._grads(state.model, total)
    assert (len(kept) > 0) == (name == "dots")
    return sum(packed) + sum(kept)


def test_remat_keeps_fewer_bytes_bf16(monkeypatch):
    """bf16 at T_dec=16: "full" keeps fewer bytes for the backward than the
    step loop without remat, whose every step keeps its own bf16 casts of
    the step weights and their fp32 upcasts for the products; "dots" keeps
    no more (the products' outputs beside the region's edges)."""
    plain = saved_bytes("plain", monkeypatch)
    full = saved_bytes("full", monkeypatch)
    dots = saved_bytes("dots", monkeypatch)
    assert full < plain / 2
    assert full < dots <= plain

