"""The port's training loop, checkpoints and CLI against the JAX package's
on the CPU, at small widths, fp32, all four dropout rates 0 on both sides.

JAX ``train()`` and the port's ``train(device="cpu")`` both resume from
one params-only Orbax checkpoint that JAX's ``save_params_only`` writes,
on one corpus written here, and take the same steps; ``checkpoint_kind``
and ``load_any_checkpoint`` over every layout the port reads; a full
checkpoint continues bit for bit; ``train_torch.py``'s flags parse to the
arguments ``train.py`` hands the JAX ``train``."""

import dataclasses
import math
import os
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import tacotron2_tpu.train as jax_train_pkg
import tacotron2_tpu.utils.cache as jax_cache
from tacotron2_tpu import config as jax_config
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_tpu.train import checkpoint as jax_ckpt
from tacotron2_tpu.train import loop as jax_loop
from tacotron2_tpu.utils.torch_compat import torch_state_dict_from_params
from tacotron2_torch import config as port_config
from tacotron2_torch.data.dataset import Example, collate
from tacotron2_torch.data.synth_corpus import write_corpus
from tacotron2_torch.models.tacotron2 import Tacotron2
from tacotron2_torch.train import checkpoint as ckpt
from tacotron2_torch.train import loop as port_loop
from tacotron2_torch.train.optim import Optimizer, make_optimizer
from tacotron2_torch.train.state import create_train_state
from tacotron2_torch.train.step import train_step
from tacotron2_torch.utils.weights import (export_jax_grads,
                                           export_jax_params, load_jax_params)

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
import train_torch  # noqa: E402

SMALL = dict(n_mels=8, prenet_dim=16, symbols_embedding_dim=32,
             encoder_embedding_dim=32, decoder_rnn_dim=64,
             attention_rnn_dim=64, attention_dim=16, location_n_filters=4,
             location_kernel_size=7, postnet_embedding_dim=32)
NO_DROPOUT = dict(p_attention_dropout=0.0, p_decoder_dropout=0.0,
                  p_prenet_dropout=0.0, p_postnet_dropout=0.0)
TRAIN = dict(precision="float32", batch_size=2, save_every_steps=0)
# parameters whose true gradient is zero get 3 lr, as in
# tests/test_torch_bptt.py::test_train_steps_match_jax
ZERO_GRAD = {"['decoder']['attention']['v']['b']": 3e-3,
             **{f"['encoder']['convs'][{i}]['b']": 3e-3 for i in range(3)},
             **{f"['postnet']['convs'][{i}]['b']": 3e-3 for i in range(5)}}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def configs(**model):
    kw = {**SMALL, **NO_DROPOUT, **model}
    return (jax_config.Config(model=jax_config.ModelConfig(**kw),
                              train=jax_config.TrainConfig(**TRAIN)),
            port_config.Config(model=port_config.ModelConfig(**kw),
                               train=port_config.TrainConfig(**TRAIN)))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Eight one-word utterances (one padded shape: text 32, mel 64)."""
    root = str(tmp_path_factory.mktemp("corpus"))
    return write_corpus(root, 8, seed=1, words=(1, 1),
                        audio=port_config.AudioConfig(n_mels=8),
                        device="cpu")[0]


@pytest.fixture(scope="module")
def orbax_params(tmp_path_factory):
    """A params-only Orbax checkpoint of seeded weights, by JAX."""
    jcfg, _ = configs()
    params, state = tacotron2_init(jax.random.PRNGKey(4), jcfg.model)
    path = str(tmp_path_factory.mktemp("orbax") / "params")
    jax_ckpt.save_params_only(path, params, state)
    return path, np_tree(params), np_tree(state)


def assert_trees_close(ref, got, atol, what, loose=None, near_zero=None):
    """Leaf by leaf within ``atol`` of max(1, the leaf's size); a leaf of
    ``loose`` within its own limit, and so is each element that
    ``near_zero`` (a tree of 0/1 masks) marks."""
    assert (jax.tree_util.tree_structure(np_tree(ref))
            == jax.tree_util.tree_structure(got))
    marks = (jax.tree_util.tree_leaves(near_zero) if near_zero is not None
             else [None] * len(jax.tree_util.tree_leaves(got)))
    for (path, r), g, m in zip(jax.tree_util.tree_leaves_with_path(ref),
                               jax.tree_util.tree_leaves(got), marks):
        r = np.asarray(r)
        key = jax.tree_util.keystr(path)
        tol = (loose or {}).get(key, atol * max(1.0, float(np.abs(r).max())))
        if m is not None:
            tol = np.where(np.asarray(m) > 0, ZERO_GRAD_LIMIT, tol)
        diff = np.abs(np.asarray(g) - r)
        assert (diff <= tol).all(), (what, key, np.argwhere(diff > tol)[:5],
                                     diff[diff > tol][:5])


ZERO_GRAD_LIMIT = 3e-3
NEAR_ZERO = 1e-4


def near_zero_elements(steps):
    """Per parameter, the elements whose gradient was below ``NEAR_ZERO``
    times the parameter's median gradient size in some step: the same
    rounding noise as the ``ZERO_GRAD`` leaves'.  A train-mode BatchNorm
    gives the conv before it a zero-mean gradient per channel, so a weight
    whose input barely moves gets a true gradient near zero, and Adam's
    first update ``lr * g / (|g| + eps)`` takes the noise's sign.  An
    exact zero (an embedding row no token of the batch reads) moves
    neither side and is not marked."""
    marks = {}
    for grads in steps:
        for name, g in grads.items():
            size = g.abs()
            small = ((size < NEAR_ZERO * size.median()) & (size > 0)).float()
            marks[name] = torch.maximum(marks.get(name, small), small)
    return marks


def test_train_matches_jax(corpus, orbax_params, tmp_path, monkeypatch):
    """Both ``train()``s from one Orbax checkpoint, one epoch of four
    steps (the first two with the postnet bypassed): every step's losses
    to 1e-4 relative, then the weights at the train step's limits (5e-5 of
    max(1, size); the zero-gradient leaves, and the elements whose
    gradient was near zero in a step, 3 lr; BatchNorm statistics 3e-4)
    and the counters exactly."""
    path, _, _ = orbax_params
    jcfg, cfg = configs()
    updates = []
    plain_update = Optimizer.update

    def update(self, model, opt_state, grads, *sharded):
        updates.append({n: g.detach().clone() for n, g in grads.items()})
        return plain_update(self, model, opt_state, grads, *sharded)

    monkeypatch.setattr(Optimizer, "update", update)
    recorded = {"jax": [], "port": []}
    for side, module in (("jax", jax_loop), ("port", port_loop)):
        plain = module.train_step

        def step(*a, _plain=plain, _side=side, **k):
            out = _plain(*a, **k)
            recorded[_side].append(out[1])
            return out

        monkeypatch.setattr(module, "train_step", step)
    kw = dict(epochs=1, resume=path, postnet_freeze_steps_override=2)
    jstate = jax_loop.train(corpus, str(tmp_path / "jax"), cfg=jcfg, **kw)
    state = port_loop.train(corpus, str(tmp_path / "port"), cfg=cfg,
                            device="cpu", **kw)
    assert len(recorded["jax"]) == len(recorded["port"]) == 4
    for i, (jl, tl) in enumerate(zip(recorded["jax"], recorded["port"])):
        for name in jl._fields:
            np.testing.assert_allclose(
                float(getattr(tl, name)), float(getattr(jl, name)),
                rtol=1e-4, atol=1e-6, err_msg=f"step {i} {name}")
    params, model_state = export_jax_params(state.model)
    marks = export_jax_grads(state.model, near_zero_elements(updates))
    assert 0 < sum(float(m.sum()) for m in jax.tree_util.tree_leaves(marks)
                   ) < 1e-3 * sum(p.numel() for p in state.model.parameters())
    assert_trees_close(jstate.params, params, 5e-5, "weights",
                       loose=ZERO_GRAD, near_zero=marks)
    # a running mean sees its conv's bias, a ZERO_GRAD leaf, at every one
    # of the four steps: momentum 0.1 times 3 lr, four times; a running
    # variance does not see it
    means = {f"['{part}']['bn'][{i}]['mean']": 0.1 * ZERO_GRAD_LIMIT * 4
             for part, n in (("encoder", 3), ("postnet", 5))
             for i in range(n)}
    assert_trees_close(jstate.model_state, model_state, 3e-4, "statistics",
                       loose=means)
    assert (int(jstate.step), int(jstate.loss_step)) == (
        state.step, state.loss_step) == (4, 4)
    for sub in ("jax", "port"):
        assert os.path.isdir(tmp_path / sub / "tacotron2_epoch_1")
        assert os.path.isfile(tmp_path / sub / "alignment_epoch_1.png")
    assert ckpt.checkpoint_kind(str(tmp_path / "port" / "tacotron2_epoch_1")
                                ) == "full"


def small_state(seed=0, **model):
    cfg = port_config.Config(model=port_config.ModelConfig(**SMALL, **model))
    return cfg, create_train_state(cfg, seed=seed, device="cpu")


def small_batch(seed=0):
    rng = np.random.default_rng(seed)
    return collate([Example(
        text=rng.integers(0, 72, n).astype(np.int32),
        mel=(rng.standard_normal((8, m)) - 4.0).astype(np.float32))
        for n, m in ((9, 20), (6, 14))], 4, 4)


def equal_states(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return (all(torch.equal(sa[k], sb[k]) for k in sa)
            and all(torch.equal(a.opt_state[m][n], b.opt_state[m][n])
                    for m in ("mu", "nu") for n in a.opt_state[m])
            and (a.step, a.loss_step, a.opt_state["count"])
            == (b.step, b.loss_step, b.opt_state["count"])
            and torch.equal(a.generator.get_state(), b.generator.get_state()))


def test_full_checkpoint_continues_bit_for_bit(tmp_path):
    """Dropout on (the generator matters): two steps, save, two more;
    against restore into a fresh state and the same two steps."""
    cfg, state = small_state()
    tx = make_optimizer(cfg.train)
    batches = [small_batch(i) for i in range(4)]
    warm = cfg.guided_attention.sigma_warmup_steps

    def steps(s, bs):
        for b in bs:
            s = train_step(s, b, cfg=cfg, tx=tx, use_postnet=True,
                           sigma_warmup_steps=warm)[0]
        return s

    state = steps(state, batches[:2])
    path = str(tmp_path / "tacotron2_epoch_1")
    ckpt.save_checkpoint(path, state, 1, 2.5)
    assert os.listdir(path) == [ckpt.FULL_FILE]
    whole = steps(state, batches[2:])
    _, template = small_state(seed=9)
    restored, epoch, best = ckpt.restore_checkpoint(path, template)
    assert (epoch, best) == (1, 2.5)
    assert equal_states(steps(restored, batches[2:]), whole)


def test_a_save_cut_off_leaves_the_checkpoint_before_it(tmp_path,
                                                        monkeypatch):
    cfg, state = small_state()
    path = str(tmp_path / "best_model")
    ckpt.save_checkpoint(path, state, 1, 3.0)
    before = open(os.path.join(path, ckpt.FULL_FILE), "rb").read()

    def cut_off(obj, f):
        with open(f, "wb") as out:
            out.write(b"half a checkpoint")
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ckpt.torch, "save", cut_off)
    state.step = 99
    with pytest.raises(OSError):
        ckpt.save_checkpoint(path, state, 2, 1.0)
    assert os.listdir(path) == [ckpt.FULL_FILE]
    assert open(os.path.join(path, ckpt.FULL_FILE), "rb").read() == before
    logs = []

    class Log:
        def log(self, msg):
            logs.append(msg)

    assert port_loop._save_best_effort(path, state, 2, 1.0, Log()) is False
    assert "No space left" in logs[0]


def test_checkpoint_kinds_and_loads(orbax_params, tmp_path):
    """Each layout is told apart and loads: the port's full and
    params-only directories, the JAX package's Orbax directory, the
    reference's PyTorch dict (bare and under ``model_state_dict``), and
    an unknown layout, whose error names both attempts."""
    orbax, params, model_state = orbax_params
    cfg, state = small_state(**NO_DROPOUT)
    ref = Tacotron2(cfg.model)
    load_jax_params(ref, params, model_state)
    want = ref.state_dict()

    full, only = str(tmp_path / "full"), str(tmp_path / "only")
    ckpt.save_checkpoint(full, state, 3, 1.5)
    ckpt.save_params_only(only, ref)
    reference_sd = {k: torch.from_numpy(np.array(v)) for k, v in
                    torch_state_dict_from_params(params, model_state,
                                                 jax_config.ModelConfig(
                                                     **SMALL)).items()}
    bare, wrapped = str(tmp_path / "bare.pt"), str(tmp_path / "wrapped.pt")
    torch.save(reference_sd, bare)
    torch.save({"model_state_dict": reference_sd, "epoch": 7}, wrapped)
    empty = tmp_path / "empty"
    empty.mkdir()
    garbage = tmp_path / "garbage.bin"
    garbage.write_bytes(b"not a checkpoint")
    kinds = {full: "full", only: "params_only", orbax: "orbax",
             bare: "reference", wrapped: "reference", str(empty): "unknown",
             str(garbage): "unknown", str(tmp_path / "none"): "unknown"}
    for path, kind in kinds.items():
        assert ckpt.checkpoint_kind(path) == kind, path

    _, template = small_state(seed=5, **NO_DROPOUT)
    got, epoch, best = ckpt.load_any_checkpoint(full, template)
    assert got is template and (epoch, best) == (3, 1.5)
    assert equal_states(got, state)
    for path in (only, orbax, bare, wrapped):
        _, template = small_state(seed=5, **NO_DROPOUT)
        got, epoch, best = ckpt.load_any_checkpoint(path, template)
        assert got is None and (epoch, best) == (0, math.inf)
        sd = template.model.state_dict()
        for k, v in want.items():
            assert torch.equal(sd[k], v), (path, k)
        assert template.opt_state["count"] == 0
    for path in (str(empty), str(garbage)):
        with pytest.raises(RuntimeError, match="full training state .* "
                                               "params-only"):
            ckpt.load_any_checkpoint(path, small_state()[1])


def test_resume_from_orbax_restarts_the_counters(corpus, orbax_params,
                                                 tmp_path, capsys):
    """``train(resume=Orbax directory)`` warns, starts at epoch 1 with
    fresh moments and runs every epoch asked for."""
    path, params, model_state = orbax_params
    _, cfg = configs()
    state = port_loop.train(corpus, str(tmp_path / "run"), cfg=cfg,
                            epochs=2, resume=path, device="cpu")
    out = capsys.readouterr().out
    assert "params-only checkpoint" in out and "(epoch 1, step 0)" in out
    assert state.step == state.opt_state["count"] == 8
    assert ckpt.checkpoint_kind(str(tmp_path / "run" / "best_model")
                                ) == "unknown"      # no validation set
    resumed = port_loop.train(
        corpus, str(tmp_path / "run"), cfg=cfg, epochs=3, device="cpu",
        resume=str(tmp_path / "run" / "tacotron2_epoch_2"))
    assert "(epoch 3, step 8)" in capsys.readouterr().out
    assert resumed.step == 12


def test_epoch_resume_goes_on_where_jax_repeats_the_epoch(
        corpus, orbax_params, tmp_path):
    """The one meaning of ``--resume`` that differs from the JAX loop's,
    pinned against it: after one epoch from the same Orbax checkpoint,
    both resume from their ``tacotron2_epoch_1`` with ``epochs=2``; the
    JAX loop runs epoch 1 again and then epoch 2 (eight more steps), the
    port runs epoch 2 alone (four)."""
    path, _, _ = orbax_params
    jcfg, cfg = configs()
    jax_loop.train(corpus, str(tmp_path / "jax"), cfg=jcfg, epochs=1,
                   resume=path)
    port_loop.train(corpus, str(tmp_path / "port"), cfg=cfg, epochs=1,
                    resume=path, device="cpu")
    jstate = jax_loop.train(
        corpus, str(tmp_path / "jax"), cfg=jcfg, epochs=2,
        resume=str(tmp_path / "jax" / "tacotron2_epoch_1"))
    state = port_loop.train(
        corpus, str(tmp_path / "port"), cfg=cfg, epochs=2, device="cpu",
        resume=str(tmp_path / "port" / "tacotron2_epoch_1"))
    assert int(jstate.step) == 4 + 8
    assert state.step == 4 + 4


def test_debug_overfit_exports(corpus, tmp_path):
    """``--debug``: one batch, then the params-only model, the batch and
    the inference artifacts under ``debug_export``."""
    _, cfg = configs()
    cfg = dataclasses.replace(
        cfg, audio=port_config.AudioConfig(n_mels=8),
        train=dataclasses.replace(cfg.train, debug_batch_size=2))
    port_loop.train(corpus, str(tmp_path), cfg=cfg, epochs=1,
                    debug_overfit=True, device="cpu")
    export = tmp_path / "debug_export"
    assert ckpt.checkpoint_kind(str(export / "overfit_model")) == \
        "params_only"
    names = set(os.listdir(export))
    assert {"debug_batch.npz", "pairs.csv", "debug_infer_alignment.png",
            "debug_infer_0.wav", "debug_infer_1.wav", "sample_0.txt",
            "debug_infer_mel_1.npy"} <= names
    assert os.path.isfile(tmp_path / "debug_alignment_iter_20.png") or any(
        n.startswith("debug_alignment_iter_") for n in os.listdir(tmp_path))


def test_tensor_parallel_raises(corpus, tmp_path):
    """The JAX loop's two errors (``tests/test_parallel.py::
    test_tp_validation_errors``): a tensor-parallel width that does not
    divide the devices (one process here), and a global batch the data
    axis does not split (8 devices, tp 2, batch 6, as the JAX test)."""
    with pytest.raises(RuntimeError, match="does not divide"):
        port_loop.train(corpus, str(tmp_path), tensor_parallel=3,
                        device="cpu")
    with pytest.raises(RuntimeError, match="not divisible by the data-axis"):
        port_loop.tensor_parallel_grid(8, 2, 6)
    assert port_loop.tensor_parallel_grid(8, 2, 8) == 4


@pytest.mark.parametrize("argv", [
    ["meta.csv", "ckpt"],
    ["meta.csv", "ckpt", "--epochs", "3", "--batch_size", "4", "--lr",
     "2e-3", "--debug", "--precision", "fp32"],
    ["meta.csv", "ckpt", "--val_metadata", "val.csv", "--resume", "r",
     "--postnet_freeze_steps", "0", "--accum_steps", "2",
     "--keep_epoch_ckpts", "0", "--precision", "bf16", "--tp", "1"],
    ["meta.csv", "ckpt", "--batch_size", "4", "--tp", "2"],
    ["meta.csv", "ckpt", "--remat", "full"],
    ["meta.csv", "ckpt", "--remat", "dots", "--tp", "2"],
    ["meta.csv", "ckpt", "--remat", "off", "--precision", "fp32"],
])
def test_cli_flags_match_train_py(argv, monkeypatch):
    """``train_torch.py``'s flags give the port's ``train`` the arguments
    ``train.py`` gives the JAX one, ``remat`` among them, plus
    ``device``."""
    seen = {}
    monkeypatch.setattr(jax_train_pkg, "train",
                        lambda **kw: seen.update(kw))
    monkeypatch.setattr(jax_cache, "enable_persistent_cache", lambda: None)
    monkeypatch.setattr(sys, "argv", ["train.py", *argv])
    runpy.run_path(os.path.join(ROOT, "train.py"), run_name="__main__")
    assert seen["remat"] == (argv[argv.index("--remat") + 1]
                             if "--remat" in argv else None)
    port = train_torch.train_kwargs(train_torch.parse_args(argv))
    assert port.pop("device") == "cuda"
    assert port == seen
    monkeypatch.setattr(port_loop, "train", lambda **kw: seen.update(
        ran=kw))
    monkeypatch.setattr(sys, "argv", ["train_torch.py", *argv, "--device",
                                      "cpu"])
    runpy.run_path(os.path.join(ROOT, "train_torch.py"), run_name="__main__")
    assert seen["ran"] == dict(port, device="cpu")
