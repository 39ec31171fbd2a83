"""The port's data parallelism (A16) against the JAX package on the CPU.

Two ranks on gloo (``tests/torch_dp_worker.py``, one subprocess a rank,
joined at a ``file://`` store in the test's temporary directory; every
wait is bounded and a hung rank is killed) run, on their own rows of one
global batch: train-mode BatchNorm, the loss on ragged rows split
unevenly, ``train_step`` / ``train_step_accum`` / ``eval_step``, and
``train()`` end to end with and without ``debug_overfit``.  Each is held to the JAX package on the whole
batch (``batchnorm_apply`` and ``jax.grad``, ``tacotron2_loss``, the JAX
``train_step`` on the 8-device mesh with ``test_dp8_matches_single_device``'s
inputs) and to one process of the port on the whole batch.  The loader's
process split is held to the JAX loader's, and ``ShardedSynthesizer``
over two CPU replicas to the JAX one over the 8-device mesh and to the
port's unsharded ``synthesize_wav``.

Widths are ``tests/test_parallel.py``'s ``SMALL``.  Limits: fp32 sums in
another order give 1e-5 relative (BatchNorm, the loss, gradients, two
ranks against one process); the train step against JAX keeps
``tests/test_torch_bptt.py``'s (losses 1e-4 relative, parameters 5e-5 of
each leaf's size, the zero-gradient leaves 3 * lr, BatchNorm state 3e-4);
the synthesizer keeps ``tests/test_parallel.py``'s (2 Griffin-Lim
iterations, 5e-3 absolute, 5e-4 on average).  Gradients are compared
as well as updated parameters: Adam's step hardly sees a gradient scaled
by the number of ranks.
"""

import csv
import dataclasses
import importlib.util
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tacotron2_tpu import config as jax_config
from tacotron2_tpu.data import dataset as jax_dataset
from tacotron2_tpu.infer import ShardedSynthesizer as JaxSharded
from tacotron2_tpu.models.layers import batchnorm_apply
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_tpu.parallel import make_mesh as jax_make_mesh
from tacotron2_tpu.parallel import shard_train_state as jax_shard_state
from tacotron2_tpu.train import loss as jax_loss
from tacotron2_tpu.train import step as jax_step
from tacotron2_tpu.train.optim import make_optimizer as jax_make_optimizer
from tacotron2_tpu.train.state import TrainState as JaxTrainState
from tacotron2_torch import config as port_config
from tacotron2_torch.data import dataset as port_dataset
from tacotron2_torch.dsp import griffinlim as tgl
from tacotron2_torch.infer import ShardedSynthesizer
from tacotron2_torch.infer.fused import synthesize_wav
from tacotron2_torch.models.tacotron2 import Tacotron2
from tacotron2_torch.parallel import (initialize_distributed, make_mesh,
                                      rank_device, shard_batch)
from tacotron2_torch.train import loss as port_loss
from tacotron2_torch.utils.weights import load_jax_params

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
WAIT_S = 300            # the two ranks' run, bounded
SMALL = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
             decoder_rnn_dim=48, prenet_dim=16, attention_rnn_dim=48,
             attention_dim=24, location_n_filters=8, location_kernel_size=15,
             postnet_embedding_dim=24, max_decoder_steps=50)
NO_DROPOUT = dict(p_attention_dropout=0.0, p_decoder_dropout=0.0,
                  p_prenet_dropout=0.0, p_postnet_dropout=0.0)
TRAIN = dict(precision="float32", learning_rate=1e-3)
SIGMA_WARMUP = 800
# Adam divides by |g| + eps, so where a gradient is at fp32 noise the step's
# direction is noise: two sides may part by up to 3e-3 a step there (twice
# the attention's learning rate of 1.5e-3).  That holds for the leaves whose
# true gradient is zero (tests/test_torch_bptt.py::ZERO_GRAD) and, on the DP8
# inputs, for the last postnet layer's conv weight and BatchNorm scale (every
# prediction starts above its target, near -5, so each channel's L1 gradient
# has one sign and its sum over the normalised activations cancels; JAX's
# own mesh and single-device steps part by 1.4e-4 there), and for every
# element whose gradient is below NOISY_GRAD of its leaf's largest.
ADAM_NOISE = 3e-3
NOISY_GRAD = 1e-3
GRAD_TOL = 1e-5         # fp32 gradients summed in another order
# (the attention's v bias shifts every energy alike, and a conv bias straight
# before a train-mode BatchNorm is cancelled by the batch mean)
STRUCTURAL_ZERO = {"['decoder']['attention']['v']['b']",
                   *(f"['encoder']['convs'][{i}]['b']" for i in range(3)),
                   *(f"['postnet']['convs'][{i}]['b']" for i in range(5))}
ZERO_GRAD = STRUCTURAL_ZERO | {"['postnet']['convs'][4]['w']",
                               "['postnet']['bn'][4]['scale']"}

_worker_spec = importlib.util.spec_from_file_location(
    "torch_dp_worker", os.path.join(HERE, "torch_dp_worker.py"))
worker = importlib.util.module_from_spec(_worker_spec)
_worker_spec.loader.exec_module(worker)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves(tree):
    return [(jax.tree_util.keystr(path), np.asarray(x))
            for path, x in jax.tree_util.tree_leaves_with_path(tree)]


def assert_trees_close(ref, got, atol, what):
    """Leaf by leaf within ``atol`` times the leaf's largest value (at least
    1)."""
    assert (jax.tree_util.tree_structure(np_tree(ref))
            == jax.tree_util.tree_structure(got))
    for (key, r), (_, g) in zip(leaves(ref), leaves(got)):
        np.testing.assert_allclose(g, r, rtol=0, err_msg=f"{what} {key}",
                                   atol=atol * max(1.0, float(np.abs(r).max())))


def assert_grads_close(ref, got, what):
    """Leaf by leaf within ``GRAD_TOL`` of the leaf's largest value plus
    1e-6 of the tree's largest; the ``STRUCTURAL_ZERO`` leaves, which hold
    only fp32 noise, below 1e-5 of the tree's largest on both sides."""
    top = max(float(np.abs(r).max()) for _, r in leaves(ref))
    for (key, r), (_, g) in zip(leaves(ref), leaves(got)):
        if key in STRUCTURAL_ZERO:
            assert max(np.abs(r).max(), np.abs(g).max()) < 1e-5 * top, \
                f"{what} {key}"
            continue
        np.testing.assert_allclose(
            g, r, rtol=0, err_msg=f"{what} {key}",
            atol=GRAD_TOL * float(np.abs(r).max()) + 1e-6 * top)


def assert_params_close(ref, got, grads, what):
    """Parameters after one Adam step: 5e-5 of each leaf's size (at least
    1), ``ADAM_NOISE`` where the step's gradient ``grads`` (the reference
    side's) is at noise."""
    for (key, r), (_, g), (_, x) in zip(leaves(ref), leaves(got),
                                        leaves(grads)):
        noisy = ((key in ZERO_GRAD)
                 | (np.abs(x) < NOISY_GRAD * np.abs(x).max()))
        tol = np.where(noisy, ADAM_NOISE,
                       5e-5 * max(1.0, float(np.abs(r).max())))
        bad = np.abs(g - r) > tol
        assert not bad.any(), (f"{what} {key}: {int(bad.sum())} of {r.size} "
                               f"off, largest {float(np.abs(g - r).max())}")


def assert_trees_equal(a, b, what):
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y, err_msg=what)


def make_corpus(root, n, seed=0):
    """A preprocessed corpus written directly: ragged text and mel
    ``.npy`` caches and their metadata."""
    rng = np.random.default_rng(seed)
    for sub in ("text", "mels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rows = []
    for i in range(n):
        base = f"DP-{i:04d}"
        np.save(os.path.join(root, "text", f"{base}.npy"),
                rng.integers(1, 72, int(rng.integers(6, 14))).astype(np.int32))
        np.save(os.path.join(root, "mels", f"{base}.npy"),
                (rng.standard_normal((80, int(rng.integers(20, 44))))
                 - 5.0).astype(np.float32))
        rows.append({"filepath": f"/wavs/{base}.wav", "text": f"t {i}"})
    meta = os.path.join(root, "metadata.csv")
    with open(meta, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=["filepath", "text"])
        w.writeheader()
        w.writerows(rows)
    return meta


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------
def dp8_batch(b=8, t_enc=8, t_dec=16, seed=0):
    """``tests/test_parallel.py::_batch``: the DP8 test's inputs."""
    rng = np.random.default_rng(seed)
    return {
        "text": rng.integers(1, 72, (b, t_enc)).astype(np.int32),
        "text_lengths": np.full((b,), t_enc, np.int32),
        "mel": (rng.standard_normal((b, 80, t_dec)).astype(np.float32) - 5.0),
        "mel_lengths": np.full((b,), t_dec, np.int32),
        "speaker_ids": np.zeros((b,), np.int32),
    }


def bn_inputs():
    rng = np.random.default_rng(1)
    b, c, t = 8, 6, 5
    return {"x": (rng.standard_normal((b, c, t)) * 2 + 0.5).astype(np.float32),
            "cot": rng.standard_normal((b, c, t)).astype(np.float32),
            "weight": rng.uniform(0.5, 2, c).astype(np.float32),
            "bias": rng.standard_normal(c).astype(np.float32),
            "running_mean": rng.standard_normal(c).astype(np.float32),
            "running_var": rng.uniform(0.5, 2, c).astype(np.float32),
            "eps": 1e-5, "momentum": 0.1,
            "rows": [np.arange(0, 4), np.arange(4, 8)]}


# each split: rank 0 holds the long items, rank 1 the short ones
LOSS_SPLITS = {"4+4": [np.arange(0, 4), np.arange(4, 8)],
               "3+5": [np.arange(0, 3), np.arange(3, 8)]}


def loss_inputs(rows):
    rng = np.random.default_rng(2)
    b, t_dec, t_enc, m = 8, 16, 12, 8
    e = np.exp(rng.standard_normal((b, t_dec, t_enc)) * 2)
    return dict(
        mel_postnet=rng.standard_normal((b, t_dec, m)).astype(np.float32),
        mel_coarse=rng.standard_normal((b, t_dec, m)).astype(np.float32),
        gate_logits=(rng.standard_normal((b, t_dec)) * 3).astype(np.float32),
        alignments=(e / e.sum(-1, keepdims=True)).astype(np.float32),
        mel_target=rng.standard_normal((b, m, t_dec)).astype(np.float32),
        mel_lengths=np.asarray([16, 15, 14, 12, 7, 6, 5, 4], np.int32),
        text_lengths=np.asarray([12, 11, 12, 10, 6, 5, 4, 3], np.int32),
        loss_step=30, sigma_warmup=100, rows=rows)


def configs(dropout: bool):
    kw = {**SMALL, **({} if dropout else NO_DROPOUT)}
    return (jax_config.Config(model=jax_config.ModelConfig(**kw),
                              train=jax_config.TrainConfig(**TRAIN)),
            port_config.Config(model=port_config.ModelConfig(**kw),
                               train=port_config.TrainConfig(**TRAIN)))


def draw_masks(cfg, b, t_dec, seed=5):
    """Global keep-masks in the port's layout (dropout rates of ``cfg``)."""
    rng = np.random.default_rng(seed)
    mc = cfg.model
    keep = lambda shape, rate: rng.random(shape) >= rate
    post = [mc.postnet_embedding_dim] * (mc.postnet_n_convolutions - 1) \
        + [mc.n_mels]
    return {"prenet": [keep((b, t_dec, mc.prenet_dim), mc.p_prenet_dropout)
                       for _ in range(2)],
            "attention": keep((t_dec, b, mc.decoder_rnn_dim),
                              mc.p_attention_dropout),
            "decoder": keep((t_dec, b, mc.decoder_rnn_dim),
                            mc.p_decoder_dropout),
            "postnet": [keep((b, c, t_dec), mc.p_postnet_dropout)
                        for c in post]}


def mask_rows(masks, rank):
    """This rank's rows of global masks (batch axis 1 for the LSTMs')."""
    rows = slice(rank * 4, (rank + 1) * 4)
    return {k: [m[rows] for m in v] if isinstance(v, list) else v[:, rows]
            for k, v in masks.items()}


def step_inputs(dropout: str):
    """One train-step case: weights, the DP8 batch and two micro-batches
    of 8; ``dropout`` "off", "generator" (drawn from the state's
    generator) or "masks" (global masks handed in, cut to rows)."""
    jcfg, cfg = configs(dropout != "off")
    params, state = tacotron2_init(jax.random.PRNGKey(0), jcfg.model)
    batch = dp8_batch()
    micro = {k: np.stack([dp8_batch(seed=1)[k], dp8_batch(seed=2)[k]])
             for k in batch}
    masks = draw_masks(cfg, 8, 16) if dropout == "masks" else None
    return dict(
        cfg=cfg, params=np_tree(params), model_state=np_tree(state),
        seed=3, batch=[shard_batch(batch, r, WORLD) for r in range(WORLD)],
        micro=[{k: v[:, r * 4:(r + 1) * 4] for k, v in micro.items()}
               for r in range(WORLD)],
        masks=[None if masks is None else mask_rows(masks, r)
               for r in range(WORLD)],
        whole=dict(batch=[batch], micro=[micro], masks=[masks]),
        jax=(jcfg, params, state, batch, micro))


STEP_CASES = ("off", "generator", "masks")


# --------------------------------------------------------------------------
# the two ranks' run, once for the module
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    _, train_cfg = configs(True)
    train_cfg = dataclasses.replace(train_cfg, train=dataclasses.replace(
        train_cfg.train, epochs=1, batch_size=1, text_pad_multiple=4,
        mel_pad_multiple=8))
    steps = {name: step_inputs(name) for name in STEP_CASES}
    spec = {"bn": bn_inputs(),
            "loss": [loss_inputs(rows) for rows in LOSS_SPLITS.values()],
            "steps": {k: {f: v for f, v in c.items()
                          if f not in ("whole", "jax")}
                      for k, c in steps.items()},
            "train": {"meta": make_corpus(str(tmp / "corpus"), 4),
                      "ckpt": str(tmp / "ckpt"),
                      "debug_ckpt": str(tmp / "debug"), "cfg": train_cfg}}
    with open(tmp / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    procs, logs = [], []
    for rank in range(WORLD):
        logs.append(open(tmp / f"rank{rank}.log", "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_dp_worker.py"),
             str(rank), str(WORLD), str(tmp / "store"), str(tmp / "spec.pkl"),
             str(tmp / f"rank{rank}.pkl")],
            env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + WAIT_S
    try:
        while (any(p.poll() is None for p in procs)
               and time.monotonic() < deadline
               and not any(p.returncode for p in procs)):
            time.sleep(0.2)
    finally:
        for p in procs:                  # a hung or orphaned rank dies
            if p.poll() is None:
                p.kill()
            p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        assert p.returncode == 0, f"rank {rank} exit {p.returncode}:\n" \
            + log.read()[-4000:]
        log.close()
    outs = []
    for rank in range(WORLD):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return spec, steps, outs


# --------------------------------------------------------------------------
# the loader's process split
# --------------------------------------------------------------------------
@pytest.mark.parametrize("process_index", [0, 1])
def test_loader_split_matches_jax(tmp_path, process_index):
    """Each process's rows and padded shapes are the JAX loader's over two
    epochs, and an epoch skipped leads to the JAX loader's second; the
    padded dims are the global batch's, equal on both processes."""
    meta = make_corpus(str(tmp_path), 12)
    kw = dict(seed=42, text_pad_multiple=4, mel_pad_multiple=8,
              process_count=2)
    make = lambda pi: port_dataset.BatchLoader(
        port_dataset.TextMelDataset(meta), 2, process_index=pi, **kw)
    ref_loader = jax_dataset.BatchLoader(
        jax_dataset.TextMelDataset(meta), 2, prefetch=0,
        process_index=process_index, **kw)
    port = make(process_index)
    assert len(port) == len(ref_loader) == 3
    ref = [list(ref_loader) for _ in range(2)]
    got = [list(port) for _ in range(2)]
    other = list(make(1 - process_index))
    resumed = make(process_index)
    resumed.skip_epochs(1)
    got.append(list(resumed))
    ref.append(ref[1])
    for epoch, (g_ep, r_ep) in enumerate(zip(got, ref)):
        assert len(g_ep) == len(r_ep) == 3
        for g, r in zip(g_ep, r_ep):
            assert g.keys() == r.keys()
            for k in r:
                np.testing.assert_array_equal(g[k], r[k],
                                              err_msg=f"epoch {epoch} {k}")
    for g, o in zip(got[0], other):
        assert g["text"].shape == o["text"].shape
        assert g["mel"].shape == o["mel"].shape
    # the split forces drop_last and checks its index
    ds = port_dataset.TextMelDataset(meta)
    assert len(port_dataset.BatchLoader(
        ds, 5, drop_last=False, process_index=1, process_count=2)) == 1
    with pytest.raises(ValueError, match="process_index"):
        port_dataset.BatchLoader(ds, 2, process_index=2, process_count=2)
    with pytest.raises(ValueError, match="global batch is 14"):
        port_dataset.BatchLoader(ds, 7, process_index=0, process_count=2)


# --------------------------------------------------------------------------
# BatchNorm and the loss on two ranks
# --------------------------------------------------------------------------
def test_global_batchnorm_matches_jax(dp):
    """Train-mode BatchNorm over two ranks of four rows against
    ``batchnorm_apply`` on all eight: outputs, running statistics, and the
    gradients of sum(y * cot) by ``jax.grad``: the input's rows on each
    rank, scale and bias summed over the ranks."""
    spec, _, outs = dp
    s = spec["bn"]
    p = {"scale": jnp.asarray(s["weight"]), "bias": jnp.asarray(s["bias"])}
    st = {"mean": jnp.asarray(s["running_mean"]),
          "var": jnp.asarray(s["running_var"])}

    def f(p, x):
        y, new = batchnorm_apply(p, st, x, True, s["momentum"], s["eps"])
        return (y * s["cot"]).sum(), (y, new)

    (_, (y, new)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(p, jnp.asarray(s["x"]))
    got = [o["bn"] for o in outs]
    cat = lambda k: np.concatenate([g[k] for g in got])
    np.testing.assert_allclose(cat("y"), np.asarray(y), atol=1e-5, rtol=0)
    np.testing.assert_allclose(cat("x_grad"), np.asarray(gx), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got[0]["weight_grad"] + got[1]["weight_grad"],
                               np.asarray(gp["scale"]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[0]["bias_grad"] + got[1]["bias_grad"],
                               np.asarray(gp["bias"]), atol=1e-5, rtol=0)
    for g in got:
        np.testing.assert_allclose(g["running_mean"], np.asarray(new["mean"]),
                                   atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["running_var"], np.asarray(new["var"]),
                                   atol=1e-5, rtol=0)
    # one rank's own moments would be far off
    assert np.abs(got[0]["y"] - np.asarray(y)[:4]).max() < 1e-5
    assert abs(float(s["x"][:4].mean()) - float(s["x"].mean())) > 1e-2


@pytest.mark.parametrize("split", list(LOSS_SPLITS))
def test_loss_on_ragged_split_matches_jax(dp, split):
    """Long items on rank 0, short ones on rank 1 (and three rows against
    five): every ``LossOutput`` field on both ranks equals the JAX loss on
    the whole batch (1e-5 relative), and the rows of each rank's gradient
    of ``total`` are ``jax.grad``'s (1e-5 of the largest).  A per-rank
    mean would differ: rank 0's own loss is checked to be off."""
    spec, _, outs = dp
    i = list(LOSS_SPLITS).index(split)
    ins = spec["loss"][i]
    names = ("mel_postnet", "mel_coarse", "gate_logits", "alignments")

    def f(preds):
        return jax_loss.tacotron2_loss(
            *(preds[k] for k in names), jnp.asarray(ins["mel_target"]),
            jnp.asarray(ins["mel_lengths"]), jnp.asarray(ins["text_lengths"]),
            jnp.int32(ins["loss_step"]), jax_config.GuidedAttentionConfig(),
            sigma_warmup_steps=ins["sigma_warmup"])

    preds = {k: jnp.asarray(ins[k]) for k in names}
    ref = f(preds)
    ref_g = jax.grad(lambda p: f(p).total)(preds)
    for o in outs:
        got = o["loss"][i]["losses"]
        for name in ref._fields:
            np.testing.assert_allclose(got[name], float(getattr(ref, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    for k in names:
        g = np.concatenate([o["loss"][i]["grads"][k] for o in outs])
        r = np.asarray(ref_g[k])
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(), rtol=0,
                                   err_msg=k)
    rows0 = ins["rows"][0]
    alone = port_loss.tacotron2_loss(
        *(torch.from_numpy(ins[k][rows0]) for k in names),
        torch.from_numpy(ins["mel_target"][rows0]),
        torch.from_numpy(ins["mel_lengths"][rows0]),
        torch.from_numpy(ins["text_lengths"][rows0]), ins["loss_step"],
        port_config.GuidedAttentionConfig(),
        sigma_warmup_steps=ins["sigma_warmup"])
    assert abs(float(alone.mel) - float(ref.mel)) > 1e-3 * float(ref.mel)


# --------------------------------------------------------------------------
# the train step on two ranks
# --------------------------------------------------------------------------
def jax_mesh_steps(jcfg, params, state, batch, micro):
    """From the same weights, the JAX ``train_step`` and
    ``train_step_accum`` on the 8-device mesh: {"step": (losses, params,
    model state), "accum": ...}."""
    jtx = jax_make_optimizer(jcfg.train)
    mesh = jax_make_mesh(n_data=8, n_model=1)
    put = lambda tree, spec: {k: jax.device_put(v, NamedSharding(mesh, spec))
                              for k, v in tree.items()}
    out = {}
    with mesh:
        for what in ("step", "accum"):
            jstate = jax_shard_state(mesh, JaxTrainState(
                params=params, model_state=state, opt_state=jtx.init(params),
                step=jnp.int32(0), loss_step=jnp.int32(0),
                rng=jax.random.PRNGKey(1)))
            if what == "step":
                jstate, losses, _ = jax_step.train_step(
                    jstate, put(batch, P("data")), cfg=jcfg, tx=jtx,
                    use_postnet=True, sigma_warmup_steps=SIGMA_WARMUP)
            else:
                jstate, losses, _ = jax_step.train_step_accum(
                    jstate, put(micro, P(None, "data")), cfg=jcfg, tx=jtx,
                    use_postnet=True, sigma_warmup_steps=SIGMA_WARMUP,
                    accum_steps=2)
            out[what] = (losses, np_tree(jstate.params),
                         np_tree(jstate.model_state))
    return out


@pytest.fixture(scope="module")
def single(dp):
    """One process of the port on the whole batch, per step case."""
    _, steps, _ = dp
    return {name: worker.step_case({**c, **c["whole"]}, 0)
            for name, c in steps.items()}


def test_train_steps_match_jax_mesh(dp, single):
    """Dropout off, fp32, from the same weights: a two-rank ``train_step``
    and ``train_step_accum`` against the JAX steps on the 8-device mesh:
    losses to 1e-4 relative on both ranks, updated parameters within
    ``assert_params_close`` (gradients at noise read from one process of
    the port) and BatchNorm state 3e-4, the counters exactly."""
    _, steps, outs = dp
    ref = jax_mesh_steps(*steps["off"]["jax"])
    for o in outs:
        got = o["steps"]["off"]
        for what, (losses, p, s) in ref.items():
            for name in losses._fields:
                np.testing.assert_allclose(
                    got[what][name], float(getattr(losses, name)), rtol=1e-4,
                    atol=1e-6, err_msg=f"{what} {name}")
            assert_params_close(p, got[f"params_{what}"],
                                single["off"][f"grads_{what}"], what)
            assert_trees_close(s, got[f"state_{what}"], 3e-4, what)
        assert got["counters_step"] == (1, 1)
        assert got["counters_accum"] == (1, 2)


@pytest.mark.parametrize("dropout", STEP_CASES)
def test_two_ranks_match_one_process(dp, single, dropout):
    """Two ranks against one process of the port on the whole batch, from
    the same weights and generator, within fp32 sum order: the summed
    gradients that ``train_step`` and ``train_step_accum`` hand the
    optimizer and the Adam moments after them (``GRAD_TOL``: a gradient
    twice or half too large fails here, where Adam's step would hide it),
    the losses of both steps and of ``eval_step`` after the second and the
    eval entropy (1e-5 relative), the parameters and BatchNorm state (as
    against JAX); the two ranks' state bit for bit.  Dropout off, drawn
    from the generator for the global batch, or handed in as this rank's
    rows of global masks."""
    _, _, outs = dp
    ref = single[dropout]
    got = [o["steps"][dropout] for o in outs]
    for what in ("step", "accum"):
        for part in ("params", "state", "moments"):
            assert_trees_equal(got[0][f"{part}_{what}"],
                               got[1][f"{part}_{what}"],
                               f"ranks' {part} after {what}")
    for g in got:
        for what in ("step", "accum"):
            assert_grads_close(ref[f"grads_{what}"], g[f"grads_{what}"],
                               f"{what} gradient")
            for i, m in enumerate(("mu", "nu")):
                assert_grads_close(ref[f"moments_{what}"][i],
                                   g[f"moments_{what}"][i], f"{what} {m}")
            assert_params_close(ref[f"params_{what}"], g[f"params_{what}"],
                                ref[f"grads_{what}"], what)
            assert_trees_close(ref[f"state_{what}"], g[f"state_{what}"],
                               3e-4, what)
            assert g[f"counters_{what}"] == ref[f"counters_{what}"]
        for what in ("step", "accum", "eval"):
            for name, value in ref[what].items():
                np.testing.assert_allclose(g[what][name], value, rtol=1e-5,
                                           atol=1e-6, err_msg=f"{what} {name}")
        np.testing.assert_allclose(g["eval_entropy"], ref["eval_entropy"],
                                   rtol=1e-5)


def test_two_process_training_end_to_end(dp):
    """``train()`` on two ranks (4 rows, a global batch of 2): both ranks
    at step 2 with bit-equal weights, one log written by rank 0 alone with
    one "Data parallel" line, the epoch checkpoint saved."""
    spec, _, outs = dp
    res = [o["train"] for o in outs]
    assert res[0]["step"] == res[1]["step"] == 2
    assert res[0]["digest"] == res[1]["digest"]
    assert res[0]["param0"] == res[1]["param0"]
    ckpt = spec["train"]["ckpt"]
    log = open(os.path.join(ckpt, "training_log.txt")).read()
    assert log.count("Data parallel: 2 devices, 2 processes, "
                     "global micro-batch 2") == 1
    assert log.count("Epoch 1 complete") == 1
    assert os.path.isfile(os.path.join(ckpt, "tacotron2_epoch_1",
                                       "train_state.pt"))
    assert not [f for f in os.listdir(os.path.join(ckpt, "tacotron2_epoch_1"))
                if ".tmp" in f]


def test_debug_runs_on_rank_0_alone(dp):
    """``train(debug_overfit=True)`` on two ranks: rank 0 overfits its
    batch with no collective (the other rank waits at a barrier), logs the
    NOTE once and exports; the other rank takes no step."""
    spec, _, outs = dp
    steps = [o["train"]["debug_step"] for o in outs]
    assert steps[0] > 0 and steps[1] == 0
    debug = spec["train"]["debug_ckpt"]
    log = open(os.path.join(debug, "training_log.txt")).read()
    assert log.count("NOTE: --debug runs on rank 0 alone") == 1
    assert os.path.isfile(os.path.join(debug, "debug_export",
                                       "overfit_model", "weights.pt"))


def test_single_process_helpers(monkeypatch):
    """Without torchrun's variables ``initialize_distributed()`` does
    nothing; the mesh and batch helpers: a data mesh, and a 2x2 grid in the
    JAX package's device order."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()
    assert rank_device("cpu") == torch.device("cpu")
    mesh = make_mesh(devices=["cpu"] * 3, n_data=2)
    assert mesh.shape == {"data": 2, "model": 1}
    grid = make_mesh(n_model=2, devices=[f"cpu:{i}" for i in range(5)])
    assert grid.shape == {"data": 2, "model": 2}
    assert grid.devices == ((torch.device("cpu:0"), torch.device("cpu:1")),
                            (torch.device("cpu:2"), torch.device("cpu:3")))
    with pytest.raises(ValueError, match="exceeds"):
        make_mesh(devices=["cpu"], n_data=2)
    b = dp8_batch()
    halves = [shard_batch(b, r, 2) for r in range(2)]
    for k in b:
        np.testing.assert_array_equal(
            np.concatenate([h[k] for h in halves]), b[k])


# --------------------------------------------------------------------------
# ShardedSynthesizer over two CPU replicas
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def synth_models():
    out = {}
    for n_speakers, key in ((1, 0), (4, 2)):
        kw = {**SMALL, "n_speakers": n_speakers}
        params, state = tacotron2_init(jax.random.PRNGKey(key),
                                       jax_config.ModelConfig(**kw))
        model = load_jax_params(Tacotron2(port_config.ModelConfig(**kw)),
                                np_tree(params), np_tree(state))
        out[n_speakers] = (params, state, model,
                           jax_config.Config(model=jax_config.ModelConfig(**kw)),
                           port_config.Config(model=port_config.ModelConfig(**kw)))
    return out


@pytest.fixture
def jax_phase(monkeypatch):
    """Hand the port the JAX package's own initial-phase draw."""
    def draw(shape, seed, device):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.PRNGKey(seed), tuple(shape), minval=0.0,
            maxval=2.0 * np.pi)))
    monkeypatch.setattr(tgl, "_initial_phase", draw)


def assert_wavs_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == r.shape and g.size > 0
        np.testing.assert_allclose(g, r, atol=5e-3, rtol=0)
        assert np.mean(np.abs(g - r)) < 5e-4


@pytest.mark.parametrize("n_texts", [8, 3])
def test_sharded_matches_jax_and_unsharded(synth_models, jax_phase, n_texts):
    """Two CPU replicas against the port's unsharded ``synthesize_wav``
    and (eight texts) the JAX ``ShardedSynthesizer`` over the 8-device
    mesh, 2 Griffin-Lim iterations: equal lengths (so equal frame ends),
    5e-3 absolute and 5e-4 on average.  Three texts pad the second shard
    with a copy of the last."""
    params, state, model, jcfg, cfg = synth_models[1]
    texts = [f"test sentence number {i}." for i in range(n_texts)]
    with ShardedSynthesizer(model, make_mesh(devices=["cpu", "cpu"]), cfg,
                            gl_iters=2) as synth:
        wavs = synth(texts)
    assert_wavs_close(wavs, synthesize_wav(model, texts, cfg, gl_iters=2,
                                           device="cpu"))
    if n_texts == 8:
        ref = JaxSharded(params, state, jax_make_mesh(n_data=8), jcfg,
                         gl_iters=2)
        try:
            assert_wavs_close(wavs, ref(texts))
        finally:
            ref.close()


def test_sharded_per_item_speakers(synth_models, jax_phase):
    """Per-item speakers follow their items into the shards: the same
    audio as the unsharded batch, and other audio with the speakers
    swapped."""
    _, _, model, _, cfg = synth_models[4]
    texts = ["speaker one text here.", "speaker three text here."]
    synth = ShardedSynthesizer(model, make_mesh(devices=["cpu", "cpu"]), cfg,
                               gl_iters=2)
    wavs = synth(texts, speaker_id=[1, 3])
    assert_wavs_close(wavs, synthesize_wav(
        model, texts, cfg, gl_iters=2, speaker_id=[1, 3], device="cpu"))
    other = synth(texts, speaker_id=[3, 1])
    n = min(wavs[0].size, other[0].size)
    assert n == 0 or not np.allclose(wavs[0][:n], other[0][:n])


def test_sharded_checks(synth_models):
    _, _, model, _, cfg = synth_models[1]
    mesh = make_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="needs a 'model' mesh axis wider "
                                         "than 1"):
        ShardedSynthesizer(model, mesh, cfg, tensor_parallel=True)
    with pytest.raises(ValueError, match="data"):
        ShardedSynthesizer(model, ("cpu", "cpu"), cfg)
    synth = ShardedSynthesizer(model, mesh, cfg)
    assert synth([]) == []
    synth.close()
    with pytest.raises(RuntimeError, match="closed"):
        synth(["one."])
