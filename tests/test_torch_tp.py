"""The port's tensor parallelism (A16-TP) against the JAX package on the CPU.

Two grids of gloo ranks (``tests/torch_tp_worker.py``, one subprocess a
rank, joined at a ``file://`` store in the test's temporary directory;
every wait is bounded and a hung rank is killed), each started once for
every case: ``1x2`` (two ranks, ``tp=2``) and ``2x2`` (four ranks, two
data indices of ``tp=2``).  Each rank runs the four model-axis autograd
ops on its shards, keeps its shards of a model made from the JAX package's
weights, and takes a ``train_step`` and an ``eval_step`` on its data
index's rows of ``tests/test_parallel.py``'s DP8 batch; the ``2x2`` grid
also runs ``train(tensor_parallel=2)``.

Held to: the JAX 4x2 mesh's layout (``param_shardings`` spec by spec, each
rank's shard exactly the JAX array's shard on device ``(d, m)``); the JAX
4x2 tensor-parallel step and the JAX DP8 step at ``test_tp_matches_dp``'s
limits (fp32, dropout off: losses 1e-3 relative, ``proj`` 5e-4); one
process of the port on the whole batch at ``tests/test_torch_parallel.py``'s
limits (dropout off, drawn from the generator, and drawn with every
decoder step rematerialised, ``remat="full"``); autograd on the
unsharded products (the ops); and, for ``ShardedSynthesizer(
tensor_parallel=True)`` over ``["cpu"] * 2`` and ``["cpu"] * 4``, the JAX
synthesizer on its 4x2 mesh and the unsharded port (2 Griffin-Lim
iterations, 5e-3 absolute; mels 1e-3).  Widths are ``SMALL``.
"""

import dataclasses
import functools
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
from tacotron2_tpu.infer import ShardedSynthesizer as JaxSharded
from tacotron2_tpu.models.tacotron2 import tacotron2_init
from tacotron2_tpu.parallel import make_mesh as jax_make_mesh
from tacotron2_tpu.parallel import param_shardings as jax_param_shardings
from tacotron2_tpu.parallel import shard_train_state as jax_shard_state
from tacotron2_tpu.train import step as jax_step
from tacotron2_tpu.train.optim import make_optimizer as jax_make_optimizer
from tacotron2_tpu.train.state import TrainState as JaxTrainState
from tacotron2_torch import config as port_config
from tacotron2_torch.dsp import griffinlim as tgl
from tacotron2_torch.infer import ShardedSynthesizer
from tacotron2_torch.infer.fused import synthesize_wav
from tacotron2_torch.infer.synthesize import load_model
from tacotron2_torch.models.layers import linear
from tacotron2_torch.models.tacotron2 import Tacotron2, tacotron2_infer
from tacotron2_torch.parallel import make_mesh, param_shardings, shard_batch
from tacotron2_torch.text import pad_sequences, text_to_sequence
from tacotron2_torch.utils.weights import load_jax_params, param_pairs

HERE = os.path.dirname(os.path.abspath(__file__))
WAIT_S = 300            # each grid's run, bounded
LAYOUTS = {"1x2": (2, 2), "2x2": (4, 2)}      # world, tp
SMALL = dict(symbols_embedding_dim=32, encoder_embedding_dim=32,
             decoder_rnn_dim=48, prenet_dim=16, attention_rnn_dim=48,
             attention_dim=24, location_n_filters=8, location_kernel_size=15,
             postnet_embedding_dim=24, max_decoder_steps=50)
NO_DROPOUT = dict(p_attention_dropout=0.0, p_decoder_dropout=0.0,
                  p_prenet_dropout=0.0, p_postnet_dropout=0.0)
TRAIN = dict(precision="float32", learning_rate=1e-3)
# dropout off; dropout drawn from the generator; the latter with every
# decoder step rematerialised (remat "full": the model-axis collectives of
# a step run again in the backward, in the same order on every rank)
STEP_CASES = ("off", "generator", "remat")
# tests/test_parallel.py::test_tp_matches_dp
JAX_LOSS_RTOL, JAX_PROJ_ATOL = 1e-3, 5e-4
# tests/test_torch_parallel.py: fp32 sums in another order, Adam's step on a
# gradient at noise, the leaves whose true gradient is zero
GRAD_TOL, ADAM_NOISE, NOISY_GRAD = 1e-5, 3e-3, 1e-3
STRUCTURAL_ZERO = {"['decoder']['attention']['v']['b']",
                   *(f"['encoder']['convs'][{i}]['b']" for i in range(3)),
                   *(f"['postnet']['convs'][{i}]['b']" for i in range(5))}
ZERO_GRAD = STRUCTURAL_ZERO | {"['postnet']['convs'][4]['w']",
                               "['postnet']['bn'][4]['scale']"}
OPS_TOL = 1e-5          # of the largest value: fp32 sums in another order
MEL_TOL = 1e-3

_worker_spec = importlib.util.spec_from_file_location(
    "torch_tp_worker", os.path.join(HERE, "torch_tp_worker.py"))
worker = importlib.util.module_from_spec(_worker_spec)
_worker_spec.loader.exec_module(worker)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def leaves(tree):
    return [(jax.tree_util.keystr(path), np.asarray(x))
            for path, x in jax.tree_util.tree_leaves_with_path(tree)]


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def assert_grads_close(ref, got, what):
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
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(x, y, err_msg=what)


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------
def dp8_batch(b=8, t_enc=8, t_dec=16, seed=0):
    """``tests/test_parallel.py::_batch``."""
    rng = np.random.default_rng(seed)
    return {
        "text": rng.integers(1, 72, (b, t_enc)).astype(np.int32),
        "text_lengths": np.full((b,), t_enc, np.int32),
        "mel": (rng.standard_normal((b, 80, t_dec)).astype(np.float32) - 5.0),
        "mel_lengths": np.full((b,), t_dec, np.int32),
        "speaker_ids": np.zeros((b,), np.int32),
    }


def configs(dropout: bool):
    kw = {**SMALL, **({} if dropout else NO_DROPOUT)}
    return (jax_config.Config(model=jax_config.ModelConfig(**kw),
                              train=jax_config.TrainConfig(**TRAIN)),
            port_config.Config(model=port_config.ModelConfig(**kw),
                               train=port_config.TrainConfig(**TRAIN)))


def ops_inputs():
    rng = np.random.default_rng(11)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"x": f(3, 7), "h": f(3, 5), "wi": f(16, 7), "wh": f(16, 5),
            "cot": f(3, 16), "x2": f(3, 12), "w2": f(6, 12), "cot2": f(3, 6)}


@functools.lru_cache(maxsize=None)
def jax_weights():
    """The JAX package's seed-0 ``SMALL`` weights as numpy trees (dropout
    rates do not change them), drawn under one ``jax.jit`` (the same bits
    as drawn op by op, in one compile)."""
    return np_tree(jax.jit(tacotron2_init, static_argnums=1)(
        jax.random.PRNGKey(0), configs(False)[0].model))


def step_inputs(case: str, n_data: int):
    _, cfg = configs(case != "off")
    if case == "remat":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat_decoder_step=True, decoder_remat_policy="full"))
    params, state = jax_weights()
    batch = dp8_batch()
    return dict(cfg=cfg, params=params, model_state=state, seed=3,
                batch=[shard_batch(batch, d, n_data) for d in range(n_data)])


def make_corpus(root, n, seed=0):
    import csv
    rng = np.random.default_rng(seed)
    for sub in ("text", "mels"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rows = []
    for i in range(n):
        base = f"TP-{i:04d}"
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
# the grids' runs: started once, the JAX references made while they run
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def grids_started(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    runs = {}
    for name, (world, tp) in LAYOUTS.items():
        n_data = world // tp
        spec = {"ops": ops_inputs(),
                "steps": {c: step_inputs(c, n_data) for c in STEP_CASES}}
        if name == "2x2":
            _, cfg = configs(True)
            spec["train"] = {
                "meta": make_corpus(str(tmp / "corpus"), 4),
                "ckpt": str(tmp / "ckpt"),
                "cfg": dataclasses.replace(cfg, train=dataclasses.replace(
                    cfg.train, epochs=1, batch_size=1, text_pad_multiple=4,
                    mel_pad_multiple=8))}
        with open(tmp / f"{name}.pkl", "wb") as f:
            pickle.dump(spec, f)
        procs, logs = [], []
        for rank in range(world):
            logs.append(open(tmp / f"{name}_rank{rank}.log", "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(HERE, "torch_tp_worker.py"),
                 str(rank), str(world), str(tp), str(tmp / f"{name}.store"),
                 str(tmp / f"{name}.pkl"), str(tmp / f"{name}_out{rank}.pkl")],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        runs[name] = (spec, procs, logs)
    yield tmp, runs
    for _, procs, logs in runs.values():
        for p in procs:                  # a hung or orphaned rank dies
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()


def jax_steps(params, state, batch):
    """From the same weights, one fp32 JAX ``train_step`` without dropout
    on the DP8 mesh and on the 4x2 tensor-parallel mesh: {name: (losses,
    params)}."""
    jcfg, _ = configs(False)
    out = {}
    for name, (nd, nm, tp) in (("dp8", (8, 1, False)), ("tp4x2", (4, 2, True))):
        mesh = jax_make_mesh(n_data=nd, n_model=nm)
        tx = jax_make_optimizer(jcfg.train)
        fresh = lambda tree: jax.tree_util.tree_map(jnp.array, tree)
        with mesh:            # the step donates its state: fresh copies
            jstate = jax_shard_state(mesh, JaxTrainState(
                params=fresh(params), model_state=fresh(state),
                opt_state=tx.init(fresh(params)),
                step=jnp.int32(0), loss_step=jnp.int32(0),
                rng=jax.random.PRNGKey(1)), tensor_parallel=tp)
            batch_d = {k: jax.device_put(v, NamedSharding(mesh, P("data")))
                       for k, v in batch.items()}
            jstate, losses, _ = jax_step.train_step(
                jstate, batch_d, cfg=jcfg, tx=tx, use_postnet=True,
                sigma_warmup_steps=800)
        out[name] = (losses, np_tree(jstate.params))
    return out


@pytest.fixture(scope="module")
def refs(grids_started):
    """The JAX steps, the JAX 4x2 layout, and one process of the port per
    step case, made while the grids run."""
    jcfg, _ = configs(False)
    params, state = jax_weights()
    mesh = jax_make_mesh(n_data=4, n_model=2)
    with mesh:
        placed = jax_shard_state(mesh, JaxTrainState(
            params=params, model_state=state,
            opt_state=jax_make_optimizer(jcfg.train).init(params),
            step=jnp.int32(0), loss_step=jnp.int32(0),
            rng=jax.random.PRNGKey(1)), tensor_parallel=True)
    layout = {"specs": jax_param_shardings(mesh, params, True),
              "params": placed.params, "grid": mesh.devices}
    one = {c: worker.step_case(step_inputs(c, 1), 0) for c in STEP_CASES}
    return {"jax": jax_steps(params, state, dp8_batch()), "layout": layout,
            "one": one}


@pytest.fixture(scope="module")
def grids(grids_started, refs):
    tmp, runs = grids_started
    deadline = time.monotonic() + WAIT_S
    every = [p for _, procs, _ in runs.values() for p in procs]
    while (any(p.poll() is None for p in every)
           and time.monotonic() < deadline
           and not any(p.returncode for p in every)):
        time.sleep(0.2)
    for p in every:
        if p.poll() is None:
            p.kill()
        p.wait()
    out = {}
    for name, (spec, procs, logs) in runs.items():
        for rank, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            assert p.returncode == 0, f"{name} rank {rank} exit " \
                f"{p.returncode}:\n" + log.read()[-4000:]
        outs = []
        for rank in range(len(procs)):
            with open(tmp / f"{name}_out{rank}.pkl", "rb") as f:
                outs.append(pickle.load(f))
        out[name] = (spec, outs)
    return out


# --------------------------------------------------------------------------
# layout and the ops
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_grid_and_shards_match_jax_layout(grids, refs, layout):
    """Rank r sits at (r // 2, r % 2); every parameter's spec is the JAX
    4x2 mesh's spec read through the weight bridge; each rank's shard of a
    sharded parameter is exactly the JAX array's shard on device (d, m)
    (transposed where the bridge transposes), and its moments are shaped
    like it."""
    _, outs = grids[layout]
    world, tp = LAYOUTS[layout]
    jl = refs["layout"]
    cfg = configs(False)[1].model
    pairs = {key: (path, tr) for path, key, tr in param_pairs(cfg)
             if path[0] == "params"}
    for rank, o in enumerate(outs):
        d, m = divmod(rank, tp)
        assert o["grid"] == (world // tp, tp, d, m)
        specs = o["steps"]["off"]["specs"]
        assert set(specs) == set(pairs)
        n_sharded = 0
        for key, (path, tr) in pairs.items():
            jspec = tuple(get(jl["specs"], path[1:]).spec)
            assert specs[key] == (tuple(reversed(jspec)) if tr else jspec), key
            if "model" not in jspec:
                assert key not in o["steps"]["off"]["shards"]["params"]
                continue
            n_sharded += 1
            dev = jl["grid"][d, m]
            shard = [s.data for s in get(jl["params"], path[1:])
                     .addressable_shards if s.device == dev][0]
            got = o["steps"]["off"]["shards"]["params"][key]
            np.testing.assert_array_equal(got.T if tr else got,
                                          np.asarray(shard), err_msg=key)
            for mom in ("mu", "nu"):
                assert o["steps"]["off"]["shards"][mom][key].shape == got.shape
        assert n_sharded == 10


def test_port_param_shardings_replicated_without_tp():
    model = Tacotron2(configs(False)[1].model)
    assert set(param_shardings(model).values()) == {()}
    specs = param_shardings(model, True)
    assert specs["decoder.attention_lstm.weight_ih"] == ("model", None)
    assert specs["decoder.decoder_lstm.bias_hh"] == ("model",)
    assert specs["decoder.linear_projection.weight"] == (None, "model")
    assert specs["decoder.linear_projection.bias"] == ()
    assert specs["encoder.lstm.fwd.weight_ih"] == ()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_model_axis_ops_match_autograd(grids, layout):
    """copy in + gather out around a gate-split product of two inputs, and
    split in + reduce out around an input-split one, against autograd on
    the unsharded products: the outputs and the inputs' gradients on every
    rank, each rank's weight gradient the slice of the whole one."""
    spec, outs = grids[layout]
    s = spec["ops"]
    t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in s.items()}
    y = linear(t["x"], t["wi"]) + linear(t["h"], t["wh"])
    (y * t["cot"]).sum().backward()
    y2 = linear(t["x2"], t["w2"])
    (y2 * t["cot2"]).sum().backward()
    tp = LAYOUTS[layout][1]

    def close(got, ref, what):
        ref = ref.detach()
        np.testing.assert_allclose(got, ref.numpy(), rtol=0,
                                   atol=OPS_TOL * float(ref.abs().max()),
                                   err_msg=what)

    for rank, o in enumerate(outs):
        m = rank % tp
        got = o["ops"]
        rows = slice(m * 16 // tp, (m + 1) * 16 // tp)
        cols = slice(m * 12 // tp, (m + 1) * 12 // tp)
        close(got["y"], y, "gathered gates")
        close(got["x_grad"], t["x"].grad, "copy-in x")
        close(got["h_grad"], t["h"].grad, "copy-in h")
        close(got["wi_grad"], t["wi"].grad[rows], "gate-split wi")
        close(got["wh_grad"], t["wh"].grad[rows], "gate-split wh")
        close(got["y2"], y2, "reduced heads")
        close(got["x2_grad"], t["x2"].grad, "split-in x")
        close(got["w2_grad"], t["w2"].grad[:, cols], "input-split w")


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_step_matches_jax_tp_and_dp8(grids, refs, layout):
    """fp32, no dropout, the DP8 batch: every rank's losses against the JAX
    4x2 tensor-parallel step and the JAX DP8 step (1e-3 relative), the
    gathered ``proj`` weights against both (5e-4)."""
    _, outs = grids[layout]
    for name, (losses, params) in refs["jax"].items():
        for o in outs:
            got = o["steps"]["off"]
            for k in losses._fields:
                np.testing.assert_allclose(
                    got["losses"][k], float(getattr(losses, k)),
                    rtol=JAX_LOSS_RTOL, atol=1e-6, err_msg=f"{name} {k}")
            np.testing.assert_allclose(
                got["params"]["decoder"]["proj"]["w"],
                params["decoder"]["proj"]["w"], atol=JAX_PROJ_ATOL, rtol=0,
                err_msg=name)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dropout", STEP_CASES)
def test_tp_step_matches_one_process(grids, refs, layout, dropout):
    """Against one process of the port on the whole batch, from the same
    weights and generator: the whole gradients (``GRAD_TOL``), Adam
    moments, parameters, BatchNorm state, counters, the step's and a
    following ``eval_step``'s losses (1e-5 relative).  Every rank gathers
    the same whole state, bit for bit, and the replicated part of it
    (parameters, moments, statistics, counters, generator) is bit-equal
    across ranks before any gather."""
    _, outs = grids[layout]
    ref = refs["one"][dropout]
    got = [o["steps"][dropout] for o in outs]
    for g in got[1:]:
        assert g["digest"] == got[0]["digest"]
        assert_trees_equal(g["params"], got[0]["params"], "gathered params")
        assert_trees_equal(g["moments"], got[0]["moments"], "gathered moments")
    for g in got:
        assert g["gathered_equal"]
        assert_grads_close(ref["grads"], g["grads"], "gradient")
        for i, m in enumerate(("mu", "nu")):
            assert_grads_close(ref["moments"][i], g["moments"][i], m)
        assert_params_close(ref["params"], g["params"], ref["grads"], "step")
        for (key, r), (_, x) in zip(leaves(ref["state"]), leaves(g["state"])):
            np.testing.assert_allclose(x, r, rtol=0, atol=3e-4 * max(
                1.0, float(np.abs(r).max())), err_msg=key)
        assert g["counters"] == ref["counters"] == (1, 1)
        for what in ("losses", "eval"):
            for k, v in ref[what].items():
                np.testing.assert_allclose(g[what][k], v, rtol=1e-5,
                                           atol=1e-6, err_msg=f"{what} {k}")
        np.testing.assert_allclose(g["eval_entropy"], ref["eval_entropy"],
                                   rtol=1e-5)


def test_tp_training_end_to_end(grids):
    """``train(tensor_parallel=2)`` on four ranks (4 rows, batch 1 a
    process: a global batch of 4, two rows a data index): every rank at
    step 1 with the same replicated state, one log with one "SPMD mesh"
    line, the epoch checkpoint in the unsharded layout, which ``load_model``
    reads in one process; its weights are the ranks' shards concatenated."""
    spec, outs = grids["2x2"]
    res = [o["train"] for o in outs]
    assert {r["step"] for r in res} == {1}
    assert len({r["digest"] for r in res}) == 1
    ckpt = spec["train"]["ckpt"]
    log = open(os.path.join(ckpt, "training_log.txt")).read()
    assert log.count("SPMD mesh: data=2 x model=2 (tensor parallel), 4 "
                     "processes, global micro-batch 4") == 1
    assert log.count("Epoch 1 complete") == 1
    path = os.path.join(ckpt, "tacotron2_epoch_1")
    model = load_model(path, spec["train"]["cfg"], device="cpu")
    sd = model.state_dict()
    specs = param_shardings(model, True)
    assert set(res[0]["shards"]) == {k for k, s in specs.items() if s}
    for key in res[0]["shards"]:
        dim = specs[key].index("model")
        for d in range(2):         # ranks 2d, 2d + 1: data index d
            whole = np.concatenate([res[2 * d]["shards"][key],
                                    res[2 * d + 1]["shards"][key]], axis=dim)
            np.testing.assert_array_equal(sd[key].numpy(), whole,
                                          err_msg=key)


def test_step_loop_sums_bf16_weight_gradients_in_fp32():
    """The step loop that tensor parallelism trains through, at bf16
    compute, against the split BPTT's plain route (which sums its weight
    gradients in fp32) on the same inputs: within 5e-2 by the rule of the
    smoke's phase 10 and 20 (max error over the leaf's largest plus 1e-2
    of the largest of all; each step's gradient of a scalar such as the
    energy scale is still rounded to bf16, 2e-2 here).  Summed in bf16
    over 200 steps they part by 0.66 here (0.74 at full width on the
    card)."""
    from tacotron2_torch.models.tacotron2 import replace_config
    from tacotron2_torch.train import step
    from tacotron2_torch.train.state import create_train_state
    _, cfg = configs(False)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, precision="bfloat16"))
    rng = np.random.default_rng(4)
    b, t_enc, t_dec = 4, 24, 200
    batch = step._to_device({
        "text": rng.integers(1, 72, (b, t_enc)),
        "text_lengths": np.full((b,), t_enc),
        "mel": (rng.standard_normal((b, 80, t_dec)) - 5).astype(np.float32),
        "mel_lengths": np.full((b,), t_dec)}, torch.device("cpu"))
    state = create_train_state(cfg, seed=0, device="cpu")
    grads = {}
    for split in (True, False):
        replace_config(state.model, decoder_split_bptt=split)
        total, _ = step._forward_loss(state.model, cfg, batch, None, 0, False,
                                      800)
        grads[split] = step._grads(state.model, total)
    top = max(float(g.abs().max()) for g in grads[True].values())
    for name, ref in grads[True].items():
        err = float((grads[False][name] - ref).abs().max()) / (
            float(ref.abs().max()) + 1e-2 * top)
        assert err < 5e-2, f"{name} {err}"


# --------------------------------------------------------------------------
# ShardedSynthesizer(tensor_parallel=True)
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def synth_model():
    params, state = jax_weights()
    model = load_jax_params(Tacotron2(port_config.ModelConfig(**SMALL)),
                            params, state)
    return (params, state, model,
            jax_config.Config(model=jax_config.ModelConfig(**SMALL)),
            port_config.Config(model=port_config.ModelConfig(**SMALL)))


def jax_phase_draw(shape, seed, device):
    """The JAX package's own initial-phase draw, for the port."""
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), tuple(shape), minval=0.0,
        maxval=2.0 * np.pi)))


TP_TEXTS = [f"tensor parallel check {i}." for i in range(4)]


@pytest.fixture(scope="module")
def synth_refs(synth_model):
    """The JAX tensor-parallel synthesizer's waveforms on the 4x2 mesh,
    the port's unsharded ones (the JAX package's initial phase for both),
    and the unsharded decode of each row slice a data shard takes."""
    params, state, model, jcfg, cfg = synth_model
    ref = JaxSharded(params, state, jax_make_mesh(n_data=4, n_model=2), jcfg,
                     gl_iters=2, tensor_parallel=True)
    try:
        jax_wavs = ref(TP_TEXTS)
    finally:
        ref.close()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgl, "_initial_phase", jax_phase_draw)
        port_wavs = synthesize_wav(model, TP_TEXTS, cfg, gl_iters=2,
                                   device="cpu")
    tokens, lengths = pad_sequences(
        [text_to_sequence(t) for t in TP_TEXTS], pad_multiple=16)
    decodes = {}
    for per in (2, 4):
        for start in range(0, len(TP_TEXTS), per):
            rows = slice(start, start + per)
            decodes[start, per] = tacotron2_infer(
                model, tokens[rows], text_lengths=lengths[rows],
                stop_mode="all", device="cpu")
    return jax_wavs, port_wavs, (tokens, lengths), decodes


def assert_wavs_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == np.float32 and g.shape == r.shape and g.size > 0
        np.testing.assert_allclose(g, r, atol=5e-3, rtol=0)
        assert np.mean(np.abs(g - r)) < 5e-4


@pytest.mark.parametrize("n_data,n_model", [(1, 2), (2, 2)])
def test_tp_sharded_matches_jax_and_unsharded(synth_model, synth_refs,
                                              monkeypatch, n_data, n_model):
    """Over ``["cpu"] * n_data * n_model``: each data shard's replica holds
    shard 0 of the sharded tensors and its model axis the others; the
    waveforms against the JAX tensor-parallel synthesizer on the 4x2 mesh
    and the port's unsharded ``synthesize_wav`` (equal lengths, so equal
    frame ends); each data shard's decode against the unsharded model's
    (frame ends equal, mels within 1e-3)."""
    _, _, model, _, cfg = synth_model
    jax_wavs, port_wavs, (tokens, lengths), decodes = synth_refs
    monkeypatch.setattr(tgl, "_initial_phase", jax_phase_draw)
    mesh = make_mesh(n_data, n_model, ["cpu"] * (n_data * n_model))
    assert mesh.shape == {"data": n_data, "model": n_model}
    with ShardedSynthesizer(model, mesh, cfg, gl_iters=2,
                            tensor_parallel=True) as synth:
        for replica in synth.replicas:
            dec = replica.decoder
            assert dec.attention_lstm.weight_ih.shape[0] == 4 * 48 // n_model
            assert dec.linear_projection.weight.shape[1] == 80 // n_model
            assert dec.model_axis.size == n_model
            assert all(len(v) == n_model - 1
                       for v in dec.model_axis.peers.values())
        wavs = synth(TP_TEXTS)
        assert_wavs_close(wavs, jax_wavs)
        assert_wavs_close(wavs, port_wavs)
        per = len(TP_TEXTS) // n_data
        for d, replica in enumerate(synth.replicas):
            rows = slice(d * per, (d + 1) * per)
            got, _, ends = tacotron2_infer(
                replica, tokens[rows], text_lengths=lengths[rows],
                stop_mode="all", device="cpu")
            ref, _, ends_ref = decodes[d * per, per]
            assert torch.equal(ends, ends_ref)
            np.testing.assert_allclose(got.mel_postnet.numpy(),
                                       ref.mel_postnet.numpy(), atol=MEL_TOL,
                                       rtol=0)
