"""The port's letter-to-sound tools against the JAX package's, on the CPU.

``tools/train_lts_torch.py`` (the graphone n-gram), ``tools/
eval_g2p_torch.py`` (the G2P scorer) and ``tools/train_lts_neural_torch.py``
(the neural seq2seq, PyTorch) are held to ``tools/train_lts.py``,
``tools/eval_g2p.py`` and ``tools/train_lts_neural.py`` on the same inputs:

- the n-gram pipeline on 300 training words: the EM probabilities, both
  Viterbi alignments, the counts, the pruning and the serialized arrays
  equal, and both packages' ``LtsModel`` pronounce alike from the file;
- ``evaluate`` of both scorers: equal stats and misses at n=40, seed 1;
- the neural model from the JAX ``init_params`` at dropout 0 and
  smoothing 0.1, B=8: the loss within 1e-5 relative of ``loss_fn`` and
  every gradient leaf within 1e-4 of ``jax.grad``'s (fp32 sums in another
  order over a 52-step encoder and a 28-step decoder);
- the schedule and Adam within 1e-6 of optax's over 20 steps on the same
  gradients, and twenty whole training steps of both trainers at dropout
  0 on the same batches (losses within 1e-4 relative, weights 1e-4);
- ``greedy`` on the committed ``lts_neural.npz``: the JAX ``greedy``'s ids
  on 64 held-out words;
- a CPU run of the trainer writes a file both ``lts_neural`` modules
  decode alike.
"""

import importlib.util
import os
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tacotron2_tpu.text.lts_model import LtsModel as JaxLtsModel
from tacotron2_tpu.text.lts_neural import NeuralLts as JaxNeuralLts
from tacotron2_torch.text.lts_model import LtsModel
from tacotron2_torch.text.lts_neural import NeuralLts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED_NEURAL = os.path.join(ROOT, "tacotron2_tpu", "text", "data",
                                "lts_neural.npz")
LOSS_TOL = 1e-5      # relative
GRAD_TOL = 1e-4      # absolute, every leaf
OPT_TOL = 1e-6
TRACK_LOSS_TOL = 1e-4    # twenty steps: each step's loss, relative
TRACK_PARAM_TOL = 1e-4   # and the weights after them, absolute


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def ngram_tools():
    return _load_tool("train_lts"), _load_tool("train_lts_torch")


@pytest.fixture(scope="module")
def neural_tools():
    return _load_tool("train_lts_neural"), _load_tool("train_lts_neural_torch")


@pytest.fixture(scope="module")
def neural_data(neural_tools):
    return neural_tools[1].build_data()


# ---------------------------------------------------------------------------
# the graphone n-gram


def fit_table(tool, pairs, path):
    """``tools/train_lts*.py::main``'s pipeline on ``pairs`` through
    ``tool``'s functions (order 6, 4 EM iterations, the bigram
    realignment); the table written to ``path``.  Returns every
    intermediate."""
    probs = tool.em_align(pairs, iters=4)
    aligned = [(w, ph, tool.viterbi_align(w, ph, probs)) for w, ph in pairs]
    aligned = [x for x in aligned if x[2] is not None]
    uni, big = defaultdict(int), defaultdict(lambda: defaultdict(int))
    for _, _, seq in aligned:
        prev = None
        for g in seq:
            uni[g] += 1
            big[prev][g] += 1
            prev = g
    realigned = [tool.viterbi_align_bigram(w, ph, probs, big, uni, len(uni))
                 or seq for w, ph, seq in aligned]
    gset = sorted({g for seq in realigned for g in seq})
    vocab = ["<s>", "</s>"] + ["{}|{}".format(c, " ".join(p))
                               for c, p in gset]
    gid = {g: i + 2 for i, g in enumerate(gset)}
    seqs = [[gid[g] for g in seq] for seq in realigned]
    freq = defaultdict(int)
    for seq in seqs:
        for g in seq:
            freq[g] += 1
    by_letter = defaultdict(list)
    for (c, _), i in gid.items():
        by_letter[c].append(i)
    cands = {c: sorted(ids, key=lambda i: -freq[i])[:24]
             for c, ids in by_letter.items()}
    grams = tool.count_ngrams(seqs, 6, bos_id=0, eos_id=1)
    counted = [{ctx: dict(t) for ctx, t in g.items()} for g in grams]
    grams = tool.prune_ngrams(grams, 2, 4)
    tool.serialize(str(path), vocab, grams, 6, cands)
    return dict(probs=dict(probs), aligned=aligned, realigned=realigned,
                counted=counted,
                pruned=[{ctx: dict(t) for ctx, t in g.items()}
                        for g in grams])


@pytest.fixture(scope="module")
def tables(ngram_tools, tmp_path_factory):
    jax_tool, port_tool = ngram_tools
    from tacotron2_torch.text.lexicon import load_lexicon
    pairs = port_tool.training_words(load_lexicon())
    # 300 words from across the alphabet
    pairs = pairs[::len(pairs) // 300][:300]
    d = tmp_path_factory.mktemp("lts")
    return (pairs, d / "jax.npz", d / "port.npz",
            fit_table(jax_tool, pairs, d / "jax.npz"),
            fit_table(port_tool, pairs, d / "port.npz"))


def test_training_words_and_holdout_match(ngram_tools):
    jax_tool, port_tool = ngram_tools
    from tacotron2_tpu.text.lexicon import load_lexicon as jax_lexicon
    from tacotron2_torch.text.lexicon import load_lexicon
    lex = load_lexicon()
    assert lex == jax_lexicon()
    assert port_tool.training_words(lex) == jax_tool.training_words(lex)
    words = sorted(lex)[::97]
    assert ([port_tool.is_holdout(w) for w in words]
            == [jax_tool.is_holdout(w) for w in words])


@pytest.mark.parametrize("stage", ["probs", "aligned", "realigned",
                                   "counted", "pruned"])
def test_ngram_pipeline_matches_jax_tool(tables, stage):
    pairs, _, _, want, got = tables
    assert len(pairs) == 300
    assert got[stage] == want[stage]


def test_serialized_table_matches_jax_tool(tables):
    _, jax_path, port_path, _, _ = tables
    want, got = np.load(jax_path), np.load(port_path)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def test_both_lts_models_pronounce_alike(tables):
    pairs, _, port_path, _, _ = tables
    port, jax_model = LtsModel(str(port_path)), JaxLtsModel(str(port_path))
    words = [w for w, _ in pairs[::6]] + ["tacotron", "zyxel", "quokka"]
    assert [port.pronounce(w) for w in words] == [
        jax_model.pronounce(w) for w in words]


# ---------------------------------------------------------------------------
# the G2P scorer


def test_evaluate_matches_jax_scorer():
    want = _load_tool("eval_g2p").evaluate(40, 1, 10)
    got = _load_tool("eval_g2p_torch").evaluate(40, 1, 10)
    assert got == want
    assert got[0]["n"] == 40


# ---------------------------------------------------------------------------
# the neural seq2seq


def test_build_data_matches_jax_tool(neural_tools, neural_data):
    letters, targets, symbols, rows, hold = neural_data
    want = neural_tools[0].build_data()
    assert np.array_equal(letters, want[0])
    assert np.array_equal(targets, want[1])
    assert symbols == want[2]
    assert [w for w, _, _ in rows] == [w for w, _, _ in want[3]]
    assert [w for w, _, _ in hold] == [w for w, _, _ in want[4]]
    assert (len(rows), len(hold), len(symbols)) == (103953, 11578, 72)


def test_params_match_the_jax_leaves(neural_tools, neural_data):
    jax_tool, port_tool = neural_tools
    v = len(neural_data[2])
    want = jax_tool.init_params(jax.random.PRNGKey(0), v)
    got = port_tool.init_params(0, v)
    assert list(got) == list(want)
    assert {k: tuple(x.shape) for k, x in got.items()} == {
        k: tuple(x.shape) for k, x in want.items()}
    assert sum(x.numel() for x in got.values()) == 3229960
    for k, x in got.items():
        if x.ndim == 1:
            assert not x.any(), k
        else:
            bound = 1.0 / np.sqrt(x.shape[0])
            assert float(x.abs().max()) <= bound, k
            assert float(x.abs().max()) > 0.9 * bound, k
    again = port_tool.init_params(0, v)
    assert all(torch.equal(got[k], again[k]) for k in got)
    back = port_tool.params_from_numpy(
        {k: np.asarray(x) for k, x in want.items()})
    assert all(np.array_equal(back[k].numpy(), np.asarray(want[k]))
               for k in want)


def test_first_step_loss_and_gradients_match_jax(neural_tools, neural_data):
    """From the JAX ``init_params`` at dropout 0 and smoothing 0.1, B=8 of
    the training rows."""
    jax_tool, port_tool = neural_tools
    letters, targets, symbols = neural_data[:3]
    lb, tb = letters[1000:1008], targets[1000:1008]
    jp = jax_tool.init_params(jax.random.PRNGKey(3), len(symbols))
    loss_fn, _ = jax_tool.make_fns(len(symbols), dropout=0.0,
                                   label_smooth=0.1)
    want_loss, want_grads = jax.value_and_grad(loss_fn)(
        jp, jnp.asarray(lb), jnp.asarray(tb), None)
    p = port_tool.params_from_numpy({k: np.asarray(x) for k, x in jp.items()})
    for x in p.values():
        x.requires_grad_(True)
    loss = port_tool.loss_fn(p, torch.from_numpy(lb).long(),
                             torch.from_numpy(tb).long(), None, 0.1)
    grads = torch.autograd.grad(loss, list(p.values()))
    assert abs(float(loss.detach()) / float(want_loss) - 1) <= LOSS_TOL
    for k, g in zip(p, grads):
        err = np.abs(g.numpy() - np.asarray(want_grads[k])).max()
        assert err <= GRAD_TOL, (k, err)


def test_schedule_and_adam_match_optax(neural_tools):
    port_tool = neural_tools[1]
    total, lr = 60, 2e-3
    sched = optax.warmup_cosine_decay_schedule(
        0.0, lr, min(200, max(total // 10, 1)), total, lr * 0.02)
    mine = port_tool.warmup_cosine(lr, total)
    for c in list(range(0, 12)) + [30, 59, 60, 61, 100]:
        assert abs(mine(c) - float(sched(c))) <= OPT_TOL * lr, c
    rng = np.random.default_rng(5)
    shapes = {"w": (7, 5), "b": (5,)}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1
              for k, s in shapes.items()}
    tx = optax.adam(sched)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = port_tool.Adam(tp, mine)
    for step in range(20):
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in shapes.items()}
        upd, state = tx.update({k: jnp.asarray(g) for k, g in grads.items()},
                               state)
        jp = optax.apply_updates(jp, upd)
        opt.step(tp, {k: torch.from_numpy(g) for k, g in grads.items()})
        for k in shapes:
            err = np.abs(tp[k].numpy() - np.asarray(jp[k])).max()
            assert err <= OPT_TOL, (step, k, err)


def test_twenty_steps_track_the_jax_trainer(neural_tools, neural_data):
    """Twenty optimiser steps of both trainers from the JAX
    ``init_params`` on the same batches of the first epoch's permutation
    (B=16, dropout 0, smoothing 0.1, the 20-step schedule): every step's
    loss within ``TRACK_LOSS_TOL`` relative and the weights after it
    within ``TRACK_PARAM_TOL`` (Adam turns the sign of a gradient near
    zero into a step of about the learning rate, so the fp32 order of the
    sums shows in the weights first)."""
    jax_tool, port_tool = neural_tools
    letters, targets, symbols = neural_data[:3]
    v, b, steps, lr = len(symbols), 16, 20, 2e-3
    idx = np.random.default_rng(0).permutation(len(letters))
    jp = jax_tool.init_params(jax.random.PRNGKey(1), v)
    loss_fn, _ = jax_tool.make_fns(v, dropout=0.0, label_smooth=0.1)
    tx = optax.adam(optax.warmup_cosine_decay_schedule(
        0.0, lr, min(200, max(steps // 10, 1)), steps, lr * 0.02))
    state = tx.init(jp)

    @jax.jit
    def jax_step(p, s, lb, tb):
        loss, g = jax.value_and_grad(loss_fn)(p, lb, tb, None)
        u, s = tx.update(g, s)
        return optax.apply_updates(p, u), s, loss

    p = port_tool.params_from_numpy({k: np.asarray(x) for k, x in jp.items()})
    opt = port_tool.Adam(p, port_tool.warmup_cosine(lr, steps))
    for step in range(steps):
        sel = idx[step * b:(step + 1) * b]
        jp, state, want = jax_step(jp, state, jnp.asarray(letters[sel]),
                                   jnp.asarray(targets[sel]))
        got = port_tool.train_step(
            p, opt, torch.from_numpy(letters[sel]).long(),
            torch.from_numpy(targets[sel]).long(), None, 0.1)
        assert abs(float(got) / float(want) - 1) <= TRACK_LOSS_TOL, step
    for k, x in p.items():
        err = np.abs(x.numpy() - np.asarray(jp[k])).max()
        assert err <= TRACK_PARAM_TOL, (k, err)


def test_greedy_on_the_committed_model_matches_jax(neural_tools,
                                                   neural_data):
    jax_tool, port_tool = neural_tools
    hold = neural_data[4]
    z = np.load(COMMITTED_NEURAL)
    arrays = {k: np.asarray(z[k], np.float32) for k in z.files
              if k != "phone_symbols"}
    v = arrays["out_b"].shape[0]
    letters, truths = port_tool.heldout_batch(hold[::100], 64)
    _, greedy = jax_tool.make_fns(v)
    want = np.asarray(jax.jit(greedy)(arrays, jnp.asarray(letters)))
    got = port_tool.greedy(port_tool.params_from_numpy(arrays),
                           torch.from_numpy(letters).long()).numpy()
    assert got.shape == want.shape == (64, 28)
    assert np.array_equal(got, want)
    symbols = [str(s) for s in z["phone_symbols"]]
    acc, acc_ns = port_tool.word_accuracy(got, truths, symbols)
    assert 0.5 < acc <= acc_ns


def test_cpu_run_writes_a_file_both_packages_decode(neural_tools, tmp_path):
    port_tool = neural_tools[1]
    out = str(tmp_path / "lts_neural.npz")
    port_tool.main(["--limit", "256", "--epochs", "1", "--batch", "64",
                    "--eval-n", "16", "--device", "cpu", "--out", out])
    z = np.load(out)
    assert sorted(z.files) == sorted(
        list(port_tool.param_shapes(72)) + ["phone_symbols"])
    assert all(z[k].dtype == np.float16 for k in z.files
               if k != "phone_symbols")
    port, jax_model = NeuralLts(out), JaxNeuralLts(out)
    for w in ("hello", "tacotron", "a"):
        assert port.pronounce(w) == jax_model.pronounce(w)
