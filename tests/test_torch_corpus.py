"""The port's synthetic corpus, its G2P analysis and its quality harness
against the JAX package's, on the CPU.

* ``data/synth_corpus.py::synth_utterance`` bit for bit against
  ``tools/make_synth_corpus.py::synth_utterance`` on rows 0-31 at prosody 0
  and 0.2, and ``make_synth_corpus`` (and its CLI) against the tool's
  ``main``: the same WAV bytes and metadata, with one speaker and four,
  whole or only some rows written.
* The seed-5, 4-speaker, 2048-row corpus of ``docs/evidence_r5``: rows
  2000-2047 generated by the port and preprocessed on the CPU; the first
  16 val items' ``(text_len, mel_len, speaker_id)`` equal the triples of
  ``docs/evidence_r5/quality_r5ms.json`` (the TPU's report).
* ``text/analysis.py``'s ``g2p_coverage``, ``format_report`` and
  ``heteronym_audit`` on those 48 val texts: equal to the JAX package's.
* ``tools/eval_quality_torch.py::evaluate`` at full width on
  ``checkpoints/r5_ms_bf16`` (fp32, CPU) for the two shortest val items
  (report indices 14 and 3) against ``tools/eval_quality.py`` run through
  the JAX package on the CPU: the items' lengths, speakers and gate stops
  equal; MCDs within 0.01 dB and diagonality within 1e-3 (both sides fp32;
  read: 1e-4 dB and 3e-4).  The report's keys are the tool's, and the
  CLI (``--skip-ar --out``) prints and writes the teacher-forced ones.
"""

import csv
import importlib.util
import json
import os
import runpy
import sys

import numpy as np
import pytest

from tacotron2_tpu.text import G2p as JaxG2p
from tacotron2_tpu.text import analysis as jax_analysis
from tacotron2_torch.data import synth_corpus
from tacotron2_torch.data.metadata import _write_csv, read_metadata
from tacotron2_torch.data.preprocess import preprocess_corpus
from tacotron2_torch.text import G2p
from tacotron2_torch.text import analysis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT = os.path.join(ROOT, "docs", "evidence_r5", "quality_r5ms.json")
CKPT = os.path.join(ROOT, "checkpoints", "r5_ms_bf16")
VAL_ROWS = range(2000, 2048)
MCD_TOL = 1e-2          # dB, port vs JAX package, both fp32 on the CPU
DIAG_TOL = 1e-3


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def tool():
    return _load_tool("make_synth_corpus")


# ------------------------------------------------------------ the generator

@pytest.mark.parametrize("prosody", [0.0, 0.2])
def test_synth_utterance_bit_for_bit(tool, prosody):
    """The tool's row loop (words, phonemes, speakers, waveform) on rows
    0-31, each side on its own package's G2P and random stream."""
    assert synth_corpus.VOCAB == tool.VOCAB and synth_corpus.SR == tool.SR
    port_g2p, jax_g2p = G2p(), JaxG2p()
    rng_t, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    n_speakers = 4
    for i in range(32):
        n_words = int(rng_t.integers(3, 9))
        assert n_words == int(rng_j.integers(3, 9))
        draw = rng_t.integers(0, len(synth_corpus.VOCAB), n_words)
        np.testing.assert_array_equal(
            draw, rng_j.integers(0, len(tool.VOCAB), n_words))
        words = " ".join(synth_corpus.VOCAB[int(j)] for j in draw)
        phonemes = port_g2p(words)
        assert phonemes == jax_g2p(words)
        scale = 1.0 + 0.3 * (i % n_speakers) / (n_speakers - 1)
        for ph in set(phonemes) - {" "}:
            core = ph.rstrip("012")
            assert synth_corpus._phoneme_params(core, None) == \
                tool._phoneme_params(core, None)
        got = synth_corpus.synth_utterance(phonemes, rng_t, scale, prosody)
        ref = tool.synth_utterance(phonemes, rng_j, scale, prosody)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    assert rng_t.integers(0, 1 << 30) == rng_j.integers(0, 1 << 30)


def _run_tool_main(tool, monkeypatch, outdir, *argv):
    monkeypatch.setattr(sys, "argv", ["make_synth_corpus.py", outdir,
                                      *argv])
    tool.main()


def _same_corpus(got_dir, ref_dir, rows):
    names = sorted(f"SYN-{i:04d}.wav" for i in rows)
    assert sorted(os.listdir(os.path.join(got_dir, "wavs"))) == names
    for name in names:
        with open(os.path.join(got_dir, "wavs", name), "rb") as a, \
                open(os.path.join(ref_dir, "wavs", name), "rb") as b:
            assert a.read() == b.read(), name
    with open(os.path.join(got_dir, "metadata.csv"), encoding="utf-8") as f:
        got = f.read().replace(os.path.abspath(got_dir), "<root>")
    with open(os.path.join(ref_dir, "metadata.csv"), encoding="utf-8") as f:
        ref = f.read().replace(os.path.abspath(ref_dir), "<root>")
    return got, ref


@pytest.mark.parametrize("argv", [("--n", "12", "--seed", "3"),
                                  ("--n", "12", "--seed", "5",
                                   "--n_speakers", "4", "--prosody", "0.2",
                                   "--min_words", "2", "--max_words", "4")])
def test_make_synth_corpus_matches_tool(tool, monkeypatch, tmp_path, argv):
    ref_dir, got_dir = str(tmp_path / "tool"), str(tmp_path / "port")
    _run_tool_main(tool, monkeypatch, ref_dir, *argv)
    kw = dict(zip(argv[::2], argv[1::2]))
    meta = synth_corpus.make_synth_corpus(
        got_dir, n=int(kw["--n"]), seed=int(kw["--seed"]),
        min_words=int(kw.get("--min_words", 3)),
        max_words=int(kw.get("--max_words", 8)),
        prosody=float(kw.get("--prosody", 0.0)),
        n_speakers=int(kw.get("--n_speakers", 1)))
    assert meta == os.path.join(got_dir, "metadata.csv")
    got, ref = _same_corpus(got_dir, ref_dir, range(12))
    assert got == ref


def test_make_synth_corpus_cli_writes_some_rows(tool, monkeypatch, tmp_path):
    """``--rows 4:9``: five of the twelve files, each the whole corpus's,
    and the metadata lines of those five."""
    ref_dir, got_dir = str(tmp_path / "tool"), str(tmp_path / "port")
    argv = ("--n", "12", "--seed", "7", "--n_speakers", "3")
    _run_tool_main(tool, monkeypatch, ref_dir, *argv)
    monkeypatch.setattr(sys, "argv", ["make_synth_corpus_torch.py", got_dir,
                                      *argv, "--rows", "4:9"])
    monkeypatch.syspath_prepend(ROOT)
    runpy.run_path(os.path.join(ROOT, "tools", "make_synth_corpus_torch.py"),
                   run_name="__main__")
    got, ref = _same_corpus(got_dir, ref_dir, range(4, 9))
    ref_lines = ref.splitlines()
    assert got.splitlines() == [ref_lines[0]] + ref_lines[5:10]


# ------------------------------------------------- the r5 corpus, seed 5

@pytest.fixture(scope="module")
def r5_val(tmp_path_factory):
    """Rows 2000-2047 of the seed-5 corpus (every row synthesized, these
    written), preprocessed on the CPU; returns (processed metadata, rows)."""
    root = str(tmp_path_factory.mktemp("r5"))
    meta = synth_corpus.make_synth_corpus(
        os.path.join(root, "raw"), n=2048, seed=5, n_speakers=4,
        rows=VAL_ROWS)
    out = os.path.join(root, "processed")
    stats = preprocess_corpus(meta, out, batch_size=16, text_workers=1,
                              device="cpu")
    assert stats == {"ok": len(VAL_ROWS), "skipped": 0}
    return os.path.join(out, "metadata.csv"), read_metadata(meta)


@pytest.fixture(scope="module")
def report():
    with open(REPORT) as f:
        return json.load(f)


def test_r5_val_items_match_the_tpu_report(r5_val, report):
    from tacotron2_torch.data.dataset import TextMelDataset
    ds = TextMelDataset(r5_val[0])
    assert len(ds) == 48 and ds.n_speakers == 4
    got = []
    for i in range(16):
        item = ds[i]
        got.append((len(item.text), item.mel.shape[1], item.speaker_id))
    want = [(r["text_len"], r["mel_len"], r["speaker_id"])
            for r in report["per_item"]]
    assert got == want
    assert want[0] == (19, 159, 0) and want[15] == (22, 177, 3)


def test_g2p_coverage_equal(r5_val):
    texts = [r["text"] for r in r5_val[1]]
    got = analysis.g2p_coverage(texts)
    ref = jax_analysis.g2p_coverage(texts, JaxG2p())
    assert got == ref
    assert got["total_tokens"] > 48 * 3
    assert analysis.format_report(got) == jax_analysis.format_report(ref)


def test_heteronym_audit_equal(r5_val):
    texts = [r["text"] for r in r5_val[1]]
    texts_plus = texts + ["They read the record and lead the way.",
                          "I live where the wind blows the bass."]
    for t in (texts, texts_plus):
        assert analysis.heteronym_audit(t) == jax_analysis.heteronym_audit(t)


def test_analysis_cli_equal(r5_val, monkeypatch, capsys):
    """``python -m ...text.analysis META [--json] [--heteronyms]``, both
    packages, the same output."""
    meta = r5_val[0]
    for flags in ([], ["--json"], ["--heteronyms"]):
        outs = []
        for mod in (analysis, jax_analysis):
            monkeypatch.setattr(sys, "argv", ["analysis", meta, *flags])
            mod._main()
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and outs[0], flags


def test_evaluate_matches_jax_eval_quality(r5_val, report, tmp_path,
                                           monkeypatch):
    """Report items 14 and 3 (the two shortest); speakers 0 and 1 follow
    in the metadata so that the speaker map stays the val split's."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        from eval_quality_torch import evaluate
    finally:
        sys.path.pop(0)
    rows = read_metadata(r5_val[0])
    pair = str(tmp_path / "pair.csv")
    with open(r5_val[0], encoding="utf-8", newline="") as f:
        fields = next(csv.reader(f))
    _write_csv(pair, [rows[i] for i in (14, 3, 0, 1)], fields)
    for sub in ("text", "mels"):
        os.symlink(os.path.join(os.path.dirname(r5_val[0]), sub),
                   str(tmp_path / sub))

    got = evaluate(CKPT, pair, n=2, n_speakers=4, device="cpu")
    out = str(tmp_path / "jax.json")
    monkeypatch.setattr(sys, "argv", [
        "eval_quality.py", CKPT, pair, "--n", "2", "--n_speakers", "4",
        "--out", out])
    runpy.run_path(os.path.join(ROOT, "tools", "eval_quality.py"),
                   run_name="__main__")
    with open(out) as f:
        ref = json.load(f)

    assert list(got) == list(ref)
    assert got["n_items"] == ref["n_items"] == 2
    for g, r, pinned in zip(got["per_item"], ref["per_item"],
                            (report["per_item"][14], report["per_item"][3])):
        assert list(g) == list(r)
        for k in ("index", "text_len", "mel_len", "speaker_id",
                  "ar_end_frames", "gate_err_frames"):
            assert g[k] == r[k], k
        for k in ("text_len", "mel_len", "speaker_id"):
            assert g[k] == pinned[k], k
        for k in ("mcd_tf_db", "mcd_ar_dtw_db"):
            assert abs(g[k] - r[k]) <= MCD_TOL, k
        assert abs(g["diagonality"] - r["diagonality"]) <= DIAG_TOL
    for key in ("mcd_teacher_forced_db", "mcd_autoregressive_dtw_db"):
        for stat in ("mean", "median", "p90", "max"):
            assert abs(got[key][stat] - ref[key][stat]) <= MCD_TOL, key
    for stat in ("mean", "max"):
        assert abs(got["alignment_diagonality"][stat]
                   - ref["alignment_diagonality"][stat]) <= DIAG_TOL
        assert (got["gate_timing_error_frames"][stat]
                == ref["gate_timing_error_frames"][stat])


def test_eval_quality_cli_teacher_forced_only(r5_val, report, tmp_path,
                                              monkeypatch, capsys):
    """``tools/eval_quality_torch.py --skip-ar --out``: the teacher-forced
    keys only, printed and written, equal to ``evaluate``'s."""
    out = str(tmp_path / "report.json")
    monkeypatch.setattr(sys, "argv", [
        "eval_quality_torch.py", CKPT, r5_val[0], "--n", "1", "--skip-ar",
        "--n_speakers", "4", "--device", "cpu", "--out", out])
    runpy.run_path(os.path.join(ROOT, "tools", "eval_quality_torch.py"),
                   run_name="__main__")
    with open(out) as f:
        got = json.load(f)
    assert list(got) == ["checkpoint", "n_items", "mcd_teacher_forced_db",
                         "alignment_diagonality", "per_item"]
    assert list(got["per_item"][0]) == ["index", "text_len", "mel_len",
                                        "speaker_id", "mcd_tf_db",
                                        "diagonality"]
    assert got["per_item"][0]["mcd_tf_db"] == pytest.approx(
        report["per_item"][0]["mcd_tf_db"], abs=MCD_TOL)
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == got
